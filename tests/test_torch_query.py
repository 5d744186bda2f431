"""The port's state query dialect (``tasksrunner_torch/state/query.py``, the
stores' ``query``) against the JAX package's, in one process.

* Seeded documents and seeded queries (EQ / NEQ / IN / AND / OR, nested
  paths, missing fields and nulls, sort clauses, pages walked by token):
  the port's ``run_query`` and in-memory store give the JAX ones' items,
  order and tokens; the port's and the JAX sqlite stores, reading one
  file the JAX store wrote, give each other's; and the port's two stores
  give each other's items, order and tokens, rows that tie in key order.
* Every query case of ``tests/test_state.py``, run against the port's
  in-memory store and its sqlite store in memory and on a file.
"""

import asyncio
import json

import numpy as np
import pytest

from tasksrunner.errors import QueryError as JaxQueryError
from tasksrunner.state import query as jax_query
from tasksrunner.state.base import StateItem as JaxItem
from tasksrunner.state.memory import InMemoryStateStore as JaxMemory
from tasksrunner.state.sqlite import SqliteStateStore as JaxSqlite
from tasksrunner_torch.errors import QueryError, StateError
from tasksrunner_torch.state import query
from tasksrunner_torch.state.base import StateItem
from tasksrunner_torch.state.memory import InMemoryStateStore
from tasksrunner_torch.state.sqlite import SqliteStateStore

PRIORITIES = ["High", "Medium", "Low"]
CITIES = ["Athens", "Berlin", "Cairo"]
SCALARS = {  # path -> the values a filter may compare it with
    "priority": PRIORITIES + [None, "high"],
    "n": [0, 1, 2, 3, 4, 1.0, True, None],
    "done": [True, False, 0, None],
    "confidence": [0.5, None],  # set below to stored values as well
    "address.city": CITIES + [None],
    "address.zip": [100, 101, 102, "101"],
    "missing": [None, 1, "x"],
    "taskId": ["t000", "t007", "nope"],
}
SORTABLE = ["priority", "n", "done", "confidence", "address.city", "address.zip", "missing"]
N_QUERIES = 80


def seeded_docs(seed: int, n: int = 48) -> dict[str, dict]:
    rng = np.random.default_rng(seed)
    docs = {}
    for i in range(n):
        doc: dict = {"taskId": f"t{i:03d}", "n": int(rng.integers(0, 5)),
                     "done": bool(rng.integers(2))}
        if rng.random() < 0.85:
            doc["priority"] = PRIORITIES[rng.integers(3)] if rng.random() < 0.9 else None
        if rng.random() < 0.9:
            doc["confidence"] = round(float(rng.random()), 4)
        if rng.random() < 0.7:
            doc["address"] = {"city": CITIES[rng.integers(3)],
                              "zip": int(rng.integers(100, 103))}
        if rng.random() < 0.2:
            doc["tags"] = ["a", "b"][: int(rng.integers(1, 3))]
        docs[f"app||{doc['taskId']}"] = doc
    docs["other||t999"] = {"taskId": "t999", "priority": "High", "n": 1}
    return docs


def _value(rng, path: str, docs: dict):
    values = SCALARS[path]
    if path == "confidence" and rng.random() < 0.5:
        stored = [d["confidence"] for d in docs.values() if "confidence" in d]
        return stored[rng.integers(len(stored))]
    return values[rng.integers(len(values))]


def _filter(rng, docs: dict, depth: int = 0) -> dict:
    if depth < 2 and rng.random() < 0.3:
        return {["AND", "OR"][rng.integers(2)]: [_filter(rng, docs, depth + 1)
                                                for _ in range(int(rng.integers(1, 4)))]}
    path = list(SCALARS)[rng.integers(len(SCALARS))]
    op = ["EQ", "NEQ", "IN"][rng.integers(3)]
    if op == "IN":
        return {op: {path: [_value(rng, path, docs) for _ in range(int(rng.integers(0, 4)))]}}
    return {op: {path: _value(rng, path, docs)}}


def seeded_queries(seed: int, docs: dict) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_QUERIES):
        q: dict = {}
        if rng.random() < 0.85:
            q["filter"] = _filter(rng, docs)
        if rng.random() < 0.7:
            q["sort"] = [{"key": SORTABLE[rng.integers(len(SORTABLE))],
                          **({"order": ["ASC", "DESC", "desc"][rng.integers(3)]}
                             if rng.random() < 0.8 else {})}
                         for _ in range(int(rng.integers(1, 3)))]
            if rng.random() < 0.5:  # a unique last key: one order for every engine
                q["sort"].append({"key": "taskId"})
        if rng.random() < 0.6:
            q["page"] = {"limit": int(rng.integers(1, 9))}
        out.append(q)
    return out


def _rows(items) -> list[tuple]:
    return [(i.key, i.value, i.etag) for i in items]


def _walk(run, q: dict) -> list:
    """Every page of ``q`` through ``run(q) -> (items, token)``: the pages
    and their tokens."""
    pages, token = [], None
    while True:
        page = dict(q)
        if "page" in q:
            page["page"] = {**q["page"], **({"token": token} if token else {})}
        items, token = run(page)
        pages.append((_rows(items), token))
        if token is None or "page" not in q:
            return pages


def _flat(pages) -> list:
    return [row for rows, _ in pages for row in rows]


def test_run_query_gives_the_jax_items_order_and_tokens():
    docs = seeded_docs(0)
    jax_items = [JaxItem(k, v, str(i)) for i, (k, v) in enumerate(sorted(docs.items()))]
    items = [StateItem(k, v, str(i)) for i, (k, v) in enumerate(sorted(docs.items()))]
    for q in seeded_queries(1, docs):
        want = _walk(lambda p: jax_query.run_query(jax_items, p), q)
        got = _walk(lambda p: query.run_query(items, p), q)
        assert got == want, q
    # the pieces alone, too
    for path in ["address.city", "address", "tags", "missing.deeper", "taskId"]:
        for doc in docs.values():
            assert query.get_path(doc, path) == jax_query.get_path(doc, path)
    assert query.paginate(items, None) == (items, None)
    assert query.paginate(items, {"token": "40"}) == jax_query.paginate(items, {"token": "40"})


def _stores_run(store, key_prefix: str = ""):
    loop = asyncio.new_event_loop()

    def run(q):
        resp = loop.run_until_complete(store.query(q, key_prefix=key_prefix))
        return resp.items, resp.token
    return loop, run


async def _fill(store, docs: dict) -> None:
    for key, doc in sorted(docs.items()):
        await store.set(key, doc)


@pytest.mark.parametrize("key_prefix", ["", "app||"])
def test_the_memory_and_sqlite_stores_answer_as_the_jax_ones(tmp_path, key_prefix):
    docs = seeded_docs(2)
    path = tmp_path / "state.db"
    stores = {"jax-memory": JaxMemory("s"), "port-memory": InMemoryStateStore("s")}
    writer = JaxSqlite("s", path)  # the JAX store writes the file both sqlite stores read
    for store in (*stores.values(), writer):
        asyncio.run(_fill(store, docs))
    writer.close()
    stores.update({"jax-sqlite": JaxSqlite("s", path), "port-sqlite": SqliteStateStore("s", path)})
    runs = {name: _stores_run(store, key_prefix) for name, store in stores.items()}
    try:
        for q in seeded_queries(3, docs):
            got = {name: _walk(run, q) for name, (_, run) in runs.items()}
            assert got["port-memory"] == got["jax-memory"], q
            assert got["port-sqlite"] == got["jax-sqlite"], q
            # every engine finds the same items (etags are each store's own)
            found = {name: sorted((k, json.dumps(v, sort_keys=True)) for k, v, _ in _flat(p))
                     for name, p in got.items()}
            assert found["port-sqlite"] == found["port-memory"], q
            assert all(k.startswith(key_prefix) for k, _ in found["port-memory"])
            strip = [[([r[:2] for r in rows], token) for rows, token in got[name]]
                     for name in ("port-sqlite", "port-memory")]
            assert strip[0] == strip[1], q
    finally:
        for loop, _ in runs.values():
            loop.close()
        for name in ("jax-sqlite", "port-sqlite"):
            stores[name].close()


@pytest.mark.parametrize("bad", [
    "not an object",
    {"filter": {"BOGUS": {"a": 1}}},
    {"filter": {"EQ": {"a": 1, "b": 2}}},
    {"filter": {"EQ": {}}},
    {"filter": {"AND": []}},
    {"filter": {"OR": {"EQ": {"a": 1}}}},
    {"filter": {"IN": {"a": "not-a-list"}}},
    {"filter": {"IN": {"a": [[1]]}}},
    {"filter": {"NEQ": {"a": {"b": 1}}}},
    {"filter": {"EQ": {"a": 1}, "NEQ": {"a": 2}}},
    {"sort": [{"order": "ASC"}]},
    {"sort": ["priority"]},
    {"sort": [{"key": "a", "order": "SIDEWAYS"}]},
    {"page": {"limit": -1}},
    {"page": {"limit": 0}},
    {"page": {"limit": "2"}},
    {"page": {"limit": 2, "token": "xyz"}},
    {"page": {"token": "-1"}},
])
def test_a_malformed_query_is_refused_as_the_jax_dialect_refuses_it(tmp_path, bad):
    docs = seeded_docs(4, n=4)
    items = [StateItem(k, v, "1") for k, v in docs.items()]
    with pytest.raises(JaxQueryError) as want:
        jax_query.run_query([JaxItem(k, v, "1") for k, v in docs.items()], bad)
    with pytest.raises(QueryError) as got:
        query.run_query(items, bad)
    assert str(got.value) == str(want.value)
    assert got.value.http_status == 400 and isinstance(got.value, StateError)
    store = SqliteStateStore("s", tmp_path / "s.db")
    try:
        asyncio.run(_fill(store, docs))
        with pytest.raises(QueryError):
            asyncio.run(store.query(bad))
    finally:
        store.close()


# -- tests/test_state.py's query cases, against the port's stores -------------

ENGINES = {
    "memory": lambda tmp_path: InMemoryStateStore("s"),
    "sqlite-mem": lambda tmp_path: SqliteStateStore("s"),
    "sqlite-file": lambda tmp_path: SqliteStateStore("s", tmp_path / "state.db"),
}

TASKS = [
    {"taskId": "t1", "taskName": "alpha", "taskCreatedBy": "a@x.com",
     "taskDueDate": "2026-07-28T00:00:00", "isCompleted": False, "priority": 3},
    {"taskId": "t2", "taskName": "beta", "taskCreatedBy": "b@x.com",
     "taskDueDate": "2026-07-29T00:00:00", "isCompleted": True, "priority": 1},
    {"taskId": "t3", "taskName": "gamma", "taskCreatedBy": "a@x.com",
     "taskDueDate": "2026-07-28T00:00:00", "isCompleted": False, "priority": 2},
]


@pytest.fixture(params=sorted(ENGINES))
def store(request, tmp_path):
    s = ENGINES[request.param](tmp_path)
    yield s
    if isinstance(s, SqliteStateStore):
        s.close()


async def seed(store, prefix=""):
    for t in TASKS:
        await store.set(prefix + t["taskId"], t)


async def test_query_eq_by_creator(store):
    await seed(store)
    resp = await store.query({"filter": {"EQ": {"taskCreatedBy": "a@x.com"}}})
    assert {i.value["taskId"] for i in resp.items} == {"t1", "t3"}


async def test_query_eq_serialized_datetime(store):
    await seed(store)
    hit = await store.query({"filter": {"EQ": {"taskDueDate": "2026-07-28T00:00:00"}}})
    assert len(hit.items) == 2
    miss = await store.query({"filter": {"EQ": {"taskDueDate": "07/28/2026 00:00:00"}}})
    assert miss.items == []


async def test_query_eq_bool_and_missing_field(store):
    await seed(store)
    resp = await store.query({"filter": {"EQ": {"isCompleted": True}}})
    assert [i.value["taskId"] for i in resp.items] == ["t2"]
    resp = await store.query({"filter": {"EQ": {"noSuchField": None}}})
    assert len(resp.items) == 3  # a missing field compares equal to null


async def test_query_neq_in_and_or(store):
    await seed(store)
    resp = await store.query({"filter": {"NEQ": {"taskCreatedBy": "a@x.com"}}})
    assert [i.value["taskId"] for i in resp.items] == ["t2"]
    resp = await store.query({"filter": {"IN": {"taskName": ["alpha", "gamma"]}}})
    assert {i.value["taskId"] for i in resp.items} == {"t1", "t3"}
    resp = await store.query({"filter": {"AND": [
        {"EQ": {"taskCreatedBy": "a@x.com"}}, {"EQ": {"isCompleted": False}},
        {"NEQ": {"taskName": "gamma"}}]}})
    assert [i.value["taskId"] for i in resp.items] == ["t1"]
    resp = await store.query({"filter": {"OR": [
        {"EQ": {"taskName": "beta"}}, {"EQ": {"taskName": "gamma"}}]}})
    assert {i.value["taskId"] for i in resp.items} == {"t2", "t3"}


async def test_query_in_with_null_candidate(store):
    await seed(store)
    resp = await store.query({"filter": {"IN": {"noField": [None]}}})
    assert len(resp.items) == 3
    resp = await store.query({"filter": {"IN": {"taskName": []}}})
    assert resp.items == []


async def test_query_sort_and_page(store):
    await seed(store)
    resp = await store.query({"sort": [{"key": "priority", "order": "DESC"}]})
    assert [i.value["priority"] for i in resp.items] == [3, 2, 1]
    resp = await store.query({
        "sort": [{"key": "taskCreatedBy"}, {"key": "priority", "order": "DESC"}]})
    assert [i.value["taskId"] for i in resp.items] == ["t1", "t3", "t2"]
    seen, token = [], None
    while True:
        page = {"limit": 2, **({"token": token} if token else {})}
        resp = await store.query({"sort": [{"key": "taskId"}], "page": page})
        seen += [i.value["taskId"] for i in resp.items]
        token = resp.token
        if token is None:
            break
    assert seen == ["t1", "t2", "t3"]


async def test_query_key_prefix_isolation(store):
    await seed(store, prefix="appA||")
    await store.set("appB||t9", {"taskCreatedBy": "a@x.com"})
    resp = await store.query({"filter": {"EQ": {"taskCreatedBy": "a@x.com"}}},
                             key_prefix="appA||")
    assert {i.key for i in resp.items} == {"appA||t1", "appA||t3"}


async def test_query_prefix_with_like_metacharacters(store):
    await store.set("app%_x||k", {"v": 1})
    await store.set("appZZxQQk", {"v": 2})
    resp = await store.query({}, key_prefix="app%_x||")
    assert [i.key for i in resp.items] == ["app%_x||k"]


async def test_query_malformed_rejected(store):
    await seed(store)
    for bad in [
        {"filter": {"BOGUS": {"a": 1}}},
        {"filter": {"EQ": {"a": 1, "b": 2}}},
        {"filter": {"AND": []}},
        {"filter": {"IN": {"a": "not-a-list"}}},
        {"sort": [{"order": "ASC"}]},
        {"sort": [{"key": "a", "order": "SIDEWAYS"}]},
        {"page": {"limit": -1}},
        {"page": {"limit": 2, "token": "xyz"}},
    ]:
        with pytest.raises(QueryError):
            await store.query(bad)


async def test_nested_path_query(store):
    await store.set("n1", {"address": {"city": "Athens"}})
    await store.set("n2", {"address": {"city": "Berlin"}})
    resp = await store.query({"filter": {"EQ": {"address.city": "Athens"}}})
    assert [i.key for i in resp.items] == ["n1"]


async def test_sort_on_container_values_does_not_crash(store):
    await store.set("c1", {"address": {"city": "Athens"}})
    await store.set("c2", {"address": {"city": "Berlin"}})
    resp = await store.query({"sort": [{"key": "address"}]})
    assert len(resp.items) == 2


@pytest.mark.parametrize("engine", ["sqlite-mem", "sqlite-file"])
async def test_nan_rejected_at_write_time(tmp_path, engine):
    """NaN would poison json_extract: the sqlite store refuses it when written."""
    store = ENGINES[engine](tmp_path)
    try:
        with pytest.raises(StateError):
            await store.set("k", float("nan"))
        await seed(store)
        resp = await store.query({"filter": {"EQ": {"taskName": "alpha"}}})
        assert len(resp.items) == 1
    finally:
        store.close()


async def test_container_filter_operands_rejected(store):
    await seed(store)
    with pytest.raises(QueryError, match="scalar"):
        await store.query({"filter": {"EQ": {"tags": ["urgent"]}}})
    with pytest.raises(QueryError, match="scalar"):
        await store.query({"filter": {"IN": {"a": [{"x": 1}]}}})


async def test_mixed_type_sort_rank_matches_sqlite_order(store):
    await store.set("a", {"v": "zeta"})
    await store.set("b", {"v": 5})
    await store.set("c", {"w": 1})          # v missing: null
    await store.set("d", {"v": {"k": 1}})   # a container
    resp = await store.query({"sort": [{"key": "v"}]})
    assert [i.key for i in resp.items] == ["c", "b", "a", "d"]


async def test_negative_page_token_rejected(store):
    await seed(store)
    with pytest.raises(QueryError):
        await store.query({"page": {"limit": 2, "token": "-1"}})


async def test_every_store_supports_the_query(store):
    await seed(store)
    resp = await store.query({"page": {"limit": 2}})
    assert [i.key for i in resp.items] == ["t1", "t2"] and resp.token == "2"
    resp = await store.query({"page": {"limit": 2, "token": "2"}})
    assert [i.key for i in resp.items] == ["t3"] and resp.token is None
    resp = await store.query({"page": {"token": "1"}})
    assert [i.key for i in resp.items] == ["t2", "t3"] and resp.token is None
