"""The port's sharded state store against the JAX package's, on the CPU in
one process: the rendezvous router, the sqlite driver's ``shards``,
staged (two-phase) transactions, a seeded run of sets, deletes and
transactions on a 4-shard store of each package, and paged queries over
the facade. Everything compared is exact: shard indices, results, error
types, each shard file's ``(key, value, etag)`` rows and query pages."""

import asyncio
import random
import sqlite3

import numpy as np
import pytest

from tasksrunner import errors as jax_errors
from tasksrunner.state import sqlite as jax_sqlite
from tasksrunner.state.base import TransactionOp as JaxOp
from tasksrunner.state.sharding import ShardRouter as JaxRouter

from tasksrunner_torch import errors
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import parse_component
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.state import sqlite as port_sqlite
from tasksrunner_torch.state.base import TransactionOp
from tasksrunner_torch.state.sharding import ShardedStateStore, ShardRouter

PACKAGES = {"jax": (jax_sqlite, JaxOp, jax_errors), "port": (port_sqlite, TransactionOp, errors)}


def _keys(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"task-{v:x}-{rng.integers(0, 1000)}" for v in rng.integers(0, 2**40, n)]


# -- the router ---------------------------------------------------------------

@pytest.mark.parametrize("seed", ["", "seed-a", "hash-7"])
def test_router_assigns_every_key_as_the_jax_router(seed):
    keys = _keys(16, 10_000)
    for shards in range(1, 9):
        router = ShardRouter(shards, seed)
        assert [router.shard_of(k) for k in keys] == JaxRouter(shards, seed).spread(keys)


def test_router_golden_keys_and_moved_share():
    """``tests/test_state_sharding.py``'s golden assignment; growing N → N+1
    moves only keys to the new shard, under 1.35 × 1/(N+1) of them (that
    file's bound)."""
    golden = ShardRouter(4, "")
    assert [golden.shard_of(k) for k in ["task-0", "task-1", "task-2", "task-3", "task-4",
                                         "alpha", "beta", "gamma", "", "k"]] == \
        [1, 3, 2, 0, 0, 0, 1, 0, 3, 3]
    keys = _keys(3, 2000)
    for n in (1, 2, 4, 7):
        before, after = ShardRouter(n, "grow"), ShardRouter(n + 1, "grow")
        moved = [k for k in keys if before.shard_of(k) != after.shard_of(k)]
        assert len(moved) < len(keys) / (n + 1) * 1.35
        assert all(after.shard_of(k) == n for k in moved)
    for bad in (0, -3, 65):
        with pytest.raises(errors.ComponentError):
            ShardRouter(bad)


# -- the driver -------------------------------------------------------------

async def test_the_driver_builds_shard_files_and_gauges(tmp_path):
    """``shards: 4`` and ``hashSeed`` give four ``-shardN`` files, each
    key in the one its router names; ``shards: 1`` is the plain store on
    the named file; each shard's flush sets its own queue-depth gauge."""
    def registry(**metadata):
        return ComponentRegistry([parse_component({"componentType": "state.sqlite", "metadata": [
            {"name": k, "value": str(v)} for k, v in metadata.items()]}, default_name="s")])

    store = registry(databasePath=tmp_path / "s.db", shards=4, hashSeed="h").get("s")
    keys = _keys(5, 64)
    try:
        assert isinstance(store, ShardedStateStore) and store.router.seed == "h"
        await asyncio.gather(*(store.set(k, {"k": k}) for k in keys))
        for i in range(4):
            assert metrics.get("state_write_queue_depth", store="s", shard=i) >= 1
    finally:
        store.close()
    for i in range(4):
        with sqlite3.connect(tmp_path / f"s-shard{i}.db") as conn:
            held = {row[0] for row in conn.execute("SELECT key FROM state")}
        assert held == {k for k in keys if store.router.shard_of(k) == i} and held
    plain = registry(databasePath=tmp_path / "one.db", shards=1).get("s")
    try:
        assert type(plain) is port_sqlite.SqliteStateStore and plain.shard is None
        await plain.set("k", 1)
    finally:
        plain.close()
    assert (tmp_path / "one.db").is_file() and not (tmp_path / "one-shard0.db").exists()


# -- staged transactions ------------------------------------------------------

@pytest.mark.parametrize("package", PACKAGES)
async def test_a_late_commit_past_the_decision_deadline_raises(tmp_path, monkeypatch, package):
    """A coordinator that never decides cannot wedge the shard: past the
    deadline the writer rolls back, a late commit raises StateError and
    writes go on (``tests/test_state_sharding.py:153``'s check)."""
    sqlite_mod, op, errs = PACKAGES[package]
    monkeypatch.setattr(sqlite_mod.SqliteStateStore, "_STAGE_DECISION_TIMEOUT", 0.1)
    s = sqlite_mod.SqliteStateStore("t", tmp_path / "t.db")
    try:
        txn = await s.stage_transact([op("upsert", "k", {"v": 1})])
        await asyncio.sleep(0.4)
        with pytest.raises(errs.StateError, match="decision deadline exceeded"):
            await txn.commit()
        assert await s.get("k") is None
        await asyncio.wait_for(s.set("k2", {"v": 2}), 5)
        # a stage refused by its etag leaves no transaction open
        with pytest.raises(errs.EtagMismatch):
            await s.stage_transact([op("upsert", "k2", {"v": 3}, etag="999")])
        await asyncio.wait_for(s.set("k3", 3), 5)
    finally:
        s.close()


@pytest.mark.parametrize("package", PACKAGES)
async def test_a_staged_transaction_holds_the_writer(tmp_path, package):
    """While staged, the store's one writer is parked: a queued write
    lands only after the decision."""
    sqlite_mod, op, _ = PACKAGES[package]
    s = sqlite_mod.SqliteStateStore("t", tmp_path / "t.db")
    try:
        txn = await s.stage_transact([op("upsert", "k", {"v": 1})])
        queued = asyncio.ensure_future(s.set("other", {"v": 2}))
        done, _ = await asyncio.wait({queued}, timeout=0.3)
        assert not done
        await txn.commit()
        await asyncio.wait_for(queued, 5)
        assert (await s.get("k")).value == {"v": 1}
    finally:
        s.close()


@pytest.mark.parametrize("package", PACKAGES)
async def test_concurrent_cross_shard_transactions_do_not_deadlock(tmp_path, package):
    sqlite_mod, op, _ = PACKAGES[package]
    s = sqlite_mod.build_sharded_store("x", tmp_path / "x.db", shards=3)
    try:
        by_shard = {}
        for k in _keys(9, 64):
            by_shard.setdefault(s.router.shard_of(k), k)
        ka, kb, kc = (by_shard[i] for i in range(3))
        await asyncio.wait_for(asyncio.gather(*(
            s.transact([op("upsert", ka, {"i": i}), op("upsert", kb, {"i": i}),
                        op("upsert", kc, {"i": i})]) for i in range(12))), 30)
        values = [(await s.get(k)).value for k in (ka, kb, kc)]
        assert values[0] == values[1] == values[2]
    finally:
        s.close()


async def test_a_failed_second_commit_is_an_atomicity_error():
    """Shard 0 commits, shard 1's commit fails: the caller is told which
    committed; a failure at the first commit re-raises as it came."""
    class Txn:
        def __init__(self, log, fail):
            self.log, self.fail = log, fail

        async def commit(self):
            if self.fail:
                raise errors.StateError("disk")
            self.log.append("commit")

        async def rollback(self):
            self.log.append("rollback")

    class Child:
        def __init__(self, fail):
            self.fail, self.log = fail, []

        async def stage_transact(self, ops):
            return Txn(self.log, self.fail)

    for fails, want, logs in (
            ((False, True, False), errors.CrossShardAtomicityError,
             [["commit"], [], ["rollback"]]),
            ((True, False, False), errors.StateError, [[], ["rollback"], ["rollback"]])):
        children = [Child(f) for f in fails]
        store = ShardedStateStore("x", children)
        keys = {}
        for k in _keys(4, 64):
            keys.setdefault(store.router.shard_of(k), k)
        with pytest.raises(want) as info:
            await store.transact([TransactionOp("upsert", keys[i], 1) for i in range(3)])
        assert type(info.value) is want
        assert [c.log for c in children] == logs
        if want is errors.CrossShardAtomicityError:
            assert "committed on shard(s) [0] but failed on shard 1" in str(info.value)


# -- a seeded run on both packages -------------------------------------------

async def _run_ops(store, op, errs, rng: random.Random, keys: list[str], n: int) -> list:
    """``n`` seeded operations: sets and deletes with no, the current or a
    stale etag, and transactions over 2-4 keys (mostly across shards),
    some with a stale etag. Each result or error type, in order."""
    out = []
    for _ in range(n):
        kind = rng.choice(["set", "set", "delete", "transact", "transact"])
        picks = rng.sample(keys, rng.randint(2, 4))
        etags = []
        for k in picks:
            item = await store.get(k)
            mode = rng.choice(["none", "none", "current", "stale"])
            etags.append(None if mode == "none" else
                         "1" if mode == "stale" else (item.etag if item else "1"))
        try:
            if kind == "set":
                res = await store.set(picks[0], {"n": rng.randrange(100), "k": picks[0]},
                                      etag=etags[0])
            elif kind == "delete":
                res = await store.delete(picks[0], etag=etags[0])
            else:
                await store.transact([
                    op("delete" if rng.random() < 0.2 else "upsert", k,
                       {"n": rng.randrange(100), "k": k}, etag=e)
                    for k, e in zip(picks, etags)])
                res = "ok"
        except (errs.EtagMismatch, errs.StateError) as exc:
            res = type(exc).__name__
        out.append((kind, res))
    return out


def _rows(path) -> list[tuple]:
    with sqlite3.connect(path) as conn:
        return conn.execute("SELECT key, value, etag FROM state ORDER BY key").fetchall()


async def test_a_seeded_run_leaves_the_same_shard_files(tmp_path):
    """The same seeded operations on a 4-shard store of each package: the
    same results and error types, and the same rows in each shard file;
    then each package opens the other's files and reads every key the
    same."""
    keys = _keys(11, 40)
    results, stores = {}, {}
    for name, (sqlite_mod, op, errs) in PACKAGES.items():
        store = sqlite_mod.build_sharded_store("s", tmp_path / name / "s.db", shards=4,
                                               hash_seed="parity")
        try:
            results[name] = await _run_ops(store, op, errs, random.Random(16), keys, 240)
        finally:
            store.close()
        stores[name] = tmp_path / name / "s.db"
    assert results["port"] == results["jax"]
    kinds = {r for _, r in results["port"]}
    assert {"ok", "EtagMismatch", True, False} <= kinds  # not vacuous
    for i in range(4):
        rows = _rows(tmp_path / "port" / f"s-shard{i}.db")
        assert rows == _rows(tmp_path / "jax" / f"s-shard{i}.db") and rows
    seen = {}
    for name, other in (("port", "jax"), ("jax", "port")):
        sqlite_mod = PACKAGES[name][0]
        store = sqlite_mod.build_sharded_store("s", stores[other], shards=4, hash_seed="parity")
        try:
            seen[name] = [(i.key, i.value, i.etag) if i else None
                          for i in await store.bulk_get(keys)] + [await store.keys()]
        finally:
            store.close()
    assert seen["port"] == seen["jax"]


async def test_paged_queries_over_the_facade_equal_the_jax_facade(tmp_path):
    rng = np.random.default_rng(23)
    docs = {f"k{i:03d}": {"priority": ["High", "Medium", "Low"][int(rng.integers(3))],
                          "confidence": float(rng.integers(0, 5)) / 4, "i": i}
            for i in range(120)}
    queries = [{},
               {"filter": {"EQ": {"priority": "High"}}, "page": {"limit": 7}},
               {"sort": [{"key": "confidence", "order": "DESC"}], "page": {"limit": 25}},
               {"filter": {"OR": [{"EQ": {"priority": "Low"}}, {"IN": {"confidence": [0.5]}}]},
                "sort": [{"key": "priority"}, {"key": "i", "order": "DESC"}],
                "page": {"limit": 10}}]
    pages = {}
    for name, (sqlite_mod, _, _) in PACKAGES.items():
        store = sqlite_mod.build_sharded_store("q", tmp_path / name / "q.db", shards=4)
        try:
            for k, v in docs.items():
                await store.set(k, v)
            walked = []
            for q in queries:
                token = None
                while True:
                    page = dict(q.get("page") or {})
                    if token is not None:
                        page["token"] = token
                    resp = await store.query({**q, **({"page": page} if page else {})},
                                             key_prefix="k")
                    walked.append(([(i.key, i.value, i.etag) for i in resp.items], resp.token))
                    token = resp.token
                    if token is None:
                        break
            pages[name] = walked
        finally:
            store.close()
    assert pages["port"] == pages["jax"]
    assert sum(len(items) for items, _ in pages["port"][-12:]) > 0
