"""The port's bindings, query API and queue-fed scorer against the JAX
package's, in one process on the CPU.

* One queue file, two packages: what a JAX ``SqliteQueue`` sends, the
  port's binding delivers, and the other way round; the backlog, the
  dead letters and ``open_queue_for_inspection`` read the same from both.
* Cron: ``CronSchedule(expr).next_after(t)`` at 200 seeded datetimes, each
  against the JAX engine (the sample's ``5 0 * * *``, steps, ranges,
  names, the day-of-month / day-of-week OR rule, ``@every``); malformed
  expressions raise ``BindingError`` in both.
* The routes: one script of ``POST /v1.0/bindings/{name}`` and ``POST
  /v1.0/state/{store}/query`` calls through the JAX sidecar and the
  port's (each beside an app of its package in its ``AppHost``, with
  grants) gives the same statuses and bodies, 403 without a grant and
  400 on a malformed query included; both apps' ``@app.binding`` routes
  get the same queue events, and the same metric names count them.
* The slice whole: the same 24 queue messages through the JAX scorer on
  the JAX host and the port's scorer on the port's host (``device="cpu"``)
  store the same keys with confidences within ``CONFIDENCE_TOL``, and
  each side's scores read back page by page through its sidecar's query
  route; and a message that meets a warming scorer is dead-lettered after
  ``maxRetries`` in both (a 503 nacks a binding's delivery, whatever its
  ``Retry-After``).
"""

import asyncio
import datetime as dt
import json
import sqlite3

import numpy as np
import pytest

from tasksrunner.ml.platform import pin_cpu_platform

if not pin_cpu_platform():
    pytest.skip("jax cpu platform unavailable", allow_module_level=True)

import jax  # noqa: E402

from tasksrunner.bindings import cron as jax_cron  # noqa: E402
from tasksrunner.bindings import localqueue as jax_localqueue  # noqa: E402
from tasksrunner.component.spec import parse_component as jax_parse_component  # noqa: E402
from tasksrunner.errors import BindingError as JaxBindingError  # noqa: E402
from tasksrunner_torch import model, service  # noqa: E402
from tasksrunner_torch.app import App  # noqa: E402
from tasksrunner_torch.bindings import cron, localqueue  # noqa: E402
from tasksrunner_torch.client import http_request  # noqa: E402
from tasksrunner_torch.component.registry import ComponentRegistry  # noqa: E402
from tasksrunner_torch.component.spec import parse_component  # noqa: E402
from tasksrunner_torch.errors import BindingError  # noqa: E402
from tasksrunner_torch.hosting import AppHost  # noqa: E402
from tasksrunner_torch.runtime import InProcAppChannel, Runtime  # noqa: E402

CONFIDENCE_TOL = 2e-2
QUEUE_TYPE = "bindings.azure.storagequeues"


def bounded(aw, seconds: float = 60):
    return asyncio.wait_for(aw, seconds)


async def wait_until(cond, seconds: float = 10.0, what: str = "condition"):
    deadline = asyncio.get_running_loop().time() + seconds
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"{what} not met in {seconds} s")
        await asyncio.sleep(0.02)


def _queue_doc(root, **extra) -> dict:
    return {"componentType": QUEUE_TYPE, "metadata": [
        {"name": "queuePath", "value": str(root)}, {"name": "queueName", "value": "extq"},
        *({"name": k, "value": str(v)} for k, v in extra.items())]}


# -- one queue file, two packages ----------------------------------------------

async def test_a_queue_file_is_shared_by_a_producer_and_a_consumer_of_either_package(tmp_path):
    root = tmp_path / "queues"
    doc = _queue_doc(root, pollIntervalSeconds=0.01, maxRetries=2, retryDelaySeconds=0.01)
    packages = {"jax": (jax_localqueue, jax_parse_component(doc, default_name="extq")),
                "port": (localqueue, parse_component(doc, default_name="extq"))}
    handles = {name: mod.SqliteQueue(root / "extq.db") for name, (mod, _) in packages.items()}

    def send(batch) -> None:  # the two producers interleaved
        for i in batch:
            handles["jax" if i % 2 else "port"].send({"i": i, "fail": i == 4})
        assert handles["jax"].backlog() == handles["port"].backlog() == 3
        for name, (mod, spec) in packages.items():
            inspected = mod.open_queue_for_inspection(spec, tmp_path)
            assert inspected.backlog() == 3
            inspected.close()

    got = {"jax": [], "port": []}

    def sink_of(name):
        async def sink(event):
            got[name].append((event.data["i"], event.metadata["attempt"]))
            return not event.data["fail"]
        return sink

    # the JAX binding drains the first batch and stops on an empty queue
    # (a binding stopped between its claim and the delivery would leave
    # the message to its 30 s lease, in both packages); the port's binding
    # drains the second
    send(range(3))
    jax_binding = jax_localqueue._localqueue_binding(packages["jax"][1], {
        m["name"]: m["value"] for m in doc["metadata"]})
    await jax_binding.start(sink_of("jax"))
    await wait_until(lambda: handles["jax"].backlog() == 0, what="the JAX binding's drain")
    await jax_binding.stop()
    send(range(3, 6))
    port_binding = localqueue._localqueue_binding(packages["port"][1], {
        m["name"]: m["value"] for m in doc["metadata"]})
    await port_binding.start(sink_of("port"))
    await wait_until(lambda: handles["port"].backlog() == 0, what="the drain")
    await port_binding.stop()
    delivered = sorted(got["jax"] + got["port"])
    assert [i for i, a in delivered if a == "1"] == list(range(6))
    assert (4, "2") in delivered  # the failing message, delivered twice, then parked
    for name in ("jax", "port"):
        detail = handles[name].dead_letter_detail()
        assert [(d["data"], d["attempts"]) for d in detail] == [({"i": 4, "fail": True}, 2)]
    assert handles["jax"].requeue_dead_letters() == 1
    assert handles["port"].backlog() == handles["jax"].backlog() == 1
    assert handles["port"].purge_dead_letters() == 0
    for handle in handles.values():
        handle.close()
    with sqlite3.connect(root / "extq.db") as conn:
        assert conn.execute("SELECT COUNT(*) FROM queue WHERE done = 1").fetchone() == (5,)


def test_open_queue_for_inspection_refuses_what_the_jax_one_refuses(tmp_path):
    for doc in ({"componentType": "pubsub.sqlite"},
                {"componentType": QUEUE_TYPE, "metadata": [
                    {"name": "queuePath", "secretRef": "p"}]}):
        with pytest.raises(Exception) as want:
            jax_localqueue.open_queue_for_inspection(
                jax_parse_component(doc, default_name="q"), tmp_path, must_exist=False)
        with pytest.raises(Exception) as got:
            localqueue.open_queue_for_inspection(parse_component(doc, default_name="q"), tmp_path)
        assert type(got.value).__name__ == type(want.value).__name__ == "ComponentError"
    # a file not made yet: the port's one caller (the scaler) reads a
    # backlog of 0, as the JAX scaler does through ``must_exist=False``
    doc = _queue_doc(tmp_path / "none")
    want = jax_localqueue.open_queue_for_inspection(
        jax_parse_component(doc, default_name="q"), tmp_path, must_exist=False)
    got = localqueue.open_queue_for_inspection(parse_component(doc, default_name="q"), tmp_path)
    assert got.backlog() == want.backlog() == 0
    got.close()
    want.close()


# -- cron ------------------------------------------------------------------------

CRON_EXPRESSIONS = [
    "5 0 * * *",                      # the sample's schedule
    "*/15 * * * *",                   # a step
    "0-30/10 9-17 * * mon-fri",       # ranges, a ranged step, day names
    "7/20 */3 * * *",                 # N/step
    "*/10 * 13 * fri",                # day of month OR day of week
    "0 12 1,15 * sat,sun",            # lists, the OR rule again
    "0 0 * * 7",                      # 7 is Sunday
    "30 6 * feb-dec SUN-sat",         # month names, mixed case
    "0 30 8 * * *",                   # six fields, a seconds field of 0
    "@every 90s",
    "@every 250ms",
]
CRON_DATETIMES = 200


@pytest.mark.parametrize("expr", CRON_EXPRESSIONS)
def test_cron_next_after_matches_the_jax_engine(expr):
    rng = np.random.default_rng(CRON_EXPRESSIONS.index(expr))
    start = dt.datetime(2026, 1, 1)
    got, want = cron.CronSchedule(expr), jax_cron.CronSchedule(expr)
    n = CRON_DATETIMES // len(CRON_EXPRESSIONS) + 1  # 200 datetimes over the expressions
    for seconds in rng.integers(0, 4 * 365 * 86400, n):
        t = start + dt.timedelta(seconds=int(seconds), microseconds=int(rng.integers(10**6)))
        nxt = got.next_after(t)
        assert nxt == want.next_after(t), (expr, t)
        assert nxt > t
        assert got.next_after(nxt) == want.next_after(nxt)  # and the fire after it
        if got.interval is None:
            assert got.matches(nxt) and want.matches(nxt)


@pytest.mark.parametrize("expr", [
    "5 0 * *", "61 * * * *", "* * * * * *", "*/0 * * * *", "5-1 * * * *", "x * * * *",
    "0 0 32 * *", "0 0 * 13 *", "0 0 * * 8", "@every 5x", "@every", "1 2 3 4 5 6 7",
    "0 0 * * mon-", "*/a * * * *",
])
def test_a_malformed_cron_expression_raises_binding_error_in_both(expr):
    with pytest.raises(JaxBindingError) as want:
        jax_cron.CronSchedule(expr)
    with pytest.raises(BindingError) as got:
        cron.CronSchedule(expr)
    assert str(got.value) == str(want.value)


# -- the routes, through both sidecars ------------------------------------------

GRANTS = {"kv": ["read", "write"], "audit": ["write"], "blobs": ["invoke"], "mail": ["invoke"],
          "tick": ["invoke"], "q": ["invoke"]}
DOCS = [{"key": f"k{i}", "value": v} for i, v in enumerate([
    {"p": "high", "c": 0.9, "who": {"city": "Athens"}}, {"p": "low", "c": 0.2},
    {"p": "high", "c": 0.4, "who": {"city": "Berlin"}}, {"p": None, "c": 0.7},
    {"c": 0.1}, {"p": "medium", "c": 0.55, "tags": ["x"]}])]
SCRIPT = [  # (path, body)
    ("/v1.0/state/kv/query", {"filter": {"EQ": {"p": "high"}}}),
    ("/v1.0/state/kv/query", {"sort": [{"key": "c", "order": "DESC"}], "page": {"limit": 2}}),
    ("/v1.0/state/kv/query", {"sort": [{"key": "c", "order": "DESC"}],
                              "page": {"limit": 2, "token": "2"}}),
    ("/v1.0/state/kv/query", {"filter": {"IN": {"p": [None, "low"]}}, "sort": [{"key": "c"}]}),
    ("/v1.0/state/kv/query", {"filter": {"OR": [{"EQ": {"who.city": "Berlin"}},
                                                {"AND": [{"NEQ": {"p": "high"}},
                                                         {"EQ": {"c": 0.55}}]}]}}),
    ("/v1.0/state/kv/query", {}),
    ("/v1.0/state/kv/query", {"filter": {"BOGUS": {"a": 1}}}),
    ("/v1.0/state/kv/query", {"filter": {"EQ": {"tags": ["x"]}}}),
    ("/v1.0/state/kv/query", {"page": {"limit": 2, "token": "xyz"}}),
    ("/v1.0/state/kv/query", [1]),
    ("/v1.0/state/kv/query", b"{bad"),
    ("/v1.0/state/audit/query", {}),
    ("/v1.0/state/nope/query", {}),
    ("/v1.0/bindings/blobs", {"operation": "create", "data": {"taskId": "t1"},
                              "metadata": {"blobName": "t1.json"}}),
    ("/v1.0/bindings/blobs", {"operation": "create", "data": "plain text",
                              "metadata": {"blobName": "dir/t2.txt"}}),
    ("/v1.0/bindings/blobs", {"operation": "get", "metadata": {"blobName": "t1.json"}}),
    ("/v1.0/bindings/blobs", {"operation": "list"}),
    ("/v1.0/bindings/blobs", {"operation": "get", "metadata": {"blobName": "nope.json"}}),
    ("/v1.0/bindings/blobs", {"operation": "get"}),
    ("/v1.0/bindings/blobs", {"operation": "create", "metadata": {"blobName": "../out"}}),
    ("/v1.0/bindings/blobs", {"operation": "delete", "metadata": {"blobName": "dir/t2.txt"}}),
    ("/v1.0/bindings/blobs", {"operation": "rename"}),
    ("/v1.0/bindings/mail", {"data": "<b>hi</b>", "metadata": {"emailTo": "a@x.com",
                                                               "subject": "s"}}),
    ("/v1.0/bindings/mail", {"data": "no recipient"}),
    ("/v1.0/bindings/q", {"operation": "create", "data": {"taskId": "from-binding"}}),
    ("/v1.0/bindings/q", {"operation": "get"}),
    ("/v1.0/bindings/tick", {"data": 1}),
    ("/v1.0/bindings/audit", {}),
    ("/v1.0/bindings/ghost", {}),
    ("/v1.0/bindings/blobs", b"{bad"),
]


def _write_route_components(root, data) -> None:
    root.mkdir()
    files = {
        "kv": ("state.sqlite", {"databasePath": data / "kv.db"}),
        "audit": ("state.in-memory", {}),
        "q": ("bindings.localqueue", {"queuePath": data / "queues", "route": "/in",
                                      "pollIntervalSeconds": 0.01, "maxRetries": 2,
                                      "retryDelaySeconds": 0.01}),
        "blobs": ("bindings.localblob", {"blobPath": data / "blobs", "container": "c"}),
        "mail": ("bindings.smtp", {"outboxPath": data / "outbox",
                                   "emailFrom": "noreply@x"}),
        "tick": ("bindings.cron", {"schedule": "5 0 * * *"}),
    }
    for name, (type_, meta) in files.items():
        items = "".join(f"\n  - name: {k}\n    value: \"{v}\"" for k, v in meta.items())
        (root / f"{name}.yaml").write_text(
            f"apiVersion: dapr.io/v1alpha1\nkind: Component\nmetadata:\n  name: {name}\n"
            f"spec:\n  type: {type_}\n  version: v1\n  metadata:{items or ' []'}\n")


def _normalise(payload):
    """Ids made up per call (message, mail) as a placeholder."""
    if isinstance(payload, dict) and isinstance(payload.get("metadata"), dict):
        meta = payload["metadata"]
        for key in ("messageId", "mailId"):
            if key in meta:
                meta[key] = "an id"
    return payload


async def _drive_routes(host, data, producer_cls, received) -> dict:
    port = host.sidecar_port

    async def call(method, path, body=None):
        raw = body if isinstance(body, bytes) or body is None else json.dumps(body).encode()
        status, _, payload = await bounded(http_request("127.0.0.1", port, method, path,
                                                        body=raw or b""), 20)
        return status, json.loads(payload) if payload else None

    before = (await call("GET", "/v1.0/metadata"))[1]["metrics"]
    out: dict = {"save": await call("POST", "/v1.0/state/kv", DOCS)}
    out["script"] = [(path, *map(_normalise, await call("POST", path, body)))
                     for path, body in SCRIPT]
    # an outside producer of the other package; one message the app fails
    producer = producer_cls(data / "queues" / "q.db")
    producer.send({"taskId": "from-outside"})
    producer.send({"taskId": "poison"})
    await bounded(wait_until(lambda: producer.backlog() == 0, what="the queue's drain"))
    out["dead_letters"] = [(d["data"], d["attempts"]) for d in producer.dead_letter_detail()]
    producer.close()
    out["received"] = sorted(received)
    out["mail"] = [{k: m[k] for k in ("from", "to", "toName", "subject", "body")}
                   for m in (json.loads(p.read_text()) for p in (data / "outbox").glob("*.json"))]
    meta = (await call("GET", "/v1.0/metadata"))[1]
    out["components"] = meta["components"]
    # the counters this script moved (the registry is the process's; the
    # port's snapshot also lists each histogram's count, sum and max)
    out["metric_names"] = sorted(
        k for k, v in meta["metrics"].items()
        if k.startswith(("binding_", "state_query")) and "_seconds" not in k
        and v != before.get(k))
    out["histogram_names"] = sorted(
        k for k in meta.get("histograms", {}) if k.startswith("binding_"))
    return out


def _receiver(app_cls, received: list):
    app = app_cls("processor")

    @app.binding("q", route="/in")
    async def on_queue(req):
        received.append((json.dumps(req.data, sort_keys=True), req.headers.get("attempt"),
                         req.headers.get("content-type")))
        return 500 if req.data.get("taskId") == "poison" else 200

    return app


async def _jax_routes(data) -> dict:
    from tasksrunner.app import App as JaxApp
    from tasksrunner.hosting import AppHost as JaxAppHost

    _write_route_components(data / "components", data)
    received: list = []
    host = JaxAppHost(_receiver(JaxApp, received), components_path=str(data / "components"),
                      registry_file=str(data / "apps.json"))
    await bounded(host.start())
    try:
        return await _drive_routes(host, data, localqueue.SqliteQueue, received)
    finally:
        await bounded(host.stop())


async def _port_routes(data) -> dict:
    _write_route_components(data / "components", data)
    received: list = []
    host = AppHost(_receiver(App, received), components_path=str(data / "components"),
                   registry_file=str(data / "apps.json"))
    await bounded(host.start())
    try:
        return await _drive_routes(host, data, jax_localqueue.SqliteQueue, received)
    finally:
        await bounded(host.stop())


def test_the_bindings_and_query_routes_answer_as_the_jax_sidecar(tmp_path, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_MESH", "0")
    monkeypatch.setenv("TASKSRUNNER_GRANTS", json.dumps(GRANTS))
    monkeypatch.delenv("TASKSRUNNER_API_TOKEN", raising=False)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = asyncio.run(_jax_routes(tmp_path / "jax"))
    got = asyncio.run(_port_routes(tmp_path / "port"))
    assert got["save"] == want["save"] == (204, None)
    for (path, *g), (_, *w), (_, body) in zip(got["script"], want["script"], SCRIPT):
        assert g == w, (path, body)
    statuses = [s for _, s, _ in got["script"]]
    assert statuses.count(403) == 4 and statuses.count(400) >= 5
    assert got["dead_letters"] == want["dead_letters"] == [({"taskId": "poison"}, 2)]
    assert got["received"] == want["received"]
    assert [a for _, a, _ in got["received"]] == ["1", "1", "1", "2"]
    assert got["mail"] == want["mail"] and len(got["mail"]) == 1
    assert got["components"] == want["components"]
    assert got["metric_names"] == want["metric_names"]
    assert got["histogram_names"] == want["histogram_names"] == [
        "binding_delivery_latency_seconds", "binding_latency_seconds"]


# -- the slice whole: the queue-fed scorer ---------------------------------------

TASKS = [{"taskId": f"q-{i}", "taskName": f"{verb} the {thing} {i}",
          "taskCreatedBy": f"user{i % 3}@example.com", "taskAssignedTo": f"ops{i % 4}"}
         for i, (verb, thing) in enumerate(
             (v, t) for v in ("fix", "ship", "review", "water", "plan", "test")
             for t in ("deploy", "docs", "plants", "outage"))]


def _write_scorer_components(root, data) -> None:
    root.mkdir()
    (root / "scores.yaml").write_text(
        "componentType: state.azure.cosmosdb\nmetadata:\n- name: databasePath\n"
        f"  value: {data / 'scores.db'}\nscopes:\n- priority-scorer\n")
    (root / "queue.yaml").write_text(
        f"componentType: {QUEUE_TYPE}\nmetadata:\n- name: queueName\n"
        "  value: external-tasks-queue\n- name: queuePath\n"
        f"  value: {data / 'queues'}\n- name: route\n  value: /on-task-saved\n"
        "- name: pollIntervalSeconds\n  value: \"0.01\"\nscopes:\n- priority-scorer\n")


def _stored(data) -> dict:
    with sqlite3.connect(data / "scores.db") as conn:
        return {k.split("||", 1)[1]: json.loads(v)
                for k, v in conn.execute("SELECT key, value FROM state")}


async def _drive_scorer(host, data, producer_cls) -> dict:
    producer = producer_cls(data / "queues" / "external-tasks-queue.db")
    for task in TASKS:
        producer.send(task)
    producer.send({"not": "a task"})  # acked, nothing stored
    await bounded(wait_until(lambda: producer.backlog() == 0, 60, "the queue's drain"))
    dead = producer.dead_letter_detail()
    producer.close()
    stored = _stored(data)
    pages, token, union = [], None, []
    for priority in sorted({v["priority"] for v in stored.values()}):
        while True:
            query = {"filter": {"EQ": {"priority": priority}},
                     "sort": [{"key": "confidence", "order": "DESC"}],
                     "page": {"limit": 5, **({"token": token} if token else {})}}
            status, _, body = await bounded(http_request(
                "127.0.0.1", host.sidecar_port, "POST", "/v1.0/state/scores/query",
                body=json.dumps(query).encode()))
            assert status == 200, body
            doc = json.loads(body)
            pages.append([r["data"]["confidence"] for r in doc["results"]])
            union += [(r["key"], r["data"]) for r in doc["results"]]
            token = doc["token"]
            if token is None:
                break
    return {"stored": stored, "dead": dead, "pages": pages, "union": union}


async def _jax_scorer(data) -> dict:
    from tasksrunner.hosting import AppHost as JaxAppHost
    from tasksrunner.ml.service import make_app as jax_make_app

    _write_scorer_components(data / "components", data)
    host = JaxAppHost(jax_make_app(), components_path=str(data / "components"),
                      registry_file=str(data / "apps.json"))
    await bounded(host.start(), 120)  # the JAX host warms the model up in start
    try:
        return await _drive_scorer(host, data, localqueue.SqliteQueue)
    finally:
        await bounded(host.stop())


async def _port_scorer(data) -> dict:
    _write_scorer_components(data / "components", data)
    app = service.make_app(device="cpu")
    host = AppHost(app, components_path=str(data / "components"),
                   registry_file=str(data / "apps.json"))
    await bounded(host.start())
    try:
        await bounded(app.wait_ready())
        return await _drive_scorer(host, data, jax_localqueue.SqliteQueue)
    finally:
        await bounded(host.stop())


def test_the_queue_fed_scorer_stores_the_jax_scorers_scores(tmp_path, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_ML_BUCKETS", "1")  # one jit compile on the JAX side
    monkeypatch.setenv("TASKSRUNNER_MESH", "0")
    monkeypatch.delenv("TASKSRUNNER_GRANTS", raising=False)
    from tasksrunner.ml import model as jax_model

    jcfg = jax_model.ModelConfig(n_classes=len(service.PRIORITY_LABELS))
    tree = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(service, "init_params",
                        lambda cfg, seed, device: model.params_from_jax(tree, device))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = asyncio.run(_jax_scorer(tmp_path / "jax"))
    got = asyncio.run(_port_scorer(tmp_path / "port"))
    ids = sorted(t["taskId"] for t in TASKS)
    assert sorted(got["stored"]) == sorted(want["stored"]) == ids
    for task_id, value in got["stored"].items():
        assert abs(value["confidence"] - want["stored"][task_id]["confidence"]) <= CONFIDENCE_TOL
    assert got["dead"] == want["dead"] == []
    for side in (got, want):  # each side's query: the union is the store, in order
        assert sorted(k for k, _ in side["union"]) == ids
        assert all(side["stored"][k] == v for k, v in side["union"])
        assert all(page == sorted(page, reverse=True) for page in side["pages"])


async def _warming(app, registry_cls, runtime_cls, channel_cls, spec) -> list:
    """A message sent while the scorer has not warmed up: each delivery is
    answered 503 and nacked, until the queue parks it."""
    runtime = runtime_cls("priority-scorer", registry_cls([spec], app_id="priority-scorer"),
                          app_channel=channel_cls(app))
    await bounded(runtime.start())
    try:
        queue = runtime.registry.get("extq").queue
        queue.send(TASKS[0])
        await bounded(wait_until(lambda: queue.dead_letter_detail(), 10, "a dead letter"))
        return [(d["data"], d["attempts"]) for d in queue.dead_letter_detail()]
    finally:
        await bounded(runtime.stop())


def test_a_warming_scorer_dead_letters_a_queue_message_after_max_retries(tmp_path, monkeypatch):
    """The reference's own behaviour, kept: a binding's delivery ignores a
    503's Retry-After, so a message that meets the warm-up uses up its
    ``maxRetries`` and is parked."""
    monkeypatch.setenv("TASKSRUNNER_MESH", "0")
    monkeypatch.delenv("TASKSRUNNER_GRANTS", raising=False)
    from tasksrunner.component.registry import ComponentRegistry as JaxRegistry
    from tasksrunner.ml.service import make_app as jax_make_app
    from tasksrunner.runtime import InProcAppChannel as JaxChannel
    from tasksrunner.runtime import Runtime as JaxRuntime

    results = {}
    for name, make, registry_cls, runtime_cls, channel_cls, parse in (
            ("jax", jax_make_app, JaxRegistry, JaxRuntime, JaxChannel, jax_parse_component),
            ("port", lambda: service.make_app(device="cpu"), ComponentRegistry, Runtime,
             InProcAppChannel, parse_component)):
        doc = _queue_doc(tmp_path / name, route="/on-task-saved", pollIntervalSeconds=0.01,
                         maxRetries=3, retryDelaySeconds=0.01)
        # the app is never begun: its model never loads, every event meets the warm-up
        results[name] = asyncio.run(_warming(make(), registry_cls, runtime_cls, channel_cls,
                                             parse(doc, default_name="extq")))
    assert results["port"] == results["jax"] == [(TASKS[0], 3)]
