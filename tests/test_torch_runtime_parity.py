"""The port's runtime-hosted scorer against the JAX package's, on the CPU:

(a) the same answers: the same 16 saved-task events scored by the JAX
    scorer on ``InProcCluster`` and by the port's on ``InProcHost``, from
    the same params, and every stored score read back;
(b) the same protocol: the port's scorer, served by ``App.start``,
    behind a real ``tasksrunner`` runtime and sidecar (the two-process
    layout of ``tasksrunner sidecar --app-port P``, here in one loop);
(c) the port's spans readable by the JAX package's ``trace_spans``.
"""

import asyncio
import contextvars
import json

import numpy as np
import pytest

from tasksrunner.ml.platform import pin_cpu_platform

if not pin_cpu_platform():
    pytest.skip("jax cpu platform unavailable", allow_module_level=True)

import jax  # noqa: E402

from tasksrunner_torch import model, service, spans  # noqa: E402
from tasksrunner_torch.app import App  # noqa: E402
from tasksrunner_torch.batching import MicroBatcher  # noqa: E402
from tasksrunner_torch.hosting import InProcHost  # noqa: E402
from tasksrunner_torch.pubsub import InMemoryBroker  # noqa: E402
from tasksrunner_torch.state import InMemoryStateStore  # noqa: E402
from tasksrunner_torch.tracing import ensure_trace, trace_scope  # noqa: E402

PUBSUB, TOPIC = "taskspubsub", "tasksavedtopic"
# tests/test_torch_model.py's forward tolerance between the two packages
# (bf16 rounding lands at other places and accumulates): confidences
# agree within it, and the argmax wherever JAX's top two are further
# apart than twice that
CONFIDENCE_TOL = 2e-2
MARGIN = 4e-2

TASKS = [{"taskId": f"t-{i}",
          "taskName": f"{verb} the {thing} {i}",
          "taskCreatedBy": f"user{i % 3}@example.com",
          "taskAssignedTo": f"ops{i % 4}"}
         for i, (verb, thing) in enumerate(
             (v, t) for v in ("fix", "ship", "review", "water")
             for t in ("deploy", "docs", "plants", "outage"))]


def bounded(aw, seconds: float = 60):
    return asyncio.wait_for(aw, seconds)


def _jax_components():
    from tasksrunner.component.spec import parse_component
    return [parse_component({"componentType": "state.in-memory"}, default_name="scores"),
            parse_component({"componentType": "pubsub.in-memory"}, default_name=PUBSUB)]


async def _poll_scores(get, ids, seconds: float = 30) -> dict:
    """{task id: stored score}, polling ``get(id)`` (None while absent)."""
    async def poll():
        found = {}
        while len(found) < len(ids):
            for task_id in ids:
                if task_id not in found:
                    value = await get(task_id)
                    if value is not None:
                        found[task_id] = value
            await asyncio.sleep(0.02)
        return found
    return await bounded(poll(), seconds)


async def _jax_scores() -> dict:
    from tasksrunner import App as JaxApp
    from tasksrunner import InProcCluster
    from tasksrunner.ml.service import make_app as jax_make_app

    cluster = InProcCluster(_jax_components())
    cluster.add_app(jax_make_app())
    cluster.add_app(JaxApp("some-api"))
    await bounded(cluster.start(), 120)
    try:
        client = cluster.client("some-api")
        for task in TASKS:
            await bounded(client.publish_event(PUBSUB, TOPIC, task))

        async def get(task_id):
            r = await client.invoke_method("priority-scorer", f"scores/{task_id}",
                                           http_method="GET")
            return r.json() if r.status == 200 else None
        return await _poll_scores(get, [t["taskId"] for t in TASKS])
    finally:
        await bounded(cluster.stop())


async def _port_scores() -> dict:
    store = InMemoryStateStore("scores")
    host = InProcHost(state_stores={"scores": store},
                      brokers={PUBSUB: InMemoryBroker(PUBSUB, max_attempts=1)})
    host.add_app(service.make_app(device="cpu"))
    host.add_app(App("some-api"))
    await bounded(host.start())
    try:
        client = host.client("some-api")
        for task in TASKS:  # published during warm-up: deferred, then scored
            await bounded(client.publish_event(PUBSUB, TOPIC, task))

        async def get(task_id):
            r = await client.invoke_method("priority-scorer", f"scores/{task_id}",
                                           http_method="GET")
            return r.json() if r.status == 200 else None
        scores = await _poll_scores(get, [t["taskId"] for t in TASKS])
        assert host.brokers[PUBSUB].dead_letters == []
        return scores
    finally:
        await bounded(host.stop())


def test_stored_scores_match_the_jax_scorer(monkeypatch):
    # one bucket: the broker hands a group one event at a time, so every
    # event is a batch of one on both sides, and JAX compiles one shape
    monkeypatch.setenv("TASKSRUNNER_ML_BUCKETS", "1")
    from tasksrunner.ml import model as jax_model

    jcfg = jax_model.ModelConfig(n_classes=len(service.PRIORITY_LABELS))
    jax_params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jax_params)
    monkeypatch.setattr(service, "init_params",
                        lambda cfg, seed, device: model.params_from_jax(tree, device))

    want = asyncio.run(_jax_scores())
    got = asyncio.run(_port_scores())
    assert sorted(got) == sorted(want) == sorted(t["taskId"] for t in TASKS)

    texts = [" ".join(t[k] for k in ("taskName", "taskCreatedBy", "taskAssignedTo"))
             for t in TASKS]
    tokens = jax_model.hash_tokens(texts, jcfg)
    probs = np.asarray(jax.jit(lambda p, t: jax.nn.softmax(
        jax_model.forward(p, t, cfg=jcfg), axis=-1))(jax_params, tokens))
    top2 = np.sort(probs, axis=-1)[:, -2:]
    compared = 0
    for task, (second, first) in zip(TASKS, top2):
        task_id = task["taskId"]
        assert abs(got[task_id]["confidence"] - want[task_id]["confidence"]) <= CONFIDENCE_TOL
        if first - second > MARGIN:
            assert got[task_id]["priority"] == want[task_id]["priority"], task_id
            compared += 1
    assert compared >= len(TASKS) // 2  # the priority check is not vacuous


async def test_port_scorer_behind_the_jax_sidecar(monkeypatch):
    """The two-process layout in one loop: the port's scorer served over
    HTTP, a ``tasksrunner`` Runtime + Sidecar reaching it through an
    ``HTTPAppChannel``; the scorer's state calls go back to the sidecar
    over ``TASKSRUNNER_HTTP_PORT`` with the API token."""
    from tasksrunner.client import AppClient as JaxClient
    from tasksrunner.component.registry import ComponentRegistry
    from tasksrunner.runtime import HTTPAppChannel, Runtime
    from tasksrunner.sidecar import Sidecar

    monkeypatch.setenv("TASKSRUNNER_API_TOKEN", "s3cret")
    monkeypatch.setenv("TASKSRUNNER_MESH", "0")
    scorer = service.make_app(device="cpu")
    app_port = await bounded(scorer.start("127.0.0.1", 0))
    runtime = Runtime("priority-scorer",
                      ComponentRegistry(_jax_components(), app_id="priority-scorer"),
                      app_channel=HTTPAppChannel("127.0.0.1", app_port))
    sidecar = Sidecar(runtime, port=0)
    client = None
    try:
        await bounded(sidecar.start())
        monkeypatch.setenv("TASKSRUNNER_HTTP_PORT", str(sidecar.port))
        client = JaxClient.http(sidecar.port)
        task = {"taskId": "t-77", "taskName": "rotate the keys"}
        await bounded(client.publish_event(PUBSUB, TOPIC, task))

        async def get(task_id):
            r = await client.invoke_method("priority-scorer", f"scores/{task_id}",
                                           http_method="GET")
            assert r.status in (200, 404), r.body
            return r.json() if r.status == 200 else None
        stored = (await _poll_scores(get, ["t-77"]))["t-77"]
        direct = await bounded(client.invoke_method(
            "priority-scorer", "score", data={"taskName": "rotate the keys"}))
        assert direct.status == 200 and direct.json() == stored
        # saved through the sidecar's state API, under the app's key prefix
        assert await bounded(client.get_state("scores", "t-77")) == stored
        missing = await bounded(client.invoke_method(
            "priority-scorer", "scores/nope", http_method="GET"))
        assert missing.status == 404
    finally:
        if client is not None:
            await client.close()
        await bounded(sidecar.stop())
        await runtime.app_channel.close()
        await bounded(scorer.stop())


async def test_port_ml_request_span_reads_through_jax_trace_spans(tmp_path):
    from tasksrunner.observability.spans import trace_spans

    db = str(tmp_path / "traces.db")
    trace = "cd" * 16
    batcher = MicroBatcher(lambda items, bucket: items)
    spans.configure_spans("port", db)
    batcher.start()
    try:
        with trace_scope(ensure_trace(f"00-{trace}-{'34' * 8}-01")):
            assert await bounded(batcher.submit("x")) == "x"
    finally:
        await bounded(batcher.stop())
        spans.close_spans()
    rows = trace_spans(db, trace)
    assert [r["name"] for r in rows] == ["ml-request"]
    assert rows[0]["role"] == "port" and rows[0]["status"] == 200
    batch = trace_spans(db, json.loads(rows[0]["attrs"])["batch_trace"])
    assert [r["name"] for r in batch] == ["ml-batch"]


SPAN_TASK = {"taskId": "t-span", "taskName": "trace the saved task",
             "taskCreatedBy": "ops", "taskAssignedTo": "ops1"}


async def _each_in_its_own_context(client) -> None:
    """One ``/score`` invoke and one publish, each from a task of its own:
    each starts a trace of its own on either side (the JAX runtime
    installs a new root in its caller's context)."""
    await asyncio.ensure_future(bounded(client.invoke_method(
        "priority-scorer", "score", data={"taskName": SPAN_TASK["taskName"]})))
    await asyncio.ensure_future(bounded(client.publish_event(PUBSUB, TOPIC, SPAN_TASK)))


async def _jax_traced(db: str) -> None:
    from tasksrunner import App as JaxApp
    from tasksrunner import InProcCluster
    from tasksrunner.ml.service import make_app as jax_make_app
    from tasksrunner.observability import spans as jax_spans

    recorder = jax_spans.configure_spans("jax-proc")  # from TASKSRUNNER_TRACE_DB
    assert recorder is not None and recorder.path == db
    cluster = InProcCluster(_jax_components())
    cluster.add_app(jax_make_app())
    cluster.add_app(JaxApp("some-api"))
    try:
        await bounded(cluster.start(), 120)
        client = cluster.client("some-api")
        await _each_in_its_own_context(client)
        # read through the scorer's own client: its keys carry its prefix
        scorer = cluster.client("priority-scorer")
        await _poll_scores(lambda key: scorer.get_state("scores", key), [SPAN_TASK["taskId"]])
    finally:
        await bounded(cluster.stop())
        recorder.close()
        jax_spans._recorder = None


async def _port_traced() -> None:
    store = InMemoryStateStore("scores")
    host = InProcHost(state_stores={"scores": store},
                      brokers={PUBSUB: InMemoryBroker(PUBSUB, max_attempts=1)})
    host.add_app(service.make_app(device="cpu"))
    host.add_app(App("some-api"))
    try:
        await bounded(host.start())  # the apps record into TASKSRUNNER_TRACE_DB
        await bounded(host.wait_ready())
        await _each_in_its_own_context(host.client("some-api"))
        await _poll_scores(store.get, [SPAN_TASK["taskId"]])
    finally:
        await bounded(host.stop())
        spans.close_spans()


def _span_shapes(db: str) -> tuple[list, dict]:
    """Each trace's sorted (kind, name, parent's kind) of its spans, read
    by JAX's ``trace_spans``, sorted; and {first span's name: rows}."""
    from tasksrunner.observability.spans import list_traces, trace_spans

    shapes, rows_of = [], {}
    for trace in list_traces(db, limit=100):
        rows = trace_spans(db, trace["trace_id"])
        kinds = {r["span_id"]: r["kind"] for r in rows}
        shapes.append(sorted((r["kind"], r["name"], kinds.get(r["parent_id"]))
                             for r in rows))
        rows_of[rows[0]["name"]] = rows
    return sorted(shapes), rows_of


def test_spans_of_one_score_and_one_event_match_the_jax_scorer(monkeypatch, tmp_path):
    """The same span kinds, names and parent links from the port's scorer
    on ``InProcHost`` as from the JAX scorer on ``InProcCluster``; and the
    port's ``critical_path`` equal to JAX's on the port's file."""
    from tasksrunner.observability.spans import critical_path as jax_critical_path

    monkeypatch.setenv("TASKSRUNNER_ML_BUCKETS", "1")
    jax_db, port_db = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    # fresh contexts: no ambient trace that an earlier test in this
    # process left installed joins the two calls into one trace
    monkeypatch.setenv("TASKSRUNNER_TRACE_DB", jax_db)
    contextvars.Context().run(asyncio.run, _jax_traced(jax_db))
    monkeypatch.setenv("TASKSRUNNER_TRACE_DB", port_db)
    contextvars.Context().run(asyncio.run, _port_traced())

    want, _ = _span_shapes(jax_db)
    got, port_rows = _span_shapes(port_db)
    invoke = "invoke priority-scorer/score"
    publish = f"publish {PUBSUB}/{TOPIC}"
    batch = [("internal", "ml-batch", None)]
    assert want == sorted([
        [("client", invoke, None), ("internal", "ml-request", "server"),
         ("server", "POST /score", "client")],
        [("consumer", "POST /on-task-saved", "producer"),
         ("internal", "ml-request", "consumer"), ("producer", publish, None)],
        batch, batch])
    assert got == want

    for first in (invoke, publish):
        rows = port_rows[first]
        mine = spans.critical_path(rows)
        assert [hop["name"] for hop in mine] == [r["name"] for r in rows]
        assert mine == jax_critical_path(rows)
