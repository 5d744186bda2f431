"""The port's scorer on its runtime, on the CPU: the in-process host
(tasksrunner_torch/hosting.py) with its broker and state store, the
saved-task subscription and ``GET /scores/{id}``, the warm-up's and the
shedding front door's nacks, the batcher's spans, and the app's routing.
No JAX: this file runs where only PyTorch is. Every await is bounded."""

import asyncio
import json
import sqlite3
import threading

import pytest

from tasksrunner_torch import admission, cloudevents, service, spans
from tasksrunner_torch.app import App, Response
from tasksrunner_torch.batching import BatcherConfig, MicroBatcher
from tasksrunner_torch.client import http_request
from tasksrunner_torch.hosting import InProcHost
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.pubsub import InMemoryBroker
from tasksrunner_torch.state import InMemoryStateStore
from tasksrunner_torch.tracing import current_trace, ensure_trace, trace_scope

TRACE = "ab" * 16
PARENT_SPAN = "12" * 8
ROOT_TRACEPARENT = f"00-{TRACE}-{PARENT_SPAN}-01"
PUBSUB, TOPIC = "taskspubsub", "tasksavedtopic"


def bounded(aw, seconds: float = 30):
    return asyncio.wait_for(aw, seconds)


def _host(max_attempts: int = 3):
    """The scorer (on the CPU) and a publisher app in one host. With
    ``max_attempts=1`` a nack that used up an attempt dead-letters the
    event at once, so every stored event proves its nacks used none."""
    store = InMemoryStateStore("scores")
    broker = InMemoryBroker(PUBSUB, max_attempts=max_attempts)
    host = InProcHost(state_stores={"scores": store}, brokers={PUBSUB: broker})
    scorer = service.make_app(device="cpu")
    host.add_app(scorer)
    host.add_app(App("some-api"))
    return host, scorer, store, broker


async def _stored(store, keys, seconds: float = 20):
    """Wait until every key is in the store."""
    async def poll():
        while not all(k in store.keys() for k in keys):
            await asyncio.sleep(0.02)
    await bounded(poll(), seconds)


def _gate_warmup(monkeypatch) -> threading.Event:
    gate = threading.Event()
    real_init = service.init_params

    def gated_init(*args, **kwargs):
        gate.wait(20)
        return real_init(*args, **kwargs)

    monkeypatch.setattr(service, "init_params", gated_init)
    return gate


async def test_scorer_service_on_the_runtime():
    """The scorer slots into the runtime like any other app: /score over
    service invocation, and a saved-task event scored through the
    subscription, written to the scores store and read back."""
    host, _, _, _ = _host()
    await bounded(host.start())
    try:
        await bounded(host.wait_ready())
        client = host.client("some-api")
        resp = await bounded(client.invoke_method(
            "priority-scorer", "score", data={"taskName": "fix prod outage"}))
        assert resp.status == 200
        doc = resp.json()
        assert doc["priority"] in service.PRIORITY_LABELS
        assert 0.0 < doc["confidence"] <= 1.0

        await bounded(client.publish_event(
            PUBSUB, TOPIC, {"taskId": "t-42", "taskName": "water the plants"}))
        score = None
        while score is None:
            r = await bounded(client.invoke_method("priority-scorer", "scores/t-42",
                                                   http_method="GET"))
            if r.status == 200:
                score = r.json()
            else:
                assert r.status == 404
                await asyncio.sleep(0.02)
        assert score["priority"] in service.PRIORITY_LABELS
        # the stored score is the synchronous lane's answer for the task
        direct = await bounded(client.invoke_method(
            "priority-scorer", "score", data={"taskName": "water the plants"}))
        assert direct.json() == score
    finally:
        await bounded(host.stop())


async def test_event_published_during_warmup_is_deferred_then_stored(monkeypatch):
    gate = _gate_warmup(monkeypatch)
    host, _, store, broker = _host(max_attempts=1)
    await bounded(host.start())
    try:
        client = host.client("some-api")
        await bounded(client.publish_event(
            PUBSUB, TOPIC, {"taskId": "early", "taskName": "publish before warm-up"}))

        async def declined():
            while not host.declined.get(503):
                await asyncio.sleep(0.01)
        await bounded(declined(), 10)
        r = await bounded(client.invoke_method("priority-scorer", "score",
                                               data={"taskName": "too soon"}))
        assert r.status == 503 and r.headers["retry-after"] == "1"
        gate.set()
        await _stored(store, ["early"])
        assert broker.dead_letters == []
        assert set(host.declined) == {503}
    finally:
        gate.set()
        await bounded(host.stop())


async def test_non_task_events_are_acked_and_nothing_is_stored():
    host, _, store, broker = _host(max_attempts=1)
    await bounded(host.start())
    try:
        await bounded(host.wait_ready())
        client = host.client("some-api")
        for event in ({"note": "no task here"}, {"taskId": "", "taskName": "blank id"},
                      ["not", "an", "object"]):
            await bounded(client.publish_event(PUBSUB, TOPIC, event))
        # one group takes one message at a time: once the last event is
        # stored, the three before it were answered
        await bounded(client.publish_event(PUBSUB, TOPIC, {"taskId": "real", "taskName": "x"}))
        await _stored(store, ["real"])
        assert store.keys() == ["real"]
        assert broker.dead_letters == [] and host.declined == {}
    finally:
        await bounded(host.stop())


async def test_missing_score_is_404():
    host, _, _, _ = _host()
    await bounded(host.start())
    try:
        await bounded(host.wait_ready())
        r = await bounded(host.client("some-api").invoke_method(
            "priority-scorer", "scores/missing", http_method="GET"))
        assert r.status == 404
        assert r.json() == {"error": "no score for missing"}
    finally:
        await bounded(host.stop())


async def test_admission_drill_sheds_at_the_front_door_and_stores_every_event(monkeypatch):
    """A burst fills the batcher's token budget while its batches are
    held: the sampler flips the front door to 429 + Retry-After, the
    health and runtime paths stay open, the events published meanwhile
    are nacked without using an attempt, and the gate holds until the
    score falls below 0.75. Every event is stored in the end."""
    monkeypatch.setenv("TASKSRUNNER_ADMISSION", "1")
    burst = 8
    # each burst task has 3 words, so 3 tokens: the burst fills exactly
    # the budget, and the score it leaves is 1.0 (Retry-After 1 s)
    monkeypatch.setenv("TASKSRUNNER_ML_MAX_TOKENS", str(3 * burst))
    hold = threading.Event()
    hold.set()
    real_probs = service.batch_probs

    def held_probs(*args, **kwargs):
        hold.wait(20)
        return real_probs(*args, **kwargs)

    monkeypatch.setattr(service, "batch_probs", held_probs)
    host, scorer, store, broker = _host(max_attempts=1)
    drill = {"level": 0.0}
    await bounded(host.start())
    try:
        await bounded(host.wait_ready())
        client = host.client("some-api")
        hold.clear()
        flood = [asyncio.ensure_future(client.invoke_method(
            "priority-scorer", "score", data={"taskName": f"drill task {i}"}))
            for i in range(burst)]

        async def shedding():
            while not scorer.admission.shedding:
                await asyncio.sleep(0.01)
        await bounded(shedding(), 10)  # the sampler's own tick

        r = await bounded(client.invoke_method("priority-scorer", "score",
                                               data={"taskName": "shed me"}))
        assert r.status == 429 and r.headers["retry-after"] == "1"
        assert (await bounded(client.invoke_method(
            "priority-scorer", "ml/stats", http_method="GET"))).status == 429
        for path in ("healthz", "tasksrunner/healthz"):
            assert (await bounded(client.invoke_method(
                "priority-scorer", path, http_method="GET"))).status == 204
        doc = await bounded(client.invoke_method(
            "priority-scorer", "tasksrunner/subscribe", http_method="GET"))
        assert doc.status == 200 and doc.json()[0]["topic"] == TOPIC
        events = [f"flood-{i}" for i in range(4)]
        for task_id in events:
            await bounded(client.publish_event(
                PUBSUB, TOPIC, {"taskId": task_id, "taskName": f"saved {task_id}"}))

        async def declined():
            while not host.declined.get(429):
                await asyncio.sleep(0.01)
        await bounded(declined(), 10)
        snap = metrics.snapshot()
        assert snap["admission_state"] == 1.0
        assert snap["admission_shed_total{route=app}"] >= 3

        # hysteresis: the batches drain, but a score of 0.8 keeps it shedding
        admission.register_signal("drill", lambda: drill["level"])
        drill["level"] = 0.8
        hold.set()
        replies = await bounded(asyncio.gather(*flood))
        assert [r.status for r in replies] == [200] * burst
        assert scorer.admission.sample() == pytest.approx(0.8)
        assert scorer.admission.shedding
        drill["level"] = 0.5
        assert scorer.admission.sample() < 0.75
        assert not scorer.admission.shedding

        await _stored(store, events)
        assert broker.dead_letters == []
        assert 503 not in host.declined
    finally:
        hold.set()
        admission.unregister_signal("drill")
        await bounded(host.stop())
    # the scorer's signal goes with it
    assert "ml_tokens_in_flight" not in admission._EXTRA_SIGNALS


def _rows(path: str, trace_id: str) -> list[dict]:
    conn = sqlite3.connect(path)
    conn.row_factory = sqlite3.Row
    try:
        return [dict(r) for r in conn.execute(
            "SELECT * FROM spans WHERE trace_id = ? ORDER BY start", (trace_id,))]
    finally:
        conn.close()


@pytest.mark.parametrize("fails", [False, True], ids=["ok", "failed"])
async def test_ml_batch_spans_split_queue_wait_from_service(tmp_path, fails):
    db = str(tmp_path / "traces.db")

    def run_batch(items, bucket):
        import time
        time.sleep(0.01)
        if fails:
            raise RuntimeError("batch crashed")
        return [i * 2 for i in items]

    mb = MicroBatcher(run_batch, config=BatcherConfig(max_delay_ms=5))
    spans.configure_spans("port-proc", db)
    mb.start()
    try:
        with trace_scope(ensure_trace(ROOT_TRACEPARENT)):
            submitter = current_trace()
            if fails:
                with pytest.raises(RuntimeError, match="batch crashed"):
                    await bounded(mb.submit(21))
            else:
                assert await bounded(mb.submit(21)) == 42
    finally:
        await bounded(mb.stop())
        spans.close_spans()

    status = 500 if fails else 200
    reqs = [s for s in _rows(db, TRACE) if s["name"] == "ml-request"]
    assert len(reqs) == 1
    req = reqs[0]
    # the request span joins the submitter's trace, under its span
    assert req["parent_id"] == submitter.span_id and req["status"] == status
    attrs = json.loads(req["attrs"])
    assert attrs["queue_wait"] >= 0 and attrs["service"] > 0
    assert req["duration"] == pytest.approx(attrs["queue_wait"] + attrs["service"], rel=0.2)
    # ...and points at the batch span, which roots its own trace
    batch_trace = attrs["batch_trace"]
    assert batch_trace != TRACE
    batch = [s for s in _rows(db, batch_trace) if s["name"] == "ml-batch"]
    assert len(batch) == 1 and batch[0]["status"] == status
    assert json.loads(batch[0]["attrs"]) == {"bucket": 1, "size": 1}
    assert batch[0]["role"] == "port-proc"


async def test_saved_task_event_carries_the_publisher_trace_to_ml_request(tmp_path):
    db = str(tmp_path / "traces.db")
    host, _, store, _ = _host()
    spans.configure_spans("inproc", db)
    try:
        await bounded(host.start())
        await bounded(host.wait_ready())
        with trace_scope(ensure_trace(ROOT_TRACEPARENT)):
            await bounded(host.client("some-api").publish_event(
                PUBSUB, TOPIC, {"taskId": "traced", "taskName": "follow the trace"}))
        await _stored(store, ["traced"])
    finally:
        await bounded(host.stop())
        spans.close_spans()
    reqs = [s for s in _rows(db, TRACE) if s["name"] == "ml-request"]
    assert len(reqs) == 1
    # publisher's span → the published message's span → the handler's span
    assert reqs[0]["parent_id"] not in (None, PARENT_SPAN)


async def test_routes_with_path_params_and_the_subscription_document():
    app = App("router")
    seen = {}

    @app.get("/scores/latest")
    async def latest(req):
        return {"route": "exact"}

    @app.get("/scores/{task_id}")
    async def by_id(req):
        return {"route": "param", **req.path_params}

    @app.post("/items/{group}/{item}")
    async def item(req):
        return 201, req.path_params

    @app.subscribe(PUBSUB, TOPIC, "/on-saved")
    async def on_saved(req):
        seen["data"] = req.data
        return 200

    async def call(method, path, headers=None, body=b""):
        return await bounded(app.handle(method, path, headers or {}, body))

    assert (await call("GET", "/scores/latest")).body == {"route": "exact"}
    got = await call("GET", "/scores/t-7?verbose=1")
    assert got.body == {"route": "param", "task_id": "t-7"}
    got = await call("POST", "/items/a/b")
    assert (got.status, got.body) == (201, {"group": "a", "item": "b"})
    assert (await call("POST", "/scores/t-7")).status == 405
    assert (await call("GET", "/scores/a/b")).status == 404
    assert (await call("GET", "/healthz")).status == 204
    assert (await call("GET", "/tasksrunner/healthz")).status == 204
    want = [{"pubsubname": PUBSUB, "topic": TOPIC, "route": "/on-saved"}]
    assert (await call("GET", "/dapr/subscribe")).body == want
    assert (await call("GET", "/tasksrunner/subscribe")).body == want

    envelope = cloudevents.wrap({"taskId": "t"}, source="x", topic=TOPIC, pubsub_name=PUBSUB)
    body = json.dumps(envelope).encode()
    await call("POST", "/on-saved", {"content-type": cloudevents.CONTENT_TYPE}, body)
    assert seen["data"] == {"taskId": "t"}
    # a content type decides: plain JSON is never unwrapped
    await call("POST", "/on-saved", {"content-type": "application/json"}, body)
    assert seen["data"] == envelope
    await call("POST", "/on-saved", {}, body)  # no content type: sniffed
    assert seen["data"] == {"taskId": "t"}

    # an app's own /healthz wins over the default; and over HTTP
    @app.get("/healthz")
    async def healthz(req):
        return Response(503, {"warm": False})

    port = await bounded(app.start("127.0.0.1", 0))
    try:
        status, headers, payload = await bounded(http_request(
            "127.0.0.1", port, "GET", "/scores/t-9"))
        assert status == 200 and json.loads(payload)["task_id"] == "t-9"
        assert (await bounded(http_request("127.0.0.1", port, "GET", "/healthz")))[0] == 503
        assert (await bounded(http_request(
            "127.0.0.1", port, "GET", "/tasksrunner/healthz")))[0] == 204
    finally:
        await bounded(app.stop())
