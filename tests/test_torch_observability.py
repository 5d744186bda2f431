"""The port's request-path observability against the JAX package's, in one
process on the CPU: the admission controller's lag, write-queue,
in-flight and registered signals; the event-loop-lag probe; trace
exemplars; W3C baggage; span retention and ``critical_path``; the
scorer's ``/openapi.json``; and ``GET /tasksrunner/stats`` as the JAX
app server answers it. No subprocess; the file runs in a few seconds."""

import asyncio
import contextvars
import json
import time

import pytest

from tasksrunner.observability import admission as jax_admission
from tasksrunner.observability import spans as jax_spans
from tasksrunner.observability import tracing as jax_tracing
from tasksrunner.observability.metrics import MetricsRegistry as JaxRegistry
from tasksrunner_torch import admission, service, spans, tracing
from tasksrunner_torch.app import App, Response
from tasksrunner_torch.client import http_request
from tasksrunner_torch.metrics import MetricsRegistry
from tasksrunner_torch.probes import EventLoopLagProbe

TOKEN = "s3cret"


def bounded(aw, seconds: float = 30):
    return asyncio.wait_for(aw, seconds)


# -- admission -------------------------------------------------------------

# (lag seconds, {(queue gauge, shard): depth}, inflight, extra signal)
SIGNALS = [
    (0.0, {}, 0, None),
    (0.1, {}, 0, None),
    (0.3, {}, 0, None),                      # lag alone saturates
    (0.2, {}, 0, None),                      # 0.8: still shedding (hysteresis)
    (0.15, {}, 0, None),                     # 0.6: admits again
    (0.0, {("state_write_queue_depth", "0"): 100,
           ("state_write_queue_depth", "1"): 600}, 0, None),   # the worst shard
    (0.0, {("broker_publish_queue_depth", "a"): 400}, 0, None),
    (0.05, {}, 70, None),                    # in flight over 64
    (0.05, {}, 40, 0.9),
    (0.05, {}, 10, 2.6),                     # Retry-After 3
    (0.9, {}, 10, 0.2),                      # lag 3.6: Retry-After 4
    (0.0, {}, 0, 0.0),
    (40.0, {}, 0, None),                     # Retry-After clamped to 30
    (0.0, {}, 0, None),
]


@pytest.mark.parametrize("limits", [
    {},
    {"TASKSRUNNER_ADMISSION_MAX_LAG_SECONDS": "0.5",
     "TASKSRUNNER_ADMISSION_MAX_QUEUE_DEPTH": "100",
     "TASKSRUNNER_ADMISSION_MAX_INFLIGHT": "16"},
    {"TASKSRUNNER_ADMISSION_MAX_LAG_SECONDS": "0",
     "TASKSRUNNER_ADMISSION_MAX_QUEUE_DEPTH": "0"},
], ids=["defaults", "tight", "lag-and-queues-off"])
def test_admission_scores_and_sheds_as_the_jax_controller(monkeypatch, limits):
    monkeypatch.setenv("TASKSRUNNER_ADMISSION", "1")
    for name, value in limits.items():
        monkeypatch.setenv(name, value)
    inflight = {"n": 0}
    extra = {"ratio": None}
    mine_reg, theirs_reg = MetricsRegistry(), JaxRegistry()
    mine = admission.AdmissionController.from_env(inflight=lambda: inflight["n"],
                                                  registry=mine_reg)
    theirs = jax_admission.AdmissionController.from_env(inflight=lambda: inflight["n"],
                                                        registry=theirs_reg)
    assert (mine.max_lag_seconds, mine.max_queue_depth, mine.max_inflight) == (
        theirs.max_lag_seconds, theirs.max_queue_depth, theirs.max_inflight)
    admission.register_signal("test-extra", lambda: extra["ratio"] or 0.0)
    jax_admission.register_signal("test-extra", lambda: extra["ratio"] or 0.0)
    try:
        shed_seen = 0
        for lag, depths, n, ratio in SIGNALS:
            inflight["n"], extra["ratio"] = n, ratio
            for reg in (mine_reg, theirs_reg):
                reg.set_gauge("event_loop_lag_seconds", lag)
                for (gauge, shard), depth in depths.items():
                    reg.set_gauge(gauge, depth, shard=shard)
            assert mine.sample() == pytest.approx(theirs.sample(), abs=0.0)
            assert mine.shedding == theirs.shedding
            assert mine.retry_after_seconds() == theirs.retry_after_seconds()
            assert mine_reg.snapshot()["admission_state"] == float(mine.shedding)
            shed_seen += mine.shedding
            for reg in (mine_reg, theirs_reg):  # the queues drain again
                for gauge, shard in depths:
                    reg.set_gauge(gauge, 0.0, shard=shard)
        assert shed_seen >= 3  # the table is not vacuous under any limits
    finally:
        admission.unregister_signal("test-extra")
        jax_admission.unregister_signal("test-extra")


async def test_lag_probe_reports_a_blocked_loop():
    """Each check reads the value the probe writes to the gauge next,
    never the gauge after a fixed sleep: on a loaded machine a sleep can
    end before the probe has written, or after it has recovered."""
    reg = MetricsRegistry()
    readings: asyncio.Queue = asyncio.Queue()
    set_gauge = reg.set_gauge

    def noted(name, value, **labels):
        set_gauge(name, value, **labels)
        readings.put_nowait(value)

    reg.set_gauge = noted
    probe = EventLoopLagProbe(interval=0.05, registry=reg)
    probe.start()
    try:
        # a reading: the probe has just begun its next sleep
        await asyncio.wait_for(readings.get(), 10)
        time.sleep(0.3)  # the loop is blocked through that sleep
        blocked = await asyncio.wait_for(readings.get(), 10)
        assert blocked >= 0.2
        # and it recovers once the loop runs again: a reading below 0.2 s
        # within the next four (0.2 s of probing at 0.05 s)
        after = []
        while len(after) < 4 and (not after or after[-1] >= 0.2):
            after.append(await asyncio.wait_for(readings.get(), 10))
        assert after[-1] < 0.2, f"no reading below 0.2 s in {after}"
    finally:
        await probe.stop()


async def test_a_late_loop_shuts_the_front_door(monkeypatch):
    """``TASKSRUNNER_ADMISSION=1``: an app served by ``App.start`` runs the
    loop's lag probe, and a loop later than
    ``TASKSRUNNER_ADMISSION_MAX_LAG_SECONDS`` sheds with 429."""
    monkeypatch.setenv("TASKSRUNNER_ADMISSION", "1")
    monkeypatch.setenv("TASKSRUNNER_ADMISSION_MAX_LAG_SECONDS", "0.1")
    app = App("lagged")

    @app.get("/work")
    async def work(req):
        return {"done": True}

    port = await bounded(app.start("127.0.0.1", 0))
    try:
        assert (await bounded(http_request("127.0.0.1", port, "GET", "/work")))[0] == 200
        # longer than the probe's interval: one of its sleeps wakes late
        time.sleep(0.8)

        async def shedding():
            while not app.admission.shedding:
                await asyncio.sleep(0.01)
        await bounded(shedding(), 5)
        status, headers, _ = await bounded(http_request("127.0.0.1", port, "GET", "/work"))
        assert status == 429 and int(headers["retry-after"]) >= 3
        assert app.admission.score >= 3.0
    finally:
        await bounded(app.stop())
        admission.default_metrics.set_gauge("event_loop_lag_seconds", 0.0)


# -- exemplars -------------------------------------------------------------

OBSERVED = [(0.01, 0), (0.2, 1), (0.05, 2), (0.35, 3), (0.11, None), (1.5, 4),
            (0.12, 5), (0.4, 6), (0.13, 7), (0.9, 8), (2.0, 9), (0.3, 10)]


def _trace(i: int) -> str:
    return f"{i:032x}"


def test_exemplars_match_the_jax_registry(monkeypatch):
    """The same observations in the same trace scopes (and by hand, with
    ``traces=``) keep the same newest-8 exemplars above the threshold."""
    monkeypatch.setenv("TASKSRUNNER_SLOW_THRESHOLD_SECONDS", "0.1")
    # a fresh context: no ambient trace of either package, whatever an
    # earlier test in this process installed
    contextvars.Context().run(_compare_exemplars)


def _compare_exemplars():
    mine, theirs = MetricsRegistry(), JaxRegistry()
    assert mine.slow_threshold == theirs.slow_threshold == 0.1
    span = "ab" * 8
    for value, i in OBSERVED:
        if i is None:  # no trace in scope: no exemplar
            mine.observe("ml_infer_latency_seconds", value, bucket="8")
            theirs.observe("ml_infer_latency_seconds", value, bucket="8")
            continue
        with tracing.trace_scope(tracing.TraceContext(_trace(i), span)):
            mine.observe("ml_infer_latency_seconds", value, bucket="8")
        with jax_tracing.trace_scope(jax_tracing.TraceContext(_trace(i), span)):
            theirs.observe("ml_infer_latency_seconds", value, bucket="8")
    values = [v for v, _ in OBSERVED]
    traces = [None if i is None else _trace(100 + i) for _, i in OBSERVED]
    with tracing.trace_scope(tracing.TraceContext(_trace(999), span)):
        # observe_many takes no ambient trace: only those given
        mine.observe_many("ml_queue_wait_seconds", values, traces=traces, bucket="1")
        mine.observe_many("ml_queue_wait_seconds", values, bucket="2")
    theirs.observe_many("ml_queue_wait_seconds", values, traces=traces, bucket="1")
    theirs.observe_many("ml_queue_wait_seconds", values, bucket="2")

    got, want = mine.snapshot_histograms(), theirs.snapshot_histograms()
    assert sorted(got) == sorted(want)
    for name in want:
        assert len(got[name]["series"]) == len(want[name]["series"])
        for g, w in zip(got[name]["series"], want[name]["series"]):
            assert (g["labels"], g["counts"], g["count"]) == (w["labels"], w["counts"], w["count"])
            assert [e[:2] for e in g["exemplars"]] == [e[:2] for e in w["exemplars"]]
    kept = got["ml_infer_latency_seconds"]["series"][0]["exemplars"]
    assert len(kept) == 8 and kept[-1][:2] == [_trace(10), 0.3]
    assert got["ml_queue_wait_seconds"]["series"][1]["exemplars"] == []


# -- baggage ---------------------------------------------------------------

BAGGAGE_HEADERS = [
    None, "", "userId=alice", "a=1, b = two ,c=%20three%2C",
    "=novalue,noequals,ok=1,,  ,k=v=w", "tenant=acme;prop=1,env=prod",
    ",".join(f"k{i}=v{i}" for i in range(20)),   # past 16 items
    "big=" + "x" * 1100 + ",small=1",            # one item past 1024 bytes
    ",".join(f"key{i}={'y' * 100}" for i in range(12)),  # stops at 1024 bytes
]


@pytest.mark.parametrize("header", BAGGAGE_HEADERS)
def test_baggage_parses_and_serializes_as_jax(header):
    bag = tracing.parse_baggage(header)
    assert bag == jax_tracing.parse_baggage(header)
    assert len(bag) <= tracing.MAX_BAGGAGE_ITEMS
    wire = tracing.serialize_baggage(bag)
    assert wire == jax_tracing.serialize_baggage(bag)
    assert wire is None or len(wire) <= tracing.MAX_BAGGAGE_BYTES
    unicode = {"who": "zoë & co", "path": "/a,b;c=d", **bag}
    assert tracing.serialize_baggage(unicode) == jax_tracing.serialize_baggage(unicode)


def test_baggage_rides_every_hop():
    parent = "00-" + "ef" * 16 + "-" + "12" * 8 + "-01"
    ctx = tracing.ensure_trace(parent, "tenant=acme,env=prod")
    # JAX's ensure_trace installs its context: keep it out of this one
    theirs = contextvars.copy_context().run(
        jax_tracing.ensure_trace, parent, "tenant=acme,env=prod")
    assert (ctx.trace_id, ctx.parent_id, ctx.baggage) == (
        theirs.trace_id, theirs.parent_id, theirs.baggage)
    with tracing.trace_scope(ctx):
        headers = tracing.outgoing_headers()
    assert headers[tracing.BAGGAGE_HEADER] == "tenant=acme,env=prod"
    assert tracing.TraceContext.parse(headers["traceparent"]).trace_id == "ef" * 16
    # baggage without a traceparent starts a trace that carries it
    assert tracing.ensure_trace(None, "a=1").baggage == {"a": "1"}
    assert tracing.BAGGAGE_HEADER not in tracing.outgoing_headers()


# -- span retention and the readers ----------------------------------------

def test_retention_and_critical_path_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(spans.RETENTION_ENV_VAR, "3600")
    now = time.time()
    trace = "fe" * 16
    rows = [  # (span, parent, name, kind, start offset, duration, attrs)
        ("a" * 16, None, "invoke priority-scorer/score", "client", 0.0, 0.050, {}),
        ("b" * 16, "a" * 16, "POST /score", "server", 0.002, 0.046, {}),
        ("c" * 16, "b" * 16, "ml-request", "internal", 0.003, 0.040,
         {"queue_wait": 0.030, "service": 0.010}),
        ("d" * 16, "b" * 16, "early", "internal", 0.004, 0.001, {}),
        ("e" * 16, "c" * 16, "outlives", "internal", 0.030, 0.5, {}),
        ("f" * 16, "a" * 16, "old", "server", -7200.0, 0.001, {}),
    ]
    mine = spans.SpanRecorder("port", tmp_path / "mine.db")
    theirs = jax_spans.SpanRecorder("port", tmp_path / "theirs.db", flush_interval=999)
    assert mine.retention_seconds == theirs.retention_seconds == 3600
    try:
        for span, parent, name, kind, offset, duration, attrs in rows:
            mine.append(trace, span, parent, kind, name, 200, now + offset, duration, attrs)
            theirs.record(kind=kind, name=name, status=200, start=now + offset,
                          duration=duration, attrs=attrs, span_id=span, parent_id=parent,
                          trace_id=trace)
        mine.flush()
        theirs.flush()
    finally:
        mine.close()
        theirs.close()
    got = spans.trace_spans(str(tmp_path / "mine.db"), trace[:8])
    want = jax_spans.trace_spans(str(tmp_path / "theirs.db"), trace[:8])
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert "old" not in [r["name"] for r in got]  # pruned by the sweep
    assert spans.critical_path(got) == jax_spans.critical_path(got)
    chain = spans.critical_path(got)
    assert [hop["name"] for hop in chain] == [
        "invoke priority-scorer/score", "POST /score", "ml-request", "outlives"]
    assert chain[2]["queue_wait"] == 0.030 and chain[2]["self_time"] >= 0.0
    listed = spans.list_traces(str(tmp_path / "mine.db"))
    assert listed == jax_spans.list_traces(str(tmp_path / "theirs.db"))
    assert listed[0]["root"] == "port: invoke priority-scorer/score"


# -- the replica's reserved surface ----------------------------------------

def test_scorer_openapi_matches_the_jax_scorer():
    from tasksrunner.ml.platform import pin_cpu_platform

    if not pin_cpu_platform():
        pytest.skip("jax cpu platform unavailable")
    from tasksrunner.ml.service import make_app as jax_make_app

    async def documents():
        mine = await service.make_app(device="cpu").handle("GET", "/openapi.json")
        theirs = await jax_make_app().handle("GET", "/openapi.json")
        return mine, theirs
    mine, theirs = asyncio.run(documents())
    assert mine.status == theirs.status == 200
    got, want = mine.body, json.loads(json.dumps(theirs.body))
    assert {k: v for k, v in got.items() if k != "paths"} == {
        k: v for k, v in want.items() if k != "paths"}
    for path, ops in want["paths"].items():
        assert got["paths"][path] == ops, path
    assert set(got["paths"]) - set(want["paths"]) == {"/metrics"}
    assert "/on-task-saved" not in got["paths"]  # a subscription, not an API


def _apps(release: asyncio.Event):
    """The same one-route app in each package: ``POST /hold`` waits for
    ``release``."""
    from tasksrunner import App as JaxApp

    mine, theirs = App("probe"), JaxApp("probe")

    @mine.post("/hold")
    async def hold(req):
        await release.wait()
        return Response(200, {"ok": True})

    @theirs.post("/hold")
    async def jax_hold(req):
        await release.wait()
        return 200, {"ok": True}
    return mine, theirs


async def test_stats_probe_answers_as_the_jax_app_server(monkeypatch):
    """``GET /tasksrunner/stats`` on the port's ``App.start`` and on JAX's
    ``build_app_server``: 401 without the token, the same keys and
    counts, a request in flight counted and the probe not, and the probe
    answered while the replica sheds."""
    from aiohttp import web

    from tasksrunner.hosting import build_app_server

    monkeypatch.setenv("TASKSRUNNER_API_TOKEN", TOKEN)
    release = asyncio.Event()
    mine, theirs = _apps(release)
    my_gate = admission.AdmissionController(max_lag_seconds=0, inflight=lambda: 0,
                                            registry=MetricsRegistry())
    their_gate = jax_admission.AdmissionController(max_lag_seconds=0, inflight=lambda: 0,
                                                   registry=JaxRegistry())
    my_port = await bounded(mine.start("127.0.0.1", 0))
    mine.admission = my_gate
    runner = web.AppRunner(build_app_server(theirs, admission=their_gate))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    their_port = runner.addresses[0][1]
    ports = {"mine": my_port, "theirs": their_port}

    async def both(method, path, *, token=True):
        out = {}
        for side, port in ports.items():
            headers = {"tr-api-token": TOKEN} if token else {}
            status, _, body = await bounded(http_request(
                "127.0.0.1", port, method, path, headers=headers, body=b"{}"
                if method == "POST" else b""))
            out[side] = (status, json.loads(body) if body else None)
        assert out["mine"] == out["theirs"], out
        return out["mine"]

    try:
        assert await both("GET", "/tasksrunner/stats", token=False) == (
            401, {"error": "missing or bad api token"})
        assert await both("GET", "/tasksrunner/stats") == (
            200, {"inflight": 0, "requests_total": 0})
        held = [asyncio.ensure_future(http_request("127.0.0.1", port, "POST", "/hold",
                                                   body=b"{}"))
                for port in ports.values()]

        async def in_flight():
            while not (mine.inflight == 1 and theirs.inflight == 1):
                await asyncio.sleep(0.005)
        await bounded(in_flight(), 10)
        assert await both("GET", "/tasksrunner/stats") == (
            200, {"inflight": 1, "requests_total": 1})
        release.set()
        assert [r[0] for r in await bounded(asyncio.gather(*held))] == [200, 200]
        assert await both("GET", "/tasksrunner/stats") == (
            200, {"inflight": 0, "requests_total": 1})
        my_gate.shedding = their_gate.shedding = True
        assert (await both("POST", "/hold"))[0] == 429
        assert await both("GET", "/tasksrunner/stats") == (
            200, {"inflight": 0, "requests_total": 1})
    finally:
        release.set()
        await runner.cleanup()
        await bounded(mine.stop())
