"""The port's telemetry against the JAX package's, on the same seeded
inputs in one CPU process:

* the Prometheus exposition of a registry (tasksrunner_torch/metrics.py
  ``render_prometheus`` against tasksrunner/observability/metrics.py):
  the same ``inc`` / ``set_gauge`` / ``observe`` / ``observe_many``
  sequence gives the same text, bar the ``uptime_seconds`` value;
* the flight recorder (flightrec.py against
  tasksrunner/observability/flightrec.py): the same notes and dumps give
  the same payloads, and each package lists and reads the other's files;
* the trace readers (spans.py): ``assemble_trace``, ``critical_path``
  and ``service_map`` over span files written by either recorder;
* the log lines (logconfig.py against
  tasksrunner/observability/logging.py), inside and outside a trace,
  equal once the time stamp is masked.

Text and rows must be equal; nothing is within a tolerance."""

import contextvars
import io
import logging
import random
import re
import sys
import types

import numpy as np
import pytest

from tasksrunner.observability import flightrec as jax_flightrec
from tasksrunner.observability import logging as jax_logging
from tasksrunner.observability import spans as jax_spans
from tasksrunner.observability import tracing as jax_tracing
from tasksrunner.observability.metrics import MetricsRegistry as JaxRegistry
from tasksrunner.observability.metrics import render_prometheus as jax_render
from tasksrunner.observability.names import ALL as JAX_NAMES

from tasksrunner_torch import flightrec, logconfig, names, spans, tracing
from tasksrunner_torch.metrics import DEFAULT_BOUNDS, MetricsRegistry, render_prometheus

SEEDS = [0, 1, 2]
UPTIME = re.compile(r"^uptime_seconds \S+$", re.M)


def test_the_help_texts_are_the_jax_registrys():
    assert names.ALL == JAX_NAMES


def _ops(seed: int) -> list[tuple]:
    """A seeded script of registry calls: counters with whole and
    fractional steps, gauges set twice, histograms one value at a time
    and in runs past the fold size, values on, between and past the
    bounds, label values that need escaping, a name no table declares."""
    rng = np.random.default_rng(seed)
    label_values = ["a", "b/c", 'q"uote', "back\\slash", "new\nline", "é"]
    ops: list[tuple] = []
    for _ in range(60):
        labels = {k: label_values[rng.integers(len(label_values))]
                  for k in rng.choice(["route", "status", "target"], rng.integers(0, 3),
                                      replace=False)}
        kind = rng.integers(4)
        if kind == 0:
            name = rng.choice(["invoke", "publish", "pubsub_delivery", "made_up_total"])
            ops.append(("inc", str(name), float(rng.choice([1, 2, 0.25, rng.random()])),
                        labels))
        elif kind == 1:
            name = rng.choice(["broker_dlq_depth", "ml_queue_depth", "admission_saturation"])
            ops.append(("set_gauge", str(name), float(rng.normal() * 10), labels))
        else:
            name = str(rng.choice(["invoke_latency_seconds", "ml_queue_wait_seconds",
                                   "made_up_seconds"]))
            n = int(rng.choice([1, 5, 700]))
            values = np.exp(rng.uniform(np.log(5e-5), np.log(300.0), n))
            on_bounds = rng.choice(DEFAULT_BOUNDS, max(1, n // 10))
            values = [float(v) for v in np.concatenate([values, on_bounds])]
            if kind == 2:
                ops.extend(("observe", name, v, labels) for v in values)
            else:
                ops.append(("observe_many", name, values, labels))
    return ops


@pytest.mark.parametrize("seed", SEEDS)
def test_the_exposition_is_the_jax_registrys(seed):
    mine, theirs = MetricsRegistry(), JaxRegistry()
    for method, name, value, labels in _ops(seed):
        for reg in (mine, theirs):
            getattr(reg, method)(name, value, **labels)
    got, want = render_prometheus(mine), jax_render(theirs)
    assert UPTIME.search(got) and UPTIME.search(want)
    assert UPTIME.sub("uptime_seconds -", got) == UPTIME.sub("uptime_seconds -", want)


def test_the_exposition_cases_of_the_jax_test():
    """tests/test_metrics.py::test_render_prometheus_exposition_format on
    the port's registry."""
    reg = MetricsRegistry()
    reg.inc("pubsub_delivery", route="/on-saved", status="200")
    reg.set_gauge("broker_dlq_depth", 2.0, topic="t", group="g")
    reg.observe("invoke_latency_seconds", 3e-4, target="api")
    text = render_prometheus(reg)
    assert "# TYPE pubsub_delivery counter" in text
    assert "# TYPE broker_dlq_depth gauge" in text
    assert "# TYPE invoke_latency_seconds histogram" in text
    assert "# HELP invoke_latency_seconds" in text
    assert 'pubsub_delivery{route="/on-saved",status="200"} 1' in text
    assert 'broker_dlq_depth{group="g",topic="t"} 2' in text
    assert re.search(r'invoke_latency_seconds_bucket\{target="api",le="0\.0004"\} 1', text)
    assert 'invoke_latency_seconds_bucket{target="api",le="+Inf"} 1' in text
    assert 'invoke_latency_seconds_count{target="api"} 1' in text
    assert 'invoke_latency_seconds_sum{target="api"} 0.0003' in text
    assert re.search(r"uptime_seconds \d", text)
    assert text.endswith("\n")
    cums = [int(m.group(1)) for m in re.finditer(
        r'invoke_latency_seconds_bucket\{[^}]*\} (\d+)', text)]
    assert cums == sorted(cums) and cums[-1] == 1


def _recorded(module, registry_cls, root, seed, monkeypatch) -> list[str]:
    """One package's recorder fed the seeded notes and dumps, on a fake
    clock and a registry of its own holding the seeded gauges."""
    rng = random.Random(seed)
    clock = [1_700_000_000.0]
    monkeypatch.setattr(module, "time", types.SimpleNamespace(time=lambda: clock[0]))
    gauges = registry_cls()
    for name in ("admission_saturation", "ml_queue_depth", "state_write_queue_depth"):
        for shard in range(2):
            gauges.set_gauge(name, rng.uniform(0, 3), shard=str(shard))
    monkeypatch.setattr(module, "metrics", gauges)
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_RING", "16")
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_DIR", str(root))
    rec = module.FlightRecorder("scorer")
    paths = []
    for i in range(40):
        clock[0] += rng.choice([0.05, 0.4, 1.3])
        rec.note(name=rng.choice(["invoke", "save_state", "publish"]),
                 trace_id=f"{rng.getrandbits(128):032x}" if rng.random() < 0.8 else None,
                 status=rng.choice([200, 204, 429, 500]), duration=rng.random() / 10)
        if i in (9, 10, 30):
            paths.append(rec.dump("admission-shed", {"score": round(rng.uniform(1, 3), 3)}))
        if i == 20:
            paths.append(rec.dump("slow-exemplar", {"metric": "m", "value": 0.5}))
    return paths


@pytest.mark.parametrize("seed", SEEDS)
def test_flight_recorder_dumps_match_and_read_across(seed, tmp_path, monkeypatch):
    got = _recorded(flightrec, MetricsRegistry, tmp_path / "port", seed, monkeypatch)
    want = _recorded(jax_flightrec, JaxRegistry, tmp_path / "jax", seed, monkeypatch)
    assert [p is None for p in got] == [p is None for p in want] == [False, True, False, False]
    assert [p.replace("/port/", "/") for p in got if p] == \
        [p.replace("/jax/", "/") for p in want if p]
    for mine, theirs in zip(filter(None, got), filter(None, want)):
        assert flightrec.read_dump(theirs) == jax_flightrec.read_dump(mine)
        assert flightrec.read_dump(mine) == jax_flightrec.read_dump(theirs)
    for root in ("port", "jax"):
        assert flightrec.list_dumps(tmp_path / root) == \
            jax_flightrec.list_dumps(tmp_path / root)
    rows = flightrec.list_dumps(tmp_path / "port")
    assert [r["reason"] for r in rows] == ["admission-shed", "slow-exemplar", "admission-shed"]
    assert {r["entries"] for r in rows} <= set(range(1, 17))


def _span_script(seed: int, start: float) -> list[dict]:
    """Seeded traces: a client span per trace with a server span under
    it, batched work (``ml-request`` with a queue wait under the server,
    its ``ml-batch`` in a trace of its own), producers and consumers, a
    child outliving its parent, a span recorded in both files."""
    rng = random.Random(seed)
    out = []
    for t in range(6):
        trace = f"{rng.getrandbits(128):032x}"
        t0 = start + t
        client = {"trace_id": trace, "span_id": f"{rng.getrandbits(64):016x}",
                  "parent_id": f"{rng.getrandbits(64):016x}", "kind": "client",
                  "name": "invoke scorer/score", "status": 200, "start": t0,
                  "duration": 0.05 + rng.random() / 10,
                  "attrs": {"target": rng.choice(["scorer", "api"])}, "role": "caller"}
        server = {**client, "span_id": f"{rng.getrandbits(64):016x}",
                  "parent_id": client["span_id"], "kind": "server", "name": "POST /score",
                  "start": t0 + 0.002, "duration": client["duration"] - 0.004, "attrs": {},
                  "role": "scorer"}
        wait = rng.random() / 100
        request = {**server, "span_id": f"{rng.getrandbits(64):016x}",
                   "parent_id": server["span_id"], "kind": "internal", "name": "ml-request",
                   "start": t0 + 0.003, "duration": wait + 0.01,
                   "attrs": {"queue_wait": wait, "service": 0.01, "bucket": 4}}
        producer = {**client, "span_id": f"{rng.getrandbits(64):016x}",
                    "parent_id": client["span_id"], "kind": "producer",
                    "name": "publish ps/topic", "start": t0 + 0.01, "duration": 0.002,
                    "attrs": {"target": "ps/topic"}}
        consumer = {**producer, "span_id": f"{rng.getrandbits(64):016x}",
                    "parent_id": producer["span_id"], "kind": "consumer",
                    "name": "POST /on-saved", "start": t0 + 0.2, "duration": 0.03,
                    "attrs": {}, "role": "scorer"}
        out += [client, server, request, producer, consumer]
    return out


def _write(recorder_of, path, rows) -> None:
    by_role = {}
    for row in rows:
        rec = by_role.setdefault(row["role"], recorder_of(row["role"], path))
        kw = {k: row[k] for k in ("trace_id", "span_id", "parent_id", "kind", "name",
                                  "status", "start", "duration", "attrs")}
        if isinstance(rec, jax_spans.SpanRecorder):
            rec.record(**kw)
        else:
            rec.append(**kw)
    for rec in by_role.values():
        rec.close()


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_readers_agree_over_either_packages_files(seed, tmp_path):
    import time

    rows = _span_script(seed, time.time() - 60)
    half = len(rows) // 2
    port_db, jax_db = str(tmp_path / "port.db"), str(tmp_path / "jax.db")
    # each file written by one package's recorder; one span in both
    _write(spans.SpanRecorder, port_db, rows[:half + 1])
    _write(jax_spans.SpanRecorder, jax_db, rows[half:])
    traces = sorted({r["trace_id"] for r in rows})
    fetched = jax_spans.trace_spans(jax_db, "")
    for trace in traces + [traces[0][:8], "f" * 32]:
        for sources in ([port_db, jax_db], [jax_db, port_db, str(tmp_path / "none.db")],
                        [port_db, fetched]):
            got = spans.assemble_trace(sources, trace)
            want = jax_spans.assemble_trace(sources, trace)
            assert got == want
            assert spans.critical_path(got) == jax_spans.critical_path(want)
        if trace in traces:
            assert len(got) == 5  # the span in both files counts once
    for db in (port_db, jax_db):
        assert spans.service_map(db) == jax_spans.service_map(db)
        assert spans.list_traces(db) == jax_spans.list_traces(db)


STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} ")


def _log_lines(configure, tracing_module, trace_id: str, monkeypatch) -> list[str]:
    stream = io.StringIO()
    monkeypatch.setattr(sys, "stderr", stream)  # the handler's stream, taken at configuring
    configure("scorer")
    log = logging.getLogger("tasksrunner.probe")
    log.info("before %s", 1)
    ctx = tracing_module.TraceContext(trace_id=trace_id, span_id="1" * 16)
    with tracing_module.trace_scope(ctx):
        log.warning("inside a request")
    log.error("after")
    return [STAMP.sub("<time> ", line) for line in stream.getvalue().splitlines()]


def test_log_lines_match_the_jax_format(monkeypatch):
    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", list(root.handlers))
    monkeypatch.setattr(root, "level", root.level)
    trace_id = f"{random.Random(0).getrandbits(128):032x}"
    # a fresh context: no ambient trace from an earlier test of this process
    got = contextvars.Context().run(_log_lines, logconfig.configure_logging, tracing, trace_id,
                                    monkeypatch)
    want = contextvars.Context().run(_log_lines, jax_logging.configure_logging, jax_tracing,
                                     trace_id, monkeypatch)
    assert got == want
    assert got[1] == (f"<time> WARNING role=scorer trace={trace_id[:16]} tasksrunner.probe :: "
                      "inside a request")
    assert logconfig.FORMAT == jax_logging.FORMAT
