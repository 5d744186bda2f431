"""The port's telemetry helpers on their own, without JAX: the ids
(tasksrunner_torch/ids.py), the flight recorder (flightrec.py) and its
three triggers, the uvloop switch (eventloop.py), the role- and
trace-tagged log lines (logconfig.py), the span recorder's flush
(spans.py) and the metric-name registry (names.py) checked against every
name the port's source records.

Two short subprocesses in all: one exits without ``mark_clean`` and must
leave an ``unclean-shutdown`` dump, one stops cleanly and must leave
none."""

import ast
import io
import json
import logging
import os
import pathlib
import re
import subprocess
import sys
import threading
import types

import pytest

from tasksrunner_torch import eventloop, flightrec, ids, logconfig, metrics, names, spans
from tasksrunner_torch.admission import AdmissionController
from tasksrunner_torch.metrics import MetricsRegistry
from tasksrunner_torch.tracing import TraceContext, trace_scope

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "tasksrunner_torch"


def test_ids_are_hex_of_the_full_width_and_do_not_repeat():
    spans = {ids.hex8() for _ in range(2000)}
    traces = {ids.hex16() for _ in range(2000)}
    assert len(spans) == len(traces) == 2000
    assert all(re.fullmatch(r"[0-9a-f]{16}", s) for s in spans)
    assert all(re.fullmatch(r"[0-9a-f]{32}", t) for t in traces)


def test_a_forked_child_does_not_replay_the_parents_ids():
    ids.hex16()  # this thread's generator is seeded before the fork
    read, write = os.pipe()
    pid = os.fork()
    if pid == 0:  # the child: its next id, then out without pytest's teardown
        os.write(write, ids.hex16().encode())
        os._exit(0)
    os.close(write)
    theirs = os.read(read, 64).decode()
    os.close(read)
    os.waitpid(pid, 0)
    assert re.fullmatch(r"[0-9a-f]{32}", theirs) and theirs != ids.hex16()


@pytest.fixture
def recorder(tmp_path, monkeypatch):
    """A process recorder dumping into ``tmp_path``, put back after."""
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_DIR", str(tmp_path))
    rec = flightrec.FlightRecorder("svc")
    monkeypatch.setattr(flightrec, "_flightrec", rec)
    return rec


def _dumps(root) -> list[dict]:
    return [json.loads(p.read_text()) for p in sorted(pathlib.Path(root).glob("*.json"))]


def test_each_reason_dumps_at_most_once_in_five_seconds(recorder, tmp_path, monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(flightrec, "time", types.SimpleNamespace(time=lambda: clock[0]))
    for i in range(3):
        flightrec.note_request(name="save_state", trace_id=f"{i:032x}", status=200,
                               duration=0.001 * i)
    first = flightrec.dump("admission-shed", {"score": 1.5})
    assert first == str(tmp_path / f"svc-{os.getpid()}-1000-admission-shed.json")
    assert flightrec.dump("admission-shed") is None  # the same reason, too soon
    assert flightrec.dump("slow-exemplar") is not None  # another reason
    clock[0] += 4.9
    assert flightrec.dump("admission-shed") is None
    clock[0] += 0.2
    assert flightrec.dump("admission-shed") is not None
    reasons = sorted(d["reason"] for d in _dumps(tmp_path))
    assert reasons == ["admission-shed", "admission-shed", "slow-exemplar"]
    payload = flightrec.read_dump(first)
    assert payload["detail"] == {"score": 1.5} and payload["role"] == "svc"
    assert [e["trace"] for e in payload["entries"]] == [f"{i:032x}" for i in range(3)]
    # one gauge sample a second: only the first note carries one
    assert ["gauges" in e for e in payload["entries"]] == [True, False, False]
    listed = flightrec.list_dumps(tmp_path)
    assert len(listed) == 3 and {r["entries"] for r in listed} == {3}


def test_the_ring_keeps_the_newest_entries(tmp_path, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_RING", "4")
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_DIR", str(tmp_path))
    rec = flightrec.FlightRecorder("svc")
    for i in range(10):
        rec.note(name="r", trace_id=str(i), status=200, duration=0.0)
    payload = flightrec.read_dump(rec.dump("ring"))
    assert [e["trace"] for e in payload["entries"]] == ["6", "7", "8", "9"]


def test_flightrec_off_records_and_dumps_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC", "0")
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_DIR", str(tmp_path))
    monkeypatch.setattr(flightrec, "_flightrec", None)
    assert flightrec.configure_flightrec("svc") is None
    flightrec.note_request(name="r", trace_id=None, status=200, duration=0.0)
    assert flightrec.dump("admission-shed") is None
    assert flightrec._flightrec is None and not list(tmp_path.iterdir())


def test_entering_the_shed_state_dumps_the_ring(recorder, tmp_path):
    flightrec.note_request(name="invoke", trace_id="a" * 32, status=200, duration=0.01)
    controller = AdmissionController(max_inflight=2, inflight=lambda: 5,
                                     registry=MetricsRegistry())
    assert controller.sample() == 2.5 and controller.shedding
    controller.sample()  # still shedding: no second dump
    (dump,) = _dumps(tmp_path)
    assert dump["reason"] == "admission-shed" and dump["detail"] == {"score": 2.5}
    assert [e["trace"] for e in dump["entries"]] == ["a" * 32]


def test_a_slow_exemplar_dumps_the_ring(recorder, tmp_path, monkeypatch):
    monkeypatch.setattr(metrics, "on_slow_exemplar", flightrec._on_slow)
    reg = MetricsRegistry()
    reg.slow_threshold = 0.1
    ctx = TraceContext.new()
    reg.observe("invoke_latency_seconds", 0.05, target="t")  # fast: no exemplar
    reg.observe("invoke_latency_seconds", 0.5, target="t")   # slow, but in no trace
    assert not list(tmp_path.iterdir())
    with trace_scope(ctx):
        reg.observe("invoke_latency_seconds", 0.5, target="t")
    reg.observe_many("ml_queue_wait_seconds", [0.2, 0.01], traces=[ctx.trace_id, None])
    (dump,) = _dumps(tmp_path)  # the second exemplar met the rate limit
    assert dump["reason"] == "slow-exemplar"
    assert dump["detail"] == {"metric": "invoke_latency_seconds", "trace_id": ctx.trace_id,
                              "value": 0.5}
    exemplars = reg.snapshot_histograms()["ml_queue_wait_seconds"]["series"][0]["exemplars"]
    assert [e[0] for e in exemplars] == [ctx.trace_id]


_EXIT_SCRIPT = """
import sys
from tasksrunner_torch import flightrec
flightrec.configure_flightrec("probe")
flightrec.note_request(name="save_state", trace_id="f" * 32, status=200, duration=0.002)
if sys.argv[1] == "clean":
    flightrec.mark_clean()
"""


@pytest.mark.parametrize("how", ["unclean", "clean"])
def test_an_unclean_exit_leaves_a_dump_and_a_clean_one_none(how, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TASKSRUNNER_FLIGHTREC")}
    env["PYTHONPATH"] = str(PACKAGE.parent)
    env["TASKSRUNNER_FLIGHTREC_DIR"] = str(tmp_path)
    subprocess.run([sys.executable, "-c", _EXIT_SCRIPT, how], check=True,
                   env=env, timeout=60)
    dumps = _dumps(tmp_path)
    if how == "clean":
        assert dumps == []
    else:
        (dump,) = dumps
        assert dump["reason"] == "unclean-shutdown" and dump["role"] == "probe"
        assert [e["trace"] for e in dump["entries"]] == ["f" * 32]


def test_uvloop_is_off_by_default_and_missing_uvloop_only_warns(monkeypatch, caplog):
    monkeypatch.delenv("TASKSRUNNER_UVLOOP", raising=False)
    assert eventloop.maybe_enable_uvloop() is False
    monkeypatch.setenv("TASKSRUNNER_UVLOOP", "1")
    monkeypatch.setitem(sys.modules, "uvloop", None)  # an import of it fails
    with caplog.at_level(logging.WARNING, logger="tasksrunner_torch.eventloop"):
        assert eventloop.maybe_enable_uvloop() is False
    assert "uvloop is not installed; continuing on the default asyncio event loop" \
        in caplog.text
    assert eventloop.uvloop_available() is False


def test_log_lines_carry_the_role_and_the_trace(monkeypatch):
    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", list(root.handlers))
    monkeypatch.setattr(root, "level", root.level)
    stream = io.StringIO()
    monkeypatch.setattr(sys, "stderr", stream)  # the handler's stream, taken at configuring
    logconfig.configure_logging("scorer")
    log = logconfig.service_logger("tasksrunner_torch.probe")
    log.info("outside")
    ctx = TraceContext.new()
    with trace_scope(ctx):
        log.warning("inside")
    outside, inside = stream.getvalue().splitlines()
    assert re.fullmatch(r"\S+ \S+ INFO    role=scorer trace=- tasksrunner_torch\.probe :: "
                        r"outside", outside)
    assert inside.endswith(f"WARNING role=scorer trace={ctx.trace_id[:16]} "
                           "tasksrunner_torch.probe :: inside")


def test_a_flush_waits_for_the_write_in_flight(tmp_path):
    """A sidecar's ``/v1.0/traces`` flushes, then reads the file: a flush
    that found the buffer empty while the timer's first write was still
    making the file's table let the read meet no table."""
    rec = spans.SpanRecorder("svc", tmp_path / "spans.db")
    done = threading.Event()
    try:
        with rec._io_lock:  # the timer's write, in flight
            flusher = threading.Thread(target=lambda: (rec.flush(), done.set()))
            flusher.start()
            assert not done.wait(0.2)
        assert done.wait(5)
        flusher.join()
    finally:
        rec.close()


#: the registry methods whose first argument names a series, and the
#: table of :mod:`tasksrunner_torch.names` the name must be in
_RECORDERS = {"inc": names.COUNTERS, "set_gauge": names.GAUGES,
              "observe": names.HISTOGRAMS, "observe_many": names.HISTOGRAMS}


def test_every_metric_name_the_port_records_is_declared_with_its_kind():
    used: dict[str, set[str]] = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _RECORDERS and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                used.setdefault(node.func.attr, set()).add(node.args[0].value)
    assert sum(map(len, used.values())) >= 30, used  # the lint reads the real call sites
    wrong = {(method, name) for method, found in used.items() for name in found
             if name not in _RECORDERS[method]}
    assert not wrong, f"undeclared or of another kind: {sorted(wrong)}"
    assert names.ALL == {**names.COUNTERS, **names.GAUGES, **names.HISTOGRAMS}
