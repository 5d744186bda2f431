"""The operating plane of the port against the JAX package's, on the CPU
in one process: the sidecar's new routes, the operator verbs and the
orchestrator's trace assembly.

* A JAX app host and a port app host (one echo app each, the same
  component files, a registry file each, ``TASKSRUNNER_API_TOKEN`` set)
  take the same seeded calls through their sidecars. Then each
  sidecar's ``GET /metrics`` answers 401 without the token and
  Prometheus text 0.0.4 with it, with the same series names and label
  sets for the names both record; and ``GET /v1.0/traces/{id}`` answers
  the same span rows (ids and times masked) for a trace sent through
  each.
* Every verb of the slice (``components``, ``invoke``, ``publish``,
  ``state``, ``metrics``, ``traces``, ``flightrec``, ``dlq``) is called
  through ``main([...])`` of each package against the same sidecar or
  files, the JAX package's and the port's in turn: stdout and exit code
  must be equal, bar time stamps, elapsed times, message ids, latency
  values and the program's name in a hint.
* ``GET /admin/traces/{id}`` over two port sidecars and one that is down
  merges both sidecars' spans (a span both hold counts once) and counts
  2 replicas.
"""

import asyncio
import contextvars
import json
import random
import re
import shutil
import socket
import sqlite3
import sys
import threading
import time
import types
from pathlib import Path

from tasksrunner import cli as jax_cli
from tasksrunner.app import App as JaxApp
from tasksrunner.hosting import AppHost as JaxAppHost
from tasksrunner.observability import flightrec as jax_flightrec
from tasksrunner.observability import spans as jax_spans

from tasksrunner_torch import cli, flightrec, spans
from tasksrunner_torch.app import App
from tasksrunner_torch.bindings.localqueue import SqliteQueue
from tasksrunner_torch.client import http_request
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.hosting import AppHost
from tasksrunner_torch.invoke.resolver import NameResolver
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.orchestrator.admin import AdminServer
from tasksrunner_torch.pubsub.sqlite import SqliteBroker
from tasksrunner_torch.runtime import Runtime
from tasksrunner_torch.sidecar import Sidecar

TOKEN = "ops-parity-token"
AUTH = {"tr-api-token": TOKEN}
APP_ID = "echo"
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
SEED = 7


class _Loop:
    """An event loop in a thread: the hosts serve there while the verbs
    run their own loops in the test's thread."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def _components(root: Path) -> Path:
    """The state store and broker files, under ``root``."""
    root.mkdir()
    comps = root / "components"
    comps.mkdir()
    for name, type_, key, value in (("kv", "state.sqlite", "databasePath", root / "kv.db"),
                                    ("ps", "pubsub.redis", "brokerPath", root / "broker.db")):
        (comps / f"{name}.yaml").write_text(
            f"apiVersion: dapr.io/v1alpha1\nkind: Component\nmetadata:\n  name: {name}\n"
            f"spec:\n  type: {type_}\n  version: v1\n  metadata:\n  - name: {key}\n"
            f"    value: {value}\n")
    return comps


def _jax_app() -> JaxApp:
    app = JaxApp(APP_ID)

    @app.post("/echo")
    async def echo(request):
        return {"echo": request.json()}

    return app


def _port_app() -> App:
    app = App(APP_ID)

    @app.post("/echo")
    async def echo(req):
        return {"echo": req.json()}

    return app


def _calls(seed: int) -> list[tuple]:
    """The seeded calls each sidecar takes: state, publish and invoke,
    the last two also in the known trace."""
    rng = random.Random(seed)
    calls = []
    for i in range(16):
        key = f"k{rng.randrange(3)}"
        calls.append(rng.choice([
            ("POST", "/v1.0/state/kv", [{"key": key, "value": {"i": i}}], {}),
            ("GET", f"/v1.0/state/kv/{key}", None, {}),
            ("POST", "/v1.0/publish/ps/topic", {"i": i}, {}),
            ("POST", f"/v1.0/invoke/{APP_ID}/method/echo", {"i": i}, {}),
            ("GET", "/v1.0/state/nope/x", None, {})]))
    traced = {"traceparent": f"00-{TRACE}-00f067aa0ba902b7-01"}
    calls += [("POST", "/v1.0/publish/ps/topic", {"traced": 1}, traced),
              ("POST", f"/v1.0/invoke/{APP_ID}/method/echo", {"traced": 2}, traced)]
    return calls


async def _drive(port: int) -> list[int]:
    statuses = []
    for method, path, body, headers in _calls(SEED):
        status, _, _ = await asyncio.wait_for(http_request(
            "127.0.0.1", port, method, path, headers={**AUTH, **headers},
            body=b"" if body is None else json.dumps(body).encode()), 30)
        statuses.append(status)
    return statuses


def _series(text: str) -> dict[str, set]:
    """Prometheus text → sample name → the label sets it carries."""
    out: dict[str, set] = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            m = re.fullmatch(r"([a-zA-Z_:][\w:]*)(\{.*\})? \S+", line)
            assert m, line
            out.setdefault(m.group(1), set()).add(m.group(2) or "")
    return out


def _types(text: str) -> dict[str, str]:
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _rows(doc: dict) -> list[tuple]:
    """Span rows with their ids, times and app id masked; each parent
    given as the position of its span among these rows."""
    rows = sorted(doc["spans"], key=lambda r: (r["kind"], r["name"]))
    index = {r["span_id"]: i for i, r in enumerate(rows)}
    return [(r["trace_id"], r["kind"], r["name"], r["status"], json.loads(r["attrs"]),
             index.get(r["parent_id"], "outside")) for r in rows]


_MASKS = [
    (re.compile(r"\b\d\d:\d\d:\d\d(\.\d{3})?\b"), "<clock>"),
    (re.compile(r"in \d+\.\d\ds \(\d+/s\)"), "in <s>"),
    (re.compile(r"[0-9a-f]{32}|[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"),
     "<id>"),
    (re.compile(r"python -m tasksrunner_torch "), "tasksrunner "),
]
#: lines whose numbers are this process's own times: the uptime and the
#: sidecar's request latencies (the verbs' own metadata calls among them)
_TIMED = re.compile(r"uptime_seconds|sidecar_request_latency_seconds|event_loop_lag|"
                    r'"(p50|p95|p99|sum|count|time|seconds)"')


def _normal(text: str) -> str:
    lines = []
    for line in text.splitlines():
        for pattern, repl in _MASKS:
            line = pattern.sub(repl, line)
        if _TIMED.search(line):
            line = re.sub(r"\d+(\.\d+)?(e-?\d+)?", "#", line)
        lines.append(line)
    return "\n".join(lines)


def _verb(main, argv, capsys) -> tuple:
    try:
        main(argv)
        code = 0
    except SystemExit as exc:
        code = 0 if exc.code is None else (exc.code if isinstance(exc.code, int) else 1)
    out = capsys.readouterr().out
    return code, _normal(out)


def _both(argv, capsys) -> tuple:
    """The JAX verb, then the port's, on the same arguments."""
    want = _verb(jax_cli.main, argv, capsys)
    got = _verb(cli.main, argv, capsys)
    assert got == want, f"{argv}: port {got!r} != JAX {want!r}"
    return got


def _dead_letters(root: Path) -> Path:
    """A broker file and a queue file holding dead letters, and the
    components that name them."""
    comps = root / "dlq-components"
    comps.mkdir(parents=True)
    (comps / "bus.yaml").write_text(
        "apiVersion: dapr.io/v1alpha1\nkind: Component\nmetadata:\n  name: bus\nspec:\n"
        f"  type: pubsub.redis\n  version: v1\n  metadata:\n  - name: brokerPath\n"
        f"    value: {root / 'dlq-broker.db'}\n")
    (comps / "jobs.yaml").write_text(
        "apiVersion: dapr.io/v1alpha1\nkind: Component\nmetadata:\n  name: jobs\nspec:\n"
        "  type: bindings.azure.storagequeues\n  version: v1\n  metadata:\n"
        f"  - name: queuePath\n    value: {root / 'queues'}\n")
    rng = random.Random(SEED)

    async def publish():
        broker = SqliteBroker("bus", root / "dlq-broker.db")
        await broker.ensure_group("orders", "billing")
        for i in range(5):
            await broker.publish("orders", {"order": i, "note": "x" * rng.randrange(80)})
        await broker.aclose()

    asyncio.run(publish())
    with sqlite3.connect(root / "dlq-broker.db") as conn:
        conn.execute("UPDATE deliveries SET done = 2, attempts = 3 WHERE rowid % 2 = 1")
    queue = SqliteQueue(root / "queues" / "jobs.db")
    for i in range(4):
        msg = queue.send({"job": i})
        if i != 2:
            queue.dead_letter(msg)
    queue.close()
    return comps


def test_sidecar_routes_and_verbs_match_the_jax_package(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TASKSRUNNER_API_TOKEN", TOKEN)
    monkeypatch.setenv("TASKSRUNNER_MESH", "0")
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.chdir(tmp_path)
    # fresh process-wide registries, recorders and flight recorders for
    # the two hosts; all put back after
    jax_metrics_module = sys.modules["tasksrunner.observability.metrics"]
    for reg, kinds in ((metrics, None), (jax_metrics_module.metrics, "_kinds")):
        for attr in ("_counters", "_gauges", "_histograms"):
            monkeypatch.setattr(reg, attr, {})
        if kinds:
            monkeypatch.setattr(reg, kinds, {"uptime_seconds": "gauge"})
    for module in (flightrec, jax_flightrec):
        monkeypatch.setattr(module, "_flightrec", None)
    monkeypatch.setattr(sys.modules["tasksrunner_torch.metrics"], "on_slow_exemplar", None)
    monkeypatch.setattr(jax_metrics_module, "on_slow_exemplar", None)
    monkeypatch.setattr(spans, "_recorder", None)
    monkeypatch.setattr(jax_spans, "_recorder", None)
    dbs = {"jax": str(tmp_path / "jax-traces.db"), "port": str(tmp_path / "port-traces.db")}
    jax_spans.configure_spans(APP_ID, dbs["jax"])
    spans.configure_spans(APP_ID, dbs["port"])
    # the same component files, each host's own store and broker files
    comps = {name: _components(tmp_path / name) for name in ("jax", "port")}
    registries = {"jax": str(tmp_path / "jax-apps.json"), "port": str(tmp_path / "port-apps.json")}
    loop = _Loop()
    hosts = {"jax": JaxAppHost(_jax_app(), components_path=str(comps["jax"]),
                               registry_file=registries["jax"]),
             "port": AppHost(_port_app(), components_path=str(comps["port"]),
                             registry_file=registries["port"])}
    started = []
    try:
        for name, host in hosts.items():
            loop.run(host.start())
            started.append(host)
        statuses = {name: loop.run(_drive(host.sidecar_port)) for name, host in hosts.items()}
        assert statuses["port"] == statuses["jax"]
        assert {200, 204, 400} <= set(statuses["jax"])
        # a route reads a span file once the recorder's timer has made it
        deadline = time.monotonic() + 10
        while not all(Path(db).is_file() for db in dbs.values()):
            assert time.monotonic() < deadline, "no span file after 10 s"
            time.sleep(0.05)
        texts, traces = {}, {}
        for name, host in hosts.items():
            port = host.sidecar_port
            status, _, _ = loop.run(http_request("127.0.0.1", port, "GET", "/metrics"))
            assert status == 401
            status, headers, body = loop.run(http_request("127.0.0.1", port, "GET", "/metrics",
                                                          headers=AUTH))
            assert status == 200
            assert headers["content-type"] == "text/plain; version=0.0.4; charset=utf-8"
            texts[name] = body.decode()
            status, _, body = loop.run(http_request("127.0.0.1", port, "GET",
                                                    f"/v1.0/traces/{TRACE}", headers=AUTH))
            assert status == 200
            traces[name] = json.loads(body)
        got, want = _series(texts["port"]), _series(texts["jax"])
        common = set(got) & set(want)
        assert {"publish", "invoke", "state_save", "sidecar_request_latency_seconds_bucket",
                "invoke_latency_seconds_count", "uptime_seconds"} <= common
        assert {n: got[n] for n in common} == {n: want[n] for n in common}
        common_types = set(_types(texts["port"])) & set(_types(texts["jax"]))
        assert {n: _types(texts["port"])[n] for n in common_types} == \
            {n: _types(texts["jax"])[n] for n in common_types}
        assert _rows(traces["port"]) == _rows(traces["jax"])
        assert [r[2] for r in _rows(traces["port"])] == [
            f"invoke {APP_ID}/echo", "publish ps/topic", "POST /echo"]

        # the verbs, each package's against each host and the files; one
        # metadata call first, so each verb finds the series of its own call
        for host in hosts.values():
            assert loop.run(http_request("127.0.0.1", host.sidecar_port, "GET",
                                         "/v1.0/metadata", headers=AUTH))[0] == 200
        for name in hosts:
            reg = ["--registry-file", registries[name]]
            for argv in (
                    ["invoke", APP_ID, "echo", "--verb", "POST", "--data", '{"a": [1, 2]}'],
                    ["invoke", APP_ID, "missing"],
                    ["invoke", "ghost", "echo"],
                    ["publish", "ps", "topic", "--app-id", APP_ID, "--data", '{"x": 1}'],
                    ["publish", "ps", "topic", "--app-id", APP_ID, "--count", "5"],
                    ["publish", "nope", "topic", "--app-id", APP_ID],
                    ["state", "set", "kv", f"{name}-key", "--app-id", APP_ID, "--data",
                     '{"v": "é"}'],
                    ["state", "get", "kv", f"{name}-key", "--app-id", APP_ID],
                    ["state", "query", "kv", "--app-id", APP_ID, "--data",
                     '{"filter": {"EQ": {"v": "é"}}}'],
                    ["state", "get", "kv", "--app-id", APP_ID],
                    ["state", "delete", "kv", f"{name}-key", "--app-id", APP_ID],
                    ["state", "get", "kv", f"{name}-key", "--app-id", APP_ID],
                    ["metrics", APP_ID],
                    ["metrics", "--app-id", APP_ID, "--json"],
                    ["metrics", APP_ID, "--percentiles"],
                    ["metrics", APP_ID, "--slow", "latency"],
                    ["metrics", "ghost"]):
                _both(argv + reg, capsys)
        # the span files, each package's and both
        for db in (dbs["jax"], dbs["port"], f"{dbs['port']},{dbs['jax']}"):
            for argv in (["list"], ["show", TRACE], ["critical", TRACE[:12]], ["map"],
                         ["map", "--mermaid"], ["show", "f" * 32], ["show"],
                         ["query", "SELECT role, kind, name, status FROM spans ORDER BY name"],
                         ["query", "DELETE FROM spans"], ["query"]):
                _both(["traces", *argv, "--db", db], capsys)
        assert _both(["traces", "list", "--db", str(tmp_path / "none.db")], capsys)[0] == 2
        # a dump from each package's flight recorder, each listed and read by both
        for module, reason in ((flightrec, "admission-shed"), (jax_flightrec, "slow-exemplar")):
            assert module.dump(reason, {"score": 1.5})
        dumps = sorted((tmp_path / "flightrec").glob("*.json"))
        assert len(dumps) == 2
        _both(["flightrec", "--dir", str(tmp_path / "flightrec")], capsys)
        for dump in dumps:
            _both(["flightrec", "--dump", str(dump), "--limit", "5"], capsys)
        _both(["flightrec", "--dir", str(tmp_path / "nothing")], capsys)
        _both(["components", str(comps["port"])], capsys)
        _both(["components", str(comps["port"]), "--app-id", "other"], capsys)
    finally:
        for host in reversed(started):
            loop.run(host.stop())
        loop.close()
        jax_spans._recorder.close()
        spans.close_spans()

    # dead letters: each verb on its own copy of the files, then the files compared
    comps = _dead_letters(tmp_path / "dlq")
    for argv in (["list", "bus", "orders", "--group", "billing"],
                 ["show", "bus", "orders", "--app-id", "billing"],
                 ["list", "jobs"], ["show", "jobs"],
                 ["requeue", "bus", "orders", "--group", "billing"],
                 ["purge", "jobs"], ["list", "bus", "orders"], ["list", "ghost"],
                 ["list", "bus", "orders", "--group", "nobody"]):
        results = {}
        for name, main in (("jax", jax_cli.main), ("port", cli.main)):
            copy = tmp_path / f"dlq-{name}"
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(tmp_path / "dlq", copy)
            for f in (copy / "dlq-components").iterdir():
                f.write_text(f.read_text().replace(str(tmp_path / "dlq"), str(copy)))
            out = _verb(main, ["dlq", *argv, "--resources", str(copy / "dlq-components")],
                        capsys)
            with sqlite3.connect(copy / "dlq-broker.db") as conn:
                broker = conn.execute("SELECT msg_id, done, attempts FROM deliveries "
                                      "ORDER BY msg_id").fetchall()
            with sqlite3.connect(copy / "queues" / "jobs.db") as conn:
                queue = conn.execute("SELECT id, done FROM queue ORDER BY id").fetchall()
            results[name] = (out, broker, queue)
        assert results["port"] == results["jax"], argv


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


async def test_admin_traces_merge_two_sidecars_and_skip_a_dead_one(tmp_path, monkeypatch):
    """Two replicas in one process would share its one recorder; here
    each sidecar is given a recorder of its own, as two processes have."""
    monkeypatch.setenv("TASKSRUNNER_API_TOKEN", TOKEN)
    monkeypatch.setattr(flightrec, "_flightrec", None)
    serving: contextvars.ContextVar = contextvars.ContextVar("serving")
    monkeypatch.setattr(spans, "recorder", lambda: serving.get(None))
    now = time.time()
    rows = [dict(trace_id=TRACE, span_id=f"{i:016x}", parent_id=f"{i - 1:016x}" if i else None,
                 kind="client" if i == 0 else "server", name=f"hop {i}", status=200,
                 start=now + i / 100, duration=0.5 - i / 100, attrs={"i": i})
            for i in range(4)]
    recorders, sidecars = [], []
    for n, part in enumerate((rows[:3], rows[2:])):  # hop 2 is in both
        rec = spans.SpanRecorder(f"replica{n}", tmp_path / f"replica{n}.db")
        for row in part[:-1]:
            rec.append(**row)
        rec.flush()
        rec.append(**part[-1])  # still buffered: the route flushes it
        rec.append(**{**rows[0], "trace_id": "e" * 32, "span_id": f"{90 + n:016x}"})
        recorders.append(rec)
        sidecar = Sidecar(Runtime(f"replica{n}", ComponentRegistry([]),
                                  resolver=NameResolver(registry_file=tmp_path / "apps.json")),
                          port=0)

        async def handle(*args, _handle=sidecar.handle, _rec=rec):
            serving.set(_rec)
            return await _handle(*args)

        sidecar.handle = handle
        await sidecar.start()
        sidecars.append(sidecar)
    orch = types.SimpleNamespace(replicas={
        "a": [types.SimpleNamespace(ports=(0, sidecars[0].port)),
              types.SimpleNamespace(ports=None)],  # not ready yet: not asked
        "b": [types.SimpleNamespace(ports=(0, _free_port())),  # down
              types.SimpleNamespace(ports=(0, sidecars[1].port))]})
    admin = AdminServer(orch)
    try:
        reply = await admin.handle("GET", f"/admin/traces/{TRACE}", {}, b"")
        assert reply.status == 401
        reply = await admin.handle("GET", f"/admin/traces/{TRACE[:10]}", AUTH, b"")
        assert reply.status == 200
        assert reply.body["trace_id"] == TRACE[:10] and reply.body["replicas"] == 2
        got = reply.body["spans"]
        assert [(r["name"], r["role"]) for r in got] == [
            ("hop 0", "replica0"), ("hop 1", "replica0"), ("hop 2", "replica0"),
            ("hop 3", "replica1")]
        assert [json.loads(r["attrs"]) for r in got] == [{"i": i} for i in range(4)]
        reply = await admin.handle("GET", f"/admin/traces/{'0' * 32}", AUTH, b"")
        assert reply.body == {"trace_id": "0" * 32, "replicas": 2, "spans": []}
    finally:
        for sidecar in sidecars:
            await sidecar.stop()
        for rec in recorders:
            rec.close()
