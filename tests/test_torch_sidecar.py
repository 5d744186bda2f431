"""The port's sidecar, runtime and hosts on the CPU, without JAX: every
route's status and body, the API token, invoke between two sidecars that
share one registry file, subscription deliveries deferred by 503 and 429,
``AppHost``, and the command line (one test runs ``serve`` and
``sidecar`` as processes)."""

import asyncio
import json
import os
import signal
import socket
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tasksrunner_torch import cli
from tasksrunner_torch.app import App, Response
from tasksrunner_torch.client import http_request
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import parse_component
from tasksrunner_torch.hosting import AppHost
from tasksrunner_torch.invoke.resolver import AppAddress, NameResolver
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.runtime import HTTPAppChannel, Runtime
from tasksrunner_torch.sidecar import Sidecar

REPO = Path(__file__).resolve().parent.parent
TOPIC = "tasksavedtopic"


def bounded(aw, seconds: float = 20):
    return asyncio.wait_for(aw, seconds)


def spec(name: str, type_: str, **metadata) -> object:
    return parse_component({"componentType": type_, "metadata": [
        {"name": k, "value": str(v)} for k, v in metadata.items()]}, default_name=name)


def components(tmp_path, **broker_metadata) -> list:
    return [spec("kv", "state.sqlite", databasePath=tmp_path / "kv.db"),
            spec("bus", "pubsub.sqlite", brokerPath=tmp_path / "bus.db", gcIntervalSeconds=0,
                 **broker_metadata)]


async def call(port: int, method: str, path: str, body=None, headers=None):
    """(status, headers, body as bytes); a non-bytes body is sent as JSON."""
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    return await bounded(http_request("127.0.0.1", port, method, path,
                                      headers=headers, body=body or b""))


async def _sidecar(app_id, specs, *, app_port=None, resolver=None) -> Sidecar:
    channel = HTTPAppChannel("127.0.0.1", app_port) if app_port else None
    runtime = Runtime(app_id, ComponentRegistry(specs, app_id=app_id),
                      resolver=resolver, app_channel=channel)
    sidecar = Sidecar(runtime, port=0)
    await bounded(sidecar.start())
    return sidecar


async def test_every_route_answers_with_its_status_and_body(tmp_path):
    sc = await _sidecar("a", components(tmp_path))
    p = sc.port
    try:
        assert await call(p, "POST", "/v1.0/state/kv", [{"key": "x", "value": {"v": 1}}]) == \
            (204, {"content-length": "0", "connection": "close"}, b"")
        status, headers, body = await call(p, "GET", "/v1.0/state/kv/x")
        assert (status, json.loads(body), headers["etag"]) == (200, {"v": 1}, "1")
        assert (await call(p, "GET", "/v1.0/state/kv/missing"))[::2] == (204, b"")
        status, _, body = await call(p, "POST", "/v1.0/state/kv",
                                     [{"key": "x", "value": 2, "etag": "9"}])
        assert (status, json.loads(body)) == (409, {"error": "etag mismatch for key 'a||x'"})
        assert (await call(p, "DELETE", "/v1.0/state/kv/x", headers={"if-match": "9"}))[0] == 409
        assert (await call(p, "POST", "/v1.0/state/kv/transaction", {"operations": [
            {"operation": "upsert", "request": {"key": "y", "value": [1]}},
            {"operation": "delete", "request": {"key": "x"}}]}))[0] == 204
        status, _, body = await call(p, "POST", "/v1.0/state/kv/bulk", {"keys": ["x", "y"]})
        # etag 2 went to the refused write: a refused op leaves a gap
        assert (status, json.loads(body)) == (
            200, [{"key": "x"}, {"key": "y", "data": [1], "etag": "3"}])
        assert (await call(p, "DELETE", "/v1.0/state/kv/y"))[::2] == (204, b"")
        # the store holds the app's keys under its prefix
        with sqlite3.connect(tmp_path / "kv.db") as conn:
            assert conn.execute("SELECT key FROM state").fetchall() == []
        await call(p, "POST", "/v1.0/state/kv", [{"key": "z", "value": None}])
        with sqlite3.connect(tmp_path / "kv.db") as conn:
            assert conn.execute("SELECT key, value FROM state").fetchall() == [("a||z", "null")]
        assert (await call(p, "GET", "/v1.0/state/kv/z"))[::2] == (200, b"null")

        status, _, body = await call(p, "POST", "/v1.0/publish/bus/t", {"taskId": "1"})
        assert status == 200 and len(json.loads(body)["messageId"]) == 32
        status, _, body = await call(p, "POST", "/v1.0/publish/bus/t?metadata.rawPayload=true",
                                     b'{"raw": 1}')
        assert status == 200

        for method, path, payload, want in (
                ("POST", "/v1.0/state/kv", b"{not json", (400, "malformed JSON body: ")),
                ("POST", "/v1.0/state/kv", {"key": "x"}, (400, "state save body must be")),
                ("POST", "/v1.0/state/kv", [{"value": 1}], (500, "each state item needs a key")),
                ("POST", "/v1.0/state/kv/transaction",
                 {"operations": [{"operation": "merge", "request": {"key": "k"}}]},
                 (500, "unknown transaction operation 'merge'")),
                ("GET", "/v1.0/state/nope/x", None,
                 (400, "component 'nope' is not registered for app 'a'")),
                ("POST", "/v1.0/publish/kv/t", {}, (400, "component 'kv' is 'state.sqlite', "
                                                        "not a pubsub component")),
                ("POST", "/v1.0/invoke/ghost/method/x", {},
                 (404, "no app registered with id 'ghost'")),
                ("GET", "/v1.0/nothing", None, (404, "no route GET /v1.0/nothing")),
                ("PUT", "/v1.0/state/kv", None, (405, "no route PUT /v1.0/state/kv"))):
            status, _, body = await call(p, method, path, payload)
            assert (status, json.loads(body)["error"][:len(want[1])]) == want, path

        assert (await call(p, "GET", "/v1.0/healthz"))[::2] == (204, b"")
        status, _, body = await call(p, "GET", "/v1.0/metadata")
        meta = json.loads(body)
        assert status == 200 and meta["id"] == "a" and meta["subscriptions"] == []
        assert meta["components"] == [{"name": "bus", "type": "pubsub.sqlite"},
                                      {"name": "kv", "type": "state.sqlite"}]
        assert meta["metrics"]["sidecar_request_latency_seconds_count{route=save_state}"] >= 3
    finally:
        await bounded(sc.stop())


async def test_the_api_token_guards_every_route_but_healthz(tmp_path, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_API_TOKEN", "s3cret")
    sc = await _sidecar("a", components(tmp_path))
    try:
        for method, path in (("GET", "/v1.0/state/kv/x"), ("POST", "/v1.0/publish/bus/t"),
                             ("GET", "/v1.0/metadata"), ("POST", "/v1.0/invoke/a/method/x")):
            status, _, body = await call(sc.port, method, path, {})
            assert (status, json.loads(body)) == (401, {"error": "missing or bad api token"})
            assert (await call(sc.port, method, path, {},
                               headers={"tr-api-token": "wrong"}))[0] == 401
        assert (await call(sc.port, "GET", "/v1.0/healthz"))[0] == 204
        assert (await call(sc.port, "GET", "/v1.0/state/kv/x",
                           headers={"tr-api-token": "s3cret"}))[0] == 204
    finally:
        await bounded(sc.stop())


async def test_invoke_crosses_two_sidecars_through_one_registry_file(tmp_path):
    registry = tmp_path / "apps.json"
    target = App("target")

    @target.route("PUT", "/things/{kind}/{id}")
    async def put_thing(req):
        return Response(201, {"path": req.path, "query": req.query, "body": req.json(),
                              "x-tag": req.headers.get("x-tag"),
                              "cookie": req.headers.get("cookie"),
                              "traced": "traceparent" in req.headers},
                        headers={"X-Reply": "yes", "Retry-After": "3"})

    caller = App("caller")
    target_port = await cli.start_app(target)
    caller_port = await cli.start_app(caller)
    sidecars = []
    try:
        for app_id, port in (("target", target_port), ("caller", caller_port)):
            resolver = NameResolver(registry_file=registry)
            sc = await _sidecar(app_id, [], app_port=port, resolver=resolver)
            sidecars.append(sc)
            await asyncio.to_thread(resolver.register, AppAddress(
                app_id=app_id, host="127.0.0.1", sidecar_port=sc.port, app_port=port))
        assert set(json.loads(registry.read_text())) == {"target", "caller"}
        status, headers, body = await call(
            sidecars[1].port, "PUT", "/v1.0/invoke/target/method/things/a/b?x=1", {"n": 1},
            headers={"x-tag": "t", "cookie": "secret", "content-type": "application/json"})
        assert status == 201
        assert json.loads(body) == {"path": "/things/a/b", "query": "x=1", "body": {"n": 1},
                                    "x-tag": "t", "cookie": None, "traced": True}
        assert headers["x-reply"] == "yes" and headers["retry-after"] == "3"
        # the caller's own client goes the same way: two hops
        caller.client = cli.AppClient.http(sidecars[1].port)
        reply = await bounded(caller.client.invoke_method("target", "things/c/d",
                                                          http_method="PUT", data=[2]))
        assert (reply.status, reply.json()["body"]) == (201, [2])
        missing = await call(sidecars[1].port, "GET", "/v1.0/invoke/target/method/nope")
        assert missing[0] == 404
    finally:
        for sc in sidecars:
            await bounded(sc.stop())
        await bounded(target.stop())
        await bounded(caller.stop())


async def test_deliveries_deferred_by_503_and_429_charge_no_attempt(tmp_path):
    # one attempt: a deferral that used one would dead-letter the event
    specs = components(tmp_path, maxRetries=1, retryDelaySeconds=5)
    app = App("consumer")
    answers = [Response(503, {"error": "warming"}, headers={"Retry-After": "0.05"}),
               Response(429, {"error": "busy"}, headers={"Retry-After": "0.05"})]
    got: list = []

    @app.subscribe("bus", TOPIC, "/on-saved")
    async def on_saved(req):
        got.append((req.data, "traceparent" in req.headers))
        return answers.pop(0) if answers else 200

    port = await cli.start_app(app)
    sc = await _sidecar("consumer", specs, app_port=port)
    try:
        status, _, _ = await call(sc.port, "POST", f"/v1.0/publish/bus/{TOPIC}", {"taskId": "t"})
        assert status == 200

        async def acked():
            while sc.runtime.registry.get("bus").backlog(TOPIC, "consumer"):
                await asyncio.sleep(0.01)
        await bounded(acked())
        assert got == [({"taskId": "t"}, True)] * 3
        bus = sc.runtime.registry.get("bus")
        assert bus.dead_letters(TOPIC, "consumer") == []
        with sqlite3.connect(tmp_path / "bus.db") as conn:
            assert conn.execute("SELECT attempts, done FROM deliveries").fetchall() == [(1, 1)]
        for code in ("503", "429", "200"):
            assert metrics.get("pubsub_delivery", route="/on-saved", status=code) >= 1
        meta = json.loads((await call(sc.port, "GET", "/v1.0/metadata"))[2])
        assert meta["subscriptions"] == [{"topic": TOPIC, "group": "consumer"}]
    finally:
        await bounded(sc.stop())
        await bounded(app.stop())


async def test_app_host_serves_the_app_and_its_sidecar_in_one_process(tmp_path):
    app = App("hosted")

    @app.post("/note")
    async def note(req):
        await app.client.save_state("kv", "n", req.json())
        return await app.client.get_state("kv", "n")

    registry = tmp_path / "apps.json"
    host = AppHost(app, specs=components(tmp_path), registry_file=str(registry))
    await bounded(host.start())
    try:
        assert (await call(host.sidecar_port, "GET", "/v1.0/healthz"))[0] == 204
        status, _, body = await call(host.sidecar_port, "POST",
                                     "/v1.0/invoke/hosted/method/note", {"v": 3})
        assert (status, json.loads(body)) == (200, {"v": 3})
        status, _, body = await call(host.app_port, "POST", "/note", {"v": 4})
        assert (status, json.loads(body)) == (200, {"v": 4})
        (entry,) = json.loads(registry.read_text())["hosted"]
        assert (entry["sidecar_port"], entry["app_port"]) == (host.sidecar_port, host.app_port)
    finally:
        await bounded(host.stop())
    assert json.loads(registry.read_text()) == {}


async def test_app_host_unwinds_a_start_that_fails(tmp_path):
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        app = App("hosted")
        host = AppHost(app, specs=[], sidecar_port=taken.getsockname()[1],
                       registry_file=str(tmp_path / "apps.json"))
        with pytest.raises(OSError):
            await bounded(host.start())
    with pytest.raises(OSError):  # the app's port was released
        await call(host.app_port, "GET", "/tasksrunner/healthz")
    assert not (tmp_path / "apps.json").exists() or json.loads(
        (tmp_path / "apps.json").read_text()) == {}


async def test_a_subscription_without_its_grant_fails_the_start(tmp_path, monkeypatch):
    from tasksrunner_torch.errors import PermissionDenied
    from tasksrunner_torch.security import grants_from_env

    app = App("consumer")

    @app.subscribe("bus", TOPIC, "/on-saved")
    async def on_saved(req):
        return 200

    port = await cli.start_app(app)
    try:
        for grants, allowed in (({"bus": ["publish"]}, False),
                                ({"bus": [{"subscribe": ["othertopic"]}]}, False),
                                ({"bus": [{"subscribe": [TOPIC]}], "kv": ["read"]}, True)):
            monkeypatch.setenv("TASKSRUNNER_GRANTS", json.dumps(grants))
            runtime = Runtime("consumer", ComponentRegistry(components(tmp_path),
                                                            app_id="consumer"),
                              app_channel=HTTPAppChannel("127.0.0.1", port),
                              grants=grants_from_env())
            try:
                if allowed:
                    await bounded(runtime.start())
                    with pytest.raises(PermissionDenied, match="no 'write' grant"):
                        await bounded(runtime.save_state("kv", [{"key": "k", "value": 1}]))
                else:
                    with pytest.raises(PermissionDenied):
                        await bounded(runtime.start())
            finally:
                await bounded(runtime.stop())
    finally:
        await bounded(app.stop())


def test_the_resolver_prunes_what_dead_replicas_left(tmp_path):
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait(timeout=30)
    registry = tmp_path / "apps.json"
    resolver = NameResolver(registry_file=registry)
    resolver.register(AppAddress(app_id="gone", host="127.0.0.1", sidecar_port=1, pid=dead.pid))
    resolver.register(AppAddress(app_id="here", host="127.0.0.1", sidecar_port=2))
    resolver.register(AppAddress(app_id="here", host="127.0.0.1", sidecar_port=3))
    peer = NameResolver(registry_file=registry)
    assert {peer.resolve("here").sidecar_port for _ in range(2)} == {2, 3}  # round robin
    assert resolver.prune_dead_local() == [("gone", dead.pid)]
    with pytest.raises(cli.TasksRunnerError, match="no app registered with id 'gone'"):
        peer.resolve("gone")
    resolver.unregister("here", pid=os.getpid(), sidecar_port=2)
    assert [a.sidecar_port for a in peer.resolve_all("here")] == [3]


def test_the_commands_refuse_to_run_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["serve", "tasksrunner_torch.service:make_app"],
                 ["sidecar", "--app-id", "x", "--app-port", "1"],
                 ["host", "tasksrunner_torch.service:make_app", "--device", "cuda:0"]):
        with pytest.raises(SystemExit, match="no CUDA device is available"):
            cli.main(argv)


def test_device_goes_to_a_factory_that_takes_one_and_is_refused_otherwise():
    app = cli.make_app("tasksrunner_torch.service:make_app", "cpu")
    assert app.app_id == "priority-scorer"
    with pytest.raises(cli.TasksRunnerError, match="takes no device argument"):
        cli.make_app("tasksrunner_torch.app:App", "cpu")
    with pytest.raises(cli.TasksRunnerError, match="cannot import app module"):
        cli.make_app("no_such_module:make_app")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ready(proc: subprocess.Popen, seconds: float = 60) -> dict:
    """The fields of the process's ``ready`` line."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("ready "):
            return dict(kv.split("=", 1) for kv in line.split()[1:])
        if not line and proc.poll() is not None:
            raise AssertionError(f"exited {proc.returncode}: {proc.stderr.read()[-2000:]}")
    raise AssertionError("no ready line")


def test_serve_and_sidecar_as_processes_score_a_saved_task(tmp_path):
    """The two-process layout from the command line, on the CPU: the
    scorer served by ``serve``, its ``sidecar`` over sqlite files; an
    event published to the sidecar is scored and stored, ``/score``
    through the sidecar gives the stored answer, and SIGTERM stops both
    cleanly and unregisters the sidecar."""
    comps = tmp_path / "components"
    comps.mkdir()
    (comps / "statestore.yaml").write_text(
        "kind: Component\nmetadata:\n  name: scores\nspec:\n  type: state.azure.cosmosdb\n"
        f"  metadata:\n  - name: databasePath\n    value: {tmp_path / 'scores.db'}\n")
    (comps / "pubsub.yaml").write_text(
        "kind: Component\nmetadata:\n  name: taskspubsub\nspec:\n  type: pubsub.redis\n"
        f"  metadata:\n  - name: brokerPath\n    value: {tmp_path / 'broker.db'}\n")
    registry = tmp_path / "apps.json"
    sidecar_port = _free_port()
    env = {**os.environ, "TASKSRUNNER_ML_BUCKETS": "1"}
    run = [sys.executable, "-m", "tasksrunner_torch", "--log-level", "warning"]
    procs = []
    try:
        procs.append(subprocess.Popen(
            run + ["serve", "tasksrunner_torch.service:make_app", "--device", "cpu",
                   "--sidecar-port", str(sidecar_port)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        app_port = int(_ready(procs[0])["app_port"])
        procs.append(subprocess.Popen(
            run + ["sidecar", "--app-id", "priority-scorer", "--app-port", str(app_port),
                   "--port", str(sidecar_port), "--components", str(comps),
                   "--registry-file", str(registry), "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        assert _ready(procs[1]) == {"app": "priority-scorer", "sidecar_port": str(sidecar_port)}

        async def drive():
            task = {"taskId": "t-1", "taskName": "rotate the keys", "taskAssignedTo": "ops"}
            status, _, _ = await call(sidecar_port, "POST",
                                      "/v1.0/publish/taskspubsub/tasksavedtopic", task)
            assert status == 200
            deadline = time.monotonic() + 30
            while True:
                status, _, body = await call(
                    sidecar_port, "GET", "/v1.0/invoke/priority-scorer/method/scores/t-1")
                if status == 200:
                    break
                assert status == 404 and time.monotonic() < deadline, (status, body)
                await asyncio.sleep(0.05)
            status, _, scored = await call(
                sidecar_port, "POST", "/v1.0/invoke/priority-scorer/method/score", task)
            assert status == 200
            return json.loads(body), json.loads(scored)

        stored, scored = asyncio.run(drive())
        assert stored == {k: v for k, v in scored.items() if k != "taskId"}
        with sqlite3.connect(tmp_path / "scores.db") as conn:
            assert conn.execute("SELECT key FROM state").fetchall() == [("priority-scorer||t-1",)]
        for proc in reversed(procs):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0, proc.stderr.read()[-2000:]
        assert json.loads(registry.read_text()) == {}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdout.close()
            proc.stderr.close()
