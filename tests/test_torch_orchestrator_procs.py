"""The port's orchestrator with real replica processes on the CPU: each
replica a ``python -m tasksrunner_torch host`` of the scorer
(``--device cpu``, one bucket), min 1 and max 2. Two tests, each bounded
by its own time limit:

* ``python -m tasksrunner_torch run`` over sqlite files: a backlog scales
  it out to 2, a replica killed with SIGKILL mid-burst is restarted and
  no event is lost (each stored once, no dead letter), it scales in after
  the cooldown, and SIGTERM stops every replica, each logging its kernel
  launch counts, and leaves the registry empty;
* the admin verbs through the command line (``scale``, ``update``,
  ``restart``, ``logs``, ``revisions``, ``ps``), the merged metrics, a
  trace no replica recorded, ``/admin/actors`` over a replica without actors,
  ``/admin/placement``'s one-shot sweep and ``shards``, a second
  orchestrator fenced out, a standby that
  adopts the replica an abandoned orchestrator left running, and
  ``stop``, after which the adopted replica is respawned."""

import asyncio
import json
import os
import signal
import sqlite3
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tasksrunner_torch import cli, cloudevents
from tasksrunner_torch.client import http_request
from tasksrunner_torch.invoke.resolver import NameResolver
from tasksrunner_torch.orchestrator.admin import info_path
from tasksrunner_torch.orchestrator.config import AppSpec, HealthSpec, RunConfig, ScaleSpec
from tasksrunner_torch.orchestrator.run import Orchestrator
from tasksrunner_torch.pubsub.sqlite import SqliteBroker
from tasksrunner_torch.service import PRIORITY_LABELS

REPO = Path(__file__).resolve().parent.parent
APP, PUBSUB, TOPIC = "priority-scorer", "taskspubsub", "tasksavedtopic"
SCORER = "tasksrunner_torch.service:make_app"
LIMIT_S = 90


def _components(tmp_path: Path) -> Path:
    comps = tmp_path / "components"
    comps.mkdir()
    (comps / "scores.yaml").write_text(
        "kind: Component\nmetadata:\n  name: scores\nspec:\n  type: state.sqlite\n"
        f"  metadata:\n  - name: databasePath\n    value: {tmp_path / 'scores.db'}\n")
    # a short claim lease: a killed replica's claimed events come back soon
    (comps / "pubsub.yaml").write_text(
        "kind: Component\nmetadata:\n  name: taskspubsub\nspec:\n  type: pubsub.sqlite\n"
        f"  metadata:\n  - name: brokerPath\n    value: {tmp_path / 'broker.db'}\n"
        "  - name: claimLeaseSeconds\n    value: \"1\"\n"
        "  - name: gcIntervalSeconds\n    value: \"0\"\n")
    return comps


async def _publish(path: Path, first: int, n: int) -> list[str]:
    """``n`` saved-task events into the broker file, as a sidecar
    publishes them (a CloudEvent each); the scorer's group is made first."""
    broker = SqliteBroker(PUBSUB, path)
    try:
        await broker.ensure_group(TOPIC, APP)
        ids = [f"task-{i}" for i in range(first, first + n)]
        for task_id in ids:
            data = {"taskId": task_id, "taskName": f"rotate the keys of service {task_id}"}
            await broker.publish(TOPIC, cloudevents.wrap(data, source="test", topic=TOPIC,
                                                         pubsub_name=PUBSUB),
                                 metadata={"content-type": cloudevents.CONTENT_TYPE})
        return ids
    finally:
        await broker.aclose()


def _stored(path: Path) -> dict[str, dict]:
    if not path.exists():
        return {}
    with sqlite3.connect(path) as conn:
        try:
            rows = conn.execute("SELECT key, value FROM state").fetchall()
        except sqlite3.OperationalError:  # the file is made before its table
            return {}
    return {k.split("||", 1)[1]: json.loads(v) for k, v in rows}


def _until(predicate, seconds: float, what: str):
    deadline = time.monotonic() + seconds
    while True:
        value = predicate()
        if value:
            return value
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _admin(admin_url: str, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(admin_url + path, timeout=10) as resp:
        return json.loads(resp.read())


def test_run_scales_on_backlog_restarts_a_killed_replica_and_loses_no_event(tmp_path):
    comps = _components(tmp_path)
    run_file = tmp_path / "run.yaml"
    run_file.write_text(
        "resources_path: ./components\nregistry_file: .tasksrunner/apps.json\napps:\n"
        f"  - app_id: {APP}\n    module: {SCORER}\n"
        "    env: { TASKSRUNNER_ML_BUCKETS: \"1\" }\n"
        "    health: { interval_seconds: 0.5 }\n"
        "    scale:\n      min_replicas: 1\n      max_replicas: 2\n      cooldown_seconds: 6\n"
        "      rules:\n        - type: pubsub-backlog\n          metadata:\n"
        f"            component: {PUBSUB}\n            topic: {TOPIC}\n"
        "            messageCount: \"4\"\n")
    assert comps.is_dir()
    # a backlog waits before the orchestrator starts: its first step scales out
    published = asyncio.run(_publish(tmp_path / "broker.db", 0, 40))
    started = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tasksrunner_torch", "run", str(run_file), "--device", "cpu"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
        stderr=open(tmp_path / "orchestrator.log", "w"), text=True)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    remaining = lambda: LIMIT_S - (time.monotonic() - started)  # noqa: E731
    try:
        def ready(index: int) -> list[str]:
            return [line for line in lines if line.startswith(f"[{APP}·{index}] ready ")]

        _until(lambda: ready(0) and ready(1), remaining(), "the backlog did not scale to 2")
        admin_url = json.loads(info_path(tmp_path / ".tasksrunner/apps.json")
                               .read_text())["admin_url"]
        replicas = _admin(admin_url, "/admin/apps")["apps"][0]["replicas"]
        assert len(replicas) == 2
        killed = replicas[0]["pid"]
        published += asyncio.run(_publish(tmp_path / "broker.db", 40, 40))
        os.kill(killed, signal.SIGKILL)  # mid-burst

        _until(lambda: set(_stored(tmp_path / "scores.db")) >= set(published), remaining(),
               "not every event was stored")

        def scaled_in():
            group = _admin(admin_url, "/admin/apps")["apps"][0]["replicas"]
            return len(group) == 1 and group[0]["running"] and group[0] or None

        replica = _until(scaled_in, remaining(), "no scale-in after the cooldown")
        assert replica["pid"] != killed and replica["restarts"] == 1
        assert len(ready(0)) == 2  # the killed replica came back
        stored = _stored(tmp_path / "scores.db")
        assert sorted(stored) == sorted(published)
        assert all(v["priority"] in PRIORITY_LABELS and 0 < v["confidence"] <= 1
                   for v in stored.values())
        with sqlite3.connect(tmp_path / "broker.db") as conn:
            rows = conn.execute("SELECT done FROM deliveries WHERE grp = ?", (APP,)).fetchall()
        assert sorted(r[0] for r in rows) == [1] * len(published)  # acked, no dead letter

        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=max(remaining(), 1)) == 0, (
            tmp_path / "orchestrator.log").read_text()[-3000:]
        reader.join(timeout=10)
        counted = [line for line in lines if " kernel launches app=priority-scorer " in line]
        # the scaled-in replica and the last one logged their counts (on the CPU, none)
        assert len(counted) == 2, lines[-20:]
        assert all(json.loads(line.split(" pid=")[1].split(" ", 1)[1])["flash_fwd"] == 0
                   for line in counted)
        assert json.loads((tmp_path / ".tasksrunner/apps.json").read_text()) == {}
        assert not info_path(tmp_path / ".tasksrunner/apps.json").exists()
        assert NameResolver.local_pid_dead("127.0.0.1", replica["pid"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        for entry in _registered(tmp_path):  # replicas a failed run left behind
            if not NameResolver.local_pid_dead("127.0.0.1", entry["pid"]):
                os.kill(entry["pid"], signal.SIGKILL)
        proc.stdout.close()


def _registered(tmp_path: Path) -> list[dict]:
    path = tmp_path / ".tasksrunner/apps.json"
    try:
        return [e for entries in json.loads(path.read_text()).values() for e in entries]
    except (OSError, ValueError):
        return []


async def _cli(*argv: str) -> None:
    # in a thread: the command blocks on the admin API this loop serves
    await asyncio.to_thread(cli.main, list(argv))


async def _ready(orch: Orchestrator, n: int) -> list[int]:
    """Wait until the app has ``n`` replicas, each ready; their pids."""
    while True:
        group = orch.replicas[APP]
        if len(group) == n and all(r.ready.is_set() and r.proc.returncode is None
                                   for r in group):
            return [r.proc.pid for r in group]
        await asyncio.sleep(0.05)


async def test_admin_verbs_fencing_and_adoption(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TASKSRUNNER_REPL_LEASE_SECONDS", "0.5")
    registry = str(tmp_path / "apps.json")

    def config(**kw) -> RunConfig:
        return RunConfig(apps=[AppSpec(
            app_id=APP, module=SCORER, env={"TASKSRUNNER_ML_BUCKETS": "1"},
            scale=ScaleSpec(min_replicas=1, max_replicas=2),
            health=HealthSpec(interval_seconds=0.5, initial_delay_seconds=0.5))],
            registry_file=registry, base_dir=tmp_path, **kw)

    async def drive() -> None:
        first = Orchestrator(config(), device="cpu")
        successor = None
        try:
            await first.start()
            [pid] = await _ready(first, 1)
            verbs = ["--registry-file", registry]
            await _cli("scale", APP, "--min-replicas", "2", *verbs)
            await _ready(first, 2)
            await _cli("update", APP, "--set-env", "MARK=1", *verbs)  # rolling restart
            pids = await _ready(first, 2)
            assert pid not in pids
            await _cli("scale", APP, "--min-replicas", "1", "--max-replicas", "1", *verbs)
            [pid] = await _ready(first, 1)
            await _cli("restart", APP, *verbs)
            [restarted] = await _ready(first, 1)
            assert restarted != pid
            capsys.readouterr()
            await _cli("logs", APP, "--tail", "3", *verbs)
            await _cli("revisions", APP, *verbs)
            out = capsys.readouterr().out.splitlines()
            assert any(line.startswith(f"[{APP}·0] ") for line in out[:3]), out
            # REV, CREATED (date and time), ACTIVE, then the reason from column 34
            assert [line[34:].split("  ")[0] for line in out[4:]] == [
                "initial deploy", "scale update", "env update", "scale update",
                "manual restart"], out
            await _cli("ps", "--json", *verbs)
            [row] = json.loads(capsys.readouterr().out)
            assert (row["app_id"], row["pid"], row["health"]) == (APP, restarted, "ok")
            port = int(json.loads(info_path(registry).read_text())["admin_url"].rsplit(":", 1)[1])
            status, _, body = await http_request("127.0.0.1", port, "GET",
                                                 f"/admin/apps/{APP}/metrics")
            merged = json.loads(body)
            assert status == 200 and merged["replicas"] == 1
            assert "sidecar_request_latency_seconds" in {r["name"] for r in merged["percentiles"]}
            status = first.status()["apps"][0]
            assert status["env_keys"] == ["MARK", "TASKSRUNNER_ML_BUCKETS"]
            assert status["revision"] == 5 and status["scale"] == {"min": 1, "max": 1}
            with pytest.raises(SystemExit, match="orchestrator returned 400: min_replicas 2 "
                                                 "exceeds max_replicas 1"):
                await _cli("scale", APP, "--min-replicas", "2", *verbs)
            with pytest.raises(SystemExit, match="returned 404: unknown app 'nope'"):
                await _cli("revisions", "nope", *verbs)
            status, _, body = await http_request("127.0.0.1", port, "GET", "/admin/traces/abc")
            assert (status, json.loads(body)) == (
                200, {"trace_id": "abc", "replicas": 1, "spans": []})
            # the actor gate is off: the replica's sidecar has no /v1.0/actors
            status, _, body = await http_request("127.0.0.1", port, "GET", "/admin/actors")
            assert (status, json.loads(body)) == (200, {"placement": [], "replicas": []})
            # TASKSRUNNER_RESHARD off: one sweep for the request, over a
            # replica whose app has no sharded store
            status, _, body = await http_request("127.0.0.1", port, "GET", "/admin/placement")
            doc = json.loads(body)
            assert status == 200 and doc["reshard"] is False and list(doc["apps"]) == [APP]
            assert doc["apps"][APP]["stores"] == {} and doc["apps"][APP]["last_sweep"] > 0
            capsys.readouterr()
            await _cli("shards", *verbs)
            assert capsys.readouterr().out.splitlines() == [
                "NOTE: TASKSRUNNER_RESHARD is off — this is a one-shot sweep, not a live "
                "control loop",
                "no sharded stores reporting placement (stores with shards > 1 publish it "
                "via sidecar metadata)"]

            # a second orchestrator on this registry is fenced out
            with pytest.raises(SystemExit, match="--standby"):
                await Orchestrator(config(), device="cpu").start()
            # the first walks away as a killed one would; a standby adopts
            await first.abandon()
            assert not NameResolver.local_pid_dead("127.0.0.1", restarted)
            successor = Orchestrator(config(standby=True), device="cpu")
            await successor.start()
            adopted = successor.replicas[APP]
            assert [r.proc.pid for r in adopted] == [restarted] and adopted[0].restarts == 0
            assert "adopted 1 running replica(s)" in successor.revisions[APP][0]["reason"]
            # stopped by hand, the adopted replica is noticed and respawned
            await _cli("stop", APP, *verbs)
            with pytest.raises(SystemExit, match="'nope' is not registered"):
                await _cli("stop", "nope", *verbs)
            while adopted[0].restarts == 0:
                await asyncio.sleep(0.05)
            [restarted] = await _ready(successor, 1)  # a child of the successor now
        finally:
            if successor is not None:
                await successor.stop()
            await first.stop()
        assert NameResolver.local_pid_dead("127.0.0.1", restarted)
        assert json.loads(Path(registry).read_text()) == {}

    await asyncio.wait_for(drive(), LIMIT_S)
