"""The port's orchestrator against the JAX package's, in one process with
no replica processes: run files read into equal ``RunConfig`` s (and the
same errors), the parts the port refuses, the backlog read from a broker
file the JAX broker wrote, every scale rule's verdicts and the
controller's step sequence over the same signals and clock, the
control-plane lease records fencing each other across the two packages,
the status document's shape, the merges of replicas' metrics, per-app
tokens, and the admin client's healing of a torn info file.
(``tests/test_torch_orchestrator_procs.py`` runs replica processes.)"""

import asyncio
import dataclasses
import importlib
import json
import pathlib
import sqlite3
import textwrap
import time

import pytest

from tasksrunner.bindings.localqueue import SqliteQueue as JaxQueue
from tasksrunner.component.spec import parse_component as jax_parse_component
from tasksrunner.errors import ComponentError as JaxComponentError
from tasksrunner.orchestrator import autoscale as jax_autoscale
from tasksrunner.orchestrator import config as jax_config
from tasksrunner.orchestrator import run as jax_run
from tasksrunner.pubsub.sqlite import SqliteBroker as JaxBroker
from tasksrunner.state.replication import Lease as JaxLease
from tasksrunner.state.sqlite import SqliteStateStore as JaxStore
from tasksrunner_torch import cli, security
from tasksrunner_torch import metrics as port_metrics_mod
from tasksrunner_torch.app import Response, start_server
from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER, http_request
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import parse_component
from tasksrunner_torch.errors import ComponentError
from tasksrunner_torch.orchestrator import autoscale as port_autoscale
from tasksrunner_torch.orchestrator import config as port_config
from tasksrunner_torch.orchestrator import run as port_run
from tasksrunner_torch.orchestrator.admin import info_path
from tasksrunner_torch.pubsub.sqlite import open_for_inspection
from tasksrunner_torch.runtime import Runtime
from tasksrunner_torch.sidecar import Sidecar
from tasksrunner_torch.state.lease import Lease
from tasksrunner_torch.state.sqlite import SqliteStateStore

# the module, not the registry of the same name the package exports
jax_metrics_mod = importlib.import_module("tasksrunner.observability.metrics")
REPO = pathlib.Path(__file__).resolve().parent.parent
TOPIC, GROUP = "tasksavedtopic", "worker"
PACKAGES = {"jax": (jax_config, jax_autoscale), "port": (port_config, port_autoscale)}


def bounded(aw, seconds: float = 20):
    return asyncio.wait_for(aw, seconds)


# -- run files -----------------------------------------------------------------

RUN_FILES = {
    # tests/test_orchestrator.py's run files, then the other fields
    "two_apps": """
        resources_path: ./components
        apps:
          - app_id: api
            module: pkg.mod:make_app
            app_port: 5103
            sidecar_port: 3500
            env: { A: "1" }
          - app_id: worker
            module: pkg.worker:make_app
            scale:
              min_replicas: 2
              max_replicas: 5
              rules:
                - type: pubsub-backlog
                  metadata: { component: ps, topic: t, messageCount: 10 }
    """,
    "health_variants": """
        apps:
          - app_id: a
            module: m:make_app
            health: true
          - app_id: b
            module: m:make_app
            health: false
          - app_id: c
            module: m:make_app
            health:
          - app_id: d
            module: m:make_app
            health:
              interval_seconds: 0.5
              failure_threshold: 7
    """,
    "every_field": """
        base_dir: ./deploy
        resources_path: components
        registry_file: state/apps.json
        admin_port: 4999
        require_api_token: true
        per_app_tokens: true
        adopt: false
        standby: true
        apps:
          - app_id: priority-scorer
            module: tasksrunner_torch.service:make_app
            host: 0.0.0.0
            env:
              TASKSRUNNER_ML_BUCKETS: "1,8"
              N: 3
            grants:
              scores: [read, write]
              taskspubsub:
                - subscribe: [tasksavedtopic]
            scale:
              min_replicas: 1
              max_replicas: 3
              cooldown_seconds: 2.5
              rules:
                - type: http-concurrency
                  metadata: { concurrentRequests: 4 }
                - type: cpu
                  metadata: { utilization: 60 }
                - type: memory
                  metadata: { megabytes: 512 }
                - type: target-p99
                  metadata: { metric: m, targetSeconds: 0.25, minSamples: 5 }
                - type: loop-lag
                  metadata: { maxLagSeconds: 0.1 }
    """,
    "absolute_paths": """
        base_dir: /srv/tasks
        resources_path: /etc/components
        registry_file: /var/run/apps.json
        apps:
          - app_id: x
            module: m:f
    """,
}

BAD_RUN_FILES = {
    "no_apps": "apps: []",
    "empty": "",
    "no_module": "apps:\n  - app_id: a\n",
    "unknown_rule": "apps:\n  - app_id: a\n    module: m:f\n    scale:\n      rules:\n"
                    "        - type: kafka-lag\n",
    "bad_health_value": "apps:\n  - app_id: a\n    module: m:f\n    health:\n"
                        "      interval_seconds: soon\n",
    "health_a_list": "apps:\n  - app_id: a\n    module: m:f\n    health: [1]\n",
    "bad_grant": "apps:\n  - app_id: a\n    module: m:f\n    grants:\n      kv: [drop]\n",
}


def _as_dict(config) -> dict:
    doc = dataclasses.asdict(config)
    doc["registry_path"] = str(config.registry_path)
    doc["base_dir"] = str(doc["base_dir"])
    return doc


@pytest.mark.parametrize("name", sorted(RUN_FILES))
def test_a_run_file_reads_into_the_jax_run_config(tmp_path, name):
    path = tmp_path / "run.yaml"
    path.write_text(textwrap.dedent(RUN_FILES[name]))
    assert _as_dict(port_config.load_run_config(path)) == _as_dict(
        jax_config.load_run_config(path))


def test_the_repos_run_yaml_reads_into_the_jax_run_config():
    got = port_config.load_run_config(REPO / "run.yaml")
    assert _as_dict(got) == _as_dict(jax_config.load_run_config(REPO / "run.yaml"))
    assert got.apps[2].scale.rules[0].metadata["messageCount"] == "10"


@pytest.mark.parametrize("name", sorted(BAD_RUN_FILES))
def test_a_bad_run_file_is_refused_with_the_jax_error(tmp_path, name):
    path = tmp_path / "run.yaml"
    path.write_text(BAD_RUN_FILES[name])
    with pytest.raises(JaxComponentError) as jax_error:
        jax_config.load_run_config(path)
    with pytest.raises(ComponentError) as port_error:
        port_config.load_run_config(path)
    assert str(port_error.value) == str(jax_error.value)


def test_a_missing_run_file_is_a_component_error(tmp_path):
    with pytest.raises(ComponentError, match="cannot read run config"):
        port_config.load_run_config(tmp_path / "none.yaml")


@pytest.mark.parametrize("text, item", [
    ("mesh_tls: true\napps:\n  - app_id: a\n    module: m:f\n", "A22"),
])
def test_what_the_port_lacks_is_refused_not_ignored(tmp_path, text, item):
    path = tmp_path / "run.yaml"
    path.write_text(text)
    jax_config.load_run_config(path)  # the reference reads it
    with pytest.raises(ComponentError, match=rf"not ported yet \(ROADMAP {item}\)"):
        port_config.load_run_config(path)


def test_the_orchestrator_refuses_mesh_tls_reshard_and_queue_backlog(tmp_path, monkeypatch):
    config = port_config.RunConfig(apps=[], registry_file=str(tmp_path / "apps.json"),
                                   base_dir=tmp_path, mesh_tls=True)
    with pytest.raises(ComponentError, match=r"mesh_tls is not ported yet \(ROADMAP A22\)"):
        port_run.Orchestrator(config)
    config.mesh_tls = False
    # the placement loop is ported: with no app there is nothing to sweep
    monkeypatch.setenv("TASKSRUNNER_RESHARD", "1")

    async def reshard() -> None:
        orch = port_run.Orchestrator(config)
        await orch.start()
        try:
            assert orch.placement == {}
        finally:
            await orch.stop()

    asyncio.run(reshard())
    assert (tmp_path / "control-plane.db").exists()
    # a queue-backlog rule is read now, and refused as in JAX where its
    # component is missing
    for cfg, mod in PACKAGES.values():
        with pytest.raises((ComponentError, JaxComponentError), match="unknown component 'q'"):
            mod.read_backlog(cfg.ScaleRule("queue-backlog", {"component": "q"}), app_id="a",
                             components=[], base_dir=tmp_path)


def test_run_needs_a_card_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    import torch

    path = tmp_path / "run.yaml"
    path.write_text("apps:\n  - app_id: a\n    module: m:f\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        cli.main(["run", str(path)])
    # an admin verb is a client of the orchestrator: it needs no card
    with pytest.raises(SystemExit, match="no orchestrator control file"):
        cli.main(["revisions", "a", "--registry-file", str(tmp_path / "apps.json")])


# -- the backlog ---------------------------------------------------------------

def _broker_specs(path) -> dict:
    doc = {"componentType": "pubsub.sqlite", "metadata": [{"name": "brokerPath",
                                                          "value": str(path)}]}
    return {"jax": [jax_parse_component(doc, default_name="ps")],
            "port": [parse_component(doc, default_name="ps")]}


def _set_backlog(path, n: int) -> None:
    """Settle deliveries (or reopen settled ones) until ``n`` are pending."""
    with sqlite3.connect(path) as conn:
        conn.execute("UPDATE deliveries SET done = 1")
        conn.execute("UPDATE deliveries SET done = 0 WHERE rowid IN "
                     "(SELECT rowid FROM deliveries ORDER BY rowid LIMIT ?)", (n,))


async def test_the_backlog_of_a_broker_file_the_jax_broker_wrote(tmp_path):
    path = tmp_path / "b.db"
    broker = JaxBroker("ps", path)
    await broker.ensure_group(TOPIC, GROUP)
    for i in range(25):
        await broker.publish(TOPIC, {"i": i})
    await broker.aclose()
    specs = _broker_specs(path)
    for meta, want in (({"component": "ps", "topic": TOPIC, "group": GROUP}, 25),
                       ({"component": "ps", "topic": TOPIC}, 25),  # the group: the app id
                       ({"component": "ps", "topic": "other"}, 0)):
        got = {name: mod.read_backlog(cfg.ScaleRule("pubsub-backlog", meta), app_id=GROUP,
                                      components=specs[name], base_dir=tmp_path)
               for name, (cfg, mod) in PACKAGES.items()}
        assert got == {"jax": want, "port": want}
    _set_backlog(path, 7)
    rule = port_config.ScaleRule("pubsub-backlog", {"component": "ps", "topic": TOPIC})
    assert port_autoscale.read_backlog(rule, app_id=GROUP, components=specs["port"],
                                       base_dir=tmp_path) == 7
    # nothing published yet is a backlog of 0, a relative path resolves
    # against the run file's directory
    rel = _broker_specs("rel/none.db")
    for name, (cfg, mod) in PACKAGES.items():
        assert mod.read_backlog(cfg.ScaleRule("pubsub-backlog", {"component": "ps"}),
                                app_id="a", components=rel[name], base_dir=tmp_path) == 0
    with pytest.raises(ComponentError, match="unknown component 'nope'"):
        port_autoscale.read_backlog(port_config.ScaleRule("pubsub-backlog", {"component": "nope"}),
                                    app_id="a", components=[], base_dir=tmp_path)


def _queue_specs(root) -> dict:
    doc = {"componentType": "bindings.azure.storagequeues",
           "metadata": [{"name": "queuePath", "value": str(root)},
                        {"name": "queueName", "value": "external-tasks-queue"}]}
    return {"jax": [jax_parse_component(doc, default_name="q")],
            "port": [parse_component(doc, default_name="q")]}


def _set_queue_backlog(path, n: int) -> None:
    """Ack messages (or reopen acked ones) until ``n`` are waiting."""
    with sqlite3.connect(path) as conn:
        conn.execute("UPDATE queue SET done = 1")
        conn.execute("UPDATE queue SET done = 0 WHERE rowid IN "
                     "(SELECT rowid FROM queue ORDER BY rowid LIMIT ?)", (n,))


def test_a_queue_backlog_rule_reads_the_queue_file_the_jax_queue_wrote(tmp_path):
    path = tmp_path / "queues" / "external-tasks-queue.db"
    queue = JaxQueue(path)
    ids = [queue.send({"i": i}) for i in range(12)]
    queue.ack(ids[0])
    queue.dead_letter(ids[1])
    queue.claim()  # a claimed message is still backlog
    queue.close()
    specs = _queue_specs(tmp_path / "queues")
    got = {name: mod.read_backlog(cfg.ScaleRule("queue-backlog", {"component": "q"}),
                                  app_id="a", components=specs[name], base_dir=tmp_path)
           for name, (cfg, mod) in PACKAGES.items()}
    assert got == {"jax": 10, "port": 10}
    # nothing sent yet is a backlog of 0; a relative queuePath resolves
    # against the run file's directory
    rel = _queue_specs("rel/queues")
    for name, (cfg, mod) in PACKAGES.items():
        assert mod.read_backlog(cfg.ScaleRule("queue-backlog", {"component": "q"}), app_id="a",
                                components=rel[name], base_dir=tmp_path) == 0
    assert (tmp_path / "rel" / "queues" / "external-tasks-queue.db").is_file()
    # a run file with the rule is read into the JAX run config
    run = tmp_path / "run.yaml"
    run.write_text("apps:\n  - app_id: a\n    module: m:f\n    scale:\n      rules:\n"
                   "        - type: queue-backlog\n          metadata: { component: q, "
                   "messageCount: \"5\" }\n")
    want, have = jax_config.load_run_config(run), port_config.load_run_config(run)
    assert dataclasses.asdict(have.apps[0].scale) == dataclasses.asdict(want.apps[0].scale)


@pytest.mark.parametrize("doc, must_exist", [
    ({"componentType": "state.sqlite"}, False),
    ({"componentType": "pubsub.redis", "metadata": [{"name": "redisHost", "value": "r:6379"}]},
     False),
    ({"componentType": "pubsub.sqlite"}, True),  # the default file does not exist
])
def test_open_for_inspection_refuses_what_the_jax_one_refuses(tmp_path, doc, must_exist):
    with pytest.raises(JaxComponentError):
        from tasksrunner.pubsub.sqlite import open_for_inspection as jax_open
        jax_open(jax_parse_component(doc, default_name="c"), tmp_path, must_exist=must_exist)
    with pytest.raises(ComponentError):
        open_for_inspection(parse_component(doc, default_name="c"), tmp_path,
                            must_exist=must_exist)


# -- the scale rules and the controller ----------------------------------------

class FakeClock:
    now = 1000.0

    @classmethod
    def monotonic(cls) -> float:
        return cls.now


class Replicas:
    """Two fake replicas, each one HTTP server answering its app's
    ``/tasksrunner/stats`` and its sidecar's ``/v1.0/metadata`` with
    what the script sets."""

    def __init__(self) -> None:
        self.stats = [{"inflight": 0, "requests_total": 0} for _ in range(2)]
        self.docs = [{} for _ in range(2)]
        self.servers = []
        self.info: list[dict] = []

    async def start(self) -> None:
        for i in range(2):
            async def handle(method, target, headers, body, i=i):
                if target == "/tasksrunner/stats":
                    return Response(200, self.stats[i])
                return Response(200, self.docs[i])
            server = await start_server(handle, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            self.servers.append(server)
            self.info.append({"pid": 1001 + i, "app_port": port, "sidecar_port": port,
                              "host": "127.0.0.1"})

    async def stop(self) -> None:
        for server in self.servers:
            server.close()
            await server.wait_closed()


def _hist(counts, metric="sidecar_request_latency_seconds"):
    return {"histograms": {metric: {"bounds": [0.1, 0.5, 1.0], "series": [
        {"labels": {"route": "invoke"}, "counts": list(counts), "sum": 0.0,
         "count": sum(counts)}]}}}


def _lag(seconds):
    return {"metrics": {"event_loop_lag_seconds": seconds, "other": 9.0}}


# per rule: its metadata and, per evaluation, what the signals read; the
# desired counts run up, down, up again (the cooldown's reset), then down
# for good, so each script covers scale-out, cooldown, reset and scale-in
SCRIPTS = {
    "pubsub-backlog": ({"component": "ps", "topic": TOPIC, "messageCount": "10"},
                       [0, 25, 3, 28, 0, 1, 0, 0, 0]),
    "http-concurrency": ({"concurrentRequests": "4"},
                         [(0, 0), (5, 4), (2, 0), (9, 1), (0, 0), (1, 0), (0, 0), (0, 0), (0, 0)]),
    "cpu": ({"utilization": "50"},  # ticks added per replica between polls (1 s apart)
            [(0, 0), (70, 50), (10, 5), (80, 60), (0, 0), (20, 0), (0, 0), (0, 0), (0, 0)]),
    "memory": ({"megabytes": "100"},
               [(50, 40), (250, 260), (60, 30), (300, 10), (20, 20), (90, 90), (30, 30),
                (10, 10), (10, 10)]),
    "target-p99": ({"targetSeconds": "0.25", "minSamples": "5"},
                   [((0, 0, 0, 0), (0, 0, 0, 0)), ((0, 0, 10, 0), (0, 0, 5, 0)),
                    ((0, 0, 10, 0), (0, 0, 5, 0)), ((1, 0, 30, 2), (0, 0, 9, 0)),
                    ((40, 0, 30, 2), (20, 0, 9, 0)), ((40, 0, 30, 2), (20, 0, 9, 0)),
                    ((1, 0, 0, 0), (0, 0, 0, 0)), ((50, 0, 0, 0), (0, 0, 0, 0)),
                    ((50, 0, 0, 0), (0, 0, 0, 0))]),
    "queue-backlog": ({"component": "q", "messageCount": "10"},
                      [0, 25, 3, 28, 0, 1, 0, 0, 0]),
    "loop-lag": ({"maxLagSeconds": "0.5"},
                 [(0.0, 0.0), (0.9, 0.1), (0.2, 0.1), (0.1, 0.7), (0.0, 0.0), (0.3, 0.2),
                  (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)]),
}


def _controller(name: str, rule_type: str, meta: dict, components, replicas, calls, tmp_path):
    cfg, mod = PACKAGES[name]
    app = cfg.AppSpec(app_id=f"scaled-{rule_type}", module="m:f", scale=cfg.ScaleSpec(
        min_replicas=1, max_replicas=5, cooldown_seconds=2.0,
        rules=[cfg.ScaleRule(rule_type, dict(meta))]))
    return mod.AutoscaleController(app, components, calls.append, base_dir=tmp_path,
                                   replica_info=lambda: replicas.info)


@pytest.mark.parametrize("rule_type", sorted(SCRIPTS))
async def test_each_rule_scales_as_the_jax_controller_does(tmp_path, monkeypatch, rule_type):
    meta, script = SCRIPTS[rule_type]
    ticks, rss = {}, {}
    for _, mod in PACKAGES.values():
        monkeypatch.setattr(mod, "time", FakeClock)
        monkeypatch.setattr(mod, "_read_proc_cpu_ticks", lambda pid: ticks.get(pid))
        monkeypatch.setattr(mod, "_read_proc_rss_mb", lambda pid: rss.get(pid, 0.0))
    path = tmp_path / "b.db"
    broker = JaxBroker("ps", path)
    await broker.ensure_group(TOPIC, f"scaled-{rule_type}")
    for i in range(30):
        await broker.publish(TOPIC, {"i": i})
    await broker.aclose()
    queue = JaxQueue(tmp_path / "queues" / "external-tasks-queue.db")
    for i in range(30):
        queue.send({"i": i})
    queue.close()
    specs = {name: _broker_specs(path)[name] + _queue_specs(tmp_path / "queues")[name]
             for name in PACKAGES}
    replicas = Replicas()
    await replicas.start()
    calls = {"jax": [], "port": []}
    ctrls = {name: _controller(name, rule_type, meta, specs[name], replicas, calls[name],
                               tmp_path) for name in PACKAGES}
    gauges = {"jax": jax_metrics_mod.metrics, "port": port_metrics_mod.metrics}
    seen = {"jax": [], "port": []}
    try:
        for signal_value in script:
            if rule_type == "pubsub-backlog":
                _set_backlog(path, signal_value)
            elif rule_type == "queue-backlog":
                _set_queue_backlog(tmp_path / "queues" / "external-tasks-queue.db", signal_value)
            elif rule_type == "http-concurrency":
                for stats, n in zip(replicas.stats, signal_value):
                    stats["inflight"] = n
            elif rule_type == "cpu":
                for info, n in zip(replicas.info, signal_value):
                    ticks[info["pid"]] = ticks.get(info["pid"], 0) + n
            elif rule_type == "memory":
                rss.update({info["pid"]: mb for info, mb in zip(replicas.info, signal_value)})
            elif rule_type == "target-p99":
                replicas.docs = [_hist(counts) for counts in signal_value]
            else:
                replicas.docs = [_lag(lag) for lag in signal_value]
            for name, ctrl in ctrls.items():
                current = await bounded(ctrl.step())
                desired = gauges[name].get("autoscale_desired_replicas", app=ctrl.app.app_id)
                seen[name].append((desired, current, list(calls[name])))
            FakeClock.now += 1.0
    finally:
        await replicas.stop()
    assert seen["port"] == seen["jax"]
    desired = [d for d, _, _ in seen["port"]]
    assert max(desired) > 1 and desired[-1] == 1, desired  # out, then in again
    assert calls["port"][-1] == 1 and len(calls["port"]) >= 2


async def test_a_failing_rule_is_skipped_and_a_blackout_holds(tmp_path):
    replicas = Replicas()
    await replicas.start()
    replicas.docs = [_lag(2.0), _lag(0.0)]
    out = {}
    try:
        for name, (cfg, mod) in PACKAGES.items():
            bad = cfg.ScaleRule("pubsub-backlog", {"component": "no-such-broker", "topic": "t"})
            lag = cfg.ScaleRule("loop-lag", {"maxLagSeconds": "0.5"})
            app = cfg.AppSpec(app_id="w-isolation", module="x:y", scale=cfg.ScaleSpec(
                min_replicas=1, max_replicas=5, rules=[bad, lag]))
            ctrl = mod.AutoscaleController(app, [], lambda n: None, base_dir=tmp_path,
                                           replica_info=lambda: replicas.info)
            first = await asyncio.to_thread(ctrl.desired_replicas)
            app.scale.rules = [bad]  # every rule failing: hold the count
            ctrl.current = 3
            out[name] = (first, await asyncio.to_thread(ctrl.desired_replicas))
    finally:
        await replicas.stop()
    assert out["port"] == out["jax"] == (2, 3)
    assert port_metrics_mod.metrics.get("autoscale_desired_replicas", app="w-isolation") == 3.0


def test_the_cpu_and_memory_rules_read_this_process():
    import os

    rss = port_autoscale._read_proc_rss_mb(os.getpid())
    assert rss == pytest.approx(jax_autoscale._read_proc_rss_mb(os.getpid()), rel=0.2)
    assert rss > 10
    assert port_autoscale._read_proc_cpu_ticks(os.getpid()) >= 0
    assert port_autoscale._read_proc_cpu_ticks(2 ** 30) is None


# -- the control-plane lease ---------------------------------------------------

async def test_lease_records_of_either_package_fence_the_other(tmp_path):
    path = tmp_path / "control-plane.db"
    jax_store = JaxStore("orchestrator.control-plane", path)
    port_store = SqliteStateStore("orchestrator.control-plane", path)
    try:
        jax_lease = JaxLease(jax_store, "control-plane", lease_seconds=30)
        port_lease = Lease(port_store, "control-plane", lease_seconds=30)
        assert await bounded(jax_lease.acquire("jax-orch")) == 1
        record = await bounded(port_lease.peek())
        assert set(record) == {"owner", "epoch", "expires", "host", "pid", "registered_at"}
        # a live JAX holder fences the port
        assert await bounded(port_lease.acquire("port-orch")) is None
        assert await bounded(port_lease.renew("port-orch")) is False
        await bounded(jax_lease.release("jax-orch"))
        # released: the port takes over and the epoch moves on
        assert await bounded(port_lease.acquire("port-orch")) == 2
        assert set(await bounded(jax_lease.peek())) == set(record)
        assert await bounded(jax_lease.acquire("jax-orch")) is None
        assert await bounded(port_lease.renew("port-orch")) is True
        assert await bounded(port_lease.acquire("port-orch")) == 2  # a renewal keeps it
        await bounded(port_lease.release("jax-orch"))  # not the holder: nothing
        assert (await bounded(jax_lease.peek()))["owner"] == "port-orch"
        await bounded(port_lease.release("port-orch"))
        assert await bounded(jax_lease.acquire("jax-orch")) == 3
        # an expired holder is taken over without a release
        short = Lease(port_store, "other", lease_seconds=0.05)
        assert await bounded(short.acquire("gone")) == 1
        await asyncio.sleep(0.1)
        assert await bounded(JaxLease(jax_store, "other").acquire("next")) == 2
    finally:
        await jax_store.aclose()
        port_store.close()


async def test_a_second_orchestrator_on_one_registry_is_refused(tmp_path):
    registry = str(tmp_path / "apps.json")
    first = port_run.Orchestrator(port_config.RunConfig(apps=[], registry_file=registry,
                                                        base_dir=tmp_path))
    await bounded(first.start())
    try:
        # fenced by the port's lease and by a JAX orchestrator's alike
        for orch in (port_run.Orchestrator(port_config.RunConfig(
                         apps=[], registry_file=registry, base_dir=tmp_path)),
                     jax_run.Orchestrator(jax_config.RunConfig(
                         apps=[], registry_file=registry, base_dir=tmp_path))):
            with pytest.raises(SystemExit, match="--standby"):
                await bounded(orch.start())
        info = json.loads(info_path(registry).read_text())
        assert info["pid"] > 0 and info["admin_url"].startswith("http://127.0.0.1:")
    finally:
        await bounded(first.stop())
    assert not info_path(registry).exists()


# -- the status document -------------------------------------------------------

def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_keys(v) for v in doc]
    return type(doc).__name__


async def test_status_revisions_replica_info_and_logs_have_the_jax_shape(tmp_path):
    out = {}
    for name, (cfg, _) in PACKAGES.items():
        run_mod = jax_run if name == "jax" else port_run
        config = cfg.RunConfig(
            apps=[cfg.AppSpec(app_id="priority-scorer", module="m:f", env={"B": "1", "A": "2"},
                              scale=cfg.ScaleSpec(min_replicas=1, max_replicas=3))],
            registry_file=str(tmp_path / name / "apps.json"), base_dir=tmp_path)
        orch = run_mod.Orchestrator(config)
        orch.replicas["priority-scorer"] = []
        for i in range(2):
            replica = run_mod.Replica(config.apps[0], i, config)
            replica.ports = (5000 + i, 6000 + i) if i == 0 else None
            replica.started_at = time.time() - 10
            replica.restarts = i
            replica.log_buffer.extend([f"line {i}.{n}" for n in range(3)])
            orch.replicas["priority-scorer"].append(replica)
        orch._record_revision("priority-scorer", "initial deploy")
        entry = orch._record_revision("priority-scorer", "scale update", min_replicas=1,
                                      max_replicas=3)
        status = orch.status()
        for replica in status["apps"][0]["replicas"]:
            assert 9.0 <= replica.pop("uptime_seconds") <= 60.0
        out[name] = {
            "status": status, "entry": {k: v for k, v in entry.items() if k != "created"},
            "revisions": [sorted(r) for r in orch.revisions["priority-scorer"]],
            "info": orch._replica_info("priority-scorer"),
            "logs": orch.app_logs("priority-scorer", tail=2, replica=1),
            "count": orch.replica_count("priority-scorer"),
            "tag": orch.replicas["priority-scorer"][1].tag}
    assert out["port"] == out["jax"]
    assert out["port"]["status"]["apps"][0]["env_keys"] == ["A", "B"]


def test_the_replica_command_is_the_ports_host(tmp_path):
    config = port_config.RunConfig(
        apps=[port_config.AppSpec(app_id="s", module="tasksrunner_torch.service:make_app",
                                  app_port=5217, sidecar_port=3502)],
        resources_path=str(tmp_path / "components"), base_dir=tmp_path)
    jax_cmd = jax_run.Replica(jax_config.AppSpec(app_id="s", module="m:f", app_port=5217,
                                                 sidecar_port=3502), 0, config)._command()
    first = port_run.Replica(config.apps[0], 0, config)._command()
    assert first[1:4] == ["-m", "tasksrunner_torch", "host"]
    assert first[4:] == ["tasksrunner_torch.service:make_app"] + jax_cmd[5:]
    scaled = port_run.Replica(config.apps[0], 1, config, device="cpu")._command()
    assert scaled[-6:] == ["--app-port", "0", "--sidecar-port", "0", "--device", "cpu"]


# -- metrics merges, tokens, the admin client ----------------------------------

def _observe_both(values_by_route: dict) -> dict:
    """The same observations into a fresh JAX and a fresh port registry."""
    jax_reg, port_reg = jax_metrics_mod.MetricsRegistry(), port_metrics_mod.MetricsRegistry()
    for route, values in values_by_route.items():
        for v in values:
            jax_reg.observe("lat", v, route=route)
            port_reg.observe("lat", v, route=route)
        jax_reg.inc("calls", len(values), route=route)
        port_reg.inc("calls", len(values), route=route)
        jax_reg.set_gauge("depth", float(len(values)), route=route)
        port_reg.set_gauge("depth", float(len(values)), route=route)
    return {"jax": jax_reg, "port": port_reg}


def test_replica_metrics_merge_as_the_jax_merges_do():
    a = _observe_both({"score": [0.001, 0.02, 0.3], "save": [0.004]})
    b = _observe_both({"score": [0.05, 2.0], "publish": [0.0002, 0.0002]})
    merged = {}
    # the flat snapshots differ in their histogram keys: both merge the JAX ones
    flat = [r["jax"].snapshot() for r in (a, b)]
    for name, mod in (("jax", jax_metrics_mod), ("port", port_metrics_mod)):
        hists = mod.merge_histogram_snapshots([a[name].snapshot_histograms(),
                                               b[name].snapshot_histograms()])
        for hist in hists.values():
            for series in hist["series"]:
                series.pop("max", None)
        merged[name] = (hists, mod.summarize_histograms(hists),
                        mod.merge_flat_snapshots(flat, a["jax"].snapshot_kinds()))
    assert merged["port"] == merged["jax"]
    flat = port_metrics_mod.merge_flat_snapshots([r["port"].snapshot() for r in (a, b)],
                                                 a["port"].snapshot_kinds())
    assert flat["depth{route=score}"] == 3.0  # a gauge: the larger
    assert flat["calls{route=score}"] == 5.0  # a counter: the sum
    assert flat["lat_count{route=score}"] == 5 and flat["lat_max{route=score}"] == 2.0
    # the port keeps each series' largest value through a merge
    port = port_metrics_mod.merge_histogram_snapshots(
        [a["port"].snapshot_histograms(), b["port"].snapshot_histograms()])
    assert [s["max"] for s in port["lat"]["series"]] == [0.0002, 0.004, 2.0]


def test_per_app_tokens_hash_and_load_as_the_jax_ones(tmp_path):
    from tasksrunner import security as jax_security

    assert security.hash_token("s3cret") == jax_security.hash_token("s3cret")
    path = tmp_path / "tokens.json"
    path.write_text(json.dumps({"a": security.hash_token("x"), "b": 7}))
    assert security.load_token_map(path) == jax_security.load_token_map(path)
    assert security.load_token_map(None) == {}
    path.write_text("[1]")
    with pytest.raises(ComponentError, match="must be a JSON object"):
        security.load_token_map(path)
    grants = {"scores": ["read", "write"], "taskspubsub": [{"subscribe": ["t"]}]}
    assert (security.AppGrants.parse(grants).to_json()
            == jax_security.AppGrants.parse(grants).to_json())


async def test_a_peer_token_opens_the_invoke_route_and_nothing_else(monkeypatch):
    monkeypatch.setenv(TOKEN_ENV, "own-token")
    runtime = Runtime("target", ComponentRegistry([parse_component(
        {"componentType": "state.in-memory"}, default_name="kv")], app_id="target"))
    sidecar = Sidecar(runtime, port=0, peer_tokens={security.hash_token("peer-token")})
    await bounded(sidecar.start())
    try:
        async def call(method, path, token):
            return (await bounded(http_request("127.0.0.1", sidecar.port, method, path,
                                               headers={TOKEN_HEADER: token},
                                               body=b"[]")))[0]
        invoke = "/v1.0/invoke/nobody/method/x"
        # past the token check: the target is not registered
        assert await call("POST", invoke, "peer-token") == 404
        assert await call("POST", invoke, "own-token") == 404
        assert await call("POST", invoke, "stolen") == 401
        assert await call("POST", "/v1.0/state/kv", "peer-token") == 401
        assert await call("POST", "/v1.0/state/kv", "own-token") == 204
    finally:
        await bounded(sidecar.stop())


def test_the_admin_client_heals_a_torn_info_file(tmp_path):
    registry_file = str(tmp_path / "apps.json")
    info_file = info_path(registry_file)
    info_file.write_text('{"admin_url": truncated-mid-wri')
    with pytest.raises(SystemExit, match="unreadable"):
        cli._admin_request(registry_file, "GET", "/admin/apps")
    assert not info_file.exists()
    from tasksrunner.orchestrator.admin import info_path as jax_info_path
    assert info_path(registry_file) == jax_info_path(registry_file)


def test_per_app_tokens_reach_each_replica_as_the_jax_ones_do(tmp_path):
    configs = {}
    for name, (cfg, _) in PACKAGES.items():
        run_mod = jax_run if name == "jax" else port_run
        config = cfg.RunConfig(apps=[cfg.AppSpec(app_id=a, module="m:f") for a in ("a", "b")],
                               registry_file=str(tmp_path / name / "apps.json"),
                               base_dir=tmp_path, per_app_tokens=True)
        run_mod.Orchestrator(config)._issue_app_tokens()
        path = pathlib.Path(config.tokens_file)
        assert path.stat().st_mode & 0o777 == 0o600
        assert json.loads(path.read_text()) == {
            a: security.hash_token(t) for a, t in config.app_tokens.items()}
        configs[name] = config
    assert sorted(configs["port"].app_tokens) == sorted(configs["jax"].app_tokens)
    env = port_run.Replica(configs["port"].apps[1], 0, configs["port"])._env()
    assert env[TOKEN_ENV] == configs["port"].app_tokens["b"]
    assert env["TASKSRUNNER_TOKENS_FILE"] == configs["port"].tokens_file
    assert (env["TASKSRUNNER_APP_ID"], env["TASKSRUNNER_REPLICA"]) == ("b", "0")
