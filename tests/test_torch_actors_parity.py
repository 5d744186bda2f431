"""The port's virtual actors against the JAX package's, on the CPU in one
process: one script of turns, reminders (one-shot and periodic), a crash
with failover, a zombie's fenced commit and a double failover on each
package over its own sqlite file, compared result by result and key by
key (timestamps, pids, replica ids and etags left out); turns forwarded
over HTTP from either package's sidecar to an actor the other owns;
``locality_rank``; the actor routes' statuses and bodies, the ``actors``
verb and ``/admin/actors``; and a first activation over a replica set
with ``followerReads``, where the JAX runtime loses acknowledged turns to
a follower's stale read (ROADMAP C) and the port does not."""

import asyncio
import contextlib
import json
import re
import sqlite3
import threading
import time
import types

import pytest

from tasksrunner import cli as jax_cli
from tasksrunner.app import App as JaxApp
from tasksrunner.component.registry import ComponentRegistry as JaxRegistry
from tasksrunner.component.spec import ComponentSpec as JaxSpec
from tasksrunner.errors import TasksRunnerError as JaxError
from tasksrunner.orchestrator.admin import AdminServer as JaxAdminServer
from tasksrunner.runtime import InProcAppChannel as JaxChannel, Runtime as JaxRuntime
from tasksrunner.sidecar import Sidecar as JaxSidecar
from tasksrunner.state import sharding as jax_sharding
from tasksrunner.state.replication import build_replicated_store as jax_replicated

from tasksrunner_torch import cli
from tasksrunner_torch.app import App
from tasksrunner_torch.client import http_request
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import TasksRunnerError
from tasksrunner_torch.invoke.resolver import AppAddress, NameResolver
from tasksrunner_torch.orchestrator.admin import AdminServer
from tasksrunner_torch.runtime import InProcAppChannel, Runtime
from tasksrunner_torch.sidecar import Sidecar
from tasksrunner_torch.state import sharding
from tasksrunner_torch.state.replication import build_replicated_store

LEASE = 0.25
#: the script's lease: long enough that no owner's lapses between its own
#: turns on a loaded host (a lapse re-acquires, one epoch up)
SCRIPT_LEASE = 1.0
PACKAGES = {
    "jax": types.SimpleNamespace(App=JaxApp, Registry=JaxRegistry, Spec=JaxSpec,
                                 Runtime=JaxRuntime, Channel=JaxChannel, Sidecar=JaxSidecar,
                                 Error=JaxError, replicated=jax_replicated),
    "port": types.SimpleNamespace(App=App, Registry=ComponentRegistry, Spec=ComponentSpec,
                                  Runtime=Runtime, Channel=InProcAppChannel, Sidecar=Sidecar,
                                  Error=TasksRunnerError, replicated=build_replicated_store),
}
#: what differs between two runs whatever the package: times (and whether a
#: lease has run out yet), pids, replica ids
VOLATILE = frozenset({"ts", "created", "updated", "due", "lease_expires", "granted_at",
                      "owner", "registered_at", "pid", "replica", "lease_age",
                      "lease_expires_in", "alive", "sidecar_port"})


@pytest.fixture
def actor_env(monkeypatch, tmp_path):
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("TASKSRUNNER_ACTORS", "1")
    monkeypatch.setenv("TASKSRUNNER_ACTOR_LEASE_SECONDS", "5")
    monkeypatch.setenv("TASKSRUNNER_ACTOR_REMINDER_POLL_SECONDS", "30")


def counter_app(pkg):
    app = pkg.App("svc")

    @app.actor("Counter")
    async def counter(turn):
        if turn.is_reminder:
            turn.state["reminded"] = turn.state.get("reminded", 0) + 1
            turn.state.setdefault("fired_as", []).append(turn.method)
            return None
        turn.state["n"] = turn.state.get("n", 0) + 1
        if turn.data:
            turn.stage_effect(f"audit||{turn.actor_id}||{turn.state['n']}", turn.data)
        return turn.state["n"]

    return app


def runtime(pkg, db=None, *, store=None):
    if store is None:
        spec = pkg.Spec(name="statestore", type="state.sqlite",
                        metadata={"databasePath": str(db)})
        return pkg.Runtime("svc", pkg.Registry([spec], app_id="svc"),
                           app_channel=pkg.Channel(counter_app(pkg)))
    reg = pkg.Registry([pkg.Spec(name="statestore", type="state.in-memory")], app_id="svc")
    reg._instances["statestore"] = store
    return pkg.Runtime("svc", reg, app_channel=pkg.Channel(counter_app(pkg)))


def normal(value):
    """``value`` without the keys that differ between runs."""
    if isinstance(value, dict):
        return {k: normal(v) for k, v in value.items() if k not in VOLATILE}
    if isinstance(value, list):
        return [normal(v) for v in value]
    return value


def store_rows(db) -> dict:
    with contextlib.closing(sqlite3.connect(db)) as conn:
        return {k: normal(json.loads(v)) for k, v in conn.execute("SELECT key, value FROM state")}


async def stop_all(*rts):
    for rt in rts:
        if rt.actors is not None:
            await rt.actors.stop()
            rt.actors = None
    for rt in rts:
        await rt.stop()


async def retried(pkg, call, *, deadline=5.0):
    end = time.monotonic() + deadline
    failures = 0
    while True:
        try:
            return await call(), failures > 0
        except pkg.Error:
            failures += 1
            assert time.monotonic() < end
            await asyncio.sleep(0.02)


async def _actor_script(pkg, db) -> list:
    """The script: every answer and every record it reads, in order."""
    out = []
    r1, r2, r3 = rts = [runtime(pkg, db) for _ in range(3)]
    for rt in rts:
        await rt.start()
        rt.actors.lease_seconds = SCRIPT_LEASE
    try:
        # turns and a forward in this process
        out += [await r1.invoke_actor("Counter", "a", "bump") for _ in range(3)]
        out.append(await r2.invoke_actor("Counter", "a", "bump", {"from": "r2"}))
        out.append(await r1.invoke_actor("Counter", "b", "bump"))
        # reminders: one-shot, then periodic, then removed
        await r1.register_actor_reminder("Counter", "a", "once", due_seconds=0.0)
        out.append(await r1.actors.sweep())
        out.append(await r1.actors.sweep())
        await r2.register_actor_reminder("Counter", "a", "tick", due_seconds=0.0,
                                         period_seconds=0.15, data={"k": 1})
        out.append((await r1.actors.sweep())["fired"])
        out.append((await r1.actors.sweep())["fired"])
        await asyncio.sleep(0.2)
        out.append((await r1.actors.sweep())["fired"])
        out.append(normal(await r1.get_actor_state("Counter", "a")))
        await r1.unregister_actor_reminder("Counter", "a", "tick")
        out.append(normal(await r3.get_actor_state("Counter", "a")))
        # a crash and its failover: every acknowledged turn kept
        r1.actors.simulate_crash()
        out.append(await retried(pkg, lambda: r2.invoke_actor("Counter", "a", "bump",
                                                              {"from": "failover"})))
        out.append(normal(await r2.get_actor_state("Counter", "a")))
        # the zombie wakes believing in its lease: fenced, nothing applied
        r1.actors.crashed = False
        r1.actors._activations[("Counter", "b")].lease_expires = time.time() + 99
        out.append(await retried(pkg, lambda: r3.invoke_actor("Counter", "b", "bump")))
        with pytest.raises(pkg.Error) as fenced:
            await r1.invoke_actor("Counter", "b", "bump")
        out.append((type(fenced.value).__name__, fenced.value.http_status, str(fenced.value)))
        out.append(("Counter", "b") in r1.actors._activations)
        # a double failover: epochs 2 then 3
        r2.actors.simulate_crash()
        out.append(await retried(pkg, lambda: r3.invoke_actor("Counter", "a", "bump")))
        out.append(normal(await r3.get_actor_state("Counter", "a")))
        out.append(normal(await r3.actors.placement_table()))
    finally:
        await stop_all(*rts)
    return out


async def test_scripted_actor_operations_equal_the_jax_ones(actor_env, tmp_path):
    results = {name: await _actor_script(pkg, tmp_path / f"{name}.db")
               for name, pkg in PACKAGES.items()}
    assert results["port"] == results["jax"]
    assert results["port"][-3:-1] == [(6, True), {"epoch": 3, "data": {
        "n": 6, "reminded": 3, "fired_as": ["once", "tick", "tick"]}, "reminders": {}}]
    rows = {name: store_rows(tmp_path / f"{name}.db") for name in PACKAGES}
    assert rows["port"] == rows["jax"]
    assert rows["port"]["svc||actor-index||Counter"] == {"ids": ["a", "b"]}
    assert rows["port"]["svc||audit||a||5"] == {"from": "failover"}


async def test_turns_forward_over_http_between_the_packages(actor_env, tmp_path):
    """Two sidecars, one of each package, over one sqlite file: a turn sent
    to either for an actor the other owns is served by the owner."""
    sidecars = {name: pkg.Sidecar(runtime(pkg, tmp_path / "shared.db"), port=0)
                for name, pkg in PACKAGES.items()}
    for sc in sidecars.values():
        await sc.start()
    try:
        async def turn(name, actor_id):
            status, _, body = await http_request(
                "127.0.0.1", sidecars[name].port, "PUT",
                f"/v1.0/actors/Counter/{actor_id}/method/bump")
            return status, json.loads(body)

        for owner, other in (("jax", "port"), ("port", "jax")):
            actor_id = f"owned-by-{owner}"
            assert await turn(owner, actor_id) == (200, {"result": 1})
            assert await turn(other, actor_id) == (200, {"result": 2})
            assert await turn(other, actor_id) == (200, {"result": 3})
            assert ("Counter", actor_id) in sidecars[owner].runtime.actors._activations
            assert ("Counter", actor_id) not in sidecars[other].runtime.actors._activations
        tables = [normal(await sc.runtime.actors.placement_table()) for sc in sidecars.values()]
        assert tables[0] == [{**row, "owned_here": not row["owned_here"]} for row in tables[1]]
    finally:
        for sc in sidecars.values():
            await sc.stop()


def test_locality_rank_equals_the_jax_one():
    """The same keys over 4 shards, under a placement assignment and under
    replica-set leaders, for every local member: the same rank."""
    keys = [f"svc||actor-rec||Counter||{i}" for i in range(300)]
    leaders = {0: "r1", 1: "r0", 2: "r2", 3: "r1"}
    ranks = {}
    for name, module in (("jax", jax_sharding), ("port", sharding)):
        store = module.ShardedStateStore("statestore", [object()] * 4, hash_seed="s7")
        by_assignment = []
        for local in (None, "host-a", "host-b"):
            store.local_member = local
            store.placement.assignment = {0: "host-a", 1: "host-b", 3: "host-a"}
            by_assignment.append([store.locality_rank(k) for k in keys])
        store._shards = [types.SimpleNamespace(leader_member=lambda m=m: m)
                         for m in leaders.values()]
        by_leader = []
        for local in ("r0", "r1", "r2"):
            store.local_member = local
            by_leader.append([store.locality_rank(k) for k in keys])
        ranks[name] = (by_assignment, by_leader)
    assert ranks["port"] == ranks["jax"]
    by_assignment, by_leader = ranks["port"]
    assert set(by_assignment[0]) == {1.0} and set(by_assignment[1]) == {0.0, 1.0}
    assert all(sum(r == 1.0 for r in row) > 0 for row in by_leader)


async def _stale_follower_activations(pkg, path) -> tuple[list, list, list]:
    """A replica set of 3 (quorum 2) with ``followerReads``, one follower
    never applying: replica A acknowledges three turns on each actor, then
    replica B sends one more. Returns B's answers and each one's owners."""
    store = pkg.replicated("statestore", path, replicas=3, follower_reads=True)
    a, b = runtime(pkg, store=store), runtime(pkg, store=store)
    await a.start()
    await b.start()
    try:
        await store.get("warm-up")  # the members start on first use
        leader = store.leader_member()
        stale = [n for n in store.nodes if n.node_id != leader][1]

        async def never(*args, **kwargs):
            await asyncio.Event().wait()

        stale.apply_records = stale.install_snapshot = never
        answers = []
        for i in range(6):
            for _ in range(3):
                await a.invoke_actor("Counter", f"c{i}", "bump")
            answers.append(await b.invoke_actor("Counter", f"c{i}", "bump"))
        return (answers, sorted(aid for _, aid in a.actors._activations),
                sorted(aid for _, aid in b.actors._activations))
    finally:
        await stop_all(a, b)
        with contextlib.suppress(Exception):
            await store.aclose()


async def test_a_stale_follower_read_makes_two_owners_in_jax_but_not_in_the_port(
        actor_env, tmp_path, monkeypatch):
    """The first activation's create is unguarded and checked by reading
    it back. Over ``followerReads`` the JAX runtime reads a follower that
    trails: it finds no owner, overwrites the live owner's records, and
    acknowledged turns are lost while both replicas hold the actor. The
    port reads its actor records from the leader."""
    monkeypatch.setenv("TASKSRUNNER_REPL_ACK_TIMEOUT_SECONDS", "2")
    jax_answers, jax_a, jax_b = await _stale_follower_activations(
        PACKAGES["jax"], tmp_path / "jax.db")
    port_answers, port_a, port_b = await _stale_follower_activations(
        PACKAGES["port"], tmp_path / "port.db")
    ids = [f"c{i}" for i in range(6)]
    assert port_answers == [4] * 6 and port_a == ids and port_b == []
    # the reference's fault, as ROADMAP C records it
    assert 1 in jax_answers and set(jax_a) & set(jax_b)


# -- the routes, the verb and /admin/actors --------------------------------

class _Loop:
    """A loop in a thread: the verbs run asyncio.run of their own."""

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


def verb(main, argv, capsys) -> tuple:
    """Exit code and output, every clock reading masked."""
    try:
        main(argv)
        code = 0
    except SystemExit as exc:
        code = 0 if exc.code is None else (exc.code if isinstance(exc.code, int) else 1)
    out = capsys.readouterr().out
    out = re.sub(r'"(lease_age|lease_expires_in|registered_at|pid|sidecar_port|created|updated'
                 r'|ts)": [-0-9.e]+', r'"\1": <n>', out)
    return code, re.sub(r"\d+\.\d", "<t>", out)


def _route_script(zombie_id: str) -> list[tuple]:
    return [("PUT", "/v1.0/actors/Counter/a1/method/bump", None),
            ("PUT", "/v1.0/actors/Counter/a1/method/bump", {"note": "x"}),
            ("PUT", "/v1.0/actors/Nope/x/method/m", None),
            ("POST", "/v1.0/actors/Counter/a1/reminders/tick",
             {"dueSeconds": 0, "periodSeconds": 5}),
            ("POST", "/v1.0/actors/Counter/a1/reminders/bad", {"periodSeconds": 5}),
            ("POST", "/v1.0/actors/Counter/a1/reminders/bad", b"{"),
            ("SWEEP", None, None),
            ("GET", "/v1.0/actors/Counter/a1/state", None),
            ("DELETE", "/v1.0/actors/Counter/a1/reminders/tick", None),
            ("DELETE", "/v1.0/actors/Counter/a1/reminders/never-set", None),
            ("GET", "/v1.0/actors/Counter/a1/state", None),
            ("GET", "/v1.0/actors/Counter/ghost/state", None),
            ("SHORT-LEASE", None, None),
            ("PUT", f"/v1.0/actors/Counter/{zombie_id}/method/bump", None),
            ("ZOMBIE", zombie_id, None),
            ("PUT", f"/v1.0/actors/Counter/{zombie_id}/method/bump", None),
            ("GET", "/v1.0/actors", None)]


async def _drive_routes(pkg, sidecar, db) -> list:
    out = []
    rt = sidecar.runtime
    for method, path, body in _route_script("z1"):
        if method == "SWEEP":
            out.append(await rt.actors.sweep())
            continue
        if method == "SHORT-LEASE":
            rt.actors.lease_seconds = LEASE
            continue
        if method == "ZOMBIE":
            # another replica takes the actor over once this one's lease is
            # gone; this one then wakes believing in its lease
            await asyncio.sleep(LEASE + 0.05)
            other = runtime(pkg, db)
            await other.start()
            try:
                out.append(await other.invoke_actor("Counter", path, "bump"))
            finally:
                await stop_all(other)
            rt.actors._activations[("Counter", path)].lease_expires = time.time() + 99
            continue
        raw = body if isinstance(body, bytes) else (
            b"" if body is None else json.dumps(body).encode())
        status, _, reply = await http_request("127.0.0.1", sidecar.port, method, path, body=raw)
        out.append((method, path, status, normal(json.loads(reply)) if reply else None))
    return out


def test_actor_routes_verb_and_admin_equal_the_jax_ones(actor_env, tmp_path, capsys):
    loop = _Loop()
    sidecars, started, admins = {}, [], {}
    try:
        answers = {}
        for name, pkg in PACKAGES.items():
            db = tmp_path / f"{name}.db"
            sidecars[name] = pkg.Sidecar(runtime(pkg, db), port=0)
            loop.run(sidecars[name].start())
            started.append(sidecars[name])
            answers[name] = loop.run(_drive_routes(pkg, sidecars[name], db))
        assert answers["port"] == answers["jax"]
        statuses = [a[2] for a in answers["port"] if isinstance(a, tuple) and len(a) == 4]
        assert statuses == [200, 200, 404, 204, 400, 400, 200, 204, 204, 200, 200, 200, 409, 200]
        # each package's verb against each sidecar prints the same
        for name, sc in sidecars.items():
            registry = tmp_path / f"{name}-apps.json"
            NameResolver(registry_file=registry).register(AppAddress(
                app_id="svc", host="127.0.0.1", sidecar_port=sc.port))
            for extra in ([], ["--ids"], ["--json"]):
                argv = ["actors", "--app-id", "svc", *extra, "--registry-file", str(registry)]
                want = verb(jax_cli.main, argv, capsys)
                assert verb(cli.main, argv, capsys) == want, argv
                assert want[0] == 0
        # the two admin servers over the two sidecars
        replicas = [types.SimpleNamespace(ports=(0, sc.port)) for sc in sidecars.values()]
        docs = {}
        for name, server in (("jax", JaxAdminServer), ("port", AdminServer)):
            orch = types.SimpleNamespace(
                replicas={"svc": replicas}, placement={},
                config=types.SimpleNamespace(app_tokens=None,
                                             registry_path=tmp_path / name / "apps.json"))
            admins[name] = server(orch)
            loop.run(admins[name].start())
            status, _, raw = loop.run(http_request("127.0.0.1", admins[name].port, "GET",
                                                   "/admin/actors"))
            docs[name] = (status, normal(json.loads(raw)))
        assert docs["port"] == docs["jax"]
        assert docs["port"][0] == 200 and len(docs["port"][1]["replicas"]) == 2
        assert [(r["type"], r["id"]) for r in docs["port"][1]["placement"]] == [
            ("Counter", "a1"), ("Counter", "z1")]
    finally:
        for admin in admins.values():
            loop.run(admin.stop())
        for sc in reversed(started):
            loop.run(sc.stop())
        loop.close()


def test_with_both_flags_off_no_actor_or_workflow_route_answers(monkeypatch, tmp_path):
    monkeypatch.delenv("TASKSRUNNER_ACTORS", raising=False)
    monkeypatch.delenv("TASKSRUNNER_WORKFLOWS", raising=False)
    loop = _Loop()
    sidecars = {name: pkg.Sidecar(runtime(pkg, tmp_path / f"{name}.db"), port=0)
                for name, pkg in PACKAGES.items()}
    try:
        statuses = {}
        for name, sc in sidecars.items():
            loop.run(sc.start())
            statuses[name] = [loop.run(http_request("127.0.0.1", sc.port, method, path))[0]
                              for method, path in (
                                  ("GET", "/v1.0/actors"),
                                  ("PUT", "/v1.0/actors/Counter/a/method/bump"),
                                  ("GET", "/v1.0/actors/Counter/a/state"),
                                  ("GET", "/v1.0/workflows"),
                                  ("POST", "/v1.0/workflows/engine/w/start"),
                                  ("GET", "/v1.0/healthz"))]
            assert sc.runtime.actors is None
        assert statuses["port"] == statuses["jax"] == [404, 404, 404, 404, 404, 204]
        assert not any("/v1.0/actors" in r.path or "/v1.0/workflows" in r.path
                       for r in sidecars["port"].router.table)
    finally:
        for sc in sidecars.values():
            loop.run(sc.stop())
        loop.close()


# -- activations at once -----------------------------------------------------

async def _index_after_activations_at_once(pkg, db) -> tuple[int, list]:
    """Two replicas, each with its own store on one sqlite file, each
    activating 16 new actors at once: the ids the index holds, and the
    turns' errors."""
    a, b = runtime(pkg, db), runtime(pkg, db)
    await a.start()
    await b.start()
    try:
        results = await asyncio.gather(*(rt.invoke_actor("Counter", f"{n}{i}", "bump")
                                         for i in range(16) for n, rt in (("a", a), ("b", b))),
                                       return_exceptions=True)
        index = await a.get_state("statestore", "actor-index||Counter")
        return len(index.value["ids"]), [r for r in results if isinstance(r, BaseException)]
    finally:
        await stop_all(a, b)


async def test_every_actor_activated_at_once_lands_in_the_index(actor_env, tmp_path):
    """The sweep adopts only the actors in the type's index. The JAX
    runtime adds an id with at most 8 CAS tries (and creates the index
    unguarded): with 32 activations at once over one file most ids never
    land, so those actors are not adopted when their owner dies (ROADMAP
    C). The port creates it guarded and retries with a random pause."""
    held, errors = await _index_after_activations_at_once(PACKAGES["port"], tmp_path / "p.db")
    assert (held, errors) == (32, [])
    jax_held, jax_errors = await _index_after_activations_at_once(PACKAGES["jax"],
                                                                  tmp_path / "j.db")
    assert jax_held < 32 and jax_errors == []
