"""The port's virtual actors (tasksrunner_torch.actors): the counterpart of
every test of tests/test_actors.py but its three chaos tests (A23).

Several ``Runtime`` objects share one store instance (the registry takes
a live one), modelling replicas of one app over one durable store without
processes. Failover is driven by ``simulate_crash()`` (dying as SIGKILL
kills: no lease released, the activations kept as a zombie's) and short
leases, every sweep is an explicit ``sweep()`` call. Imports no JAX.
"""

import asyncio
import json
import subprocess
import sys
import time

import pytest

from tasksrunner_torch.app import App
from tasksrunner_torch.client import AppClient, http_request
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import (
    ActorError, ActorFencedError, ActorNotRegistered, EtagMismatch, TasksRunnerError,
    ValidationError,
)
from tasksrunner_torch.runtime import InProcAppChannel, Runtime
from tasksrunner_torch.sidecar import Sidecar
from tasksrunner_torch.state import InMemoryStateStore

LEASE = 0.25


@pytest.fixture
def actor_env(monkeypatch, tmp_path):
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("TASKSRUNNER_ACTORS", "1")
    # long defaults: failover tests shorten the lease on the built runtime;
    # the background sweep waits 30 s, so every sweep is a test's own
    monkeypatch.setenv("TASKSRUNNER_ACTOR_LEASE_SECONDS", "5")
    monkeypatch.setenv("TASKSRUNNER_ACTOR_REMINDER_POLL_SECONDS", "30")


def build_app(app_id="svc", events=None):
    app = App(app_id)

    @app.actor("Counter")
    async def counter(turn):
        if turn.is_reminder:
            turn.state["reminded"] = turn.state.get("reminded", 0) + 1
            turn.state.setdefault("fired_as", []).append(turn.method)
            return None
        turn.state["n"] = turn.state.get("n", 0) + 1
        return turn.state["n"]

    @app.actor("Slow")
    async def slow(turn):
        if events is not None:
            events.append(("start", turn.data))
        await asyncio.sleep(0.03)
        if events is not None:
            events.append(("end", turn.data))
        return None

    return app


def make_runtime(shared, *, app_id="svc", lease=None, events=None, app=None):
    reg = ComponentRegistry([ComponentSpec(name="statestore", type="state.in-memory")],
                            app_id=app_id)
    reg._instances["statestore"] = shared
    rt = Runtime(app_id, reg, app_channel=InProcAppChannel(app or build_app(app_id, events)))
    rt._test_lease = lease
    return rt


async def start_all(*rts):
    for rt in rts:
        await rt.start()
        assert rt.actors is not None
        if rt._test_lease is not None:
            rt.actors.lease_seconds = rt._test_lease


async def shutdown(*rts):
    # every actor runtime stops while the shared store is open; then the
    # runtimes (the first Runtime.stop closes the store)
    for rt in rts:
        if rt.actors is not None:
            await rt.actors.stop()
            rt.actors = None
    for rt in rts:
        await rt.stop()


async def retry_turn(rt, actor_id, *, deadline=5.0):
    """One turn, retried while placement moves (a lease expiring)."""
    end = time.time() + deadline
    while True:
        try:
            return await rt.invoke_actor("Counter", actor_id, "bump")
        except TasksRunnerError:
            if time.time() > end:
                raise
            await asyncio.sleep(0.02)


# -- registration ----------------------------------------------------------

def test_actor_decorator_rejects_sync_handlers():
    app = App("svc")
    with pytest.raises(ValidationError):
        @app.actor("Bad")
        def bad(turn):  # noqa: ARG001 - the shape under test
            return None


def test_actor_decorator_rejects_duplicate_type():
    app = App("svc")

    @app.actor("Dup")
    async def one(turn):
        return None

    with pytest.raises(ValidationError):
        @app.actor("Dup")
        async def two(turn):
            return None


# -- the gate --------------------------------------------------------------

async def test_gate_off_no_actor_runtime(monkeypatch):
    monkeypatch.delenv("TASKSRUNNER_ACTORS", raising=False)
    rt = make_runtime(InMemoryStateStore("statestore"))
    await rt.start()
    try:
        assert rt.actors is None
        assert "actors" not in rt.metadata()
        with pytest.raises(ActorError):
            await rt.invoke_actor("Counter", "x", "bump")
    finally:
        await rt.stop()


async def test_gate_on_but_no_handlers(actor_env):
    rt = make_runtime(InMemoryStateStore("statestore"), app_id="plain", app=App("plain"))
    await rt.start()
    try:
        assert rt.actors is None  # the app hosts no actor type
    finally:
        await rt.stop()


# -- turns -----------------------------------------------------------------

async def test_turns_and_state_persistence(actor_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        assert await rt.invoke_actor("Counter", "c1", "bump") == 1
        assert await rt.invoke_actor("Counter", "c1", "bump") == 2
        assert await rt.invoke_actor("Counter", "other", "bump") == 1
        doc = await rt.get_actor_state("Counter", "c1")
        assert doc["data"] == {"n": 2}
        assert doc["epoch"] == 1
        with pytest.raises(ActorNotRegistered):
            await rt.invoke_actor("Nope", "c1", "bump")
        assert rt.metadata()["actors"]["owned"] == {"Counter": 2}
    finally:
        await shutdown(rt)


async def test_turns_serialize_per_actor(actor_env):
    events = []
    rt = make_runtime(InMemoryStateStore("statestore"), events=events)
    await start_all(rt)
    try:
        await asyncio.gather(*(rt.invoke_actor("Slow", "s1", "go", i) for i in (1, 2, 3)))
        # one turn at a time: each start is followed by its own end
        assert len(events) == 6
        for i in range(0, 6, 2):
            assert events[i][0] == "start"
            assert events[i + 1] == ("end", events[i][1])
    finally:
        await shutdown(rt)


async def test_forwarding_to_live_owner(actor_env):
    shared = InMemoryStateStore("statestore")
    r1, r2 = make_runtime(shared), make_runtime(shared)
    await start_all(r1, r2)
    try:
        assert await r1.invoke_actor("Counter", "f1", "bump") == 1
        # r2 does not own f1: the turn goes to r1 in this process
        assert await r2.invoke_actor("Counter", "f1", "bump") == 2
        assert await r1.invoke_actor("Counter", "f1", "bump") == 3
        assert ("Counter", "f1") in r1.actors._activations
        assert ("Counter", "f1") not in r2.actors._activations
    finally:
        await shutdown(r1, r2)


# -- reminders -------------------------------------------------------------

async def test_reminder_fires_exactly_once_per_schedule(actor_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        await rt.invoke_actor("Counter", "r1", "bump")
        # one-shot: fires once, then goes
        await rt.register_actor_reminder("Counter", "r1", "once", due_seconds=0.0)
        assert (await rt.actors.sweep())["fired"] == 1
        assert (await rt.actors.sweep())["fired"] == 0
        doc = await rt.get_actor_state("Counter", "r1")
        assert doc["data"]["reminded"] == 1
        assert "once" not in doc["reminders"]
        # periodic: fires, re-arms, fires again after the period, never
        # twice inside one
        await rt.register_actor_reminder("Counter", "r1", "tick", due_seconds=0.0,
                                         period_seconds=0.15)
        assert (await rt.actors.sweep())["fired"] == 1
        assert (await rt.actors.sweep())["fired"] == 0
        await asyncio.sleep(0.2)
        assert (await rt.actors.sweep())["fired"] == 1
        await rt.unregister_actor_reminder("Counter", "r1", "tick")
        await asyncio.sleep(0.2)
        assert (await rt.actors.sweep())["fired"] == 0
        doc = await rt.get_actor_state("Counter", "r1")
        assert doc["data"]["reminded"] == 3
        assert doc["reminders"] == {}
    finally:
        await shutdown(rt)


async def test_reminders_survive_replica_restart(actor_env):
    shared = InMemoryStateStore("statestore")
    r1 = make_runtime(shared)
    await start_all(r1)
    await r1.invoke_actor("Counter", "d1", "bump")
    await r1.register_actor_reminder("Counter", "d1", "tick", due_seconds=0.0,
                                     period_seconds=0.1)
    # a clean stop: the lease released, the reminder durable
    await r1.actors.stop()
    r1.actors = None
    r2 = make_runtime(shared)
    await start_all(r2)
    try:
        # the sweep adopts the released actor and fires its due reminder
        stats = await r2.actors.sweep()
        assert stats["adopted"] == 1
        assert stats["fired"] == 1
        doc = await r2.get_actor_state("Counter", "d1")
        assert doc["data"]["reminded"] == 1
        assert doc["epoch"] == 2  # adoption bumped the fencing epoch
    finally:
        await shutdown(r2, r1)


# -- crash failover and fencing --------------------------------------------

async def test_crash_failover_zero_lost_acked_turns(actor_env):
    shared = InMemoryStateStore("statestore")
    r1 = make_runtime(shared, lease=LEASE)
    r2 = make_runtime(shared, lease=LEASE)
    await start_all(r1, r2)
    try:
        acked = 0
        for _ in range(5):
            acked = await r1.invoke_actor("Counter", "c2", "bump")
        r1.actors.simulate_crash()
        t0 = time.time()
        v = await retry_turn(r2, "c2")
        took = time.time() - t0
        assert v == acked + 1  # the survivor's first turn sees every acked one
        assert took < LEASE + 2.0  # one lease and some slack
        assert (await r2.get_actor_state("Counter", "c2"))["epoch"] == 2
    finally:
        await shutdown(r2, r1)


async def test_zombie_commit_is_fenced(actor_env):
    shared = InMemoryStateStore("statestore")
    r1 = make_runtime(shared, lease=LEASE)
    r2 = make_runtime(shared, lease=LEASE)
    await start_all(r1, r2)
    try:
        await r1.invoke_actor("Counter", "z1", "bump")
        r1.actors.simulate_crash()
        await retry_turn(r2, "z1")  # r2 takes over at epoch 2
        # the zombie wakes with its activation (epoch 1's etag) and a lease
        # it believes alive
        r1.actors.crashed = False
        r1.actors._activations[("Counter", "z1")].lease_expires = time.time() + 99
        with pytest.raises(ActorFencedError) as exc:
            await r1.invoke_actor("Counter", "z1", "bump")
        assert "NOT applied" in str(exc.value)
        doc = await r2.get_actor_state("Counter", "z1")
        assert doc["data"]["n"] == 2
        assert doc["epoch"] == 2
        assert ("Counter", "z1") not in r1.actors._activations
    finally:
        await shutdown(r2, r1)


async def test_double_failover_epochs_monotonic(actor_env):
    shared = InMemoryStateStore("statestore")
    r1, r2, r3 = rts = [make_runtime(shared, lease=LEASE) for _ in range(3)]
    await start_all(*rts)
    try:
        for _ in range(3):
            await r1.invoke_actor("Counter", "m1", "bump")
        r1.actors.simulate_crash()
        assert await retry_turn(r2, "m1") == 4
        assert (await r2.get_actor_state("Counter", "m1"))["epoch"] == 2
        r2.actors.simulate_crash()
        assert await retry_turn(r3, "m1") == 5
        doc = await r3.get_actor_state("Counter", "m1")
        assert doc["epoch"] == 3
        assert doc["data"]["n"] == 5
    finally:
        await shutdown(r3, r2, r1)


# -- pid recycling ----------------------------------------------------------

def _place_doc(pid, registered_at, *, lease_expires):
    return {"owner": {"replica": "ghost@x.y", "app_id": "svc", "host": "127.0.0.1",
                      "pid": pid, "registered_at": registered_at},
            "epoch": 7, "lease_expires": lease_expires, "granted_at": registered_at}


async def test_owner_dead_predicate_no_ghost_passes_both(actor_env, monkeypatch):
    from tasksrunner_torch.actors.runtime import ActorRuntime

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        registered_at = time.time()
        live = _place_doc(child.pid, registered_at, lease_expires=time.time() + 60)
        assert not ActorRuntime.owner_dead(live)
        # an expired lease is dead however alive the pid (a wedged owner)
        stale = _place_doc(child.pid, registered_at, lease_expires=time.time() - 1)
        assert ActorRuntime.owner_dead(stale)
        # a recycled pid: its holder was born after the owner registered
        monkeypatch.setattr("tasksrunner_torch.invoke.resolver._pid_started_at",
                            lambda pid: registered_at + 100.0)
        assert ActorRuntime.owner_dead(live)
    finally:
        child.kill()
        child.wait()


async def test_pid_recycled_owner_is_preempted(actor_env, monkeypatch):
    from tasksrunner_torch.actors.runtime import place_key

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        registered_at = time.time()
        await rt.save_state_item("statestore", place_key("Counter", "p1"),
                                 _place_doc(child.pid, registered_at,
                                            lease_expires=time.time() + 60))
        # a live pid inside a valid lease: unreachable, not preemptable
        with pytest.raises(ActorError, match="unreachable"):
            await rt.invoke_actor("Counter", "p1", "bump")
        # the pid turns out recycled: taken over at once, above its epoch
        monkeypatch.setattr("tasksrunner_torch.invoke.resolver._pid_started_at",
                            lambda pid: registered_at + 100.0)
        assert await rt.invoke_actor("Counter", "p1", "bump") == 1
        assert (await rt.get_actor_state("Counter", "p1"))["epoch"] == 8
    finally:
        child.kill()
        child.wait()
        await shutdown(rt)


# -- the sidecar's routes, the placement table, the verb -------------------

async def test_sidecar_actor_routes_gated_off(monkeypatch):
    monkeypatch.delenv("TASKSRUNNER_ACTORS", raising=False)
    monkeypatch.delenv("TASKSRUNNER_WORKFLOWS", raising=False)
    sc = Sidecar(make_runtime(InMemoryStateStore("statestore")), port=0)
    assert not any("/v1.0/actors" in r.path for r in sc.router.table)


async def test_sidecar_actor_api_end_to_end(actor_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    sc = Sidecar(rt, port=0)
    await sc.start()
    try:
        async def call(method, path, body=None):
            status, _, raw = await http_request(
                "127.0.0.1", sc.port, method, path,
                body=b"" if body is None else json.dumps(body).encode())
            return status, (json.loads(raw) if raw else None)

        assert await call("PUT", "/v1.0/actors/Counter/web1/method/bump") == (
            200, {"result": 1})
        status, _ = await call("POST", "/v1.0/actors/Counter/web1/reminders/tick",
                               {"dueSeconds": 0.0, "periodSeconds": 5})
        assert status == 204
        assert (await rt.actors.sweep())["fired"] == 1
        status, doc = await call("GET", "/v1.0/actors/Counter/web1/state")
        assert doc["data"] == {"n": 1, "reminded": 1, "fired_as": ["tick"]}
        status, _ = await call("DELETE", "/v1.0/actors/Counter/web1/reminders/tick")
        assert status == 204
        status, view = await call("GET", "/v1.0/actors")
        assert view["replica"]["owned"] == {"Counter": 1}
        assert view["placement"][0]["id"] == "web1"
        assert view["placement"][0]["alive"] is True
        assert (await call("PUT", "/v1.0/actors/Nope/x/method/m"))[0] == 404
        # the app's HTTP client over the same routes
        client = AppClient.http(sc.port)
        assert await client.invoke_actor("Counter", "web1", "bump") == 2
        assert (await client.get_actor_state("Counter", "web1"))["data"]["n"] == 2
    finally:
        await sc.stop()


async def test_placement_table_rows(actor_env):
    shared = InMemoryStateStore("statestore")
    r1, r2 = make_runtime(shared), make_runtime(shared)
    await start_all(r1, r2)
    try:
        await r1.invoke_actor("Counter", "t1", "bump")
        await r2.invoke_actor("Counter", "t2", "bump")
        # both replicas render the same table from the shared store
        t_from_r1 = await r1.actors.placement_table()
        t_from_r2 = await r2.actors.placement_table()
        owners = {row["id"]: row["owner"] for row in t_from_r1}
        assert owners == {row["id"]: row["owner"] for row in t_from_r2}
        assert owners["t1"] == r1.actors.replica_id
        assert owners["t2"] == r2.actors.replica_id
        by_id = {row["id"]: row for row in t_from_r1}
        assert by_id["t1"]["owned_here"] is True
        assert by_id["t2"]["owned_here"] is False
        assert all(row["alive"] for row in t_from_r1)
        assert all(row["epoch"] == 1 for row in t_from_r1)
    finally:
        await shutdown(r1, r2)


def test_cli_has_actors_surface():
    from tasksrunner_torch.cli import _cmd_actors, build_parser

    args = build_parser().parse_args(["actors", "--app-id", "svc", "--ids"])
    assert args.fn is _cmd_actors
    assert args.app_id == "svc"
    assert args.ids is True


# -- what the port adds to the reference's tests ---------------------------

async def test_in_process_client_reaches_the_actors(actor_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        client = AppClient.runtime(rt)
        assert await client.invoke_actor("Counter", "k1", "bump") == 1
        await client.register_actor_reminder("Counter", "k1", "tick", due_seconds=0.0)
        assert (await rt.actors.sweep())["fired"] == 1
        await client.unregister_actor_reminder("Counter", "k1", "tick")
        assert (await client.get_actor_state("Counter", "k1"))["data"]["reminded"] == 1
    finally:
        await shutdown(rt)


async def test_a_stale_record_etag_refuses_the_whole_cross_shard_commit(actor_env, tmp_path):
    """An effectful commit on a sharded store is a cross-shard transaction
    guarded by the record's etag: with that etag stale, the staged commit
    refuses all of it, and no effect lands on any shard."""
    from tasksrunner_torch.actors.runtime import record_key
    from tasksrunner_torch.state.sqlite import build_sharded_store

    store = build_sharded_store("statestore", tmp_path / "actors.db", shards=4)
    app = build_app()

    @app.actor("Effects")
    async def effects(turn):
        for i in range(8):
            turn.stage_effect(f"eff||{turn.actor_id}||{turn.data}||{i}", i)
        turn.state["n"] = turn.state.get("n", 0) + 1
        return turn.state["n"]

    rt = make_runtime(store, app=app)
    await start_all(rt)
    try:
        assert await rt.invoke_actor("Effects", "e1", "go", "a") == 1
        effect_keys = [f"svc||eff||e1||a||{i}" for i in range(8)]
        assert len({store.router.shard_of(k) for k in effect_keys}) > 1
        assert all([await store.get(k) for k in effect_keys])
        # another writer moves the record on: this owner's etag is stale
        rkey = "svc||" + record_key("Effects", "e1")
        rec = await store.get(rkey)
        await store.set(rkey, {**rec.value, "epoch": 2}, etag=rec.etag)
        with pytest.raises(ActorFencedError):
            await rt.invoke_actor("Effects", "e1", "go", "b")
        assert [await store.get(f"svc||eff||e1||b||{i}") for i in range(8)] == [None] * 8
        assert (await store.get(rkey)).value["data"] == {"n": 1}
        with pytest.raises(EtagMismatch):  # the store's own refusal, for the record
            await rt.transact_state("statestore", [
                {"operation": "upsert", "request": {"key": "x", "value": 1}},
                {"operation": "upsert", "request": {"key": record_key("Effects", "e1"),
                                                    "value": {}, "etag": rec.etag}}])
        assert await store.get("svc||x") is None
    finally:
        await shutdown(rt)
