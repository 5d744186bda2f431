"""The port's durable workflows (tasksrunner_torch.workflows): the
counterpart of every test of tests/test_workflows.py.

As there, several ``Runtime`` objects share one store instance, failover
is ``simulate_crash`` plus short leases and explicit ``sweep()`` calls.
The reference's chaos drill (a ``crashEveryN`` fault felling the owner
mid-activity, ROADMAP A23) becomes an activity that calls
``simulate_crash()`` itself over a 3-member replica set. The ``kill -9``
drill runs a child process of the port. The sample's three workflows run
on a copy of its ``register_workflows`` kept here (the sample imports the
JAX package), over a small fake tasks manager. Imports no JAX.
"""

import asyncio
import datetime as dt
import json
import os
import random as random_mod
import sys
import time
import uuid as uuid_mod

import pytest

from tasksrunner_torch.app import App
from tasksrunner_torch.client import http_request
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import (
    ActivityError, ValidationError, WorkflowError, WorkflowNotFound,
)
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.resiliency import RetrySpec
from tasksrunner_torch.runtime import InProcAppChannel, Runtime
from tasksrunner_torch.sidecar import Sidecar
from tasksrunner_torch.state import InMemoryStateStore
from tasksrunner_torch.state.replication import build_replicated_store
from tasksrunner_torch.workflows import WORKFLOW_ACTOR_TYPE

LEASE = 0.25
#: a fast drive for tests (the default, the 2 s sweep, would crawl)
DRIVE = 0.1


@pytest.fixture
def wf_env(monkeypatch, tmp_path):
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("TASKSRUNNER_WORKFLOWS", "1")
    monkeypatch.setenv("TASKSRUNNER_ACTOR_LEASE_SECONDS", "5")
    # the background sweep waits 30 s: every sweep is a test's own
    monkeypatch.setenv("TASKSRUNNER_ACTOR_REMINDER_POLL_SECONDS", "30")


def build_app(app_id="svc", log=None, crash=None):
    """One app with every scenario; ``log`` collects the activity bodies
    run, as (kind, payload), over every replica. ``crash(actx, data)``, when
    given, runs first in ``reserve``."""
    app = App(app_id)
    log = log if log is not None else []

    @app.workflow("simple")
    async def simple(ctx, inp):
        a = await ctx.call_activity("add", {"x": inp, "y": 1})
        return await ctx.call_activity("add", {"x": a, "y": 10})

    @app.activity("add")
    async def add(actx, data):
        log.append(("add", actx.seq))
        actx.stage_effect(f"eff||{actx.instance}||{actx.seq}", data)
        return data["x"] + data["y"]

    @app.workflow("fanout")
    async def fanout(ctx, n):
        return sum(await ctx.when_all([ctx.call_activity("add", {"x": i, "y": 0})
                                       for i in range(n)]))

    @app.workflow("order")
    async def order(ctx, n):
        for i in range(n):
            await ctx.call_activity("reserve", {"i": i})
            ctx.register_compensation("release", {"i": i})
        await ctx.call_activity("charge", None)
        return "paid"

    @app.activity("reserve")
    async def reserve(actx, data):
        if crash is not None:
            await crash(actx, data)
        log.append(("reserve", data["i"]))
        actx.stage_effect(f"res||{actx.instance}||{data['i']}", data)
        return data["i"]

    @app.activity("release")
    async def release(actx, data):
        log.append(("release", data["i"]))
        actx.stage_effect(f"rel||{actx.instance}||{data['i']}", data)
        return data["i"]

    @app.activity("charge", retry=RetrySpec(duration=0.01, max_retries=1))
    async def charge(actx, data):
        log.append(("charge", actx.attempt))
        raise RuntimeError("card declined")

    @app.workflow("fallback")
    async def fallback(ctx, inp):
        try:
            return await ctx.call_activity("charge", None)
        except ActivityError as exc:
            return {"fallback": True, "cause": str(exc)}

    @app.workflow("parent")
    async def parent(ctx, inp):
        return await ctx.when_all([ctx.call_child("simple", 5), ctx.call_child("simple", 50)])

    @app.workflow("waiter")
    async def waiter(ctx, inp):
        return {"got": await ctx.wait_event("go")}

    @app.workflow("timed")
    async def timed(ctx, inp):
        log.append(("orchestrate", "timed"))
        u1 = ctx.uuid4()
        await ctx.sleep(0.15)
        return [u1, ctx.uuid4(), ctx.now()]

    @app.workflow("racer")
    async def racer(ctx, inp):
        winner = await ctx.when_any([ctx.wait_event("a"), ctx.wait_event("b")])
        return winner.value

    @app.workflow("rogue")
    async def rogue(ctx, inp):
        await asyncio.sleep(0.01)  # forbidden: a foreign awaitable
        return "never"

    @app.workflow("lost")
    async def lost(ctx, inp):
        return await ctx.call_activity("no-such-activity", None)

    return app


def make_runtime(shared, *, app_id="svc", lease=LEASE, log=None, app=None, crash=None):
    reg = ComponentRegistry([ComponentSpec(name="statestore", type="state.in-memory")],
                            app_id=app_id)
    reg._instances["statestore"] = shared
    rt = Runtime(app_id, reg,
                 app_channel=InProcAppChannel(app or build_app(app_id, log, crash)))
    rt._test_lease = lease
    return rt


async def start_all(*rts):
    for rt in rts:
        await rt.start()
        assert rt.actors is not None and rt.workflows is not None
        if rt._test_lease is not None:
            rt.actors.lease_seconds = rt._test_lease
        rt.app_channel.app.workflow_engine.drive_period = DRIVE


async def shutdown(*rts):
    for rt in rts:
        if rt.actors is not None:
            if rt.workflows is not None:
                rt.workflows.detach()
                rt.workflows = None
            await rt.actors.stop()
            rt.actors = None
    for rt in rts:
        await rt.stop()


async def adopt_until(rt, instance, *, timeout=8.0):
    """What a cluster's periodic sweep does, in an explicit loop."""
    deadline = time.monotonic() + timeout
    while True:
        await rt.actors.sweep()
        status = await rt.workflows.status(instance)
        if status["status"] in ("completed", "failed", "terminated"):
            return status
        assert time.monotonic() < deadline, f"instance {instance} never converged: {status}"
        await asyncio.sleep(0.05)


# -- registration ----------------------------------------------------------

def test_workflow_decorator_rejects_sync_orchestrators():
    app = App("svc")
    with pytest.raises(ValidationError):
        @app.workflow("bad")
        def bad(ctx, inp):  # noqa: ARG001 - the shape under test
            return None


def test_activity_decorator_rejects_sync_handlers():
    app = App("svc")
    with pytest.raises(ValidationError):
        @app.activity("bad")
        def bad(actx, data):  # noqa: ARG001 - the shape under test
            return None


def test_duplicate_registration_rejected():
    app = App("svc")

    @app.workflow("dup")
    async def one(ctx, inp):
        return None

    with pytest.raises(WorkflowError):
        @app.workflow("dup")
        async def two(ctx, inp):
            return None

    @app.activity("dup-act")
    async def act_one(actx, data):
        return None

    with pytest.raises(WorkflowError):
        @app.activity("dup-act")
        async def act_two(actx, data):
            return None


# -- the basic scenarios ---------------------------------------------------

async def test_sequential_workflow_exact_once_effects(wf_env):
    shared = InMemoryStateStore("statestore")
    log = []
    rt = make_runtime(shared, log=log)
    await start_all(rt)
    try:
        inst = await rt.workflows.start("simple", 100)
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "completed" and status["result"] == 111
        assert log == [("add", 1), ("add", 2)]
        for seq in (1, 2):
            assert await shared.get(f"svc||eff||{inst}||{seq}") is not None
        history = await rt.workflows.history(inst)
        assert [e["t"] for e in history] == [
            "started", "activity_completed", "activity_completed", "completed"]
    finally:
        await shutdown(rt)


async def test_fanout_fanin(wf_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        inst = await rt.workflows.start("fanout", 7)
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "completed" and status["result"] == 21
    finally:
        await shutdown(rt)


async def test_saga_compensates_reverse_order(wf_env):
    log = []
    rt = make_runtime(InMemoryStateStore("statestore"), log=log)
    await start_all(rt)
    try:
        inst = await rt.workflows.start("order", 3)
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "failed"
        assert "card declined" in status["error"]
        assert [p for kind, p in log if kind == "release"] == [2, 1, 0]
        comp = [e for e in await rt.workflows.history(inst) if e["t"] == "compensated"]
        assert [e["idx"] for e in comp] == [2, 1, 0]
        assert all("error" not in e for e in comp)
    finally:
        await shutdown(rt)


async def test_orchestrator_can_catch_activity_error(wf_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        inst = await rt.workflows.start("fallback", None)
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "completed"
        assert status["result"]["fallback"] is True
        assert "card declined" in status["result"]["cause"]
    finally:
        await shutdown(rt)


async def test_child_workflows_fan_out(wf_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        inst = await rt.workflows.start("parent", None)
        status = await rt.workflows.wait(inst, timeout=10)
        assert status["status"] == "completed"
        assert status["result"] == [16, 61]
        # a child's id derives from its parent's: restarts find it again
        child = await rt.workflows.status(f"{inst}::c1")
        assert child["status"] == "completed" and child["parent"] == inst
    finally:
        await shutdown(rt)


async def test_external_event_and_duplicate_delivery(wf_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        inst = await rt.workflows.start("waiter", None)
        assert (await rt.workflows.status(inst))["status"] == "running"
        await rt.workflows.raise_event(inst, "go", data={"n": 1}, id="e-1")
        await rt.workflows.raise_event(inst, "go", data={"n": 1}, id="e-1")  # a duplicate
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "completed"
        assert status["result"] == {"got": {"n": 1}}
        history = await rt.workflows.history(inst)
        assert len([e for e in history if e["t"] == "event_raised"]) == 1
    finally:
        await shutdown(rt)


async def test_when_any_winner_is_replay_stable(wf_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        inst = await rt.workflows.start("racer", None)
        await rt.workflows.raise_event(inst, "b", data="b wins")
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "completed" and status["result"] == "b wins"
        # the loser landing later does not flip the verdict
        await rt.workflows.raise_event(inst, "a", data="a late")
        assert (await rt.workflows.status(inst))["result"] == "b wins"
    finally:
        await shutdown(rt)


async def test_durable_timer_and_deterministic_randomness(wf_env):
    """A timer suspends the instance across turns, so the orchestrator
    replays; the uuid drawn before it survives replay (the context's PRNG
    is seeded from the instance), and ctx.now() comes from history."""
    log = []
    rt = make_runtime(InMemoryStateStore("statestore"), log=log)
    await start_all(rt)
    try:
        t0 = time.time()
        inst = await rt.workflows.start("timed", "x")
        assert (await rt.workflows.status(inst))["status"] == "running"
        status = await adopt_until(rt, inst)
        assert status["status"] == "completed"
        u1, u2, wf_now = status["result"]
        rng = random_mod.Random(f"wf:timed:{inst}")
        assert u1 == str(uuid_mod.UUID(int=rng.getrandbits(128), version=4))
        assert u2 == str(uuid_mod.UUID(int=rng.getrandbits(128), version=4))
        assert t0 <= wf_now <= time.time()
        assert len([p for kind, p in log if kind == "orchestrate"]) >= 2
        history = await rt.workflows.history(inst)
        assert len([e for e in history if e["t"] == "timer_fired"]) == 1
    finally:
        await shutdown(rt)


async def test_nondeterminism_foreign_await_fails_cleanly(wf_env):
    log = []
    rt = make_runtime(InMemoryStateStore("statestore"), log=log)
    await start_all(rt)
    try:
        inst = await rt.workflows.start("rogue", None)
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "failed"
        assert "foreign awaitable" in status["error"]
        assert log == []  # failed at once, nothing compensated
    finally:
        await shutdown(rt)


async def test_unregistered_activity_fails_workflow(wf_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        inst = await rt.workflows.start("lost", None)
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "failed"
        assert "no-such-activity" in status["error"]
    finally:
        await shutdown(rt)


async def test_terminate_and_listing(wf_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        inst = await rt.workflows.start("waiter", None)
        await rt.workflows.terminate(inst, reason="operator said no")
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "terminated"
        assert status["error"] == "operator said no"
        assert [r["instance"] for r in await rt.workflows.list()] == [inst]
        with pytest.raises(WorkflowNotFound):
            await rt.workflows.status("no-such-instance")
    finally:
        await shutdown(rt)


async def test_history_gc_truncates_terminal_instances(wf_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    await start_all(rt)
    try:
        rt.app_channel.app.workflow_engine.retain_seconds = 0.1
        inst = await rt.workflows.start("simple", 1)
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "completed" and status["events"] == 4
        await asyncio.sleep(0.15)
        await rt.actors.sweep()  # fires the one-shot GC reminder
        status = await rt.workflows.status(inst)
        assert status["events"] == 1
        assert status["status"] == "completed" and status["result"] == 12
        assert (await rt.workflows.history(inst))[0]["t"] == "completed"
    finally:
        await shutdown(rt)


# -- the sidecar's routes --------------------------------------------------

async def test_sidecar_workflow_routes_gated_off(monkeypatch):
    monkeypatch.delenv("TASKSRUNNER_WORKFLOWS", raising=False)
    sc = Sidecar(make_runtime(InMemoryStateStore("statestore")), port=0)
    assert not any("/v1.0/workflows" in r.path for r in sc.router.table)


async def test_sidecar_registers_actor_routes_under_workflows_flag(wf_env, monkeypatch):
    """A replica that does not own an instance forwards its turns to the
    owner through the actor routes: the workflows flag alone opens them."""
    monkeypatch.delenv("TASKSRUNNER_ACTORS", raising=False)
    sc = Sidecar(make_runtime(InMemoryStateStore("statestore")), port=0)
    assert any("/v1.0/actors" in r.path for r in sc.router.table)


async def test_sidecar_workflow_api_end_to_end(wf_env):
    rt = make_runtime(InMemoryStateStore("statestore"))
    sc = Sidecar(rt, port=0)
    await sc.start()
    rt.app_channel.app.workflow_engine.drive_period = DRIVE
    try:
        async def call(method, path, body=None):
            status, _, raw = await http_request(
                "127.0.0.1", sc.port, method, path,
                body=b"" if body is None else json.dumps(body).encode())
            return status, (json.loads(raw) if raw else None)

        assert await call("POST", "/v1.0/workflows/engine/simple/start?instanceID=http-1",
                          100) == (200, {"instanceID": "http-1"})
        await rt.workflows.wait("http-1", timeout=5)
        status, doc = await call("GET", "/v1.0/workflows/engine/http-1")
        assert doc["status"] == "completed" and doc["result"] == 111
        status, doc = await call("GET", "/v1.0/workflows/engine/http-1/history")
        assert doc["history"][0]["t"] == "started"

        status, _ = await call("POST", "/v1.0/workflows/engine/waiter/start?instanceID=http-2")
        assert status == 200
        status, _ = await call(
            "POST", "/v1.0/workflows/engine/http-2/raiseEvent/go?eventID=e1", {"n": 2})
        assert status == 202
        assert (await rt.workflows.wait("http-2", timeout=5))["result"] == {"got": {"n": 2}}

        await call("POST", "/v1.0/workflows/engine/waiter/start?instanceID=http-3")
        status, _ = await call("POST", "/v1.0/workflows/engine/http-3/terminate",
                               {"reason": "done testing"})
        assert status == 202
        assert (await rt.workflows.wait("http-3", timeout=5))["status"] == "terminated"

        status, doc = await call("GET", "/v1.0/workflows")
        assert {r["instance"] for r in doc["instances"]} == {"http-1", "http-2", "http-3"}
        assert (await call("GET", "/v1.0/workflows/engine/ghost"))[0] == 404
    finally:
        await sc.stop()


# -- failover (replicas in this process) -----------------------------------

async def test_owner_crash_mid_run_replica_adopts(wf_env):
    """The owner dies between turns; the survivor adopts by its sweep and
    finishes the run."""
    shared = InMemoryStateStore("statestore")
    log = []
    r1, r2 = make_runtime(shared, log=log), make_runtime(shared, log=log)
    await start_all(r1, r2)
    try:
        inst = await r1.workflows.start("fanout", 5)  # completes in the start's pump
        inst2 = await r1.workflows.start("timed", None)  # blocked on its timer
        assert (await r1.workflows.status(inst2))["status"] == "running"
        r1.actors.simulate_crash()
        await asyncio.sleep(LEASE + 0.1)
        assert (await adopt_until(r2, inst2))["status"] == "completed"
        assert (await r2.workflows.status(inst))["status"] == "completed"
    finally:
        await shutdown(r2, r1)


async def test_crash_mid_activity_rf3_exactly_once(wf_env, tmp_path, monkeypatch):
    """The owner dies inside an activity (its body calls simulate_crash()
    and never returns, as a killed process never does) over a 3-member
    replica set. The survivor adopts after the lease, replay goes on from
    the committed prefix, every effect is stored once, the compensations
    run once each in reverse order; with the store's leader then crashed,
    no acknowledged effect is lost."""
    monkeypatch.setenv("TASKSRUNNER_REPL_LEASE_SECONDS", "0.4")
    store = build_replicated_store("statestore", tmp_path / "wf.db", replicas=3)
    log = []
    felled = asyncio.Event()

    async def fell_on_second(actx, data):
        if data["i"] == 1 and not felled.is_set():
            felled.set()
            r1.actors.simulate_crash()
            await asyncio.Event().wait()  # dead: this attempt never ends

    r1 = make_runtime(store, log=log, crash=fell_on_second)
    r2 = make_runtime(store, log=log)
    await start_all(r1, r2)
    started0 = metrics.get("workflow_started_total", workflow="order")
    comp0 = metrics.get("workflow_compensation_total", workflow="order")
    inst = "drill-1"
    owner = asyncio.create_task(r1.workflows.start("order", 3, instance=inst))
    try:
        await asyncio.wait_for(felled.wait(), 5)
        assert r1.actors.crashed and not owner.done()
        record_key = f"svc||actor-rec||{WORKFLOW_ACTOR_TYPE}||{inst}"
        dead_epoch = (await store.get(record_key)).value["epoch"]
        # the committed prefix: one reserve
        assert (await r2.workflows.status(inst))["status"] == "running"
        history = await r2.workflows.history(inst)
        assert [e["seq"] for e in history if e["t"] == "activity_completed"] == [1]
        await asyncio.sleep(LEASE + 0.1)
        status = await adopt_until(r2, inst)
        assert status["status"] == "failed" and "card declined" in status["error"]
        # the felled attempt stored nothing; the adopter ran it again
        assert sorted(p for k, p in log if k == "reserve") == [0, 1, 2]
        assert [p for k, p in log if k == "release"] == [2, 1, 0]
        history = await r2.workflows.history(inst)
        assert [e["seq"] for e in history if e["t"] == "activity_completed"] == [1, 2, 3]
        assert [e["idx"] for e in history if e["t"] == "compensated"] == [2, 1, 0]
        assert metrics.get("workflow_started_total", workflow="order") == started0 + 1
        assert metrics.get("workflow_compensation_total", workflow="order") == comp0 + 3
        assert (await store.get(record_key)).value["epoch"] > dead_epoch
        # every effect once, on the set's leader and after it is lost
        effects = sorted(k for k in await store.keys(prefix="svc||")
                         if k.split("||")[1] in ("res", "rel"))
        assert effects == sorted(f"svc||{p}||{inst}||{i}" for p in ("res", "rel")
                                 for i in range(3))
        leader = next(n for n in store.nodes if n.node_id == store.leader_member())
        leader.crash()
        lost = [k for k in effects if await store.get(k) is None]
        assert lost == [], f"acknowledged effects lost after the leader's crash: {lost}"
        history = await r2.workflows.history(inst)
        assert [e["seq"] for e in history if e["t"] == "activity_completed"] == [1, 2, 3]
        assert history[-1]["t"] == "failed"
    finally:
        owner.cancel()
        with pytest.raises(asyncio.CancelledError):
            await owner
        await shutdown(r2, r1)
        await store.aclose()


# -- the cross-process kill -9 drill ---------------------------------------

_KILL9_CHILD = '''
import asyncio, os, sys

os.environ["TASKSRUNNER_WORKFLOWS"] = "1"
os.environ["TASKSRUNNER_ACTOR_LEASE_SECONDS"] = "0.5"
os.environ["TASKSRUNNER_ACTOR_REMINDER_POLL_SECONDS"] = "30"

from tasksrunner_torch.app import App
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.runtime import InProcAppChannel, Runtime


def build():
    app = App("svc")

    @app.workflow("steps")
    async def steps(ctx, n):
        total = 0
        for i in range(n):
            total += await ctx.call_activity("slowstep", {"i": i})
        return total

    @app.activity("slowstep")
    async def slowstep(actx, data):
        actx.stage_effect(f"eff||{actx.instance}||{actx.seq}", data)
        print(f"STEP {actx.seq}", flush=True)
        await asyncio.sleep(0.05)
        return 1

    return app


async def main():
    spec = ComponentSpec(name="statestore", type="state.sqlite",
                         metadata={"databasePath": sys.argv[1]})
    rt = Runtime("svc", ComponentRegistry([spec], app_id="svc"),
                 app_channel=InProcAppChannel(build()))
    await rt.start()
    rt.actors.lease_seconds = 0.5
    rt.app_channel.app.workflow_engine.drive_period = 0.2
    print("READY", flush=True)
    await rt.workflows.start("steps", 12, instance="xproc-1")
    await asyncio.sleep(60)  # killed long before this


asyncio.run(main())
'''


def steps_app():
    app = build_app()

    @app.workflow("steps")
    async def steps(ctx, n):
        total = 0
        for i in range(n):
            total += await ctx.call_activity("slowstep", {"i": i})
        return total

    @app.activity("slowstep")
    async def slowstep(actx, data):
        actx.stage_effect(f"eff||{actx.instance}||{actx.seq}", data)
        return 1

    return app


async def kill9_owner_after(script: str, db, steps: int):
    """A child process running ``script`` over ``db``, killed with SIGKILL
    once it printed ``STEP steps``."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    child = await asyncio.create_subprocess_exec(
        sys.executable, "-c", script, str(db), stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT, env=env)
    try:
        seen = 0
        while seen < steps:
            line = (await asyncio.wait_for(child.stdout.readline(), 60)).decode().strip()
            assert line or child.returncode is None, "the child ended before its steps"
            if line.startswith("STEP "):
                seen = int(line.split()[1])
    finally:
        child.kill()
        await child.wait()


async def test_kill9_workflow_owner_history_continuity(wf_env, tmp_path):
    """``kill -9`` of the process that owns a running workflow, mid-activity,
    over a shared sqlite file: this replica adopts it and finishes it, with
    one contiguous history without duplicates."""
    db = tmp_path / "wf.db"
    await kill9_owner_after(_KILL9_CHILD, db, 3)
    spec = ComponentSpec(name="statestore", type="state.sqlite",
                         metadata={"databasePath": str(db)})
    reg = ComponentRegistry([spec], app_id="svc")
    rt = Runtime("svc", reg, app_channel=InProcAppChannel(steps_app()))
    await rt.start()
    rt.actors.lease_seconds = LEASE
    rt.app_channel.app.workflow_engine.drive_period = DRIVE
    try:
        status = await adopt_until(rt, "xproc-1", timeout=15.0)
        assert status["status"] == "completed" and status["result"] == 12
        history = await rt.workflows.history("xproc-1")
        seqs = [e["seq"] for e in history if e["t"] == "activity_completed"]
        assert seqs == list(range(1, 13)), seqs
        assert len([e for e in history if e["t"] == "started"]) == 1
        store = reg.get("statestore")
        for seq in range(1, 13):
            assert await store.get(f"svc||eff||xproc-1||{seq}") is not None
        record = await store.get(f"svc||actor-rec||{WORKFLOW_ACTOR_TYPE}||xproc-1")
        assert int(record.value["epoch"]) >= 2
    finally:
        await shutdown(rt)


# -- the tasks tracker sample's scenarios ----------------------------------

CARD_LIMIT = 500.0
SAMPLE_APP_ID = "tasksmanager-backend-api"


def register_workflows(app, tasks) -> None:
    """A copy of ``samples/tasks_tracker/backend_api/workflows.py``'s
    ``register_workflows`` on the port's ``App`` and ``RetrySpec``."""

    @app.workflow("checkout")
    async def checkout(ctx, order):
        order = dict(order or {})
        order_id = order.get("orderId") or ctx.uuid4()
        for item in order.get("items", []):
            stock = await ctx.call_activity("reserve-stock", {"orderId": order_id, "item": item})
            ctx.register_compensation("release-stock", stock)
        receipt = await ctx.call_activity(
            "charge-card", {"orderId": order_id, "amount": order.get("amount", 0)})
        ctx.register_compensation("refund-card", receipt)
        await ctx.call_activity("send-confirmation", {"orderId": order_id, "placedAt": ctx.now()})
        return {"orderId": order_id, "receipt": receipt}

    @app.activity("reserve-stock")
    async def reserve_stock(actx, data):
        actx.stage_effect(f"checkout||{data['orderId']}||reserved||{data['item']}", data)
        return data

    @app.activity("release-stock")
    async def release_stock(actx, data):
        actx.stage_effect(f"checkout||{data['orderId']}||reserved||{data['item']}",
                          operation="delete")
        return data["item"]

    @app.activity("charge-card", retry=RetrySpec(policy="exponential", duration=0.05,
                                                 max_retries=3), timeout=10.0)
    async def charge_card(actx, data):
        amount = float(data.get("amount") or 0)
        if amount > CARD_LIMIT:
            raise RuntimeError(f"card declined: {amount} exceeds limit {CARD_LIMIT}")
        receipt = {"orderId": data["orderId"], "amount": amount, "attempt": actx.attempt}
        actx.stage_effect(f"checkout||{data['orderId']}||charge", receipt)
        return receipt

    @app.activity("refund-card")
    async def refund_card(actx, receipt):
        actx.stage_effect(f"checkout||{receipt['orderId']}||charge", operation="delete")
        actx.stage_effect(f"checkout||{receipt['orderId']}||refund", receipt)
        return receipt["orderId"]

    @app.activity("send-confirmation")
    async def send_confirmation(actx, data):
        actx.stage_effect(f"checkout||{data['orderId']}||confirmation", data)
        return data["orderId"]

    @app.workflow("overdue-escalation")
    async def overdue_escalation(ctx, req):
        req = dict(req or {})
        task_id = req["taskId"]
        interval = float(req.get("intervalSeconds", 3600.0))
        levels = int(req.get("maxLevels", 3))
        for level in range(1, levels + 1):
            await ctx.sleep(interval)
            task = await ctx.call_activity("check-task", task_id)
            if task is None or task.get("isCompleted"):
                return {"taskId": task_id, "outcome": "completed", "nags": level - 1}
            await ctx.call_activity("escalate", {"taskId": task_id, "level": level,
                                                 "at": ctx.now()})
        await ctx.call_activity("mark-task-overdue", {"taskId": task_id})
        return {"taskId": task_id, "outcome": "overdue", "nags": levels}

    @app.activity("check-task")
    async def check_task(actx, task_id):
        task = await tasks().get_task_by_id(task_id)
        return None if task is None else dict(task)

    @app.activity("escalate")
    async def escalate(actx, data):
        actx.stage_effect(f"escalation||{data['taskId']}||{data['level']}", data)
        return data["level"]

    @app.activity("mark-task-overdue")
    async def mark_task_overdue(actx, doc):
        await tasks().mark_overdue_tasks([doc])
        actx.stage_effect(f"overdue||{doc['taskId']}", doc)
        return doc["taskId"]

    @app.workflow("overdue-sweep")
    async def overdue_sweep(ctx, _req):
        due = await ctx.call_activity("collect-due-tasks", None)
        marked = await ctx.when_all([ctx.call_activity("mark-task-overdue", doc)
                                     for doc in due])
        return {"swept": len(marked), "taskIds": marked}

    @app.activity("collect-due-tasks")
    async def collect_due_tasks(actx, _data):
        return [dict(t) for t in await tasks().get_yesterdays_due_tasks()]


def _yesterday() -> str:
    """The sample's date format, for yesterday's midnight."""
    midnight = (dt.datetime.now() - dt.timedelta(days=1)).replace(
        hour=0, minute=0, second=0, microsecond=0)
    return midnight.strftime("%Y-%m-%dT%H:%M:%S")


class FakeTasks:
    """The part of the sample's ``FakeTasksManager`` its workflows call,
    each task its JSON document."""

    def __init__(self) -> None:
        self.tasks: dict[str, dict] = {}

    async def create_new_task(self, doc: dict) -> str:
        task_id = uuid_mod.uuid4().hex
        self.tasks[task_id] = {"taskId": task_id, "taskName": doc["taskName"],
                               "taskCreatedBy": doc["taskCreatedBy"],
                               "taskDueDate": doc.get("taskDueDate", ""),
                               "isCompleted": False, "isOverDue": False}
        return task_id

    async def get_task_by_id(self, task_id: str) -> dict | None:
        return self.tasks.get(task_id)

    async def mark_task_completed(self, task_id: str) -> None:
        self.tasks[task_id]["isCompleted"] = True

    async def get_yesterdays_due_tasks(self) -> list[dict]:
        return [t for t in self.tasks.values()
                if t["taskDueDate"] == _yesterday() and not t["isCompleted"]]

    async def mark_overdue_tasks(self, docs: list[dict]) -> None:
        for doc in docs:
            if doc.get("taskId") in self.tasks:
                self.tasks[doc["taskId"]]["isOverDue"] = True


async def test_sample_tasks_tracker_scenarios(wf_env):
    """The sample's three workflows end to end: the checkout saga (paid,
    and declined with its compensation), the reminder-driven overdue
    escalation (nagging to overdue, and standing down), and the fan-out
    sweep."""
    manager = FakeTasks()
    app = App(SAMPLE_APP_ID)
    register_workflows(app, lambda: manager)
    shared = InMemoryStateStore("statestore")
    rt = make_runtime(shared, app_id=SAMPLE_APP_ID, app=app)
    await start_all(rt)
    key = f"{SAMPLE_APP_ID}||"
    try:
        # 1. the saga, paid: every effect stored
        inst = await rt.workflows.start("checkout", {"items": ["tea", "mug"], "amount": 42.0},
                                        instance="ord-ok")
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "completed"
        order_id = status["result"]["orderId"]
        assert status["result"]["receipt"]["amount"] == 42.0
        for item in ("tea", "mug"):
            assert await shared.get(f"{key}checkout||{order_id}||reserved||{item}") is not None
        assert await shared.get(f"{key}checkout||{order_id}||charge") is not None
        assert await shared.get(f"{key}checkout||{order_id}||confirmation") is not None

        # 2. the saga, declined: the reservation deleted again, no charge
        inst = await rt.workflows.start(
            "checkout", {"items": ["tv"], "amount": 9000.0, "orderId": "bigspender"},
            instance="ord-declined")
        status = await rt.workflows.wait(inst, timeout=5)
        assert status["status"] == "failed" and "card declined" in status["error"]
        assert await shared.get(f"{key}checkout||bigspender||reserved||tv") is None
        assert await shared.get(f"{key}checkout||bigspender||charge") is None
        comp = [e for e in await rt.workflows.history(inst) if e["t"] == "compensated"]
        assert [c["name"] for c in comp] == ["release-stock"]

        # 3. escalation: never completed, so nagged, then overdue
        task_id = await manager.create_new_task({"taskName": "file taxes",
                                                 "taskCreatedBy": "sam@tasks.dev"})
        inst = await rt.workflows.start(
            "overdue-escalation", {"taskId": task_id, "intervalSeconds": 0.05, "maxLevels": 2},
            instance="esc-1")
        status = await adopt_until(rt, inst)
        assert status["status"] == "completed"
        assert status["result"] == {"taskId": task_id, "outcome": "overdue", "nags": 2}
        assert manager.tasks[task_id]["isOverDue"]
        for level in (1, 2):
            assert await shared.get(f"{key}escalation||{task_id}||{level}") is not None

        # 4. escalation stands down for a task completed in time
        task2 = await manager.create_new_task({"taskName": "water plants",
                                               "taskCreatedBy": "sam@tasks.dev"})
        await manager.mark_task_completed(task2)
        inst = await rt.workflows.start(
            "overdue-escalation", {"taskId": task2, "intervalSeconds": 0.05, "maxLevels": 3},
            instance="esc-2")
        status = await adopt_until(rt, inst)
        assert status["status"] == "completed"
        assert status["result"]["outcome"] == "completed" and status["result"]["nags"] == 0

        # 5. the fan-out sweep over yesterday's due tasks
        due_ids = [await manager.create_new_task(
            {"taskName": f"due-{i}", "taskCreatedBy": "sam@tasks.dev",
             "taskDueDate": _yesterday()}) for i in range(3)]
        inst = await rt.workflows.start("overdue-sweep", None, instance="sweep-1")
        status = await rt.workflows.wait(inst, timeout=8)
        assert status["status"] == "completed" and status["result"]["swept"] == 3
        assert sorted(status["result"]["taskIds"]) == sorted(due_ids)
        for tid in due_ids:
            assert manager.tasks[tid]["isOverDue"]
            assert await shared.get(f"{key}overdue||{tid}") is not None
    finally:
        await shutdown(rt)
