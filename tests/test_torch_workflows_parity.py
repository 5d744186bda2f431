"""The port's workflows against the JAX package's, on the CPU in one process:
one script of workflows (sequential, fan-out, the saga, a caught failure,
children, an external event, ``when_any``, a durable timer drawing
``ctx.random``/``ctx.uuid4``), a termination and a history's GC on each
package over its own sqlite file, compared by results, status documents,
histories (``t``, ``seq``, ``name``, ``result``, ``error``) and every
stored key (timestamps, pids, replica ids and etags left out); an
instance one package owns, crashed after a committed prefix and adopted by
the other package's runtime over the same file, both ways; and the
workflow routes' statuses and bodies and the ``workflows`` verb."""

import asyncio
import json
import random
import time
import types
import uuid

import pytest

from tasksrunner import cli as jax_cli
from tasksrunner.app import App as JaxApp
from tasksrunner.component.registry import ComponentRegistry as JaxRegistry
from tasksrunner.component.spec import ComponentSpec as JaxSpec
from tasksrunner.errors import ActivityError as JaxActivityError
from tasksrunner.runtime import InProcAppChannel as JaxChannel, Runtime as JaxRuntime
from tasksrunner.sidecar import Sidecar as JaxSidecar

from tasksrunner_torch import cli
from tasksrunner_torch.app import App
from tasksrunner_torch.client import http_request
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import ActivityError
from tasksrunner_torch.invoke.resolver import AppAddress, NameResolver
from tasksrunner_torch.runtime import InProcAppChannel, Runtime
from tasksrunner_torch.sidecar import Sidecar

from test_torch_actors_parity import _Loop, normal, store_rows, verb

LEASE = 0.25
DRIVE = 0.1
PACKAGES = {
    "jax": types.SimpleNamespace(App=JaxApp, Registry=JaxRegistry, Spec=JaxSpec,
                                 Runtime=JaxRuntime, Channel=JaxChannel, Sidecar=JaxSidecar,
                                 ActivityError=JaxActivityError),
    "port": types.SimpleNamespace(App=App, Registry=ComponentRegistry, Spec=ComponentSpec,
                                  Runtime=Runtime, Channel=InProcAppChannel, Sidecar=Sidecar,
                                  ActivityError=ActivityError),
}
TERMINAL = ("completed", "failed", "terminated")


@pytest.fixture
def wf_env(monkeypatch, tmp_path):
    monkeypatch.setenv("TASKSRUNNER_FLIGHTREC_DIR", str(tmp_path / "flightrec"))
    monkeypatch.setenv("TASKSRUNNER_WORKFLOWS", "1")
    monkeypatch.setenv("TASKSRUNNER_ACTOR_LEASE_SECONDS", "5")
    monkeypatch.setenv("TASKSRUNNER_ACTOR_REMINDER_POLL_SECONDS", "30")


def workflow_app(pkg, *, crash=None):
    """The scenarios on ``pkg``'s App. ``crash(actx)``, when given, runs
    first in every ``step`` activity."""
    app = pkg.App("svc")

    @app.workflow("simple")
    async def simple(ctx, inp):
        a = await ctx.call_activity("add", {"x": inp, "y": 1})
        return await ctx.call_activity("add", {"x": a, "y": 10})

    @app.activity("add")
    async def add(actx, data):
        actx.stage_effect(f"eff||{actx.instance}||{actx.seq}", data)
        return data["x"] + data["y"]

    @app.workflow("fanout")
    async def fanout(ctx, n):
        return sum(await ctx.when_all([ctx.call_activity("add", {"x": i, "y": i})
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
        actx.stage_effect(f"res||{actx.instance}||{data['i']}", data)
        return data["i"]

    @app.activity("release")
    async def release(actx, data):
        actx.stage_effect(f"res||{actx.instance}||{data['i']}", operation="delete")
        return data["i"]

    @app.activity("charge")
    async def charge(actx, data):
        raise RuntimeError(f"card declined on attempt {actx.attempt}")

    @app.workflow("fallback")
    async def fallback(ctx, inp):
        try:
            return await ctx.call_activity("charge", None)
        except pkg.ActivityError as exc:
            return {"fallback": True, "cause": str(exc)}

    @app.workflow("parent")
    async def parent(ctx, inp):
        return await ctx.when_all([ctx.call_child("simple", 5), ctx.call_child("simple", 50)])

    @app.workflow("waiter")
    async def waiter(ctx, inp):
        return {"got": await ctx.wait_event("go")}

    @app.workflow("racer")
    async def racer(ctx, inp):
        winner = await ctx.when_any([ctx.wait_event("a"), ctx.wait_event("b")])
        return winner.value

    @app.workflow("timed")
    async def timed(ctx, inp):
        draws = [ctx.uuid4(), round(ctx.random(), 12)]
        await ctx.sleep(0.15)
        return draws + [ctx.uuid4()]

    @app.workflow("steps")
    async def steps(ctx, n):
        total = 0
        for i in range(n):
            total += await ctx.call_activity("step", {"i": i})
        return total

    @app.activity("step")
    async def step(actx, data):
        if crash is not None:
            await crash(actx)
        actx.stage_effect(f"eff||{actx.instance}||{actx.seq}", data)
        return 1

    return app


def runtime(pkg, db, *, crash=None):
    spec = pkg.Spec(name="statestore", type="state.sqlite", metadata={"databasePath": str(db)})
    return pkg.Runtime("svc", pkg.Registry([spec], app_id="svc"),
                       app_channel=pkg.Channel(workflow_app(pkg, crash=crash)))


async def start(rt, lease=LEASE):
    await rt.start()
    rt.actors.lease_seconds = lease
    rt.app_channel.app.workflow_engine.drive_period = DRIVE


async def stop(*rts):
    for rt in rts:
        if rt.workflows is not None:
            rt.workflows.detach()
            rt.workflows = None
        if rt.actors is not None:
            await rt.actors.stop()
            rt.actors = None
    for rt in rts:
        await rt.stop()


async def until_terminal(rt, instance, timeout=10.0) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        await rt.actors.sweep()
        status = await rt.workflows.status(instance)
        if status["status"] in TERMINAL:
            return status
        assert time.monotonic() < deadline, f"{instance} never ended: {status}"
        await asyncio.sleep(0.05)


def projected(history: list[dict]) -> list[tuple]:
    return [tuple(e.get(k) for k in ("t", "seq", "name", "result", "error")) for e in history]


SCRIPT = [("simple", 100, "s-1"), ("fanout", 6, "f-1"), ("order", 3, "o-1"),
          ("fallback", None, "fb-1"), ("parent", None, "p-1"), ("waiter", None, "w-1"),
          ("racer", None, "r-1"), ("timed", None, "t-1"), ("waiter", None, "w-2")]


async def _workflow_script(pkg, db) -> dict:
    rt = runtime(pkg, db)
    await start(rt, lease=5.0)  # no lease lapses between turns, however slow the host
    out = {"statuses": {}, "histories": {}, "results": []}
    try:
        for name, inp, inst in SCRIPT:
            out["results"].append(await rt.workflows.start(name, inp, instance=inst))
        out["results"].append(await rt.workflows.raise_event("w-1", "go", data={"n": 1}, id="e1"))
        out["results"].append(await rt.workflows.raise_event("w-1", "go", data={"n": 1}, id="e1"))
        await rt.workflows.raise_event("r-1", "b", data="b wins")
        await rt.workflows.raise_event("r-1", "a", data="a late")
        out["results"].append(await rt.workflows.terminate("w-2", reason="operator said no"))
        for _, _, inst in SCRIPT:
            await until_terminal(rt, inst)
        # GC: a terminal instance's history cut to its last event
        rt.app_channel.app.workflow_engine.retain_seconds = 0.1
        await rt.workflows.start("simple", 1, instance="gc-1")
        await until_terminal(rt, "gc-1")
        await asyncio.sleep(0.15)
        await rt.actors.sweep()
        instances = [inst for _, _, inst in SCRIPT] + ["p-1::c1", "p-1::c2", "gc-1"]
        for inst in instances:
            out["statuses"][inst] = normal(await rt.workflows.status(inst))
            history = projected(await rt.workflows.history(inst))
            # the two children's completions reach the parent in either order
            out["histories"][inst] = sorted(history, key=repr) if inst == "p-1" else history
        # the list is in order of creation: the two children start at once
        out["list"] = sorted(normal(await rt.workflows.list()), key=lambda r: r["instance"])
    finally:
        await stop(rt)
    return out


async def test_scripted_workflows_equal_the_jax_ones(wf_env, tmp_path):
    runs = {name: await _workflow_script(pkg, tmp_path / f"{name}.db")
            for name, pkg in PACKAGES.items()}
    assert runs["port"]["results"] == runs["jax"]["results"]
    assert runs["port"]["statuses"] == runs["jax"]["statuses"]
    assert runs["port"]["histories"] == runs["jax"]["histories"]
    assert runs["port"]["list"] == runs["jax"]["list"]
    statuses = runs["port"]["statuses"]
    assert [statuses[i]["status"] for _, _, i in SCRIPT] == [
        "completed", "completed", "failed", "completed", "completed", "completed",
        "completed", "completed", "terminated"]
    assert (statuses["s-1"]["result"], statuses["f-1"]["result"],
            statuses["p-1"]["result"], statuses["r-1"]["result"]) == (111, 30, [16, 61], "b wins")
    rng = random.Random("wf:timed:t-1")
    first = str(uuid.UUID(int=rng.getrandbits(128), version=4))
    assert statuses["t-1"]["result"][:2] == [first, round(rng.random(), 12)]
    assert statuses["gc-1"]["events"] == 1
    rows = {name: store_rows(tmp_path / f"{name}.db") for name in PACKAGES}
    for name in PACKAGES:
        # the children's completions reach the parent in either order; and
        # the parent asks for a child's start on each of its turns until the
        # child answers, so two starts of one child can be in flight at once:
        # a replica then fences its own first activation, in either package,
        # one epoch up, as the timing falls
        rows[name]["svc||actor-rec||_Workflow||p-1"]["data"]["history"].sort(key=repr)
        for child in ("p-1::c1", "p-1::c2"):
            for kind in ("rec", "place"):
                rows[name][f"svc||actor-{kind}||_Workflow||{child}"].pop("epoch")
    assert rows["port"] == rows["jax"]
    assert not any(k.startswith("svc||res||o-1") for k in rows["port"])  # compensated
    assert rows["port"]["svc||eff||s-1||2"] == {"x": 101, "y": 10}


@pytest.mark.parametrize("owner, adopter", [("jax", "port"), ("port", "jax")])
async def test_an_instance_crashed_in_one_package_is_adopted_by_the_other(
        wf_env, tmp_path, owner, adopter):
    """The owner commits three steps, then dies inside the fourth (its
    body calls simulate_crash() and never returns). The other package's
    runtime on the same sqlite file adopts the instance after the lease
    and finishes it: one contiguous history, every effect stored once,
    the record's epoch above the dead owner's."""
    db = tmp_path / "shared.db"
    felled = asyncio.Event()

    async def fell_fourth(actx):
        if actx.seq == 4 and not felled.is_set():
            felled.set()
            first.actors.simulate_crash()
            await asyncio.Event().wait()  # dead: this attempt never ends

    first = runtime(PACKAGES[owner], db, crash=fell_fourth)
    second = runtime(PACKAGES[adopter], db)
    await start(first)
    await start(second)
    owned = asyncio.create_task(first.workflows.start("steps", 8, instance="x-1"))
    try:
        await asyncio.wait_for(felled.wait(), 10)
        dead_epoch = store_rows(db)["svc||actor-rec||_Workflow||x-1"]["epoch"]
        history = await second.workflows.history("x-1")
        assert [e["seq"] for e in history if e["t"] == "activity_completed"] == [1, 2, 3]
        await asyncio.sleep(LEASE + 0.05)
        status = await until_terminal(second, "x-1")
        assert (status["status"], status["result"]) == ("completed", 8)
        history = await second.workflows.history("x-1")
        assert [e["seq"] for e in history if e["t"] == "activity_completed"] == list(range(1, 9))
        assert [e["t"] for e in history].count("started") == 1
        rows = store_rows(db)
        assert sorted(k for k in rows if k.startswith("svc||eff||x-1||")) == sorted(
            f"svc||eff||x-1||{seq}" for seq in range(1, 9))
        assert rows["svc||actor-rec||_Workflow||x-1"]["epoch"] > dead_epoch
        assert ("_Workflow", "x-1") in second.actors._activations
    finally:
        owned.cancel()
        with pytest.raises(asyncio.CancelledError):
            await owned
        await stop(second, first)


# -- the routes and the verb -----------------------------------------------

ROUTES = [
    ("POST", "/v1.0/workflows/engine/simple/start?instanceID=h-1", 100),
    ("POST", "/v1.0/workflows/engine/nope/start?instanceID=h-0", None),
    ("POST", "/v1.0/workflows/engine/waiter/start?instanceID=h-2", None),
    ("POST", "/v1.0/workflows/engine/waiter/start?instanceID=h-3", None),
    ("WAIT", "h-1", None),
    ("GET", "/v1.0/workflows/engine/h-1", None),
    ("GET", "/v1.0/workflows/engine/h-1/history", None),
    ("POST", "/v1.0/workflows/engine/h-2/raiseEvent/go?eventID=e1", {"n": 2}),
    ("POST", "/v1.0/workflows/engine/h-3/terminate", {"reason": "done testing"}),
    ("POST", "/v1.0/workflows/engine/h-3/terminate", None),
    ("WAIT", "h-2", None),
    ("GET", "/v1.0/workflows/engine/h-2", None),
    ("GET", "/v1.0/workflows/engine/h-3/history", None),
    ("GET", "/v1.0/workflows/engine/ghost", None),
    ("GET", "/v1.0/workflows/engine/ghost/history", None),
    ("POST", "/v1.0/workflows/engine/ghost/raiseEvent/go", None),
    ("POST", "/v1.0/workflows/engine/simple/start", b"{"),
    ("GET", "/v1.0/workflows", None),
    ("PUT", "/v1.0/actors/_Workflow/h-1/method/step", None),
]


async def _drive(sidecar) -> list:
    out = []
    for method, path, body in ROUTES:
        if method == "WAIT":
            out.append(normal(await until_terminal(sidecar.runtime, path)))
            continue
        raw = body if isinstance(body, bytes) else (
            b"" if body is None else json.dumps(body).encode())
        status, _, reply = await http_request("127.0.0.1", sidecar.port, method, path, body=raw)
        out.append((method, path, status, normal(json.loads(reply)) if reply else None))
    return out


def test_workflow_routes_and_verb_equal_the_jax_ones(wf_env, tmp_path, capsys):
    loop = _Loop()
    sidecars, started = {}, []
    try:
        answers = {}
        for name, pkg in PACKAGES.items():
            sidecars[name] = pkg.Sidecar(runtime(pkg, tmp_path / f"{name}.db"), port=0)
            loop.run(sidecars[name].start())
            started.append(sidecars[name])
            sidecars[name].runtime.app_channel.app.workflow_engine.drive_period = DRIVE
            answers[name] = loop.run(_drive(sidecars[name]))
        assert answers["port"] == answers["jax"]
        assert [a[2] for a in answers["port"] if isinstance(a, tuple)] == [
            200, 500, 200, 200, 200, 200, 202, 202, 202, 200, 200, 404, 404, 500, 400, 200, 200]
        for name, sc in sidecars.items():
            registry = tmp_path / f"{name}-apps.json"
            NameResolver(registry_file=registry).register(AppAddress(
                app_id="svc", host="127.0.0.1", sidecar_port=sc.port))
            reg = ["--app-id", "svc", "--registry-file", str(registry)]
            for extra in ([], ["--json"], ["h-1"], ["h-1", "--history"], ["h-3", "--json"],
                          ["ghost"], ["--terminate"]):
                argv = ["workflows", *extra, *reg]
                want = verb(jax_cli.main, argv, capsys)
                assert verb(cli.main, argv, capsys) == want, argv
            # the verbs that change state, each on an instance of its own
            for who, main in (("jax", jax_cli.main), ("port", cli.main)):
                inst = f"v-{name}-{who}"
                outs = [verb(main, ["workflows", *argv, *reg], capsys) for argv in (
                    [inst, "--start", "waiter"],
                    [inst, "--raise-event", "go", "--input", '{"k": 1}'],
                    [inst, "--terminate", "--reason", "late"],
                    [inst])]
                outs = [(code, text.replace(inst, "<inst>")) for code, text in outs]
                if who == "jax":
                    want = outs
                else:
                    assert outs == want
            assert want[0][0] == 0 and '"status": "completed"' in want[-1][1]
    finally:
        for sc in reversed(started):
            loop.run(sc.stop())
        loop.close()
