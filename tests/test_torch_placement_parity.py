"""The port's elastic placement against the JAX package's, on the CPU in one
process: the placement map, the heat tracker on an injected clock, the
planning helpers on seeded heat documents, the online split and the
key-streaming migration under concurrent writers, the stale-epoch 409 of
both sidecars, the placement loop's merge, ``/admin/placement`` and the
``shards`` verb. Maps, rankings, plans, documents, statuses, headers and
stored contents are compared exactly; the verbs' output with the sweep's
clock time masked."""

import asyncio
import json
import logging
import random
import re
import threading
import types
from pathlib import Path

import numpy as np
import pytest

from tasksrunner import cli as jax_cli
from tasksrunner.component.registry import ComponentRegistry as JaxRegistry
from tasksrunner.component.spec import parse_component as jax_parse_component
from tasksrunner.orchestrator.admin import AdminServer as JaxAdminServer
from tasksrunner.orchestrator.placement import PlacementController as JaxController
from tasksrunner.runtime import Runtime as JaxRuntime
from tasksrunner.sidecar import Sidecar as JaxSidecar
from tasksrunner.state import placement as jax_placement
from tasksrunner.state import sqlite as jax_sqlite

from tasksrunner_torch import cli
from tasksrunner_torch.client import http_request
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import parse_component
from tasksrunner_torch.invoke.resolver import NameResolver
from tasksrunner_torch.orchestrator.admin import AdminServer
from tasksrunner_torch.orchestrator.placement import PlacementController
from tasksrunner_torch.runtime import Runtime
from tasksrunner_torch.sidecar import Sidecar
from tasksrunner_torch.state import placement
from tasksrunner_torch.state import sqlite as port_sqlite
from tasksrunner_torch.state.sharding import ShardRouter

HEADER = placement.PLACEMENT_EPOCH_HEADER
PACKAGES = {"jax": (jax_sqlite, jax_placement), "port": (port_sqlite, placement)}


# -- the map, the tracker and the planning -------------------------------------

def test_placement_maps_and_docs_equal_the_jax_ones():
    got, want = placement.PlacementMap(shards=4), jax_placement.PlacementMap(shards=4)
    steps = [("advanced", {"assignment": {2: "hostB"}}),
             ("with_migration", {"migration": {"phase": "catchup", "shard": 1}}),
             ("advanced", {"shards": 5, "assignment": {4: "hostC"}}),
             ("with_migration", {"migration": None})]
    for method, kwargs in steps:
        got = getattr(got, method)(**kwargs)
        want = getattr(want, method)(**kwargs)
        assert got.to_doc() == want.to_doc()
    assert got.to_doc()["epoch"] == 3
    doc = {"shards": 3, "epoch": 7, "assignment": {"0": "r1"}, "migration": {"phase": "flip"}}
    assert placement.PlacementMap.from_doc(doc).to_doc() == \
        jax_placement.PlacementMap.from_doc(doc).to_doc() == doc
    with pytest.raises(Exception, match="needs >= 1 shard"):
        placement.PlacementMap(shards=0)


def test_the_heat_tracker_on_an_injected_clock_equals_the_jax_one(monkeypatch):
    """One seeded stream of writes (a few hot keys, a long tail, quiet
    spells) into both trackers, each on its own copy of one fake clock,
    with the threshold and the hysteresis window that both packages read
    from the environment; every sample's rates, the hot shards and the
    snapshot equal."""
    monkeypatch.setenv("TASKSRUNNER_RESHARD_HEAT_THRESHOLD", "20")
    monkeypatch.setenv("TASKSRUNNER_RESHARD_HYSTERESIS_SECONDS", "2")
    rng = np.random.default_rng(20)
    clocks = {"jax": [0.0], "port": [0.0]}
    trackers = {name: mod.ShardHeatTracker(4, clock=lambda c=clocks[name]: c[0])
                for name, (_, mod) in PACKAGES.items()}
    hot_seen = set()
    for step in range(40):
        writes = int(rng.integers(0, 400)) if step % 9 < 6 else 0
        shards = rng.integers(0, 4, writes)
        keys = [f"hot-{k}" if k < 3 else f"tail-{k}" for k in rng.integers(0, 200, writes)]
        now = step * 0.7
        for name, tracker in trackers.items():
            for shard, key in zip(shards, keys):
                tracker.note_write(int(shard), key)
            clocks[name][0] = now
            rates = tracker.sample()
        assert rates == trackers["jax"].rates()
        assert trackers["port"].snapshot() == trackers["jax"].snapshot()
        hot_seen.update(trackers["port"].hot_shards())
        if step == 20:
            for tracker in trackers.values():
                tracker.grow(1)
    assert hot_seen and trackers["port"].shards == 5  # not vacuous


def test_merge_rank_and_plan_over_seeded_heat_docs_equal_the_jax_ones(monkeypatch):
    rng = np.random.default_rng(21)
    for _ in range(60):
        n = int(rng.integers(1, 9))
        docs = [{"store": "s", "heat": {
            "rates": [float(r) for r in rng.gamma(1.0, 40.0, int(rng.integers(1, n + 1)))],
            "hot": sorted({int(i) for i in rng.integers(0, n, int(rng.integers(0, 3)))}),
            "top_keys": {str(i): [f"k{j}" for j in range(int(rng.integers(0, 4)))]
                         for i in range(n) if rng.random() < 0.6}}}
            for _ in range(int(rng.integers(1, 4)))]
        threshold = rng.choice([None, 25.0, 60.0])
        if threshold is None:  # the default, 50
            monkeypatch.delenv("TASKSRUNNER_RESHARD_HEAT_THRESHOLD", raising=False)
        else:
            monkeypatch.setenv("TASKSRUNNER_RESHARD_HEAT_THRESHOLD", str(threshold))
        merged = placement.merge_heat_docs(docs)
        assert merged == jax_placement.merge_heat_docs(docs)
        assert placement.rank_shards(merged) == jax_placement.rank_shards(merged)
        for doc in docs:
            assert placement.plan_rebalance(doc) == jax_placement.plan_rebalance(doc)
        wrapped = [{"placement": {"s": {**d, "epoch": int(rng.integers(1, 4)), "shards": n,
                                       "assignment": {}, "migration": None}}} for d in docs]
        assert PlacementController._merge(wrapped) == JaxController("a", list)._merge(wrapped)


# -- the split and the migration ----------------------------------------------

async def _split_under_writers(sqlite_mod, path: Path, seeds: int) -> tuple:
    """``seeds`` keys on four shards, then a split to five while four
    writers keep writing 50 keys each (the JAX test's shape): what every
    key reads back, the last value acked a key, the result and the
    moved share."""
    store = sqlite_mod.build_sharded_store("split", path, shards=4, hash_seed="s")
    acked: dict[str, int] = {}
    stop = asyncio.Event()

    async def writer(w: int) -> None:
        i = 0
        while not stop.is_set():
            key = f"w{w}-{i % 50}"
            await store.set(key, {"v": i})
            acked[key] = i
            i += 1

    try:
        await asyncio.gather(*(store.set(f"seed-{i}", {"v": i}) for i in range(seeds)))
        before = {f"seed-{i}": store.router.shard_of(f"seed-{i}") for i in range(seeds)}
        writers = [asyncio.create_task(writer(w)) for w in range(4)]
        await asyncio.sleep(0.05)
        result = await store.split_shard()
        await asyncio.sleep(0.05)
        stop.set()
        await asyncio.gather(*writers)
        keys = await store.keys()
        contents = {i.key: i.value for i in await store.bulk_get(keys)}
        moved = sum(store.router.shard_of(k) != s for k, s in before.items())
        held = [await store._shards[i].keys() for i in range(store.shard_count)]
        return contents, acked, result, moved / seeds, keys, held, store.router
    finally:
        stop.set()
        store.close()


async def test_a_split_under_writers_loses_nothing_as_in_the_jax_package(tmp_path):
    runs = {name: await _split_under_writers(mod, tmp_path / name / "s.db", 1000)
            for name, (mod, _) in PACKAGES.items()}
    for contents, acked, result, share, keys, held, router in runs.values():
        assert {k: contents[k] for k in acked} == {k: {"v": v} for k, v in acked.items()}
        assert (result["shards"], result["epoch"], result["new_shard"]) == (5, 2, 4)
        assert 0.12 <= share <= 0.28 and len(keys) == len(set(keys))
        # every key on exactly the shard its router names
        assert all(router.shard_of(k) == i for i, ks in enumerate(held) for k in ks)
        assert sorted(k for ks in held for k in ks) == keys
        assert result["pause_seconds"] < placement.pause_budget_default()
    got, want = runs["port"], runs["jax"]
    # the seeds and every writer's last value: the contents are the JAX run's
    seeded = {k: v for k, v in got[0].items() if k.startswith("seed-")}
    assert seeded == {k: v for k, v in want[0].items() if k.startswith("seed-")}
    assert got[3] == want[3]


async def test_migrating_a_shard_to_a_new_store_equals_the_jax_migration(tmp_path):
    contents = {}
    for name, (mod, _) in PACKAGES.items():
        store = mod.build_sharded_store("mv", tmp_path / name / "mv.db", shards=3)
        try:
            keys = [f"task-{i}" for i in range(300)]
            await asyncio.gather(*(store.set(k, {"k": k}) for k in keys))
            target = mod.SqliteStateStore("mv", tmp_path / name / "mv-new.db", shard=2)
            writes = [asyncio.create_task(store.set(f"late-{i}", {"i": i})) for i in range(40)]
            result = await store.migrate_shard(2, target=target)
            await asyncio.gather(*writes)
            assert (result["action"], result["epoch"], result["shard"]) == ("move", 2, 2)
            assert store._shards[2] is target and store.placement.assignment == {2: "mv"}
            every = await store.keys()
            contents[name] = {i.key: i.value for i in await store.bulk_get(every)}
            assert sorted(await target.keys()) == sorted(
                k for k in every if store.router.shard_of(k) == 2)
        finally:
            store.close()
    assert contents["port"] == contents["jax"] and len(contents["port"]) == 340
    refusals = {}
    for name, (mod, _) in PACKAGES.items():
        refused = mod.build_sharded_store("r", ":memory:", shards=2)
        try:
            for kwargs in ({"member": "m1"}, {}):
                with pytest.raises(Exception) as err:
                    await refused.migrate_shard(0, **kwargs)
                refusals.setdefault(name, []).append((type(err.value).__name__, str(err.value)))
        finally:
            refused.close()
    # member= needs replica-set children: a plain shard is refused as in JAX
    assert refusals["port"] == refusals["jax"]
    assert "shard 0 is not replicated" in refusals["port"][0][1]
    assert "exactly one of" in refusals["port"][1][1]


async def test_a_write_in_flight_across_a_catch_up_round_is_not_lost(tmp_path, caplog,
                                                                      monkeypatch):
    """A write to a moving key has entered the store but not landed when a
    catch-up round reads that key: the round copies the old value. The
    port's tap notes the key once the write returns, so the paused round
    copies it again (the JAX tap noted it before the write and the round
    took it). Also: a pause past the budget is logged."""
    store = port_sqlite.build_sharded_store("tap", tmp_path / "tap.db", shards=2)
    grown = ShardRouter(3, "")
    moving = [f"k{i}" for i in range(2000) if grown.shard_of(f"k{i}") == 2]
    victim, others = moving[0], moving[1:72]
    await asyncio.gather(*(store.set(k, "old") for k in [victim, *others]))
    child = store.shard_for(victim)
    release = asyncio.Event()
    child_set = child.set

    async def held_set(key, value, *, etag=None):
        if key == victim:
            await release.wait()
        return await child_set(key, value, etag=etag)

    child.set = held_set
    target = store.child_factory(2)
    store.child_factory = lambda n: target
    target_set, calls = target.set, [0]

    async def counted_set(key, value, *, etag=None):
        calls[0] += 1
        if calls[0] == 1:  # inside the first copy: 71 moving keys written
            await asyncio.gather(*(store.set(k, "new") for k in others))
        elif calls[0] > len(others) + 1:  # in the round that read the victim
            release.set()
        return await target_set(key, value, etag=etag)

    target.set = counted_set
    try:
        in_flight = asyncio.create_task(store.set(victim, "new"))
        await asyncio.sleep(0.05)
        monkeypatch.setenv("TASKSRUNNER_RESHARD_PAUSE_BUDGET_SECONDS", "0")
        with caplog.at_level(logging.WARNING, "tasksrunner_torch.state.sharding"):
            result = await asyncio.wait_for(store.split_shard(), 30)
        await in_flight
        assert release.is_set() and result["shards"] == 3
        assert (await store.get(victim)).value == "new"
        assert [(await store.get(k)).value for k in others] == ["new"] * len(others)
        assert "flip paused writes" in caplog.text and "(budget 0.000s)" in caplog.text
    finally:
        release.set()
        store.close()


# -- the sidecars' 409 ------------------------------------------------------------

def _spec_doc(path: Path) -> dict:
    return {"componentType": "state.sqlite", "metadata": [
        {"name": "databasePath", "value": str(path)}, {"name": "shards", "value": "4"},
        {"name": "hashSeed", "value": "p"}]}


async def test_a_stale_epoch_is_a_409_with_the_live_epoch_from_both_sidecars(tmp_path):
    """The six state routes with no epoch, the live one, a stale one, a
    newer one and a malformed one: the same statuses, epoch headers and
    errors from the JAX sidecar and the port's."""
    sidecars = {
        "jax": JaxSidecar(JaxRuntime("svc", JaxRegistry([jax_parse_component(
            _spec_doc(tmp_path / "jax" / "s.db"), default_name="scores")])), port=0),
        "port": Sidecar(Runtime("svc", ComponentRegistry([parse_component(
            _spec_doc(tmp_path / "port" / "s.db"), default_name="scores")]),
            resolver=NameResolver(registry_file=tmp_path / "apps.json")), port=0)}
    routes = [("POST", "/v1.0/state/scores", [{"key": "a", "value": 1},
                                              {"key": "b", "value": 2}]),
              ("GET", "/v1.0/state/scores/a", None),
              ("POST", "/v1.0/state/scores/bulk", {"keys": ["a", "b"]}),
              ("POST", "/v1.0/state/scores/query", {"page": {"limit": 1}}),
              ("POST", "/v1.0/state/scores/transaction", {"operations": [
                  {"operation": "upsert", "request": {"key": "c", "value": 3}},
                  {"operation": "upsert", "request": {"key": "d", "value": 4}}]}),
              ("DELETE", "/v1.0/state/scores/b", None)]
    answers = {}
    for name, sidecar in sidecars.items():
        await sidecar.start()
        try:
            stale_name = "placement_stale_routes_total{store=scores}"

            async def stale_count():
                _, _, raw = await http_request("127.0.0.1", sidecar.port, "GET",
                                               "/v1.0/metadata")
                doc = json.loads(raw)
                return doc.get("placement"), doc["metrics"].get(stale_name, 0)

            seen, (_, stale_before) = [], await stale_count()
            for epoch in (None, "1", "0", "2", "x"):
                for method, path, body in routes:
                    headers = {} if epoch is None else {HEADER: epoch}
                    status, reply_headers, raw = await http_request(
                        "127.0.0.1", sidecar.port, method, path, headers=headers,
                        body=b"" if body is None else json.dumps(body).encode())
                    error = json.loads(raw).get("error") if status >= 400 else None
                    seen.append((epoch, method, path, status, reply_headers.get(HEADER), error))
            docs, stale_after = await stale_count()
            seen.append((docs["scores"]["epoch"], stale_after - stale_before))
            answers[name] = seen
        finally:
            await sidecar.stop()
    assert answers["port"] == answers["jax"]
    stale = [a for a in answers["port"][:-1] if a[0] in ("0", "2")]
    assert all(a[3:5] == (409, "1") for a in stale) and len(stale) == 12
    assert answers["port"][-1] == (1, 12.0)


# -- /admin/placement and the shards verb --------------------------------------

class _Loop:
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


def _verb(main, argv, capsys) -> tuple:
    try:
        main(argv)
        code = 0
    except SystemExit as exc:
        code = 0 if exc.code is None else (exc.code if isinstance(exc.code, int) else 1)
    return code, re.sub(r'"last_sweep": [0-9.]+', '"last_sweep": <clock>',
                        capsys.readouterr().out)


def test_admin_placement_and_the_shards_verb_equal_the_jax_ones(tmp_path, monkeypatch, capsys):
    """Two replicas, one a JAX sidecar and one the port's, over a 4-shard
    store each with seeded writes and a frozen heat clock (a threshold of
    1 write/s and no hysteresis, so a shard is hot and a plan shows). The
    JAX and the port admin servers answer ``/admin/placement`` alike with
    the loop on and off, and each package's ``shards`` verb prints the
    same against either."""
    monkeypatch.setenv("TASKSRUNNER_RESHARD_HEAT_THRESHOLD", "1")
    monkeypatch.setenv("TASKSRUNNER_RESHARD_HYSTERESIS_SECONDS", "0")
    loop = _Loop()
    rng = random.Random(22)
    writes = [(f"task-{rng.randrange(300)}", rng.randrange(9)) for _ in range(200)]
    sidecars = {
        "jax": JaxSidecar(JaxRuntime("scorer", JaxRegistry([jax_parse_component(
            _spec_doc(tmp_path / "jax" / "s.db"), default_name="scores")])), port=0),
        "port": Sidecar(Runtime("scorer", ComponentRegistry([parse_component(
            _spec_doc(tmp_path / "port" / "s.db"), default_name="scores")]),
            resolver=NameResolver(registry_file=tmp_path / "apps.json")), port=0)}
    admins, started = {}, []
    try:
        for name, sidecar in sidecars.items():
            loop.run(sidecar.start())
            started.append(sidecar)
            store = sidecar.runtime.registry.get("scores")
            clock = [0.0]
            store.heat = PACKAGES[name][1].ShardHeatTracker(4, clock=lambda c=clock: c[0])
            for key, v in writes:
                loop.run(http_request("127.0.0.1", sidecar.port, "POST", "/v1.0/state/scores",
                                      body=json.dumps([{"key": key, "value": v}]).encode()))
            clock[0] = 1.0  # one sample folds the writes; the clock stays
        replicas = [types.SimpleNamespace(ports=(0, s.port)) for s in sidecars.values()]
        info = [{"pid": None, "app_port": None, "sidecar_port": s.port, "host": "127.0.0.1"}
                for s in sidecars.values()]
        for name, server in (("jax", JaxAdminServer), ("port", AdminServer)):
            orch = types.SimpleNamespace(
                replicas={"scorer": replicas}, placement={},
                _replica_info=lambda app_id: info,
                config=types.SimpleNamespace(app_tokens=None,
                                             registry_path=tmp_path / name / "apps.json"))
            admins[name] = server(orch)
            loop.run(admins[name].start())
        docs = {}
        for reshard in (False, True):
            if reshard:  # the loop on: each admin's controller has swept once
                for name, controller in (("jax", JaxController), ("port", PlacementController)):
                    c = controller("scorer", lambda: info)
                    loop.run(c.step())
                    admins[name].orch.placement = {"scorer": c}
            for name, admin in admins.items():
                status, _, raw = loop.run(http_request("127.0.0.1", admin.port, "GET",
                                                       "/admin/placement"))
                assert status == 200
                doc = json.loads(raw)
                for app in doc["apps"].values():
                    app["last_sweep"] = "<clock>"
                docs[(name, reshard)] = doc
            assert docs[("port", reshard)] == docs[("jax", reshard)]
            for name in admins:
                reg = ["--registry-file", str(tmp_path / name / "apps.json")]
                for argv in (["shards", *reg], ["shards", "--json", *reg]):
                    want = _verb(jax_cli.main, argv, capsys)
                    assert _verb(cli.main, argv, capsys) == want, argv
        entry = docs[("port", True)]["apps"]["scorer"]["stores"]["scores"]
        assert (entry["epoch"], entry["shards"], entry["replicas_reporting"]) == (1, 4, 2)
        assert entry["plan"]["action"] == "split" and all(r["rate"] > 0
                                                          for r in entry["ranking"])
        code, out = _verb(cli.main, ["shards", "--registry-file",
                                     str(tmp_path / "port" / "apps.json")], capsys)
        assert code == 0 and out.splitlines()[0].startswith("scorer/scores: epoch 1, 4 shards, "
                                                            "2 replica(s) reporting")
        empty = ["shards", "--registry-file", str(tmp_path / "none" / "apps.json")]
        assert _verb(cli.main, empty, capsys) == _verb(jax_cli.main, empty, capsys)
    finally:
        for admin in admins.values():
            loop.run(admin.stop())
        for sidecar in reversed(started):
            loop.run(sidecar.stop())
        loop.close()
