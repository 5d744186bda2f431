"""The port's replica sets against the JAX package's, on the CPU in one
process: one seeded script of sets, deletes, transactions and staged
transactions through each package's ``build_replicated_store`` at RF 2
and 3, with 1 and 4 shards, then every member file's ``state`` rows,
``repl_log`` rows (the record's send time left out) and ``repl_meta``,
and the lease records (their times left out), compared exactly; the
error class and status of a fenced write, a quorum timeout and a read
past ``maxLagRecords``; each package's ``repl`` verb on the other's
files; and the placement document of a plain and of a replicated
sharded store, key for key."""

import asyncio
import json
import random
import re
import sqlite3
from pathlib import Path

import pytest

from tasksrunner import cli as jax_cli
from tasksrunner.orchestrator.placement import PlacementController as JaxController
from tasksrunner.state import placement as jax_placement
from tasksrunner.state import replication as jax_replication
from tasksrunner.state.base import TransactionOp as JaxOp

from tasksrunner_torch import cli
from tasksrunner_torch.orchestrator.placement import PlacementController
from tasksrunner_torch.state import placement
from tasksrunner_torch.state import replication
from tasksrunner_torch.state.base import TransactionOp

PACKAGES = {"jax": (jax_replication, jax_placement, JaxOp),
            "port": (replication, placement, TransactionOp)}
#: a short lease for the drills that need a promotion
LEASE = 0.4
PATIENCE = 20.0


@pytest.fixture(autouse=True)
def _long_lease(monkeypatch):
    """A lease no test outlives, so r0 stays leader. Both packages read it
    from the environment as each member is made."""
    monkeypatch.setenv("TASKSRUNNER_REPL_LEASE_SECONDS", "30")


def _script(seed: int) -> list[tuple]:
    """Sets, conditional sets, deletes, transactions within a shard and
    across shards, and staged transactions committed or rolled back."""
    rng = random.Random(seed)
    keys = [f"task-{i}" for i in range(24)]
    steps: list[tuple] = []
    for i in range(60):
        roll = rng.random()
        key = rng.choice(keys)
        if roll < 0.55:
            steps.append(("set", key, {"i": i, "w": rng.randrange(100)}))
        elif roll < 0.65:
            steps.append(("set_etag", key, {"i": i}))
        elif roll < 0.75:
            steps.append(("delete", key))
        elif roll < 0.9:
            steps.append(("transact", [(rng.choice(["upsert", "delete"]), k, {"t": i})
                                       for k in rng.sample(keys, 3)]))
        else:
            steps.append(("staged", rng.random() < 0.7,
                          [("upsert", k, {"s": i}) for k in rng.sample(keys, 2)]))
    return steps


async def _run_script(store, op_type, steps) -> list:
    out = []
    for step in steps:
        try:
            if step[0] == "set":
                out.append(await store.set(step[1], step[2]))
            elif step[0] == "set_etag":
                out.append(await store.set(step[1], step[2], etag="1"))
            elif step[0] == "delete":
                out.append(await store.delete(step[1]))
            elif step[0] == "transact":
                out.append(await store.transact([op_type(o, k, v if o == "upsert" else None)
                                                 for o, k, v in step[1]]))
            else:
                # a staged transaction on the shard of its first key
                child = store.shard_for(step[2][0][1]) if hasattr(store, "shard_for") else store
                ops = [op_type(o, k, v) for o, k, v in step[2]
                       if getattr(store, "shard_for", lambda _: child)(k) is child]
                txn = await child.stage_transact(ops)
                await (txn.commit() if step[1] else txn.rollback())
                out.append(step[1])
        except Exception as exc:  # noqa: BLE001 - the error is the result
            out.append(type(exc).__name__)
    return out


def _files(root: Path) -> dict:
    """Every member file's rows, log (no send time) and position, and the
    lease records (no times)."""
    out = {}
    for path in sorted(root.glob("*.db")):
        with sqlite3.connect(path) as con:
            tables = {r[0] for r in con.execute("SELECT name FROM sqlite_master")}
            state = con.execute("SELECT key, value, etag FROM state ORDER BY key").fetchall()
            if path.stem.endswith("repl-meta"):
                out[path.name] = {k: {f: v for f, v in json.loads(v).items()
                                      if f not in ("expires", "registered_at")}
                                  for k, v, _ in state}
                continue
            log = [(seq, epoch, {f: v for f, v in json.loads(rec).items() if f != "ts"})
                   for seq, epoch, rec in con.execute(
                       "SELECT seq, epoch, record FROM repl_log ORDER BY seq")]
            out[path.name] = {"state": state, "log": log, "tables": sorted(tables),
                              "meta": con.execute("SELECT * FROM repl_meta").fetchall(),
                              "etag_seq": con.execute("SELECT n FROM etag_seq").fetchall()}
    return out


async def _settled(store) -> None:
    """Every shard's members at its leader's position."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + PATIENCE
    children = getattr(store, "_shards", [store])
    while not all(len({n.store.repl_position() for n in c.nodes}) == 1 for c in children):
        assert loop.time() < deadline, "the members never settled"
        await asyncio.sleep(0.02)


@pytest.mark.parametrize("shards, replicas", [(1, 2), (1, 3), (4, 2), (4, 3)])
async def test_a_seeded_script_leaves_the_jax_member_files(tmp_path, shards, replicas):
    steps = _script(shards * 10 + replicas)
    results, files = {}, {}
    for name, (repl_mod, _, op_type) in PACKAGES.items():
        store = repl_mod.build_replicated_store(
            "rs", tmp_path / name / "rs.db", shards=shards, replicas=replicas, hash_seed="p")
        try:
            if shards > 1:  # every shard's leader elected before the script
                await asyncio.gather(*(child.set("boot", 0) for child in store._shards))
            results[name] = await _run_script(store, op_type, steps)
            await _settled(store)
            leaders = [child.leader_member() for child in getattr(store, "_shards", [store])]
        finally:
            await store.aclose()
        assert leaders == ["r0"] * shards
        files[name] = _files(tmp_path / name)
    assert results["port"] == results["jax"]
    assert files["port"] == files["jax"]
    assert len(files["port"]) == shards * replicas + 1
    assert {"EtagMismatch", True, False} <= set(results["port"])
    logged = [rec for f in files["port"].values() if "log" in f for rec in f["log"]]
    assert logged[0] == (1, 1, {"seq": 1, "epoch": 1, "ops": [], "etag_n": 0, "barrier": True})


# -- the errors ----------------------------------------------------------------------

class _Severed:
    def __init__(self, inner) -> None:
        self.inner = inner
        self.severed = True

    async def position(self):
        if self.severed:
            raise OSError("severed")
        return await self.inner.position()

    async def append(self, records):
        if self.severed:
            raise OSError("severed")
        return await self.inner.append(records)

    async def install(self, snapshot):
        if self.severed:
            raise OSError("severed")
        return await self.inner.install(snapshot)


async def _until(predicate, what: str) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + PATIENCE
    while not predicate():
        assert loop.time() < deadline, what
        await asyncio.sleep(0.02)


async def _fenced_write(repl_mod, path) -> BaseException:
    store = repl_mod.build_replicated_store("z", path, replicas=2, ack_quorum=2)
    try:
        await store.set("seed", 1)
        zombie = next(n for n in store.nodes if n.node_id == store.leader_member())
        zombie.renewal_paused = True
        survivor = next(n for n in store.nodes if n is not zombie)
        survivor.links[zombie.node_id] = _Severed(survivor.links[zombie.node_id])
        await _until(lambda: survivor.is_leader, "the promotion")
        try:
            await zombie.store.set("zombie", 1)
        except Exception as exc:  # noqa: BLE001 - compared
            return exc
        raise AssertionError("the zombie's write was acked")
    finally:
        store.close()


async def _quorum_timeout(repl_mod, path) -> BaseException:
    store = repl_mod.build_replicated_store("q", path, replicas=2, ack_quorum=2)
    try:
        await store.set("seed", 1)
        follower = next(n for n in store.nodes if n.node_id != store.leader_member())

        async def hang(_):
            await asyncio.Event().wait()

        follower.apply_records = follower.install_snapshot = hang
        try:
            await asyncio.wait_for(store.set("k", 1), PATIENCE)
        except Exception as exc:  # noqa: BLE001 - compared
            return exc
        raise AssertionError("the write was acked without its quorum")
    finally:
        store.close()


async def _stale_read(repl_mod, path) -> BaseException:
    store = repl_mod.build_replicated_store("f", path, replicas=2, ack_quorum=1,
                                            follower_reads=True, max_lag=3)
    try:
        await store.set("k", 0)
        follower = next(n for n in store.nodes if n.node_id != store.leader_member())
        follower.crash()
        for i in range(6):
            await store.set(f"k{i}", i)
        try:
            await store.read_follower("k", member=follower.node_id)
        except Exception as exc:  # noqa: BLE001 - compared
            return exc
        raise AssertionError("a follower past the bound was read")
    finally:
        store.close()


#: the settings each drill needs beyond the long lease
DRILL_ENV = {_fenced_write: {"TASKSRUNNER_REPL_LEASE_SECONDS": str(LEASE)},
             _quorum_timeout: {"TASKSRUNNER_REPL_ACK_TIMEOUT_SECONDS": "0.5"}}


@pytest.mark.parametrize("drill", [_fenced_write, _quorum_timeout, _stale_read])
async def test_each_failure_raises_the_jax_error_and_status(tmp_path, monkeypatch, drill):
    for var, value in DRILL_ENV.get(drill, {}).items():
        monkeypatch.setenv(var, value)
    got = {}
    for name, (repl_mod, *_) in PACKAGES.items():
        exc = await drill(repl_mod, tmp_path / name / "d.db")
        got[name] = (type(exc).__name__, exc.http_status,
                     re.sub(r"\d+(\.\d+)?", "N", str(exc)))
    assert got["port"] == got["jax"]
    assert got["port"][:2] in {("ReplicaFencedError", 409), ("ReplicationQuorumError", 503),
                               ("StaleReadError", 503)}


# -- the repl verb ----------------------------------------------------------------------

def _verb(main, argv, capsys) -> tuple:
    try:
        main(argv)
        code = 0
    except SystemExit as exc:
        code = 0 if exc.code is None else (exc.code if isinstance(exc.code, int) else 1)
    captured = capsys.readouterr()
    out = re.sub(r'"lease_seconds_left": -?[0-9.e+]+', '"lease_seconds_left": <t>', captured.out)
    return code, out, captured.err


def test_each_repl_verb_reads_the_other_packages_files(tmp_path, capsys):
    async def write(repl_mod, path):
        store = repl_mod.build_replicated_store("scores", path, shards=2, replicas=3)
        try:
            await asyncio.gather(*(store.set(f"k{i}", i) for i in range(30)))
            await _settled(store)
        finally:
            await store.aclose()

    for name, (repl_mod, *_) in PACKAGES.items():
        asyncio.run(write(repl_mod, tmp_path / name / "scores.db"))
    for name in PACKAGES:
        base = str(tmp_path / name / "scores.db")
        for argv in (["repl", base], ["repl", base, "--json"]):
            want = _verb(jax_cli.main, argv, capsys)
            assert _verb(cli.main, argv, capsys) == want, argv
    code, out, _ = _verb(cli.main, ["repl", str(tmp_path / "jax" / "scores.db")], capsys)
    assert code == 0 and out.count("scores shard ") == 2 and out.count("  r") == 6
    assert "leader r0 (epoch 1" in out and "lease EXPIRED" in out
    missing = ["repl", str(tmp_path / "none.db")]
    assert _verb(cli.main, missing, capsys) == _verb(jax_cli.main, missing, capsys)


# -- the placement document -----------------------------------------------------------------

@pytest.mark.parametrize("replicas", [1, 3])
async def test_the_placement_document_equals_the_jax_one(tmp_path, replicas):
    docs = {}
    for name, (repl_mod, place_mod, _) in PACKAGES.items():
        store = repl_mod.build_replicated_store("pd", tmp_path / name / "pd.db", shards=4,
                                                replicas=replicas, hash_seed="s")
        clock = [0.0]
        store.heat = place_mod.ShardHeatTracker(4, clock=lambda c=clock: c[0])
        try:
            for i in range(40):
                await store.set(f"k{i}", i)
            clock[0] = 1.0
            docs[name] = [store.placement_doc()]
            store.local_member = "r1"
            docs[name].append(store.placement_doc())
        finally:
            await store.aclose()
    assert docs["port"] == docs["jax"]
    first, second = docs["port"]
    assert first["local_member"] is None and second["local_member"] == "r1"
    if replicas == 1:
        assert "leaders" not in first
    else:
        assert first["leaders"] == {str(i): "r0" for i in range(4)}
    # the orchestrator's merge passes the freshest document's leaders on
    views = [c("scorer", lambda: [])._merge([{"placement": {"pd": d}} for d in docs["port"]])
             for c in (JaxController, PlacementController)]
    assert views[0] == views[1]
    assert views[1]["pd"]["leaders"] == first.get("leaders", {})


def test_the_shards_verb_prints_each_shard_leader(monkeypatch, capsys):
    doc = {"reshard": True, "apps": {"scorer": {"app_id": "scorer", "last_sweep": 1.0, "stores": {
        "scores": {"store": "scores", "epoch": 2, "shards": 3, "assignment": {"1": "r2"},
                   "leaders": {"0": "r0", "1": "r2", "2": "r1"}, "migration": None,
                   "replicas_reporting": 1, "plan": None,
                   "ranking": [{"shard": i, "rank": i, "rate": 0.0, "hot": False}
                               for i in range(3)]}}}}}
    outs = []
    for mod in (jax_cli, cli):
        monkeypatch.setattr(mod, "_admin_request", lambda *a, **k: doc)
        mod.main(["shards", "--registry-file", "unused.json"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert [line.rsplit("@ ", 1)[1] for line in outs[1].splitlines()[1:]] == ["r0", "r2", "r1"]
