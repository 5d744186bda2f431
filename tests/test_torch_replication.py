"""The port's replica sets on their own, on the CPU in one process and
without JAX: the record stream reaching every member at one high-water
mark, ``replicas: 1`` as the plain store, the component metadata, lease
epochs, a stalled leader fenced with no acknowledged write lost, the
failover after a crash, the ack quorum's timeout on a link that never
answers, the resync of a follower by log and by snapshot, the follower
reads' lag bound and read cache, shards of replica sets (routing, a crash,
a leadership handoff, an online split, a staged cross-shard commit) and
the client's placement-epoch retry. Waits have generous deadlines and no
test orders events by the wall clock."""

import asyncio
import json
import sqlite3
import threading

import pytest

from tasksrunner_torch import client as client_mod
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import parse_component
from tasksrunner_torch.errors import (
    EtagMismatch, PlacementEpochError, ReplicaFencedError, ReplicationQuorumError,
    StaleReadError,
)
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.state.base import TransactionOp
from tasksrunner_torch.state.lease import Lease
from tasksrunner_torch.state.placement import PLACEMENT_EPOCH_HEADER
from tasksrunner_torch.state.replication import (
    ReplicaSetStore, ShardReplicator, build_replicated_store,
)
from tasksrunner_torch.state.sharding import ShardedStateStore
from tasksrunner_torch.state.sqlite import SqliteStateStore

#: a short lease, so a promotion takes a fraction of a second
LEASE = 0.4
#: how long a wait may take before the test fails: far past what it needs
PATIENCE = 20.0


@pytest.fixture(autouse=True)
def _short_lease(monkeypatch):
    """Members read their lease from the environment as they are made."""
    monkeypatch.setenv("TASKSRUNNER_REPL_LEASE_SECONDS", str(LEASE))


def _build(tmp_path, name="repl", *, replicas=2, **kw):
    return build_replicated_store(name, tmp_path / f"{name}.db", replicas=replicas, **kw)


async def _wait_for(predicate, what: str, timeout: float = PATIENCE) -> None:
    deadline = asyncio.get_running_loop().time() + timeout
    while not predicate():
        assert asyncio.get_running_loop().time() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


def _leader(store: ReplicaSetStore):
    return next(n for n in store.nodes if n.node_id == store.leader_member())


def _in_step(store: ReplicaSetStore) -> bool:
    return len({n.store.repl_position() for n in store.nodes}) == 1


def _silence(node) -> list:
    """The link to ``node`` never answers a shipment: each waits forever.
    Returns the list of shipments it was sent."""
    calls = []

    async def hang(payload):
        calls.append(payload)
        await asyncio.Event().wait()

    node.apply_records = node.install_snapshot = hang
    return calls


class _SeverableLink:
    """A link that fails like a dropped connection while severed."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.severed = True

    def _check(self) -> None:
        if self.severed:
            raise OSError("link severed")

    async def position(self):
        self._check()
        return await self.inner.position()

    async def append(self, records):
        self._check()
        return await self.inner.append(records)

    async def install(self, snapshot):
        self._check()
        return await self.inner.install(snapshot)


# -- the record stream ----------------------------------------------------------

async def test_every_member_holds_every_write_at_one_hwm(tmp_path):
    store = _build(tmp_path, replicas=3, ack_quorum=3)
    try:
        for i in range(40):
            await store.set(f"k{i}", {"v": i})
        await store.delete("k3")
        await store.transact([TransactionOp("upsert", "tx-a", {"t": 1}),
                              TransactionOp("upsert", "tx-b", {"t": 2})])
        # quorum 3: each write waited for both followers
        assert _in_step(store), [n.store.repl_position() for n in store.nodes]
        assert store.nodes[0].store.repl_position() == (43, 1)  # barrier + 42 records
        for node in store.nodes:
            assert (await node.store.get("k7")).value == {"v": 7}
            assert await node.store.get("k3") is None
            assert (await node.store.get("tx-b")).value == {"t": 2}
    finally:
        await store.aclose()


async def test_rf1_is_the_plain_store(tmp_path):
    store = _build(tmp_path, replicas=1)
    try:
        assert type(store) is SqliteStateStore
        await store.set("k", {"v": 1})
    finally:
        store.close()
    with sqlite3.connect(tmp_path / "repl.db") as con:
        tables = {r[0] for r in con.execute("SELECT name FROM sqlite_master WHERE type='table'")}
    assert tables == {"state", "etag_seq"}
    assert not (tmp_path / "repl-repl-meta.db").exists()
    sharded = _build(tmp_path, "plain", replicas=1, shards=3)
    assert type(sharded) is ShardedStateStore and sharded.shard_count == 3
    sharded.close()


async def test_component_metadata_builds_replica_sets(tmp_path):
    def build(**extra):
        meta = {"databasePath": str(tmp_path / "s.db"), **extra}
        return ComponentRegistry([parse_component({"componentType": "state.sqlite", "metadata": [
            {"name": k, "value": v} for k, v in meta.items()]}, default_name="st")]).get("st")

    plain = build()
    assert type(plain) is SqliteStateStore
    plain.close()
    store = build(replicas="3", followerReads="true", maxLagRecords="7")
    try:
        assert isinstance(store, ReplicaSetStore) and len(store.nodes) == 3
        assert [n.ack_quorum for n in store.nodes] == [2, 2, 2]  # a majority
        assert store.follower_reads and store.max_lag == 7
        await store.set("meta-key", {"ok": True})
        assert (await store.get("meta-key")).value == {"ok": True}
    finally:
        await store.aclose()
    assert {p.name for p in tmp_path.iterdir() if p.suffix == ".db"} == {
        "s.db", "s-r1.db", "s-r2.db", "s-repl-meta.db"}
    store = build(replicas="2", ackQuorum="1", shards="2", hashSeed="h")
    try:
        assert type(store) is ShardedStateStore and store.hash_seed == "h"
        assert all(n.ack_quorum == 1 for child in store._shards for n in child.nodes)
    finally:
        store.close()


# -- leadership ---------------------------------------------------------------------

async def test_lease_epochs_only_go_up():
    meta = SqliteStateStore("meta")
    lease = Lease(meta, "l", lease_seconds=60)
    try:
        assert await lease.acquire("a") == 1
        assert await lease.renew("a") is True
        assert await lease.acquire("b") is None  # the holder lives
        await lease.release("a")
        assert await lease.acquire("b") == 2  # a takeover bumps the epoch
        await lease.release("b")
        assert await lease.acquire("a") == 3  # a release keeps the line
        assert await lease.renew("b") is False
        short = Lease(meta, "short", lease_seconds=0.05)
        assert await short.acquire("a") == 1
        await asyncio.sleep(0.1)  # past its life, however late the loop wakes
        assert await short.acquire("b") == 2
    finally:
        meta.close()


async def test_a_stalled_leader_is_fenced_and_no_acknowledged_write_is_lost(tmp_path):
    store = _build(tmp_path, replicas=2, ack_quorum=2)
    acked = []
    try:
        for i in range(25):
            await store.set(f"k{i}", {"v": i})
            acked.append(f"k{i}")
        zombie = _leader(store)
        zombie.renewal_paused = True
        survivor = next(n for n in store.nodes if n is not zombie)
        # one way: the survivor cannot reach the zombie (so its barrier
        # cannot demote it), the zombie still ships to the survivor
        partition = _SeverableLink(survivor.links[zombie.node_id])
        survivor.links[zombie.node_id] = partition
        await _wait_for(lambda: survivor.is_leader, "the follower's promotion")
        with pytest.raises(ReplicaFencedError):
            await zombie.store.set("zombie-write", {"evil": True})
        assert await survivor.store.get("zombie-write") is None
        assert survivor.store.repl_position()[1] == 2
        partition.severed = False
        await store.set("post-failover", {"ok": True})
        acked.append("post-failover")
        assert [k for k in acked if await store.get(k) is None] == []
        # the fenced member is resynced from the new leader, its commit gone
        await _wait_for(lambda: _in_step(store), "the zombie's resync")
        assert await zombie.store.get("zombie-write") is None
        assert metrics.get("repl_fenced_total", store="repl", shard=0) >= 1
    finally:
        await store.aclose()


async def test_a_crashed_leader_fails_over_with_every_acknowledged_write(tmp_path):
    store = _build(tmp_path, replicas=3)
    try:
        for i in range(15):
            await store.set(f"k{i}", {"v": i})
        victim = _leader(store)
        victim.crash()
        await store.set("after", {"v": -1})  # waits for a promotion
        leader = _leader(store)
        assert leader is not victim and leader.store.repl_position()[1] == 2
        survivor = next(n for n in store.nodes if n not in (victim, leader))
        await _wait_for(lambda: survivor.store.repl_position() == leader.store.repl_position(),
                        "the surviving follower")
        for node in (leader, survivor):
            for i in range(15):
                assert (await node.store.get(f"k{i}")).value == {"v": i}
            assert (await node.store.get("after")).value == {"v": -1}
        victim.revive()
        await _wait_for(lambda: _in_step(store), "the old leader's resync")
        assert (await victim.store.get("after")).value == {"v": -1}
    finally:
        await store.aclose()


@pytest.mark.parametrize("when", ["queued", "committing"])
async def test_writes_in_flight_on_a_crashing_leader_are_acked_only_once_replicated(
        tmp_path, when):
    """The leader crashes with a batch of writes in its writer's queue, or
    with that batch committed in its file but not yet resolved. Nothing
    ships those records, so no caller may see them acked there: each write
    goes again to the new leader, and every write that resolved reads back
    from the new leader and from the surviving follower."""
    store = _build(tmp_path, replicas=3)
    release = threading.Event()
    try:
        await store.set("seed", 0)
        victim = _leader(store)
        reached = threading.Event()
        if when == "queued":  # the writer thread busy: the batch waits in the queue
            victim.store._write_exec.submit(release.wait, PATIENCE)
            reached.set()
        else:  # the batch's transaction committed, its callers not yet resolved
            commit = victim.store._repl_committed

            def held(record):
                commit(record)
                if record is not None and not reached.is_set():
                    reached.set()
                    release.wait(PATIENCE)

            victim.store._repl_committed = held
        writes = [asyncio.create_task(store.set(f"w{i}", {"v": i})) for i in range(20)]
        await asyncio.sleep(0)
        assert await asyncio.to_thread(reached.wait, PATIENCE)
        victim.crash()
        release.set()
        done = await asyncio.wait_for(asyncio.gather(*writes, return_exceptions=True), PATIENCE)
        acked = [f"w{i}" for i, r in enumerate(done) if not isinstance(r, BaseException)]
        await _wait_for(lambda: store.leader_member() not in (None, victim.node_id),
                        "a new leader")
        leader = _leader(store)
        survivor = next(n for n in store.nodes if n not in (victim, leader))
        await _wait_for(lambda: survivor.store.repl_position() == leader.store.repl_position(),
                        "the surviving follower")
        for node in (leader, survivor):
            held = [await node.store.get(k) for k in acked]
            assert [item and item.value for item in held] == [
                {"v": int(k[1:])} for k in acked], node.node_id
        assert acked == [f"w{i}" for i in range(20)], done  # each went again to the new leader
        victim.revive()
        await _wait_for(lambda: _in_step(store), "the old leader's resync")
        assert [(await victim.store.get(k)).value for k in acked] == [
            {"v": int(k[1:])} for k in acked]
    finally:
        release.set()
        await store.aclose()


# -- the ack quorum -------------------------------------------------------------------

async def test_a_write_fails_its_quorum_when_the_follower_never_answers(tmp_path, monkeypatch):
    """RF 2, quorum 2: the follower's link never answers, so a write is
    committed on the leader and fails with ReplicationQuorumError at the
    ack timeout. The writer thread is not held: a read and another write
    on the leader go through meanwhile."""
    monkeypatch.setenv("TASKSRUNNER_REPL_ACK_TIMEOUT_SECONDS", "1.0")
    monkeypatch.setenv("TASKSRUNNER_REPL_LEASE_SECONDS", "30")
    store = _build(tmp_path, replicas=2, ack_quorum=2)
    try:
        await store.set("seed", {"v": 0})
        leader = _leader(store)
        shipped = _silence(next(n for n in store.nodes if n is not leader))
        writes = [asyncio.create_task(store.set(f"unreplicated-{i}", {"v": i}))
                  for i in range(3)]
        for i in range(3):  # committed on the leader, its writer free
            while await leader.store.get(f"unreplicated-{i}") is None:
                await asyncio.sleep(0.01)
        done = await asyncio.wait_for(asyncio.gather(*writes, return_exceptions=True), PATIENCE)
        assert [type(e) for e in done] == [ReplicationQuorumError] * 3
        assert shipped and ReplicationQuorumError.http_status == 503
    finally:
        store.close()


async def test_one_silent_follower_does_not_hold_a_majority_back(tmp_path, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_REPL_LEASE_SECONDS", "30")
    store = _build(tmp_path, replicas=3, ack_quorum=2)
    try:
        await store.set("seed", 0)
        leader = _leader(store)
        await _wait_for(lambda: _in_step(store), "the members")
        silent, other = (n for n in store.nodes if n is not leader)
        _silence(silent)
        await asyncio.wait_for(asyncio.gather(*(store.set(f"k{i}", i) for i in range(50))),
                               PATIENCE)
        assert other.store.repl_position() == leader.store.repl_position()
        assert silent.store.repl_position()[0] < leader.store.repl_position()[0]
    finally:
        store.close()


# -- resync ---------------------------------------------------------------------------

@pytest.mark.parametrize("retain", [4096, 4])
async def test_a_follower_back_from_a_crash_is_resynced(tmp_path, monkeypatch, retain):
    """By the log, or by a snapshot once the log no longer holds the gap."""
    monkeypatch.setenv("TASKSRUNNER_REPL_LOG_RETAIN", str(retain))
    store = _build(tmp_path, replicas=2, ack_quorum=1)
    try:
        await store.set("warm", {"v": 0})
        leader = _leader(store)
        follower = next(n for n in store.nodes if n is not leader)
        follower.crash()
        for i in range(40):
            await store.set(f"gap{i}", {"v": i})
        assert follower.store.repl_position()[0] < leader.store.repl_position()[0]
        follower.revive()
        await _wait_for(lambda: _in_step(store), "the follower's catch-up")
        for key, value in (("warm", 0), ("gap0", 0), ("gap39", 39)):
            assert (await follower.store.get(key)).value == {"v": value}
        with sqlite3.connect(follower.store.path) as con:
            logged = con.execute("SELECT COUNT(*) FROM repl_log").fetchone()[0]
        assert logged == (0 if retain == 4 else 42)  # a snapshot leaves no log
    finally:
        await store.aclose()


# -- follower reads ---------------------------------------------------------------------

async def test_follower_reads_keep_to_the_lag_bound_and_their_cache(tmp_path):
    store = _build(tmp_path, replicas=2, ack_quorum=1, follower_reads=True, max_lag=5,
                   cache_size=64)
    try:
        await store.set("k", {"v": "fresh"})
        leader = _leader(store)
        follower = next(n for n in store.nodes if n is not leader)
        await _wait_for(lambda: _in_step(store), "the follower")
        assert (await store.read_follower("k", member=follower.node_id)).value == {"v": "fresh"}
        await store.set("k", {"v": "second"})
        await _wait_for(lambda: _in_step(store), "the follower")
        # the follower's read cache took the applied record
        assert follower.store._cache_get("k")[0] == '{"v":"second"}'
        assert (await store.read_follower("k")).value == {"v": "second"}
        follower.crash()
        for i in range(20):  # 20 records behind: past the bound of 5
            await store.set(f"lag{i}", {"v": i})
        await store.set("k", {"v": "newer"})
        with pytest.raises(StaleReadError, match="lags 21 records"):
            await store.read_follower("k", member=follower.node_id)
        assert (await store.get("k")).value == {"v": "newer"}  # the leader serves
        follower.revive()
        await _wait_for(lambda: _in_step(store), "the follower's catch-up")
        assert (await store.read_follower("k", member=follower.node_id)).value == {"v": "newer"}
        assert StaleReadError.http_status == 503
    finally:
        await store.aclose()


# -- shards of replica sets -------------------------------------------------------------

async def test_a_sharded_replicated_store_routes_and_survives_a_crash(tmp_path):
    store = _build(tmp_path, "grid", shards=2, replicas=2, ack_quorum=2)
    try:
        for i in range(30):
            await store.set(f"k{i}", {"v": i})
        for i, child in enumerate(store._shards):
            assert sorted(await child.keys()) == sorted(
                f"k{j}" for j in range(30) if store.router.shard_of(f"k{j}") == i)
        shard0 = store._shards[0]
        victim = _leader(shard0)
        victim.crash()
        for i in range(30):
            assert (await store.get(f"k{i}")).value == {"v": i}
        asyncio.get_running_loop().call_later(0.2, victim.revive)  # quorum 2 needs it back
        await store.set("k0-after", {"v": 1})
        assert (await store.get("k0-after")).value == {"v": 1}
        assert store.placement_doc()["leaders"]["0"] != victim.node_id
    finally:
        await store.aclose()
    assert {"grid-shard0.db", "grid-shard1.db", "grid-shard0-r1.db", "grid-shard1-r1.db",
            "grid-repl-meta.db"} <= {p.name for p in tmp_path.iterdir()}


async def test_migrating_a_shard_to_a_member_hands_its_leadership_over(tmp_path, monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_REPL_LEASE_SECONDS", "5")
    store = _build(tmp_path, "mv", shards=2, replicas=3)
    try:
        await asyncio.gather(*(store.set(f"k{i}", i) for i in range(60)))
        child = store._shards[1]
        old = _leader(child)
        writes = [asyncio.create_task(store.set(f"late-{i}", i)) for i in range(30)]
        result = await store.migrate_shard(1, member="r2")
        await asyncio.gather(*writes)
        assert (result["action"], result["shard"], result["target"], result["epoch"]) == \
            ("move", 1, "r2", 2)
        assert child.leader_member() == "r2" and not old.is_leader
        assert child.nodes[2].store.repl_position()[1] == 2  # the lease's epoch, bumped
        assert store.placement.assignment == {1: "r2"}
        doc = store.placement_doc()
        assert doc["leaders"] == {"0": "r0", "1": "r2"} and doc["local_member"] is None
        await store.set("after", 1)
        await _wait_for(lambda: _in_step(child), "the members of shard 1")
        every = [f"k{i}" for i in range(60)] + [f"late-{i}" for i in range(30)] + ["after"]
        assert None not in await store.bulk_get(every)
        again = await store.migrate_shard(1, member="r2")  # the leader already
        assert (again["epoch"], child.leader_member()) == (3, "r2")
    finally:
        await store.aclose()


async def test_a_split_makes_a_replica_set_of_the_same_size(tmp_path):
    store = _build(tmp_path, "sp", shards=2, replicas=3)
    try:
        await asyncio.gather(*(store.set(f"k{i}", i) for i in range(200)))
        writes = [asyncio.create_task(store.set(f"w{i}", i)) for i in range(40)]
        result = await store.split_shard()
        await asyncio.gather(*writes)
        assert result["shards"] == 3 and store.shard_count == 3
        new = store._shards[2]
        assert isinstance(new, ReplicaSetStore) and len(new.nodes) == 3
        await _wait_for(lambda: _in_step(new), "the new set's members")
        held = await new.keys()
        assert held and all(store.router.shard_of(k) == 2 for k in held)
        for node in new.nodes:
            assert sorted(await node.store.keys()) == sorted(held)
        every = [f"k{i}" for i in range(200)] + [f"w{i}" for i in range(40)]
        assert [i.value for i in await store.bulk_get(every)] == list(range(200)) + list(
            range(40))
        assert sorted(await store.keys()) == sorted(every)
    finally:
        await store.aclose()
    assert (tmp_path / "sp-shard2-r2.db").exists()
    with sqlite3.connect(tmp_path / "sp-repl-meta.db") as con:
        leases = {k: json.loads(v) for k, v in con.execute("SELECT key, value FROM state")}
    # every leader released its lease at the close, the split's set's too:
    # the set that owns the lease store closed it last
    assert sorted(leases) == [f"repl-lease||sp||{i}" for i in range(3)]
    assert [rec["expires"] for rec in leases.values()] == [0.0] * 3


async def test_a_cross_shard_transaction_commits_after_replication(tmp_path):
    """The staged commit on replica sets: the record is appended at commit,
    not at stage (a rolled-back stage leaves none), and the commit resolves
    once the quorum holds it."""
    store = _build(tmp_path, "tx", shards=2, replicas=2, ack_quorum=2)
    try:
        keys = {}
        for i in range(40):
            keys.setdefault(store.router.shard_of(f"t{i}"), f"t{i}")
        a, b = keys[0], keys[1]
        await asyncio.gather(store.set(a, 0), store.set(b, 0))
        positions = [c.nodes[0].store.repl_position() for c in store._shards]
        with pytest.raises(EtagMismatch):
            await store.transact([TransactionOp("upsert", a, 1),
                                  TransactionOp("upsert", b, 1, etag="999")])
        assert [c.nodes[0].store.repl_position() for c in store._shards] == positions
        await store.transact([TransactionOp("upsert", a, 2), TransactionOp("upsert", b, 2)])
        for child, key in zip(store._shards, (a, b)):
            assert _in_step(child)
            assert [(await n.store.get(key)).value for n in child.nodes] == [2, 2]
    finally:
        await store.aclose()


# -- the client's placement epoch ---------------------------------------------------------

async def test_the_client_retries_once_on_a_new_epoch_then_raises(monkeypatch):
    sent, answers = [], []

    async def fake_request(host, port, method, path, *, headers=None, body=b""):
        sent.append(dict(headers or {}).get(PLACEMENT_EPOCH_HEADER))
        return answers.pop(0)

    monkeypatch.setattr(client_mod, "http_request", fake_request)
    app = client_mod.AppClient.http(port=1)
    stale = (409, {PLACEMENT_EPOCH_HEADER: "2"}, b'{"error": "stale"}')
    answers[:] = [stale, (200, {}, json.dumps({"v": 1}).encode())]
    assert await app.get_state("scores", "k") == {"v": 1}
    assert sent == [None, "2"]
    answers[:] = [(204, {}, b"")]
    await app.save_state("scores", "k", 1)
    assert sent[-1] == "2"  # the cached epoch goes with the next call
    answers[:] = [stale, (409, {PLACEMENT_EPOCH_HEADER: "3"}, b"")]
    with pytest.raises(PlacementEpochError) as err:
        await app.query_state("scores", {})
    assert err.value.current_epoch == 3 and sent[-2:] == ["2", "2"]
    answers[:] = [(200, {}, b'{"results": []}')]
    await app.query_state("scores", {})
    assert sent[-1] == "3"
    # a 409 without the header is an etag conflict, not retried
    answers[:] = [(409, {}, b'{"error": "etag"}')]
    with pytest.raises(client_mod.InvocationError):
        await app.save_state("scores", "k", 2)
    assert answers == []


async def test_the_replicator_is_attached_to_its_leader_alone(tmp_path):
    store = _build(tmp_path, replicas=3)
    try:
        await store.set("k", 1)
        leader = _leader(store)
        assert isinstance(leader.store._repl, ShardReplicator)
        assert [n.store._repl is None for n in store.nodes if n is not leader] == [True] * 2
    finally:
        await store.aclose()
    assert all(n.store._repl is None for n in store.nodes)
