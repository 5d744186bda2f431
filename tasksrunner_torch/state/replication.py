"""Replica sets: the port of ``tasksrunner/state/replication.py`` (a
shard's members with a leased leader, epoch fencing and ack after
replication), in-process, without its chaos and mesh hooks.

* **Members.** Each member of a shard is a whole
  :class:`~tasksrunner_torch.state.sqlite.SqliteStateStore` with the
  record stream on (``repl_log``, ``repl_meta``) and a role loop
  (:class:`ReplicationNode`). Member 0 keeps the unreplicated file's
  name, the others add ``-rM`` (:func:`_member_path`); the leases live in
  one ``{stem}-repl-meta`` store shared by the shards.
* **Leadership.** One member at a time holds the shard's
  :class:`~tasksrunner_torch.state.lease.Lease` (key
  ``repl-lease||{store}||{shard}``) and leads: it renews the lease every
  third of its life, the others contend for it once it has expired. A
  member that takes the lease first writes a barrier record at the new,
  higher epoch, then ships (:class:`ShardReplicator`): one task a
  follower streams the log from that follower's acknowledged position; a
  follower with a gap gets the missing records, one whose log diverged or
  lies before the retained window gets a snapshot.
* **Ack after replication.** With ``ackQuorum`` > 1 a write's callers
  resolve once that many members (the leader among them) hold its
  record. The writer thread hands the record over and goes on; the loop
  resolves the callers from the followers' acks, or fails them with
  :class:`~tasksrunner_torch.errors.ReplicationQuorumError` at the ack
  timeout.
* **Fencing.** Followers refuse records below their epoch, so a deposed
  leader's late commit fails :class:`~tasksrunner_torch.errors.ReplicaFencedError`
  and was never acknowledged; that member then waits to be resynced
  before it may lead again. :class:`ReplicaSetStore` retries a write once
  on the new leader after a fenced or leaderless attempt.
* **Follower reads.** ``followerReads`` serves reads from a follower
  within ``maxLagRecords`` of the leader, else from the leader;
  :meth:`ReplicaSetStore.read_follower` raises
  :class:`~tasksrunner_torch.errors.StaleReadError` past the bound.

Metrics, with the JAX names and labels (``store``, ``shard``, and
``member`` where one is named): ``repl_epoch``, ``repl_failover_total``,
``repl_fenced_total``, ``repl_follower_lag_records`` and
``repl_records_total``. With spans recorded, ``repl-ship``,
``repl-apply`` and ``repl-ack`` join the trace of the write whose
traceparent the record carries.

Not ported: the replication lane's chaos (``kind: Chaos``, ROADMAP A23)
and members in other processes over the mesh (``state/replmesh.py``,
A22).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import pathlib
import time
from typing import Any, Callable

from tasksrunner_torch import spans
from tasksrunner_torch.envflag import env_number
from tasksrunner_torch.errors import (
    ComponentError, NotLeaderError, ReplicaFencedError, ReplicationError, ReplicationGapError,
    ReplicationQuorumError, StaleReadError, StateError,
)
from tasksrunner_torch.ids import hex8
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.state.base import QueryResponse, StateItem, TransactionOp
from tasksrunner_torch.state.lease import Lease
from tasksrunner_torch.state.sqlite import SqliteStateStore, _shard_path
from tasksrunner_torch.tracing import TraceContext

logger = logging.getLogger(__name__)

#: each member is a whole engine (a file, threads, connections): past 5
#: the writes it multiplies cost more availability than they buy
MAX_REPLICAS = 5

DEFAULT_ACK_TIMEOUT_SECONDS = 10.0
DEFAULT_MAX_LAG_RECORDS = 256


def ack_timeout_default() -> float:
    return env_number("TASKSRUNNER_REPL_ACK_TIMEOUT_SECONDS", DEFAULT_ACK_TIMEOUT_SECONDS)


def max_lag_default() -> int:
    return int(env_number("TASKSRUNNER_REPL_MAX_LAG_RECORDS", DEFAULT_MAX_LAG_RECORDS))


def _batch_tp(records: list[dict]) -> str | None:
    """The traceparent of a shipped batch: its first record's that has one."""
    return next((rec["tp"] for rec in records if rec.get("tp")), None)


def _tp_span(tp: str | None, *, name: str, kind: str, status: int, start: float,
             duration: float, attrs: dict) -> None:
    """A span in the trace of the write whose traceparent ``tp`` is: the
    replication loops run far from that write's context."""
    if tp is None or not spans.active():
        return
    ctx = TraceContext.parse(tp)
    if ctx is not None:
        spans.record_span(name=name, kind=kind, status=status, start=start, duration=duration,
                          attrs=attrs, trace_id=ctx.trace_id, span_id=hex8(),
                          parent_id=ctx.span_id)


def _fenced(store: SqliteStateStore) -> ReplicaFencedError:
    return ReplicaFencedError(f"state store {store.name!r}: leadership lost (epoch fenced); "
                              "the write was not acked")


class LocalLink:
    """The leader's handle on a follower in this process: ``append``,
    ``install`` and ``position``, the protocol a link across processes
    would carry."""

    def __init__(self, node: ReplicationNode) -> None:
        self._node = node

    async def append(self, records: list[dict]) -> int:
        return await self._node.apply_records(records)

    async def install(self, snapshot: dict) -> None:
        await self._node.install_snapshot(snapshot)

    async def position(self) -> tuple[int, int]:
        return self._node.position()


class _Pending:
    """A record committed on the leader, waiting for its ack quorum."""

    __slots__ = ("record", "resolve", "fail", "acks", "deadline", "admitted")

    def __init__(self, record: dict, resolve: Callable[[], None],
                 fail: Callable[[BaseException], None], first_ack: str, deadline: float) -> None:
        self.record = record
        self.resolve = resolve
        self.fail = fail
        self.acks = {first_ack}
        self.deadline = deadline
        #: the repl-ack span runs from the commit to the quorum
        self.admitted = time.time()


class ShardReplicator:
    """The leader's replication session for one shard, attached to its
    store as ``_repl``. The store calls :meth:`on_commit` from the writer
    thread after each record; the callers resolve at the quorum, fail
    with :class:`ReplicationQuorumError` at the ack timeout, or with
    :class:`ReplicaFencedError` once a follower has seen a higher epoch
    (which fences the whole session)."""

    def __init__(self, node: ReplicationNode, *, epoch: int, ack_quorum: int,
                 ack_timeout: float) -> None:
        self._node = node
        self._store = node.store
        self._loop = asyncio.get_running_loop()
        self.epoch = int(epoch)
        self.ack_quorum = max(1, int(ack_quorum))
        self.ack_timeout = float(ack_timeout)
        self.fenced = False
        self._closed = False
        self._pending: collections.OrderedDict[int, _Pending] = collections.OrderedDict()
        self._member_hwm: dict[str, int] = {}
        self._wake: dict[str, asyncio.Event] = {}
        self._tasks: list[asyncio.Task] = []

    def start(self) -> None:
        for member, link in self._node.links.items():
            self._member_hwm[member] = 0
            self._wake[member] = asyncio.Event()
            self._wake[member].set()  # a catch-up pass at once
            self._tasks.append(asyncio.ensure_future(self._ship_loop(member, link)))
        self._tasks.append(asyncio.ensure_future(self._timeout_loop()))

    # -- the writer thread's side ------------------------------------------

    def on_commit(self, record: dict, resolve: Callable[[], None],
                  fail: Callable[[BaseException], None]) -> None:
        """A record committed on the leader; ``resolve`` and ``fail``
        settle its callers from any thread."""
        if self.fenced:
            fail(_fenced(self._store))
            return
        pending: Callable[[], None] | None = resolve
        if self.ack_quorum <= 1:  # the leader alone: acked now, shipped later
            resolve()
            pending = None
        try:
            self._loop.call_soon_threadsafe(self._admit, record, pending, fail)
        except RuntimeError:  # the loop is closed (shutdown)
            if pending is not None:
                fail(StateError(f"state store {self._store.name!r}: replication session "
                                "closed before the write could be acked"))

    # -- the loop's side -------------------------------------------------------

    def _admit(self, record: dict, resolve: Callable[[], None] | None,
               fail: Callable[[BaseException], None]) -> None:
        if resolve is not None:
            if self._closed or self.fenced:
                fail(_fenced(self._store) if self.fenced else StateError(
                    f"state store {self._store.name!r}: replication session closed"))
                return
            self._pending[record["seq"]] = _Pending(
                record, resolve, fail, self._node.node_id, time.monotonic() + self.ack_timeout)
        for evt in self._wake.values():
            evt.set()

    def _on_ack(self, member: str, hwm: int) -> None:
        done = []
        for seq, p in self._pending.items():
            if seq > hwm:
                break
            p.acks.add(member)
            if len(p.acks) >= self.ack_quorum:
                done.append(seq)
        now = time.time()
        for seq in done:
            p = self._pending.pop(seq)
            p.resolve()
            _tp_span(p.record.get("tp"), name="repl-ack", kind="internal", status=200,
                     start=p.admitted, duration=now - p.admitted,
                     attrs={"seq": seq, "acks": len(p.acks), "quorum": self.ack_quorum,
                            "store": self._store.name})

    async def _ship_loop(self, member: str, link: Any) -> None:
        labels = self._node.metric_labels
        backoff = 0.05
        primed = force_snapshot = False
        while not self._closed and not self.fenced:
            evt = self._wake[member]
            evt.clear()
            try:
                if not primed:
                    hwm, f_epoch = await link.position()
                    self._member_hwm[member] = hwm
                    # log matching: the follower's log is a prefix of ours
                    # only if our record at its hwm has its epoch; a
                    # zombie that committed past our barrier gets a snapshot
                    if hwm > 0 and await self._run_store(
                            self._store.read_repl_epoch_at, hwm) != f_epoch:
                        force_snapshot = True
                    primed = True
                leader_hwm, _ = self._store.repl_position()
                sent = self._member_hwm[member]
                metrics.set_gauge("repl_follower_lag_records", max(0, leader_hwm - sent),
                                  member=member, **labels)
                if not force_snapshot and sent >= leader_hwm:
                    await evt.wait()
                    continue
                records = None if force_snapshot else await self._run_store(
                    self._store.read_repl_log, sent)
                if records is None:  # pruned past the gap, or diverged
                    snap = await self._run_store(self._store.read_repl_snapshot)
                    await link.install(snap)
                    acked = int(snap["hwm"])
                    force_snapshot = False
                else:
                    ship_wall, ship_t0 = time.time(), time.monotonic()
                    acked = await link.append(records)
                    metrics.inc("repl_records_total", len(records), member=member, **labels)
                    _tp_span(_batch_tp(records), name="repl-ship", kind="producer", status=200,
                             start=ship_wall, duration=time.monotonic() - ship_t0,
                             attrs={"member": member, "records": len(records), **labels})
                self._member_hwm[member] = acked
                self._on_ack(member, acked)
                backoff = 0.05
            except ReplicationGapError as exc:
                if exc.diverged:
                    force_snapshot = True
                else:
                    self._member_hwm[member] = exc.hwm
            except ReplicaFencedError:
                self._fence()
                return
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - a follower down: back off, the timeout fails writes
                primed = False
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 0.5)

    async def _timeout_loop(self) -> None:
        interval = max(0.02, min(self.ack_timeout / 4, 1.0))
        while not self._closed and not self.fenced:
            await asyncio.sleep(interval)
            now = time.monotonic()
            for seq in [seq for seq, p in self._pending.items() if p.deadline <= now]:
                self._pending.pop(seq).fail(ReplicationQuorumError(
                    f"state store {self._store.name!r}: record seq {seq} did not reach ack "
                    f"quorum {self.ack_quorum} within {self.ack_timeout}s — the replica set is "
                    "degraded"))

    async def _run_store(self, fn, *args):
        return await self._loop.run_in_executor(self._store._write_exec, fn, *args)

    def _fence(self) -> None:
        """Leadership is gone: every pending write fails and every later
        one too. The session stays attached to the store, so a late
        flush fails fast until a new leader resyncs this member."""
        if self.fenced:
            return
        self.fenced = True
        metrics.inc("repl_fenced_total", **self._node.metric_labels)
        pending, self._pending = self._pending, collections.OrderedDict()
        err = _fenced(self._store)
        for p in pending.values():
            p.fail(err)
        self._node._needs_resync = True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for t in self._tasks:
            t.cancel()
        for evt in self._wake.values():
            evt.set()
        pending, self._pending = self._pending, collections.OrderedDict()
        err = StateError(f"state store {self._store.name!r}: replication session closed")
        for p in pending.values():
            p.fail(err)


class ReplicationNode:
    """One member of a shard's replica set: its engine and the role loop
    that renews the shard's lease while leading and contends for it
    while following."""

    def __init__(self, name: str, path: str | pathlib.Path, *, member: int, shard: int,
                 meta_store: Any, ack_quorum: int = 2, group_commit: bool = True,
                 cache_size: int = 0, shard_label: int | None = None) -> None:
        self.name = name
        self.member = int(member)
        self.node_id = f"r{member}"
        self.shard = int(shard)
        self.ack_quorum = int(ack_quorum)
        self.ack_timeout = ack_timeout_default()
        self.store = SqliteStateStore(name, path, replication=True, group_commit=group_commit,
                                      cache_size=cache_size, shard=shard_label)
        self.lease = Lease(meta_store, f"repl-lease||{name}||{shard}")
        #: links to the other members, set by build_replicated_store
        self.links: dict[str, LocalLink] = {}
        self.replicator: ShardReplicator | None = None
        #: a host's loss, simulated: protocol calls raise OSError and the
        #: role loop idles
        self.crashed = False
        #: a stalled leader: it stops renewing but goes on taking writes
        #: until it is fenced
        self.renewal_paused = False
        # lost leadership with a log that may have diverged: it must not
        # lead again before the new leader has resynced it, or its unacked
        # suffix could overwrite acknowledged writes
        self._needs_resync = False
        self._running = False
        self._task: asyncio.Task | None = None

    @property
    def metric_labels(self) -> dict:
        return {"store": self.name, "shard": self.shard}

    @property
    def is_leader(self) -> bool:
        return self.replicator is not None and not self.replicator.fenced

    async def start(self) -> None:
        if self._task is None:
            self._running = True
            self._task = asyncio.ensure_future(self._role_loop())

    def _retire(self) -> None:
        if self.replicator is not None:
            self.replicator.close()
            self.replicator = None
            self.store._repl = None

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None
        if self.is_leader and not self.crashed:
            try:
                await self.lease.release(self.node_id)
            except Exception:  # noqa: BLE001 - the meta store may be gone already
                logger.debug("lease release failed for %s/%s %s", self.name, self.shard,
                             self.node_id, exc_info=True)
        self._retire()

    def crash(self) -> None:
        """A host's loss: protocol calls fail, the role loop idles, the
        lease is left to expire."""
        self.crashed = True
        if self.replicator is not None:
            self._retire()
            self._needs_resync = True

    def revive(self) -> None:
        self.crashed = False

    # -- the role loop -------------------------------------------------------

    async def _role_loop(self) -> None:
        interval = self.lease.lease_seconds / 3.0
        if self.member:  # member 0 contends first at a cold start
            await asyncio.sleep(min(interval, 0.03 * self.member))
        while self._running:
            try:
                if not self.crashed:
                    await self._tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - the next tick tries again
                logger.debug("replication %s/%s %s: role tick failed", self.name, self.shard,
                             self.node_id, exc_info=True)
            await asyncio.sleep(interval)

    async def _tick(self) -> None:
        if not self.is_leader:
            await self._maybe_promote()
        elif not self.renewal_paused and not await self.lease.renew(self.node_id):
            # the lease was taken: fence now, not when a follower refuses
            if self.replicator is not None:
                self.replicator._fence()

    async def _maybe_promote(self) -> None:
        rec = await self.lease.peek()
        if (rec is not None and not Lease.holder_gone(rec)) or self._needs_resync:
            return
        # not while a reachable peer is ahead: our stream would cut its
        # acked suffix (an unreachable one is resynced when it returns)
        my_hwm, _ = self.store.repl_position()
        for link in self.links.values():
            try:
                hwm, _ = await link.position()
            except Exception:  # noqa: BLE001 - a member down cannot object
                continue
            if hwm > my_hwm:
                return
        epoch = await self.lease.acquire(self.node_id)
        if epoch is None:
            return
        promoted = False
        try:
            if not self._needs_resync:
                await self._become_leader(epoch)
                promoted = True
        finally:
            if not promoted:
                # fenced while the probes ran: our log may be behind, so
                # hand the lease back (shielded: a cancel still surrenders)
                await asyncio.shield(self.lease.release(self.node_id))

    async def _become_leader(self, epoch: int) -> None:
        self._retire()
        # the barrier: durable at the new epoch before any data at it
        await asyncio.get_running_loop().run_in_executor(
            self.store._write_exec, self.store.append_repl_barrier, epoch)
        self.replicator = ShardReplicator(self, epoch=epoch, ack_quorum=self.ack_quorum,
                                          ack_timeout=self.ack_timeout)
        self.store._repl = self.replicator
        self.replicator.start()
        self._needs_resync = False
        metrics.set_gauge("repl_epoch", epoch, **self.metric_labels)
        if epoch > 1:
            metrics.inc("repl_failover_total", **self.metric_labels)
        logger.info("replication: %s shard %d: %s is leader (epoch %d)", self.name, self.shard,
                    self.node_id, epoch)

    # -- the follower's side (called through links) -------------------------

    def _check_up(self) -> None:
        if self.crashed:
            raise OSError(f"replica member {self.node_id} is down")

    async def apply_records(self, records: list[dict]) -> int:
        self._check_up()
        _, prev_epoch = self.store.repl_position()
        apply_wall, apply_t0 = time.time(), time.monotonic()
        hwm = await asyncio.get_running_loop().run_in_executor(
            self.store._write_exec, self.store.apply_repl_records, records)
        _tp_span(_batch_tp(records), name="repl-apply", kind="consumer", status=200,
                 start=apply_wall, duration=time.monotonic() - apply_t0,
                 attrs={"member": self.node_id, "records": len(records), **self.metric_labels})
        if self.store.repl_position()[1] > prev_epoch:
            # a new leader's records applied cleanly: our log is a prefix
            # of its log, so we may contend again
            self._accept_new_leader()
        return hwm

    async def install_snapshot(self, snapshot: dict) -> None:
        self._check_up()
        await asyncio.get_running_loop().run_in_executor(
            self.store._write_exec, self.store.install_repl_snapshot, snapshot)
        self._accept_new_leader()

    def position(self) -> tuple[int, int]:
        self._check_up()
        return self.store.repl_position()

    def _accept_new_leader(self) -> None:
        self._retire()
        self._needs_resync = False


class ReplicaSetStore:
    """One shard's replica set as a state store. Writes go to the lease
    holder, with one retry after a fenced or leaderless attempt (the
    write was not applied); reads to the leader or, with
    ``followerReads``, to a follower within the lag bound. The members
    start on first use: components are built with no loop running."""

    def __init__(self, name: str, nodes: list[ReplicationNode], *, shard: int = 0,
                 follower_reads: bool = False, max_lag: int | None = None,
                 meta_store: Any = None, owns_meta: bool = False) -> None:
        self.name = name
        self.nodes = nodes
        self.shard = int(shard)
        self.follower_reads = bool(follower_reads)
        self.max_lag = int(max_lag) if max_lag else max_lag_default()
        self._meta = meta_store
        #: this set closes the lease store the shards share, so a sharded
        #: facade closes it after every other set
        self.owns_meta = bool(owns_meta)
        self._started = False
        self._rr = 0

    async def _ensure_started(self) -> None:
        if not self._started:
            self._started = True
            for node in self.nodes:
                await node.start()

    def _live_leader(self) -> ReplicationNode | None:
        return next((n for n in self.nodes if n.is_leader and not n.crashed), None)

    async def _leader_node(self) -> ReplicationNode:
        await self._ensure_started()
        lease_s = self.nodes[0].lease.lease_seconds
        deadline = time.monotonic() + 3.0 * lease_s + 1.0
        while (leader := self._live_leader()) is None:
            if time.monotonic() > deadline:
                raise NotLeaderError(f"state store {self.name!r} shard {self.shard}: no member "
                                     "holds the shard lease")
            await asyncio.sleep(min(0.02, lease_s / 10.0))
        return leader

    def leader_member(self) -> str | None:
        return next((n.node_id for n in self.nodes if n.is_leader), None)

    def member_lag(self, member: str) -> int | None:
        """The records ``member`` trails the leader by; None with no live
        leader. 0 when ``member`` leads (it won a takeover meanwhile)."""
        leader = self._live_leader()
        if leader is None or leader.replicator is None:
            return None
        if leader.node_id == member:
            return 0
        hwm, _ = leader.store.repl_position()
        return max(0, hwm - leader.replicator._member_hwm.get(member, 0))

    async def transfer_leadership(self, member: str) -> int:
        """Hand the lease to ``member``, with the writers quiesced by the
        caller (the sharded facade's flip): wait until its log has the
        leader's hwm, retire the leader's session, release the lease,
        take it for ``member`` (the epoch goes up as in a takeover) and
        promote it through the barrier. Returns the new epoch. A leader
        lost meanwhile leaves it to the ordinary failover."""
        await self._ensure_started()
        target = next((n for n in self.nodes if n.node_id == member), None)
        where = f"state store {self.name!r} shard {self.shard}"
        if target is None:
            raise ReplicationError(f"{where}: no member {member!r}")
        if target.crashed:
            raise ReplicationError(f"{where}: member {member!r} is down")
        leader = await self._leader_node()
        if leader is target:
            return leader.store.repl_position()[1]
        deadline = time.monotonic() + 2.0 * leader.ack_timeout
        while True:
            if leader.crashed or not leader.is_leader:
                raise NotLeaderError(f"{where}: leadership moved mid-transfer — retry against "
                                     "the new leader")
            leader_hwm, _ = leader.store.repl_position()
            try:
                hwm, _ = target.position()
            except OSError as exc:
                raise ReplicationError(f"{where}: transfer target {member!r} went down") from exc
            if hwm >= leader_hwm:
                break
            if time.monotonic() > deadline:
                raise ReplicationError(f"{where}: {member!r} still trails by "
                                       f"{leader_hwm - hwm} records at the transfer deadline")
            await asyncio.sleep(0.01)
        # nothing is pending (the writers are quiesced): retire cleanly
        leader._retire()
        await leader.lease.release(leader.node_id)
        epoch = None
        for _ in range(3):
            epoch = await target.lease.acquire(target.node_id)
            if epoch is not None:
                break
            rec = await target.lease.peek()
            if (rec is not None and rec.get("owner") != target.node_id
                    and not Lease.holder_gone(rec)):
                raise NotLeaderError(f"{where}: {rec.get('owner')!r} won the takeover race "
                                     f"during the transfer to {member!r}")
        if epoch is None:
            raise NotLeaderError(f"{where}: could not acquire the shard lease for {member!r}")
        await target._become_leader(epoch)
        return epoch

    # -- writes ------------------------------------------------------------

    async def _write(self, fn) -> Any:
        await self._ensure_started()
        last: BaseException | None = None
        for _ in range(2):
            node = await self._leader_node()
            try:
                return await fn(node)
            except (NotLeaderError, ReplicaFencedError) as exc:
                last = exc  # not applied, not acked: safe to retry on the new leader
        raise last  # type: ignore[misc]

    async def set(self, key: str, value: Any, *, etag: str | None = None) -> str:
        return await self._write(lambda n: n.store.set(key, value, etag=etag))

    async def delete(self, key: str, *, etag: str | None = None) -> bool:
        return await self._write(lambda n: n.store.delete(key, etag=etag))

    async def transact(self, ops: list[TransactionOp]) -> None:
        return await self._write(lambda n: n.store.transact(ops))

    async def stage_transact(self, ops: list[TransactionOp]):
        """Stage on the leader, with no retry: a staged transaction holds
        the commit slot."""
        node = await self._leader_node()
        return await node.store.stage_transact(ops)

    # -- reads -------------------------------------------------------------

    async def _read_node(self) -> ReplicationNode:
        leader = await self._leader_node()
        if not self.follower_reads:
            return leader
        leader_hwm, _ = leader.store.repl_position()
        n = len(self.nodes)
        for i in range(n):
            node = self.nodes[(self._rr + i) % n]
            if node is leader or node.crashed:
                continue
            if leader_hwm - node.store.repl_position()[0] <= self.max_lag:
                self._rr = (self._rr + i + 1) % n
                return node
        return leader  # every follower past the bound

    async def get(self, key: str) -> StateItem | None:
        return await (await self._read_node()).store.get(key)

    async def get_strong(self, key: str) -> StateItem | None:
        """A read from the leader whatever ``followerReads`` says: it sees
        every acknowledged write (the actor runtime's reads)."""
        return await (await self._leader_node()).store.get(key)

    async def bulk_get(self, keys: list[str]) -> list[StateItem | None]:
        return await (await self._read_node()).store.bulk_get(keys)

    async def query(self, query: dict, *, key_prefix: str = "") -> QueryResponse:
        return await (await self._read_node()).store.query(query, key_prefix=key_prefix)

    async def keys(self, *, prefix: str = "") -> list[str]:
        return await (await self._read_node()).store.keys(prefix=prefix)

    async def read_follower(self, key: str, *, member: str | None = None) -> StateItem | None:
        """Read from a follower (``member``, or the first), raising
        :class:`StaleReadError` rather than redirecting past the bound."""
        leader = await self._leader_node()
        leader_hwm, _ = leader.store.repl_position()
        for node in self.nodes:
            if node is leader or (member is not None and node.node_id != member):
                continue
            lag = leader_hwm - node.store.repl_position()[0]
            if lag > self.max_lag:
                raise StaleReadError(f"state store {self.name!r}: follower {node.node_id} lags "
                                     f"{lag} records (> maxLagRecords {self.max_lag})")
            return await node.store.get(key)
        raise StaleReadError(f"state store {self.name!r}: no follower matches {member!r}")

    # -- lifecycle ---------------------------------------------------------

    async def aclose(self) -> None:
        """Stop the members (a leader releases its lease) and close them."""
        for node in self.nodes:
            await node.stop()
        self._close_stores()

    def close(self) -> None:
        """Without a loop: a crash's equivalent, the leases left to expire."""
        for node in self.nodes:
            node._running = False
            if node._task is not None:
                node._task.cancel()
                node._task = None
            node._retire()
        self._close_stores()

    def _close_stores(self) -> None:
        for node in self.nodes:
            node.store.close()
        if self.owns_meta and self._meta is not None:
            self._meta.close()


def _member_path(path: str, shard: int, member: int, shards: int) -> str:
    """Member ``member`` of shard ``shard``: member 0 keeps the plain
    layout's file (``tasks.db``, ``tasks-shardN.db``), so existing data
    seeds the set; the others add ``-rM``. ``:memory:`` stays."""
    if path == ":memory:":
        return path
    base = path if shards == 1 else _shard_path(path, shard)
    if member == 0:
        return base
    p = pathlib.Path(base)
    return str(p.with_name(f"{p.stem}-r{member}{p.suffix}"))


def _meta_path(path: str) -> str:
    if path == ":memory:":
        return path
    p = pathlib.Path(path)
    return str(p.with_name(f"{p.stem}-repl-meta{p.suffix}"))


def build_replicated_store(name: str, path: str | pathlib.Path = ":memory:", *,
                           shards: int = 1, replicas: int, ack_quorum: int | None = None,
                           hash_seed: str = "", group_commit: bool = True, cache_size: int = 0,
                           follower_reads: bool = False, max_lag: int | None = None):
    """A replica set of ``replicas`` members per shard, one lease store
    for all, behind the sharded facade when ``shards`` > 1. ``ack_quorum``
    defaults to a majority (RF 2 → 2, RF 3 → 2): no acknowledged write is
    lost while a majority lives. ``replicas: 1`` is the plain store. The
    lease, the ack timeout and the log's length are read from
    ``TASKSRUNNER_REPL_LEASE_SECONDS``, ``_ACK_TIMEOUT_SECONDS`` and
    ``_LOG_RETAIN`` as each member is made, a split's members too."""
    from tasksrunner_torch.state.sharding import MAX_SHARDS, ShardedStateStore
    from tasksrunner_torch.state.sqlite import build_sharded_store
    if not 1 <= replicas <= MAX_REPLICAS:
        raise ComponentError(f"state store {name!r}: replicas must be in 1..{MAX_REPLICAS}, "
                             f"not {replicas}")
    if not 1 <= shards <= MAX_SHARDS:
        raise ComponentError(f"state store {name!r}: shards must be in 1..{MAX_SHARDS}, "
                             f"not {shards}")
    if replicas == 1:
        if shards == 1:
            return SqliteStateStore(name, path, group_commit=group_commit, cache_size=cache_size)
        return build_sharded_store(name, path, shards=shards, hash_seed=hash_seed,
                                   group_commit=group_commit, cache_size=cache_size)
    quorum = max(1, min(int(ack_quorum) if ack_quorum else replicas // 2 + 1, replicas))
    per_cache = max(1, cache_size // shards) if cache_size and shards > 1 else cache_size
    meta = SqliteStateStore(f"{name}.repl-meta", _meta_path(str(path)))

    def make_set(s: int, *, owns_meta: bool) -> ReplicaSetStore:
        nodes = [ReplicationNode(name, _member_path(str(path), s, m, shards), member=m, shard=s,
                                 meta_store=meta, ack_quorum=quorum, group_commit=group_commit,
                                 cache_size=per_cache, shard_label=s if shards > 1 else None)
                 for m in range(replicas)]
        for node in nodes:
            node.links = {other.node_id: LocalLink(other) for other in nodes if other is not node}
        return ReplicaSetStore(name, nodes, shard=s, follower_reads=follower_reads,
                               max_lag=max_lag, meta_store=meta, owns_meta=owns_meta)

    sets = [make_set(s, owns_meta=s == shards - 1) for s in range(shards)]
    if shards == 1:
        return sets[0]
    facade = ShardedStateStore(name, sets, hash_seed=hash_seed)
    # a split makes set N the same way; the meta store stays with the
    # original last set, which no split retires and the facade closes last
    facade.child_factory = lambda s: make_set(s, owns_meta=False)
    return facade
