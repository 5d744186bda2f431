"""Sharded state: the port of ``tasksrunner/state/sharding.py``, one store
facade over N independent child stores (N writer threads, N WALs).

* **Routing: rendezvous hashing.** Shard ``i`` has a salt from
  ``(hashSeed, i)``; a key goes to the shard whose ``mix(hash(key) ^
  salt_i)`` is largest (:class:`ShardRouter`, bit for bit the JAX
  router). Growing N → N+1 keeps the old salts, so only the keys the new
  shard wins move: an expected 1/(N+1). Assignment is a pure function of
  ``(key, hashSeed, shards)``, so every replica and restart routes alike.
* **Cross-shard transactions: ordered two-phase commit.** Ops on one
  shard are that shard's one transaction. Ops over several are staged on
  each shard in ascending index order (``stage_transact``: etags checked
  and ops applied in an open transaction whose writer thread parks), so
  concurrent ones cannot deadlock; a stage that fails rolls back every
  staged shard and re-raises. Then the commits, in the same order: if the
  first fails the rest roll back; if a later one fails after others
  committed, :class:`~tasksrunner_torch.errors.CrossShardAtomicityError`
  names the split.
* **Elastic placement.** A :class:`~tasksrunner_torch.state.placement.PlacementMap`
  (an epoch and each shard's host) sits over the router. Every facade
  operation passes a barrier that is open except during a flip's final
  drain; a caller naming a stale epoch is refused (:meth:`check_epoch`).
  :meth:`ShardedStateStore.split_shard` grows the ring online and
  :meth:`ShardedStateStore.migrate_shard` moves a shard: to another
  store with ``target=`` (keys stream while writes go on, a dirty-key tap
  is drained round by round, and the last round, the structural swap and
  the epoch's advance run under the pause,
  :meth:`ShardedStateStore._fenced_flip`), or, for a replica set
  (:mod:`tasksrunner_torch.state.replication`), to another member with
  ``member=``: the record stream is the copy, and the leadership handoff
  runs under the pause.
* **Replica-set children.** The placement document names each shard's
  leader (``leaders``) and this process's member (``local_member``), and
  an online split makes the new shard a replica set of the same size.

The tap notes a key once its write has returned (the JAX facade notes it
before the write: a catch-up read between the two copies the old value
and drops the key from the tap); a ``member=`` handoff uses no tap. Not
ported: ``locality_rank`` (ROADMAP A21, its one caller) and chaos on the
catch-up lane (A23).
"""

from __future__ import annotations

import asyncio
import hashlib
import heapq
import logging
import time
from typing import Any, Callable, Sequence

from tasksrunner_torch.errors import (
    ComponentError, CrossShardAtomicityError, PlacementEpochError, QueryError, StateError,
)
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.state.base import QueryResponse, StateItem, TransactionOp
from tasksrunner_torch.state.placement import (
    PlacementMap, ShardHeatTracker, pause_budget_default,
)
from tasksrunner_torch.state.query import paginate, sort_items, validate_filter

logger = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1

#: each shard is a file, 2-3 threads and 2 connections: past this the
#: fan-out costs more than it buys
MAX_SHARDS = 64
#: catch-up rounds a migration or a split may take before its dirty set
#: must fit the paused round; past them the writers outrun the copy
CATCH_UP_ROUNDS = 8


def _blake64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


def _mix64(x: int) -> int:
    """splitmix64's finalizer: one flipped bit of ``hash ^ salt`` moves
    the whole weight, so the shards' weights are not correlated."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return (x ^ (x >> 31)) & _MASK64


class ShardRouter:
    """Key → shard index by rendezvous hashing, deterministic in
    ``(shards, seed)``, with a bounded memo of answers."""

    __slots__ = ("shards", "seed", "_salts", "_cache")

    #: the memo is cleared whole when it reaches this many keys
    _CACHE_MAX = 65536

    def __init__(self, shards: int, seed: str = "") -> None:
        if not isinstance(shards, int) or shards < 1:
            raise ComponentError(f"shards must be a positive integer, not {shards!r}")
        if shards > MAX_SHARDS:
            raise ComponentError(f"shards must be <= {MAX_SHARDS}, not {shards}")
        self.shards = shards
        self.seed = seed
        # salt i depends on (seed, i) only: growing appends salts
        self._salts = tuple(_blake64(f"{seed}|{i}".encode()) for i in range(shards))
        self._cache: dict[str, int] = {}

    def shard_of(self, key: str) -> int:
        if self.shards == 1:
            return 0
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        h = _blake64(key.encode("utf-8"))
        best_i, best_w = 0, -1
        for i, salt in enumerate(self._salts):
            w = _mix64(h ^ salt)
            if w > best_w:
                best_i, best_w = i, w
        if len(self._cache) >= self._CACHE_MAX:
            self._cache.clear()
        self._cache[key] = best_i
        return best_i


class ShardedStateStore:
    """One store facade over child stores and a router. The children are
    whole engines; the facade routes, fans out and merges. A cross-shard
    ``transact`` needs children with ``stage_transact`` (the sqlite store
    has it)."""

    def __init__(self, name: str, shards: Sequence[Any], *, hash_seed: str = "") -> None:
        if not shards:
            raise ComponentError(f"sharded store {name!r} needs >= 1 shard")
        self.name = name
        self._shards = list(shards)
        self.hash_seed = hash_seed
        self.router = ShardRouter(len(self._shards), hash_seed)
        #: the epoched routing table; replaced whole by a flip
        self.placement = PlacementMap(shards=len(self._shards))
        self.heat = ShardHeatTracker(len(self._shards))
        #: this process's member label; None: no locality known
        self.local_member: str | None = None
        #: makes child N for an online split (the sqlite build sets it)
        self.child_factory: Callable[[int], Any] | None = None
        # the flip's barrier: open but for a flip's final drain; operations
        # count themselves in and out so the flip waits for none in flight
        self._op_gate = asyncio.Event()
        self._op_gate.set()
        self._inflight = 0
        self._drained = asyncio.Event()
        self._drained.set()
        #: keys written while a session copies (None: no session)
        self._dirty: set[str] | None = None
        self._reshard_lock = asyncio.Lock()

    # -- routing -----------------------------------------------------------

    def shard_for(self, key: str):
        return self._shards[self.router.shard_of(key)]

    @property
    def shard_count(self) -> int:
        return len(self._shards)

    # -- the barrier and the taps --------------------------------------------

    async def _enter(self) -> None:
        await self._op_gate.wait()
        self._inflight += 1
        self._drained.clear()

    def _exit(self, written: Sequence[str] = ()) -> None:
        if self._dirty is not None:
            self._dirty.update(written)
        self._inflight -= 1
        if self._inflight <= 0:
            self._drained.set()

    # -- one key: routed ------------------------------------------------------

    async def get(self, key: str) -> StateItem | None:
        await self._enter()
        try:
            return await self.shard_for(key).get(key)
        finally:
            self._exit()

    async def get_strong(self, key: str) -> StateItem | None:
        """:meth:`get` from the leader of a replica set's shard."""
        await self._enter()
        try:
            child = self.shard_for(key)
            return await getattr(child, "get_strong", child.get)(key)
        finally:
            self._exit()

    async def set(self, key: str, value: Any, *, etag: str | None = None) -> str:
        await self._enter()
        try:
            self.heat.note_write(self.router.shard_of(key), key)
            return await self.shard_for(key).set(key, value, etag=etag)
        finally:
            self._exit((key,))

    async def delete(self, key: str, *, etag: str | None = None) -> bool:
        await self._enter()
        try:
            self.heat.note_write(self.router.shard_of(key), key)
            return await self.shard_for(key).delete(key, etag=etag)
        finally:
            self._exit((key,))

    # -- fan-out reads -------------------------------------------------------

    async def bulk_get(self, keys: list[str]) -> list[StateItem | None]:
        await self._enter()
        try:
            out: list[StateItem | None] = [None] * len(keys)
            by_shard: dict[int, list[int]] = {}
            for i, key in enumerate(keys):
                by_shard.setdefault(self.router.shard_of(key), []).append(i)

            async def one(shard: int, idxs: list[int]) -> None:
                items = await self._shards[shard].bulk_get([keys[i] for i in idxs])
                for i, item in zip(idxs, items):
                    out[i] = item

            await asyncio.gather(*(one(s, idxs) for s, idxs in by_shard.items()))
            return out
        finally:
            self._exit()

    async def keys(self, *, prefix: str = "") -> list[str]:
        await self._enter()
        try:
            per_shard = await asyncio.gather(*(s.keys(prefix=prefix) for s in self._shards))
            # each child's list is sorted: merged, it is one file's ORDER BY key
            return list(heapq.merge(*per_shard))
        finally:
            self._exit()

    async def query(self, query: dict, *, key_prefix: str = "") -> QueryResponse:
        """The filter runs on every child; the sort and the page run here
        over the merged items, so they see the whole result."""
        if not isinstance(query, dict):
            raise QueryError("query must be a JSON object")
        filt = query.get("filter")
        validate_filter(filt)
        await self._enter()
        try:
            per_shard = await asyncio.gather(
                *(s.query({"filter": filt}, key_prefix=key_prefix) for s in self._shards))
        finally:
            self._exit()
        items = list(heapq.merge(*(r.items for r in per_shard), key=lambda it: it.key))
        items, token = paginate(sort_items(items, query.get("sort")), query.get("page"))
        return QueryResponse(items=items, token=token)

    # -- transactions --------------------------------------------------------

    async def transact(self, ops: list[TransactionOp]) -> None:
        await self._enter()
        try:
            by_shard: dict[int, list[TransactionOp]] = {}
            for op in ops:
                shard = self.router.shard_of(op.key)
                self.heat.note_write(shard, op.key)
                by_shard.setdefault(shard, []).append(op)
            if len(by_shard) <= 1:  # one shard: its one transaction
                for shard, shard_ops in by_shard.items():
                    await self._shards[shard].transact(shard_ops)
                return
            await self._transact_cross_shard(by_shard)
        finally:
            self._exit([op.key for op in ops])

    async def _transact_cross_shard(self, by_shard: dict[int, list[TransactionOp]]) -> None:
        staged = []
        try:
            for shard in sorted(by_shard):
                child = self._shards[shard]
                stage = getattr(child, "stage_transact", None)
                if stage is None:
                    raise StateError(
                        f"store {self.name!r}: cross-shard transactions need shards that "
                        f"support staged commits; shard {shard} ({type(child).__name__}) "
                        "does not")
                staged.append((shard, await stage(by_shard[shard])))
        except BaseException:
            # nothing committed anywhere: unwind every staged shard
            for _, txn in staged:
                await txn.rollback()
            raise
        committed: list[int] = []
        for pos, (shard, txn) in enumerate(staged):
            try:
                await txn.commit()
            except BaseException as exc:
                for _, rest in staged[pos + 1:]:
                    await rest.rollback()
                if committed:
                    raise CrossShardAtomicityError(
                        f"store {self.name!r}: cross-shard transaction committed on "
                        f"shard(s) {committed} but failed on shard {shard}; remaining shards "
                        "rolled back — repair by re-reading the affected keys") from exc
                raise
            committed.append(shard)

    # -- placement: the epoch and telemetry ----------------------------------

    def check_epoch(self, epoch: int | None) -> None:
        """A caller's routing epoch against the live map: any other epoch
        (older: the caller's map is stale; newer: ours is) is refused with
        the epoch held here. None (no header) is not checked."""
        if epoch is None:
            return
        current = self.placement.epoch
        if epoch != current:
            metrics.inc("placement_stale_routes_total", store=self.name)
            raise PlacementEpochError(
                f"state store {self.name!r}: routing epoch {epoch} does not match placement "
                f"epoch {current} — refresh the placement map and retry",
                current_epoch=current)

    def placement_doc(self) -> dict:
        """What the sidecar's metadata exports and the placement loop
        merges: epoch, assignment, migration, each shard's heat, the local
        member and, for replica-set children, each shard's leader."""
        self.heat.sample()
        doc = self.placement.to_doc()
        doc["store"] = self.name
        doc["heat"] = self.heat.snapshot()
        doc["local_member"] = self.local_member
        leaders = {str(i): leader_of() for i, child in enumerate(self._shards)
                   if (leader_of := getattr(child, "leader_member", None)) is not None}
        if leaders:
            doc["leaders"] = leaders
        metrics.set_gauge("placement_epoch", float(self.placement.epoch), store=self.name)
        for i, rate in enumerate(self.heat.rates()):
            metrics.set_gauge("shard_heat", rate, store=self.name, shard=i)
        return doc

    def locality_rank(self, key: str) -> float:
        """1.0 when this process's member leads the shard that holds
        ``key`` (or nothing is known), 0.0 when another member does: the
        hint by which actor placement keeps an actor's turns beside its
        records."""
        if self.local_member is None:
            return 1.0
        idx = self.router.shard_of(key)
        leader_of = getattr(self._shards[idx], "leader_member", None)
        owner = leader_of() if leader_of is not None else self.placement.assignment.get(idx)
        if owner is None:
            return 1.0
        return 1.0 if owner == self.local_member else 0.0

    # -- placement: migration and split --------------------------------------

    def _publish_migration(self, status: dict | None) -> None:
        self.placement = self.placement.with_migration(status)

    def _take_dirty(self, pred) -> list[str]:
        """The tap's keys that ``pred`` keeps, sorted; the tap restarts."""
        if not self._dirty:
            return []
        dirty, self._dirty = self._dirty, set()
        return sorted(k for k in dirty if pred(k))

    async def _stream_keys(self, keys: list[str], target) -> int:
        """Copy ``keys`` onto ``target`` from the children that hold them
        (the facade's barrier may be closed); a key gone meanwhile is
        deleted there. Returns the keys copied. A chunk's writes go at
        once, so the target's group commit folds them into a few
        transactions: for a replica set a few records and quorum acks,
        not one a key, or a writer outruns the copy."""
        moved = 0
        for start in range(0, len(keys), 256):
            by_shard: dict[int, list[str]] = {}
            for k in keys[start:start + 256]:
                by_shard.setdefault(self.router.shard_of(k), []).append(k)
            for src, ks in by_shard.items():
                items = await self._shards[src].bulk_get(ks)
                await asyncio.gather(*(target.delete(k) if item is None
                                       else target.set(k, item.value)
                                       for k, item in zip(ks, items)))
                moved += sum(item is not None for item in items)
        if moved:
            metrics.inc("placement_keys_moved_total", moved, store=self.name)
        return moved

    async def _delete_moved(self, keys: list[str]) -> None:
        """Drop moved keys from their sources, 512 at once a shard, so the
        group commit folds them into few transactions."""
        by_shard: dict[int, list[str]] = {}
        for k in keys:
            by_shard.setdefault(self.router.shard_of(k), []).append(k)
        for src, ks in by_shard.items():
            for start in range(0, len(ks), 512):
                await asyncio.gather(*(self._shards[src].delete(k)
                                       for k in ks[start:start + 512]))

    async def _fenced_flip(self, mutate, *, shards: int | None = None,
                           assignment: dict[int, str] | None = None) -> float:
        """Close the barrier, wait until no operation is in flight, run
        ``mutate`` (the last drain and the swap), publish the successor
        map at a higher epoch and reopen. Only this window pauses writes;
        a router that saw the old map fails :meth:`check_epoch` as soon as
        the new one is live. Returns the pause's seconds."""
        budget = pause_budget_default()
        started = time.monotonic()
        self._op_gate.clear()
        try:
            await self._drained.wait()
            await mutate()
            successor = self.placement.advanced(shards=shards, assignment=assignment)
            if successor.epoch <= self.placement.epoch:
                raise StateError(f"state store {self.name!r}: refusing a non-monotone "
                                 "placement epoch flip")
            self.placement = successor
        finally:
            self._op_gate.set()
        pause = time.monotonic() - started
        metrics.inc("placement_flips_total", store=self.name)
        metrics.set_gauge("placement_pause_seconds", pause, store=self.name)
        metrics.set_gauge("placement_epoch", float(self.placement.epoch), store=self.name)
        if pause > budget:
            logger.warning("placement: %s flip paused writes %.3fs (budget %.3fs)",
                           self.name, pause, budget)
        return pause

    async def _converge(self, pred, target, status: dict,
                        seen: set[str]) -> tuple[list[str], int]:
        """Catch-up rounds over the tap until at most 64 keys are left for
        the paused round: (those keys, keys copied). Each round's keys go
        into ``seen``. Raises when the writers outrun the copy."""
        moved = 0
        for _ in range(CATCH_UP_ROUNDS):
            residue = self._take_dirty(pred)
            if len(residue) <= 64:
                return residue, moved
            seen.update(residue)
            self._publish_migration({**status, "phase": "catchup", "pending": len(residue)})
            moved += await self._stream_keys(residue, target)
        raise StateError(
            f"state store {self.name!r}: {status['kind']} of shard {status['shard']}: the "
            f"dirty set did not converge in {CATCH_UP_ROUNDS} rounds — the writer outruns the "
            "copy; raise the pause budget or throttle the writer")

    async def migrate_shard(self, shard: int, *, member: str | None = None,
                            target=None) -> dict:
        """Move shard ``shard`` while it serves. ``target=``: stream its
        keys to that store, converge the tap, then swap the child and
        advance the epoch under the pause, and close the old child.
        ``member=``: hand a replica set's leadership to that member."""
        if not 0 <= shard < len(self._shards):
            raise StateError(f"state store {self.name!r} has no shard {shard}")
        if (member is None) == (target is None):
            raise StateError(f"state store {self.name!r}: migrate_shard needs exactly one of "
                             "member= (replicated handoff) or target= (key streaming)")
        async with self._reshard_lock:
            if member is not None:
                return await self._migrate_leadership(shard, member)
            old = self._shards[shard]
            of_shard = lambda k: self.router.shard_of(k) == shard  # noqa: E731
            status = {"kind": "move", "shard": shard, "target": target.name}
            self._dirty = set()
            try:
                self._publish_migration({**status, "phase": "copy"})
                moved = await self._stream_keys(await old.keys(), target)
                residue, caught_up = await self._converge(of_shard, target, status, set())
                moved += caught_up
                self._publish_migration({**status, "phase": "flip"})

                async def swap() -> None:
                    final = sorted(set(residue) | set(self._take_dirty(of_shard)))
                    await self._stream_keys(final, target)
                    self._shards[shard] = target

                pause = await self._fenced_flip(swap, assignment={shard: target.name})
            finally:
                self._dirty = None
                self._publish_migration(None)
            try:
                await _aclose(old)
            except Exception:  # noqa: BLE001 - the swap has happened
                logger.debug("placement: %s: retired source shard close failed", self.name,
                             exc_info=True)
            return {"action": "move", "shard": shard, "target": target.name,
                    "epoch": self.placement.epoch, "keys_moved": moved, "pause_seconds": pause}

    async def _migrate_leadership(self, shard: int, member: str) -> dict:
        """Wait until ``member`` has the leader's log (the stream moves
        it), then hand it the lease under the pause: the writers are
        quiesced, so the handoff finds nothing in flight."""
        child = self._shards[shard]
        transfer = getattr(child, "transfer_leadership", None)
        if transfer is None:
            raise StateError(f"state store {self.name!r}: shard {shard} is not replicated — "
                             "migrate with an explicit target= store")
        status = {"kind": "move", "shard": shard, "target": member}
        try:
            self._publish_migration({**status, "phase": "catchup"})
            deadline = time.monotonic() + 30.0
            while (lag := child.member_lag(member)) is None or lag > 0:
                if time.monotonic() > deadline:
                    raise StateError(f"state store {self.name!r}: shard {shard} catch-up "
                                     f"toward {member} did not converge")
                await asyncio.sleep(0.02)
            self._publish_migration({**status, "phase": "flip"})
            pause = await self._fenced_flip(lambda: transfer(member),
                                            assignment={shard: member})
        finally:
            self._publish_migration(None)
        return {"action": "move", "shard": shard, "target": member,
                "epoch": self.placement.epoch, "pause_seconds": pause}

    async def split_shard(self) -> dict:
        """Grow the ring N → N+1 while it serves: make shard N with
        :attr:`child_factory`, stream every key the grown router gives it
        (about 1/(N+1), from every shard; no key moves between the
        others), converge the tap, then under the pause copy the rest,
        delete the moved keys' source copies (so that ``keys`` and
        ``query`` never see one twice), swap router and map."""
        async with self._reshard_lock:
            n = len(self._shards)
            if n + 1 > MAX_SHARDS:
                raise ComponentError(f"state store {self.name!r}: cannot split past "
                                     f"{MAX_SHARDS} shards")
            if self.child_factory is None:
                raise StateError(f"state store {self.name!r}: online split needs a child "
                                 "factory (sqlite-backed stores wire one)")
            target = self.child_factory(n)
            grown = ShardRouter(n + 1, self.hash_seed)
            moving = lambda k: grown.shard_of(k) == n  # noqa: E731
            status = {"kind": "split", "shard": n}
            self._dirty = set()
            try:
                self._publish_migration({**status, "phase": "copy"})
                moved_keys = {k for k in await self.keys() if moving(k)}
                moved = await self._stream_keys(sorted(moved_keys), target)
                residue, caught_up = await self._converge(moving, target, status, moved_keys)
                moved += caught_up
                self._publish_migration({**status, "phase": "flip"})

                async def swap() -> None:
                    final = sorted(set(residue) | set(self._take_dirty(moving)))
                    moved_keys.update(final)
                    await self._stream_keys(final, target)
                    await self._delete_moved(sorted(moved_keys))
                    self._shards.append(target)
                    self.router = grown
                    self.heat.grow(1)

                pause = await self._fenced_flip(swap, shards=n + 1, assignment={n: target.name})
            finally:
                self._dirty = None
                self._publish_migration(None)
            return {"action": "split", "new_shard": n, "shards": n + 1,
                    "epoch": self.placement.epoch, "keys_moved": moved, "pause_seconds": pause}

    # -- lifecycle -----------------------------------------------------------

    def _closing_order(self) -> list:
        """The children, the one that owns the replica sets' shared lease
        store last: a split's set must stop while that store is open."""
        return sorted(self._shards, key=lambda child: getattr(child, "owns_meta", False))

    def close(self) -> None:
        first: BaseException | None = None
        for child in self._closing_order():
            try:
                child.close()
            except Exception as exc:  # noqa: BLE001 - close the rest first
                first = first or exc
        if first is not None:
            raise first

    async def aclose(self) -> None:
        """The children's own async close where they have one: a replica
        set's leaders release their leases only there (``close`` is a
        crash's equivalent)."""
        first: BaseException | None = None
        for child in self._closing_order():
            try:
                await _aclose(child)
            except Exception as exc:  # noqa: BLE001 - close the rest first
                first = first or exc
        if first is not None:
            raise first


async def _aclose(store) -> None:
    closer = getattr(store, "aclose", None)
    if closer is not None:
        await closer()
    else:
        store.close()
