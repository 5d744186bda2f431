"""One replica's virtual-actor runtime: placement, turns, reminders. The
port of ``tasksrunner/actors/runtime.py``, without its chaos hooks
(``kind: Chaos`` is refused at load, ROADMAP A23).

Three durable records per actor, in the app's actor state store, under
the JAX package's keys and JSON shapes (a store file written by either
package is read by the other):

* ``actor-rec||{type}||{id}``: ``{"epoch", "data", "reminders"}``, the
  actor's state and its reminder table, so a turn's state and reminder
  changes commit in one etag-guarded write;
* ``actor-place||{type}||{id}``: the owner (replica id, app id, host,
  sidecar port, pid, registration time), the fencing epoch, the lease's
  expiry and when it was granted (``released`` after a clean stop);
* ``actor-index||{type}``: ``{"ids": [...]}``, the ids the sweep scans.

**Fencing.** Every acquisition bumps the epoch with an etag-guarded write
to the actor record, which makes the etag the previous owner holds stale:
a zombie's next commit fails :class:`~tasksrunner_torch.errors.ActorFencedError`
and its turn is not acknowledged. A turn is acknowledged only after its
commit resolved.

**Liveness.** An owner is dead when its lease expired or
``NameResolver.local_pid_dead`` says its pid is gone (or recycled).

**Reminders.** Durable, in the record. The sweep
(``TASKSRUNNER_ACTOR_REMINDER_POLL_SECONDS``) renews the leases of owned
actors, fires due reminders (the due time moves in the same write as the
handler's state) and adopts actors with reminders whose owner died.

Two departures from the JAX runtime close races in it (ROADMAP C). Every
read of these records goes to the store's leader
(``Runtime.get_state(..., consistency="strong")``): over a replica set
with ``followerReads`` a follower could answer an activation's read with
a record older than the leader's. And every first write of a record is a
guarded create (:data:`~tasksrunner_torch.state.base.ABSENT_ETAG`): the
JAX runtime writes it unguarded and reads it back, so of two replicas
that activate one actor at once, or add to one index at once, the later
create can replace the earlier one's record after the earlier one read
its own back, leaving two owners or an id no sweep adopts. The index's
CAS also retries with a random pause instead of giving up after 8 tries.

A turn forwarded to another replica goes to it in this process through
:data:`_LOCAL_REPLICAS`, else to the owner's sidecar over HTTP
(``client.http_request``, with ``x-tasksrunner-actor-forward: 1``, the
trace's ``traceparent`` and ``baggage`` and the API token).

Metrics: ``actor_turns_total{type,status}``,
``actor_turn_latency_seconds{type}``, ``actor_reminder_fired_total{type}``,
``actor_fenced_total{type}``, ``actor_failover_total{type}`` and the gauge
``actor_owned{type}``. With spans recorded, a turn records
``actor-turn {type}/{method}`` (server) and a forward ``actor-forward
{type}/{method}`` (client), in the caller's trace.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import json
import logging
import os
import random
import time
from typing import Any

from tasksrunner_torch import spans
from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER, http_request
from tasksrunner_torch.envflag import env_number
from tasksrunner_torch.errors import (
    ActorError, ActorFencedError, ActorNotRegistered, EtagMismatch, TasksRunnerError,
)
from tasksrunner_torch.invoke.resolver import NameResolver
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.state.base import ABSENT_ETAG
from tasksrunner_torch.tracing import TraceContext, current_or_new, hop_headers, trace_scope

logger = logging.getLogger(__name__)

#: replica id → runtime: replicas in one process forward turns to each
#: other here; a crashed runtime removes itself, as a dead process stops
#: answering its port
_LOCAL_REPLICAS: dict[str, "ActorRuntime"] = {}

_REPLICA_SEQ = itertools.count()

DEFAULT_LEASE_SECONDS = 30.0
DEFAULT_POLL_SECONDS = 2.0
DEFAULT_TURN_TIMEOUT = 30.0
FORWARD_HEADER = "x-tasksrunner-actor-forward"
#: tries of the index's CAS, and the pause's bound after the n-th lost one
#: (n × this)
INDEX_ATTEMPTS, INDEX_BACKOFF_S = 64, 0.002


def record_key(actor_type: str, actor_id: str) -> str:
    return f"actor-rec||{actor_type}||{actor_id}"


def place_key(actor_type: str, actor_id: str) -> str:
    return f"actor-place||{actor_type}||{actor_id}"


def index_key(actor_type: str) -> str:
    return f"actor-index||{actor_type}"


class _Activation:
    """One actor this replica owns: its turn lock and cached etags."""

    __slots__ = ("lock", "etag", "place_etag", "epoch", "data", "reminders", "lease_expires")

    def __init__(self, *, etag: str, place_etag: str, epoch: int, data: dict,
                 reminders: dict, lease_expires: float) -> None:
        self.lock = asyncio.Lock()  # one turn at a time per actor
        self.etag = etag
        self.place_etag = place_etag
        self.epoch = epoch
        self.data = data
        self.reminders = reminders
        self.lease_expires = lease_expires


class ActorRuntime:
    """Everything actor-shaped on one replica. ``Runtime.start`` builds
    it when ``TASKSRUNNER_ACTORS`` (or ``TASKSRUNNER_WORKFLOWS``) is on
    and the app hosts at least one actor type."""

    def __init__(self, runtime: Any, actor_types: list[str]) -> None:
        self.runtime = runtime
        self.types = sorted(actor_types)
        self.store = self._pick_store()
        self.lease_seconds = env_number("TASKSRUNNER_ACTOR_LEASE_SECONDS",
                                        DEFAULT_LEASE_SECONDS)
        self.poll_seconds = env_number("TASKSRUNNER_ACTOR_REMINDER_POLL_SECONDS",
                                       DEFAULT_POLL_SECONDS)
        self.turn_timeout = env_number("TASKSRUNNER_ACTOR_TURN_TIMEOUT_SECONDS",
                                       DEFAULT_TURN_TIMEOUT)
        self.crashed = False
        # "t": the JAX runtime's ids end in a bare number, so a runtime of
        # each package in one process never takes the other's records for
        # its own
        self.replica_id = f"{runtime.app_id or 'app'}@{os.getpid()}.t{next(_REPLICA_SEQ)}"
        self._registered_at = time.time()
        self._activations: dict[tuple[str, str], _Activation] = {}
        self._sweep_task: asyncio.Task | None = None
        #: async callbacks ``(actor_type, actor_id, method, result)`` run
        #: after a reminder turn committed: how the workflow runtime
        #: learns that an adopted instance moved and needs pumping
        self.turn_observers: list = []

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        _LOCAL_REPLICAS[self.replica_id] = self
        self._sweep_task = asyncio.create_task(self._sweep_loop())
        logger.info("actor runtime %s hosting %s (lease %.1fs, poll %.1fs)",
                    self.replica_id, self.types, self.lease_seconds, self.poll_seconds)

    async def stop(self) -> None:
        """Release every lease (the epoch kept, so the next owner still
        fences above this one): after a clean stop, failover is at once."""
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._sweep_task
            self._sweep_task = None
        _LOCAL_REPLICAS.pop(self.replica_id, None)
        now = time.time()
        for (atype, aid), act in list(self._activations.items()):
            release = {"owner": self._identity(), "epoch": act.epoch, "lease_expires": 0.0,
                       "granted_at": now, "released": True}
            try:
                await self.runtime.save_state_item(self.store, place_key(atype, aid), release,
                                                   etag=act.place_etag)
            except TasksRunnerError:
                pass  # placed elsewhere already: nothing to release
        self._activations.clear()

    def simulate_crash(self) -> None:
        """Die as SIGKILL kills: no sweep, no answer, nothing released.
        Leases dangle until they expire; turns in flight run on and meet
        the fence at their commit."""
        self.crashed = True
        _LOCAL_REPLICAS.pop(self.replica_id, None)
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            self._sweep_task = None

    # -- store and identity ----------------------------------------------

    def _pick_store(self) -> str:
        """The state component whose metadata says ``actorStateStore:
        "true"``, else one named ``statestore``, else the only one."""
        names = list(self.runtime.registry.names(block="state"))
        for name in names:
            raw = self.runtime.registry.spec(name).metadata.get("actorStateStore")
            if str(raw).lower() == "true":
                return name
        if "statestore" in names:
            return "statestore"
        if len(names) == 1:
            return names[0]
        raise ActorError('no actor state store: mark one state component with metadata '
                         f'actorStateStore: "true" (state components: {names or "none"})')

    async def _read(self, key: str):
        return await self.runtime.get_state(self.store, key, consistency="strong")

    def _identity(self) -> dict:
        addr = getattr(self.runtime, "actor_address", None)
        return {"replica": self.replica_id, "app_id": self.runtime.app_id,
                "host": addr[0] if addr else "127.0.0.1",
                "sidecar_port": addr[1] if addr else None,
                "pid": os.getpid(), "registered_at": self._registered_at}

    @staticmethod
    def owner_dead(place_doc: dict, now: float | None = None) -> bool:
        """Lease expired, or the owner's pid provably gone (a recycled
        pid counts as gone); a live owner inside its lease never is."""
        now = time.time() if now is None else now
        if float(place_doc.get("lease_expires", 0.0)) <= now:
            return True
        owner = place_doc.get("owner") or {}
        return NameResolver.local_pid_dead(owner.get("host"), owner.get("pid"),
                                           owner.get("registered_at"))

    # -- the operations --------------------------------------------------

    async def invoke_turn(self, actor_type: str, actor_id: str, method: str,
                          data: Any = None, *, forwarded: bool = False) -> Any:
        """One turn; returns the handler's result after its commit resolved."""
        target = await self._resolve_owner(actor_type, actor_id, forwarded=forwarded)
        if not isinstance(target, _Activation):
            return await self._forward_turn(target, actor_type, actor_id, method, data)
        return await self._execute_turn(target, actor_type, actor_id, method=method,
                                        data=data, kind="turn", reminder_name=None)

    async def register_reminder(self, actor_type: str, actor_id: str, name: str, *,
                                due_seconds: float, period_seconds: float | None = None,
                                data: Any = None, forwarded: bool = False) -> None:
        """Keep a reminder in the actor's record (re-registering replaces it)."""
        target = await self._resolve_owner(actor_type, actor_id, forwarded=forwarded)
        if not isinstance(target, _Activation):
            await self._forward_reminder(target, actor_type, actor_id, name, "POST",
                                         {"dueSeconds": due_seconds,
                                          "periodSeconds": period_seconds, "data": data})
            return
        async with target.lock:
            reminders = dict(target.reminders)
            reminders[name] = {"due": time.time() + max(0.0, due_seconds),
                               "period": period_seconds, "data": data}
            await self._commit(target, actor_type, actor_id, new_data=target.data,
                               new_reminders=reminders)

    async def unregister_reminder(self, actor_type: str, actor_id: str, name: str, *,
                                  forwarded: bool = False) -> None:
        target = await self._resolve_owner(actor_type, actor_id, forwarded=forwarded)
        if not isinstance(target, _Activation):
            await self._forward_reminder(target, actor_type, actor_id, name, "DELETE", None)
            return
        async with target.lock:
            if name not in target.reminders:
                return
            reminders = dict(target.reminders)
            reminders.pop(name)
            await self._commit(target, actor_type, actor_id, new_data=target.data,
                               new_reminders=reminders)

    async def read_state(self, actor_type: str, actor_id: str) -> dict:
        """The durable record (a read, not a turn: any replica serves it)."""
        item = await self._read(record_key(actor_type, actor_id))
        if item is None:
            return {"epoch": 0, "data": {}, "reminders": {}}
        return item.value

    # -- ownership -------------------------------------------------------

    async def _resolve_owner(self, actor_type: str, actor_id: str, *, forwarded: bool):
        if self.crashed:
            raise ActorError(f"actor runtime {self.replica_id} is down (crashed)")
        if actor_type not in self.types:
            raise ActorNotRegistered(f"no actor type {actor_type!r} on app "
                                     f"{self.runtime.app_id!r} (hosted: {self.types})")
        act = self._activations.get((actor_type, actor_id))
        if act is not None:
            if act.lease_expires > time.time():
                return act
            # our lease lapsed (a stalled sweep): walk placement again,
            # retaking the actor if nobody else did
            self._deactivate(actor_type, actor_id)
        return await self._activate(actor_type, actor_id, forwarded=forwarded)

    def _locality_rank(self, actor_type: str, actor_id: str) -> float:
        """1.0 when this replica's member leads the shard that holds the
        actor's record (or nothing is known), 0.0 when another does: a
        bias of placement races, never a refusal."""
        try:
            store, prefixer = self.runtime._state_store(self.store)
        except TasksRunnerError:
            return 1.0
        rank_of = getattr(store, "locality_rank", None)
        if rank_of is None:
            return 1.0
        return float(rank_of(prefixer.apply(record_key(actor_type, actor_id))))

    async def _activate(self, actor_type: str, actor_id: str, *, forwarded: bool):
        """Walk the placement record: the live owner's document to forward
        to, or a new activation when the record is free, released or its
        owner dead (the epoch bumped). A replica whose member does not
        lead the actor's shard naps once before it claims, so the local
        one usually wins."""
        deferred = False
        for _ in range(4):
            now = time.time()
            place = await self._read(place_key(actor_type, actor_id))
            takeover = False
            if place is not None:
                doc = place.value
                owner = doc.get("owner") or {}
                if owner.get("replica") != self.replica_id:
                    if not self.owner_dead(doc, now):
                        if forwarded:
                            # a forwarded call never forwards again: the
                            # origin retries against the fresh record
                            raise ActorError(f"actor {actor_type}/{actor_id} moved while "
                                             "forwarding; retry")
                        return doc
                    takeover = not doc.get("released", False)
                epoch = int(doc.get("epoch", 0)) + 1
                place_etag = place.etag
            else:
                epoch = 1
                place_etag = ABSENT_ETAG
            if not deferred and not forwarded and (place is None or takeover):
                deferred = True
                rank = self._locality_rank(actor_type, actor_id)
                if rank < 1.0:
                    await asyncio.sleep(0.05 * (1.0 - rank))
                    continue
            lease_expires = now + self.lease_seconds
            new_place = {"owner": self._identity(), "epoch": epoch,
                         "lease_expires": lease_expires, "granted_at": now}
            try:
                new_place_etag = await self.runtime.save_state_item(
                    self.store, place_key(actor_type, actor_id), new_place, etag=place_etag)
            except EtagMismatch:
                continue  # lost the race: read again
            act = await self._fence_record(actor_type, actor_id, epoch, new_place_etag,
                                           lease_expires)
            if act is None:
                continue
            await self._index_add(actor_type, actor_id)
            self._activations[(actor_type, actor_id)] = act
            if takeover:
                metrics.inc("actor_failover_total", type=actor_type)
                logger.warning("actor %s/%s failed over to %s (epoch %d)", actor_type,
                               actor_id, self.replica_id, epoch)
            return act
        raise ActorError(f"could not place actor {actor_type}/{actor_id}: placement "
                         "contention; retry")

    async def _fence_record(self, actor_type: str, actor_id: str, epoch: int,
                            place_etag: str, lease_expires: float) -> _Activation | None:
        """Write the new epoch into the record before any turn: the fence
        that makes every etag the previous owner holds stale."""
        key = record_key(actor_type, actor_id)
        rec = await self._read(key)
        for _ in range(4):
            if rec is None:
                value, etag = {"epoch": epoch, "data": {}, "reminders": {}}, ABSENT_ETAG
            else:
                value, etag = {**rec.value, "epoch": epoch}, rec.etag
            try:
                new_etag = await self.runtime.save_state_item(self.store, key, value, etag=etag)
            except EtagMismatch:
                # a zombie's last commit slipped in: take it in and fence on top
                rec = await self._read(key)
                continue
            return _Activation(etag=new_etag, place_etag=place_etag, epoch=epoch,
                               data=value.get("data") or {},
                               reminders=value.get("reminders") or {},
                               lease_expires=lease_expires)
        return None

    async def _index_add(self, actor_type: str, actor_id: str) -> None:
        """Add the id to the type's index, which the sweep adopts from: an
        id missing there is never adopted. Every activation at once CASes
        the one record, so a loser pauses a random while before it reads
        again."""
        key = index_key(actor_type)
        for attempt in range(INDEX_ATTEMPTS):
            item = await self._read(key)
            ids = list(item.value.get("ids") or []) if item is not None else []
            if actor_id in ids:
                return
            try:
                await self.runtime.save_state_item(
                    self.store, key, {"ids": sorted({*ids, actor_id})},
                    etag=item.etag if item is not None else ABSENT_ETAG)
            except EtagMismatch:
                await asyncio.sleep(random.uniform(0.0, INDEX_BACKOFF_S * (attempt + 1)))
                continue
            return
        logger.warning("actor index %s: gave up adding %s under contention", actor_type,
                       actor_id)

    async def _index_ids(self, actor_type: str) -> list[str]:
        item = await self._read(index_key(actor_type))
        return [] if item is None else list(item.value.get("ids") or [])

    def _deactivate(self, actor_type: str, actor_id: str) -> None:
        self._activations.pop((actor_type, actor_id), None)

    # -- turns -----------------------------------------------------------

    async def _execute_turn(self, act: _Activation, actor_type: str, actor_id: str, *,
                            method: str, data: Any, kind: str,
                            reminder_name: str | None) -> Any:
        # the turn's span is a child of the caller's context (the
        # sidecar's, a forward hop's or a reminder's new root)
        turn_ctx = current_or_new().child() if spans.active() else None
        async with act.lock:
            started = time.perf_counter()
            wall_started = time.time()
            payload = json.dumps({"data": data, "state": act.data, "kind": kind,
                                  "reminder": reminder_name}).encode()
            headers = {"content-type": "application/json"}
            scope = contextlib.nullcontext()
            if turn_ctx is not None:
                # the app adopts it, so the handler's ACTOR span nests here
                headers.update(hop_headers(turn_ctx))
                scope = trace_scope(turn_ctx)
            turn_status = 500
            try:
                with scope:
                    try:
                        status, _, body = await asyncio.wait_for(
                            self.runtime.app_channel.request(
                                "PUT", f"/tasksrunner/actors/{actor_type}/{actor_id}/{method}",
                                headers=headers, body=payload),
                            timeout=self.turn_timeout)
                    except asyncio.TimeoutError:
                        metrics.inc("actor_turns_total", type=actor_type, status="timeout")
                        raise ActorError(
                            f"actor {actor_type}/{actor_id}.{method} exceeded the "
                            f"{self.turn_timeout}s turn timeout "
                            "(TASKSRUNNER_ACTOR_TURN_TIMEOUT_SECONDS)") from None
                    if status >= 300:
                        metrics.inc("actor_turns_total", type=actor_type, status="error")
                        turn_status = status
                        raise ActorError(f"actor {actor_type}/{actor_id}.{method} failed "
                                         f"({status}): {body[:200].decode('utf-8', 'replace')}")
                    doc = json.loads(body) if body else {}
                    new_state = doc.get("state")
                    if not isinstance(new_state, dict):
                        new_state = {}
                    reminders = dict(act.reminders)
                    if kind == "reminder" and reminder_name is not None:
                        rem = reminders.get(reminder_name)
                        if rem is not None:
                            if rem.get("period"):
                                reminders[reminder_name] = {
                                    **rem, "due": time.time() + float(rem["period"])}
                            else:
                                reminders.pop(reminder_name)
                    # staged changes after the fired one's re-arm: a handler
                    # that sets or clears the reminder that fired wins
                    now = time.time()
                    for rname, spec in (doc.get("reminders_set") or {}).items():
                        reminders[rname] = {
                            "due": now + max(0.0, float(spec.get("dueSeconds", 0.0))),
                            "period": spec.get("periodSeconds"), "data": spec.get("data")}
                    for rname in doc.get("reminders_clear") or []:
                        reminders.pop(rname, None)
                    await self._commit(act, actor_type, actor_id, new_data=new_state,
                                       new_reminders=reminders,
                                       effects=doc.get("effects") or None)
                    turn_status = 200
            finally:
                if turn_ctx is not None:
                    spans.record_span(
                        kind="server", name=f"actor-turn {actor_type}/{method}",
                        status=turn_status, start=wall_started,
                        duration=time.perf_counter() - started,
                        attrs={"actor": f"{actor_type}/{actor_id}", "turn_kind": kind},
                        trace_id=turn_ctx.trace_id, span_id=turn_ctx.span_id,
                        parent_id=turn_ctx.parent_id)
            metrics.observe("actor_turn_latency_seconds", time.perf_counter() - started,
                            type=actor_type)
            metrics.inc("actor_turns_total", type=actor_type, status="ok")
            if kind == "reminder":
                metrics.inc("actor_reminder_fired_total", type=actor_type)
            return doc.get("result")

    async def _commit(self, act: _Activation, actor_type: str, actor_id: str, *,
                      new_data: dict, new_reminders: dict, effects: list | None = None) -> None:
        """The one writer of the actor record, under the turn lock, guarded
        by its etag; an etag mismatch means this owner was fenced. With
        ``effects`` the record and every effect go in one transaction
        guarded by the record's etag."""
        record = {"epoch": act.epoch, "data": new_data, "reminders": new_reminders}
        rkey = record_key(actor_type, actor_id)
        try:
            if not effects:
                act.etag = await self.runtime.save_state_item(self.store, rkey, record,
                                                              etag=act.etag)
            else:
                ops = [{"operation": "upsert",
                        "request": {"key": rkey, "value": record, "etag": act.etag}}]
                for eff in effects:
                    operation = eff.get("operation", "upsert")
                    req: dict[str, Any] = {"key": str(eff["key"])}
                    if operation == "upsert":
                        req["value"] = eff.get("value")
                    ops.append({"operation": operation, "request": req})
                await self.runtime.transact_state(self.store, ops)
        except EtagMismatch as exc:
            self._deactivate(actor_type, actor_id)
            metrics.inc("actor_fenced_total", type=actor_type)
            metrics.inc("actor_turns_total", type=actor_type, status="fenced")
            raise ActorFencedError(
                f"actor {actor_type}/{actor_id}: commit fenced — a newer owner bumped past "
                f"epoch {act.epoch}; this turn was NOT applied (retry against the new "
                "owner)") from exc
        if effects:
            # a transaction returns no etag: read it back, while the record
            # still carries our epoch (epochs only grow, so a higher one is
            # a new owner's, and so is its etag)
            check = await self._read(rkey)
            if check is None or int(check.value.get("epoch", -1)) > act.epoch:
                self._deactivate(actor_type, actor_id)
                raise ActorFencedError(
                    f"actor {actor_type}/{actor_id}: fenced right after an effectful commit "
                    f"(epoch {act.epoch} superseded); the turn WAS applied but this owner is "
                    "done")
            act.etag = check.etag
        act.data = new_data
        act.reminders = new_reminders

    # -- forwarding ------------------------------------------------------

    async def _forward_turn(self, owner: dict, actor_type: str, actor_id: str, method: str,
                            data: Any) -> Any:
        odoc = owner.get("owner") or {}
        peer = _LOCAL_REPLICAS.get(odoc.get("replica"))
        # the hop is a client span; the owner's turn span nests under it
        fwd_ctx = current_or_new().child() if spans.active() else None
        scope = trace_scope(fwd_ctx) if fwd_ctx is not None else contextlib.nullcontext()
        started = time.time()
        fwd_status = 500
        try:
            with scope:
                if peer is not None:
                    result = await peer.invoke_turn(actor_type, actor_id, method, data,
                                                    forwarded=True)
                    fwd_status = 200
                    return result
                if odoc.get("sidecar_port"):
                    status, body = await self._http_forward(
                        odoc, "PUT", f"/v1.0/actors/{actor_type}/{actor_id}/method/{method}",
                        data, trace_ctx=fwd_ctx)
                    fwd_status = status
                    if status == 409:
                        raise ActorFencedError(f"actor {actor_type}/{actor_id}: owner fenced "
                                               "the forwarded turn; retry")
                    if status >= 300:
                        raise ActorError(
                            f"forwarded turn to {odoc.get('replica')} failed ({status}): "
                            f"{body[:200].decode('utf-8', 'replace')}")
                    return (json.loads(body) if body else {}).get("result")
                raise ActorError(
                    f"actor {actor_type}/{actor_id} is owned by {odoc.get('replica')!r} which "
                    "is unreachable from here; retry (ownership moves when its lease expires)")
        finally:
            if fwd_ctx is not None:
                spans.record_span(
                    kind="client", name=f"actor-forward {actor_type}/{method}",
                    status=fwd_status, start=started, duration=time.time() - started,
                    attrs={"target": odoc.get("replica"), "actor": f"{actor_type}/{actor_id}"},
                    trace_id=fwd_ctx.trace_id, span_id=fwd_ctx.span_id,
                    parent_id=fwd_ctx.parent_id)

    async def _forward_reminder(self, owner: dict, actor_type: str, actor_id: str, name: str,
                                http_method: str, body: Any) -> None:
        odoc = owner.get("owner") or {}
        peer = _LOCAL_REPLICAS.get(odoc.get("replica"))
        if peer is not None:
            if http_method == "POST":
                await peer.register_reminder(
                    actor_type, actor_id, name, due_seconds=body["dueSeconds"],
                    period_seconds=body.get("periodSeconds"), data=body.get("data"),
                    forwarded=True)
            else:
                await peer.unregister_reminder(actor_type, actor_id, name, forwarded=True)
            return
        if odoc.get("sidecar_port"):
            status, resp = await self._http_forward(
                odoc, http_method, f"/v1.0/actors/{actor_type}/{actor_id}/reminders/{name}",
                body)
            if status >= 300:
                raise ActorError(f"forwarded reminder op to {odoc.get('replica')} failed "
                                 f"({status}): {resp[:200].decode('utf-8', 'replace')}")
            return
        raise ActorError(f"actor {actor_type}/{actor_id} is owned by {odoc.get('replica')!r} "
                         "which is unreachable from here; retry")

    async def _http_forward(self, owner: dict, http_method: str, path: str, body: Any, *,
                            trace_ctx: TraceContext | None = None) -> tuple[int, bytes]:
        headers = {"content-type": "application/json", FORWARD_HEADER: "1",
                   **(hop_headers(trace_ctx) if trace_ctx is not None else {})}
        token = os.environ.get(TOKEN_ENV)
        if token:
            headers[TOKEN_HEADER] = token
        host, port = owner.get("host"), owner.get("sidecar_port")
        try:
            status, _, reply = await http_request(
                host, int(port), http_method, path, headers=headers,
                body=b"" if body is None else json.dumps(body).encode())
        except (OSError, asyncio.IncompleteReadError) as exc:
            raise ActorError(f"owner sidecar unreachable at http://{host}:{port}{path}: {exc} "
                             "(retry; ownership moves when its lease expires)") from exc
        return status, reply

    # -- the sweep: renewals, reminders, failover -------------------------

    async def _sweep_loop(self) -> None:
        while not self.crashed:
            await asyncio.sleep(self.poll_seconds)
            try:
                await self.sweep()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - the next pass tries again
                logger.exception("actor sweep failed on %s", self.replica_id)

    async def sweep(self) -> dict:
        """One pass of the control loop (tests step it themselves):
        ``{"renewed", "fired", "adopted"}``."""
        stats = {"renewed": 0, "fired": 0, "adopted": 0}
        now = time.time()
        # 1. renew every lease we hold; a lost CAS means a new owner fenced us
        for (atype, aid), act in list(self._activations.items()):
            if self.crashed:
                return stats
            renewal = {"owner": self._identity(), "epoch": act.epoch,
                       "lease_expires": now + self.lease_seconds, "granted_at": now}
            try:
                act.place_etag = await self.runtime.save_state_item(
                    self.store, place_key(atype, aid), renewal, etag=act.place_etag)
                act.lease_expires = now + self.lease_seconds
                stats["renewed"] += 1
            except EtagMismatch:
                self._deactivate(atype, aid)
        # 2. fire the due reminders of owned actors
        for (atype, aid), act in list(self._activations.items()):
            if self.crashed:
                return stats
            stats["fired"] += await self._fire_due(atype, aid, act)
        # 3. adopt actors with reminders whose owner is dead (one without
        # reminders is placed again on its next turn)
        for atype in self.types:
            for aid in await self._index_ids(atype):
                if self.crashed:
                    return stats
                if (atype, aid) in self._activations:
                    continue
                place = await self._read(place_key(atype, aid))
                if place is None or not self.owner_dead(place.value):
                    continue
                rec = await self._read(record_key(atype, aid))
                if rec is None or not rec.value.get("reminders"):
                    continue
                if (atype, aid) in self._activations:
                    continue  # a turn activated it while we read
                try:
                    adopted = await self._activate(atype, aid, forwarded=False)
                except TasksRunnerError as exc:
                    logger.warning("adopting %s/%s failed: %s", atype, aid, exc)
                    continue
                if isinstance(adopted, _Activation):
                    stats["adopted"] += 1
                    stats["fired"] += await self._fire_due(atype, aid, adopted)
        owned: dict[str, int] = {}
        for atype, _ in self._activations:
            owned[atype] = owned.get(atype, 0) + 1
        for atype in self.types:
            metrics.set_gauge("actor_owned", owned.get(atype, 0), type=atype)
        return stats

    async def _fire_due(self, actor_type: str, actor_id: str, act: _Activation) -> int:
        fired = 0
        now = time.time()
        for name, rem in sorted(act.reminders.items()):
            if float(rem.get("due", 0.0)) > now:
                continue
            try:
                # a reminder turn has no caller: it roots a trace of its own
                scope = (trace_scope(TraceContext.new()) if spans.active()
                         else contextlib.nullcontext())
                with scope:
                    result = await self._execute_turn(
                        act, actor_type, actor_id, method=name, data=rem.get("data"),
                        kind="reminder", reminder_name=name)
                fired += 1
                for observer in self.turn_observers:
                    try:
                        await observer(actor_type, actor_id, name, result)
                    except Exception:  # noqa: BLE001 - one observer must not stop the sweep
                        logger.exception("turn observer failed after reminder %s on %s/%s",
                                         name, actor_type, actor_id)
            except ActorFencedError:
                return fired  # the actor moved mid-sweep: the new owner fires
            except TasksRunnerError as exc:
                # the due time is unchanged: it fires again next pass
                logger.warning("reminder %s on %s/%s failed: %s", name, actor_type,
                               actor_id, exc)
        return fired

    # -- views -----------------------------------------------------------

    def summary(self) -> dict:
        """This replica's view, for ``/v1.0/metadata`` and ``ps``."""
        owned: dict[str, int] = {}
        for atype, _ in self._activations:
            owned[atype] = owned.get(atype, 0) + 1
        return {"types": self.types, "replica": self.replica_id, "owned": owned,
                "crashed": self.crashed, "lease_seconds": self.lease_seconds}

    async def placement_table(self) -> list[dict]:
        """The placement table from the shared store (every replica renders
        the same one): a row per actor id."""
        rows: list[dict] = []
        now = time.time()
        for atype in self.types:
            for aid in await self._index_ids(atype):
                place = await self._read(place_key(atype, aid))
                if place is None:
                    continue
                doc = place.value
                owner = doc.get("owner") or {}
                rows.append({
                    "type": atype, "id": aid, "owner": owner.get("replica"),
                    "owner_app": owner.get("app_id"), "host": owner.get("host"),
                    "sidecar_port": owner.get("sidecar_port"), "pid": owner.get("pid"),
                    "epoch": doc.get("epoch"),
                    "lease_age": round(max(0.0, now - float(doc.get("granted_at", now))), 3),
                    "lease_expires_in": round(float(doc.get("lease_expires", 0.0)) - now, 3),
                    "alive": not self.owner_dead(doc, now),
                    "owned_here": (atype, aid) in self._activations,
                })
        return rows
