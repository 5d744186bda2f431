"""The durable sqlite state store: the port of ``tasksrunner/state/sqlite.py``
(``SqliteStateStore``, its staged transactions, the replication record
stream and the sharded and replicated builds).

The on-disk schema (``state(key, value, etag)`` and the store-wide etag
sequence ``etag_seq``) and the value encoding (compact JSON, NaN
refused) are the JAX store's, so a file written by either store reads
back in the other.

* **Group commit.** Concurrent ``set`` / ``delete`` / ``transact`` calls
  queue, and one flush on the writer thread drains what accumulated into
  one ``BEGIN IMMEDIATE … COMMIT``; each caller still gets its own etag
  or :class:`~tasksrunner_torch.errors.EtagMismatch`, and writes apply in
  the order they were queued. A run of unconditional upserts is one
  ``executemany``. When a whole batch fails, each op is retried alone so
  one bad op cannot fail its neighbours. ``groupCommit: false`` runs one
  transaction per call, still off the loop.
* **Off the loop.** Every statement runs on a writer thread or, for a
  file, a reader thread with its own connection.
* **WAL with a background checkpointer.** ``wal_autocheckpoint=0`` and a
  thread that runs PASSIVE checkpoints, so no commit copies the WAL
  inline; ``close`` folds the WAL back into the file.
* **Read cache.** ``readCacheSize`` > 0 keeps a write-through LRU of
  (key → document, etag); safe only where this process is the file's
  one writer.
* **Queries in the engine.** The dialect of
  :mod:`tasksrunner_torch.state.query` compiles to SQL over
  ``json_extract`` (:func:`compile_filter`, :func:`compile_sort`), the
  key prefix to an escaped ``LIKE``, a page to ``LIMIT`` / ``OFFSET``
  with the tokens of ``query.paginate``, rows that tie in key order;
  the answer is the in-memory store's. NaN is refused when written, so it never reaches a query.

* **Staged transactions.** :meth:`SqliteStateStore.stage_transact` opens
  the transaction, checks every etag and applies the ops on the writer
  thread, then parks that thread until the coordinator commits or rolls
  back (:class:`StagedTransaction`): the per-shard half of
  :mod:`tasksrunner_torch.state.sharding`'s two-phase commit. Queued
  flushes wait behind it, on the same thread and connection.
* **Shards.** ``shards: N`` builds N stores on ``-shardN`` files behind a
  :class:`~tasksrunner_torch.state.sharding.ShardedStateStore`
  (:func:`build_sharded_store`); ``shards: 1`` is the plain store.
* **The replication record stream.** A member of a replica set
  (``replication=True``) also has the tables ``repl_log`` (one JSON
  record a committed batch: its mutations, the etag sequence after it,
  the leader's epoch) and ``repl_meta`` (the member's high-water mark and
  epoch), the JAX schema. The record is written in the batch's own
  transaction. With a replication session attached (``_repl``, the
  leader's :class:`~tasksrunner_torch.state.replication.ShardReplicator`),
  the batch's callers resolve only once the session has the record's ack
  quorum, on the loop: the writer thread never waits for it. A member
  without a session (a follower, or a leader that crashed or handed its
  shard on) refuses a write with :class:`~tasksrunner_torch.errors.NotLeaderError`,
  also one it committed just as its session went: no follower gets that
  record, so it was never acked (the JAX store resolves it as a success).
  The follower's side (:meth:`SqliteStateStore.apply_repl_records`,
  :meth:`~SqliteStateStore.install_repl_snapshot`) keeps the read cache
  in step. ``replicas: N`` builds the replica sets
  (:func:`~tasksrunner_torch.state.replication.build_replicated_store`).

The store sets the gauge ``state_write_queue_depth`` (an admission
signal; a shard's carries a ``shard`` label) once per batch and observes
``state_queue_wait_seconds`` and ``state_commit_seconds``; with spans
recorded, each write of a caller in a trace records a ``state-write
{store}`` span.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import json
import pathlib
import sqlite3
import threading
import time
from typing import TYPE_CHECKING, Any

from tasksrunner_torch import spans
from tasksrunner_torch._sqlite import begin_immediate, checkpoint_loop, resolve_futures
from tasksrunner_torch.component.registry import driver
from tasksrunner_torch.component.spec import ComponentSpec, metadata_bool, metadata_int
from tasksrunner_torch.envflag import env_number
from tasksrunner_torch.errors import (
    ComponentError, EtagMismatch, NotLeaderError, QueryError, ReplicaFencedError,
    ReplicationGapError, StateError,
)
from tasksrunner_torch.ids import hex8
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.state.base import ABSENT_ETAG, QueryResponse, StateItem, TransactionOp
from tasksrunner_torch.state.query import page_window, sort_clauses, validate_filter
from tasksrunner_torch.tracing import current_trace

if TYPE_CHECKING:  # sharding imports this module
    from tasksrunner_torch.state.sharding import ShardedStateStore

_SCHEMA = """
CREATE TABLE IF NOT EXISTS state (
    key   TEXT PRIMARY KEY,
    value TEXT NOT NULL,
    etag  TEXT NOT NULL
) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS etag_seq (
    id  INTEGER PRIMARY KEY CHECK (id = 1),
    n   INTEGER NOT NULL
);
INSERT OR IGNORE INTO etag_seq(id, n) VALUES (1, 0);
"""

#: made only on a replica set's members, so a plain store's file stays as
#: it was: the record stream and the member's position
_REPL_SCHEMA = """
CREATE TABLE IF NOT EXISTS repl_log (
    seq    INTEGER PRIMARY KEY,
    epoch  INTEGER NOT NULL,
    record TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS repl_meta (
    id    INTEGER PRIMARY KEY CHECK (id = 1),
    hwm   INTEGER NOT NULL,
    epoch INTEGER NOT NULL
);
INSERT OR IGNORE INTO repl_meta(id, hwm, epoch) VALUES (1, 0, 0);
"""

_SET_SQL = ("INSERT INTO state(key, value, etag) VALUES(?, ?, ?) "
            "ON CONFLICT(key) DO UPDATE SET value=excluded.value, etag=excluded.etag")

#: records a member keeps in ``repl_log``; a follower further behind
#: gets a snapshot
DEFAULT_LOG_RETAIN = 4096


def log_retain_default() -> int:
    return int(env_number("TASKSRUNNER_REPL_LOG_RETAIN", DEFAULT_LOG_RETAIN))


def _like_escape(prefix: str) -> str:
    return prefix.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")


def _param(value: Any) -> Any:
    """A JSON scalar as ``json_extract`` gives it back (true is 1)."""
    return int(value) if isinstance(value, bool) else value


def compile_filter(filt: Any) -> tuple[str, list[Any]]:
    """A validated filter as a WHERE fragment and its parameters, with
    the semantics of :func:`tasksrunner_torch.state.query.matches`."""
    if filt in (None, {}):
        return "1", []
    op, operand = next(iter(filt.items()))
    if op in ("AND", "OR"):
        parts, params = [], []
        for sub in operand:
            frag, p = compile_filter(sub)
            parts.append(f"({frag})")
            params.extend(p)
        return f" {op} ".join(parts), params
    path, expected = next(iter(operand.items()))
    col, jpath = "json_extract(value, ?)", "$." + path
    if op == "EQ":
        return f"{col} IS ?", [jpath, _param(expected)]
    if op == "NEQ":
        return f"{col} IS NOT ?", [jpath, _param(expected)]
    if op == "IN":
        if not expected:
            return "0", []
        frag = f"{col} IN ({', '.join('?' for _ in expected)})"
        params: list[Any] = [jpath, *(_param(v) for v in expected)]
        if any(v is None for v in expected):
            # IN never matches NULL: a missing field is null, as in matches
            frag = f"({frag} OR json_extract(value, ?) IS NULL)"
            params.append(jpath)
        return frag, params
    raise QueryError(f"unknown filter operator {op!r}")


def compile_sort(sort_spec: list[dict] | None) -> tuple[str, list[Any]]:
    """The sort clauses, then the key: rows that tie come in key order,
    as the in-memory store's stable sort over keys in order gives them,
    so a page walk never skips or repeats a row."""
    clauses = sort_clauses(sort_spec)
    return ("ORDER BY " + "".join(f"json_extract(value, ?) {order}, " for _, order in clauses)
            + "key", ["$." + path for path, _ in clauses])


def _encode(key: str, value: Any) -> str:
    """Serialised on the caller, so a bad value fails its own call and
    never the shared batch; NaN and infinities are refused."""
    try:
        return json.dumps(value, separators=(",", ":"), allow_nan=False)
    except ValueError as exc:
        raise StateError(f"value for key {key!r} is not valid JSON: {exc}") from exc


def _encode_ops(ops: list[TransactionOp]) -> list[tuple]:
    return [(op.operation, op.key,
             _encode(op.key, op.value) if op.operation == "upsert" else None, op.etag)
            for op in ops]


class _PendingWrite:
    """One queued write and its caller's loop and future."""

    __slots__ = ("op", "loop", "future", "enqueued", "ctx")

    def __init__(self, op: tuple, loop: asyncio.AbstractEventLoop,
                 future: asyncio.Future) -> None:
        self.op = op
        self.loop = loop
        self.future = future
        self.enqueued = time.monotonic()
        #: the caller's trace, read on the loop: the writer thread has none
        self.ctx = current_trace() if spans.active() else None


class StagedTransaction:
    """The coordinator's handle on one store's staged transaction, held
    open with the writer thread parked until :meth:`commit` or
    :meth:`rollback` (exactly one must be awaited). Past the store's
    ``_STAGE_DECISION_TIMEOUT`` the writer rolls back on its own, and a
    late :meth:`commit` raises :class:`StateError`."""

    __slots__ = ("_loop", "_staged", "_done", "_lock", "_evt", "_decision")

    def __init__(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop
        #: the ops applied in the open transaction, or the stage's error
        self._staged: asyncio.Future = loop.create_future()
        #: "committed" / "rolledback", or the commit's error
        self._done: asyncio.Future = loop.create_future()
        self._lock = threading.Lock()
        self._evt = threading.Event()
        self._decision: str | None = None

    def _decide(self, decision: str) -> None:
        # the first decision wins: the writer's deadline races a late
        # coordinator, and the lock settles the race
        with self._lock:
            if self._decision is None:
                self._decision = decision
        self._evt.set()

    async def commit(self) -> None:
        self._decide("commit")
        if await self._done != "committed":
            raise StateError("staged transaction was rolled back before the commit "
                             "decision arrived (decision deadline exceeded)")

    async def rollback(self) -> None:
        """Idempotent with the writer's own rollback at the deadline."""
        self._decide("rollback")
        await self._done

    # the writer thread's side

    def _await_decision(self, timeout: float) -> str:
        if not self._evt.wait(timeout):
            self._decide("timeout")
        with self._lock:
            return self._decision or "timeout"

    def _post(self, fut: asyncio.Future, value: Any, exc: BaseException | None) -> None:
        resolve_futures([(self._loop, fut, value, exc)])


class SqliteStateStore:
    #: how long a staged transaction may park the writer waiting for the
    #: coordinator's decision before the writer rolls it back
    _STAGE_DECISION_TIMEOUT = 30.0

    def __init__(self, name: str, path: str | pathlib.Path = ":memory:", *,
                 group_commit: bool = True, cache_size: int = 0,
                 shard: int | None = None, replication: bool = False) -> None:
        self.name = name
        self.path = str(path)
        #: a replica set's member: each commit appends its record to
        #: ``repl_log`` (the batch is the record, so group commit is on)
        self.replication = bool(replication)
        if self.replication:
            group_commit = True
        #: this store's index in a sharded component, else None: it labels
        #: the queue-depth gauge and names the threads ``{name}.{shard}``
        self.shard = shard
        thread_tag = name if shard is None else f"{name}.{shard}"
        self._is_file = self.path != ":memory:"
        if self._is_file:
            pathlib.Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self.group_commit = bool(group_commit)
        self.cache_size = max(0, int(cache_size))

        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # WAL + NORMAL: fsync at checkpoint, not per commit
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute("PRAGMA busy_timeout=5000")
        if self._is_file:
            self._conn.execute("PRAGMA wal_autocheckpoint=0")
        self._conn.executescript(_SCHEMA)
        if self.replication:
            self._conn.executescript(_REPL_SCHEMA)
        self._conn.commit()

        #: the leader's replication session, when this member leads
        self._repl: Any = None
        # the position mirrors repl_meta: written on the writer thread,
        # read from the loop (lag, bounds), so a lock keeps the pair whole
        self._repl_lock = threading.Lock()
        self._repl_retain = max(1, log_retain_default())
        self._repl_hwm = self._repl_epoch = 0
        if self.replication:
            self._repl_hwm, self._repl_epoch = self._conn.execute(
                "SELECT hwm, epoch FROM repl_meta WHERE id = 1").fetchone()

        # the writer thread owns _conn; a file gets a reader thread with
        # its own connection, so reads never queue behind a flush. An
        # in-memory database is private to its connection, so there the
        # reader is the writer.
        self._write_exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"state-w-{thread_tag}")
        if self._is_file:
            self._rconn = sqlite3.connect(self.path, check_same_thread=False)
            self._rconn.execute("PRAGMA busy_timeout=5000")
            self._read_exec = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"state-r-{thread_tag}")
        else:
            self._rconn = self._conn
            self._read_exec = self._write_exec

        self._dirty = [False]  # set on commit, cleared by the checkpointer
        self._ckpt_stop = threading.Event()
        self._ckpt_thread: threading.Thread | None = None
        if self._is_file:
            self._ckpt_thread = threading.Thread(
                target=checkpoint_loop, args=(self.path, self._ckpt_stop, self._dirty),
                name=f"state-ckpt-{thread_tag}", daemon=True)
            self._ckpt_thread.start()

        self._q_lock = threading.Lock()
        self._q_pending: list[_PendingWrite] = []
        self._q_flushing = False
        self._closed = False
        self._cache: collections.OrderedDict[str, tuple[str, str]] = collections.OrderedDict()
        self._cache_lock = threading.Lock()

    # -- writes (writer thread, inside an open transaction) ----------------

    @staticmethod
    def _reserve_etags(cur: sqlite3.Cursor, count: int) -> int:
        """Advance the store-wide sequence by ``count`` and return the
        first value reserved: a key deleted and made again never reuses
        an old etag."""
        cur.execute("UPDATE etag_seq SET n = n + ? WHERE id = 1", (count,))
        (n,) = cur.execute("SELECT n FROM etag_seq WHERE id = 1").fetchone()
        return n - count + 1

    @staticmethod
    def _etags_needed(op: tuple) -> int:
        if op[0] == "set":
            return 1
        if op[0] == "transact":
            return sum(1 for o in op[1] if o[0] == "upsert")
        return 0

    @staticmethod
    def _stored_etag(cur: sqlite3.Cursor, key: str) -> str:
        """The key's etag; :data:`ABSENT_ETAG` for a key not stored."""
        row = cur.execute("SELECT etag FROM state WHERE key = ?", (key,)).fetchone()
        return ABSENT_ETAG if row is None else row[0]

    def _apply_set(self, cur, key: str, doc: str, etag: str | None,
                   mutations: list[tuple], alloc) -> str:
        # refused before any write, so a coalesced batch stays clean
        if etag is not None and self._stored_etag(cur, key) != etag:
            raise EtagMismatch(f"etag mismatch for key {key!r}")
        new_etag = alloc()
        cur.execute(_SET_SQL, (key, doc, new_etag))
        mutations.append(("set", key, doc, new_etag))
        return new_etag

    def _apply_delete(self, cur, key: str, etag: str | None, mutations: list[tuple]) -> bool:
        stored = self._stored_etag(cur, key)
        if etag is not None and stored != etag:
            raise EtagMismatch(f"etag mismatch for key {key!r}")
        if stored == ABSENT_ETAG:
            return False
        cur.execute("DELETE FROM state WHERE key = ?", (key,))
        mutations.append(("delete", key))
        return True

    def _apply_transact(self, cur, ops: list[tuple], mutations: list[tuple], alloc) -> None:
        """Every etag checked against the state before the transaction,
        then the ops applied in order."""
        for _operation, key, _doc, etag in ops:
            if etag is not None and self._stored_etag(cur, key) != etag:
                raise EtagMismatch(f"etag mismatch for key {key!r}")
        for operation, key, doc, _etag in ops:
            if operation == "upsert":
                self._apply_set(cur, key, doc, None, mutations, alloc)
            else:
                cur.execute("DELETE FROM state WHERE key = ?", (key,))
                mutations.append(("delete", key))

    def _apply_op(self, cur, op: tuple, mutations: list[tuple], alloc) -> Any:
        if op[0] == "set":
            return self._apply_set(cur, op[1], op[2], op[3], mutations, alloc)
        if op[0] == "delete":
            return self._apply_delete(cur, op[1], op[2], mutations)
        return self._apply_transact(cur, op[1], mutations, alloc)

    # -- the record stream, the leader's side (writer thread) -------------

    def _repl_append(self, cur, mutations: list[tuple], tp: str | None = None) -> dict | None:
        """Append the record of ``mutations`` inside their transaction,
        so both commit or neither. It carries the etag sequence after
        the batch (a promoted follower goes on from there), the epoch
        (lower ones are refused downstream) and the first writer's
        traceparent (the ship, apply and ack spans join its trace)."""
        if not self.replication or not mutations:
            return None
        seq = self._repl_hwm + 1
        (etag_n,) = cur.execute("SELECT n FROM etag_seq WHERE id = 1").fetchone()
        record = {"seq": seq, "epoch": self._repl_epoch, "ops": mutations, "etag_n": etag_n,
                  "ts": time.time()}
        if tp is not None:
            record["tp"] = tp
        cur.execute("INSERT INTO repl_log(seq, epoch, record) VALUES (?, ?, ?)",
                    (seq, self._repl_epoch, json.dumps(record, separators=(",", ":"))))
        cur.execute("UPDATE repl_meta SET hwm = ? WHERE id = 1", (seq,))
        # a bounded log: a follower further behind gets a snapshot
        cur.execute("DELETE FROM repl_log WHERE seq <= ?", (seq - self._repl_retain,))
        return record

    def _repl_committed(self, record: dict | None) -> None:
        if record is not None:
            with self._repl_lock:
                self._repl_hwm = record["seq"]

    def _not_leader(self) -> NotLeaderError:
        return NotLeaderError(f"state store {self.name!r}: this member does not lead its shard; "
                              "the write was not acked — retry against the leader")

    def _repl_fail_fast(self) -> BaseException | None:
        """A member that does not lead, or was fenced, refuses a write
        before touching the file: its record could reach no quorum and
        would only lengthen the suffix a resync throws away."""
        if not self.replication:
            return None
        if self._repl is None:
            return self._not_leader()
        if self._repl.fenced:
            return ReplicaFencedError(f"state store {self.name!r}: this member lost shard "
                                      "leadership (epoch fenced); retry against the new leader")
        return None

    def _resolve_after_quorum(self, rec: dict | None, pairs: list[tuple]) -> None:
        """Resolve (loop, future, value, error) rows now, or, with a
        replication session, once ``rec`` has its ack quorum; a row
        refused by its own etag keeps its own error. A record committed
        after the session went (the member crashed or handed its shard
        on under the writer thread) fails its rows with
        :class:`NotLeaderError`: nothing ships it, so it is not acked."""
        repl = self._repl
        if rec is None:
            resolve_futures(pairs)
            return
        if repl is None:
            err = self._not_leader()
            resolve_futures([(loop, fut, None, exc or err) for loop, fut, _, exc in pairs])
            return
        repl.on_commit(rec, lambda: resolve_futures(pairs),
                       lambda qexc: resolve_futures([(loop, fut, None, exc or qexc)
                                                     for loop, fut, _, exc in pairs]))

    # -- group commit (writer thread) --------------------------------------

    def _flush_writes(self) -> None:
        """Flush what accumulated in one transaction, then submit itself
        again if more arrived, so reads sharing the executor (an
        in-memory store) interleave instead of waiting out a drain."""
        with self._q_lock:
            batch = self._q_pending
            if not batch:
                self._q_flushing = False
                return
            self._q_pending = []
        if self.shard is None:
            metrics.set_gauge("state_write_queue_depth", len(batch), store=self.name)
        else:  # a hot shard's depth shows as its own, not averaged away
            metrics.set_gauge("state_write_queue_depth", len(batch), store=self.name,
                              shard=self.shard)
        self._exec_batch(batch)
        with self._q_lock:
            if not self._q_pending:
                self._q_flushing = False
                return
            try:
                self._write_exec.submit(self._flush_writes)
            except RuntimeError:  # shut down: fail the stragglers
                self._q_flushing = False
                closed = StateError(f"state store {self.name!r} is closed")
                resolve_futures([(row.loop, row.future, None, closed) for row in self._q_pending])
                self._q_pending = []

    def _exec_batch(self, batch: list[_PendingWrite]) -> None:
        """One BEGIN IMMEDIATE … COMMIT for the batch; an op refused by
        its etag fails its caller alone."""
        fast = self._repl_fail_fast()
        if fast is not None:
            resolve_futures([(row.loop, row.future, None, fast) for row in batch])
            return
        results: list[tuple[Any, BaseException | None]] = [(None, None)] * len(batch)
        mutations: list[tuple] = []
        batch_start = time.monotonic()
        metrics.observe_many("state_queue_wait_seconds",
                             [batch_start - row.enqueued for row in batch], store=self.name)
        cur = self._conn.cursor()
        try:
            begin_immediate(cur)
            try:
                need = sum(self._etags_needed(row.op) for row in batch)
                seq = iter(range(self._reserve_etags(cur, need), 2 ** 63)) if need else iter(())
                alloc = lambda: str(next(seq))  # noqa: E731
                i, n = 0, len(batch)
                while i < n:
                    if batch[i].op[0] == "set" and batch[i].op[3] is None:
                        # a run of unconditional upserts: one executemany,
                        # applied in order, so a repeated key's last wins
                        params = []
                        while i < n and batch[i].op[0] == "set" and batch[i].op[3] is None:
                            _, key, doc, _ = batch[i].op
                            etag = alloc()
                            params.append((key, doc, etag))
                            results[i] = (etag, None)
                            i += 1
                        cur.executemany(_SET_SQL, params)
                        mutations.extend(("set", *p) for p in params)
                        continue
                    try:
                        results[i] = (self._apply_op(cur, batch[i].op, mutations, alloc), None)
                    except EtagMismatch as exc:
                        results[i] = (None, exc)
                    i += 1
                rec = self._repl_append(cur, mutations, tp=next(
                    (row.ctx.header for row in batch if row.ctx is not None), None))
                self._conn.commit()
            except BaseException:
                self._conn.rollback()
                raise
        except BaseException:
            # the whole batch failed (lock deadline, disk): each op alone
            for row in batch:
                try:
                    value, rec = self._exec_single_repl(row.op)
                except BaseException as exc:  # noqa: BLE001 - the caller's error
                    resolve_futures([(row.loop, row.future, None, exc)])
                else:
                    self._resolve_after_quorum(rec, [(row.loop, row.future, value, None)])
            return
        self._dirty[0] = True
        self._cache_apply(mutations)
        self._repl_committed(rec)
        end = time.monotonic()
        metrics.observe("state_commit_seconds", end - batch_start, store=self.name)
        if spans.active():
            wall_end = time.time()
            for row, (_, exc) in zip(batch, results):
                if row.ctx is not None:
                    spans.record_span(
                        kind="internal", name=f"state-write {self.name}",
                        status=200 if exc is None else 409,
                        start=wall_end - (end - row.enqueued), duration=end - row.enqueued,
                        attrs={"queue_wait": batch_start - row.enqueued,
                               "service": end - batch_start, "store": self.name},
                        trace_id=row.ctx.trace_id, span_id=hex8(), parent_id=row.ctx.span_id)
        self._resolve_after_quorum(rec, [(row.loop, row.future, value, exc)
                                         for row, (value, exc) in zip(batch, results)])

    def _exec_single(self, op: tuple) -> Any:
        """One op in its own transaction (writer thread)."""
        return self._exec_single_repl(op)[0]

    def _exec_single_repl(self, op: tuple) -> tuple[Any, dict | None]:
        fast = self._repl_fail_fast()
        if fast is not None:
            raise fast
        mutations: list[tuple] = []
        cur = self._conn.cursor()
        begin_immediate(cur)
        try:
            value = self._apply_op(cur, op, mutations,
                                   lambda: str(self._reserve_etags(cur, 1)))
            rec = self._repl_append(cur, mutations)
            self._conn.commit()
        except BaseException:
            self._conn.rollback()
            raise
        self._dirty[0] = True
        self._cache_apply(mutations)
        self._repl_committed(rec)
        return value, rec

    async def _submit_write(self, op: tuple) -> Any:
        loop = asyncio.get_running_loop()
        if not self.group_commit:
            return await loop.run_in_executor(self._write_exec, self._exec_single, op)
        row = _PendingWrite(op, loop, loop.create_future())
        with self._q_lock:
            if self._closed:
                raise StateError(f"state store {self.name!r} is closed")
            self._q_pending.append(row)
            if not self._q_flushing:
                try:
                    self._write_exec.submit(self._flush_writes)
                except RuntimeError:
                    self._q_pending.remove(row)
                    raise
                self._q_flushing = True
        return await row.future

    # -- read cache --------------------------------------------------------

    def _cache_get(self, key: str) -> tuple[str, str] | None:
        if not self.cache_size:
            return None
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
            return hit

    def _cache_apply(self, mutations: list[tuple]) -> None:
        """Write-through, after COMMIT: a rolled-back batch never reaches it."""
        if not self.cache_size or not mutations:
            return
        with self._cache_lock:
            for m in mutations:
                if m[0] == "set":
                    self._cache[m[1]] = (m[2], m[3])
                    self._cache.move_to_end(m[1])
                else:
                    self._cache.pop(m[1], None)
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)

    # -- the store's operations --------------------------------------------

    async def _run_read(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(self._read_exec, fn, *args)

    def _get_sync(self, key: str):
        return self._rconn.execute(
            "SELECT value, etag FROM state WHERE key = ?", (key,)).fetchone()

    async def get(self, key: str) -> StateItem | None:
        row = self._cache_get(key) or await self._run_read(self._get_sync, key)
        # parsed per read: a caller may change what it gets back
        return None if row is None else StateItem(key=key, value=json.loads(row[0]), etag=row[1])

    async def bulk_get(self, keys: list[str]) -> list[StateItem | None]:
        rows: list = [self._cache_get(key) for key in keys]
        misses = [i for i, row in enumerate(rows) if row is None]
        if misses:
            found = await self._run_read(lambda: [self._get_sync(keys[i]) for i in misses])
            for i, row in zip(misses, found):
                rows[i] = row
        return [None if row is None else StateItem(key=key, value=json.loads(row[0]), etag=row[1])
                for key, row in zip(keys, rows)]

    async def set(self, key: str, value: Any, *, etag: str | None = None) -> str:
        return await self._submit_write(("set", key, _encode(key, value), etag))

    async def delete(self, key: str, *, etag: str | None = None) -> bool:
        return await self._submit_write(("delete", key, etag))

    async def transact(self, ops: list[TransactionOp]) -> None:
        await self._submit_write(("transact", _encode_ops(ops)))

    async def stage_transact(self, ops: list[TransactionOp]) -> StagedTransaction:
        """Apply ``ops`` in an open transaction and return it held open,
        for the coordinator to commit or roll back. A stage that fails
        (an etag, the lock's deadline) rolls back and raises here: a
        failed stage never leaves a transaction open."""
        encoded = _encode_ops(ops)
        txn = StagedTransaction(asyncio.get_running_loop())
        closed = StateError(f"state store {self.name!r} is closed")
        with self._q_lock:
            if self._closed:
                raise closed
            try:
                self._write_exec.submit(self._stage_job, encoded, txn)
            except RuntimeError:
                raise closed from None
        await txn._staged
        return txn

    def _stage_job(self, ops: list[tuple], txn: StagedTransaction) -> None:
        """Writer thread: BEGIN, check and apply, park on the decision,
        then COMMIT (with the record appended) or ROLLBACK."""
        fast = self._repl_fail_fast()
        if fast is not None:
            txn._post(txn._staged, None, fast)
            return
        cur = self._conn.cursor()
        mutations: list[tuple] = []
        try:
            begin_immediate(cur)
            try:
                need = sum(1 for o in ops if o[0] == "upsert")
                seq = iter(range(self._reserve_etags(cur, need), 2 ** 63)) if need else iter(())
                self._apply_transact(cur, ops, mutations, lambda: str(next(seq)))
            except BaseException:
                self._conn.rollback()
                raise
        except BaseException as exc:  # noqa: BLE001 - the coordinator's error
            txn._post(txn._staged, None, exc)
            return
        txn._post(txn._staged, None, None)
        decision = txn._await_decision(self._STAGE_DECISION_TIMEOUT)
        try:
            if decision == "commit":
                try:
                    rec = self._repl_append(cur, mutations)
                    self._conn.commit()
                except BaseException:
                    self._conn.rollback()
                    raise
                self._dirty[0] = True
                self._cache_apply(mutations)
                self._repl_committed(rec)
                self._resolve_after_quorum(rec, [(txn._loop, txn._done, "committed", None)])
            else:
                self._conn.rollback()
                txn._post(txn._done, "rolledback", None)
        except BaseException as exc:  # noqa: BLE001 - a disk-level failure
            txn._post(txn._done, None, exc)

    # -- the record stream: the follower's side and the leader's catch-up --
    # (writer thread: each runs in turn with the flushes on one connection,
    # so a snapshot never sees half a batch)

    def apply_repl_records(self, records: list[dict]) -> int:
        """Apply a leader's records in order; the new high-water mark. A
        record below this member's epoch is a zombie's
        (:class:`ReplicaFencedError`); one at a higher epoch whose seq is
        already held means our own suffix diverged (a ``diverged``
        :class:`ReplicationGapError`: send a snapshot); a duplicate at the
        same epoch is skipped; a seq past hwm + 1 is a gap."""
        if not records:
            return self._repl_hwm
        cur = self._conn.cursor()
        mutations: list[tuple] = []
        hwm, epoch = self._repl_hwm, self._repl_epoch
        max_etag_n = 0
        begin_immediate(cur)
        try:
            for rec in records:
                seq, rec_epoch = int(rec["seq"]), int(rec["epoch"])
                if rec_epoch < epoch:
                    raise ReplicaFencedError(f"record epoch {rec_epoch} is behind member epoch "
                                             f"{epoch} (fenced ex-leader)")
                if seq <= hwm:
                    if rec_epoch > epoch:
                        raise ReplicationGapError(
                            f"seq {seq} already held at epoch {epoch} but offered at epoch "
                            f"{rec_epoch}: diverged suffix", hwm=hwm, diverged=True)
                    continue
                if seq != hwm + 1:
                    raise ReplicationGapError(f"record seq {seq} does not extend hwm {hwm}",
                                              hwm=hwm)
                for m in rec["ops"]:
                    if m[0] == "set":
                        cur.execute(_SET_SQL, (m[1], m[2], m[3]))
                    else:
                        cur.execute("DELETE FROM state WHERE key = ?", (m[1],))
                    mutations.append(tuple(m))
                cur.execute("INSERT OR REPLACE INTO repl_log(seq, epoch, record) VALUES (?, ?, ?)",
                            (seq, rec_epoch, json.dumps(rec, separators=(",", ":"))))
                hwm, epoch = seq, rec_epoch
                max_etag_n = max(max_etag_n, int(rec.get("etag_n", 0)))
            cur.execute("UPDATE repl_meta SET hwm = ?, epoch = ? WHERE id = 1", (hwm, epoch))
            cur.execute("DELETE FROM repl_log WHERE seq <= ?", (hwm - self._repl_retain,))
            if max_etag_n:
                # never backwards: a promoted follower's etags must be
                # fresher than any the old leader gave out
                cur.execute("UPDATE etag_seq SET n = ? WHERE id = 1 AND n < ?",
                            (max_etag_n, max_etag_n))
            self._conn.commit()
        except BaseException:
            self._conn.rollback()
            raise
        with self._repl_lock:
            self._repl_hwm, self._repl_epoch = hwm, epoch
        self._dirty[0] = True
        self._cache_apply(mutations)
        return hwm

    def read_repl_log(self, after_seq: int, limit: int = 512) -> list[dict] | None:
        """The records after ``after_seq`` in order, or None when the log
        was pruned past it (the leader sends a snapshot instead)."""
        if after_seq >= self.repl_position()[0]:
            return []
        rows = self._conn.execute("SELECT record FROM repl_log WHERE seq > ? ORDER BY seq LIMIT ?",
                                  (after_seq, limit)).fetchall()
        records = [json.loads(r[0]) for r in rows]
        if not records or records[0]["seq"] != after_seq + 1:
            return None
        return records

    def read_repl_epoch_at(self, seq: int) -> int | None:
        """The epoch of this member's record ``seq``, None when it holds
        none: the leader's log-matching check on a follower's hwm."""
        row = self._conn.execute("SELECT epoch FROM repl_log WHERE seq = ?", (seq,)).fetchone()
        return None if row is None else int(row[0])

    def read_repl_snapshot(self) -> dict:
        """Every row at the current position."""
        rows = self._conn.execute("SELECT key, value, etag FROM state ORDER BY key").fetchall()
        (etag_n,) = self._conn.execute("SELECT n FROM etag_seq WHERE id = 1").fetchone()
        hwm, epoch = self.repl_position()
        return {"rows": [list(r) for r in rows], "hwm": hwm, "epoch": epoch, "etag_n": etag_n}

    def install_repl_snapshot(self, snap: dict) -> None:
        """Replace this member's state by a leader's snapshot: the resync
        of a diverged suffix or of a gap the log no longer holds."""
        cur = self._conn.cursor()
        begin_immediate(cur)
        try:
            cur.execute("DELETE FROM state")
            cur.execute("DELETE FROM repl_log")
            cur.executemany("INSERT INTO state(key, value, etag) VALUES (?, ?, ?)",
                            [tuple(r) for r in snap["rows"]])
            cur.execute("UPDATE repl_meta SET hwm = ?, epoch = ? WHERE id = 1",
                        (int(snap["hwm"]), int(snap["epoch"])))
            cur.execute("UPDATE etag_seq SET n = ? WHERE id = 1", (int(snap["etag_n"]),))
            self._conn.commit()
        except BaseException:
            self._conn.rollback()
            raise
        with self._repl_lock:
            self._repl_hwm, self._repl_epoch = int(snap["hwm"]), int(snap["epoch"])
        self._dirty[0] = True
        with self._cache_lock:
            self._cache.clear()

    def append_repl_barrier(self, epoch: int) -> dict:
        """A new leader's first record: empty, at its higher epoch (the
        leadership barrier), durable before any data at that epoch."""
        cur = self._conn.cursor()
        begin_immediate(cur)
        try:
            seq = self._repl_hwm + 1
            (etag_n,) = cur.execute("SELECT n FROM etag_seq WHERE id = 1").fetchone()
            record = {"seq": seq, "epoch": int(epoch), "ops": [], "etag_n": etag_n,
                      "ts": time.time(), "barrier": True}
            cur.execute("INSERT INTO repl_log(seq, epoch, record) VALUES (?, ?, ?)",
                        (seq, int(epoch), json.dumps(record, separators=(",", ":"))))
            cur.execute("UPDATE repl_meta SET hwm = ?, epoch = ? WHERE id = 1",
                        (seq, int(epoch)))
            self._conn.commit()
        except BaseException:
            self._conn.rollback()
            raise
        with self._repl_lock:
            self._repl_hwm, self._repl_epoch = seq, int(epoch)
        self._dirty[0] = True
        return record

    def repl_position(self) -> tuple[int, int]:
        """(high-water mark, epoch), from any thread."""
        with self._repl_lock:
            return self._repl_hwm, self._repl_epoch

    async def query(self, query: dict, *, key_prefix: str = "") -> QueryResponse:
        if not isinstance(query, dict):
            raise QueryError("query must be a JSON object")
        filt = query.get("filter")
        validate_filter(filt)
        where, params = compile_filter(filt)
        order, order_params = compile_sort(query.get("sort"))
        sql = f"SELECT key, value, etag FROM state WHERE ({where})"
        if key_prefix:
            sql += r" AND key LIKE ? ESCAPE '\'"
            params.append(_like_escape(key_prefix) + "%")
        sql += f" {order}"
        params.extend(order_params)
        # paged in the engine, with query.paginate's offset tokens
        start, limit = page_window(query.get("page"))
        if limit is not None:
            sql += " LIMIT ? OFFSET ?"
            params.extend([limit + 1, start])  # one more row: is there a next page?
        elif start:
            sql += " LIMIT -1 OFFSET ?"
            params.append(start)
        rows = await self._run_read(self._query_sync, sql, params)
        token = None
        if limit is not None and len(rows) > limit:
            rows, token = rows[:limit], str(start + limit)
        return QueryResponse(items=[StateItem(key=k, value=json.loads(v), etag=e)
                                    for k, v, e in rows], token=token)

    def _query_sync(self, sql: str, params: list[Any]) -> list[tuple]:
        try:
            return self._rconn.execute(sql, params).fetchall()
        except sqlite3.Error as exc:
            raise QueryError(f"query failed: {exc}") from exc

    async def keys(self, *, prefix: str = "") -> list[str]:
        def read() -> list[str]:
            rows = self._rconn.execute("SELECT key FROM state ORDER BY key").fetchall()
            return [r[0] for r in rows if r[0].startswith(prefix)]
        return await self._run_read(read)

    def close(self) -> None:
        """Drain the write queue, stop the checkpointer, fold the WAL
        back into the file and close both connections. Synchronous, so
        it runs without a loop too."""
        with self._q_lock:
            if self._closed:
                return
            self._closed = True
            if self._q_pending and not self._q_flushing:
                self._write_exec.submit(self._flush_writes)
                self._q_flushing = True
        self._write_exec.shutdown(wait=True)
        if self._read_exec is not self._write_exec:
            self._read_exec.shutdown(wait=True)
        self._ckpt_stop.set()
        if self._ckpt_thread is not None:
            self._ckpt_thread.join(timeout=5.0)
        if self._is_file:
            try:
                self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            except sqlite3.Error:  # best effort: the WAL stays valid
                pass
        if self._rconn is not self._conn:
            self._rconn.close()
        self._conn.close()


def _shard_path(path: str, index: int) -> str:
    """Shard ``index``'s file: ``tasks.db`` → ``tasks-shard0.db``, … ;
    ``:memory:`` stays, each connection to it being a private database."""
    if path == ":memory:":
        return path
    p = pathlib.Path(path)
    return str(p.with_name(f"{p.stem}-shard{index}{p.suffix}"))


def build_sharded_store(name: str, path: str | pathlib.Path = ":memory:", *, shards: int,
                        hash_seed: str = "", group_commit: bool = True,
                        cache_size: int = 0) -> ShardedStateStore:
    """``shards`` stores, each on its own ``-shardN`` file with its own
    writer, reader and checkpointer, behind one facade routing by
    rendezvous hash. The read cache's budget is split over the shards."""
    from tasksrunner_torch.state.sharding import MAX_SHARDS, ShardedStateStore
    if not 1 <= shards <= MAX_SHARDS:
        # before any child: each starts threads a late error would leak
        raise ComponentError(f"state store {name!r}: shards must be in 1..{MAX_SHARDS}, "
                             f"not {shards}")
    per_shard_cache = max(1, cache_size // shards) if cache_size else 0

    def make_child(i: int) -> SqliteStateStore:
        return SqliteStateStore(name, _shard_path(str(path), i), group_commit=group_commit,
                                cache_size=per_shard_cache, shard=i)

    facade = ShardedStateStore(name, [make_child(i) for i in range(shards)],
                               hash_seed=hash_seed)
    facade.child_factory = make_child  # an online split makes shard N the same way
    return facade


@driver("state.sqlite", "state.azure.cosmosdb", "state.postgresql")
def _sqlite_state(spec: ComponentSpec, metadata: dict[str, str]):
    """``databasePath`` picks the file (in memory without one);
    ``groupCommit`` (true) and ``readCacheSize`` (0, off) as above.
    ``shards`` (1) partitions the store over that many ``-shardN`` files
    by rendezvous hash of the key, seeded by ``hashSeed`` (empty; every
    replica opening the files must use the same); ``shards: 1`` is the
    plain single-file store.

    ``replicas`` (1; at most 5) makes each shard a replica set of that
    many members with a leased leader, epoch fencing and ack after
    replication: ``ackQuorum`` (a majority) members, the leader among
    them, hold a write before it is acknowledged; ``followerReads: true``
    serves reads from a follower within ``maxLagRecords``
    (``TASKSRUNNER_REPL_MAX_LAG_RECORDS``) of the leader.
    ``replicas: 1`` is the plain store, with no record stream and no
    lease file."""
    shards = metadata_int(metadata, "shards", 1)
    replicas = metadata_int(metadata, "replicas", 1)
    path = metadata.get("databasePath", ":memory:")
    group_commit = metadata_bool(metadata, "groupCommit", True)
    cache_size = metadata_int(metadata, "readCacheSize", 0)
    if replicas > 1:
        from tasksrunner_torch.state.replication import build_replicated_store
        return build_replicated_store(
            spec.name, path, shards=shards, replicas=replicas,
            ack_quorum=metadata_int(metadata, "ackQuorum", 0) or None,
            hash_seed=metadata.get("hashSeed", ""), group_commit=group_commit,
            cache_size=cache_size,
            follower_reads=metadata_bool(metadata, "followerReads", False),
            max_lag=metadata_int(metadata, "maxLagRecords", 0) or None)
    if shards == 1:
        return SqliteStateStore(spec.name, path, group_commit=group_commit,
                                cache_size=cache_size)
    return build_sharded_store(spec.name, path, shards=shards,
                               hash_seed=metadata.get("hashSeed", ""),
                               group_commit=group_commit, cache_size=cache_size)
