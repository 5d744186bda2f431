"""The durable sqlite broker: the port of ``tasksrunner/pubsub/sqlite.py``
(``SqliteBroker``).

Every sidecar process that opens the same file shares one broker:
messages and consumer groups outlive their subscribers and the
processes, so a group's messages wait for it while it is down. The
schema (``groups``, ``messages``, ``deliveries``) is the JAX broker's,
so a JAX sidecar and a port sidecar can share one broker file. The
delivery contract is :mod:`tasksrunner_torch.pubsub.base`'s:

* **Publish coalescing.** Concurrent publishes queue and one flush on
  the broker's thread inserts what accumulated, with each group's
  delivery rows, in one transaction; a batch that fails is retried one
  message at a time. The gauge ``broker_publish_queue_depth`` (an
  admission signal) is the batch's size.
* **Claim and ack with leases.** A consumer's poll loop claims up to
  ``claim_batch`` visible messages and, in the same transaction, acks
  the batch before it; a claim hides a message for ``claim_lease``
  seconds, so a consumer that dies leaves it to be redelivered when the
  lease runs out, and a slow batch re-leases its tail. An idle consumer
  polls every ``poll_interval`` seconds after a read-only probe that
  takes no lock.
* **Nacks.** A nack makes the message visible again after
  ``retry_delay`` (a :class:`~tasksrunner_torch.pubsub.base.Nack`'s
  ``retry_after`` instead); claiming charged an attempt, which a
  ``Nack(counts_attempt=False)`` refunds; a message that used up
  ``max_attempts`` is dead-lettered (``broker_dlq_depth``); an operator
  reads, requeues or purges a group's dead letters (the ``dlq`` verb).
* **Janitor.** Every ``gc_interval`` seconds, messages settled in every
  group and older than ``gc_retention`` are dropped.

``pubsub.redis`` lands here when its component has no ``redisHost``, as
in the JAX package; the Redis streams broker itself is not ported, so a
``redisHost`` is refused.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import pathlib
import sqlite3
import threading
import time
from typing import Any, Awaitable, Callable

from tasksrunner_torch._sqlite import begin_immediate, checkpoint_loop, resolve_futures
from tasksrunner_torch.component.registry import driver
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import ComponentError
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.pubsub.base import Handler, Message, Nack
from tasksrunner_torch.ids import hex16

logger = logging.getLogger(__name__)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS groups (
    topic TEXT NOT NULL,
    grp   TEXT NOT NULL,
    PRIMARY KEY (topic, grp)
);
CREATE TABLE IF NOT EXISTS messages (
    id       TEXT PRIMARY KEY,
    topic    TEXT NOT NULL,
    data     TEXT NOT NULL,
    metadata TEXT NOT NULL,
    created  REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS deliveries (
    msg_id        TEXT NOT NULL,
    topic         TEXT NOT NULL,
    grp           TEXT NOT NULL,
    attempts      INTEGER NOT NULL DEFAULT 0,
    visible_at    REAL NOT NULL,
    claimed_until REAL NOT NULL DEFAULT 0,
    done          INTEGER NOT NULL DEFAULT 0,  -- 0 pending, 1 acked, 2 dead
    PRIMARY KEY (msg_id, grp)
);
CREATE INDEX IF NOT EXISTS idx_deliveries_pending
    ON deliveries (topic, grp, done, visible_at);
"""

_ACK_SQL = "UPDATE deliveries SET done = 1 WHERE msg_id = ? AND grp = ?"


def _locked(fn):
    """Run a method that touches the database under the instance's lock."""
    def wrapper(self, *args, **kwargs):
        with self._db_lock:
            return fn(self, *args, **kwargs)
    return wrapper


class SqliteBroker:
    def __init__(self, name: str, path: str | pathlib.Path, *, max_attempts: int = 3,
                 retry_delay: float = 0.2, claim_lease: float = 30.0,
                 poll_interval: float = 0.05, claim_batch: int = 64,
                 gc_interval: float = 300.0, gc_retention: float = 3600.0) -> None:
        self.name = name
        self.path = str(path)
        if self.path != ":memory:":
            pathlib.Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self.max_attempts = max_attempts
        self.retry_delay = retry_delay
        self.claim_lease = claim_lease
        self.poll_interval = poll_interval
        #: messages claimed per poll: large batches amortise commits, small
        #: ones spread a backlog over competing consumers
        self.claim_batch = max(1, claim_batch)
        self.gc_interval = gc_interval
        self.gc_retention = gc_retention
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute("PRAGMA busy_timeout=5000")
        self._conn.execute("PRAGMA wal_autocheckpoint=0")
        self._conn.executescript(_SCHEMA)
        self._conn.commit()
        self._dirty = [False]  # set by each commit, cleared by the checkpointer
        self._ckpt_stop = threading.Event()
        self._ckpt_thread: threading.Thread | None = None
        if self.path != ":memory:":
            self._ckpt_thread = threading.Thread(
                target=checkpoint_loop, args=(self.path, self._ckpt_stop, self._dirty),
                name=f"broker-ckpt-{name}", daemon=True)
            self._ckpt_thread.start()
        self._tasks: list[asyncio.Task] = []
        self._janitor: asyncio.Task | None = None
        self._closed = False
        # every statement of the async paths runs on this thread, so a
        # lock wait never stalls the loop; _db_lock also serialises the
        # synchronous readers (backlog, dead_letters, gc) against it
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"broker-{name}")
        self._db_lock = threading.Lock()
        self._pub_lock = threading.Lock()
        self._pub_pending: list[tuple] = []
        self._pub_flushing = False

    async def _run(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(self._executor, fn, *args)

    def _write_txn(self, body):
        """``body(cursor)`` inside BEGIN IMMEDIATE … COMMIT; the caller
        holds ``_db_lock``."""
        cur = self._conn.cursor()
        begin_immediate(cur)
        try:
            result = body(cur)
            self._conn.commit()
        except BaseException:
            self._conn.rollback()
            raise
        self._dirty[0] = True
        return result

    # -- publish ---------------------------------------------------------

    async def publish(self, topic: str, data: Any, *,
                      metadata: dict[str, str] | None = None) -> str:
        msg_id = hex16()
        # serialised on the caller: a bad payload fails its own publish
        row = (msg_id, topic, json.dumps(data), json.dumps(dict(metadata or {})))
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        with self._pub_lock:
            self._pub_pending.append((row, loop, fut))
            if not self._pub_flushing:
                try:
                    self._executor.submit(self._flush_publishes)
                except RuntimeError:  # closed: fail this publish alone
                    self._pub_pending.pop()
                    raise
                self._pub_flushing = True
        await fut
        return msg_id

    def _flush_publishes(self) -> None:
        """Flush one accumulated batch in one transaction (broker thread),
        then submit itself again if more arrived, so claims and acks
        interleave on the thread instead of waiting out a drain."""
        with self._pub_lock:
            batch, self._pub_pending = self._pub_pending, []
            if not batch:
                self._pub_flushing = False
                return
        metrics.set_gauge("broker_publish_queue_depth", len(batch), pubsub=self.name)
        try:
            with self._db_lock:
                self._publish_rows([row for row, _, _ in batch])
            outcomes = [(loop, fut, None, None) for _, loop, fut in batch]
        except BaseException:  # noqa: BLE001 - one message at a time
            outcomes = []
            for row, loop, fut in batch:
                try:
                    with self._db_lock:
                        self._publish_rows([row])
                    outcomes.append((loop, fut, None, None))
                except BaseException as exc:  # noqa: BLE001 - the publisher's error
                    outcomes.append((loop, fut, None, exc))
        resolve_futures(outcomes)
        with self._pub_lock:
            if not self._pub_pending:
                self._pub_flushing = False
                return
            try:
                self._executor.submit(self._flush_publishes)
            except RuntimeError:  # closed: fail the stragglers
                self._pub_flushing = False
                closed = RuntimeError("broker closed")
                resolve_futures([(loop, fut, None, closed)
                                 for _, loop, fut in self._pub_pending])
                self._pub_pending = []

    def _publish_rows(self, rows: list[tuple]) -> None:
        """The messages and a delivery row for every group of their
        topics, in one transaction; the caller holds ``_db_lock``."""
        now = time.time()

        def body(cur: sqlite3.Cursor) -> None:
            cur.executemany(
                "INSERT INTO messages(id, topic, data, metadata, created) VALUES (?,?,?,?,?)",
                [(*row, now) for row in rows])
            groups: dict[str, list[str]] = {}
            deliveries = []
            for msg_id, topic, _, _ in rows:
                if topic not in groups:
                    groups[topic] = [r[0] for r in cur.execute(
                        "SELECT grp FROM groups WHERE topic = ?", (topic,)).fetchall()]
                deliveries += [(msg_id, topic, grp, now) for grp in groups[topic]]
            if deliveries:
                cur.executemany(
                    "INSERT INTO deliveries(msg_id, topic, grp, visible_at) VALUES (?,?,?,?)",
                    deliveries)

        self._write_txn(body)

    async def ensure_group(self, topic: str, group: str) -> None:
        """Create the durable group without a consumer: messages published
        from now on wait for it."""
        await self._run(self._ensure_group_sync, topic, group)

    @_locked
    def _ensure_group_sync(self, topic: str, group: str) -> None:
        self._write_txn(lambda cur: cur.execute(
            "INSERT OR IGNORE INTO groups(topic, grp) VALUES (?, ?)", (topic, group)))

    # -- consume ---------------------------------------------------------

    @_locked
    def _claim_and_ack(self, topic: str, group: str, limit: int,
                       ack_ids: list[str]) -> list[Message]:
        """One transaction that acks the previous batch and claims the
        next, so a busy consumer commits once a batch."""
        now = time.time()
        cur = self._conn.cursor()
        # a read-only probe first: an idle consumer must not take the
        # file's write lock on every poll against the publishers
        probe = cur.execute(
            "SELECT 1 FROM deliveries WHERE topic = ? AND grp = ? "
            "AND done = 0 AND visible_at <= ? AND claimed_until <= ? LIMIT 1",
            (topic, group, now, now)).fetchone()
        if probe is None and not ack_ids:
            return []

        def body(cur: sqlite3.Cursor) -> list:
            if ack_ids:
                cur.executemany(_ACK_SQL, [(m, group) for m in ack_ids])
            if probe is None:
                return []
            # competing consumers may both pass the probe: the claim
            # re-reads inside the write transaction
            rows = cur.execute(
                "SELECT d.msg_id, d.attempts, m.data, m.metadata FROM deliveries d "
                "JOIN messages m ON m.id = d.msg_id "
                "WHERE d.topic = ? AND d.grp = ? AND d.done = 0 "
                "AND d.visible_at <= ? AND d.claimed_until <= ? "
                "ORDER BY d.visible_at LIMIT ?",
                (topic, group, now, now, limit)).fetchall()
            if rows:
                cur.executemany(
                    "UPDATE deliveries SET claimed_until = ?, attempts = attempts + 1 "
                    "WHERE msg_id = ? AND grp = ?",
                    [(now + self.claim_lease, r[0], group) for r in rows])
            return rows

        return [Message(id=msg_id, topic=topic, data=json.loads(data),
                        metadata=json.loads(metadata), attempt=attempts + 1)
                for msg_id, attempts, data, metadata in self._write_txn(body)]

    @_locked
    def _ack_many(self, msg_ids: list[str], group: str) -> None:
        self._write_txn(lambda cur: cur.executemany(_ACK_SQL, [(m, group) for m in msg_ids]))

    @_locked
    def _extend_leases(self, msg_ids: list[str], group: str) -> float:
        """Re-lease claims not yet handled, so a slow batch's tail does
        not expire into a second delivery."""
        until = time.time() + self.claim_lease
        self._write_txn(lambda cur: cur.executemany(
            "UPDATE deliveries SET claimed_until = ? WHERE msg_id = ? AND grp = ?",
            [(until, m, group) for m in msg_ids]))
        return until

    def _dlq_gauge(self, topic: str, group: str) -> None:
        (n,) = self._conn.execute(
            "SELECT COUNT(*) FROM deliveries WHERE topic = ? AND grp = ? AND done = 2",
            (topic, group)).fetchone()
        metrics.set_gauge("broker_dlq_depth", float(n), topic=topic, group=group)

    @_locked
    def _nack(self, msg: Message, group: str, hint: Nack | None = None) -> None:
        counts = hint is None or hint.counts_attempt
        delay = self.retry_delay if hint is None or hint.retry_after is None else hint.retry_after
        if counts and msg.attempt >= self.max_attempts:
            logger.warning("dead-lettering message %s on %s/%s after %d attempts",
                           msg.id, msg.topic, group, msg.attempt)
            self._write_txn(lambda cur: cur.execute(
                "UPDATE deliveries SET done = 2 WHERE msg_id = ? AND grp = ?", (msg.id, group)))
            self._dlq_gauge(msg.topic, group)
            return
        # claiming charged this attempt; a declined delivery refunds it
        refund = "" if counts else ", attempts = attempts - 1"
        self._write_txn(lambda cur: cur.execute(
            f"UPDATE deliveries SET visible_at = ?, claimed_until = 0{refund} "
            "WHERE msg_id = ? AND grp = ?", (time.time() + delay, msg.id, group)))

    async def subscribe(self, topic: str, group: str,
                        handler: Handler) -> Callable[[], Awaitable[None]]:
        """One competing consumer of ``group`` on ``topic`` (the group is
        created if it is new); returns the coroutine function that stops
        it, after settling the acks it holds."""
        await self.ensure_group(topic, group)
        if self._janitor is None and self.gc_interval > 0:
            self._janitor = asyncio.get_running_loop().create_task(self._janitor_loop())
            self._tasks.append(self._janitor)
        stop = asyncio.Event()

        async def poll_loop() -> None:
            acks: list[str] = []  # settled inside the next claim
            try:
                while not stop.is_set() and not self._closed:
                    batch = await self._run(self._claim_and_ack, topic, group,
                                            self.claim_batch, acks)
                    acks = []
                    if not batch:
                        try:
                            await asyncio.wait_for(stop.wait(), timeout=self.poll_interval)
                        except asyncio.TimeoutError:
                            pass
                        continue
                    lease_deadline = time.time() + self.claim_lease
                    for i, msg in enumerate(batch):
                        if time.time() > lease_deadline - self.claim_lease / 2:
                            lease_deadline = await self._run(
                                self._extend_leases, [m.id for m in batch[i:]], group)
                        try:
                            ok = await handler(msg)
                        except asyncio.CancelledError:
                            raise
                        except Exception:  # noqa: BLE001 - a raising handler nacks
                            logger.exception("handler error on topic %s group %s", topic, group)
                            ok = False
                        if ok:
                            acks.append(msg.id)
                        else:
                            await self._run(self._nack, msg, group,
                                            ok if isinstance(ok, Nack) else None)
            finally:
                # stopping must not redeliver what was handled; called
                # directly, as the executor may refuse work by now
                if acks:
                    self._ack_many(acks, group)

        task = asyncio.get_running_loop().create_task(poll_loop())
        self._tasks.append(task)

        async def cancel() -> None:
            stop.set()
            try:
                await task
            except asyncio.CancelledError:
                if not task.cancelled():
                    raise

        return cancel

    async def _janitor_loop(self) -> None:
        while not self._closed:
            await asyncio.sleep(self.gc_interval)
            if self._closed:
                return
            try:
                dropped = await self._run(lambda: self.gc(older_than=self.gc_retention))
            except Exception:  # noqa: BLE001 - the next round retries
                logger.exception("broker %s gc failed", self.name)
                continue
            if dropped:
                logger.info("broker %s gc dropped %d settled message(s)", self.name, dropped)

    # -- introspection -----------------------------------------------------

    @_locked
    def backlog(self, topic: str, group: str) -> int:
        """Messages the group has not acked or dead-lettered."""
        (n,) = self._conn.execute(
            "SELECT COUNT(*) FROM deliveries WHERE topic = ? AND grp = ? AND done = 0",
            (topic, group)).fetchone()
        return n

    @_locked
    def dead_letters(self, topic: str, group: str) -> list[str]:
        rows = self._conn.execute(
            "SELECT msg_id FROM deliveries WHERE topic = ? AND grp = ? AND done = 2",
            (topic, group)).fetchall()
        return [r[0] for r in rows]

    @_locked
    def dead_letter_detail(self, topic: str, group: str) -> list[dict]:
        """The group's dead letters, oldest first: id, attempts, data,
        metadata and when each was published (the ``dlq`` verb's view)."""
        rows = self._conn.execute(
            "SELECT d.msg_id, d.attempts, m.data, m.metadata, m.created "
            "FROM deliveries d JOIN messages m ON m.id = d.msg_id "
            "WHERE d.topic = ? AND d.grp = ? AND d.done = 2 ORDER BY m.created",
            (topic, group)).fetchall()
        return [{"id": msg_id, "attempts": attempts, "data": json.loads(data),
                 "metadata": json.loads(metadata), "created": created}
                for msg_id, attempts, data, metadata, created in rows]

    def _settle_dead_letters(self, sql: str, params: list, topic: str, group: str,
                             msg_ids: list[str] | None) -> int:
        # the caller holds _db_lock; msg_ids None is every dead letter
        if msg_ids is not None:
            if not msg_ids:
                return 0
            sql += f" AND msg_id IN ({', '.join('?' for _ in msg_ids)})"
            params = params + list(msg_ids)
        n = self._write_txn(lambda cur: cur.execute(sql, params)).rowcount
        self._dlq_gauge(topic, group)
        return n

    @_locked
    def requeue_dead_letters(self, topic: str, group: str,
                             msg_ids: list[str] | None = None) -> int:
        """Dead letters back to pending with a fresh attempt budget."""
        return self._settle_dead_letters(
            "UPDATE deliveries SET done = 0, attempts = 0, visible_at = ?, claimed_until = 0 "
            "WHERE topic = ? AND grp = ? AND done = 2", [time.time(), topic, group],
            topic, group, msg_ids)

    @_locked
    def purge_dead_letters(self, topic: str, group: str,
                           msg_ids: list[str] | None = None) -> int:
        """Dead letters discarded; their messages become collectable."""
        return self._settle_dead_letters(
            "DELETE FROM deliveries WHERE topic = ? AND grp = ? AND done = 2",
            [topic, group], topic, group, msg_ids)

    @_locked
    def gc(self, *, older_than: float = 3600.0) -> int:
        """Drop messages settled in every group; a pending or dead-lettered
        delivery keeps its message."""
        cutoff = time.time() - older_than

        def body(cur: sqlite3.Cursor) -> int:
            cur.execute(
                "DELETE FROM messages WHERE created < ? AND NOT EXISTS "
                "(SELECT 1 FROM deliveries d WHERE d.msg_id = messages.id "
                "AND d.done IN (0, 2))", (cutoff,))
            dropped = cur.rowcount
            cur.execute(
                "DELETE FROM deliveries WHERE done != 0 AND NOT EXISTS "
                "(SELECT 1 FROM messages m WHERE m.id = deliveries.msg_id)")
            return dropped

        return self._write_txn(body)

    def close_sync(self) -> None:
        """Close without a loop (a reader of the file out of band)."""
        self._closed = True
        self._ckpt_stop.set()
        self._executor.shutdown(wait=False)
        self._conn.close()

    async def aclose(self) -> None:
        self._closed = True
        self._ckpt_stop.set()
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001 - already reported
                pass
        self._tasks.clear()
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, lambda: self._executor.shutdown(wait=True))
        if self._ckpt_thread is not None:
            await loop.run_in_executor(None, self._ckpt_thread.join)
        self._conn.close()


def default_broker_path(name: str) -> str:
    """The ``brokerPath`` of a component that names none."""
    return ".tasksrunner/pubsub-" + name + ".db"


def open_for_inspection(spec: ComponentSpec, base_dir: pathlib.Path | str | None = None,
                        *, must_exist: bool = True) -> SqliteBroker:
    """A component's shared broker file opened out of band, as an
    autoscaler reads the broker and not the app; a relative
    ``brokerPath`` resolves against ``base_dir`` (the run file's
    directory, which the replicas resolve against too). Close it with
    :meth:`SqliteBroker.close_sync`. A component whose live broker is not
    the sqlite file (a ``redisHost``) is refused."""
    if not spec.type.startswith("pubsub."):
        raise ComponentError(f"component {spec.name!r} is {spec.type}, not a pubsub")
    host = spec.metadata.get("redisHost")
    if host is not None and (not isinstance(host, str) or host.strip()):
        raise ComponentError(
            f"component {spec.name!r} is served by the Redis streams broker (redisHost "
            "set), which is not ported yet; its backlog is in no local broker file")
    broker_path = spec.metadata.get("brokerPath")
    if not isinstance(broker_path, str):
        broker_path = default_broker_path(spec.name)
    path = pathlib.Path(broker_path)
    if not path.is_absolute():
        path = pathlib.Path(base_dir or pathlib.Path.cwd()) / path
    if must_exist and not path.is_file():
        raise ComponentError(
            f"broker file {path} does not exist: has anything published through this "
            "component yet? (a relative brokerPath resolves against the run file's directory)")
    return SqliteBroker(spec.name, path)


@driver("pubsub.sqlite", "pubsub.azure.servicebus")
def _sqlite_pubsub(spec: ComponentSpec, metadata: dict[str, str]) -> SqliteBroker:
    """``brokerPath`` picks the shared file; ``maxRetries``,
    ``retryDelaySeconds``, ``pollIntervalSeconds``, ``claimLeaseSeconds``,
    ``claimBatchSize``, ``gcIntervalSeconds`` (0: no janitor) and
    ``gcRetentionSeconds`` as in the JAX driver."""
    return SqliteBroker(
        spec.name, metadata.get("brokerPath", default_broker_path(spec.name)),
        max_attempts=int(metadata.get("maxRetries", 3)),
        retry_delay=float(metadata.get("retryDelaySeconds", 0.2)),
        poll_interval=float(metadata.get("pollIntervalSeconds", 0.05)),
        claim_lease=float(metadata.get("claimLeaseSeconds", 30.0)),
        claim_batch=int(metadata.get("claimBatchSize", 64)),
        gc_interval=float(metadata.get("gcIntervalSeconds", 300.0)),
        gc_retention=float(metadata.get("gcRetentionSeconds", 3600.0)))


@driver("pubsub.redis", "pubsub.redis-streams")
def _redis_pubsub(spec: ComponentSpec, metadata: dict[str, str]) -> SqliteBroker:
    """Without a ``redisHost`` the durable sqlite broker stands in, as in
    the JAX package; the Redis streams broker is not ported yet."""
    if metadata.get("redisHost"):
        raise ComponentError(
            f"pubsub {spec.name!r}: the Redis streams broker (redisHost) is not ported "
            "yet; drop redisHost to use the sqlite broker file")
    return _sqlite_pubsub(spec, metadata)
