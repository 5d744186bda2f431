"""A message queue in a sqlite file: the port of
``tasksrunner/bindings/localqueue.py``, on the same file schema, so a
producer of either package and a consumer of the other share one file.

It stands in for the reference's Azure Storage Queue
(``bindings.azure.storagequeues``): the sidecar polls the queue and
POSTs each message to the app route of the component's ``route``
metadata; a 2xx acks (deletes) it, anything else makes it visible again
after ``retryDelaySeconds`` until ``maxRetries`` deliveries have failed,
and then it is dead-lettered. An outside producer drops messages in
with :meth:`SqliteQueue.send`, through the binding's output side
(``create``), or with any sqlite client.

The backlog that the ``queue-backlog`` scale rule reads is
:meth:`SqliteQueue.backlog` on a handle of its own
(:func:`open_queue_for_inspection`).
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
import uuid
from typing import Any

from tasksrunner_torch.bindings.base import (
    BindingEvent, BindingResponse, EventSink, InputBinding, OutputBinding,
)
from tasksrunner_torch.component.registry import driver
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import BindingError, ComponentError

logger = logging.getLogger(__name__)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS queue (
    id            TEXT PRIMARY KEY,
    data          TEXT NOT NULL,
    enqueued      REAL NOT NULL,
    visible_at    REAL NOT NULL,
    attempts      INTEGER NOT NULL DEFAULT 0,
    done          INTEGER NOT NULL DEFAULT 0
);
CREATE INDEX IF NOT EXISTS idx_queue_visible ON queue (done, visible_at);
"""


def _locked(fn):
    """Run a method that touches the database under the instance's lock."""
    def wrapper(self, *args, **kwargs):
        with self._db_lock:
            return fn(self, *args, **kwargs)
    return wrapper


#: seconds a claimed message stays invisible: a consumer that dies
#: mid-delivery leaves it to be redelivered after this
CLAIM_LEASE = 30.0


class SqliteQueue:
    """The queue itself, shared across processes through its file.
    ``done`` is 0 while a message waits, 1 once acked, 2 once
    dead-lettered; a claimed message stays invisible for
    :data:`CLAIM_LEASE` seconds."""

    def __init__(self, path: str | pathlib.Path) -> None:
        self.path = str(path)
        if self.path != ":memory:":
            pathlib.Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # WAL + NORMAL: fsync at checkpoint, not per commit
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute("PRAGMA busy_timeout=5000")
        self._conn.executescript(_SCHEMA)
        self._conn.commit()
        # the binding's thread and producers on other threads share the connection
        self._db_lock = threading.Lock()

    @_locked
    def send(self, data: Any) -> str:
        msg_id = str(uuid.uuid4())
        now = time.time()
        self._conn.execute(
            "INSERT INTO queue(id, data, enqueued, visible_at) VALUES (?,?,?,?)",
            (msg_id, json.dumps(data), now, now))
        self._conn.commit()
        return msg_id

    @_locked
    def claim(self) -> tuple[str, Any, int] | None:
        """The oldest visible message, made invisible for the lease:
        (id, data, attempt number), or None."""
        now = time.time()
        cur = self._conn.cursor()
        try:
            cur.execute("BEGIN IMMEDIATE")
            row = cur.execute(
                "SELECT id, data, attempts FROM queue "
                "WHERE done = 0 AND visible_at <= ? ORDER BY enqueued LIMIT 1", (now,)
            ).fetchone()
            if row is None:
                self._conn.commit()
                return None
            msg_id, data, attempts = row
            cur.execute("UPDATE queue SET visible_at = ?, attempts = attempts + 1 WHERE id = ?",
                        (now + CLAIM_LEASE, msg_id))
            self._conn.commit()
        except BaseException:
            self._conn.rollback()
            raise
        return msg_id, json.loads(data), attempts + 1

    @_locked
    def ack(self, msg_id: str) -> None:
        self._conn.execute("UPDATE queue SET done = 1 WHERE id = ?", (msg_id,))
        self._conn.commit()

    @_locked
    def nack(self, msg_id: str, *, delay: float = 0.2) -> None:
        self._conn.execute("UPDATE queue SET visible_at = ? WHERE id = ?",
                           (time.time() + delay, msg_id))
        self._conn.commit()

    @_locked
    def dead_letter(self, msg_id: str) -> None:
        self._conn.execute("UPDATE queue SET done = 2 WHERE id = ?", (msg_id,))
        self._conn.commit()

    @_locked
    def backlog(self) -> int:
        """Messages neither acked nor dead-lettered, claimed ones included."""
        (n,) = self._conn.execute("SELECT COUNT(*) FROM queue WHERE done = 0").fetchone()
        return n

    @_locked
    def dead_letter_detail(self) -> list[dict]:
        """The dead letters with their payloads, oldest first."""
        rows = self._conn.execute(
            "SELECT id, data, attempts, enqueued FROM queue "
            "WHERE done = 2 ORDER BY enqueued").fetchall()
        return [{"id": msg_id, "attempts": attempts, "data": json.loads(data),
                 "created": enqueued}
                for msg_id, data, attempts, enqueued in rows]

    def _dead_letter_sql(self, sql: str, params: list, msg_ids: list[str] | None) -> int:
        if msg_ids is not None:
            if not msg_ids:
                return 0
            sql += f" AND id IN ({', '.join('?' for _ in msg_ids)})"
            params = [*params, *msg_ids]
        cur = self._conn.execute(sql, params)
        self._conn.commit()
        return cur.rowcount

    @_locked
    def purge_dead_letters(self, msg_ids: list[str] | None = None) -> int:
        """Discard dead letters (all, or those of ``msg_ids``)."""
        return self._dead_letter_sql("DELETE FROM queue WHERE done = 2", [], msg_ids)

    @_locked
    def requeue_dead_letters(self, msg_ids: list[str] | None = None) -> int:
        """Put dead letters back in the queue with a fresh attempt budget."""
        return self._dead_letter_sql(
            "UPDATE queue SET done = 0, attempts = 0, visible_at = ? WHERE done = 2",
            [time.time()], msg_ids)

    def close(self) -> None:
        self._conn.close()


#: the component types served by the shared queue file: the driver below
#: and :func:`open_queue_for_inspection` both take exactly these
QUEUE_BINDING_TYPES = ("bindings.localqueue", "bindings.azure.storagequeues")
DEFAULT_QUEUE_ROOT = ".tasksrunner/queues"


def open_queue_for_inspection(spec: ComponentSpec,
                              base_dir: pathlib.Path | str | None = None) -> SqliteQueue:
    """A queue component's file opened out of band, with the driver's
    defaults: ``{queuePath}/{queueName}.db``, a relative ``queuePath``
    resolved against ``base_dir`` (the run file's directory, which the
    replicas resolve against too). A file that does not exist yet is
    made: nothing sent yet is a backlog of 0."""
    if spec.type not in QUEUE_BINDING_TYPES:
        raise ComponentError(
            f"component {spec.name!r} is {spec.type}, not a queue binding "
            f"backed by a shared queue file ({', '.join(sorted(QUEUE_BINDING_TYPES))})")
    root = spec.metadata.get("queuePath", DEFAULT_QUEUE_ROOT)
    qname = spec.metadata.get("queueName", spec.name)
    if not isinstance(root, str) or not isinstance(qname, str):
        raise ComponentError(f"component {spec.name!r} has secret-typed queue path metadata")
    path = pathlib.Path(root) / f"{qname}.db"
    if not path.is_absolute():
        path = pathlib.Path(base_dir or pathlib.Path.cwd()) / path
    return SqliteQueue(path)


class LocalQueueBinding(InputBinding, OutputBinding):
    """The input side claims and delivers one message at a time; the
    output side's ``create`` enqueues."""

    def __init__(self, name: str, path: str, *, route: str | None = None,
                 poll_interval: float = 0.05, max_attempts: int = 3,
                 retry_delay: float = 0.2) -> None:
        InputBinding.__init__(self, name)
        self.queue = SqliteQueue(path)
        if route:
            self.route = route if route.startswith("/") else "/" + route
        self.poll_interval = poll_interval
        self.max_attempts = max_attempts
        self.retry_delay = retry_delay
        self._task: asyncio.Task | None = None
        # one thread: a lock wait on the shared file never stalls the
        # loop, and the poll loop and the output side's sends take turns
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"queue-{name}")

    async def _run(self, fn, *args, **kwargs):
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, lambda: fn(*args, **kwargs))

    async def start(self, sink: EventSink) -> None:
        async def loop() -> None:
            while True:
                claimed = await self._run(self.queue.claim)
                if claimed is None:
                    await asyncio.sleep(self.poll_interval)
                    continue
                msg_id, data, attempt = claimed
                try:
                    ok = await sink(BindingEvent(
                        binding=self.name, data=data,
                        metadata={"messageId": msg_id, "attempt": str(attempt)}))
                except Exception:  # noqa: BLE001 - a failed delivery nacks
                    logger.exception("queue %s delivery failed", self.name)
                    ok = False
                if ok:
                    await self._run(self.queue.ack, msg_id)
                elif attempt >= self.max_attempts:
                    logger.warning("dead-lettering queue message %s after %d attempts",
                                   msg_id, attempt)
                    await self._run(self.queue.dead_letter, msg_id)
                else:
                    await self._run(self.queue.nack, msg_id, delay=self.retry_delay)

        self._task = asyncio.create_task(loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # the db thread may be waiting on the file's lock: not on the loop
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: self._executor.shutdown(wait=True))
        self.queue.close()

    async def invoke(self, operation: str, data: Any,
                     metadata: dict[str, str] | None = None) -> BindingResponse:
        if operation != "create":
            raise BindingError(f"queue binding supports only create, not {operation!r}")
        msg_id = await self._run(self.queue.send, data)
        return BindingResponse(metadata={"messageId": msg_id})


@driver(*QUEUE_BINDING_TYPES)
def _localqueue_binding(spec: ComponentSpec, metadata: dict[str, str]) -> LocalQueueBinding:
    """``{queuePath}/{queueName}.db`` (the reference's ``queueName`` names
    a file, so the Azure-typed component file works unchanged);
    ``route``, ``pollIntervalSeconds`` (0.05), ``maxRetries`` (3) and
    ``retryDelaySeconds`` (0.2) as in the JAX driver."""
    root = metadata.get("queuePath", DEFAULT_QUEUE_ROOT)
    qname = metadata.get("queueName", spec.name)
    return LocalQueueBinding(
        spec.name, str(pathlib.Path(root) / f"{qname}.db"),
        route=metadata.get("route"),
        poll_interval=float(metadata.get("pollIntervalSeconds", 0.05)),
        max_attempts=int(metadata.get("maxRetries", 3)),
        retry_delay=float(metadata.get("retryDelaySeconds", 0.2)))
