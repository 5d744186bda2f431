"""The runtime side of the workflow plane: start, status, terminate and
raise an event. The port of ``tasksrunner/workflows/runtime.py``.

:class:`WorkflowRuntime` is a thin client over the actor runtime: every
operation is a turn on the ``_Workflow`` instance, so it inherits the
actor's one owner, ack after commit and fencing. What it adds is the
pump: a turn's result document says whether more work is ready
(``outcome == "running"``), which children to start and which parent to
notify, and the pump drains those until the instance blocks or ends.

The pump speeds things up; correctness does not rest on it. A running
instance carries the periodic ``__wfdrive`` reminder, so with every pump
gone (the owner crashed) a surviving replica's sweep adopts the instance
and each firing advances it one batch; the turn observer then starts a
pump on the adopting replica, so recovery runs at the pump's pace.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
import uuid
from typing import Any

from tasksrunner_torch.errors import TasksRunnerError, WorkflowNotFound
from tasksrunner_torch.workflows.engine import WORKFLOW_ACTOR_TYPE

logger = logging.getLogger(__name__)

_TERMINAL = ("completed", "failed", "terminated")

#: pump safety valve: a single follow-up chain never issues more than
#: this many step turns (a buggy orchestrator that always reports
#: "running" must not wedge the caller forever)
_MAX_PUMP_STEPS = 10_000


class WorkflowRuntime:
    """One replica's handle on the workflow plane."""

    def __init__(self, runtime: Any, actors: Any):
        self.runtime = runtime
        self.actors = actors
        self._observer = self._on_reminder_turn
        actors.turn_observers.append(self._observer)
        #: background child-start / pump tasks (kept to a set so they
        #: are not garbage-collected mid-flight)
        self._tasks: set[asyncio.Task] = set()

    def detach(self) -> None:
        with contextlib.suppress(ValueError):
            self.actors.turn_observers.remove(self._observer)
        for task in self._tasks:
            task.cancel()
        self._tasks.clear()

    # -- public operations -------------------------------------------------

    async def start(self, name: str, input: Any = None, *,
                    instance: str | None = None,
                    parent: dict | None = None) -> str:
        """Start (or idempotently re-start) an instance; returns its id
        after the start turn committed."""
        instance = instance or uuid.uuid4().hex
        doc = await self._turn(instance, "start", {
            "wf": name, "input": input, "parent": parent})
        await self._follow_up(instance, doc)
        return instance

    async def status(self, instance: str) -> dict:
        """Durable status — a plain state read, served by any replica."""
        record = await self.actors.read_state(WORKFLOW_ACTOR_TYPE, instance)
        state = record.get("data") or {}
        if not state.get("wf"):
            raise WorkflowNotFound(
                f"no workflow instance {instance!r}")
        return {
            "instance": instance,
            "workflow": state.get("wf"),
            "status": state.get("status"),
            "result": state.get("result"),
            "error": state.get("error"),
            "events": len(state.get("history") or ()),
            "created": state.get("created"),
            "updated": state.get("updated"),
            "parent": (state.get("parent") or {}).get("instance"),
        }

    async def history(self, instance: str) -> list[dict]:
        record = await self.actors.read_state(WORKFLOW_ACTOR_TYPE, instance)
        state = record.get("data") or {}
        if not state.get("wf"):
            raise WorkflowNotFound(f"no workflow instance {instance!r}")
        return list(state.get("history") or ())

    async def raise_event(self, instance: str, event: str,
                          data: Any = None, *, id: str | None = None) -> dict:
        doc = await self._turn(instance, "raise",
                               {"name": event, "data": data, "id": id})
        await self._follow_up(instance, doc)
        return doc

    async def terminate(self, instance: str,
                        reason: str = "terminated") -> dict:
        doc = await self._turn(instance, "terminate", {"reason": reason})
        await self._follow_up(instance, doc)
        return doc

    async def wait(self, instance: str, *, timeout: float = 30.0,
                   poll: float = 0.05) -> dict:
        """Poll until the instance reaches a terminal status."""
        deadline = time.monotonic() + timeout
        while True:
            status = await self.status(instance)
            if status["status"] in _TERMINAL:
                return status
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"workflow {instance!r} still {status['status']!r} "
                    f"after {timeout}s")
            await asyncio.sleep(poll)

    async def list(self) -> list[dict]:
        """Every known instance (from the actor index), oldest first."""
        rows = []
        for instance in await self.actors._index_ids(WORKFLOW_ACTOR_TYPE):
            try:
                rows.append(await self.status(instance))
            except WorkflowNotFound:
                continue  # GC'd or never-started record
        rows.sort(key=lambda r: r.get("created") or 0.0)
        return rows

    def summary(self) -> dict:
        """Cheap local view for ``/v1.0/metadata``."""
        return {"actor_type": WORKFLOW_ACTOR_TYPE,
                "pumps_in_flight": len(self._tasks)}

    # -- the pump ----------------------------------------------------------

    async def _turn(self, instance: str, method: str, data: Any) -> dict:
        doc = await self.actors.invoke_turn(
            WORKFLOW_ACTOR_TYPE, instance, method, data)
        return doc if isinstance(doc, dict) else {}

    async def _follow_up(self, instance: str, doc: dict) -> None:
        """Drain immediately-available work: step while the turn
        reports ``running``, start children, deliver the parent
        notification, reconcile possibly-lost child completions."""
        steps = 0
        while doc:
            await self._side_actions(instance, doc)
            if doc.get("outcome") != "running" or steps >= _MAX_PUMP_STEPS:
                return
            steps += 1
            try:
                doc = await self._turn(instance, "step", None)
            except TasksRunnerError as exc:
                # owner moved or crashed mid-pump: the drive reminder
                # (wherever the instance lands next) takes over
                logger.debug("pump for %s stopped: %s", instance, exc)
                return

    async def _side_actions(self, instance: str, doc: dict) -> None:
        for child in doc.get("start_children") or []:
            self._spawn(self._start_child(child))
        notify = doc.get("notify_parent")
        if notify is not None:
            self._spawn(self._notify_parent(notify))
        for pending in doc.get("pending_children") or []:
            self._spawn(self._reconcile_child(instance, pending))

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._reap)

    def _reap(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        if task.cancelled():
            return
        exc = task.exception()  # retrieve: a crash drill killing a pump
        if exc is not None:     # task must not warn at GC time
            logger.debug("workflow pump task died: %r", exc)

    async def _start_child(self, child: dict) -> None:
        try:
            await self.start(child["wf"], child.get("input"),
                             instance=child["instance"],
                             parent=child.get("parent"))
        except TasksRunnerError as exc:
            # the parent re-requests the start on its next turn
            logger.warning("starting child workflow %s failed: %s",
                           child.get("instance"), exc)

    async def _notify_parent(self, notify: dict) -> None:
        try:
            await self.raise_event(notify["instance"], notify["event"],
                                   data=notify.get("data"),
                                   id=notify.get("id"))
        except TasksRunnerError as exc:
            # lost notification: the parent's pending-children
            # reconciliation polls the child state and self-heals
            logger.warning("notifying parent %s failed: %s",
                           notify.get("instance"), exc)

    async def _reconcile_child(self, parent: str, pending: dict) -> None:
        """If a child already terminated but the parent never saw it
        (its completion notification died with a crashed replica),
        re-deliver from the child's durable state."""
        child = pending["instance"]
        try:
            record = await self.actors.read_state(WORKFLOW_ACTOR_TYPE, child)
        except TasksRunnerError:
            return
        state = record.get("data") or {}
        if state.get("status") not in _TERMINAL:
            return
        data = ({"error": state.get("error")}
                if state["status"] in ("failed", "terminated")
                else {"result": state.get("result")})
        with contextlib.suppress(TasksRunnerError):
            await self.raise_event(parent, pending["event"], data=data,
                                   id=f"{child}::done")

    # -- reminder-driven progress ------------------------------------------

    async def _on_reminder_turn(self, actor_type: str, actor_id: str,
                                method: str, result: Any) -> None:
        """Called by the actor sweep after a reminder turn committed.
        This is how an ADOPTED instance (original owner dead, no pump
        anywhere) gets a pump again on the adopting replica."""
        if actor_type != WORKFLOW_ACTOR_TYPE or not isinstance(result, dict):
            return
        await self._follow_up(actor_id, result)
