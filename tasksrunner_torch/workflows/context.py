"""The deterministic orchestrator surface, tasks and the context: the
port of ``tasksrunner/workflows/context.py``.

An orchestrator is replayed from the start of its history on every
scheduling turn, so all it observes must follow from that history:
activity results, timer firings, external events, child results, and the
context's stand-ins for the clock and for randomness
(:meth:`WorkflowContext.now`, :meth:`WorkflowContext.random`,
:meth:`WorkflowContext.uuid4`, seeded with the JAX package's string
``f"wf:{workflow}:{instance}"``, so both packages draw the same values).
Side effects belong in activities.

Awaiting a task whose outcome history already holds never suspends
(``__await__`` returns or raises inline), so one ``coro.send(None)``
runs the orchestrator to its first unresolved await, and every task made
before that point is the frontier the engine schedules: a fan-out comes
for free, since a task is scheduled when it is made, not when awaited.
"""

from __future__ import annotations

import random
import uuid
from collections import deque
from typing import Any, Iterable

from tasksrunner_torch.errors import ActivityError, WorkflowNondeterminismError

#: history event names a task resolves from, by task kind
_ACTIVITY_EVENTS = ("activity_completed", "activity_failed")

#: internal event-name prefix carrying a child workflow's outcome back
#: to the parent task that scheduled it (suffix = the task's seq)
CHILD_EVENT_PREFIX = "__wfchild::"


class _WorkflowTask:
    """One schedulable unit: an activity call, a durable timer, an
    external-event wait, a child workflow, or a when_all/when_any
    composite. Awaitable exactly once per replay."""

    __slots__ = ("kind", "seq", "name", "payload", "resolved", "value",
                 "error", "children", "fire_at", "resolved_pos")

    def __init__(self, kind: str, seq: int | None, name: str = "", *,
                 payload: Any = None, fire_at: float | None = None,
                 children: list["_WorkflowTask"] | None = None):
        self.kind = kind       # activity | timer | event | child | all | any
        self.seq = seq         # None for composites
        self.name = name
        self.payload = payload
        self.resolved = False
        self.value: Any = None
        self.error: str | None = None
        self.children = children or []
        self.fire_at = fire_at
        #: history position of the resolving event — when_any picks its
        #: winner by this, so the verdict of a race is frozen the moment
        #: the first competitor's event lands in history and can never
        #: flip when a later event resolves an earlier-listed task
        self.resolved_pos = -1

    def resolve(self, value: Any) -> None:
        self.resolved = True
        self.value = value

    def fail(self, error: str) -> None:
        self.resolved = True
        self.error = error

    def _outcome(self) -> Any:
        if self.error is not None:
            raise ActivityError(self.error)
        return self.value

    def __await__(self):
        if not self.resolved:
            yield self  # suspends the replay; the engine never resumes it
        if not self.resolved:
            raise WorkflowNondeterminismError(
                "a workflow task was resumed without a recorded outcome "
                "(tasks must only be awaited inside an orchestrator)")
        return self._outcome()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "resolved" if self.resolved else "pending"
        return f"<_WorkflowTask {self.kind} #{self.seq} {self.name!r} {state}>"


class ActivityContext:
    """What an activity function receives beside its input."""

    __slots__ = ("instance", "workflow", "name", "seq", "attempt",
                 "is_compensation", "effects")

    def __init__(self, *, instance: str, workflow: str, name: str,
                 seq: int, attempt: int, is_compensation: bool = False):
        self.instance = instance
        self.workflow = workflow
        self.name = name
        self.seq = seq
        self.attempt = attempt
        self.is_compensation = is_compensation
        #: staged state ops, applied atomically WITH the history commit
        #: that records this activity's completion — which is exactly
        #: why an acked effect is applied once even when the activity
        #: body ran more than once (crash before commit = no effect)
        self.effects: list[dict] = []

    def stage_effect(self, key: str, value: Any = None, *,
                     operation: str = "upsert") -> None:
        """Stage a write to the workflow state store, committed
        atomically with this activity's completion event."""
        if operation not in ("upsert", "delete"):
            raise ValueError(f"unknown effect operation {operation!r}")
        self.effects.append(
            {"operation": operation, "key": str(key), "value": value})


class WorkflowContext:
    """The orchestrator's only legitimate window on the world."""

    def __init__(self, *, instance: str, workflow: str,
                 history: list[dict], input: Any = None):
        self.instance = instance
        self.workflow = workflow
        self.input = input
        #: False from the first await whose outcome history does NOT
        #: already hold — i.e. True exactly while re-traversing old
        #: ground (use it to suppress duplicate logging, nothing else)
        self.is_replaying = True
        self.tasks: list[_WorkflowTask] = []
        #: (activity name, input) pairs in registration order; the
        #: engine runs them in reverse when the orchestrator fails
        self.compensations: list[tuple[str, Any]] = []
        self._seq = 0
        self._results: dict[int, dict] = {}
        self._event_queues: dict[str, deque] = {}
        self._now = 0.0
        self._rng = random.Random(f"wf:{workflow}:{instance}")
        for pos, event in enumerate(history):
            t = event.get("t")
            ts = float(event.get("ts", 0.0))
            if t == "started":
                self._now = max(self._now, ts)
            elif t in _ACTIVITY_EVENTS or t == "timer_fired":
                self._results[int(event["seq"])] = {**event, "_pos": pos}
            elif t == "event_raised":
                name = str(event.get("name") or "")
                if name.startswith(CHILD_EVENT_PREFIX):
                    try:
                        seq = int(name[len(CHILD_EVENT_PREFIX):])
                    except ValueError:
                        continue
                    self._results[seq] = {**event, "t": "child_done",
                                          "_pos": pos}
                else:
                    self._event_queues.setdefault(name, deque()).append(
                        {**event, "_pos": pos})

    # -- deterministic ambient substitutes --------------------------------

    def now(self) -> float:
        """The timestamp of the latest history event applied so far —
        the replay-stable stand-in for ``time.time()``."""
        return self._now

    def random(self) -> float:
        """Replay-stable ``random.random()`` (seeded per instance)."""
        return self._rng.random()

    def uuid4(self) -> str:
        """Replay-stable uuid4 string (drawn from the instance PRNG)."""
        return str(uuid.UUID(int=self._rng.getrandbits(128), version=4))

    # -- task creation -----------------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _attach(self, task: _WorkflowTask) -> _WorkflowTask:
        self.tasks.append(task)
        rec = self._results.get(task.seq)
        if rec is None:
            if task.kind == "event":
                queue = self._event_queues.get(task.name)
                if queue:
                    event = queue.popleft()
                    self._now = max(self._now, float(event.get("ts", 0.0)))
                    task.resolve(event.get("data"))
                    task.resolved_pos = int(event.get("_pos", -1))
                    return task
            self.is_replaying = False
            return task
        t = rec.get("t")
        expect = {"activity": _ACTIVITY_EVENTS, "timer": ("timer_fired",),
                  "child": ("child_done",)}.get(task.kind, ())
        if t not in expect:
            raise WorkflowNondeterminismError(
                f"workflow {self.workflow!r} instance {self.instance!r}: "
                f"replay scheduled a {task.kind!r} task at seq {task.seq} "
                f"but history recorded {t!r} there — the orchestrator is "
                "not deterministic")
        if t in _ACTIVITY_EVENTS and rec.get("name") != task.name:
            raise WorkflowNondeterminismError(
                f"workflow {self.workflow!r} instance {self.instance!r}: "
                f"replay called activity {task.name!r} at seq {task.seq} "
                f"but history recorded {rec.get('name')!r} there — the "
                "orchestrator is not deterministic")
        self._now = max(self._now, float(rec.get("ts", 0.0)))
        if t == "activity_completed":
            task.resolve(rec.get("result"))
        elif t == "activity_failed":
            task.fail(str(rec.get("error")))
        elif t == "timer_fired":
            task.resolve(None)
        else:  # child_done
            data = rec.get("data") or {}
            if data.get("error") is not None:
                task.fail(str(data["error"]))
            else:
                task.resolve(data.get("result"))
        task.resolved_pos = int(rec.get("_pos", -1))
        return task

    def call_activity(self, name: str, input: Any = None) -> _WorkflowTask:
        """Schedule one activity execution. The returned task resolves
        with the activity's result (or raises :class:`ActivityError`
        once its retry policy is exhausted)."""
        return self._attach(_WorkflowTask(
            "activity", self._next_seq(), name, payload=input))

    def create_timer(self, delay_seconds: float) -> _WorkflowTask:
        """A durable timer: fires ``delay_seconds`` after the moment it
        was scheduled (in history time), surviving host loss via the
        reminder machinery."""
        return self._attach(_WorkflowTask(
            "timer", self._next_seq(),
            fire_at=self._now + max(0.0, float(delay_seconds))))

    def sleep(self, delay_seconds: float) -> _WorkflowTask:
        return self.create_timer(delay_seconds)

    def wait_event(self, name: str) -> _WorkflowTask:
        """Wait for an external event raised at this instance. Events
        raised before the wait are buffered; each wait consumes one
        raising, FIFO per name."""
        if name.startswith(CHILD_EVENT_PREFIX):
            raise WorkflowNondeterminismError(
                f"event name {name!r} uses the reserved child-completion "
                "prefix")
        return self._attach(_WorkflowTask("event", self._next_seq(), name))

    def call_child(self, name: str, input: Any = None, *,
                   instance: str | None = None) -> _WorkflowTask:
        """Schedule a child workflow. Its instance id is derived from
        this instance and the task seq unless given, so replays (and
        crash-retried starts) address the SAME child — starts are
        idempotent on the child side."""
        seq = self._next_seq()
        task = _WorkflowTask("child", seq, name, payload={
            "input": input,
            "instance": instance or f"{self.instance}::c{seq}",
        })
        return self._attach(task)

    def register_compensation(self, name: str, input: Any = None) -> None:
        """Register a compensating activity. On orchestrator failure
        the engine runs every registered compensation exactly once, in
        reverse registration order."""
        self.compensations.append((name, input))

    # -- composition -------------------------------------------------------

    def when_all(self, tasks: Iterable[_WorkflowTask]) -> _WorkflowTask:
        """Resolves with the list of results once every task resolved;
        fails (with the first failed task's error, in list order) once
        all resolved and any failed."""
        children = list(tasks)
        comp = _WorkflowTask("all", None, children=children)
        if all(t.resolved for t in children):
            failed = next((t for t in children if t.error is not None), None)
            if failed is not None:
                comp.fail(failed.error)
            else:
                comp.resolve([t.value for t in children])
        self.tasks.append(comp)
        return comp

    def when_any(self, tasks: Iterable[_WorkflowTask]) -> _WorkflowTask:
        """Resolves with the winning task object — the one whose
        outcome landed in history FIRST (history position, a pure
        function of the log, so replay-stable even when a slower
        competitor's event arrives later). Lets an orchestrator race an
        activity against a timer."""
        children = list(tasks)
        comp = _WorkflowTask("any", None, children=children)
        resolved = [t for t in children if t.resolved]
        if resolved:
            comp.resolve(min(resolved, key=lambda t: t.resolved_pos))
        self.tasks.append(comp)
        return comp
