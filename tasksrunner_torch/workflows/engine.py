"""The workflow engine: replay, scheduling and sagas inside actor turns.
The port of ``tasksrunner/workflows/engine.py``, without its chaos hooks
(ROADMAP A23).

Every workflow instance is a virtual actor (type ``_Workflow``, id the
instance id), which gives it the actor runtime's durability:

* **One writer.** The actor's one-turn-at-a-time lock and epoch fencing
  mean one live replica appends to an instance's history; a zombie's
  commit dies on the etag chain.
* **Atomic progress.** One scheduling turn is one commit: the history
  events appended in the turn, the effects of the activities they record
  and the reminder changes land in one etag-guarded transaction
  (``ActorRuntime._commit`` with effects). A crash mid-turn loses the
  whole turn: its activities run again on replay (at least once), but
  their effects apply exactly once, since an effect exists only in the
  transaction of the event that records it.
* **Recovery.** The periodic ``__wfdrive`` reminder makes a running
  instance adoptable: when its owner dies, a surviving replica's sweep
  adopts the actor, fires the reminder, and replay goes on from the
  committed history.

The orchestrator is driven by one ``coro.send(None)`` per replay (see
:mod:`tasksrunner_torch.workflows.context`), and every unresolved task
made before the first unresolved await is the frontier.
``TASKSRUNNER_WORKFLOW_REPLAY_BATCH`` bounds the activities one turn runs:
the length of a turn against the work a crash loses.

Metrics: ``workflow_started_total``, ``workflow_completed_total``,
``workflow_activity_total``, ``workflow_compensation_total``,
``workflow_replays_total``, ``workflow_activity_latency_seconds`` and
``workflow_history_events``. With spans recorded, each scheduling turn
records ``workflow-turn {wf}`` in the instance's own trace (its id kept in
the instance's state, so an adopting replica appends to the same trace),
with ``workflow-activity``, ``workflow-compensation`` and
``workflow-timer`` spans under it.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable

from tasksrunner_torch.envflag import env_number
from tasksrunner_torch.errors import (
    ActivityError, WorkflowError, WorkflowNondeterminismError, WorkflowNotFound,
)
from tasksrunner_torch.ids import hex8, hex16
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.resiliency.policy import RetrySpec
from tasksrunner_torch.spans import active as spans_active, record_span
from tasksrunner_torch.tracing import TraceContext, current_trace, trace_scope
from tasksrunner_torch.workflows.context import (
    CHILD_EVENT_PREFIX, ActivityContext, WorkflowContext, _WorkflowTask,
)

logger = logging.getLogger(__name__)

#: the actor type every workflow instance lives under
WORKFLOW_ACTOR_TYPE = "_Workflow"
#: periodic reminder that keeps a running instance adoptable + driven
DRIVE_REMINDER = "__wfdrive"
#: one-shot reminder that truncates a terminal instance's history
GC_REMINDER = "__wfgc"

_TERMINAL = ("completed", "failed", "terminated")

DEFAULT_RETRY = RetrySpec(policy="exponential", duration=0.2,
                          max_interval=5.0, max_retries=3)


class WorkflowEngine:
    """App-side registries plus the turn handler for ``_Workflow``."""

    def __init__(self, app: Any):
        self.app = app
        self.workflows: dict[str, Callable] = {}
        #: name → (fn, RetrySpec, per-attempt timeout seconds)
        self.activities: dict[str, tuple] = {}
        #: the drive reminder's period; Runtime._start_workflows sets the
        #: actor sweep's
        self.drive_period = 2.0
        self.replay_batch = max(1, int(env_number("TASKSRUNNER_WORKFLOW_REPLAY_BATCH", 16)))
        self.default_timeout = env_number("TASKSRUNNER_WORKFLOW_ACTIVITY_TIMEOUT_SECONDS", 30.0)
        self.retain_seconds = env_number("TASKSRUNNER_WORKFLOW_HISTORY_RETAIN_SECONDS", 3600.0)

    # -- registration ------------------------------------------------------

    def register_workflow(self, name: str, fn: Callable) -> None:
        if name in self.workflows:
            raise WorkflowError(f"workflow {name!r} is already registered")
        self.workflows[name] = fn

    def register_activity(self, name: str, fn: Callable, *,
                          retry: RetrySpec | None = None,
                          timeout: float | None = None) -> None:
        if name in self.activities:
            raise WorkflowError(f"activity {name!r} is already registered")
        self.activities[name] = (fn, retry or DEFAULT_RETRY,
                                 timeout or self.default_timeout)

    # -- the actor turn handler --------------------------------------------

    async def handle_turn(self, turn: Any) -> dict:
        """Every workflow operation is an actor turn on the instance —
        serialized by the actor lock, committed atomically, fenced."""
        method = turn.method
        if turn.is_reminder:
            if method == GC_REMINDER:
                return self._gc(turn)
            return await self._advance(turn)  # DRIVE_REMINDER
        if method == "start":
            return await self._start(turn)
        if method == "step":
            return await self._advance(turn)
        if method == "raise":
            return await self._raise(turn)
        if method == "terminate":
            return await self._terminate(turn)
        raise WorkflowError(f"unknown workflow method {method!r}")

    # -- operations --------------------------------------------------------

    async def _start(self, turn: Any) -> dict:
        data = turn.data or {}
        name = str(data.get("wf") or "")
        if name not in self.workflows:
            raise WorkflowNotFound(
                f"no workflow named {name!r} is registered "
                f"(known: {sorted(self.workflows) or 'none'})")
        if turn.state.get("wf"):
            # idempotent restart: crash-retried starts and replayed
            # child starts land here — report, don't reinitialize
            return self._doc(turn, outcome=self._outcome_of(turn.state))
        ts = time.time()
        turn.state.update({
            "wf": name,
            "input": data.get("input"),
            "status": "running",
            "history": [{"t": "started", "ts": ts}],
            "created": ts,
            "updated": ts,
            "parent": data.get("parent"),
            "result": None,
            "error": None,
        })
        turn.set_reminder(DRIVE_REMINDER, self.drive_period,
                          period_seconds=self.drive_period)
        metrics.inc("workflow_started_total", workflow=name)
        return await self._advance(turn)

    async def _raise(self, turn: Any) -> dict:
        state = turn.state
        if not state.get("wf"):
            raise WorkflowNotFound(
                f"workflow instance {turn.actor_id!r} was never started")
        if state.get("status") in _TERMINAL:
            return self._doc(turn, outcome=state["status"])
        data = turn.data or {}
        name = str(data.get("name") or "")
        event_id = data.get("id")
        if event_id is not None:
            for event in state["history"]:
                if (event.get("t") == "event_raised"
                        and event.get("id") == event_id):
                    # duplicate delivery (a retried child notification):
                    # drop it, then still advance — idempotent
                    return await self._advance(turn)
        state["history"].append({
            "t": "event_raised", "ts": time.time(), "name": name,
            "data": data.get("data"), "id": event_id,
        })
        return await self._advance(turn)

    async def _terminate(self, turn: Any) -> dict:
        state = turn.state
        if not state.get("wf"):
            raise WorkflowNotFound(
                f"workflow instance {turn.actor_id!r} was never started")
        if state.get("status") in _TERMINAL:
            return self._doc(turn, outcome=state["status"])
        reason = str((turn.data or {}).get("reason") or "terminated")
        state["history"].append(
            {"t": "terminated", "ts": time.time(), "reason": reason})
        self._finalize(turn, "terminated", error=reason)
        return self._doc(turn, outcome="terminated")

    def _gc(self, turn: Any) -> dict:
        """Truncate a terminal instance's history to its last event (a
        summary stub). The GC reminder is one-shot: the runtime already
        popped it when it fired."""
        state = turn.state
        if state.get("status") in _TERMINAL and state.get("history"):
            dropped = len(state["history"]) - 1
            state["history"] = state["history"][-1:]
            state["gc_dropped_events"] = dropped
        return self._doc(turn, outcome=self._outcome_of(state))

    # -- the scheduler -----------------------------------------------------

    def _instance_trace(self, state: dict) -> dict | None:
        """The instance's durable trace identity. Created on the first
        traced turn (normally the start turn, whose caller context it
        joins) and carried in actor state like the history, so the
        replica that adopts the instance after its owner dies keeps
        appending to the SAME logical trace — replays and crashes
        stitch instead of fragmenting into per-owner traces."""
        if not spans_active():
            return None
        trace = state.get("trace")
        if trace is None:
            ctx = current_trace()
            trace = {"id": ctx.trace_id if ctx is not None else hex16(),
                     "root": hex8(),
                     "parent": ctx.span_id if ctx is not None else None}
            state["trace"] = trace
        return trace

    def _child_span(self, *, name: str, status: int, start: float,
                    duration: float, attrs: dict) -> None:
        """A span nested under the current workflow-turn span. Explicit
        ids on purpose: the ambient span IS the turn span, so letting
        record_span default would collide with it."""
        if not spans_active():
            return
        ctx = current_trace()
        if ctx is None:
            return
        record_span(kind="internal", name=name, status=status, start=start,
                    duration=duration, attrs=attrs, trace_id=ctx.trace_id,
                    span_id=hex8(), parent_id=ctx.span_id)

    async def _advance(self, turn: Any) -> dict:
        state = turn.state
        if not state.get("wf"):
            # adopted before start committed, or a stray reminder after
            # GC of an unstarted record — nothing to do
            return self._doc(turn, outcome="noop")
        if state.get("status") in _TERMINAL:
            turn.clear_reminder(DRIVE_REMINDER)
            return self._doc(turn, outcome=state["status"])
        trace = self._instance_trace(state)
        if trace is None:
            return await self._drive(turn)
        # One span per scheduling turn, recorded with an explicit
        # trace_id: the ambient context belongs to whichever caller or
        # reminder drove this turn, but the span belongs to the
        # instance's own trace. Replay passes inside the turn are NOT
        # separate spans — history replay re-executes nothing, so the
        # turn span just carries the event count it replayed over.
        if trace.get("rooted"):
            turn_ctx = TraceContext(trace_id=trace["id"], span_id=hex8(),
                                    parent_id=trace["root"])
        else:
            # the first traced turn IS the instance's root span
            turn_ctx = TraceContext(trace_id=trace["id"],
                                    span_id=trace["root"],
                                    parent_id=trace.get("parent"))
            trace["rooted"] = True
        started = time.time()
        perf = time.perf_counter()
        outcome = "error"
        try:
            with trace_scope(turn_ctx):
                doc = await self._drive(turn)
                outcome = doc.get("outcome") or "ok"
                return doc
        finally:
            record_span(
                kind="internal", name=f"workflow-turn {state['wf']}",
                status=200 if outcome != "error" else 500,
                start=started, duration=time.perf_counter() - perf,
                attrs={"instance": turn.actor_id, "outcome": outcome,
                       "events": len(state.get("history") or ())},
                trace_id=trace["id"], span_id=turn_ctx.span_id,
                parent_id=turn_ctx.parent_id)

    async def _drive(self, turn: Any) -> dict:
        state = turn.state
        wf_name = state["wf"]
        orchestrator = self.workflows.get(wf_name)
        if orchestrator is None:
            # host rolled forward without this workflow registered:
            # leave the instance intact for a replica that has it
            logger.warning("instance %s references unregistered workflow %r",
                           turn.actor_id, wf_name)
            return self._doc(turn, outcome="blocked")

        while True:
            metrics.inc("workflow_replays_total", workflow=wf_name)
            try:
                kind, payload, ctx = self._replay(turn.actor_id, wf_name,
                                                  state, orchestrator)
            except WorkflowNondeterminismError as exc:
                state["history"].append(
                    {"t": "failed", "ts": time.time(), "error": str(exc)})
                self._finalize(turn, "failed", error=str(exc))
                return self._doc(turn, outcome="failed")

            if kind == "done":
                state["history"].append(
                    {"t": "completed", "ts": time.time(), "result": payload})
                self._finalize(turn, "completed", result=payload)
                return self._doc(turn, outcome="completed")

            if kind == "wf_failed":
                return await self._compensate(turn, ctx, payload)

            # suspended: fire due timers first — they only append
            # events, so looping here is cheap and side-effect-free
            pending = [t for t in ctx.tasks
                       if not t.resolved and t.seq is not None]
            now = time.time()
            due = [t for t in pending
                   if t.kind == "timer" and t.fire_at <= now]
            if due:
                for t in sorted(due, key=lambda t: t.seq):
                    state["history"].append(
                        {"t": "timer_fired", "ts": now, "seq": t.seq})
                    self._child_span(name="workflow-timer", status=200,
                                     start=now, duration=0.0,
                                     attrs={"seq": t.seq})
                continue

            runnable = [t for t in pending
                        if t.kind == "activity"][:self.replay_batch]
            if runnable:
                await self._run_batch(turn, ctx, runnable)
                self._touch(turn)
                return self._doc(turn, outcome="running",
                                 children=self._children(state, pending))
            timers = [t for t in pending if t.kind == "timer"]
            if timers:
                # pull the drive reminder forward to the next timer
                # fire — a 200ms durable timer must not wait for the
                # periodic drive cadence to come around
                delta = max(0.0, min(t.fire_at for t in timers) - now)
                turn.set_reminder(DRIVE_REMINDER, delta,
                                  period_seconds=self.drive_period)
            self._touch(turn)
            return self._doc(turn, outcome="blocked",
                             children=self._children(state, pending))

    def _replay(self, instance: str, wf_name: str, state: dict,
                orchestrator: Callable):
        """One replay pass: run the orchestrator against history, up to
        its first unresolved await (or to the end)."""
        ctx = WorkflowContext(instance=instance, workflow=wf_name,
                              history=state["history"],
                              input=state.get("input"))
        coro = orchestrator(ctx, state.get("input"))
        try:
            yielded = coro.send(None)
        except StopIteration as stop:
            return "done", stop.value, ctx
        except ActivityError as exc:
            return "wf_failed", str(exc), ctx
        except WorkflowNondeterminismError:
            raise
        except Exception as exc:  # noqa: BLE001 - the orchestrator's own failure
            return "wf_failed", f"{type(exc).__name__}: {exc}", ctx
        if not isinstance(yielded, _WorkflowTask):
            raise WorkflowNondeterminismError(
                f"workflow {wf_name!r} awaited a foreign awaitable "
                f"({type(yielded).__name__}); orchestrators may only await "
                "ctx.* tasks — do I/O inside activities")
        # the coroutine is intentionally abandoned (not closed): replay
        # rebuilds it from scratch next turn, and close() would inject
        # GeneratorExit into orchestrator try/finally blocks mid-flight
        return "suspended", yielded, ctx

    # -- activity execution ------------------------------------------------

    async def _run_batch(self, turn: Any, ctx: WorkflowContext,
                         runnable: list[_WorkflowTask]) -> None:
        """Execute up to one batch of activities concurrently; append
        their outcome events and stage their effects onto this turn —
        one commit for the whole batch."""
        outcomes = await asyncio.gather(
            *(self._run_activity(ctx, t.name, t.payload, seq=t.seq)
              for t in runnable))
        now = time.time()
        for task, (ok, value, effects) in zip(runnable, outcomes):
            if ok:
                turn.state["history"].append({
                    "t": "activity_completed", "ts": now,
                    "seq": task.seq, "name": task.name, "result": value})
            else:
                turn.state["history"].append({
                    "t": "activity_failed", "ts": now,
                    "seq": task.seq, "name": task.name, "error": value})
            turn.effects.extend(effects)

    async def _run_activity(self, ctx: WorkflowContext, name: str,
                            input: Any, *, seq: int,
                            is_compensation: bool = False):
        """One activity to completion under its retry policy. Never
        raises: outcomes are data the scheduler records."""
        entry = self.activities.get(name)
        if entry is None:
            metrics.inc("workflow_activity_total", activity=name,
                        status="unregistered")
            return (False, f"no activity named {name!r} is registered", [])
        fn, retry, timeout = entry
        delays = retry.delays()
        attempt = 0
        while True:
            attempt += 1
            actx = ActivityContext(
                instance=ctx.instance, workflow=ctx.workflow, name=name,
                seq=seq, attempt=attempt, is_compensation=is_compensation)
            span_name = (f"workflow-compensation {name}" if is_compensation
                         else f"workflow-activity {name}")
            wall = time.time()
            started = time.perf_counter()
            try:
                result = await asyncio.wait_for(fn(actx, input), timeout=timeout)
            except Exception as exc:  # noqa: BLE001 - an activity's failure is its outcome
                error = f"{type(exc).__name__}: {exc}"
                self._child_span(
                    name=span_name, status=500, start=wall,
                    duration=time.perf_counter() - started,
                    attrs={"activity": name, "attempt": attempt, "seq": seq,
                           "error": error})
                try:
                    delay = next(delays)
                except StopIteration:
                    metrics.inc("workflow_activity_total", activity=name,
                                status="error")
                    logger.warning(
                        "activity %s (instance %s, attempt %d) exhausted "
                        "retries: %s", name, ctx.instance, attempt, error)
                    return (False, error, [])
                metrics.inc("workflow_activity_total", activity=name,
                            status="retry")
                await asyncio.sleep(delay)
                continue
            elapsed = time.perf_counter() - started
            # observed inside the turn's trace scope, so a slow attempt
            # captures the instance trace_id as its exemplar
            metrics.observe("workflow_activity_latency_seconds",
                            elapsed, activity=name)
            metrics.inc("workflow_activity_total", activity=name, status="ok")
            self._child_span(
                name=span_name, status=200, start=wall, duration=elapsed,
                attrs={"activity": name, "attempt": attempt, "seq": seq})
            return (True, result, actx.effects)

    # -- sagas -------------------------------------------------------------

    async def _compensate(self, turn: Any, ctx: WorkflowContext,
                          error: str) -> dict:
        """The orchestrator failed: run registered compensations in
        reverse registration order. Each completed compensation appends
        a ``compensated`` event — replay skips it forever after, which
        is the exactly-once half; reverse order falls out of walking
        the (replay-stable) registration list backwards."""
        state = turn.state
        done = {int(e["idx"]) for e in state["history"]
                if e.get("t") == "compensated"}
        remaining = [i for i in range(len(ctx.compensations) - 1, -1, -1)
                     if i not in done]
        ran = 0
        for idx in remaining:
            if ran >= self.replay_batch:
                # bound the commit like a normal turn; the next drive
                # turn replays, fails at the same point, and continues
                self._touch(turn)
                return self._doc(turn, outcome="running")
            name, cinput = ctx.compensations[idx]
            ok, value, effects = await self._run_activity(
                ctx, name, cinput, seq=-(idx + 1), is_compensation=True)
            event = {"t": "compensated", "ts": time.time(), "idx": idx,
                     "name": name}
            if not ok:
                # a compensation out of retries is recorded (with its
                # error) rather than wedging the saga forever — the
                # history keeps the evidence for the operator
                event["error"] = value
            state["history"].append(event)
            turn.effects.extend(effects)
            metrics.inc("workflow_compensation_total", workflow=state["wf"])
            ran += 1
        state["history"].append(
            {"t": "failed", "ts": time.time(), "error": error})
        self._finalize(turn, "failed", error=error)
        return self._doc(turn, outcome="failed")

    # -- terminal & docs ---------------------------------------------------

    def _finalize(self, turn: Any, status: str, *, result: Any = None,
                  error: str | None = None) -> None:
        state = turn.state
        state["status"] = status
        state["result"] = result
        state["error"] = error
        self._touch(turn)
        turn.clear_reminder(DRIVE_REMINDER)
        if self.retain_seconds > 0:
            turn.set_reminder(GC_REMINDER, self.retain_seconds)
        metrics.inc("workflow_completed_total", workflow=state["wf"],
                    status=status)

    def _touch(self, turn: Any) -> None:
        turn.state["updated"] = time.time()
        metrics.observe("workflow_history_events",
                        len(turn.state.get("history") or ()),
                        workflow=turn.state.get("wf") or "")

    @staticmethod
    def _outcome_of(state: dict) -> str:
        status = state.get("status")
        return status if status in _TERMINAL else "running"

    def _children(self, state: dict,
                  pending: list[_WorkflowTask]) -> tuple[list, list]:
        """(start_children, pending_children) for the result doc. Both
        are recomputed every turn — starts are idempotent on the child,
        and the pending list lets the pump reconcile a lost completion
        notification by polling the child's terminal state."""
        start, waiting = [], []
        for t in pending:
            if t.kind != "child":
                continue
            child_instance = t.payload["instance"]
            event = f"{CHILD_EVENT_PREFIX}{t.seq}"
            start.append({
                "instance": child_instance, "wf": t.name,
                "input": t.payload.get("input"),
                "parent": {"instance": None, "event": event},
            })
            waiting.append({"instance": child_instance, "event": event})
        return start, waiting

    def _doc(self, turn: Any, *, outcome: str,
             children: tuple[list, list] | None = None) -> dict:
        state = turn.state
        start_children, pending_children = children or ([], [])
        for child in start_children:
            # the parent pointer needs OUR instance id, known here
            child["parent"]["instance"] = turn.actor_id
        doc: dict[str, Any] = {
            "instance": turn.actor_id,
            "workflow": state.get("wf"),
            "status": state.get("status"),
            "outcome": outcome,
            "result": state.get("result"),
            "error": state.get("error"),
            "events": len(state.get("history") or ()),
        }
        if start_children:
            doc["start_children"] = start_children
        if pending_children:
            doc["pending_children"] = pending_children
        parent = state.get("parent")
        if outcome in _TERMINAL and parent and parent.get("instance"):
            doc["notify_parent"] = {
                "instance": parent["instance"],
                "event": parent["event"],
                "data": ({"error": state.get("error")}
                         if outcome in ("failed", "terminated")
                         else {"result": state.get("result")}),
                "id": f"{turn.actor_id}::done",
            }
        return doc
