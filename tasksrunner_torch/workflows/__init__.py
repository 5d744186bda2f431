"""Durable, replayed workflows on the actor runtime: the port of
``tasksrunner/workflows/``.

An orchestrator is a deterministic ``async def (ctx, input)`` replayed
against its committed history; activities carry the side effects (each
with its retry policy and timeout), compensations give saga semantics,
timers ride the durable reminders, and every scheduling turn commits
atomically on the actor state store, so an instance survives ``kill -9``
between and during its steps. Gated by ``TASKSRUNNER_WORKFLOWS`` (off).
"""

from tasksrunner_torch.workflows.context import ActivityContext, WorkflowContext
from tasksrunner_torch.workflows.engine import (
    DRIVE_REMINDER, GC_REMINDER, WORKFLOW_ACTOR_TYPE, WorkflowEngine,
)
from tasksrunner_torch.workflows.runtime import WorkflowRuntime

__all__ = ["ActivityContext", "DRIVE_REMINDER", "GC_REMINDER", "WORKFLOW_ACTOR_TYPE",
           "WorkflowContext", "WorkflowEngine", "WorkflowRuntime"]
