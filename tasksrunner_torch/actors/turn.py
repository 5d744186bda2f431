"""The object an actor turn handler receives: the port of
``tasksrunner/actors/turn.py``. Its own module, so that the app builds
turns without importing the actor runtime."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class ActorTurn:
    """One turn. The handler changes ``state`` in place (or replaces it)
    and returns a JSON-serialisable result. The owning replica commits
    ``state`` with an etag-guarded write after the handler returns, and
    acknowledges the turn only once that commit resolved.

    Two more kinds of change ride the same commit:

    * effects (:meth:`stage_effect`): writes to other keys of the actor
      store, applied in one transaction with the record, so a fenced
      zombie loses them with it: an effect is applied once per
      acknowledged turn (the workflow engine's exactly-once activities);
    * reminder changes (:meth:`set_reminder`, :meth:`clear_reminder`),
      folded into the record's reminder table before the commit.
    """

    actor_type: str
    actor_id: str
    #: the invoked method; a reminder turn's is the reminder's name
    method: str
    data: Any = None
    state: dict = field(default_factory=dict)
    #: "turn" for a caller's invocation, "reminder" for a firing
    kind: str = "turn"
    #: the reminder's name when kind == "reminder"
    reminder: str | None = None
    #: staged state ops, committed with the record
    effects: list = field(default_factory=list)
    #: staged reminder registrations (name → spec) and removals
    reminder_sets: dict = field(default_factory=dict)
    reminder_clears: list = field(default_factory=list)

    @property
    def is_reminder(self) -> bool:
        return self.kind == "reminder"

    def stage_effect(self, key: str, value: Any = None, *,
                     operation: str = "upsert") -> None:
        """Stage a write to ``key`` in the actor store, committed in one
        transaction with this turn's record."""
        if operation not in ("upsert", "delete"):
            raise ValueError(f"unknown effect operation {operation!r}")
        self.effects.append({"operation": operation, "key": key, "value": value})

    def set_reminder(self, name: str, due_seconds: float, *,
                     period_seconds: float | None = None, data: Any = None) -> None:
        """Register (or replace) a reminder with this turn's commit."""
        self.reminder_clears = [n for n in self.reminder_clears if n != name]
        self.reminder_sets[name] = {"dueSeconds": float(due_seconds),
                                    "periodSeconds": period_seconds, "data": data}

    def clear_reminder(self, name: str) -> None:
        """Remove a reminder with this turn's commit."""
        self.reminder_sets.pop(name, None)
        if name not in self.reminder_clears:
            self.reminder_clears.append(name)
