"""Virtual actors: the port of ``tasksrunner/actors/``.

An actor is a named unit of state and behaviour (``("Counter",
"user-7")``) that the runtime places on exactly one replica at a time.
An app registers a turn handler per actor type with ``@app.actor(type)``;
callers use ``runtime.invoke_actor`` (or the sidecar's
``/v1.0/actors/{type}/{id}/method/{m}``) and never learn where the actor
lives. Gated by ``TASKSRUNNER_ACTORS`` (off), and booted too by
``TASKSRUNNER_WORKFLOWS``, whose instances are actors.
"""

from tasksrunner_torch.actors.runtime import ActorRuntime
from tasksrunner_torch.actors.turn import ActorTurn

__all__ = ["ActorRuntime", "ActorTurn"]
