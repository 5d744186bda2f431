"""The bindings' contract: the port of ``tasksrunner/bindings/base.py``.

* An **input binding** pushes outside events into the app: the runtime
  starts it with a sink, and each event becomes a ``POST`` to the
  binding's :attr:`InputBinding.route` (``/<name>`` by default, the cron
  convention; a queue takes its ``route`` metadata). A 2xx acks the
  event; anything else nacks it, for the source to deliver again where it
  can.
* An **output binding** takes the app's data out:
  ``invoke(operation, data, metadata)`` → :class:`BindingResponse`
  (a blob ``create``, a mail ``create``).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable


@dataclass
class BindingEvent:
    """What an input binding delivers to the app."""

    binding: str
    data: Any
    metadata: dict[str, str] = field(default_factory=dict)


#: the runtime's sink: True acks (consumes) the event, False nacks it
EventSink = Callable[[BindingEvent], Awaitable[bool]]


@dataclass
class BindingResponse:
    """The result of an output binding's operation."""

    data: Any = None
    metadata: dict[str, str] = field(default_factory=dict)


class InputBinding(abc.ABC):
    #: the app route events go to
    route: str

    def __init__(self, name: str) -> None:
        self.name = name
        self.route = "/" + name
        #: set by the runtime that started this binding, so a shared
        #: instance is never started twice (which would orphan the first
        #: poll task)
        self.running = False

    @abc.abstractmethod
    async def start(self, sink: EventSink) -> None:
        """Deliver events to ``sink`` until :meth:`stop`."""

    @abc.abstractmethod
    async def stop(self) -> None: ...


class OutputBinding(abc.ABC):
    def __init__(self, name: str) -> None:
        self.name = name

    @abc.abstractmethod
    async def invoke(self, operation: str, data: Any,
                     metadata: dict[str, str] | None = None) -> BindingResponse: ...
