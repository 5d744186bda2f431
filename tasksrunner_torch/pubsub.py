"""An in-process pub/sub broker: the port of ``tasksrunner/pubsub/memory.py``
and of the delivery contract in ``tasksrunner/pubsub/base.py``.

* One consumer group per subscribing app: every group on a topic gets
  each message; the consumers of one group compete for it (round robin).
  A group takes one message at a time.
* At-least-once delivery: a handler acks with a truthy result and nacks
  with a falsy one or by raising; a nacked message comes back after
  ``retry_delay`` and is dead-lettered after ``max_attempts`` tries.
* A :class:`Nack` carries hints: ``retry_after`` replaces the retry
  delay, and ``counts_attempt=False`` (a 429 or 503 with
  ``Retry-After``: the app declined the message without looking at it)
  redelivers it without using up an attempt, so a warm-up or a shedding
  front door cannot dead-letter a message.

Nothing outlives the process.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from tasksrunner_torch.tracing import hex16

logger = logging.getLogger(__name__)


@dataclass
class Message:
    id: str
    topic: str
    data: Any
    metadata: dict[str, str] = field(default_factory=dict)
    #: the delivery attempt this is, from 1
    attempt: int = 1


class Nack:
    """A falsy handler outcome that says when to redeliver and whether
    the try counts against the attempt budget."""

    __slots__ = ("retry_after", "counts_attempt")

    def __init__(self, retry_after: float | None = None, *,
                 counts_attempt: bool = True) -> None:
        self.retry_after = retry_after
        self.counts_attempt = counts_attempt

    def __bool__(self) -> bool:
        return False


def retry_after_from_headers(headers: dict[str, str] | None) -> float | None:
    """A numeric ``Retry-After`` from a header map (any case), or None."""
    for key, value in (headers or {}).items():
        if key.lower() == "retry-after":
            try:
                return max(0.0, float(value.strip()))
            except (TypeError, ValueError):
                return None
    return None


Handler = Callable[[Message], Awaitable["bool | Nack"]]


class _Group:
    """One consumer group on one topic: a queue and competing consumers."""

    def __init__(self) -> None:
        self.queue: asyncio.Queue[Message] = asyncio.Queue()
        self.consumers: list[Handler] = []
        self.rr = itertools.count()
        self.pump: asyncio.Task | None = None


class InMemoryBroker:
    def __init__(self, name: str = "memory", *, max_attempts: int = 3,
                 retry_delay: float = 0.05) -> None:
        self.name = name
        self.max_attempts = max_attempts
        self.retry_delay = retry_delay
        self._groups: dict[str, dict[str, _Group]] = defaultdict(dict)
        #: messages that ran out of attempts
        self.dead_letters: list[Message] = []
        self._closed = False

    async def publish(self, topic: str, data: Any, *,
                      metadata: dict[str, str] | None = None) -> str:
        msg_id = hex16()
        for group in self._groups.get(topic, {}).values():
            group.queue.put_nowait(Message(id=msg_id, topic=topic, data=data,
                                           metadata=dict(metadata or {})))
        return msg_id

    async def subscribe(self, topic: str, group: str,
                        handler: Handler) -> Callable[[], Awaitable[None]]:
        """Add ``handler`` to ``group`` on ``topic``; returns the
        coroutine function that cancels the subscription."""
        g = self._groups[topic].setdefault(group, _Group())
        g.consumers.append(handler)
        if g.pump is None:
            g.pump = asyncio.get_running_loop().create_task(self._pump(topic, group, g))

        async def cancel() -> None:
            if handler in g.consumers:
                g.consumers.remove(handler)
            if not g.consumers and g.pump is not None:
                g.pump.cancel()
                g.pump = None

        return cancel

    async def _pump(self, topic: str, group_name: str, g: _Group) -> None:
        while not self._closed:
            msg = await g.queue.get()
            handler = g.consumers[next(g.rr) % len(g.consumers)]
            try:
                ok = await handler(msg)
            except Exception:  # noqa: BLE001 - a raising handler nacks
                logger.exception("handler error on topic %s group %s", topic, group_name)
                ok = False
            if ok:
                continue
            hint = ok if isinstance(ok, Nack) else None
            counts = hint is None or hint.counts_attempt
            delay = (self.retry_delay if hint is None or hint.retry_after is None
                     else hint.retry_after)
            if counts and msg.attempt >= self.max_attempts:
                logger.warning("dead-lettering message %s on %s/%s after %d attempts",
                               msg.id, topic, group_name, msg.attempt)
                self.dead_letters.append(msg)
                continue
            if counts:
                msg.attempt += 1
            asyncio.get_running_loop().call_later(delay, g.queue.put_nowait, msg)

    async def aclose(self) -> None:
        self._closed = True
        for groups in self._groups.values():
            for g in groups.values():
                if g.pump is not None:
                    g.pump.cancel()
                    g.pump = None
