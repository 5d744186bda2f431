"""An in-process pub/sub broker: the port of ``tasksrunner/pubsub/memory.py``,
under the delivery contract of :mod:`tasksrunner_torch.pubsub.base`.

A group's consumers take turns (round robin) and the group takes one
message at a time; a nacked message comes back after ``retry_delay``
(or its :class:`~tasksrunner_torch.pubsub.base.Nack`'s ``retry_after``)
and is dead-lettered after ``max_attempts`` tries that count.
Nothing outlives the process.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from collections import defaultdict
from typing import Any, Awaitable, Callable

from tasksrunner_torch.component.registry import driver
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.pubsub.base import Handler, Message, Nack
from tasksrunner_torch.ids import hex16

logger = logging.getLogger(__name__)


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


@driver("pubsub.in-memory", "pubsub.memory")
def _memory_pubsub(spec: ComponentSpec, metadata: dict[str, str]) -> InMemoryBroker:
    return InMemoryBroker(spec.name, max_attempts=int(metadata.get("maxRetries", 3)),
                          retry_delay=float(metadata.get("retryDelaySeconds", 0.05)))
