"""The pub/sub delivery contract: the port of ``tasksrunner/pubsub/base.py``.

* Every consumer group on a topic gets each message; the consumers of
  one group compete for it.
* At-least-once delivery: a handler acks with a truthy result and nacks
  with a falsy one or by raising; a nacked message comes back later and
  is dead-lettered after the broker's ``max_attempts`` tries.
* A :class:`Nack` carries hints: ``retry_after`` replaces the broker's
  retry delay, and ``counts_attempt=False`` (a 429 or 503 with
  ``Retry-After``: the app declined the message without looking at it)
  redelivers it without using up an attempt, so a warm-up or a shedding
  front door cannot dead-letter a message.

A broker's ``subscribe(topic, group, handler)`` returns the coroutine
function that cancels the subscription.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable


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


def delivery_outcome(status: int, headers: dict[str, str] | None) -> bool | Nack:
    """What an app's answer to a delivery means to the broker: 2xx acks;
    429 or 503 with a numeric ``Retry-After`` is a :class:`Nack` that
    comes back after that many seconds without using up an attempt;
    anything else nacks."""
    if 200 <= status < 300:
        return True
    if status in (429, 503):
        delay = retry_after_from_headers(headers)
        if delay is not None:
            return Nack(retry_after=delay, counts_attempt=False)
    return False
