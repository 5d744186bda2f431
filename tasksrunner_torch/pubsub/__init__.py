"""Pub/sub brokers: the port of ``tasksrunner/pubsub/`` (the delivery
contract in ``base``, the in-process broker in ``memory`` and the
durable sqlite one in ``sqlite``)."""

from tasksrunner_torch.pubsub.base import (
    Handler, Message, Nack, delivery_outcome, retry_after_from_headers,
)
from tasksrunner_torch.pubsub.memory import InMemoryBroker

__all__ = ["Handler", "InMemoryBroker", "Message", "Nack", "delivery_outcome",
           "retry_after_from_headers"]
