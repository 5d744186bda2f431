"""State stores: the port of ``tasksrunner/state/`` (the contract in
``base``, key prefixes in ``keyprefix``, the in-memory store in
``memory`` and the durable sqlite one in ``sqlite``)."""

from tasksrunner_torch.state.base import StateItem, TransactionOp
from tasksrunner_torch.state.memory import InMemoryStateStore

__all__ = ["InMemoryStateStore", "StateItem", "TransactionOp"]
