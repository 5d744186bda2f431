"""State stores: the port of ``tasksrunner/state/`` (the contract in
``base``, key prefixes in ``keyprefix``, the in-memory store in
``memory``, the durable sqlite one in ``sqlite``, and the epoch-fenced
lease over one record in ``lease``)."""

from tasksrunner_torch.state.base import StateItem, TransactionOp
from tasksrunner_torch.state.memory import InMemoryStateStore

__all__ = ["InMemoryStateStore", "StateItem", "TransactionOp"]
