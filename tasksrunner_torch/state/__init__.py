"""State stores: the port of ``tasksrunner/state/`` (the contract in
``base``, key prefixes in ``keyprefix``, the in-memory store in
``memory``, the durable sqlite one in ``sqlite``, the sharded facade in
``sharding``, its placement map and heat in ``placement``, the
epoch-fenced lease over one record in ``lease``, and the replica sets in
``replication``)."""

from tasksrunner_torch.state.base import StateItem, TransactionOp
from tasksrunner_torch.state.memory import InMemoryStateStore

__all__ = ["InMemoryStateStore", "StateItem", "TransactionOp"]
