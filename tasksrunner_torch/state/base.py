"""The state store's contract: the port of ``tasksrunner/state/base.py``
without the query dialect.

Values are JSON documents. Every write gives a fresh, opaque etag; a
write may name the etag it expects (optimistic concurrency,
first-write-wins) and is refused with
:class:`~tasksrunner_torch.errors.EtagMismatch` when the stored one
differs. A store's methods:

* ``get(key)`` → :class:`StateItem` or None, ``bulk_get(keys)``;
* ``set(key, value, *, etag=None)`` → the new etag;
* ``delete(key, *, etag=None)`` → whether the key existed;
* ``transact(ops)``: :class:`TransactionOp` s applied atomically, every
  etag checked against the state before the transaction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Literal


@dataclass
class StateItem:
    """One key's stored document and its concurrency token."""

    key: str
    value: Any
    etag: str


@dataclass
class TransactionOp:
    """One operation inside a state transaction."""

    operation: Literal["upsert", "delete"]
    key: str
    value: Any = None
    etag: str | None = None
