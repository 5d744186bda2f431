"""The state store's contract: the port of ``tasksrunner/state/base.py``.

Values are JSON documents. Every write gives a fresh, opaque etag; a
write may name the etag it expects (optimistic concurrency,
first-write-wins) and is refused with
:class:`~tasksrunner_torch.errors.EtagMismatch` when the stored one
differs. A store's methods:

* ``get(key)`` → :class:`StateItem` or None, ``bulk_get(keys)``;
* ``set(key, value, *, etag=None)`` → the new etag; an etag of
  :data:`ABSENT_ETAG` expects the key absent, so of two creates of one
  key the first wins and the second is refused (no store hands that etag
  out: etags count up from 1);
* ``delete(key, *, etag=None)`` → whether the key existed;
* ``transact(ops)``: :class:`TransactionOp` s applied atomically, every
  etag checked against the state before the transaction;
* ``query(query, *, key_prefix="")`` → :class:`QueryResponse`: the
  filter, sort and page dialect of :mod:`tasksrunner_torch.state.query`
  over the keys that start with ``key_prefix``; a malformed query raises
  :class:`~tasksrunner_torch.errors.QueryError`. Every store of the port
  takes the dialect (the JAX package's Redis store does not).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Literal

#: the etag a write names to expect its key absent (a guarded create); the
#: JAX package has none, so its first creates are unguarded
ABSENT_ETAG = "0"


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


@dataclass
class QueryResponse:
    items: list[StateItem] = field(default_factory=list)
    #: the next page's token; None once the results are exhausted
    token: str | None = None
