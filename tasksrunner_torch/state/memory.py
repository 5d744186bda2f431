"""An in-memory state store: the port of ``tasksrunner/state/memory.py``,
under the contract of :mod:`tasksrunner_torch.state.base`.

Values are kept as their JSON text, so what a caller reads back is a
copy of what was saved, as it would be from any store behind a sidecar.
Etags count up from 1. A query runs
:func:`~tasksrunner_torch.state.query.run_query` over the keys in order.
Nothing outlives the process.
"""

from __future__ import annotations

import itertools
import json
from typing import Any

from tasksrunner_torch.component.registry import driver
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import EtagMismatch
from tasksrunner_torch.state.base import ABSENT_ETAG, QueryResponse, StateItem, TransactionOp
from tasksrunner_torch.state.query import run_query


class InMemoryStateStore:
    def __init__(self, name: str = "memory") -> None:
        self.name = name
        #: key -> (JSON text, etag)
        self._items: dict[str, tuple[str, str]] = {}
        self._etags = itertools.count(1)

    async def get(self, key: str) -> StateItem | None:
        found = self._items.get(key)
        return None if found is None else StateItem(key, json.loads(found[0]), found[1])

    async def bulk_get(self, keys: list[str]) -> list[StateItem | None]:
        return [await self.get(key) for key in keys]

    def _check(self, key: str, etag: str | None) -> None:
        stored = self._items[key][1] if key in self._items else ABSENT_ETAG
        if etag is not None and stored != etag:
            raise EtagMismatch(f"etag mismatch for key {key!r}")

    def _set(self, key: str, text: str) -> str:
        etag = str(next(self._etags))
        self._items[key] = (text, etag)
        return etag

    async def set(self, key: str, value: Any, *, etag: str | None = None) -> str:
        self._check(key, etag)
        return self._set(key, json.dumps(value))

    async def delete(self, key: str, *, etag: str | None = None) -> bool:
        self._check(key, etag)
        return self._items.pop(key, None) is not None

    async def transact(self, ops: list[TransactionOp]) -> None:
        """Every etag checked first, then the ops applied in order."""
        for op in ops:
            self._check(op.key, op.etag)
        texts = [json.dumps(op.value) if op.operation == "upsert" else None for op in ops]
        for op, text in zip(ops, texts):
            if text is None:
                self._items.pop(op.key, None)
            else:
                self._set(op.key, text)

    async def query(self, query: dict, *, key_prefix: str = "") -> QueryResponse:
        candidates = [StateItem(key, json.loads(text), etag)
                      for key, (text, etag) in sorted(self._items.items())
                      if key.startswith(key_prefix)]
        items, token = run_query(candidates, query)
        return QueryResponse(items=items, token=token)

    def keys(self) -> list[str]:
        return list(self._items)


@driver("state.in-memory", "state.memory")
def _memory_state(spec: ComponentSpec, metadata: dict[str, str]) -> InMemoryStateStore:
    return InMemoryStateStore(spec.name)
