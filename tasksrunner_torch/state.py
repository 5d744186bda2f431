"""An in-memory key/value state store: the part of
``tasksrunner/state/memory.py`` the scorer uses (get, set, delete).

Values are kept as their JSON text, so what a caller reads back is a
copy of what was saved, as it would be from any store behind a sidecar.
Nothing outlives the process.
"""

from __future__ import annotations

import json
from typing import Any


class InMemoryStateStore:
    def __init__(self, name: str = "memory") -> None:
        self.name = name
        self._items: dict[str, str] = {}

    async def get(self, key: str) -> Any:
        """The value saved under ``key``, or None."""
        raw = self._items.get(key)
        return None if raw is None else json.loads(raw)

    async def set(self, key: str, value: Any) -> None:
        self._items[key] = json.dumps(value)

    async def delete(self, key: str) -> None:
        self._items.pop(key, None)

    def keys(self) -> list[str]:
        return list(self._items)
