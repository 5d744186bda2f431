"""An epoch-fenced lease over one record of a state store: the port of
``Lease`` and ``lease_seconds_default`` in
``tasksrunner/state/replication.py`` (the rest of that module is
:mod:`tasksrunner_torch.state.replication`, whose shard leaders hold
these leases).

The record, ``{owner, epoch, expires, host, pid, registered_at}``, is the
JAX one and is only ever replaced by an etag-guarded write, so of two
contenders for a takeover exactly one wins; each change of owner bumps
``epoch``. A holder is gone when its lease has expired or its local pid
is dead (:meth:`~tasksrunner_torch.invoke.resolver.NameResolver.local_pid_dead`),
so a killed holder is taken over without waiting out its lease. The
record and the sqlite file are the JAX package's, so a lease one package
holds fences the other. The orchestrator's control plane is one holder,
a replica set's leader another.
"""

from __future__ import annotations

import os
import time
from typing import Any

from tasksrunner_torch.envflag import env_number
from tasksrunner_torch.errors import EtagMismatch
from tasksrunner_torch.invoke.resolver import NameResolver

DEFAULT_LEASE_SECONDS = 5.0


def lease_seconds_default() -> float:
    return env_number("TASKSRUNNER_REPL_LEASE_SECONDS", DEFAULT_LEASE_SECONDS)


class Lease:
    def __init__(self, store: Any, key: str, *, lease_seconds: float | None = None) -> None:
        self._store = store
        self.key = key
        self.lease_seconds = (float(lease_seconds) if lease_seconds
                              else lease_seconds_default())

    def _record(self, owner: str, epoch: int) -> dict:
        return {"owner": owner, "epoch": int(epoch),
                "expires": time.time() + self.lease_seconds,
                "host": "127.0.0.1", "pid": os.getpid(), "registered_at": time.time()}

    @staticmethod
    def holder_gone(rec: dict) -> bool:
        """Expired, or held by a local pid that no longer exists."""
        if float(rec.get("expires", 0.0)) <= time.time():
            return True
        return NameResolver.local_pid_dead(rec.get("host"), rec.get("pid"),
                                           rec.get("registered_at"))

    async def peek(self) -> dict | None:
        item = await self._store.get(self.key)
        return None if item is None else item.value

    async def acquire(self, owner: str) -> int | None:
        """Take or renew the lease: the (possibly bumped) epoch, or None
        when another live holder has it or the takeover race was lost."""
        item = await self._store.get(self.key)
        if item is None:
            # a creation race: write, then check who won (the last write)
            await self._store.set(self.key, self._record(owner, 1))
            check = await self._store.get(self.key)
            if check is not None and check.value.get("owner") == owner:
                return 1
            return None
        rec = item.value
        epoch = int(rec.get("epoch", 0))
        if rec.get("owner") != owner:
            if not self.holder_gone(rec):
                return None
            epoch += 1
        try:
            await self._store.set(self.key, self._record(owner, epoch), etag=item.etag)
            return epoch
        except EtagMismatch:
            return None

    async def renew(self, owner: str) -> bool:
        item = await self._store.get(self.key)
        if item is None or item.value.get("owner") != owner:
            return False
        try:
            await self._store.set(self.key, self._record(owner, int(item.value.get("epoch", 0))),
                                  etag=item.etag)
            return True
        except EtagMismatch:
            return False

    async def release(self, owner: str) -> None:
        """Expire our own lease in place (the epoch kept, so the next
        acquisition still bumps it); nothing when we do not hold it."""
        item = await self._store.get(self.key)
        if item is None or item.value.get("owner") != owner:
            return
        try:
            await self._store.set(self.key, {**item.value, "expires": 0.0}, etag=item.etag)
        except EtagMismatch:
            pass
