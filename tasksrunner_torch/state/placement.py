"""Elastic shard placement: the port of ``tasksrunner/state/placement.py``.

:class:`~tasksrunner_torch.state.sharding.ShardRouter` says which shard a
key belongs to, a pure function of ``(key, seed, shards)``. This module
holds the mutable layer over it that a migration or a split moves:

* :class:`PlacementMap`: an epoch and a per-shard host assignment. A
  migration or a split commits by replacing the map with a successor at
  a strictly higher epoch (one attribute store, atomic under asyncio),
  and every state request that names an epoch is checked against it
  (``ShardedStateStore.check_epoch``): a stale router gets a 409 that
  carries the live epoch, never a write on the wrong shard.
* :class:`ShardHeatTracker`: each shard's write rate as an EWMA, with
  hysteresis (a shard ranks hot only after staying above the threshold
  for ``TASKSRUNNER_RESHARD_HYSTERESIS_SECONDS``) and a bounded sketch of
  its hot keys.
* :func:`merge_heat_docs`, :func:`rank_shards` and :func:`plan_rebalance`:
  the pure planning half of the orchestrator's placement loop
  (:mod:`tasksrunner_torch.orchestrator.placement`).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

from tasksrunner_torch.envflag import env_number
from tasksrunner_torch.errors import ComponentError

#: the header a routing-aware caller sends with the epoch it routed by;
#: a 409 carries the live epoch back in it
PLACEMENT_EPOCH_HEADER = "x-tasksrunner-placement-epoch"


def heat_threshold_default() -> float:
    return env_number("TASKSRUNNER_RESHARD_HEAT_THRESHOLD", 50.0)


def hysteresis_default() -> float:
    return env_number("TASKSRUNNER_RESHARD_HYSTERESIS_SECONDS", 10.0)


def pause_budget_default() -> float:
    return env_number("TASKSRUNNER_RESHARD_PAUSE_BUDGET_SECONDS", 2.0)


class PlacementMap:
    """One sharded store's epoched routing table, immutable by
    convention: :meth:`advanced` builds the successor. ``assignment``
    maps a shard index to a host or member label; ``migration`` is the
    status of a session in flight, or None."""

    __slots__ = ("epoch", "shards", "assignment", "migration")

    def __init__(self, *, shards: int, epoch: int = 1,
                 assignment: dict[int, str] | None = None,
                 migration: dict | None = None) -> None:
        if shards < 1:
            raise ComponentError(f"placement map needs >= 1 shard, not {shards}")
        self.epoch = int(epoch)
        self.shards = int(shards)
        self.assignment: dict[int, str] = dict(assignment or {})
        self.migration = migration

    def advanced(self, *, shards: int | None = None,
                 assignment: dict[int, str] | None = None,
                 migration: dict | None = None) -> PlacementMap:
        """The successor at ``epoch + 1``: the only way the epoch moves."""
        return PlacementMap(shards=self.shards if shards is None else shards,
                            epoch=self.epoch + 1,
                            assignment={**self.assignment, **(assignment or {})},
                            migration=migration)

    def with_migration(self, migration: dict | None) -> PlacementMap:
        """The same epoch with new status: status is telemetry, not
        routing, so it must not turn routers stale."""
        return PlacementMap(shards=self.shards, epoch=self.epoch,
                            assignment=self.assignment, migration=migration)

    def to_doc(self) -> dict:
        return {"epoch": self.epoch, "shards": self.shards,
                "assignment": {str(k): v for k, v in self.assignment.items()},
                "migration": self.migration}

    @classmethod
    def from_doc(cls, doc: dict) -> PlacementMap:
        return cls(shards=int(doc.get("shards", 1)), epoch=int(doc.get("epoch", 1)),
                   assignment={int(k): v for k, v in (doc.get("assignment") or {}).items()},
                   migration=doc.get("migration"))


class ShardHeatTracker:
    """Per-shard write-rate EWMA, hysteresis and a bounded hot-key sketch.

    :meth:`note_write` is on every write, so it only counts; the EWMA is
    folded in :meth:`sample`, which the metadata poll calls. The sketch
    is lossy counting: past :attr:`KEY_CAP` keys a shard's counts halve
    and the zeros go, so heavy hitters stay and the tail cannot grow it.
    The threshold and the hysteresis window are read from the environment
    when the tracker is made. ``clock`` is the monotonic clock, or a
    test's."""

    #: a shard's hot-key table is halved and pruned past this many keys
    KEY_CAP = 64
    #: seconds after which a burst's weight in the EWMA has halved
    HALFLIFE = 5.0

    def __init__(self, shards: int, *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.threshold = heat_threshold_default()
        self.hysteresis = hysteresis_default()
        self._clock = clock
        self._counts: list[int] = [0] * shards
        self._rates: list[float] = [0.0] * shards
        self._hot_since: list[float | None] = [None] * shards
        self._key_counts: list[dict[str, int]] = [{} for _ in range(shards)]
        self._last_sample = clock()

    @property
    def shards(self) -> int:
        return len(self._rates)

    def grow(self, extra: int = 1) -> None:
        """The ring grew (a split): the new shards start cold."""
        self._counts.extend([0] * extra)
        self._rates.extend([0.0] * extra)
        self._hot_since.extend([None] * extra)
        self._key_counts.extend({} for _ in range(extra))

    def note_write(self, shard: int, key: str | None = None) -> None:
        self._counts[shard] += 1
        if key is not None:
            table = self._key_counts[shard]
            table[key] = table.get(key, 0) + 1
            if len(table) > self.KEY_CAP:
                self._key_counts[shard] = {k: c // 2 for k, c in table.items() if c // 2 > 0}

    def sample(self, now: float | None = None) -> list[float]:
        """Fold the counts since the last sample into the rates and move
        the hysteresis clocks; nothing changes at zero elapsed time."""
        if now is None:
            now = self._clock()
        dt = now - self._last_sample
        if dt <= 0.0:
            return list(self._rates)
        self._last_sample = now
        # alpha → 1 as dt ≫ HALFLIFE: a rare poll still forgets old heat
        alpha = 1.0 - 0.5 ** (dt / self.HALFLIFE)
        for i, count in enumerate(self._counts):
            self._counts[i] = 0
            rate = self._rates[i] + alpha * (count / dt - self._rates[i])
            self._rates[i] = rate
            if rate < self.threshold:
                self._hot_since[i] = None
            elif self._hot_since[i] is None:
                self._hot_since[i] = now
        return list(self._rates)

    def rates(self) -> list[float]:
        return list(self._rates)

    def hot_shards(self, now: float | None = None) -> list[int]:
        """The shards above the threshold for a whole hysteresis window:
        the only ones a plan may act on."""
        if now is None:
            now = self._clock()
        return [i for i, since in enumerate(self._hot_since)
                if since is not None and now - since >= self.hysteresis]

    def hot_keys(self, shard: int, limit: int = 8) -> list[tuple[str, int]]:
        return sorted(self._key_counts[shard].items(), key=lambda kv: -kv[1])[:limit]

    def snapshot(self, now: float | None = None) -> dict:
        if now is None:
            now = self._clock()
        return {"rates": [round(r, 3) for r in self._rates],
                "hot": self.hot_shards(now),
                "threshold": self.threshold,
                "hysteresis_seconds": self.hysteresis,
                "top_keys": {str(i): [k for k, _ in self.hot_keys(i)]
                             for i in range(self.shards) if self._key_counts[i]}}


# -- the placement loop's planning: pure functions over heat documents -------

def merge_heat_docs(docs: Iterable[dict]) -> list[float]:
    """Per-shard rates summed over the replicas' documents (each replica
    has its own store, so the cluster's heat is the sum)."""
    merged: list[float] = []
    for doc in docs:
        rates = (doc.get("heat") or {}).get("rates") or []
        merged.extend([0.0] * (len(rates) - len(merged)))
        for i, r in enumerate(rates):
            merged[i] += float(r)
    return merged


def rank_shards(rates: list[float]) -> list[dict]:
    """The ranking the admin route and ``shards`` show, hottest first."""
    threshold = heat_threshold_default()
    ranked = sorted(({"shard": i, "rate": round(r, 3), "hot": r >= threshold}
                     for i, r in enumerate(rates)), key=lambda row: -row["rate"])
    for rank, row in enumerate(ranked):
        row["rank"] = rank
    return ranked


def plan_rebalance(store_doc: dict) -> dict | None:
    """One proposed action for a store's merged heat, or None. Only the
    shards past the hysteresis window (``heat.hot``) count. A shard hot
    across many keys is split (the grown ring takes about 1/(N+1) of
    them); one that a single key dominates cannot be cooled by a split
    and moves to the coldest host instead."""
    threshold = heat_threshold_default()
    heat = store_doc.get("heat") or {}
    rates = [float(r) for r in (heat.get("rates") or [])]
    hot = [i for i in (heat.get("hot") or []) if i < len(rates)]
    if not hot:
        return None
    hottest = max(hot, key=lambda i: rates[i])
    top_keys = (heat.get("top_keys") or {}).get(str(hottest)) or []
    return {"store": store_doc.get("store"),
            "action": "split" if len(top_keys) > 1 else "move",
            "shard": hottest,
            "rate": round(rates[hottest], 3),
            "coldest_shard": min(range(len(rates)), key=lambda i: rates[i]),
            "reason": f"shard {hottest} sustained {rates[hottest]:.1f} ops/s >= {threshold:.1f}"}
