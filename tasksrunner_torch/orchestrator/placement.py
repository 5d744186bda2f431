"""The orchestrator's placement loop: the port of
``tasksrunner/orchestrator/placement.py``.

Every sharded store publishes its epoch, assignment and per-shard heat in
its sidecar's ``/v1.0/metadata`` (``placement``). A
:class:`PlacementController` sweeps those documents over an app's
replicas every 2 s, merges them into one view a store (the freshest
epoch's map and shard leaders, the rates summed, the hot shards and hot
keys of every replica) and keeps a rebalance plan beside a hot/cold ranking. The plan
is advice: only the process that owns a store can hold its write pause,
so a migration or a split runs there (``ShardedStateStore.migrate_shard``
/ ``split_shard``). ``/admin/placement`` and ``python -m
tasksrunner_torch shards`` show the view. The loop runs under
``TASKSRUNNER_RESHARD``; the telemetry under it is always on.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Callable

from tasksrunner_torch.client import TOKEN_HEADER, http_request
from tasksrunner_torch.state.placement import (
    merge_heat_docs, plan_rebalance, rank_shards,
)

logger = logging.getLogger(__name__)

#: seconds between sweeps: heat moves on multi-second half-lives and a
#: shard ranks hot only after 10 s, so a faster sweep only loads sidecars
SWEEP_INTERVAL = 2.0


class PlacementController:
    """One app's sweep of its replicas' placement telemetry into a plan."""

    def __init__(self, app_id: str, replica_info: Callable[[], list[dict]], *,
                 api_token: str | None = None) -> None:
        self.app_id = app_id
        self.replica_info = replica_info
        self.api_token = api_token
        #: store → merged view; replaced whole each sweep
        self.view: dict[str, dict] = {}
        self.last_sweep: float | None = None
        self._task: asyncio.Task | None = None
        self._warned_unreachable = False

    async def _fetch_metadata(self) -> list[dict]:
        """Every live replica sidecar's ``/v1.0/metadata`` (5 s each); one
        that does not answer is left out, so a restart cannot wedge the loop."""
        headers = {TOKEN_HEADER: self.api_token} if self.api_token else {}
        docs: list[dict] = []
        for info in self.replica_info():
            port = info.get("sidecar_port")
            if not port:
                continue
            try:
                status, _, body = await asyncio.wait_for(http_request(
                    "127.0.0.1", port, "GET", "/v1.0/metadata", headers=headers), 5)
                if status == 200:
                    docs.append(json.loads(body))
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError):
                continue
        return docs

    @staticmethod
    def _merge(docs: list[dict]) -> dict[str, dict]:
        """One view a store: the map of the document with the highest
        epoch (a replica that missed a flip reports a stale one), the
        rates summed over the replicas, the union of their hot shards and
        of their hot keys, ranked and planned."""
        per_store: dict[str, list[dict]] = {}
        for doc in docs:
            for store, pdoc in (doc.get("placement") or {}).items():
                if isinstance(pdoc, dict):
                    per_store.setdefault(store, []).append(pdoc)
        view: dict[str, dict] = {}
        for store, pdocs in sorted(per_store.items()):
            freshest = max(pdocs, key=lambda d: int(d.get("epoch", 0)))
            rates = merge_heat_docs(pdocs)
            hot: set[int] = set()
            top_keys: dict[str, list[str]] = {}
            for d in pdocs:
                heat = d.get("heat") or {}
                hot.update(int(i) for i in (heat.get("hot") or []))
                for shard, keys in (heat.get("top_keys") or {}).items():
                    bucket = top_keys.setdefault(str(shard), [])
                    bucket.extend(k for k in keys if k not in bucket)
            merged = {**freshest, "heat": {"rates": rates, "hot": sorted(hot),
                                           "top_keys": top_keys}}
            view[store] = {
                "store": store,
                "epoch": int(freshest.get("epoch", 0)),
                "shards": int(freshest.get("shards", 0)),
                "assignment": freshest.get("assignment") or {},
                "leaders": freshest.get("leaders") or {},
                "migration": freshest.get("migration"),
                "replicas_reporting": len(pdocs),
                "ranking": rank_shards(rates),
                "plan": plan_rebalance(merged),
            }
        return view

    async def step(self) -> dict[str, dict]:
        docs = await self._fetch_metadata()
        if not docs:
            if not self._warned_unreachable:
                self._warned_unreachable = True
                logger.warning("placement sweep for %s reached no replicas", self.app_id)
            return self.view
        self._warned_unreachable = False
        self.view = self._merge(docs)
        self.last_sweep = time.time()
        for store, entry in self.view.items():
            plan = entry.get("plan")
            if plan and plan.get("action"):
                logger.info("placement plan for %s/%s: %s shard %s (%s)", self.app_id, store,
                            plan["action"], plan.get("shard"), plan.get("reason"))
        return self.view

    def snapshot(self) -> dict:
        """This app's part of ``/admin/placement``."""
        return {"app_id": self.app_id, "last_sweep": self.last_sweep, "stores": self.view}

    async def run(self) -> None:
        while True:
            try:
                await self.step()
            except Exception:  # noqa: BLE001 - one bad sweep must not end the loop
                logger.exception("placement sweep failed for %s", self.app_id)
            await asyncio.sleep(SWEEP_INTERVAL)

    def start(self) -> None:
        self._task = asyncio.create_task(self.run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
