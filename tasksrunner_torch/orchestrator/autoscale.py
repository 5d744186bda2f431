"""KEDA-style autoscaling for the orchestrator: the port of
``tasksrunner/orchestrator/autoscale.py``.

The controller asks each of an app's rules for a replica count, takes
the largest, clamps it to ``[min_replicas, max_replicas]`` and tells the
orchestrator: scale-out at once, scale-in only once the lower count has
held for the whole ``cooldown_seconds`` (load that returns restarts the
clock). The rules, as in the JAX package:

==================  ====================================================
``pubsub-backlog``   +1 replica per ``messageCount`` messages the app's
                     group has not settled in the component's sqlite
                     broker file, read out of band as KEDA reads the
                     broker (:func:`read_backlog`)
``queue-backlog``    +1 replica per ``messageCount`` messages neither
                     acked nor dead-lettered in the queue binding's file
                     (KEDA's ``azure-queue`` scaler; :func:`read_backlog`)
``http-concurrency`` +1 replica per ``concurrentRequests`` in flight,
                     summed over each replica's ``/tasksrunner/stats``
``cpu``              replicas so that each stays under ``utilization``
                     percent of a core, from ``/proc/<pid>/stat`` deltas
``memory``           scale-out while the mean RSS is over ``megabytes``,
                     scale-in only when the total still fits the
                     smaller fleet (``/proc/<pid>/status``)
``target-p99``       ``ceil(n · p99 / targetSeconds)`` over the window
                     of a histogram since the last evaluation, merged
                     over the replicas' sidecar ``/v1.0/metadata``
``loop-lag``         +1 replica while any replica's
                     ``event_loop_lag_seconds`` is over ``maxLagSeconds``
==================  ====================================================

A rule that raises is logged and skipped; only when every rule
fails does the count hold. Each verdict is set as the gauge
``autoscale_desired_replicas{app}``. There is no scale-to-zero:
``min_replicas`` is at least 1.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import os
import pathlib
import time
import urllib.request
from typing import Callable

from tasksrunner_torch.client import TOKEN_HEADER
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import ComponentError
from tasksrunner_torch.metrics import estimate_percentile, merge_histogram_snapshots, metrics
from tasksrunner_torch.orchestrator.config import RULE_TYPES, AppSpec, ScaleRule

logger = logging.getLogger(__name__)


def read_backlog(rule: ScaleRule, *, app_id: str, components: list[ComponentSpec],
                 base_dir: pathlib.Path) -> int:
    """The backlog a backlog rule watches, read from the component's file
    on a connection of its own (a relative path resolves against
    ``base_dir``): for ``pubsub-backlog`` the messages of its ``topic``
    the ``group`` (the app id by default) has not settled, for
    ``queue-backlog`` the queue's messages neither acked nor
    dead-lettered."""
    meta = rule.metadata
    comp_name = meta.get("component")
    spec = next((s for s in components if s.name == comp_name), None)
    if rule.type in ("pubsub-backlog", "queue-backlog") and spec is None:
        raise ComponentError(f"scale rule references unknown component {comp_name!r}")
    if rule.type == "pubsub-backlog":
        from tasksrunner_torch.pubsub.sqlite import open_for_inspection
        # nothing published yet is a backlog of 0
        broker = open_for_inspection(spec, base_dir, must_exist=False)
        try:
            return broker.backlog(meta.get("topic", ""), meta.get("group", app_id))
        finally:
            broker.close_sync()
    if rule.type == "queue-backlog":
        from tasksrunner_torch.bindings.localqueue import open_queue_for_inspection
        queue = open_queue_for_inspection(spec, base_dir)
        try:
            return queue.backlog()
        finally:
            queue.close()
    raise ComponentError(f"unknown scale rule type {rule.type!r}")


def _get_json(host: str | None, port: int, path: str, timeout: float,
              api_token: str | None) -> dict:
    if host in (None, "", "0.0.0.0"):
        host = "127.0.0.1"
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 headers={TOKEN_HEADER: api_token} if api_token else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _read_inflight(replicas: list[dict], timeout: float = 0.5,
                   api_token: str | None = None) -> int:
    """In-flight requests summed over the replicas' ``/tasksrunner/stats``;
    a replica that does not answer counts 0 (it may be restarting)."""
    total = 0
    for info in replicas:
        if not info.get("app_port"):
            continue
        try:
            total += int(_get_json(info.get("host"), info["app_port"], "/tasksrunner/stats",
                                   timeout, api_token).get("inflight", 0))
        except (OSError, ValueError):
            continue
    return total


def _fetch_replica_metadata(replicas: list[dict], timeout: float = 0.5,
                            api_token: str | None = None) -> list[dict]:
    """Each replica's sidecar ``/v1.0/metadata`` (flat metrics and
    histograms); a replica that does not answer is left out. Blocking:
    the controller calls it off the loop."""
    docs = []
    for info in replicas:
        if not info.get("sidecar_port"):
            continue
        try:
            docs.append(_get_json(info.get("host"), info["sidecar_port"], "/v1.0/metadata",
                                  timeout, api_token))
        except (OSError, ValueError):
            continue
    return docs


def _read_proc_cpu_ticks(pid: int) -> int | None:
    """utime + stime in clock ticks, from ``/proc/<pid>/stat``."""
    try:
        text = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return None
    # the command name may hold spaces: split after its closing paren
    rest = text.rpartition(")")[2].split()
    return int(rest[11]) + int(rest[12])  # fields 14 and 15


def _read_proc_rss_mb(pid: int) -> float:
    try:
        for line in pathlib.Path(f"/proc/{pid}/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0  # kB → MB
    except OSError:
        pass
    return 0.0


class AutoscaleController:
    """An app's desired replica count, driving ``set_replicas``."""

    def __init__(self, app: AppSpec, components: list[ComponentSpec],
                 set_replicas: Callable[[int], "asyncio.Future | None"], *,
                 base_dir: pathlib.Path | None = None, interval: float = 0.5,
                 replica_info: Callable[[], list[dict]] | None = None,
                 api_token: str | None = None) -> None:
        self.app = app
        self.components = components
        self.set_replicas = set_replicas
        self.base_dir = base_dir or pathlib.Path.cwd()
        self.interval = interval
        #: the token the replicas' stats and metadata routes ask for
        self.api_token = api_token
        #: the live replicas ({pid, app_port, sidecar_port, host} each),
        #: from the orchestrator
        self.replica_info = replica_info or (lambda: [])
        self.current = app.scale.min_replicas
        self._low_since: float | None = None
        self._task: asyncio.Task | None = None
        #: pid → (monotonic time, cpu ticks) at the previous poll
        self._cpu_prev: dict[int, tuple[float, int]] = {}
        #: metric → summed bucket counts at the previous evaluation
        self._p99_prev: dict[str, list[int]] = {}
        #: one metadata sweep per evaluation, shared by the telemetry rules
        self._metadata_docs: list[dict] | None = None
        #: (rule type, exception class) already logged with a traceback
        self._rule_failed: set[tuple[str, str]] = set()

    def _cpu_percent_total(self, replicas: list[dict]) -> float:
        """Summed CPU % of the replicas between two polls (100 = one busy
        core); a pid seen for the first time adds 0."""
        clk_tck = os.sysconf("SC_CLK_TCK")
        now = time.monotonic()
        total = 0.0
        live: set[int] = set()
        for info in replicas:
            pid = info.get("pid")
            if not pid:
                continue
            ticks = _read_proc_cpu_ticks(pid)
            if ticks is None:
                continue
            live.add(pid)
            prev = self._cpu_prev.get(pid)
            self._cpu_prev[pid] = (now, ticks)
            if prev is None or now - prev[0] <= 0:
                continue
            total += 100.0 * (ticks - prev[1]) / clk_tck / (now - prev[0])
        # a recycled pid must not inherit an exited one's ticks
        for pid in list(self._cpu_prev):
            if pid not in live:
                del self._cpu_prev[pid]
        return total

    def _replica_metadata(self) -> list[dict]:
        if self._metadata_docs is None:
            self._metadata_docs = _fetch_replica_metadata(self.replica_info(),
                                                          api_token=self.api_token)
        return self._metadata_docs

    def _target_p99_desired(self, rule: ScaleRule) -> int:
        """``ceil(n · p99 / target)`` over the observations since the last
        evaluation (negative deltas, a restarted replica's, clamp to 0);
        fewer than ``minSamples`` of them, or a p99 within the target,
        is no verdict (0)."""
        meta = rule.metadata
        metric = meta.get("metric", "sidecar_request_latency_seconds")
        target = max(float(meta.get("targetSeconds", 0.5)), 1e-6)
        min_samples = max(int(meta.get("minSamples", 10)), 1)
        docs = self._replica_metadata()
        hist = merge_histogram_snapshots([d.get("histograms") or {} for d in docs]).get(metric)
        if hist is None:
            self._p99_prev.pop(metric, None)
            return 0
        bounds = hist["bounds"]
        totals = [0] * (len(bounds) + 1)
        for series in hist["series"]:
            for i, c in enumerate(series["counts"]):
                totals[i] += int(c)
        prev = self._p99_prev.get(metric)
        self._p99_prev[metric] = totals
        if prev is None or len(prev) != len(totals):
            window = totals  # first sight: all of it is the window
        else:
            window = [max(0, c - p) for c, p in zip(totals, prev)]
        if sum(window) < min_samples:
            return 0
        p99 = estimate_percentile(bounds, window, 0.99)
        if p99 <= target:
            return 0
        return math.ceil(max(len(docs), 1) * p99 / target)

    def _loop_lag_desired(self, rule: ScaleRule) -> int:
        """One more replica while any replica's loop lags over the limit."""
        max_lag = max(float(rule.metadata.get("maxLagSeconds", 0.1)), 1e-6)
        worst = 0.0
        for doc in self._replica_metadata():
            for key, value in (doc.get("metrics") or {}).items():
                if key.split("{", 1)[0] == "event_loop_lag_seconds":
                    worst = max(worst, float(value))
        return self.current + 1 if worst > max_lag else 0

    def _rule_desired(self, rule: ScaleRule) -> int:
        meta = rule.metadata
        if rule.type in ("pubsub-backlog", "queue-backlog"):
            backlog = read_backlog(rule, app_id=self.app.app_id, components=self.components,
                                   base_dir=self.base_dir)
            return math.ceil(backlog / max(int(meta.get("messageCount", 10)), 1))
        if rule.type == "http-concurrency":
            per = max(int(meta.get("concurrentRequests", 10)), 1)
            return math.ceil(_read_inflight(self.replica_info(), api_token=self.api_token) / per)
        if rule.type == "cpu":
            threshold = max(float(meta.get("utilization", 70)), 1.0)
            return math.ceil(self._cpu_percent_total(self.replica_info()) / threshold)
        if rule.type == "memory":
            # scale-out from the mean (some replica over its budget),
            # scale-in only if the total fits the smaller fleet, and the
            # sum term never above the current count: a fixed per-replica
            # baseline over the budget must not ratchet to max_replicas,
            # and memory that follows the load must not flip-flop
            per_mb = max(float(meta.get("megabytes", 512)), 1.0)
            rss = [_read_proc_rss_mb(info["pid"]) for info in self.replica_info()
                   if info.get("pid")]
            if not rss:
                return 0
            mean_term = math.ceil((sum(rss) / len(rss)) / per_mb)
            sum_term = min(len(rss), math.ceil(sum(rss) / per_mb))
            return max(mean_term, sum_term)
        if rule.type == "target-p99":
            return self._target_p99_desired(rule)
        if rule.type == "loop-lag":
            return self._loop_lag_desired(rule)
        raise ComponentError(f"unknown scale rule type {rule.type!r} (known: {RULE_TYPES})")

    def desired_replicas(self) -> int:
        """The largest of the rules' counts, clamped to the app's bounds
        (the KEDA multi-trigger formula); blocking."""
        scale = self.app.scale
        self._metadata_docs = None  # a fresh sweep per evaluation
        if not scale.rules:
            return scale.min_replicas
        verdicts = []
        for rule in scale.rules:
            try:
                verdicts.append(self._rule_desired(rule))
            except Exception as exc:  # noqa: BLE001 - one broken signal must not stop scaling
                key = (rule.type, type(exc).__name__)
                if key not in self._rule_failed:
                    self._rule_failed.add(key)
                    logger.exception("scale rule %s for %s failed; skipping it",
                                     rule.type, self.app.app_id)
                else:
                    logger.warning("scale rule %s for %s still failing (%s); skipping it",
                                   rule.type, self.app.app_id, exc)
        # every rule failing is a blackout, not evidence the load went away
        desired = max(verdicts) if verdicts else self.current
        desired = max(scale.min_replicas, min(scale.max_replicas, desired))
        metrics.set_gauge("autoscale_desired_replicas", float(desired), app=self.app.app_id)
        return desired

    async def _apply(self, desired: int) -> None:
        self.current = desired
        result = self.set_replicas(desired)
        if asyncio.isfuture(result) or asyncio.iscoroutine(result):
            await result

    async def step(self) -> int:
        desired = await asyncio.to_thread(self.desired_replicas)
        now = time.monotonic()
        if desired > self.current:
            self._low_since = None
            logger.info("scaling %s out: %d -> %d replicas", self.app.app_id, self.current,
                        desired)
            await self._apply(desired)
        elif desired < self.current:
            if self._low_since is None:
                self._low_since = now
            elif now - self._low_since >= self.app.scale.cooldown_seconds:
                logger.info("scaling %s in: %d -> %d replicas", self.app.app_id,
                            self.current, desired)
                self._low_since = None
                await self._apply(desired)
        else:
            self._low_since = None
        return self.current

    async def run(self) -> None:
        while True:
            try:
                await self.step()
            except Exception:  # noqa: BLE001 - the loop must go on
                logger.exception("autoscale step failed for %s", self.app.app_id)
            await asyncio.sleep(self.interval)

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
