"""Counters, gauges and histograms for the serving plane: the part of
``tasksrunner.observability.metrics.MetricsRegistry`` the batcher calls
(``inc``, ``set_gauge``, ``observe``, ``observe_many``, ``snapshot``).

Each batcher keeps its own registry (``GET /metrics``); :data:`metrics`
is the process-wide one, which the admission controller writes
(``admission_state``, ``admission_saturation``, ``admission_shed_total``).

A histogram keeps its count, sum and largest value per label set, which
is bounded in memory; the JAX package's log2 buckets, exemplars and
Prometheus exposition are not ported.
"""

from __future__ import annotations

import threading
import time

_Key = tuple[str, tuple[tuple[str, str], ...]]


def _key(name: str, labels: dict[str, str]) -> _Key:
    return name, tuple(sorted(labels.items()))


def _flat(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """Thread-safe: the batcher records from the event loop, the
    service's batches run in a worker thread."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[_Key, float] = {}
        self._gauges: dict[_Key, float] = {}
        self._histograms: dict[_Key, list[float]] = {}  # [count, sum, max]
        self.started_at = time.time()

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = _key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value: float, **labels: str) -> None:
        self.observe_many(name, [value], **labels)

    def observe_many(self, name: str, values: list[float], **labels: str) -> None:
        if not values:
            return
        key = _key(name, labels)
        with self._lock:
            hist = self._histograms.setdefault(key, [0, 0.0, float("-inf")])
            hist[0] += len(values)
            hist[1] += sum(values)
            hist[2] = max(hist[2], max(values))

    def snapshot(self) -> dict[str, float]:
        """Flat ``name{label=value,...}`` → value; a histogram shows as
        ``name_count``, ``name_sum`` and ``name_max``."""
        with self._lock:
            out = {_flat(n, ls): v for (n, ls), v in self._counters.items()}
            out.update({_flat(n, ls): v for (n, ls), v in self._gauges.items()})
            for (n, ls), (count, total, peak) in self._histograms.items():
                out[_flat(f"{n}_count", ls)] = count
                out[_flat(f"{n}_sum", ls)] = total
                out[_flat(f"{n}_max", ls)] = peak
        out["uptime_seconds"] = time.time() - self.started_at
        return out


#: the process-wide registry
metrics = MetricsRegistry()
