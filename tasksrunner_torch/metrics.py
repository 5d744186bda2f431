"""Counters, gauges and histograms for the serving plane: the part of
``tasksrunner.observability.metrics`` the batcher and the benches call
(``inc``, ``set_gauge``, ``observe``, ``observe_many``, ``snapshot``,
``snapshot_histograms`` and :func:`estimate_percentile`), and the merges
of several replicas' snapshots the orchestrator reads
(:func:`merge_histogram_snapshots`, :func:`merge_flat_snapshots`,
:func:`summarize_histograms`).

:data:`metrics` is the process-wide registry: the batcher (unless given
another), the runtime, the sidecar and the admission controller write
into it, and a sidecar serves it. Every literal name the port records is
declared in :mod:`tasksrunner_torch.names`.

A histogram keeps, per label set, its count, sum and largest value and
the counts of the JAX package's fixed log2 buckets (:data:`DEFAULT_BOUNDS`,
``len(bounds) + 1`` counts, the last one past the top bound), so a
snapshot's percentiles are those the JAX registry gives for the same
observations. An observation of at least
``TASKSRUNNER_SLOW_THRESHOLD_SECONDS`` (default 0.25) made inside a trace
keeps that trace's id as an *exemplar*: the newest :data:`MAX_EXEMPLARS`
per series, ``[trace_id, value, unix time]`` each, so the slow tail of a
histogram leads to its traces. :meth:`MetricsRegistry.observe` takes the
ambient trace; ``observe_many(..., traces=[...])`` takes one trace id
per value, for work that runs off the requests' tasks (a batch). A
slow observation that keeps an exemplar also calls the hook
:func:`set_on_slow_exemplar` installed (the flight recorder's). Values
wait in a per-series buffer and fold into the buckets in sorted runs of
:data:`FOLD_AT`, and at every snapshot, as the JAX registry folds them,
so a histogram's ``_sum`` is added in the same order and prints the
same digits.

:func:`render_prometheus` writes a registry as Prometheus text
exposition 0.0.4, the sidecar's ``GET /metrics``.
"""

from __future__ import annotations

import os
import threading
import time
from bisect import bisect_right
from typing import Any, Iterable

from tasksrunner_torch.tracing import current_trace

#: 100 µs · 2^i for i < 21 (to about 105 s): tasksrunner/observability/metrics.py:56
DEFAULT_BOUNDS: tuple[float, ...] = tuple(1e-4 * 2.0**i for i in range(21))

ENV_SLOW_THRESHOLD = "TASKSRUNNER_SLOW_THRESHOLD_SECONDS"
DEFAULT_SLOW_THRESHOLD = 0.25
#: exemplars kept per series, the newest
MAX_EXEMPLARS = 8
#: a series folds its buffered values into its buckets at this many
FOLD_AT = 512

#: called as ``hook(metric, trace_id, value)`` for every exemplar kept;
#: set by the flight recorder (:mod:`tasksrunner_torch.flightrec`)
on_slow_exemplar = None


def set_on_slow_exemplar(hook) -> None:
    """Install (or, with None, clear) the slow-exemplar observer."""
    global on_slow_exemplar
    on_slow_exemplar = hook


def _slow_threshold() -> float:
    try:
        return float(os.environ.get(ENV_SLOW_THRESHOLD) or DEFAULT_SLOW_THRESHOLD)
    except ValueError:
        return DEFAULT_SLOW_THRESHOLD

_Key = tuple[str, tuple[tuple[str, str], ...]]


def _key(name: str, labels: dict[str, str]) -> _Key:
    return name, tuple(sorted(labels.items()))


def _flat(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class _Series:
    __slots__ = ("count", "sum", "max", "counts", "exemplars", "pending")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.max = float("-inf")
        self.counts = [0] * (len(DEFAULT_BOUNDS) + 1)
        #: (trace_id, value, unix time), newest last
        self.exemplars: list[tuple[str, float, float]] = []
        #: observations not yet in the buckets
        self.pending: list[float] = []

    def fold(self) -> None:
        """The buffered values into the buckets, sorted, one bisect a
        bound (the caller holds the registry's lock)."""
        if not self.pending:
            return
        vals = sorted(self.pending)
        self.pending = []
        n = len(vals)
        prev = 0
        for i, bound in enumerate(DEFAULT_BOUNDS):
            # bucket i holds bounds[i-1] < value <= bounds[i]
            pos = bisect_right(vals, bound)
            if pos != prev:
                self.counts[i] += pos - prev
                prev = pos
            if pos == n:
                break
        if prev != n:
            self.counts[len(DEFAULT_BOUNDS)] += n - prev
        self.sum += sum(vals)
        self.count += n


class MetricsRegistry:
    """Thread-safe: the batcher records from the event loop, the
    service's batches run in a worker thread."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[_Key, float] = {}
        self._gauges: dict[_Key, float] = {}
        self._histograms: dict[_Key, _Series] = {}
        self.started_at = time.time()
        #: an observation at least this large keeps its trace as an exemplar
        self.slow_threshold = _slow_threshold()

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = _key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def get(self, name: str, **labels: str) -> float:
        """The gauge ``name`` with exactly these labels, else the counter,
        else 0."""
        key = _key(name, labels)
        with self._lock:
            if key in self._gauges:
                return self._gauges[key]
            return self._counters.get(key, 0.0)

    def gauge_values(self, name: str) -> list[float]:
        """The values of gauge ``name`` under every label set."""
        with self._lock:
            return [v for (n, _), v in self._gauges.items() if n == name]

    def observe(self, name: str, value: float, **labels: str) -> None:
        """One observation; when it is slow, the ambient trace (if any)
        becomes its exemplar."""
        ctx = current_trace() if value >= self.slow_threshold else None
        self._observe(name, [value], None if ctx is None else [ctx.trace_id], labels)

    def observe_many(self, name: str, values: list[float], *,
                     traces: list[str | None] | None = None, **labels: str) -> None:
        """Several observations of one series. ``traces``, aligned with
        ``values`` (None entries skipped), names each value's trace for
        its exemplar; without it no exemplar is kept."""
        self._observe(name, values, traces, labels)

    def _observe(self, name: str, values: list[float], traces: list[str | None] | None,
                 labels: dict[str, str]) -> None:
        if not values:
            return
        key = _key(name, labels)
        kept: list[tuple[str, float]] = []
        with self._lock:
            series = self._histograms.get(key)
            if series is None:
                series = self._histograms[key] = _Series()
            if traces is not None:
                for value, trace_id in zip(values, traces):
                    if value >= self.slow_threshold and trace_id:
                        if len(series.exemplars) >= MAX_EXEMPLARS:
                            del series.exemplars[0]
                        series.exemplars.append((trace_id, value, time.time()))
                        kept.append((trace_id, value))
            series.max = max(series.max, max(values))
            series.pending.extend(values)
            if len(series.pending) >= FOLD_AT:
                series.fold()
        hook = on_slow_exemplar
        if hook is not None:
            for trace_id, value in kept:
                try:
                    hook(name, trace_id, value)
                except Exception:  # noqa: BLE001 - telemetry must not fail the caller
                    pass

    def _folded(self) -> None:
        # the caller holds the lock
        for series in self._histograms.values():
            series.fold()

    def snapshot(self) -> dict[str, float]:
        """Flat ``name{label=value,...}`` → value; a histogram shows as
        ``name_count``, ``name_sum`` and ``name_max``."""
        with self._lock:
            self._folded()
            out = {_flat(n, ls): v for (n, ls), v in self._counters.items()}
            out.update({_flat(n, ls): v for (n, ls), v in self._gauges.items()})
            for (n, ls), series in self._histograms.items():
                out[_flat(f"{n}_count", ls)] = series.count
                out[_flat(f"{n}_sum", ls)] = series.sum
                out[_flat(f"{n}_max", ls)] = series.max
        out["uptime_seconds"] = time.time() - self.started_at
        return out

    def snapshot_kinds(self) -> dict[str, str]:
        """Each flat name of :meth:`snapshot` (labels left out) → "counter"
        or "gauge", what :func:`merge_flat_snapshots` sums or takes the
        largest of: a histogram's ``_count`` and ``_sum`` are counters,
        its ``_max`` a gauge."""
        kinds = {"uptime_seconds": "gauge"}
        with self._lock:
            kinds.update({n: "counter" for n, _ in self._counters})
            kinds.update({n: "gauge" for n, _ in self._gauges})
            for n, _ in self._histograms:
                kinds.update({f"{n}_count": "counter", f"{n}_sum": "counter",
                              f"{n}_max": "gauge"})
        return kinds

    def snapshot_histograms(self) -> dict[str, dict[str, Any]]:
        """Each histogram as ``{"bounds": [...], "series": [{"labels",
        "counts", "count", "sum", "max", "exemplars"}, ...]}``, series
        sorted by their labels: the shape of the JAX registry's
        ``snapshot_histograms`` (plus ``max``), so two snapshots diff
        bucket by bucket."""
        out: dict[str, dict[str, Any]] = {}
        with self._lock:
            self._folded()
            for (name, labels), series in sorted(self._histograms.items()):
                hist = out.setdefault(name, {"bounds": list(DEFAULT_BOUNDS), "series": []})
                hist["series"].append({"labels": dict(labels), "counts": list(series.counts),
                                       "count": series.count, "sum": series.sum,
                                       "max": series.max,
                                       "exemplars": [list(e) for e in series.exemplars]})
        return out


def merge_histogram_snapshots(snaps: Iterable[dict[str, dict[str, Any]]]
                              ) -> dict[str, dict[str, Any]]:
    """Replicas' :meth:`~MetricsRegistry.snapshot_histograms` merged, as
    ``tasksrunner/observability/metrics.py:396`` merges them: series of
    one name and label set add bucket by bucket (a series whose bounds
    differ from the first seen is skipped, not merged wrongly), their
    exemplars are pooled, and a ``max`` where the series carry one is the
    largest."""
    merged: dict[str, dict[str, Any]] = {}
    for snap in snaps:
        for name, hist in snap.items():
            target = merged.setdefault(name, {"bounds": list(hist["bounds"]), "series": {}})
            if target["bounds"] != list(hist["bounds"]):
                continue
            for series in hist["series"]:
                key = tuple(sorted(series["labels"].items()))
                slot = target["series"].get(key)
                if slot is None:
                    slot = target["series"][key] = {
                        "labels": dict(series["labels"]), "counts": list(series["counts"]),
                        "sum": float(series["sum"]), "count": int(series["count"]),
                        "exemplars": [list(e) for e in series.get("exemplars", ())]}
                    if "max" in series:
                        slot["max"] = float(series["max"])
                    continue
                slot["counts"] = [a + b for a, b in zip(slot["counts"], series["counts"])]
                slot["sum"] += float(series["sum"])
                slot["count"] += int(series["count"])
                slot["exemplars"].extend(list(e) for e in series.get("exemplars", ()))
                if "max" in series:
                    slot["max"] = max(slot.get("max", float("-inf")), float(series["max"]))
    return {name: {"bounds": hist["bounds"],
                   "series": [hist["series"][k] for k in sorted(hist["series"])]}
            for name, hist in merged.items()}


def merge_flat_snapshots(snaps: Iterable[dict[str, float]],
                         kinds: dict[str, str] | None = None) -> dict[str, float]:
    """Replicas' flat :meth:`~MetricsRegistry.snapshot` merged: a gauge
    (by ``kinds``) takes the largest value, anything else is summed."""
    kinds = kinds or {}
    out: dict[str, float] = {}
    for snap in snaps:
        for key, value in snap.items():
            if kinds.get(key.split("{", 1)[0]) == "gauge":
                out[key] = max(out.get(key, float("-inf")), float(value))
            else:
                out[key] = out.get(key, 0.0) + float(value)
    return out


def summarize_histograms(merged: dict[str, dict[str, Any]],
                         quantiles: tuple[float, ...] = (0.5, 0.95, 0.99)
                         ) -> list[dict[str, Any]]:
    """One row per series of merged histograms: name, labels, count, sum
    and the ``p50`` / ``p95`` / ``p99`` estimates."""
    rows: list[dict[str, Any]] = []
    for name, hist in sorted(merged.items()):
        for series in hist["series"]:
            row: dict[str, Any] = {"name": name, "labels": dict(series["labels"]),
                                   "count": series["count"], "sum": series["sum"]}
            for q in quantiles:
                row[f"p{int(q * 100)}"] = estimate_percentile(hist["bounds"], series["counts"], q)
            rows.append(row)
    return rows


def estimate_percentile(bounds: list[float], counts: list[int], q: float) -> float:
    """The q-quantile (0..1) of bucket ``counts`` over ``bounds``, by
    linear interpolation inside the bucket that holds it; observations
    past the top bound clamp to it (tasksrunner/observability/metrics.py:480)."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        prev_cum = cum
        cum += c
        if cum >= rank:
            if i >= len(bounds):
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            frac = (rank - prev_cum) / c
            return lo + (bounds[i] - lo) * frac
    return bounds[-1]


def _prom_label_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels: dict[str, str], extra: tuple[str, str] | None = None) -> str:
    parts = [f'{k}="{_prom_label_escape(str(v))}"' for k, v in sorted(labels.items())]
    if extra is not None:
        parts.append(f'{extra[0]}="{_prom_label_escape(extra[1])}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _format_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render_prometheus(registry: MetricsRegistry,
                      help_texts: dict[str, str] | None = None) -> str:
    """``registry`` as Prometheus text exposition 0.0.4
    (tasksrunner/observability/metrics.py:525): ``# HELP`` and ``# TYPE``
    once a name, the counters, then the gauges with ``uptime_seconds``,
    then each histogram's cumulative ``_bucket{le=...}`` series ending at
    ``+Inf``, its ``_sum`` and ``_count``; labels sorted and escaped. The
    help texts are :data:`tasksrunner_torch.names.ALL`'s unless given."""
    if help_texts is None:
        from tasksrunner_torch.names import ALL as help_texts
    lines: list[str] = []
    with registry._lock:
        counters = sorted(registry._counters.items())
        gauges = sorted(registry._gauges.items())
        uptime = time.time() - registry.started_at
    gauges.append((("uptime_seconds", ()), uptime))
    gauges.sort()

    def scalar_block(items: list, prom_type: str) -> None:
        last_name = None
        for (name, label_items), value in items:
            if name != last_name:
                lines.append(f"# HELP {name} {help_texts.get(name, name)}")
                lines.append(f"# TYPE {name} {prom_type}")
                last_name = name
            lines.append(f"{name}{_prom_labels(dict(label_items))} {_format_value(value)}")

    scalar_block(counters, "counter")
    scalar_block(gauges, "gauge")
    for name, hist in sorted(registry.snapshot_histograms().items()):
        lines.append(f"# HELP {name} {help_texts.get(name, name)}")
        lines.append(f"# TYPE {name} histogram")
        bounds = hist["bounds"]
        for series in hist["series"]:
            labels = series["labels"]
            cum = 0
            for i, bound in enumerate(bounds):
                cum += series["counts"][i]
                lines.append(
                    f"{name}_bucket{_prom_labels(labels, ('le', repr(float(bound))))} {cum}")
            cum += series["counts"][len(bounds)]
            lines.append(f"{name}_bucket{_prom_labels(labels, ('le', '+Inf'))} {cum}")
            lines.append(f"{name}_sum{_prom_labels(labels)} {repr(series['sum'])}")
            lines.append(f"{name}_count{_prom_labels(labels)} {series['count']}")
    lines.append("")
    return "\n".join(lines)


#: the process-wide registry
metrics = MetricsRegistry()
