"""The port's histograms (tasksrunner_torch/metrics.py) against the JAX
registry's (tasksrunner/observability/metrics.py): the same observations
give the same log2 bucket counts, and so the same percentiles; and the
flat snapshot that ``GET /metrics`` serves keeps its keys."""

import numpy as np
import pytest

from tasksrunner.observability.metrics import DEFAULT_BOUNDS as JAX_BOUNDS
from tasksrunner.observability.metrics import MetricsRegistry as JaxRegistry
from tasksrunner.observability.metrics import estimate_percentile as jax_percentile
from tasksrunner_torch.metrics import DEFAULT_BOUNDS, MetricsRegistry, estimate_percentile

LABEL_SETS = [{}, {"bucket": "1"}, {"bucket": "8"}, {"bucket": "32"}, {"bucket": "4", "lane": "x"}]


def _feed(registries, rng, n: int) -> None:
    """``n`` observations from 50 µs to 200 s, log-uniform, over the label
    sets, one at a time and in runs, into every registry alike."""
    values = np.exp(rng.uniform(np.log(50e-6), np.log(200.0), n))
    which = rng.integers(0, len(LABEL_SETS), n)
    i = 0
    while i < n:
        run = int(rng.integers(1, 40))
        labels = LABEL_SETS[which[i]]
        chunk = [float(v) for v in values[i:i + run]]
        for reg in registries:
            if run == 1:
                reg.observe("ml_queue_wait_seconds", chunk[0], **labels)
            else:
                reg.observe_many("ml_queue_wait_seconds", chunk, **labels)
        i += run


def _by_labels(snapshot: dict) -> dict:
    hist = snapshot["ml_queue_wait_seconds"]
    return {tuple(sorted(s["labels"].items())): s for s in hist["series"]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_count_as_the_jax_registry_does(seed):
    port, ref = MetricsRegistry(), JaxRegistry()
    _feed([port, ref], np.random.default_rng(seed), 3000)
    got, want = port.snapshot_histograms(), ref.snapshot_histograms()
    assert list(DEFAULT_BOUNDS) == list(JAX_BOUNDS)
    assert got["ml_queue_wait_seconds"]["bounds"] == want["ml_queue_wait_seconds"]["bounds"]
    got_series, want_series = _by_labels(got), _by_labels(want)
    assert list(got_series) == list(want_series)  # the same label sets, in the same order
    bounds = want["ml_queue_wait_seconds"]["bounds"]
    for key, w in want_series.items():
        g = got_series[key]
        assert g["counts"] == w["counts"] and g["count"] == w["count"]
        assert len(g["counts"]) == len(bounds) + 1 and g["counts"][-1] > 0  # past 105 s
        assert g["sum"] == pytest.approx(w["sum"], rel=1e-12)
        for q in (0.5, 0.99):
            assert abs(estimate_percentile(bounds, g["counts"], q)
                       - jax_percentile(bounds, w["counts"], q)) <= 1e-12


def test_values_on_and_beside_a_bound_fall_in_the_jax_registry_buckets():
    """A value equal to a bound counts in that bound's bucket; the next
    float above it in the next bucket."""
    port, ref = MetricsRegistry(), JaxRegistry()
    values = [0.0]
    for bound in DEFAULT_BOUNDS:
        values += [float(np.nextafter(bound, 0.0)), bound, float(np.nextafter(bound, np.inf))]
    for reg in (port, ref):
        reg.observe_many("ml_queue_wait_seconds", values)
    got = _by_labels(port.snapshot_histograms())[()]
    want = _by_labels(ref.snapshot_histograms())[()]
    assert got["counts"] == want["counts"]
    assert got["counts"][0] == 3 and got["counts"][-1] == 1


@pytest.mark.parametrize("seed", [3, 4])
def test_estimate_percentile_equals_the_jax_function(seed):
    rng = np.random.default_rng(seed)
    bounds = list(DEFAULT_BOUNDS)
    for _ in range(50):
        counts = [int(c) for c in rng.integers(0, 5, len(bounds) + 1)
                  * (rng.random(len(bounds) + 1) < 0.3)]
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert estimate_percentile(bounds, counts, q) == jax_percentile(bounds, counts, q)
    assert estimate_percentile(bounds, [0] * (len(bounds) + 1), 0.5) == 0.0


def test_flat_snapshot_keeps_its_keys():
    """``snapshot()`` is what ``GET /metrics`` serves: counters, gauges,
    each histogram's count, sum and max, and the uptime, flat."""
    reg = MetricsRegistry()
    reg.inc("ml_shed_total")
    reg.inc("ml_batches_total", bucket="8")
    reg.inc("ml_batches_total", 2, bucket="8")
    reg.set_gauge("ml_queue_depth", 3.0)
    reg.observe("ml_batch_size", 4.0)
    reg.observe_many("ml_queue_wait_seconds", [0.001, 0.004], bucket="8")
    snap = reg.snapshot()
    assert set(snap) == {
        "ml_shed_total", "ml_batches_total{bucket=8}", "ml_queue_depth",
        "ml_batch_size_count", "ml_batch_size_sum", "ml_batch_size_max",
        "ml_queue_wait_seconds_count{bucket=8}", "ml_queue_wait_seconds_sum{bucket=8}",
        "ml_queue_wait_seconds_max{bucket=8}", "uptime_seconds"}
    assert snap["ml_batches_total{bucket=8}"] == 3.0
    assert snap["ml_queue_wait_seconds_count{bucket=8}"] == 2
    assert snap["ml_queue_wait_seconds_sum{bucket=8}"] == pytest.approx(0.005)
    assert snap["ml_queue_wait_seconds_max{bucket=8}"] == 0.004
    series = reg.snapshot_histograms()["ml_queue_wait_seconds"]["series"]
    assert series == [{"labels": {"bucket": "8"}, "counts": series[0]["counts"],
                       "count": 2, "sum": pytest.approx(0.005), "max": 0.004,
                       "exemplars": []}]
    assert sum(series[0]["counts"]) == 2
