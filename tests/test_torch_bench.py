"""The port's benches (tasksrunner_torch/bench.py) on the CPU, at a small
size: bench.py's FLOP count and result keys, the serving lanes and the
flood drill on the in-process host, and the kernels' build knobs
(tasksrunner_torch/_kernels.py). No JAX: what bench.py computes is
written out here from bench.py:1912-1916 and :2611-2712."""

import asyncio
import hashlib
import json
import math
import os

import pytest
import torch

from tasksrunner_torch import _kernels, bench
from tasksrunner_torch.model import ModelConfig

STEP_KEYS = {"device", "batch", "seq_len", "d_model", "n_layers", "attention_core", "step_ms",
             "tflops_per_sec", "mfu", "einsum_core_step_ms", "einsum_core_mfu"}
LANE_KEYS = {"requests", "concurrency", "req_per_sec", "latency_p50_ms", "latency_p99_ms",
             "response_mismatches", "jit_cache_size_after_warmup",
             "jit_cache_size_after_load", "recompiles", "batches", "shed",
             "queue_wait_per_bucket", "service_time_per_bucket"}
FLOOD_KEYS = {"flooded", "served", "shed", "other_statuses", "shed_carry_retry_after",
              "max_queue", "concurrency", "budget_ms", "queue_wait_p50_ms",
              "queue_wait_p99_ms", "queue_wait_bound_ms", "bound_with_resolution_ms",
              "queue_wait_bounded"}
SERVE_KEYS = {"backend", "devices", "flash_attention", "serial", "batched", "flood",
              "throughput_ratio", "zero_recompiles"}


@pytest.mark.parametrize("cfg, batch", [
    (bench.BENCH_CONFIG, bench.BENCH_BATCH), (ModelConfig(), 8),
    (ModelConfig(seq_len=16, d_model=64, n_heads=4, d_ff=96, n_layers=3), 5)],
    ids=["bench", "served", "odd"])
def test_step_flops_is_bench_py_count(cfg, batch):
    b, s, d, ff, layers = batch, cfg.seq_len, cfg.d_model, cfg.d_ff, cfg.n_layers
    fwd = layers * (8 * b * s * d * d + 4 * b * s * s * d + 4 * b * s * d * ff)
    assert bench.step_flops(cfg, batch) == 3 * fwd
    if cfg == bench.BENCH_CONFIG:
        assert bench.step_flops(cfg, batch) == 10_720_238_370_816  # about 1.07e13


def test_peak_is_known_only_for_the_h100_sxm():
    assert bench._peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench._peak_flops("cpu") is None
    assert bench._peak_flops("NVIDIA A100-SXM4-80GB") is None


def test_step_bench_on_the_cpu_returns_bench_py_keys():
    result = bench.run_step_bench(device="cpu")
    assert STEP_KEYS <= set(result)
    assert result["mfu"] is None and result["einsum_core_mfu"] is None
    assert result["device"] == "cpu" and result["power_limit"] is None
    assert (result["batch"], result["seq_len"], result["n_layers"]) == (8, 32, 2)
    assert result["step_ms"] > 0 and result["einsum_core_step_ms"] > 0
    assert all(math.isfinite(x) for x in result["losses"] + result["einsum_core_losses"])
    # the plain versions run on the CPU: no kernel is launched
    assert not any(result["launches"].values())
    json.dumps(result)


def test_step_bench_restores_the_flash_flag(monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_FLASH", "off")
    bench.run_step_bench(device="cpu")
    assert os.environ["TASKSRUNNER_FLASH"] == "off"
    monkeypatch.delenv("TASKSRUNNER_FLASH")
    bench.run_step_bench(device="cpu")
    assert "TASKSRUNNER_FLASH" not in os.environ


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_step_bench()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(bench.run_ml_serve_bench(8, concurrency=2))


def test_serve_bench_lanes_and_flood_on_the_cpu():
    result = asyncio.run(asyncio.wait_for(bench.run_ml_serve_bench(
        32, concurrency=4, flood_s=0.5, flood_ramp_s=0.2, device="cpu"), 60))
    assert SERVE_KEYS <= set(result)
    assert result["backend"] == "cpu" and result["flash_attention"] is True
    for name, buckets in (("serial", 1), ("batched", 6)):
        lane = result[name]
        assert LANE_KEYS <= set(lane), name
        assert lane["requests"] == 32 and lane["response_mismatches"] == 0
        assert lane["recompiles"] == 0 and lane["jit_cache_size_after_warmup"] == buckets
        assert sum(lane["batches"].values()) >= 1 and lane["shed"] == 0
        waits = lane["queue_wait_per_bucket"]
        assert sum(row["count"] for row in waits.values()) == 32
        assert all(0 <= row["p50_ms"] <= row["p99_ms"] for row in waits.values())
        assert sum(row["count"] for row in lane["service_time_per_bucket"].values()) \
            == sum(lane["batches"].values())
    assert set(result["serial"]["batches"]) == {"1"}
    assert result["zero_recompiles"] is True
    flood = result["flood"]
    assert FLOOD_KEYS <= set(flood)
    assert flood["served"] > 0 and flood["shed"] > 0 and flood["other_statuses"] == 0
    assert flood["shed_carry_retry_after"] == ["1"] and flood["shed_without_retry_after"] == 0
    assert flood["flooded"] == flood["served"] + flood["shed"]
    assert flood["bound_with_resolution_ms"] == 2 * flood["queue_wait_bound_ms"]
    json.dumps(result)


def test_hist_rows_diff_two_snapshots():
    before = {"h": {"bounds": [1.0, 2.0], "series": [
        {"labels": {"bucket": "4"}, "counts": [1, 0, 0], "count": 1, "sum": 0.5}]}}
    after = {"h": {"bounds": [1.0, 2.0], "series": [
        {"labels": {"bucket": "4"}, "counts": [1, 2, 0], "count": 3, "sum": 3.5},
        {"labels": {"bucket": "8"}, "counts": [0, 0, 0], "count": 0, "sum": 0.0},
        {"labels": {}, "counts": [0, 0, 1], "count": 1, "sum": 9.0}]}}
    rows = bench._ml_hist_rows(before, after, "h")
    assert rows == {"4": {"count": 2, "p50_ms": 1500.0, "p99_ms": pytest.approx(1990.0)},
                    "all": {"count": 1, "p50_ms": 2000.0, "p99_ms": 2000.0}}
    assert bench._ml_hist_rows(before, after, "absent") == {}


def _todays_path(name: str):
    """The library path as the build named it before it had knobs: the
    hash of the flags and of every source."""
    digest = hashlib.sha256(" ".join(_kernels.NVCC_FLAGS).encode())
    for src in sorted(_kernels.CSRC.iterdir()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _kernels.BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd", "flash_ring"])
def test_library_path_carries_the_knobs(name, monkeypatch):
    for env in _kernels.KNOBS:
        monkeypatch.delenv(env, raising=False)
    default = _kernels.library_path(name)
    assert _kernels.defines() == ()
    assert default == _todays_path(name)
    monkeypatch.setenv("TRTORCH_FWD_STAGES", "3")
    assert _kernels.defines() == ("-DTR_FWD_STAGES=3",)
    three = _kernels.library_path(name)
    monkeypatch.setenv("TRTORCH_FWD_STAGES", "2")
    two = _kernels.library_path(name)
    monkeypatch.setenv("TRTORCH_BWD_STAGES", "5")
    assert _kernels.defines() == ("-DTR_BWD_STAGES=5", "-DTR_FWD_STAGES=2")
    both = _kernels.library_path(name)
    assert len({default, three, two, both}) == 4
    assert _kernels.library_path(name, ()) == default
    monkeypatch.setenv("TRTORCH_BWD_STAGES", "0")
    with pytest.raises(ValueError, match="positive integer"):
        _kernels.defines()


def test_each_knob_is_read_by_its_source():
    for macro, source in (("TR_FWD_STAGES", "flash_fwd.cu"), ("TR_BWD_STAGES", "flash_bwd.cu")):
        text = (_kernels.CSRC / source).read_text()
        assert f"#ifndef {macro}\n#define {macro} 4\n#endif" in text
        assert f"D == 128 ? 2 : {macro}" in text
    assert set(_kernels.KNOBS.values()) == {"TR_FWD_STAGES", "TR_BWD_STAGES"}
