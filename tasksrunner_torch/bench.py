"""The scorer's benches on the card: the port of ``bench.py``'s train-step
lane (``run_tpu_step_bench``, bench.py:1844) and its serving lanes
(``_ml_hist_rows``, ``_ml_serve_lane``, ``_ml_flood_drill`` and
``run_ml_serve_bench``, bench.py:2429-2712).

    python -m tasksrunner_torch.bench --step     # one JSON line each
    python -m tasksrunner_torch.bench --serve

* :func:`run_step_bench`: one SGD step of the model at bench.py's bench
  config (vocab 32768, s 512, d 1024, 16 heads, ff 4096, 8 layers) at
  batch 32, timed first (``first_step_s``: it includes building and
  loading the kernels), then 20 more; the step time, TFLOP/s and MFU by
  bench.py's analytic FLOP count (:func:`step_flops`), with the flash
  core (``TASKSRUNNER_FLASH=1``) against the einsum core (``=0``), and
  each core's kernel launches.
* :func:`run_ml_serve_bench`: the scorer (``service.make_app``) in an
  :class:`~tasksrunner_torch.hosting.InProcHost` beside a calling app
  that calls ``POST /score`` through ``invoke_method``: a serial lane
  (``TASKSRUNNER_ML_BATCHING=0``) against a batched one (``=1``), and a
  flood drill that offers more than the queue admits. Each lane reads
  its queue wait and service time per bucket from a diff of the served
  app's registry (the process's, which other lanes also write: only
  the diff is the lane's), and its recompiles from ``/ml/stats``'s
  ``jit_cache_size`` (distinct shapes run).

Every lane runs on ``cuda:0`` unless ``device="cpu"`` is given, and
raises where there is no card. On the CPU the step lane runs the served
``ModelConfig()`` at batch 8 (bench.py's ``TASKSRUNNER_BENCH_TPU_FORCE``
smoke mode) and the kernels' plain versions run: its numbers are the
CPU's, with ``mfu`` null.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import math
import os
import subprocess
import time
from typing import Any, AsyncIterator, Iterator

import torch

from tasksrunner_torch import flash, service
from tasksrunner_torch.app import App
from tasksrunner_torch.batching import BatcherConfig
from tasksrunner_torch.client import AppClient
from tasksrunner_torch.device import resolve_device
from tasksrunner_torch.hosting import InProcHost
from tasksrunner_torch.metrics import estimate_percentile
from tasksrunner_torch.model import ModelConfig, init_params, make_train_step
from tasksrunner_torch.pubsub import InMemoryBroker
from tasksrunner_torch.state import InMemoryStateStore

#: bench.py:1867-1868's bench config, at its batch
BENCH_CONFIG = ModelConfig(vocab=32768, seq_len=512, d_model=1024, n_heads=16,
                           d_ff=4096, n_layers=8)
BENCH_BATCH = 32
#: the CPU's batch, at the served config
CPU_BATCH = 8
TIMED_STEPS = 20

#: dense bf16 tensor-core peak by device name (NVIDIA's H100 SXM data
#: sheet, at its 700 W limit); a card not listed gets ``mfu: null``
PEAK_FLOPS = {"H100 80GB HBM3": 989e12}

SCORER, CALLER = "priority-scorer", "bench-caller"
PUBSUB, STATE_STORE = "taskspubsub", "scores"


def _peak_flops(device_kind: str) -> float | None:
    return next((peak for name, peak in PEAK_FLOPS.items()
                 if name.lower() in device_kind.lower()), None)


def step_flops(cfg: ModelConfig, batch: int) -> int:
    """bench.py:1912-1916's analytic matmul FLOPs of one train step: per
    layer the forward is q/k/v/o 8·b·s·d² + attention 4·b·s²·d + the
    feed-forward 4·b·s·d·ff, and the step about 3× the forward."""
    b, s, d, ff = batch, cfg.seq_len, cfg.d_model, cfg.d_ff
    fwd = cfg.n_layers * (8 * b * s * d * d + 4 * b * s * s * d + 4 * b * s * d * ff)
    return 3 * fwd


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def power_limit(dev: torch.device) -> str | None:
    """The card's power limit as nvidia-smi gives it (``700.00 W``);
    None off the card."""
    if dev.type != "cuda":
        return None
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(dev.index or 0)],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return line.rsplit(",", 1)[1].strip()


@contextlib.contextmanager
def _env(overrides: dict[str, str]) -> Iterator[None]:
    """Set ``overrides`` in the environment; restore what was there."""
    prior = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        yield
    finally:
        for key, value in prior.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _time_steps(cfg: ModelConfig, tokens: torch.Tensor,
                labels: torch.Tensor) -> dict[str, Any]:
    """One step from fresh params, timed alone, then ``TIMED_STEPS`` more
    timed together, each timing ending in a synchronise; the launches and
    losses seen."""
    dev = tokens.device
    params = init_params(cfg, 0, dev)
    step = make_train_step(cfg)
    before = flash.launch_counts()
    started = time.perf_counter()
    params, loss = step(params, tokens, labels)
    first_loss = float(loss)  # waits for the step
    first_s = time.perf_counter() - started
    started = time.perf_counter()
    for _ in range(TIMED_STEPS):
        params, loss = step(params, tokens, labels)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_s = (time.perf_counter() - started) / TIMED_STEPS
    return {"first_step_s": first_s, "step_s": step_s, "losses": [first_loss, float(loss)],
            "launches": {k: v - before[k] for k, v in flash.launch_counts().items()}}


def run_step_bench(device: str | torch.device | None = None) -> dict[str, Any]:
    """The train step's time, TFLOP/s and MFU with the flash core, and
    again with the einsum core (``TASKSRUNNER_FLASH`` restored after)."""
    dev = resolve_device(device)
    cfg, batch = (ModelConfig(), CPU_BATCH) if dev.type == "cpu" else (BENCH_CONFIG, BENCH_BATCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen, device=dev,
                           dtype=torch.int32)
    labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen, device=dev)
    with _env({"TASKSRUNNER_FLASH": "1"}):
        flash_run = _time_steps(cfg, tokens, labels)
    with _env({"TASKSRUNNER_FLASH": "0"}):
        einsum_run = _time_steps(cfg, tokens, labels)

    flops = step_flops(cfg, batch)
    kind = device_name(dev)
    peak = _peak_flops(kind)
    return {
        "device": kind,
        "power_limit": power_limit(dev),
        "batch": batch,
        "seq_len": cfg.seq_len,
        "d_model": cfg.d_model,
        "n_layers": cfg.n_layers,
        "attention_core": "cuda-flash" if dev.type == "cuda" else "flash-plain-version",
        "flops_per_step": flops,
        "steps": TIMED_STEPS,
        "first_step_s": flash_run["first_step_s"],
        "step_ms": flash_run["step_s"] * 1e3,
        "tflops_per_sec": flops / flash_run["step_s"] / 1e12,
        "mfu": flops / flash_run["step_s"] / peak if peak else None,
        "losses": flash_run["losses"],
        "launches": flash_run["launches"],
        "einsum_core_step_ms": einsum_run["step_s"] * 1e3,
        "einsum_core_mfu": flops / einsum_run["step_s"] / peak if peak else None,
        "einsum_core_losses": einsum_run["losses"],
        "einsum_core_launches": einsum_run["launches"],
    }


# ---------------------------------------------------------------------------
# the serving lanes
# ---------------------------------------------------------------------------

def _ml_hist_rows(before: dict, after: dict, name: str) -> dict[str, dict]:
    """Per-bucket count, p50 and p99 (ms) of histogram ``name``, from the
    diff of two ``snapshot_histograms()``: only what fell between them."""
    hist = after.get(name)
    if not hist:
        return {}
    prior = {tuple(sorted(s["labels"].items())): s
             for s in before.get(name, {}).get("series", [])}
    rows = {}
    for series in hist["series"]:
        prev = prior.get(tuple(sorted(series["labels"].items())))
        counts = [c - (prev["counts"][i] if prev else 0)
                  for i, c in enumerate(series["counts"])]
        count = series["count"] - (prev["count"] if prev else 0)
        if count <= 0:
            continue
        rows[series["labels"].get("bucket", "all")] = {
            "count": count,
            "p50_ms": estimate_percentile(hist["bounds"], counts, 0.5) * 1e3,
            "p99_ms": estimate_percentile(hist["bounds"], counts, 0.99) * 1e3,
        }
    return rows


@contextlib.asynccontextmanager
async def _scorer_host(device: torch.device) -> AsyncIterator[tuple[AppClient, App]]:
    """The scorer on ``device`` and a calling app in an in-process host
    with a ``scores`` store and a ``taskspubsub`` broker, started and
    warmed up: (the calling app's client, the scorer app)."""
    host = InProcHost(state_stores={STATE_STORE: InMemoryStateStore(STATE_STORE)},
                      brokers={PUBSUB: InMemoryBroker(PUBSUB)})
    scorer = service.make_app(device=device)
    host.add_app(scorer)
    host.add_app(App(CALLER))
    await host.start()
    try:
        await host.wait_ready()
        yield host.client(CALLER), scorer
    finally:
        await host.stop()


async def _ml_stats(client: AppClient) -> dict:
    reply = await client.invoke_method(SCORER, "ml/stats", http_method="GET")
    if reply.status != 200:
        raise RuntimeError(f"/ml/stats answered {reply.status}: {reply.body!r}")
    return reply.json()


async def _ml_serve_lane(n_requests: int, concurrency: int, env: dict[str, str], *,
                         device: torch.device) -> dict[str, Any]:
    """One serving lane: ``n_requests`` ``POST /score`` calls from
    ``concurrency`` workers, every answer checked against its request's
    taskId."""
    with _env(env):
        async with _scorer_host(device) as (client, scorer):
            stats0 = await _ml_stats(client)
            hists0 = scorer.registry.snapshot_histograms()
            latencies: list[float] = []
            mismatches = 0

            async def worker(w: int) -> None:
                nonlocal mismatches
                for i in range(n_requests // concurrency):
                    task_id = f"t-{w}-{i}"
                    started = time.perf_counter()
                    resp = await client.invoke_method(
                        SCORER, "score",
                        data={"taskId": task_id,
                              "taskName": f"bench task {w} {i} " + "word " * (i % 7)})
                    latencies.append(time.perf_counter() - started)
                    if resp.status != 200 or resp.json().get("taskId") != task_id:
                        mismatches += 1

            wall0 = time.perf_counter()
            await asyncio.gather(*(worker(w) for w in range(concurrency)))
            wall = time.perf_counter() - wall0
            stats1 = await _ml_stats(client)
            hists1 = scorer.registry.snapshot_histograms()
    latencies.sort()
    done = len(latencies)
    return {
        "requests": done,
        "concurrency": concurrency,
        "req_per_sec": done / wall,
        "latency_p50_ms": latencies[done // 2] * 1e3,
        "latency_p99_ms": latencies[int(done * 0.99)] * 1e3,
        "response_mismatches": mismatches,
        "jit_cache_size_after_warmup": stats0["jit_cache_size"],
        "jit_cache_size_after_load": stats1["jit_cache_size"],
        "recompiles": stats1["jit_cache_size"] - stats0["jit_cache_size"],
        "batches": stats1["batches"],
        "shed": stats1["shed"],
        "queue_wait_per_bucket": _ml_hist_rows(hists0, hists1, "ml_queue_wait_seconds"),
        "service_time_per_bucket": _ml_hist_rows(hists0, hists1, "ml_infer_latency_seconds"),
    }


async def _ml_flood_drill(max_queue: int, max_delay_ms: float, *, device: torch.device,
                          concurrency: int = 64, duration_s: float = 2.5,
                          ramp_s: float = 0.6) -> dict[str, Any]:
    """More offered load than the queue admits: the overflow must shed
    with 429 + Retry-After, and the served requests' p99 queue wait stay
    within the assembly budget plus the device time of the batches ahead
    (bench.py:2539-2557). The wait histogram is snapshotted ``ramp_s``
    into the flood, so that the opening convoy is left out; the admitted
    queue stays at ``max_queue``, so an admitted request waits at most its
    window plus ``ceil(max_queue / max_batch) + 1`` batches (the one on the
    device when it came). The bounds are powers of two, so the p99 estimate
    may overstate the wait up to 2×: the check allows that factor (both
    numbers are reported)."""
    env = {"TASKSRUNNER_ML_MAX_QUEUE": str(max_queue),
           "TASKSRUNNER_ML_MAX_DELAY_MS": str(max_delay_ms)}
    with _env(env):
        max_batch = BatcherConfig.from_env().max_batch
        async with _scorer_host(device) as (client, scorer):
            loop = asyncio.get_running_loop()
            stop_at = loop.time() + duration_s
            served = shed = other = no_retry_after = 0
            retry_afters: set[str] = set()
            hists0 = scorer.registry.snapshot_histograms()

            async def ramp_snapshot() -> None:
                nonlocal hists0
                await asyncio.sleep(ramp_s)
                hists0 = scorer.registry.snapshot_histograms()

            async def worker(w: int) -> None:
                nonlocal served, shed, other, no_retry_after
                i = 0
                while loop.time() < stop_at:
                    resp = await client.invoke_method(
                        SCORER, "score",
                        data={"taskId": f"flood-{w}-{i}", "taskName": f"flood {w} {i}"})
                    i += 1
                    if resp.status == 200:
                        served += 1
                    elif resp.status == 429:
                        shed += 1
                        retry_after = resp.headers.get("retry-after")
                        if retry_after is None:
                            no_retry_after += 1
                        else:
                            retry_afters.add(retry_after)
                        # a shed answer never yields the loop: back off as a
                        # client honouring Retry-After would, scaled down so
                        # the flood goes on
                        await asyncio.sleep(0.002)
                    else:
                        other += 1

            await asyncio.gather(ramp_snapshot(), *(worker(w) for w in range(concurrency)))
            hists1 = scorer.registry.snapshot_histograms()
            stats = await _ml_stats(client)
    waits = _ml_hist_rows(hists0, hists1, "ml_queue_wait_seconds")
    infer = _ml_hist_rows(hists0, hists1, "ml_infer_latency_seconds")
    p99_wait = max((r["p99_ms"] for r in waits.values()), default=0.0)
    p50_wait = max((r["p50_ms"] for r in waits.values()), default=0.0)
    p99_infer = max((r["p99_ms"] for r in infer.values()), default=0.0)
    bound_ms = max_delay_ms + (math.ceil(max_queue / max_batch) + 1) * p99_infer
    return {
        "flooded": served + shed + other,
        "served": served,
        "shed": shed,
        "other_statuses": other,
        "shed_carry_retry_after": sorted(retry_afters),
        "shed_without_retry_after": no_retry_after,
        "max_queue": max_queue,
        "concurrency": concurrency,
        "budget_ms": max_delay_ms,
        "queue_wait_p50_ms": p50_wait,
        "queue_wait_p99_ms": p99_wait,
        "service_time_p99_ms": p99_infer,
        "queue_wait_bound_ms": bound_ms,
        "bound_with_resolution_ms": bound_ms * 2,
        "queue_wait_bounded": p99_wait <= bound_ms * 2,
        "jit_cache_size_after_load": stats["jit_cache_size"],
        "batches": stats["batches"],
    }


async def run_ml_serve_bench(n_requests: int = 384, *, concurrency: int = 16,
                             flood_s: float = 2.5, flood_ramp_s: float = 0.6,
                             device: str | torch.device | None = None) -> dict[str, Any]:
    """The serial lane (every request its own batch), the batched lane
    (micro-batches padded up the bucket ladder) at the same mix and
    concurrency, and the flood drill (``max_queue`` 32, a 25 ms window, 64
    workers for ``flood_s``). ``recompiles`` is the growth of
    ``jit_cache_size`` under load: the bar is zero."""
    dev = resolve_device(device)
    serial = await _ml_serve_lane(n_requests, concurrency,
                                  {"TASKSRUNNER_ML_BATCHING": "0"}, device=dev)
    batched = await _ml_serve_lane(n_requests, concurrency,
                                   {"TASKSRUNNER_ML_BATCHING": "1"}, device=dev)
    flood = await _ml_flood_drill(max_queue=32, max_delay_ms=25.0, device=dev,
                                  duration_s=flood_s, ramp_s=flood_ramp_s)
    return {
        "backend": dev.type,
        "device": device_name(dev),
        "power_limit": power_limit(dev),
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "flash_attention": flash.use_flash(),
        "serial": serial,
        "batched": batched,
        "flood": flood,
        "throughput_ratio": (batched["req_per_sec"] / serial["req_per_sec"]
                             if serial["req_per_sec"] else None),
        "zero_recompiles": serial["recompiles"] == 0 and batched["recompiles"] == 0,
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="The scorer's benches; each prints one JSON line.")
    lane = parser.add_mutually_exclusive_group(required=True)
    lane.add_argument("--step", action="store_true",
                      help="the train step at the bench config: ms, TFLOP/s, MFU, "
                           "flash against the einsum core")
    lane.add_argument("--serve", action="store_true",
                      help="serial against batched /score, per-bucket queue wait "
                           "and service time, recompiles, and the flood drill")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0; 'cpu' runs the lanes "
                             "on the CPU)")
    args = parser.parse_args(argv)
    if args.step:
        result = run_step_bench(args.device)
    else:
        result = asyncio.run(run_ml_serve_bench(device=args.device))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
