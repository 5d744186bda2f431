"""The port's serving plane on the CPU: the micro-batcher's semantics
(tasksrunner_torch/batching.py), the scorer over real HTTP
(tasksrunner_torch/service.py) and the harness entry."""

import asyncio
import json
import threading
import time

import numpy as np
import pytest
import torch

from tasksrunner_torch import graft_entry, service
from tasksrunner_torch.batching import BatcherConfig, MicroBatcher
from tasksrunner_torch.errors import SaturatedError
from tasksrunner_torch.metrics import MetricsRegistry


def _recorder():
    calls = []

    def run_batch(items, bucket):
        calls.append((list(items), bucket))
        return [x * 10 for x in items]
    return run_batch, calls


async def test_batcher_flushes_on_size_and_pads_to_the_bucket():
    run_batch, calls = _recorder()
    # a registry of its own: the default is the process's, which other
    # tests in this process write too
    batcher = MicroBatcher(run_batch, config=BatcherConfig(
        max_batch=4, max_delay_ms=10_000, buckets=(1, 2, 4)), registry=MetricsRegistry())
    batcher.start()
    try:
        results = await asyncio.wait_for(
            asyncio.gather(*(batcher.submit(i) for i in range(4))), 5)
    finally:
        await batcher.stop()
    assert results == [0, 10, 20, 30]
    assert calls == [([0, 1, 2, 3], 4)]
    assert batcher.stats()["batches"] == {"4": 1}
    snap = batcher.registry.snapshot()
    assert snap["ml_batches_total{bucket=4}"] == 1
    assert snap["ml_batch_size_count"] == 1


async def test_batcher_deadline_runs_from_the_oldest_request():
    run_batch, calls = _recorder()
    batcher = MicroBatcher(run_batch, config=BatcherConfig(
        max_batch=8, max_delay_ms=300, buckets=(1, 2, 4, 8)))
    batcher.start()
    try:
        started = time.monotonic()
        first = asyncio.ensure_future(batcher.submit(1))
        await asyncio.sleep(0.2)
        second = asyncio.ensure_future(batcher.submit(2))
        await asyncio.wait_for(asyncio.gather(first, second), 5)
        elapsed = time.monotonic() - started
    finally:
        await batcher.stop()
    # one batch, flushed 300 ms after the FIRST request; a window that
    # restarted at the second would flush at 500 ms
    assert calls == [([1, 2], 2)]
    assert 0.29 <= elapsed < 0.45, elapsed


async def test_batcher_isolates_errors_and_rides_along_behind_a_batch():
    release = threading.Event()
    calls = []

    def run_batch(items, bucket):
        calls.append(list(items))
        if items == ["slow"]:
            release.wait(5)
        if "crash" in items:
            raise RuntimeError("batch crashed")
        return [ValueError("bad item") if x == "bad" else x for x in items]

    batcher = MicroBatcher(run_batch, config=BatcherConfig(
        max_batch=4, max_delay_ms=0, buckets=(1, 2, 4)))
    batcher.start()
    try:
        slow = asyncio.ensure_future(batcher.submit("slow"))
        await asyncio.sleep(0.05)
        # both queue while the slow batch holds the device: one batch next
        good = asyncio.ensure_future(batcher.submit("good"))
        bad = asyncio.ensure_future(batcher.submit("bad"))
        await asyncio.sleep(0.05)
        release.set()
        assert await asyncio.wait_for(slow, 5) == "slow"
        assert await asyncio.wait_for(good, 5) == "good"
        with pytest.raises(ValueError, match="bad item"):
            await asyncio.wait_for(bad, 5)
        with pytest.raises(RuntimeError, match="batch crashed"):
            await asyncio.wait_for(batcher.submit("crash"), 5)
        assert await asyncio.wait_for(batcher.submit("after"), 5) == "after"
    finally:
        await batcher.stop()
    assert calls == [["slow"], ["good", "bad"], ["crash"], ["after"]]


async def test_batcher_sheds_at_max_queue():
    release = threading.Event()

    def run_batch(items, bucket):
        release.wait(5)
        return items

    batcher = MicroBatcher(run_batch, config=BatcherConfig(
        max_batch=1, max_delay_ms=0, buckets=(1,), max_queue=2), registry=MetricsRegistry())
    batcher.start()
    try:
        running = asyncio.ensure_future(batcher.submit(0))
        await asyncio.sleep(0.05)  # the worker holds item 0
        queued = [asyncio.ensure_future(batcher.submit(i)) for i in (1, 2)]
        await asyncio.sleep(0.01)
        with pytest.raises(SaturatedError) as shed:
            await batcher.submit(3)
        assert shed.value.retry_after == 1.0
        assert batcher.saturation() >= 1.0
        release.set()
        assert await asyncio.wait_for(asyncio.gather(running, *queued), 5) == [0, 1, 2]
    finally:
        release.set()
        await batcher.stop()
    assert batcher.stats()["shed"] == 1
    assert batcher.registry.snapshot()["ml_shed_total"] == 1


async def _call(port, method, path, body=b""):
    """One HTTP/1.1 request over asyncio streams: (status, headers, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                     .encode() + body)
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), 120)
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    return int(lines[0].split(" ")[1]), headers, payload


async def test_scorer_serves_over_http_on_the_cpu(monkeypatch):
    monkeypatch.setenv("TASKSRUNNER_ML_MAX_DELAY_MS", "20")
    warmup_gate = threading.Event()
    real_init = service.init_params

    def gated_init(*args, **kwargs):
        warmup_gate.wait(10)
        return real_init(*args, **kwargs)

    monkeypatch.setattr(service, "init_params", gated_init)
    app = service.make_app(device="cpu")
    port = await app.start("127.0.0.1", 0)
    try:
        task = json.dumps({"taskId": "t-0", "taskName": "fix the deploy"}).encode()
        status, headers, _ = await _call(port, "POST", "/score", task)
        assert status == 503 and headers["Retry-After"] == "1"
        warmup_gate.set()
        await asyncio.wait_for(app.wait_ready(), 60)

        stats = json.loads((await _call(port, "GET", "/ml/stats"))[2])
        buckets = stats["buckets"]
        assert stats["ready"] and stats["jit_cache_size"] == len(buckets)

        # the scorer's series are in the process's registry: count this app's batches
        before = json.loads((await _call(port, "GET", "/metrics"))[2])
        bodies = [json.dumps({"taskId": f"t-{i}", "taskName": f"task {i} urgent",
                              "taskAssignedTo": "ops"}).encode() for i in range(24)]
        replies = await asyncio.gather(*(
            _call(port, "POST", "/score", b) for b in bodies))
        for i, (status, _, body) in enumerate(replies):
            assert status == 200, body
            scored = json.loads(body)
            assert scored["taskId"] == f"t-{i}"
            assert scored["priority"] in service.PRIORITY_LABELS
            assert 0.0 < scored["confidence"] <= 1.0

        for bad in (b"{not json", b"[1, 2]"):
            status, _, _ = await _call(port, "POST", "/score", bad)
            assert status == 400
        assert (await _call(port, "GET", "/nowhere"))[0] == 404
        assert (await _call(port, "GET", "/score"))[0] == 405

        stats = json.loads((await _call(port, "GET", "/ml/stats"))[2])
        assert stats["completed"] == 24
        assert stats["jit_cache_size"] == len(buckets)  # flat after the burst
        metrics = json.loads((await _call(port, "GET", "/metrics"))[2])
        assert sum(v - before.get(k, 0) for k, v in metrics.items()
                   if k.startswith("ml_batches_total")) == sum(stats["batches"].values())
    finally:
        warmup_gate.set()
        await app.stop()


def test_graft_entry_runs_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    logits = fn(*args)
    assert logits.shape == (8, 5) and logits.dtype == torch.float32
    assert np.isfinite(logits.numpy()).all()
