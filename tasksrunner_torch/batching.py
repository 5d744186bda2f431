"""Continuous-batching engine for the serving plane: the port of
``tasksrunner/ml/batching.py``, with the same semantics.

* **Micro-batch assembly under a latency budget.** Requests enter a
  queue; the worker flushes a batch on ``max_batch`` OR when the
  *oldest* queued request has waited ``max_delay_ms``, whichever comes
  first. Each request resolves through its own future, so one poisoned
  request fails alone, never its batchmates.
* **Padding-bucket shape discipline.** Assembled batches are padded up
  to a fixed ladder (default 1/2/4/8/16/32), which the service warms
  once per bucket at startup.
* **Saturation signalling.** Queue depth and tokens in flight are
  published as gauges; ``saturation()`` reports the worst ratio against
  ``max_queue`` / ``max_tokens``, and ``submit`` sheds with
  :class:`~tasksrunner_torch.errors.SaturatedError` once the queue is
  full. The ``ml_*`` series go into the process-wide registry
  (:data:`tasksrunner_torch.metrics.metrics`) unless ``registry=`` names
  another, as in the JAX batcher.

* **Spans.** When spans are recorded (:mod:`tasksrunner_torch.spans`),
  ``submit`` captures the submitter's trace context; each batch records
  one ``ml-batch`` span as its own trace root (many request traces
  converge on one batch), and one ``ml-request`` span in each
  submitter's trace, under its span, with the request's ``queue_wait``
  and the batch's ``service`` time, ``bucket`` and ``batch_trace``. A
  failed batch records them with status 500. The queue wait of each
  request is observed with its trace for the histogram's exemplars, and
  the service time inside the batch's trace.

The engine is model-agnostic: it schedules opaque items through a
caller-supplied ``run_batch(items, bucket) -> results`` executed in a
worker thread, so the event loop keeps serving while a batch runs.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Sequence

from tasksrunner_torch import spans
from tasksrunner_torch.envflag import env_number, env_str
from tasksrunner_torch.errors import SaturatedError
from tasksrunner_torch.ids import hex8
from tasksrunner_torch.metrics import MetricsRegistry, metrics as default_metrics
from tasksrunner_torch.tracing import TraceContext, current_trace, trace_scope

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)
DEFAULT_MAX_BATCH = 32
DEFAULT_MAX_DELAY_MS = 5.0
DEFAULT_MAX_QUEUE = 256
DEFAULT_MAX_TOKENS = 8192


def parse_buckets(raw: str) -> tuple[int, ...]:
    """``"1,2,4,8"`` → ``(1, 2, 4, 8)``: sorted, deduplicated,
    positives only. Falls back to :data:`DEFAULT_BUCKETS` on garbage
    rather than refusing to serve."""
    try:
        buckets = sorted({int(part) for part in raw.split(",") if part.strip()})
    except ValueError:
        logger.warning("ignoring malformed bucket ladder %r; using %s",
                       raw, DEFAULT_BUCKETS)
        return DEFAULT_BUCKETS
    buckets = tuple(b for b in buckets if b > 0)
    return buckets or DEFAULT_BUCKETS


@dataclass(frozen=True)
class BatcherConfig:
    """Knobs for one :class:`MicroBatcher` (env: ``TASKSRUNNER_ML_*``)."""

    max_batch: int = DEFAULT_MAX_BATCH
    max_delay_ms: float = DEFAULT_MAX_DELAY_MS
    buckets: tuple[int, ...] = DEFAULT_BUCKETS
    max_queue: int = DEFAULT_MAX_QUEUE
    max_tokens: int = DEFAULT_MAX_TOKENS

    def __post_init__(self) -> None:
        # max_batch can never exceed the largest warmed shape
        object.__setattr__(self, "buckets", tuple(sorted(set(self.buckets))))
        object.__setattr__(
            self, "max_batch", max(1, min(self.max_batch, self.buckets[-1])))

    @classmethod
    def from_env(cls) -> BatcherConfig:
        return cls(
            max_batch=int(env_number("TASKSRUNNER_ML_MAX_BATCH", DEFAULT_MAX_BATCH)),
            max_delay_ms=env_number("TASKSRUNNER_ML_MAX_DELAY_MS",
                                    DEFAULT_MAX_DELAY_MS),
            buckets=parse_buckets(env_str("TASKSRUNNER_ML_BUCKETS",
                                          ",".join(map(str, DEFAULT_BUCKETS)))),
            max_queue=int(env_number("TASKSRUNNER_ML_MAX_QUEUE", DEFAULT_MAX_QUEUE)),
            max_tokens=int(env_number("TASKSRUNNER_ML_MAX_TOKENS",
                                      DEFAULT_MAX_TOKENS)),
        )

    def serial(self) -> BatcherConfig:
        """The batch-of-one variant (``TASKSRUNNER_ML_BATCHING=off``):
        same queue/shed semantics, no assembly, one shape."""
        return replace(self, max_batch=1, buckets=(1,), max_delay_ms=0.0)


class _Pending:
    __slots__ = ("item", "tokens", "enqueued", "future", "ctx")

    def __init__(self, item: Any, tokens: int, enqueued: float,
                 future: asyncio.Future, ctx: TraceContext | None) -> None:
        self.item = item
        self.tokens = tokens
        self.enqueued = enqueued
        self.future = future
        #: the submitter's trace context, captured only when spans are on
        self.ctx = ctx


class MicroBatcher:
    """Request queue + micro-batch assembly + padding buckets.

    ``run_batch(items, bucket)`` receives the assembled items (length
    <= bucket) and the bucket to pad to; it runs in a worker thread and
    returns one result per item, in order. A result that is an
    ``Exception`` instance fails that item's future alone;
    ``run_batch`` raising fails only that batch's futures. The engine
    survives both.
    """

    def __init__(
        self,
        run_batch: Callable[[list[Any], int], Sequence[Any]],
        *,
        config: BatcherConfig | None = None,
        tokens_of: Callable[[Any], int] | None = None,
        registry: MetricsRegistry | None = None,
    ) -> None:
        self.config = config if config is not None else BatcherConfig()
        self._run_batch = run_batch
        self._tokens_of = tokens_of if tokens_of is not None else (lambda _: 1)
        #: where the ``ml_*`` series go: the process-wide registry unless
        #: one is given, so a hosted replica's sidecar serves them
        self.registry = registry if registry is not None else default_metrics
        self._queue: asyncio.Queue[_Pending] = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._tokens_in_flight = 0
        self._submitted = 0
        self._completed = 0
        self._shed = 0
        self._batch_counts: dict[int, int] = {}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        while not self._queue.empty():
            pending = self._queue.get_nowait()
            self._account_done([pending])
            if not pending.future.done():
                pending.future.set_exception(
                    RuntimeError("batcher stopped before the request ran"))

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    # -- submission ------------------------------------------------------

    async def submit(self, item: Any) -> Any:
        """Enqueue one item; resolves with its result once the batch it
        lands in has executed. Sheds with :class:`SaturatedError`
        (429 + Retry-After) when the queue is full."""
        if not self.running:
            raise RuntimeError("MicroBatcher.submit before start()")
        if self._queue.qsize() >= self.config.max_queue:
            self._shed += 1
            self.registry.inc("ml_shed_total")
            exc = SaturatedError(
                f"inference queue full ({self.config.max_queue} pending)")
            exc.retry_after = 1.0
            raise exc
        pending = _Pending(item, max(1, int(self._tokens_of(item))),
                           time.monotonic(),
                           asyncio.get_running_loop().create_future(),
                           current_trace() if spans.active() else None)
        self._submitted += 1
        self._tokens_in_flight += pending.tokens
        self._queue.put_nowait(pending)
        self._publish_depth()
        return await pending.future

    # -- saturation ------------------------------------------------------

    def saturation(self) -> float:
        """Worst ratio across the batcher's capacity signals (>= 1.0
        means saturated)."""
        score = 0.0
        if self.config.max_tokens > 0:
            score = max(score, self._tokens_in_flight / self.config.max_tokens)
        if self.config.max_queue > 0:
            score = max(score, self._queue.qsize() / self.config.max_queue)
        return score

    def stats(self) -> dict[str, Any]:
        return {
            "submitted": self._submitted,
            "completed": self._completed,
            "shed": self._shed,
            "queue_depth": self._queue.qsize(),
            "tokens_in_flight": self._tokens_in_flight,
            "batches": {str(k): v for k, v in sorted(self._batch_counts.items())},
            "buckets": list(self.config.buckets),
            "max_batch": self.config.max_batch,
            "max_delay_ms": self.config.max_delay_ms,
        }

    # -- the worker ------------------------------------------------------

    def bucket_for(self, size: int) -> int:
        """Smallest ladder entry >= size (sizes above the ladder are
        impossible: max_batch is clamped to the top bucket)."""
        for bucket in self.config.buckets:
            if bucket >= size:
                return bucket
        return self.config.buckets[-1]

    async def _run(self) -> None:
        while True:
            batch = [await self._queue.get()]
            # the budget runs from the OLDEST request's enqueue, so a
            # request that already waited behind a slow batch isn't
            # charged a fresh window on top
            deadline = batch[0].enqueued + self.config.max_delay_ms / 1000.0
            while len(batch) < self.config.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), remaining))
                except asyncio.TimeoutError:
                    break
            # whatever accumulated while the previous batch held the
            # device rides along with no extra waiting
            while len(batch) < self.config.max_batch and not self._queue.empty():
                batch.append(self._queue.get_nowait())
            self._publish_depth()
            await self._execute(batch)

    async def _execute(self, batch: list[_Pending]) -> None:
        bucket = self.bucket_for(len(batch))
        label = str(bucket)
        wall = time.time()
        waits = [time.monotonic() - p.enqueued for p in batch]
        # the batch is its own trace root (many request traces converge
        # on it); each request's ml-request span names it
        batch_ctx = TraceContext.new() if spans.active() else None
        with trace_scope(batch_ctx) if batch_ctx is not None else contextlib.nullcontext():
            self.registry.observe("ml_batch_size", float(len(batch)))
            self.registry.observe_many(
                "ml_queue_wait_seconds", waits, bucket=label,
                traces=[p.ctx.trace_id if p.ctx is not None else None for p in batch])
            started = time.monotonic()
            try:
                results = await asyncio.to_thread(
                    self._run_batch, [p.item for p in batch], bucket)
            except Exception as exc:
                logger.exception("inference batch of %d (bucket %d) failed",
                                 len(batch), bucket)
                self._record_spans(batch, waits, bucket, batch_ctx, wall,
                                   time.monotonic() - started, 500)
                self._account_done(batch)
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)
                return
            service = time.monotonic() - started
            # inside the batch's scope: a slow batch's exemplar is its trace
            self.registry.observe("ml_infer_latency_seconds", service, bucket=label)
            self._record_spans(batch, waits, bucket, batch_ctx, wall, service, 200)
        self.registry.inc("ml_batches_total", bucket=label)
        self._batch_counts[bucket] = self._batch_counts.get(bucket, 0) + 1
        self._account_done(batch)
        if len(results) != len(batch):
            mismatch = RuntimeError(
                f"run_batch returned {len(results)} results for "
                f"{len(batch)} items")
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(mismatch)
            return
        for p, result in zip(batch, results):
            if p.future.done():
                continue  # the caller gave up waiting; nothing to tell
            if isinstance(result, Exception):
                p.future.set_exception(result)
            else:
                p.future.set_result(result)

    def _record_spans(self, batch: list[_Pending], waits: list[float], bucket: int,
                      batch_ctx: TraceContext | None, wall: float, service: float,
                      status: int) -> None:
        """One ml-batch span, its own trace, and one ml-request span in
        each submitter's trace; explicit ids throughout, since the worker
        task has no submitter's context."""
        if batch_ctx is None:
            return
        spans.record_span(
            kind="internal", name="ml-batch", status=status, start=wall,
            duration=service, attrs={"bucket": bucket, "size": len(batch)},
            trace_id=batch_ctx.trace_id, span_id=batch_ctx.span_id)
        for p, wait in zip(batch, waits):
            if p.ctx is None:
                continue
            spans.record_span(
                kind="internal", name="ml-request", status=status,
                start=wall - wait, duration=wait + service,
                attrs={"queue_wait": wait, "service": service,
                       "bucket": bucket, "batch_trace": batch_ctx.trace_id},
                trace_id=p.ctx.trace_id, span_id=hex8(), parent_id=p.ctx.span_id)

    def _account_done(self, batch: list[_Pending]) -> None:
        self._completed += len(batch)
        self._tokens_in_flight -= sum(p.tokens for p in batch)
        self._publish_depth()

    def _publish_depth(self) -> None:
        self.registry.set_gauge("ml_queue_depth", float(self._queue.qsize()))
        self.registry.set_gauge("ml_tokens_in_flight",
                                float(self._tokens_in_flight))
