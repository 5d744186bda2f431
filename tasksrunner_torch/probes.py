"""The event-loop-lag probe: the port of ``tasksrunner/observability/probes.py``.

A task sleeps for a fixed interval and reports how late the loop woke
it, as the gauge ``event_loop_lag_seconds`` of the process-wide
:data:`~tasksrunner_torch.metrics.metrics`. A loop that wakes 100 ms
late adds 100 ms to every request it serves; in the scorer the usual
cause is the batcher's worker thread holding the interpreter while it
launches a batch. The admission controller reads the gauge as its lag
signal (``TASKSRUNNER_ADMISSION_MAX_LAG_SECONDS``).

One probe per loop: :class:`~tasksrunner_torch.hosting.InProcHost` runs
one for all its apps, :meth:`App.start <tasksrunner_torch.app.App.start>`
one for an app served on its own, as the JAX sidecar keeps one per
replica.
"""

from __future__ import annotations

import asyncio
import contextlib

from tasksrunner_torch.metrics import MetricsRegistry, metrics as default_metrics

DEFAULT_INTERVAL = 0.5
LAG_GAUGE = "event_loop_lag_seconds"


class EventLoopLagProbe:
    """Timer-drift sampler feeding ``event_loop_lag_seconds``."""

    def __init__(self, interval: float = DEFAULT_INTERVAL,
                 registry: MetricsRegistry | None = None) -> None:
        self.interval = interval
        self.registry = registry if registry is not None else default_metrics
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            lag = loop.time() - t0 - self.interval
            self.registry.set_gauge(LAG_GAUGE, max(0.0, lag))
