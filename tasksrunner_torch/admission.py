"""Front-door admission control: the part of
``tasksrunner/observability/admission.py`` an app of the port uses.

A replica that keeps accepting work past saturation turns overload into
timeouts. The controller samples saturation signals a few times a
second, folds them into one score (the max of their ratios, each 1.0 at
its threshold) and flips into *shedding* when the score reaches 1.0.
While it sheds, the app's front door (``App.handle``) answers every
request but ``/healthz`` and ``/tasksrunner/*`` with 429 and a
``Retry-After`` of ceil(score) seconds, clamped to 1..30. Shedding stops
only when the score falls below 0.75 of the threshold, so the gate does
not flap at 1.0. Entering the shed state dumps the flight recorder's
ring (:mod:`tasksrunner_torch.flightrec`, reason ``admission-shed``).

The signals, each a ratio: the event loop's lag
(``event_loop_lag_seconds``, from :mod:`tasksrunner_torch.probes`) over
``TASKSRUNNER_ADMISSION_MAX_LAG_SECONDS`` (0.25); the worst write-queue
depth (the gauges :data:`QUEUE_GAUGES`, under any labels) over
``TASKSRUNNER_ADMISSION_MAX_QUEUE_DEPTH`` (512); the app's in-flight
requests over ``TASKSRUNNER_ADMISSION_MAX_INFLIGHT`` (64); and every
ratio a subsystem registered with :func:`register_signal` (the scorer's
batcher registers its tokens in flight). A threshold of 0 turns its
signal off. The sqlite store and broker set the queue gauges, once a
batch (``state_write_queue_depth``, ``broker_publish_queue_depth``).

Off unless ``TASKSRUNNER_ADMISSION`` is on: :meth:`AdmissionController.from_env`
returns None and the front door tests ``admission is not None`` and
nothing else.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import math
from typing import Callable

from tasksrunner_torch import flightrec
from tasksrunner_torch.envflag import env_flag, env_number
from tasksrunner_torch.metrics import MetricsRegistry, metrics as default_metrics
from tasksrunner_torch.probes import LAG_GAUGE

logger = logging.getLogger(__name__)

#: write-queue depth gauges; the worst series under any labels counts
QUEUE_GAUGES = ("state_write_queue_depth", "broker_publish_queue_depth")

SAMPLE_INTERVAL = 0.25
#: shedding stops only below this fraction of the entry threshold
EXIT_RATIO = 0.75
DEFAULT_MAX_LAG_SECONDS = 0.25
DEFAULT_MAX_QUEUE_DEPTH = 512
DEFAULT_MAX_INFLIGHT = 64
MAX_RETRY_AFTER_SECONDS = 30

#: ratios registered by subsystems the controller cannot know up front;
#: process-wide, so a subsystem registers without a handle on any app
_EXTRA_SIGNALS: dict[str, Callable[[], float]] = {}


def register_signal(name: str, fn: Callable[[], float]) -> None:
    """Fold ``fn()`` into every later :meth:`AdmissionController.sample`
    as one more ratio (>= 1.0 saturated). A name registered again
    replaces the earlier callable."""
    _EXTRA_SIGNALS[name] = fn


def unregister_signal(name: str) -> None:
    _EXTRA_SIGNALS.pop(name, None)


class AdmissionController:
    """Saturation sampler and hysteresis gate for one app.

    The front door reads :attr:`shedding`, a plain attribute, and when
    it is set, :meth:`retry_after_seconds`. :meth:`start` runs the
    sampler as an asyncio task. The signals' gauges are read from, and
    the controller's own written to, ``registry``: the process-wide
    :data:`~tasksrunner_torch.metrics.metrics` unless one is given."""

    def __init__(self, *, max_lag_seconds: float = DEFAULT_MAX_LAG_SECONDS,
                 max_queue_depth: float = DEFAULT_MAX_QUEUE_DEPTH,
                 max_inflight: float = DEFAULT_MAX_INFLIGHT,
                 inflight: Callable[[], int] | None = None,
                 registry: MetricsRegistry | None = None) -> None:
        self.max_lag_seconds = max_lag_seconds
        self.max_queue_depth = max_queue_depth
        self.max_inflight = max_inflight
        self.inflight = inflight
        self.registry = registry if registry is not None else default_metrics
        self.shedding = False
        self.score = 0.0
        self._task: asyncio.Task | None = None
        self._publish()

    @classmethod
    def from_env(cls, *, inflight: Callable[[], int] | None = None,
                 registry: MetricsRegistry | None = None) -> AdmissionController | None:
        """None unless ``TASKSRUNNER_ADMISSION`` is on."""
        if not env_flag("TASKSRUNNER_ADMISSION", default=False):
            return None
        return cls(
            max_lag_seconds=env_number("TASKSRUNNER_ADMISSION_MAX_LAG_SECONDS",
                                       DEFAULT_MAX_LAG_SECONDS),
            max_queue_depth=env_number("TASKSRUNNER_ADMISSION_MAX_QUEUE_DEPTH",
                                       DEFAULT_MAX_QUEUE_DEPTH),
            max_inflight=env_number("TASKSRUNNER_ADMISSION_MAX_INFLIGHT",
                                    DEFAULT_MAX_INFLIGHT),
            inflight=inflight, registry=registry)

    def sample(self) -> float:
        """Recompute the score and apply the hysteresis; the sampler
        calls it every :data:`SAMPLE_INTERVAL` seconds, a test may call
        it at once."""
        score = 0.0
        if self.max_lag_seconds > 0:
            score = max(score, self.registry.get(LAG_GAUGE) / self.max_lag_seconds)
        if self.max_queue_depth > 0:
            for name in QUEUE_GAUGES:
                for depth in self.registry.gauge_values(name):
                    score = max(score, depth / self.max_queue_depth)
        if self.max_inflight > 0 and self.inflight is not None:
            score = max(score, self.inflight() / self.max_inflight)
        for name, fn in list(_EXTRA_SIGNALS.items()):
            try:
                score = max(score, float(fn()))
            except Exception:  # noqa: BLE001 - one bad signal must not stop the sampler
                logger.exception("admission: signal %s failed", name)
        self.score = score
        if not self.shedding and score >= 1.0:
            self.shedding = True
            logger.warning("admission: shedding (saturation %.2f >= 1.0; "
                           "Retry-After %ds)", score, self.retry_after_seconds())
            # what led up to the trip: the flight recorder's ring
            flightrec.dump("admission-shed", {"score": score})
        elif self.shedding and score < EXIT_RATIO:
            self.shedding = False
            logger.info("admission: admitting again (saturation %.2f < %.2f)",
                        score, EXIT_RATIO)
        self._publish()
        return score

    def retry_after_seconds(self) -> int:
        """ceil(score) seconds, clamped to 1..30: the deeper the
        overload, the longer callers stay away."""
        return max(1, min(MAX_RETRY_AFTER_SECONDS, math.ceil(self.score)))

    def _publish(self) -> None:
        self.registry.set_gauge("admission_state", 1.0 if self.shedding else 0.0)
        self.registry.set_gauge("admission_saturation", self.score)

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
        while True:
            await asyncio.sleep(SAMPLE_INTERVAL)
            self.sample()
