"""The policy engine of ``kind: Resiliency`` documents: the port of
``tasksrunner/resiliency/policy.py``.

* **timeouts**: a deadline for each attempt (``perAttempt``, the
  default) or for the whole call, backoff sleeps included (``total``);
* **retries**: ``constant`` or ``exponential`` backoff, bounded by
  ``maxRetries`` (``-1``: no bound) and ``maxInterval``, optionally
  blended with decorrelated jitter; a failure that carries
  ``retry_after`` (a 429's or 503's ``Retry-After``) stretches the next
  delay to it, clamped to ``maxInterval``;
* **circuit breakers**: one per (policy, target), closed → open after
  ``consecutiveFailures >= N`` → half-open after ``timeout`` (at most
  ``maxRequests`` probes) → closed on a probe's success, open again on
  its failure.

Counters go to the process-wide registry under the JAX package's names:
``resiliency_retry_total{target}``, ``resiliency_retry_exhausted_total{target}``
and the gauge ``resiliency_breaker_state{policy,target}`` (0 closed,
1 half-open, 2 open).
"""

from __future__ import annotations

import asyncio
import logging
import random
import re
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Iterator

from tasksrunner_torch.errors import CircuitOpenError, ComponentError
from tasksrunner_torch.metrics import metrics

logger = logging.getLogger(__name__)

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h)")
_UNIT_SECONDS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(raw: str | int | float) -> float:
    """``"500ms"`` / ``"5s"`` / ``"1m30s"`` / bare seconds → seconds."""
    if isinstance(raw, (int, float)):
        return float(raw)
    text = str(raw).strip()
    if not text:
        raise ComponentError("empty duration")
    matches = list(_DURATION_RE.finditer(text))
    if matches and "".join(m.group(0) for m in matches) == text.replace(" ", ""):
        return sum(float(m.group(1)) * _UNIT_SECONDS[m.group(2)] for m in matches)
    try:
        return float(text)
    except ValueError:
        raise ComponentError(f"cannot parse duration {raw!r}") from None


@dataclass(frozen=True)
class RetrySpec:
    """A named retry policy (``spec.policies.retries.<name>``)."""

    policy: str = "constant"  # or "exponential"
    #: the base delay between attempts
    duration: float = 5.0
    #: the exponential policy's cap
    max_interval: float = 60.0
    #: attempts after the first; -1: no bound
    max_retries: int = -1
    #: 0: the schedule above; 1: decorrelated jitter, min(cap,
    #: uniform(base, previous × 3)); between: the two blended linearly
    jitter: float = 0.0

    def delays(self, rng: random.Random | None = None) -> Iterator[float]:
        if self.jitter and rng is None:
            rng = random.Random()
        n = 0
        prev = self.duration
        while self.max_retries < 0 or n < self.max_retries:
            if self.policy == "exponential":
                base = min(self.duration * (2 ** n), self.max_interval)
            else:
                base = self.duration
            if self.jitter:
                decorrelated = min(self.max_interval, rng.uniform(self.duration, prev * 3))
                prev = decorrelated
                yield (1.0 - self.jitter) * base + self.jitter * decorrelated
            else:
                yield base
            n += 1


@dataclass(frozen=True)
class CircuitBreakerSpec:
    """A named circuit breaker (``spec.policies.circuitBreakers.<name>``)."""

    name: str
    #: consecutive failures that trip it (the ``trip:`` expression)
    trip_threshold: int = 5
    #: how long it stays open before it lets probes through
    timeout: float = 30.0
    #: probes allowed while half-open
    max_requests: int = 1


_TRIP_RE = re.compile(r"consecutiveFailures\s*(>=|>)\s*(\d+)")


def parse_trip(expr: str) -> int:
    """``"consecutiveFailures >= 5"`` → 5; the one form supported."""
    m = _TRIP_RE.fullmatch(expr.strip())
    if not m:
        raise ComponentError(
            f"unsupported circuit-breaker trip expression {expr!r} "
            "(expected 'consecutiveFailures >= N')")
    threshold = int(m.group(2))
    return threshold + 1 if m.group(1) == ">" else threshold


class CircuitBreaker:
    """The breaker of one (policy, target) pair, shared by every call to
    that target, so the failures one caller sees protect the rest."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
    _STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, spec: CircuitBreakerSpec, *, target: str = "") -> None:
        self.spec = spec
        self.target = target
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self._publish_state()

    def _publish_state(self) -> None:
        metrics.set_gauge("resiliency_breaker_state", self._STATE_VALUES[self.state],
                          policy=self.spec.name, target=self.target)

    def before_call(self) -> None:
        """Let a call through, or raise :class:`CircuitOpenError`."""
        if self.state == self.OPEN:
            if time.monotonic() - self._opened_at >= self.spec.timeout:
                self.state = self.HALF_OPEN
                self._half_open_inflight = 0
                self._publish_state()
                logger.info("circuit %s[%s] half-open (probing)", self.spec.name, self.target)
            else:
                raise CircuitOpenError(
                    f"circuit {self.spec.name!r} open for target {self.target!r}")
        if self.state == self.HALF_OPEN:
            if self._half_open_inflight >= self.spec.max_requests:
                raise CircuitOpenError(
                    f"circuit {self.spec.name!r} half-open, probe limit reached "
                    f"for target {self.target!r}")
            self._half_open_inflight += 1

    def record_success(self) -> None:
        if self.state != self.CLOSED:
            logger.info("circuit %s[%s] closed", self.spec.name, self.target)
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self._half_open_inflight = 0
        self._publish_state()

    def release_probe(self) -> None:
        """A half-open probe ended with no verdict (its caller was
        cancelled): free its slot, or the breaker would stay half-open."""
        if self.state == self.HALF_OPEN and self._half_open_inflight > 0:
            self._half_open_inflight -= 1

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        should_trip = (self.state == self.HALF_OPEN
                       or self.consecutive_failures >= self.spec.trip_threshold)
        if should_trip and self.state != self.OPEN:
            self.state = self.OPEN
            self._opened_at = time.monotonic()
            self._publish_state()
            logger.warning("circuit %s[%s] OPEN after %d consecutive failures",
                           self.spec.name, self.target, self.consecutive_failures)


@dataclass
class TargetPolicy:
    """The policies of one target (an app or a component)."""

    target: str
    timeout: float | None = None
    retry: RetrySpec | None = None
    breaker: CircuitBreaker | None = None
    #: "perAttempt" (each attempt gets the whole timeout) or "total" (one
    #: budget for the attempts and the backoff sleeps between them)
    timeout_policy: str = "perAttempt"
    #: False: the retries leave the ``resiliency_retry_*`` counters alone
    #: (the runtime's builtin invoke attempts, which no document declares)
    metered: bool = True

    def _count(self, name: str) -> None:
        if self.metered:
            metrics.inc(name, target=self.target)

    async def execute(self, fn: Callable[[], Awaitable], *,
                      retriable: tuple[type[BaseException], ...] = (OSError,)):
        """``fn`` under this policy. ``retriable`` exceptions and
        timeouts use up the retry budget; anything else is raised at once
        and counts as a breaker failure. A :class:`CircuitOpenError` from
        the breaker's gate is never retried."""
        delays = self.retry.delays() if self.retry else iter(())
        deadline = (time.monotonic() + self.timeout
                    if self.timeout is not None and self.timeout_policy == "total" else None)

        def _budget_error(cause: BaseException | None = None) -> TimeoutError:
            err = TimeoutError(f"call to {self.target!r} exceeded {self.timeout}s total budget")
            if cause is not None:
                err.__cause__ = cause
            return err

        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise _budget_error()
            if self.breaker is not None:
                self.breaker.before_call()
            try:
                if remaining is not None:
                    result = await asyncio.wait_for(fn(), remaining)
                elif self.timeout is not None:
                    result = await asyncio.wait_for(fn(), self.timeout)
                else:
                    result = await fn()
            except (asyncio.TimeoutError, *retriable) as exc:
                if self.breaker is not None:
                    self.breaker.record_failure()
                delay = next(delays, None)
                if delay is None:
                    self._count("resiliency_retry_exhausted_total")
                    if isinstance(exc, asyncio.TimeoutError):
                        raise TimeoutError(f"call to {self.target!r} exceeded "
                                           f"{self.timeout}s timeout") from exc
                    raise
                # a server's Retry-After stretches the delay, up to the
                # policy's cap; the total budget below still wins
                hint = getattr(exc, "retry_after", None)
                if hint:
                    delay = max(delay, float(hint))
                    if self.retry is not None:
                        delay = min(delay, self.retry.max_interval)
                if deadline is not None and time.monotonic() + delay >= deadline:
                    # sleeping through the backoff would spend the budget
                    self._count("resiliency_retry_exhausted_total")
                    raise _budget_error(exc)
                self._count("resiliency_retry_total")
                logger.warning("retrying %s in %.3fs after %r", self.target, delay, exc)
                await asyncio.sleep(delay)
                continue
            except Exception:
                if self.breaker is not None:
                    self.breaker.record_failure()
                raise
            except BaseException:
                # a cancellation says nothing of the target's health
                if self.breaker is not None:
                    self.breaker.release_probe()
                raise
            if self.breaker is not None:
                self.breaker.record_success()
            return result


@dataclass
class _TargetRef:
    timeout: str | None = None
    retry: str | None = None
    circuit_breaker: str | None = None
    timeout_policy: str = "perAttempt"


@dataclass
class _ParsedSpec:
    """One parsed Resiliency document (:mod:`.spec` reads the YAML)."""

    name: str
    scopes: list[str] = field(default_factory=list)
    timeouts: dict[str, float] = field(default_factory=dict)
    retries: dict[str, RetrySpec] = field(default_factory=dict)
    breakers: dict[str, CircuitBreakerSpec] = field(default_factory=dict)
    app_targets: dict[str, _TargetRef] = field(default_factory=dict)
    component_targets: dict[str, dict[str, _TargetRef]] = field(default_factory=dict)

    def in_scope(self, app_id: str | None) -> bool:
        if not self.scopes or app_id is None:
            return True
        return app_id in self.scopes


class ResiliencyPolicies:
    """What the runtime asks: the in-scope documents, with breakers that
    last across calls."""

    def __init__(self, specs: list[_ParsedSpec], *, app_id: str | None = None) -> None:
        self.specs = [s for s in specs if s.in_scope(app_id)]
        self._breakers: dict[tuple[str, str], CircuitBreaker] = {}
        self._cache: dict[tuple[str, str, str], TargetPolicy | None] = {}

    def for_app(self, app_id: str) -> TargetPolicy | None:
        """The policy of service invocation toward ``app_id``."""
        return self._resolve("apps", app_id, "outbound")

    def for_component(self, name: str, direction: str = "outbound") -> TargetPolicy | None:
        """The policy of operations on component ``name``."""
        return self._resolve("components", name, direction)

    def _resolve(self, kind: str, name: str, direction: str) -> TargetPolicy | None:
        cache_key = (kind, name, direction)
        if cache_key in self._cache:
            return self._cache[cache_key]
        policy = None
        for spec in self.specs:
            if kind == "apps":
                ref = spec.app_targets.get(name)
            else:
                ref = (spec.component_targets.get(name) or {}).get(direction)
            if ref is None:
                continue
            timeout = spec.timeouts.get(ref.timeout) if ref.timeout else None
            if ref.timeout and timeout is None:
                raise ComponentError(f"resiliency {spec.name!r}: unknown timeout {ref.timeout!r}")
            retry = spec.retries.get(ref.retry) if ref.retry else None
            if ref.retry and retry is None:
                raise ComponentError(f"resiliency {spec.name!r}: unknown retry {ref.retry!r}")
            breaker = None
            if ref.circuit_breaker:
                cb_spec = spec.breakers.get(ref.circuit_breaker)
                if cb_spec is None:
                    raise ComponentError(f"resiliency {spec.name!r}: unknown circuit breaker "
                                         f"{ref.circuit_breaker!r}")
                bk = (cb_spec.name, f"{kind}/{name}/{direction}")
                breaker = self._breakers.setdefault(bk, CircuitBreaker(cb_spec, target=name))
            policy = TargetPolicy(target=name, timeout=timeout, retry=retry, breaker=breaker,
                                  timeout_policy=ref.timeout_policy)
            break  # the first in-scope document naming the target wins
        self._cache[cache_key] = policy
        return policy
