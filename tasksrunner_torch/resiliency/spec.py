"""``kind: Resiliency`` documents: the port of
``tasksrunner/resiliency/spec.py``, read with the port's
:mod:`~tasksrunner_torch.component.blockyaml` instead of PyYAML.

The document is Dapr's (1.14)::

    apiVersion: dapr.io/v1alpha1
    kind: Resiliency
    metadata:
      name: tasks-resiliency
    scopes: [some-api]                  # optional
    spec:
      policies:
        timeouts:
          fast: 500ms
        retries:
          important: {policy: exponential, duration: 200ms, maxInterval: 5s, maxRetries: 3}
        circuitBreakers:
          simpleCB: {maxRequests: 1, timeout: 30s, trip: consecutiveFailures >= 5}
      targets:
        apps:
          priority-scorer: {timeout: fast, retry: important, circuitBreaker: simpleCB}
        components:
          scores:
            outbound: {retry: important}

The files live in the resources directory beside the components; the
component loader skips them and :func:`load_resiliency` collects them.
A target that names a policy the document lacks is refused when the
document is read.
"""

from __future__ import annotations

import pathlib
from typing import Any, Mapping

from tasksrunner_torch.component import blockyaml
from tasksrunner_torch.errors import ComponentError
from tasksrunner_torch.resiliency.policy import (
    CircuitBreakerSpec, RetrySpec, _ParsedSpec, _TargetRef, parse_duration, parse_trip,
)

ResiliencySpec = _ParsedSpec

_YAML_SUFFIXES = {".yaml", ".yml"}


def is_resiliency_doc(doc: Any) -> bool:
    return isinstance(doc, Mapping) and doc.get("kind") == "Resiliency"


def _parse_target_ref(raw: Mapping[str, Any], *, where: str) -> _TargetRef:
    if not isinstance(raw, Mapping):
        raise ComponentError(f"{where}: target must be a mapping")
    timeout_policy = str(raw.get("timeoutPolicy", "perAttempt"))
    if timeout_policy not in ("perAttempt", "total"):
        raise ComponentError(f"{where}: timeoutPolicy must be 'perAttempt' or 'total', "
                             f"not {timeout_policy!r}")
    return _TargetRef(timeout=raw.get("timeout"), retry=raw.get("retry"),
                      circuit_breaker=raw.get("circuitBreaker"),
                      timeout_policy=timeout_policy)


def parse_resiliency(doc: Mapping[str, Any], *, source: str | None = None) -> ResiliencySpec:
    where = source or "resiliency"
    if not is_resiliency_doc(doc):
        raise ComponentError(f"{where}: not a Resiliency document")
    meta = doc.get("metadata") or {}
    name = str(meta.get("name") or "resiliency")
    spec = doc.get("spec") or {}
    policies = spec.get("policies") or {}

    timeouts = {str(k): parse_duration(v) for k, v in (policies.get("timeouts") or {}).items()}

    retries: dict[str, RetrySpec] = {}
    for rname, raw in (policies.get("retries") or {}).items():
        if not isinstance(raw, Mapping):
            raise ComponentError(f"{where}: retry {rname!r} must be a mapping")
        jitter = float(raw.get("jitter", 0.0))
        if not 0.0 <= jitter <= 1.0:
            raise ComponentError(f"{where}: retry {rname!r}: jitter must be in [0, 1]")
        retries[str(rname)] = RetrySpec(
            policy=str(raw.get("policy", "constant")),
            duration=parse_duration(raw.get("duration", "5s")),
            max_interval=parse_duration(raw.get("maxInterval", "60s")),
            max_retries=int(raw.get("maxRetries", -1)),
            jitter=jitter)

    breakers: dict[str, CircuitBreakerSpec] = {}
    for bname, raw in (policies.get("circuitBreakers") or {}).items():
        if not isinstance(raw, Mapping):
            raise ComponentError(f"{where}: circuitBreaker {bname!r} must be a mapping")
        breakers[str(bname)] = CircuitBreakerSpec(
            name=str(bname),
            trip_threshold=parse_trip(str(raw.get("trip", "consecutiveFailures >= 5"))),
            timeout=parse_duration(raw.get("timeout", "30s")),
            max_requests=int(raw.get("maxRequests", 1)))

    targets = spec.get("targets") or {}
    app_targets = {str(app): _parse_target_ref(raw, where=where)
                   for app, raw in (targets.get("apps") or {}).items()}
    component_targets: dict[str, dict[str, _TargetRef]] = {}
    for comp, raw in (targets.get("components") or {}).items():
        if not isinstance(raw, Mapping):
            raise ComponentError(f"{where}: component target {comp!r} must be a mapping")
        directions: dict[str, _TargetRef] = {}
        for direction in ("outbound", "inbound"):
            if direction in raw:
                directions[direction] = _parse_target_ref(raw[direction], where=where)
        if not directions:  # a bare ref is outbound
            directions["outbound"] = _parse_target_ref(raw, where=where)
        component_targets[str(comp)] = directions

    scopes = doc.get("scopes") or []
    if not isinstance(scopes, list) or not all(isinstance(s, str) for s in scopes):
        raise ComponentError(f"{where}: scopes must be a list of app-ids")

    # a dangling reference fails the host's start, not a request months later
    all_refs = list(app_targets.items()) + [
        (comp, ref) for comp, dirs in component_targets.items() for ref in dirs.values()]
    for target, ref in all_refs:
        if ref.timeout and ref.timeout not in timeouts:
            raise ComponentError(
                f"{where}: target {target!r} references unknown timeout {ref.timeout!r}")
        if ref.retry and ref.retry not in retries:
            raise ComponentError(
                f"{where}: target {target!r} references unknown retry {ref.retry!r}")
        if ref.circuit_breaker and ref.circuit_breaker not in breakers:
            raise ComponentError(f"{where}: target {target!r} references unknown circuit "
                                 f"breaker {ref.circuit_breaker!r}")

    return ResiliencySpec(name=name, scopes=list(scopes), timeouts=timeouts, retries=retries,
                          breakers=breakers, app_targets=app_targets,
                          component_targets=component_targets)


def load_resiliency(resources_path: str | pathlib.Path) -> list[ResiliencySpec]:
    """Every ``kind: Resiliency`` document under ``resources_path``."""
    root = pathlib.Path(resources_path)
    if not root.is_dir():
        return []
    specs: list[ResiliencySpec] = []
    for path in sorted(root.iterdir()):
        if path.suffix.lower() not in _YAML_SUFFIXES or not path.is_file():
            continue
        try:
            docs = blockyaml.load_all(path.read_text(), str(path))
        except (OSError, ComponentError) as exc:
            raise ComponentError(f"cannot read {path}: {exc}") from exc
        for doc in docs:
            if is_resiliency_doc(doc):
                specs.append(parse_resiliency(doc, source=str(path)))
    return specs
