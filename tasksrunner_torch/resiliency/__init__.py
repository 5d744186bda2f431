"""Declarative resiliency, the port of ``tasksrunner/resiliency/``:
``kind: Resiliency`` documents (timeouts, retries, circuit breakers)
bound to apps and components, applied by the runtime to service
invocation, component operations and deliveries."""

from tasksrunner_torch.resiliency.policy import (
    CircuitBreaker, ResiliencyPolicies, RetrySpec, TargetPolicy, parse_duration,
)
from tasksrunner_torch.resiliency.spec import ResiliencySpec, load_resiliency, parse_resiliency

__all__ = ["CircuitBreaker", "ResiliencyPolicies", "ResiliencySpec", "RetrySpec",
           "TargetPolicy", "load_resiliency", "parse_duration", "parse_resiliency"]
