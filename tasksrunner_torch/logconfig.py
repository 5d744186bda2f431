"""Log lines tagged with the service's role and the request's trace: the
port of ``tasksrunner/observability/logging.py`` (named ``logconfig`` so
that nothing reads it as the standard library's ``logging``).

Every record carries ``role=<app-id>`` and ``trace=<the first 16 hex
digits of the ambient trace, or ->``, so the orchestrator's merged
output can be searched by service and by request.
"""

from __future__ import annotations

import logging
import sys

from tasksrunner_torch.tracing import current_trace


class _RoleTraceFilter(logging.Filter):
    def __init__(self, role: str) -> None:
        super().__init__()
        self.role = role

    def filter(self, record: logging.LogRecord) -> bool:
        record.role = self.role
        ctx = current_trace()
        record.trace = ctx.trace_id[:16] if ctx else "-"
        return True


FORMAT = "%(asctime)s %(levelname)-7s role=%(role)s trace=%(trace)s %(name)s :: %(message)s"


def configure_logging(role: str, *, level: int = logging.INFO) -> logging.Logger:
    """The root logger of one service process: its handlers replaced by
    one that writes :data:`FORMAT` to standard error."""
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(FORMAT))
    handler.addFilter(_RoleTraceFilter(role))
    root.addHandler(handler)
    return root


def service_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
