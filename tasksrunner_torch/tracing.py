"""W3C trace context for the scorer's lanes: the part of
``tasksrunner/observability/tracing.py`` and ``tasksrunner/ids.py`` the
port uses.

A ``traceparent`` header (``00-<32 hex trace>-<16 hex span>-<flags>``)
arrives with a request or a delivered event; :func:`ensure_trace` adopts
it as a new child span, and :class:`trace_scope` makes that context the
ambient one for the handler, so a span recorded further down (the
batcher's ``ml-request``) lands in the caller's trace. W3C baggage is
not ported: no lane of the scorer reads it.
"""

from __future__ import annotations

import contextvars
import secrets
from dataclasses import dataclass

TRACEPARENT_HEADER = "traceparent"


def hex8() -> str:
    """16 hex chars (64 random bits): span-id sized."""
    return secrets.token_hex(8)


def hex16() -> str:
    """32 hex chars (128 random bits): trace-id and message-id sized."""
    return secrets.token_hex(16)


@dataclass(slots=True, eq=False)
class TraceContext:
    """One span's identity. Treat as immutable: contexts are shared
    between tasks and threads."""

    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars
    flags: str = "01"
    #: the span this one descends from: the wire parent after
    #: :func:`ensure_trace`, the local parent after :meth:`child`
    parent_id: str | None = None

    @classmethod
    def new(cls) -> TraceContext:
        return cls(trace_id=hex16(), span_id=hex8())

    @classmethod
    def parse(cls, header: str | None) -> TraceContext | None:
        """The context a ``traceparent`` header names, or None when it is
        absent or malformed."""
        if not header:
            return None
        parts = header.split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        return cls(trace_id=parts[1], span_id=parts[2], flags=parts[3])

    def child(self) -> TraceContext:
        return TraceContext(trace_id=self.trace_id, span_id=hex8(),
                            flags=self.flags, parent_id=self.span_id)

    @property
    def header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"


_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "tasksrunner_torch_trace", default=None)


def current_trace() -> TraceContext | None:
    return _current.get()


def ensure_trace(incoming_header: str | None = None) -> TraceContext:
    """A new child of the incoming context, or a new trace when there is
    none (or it is malformed). Unlike the JAX function it does not
    install the context: :class:`trace_scope` does, for a block, so an
    in-process dispatch cannot leave the callee's context in the
    caller's task."""
    parent = TraceContext.parse(incoming_header)
    return parent.child() if parent is not None else TraceContext.new()


class trace_scope:
    """Install ``ctx`` as the ambient trace for the with-block."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: TraceContext) -> None:
        self._ctx = ctx

    def __enter__(self) -> TraceContext:
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        _current.reset(self._token)


def outgoing_headers() -> dict[str, str]:
    """The ``traceparent`` for an outbound hop: a child of the ambient
    context, or of a new trace when there is none."""
    ctx = current_trace() or TraceContext.new()
    return {TRACEPARENT_HEADER: ctx.child().header}
