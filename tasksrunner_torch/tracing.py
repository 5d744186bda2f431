"""W3C trace context for the scorer's lanes: the part of
``tasksrunner/observability/tracing.py`` the port uses, its ids from
:mod:`tasksrunner_torch.ids`.

A ``traceparent`` header (``00-<32 hex trace>-<16 hex span>-<flags>``)
arrives with a request or a delivered event; :func:`ensure_trace` adopts
it as a new child span, and :class:`trace_scope` makes that context the
ambient one for the handler, so a span recorded further down (the
batcher's ``ml-request``) lands in the caller's trace. W3C baggage
(``baggage: k=v,k2=v2``) rides the context and every outbound hop,
capped at :data:`MAX_BAGGAGE_ITEMS` items and :data:`MAX_BAGGAGE_BYTES`
bytes so the header cannot grow hop over hop.
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass, field
from urllib.parse import quote, unquote

from tasksrunner_torch.ids import hex8, hex16

TRACEPARENT_HEADER = "traceparent"
BAGGAGE_HEADER = "baggage"

#: W3C baggage caps: the item count on the way in, the serialised size
#: on the way out (entries past it are dropped, oldest insertion kept)
MAX_BAGGAGE_ITEMS = 16
MAX_BAGGAGE_BYTES = 1024


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
    #: key/values that ride the trace (the ``baggage`` header outbound)
    baggage: dict = field(default_factory=dict)

    @classmethod
    def new(cls) -> TraceContext:
        return cls(trace_id=hex16(), span_id=hex8())

    @classmethod
    def parse(cls, header: str | None, baggage: dict | None = None) -> TraceContext | None:
        """The context a ``traceparent`` header names, or None when it is
        absent or malformed."""
        if not header:
            return None
        parts = header.split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        return cls(trace_id=parts[1], span_id=parts[2], flags=parts[3],
                   baggage=baggage or {})

    def child(self) -> TraceContext:
        return TraceContext(trace_id=self.trace_id, span_id=hex8(),
                            flags=self.flags, parent_id=self.span_id,
                            baggage=self.baggage)

    @property
    def header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"


_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "tasksrunner_torch_trace", default=None)


def current_trace() -> TraceContext | None:
    return _current.get()


def current_or_new() -> TraceContext:
    """The ambient context, or a new root installed as the ambient one
    when there is none (the actor turn's and the forward hop's parent)."""
    ctx = _current.get()
    if ctx is None:
        ctx = TraceContext.new()
        _current.set(ctx)
    return ctx


def parse_baggage(header: str | None) -> dict:
    """A ``baggage`` header (``k=v,k2=v2``) as a dict: malformed items
    skipped, at most :data:`MAX_BAGGAGE_ITEMS` kept."""
    if not header:
        return {}
    out: dict = {}
    for item in header.split(","):
        key, sep, value = item.partition("=")
        key = key.strip()
        if not sep or not key:
            continue
        out[key] = unquote(value.strip())
        if len(out) >= MAX_BAGGAGE_ITEMS:
            break
    return out


def serialize_baggage(baggage: dict) -> str | None:
    """Baggage for the wire, stopping before the entry that would take
    it past :data:`MAX_BAGGAGE_BYTES`; None when nothing is left."""
    if not baggage:
        return None
    parts: list[str] = []
    size = 0
    for key, value in baggage.items():
        item = f"{key}={quote(str(value), safe='')}"
        if size + len(item) + 1 > MAX_BAGGAGE_BYTES:
            break
        parts.append(item)
        size += len(item) + 1
    return ",".join(parts) or None


def ensure_trace(incoming_header: str | None = None,
                 baggage_header: str | None = None) -> TraceContext:
    """A new child of the incoming context, or a new trace when there is
    none (or it is malformed), carrying the incoming baggage. Unlike the
    JAX function it does not install the context: :class:`trace_scope`
    does, for a block, so an in-process dispatch cannot leave the
    callee's context in the caller's task."""
    bag = parse_baggage(baggage_header)
    parent = TraceContext.parse(incoming_header, bag)
    if parent is not None:
        return parent.child()
    return TraceContext(trace_id=hex16(), span_id=hex8(), baggage=bag)


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


def hop_headers(ctx: TraceContext) -> dict[str, str]:
    """The ``traceparent`` naming ``ctx`` and, when it carries any, its
    ``baggage``: the headers of a hop whose span is ``ctx``."""
    headers = {TRACEPARENT_HEADER: ctx.header}
    bag = serialize_baggage(ctx.baggage)
    if bag:
        headers[BAGGAGE_HEADER] = bag
    return headers


def outgoing_headers() -> dict[str, str]:
    """The headers of an outbound hop: a child of the ambient context,
    or of a new trace when there is none, with its baggage."""
    return hop_headers((current_trace() or TraceContext.new()).child())
