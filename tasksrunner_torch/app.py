"""The app framework of the port, on the standard library alone: the part
of ``tasksrunner/app.py`` and of its HTTP adapter
(``tasksrunner/hosting.py::build_app_server``) the scorer uses.

* Routes registered with ``@app.post`` / ``@app.get``; a path may hold
  parameters (``/scores/{task_id}`` → ``req.path_params``), and an exact
  route takes precedence over a parametrised one. Handlers return a
  :class:`Response`, a dict (200), a ``(status, body)`` tuple or a bare
  status.
* Topic subscriptions (``@app.subscribe(pubsub, topic, route)``),
  advertised at ``GET /dapr/subscribe`` and ``GET /tasksrunner/subscribe``
  for the runtime that delivers the events; ``Request.data`` is the body
  with its CloudEvents envelope removed.
* Input binding handlers (``@app.binding(name, route=None)``, the route
  ``/<name>`` by default, the cron convention): the runtime POSTs each of
  the binding's events there; ``Request.data`` is the raw JSON, since a
  binding's event has no envelope.
* ``/tasksrunner/healthz`` answers 204 whatever the app registers, and
  ``/healthz`` answers 204 unless the app registers its own.
* ``GET /tasksrunner/stats`` answers ``{"inflight", "requests_total"}``,
  what an autoscaler's ``http-concurrency`` rule polls: the probe is not
  counted as load, is never shed, and needs the ``tr-api-token`` header
  when ``TASKSRUNNER_API_TOKEN`` is set (401 without it).
* ``GET /openapi.json`` is an OpenAPI 3.1 document of the HTTP routes.
* Actor turn handlers (``@app.actor(type)``, ``async def (turn)`` with an
  :class:`~tasksrunner_torch.actors.ActorTurn`), workflows
  (``@app.workflow(name)``) and activities (``@app.activity(name, retry=,
  timeout=)``), the last two kept by a
  :class:`~tasksrunner_torch.workflows.WorkflowEngine` that hosts the
  ``_Workflow`` actor type. The owning runtime reaches them over the app
  channel: ``GET /tasksrunner/actors`` lists the hosted types, ``PUT
  /tasksrunner/actors/{type}/{id}/{method}`` runs one turn on ``{"data",
  "state", "kind", "reminder"}`` and answers ``{"state", "result"}`` with
  ``effects``, ``reminders_set`` and ``reminders_clear`` where the turn
  staged any; a turn adopts the runtime's ``traceparent`` and, with spans
  recorded, records ``ACTOR {type}/{id}.{method}`` (server).
* An incoming ``traceparent`` (and ``baggage``) opens a trace scope
  around the handler. With spans recorded, each routed request records
  one span around its handler, ``f"{METHOD} {path}"`` with the response
  status: kind ``consumer`` for a subscription's or a binding's route,
  ``server`` otherwise, as the JAX ``App`` names them.
* With an :class:`~tasksrunner_torch.admission.AdmissionController`
  (``TASKSRUNNER_ADMISSION``) that is shedding, every path but
  ``/healthz`` and ``/tasksrunner/*`` is answered 429 + ``Retry-After``
  before dispatch.
* :attr:`App.client` reaches the app's runtime: state, publish, invoke.
  It talks to a sidecar over HTTP unless a host gives the app its
  in-process client (:class:`~tasksrunner_torch.hosting.InProcHost`).

:meth:`App.handle` is the one dispatch every path goes through: the HTTP
server of :meth:`App.start`, a sidecar's deliveries over it, and an
in-process host. :meth:`App.start` listens first and runs the startup
hooks in the background, so a route can answer "not ready" while a slow
startup (the model's warm-up) runs; it also runs the loop's lag probe
(:mod:`tasksrunner_torch.probes`).

:func:`start_server` is the one HTTP/1.1 reader, which the app and the
sidecar (:mod:`tasksrunner_torch.sidecar`) both serve on: each
connection carries one request and is closed after the response.
:class:`Router` is the one route table: a path's ``{name}`` segment
matches one segment, and a last ``{name:.*}`` segment the rest of the
path (the sidecar's ``/v1.0/invoke/{app_id}/method/{path:.*}``).
"""

from __future__ import annotations

import asyncio
import contextlib
import http
import inspect
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from tasksrunner_torch import cloudevents, spans
from tasksrunner_torch.admission import AdmissionController
from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER, AppClient
from tasksrunner_torch.errors import TasksRunnerError, ValidationError
from tasksrunner_torch.metrics import MetricsRegistry, metrics
from tasksrunner_torch.probes import EventLoopLagProbe
from tasksrunner_torch.tracing import (
    BAGGAGE_HEADER, TRACEPARENT_HEADER, current_trace, ensure_trace, trace_scope,
)

logger = logging.getLogger(__name__)

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 1024 * 1024
SUBSCRIBE_PATHS = ("/dapr/subscribe", "/tasksrunner/subscribe")
STATS_PATH = "/tasksrunner/stats"
ACTORS_PATH = "/tasksrunner/actors"


@dataclass
class Response:
    """A JSON body (sent with ``Content-Type: application/json``), or
    ``bytes`` sent as they are, with whatever content type ``headers``
    gives them."""

    status: int = 200
    body: Any = None
    headers: dict[str, str] = field(default_factory=dict)

    def payload(self) -> bytes:
        if isinstance(self.body, (bytes, bytearray)):
            return bytes(self.body)
        return b"" if self.body is None else json.dumps(self.body).encode()

    def encode(self) -> bytes:
        payload = self.payload()
        try:
            phrase = http.HTTPStatus(self.status).phrase
        except ValueError:  # a status an app made up
            phrase = "Unknown"
        lines = [f"HTTP/1.1 {self.status} {phrase}",
                 f"Content-Length: {len(payload)}", "Connection: close"]
        if self.body is not None and not isinstance(self.body, (bytes, bytearray)):
            lines.append("Content-Type: application/json")
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + payload


@dataclass
class Request:
    method: str
    path: str  # without the query string
    headers: dict[str, str]  # names lowercased
    body: bytes
    path_params: dict[str, str] = field(default_factory=dict)
    query: str = ""

    def json(self) -> Any:
        """The body parsed as JSON; raises ValueError when it is not."""
        return json.loads(self.body)

    @property
    def data(self) -> Any:
        """The body with any CloudEvents envelope removed."""
        if not self.body:
            return None
        return cloudevents.unwrap(self.body, self.headers.get("content-type"))


Handler = Callable[[Request], Awaitable[Any]]


def _normalize(result: Any) -> Response:
    if isinstance(result, Response):
        return result
    if isinstance(result, int):
        return Response(status=result)
    if isinstance(result, tuple) and len(result) == 2 and isinstance(result[0], int):
        return Response(status=result[0], body=result[1])
    return Response(body=result)


def _segments(path: str) -> list[str]:
    return [part for part in path.split("/") if part]


def _match(segments: list[str], path: str) -> dict[str, str] | None:
    parts = _segments(path)
    tail = segments[-1] if segments and segments[-1].endswith(":.*}") else None
    fixed = segments[:-1] if tail else segments
    if len(parts) < len(fixed) or (tail is None and len(parts) != len(fixed)):
        return None
    params = {}
    for seg, part in zip(fixed, parts):
        if seg.startswith("{") and seg.endswith("}"):
            params[seg[1:-1]] = part
        elif seg != part:
            return None
    if tail:
        params[tail[1:-len(":.*}")]] = "/".join(parts[len(fixed):])
    return params


class _Route:
    __slots__ = ("method", "path", "handler", "kind", "segments")

    def __init__(self, method: str, path: str, handler: Handler, kind: str) -> None:
        self.method = method  # "*" for any
        self.path = path
        self.handler = handler
        #: "http", "subscription" for a topic's delivery route, "binding"
        #: for an input binding's; the sidecar's "exempt" (never shed) and
        #: "peer" (a peer's token passes)
        self.kind = kind
        self.segments = _segments(path)


class Router:
    """Routes in registration order; an exact path takes precedence
    over a parametrised one."""

    def __init__(self) -> None:
        self.table: list[_Route] = []
        self._exact: dict[tuple[str, str], _Route] = {}

    def add(self, method: str, path: str, handler: Handler, kind: str = "http") -> None:
        route = _Route(method, path, handler, kind)
        self.table.append(route)
        if "{" not in path:
            self._exact[(method, path)] = route

    def find(self, method: str, path: str) -> tuple[_Route, dict[str, str]] | None:
        route = self._exact.get((method, path)) or self._exact.get(("*", path))
        if route is not None:
            return route, {}
        for route in self.table:
            if route.method in (method, "*") and "{" in route.path:
                params = _match(route.segments, path)
                if params is not None:
                    return route, params
        return None

    def known_path(self, path: str) -> bool:
        return any(_match(route.segments, path) is not None for route in self.table)


async def _read_request(reader: asyncio.StreamReader, handle) -> Response:
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.LimitOverrunError:
        return Response(431, {"error": "request head too large"})
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3:
        return Response(400, {"error": "malformed request line"})
    headers = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if sep:
            headers[name.strip().lower()] = value.strip()
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        return Response(400, {"error": "malformed Content-Length"})
    if length < 0 or length > MAX_BODY_BYTES:
        return Response(413, {"error": f"body must be 0..{MAX_BODY_BYTES} bytes"})
    body = await reader.readexactly(length)
    return await handle(parts[0], parts[1], headers, body)


async def start_server(handle: Callable[[str, str, dict[str, str], bytes], Awaitable[Response]],
                       host: str, port: int) -> asyncio.Server:
    """Serve ``handle(method, target, headers, body)`` over HTTP/1.1 on
    ``host:port`` (0 picks a free port): one request per connection,
    header names lowercased, the target with its query string."""
    async def serve(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            response = await _read_request(reader, handle)
            writer.write(response.encode())
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away; nothing to answer
        finally:
            writer.close()

    return await asyncio.start_server(serve, host, port, limit=MAX_HEADER_BYTES)


class App:
    def __init__(self, app_id: str) -> None:
        self.app_id = app_id
        self.router = Router()
        #: the subscription document: {"pubsubname", "topic", "route"} each
        self.subscriptions: list[dict[str, str]] = []
        self._startup: list[Callable[[], Awaitable[None]]] = []
        self._shutdown: list[Callable[[], Awaitable[None]]] = []
        self._server: asyncio.Server | None = None
        self._startup_task: asyncio.Task | None = None
        #: the app's runtime client; a host replaces it with its own
        self.client = AppClient.http()
        #: set by :meth:`begin` when ``TASKSRUNNER_ADMISSION`` is on
        self.admission: AdmissionController | None = None
        #: requests being dispatched (admission's in-flight signal) and
        #: requests dispatched so far, both served at GET /tasksrunner/stats
        self.inflight = 0
        self.requests_total = 0
        #: the loop's lag probe while :meth:`start` serves the app
        self._lag_probe: EventLoopLagProbe | None = None
        #: the app's own metrics, where it keeps any (the scorer: its batcher's)
        self.registry: MetricsRegistry | None = None
        #: actor type → turn handler (``@app.actor``)
        self.actors: dict[str, Callable[[Any], Awaitable[Any]]] = {}
        #: the WorkflowEngine, once a workflow or an activity is registered
        self.workflow_engine: Any = None

    # -- registration ----------------------------------------------------

    def route(self, method: str, path: str, *, kind: str = "http") -> Callable[[Handler], Handler]:
        def register(fn: Handler) -> Handler:
            self.router.add(method, path, fn, kind)
            return fn
        return register

    def post(self, path: str) -> Callable[[Handler], Handler]:
        return self.route("POST", path)

    def get(self, path: str) -> Callable[[Handler], Handler]:
        return self.route("GET", path)

    def subscribe(self, pubsub: str, topic: str, route: str) -> Callable[[Handler], Handler]:
        """Deliveries of ``topic`` on ``pubsub`` come to ``POST route``."""
        def register(fn: Handler) -> Handler:
            self.subscriptions.append({"pubsubname": pubsub, "topic": topic, "route": route})
            return self.route("POST", route, kind="subscription")(fn)
        return register

    def binding(self, name: str, route: str | None = None) -> Callable[[Handler], Handler]:
        """The events of input binding ``name`` come to ``POST route``
        (``/<name>`` by default)."""
        route = route or f"/{name}"
        return self.route("POST", route, kind="binding")

    def actor(self, actor_type: str) -> Callable:
        """The turn handler of one actor type: an ``async def (turn)`` that
        never runs two turns of one actor id at once, cluster-wide."""
        def register(handler):
            if not inspect.iscoroutinefunction(handler):
                raise ValidationError(
                    f"actor turn handlers must be 'async def' ({actor_type}: "
                    f"{getattr(handler, '__name__', handler)!r} is synchronous)")
            if actor_type in self.actors:
                raise ValidationError(f"actor type {actor_type!r} is already registered")
            self.actors[actor_type] = handler
            return handler
        return register

    def _workflow_engine(self):
        """The workflow engine, made on first use; it hosts ``_Workflow``."""
        if self.workflow_engine is None:
            from tasksrunner_torch.workflows import WORKFLOW_ACTOR_TYPE, WorkflowEngine
            self.workflow_engine = WorkflowEngine(self)
            self.actors[WORKFLOW_ACTOR_TYPE] = self.workflow_engine.handle_turn
        return self.workflow_engine

    def workflow(self, name: str) -> Callable:
        """A deterministic orchestrator, ``async def (ctx, input)``, that
        sees the world only through ``ctx`` (it is replayed)."""
        def register(handler):
            if not inspect.iscoroutinefunction(handler):
                raise ValidationError(
                    f"workflow orchestrators must be 'async def' ({name}: "
                    f"{getattr(handler, '__name__', handler)!r} is synchronous)")
            self._workflow_engine().register_workflow(name, handler)
            return handler
        return register

    def activity(self, name: str, *, retry=None, timeout: float | None = None) -> Callable:
        """An activity, ``async def (actx, input)``: a workflow's effectful
        step, retried under ``retry`` (a
        :class:`~tasksrunner_torch.resiliency.RetrySpec`; a bounded
        exponential policy by default), each attempt within ``timeout``."""
        def register(handler):
            if not inspect.iscoroutinefunction(handler):
                raise ValidationError(
                    f"workflow activities must be 'async def' ({name}: "
                    f"{getattr(handler, '__name__', handler)!r} is synchronous)")
            self._workflow_engine().register_activity(name, handler, retry=retry,
                                                      timeout=timeout)
            return handler
        return register

    def on_startup(self, fn: Callable[[], Awaitable[None]]):
        self._startup.append(fn)
        return fn

    def on_shutdown(self, fn: Callable[[], Awaitable[None]]):
        self._shutdown.append(fn)
        return fn

    # -- lifecycle -------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Listen on ``host:port`` (0 picks a free port), start the loop's
        lag probe, :meth:`begin`, and return the bound port."""
        self._server = await start_server(self.handle, host, port)
        self._lag_probe = EventLoopLagProbe()
        self._lag_probe.start()
        self.begin()
        return self._server.sockets[0].getsockname()[1]

    def begin(self) -> None:
        """Start the span recorder when ``TASKSRUNNER_TRACE_DB`` names a
        file, the admission sampler when ``TASKSRUNNER_ADMISSION`` is on,
        and the startup hooks in the background."""
        if not spans.active():
            spans.configure_spans(self.app_id)
        if self.admission is None:
            self.admission = AdmissionController.from_env(inflight=lambda: self.inflight)
        if self.admission is not None:
            self.admission.start()
        self._startup_task = asyncio.get_running_loop().create_task(
            self._run_startup())

    async def _run_startup(self) -> None:
        for hook in self._startup:
            await hook()

    async def wait_ready(self) -> None:
        """Wait for the startup hooks; raises what they raised."""
        if self._startup_task is None:
            raise RuntimeError("App.wait_ready before start()")
        await asyncio.shield(self._startup_task)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._lag_probe is not None:
            await self._lag_probe.stop()
            self._lag_probe = None
        if self._startup_task is not None:
            self._startup_task.cancel()
            try:
                await self._startup_task
            except asyncio.CancelledError:
                pass
            except Exception:  # noqa: BLE001 - already reported by wait_ready
                logger.exception("startup of %s failed", self.app_id)
            self._startup_task = None
        if self.admission is not None:
            await self.admission.stop()
        for hook in self._shutdown:
            await hook()
        if spans.recorder() is not None:
            spans.recorder().flush()

    # -- requests --------------------------------------------------------

    async def handle(self, method: str, path: str, headers: dict[str, str] | None = None,
                     body: bytes = b"") -> Response:
        """Dispatch one request: the front door of every path. Header
        names must be lowercase."""
        path, _, query = path.partition("?")
        headers = headers or {}
        if method == "GET" and path == STATS_PATH:
            # the scaler's probe: not load, never shed, behind the token
            required = os.environ.get(TOKEN_ENV)
            if required and headers.get(TOKEN_HEADER) != required:
                return Response(401, {"error": "missing or bad api token"})
            return Response(body={"inflight": self.inflight,
                                  "requests_total": self.requests_total})
        admission = self.admission
        if (admission is not None and admission.shedding and path != "/healthz"
                and not path.startswith("/tasksrunner/")):
            metrics.inc("admission_shed_total", route="app")
            return Response(429, {"error": "replica saturated; retry later"},
                            headers={"Retry-After": str(admission.retry_after_seconds())})
        self.inflight += 1
        self.requests_total += 1
        try:
            return await self._dispatch(Request(method, path, headers, body, query=query))
        finally:
            self.inflight -= 1

    def openapi(self) -> dict:
        """An OpenAPI 3.1 document of the HTTP routes (subscription routes
        left out), as the JAX ``App.openapi`` builds it."""
        paths: dict[str, dict] = {}
        for route in self.router.table:
            if route.kind != "http":
                continue
            entry = paths.setdefault("/" + "/".join(route.segments), {})
            op: dict = {"operationId": f"{route.method.lower()}_{route.handler.__name__}",
                        "responses": {"200": {"description": "success"}}}
            if route.handler.__doc__:
                op["description"] = route.handler.__doc__.strip()
            params = [{"name": seg[1:-1], "in": "path", "required": True,
                       "schema": {"type": "string"}}
                      for seg in route.segments if seg.startswith("{") and seg.endswith("}")]
            if params:
                op["parameters"] = params
            entry[route.method.lower()] = op
        return {"openapi": "3.1.0", "info": {"title": self.app_id, "version": "1.0.0"},
                "paths": dict(sorted(paths.items()))}

    async def _dispatch(self, request: Request) -> Response:
        method, path = request.method, request.path
        if method == "GET" and path in SUBSCRIBE_PATHS:
            return Response(body=self.subscriptions)
        if path == "/tasksrunner/healthz":
            return Response(204)
        if method == "GET" and path == "/openapi.json":
            return Response(body=self.openapi())
        if path.startswith(ACTORS_PATH):
            return await self._handle_actor(request)
        found = self.router.find(method, path)
        if found is None:
            known = self.router.known_path(path)
            if path == "/healthz" and not known:
                return Response(204)
            return Response(405 if known else 404, {"error": f"no route {method} {path}"})
        route, request.path_params = found
        traceparent = request.headers.get(TRACEPARENT_HEADER)
        baggage = request.headers.get(BAGGAGE_HEADER)
        recording = spans.active()
        if traceparent is None and baggage is None and not recording:
            return await self._call(route, request)
        ctx = ensure_trace(traceparent, baggage)
        # the span closes inside the callee's scope: its context never
        # reaches the caller's task
        with trace_scope(ctx):
            started = time.time()
            response = await self._call(route, request)
            if recording:
                spans.record_span(
                    kind="consumer" if route.kind in ("subscription", "binding") else "server",
                    name=f"{method} {path}", status=response.status, start=started,
                    duration=time.time() - started, trace_id=ctx.trace_id,
                    span_id=ctx.span_id, parent_id=ctx.parent_id)
            return response

    async def _handle_actor(self, request: Request) -> Response:
        """The runtime's actor channel. Only the owning replica's runtime
        sends a turn, with the turn's lock held there."""
        from tasksrunner_torch.actors.turn import ActorTurn

        method, path = request.method, request.path
        if method == "GET" and path == ACTORS_PATH:
            return Response(body=sorted(self.actors))
        parts = _segments(path)  # ["tasksrunner", "actors", type, id, method]
        if method != "PUT" or len(parts) != 5:
            return Response(404, {"error": f"no actor route for {method} {path}"})
        actor_type, actor_id, turn_method = parts[2], parts[3], parts[4]
        handler = self.actors.get(actor_type)
        if handler is None:
            return Response(404, {"error": f"app {self.app_id!r} hosts no actor type "
                                           f"{actor_type!r}"})
        doc = json.loads(request.body) if request.body else {}
        turn = ActorTurn(actor_type=actor_type, actor_id=actor_id, method=turn_method,
                         data=doc.get("data"), state=doc.get("state") or {},
                         kind=doc.get("kind") or "turn", reminder=doc.get("reminder"))
        traceparent = request.headers.get(TRACEPARENT_HEADER)
        ctx = (ensure_trace(traceparent, request.headers.get(BAGGAGE_HEADER))
               if traceparent else current_trace())
        started = time.time()
        with trace_scope(ctx) if ctx is not None else contextlib.nullcontext():
            try:
                result = await handler(turn)
                out = {"state": turn.state, "result": result}
                # staged changes ride the answer only when used
                if turn.effects:
                    out["effects"] = turn.effects
                if turn.reminder_sets:
                    out["reminders_set"] = turn.reminder_sets
                if turn.reminder_clears:
                    out["reminders_clear"] = turn.reminder_clears
                response = Response(body=out)
            except TasksRunnerError as exc:
                response = Response(exc.http_status, {"error": str(exc)})
            except Exception:  # noqa: BLE001 - one turn must not stop the server
                logger.exception("actor turn %s/%s.%s failed", actor_type, actor_id,
                                 turn_method)
                response = Response(500, {"error": "internal error"})
        if ctx is not None and spans.active():
            spans.record_span(kind="server", name=f"ACTOR {actor_type}/{actor_id}.{turn_method}",
                              status=response.status, start=started,
                              duration=time.time() - started, trace_id=ctx.trace_id,
                              span_id=ctx.span_id, parent_id=ctx.parent_id)
        return response

    async def _call(self, route: _Route, request: Request) -> Response:
        try:
            return _normalize(await route.handler(request))
        except Exception:  # noqa: BLE001 - one request must not stop the server
            logger.exception("%s %s failed", request.method, request.path)
            return Response(500, {"error": "internal error"})
