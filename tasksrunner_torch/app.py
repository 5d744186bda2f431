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
* ``/tasksrunner/healthz`` answers 204 whatever the app registers, and
  ``/healthz`` answers 204 unless the app registers its own.
* An incoming ``traceparent`` opens a trace scope around the handler.
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
startup (the model's warm-up) runs. Each HTTP connection carries one
request and is closed after the response.
"""

from __future__ import annotations

import asyncio
import http
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from tasksrunner_torch import cloudevents, spans
from tasksrunner_torch.admission import AdmissionController
from tasksrunner_torch.client import AppClient
from tasksrunner_torch.metrics import MetricsRegistry, metrics
from tasksrunner_torch.tracing import TRACEPARENT_HEADER, ensure_trace, trace_scope

logger = logging.getLogger(__name__)

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 1024 * 1024
SUBSCRIBE_PATHS = ("/dapr/subscribe", "/tasksrunner/subscribe")


@dataclass
class Response:
    status: int = 200
    body: Any = None
    headers: dict[str, str] = field(default_factory=dict)

    def payload(self) -> bytes:
        return b"" if self.body is None else json.dumps(self.body).encode()

    def encode(self) -> bytes:
        payload = self.payload()
        phrase = http.HTTPStatus(self.status).phrase
        lines = [f"HTTP/1.1 {self.status} {phrase}",
                 f"Content-Length: {len(payload)}", "Connection: close"]
        if self.body is not None:
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
    if len(parts) != len(segments):
        return None
    params = {}
    for seg, part in zip(segments, parts):
        if seg.startswith("{") and seg.endswith("}"):
            params[seg[1:-1]] = part
        elif seg != part:
            return None
    return params


class App:
    def __init__(self, app_id: str) -> None:
        self.app_id = app_id
        self._routes: dict[tuple[str, str], Handler] = {}
        self._param_routes: list[tuple[str, list[str], Handler]] = []
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
        #: requests being dispatched (admission's in-flight signal)
        self.inflight = 0
        #: the app's own metrics, where it keeps any (the scorer: its batcher's)
        self.registry: MetricsRegistry | None = None

    # -- registration ----------------------------------------------------

    def route(self, method: str, path: str) -> Callable[[Handler], Handler]:
        def register(fn: Handler) -> Handler:
            if "{" in path:
                self._param_routes.append((method, _segments(path), fn))
            else:
                self._routes[(method, path)] = fn
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
            return self.post(route)(fn)
        return register

    def on_startup(self, fn: Callable[[], Awaitable[None]]):
        self._startup.append(fn)
        return fn

    def on_shutdown(self, fn: Callable[[], Awaitable[None]]):
        self._shutdown.append(fn)
        return fn

    # -- lifecycle -------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Listen on ``host:port`` (0 picks a free port), :meth:`begin`,
        and return the bound port."""
        self._server = await asyncio.start_server(
            self._serve_connection, host, port, limit=MAX_HEADER_BYTES)
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
        path = path.split("?", 1)[0]
        admission = self.admission
        if (admission is not None and admission.shedding and path != "/healthz"
                and not path.startswith("/tasksrunner/")):
            metrics.inc("admission_shed_total", route="app")
            return Response(429, {"error": "replica saturated; retry later"},
                            headers={"Retry-After": str(admission.retry_after_seconds())})
        self.inflight += 1
        try:
            return await self._dispatch(Request(method, path, headers or {}, body))
        finally:
            self.inflight -= 1

    def _find(self, method: str, path: str) -> tuple[Handler, dict[str, str]] | None:
        handler = self._routes.get((method, path))
        if handler is not None:
            return handler, {}
        for route_method, segments, fn in self._param_routes:
            if route_method == method:
                params = _match(segments, path)
                if params is not None:
                    return fn, params
        return None

    def _known_path(self, path: str) -> bool:
        return (any(p == path for _, p in self._routes)
                or any(_match(segments, path) is not None
                       for _, segments, _ in self._param_routes))

    async def _dispatch(self, request: Request) -> Response:
        method, path = request.method, request.path
        if method == "GET" and path in SUBSCRIBE_PATHS:
            return Response(body=self.subscriptions)
        if path == "/tasksrunner/healthz":
            return Response(204)
        found = self._find(method, path)
        if found is None:
            if path == "/healthz" and not self._known_path(path):
                return Response(204)
            return Response(405 if self._known_path(path) else 404,
                            {"error": f"no route {method} {path}"})
        handler, request.path_params = found
        traceparent = request.headers.get(TRACEPARENT_HEADER)
        try:
            if traceparent is None and not spans.active():
                return _normalize(await handler(request))
            with trace_scope(ensure_trace(traceparent)):
                return _normalize(await handler(request))
        except Exception:  # noqa: BLE001 - one request must not stop the server
            logger.exception("%s %s failed", method, path)
            return Response(500, {"error": "internal error"})

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        try:
            response = await self._read_and_handle(reader)
            writer.write(response.encode())
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away; nothing to answer
        finally:
            writer.close()

    async def _read_and_handle(self, reader: asyncio.StreamReader) -> Response:
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
        return await self.handle(parts[0], parts[1], headers, body)
