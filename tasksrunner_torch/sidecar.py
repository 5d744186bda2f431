"""The sidecar: Dapr-shaped HTTP routes over a
:class:`~tasksrunner_torch.runtime.Runtime`, the port of
``tasksrunner/sidecar.py`` on the port's own HTTP server
(:func:`~tasksrunner_torch.app.start_server`).

* ``POST /v1.0/state/{store}`` (a list of ``{key, value, etag?}``, 204),
  ``GET /v1.0/state/{store}/{key}`` (the value with an ``etag`` header,
  or 204 and no body for a missing key), ``DELETE
  /v1.0/state/{store}/{key}`` (``If-Match`` as the etag, 204),
  ``POST /v1.0/state/{store}/bulk`` (``{"keys": [...]}``) and
  ``POST /v1.0/state/{store}/transaction`` (``{"operations": [...]}``);
* ``POST /v1.0/state/{store}/query`` (the dialect of
  :mod:`tasksrunner_torch.state.query`), answering ``{"results": [{key,
  data, etag}], "token"}``, after the app's ``read`` grant; a malformed
  query is a 400;
* ``POST /v1.0/bindings/{name}`` (``{"operation": "create", "data",
  "metadata"}``), answering ``{"data", "metadata"}`` (bytes as UTF-8
  text), after the app's ``invoke`` grant on the binding; a body that
  is not a JSON object is a 400 (the JAX route answers 500);
* ``POST /v1.0/publish/{pubsub}/{topic}`` (``?metadata.rawPayload=true``
  publishes the body unwrapped), answering ``{"messageId"}``;
* ``GET /v1.0/secrets/{store}/{key}`` (``{key: value}``) and ``GET
  /v1.0/secrets/{store}/bulk`` (every key of the store), after the app's
  ``read`` grant on the store;
* any method on ``/v1.0/invoke/{app_id}/method/{path}``: the caller's
  ``content-type``, ``accept`` and ``x-*`` headers go to the target, its
  reply comes back less the hop-by-hop headers;
* ``GET /v1.0/traces/{trace_id}``: this process's spans of the trace
  (``{"spans": [...]}`` from its span file, the recorder's buffer flushed
  first; ``{"spans": []}`` without a file), what the orchestrator's
  ``/admin/traces/{id}`` gathers from every replica;
* a state route's ``x-tasksrunner-placement-epoch`` header, the routing
  epoch a caller used, is checked against a sharded store's placement
  epoch before the operation: another epoch is a 409 whose header of the
  same name carries the live one (a bad number is a 400);
* with ``TASKSRUNNER_ACTORS`` or ``TASKSRUNNER_WORKFLOWS`` on (workflow
  turns are forwarded to their owner through these): any method on
  ``/v1.0/actors/{type}/{id}/method/{m}`` (``{"result"}``; a peer's
  forward carries ``x-tasksrunner-actor-forward: 1`` and is never
  forwarded again), ``POST`` (``{"dueSeconds", "periodSeconds"?,
  "data"?}``, 204) and ``DELETE`` (204) of
  ``/v1.0/actors/{type}/{id}/reminders/{name}``, ``GET
  /v1.0/actors/{type}/{id}/state`` (the record) and ``GET /v1.0/actors``
  (``{"replica": summary, "placement": [rows]}``);
* with ``TASKSRUNNER_WORKFLOWS`` on, the Dapr-shaped workflow routes
  (``{component}`` is accepted and ignored): ``POST
  /v1.0/workflows/{component}/{name}/start[?instanceID=]``
  (``{"instanceID"}``), ``GET /v1.0/workflows/{component}/{instance}``
  (its status) and ``.../history``, ``POST .../terminate``
  (``{"reason"}``, 202), ``POST .../raiseEvent/{event}[?eventID=]`` (202)
  and ``GET /v1.0/workflows`` (``{"instances": [...]}``); with both flags
  off none of these routes exists;
* ``GET /v1.0/healthz`` (204), ``GET /v1.0/metadata`` (``placement``: each
  sharded store's epoch, assignment and heat) and ``GET
  /metrics``: the process-wide registry as Prometheus text 0.0.4
  (``text/plain; version=0.0.4; charset=utf-8``), its token checked
  here so the scrape is not timed into its own histogram.

Every route but ``/v1.0/healthz`` needs the ``tr-api-token`` header when
``TASKSRUNNER_API_TOKEN`` is set (401); on the invoke route a peer app's
own token also passes, when its digest is in the token map of
``TASKSRUNNER_TOKENS_FILE`` (the orchestrator's ``per_app_tokens``), so
another app's identity opens this app's methods and nothing else. A
route is shed with 429 + ``Retry-After``
while the admission controller sheds (``/v1.0/metadata`` and
``/v1.0/traces`` never are), runs in the trace scope of the incoming
``traceparent`` (a new trace without one), is timed into
``sidecar_request_latency_seconds{route}`` and noted in the flight
recorder's ring (:mod:`tasksrunner_torch.flightrec`, started with the
sidecar, marked clean when it stops). An error is answered with
``{"error": message}`` and the status its class maps to; malformed JSON
is a 400.

A standalone sidecar runs the loop's lag probe and, with
``TASKSRUNNER_ADMISSION`` on, its own admission controller. Beside an
app in one process (:class:`~tasksrunner_torch.hosting.AppHost`) it
shares the app's: the app runs the probe and the controller.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from urllib.parse import parse_qs, unquote

from tasksrunner_torch import flightrec, spans
from tasksrunner_torch.admission import AdmissionController
from tasksrunner_torch.app import App, Request, Response, Router, start_server
from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER
from tasksrunner_torch.envflag import env_flag
from tasksrunner_torch.errors import (
    PlacementEpochError, TasksRunnerError, ValidationError, WorkflowError,
)
from tasksrunner_torch.invoke.headers import inward_headers, outward_headers
from tasksrunner_torch.metrics import metrics, render_prometheus
from tasksrunner_torch.probes import EventLoopLagProbe
from tasksrunner_torch.runtime import Runtime
from tasksrunner_torch.security import hash_token, load_token_map
from tasksrunner_torch.state.placement import PLACEMENT_EPOCH_HEADER
from tasksrunner_torch.tracing import BAGGAGE_HEADER, TRACEPARENT_HEADER, ensure_trace, trace_scope

logger = logging.getLogger(__name__)


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def json_error(exc: Exception) -> Response:
    """The answer to a route's error: malformed JSON 400, a runtime
    error its class's status, anything else 500. A stale routing epoch's
    409 carries the live epoch, so the caller refreshes from the refusal."""
    if isinstance(exc, json.JSONDecodeError):
        return Response(400, {"error": f"malformed JSON body: {exc}"})
    if not isinstance(exc, TasksRunnerError):
        logger.exception("unhandled sidecar error")
    status = exc.http_status if isinstance(exc, TasksRunnerError) else 500
    headers = ({PLACEMENT_EPOCH_HEADER: str(exc.current_epoch)}
               if isinstance(exc, PlacementEpochError) else {})
    return Response(status, {"error": str(exc) or type(exc).__name__}, headers=headers)


def _json_reply(value, headers: dict[str, str] | None = None) -> Response:
    # the value as JSON text, null included
    return Response(200, json.dumps(value).encode(),
                    headers={"Content-Type": "application/json", **(headers or {})})


class Sidecar:
    """The routes of one runtime on ``host:port`` (0 picks a free port,
    :attr:`port` holds the bound one after :meth:`start`)."""

    def __init__(self, runtime: Runtime, *, host: str = "127.0.0.1", port: int = 3500,
                 app: App | None = None, peer_tokens: set[str] | None = None) -> None:
        self.runtime = runtime
        #: digests of the peer apps' tokens the invoke route accepts
        self.peer_tokens = (set(load_token_map().values()) if peer_tokens is None
                            else peer_tokens)
        self.host = host
        self.port = port
        self._app = app
        self.admission: AdmissionController | None = None
        self._lag_probe: EventLoopLagProbe | None = None
        self._server: asyncio.Server | None = None
        self.router = Router()
        self._routes()

    # -- the front door --------------------------------------------------

    async def handle(self, method: str, target: str, headers: dict[str, str],
                     body: bytes) -> Response:
        """Dispatch one request (header names lowercase)."""
        path, _, query = target.partition("?")
        if method == "GET" and path == "/v1.0/healthz":
            return Response(204)
        if method == "GET" and path == "/metrics":
            required = os.environ.get(TOKEN_ENV)
            if required and headers.get(TOKEN_HEADER) != required:
                return Response(401, {"error": "missing or bad api token"})
            return Response(200, render_prometheus(metrics).encode(),
                            headers={"Content-Type": PROMETHEUS_CONTENT_TYPE})
        found = self.router.find(method, path)
        if found is None:
            return Response(405 if self.router.known_path(path) else 404,
                            {"error": f"no route {method} {path}"})
        route, params = found
        request = Request(method, path, headers, body, query=query,
                          path_params={k: v if k == "path" else unquote(v)
                                       for k, v in params.items()})
        label = route.handler.__name__
        required = os.environ.get(TOKEN_ENV)
        supplied = headers.get(TOKEN_HEADER)
        if required and supplied != required and not (
                route.kind == "peer" and supplied is not None
                and hash_token(supplied) in self.peer_tokens):
            return Response(401, {"error": "missing or bad api token"})
        # after the token check: saturation is not for anonymous eyes
        admission = self.admission
        if admission is not None and admission.shedding and route.kind != "exempt":
            metrics.inc("admission_shed_total", route=label)
            return Response(429, {"error": "replica saturated; retry later"},
                            headers={"Retry-After": str(admission.retry_after_seconds())})
        ctx = ensure_trace(headers.get(TRACEPARENT_HEADER), headers.get(BAGGAGE_HEADER))
        started = time.perf_counter()
        status = 500
        with trace_scope(ctx):
            try:
                response = await route.handler(request)
                status = response.status
                return response
            except Exception as exc:  # noqa: BLE001 - mapped to a status
                response = json_error(exc)
                status = response.status
                return response
            finally:
                elapsed = time.perf_counter() - started
                metrics.observe("sidecar_request_latency_seconds", elapsed, route=label)
                # the black box's skeleton: one if and one deque append
                flightrec.note_request(name=label, trace_id=ctx.trace_id, status=status,
                                       duration=elapsed)

    # -- the routes ------------------------------------------------------

    def _routes(self) -> None:
        runtime, add = self.runtime, self.router.add

        def check_placement(req: Request) -> None:
            # a routing-aware caller names the epoch it routed by: another
            # epoch is a 409 before any shard is touched
            raw = req.headers.get(PLACEMENT_EPOCH_HEADER)
            if raw is None:
                return
            try:
                epoch = int(raw)
            except ValueError:
                raise ValidationError(f"bad {PLACEMENT_EPOCH_HEADER} header: {raw!r}") from None
            runtime.check_placement_epoch(req.path_params["store"], epoch)

        async def save_state(req: Request) -> Response:
            items = json.loads(req.body)
            if not isinstance(items, list):
                raise ValidationError("state save body must be a list of {key, value}")
            check_placement(req)
            await runtime.save_state(req.path_params["store"], items)
            return Response(204)

        async def get_state(req: Request) -> Response:
            check_placement(req)
            item = await runtime.get_state(req.path_params["store"], req.path_params["key"])
            if item is None:
                return Response(204)
            return _json_reply(item.value, {"etag": item.etag})

        async def delete_state(req: Request) -> Response:
            check_placement(req)
            await runtime.delete_state(req.path_params["store"], req.path_params["key"],
                                       etag=req.headers.get("if-match"))
            return Response(204)

        async def bulk_get_state(req: Request) -> Response:
            body = json.loads(req.body)
            keys = body.get("keys") if isinstance(body, dict) else body
            if not isinstance(keys, list):
                raise ValidationError('bulk get body must be {"keys": [...]}')
            check_placement(req)
            return _json_reply(await runtime.bulk_get_state(req.path_params["store"], keys))

        async def transact_state(req: Request) -> Response:
            body = json.loads(req.body)
            if not isinstance(body, dict):
                raise ValidationError('transaction body must be {"operations": [...]}')
            check_placement(req)
            await runtime.transact_state(req.path_params["store"], body.get("operations", []))
            return Response(204)

        async def query_state(req: Request) -> Response:
            body = json.loads(req.body)
            check_placement(req)
            return _json_reply(await runtime.query_state(req.path_params["store"], body))

        async def invoke_binding(req: Request) -> Response:
            body = json.loads(req.body)
            if not isinstance(body, dict):
                raise ValidationError('binding body must be {"operation", "data", "metadata"}')
            resp = await runtime.invoke_output_binding(
                req.path_params["name"], body.get("operation", "create"), body.get("data"),
                body.get("metadata") or {})
            data = resp.data
            if isinstance(data, (bytes, bytearray)):
                data = data.decode("utf-8", "replace")
            return _json_reply({"data": data, "metadata": resp.metadata})

        async def publish(req: Request) -> Response:
            data = json.loads(req.body) if req.body else None
            raw = parse_qs(req.query).get("metadata.rawPayload") == ["true"]
            msg_id = await runtime.publish(req.path_params["pubsub"], req.path_params["topic"],
                                           data, raw=raw)
            return _json_reply({"messageId": msg_id})

        async def bulk_secrets(req: Request) -> Response:
            return _json_reply(runtime.bulk_secrets(req.path_params["store"]))

        async def get_secret(req: Request) -> Response:
            return _json_reply(runtime.get_secret(req.path_params["store"],
                                                  req.path_params["key"]))

        async def invoke(req: Request) -> Response:
            status, headers, body = await runtime.invoke(
                req.path_params["app_id"], req.path_params["path"], http_method=req.method,
                query=req.query, headers=inward_headers(req.headers), body=req.body)
            return Response(status, body, headers=outward_headers(headers))

        async def metadata(req: Request) -> Response:
            return _json_reply(runtime.metadata())

        async def get_trace(req: Request) -> Response:
            rec = spans.recorder()
            path = rec.path if rec is not None else os.environ.get(spans.ENV_VAR)
            if not path or not os.path.exists(path):
                return _json_reply({"spans": []})
            if rec is not None:
                await asyncio.to_thread(rec.flush)  # the buffered tail too
            rows = await asyncio.to_thread(spans.trace_spans, path,
                                           req.path_params["trace_id"])
            return _json_reply({"spans": rows})

        add("POST", "/v1.0/state/{store}", save_state)
        add("GET", "/v1.0/state/{store}/{key}", get_state)
        add("DELETE", "/v1.0/state/{store}/{key}", delete_state)
        add("POST", "/v1.0/state/{store}/bulk", bulk_get_state)
        add("POST", "/v1.0/state/{store}/transaction", transact_state)
        add("POST", "/v1.0/state/{store}/query", query_state)
        add("POST", "/v1.0/publish/{pubsub}/{topic}", publish)
        add("POST", "/v1.0/bindings/{name}", invoke_binding)
        add("GET", "/v1.0/secrets/{store}/bulk", bulk_secrets)  # before {key}
        add("GET", "/v1.0/secrets/{store}/{key}", get_secret)
        # a peer app's own token passes here and nowhere else
        add("*", "/v1.0/invoke/{app_id}/method/{path:.*}", invoke, kind="peer")
        # never shed: an autoscaler reads its signals here under overload
        add("GET", "/v1.0/metadata", metadata, kind="exempt")
        # an operator pulls a trace exactly when the replica is in trouble
        add("GET", "/v1.0/traces/{trace_id}", get_trace, kind="exempt")
        workflows_on = env_flag("TASKSRUNNER_WORKFLOWS", default=False)
        if workflows_on or env_flag("TASKSRUNNER_ACTORS", default=False):
            self._actor_routes()
        if workflows_on:
            self._workflow_routes()

    def _actor_routes(self) -> None:
        runtime, add = self.runtime, self.router.add

        from tasksrunner_torch.actors.runtime import FORWARD_HEADER

        def forwarded(req: Request) -> bool:
            return req.headers.get(FORWARD_HEADER) == "1"

        async def invoke_actor(req: Request) -> Response:
            data = json.loads(req.body) if req.body else None
            p = req.path_params
            result = await runtime.invoke_actor(p["atype"], p["aid"], p["m"], data,
                                                forwarded=forwarded(req))
            return _json_reply({"result": result})

        async def register_actor_reminder(req: Request) -> Response:
            body = json.loads(req.body)
            if not isinstance(body, dict) or "dueSeconds" not in body:
                raise ValidationError('reminder body must be {"dueSeconds": n, '
                                      '"periodSeconds"?: n, "data"?: ...}')
            p = req.path_params
            await runtime.register_actor_reminder(
                p["atype"], p["aid"], p["name"], due_seconds=float(body["dueSeconds"]),
                period_seconds=(float(body["periodSeconds"])
                                if body.get("periodSeconds") is not None else None),
                data=body.get("data"), forwarded=forwarded(req))
            return Response(204)

        async def unregister_actor_reminder(req: Request) -> Response:
            p = req.path_params
            await runtime.unregister_actor_reminder(p["atype"], p["aid"], p["name"],
                                                    forwarded=forwarded(req))
            return Response(204)

        async def get_actor_state(req: Request) -> Response:
            return _json_reply(await runtime.get_actor_state(req.path_params["atype"],
                                                             req.path_params["aid"]))

        async def actor_placement(req: Request) -> Response:
            if runtime.actors is None:
                return _json_reply({"replica": None, "placement": []})
            return _json_reply({"replica": runtime.actors.summary(),
                                "placement": await runtime.actors.placement_table()})

        # a peer replica forwarding a turn to the owner uses its own token
        add("*", "/v1.0/actors/{atype}/{aid}/method/{m}", invoke_actor, kind="peer")
        add("POST", "/v1.0/actors/{atype}/{aid}/reminders/{name}", register_actor_reminder,
            kind="peer")
        add("DELETE", "/v1.0/actors/{atype}/{aid}/reminders/{name}",
            unregister_actor_reminder, kind="peer")
        add("GET", "/v1.0/actors/{atype}/{aid}/state", get_actor_state)
        # an operator's view, most wanted during overload and failover
        add("GET", "/v1.0/actors", actor_placement, kind="exempt")

    def _workflow_routes(self) -> None:
        runtime, add = self.runtime, self.router.add

        def plane():
            if runtime.workflows is None:
                raise WorkflowError("the workflow plane is not running on this replica "
                                    "(no @app.workflow registered?)")
            return runtime.workflows

        def query(req: Request, name: str) -> str | None:
            return (parse_qs(req.query).get(name) or [None])[-1] or None

        async def start_workflow(req: Request) -> Response:
            data = json.loads(req.body) if req.body else None
            instance = await plane().start(req.path_params["name"], data,
                                           instance=query(req, "instanceID"))
            return _json_reply({"instanceID": instance})

        async def workflow_status(req: Request) -> Response:
            return _json_reply(await plane().status(req.path_params["instance"]))

        async def workflow_history(req: Request) -> Response:
            instance = req.path_params["instance"]
            return _json_reply({"instance": instance,
                                "history": await plane().history(instance)})

        async def terminate_workflow(req: Request) -> Response:
            data = json.loads(req.body) if req.body else {}
            await plane().terminate(req.path_params["instance"],
                                    reason=str((data or {}).get("reason") or "terminated"))
            return Response(202)

        async def raise_workflow_event(req: Request) -> Response:
            data = json.loads(req.body) if req.body else None
            await plane().raise_event(req.path_params["instance"], req.path_params["event"],
                                      data=data, id=query(req, "eventID"))
            return Response(202)

        async def list_workflows(req: Request) -> Response:
            if runtime.workflows is None:
                return _json_reply({"instances": []})
            return _json_reply({"instances": await runtime.workflows.list()})

        add("POST", "/v1.0/workflows/{component}/{name}/start", start_workflow)
        add("GET", "/v1.0/workflows/{component}/{instance}", workflow_status)
        add("GET", "/v1.0/workflows/{component}/{instance}/history", workflow_history)
        add("POST", "/v1.0/workflows/{component}/{instance}/terminate", terminate_workflow)
        add("POST", "/v1.0/workflows/{component}/{instance}/raiseEvent/{event}",
            raise_workflow_event)
        add("GET", "/v1.0/workflows", list_workflows, kind="exempt")

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        """Listen, then run the runtime's subscribe handshake."""
        if self._app is not None:
            self.admission = self._app.admission
        else:
            self.admission = AdmissionController.from_env()
            self._lag_probe = EventLoopLagProbe()
        self._server = await start_server(self.handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        # placement records advertise it; set before the actor runtime boots
        self.runtime.actor_address = (self.host, self.port)
        await self.runtime.start()
        if self._lag_probe is not None:
            self._lag_probe.start()
        if self._app is None and self.admission is not None:
            self.admission.start()
        # on unless TASKSRUNNER_FLIGHTREC=0; stop() marks it clean
        flightrec.configure_flightrec(self.runtime.app_id)
        logger.info("sidecar for %s listening on %s:%d", self.runtime.app_id, self.host,
                    self.port)

    async def stop(self) -> None:
        """Stop the subscriptions (a delivery in flight finishes, and may
        still call the routes), then the server."""
        flightrec.mark_clean()
        if self._app is None and self.admission is not None:
            await self.admission.stop()
        if self._lag_probe is not None:
            await self._lag_probe.stop()
            self._lag_probe = None
        await self.runtime.stop()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
