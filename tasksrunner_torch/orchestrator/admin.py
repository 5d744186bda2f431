"""The orchestrator's admin API and the file that advertises it: the
port of ``tasksrunner/orchestrator/admin.py`` on the port's own HTTP
server (:func:`~tasksrunner_torch.app.start_server`).

Routes, on 127.0.0.1 (``admin_port``, else a free port):

* ``GET /admin/apps``: :meth:`Orchestrator.status`;
* ``GET /admin/apps/{app}/logs?tail=N&replica=I``: the replicas' newest lines;
* ``GET /admin/apps/{app}/revisions``: the app's config changes;
* ``POST /admin/apps/{app}/restart``: a rolling restart, a new revision;
* ``POST /admin/apps/{app}/env`` (``{"set": {..}, "remove": [..]}``): a
  new revision with the env changed, the replicas restarted into it;
* ``POST /admin/apps/{app}/scale`` (``{"min_replicas", "max_replicas"}``);
* ``GET /admin/apps/{app}/metrics``: every replica sidecar's
  ``/v1.0/metadata`` merged: counters summed, gauges their largest,
  histograms bucket by bucket, with p50/p95/p99 per series;
* ``GET /admin/traces/{trace_id}``: one trace assembled from every
  replica of every app, each recording into its own span file: their
  sidecars' ``/v1.0/traces/{id}`` gathered (5 s each; a replica that does
  not answer is skipped) and merged by
  :func:`~tasksrunner_torch.spans.assemble_trace`, as ``{"trace_id",
  "replicas", "spans"}`` with ``replicas`` the sidecars that answered.

* ``GET /admin/placement``: per app, each sharded store's epoch, shard
  assignment, hot/cold ranking, migration in flight and rebalance plan
  (``{"reshard", "apps": {app: {"app_id", "last_sweep", "stores"}}}``):
  the placement loops' last sweep with ``TASKSRUNNER_RESHARD`` on, else
  one sweep made for the request.
* ``GET /admin/actors``: the actor placement table (``{"placement":
  [rows sorted by type and id], "replicas": [each replica's summary with
  its app_id]}``): every replica computes the same table from the shared
  store, so the first replica of an app that answers its sidecar's
  ``/v1.0/actors`` gives it; the summaries come from every replica that
  answers (5 s each).

An unknown app is a 404 naming the running ones. When
``TASKSRUNNER_API_TOKEN`` is set every request needs it in the
``tr-api-token`` header (401), the sidecars' header.

The server writes ``orchestrator.json`` (``admin_url`` and ``pid``) beside
the registry file by write-then-rename, so a reader sees the old file or
the new one and never half of one; ``python -m tasksrunner_torch
restart|logs|scale|update|revisions`` read it.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import pathlib
import tempfile
import typing
from urllib.parse import parse_qs

from tasksrunner_torch.app import Request, Response, Router, start_server
from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER, http_request
from tasksrunner_torch.metrics import (
    merge_flat_snapshots, merge_histogram_snapshots, summarize_histograms,
)
from tasksrunner_torch.spans import assemble_trace

if typing.TYPE_CHECKING:  # run.py starts the AdminServer
    from tasksrunner_torch.orchestrator.run import Orchestrator

logger = logging.getLogger(__name__)

INFO_FILENAME = "orchestrator.json"


def info_path(registry_file: str | pathlib.Path) -> pathlib.Path:
    return pathlib.Path(registry_file).parent / INFO_FILENAME


def write_atomically(path: pathlib.Path, text: str) -> None:
    """Write ``text`` to a temporary file beside ``path``, then rename it
    over ``path``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".orchestrator-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _HTTPError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


class AdminServer:
    def __init__(self, orch: "Orchestrator", *, port: int = 0, host: str = "127.0.0.1") -> None:
        self.orch = orch
        self.host = host
        self.port = port
        self._server: asyncio.Server | None = None
        self._info_file: pathlib.Path | None = None
        self.router = Router()
        add = self.router.add
        add("GET", "/admin/apps", self._apps)
        add("GET", "/admin/apps/{app_id}/logs", self._logs)
        add("GET", "/admin/apps/{app_id}/revisions", self._revisions)
        add("POST", "/admin/apps/{app_id}/restart", self._restart)
        add("POST", "/admin/apps/{app_id}/env", self._env)
        add("POST", "/admin/apps/{app_id}/scale", self._scale)
        add("GET", "/admin/apps/{app_id}/metrics", self._metrics)
        add("GET", "/admin/traces/{trace_id}", self._traces)
        add("GET", "/admin/actors", self._actors)
        add("GET", "/admin/placement", self._placement)

    # -- lifecycle -------------------------------------------------------

    async def start(self) -> None:
        self._server = await start_server(self.handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._info_file = info_path(self.orch.config.registry_path)
        info = json.dumps({"admin_url": f"http://{self.host}:{self.port}", "pid": os.getpid()})
        await asyncio.to_thread(write_atomically, self._info_file, info)
        logger.info("orchestrator admin API on http://%s:%d", self.host, self.port)

    async def _close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def stop(self) -> None:
        if self._info_file is not None:
            self._info_file.unlink(missing_ok=True)
            self._info_file = None
        await self._close()

    async def abandon(self) -> None:
        """Close the listener but leave ``orchestrator.json``, as a killed
        orchestrator does; its successor overwrites it."""
        self._info_file = None
        await self._close()

    # -- requests --------------------------------------------------------

    async def handle(self, method: str, target: str, headers: dict[str, str],
                     body: bytes) -> Response:
        path, _, query = target.partition("?")
        token = os.environ.get(TOKEN_ENV)
        if token and headers.get(TOKEN_HEADER) != token:
            return Response(401, {"error": "missing or bad api token"})
        found = self.router.find(method, path)
        if found is None:
            return Response(405 if self.router.known_path(path) else 404,
                            {"error": f"no route {method} {path}"})
        route, params = found
        try:
            return await route.handler(Request(method, path, headers, body,
                                               path_params=params, query=query))
        except _HTTPError as exc:
            return Response(exc.status, {"error": str(exc)})
        except Exception:  # noqa: BLE001 - one request must not stop the server
            logger.exception("admin %s %s failed", method, path)
            return Response(500, {"error": "internal error"})

    def _app_id(self, req: Request) -> str:
        app_id = req.path_params["app_id"]
        if app_id not in self.orch.replicas:
            known = ", ".join(sorted(self.orch.replicas)) or "(none)"
            raise _HTTPError(404, f"unknown app {app_id!r}; running: {known}")
        return app_id

    @staticmethod
    def _json(req: Request) -> dict:
        try:
            body = req.json()
        except ValueError:
            raise _HTTPError(400, "body must be JSON") from None
        if not isinstance(body, dict):
            raise _HTTPError(400, "body must be a JSON object")
        return body

    async def _apps(self, req: Request) -> Response:
        return Response(200, self.orch.status())

    async def _logs(self, req: Request) -> Response:
        app_id = self._app_id(req)
        query = {k: v[-1] for k, v in parse_qs(req.query).items()}
        try:
            tail = int(query.get("tail", "100"))
            replica = int(query["replica"]) if "replica" in query else None
        except ValueError:
            raise _HTTPError(400, "tail and replica must be integers") from None
        return Response(200, {"lines": self.orch.app_logs(app_id, tail=tail, replica=replica)})

    async def _revisions(self, req: Request) -> Response:
        app_id = self._app_id(req)
        return Response(200, {"revisions": self.orch.revisions.get(app_id, [])})

    async def _restart(self, req: Request) -> Response:
        app_id = self._app_id(req)
        entry = await self.orch.restart_app(app_id)
        return Response(200, {"restarted": app_id, "revision": entry})

    async def _env(self, req: Request) -> Response:
        app_id = self._app_id(req)
        body = self._json(req)
        set_env = body.get("set") or {}
        remove = body.get("remove") or []
        if not isinstance(set_env, dict) or not isinstance(remove, list):
            raise _HTTPError(400, "expected {set: {..}, remove: [..]}")
        entry = await self.orch.update_env(app_id, set_env=set_env,
                                           remove=[str(k) for k in remove])
        return Response(200, {"updated": app_id, "revision": entry})

    async def _scale(self, req: Request) -> Response:
        app_id = self._app_id(req)
        body = self._json(req)
        try:
            entry = await self.orch.update_scale(
                app_id,
                min_replicas=int(body["min_replicas"]) if "min_replicas" in body else None,
                max_replicas=int(body["max_replicas"]) if "max_replicas" in body else None)
        except (ValueError, TypeError) as exc:
            raise _HTTPError(400, str(exc)) from None
        return Response(200, {"updated": app_id, "revision": entry})

    async def _metrics(self, req: Request) -> Response:
        """Every replica sidecar's metadata, merged over the app; a
        replica that does not answer is left out of the view."""
        app_id = self._app_id(req)
        token = os.environ.get(TOKEN_ENV)
        headers = {TOKEN_HEADER: token} if token else {}

        async def fetch(sidecar_port: int) -> dict | None:
            try:
                status, _, body = await asyncio.wait_for(http_request(
                    "127.0.0.1", sidecar_port, "GET", "/v1.0/metadata", headers=headers), 5)
                return json.loads(body) if status == 200 else None
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError):
                return None

        docs = await asyncio.gather(*(fetch(r.ports[1]) for r in self.orch.replicas[app_id]
                                      if r.ports))
        payloads = [d for d in docs if d is not None]
        kinds: dict[str, str] = {}
        for p in payloads:
            kinds.update(p.get("metric_kinds") or {})
        merged = merge_histogram_snapshots(p.get("histograms") or {} for p in payloads)
        return Response(200, {
            "app_id": app_id, "replicas": len(payloads),
            "metrics": merge_flat_snapshots((p.get("metrics") or {} for p in payloads), kinds),
            "percentiles": summarize_histograms(merged), "histograms": merged})

    async def _traces(self, req: Request) -> Response:
        """One trace from every replica's span file, through its sidecar."""
        trace_id = req.path_params["trace_id"]
        token = os.environ.get(TOKEN_ENV)
        headers = {TOKEN_HEADER: token} if token else {}
        sources: list[list[dict]] = []
        replicas = 0
        for _, app_replicas in sorted(self.orch.replicas.items()):
            for replica in app_replicas:
                if not replica.ports:
                    continue
                try:
                    status, _, body = await asyncio.wait_for(http_request(
                        "127.0.0.1", replica.ports[1], "GET", f"/v1.0/traces/{trace_id}",
                        headers=headers), 5)
                    if status != 200:
                        continue
                    doc = json.loads(body)
                except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                        ValueError):
                    continue  # a dead replica must not fail the view
                replicas += 1
                if doc.get("spans"):
                    sources.append(doc["spans"])
        spans = await asyncio.to_thread(assemble_trace, sources, trace_id)
        return Response(200, {"trace_id": trace_id, "replicas": replicas, "spans": spans})

    async def _actors(self, req: Request) -> Response:
        token = os.environ.get(TOKEN_ENV)
        headers = {TOKEN_HEADER: token} if token else {}
        placement: list[dict] = []
        replicas: list[dict] = []
        for app_id, app_replicas in sorted(self.orch.replicas.items()):
            have_table = False
            for replica in app_replicas:
                if not replica.ports:
                    continue
                try:
                    status, _, body = await asyncio.wait_for(http_request(
                        "127.0.0.1", replica.ports[1], "GET", "/v1.0/actors",
                        headers=headers), 5)
                    if status != 200:
                        continue
                    doc = json.loads(body)
                except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                        ValueError):
                    continue  # a dead replica must not fail the view
                if doc.get("replica"):
                    replicas.append({"app_id": app_id, **doc["replica"]})
                if not have_table and doc.get("placement"):
                    placement.extend(doc["placement"])
                    have_table = True
        placement.sort(key=lambda r: (r.get("type") or "", r.get("id") or ""))
        return Response(200, {"placement": placement, "replicas": replicas})

    async def _placement(self, req: Request) -> Response:
        controllers = self.orch.placement
        if controllers:
            return Response(200, {"reshard": True, "apps": {
                app_id: c.snapshot() for app_id, c in sorted(controllers.items())}})
        from tasksrunner_torch.orchestrator.placement import PlacementController

        tokens = self.orch.config.app_tokens
        apps = {}
        for app_id in sorted(self.orch.replicas):
            controller = PlacementController(
                app_id, lambda a=app_id: self.orch._replica_info(a),
                api_token=tokens.get(app_id) if tokens else os.environ.get(TOKEN_ENV))
            await controller.step()
            apps[app_id] = controller.snapshot()
        return Response(200, {"reshard": False, "apps": apps})
