"""The app's runtime client: the part of ``tasksrunner/client.py``'s
``AppClient`` the scorer and its callers use, with its transports behind
one surface (``save_state``, ``get_state``, ``query_state``,
``query_state_values``, ``publish_event``, ``invoke_binding``,
``invoke_method``, and the actor calls ``invoke_actor``,
``register_actor_reminder``, ``unregister_actor_reminder`` and
``get_actor_state``).

* :meth:`AppClient.http` talks to a sidecar over HTTP/1.1 on
  ``127.0.0.1``: the Dapr-shaped ``/v1.0/state/{store}``,
  ``/v1.0/state/{store}/{key}``, ``/v1.0/state/{store}/query``,
  ``/v1.0/publish/{pubsub}/{topic}``, ``/v1.0/bindings/{name}`` and
  ``/v1.0/invoke/{app}/method/{path}``; a state, publish or binding call
  answered with an error status raises
  :class:`~tasksrunner_torch.errors.InvocationError` with the status.
  The port is the one given, else ``TASKSRUNNER_HTTP_PORT`` read at
  each call (so an app may be built before its sidecar has a port),
  else 3500. ``tr-api-token`` goes with
  every call when ``TASKSRUNNER_API_TOKEN`` is set, and a ``traceparent``
  child of the ambient trace. Requests go over asyncio streams, never a
  blocking client on the event loop. A state call names the routing
  epoch its store last answered with (``x-tasksrunner-placement-epoch``);
  on a 409 that carries the store's epoch it keeps that one and retries
  once, and a second such 409 raises
  :class:`~tasksrunner_torch.errors.PlacementEpochError`. An actor call
  answered 409 raises :class:`~tasksrunner_torch.errors.ActorFencedError`
  (the owner fenced the turn: retry), as the JAX client does.
* :meth:`AppClient.direct` goes through an in-process host
  (:class:`~tasksrunner_torch.hosting.InProcHost`): state, publish and
  invoke, no queries and no bindings.
* :meth:`AppClient.runtime` calls a :class:`~tasksrunner_torch.runtime.Runtime`
  in the same process (an app beside its sidecar in
  :class:`~tasksrunner_torch.hosting.AppHost`), actors included.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Any
from urllib.parse import quote

from tasksrunner_torch.bindings.base import BindingResponse
from tasksrunner_torch.errors import ActorFencedError, InvocationError, PlacementEpochError
from tasksrunner_torch.state.placement import PLACEMENT_EPOCH_HEADER
from tasksrunner_torch.tracing import TRACEPARENT_HEADER, outgoing_headers

DEFAULT_SIDECAR_PORT = 3500
PORT_ENV = "TASKSRUNNER_HTTP_PORT"
TOKEN_ENV = "TASKSRUNNER_API_TOKEN"
TOKEN_HEADER = "tr-api-token"
MAX_RESPONSE_HEAD_BYTES = 64 * 1024


def retry_after_seconds(status: int, headers: dict[str, str]) -> float | None:
    """The delta-seconds ``Retry-After`` of a 429 or 503 (a shed replica,
    a warming model, an open breaker), which a resiliency policy's next
    delay honours; None for any other answer."""
    if status not in (429, 503) or "retry-after" not in headers:
        return None
    try:
        return max(0.0, float(headers["retry-after"]))
    except ValueError:
        return None


class InvocationResponse:
    def __init__(self, status: int, headers: dict[str, str], body: bytes) -> None:
        self.status = status
        self.headers = headers  # names lowercased
        self.body = body

    def json(self) -> Any:
        return json.loads(self.body) if self.body else None


async def http_request(host: str, port: int, method: str, path: str, *,
                       headers: dict[str, str] | None = None,
                       body: bytes = b"") -> tuple[int, dict[str, str], bytes]:
    """One HTTP/1.1 request on its own connection: (status, headers with
    lowercase names, body). Reads a body by its Content-Length, in
    chunks, or to the end of the stream."""
    reader, writer = await asyncio.open_connection(host, port, limit=MAX_RESPONSE_HEAD_BYTES)
    try:
        lines = [f"{method} {path} HTTP/1.1", f"Host: {host}:{port}",
                 f"Content-Length: {len(body)}", "Connection: close"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body)
        await writer.drain()
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
        status = int(head[0].split(" ", 2)[1])
        reply_headers = {}
        for line in head[1:]:
            name, sep, value = line.partition(":")
            if sep:
                reply_headers[name.strip().lower()] = value.strip()
        if "chunked" in reply_headers.get("transfer-encoding", ""):
            payload = b""
            while size := int((await reader.readuntil(b"\r\n")).split(b";")[0], 16):
                payload += await reader.readexactly(size)
                await reader.readexactly(2)
        elif "content-length" in reply_headers:
            payload = await reader.readexactly(int(reply_headers["content-length"]))
        else:
            payload = await reader.read()
        return status, reply_headers, payload
    finally:
        writer.close()


class _HTTPTransport:
    def __init__(self, host: str, port: int | None) -> None:
        self.host = host
        self._port = port
        #: the routing epoch each store last answered with
        self._placement_epochs: dict[str, int] = {}

    async def _request(self, method: str, path: str, *, headers: dict[str, str] | None = None,
                       body: bytes = b"") -> tuple[int, dict[str, str], bytes]:
        port = self._port or int(os.environ.get(PORT_ENV) or DEFAULT_SIDECAR_PORT)
        headers = dict(headers or {})
        if TRACEPARENT_HEADER not in headers:
            headers.update(outgoing_headers())
        token = os.environ.get(TOKEN_ENV)
        if token:
            headers.setdefault(TOKEN_HEADER, token)
        try:
            return await http_request(self.host, port, method, path, headers=headers, body=body)
        except (OSError, asyncio.IncompleteReadError) as exc:
            raise InvocationError(f"sidecar unreachable at {self.host}:{port}: {exc}") from exc

    async def _checked(self, context: str, method: str, path: str, body: bytes = b"", *,
                       store: str | None = None) -> tuple[int, bytes]:
        """The request, raising on an error status; a state call
        (``store`` given) with the placement epoch's handshake."""
        headers = {"content-type": "application/json"} if body else {}
        known = None if store is None else self._placement_epochs.get(store)
        if known is not None:
            headers[PLACEMENT_EPOCH_HEADER] = str(known)
        for _ in range(2):
            status, reply_headers, payload = await self._request(method, path, headers=headers,
                                                                 body=body)
            fresh = reply_headers.get(PLACEMENT_EPOCH_HEADER)
            if store is None or status != 409 or fresh is None:
                break
            self._placement_epochs[store] = int(fresh)
            headers[PLACEMENT_EPOCH_HEADER] = fresh
        else:  # the epoch moved again while we retried
            raise PlacementEpochError(f"store {store!r} placement epoch advanced twice during "
                                      "one call", current_epoch=int(fresh))
        if status >= 300:
            exc = InvocationError(f"{context}: {status} {payload[:200]!r}", status=status)
            exc.retry_after = retry_after_seconds(status, reply_headers)
            raise exc
        return status, payload

    async def save_state(self, store: str, key: str, value: Any) -> None:
        await self._checked(f"save state {store}", "POST", f"/v1.0/state/{quote(store)}",
                            json.dumps([{"key": key, "value": value}]).encode(), store=store)

    async def get_state(self, store: str, key: str) -> Any:
        status, payload = await self._checked(
            f"get state {store}", "GET",
            f"/v1.0/state/{quote(store)}/{quote(key, safe='')}", store=store)
        return json.loads(payload) if status == 200 and payload else None

    async def query_state(self, store: str, query: dict) -> dict:
        _, payload = await self._checked(f"query state {store}", "POST",
                                         f"/v1.0/state/{quote(store)}/query",
                                         json.dumps(query).encode(), store=store)
        return json.loads(payload)

    async def publish(self, pubsub: str, topic: str, data: Any) -> None:
        await self._checked(f"publish {pubsub}/{topic}", "POST",
                            f"/v1.0/publish/{quote(pubsub)}/{quote(topic)}",
                            json.dumps(data).encode())

    async def invoke_binding(self, name: str, operation: str, data: Any,
                             metadata: dict[str, str] | None) -> BindingResponse:
        _, payload = await self._checked(
            f"binding {name}", "POST", f"/v1.0/bindings/{quote(name)}",
            json.dumps({"operation": operation, "data": data,
                        "metadata": metadata or {}}).encode())
        doc = json.loads(payload)
        return BindingResponse(data=doc.get("data"), metadata=doc.get("metadata") or {})

    async def invoke(self, app_id: str, method_path: str, http_method: str,
                     headers: dict[str, str], body: bytes) -> tuple[int, dict[str, str], bytes]:
        path = f"/v1.0/invoke/{quote(app_id)}/method/" + method_path.lstrip("/")
        return await self._request(http_method, path, headers=headers, body=body)

    async def _actor(self, context: str, method: str, path: str, data: Any = None) -> bytes:
        body = b"" if data is None else json.dumps(data).encode()
        headers = {"content-type": "application/json"} if body else {}
        status, _, payload = await self._request(method, path, headers=headers, body=body)
        if status == 409:
            raise ActorFencedError(f"{context}: {payload[:200]!r}")
        if status >= 300:
            raise InvocationError(f"{context}: {status} {payload[:200]!r}", status=status)
        return payload

    async def invoke_actor(self, actor_type: str, actor_id: str, method: str,
                           data: Any) -> Any:
        payload = await self._actor(
            f"actor {actor_type}/{actor_id}.{method}", "PUT",
            f"/v1.0/actors/{quote(actor_type)}/{quote(actor_id, safe='')}/method/{quote(method)}",
            data)
        return json.loads(payload).get("result") if payload else None

    async def register_actor_reminder(self, actor_type: str, actor_id: str, name: str,
                                      due_seconds: float, period_seconds: float | None,
                                      data: Any) -> None:
        await self._actor(
            f"actor reminder {actor_type}/{actor_id}", "POST",
            f"/v1.0/actors/{quote(actor_type)}/{quote(actor_id, safe='')}/reminders/"
            f"{quote(name)}",
            {"dueSeconds": due_seconds, "periodSeconds": period_seconds, "data": data})

    async def unregister_actor_reminder(self, actor_type: str, actor_id: str,
                                        name: str) -> None:
        await self._actor(
            f"actor reminder {actor_type}/{actor_id}", "DELETE",
            f"/v1.0/actors/{quote(actor_type)}/{quote(actor_id, safe='')}/reminders/"
            f"{quote(name)}")

    async def get_actor_state(self, actor_type: str, actor_id: str) -> dict:
        return json.loads(await self._actor(
            f"actor state {actor_type}/{actor_id}", "GET",
            f"/v1.0/actors/{quote(actor_type)}/{quote(actor_id, safe='')}/state"))


class _DirectTransport:
    def __init__(self, host: Any, app_id: str) -> None:
        self._host = host
        self._app_id = app_id

    async def save_state(self, store: str, key: str, value: Any) -> None:
        await self._host.state_store(store).set(key, value)

    async def get_state(self, store: str, key: str) -> Any:
        item = await self._host.state_store(store).get(key)
        return None if item is None else item.value

    async def publish(self, pubsub: str, topic: str, data: Any) -> None:
        await self._host.publish(self._app_id, pubsub, topic, data)

    async def invoke(self, app_id: str, method_path: str, http_method: str,
                     headers: dict[str, str], body: bytes) -> tuple[int, dict[str, str], bytes]:
        return await self._host.invoke(app_id, http_method, method_path, headers, body)


class _RuntimeTransport:
    def __init__(self, runtime: Any) -> None:
        self._rt = runtime

    async def save_state(self, store: str, key: str, value: Any) -> None:
        await self._rt.save_state(store, [{"key": key, "value": value}])

    async def get_state(self, store: str, key: str) -> Any:
        item = await self._rt.get_state(store, key)
        return None if item is None else item.value

    async def query_state(self, store: str, query: dict) -> dict:
        return await self._rt.query_state(store, query)

    async def publish(self, pubsub: str, topic: str, data: Any) -> None:
        await self._rt.publish(pubsub, topic, data)

    async def invoke_binding(self, name: str, operation: str, data: Any,
                             metadata: dict[str, str] | None) -> BindingResponse:
        return await self._rt.invoke_output_binding(name, operation, data, metadata)

    async def invoke(self, app_id: str, method_path: str, http_method: str,
                     headers: dict[str, str], body: bytes) -> tuple[int, dict[str, str], bytes]:
        return await self._rt.invoke(app_id, method_path, http_method=http_method,
                                     headers=headers, body=body)

    async def invoke_actor(self, actor_type: str, actor_id: str, method: str,
                           data: Any) -> Any:
        return await self._rt.invoke_actor(actor_type, actor_id, method, data)

    async def register_actor_reminder(self, actor_type: str, actor_id: str, name: str,
                                      due_seconds: float, period_seconds: float | None,
                                      data: Any) -> None:
        await self._rt.register_actor_reminder(actor_type, actor_id, name,
                                               due_seconds=due_seconds,
                                               period_seconds=period_seconds, data=data)

    async def unregister_actor_reminder(self, actor_type: str, actor_id: str,
                                        name: str) -> None:
        await self._rt.unregister_actor_reminder(actor_type, actor_id, name)

    async def get_actor_state(self, actor_type: str, actor_id: str) -> dict:
        return await self._rt.get_actor_state(actor_type, actor_id)


class AppClient:
    """Make one with :meth:`http` beside a sidecar, :meth:`direct` in an
    in-process host, or :meth:`runtime` beside a runtime in one process."""

    def __init__(self, transport: _HTTPTransport | _DirectTransport | _RuntimeTransport) -> None:
        self._t = transport

    @classmethod
    def http(cls, port: int | None = None, host: str = "127.0.0.1") -> AppClient:
        return cls(_HTTPTransport(host, port))

    @classmethod
    def direct(cls, host: Any, app_id: str) -> AppClient:
        """The client of app ``app_id`` in the in-process ``host``."""
        return cls(_DirectTransport(host, app_id))

    @classmethod
    def runtime(cls, runtime: Any) -> AppClient:
        """The client of the app that ``runtime`` serves."""
        return cls(_RuntimeTransport(runtime))

    async def save_state(self, store: str, key: str, value: Any) -> None:
        await self._t.save_state(store, key, value)

    async def get_state(self, store: str, key: str) -> Any:
        """The value under ``key``, or None when there is none."""
        return await self._t.get_state(store, key)

    async def query_state(self, store: str, query: dict) -> dict:
        """``{"results": [{key, data, etag}], "token"}``: one page of the
        app's keys that match ``query``."""
        return await self._t.query_state(store, query)

    async def query_state_values(self, store: str, query: dict) -> list[Any]:
        return [r["data"] for r in (await self._t.query_state(store, query))["results"]]

    async def publish_event(self, pubsub: str, topic: str, data: Any) -> None:
        """Publish ``data``; the runtime wraps it in a CloudEvent."""
        await self._t.publish(pubsub, topic, data)

    async def invoke_binding(self, name: str, operation: str, data: Any = None,
                             metadata: dict[str, str] | None = None) -> BindingResponse:
        """Run ``operation`` on the output binding ``name``."""
        return await self._t.invoke_binding(name, operation, data, metadata)

    async def invoke_method(self, app_id: str, method_path: str, *,
                            http_method: str = "POST", data: Any = None,
                            headers: dict[str, str] | None = None) -> InvocationResponse:
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        body = b""
        if data is not None:
            body = json.dumps(data).encode()
            headers.setdefault("content-type", "application/json")
        status, reply_headers, payload = await self._t.invoke(
            app_id, method_path, http_method, headers, body)
        return InvocationResponse(status, reply_headers, payload)

    # -- actors (not on the in-process host's client) ----------------------

    async def invoke_actor(self, actor_type: str, actor_id: str, method: str,
                           data: Any = None) -> Any:
        """One turn of the actor, wherever it lives; its result."""
        return await self._t.invoke_actor(actor_type, actor_id, method, data)

    async def register_actor_reminder(self, actor_type: str, actor_id: str, name: str, *,
                                      due_seconds: float, period_seconds: float | None = None,
                                      data: Any = None) -> None:
        await self._t.register_actor_reminder(actor_type, actor_id, name, due_seconds,
                                              period_seconds, data)

    async def unregister_actor_reminder(self, actor_type: str, actor_id: str,
                                        name: str) -> None:
        await self._t.unregister_actor_reminder(actor_type, actor_id, name)

    async def get_actor_state(self, actor_type: str, actor_id: str) -> dict:
        """The actor's durable record: ``{"epoch", "data", "reminders"}``."""
        return await self._t.get_actor_state(actor_type, actor_id)
