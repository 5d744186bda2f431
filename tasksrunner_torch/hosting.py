"""Apps and their runtime in one event loop, with no sockets: the port's
counterpart of the part of ``tasksrunner/hosting.py::InProcCluster`` the
scorer needs.

:class:`InProcHost` is built from named components (state stores and
brokers). :meth:`~InProcHost.start` gives every app its in-process
:class:`~tasksrunner_torch.client.AppClient` and, when
``TASKSRUNNER_ADMISSION`` is on, one admission controller shared by all
(one process, one gate), begins each app (its startup hooks run in the
background, as under ``App.start``), reads each
app's subscription document and subscribes it to its brokers, one
consumer group per app. A published payload is wrapped in a CloudEvent
and delivered through the subscriber's own :meth:`App.handle`, with the
publisher's ``traceparent`` (and ``baggage``) carried across. As the JAX
runtime does, a 2xx acks the delivery; a 429 or 503 that carries
``Retry-After`` nacks it without using up an attempt, to come back after
that many seconds; any other answer nacks it.

The host plays the runtime's part in the traces, as the JAX runtime
does: each invoke and each publish takes one child of the caller's
context (or of a new trace) that is both the hop's ``traceparent`` and
its recorded span, ``invoke {app_id}/{path}`` of kind ``client`` or
``publish {pubsub}/{topic}`` of kind ``producer``, each with a
``target`` attribute; the callee's ``server`` or ``consumer`` span then
hangs under it. It also runs the loop's lag probe
(:mod:`tasksrunner_torch.probes`) while it is started.

``App.start`` still serves HTTP for the two-process layout, where a
``tasksrunner sidecar --app-port P`` of the JAX runtime hosts the app.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Awaitable, Callable

from tasksrunner_torch import cloudevents, spans
from tasksrunner_torch.admission import AdmissionController
from tasksrunner_torch.app import App
from tasksrunner_torch.client import AppClient
from tasksrunner_torch.errors import InvocationError
from tasksrunner_torch.probes import EventLoopLagProbe
from tasksrunner_torch.pubsub import InMemoryBroker, Message, Nack, retry_after_from_headers
from tasksrunner_torch.state import InMemoryStateStore
from tasksrunner_torch.tracing import (
    BAGGAGE_HEADER, TRACEPARENT_HEADER, TraceContext, current_trace, ensure_trace, hop_headers,
)

logger = logging.getLogger(__name__)


class InProcHost:
    def __init__(self, *, state_stores: dict[str, InMemoryStateStore] | None = None,
                 brokers: dict[str, InMemoryBroker] | None = None) -> None:
        self.state_stores = dict(state_stores or {})
        self.brokers = dict(brokers or {})
        self.apps: dict[str, App] = {}
        #: deliveries an app declined with 429/503 + Retry-After, by status
        self.declined: dict[int, int] = {}
        self._cancels: list[Callable[[], Awaitable[None]]] = []
        self._lag_probe = EventLoopLagProbe()

    def add_app(self, app: App) -> None:
        self.apps[app.app_id] = app

    def client(self, app_id: str) -> AppClient:
        return self.apps[app_id].client

    async def start(self) -> None:
        # one process, one gate: the apps share one controller, which
        # counts all their in-flight requests (registered signals are
        # process-wide anyway)
        gate = AdmissionController.from_env(
            inflight=lambda: sum(app.inflight for app in self.apps.values()))
        for app_id, app in self.apps.items():
            app.client = AppClient.direct(self, app_id)
            app.admission = gate
        self._lag_probe.start()
        for app in self.apps.values():
            app.begin()
        for app_id, app in self.apps.items():
            doc = (await app.handle("GET", "/tasksrunner/subscribe")).body
            for sub in doc:
                broker = self.brokers.get(sub["pubsubname"])
                if broker is None:
                    logger.warning("app %s subscribes to unknown pubsub %r; skipped",
                                   app_id, sub["pubsubname"])
                    continue
                self._cancels.append(await broker.subscribe(
                    sub["topic"], app_id, self._deliverer(app, sub["route"])))

    async def wait_ready(self) -> None:
        """Wait for every app's startup hooks; raises what they raised."""
        for app in self.apps.values():
            await app.wait_ready()

    async def stop(self) -> None:
        for cancel in self._cancels:
            await cancel()
        self._cancels.clear()
        for app in self.apps.values():
            await app.stop()
        for broker in self.brokers.values():
            await broker.aclose()
        await self._lag_probe.stop()

    # -- the runtime side of the apps' clients ---------------------------

    def state_store(self, name: str) -> InMemoryStateStore:
        store = self.state_stores.get(name)
        if store is None:
            raise InvocationError(f"no state store {name!r}", status=404)
        return store

    async def publish(self, source: str, pubsub: str, topic: str, data: Any) -> None:
        broker = self.brokers.get(pubsub)
        if broker is None:
            raise InvocationError(f"no pubsub {pubsub!r}", status=404)
        envelope = cloudevents.wrap(data, source=source, topic=topic, pubsub_name=pubsub)
        # one child context is both the consumers' wire parent and the
        # producer span
        ctx = current_trace() or TraceContext.new()
        child = ctx.child()
        started = time.time()
        await broker.publish(topic, envelope, metadata={
            "content-type": cloudevents.CONTENT_TYPE, **hop_headers(child)})
        spans.record_span(kind="producer", name=f"publish {pubsub}/{topic}", status=200,
                          start=started, duration=time.time() - started,
                          attrs={"target": f"{pubsub}/{topic}"}, trace_id=child.trace_id,
                          span_id=child.span_id, parent_id=ctx.span_id)

    async def invoke(self, app_id: str, method: str, method_path: str,
                     headers: dict[str, str], body: bytes) -> tuple[int, dict[str, str], bytes]:
        app = self.apps.get(app_id)
        if app is None:
            raise InvocationError(f"no app {app_id!r} in this host", status=404)
        # the caller's explicit context, else the ambient one, else a new
        # trace; one child of it is both the wire header and the client span
        incoming = headers.get(TRACEPARENT_HEADER)
        if incoming:
            base = ensure_trace(incoming, headers.get(BAGGAGE_HEADER))
        else:
            base = current_trace() or TraceContext.new()
        child = base.child()
        headers = {**headers, **hop_headers(child)}
        path = "/" + method_path.lstrip("/")
        started = time.time()
        resp = await app.handle(method, path, headers, body)
        spans.record_span(kind="client", name=f"invoke {app_id}{path}", status=resp.status,
                          start=started, duration=time.time() - started,
                          attrs={"target": app_id}, trace_id=child.trace_id,
                          span_id=child.span_id, parent_id=base.span_id)
        return resp.status, {k.lower(): v for k, v in resp.headers.items()}, resp.payload()

    def _deliverer(self, app: App, route: str) -> Callable[[Message], Awaitable[bool | Nack]]:
        async def deliver(msg: Message) -> bool | Nack:
            headers = {"content-type": msg.metadata.get("content-type",
                                                        cloudevents.CONTENT_TYPE)}
            for name in (TRACEPARENT_HEADER, BAGGAGE_HEADER):
                if name in msg.metadata:
                    headers[name] = msg.metadata[name]
            resp = await app.handle("POST", route, headers, json.dumps(msg.data).encode())
            if 200 <= resp.status < 300:
                return True
            if resp.status in (429, 503):
                delay = retry_after_from_headers(resp.headers)
                if delay is not None:
                    self.declined[resp.status] = self.declined.get(resp.status, 0) + 1
                    return Nack(retry_after=delay, counts_attempt=False)
            return False
        return deliver
