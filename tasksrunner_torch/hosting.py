"""Hosting apps with their runtime: the port of ``tasksrunner/hosting.py``'s
``AppHost`` and of the part of ``InProcCluster`` the scorer needs.

:class:`AppHost` is one app and its sidecar in one process, over real
sockets: the app on its own port (``App.start``), the sidecar
(:class:`~tasksrunner_torch.sidecar.Sidecar`) on another, the app's
client calling the sidecar's runtime directly, and the replica
registered in the resolver's file so peers can invoke it. The
``kind: Resiliency`` documents in the components directory apply to its
runtime. A start that fails part-way unwinds what it started. ``python -m tasksrunner_torch
host`` runs one.

The rest of this module is the in-process host: apps and their runtime
in one event loop, with no sockets.

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

``App.start`` also serves the two-process layout, an app beside a
``python -m tasksrunner_torch sidecar --app-port P`` of its own.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any, Awaitable, Callable

from tasksrunner_torch import cloudevents, spans
from tasksrunner_torch.admission import AdmissionController
from tasksrunner_torch.app import App
from tasksrunner_torch.client import AppClient
from tasksrunner_torch.component.loader import load_components
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import InvocationError
from tasksrunner_torch.invoke.resolver import AppAddress, NameResolver
from tasksrunner_torch.probes import EventLoopLagProbe
from tasksrunner_torch.resiliency import ResiliencyPolicies, load_resiliency
from tasksrunner_torch.pubsub import InMemoryBroker, Message, Nack, delivery_outcome
from tasksrunner_torch.runtime import InProcAppChannel, Runtime
from tasksrunner_torch.security import grants_from_env
from tasksrunner_torch.sidecar import Sidecar
from tasksrunner_torch.state import InMemoryStateStore
from tasksrunner_torch.tracing import (
    BAGGAGE_HEADER, TRACEPARENT_HEADER, TraceContext, current_trace, ensure_trace, hop_headers,
)

logger = logging.getLogger(__name__)


class AppHost:
    """App server and sidecar of one app, in one process."""

    def __init__(self, app: App, *, components_path: str | None = None,
                 specs: list[ComponentSpec] | None = None, app_port: int = 0,
                 sidecar_port: int = 0, host: str = "127.0.0.1", bind: str | None = None,
                 registry_file: str | None = None, register: bool = True) -> None:
        self.app = app
        #: where the sidecar binds and where peers reach it
        self.host = host
        #: the app server's bind address ("0.0.0.0": external ingress);
        #: the sidecar stays on ``host``
        self.bind = bind or host
        self.app_port = app_port
        self.sidecar_port = sidecar_port
        self.register = register
        if specs is None:
            specs = load_components(components_path) if components_path else []
        self.specs = specs
        #: the Resiliency documents beside the components
        self.resiliency_specs = load_resiliency(components_path) if components_path else []
        self.resolver = NameResolver(registry_file=registry_file)
        #: the app's grants from ``TASKSRUNNER_GRANTS``; None = unrestricted
        self.grants = grants_from_env()
        self.sidecar: Sidecar | None = None
        self._app_started = False

    async def start(self) -> None:
        """App server, sidecar (its subscribe handshake included), then
        the registration; a failure unwinds what already started."""
        try:
            runtime = Runtime(self.app.app_id,
                              ComponentRegistry(self.specs, app_id=self.app.app_id),
                              resolver=self.resolver, app_channel=InProcAppChannel(self.app),
                              grants=self.grants,
                              resiliency=(ResiliencyPolicies(self.resiliency_specs,
                                                             app_id=self.app.app_id)
                                          if self.resiliency_specs else None))
            # the app's calls go to its runtime directly; HTTP starts at
            # the first process boundary (peer invokes)
            self.app.client = AppClient.runtime(runtime)
            self.app_port = await self.app.start(self.bind, self.app_port)
            self._app_started = True
            self.sidecar = Sidecar(runtime, host=self.host, port=self.sidecar_port, app=self.app)
            await self.sidecar.start()
            self.sidecar_port = self.sidecar.port
            if self.register:
                # off the loop: the registry's lock file may be waited on
                await asyncio.to_thread(self.resolver.register, AppAddress(
                    app_id=self.app.app_id, host=self.host,
                    sidecar_port=self.sidecar_port, app_port=self.app_port))
        except BaseException:
            await self._teardown()
            raise
        logger.info("app %s on :%d, sidecar on :%d", self.app.app_id, self.app_port,
                    self.sidecar_port)

    async def _teardown(self) -> list[Exception]:
        """Stop whatever started, in reverse order; each step is tried
        whatever the one before it raised."""
        steps = []
        if self.register:
            steps.append(("unregister", lambda: asyncio.to_thread(
                self.resolver.unregister, self.app.app_id, pid=os.getpid(),
                sidecar_port=self.sidecar_port)))
        if self.sidecar is not None:
            steps.append(("sidecar stop", self.sidecar.stop))
        if self._app_started:
            steps.append(("app stop", self.app.stop))
        errors = []
        for what, step in steps:
            try:
                await step()
            except Exception as exc:  # noqa: BLE001 - the rest must still run
                logger.exception("%s failed", what)
                errors.append(exc)
        self.sidecar = None
        self._app_started = False
        return errors

    async def stop(self) -> None:
        """Unregister, stop the sidecar (its deliveries first), then the app."""
        errors = await self._teardown()
        if errors:
            raise ExceptionGroup("app host stop failures", errors)


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
            outcome = delivery_outcome(resp.status, resp.headers)
            if isinstance(outcome, Nack):
                self.declined[resp.status] = self.declined.get(resp.status, 0) + 1
            return outcome
        return deliver
