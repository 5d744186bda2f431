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
publisher's ``traceparent`` carried across. As the JAX runtime does, a
2xx acks the delivery; a 429 or 503 that carries ``Retry-After`` nacks it
without using up an attempt, to come back after that many seconds; any
other answer nacks it.

``App.start`` still serves HTTP for the two-process layout, where a
``tasksrunner sidecar --app-port P`` of the JAX runtime hosts the app.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Awaitable, Callable

from tasksrunner_torch import cloudevents
from tasksrunner_torch.admission import AdmissionController
from tasksrunner_torch.app import App
from tasksrunner_torch.client import AppClient
from tasksrunner_torch.errors import InvocationError
from tasksrunner_torch.pubsub import InMemoryBroker, Message, Nack, retry_after_from_headers
from tasksrunner_torch.state import InMemoryStateStore
from tasksrunner_torch.tracing import TRACEPARENT_HEADER, outgoing_headers

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
        await broker.publish(topic, envelope, metadata={
            "content-type": cloudevents.CONTENT_TYPE, **outgoing_headers()})

    async def invoke(self, app_id: str, method: str, method_path: str,
                     headers: dict[str, str], body: bytes) -> tuple[int, dict[str, str], bytes]:
        app = self.apps.get(app_id)
        if app is None:
            raise InvocationError(f"no app {app_id!r} in this host", status=404)
        if TRACEPARENT_HEADER not in headers:
            headers = {**headers, **outgoing_headers()}
        resp = await app.handle(method, "/" + method_path.lstrip("/"), headers, body)
        return resp.status, {k.lower(): v for k, v in resp.headers.items()}, resp.payload()

    def _deliverer(self, app: App, route: str) -> Callable[[Message], Awaitable[bool | Nack]]:
        async def deliver(msg: Message) -> bool | Nack:
            headers = {"content-type": msg.metadata.get("content-type",
                                                        cloudevents.CONTENT_TYPE)}
            if TRACEPARENT_HEADER in msg.metadata:
                headers[TRACEPARENT_HEADER] = msg.metadata[TRACEPARENT_HEADER]
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
