"""The runtime behind a sidecar: the port of ``tasksrunner/runtime.py``
without chaos (ROADMAP A23) and the mTLS mesh (A22).

One :class:`Runtime` per app identity holds the app's scoped
:class:`~tasksrunner_torch.component.registry.ComponentRegistry` and a
channel to the app: :class:`HTTPAppChannel` to an app served on its own
port (the two-process layout), :class:`InProcAppChannel` to an app in
the same process (:class:`~tasksrunner_torch.hosting.AppHost`). The
sidecar (:mod:`tasksrunner_torch.sidecar`) puts it on HTTP routes; an
app beside it in one process calls it directly
(:meth:`~tasksrunner_torch.client.AppClient.runtime`).

* **State**: every key is stored under the component's ``keyPrefix``
  (``{app-id}||key`` by default); save, get, bulk get, delete and
  transactions, with etags; queries (:mod:`tasksrunner_torch.state.query`)
  over the app's own keys, answered with the prefix stripped, after a
  ``read`` grant check.
* **Publish**: the data wrapped in a CloudEvent (unless raw), and a
  ``producer`` span ``publish {pubsub}/{topic}`` whose context rides the
  message as its ``traceparent`` (and ``baggage``).
* **Invoke**: the app itself through its channel, any other app through
  its sidecar over HTTP, found by the resolver on every attempt; a
  ``client`` span ``invoke {app}/{path}``; the ``tr-api-token`` header
  when ``TASKSRUNNER_API_TOKEN`` is set. ``AppNotFound`` and transport
  failures are retried under the resiliency policy that targets the app,
  or, where none does, under the builtin one (:data:`INVOKE_ATTEMPTS`),
  which leaves the ``resiliency_retry_*`` counters alone. Error statuses
  are returned as they are.
* **Secrets**: ``get_secret`` and ``bulk_secrets`` read a secret-store
  component after a ``read`` grant check.
* **Bindings** (:mod:`tasksrunner_torch.bindings`): an output binding's
  operation after an ``invoke`` grant check, under the component's
  outbound policy. Each input binding in the app's scope starts after the
  subscribe handshake and delivers every event as a ``POST`` to its
  route in a new trace, with ``content-type: application/json`` and the
  event's metadata (``messageId``, ``attempt``) as headers, under the
  component's inbound policy: a 2xx acks, anything else nacks (a 503's
  ``Retry-After`` too: unlike a subscription's, the binding's source
  retries on its own schedule, as in the JAX runtime). They stop before
  the components close.
* **Resiliency** (:mod:`tasksrunner_torch.resiliency`): a component's
  outbound policy wraps each state operation (each item of a save on
  its own), each publish and each output binding's operation; its
  inbound policy wraps each delivery to the app, a binding's included.
* **Start**: wait until the app answers ``GET /tasksrunner/healthz``,
  read ``GET /tasksrunner/subscribe`` and subscribe one consumer per
  entry (group: the app id), after a ``subscribe`` grant check where
  grants are given. A delivery hands the app the message's wire
  ``traceparent`` and ``baggage``; 2xx acks, 429/503 with
  ``Retry-After`` defers without using up an attempt, anything else
  nacks (:func:`~tasksrunner_torch.pubsub.base.delivery_outcome`).
  Then, with ``TASKSRUNNER_ACTORS`` or ``TASKSRUNNER_WORKFLOWS`` on, the
  actor types the app hosts (``GET /tasksrunner/actors``) get an
  :class:`~tasksrunner_torch.actors.ActorRuntime`, and with
  ``TASKSRUNNER_WORKFLOWS`` on an app that hosts the ``_Workflow`` type
  gets a :class:`~tasksrunner_torch.workflows.WorkflowRuntime`, its
  engine driven at the actor sweep's period.
* **Actors**: ``invoke_actor``, ``register_actor_reminder``,
  ``unregister_actor_reminder`` and ``get_actor_state``
  (:class:`~tasksrunner_torch.errors.ActorError` with the gate off or no
  actor type hosted); ``save_state_item`` is the one-key save that
  returns the new etag, which the actor commit chain guards the next
  write with.

Metrics, in the process-wide registry: ``state_op_latency_seconds``,
``state_query{store}``, ``publish_latency_seconds``, ``invoke_latency_seconds``,
``pubsub_delivery{route,status}``, ``delivery_latency_seconds{route}``,
``binding_invoke{binding,operation}``,
``binding_latency_seconds{binding,operation}``,
``binding_delivery{binding,status}`` and
``binding_delivery_latency_seconds{binding}``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any, Awaitable, Callable

from tasksrunner_torch import cloudevents, spans
from tasksrunner_torch.bindings.base import (
    BindingEvent, BindingResponse, InputBinding, OutputBinding,
)
from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER, http_request
from tasksrunner_torch.component.registry import ComponentRegistry
from tasksrunner_torch.envflag import env_flag
from tasksrunner_torch.errors import (
    ActorError, AppNotFound, BindingError, ComponentNotFound, InvocationError, StateError,
)
from tasksrunner_torch.invoke.resolver import NameResolver
from tasksrunner_torch.metrics import metrics
from tasksrunner_torch.pubsub.base import Message, Nack, delivery_outcome
from tasksrunner_torch.resiliency import ResiliencyPolicies, RetrySpec, TargetPolicy
from tasksrunner_torch.security import AppGrants
from tasksrunner_torch.state.base import StateItem, TransactionOp
from tasksrunner_torch.state.keyprefix import KeyPrefixer, prefixer_for
from tasksrunner_torch.tracing import (
    BAGGAGE_HEADER, TRACEPARENT_HEADER, TraceContext, current_trace, ensure_trace,
    hop_headers, trace_scope,
)

logger = logging.getLogger(__name__)

Reply = tuple[int, dict[str, str], bytes]
#: without a resiliency policy, a peer invoke's transport failures are
#: tried this many times, the retries after 0.2 s and then 0.4 s
INVOKE_ATTEMPTS, INVOKE_RETRY_DELAY = 3, 0.2
_BUILTIN_INVOKE_RETRY = RetrySpec("exponential", INVOKE_RETRY_DELAY,
                                  max_retries=INVOKE_ATTEMPTS - 1)


class InProcAppChannel:
    """Dispatch into an :class:`~tasksrunner_torch.app.App` in this process."""

    def __init__(self, app) -> None:
        self.app = app

    async def request(self, method: str, path: str, *, query: str = "",
                      headers: dict[str, str] | None = None, body: bytes = b"") -> Reply:
        target = path + (f"?{query}" if query else "")
        resp = await self.app.handle(method, target, {k.lower(): v for k, v in
                                                      (headers or {}).items()}, body)
        reply_headers = {k.lower(): v for k, v in resp.headers.items()}
        if resp.body is not None and not isinstance(resp.body, (bytes, bytearray)):
            reply_headers.setdefault("content-type", "application/json")
        return resp.status, reply_headers, resp.payload()


class HTTPAppChannel:
    """HTTP to the app's own port on ``host``."""

    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = port

    async def request(self, method: str, path: str, *, query: str = "",
                      headers: dict[str, str] | None = None, body: bytes = b"") -> Reply:
        target = path + (f"?{query}" if query else "")
        try:
            return await http_request(self.host, self.port, method, target,
                                      headers=headers, body=body)
        except (OSError, asyncio.IncompleteReadError) as exc:
            raise InvocationError(
                f"app unreachable at http://{self.host}:{self.port}{target}: {exc}") from exc


class Runtime:
    def __init__(self, app_id: str | None, registry: ComponentRegistry, *,
                 resolver: NameResolver | None = None, app_channel=None,
                 grants: AppGrants | None = None,
                 resiliency: ResiliencyPolicies | None = None) -> None:
        self.app_id = app_id
        self.registry = registry
        #: the in-scope Resiliency documents; None = no policies
        self.resiliency = resiliency
        self.resolver = resolver or NameResolver()
        self.app_channel = app_channel
        #: per-component permissions; None = unrestricted
        self.grants = grants
        #: (topic, group, cancel) of each subscription
        self._subscriptions: list[tuple[str, str, Callable[[], Awaitable[None]]]] = []
        #: the input bindings this runtime started
        self._input_bindings: list[InputBinding] = []
        self._started = False
        #: the ActorRuntime when the gate is on and the app hosts actor types
        self.actors = None
        #: (host, sidecar port) that actor placement records advertise, so
        #: peers can forward turns here; the sidecar sets it before start()
        self.actor_address: tuple[str, int] | None = None
        #: the WorkflowRuntime when TASKSRUNNER_WORKFLOWS is on and the app
        #: hosts the workflow actor type
        self.workflows = None

    async def _guarded(self, component_name: str, fn: Callable[[], Awaitable]) -> Any:
        """``fn`` under the component's outbound policy, if it has one."""
        policy = (self.resiliency.for_component(component_name)
                  if self.resiliency is not None else None)
        if policy is None:
            return await fn()
        return await policy.execute(fn, retriable=(OSError,))

    def _authorize(self, component: str, op: str, *, topic: str | None = None) -> None:
        if self.grants is not None:
            self.grants.check(component, op, topic=topic, app_id=self.app_id)

    def _state_store(self, name: str) -> tuple[Any, KeyPrefixer]:
        store = self.registry.get(name, block="state")
        return store, prefixer_for(self.registry.spec(name).metadata, app_id=self.app_id,
                                   component_name=name)

    def check_placement_epoch(self, store_name: str, epoch: int | None) -> None:
        """A caller's routing epoch against the store's placement map; a
        store without one (not sharded) and a caller without an epoch pass."""
        if epoch is None:
            return
        check = getattr(self.registry.get(store_name, block="state"), "check_epoch", None)
        if check is not None:
            check(epoch)

    # -- state -----------------------------------------------------------

    async def save_state(self, store_name: str, items: list[dict]) -> None:
        self._authorize(store_name, "write")
        store, prefixer = self._state_store(store_name)
        if any(not isinstance(item, dict) or "key" not in item for item in items):
            raise StateError("each state item needs a key")
        started = time.perf_counter()
        # one item at a time under the policy: a retry re-runs only the
        # failed write, never an etag-guarded one that went through
        for item in items:
            key = prefixer.apply(str(item["key"]))
            await self._guarded(store_name, lambda k=key, it=item: store.set(
                k, it.get("value"), etag=it.get("etag")))
        metrics.inc("state_save", len(items), store=store_name)
        metrics.observe("state_op_latency_seconds", time.perf_counter() - started,
                        store=store_name, op="save")

    async def save_state_item(self, store_name: str, key: str, value: Any, *,
                              etag: str | None = None) -> str:
        """One item saved as :meth:`save_state` saves it; returns the new etag."""
        self._authorize(store_name, "write")
        store, prefixer = self._state_store(store_name)
        started = time.perf_counter()
        new_etag = await self._guarded(
            store_name, lambda: store.set(prefixer.apply(key), value, etag=etag))
        metrics.inc("state_save", store=store_name)
        metrics.observe("state_op_latency_seconds", time.perf_counter() - started,
                        store=store_name, op="save")
        return new_etag

    async def get_state(self, store_name: str, key: str, *,
                        consistency: str = "eventual") -> StateItem | None:
        """``consistency="strong"`` reads a replica set's leader even where
        ``followerReads`` would send the read to a follower."""
        self._authorize(store_name, "read")
        store, prefixer = self._state_store(store_name)
        metrics.inc("state_get", store=store_name)
        started = time.perf_counter()
        read = getattr(store, "get_strong", store.get) if consistency == "strong" else store.get
        item = await self._guarded(store_name, lambda: read(prefixer.apply(key)))
        metrics.observe("state_op_latency_seconds", time.perf_counter() - started,
                        store=store_name, op="get")
        return item

    async def delete_state(self, store_name: str, key: str, *, etag: str | None = None) -> bool:
        self._authorize(store_name, "write")
        store, prefixer = self._state_store(store_name)
        metrics.inc("state_delete", store=store_name)
        return await self._guarded(store_name,
                                   lambda: store.delete(prefixer.apply(key), etag=etag))

    async def bulk_get_state(self, store_name: str, keys: list) -> list[dict]:
        self._authorize(store_name, "read")
        store, prefixer = self._state_store(store_name)
        items = await self._guarded(
            store_name, lambda: store.bulk_get([prefixer.apply(str(k)) for k in keys]))
        metrics.inc("state_bulk_get", len(keys), store=store_name)
        out = []
        for key, item in zip(keys, items):
            entry: dict = {"key": str(key)}
            if item is not None:
                entry["data"] = item.value
                entry["etag"] = item.etag
            out.append(entry)
        return out

    async def query_state(self, store_name: str, query: dict) -> dict:
        """``{"results": [{key, data, etag}], "token"}`` over the app's keys."""
        self._authorize(store_name, "read")
        store, prefixer = self._state_store(store_name)
        resp = await self._guarded(store_name,
                                   lambda: store.query(query, key_prefix=prefixer.prefix))
        metrics.inc("state_query", store=store_name)
        return {"results": [{"key": prefixer.strip(i.key), "data": i.value, "etag": i.etag}
                            for i in resp.items],
                "token": resp.token}

    async def transact_state(self, store_name: str, operations: list[dict]) -> None:
        self._authorize(store_name, "write")
        store, prefixer = self._state_store(store_name)
        ops = []
        for op in operations:
            kind = op.get("operation")
            if kind not in ("upsert", "delete"):
                raise StateError(f"unknown transaction operation {kind!r}")
            req = op.get("request") or {}
            if "key" not in req:
                raise StateError("each transaction request needs a key")
            ops.append(TransactionOp(operation=kind, key=prefixer.apply(str(req["key"])),
                                     value=req.get("value"), etag=req.get("etag")))
        started = time.perf_counter()
        await self._guarded(store_name, lambda: store.transact(ops))
        metrics.inc("state_transact", store=store_name)
        metrics.observe("state_op_latency_seconds", time.perf_counter() - started,
                        store=store_name, op="transact")

    # -- actors ----------------------------------------------------------

    def _actor_runtime(self):
        if self.actors is None:
            raise ActorError("virtual actors are disabled: set TASKSRUNNER_ACTORS=1 and "
                             "register at least one @app.actor handler")
        return self.actors

    async def invoke_actor(self, actor_type: str, actor_id: str, method: str,
                           data: Any = None, *, forwarded: bool = False) -> Any:
        return await self._actor_runtime().invoke_turn(actor_type, actor_id, method, data,
                                                       forwarded=forwarded)

    async def register_actor_reminder(self, actor_type: str, actor_id: str, name: str, *,
                                      due_seconds: float, period_seconds: float | None = None,
                                      data: Any = None, forwarded: bool = False) -> None:
        await self._actor_runtime().register_reminder(
            actor_type, actor_id, name, due_seconds=due_seconds,
            period_seconds=period_seconds, data=data, forwarded=forwarded)

    async def unregister_actor_reminder(self, actor_type: str, actor_id: str, name: str, *,
                                        forwarded: bool = False) -> None:
        await self._actor_runtime().unregister_reminder(actor_type, actor_id, name,
                                                        forwarded=forwarded)

    async def get_actor_state(self, actor_type: str, actor_id: str) -> dict:
        return await self._actor_runtime().read_state(actor_type, actor_id)

    # -- secrets ---------------------------------------------------------

    def get_secret(self, store_name: str, key: str) -> dict[str, str]:
        self._authorize(store_name, "read")
        store = self.registry.get(store_name, block="secretstores")
        return {key: store.get(key)}

    def bulk_secrets(self, store_name: str) -> dict[str, str]:
        self._authorize(store_name, "read")
        store = self.registry.get(store_name, block="secretstores")
        return store.bulk()

    # -- pub/sub ---------------------------------------------------------

    async def publish(self, pubsub_name: str, topic: str, data: Any, *,
                      metadata: dict[str, str] | None = None, raw: bool = False) -> str:
        self._authorize(pubsub_name, "publish", topic=topic)
        broker = self.registry.get(pubsub_name, block="pubsub")
        envelope = data if raw else cloudevents.wrap(
            data, source=self.app_id or "tasksrunner", topic=topic, pubsub_name=pubsub_name)
        # a raw payload must not be unwrapped on delivery
        meta = {**(metadata or {}),
                "content-type": "application/json" if raw else cloudevents.CONTENT_TYPE}
        # one child context is both the consumers' wire parent and the
        # producer span
        ctx = current_trace() or TraceContext.new()
        child = ctx.child()
        meta.update(hop_headers(child))
        started = time.time()
        msg_id = await self._guarded(
            pubsub_name, lambda: broker.publish(topic, envelope, metadata=meta))
        elapsed = time.time() - started
        metrics.inc("publish", pubsub=pubsub_name, topic=topic)
        metrics.observe("publish_latency_seconds", elapsed, pubsub=pubsub_name, topic=topic)
        spans.record_span(kind="producer", name=f"publish {pubsub_name}/{topic}", status=200,
                          start=started, duration=elapsed,
                          attrs={"target": f"{pubsub_name}/{topic}"}, trace_id=child.trace_id,
                          span_id=child.span_id, parent_id=ctx.span_id)
        return msg_id

    # -- bindings --------------------------------------------------------

    async def invoke_output_binding(self, name: str, operation: str, data: Any,
                                    metadata: dict[str, str] | None = None) -> BindingResponse:
        self._authorize(name, "invoke")
        binding = self.registry.get(name, block="bindings")
        if not isinstance(binding, OutputBinding):
            raise BindingError(f"component {name!r} is not an output binding")
        metrics.inc("binding_invoke", binding=name, operation=operation)
        started = time.perf_counter()
        result = await self._guarded(name, lambda: binding.invoke(operation, data, metadata))
        metrics.observe("binding_latency_seconds", time.perf_counter() - started,
                        binding=name, operation=operation)
        return result

    # -- service invocation ----------------------------------------------

    async def invoke(self, target_app_id: str, method_path: str, *, http_method: str = "POST",
                     query: str = "", headers: dict[str, str] | None = None,
                     body: bytes = b"") -> Reply:
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        incoming = headers.get(TRACEPARENT_HEADER)
        if incoming:  # the caller's explicit context: continue it
            base = ensure_trace(incoming, headers.get(BAGGAGE_HEADER))
        else:
            base = current_trace() or TraceContext.new()
        # one child context is both the wire header and the client span
        child = base.child()
        headers.update(hop_headers(child))
        path = "/" + method_path.lstrip("/")
        metrics.inc("invoke", target=target_app_id)
        started = time.time()
        if self.app_id is not None and target_app_id == self.app_id:
            if self.app_channel is None:
                raise InvocationError(f"no app channel for local app {self.app_id!r}")
            reply = await self.app_channel.request(http_method, path, query=query,
                                                   headers=headers, body=body)
        else:
            reply = await self._invoke_peer(target_app_id, path, http_method, query,
                                            headers, body)
        elapsed = time.time() - started
        metrics.observe("invoke_latency_seconds", elapsed, target=target_app_id)
        spans.record_span(kind="client", name=f"invoke {target_app_id}{path}",
                          status=reply[0], start=started, duration=elapsed,
                          attrs={"target": target_app_id}, trace_id=child.trace_id,
                          span_id=child.span_id, parent_id=base.span_id)
        return reply

    async def _invoke_peer(self, target: str, path: str, http_method: str, query: str,
                           headers: dict[str, str], body: bytes) -> Reply:
        """Through the target's sidecar over HTTP, re-resolved on every
        attempt (the peer may have come back on a new port), under the
        app's resiliency policy or else the builtin one."""
        token = os.environ.get(TOKEN_ENV)
        if token:  # the sidecars of one cluster share the token
            headers.setdefault(TOKEN_HEADER, token)
        target_path = f"/v1.0/invoke/{target}/method{path}" + (f"?{query}" if query else "")

        async def attempt() -> Reply:
            addr = self.resolver.resolve(target)
            try:
                return await http_request(addr.host, addr.sidecar_port, http_method,
                                          target_path, headers=headers, body=body)
            except asyncio.IncompleteReadError as exc:  # the peer hung up mid-reply
                raise ConnectionResetError(f"{target} closed the connection: {exc}") from exc

        policy = self.resiliency.for_app(target) if self.resiliency is not None else None
        if policy is None:
            policy = TargetPolicy(target, retry=_BUILTIN_INVOKE_RETRY, metered=False)
        try:
            return await policy.execute(attempt, retriable=(OSError, AppNotFound))
        except (AppNotFound, InvocationError):
            raise
        except (OSError, TimeoutError) as exc:
            raise InvocationError(f"cannot reach sidecar of {target!r}: {exc}") from exc

    # -- the consumer side -----------------------------------------------

    async def _wait_for_app(self, timeout: float = 30.0) -> None:
        """Until the app answers its built-in health route: the app may
        not listen yet when the sidecar starts."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                status, _, _ = await self.app_channel.request("GET", "/tasksrunner/healthz")
                if status < 500:
                    return
            except InvocationError:
                pass  # not up yet
            if time.monotonic() > deadline:
                raise InvocationError(
                    f"app {self.app_id!r} did not become healthy within {timeout}s")
            await asyncio.sleep(0.1)

    async def start(self) -> None:
        """The subscribe handshake (one consumer per subscription the app
        declares), then the input bindings in the app's scope."""
        if self._started or self.app_channel is None:
            self._started = True
            return
        self._started = True  # before the first await: no double start
        await self._wait_for_app()
        status, _, body = await self.app_channel.request("GET", "/tasksrunner/subscribe")
        for sub in json.loads(body) if status == 200 and body else []:
            pubsub_name, topic, route = sub["pubsubname"], sub["topic"], sub["route"]
            try:
                broker = self.registry.get(pubsub_name, block="pubsub")
            except ComponentNotFound:
                logger.warning("app %s subscribes to unknown pubsub %r; skipped",
                               self.app_id, pubsub_name)
                continue
            # a component that exists but is not granted fails the start:
            # an app must not run deaf to a subscription it declared
            self._authorize(pubsub_name, "subscribe", topic=topic)
            group = self.app_id or "default"
            cancel = await broker.subscribe(topic, group,
                                            self._make_subscription_handler(pubsub_name, route))
            self._subscriptions.append((topic, group, cancel))
            logger.info("subscribed %s to %s/%s -> %s", self.app_id, pubsub_name, topic, route)
        for name in self.registry.names(block="bindings"):
            binding = self.registry.get(name)
            # a shared instance another runtime started is not started twice
            if isinstance(binding, InputBinding) and not binding.running:
                await binding.start(self._make_binding_sink(binding))
                binding.running = True
                self._input_bindings.append(binding)
                logger.info("input binding %s -> %s", name, binding.route)
        # workflow instances are actors: either gate boots the actor runtime
        if (env_flag("TASKSRUNNER_ACTORS", default=False)
                or env_flag("TASKSRUNNER_WORKFLOWS", default=False)):
            await self._start_actors()

    async def _start_actors(self) -> None:
        """Ask the app which actor types it hosts; boot the actor runtime
        when there are any, then the workflow plane."""
        status, _, body = await self.app_channel.request("GET", "/tasksrunner/actors")
        types = json.loads(body) if status == 200 and body else []
        if not types:
            return
        from tasksrunner_torch.actors import ActorRuntime
        self.actors = ActorRuntime(self, types)
        await self.actors.start()
        await self._start_workflows()

    async def _start_workflows(self) -> None:
        from tasksrunner_torch.workflows import WORKFLOW_ACTOR_TYPE, WorkflowRuntime
        if (not env_flag("TASKSRUNNER_WORKFLOWS", default=False)
                or WORKFLOW_ACTOR_TYPE not in self.actors.types):
            return
        self.workflows = WorkflowRuntime(self, self.actors)
        # an app in this process drives its instances at the sweep's period
        engine = getattr(getattr(self.app_channel, "app", None), "workflow_engine", None)
        if engine is not None:
            engine.drive_period = self.actors.poll_seconds

    def _make_subscription_handler(self, pubsub_name: str,
                                   route: str) -> Callable[[Message], Awaitable[bool | Nack]]:
        # the component's inbound policy retries a failing handler here,
        # before the delivery counts as a nack
        policy = (self.resiliency.for_component(pubsub_name, "inbound")
                  if self.resiliency is not None else None)

        async def deliver(msg: Message) -> bool | Nack:
            wire_tp = msg.metadata.get(TRACEPARENT_HEADER)
            wire_bag = msg.metadata.get(BAGGAGE_HEADER)
            ctx = ensure_trace(wire_tp, wire_bag)
            with trace_scope(ctx):
                # the app gets the wire context, so its consumer span
                # hangs right under the producer span
                headers = {"content-type": msg.metadata.get("content-type",
                                                            cloudevents.CONTENT_TYPE),
                           TRACEPARENT_HEADER: wire_tp or ctx.header}
                if wire_bag:
                    headers[BAGGAGE_HEADER] = wire_bag
                body = json.dumps(msg.data).encode()

                async def deliver_once() -> Reply:
                    return await self.app_channel.request("POST", route, headers=headers,
                                                          body=body)

                started = time.perf_counter()
                try:
                    if policy is not None:
                        status, reply_headers, _ = await policy.execute(deliver_once,
                                                                        retriable=(OSError,))
                    else:
                        status, reply_headers, _ = await deliver_once()
                except Exception:  # noqa: BLE001 - an unreachable app nacks
                    logger.exception("delivery to %s failed", route)
                    return False
                metrics.inc("pubsub_delivery", route=route, status=str(status))
                metrics.observe("delivery_latency_seconds", time.perf_counter() - started,
                                route=route)
                return delivery_outcome(status, reply_headers)
        return deliver

    def _make_binding_sink(self, binding: InputBinding) -> Callable[[BindingEvent],
                                                                    Awaitable[bool]]:
        policy = (self.resiliency.for_component(binding.name, "inbound")
                  if self.resiliency is not None else None)

        async def sink(event: BindingEvent) -> bool:
            ctx = ensure_trace(None)  # each event opens a trace of its own
            with trace_scope(ctx):
                body = b"" if event.data is None else json.dumps(event.data).encode()
                headers = {"content-type": "application/json", TRACEPARENT_HEADER: ctx.header,
                           **event.metadata}

                async def deliver_once() -> Reply:
                    return await self.app_channel.request("POST", binding.route,
                                                          headers=headers, body=body)

                started = time.perf_counter()
                try:
                    if policy is not None:
                        status, _, _ = await policy.execute(deliver_once, retriable=(OSError,))
                    else:
                        status, _, _ = await deliver_once()
                except Exception:  # noqa: BLE001 - an unreachable app nacks
                    logger.exception("binding delivery to %s failed", binding.route)
                    return False
                metrics.inc("binding_delivery", binding=binding.name, status=str(status))
                metrics.observe("binding_delivery_latency_seconds",
                                time.perf_counter() - started, binding=binding.name)
                return 200 <= status < 300
        return sink

    # -- metadata / teardown ---------------------------------------------

    def metadata(self) -> dict:
        out = {
            "id": self.app_id,
            "components": [{"name": n, "type": self.registry.spec(n).type}
                           for n in self.registry.names()],
            "subscriptions": [{"topic": topic, "group": group}
                              for topic, group, _ in self._subscriptions],
            "metrics": metrics.snapshot(),
            "metric_kinds": metrics.snapshot_kinds(),
            "histograms": metrics.snapshot_histograms(),
        }
        if self.actors is not None:
            out["actors"] = self.actors.summary()
        if self.workflows is not None:
            out["workflows"] = self.workflows.summary()
        # the sharded stores already built (a read builds none)
        placement = {n: doc_of() for n in self.registry.names("state")
                     if (doc_of := getattr(self.registry._instances.get(n), "placement_doc",
                                           None)) is not None}
        if placement:
            out["placement"] = placement
        return out

    async def stop(self) -> None:
        if self.workflows is not None:
            self.workflows.detach()
            self.workflows = None
        if self.actors is not None:
            await self.actors.stop()
            self.actors = None
        for _, _, cancel in self._subscriptions:
            await cancel()
        self._subscriptions.clear()
        for binding in self._input_bindings:
            await binding.stop()
            binding.running = False
        self._input_bindings.clear()
        await self.registry.close()
        self._started = False
