"""Drivers by component type, and the components one app sees: the port
of ``tasksrunner/component/registry.py``.

:func:`driver` registers a factory for one or more ``type`` strings;
the cloud-typed names of the reference's component files
(``state.azure.cosmosdb``, ``pubsub.azure.servicebus``) are aliases of
the local engines, so those files run unchanged. The port's drivers:

* ``state.in-memory`` / ``state.memory``: :class:`~tasksrunner_torch.state.InMemoryStateStore`;
* ``state.sqlite`` / ``state.azure.cosmosdb`` / ``state.postgresql``:
  :class:`~tasksrunner_torch.state.sqlite.SqliteStateStore`;
* ``pubsub.in-memory`` / ``pubsub.memory``: :class:`~tasksrunner_torch.pubsub.InMemoryBroker`;
* ``pubsub.sqlite`` / ``pubsub.azure.servicebus``, and ``pubsub.redis``
  without a ``redisHost``: :class:`~tasksrunner_torch.pubsub.sqlite.SqliteBroker`;
* ``secretstores.local.env`` / ``secretstores.azure.keyvault``,
  ``secretstores.local.file`` and ``secretstores.local.static``: the
  stores of :mod:`tasksrunner_torch.secrets.local`;
* ``bindings.localqueue`` / ``bindings.azure.storagequeues``:
  :class:`~tasksrunner_torch.bindings.localqueue.LocalQueueBinding`;
  ``bindings.cron``: :class:`~tasksrunner_torch.bindings.cron.CronBinding`;
  ``bindings.localblob`` / ``bindings.azure.blobstorage``:
  :class:`~tasksrunner_torch.bindings.blobstore.LocalBlobStoreBinding`;
  ``bindings.smtp`` / ``bindings.twilio.sendgrid``:
  :class:`~tasksrunner_torch.bindings.email.EmailOutboxBinding`.

A :class:`ComponentRegistry` holds the specs in one app's scope. It
builds the secret stores among them at once, since every other
component's secret refs may name them, and each other component, its
refs resolved, the first time it is asked for.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Callable

from tasksrunner_torch.component.spec import ComponentSpec
from tasksrunner_torch.errors import ComponentNotFound, DriverNotFound
from tasksrunner_torch.secrets.base import SecretStore
from tasksrunner_torch.secrets.resolver import SecretResolver

#: factory(spec, metadata) -> component instance
DriverFactory = Callable[[ComponentSpec, dict[str, str]], Any]

_DRIVERS: dict[str, DriverFactory] = {}
#: the modules whose import registers the port's drivers
_DRIVER_MODULES = ("tasksrunner_torch.state.memory", "tasksrunner_torch.state.sqlite",
                   "tasksrunner_torch.pubsub.memory", "tasksrunner_torch.pubsub.sqlite",
                   "tasksrunner_torch.secrets.drivers", "tasksrunner_torch.bindings.localqueue",
                   "tasksrunner_torch.bindings.cron", "tasksrunner_torch.bindings.blobstore",
                   "tasksrunner_torch.bindings.email")


def driver(type_name: str, *aliases: str) -> Callable[[DriverFactory], DriverFactory]:
    """Register a component driver for one or more ``type`` strings."""

    def register(factory: DriverFactory) -> DriverFactory:
        for t in (type_name, *aliases):
            _DRIVERS[t] = factory
        return factory

    return register


def _load_drivers() -> None:
    for name in _DRIVER_MODULES:
        importlib.import_module(name)


def resolve_driver(type_name: str) -> DriverFactory:
    _load_drivers()
    try:
        return _DRIVERS[type_name]
    except KeyError:
        known = ", ".join(sorted(_DRIVERS))
        raise DriverNotFound(
            f"no driver for component type {type_name!r} (known: {known})") from None


def registered_types() -> list[str]:
    _load_drivers()
    return sorted(_DRIVERS)


class ComponentRegistry:
    """The components one app identity sees: only the specs in its
    scope, each built by its driver on first use."""

    def __init__(self, specs: list[ComponentSpec], *, app_id: str | None = None) -> None:
        self.app_id = app_id
        self.resolver = SecretResolver()
        self._specs = {spec.name: spec for spec in specs if spec.in_scope(app_id)}
        self._instances: dict[str, Any] = {}
        # secret stores first; an inline ``secrets:`` list needs none (the
        # parser resolved refs to it)
        for spec in self._specs.values():
            if spec.block == "secretstores":
                store = self._build(spec)
                if isinstance(store, SecretStore):
                    self.resolver.add_store(store)
                self._instances[spec.name] = store

    def _build(self, spec: ComponentSpec) -> Any:
        factory = resolve_driver(spec.type)
        return factory(spec, self.resolver.resolve_metadata(spec))

    def spec(self, name: str) -> ComponentSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise ComponentNotFound(
                f"component {name!r} is not registered"
                + (f" for app {self.app_id!r}" if self.app_id else "")) from None

    def get(self, name: str, *, block: str | None = None) -> Any:
        """The component ``name``, built on first use. ``block`` asserts
        its family: asking the state API for a broker is a 400."""
        spec = self.spec(name)
        if block is not None and spec.block != block:
            raise ComponentNotFound(
                f"component {name!r} is {spec.type!r}, not a {block} component")
        if name not in self._instances:
            self._instances[name] = self._build(spec)
        return self._instances[name]

    def names(self, block: str | None = None) -> list[str]:
        return sorted(n for n, s in self._specs.items() if block is None or s.block == block)

    async def close(self) -> None:
        """Close every built component (``aclose`` or ``close``); one that
        fails does not keep the rest open, and all failures are raised
        together afterwards."""
        errors: list[Exception] = []
        for name, instance in list(self._instances.items()):
            closer = getattr(instance, "aclose", None) or getattr(instance, "close", None)
            if closer is None:
                continue
            try:
                result = closer()
                if inspect.isawaitable(result):
                    await result
            except Exception as exc:  # noqa: BLE001 - collected and re-raised
                exc.add_note(f"while closing component {name!r}")
                errors.append(exc)
        self._instances.clear()
        if errors:
            raise ExceptionGroup("component close failures", errors)
