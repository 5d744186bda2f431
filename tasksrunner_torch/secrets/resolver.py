"""Secret references in component metadata resolved: the port of
``tasksrunner/secrets/resolver.py``. A ``secretKeyRef`` or store-backed
``secretRef`` resolves against the secret-store component it names, a
ref that names none against the default store (environment variables).
A ref that does not resolve raises
:class:`~tasksrunner_torch.errors.SecretError`; it never becomes ``""``."""

from __future__ import annotations

from tasksrunner_torch.component.spec import ComponentSpec, SecretRef
from tasksrunner_torch.errors import SecretError
from tasksrunner_torch.secrets.base import SecretStore
from tasksrunner_torch.secrets.local import EnvSecretStore


class SecretResolver:
    """Store name → :class:`SecretStore`, and the specs resolved."""

    def __init__(self) -> None:
        self._stores: dict[str, SecretStore] = {}
        self.default_store = EnvSecretStore()

    def add_store(self, store: SecretStore) -> None:
        self._stores[store.name] = store

    def store(self, name: str | None) -> SecretStore:
        if name is None:
            return self.default_store
        try:
            return self._stores[name]
        except KeyError:
            raise SecretError(f"secret store {name!r} is not registered") from None

    def resolve_value(self, value: str | SecretRef) -> str:
        if isinstance(value, str):
            return value
        return self.store(value.store).get(value.key)

    def resolve_metadata(self, spec: ComponentSpec) -> dict[str, str]:
        """The spec's metadata with every :class:`SecretRef` resolved."""
        out: dict[str, str] = {}
        for key, value in spec.metadata.items():
            try:
                out[key] = self.resolve_value(value)
            except SecretError as exc:
                raise SecretError(
                    f"component {spec.name!r}: cannot resolve metadata {key!r}: {exc}") from exc
        return out
