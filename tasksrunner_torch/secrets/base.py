"""The secret-store building block: the port of
``tasksrunner/secrets/base.py``. The sidecar serves it as
``GET /v1.0/secrets/{store}/{key}`` (``{key: value}``) and
``GET /v1.0/secrets/{store}/bulk``."""

from __future__ import annotations

import abc


class SecretStore(abc.ABC):
    """A named source of secrets. Synchronous: secrets are read when
    components are built and on the (rare) secret route."""

    def __init__(self, name: str) -> None:
        self.name = name

    @abc.abstractmethod
    def get(self, key: str) -> str:
        """The secret's value, or :class:`~tasksrunner_torch.errors.SecretNotFound`."""

    @abc.abstractmethod
    def keys(self) -> list[str]:
        """The names of the secrets it holds (the bulk route)."""

    def bulk(self) -> dict[str, str]:
        return {k: self.get(k) for k in self.keys()}

    def close(self) -> None:
        pass
