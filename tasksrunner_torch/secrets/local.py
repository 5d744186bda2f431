"""The local secret stores: the port of ``tasksrunner/secrets/local.py``,
reading YAML secret files with
:mod:`~tasksrunner_torch.component.blockyaml` instead of PyYAML.

* :class:`EnvSecretStore`: environment variables (``api-key`` with prefix
  ``TR_`` reads ``TR_API_KEY``);
* :class:`FileSecretStore`: a JSON or YAML file of key → value, nested
  mappings flattened with ``nested_separator`` (``SendGrid:ApiKey``);
* :class:`StaticSecretStore`: secrets held in memory.
"""

from __future__ import annotations

import json
import os
import pathlib

from tasksrunner_torch.component import blockyaml
from tasksrunner_torch.errors import ComponentError, SecretError, SecretNotFound
from tasksrunner_torch.secrets.base import SecretStore


class EnvSecretStore(SecretStore):
    """Secrets from environment variables: the key with ``prefix``,
    dashes as underscores, upper case; an unprefixed store also takes the
    key's exact name."""

    def __init__(self, name: str = "envsecretstore", *, prefix: str = "") -> None:
        super().__init__(name)
        self.prefix = prefix

    def _envname(self, key: str) -> str:
        return (self.prefix + key).replace("-", "_").upper()

    def get(self, key: str) -> str:
        env = self._envname(key)
        if env in os.environ:
            return os.environ[env]
        # a prefix is a namespace: it must not open the whole environment
        if not self.prefix and key in os.environ:
            return os.environ[key]
        raise SecretNotFound(f"secret {key!r} not in environment (looked for {env})")

    def keys(self) -> list[str]:
        if not self.prefix:
            return sorted(os.environ)
        pfx = self._envname("")
        return sorted(k[len(pfx):].lower().replace("_", "-")
                      for k in os.environ if k.startswith(pfx))


class FileSecretStore(SecretStore):
    """Secrets from a JSON file (a ``.yaml`` / ``.yml`` one read as
    YAML), nested mappings flattened with ``nested_separator``."""

    def __init__(self, name: str, path: str | pathlib.Path, *,
                 nested_separator: str = ":") -> None:
        super().__init__(name)
        self.path = pathlib.Path(path)
        self.nested_separator = nested_separator
        self._data = self._load()

    def _load(self) -> dict[str, str]:
        try:
            text = self.path.read_text()
        except OSError as exc:
            raise SecretError(f"cannot read secret file {self.path}: {exc}") from exc
        try:
            if self.path.suffix in (".yaml", ".yml"):
                docs = blockyaml.load_all(text, str(self.path))
                if len(docs) > 1:
                    raise ComponentError(f"{self.path}: more than one document")
                raw = (docs[0] if docs else None) or {}
            else:
                raw = json.loads(text or "{}")
        except (ComponentError, json.JSONDecodeError) as exc:
            raise SecretError(f"cannot parse secret file {self.path}: {exc}") from exc
        if not isinstance(raw, dict):
            raise SecretError(f"secret file {self.path} must hold a mapping")
        flat: dict[str, str] = {}

        def walk(prefix: str, node) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(f"{prefix}{self.nested_separator}{k}" if prefix else str(k), v)
            else:
                flat[prefix] = "" if node is None else str(node)

        walk("", raw)
        return flat

    def get(self, key: str) -> str:
        try:
            return self._data[key]
        except KeyError:
            raise SecretNotFound(f"secret {key!r} not in {self.path}") from None

    def keys(self) -> list[str]:
        return sorted(self._data)


class StaticSecretStore(SecretStore):
    """Secrets held in memory."""

    def __init__(self, name: str, data: dict[str, str] | None = None) -> None:
        super().__init__(name)
        self._data = dict(data or {})

    def set(self, key: str, value: str) -> None:
        self._data[key] = value

    def get(self, key: str) -> str:
        try:
            return self._data[key]
        except KeyError:
            raise SecretNotFound(f"secret {key!r} not in store {self.name!r}") from None

    def keys(self) -> list[str]:
        return sorted(self._data)
