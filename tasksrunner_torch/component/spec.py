"""Component documents and the two schemas that produce them: the port of
``tasksrunner/component/spec.py``.

Every pluggable backend is configured by a named, typed, scoped
component document, in one of two dialects that parse into one
:class:`ComponentSpec`:

* the local dialect (``apiVersion`` / ``kind: Component`` / ``spec``);
* the cloud dialect (flattened: ``componentType`` / ``version`` /
  ``metadata`` / ``secrets`` / ``scopes``), whose name comes from the
  file or the caller.

A metadata value is given three ways, as in the JAX package:

* inline, as ``value``;
* ``secretKeyRef: {name, key}`` (local dialect), resolved against the
  secret store that ``auth.secretStore`` names;
* ``secretRef: <name>`` (cloud dialect), resolved here against the
  document's own ``secrets:`` list first, else left as a
  :class:`SecretRef` to the store that ``secretStoreComponent`` names.

A :class:`SecretRef` is resolved by the registry when it builds the
component (:mod:`tasksrunner_torch.secrets.resolver`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

from tasksrunner_torch.errors import ComponentError


def scalar_str(value: Any) -> str:
    """A YAML scalar as the string a driver expects: ``true`` and
    ``false`` for booleans (not Python's ``True``), ``""`` for null."""
    if value is None:
        return ""
    if value is True:
        return "true"
    if value is False:
        return "false"
    return str(value)


def metadata_bool(metadata: Mapping[str, Any], key: str, default: bool) -> bool:
    """A string-typed metadata value as a bool; anything but the usual
    spellings is a :class:`ComponentError`."""
    raw = metadata.get(key)
    if raw is None or raw == "":
        return default
    val = str(raw).strip().lower()
    if val in ("1", "true", "yes", "on"):
        return True
    if val in ("0", "false", "no", "off"):
        return False
    raise ComponentError(f"metadata {key!r} must be a boolean, not {raw!r}")


def metadata_int(metadata: Mapping[str, Any], key: str, default: int) -> int:
    """A string-typed metadata value as an int, failing loudly."""
    raw = metadata.get(key)
    if raw is None or raw == "":
        return default
    try:
        return int(str(raw).strip())
    except ValueError:
        raise ComponentError(
            f"metadata {key!r} must be an integer, not {raw!r}") from None


@dataclass(frozen=True)
class SecretRef:
    """A secret to look up: ``key`` in secret store ``store``; a ``store``
    of None is the runtime's default store."""

    key: str
    store: str | None = None


@dataclass
class ComponentSpec:
    """A parsed, dialect-neutral component definition."""

    name: str
    type: str
    version: str = "v1"
    #: plain strings, or SecretRef for a secret looked up at build time
    metadata: dict[str, str | SecretRef] = field(default_factory=dict)
    #: app ids allowed to use this component; empty = visible to all
    scopes: list[str] = field(default_factory=list)
    #: the cloud dialect's inline ``secrets:`` list
    inline_secrets: dict[str, str] = field(default_factory=dict)
    #: the secret store of refs that name none
    secret_store: str | None = None
    #: where the spec was loaded from (diagnostics only)
    source: str | None = None

    def in_scope(self, app_id: str | None) -> bool:
        """Whether ``app_id`` may use this component; ``None`` (no app
        identity) sees everything."""
        if not self.scopes or app_id is None:
            return True
        return app_id in self.scopes

    @property
    def block(self) -> str:
        """The building-block family, the first dot-segment of ``type``:
        ``state.sqlite`` → ``state``."""
        return self.type.split(".", 1)[0]


def _metadata_items(raw: Any, *, where: str) -> list[Mapping[str, Any]]:
    if raw is None:
        return []
    if not isinstance(raw, list):
        raise ComponentError(f"{where}: metadata must be a list of items")
    for item in raw:
        if not isinstance(item, Mapping) or "name" not in item:
            raise ComponentError(f"{where}: each metadata item needs a name")
    return raw


def _parse_scopes(raw: Any, *, where: str) -> list[str]:
    if raw is None:
        return []
    if not isinstance(raw, list) or not all(isinstance(s, str) for s in raw):
        raise ComponentError(f"{where}: scopes must be a list of app-ids")
    return list(raw)


def parse_local_schema(doc: Mapping[str, Any], *, default_name: str,
                       source: str | None = None) -> ComponentSpec:
    """The local dialect (``kind: Component`` + ``spec``)."""
    where = source or default_name
    meta = doc.get("metadata") or {}
    name = meta.get("name") or default_name
    spec = doc.get("spec")
    if not isinstance(spec, Mapping) or "type" not in spec:
        raise ComponentError(f"{where}: missing spec.type")

    auth = doc.get("auth") or {}
    secret_store = auth.get("secretStore")

    metadata: dict[str, str | SecretRef] = {}
    for item in _metadata_items(spec.get("metadata"), where=where):
        key = str(item["name"])
        if "secretKeyRef" in item:
            ref = item["secretKeyRef"] or {}
            metadata[key] = SecretRef(key=str(ref.get("key") or ref.get("name") or key),
                                      store=secret_store)
        elif "value" in item:
            metadata[key] = scalar_str(item["value"])
        else:
            raise ComponentError(f"{where}: metadata item {key!r} needs value or secretKeyRef")

    return ComponentSpec(
        name=str(name), type=str(spec["type"]), version=str(spec.get("version", "v1")),
        metadata=metadata, scopes=_parse_scopes(doc.get("scopes"), where=where),
        secret_store=secret_store, source=source)


def parse_cloud_schema(doc: Mapping[str, Any], *, default_name: str,
                       source: str | None = None) -> ComponentSpec:
    """The cloud dialect (flattened ``componentType``); the document
    carries no name, so ``default_name`` (the file's stem or the
    caller's) supplies it."""
    where = source or default_name
    ctype = doc.get("componentType")
    if not ctype:
        raise ComponentError(f"{where}: missing componentType")

    secret_store = doc.get("secretStoreComponent")

    inline_secrets: dict[str, str] = {}
    for item in doc.get("secrets") or []:
        if not isinstance(item, Mapping) or "name" not in item:
            raise ComponentError(f"{where}: each secrets item needs a name")
        inline_secrets[str(item["name"])] = scalar_str(item.get("value", ""))

    metadata: dict[str, str | SecretRef] = {}
    for item in _metadata_items(doc.get("metadata"), where=where):
        key = str(item["name"])
        if "secretRef" in item:
            ref_name = str(item["secretRef"])
            if ref_name in inline_secrets:
                metadata[key] = inline_secrets[ref_name]
            else:
                metadata[key] = SecretRef(key=ref_name, store=secret_store)
        elif "value" in item:
            metadata[key] = scalar_str(item["value"])
        else:
            raise ComponentError(f"{where}: metadata item {key!r} needs value or secretRef")

    return ComponentSpec(
        name=str(doc.get("name") or default_name), type=str(ctype),
        version=str(doc.get("version", "v1")), metadata=metadata,
        scopes=_parse_scopes(doc.get("scopes"), where=where), inline_secrets=inline_secrets,
        secret_store=secret_store, source=source)


def parse_component(doc: Mapping[str, Any], *, default_name: str,
                    source: str | None = None) -> ComponentSpec:
    """Dispatch on the dialect."""
    if not isinstance(doc, Mapping):
        raise ComponentError(f"{source or default_name}: component document must be a mapping")
    if "componentType" in doc:
        return parse_cloud_schema(doc, default_name=default_name, source=source)
    if doc.get("kind") == "Component" or "spec" in doc:
        return parse_local_schema(doc, default_name=default_name, source=source)
    raise ComponentError(
        f"{source or default_name}: unrecognised component schema "
        "(expected kind: Component or componentType)")
