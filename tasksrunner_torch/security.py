"""Per-app component permissions: the port of ``AppGrants`` and
``grants_from_env`` in ``tasksrunner/security.py``.

Grants map a component name to the operations an app may run on it
(``read``, ``write``, ``publish``, ``subscribe``, ``invoke``), each for
every topic or for a list of topics: ``{"statestore": ["read", "write"],
"taskspubsub": [{"subscribe": ["tasksavedtopic"]}]}``. The runtime checks
them when they are given; without grants an app is unrestricted. By
building block: state ``read`` (get, bulk get, query) and ``write``
(save, delete, transaction); pub/sub ``publish`` and ``subscribe``,
optionally per topic; bindings ``invoke`` (an output binding's
operations); secret stores ``read``.

With ``per_app_tokens`` the orchestrator gives each app a token of its
own and writes the sha256 digests of all of them to the file that
``TASKSRUNNER_TOKENS_FILE`` names (:func:`load_token_map`): a sidecar
takes a peer's token, checked by its digest (:func:`hash_token`), on
inbound service invocation only, as ``tasksrunner/security.py`` does.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
from dataclasses import dataclass, field

from tasksrunner_torch.errors import ComponentError, PermissionDenied

#: the JSON grants of the app a replica runs, as the JAX orchestrator sets them
GRANTS_ENV = "TASKSRUNNER_GRANTS"
#: the JSON file of app_id → token digest, set for every replica when the
#: orchestrator runs with ``per_app_tokens: true``
TOKENS_FILE_ENV = "TASKSRUNNER_TOKENS_FILE"
_KNOWN_OPS = {"read", "write", "publish", "subscribe", "invoke"}


@dataclass
class AppGrants:
    #: component name → {operation → allowed topics, or None for every topic}
    components: dict[str, dict[str, list[str] | None]] = field(default_factory=dict)

    @classmethod
    def parse(cls, raw: object, *, app_id: str = "?") -> AppGrants:
        """The ``grants:`` block: per component, a list of operation
        names or single-key ``{operation: [topics]}`` mappings."""
        if raw is None:
            raw = {}
        if not isinstance(raw, dict):
            raise ComponentError(
                f"grants for app {app_id!r} must be a mapping of component name to "
                f"operation list, got {type(raw).__name__}")
        components: dict[str, dict[str, list[str] | None]] = {}
        for comp, entries in raw.items():
            entries = [entries] if isinstance(entries, str) else (entries or [])
            if not isinstance(entries, list):
                raise ComponentError(f"grants[{comp}] for app {app_id!r} must be a list "
                                     "of operations")
            ops: dict[str, list[str] | None] = {}
            for entry in entries:
                if isinstance(entry, str):
                    op, topics = entry, None
                elif isinstance(entry, dict) and len(entry) == 1:
                    op, topic_list = next(iter(entry.items()))
                    topic_list = [topic_list] if isinstance(topic_list, str) else topic_list
                    if not isinstance(topic_list, list):
                        raise ComponentError(f"grants[{comp}] for app {app_id!r}: topic "
                                             f"restriction for {op!r} must be a list")
                    topics = [str(t) for t in topic_list]
                else:
                    raise ComponentError(f"grants[{comp}] for app {app_id!r}: each entry "
                                         "must be an op string or {op: [topics]}")
                op = str(op)
                if op not in _KNOWN_OPS:
                    raise ComponentError(f"grants[{comp}] for app {app_id!r}: unknown "
                                         f"operation {op!r} (known: {sorted(_KNOWN_OPS)})")
                if op not in ops:
                    ops[op] = topics
                elif ops[op] is None or topics is None:
                    ops[op] = None  # an unrestricted grant absorbs a restricted one
                else:
                    ops[op] = ops[op] + topics
            components[str(comp)] = ops
        return cls(components=components)

    def to_json(self) -> dict:
        """The grants in the ``grants:`` block's own form."""
        return {comp: [op if topics is None else {op: topics} for op, topics in ops.items()]
                for comp, ops in self.components.items()}

    def check(self, component: str, op: str, *, topic: str | None = None,
              app_id: str | None = None) -> None:
        """Raise :class:`PermissionDenied` unless ``op`` (on ``topic``)
        is granted on ``component``."""
        ops = self.components.get(component)
        if ops is None or op not in ops:
            raise PermissionDenied(
                f"app {app_id or '?'} has no {op!r} grant on component {component!r} "
                f"(granted: {sorted(self.components.get(component, {})) or 'nothing'})")
        topics = ops[op]
        if topics is not None and topic is not None and topic not in topics:
            raise PermissionDenied(f"app {app_id or '?'} may {op} on {component!r} only "
                                   f"for topics {topics}, not {topic!r}")


def grants_from_env() -> AppGrants | None:
    """The grants in ``TASKSRUNNER_GRANTS`` (JSON); None when unset."""
    raw = os.environ.get(GRANTS_ENV)
    if not raw:
        return None
    return AppGrants.parse(json.loads(raw), app_id=os.environ.get("TASKSRUNNER_APP_ID", "?"))


def hash_token(token: str) -> str:
    """The sha256 hex digest of a peer token: what sidecars store and
    compare, so no replica holds another app's token."""
    return hashlib.sha256(token.encode()).hexdigest()


def load_token_map(path: str | pathlib.Path | None = None) -> dict[str, str]:
    """app_id → token digest, from ``path`` or the file
    ``TASKSRUNNER_TOKENS_FILE`` names; empty when neither is set."""
    if path is None:
        path = os.environ.get(TOKENS_FILE_ENV)
    if not path:
        return {}
    p = pathlib.Path(path)
    try:
        doc = json.loads(p.read_text())
    except OSError as exc:
        raise ComponentError(f"cannot read token map {p}: {exc}") from exc
    except ValueError as exc:
        raise ComponentError(f"token map {p} is not valid JSON: {exc}") from exc
    if not isinstance(doc, dict):
        raise ComponentError(f"token map {p} must be a JSON object")
    return {str(k): str(v) for k, v in doc.items()}
