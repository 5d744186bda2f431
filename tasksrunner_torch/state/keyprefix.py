"""Key prefixes that keep apps' state apart: the port of
``tasksrunner/state/keyprefix.py``.

A component's ``keyPrefix`` metadata picks the strategy: ``appid`` (the
default) stores an app's key ``k`` as ``"{app-id}||k"``, ``name`` as
``"{component}||k"``, ``none`` as ``k``, and any other literal as
``"{literal}||k"``. The runtime applies the prefix; stores only ever
see final keys.
"""

from __future__ import annotations

from tasksrunner_torch.errors import ComponentError

SEPARATOR = "||"


class KeyPrefixer:
    """The storage key of (app id, the app's key)."""

    def __init__(self, strategy: str = "appid", *, app_id: str | None = None,
                 component_name: str | None = None) -> None:
        self.strategy = strategy
        if strategy == "appid":
            self.prefix = f"{app_id}{SEPARATOR}" if app_id else ""
        elif strategy == "name":
            if not component_name:
                raise ComponentError("keyPrefix=name requires a component name")
            self.prefix = f"{component_name}{SEPARATOR}"
        elif strategy == "none":
            self.prefix = ""
        else:
            self.prefix = f"{strategy}{SEPARATOR}"

    def apply(self, key: str) -> str:
        return self.prefix + key

    def strip(self, storage_key: str) -> str:
        """The app's key of a storage key (a query's results)."""
        if self.prefix and storage_key.startswith(self.prefix):
            return storage_key[len(self.prefix):]
        return storage_key


def prefixer_for(metadata: dict, *, app_id: str | None, component_name: str) -> KeyPrefixer:
    """The component's ``keyPrefix`` strategy; ``appid`` when it is unset
    or a secret ref (a strategy is never a secret)."""
    raw = metadata.get("keyPrefix")
    return KeyPrefixer(raw if isinstance(raw, str) else "appid", app_id=app_id,
                       component_name=component_name)
