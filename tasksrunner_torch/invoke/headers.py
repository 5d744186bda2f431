"""Which headers cross an invoke hop: the port of
``tasksrunner/invoke/headers.py``."""

from __future__ import annotations

#: response headers about the hop, not the payload: never forwarded
HOP_BY_HOP = frozenset({
    "content-length", "transfer-encoding", "connection",
    "keep-alive", "server", "date",
})


def inward_headers(headers: dict[str, str]) -> dict[str, str]:
    """The caller's headers forwarded to the target app: content
    negotiation and ``x-*`` application headers; cookies, credentials
    and transport headers stay behind."""
    return {
        k: v for k, v in ((k.lower(), v) for k, v in headers.items())
        if k in ("content-type", "accept") or k.startswith("x-")
    }


def outward_headers(headers: dict[str, str]) -> dict[str, str]:
    """The app's response headers less the hop-by-hop ones."""
    return {k: v for k, v in headers.items() if k.lower() not in HOP_BY_HOP}
