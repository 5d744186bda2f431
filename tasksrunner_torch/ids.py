"""Cheap unique ids for telemetry and messages: the port of
``tasksrunner/ids.py``.

Trace ids, span ids, CloudEvents ids and broker message ids must be
unique, not unpredictable: they are correlation keys, never secrets.
``secrets.token_hex`` pays one ``os.urandom`` call per id, and a request
mints about five. Here each thread keeps a ``random.Random`` seeded once
from ``os.urandom`` and seeded again in a forked child, so a worker
never replays its parent's stream; an id is one ``getrandbits`` of the
full width.
"""

from __future__ import annotations

import os
import random
import threading

_local = threading.local()

#: bumped in a child after every fork; a generator of another
#: generation is thrown away
_generation = 0


def _on_fork() -> None:
    global _generation
    _generation += 1


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_on_fork)


def _rng() -> random.Random:
    rng = getattr(_local, "rng", None)
    if rng is None or getattr(_local, "gen", -1) != _generation:
        rng = random.Random(os.urandom(16))
        _local.rng = rng
        _local.gen = _generation
    return rng


def hex8() -> str:
    """16 hex digits (64 random bits): span-id sized."""
    return f"{_rng().getrandbits(64):016x}"


def hex16() -> str:
    """32 hex digits (128 random bits): trace-id and message-id sized."""
    return f"{_rng().getrandbits(128):032x}"
