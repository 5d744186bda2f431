"""What the sqlite state store and broker share: taking a file's write
lock, the background WAL checkpointer, and resolving callers' futures
from the thread that ran their statements."""

from __future__ import annotations

import asyncio
import sqlite3
import threading
import time
from typing import Any


def begin_immediate(cur: sqlite3.Cursor) -> None:
    """Take the file's write lock with a 0.2 → 2 ms backoff (5 s
    deadline) instead of sqlite's busy handler, whose 1 → 100 ms sleeps
    turn a convoy of short transactions into milliseconds each."""
    cur.execute("PRAGMA busy_timeout=0")
    delay = 0.0002
    deadline = time.monotonic() + 5.0
    try:
        while True:
            try:
                cur.execute("BEGIN IMMEDIATE")
                return
            except sqlite3.OperationalError as exc:
                msg = str(exc).lower()
                if ("locked" not in msg and "busy" not in msg) or time.monotonic() > deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 0.002)
    finally:
        cur.execute("PRAGMA busy_timeout=5000")


def checkpoint_loop(path: str, stop: threading.Event, dirty: list[bool]) -> None:
    """PASSIVE WAL checkpoints on a connection of their own while
    ``dirty[0]`` is set, every 0.25 s until ``stop``; one more at the end."""
    conn = None
    while not stop.wait(0.25):
        if not dirty[0]:
            continue
        dirty[0] = False
        try:
            if conn is None:
                conn = sqlite3.connect(path, timeout=1.0)
            conn.execute("PRAGMA wal_checkpoint(PASSIVE)")
        except sqlite3.Error:  # transient; the next tick retries
            dirty[0] = True
    if conn is not None:
        try:
            conn.execute("PRAGMA wal_checkpoint(PASSIVE)")
            conn.close()
        except sqlite3.Error:
            pass


def resolve_futures(pairs: list[tuple[asyncio.AbstractEventLoop, asyncio.Future, Any,
                                      BaseException | None]]) -> None:
    """Resolve futures from another thread with one wake-up per loop."""
    by_loop: dict[asyncio.AbstractEventLoop, list] = {}
    for loop, fut, value, exc in pairs:
        by_loop.setdefault(loop, []).append((fut, value, exc))
    for loop, items in by_loop.items():
        def settle(items=items) -> None:
            for fut, value, exc in items:
                if fut.done():
                    continue
                if exc is None:
                    fut.set_result(value)
                else:
                    fut.set_exception(exc)
        try:
            loop.call_soon_threadsafe(settle)
        except RuntimeError:  # the caller's loop is closed (shutdown)
            pass
