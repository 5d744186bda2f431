"""Span recording into the runtime's sqlite trace file: the part of
``tasksrunner/observability/spans.py`` the scorer's lanes use.

Recording is on only once :func:`configure_spans` has been given a path,
or found one in ``TASKSRUNNER_TRACE_DB`` (the hosts call it at start).
Rows go into the JAX package's schema, so its ``trace_spans`` and the
``tasksrunner traces`` CLI read the port's spans unchanged. Appending
is a list append; a daemon thread flushes the buffer to sqlite every
half second, off the event loop. Off, a span costs one ``if``
(:func:`active`, or the ``None`` test in :func:`record_span`).

The JAX recorder's retention sweep and buffer-depth gauge are not
ported: the port's spans live as long as the file the caller names.
"""

from __future__ import annotations

import atexit
import json
import os
import pathlib
import sqlite3
import threading

_SCHEMA = """
CREATE TABLE IF NOT EXISTS spans (
    trace_id TEXT NOT NULL,
    span_id  TEXT NOT NULL,
    parent_id TEXT,
    role     TEXT NOT NULL,
    kind     TEXT NOT NULL,    -- server | client | producer | consumer
    name     TEXT NOT NULL,
    status   INTEGER,
    start    REAL NOT NULL,
    duration REAL NOT NULL,
    attrs    TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_spans_trace ON spans (trace_id, start);
CREATE INDEX IF NOT EXISTS idx_spans_start ON spans (start);
"""

ENV_VAR = "TASKSRUNNER_TRACE_DB"
FLUSH_INTERVAL = 0.5


class SpanRecorder:
    """Buffered writer of spans into one trace file."""

    def __init__(self, role: str, path: str | pathlib.Path) -> None:
        self.role = role
        self.path = str(path)
        pathlib.Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        #: column tuples, attrs still a dict (serialised at flush); an
        #: append races a flush safely: flush takes a copy of the head
        #: and deletes only that slice
        self._buffer: list[tuple] = []
        self._io_lock = threading.Lock()
        self._conn: sqlite3.Connection | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._flush_loop, name="span-flush",
                                        daemon=True)
        self._thread.start()
        atexit.register(self.close)

    def _flush_loop(self) -> None:
        while not self._stop.wait(FLUSH_INTERVAL):
            self.flush()

    def append(self, trace_id, span_id, parent_id, kind, name, status,
               start, duration, attrs) -> None:
        self._buffer.append((trace_id, span_id, parent_id, self.role,
                             kind, name, status, start, duration, attrs))

    def flush(self) -> None:
        raw = self._buffer[:]
        if not raw:
            return
        del self._buffer[:len(raw)]
        with self._io_lock:
            if self._conn is None:
                self._conn = sqlite3.connect(self.path, check_same_thread=False)
                self._conn.execute("PRAGMA journal_mode=WAL")
                self._conn.execute("PRAGMA busy_timeout=5000")
                self._conn.executescript(_SCHEMA)
            self._conn.executemany(
                "INSERT INTO spans VALUES (?,?,?,?,?,?,?,?,?,?)",
                [row[:9] + (json.dumps(row[9], default=str) if row[9] else "{}",)
                 for row in raw])
            self._conn.commit()

    def close(self) -> None:
        atexit.unregister(self.close)
        self._stop.set()
        self._thread.join()
        self.flush()
        with self._io_lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None


#: the process's recorder; None = recording off
_recorder: SpanRecorder | None = None


def configure_spans(role: str, path: str | pathlib.Path | None = None) -> SpanRecorder | None:
    """Record this process's spans into ``path``, else into the file
    ``TASKSRUNNER_TRACE_DB`` names; with neither, recording stays as it
    is. Replaces (and closes) an earlier recorder."""
    global _recorder
    path = path or os.environ.get(ENV_VAR)
    if not path:
        return None
    if _recorder is not None:
        _recorder.close()
    _recorder = SpanRecorder(role, path)
    return _recorder


def close_spans() -> None:
    """Flush and stop recording."""
    global _recorder
    if _recorder is not None:
        _recorder.close()
        _recorder = None


def recorder() -> SpanRecorder | None:
    return _recorder


def active() -> bool:
    """True when this process records spans: the one test a hot path
    makes before any per-span work."""
    return _recorder is not None


def record_span(*, kind: str, name: str, status: int | None, start: float,
                duration: float, trace_id: str, span_id: str,
                parent_id: str | None = None, attrs: dict | None = None) -> None:
    """One span, with its ids given: the lanes that record run off the
    request's task (the batcher's worker), so no ambient context is
    read."""
    rec = _recorder
    if rec is not None:
        rec.append(trace_id, span_id, parent_id, kind, name, status,
                   start, duration, attrs)
