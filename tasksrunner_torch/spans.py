"""Span recording into the runtime's sqlite trace file, and its readers:
the part of ``tasksrunner/observability/spans.py`` the scorer's lanes use.

Recording is on only once :func:`configure_spans` has been given a path,
or found one in ``TASKSRUNNER_TRACE_DB`` (the apps call it at start;
``python -m tasksrunner_torch host``, ``serve``, ``sidecar`` and ``run``
default it to ``.tasksrunner/traces.db``, and an empty value turns it
off). Rows go into the JAX package's schema, so its ``trace_spans`` and the
``tasksrunner traces`` CLI read the port's spans unchanged, and the
port's readers (:func:`list_traces`, :func:`trace_spans`,
:func:`assemble_trace`, :func:`critical_path`, :func:`service_map`) read
the JAX package's. Appending is a list
append; a daemon thread flushes the buffer to sqlite every half second,
off the event loop. Off, a span costs one ``if`` (:func:`active`, or the
``None`` test in :func:`record_span`).

Spans older than ``TASKSRUNNER_TRACE_RETENTION_SECONDS`` (default 30
days; 0 or less keeps everything) are deleted by a sweep that rides a
flush at most once a minute. The JAX recorder's buffer-depth gauge is
not ported.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import pathlib
import sqlite3
import threading
import time

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
RETENTION_ENV_VAR = "TASKSRUNNER_TRACE_RETENTION_SECONDS"
DEFAULT_RETENTION_SECONDS = 30 * 24 * 3600.0
FLUSH_INTERVAL = 0.5
#: seconds between two retention sweeps
PRUNE_EVERY = 60


def _retention_from_env() -> float:
    raw = os.environ.get(RETENTION_ENV_VAR)
    try:
        return float(raw) if raw else DEFAULT_RETENTION_SECONDS
    except ValueError:
        # a telemetry knob must not stop an app from starting
        logging.getLogger(__name__).warning(
            "ignoring bad %s=%r (want seconds as a number)", RETENTION_ENV_VAR, raw)
        return DEFAULT_RETENTION_SECONDS


class SpanRecorder:
    """Buffered writer of spans into one trace file."""

    def __init__(self, role: str, path: str | pathlib.Path) -> None:
        self.role = role
        #: spans that started longer ago than this are pruned; <= 0 keeps all
        self.retention_seconds = _retention_from_env()
        self._last_prune = 0.0
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
        """Write what was appended before this call. Under the lock, so a
        flush returns only once a write in flight (the timer's) has landed
        too: a reader after it finds the file's table made."""
        with self._io_lock:
            raw = self._buffer[:]
            if not raw:
                return
            del self._buffer[:len(raw)]
            if self._conn is None:
                self._conn = sqlite3.connect(self.path, check_same_thread=False)
                self._conn.execute("PRAGMA journal_mode=WAL")
                self._conn.execute("PRAGMA busy_timeout=5000")
                self._conn.executescript(_SCHEMA)
            self._conn.executemany(
                "INSERT INTO spans VALUES (?,?,?,?,?,?,?,?,?,?)",
                [row[:9] + (json.dumps(row[9], default=str) if row[9] else "{}",)
                 for row in raw])
            now = time.time()
            if self.retention_seconds > 0 and now - self._last_prune > PRUNE_EVERY:
                self._conn.execute("DELETE FROM spans WHERE start < ?",
                                   (now - self.retention_seconds,))
                self._last_prune = now
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


# -- the readers ---------------------------------------------------------

def _connect_ro(path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True, check_same_thread=False)
    conn.row_factory = sqlite3.Row
    return conn


def list_traces(path: str, *, limit: int = 20) -> list[dict]:
    """The newest ``limit`` traces: id, start, span count, wall time, the
    roles that recorded them, and their first span as ``root``."""
    conn = _connect_ro(path)
    try:
        rows = conn.execute(
            "SELECT trace_id, MIN(start) AS started, COUNT(*) AS spans, "
            "MAX(start + duration) - MIN(start) AS wall, "
            "GROUP_CONCAT(DISTINCT role) AS roles "
            "FROM spans GROUP BY trace_id ORDER BY started DESC LIMIT ?",
            (limit,)).fetchall()
        out = []
        for r in rows:
            root = conn.execute(
                "SELECT name, role, status FROM spans WHERE trace_id = ? "
                "ORDER BY start LIMIT 1", (r["trace_id"],)).fetchone()
            out.append({
                "trace_id": r["trace_id"], "started": r["started"],
                "spans": r["spans"], "wall": r["wall"],
                "roles": sorted((r["roles"] or "").split(",")),
                "root": f"{root['role']}: {root['name']}" if root else "?",
                "status": root["status"] if root else None,
            })
        return out
    finally:
        conn.close()


def trace_spans(path: str, trace_id: str) -> list[dict]:
    """Every span of the traces whose id starts with ``trace_id``, as
    rows (``attrs`` still JSON text), in start order."""
    conn = _connect_ro(path)
    try:
        rows = conn.execute("SELECT * FROM spans WHERE trace_id LIKE ? ORDER BY start",
                            (trace_id + "%",)).fetchall()
        return [dict(r) for r in rows]
    finally:
        conn.close()


def assemble_trace(sources: list, trace_id: str) -> list[dict]:
    """One trace's spans merged from several sources, each a span file's
    path or a list of rows already fetched (a replica sidecar's
    ``/v1.0/traces/{id}``): a span seen twice counts once (by
    ``span_id``), and the rows come in start order. A file that is not a
    span file yet is skipped."""
    merged: dict[str, dict] = {}
    for source in sources:
        if isinstance(source, (str, pathlib.Path)):
            try:
                rows = trace_spans(str(source), trace_id)
            except sqlite3.Error:
                continue
        else:
            rows = [r for r in source if str(r.get("trace_id", "")).startswith(trace_id)]
        for row in rows:
            merged.setdefault(row["span_id"], dict(row))
    return sorted(merged.values(), key=lambda r: r["start"])


def critical_path(spans: list[dict]) -> list[dict]:
    """The blame chain of one trace's spans: from the earliest root, each
    hop descends into the child that ends last. Each hop reports its
    ``self_time`` (its duration less its overlap with the chosen child)
    and, where the span recorded one, its ``queue_wait`` / ``service``
    split, so the chain's self-times add up to the root's wall time."""
    if not spans:
        return []
    by_id = {s["span_id"]: s for s in spans}
    children: dict[str, list[dict]] = {}
    for s in spans:
        parent = s.get("parent_id")
        if parent and parent in by_id and parent != s["span_id"]:
            children.setdefault(parent, []).append(s)
    roots = [s for s in spans if not s.get("parent_id") or s["parent_id"] not in by_id]
    node = min(roots or spans, key=lambda s: s["start"])
    chain: list[dict] = []
    seen: set[str] = set()
    while node is not None and node["span_id"] not in seen:
        seen.add(node["span_id"])
        nxt = max(children.get(node["span_id"], []),
                  key=lambda s: s["start"] + s["duration"], default=None)
        attrs = node.get("attrs") or {}
        if isinstance(attrs, str):
            try:
                attrs = json.loads(attrs)
            except ValueError:
                attrs = {}
        end = node["start"] + node["duration"]
        hop = {
            "span_id": node["span_id"], "name": node["name"], "role": node["role"],
            "kind": node["kind"], "start": node["start"], "duration": node["duration"],
            # the overlap, not the child's duration: a child that outlives
            # its parent must not give a negative self time
            "self_time": node["duration"] - (
                max(0.0, min(end, nxt["start"] + nxt["duration"]) - nxt["start"])
                if nxt is not None else 0.0),
        }
        if "queue_wait" in attrs:
            hop["queue_wait"] = attrs["queue_wait"]
            hop["service"] = attrs.get("service", node["duration"] - attrs["queue_wait"])
        chain.append(hop)
        node = nxt
    return chain


def service_map(path: str) -> list[dict]:
    """The App-Map's edges: caller role → target, with the call count and
    mean duration, from the client and producer spans; one edge a
    (caller, kind, target), most calls first."""
    conn = _connect_ro(path)
    try:
        rows = conn.execute(
            "SELECT role, kind, "
            "COALESCE(json_extract(attrs, '$.target'), name) AS target, "
            "COUNT(*) AS n, AVG(duration) AS avg_duration "
            "FROM spans WHERE kind IN ('client', 'producer') "
            "GROUP BY role, kind, target ORDER BY n DESC").fetchall()
        return [{"from": r["role"], "to": r["target"], "kind": r["kind"], "calls": r["n"],
                 "avg_ms": round(r["avg_duration"] * 1000, 2)} for r in rows]
    finally:
        conn.close()
