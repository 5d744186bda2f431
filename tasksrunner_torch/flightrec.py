"""The black-box flight recorder: the port of
``tasksrunner/observability/flightrec.py``.

Traces say what happened to one request; the flight recorder says what
a process was doing just before it went wrong, when nobody was looking.
A bounded ring per process holds the skeletons of recent requests
(name, trace id, status, duration), with a sample of the saturation
gauges at most once a second, at O(1) a request: one deque append. The
ring is written to disk as JSON on the three moments worth a
post-mortem:

* the admission controller's entry into shedding (what led up to it),
* a slow observation that kept an exemplar (through
  :func:`tasksrunner_torch.metrics.set_on_slow_exemplar`),
* an unclean exit (``atexit`` without :func:`mark_clean`; a ``kill -9``
  loses the ring, the accepted trade of a black box).

Each reason dumps at most once every five seconds. Dumps go to
``TASKSRUNNER_FLIGHTREC_DIR`` (default ``.tasksrunner/flightrec``), named
``{role}-{pid}-{unix seconds}-{reason}.json``, with the JAX payload's
keys, so either package reads the other's (:func:`list_dumps`,
:func:`read_dump`; ``python -m tasksrunner_torch flightrec``).
``TASKSRUNNER_FLIGHTREC=0`` turns it all off; off, a request costs one
``if``.
"""

from __future__ import annotations

import asyncio
import atexit
import collections
import json
import logging
import os
import pathlib
import time

from tasksrunner_torch.envflag import env_flag
from tasksrunner_torch.metrics import metrics, set_on_slow_exemplar

logger = logging.getLogger(__name__)

ENV_ENABLED = "TASKSRUNNER_FLIGHTREC"
ENV_RING = "TASKSRUNNER_FLIGHTREC_RING"
ENV_DIR = "TASKSRUNNER_FLIGHTREC_DIR"

DEFAULT_RING = 256
DEFAULT_DIR = ".tasksrunner/flightrec"

#: the saturation signals sampled into the ring: those the admission
#: controller scores, so a dump shows the shed decision's inputs beside
#: the requests before it
SAMPLED_GAUGES = (
    "admission_saturation",
    "event_loop_lag_seconds",
    "state_write_queue_depth",
    "broker_publish_queue_depth",
    "ml_queue_depth",
)

#: seconds between two gauge samples in the ring
_SAMPLE_EVERY = 1.0
#: seconds between two dumps of one reason: a shed storm or a run of slow
#: requests must not fill the disk
_MIN_DUMP_INTERVAL = 5.0


class FlightRecorder:
    """The ring of one process's request skeletons and gauge samples."""

    def __init__(self, role: str) -> None:
        self.role = role
        raw = os.environ.get(ENV_RING)
        try:
            ring_size = int(raw) if raw else DEFAULT_RING
        except ValueError:
            logger.warning("ignoring bad %s=%r (want an integer)", ENV_RING, raw)
            ring_size = DEFAULT_RING
        self.out_dir = os.environ.get(ENV_DIR) or DEFAULT_DIR
        #: a deque append is atomic under the GIL: note() takes no lock
        self._ring: collections.deque = collections.deque(maxlen=ring_size)
        self._last_sample = 0.0
        self._last_dump: dict[str, float] = {}
        self._clean = False

    def note(self, *, name: str, trace_id: str | None, status: int | None,
             duration: float) -> None:
        """One request's skeleton into the ring: no I/O, no lock."""
        now = time.time()
        entry = {"ts": now, "name": name, "trace": trace_id, "status": status,
                 "dur": duration}
        if now - self._last_sample >= _SAMPLE_EVERY:
            self._last_sample = now
            entry["gauges"] = self._sample_gauges()
        self._ring.append(entry)

    @staticmethod
    def _sample_gauges() -> dict[str, float]:
        out = {}
        for name in SAMPLED_GAUGES:
            values = metrics.gauge_values(name)
            if values:
                out[name] = max(values)  # the worst series tells the story
        return out

    def dump(self, reason: str, detail: dict | None = None) -> str | None:
        """The ring, now, written to a file; returns its path, or None
        when this reason dumped less than five seconds ago. The ring is
        copied here; the file is written by the loop's executor when a
        loop runs in this thread (the path comes back before the write
        lands), else here."""
        now = time.time()
        if now - self._last_dump.get(reason, 0.0) < _MIN_DUMP_INTERVAL:
            return None
        self._last_dump[reason] = now
        payload = {"role": self.role, "pid": os.getpid(), "reason": reason,
                   "detail": detail or {}, "ts": now, "gauges": self._sample_gauges(),
                   "entries": list(self._ring)}
        path = pathlib.Path(self.out_dir) / f"{self.role}-{os.getpid()}-{int(now)}-{reason}.json"
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return self._write_dump(path, payload, reason)
        loop.run_in_executor(None, self._write_dump, path, payload, reason)
        return str(path)

    def _write_dump(self, path: pathlib.Path, payload: dict, reason: str) -> str | None:
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(payload, default=str))
        except OSError as exc:
            # a full disk must not take the process down with it
            logger.warning("flight-recorder dump to %s failed: %s", path, exc)
            return None
        logger.warning("flight recorder dumped %d entries to %s (%s)",
                       len(payload["entries"]), path, reason)
        return str(path)

    def mark_clean(self) -> None:
        """A deliberate stop: no dump at exit."""
        self._clean = True

    def _atexit(self) -> None:
        if not self._clean and self._ring:
            self.dump("unclean-shutdown")


#: the process's recorder; None: off
_flightrec: FlightRecorder | None = None


def configure_flightrec(role: str) -> FlightRecorder | None:
    """Start this process's recorder (a sidecar does at start); on unless
    ``TASKSRUNNER_FLIGHTREC=0``. A second call returns the first one's."""
    global _flightrec
    if not env_flag(ENV_ENABLED, default=True):
        return None
    if _flightrec is None:
        _flightrec = FlightRecorder(role)
        atexit.register(_flightrec._atexit)
        set_on_slow_exemplar(_on_slow)
    return _flightrec


def note_request(*, name: str, trace_id: str | None, status: int | None,
                 duration: float) -> None:
    """What the sidecar calls for every routed request: one ``if`` when off."""
    if _flightrec is not None:
        _flightrec.note(name=name, trace_id=trace_id, status=status, duration=duration)


def mark_clean() -> None:
    if _flightrec is not None:
        _flightrec.mark_clean()


def dump(reason: str, detail: dict | None = None) -> str | None:
    if _flightrec is not None:
        return _flightrec.dump(reason, detail)
    return None


def _on_slow(metric: str, trace_id: str, value: float) -> None:
    if _flightrec is not None:
        _flightrec.dump("slow-exemplar", {"metric": metric, "trace_id": trace_id,
                                          "value": value})


# -- reading (``python -m tasksrunner_torch flightrec``) ------------------

def list_dumps(out_dir: str | pathlib.Path | None = None) -> list[dict]:
    """A summary of every dump in ``out_dir``, newest first by name."""
    root = pathlib.Path(out_dir or os.environ.get(ENV_DIR) or DEFAULT_DIR)
    rows = []
    if not root.is_dir():
        return rows
    for path in sorted(root.glob("*.json"), reverse=True):
        try:
            payload = json.loads(path.read_text())
        except (OSError, ValueError):
            continue
        rows.append({"path": str(path), "role": payload.get("role"),
                     "pid": payload.get("pid"), "reason": payload.get("reason"),
                     "ts": payload.get("ts"),
                     "entries": len(payload.get("entries") or ())})
    return rows


def read_dump(path: str | pathlib.Path) -> dict:
    return json.loads(pathlib.Path(path).read_text())
