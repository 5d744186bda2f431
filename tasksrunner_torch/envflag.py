"""The environment flags the port reads.

A private copy of the parsing of ``tasksrunner.envflag.env_flag``, for
the ``TASKSRUNNER_*`` names the scorer reads. Each keeps the meaning and
default the JAX package declares for it, so one setting drives both
packages. An undeclared ``TASKSRUNNER_*`` name is refused, as it is
there. The runtime's ``TASKSRUNNER_TRACE_DB``,
``TASKSRUNNER_TRACE_RETENTION_SECONDS``,
``TASKSRUNNER_SLOW_THRESHOLD_SECONDS``, ``TASKSRUNNER_FLIGHTREC_DIR``,
``TASKSRUNNER_FLIGHTREC_RING``, ``TASKSRUNNER_HTTP_PORT`` and
``TASKSRUNNER_API_TOKEN`` are read with ``os.environ`` where they are
used (``spans``, ``metrics``, ``flightrec``, ``client``, ``app``), as the
JAX package reads them.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

_FALSE = frozenset({"0", "false", "off", "no"})

#: the TASKSRUNNER_* names the port reads
DECLARED = frozenset({
    "TASKSRUNNER_FLASH",           # bool, on: the flash kernel as attention core
    "TASKSRUNNER_ACT_F32",         # bool, off: f32 activations instead of bf16
    "TASKSRUNNER_FLASH_BWD_DELTA",  # "fused": Δ in the backward kernel (else precomputed)
    "TASKSRUNNER_ML_BATCHING",     # bool, on: micro-batching (off: batch of one)
    "TASKSRUNNER_ML_MAX_BATCH",    # int
    "TASKSRUNNER_ML_MAX_DELAY_MS",  # float
    "TASKSRUNNER_ML_BUCKETS",      # comma-separated ints
    "TASKSRUNNER_ML_MAX_QUEUE",    # int
    "TASKSRUNNER_ML_MAX_TOKENS",   # int
    "TASKSRUNNER_ADMISSION",       # bool, off: shed with 429 when saturated
    "TASKSRUNNER_ADMISSION_MAX_INFLIGHT",  # int, 64: in-flight requests at score 1.0
    "TASKSRUNNER_ADMISSION_MAX_LAG_SECONDS",  # float, 0.25: event-loop lag at score 1.0
    "TASKSRUNNER_ADMISSION_MAX_QUEUE_DEPTH",  # int, 512: write-queue depth at score 1.0
    "TASKSRUNNER_REPL_LEASE_SECONDS",  # float, 5: a lease's life (state/lease.py)
    "TASKSRUNNER_REPL_ACK_TIMEOUT_SECONDS",  # float, 10: a write's wait for its ack quorum
    "TASKSRUNNER_REPL_LOG_RETAIN",  # int, 4096: records a member keeps; past them, a snapshot
    "TASKSRUNNER_REPL_MAX_LAG_RECORDS",  # int, 256: a follower read's lag bound
    "TASKSRUNNER_RESHARD",         # bool, off: the orchestrator's placement loop
    "TASKSRUNNER_RESHARD_HEAT_THRESHOLD",  # float, 50: EWMA writes/s at which a shard is hot
    "TASKSRUNNER_RESHARD_HYSTERESIS_SECONDS",  # float, 10: how long hot before it ranks hot
    "TASKSRUNNER_RESHARD_PAUSE_BUDGET_SECONDS",  # float, 2: a routing flip's pause, warned past
    "TASKSRUNNER_FLIGHTREC",       # bool, on: the flight recorder (flightrec.py)
    "TASKSRUNNER_FLIGHTREC_DIR",   # path, .tasksrunner/flightrec: where dumps go
    "TASKSRUNNER_FLIGHTREC_RING",  # int, 256: request skeletons the ring keeps
    "TASKSRUNNER_UVLOOP",          # bool, off: uvloop's loop policy where installed
    "TASKSRUNNER_SLOW_THRESHOLD_SECONDS",  # float, 0.25: an exemplar at or above it
    "TASKSRUNNER_TRACE_DB",        # path, .tasksrunner/traces.db; empty: no recording
    "TASKSRUNNER_ACTORS",          # bool, off: the virtual-actor runtime and its routes
    "TASKSRUNNER_ACTOR_LEASE_SECONDS",  # float, 30: an actor owner's lease
    "TASKSRUNNER_ACTOR_REMINDER_POLL_SECONDS",  # float, 2: the sweep's period
    "TASKSRUNNER_ACTOR_TURN_TIMEOUT_SECONDS",  # float, 30: one turn's deadline
    "TASKSRUNNER_WORKFLOWS",       # bool, off: the workflow plane (boots actors too)
    "TASKSRUNNER_WORKFLOW_ACTIVITY_TIMEOUT_SECONDS",  # float, 30: an attempt's deadline
    "TASKSRUNNER_WORKFLOW_HISTORY_RETAIN_SECONDS",  # float, 3600: a terminal history's life
    "TASKSRUNNER_WORKFLOW_REPLAY_BATCH",  # int, 16: activities one turn runs
})


def _declared(name: str) -> str:
    if name.startswith("TASKSRUNNER_") and name not in DECLARED:
        raise LookupError(f"{name} is not a flag the port reads")
    return name


def env_flag(name: str, default: bool = True) -> bool:
    """True unless the variable is set to an explicit disable value
    (case-insensitive: 0 / false / off / no). Unset or empty →
    ``default``."""
    raw = os.environ.get(_declared(name))
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() not in _FALSE


def env_str(name: str, default: str) -> str:
    raw = os.environ.get(_declared(name))
    return default if raw is None or not raw.strip() else raw


def env_number(name: str, default: float) -> float:
    """A numeric variable; unset, empty or malformed → ``default``
    (malformed is logged)."""
    raw = os.environ.get(_declared(name))
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r; using %s", name, raw, default)
        return default
