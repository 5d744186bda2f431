"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Drives ``tasksrunner_torch`` end to end on the card and fails (non-zero
exit, traceback) at the first phase that does not hold:

1. device: the card's name and power limit, the CUDA version;
2. build: every kernel of the paths compiled with nvcc from ``csrc/``,
   one nvcc per source, all started together, with ``-Xptxas -v``'s
   registers and spills of each kernel of ``flash_fwd.cu``,
   ``flash_bwd.cu`` (the ring's backward variant included) and
   ``flash_ring.cu``;
3. kernel vs plain: each kernel's wrapper against its plain PyTorch
   version on the card, at the shapes the serving, training and
   sequence-parallel paths and the bench config give it, in bf16 and
   f32: the forward, the backward with Δ precomputed and fused, the
   ring block update from the ring's first step and from a later one
   (and its in-place read of the visiting block against rolled inputs),
   and the ring's backward step at every step of a ring of sp 4;
4. matmul: the f32-activation product on the card against the CPU's;
   C1: the bf16-activation product at the served and bench shapes against
   the f32 product of the same bf16 inputs rounded once, with cuBLAS's
   reduced-precision reduction allowed and not (at most one bf16 step);
5. gradient: ``FlashAttention``'s gradients against autograd through
   the einsum core;
6. ring: ``ring_attention`` at sp 2 and 4 against the dense flash
   forward, and its gradients against autograd through the einsum core,
   at the bench config's attention shape;
7. forward: the model with the flash kernel against the same params with
   ``TASKSRUNNER_FLASH=0``, at the served and the bench config, with one
   kernel launch per layer;
8. serve: the scorer's HTTP server on 127.0.0.1 answering concurrent
   ``POST /score`` requests, with the launch counts set to 0 just before
   and read just after;
8a. runtime: the scorer hosted on the port's in-process runtime
   (``hosting.InProcHost``, a ``scores`` store and a ``taskspubsub``
   broker) beside a publisher app: events published during warm-up are
   deferred with 503 + Retry-After and stored; a burst of saved-task
   events and ``POST /score`` calls through ``invoke_method`` stores
   every event with the synchronous lane's score; with
   ``TASKSRUNNER_ADMISSION=1`` and a small token budget a flood is shed
   at the front door with 429 + Retry-After and every event is still
   stored; the launch counts set to 0 just before each host and read
   just after. The burst records its spans (``TASKSRUNNER_TRACE_DB``):
   every ``/score`` call's client → server → ``ml-request`` chain with
   its ``ml-batch``, every event's producer → consumer, the p50 and max
   of a call's segments (client total, dispatch, queue wait, batch
   service) and the critical path of the slowest queue-wait exemplar's
   trace; the loop's lag is printed for the burst and the flood, and the
   admission score at the first shed; then ``make_app()`` served by
   ``App.start`` answers ``GET /tasksrunner/stats`` (401 without the
   token, a held ``/score`` counted in flight and the probe not,
   ``requests_total`` one up per ``/score``);
8b. sidecar: the scorer behind the port's own sidecar processes
   (``python -m tasksrunner_torch sidecar``) over the sample's sqlite
   store and broker component files, paths rewritten into a temp
   directory, beside a publisher app's sidecar on the same broker file:
   16 events published while the scorer's warm-up is held (each deferred
   with 503 + Retry-After), then 48 events and 32 ``POST /score`` calls
   through the publisher's sidecar (two sidecar hops); every event's
   stored score, read back through ``GET /scores/{id}``, equals the
   ``/score`` answer for its text; the store file holds every key, the
   broker file no dead letter and no delivery charged more than one
   attempt; then the scorer's sidecar is stopped with SIGTERM and the app
   stopped, 16 events are published into the broker file, both restart
   and every one is stored; last ``python -m tasksrunner_torch host``
   answers ``/v1.0/healthz`` and one ``/score``. Prints event-to-stored,
   two-hop ``/score`` and the restart's drain time beside the card's
   name and power limit; launch counts set to 0 just before and read
   just after;
8c. orchestrator: ``python -m tasksrunner_torch run`` over a run file
   whose one app is the scorer, 1 to 3 replicas (each a ``host`` process
   on the card) by the broker file's backlog, +1 per 16 events, a 3 s
   cooldown and liveness probes every second, beside a publisher's
   sidecar in the same registry: 32 events on one replica (its ceiling
   held at 1 by a ``POST /admin/apps/…/scale``, then put back); a burst of
   192 and the scaler's decision, each new replica's ready line and first
   stored score (publishing on while they start, so the backlog holds);
   192 events on three replicas; 32 ``/score`` calls through the
   publisher's sidecar answered by two replicas or more; ``kill -9`` of
   replica 1 in a burst of 64 and its restart, a ``POST
   /admin/apps/…/scale`` holding three replicas from the kill until that
   burst has drained, another setting the floor back to 1, and the
   scale-in after the cooldown; then SIGTERM. Every event
   stored once, no dead letter, each stored score within 2e-2 of the
   scorer's in this process; the replicas' contexts on the card while
   they serve and none after the stop, none left in the registry; each
   replica that stopped cleanly logged B1 launches equal to what its last
   ``/ml/stats`` gives. Prints events/s on one and three replicas,
   event-to-stored, spawn → ready, crash → ready, the scale-in, ``/score``
   and the card's memory;
8d. deploy: ``python -m tasksrunner_torch deploy`` on a manifest of the
   scorer (1 to 2 replicas by backlog, per-app tokens, a required API
   token, a secret from the deploying environment) whose ``scores`` store
   (the sample's cloud-dialect file) takes its database path by
   ``secretRef`` from a file secret store: ``validate`` (exit 0; a broken
   copy with the sample's ``bindings.cron`` component, whose scope names
   no app, exits 1 with that problem), ``what-if``, ``apply``, ``what-if`` (no
   changes); ``run`` on the applied run file, the floor held at 2; a
   publisher's sidecar whose resources hold the applied components and
   the sample's Resiliency document retargeted at the scorer (timeout
   and retry; the breaker left out); 64 events, each stored once in the
   file the secret names, no dead letter, scores within 2e-2; the
   secrets route 200 through the scorer's sidecar, 403 through the
   publisher's (no grant), 401 with the deploying token, and ``secret``
   through the registry; 64 two-hop ``/score`` calls in four waves, one
   replica killed with SIGKILL in the second, every call 200 and the
   caller's ``resiliency_retry_total`` printed; SIGTERM (nothing left on
   the card or in the registry, each clean stop's B1 launches equal to
   its ``/ml/stats``); ``down``, then ``what-if`` lists the environment
   again. Prints each verb's seconds, spawn → ready, crash → ready,
   events/s, the retries and the card's memory a replica;
8e. bindings: ``python -m tasksrunner_torch run`` over a run file whose
   one app is the scorer, 1 to 3 replicas by a ``queue-backlog`` rule on
   the sample's storage-queue binding (+1 per 16 messages, a 3 s
   cooldown), its file rewritten to feed ``/on-task-saved`` from a queue
   in a temp directory (``maxRetries`` and ``retryDelaySeconds`` set so a
   replica's warm-up 503s cannot use up a message), beside the sample's
   blob and SendGrid bindings: 32 messages from an outside producer
   (``bindings.SqliteQueue.send``) on one replica (its ceiling held at
   1), a burst of 192 and the scaler's decision on the backlog, messages
   sent on until both new replicas stored a score, 192 on three; a
   message that is no task (acked, nothing stored); the queue's ``create``
   (scored and stored), a blob's ``create`` and ``get`` (equal bytes) and
   one mail through a replica's sidecar; the scores read back through
   ``POST /v1.0/state/scores/query`` (EQ on ``priority``, sorted by
   ``confidence`` DESC, 50 a page), their union the store's keys and each
   value its ``GET``; every message acked once over the replicas'
   deliveries, no dead letter, a backlog of 0; the floor back at 1, the
   scale-in, SIGTERM, each clean stop's B1 launches equal to its
   ``/ml/stats``, each stored score within 2e-2 of the scorer's in this
   process. Prints messages/s on one and three replicas,
   enqueue → stored, backlog → decision, spawn → ready, the retries, the
   query's ms a page and the card's memory a replica;
8f. observability: ``python -m tasksrunner_torch run`` over a run file of
   the scorer at exactly two replicas (``TASKSRUNNER_ADMISSION=1``, an
   in-flight line of 4) and a caller app, every process recording spans
   into a file of its own, one flight-recorder directory,
   ``TASKSRUNNER_SLOW_THRESHOLD_SECONDS=0.02`` and an API token: 32
   two-hop ``/score`` calls through the caller's sidecar, each in a known
   trace, all 200; ``GET /admin/traces/{id}`` of each, from all three
   sidecars: the caller's client span, the replica sidecar's hop to its
   app, the app's ``POST /score`` and ``ml-request`` (one chain), and the
   ``ml-batch`` of the batch trace it names. The caller's piece and the
   replica's share the trace id but are not linked: no sidecar records a
   span for the request it receives, so the replica's hop names a parent
   that no file holds. So ``traces critical`` over all the span files is
   the caller's span alone (1 hop over 4 spans); over the replicas' files
   it is the hop, ``POST /score`` and ``ml-request``, and of a batch
   trace ``ml-batch``; each replica's ``/metrics`` 401 without the token,
   text 0.0.4 with it, one ``# TYPE`` a name, buckets nondecreasing to
   ``+Inf`` = ``_count``, ``ml_batches_total`` over both equal to their
   ``/ml/stats``; ``metrics scorer --percentiles`` merging both; 64
   closed-loop callers on replica 0's sidecar, each shed with 429 +
   Retry-After, and the ``admission-shed`` dump (its ``invoke`` entries the
   phase's traces, ``ml_queue_depth`` and ``admission_saturation`` among
   its gauges) beside a ``slow-exemplar`` one, listed and rendered by
   ``flightrec``; a request that fails in the app (``/scores`` has no
   store) logged with ``role=scorer`` and its trace, read by ``logs``;
   SIGTERM, no ``unclean-shutdown`` dump, each clean stop's B1 launches
   equal to its ``/ml/stats``. Prints the admin call's ms, the two-hop
   calls', the chains, the dumps and the card's memory;
8g. placement: ``python -m tasksrunner_torch run`` with
   ``TASKSRUNNER_RESHARD=1`` over one scorer replica whose ``scores`` store
   (the sample's file) is ``state.sqlite`` on 4 shards of 3 members
   (``replicas: 3``, a leased leader a shard, ack after replication) with
   a fixed ``hashSeed``: a burst of 256 saved-task events (published by a
   runtime in this process) and 16 ``/score`` calls through the replica's
   sidecar; every event's key in the ``scores-shardN.db`` file
   ``ShardRouter`` names and in no other, no shard empty, and on the 3
   member files of that shard, which stand at one ``repl_meta`` hwm; the
   meta file's 4 leases; 8 reads with the placement-epoch
   header at epoch 1 answered 200 and at epoch 0 answered 409 with the
   header at 1, ``placement_stale_routes_total`` 8; a transaction over
   keys on two shards commits both, the same with one stale etag is a 409
   that changes neither; one paged query (50 a page) returns every key
   once; ``/admin/placement`` and ``python -m tasksrunner_torch shards``
   show the store at epoch 1 on 4 shards, every shard's rate above 0, the
   plan field and each shard's leader (the lease's owner), from a sweep
   after the burst; SIGTERM, the replica's B1 launches equal to its
   ``expected_serve_launches``, ``python -m tasksrunner_torch repl`` on
   the files: 4 shards, each leader named, 3 members each; the stored
   scores within 2e-2 of the scorer's in this process. Then, in this
   process, two stores each take 1024 scores that the model computes on
   the card while a writer goes on scoring and storing. A plain store on
   4 shards (one member each) is split to 5. A store built from component
   metadata on 4 shards of 3 members (a 1 s lease) has shard 0's
   leadership handed to a follower (``migrate_shard(0, member=…)``:
   epoch 2), shard 1's leader crashed while a batch's writes are in
   flight (the seconds until a new leader acks a write; every write
   acked on that shard reads back from the new leader and the surviving
   follower; a write the crash left unacknowledged failed with a state
   error, on that shard alone) and is split to 5 (a new set of 3
   members). For each split: every acknowledged write reads back, the
   moved share of the 1024 keys within 0.12–0.28, each key on the one
   shard its router names (and on all its members), each flip's pause
   within ``TASKSRUNNER_RESHARD_PAUSE_BUDGET_SECONDS`` (2 s), and the
   writers' B1 launches ``n_layers`` a batch. Prints the events/s, the
   replica's commits, the records replicated, the stale 409s, the
   transaction's ms, the query's ms a page, the ranking, the verbs'
   lines, the handoff's pause, the failover's seconds and the splits'
   numbers;
8h. workflows: two ``python -m tasksrunner_torch host`` replicas of the
   scorer on the card, over one sqlite actor store (the sample's store
   file with ``actorStateStore: "true"`` and no read cache),
   ``TASKSRUNNER_WORKFLOWS=1``, a
   1 s actor lease and a 0.25 s sweep; the app (a module the phase
   writes) adds a ``ScoreTally`` actor, a ``triage`` workflow (an
   activity collects 32 saved tasks from the store, ``when_all`` runs one
   ``score-task`` activity a task, each calling ``POST /score`` through
   the sidecar's service invocation and staging ``score||{taskId}``, a
   last activity adds the batch to an owner's ``ScoreTally``) and the
   sample's ``checkout`` saga. 8 triage instances started through the two
   sidecars at once; 64 ``ScoreTally`` turns sent to each sidecar at once,
   half of them forwarded to the other process; 4 checkouts, 2 above the
   card limit; the ``actors`` and ``workflows`` verbs; a long triage (24
   sequential steps) whose owner is killed with SIGKILL after 3 committed
   steps and which the survivor adopts. Every instance completes with
   contiguous activity seqs, every score stored once and within 2e-2 of
   the scorer's in this process, each tally the sum of its acknowledged
   turns, no reservation left by a compensated checkout, the adopted
   record's epoch above its epoch at the kill, and the survivor's B1
   launches (its clean stop)
   its ``expected_serve_launches``. Prints instances/s, turns/s, the
   forwarded turns' p50, the failover's seconds (the kill to the
   survivor's first committed step), the drive reminder's firings on the
   survivor and the history lengths;
9. train: SGD steps at the served config (loss falls; one forward and
   one backward launch per layer and step), one step with the flash core
   against one with the einsum core (and again with the fused-Δ
   backward), then steps at the bench config, with the launch counts
   set to 0 just before and read just after;
10. sequence parallel: the model with ``Mesh(sp=4)`` at the bench config
    (forward and one train step) and ``Mesh(sp=2)`` at the served config
    (one train step) against the single-device flash path from the same
    params, with the launch counts set to 0 just before and read just
    after: ``n_layers × sp`` ring launches per forward and as many ring
    backward launches per step, no dense one, and no rotation of K/V;
11. sharded: the train step sharded dp × sp × tp over spawned ranks, all
    on this card over gloo (collectives through the host), each rank held
    against the single-device step from the same params:
    ``graft_entry.dryrun_multichip(8)`` (2 × 2 × 2 at the dryrun config),
    then the bench config at batch 32 and lr 1e-3 over (2, 1, 2), which
    runs B1 and B2, and (2, 2, 2), which runs B4 and the ring's backward;
    every rank's launch counts are set to 0 just before its step and read
    just after;
12. times: kernel, plain version, the PyTorch library call
    (``scaled_dot_product_attention`` and its backward, timed here only
    as a yardstick; none computes the ring's state update or its
    backward step) and the bound, from CUDA events; the forward's time
    per bucket and the train step's at both configs; ring attention
    against dense attention, the sequence-parallel forward and train
    step with the step's peak memory, and the host's cost per call on
    the served sp-2 path; the kernels at the sharded phase's per-rank
    shapes;
13. profile: the forward's and the train step's device busy share and
    largest kernels, from ``torch.profiler``, single-device and at sp 4;
14. bench: ``bench.py``'s lanes on the port (``tasksrunner_torch.bench``):
    the bench-config train step with the flash and the einsum core (time,
    TFLOP/s, MFU, one B1 and one B2 launch per layer and step under flash,
    none under einsum), and the serial and batched ``/score`` lanes and
    the flood drill on the in-process host (no mismatch, no recompile,
    every 429 with Retry-After, the flood's queue wait within its bound),
    with the launch counts set to 0 just before and read just after.

Earlier lines are JSON records, the last of them (``clock``) each
phase's seconds and the run's; the line before the last holds every
kernel's numbers; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import re
import signal
import socket
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from tasksrunner_torch import (  # noqa: E402
    _kernels, bench, cli, flash, graft_entry, model, ring, service, spans, train,
)
from tasksrunner_torch.app import App  # noqa: E402
from tasksrunner_torch.client import TOKEN_ENV, TOKEN_HEADER, http_request  # noqa: E402
from tasksrunner_torch.component.loader import load_components  # noqa: E402
from tasksrunner_torch.component.registry import ComponentRegistry  # noqa: E402
from tasksrunner_torch.component.spec import parse_component  # noqa: E402
from tasksrunner_torch.errors import StateError  # noqa: E402
from tasksrunner_torch.hosting import InProcHost  # noqa: E402
from tasksrunner_torch.metrics import metrics  # noqa: E402
from tasksrunner_torch.probes import LAG_GAUGE  # noqa: E402
from tasksrunner_torch.pubsub import InMemoryBroker  # noqa: E402
from tasksrunner_torch.runtime import Runtime  # noqa: E402
from tasksrunner_torch.state import InMemoryStateStore, placement, replication  # noqa: E402
from tasksrunner_torch.state.sharding import ShardRouter  # noqa: E402
from tasksrunner_torch.state.sqlite import build_sharded_store  # noqa: E402
from tasksrunner_torch.mesh import Mesh  # noqa: E402
from tasksrunner_torch.model import ModelConfig, forward, init_params  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

SERVED = ModelConfig(n_classes=len(service.PRIORITY_LABELS))
# bench.py's bench config: vocab 32768, s 512, d 1024, 16 heads, ff 4096, 8 layers
BENCH = ModelConfig(vocab=32768, seq_len=512, d_model=1024, n_heads=16,
                    d_ff=4096, n_layers=8)
BENCH_BATCH = 32
SERVED_BATCH = 8
BENCH_SP, SERVED_SP = 4, 2
# the sharded phase's meshes (dp, sp, tp) at the bench config, and the
# per-rank attention shapes they give B1/B2 and the ring kernels
SHARDED_MESHES = ((2, 1, 2), (2, 2, 2))
SHARDED_DENSE = (BENCH_BATCH // 2, 512, 8, 64)
SHARDED_RING = (BENCH_BATCH // 2, 256, 256, 8, 64)

# the plain version rounds p to bf16 against the final row max, the kernel
# against the running max of the key tiles seen so far: the two differ by
# one bf16 rounding of p (2^-8 relative) in each term, and a bf16 output
# by one bf16 step of O (2^-7 relative); LSE is f32 sums in another order
O_ATOL, O_RTOL = 1e-2, 1e-2
LSE_ATOL, LSE_RTOL = 1e-3, 1e-4
# the backward kernels round at the plain version's points; f32 sums in
# another order can move one P or dS term across a bf16 rounding boundary
# (2^-8 of that term), and a bf16 output by one bf16 step (2^-7 relative).
# dQ is summed over key tiles by f32 reduce-adds in the order the blocks
# finish, so its last bits can change from run to run; dK and dV do not
GRAD_ATOL, GRAD_RTOL = 1e-2, 1e-2
# tests/test_ml_extension.py's tolerance between the two attention cores,
# for logits and for the attention gradients of its sin-sum loss
LOGITS_TOL = 2e-2
SIN_GRAD_TOL = 1e-2
# __graft_entry__.py's dryrun limits between two train steps
LOSS_TOL, LEAF_TOL = 1e-2, 2e-2
# SGD rate of the served-config train phase: at 0.1 the JAX step itself
# diverges on this model (and the port with it), at 0.01 both fall
SERVED_LR = 0.01
BWD_VARIANTS = {"flash_bwd_delta": "precompute", "flash_bwd_fused": "fused"}

# the ring block update against its plain version: both round P to bf16
# against the same final max, so m' and den' differ only by f32 sums in
# another order (about d·2^-24 absolute for an m' near 0), and num' by at
# most one P term moved across a bf16 rounding boundary by an ulp of exp
RING_M_ATOL, RING_M_RTOL = 1e-6, 1e-5
RING_DEN_RTOL = 1e-4
RING_NUM_ATOL, RING_NUM_RTOL = 1e-2, 1e-2

RING_CASES = [  # (B, sq, sk, h, d), B the batch times sp, folded
    (2, 16, 24, 2, 32),   # tests/test_ml_extension.py's block update
    (SERVED_BATCH * 2, 16, 16, 4, 32),  # served config, sp 2 and sp 4
    (SERVED_BATCH * 4, 8, 8, 4, 32),
    (16, 4, 4, 4, 16),    # the dryrun config, batch 4, sp 4
    (BENCH_BATCH * BENCH_SP, 128, 128, 16, 64),  # bench config, sp 4
    (2, 100, 130, 4, 64),  # ragged tiles, sq != sk
    (1, 130, 100, 2, 128),
    (2, 8, 8, 2, 16),     # the dryrun's 2 × 2 × 2 mesh, one rank
    SHARDED_RING,         # the bench config on a 2 × 2 × 2 mesh, one rank
]

KERNEL_CASES = [  # (b, s, h, d)
    (1, 8, 2, 16),        # TINY
    (1, 32, 4, 32),       # served config, buckets 1, 8, 32
    (8, 32, 4, 32),
    (32, 32, 4, 32),
    (BENCH_BATCH, 512, 16, 64),  # bench config
    (2, 100, 4, 64),      # ragged last tile
    (1, 100, 2, 128),
    (2, 130, 4, 64),
    (1, 130, 2, 128),
    (2, 300, 4, 64),      # several key tiles of the backward, ragged
    (1, 260, 2, 128),
    (1, 129, 2, 64),      # one key past the forward's 128-key tile
    (3, 200, 2, 32),      # ragged, two key tiles, d 32
    (3, 50, 2, 16),       # s < 64 at d 16
    (2, 16, 2, 16),       # the dryrun's tp meshes at dp 2, one rank
    SHARDED_DENSE,        # the bench config on a 2 × 1 × 2 mesh, one rank
]


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, *, warmup: int = 3, reps: int = 15, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _bound(moved: int, ops: int) -> tuple[float, str]:
    """(ms, what sets it): the larger of bytes over the H100's memory
    rate and bf16 operations over its tensor-core rate."""
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound(b: int, s: int, h: int, d: int, itemsize: int) -> tuple[float, str]:
    """Least time for the forward on an H100: q, k, v read once, o and
    lse written once, against the two products' 4·b·h·s²·d operations."""
    return _bound(4 * b * s * h * d * itemsize + b * h * s * 4, 4 * b * h * s * s * d)


def attention_bwd_bound(b: int, s: int, h: int, d: int, itemsize: int) -> tuple[float, str]:
    """Least time for the backward wrapper's call on an H100, either Δ
    variant: q, k, v, O, dO and LSE read once (the call computes Δ from
    O and dO in both), dq, dk, dv written once, against the five
    products' 10·b·h·s²·d operations."""
    moved = 8 * b * s * h * d * itemsize + b * h * s * 4
    return _bound(moved, 10 * b * h * s * s * d)


def ring_bwd_bound(b: int, s: int, h: int, d: int, itemsize: int) -> tuple[float, str]:
    """Least time for one ring backward step on an H100: q, k, v, dO read
    once in the IO dtype, LSE and Δ read once, the f32 dQ, dK and dV
    accumulators read and written once, against the five products'
    10·b·h·s²·d operations."""
    moved = 4 * b * s * h * d * itemsize + 2 * b * h * s * 4 + 6 * b * s * h * d * 4
    return _bound(moved, 10 * b * h * s * s * d)


def ring_bound(b: int, sq: int, sk: int, h: int, d: int,
               itemsize: int) -> tuple[float, str]:
    """Least time for one ring block update on an H100: q, k, v read
    once, num read and written once in f32, m and den read and written
    once, against the two products' 4·b·h·sq·sk·d operations."""
    moved = (b * sq * h * d + 2 * b * sk * h * d) * itemsize \
        + 2 * b * h * sq * d * 4 + 4 * b * h * sq * 4
    return _bound(moved, 4 * b * h * sq * sk * d)


def qkv(gen, b, s, h, d, dtype, n=3):
    return [torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
            for _ in range(n)]


@contextlib.contextmanager
def bwd_variant(variant: str):
    """``TASKSRUNNER_FLASH_BWD_DELTA`` set for the duration of a block."""
    os.environ["TASKSRUNNER_FLASH_BWD_DELTA"] = variant
    try:
        yield
    finally:
        os.environ.pop("TASKSRUNNER_FLASH_BWD_DELTA")


reset_counts, counts = flash.reset_launch_counts, flash.launch_counts


@contextlib.contextmanager
def counted_rotations():
    """Counts the calls of ``ring._rotate`` (a K/V rotation: a roll of the
    one-process fold, or a send to the next process) inside the block."""
    real, calls = ring._rotate, []

    def rotate(k, v, mesh):
        calls.append(None)
        return real(k, v, mesh)

    ring._rotate = rotate
    try:
        yield calls
    finally:
        ring._rotate = real


# -- phases -----------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build() -> None:
    """Builds the three sources in parallel and prints, for every kernel
    they hold (the ring's backward is flash_bwd.cu's ``bwd_main`` with
    RING set), what ``-Xptxas -v`` says: registers, shared memory and
    spills."""
    started = time.monotonic()
    names = ["flash_fwd", "flash_bwd", "flash_ring"]
    outputs = _kernels.build(names)
    for name in (*names, "flash_ring_bwd"):
        flash._kernel(name)  # load and bind
    emit({"phase": "build", "kernels": names, "seconds": time.monotonic() - started})
    for name in names:
        kernel = None
        for line in outputs.get(name, "").splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and ("registers" in line or "spill" in line):
                emit({"phase": "build", "ptxas": f"{name}.cu", "kernel": kernel,
                      "info": line.strip()})


def phase_kernel_vs_plain() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = dict.fromkeys(["flash_fwd", *BWD_VARIANTS], 0.0)
    for b, s, h, d in KERNEL_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv(gen, b, s, h, d, dtype)
            scale = d ** -0.5
            out, lse = flash.flash_fwd(q, k, v, scale)
            torch.cuda.synchronize()
            want_o, want_lse = flash.flash_fwd_reference(q, k, v, scale)
            torch.cuda.synchronize()
            err_o = (out.float() - want_o.float()).abs()
            err_lse = (lse - want_lse).abs()
            ok = (bool((err_o <= O_ATOL + O_RTOL * want_o.float().abs()).all())
                  and bool((err_lse <= LSE_ATOL + LSE_RTOL * want_lse.abs()).all())
                  and out.dtype == dtype and lse.dtype == torch.float32
                  and bool(torch.isfinite(out).all()))
            emit({"phase": "kernel_vs_plain", "kernel": "flash_fwd",
                  "shape": [b, s, h, d], "dtype": str(dtype).split(".")[-1],
                  "max_abs_err_o": err_o.max().item(),
                  "max_abs_err_lse": err_lse.max().item(), "ok": ok})
            check(ok, f"flash_fwd disagrees with its plain version at {(b, s, h, d)} {dtype}")
            worst["flash_fwd"] = max(worst["flash_fwd"], err_o.max().item())
            (dout,) = qkv(gen, b, s, h, d, dtype, n=1)
            want = flash.flash_bwd_reference(q, k, v, out, lse, dout, scale)
            for name, variant in BWD_VARIANTS.items():
                with bwd_variant(variant):
                    got = flash.flash_bwd(q, k, v, out, lse, dout, scale)
                torch.cuda.synchronize()
                errs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
                ok = all(g.dtype == dtype and bool(torch.isfinite(g).all())
                         and bool((e <= GRAD_ATOL + GRAD_RTOL * w.float().abs()).all())
                         for g, w, e in zip(got, want, errs))
                emit({"phase": "kernel_vs_plain", "kernel": name,
                      "shape": [b, s, h, d], "dtype": str(dtype).split(".")[-1],
                      "max_abs_err_dq_dk_dv": [e.max().item() for e in errs], "ok": ok})
                check(ok, f"{name} disagrees with its plain version at {(b, s, h, d)} {dtype}")
                worst[name] = max(worst[name], *(e.max().item() for e in errs))
    # what the kernel was not built for is refused, not run
    try:
        flash.flash_fwd(*qkv(gen, 1, 8, 2, 48, torch.bfloat16), 0.1)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_fwd accepted d_head 48")
    return worst


def ring_state(gen, b, sq, h, d, start: bool):
    """The ring's state at its first step (-inf, 0, 0), or after one plain
    step over another random block (finite, of the sizes the ring
    carries)."""
    m = torch.full((b, h, sq), float("-inf"), device="cuda")
    num = torch.zeros(b, h, sq, d, device="cuda")
    den = torch.zeros(b, h, sq, device="cuda")
    if start:
        return m, num, den
    q, k, v = qkv(gen, b, sq, h, d, torch.float32)
    return flash.ring_block_update_reference(q, k, v, m, num, den, scale=d ** -0.5)


def phase_ring_kernel_vs_plain() -> float:
    """The ring block update against its plain version: the worst
    |num' - plain| over every case."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    for b, sq, sk, h, d in RING_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for start in (True, False):
                (q,) = qkv(gen, b, sq, h, d, dtype, n=1)
                k, v = qkv(gen, b, sk, h, d, dtype, n=2)
                state = ring_state(gen, b, sq, h, d, start)
                kept = [x.clone() for x in state]
                got = flash.ring_block_update(q, k, v, *state, scale=d ** -0.5)
                torch.cuda.synchronize()
                want = flash.ring_block_update_reference(q, k, v, *state, scale=d ** -0.5)
                errs = [(g - w).abs() for g, w in zip(got, want)]
                ok = (all(bool(torch.isfinite(g).all()) and g.dtype == torch.float32
                          for g in got)
                      and all(torch.equal(x, y) for x, y in zip(state, kept))
                      and bool((errs[0] <= RING_M_ATOL + RING_M_RTOL * want[0].abs()).all())
                      and bool((errs[1] <= RING_NUM_ATOL
                                + RING_NUM_RTOL * want[1].abs()).all())
                      and bool((errs[2] <= RING_DEN_RTOL * want[2].abs()).all()))
                emit({"phase": "kernel_vs_plain", "kernel": "flash_ring",
                      "shape": [b, sq, sk, h, d], "dtype": str(dtype).split(".")[-1],
                      "state": "first step" if start else "later step",
                      "max_abs_err_m_num_den": [e.max().item() for e in errs],
                      "max_rel_err_m_den": [(errs[i] / want[i].abs()).max().item()
                                            for i in (0, 2)], "ok": ok})
                check(ok, f"flash_ring disagrees with its plain version at "
                          f"{(b, sq, sk, h, d)} {dtype} start={start}")
                worst = max(worst, errs[1].max().item())
                if b % 2 == 0:  # the in-place read of the fold, rank r − 1's block
                    shifted = flash.ring_block_update(q, k, v, *state, scale=d ** -0.5,
                                                      shift=1, sp=2)
                    rolled = flash.ring_block_update(q, roll_fold(k, 1, 2), roll_fold(v, 1, 2),
                                                     *state, scale=d ** -0.5)
                    torch.cuda.synchronize()
                    check(all(torch.equal(x, y) for x, y in zip(shifted, rolled)),
                          f"flash_ring's in-place read differs from rolled inputs at "
                          f"{(b, sq, sk, h, d)} {dtype}")
    try:
        q, k, v = qkv(gen, 1, 8, 2, 48, torch.bfloat16)
        flash.ring_block_update(q, k, v, *ring_state(gen, 1, 8, 2, 48, True), scale=0.1)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_ring accepted d_head 48")
    return worst


def roll_fold(x: torch.Tensor, shift: int, sp: int) -> torch.Tensor:
    """x [b·sp, ...] with row bi·sp + r taken from row bi·sp + (r − shift)
    mod sp: K/V rotated ``shift`` ranks along the one-process fold."""
    return torch.roll(x.reshape(-1, sp, *x.shape[1:]), shift, dims=1).reshape(x.shape)


def fold_sp(b: int) -> int:
    """The largest ring of sp 4, 2 or 1 that a folded batch of b rows holds."""
    return next(sp for sp in (4, 2, 1) if b % sp == 0)


def ring_grad_inputs(gen, b, s, h, d, dtype, sp):
    """q, k, v, dO, and the LSE and Δ of the one-process ring of ``sp``
    ranks over them (row bi·sp + r is rank r's block): the K/V blocks are
    independent, so each visiting block carries about 1/sp of a row's
    softmax mass, as on the ring."""
    q, k, v, dout = qkv(gen, b, s, h, d, dtype, n=4)
    m, num, den = ring_state(gen, b, s, h, d, start=True)
    for shift in range(sp):
        rolled = [roll_fold(x, shift, sp) for x in (k, v)]
        m, num, den = flash.ring_block_update_reference(q, *rolled, m, num, den,
                                                        scale=d ** -0.5)
    out = (num / den[..., None]).transpose(1, 2)
    delta = (dout.float() * out).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, dout, m + torch.log(den), delta


def ring_grad_increments(inputs, acc, *, shift: int, sp: int):
    """What one ring backward step adds to copies of the accumulators
    ``acc``, by the kernel and by its plain version: (got, want), each a
    list of the dQ, dK, dV increments."""
    scale = inputs[0].shape[-1] ** -0.5
    got, want = [x.clone() for x in acc], [x.clone() for x in acc]
    flash.ring_block_grad(*inputs, *got, scale=scale, shift=shift, sp=sp)
    flash.ring_block_grad_reference(*inputs, *want, scale=scale, shift=shift, sp=sp)
    torch.cuda.synchronize()
    return ([g - a for g, a in zip(got, acc)], [w - a for w, a in zip(want, acc)])


def phase_ring_bwd_kernel_vs_plain() -> float:
    """The ring's backward step against its plain version at RING_CASES'
    shapes with sk = sq (the ring's blocks are equal), bf16 and f32, on
    the LSE and Δ of a ring of sp 4 (2, 1 where the batch does not
    divide) at every ring step, into accumulators holding earlier sums:
    the worst |increment − plain increment| over every case."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst = 0.0
    for b, sq, _, h, d in RING_CASES:
        sp = fold_sp(b)
        for dtype in (torch.bfloat16, torch.float32):
            inputs = ring_grad_inputs(gen, b, sq, h, d, dtype, sp)
            acc = [torch.randn(b, sq, h, d, generator=gen, device="cuda") for _ in range(3)]
            for shift in range(sp):
                got, want = ring_grad_increments(inputs, acc, shift=shift, sp=sp)
                errs = [(g - w).abs() for g, w in zip(got, want)]
                # the backward kernels' tolerance on what the step added (the
                # accumulators' earlier sums would loosen rtol), its absolute
                # part in units of the largest increment, never above
                # GRAD_ATOL: one P or dS term across a bf16 boundary is 2^-8
                # of that term; a wrong scale or row is a share of the whole
                atols = [GRAD_ATOL * min(1.0, w.abs().max().item()) for w in want]
                ok = all(bool(torch.isfinite(g).all())
                         and bool((e <= atol + GRAD_RTOL * w.abs()).all())
                         for g, w, e, atol in zip(got, want, errs, atols))
                emit({"phase": "kernel_vs_plain", "kernel": "flash_ring_bwd",
                      "shape": [b, sq, sq, h, d], "dtype": str(dtype).split(".")[-1],
                      "shift_sp": [shift, sp],
                      "max_abs_err_dq_dk_dv": [e.max().item() for e in errs],
                      "increment_max_dq_dk_dv": [w.abs().max().item() for w in want],
                      "increment_rms_dq_dk_dv": [w.square().mean().sqrt().item()
                                                 for w in want],
                      "atol_dq_dk_dv": atols, "ok": ok})
                check(ok, f"flash_ring_bwd disagrees with its plain version at "
                          f"{(b, sq, h, d)} {dtype} shift {shift} of sp {sp}")
                worst = max(worst, *(e.max().item() for e in errs))
    return worst


def bf16_steps(got, want):
    """The largest |got − want| in bf16 steps, each element's step taken
    at its magnitude or at want's rms, whichever is larger: a sum that
    cancels to near 0 is as uncertain as f32 sums in another order make
    it, far more than a bf16 step of its own tiny value."""
    want = want.float()
    mag = torch.maximum(want.abs(), want.square().mean().sqrt())
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want).abs() / step).max().item()


def rounded_twice(x, w, parts: int = 8):
    """The product with its K split in ``parts``, each partial rounded to
    bf16 and summed in bf16: what a reduced-precision reduction does."""
    out = None
    for xs, ws in zip(x.chunk(parts, dim=1), w.chunk(parts, dim=0)):
        part = (xs.float() @ ws.float()).to(torch.bfloat16)
        out = part if out is None else out + part
    return out


# C1's products: (m, k, n) of the served config at b 1 / 8 / 32 (m = b·32,
# d 128, ff 512) and of the bench config at batch 32 (m 16384, d 1024, ff 4096)
C1_SHAPES = [(32, 128, 128), (256, 128, 512), (1024, 512, 128),
             (16384, 1024, 1024), (16384, 1024, 4096), (16384, 4096, 1024)]


def phase_matmul() -> dict:
    """The f32-activation product on the card against the same product
    on the CPU: the repaired path keeps the f32 accumulator; a bf16
    product cast to f32 afterwards (the path before the repair) is off
    by a bf16 rounding. Then C1: the bf16-activation product
    (``model._matmul``) against the f32 product of the same bf16 inputs
    rounded once to bf16, with cuBLAS's reduced-precision reduction
    allowed and not: at most one bf16 step apart; a product whose partial
    sums are rounded to bf16 must be more."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    a = torch.randn(8, 32, 128, generator=gen)
    b = torch.randn(128, 512, generator=gen) / 128 ** 0.5
    os.environ["TASKSRUNNER_ACT_F32"] = "1"
    try:
        want = model._matmul(a, b)
        got = model._matmul(a.cuda(), b.cuda()).cpu()
    finally:
        os.environ.pop("TASKSRUNNER_ACT_F32")
    stored_bf16 = torch.matmul(a.cuda().bfloat16(), b.cuda().bfloat16()).float().cpu()
    scale = want.abs().max().item()
    record = {"phase": "matmul", "dtype": str(got.dtype).split(".")[-1],
              "rel_err": (got - want).abs().max().item() / scale,
              "rel_err_bf16_stored": (stored_bf16 - want).abs().max().item() / scale}
    record["ok"] = got.dtype == torch.float32 and record["rel_err"] <= 1e-5
    emit(record)
    check(record["ok"], "the f32-activation product lost its f32 accumulator")
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    steps = {}
    try:
        for m, k, n in C1_SHAPES:
            x = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
            w = (torch.randn(k, n, generator=gen) / k ** 0.5).to("cuda", torch.bfloat16)
            once = (x.float() @ w.float()).to(torch.bfloat16)  # f32 sums, one rounding
            # the control: partial sums rounded to bf16 must be seen
            steps[f"m{m}k{k}n{n}/rounded_twice"] = bf16_steps(rounded_twice(x, w), once)
            for reduced in (True, False):
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
                got = model._matmul(x, w)
                steps[f"m{m}k{k}n{n}/reduced_{str(reduced).lower()}"] = bf16_steps(got, once)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    c1 = {"phase": "matmul", "check": "C1", "default_flag": flag, "bf16_steps": steps,
          "ok": all((v > 1.0) == key.endswith("rounded_twice") for key, v in steps.items())}
    emit(c1)
    check(c1["ok"], f"C1: a bf16 product is more than one bf16 step off, or the "
                    f"twice-rounded control is not: {steps}")
    return record


def phase_gradient() -> None:
    """FlashAttention's dq, dk, dv against autograd through the einsum
    core, with tests/test_ml_extension.py's sin-sum loss and tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for b, s, h, d in ((2, 64, 4, 32), (SERVED_BATCH, 32, 4, 32), (2, 130, 4, 64)):
        leaves = [x.requires_grad_() for x in qkv(gen, b, s, h, d, torch.float32)]
        for name, variant in BWD_VARIANTS.items():
            with bwd_variant(variant):
                got = torch.autograd.grad(flash.flash_attention(*leaves).sin().sum(), leaves)
            want = torch.autograd.grad(model._einsum_attention(*leaves).sin().sum(), leaves)
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            ok = all(bool(((g - w).abs() <= SIN_GRAD_TOL + SIN_GRAD_TOL * w.abs()).all())
                     for g, w in zip(got, want))
            emit({"phase": "gradient", "kernel": name, "shape": [b, s, h, d],
                  "max_abs_err": err, "ok": ok})
            check(ok, f"{name}: flash gradients disagree with the einsum core's")


def phase_ring() -> None:
    """ring_attention at sp 2 and 4 against the dense flash forward, and
    its gradients (sin-sum loss, f32 leaves) against autograd through the
    einsum core, at the bench config's attention shape."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    b, s, h, d = BENCH_BATCH, BENCH.seq_len, BENCH.n_heads, BENCH.d_head
    q, k, v = qkv(gen, b, s, h, d, torch.bfloat16)
    with torch.inference_mode():
        dense = flash.flash_attention(q, k, v).float()
    leaves = [x.requires_grad_() for x in qkv(gen, b, s, h, d, torch.float32)]
    want_grads = torch.autograd.grad(model._einsum_attention(*leaves).sin().sum(), leaves)
    for sp in (2, BENCH_SP):
        before = flash.ring_launches
        with torch.inference_mode():
            got = ring.ring_attention(q, k, v, mesh=Mesh(sp=sp))
        torch.cuda.synchronize()
        launched = flash.ring_launches - before
        err = (got - dense).abs().max().item()
        grads = torch.autograd.grad(
            ring.ring_attention(*leaves, mesh=Mesh(sp=sp)).sin().sum(), leaves)
        grad_errs = [(g - w).abs().max().item() for g, w in zip(grads, want_grads)]
        ok = (got.dtype == torch.float32 and got.shape == (b, s, h, d) and err <= LOGITS_TOL
              and launched == sp
              and all(bool(((g - w).abs() <= SIN_GRAD_TOL + SIN_GRAD_TOL * w.abs()).all())
                      for g, w in zip(grads, want_grads)))
        emit({"phase": "ring", "sp": sp, "shape": [b, s, h, d],
              "max_abs_err_vs_dense_flash": err, "max_abs_err_dq_dk_dv": grad_errs,
              "ring_launches": launched, "ok": ok})
        check(ok, f"ring attention at sp {sp} disagrees with dense attention")


def _logits(params, tokens, cfg, flash_on: bool, mesh: Mesh | None = None) -> torch.Tensor:
    os.environ["TASKSRUNNER_FLASH"] = "1" if flash_on else "0"
    try:
        with torch.inference_mode():
            out = forward(params, tokens, cfg=cfg, mesh=mesh)
        torch.cuda.synchronize()
        return out
    finally:
        os.environ.pop("TASKSRUNNER_FLASH")


def phase_forward() -> None:
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, cfg, batch in (("served", SERVED, SERVED_BATCH), ("bench", BENCH, BENCH_BATCH)):
        params = init_params(cfg, 0, "cuda")
        tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                               device="cuda", dtype=torch.int32)
        before = flash.launches
        got = _logits(params, tokens, cfg, flash_on=True)
        launched = flash.launches - before
        want = _logits(params, tokens, cfg, flash_on=False)
        err = (got - want).abs().max().item()
        ok = (got.shape == (batch, cfg.n_classes) and bool(torch.isfinite(got).all())
              and bool(((got - want).abs() <= LOGITS_TOL + LOGITS_TOL * want.abs()).all())
              and launched == cfg.n_layers)
        emit({"phase": "forward", "config": name, "batch": batch,
              "max_abs_err_logits": err, "flash_launches": launched,
              "n_layers": cfg.n_layers, "ok": ok})
        check(ok, f"{name} forward: flash and einsum cores disagree or launches "
                  f"{launched} != {cfg.n_layers}")
        del params


async def _http(port: int, method: str, path: str, body: bytes = b"",
                headers: dict | None = None):
    """One HTTP/1.1 request to 127.0.0.1: (status, headers, body)."""
    return await asyncio.wait_for(
        http_request("127.0.0.1", port, method, path, headers=headers, body=body), 120)


async def _serve(n_requests: int) -> dict:
    app = service.make_app()
    port = await app.start("127.0.0.1", 0)
    try:
        first = json.dumps({"taskId": "warm", "taskName": "first task"}).encode()
        not_ready = 0
        deadline = time.monotonic() + 600
        while True:
            status, headers, body = await _http(port, "POST", "/score", first)
            if status == 200:
                break
            check(status == 503 and headers.get("retry-after") == "1",
                  f"/score during warm-up answered {status} {body!r}")
            not_ready += 1
            check(time.monotonic() < deadline, "warm-up did not finish")
            try:  # raises at once if the warm-up failed
                await asyncio.wait_for(app.wait_ready(), 0.25)
            except asyncio.TimeoutError:
                pass
        await app.wait_ready()

        bodies = [json.dumps({"taskId": f"task-{i}",
                              "taskName": f"rotate the keys of service {i}",
                              "taskCreatedBy": "ops", "taskAssignedTo": f"user{i % 5}"}
                             ).encode() for i in range(n_requests)]

        async def timed(body: bytes):
            sent = time.monotonic()
            reply = await _http(port, "POST", "/score", body)
            return reply, time.monotonic() - sent

        started = time.monotonic()
        results = await asyncio.gather(*(timed(b) for b in bodies))
        burst_s = time.monotonic() - started
        replies = [reply for reply, _ in results]
        latencies_ms = sorted(1e3 * seconds for _, seconds in results)
        for i, (status, _, body) in enumerate(replies):
            check(status == 200, f"/score answered {status}: {body!r}")
            scored = json.loads(body)
            check(scored["taskId"] == f"task-{i}", f"taskId not echoed: {scored}")
            check(scored["priority"] in service.PRIORITY_LABELS, f"bad priority {scored}")
            check(0.0 < scored["confidence"] <= 1.0, f"bad confidence {scored}")
        status, _, _ = await _http(port, "POST", "/score", b"{not json")
        check(status == 400, f"bad body answered {status}")
        stats = json.loads((await _http(port, "GET", "/ml/stats"))[2])
        check(stats["completed"] == n_requests + 1,
              f"completed {stats['completed']} != {n_requests + 1}")
        check(stats["jit_cache_size"] == len(stats["buckets"]),
              f"jit_cache_size {stats['jit_cache_size']} != {len(stats['buckets'])}")
        return {"not_ready_replies": not_ready, "requests": n_requests + 1,
                "burst_seconds": burst_s,
                "burst_latency_ms": {"n": len(latencies_ms),
                                     "p50": statistics.median(latencies_ms),
                                     "max": latencies_ms[-1]},
                "stats": stats}
    finally:
        await app.stop()


def expected_serve_launches(stats: dict, cards: int) -> int:
    """B1's launches for a scorer's life, from its ``/ml/stats``: one per
    layer for each bucket's warm-up and each batch run, times the cards a
    bucket that divides over them is split over (make_app serves on every
    visible card)."""
    return SERVED.n_layers * sum((cards if bucket % cards == 0 else 1)
                                 * (1 + stats["batches"].get(str(bucket), 0))
                                 for bucket in stats["buckets"])


def phase_serve() -> int:
    reset_counts()
    result = asyncio.run(_serve(n_requests=32))
    launches = flash.launches
    check(counts()["flash_bwd_delta"] == counts()["flash_bwd_fused"]
          == counts()["flash_ring"] == counts()["flash_ring_bwd"] == 0,
          "the served path launched a backward or ring kernel")
    # make_app serves on every visible card: a bucket that divides over
    # them runs one forward per card, at warm-up and at each batch
    cards = torch.cuda.device_count()
    expected = expected_serve_launches(result["stats"], cards)
    emit({"phase": "serve", **result, "cards": cards, "flash_launches": launches,
          "expected_launches": expected})
    check(launches > 0, "the served path launched no flash kernel")
    check(launches == expected, f"flash launches {launches} != {expected}")
    return launches


# the runtime phase: how many events and /score calls, and the token
# budget that makes the admission flood saturate the batcher (each flood
# task is 4 words, so 4 tokens: FLOOD_CLIENTS of them hold twice the budget)
RUNTIME_EVENTS, RUNTIME_REQUESTS = 64, 32
WARMUP_EVENTS = 8
FLOOD_CLIENTS, FLOOD_MAX_TOKENS = 32, 64
RUNTIME_CONFIDENCE_TOL = 1e-3
PUBSUB, TOPIC = "taskspubsub", "tasksavedtopic"
# the stats part: the API token it sets, and the batcher's window, which
# holds a lone /score in the queue long enough to be seen in flight
STATS_TOKEN, STATS_WINDOW_MS = "smoke-token", 250


class TimedStore(InMemoryStateStore):
    """The ``scores`` store, noting when each key was first saved."""

    def __init__(self, name: str) -> None:
        super().__init__(name)
        self.stored_at: dict[str, float] = {}

    async def set(self, key, value, *, etag=None) -> str:
        new_etag = await super().set(key, value, etag=etag)
        self.stored_at.setdefault(key, time.monotonic())
        return new_etag


async def _until(predicate, seconds: float, what: str) -> None:
    deadline = time.monotonic() + seconds
    while not predicate():
        check(time.monotonic() < deadline, what)
        await asyncio.sleep(0.005)


def _saved_task(prefix: str, i: int) -> dict:
    return {"taskId": f"{prefix}-{i}", "taskName": f"rotate the keys of service {i}",
            "taskCreatedBy": "ops", "taskAssignedTo": f"user{i % 5}"}


class _Runtime:
    """The scorer and a publisher app in an InProcHost with a timed
    ``scores`` store and a broker that dead-letters at the first nack
    that uses up an attempt: a stored event proves its nacks used none."""

    def __init__(self) -> None:
        self.store = TimedStore("scores")
        self.broker = InMemoryBroker(PUBSUB, max_attempts=1)
        self.host = InProcHost(state_stores={"scores": self.store},
                               brokers={PUBSUB: self.broker})
        self.scorer = service.make_app()
        self.host.add_app(self.scorer)
        self.host.add_app(App("some-api"))
        self.client = None
        self.published: dict[str, float] = {}

    async def start(self) -> None:
        await self.host.start()
        self.client = self.host.client("some-api")

    async def publish(self, task: dict) -> None:
        self.published[task["taskId"]] = time.monotonic()
        await self.client.publish_event(PUBSUB, TOPIC, task)

    async def all_stored(self, seconds: float = 20) -> dict:
        await _until(lambda: all(k in self.store.stored_at for k in self.published),
                     seconds, f"events not stored: {len(self.store.stored_at)} of "
                              f"{len(self.published)}")
        check(self.broker.dead_letters == [], f"{len(self.broker.dead_letters)} dead letters")
        ms = sorted(1e3 * (self.store.stored_at[k] - t) for k, t in self.published.items())
        return {"events": len(ms), "p50": statistics.median(ms), "max": ms[-1]}

    async def call(self, method: str, path: str, data=None):
        return await self.client.invoke_method("priority-scorer", path,
                                               http_method=method, data=data)

    async def stats(self) -> dict:
        reply = await self.call("GET", "ml/stats")
        check(reply.status == 200, f"/ml/stats answered {reply.status}")
        return reply.json()


class LagWatch:
    """Every value the loop's lag probe writes to ``event_loop_lag_seconds``
    while the watch runs (the gauge read every 10 ms), and the value it
    held when the watch began (the probe's last, perhaps older)."""

    def __init__(self) -> None:
        self.at_start = metrics.get(LAG_GAUGE)
        self.updates: list[float] = []
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        last = self.at_start
        while True:
            await asyncio.sleep(0.01)
            value = metrics.get(LAG_GAUGE)
            if value != last:
                self.updates.append(value)
                last = value

    async def stop(self) -> dict:
        self._task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await self._task
        return {"max_s": max(self.updates, default=None), "updates": len(self.updates),
                "at_start_s": self.at_start}


@contextlib.contextmanager
def timed_batch_probs():
    """Times every ``service.batch_probs`` call (a batch's forward,
    softmax and device-to-host copy, in the batcher's worker thread) in
    the block: the part of a batch's ``ml-batch`` span spent computing,
    the rest being the hand-off to the thread and back to the loop."""
    real, seconds = service.batch_probs, []

    def timed(*args, **kwargs):
        started = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - started)

    service.batch_probs = timed
    try:
        yield seconds
    finally:
        service.batch_probs = real


def _p50_max_ms(values: list[float]) -> dict:
    ms = sorted(1e3 * v for v in values)
    return {"p50": statistics.median(ms), "max": ms[-1]}


def _burst_traces(db: str, registry, batch_probs_s: list[float], since: float) -> dict:
    """The burst's spans, read back with the port's readers: every
    ``/score`` call is a client span with one ``POST /score`` server span
    under it, and under that one ``ml-request`` naming a recorded
    ``ml-batch``; every event is a producer span with a consumer span
    under it that scored it. Returns the p50 and max of a call's segments
    and the critical path of the slowest queue-wait exemplar's trace;
    and over the batches run from ``since`` (unix time) on, their
    ``ml-batch`` spans beside the ``batch_probs`` calls timed then."""
    rows = spans.trace_spans(db, "")  # every trace in the file
    by_trace: dict[str, list[dict]] = {}
    for row in rows:
        row["attrs"] = json.loads(row["attrs"])
        by_trace.setdefault(row["trace_id"], []).append(row)
    batches = {r["trace_id"]: r for r in rows if r["name"] == "ml-batch"}

    def under(parent: dict, kind: str, name: str) -> list[dict]:
        return [r for r in by_trace[parent["trace_id"]] if r["parent_id"] == parent["span_id"]
                and r["kind"] == kind and r["name"] == name]

    segments = {"client_total": [], "dispatch": [], "queue_wait": [], "batch_service": []}
    calls = [r for r in rows if r["kind"] == "client"
             and r["name"] == "invoke priority-scorer/score"]
    check(len(calls) == RUNTIME_REQUESTS,
          f"{len(calls)} /score client spans, not {RUNTIME_REQUESTS}")
    for call in calls:
        server = under(call, "server", "POST /score")
        check(len(server) == 1 and server[0]["status"] == call["status"] == 200,
              f"/score trace {call['trace_id']}: server spans {server}")
        request = under(server[0], "internal", "ml-request")
        check(len(request) == 1 and request[0]["attrs"]["batch_trace"] in batches,
              f"/score trace {call['trace_id']}: ml-request spans {request}")
        segments["client_total"].append(call["duration"])
        segments["dispatch"].append(server[0]["duration"] - request[0]["duration"])
        segments["queue_wait"].append(request[0]["attrs"]["queue_wait"])
        segments["batch_service"].append(batches[request[0]["attrs"]["batch_trace"]]["duration"])
    producers = [r for r in rows if r["kind"] == "producer"]
    check(len(producers) == WARMUP_EVENTS + RUNTIME_EVENTS,
          f"{len(producers)} producer spans, not {WARMUP_EVENTS + RUNTIME_EVENTS}")
    for producer in producers:
        consumers = under(producer, "consumer", "POST /on-task-saved")
        check(producer["name"] == f"publish {PUBSUB}/{TOPIC}" and any(
            c["status"] == 200 and under(c, "internal", "ml-request") for c in consumers),
              f"event trace {producer['trace_id']}: consumers {consumers}")
    burst_batches = [b["duration"] for b in batches.values() if b["start"] >= since]
    check(len(burst_batches) == len(batch_probs_s),
          f"{len(burst_batches)} ml-batch spans, {len(batch_probs_s)} batch_probs calls")
    exemplars = [e for series in registry.snapshot_histograms()["ml_queue_wait_seconds"]["series"]
                 for e in series["exemplars"]]
    check(bool(exemplars), "no ml_queue_wait_seconds exemplar")
    trace_id, wait, _ = max(exemplars, key=lambda e: e[1])
    path = spans.critical_path(spans.trace_spans(db, trace_id))
    check(bool(path), f"the exemplar's trace {trace_id} has no spans")
    return {"spans": len(rows), "score_calls": len(calls), "events": len(producers),
            "segments_ms": {name: _p50_max_ms(v) for name, v in segments.items()},
            "burst_batches_ms": {"ml_batch": _p50_max_ms(burst_batches),
                                 "batch_probs": _p50_max_ms(batch_probs_s),
                                 "batches": len(burst_batches),
                                 "batch_probs_calls": len(batch_probs_s)},
            "slowest_exemplar": {
                "trace_id": trace_id, "queue_wait_ms": 1e3 * wait,
                "critical_path": [
                    {"name": hop["name"], "kind": hop["kind"], "ms": 1e3 * hop["duration"],
                     "self_ms": 1e3 * hop["self_time"],
                     **({"queue_wait_ms": 1e3 * hop["queue_wait"],
                         "service_ms": 1e3 * hop["service"]} if "queue_wait" in hop else {})}
                    for hop in path]}}


async def _runtime_burst() -> dict:
    """Events published before warm-up ends, then a burst of events and
    ``POST /score`` calls for the same tasks, its spans recorded into
    ``TASKSRUNNER_TRACE_DB`` and read back once the host has stopped."""
    rt = _Runtime()
    await rt.start()
    try:
        for i in range(WARMUP_EVENTS):  # the warm-up runs in the background
            await rt.publish(_saved_task("early", i))
        await asyncio.wait_for(rt.host.wait_ready(), 600)
        warm = await rt.all_stored()
        declined_warm = dict(rt.host.declined)
        check(declined_warm.get(503, 0) >= 1 and set(declined_warm) == {503},
              f"warm-up deliveries declined {declined_warm}")

        lag = LagWatch()
        rt.published.clear()
        tasks = [_saved_task("task", i) for i in range(RUNTIME_EVENTS)]
        since = time.time()
        with timed_batch_probs() as batch_probs_s:
            sync = [asyncio.ensure_future(rt.call("POST", "score", task))
                    for task in tasks[:RUNTIME_REQUESTS]]
            for task in tasks:
                await rt.publish(task)
            replies = await asyncio.wait_for(asyncio.gather(*sync), 60)
            burst = await rt.all_stored()
        lag = await lag.stop()
        worst = 0.0
        for task, reply in zip(tasks, replies):
            check(reply.status == 200, f"/score answered {reply.status}: {reply.body!r}")
            want = reply.json()
            got = await rt.client.get_state("scores", task["taskId"])
            check(got["priority"] == want["priority"],
                  f"{task['taskId']}: stored {got} but /score answered {want}")
            worst = max(worst, abs(got["confidence"] - want["confidence"]))
        check(worst <= RUNTIME_CONFIDENCE_TOL, f"stored confidence off by {worst}")
        stored = await rt.call("GET", f"scores/{tasks[0]['taskId']}")
        check(stored.status == 200 and stored.json()["priority"] in service.PRIORITY_LABELS,
              f"GET /scores answered {stored.status}")
        check((await rt.call("GET", "scores/absent")).status == 404, "GET /scores/absent")
        result = {"warmup_latency_ms": warm, "burst_latency_ms": burst,
                  "nacks": {str(k): v for k, v in rt.host.declined.items()},
                  "score_requests": RUNTIME_REQUESTS, "max_abs_err_confidence": worst,
                  "event_loop_lag": lag, "stats": await rt.stats()}
    finally:
        await rt.host.stop()
        spans.close_spans()
    return {**result, "traces": _burst_traces(os.environ["TASKSRUNNER_TRACE_DB"],
                                              rt.scorer.registry, batch_probs_s, since)}


async def _runtime_admission() -> dict:
    """A closed-loop flood of ``POST /score`` with events published into
    it: the sampler sees the batcher's tokens in flight over the budget
    and the front door sheds; each flood client stops at its first 429.
    The events go out once the gate sheds, so that their first delivery
    meets the shedding front door: published with the flood, the card
    can score all of them before the sampler's first tick saturates."""
    rt = _Runtime()
    await rt.start()
    try:
        await asyncio.wait_for(rt.host.wait_ready(), 600)
        lag = LagWatch()
        shed: list[dict] = []
        first_shed: dict = {}
        deadline = time.monotonic() + 15

        async def client(i: int) -> int:
            task = {"taskName": f"flood task {i}", "taskAssignedTo": "ops"}
            served = 0
            while time.monotonic() < deadline:
                reply = await rt.call("POST", "score", task)
                if reply.status == 429:
                    if not first_shed:
                        first_shed.update({name: metrics.get(name) for name in (
                            "admission_saturation", LAG_GAUGE)})
                    # nothing yields between these calls: the gate is
                    # in the state that answered the 429
                    health = await rt.call("GET", "healthz")
                    stats = await rt.call("GET", "ml/stats")
                    shed.append({"retry_after": reply.headers.get("retry-after"),
                                 "healthz": health.status, "stats": stats.status,
                                 "stats_retry_after": stats.headers.get("retry-after")})
                    return served
                check(reply.status == 200, f"flood /score answered {reply.status}")
                served += 1
            return served

        flood = [asyncio.ensure_future(client(i)) for i in range(FLOOD_CLIENTS)]
        await _until(lambda: rt.scorer.admission.shedding, 15, "the flood never saturated")
        # nothing yields between here and the publishes: the broker's
        # first delivery runs while the gate still sheds (its next sample
        # is up to SAMPLE_INTERVAL away)
        for i in range(RUNTIME_EVENTS):
            await rt.publish(_saved_task("flood", i))
        served = await asyncio.wait_for(asyncio.gather(*flood), 30)
        for seen in shed:
            check(seen["retry_after"] is not None and int(seen["retry_after"]) >= 1,
                  f"429 without Retry-After: {seen}")
            check(seen["healthz"] == 204, f"/healthz answered {seen['healthz']} while shedding")
            check(seen["stats"] == 429 and seen["stats_retry_after"] is not None,
                  f"/ml/stats answered {seen['stats']} while shedding")
        stored = await rt.all_stored(seconds=60)
        lag = await lag.stop()
        # while it sheds, the score it last published is at least the
        # exit ratio (else the gate would have reopened)
        check(first_shed.get("admission_saturation", 0.0) >= 0.75,
              f"admission_saturation at the first shed: {first_shed}")
        await _until(lambda: not rt.scorer.admission.shedding, 10, "the gate did not reopen")
        return {"latency_ms": stored, "flood_clients": FLOOD_CLIENTS,
                "flood_served": sum(served), "shed_429": len(shed),
                "retry_after": sorted({s["retry_after"] for s in shed}),
                "nacks": {str(k): v for k, v in rt.host.declined.items()},
                "event_loop_lag": lag, "at_first_shed": first_shed,
                "stats": await rt.stats()}
    finally:
        await rt.host.stop()


async def _runtime_stats() -> dict:
    """``make_app()`` served by ``App.start``: ``GET /tasksrunner/stats``
    answers 401 without the token; a ``/score`` held in the batcher's
    window is counted in flight and the probe never is; ``requests_total``
    rises by one per ``/score``."""
    app = service.make_app()
    port = await app.start("127.0.0.1", 0)
    token = {"tr-api-token": STATS_TOKEN}

    async def stats() -> dict:
        status, _, body = await _http(port, "GET", "/tasksrunner/stats", headers=token)
        check(status == 200, f"/tasksrunner/stats answered {status}: {body!r}")
        return json.loads(body)

    async def score(i: int) -> None:
        status, _, body = await _http(port, "POST", "/score",
                                      json.dumps(_saved_task("stats", i)).encode())
        check(status == 200, f"/score answered {status}: {body!r}")

    try:
        await asyncio.wait_for(app.wait_ready(), 600)
        status, _, _ = await _http(port, "GET", "/tasksrunner/stats")
        check(status == 401, f"/tasksrunner/stats without the token answered {status}")
        before = await stats()
        check(before["inflight"] == 0 and await stats() == before,
              f"the stats probe counted itself: {before}")
        held = asyncio.ensure_future(score(0))
        deadline = time.monotonic() + 5
        while (seen := await stats())["inflight"] == 0:
            check(time.monotonic() < deadline and not held.done(),
                  "a /score held in the batcher's window was never seen in flight")
            await asyncio.sleep(0.005)
        check(seen == {"inflight": 1, "requests_total": before["requests_total"] + 1},
              f"one /score in flight, the probe said {seen}")
        await held
        totals = [(await stats())["requests_total"]]
        for i in range(1, 5):
            await score(i)
            now = await stats()
            check(now == {"inflight": 0, "requests_total": totals[-1] + 1},
                  f"after /score {i}: {now}, before it {totals[-1]}")
            totals.append(now["requests_total"])
        check(totals[0] == before["requests_total"] + 1, f"requests_total {totals}")
        ml = json.loads((await _http(port, "GET", "/ml/stats"))[2])
        return {"before": before, "in_flight_seen": seen, "requests_total": totals,
                "stats": ml}
    finally:
        await app.stop()


def phase_runtime(smi: str) -> int:
    """The scorer on the port's runtime: returns B1's launches."""
    cards = torch.cuda.device_count()
    total = 0
    trace_dir = tempfile.TemporaryDirectory(prefix="chip-smoke-traces-")
    for name, run, env in (
            # every queue wait is a candidate exemplar (the threshold 0)
            ("burst", _runtime_burst,
             {"TASKSRUNNER_TRACE_DB": os.path.join(trace_dir.name, "burst.db"),
              "TASKSRUNNER_SLOW_THRESHOLD_SECONDS": "0"}),
            ("admission", _runtime_admission,
             {"TASKSRUNNER_ADMISSION": "1",
              "TASKSRUNNER_ML_MAX_TOKENS": str(FLOOD_MAX_TOKENS)}),
            ("stats", _runtime_stats,
             {"TASKSRUNNER_API_TOKEN": STATS_TOKEN,
              "TASKSRUNNER_ML_MAX_DELAY_MS": str(STATS_WINDOW_MS)})):
        os.environ.update(env)
        # the scorer records into the process's registry, whose threshold
        # was read when it was made
        threshold = metrics.slow_threshold
        metrics.slow_threshold = float(env.get("TASKSRUNNER_SLOW_THRESHOLD_SECONDS", threshold))
        try:
            reset_counts()
            started = time.monotonic()
            result = asyncio.run(run())
            seconds = time.monotonic() - started
            launched = counts()
        finally:
            metrics.slow_threshold = threshold
            for key in env:
                os.environ.pop(key)
        expected = expected_serve_launches(result["stats"], cards)
        emit({"phase": "runtime", "part": name, "nvidia_smi": smi, **result,
              "seconds": seconds, "flash_launches": launched["flash_fwd"],
              "expected_launches": expected})
        check(launched["flash_fwd"] == expected,
              f"runtime {name}: flash launches {launched['flash_fwd']} != {expected}")
        check(all(v == 0 for k, v in launched.items() if k != "flash_fwd"),
              f"runtime {name} launched a backward or ring kernel: {launched}")
        if name == "admission":
            check(result["shed_429"] >= 1 and result["nacks"].get("429", 0) >= 1,
                  f"the flood was not shed at the front door: {result}")
        total += launched["flash_fwd"]
    trace_dir.cleanup()
    return total


# the sidecar phase: events published while the scorer warms up, then
# a steady burst of events and two-hop /score calls, and the events
# published while the scorer and its sidecar are down
SIDECAR_WARMUP_EVENTS, SIDECAR_EVENTS, SIDECAR_REQUESTS, RESTART_EVENTS = 16, 48, 32, 16
# events published one at a time to an idle subscriber, each waiting for
# the consumer's next poll of the broker file: the gaps between them step
# through one poll interval (50 ms), so their phases against the polls
# spread over it instead of aliasing to one
SIDECAR_IDLE_EVENTS, IDLE_GAP_S, POLL_INTERVAL_S = 8, 0.1, 0.05
SAMPLE_COMPONENTS = ROOT / "samples" / "tasks_tracker" / "components"
DELIVERED_503 = "pubsub_delivery{route=/on-task-saved,status=503}"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _Processes:
    """The phase's ``python -m tasksrunner_torch`` processes: each one's
    standard error goes to a log file in the phase's directory, each is
    waited for to print its ``ready`` line within a time limit, stopped
    with SIGTERM (exit 0 required) and killed on any failure."""

    def __init__(self, logs: Path) -> None:
        self.logs = logs
        self.procs: dict[str, subprocess.Popen] = {}

    async def start(self, name: str, *args: str, seconds: float = 120,
                    env: dict | None = None, log_level: str = "warning") -> dict:
        log = open(self.logs / f"{name}.log", "w")
        proc = subprocess.Popen([sys.executable, "-m", "tasksrunner_torch", "--log-level",
                                 log_level, *args], cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=log, text=True, env=env)
        log.close()
        self.procs[name] = proc
        deadline = time.monotonic() + seconds
        loop = asyncio.get_running_loop()
        while True:
            remaining = deadline - time.monotonic()
            check(remaining > 0, f"{name} printed no ready line in {seconds} s")
            line = await asyncio.wait_for(loop.run_in_executor(None, proc.stdout.readline),
                                          remaining)
            if line.startswith("ready "):
                return dict(kv.split("=", 1) for kv in line.split()[1:])
            check(line != "", f"{name} closed its output (exit {proc.poll()}): {self.tail(name)}")

    def tail(self, name: str) -> str:
        return (self.logs / f"{name}.log").read_text()[-3000:]

    def stop(self, name: str) -> None:
        proc = self.procs.pop(name)
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
            raise AssertionError(f"{name} did not stop on SIGTERM") from None
        finally:
            proc.stdout.close()
        check(rc == 0, f"{name} exited {rc} on SIGTERM: {self.tail(name)}")

    def kill_all(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdout.close()
        self.procs.clear()


def _write_components(root: Path, data: Path) -> None:
    """The sample's state store and broker files with their paths
    rewritten into ``data``: the store named ``scores`` and scoped to the
    scorer, the broker as it is (``pubsub.redis`` without a host is the
    sqlite broker)."""
    root.mkdir()
    (root / "statestore.yaml").write_text(
        (SAMPLE_COMPONENTS / "statestore.yaml").read_text()
        .replace("name: statestore", "name: scores")
        .replace(".tasksrunner/statestore.db", str(data / "scores.db"))
        .replace("- tasksmanager-backend-api", "- priority-scorer"))
    (root / "pubsub-redis.yaml").write_text(
        (SAMPLE_COMPONENTS / "pubsub-redis.yaml").read_text()
        .replace(".tasksrunner/pubsub-local.db", str(data / "broker.db")))


class _Scorer:
    """``make_app()`` served as ``serve`` serves it, beside a sidecar
    process of its own; its client's ``save_state`` is timed, so an
    event's stored time is when the sidecar acknowledged its score."""

    def __init__(self, procs: _Processes, sidecar_port: int, components: Path,
                 registry: Path, name: str) -> None:
        self.procs, self.sidecar_port, self.name = procs, sidecar_port, name
        self.components, self.registry = components, registry
        self.app = service.make_app()
        self.stored_at: dict[str, float] = {}

    async def start(self) -> None:
        app_port = await cli.start_app(self.app, sidecar_port=self.sidecar_port)
        self.app_port = app_port
        save = self.app.client.save_state

        async def timed_save(store, key, value):
            await save(store, key, value)
            self.stored_at.setdefault(key, time.monotonic())

        self.app.client.save_state = timed_save
        await self.procs.start(
            self.name, "sidecar", "--app-id", "priority-scorer", "--app-port", str(app_port),
            "--port", str(self.sidecar_port), "--components", str(self.components),
            "--registry-file", str(self.registry))

    async def stats(self) -> dict:
        status, _, body = await _http(self.app_port, "GET", "/ml/stats")
        check(status == 200, f"/ml/stats answered {status}")
        return json.loads(body)

    async def stop(self) -> dict:
        """SIGTERM the sidecar, then stop the app; returns its /ml/stats."""
        stats = await self.stats()
        self.procs.stop(self.name)
        await self.app.stop()
        return stats


async def _stored(scorer: _Scorer, published: dict[str, float], seconds: float) -> dict:
    await _until(lambda: all(k in scorer.stored_at for k in published), seconds,
                 f"events not stored: {sum(k in scorer.stored_at for k in published)} of "
                 f"{len(published)}")
    return _p50_max_ms([scorer.stored_at[k] - t for k, t in published.items()])


def _broker_rows(path: Path) -> list[tuple]:
    with contextlib.closing(sqlite3.connect(path)) as conn:
        return conn.execute("SELECT msg_id, grp, attempts, done FROM deliveries").fetchall()


def _store_keys(path: Path) -> list[str]:
    with contextlib.closing(sqlite3.connect(path)) as conn:
        return [row[0] for row in conn.execute("SELECT key FROM state ORDER BY key")]


async def _sidecar_phase(data: Path) -> dict:
    comps, registry = data / "components", data / "apps.json"
    _write_components(comps, data)
    procs = _Processes(data)
    gate = threading.Event()  # holds the scorer's warm-up
    real_init = service.init_params

    def gated_init(*args, **kwargs):
        check(gate.wait(120), "the warm-up gate was never opened")
        return real_init(*args, **kwargs)

    publisher = App("some-api")
    scorer = None
    service.init_params = gated_init
    try:
        pub_sidecar = _free_port()
        pub_app_port = await cli.start_app(publisher, sidecar_port=pub_sidecar)
        started = time.monotonic()
        scorer = _Scorer(procs, _free_port(), comps, registry, "scorer-sidecar")
        await asyncio.gather(scorer.start(), procs.start(
            "publisher-sidecar", "sidecar", "--app-id", "some-api", "--app-port",
            str(pub_app_port), "--port", str(pub_sidecar), "--components", str(comps),
            "--registry-file", str(registry)))
        processes_ready_s = time.monotonic() - started

        async def publish(task: dict, published: dict) -> None:
            published[task["taskId"]] = time.monotonic()
            await asyncio.wait_for(publisher.client.publish_event(PUBSUB, TOPIC, task), 30)

        async def score(task: dict):
            sent = time.monotonic()
            reply = await asyncio.wait_for(publisher.client.invoke_method(
                "priority-scorer", "score", data=task), 60)
            return reply, time.monotonic() - sent

        # warm-up: every event meets the 503 before the model loads
        warm = {}
        for i in range(SIDECAR_WARMUP_EVENTS):
            await publish(_saved_task("sc-early", i), warm)

        async def delivered_503() -> float:
            status, _, body = await _http(scorer.sidecar_port, "GET", "/v1.0/metadata")
            check(status == 200, f"/v1.0/metadata answered {status}")
            return json.loads(body)["metrics"].get(DELIVERED_503, 0)

        deadline = time.monotonic() + 30
        while (declined := await delivered_503()) < SIDECAR_WARMUP_EVENTS:
            check(time.monotonic() < deadline, f"{declined} deliveries met the warm-up's 503")
            await asyncio.sleep(0.05)
        gate.set()
        await asyncio.wait_for(scorer.app.wait_ready(), 600)
        warm_ms = await _stored(scorer, warm, 60)

        # steady state: events and two-hop /score calls for the same texts
        steady = {}
        tasks = [_saved_task("sc-task", i) for i in range(SIDECAR_EVENTS)]
        calls = [asyncio.ensure_future(score(t)) for t in tasks[:SIDECAR_REQUESTS]]
        for task in tasks:
            await publish(task, steady)
        results = await asyncio.wait_for(asyncio.gather(*calls), 120)
        steady_ms = await _stored(scorer, steady, 120)
        idle = {}
        for i in range(SIDECAR_IDLE_EVENTS):
            await asyncio.sleep(IDLE_GAP_S + i * POLL_INTERVAL_S / SIDECAR_IDLE_EVENTS)
            await publish(_saved_task("sc-idle", i), idle)
            await _stored(scorer, {f"sc-idle-{i}": idle[f"sc-idle-{i}"]}, 30)
        idle_ms = sorted(1e3 * (scorer.stored_at[k] - t) for k, t in idle.items())
        # the remaining texts, so that every stored score meets its /score answer
        rest = [_saved_task("sc-early", i) for i in range(SIDECAR_WARMUP_EVENTS)]
        rest += tasks[SIDECAR_REQUESTS:] + [_saved_task("sc-idle", i)
                                           for i in range(SIDECAR_IDLE_EVENTS)]
        results += await asyncio.wait_for(asyncio.gather(*(score(t) for t in rest)), 120)
        worst = 0.0
        for task, (reply, _) in zip(tasks[:SIDECAR_REQUESTS] + rest, results):
            check(reply.status == 200, f"two-hop /score answered {reply.status}: {reply.body!r}")
            got = await asyncio.wait_for(publisher.client.invoke_method(
                "priority-scorer", f"scores/{task['taskId']}", http_method="GET"), 30)
            check(got.status == 200, f"GET scores/{task['taskId']} answered {got.status}")
            want, got = reply.json(), got.json()
            check(got["priority"] == want["priority"],
                  f"{task['taskId']}: stored {got} but /score answered {want}")
            worst = max(worst, abs(got["confidence"] - want["confidence"]))
        check(worst <= RUNTIME_CONFIDENCE_TOL, f"stored confidence off by {worst}")
        two_hop_ms = _p50_max_ms([seconds for _, seconds in results[:SIDECAR_REQUESTS]])
        stats_first = await scorer.stop()

        # restart: events published while the scorer and its sidecar are down
        down = {}
        for i in range(RESTART_EVENTS):
            await publish(_saved_task("sc-restart", i), down)
        pending = [r for r in _broker_rows(data / "broker.db")
                   if r[1] == "priority-scorer" and r[3] == 0]
        check(len(pending) == RESTART_EVENTS,
              f"the broker file holds {len(pending)} pending events, not {RESTART_EVENTS}")
        restarted = time.monotonic()
        scorer = _Scorer(procs, scorer.sidecar_port, comps, registry, "scorer-sidecar-2")
        await scorer.start()
        await asyncio.wait_for(scorer.app.wait_ready(), 600)
        restart_ms = await _stored(scorer, down, 120)
        drain_s = max(scorer.stored_at[k] for k in down) - restarted
        stats_second = await scorer.stop()
        scorer = None
        procs.stop("publisher-sidecar")

        keys = _store_keys(data / "scores.db")
        want_keys = sorted(f"priority-scorer||{k}" for k in (*warm, *steady, *idle, *down))
        check(keys == want_keys, f"the store file holds {len(keys)} keys, not {len(want_keys)}")
        rows = _broker_rows(data / "broker.db")
        check(all(r[3] == 1 for r in rows), f"not every delivery acked: {rows}")
        # a deferral that charged an attempt would leave one above 1
        check(all(r[2] == 1 for r in rows),
              f"deliveries charged {sorted({r[2] for r in rows})} attempts")

        # host: app and sidecar in one process on the card
        ready = await procs.start("host", "host", "tasksrunner_torch.service:make_app",
                                  "--components", str(comps), "--registry-file", str(registry))
        host_sidecar = int(ready["sidecar_port"])
        status, _, _ = await _http(host_sidecar, "GET", "/v1.0/healthz")
        check(status == 204, f"host /v1.0/healthz answered {status}")
        body = json.dumps(_saved_task("sc-host", 0)).encode()
        deadline = time.monotonic() + 600
        while (reply := await _http(host_sidecar, "POST",
                                    "/v1.0/invoke/priority-scorer/method/score", body))[0] == 503:
            check(time.monotonic() < deadline, "the host's scorer never warmed up")
            await asyncio.sleep(0.25)
        check(reply[0] == 200 and json.loads(reply[2])["priority"] in service.PRIORITY_LABELS,
              f"host /score answered {reply[0]}: {reply[2]!r}")
        procs.stop("host")
        return {"processes_ready_s": processes_ready_s,
                "warmup_503_deliveries": declined,
                "event_to_stored_ms": {"warmup": warm_ms, "steady": steady_ms,
                                       "idle_one_at_a_time": idle_ms, "restart": restart_ms},
                "score_two_hop_ms": two_hop_ms, "score_calls": len(results),
                "max_abs_err_confidence": worst, "restart_drain_s": drain_s,
                "stored_keys": len(keys), "deliveries": len(rows), "dead_letters": 0,
                "host_score": json.loads(reply[2]),
                "stats": [stats_first, stats_second]}
    finally:
        service.init_params = real_init
        gate.set()
        procs.kill_all()
        if scorer is not None:
            await scorer.app.stop()
        await publisher.stop()


def phase_sidecar(smi: str) -> int:
    """The scorer behind the port's own sidecar processes over the sqlite
    store and broker files: returns B1's launches."""
    cards = torch.cuda.device_count()
    reset_counts()
    started = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-sidecar-") as data:
        result = asyncio.run(_sidecar_phase(Path(data)))
    launched = counts()
    expected = sum(expected_serve_launches(stats, cards) for stats in result["stats"])
    emit({"phase": "sidecar", "nvidia_smi": smi, **result,
          "seconds": time.monotonic() - started, "flash_launches": launched["flash_fwd"],
          "expected_launches": expected})
    check(launched["flash_fwd"] == expected,
          f"sidecar phase: flash launches {launched['flash_fwd']} != {expected}")
    check(all(v == 0 for k, v in launched.items() if k != "flash_fwd"),
          f"the sidecar phase launched a backward or ring kernel: {launched}")
    return launched["flash_fwd"]


# the orchestrator phase: python -m tasksrunner_torch run with the scorer
# as its one app, 1 to 3 replicas by the broker's backlog (+1 per 16
# events), a cooldown of 3 s and liveness probes every second
ORCH_MAX, ORCH_PER_REPLICA, ORCH_COOLDOWN_S = 3, 16, 3
ORCH_FIRST, ORCH_BURST, ORCH_CALLS, ORCH_CRASH = 32, 192, 32, 64
# a killed replica's claimed events come back after this lease (the
# sample's broker names none: 30 s by default)
ORCH_CLAIM_LEASE_S = 5
SCORE_TOL = 2e-2  # §2's forward tolerance
DELIVERED_200 = "pubsub_delivery{route=/on-task-saved,status=200}"
APP_ID = "priority-scorer"
SCALED_OUT = f"scaling {APP_ID} out: "
SCALED_IN = f"scaling {APP_ID} in: "


class _Lines:
    """A process's output lines, each with the monotonic time it was read."""

    def __init__(self, stream, log: Path | None = None) -> None:
        self.lines: list[tuple[float, str]] = []
        self._log = open(log, "w") if log is not None else None
        self._thread = threading.Thread(target=self._read, args=(stream,), daemon=True)
        self._thread.start()

    def _read(self, stream) -> None:
        for line in stream:
            self.lines.append((time.monotonic(), line.rstrip("\n")))
            if self._log is not None:
                self._log.write(line)
                self._log.flush()

    def find(self, text: str) -> list[tuple[float, str]]:
        return [(t, line) for t, line in list(self.lines) if text in line]

    def join(self) -> None:
        self._thread.join(timeout=30)
        if self._log is not None:
            self._log.close()


class _StoreWatch:
    """Polls the scores store file every 10 ms and notes when each key
    first shows: an event's stored time, as another process sees it."""

    def __init__(self, path: Path) -> None:
        self.path = path
        self.first_seen: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self) -> None:
        while not self._stop.is_set():
            if self.path.exists():
                try:
                    with contextlib.closing(sqlite3.connect(self.path, timeout=1)) as conn:
                        keys = [row[0] for row in conn.execute("SELECT key FROM state")]
                except sqlite3.Error:
                    keys = []
                now = time.monotonic()
                for key in keys:
                    self.first_seen.setdefault(key.split("||", 1)[1], now)
            self._stop.wait(0.01)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


def _card_apps() -> tuple[list[tuple[int, str]], str]:
    """nvidia-smi's compute processes, (pid, used memory) each, and the
    card's memory in use."""
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    used = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return [(int(a.split(",")[0]), a.split(",", 1)[1].strip()) for a in apps if a], used


def _check_on_card(pids: list[int], what: str, baseline: int) -> dict:
    """Each pid holds a context on the card. Where nvidia-smi shows this
    machine's pids, each must be listed; where it hides them (a container
    may list every process as pid 1), the listing must hold one context per
    pid beside the ``baseline`` ones listed before the phase (this
    process's, once it has used the card)."""
    apps, used = _card_apps()
    listed = {pid for pid, _ in apps}
    if listed & set(pids):
        check(set(pids) <= listed, f"{what}: replicas {pids} not all on the card: {apps}")
    else:
        check(len(apps) == len(pids) + baseline,
              f"{what}: {len(apps)} compute processes on the card, not {len(pids)} replicas "
              f"beside {baseline}: {apps}")
    return {"replica_pids": pids, "compute_apps": [f"{p}, {m}" for p, m in apps],
            "pids_visible": bool(listed & set(pids)), "memory_used": used}


class _Orchestrated:
    """``python -m tasksrunner_torch run`` as a subprocess, its output and
    its errors read line by line, and its admin API."""

    def __init__(self, run_file: Path, logs: Path, device: str | None,
                 env: dict | None = None, token: str | None = None) -> None:
        device_args = [] if device is None else ["--device", device]
        self.proc = subprocess.Popen([sys.executable, "-m", "tasksrunner_torch", "run",
                                      str(run_file), *device_args], cwd=ROOT,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                     env=env)
        #: the admin API's token, where the orchestrator runs with one
        self.headers = {TOKEN_HEADER: token} if token else None
        self.out = _Lines(self.proc.stdout)
        self.err = _Lines(self.proc.stderr, logs / "orchestrator.log")
        self.admin_url: str | None = None

    def ready(self, index: int, app_id: str = APP_ID) -> list[tuple[float, dict]]:
        """Each incarnation of replica ``index``'s ready line: (time, fields)."""
        return [(t, dict(kv.split("=", 1) for kv in line.split(" ready ", 1)[1].split()))
                for t, line in self.out.find(f"[{app_id}·{index}] ready ")]

    def spawned(self, index: int, app_id: str = APP_ID) -> list[tuple[float, int]]:
        return [(t, int(line.rsplit("(pid ", 1)[1].rstrip(")")))
                for t, line in self.err.find(f"started replica {app_id}·{index} (pid ")]

    async def admin(self, method: str, path: str, body=None) -> dict:
        port = int(self.admin_url.rsplit(":", 1)[1])
        status, _, reply = await _http(port, method, "/admin" + path,
                                       json.dumps(body).encode() if body is not None else b"",
                                       headers=self.headers)
        check(status == 200, f"admin {method} {path} answered {status}: {reply!r}")
        return json.loads(reply)

    async def replicas(self) -> list[dict]:
        return (await self.admin("GET", "/apps"))["apps"][0]["replicas"]

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=120)
        self.out.join()
        self.err.join()
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _backlog(path: Path) -> int:
    with contextlib.closing(sqlite3.connect(path, timeout=5)) as conn:
        return conn.execute("SELECT COUNT(*) FROM deliveries WHERE grp = ? AND done = 0",
                            (APP_ID,)).fetchone()[0]


async def _delivered(sidecar_port: int) -> float:
    status, _, body = await _http(sidecar_port, "GET", "/v1.0/metadata")
    check(status == 200, f"/v1.0/metadata answered {status}")
    return json.loads(body)["metrics"].get(DELIVERED_200, 0)


def _mib(used: str) -> float:
    return float(used.split()[0])


async def _orchestrator_phase(data: Path, device: str | None = None) -> dict:
    """The phase's run; ``device`` goes to ``run`` as ``--device`` and
    places the reference scores (None: the card)."""
    comps, registry = data / "components", data / "apps.json"
    _write_components(comps, data)
    with open(comps / "pubsub-redis.yaml", "a") as f:
        f.write(f"  - name: claimLeaseSeconds\n    value: \"{ORCH_CLAIM_LEASE_S}\"\n")
    run_file = data / "run.yaml"
    run_file.write_text(
        f"resources_path: {comps}\nregistry_file: {registry}\napps:\n"
        f"  - app_id: {APP_ID}\n    module: tasksrunner_torch.service:make_app\n"
        "    health: { interval_seconds: 1 }\n"
        f"    scale:\n      min_replicas: 1\n      max_replicas: {ORCH_MAX}\n"
        f"      cooldown_seconds: {ORCH_COOLDOWN_S}\n      rules:\n"
        f"        - type: pubsub-backlog\n          metadata:\n            component: {PUBSUB}\n"
        f"            topic: {TOPIC}\n            messageCount: \"{ORCH_PER_REPLICA}\"\n")
    procs = _Processes(data)
    publisher = App("some-api")
    baseline = len(_card_apps()[0])
    orch = _Orchestrated(run_file, data, device)
    phase_t = time.monotonic()
    watch = _StoreWatch(data / "scores.db")
    published: dict[str, float] = {}  # task id → when it was published
    tasks_by_id: dict[str, dict] = {}
    last_stats: dict[int, dict] = {}  # replica pid → its last /ml/stats
    n_events = [0]
    try:
        pub_sidecar = _free_port()
        pub_app_port = await cli.start_app(publisher, sidecar_port=pub_sidecar)
        await procs.start("publisher-sidecar", "sidecar", "--app-id", "some-api", "--app-port",
                          str(pub_app_port), "--port", str(pub_sidecar), "--components",
                          str(comps), "--registry-file", str(registry),
                          *([] if device is None else ["--device", device]))

        async def publish(n: int, prefix: str) -> dict[str, float]:
            tasks = [_saved_task(prefix, n_events[0] + i) for i in range(n)]
            n_events[0] += n
            tasks_by_id.update((t["taskId"], t) for t in tasks)
            sent = {}

            async def one(task: dict) -> None:
                sent[task["taskId"]] = time.monotonic()
                await asyncio.wait_for(publisher.client.publish_event(PUBSUB, TOPIC, task), 60)
            await asyncio.gather(*(one(t) for t in tasks))
            published.update(sent)
            return sent

        async def drained(sent: dict[str, float], seconds: float) -> dict:
            await _until(lambda: all(k in watch.first_seen for k in sent), seconds,
                         f"events not stored: {sum(k in watch.first_seen for k in sent)} of "
                         f"{len(sent)}")
            first = min(sent.values())
            last = max(watch.first_seen[k] for k in sent)
            return {"events": len(sent), "drain_s": last - first,
                    "events_per_s": len(sent) / (last - first),
                    "event_to_stored_ms": _p50_max_ms(
                        [watch.first_seen[k] - t for k, t in sent.items()])}

        async def stats(app_port: int) -> dict:
            status, _, body = await _http(app_port, "GET", "/ml/stats")
            check(status == 200, f"/ml/stats answered {status}")
            return json.loads(body)

        async def until_ready(index: int, incarnation: int, seconds: float) -> tuple[float, dict]:
            await _until(lambda: len(orch.ready(index)) >= incarnation, seconds,
                         f"replica {index} printed no ready line (incarnation {incarnation})")
            t, fields = orch.ready(index)[incarnation - 1]
            while not (await stats(int(fields["app_port"])))["ready"]:
                await asyncio.sleep(0.05)
            return t, fields

        async def sustain(until, what: str, seconds: float = 120) -> None:
            """Publish while ``until()`` is false, keeping the backlog at
            ORCH_MAX × ORCH_PER_REPLICA or above, so that the scaler
            holds the replicas it asked for (traffic that goes on)."""
            deadline = time.monotonic() + seconds
            while not await until():
                check(time.monotonic() < deadline, what)
                if _backlog(data / "broker.db") < ORCH_MAX * ORCH_PER_REPLICA:
                    await publish(ORCH_PER_REPLICA, "or-sustain")
                await asyncio.sleep(0.05)

        # 1. replica 0 alone
        ready0_t, fields0 = await until_ready(0, 1, 600)
        orch.admin_url = json.loads((data / "orchestrator.json").read_text())["admin_url"]
        spawn_ready_s = {"0": ready0_t - orch.spawned(0)[0][0]}
        # the ceiling at 1 while they drain (32 events would ask for 2)
        await orch.admin("POST", f"/apps/{APP_ID}/scale", {"max_replicas": 1})
        one_replica = await drained(await publish(ORCH_FIRST, "or-first"), 60)

        # 2. the ceiling back at 3, then a burst: the scaler's decision, each
        # new replica's ready line and first score
        await orch.admin("POST", f"/apps/{APP_ID}/scale", {"max_replicas": ORCH_MAX})
        check(not orch.err.find(SCALED_OUT), "a scale-out under the ceiling of 1")
        burst_t = time.monotonic()
        burst = await publish(ORCH_BURST, "or-burst")
        await _until(lambda: orch.err.find(SCALED_OUT), 60, "no scale-out decision")
        decision_t, decision = orch.err.find(SCALED_OUT)[0]
        ports: dict[int, int] = {0: int(fields0["sidecar_port"])}
        first_score: dict[int, float] = {}

        async def all_serving() -> bool:
            for i in range(1, ORCH_MAX):
                if i not in ports and orch.ready(i):
                    ports[i] = int(orch.ready(i)[0][1]["sidecar_port"])
                if i in ports and i not in first_score and await _delivered(ports[i]) > 0:
                    first_score[i] = time.monotonic()
            return len(first_score) == ORCH_MAX - 1

        await sustain(all_serving, "the new replicas did not all serve")
        # 2b. at once, before the cooldown could take a replica: the same
        # burst on three replicas, the card's processes read while they serve
        three = await publish(ORCH_BURST, "or-three")
        replicas = await orch.replicas()
        check(len(replicas) == ORCH_MAX and all(r["running"] for r in replicas),
              f"the scaler did not reach {ORCH_MAX} replicas: {replicas}")
        on_card = _check_on_card([r["pid"] for r in replicas], "while serving", baseline)
        three_replicas = await drained(three, 120)
        revisions = (await orch.admin("GET", f"/apps/{APP_ID}/revisions"))["revisions"]
        check([r["reason"] for r in revisions] == ["initial deploy"] + ["scale update"] * 2,
              f"scaling is no revision, a scale update is: {revisions}")
        for i in range(1, ORCH_MAX):
            spawn_ready_s[str(i)] = orch.ready(i)[0][0] - orch.spawned(i)[0][0]
        scale_out = {
            "publish_to_decision_s": decision_t - burst_t,
            "decision": decision.split(" INFO ")[-1],
            "decision_to_ready_s": {str(i): orch.ready(i)[0][0] - decision_t
                                    for i in range(1, ORCH_MAX)},
            "decision_to_first_score_s": {str(i): first_score[i] - decision_t
                                          for i in range(1, ORCH_MAX)},
            "burst": await drained(burst, 120)}

        # 3. /score through the publisher's sidecar, round robin over the
        # replicas, once no event is left to score
        await _until(lambda: all(k in watch.first_seen for k in published), 120,
                     "not every event was stored")
        before = {r["index"]: (await stats(r["app_port"]))["completed"] for r in replicas}
        score_tasks = [_saved_task("or-score", i) for i in range(ORCH_CALLS)]

        async def score(task: dict):
            sent = time.monotonic()
            reply = await asyncio.wait_for(publisher.client.invoke_method(
                APP_ID, "score", data=task), 60)
            return reply, time.monotonic() - sent

        results = await asyncio.gather(*(score(t) for t in score_tasks))
        for reply, _ in results:
            check(reply.status == 200, f"/score answered {reply.status}: {reply.body!r}")
        answered = {r["index"]: (await stats(r["app_port"]))["completed"] - before[r["index"]]
                    for r in replicas}
        check(sum(answered.values()) == ORCH_CALLS and sum(n > 0 for n in answered.values()) >= 2,
              f"/score calls per replica {answered}: not spread over two or more")

        # 4. kill -9 replica 1 in a burst; its supervisor restarts it. An
        # operator's scale update holds the three from before the kill to
        # after the drain (the killed replica's claimed events wait out
        # their lease), so that no scale-in comes first and the stats read
        # after the drain are each replica's last
        crash = await publish(ORCH_CRASH, "or-crash")
        pinned = (await orch.admin("POST", f"/apps/{APP_ID}/scale",
                                   {"min_replicas": ORCH_MAX}))["revision"]
        replicas = await orch.replicas()
        check(pinned["revision"] == 4 and len(replicas) == ORCH_MAX,
              f"the scale update answered {pinned}: {replicas}")
        victim = replicas[1]
        last_stats[victim["pid"]] = await stats(victim["app_port"])
        os.kill(victim["pid"], signal.SIGKILL)
        killed_t = time.monotonic()
        back_t, fields1 = await until_ready(1, 2, 120)
        check(orch.spawned(1)[-1][1] != victim["pid"], "replica 1 kept its pid")
        crashed = {"killed_pid": victim["pid"], "exit_to_ready_s": back_t - killed_t,
                   "burst": await drained(crash, 120)}
        await _until(lambda: all(k in watch.first_seen for k in published), 120,
                     "not every event was stored")

        # 5. after the drain, every replica's stats; then the floor back at 1
        # and the scale-in after the cooldown
        replicas = await orch.replicas()
        check(len(replicas) == ORCH_MAX and all(r["running"] and r["app_port"]
                                                for r in replicas),
              f"a replica is down after the drain: {replicas}")
        for r in replicas:
            last_stats[r["pid"]] = await stats(r["app_port"])
        restarts = {r["index"]: [r["restarts"], r["health_restarts"]] for r in replicas}
        check(restarts == {0: [0, 0], 1: [1, 0], 2: [0, 0]},
              f"restarts other than the killed replica's: {replicas}")
        released_t = time.monotonic()
        released = (await orch.admin("POST", f"/apps/{APP_ID}/scale",
                                     {"min_replicas": 1}))["revision"]
        check(released["revision"] == 5 and released["min_replicas"] == 1,
              f"the scale update answered {released}")
        await _until(lambda: orch.err.find(SCALED_IN), 60, "no scale-in")
        scale_in_decision_s = orch.err.find(SCALED_IN)[0][0] - released_t
        deadline = time.monotonic() + 60
        while len(await orch.replicas()) > 1:
            check(time.monotonic() < deadline, "the app did not scale in to 1")
            await asyncio.sleep(0.05)
        scaled_in = {"decision_s": scale_in_decision_s,
                     "one_replica_s": time.monotonic() - released_t}
        revisions = (await orch.admin("GET", f"/apps/{APP_ID}/revisions"))["revisions"]
        reasons = [r["reason"] for r in revisions]
        check(reasons == ["initial deploy"] + ["scale update"] * 4, f"revisions {reasons}")
        last_pid = (await orch.replicas())[0]["pid"]

        # 6. SIGTERM: every replica stops and leaves the card and the registry
        rc = orch.stop()
        check(rc == 0, f"the orchestrator exited {rc}: "
                       f"{(data / 'orchestrator.log').read_text()[-3000:]}")
        after = _check_on_card([], "after the stop", baseline)
        procs.stop("publisher-sidecar")
        left = json.loads(registry.read_text())
        check(left == {}, f"entries left in the registry: {left}")
        counted = {}
        for _, line in orch.out.find(" kernel launches app=priority-scorer pid="):
            pid, launches = line.split(" pid=", 1)[1].split(" ", 1)
            counted[int(pid)] = json.loads(launches)
        serving = [p for p in last_stats if p != victim["pid"]]
        check(sorted(counted) == sorted(serving),
              f"kernel launch lines for {sorted(counted)}, replicas {sorted(serving)}")
        cards = torch.cuda.device_count()
        expected = {p: expected_serve_launches(last_stats[p], cards) for p in serving}
        check(all(counted[p]["flash_fwd"] == expected[p] for p in serving),
              f"B1 launches {counted} != expected {expected}")
        check(all(v == 0 for c in counted.values() for k, v in c.items() if k != "flash_fwd"),
              f"a replica launched a backward or ring kernel: {counted}")
        check(last_pid in counted, "the last replica logged no launch counts")
        watch.stop()

        # every event stored once under its key, no dead letter
        keys = _store_keys(data / "scores.db")
        check(keys == sorted(f"{APP_ID}||{k}" for k in published),
              f"the store file holds {len(keys)} keys, not {len(published)}")
        rows = [r for r in _broker_rows(data / "broker.db") if r[1] == APP_ID]
        check(len(rows) == len(published) and all(r[3] == 1 for r in rows),
              f"deliveries not all acked once: {len(rows)} rows, "
              f"{sum(r[3] == 2 for r in rows)} dead letters")
        # the stored scores against the scorer's math in this process
        with contextlib.closing(sqlite3.connect(data / "scores.db")) as conn:
            stored = {k.split("||", 1)[1]: json.loads(v)
                      for k, v in conn.execute("SELECT key, value FROM state")}
        ref_device = torch.device("cuda", 0) if device is None else torch.device(device)
        ids = sorted(stored)
        probs = service.batch_probs(
            [init_params(SERVED, 0, ref_device)], [ref_device],
            np.stack([service.task_tokens(tasks_by_id[k], SERVED) for k in ids]), cfg=SERVED)
        worst = 0.0
        for row, k in zip(probs, ids):
            label = service.PRIORITY_LABELS.index(stored[k]["priority"])
            check(row[label] >= row.max() - SCORE_TOL,
                  f"{k}: stored {stored[k]} but the scorer gives {row.tolist()}")
            worst = max(worst, abs(float(row[label]) - stored[k]["confidence"]))
        check(worst <= SCORE_TOL, f"stored confidence off by {worst}")
        per_replica_mib = (_mib(on_card["memory_used"]) - _mib(after["memory_used"])) / ORCH_MAX
        return {"spawn_to_ready_s": spawn_ready_s, "one_replica": one_replica,
                "scale_out": scale_out, "three_replicas": three_replicas,
                "score_ms": _p50_max_ms([s for _, s in results]), "score_per_replica": answered,
                "crash": crashed, "restarts_and_health_restarts": restarts,
                "scale_in_after_floor_released": scaled_in,
                "scaler": [(t - phase_t, line.split(" INFO ")[-1]) for t, line
                           in orch.err.find(f"scaling {APP_ID} ")],
                "revisions": [(r["created"] - revisions[0]["created"], r["reason"],
                               {k: r[k] for k in r if k.endswith("_replicas")})
                              for r in revisions],
                "on_card": on_card, "after_stop": after,
                "card_memory_per_replica_mib": per_replica_mib,
                "events": len(published), "stored_keys": len(keys), "dead_letters": 0,
                "max_abs_err_confidence": worst, "launches": {str(p): c["flash_fwd"]
                                                              for p, c in counted.items()},
                "expected_launches": {str(p): e for p, e in expected.items()}}
    except BaseException:
        # what the orchestrator and its replicas said, for the failure
        for t, line in sorted(orch.err.lines + [x for x in orch.out.lines if any(
                w in x[1] for w in (" ready ", "WARNING", "ERROR", "Traceback", "Error"))]
                )[-80:]:
            print(f"{t - phase_t:9.3f} {line}", file=sys.stderr)
        raise
    finally:
        watch.stop()
        orch.kill()
        for entry in (json.loads(registry.read_text()).get(APP_ID, [])
                      if registry.exists() else []):
            with contextlib.suppress(ProcessLookupError):
                os.kill(entry["pid"], signal.SIGKILL)  # replicas a failed run left behind
        procs.kill_all()
        await publisher.stop()


def phase_orchestrator(smi: str) -> int:
    """The scorer supervised and autoscaled by ``python -m
    tasksrunner_torch run``: returns B1's launches in its replicas."""
    started = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-orchestrator-") as data:
        result = asyncio.run(_orchestrator_phase(Path(data)))
    launched = sum(result["launches"].values())
    emit({"phase": "orchestrator", "nvidia_smi": smi, **result,
          "seconds": time.monotonic() - started, "flash_launches": launched})
    check(launched > 0, "the orchestrated replicas launched no flash kernel")
    return launched


# the deploy phase: the scorer deployed from a manifest whose state store
# takes its database path from a file secret store, 1 to 2 replicas by the
# broker's backlog, per-app tokens and a required API token; a publisher's
# sidecar holds the sample's Resiliency document retargeted at the scorer
DEPLOY_TOKEN, DEPLOY_ENV, DEPLOY_KEY_VAR = "deploy-smoke-token", "smoke-env", "SMOKE_SCORER_KEY"
DEPLOY_EVENTS, DEPLOY_WAVES, DEPLOY_WAVE = 64, 4, 16
SAMPLE_ROOT = SAMPLE_COMPONENTS.parent
PUBLISHER_GRANTS = {PUBSUB: [{"publish": [TOPIC]}]}


def _deploy_files(data: Path) -> Path:
    """The manifest, its components and the secret file; returns the
    manifest's path. The state store is the sample's cloud-dialect file
    named ``scores`` and scoped to the scorer, its ``databasePath`` a
    ``secretRef`` into the ``vault`` store; the broker is the sample's."""
    comps = data / "components"
    comps.mkdir()
    (data / "secrets.json").write_text(json.dumps({"scores-db": str(data / "scores.db")}))
    (comps / "vault.yaml").write_text(
        "componentType: secretstores.local.file\nversion: v1\nmetadata:\n"
        f"- name: secretsFile\n  value: {data / 'secrets.json'}\n")
    store = (SAMPLE_ROOT / "aca-components" / "containerapps-statestore.yaml").read_text()
    check("  value: .tasksrunner/statestore.db\n" in store, "the sample's store file changed")
    (comps / "scores.yaml").write_text(
        "secretStoreComponent: vault\n" + store
        .replace("  value: .tasksrunner/statestore.db\n", "  secretRef: scores-db\n")
        .replace("- tasksmanager-backend-api", f"- {APP_ID}"))
    (comps / "pubsub.yaml").write_text(
        (SAMPLE_COMPONENTS / "pubsub-redis.yaml").read_text()
        .replace(".tasksrunner/pubsub-local.db", str(data / "broker.db"))
        + f"  - name: claimLeaseSeconds\n    value: \"{ORCH_CLAIM_LEASE_S}\"\n")
    manifest = data / "env.yaml"
    manifest.write_text(
        f"environment:\n  name: {DEPLOY_ENV}\n  per_app_tokens: true\n"
        "  require_api_token: true\ncomponents:\n  - name: vault\n    file: components/vault.yaml\n"
        "  - name: scores\n    file: components/scores.yaml\n"
        f"  - name: {PUBSUB}\n    file: components/pubsub.yaml\n"
        f"apps:\n  - app_id: {APP_ID}\n    module: tasksrunner_torch.service:make_app\n"
        "    ingress: internal\n    health: { interval_seconds: 1 }\n"
        f"    secrets:\n      api-key: {{ env: {DEPLOY_KEY_VAR} }}\n"
        f"    grants:\n      scores: [read, write]\n      vault: [read]\n"
        f"      {PUBSUB}:\n        - subscribe: [{TOPIC}]\n"
        "    scale:\n      min_replicas: 1\n      max_replicas: 2\n"
        f"      cooldown_seconds: {ORCH_COOLDOWN_S}\n      rules:\n"
        f"        - type: pubsub-backlog\n          metadata:\n            component: {PUBSUB}\n"
        f"            topic: {TOPIC}\n            messageCount: \"{ORCH_PER_REPLICA}\"\n")
    return manifest


def _deploy_verb(env: dict, action: str, manifest: Path, rc: int = 0) -> tuple[list[str], float]:
    """``python -m tasksrunner_torch deploy ACTION MANIFEST``: its output's
    lines and its seconds; exits ``rc`` or fails."""
    started = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "tasksrunner_torch", "deploy", action,
                          str(manifest)], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    check(out.returncode == rc, f"deploy {action} exited {out.returncode}, not {rc}: "
                                f"{out.stdout}{out.stderr[-2000:]}")
    return out.stdout.splitlines(), time.monotonic() - started


def _proc_env(pid: int) -> dict[str, str]:
    """The environment a replica was started with, as the host shows it."""
    raw = Path(f"/proc/{pid}/environ").read_bytes().split(b"\0")
    return dict(e.decode().split("=", 1) for e in raw if b"=" in e)


async def _deploy_phase(data: Path) -> dict:
    """The phase's run, on the card."""
    manifest = _deploy_files(data)
    registry = data / ".tasksrunner" / "apps.json"
    env = {**os.environ, TOKEN_ENV: DEPLOY_TOKEN, DEPLOY_KEY_VAR: "sk-smoke"}
    verbs: dict[str, float] = {}

    # 1. validate; a broken copy (a cron binding whose scope names no app)
    lines, verbs["validate"] = _deploy_verb(env, "validate", manifest)
    check(lines == [f"manifest '{DEPLOY_ENV}' is valid (1 apps, 3 components)"], f"{lines}")
    broken = data / "broken"
    broken.mkdir()
    (broken / "components").symlink_to(data / "components")
    (broken / "cron.yaml").write_text(
        (SAMPLE_ROOT / "aca-components" / "containerapps-scheduled-cron.yaml").read_text())
    (broken / "env.yaml").write_text(manifest.read_text().replace(
        "components:\n", "components:\n  - name: nightly\n    file: cron.yaml\n", 1))
    problems, verbs["validate_broken"] = _deploy_verb(env, "validate", broken / "env.yaml", 1)
    check(problems == ["ERROR: component 'nightly': scope 'tasksmanager-backend-processor' "
                       "matches no app"], f"the broken manifest's problems: {problems}")
    # 2. what-if, apply, what-if
    created, verbs["what_if"] = _deploy_verb(env, "what-if", manifest)
    check(created == [f"+ {DEPLOY_ENV}"], f"the first what-if: {created}")
    applied, verbs["apply"] = _deploy_verb(env, "apply", manifest)
    run_file = data / ".tasksrunner" / f"{DEPLOY_ENV}-run.yaml"
    check(applied[-1] == f"start with: python -m tasksrunner_torch run {run_file}", f"{applied}")
    again, verbs["what_if_again"] = _deploy_verb(env, "what-if", manifest)
    check(again == ["no changes — recorded state matches the manifest"], f"{again}")

    procs = _Processes(data)
    publisher = App("some-api")
    baseline = len(_card_apps()[0])
    orch = _Orchestrated(run_file, data, None, env=env, token=DEPLOY_TOKEN)
    phase_t = time.monotonic()
    watch = _StoreWatch(data / "scores.db")
    saved_token = os.environ.get(TOKEN_ENV)
    published: dict[str, float] = {}
    tasks_by_id: dict[str, dict] = {}
    try:
        async def stats(app_port: int) -> dict:
            status, _, body = await _http(app_port, "GET", "/ml/stats")
            check(status == 200, f"/ml/stats answered {status}")
            return json.loads(body)

        async def until_ready(index: int, incarnation: int, seconds: float) -> dict:
            await _until(lambda: len(orch.ready(index)) >= incarnation, seconds,
                         f"replica {index} printed no ready line (incarnation {incarnation})")
            fields = orch.ready(index)[incarnation - 1][1]
            while not (await stats(int(fields["app_port"])))["ready"]:
                await asyncio.sleep(0.05)
            return fields

        # 3. the applied run file on the card: replica 0, then the floor at
        # 2 (the scaler's range is 1-2) so that both serve until the stop
        fields0 = await until_ready(0, 1, 600)
        spawn_ready_s = {"0": orch.ready(0)[0][0] - orch.spawned(0)[0][0]}
        orch.admin_url = json.loads((registry.parent / "orchestrator.json").read_text()
                                    )["admin_url"]
        await orch.admin("POST", f"/apps/{APP_ID}/scale", {"min_replicas": 2})
        fields1 = await until_ready(1, 1, 300)
        spawn_ready_s["1"] = orch.ready(1)[0][0] - orch.spawned(1)[0][0]
        replicas = await orch.replicas()
        check(len(replicas) == 2, f"not two replicas: {replicas}")
        # the app's own token (per_app_tokens), and its secret from the
        # deploying environment, as the host shows the replica's start
        started_with = _proc_env(replicas[0]["pid"])
        scorer_token = started_with.get(TOKEN_ENV)
        check(scorer_token not in (None, DEPLOY_TOKEN), "the replica has no token of its own")
        check(started_with.get("API_KEY") == "sk-smoke", "the manifest's secret is not in env")
        on_card = _check_on_card([r["pid"] for r in replicas], "while serving", baseline)

        # 4. the publisher: the applied components and the sample's
        # Resiliency document retargeted at the scorer, timeout and retry
        # only. It is the one caller outside the run file, so it holds the
        # scorer's token, read where an operator on the host can read it.
        pub_comps = data / "publisher"
        pub_comps.mkdir()
        for comp in (data / ".tasksrunner" / f"{DEPLOY_ENV}-components").iterdir():
            (pub_comps / comp.name).write_text(comp.read_text())
        policy = (SAMPLE_COMPONENTS / "resiliency.yaml").read_text()
        check("      tasksmanager-backend-api:\n" in policy
              and "        circuitBreaker: api-breaker\n" in policy,
              "the sample's resiliency file changed")
        (pub_comps / "resiliency.yaml").write_text(
            policy.replace("      tasksmanager-backend-api:\n", f"      {APP_ID}:\n")
            .replace("        circuitBreaker: api-breaker\n", ""))
        os.environ[TOKEN_ENV] = scorer_token
        pub_sidecar = _free_port()
        pub_app_port = await cli.start_app(publisher, sidecar_port=pub_sidecar)
        await procs.start("publisher-sidecar", "sidecar", "--app-id", "some-api", "--app-port",
                          str(pub_app_port), "--port", str(pub_sidecar), "--components",
                          str(pub_comps), "--registry-file", str(registry),
                          env={**os.environ, "TASKSRUNNER_GRANTS": json.dumps(PUBLISHER_GRANTS)})

        # 5. events: each stored once, in the file the secret names
        tasks = [_saved_task("dp", i) for i in range(DEPLOY_EVENTS)]
        tasks_by_id.update((t["taskId"], t) for t in tasks)

        async def publish(task: dict) -> None:
            published[task["taskId"]] = time.monotonic()
            await asyncio.wait_for(publisher.client.publish_event(PUBSUB, TOPIC, task), 60)
        await asyncio.gather(*(publish(t) for t in tasks))
        await _until(lambda: all(k in watch.first_seen for k in published), 120,
                     f"events not stored: {sum(k in watch.first_seen for k in published)} of "
                     f"{len(published)}")
        first, last = min(published.values()), max(watch.first_seen[k] for k in published)
        events = {"events": len(published), "drain_s": last - first,
                  "events_per_s": len(published) / (last - first),
                  "event_to_stored_ms": _p50_max_ms(
                      [watch.first_seen[k] - t for k, t in published.items()])}

        # 6. the secrets route: the scorer's grant opens it, the publisher's not
        secret_path = "/v1.0/secrets/vault/scores-db"
        status, _, body = await _http(int(fields0["sidecar_port"]), "GET", secret_path,
                                      headers={TOKEN_HEADER: scorer_token})
        check((status, json.loads(body)) == (200, {"scores-db": str(data / "scores.db")}),
              f"the scorer's secret read answered {status}: {body!r}")
        status, _, body = await _http(pub_sidecar, "GET", secret_path,
                                      headers={TOKEN_HEADER: scorer_token})
        check(status == 403 and b"no 'read' grant on component 'vault'" in body,
              f"the publisher's secret read answered {status}: {body!r}")
        status, _, _ = await _http(int(fields0["sidecar_port"]), "GET", secret_path,
                                   headers={TOKEN_HEADER: DEPLOY_TOKEN})
        check(status == 401, f"the deploying token opened the scorer's sidecar ({status})")
        secret_cli = subprocess.run(
            [sys.executable, "-m", "tasksrunner_torch", "secret", "vault", "scores-db",
             "--app-id", APP_ID, "--registry-file", str(registry)], cwd=ROOT,
            env={**os.environ, TOKEN_ENV: scorer_token}, capture_output=True, text=True,
            timeout=120)
        check(secret_cli.returncode == 0 and json.loads(secret_cli.stdout) == {
            "scores-db": str(data / "scores.db")}, f"secret: {secret_cli}")

        # 7. two-hop /score in waves over both replicas; replica 1 killed
        # with SIGKILL after the first: the publisher's policy retries
        # what met the dead replica, and every call answers 200
        score_ms: list[float] = []

        async def score(task: dict) -> None:
            sent = time.monotonic()
            reply = await asyncio.wait_for(publisher.client.invoke_method(
                APP_ID, "score", data=task), 60)
            check(reply.status == 200, f"/score answered {reply.status}: {reply.body!r}")
            score_ms.append((time.monotonic() - sent) * 1e3)

        last_stats = {r["pid"]: await stats(r["app_port"]) for r in replicas}
        victim = replicas[1]
        killed_t = None
        for wave in range(DEPLOY_WAVES):
            calls = [_saved_task(f"dp-score{wave}", i) for i in range(DEPLOY_WAVE)]
            running = asyncio.gather(*(score(t) for t in calls))
            if wave == 1:
                await asyncio.sleep(0.005)  # the wave in flight
                last_stats[victim["pid"]] = await stats(victim["app_port"])
                os.kill(victim["pid"], signal.SIGKILL)
                killed_t = time.monotonic()
            await running
        status, _, body = await _http(pub_sidecar, "GET", "/v1.0/metadata",
                                      headers={TOKEN_HEADER: scorer_token})
        check(status == 200, f"the publisher's metadata answered {status}")
        caller_metrics = json.loads(body)["metrics"]
        retries = caller_metrics.get(f"resiliency_retry_total{{target={APP_ID}}}", 0)
        exhausted = caller_metrics.get(f"resiliency_retry_exhausted_total{{target={APP_ID}}}", 0)
        print(f"deploy: resiliency_retry_total{{target={APP_ID}}} = {retries}", flush=True)
        check(len(score_ms) == DEPLOY_WAVES * DEPLOY_WAVE and exhausted == 0,
              f"{len(score_ms)} /score answers, {exhausted} exhausted")
        check(retries > 0, "no call met the killed replica: nothing was retried")
        fields1b = await until_ready(1, 2, 120)
        crash_ready_s = orch.ready(1)[1][0] - killed_t

        # 8. SIGTERM: every replica stops, each cleanly stopped one logs its
        # launches; nothing left on the card or in the registry
        replicas = await orch.replicas()
        check(len(replicas) == 2 and replicas[1]["pid"] != victim["pid"],
              f"replica 1 did not come back: {replicas}")
        for r in replicas:
            last_stats[r["pid"]] = await stats(r["app_port"])
        rc = orch.stop()
        check(rc == 0, f"the orchestrator exited {rc}: "
                       f"{(data / 'orchestrator.log').read_text()[-3000:]}")
        procs.stop("publisher-sidecar")
        after = _check_on_card([], "after the stop", baseline)
        left = json.loads(registry.read_text())
        check(left == {}, f"entries left in the registry: {left}")
        counted = {}
        for _, line in orch.out.find(f" kernel launches app={APP_ID} pid="):
            pid, launches = line.split(" pid=", 1)[1].split(" ", 1)
            counted[int(pid)] = json.loads(launches)
        serving = sorted(r["pid"] for r in replicas)
        check(sorted(counted) == serving, f"launch lines for {sorted(counted)}, not {serving}")
        expected = {p: expected_serve_launches(last_stats[p], torch.cuda.device_count())
                    for p in serving}
        check(all(counted[p]["flash_fwd"] == expected[p] for p in serving),
              f"B1 launches {counted} != expected {expected}")
        check(all(v == 0 for c in counted.values() for k, v in c.items() if k != "flash_fwd"),
              f"a replica launched a backward or ring kernel: {counted}")
        watch.stop()

        # every event stored once, in the secret's file; no dead letter;
        # the stored scores against the scorer's math in this process
        keys = _store_keys(data / "scores.db")
        check(keys == sorted(f"{APP_ID}||{k}" for k in published),
              f"the store file holds {len(keys)} keys, not {len(published)}")
        rows = [r for r in _broker_rows(data / "broker.db") if r[1] == APP_ID]
        check(len(rows) == len(published) and all(r[3] == 1 for r in rows),
              f"deliveries not all acked once: {len(rows)} rows, "
              f"{sum(r[3] == 2 for r in rows)} dead letters")
        with contextlib.closing(sqlite3.connect(data / "scores.db")) as conn:
            stored = {k.split("||", 1)[1]: json.loads(v)
                      for k, v in conn.execute("SELECT key, value FROM state")}
        ref_device = torch.device("cuda", 0)
        ids = sorted(stored)
        probs = service.batch_probs(
            [init_params(SERVED, 0, ref_device)], [ref_device],
            np.stack([service.task_tokens(tasks_by_id[k], SERVED) for k in ids]), cfg=SERVED)
        worst = 0.0
        for row, k in zip(probs, ids):
            label = service.PRIORITY_LABELS.index(stored[k]["priority"])
            check(row[label] >= row.max() - SCORE_TOL,
                  f"{k}: stored {stored[k]} but the scorer gives {row.tolist()}")
            worst = max(worst, abs(float(row[label]) - stored[k]["confidence"]))
        check(worst <= SCORE_TOL, f"stored confidence off by {worst}")

        # 9. down, then what-if lists the environment again
        gone, verbs["down"] = _deploy_verb(env, "down", manifest)
        check(gone == [f"environment '{DEPLOY_ENV}' state removed"] and not run_file.exists()
              and not (data / ".tasksrunner" / "deployed.json").exists(), f"down: {gone}")
        after_down, verbs["what_if_after_down"] = _deploy_verb(env, "what-if", manifest)
        check(after_down == [f"+ {DEPLOY_ENV}"], f"what-if after down: {after_down}")
        return {"verb_seconds": verbs, "spawn_to_ready_s": spawn_ready_s,
                "crash_to_ready_s": crash_ready_s, "killed_pid": victim["pid"],
                "restarted_sidecar_port": int(fields1b["sidecar_port"]),
                "first_sidecar_port_1": int(fields1["sidecar_port"]),
                "events": events, "score_ms": _p50_max_ms([m / 1e3 for m in score_ms]),
                "score_calls": len(score_ms), "resiliency_retry_total": retries,
                "resiliency_retry_exhausted_total": exhausted,
                "on_card": on_card, "after_stop": after,
                "card_memory_per_replica_mib": (_mib(on_card["memory_used"])
                                                - _mib(after["memory_used"])) / 2,
                "stored_keys": len(keys), "dead_letters": 0,
                "max_abs_err_confidence": worst,
                "launches": {str(p): c["flash_fwd"] for p, c in counted.items()},
                "expected_launches": {str(p): e for p, e in expected.items()}}
    except BaseException:
        for t, line in sorted(orch.err.lines + [x for x in orch.out.lines if any(
                w in x[1] for w in (" ready ", "WARNING", "ERROR", "Traceback", "Error"))]
                )[-80:]:
            print(f"{t - phase_t:9.3f} {line}", file=sys.stderr)
        for name in list(procs.procs):
            print(f"{name}: {procs.tail(name)}", file=sys.stderr)
        raise
    finally:
        if saved_token is None:
            os.environ.pop(TOKEN_ENV, None)
        else:
            os.environ[TOKEN_ENV] = saved_token
        watch.stop()
        orch.kill()
        for entry in (json.loads(registry.read_text()).get(APP_ID, [])
                      if registry.exists() else []):
            with contextlib.suppress(ProcessLookupError):
                os.kill(entry["pid"], signal.SIGKILL)  # replicas a failed run left behind
        procs.kill_all()
        await publisher.stop()


def phase_deploy(smi: str) -> int:
    """The scorer deployed from a manifest (``python -m tasksrunner_torch
    deploy``) and run from the applied run file: returns B1's launches
    in its replicas."""
    started = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-deploy-") as data:
        result = asyncio.run(_deploy_phase(Path(data)))
    launched = sum(result["launches"].values())
    emit({"phase": "deploy", "nvidia_smi": smi, **result,
          "seconds": time.monotonic() - started, "flash_launches": launched})
    check(launched > 0, "the deployed replicas launched no flash kernel")
    return launched


# the bindings phase: the scorer fed from the sample's storage-queue binding
# (an outside producer's messages POSTed to /on-task-saved), 1 to 3 replicas
# by the queue's backlog; maxRetries and retryDelaySeconds set so that the
# 503s of a starting replica's warm-up (about 0.5 s apart, 8-12 s) cannot use
# up a message's deliveries: every message must still be stored, once
QUEUE = "externaltasksmanager"
QUEUE_FILE = "external-tasks-queue.db"
BLOBS, BLOB_CONTAINER, MAIL = "externaltasksblobstore", "externaltaskscontainer", "sendgrid"
BIND_MAX_RETRIES, BIND_RETRY_DELAY_S = 1000, 0.5
BIND_FIRST, BIND_BURST, BIND_QUERY_PAGE = 32, 192, 50
BOUND_200 = f"binding_delivery{{binding={QUEUE},status=200}}"


def _bindings_files(data: Path) -> Path:
    """The store (``_write_components``' ``scores``), the sample's queue,
    blob and SendGrid binding files with their paths moved into ``data``
    and scoped to the scorer, and the run file; returns the run file."""
    comps = data / "components"
    _write_components(comps, data)
    (comps / "pubsub-redis.yaml").unlink()  # the queue feeds the scorer here
    samples = {name: (SAMPLE_COMPONENTS / name).read_text() for name in (
        "bindings-in-storagequeue.yaml", "bindings-out-blobstorage.yaml",
        "bindings-out-sendgrid.yaml")}
    scope = "- tasksmanager-backend-processor"
    check(all(scope in text for text in samples.values())
          and "    value: /externaltasksprocessor/process\n" in samples[
              "bindings-in-storagequeue.yaml"], "the sample's binding files changed")
    (comps / "queue.yaml").write_text(
        samples["bindings-in-storagequeue.yaml"]
        .replace(".tasksrunner/queues", str(data / "queues"))
        .replace("/externaltasksprocessor/process", "/on-task-saved")
        .replace(scope, f"- {APP_ID}")
        .replace("scopes:", f"  - name: maxRetries\n    value: \"{BIND_MAX_RETRIES}\"\n"
                            f"  - name: retryDelaySeconds\n    value: \"{BIND_RETRY_DELAY_S}\"\n"
                            "scopes:"))
    (comps / "blobs.yaml").write_text(
        samples["bindings-out-blobstorage.yaml"]
        .replace(".tasksrunner/blobs", str(data / "blobs")).replace(scope, f"- {APP_ID}"))
    (comps / "sendgrid.yaml").write_text(
        samples["bindings-out-sendgrid.yaml"]
        .replace(".tasksrunner/outbox", str(data / "outbox")).replace(scope, f"- {APP_ID}"))
    run_file = data / "run.yaml"
    run_file.write_text(
        f"resources_path: {comps}\nregistry_file: {data / 'apps.json'}\napps:\n"
        f"  - app_id: {APP_ID}\n    module: tasksrunner_torch.service:make_app\n"
        "    health: { interval_seconds: 1 }\n"
        f"    scale:\n      min_replicas: 1\n      max_replicas: {ORCH_MAX}\n"
        f"      cooldown_seconds: {ORCH_COOLDOWN_S}\n      rules:\n"
        f"        - type: queue-backlog\n          metadata:\n            component: {QUEUE}\n"
        f"            messageCount: \"{ORCH_PER_REPLICA}\"\n")
    return run_file


def _queue_rows(path: Path) -> dict[str, tuple[int, int]]:
    """Each message's (attempts, done): done 1 acked, 2 dead-lettered."""
    with contextlib.closing(sqlite3.connect(path, timeout=5)) as conn:
        return {i: (a, d) for i, a, d in conn.execute("SELECT id, attempts, done FROM queue")}


async def _bindings_phase(data: Path) -> dict:
    """The phase's run, on the card."""
    from tasksrunner_torch.bindings import SqliteQueue

    run_file = _bindings_files(data)
    registry = data / "apps.json"
    baseline = len(_card_apps()[0])
    orch = _Orchestrated(run_file, data, None)
    phase_t = time.monotonic()
    watch = _StoreWatch(data / "scores.db")
    producer = SqliteQueue(data / "queues" / QUEUE_FILE)
    sent: dict[str, float] = {}  # task id → when it was enqueued
    tasks_by_id: dict[str, dict] = {}
    last_stats: dict[int, dict] = {}  # replica pid → its last /ml/stats
    try:
        def send(n: int, prefix: str) -> dict[str, float]:
            """n task messages into the queue file, as an outside producer."""
            out = {}
            for i in range(n):
                task = _saved_task(prefix, len(tasks_by_id))
                tasks_by_id[task["taskId"]] = task
                out[task["taskId"]] = time.monotonic()
                producer.send(task)
            sent.update(out)
            return out

        async def drained(batch: dict[str, float], seconds: float) -> dict:
            await _until(lambda: all(k in watch.first_seen for k in batch), seconds,
                         f"messages not stored: {sum(k in watch.first_seen for k in batch)} "
                         f"of {len(batch)}")
            first, last = min(batch.values()), max(watch.first_seen[k] for k in batch)
            return {"messages": len(batch), "drain_s": last - first,
                    "messages_per_s": len(batch) / (last - first),
                    "enqueue_to_stored_ms": _p50_max_ms(
                        [watch.first_seen[k] - t for k, t in batch.items()])}

        async def stats(app_port: int) -> dict:
            status, _, body = await _http(app_port, "GET", "/ml/stats")
            check(status == 200, f"/ml/stats answered {status}")
            return json.loads(body)

        async def delivered(sidecar_port: int) -> float:
            status, _, body = await _http(sidecar_port, "GET", "/v1.0/metadata")
            check(status == 200, f"/v1.0/metadata answered {status}")
            return json.loads(body)["metrics"].get(BOUND_200, 0)

        # 1. replica 0 alone, its ceiling held at 1 for the first 32
        await _until(lambda: orch.ready(0), 600, "replica 0 printed no ready line")
        ready0_t, fields0 = orch.ready(0)[0]
        while not (await stats(int(fields0["app_port"])))["ready"]:
            await asyncio.sleep(0.05)
        spawn_ready_s = {"0": ready0_t - orch.spawned(0)[0][0]}
        orch.admin_url = json.loads((data / "orchestrator.json").read_text())["admin_url"]
        await orch.admin("POST", f"/apps/{APP_ID}/scale", {"max_replicas": 1})
        one_replica = await drained(send(BIND_FIRST, "q-first"), 60)

        # 2. the ceiling back at 3 and a burst of 192: the scaler's decision
        # on the backlog, messages sent on while the new replicas start (so
        # the backlog holds) until each has stored a score
        await orch.admin("POST", f"/apps/{APP_ID}/scale", {"max_replicas": ORCH_MAX})
        check(not orch.err.find(SCALED_OUT), "a scale-out under the ceiling of 1")
        burst_t = time.monotonic()
        burst = send(BIND_BURST, "q-burst")
        await _until(lambda: orch.err.find(SCALED_OUT), 60, "no scale-out decision")
        decision_t, decision = orch.err.find(SCALED_OUT)[0]
        ports: dict[int, int] = {0: int(fields0["sidecar_port"])}
        first_score: dict[int, float] = {}
        deadline = time.monotonic() + 180
        while len(first_score) < ORCH_MAX - 1:
            check(time.monotonic() < deadline, "the new replicas did not all serve")
            for i in range(1, ORCH_MAX):
                if i not in ports and orch.ready(i):
                    ports[i] = int(orch.ready(i)[0][1]["sidecar_port"])
                if i in ports and i not in first_score and await delivered(ports[i]) > 0:
                    first_score[i] = time.monotonic()
            if producer.backlog() < ORCH_MAX * ORCH_PER_REPLICA:
                send(ORCH_PER_REPLICA, "q-sustain")
            await asyncio.sleep(0.05)
        # the floor at 3 until every replica's stats are read (no scale-in first)
        await orch.admin("POST", f"/apps/{APP_ID}/scale", {"min_replicas": ORCH_MAX})
        three = send(BIND_BURST, "q-three")
        replicas = await orch.replicas()
        check(len(replicas) == ORCH_MAX and all(r["running"] for r in replicas),
              f"the scaler did not reach {ORCH_MAX} replicas: {replicas}")
        on_card = _check_on_card([r["pid"] for r in replicas], "while serving", baseline)
        three_replicas = await drained(three, 120)
        for i in range(1, ORCH_MAX):
            spawn_ready_s[str(i)] = orch.ready(i)[0][0] - orch.spawned(i)[0][0]
        scale_out = {"backlog_to_decision_s": decision_t - burst_t,
                     "decision": decision.split(" INFO ")[-1],
                     "decision_to_ready_s": {str(i): orch.ready(i)[0][0] - decision_t
                                             for i in range(1, ORCH_MAX)},
                     "decision_to_first_score_s": {str(i): first_score[i] - decision_t
                                                   for i in range(1, ORCH_MAX)},
                     "burst": await drained(burst, 120)}
        await _until(lambda: all(k in watch.first_seen for k in sent), 120,
                     "not every message was stored")

        # 3. a message that is no task: acked, nothing stored
        stray = producer.send({"note": "not a task"})
        await _until(lambda: _queue_rows(data / "queues" / QUEUE_FILE)[stray][1] == 1, 30,
                     "the stray message was not acked")

        # 4. the output bindings through replica 0's sidecar
        sidecar = ports[0]

        async def bind(name: str, body: dict) -> dict:
            status, _, reply = await _http(sidecar, "POST", f"/v1.0/bindings/{name}",
                                           json.dumps(body).encode())
            check(status == 200, f"binding {name} answered {status}: {reply!r}")
            return json.loads(reply)

        task = _saved_task("q-binding", len(tasks_by_id))
        tasks_by_id[task["taskId"]] = task
        sent[task["taskId"]] = time.monotonic()
        created = await bind(QUEUE, {"operation": "create", "data": task})
        check(created["metadata"].get("messageId") in _queue_rows(data / "queues" / QUEUE_FILE),
              f"the queue's create answered {created}")
        blob_name = f"{task['taskId']}.json"
        text = json.dumps(task, indent=2)
        await bind(BLOBS, {"operation": "create", "data": text,
                           "metadata": {"blobName": blob_name}})
        got = await bind(BLOBS, {"operation": "get", "metadata": {"blobName": blob_name}})
        on_disk = (data / "blobs" / BLOB_CONTAINER / blob_name).read_bytes()
        check(got["data"] == text and on_disk == text.encode(),
              f"the blob read back differs: {got}")
        await bind(MAIL, {"operation": "create", "data": f"task {task['taskId']} scored",
                          "metadata": {"emailTo": "ops@example.com", "subject": "scored"}})
        mails = [json.loads(p.read_text()) for p in (data / "outbox").glob("*.json")]
        check(len(mails) == 1 and mails[0]["to"] == "ops@example.com"
              and mails[0]["from"] == "noreply@tasksrunner.local", f"the outbox holds {mails}")
        await _until(lambda: task["taskId"] in watch.first_seen, 30,
                     "the binding's message was not stored")

        # 5. the scores read back through the query route, page by page
        keys = sorted(k.split("||", 1)[1] for k in _store_keys(data / "scores.db"))
        check(keys == sorted(sent), f"the store holds {len(keys)} keys, not {len(sent)}")
        union: dict[str, dict] = {}
        page_s: list[float] = []
        for priority in service.PRIORITY_LABELS:
            token, last = None, math.inf
            while True:
                page = {"limit": BIND_QUERY_PAGE, **({"token": token} if token else {})}
                query = {"filter": {"EQ": {"priority": priority}},
                         "sort": [{"key": "confidence", "order": "DESC"}], "page": page}
                started = time.monotonic()
                status, _, reply = await _http(sidecar, "POST", "/v1.0/state/scores/query",
                                               json.dumps(query).encode())
                page_s.append(time.monotonic() - started)
                check(status == 200, f"the query answered {status}: {reply!r}")
                doc = json.loads(reply)
                for row in doc["results"]:
                    check(row["data"]["priority"] == priority and row["key"] not in union
                          and row["data"]["confidence"] <= last,
                          f"query row out of place: {row}")
                    last = row["data"]["confidence"]
                    union[row["key"]] = row["data"]
                token = doc["token"]
                if token is None:
                    break
        check(sorted(union) == keys, f"the query found {len(union)} keys, not {len(keys)}")
        for key, value in union.items():
            status, _, reply = await _http(sidecar, "GET", f"/v1.0/state/scores/{key}")
            check(status == 200 and json.loads(reply) == value, f"GET {key} differs: {reply!r}")

        # 6. every replica's stats and deliveries, then the floor back at 1
        # and the scale-in after the cooldown
        replicas = await orch.replicas()
        check(len(replicas) == ORCH_MAX and all(r["running"] and r["restarts"] == 0
                                                for r in replicas),
              f"a replica restarted or is down: {replicas}")
        acked = 0.0
        for r in replicas:
            last_stats[r["pid"]] = await stats(r["app_port"])
            acked += await delivered(r["sidecar_port"])
        rows = _queue_rows(data / "queues" / QUEUE_FILE)
        check(acked == len(rows) == len(sent) + 1 and all(d == 1 for _, d in rows.values()),
              f"{acked} deliveries acked, {len(rows)} messages, {len(sent) + 1} sent, "
              f"{sum(d == 2 for _, d in rows.values())} dead letters")
        released_t = time.monotonic()
        await orch.admin("POST", f"/apps/{APP_ID}/scale", {"min_replicas": 1})
        await _until(lambda: orch.err.find(SCALED_IN), 60, "no scale-in")
        scale_in_decision_s = orch.err.find(SCALED_IN)[0][0] - released_t
        deadline = time.monotonic() + 60
        while len(await orch.replicas()) > 1:
            check(time.monotonic() < deadline, "the app did not scale in to 1")
            await asyncio.sleep(0.05)
        scaled_in = {"decision_s": scale_in_decision_s,
                     "one_replica_s": time.monotonic() - released_t}

        # 7. SIGTERM: every replica leaves the card and the registry and
        # logs its launches
        rc = orch.stop()
        check(rc == 0, f"the orchestrator exited {rc}: "
                       f"{(data / 'orchestrator.log').read_text()[-3000:]}")
        after = _check_on_card([], "after the stop", baseline)
        left = json.loads(registry.read_text())
        check(left == {}, f"entries left in the registry: {left}")
        counted = {}
        for _, line in orch.out.find(" kernel launches app=priority-scorer pid="):
            pid, launches = line.split(" pid=", 1)[1].split(" ", 1)
            counted[int(pid)] = json.loads(launches)
        check(sorted(counted) == sorted(last_stats),
              f"kernel launch lines for {sorted(counted)}, replicas {sorted(last_stats)}")
        cards = torch.cuda.device_count()
        expected = {p: expected_serve_launches(s, cards) for p, s in last_stats.items()}
        check(all(counted[p]["flash_fwd"] == expected[p] for p in expected),
              f"B1 launches {counted} != expected {expected}")
        check(all(v == 0 for c in counted.values() for k, v in c.items() if k != "flash_fwd"),
              f"a replica launched a backward or ring kernel: {counted}")
        watch.stop()

        # the stored scores against the scorer's math in this process
        with contextlib.closing(sqlite3.connect(data / "scores.db")) as conn:
            stored = {k.split("||", 1)[1]: json.loads(v)
                      for k, v in conn.execute("SELECT key, value FROM state")}
        check(sorted(stored) == keys, "the store changed after the query")
        device = torch.device("cuda", 0)
        probs = service.batch_probs(
            [init_params(SERVED, 0, device)], [device],
            np.stack([service.task_tokens(tasks_by_id[k], SERVED) for k in keys]), cfg=SERVED)
        worst = 0.0
        for row, k in zip(probs, keys):
            label = service.PRIORITY_LABELS.index(stored[k]["priority"])
            check(row[label] >= row.max() - SCORE_TOL,
                  f"{k}: stored {stored[k]} but the scorer gives {row.tolist()}")
            worst = max(worst, abs(float(row[label]) - stored[k]["confidence"]))
        check(worst <= SCORE_TOL, f"stored confidence off by {worst}")
        attempts = [a for a, _ in rows.values()]
        return {"spawn_to_ready_s": spawn_ready_s, "one_replica": one_replica,
                "scale_out": scale_out, "three_replicas": three_replicas,
                "scale_in_after_floor_released": scaled_in,
                "scaler": [(t - phase_t, line.split(" INFO ")[-1]) for t, line
                           in orch.err.find(f"scaling {APP_ID} ")],
                "messages": len(rows), "stored_keys": len(keys), "dead_letters": 0,
                "backlog": producer.backlog(), "retries": sum(attempts) - len(attempts),
                "most_attempts": max(attempts),
                "query_pages": len(page_s), "query_ms_per_page": _p50_max_ms(page_s),
                "on_card": on_card, "after_stop": after,
                "card_memory_per_replica_mib":
                    (_mib(on_card["memory_used"]) - _mib(after["memory_used"])) / ORCH_MAX,
                "max_abs_err_confidence": worst,
                "launches": {str(p): c["flash_fwd"] for p, c in counted.items()},
                "expected_launches": {str(p): e for p, e in expected.items()}}
    except BaseException:
        for t, line in sorted(orch.err.lines + [x for x in orch.out.lines if any(
                w in x[1] for w in (" ready ", "WARNING", "ERROR", "Traceback", "Error"))]
                )[-80:]:
            print(f"{t - phase_t:9.3f} {line}", file=sys.stderr)
        raise
    finally:
        watch.stop()
        producer.close()
        orch.kill()
        for entry in (json.loads(registry.read_text()).get(APP_ID, [])
                      if registry.exists() else []):
            with contextlib.suppress(ProcessLookupError):
                os.kill(entry["pid"], signal.SIGKILL)  # replicas a failed run left behind


def phase_bindings(smi: str) -> int:
    """The scorer fed from a queue binding and scaled by the queue's
    backlog under ``python -m tasksrunner_torch run``: returns B1's
    launches in its replicas."""
    started = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-bindings-") as data:
        result = asyncio.run(_bindings_phase(Path(data)))
    launched = sum(result["launches"].values())
    emit({"phase": "bindings", "nvidia_smi": smi, **result,
          "seconds": time.monotonic() - started, "flash_launches": launched})
    check(launched > 0, "the queue-fed replicas launched no flash kernel")
    return launched


OBS_SCORER, OBS_CALLER = "scorer", "caller"
OBS_CALLS, OBS_FLOOD, OBS_MAX_INFLIGHT = 32, 64, 4
OBS_SLOW_S = 0.02  # a two-hop call takes tens of ms: each one is slow
OBS_TOKEN = "chip-smoke-observability"
OBS_APPS = '''"""The observability phase's apps: the scorer and a caller, each
process recording its spans into a file of its own beside this module."""
import os

from tasksrunner_torch import service
from tasksrunner_torch.app import App


def _own_span_file(role):
    os.environ["TASKSRUNNER_TRACE_DB"] = os.path.join(
        os.path.dirname(__file__), "traces", f"{role}-{os.environ['TASKSRUNNER_REPLICA']}.db")


def scorer(device=None):
    _own_span_file("scorer")
    return service.make_app(device=device)


def caller(device=None):  # serves nothing: the device is not used
    _own_span_file("caller")
    return App("caller")
'''


def _observability_files(data: Path) -> Path:
    """The apps' module and the run file: the scorer at exactly two
    replicas with admission on and a small in-flight line, and a caller;
    no components (the scorer's ``/scores`` then has no store)."""
    (data / "obs_apps.py").write_text(OBS_APPS)
    run_file = data / "run.yaml"
    run_file.write_text(
        f"registry_file: {data / 'apps.json'}\napps:\n"
        f"  - app_id: {OBS_SCORER}\n    module: obs_apps:scorer\n"
        "    health: { interval_seconds: 1 }\n"
        "    env:\n      TASKSRUNNER_ADMISSION: \"1\"\n"
        f"      TASKSRUNNER_ADMISSION_MAX_INFLIGHT: \"{OBS_MAX_INFLIGHT}\"\n"
        "    scale:\n      min_replicas: 2\n      max_replicas: 2\n"
        f"  - app_id: {OBS_CALLER}\n    module: obs_apps:caller\n")
    return run_file


def _exposition(text: str) -> dict:
    """The Prometheus text checked: one ``# TYPE`` a name, every
    histogram's buckets nondecreasing up to ``+Inf`` equal to its
    ``_count``. Returns each sample line's value by its name and labels."""
    types = re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M)
    check(len(types) == len({n for n, _ in types}), "a name with two # TYPE lines")
    samples: dict[str, float] = {}
    buckets: dict[str, list[tuple[str, float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        samples[key] = float(value)
        m = re.fullmatch(r'(\w+)_bucket\{(.*?),?le="([^"]+)"\}', key)
        if m:
            buckets.setdefault(f"{m.group(1)}{{{m.group(2)}}}", []).append((m.group(3), float(value)))
    for series, rows in buckets.items():
        counts = [c for _, c in rows]
        name, labels = series.split("{", 1)
        count = samples[f"{name}_count" + ("{" + labels if labels != "}" else "")]
        check(counts == sorted(counts) and rows[-1][0] == "+Inf" and counts[-1] == count,
              f"{series}: buckets {rows[-3:]} against _count {count}")
    check(bool(buckets), "no histogram in the exposition")
    return samples


def _verb_run(env: dict, *args: str, rc: int = 0) -> tuple[str, float]:
    """One ``python -m tasksrunner_torch`` verb: its stdout and seconds."""
    started = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "tasksrunner_torch", *args], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    check(out.returncode == rc, f"{' '.join(args)} exited {out.returncode}, not {rc}: "
                                f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    return out.stdout, time.monotonic() - started


async def _observability_phase(data: Path) -> dict:
    """The phase's run, on the card."""
    run_file = _observability_files(data)
    registry, dumps = data / "apps.json", data / "flightrec"
    env = {**os.environ, TOKEN_ENV: OBS_TOKEN, "TASKSRUNNER_FLIGHTREC_DIR": str(dumps),
           "TASKSRUNNER_SLOW_THRESHOLD_SECONDS": str(OBS_SLOW_S),
           "PYTHONPATH": os.pathsep.join(filter(None, (str(data), os.environ.get("PYTHONPATH"))))}
    auth = {TOKEN_HEADER: OBS_TOKEN}
    baseline = len(_card_apps()[0])
    orch = _Orchestrated(run_file, data, None, env=env, token=OBS_TOKEN)
    phase_t = time.monotonic()
    rng = np.random.default_rng(15)
    sent: set[str] = set()  # every trace id the phase sent

    def traceparent() -> dict:
        trace = "".join(f"{b:02x}" for b in rng.integers(0, 256, 16))
        sent.add(trace)
        return {"traceparent": f"00-{trace}-{rng.integers(1, 2**62):016x}-01", **auth}

    try:
        async def stats(app_port: int) -> dict:
            status, _, body = await _http(app_port, "GET", "/ml/stats")
            check(status == 200, f"/ml/stats answered {status}")
            return json.loads(body)

        # 1. the scorer's two replicas and the caller, ready
        fields = {}
        for app_id, index in ((OBS_SCORER, 0), (OBS_SCORER, 1), (OBS_CALLER, 0)):
            await _until(lambda: orch.ready(index, app_id), 600, f"{app_id}·{index} never ready")
            fields[(app_id, index)] = orch.ready(index, app_id)[0][1]
        scorer_ports = [(int(fields[(OBS_SCORER, i)]["app_port"]),
                         int(fields[(OBS_SCORER, i)]["sidecar_port"])) for i in range(2)]
        for app_port, _ in scorer_ports:
            while not (await stats(app_port))["ready"]:
                await asyncio.sleep(0.05)
        caller = int(fields[(OBS_CALLER, 0)]["sidecar_port"])
        ready_s = {f"{a}·{i}": orch.ready(i, a)[0][0] - orch.spawned(i, a)[0][0]
                   for a, i in fields}
        orch.admin_url = json.loads((data / "orchestrator.json").read_text())["admin_url"]
        status = await orch.admin("GET", "/apps")
        pids = {a["app_id"]: [r["pid"] for r in a["replicas"]] for a in status["apps"]}
        # the scorers hold a context each; the caller may hold none
        apps, used = _card_apps()
        listed = {pid for pid, _ in apps}
        check(set(pids[OBS_SCORER]) <= listed if listed & set(pids[OBS_SCORER])
              else baseline + 2 <= len(apps) <= baseline + 3,
              f"the scorer's replicas {pids[OBS_SCORER]} not on the card: {apps}")
        on_card_serving = {"compute_apps": [f"{p}, {m}" for p, m in apps], "memory_used": used}

        # 2. 32 two-hop /score calls through the caller's sidecar, two at a
        # time (under the replicas' in-flight line), each in a trace of its own
        calls: list[tuple[str, float, int]] = []
        sem = asyncio.Semaphore(2)

        async def score(i: int) -> None:
            headers = traceparent()
            task = json.dumps(_saved_task("obs", i)).encode()
            async with sem:
                started = time.monotonic()
                reply, _, _ = await _http(caller, "POST", f"/v1.0/invoke/{OBS_SCORER}/method/score",
                                          task, headers=headers)
                calls.append((headers["traceparent"][3:35], time.monotonic() - started, reply))

        await asyncio.gather(*(score(i) for i in range(OBS_CALLS)))
        check([c for _, _, c in calls] == [200] * OBS_CALLS, f"two-hop statuses {calls}")

        # 3. each trace through the admin API: the caller's client span and
        # the replica's hop, app server span and ml-request; the batch's own
        # trace holds its ml-batch. The two pieces share the trace id only:
        # the replica's sidecar records no span for the request it receives
        # (nor does the JAX one), so its hop's parent is in no file. A
        # sidecar serves spans once its recorder's timer has made the span
        # file (as in the JAX package)
        await _until(lambda: len(list((data / "traces").glob("*.db"))) == 3, 10,
                     "the span files were not made")
        admin_ms, batch_traces = [], set()
        for trace, _, _ in calls:
            started = time.monotonic()
            doc = await orch.admin("GET", f"/traces/{trace}")
            admin_ms.append(time.monotonic() - started)
            check(doc["replicas"] == 3, f"{trace}: {doc['replicas']} sidecars answered, not 3")
            rows = {(r["role"], r["kind"], r["name"]): r for r in doc["spans"]}
            want = {(OBS_CALLER, "client", f"invoke {OBS_SCORER}/score"),
                    (OBS_SCORER, "client", f"invoke {OBS_SCORER}/score"),
                    (OBS_SCORER, "server", "POST /score"),
                    (OBS_SCORER, "internal", "ml-request")}
            check(set(rows) == want and len(doc["spans"]) == 4, f"{trace}: {sorted(rows)}")
            hop, server, request = (rows[(OBS_SCORER, "client", f"invoke {OBS_SCORER}/score")],
                                    rows[(OBS_SCORER, "server", "POST /score")],
                                    rows[(OBS_SCORER, "internal", "ml-request")])
            check(server["parent_id"] == hop["span_id"] and request["parent_id"] == server["span_id"]
                  and all(r["trace_id"] == trace and r["status"] == 200 for r in doc["spans"]),
                  f"{trace}: the replica's spans are not one chain: {doc['spans']}")
            check(hop["parent_id"] not in {r["span_id"] for r in doc["spans"]},
                  f"{trace}: the replica's hop is linked to a recorded span: {doc['spans']}")
            batch_traces.add(json.loads(request["attrs"])["batch_trace"])
        for batch in sorted(batch_traces):
            doc = await orch.admin("GET", f"/traces/{batch}")
            check([(r["role"], r["name"]) for r in doc["spans"]] == [(OBS_SCORER, "ml-batch")],
                  f"batch trace {batch}: {doc['spans']}")
        dbs = sorted(str(p) for p in (data / "traces").glob("*.db"))
        slowest = max(calls, key=lambda c: c[1])[0]
        critical, _ = _verb_run(env, "traces", "critical", slowest, "--db", ",".join(dbs))
        whole = critical.splitlines()
        check(whole[0].startswith(f"critical path: 1 hops over 4 spans, root "
                                  f"'invoke {OBS_SCORER}/score'")
              and f"[{OBS_CALLER}] client" in whole[1],
              f"the chain over all span files is not the caller's span alone: {critical}")
        scorer_dbs = ",".join(d for d in dbs if "/scorer-" in d)
        replica_chain, _ = _verb_run(env, "traces", "critical", slowest, "--db", scorer_dbs)
        hops = [line.split("] ", 1)[1].split(None, 1) for line in replica_chain.splitlines()
                if "] " in line]
        check([h[1].strip().split("  (")[0] for h in hops] == [
            f"invoke {OBS_SCORER}/score", "POST /score", "ml-request"],
              f"the replica's chain: {replica_chain}")
        batch_of_slowest = [json.loads(r["attrs"])["batch_trace"] for r in (
            await orch.admin("GET", f"/traces/{slowest}"))["spans"] if r["name"] == "ml-request"]
        batch_chain, _ = _verb_run(env, "traces", "critical", batch_of_slowest[0], "--db",
                                   scorer_dbs)
        check("ml-batch" in batch_chain, f"the batch's chain: {batch_chain}")

        # 4. each replica's /metrics: 401 without the token, text 0.0.4 with
        # it; ml_batches_total against /ml/stats, and the merged percentiles
        batches, counted_batches = 0, 0.0
        for app_port, sidecar_port in scorer_ports:
            status, _, _ = await _http(sidecar_port, "GET", "/metrics")
            check(status == 401, f"/metrics without the token answered {status}")
            status, headers, body = await _http(sidecar_port, "GET", "/metrics", headers=auth)
            check(status == 200 and headers.get("content-type", "").startswith(
                "text/plain; version=0.0.4"), f"/metrics answered {status} {headers}")
            samples = _exposition(body.decode())
            counted_batches += sum(v for k, v in samples.items()
                                   if k.startswith("ml_batches_total{"))
            batches += sum((await stats(app_port))["batches"].values())
            check(any(k.startswith("ml_queue_wait_seconds_bucket{") for k in samples)
                  and "ml_queue_depth" in samples, "a replica's /metrics lacks the ml_ series")
        check(counted_batches == batches, f"ml_batches_total {counted_batches} != {batches}")
        percentiles, _ = _verb_run(env, "metrics", OBS_SCORER, "--percentiles",
                                   "--registry-file", str(registry))
        check(percentiles.startswith("# merged across 2 replica(s)"), percentiles[:200])

        # 5. a flood of 64 closed-loop callers on replica 0's sidecar: shed
        # with 429 + Retry-After, and the shed dumps the flight recorder
        shed_retry_after, served = [], 0

        async def flooder() -> None:
            nonlocal served
            deadline = time.monotonic() + 30
            while True:
                check(time.monotonic() < deadline, "a flooder was never shed")
                reply, headers, _ = await _http(
                    scorer_ports[0][1], "POST", f"/v1.0/invoke/{OBS_SCORER}/method/score",
                    json.dumps(_saved_task("flood", served)).encode(), headers=traceparent())
                if reply == 429:
                    shed_retry_after.append(headers.get("retry-after"))
                    return
                check(reply == 200, f"flood call answered {reply}")
                served += 1

        flood_t = time.monotonic()
        await asyncio.gather(*(flooder() for _ in range(OBS_FLOOD)))
        check(len(shed_retry_after) == OBS_FLOOD and all(
            r is not None and int(r) >= 1 for r in shed_retry_after),
              f"429s without Retry-After: {shed_retry_after}")
        pid0 = pids[OBS_SCORER][0]
        await _until(lambda: list(dumps.glob(f"{OBS_SCORER}-{pid0}-*-admission-shed.json")), 10,
                     "no admission-shed dump")
        shed_file = sorted(dumps.glob(f"{OBS_SCORER}-{pid0}-*-admission-shed.json"))[0]
        shed = json.loads(shed_file.read_text())
        entries = shed["entries"]
        routed = [e for e in entries if e["name"] == "invoke"]
        check(bool(routed) and all(e["trace"] in sent for e in routed),
              f"the shed dump's invoke entries are not the phase's calls: {routed[:3]}")
        # the dump is taken as the score crosses 1.0, before the gauge shows it
        check({"ml_queue_depth", "admission_saturation"} <= set(shed["gauges"])
              and shed["detail"]["score"] >= 1.0, f"shed dump {shed['detail']} {shed['gauges']}")
        slow = sorted(dumps.glob("*-slow-exemplar.json"))
        check(bool(slow), "no slow-exemplar dump")
        listing, _ = _verb_run(env, "flightrec", "--dir", str(dumps))
        check("admission-shed" in listing and "slow-exemplar" in listing, listing[-1000:])
        rendered, _ = _verb_run(env, "flightrec", "--dump", str(shed_file))
        check(rendered.startswith(f"{OBS_SCORER} pid {pid0} — admission-shed"), rendered[:300])

        # 6. a request that fails in the app (no store for /scores): its
        # traceback is logged with the role and its trace
        headers = traceparent()
        deadline = time.monotonic() + 30
        while True:  # until replica 0's gate has reopened
            reply, _, _ = await _http(caller, "GET", f"/v1.0/invoke/{OBS_SCORER}/method/scores/x",
                                      headers=headers)
            if reply == 500:
                break
            check(reply == 429 and time.monotonic() < deadline, f"/scores/x answered {reply}")
            await asyncio.sleep(0.25)
        failed = headers["traceparent"][3:19]
        logs, _ = _verb_run(env, "logs", OBS_SCORER, "--tail", "2000",
                            "--registry-file", str(registry))
        tagged = [line for line in logs.splitlines()
                  if f"role={OBS_SCORER} trace={failed} " in line]
        check(any("GET /scores/x failed" in line for line in tagged),
              f"no log line of the failed request tagged trace={failed}: {logs[-1500:]}")
        check(all(re.search(r"role=\S+ trace=(-|[0-9a-f]{16}) ", line)
                  for line in logs.splitlines() if " role=" in line), "an untagged log line")

        # 7. the replicas' last stats (once replica 0 admits again), then
        # SIGTERM: every clean stop logs its launches, none leaves an
        # unclean-shutdown dump
        deadline = time.monotonic() + 30
        while (await _http(scorer_ports[0][0], "GET", "/ml/stats"))[0] == 429:
            check(time.monotonic() < deadline, "replica 0 kept shedding")
            await asyncio.sleep(0.25)
        last_stats = {pid: await stats(port) for pid, (port, _) in zip(pids[OBS_SCORER],
                                                                       scorer_ports)}
        rc = orch.stop()
        check(rc == 0, f"the orchestrator exited {rc}: "
                       f"{(data / 'orchestrator.log').read_text()[-3000:]}")
        after = _check_on_card([], "after the stop", baseline)
        check(json.loads(registry.read_text()) == {}, "entries left in the registry")
        check(not list(dumps.glob("*-unclean-shutdown.json")), "an unclean-shutdown dump")
        counted = {}
        for _, line in orch.out.find(f" kernel launches app={OBS_SCORER} pid="):
            pid, launches = line.split(" pid=", 1)[1].split(" ", 1)
            counted[int(pid)] = json.loads(launches)
        check(sorted(counted) == sorted(last_stats),
              f"launch lines for {sorted(counted)}, replicas {sorted(last_stats)}")
        expected = {p: expected_serve_launches(s, torch.cuda.device_count())
                    for p, s in last_stats.items()}
        check(all(counted[p]["flash_fwd"] == expected[p] for p in expected),
              f"B1 launches {counted} != expected {expected}")
        check(all(v == 0 for c in counted.values() for k, v in c.items() if k != "flash_fwd"),
              f"a replica launched a backward or ring kernel: {counted}")
        return {"spawn_to_ready_s": ready_s, "two_hop_ms": _p50_max_ms([c[1] for c in calls]),
                "admin_traces_ms": _p50_max_ms(admin_ms), "batch_traces": len(batch_traces),
                "critical_all_dbs": critical.splitlines(),
                "critical_replica": replica_chain.splitlines(),
                "ml_batches_total": counted_batches,
                "flood": {"served": served, "shed": len(shed_retry_after),
                          "seconds": time.monotonic() - flood_t,
                          "retry_after": sorted(set(shed_retry_after))},
                "dumps": sorted(p.name.split("-", 3)[-1] for p in dumps.glob("*.json")),
                "shed_dump": {"entries": len(entries), "gauges": shed["gauges"],
                              "detail": shed["detail"]},
                "on_card": on_card_serving, "after_stop": after,
                "card_memory_per_scorer_mib": (
                    (_mib(on_card_serving["memory_used"]) - _mib(after["memory_used"]))
                    / len(pids[OBS_SCORER])),
                "launches": {str(p): c["flash_fwd"] for p, c in counted.items()},
                "expected_launches": {str(p): e for p, e in expected.items()}}
    except BaseException:
        for t, line in sorted(orch.err.lines + [x for x in orch.out.lines if any(
                w in x[1] for w in (" ready ", "WARNING", "ERROR", "Traceback", "Error"))]
                )[-80:]:
            print(f"{t - phase_t:9.3f} {line}", file=sys.stderr)
        raise
    finally:
        orch.kill()
        for entries in (json.loads(registry.read_text()).values() if registry.exists() else []):
            for entry in entries:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(entry["pid"], signal.SIGKILL)  # replicas a failed run left behind


def phase_observability(smi: str) -> int:
    """The scorer operated through its telemetry under ``python -m
    tasksrunner_torch run``: returns B1's launches in its replicas."""
    started = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-observability-") as data:
        result = asyncio.run(_observability_phase(Path(data)))
    launched = sum(result["launches"].values())
    emit({"phase": "observability", "nvidia_smi": smi, **result,
          "seconds": time.monotonic() - started, "flash_launches": launched})
    check(launched > 0, "the observed replicas launched no flash kernel")
    return launched


PLACE_SHARDS, PLACE_REPLICAS, PLACE_SEED = 4, 3, "chip-smoke-placement"
PLACE_EVENTS, PLACE_CALLS, PLACE_READS = 256, 16, 8
SPLIT_KEYS, SPLIT_BATCH = 1024, 32
#: the in-process store's shards whose leadership is handed over, and
#: whose leader is crashed
HANDOFF_SHARD, FAILOVER_SHARD = 0, 1
#: the in-process store's lease, short so that a failover takes about a second
REPL_LEASE_S = "1"


def _placement_files(data: Path) -> Path:
    """The sample's store file as ``scores`` on 4 shards of 3 members with a
    fixed ``hashSeed``, the broker file, and a run file of one scorer
    replica."""
    comps, registry = data / "components", data / "apps.json"
    _write_components(comps, data)
    store = comps / "statestore.yaml"
    store.write_text(store.read_text().replace(
        "scopes:", f'  - name: shards\n    value: "{PLACE_SHARDS}"\n'
                   f'  - name: replicas\n    value: "{PLACE_REPLICAS}"\n'
                   f"  - name: hashSeed\n    value: {PLACE_SEED}\nscopes:"))
    run_file = data / "run.yaml"
    run_file.write_text(
        f"resources_path: {comps}\nregistry_file: {registry}\napps:\n"
        f"  - app_id: {APP_ID}\n    module: tasksrunner_torch.service:make_app\n"
        "    health: { interval_seconds: 1 }\n")
    return run_file


def _scores(probs: np.ndarray) -> list[dict]:
    return [{"priority": service.PRIORITY_LABELS[int(row.argmax())],
             "confidence": float(row.max())} for row in probs]


def _member_rows(path: Path) -> tuple[int, list[tuple]]:
    """A member file's high-water mark and its (key, value) rows."""
    with contextlib.closing(sqlite3.connect(path, timeout=5)) as conn:
        hwm = conn.execute("SELECT hwm FROM repl_meta WHERE id = 1").fetchone()[0]
        return hwm, conn.execute("SELECT key, value FROM state ORDER BY key").fetchall()


async def _members_settled(sets, what: str) -> None:
    """Every replica set's members at one position."""
    deadline = time.monotonic() + 60
    while not all(len({n.store.repl_position() for n in rs.nodes}) == 1 for rs in sets):
        check(time.monotonic() < deadline, f"{what}: members not at one position "
              f"{[[n.store.repl_position() for n in rs.nodes] for rs in sets]}")
        await asyncio.sleep(0.02)


def _repl_records(snapshot: dict) -> float:
    return sum(v for k, v in snapshot.items() if k.startswith("repl_records_total{"))


class _ScoringWriter:
    """Scores batches of saved tasks with the model on the card and stores
    each batch's scores at once. ``acked`` holds the writes that resolved,
    ``failed`` those that raised (a drill allows them only where it
    crashes a leader); ``storing`` is set while a batch's writes are in
    flight. Each batch is one forward: ``n_layers`` B1 launches."""

    def __init__(self, store) -> None:
        self.store = store
        self.device = torch.device("cuda", 0)
        self.params = init_params(SERVED, 0, self.device)
        self.acked: dict[str, dict] = {}
        self.failed: dict[str, BaseException] = {}
        self.issued = self.batches = 0
        self.storing = asyncio.Event()
        self._stop = asyncio.Event()
        self._task: asyncio.Task | None = None

    async def batch(self, prefix: str) -> None:
        tasks = [_saved_task(prefix, self.issued + i) for i in range(SPLIT_BATCH)]
        self.issued += SPLIT_BATCH
        tokens = np.stack([service.task_tokens(t, SERVED) for t in tasks])
        probs = await asyncio.to_thread(service.batch_probs, [self.params], [self.device],
                                        tokens, cfg=SERVED)
        self.batches += 1
        values = dict(zip((t["taskId"] for t in tasks), _scores(probs)))
        writes = asyncio.gather(*(self.store.set(k, v) for k, v in values.items()),
                                return_exceptions=True)
        self.storing.set()
        try:
            done = await writes
        finally:
            self.storing.clear()
        for (key, value), result in zip(values.items(), done):
            if isinstance(result, BaseException):
                self.failed[key] = result
            else:
                self.acked[key] = value

    async def fill(self, keys: int) -> None:
        while len(self.acked) < keys:
            await self.batch("split")

    def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while not self._stop.is_set():
            await self.batch("split-live")

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task

    async def cancel(self) -> None:
        """After a failed check: the writer goes before the store closes."""
        self._stop.set()
        if self._task is not None and not self._task.done():
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)


async def _split_under(store, writer: _ScoringWriter, before: dict, epoch: int) -> dict:
    """``store`` split to one more shard while ``writer`` runs, then the
    writer stopped: every acknowledged write reads back, about a fifth of
    the keys moved, each key on the one shard its router names, the
    flip's pause within its budget."""
    shards = store.shard_count
    split_t = time.monotonic()
    result = await store.split_shard()
    split_s = time.monotonic() - split_t
    await asyncio.sleep(0.2)
    await writer.stop()
    items = await store.bulk_get(list(writer.acked))
    lost = [k for k, item in zip(writer.acked, items)
            if item is None or item.value != writer.acked[k]]
    check(not lost, f"{len(lost)} acknowledged writes lost: {lost[:5]}")
    check(result["epoch"] == store.placement.epoch == epoch and result["shards"] == shards + 1,
          f"the split's result {result}")
    moved_share = sum(store.router.shard_of(k) != s for k, s in before.items()) / len(before)
    check(len(before) >= 1000 and 0.12 <= moved_share <= 0.28,
          f"moved share {moved_share} of {len(before)} keys")
    held = [await child.keys() for child in store._shards]
    every = await store.keys()
    check(sorted(k for ks in held for k in ks) == every and len(every) == len(set(every))
          and all(store.router.shard_of(k) == i for i, ks in enumerate(held) for k in ks),
          "a key on no shard, on two, or on one its router does not name")
    budget = placement.pause_budget_default()
    check(result["pause_seconds"] <= budget,
          f"the split's flip paused writes {result['pause_seconds']} s, budget {budget} s")
    return {"keys_before": len(before), "keys_after": len(every), "moved_share": moved_share,
            "keys_moved": result["keys_moved"], "split_s": split_s, "epoch": result["epoch"],
            "pause_s": result["pause_seconds"], "pause_budget_s": budget,
            "per_shard": [len(ks) for ks in held]}


async def _plain_split(data: Path) -> dict:
    """A 4-shard ``scores`` store of plain members (``replicas: 1``) in this
    process split to 5 while the writer stores scores: the unreplicated
    path of the split and its chunked copy. Returns the numbers and the
    writer's batches."""
    store = build_sharded_store("scores", data / "split-plain" / "scores.db",
                                shards=PLACE_SHARDS, hash_seed=PLACE_SEED)
    check(all(type(child).__name__ == "SqliteStateStore" for child in store._shards),
          f"the plain store's children {store._shards}")
    writer = _ScoringWriter(store)
    try:
        await writer.fill(SPLIT_KEYS)
        before = {k: store.router.shard_of(k) for k in await store.keys()}
        writer.start()
        await asyncio.sleep(0.2)
        split = await _split_under(store, writer, before, 2)
        check(not writer.failed, f"{len(writer.failed)} writes failed on the plain store: "
                                 f"{list(writer.failed.items())[:3]}")
        return {"members": 1, **split, "written_during": len(writer.acked) - SPLIT_KEYS,
                "batches": writer.batches}
    finally:
        await writer.cancel()
        await asyncio.to_thread(store.close)


async def _in_process_replica_sets(data: Path) -> dict:
    """A ``scores`` store of this process built from component metadata on 4 shards of
    3 members, while the writer stores scores: shard 0's leadership handed
    to a follower, shard 1's leader crashed while a batch's writes are in
    flight, then the split to 5. Returns the numbers and the writer's
    batches."""
    lease_env, saved_lease = "TASKSRUNNER_REPL_LEASE_SECONDS", os.environ.get(
        "TASKSRUNNER_REPL_LEASE_SECONDS")
    os.environ[lease_env] = REPL_LEASE_S  # read as each member is made, the split's too
    meta = {"databasePath": str(data / "split" / "scores.db"), "shards": str(PLACE_SHARDS),
            "replicas": str(PLACE_REPLICAS), "hashSeed": PLACE_SEED}
    store = ComponentRegistry([parse_component({"componentType": "state.sqlite", "metadata": [
        {"name": k, "value": v} for k, v in meta.items()]}, default_name="scores")]).get("scores")
    check(type(store).__name__ == "ShardedStateStore"
          and all(len(rs.nodes) == PLACE_REPLICAS for rs in store._shards),
          f"the component built {store!r}")
    records_before = _repl_records(metrics.snapshot())
    writer = _ScoringWriter(store)
    try:
        await writer.fill(SPLIT_KEYS)
        before = {k: store.router.shard_of(k) for k in await store.keys()}
        writer.start()
        await asyncio.sleep(0.2)

        # (a) shard 0's leadership handed to a follower under the writer
        moved = store._shards[HANDOFF_SHARD]
        old_leader = moved.leader_member()
        target = next(n.node_id for n in moved.nodes if n.node_id != old_leader)
        handoff = await store.migrate_shard(HANDOFF_SHARD, member=target)
        check(moved.leader_member() == target and handoff["epoch"] == store.placement.epoch == 2
              and store.placement.assignment == {HANDOFF_SHARD: target},
              f"the handoff's result {handoff}, leader {moved.leader_member()}")
        lease_epoch = next(n for n in moved.nodes if n.node_id == target).store.repl_position()[1]
        check(lease_epoch == 2, f"shard {HANDOFF_SHARD}'s epoch after the handoff: {lease_epoch}")
        await asyncio.sleep(0.2)

        # (b) shard 1's leader crashed while the writer's batch is in
        # flight; a probe write on that shard waits for the new leader's ack
        failing = store._shards[FAILOVER_SHARD]
        await writer.storing.wait()
        victim = next(n for n in failing.nodes if n.node_id == failing.leader_member())
        victim.crash()
        crashed_t = time.monotonic()
        probe = next(k for k in (f"failover-probe-{i}" for i in range(1000))
                     if store.router.shard_of(k) == FAILOVER_SHARD)
        await store.set(probe, {"after": "crash"})
        failover_s = time.monotonic() - crashed_t
        writer.acked[probe] = {"after": "crash"}
        new_leader = next(n for n in failing.nodes if n.node_id == failing.leader_member())
        survivor = next(n for n in failing.nodes if n not in (victim, new_leader))
        await asyncio.sleep(0.2)
        # every write acked so far on that shard, and the new leader's
        # position, read with nothing in between: each of those writes is
        # in its log at or below that position
        on_failed = {k: v for k, v in writer.acked.items()
                     if store.router.shard_of(k) == FAILOVER_SHARD}
        leader_hwm, failover_epoch = new_leader.store.repl_position()
        deadline = time.monotonic() + 30
        while survivor.store.repl_position()[0] < leader_hwm:
            check(time.monotonic() < deadline, "the surviving follower did not catch up")
            await asyncio.sleep(0.02)
        for node in (new_leader, survivor):
            items = await node.store.bulk_get(list(on_failed))
            lost = [k for k, item in zip(on_failed, items)
                    if item is None or item.value != on_failed[k]]
            check(not lost, f"{len(lost)} acknowledged writes missing on {node.node_id} after "
                            f"the failover: {lost[:5]}")
        check(failover_epoch == 2, f"shard {FAILOVER_SHARD}'s epoch after the failover: "
                                   f"{failover_epoch}")
        # a write the crash left unacknowledged failed with a state error
        # on the crashed shard, and on no other
        unacked = dict(writer.failed)
        check(all(isinstance(exc, StateError) for exc in unacked.values())
              and all(store.router.shard_of(k) == FAILOVER_SHARD for k in unacked),
              f"writes failed outside the crash: {list(unacked.items())[:3]}")
        victim.revive()  # the new leader resyncs it

        # (c) the split to 5, a replica set of 3 members made for shard 4
        split = await _split_under(store, writer, before, 3)
        check(len(store._shards[4].nodes) == PLACE_REPLICAS and writer.failed == unacked,
              f"the split's set {store._shards[4]!r}, failed writes {len(writer.failed)}")
        await _members_settled(store._shards, "after the split")
        for i, rs in enumerate(store._shards):
            per_member = [sorted(await n.store.keys()) for n in rs.nodes]
            check(all(keys == per_member[0] for keys in per_member),
                  f"shard {i}'s members hold different keys")
        budget = placement.pause_budget_default()
        check(handoff["pause_seconds"] <= budget,
              f"the handoff's flip paused writes {handoff['pause_seconds']} s, budget {budget} s")
        return {"members": PLACE_REPLICAS, **split,
                "written_during": len(writer.acked) - SPLIT_KEYS,
                "handoff": {"shard": HANDOFF_SHARD, "from": old_leader, "to": target,
                            "epoch": lease_epoch, "placement_epoch": handoff["epoch"],
                            "pause_s": handoff["pause_seconds"]},
                "failover": {"shard": FAILOVER_SHARD, "crashed": victim.node_id,
                             "new_leader": new_leader.node_id, "epoch": failover_epoch,
                             "seconds_to_ack": failover_s, "lease_s": float(REPL_LEASE_S),
                             "acked_keys_checked": len(on_failed),
                             "unacked_in_crash": len(unacked)},
                "records_replicated": _repl_records(metrics.snapshot()) - records_before,
                "batches": writer.batches}
    finally:
        await writer.cancel()
        await store.aclose()
        if saved_lease is None:
            os.environ.pop(lease_env, None)
        else:
            os.environ[lease_env] = saved_lease


async def _placement_phase(data: Path) -> dict:
    """The phase's run, on the card."""
    run_file = _placement_files(data)
    comps, registry = data / "components", data / "apps.json"
    env = {**os.environ, "TASKSRUNNER_RESHARD": "1"}
    baseline = len(_card_apps()[0])
    orch = _Orchestrated(run_file, data, None, env=env)
    publisher = Runtime("some-api", ComponentRegistry(load_components(comps, app_id="some-api"),
                                                      app_id="some-api"))
    phase_t = time.monotonic()
    router = ShardRouter(PLACE_SHARDS, PLACE_SEED)
    # member 0's files: the leaders' while no failover or handoff moves them
    shard_files = [data / f"scores-shard{i}.db" for i in range(PLACE_SHARDS)]
    member_files = [[Path(replication._member_path(str(data / "scores.db"), i, m, PLACE_SHARDS))
                     for m in range(PLACE_REPLICAS)] for i in range(PLACE_SHARDS)]
    epoch_header = placement.PLACEMENT_EPOCH_HEADER

    def held() -> list[list[str]]:
        keys = []
        for path in shard_files:
            try:
                keys.append(_store_keys(path) if path.exists() else [])
            except sqlite3.Error:  # made, its table not yet
                keys.append([])
        return keys

    try:
        async def stats(app_port: int) -> dict:
            status, _, body = await _http(app_port, "GET", "/ml/stats")
            check(status == 200, f"/ml/stats answered {status}")
            return json.loads(body)

        # 1. one scorer replica, ready
        await _until(lambda: orch.ready(0), 600, "the scorer never printed its ready line")
        ready_t, fields = orch.ready(0)[0]
        app_port, sidecar = int(fields["app_port"]), int(fields["sidecar_port"])
        while not (await stats(app_port))["ready"]:
            await asyncio.sleep(0.05)
        orch.admin_url = json.loads((data / "orchestrator.json").read_text())["admin_url"]

        # 2. a burst of saved-task events and /score calls through the sidecar
        tasks = [_saved_task("pl", i) for i in range(PLACE_EVENTS)]
        burst_t = time.monotonic()
        calls = await asyncio.gather(
            *(publisher.publish(PUBSUB, TOPIC, t) for t in tasks),
            *(_http(sidecar, "POST", f"/v1.0/invoke/{APP_ID}/method/score",
                    json.dumps(t).encode()) for t in tasks[:PLACE_CALLS]))
        check([c[0] for c in calls[PLACE_EVENTS:]] == [200] * PLACE_CALLS,
              f"/score statuses {[c[0] for c in calls[PLACE_EVENTS:]]}")
        deadline = time.monotonic() + 120
        while (landed := sum(map(len, held()))) < PLACE_EVENTS:
            check(time.monotonic() < deadline, f"{landed} of {PLACE_EVENTS} events stored")
            await asyncio.sleep(0.02)
        stored_s = time.monotonic() - burst_t
        burst_wall = time.time()

        # 3. each key in the one shard file its router names, no shard empty
        per_shard = held()
        check(sorted(k for ks in per_shard for k in ks)
              == sorted(f"{APP_ID}||{t['taskId']}" for t in tasks),
              "the shard files do not hold each event's key once")
        check(all(per_shard) and all(router.shard_of(k) == i for i, ks in enumerate(per_shard)
                                     for k in ks), f"keys per shard {list(map(len, per_shard))}")
        # ... and on each of its shard's 3 members, the members at one hwm
        deadline = time.monotonic() + 60
        while True:
            members = [[_member_rows(path) for path in paths] for paths in member_files]
            hwms = [[hwm for hwm, _ in shard] for shard in members]
            if all(len(set(h)) == 1 for h in hwms):
                break
            check(time.monotonic() < deadline, f"the members' hwms never met: {hwms}")
            await asyncio.sleep(0.05)
        check(all([k for k, _ in rows] == per_shard[i] for i, shard in enumerate(members)
                  for _, rows in shard)
              and all(rows == shard[0][1] for shard in members for _, rows in shard),
              "a shard's members hold different rows")
        with contextlib.closing(sqlite3.connect(data / "scores-repl-meta.db")) as conn:
            leases = dict((k, json.loads(v)) for k, v in conn.execute(
                "SELECT key, value FROM state WHERE key LIKE 'repl-lease||%'"))
        check(sorted(leases) == [f"repl-lease||scores||{i}" for i in range(PLACE_SHARDS)],
              f"the meta file's leases {sorted(leases)}")

        # 4. reads at the live epoch pass; at a stale one, 409 with the live one
        for epoch, want in (("1", 200), ("0", 409)):
            for t in tasks[:PLACE_READS]:
                status, headers, _ = await _http(sidecar, "GET",
                                                 f"/v1.0/state/scores/{t['taskId']}",
                                                 headers={epoch_header: epoch})
                check(status == want and (want == 200 or headers.get(epoch_header) == "1"),
                      f"epoch {epoch}: {status} {headers}")
        status, _, body = await _http(sidecar, "GET", "/v1.0/metadata")
        stale = json.loads(body)["metrics"].get("placement_stale_routes_total{store=scores}")
        check(stale == PLACE_READS, f"placement_stale_routes_total {stale}")

        # 5. a transaction over two shards commits both; with one stale etag,
        # 409 and neither key changes
        ids = [f"txn-{i}" for i in range(64)]
        by_shard = {}
        for i in ids:
            by_shard.setdefault(router.shard_of(f"{APP_ID}||{i}"), i)
        ka, kb = by_shard[min(by_shard)], by_shard[max(by_shard)]

        async def transact(value: int, etag: str | None = None) -> int:
            ops = [{"operation": "upsert", "request": {"key": k, "value": {"n": value},
                                                       **({"etag": etag} if k == kb and etag
                                                          else {})}} for k in (ka, kb)]
            return (await _http(sidecar, "POST", "/v1.0/state/scores/transaction",
                                json.dumps({"operations": ops}).encode()))[0]

        async def read(key: str) -> tuple:
            status, headers, body = await _http(sidecar, "GET", f"/v1.0/state/scores/{key}")
            return status, json.loads(body), headers.get("etag")

        txn_t = time.monotonic()
        check(await transact(1) == 204, "the cross-shard transaction was refused")
        txn_ms = (time.monotonic() - txn_t) * 1000
        committed = [await read(k) for k in (ka, kb)]
        check([c[:2] for c in committed] == [(200, {"n": 1})] * 2, f"committed {committed}")
        check(await transact(2, etag="1") == 409, "a stale etag did not refuse the transaction")
        check([await read(k) for k in (ka, kb)] == committed, "a refused transaction wrote")

        # 6. one paged query over the four shards: every key once
        page_s, seen, token = [], [], None
        while True:
            page = {"limit": 50, **({"token": token} if token else {})}
            started = time.monotonic()
            status, _, body = await _http(sidecar, "POST", "/v1.0/state/scores/query",
                                          json.dumps({"page": page}).encode())
            page_s.append(time.monotonic() - started)
            check(status == 200, f"the query answered {status}")
            doc = json.loads(body)
            seen += [r["key"] for r in doc["results"]]
            token = doc.get("token")
            if not token:
                break
        check(sorted(seen) == sorted([t["taskId"] for t in tasks] + [ka, kb]),
              f"the query's {len(seen)} keys are not every key once")

        # 7. the placement loop's view, once it has swept after the burst
        deadline = time.monotonic() + 30
        while True:
            doc = await orch.admin("GET", "/placement")
            app_doc = doc["apps"].get(APP_ID) or {}
            if (app_doc.get("last_sweep") or 0) > burst_wall:
                break
            check(time.monotonic() < deadline, f"no placement sweep after the burst: {doc}")
            await asyncio.sleep(0.25)
        entry = app_doc["stores"]["scores"]
        leaders = entry["leaders"]
        check(doc["reshard"] is True and entry["epoch"] == 1 and entry["shards"] == PLACE_SHARDS
              and sorted(r["shard"] for r in entry["ranking"]) == list(range(PLACE_SHARDS))
              and all(r["rate"] > 0 for r in entry["ranking"]) and "plan" in entry
              and sorted(leaders) == [str(i) for i in range(PLACE_SHARDS)]
              and all(leases[f"repl-lease||scores||{i}"]["owner"] == leaders[str(i)]
                      for i in range(PLACE_SHARDS)), f"/admin/placement {entry}")
        shards_out, verb_s = _verb_run(env, "shards", "--registry-file", str(registry))
        lines = shards_out.splitlines()
        shard_lines = [x for x in lines if x.startswith("  shard ")]
        check(lines[0] == f"{APP_ID}/scores: epoch 1, {PLACE_SHARDS} shards, 1 replica(s) "
                          "reporting" and len(shard_lines) == PLACE_SHARDS
              and all(x.split(":")[0] == f"  shard {i}" and x.endswith(f" @ {leaders[str(i)]}")
                      for i, x in enumerate(sorted(shard_lines))), f"shards printed {shards_out}")
        status, _, body = await _http(sidecar, "GET", "/v1.0/metadata")
        replica_metrics = json.loads(body)["metrics"]
        replica_records = _repl_records(replica_metrics)
        commits = replica_metrics.get("state_commit_seconds_count{store=scores}", 0)
        waits = replica_metrics.get("state_queue_wait_seconds_count{store=scores}", 0)
        replica_store = {
            "commits": commits, "queued_writes": waits,
            "commit_ms_mean": 1e3 * replica_metrics.get(
                "state_commit_seconds_sum{store=scores}", 0) / max(commits, 1),
            "commit_ms_max": 1e3 * replica_metrics.get("state_commit_seconds_max{store=scores}", 0),
            "queue_wait_ms_mean": 1e3 * replica_metrics.get(
                "state_queue_wait_seconds_sum{store=scores}", 0) / max(waits, 1)}
        check(replica_records >= (PLACE_REPLICAS - 1) * PLACE_EVENTS,
              f"the replica shipped {replica_records} records")

        # 8. SIGTERM: the replica's clean stop logs its launches
        last_stats = await stats(app_port)
        pid = (await orch.replicas())[0]["pid"]
        rc = orch.stop()
        check(rc == 0, f"the orchestrator exited {rc}: "
                       f"{(data / 'orchestrator.log').read_text()[-3000:]}")
        after = _check_on_card([], "after the stop", baseline)
        check(json.loads(registry.read_text()) == {}, "entries left in the registry")
        counted = {}
        for _, line in orch.out.find(f" kernel launches app={APP_ID} pid="):
            line_pid, launches = line.split(" pid=", 1)[1].split(" ", 1)
            counted[int(line_pid)] = json.loads(launches)
        expected = expected_serve_launches(last_stats, torch.cuda.device_count())
        check(list(counted) == [pid] and counted[pid]["flash_fwd"] == expected,
              f"B1 launches {counted} != expected {expected} for pid {pid}")
        check(all(v == 0 for k, v in counted[pid].items() if k != "flash_fwd"),
              f"the replica launched a backward or ring kernel: {counted}")
        repl_out, _ = _verb_run(env, "repl", str(data / "scores.db"))
        repl_lines = repl_out.splitlines()
        check(len(repl_lines) == PLACE_SHARDS * (1 + PLACE_REPLICAS)
              and all(any(x.startswith(f"scores shard {i}: leader {leaders[str(i)]} (epoch 1, ")
                          for x in repl_lines) for i in range(PLACE_SHARDS))
              and len([x for x in repl_lines if re.fullmatch(r"  r\d: hwm \d+ epoch 1", x)])
              == PLACE_SHARDS * PLACE_REPLICAS, f"repl printed {repl_out}")

        # 9. in this process, a writer scoring on the card: a plain sharded
        # store split, then replica sets
        reset_counts()
        plain = await _plain_split(data)
        split = await _in_process_replica_sets(data)
        split_launches = counts()["flash_fwd"]
        batches = plain["batches"] + split["batches"]
        check(split_launches == SERVED.n_layers * batches,
              f"the in-process writers launched B1 {split_launches} times, not "
              f"{SERVED.n_layers} × {batches}")

        # the stored scores against the scorer's math in this process
        stored = {}
        for path in shard_files:
            with contextlib.closing(sqlite3.connect(path)) as conn:
                stored.update((k.split("||", 1)[1], json.loads(v))
                              for k, v in conn.execute("SELECT key, value FROM state"))
        device = torch.device("cuda", 0)
        probs = service.batch_probs(
            [init_params(SERVED, 0, device)], [device],
            np.stack([service.task_tokens(t, SERVED) for t in tasks]), cfg=SERVED)
        worst = 0.0
        for row, t in zip(probs, tasks):
            got = stored[t["taskId"]]
            label = service.PRIORITY_LABELS.index(got["priority"])
            check(row[label] >= row.max() - SCORE_TOL,
                  f"{t['taskId']}: stored {got} but the scorer gives {row.tolist()}")
            worst = max(worst, abs(float(row[label]) - got["confidence"]))
        check(worst <= SCORE_TOL, f"stored confidence off by {worst}")
        return {"spawn_to_ready_s": ready_t - orch.spawned(0)[0][0],
                "events": PLACE_EVENTS, "stored_s": stored_s,
                "events_per_s": PLACE_EVENTS / stored_s,
                "keys_per_shard": [len(ks) for ks in per_shard], "stale_409s": stale,
                "transaction_ms": txn_ms, "query_pages": len(page_s),
                "query_ms_per_page": _p50_max_ms(page_s),
                "members": PLACE_REPLICAS, "records_replicated": replica_records,
                "replica_store": replica_store,
                "placement": {"ranking": entry["ranking"], "plan": entry["plan"],
                              "leaders": leaders},
                "shards_verb_s": verb_s, "shards_verb": lines, "repl_verb": repl_lines,
                "plain_split": plain, "replica_sets": split,
                "split_flash_launches": split_launches, "worst_confidence_err": worst,
                "after_stop": after, "launches": {str(pid): counted[pid]["flash_fwd"]},
                "expected_launches": {str(pid): expected}}
    except BaseException:
        for t, line in sorted(orch.err.lines + [x for x in orch.out.lines if any(
                w in x[1] for w in (" ready ", "WARNING", "ERROR", "Traceback", "Error"))]
                )[-80:]:
            print(f"{t - phase_t:9.3f} {line}", file=sys.stderr)
        raise
    finally:
        await publisher.registry.close()
        orch.kill()
        for entries in (json.loads(registry.read_text()).values() if registry.exists() else []):
            for entry in entries:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(entry["pid"], signal.SIGKILL)  # replicas a failed run left behind


def phase_placement(smi: str) -> int:
    """The scorer's ``scores`` store on four shards of three members behind
    its sidecar under ``python -m tasksrunner_torch run`` with the
    placement loop, then a handoff, a failover and an online split over
    replica sets in this process: returns B1's launches in the replica and
    in the in-process writer."""
    started = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-placement-") as data:
        result = asyncio.run(_placement_phase(Path(data)))
    launched = sum(result["launches"].values()) + result["split_flash_launches"]
    emit({"phase": "placement", "nvidia_smi": smi, **result,
          "seconds": time.monotonic() - started, "flash_launches": launched})
    check(launched > 0, "the placement phase launched no flash kernel")
    return launched


WF_TASKS = 32        # saved-task texts one triage instance scores
WF_INSTANCES = 8     # triage instances, half started through each sidecar
WF_TURNS = 64        # ScoreTally turns sent to each sidecar
WF_TALLIES = 8       # the actors those turns go to, half placed on each replica
WF_LONG_STEPS = 24   # the long triage's sequential scoring steps
WF_KILL_AFTER = 3    # its scoring steps committed before its owner is killed
WF_PACE_S = 0.05     # the long triage's pause a step, so the kill lands mid-run
WF_LEASE_S, WF_POLL_S = "1", "0.25"
WF_CHECKOUTS = [({"items": ["tea", "mug"], "amount": 42.0}, "completed"),
                ({"items": ["tv"], "amount": 9000.0}, "failed"),
                ({"items": ["pen"], "amount": 120.0}, "completed"),
                ({"items": ["lamp", "rug"], "amount": 777.0}, "failed")]
WF_APPS = '''"""The workflows phase's app: the scorer, an actor that keeps an owner's
running total of scores, the triage workflow whose activities score
saved tasks through the sidecar's service invocation of POST /score, and
the tasks tracker sample's checkout saga."""
import asyncio

from tasksrunner_torch import service
from tasksrunner_torch.resiliency import RetrySpec

CARD_LIMIT = 500.0
STORE = "statestore"


def scorer(device=None):
    app = service.make_app(device=device)

    @app.actor("ScoreTally")
    async def score_tally(turn):
        # an add with a key counts once: an activity may run twice
        key = (turn.data or {}).get("key")
        seen = turn.state.setdefault("seen", [])
        if key is None or key not in seen:
            if key is not None:
                seen.append(key)
            turn.state["total"] = turn.state.get("total", 0.0) + float(turn.data["score"])
            turn.state["count"] = turn.state.get("count", 0) + 1
        return {"total": turn.state.get("total", 0.0), "count": turn.state.get("count", 0)}

    @app.workflow("triage")
    async def triage(ctx, req):
        tasks = await ctx.call_activity("collect-tasks", req["taskIds"])
        pace = req.get("paceSeconds", 0.0)
        if req.get("sequential"):
            scores = [await ctx.call_activity("score-task", {"task": t, "pace": pace})
                      for t in tasks]
        else:
            scores = await ctx.when_all([ctx.call_activity("score-task", {"task": t})
                                         for t in tasks])
        tally = await ctx.call_activity("tally", {
            "owner": req["owner"], "key": ctx.instance,
            "score": sum(s["confidence"] for s in scores)})
        return {"scored": len(scores), "tally": tally}

    @app.activity("collect-tasks")
    async def collect_tasks(actx, task_ids):
        return [await app.client.get_state(STORE, f"task||{t}") for t in task_ids]

    # a 503 (warming) or a 429 (shed) is tried again
    @app.activity("score-task", retry=RetrySpec(duration=0.1, max_retries=50))
    async def score_task(actx, req):
        if req.get("pace"):
            await asyncio.sleep(req["pace"])
        reply = await app.client.invoke_method(app.app_id, "score", data=req["task"])
        if reply.status != 200:
            raise RuntimeError(f"/score answered {reply.status}")
        score = reply.json()
        doc = {"priority": score["priority"], "confidence": score["confidence"]}
        actx.stage_effect(f"score||{req['task']['taskId']}", doc)
        return doc

    @app.activity("tally")
    async def tally(actx, req):
        return await app.client.invoke_actor("ScoreTally", req["owner"], "add",
                                             {"score": req["score"], "key": req["key"]})

    # the sample's checkout saga (samples/tasks_tracker/backend_api/workflows.py)
    @app.workflow("checkout")
    async def checkout(ctx, order):
        order = dict(order or {})
        order_id = order.get("orderId") or ctx.uuid4()
        for item in order.get("items", []):
            stock = await ctx.call_activity("reserve-stock", {"orderId": order_id, "item": item})
            ctx.register_compensation("release-stock", stock)
        receipt = await ctx.call_activity(
            "charge-card", {"orderId": order_id, "amount": order.get("amount", 0)})
        ctx.register_compensation("refund-card", receipt)
        await ctx.call_activity("send-confirmation", {"orderId": order_id, "placedAt": ctx.now()})
        return {"orderId": order_id, "receipt": receipt}

    @app.activity("reserve-stock")
    async def reserve_stock(actx, data):
        actx.stage_effect(f"checkout||{data['orderId']}||reserved||{data['item']}", data)
        return data

    @app.activity("release-stock")
    async def release_stock(actx, data):
        actx.stage_effect(f"checkout||{data['orderId']}||reserved||{data['item']}",
                          operation="delete")
        return data["item"]

    @app.activity("charge-card", retry=RetrySpec(policy="exponential", duration=0.05,
                                                 max_retries=3), timeout=10.0)
    async def charge_card(actx, data):
        amount = float(data.get("amount") or 0)
        if amount > CARD_LIMIT:
            raise RuntimeError(f"card declined: {amount} exceeds limit {CARD_LIMIT}")
        receipt = {"orderId": data["orderId"], "amount": amount, "attempt": actx.attempt}
        actx.stage_effect(f"checkout||{data['orderId']}||charge", receipt)
        return receipt

    @app.activity("refund-card")
    async def refund_card(actx, receipt):
        actx.stage_effect(f"checkout||{receipt['orderId']}||charge", operation="delete")
        actx.stage_effect(f"checkout||{receipt['orderId']}||refund", receipt)
        return receipt["orderId"]

    @app.activity("send-confirmation")
    async def send_confirmation(actx, data):
        actx.stage_effect(f"checkout||{data['orderId']}||confirmation", data)
        return data["orderId"]

    return app
'''


def _workflow_files(data: Path) -> Path:
    """The apps' module and the components: the sample's store file as the
    actor store (``actorStateStore: "true"``) on a file in ``data``, scoped
    to the scorer, without its read cache (two processes write the file:
    a cache would serve one the records the other replaced)."""
    (data / "wf_apps.py").write_text(WF_APPS)
    comps = data / "components"
    comps.mkdir()
    (comps / "statestore.yaml").write_text(
        (SAMPLE_COMPONENTS / "statestore.yaml").read_text()
        .replace(".tasksrunner/statestore.db", str(data / "wf.db"))
        .replace('value: "1024"', 'value: "0"')
        .replace("- tasksmanager-backend-api", f"- {APP_ID}")
        .replace("scopes:", '  - name: actorStateStore\n    value: "true"\nscopes:'))
    return comps


def _history_seqs(history: list[dict]) -> list[int]:
    return [e["seq"] for e in history if e["t"] == "activity_completed"]


async def _workflows_phase(data: Path, device: str | None = None) -> dict:
    """The phase's run: two ``host`` replicas of the scorer over one actor
    store, on the card unless ``device`` names another."""
    comps, registry = _workflow_files(data), data / "apps.json"
    env = {**os.environ, "TASKSRUNNER_WORKFLOWS": "1", "TASKSRUNNER_TRACE_DB": "",
           "TASKSRUNNER_FLIGHTREC_DIR": str(data / "flightrec"),
           "TASKSRUNNER_ACTOR_LEASE_SECONDS": WF_LEASE_S,
           "TASKSRUNNER_ACTOR_REMINDER_POLL_SECONDS": WF_POLL_S,
           "PYTHONPATH": os.pathsep.join(filter(None, (str(data), os.environ.get("PYTHONPATH"))))}
    device_args = [] if device is None else ["--device", device]
    procs = _Processes(data)
    phase_t = time.monotonic()
    try:
        ready = await asyncio.gather(*(procs.start(
            name, "host", "wf_apps:scorer", "--components", str(comps), "--registry-file",
            str(registry), *device_args, env=env, log_level="info", seconds=600)
            for name in ("a", "b")))
        sidecar = {n: int(r["sidecar_port"]) for n, r in zip("ab", ready)}
        app_port = {n: int(r["app_port"]) for n, r in zip("ab", ready)}
        pid = {n: procs.procs[n].pid for n in "ab"}

        async def stats(name: str) -> dict:
            status, _, body = await _http(app_port[name], "GET", "/ml/stats")
            check(status == 200, f"/ml/stats of {name} answered {status}")
            return json.loads(body)

        async def call(name: str, method: str, path: str, body=None) -> tuple[int, object]:
            raw = b"" if body is None else json.dumps(body).encode()
            status, _, reply = await _http(sidecar[name], method, path, raw)
            return status, (json.loads(reply) if reply else None)

        async def wf(name: str, instance: str, what: str = "") -> object:
            status, doc = await call(name, "GET", f"/v1.0/workflows/engine/{instance}{what}")
            check(status == 200, f"{instance}{what} answered {status}: {doc}")
            return doc

        deadline = time.monotonic() + 600
        while not all([(await stats(n))["ready"] for n in "ab"]):
            check(time.monotonic() < deadline, "the replicas never warmed up")
            await asyncio.sleep(0.1)
        ready_s = time.monotonic() - phase_t

        # the saved tasks the triage instances collect
        tasks = [_saved_task("wf", i) for i in range(WF_INSTANCES * WF_TASKS + WF_LONG_STEPS)]
        status, _ = await call("a", "POST", "/v1.0/state/statestore",
                               [{"key": f"task||{t['taskId']}", "value": t} for t in tasks])
        check(status == 204, f"saving the tasks answered {status}")

        # 1. triage instances, half through each sidecar, all at once
        triage = {f"tri-{i}": {"taskIds": [t["taskId"] for t in
                                           tasks[i * WF_TASKS:(i + 1) * WF_TASKS]],
                               "owner": f"triage-owner-{i % 2}"} for i in range(WF_INSTANCES)}
        started = time.monotonic()
        starts = await asyncio.gather(*(call(
            "ab"[i % 2], "POST", f"/v1.0/workflows/engine/triage/start?instanceID={inst}", req)
            for i, (inst, req) in enumerate(triage.items())))
        check(all(s == (200, {"instanceID": i}) for s, i in zip(starts, triage)),
              f"triage starts answered {starts}")
        for inst in triage:
            while (doc := await wf("b", inst))["status"] == "running":
                await asyncio.sleep(0.02)
            check(doc["status"] == "completed" and doc["result"]["scored"] == WF_TASKS,
                  f"{inst} ended {doc}")
        triage_s = time.monotonic() - started

        # 2. ScoreTally turns: each actor placed on one replica first, then
        # WF_TURNS a sidecar at once, half of each sidecar's forwarded
        acked: dict[str, list[float]] = {f"owner-{k}": [] for k in range(WF_TALLIES)}
        for k in range(WF_TALLIES):
            status, doc = await call("ab"[k % 2], "PUT",
                                     f"/v1.0/actors/ScoreTally/owner-{k}/method/add",
                                     {"score": 0.0})
            check(status == 200, f"placing owner-{k} answered {status}: {doc}")
            acked[f"owner-{k}"].append(0.0)

        async def turn(name: str, i: int) -> tuple[str, str, int, float]:
            actor, score = f"owner-{i % WF_TALLIES}", (i % 16 + 1) / 16
            t = time.monotonic()
            status, _ = await call(name, "PUT", f"/v1.0/actors/ScoreTally/{actor}/method/add",
                                   {"score": score})
            if status == 200:
                acked[actor].append(score)
            return name, actor, status, time.monotonic() - t

        started = time.monotonic()
        turns = await asyncio.gather(*(turn(n, i) for n in "ab" for i in range(WF_TURNS)))
        turns_s = time.monotonic() - started
        check([t[2] for t in turns] == [200] * len(turns),
              f"tally turn statuses {sorted({t[2] for t in turns})}")
        status, view = await call("a", "GET", "/v1.0/actors")
        owner_of = {row["id"]: row["owner"] for row in view["placement"]}
        local = {n: (await call(n, "GET", "/v1.0/metadata"))[1]["actors"]["replica"] for n in "ab"}
        forwarded = [t[3] for t in turns if owner_of[t[1]] != local[t[0]]]
        check(len(forwarded) == WF_TURNS, f"{len(forwarded)} of {2 * WF_TURNS} turns forwarded")

        # 3. checkouts, the two above the card limit compensated
        for i, (order, _) in enumerate(WF_CHECKOUTS):
            status, _ = await call("ab"[i % 2], "POST",
                                   f"/v1.0/workflows/engine/checkout/start?instanceID=co-{i}",
                                   {**order, "orderId": f"ord-{i}"})
            check(status == 200, f"checkout co-{i} answered {status}")
        for i, (_, want) in enumerate(WF_CHECKOUTS):
            while (doc := await wf("a", f"co-{i}"))["status"] == "running":
                await asyncio.sleep(0.02)
            check(doc["status"] == want, f"co-{i} ended {doc}")

        # the verbs, while both replicas answer
        actors_out, _ = _verb_run(env, "actors", "--app-id", APP_ID, "--registry-file",
                                  str(registry))
        workflows_out, _ = _verb_run(env, "workflows", "--app-id", APP_ID, "--registry-file",
                                     str(registry))
        check(len(workflows_out.splitlines()) == 1 + WF_INSTANCES + len(WF_CHECKOUTS),
              f"workflows printed {workflows_out}")

        # 4. the long triage through a, killed with SIGKILL after its
        # WF_KILL_AFTER-th scoring step; b adopts it
        long_ids = [t["taskId"] for t in tasks[WF_INSTANCES * WF_TASKS:]]
        fired_before = (await call("b", "GET", "/v1.0/metadata"))[1]["metrics"].get(
            "actor_reminder_fired_total{type=_Workflow}", 0)
        long_start = asyncio.ensure_future(call(
            "a", "POST", "/v1.0/workflows/engine/triage/start?instanceID=tri-long",
            {"taskIds": long_ids, "owner": "triage-owner-long", "sequential": True,
             "paceSeconds": WF_PACE_S}))
        deadline = time.monotonic() + 60
        while True:
            status, doc = await call("b", "GET", "/v1.0/workflows/engine/tri-long/history")
            scored = [e for e in (doc or {}).get("history", [])
                      if e.get("t") == "activity_completed" and e["name"] == "score-task"]
            if status == 200 and len(scored) >= WF_KILL_AFTER:
                break
            check(time.monotonic() < deadline, f"tri-long never reached its third step: {doc}")
            await asyncio.sleep(0.005)
        status, place = await call("b", "GET", "/v1.0/actors")
        long_row = next(r for r in place["placement"] if r["id"] == "tri-long")
        check(long_row["pid"] == pid["a"], f"tri-long owned by {long_row}, not a's pid")
        epoch_at_kill = (await call("b", "GET", "/v1.0/actors/_Workflow/tri-long/state"))[1][
            "epoch"]
        os.kill(pid["a"], signal.SIGKILL)
        killed_t = time.monotonic()
        procs.procs.pop("a").wait(timeout=30)
        long_start.cancel()
        with contextlib.suppress(BaseException):
            await long_start
        at_kill = len(_history_seqs((await wf("b", "tri-long", "/history"))["history"]))
        failover_s = None
        deadline = time.monotonic() + 60
        while (doc := await wf("b", "tri-long"))["status"] == "running":
            if failover_s is None and len(_history_seqs(
                    (await wf("b", "tri-long", "/history"))["history"])) > at_kill:
                failover_s = time.monotonic() - killed_t
            check(time.monotonic() < deadline, f"tri-long never ended after the kill: {doc}")
            await asyncio.sleep(0.01)
        if failover_s is None:
            failover_s = time.monotonic() - killed_t
        check(doc["status"] == "completed" and doc["result"]["scored"] == WF_LONG_STEPS,
              f"tri-long ended {doc}")
        fired = (await call("b", "GET", "/v1.0/metadata"))[1]["metrics"].get(
            "actor_reminder_fired_total{type=_Workflow}", 0) - fired_before
        check(fired >= 1, "no drive reminder fired on the survivor")
        status, record = await call("b", "GET", "/v1.0/actors/_Workflow/tri-long/state")
        check(record["epoch"] > epoch_at_kill,
              f"the adopted record's epoch {record['epoch']}, {epoch_at_kill} at the kill")

        # every history contiguous, without a duplicate, across the kill
        lengths = {}
        for inst in [*triage, "tri-long", *(f"co-{i}" for i in range(len(WF_CHECKOUTS)))]:
            history = (await wf("b", inst, "/history"))["history"]
            seqs = _history_seqs(history)
            check(seqs == list(range(1, len(seqs) + 1)), f"{inst}: activity seqs {seqs}")
            lengths[inst] = len(history)
        check(all(lengths[i] == WF_TASKS + 4 for i in triage)
              and lengths["tri-long"] == WF_LONG_STEPS + 4, f"history lengths {lengths}")

        # each tally the sum of its acknowledged turns, the triage ones once each
        for actor, scores in acked.items():
            state = (await call("b", "GET", f"/v1.0/actors/ScoreTally/{actor}/state"))[1]["data"]
            check(state["count"] == len(scores) and state["total"] == sum(scores),
                  f"{actor}: {state['count']} turns totalling {state['total']}, acked "
                  f"{len(scores)} totalling {sum(scores)}")
        for owner, n in (("triage-owner-0", WF_INSTANCES // 2),
                         ("triage-owner-1", WF_INSTANCES // 2), ("triage-owner-long", 1)):
            state = (await call("b", "GET", f"/v1.0/actors/ScoreTally/{owner}/state"))[1]["data"]
            check(state["count"] == n, f"{owner} counted {state['count']} instances, not {n}")

        # the survivor's clean stop: its launches against its /ml/stats
        last_stats = await stats("b")
        procs.stop("b")
        counted = [json.loads(line.split(" pid=", 1)[1].split(" ", 1)[1])
                   for line in (data / "b.log").read_text().splitlines()
                   if f" kernel launches app={APP_ID} pid={pid['b']} " in line]
        expected = expected_serve_launches(last_stats, torch.cuda.device_count())
        check(len(counted) == 1 and counted[0]["flash_fwd"] == expected,
              f"the survivor's B1 launches {counted} != expected {expected}")

        # the store file: every score once, each the smoke's own within SCORE_TOL;
        # compensated checkouts hold no reservation
        with contextlib.closing(sqlite3.connect(data / "wf.db")) as conn:
            rows = dict(conn.execute("SELECT key, value FROM state"))
        prefix = f"{APP_ID}||"
        scores = {k[len(prefix + "score||"):]: json.loads(v) for k, v in rows.items()
                  if k.startswith(prefix + "score||")}
        check(sorted(scores) == sorted(t["taskId"] for t in tasks),
              f"{len(scores)} score effects stored for {len(tasks)} tasks")
        for i, (order, want) in enumerate(WF_CHECKOUTS):
            held = sorted(k for k in rows if k.startswith(f"{prefix}checkout||ord-{i}||"))
            if want == "failed":  # declined: no charge, the reservations released
                check(held == [], f"compensated co-{i} holds {held}")
            else:
                check(len([k for k in held if "||reserved||" in k]) == len(order["items"])
                      and f"{prefix}checkout||ord-{i}||confirmation" in held,
                      f"co-{i} holds {held}")
        dev = torch.device(device or "cuda:0")
        probs = service.batch_probs(
            [init_params(SERVED, 0, dev)], [dev],
            np.stack([service.task_tokens(t, SERVED) for t in tasks]), cfg=SERVED)
        worst = 0.0
        for row, t in zip(probs, tasks):
            got = scores[t["taskId"]]
            label = service.PRIORITY_LABELS.index(got["priority"])
            check(row[label] >= row.max() - SCORE_TOL,
                  f"{t['taskId']}: stored {got} but the scorer gives {row.tolist()}")
            worst = max(worst, abs(float(row[label]) - got["confidence"]))
        check(worst <= SCORE_TOL, f"stored confidence off by {worst}")
        return {"replicas_ready_s": ready_s,
                "triage": {"instances": WF_INSTANCES, "tasks_each": WF_TASKS,
                           "seconds": triage_s, "instances_per_s": WF_INSTANCES / triage_s},
                "tally_turns": {"turns": len(turns), "seconds": turns_s,
                                "turns_per_s": len(turns) / turns_s,
                                "forwarded": len(forwarded),
                                "forwarded_ms": _p50_max_ms(forwarded),
                                "local_ms": _p50_max_ms([t[3] for t in turns
                                                         if owner_of[t[1]] == local[t[0]]])},
                "kill": {"steps_at_kill": at_kill, "failover_s": failover_s,
                         "reminder_refires_on_survivor": fired,
                         "epoch_at_kill": epoch_at_kill, "adopted_epoch": record["epoch"]},
                "history_lengths": lengths, "score_effects": len(scores),
                "worst_confidence_err": worst, "verbs": {
                    "actors": actors_out.splitlines(), "workflows": len(
                        workflows_out.splitlines()) - 1},
                "survivor_launches": counted[0]["flash_fwd"], "expected_launches": expected}
    except BaseException:
        for name in ("a", "b"):
            if (data / f"{name}.log").exists():
                print(f"--- replica {name}, {time.monotonic() - phase_t:.3f} s into the phase:\n"
                      f"{procs.tail(name)}", file=sys.stderr)
        raise
    finally:
        procs.kill_all()


def phase_workflows(smi: str) -> int:
    """Two ``host`` replicas of the scorer over one actor store: triage
    workflows scoring saved tasks through ``/score``, ScoreTally turns
    forwarded between the replicas, checkouts, and a ``kill -9`` of a
    running instance's owner; returns the survivor's B1 launches."""
    started = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-workflows-") as data:
        result = asyncio.run(_workflows_phase(Path(data)))
    emit({"phase": "workflows", "nvidia_smi": smi, **result,
          "seconds": time.monotonic() - started})
    check(result["survivor_launches"] > 0, "the workflows phase launched no flash kernel")
    return result["survivor_launches"]


def _one_step(cfg, params, tokens, labels, lr, *, flash_on: bool,
              mesh: Mesh | None = None):
    """One train step from a copy of ``params``: (new params, loss)."""
    os.environ["TASKSRUNNER_FLASH"] = "1" if flash_on else "0"
    try:
        copy = model._with_leaves([p.clone() for p in model._leaves(params)])
        new, loss = model.make_train_step(cfg, mesh, learning_rate=lr)(copy, tokens, labels)
        torch.cuda.synchronize()
        return new, loss
    finally:
        os.environ.pop("TASKSRUNNER_FLASH")


def _compare_steps(config: str, cfg: ModelConfig, batch: int) -> None:
    """One step with the flash core (each backward variant) against one
    with the einsum core from the same params, at a rate where a wrong
    gradient shows in the leaves, held to the dryrun's limits."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = init_params(cfg, 1, "cuda")
    tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen, device="cuda")
    want, want_loss = _one_step(cfg, params, tokens, labels, 0.1, flash_on=False)
    for name, variant in BWD_VARIANTS.items():
        with bwd_variant(variant):
            got, got_loss = _one_step(cfg, params, tokens, labels, 0.1, flash_on=True)
        errs = [(g - w).abs().max().item()
                for g, w in zip(model._leaves(got), model._leaves(want))]
        moved = max((g - p).abs().max().item()
                    for g, p in zip(model._leaves(got), model._leaves(params)))
        ok = (abs(got_loss.item() - want_loss.item()) <= LOSS_TOL and max(errs) <= LEAF_TOL
              and all(bool(torch.isfinite(g).all()) for g in model._leaves(got))
              and moved > 1e-3)
        emit({"phase": "train", "config": config, "batch": batch,
              "step": "flash vs einsum", "kernel": name, "learning_rate": 0.1,
              "loss_flash": got_loss.item(), "loss_einsum": want_loss.item(),
              "max_abs_err_leaves": max(errs), "max_leaf_move": moved, "ok": ok})
        check(ok, f"{config} {name}: the flash train step disagrees with the einsum one")
        del got


def phase_train() -> dict:
    """The training path: counts set to 0 just before, read just after."""
    reset_counts()
    steps = 10
    before = counts()
    losses = train.train(SERVED, steps, SERVED_BATCH, seed=0, learning_rate=SERVED_LR)
    launched = {k: v - before[k] for k, v in counts().items()}
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and launched == {"flash_fwd": steps * SERVED.n_layers,
                           "flash_bwd_delta": steps * SERVED.n_layers,
                           "flash_bwd_fused": 0, "flash_ring": 0, "flash_ring_bwd": 0})
    emit({"phase": "train", "config": "served", "steps": steps, "batch": SERVED_BATCH,
          "learning_rate": SERVED_LR, "losses": losses, "launches": launched,
          "n_layers": SERVED.n_layers, "ok": ok})
    check(ok, f"served training: losses {losses}, launches {launched}")

    _compare_steps("served", SERVED, SERVED_BATCH)

    steps = 3
    before = counts()
    losses = train.train(BENCH, steps, BENCH_BATCH, seed=0)
    launched = {k: v - before[k] for k, v in counts().items()}
    ok = (all(math.isfinite(x) for x in losses)
          and launched["flash_bwd_delta"] == steps * BENCH.n_layers)
    emit({"phase": "train", "config": "bench", "steps": steps, "batch": BENCH_BATCH,
          "losses": losses, "launches": launched, "n_layers": BENCH.n_layers, "ok": ok})
    check(ok, f"bench training: losses {losses}, launches {launched}")
    _compare_steps("bench", BENCH, BENCH_BATCH)
    final = counts()
    for name in ("flash_fwd", *BWD_VARIANTS):
        check(final[name] > 0, f"the training path launched {name} no time")
    check(final["flash_ring"] == final["flash_ring_bwd"] == 0,
          "the single-device training path launched a ring kernel")
    return final


def _step_errors(got, want, params) -> dict:
    errs = [(g - w).abs().max().item()
            for g, w in zip(model._leaves(got), model._leaves(want))]
    moved = min((g - p).abs().max().item()
                for g, p in zip(model._leaves(got), model._leaves(params)))
    return {"max_abs_err_leaves": max(errs), "min_leaf_move": moved,
            "finite": all(bool(torch.isfinite(g).all()) for g in model._leaves(got))}


def phase_sequence_parallel() -> dict:
    """The slice's main path, the model with a Mesh: the bench config's
    forward at sp 4, one train step at sp 4 and one at the served config
    at sp 2, each against the single-device flash path from the same
    params. The references run first; the launch counts are set to 0
    just before the sequence-parallel runs and read just after, and the
    K/V rotations (``ring._rotate`` calls) counted around them: the
    one-process ring reads the visiting block in place and rotates
    nothing."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = []
    for name, cfg, batch, sp in (("bench", BENCH, BENCH_BATCH, BENCH_SP),
                                 ("served", SERVED, SERVED_BATCH, SERVED_SP)):
        params = init_params(cfg, 1, "cuda")
        tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen, device="cuda")
        want_logits = _logits(params, tokens, cfg, flash_on=True) if name == "bench" else None
        want, want_loss = _one_step(cfg, params, tokens, labels, 0.1, flash_on=True)
        cases.append((name, cfg, batch, sp, params, tokens, labels, want_logits, want,
                      want_loss))

    reset_counts()
    expected = dict.fromkeys(counts(), 0)
    with counted_rotations() as rotations:
        _run_sequence_parallel(cases, expected)
    launched = counts()
    emit({"phase": "sequence_parallel", "launches": launched, "expected": expected,
          "rotations": len(rotations)})
    check(launched == expected, f"sequence-parallel launches {launched} != {expected}")
    check(launched["flash_ring"] > 0 and launched["flash_ring_bwd"] > 0,
          "the sequence-parallel path launched a ring kernel no time")
    check(not rotations, f"the one-process ring rotated K/V {len(rotations)} times")
    return launched


def _run_sequence_parallel(cases, expected: dict) -> None:
    for name, cfg, batch, sp, params, tokens, labels, want_logits, want, want_loss in cases:
        if want_logits is not None:
            before = counts()
            got = _logits(params, tokens, cfg, flash_on=True, mesh=Mesh(sp=sp))
            launched = {k: n - before[k] for k, n in counts().items()}
            err = (got - want_logits).abs().max().item()
            ok = (got.shape == (batch, cfg.n_classes) and bool(torch.isfinite(got).all())
                  and bool(((got - want_logits).abs()
                            <= LOGITS_TOL + LOGITS_TOL * want_logits.abs()).all())
                  and launched == {**dict.fromkeys(launched, 0),
                                   "flash_ring": cfg.n_layers * sp})
            emit({"phase": "sequence_parallel", "config": name, "batch": batch, "sp": sp,
                  "run": "forward", "max_abs_err_logits_vs_single_device": err,
                  "launches": launched, "n_layers": cfg.n_layers, "ok": ok})
            check(ok, f"{name} sp {sp} forward: logits or launches {launched} wrong")
            expected["flash_ring"] += cfg.n_layers * sp
        got, got_loss = _one_step(cfg, params, tokens, labels, 0.1, flash_on=True,
                                  mesh=Mesh(sp=sp))
        errs = _step_errors(got, want, params)
        ok = (abs(got_loss.item() - want_loss.item()) <= LOSS_TOL
              and errs["max_abs_err_leaves"] <= LEAF_TOL and errs["finite"]
              and errs["min_leaf_move"] > 0)
        emit({"phase": "sequence_parallel", "config": name, "batch": batch, "sp": sp,
              "run": "train step", "learning_rate": 0.1, "loss_sp": got_loss.item(),
              "loss_single_device": want_loss.item(), **errs, "ok": ok})
        check(ok, f"{name} sp {sp} train step disagrees with the single-device step")
        expected["flash_ring"] += cfg.n_layers * sp
        expected["flash_ring_bwd"] += cfg.n_layers * sp
        del got


def _sharded_launches(cfg: ModelConfig, sp: int) -> dict:
    """What one rank's step launches: B1 and B2 once per layer at sp 1,
    B4 and the ring's backward sp times per layer above."""
    zero = dict.fromkeys(counts(), 0)
    if sp == 1:
        return {**zero, "flash_fwd": cfg.n_layers, "flash_bwd_delta": cfg.n_layers}
    return {**zero, "flash_ring": cfg.n_layers * sp, "flash_ring_bwd": cfg.n_layers * sp}


def phase_sharded(cards: int = 1, meshes=SHARDED_MESHES, dryrun_ranks: int = 8) -> None:
    """The dp × sp × tp train step over spawned ranks on ``cards`` cards,
    rank r on cuda:(r mod cards): the dryrun at its default factorization
    of ``dryrun_ranks``, then the bench config at each of ``meshes``. With
    a card for each rank the ranks use NCCL, else gloo, whose collectives
    go through the host. The ranks load the kernels built by
    the build phase; each holds its updated tree against the
    single-device step (loss 1e-2, leaves 2e-2, updates 5e-2 of the
    largest: a failure raises) and reports its launch counts around its
    step."""
    torch.cuda.empty_cache()
    started = time.monotonic()
    runs = [("dryrun", graft_entry.DRYRUN_CONFIG,
             graft_entry.default_factorization(dryrun_ranks), 4)]
    runs += [("bench", BENCH, mesh, BENCH_BATCH) for mesh in meshes]
    for name, cfg, (dp, sp, tp), batch in runs:
        n = dp * sp * tp
        devices = [f"cuda:{r % cards}" for r in range(n)]
        timing = (f"{n} ranks on {n} cards over NCCL" if cards >= n else
                  f"{n} ranks on {'one card' if cards == 1 else f'{cards} cards'} "
                  "over gloo, collectives through the host")
        t0 = time.monotonic()
        if name == "dryrun":
            reports = graft_entry.dryrun_multichip(n, devices=devices)
        else:
            reports = graft_entry.sharded_step(cfg, n, dp=dp, sp=sp, tp=tp,
                                               devices=devices, batch=batch)
        wall_s = time.monotonic() - t0
        expected = _sharded_launches(cfg, sp)
        for report in reports:
            ok = report["launches"] == expected
            emit({"phase": "sharded", "config": name, "mesh_dp_sp_tp": [dp, sp, tp],
                  "batch": batch, **report, "expected_launches": expected,
                  "timing": timing, "ok": ok})
            check(ok, f"sharded {name} {(dp, sp, tp)} rank {report['rank']}: launches "
                      f"{report['launches']} != {expected}")
        emit({"phase": "sharded", "config": name, "mesh_dp_sp_tp": [dp, sp, tp],
              "batch": batch, "ranks": n, "wall_s": wall_s,
              "step_s_max": max(r["step_s"] for r in reports), "timing": timing})
    emit({"phase": "sharded", "cards": cards, "wall_s": time.monotonic() - started})


def _time_attention(b, s, h, d) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = qkv(gen, b, s, h, d, torch.bfloat16)
    scale = d ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [b, h, s, d] views
    kernel_ms = cuda_ms(lambda: flash.flash_fwd(q, k, v, scale))
    plain_ms = cuda_ms(lambda: flash.flash_fwd_reference(q, k, v, scale), reps=5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
    bound_ms, bound_by = attention_bound(b, s, h, d, q.element_size())
    return {"shape": [b, s, h, d], "dtype": "bfloat16", "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "vs_library": kernel_ms / library_ms, "bound_share": bound_ms / kernel_ms}


def _time_attention_bwd(b, s, h, d) -> dict:
    """Each backward variant's wrapper, the plain version, and the
    library yardstick: scaled_dot_product_attention's forward and
    backward less its forward, on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, dout = qkv(gen, b, s, h, d, torch.bfloat16, n=4)
    scale = d ** -0.5
    out, lse = flash.flash_fwd(q, k, v, scale)
    plain_ms = cuda_ms(lambda: flash.flash_bwd_reference(q, k, v, out, lse, dout, scale),
                       reps=5)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dout_t = dout.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

    sdpa_fwd_ms = cuda_ms(sdpa)
    sdpa_fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dout_t))
    timed = {}
    for name, variant in BWD_VARIANTS.items():
        with bwd_variant(variant):
            ms = cuda_ms(lambda: flash.flash_bwd(q, k, v, out, lse, dout, scale))
        bound_ms, bound_by = attention_bwd_bound(b, s, h, d, q.element_size())
        timed[name] = {"shape": [b, s, h, d], "dtype": "bfloat16", "ms": ms,
                       "plain_ms": plain_ms, "library_ms": sdpa_fwd_bwd_ms - sdpa_fwd_ms,
                       "library_fwd_bwd_ms": sdpa_fwd_bwd_ms, "library_fwd_ms": sdpa_fwd_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by}
    return timed


def _time_ring_block(b, sq, sk, h, d) -> dict:
    """The ring block update on a later-step state (its work does not
    depend on the values): kernel, plain version and bound. No single
    PyTorch call computes this state update, so there is no library
    time."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    (q,) = qkv(gen, b, sq, h, d, torch.bfloat16, n=1)
    k, v = qkv(gen, b, sk, h, d, torch.bfloat16, n=2)
    state = ring_state(gen, b, sq, h, d, start=False)
    scale = d ** -0.5
    kernel_ms = cuda_ms(lambda: flash.ring_block_update(q, k, v, *state, scale=scale))
    plain_ms = cuda_ms(lambda: flash.ring_block_update_reference(q, k, v, *state, scale=scale),
                       reps=5)
    bound_ms, bound_by = ring_bound(b, sq, sk, h, d, q.element_size())
    return {"shape": [b, sq, sk, h, d], "dtype": "bfloat16", "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / kernel_ms}


def _step_peak_bytes(step, params, tokens, labels) -> int:
    """The peak of allocated device memory over one train step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(params, tokens, labels)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _time_ring_bwd(b, s, h, d, sp) -> dict:
    """The ring's backward step on the inputs of a ring of ``sp``: kernel,
    plain version and bound. No single PyTorch call takes the ring's LSE
    and Δ and adds into gradient accumulators, so there is no library
    time."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    inputs = ring_grad_inputs(gen, b, s, h, d, torch.bfloat16, sp)
    acc = [torch.zeros(b, s, h, d, device="cuda") for _ in range(3)]
    scale = d ** -0.5
    kernel_ms = cuda_ms(lambda: flash.ring_block_grad(*inputs, *acc, scale=scale))
    plain_ms = cuda_ms(lambda: flash.ring_block_grad_reference(*inputs, *acc, scale=scale),
                       reps=5)
    bound_ms, bound_by = ring_bwd_bound(b, s, h, d, 2)
    return {"shape": [b, s, h, d], "dtype": "bfloat16", "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / kernel_ms}


def _time_sequence_parallel() -> None:
    """Ring attention at sp 4 against the dense flash forward on the same
    global bench-shape inputs; the forward and train step of the bench
    config at sp 4 and of the served config at sp 2, each beside the
    single-device forward and step on the same params and tokens, with
    the steps' peak device memory."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    b, s, h, d = BENCH_BATCH, BENCH.seq_len, BENCH.n_heads, BENCH.d_head
    q, k, v = qkv(gen, b, s, h, d, torch.bfloat16)
    with torch.inference_mode():
        ring_ms = cuda_ms(lambda: ring.ring_attention(q, k, v, mesh=Mesh(sp=BENCH_SP)))
        dense_ms = cuda_ms(lambda: flash.flash_attention(q, k, v))
    emit({"phase": "times", "attention": "ring vs dense", "shape": [b, s, h, d],
          "sp": BENCH_SP, "ring_ms": ring_ms, "dense_flash_ms": dense_ms,
          "ring_bound_ms": BENCH_SP * ring_bound(b * BENCH_SP, s // BENCH_SP, s // BENCH_SP,
                                                 h, d, 2)[0],
          "dense_bound_ms": attention_bound(b, s, h, d, 2)[0]})
    for name, cfg, batch, sp in (("bench", BENCH, BENCH_BATCH, BENCH_SP),
                                 ("served", SERVED, SERVED_BATCH, SERVED_SP)):
        params = init_params(cfg, 0, "cuda")
        tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen, device="cuda")
        fwd_ms, step_ms, peak = {}, {}, {}
        for mesh in (Mesh(sp=sp), None):
            key = "sp" if mesh else "single_device"
            with torch.inference_mode():
                fwd_ms[key] = cuda_ms(lambda: forward(params, tokens, cfg=cfg, mesh=mesh),
                                      reps=7, inner=5)
            step = model.make_train_step(cfg, mesh)
            step_ms[key] = cuda_ms(lambda: step(params, tokens, labels), warmup=2, reps=5,
                                   inner=3)
            peak[key] = _step_peak_bytes(step, params, tokens, labels)
        emit({"phase": "times", "forward": name, "sp": sp, "batch": batch,
              "ms": fwd_ms["sp"], "single_device_ms": fwd_ms["single_device"],
              "vs_single_device": fwd_ms["sp"] / fwd_ms["single_device"]})
        emit({"phase": "times", "train_step": name, "sp": sp, "batch": batch,
              "ms": step_ms["sp"], "single_device_ms": step_ms["single_device"],
              "vs_single_device": step_ms["sp"] / step_ms["single_device"],
              "peak_bytes": peak["sp"], "single_device_peak_bytes": peak["single_device"]})
        del params


def host_us(fn, *, calls: int = 200, reps: int = 7) -> float:
    """The host's time per call, in µs: the median over ``reps`` of the
    wall time per call of ``calls`` back-to-back calls, each window begun
    on an idle card and ended without waiting for it. Where the card runs
    a call faster than the host enqueues it, this is the host's cost."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        started = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - started) / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def _time_host() -> None:
    """The host's cost per call on the served config's sp-2 path: the ring
    block update at its fold shape, ring attention beside the dense flash
    attention on the same global inputs, and the forward at sp 2 beside
    the single-device one."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    cfg, sp, b = SERVED, SERVED_SP, SERVED_BATCH
    s, h, d = cfg.seq_len, cfg.n_heads, cfg.d_head
    q, k, v = qkv(gen, b, s, h, d, torch.bfloat16)
    fold = [x.reshape(b * sp, s // sp, h, d) for x in (q, k, v)]
    state = ring_state(gen, b * sp, s // sp, h, d, start=False)
    params = init_params(cfg, 0, "cuda")
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda",
                           dtype=torch.int32)
    calls = {"ring_block_update": lambda: flash.ring_block_update(*fold, *state,
                                                                   scale=d ** -0.5),
             "ring_attention": lambda: ring.ring_attention(q, k, v, mesh=Mesh(sp=sp)),
             "flash_attention": lambda: flash.flash_attention(q, k, v),
             "forward_sp": lambda: forward(params, tokens, cfg=cfg, mesh=Mesh(sp=sp)),
             "forward_single_device": lambda: forward(params, tokens, cfg=cfg)}
    with torch.inference_mode():
        emit({"phase": "times", "host_us_per_call": {name: host_us(fn)
                                                     for name, fn in calls.items()},
              "config": "served", "sp": sp, "batch": b,
              "fold_shape": [b * sp, s // sp, h, d]})
    del params


def _time_sharded_host() -> None:
    """The host's cost per call of each kernel's wrapper at the sharded
    phase's per-rank shapes: where it reaches the CUDA-event time, that
    time is the host's, not the kernel's."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    b, s, h, d = SHARDED_DENSE
    q, k, v, dout = qkv(gen, b, s, h, d, torch.bfloat16, n=4)
    out, lse = flash.flash_fwd(q, k, v, d ** -0.5)
    rb, rs, _, rh, rd = SHARDED_RING
    ring_inputs = ring_grad_inputs(gen, rb, rs, rh, rd, torch.bfloat16, 2)
    state = ring_state(gen, rb, rs, rh, rd, start=False)
    acc = [torch.zeros(rb, rs, rh, rd, device="cuda") for _ in range(3)]
    calls = {"flash_fwd": lambda: flash.flash_fwd(q, k, v, d ** -0.5),
             "flash_bwd_delta": lambda: flash.flash_bwd(q, k, v, out, lse, dout, d ** -0.5),
             "flash_ring": lambda: flash.ring_block_update(*ring_inputs[:3], *state,
                                                          scale=rd ** -0.5),
             "flash_ring_bwd": lambda: flash.ring_block_grad(*ring_inputs, *acc,
                                                             scale=rd ** -0.5)}
    emit({"phase": "times", "path": "sharded, one rank",
          "shapes": {"dense": SHARDED_DENSE, "ring": SHARDED_RING},
          "host_us_per_call": {name: host_us(fn) for name, fn in calls.items()}})


def phase_times() -> dict:
    timed = {}
    shapes = [(1, 32, 4, 32), (8, 32, 4, 32), (32, 32, 4, 32), (BENCH_BATCH, 512, 16, 64)]
    for shape in shapes:
        timed[shape] = {"flash_fwd": _time_attention(*shape)}
        emit({"phase": "times", "kernel": "flash_fwd", **timed[shape]["flash_fwd"]})
        timed[shape].update(_time_attention_bwd(*shape))
        for name in BWD_VARIANTS:
            emit({"phase": "times", "kernel": name, **timed[shape][name]})
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, cfg, batches in (("served", SERVED, (1, 2, 4, 8, 16, 32)),
                               ("bench", BENCH, (BENCH_BATCH,))):
        params = init_params(cfg, 0, "cuda")
        for batch in batches:
            tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                                   device="cuda", dtype=torch.int32)
            with torch.inference_mode():
                ms = cuda_ms(lambda: forward(params, tokens, cfg=cfg), reps=7, inner=5)
            emit({"phase": "times", "forward": name, "batch": batch, "ms": ms})
        del params
    for name, cfg, batch in (("served", SERVED, SERVED_BATCH), ("served", SERVED, 32),
                             ("bench", BENCH, BENCH_BATCH)):
        params = init_params(cfg, 0, "cuda")
        tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen, device="cuda")
        step = model.make_train_step(cfg)
        ms = cuda_ms(lambda: step(params, tokens, labels), warmup=2, reps=5, inner=3)
        emit({"phase": "times", "train_step": name, "batch": batch, "ms": ms})
        del params
    for shape, sp in (((SERVED_BATCH * SERVED_SP, 16, 16, 4, 32), SERVED_SP),
                      (RING_CASES[4], BENCH_SP), (SHARDED_RING, 2)):
        timed[shape] = {"flash_ring": _time_ring_block(*shape),
                        "flash_ring_bwd": _time_ring_bwd(*shape[:2], *shape[3:], sp)}
        for name in ("flash_ring", "flash_ring_bwd"):
            emit({"phase": "times", "kernel": name, **timed[shape][name]})
    sharded = {"flash_fwd": _time_attention(*SHARDED_DENSE),
               **_time_attention_bwd(*SHARDED_DENSE)}
    for name, record in sharded.items():
        emit({"phase": "times", "kernel": name, "path": "sharded, one rank", **record})
    _time_sharded_host()
    _time_sequence_parallel()
    _time_host()
    return {"flash_fwd": timed[(32, 32, 4, 32)]["flash_fwd"],
            **{name: timed[(BENCH_BATCH, 512, 16, 64)][name] for name in BWD_VARIANTS},
            **timed[RING_CASES[4]]}


def _profile(fn, n: int) -> dict:
    """Device busy time (summed kernel time over the host wall time of a
    synchronised window of ``n`` calls) and the largest kernels, from
    torch.profiler. The profiler adds host time, so the share is a lower
    bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - started
    # device-side events only: an aten op also carries the time of the
    # kernels it launched, and so does NCCL's ``nccl:*`` range
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.key.startswith("nccl:")]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"calls": n, "wall_ms_per_call": 1e3 * wall_s / n,
            "device_busy_ms_per_call": 1e3 * busy_s / n,
            "device_busy_share": busy_s / wall_s if busy_s else None,
            "top_ms_per_call": {e.key[:80]: e.self_device_time_total / 1e3 / n
                                for e in top}}


def phase_profile() -> None:
    gen = torch.Generator(device="cuda").manual_seed(6)
    for name, cfg, batch, n, sp in (("served", SERVED, 32, 20, None),
                                    ("bench", BENCH, BENCH_BATCH, 5, None),
                                    ("bench", BENCH, BENCH_BATCH, 5, BENCH_SP)):
        params = init_params(cfg, 0, "cuda")
        tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels = torch.randint(0, cfg.n_classes, (batch,), generator=gen, device="cuda")
        mesh = Mesh(sp=sp) if sp else None

        def fwd():
            with torch.inference_mode():
                forward(params, tokens, cfg=cfg, mesh=mesh)

        emit({"phase": "profile", "forward": name, "sp": sp, "batch": batch,
              **_profile(fwd, n)})
        step = model.make_train_step(cfg, mesh)
        emit({"phase": "profile", "train_step": name, "sp": sp, "batch": batch,
              **_profile(lambda: step(params, tokens, labels), n)})
        del params


def phase_bench(smi: str) -> dict:
    """bench.py's train-step and serving lanes on the port: counts set to
    0 just before, read just after. Returns the kernels' launches."""
    reset_counts()
    step = bench.run_step_bench()
    step_launches = counts()
    serve = asyncio.run(bench.run_ml_serve_bench())
    launched = counts()
    lanes = (serve["serial"], serve["batched"], serve["flood"])
    # one forward per layer for each warmed bucket and each batch run
    serve_expected = SERVED.n_layers * sum(
        lane["jit_cache_size_after_load"] + sum(lane["batches"].values()) for lane in lanes)
    emit({"phase": "bench", "nvidia_smi": smi, "step": step, "serve": serve,
          "launches": launched, "serve_expected_flash_fwd": serve_expected})
    losses = step["losses"] + step["einsum_core_losses"]
    check(all(math.isfinite(x) for x in losses), f"bench step losses {losses}")
    check(step["mfu"] is not None and 0 < step["mfu"] <= 1.05, f"bench mfu {step['mfu']}")
    per_core = (step["steps"] + 1) * BENCH.n_layers
    check(step["launches"] == {"flash_fwd": per_core, "flash_bwd_delta": per_core,
                               "flash_bwd_fused": 0, "flash_ring": 0, "flash_ring_bwd": 0},
          f"bench step launches {step['launches']}, expected {per_core} B1 and B2")
    check(not any(step["einsum_core_launches"].values()),
          f"the einsum core launched {step['einsum_core_launches']}")
    check(launched["flash_fwd"] - step_launches["flash_fwd"] == serve_expected,
          f"serve lanes' B1 launches {launched['flash_fwd'] - step_launches['flash_fwd']} "
          f"!= {serve_expected}")
    check(launched["flash_bwd_delta"] == step_launches["flash_bwd_delta"],
          "the serve lanes launched a backward kernel")
    for name in ("serial", "batched"):
        check(serve[name]["response_mismatches"] == 0,
              f"{name} lane: {serve[name]['response_mismatches']} mismatches")
    check(serve["zero_recompiles"], "a serve lane ran a shape after warm-up")
    flood = serve["flood"]
    check(flood["shed"] > 0 and flood["shed_without_retry_after"] == 0
          and flood["shed_carry_retry_after"], f"the flood did not shed with Retry-After: {flood}")
    check(flood["other_statuses"] == 0, f"the flood got {flood['other_statuses']} other statuses")
    check(flood["queue_wait_bounded"],
          f"flood p99 queue wait {flood['queue_wait_p99_ms']} ms over "
          f"{flood['bound_with_resolution_ms']} ms")
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    started, seconds = time.monotonic(), {}

    def clocked(phase, *args):
        """A phase run, its seconds kept under its name."""
        t = time.monotonic()
        try:
            return phase(*args)
        finally:
            seconds[phase.__name__.removeprefix("phase_")] = time.monotonic() - t

    smi = clocked(phase_device)
    clocked(phase_build)
    worst_err = clocked(phase_kernel_vs_plain)
    worst_err["flash_ring"] = clocked(phase_ring_kernel_vs_plain)
    worst_err["flash_ring_bwd"] = clocked(phase_ring_bwd_kernel_vs_plain)
    clocked(phase_matmul)
    clocked(phase_gradient)
    clocked(phase_ring)
    clocked(phase_forward)
    launches = {"flash_fwd": clocked(phase_serve) + clocked(phase_runtime, smi)
                + clocked(phase_sidecar, smi) + clocked(phase_orchestrator, smi)
                + clocked(phase_deploy, smi) + clocked(phase_bindings, smi)
                + clocked(phase_observability, smi) + clocked(phase_placement, smi)
                + clocked(phase_workflows, smi)}
    trained = clocked(phase_train)
    launches.update({name: trained[name] for name in BWD_VARIANTS})
    sp_launches = clocked(phase_sequence_parallel)
    launches.update({name: sp_launches[name] for name in ("flash_ring", "flash_ring_bwd")})
    clocked(phase_sharded)
    timed = clocked(phase_times)
    clocked(phase_profile)
    benched = clocked(phase_bench, smi)
    for name in ("flash_fwd", "flash_bwd_delta"):
        launches[name] += benched[name]
    emit({"phase": "clock", "seconds_by_phase": seconds,
          "seconds": time.monotonic() - started})
    sources = {"flash_fwd": ("tasksrunner_torch/csrc/flash_fwd.cu",
                             "tasksrunner/ml/flash.py:130"),
               "flash_bwd_delta": ("tasksrunner_torch/csrc/flash_bwd.cu",
                                   "tasksrunner/ml/flash.py:189"),
               "flash_bwd_fused": ("tasksrunner_torch/csrc/flash_bwd.cu",
                                   "tasksrunner/ml/flash.py:168"),
               "flash_ring": ("tasksrunner_torch/csrc/flash_ring.cu",
                              "tasksrunner/ml/flash.py:297"),
               "flash_ring_bwd": ("tasksrunner_torch/csrc/flash_bwd.cu",
                                  "tasksrunner/ml/ring.py:70")}
    print(smi, flush=True)
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": worst_err[name],
        **{key: timed[name][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "shape", "dtype")}}
        for name, (source, replaces) in sources.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
