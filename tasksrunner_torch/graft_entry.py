"""Harness entry: the port of ``__graft_entry__.py``'s ``entry``,
``dryrun_multichip`` and ``_dryrun_factored``.

The dryrun runs one train step of the model sharded dp × sp × tp over n
ranks, one process each, and holds it against the same step on one
device, as the reference does (__graft_entry__.py:128-158): both losses
finite, the losses within 1e-2, every updated leaf finite and within
2e-2. Where the JAX dryrun places its mesh on n virtual CPU devices, the
port spawns n processes, one per entry of ``devices``: over NCCL when
those are n distinct cards, over gloo otherwise (CPU ranks, or several
ranks sharing one card, whose collectives then go through the host).

:func:`sharded_step_rank` is one rank's part, over a mesh it is given;
:func:`sharded_step` spawns the ranks, runs the single-device reference
and checks each rank against it (:func:`verify_step`).
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import multiprocessing.connection
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from tasksrunner_torch import flash
from tasksrunner_torch.device import resolve_device
from tasksrunner_torch.mesh import Mesh
from tasksrunner_torch.model import (
    ModelConfig,
    _leaves,
    forward,
    gather_params,
    init_params,
    make_train_step,
    shard_params,
)

#: the reference dryrun's model (__graft_entry__.py:87-88)
DRYRUN_CONFIG = ModelConfig(vocab=512, seq_len=16, d_model=64, n_heads=4, d_ff=128,
                            n_layers=2)
LOSS_TOL, LEAF_TOL = 1e-2, 2e-2
#: each leaf's update against the single-device step's, in units of that
#: step's largest update of the leaf: bf16 activations round each product
#: to 2^-8, and a gradient summed once too often or too rarely is off by
#: a whole factor
UPDATE_TOL = 5e-2
#: the reference step's SGD rate (make_train_step's default)
LEARNING_RATE = 1e-3
#: seconds a rank waits in one collective before it fails, and that all
#: the ranks of a dryrun get, start to finish
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 600


def entry(device: str | torch.device | None = None) -> tuple[Callable, tuple[Any, ...]]:
    """Return ``(fn, example_args)``: the single-device forward at the
    default :class:`ModelConfig` on a batch of 8, on ``device``
    (``cuda:0`` by default)."""
    dev = resolve_device(device)
    cfg = ModelConfig()
    params = init_params(cfg, 0, dev)
    tokens = torch.zeros((8, cfg.seq_len), dtype=torch.int32, device=dev)

    def fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return forward(params, tokens, cfg=cfg)

    return fn, (params, tokens)


def default_factorization(n_devices: int, cfg: ModelConfig = DRYRUN_CONFIG
                          ) -> tuple[int, int, int]:
    """(dp, sp, tp) for ``n_devices`` (__graft_entry__.py:49-56): tp 2 where
    it divides the devices and the heads, then sp 2 where it divides the
    rest and the sequence, and the rest data parallel."""
    tp = 2 if n_devices % 2 == 0 and cfg.n_heads % 2 == 0 else 1
    rem = n_devices // tp
    sp = 2 if rem % 2 == 0 and cfg.seq_len % 2 == 0 else 1
    return rem // sp, sp, tp


def dryrun_inputs(cfg: ModelConfig, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """Tokens [batch, seq] in [1, vocab) and labels [batch] in
    [0, n_classes), int32, from seed 7: not all zeros, so that a wrong
    split of the embedding or of the batch shows."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg.vocab, (batch, cfg.seq_len), dtype=np.int32)
    labels = rng.integers(0, cfg.n_classes, (batch,), dtype=np.int32)
    return tokens, labels


def sharded_step_rank(mesh: Mesh, cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                      labels: torch.Tensor) -> dict[str, Any]:
    """One rank's part of the sharded step over ``mesh``, from the whole
    tree ``params`` and the whole batch, all on this rank's device:
    shards the params, runs one step, gathers the updated tree over tp
    and checks that every rank of the mesh holds the same one bit for bit
    (a replicated leaf updated differently on two ranks fails here).
    Returns the step's ``loss``, the updated whole tree (``params``), and
    the kernel launch counts (``launches``, set to 0 just before the step
    and read just after) and wall time (``step_s``) of the step, which
    follows one untimed step on a throwaway copy of the shards (a
    process's first step also creates its library handles and
    communicators)."""
    local = shard_params(params, mesh)
    step = make_train_step(cfg, mesh, learning_rate=LEARNING_RATE)
    step(shard_params(params, mesh), tokens, labels)
    _sync(tokens.device)
    dist.barrier(group=mesh.group)
    flash.reset_launch_counts()
    started = time.perf_counter()
    local, loss = step(local, tokens, labels)
    _sync(tokens.device)
    step_s = time.perf_counter() - started
    launches = flash.launch_counts()
    gathered = gather_params(local, mesh)
    _check_same_on_every_rank(gathered, mesh)
    return {"loss": float(loss), "params": gathered, "launches": launches,
            "step_s": step_s}


def _check_same_on_every_rank(tree: dict, mesh: Mesh) -> None:
    """AssertionError unless every rank of ``mesh`` holds ``tree`` bit for
    bit: each leaf is compared with group rank 0's."""
    flat = torch.cat([x.reshape(-1) for x in _leaves(tree)])
    wire = flat.clone()
    dist.broadcast(wire, group_src=0, group=mesh.group)
    if not torch.equal(wire, flat):
        raise AssertionError(f"rank {mesh.coords} of the mesh holds another updated "
                             "tree than rank (0, 0, 0): a replicated leaf or a shard "
                             "was updated differently")


def verify_step(loss: float, params: dict, ref_loss: float, ref_params: dict,
                start: dict | None = None) -> float:
    """The reference dryrun's checks, in its order and with its messages
    (__graft_entry__.py:128-158): both losses finite, the losses within
    1e-2, every leaf of both trees finite and within 2e-2. Returns the
    largest leaf error.

    Given the tree ``start`` both steps began from, each leaf's update is
    then held to the reference's within :data:`UPDATE_TOL` of its largest
    update: at lr 1e-3 the 2e-2 leaf check cannot see a gradient off by a
    factor of two, which a collective wrong only in its backward gives."""
    if not np.isfinite(loss):
        raise AssertionError(f"sharded loss is not finite: {loss}")
    if not np.isfinite(ref_loss):
        raise AssertionError(f"single-device reference loss is not finite: {ref_loss}")
    if abs(loss - ref_loss) > LOSS_TOL:
        raise AssertionError(f"sharded loss {loss:.6f} diverges from single-device "
                             f"{ref_loss:.6f} — sharding layout is wrong")
    worst = 0.0
    for s, r in zip(_leaves(params), _leaves(ref_params)):
        if not bool(torch.isfinite(s).all()):
            raise AssertionError("non-finite updated parameter leaf (sharded)")
        if not bool(torch.isfinite(r).all()):
            raise AssertionError("non-finite updated parameter leaf (reference)")
        err = (s.float() - r.to(s.device).float()).abs().max().item()
        if err > LEAF_TOL:
            raise AssertionError(f"updated params diverge from single-device step "
                                 f"(max abs err {err:.4g}) — gradient sharding is wrong")
        worst = max(worst, err)
    for s, r, p in zip(_leaves(params), _leaves(ref_params),
                       _leaves(start) if start is not None else []):
        p = p.to(s.device).float()
        moved, ref_moved = p - s.float(), p - r.to(s.device).float()
        err = (moved - ref_moved).abs().max().item()
        # plus the f32 rounding of both updated leaves, a few ulps of the leaf
        tol = (UPDATE_TOL * ref_moved.abs().max().item()
               + 4 * torch.finfo(torch.float32).eps * p.abs().max().item())
        if err > tol:
            raise AssertionError(f"updated params diverge from single-device step: an "
                                 f"update is off by {err:.4g} of at most "
                                 f"{ref_moved.abs().max().item():.4g} — gradient "
                                 "sharding is wrong")
    return worst


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_main(rank: int, spec: dict, out_dir: str) -> None:
    """One spawned rank of :func:`sharded_step`: writes its report, or
    its traceback, to ``out_dir``."""
    out = Path(out_dir)
    try:
        device = torch.device(spec["devices"][rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(spec["backend"], init_method=f"file://{out}/rendezvous",
                                rank=rank, world_size=len(spec["devices"]),
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
                                device_id=device if spec["backend"] == "nccl" else None)
        try:
            report = _rank_step(rank, spec, device, out)
        finally:
            dist.destroy_process_group()
        (out / f"rank{rank}.json").write_text(json.dumps(report))
    except BaseException as exc:
        (out / f"rank{rank}.error").write_text(
            f"{type(exc).__name__}\n{exc}\n{traceback.format_exc()}")
        raise


def _rank_step(rank: int, spec: dict, device: torch.device, out: Path) -> dict:
    mesh = Mesh(spec["dp"], spec["sp"], spec["tp"], group=dist.group.WORLD)
    tokens, labels = (torch.from_numpy(x).to(device) for x in spec["inputs"])
    start = init_params(spec["cfg"], 0, device)
    result = sharded_step_rank(mesh, spec["cfg"], start, tokens, labels)
    reference = torch.load(out / "reference.pt", map_location=device, weights_only=True)
    worst = verify_step(result["loss"], result["params"], reference["loss"],
                        reference["params"], start)
    return {"rank": rank, "coords": mesh.coords, "loss": result["loss"],
            "reference_loss": reference["loss"], "max_abs_err_leaves": worst,
            "launches": result["launches"], "step_s": result["step_s"]}


def _devices(n: int, devices: list | None) -> list[torch.device]:
    """The n devices of the ranks: ``devices``, or cuda:0 … cuda:n-1;
    RuntimeError ("need") when there are fewer."""
    if devices is None:
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"need {n} CUDA devices, have {have} (pass devices=, "
                               f"which may repeat one device, e.g. ['cpu'] * {n})")
        devices = [f"cuda:{i}" for i in range(n)]
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices, have {len(devices)}")
    return [resolve_device(d) for d in devices[:n]]


def _join(procs: list, out: Path) -> None:
    """Waits for every rank until JOIN_TIMEOUT_S; at the first rank that
    fails, or at the deadline, kills the rest and raises: the rank's own
    AssertionError message where it has one, else RuntimeError."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.is_alive()],
                timeout=max(0.0, min(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errors = sorted(out.glob("rank*.error"))
    if errors:
        kind, message, *rest = errors[0].read_text().split("\n")
        if kind == "AssertionError":
            raise AssertionError(f"{errors[0].stem}: {message}")
        raise RuntimeError(f"{errors[0].stem} failed: {kind}: {message}\n" + "\n".join(rest))
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise RuntimeError(f"ranks did not finish within {JOIN_TIMEOUT_S} s or died "
                           f"without a report (exit codes {bad})")


def sharded_step(cfg: ModelConfig, n_devices: int, *, dp: int, sp: int, tp: int,
                 devices: list | None = None, batch: int | None = None) -> list[dict]:
    """One train step of ``cfg`` at lr 1e-3 sharded dp × sp × tp over
    ``n_devices`` spawned ranks, held against the same step on the first
    device from the same params (``init_params(cfg, 0)``) and inputs
    (:func:`dryrun_inputs`, ``batch`` rows, max(2·dp, 4) by default).
    Every refusal comes before any process starts. Returns every rank's
    report: its mesh coordinates, loss, largest leaf error, kernel launch
    counts over the step, and the step's wall time."""
    devs = _devices(n_devices, devices)
    if dp * sp * tp != n_devices:
        raise ValueError(f"{dp}x{sp}x{tp} != {n_devices} devices")
    if cfg.n_heads % tp or cfg.seq_len % sp:
        raise ValueError(f"tp={tp} must divide n_heads={cfg.n_heads} and sp={sp} "
                         f"must divide seq_len={cfg.seq_len}")
    inputs = dryrun_inputs(cfg, batch or max(2 * dp, 4))
    distinct_cards = all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs)
    spec = {"cfg": cfg, "dp": dp, "sp": sp, "tp": tp, "inputs": inputs,
            "devices": [str(d) for d in devs],
            "backend": "nccl" if distinct_cards else "gloo"}
    with tempfile.TemporaryDirectory(prefix="tasksrunner-dryrun-") as tmp:
        out = Path(tmp)
        _reference_step(cfg, spec, devs[0], out)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, spec, tmp), daemon=True)
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        _join(procs, out)
        return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n_devices)]


def _reference_step(cfg: ModelConfig, spec: dict, device: torch.device, out: Path) -> None:
    """The single-device step on ``device``, saved for the ranks; the
    device's cached memory is given back before they start."""
    tokens, labels = (torch.from_numpy(x).to(device) for x in spec["inputs"])
    params, loss = make_train_step(cfg, learning_rate=LEARNING_RATE)(
        init_params(cfg, 0, device), tokens, labels)
    torch.save({"loss": float(loss), "params": params}, out / "reference.pt")
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _dryrun_factored(n_devices: int, *, dp: int, sp: int, tp: int,
                     devices: list | None = None) -> list[dict]:
    """The dryrun with an explicit dp×sp×tp factorization
    (__graft_entry__.py:59-158) at the reference's config."""
    reports = sharded_step(DRYRUN_CONFIG, n_devices, dp=dp, sp=sp, tp=tp, devices=devices)
    print(f"dryrun_multichip: mesh=({dp}dp x {sp}sp x {tp}tp), "
          f"sharded loss={reports[0]['loss']:.6f}, "
          f"worst leaf error={max(r['max_abs_err_leaves'] for r in reports):.3g}")
    print("dryrun_multichip ok: sharded step matches single-device on every rank")
    return reports


def dryrun_multichip(n_devices: int, devices: list | None = None) -> list[dict]:
    """One self-verifying train step sharded over ``n_devices`` ranks at
    the reference's default factorization (__graft_entry__.py:33-56). It
    fails when the sharded step diverges from the single-device one."""
    dp, sp, tp = default_factorization(n_devices)
    return _dryrun_factored(n_devices, dp=dp, sp=sp, tp=tp, devices=devices)
