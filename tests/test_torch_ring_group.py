"""Ring attention over a process group: ``ring.ring_attention`` with
``Mesh(sp=4, group=...)`` on four gloo CPU processes, each holding one
sequence block, against the port's dense einsum core over the whole
sequence; and the model over that group against its single-device
forward. This module imports no JAX: it is also what each spawned
process imports to find its worker."""

import datetime
import json
import multiprocessing

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tasksrunner_torch import model, ring
from tasksrunner_torch.mesh import Mesh

RANKS = 4
SHAPE = (2, 16, 4, 16)  # b, s, h, d
JOIN_S = 120  # the whole group, start to finish, on a loaded machine
TOL = 2e-2  # test_ml_extension.py:155, ring against dense
GRAD_TOL = 1e-2


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _worker(rank: int, rendezvous: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=rendezvous, rank=rank,
                            world_size=RANKS, timeout=datetime.timedelta(seconds=60))
    try:
        rng = np.random.default_rng(21)
        q, k, v = (torch.from_numpy(rng.standard_normal(SHAPE, np.float32))
                   for _ in range(3))
        whole = [x.clone().requires_grad_() for x in (q, k, v)]
        dense = model._einsum_attention(*whole)
        dense_grads = torch.autograd.grad(dense.sin().sum(), whole)
        folded = ring.ring_attention(*whole, mesh=Mesh(sp=RANKS))
        folded_grads = torch.autograd.grad(folded.sin().sum(), whole)

        mesh = Mesh(sp=RANKS, group=dist.group.WORLD)
        rows = slice(rank * SHAPE[1] // RANKS, (rank + 1) * SHAPE[1] // RANKS)
        local = [x[:, rows].clone().requires_grad_() for x in (q, k, v)]
        out = ring.ring_attention(*local, mesh=mesh)
        # each rank's loss is its own block's; the rotation's backward brings
        # the other ranks' gradients of this rank's K/V home
        grads = torch.autograd.grad(out.sin().sum(), local)

        # the sabotaged ring: every rank skips its first rotation
        real, calls = ring._rotate, []

        def dropped(k_blk, v_blk, mesh):
            calls.append(None)
            return (k_blk, v_blk) if len(calls) == 1 else real(k_blk, v_blk, mesh)

        ring._rotate = dropped
        try:
            broken = ring.ring_attention(*(x.detach() for x in local), mesh=mesh)
        finally:
            ring._rotate = real

        # the model over the group: each rank its sequence block, the pool
        # summed over the ranks, the logits replicated
        cfg = model.ModelConfig(vocab=64, seq_len=SHAPE[1], d_model=32, n_heads=2,
                                d_ff=32, n_layers=1)
        params = model.init_params(cfg, 5, "cpu")
        tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (4, cfg.seq_len)))
        logits = model.forward(model.shard_params(params, mesh), tokens, cfg=cfg, mesh=mesh)
        want_logits = model.forward(params, tokens, cfg=cfg)

        want = dense.detach()[:, rows]
        result = {
            "logits_shape": list(logits.shape),
            "logits_err": (logits - want_logits).abs().max().item(),
            "logits_ok": _close(logits, want_logits, TOL),
            "shape": list(out.shape), "dtype": str(out.dtype),
            "out_err": (out.detach() - want).abs().max().item(),
            "out_ok": _close(out.detach(), want, TOL),
            "grad_err": [(g - w[:, rows]).abs().max().item()
                         for g, w in zip(grads, dense_grads)],
            "grad_ok": [_close(g, w[:, rows], GRAD_TOL) for g, w in zip(grads, dense_grads)],
            "dropped_err": (broken - want).abs().max().item(),
            "one_process_err": [(a - b[:, rows]).abs().max().item() for a, b in zip(
                (out.detach(), *grads), (folded.detach(), *folded_grads))],
        }
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's result, from one 4-process gloo group with a file
    rendezvous (no TCP port, so parallel test workers do not collide)."""
    tmp = tmp_path_factory.mktemp("ring_group")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, f"file://{tmp}/rendezvous", str(tmp)))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    try:
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
        for p in procs:
            p.join(timeout=max(0.0, (deadline - datetime.datetime.now()).total_seconds()))
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not hung, f"ranks still running after {JOIN_S} s: pids {hung}"
    assert [p.exitcode for p in procs] == [0] * RANKS
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(RANKS)]


def test_ring_over_a_process_group_matches_dense(ranks):
    for r, res in enumerate(ranks):
        assert res["shape"] == [SHAPE[0], SHAPE[1] // RANKS, *SHAPE[2:]]
        assert res["dtype"] == "torch.float32"
        assert res["out_ok"], (r, res["out_err"])


def test_ring_gradients_over_a_process_group_match_dense(ranks):
    for r, res in enumerate(ranks):
        assert all(res["grad_ok"]), (r, res["grad_err"])


def test_a_ring_with_one_rotation_dropped_disagrees(ranks):
    """The counterpart of test_ml_extension.py:106-126: a ring that misses
    a block must not pass for attention."""
    assert all(res["dropped_err"] > TOL for res in ranks), [r["dropped_err"] for r in ranks]


def test_the_process_group_ring_equals_the_one_process_ring(ranks):
    """The same blocks in the same order: each rank's output and q, k, v
    gradients equal those of Mesh(sp=4) in one process, sliced to its
    block (bit for bit on the CPU; 1e-6 leaves room for summation order)."""
    for r, res in enumerate(ranks):
        assert max(res["one_process_err"]) <= 1e-6, (r, res["one_process_err"])


def test_the_model_over_a_process_group_matches_the_single_device_forward(ranks):
    """The model with this group as its sp axis (each rank its sequence
    block, the ring over the processes, the mean pool summed over them):
    every rank's logits equal the single-device forward's within the
    tolerance of the ring against dense attention."""
    for r, res in enumerate(ranks):
        assert res["logits_shape"] == [4, 5]
        assert res["logits_ok"], (r, res["logits_err"])
