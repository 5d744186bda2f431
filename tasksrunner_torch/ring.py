"""Ring attention: the port of ``tasksrunner/ml/ring.py``, bidirectional
attention with the sequence split over the ``sp`` ranks of a
:class:`~tasksrunner_torch.mesh.Mesh`.

Each rank holds one sequence block of q, k and v. K and V visit every
rank in turn (rank i's block reaches rank i + j at step j), and at each
step every rank folds the visiting block into the running softmax state
(max m, numerator num, denominator den) of its own queries.

With ``TASKSRUNNER_FLASH`` on (the default) the whole ring is one
autograd node, :class:`RingAttention`: its forward runs the steps with
``flash.ring_block_update`` (the kernel of ``csrc/flash_ring.cu`` on the
card) and keeps only q, k, v, the context and its log-sum-exp; its
backward is a second pass over the ring with ``flash.ring_block_grad``
(the ring variant of ``csrc/flash_bwd.cu``), FlashAttention-2's backward
for one visiting block at a time. With ``TASKSRUNNER_FLASH=0`` the ring
runs the plain update step by step and autograd differentiates it, as
the JAX ring differentiates its einsum update. :class:`RingBlockUpdate`
is the one-step counterpart of the JAX custom VJP (kernel forward, plain
update's gradient).

With ``Mesh(sp=n)`` (one process) the n blocks are folded into the batch,
[b, s, h, d] → [b·n, s/n, h, d] (a view). Under :class:`RingAttention`
the kernels read the visiting block of step j in place, from row
bi·n + (r − j) mod n of the fold, and nothing rotates; the plain ring
rotates with ``torch.roll``. With a mesh over a process group a rotation
is a ``dist.batch_isend_irecv`` between neighbouring ranks of its
``sp_group``; in the backward, K, V and their gradient accumulators
travel the ring together and the accumulators end at their home rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tasksrunner_torch import flash
from tasksrunner_torch.mesh import Mesh, through_host

#: the plain block update (ring.py:31-49): one function, kept in flash.py
#: beside the kernel it is the plain version of
_block_update = flash.ring_block_update_reference


class RingBlockUpdate(torch.autograd.Function):
    """The block update with the kernel forward and the plain update's
    gradient (ring.py:52-76): the backward recomputes the step with the
    plain update from the saved inputs and returns the
    gradients for (q, k_blk, v_blk, m, num, den), None where an input
    needs none (the ring's −inf initial m)."""

    @staticmethod
    def forward(ctx, q, k_blk, v_blk, m, num, den, scale):
        ctx.save_for_backward(q, k_blk, v_blk, m, num, den)
        ctx.scale = scale
        return flash.ring_block_update(q, k_blk, v_blk, m, num, den, scale=scale)

    @staticmethod
    def backward(ctx, dm, dnum, dden):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(need)
                      for x, need in zip(ctx.saved_tensors, needs)]
            outs = flash.ring_block_update_reference(*leaves, scale=ctx.scale)
            pairs = [(o, g) for o, g in zip(outs, (dm, dnum, dden)) if o.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], [x for x, need in zip(leaves, needs) if need],
                [g for _, g in pairs]))
        return (*(next(grads) if need else None for need in needs), None)


def _send_recv(group, tensors, shift: int) -> list[torch.Tensor]:
    """Each tensor sent ``shift`` ranks forward in ``group`` and its
    counterpart received from ``shift`` ranks back, on its device (by way
    of the host where :func:`~tasksrunner_torch.mesh.through_host` says)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (rank + shift) % n)
    src = dist.get_global_rank(group, (rank - shift) % n)
    wire = [x.to("cpu" if through_host(x, group) else x.device).contiguous()
            for x in tensors]
    received = [torch.empty_like(x) for x in wire]
    ops = ([dist.P2POp(dist.isend, x, dst, group) for x in wire]
           + [dist.P2POp(dist.irecv, y, src, group) for y in received])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [y.to(x.device) for y, x in zip(received, tensors)]


class _RotateP2P(torch.autograd.Function):
    """K and V one rank forward (``ppermute`` with perm i → i + 1); the
    gradient goes one rank back, the transpose of that permutation."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return tuple(_send_recv(group, (k, v), 1))

    @staticmethod
    def backward(ctx, dk, dv):
        return (None, *_send_recv(ctx.group, (dk, dv), -1))


def _rotate(k: torch.Tensor, v: torch.Tensor,
            mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V one sp rank forward: between processes with a group, else
    along the n axis of the folded batch [b·n, ...] (rank r ← rank r − 1),
    which only the plain ring does."""
    if mesh.group is not None:
        return _RotateP2P.apply(mesh.sp_group, k, v)

    def roll(x):
        return torch.roll(x.reshape(-1, mesh.sp, *x.shape[1:]), 1, dims=1).reshape(x.shape)

    return roll(k), roll(v)


def _initial_state(q: torch.Tensor):
    b, sq, h, d = q.shape
    return (torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, sq), dtype=torch.float32, device=q.device))


def _ring_per_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh: Mesh,
                   scale: float) -> torch.Tensor:
    """The per-rank body (ring.py:79-109) step by step over q/k/v
    [b, s_block, h, d], with :func:`_block_update` folding each visiting
    block and autograd differentiating every step: the context block
    [b, s_block, h, d] in f32."""
    m, num, den = _initial_state(q)
    for step in range(mesh.sp):
        m, num, den = _block_update(q, k, v, m, num, den, scale=scale)
        if step < mesh.sp - 1:  # the last rotation would only bring K/V home
            k, v = _rotate(k, v, mesh)
    return (num / den[..., None]).transpose(1, 2)


class RingAttention(torch.autograd.Function):
    """The whole ring as one differentiable op over the kernels.

    Forward: the sp steps of ``flash.ring_block_update`` without autograd;
    it keeps q, k, v, the context O = num/den and LSE = m + log den
    [b, h, s_block] f32, and no per-step state. Backward: with Δ =
    rowsum(dO∘O), the block visiting at step j adds its share of dQ, dK,
    dV (``flash.ring_block_grad``) into f32 accumulators, cast once at the
    end. In one process both passes read the visiting block in place of
    the fold; over a group K and V rotate, and in the backward their dK
    and dV accumulators travel with them and take one more step home."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, scale):
        n = mesh.sp
        m, num, den = _initial_state(q)
        k_blk, v_blk = k, v
        for step in range(n):
            if mesh.group is None:
                m, num, den = flash.ring_block_update(q, k, v, m, num, den, scale=scale,
                                                      shift=step, sp=n)
            else:
                m, num, den = flash.ring_block_update(q, k_blk, v_blk, m, num, den,
                                                      scale=scale)
                if step < n - 1:  # the last rotation would only bring K/V home
                    k_blk, v_blk = _rotate(k_blk, v_blk, mesh)
        out = (num / den[..., None]).transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, m + torch.log(den))
        ctx.mesh, ctx.scale = mesh, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, n = ctx.mesh, ctx.mesh.sp
        delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = (torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                      for x in (q, k, v))
        k_blk, v_blk = k, v
        for step in range(n):
            if mesh.group is None:
                flash.ring_block_grad(q, k, v, dout, lse, delta, dq, dk, dv,
                                      scale=ctx.scale, shift=step, sp=n)
                continue
            flash.ring_block_grad(q, k_blk, v_blk, dout, lse, delta, dq, dk, dv,
                                  scale=ctx.scale)
            if step < n - 1:
                k_blk, v_blk, dk, dv = _send_recv(mesh.sp_group, (k_blk, v_blk, dk, dv), 1)
            elif n > 1:  # the accumulators of rank r + 1's block, one step home
                dk, dv = _send_recv(mesh.sp_group, (dk, dv), 1)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          mesh: Mesh, scale: float) -> torch.Tensor:
    """The per-rank body over q/k/v [b, s_block, h, d] (the one-process
    fold or a group rank's shard): the context block [b, s_block, h, d]
    in f32."""
    if flash.use_flash():
        return RingAttention.apply(q, k, v, mesh, scale)
    return _ring_per_step(q, k, v, mesh=mesh, scale=scale)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh, scale: float | None = None) -> torch.Tensor:
    """Bidirectional ring attention over ``mesh``'s sp axis, in f32.

    With ``mesh.group`` None, q/k/v are the global [b, s, h, d] tensors
    and the result is the global context [b, s, h, d]; sp must divide s.
    With a group, they are this rank's [b, s/sp, h, d] shard and so is
    the result. ``scale`` defaults to 1/√d_head."""
    scale = float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5
    if mesh.group is not None:
        return _ring_attention_local(q, k, v, mesh=mesh, scale=scale)
    b, s, h, d = q.shape
    block = mesh.block(s)

    def fold(x):  # [b, s, h, d] → [b·sp, s/sp, h, d]; row bi·sp + r is rank r's
        return x.reshape(b * mesh.sp, block, h, d)

    ctx = _ring_attention_local(fold(q), fold(k), fold(v), mesh=mesh, scale=scale)
    return ctx.reshape(b, s, h, d)
