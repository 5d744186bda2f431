"""Ring attention: the port of ``tasksrunner/ml/ring.py``, bidirectional
attention with the sequence split over the ``sp`` ranks of a
:class:`~tasksrunner_torch.mesh.Mesh`.

Each rank holds one sequence block of q, k and v. K and V rotate one
rank forward n times (rank i sends to i + 1), and at each step every
rank folds the block it holds into the running softmax state (max m,
numerator num, denominator den) of its own queries. The fold is
:class:`RingBlockUpdate`: its forward is ``flash.ring_block_update``,
the kernel of ``csrc/flash_ring.cu`` on the card; its backward
differentiates the plain update, as the JAX custom VJP does. With
``TASKSRUNNER_FLASH`` off the ring runs the plain update throughout.

With ``Mesh(sp=n)`` (one process) the n blocks are folded into the batch,
[b, s, h, d] → [b·n, s/n, h, d] (a view), and a rotation is a
``torch.roll`` along the n axis: one kernel launch per step covers every
rank's block. With ``Mesh(sp=n, group=g)`` a rotation is a
``dist.batch_isend_irecv`` between neighbouring processes, whose
backward sends the gradient one rank back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tasksrunner_torch import flash
from tasksrunner_torch.mesh import Mesh

#: the plain block update (ring.py:31-49): one function, kept in flash.py
#: beside the kernel it is the plain version of
_block_update = flash.ring_block_update_reference


class RingBlockUpdate(torch.autograd.Function):
    """The block update with the kernel forward and the plain update's
    gradient (ring.py:52-76): the backward recomputes the step with
    :func:`_block_update` from the saved inputs and returns the
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
            outs = _block_update(*leaves, scale=ctx.scale)
            pairs = [(o, g) for o, g in zip(outs, (dm, dnum, dden)) if o.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], [x for x, need in zip(leaves, needs) if need],
                [g for _, g in pairs]))
        return (*(next(grads) if need else None for need in needs), None)


def _send_recv(group, tensors, shift: int) -> list[torch.Tensor]:
    """Each tensor sent ``shift`` ranks forward in ``group`` and its
    counterpart received from ``shift`` ranks back."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (rank + shift) % n)
    src = dist.get_global_rank(group, (rank - shift) % n)
    tensors = [x.contiguous() for x in tensors]
    received = [torch.empty_like(x) for x in tensors]
    ops = ([dist.P2POp(dist.isend, x, dst, group) for x in tensors]
           + [dist.P2POp(dist.irecv, y, src, group) for y in received])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return received


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
    along the n axis of the folded batch [b·n, ...] (rank r ← rank r − 1)."""
    if mesh.group is not None:
        return _RotateP2P.apply(mesh.group, k, v)

    def roll(x):
        return torch.roll(x.reshape(-1, mesh.sp, *x.shape[1:]), 1, dims=1).reshape(x.shape)

    return roll(k), roll(v)


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          mesh: Mesh, scale: float) -> torch.Tensor:
    """The per-rank body (ring.py:79-109) over q/k/v [b, s_block, h, d]:
    the context block [b, s_block, h, d] in f32."""
    n = mesh.sp
    b, sq, h, d = q.shape
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=q.device)
    num = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    fast = flash.use_flash()
    for step in range(n):
        if fast:
            m, num, den = RingBlockUpdate.apply(q, k, v, m, num, den, scale)
        else:
            m, num, den = _block_update(q, k, v, m, num, den, scale=scale)
        if step < n - 1:  # the last rotation would only bring K/V home
            k, v = _rotate(k, v, mesh)
    return (num / den[..., None]).transpose(1, 2)


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
