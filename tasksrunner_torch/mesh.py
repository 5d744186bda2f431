"""The port's stand-in for the JAX ``Mesh(devices.reshape(dp, sp, tp),
("dp", "sp", "tp"))`` that ``tasksrunner/ml/model.py`` and
``__graft_entry__.py`` take, and the collectives the sharded model runs
over it.

A mesh has two placements:

* ``Mesh(sp=n)``: n sequence ranks in one process on one device. Ring
  attention (:mod:`tasksrunner_torch.ring`) takes the global [b, s, h, d]
  tensors, as the JAX ``ring_attention`` takes global arrays, and folds
  the n sequence blocks into the batch. Without a group only sp may
  exceed 1.
* ``Mesh(dp, sp, tp, group=g)``: one rank per process of the
  ``torch.distributed`` group ``g`` of dp·sp·tp ranks. Group rank r sits
  at (i_dp, i_sp, i_tp) with r = (i_dp·sp + i_sp)·tp + i_tp, the layout
  of ``np.array(devices).reshape(dp, sp, tp)``. The mesh builds one
  subgroup per axis with ``dist.new_group`` (``dp_group``, ``sp_group``,
  ``tp_group``), all of them, in the same order on every rank. Like
  ``dist.new_group``, that is collective over the whole job: every rank
  of the default group builds the mesh, or, where ``g`` is not the whole
  job, calls :meth:`Mesh.over` with the same ranks.

Collectives and their gradients. One convention, which the sharded model
in :mod:`tasksrunner_torch.model` follows at every use:

* a forward collective whose output is replicated over its group (the
  tp sum after wo and w2, the sp sum of the mean pool) has an identity
  backward: :meth:`Mesh.reduce`;
* a replicated tensor that enters rank-local partial work takes a sum
  over the group in its backward and is the identity forward:
  :meth:`Mesh.enter`. That is the layernorm output going into the
  column-split q/k/v and w1 products (over tp), and every parameter
  that works on this rank's sequence block (over sp). The head works on
  the pool, which is already replicated over sp, and does not enter;
* the tp all-gather after the embedding (:meth:`Mesh.gather`) has for
  backward this rank's slice of its output's gradient, which the rules
  above leave summed and replicated over tp;
* after that, the train step averages gradients over dp only.

Each collective takes its tensors where they lie. Gloo, which the port
uses for CPU ranks and for several ranks sharing one card, copies a CUDA
tensor to the host itself in ``all_reduce``, ``broadcast`` and
``all_gather``; its ``batch_isend_irecv`` refuses one (PyTorch 2.11 on an
H100). So the ring's exchange (``ring._send_recv``), the one point-to-point
operation, goes through an explicit copy to the host and back over gloo,
chosen by the group's backend (:func:`through_host`). NCCL, which the
port picks only when every rank has a card of its own, takes every
tensor in place. Sums run in f32 and come back in the input's dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "sp", "tp")


def through_host(x: torch.Tensor, group: dist.ProcessGroup) -> bool:
    """Whether a point-to-point exchange over ``group`` takes ``x`` by a
    copy to the host: a CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group``, summed in f32, as a new tensor in
    ``x``'s dtype on its device."""
    wire = x.detach().to(torch.float32, copy=True)
    dist.all_reduce(wire, group=group)
    return wire.to(x.dtype)


def all_gather(x: torch.Tensor, group: dist.ProcessGroup, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in group
    rank order, on ``x``'s device."""
    wire = x.detach().contiguous()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=dim)


class _Reduce(torch.autograd.Function):
    """Sum over the group forward; identity backward (the sum is
    replicated over the group, and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Enter(torch.autograd.Function):
    """Identity forward; sum over the group backward (each rank's partial
    work gives a share of the replicated input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along the last dim forward; this rank's slice of the
    (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.width = x.shape[-1]
        ctx.rank = dist.get_rank(group)
        return all_gather(x, group, -1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.rank * ctx.width, ctx.width), None


def _new_axis_groups(ranks: list[int], dp: int, sp: int,
                     tp: int) -> dict[str, dist.ProcessGroup | None]:
    """Every subgroup of the mesh over the job ranks ``ranks`` (in group
    rank order), axis by axis in the order dp, sp, tp, each line of the
    grid in row-major order: the caller's own group of each axis, None
    for a rank outside ``ranks``. Every rank of the job calls this with
    the same arguments."""
    grid = np.asarray(ranks).reshape(dp, sp, tp)
    me = dist.get_rank()
    own: dict[str, dist.ProcessGroup | None] = dict.fromkeys(AXES)
    for axis, size in enumerate((dp, sp, tp)):
        for line in np.moveaxis(grid, axis, -1).reshape(-1, size).tolist():
            group = dist.new_group(line)
            if me in line:
                own[AXES[axis]] = group
    return own


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int = 1
    sp: int = 1
    tp: int = 1
    group: dist.ProcessGroup | None = None
    #: this rank's (i_dp, i_sp, i_tp); (0, 0, 0) without a group
    coords: tuple[int, int, int] = dataclasses.field(init=False, compare=False)
    dp_group: dist.ProcessGroup | None = dataclasses.field(init=False, compare=False)
    sp_group: dist.ProcessGroup | None = dataclasses.field(init=False, compare=False)
    tp_group: dist.ProcessGroup | None = dataclasses.field(init=False, compare=False)

    def __post_init__(self) -> None:
        for axis in AXES:
            if self.size(axis) < 1:
                raise ValueError(f"{axis} must be at least 1, got {self.size(axis)}")
        n = self.dp * self.sp * self.tp
        axes: dict[str, dist.ProcessGroup | None] = dict.fromkeys(AXES)
        coords = (0, 0, 0)
        if self.group is None:
            if self.dp > 1 or self.tp > 1:
                raise ValueError("a mesh without a process group runs in one process: "
                                 f"only sp may exceed 1, got dp={self.dp}, tp={self.tp}")
        else:
            if dist.get_world_size(self.group) != n:
                raise ValueError(f"dp·sp·tp = {self.dp}·{self.sp}·{self.tp} = {n} but "
                                 f"the process group has "
                                 f"{dist.get_world_size(self.group)} ranks")
            rank = dist.get_rank(self.group)
            coords = (rank // (self.sp * self.tp), rank // self.tp % self.sp, rank % self.tp)
            axes = _new_axis_groups(dist.get_process_group_ranks(self.group),
                                    self.dp, self.sp, self.tp)
        object.__setattr__(self, "coords", coords)
        for axis in AXES:
            object.__setattr__(self, f"{axis}_group", axes[axis])

    @classmethod
    def over(cls, ranks: list[int], *, dp: int = 1, sp: int = 1,
             tp: int = 1) -> Mesh | None:
        """The mesh over the job ranks ``ranks`` (a new group of them):
        every rank of the job calls this with the same arguments, in the
        same order, as ``dist.new_group`` asks. A rank in ``ranks`` gets
        its mesh, any other None."""
        ranks = sorted(ranks)
        group = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            return cls(dp, sp, tp, group=group)
        if len(ranks) != dp * sp * tp:
            raise ValueError(f"dp·sp·tp = {dp * sp * tp} but {len(ranks)} ranks")
        _new_axis_groups(ranks, dp, sp, tp)
        return None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXES

    @property
    def shape(self) -> dict[str, int]:
        return {axis: self.size(axis) for axis in AXES}

    def size(self, axis: str) -> int:
        return getattr(self, axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[AXES.index(axis)]

    def block(self, seq_len: int) -> int:
        """The length of one rank's sequence block; ValueError when sp
        does not divide ``seq_len`` (__graft_entry__.py:92-95)."""
        if seq_len % self.sp:
            raise ValueError(f"sp={self.sp} must divide seq_len={seq_len}")
        return seq_len // self.sp

    def heads(self, n_heads: int) -> int:
        """The number of heads on one tp rank; ValueError when tp does not
        divide ``n_heads`` (__graft_entry__.py:92-95)."""
        if n_heads % self.tp:
            raise ValueError(f"tp={self.tp} must divide n_heads={n_heads}")
        return n_heads // self.tp

    def _group(self, axis: str) -> dist.ProcessGroup | None:
        """The axis's group, None where there is nothing to communicate
        (one rank on the axis)."""
        return getattr(self, f"{axis}_group") if self.size(axis) > 1 else None

    def reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over ``axis``, replicated; identity backward."""
        group = self._group(axis)
        return x if group is None else _Reduce.apply(x, group)

    def enter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x``, replicated over ``axis``, entering rank-local work: the
        identity, with its gradient summed over ``axis``."""
        group = self._group(axis)
        return x if group is None else _Enter.apply(x, group)

    def gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``x`` of ``axis`` concatenated along the last dim;
        this rank's slice of the gradient backward."""
        group = self._group(axis)
        return x if group is None else _Gather.apply(x, group)
