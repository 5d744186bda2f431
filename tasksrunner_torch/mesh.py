"""The port's stand-in for a JAX ``Mesh`` with a sequence axis ``sp``:
the counterpart of the ``("dp", "sp", "tp")`` meshes that
``tasksrunner/ml/model.py`` takes, cut to the one axis that ring
attention (:mod:`tasksrunner_torch.ring`) runs over. It exposes
``axis_names`` and ``shape`` as a JAX mesh does, so the model reads it
the same way (model.py:113-115).

The sp ranks have two placements:

* ``Mesh(sp=n)``: n ranks in one process on one device. Ring attention
  takes the global [b, s, h, d] tensors, as the JAX ``ring_attention``
  takes global arrays, and folds the n sequence blocks into the batch.
* ``Mesh(sp=n, group=g)``: one rank per process of the
  ``torch.distributed`` group ``g`` of size n. Ring attention takes this
  rank's [b, s/n, h, d] shard and rotates K and V between processes.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    sp: int
    group: dist.ProcessGroup | None = None

    def __post_init__(self) -> None:
        if self.sp < 1:
            raise ValueError(f"sp must be at least 1, got {self.sp}")
        if self.group is not None and dist.get_world_size(self.group) != self.sp:
            raise ValueError(f"sp={self.sp} but the process group has "
                             f"{dist.get_world_size(self.group)} ranks")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("sp",)

    @property
    def shape(self) -> dict[str, int]:
        return {"sp": self.sp}

    def block(self, seq_len: int) -> int:
        """The length of one rank's sequence block; ValueError when sp
        does not divide ``seq_len`` (__graft_entry__.py:92-95)."""
        if seq_len % self.sp:
            raise ValueError(f"sp={self.sp} must divide seq_len={seq_len}")
        return seq_len // self.sp
