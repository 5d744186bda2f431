"""Where one rank's time goes in the sharded train step, one rank per card.

    NCCL_SOCKET_IFNAME=lo python3 scripts/torch_sharded_profile.py

Needs four cards. For each of (dp, sp, tp) = (2, 1, 2) and (1, 2, 2),
spawns four ranks, one per card over NCCL, at the bench config (batch 32,
lr 1e-3), and profiles five steps of every rank after three warm ones
with ``chip_smoke._profile``: host wall time per step, device busy time
and share (NCCL's kernels, which spin while they wait for a peer, count
as busy), and the largest kernels. Prints one JSON line per rank and
mesh.
"""

from __future__ import annotations

import datetime
import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from chip_smoke import BENCH, BENCH_BATCH  # noqa: E402
from tasksrunner_torch.graft_entry import LEARNING_RATE, dryrun_inputs  # noqa: E402
from tasksrunner_torch.mesh import Mesh  # noqa: E402
from tasksrunner_torch.model import init_params, make_train_step, shard_params  # noqa: E402

N = 4
MESHES = ((2, 1, 2), (1, 2, 2))
STEPS = 5


def _rank(rank: int, shape: tuple[int, int, int], tmp: str) -> None:
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=N, timeout=datetime.timedelta(seconds=60),
                            device_id=device)
    try:
        mesh = Mesh(*shape, group=dist.group.WORLD)
        tokens, labels = (torch.from_numpy(x).to(device)
                          for x in dryrun_inputs(BENCH, BENCH_BATCH))
        local = shard_params(init_params(BENCH, 0, device), mesh)
        step = make_train_step(BENCH, mesh, learning_rate=LEARNING_RATE)
        report = chip_smoke._profile(lambda: step(local, tokens, labels), STEPS)
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(
            {"mesh_dp_sp_tp": list(shape), "rank": rank, "coords": mesh.coords,
             **report, "timing": f"{N} ranks on {N} cards over NCCL"}))
    finally:
        dist.destroy_process_group()


def main() -> int:
    if torch.cuda.device_count() < N:
        print(f"torch_sharded_profile: needs {N} cards, has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    chip_smoke.phase_device()
    chip_smoke.phase_build()  # before any rank starts
    for shape in MESHES:
        with tempfile.TemporaryDirectory(prefix="tasksrunner-profile-") as tmp:
            mp.spawn(_rank, args=(shape, tmp), nprocs=N, join=True)
            for rank in range(N):
                print(Path(tmp, f"rank{rank}.json").read_text(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
