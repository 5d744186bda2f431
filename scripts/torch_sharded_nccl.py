"""The sharded train step and the served split with one card per rank.

    python3 scripts/torch_sharded_nccl.py

Needs four cards. Runs ``chip_smoke.py``'s phases on all four:

* build, then serve: ``service.make_app()`` serves on every visible card,
  so each bucket that divides by four runs its rows split over them
  (warm-up included, off the event loop); then every bucket's
  probabilities split over the four cards against those of one card;
* sharded: the dryrun at its default factorization of 4 (1 × 2 × 2),
  then the bench config at batch 32 and lr 1e-3 over (dp, sp, tp) =
  (2, 1, 2), which runs B1 and B2, and (1, 2, 2), which runs B4 and the
  ring's backward, one rank per card over NCCL, each rank held against
  the single-device step on cuda:0.

A phase that does not hold raises. Prints the cards' names and power
limits and the phases' JSON lines.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from chip_smoke import LOGITS_TOL, SERVED, check, emit  # noqa: E402
from tasksrunner_torch import service  # noqa: E402
from tasksrunner_torch.batching import DEFAULT_BUCKETS  # noqa: E402
from tasksrunner_torch.model import init_params, replicate_params, serving_mesh  # noqa: E402

N = 4


def served_split() -> None:
    """Each bucket's probabilities over the four cards against one card's
    from the same params, within the logits' tolerance (a probability
    moves no more than the logits do)."""
    devices = list(serving_mesh())
    replicas = replicate_params(init_params(SERVED, 0, devices[0]), devices)
    rng = np.random.default_rng(0)
    for bucket in DEFAULT_BUCKETS:
        tokens = rng.integers(0, SERVED.vocab, (bucket, SERVED.seq_len), dtype=np.int32)
        split = service.batch_probs(replicas, devices, tokens, cfg=SERVED)
        one = service.batch_probs(replicas[:1], devices[:1], tokens, cfg=SERVED)
        err = float(np.abs(split - one).max())
        parts = len(service.place_tokens(tokens, devices))
        emit({"phase": "served split", "bucket": bucket, "parts": parts,
              "max_abs_err_probs": err, "tolerance": LOGITS_TOL})
        check(err <= LOGITS_TOL, f"bucket {bucket} split over {parts} cards is off by {err}")


def main() -> int:
    if torch.cuda.device_count() < N:
        print(f"torch_sharded_nccl: needs {N} cards, has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    chip_smoke.phase_device()
    chip_smoke.phase_build()  # before any rank starts
    chip_smoke.phase_serve()
    served_split()
    chip_smoke.phase_sharded(cards=N, meshes=((2, 1, 2), (1, 2, 2)), dryrun_ranks=N)
    return 0


if __name__ == "__main__":
    sys.exit(main())
