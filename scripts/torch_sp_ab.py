"""Times the sequence-parallel path of another source tree's port with
chip_smoke.py's own timing functions, for an A/B of two trees on one card
in one call.

    python3 scripts/torch_sp_ab.py TREE

TREE is the root of a checkout (the repo itself, or an older commit
unpacked with ``git archive`` into a directory that .gitignore lists).
Its ``tasksrunner_torch`` is imported in place of the repo's and builds
its kernels into its own build directory. Prints chip_smoke's ``times``
records of the sp forward and train step beside the single-device ones
and of the host's cost per call on the served sp-2 path, each with a
``tree`` key. Run the trees in turns (A, B, B, A): times move between
calls and machines. Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


def main() -> int:
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(tree))
    import tasksrunner_torch  # TREE's package, before chip_smoke imports one

    if Path(tasksrunner_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"{tree} holds no tasksrunner_torch")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not smoke.torch.cuda.is_available():
        print("torch_sp_ab: no CUDA device is available", file=sys.stderr)
        return 2
    smoke.emit = lambda record: print(json.dumps({"tree": str(tree), **record}), flush=True)
    smoke._kernels.build(["flash_fwd", "flash_bwd", "flash_ring"])
    smoke._time_sequence_parallel()
    smoke._time_host()
    return 0


if __name__ == "__main__":
    sys.exit(main())
