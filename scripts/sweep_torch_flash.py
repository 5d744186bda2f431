"""Sweep of the port's flash kernels on the card: the counterpart of
``scripts/sweep_flash_bwd.py`` for ``tasksrunner_torch``.

    python scripts/sweep_torch_flash.py [--out build/sweep_torch_flash.json]

It sweeps the two axes of the JAX sweep as the port has them:

* the backward's Δ variant: ``TASKSRUNNER_FLASH_BWD_DELTA`` unset (Δ by
  the pre-pass, B2) or ``fused`` (Δ in the main kernel, B3);
* the on-chip tiling: the depth of B1's K/V ring (``TRTORCH_FWD_STAGES``)
  and of B2/B3's Q/dO ring (``TRTORCH_BWD_STAGES``), 4 by default below
  d 128. They are compile-time defines, so each variant builds libraries
  of its own (``_kernels.KNOBS``).

Each variant runs in its own process. There it first holds B1 and the
backward against their plain versions, at the bench shape and at some of
the card tests' shapes, in bf16 and f32, to the card tests' tolerance;
only then are B1 and the backward timed alone at the bench shape (CUDA
events), and its train step by ``bench.run_step_bench()`` at the bench
config. The default build runs first and again last, which shows the
spread between two processes. A variant that fails is reported and not
ranked. The output is a table ranked by step time, and the JSON file
``--out``.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "sweep_torch_flash.json"

#: (label, environment) of each variant; the first is the default build
VARIANTS: list[tuple[str, dict[str, str]]] = [
    ("default", {}),
    ("delta_fused", {"TASKSRUNNER_FLASH_BWD_DELTA": "fused"}),
    ("fwd_stages=2", {"TRTORCH_FWD_STAGES": "2"}),
    ("fwd_stages=3", {"TRTORCH_FWD_STAGES": "3"}),
    ("fwd_stages=6", {"TRTORCH_FWD_STAGES": "6"}),
    ("bwd_stages=2", {"TRTORCH_BWD_STAGES": "2"}),
    ("bwd_stages=3", {"TRTORCH_BWD_STAGES": "3"}),
    ("bwd_stages=5", {"TRTORCH_BWD_STAGES": "5"}),
    ("default (again)", {}),  # the spread between two processes of one build
]
SWEPT = ("TASKSRUNNER_FLASH_BWD_DELTA", "TRTORCH_FWD_STAGES", "TRTORCH_BWD_STAGES")

#: (b, s, h, d): the bench config's attention, then card-test shapes
#: (tests/test_torch_gpu.py) with ragged tiles at every d the knobs reach
TWIN_SHAPES = [(32, 512, 16, 64), (8, 32, 4, 32), (2, 300, 4, 64), (3, 50, 2, 16),
               (3, 200, 2, 32), (1, 260, 2, 128)]


def hold_twins() -> dict[str, float]:
    """B1 and the backward of the variant the environment selects against
    their plain versions, to tests/test_torch_gpu.py's tolerance: O and
    the gradients 1e-2 (one bf16 rounding of p or dS), LSE 1e-3 / 1e-4.
    Raises on the first disagreement; returns each kernel's largest
    absolute error."""
    import torch

    from tasksrunner_torch import flash

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for shape in TWIN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, dout = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                             for _ in range(4))
            scale = shape[-1] ** -0.5
            out, lse = flash.flash_fwd(q, k, v, scale)
            grads = flash.flash_bwd(q, k, v, out, lse, dout, scale)
            torch.cuda.synchronize()
            want_o, want_lse = flash.flash_fwd_reference(q, k, v, scale)
            torch.testing.assert_close(out.float(), want_o.float(), atol=1e-2, rtol=1e-2)
            torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-4)
            worst["flash_fwd"] = max(worst["flash_fwd"],
                                     (out.float() - want_o.float()).abs().max().item())
            for got, want in zip(grads, flash.flash_bwd_reference(q, k, v, out, lse, dout,
                                                                  scale)):
                torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
                worst["flash_bwd"] = max(worst["flash_bwd"],
                                         (got.float() - want.float()).abs().max().item())
    return worst


def time_kernels() -> dict[str, float]:
    """B1 and the backward alone at the bench config's attention shape
    (b32 s512 h16 d64, bf16): the median over 15 repeats of the mean of 10
    back-to-back calls, from CUDA events."""
    import statistics

    import torch

    from tasksrunner_torch import flash

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, dout = (torch.randn(TWIN_SHAPES[0], generator=gen, device=dev)
                     .to(torch.bfloat16) for _ in range(4))
    scale = TWIN_SHAPES[0][-1] ** -0.5
    out, lse = flash.flash_fwd(q, k, v, scale)

    def median_ms(fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(15):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 10)
        return statistics.median(times)

    return {"flash_fwd_ms": median_ms(lambda: flash.flash_fwd(q, k, v, scale)),
            "flash_bwd_ms": median_ms(lambda: flash.flash_bwd(q, k, v, out, lse, dout, scale))}


def child() -> None:
    """One variant, under the environment it was started with."""
    from tasksrunner_torch import _kernels, bench

    _kernels.build(["flash_fwd", "flash_bwd"])  # both at once
    worst = hold_twins()
    kernel_ms = time_kernels()
    result = bench.run_step_bench()
    print(json.dumps({"defines": list(_kernels.defines()), "twin_max_abs_err": worst,
                      **kernel_ms,
                      **{k: result[k] for k in (
                          "device", "power_limit", "step_ms", "tflops_per_sec", "mfu",
                          "first_step_s", "launches", "einsum_core_step_ms")}}))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--child", action="store_true")
    parser.add_argument("--out", type=pathlib.Path, default=OUT)
    parser.add_argument("--timeout", type=int, default=600)
    args = parser.parse_args()
    if args.child:
        child()
        return

    base_env = {k: v for k, v in os.environ.items() if k not in SWEPT}
    results = []
    for label, env in VARIANTS:
        print(f"[{label}] ...", flush=True)
        try:
            proc = subprocess.run([sys.executable, str(pathlib.Path(__file__)), "--child"],
                                  capture_output=True, text=True, timeout=args.timeout,
                                  env={**base_env, **env}, cwd=str(REPO))
        except subprocess.TimeoutExpired:
            print(f"[{label}] timed out after {args.timeout} s", flush=True)
            results.append({"variant": label, "env": env, "error": "timeout"})
            continue
        if proc.returncode != 0:
            tail = proc.stderr.strip()[-1500:]
            print(f"[{label}] FAILED:\n{tail}", flush=True)
            results.append({"variant": label, "env": env, "error": tail})
            continue
        row = {"variant": label, "env": env,
               **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(f"[{label}] step {row['step_ms']:.3f} ms, twins held "
              f"(max abs err {row['twin_max_abs_err']})", flush=True)
        results.append(row)

    ranked = sorted((r for r in results if "step_ms" in r), key=lambda r: r["step_ms"])
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"results": results, "ranked": ranked}, indent=1))
    if ranked:
        print(f"\nranked ({ranked[0]['device']}, {ranked[0]['power_limit']}):")
        for r in ranked:
            mfu = f"{r['mfu']:.3f}" if r["mfu"] is not None else "n/a"
            print(f"  {r['step_ms']:9.3f} ms  {r['tflops_per_sec']:7.1f} TFLOP/s  "
                  f"MFU {mfu}  B1 {r['flash_fwd_ms']:.4f} ms  backward "
                  f"{r['flash_bwd_ms']:.4f} ms  {r['variant']}")
        best = ranked[0]
        exports = " ".join(f"{k}={v}" for k, v in best["env"].items())
        print(f"\nbest: {best['variant']} "
              + (f"(export {exports})" if exports else "(the default build: no overrides)"))
    print(f"\nwrote {args.out}")
    if len(ranked) < len(VARIANTS):
        sys.exit(1)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
