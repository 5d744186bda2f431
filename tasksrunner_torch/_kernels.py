"""Builds and loads the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/tasksrunner_torch/`` beside the package. The file name carries a
hash of every source in ``csrc/`` and of the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Callers bind the C
entries with ``ctypes`` and declare their ``argtypes``.

A few tiling choices are compile-time knobs (:data:`KNOBS`): a
``TRTORCH_*`` variable set in the environment adds its ``-D`` define to
the build, and so to the file's hash and to the key a loaded library is
kept under, so two variants never share a library. With none set the
build is the default one, its file named by the sources and flags alone.

Nothing here runs at import: this module is imported on machines that
have no ``nvcc`` and no card, where only the kernels' plain versions
run. A failed build raises with the compiler's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tasksrunner_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: compile-time knobs: the environment variable → the macro it defines;
#: unset, the source's own default holds
KNOBS = {
    "TRTORCH_FWD_STAGES": "TR_FWD_STAGES",  # flash_fwd.cu: K/V ring depth below d 128 (4)
    "TRTORCH_BWD_STAGES": "TR_BWD_STAGES",  # flash_bwd.cu: Q/dO ring depth below d 128 (4)
}

_lock = threading.Lock()
_libraries: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels cannot be built")


def defines() -> tuple[str, ...]:
    """The ``-D`` flags of the :data:`KNOBS` set in the environment, in a
    fixed order; each must be a positive integer."""
    flags = []
    for env, macro in sorted(KNOBS.items()):
        raw = os.environ.get(env, "").strip()
        if not raw:
            continue
        if not raw.isdigit() or int(raw) < 1:
            raise ValueError(f"{env}={raw!r}: expected a positive integer")
        flags.append(f"-D{macro}={int(raw)}")
    return tuple(flags)


def library_path(name: str, flags: tuple[str, ...] | None = None) -> Path:
    """Where ``csrc/<name>.cu`` is built with the define ``flags``
    (by default those the environment sets)."""
    flags = defines() if flags is None else flags
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for src in sorted(CSRC.iterdir()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet: one
    ``nvcc`` per source, all started together, all waited for. Returns
    the compiler's output for each source it compiled: ``-Xptxas -v``
    lists each kernel's registers, shared memory and spills."""
    flags = defines()
    started = []
    for name in names:
        out = library_path(name, flags)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures, outputs = [], {}
    for name, out, tmp, proc in started:
        stdout, stderr = proc.communicate()
        outputs[name] = stdout + stderr
        if proc.returncode:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                            f"{stdout}{stderr}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outputs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` with the knobs the
    environment sets, built first if needed."""
    flags = defines()
    with _lock:
        lib = _libraries.get((name, flags))
        if lib is None:
            build([name])
            lib = _libraries[name, flags] = ctypes.CDLL(str(library_path(name, flags)))
        return lib
