"""Builds and loads the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/tasksrunner_torch/`` beside the package. The file name carries a
hash of every source in ``csrc/`` and of the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Callers bind the C
entries with ``ctypes`` and declare their ``argtypes``.

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

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet: one
    ``nvcc`` per source, all started together, all waited for. Returns
    the compiler's output for each source it compiled: ``-Xptxas -v``
    lists each kernel's registers, shared memory and spills."""
    started = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
    """The loaded library built from ``csrc/<name>.cu``, built first if
    needed."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build([name])
            lib = _libraries[name] = ctypes.CDLL(str(library_path(name)))
        return lib
