"""Build a CUDA C++ kernel source into a shared library with a plain C
interface and load it with ``ctypes``.

The library is compiled by ``nvcc`` for ``sm_90a`` at first use, from the
source in the package, into ``<checkout>/build/kernels/<name>-<hash>/``.
The hash covers the source and the flags, so an edited source rebuilds.
A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# <checkout>/src/repro_torch/kernels/_build.py -> <checkout>/build/kernels
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                           "/usr/local/cuda/bin: the CUDA kernels cannot be "
                           "built")
    return path


def library_path(source: Path, name: str) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def build(source: Path, name: str) -> Path:
    """Compile ``source`` unless the library for its hash exists; returns
    the library's path.  The compiler's report (``-Xptxas -v``: registers,
    spills) is kept beside it in ``nvcc.log``."""
    so = library_path(source, name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (so.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load(source: str, name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(Path(source), name)))
