"""Wrapper of the CUDA C++ ``selective_scan`` kernel
(``selective_scan.cu``), which replaces the TPU kernel
``repro/kernels/selective_scan/selective_scan.py:50``.

The kernel is built with ``nvcc`` at the first launch and called through
a plain C interface (``ctypes``) on PyTorch's current stream.  A CUDA
tensor launches it; a CPU tensor takes ``ref.selective_scan_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

SOURCE = Path(__file__).with_name("selective_scan.cu")
MAX_N = 64


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(str(SOURCE), "selective_scan")
    fn = lib.selective_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build() -> Path:
    """Compile the kernel (if its build is missing) and return the
    library's path."""
    _library()
    return _build.library_path(SOURCE, "selective_scan")


def selective_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor
                   ) -> torch.Tensor:
    """u, dt: [Bsz, S, di]; B, C: [Bsz, S, N]; A: [di, N] or [G, di, N];
    D: [di] or [G, di] -> y [Bsz, S, di] f32.  With a group axis G (which
    must divide Bsz) batch row b reads A[b // (Bsz // G)] and D likewise."""
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"u and dt must both be [Bsz, S, di], got "
                         f"{tuple(u.shape)} and {tuple(dt.shape)}")
    Bsz, S, di = u.shape
    N = A.shape[-1]
    A3 = A if A.dim() == 3 else A[None]
    D2 = D if D.dim() == 2 else D[None]
    G = A3.shape[0]
    if (B.shape != (Bsz, S, N) or C.shape != B.shape
            or A3.shape[1:] != (di, N) or D2.shape != (G, di)
            or Bsz % G):
        raise ValueError(f"selective_scan operands do not fit: u "
                         f"{tuple(u.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}")
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, B, C, A, D)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu tensors, got "
                         f"{u.device}")
    for name, t in (("u", u), ("dt", dt), ("B", B), ("C", C), ("A", A3),
                    ("D", D2)):
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan takes float32, {name} is "
                            f"{t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N > MAX_N:
        raise ValueError(f"state size {N} > {MAX_N}")
    y = torch.empty_like(u)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.selective_scan_launch(
            u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            A3.data_ptr(), D2.data_ptr(), y.data_ptr(), Bsz, S, di, N, G,
            stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: CUDA error {rc}")
    launch_counts["selective_scan"] += 1
    return y
