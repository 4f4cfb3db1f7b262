"""Wrapper of the CUDA C++ ``stale_agg_refresh`` kernel
(``stale_agg_refresh.cu``), which replaces the TPU kernel
``repro/kernels/stale_agg/stale_agg.py:98``.

The kernel is built with ``nvcc`` at the first launch and called through
a plain C interface (``ctypes``) on PyTorch's current stream.  A CUDA
tensor launches it; a CPU tensor takes ``ref.stale_agg_refresh_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.stale_agg.ref import stale_agg_refresh_ref

SOURCE = Path(__file__).with_name("stale_agg_refresh.cu")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(str(SOURCE), "stale_agg_refresh")
    fn = lib.stale_agg_refresh_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build() -> Path:
    """Compile the kernel (if its build is missing) and return the
    library's path."""
    _library()
    return _build.library_path(SOURCE, "stale_agg_refresh")


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stale_agg_refresh(coeff: torch.Tensor, beta: torch.Tensor,
                      act: torch.Tensor, idx: torch.Tensor, G: torch.Tensor,
                      h: torch.Tensor, stale_sum: torch.Tensor
                      ) -> torch.Tensor:
    """Eq. 18 delta + in-place stale-store refresh in one pass.

    coeff, beta, act: [C] f32; idx: [C] integer, DISTINCT rows of the store;
    G: [C, P] f32; h: [N, P] f32 store, contiguous, refreshed in place
    (h[idx[c]] <- G[c] where act[c] > 0; other rows untouched);
    stale_sum: [P] f32.  Returns delta [P] f32."""
    if G.device.type == "cpu":
        return stale_agg_refresh_ref(coeff, beta, act, idx, G, h, stale_sum)
    if G.device.type != "cuda":
        raise ValueError(f"stale_agg_refresh runs on cuda or cpu tensors, "
                         f"got {G.device}")
    C, P = G.shape
    dev, f32 = G.device, torch.float32
    if h.dim() != 2 or h.shape[1] != P:
        raise ValueError(f"store h must be [N, {P}], got {tuple(h.shape)}")
    coeff = coeff.to(f32).contiguous()
    beta = beta.to(f32).contiguous()
    act = act.to(f32).contiguous()
    idx = idx.to(torch.int32).contiguous()
    for name, t, shape, dtype in (
            ("coeff", coeff, (C,), f32), ("beta", beta, (C,), f32),
            ("act", act, (C,), f32), ("idx", idx, (C,), torch.int32),
            ("G", G, (C, P), f32), ("h", h, tuple(h.shape), f32),
            ("stale_sum", stale_sum, (P,), f32)):
        _check(name, t, shape, dtype, dev)
    delta = torch.empty((P,), device=dev, dtype=f32)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.stale_agg_refresh_launch(
            coeff.data_ptr(), beta.data_ptr(), act.data_ptr(),
            idx.data_ptr(), G.data_ptr(), h.data_ptr(),
            stale_sum.data_ptr(), delta.data_ptr(), C, P, stream)
    if rc != 0:
        raise RuntimeError(f"stale_agg_refresh launch failed: CUDA error "
                           f"{rc}")
    launch_counts["stale_agg_refresh"] += 1
    return delta
