"""Wrapper of the CUDA C++ ``flash_attention`` kernel
(``flash_attention.cu``), which replaces the TPU kernel
``repro/kernels/flash_attention/flash_attention.py:74``.

The kernel is built with ``nvcc`` at the first launch and called through
a plain C interface (``ctypes``) on PyTorch's current stream.  A CUDA
tensor launches it; a CPU tensor takes ``ref.attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).with_name("flash_attention.cu")
MAX_D = 256


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(str(SOURCE), "flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build() -> Path:
    """Compile the kernel (if its build is missing) and return the
    library's path."""
    _library()
    return _build.library_path(SOURCE, "flash_attention")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, H, S, D]; k, v: [B, Hk, S, D] with H % Hk == 0 (query head h
    reads KV head h // (H // Hk)) -> out [B, H, S, D] f32.  Causal
    (optionally sliding-window) softmax attention, scale 1/sqrt(D)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, H, S, D] and k, v [B, Hk, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    Hk = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D) or H % Hk:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of Hk)")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention takes float32, {name} is "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D > MAX_D:
        raise ValueError(f"head dim {D} > {MAX_D}")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Hk, S, D, int(bool(causal)), int(window), 1.0 / math.sqrt(D),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    launch_counts["flash_attention"] += 1
    return out
