"""Triton kernel: per-row inner products for the StaleVR beta (Eq. 20).

Replaces the TPU kernel ``repro/kernels/batched_dot/batched_dot.py:40``
(``batched_dot``): for G, h of shape [C, P] one pass gives
``dots[c] = <G_c, h_c>`` and ``norms[c] = ||h_c||^2`` in f32.

Bound: device-memory bytes (2 C P 4 B read for 4 flops per element pair).
A row per program would light up only C of the 132 SMs at the slice's
C = 24, so the P axis is split too: stage 1 runs a (C, split) grid, each
program streaming one masked P chunk in BLOCK-wide coalesced loads into
two f32 vector accumulators; stage 2 reduces each row's split partials in
one program.  No atomics: the launch configuration fixes the summation
order, so the same inputs give the same bits on every run.

``triton`` is imported inside ``_kernels`` at the first launch, never
when this module is imported (the CPU build of the port has no triton).
"""
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.batched_dot.ref import batched_dot_ref

BLOCK = 1024        # f32 elements per load step of one program
MAX_SPLIT = 64      # most P chunks per row (stage-1 programs per row)

# bound to ``triton.language`` by ``_kernels`` before the kernels are defined
tl = None
_KERNELS = None


def _kernels():
    global tl, _KERNELS
    if _KERNELS is None:
        import triton
        import triton.language
        tl = triton.language

        @triton.jit
        def batched_dot_partial_kernel(g_ptr, h_ptr, pd_ptr, pn_ptr, P,
                                       chunk, split, BLOCK: tl.constexpr):
            c = tl.program_id(0)
            s = tl.program_id(1)
            row = c.to(tl.int64) * P
            start = s * chunk
            offs = tl.arange(0, BLOCK)
            acc_d = tl.zeros([BLOCK], dtype=tl.float32)
            acc_n = tl.zeros([BLOCK], dtype=tl.float32)
            for k in range(0, chunk, BLOCK):
                p = start + k + offs
                m = p < P
                g = tl.load(g_ptr + row + p, mask=m, other=0.0)
                hv = tl.load(h_ptr + row + p, mask=m, other=0.0)
                acc_d += g * hv
                acc_n += hv * hv
            tl.store(pd_ptr + c * split + s, tl.sum(acc_d, axis=0))
            tl.store(pn_ptr + c * split + s, tl.sum(acc_n, axis=0))

        @triton.jit
        def batched_dot_final_kernel(pd_ptr, pn_ptr, dot_ptr, nrm_ptr,
                                     split, SPLIT_P2: tl.constexpr):
            c = tl.program_id(0)
            offs = tl.arange(0, SPLIT_P2)
            m = offs < split
            d = tl.load(pd_ptr + c * split + offs, mask=m, other=0.0)
            n = tl.load(pn_ptr + c * split + offs, mask=m, other=0.0)
            tl.store(dot_ptr + c, tl.sum(d, axis=0))
            tl.store(nrm_ptr + c, tl.sum(n, axis=0))

        _KERNELS = (batched_dot_partial_kernel, batched_dot_final_kernel)
    return _KERNELS


def launch_shape(P: int):
    """(split, chunk): at most MAX_SPLIT chunks of a row, each a multiple
    of BLOCK, none empty, together covering P."""
    blocks = max(1, -(-P // BLOCK))
    chunk_blocks = -(-blocks // MAX_SPLIT)
    split = -(-blocks // chunk_blocks)
    return split, chunk_blocks * BLOCK


def triton_next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def batched_dot(G: torch.Tensor, h: torch.Tensor):
    """G, h: [C, P] f32 -> (dots [C], norms [C]) f32."""
    if G.device.type == "cpu":
        return batched_dot_ref(G, h)
    if G.device.type != "cuda":
        raise ValueError(f"batched_dot runs on cuda or cpu tensors, got "
                         f"{G.device}")
    if G.dim() != 2 or G.shape != h.shape:
        raise ValueError(f"G and h must both be [C, P], got {tuple(G.shape)} "
                         f"and {tuple(h.shape)}")
    if h.device != G.device:
        raise ValueError(f"h is on {h.device}, G on {G.device}")
    if G.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"batched_dot takes float32, got {G.dtype} and "
                        f"{h.dtype}")
    G, h = G.contiguous(), h.contiguous()
    C, P = G.shape
    split, chunk = launch_shape(P)
    partial_kernel, final_kernel = _kernels()
    pd = torch.empty((C, split), device=G.device, dtype=torch.float32)
    pn = torch.empty_like(pd)
    dots = torch.empty((C,), device=G.device, dtype=torch.float32)
    norms = torch.empty_like(dots)
    if C > 0:
        with torch.cuda.device(G.device):
            partial_kernel[(C, split)](G, h, pd, pn, P, chunk, split,
                                       BLOCK=BLOCK, num_warps=4)
            final_kernel[(C,)](pd, pn, dots, norms, split,
                               SPLIT_P2=triton_next_pow2(split),
                               num_warps=1)
    launch_counts["batched_dot"] += 1
    return dots, norms
