"""``flash_gqa``: GQA attention in the model layout through the
``flash_attention`` kernel, the port of
``repro.kernels.flash_attention.ops.flash_gqa``.

A ``torch.autograd.Function`` whose forward is the kernel on a CUDA tensor
and its plain version on a CPU tensor (the dispatch lives in the kernel's
wrapper, nowhere else), and whose backward is autograd through the plain
GQA version (``ref.gqa_ref``), as the reference's ``_flash_gqa_bwd`` is.
Under ``torch.func.vmap`` the vmapped axis folds into the kernel's batch
axis: one launch for a whole cohort."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import gqa_ref


def _batched(x: torch.Tensor, dim, size: int) -> torch.Tensor:
    """x with its vmapped axis (``dim``, None if unbatched) leading."""
    if dim is None:
        return x.expand(size, *x.shape)
    return x.movedim(dim, 0)


class FlashGQA(torch.autograd.Function):

    @staticmethod
    def forward(q, k, v, causal, window):
        out = flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=causal, window=window)
        return out.transpose(1, 2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda q_, k_, v_: gqa_ref(q_, k_, v_, ctx.causal, ctx.window),
            q, k, v)
        return (*vjp(g.to(q.dtype)), None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size
        q, k, v = (_batched(t, d, n) for t, d in zip((q, k, v), in_dims[:3]))
        fold = lambda t: t.reshape(n * t.shape[1], *t.shape[2:])
        out = FlashGQA.apply(fold(q), fold(k), fold(v), causal, window)
        return out.reshape(n, -1, *out.shape[1:]), 0


def flash_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,S,Hq,dh]; k/v [B,S,Hk,dh] -> [B,S,Hq,dh] (differentiable)."""
    return FlashGQA.apply(q, k, v, causal, window)
