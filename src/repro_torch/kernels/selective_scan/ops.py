"""``ssm_scan``: the selective scan through the ``selective_scan`` kernel,
the port of ``repro.kernels.selective_scan.ops.ssm_scan_pallas``.

Mind the argument order: this wrapper takes ``(u, dt, A, B, C, D)``, the
kernel ``(u, dt, B, C, A, D)``.  A ``torch.autograd.Function`` whose
forward is the kernel on a CUDA tensor and its plain version on a CPU
tensor (the dispatch lives in the kernel's wrapper), and whose backward is
autograd through the plain recurrence (``ref.selective_scan_ref``), as the
reference's ``_ssm_scan_bwd`` is.  Under ``torch.func.vmap`` the vmapped
axis folds into the kernel's batch axis; per-client ``A`` and ``D`` become
the kernel's group axis, so a whole cohort is one launch."""
from __future__ import annotations

import torch

from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan.selective_scan import selective_scan


def _grouped(x: torch.Tensor, dim, size: int, lead: int) -> torch.Tensor:
    """A parameter (``lead``: its axes beyond the group axis, 2 for A's
    [di, N], 1 for D's [di]) with the vmapped axis folded into a leading
    group axis."""
    if dim is None:
        grouped = x if x.dim() > lead else x[None]
        return grouped.repeat(size, *([1] * lead))
    x = x.movedim(dim, 0)
    return x.reshape(-1, *x.shape[x.dim() - lead:])


class SSMScan(torch.autograd.Function):

    @staticmethod
    def forward(u, dt, A, B, C, D):
        return selective_scan(u, dt, B, C, A, D)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        _, vjp = torch.func.vjp(
            lambda u, dt, A, B, C, D: selective_scan_ref(u, dt, B, C, A, D),
            *ctx.saved_tensors)
        return vjp(g)

    @staticmethod
    def vmap(info, in_dims, u, dt, A, B, C, D):
        n = info.batch_size

        def fold(t, d):
            t = t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
            return t.reshape(n * t.shape[1], *t.shape[2:])

        u, dt, B, C = (fold(t, d) for t, d in
                       zip((u, dt, B, C), (in_dims[0], in_dims[1],
                                           in_dims[3], in_dims[4])))
        if in_dims[2] is not None or in_dims[5] is not None or A.dim() == 3:
            A = _grouped(A, in_dims[2], n, lead=2)
            D = _grouped(D, in_dims[5], n, lead=1)
        # else A and D are shared by every client: the kernel reads them at
        # G = 1 and nothing is copied per client.
        y = SSMScan.apply(u.contiguous(), dt.contiguous(), A.contiguous(),
                          B.contiguous(), C.contiguous(), D.contiguous())
        return y.reshape(n, -1, *y.shape[1:]), 0


def ssm_scan(u, dt, A, B, C, D):
    """Same contract as ``mamba._ssm_scan``'s y output (no ``h_last``: the
    chunked plain scan serves calls that need a decode cache).
    u, dt: [Bsz,S,di]; A: [di,N]; B, C: [Bsz,S,N]; D: [di] -> [Bsz,S,di].
    Differentiable (backward through the plain recurrence)."""
    return SSMScan.apply(u, dt, A, B, C, D)
