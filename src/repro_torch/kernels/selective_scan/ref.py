"""Plain PyTorch version of the ``selective_scan`` kernel (the sequential
recurrence): the CPU path of the wrapper, the backward's function
(autograd through it), and the yardstick the kernel is held to on the
card."""
from __future__ import annotations

import torch


def selective_scan_ref(u, dt, B, C, A, D):
    """The kernel's function in its argument order: u, dt: [Bsz,S,di];
    B, C: [Bsz,S,N]; A: [di,N] or [G,di,N]; D: [di] or [G,di] ->
    [Bsz,S,di].  With a group axis G (which divides Bsz) batch row b reads
    A[b // (Bsz // G)] and D likewise: the per-client parameters of a
    folded cohort."""
    u, dt, B, C = u.float(), dt.float(), B.float(), C.float()
    A, D = A.float(), D.float()
    Bsz, S, di = u.shape
    N = A.shape[-1]
    if A.dim() == 3:
        A = A.repeat_interleave(Bsz // A.shape[0], dim=0)
    if D.dim() == 2:
        D = D.repeat_interleave(Bsz // D.shape[0], dim=0)
    h = torch.zeros((Bsz, di, N), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(S):
        u_t, dt_t = u[:, t], dt[:, t]
        dA = torch.exp(dt_t[..., None] * A)                  # [Bsz,di,N]
        h = h * dA + (dt_t * u_t)[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]) + D * u_t)
    return torch.stack(ys, dim=1)
