"""Mamba-1 selective state-space block (falcon-mamba-7b style), the port of
``repro.models.mamba`` (``dt_rank``, ``mamba_init``, ``_ssm_scan``,
``mamba``).

The full-sequence scan goes through ``kernels.selective_scan.ops.ssm_scan``
exactly where the reference takes its kernel path, at
``return_cache=False``: on a CUDA tensor the Hopper kernel, on a CPU
tensor its plain version.  A call that needs the final state
(``return_cache=True``) runs the plain chunked ``_ssm_scan``.  Decode and
the mamba cache come with serving."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.selective_scan.ops import ssm_scan
from repro_torch.models import layers


def dt_rank(cfg: ArchConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_init(key, cfg: ArchConfig):
    d, di, N, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    r = dt_rank(cfg)
    keys = prng.split(key, 6)
    scale = 1.0 / math.sqrt(d)
    dev = key.device
    dt0 = prng.uniform(keys[4], (di,), 1e-3, 1e-1).clamp_min(1e-4)
    return {
        "in_proj": layers._uniform(keys[0], (d, 2 * di), scale),
        "conv_w": layers._uniform(keys[1], (k, di), 1.0 / math.sqrt(k)),
        "x_proj": layers._uniform(keys[2], (di, r + 2 * N),
                                  1.0 / math.sqrt(di)),
        "dt_proj": layers._uniform(keys[3], (r, di), 1.0 / math.sqrt(r)),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                        device=dev).expand(di, N)
                           .contiguous()),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": layers._uniform(keys[5], (di, d), 1.0 / math.sqrt(di)),
    }


SSM_CHUNK = 16  # sequence chunk of the plain chunked scan


def _ssm_scan(u, dt, A, B, C, D):
    """Plain chunked selective scan that also returns the final state.
    u,dt: [B,S,di]; A: [di,N]; B,C: [B,S,N]; D: [di] -> (y [B,S,di],
    h_last [B,di,N]).

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t ;  y_t = <C_t, h_t> + D*u_t

    Chunks of SSM_CHUNK steps materialize [B,Sc,di,N] decay and input
    terms; the state is carried across chunks."""
    Bsz, S, di = u.shape
    N = A.shape[-1]
    Sc = SSM_CHUNK
    while S % Sc:
        Sc -= 1
    h = torch.zeros((Bsz, di, N), dtype=u.dtype, device=u.device)
    ys = []
    for c0 in range(0, S, Sc):
        dt_c, u_c = dt[:, c0:c0 + Sc], u[:, c0:c0 + Sc]
        dA = torch.exp(dt_c[..., None] * A)                  # [B,Sc,di,N]
        dBu = (dt_c * u_c)[..., None] * B[:, c0:c0 + Sc, None, :]
        hs = []
        for t in range(Sc):
            h = dA[:, t] * h + dBu[:, t]
            hs.append(h)
        ys.append(torch.einsum("bsdn,bsn->bsd", torch.stack(hs, 1),
                               C[:, c0:c0 + Sc]))
    y = torch.cat(ys, dim=1)
    return y + D * u, h


def mamba(p, cfg: ArchConfig, x: torch.Tensor, return_cache: bool = False):
    """Full-sequence mamba block.  x [B,S,d] -> [B,S,d] (+ decode cache)."""
    Bsz, S, d = x.shape
    N, k = cfg.ssm_state, cfg.ssm_conv
    r = dt_rank(cfg)
    xz = x @ p["in_proj"]                                   # [B,S,2di]
    u, z = xz.chunk(2, dim=-1)
    # depthwise causal conv over S
    u_pad = F.pad(u, (0, 0, k - 1, 0))
    u_conv = sum(u_pad[:, i:i + S] * p["conv_w"][i] for i in range(k))
    u_conv = F.silu(u_conv)
    proj = u_conv @ p["x_proj"]                             # [B,S,r+2N]
    dt_in, Bmat, Cmat = torch.split(proj, [r, N, N], dim=-1)
    dt_lin = dt_in @ p["dt_proj"] + p["dt_bias"]
    dt = torch.logaddexp(dt_lin, torch.zeros_like(dt_lin))  # softplus
    A = -torch.exp(p["A_log"].float())                      # [di,N]
    args = (u_conv.float(), dt.float(), A, Bmat.float().contiguous(),
            Cmat.float().contiguous(), p["D"].float())
    if return_cache:
        y, h_last = _ssm_scan(*args)
    else:
        y = ssm_scan(*args)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if return_cache:
        # last k-1 raw (pre-conv) inputs, front-padded with the causal
        # conv's zeros for prompts shorter than the receptive field
        tail = u[:, max(0, S - (k - 1)):, :]
        if S < k - 1:
            tail = F.pad(tail, (0, 0, k - 1 - S, 0))
        return out, {"conv": tail, "ssm": h_last}
    return out
