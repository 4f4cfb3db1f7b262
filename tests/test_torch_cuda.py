"""The port's Hopper kernels on the card, against their plain versions.

Every test here needs a CUDA GPU and skips without one.  The file imports
neither JAX nor the reference package, so it also runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference kernel tests': batched_dot rtol 2e-5, atol
2e-5 sqrt(P); stale_agg_refresh delta rtol 2e-4, atol 2e-4 C, the
refreshed store bitwise; flash_attention rtol 2e-3, atol 2e-3;
selective_scan rtol 1e-4, atol 1e-4.  The shapes are the real-model
world's at published widths (qwen3-0.6b heads: H 16, Hk 8, D 128 at
S 256 for a cohort of 4 clients x 4 sequences and the 32-sequence loss
probe; falcon-mamba-7b: di 8192, N 16) and ragged ones."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.batched_dot import batched_dot as bd
from repro_torch.kernels.batched_dot.ref import batched_dot_ref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.selective_scan import selective_scan as ss
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.stale_agg import stale_agg as sa
from repro_torch.kernels.stale_agg.ref import stale_agg_refresh_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the Hopper kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _k2_inputs(C, N, P, seed=0):
    rng = np.random.default_rng(seed)
    coeff = rng.uniform(0, 2, C).astype(np.float32)
    beta = rng.uniform(0, 1, C).astype(np.float32)
    act = (rng.uniform(size=C) > 0.3).astype(np.float32)
    act[0] = 1.0
    idx = rng.choice(N, C, replace=False).astype(np.int32)
    G = rng.normal(size=(C, P)).astype(np.float32)
    h = rng.normal(size=(N, P)).astype(np.float32)
    ss = rng.normal(size=P).astype(np.float32)
    return coeff, beta, act, idx, G, h, ss


@pytest.mark.parametrize("C,P", [(24, 103018), (120, 103018), (7, 1001),
                                 (3, 1)])
def test_batched_dot_kernel(cuda, C, P):
    rng = np.random.default_rng(C + P)
    G = torch.tensor(rng.normal(size=(C, P)).astype(np.float32), device=cuda)
    h = torch.tensor(rng.normal(size=(C, P)).astype(np.float32), device=cuda)
    before = launch_counts["batched_dot"]
    d1, n1 = bd.batched_dot(G, h)
    d2, n2 = bd.batched_dot(G, h)
    torch.cuda.synchronize()
    assert launch_counts["batched_dot"] == before + 2
    assert torch.equal(d1, d2) and torch.equal(n1, n2)      # deterministic
    rd, rn = batched_dot_ref(G, h)
    for got, want in ((d1, rd), (n1, rn)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5 * math.sqrt(P))


@pytest.mark.parametrize("C,N,P", [(24, 120, 103018), (120, 120, 103018),
                                   (5, 9, 1001)])
def test_stale_agg_refresh_kernel(cuda, C, N, P):
    coeff, beta, act, idx, G, h, ss = _k2_inputs(C, N, P)
    coeff[1], act[1], G[1] = 0.0, 0.0, np.nan          # a padding slot
    args = [torch.tensor(a, device=cuda) for a in (coeff, beta, act, idx, G)]
    hk = torch.tensor(h, device=cuda)
    hp = hk.clone()
    ssd = torch.tensor(ss, device=cuda)
    dk = sa.stale_agg_refresh(*args, hk, ssd)
    torch.cuda.synchronize()
    dp = stale_agg_refresh_ref(*args, hp, ssd)
    assert bool(torch.isfinite(dk).all())
    np.testing.assert_allclose(dk.cpu().numpy(), dp.cpu().numpy(),
                               rtol=2e-4, atol=2e-4 * C)
    assert torch.equal(hk, hp)
    untouched = np.setdiff1d(np.arange(N), idx[act > 0])
    assert np.array_equal(hk.cpu().numpy()[untouched], h[untouched])


# (B, H, Hk, S, D, causal, window)
K4_SHAPES = [(16, 16, 8, 256, 128, True, 0), (32, 16, 8, 256, 128, True, 0),
             (2, 4, 4, 100, 64, True, 0), (3, 4, 2, 130, 64, True, 48),
             (1, 2, 1, 257, 128, True, 0), (2, 2, 2, 70, 32, False, 0),
             (1, 3, 1, 64, 200, True, 0)]


@pytest.mark.parametrize("B,H,Hk,S,D,causal,window", K4_SHAPES)
def test_flash_attention_kernel(cuda, B, H, Hk, S, D, causal, window):
    rng = np.random.default_rng(S + D + H)
    q = torch.tensor(rng.normal(size=(B, H, S, D)).astype(np.float32),
                     device=cuda)
    k, v = (torch.tensor(rng.normal(size=(B, Hk, S, D)).astype(np.float32),
                         device=cuda) for _ in range(2))
    before = launch_counts["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention"] == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)


def _scan_inputs(Bsz, S, di, N, G, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    dt = np.logaddexp(f(Bsz, S, di) - 1, 0).astype(np.float32)
    return (f(Bsz, S, di), dt, f(Bsz, S, N), f(Bsz, S, N),
            (-np.exp(f(G, di, N))).astype(np.float32), f(G, di))


# (Bsz, S, di, N, G): the cohort (4 clients x 4 rows, per-client A and D),
# the loss probe, the evaluation, and ragged di / S / N
K5_SHAPES = [(16, 256, 8192, 16, 4), (32, 256, 8192, 16, 1),
             (16, 256, 8192, 16, 1), (2, 100, 200, 16, 1),
             (3, 17, 33, 8, 3), (4, 40, 130, 4, 2), (2, 9, 64, 40, 1)]


@pytest.mark.parametrize("Bsz,S,di,N,G", K5_SHAPES)
def test_selective_scan_kernel(cuda, Bsz, S, di, N, G):
    u, dt, B, C, A, D = (torch.tensor(a, device=cuda) for a in
                         _scan_inputs(Bsz, S, di, N, G, seed=S + di))
    before = launch_counts["selective_scan"]
    y = ss.selective_scan(u, dt, B, C, A, D)
    torch.cuda.synchronize()
    assert launch_counts["selective_scan"] == before + 1
    want = selective_scan_ref(u, dt, B, C, A, D)
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_refuse_bad_operands(cuda):
    G = torch.zeros(4, 10, device=cuda)
    with pytest.raises(TypeError):
        bd.batched_dot(G.double(), G.double())
    with pytest.raises(ValueError):
        bd.batched_dot(G, torch.zeros(4, 11, device=cuda))
    h = torch.zeros(6, 10, device=cuda)
    z = torch.zeros(4, device=cuda)
    idx = torch.arange(4, device=cuda)
    with pytest.raises(ValueError):
        sa.stale_agg_refresh(z, z, z, idx, G, h.t(), torch.zeros(10,
                                                                 device=cuda))
    with pytest.raises(ValueError):
        sa.stale_agg_refresh(z, z, z, idx, G, h, torch.zeros(10))
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.transpose(2, 3), q.transpose(2, 3))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :1].cpu(), q[:, :1].cpu())
    u, dt, B, C, A, D = (torch.tensor(a, device=cuda) for a in
                         _scan_inputs(2, 8, 16, 4, 1, seed=0))
    with pytest.raises(TypeError):
        ss.selective_scan(u.double(), dt.double(), B, C, A, D)
    with pytest.raises(ValueError):
        ss.selective_scan(u, dt, B.transpose(0, 1).contiguous()
                          .transpose(0, 1), C, A, D)
    with pytest.raises(ValueError):
        ss.selective_scan(u, dt, B, C, A[0, :, :3], D)


def test_round_on_the_card_matches_the_cpu(cuda):
    """One stalevre round of the small CNN world on the card (kernels)
    against the same round on the CPU (plain versions): same draws,
    metrics within rtol 1e-4."""
    from repro_torch.core.engine import RoundEngine, ServerConfig
    from repro_torch.fl.experiments import build_setting
    out = {}
    for dev in ("cpu", "cuda"):
        tasks, B, avail = build_setting(n_models=2, n_clients=16, small=True)
        eng = RoundEngine(tasks, B, avail,
                          ServerConfig(method="stalevre", local_epochs=2,
                                       seed=1), device=dev)
        state = eng.init_state()
        for _ in range(2):
            state, mets = eng.round_step(state)
        out[dev] = {k: v.cpu().numpy() for k, v in mets.items()}
    assert np.array_equal(out["cpu"]["active"], out["cuda"]["active"])
    for k in ("H1", "Zp", "Zl", "loss", "beta"):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_model_world_round_on_the_card_matches_the_cpu(cuda):
    """Two stalevre rounds of the real-model world (``_model_cfg`` dims) on
    the card (all four kernels, cohort local SGD through vmap(grad) of K4
    and K5) against the same rounds on the CPU (plain versions): same
    draws, metrics within rtol 1e-4, atol 1e-5."""
    from repro_torch.core.engine import RoundEngine, ServerConfig
    from repro_torch.fl.experiments import build_model_setting
    out, counts = {}, {}
    for dev in ("cpu", "cuda"):
        tasks, B, avail = build_model_setting()
        eng = RoundEngine(tasks, B, avail,
                          ServerConfig(method="stalevre", local_epochs=1,
                                       batch_size=4, active_rate=0.5),
                          device=dev)
        before = dict(launch_counts)
        state = eng.init_state()
        for _ in range(2):
            state, mets = eng.round_step(state)
        counts[dev] = {k: launch_counts[k] - before[k] for k in before}
        out[dev] = {k: v.cpu().numpy() for k, v in mets.items()}
    assert not any(counts["cpu"].values())
    assert all(n > 0 for n in counts["cuda"].values()), counts["cuda"]
    assert np.array_equal(out["cpu"]["active"], out["cuda"]["active"])
    for k in ("H1", "Zp", "Zl", "loss", "beta"):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
