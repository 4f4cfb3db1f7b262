"""The port's Hopper kernels on the card, against their plain versions.

Every test here needs a CUDA GPU and skips without one.  The file imports
neither JAX nor the reference package, so it also runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference kernel tests': batched_dot rtol 2e-5, atol
2e-5 sqrt(P); stale_agg_refresh delta rtol 2e-4, atol 2e-4 C, the
refreshed store bitwise."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.batched_dot import batched_dot as bd
from repro_torch.kernels.batched_dot.ref import batched_dot_ref
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
