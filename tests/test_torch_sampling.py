"""Per-module parity of the port's sampler math, monitors, aggregation and
stale-store helpers with ``repro.core`` on the same numpy inputs.

Tolerance: rtol 1e-6 / atol 1e-7 (f32 arithmetic in another order); the
participation draws are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import convergence as jconv
from repro.core import sampling as jsamp
from repro.core import stale as jstale
from repro_torch import prng
from repro_torch.core import aggregation as tagg
from repro_torch.core import convergence as tconv
from repro_torch.core import sampling as tsamp
from repro_torch.core import stale as tstale

RTOL, ATOL = 1e-6, 1e-7
t = lambda a: torch.tensor(np.array(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def world(seed, N=24, S=3):
    rng = np.random.default_rng(seed)
    losses = rng.uniform(0.1, 3.0, (N, S)).astype(np.float32)
    avail = rng.uniform(size=(N, S)) > 0.15
    counts = rng.integers(2, 140, (N, S)).astype(np.float32)
    counts = np.where(avail, counts, 0.0)
    d = (counts / counts.sum(0, keepdims=True)).astype(np.float32)
    B = rng.integers(1, S + 1, N)
    return losses, avail, d, B


def test_processor_budget_utilities():
    losses, _, _, B = world(0)
    want = jsamp.processor_budget_utilities(jnp.asarray(losses), B)
    got = tsamp.processor_budget_utilities(t(losses), B)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m", [1.5, 4.0, 9.7, 1000.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_waterfilling(seed, m):
    rng = np.random.default_rng(seed)
    U = rng.uniform(size=(40, 3)).astype(np.float32)
    U[rng.uniform(size=U.shape) < 0.2] = 0.0
    U[:, 0] *= 10.0           # heavy rows saturate
    close(tsamp.solve_waterfilling(t(U), m),
          jsamp.solve_waterfilling(jnp.asarray(U), m))


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_waterfilling_capped(seed):
    rng = np.random.default_rng(seed)
    U = rng.uniform(size=(30, 3)).astype(np.float32)
    eta = rng.uniform(0.2, 1.0, 30).astype(np.float32)
    close(tsamp.solve_waterfilling_capped(t(U), 6.0, t(eta)),
          jsamp.solve_waterfilling_capped(jnp.asarray(U), 6.0,
                                          jnp.asarray(eta)))
    # eta == 1 is the uncapped solve
    close(tsamp.solve_waterfilling_capped(t(U), 6.0, torch.ones(30)),
          tsamp.solve_waterfilling(t(U), 6.0))


@pytest.mark.parametrize("eta", [None, 0.6])
@pytest.mark.parametrize("seed", [0, 1])
def test_lvr_probabilities(seed, eta):
    losses, avail, d, B = world(seed)
    m = float(np.float32(0.1) * np.float32(B.sum()))
    j_eta = None if eta is None else jnp.full((len(B),), eta, jnp.float32)
    t_eta = None if eta is None else torch.full((len(B),), eta)
    want = jsamp.lvr_probabilities(jnp.asarray(losses), jnp.asarray(d),
                                   jnp.asarray(B), jnp.asarray(avail), m,
                                   eta=j_eta)
    got = tsamp.lvr_probabilities(t(losses), t(d), B, t(avail), m, eta=t_eta)
    close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_probabilities(seed):
    _, avail, d, B = world(seed)
    m = float(np.float32(0.3) * np.float32(B.sum()))
    close(tsamp.random_probabilities(t(d), B, t(avail), m),
          jsamp.random_probabilities(jnp.asarray(d), B, jnp.asarray(avail),
                                     m))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_assignment_exact(seed):
    losses, avail, d, B = world(seed)
    p = np.asarray(jsamp.lvr_probabilities(
        jnp.asarray(losses), jnp.asarray(d), jnp.asarray(B),
        jnp.asarray(avail), 8.0))
    with jax.threefry_partitionable(False):
        want = np.asarray(jsamp.sample_assignment(jax.random.PRNGKey(seed),
                                                  jnp.asarray(p)))
    got = tsamp.sample_assignment(prng.PRNGKey(seed), t(p)).numpy()
    assert got.sum() > 0
    assert np.array_equal(got, want)


def test_ordered_sum_is_sequential():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=500) * 10.0 ** rng.integers(-4, 4, 500)
         ).astype(np.float32)
    seq = np.float32(0.0)
    for v in x:
        seq = np.float32(seq + v)
    assert tconv.ordered_sum(t(x)).item() == seq
    assert tconv.ordered_sum(t(x)).item() == float(
        jconv.ordered_sum(jnp.asarray(x)))


def test_round_metrics():
    rng = np.random.default_rng(3)
    V = 50
    coeffs = np.where(rng.uniform(size=V) < 0.2, rng.uniform(0, 4, V),
                      0).astype(np.float32)
    lv = rng.uniform(0.1, 3, V).astype(np.float32)
    dv = rng.uniform(0, 0.05, V).astype(np.float32)
    Bv = rng.integers(1, 4, V).astype(np.float32)
    want = jconv.round_metrics(*(jnp.asarray(a) for a in (coeffs, lv, dv,
                                                          Bv)))
    got = tconv.round_metrics(*(t(a) for a in (coeffs, lv, dv, Bv)))
    for k in ("H1", "Zp", "Zl"):
        close(got[k], want[k])


def test_unbiased_coeffs():
    rng = np.random.default_rng(4)
    V = 40
    d = rng.uniform(0, 0.1, V).astype(np.float32)
    B = rng.integers(1, 4, V).astype(np.float32)
    p = rng.uniform(0, 1, V).astype(np.float32)
    p[::7] = 0.0
    act = (rng.uniform(size=V) < 0.3).astype(np.float32)
    close(tagg.unbiased_coeffs(t(d), t(B), t(p), t(act)),
          jagg.unbiased_coeffs(*(jnp.asarray(a) for a in (d, B, p, act))))


def test_stale_delta_onedot():
    rng = np.random.default_rng(5)
    N, A, P = 12, 5, 70
    h = rng.normal(size=(N, P)).astype(np.float32)
    idx = rng.choice(N, A, replace=False)
    G = rng.normal(size=(A, P)).astype(np.float32)
    coeffs = rng.uniform(0, 2, A).astype(np.float32)
    beta = rng.uniform(0, 1, A).astype(np.float32)
    w = rng.uniform(0, 0.1, N).astype(np.float32)
    want = jagg.stale_delta_onedot(jnp.asarray(coeffs), jnp.asarray(G),
                                   jnp.asarray(h[idx]), jnp.asarray(beta),
                                   jnp.asarray(h), jnp.asarray(w))
    got = tagg.stale_delta_onedot(t(coeffs), t(G), t(h[idx]), t(beta), t(h),
                                  t(w))
    close(got, want)
    # aggregate/apply_delta are w - sum and w - delta
    wts = rng.normal(size=P).astype(np.float32)
    close(tagg.apply_delta(t(wts), got),
          jagg.apply_delta(jnp.asarray(wts), jnp.asarray(got.numpy())))


def test_optimal_beta():
    rng = np.random.default_rng(6)
    G = rng.normal(size=(6, 300)).astype(np.float32)
    h = rng.normal(size=(6, 300)).astype(np.float32)
    h[2] = 0.0                                    # no stored update: beta 0
    want = jstale.optimal_beta(jnp.asarray(G), jnp.asarray(h))
    got = tstale.optimal_beta(t(G), t(h))
    close(got, want)
    assert got[2].item() == 0.0


def _beta_state(rng, n):
    bh = rng.uniform(0.5, 1, n).astype(np.float32)
    bl = rng.uniform(0, 1, n).astype(np.float32)
    th = rng.integers(0, 6, n).astype(np.float32)
    tl = np.maximum(th - rng.integers(0, 4, n), 0).astype(np.float32)
    return bh, bl, th, tl


@pytest.mark.parametrize("tau", [0.0, 3.0, 9.0])
def test_estimate_and_update_beta(tau):
    rng = np.random.default_rng(7)
    n = 20
    fields = _beta_state(rng, n)
    jst = jstale.BetaState(*(jnp.asarray(f) for f in fields))
    tst = tstale.BetaState(*(t(f) for f in fields))
    close(tstale.estimate_beta(tst, torch.tensor(tau)),
          jstale.estimate_beta(jst, jnp.float32(tau)))
    active = (rng.uniform(size=n) < 0.4).astype(np.float32)
    measured = rng.uniform(-0.2, 1.3, n).astype(np.float32)
    want = jstale.update_beta_state(jst, jnp.asarray(active),
                                    jnp.asarray(measured), jnp.float32(tau))
    got = tstale.update_beta_state(tst, t(active), t(measured),
                                   torch.tensor(tau))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_flat_layout_views_and_flatten():
    tree = {"a.weight": torch.arange(6.0).reshape(2, 3),
            "a.bias": torch.tensor([7.0]), "b": torch.ones(2, 2)}
    lay = tstale.FlatLayout.of(tree)
    assert lay.P == 11
    flat = lay.flatten(tree)
    for k, v in lay.views(flat).items():
        assert torch.equal(v, tree[k])
    # views write through to the flat store
    lay.views(flat)["a.bias"].fill_(-1.0)
    assert flat[6].item() == -1.0
