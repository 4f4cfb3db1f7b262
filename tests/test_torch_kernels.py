"""The port's kernels against the reference's Pallas kernels (interpret
mode) and their oracles, at the bounds of the reference's kernel tests:

  batched_dot          rtol 2e-5, atol 2e-5 sqrt(P)
  stale_agg_refresh    delta rtol 2e-4, atol 2e-4 C; refreshed store and
                       untouched rows BITWISE

On the CPU the wrappers run their plain versions (``ref.py``); the Hopper
kernels themselves are held against those plain versions on the card by
``tests/test_torch_cuda.py``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batched_dot.batched_dot import batched_dot as jbd
from repro.kernels.batched_dot.ops import optimal_beta_pallas
from repro.kernels.batched_dot.ref import batched_dot_ref as jbd_ref
from repro.kernels.stale_agg.ref import stale_agg_refresh_ref as jsa_ref
from repro.kernels.stale_agg.stale_agg import stale_agg_refresh as jsa
from repro_torch.kernels import launch_counts
from repro_torch.kernels.batched_dot import batched_dot as tbd_mod
from repro_torch.kernels.batched_dot import ops as tbd_ops
from repro_torch.kernels.stale_agg import stale_agg as tsa_mod


def _k1_inputs(C, P, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C, P)).astype(np.float32),
            rng.normal(size=(C, P)).astype(np.float32))


def _k1_close(got, want, P):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5 * math.sqrt(P))


# P tails: not a multiple of 128, of the Pallas block, or of BLOCK=1024
K1_SHAPES = [(3, 1000), (5, 4096), (2, 1), (4, 1025)]


@pytest.mark.parametrize("C,P", K1_SHAPES)
def test_batched_dot_plain_vs_pallas_interpret(C, P):
    G, h = _k1_inputs(C, P)
    jd, jn = jbd(jnp.asarray(G), jnp.asarray(h), interpret=True)
    td, tn = tbd_mod.batched_dot(torch.tensor(G), torch.tensor(h))
    _k1_close(td, jd, P)
    _k1_close(tn, jn, P)
    rd, rn = jbd_ref(jnp.asarray(G), jnp.asarray(h))
    _k1_close(td, rd, P)
    _k1_close(tn, rn, P)


def test_optimal_beta_op_vs_pallas_op():
    """The op over a flattened cohort == the reference op over the same
    cohort as a pytree; a zero store row gives beta 0."""
    rng = np.random.default_rng(1)
    C = 4
    tree_G = {"a": rng.normal(size=(C, 3, 5)).astype(np.float32),
              "b": rng.normal(size=(C, 7)).astype(np.float32)}
    tree_h = {"a": rng.normal(size=(C, 3, 5)).astype(np.float32),
              "b": rng.normal(size=(C, 7)).astype(np.float32)}
    tree_h["a"][1], tree_h["b"][1] = 0.0, 0.0
    want = optimal_beta_pallas({k: jnp.asarray(v) for k, v in tree_G.items()},
                               {k: jnp.asarray(v) for k, v in tree_h.items()},
                               interpret=True)
    flat = lambda tr: torch.tensor(np.concatenate(
        [tr[k].reshape(C, -1) for k in sorted(tr)], axis=1))
    got = tbd_ops.optimal_beta(flat(tree_G), flat(tree_h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert got[1].item() == 0.0


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


def _run_port(coeff, beta, act, idx, G, h, ss):
    ht = torch.tensor(h)
    delta = tsa_mod.stale_agg_refresh(*(torch.tensor(a) for a in
                                        (coeff, beta, act, idx, G)), ht,
                                      torch.tensor(ss))
    return delta.numpy(), ht.numpy()


# (C, N, P): a cohort, the needs-all case C == N, and P tails
K2_SHAPES = [(4, 9, 1000), (9, 9, 300), (3, 7, 1), (6, 20, 2049)]


@pytest.mark.parametrize("C,N,P", K2_SHAPES)
def test_stale_agg_refresh_plain_vs_pallas_interpret(C, N, P):
    coeff, beta, act, idx, G, h, ss = _k2_inputs(C, N, P)
    jdelta, jstore = jsa(*(jnp.asarray(a) for a in (coeff, beta, act, idx, G,
                                                    h, ss)), interpret=True)
    rdelta, rstore = jsa_ref(*(jnp.asarray(a) for a in (coeff, beta, act, idx,
                                                        G, h, ss)))
    delta, store = _run_port(coeff, beta, act, idx, G, h, ss)
    for want in (jdelta, rdelta):
        np.testing.assert_allclose(delta, np.asarray(want), rtol=2e-4,
                                   atol=2e-4 * C)
    # the refreshed store is bitwise, and so are the rows left alone
    assert np.array_equal(store, np.asarray(jstore))
    assert np.array_equal(store, np.asarray(rstore))
    untouched = np.setdiff1d(np.arange(N), idx[act > 0])
    assert np.array_equal(store[untouched], h[untouched])


def test_stale_agg_refresh_nan_padding_slot_adds_nothing():
    """A cohort padding slot (coeff 0, act 0) whose G row is NaN is selected
    out: delta == the delta without that slot, and its store row stays."""
    C, N, P = 5, 8, 257
    coeff, beta, act, idx, G, h, ss = _k2_inputs(C, N, P, seed=3)
    coeff[2], act[2] = 0.0, 0.0
    G[2] = np.nan
    delta, store = _run_port(coeff, beta, act, idx, G, h, ss)
    assert np.all(np.isfinite(delta))
    keep = np.arange(C) != 2
    want_delta, want_store = jsa_ref(*(jnp.asarray(a[keep]) for a in
                                       (coeff, beta, act, idx, G)),
                                     jnp.asarray(h), jnp.asarray(ss))
    np.testing.assert_allclose(delta, np.asarray(want_delta), rtol=2e-4,
                               atol=2e-4 * C)
    assert np.array_equal(store, np.asarray(want_store))
    assert np.array_equal(store[idx[2]], h[idx[2]])


def test_ops_dispatch_on_cpu_takes_plain_versions():
    """CPU tensors never reach a kernel: the launch counts stay put."""
    before = dict(launch_counts)
    coeff, beta, act, idx, G, h, ss = _k2_inputs(3, 5, 64)
    ht = torch.tensor(h)
    tsa_mod.stale_agg_refresh(*(torch.tensor(a) for a in
                                (coeff, beta, act, idx, G)), ht,
                              torch.tensor(ss))
    tbd_ops.optimal_beta(torch.tensor(G), torch.tensor(G))
    assert dict(launch_counts) == before


def test_batched_dot_launch_shape():
    for P in (1, 1000, 1024, 1025, 103018, 10 ** 7):
        split, chunk = tbd_mod.launch_shape(P)
        assert 1 <= split <= tbd_mod.MAX_SPLIT
        assert chunk % tbd_mod.BLOCK == 0 and split * chunk >= P
        assert (split - 1) * chunk < P              # no chunk is empty
