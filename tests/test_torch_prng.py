"""The port's threefry draws are bit-identical to ``jax.random`` in the
``jax_threefry_partitionable=False`` layout (the layout in which the
reference's goldens reproduce).  Every reference value is built inside the
scoped flag, never by flipping it for the process."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as jsampling
from repro_torch import prng
from repro_torch.core import sampling as tsampling

SEEDS = [0, 1, 42, 2 ** 31 - 1]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.PRNGKey(seed))
    assert np.array_equal(_u32(prng.PRNGKey(seed)), want)


@pytest.mark.parametrize("num", [2, 3, 7, 16])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_split(seed, num):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    assert np.array_equal(_u32(prng.split(prng.PRNGKey(seed), num)), want)


def test_split_batched_keys():
    """A batch of keys splits row by row, as ``vmap(split)``."""
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(3), 5)
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 4))(keys))
    tkeys = prng.split(prng.PRNGKey(3), 5)
    assert np.array_equal(_u32(prng.split(tkeys, 4)), want)


@pytest.mark.parametrize("data", [0, 1, 17, 123456, 2 ** 32 - 1])
def test_fold_in(data):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(9),
                                             np.uint32(data)))
    assert np.array_equal(_u32(prng.fold_in(prng.PRNGKey(9), data)), want)


@pytest.mark.parametrize("shape", [(), (1,), (3,), (4, 5), (3, 3, 1, 8)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.3, 0.3),
                                    (-1 / 24, 1 / 24)])
def test_uniform(shape, bounds):
    lo, hi = bounds
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(11), shape,
                                             jnp.float32, lo, hi))
    got = prng.uniform(prng.PRNGKey(11), shape, lo, hi).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("span", [1, 5, 7, 16, 143, 100000])
def test_randint(span):
    """Span 1, small spans, spans that are not a power of 2, and one past
    2^16 (where the multiplier wraps in uint32)."""
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (32,),
                                             0, span))
    got = prng.randint(prng.PRNGKey(5), (32,), 0, span).numpy()
    assert np.array_equal(got, want)


def test_randint_batched_like_the_engine():
    """The local-SGD minibatch draw: per-client keys, per-client maxval
    max(count, 1), as ``vmap(randint)`` over clients."""
    counts = np.array([0, 1, 5, 17, 143, 2, 9, 64], np.int32)
    with jax.threefry_partitionable(False):
        keys = jsampling.index_keys(jax.random.PRNGKey(2), len(counts))
        step_keys = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        want = np.asarray(jax.vmap(lambda k, c: jax.random.randint(
            k, (16,), 0, jnp.maximum(c, 1)))(step_keys[:, 1],
                                              jnp.asarray(counts)))
    tkeys = tsampling.index_keys(prng.PRNGKey(2), len(counts))
    tstep = prng.split(tkeys, 3)
    got = prng.randint(tstep[:, 1], (16,), 0,
                       torch.as_tensor(counts).long().clamp_min(1)[:, None])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [21, 22])
@pytest.mark.parametrize("n", [1, 10, 230])
def test_index_keys_and_uniform(n, seed):
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(seed)
        want_k = np.asarray(jsampling.index_keys(key, n))
        want_u = np.asarray(jsampling.index_uniform(key, n))
    tkey = prng.PRNGKey(seed)
    assert np.array_equal(_u32(tsampling.index_keys(tkey, n)), want_k)
    assert np.array_equal(tsampling.index_uniform(tkey, n).numpy(), want_u)


def test_normal_close():
    """``normal`` is the inverse-erf transform of the same uniform bits;
    only the erfinv implementations' rounding differs."""
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (16, 4)))
    got = prng.normal(prng.PRNGKey(4), (16, 4)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
