"""The port's ``flash_attention`` (K4) and ``flash_gqa`` on the CPU against
the reference's Pallas kernel in interpret mode and its oracles.

On the CPU the wrappers run their plain versions (``ref.py``); the Hopper
kernel itself is held against those plain versions on the card by
``tests/test_torch_cuda.py``.  Tolerances:

  forward           rtol 2e-3, atol 2e-3 (the reference's kernel bound,
                    ``tests/test_kernels.py``: online softmax vs the
                    materialized one)
  gradients         rtol 1e-4, atol 1e-4 (the reference's own bound for
                    ``flash_gqa`` gradients: both backwards differentiate
                    the materialized-softmax GQA reference, in two
                    frameworks)
  vmap rule         rtol 1e-6, atol 1e-6 (the same f32 arithmetic on the
                    same rows, batched or one client at a time)

Inputs are drawn with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jflash
from repro.kernels.flash_attention.ops import _gqa_ref as jgqa_ref
from repro.kernels.flash_attention.ops import flash_gqa as jflash_gqa
from repro.kernels.flash_attention.ref import attention_ref as jattn_ref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention as tflash
from repro_torch.kernels.flash_attention.ref import attention_ref, gqa_ref

FWD = dict(rtol=2e-3, atol=2e-3)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# (B, H, S, D, causal, window): the reference kernel test's grid, with S
# tails that are not a multiple of a 64-row tile
@pytest.mark.parametrize("B,H,S,D,causal,window", [
    (1, 2, 256, 64, True, 0), (2, 1, 128, 128, True, 64),
    (1, 1, 130, 60, False, 0), (1, 2, 100, 96, True, 40),
    (1, 1, 64, 128, True, 0)])
def test_flash_attention_vs_pallas_interpret(B, H, S, D, causal, window):
    rng = np.random.default_rng(S + D)
    q, k, v = (_normal(rng, B, H, S, D) for _ in range(3))
    got = tflash(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                 causal=causal, window=window).numpy()
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **FWD)
    oracle = jattn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), **FWD)


def test_flash_attention_indexes_grouped_kv_heads():
    """k/v with Hk < H heads: query head h reads KV head h // (H // Hk),
    the same function as repeating the KV heads."""
    rng = np.random.default_rng(3)
    q = torch.tensor(_normal(rng, 2, 4, 40, 32))
    k, v = (torch.tensor(_normal(rng, 2, 2, 40, 32)) for _ in range(2))
    got = tflash(q, k, v, causal=True)
    want = attention_ref(q, k.repeat_interleave(2, 1),
                         v.repeat_interleave(2, 1), causal=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("Hq,Hk,window", [(2, 2, 0), (4, 2, 0), (4, 1, 0),
                                          (4, 4, 16)])
def test_flash_gqa_and_grad_vs_pallas_interpret(Hq, Hk, window):
    """Model layout [B,S,H,dh] with grouped KV: forward, and the gradient
    of sum(sin(out)) against ``jax.grad`` through the reference's
    ``flash_gqa`` (interpret mode; its backward is the GQA oracle's)."""
    rng = np.random.default_rng(Hq * 10 + Hk + window)
    B, S, dh = 2, 48, 32
    q = _normal(rng, B, S, Hq, dh)
    k, v = _normal(rng, B, S, Hk, dh), _normal(rng, B, S, Hk, dh)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    targs = [torch.tensor(a) for a in (q, k, v)]

    out = tops.flash_gqa(*targs, causal=True, window=window)
    want = jflash_gqa(*jargs, causal=True, window=window, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD)

    def tloss(q_, k_, v_):
        return torch.sin(tops.flash_gqa(q_, k_, v_, True, window)).sum()

    def jloss(q_, k_, v_):
        return jnp.sum(jnp.sin(jflash_gqa(q_, k_, v_, causal=True,
                                          window=window, interpret=True)))

    tg = torch.func.grad(tloss, argnums=(0, 1, 2))(*targs)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


def test_flash_gqa_backward_is_the_plain_gqa_vjp():
    """With one cotangent, the Function's backward equals autograd through
    the plain GQA version (the same function), and the reference's vjp of
    its own GQA oracle within the gradient bound."""
    rng = np.random.default_rng(9)
    B, S, Hq, Hk, dh = 1, 32, 4, 2, 32
    q, k, v = (_normal(rng, B, S, Hq, dh), _normal(rng, B, S, Hk, dh),
               _normal(rng, B, S, Hk, dh))
    ct = _normal(rng, B, S, Hq, dh)
    targs = [torch.tensor(a) for a in (q, k, v)]
    _, vjp_k = torch.func.vjp(lambda *a: tops.flash_gqa(*a), *targs)
    _, vjp_r = torch.func.vjp(lambda *a: gqa_ref(*a), *targs)
    for a, b in zip(vjp_k(torch.tensor(ct)), vjp_r(torch.tensor(ct))):
        assert torch.equal(a, b)
    _, vjp_j = jax.vjp(lambda *a: jgqa_ref(*a, True, 0),
                       *(jnp.asarray(a) for a in (q, k, v)))
    for a, b in zip(vjp_k(torch.tensor(ct)), vjp_j(jnp.asarray(ct))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


def test_vmap_grad_folds_clients_into_the_batch_axis(monkeypatch):
    """``vmap(grad(loss))`` over a cohort through ``flash_gqa`` == the
    per-client loop, and the forward reaches the kernel wrapper ONCE for
    the cohort, with the clients folded into its batch axis."""
    rng = np.random.default_rng(5)
    A, B, S, Hq, Hk, dh = 3, 2, 24, 4, 2, 16
    q = torch.tensor(_normal(rng, A, B, S, Hq, dh))
    k = torch.tensor(_normal(rng, A, B, S, Hk, dh))
    v = torch.tensor(_normal(rng, A, B, S, Hk, dh))
    w = torch.tensor(_normal(rng, A, dh))          # a per-client parameter

    def loss(w_, q_, k_, v_):
        return torch.sin(tops.flash_gqa(q_ * w_, k_, v_, True, 0)).sum()

    calls = []
    real = tops.flash_attention

    def spy(q_, k_, v_, **kw):
        calls.append(tuple(q_.shape))
        return real(q_, k_, v_, **kw)

    monkeypatch.setattr(tops, "flash_attention", spy)
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(w, q, k, v)
    assert calls == [(A * B, Hq, S, dh)]
    for i in range(A):
        want = torch.func.grad(loss, argnums=(0, 1))(w[i], q[i], k[i], v[i])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)
    # a vmap with unbatched operands broadcasts them across the cohort
    out = torch.func.vmap(lambda q_: tops.flash_gqa(q_, k[0], v[0]))(q)
    np.testing.assert_allclose(
        out.numpy(), torch.stack([gqa_ref(q[i], k[0], v[0])
                                  for i in range(A)]).numpy(),
        rtol=1e-6, atol=1e-6)


def test_cpu_wrappers_take_plain_versions_and_check_shapes():
    before = dict(launch_counts)
    q = torch.zeros(1, 4, 8, 16)
    tflash(q, q[:, :2], q[:, :2])
    tops.flash_gqa(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    assert dict(launch_counts) == before
    with pytest.raises(ValueError):
        tflash(q, q[:, :3], q[:, :3])          # 4 heads over 3 KV heads
    with pytest.raises(ValueError):
        tflash(q, q, q[:, :, :4])
