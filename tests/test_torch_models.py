"""The port's real-model stack (``repro_torch.models`` and the configs) on
the CPU against the reference's, for qwen3-0.6b and falcon-mamba-7b at
``_model_cfg`` dims.

Parameters are drawn by the reference and carried across leaf by leaf
(``jax_leaves`` of the port's adapter: the same paths, no layout change);
tokens come from numpy.  The reference runs its CPU paths (``_chunk_attend``
and the chunked associative scan), the port its plain kernel versions, so
the two differ in summation order only.  Tolerances:

  loss              rtol 1e-5, atol 1e-5
  logits            rtol 1e-4, atol 1e-5
  gradients         rtol 1e-4, atol 1e-6 (per leaf; f32 in another order,
                    through two layers)
  layers            rtol 1e-5, atol 1e-6
  init              uniform leaves bitwise (the same threefry draws);
                    the normal embedding, mamba's log(expm1(.)) dt bias
                    and its log(1..N) A_log at rtol 1e-5, atol 1e-6
                    (erfinv / expm1 / log
                    implementations; worst seen 3.9e-7 absolute on the
                    0.02-scaled embedding)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.fl import experiments as jexp
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import transformer as jtf
from repro_torch import convert, prng
from repro_torch.configs import registry as treg
from repro_torch.fl import experiments as texp
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttf

ARCHS = ["qwen3-0.6b", "falcon-mamba-7b"]


def _port_params(jtree, adapter):
    """A reference parameter tree -> the port adapter's flat leaf dict."""
    return {name: torch.tensor(np.asarray(convert._get(jtree, path)))
            for name, (path, change) in adapter.jax_leaves.items()
            if change is None}


def _tokens(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_reference(name):
    """The port's published numbers are the reference's, field by field,
    and so is ``_model_cfg``; the analytic parameter count matches the
    port's init (drawn on the meta device: shapes only)."""
    assert dataclasses.asdict(treg.get_config(name)) == \
        dataclasses.asdict(jreg.get_config(name))
    assert dataclasses.asdict(texp._model_cfg(name)) == \
        dataclasses.asdict(jexp._model_cfg(name))
    for cfg in (treg.get_config(name), texp._model_cfg(name)):
        cut = dataclasses.replace(cfg, n_layers=1)
        params = texp._arch_adapter(cut).init(prng.PRNGKey(0, "meta"))
        assert sum(v.numel() for v in params.values()) == cut.param_count()


@pytest.mark.parametrize("name", ARCHS)
def test_init_matches_reference(name):
    cfg = texp._model_cfg(name)
    with jax.threefry_partitionable(False):
        want = jtf.init(jax.random.PRNGKey(3), jexp._model_cfg(name))
    adapter = texp._arch_adapter(cfg)
    got = adapter.init(prng.PRNGKey(3))
    assert set(got) == set(adapter.jax_leaves)
    for leaf, (path, _) in adapter.jax_leaves.items():
        w = np.asarray(convert._get(want, path))
        g = got[leaf].numpy()
        assert g.shape == w.shape, leaf
        if leaf in ("embed.w", "blocks.mamba.dt_bias", "blocks.mamba.A_log"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=leaf)
        else:
            assert np.array_equal(g, w), leaf


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_and_grads_match_reference(name):
    """``transformer.forward``/``logits`` and the gradient of the loss over
    every leaf, from the reference's parameters carried across."""
    jcfg, tcfg = jexp._model_cfg(name), texp._model_cfg(name)
    adapter = texp._arch_adapter(tcfg)
    with jax.threefry_partitionable(False):
        jparams = jtf.init(jax.random.PRNGKey(1), jcfg)
    tparams = _port_params(jparams, adapter)
    toks = _tokens(tcfg)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"x": torch.tensor(toks)}

    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.forward(p, jcfg, jbatch)[0])(jparams)
    tloss = adapter.loss_fn(tparams, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    jlogits = jtf.logits(jparams, jcfg, jbatch)
    tlogits = ttf.logits(texp._unflatten(tparams), tcfg,
                         {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    tgrads = torch.func.grad(adapter.loss_fn)(tparams, tbatch)
    for leaf, (path, _) in adapter.jax_leaves.items():
        np.testing.assert_allclose(
            tgrads[leaf].numpy(), np.asarray(convert._get(jgrads, path)),
            rtol=1e-4, atol=1e-6, err_msg=f"{name} grad {leaf}")
    acc = jnp.mean(jnp.argmax(jlogits[:, :-1], -1) == jbatch["tokens"][:, 1:])
    assert float(adapter.accuracy(tparams, tbatch)) == pytest.approx(
        float(acc), abs=1e-6)


def test_layers_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    pos = np.arange(6)
    close = lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    close(tlayers.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x)),
          jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    close(tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    w = {k: rng.normal(size=s).astype(np.float32) for k, s in
         (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    close(tlayers.mlp({k: torch.tensor(v) for k, v in w.items()},
                      torch.tensor(x)),
          jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                      jnp.asarray(x)))
    logits = rng.normal(size=(4, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 5))
    close(tlayers.cross_entropy(torch.tensor(logits), torch.tensor(labels)),
          jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))


def test_mamba_block_with_cache_matches_reference():
    """``mamba(return_cache=True)`` (the plain chunked scan) and the kernel
    path (``return_cache=False``) against the reference's block, decode
    cache included."""
    cfg = texp._model_cfg("falcon-mamba-7b")
    with jax.threefry_partitionable(False):
        jp = jmamba.mamba_init(jax.random.PRNGKey(4), jexp._model_cfg(
            "falcon-mamba-7b"))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(6).normal(size=(2, 10, cfg.d_model)) \
        .astype(np.float32) * 0.5
    jout, jcache = jmamba.mamba(jp, jexp._model_cfg("falcon-mamba-7b"),
                                jnp.asarray(x), return_cache=True)
    tout, tcache = tmamba.mamba(tp, cfg, torch.tensor(x), return_cache=True)
    tout_k = tmamba.mamba(tp, cfg, torch.tensor(x))
    for got in (tout, tout_k):
        np.testing.assert_allclose(got.numpy(), np.asarray(jout), rtol=1e-4,
                                   atol=1e-5)
    assert np.array_equal(tcache["conv"].numpy(), np.asarray(jcache["conv"]))
    np.testing.assert_allclose(tcache["ssm"].numpy(),
                               np.asarray(jcache["ssm"]), rtol=1e-4,
                               atol=1e-5)


def test_unported_families_raise():
    cfg = dataclasses.replace(texp._model_cfg("qwen3-0.6b"), family="moe")
    with pytest.raises(NotImplementedError, match="moe"):
        ttf.init(prng.PRNGKey(0, "meta"), cfg)
    with pytest.raises(KeyError):
        treg.get_config("llama4-scout-17b-a16e")
