"""Model assembly for the ``dense`` and ``ssm`` families, the port of
``repro.models.transformer`` (training path).

Parameters are the reference's nested dict of tensors, with the blocks
stacked on a leading L axis; the layer loop indexes that axis.  Entry
points:

- ``forward(params, cfg, batch)`` — training loss (mean next-token CE)
- ``logits(params, cfg, batch)``  — next-token logits, for evaluation

The ``moe``, ``hybrid``, ``vlm`` and ``audio`` families, and serving
(``prefill``, ``decode_step``), come with later slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers
from repro_torch.models import mamba as mamba_mod

FAMILIES = ("dense", "ssm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
            f"the port runs {FAMILIES}; moe, hybrid, vlm and audio come "
            f"with the slice that ports their layers")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(key, cfg: ArchConfig) -> Dict[str, Any]:
    ks = prng.split(key, 8)
    dev = key.device
    if cfg.family == "ssm":
        return {"norm": layers.rmsnorm_init(cfg.d_model, dev),
                "mamba": mamba_mod.mamba_init(ks[0], cfg)}
    return {"ln1": layers.rmsnorm_init(cfg.d_model, dev),
            "attn": attention.attn_init(ks[0], cfg),
            "ln2": layers.rmsnorm_init(cfg.d_model, dev),
            "mlp": layers.mlp_init(ks[2], cfg.d_model, cfg.d_ff)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init(key: torch.Tensor, cfg: ArchConfig) -> Dict[str, Any]:
    """Full model parameters on the key's device; blocks stacked on a
    leading L axis, drawn with the reference's threefry stream."""
    _check_family(cfg)
    k_embed, k_blocks, k_head, _ = prng.split(key, 4)
    block_keys = prng.split(k_blocks, cfg.n_layers)
    params = {
        "embed": layers.embed_init(k_embed, cfg.vocab_size, cfg.d_model),
        "blocks": _stack([_block_init(block_keys[i], cfg)
                          for i in range(cfg.n_layers)]),
        "final_norm": layers.rmsnorm_init(cfg.d_model, key.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": layers._uniform(
            k_head, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5)}
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_fwd(p, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    if cfg.family == "ssm":
        return x + mamba_mod.mamba(p["mamba"], cfg,
                                   layers.rmsnorm(p["norm"], x, cfg.norm_eps))
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attention.attention(p["attn"], cfg, h, positions)
    h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + layers.mlp(p["mlp"], h2)


def embed_inputs(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """x [B,S,d]: the token path (the vlm and audio frontends, and their
    loss masks, come with their families)."""
    return layers.embed(params["embed"], batch["tokens"])


def _head_logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final-norm'd hidden states -> vocab logits (tied or untied head)."""
    if cfg.tie_embeddings:
        return x @ params["embed"]["w"].T
    return x @ params["lm_head"]["w"]


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _trunk(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
           ) -> torch.Tensor:
    """Embed -> block loop -> final norm -> full logits [B, S, V]."""
    _check_family(cfg)
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x = _block_fwd(_index(params["blocks"], i), cfg, x, positions)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head_logits(params, cfg, x)


def forward(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (mean next-token CE loss, aux 0.0)."""
    full_logits = _trunk(params, cfg, batch)
    tgt = batch["tokens"]
    loss = layers.cross_entropy(full_logits[:, :-1], tgt[:, 1:])
    return loss, torch.zeros((), dtype=torch.float32, device=loss.device)


def logits(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
           ) -> torch.Tensor:
    """Full next-token logits over the tokens, [B, S, V]."""
    return _trunk(params, cfg, batch)
