"""Small CNN of the paper's §6.1 classifier: 2 conv + 2 pool + 2 linear,
the port of ``repro.models.cnn`` as plain functions on a parameter dict.

Layouts are PyTorch's: conv weights OIHW, linear weights [out, in],
activations NCHW.  The inputs stay NHWC ([B, 28, 28, C], the data layout
of both packages), and the activations are permuted back to NHWC before
the flatten so ``fc1`` sees its inputs in the reference's (h, w, c) order.
``JAX_LEAVES`` maps each leaf to its reference path and layout change
(``repro_torch.convert``)."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import prng

# port leaf -> (reference path, layout change from the reference's layout)
JAX_LEAVES = {
    "conv1.weight": (("conv1", "w"), "hwio_to_oihw"),
    "conv1.bias": (("conv1", "b"), None),
    "conv2.weight": (("conv2", "w"), "hwio_to_oihw"),
    "conv2.bias": (("conv2", "b"), None),
    "fc1.weight": (("fc1", "w"), "transpose"),
    "fc1.bias": (("fc1", "b"), None),
    "fc2.weight": (("fc2", "w"), "transpose"),
    "fc2.bias": (("fc2", "b"), None),
}


def init(key: torch.Tensor, n_classes: int, channels: int = 16,
         in_ch: int = 1) -> Dict[str, torch.Tensor]:
    """Random parameters from a threefry key, drawn exactly as the
    reference draws them (in its layouts, then permuted)."""
    k1, k2, k3, k4 = prng.split(key, 4)

    def conv_init(k, kh, kw, cin, cout):
        scale = 1.0 / math.sqrt(kh * kw * cin)
        hwio = prng.uniform(k, (kh, kw, cin, cout), -scale, scale)
        return hwio.permute(3, 2, 0, 1).contiguous()

    def dense_init(k, fan_in, fan_out):
        bound = 1 / math.sqrt(fan_in)
        return prng.uniform(k, (fan_in, fan_out), -bound, bound).t() \
            .contiguous()

    c2 = channels * 2
    flat = 7 * 7 * c2  # 28 -> pool -> 14 -> pool -> 7
    hidden = 128
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32,
                                  device=key.device)
    return {
        "conv1.weight": conv_init(k1, 3, 3, in_ch, channels),
        "conv1.bias": zeros(channels),
        "conv2.weight": conv_init(k2, 3, 3, channels, c2),
        "conv2.bias": zeros(c2),
        "fc1.weight": dense_init(k3, flat, hidden),
        "fc1.bias": zeros(hidden),
        "fc2.weight": dense_init(k4, hidden, n_classes),
        "fc2.bias": zeros(n_classes),
    }


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: [B, 28, 28, C] -> logits [B, n_classes]."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(h, params["conv1.weight"], params["conv1.bias"],
                        padding=1))
    h = F.max_pool2d(h, 2)
    h = F.relu(F.conv2d(h, params["conv2.weight"], params["conv2.bias"],
                        padding=1))
    h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(F.linear(h, params["fc1.weight"], params["fc1.bias"]))
    return F.linear(h, params["fc2.weight"], params["fc2.bias"])


def loss_fn(params, batch) -> torch.Tensor:
    logits = apply(params, batch["x"])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"].long()[:, None])[:, 0]
    return (logz - gold).mean()


def accuracy(params, batch) -> torch.Tensor:
    pred = apply(params, batch["x"]).argmax(dim=-1)
    return (pred == batch["y"].long()).float().mean()
