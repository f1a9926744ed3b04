"""Building blocks shared by the port's models (NCHW).

Parameter names follow the JAX package's flax modules so that a flax
parameter tree maps onto a ``state_dict`` mechanically (models/bridge.py).
Random initialisation mirrors flax's defaults: lecun-normal kernels
(truncated normal, fan-in scaling), zero biases, BatchNorm scale 1 / var 1,
LayerNorm scale 1.  Every draw comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "BatchNormInference",
    "sigmoid_range",
    "lecun_normal_",
    "init_flax_defaults",
    "same_pad",
]

# flax's truncated_normal(lower=-2, upper=2) stddev correction
_TRUNC_STD = 0.87962566103423978


class BatchNormInference(nn.Module):
    """BatchNorm2d in inference form over NCHW, computed as the JAX
    package does: ``x * (g / sqrt(var + eps)) + (b - mean * g / sqrt(var +
    eps))``, in the parameters' dtype (an engine cast to bf16 folds in
    bf16, as the JAX package's fold does with its parameters cast to the
    activations' dtype).  ``running_mean``/``running_var`` are buffers."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def fold(self):
        """``(inv, shift)``: the per-channel scale and shift of the fold."""
        inv = self.weight * (1.0 / torch.sqrt(self.running_var + self.eps))
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, shift = self.fold()
        return x * inv[:, None, None] + shift[:, None, None]


def sigmoid_range(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """fastai SigmoidRange: sigmoid scaled to (lo, hi)."""
    return torch.sigmoid(x) * (hi - lo) + lo


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal on [-2, 2] std units, scaled
    to variance 1/fan_in.  ``fan_in`` is every dim but the first (OIHW or
    OIDHW conv, (out, in) Linear, or IOHW transposed conv, whose flax kernel
    ``(kH, kW, O, I)`` has the same fan-in)."""
    fan_in = math.prod(w.shape[1:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    # inverse-CDF sampling, as torch.nn.init.trunc_normal_ does
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        w.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        w.erfinv_()
        w.mul_(std * math.sqrt(2.0))
        w.clamp_(-2.0 * std, 2.0 * std)
    return w


@torch.no_grad()
def init_flax_defaults(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """(Re)initialise every parameter the way flax's defaults would.
    Modules with parameters of their own (``query_feat``, ``gamma``, ...)
    initialise those in their ``reset_flax`` method."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, BatchNormInference)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNormInference):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        if hasattr(m, "reset_flax"):
            m.reset_flax(generator)
    return module


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax ``padding="SAME"`` for a k x k, stride-s conv: pad so the
    output is ``ceil(n / s)``, the odd pixel at the end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x
