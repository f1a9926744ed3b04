"""Frozen copy of the port's ``havc_tpu_torch/models/convnext.py`` (the benchmark's plain
reference).

ConvNeXt backbone (DDColor's encoder), NCHW.

Port of ``havc_tpu.models.convnext``: dw7x7 -> LayerNorm -> pw 4x MLP
(exact GELU) -> layer-scale -> residual, with stage downsample convs.
Every LayerNorm uses flax's default eps 1e-6 and normalises the channel
axis (applied channels-last, as upstream ConvNeXt does).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import same_pad

__all__ = ["ConvNeXt", "CONVNEXT_CONFIGS", "channel_norm"]

CONVNEXT_CONFIGS = {
    # "micro" is a test/dev config (not a published checkpoint size)
    "micro": dict(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256)),
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
}

LN_EPS = 1e-6  # flax nn.LayerNorm default


def channel_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channel axis of an NCHW tensor."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.layer_scale_init = layer_scale_init

    def reset_flax(self, generator):
        self.gamma.fill_(self.layer_scale_init)

    def forward(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        return x + (y * self.gamma).permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """Returns the four stage features (1/4, 1/8, 1/16, 1/32), NCHW;
    ``out_norms=True`` applies the per-stage output LayerNorms."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), out_norms: bool = False):
        super().__init__()
        self.depths = tuple(depths)
        self.out_norms = out_norms
        self.stem_conv = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = nn.LayerNorm(dims[0], eps=LN_EPS)
        for s in range(4):
            if s > 0:
                self.add_module(f"down{s}_norm", nn.LayerNorm(dims[s - 1], eps=LN_EPS))
                self.add_module(f"down{s}_conv", nn.Conv2d(dims[s - 1], dims[s], 2, stride=2))
            for b in range(depths[s]):
                self.add_module(f"stage{s}_block{b}", ConvNeXtBlock(dims[s]))
            if out_norms:
                self.add_module(f"out_norm{s}", nn.LayerNorm(dims[s], eps=LN_EPS))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        # flax convs default to padding="SAME"
        x = channel_norm(self.stem_norm, self.stem_conv(same_pad(x, 4, 4)))
        feats = []
        for s in range(4):
            if s > 0:
                x = channel_norm(getattr(self, f"down{s}_norm"), x)
                x = getattr(self, f"down{s}_conv")(same_pad(x, 2, 2))
            for b in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{b}")(x)
            feats.append(channel_norm(getattr(self, f"out_norm{s}"), x)
                         if self.out_norms else x)
        return tuple(feats)
