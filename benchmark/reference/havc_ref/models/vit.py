"""Frozen copy of the port's ``havc_tpu_torch/models/vit.py`` (the benchmark's plain
reference).

DINOv2 ViT-S/14 feature extractor and ColorMNet's segmentor head (NCHW).

Port of ``havc_tpu.models.vit``: patch embed 14x14 stride 14, pre-norm
blocks with LayerScale and exact GELU, learned position embeddings stored
at the 37x37 pretraining grid and bicubically interpolated to the input
grid, the shared final norm on the last four blocks, then
``DinoSegmentor``: concat -> 1x1 conv (no bias) -> BatchNorm -> ReLU ->
bilinear re-grid from the 1/14 to the 1/16 grid.  Attention is written
as matmul + softmax.  Parameter names are the flax ones.

The modules compute in the dtype of their parameters and input; the
attention's logits and softmax and the position embeddings' bicubic
re-grid are float32 whatever that dtype, as in the JAX package.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import bilinear_nchw
from ..utils.precision import ieee_precision

__all__ = ["ViT", "VIT_CONFIGS", "DinoSegmentor", "torch_bicubic_matrix"]

VIT_CONFIGS = {
    "dinov2_s14": dict(patch=14, dim=384, depth=12, heads=6),
    # test/dev configs
    "micro": dict(patch=14, dim=64, depth=4, heads=2),
    "nano": dict(patch=14, dim=32, depth=2, heads=2),
}

LN_EPS = 1e-6  # flax nn.LayerNorm default


@functools.lru_cache(maxsize=32)
def torch_bicubic_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out_size, in_size) weights of torch ``F.interpolate(mode="bicubic",
    align_corners=False)`` with an explicit sampling ``scale``: source
    ``(dst + 0.5) / scale - 0.5``, cubic A = -0.75, taps clamped to the
    edge.  Formed in float32 as the JAX package forms them."""
    a = np.float32(-0.75)
    src = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) / np.float32(scale) \
        - np.float32(0.5)
    i0 = np.floor(src)
    t = src - i0

    def near(x):
        return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1

    def far(x):
        return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a

    w = np.stack([far(1 + t), near(t), near(1 - t), far(2 - t)], axis=-1)  # (out, 4)
    idx = np.clip(i0[:, None].astype(np.int64) + np.arange(-1, 3)[None, :], 0, in_size - 1)
    mat = np.zeros((out_size, in_size), np.float32)
    np.add.at(mat, (np.repeat(np.arange(out_size), 4), idx.ravel()), w.ravel())
    return mat


@functools.lru_cache(maxsize=32)
def _bicubic_device(in_size: int, out_size: int, scale: float, device: torch.device):
    return torch.from_numpy(torch_bicubic_matrix(in_size, out_size, scale)).to(device)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        d = c // self.heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        logits = q.float() @ k.float().transpose(-1, -2) / math.sqrt(d)
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class Block(nn.Module):
    """Pre-norm attention and MLP, each scaled by its LayerScale gamma."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.ls1_gamma = nn.Parameter(torch.ones(dim))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, dim * 4)
        self.mlp_fc2 = nn.Linear(dim * 4, dim)
        self.ls2_gamma = nn.Parameter(torch.ones(dim))

    def reset_flax(self, generator):
        self.ls1_gamma.fill_(1.0)
        self.ls2_gamma.fill_(1.0)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1_gamma
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + y * self.ls2_gamma


class ViT(nn.Module):
    """Returns the ``out_layers`` block outputs, each through the shared
    final norm, as ``(B, dim, H/14, W/14)`` maps."""

    def __init__(self, patch: int = 14, dim: int = 384, depth: int = 12, heads: int = 6,
                 out_layers: Sequence[int] = (8, 9, 10, 11), pretrain_grid: int = 37):
        super().__init__()
        self.patch, self.dim, self.depth = patch, dim, depth
        self.out_layers = tuple(out_layers)
        self.pretrain_grid = pretrain_grid
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid ** 2 + 1, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, heads))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def reset_flax(self, generator):
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, rgb) -> Tuple[torch.Tensor, ...]:
        b, _, h, w = rgb.shape
        p, g0 = self.patch, self.pretrain_grid
        gh, gw = max(h // p, 1), max(w // p, 1)
        if (gh * p, gw * p) != (h, w):
            rgb = bilinear_nchw(rgb, gh * p, gw * p)
        x = self.patch_embed(rgb).flatten(2).transpose(1, 2)  # (B, gh*gw, dim)
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (g0, g0):
            # upstream interpolate_pos_encoding: bicubic with scale
            # (grid + 0.1) / pretrain_grid, antialias off
            grid = pos_patch.reshape(g0, g0, self.dim).float()
            mh = _bicubic_device(g0, gh, (gh + 0.1) / g0, x.device)
            mw = _bicubic_device(g0, gw, (gw + 0.1) / g0, x.device)
            with ieee_precision():  # the JAX package's bicubic is exact mul-adds
                grid = torch.einsum("oh,hwc->owc", mh, grid)
                grid = torch.einsum("pw,owc->opc", mw, grid)
            pos_patch = grid.reshape(1, gh * gw, self.dim).to(pos_cls.dtype)
        x = torch.cat([self.cls_token.expand(b, 1, self.dim).to(x.dtype), x], dim=1)
        x = x + torch.cat([pos_cls, pos_patch], dim=1).to(x.dtype)
        outs = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
            if i in self.out_layers:
                f = self.norm(x)[:, 1:]
                outs.append(f.transpose(1, 2).reshape(b, self.dim, gh, gw))
        return tuple(outs)


class DinoSegmentor(nn.Module):
    """The last four layers concatenated -> 1x1 conv + BN + ReLU ->
    torch-exact bilinear from the 1/14 grid to the 1/16 grid."""

    def __init__(self, vit_config: str = "dinov2_s14"):
        super().__init__()
        cfg = VIT_CONFIGS[vit_config]
        self.backbone = ViT(patch=cfg["patch"], dim=cfg["dim"], depth=cfg["depth"],
                            heads=cfg["heads"],
                            out_layers=tuple(range(cfg["depth"] - 4, cfg["depth"])))
        # the last four blocks (fewer when the ViT is shallower)
        c = sum(i in self.backbone.out_layers for i in range(cfg["depth"])) * cfg["dim"]
        self.out_channels = c
        self.conv3 = nn.Conv2d(c, c, 1, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(c))
        self.bn_bias = nn.Parameter(torch.zeros(c))
        self.bn_mean = nn.Parameter(torch.zeros(c))
        self.bn_var = nn.Parameter(torch.ones(c))

    def reset_flax(self, generator):
        self.bn_scale.fill_(1.0)
        self.bn_bias.zero_()
        self.bn_mean.zero_()
        self.bn_var.fill_(1.0)

    def forward(self, rgb):
        f = self.conv3(torch.cat(self.backbone(rgb), dim=1))
        col = lambda t: t[:, None, None]  # noqa: E731
        f = (f - col(self.bn_mean)) / torch.sqrt(col(self.bn_var) + 1e-5) * col(self.bn_scale) \
            + col(self.bn_bias)
        f = F.relu(f)
        gh, gw = f.shape[-2:]
        return F.interpolate(f, size=(int(gh * 14 / 16), int(gw * 14 / 16)), mode="bilinear",
                             align_corners=False)
