"""Frozen copy of the port's ``havc_tpu_torch/models/ddcolor.py`` (the benchmark's plain
reference).

DDColor: ConvNeXt encoder + fastai pixel decoder + Mask2Former-style
color-query decoder, NCHW.

Port of ``havc_tpu.models.ddcolor``.  Submodule names are the flax ones
(``convnext.stage2_block5.dwconv``, ``layer0.shuf.conv.conv``,
``block3.cross.q``, ``color_embed2``, ``refine``, ...).  The decoder's
LayerNorms use flax's default eps 1e-6; attention is written out as matmul
+ softmax in float32.

I/O of ``colorize``: RGB ``(B, H, W, 3)`` in [0,1] -> RGB; the model
itself maps the gray RGB rendering of LAB (L, 0, 0) ``(B, 3, S, S)`` to
raw LAB ab ``(B, 2, S, S)``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.colorspace import lab_to_rgb, rgb_to_lab
from ..ops.resize import resize
from .convnext import CONVNEXT_CONFIGS, LN_EPS, ConvNeXt
from .deoldify import PixelShuffleICNR, UnetBlockWide, _imagenet_stats

__all__ = ["DDColor", "DDCOLOR_CONFIGS", "colorize", "sine_position_embedding"]

DDCOLOR_CONFIGS = {
    # test/dev scale (not a published geometry)
    "micro": dict(encoder="micro", dim=64, num_queries=16, num_blocks=3,
                  unet_out=(64, 64, 32), heads=8, ffn_dim=128),
    "tiny": dict(encoder="tiny", dim=256, num_queries=100, num_blocks=9,
                 unet_out=(512, 512, 256)),
    "large": dict(encoder="large", dim=256, num_queries=100, num_blocks=9,
                  unet_out=(512, 512, 256)),
    # the published model names map to the large encoder
    "artistic": dict(encoder="large", dim=256, num_queries=100, num_blocks=9,
                     unet_out=(512, 512, 256)),
    "modelscope": dict(encoder="large", dim=256, num_queries=100,
                       num_blocks=9, unet_out=(512, 512, 256)),
}


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """DETR PositionEmbeddingSine (normalize=True): (H, W, 2*num_pos_feats)
    with the y-embedding first, interleaved sin/cos per frequency."""
    scale = 2.0 * math.pi
    eps = 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    i = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2.0 * torch.floor(i / 2.0) / num_pos_feats)

    def embed(t):
        p = t[..., None] / dim_t
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                           dim=-1).reshape(h, w, num_pos_feats)

    return torch.cat([embed(y), embed(x)], dim=-1)


class MHA(nn.Module):
    """nn.MultiheadAttention equivalent with q/k/v/proj Linear layers."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in):
        b, lq, dim = q_in.shape
        d = dim // self.heads

        def split(t):  # (B, L, dim) -> (B, heads, L, d)
            return t.reshape(b, t.shape[1], self.heads, d).transpose(1, 2)

        q, k, v = split(self.q(q_in)), split(self.k(k_in)), split(self.v(v_in))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, lq, dim)
        return self.proj(out)


class ColorDecoderBlock(nn.Module):
    """Cross-attn -> self-attn -> FFN, post-norm, positional embeddings on
    queries/keys only."""

    def __init__(self, dim: int, heads: int = 8, ffn_dim: int = 2048):
        super().__init__()
        self.cross = MHA(dim, heads)
        self.cross_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.self = MHA(dim, heads)
        self.self_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn1 = nn.Linear(dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, dim)
        self.ffn_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, queries, query_pos, tokens, token_pos):
        x = queries
        x = self.cross_norm(x + self.cross(x + query_pos, tokens + token_pos, tokens))
        x = self.self_norm(x + self.self(x + query_pos, x + query_pos, x))
        return self.ffn_norm(x + self.ffn2(F.relu(self.ffn1(x))))


class DDColor(nn.Module):
    """Gray RGB (B,3,S,S) in [0,1] -> raw LAB ab (B,2,S,S)."""

    def __init__(self, encoder: str = "large", dim: int = 256,
                 num_queries: int = 100, num_blocks: int = 9,
                 unet_out: Sequence[int] = (512, 512, 256), heads: int = 8,
                 ffn_dim: int = 2048, num_output_channels: int = 2,
                 unet_extra_bn: bool = True, do_normalize: bool = False):
        super().__init__()
        cfg = CONVNEXT_CONFIGS[encoder]
        dims = cfg["dims"]
        self.convnext = ConvNeXt(out_norms=True, **cfg)
        c = dims[3]
        for i, (skip_c, out_ch) in enumerate(zip((dims[2], dims[1], dims[0]), unet_out)):
            blk = UnetBlockWide(c, skip_c, out_ch * 2, blur=True,
                                self_attention=False, use_bn=unet_extra_bn)
            self.add_module(f"layer{i}", blk)
            c = blk.out_channels
        self.last_shuf = PixelShuffleICNR(c, unet_out[-1], blur=True, use_bn=False, scale=4)
        self.query_feat = nn.Parameter(torch.zeros(num_queries, dim))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, dim))
        self.level_embed = nn.Parameter(torch.zeros(3, dim))
        for s in range(3):
            self.add_module(f"input_proj{s}", nn.Conv2d(unet_out[s], dim, 1))
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", ColorDecoderBlock(dim, heads, ffn_dim))
        self.decoder_norm = nn.LayerNorm(dim, eps=LN_EPS)
        emb_dims = (dim, dim, unet_out[-1])
        for j in range(3):
            self.add_module(f"color_embed{j}", nn.Linear(dim if j == 0 else emb_dims[j - 1], emb_dims[j]))
        self.refine = nn.Conv2d(num_queries + 3, num_output_channels, 1)
        self.do_normalize = do_normalize

    def reset_flax(self, generator):
        # flax nn.initializers.normal(1.0)
        for p in (self.query_feat, self.query_embed, self.level_embed):
            p.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        img = x
        if self.do_normalize:
            mean, std = _imagenet_stats(x.dtype, x.device)
            x = (x - mean[:, None, None]) / std[:, None, None]
        f4, f8, f16, f32 = self.convnext(x)
        y = f32
        scale_feats = []
        for i, skip in enumerate((f16, f8, f4)):
            y = getattr(self, f"layer{i}")(y, skip)
            scale_feats.append(y)  # 1/16, 1/8, 1/4
        emb = self.last_shuf(y)  # (B, C, S, S) full-res embedding

        b = x.shape[0]
        tokens, poss = [], []
        for s, feat in enumerate(scale_feats):
            t = getattr(self, f"input_proj{s}")(feat)
            d, fh, fw = t.shape[1:]
            tokens.append(t.flatten(2).transpose(1, 2) + self.level_embed[s])
            pos = sine_position_embedding(fh, fw, d // 2, device=x.device)
            poss.append(pos.reshape(1, fh * fw, d))
        q = self.query_feat.expand(b, -1, -1)
        qp = self.query_embed[None]
        for i in range(self.num_blocks):
            lvl = i % 3
            q = getattr(self, f"block{i}")(q, qp, tokens[lvl], poss[lvl])
        e = self.decoder_norm(q)
        for j in range(3):
            if j > 0:
                e = F.relu(e)
            e = getattr(self, f"color_embed{j}")(e)
        sim = torch.einsum("bchw,bqc->bqhw", emb, e)
        return self.refine(torch.cat([sim, img], dim=1))

    @staticmethod
    def from_config(name: str) -> "DDColor":
        return DDColor(**DDCOLOR_CONFIGS[name])


def colorize(model: DDColor, rgb: torch.Tensor, input_size: int = 384) -> torch.Tensor:
    """RGB ``(B, H, W, 3)`` -> colorized RGB: resize first (bilinear, no
    antialias), take L of the resized image and render it as the gray RGB
    of LAB (L, 0, 0), run the model, bilinear-resize its ab back (no
    antialias) and join it with the original-resolution L."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    l_orig = rgb_to_lab(rgb)[..., 0:1]
    rgb_rs = torch.clamp(
        resize(rgb, input_size, input_size, "bilinear", antialias=False), 0.0, 1.0)
    l_rs = rgb_to_lab(rgb_rs)[..., 0:1]
    gray = lab_to_rgb(torch.cat([l_rs, torch.zeros_like(l_rs), torch.zeros_like(l_rs)], dim=-1))
    ab = model(gray.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ab_up = resize(ab, h, w, "bilinear", antialias=False)
    return torch.clamp(lab_to_rgb(torch.cat([l_orig, ab_up], dim=-1)), 0.0, 1.0)
