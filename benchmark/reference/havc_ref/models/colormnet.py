"""Frozen copy of the port's ``havc_tpu_torch/models/colormnet.py`` (the benchmark's plain
reference).

ColorMNet networks (NCHW): key/value encoders, local attention, decoder,
and the memory-readout math.

Port of ``havc_tpu.models.colormnet``.  The two LAB chroma channels are
two "objects" propagated like masks: per-object tensors fold the object
axis O = 2 into the batch axis, ``(B*O, C, H, W)``, object-major within a
batch item.  Resampling is ``jax.image.resize``'s (``ops.resize.
bilinear_nchw``), which antialiases when it downscales; flax's SAME
padding, LayerNorm eps 1e-6, CBAM's (max, mean) channel pool and the
(heads, 1, 1) temperature of the channel attention are kept.  Parameter
names are the flax ones.

The modules compute in the dtype of their parameters and input (an
engine cast to bfloat16 runs them in bf16), and in float32 where the JAX
modules ask for it (``preferred_element_type=jnp.float32``): the channel
attention's logits and softmax, the window attention (float32 result,
cast back to the values' dtype) and the memory similarity.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import bilinear_nchw
from ..ops.window_attn import window_attn
from ..utils.precision import ieee_precision
from .resnet import RESNET_CONFIGS, ResNetBody
from .vit import LN_EPS, DinoSegmentor

__all__ = [
    "KeyEncoder",
    "KeyProjection",
    "ValueEncoder",
    "Decoder",
    "LocalAttention",
    "ColorMNet",
    "get_similarity",
    "topk_softmax",
    "stable_top_k",
    "COLORMNET_CONFIGS",
]

COLORMNET_CONFIGS = {
    # full published geometry
    "full": dict(key_dim=64, value_dim=512, hidden_dim=64, resnet="resnet50",
                 vit="dinov2_s14", value_resnet="resnet18"),
    # test/dev scale
    "micro": dict(key_dim=8, value_dim=16, hidden_dim=8, resnet="nano", vit="nano",
                  value_resnet="nano"),
}


def _stage_channels(resnet: str):
    """(layer1, layer2, layer3) output channels of a ResNet config."""
    cfg = RESNET_CONFIGS[resnet]
    stem = cfg.get("stem_features", 64)
    exp = 1 if cfg["block"] == "basic" else 4
    return tuple(stem * 2 ** s * exp for s in range(3))


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1)


class _LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map."""

    def __init__(self, features: int):
        super().__init__()
        self.ln = nn.LayerNorm(features, eps=LN_EPS)

    def forward(self, x):
        return self.ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class CrossChannelAttention(nn.Module):
    """Transposed (channel) attention between encoder and decoder
    features: tokens are channels, normalised over positions."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        d2 = dim * 2
        self.heads = heads
        for name in ("to_q", "to_k", "to_v"):
            self.add_module(name, nn.Conv2d(dim, d2, 1))
            self.add_module(f"{name}_dw", nn.Conv2d(d2, d2, 3, 1, 1, groups=d2))
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.to_out = nn.Conv2d(d2, dim, 1)

    def reset_flax(self, generator):
        self.temperature.fill_(1.0)

    def forward(self, enc, dnc):
        b, _, h, w = enc.shape

        def qkv(x, name):  # (B, heads, C/heads, H*W)
            y = getattr(self, f"{name}_dw")(getattr(self, name)(x))
            return y.reshape(b, self.heads, -1, h * w)

        q, k, v = qkv(enc, "to_q"), qkv(dnc, "to_k"), qkv(dnc, "to_v")
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
        # logits and softmax in float32, the weights back in the input's type
        logits = (q.float() @ k.float().transpose(-1, -2)) * self.temperature.float()
        attn = torch.softmax(logits, dim=-1).to(enc.dtype)
        return self.to_out((attn @ v).reshape(b, -1, h, w))


class Fuse(nn.Module):
    """DINOv2 <-> ResNet feature fusion."""

    def __init__(self, enc_in: int, out_feat: int):
        super().__init__()
        self.encode_enc = _conv3(enc_in, out_feat)
        self.norm1 = _LayerNorm2d(out_feat)
        self.norm2 = _LayerNorm2d(out_feat)
        self.crossattn = CrossChannelAttention(out_feat)
        self.norm3 = _LayerNorm2d(out_feat)

    def forward(self, enc, dnc):
        enc = self.encode_enc(enc)
        res = enc
        out = self.crossattn(self.norm1(enc), self.norm2(dnc)) + res
        return F.relu(self.norm3(out))


def _per_object(x, o: int):
    """(B, ...) -> (B*O, ...), each item repeated O times (jnp.repeat)."""
    return x.unsqueeze(1).expand(x.shape[0], o, *x.shape[1:]).reshape(-1, *x.shape[1:])


def _fit(x, ref):
    if x.shape[-2:] != ref.shape[-2:]:
        x = bilinear_nchw(x, ref.shape[-2], ref.shape[-1])
    return x


class KeyEncoder(nn.Module):
    """ResNet f16/f8/f4 + DINOv2 segmentor, fused per scale."""

    def __init__(self, resnet: str = "resnet50", vit: str = "dinov2_s14"):
        super().__init__()
        self.ResNetBody_0 = ResNetBody.from_config(resnet, num_stages=3)
        self.network2 = DinoSegmentor(vit_config=vit)
        c4, c8, c16 = _stage_channels(resnet)
        cd = self.network2.out_channels
        self.dims = (c16, c8, c4)
        self.fuse1 = Fuse(cd, c16)
        self.fuse2 = Fuse(cd, c8)
        self.fuse3 = Fuse(cd, c4)

    def forward(self, rgb):
        _, f4, f8, f16 = self.ResNetBody_0(rgb)
        dino = self.network2(rgb)
        h, w = dino.shape[-2:]
        g16 = self.fuse1(_fit(dino, f16), f16)
        g8 = self.fuse2(_fit(bilinear_nchw(dino, 2 * h, 2 * w), f8), f8)
        g4 = self.fuse3(_fit(bilinear_nchw(dino, 4 * h, 4 * w), f4), f4)
        return g16, g8, g4


class KeyProjection(nn.Module):
    """key (Ck) + shrinkage (d^2 + 1) + selection (sigmoid) heads."""

    def __init__(self, in_dim: int, key_dim: int = 64):
        super().__init__()
        self.key_proj = _conv3(in_dim, key_dim)
        self.d_proj = _conv3(in_dim, 1)
        self.e_proj = _conv3(in_dim, key_dim)

    def forward(self, x):
        return (self.key_proj(x), self.d_proj(x) ** 2 + 1,
                torch.sigmoid(self.e_proj(x)))


class CBAM(nn.Module):
    """Channel MLP gate, then a 7x7 spatial gate over (max, mean)."""

    def __init__(self, features: int, reduction: int = 16):
        super().__init__()
        r = max(features // reduction, 1)
        self.mlp1 = nn.Linear(features, r)
        self.mlp2 = nn.Linear(r, features)
        self.spatial = nn.Conv2d(2, 1, 7, 1, 3)

    def forward(self, x):
        avg = self.mlp2(F.relu(self.mlp1(x.mean(dim=(2, 3)))))
        mx = self.mlp2(F.relu(self.mlp1(x.amax(dim=(2, 3)))))
        x = x * torch.sigmoid(avg + mx)[:, :, None, None]
        sp = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(sp))


class GroupResBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv1 = _conv3(in_dim, out_dim)
        self.conv2 = _conv3(out_dim, out_dim)
        self.downsample = _conv3(in_dim, out_dim) if in_dim != out_dim else None

    def forward(self, g):
        out = self.conv2(F.relu(self.conv1(F.relu(g))))
        return out + (self.downsample(g) if self.downsample is not None else g)


class FeatureFusionBlock(nn.Module):
    """Image feature ``x`` (B, Cx) repeated per object ++ per-object ``g``
    (B*O, Cg) -> fused (B*O, out_dim)."""

    def __init__(self, x_dim: int, g_dim: int, mid_dim: int, out_dim: int,
                 num_objects: int = 2):
        super().__init__()
        self.num_objects = num_objects
        self.block1 = GroupResBlock(x_dim + g_dim, mid_dim)
        self.attention = CBAM(mid_dim)
        self.block2 = GroupResBlock(mid_dim, out_dim)

    def forward(self, x, g):
        g = torch.cat([_per_object(x, self.num_objects), g], dim=1)
        g = self.block1(g)
        return self.block2(g + self.attention(g))


class GRUUpdate(nn.Module):
    """The XMem hidden-state GRU."""

    def __init__(self, g_dim: int, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.transform = _conv3(g_dim + hidden_dim, hidden_dim * 3)

    def forward(self, g, h):
        hd = self.hidden_dim
        values = self.transform(torch.cat([g, h], dim=1))
        forget = torch.sigmoid(values[:, :hd])
        update = torch.sigmoid(values[:, hd:2 * hd])
        new = torch.tanh(values[:, 2 * hd:])
        return forget * h * (1 - update) + update * new


class ValueEncoder(nn.Module):
    """Frame + per-object chroma (own channel, other channel) -> value.
    image (B, 3, H, W), f16_key (B, Cf, h, w), hidden (B*O, hd, h, w),
    chroma (B, O, H, W)."""

    def __init__(self, f16_dim: int, value_dim: int = 512, hidden_dim: int = 64,
                 resnet: str = "resnet18", num_objects: int = 2):
        super().__init__()
        self.num_objects = num_objects
        self.ResNetBody_0 = ResNetBody.from_config(resnet, num_stages=3, in_features=5)
        self.fuser = FeatureFusionBlock(f16_dim, _stage_channels(resnet)[2], value_dim,
                                        value_dim, num_objects)
        self.hidden_reinforce = GRUUpdate(value_dim, hidden_dim)

    def forward(self, image, f16_key, hidden, chroma, deep_update: bool = True):
        b, o = image.shape[0], self.num_objects
        h, w = image.shape[-2:]
        g = torch.cat([image[:, None].expand(b, o, 3, h, w), chroma[:, :, None],
                       chroma.flip(1)[:, :, None]], dim=2).reshape(b * o, 5, h, w)
        g16 = _fit(self.ResNetBody_0(g)[3], f16_key)
        g16 = self.fuser(f16_key, g16)
        if deep_update:
            hidden = self.hidden_reinforce(g16, hidden)
        return g16, hidden


class UpsampleBlock(nn.Module):
    def __init__(self, skip_dim: int, up_dim: int, out_dim: int, num_objects: int = 2):
        super().__init__()
        self.num_objects = num_objects
        self.skip_conv = _conv3(skip_dim, up_dim)
        self.out_conv = GroupResBlock(up_dim, out_dim)

    def forward(self, skip_f, up_g):
        skip = _per_object(self.skip_conv(skip_f), self.num_objects)
        g = bilinear_nchw(up_g, 2 * up_g.shape[-2], 2 * up_g.shape[-1])
        return self.out_conv(skip + g)


class Decoder(nn.Module):
    """Memory readout + multi-scale features -> per-object ab logit (tanh
    is the caller's) and the updated hidden state."""

    def __init__(self, f16_dim: int, f8_dim: int, f4_dim: int, value_dim: int = 512,
                 hidden_dim: int = 64, num_objects: int = 2):
        super().__init__()
        self.fuser = FeatureFusionBlock(f16_dim, value_dim + hidden_dim, 512, 512, num_objects)
        self.up_16_8 = UpsampleBlock(f8_dim, 512, 256, num_objects)
        self.up_8_4 = UpsampleBlock(f4_dim, 256, 256, num_objects)
        self.pred = _conv3(256, 1)
        self.hu_g16 = nn.Conv2d(512, 256, 1)
        self.hu_g8 = nn.Conv2d(256, 256, 1)
        self.hu_g4 = nn.Conv2d(257, 256, 1)
        self.hidden_update = GRUUpdate(256, hidden_dim)

    def forward(self, f16, f8, f4, hidden, memory_readout):
        g16 = self.fuser(f16, torch.cat([memory_readout, hidden], dim=1))
        g8 = self.up_16_8(f8, g16)
        g4 = self.up_8_4(f4, g8)
        logits = self.pred(F.relu(g4))
        # hidden update from multi-scale g, area-downsampled
        g4h = torch.cat([g4, logits], dim=1)
        mid = self.hu_g16(g16) + self.hu_g8(F.avg_pool2d(g8, 2, 2)) \
            + self.hu_g4(F.avg_pool2d(g4h, 4, 4))
        hidden = self.hidden_update(mid, hidden)
        return hidden, bilinear_nchw(logits, 4 * logits.shape[-2], 4 * logits.shape[-1])


class LocalAttention(nn.Module):
    """Window-15 local attention of the current key onto the last memory
    frame (both objects' values jointly, d_vu = O * Cv): ``window_attn``
    (the CUDA kernel on the card; float32 out, cast to v's dtype), then a
    5x5 depthwise conv without bias and the output projection.  q, k (B,
    d_qk, H, W), v (B, d_vu, H, W) -> (B, d_vu, H, W)."""

    def __init__(self, d_qk: int, d_vu: int, max_dis: int = 7):
        super().__init__()
        win = 2 * max_dis + 1
        self.max_dis = max_dis
        # relative position logits from the unscaled query
        self.relative_emb_k = nn.Conv2d(d_qk, win * win, 1)
        self.dw_conv = nn.Conv2d(d_vu, d_vu, 5, 1, 2, groups=d_vu, bias=False)
        self.projection = nn.Linear(d_vu, d_vu)

    def forward(self, q, k, v):
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()  # noqa: E731
        rel = self.relative_emb_k(q)
        out = window_attn(nhwc(q), nhwc(k), nhwc(v), nhwc(rel), self.max_dis).to(v.dtype)
        out = self.dw_conv(out.permute(0, 3, 1, 2))
        return self.projection(out.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ColorMNet(nn.Module):
    """The five parameter groups of one engine, named as the converted
    checkpoint's (``key_encoder``, ``key_proj``, ``value_encoder``,
    ``decoder``, ``short_term_attn``)."""

    def __init__(self, config: str = "full"):
        super().__init__()
        c = COLORMNET_CONFIGS[config]
        self.key_encoder = KeyEncoder(resnet=c["resnet"], vit=c["vit"])
        f16, f8, f4 = self.key_encoder.dims
        self.key_proj = KeyProjection(f16, key_dim=c["key_dim"])
        self.value_encoder = ValueEncoder(
            f16, value_dim=c["value_dim"], hidden_dim=c["hidden_dim"],
            resnet=c["value_resnet"])
        self.decoder = Decoder(f16, f8, f4, value_dim=c["value_dim"],
                               hidden_dim=c["hidden_dim"])
        self.short_term_attn = LocalAttention(d_qk=c["key_dim"], d_vu=2 * c["value_dim"])


# --- memory readout math ------------------------------------------------------------


def stable_top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, and among
    equal values the lower index first (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@ieee_precision()
def get_similarity(mk: torch.Tensor, ms: Optional[torch.Tensor], qk: torch.Tensor,
                   qe: Optional[torch.Tensor]) -> torch.Tensor:
    """Anisotropic L2 similarity.  mk (N, Ck) memory keys, ms (N,)
    shrinkage, qk (P, Ck) query keys, qe (P, Ck) selection -> (N, P)
    float32; with leading batch axes on all four, batched products.

    The products run in IEEE float32 whatever the stores' dtype and the
    process's flags, as the JAX package's ``preferred_element_type=
    jnp.float32, precision=HIGHEST`` contractions do: a bf16 (or TF32)
    product would round the similarities and turn the top-k into
    near-ties.  Their operands ``mk ** 2`` and
    ``qk * qe`` are formed in the stores' dtype first, as the jitted JAX
    function forms them; ``b_sq`` is summed from the float32 values (XLA
    fuses that reduction)."""
    ck = mk.shape[-1]
    f32 = torch.float32
    if qe is not None:
        a_sq = (mk ** 2).to(f32) @ qe.to(f32).transpose(-1, -2)
        two_ab = 2.0 * (mk.to(f32) @ (qk * qe).to(f32).transpose(-1, -2))
        b_sq = (qe.to(f32) * qk.to(f32) ** 2).sum(dim=-1)[..., None, :]
        sim = -a_sq + two_ab - b_sq
    else:
        sim = -(mk ** 2).sum(dim=-1).to(f32)[..., None] \
            + 2.0 * (mk.to(f32) @ qk.to(f32).transpose(-1, -2))
    if ms is not None:
        sim = sim * ms.to(f32)[..., None]
    return sim / math.sqrt(ck)


def topk_softmax(sim: torch.Tensor, top_k: int = 30, valid: Optional[torch.Tensor] = None):
    """Top-k softmax over the memory axis.  sim (N, P), valid (N,) live
    slots -> (affinity (N, P), usage (N,)), with any leading batch axes; an
    all-masked memory reads as zeros."""
    if valid is not None:
        sim = torch.where(valid[..., None], sim, -1e30)
    sim_t = sim.transpose(-1, -2)  # (..., P, N)
    values, idx = stable_top_k(sim_t, min(top_k, sim.shape[-2]))  # (..., P, k)
    live = values > -1e29
    x_exp = torch.where(live, torch.exp(values - values[..., :1]), 0.0)
    x_exp = x_exp / torch.clamp(x_exp.sum(dim=-1, keepdim=True), min=1e-30)
    affinity = torch.zeros_like(sim_t).scatter(-1, idx, x_exp)  # (..., P, N)
    return affinity.transpose(-1, -2), affinity.sum(dim=-2)
