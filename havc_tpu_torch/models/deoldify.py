"""DeOldify DynamicUnetWide (the Video and Stable weights) and
DynamicUnetDeep (the Artistic weights), NCHW.

Port of ``havc_tpu.models.deoldify``.  Submodule names are the flax ones
(``ResNetBody_0``, ``up0.shuf.conv.conv``, ``last_cross.conv1.conv``, ...)
so that models/bridge.py maps a flax tree onto the ``state_dict``.

* ``PixelShuffleICNR``: 1x1 conv to nf*4 -> ReLU -> ``pixel_shuffle(2)``
  (channel order ``(c_out, dy, dx)``) -> replication pad (1,0,1,0) -> 2x2
  stride-1 average pool ("blur"); everything after the conv, and the
  join with a block's skip or the head's input, is ``ops.unet_join`` (one
  CUDA kernel on the card).
* ``UnetBlockWide``: shuf(up) ++ BN(skip) -> ReLU -> one conv (+ fastai
  self-attention, softmax over axis 1).
* ``UnetBlockDeep``: shuf(up) to half its channels ++ BN(skip) -> ReLU ->
  two convs of ``nf_factor`` times the joined channels (halved first in
  the last block), the second with the self-attention.
* The head: the final shuffle always blurs (a fastai-1.0.60 quirk the
  weights were trained with), dense merge with the input, a res block,
  a 1x1 conv to 3 channels and SigmoidRange(-3, 3).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.colorspace import copy_chroma, rgb_to_gray
from ..ops.resize import resize
from ..ops.unet_join import unet_join
from .layers import BatchNormInference, sigmoid_range
from .resnet import RESNET_CONFIGS, ResNetBody

__all__ = [
    "DeOldifyWide",
    "DeOldifyDeep",
    "DEOLDIFY_CONFIGS",
    "make_model",
    "colorize",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

DEOLDIFY_CONFIGS = {
    # weights_name -> (variant, encoder, nf_factor)
    "video": ("wide", "resnet101", 2),
    "stable": ("wide", "resnet101", 2),
    "artistic": ("deep", "resnet34", 1.5),
}


class SelfAttention(nn.Module):
    """fastai SelfAttention: 1x1 f/g/h convs, softmax(f^T g) over the
    first axis, gamma-gated."""

    def __init__(self, channels: int):
        super().__init__()
        self.query = nn.Conv2d(channels, channels // 8, 1, bias=False)
        self.key = nn.Conv2d(channels, channels // 8, 1, bias=False)
        self.value = nn.Conv2d(channels, channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def reset_flax(self, generator):
        self.gamma.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        f = self.query(x).reshape(b, c // 8, h * w)
        g = self.key(x).reshape(b, c // 8, h * w)
        hh = self.value(x).reshape(b, c, h * w)
        beta = torch.softmax(torch.bmm(f.transpose(1, 2), g), dim=1)  # (b, n, m)
        o = torch.bmm(hh, beta).reshape(b, c, h, w)
        return self.gamma * o + x


class ConvBnRelu(nn.Module):
    """custom_conv_layer inference form: conv -> ReLU -> BN (+ attention)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 use_activ: bool = True, use_bn: bool = True,
                 self_attention: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel_size, 1, (kernel_size - 1) // 2,
                              bias=not use_bn)
        self.use_activ = use_activ
        if use_bn:
            self.bn = BatchNormInference(features)
        if self_attention:
            self.attn = SelfAttention(features)

    def forward(self, x):
        x = self.conv(x)
        if self.use_activ:
            x = F.relu(x)
        if hasattr(self, "bn"):
            x = self.bn(x)
        if hasattr(self, "attn"):
            x = self.attn(x)
        return x


class PixelShuffleICNR(nn.Module):
    """1x1 conv to features*scale^2 -> ReLU -> pixel shuffle -> blur;
    with ``skip``, joined with it (``ops.unet_join``)."""

    def __init__(self, cin: int, features: int, blur: bool = True,
                 use_bn: bool = True, scale: int = 2):
        super().__init__()
        self.conv = ConvBnRelu(cin, features * scale * scale, kernel_size=1,
                               use_activ=False, use_bn=use_bn)
        self.blur = blur
        self.scale = scale

    def forward(self, x, skip=None, skip_bn=None):
        conv = self.conv
        bn = conv.bn.fold() if hasattr(conv, "bn") else None
        return unet_join(conv.conv(x), self.scale, bn, skip=skip, skip_bn=skip_bn,
                         blur=self.blur)


class UnetBlockWide(nn.Module):
    """fastai/DeOldify UnetBlockWide; also DDColor's pixel-decoder block."""

    def __init__(self, up_in_c: int, skip_c: int, n_out: int, blur: bool = True,
                 self_attention: bool = False, use_bn: bool = True):
        super().__init__()
        up_out = n_out // 2
        self.shuf = PixelShuffleICNR(up_in_c, up_out, blur=blur, use_bn=use_bn)
        self.bn = BatchNormInference(skip_c)
        self.conv = ConvBnRelu(up_out + skip_c, up_out,
                               self_attention=self_attention, use_bn=use_bn)
        self.out_channels = up_out

    def forward(self, up_in, skip):
        return self.conv(self.shuf(up_in, skip, self.bn.fold()))


class UnetBlockDeep(nn.Module):
    """fastai/DeOldify UnetBlockDeep (DeOldify Artistic)."""

    def __init__(self, up_in_c: int, skip_c: int, nf_factor: float = 1.5,
                 final_div: bool = True, blur: bool = True, self_attention: bool = False):
        super().__init__()
        self.shuf = PixelShuffleICNR(up_in_c, up_in_c // 2, blur=blur)
        self.bn = BatchNormInference(skip_c)
        ni = up_in_c // 2 + skip_c
        nf = int((ni if final_div else ni // 2) * nf_factor)
        self.conv1 = ConvBnRelu(ni, nf)
        self.conv2 = ConvBnRelu(nf, nf, self_attention=self_attention)
        self.out_channels = nf

    def forward(self, up_in, skip):
        return self.conv2(self.conv1(self.shuf(up_in, skip, self.bn.fold())))


class ResBlock(nn.Module):
    """fastai res_block with NormType.Spectral: two conv -> ReLU (with
    bias, no BN) and a residual."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = ConvBnRelu(features, features, use_bn=False)
        self.conv2 = ConvBnRelu(features, features, use_bn=False)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class _DynamicUnet(nn.Module):
    """The encoder, middle convs and head the Wide and Deep U-Nets share;
    a subclass adds its ``up0..up3`` blocks and gives their last width."""

    def __init__(self, encoder: str, n_classes: int = 3,
                 y_range: Tuple[float, float] = (-3.0, 3.0)):
        super().__init__()
        self.ResNetBody_0 = ResNetBody.from_config(encoder)
        cfg = RESNET_CONFIGS[encoder]
        stem = cfg.get("stem_features", 64)
        exp = 1 if cfg["block"] == "basic" else 4
        # channels of (relu, layer1, layer2, layer3, layer4)
        self.chans = [stem] + [stem * 2 ** s * exp for s in range(4)]
        ni = self.chans[4]
        self.pre_bn = BatchNormInference(ni)
        self.mid_conv1 = ConvBnRelu(ni, ni * 2)
        self.mid_conv2 = ConvBnRelu(ni * 2, ni)
        self.y_range = y_range
        self.n_classes = n_classes

    def _make_head(self, c: int):
        self.final_shuf = PixelShuffleICNR(c, c, blur=True, use_bn=False)
        self.last_cross = ResBlock(c + 3)
        self.head_conv = nn.Conv2d(c + 3, self.n_classes, 1)

    def forward(self, x):
        inp = x
        relu_out, l1, l2, l3, l4 = self.ResNetBody_0(x)
        y = self.mid_conv2(self.mid_conv1(F.relu(self.pre_bn(l4))))
        for i, skip in enumerate((l3, l2, l1, relu_out)):
            y = getattr(self, f"up{i}")(y, skip)
        if y.shape[2] != inp.shape[2]:
            y = self.final_shuf(y, inp)  # the shuffle joined with the input
        else:
            y = torch.cat([y, inp], dim=1)
        y = self.last_cross(y)
        return sigmoid_range(self.head_conv(y), *self.y_range)


class DeOldifyWide(_DynamicUnet):
    """DynamicUnetWide (Video/Stable): nf = 512 * nf_factor."""

    def __init__(self, encoder: str = "resnet101", nf_factor: int = 2,
                 n_classes: int = 3, self_attention: bool = True,
                 blur: bool = True, y_range: Tuple[float, float] = (-3.0, 3.0)):
        super().__init__(encoder, n_classes, y_range)
        nf = 512 * nf_factor
        skips_c = self.chans[3::-1]
        c = self.chans[4]
        for i, skip_c in enumerate(skips_c):
            n_out = nf if i != len(skips_c) - 1 else nf // 2
            blk = UnetBlockWide(c, skip_c, n_out, blur=blur,
                                self_attention=self_attention and i == len(skips_c) - 3)
            self.add_module(f"up{i}", blk)
            c = blk.out_channels
        self._make_head(c)


class DeOldifyDeep(_DynamicUnet):
    """DynamicUnetDeep (Artistic): each block's width is ``nf_factor``
    times its joined channels."""

    def __init__(self, encoder: str = "resnet34", nf_factor: float = 1.5,
                 n_classes: int = 3, self_attention: bool = True,
                 blur: bool = True, y_range: Tuple[float, float] = (-3.0, 3.0)):
        super().__init__(encoder, n_classes, y_range)
        skips_c = self.chans[3::-1]
        c = self.chans[4]
        for i, skip_c in enumerate(skips_c):
            blk = UnetBlockDeep(c, skip_c, nf_factor=nf_factor,
                                final_div=i != len(skips_c) - 1, blur=blur,
                                self_attention=self_attention and i == len(skips_c) - 3)
            self.add_module(f"up{i}", blk)
            c = blk.out_channels
        self._make_head(c)


def make_model(weights_name: str) -> nn.Module:
    """Model for a published weights name: video / stable / artistic."""
    variant, encoder, nf = DEOLDIFY_CONFIGS[weights_name]
    if variant == "wide":
        return DeOldifyWide(encoder=encoder, nf_factor=int(nf))
    return DeOldifyDeep(encoder=encoder, nf_factor=float(nf))


@functools.lru_cache(maxsize=8)
def _imagenet_stats(dtype: torch.dtype, device: torch.device):
    # made once per device: a copy from the host would wait for the card
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def colorize(model: nn.Module, rgb: torch.Tensor, render_factor: int = 24) -> torch.Tensor:
    """Colorize ``(B, H, W, 3)`` RGB: square-stretch to
    ``render_factor*16`` (bilinear), rec601 gray, imagenet-normalize,
    U-Net forward, denormalize, then marry the model chroma to the
    original-resolution luma."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    size = render_factor * 16
    sq = rgb_to_gray(resize(rgb, size, size, "bilinear"))
    mean, std = _imagenet_stats(rgb.dtype, rgb.device)
    out = model(((sq - mean) / std).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    out = torch.clamp(out * std + mean, 0.0, 1.0)
    out_full = resize(out, h, w, "bilinear")
    return torch.clamp(copy_chroma(out_full, rgb), 0.0, 1.0)
