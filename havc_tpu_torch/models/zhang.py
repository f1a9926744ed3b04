"""Zhang et al. colorization CNNs (eccv16 and siggraph17), NCHW.

Port of ``havc_tpu.models.zhang``.  Submodule names are the flax ones
(``model1.conv0``, ``model1.norm``, ``model8_up``, ``model3short8``, ...)
so that models/bridge.py maps a flax tree onto the ``state_dict``; the
transposed convolutions (``model8_up``, ``model9_up``, ``model10_up``) are
``nn.ConvTranspose2d(k=4, s=2, p=1)``, torch's own form of the JAX
package's ``PtConvTranspose``.

* ECCV16: 8 conv blocks (blocks 5-6 dilated by 2), a 313-bin color-class
  softmax, a 1x1 ab regression, 4x bilinear upsampling.
* Siggraph17: L + ab hints + mask in (HAVC feeds zero hints), stride-2
  subsampling between blocks 1-4, three shortcuts on the decoder, tanh ab.

``width`` is the channel count of the first block (64 in the published
nets); every block scales with it, the 313 classes and the 2 ab channels
do not.  ``colorize`` runs the net at 256x256 on the L of a bicubic
resize and joins the bilinearly upsampled ab with the L of the original.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.colorspace import lab_to_rgb, rgb_to_lab
from ..ops.resize import bilinear_nchw, resize
from .layers import BatchNormInference

__all__ = ["ECCV16", "Siggraph17", "colorize"]

# LAB normalization constants (reference base_color.py:8-23).
L_CENT = 50.0
L_NORM = 100.0
AB_NORM = 110.0


class _ConvBlock(nn.Module):
    """``n_convs`` 3x3 convs with ReLU (stride on the last, optional
    dilation), then inference BatchNorm: one "modelK" block."""

    def __init__(self, cin: int, features: int, n_convs: int, last_stride: int = 1,
                 dilation: int = 1, norm: bool = True):
        super().__init__()
        for i in range(n_convs):
            stride = last_stride if i == n_convs - 1 else 1
            self.add_module(f"conv{i}", nn.Conv2d(cin if i == 0 else features, features, 3,
                                                  stride, dilation, dilation))
        self.n_convs = n_convs
        if norm:
            self.norm = BatchNormInference(features)

    def forward(self, x):
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.norm(x) if hasattr(self, "norm") else x


def _up(cin: int, features: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, features, 4, 2, 1)


class ECCV16(nn.Module):
    """ECCVGenerator: normalised L ``(B, 1, H, W)`` -> ab ``(B, 2, H, W)``."""

    def __init__(self, width: int = 64):
        super().__init__()
        c1, c2, c3, c4 = width, 2 * width, 4 * width, 8 * width
        self.model1 = _ConvBlock(1, c1, 2, last_stride=2)
        self.model2 = _ConvBlock(c1, c2, 2, last_stride=2)
        self.model3 = _ConvBlock(c2, c3, 3, last_stride=2)
        self.model4 = _ConvBlock(c3, c4, 3)
        self.model5 = _ConvBlock(c4, c4, 3, dilation=2)
        self.model6 = _ConvBlock(c4, c4, 3, dilation=2)
        self.model7 = _ConvBlock(c4, c4, 3)
        self.model8_up = _up(c4, c3)
        self.model8_conv1 = nn.Conv2d(c3, c3, 3, 1, 1)
        self.model8_conv2 = nn.Conv2d(c3, c3, 3, 1, 1)
        self.model8_class = nn.Conv2d(c3, 313, 1)
        self.model_out = nn.Conv2d(313, 2, 1, bias=False)

    def forward(self, input_l):
        x = (input_l - L_CENT) / L_NORM
        for k in range(1, 8):
            x = getattr(self, f"model{k}")(x)
        x = F.relu(self.model8_up(x))
        x = F.relu(self.model8_conv1(x))
        x = F.relu(self.model8_conv2(x))
        x = torch.softmax(self.model8_class(x), dim=1)
        x = self.model_out(x)
        x = bilinear_nchw(x, 4 * x.shape[2], 4 * x.shape[3])
        return x * AB_NORM


class Siggraph17(nn.Module):
    """SIGGRAPHGenerator inference graph (zero ab hints by default)."""

    def __init__(self, width: int = 64):
        super().__init__()
        c1, c2, c3, c4 = width, 2 * width, 4 * width, 8 * width
        self.model1 = _ConvBlock(4, c1, 2)
        self.model2 = _ConvBlock(c1, c2, 2)
        self.model3 = _ConvBlock(c2, c3, 3)
        self.model4 = _ConvBlock(c3, c4, 3)
        self.model5 = _ConvBlock(c4, c4, 3, dilation=2)
        self.model6 = _ConvBlock(c4, c4, 3, dilation=2)
        self.model7 = _ConvBlock(c4, c4, 3)
        self.model8_up = _up(c4, c3)
        self.model3short8 = nn.Conv2d(c3, c3, 3, 1, 1)
        self.model8_conv1 = nn.Conv2d(c3, c3, 3, 1, 1)
        self.model8_conv2 = nn.Conv2d(c3, c3, 3, 1, 1)
        self.model8_norm = BatchNormInference(c3)
        self.model9_up = _up(c3, c2)
        self.model2short9 = nn.Conv2d(c2, c2, 3, 1, 1)
        self.model9_conv1 = nn.Conv2d(c2, c2, 3, 1, 1)
        self.model9_norm = BatchNormInference(c2)
        self.model10_up = _up(c2, c2)
        self.model1short10 = nn.Conv2d(c1, c2, 3, 1, 1)
        self.model10_conv1 = nn.Conv2d(c2, c2, 3, 1, 1)
        self.model_out = nn.Conv2d(c2, 2, 1)

    def forward(self, input_l, input_ab=None, mask=None):
        if input_ab is None:
            input_ab = torch.zeros((input_l.shape[0], 2) + input_l.shape[2:],
                                   dtype=input_l.dtype, device=input_l.device)
        if mask is None:
            mask = torch.zeros_like(input_l)
        x = torch.cat([(input_l - L_CENT) / L_NORM, input_ab / AB_NORM, mask], dim=1)
        conv1 = self.model1(x)
        conv2 = self.model2(conv1[:, :, ::2, ::2])
        conv3 = self.model3(conv2[:, :, ::2, ::2])
        conv7 = self.model7(self.model6(self.model5(self.model4(conv3[:, :, ::2, ::2]))))
        x = F.relu(self.model8_up(conv7) + self.model3short8(conv3))
        x = F.relu(self.model8_conv1(x))
        conv8 = self.model8_norm(F.relu(self.model8_conv2(x)))
        x = F.relu(self.model9_up(conv8) + self.model2short9(conv2))
        conv9 = self.model9_norm(F.relu(self.model9_conv1(x)))
        x = F.relu(self.model10_up(conv9) + self.model1short10(conv1))
        x = F.leaky_relu(self.model10_conv1(x), negative_slope=0.2)
        return torch.tanh(self.model_out(x)) * AB_NORM


def colorize(model: nn.Module, rgb: torch.Tensor, input_size: int = 256) -> torch.Tensor:
    """RGB ``(B, H, W, 3)`` in [0,1] -> colorized RGB: the L of a bicubic
    ``input_size`` square resize into the net, its ab bilinearly resized
    back and joined with the L of the original resolution."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    l_orig = rgb_to_lab(rgb)[..., 0:1]
    rgb_rs = torch.clamp(resize(rgb, input_size, input_size, "bicubic"), 0.0, 1.0)
    l_rs = rgb_to_lab(rgb_rs)[..., 0:1]
    ab = model(l_rs.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ab_up = resize(ab, h, w, "bilinear")
    return torch.clamp(lab_to_rgb(torch.cat([l_orig, ab_up], dim=-1)), 0.0, 1.0)
