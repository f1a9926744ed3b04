"""Deep-Exemplar colorization (NCHW): VGG19 features, WarpNet and
ColorVidNet.

Port of ``havc_tpu.models.deepex``:

* ``VGG19Features``: caffe-style features (r12, r22, r32, r42, r52) of an
  RGB frame (BGR * 255 - mean);
* ``WarpNet``: the r22..r52 pyramid fused at H/4 (reflect-padded convs,
  instance norms, PReLU, three residual blocks; ``encode``), then the
  centred-cosine correlation of the frame's tokens with the reference's
  and a softmax at ``temperature`` that warps the reference's LAB onto the
  frame (``correlate``).  The row maximum is subtracted before the
  division by the temperature: the entry points run it at 1e-10, a hard argmax;
* ``ColorVidNet``: ``cat(L - 50, warped ab, similarity, last LAB - (50,
  0, 0))`` -> ab in (-128, 128).

The engine runs inside ``utils.precision.engine_precision``: TF32 on the
card by default (the JAX package runs these convolutions at XLA's
DEFAULT precision), IEEE float32 when the caller sets PyTorch's flags so.
``_Conv2d`` picks the faster route at each: at TF32 every convolution
runs through cuDNN; at IEEE float32 every one but the dilated ones runs
without cuDNN, whose heuristics then pick FFT or slow implicit-GEMM
algorithms for several 3x3 convolutions at 1/2 and 1/4 size, while
PyTorch's own dilated convolution is 25 times slower than cuDNN's.
``chip_smoke.py``'s ``deepex_conv_paths`` times one batch of four frames
at 216x384 both ways at both precisions on every run.  On an H100
(700 W): at TF32 10.4-13.3 ms through cuDNN against 151-211 ms through
PyTorch's kernels; at IEEE 375-578 ms through cuDNN (ColorVidNet's
``conv9_1`` alone up to 396 ms), 130-211 ms through PyTorch's kernels
and 48.4-48.6 ms with the split.

The LAB-level functions (``frame_colorization``,
``frame_colorization_batched``, ``encode_reference``,
``guided_filter_ab``) take and return channel-last ``(B, H, W, C)``
tensors like the rest of the port; the modules compute in NCHW.
Parameter names are the flax ones (``conv1_1``, ``l2a.conv``, ``prelu``,
``res1.conv1``, ``theta``, ``conv1_2norm_ss``, ...), so
``models/bridge.state_dict_from_flax`` carries a JAX tree across.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.colorspace import lab_to_rgb
from ..ops.retinex import _box_filter_1d
from ..utils.precision import TF32
from ..utils.profiling import stage_timer

__all__ = [
    "VGG19Features",
    "WarpNet",
    "ColorVidNet",
    "DeepEx",
    "frame_colorization",
    "frame_colorization_batched",
    "encode_reference",
    "get_deepex_size",
    "guided_filter_ab",
]

# caffe VGG preprocessing constants (BGR)
_VGG_MEAN_BGR = (103.939, 116.779, 123.68)

_VGG_CFG = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool",
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), "pool",
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), ("conv3_4", 256, 256),
    "pool",
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), ("conv4_4", 512, 512),
    "pool",
    ("conv5_1", 512, 512), ("conv5_2", 512, 512),
]
_VGG_OUT = ("conv1_2", "conv2_2", "conv3_2", "conv4_2", "conv5_2")


def get_deepex_size(speed: str = "medium") -> Tuple[int, int]:
    """Render speed (case-insensitive) -> working size (H, W)."""
    return {
        "fast": (144, 256),
        "medium": (216, 384),
        "slow": (288, 512),
        "slower": (360, 640),
    }[speed.lower()]


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine: over H, W per sample and channel,
    with the population variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps)


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * alpha)


def _up(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` by an integer factor: index
    ``i // k``."""
    return x.repeat_interleave(k, dim=2).repeat_interleave(k, dim=3)


class _Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs a CUDA input without cuDNN when it is
    undilated and cuDNN's convolutions are not at TF32 (see the module
    docstring for the measurement)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda or self.dilation != (1, 1) or \
                torch.backends.cudnn.conv.fp32_precision == TF32:
            return super().forward(x)
        enabled = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            return super().forward(x)
        finally:
            torch.backends.cudnn.enabled = enabled


class _PReLUParam(nn.Module):
    """Holds one PReLU slope (flax init 0.25)."""

    def __init__(self):
        super().__init__()
        self.prelu = nn.Parameter(torch.full((1,), 0.25))

    def reset_flax(self, generator):
        self.prelu.fill_(0.25)


class VGG19Features(nn.Module):
    """VGG19 up to relu5_2 over an RGB [0, 1] NCHW batch: (r12, r22, r32,
    r42, r52)."""

    def __init__(self):
        super().__init__()
        for layer in _VGG_CFG:
            if layer != "pool":
                name, cin, cout = layer
                setattr(self, name, _Conv2d(cin, cout, 3, 1, 1))

    def forward(self, rgb01: torch.Tensor):
        bgr = rgb01.flip(1) * 255.0  # scalars: no constant tensor to copy to the card
        x = torch.cat([bgr[:, c:c + 1] - m for c, m in enumerate(_VGG_MEAN_BGR)], dim=1)
        outs = []
        for layer in _VGG_CFG:
            if layer == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, layer[0])(x))
            if layer[0] in _VGG_OUT:
                outs.append(x)
        return tuple(outs)


class _PadConvINPReLU(_PReLUParam):
    """ReflectionPad(1) + 3x3 conv + InstanceNorm + PReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv = _Conv2d(cin, cout, 3, stride, 0)

    def forward(self, x):
        x = self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))
        return _prelu(_instance_norm(x), self.prelu)


class _ResidualBlock(_PReLUParam):
    """Reflect-padded convs and instance norms with one PReLU shared by the
    first conv and the residual sum."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = _Conv2d(c, c, 3, 1, 0)
        self.conv2 = _Conv2d(c, c, 3, 1, 0)

    def forward(self, x):
        y = _prelu(_instance_norm(self.conv1(F.pad(x, (1, 1, 1, 1), mode="reflect"))),
                   self.prelu)
        y = _instance_norm(self.conv2(F.pad(y, (1, 1, 1, 1), mode="reflect")))
        return _prelu(x + y, self.prelu)


def _feature_normalize(x: torch.Tensor) -> torch.Tensor:
    """L2-normalise over channels (NCHW)."""
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10)


class WarpNet(nn.Module):
    """Nonlocal correspondence: ``encode`` fuses a normalised VGG pyramid
    at H/4; ``correlate`` warps the reference LAB onto the frames."""

    def __init__(self, feature_channel: int = 64, inter_channels: int = 256):
        super().__init__()
        fc = feature_channel
        self.l2a, self.l2b = _PadConvINPReLU(128, 128), _PadConvINPReLU(128, fc, 2)
        self.l3a, self.l3b = _PadConvINPReLU(256, 128), _PadConvINPReLU(128, fc)
        self.l4a, self.l4b = _PadConvINPReLU(512, 256), _PadConvINPReLU(256, fc)
        self.l5a, self.l5b = _PadConvINPReLU(512, 256), _PadConvINPReLU(256, fc)
        self.res1 = _ResidualBlock(fc * 4)
        self.res2 = _ResidualBlock(fc * 4)
        self.res3 = _ResidualBlock(fc * 4)
        self.theta = _Conv2d(fc * 4, inter_channels, 1)
        self.phi = _Conv2d(fc * 4, inter_channels, 1)

    def encode(self, feats) -> torch.Tensor:
        """Normalised VGG pyramid (r22..r52, or all five) -> the fused H/4
        feature map."""
        f2, f3, f4, f5 = feats[1:] if len(feats) == 5 else feats
        x2 = self.l2b(self.l2a(f2))
        x3 = self.l3b(self.l3a(f3))
        x4 = _up(self.l4b(self.l4a(f4)), 2)
        x5 = _up(self.l5b(_up(self.l5a(f5), 2)), 2)
        dh, dw = x2.shape[2] - x5.shape[2], x2.shape[3] - x5.shape[3]
        if dh or dw:  # the odd-size rule: edge-pad x5 to x2's size
            x5 = F.pad(x5, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2), mode="replicate")
        return self.res3(self.res2(self.res1(torch.cat([x2, x3, x4, x5], dim=1))))

    def correlate(self, b_lab, a_feat, b_feat, temperature: float = 0.001 * 5):
        """Centred-cosine correspondence and warp.  ``b_lab`` (NCHW LAB) and
        ``b_feat`` may have batch 1 against a batch of ``a_feat``: the
        reference broadcasts.  Returns the warped LAB and the similarity
        map at ``b_lab``'s resolution."""
        theta = self.theta(a_feat)
        phi = self.phi(b_feat)
        b_sz, c, fh, fw = theta.shape
        theta = theta.flatten(2).transpose(1, 2)  # (B, N, C)
        phi = phi.flatten(2).transpose(1, 2)
        theta = theta - theta.mean(dim=1, keepdim=True)
        phi = phi - phi.mean(dim=1, keepdim=True)
        theta = theta / (torch.linalg.vector_norm(theta, dim=-1, keepdim=True) + 1e-10)
        phi = phi / (torch.linalg.vector_norm(phi, dim=-1, keepdim=True) + 1e-10)
        f = torch.matmul(theta, phi.transpose(1, 2))  # (B, N, M), phi broadcasts
        fmax = f.amax(dim=-1, keepdim=True)
        similarity = fmax.reshape(b_sz, 1, fh, fw)
        # the row maximum first, then the temperature: at 1e-10 the logits
        # are <= 0 and exp underflows harmlessly
        attn = torch.softmax((f - fmax) / temperature, dim=-1)
        b_tokens = F.avg_pool2d(b_lab, 4, 4).flatten(2).transpose(1, 2)  # (Bb, M, 3)
        warped = torch.matmul(attn, b_tokens).transpose(1, 2).reshape(b_sz, -1, fh, fw)
        return _up(warped, 4), _up(similarity, 4)

    def forward(self, b_lab, a_feats, b_feats, temperature: float = 0.001 * 5):
        return self.correlate(b_lab, self.encode(a_feats), self.encode(b_feats), temperature)


class _UpConv(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _Conv2d(cin, cout, 3, 1, 1)

    def forward(self, x):
        return self.conv(_up(x, 2))


class ColorVidNet(nn.Module):
    """7-channel input -> ab, ``tanh * 128``: convs with instance norms,
    depthwise stride-2 1x1 downsamples, dilated convs at 1/8, nearest
    upsamples with skips."""

    def __init__(self, in_channels: int = 7):
        super().__init__()

        def conv(cin, cout, dil=1):
            return _Conv2d(cin, cout, 3, 1, dil, dilation=dil)

        def ss(c):
            return _Conv2d(c, c, 1, 2, 0, groups=c, bias=False)

        self.conv1_1a, self.conv1_1b = conv(in_channels, 32), conv(32, 64)
        self.conv1_2, self.conv1_2norm_ss = conv(64, 64), ss(64)
        self.conv2_1, self.conv2_2, self.conv2_2norm_ss = conv(64, 128), conv(128, 128), ss(128)
        self.conv3_1, self.conv3_2, self.conv3_3 = conv(128, 256), conv(256, 256), conv(256, 256)
        self.conv3_3norm_ss = ss(256)
        self.conv4_1, self.conv4_2, self.conv4_3 = conv(256, 512), conv(512, 512), conv(512, 512)
        self.conv5_1, self.conv5_2, self.conv5_3 = (conv(512, 512, 2), conv(512, 512, 2),
                                                    conv(512, 512, 2))
        self.conv6_1, self.conv6_2, self.conv6_3 = (conv(512, 512, 2), conv(512, 512, 2),
                                                    conv(512, 512, 2))
        self.conv7_1, self.conv7_2, self.conv7_3 = conv(512, 512), conv(512, 512), conv(512, 512)
        self.conv8_1, self.conv3_3_short = _UpConv(512, 256), conv(256, 256)
        self.conv8_2, self.conv8_3 = conv(256, 256), conv(256, 256)
        self.conv9_1, self.conv2_2_short = _UpConv(256, 128), conv(128, 128)
        self.conv9_2 = conv(128, 128)
        self.conv10_1, self.conv1_2_short = _UpConv(128, 128), conv(64, 128)
        self.conv10_2 = conv(128, 128)
        self.conv10_ab = _Conv2d(128, 2, 1)

    def forward(self, x):
        r = F.relu
        c11 = r(self.conv1_1b(r(self.conv1_1a(x))))
        c12n = _instance_norm(r(self.conv1_2(c11)))
        c21 = r(self.conv2_1(self.conv1_2norm_ss(c12n)))
        c22n = _instance_norm(r(self.conv2_2(c21)))
        c31 = r(self.conv3_1(self.conv2_2norm_ss(c22n)))
        c33n = _instance_norm(r(self.conv3_3(r(self.conv3_2(c31)))))
        c41 = r(self.conv4_1(self.conv3_3norm_ss(c33n)))
        c43n = _instance_norm(r(self.conv4_3(r(self.conv4_2(c41)))))
        c53n = _instance_norm(r(self.conv5_3(r(self.conv5_2(r(self.conv5_1(c43n)))))))
        c63n = _instance_norm(r(self.conv6_3(r(self.conv6_2(r(self.conv6_1(c53n)))))))
        c73n = _instance_norm(r(self.conv7_3(r(self.conv7_2(r(self.conv7_1(c63n)))))))
        c81c = r(self.conv8_1(c73n) + self.conv3_3_short(c33n))
        c83n = _instance_norm(r(self.conv8_3(r(self.conv8_2(c81c)))))
        c91c = r(self.conv9_1(c83n) + self.conv2_2_short(c22n))
        c92n = _instance_norm(r(self.conv9_2(c91c)))
        c101c = r(self.conv10_1(c92n) + self.conv1_2_short(c12n))
        y = self.conv10_2(c101c)
        c102 = torch.where(y >= 0, y, y * 0.2)  # leaky 0.2
        return torch.tanh(self.conv10_ab(c102)) * 128.0


class DeepEx(nn.Module):
    """The three networks of one engine, named as the converted checkpoint's
    groups (``vgg``, ``warpnet``, ``colorvid``)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG19Features()
        self.warpnet = WarpNet()
        self.colorvid = ColorVidNet()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _center(lab: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """Deep-Exemplar's centred LAB, L - 50 (``sign=1`` undoes it)."""
    return torch.cat([lab[..., 0:1] + sign * 50.0, lab[..., 1:]], dim=-1)


def _gray_rgb(ia_lab: torch.Tensor) -> torch.Tensor:
    """The frame's L / 100 in three NCHW channels (VGG's gray input)."""
    return _nchw(ia_lab[..., 0:1] / 100.0).expand(-1, 3, -1, -1)


def frame_colorization(
    vggnet: VGG19Features,
    warpnet: WarpNet,
    colornet: ColorVidNet,
    ia_lab: torch.Tensor,
    ib_lab: torch.Tensor,
    ia_last_lab: torch.Tensor,
    features_b: Sequence[torch.Tensor],
    temperature: float = 0.01,
):
    """One colorization step: the current frames' LAB ``ia_lab`` (B, H, W,
    3), the reference's ``ib_lab``, the previous prediction
    ``ia_last_lab`` and the reference's VGG features ``features_b``
    (NCHW).  Returns (predicted ab (B, H, W, 2), warped LAB (B, H, W, 3),
    the frames' VGG features)."""
    feats_a = vggnet(_gray_rgb(ia_lab))
    a_norm = tuple(_feature_normalize(f) for f in feats_a)
    b_norm = tuple(_feature_normalize(f) for f in features_b)
    warped_c, similarity = warpnet(_nchw(_center(ib_lab)), a_norm, b_norm, temperature)
    color_input = torch.cat([_nchw(ia_lab[..., 0:1] - 50.0), warped_c[:, 1:3], similarity,
                             _nchw(_center(ia_last_lab))], dim=1)
    ab = colornet(color_input)
    return _nhwc(ab), _center(_nhwc(warped_c), 1.0), feats_a


def _ref_lab_to_rgb(ib_lab: torch.Tensor) -> torch.Tensor:
    return torch.clamp(lab_to_rgb(ib_lab), 0.0, 1.0)


def encode_reference(vggnet: VGG19Features, warpnet: WarpNet, ib_lab: torch.Tensor):
    """The reference's WarpNet feature at H/4 (NCHW), computed once per
    scene: VGG of its RGB, normalised, then ``encode``."""
    with stage_timer("deepex_vgg"):
        feats_b = vggnet(_nchw(_ref_lab_to_rgb(ib_lab)))
    with stage_timer("deepex_warp"):
        return warpnet.encode(tuple(_feature_normalize(f) for f in feats_b))


def frame_colorization_batched(
    vggnet: VGG19Features,
    warpnet: WarpNet,
    colornet: ColorVidNet,
    ia_lab: torch.Tensor,  # (B, H, W, 3) current frames, raw LAB
    ib_lab: torch.Tensor,  # (1, H, W, 3) scene reference, raw LAB
    ia_last_lab: torch.Tensor,  # (1, H, W, 3) pinned last prediction, raw LAB
    b_feat: torch.Tensor,  # (1, 256, h/4, w/4) encode_reference output
    temperature: float = 1e-10,
) -> torch.Tensor:
    """A batch of frames of one scene against its pinned reference and last
    prediction (each frame is independent given them): ab (B, H, W, 2).
    Stage-timed as ``deepex_vgg``, ``deepex_warp`` and ``deepex_colorvid``."""
    with stage_timer("deepex_vgg"):
        feats_a = vggnet(_gray_rgb(ia_lab))
    with stage_timer("deepex_warp"):
        a_feat = warpnet.encode(tuple(_feature_normalize(f) for f in feats_a))
        warped_c, similarity = warpnet.correlate(_nchw(_center(ib_lab)), a_feat, b_feat,
                                                 temperature)
    with stage_timer("deepex_colorvid"):
        last_c = _nchw(_center(ia_last_lab)).expand(ia_lab.shape[0], -1, -1, -1)
        color_input = torch.cat([_nchw(ia_lab[..., 0:1] - 50.0), warped_c[:, 1:3], similarity,
                                 last_c], dim=1)
        return _nhwc(colornet(color_input))


def guided_filter_ab(l_chan: torch.Tensor, ab: torch.Tensor, radius: int = 8,
                     eps: float = 1e-3) -> torch.Tensor:
    """Guided filter of ab (B, H, W, 2) by L / 100 (B, H, W, 1), through
    box means: the cheap edge-aware alternative to the WLS smoother."""

    def box(x):
        return _box_filter_1d(_box_filter_1d(x, radius, -3), radius, -2)

    guide = l_chan / 100.0
    mean_i, mean_p = box(guide), box(ab)
    corr_ip, corr_ii = box(guide * ab), box(guide * guide)
    var_i = corr_ii - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return box(a) * guide + box(b)
