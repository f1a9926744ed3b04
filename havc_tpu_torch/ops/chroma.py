"""Chroma adjustments and the HAVC hue-range mini-language, in PyTorch.

Port of ``havc_tpu.ops.chroma``:

* the hue-range DSL ``"hue1_min:hue1_max,...|adjust,weight"`` with 12
  named hue-wheel sectors, parsed on the host into plain tuples;
* hue-mask desaturation / hue mapping (``adjust_chroma``);
* gray-pixel color restore with a binary mask (``restore_color``) or a
  soft saturation mask (``gradient_mask``, ``restore_color_gradient``);
* HSV/YUV tweaks: saturation, brightness, hue rotation, gamma, percentile
  contrast, and the luma-constrained levels.

Image functions take ``(..., H, W, 3)`` RGB in [0,1].  Thresholds quoted
on the 0..255 scale keep that scale and are divided by 255 inside.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .colorspace import hsv_to_rgb, pymod, rgb_to_hsv, rgb_to_yuv, yuv_to_rgb

__all__ = [
    "HueAdjust",
    "NAMED_HUE_RANGES",
    "get_color_tune",
    "parse_hue_range",
    "parse_hue_ranges",
    "parse_hue_adjust",
    "hue_mask",
    "adjust_chroma",
    "adjust_hue_range",
    "chroma_tweak",
    "tweak",
    "gamma_contrast",
    "brightness",
    "luma_adjusted_levels",
    "restore_color",
    "gradient_mask",
    "restore_color_gradient",
    "weighted_merge",
    "mask_merge",
]

# 12 named hue-wheel sectors of 30 degrees.
NAMED_HUE_RANGES = {
    "red": (0.0, 30.0),
    "orange": (30.0, 60.0),
    "yellow": (60.0, 90.0),
    "yellow-green": (90.0, 120.0),
    "green": (120.0, 150.0),
    "blue-green": (150.0, 180.0),
    "cyan": (180.0, 210.0),
    "blue": (210.0, 240.0),
    "blue-violet": (240.0, 270.0),
    "violet": (270.0, 300.0),
    "red-violet": (300.0, 330.0),
    "rose": (330.0, 360.0),
}


class HueAdjust(NamedTuple):
    """Parsed form of the hue-adjust DSL."""

    ranges: tuple  # ((min_deg, max_deg), ...)
    sat: float
    hue: int  # hue shift in degrees (+/-360)
    weight: float


# Color-tune name -> hue range string
_COLOR_TUNE = {
    "magenta": "270:300",
    "magenta/violet": "270:330",
    "violet": "300:330",
    "violet/red": "300:360",
    "blue/magenta": "240:300",
    "yellow": "60:90",
    "yellow/orange": "30:90",
    "yellow/green": "60:120",
}


def get_color_tune(name: str) -> str:
    """The hue range string of a color-tune name."""
    try:
        return _COLOR_TUNE[name]
    except KeyError:
        raise ValueError(f"HAVC: unknown color tune: {name}")


def parse_hue_range(hue_range: str) -> tuple:
    if hue_range in NAMED_HUE_RANGES:
        return NAMED_HUE_RANGES[hue_range]
    p = hue_range.split(":")
    if len(p) == 2 and p[0].strip().isnumeric() and p[1].strip().isnumeric():
        return (float(p[0]), float(p[1]))
    raise ValueError(f"HAVC: unknown hue name: {hue_range}")


def parse_hue_ranges(ranges: str) -> tuple:
    return tuple(parse_hue_range(r) for r in ranges.split(","))


def _isfloat(x: str) -> bool:
    try:
        float(x)
        return True
    except ValueError:
        return False


def parse_hue_adjust(hue_adjust: str):
    """Parse ``"range1,...,rangeN|adjust,weight"``; returns HueAdjust or None.

    ``adjust`` in (0,10) is a saturation factor; a signed integer is a hue
    shift in degrees.
    """
    if hue_adjust in ("", "none", None):
        return None
    p = hue_adjust.split("|")
    sat, hue, weight = 1.0, 0, 0.0
    if len(p) < 1 or len(p) > 2:
        return None
    try:
        ranges = parse_hue_ranges(p[0])
    except ValueError:
        return None
    if len(p) == 1:
        return HueAdjust(ranges, sat, hue, weight)
    sw = p[1].split(",")
    if len(sw) != 2 or not _isfloat(sw[0]) or not _isfloat(sw[1]):
        return None
    if sw[0][0] in ("-", "+"):
        hue = int(float(sw[0]))
    else:
        sat = float(sw[0])
    if sat > 10:  # fix wrong input (reference behaviour)
        hue = int(sat)
        sat = 1.0
    weight = float(sw[1])
    return HueAdjust(ranges, sat, hue, weight)


# --- elementary kernels ------------------------------------------------------


def weighted_merge(a: torch.Tensor, b: torch.Tensor, w) -> torch.Tensor:
    """``a*(1-w) + b*w``; w may be a scalar or a broadcastable tensor."""
    return a + (b - a) * w


def mask_merge(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mask==1 -> b, mask==0 -> a.  ``mask`` shape (..., H, W) or (...,H,W,1)."""
    if mask.ndim == a.ndim - 1:
        mask = mask[..., None]
    return a * (1.0 - mask) + b * mask


def hue_mask(rgb: torch.Tensor, ranges: Sequence[tuple]) -> torch.Tensor:
    """Mask of pixels whose hue lies strictly inside any (min, max) range."""
    h_deg = rgb_to_hsv(rgb)[..., 0] * 360.0
    cond = torch.zeros(h_deg.shape, dtype=torch.bool, device=rgb.device)
    for hue_min, hue_max in ranges:
        cond = cond | ((h_deg > hue_min) & (h_deg < hue_max))
    return cond.to(rgb.dtype)


def _hue_add(h: torch.Tensor, hue_deg: float) -> torch.Tensor:
    """Rotate the hue channel (turns) by ``hue_deg`` degrees, clamped to
    +/-360."""
    if hue_deg == 0:
        return h
    shift = min(max(int(hue_deg), -360), 360) / 360.0
    return pymod(h + shift, 1.0)


def _hsv_tweak(rgb, hue=0, sat=1.0, bright=0.0) -> torch.Tensor:
    hsv = rgb_to_hsv(rgb)
    h = _hue_add(hsv[..., 0], hue)
    s = torch.clamp(hsv[..., 1] * min(max(sat, 0.0), 10.0), 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] * min(max(1.0 + bright, 0.0), 10.0), 0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def adjust_chroma(
    rgb: torch.Tensor,
    ranges: Sequence[tuple],
    sat: float = 0.3,
    hue: int = 0,
    weight: float = 0.0,
) -> torch.Tensor:
    """Desaturate / hue-shift only the pixels inside the hue ranges."""
    if not ranges:
        return rgb
    hsv = rgb_to_hsv(rgb)
    h = _hue_add(hsv[..., 0], hue)
    s = torch.clamp(hsv[..., 1] * min(max(sat, 0.0), 10.0), 0.0, 1.0)
    modified = hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], dim=-1))
    mask = hue_mask(rgb, ranges)
    out = mask_merge(rgb, modified, mask)
    if weight > 0:
        # hue==0: pull toward the modified (desaturated) image; hue!=0: pull
        # back toward the original colors
        target = modified if hue == 0 else rgb
        out = weighted_merge(out, target, weight)
    elif weight < 0:
        out = weighted_merge(out, rgb, -weight)
    return out


def adjust_hue_range(rgb: torch.Tensor, hue_adjust: str) -> torch.Tensor:
    """String-DSL entry point."""
    param = parse_hue_adjust(hue_adjust)
    if param is None:
        return rgb
    return adjust_chroma(rgb, param.ranges, param.sat, param.hue, param.weight)


def chroma_tweak(
    rgb: torch.Tensor,
    sat: float = 1.0,
    bright: float = 0.0,
    hue: int = 0,
    hue_adjust: str = "none",
) -> torch.Tensor:
    """HSV saturation/brightness/hue tweak + optional hue-range adjust.
    ``bright`` scales V by ``(1 + bright)``."""
    if sat == 1 and bright == 0 and hue == 0 and hue_adjust in ("none", ""):
        return rgb
    out = _hsv_tweak(rgb, hue=hue, sat=sat, bright=bright)
    param = parse_hue_adjust(hue_adjust)
    if param is None:
        return out
    return adjust_chroma(out, param.ranges, param.sat, param.hue, param.weight)


def _percentile(y: torch.Tensor, perc: float) -> torch.Tensor:
    """Per-frame percentile over the last two axes, linear interpolation
    weighted as ``jnp.percentile`` does (its float32 index arithmetic,
    done on the host: nothing waits for the card); returns shape
    (..., 1, 1)."""
    flat = torch.sort(y.flatten(-2), dim=-1).values
    n = flat.shape[-1]
    q = np.float32(perc / 100.0 * (n - 1))
    low = np.floor(q)
    high_w = np.float32(q - low)
    lo_i = int(low)
    hi_i = min(lo_i + 1, n - 1)
    out = flat[..., lo_i] * float(np.float32(1.0) - high_w) + flat[..., hi_i] * float(high_w)
    return out[..., None, None]


def gamma_contrast(
    rgb: torch.Tensor, gamma: float = 1.0, cont: float = 1.0, perc: float = 5.0
) -> torch.Tensor:
    """Luma percentile contrast stretch (factor ``cont`` between the
    ``perc`` / ``100-perc`` percentiles of each frame) then gamma
    ``y ** (1/gamma)``, in YUV."""
    if cont == 1.0 and gamma == 1.0:
        return rgb
    yuv = rgb_to_yuv(rgb)
    y = yuv[..., 0]
    if cont != 1.0:
        y_min = _percentile(y, perc)
        y_max = _percentile(y, 100.0 - perc)
        y_fix = torch.minimum(torch.maximum(y, y_min), y_max)
        y = torch.clamp(
            (y_fix - y_min) * cont / torch.clamp(y_max - y_min, min=1e-6), 0.0, 1.0
        )
    if gamma != 1.0:
        y = torch.clamp(y, 0.0, 1.0) ** (1.0 / gamma)
    return yuv_to_rgb(torch.stack([y, yuv[..., 1], yuv[..., 2]], dim=-1))


def brightness(rgb: torch.Tensor, bright: float = 0.0) -> torch.Tensor:
    """Add ``bright`` (fraction of full scale) to luma."""
    if bright == 0:
        return rgb
    yuv = rgb_to_yuv(rgb)
    y = torch.clamp(yuv[..., 0] + bright, 0.0, 1.0)
    return yuv_to_rgb(torch.stack([y, yuv[..., 1], yuv[..., 2]], dim=-1))


def tweak(
    rgb: torch.Tensor,
    hue: float = 0.0,
    sat: float = 1.0,
    bright: float = 0.0,
    cont: float = 1.0,
    gamma: float = 1.0,
) -> torch.Tensor:
    """Full hue/sat/bright/cont/gamma tweak: gamma and contrast act on
    luma (YUV); hue/sat act in HSV; bright scales V."""
    out = rgb
    if cont != 1.0 or gamma != 1.0:
        out = gamma_contrast(out, gamma=gamma, cont=cont)
    if sat != 1.0 or hue != 0.0 or bright != 0.0:
        out = _hsv_tweak(out, hue=hue, sat=sat, bright=bright)
    return out


def luma_adjusted_levels(
    rgb: torch.Tensor,
    luma_min: float = 0.0,
    gamma: float = 1.0,
    gamma_luma_min: float = 0.0,
    gamma_alpha: float = 0.0,
    gamma_min: float = 0.2,
) -> torch.Tensor:
    """Lift each frame's mean luma to at least ``luma_min``; apply a
    luma-gated gamma to frames darker than ``gamma_luma_min``.  The
    per-frame branches are selections on the frame's mean luma."""
    yuv = rgb_to_yuv(rgb)
    y = yuv[..., 0]
    frame_luma = torch.mean(y, dim=(-2, -1), keepdim=True)
    lift = torch.where(frame_luma < luma_min, luma_min - frame_luma, 0.0)
    y_new = torch.clamp(y + lift, 0.0, 1.0)
    if gamma != 1.0:
        if gamma_alpha != 0.0:
            g = torch.clamp(
                gamma * (frame_luma / max(gamma_luma_min, 1e-6)) ** gamma_alpha,
                min=gamma_min,
            )
        else:
            g = torch.full_like(frame_luma, gamma)
        y_gamma = torch.clamp(y_new, 0.0, 1.0) ** (1.0 / torch.clamp(g, min=1e-6))
        y_new = torch.where(frame_luma < gamma_luma_min, y_gamma, y_new)
    return yuv_to_rgb(torch.stack([y_new, yuv[..., 1], yuv[..., 2]], dim=-1))


# --- gray-pixel color restore ------------------------------------------------


def restore_color(
    color: torch.Tensor,
    gray: torch.Tensor,
    sat: float = 1.0,
    tht: int = 15,
    weight: float = 0.0,
    tht_scen: float = 0.8,
    hue_adjust: str = "none",
    return_mask: bool = False,
):
    """Restore colors of gray pixels in ``gray`` from ``color``.

    A pixel is gray when its HSV saturation is below ``tht/255``; a frame
    whose gray share exceeds ``tht_scen`` is taken for a scene cut and
    left as it is (a per-frame selection).
    """
    hsv_color = rgb_to_hsv(color)
    s_scaled = torch.clamp(hsv_color[..., 1] * min(max(sat, 0.0), 10.0), 0.0, 1.0)
    color_sat = hsv_to_rgb(
        torch.stack([hsv_color[..., 0], s_scaled, hsv_color[..., 2]], dim=-1)
    )
    s_gray = rgb_to_hsv(gray)[..., 1]
    mask = (s_gray < tht / 255.0).to(gray.dtype)
    if return_mask:
        return mask
    restored = mask_merge(gray, color_sat, mask)
    if weight > 0:
        restored = weighted_merge(restored, gray, weight)
    elif weight < 0:
        restored = weighted_merge(restored, color_sat, -weight)
    if 0.0 < tht_scen < 1.0:
        scenechange = torch.mean(mask, dim=(-2, -1))[..., None, None, None]
        restored = torch.where(scenechange > tht_scen, gray, restored)
    param = parse_hue_adjust(hue_adjust)
    if param is not None:
        restored = adjust_chroma(
            restored, param.ranges, param.sat, param.hue, param.weight
        )
    return restored


def gradient_mask(saturation: torch.Tensor, tht: int = 15, alpha: float = 2.0,
                  algo: int = 0) -> torch.Tensor:
    """Soft "is gray" mask in [0,1] from an HSV saturation channel in
    [0,1]; ``tht`` on the 0..255 scale.  Decay ``algo``: 0 linear with a
    steep gradient, 1 power law, 2 exponential (0.5 at ``tht``, 0 from
    ``2 * tht``)."""
    s255 = saturation * 255.0
    tht = int(min(max(tht, 0), 255))
    if tht == 0:
        return torch.zeros_like(saturation)
    if algo == 0:
        steep = 2.0
        grad = torch.where(s255 < tht, steep * s255 / alpha - tht, steep * (s255 - tht) * alpha)
        return torch.clamp(255.0 - tht - grad, 0.0, 255.0) / 255.0
    if algo == 1:
        max_s = min(2 * tht, 200)
        s_c = torch.clamp(s255, 0.0, max_s)
        return (1.0 - s_c / max_s) ** alpha
    s_rel = torch.clamp(s255 / tht, 0.0, 2.0)
    mask = torch.exp(-alpha * s_rel * math.log(2.0))
    return torch.where(s255 >= 2 * tht, 0.0, mask)


def restore_color_gradient(
    color: torch.Tensor,
    gray: torch.Tensor,
    sat: float = 1.0,
    tht: int = 50,
    weight: float = 0.0,
    alpha: float = 2.0,
    algo: int = 0,
    return_mask: bool = False,
):
    """``restore_color`` with the soft ``gradient_mask`` in place of the
    binary one, and no scene-cut gate."""
    hsv_color = rgb_to_hsv(color)
    if sat != 1.0:
        s_scaled = torch.clamp(hsv_color[..., 1] * min(max(sat, 0.0), 10.0), 0.0, 1.0)
        hsv_color = torch.stack([hsv_color[..., 0], s_scaled, hsv_color[..., 2]], dim=-1)
    color_sat = hsv_to_rgb(hsv_color)
    mask = gradient_mask(rgb_to_hsv(gray)[..., 1], tht, alpha, algo)
    if return_mask:
        return mask
    restored = mask_merge(gray, color_sat, mask)
    if weight > 0:
        restored = weighted_merge(restored, color_sat, weight)
    elif weight < 0:
        restored = weighted_merge(restored, gray, -weight)
    return restored
