"""Frozen copy of the port's ``havc_tpu_torch/filters.py`` (the benchmark's plain
reference).

Clip-level filters over ``(T, H, W, 3)`` RGB [0,1] frames, in PyTorch.

Port of ``havc_tpu.filters``: dark tweak, chroma-bright tweak, colormap,
luma-constrained tweak, luma recovery and the spline64 chroma restore.
The stabilizer's unfused branch runs these; its fused branch runs the
post-chain kernel (``ops/post_chain.py``).
"""
from __future__ import annotations

import torch

from .ops.chroma import adjust_hue_range, chroma_tweak, luma_adjusted_levels, tweak
from .ops.colorspace import copy_chroma, rgb_to_yuv, yuv_to_rgb
from .ops.merge import luma_masked_merge, w_luma_masked_merge
from .ops.resize import resize

__all__ = [
    "dark_tweak",
    "chroma_bright_tweak",
    "colormap_filter",
    "constrained_tweak",
    "recover_clip_luma",
    "recover_clip_luma_y",
    "chroma_resize_restore",
]


def dark_tweak(
    x: torch.Tensor,
    dark_threshold: float = 0.3,
    dark_amount: float = 0.8,
    dark_hue_adjust: str = "none",
) -> torch.Tensor:
    """Darken + desaturate dark regions.  The white limit clamps
    dark_threshold to [0.1, 0.5], sat = 1.1-amount in [0.1, 0.8],
    bright = -amount."""
    d_threshold = 0.1
    d_white = min(max(dark_threshold, d_threshold), 0.50)
    d_sat = min(max(1.1 - dark_amount, 0.10), 0.80)
    d_bright = -min(max(dark_amount, 0.20), 0.90)
    dark_img = tweak(x, bright=d_bright, sat=d_sat)
    if dark_hue_adjust not in ("none", ""):
        dark_img = adjust_hue_range(dark_img, dark_hue_adjust)
    if d_threshold == d_white:
        return luma_masked_merge(dark_img, x, d_threshold)
    return w_luma_masked_merge(dark_img, x, d_threshold, d_white)


def chroma_bright_tweak(
    x: torch.Tensor,
    black_threshold: float = 0.3,
    white_threshold: float = 0.6,
    dark_sat: float = 0.8,
    dark_bright: float = -0.10,
    chroma_adjust: str = "none",
) -> torch.Tensor:
    """Luma-gradient saturation smoothing."""
    dark_img = chroma_tweak(x, sat=dark_sat, bright=dark_bright, hue_adjust=chroma_adjust)
    if black_threshold == white_threshold:
        return luma_masked_merge(dark_img, x, black_threshold)
    return w_luma_masked_merge(dark_img, x, black_threshold, white_threshold)


def colormap_filter(x: torch.Tensor, colormap_adjust: str = "none") -> torch.Tensor:
    """Direct hue color mapping."""
    if colormap_adjust in ("none", ""):
        return x
    return chroma_tweak(x, hue_adjust=colormap_adjust)


def constrained_tweak(
    x: torch.Tensor,
    luma_min: float = 0.1,
    gamma: float = 1.0,
    gamma_luma_min: float = 0.0,
    gamma_alpha: float = 0.0,
    gamma_min: float = 0.5,
) -> torch.Tensor:
    """Luma-constrained gamma."""
    return luma_adjusted_levels(x, luma_min, gamma, gamma_luma_min, gamma_alpha, gamma_min)


def recover_clip_luma(hires: torch.Tensor, colored: torch.Tensor) -> torch.Tensor:
    """Chroma of ``colored`` on the luma of ``hires``."""
    return torch.clamp(copy_chroma(colored, hires), 0.0, 1.0)


def recover_clip_luma_y(y: torch.Tensor, colored: torch.Tensor) -> torch.Tensor:
    """``recover_clip_luma`` from the luma plane ``(..., H, W)`` itself:
    the same output, and a third of the memory for a caller that keeps
    the luma (streaming's rolling full-resolution buffer)."""
    yuv = rgb_to_yuv(colored)
    return torch.clamp(yuv_to_rgb(torch.stack([y, yuv[..., 1], yuv[..., 2]], dim=-1)), 0.0, 1.0)


def chroma_resize_restore(hires: torch.Tensor, lowres: torch.Tensor) -> torch.Tensor:
    """Spline64 upscale of ``lowres`` + luma copy-back from ``hires``."""
    h, w = hires.shape[-3], hires.shape[-2]
    up = resize(lowres, h, w, "spline64")
    return recover_clip_luma(hires, up)
