"""Multi-scale retinex (MSR / MSRCP), in PyTorch.

Port of ``havc_tpu.ops.retinex`` (rgb_equalizer method 5, the
``retinex/red`` ColorFix prefilter and ``HAVC_retinex``).  Each Gaussian
blur (sigmas 25/80/250) is three iterated box filters, each a cumulative
sum along one axis: O(N) per scale at any sigma.  At sigma 250 the box
radius is 249, so a cumulative sum runs over up to ``W + 499`` samples; a
sum in another order (XLA's, or the card's parallel scan) moves a blurred
value by a few float32 ulps of the running sum.

The histogram-tail quantiles are ``jnp.quantile``'s linear interpolation,
computed here from one sort per frame (``torch.quantile`` refuses inputs
of more than 2^24 values, which a batch of 1080p frames exceeds).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .colorspace import luma, rgb_to_yuv, yuv_to_rgb

__all__ = ["gaussian_blur_box", "msr", "msrcp_rgb", "msr_yuv", "msr_luma", "msrcp",
           "retinex_filter", "quantile_linear"]


def _box_filter_1d(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """Mean filter of width ``2 * radius + 1`` along ``axis`` by a
    cumulative sum over the edge-padded signal."""
    if radius <= 0:
        return x
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(-(radius + 1), n + radius, device=x.device), 0, n - 1)
    c = torch.cumsum(x.index_select(axis, idx), dim=axis)
    hi = c.narrow(axis, 2 * radius + 1, n)
    lo = c.narrow(axis, 0, n)
    return (hi - lo) / (2 * radius + 1)


def _box_radius_for_sigma(sigma: float, passes: int = 3) -> int:
    w = math.sqrt(12.0 * sigma * sigma / passes + 1.0)
    return max(int((w - 1) / 2), 1)


def gaussian_blur_box(x: torch.Tensor, sigma: float, passes: int = 3) -> torch.Tensor:
    """Gaussian blur of ``(..., H, W)`` approximated by iterated box filters."""
    r = _box_radius_for_sigma(sigma, passes)
    out = x
    for _ in range(passes):
        out = _box_filter_1d(out, r, axis=out.ndim - 2)
        out = _box_filter_1d(out, r, axis=out.ndim - 1)
    return out


def quantile_linear(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(flat, q, axis=-1)`` (linear interpolation), with its
    float32 index arithmetic, over rows that need not fit
    ``torch.quantile``'s size limit."""
    srt = torch.sort(flat, dim=-1).values
    n = flat.shape[-1]
    pos = np.float32(q) * np.float32(n - 1)
    low = np.floor(pos)
    high_w = np.float32(pos - low)
    low_w = np.float32(1.0) - high_w
    lo_i = int(min(max(low, 0), n - 1))
    hi_i = int(min(max(np.ceil(pos), 0), n - 1))
    # lo * low_w + hi * high_w with the first product fused into the add,
    # as XLA contracts it (exact in float64, then rounded once)
    hi_part = (srt[..., hi_i] * float(high_w)).double()
    return (srt[..., lo_i].double() * float(low_w) + hi_part).float()


def msr(intensity: torch.Tensor, sigmas=(25.0, 80.0, 250.0), lower_thr: float = 0.001,
        upper_thr: float = 0.001) -> torch.Tensor:
    """Multi-scale retinex of single-channel images ``(..., H, W)`` in
    [0,1]: the mean over scales of ``log(I + 1/255) - log(G * I + 1/255)``,
    then the histogram tails (``lower_thr``/``upper_thr`` quantiles) clipped
    and the rest stretched to [0,1]."""
    eps = 1.0 / 255.0
    log_i = torch.log(intensity + eps)
    acc = torch.zeros_like(intensity)
    for s in sigmas:
        acc = acc + (log_i - torch.log(gaussian_blur_box(intensity, s) + eps))
    out = acc / len(sigmas)
    flat = out.reshape(out.shape[:-2] + (-1,))
    lo = quantile_linear(flat, lower_thr)[..., None, None]
    hi = quantile_linear(flat, 1.0 - upper_thr)[..., None, None]
    return torch.clamp((out - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


def msrcp_rgb(rgb: torch.Tensor, sigmas=(25.0, 80.0, 250.0), lower_thr: float = 0.001,
              upper_thr: float = 0.001) -> torch.Tensor:
    """MSRCP: MSR on the intensity ``(R+G+B)/3``, then every channel of a
    pixel scaled by the same gain ``I_out / I_in``, capped so that its
    largest channel reaches at most 1 (hue preserved)."""
    inten = torch.mean(rgb, dim=-1)
    enhanced = msr(inten, sigmas, lower_thr, upper_thr)
    eps = 1.0 / 255.0
    gain = enhanced / torch.clamp(inten, min=eps)
    peak = torch.amax(rgb, dim=-1)
    gain = torch.minimum(gain, 1.0 / torch.clamp(peak, min=eps))
    return torch.clamp(rgb * gain[..., None], 0.0, 1.0)


def msr_yuv(rgb: torch.Tensor, sigmas=(25.0, 80.0, 250.0), range_tv: bool = False) -> torch.Tensor:
    """MSR on the Y plane only, min-max normalised to the output range
    (studio swing with ``range_tv``), chroma untouched."""
    yuv = rgb_to_yuv(rgb)
    y = yuv[..., 0]
    eps = 1.0 / 255.0
    log_i = torch.log(y + eps)
    acc = torch.zeros_like(y)
    for s in sigmas:
        acc = acc + (log_i - torch.log(gaussian_blur_box(y, s) + eps))
    out = acc / len(sigmas)
    lo = torch.amin(out, dim=(-2, -1), keepdim=True)
    hi = torch.amax(out, dim=(-2, -1), keepdim=True)
    mn, mx = (16.0 / 255.0, 235.0 / 255.0) if range_tv else (0.0, 1.0)
    y_norm = (out - lo) / torch.clamp(hi - lo, min=1e-6) * (mx - mn) + mn
    out_yuv = torch.stack([torch.clamp(y_norm, mn, mx), yuv[..., 1], yuv[..., 2]], dim=-1)
    return torch.clamp(yuv_to_rgb(out_yuv), 0.0, 1.0)


def _luma_blend(orig, new, f_luma, luma_limit=0.40, alpha=0.90, min_w=0.25, decay=3.0):
    """Dark frames keep a share of the original: the weight of ``new``
    ramps as ``(luma / limit) ** decay``, floored at ``min_w``."""
    bright_scale = torch.clamp((f_luma / luma_limit) ** decay, 0.0, 1.0)
    w = torch.clamp(alpha * bright_scale, min=min_w)
    w = torch.where(f_luma < luma_limit, w, 1.0)[..., None, None, None]
    return orig * (1.0 - w) + new * w


def retinex_filter(
    rgb: torch.Tensor,
    luma_dark: float = 0.20,
    luma_bright: float = 0.80,
    sigmas=(25.0, 80.0, 250.0),
    range_tv: bool = True,
    blend: bool = False,
    fast_mode: bool = True,
) -> torch.Tensor:
    """The Retinex wrapper over ``(T, H, W, 3)`` or ``(H, W, 3)``: MSRCP
    (``fast_mode``) or MSR on Y, applied to frames whose mean luma lies in
    [luma_dark, luma_bright] (the others pass through), with an optional
    dark-frame blend ramp."""
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    y = luma(rgb)
    if range_tv:
        f_luma = torch.clamp(torch.mean(y, dim=(-2, -1)) / (235.0 / 255.0) - 0.07, min=0.0)
    else:
        f_luma = torch.mean(y, dim=(-2, -1))
    filt = msrcp_rgb(rgb, sigmas) if fast_mode else msr_yuv(rgb, sigmas, range_tv=not range_tv)
    if blend:
        min_w, decay = (0.25, 3.0) if fast_mode else (0.15, 4.0)
        filt = _luma_blend(rgb, filt, f_luma, 0.40, 0.90, min_w, decay)
    in_range = (f_luma >= luma_dark) & (f_luma <= luma_bright)
    out = torch.where(in_range[..., None, None, None], filt, rgb)
    return out[0] if single else out


def msr_luma(rgb, sigmas=(25.0, 80.0, 250.0), chroma_protect=None):
    """rgb_equalizer method 5: MSRCP on RGB."""
    return msrcp_rgb(rgb, sigmas)


msrcp = msrcp_rgb
