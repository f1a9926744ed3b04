"""Frozen copy of the port's ``havc_tpu_torch/ops/equalize.py`` (the benchmark's plain
reference).

Histogram equalization / auto-levels (CLAHE, EQ, ScaleAbs, white balance),
in PyTorch.

Port of ``havc_tpu.ops.equalize`` (``rgb_equalizer`` methods 0-5):

* method 0: CLAHE on luma (YUV), luma-gated and luma-blended
* method 1: global histogram equalization per RGB channel
* method 2: CLAHE per RGB channel
* method 3: blend of 0 and 1
* method 4: ScaleAbs auto-contrast (histogram-percentile clip + stretch)
* method 5: multi-scale retinex (``ops/retinex.py``)

The JAX package counts histograms with a 256-wide one-hot contraction and
maps CLAHE pixels through a gathered ``(..., H, W, 256)`` LUT tensor, both
of which XLA fuses away.  Here nothing 256-wide per pixel is built: the
bins are counted per frame (per tile) with ``scatter_add_``, and each
pixel gathers the two LUT entries it needs from the flat table at index
``tile * 256 + bin``.  The counts are exact in float32 (below 2^24), the
bin rule is the JAX package's truncating ``int(x * 255)``, and the LUT
lookup is its floor-and-interpolate ``_lut_apply`` operation for
operation.

The CLAHE tile coordinates ``(i + 0.5) / t - 0.5`` are computed as XLA
computes them under ``jax.jit`` (the way the JAX package's BW tune runs):
one fused multiply-add by float32(1/t), rounded once.  At an odd tile size
the first tile's centre then lands just below 0 (-8.8e-9 at t = 135, the
tile height of 1080p), so its row takes the second tile's LUT; an exact
division would give 0 and the first tile's.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .colorspace import luma, rgb_to_yuv, yuv_to_rgb
from .merge import luma_blend

__all__ = [
    "histogram256",
    "equalize_hist_channel",
    "clahe_channel",
    "clahe_luma",
    "clahe_rgb",
    "equalize_rgb",
    "scale_abs_autolevels",
    "rgb_equalizer",
    "adjust_rgb",
    "rgb_balance",
]

# Luma gates (reference constants.py:45-46).
DEF_THT_DARK_BLACK = 0.15
DEF_THT_BRIGHT_WHITE = 0.70


def _bins(x: torch.Tensor) -> torch.Tensor:
    """The bin of each value: ``clip(int(x * 255), 0, 255)`` (truncating)."""
    return torch.clamp((x * 255.0).to(torch.int32), 0, 255).to(torch.int64)


def _count(index: torch.Tensor, rows: int) -> torch.Tensor:
    """``(rows, 256)`` float32 counts of the flat bin indices ``index``
    (``row * 256 + bin``)."""
    hist = torch.zeros(rows * 256, dtype=torch.float32, device=index.device)
    flat = index.reshape(-1)
    hist.scatter_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32, device=index.device))
    return hist.reshape(rows, 256)


def histogram256(x: torch.Tensor) -> torch.Tensor:
    """256-bin histogram over the last axis (values in [0,1]):
    ``(..., N) -> (..., 256)``."""
    lead = tuple(x.shape[:-1])
    rows = math.prod(lead)
    b = _bins(x).reshape(rows, -1)
    b = b + 256 * torch.arange(rows, device=x.device)[:, None]
    return _count(b, rows).reshape(lead + (256,))


def _lut_apply(x: torch.Tensor, flat_lut: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Map values in [0,1] through 256-entry LUTs with linear interpolation:
    ``flat_lut`` holds the tables end to end, ``base`` is each value's
    table offset (a multiple of 256, broadcastable to ``x``)."""
    xf = torch.clamp(x * 255.0, 0.0, 255.0)
    lo = torch.floor(xf).to(torch.int32)
    hi = torch.clamp(lo + 1, max=255)
    frac = xf - lo
    v_lo = flat_lut[base + lo]
    v_hi = flat_lut[base + hi]
    return v_lo * (1.0 - frac) + v_hi * frac


def equalize_hist_channel(x: torch.Tensor) -> torch.Tensor:
    """Global histogram equalization of one channel, ``(..., H, W)`` in
    [0,1] (cv2.equalizeHist: the cdf less its first non-zero value,
    normalised to [0,255])."""
    shape = x.shape
    flat = x.reshape(shape[:-2] + (-1,))
    hist = histogram256(flat)
    cdf = torch.cumsum(hist, dim=-1)
    total = cdf[..., -1:]
    cdf_min = torch.amin(torch.where(cdf > 0, cdf, torch.inf), dim=-1, keepdim=True)
    lut = torch.clamp((cdf - cdf_min) / torch.clamp(total - cdf_min, min=1.0), 0.0, 1.0)
    rows = lut.numel() // 256
    base = (256 * torch.arange(rows, device=x.device)).reshape(flat.shape[:-1] + (1,))
    return _lut_apply(flat, lut.reshape(-1), base).reshape(shape)


def _clahe_luts(hist: torch.Tensor, npix: int, clip_limit: float, nbins: int = 256) -> torch.Tensor:
    """Clip-limited equalization LUTs from per-tile histograms
    ``(..., 256)``; ``npix`` pixels per tile."""
    if clip_limit > 0:
        limit = max(clip_limit * npix / nbins, 1.0)
        excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=-1, keepdim=True)
        hist = torch.clamp(hist, max=limit) + excess / nbins
    cdf = torch.cumsum(hist, dim=-1)
    return torch.clamp((cdf - cdf[..., :1]) / torch.clamp(npix - cdf[..., :1], min=1.0), 0.0, 1.0)


@functools.lru_cache(maxsize=64)
def _tile_coords(n: int, t: int, device: torch.device) -> torch.Tensor:
    """Tile-space coordinates ``(i + 0.5) / t - 0.5`` of ``n`` pixels as
    XLA's ``fma(i + 0.5, float32(1/t), -0.5)``: the float64 product and
    difference are exact, so one rounding to float32 equals the fma's.
    Made once per (n, t, device): no host copy inside a frame loop."""
    i = np.arange(n, dtype=np.float64)
    c = (i + 0.5) * np.float64(np.float32(1.0 / t)) - 0.5
    return torch.from_numpy(c.astype(np.float32)).to(device)


def clahe_channel(x: torch.Tensor, clip_limit: float = 2.0, gridsize: int = 8) -> torch.Tensor:
    """CLAHE on single-channel images ``(..., H, W)`` in [0,1]: per-tile
    clipped histograms -> per-tile LUTs; each pixel is mapped through the
    4 neighbouring tiles' LUTs and blended bilinearly by its distance to
    their centres.  The image is edge-padded to a multiple of the grid."""
    shape = x.shape
    h, w = shape[-2], shape[-1]
    gh = gw = gridsize
    th, tw = -(-h // gh), -(-w // gw)
    x3 = x.reshape(-1, h, w)
    n = x3.shape[0]
    dev = x.device
    xp = F.pad(x3[:, None], (0, tw * gw - w, 0, th * gh - h), mode="replicate")[:, 0]
    # tile row of every padded pixel: (frame * gh + ty) * gw + tx
    ty = torch.arange(th * gh, device=dev) // th
    tx = torch.arange(tw * gw, device=dev) // tw
    tile = ((torch.arange(n, device=dev)[:, None, None] * gh + ty[None, :, None]) * gw
            + tx[None, None, :])
    hist = _count(tile * 256 + _bins(xp), n * gh * gw)
    luts = _clahe_luts(hist, th * tw, clip_limit).reshape(-1)

    # bilinear interpolation between tile mappings
    # (the top and left half-tiles blend toward tile 1: y0 is clamped
    # before y1 = y0 + 1 is formed, the JAX package's convention)
    yy, xx = _tile_coords(h, th, dev), _tile_coords(w, tw, dev)
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, gh - 1)
    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, gw - 1)
    y1 = torch.clamp(y0 + 1, 0, gh - 1)
    x1 = torch.clamp(x0 + 1, 0, gw - 1)
    fy = torch.clamp(yy - torch.floor(yy), 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - torch.floor(xx), 0.0, 1.0)[None, :]
    frame = torch.arange(n, device=dev)[:, None, None] * gh

    def gather_map(ty_, tx_):
        base = ((frame + ty_[None, :, None]) * gw + tx_[None, None, :]) * 256
        return _lut_apply(x3, luts, base)

    top = gather_map(y0, x0) * (1 - fx) + gather_map(y0, x1) * fx
    bot = gather_map(y1, x0) * (1 - fx) + gather_map(y1, x1) * fx
    return (top * (1 - fy) + bot * fy).reshape(shape)


def clahe_luma(rgb: torch.Tensor, clip_limit: float = 2.0, gridsize: int = 8) -> torch.Tensor:
    """CLAHE on the luma channel only (method 0)."""
    yuv = rgb_to_yuv(rgb)
    y_eq = clahe_channel(yuv[..., 0], clip_limit, gridsize)
    out = yuv_to_rgb(torch.stack([y_eq, yuv[..., 1], yuv[..., 2]], dim=-1))
    return torch.clamp(out, 0.0, 1.0)


def equalize_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """Global histogram equalization per RGB channel (method 1)."""
    return torch.stack([equalize_hist_channel(rgb[..., c]) for c in range(3)], dim=-1)


def clahe_rgb(rgb: torch.Tensor, clip_limit: float = 2.0, gridsize: int = 8) -> torch.Tensor:
    """CLAHE per RGB channel (method 2)."""
    return torch.stack([clahe_channel(rgb[..., c], clip_limit, gridsize) for c in range(3)],
                       dim=-1)


def scale_abs_autolevels(rgb: torch.Tensor, clip_hist_percent: float = 1.0) -> torch.Tensor:
    """Auto brightness/contrast (method 4): the gray levels that cut
    ``clip_hist_percent / 2`` % of the mass on each side are stretched to
    the full range by ``alpha * x + beta``."""
    gray = luma(rgb)
    flat = gray.reshape(gray.shape[:-2] + (-1,))
    hist = histogram256(flat)
    cdf = torch.cumsum(hist, dim=-1)
    total = cdf[..., -1:]
    cut = total * clip_hist_percent / 200.0
    bins = torch.arange(256, dtype=torch.float32, device=rgb.device)
    min_gray = torch.amin(torch.where(cdf > cut, bins, 255.0), dim=-1, keepdim=True)
    max_gray = torch.amax(torch.where(cdf < total - cut, bins, 0.0), dim=-1, keepdim=True)
    spread = torch.clamp(max_gray - min_gray, min=1.0)
    alpha = 255.0 / spread
    beta = -min_gray * alpha
    sh = gray.shape[:-2] + (1, 1, 1)
    return torch.clamp(rgb * alpha.reshape(sh) + beta.reshape(sh) / 255.0, 0.0, 1.0)


def _luma_gate(orig: torch.Tensor, filtered: torch.Tensor) -> torch.Tensor:
    """Frames whose mean luma lies outside [0.15, 0.70] pass through
    unfiltered (the reference returns early on them)."""
    fl = torch.mean(luma(orig), dim=(-2, -1))[..., None, None, None]
    ok = (fl >= DEF_THT_DARK_BLACK) & (fl <= DEF_THT_BRIGHT_WHITE)
    return torch.where(ok, filtered, orig)


def rgb_equalizer(
    rgb: torch.Tensor,
    method: int = 0,
    clip_limit: float = 1.0,
    gridsize: int = 8,
    strength: float = 0.5,
    weight3: float = 0.3,
    luma_blend_on: bool = True,
) -> torch.Tensor:
    """Equalizer methods 0-5.  ``strength`` 0 returns the input; the
    filtered result is blended with the input at weight ``1 - strength``;
    frames outside the luma gate pass through."""
    if strength <= 0:
        return rgb
    if method == 0:
        filtered = clahe_luma(rgb, 2.0 if clip_limit == 1.0 else clip_limit, gridsize)
        if luma_blend_on:
            filtered = luma_blend(rgb, filtered, 0.40, 0.90, 0.35, 2.0)
    elif method == 1:
        filtered = equalize_rgb(rgb)
        if luma_blend_on:
            filtered = luma_blend(rgb, filtered, 0.40, 0.90, 0.15, 4.0)
    elif method == 2:
        filtered = clahe_rgb(rgb, 2.0 if clip_limit == 1.0 else clip_limit, gridsize)
        if luma_blend_on:
            filtered = luma_blend(rgb, filtered, 0.40, 0.90, 0.15, 4.0)
    elif method == 3:
        f0 = rgb_equalizer(rgb, 0, clip_limit, gridsize, 1.0, luma_blend_on=luma_blend_on)
        f1 = rgb_equalizer(rgb, 1, clip_limit, gridsize, 1.0, luma_blend_on=luma_blend_on)
        filtered = f0 * (1 - weight3) + f1 * weight3
    elif method == 4:
        filtered = scale_abs_autolevels(rgb, clip_hist_percent=1.0)
        if luma_blend_on:
            filtered = luma_blend(rgb, filtered, 0.40, 0.90, 0.15, 4.0)
    elif method == 5:
        from .retinex import msr_luma

        filtered = msr_luma(rgb)
        if luma_blend_on:
            filtered = luma_blend(rgb, filtered, 0.40, 0.90, 0.35, 2.0)
    else:
        raise ValueError(f"rgb_equalizer: unknown method {method}")
    filtered = _luma_gate(rgb, filtered)
    weight = min(max(1.0 - strength, 0.0), 1.0)
    return filtered * (1 - weight) + rgb * weight


def adjust_rgb(rgb: torch.Tensor, factor=(1.0, 1.0, 1.0), bias=(0.0, 0.0, 0.0),
               gamma=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Per-channel gain, bias (on the 0..255 scale) and gamma."""
    chans = []
    for c in range(3):
        x = torch.clamp(rgb[..., c] * factor[c] + bias[c] / 255.0, 0.0, 1.0)
        if gamma[c] != 1.0:
            x = x ** (1.0 / gamma[c])
        chans.append(x)
    return torch.stack(chans, dim=-1)


def rgb_balance(rgb: torch.Tensor, strength: float = 0.5, rgb_factor=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """Auto white balance: each channel's frame mean pulled toward their
    common average, times the per-channel factors, blended at
    ``strength``."""
    means = torch.mean(rgb, dim=(-3, -2), keepdim=True)
    gray = torch.mean(means, dim=-1, keepdim=True)
    gain = gray / torch.clamp(means, min=1e-4)
    # scalar products, as no host tensor may cross to the card mid-stream
    gain = torch.cat([gain[..., c:c + 1] * float(rgb_factor[c]) for c in range(3)], dim=-1)
    balanced = torch.clamp(rgb * gain, 0.0, 1.0)
    return rgb * (1 - strength) + balanced * strength
