"""Separable resampling as two dense matrix products.

A polyphase resampler is two banded matrices ``W_h (H_out x H_in)`` and
``W_w (W_out x W_in)``; they are built on the host in numpy (cached) and
applied with two ``einsum`` contractions.  Rows are normalized and
edge-clamped (replicate border); when downscaling the kernel is stretched
by the scale factor (antialiasing), as VapourSynth/zimg do.
``antialias=False`` skips the stretch (``F.interpolate(antialias=False)``
semantics).  This is the same matrix form as ``havc_tpu.ops.resize``, so
spline64 and DDColor's non-antialiased bilinear agree with it exactly.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["resize", "resize_kernel_matrix", "KERNELS"]


# --- kernel functions (numpy, host-side) ------------------------------------


def _kernel_point(x):
    return (np.abs(x) <= 0.5).astype(np.float64)


def _kernel_bilinear(x):
    x = np.abs(x)
    return np.maximum(1.0 - x, 0.0)


def _kernel_bicubic(x, b=0.0, c=0.5):
    # Mitchell-Netravali family; VS default Bicubic is b=0, c=0.5 (Catmull-Rom).
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    p1 = (12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b)
    p2 = (-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 + (-12 * b - 48 * c) * x + (
        8 * b + 24 * c
    )
    out = np.where(x < 1.0, p1, np.where(x < 2.0, p2, 0.0))
    return out / 6.0


def _kernel_lanczos(x, a=3):
    x = np.abs(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sinc(x) * np.sinc(x / a)
    return np.where(x < a, out, 0.0)


def _piecewise_spline(x, coeffs):
    """Piecewise-cubic spline kernel from per-interval coefficients
    ``[(a3, a2, a1, a0), ...]`` for x in [i, i+1)."""
    x = np.abs(x)
    out = np.zeros_like(x)
    for i, (a3, a2, a1, a0) in enumerate(coeffs):
        t = x - i
        seg = ((a3 * t + a2) * t + a1) * t + a0
        out = np.where((x >= i) & (x < i + 1), seg, out)
    return out


# Standard AviSynth/zimg spline kernel coefficients.
_SPLINE16 = [(1.0, -9.0 / 5.0, -1.0 / 5.0, 1.0), (-1.0 / 3.0, 4.0 / 5.0, -7.0 / 15.0, 0.0)]
_SPLINE36 = [
    (13.0 / 11.0, -453.0 / 209.0, -3.0 / 209.0, 1.0),
    (-6.0 / 11.0, 270.0 / 209.0, -156.0 / 209.0, 0.0),
    (1.0 / 11.0, -45.0 / 209.0, 26.0 / 209.0, 0.0),
]
_SPLINE64 = [
    (49.0 / 41.0, -6387.0 / 2911.0, -3.0 / 2911.0, 1.0),
    (-24.0 / 41.0, 4032.0 / 2911.0, -2328.0 / 2911.0, 0.0),
    (6.0 / 41.0, -1008.0 / 2911.0, 582.0 / 2911.0, 0.0),
    (-1.0 / 41.0, 168.0 / 2911.0, -97.0 / 2911.0, 0.0),
]

KERNELS = {
    "point": (_kernel_point, 0.5),
    "bilinear": (_kernel_bilinear, 1.0),
    "bicubic": (functools.partial(_kernel_bicubic, b=0.0, c=0.5), 2.0),
    "mitchell": (functools.partial(_kernel_bicubic, b=1 / 3, c=1 / 3), 2.0),
    "lanczos": (functools.partial(_kernel_lanczos, a=3), 3.0),
    "spline16": (functools.partial(_piecewise_spline, coeffs=_SPLINE16), 2.0),
    "spline36": (functools.partial(_piecewise_spline, coeffs=_SPLINE36), 3.0),
    "spline64": (functools.partial(_piecewise_spline, coeffs=_SPLINE64), 4.0),
}


@functools.lru_cache(maxsize=512)
def resize_kernel_matrix(
    in_size: int, out_size: int, kernel: str = "spline64",
    antialias: bool = True,
) -> np.ndarray:
    """The (out_size, in_size) resampling weight matrix, float32.

    Center-aligned mapping ``src = (dst + 0.5) * in/out - 0.5``; the kernel
    is stretched by the scale factor when downscaling unless
    ``antialias=False``.  The result is cached and shared: do not write
    to it.
    """
    fn, support = KERNELS[kernel]
    scale = in_size / out_size
    stretch = max(scale, 1.0) if antialias else 1.0
    sup = support * stretch

    dst = np.arange(out_size, dtype=np.float64)
    src_center = (dst + 0.5) * scale - 0.5  # (out,)

    lo = np.floor(src_center - sup).astype(np.int64)
    width = int(math.ceil(2.0 * sup)) + 2
    taps = lo[:, None] + np.arange(width)[None, :]  # (out, width)
    dist = (src_center[:, None] - taps) / stretch
    w = fn(dist)
    # normalize rows
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    # scatter into the dense matrix with edge clamp (replicate border)
    taps_clamped = np.clip(taps, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(dst.astype(np.int64), width), taps_clamped.ravel()), w.ravel())
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size: int, out_size: int, kernel: str, antialias: bool,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        resize_kernel_matrix(in_size, out_size, kernel, antialias)
    ).to(device)


def resize(
    img: torch.Tensor,
    height: int,
    width: int,
    kernel: str = "spline64",
    antialias: bool = True,
) -> torch.Tensor:
    """Resize ``(..., H, W, C)`` image(s) to ``(..., height, width, C)``:
    a vertical then a horizontal matrix product in float32."""
    h_in, w_in = img.shape[-3], img.shape[-2]
    out = img
    if h_in != height:
        wh = _device_matrix(h_in, height, kernel, antialias, img.device)
        out = torch.einsum("oh,...hwc->...owc", wh, out.float()).to(img.dtype)
    if w_in != width:
        ww = _device_matrix(w_in, width, kernel, antialias, img.device)
        out = torch.einsum("pw,...hwc->...hpc", ww, out.float()).to(img.dtype)
    return out
