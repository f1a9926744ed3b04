"""Separable resampling as two dense matrix products.

A polyphase resampler is two banded matrices ``W_h (H_out x H_in)`` and
``W_w (W_out x W_in)``; they are built on the host in numpy (cached) and
applied with two ``einsum`` contractions.  Rows are normalized and
edge-clamped (replicate border); when downscaling the kernel is stretched
by the scale factor (antialiasing), as VapourSynth/zimg do.
``antialias=False`` skips the stretch (``F.interpolate(antialias=False)``
semantics).  This is the same matrix form as ``havc_tpu.ops.resize``, so
spline64 and DDColor's non-antialiased bilinear agree with it exactly.

``bilinear_nchw`` is ``jax.image.resize(..., "bilinear")`` over NCHW
feature maps, which differs from both the matrices above and
``F.interpolate``: it antialiases when it downscales and, at the border,
renormalises over the in-frame taps instead of replicating the edge.
``smart_resize_pad`` / ``smart_resize_restore`` are the exemplar path's
aspect-preserving work geometry.  ``resize_nearest`` is
``jax.image.resize(..., "nearest")`` over NCHW (the U-Net decoders' join
of an upsampled map with a skip of another size).

Both products run at IEEE float32 whatever the process's flags
(``utils.precision.ieee_precision``), as the JAX package pins
``Precision.HIGHEST`` on its resizes and ``jax.image.resize`` does by
default: at TF32 the chroma restore onto full-resolution luma would lose
chroma fidelity.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.precision import ieee_precision

__all__ = ["resize", "resize_kernel_matrix", "KERNELS", "bilinear_nchw", "PadMeta",
           "smart_resize_pad", "smart_resize_restore", "pad_to_square", "unpad_from_square",
           "resize_nearest"]


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


@ieee_precision()
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


# --- jax.image.resize(..., "bilinear") over NCHW ---------------------------------


@functools.lru_cache(maxsize=128)
def _jax_linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """The (out_size, in_size) weights of ``jax.image.resize``'s linear
    method along one axis: a triangle stretched by in/out when
    downscaling, weights normalised over the in-frame taps, and samples
    that fall outside the frame zeroed (jax ``compute_weight_mat``)."""
    f32 = np.float32  # jax forms the weights in float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)  # (in, out)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T, dtype=f32)


@functools.lru_cache(maxsize=64)
def _jax_linear_device(in_size: int, out_size: int, device: torch.device,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The float32 weights on ``device``, cast to ``dtype`` once."""
    return torch.from_numpy(_jax_linear_matrix(in_size, out_size)).to(device).to(dtype)


@ieee_precision()
def bilinear_nchw(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` over the H, W axes of an
    NCHW tensor, as two matrix products in x's dtype (float32 weights cast
    to it, as ``jax.image.resize`` casts them)."""
    out = x
    if x.shape[-2] != height:
        wh = _jax_linear_device(x.shape[-2], height, x.device, x.dtype)
        out = torch.einsum("oh,nchw->ncow", wh, out)
    if x.shape[-1] != width:
        ww = _jax_linear_device(x.shape[-1], width, x.device, x.dtype)
        out = torch.einsum("pw,ncow->ncop", ww, out)
    return out


# --- aspect-preserving pad/restore geometry ---------------------------------------


class PadMeta(NamedTuple):
    """Geometry captured by smart_resize_pad, consumed by
    smart_resize_restore."""

    orig_h: int
    orig_w: int
    pad_w: int  # symmetric horizontal border (pre-resize pixels)
    pad_h: int  # symmetric vertical border


def smart_resize_pad(frames: torch.Tensor, target_h: int, target_w: int,
                     kernel: str = "spline64"):
    """Pad ``(..., H, W, C)`` frames to the target aspect ratio with
    symmetric black borders, then resize to (target_h, target_w) and clamp
    to [0, 1].  Returns (resized, PadMeta)."""
    h, w = frames.shape[-3], frames.shape[-2]
    ratio_clip = round(w / h, 2)
    ratio_target = round(target_w / target_h, 2)
    pad_w = pad_h = 0
    if ratio_clip < ratio_target:
        pad_w = int(round((round(h * ratio_target) - w) / 2))
    elif ratio_clip > ratio_target:
        pad_h = int(round((round(w / ratio_target) - h) / 2))
    if pad_w or pad_h:
        frames = torch.nn.functional.pad(frames, (0, 0, pad_w, pad_w, pad_h, pad_h))
    out = torch.clamp(resize(frames, target_h, target_w, kernel), 0.0, 1.0)
    return out, PadMeta(h, w, pad_w, pad_h)


def smart_resize_restore(frames: torch.Tensor, meta: PadMeta,
                         kernel: str = "spline64") -> torch.Tensor:
    """Resize back to the padded geometry and crop the borders off."""
    ph, pw = meta.pad_h, meta.pad_w
    out = torch.clamp(resize(frames, meta.orig_h + 2 * ph, meta.orig_w + 2 * pw, kernel),
                      0.0, 1.0)
    if ph:
        out = out[..., ph:-ph, :, :]
    if pw:
        out = out[..., pw:-pw, :]
    return out


def pad_to_square(frames: torch.Tensor, size: int = 512, kernel: str = "lanczos",
                  border: float = 128.0 / 255.0):
    """Fit ``(..., H, W, C)`` frames into a ``size`` x ``size`` box keeping
    their aspect (resized with ``kernel``, clamped to [0, 1]), then fill
    the rest with ``border`` gray.  Returns (padded, PadMeta), where the
    PadMeta's pads are the left and top borders in resized pixels."""
    h, w = frames.shape[-3], frames.shape[-2]
    scale = size / max(w, h)
    new_w, new_h = int(w * scale), int(h * scale)
    out = torch.clamp(resize(frames, new_h, new_w, kernel), 0.0, 1.0)
    pad_w, pad_h = size - new_w, size - new_h
    left, top = pad_w // 2, pad_h // 2
    out = torch.nn.functional.pad(out, (0, 0, left, pad_w - left, top, pad_h - top),
                                  value=border)
    return out, PadMeta(h, w, left, top)


def unpad_from_square(frames: torch.Tensor, meta: PadMeta, size: int = 512,
                      kernel: str = "lanczos") -> torch.Tensor:
    """Crop the content box out of :func:`pad_to_square`'s output and
    resize it back to the original size."""
    scale = size / max(meta.orig_w, meta.orig_h)
    new_w, new_h = int(meta.orig_w * scale), int(meta.orig_h * scale)
    top, left = meta.pad_h, meta.pad_w
    out = frames[..., top:top + new_h, left:left + new_w, :]
    return torch.clamp(resize(out, meta.orig_h, meta.orig_w, kernel), 0.0, 1.0)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` over NCHW: source index
    ``floor((i + 0.5) * in / out)`` computed in float32."""
    for dim, n in ((2, h), (3, w)):
        m = x.shape[dim]
        if m == n:
            continue
        off = (torch.arange(n, dtype=torch.float32) + 0.5) * m / n
        idx = torch.floor(off).to(torch.long).to(x.device)
        x = x.index_select(dim, idx)
    return x
