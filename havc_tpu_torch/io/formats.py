"""Output format restore: RGB -> YUV with matrix, range, subsampling and
error-diffusion dithering.

Port of ``havc_tpu.io.formats`` (the reference's ``restore_format``): the
pipeline works in full-range float RGB and gives the clip back in its
original colorimetry, BT.601/709/2020, limited or full range, 8 to 16
bits, 4:2:0/4:2:2/4:4:4, quantised with Floyd-Steinberg error diffusion.
The matrix, range and subsampling run where the frames are (``device``
for numpy); the float code planes then come to the host in one copy and
the native library (``io.native``) dithers them, as in the JAX package.
``dither="error_diffusion"`` raises ``NativeUnavailable`` when that
library cannot be built or loaded: it never rounds instead.  Any other
``dither`` value rounds to the nearest code.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..ops.resize import bilinear_nchw
from ..utils.profiling import on_device

__all__ = [
    "MATRIX_COEFFS",
    "rgb_to_yuv_planes",
    "yuv420p8_to_rgb",
    "restore_format_yuv420p8",
    "restore_format_yuv",
    "yuv_planes_to_rgb",
]

# Kr, Kb per matrix (ITU-R)
MATRIX_COEFFS = {
    "601": (0.299, 0.114),
    "709": (0.2126, 0.0722),
    "2020": (0.2627, 0.0593),
}


def _fs_dither(plane_codes: np.ndarray, lo: float, hi: float, bits: int = 8) -> np.ndarray:
    """Floyd-Steinberg quantisation of (n, h, w) float code values to
    uint8/uint16 in the native library (frames in parallel)."""
    from .native import load_native

    x = np.ascontiguousarray(plane_codes, np.float32)
    n, h, w = x.shape
    lib = load_native()
    out = np.empty((n, h, w), np.uint8 if bits <= 8 else np.uint16)
    fn = lib.fs_dither_u8_batch if bits <= 8 else lib.fs_dither_u16_batch
    fn(x.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), n, w, h,
       float(lo), float(hi))
    return out


def _ranges(bits: int, range_full: bool):
    """(y_scale, y_offset, c_scale, c_offset, y_clamp, c_clamp) of a bit
    depth: limited-range excursions scale by 2^(bits-8), full range spans
    [0, 2^bits - 1]."""
    s = float(1 << (bits - 8))
    if range_full:
        peak = float((1 << bits) - 1)
        mid = float(1 << (bits - 1))
        return peak, 0.0, peak, mid, (0.0, peak), (0.0, peak)
    return (
        219.0 * s, 16.0 * s, 224.0 * s, 128.0 * s,
        (16.0 * s, 235.0 * s), (16.0 * s, 240.0 * s),
    )


def rgb_to_yuv_planes(frames: torch.Tensor, matrix: str = "709", range_full: bool = False,
                      bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, H, W, 3) RGB [0, 1] -> float code-value planes (Y, U, V) at full
    resolution for a bit depth; quantisation is the caller's step."""
    kr, kb = MATRIX_COEFFS[matrix]
    kg = 1.0 - kr - kb
    r, g, b = frames[..., 0], frames[..., 1], frames[..., 2]
    y = kr * r + kg * g + kb * b
    cb = (b - y) / (2.0 * (1.0 - kb))
    cr = (r - y) / (2.0 * (1.0 - kr))
    ys, yo, cs, co, _, _ = _ranges(bits, range_full)
    return y * ys + yo, cb * cs + co, cr * cs + co


def _subsample(c: torch.Tensor, subsampling: str = "420") -> torch.Tensor:
    """Mean chroma subsample: '420' 2x2, '422' 2x1, '444' none; an odd
    size is edge-replicated first."""
    if subsampling == "444":
        return c
    t, h, w = c.shape
    if w % 2:
        c = torch.cat([c, c[:, :, -1:]], dim=2)
        w += 1
    if subsampling == "422":
        return c.reshape(t, h, w // 2, 2).mean(dim=3)
    if h % 2:
        c = torch.cat([c, c[:, -1:, :]], dim=1)
        h += 1
    return c.reshape(t, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


@torch.inference_mode()
def _code_planes(frames, matrix: str, range_full: bool, bits: int, subsampling: str,
                 device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The float code planes (Y at full size, U and V subsampled), computed
    where the frames are and copied to the host in one transfer."""
    y, u, v = rgb_to_yuv_planes(on_device(frames, device), matrix, range_full, bits)
    u, v = _subsample(u, subsampling), _subsample(v, subsampling)
    flat = torch.cat([y.reshape(-1), u.reshape(-1), v.reshape(-1)]).cpu().numpy()
    ny, nc = y.numel(), u.numel()
    return (flat[:ny].reshape(y.shape), flat[ny:ny + nc].reshape(u.shape),
            flat[ny + nc:].reshape(v.shape))


def _quantize(planes, bits: int, range_full: bool, dither: str):
    _, _, _, _, y_rng, c_rng = _ranges(bits, range_full)
    rngs = (y_rng, c_rng, c_rng)
    if dither == "error_diffusion":
        return tuple(_fs_dither(p, *r, bits=bits) for p, r in zip(planes, rngs))
    dtype = np.uint8 if bits <= 8 else np.uint16
    return tuple(np.clip(np.round(p), *r).astype(dtype) for p, r in zip(planes, rngs))


def restore_format_yuv(
    frames,
    matrix: str = "709",
    range_full: bool = False,
    bits: int = 8,
    subsampling: str = "420",
    dither: str = "error_diffusion",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(T, H, W, 3) RGB [0, 1] (numpy or a tensor) -> (Y, U, V) numpy planes,
    uint8 for bits <= 8 else uint16, in the given matrix, range, depth and
    subsampling."""
    return _quantize(_code_planes(frames, matrix, range_full, bits, subsampling, device),
                     bits, range_full, dither)


def restore_format_yuv420p8(
    frames,
    matrix: str = "709",
    range_full: bool = False,
    dither: str = "error_diffusion",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``restore_format_yuv`` for the common YUV420P8 output."""
    return restore_format_yuv(frames, matrix, range_full, bits=8, subsampling="420",
                              dither=dither, device=device)


@torch.inference_mode()
def yuv_planes_to_rgb(
    y: np.ndarray, u: np.ndarray, v: np.ndarray,
    matrix: str = "709", range_full: bool = False, bits: int = 8, device=None,
) -> torch.Tensor:
    """The inverse: uint8/uint16 planes (any subsampling) -> (T, H, W, 3)
    RGB [0, 1] on ``device``, the chroma upsampled as
    ``jax.image.resize(..., "bilinear")`` does."""
    yf, uf, vf = (on_device(np.asarray(p), device) for p in (y, u, v))
    ys, yo, cs, co, _, _ = _ranges(bits, range_full)
    yn = (yf - yo) / ys
    cb = (uf - co) / cs
    cr = (vf - co) / cs
    h, w = yn.shape[1:]

    def up(c):
        return c if c.shape[1:] == (h, w) else bilinear_nchw(c[:, None], h, w)[:, 0]

    cb, cr = up(cb), up(cr)
    kr, kb = MATRIX_COEFFS[matrix]
    kg = 1.0 - kr - kb
    r = yn + 2.0 * (1.0 - kr) * cr
    b = yn + 2.0 * (1.0 - kb) * cb
    g = (yn - kr * r - kb * b) / kg
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def yuv420p8_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                    matrix: str = "709", range_full: bool = False, device=None) -> torch.Tensor:
    return yuv_planes_to_rgb(y, u, v, matrix, range_full, bits=8, device=device)
