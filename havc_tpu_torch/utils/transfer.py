"""uint8 transfer-boundary helpers.

Port of ``havc_tpu.utils.transfer``.  Frames cross the host<->device link
as uint8, 1 byte a channel (a gray frame 1 byte a pixel), and the [0, 1]
normalisation and the final clip/round/quantise run on the device.  The
output side can pack I420 on the device (1.5 bytes a pixel), or only its
chroma planes (0.5 bytes a pixel) when the host already holds the luma.

The arithmetic is the JAX package's, bit for bit: ``u8_to_unit``
multiplies by the float32 reciprocal of 255, as XLA compiles the
division; rounding is half to even (``torch.round``, like ``jnp.round``);
the I420 pack is OpenCV's BT.601 studio-swing fixed point in int32 with
20 fractional bits, chroma from the top-left pixel of each 2x2 block.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["u8_to_unit", "unit_to_u8", "gray_to_rgb", "rgb_unit_to_i420_u8",
           "rgb_unit_to_uv420_u8"]

_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def u8_to_unit(u8: torch.Tensor) -> torch.Tensor:
    """uint8 0..255 -> float32 [0, 1]; ``unit_to_u8(u8_to_unit(x))``
    recovers every code value."""
    return u8.to(torch.float32) * _INV_255


def unit_to_u8(x: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> uint8 0..255: clip, scale, round half to even."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def gray_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """(T, H, W) or (T, H, W, 1) -> (T, H, W, 3) by channel replication
    (a view)."""
    if x.ndim == 3:
        x = x[..., None]
    return x.expand(*x.shape[:-1], 3)


_HALF, _OFF_Y, _OFF_C = 1 << 19, 16 << 20, 128 << 20


def _uv_planes(v: torch.Tensor):
    """The U and V planes, (T, H/2 * W/2) int32 each, from the top-left
    pixel of every 2x2 block."""
    u8 = torch.round(torch.clamp(v[:, 0::2, 0::2], 0.0, 1.0) * 255.0).to(torch.int32)
    r, g, b = u8[..., 0], u8[..., 1], u8[..., 2]
    u = (-155188 * r - 305135 * g + 460324 * b + _HALF + _OFF_C) >> 20
    w = (460324 * r - 385875 * g - 74448 * b + _HALF + _OFF_C) >> 20
    t = v.shape[0]
    return u.reshape(t, -1), w.reshape(t, -1)


def rgb_unit_to_i420_u8(x: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) float [0, 1] -> (T, H*3//2, W) uint8 packed I420 (H, W
    even), bit-identical to ``cv2.cvtColor(unit_to_u8(x),
    cv2.COLOR_RGB2YUV_I420)``."""
    t, hh, ww = x.shape[0], x.shape[1], x.shape[2]
    u8 = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.int32)
    y = (269484 * u8[..., 0] + 528482 * u8[..., 1] + 102760 * u8[..., 2]
         + _HALF + _OFF_Y) >> 20
    u, w = _uv_planes(x)
    packed = torch.cat([y.reshape(t, -1), u, w], dim=1)
    return packed.reshape(t, hh * 3 // 2, ww).to(torch.uint8)


def rgb_unit_to_uv420_u8(x: torch.Tensor) -> torch.Tensor:
    """The chroma rows of the packed I420, ``rgb_unit_to_i420_u8(x)[:, H:]``
    ((T, H//2, W) uint8), without computing the Y plane."""
    t, hh, ww = x.shape[0], x.shape[1], x.shape[2]
    u, w = _uv_planes(x)
    return torch.cat([u, w], dim=1).reshape(t, hh // 2, ww).to(torch.uint8)
