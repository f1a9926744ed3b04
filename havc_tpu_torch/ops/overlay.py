"""Blend-mode compositor (``HAVC_clip_overlay``).

Port of ``havc_tpu.ops.overlay``: 9 blend modes on values in [0, 1]
(peak 1, neutral 0.5), the overlay cropped to the base and placed at
(x, y), a mask (or the overlay's rectangle) scaled by the opacity.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["overlay", "BLEND_MODES"]

BLEND_MODES = (
    "normal", "addition", "average", "difference", "divide",
    "exclusion", "multiply", "overlay", "subtract",
)


def _blend(mode: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x = overlay, y = base (the reference's Expr operand order)."""
    if mode == "normal":
        return x
    if mode == "addition":
        return x + y
    if mode == "average":
        return (x + y) / 2
    if mode == "difference":
        return (x - y).abs()
    if mode == "divide":
        return torch.where(y <= 0, 1.0, torch.clamp(x / torch.clamp(y, min=1e-6), max=1.0))
    if mode == "exclusion":
        return x + y - 2 * x * y
    if mode == "multiply":
        return x * y
    if mode == "overlay":
        return torch.where(x < 0.5, 2 * x * y, 1 - 2 * (1 - x) * (1 - y))
    if mode == "subtract":
        return x - y
    raise ValueError(f"overlay: invalid mode '{mode}'")


def overlay(
    base: torch.Tensor,
    over: torch.Tensor,
    x: int = 0,
    y: int = 0,
    mask: Optional[torch.Tensor] = None,
    opacity: float = 1.0,
    mode: str = "normal",
) -> torch.Tensor:
    """Composite ``over`` onto ``base`` at (x, y).

    ``base``/``over``: (..., H, W, 3); ``mask``: (..., h, w) or
    (..., h, w, 1) in [0, 1], the size of ``over``.
    """
    bh, bw = base.shape[-3], base.shape[-2]
    oh, ow = over.shape[-3], over.shape[-2]

    # crop the overlay to the visible region, then pad it to the base size
    cl, pl = max(-x, 0), max(x, 0)
    ct, pt = max(-y, 0), max(y, 0)
    cr = max((x + ow) - bw, 0)
    cb = max((y + oh) - bh, 0)
    over_c = over[..., ct:oh - cb, cl:ow - cr, :]
    vh, vw = over_c.shape[-3], over_c.shape[-2]
    over_p = F.pad(over_c, (0, 0, pl, bw - pl - vw, pt, bh - pt - vh))

    if mask is None:
        m = base.new_zeros(base.shape[:-1])
        m[..., pt:pt + vh, pl:pl + vw] = 1.0
    else:
        if mask.ndim == over.ndim:
            mask = mask[..., 0]
        m_c = mask[..., ct:oh - cb, cl:ow - cr]
        m = F.pad(m_c, (pl, bw - pl - m_c.shape[-1], pt, bh - pt - m_c.shape[-2]))
    m = torch.clamp(m * min(max(opacity, 0.0), 1.0), 0.0, 1.0)[..., None]

    blended = torch.clamp(_blend(mode.lower(), over_p, base), 0.0, 1.0)
    return base * (1 - m) + blended * m
