"""Non-local-means luma degrain (the KNLMeansCL role).

Port of ``havc_tpu.ops.denoise``: the (2a+1)^2 search window is a loop
over whole-frame shifts; each shift's patch distance is a box-filtered
squared difference (patch radius f) and weighs the shifted plane by
exp(-d / h^2).  Only the two accumulators live across the loop.
"""
from __future__ import annotations

import torch

from .colorspace import rgb_to_yuv, yuv_to_rgb_preserve_luma
from .retinex import _box_filter_1d

__all__ = ["nlm_luma", "degrain"]


def _patch_dist(a: torch.Tensor, b: torch.Tensor, f: int) -> torch.Tensor:
    d = (a - b) ** 2
    d = _box_filter_1d(d, f, d.ndim - 2)
    return _box_filter_1d(d, f, d.ndim - 1)


def nlm_luma(y: torch.Tensor, h: float = 1.2, a: int = 2, f: int = 1) -> torch.Tensor:
    """Non-local means on a luma plane (..., H, W) in [0, 1]: ``h`` the
    strength (h = 1.2 removes mild grain), ``a`` the search radius, ``f``
    the patch radius."""
    h2 = (h / 16.0) ** 2
    acc = torch.zeros_like(y)
    wacc = torch.zeros_like(y)
    for dy in range(-a, a + 1):
        for dx in range(-a, a + 1):
            shifted = torch.roll(y, (dy, dx), dims=(-2, -1))
            w = torch.exp(-_patch_dist(y, shifted, f) / h2)
            acc += shifted * w
            wacc += w
    return acc / torch.clamp(wacc, min=1e-8)


def degrain(rgb: torch.Tensor, strength: int = 1) -> torch.Tensor:
    """NLM on the luma only, strengths 1-3 (search and patch radius 1-3)."""
    params = {1: (1.2, 1, 1), 2: (1.2, 2, 2), 3: (1.2, 3, 3)}
    h, a, f = params.get(max(min(strength, 3), 1))
    yuv = rgb_to_yuv(rgb)
    y_dn = nlm_luma(yuv[..., 0], h, a, f)
    return yuv_to_rgb_preserve_luma(torch.stack([y_dn, yuv[..., 1], yuv[..., 2]], dim=-1))
