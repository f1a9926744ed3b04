"""The fused post chain (dark tweak -> chroma-bright tweak -> colormap ->
clamp) over ``(T, H, W, 3)`` float32 RGB: frozen copy of the plain version
in the port's ``havc_tpu_torch/ops/post_chain.py``.  ``post_chain`` is the
plain version on every device (no kernel)."""
from __future__ import annotations

import torch

from .colorspace import pymod

__all__ = ["post_chain", "post_chain_reference"]

MAX_RANGES = 8  # hue ranges the kernel's parameter block holds


def _fill_defaults(kw: dict) -> dict:
    out = dict(
        dark_thr=0.1, dark_white=0.3, dark_sat=0.3, dark_bright=-0.8,
        sm_black=0.3, sm_white=0.7, sm_sat=0.9, sm_bright=0.0,
        cmap_ranges=(), cmap_hue_shift=0.0, cmap_sat=1.0, cmap_weight=0.0,
    )
    unknown = set(kw) - set(out)
    if unknown:
        raise TypeError(f"post_chain: unknown parameters {sorted(unknown)}")
    out.update(kw)
    out["cmap_ranges"] = tuple(tuple(r) for r in out["cmap_ranges"])
    return out


def _ramp(thr: float, white: float):
    """(tresh, grad) of the luma ramp, rounded in Python as the reference
    does: banker's ``round`` on the 0..255 levels, gradient to 3 decimals
    (dark (0.1, 0.2): 26, 0.04; smooth (0.3, 0.7): 76, 0.01)."""
    maxw = round(white * 255)
    tresh = min(round(thr * 255), maxw - 10)
    grad = round(1.0 / (maxw - tresh), 3)
    return tresh, grad


# --- the plain version -------------------------------------------------------


def _luma(r, g, b):
    return 0.299 * r + 0.587 * g + 0.114 * b


def _rgb_to_hsv(r, g, b):
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, 1.0)
    h_r = pymod((g - b) / safe_c, 6.0)
    h_g = (b - r) / safe_c + 2.0
    h_b = (r - g) / safe_c + 4.0
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b))
    h = torch.where(c > 0, h / 6.0, 0.0)
    s = torch.where(v > 0, c / torch.where(v > 0, v, 1.0), 0.0)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    h6 = pymod(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(c0, c1, c2, c3, c4, c5):
        return torch.where(
            i == 0, c0,
            torch.where(i == 1, c1,
                        torch.where(i == 2, c2,
                                    torch.where(i == 3, c3,
                                                torch.where(i == 4, c4, c5)))),
        )

    return pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)


def _tweak_blend(r, g, b, sat, bright, thr, white):
    """HSV tweak (S * sat, V * (1 + bright)) blended back toward the input
    by the clamped luma ramp between ``thr`` and ``white``."""
    h, s, v = _rgb_to_hsv(r, g, b)
    s_d = torch.clamp(s * sat, 0.0, 1.0)
    v_d = torch.clamp(v * (1.0 + bright), 0.0, 1.0)
    rd, gd, bd = _hsv_to_rgb(h, s_d, v_d)
    y = _luma(r, g, b)
    tresh, grad = _ramp(thr, white)
    w = torch.clamp((y * 255.0 - tresh) * grad, 0.0, 1.0)
    return rd * (1 - w) + r * w, gd * (1 - w) + g * w, bd * (1 - w) + b * w


def post_chain_reference(frames: torch.Tensor, **kw) -> torch.Tensor:
    """The pixel program in plain PyTorch ops."""
    p = _fill_defaults(kw)
    r, g, b = frames[..., 0], frames[..., 1], frames[..., 2]
    # dark tweak, then chroma-bright tweak
    r1, g1, b1 = _tweak_blend(r, g, b, p["dark_sat"], p["dark_bright"],
                              p["dark_thr"], p["dark_white"])
    r2, g2, b2 = _tweak_blend(r1, g1, b1, p["sm_sat"], p["sm_bright"],
                              p["sm_black"], p["sm_white"])
    # colormap: hue shift inside the ranges, pulled back by the weight
    if p["cmap_ranges"]:
        h, s, v = _rgb_to_hsv(r2, g2, b2)
        h_deg = h * 360.0
        in_range = torch.zeros_like(h, dtype=torch.bool)
        for lo, hi in p["cmap_ranges"]:
            in_range = in_range | ((h_deg > lo) & (h_deg < hi))
        shift = min(max(int(p["cmap_hue_shift"]), -360), 360) / 360.0
        h_m = pymod(h + shift, 1.0)
        s_m = torch.clamp(s * p["cmap_sat"], 0.0, 1.0)
        rm, gm, bm = _hsv_to_rgb(h_m, s_m, v)
        m = in_range.to(r2.dtype)
        r3 = r2 * (1 - m) + rm * m
        g3 = g2 * (1 - m) + gm * m
        b3 = b2 * (1 - m) + bm * m
        cw = p["cmap_weight"]
        if cw > 0:
            r3 = r3 * (1 - cw) + r2 * cw
            g3 = g3 * (1 - cw) + g2 * cw
            b3 = b3 * (1 - cw) + b2 * cw
        r2, g2, b2 = r3, g3, b3
    return torch.stack(
        [torch.clamp(r2, 0.0, 1.0), torch.clamp(g2, 0.0, 1.0), torch.clamp(b2, 0.0, 1.0)],
        dim=-1,
    )


post_chain = post_chain_reference
