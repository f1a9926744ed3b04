"""Frozen copy of the port's ``havc_tpu_torch/ops/colorspace.py`` (the benchmark's plain
reference).

Color-space conversions in PyTorch.

Same conventions and layout as ``havc_tpu.ops.colorspace``: float RGB in
``[0, 1]``, channel-last ``(..., H, W, 3)``.

* ``YUV``: OpenCV's full-range ``COLOR_RGB2YUV`` rescaled to [0,1]:
  ``Y = 0.299 R + 0.587 G + 0.114 B``; ``U = 0.492 (B - Y) + 0.5``;
  ``V = 0.877 (R - Y) + 0.5``.
* ``HSV``: H in [0, 1) (fraction of a turn), S, V in [0, 1].
* ``LAB``: CIELAB with D65 white, L in [0, 100], a/b about [-110, 110].
"""
from __future__ import annotations

import functools
import math

import torch

__all__ = [
    "rgb_to_yuv",
    "yuv_to_rgb",
    "yuv_to_rgb_preserve_luma",
    "rgb_to_gray",
    "luma",
    "rgb_to_hsv",
    "hsv_to_rgb",
    "rgb_to_lab",
    "lab_to_rgb",
    "srgb_to_linear",
    "linear_to_srgb",
    "copy_chroma",
    "copy_luma",
    "ciede2000",
    "pymod",
]

_YUV_U_SCALE = 0.492
_YUV_V_SCALE = 0.877

# Rec.601 luma weights
_LUMA_R = 0.299
_LUMA_G = 0.587
_LUMA_B = 0.114


def pymod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.remainder``: the result takes the sign of ``y``.  Written as
    ``fmod`` plus the sign fix-up, as XLA lowers it."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma of an RGB image; returns shape ``(..., H, W)``."""
    return _LUMA_R * rgb[..., 0] + _LUMA_G * rgb[..., 1] + _LUMA_B * rgb[..., 2]


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Replicate luma over 3 channels."""
    y = luma(rgb)
    return torch.stack([y, y, y], dim=-1)


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    y = luma(rgb)
    u = _YUV_U_SCALE * (rgb[..., 2] - y) + 0.5
    v = _YUV_V_SCALE * (rgb[..., 0] - y) + 0.5
    return torch.stack([y, u, v], dim=-1)


def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    y = yuv[..., 0]
    u = yuv[..., 1] - 0.5
    v = yuv[..., 2] - 0.5
    r = y + v / _YUV_V_SCALE
    b = y + u / _YUV_U_SCALE
    g = (y - _LUMA_R * r - _LUMA_B * b) / _LUMA_G
    return torch.stack([r, g, b], dim=-1)


def yuv_to_rgb_preserve_luma(yuv: torch.Tensor) -> torch.Tensor:
    """YUV -> RGB that keeps Y exact by desaturating out-of-gamut pixels:
    the chroma offset is scaled per pixel by the largest s <= 1 that keeps
    every channel in [0, 1]."""
    y = torch.clamp(yuv[..., 0], 0.0, 1.0)
    rgb = yuv_to_rgb(torch.stack([y, yuv[..., 1], yuv[..., 2]], dim=-1))
    yc = y[..., None]
    k = rgb - yc
    eps = 1e-6
    s_hi = torch.where(k > eps, (1.0 - yc) / torch.clamp(k, min=eps), torch.inf)
    s_lo = torch.where(k < -eps, -yc / torch.clamp(k, max=-eps), torch.inf)
    s = torch.minimum(s_hi.amin(dim=-1), s_lo.amin(dim=-1))
    s = torch.clamp(s, 0.0, 1.0)[..., None]
    return torch.clamp(yc + k * s, 0.0, 1.0)


def copy_chroma(src: torch.Tensor, luma_from: torch.Tensor) -> torch.Tensor:
    """Chroma (U, V) of ``src`` with the luma of ``luma_from``."""
    yuv_src = rgb_to_yuv(src)
    y = luma(luma_from)
    return yuv_to_rgb(torch.stack([y, yuv_src[..., 1], yuv_src[..., 2]], dim=-1))


def copy_luma(src: torch.Tensor, chroma_from: torch.Tensor) -> torch.Tensor:
    """Luma of ``src`` with the chroma (U, V) of ``chroma_from``."""
    return copy_chroma(chroma_from, src)


# --- HSV ---------------------------------------------------------------------


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> HSV with H in [0,1), S,V in [0,1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
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
    return torch.stack([h, s, v], dim=-1)


def _pick(i, c0, c1, c2, c3, c4, c5):
    return torch.where(
        i == 0, c0,
        torch.where(i == 1, c1,
                    torch.where(i == 2, c2,
                                torch.where(i == 3, c3,
                                            torch.where(i == 4, c4, c5)))),
    )


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = pymod(h, 1.0) * 6.0
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _pick(i, v, q, p, p, t, v)
    g = _pick(i, t, v, v, q, p, p)
    b = _pick(i, p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


# --- sRGB <-> linear ---------------------------------------------------------


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * (c ** (1.0 / 2.4)) - 0.055)


# --- CIELAB (D65) ------------------------------------------------------------

# sRGB -> XYZ (D65) matrices, applied as explicit channel arithmetic as in
# the JAX package (its matmul form lost precision on some backends)
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_XYZ2RGB = (
    (3.240479, -1.537150, -0.498535),
    (-0.969256, 1.875992, 0.041556),
    (0.055648, -0.204043, 1.057311),
)
_WHITE = (0.950456, 1.0, 1.088754)
_LAB_DELTA = 6.0 / 29.0


def _apply_mat3(v: torch.Tensor, mat) -> torch.Tensor:
    rows = [m[0] * v[..., 0] + m[1] * v[..., 1] + m[2] * v[..., 2] for m in mat]
    return torch.stack(rows, dim=-1)


def _white(like: torch.Tensor) -> torch.Tensor:
    return _white_on(like.device)


@functools.lru_cache(maxsize=8)
def _white_on(device: torch.device) -> torch.Tensor:
    # made once per device: a copy from the host would wait for the card
    return torch.tensor(_WHITE, dtype=torch.float32, device=device)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(
        t > _LAB_DELTA**3,
        torch.clamp(t, min=1e-8) ** (1.0 / 3.0),
        t / (3.0 * _LAB_DELTA**2) + 4.0 / 29.0,
    )


def _lab_finv(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _LAB_DELTA, t**3, 3.0 * _LAB_DELTA**2 * (t - 4.0 / 29.0))


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [0,1] -> CIELAB (L in [0,100], a/b approx [-110,110])."""
    lin = srgb_to_linear(rgb)
    xyz = _apply_mat3(lin, _RGB2XYZ)
    fxyz = _lab_f(xyz / _white(xyz))
    l = 116.0 * fxyz[..., 1] - 16.0
    a = 500.0 * (fxyz[..., 0] - fxyz[..., 1])
    b = 200.0 * (fxyz[..., 1] - fxyz[..., 2])
    return torch.stack([l, a, b], dim=-1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (l + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = torch.stack([_lab_finv(fx), _lab_finv(fy), _lab_finv(fz)], dim=-1)
    xyz = xyz * _white(xyz)
    lin = _apply_mat3(xyz, _XYZ2RGB)
    return linear_to_srgb(lin)


# --- CIEDE2000 ---------------------------------------------------------------


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s arithmetic (the larger leg times sqrt(1 + r^2))."""
    x, y = x.abs(), y.abs()
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    r = lo / torch.where(hi == 0, 1.0, hi)
    return torch.where(hi == 0, hi, hi * torch.sqrt(1 + r * r))


def _pow7(x: torch.Tensor) -> torch.Tensor:
    """``x ** 7`` as XLA's integer power multiplies it: x * x^2 * x^4."""
    x2 = x * x
    return (x * x2) * (x2 * x2)


_DEG = 180.0 / math.pi  # jnp.degrees / jnp.radians multiply by these
_RAD = math.pi / 180.0


def ciede2000(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """Per-pixel CIEDE2000 difference of two LAB images ``(..., 3)``; the
    JAX package's formula term for term (hue angles in degrees, taken
    modulo 360 with the sign of the divisor; achromatic pairs, where
    C1' C2' is exactly 0, take the hue sum and no hue difference)."""
    L1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    L2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]

    C1 = _hypot(a1, b1)
    C2 = _hypot(a2, b2)
    Cbar = 0.5 * (C1 + C2)
    c7 = _pow7(Cbar)
    G = 0.5 * (1.0 - torch.sqrt(c7 / (c7 + 25.0**7 + 1e-30)))
    a1p = (1.0 + G) * a1
    a2p = (1.0 + G) * a2
    C1p = _hypot(a1p, b1)
    C2p = _hypot(a2p, b2)
    h1p = pymod(torch.atan2(b1, a1p) * _DEG, 360.0)
    h2p = pymod(torch.atan2(b2, a2p) * _DEG, 360.0)

    dLp = L2 - L1
    dCp = C2p - C1p
    dh = h2p - h1p
    dh = torch.where(dh > 180.0, dh - 360.0, dh)
    dh = torch.where(dh < -180.0, dh + 360.0, dh)
    achromatic = C1p * C2p == 0.0
    dh = torch.where(achromatic, 0.0, dh)
    dHp = 2.0 * torch.sqrt(C1p * C2p) * torch.sin(dh * _RAD / 2.0)

    Lbp = 0.5 * (L1 + L2)
    Cbp = 0.5 * (C1p + C2p)
    hsum = h1p + h2p
    hdiff = (h1p - h2p).abs()
    hbp = torch.where(
        achromatic,
        hsum,
        torch.where(hdiff <= 180.0, 0.5 * hsum,
                    torch.where(hsum < 360.0, 0.5 * (hsum + 360.0), 0.5 * (hsum - 360.0))),
    )
    T = (
        1.0
        - 0.17 * torch.cos((hbp - 30.0) * _RAD)
        + 0.24 * torch.cos((2.0 * hbp) * _RAD)
        + 0.32 * torch.cos((3.0 * hbp + 6.0) * _RAD)
        - 0.20 * torch.cos((4.0 * hbp - 63.0) * _RAD)
    )
    q = (hbp - 275.0) / 25.0
    dTheta = 30.0 * torch.exp(-(q * q))
    cb7 = _pow7(Cbp)
    Rc = 2.0 * torch.sqrt(cb7 / (cb7 + 25.0**7 + 1e-30))
    l50 = (Lbp - 50.0) * (Lbp - 50.0)
    Sl = 1.0 + 0.015 * l50 / torch.sqrt(20.0 + l50)
    Sc = 1.0 + 0.045 * Cbp
    Sh = 1.0 + 0.015 * Cbp * T
    Rt = -torch.sin((2.0 * dTheta) * _RAD) * Rc
    dl, dc, dhh = dLp / Sl, dCp / Sc, dHp / Sh
    return torch.sqrt(dl * dl + dc * dc + dhh * dhh + Rt * dc * dhh)
