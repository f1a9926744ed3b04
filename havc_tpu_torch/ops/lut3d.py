"""3D LUT application (.cube) and the 12 built-in film looks, in PyTorch.

Port of ``havc_tpu.ops.lut3d`` (``HAVC_TimeCube``, the Retinex/Red film
LUTs, ``HAVC_ColorAdjust``'s LUT remaps).  The look lattices are built in
numpy from the same parameter table as the JAX package's, so they are
bit-equal; ``load_cube`` reads a user ``.cube`` file the same way.
``apply_lut3d`` is trilinear interpolation over an ``(N, N, N, 3)``
lattice: each pixel gathers its 8 corners from the flat table, one pair of
corners at a time so that no more than two corner images are alive.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_cube", "apply_lut3d", "lattice_on", "make_look_lut", "LUT_NAMES", "LUT_TWEAKS"]

# LUT id -> name (reference constants.py:30-41 DEF_LUT_*).
LUT_NAMES = [
    "forest_film",     # 0
    "city_skyline",    # 1
    "exploration",     # 2
    "fuj_film",        # 3
    "hollywood",       # 4
    "classic_film",    # 5
    "warm_haze",       # 6
    "hdr_color",       # 7
    "amber_light",     # 8
    "blue_mist",       # 9
    "vintage_fox",     # 10
    "flat_pop",        # 11
]

# Per-LUT tweak factors applied after the LUT — the exact vs_timecube
# match table (vsplugins.py:333-358).
LUT_TWEAKS = {
    # (hue, sat, bright, cont, gamma) — bright in 0-255 units like the
    # reference's vs_tweak call
    0: (10.0, 0.70, 0.0, 1.00, 1.00),
    1: (-3.0, 0.65, 1.0, 0.90, 1.05),
    2: (10.0, 1.05, -1.0, 1.05, 0.95),
    3: (10.0, 0.80, 0.0, 1.00, 1.00),
    4: (10.0, 0.75, 0.0, 1.00, 1.00),
    5: (0.0, 0.80, 0.0, 1.00, 1.00),
    6: (0.0, 0.75, 0.0, 1.00, 1.00),
    7: (0.0, 0.95, 0.0, 1.00, 1.00),
    8: (10.0, 0.40, 5.0, 1.00, 1.00),
    9: (3.0, 0.80, -1.0, 1.00, 1.00),
    10: (3.0, 0.80, 1.0, 1.00, 1.00),
    11: (-2.0, 0.80, 0.0, 1.00, 1.00),
}


def load_cube(path: str) -> np.ndarray:
    """Parse a .cube file into an (N, N, N, 3) float32 lattice.

    Follows the Adobe/Resolve .cube convention: data ordered with the red
    axis fastest.  DOMAIN_MIN/MAX rescaling is applied.
    """
    size = None
    dom_min = np.zeros(3)
    dom_max = np.ones(3)
    data = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0].upper()
            if key == "LUT_3D_SIZE":
                size = int(parts[1])
            elif key == "DOMAIN_MIN":
                dom_min = np.array([float(v) for v in parts[1:4]])
            elif key == "DOMAIN_MAX":
                dom_max = np.array([float(v) for v in parts[1:4]])
            elif key in ("TITLE", "LUT_1D_SIZE"):
                continue
            else:
                try:
                    data.append([float(v) for v in parts[:3]])
                except ValueError:
                    continue
    if size is None or len(data) != size**3:
        raise ValueError(f"invalid .cube file: {path}")
    lut = np.asarray(data, dtype=np.float32).reshape(size, size, size, 3)
    # file order is r-fastest: lut[b, g, r] -> transpose to [r, g, b]
    lut = lut.transpose(2, 1, 0, 3)
    lut = (lut - dom_min) / (dom_max - dom_min)
    return lut.astype(np.float32)


def lattice_on(lut: np.ndarray, device: torch.device) -> torch.Tensor:
    """A lattice on ``device``, copied from pinned memory so that the host
    does not wait for the card."""
    t = torch.from_numpy(np.ascontiguousarray(lut, dtype=np.float32))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def apply_lut3d(rgb: torch.Tensor, lut) -> torch.Tensor:
    """Trilinear 3D-LUT lookup on ``(..., 3)`` RGB in [0,1]; ``lut`` is an
    ``(N, N, N, 3)`` lattice indexed ``[r, g, b]`` (numpy or a tensor on
    ``rgb``'s device)."""
    lut = torch.as_tensor(lut, dtype=rgb.dtype, device=rgb.device)
    n = lut.shape[0]
    x = torch.clamp(rgb, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(x).to(torch.int32), 0, n - 2)
    f = x - i0
    i0 = i0.to(torch.int64)
    flat = lut.reshape(-1, 3)
    r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]

    def edge(ir, ig):
        # the b-axis pair of corners at (ir, ig), blended by fb
        idx = (ir * n + ig) * n + b0
        return flat[idx] * (1 - fb) + flat[idx + 1] * fb

    c0 = edge(r0, g0) * (1 - fg) + edge(r0, g0 + 1) * fg
    c1 = edge(r0 + 1, g0) * (1 - fg) + edge(r0 + 1, g0 + 1) * fg
    return c0 * (1 - fr) + c1 * fr


def _tone_curve(x, lift, gain, gamma):
    return np.clip(gain * np.clip(x + lift, 0, 1) ** gamma, 0, 1)


def make_look_lut(name_or_id, size: int = 33) -> np.ndarray:
    """Generate one of the 12 named film looks as an (size^3, 3) lattice.

    Parametric approximations of the bundled TimeCube looks: each look is a
    combination of per-channel tone curves and a gentle chroma rotation.
    """
    if isinstance(name_or_id, int):
        name = LUT_NAMES[name_or_id]
    else:
        name = name_or_id.lower().replace(" ", "_")
    g = np.linspace(0.0, 1.0, size, dtype=np.float32)
    r, gg, b = np.meshgrid(g, g, g, indexing="ij")

    # (lift_r, lift_g, lift_b), (gain_r...), (gamma_r...), warm shift
    params = {
        "forest_film":  ((0.00, 0.01, 0.00), (0.98, 1.02, 0.96), (1.05, 0.98, 1.05)),
        "city_skyline": ((0.00, 0.00, 0.02), (0.97, 0.99, 1.05), (1.02, 1.00, 0.95)),
        "exploration":  ((0.01, 0.01, 0.00), (1.03, 1.00, 0.97), (0.97, 1.00, 1.02)),
        "fuj_film":     ((0.00, 0.01, 0.01), (1.00, 1.03, 1.00), (1.00, 0.96, 1.02)),
        "hollywood":    ((0.02, 0.00, 0.00), (1.05, 0.99, 0.94), (0.95, 1.00, 1.06)),
        "classic_film": ((0.01, 0.01, 0.01), (0.96, 0.96, 0.96), (1.04, 1.04, 1.02)),
        "warm_haze":    ((0.03, 0.02, 0.00), (1.04, 1.00, 0.93), (0.92, 0.97, 1.04)),
        "hdr_color":    ((0.00, 0.00, 0.00), (1.06, 1.06, 1.06), (0.90, 0.90, 0.90)),
        "amber_light":  ((0.02, 0.01, 0.00), (1.06, 1.01, 0.92), (0.95, 1.00, 1.05)),
        "blue_mist":    ((0.00, 0.01, 0.03), (0.95, 1.00, 1.07), (1.05, 1.00, 0.93)),
        "vintage_fox":  ((0.02, 0.02, 0.01), (0.94, 0.93, 0.90), (1.02, 1.05, 1.08)),
        "flat_pop":     ((0.00, 0.00, 0.00), (1.08, 1.08, 1.08), (1.10, 1.10, 1.10)),
    }
    if name not in params:
        raise ValueError(f"unknown LUT look: {name}")
    lifts, gains, gammas = params[name]
    out = np.stack(
        [
            _tone_curve(r, lifts[0], gains[0], gammas[0]),
            _tone_curve(gg, lifts[1], gains[1], gammas[1]),
            _tone_curve(b, lifts[2], gains[2], gammas[2]),
        ],
        axis=-1,
    )
    return out.astype(np.float32)
