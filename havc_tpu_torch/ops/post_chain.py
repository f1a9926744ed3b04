"""The fused post chain: dark tweak -> chroma-bright tweak -> colormap ->
clamp, as one per-pixel program over ``(T, H, W, 3)`` float32 RGB.

Three functions:

* ``post_chain_reference(frames, **kw)`` — the plain PyTorch version, a
  line-for-line copy of ``havc_tpu.ops.pallas_kernels._post_math``;
* ``post_chain_cuda(frames, **kw)`` — the CUDA C++ kernel
  (``csrc/post_chain.cu``) on a CUDA tensor; the counter
  ``post_chain_launches`` (``utils.profiling.counters()``) counts its
  launches;
* ``post_chain(frames, **kw)`` — the dispatcher: the plain version for a
  tensor on the CPU, the kernel for a tensor on CUDA.  There is no
  fallback: a CUDA tensor never reaches the plain version, and a build or
  launch failure raises.

Keyword parameters and defaults are those of ``post_chain_reference`` in
the JAX package: ``dark_thr, dark_white, dark_sat, dark_bright, sm_black,
sm_white, sm_sat, sm_bright, cmap_ranges, cmap_hue_shift, cmap_sat,
cmap_weight``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..utils.profiling import count
from .colorspace import pymod

__all__ = ["post_chain", "post_chain_cuda", "post_chain_reference", "check_range_forms",
           "MAX_RANGES"]

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


# --- the CUDA kernel -----------------------------------------------------------


class _Params(ctypes.Structure):
    """Mirror of ``PostChainParams`` in csrc/post_chain.cu."""

    _fields_ = [
        ("dark_sat", ctypes.c_float), ("dark_vscale", ctypes.c_float),
        ("dark_tresh", ctypes.c_float), ("dark_grad", ctypes.c_float),
        ("sm_sat", ctypes.c_float), ("sm_vscale", ctypes.c_float),
        ("sm_tresh", ctypes.c_float), ("sm_grad", ctypes.c_float),
        ("n_ranges", ctypes.c_int),
        ("lo", ctypes.c_float * MAX_RANGES), ("hi", ctypes.c_float * MAX_RANGES),
        ("cmap_shift", ctypes.c_float), ("cmap_sat", ctypes.c_float),
        ("cmap_weight", ctypes.c_float), ("cmap_keep", ctypes.c_float),
    ]


def _params(p: dict) -> _Params:
    ranges = p["cmap_ranges"]
    if len(ranges) > MAX_RANGES:
        raise ValueError(
            f"post_chain_cuda: at most {MAX_RANGES} hue ranges, got {len(ranges)}"
        )
    dark_tresh, dark_grad = _ramp(p["dark_thr"], p["dark_white"])
    sm_tresh, sm_grad = _ramp(p["sm_black"], p["sm_white"])
    lo = [float(r[0]) for r in ranges] + [0.0] * (MAX_RANGES - len(ranges))
    hi = [float(r[1]) for r in ranges] + [0.0] * (MAX_RANGES - len(ranges))
    # the scalars are formed in Python doubles exactly as the plain version
    # forms them, then rounded once to float32
    return _Params(
        dark_sat=p["dark_sat"], dark_vscale=1.0 + p["dark_bright"],
        dark_tresh=dark_tresh, dark_grad=dark_grad,
        sm_sat=p["sm_sat"], sm_vscale=1.0 + p["sm_bright"],
        sm_tresh=sm_tresh, sm_grad=sm_grad,
        n_ranges=len(ranges),
        lo=(ctypes.c_float * MAX_RANGES)(*lo), hi=(ctypes.c_float * MAX_RANGES)(*hi),
        cmap_shift=min(max(int(p["cmap_hue_shift"]), -360), 360) / 360.0,
        cmap_sat=p["cmap_sat"], cmap_weight=p["cmap_weight"],
        cmap_keep=1 - p["cmap_weight"],
    )


def post_chain_cuda(frames: torch.Tensor, **kw) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous float32 ``(..., 3)`` CUDA
    tensor; returns a new tensor of the same shape."""
    if not frames.is_cuda:
        raise ValueError("post_chain_cuda: frames must be a CUDA tensor")
    if frames.dtype != torch.float32:
        raise ValueError(f"post_chain_cuda: frames must be float32, got {frames.dtype}")
    if frames.ndim < 1 or frames.shape[-1] != 3:
        raise ValueError(f"post_chain_cuda: last dim must be 3, got {tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("post_chain_cuda: frames must be contiguous")
    params = _params(_fill_defaults(kw))
    out = torch.empty_like(frames)
    n_pixels = frames.numel() // 3
    if n_pixels == 0:
        return out
    lib = kernels.load("post_chain")
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = lib.post_chain_launch(
            frames.data_ptr(), out.data_ptr(), n_pixels, ctypes.byref(params), stream
        )
    if rc != 0:
        raise RuntimeError(f"post_chain_cuda: launch failed with CUDA error {rc}")
    count("post_chain_launches")
    return out


def check_range_forms() -> list:
    """Mismatches of the kernel's range-limited forms against the generic
    ones, over every float of their ranges, counted on the current CUDA
    device: ``[py_mod(x, 6) on [-1, 1], py_mod(h, 1) on [0, 1], the hue
    sextant on [0, 1]]`` (NaN and -0 included).  All zero when the kernel
    gives the same bits as the generic forms."""
    counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    rc = kernels.load("post_chain").post_chain_check_forms(
        counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"check_range_forms: launch failed with CUDA error {rc}")
    return counts.tolist()


def post_chain(frames: torch.Tensor, **kw) -> torch.Tensor:
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor."""
    if frames.device.type == "cpu":
        return post_chain_reference(frames, **kw)
    if frames.is_cuda:
        return post_chain_cuda(frames, **kw)
    raise ValueError(f"post_chain: no implementation for device {frames.device}")
