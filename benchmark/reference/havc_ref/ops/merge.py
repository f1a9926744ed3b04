"""Frozen copy of the port's ``havc_tpu_torch/ops/merge.py`` (the benchmark's plain
reference).

Model-combine ("merge") methods, in PyTorch.

Port of ``havc_tpu.ops.merge``.  Method ids match the reference:

* 2 ``SimpleMerge`` — weighted lerp (the method of the main path)
* 3 ``ConstrainedChromaMerge`` — YUV chroma clamp +/-alpha, dark red fix,
  double re-merge (the streaming path's default)
* 4 ``LumaMaskedMerge`` — (gradient) luma mask merge
* 5 ``AdaptiveLumaMerge`` — weight decays with the frame's luma
* 6 ``ChromaRetentionMerge`` — gray pixels of one clip recolored from the
  other through a soft saturation mask, optionally at a reduced chroma
  resolution with the full-resolution luma married back
* 7 ``ChromaBoundAdaptiveMerge`` — Laplacian-texture adaptive chroma clamp

``luma_blend`` is the frame-luma-driven blend the equalizers use.

Functions take ``(..., H, W, 3)`` RGB in [0,1].  The per-frame branches of
the reference (mean-luma gates) are selections on per-frame reductions.
"""
from __future__ import annotations

import functools

import torch

from .chroma import (adjust_chroma, mask_merge, parse_hue_ranges, restore_color,
                     restore_color_gradient, tweak, weighted_merge)
from .colorspace import luma, rgb_to_yuv, yuv_to_rgb
from .resize import resize
from ..utils.precision import ieee_precision

__all__ = [
    "simple_merge",
    "luma_masked_merge",
    "w_luma_masked_merge",
    "adaptive_luma_merge",
    "luma_blend",
    "chroma_limit",
    "constrained_chroma_merge",
    "chroma_bound_adaptive_merge",
    "chroma_retention_merge",
    "combine_models",
    "DEF_CMC_p",
    "DEF_LMM_p",
    "DEF_ALM_p",
    "DEF_CRT_p",
]

# Default parameter packs (reference: vsslib/constants.py:19-22).
DEF_CMC_p = [0.15, True, 20, 24]
DEF_LMM_p = [0.15, 0.65, 1.0]
DEF_ALM_p = [0.8, 1.0, 0.15]
DEF_CRT_p = [0.8, 30, 2, False, 0, 0]


def _frame_luma(rgb: torch.Tensor) -> torch.Tensor:
    """Mean Rec.601 luma per frame, shape (..., 1, 1, 1)."""
    return torch.mean(luma(rgb), dim=(-2, -1))[..., None, None, None]


def simple_merge(a: torch.Tensor, b: torch.Tensor, b_weight: float = 0.5) -> torch.Tensor:
    """Method 2: plain weighted merge."""
    return weighted_merge(a, b, b_weight)


def luma_masked_merge(
    dark: torch.Tensor, white: torch.Tensor, luma_limit: float = 0.4
) -> torch.Tensor:
    """Binary luma mask: pixels of ``white`` with luma > limit kept, the
    rest filled from ``dark``."""
    mask = (luma(white) > luma_limit).to(white.dtype)
    return mask_merge(dark, white, mask)


def w_luma_masked_merge(
    dark: torch.Tensor,
    white: torch.Tensor,
    dark_luma: float = 0.3,
    white_luma: float = 0.9,
) -> torch.Tensor:
    """Gradient luma mask merge: the mask ramps linearly from
    ``dark_luma`` to ``white_luma`` on the luma of ``white``.  The ramp's
    constants are rounded in Python exactly as the reference does
    (banker's ``round``, gradient to 3 decimals)."""
    if dark_luma >= white_luma:
        return dark
    y255 = luma(white) * 255.0
    max_white = round(white_luma * 255)
    tresh = min(round(dark_luma * 255), max_white - 10)
    grad = round(1.0 / (max_white - tresh), 3)
    w = torch.clamp((y255 - tresh) * grad, 0.0, 1.0)
    return mask_merge(dark, white, w)


def luma_blend(
    a: torch.Tensor,
    b: torch.Tensor,
    luma_limit: float = 0.4,
    alpha: float = 0.90,
    min_w: float = 0.15,
    decay: float = 4.0,
) -> torch.Tensor:
    """Frame-luma-driven blend: on frames of ``a`` darker than
    ``luma_limit`` the weight of ``b`` is ``max(alpha * (L / limit) **
    decay, min_w)``; brighter frames are ``b``."""
    fl = _frame_luma(a)
    bright_scale = torch.clamp((fl / luma_limit) ** decay, 0.0, 1.0)
    w = torch.clamp(alpha * bright_scale, min=min_w)
    return torch.where(fl < luma_limit, weighted_merge(a, b, w), b)


def adaptive_luma_merge(
    a: torch.Tensor,
    b: torch.Tensor,
    luma_threshold: float = 0.6,
    alpha: float = 1.0,
    b_weight: float = 0.5,
    min_weight: float = 0.15,
) -> torch.Tensor:
    """Method 5: on frames darker than ``luma_threshold`` the weight of
    ``b`` decays as ``b_weight * (luma / threshold) ** alpha``, floored at
    ``min_weight``."""
    fl = _frame_luma(b)
    bright_scale = (torch.clamp(fl, min=1e-6) / luma_threshold) ** alpha
    w_dark = torch.clamp(b_weight * bright_scale, min=min_weight)
    w = torch.where(fl < luma_threshold, w_dark, b_weight)
    return weighted_merge(a, b, w)


# --- chroma-clamped merges ---------------------------------------------------

_RED_FIX_RANGES = parse_hue_ranges("280:360,0:30")


def _dark_red_fix(img: torch.Tensor) -> torch.Tensor:
    """Dark-frame red-shift correction: one of four saturation treatments
    chosen by the frame's mean luma; all four are computed and selected
    per frame."""
    fl = _frame_luma(img)

    def sat_in_red(sat):
        return adjust_chroma(img, _RED_FIX_RANGES, sat=sat, hue=0, weight=0.0)

    img_d1 = w_luma_masked_merge(sat_in_red(0.9), img, 0.2, 0.3)  # luma in (0.2, 0.3]
    img_d2 = w_luma_masked_merge(sat_in_red(0.8), img, 0.1, 0.2)  # luma in (0.1, 0.2]
    img_d3 = tweak(img, sat=0.7)  # luma <= 0.1
    out = torch.where(fl > 0.3, img, img_d1)
    return torch.where(fl > 0.2, out, torch.where(fl > 0.1, img_d2, img_d3))


def chroma_limit(stable: torch.Tensor, new: torch.Tensor, alpha: float = 0.15) -> torch.Tensor:
    """Chroma of ``new`` clamped within +/-alpha (relative, on the 0..1
    chroma encoding) of ``stable``'s; luma from ``stable``."""
    yuv1 = rgb_to_yuv(stable)
    yuv2 = rgb_to_yuv(new)
    u1, v1 = yuv1[..., 1], yuv1[..., 2]
    u2 = torch.clamp(yuv2[..., 1], u1 * (1 - alpha), torch.clamp(u1 * (1 + alpha), 0, 1))
    v2 = torch.clamp(yuv2[..., 2], v1 * (1 - alpha), torch.clamp(v1 * (1 + alpha), 0, 1))
    return torch.clamp(yuv_to_rgb(torch.stack([yuv1[..., 0], u2, v2], dim=-1)), 0.0, 1.0)


def constrained_chroma_merge(
    a: torch.Tensor,
    b: torch.Tensor,
    b_weight: float = 0.5,
    chroma_threshold: float = 0.2,
    red_fix: bool = True,
) -> torch.Tensor:
    """Method 3: chroma clamp, optional dark red fix, then the double
    re-merge ``SimpleMerge(CCM, SimpleMerge(a, b, min(w, 0.6)), 0.3)``."""
    stab = chroma_limit(a, b, chroma_threshold)
    if b_weight < 1.0:
        stab = weighted_merge(a, stab, b_weight)
    if red_fix:
        stab = _dark_red_fix(stab)
    clip_m = simple_merge(a, b, min(b_weight, 0.6))
    return simple_merge(stab, clip_m, 0.3)


@functools.lru_cache(maxsize=8)
def _laplacian_kernel(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # made once per device: a copy from the host would wait for the card
    return torch.tensor([[[[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]]]],
                        dtype=dtype, device=device)


@ieee_precision()
def _laplacian(y: torch.Tensor) -> torch.Tensor:
    """3x3 Laplacian (cv2.Laplacian's default kernel) with a replicated
    border, as a depthwise convolution over (..., H, W), at IEEE float32:
    a filter outside the engines computes as on the CPU."""
    x = y.reshape((-1, 1) + tuple(y.shape[-2:]))
    x = torch.nn.functional.pad(x, (1, 1, 1, 1), mode="replicate")
    k = _laplacian_kernel(y.dtype, y.device)
    return torch.nn.functional.conv2d(x, k)[:, 0].reshape(y.shape)


def chroma_bound_adaptive_merge(
    a: torch.Tensor,
    b: torch.Tensor,
    red_fix: bool = True,
    base_tol: int = 14,
    max_extra: int = 18,
    b_weight: float = 0.5,
) -> torch.Tensor:
    """Method 7: per-pixel chroma tolerance ``base_tol + max_extra *
    |Laplacian(Y)|`` on centred chroma (``base_tol``/``max_extra`` on the
    0..255 scale)."""
    yuv1 = rgb_to_yuv(a)
    yuv2 = rgb_to_yuv(b)
    y1 = yuv1[..., 0]
    u1, v1 = yuv1[..., 1] - 0.5, yuv1[..., 2] - 0.5
    u2, v2 = yuv2[..., 1] - 0.5, yuv2[..., 2] - 0.5
    texture = torch.clamp(torch.abs(_laplacian(y1 * 255.0)) / 255.0, 0.0, 1.0)
    tol = (base_tol + max_extra * texture) / 255.0
    u2m = torch.clamp(u2, torch.clamp(u1 - tol, -0.5, 0.5), torch.clamp(u1 + tol, -0.5, 0.5))
    v2m = torch.clamp(v2, torch.clamp(v1 - tol, -0.5, 0.5), torch.clamp(v1 + tol, -0.5, 0.5))
    out = torch.clamp(yuv_to_rgb(torch.stack([y1, u2m + 0.5, v2m + 0.5], dim=-1)), 0.0, 1.0)
    if b_weight < 1.0:
        out = weighted_merge(a, out, b_weight)
    if red_fix:
        out = _dark_red_fix(out)
    return out


def chroma_retention_merge(
    a: torch.Tensor,
    b: torch.Tensor,
    sat: float = 0.8,
    tht: int = 30,
    b_weight: float = 0.9,
    alpha: float = 2.0,
    mask_weight: float = 0.0,
    chroma_resize: bool = True,
    binary_mask: bool = False,
    algo: int = 0,
    return_mask: bool = False,
) -> torch.Tensor:
    """Method 6: restore the colors of the gray pixels of ``a`` from
    ``b``, with ``chroma_resize`` at a reduced square size (spline64) and
    the full-resolution luma of ``a`` married back.  ``return_mask=True``
    returns the gray-pixel mask as a 3-channel image."""
    alpha = max(min(alpha, 10.0), 1.0)
    h, w = a.shape[-3], a.shape[-2]
    work_a, work_b = a, b
    did_resize = False
    if chroma_resize:
        rf = min(max(int(0.4 * w / 16), 16), 48)
        frame_size = min(rf * 16, w)
        if frame_size < w:
            work_a = resize(a, frame_size, frame_size, "spline64")
            work_b = resize(b, frame_size, frame_size, "spline64")
            did_resize = True
    if binary_mask:
        restored = restore_color(color=work_b, gray=work_a, sat=sat, tht=tht, weight=mask_weight,
                                 tht_scen=1.0, return_mask=return_mask)
    else:
        restored = restore_color_gradient(color=work_b, gray=work_a, sat=sat, tht=tht,
                                          weight=mask_weight, alpha=alpha, algo=algo,
                                          return_mask=return_mask)
    if return_mask:
        mask = restored[..., None].expand(restored.shape + (3,))
        if did_resize:
            mask = resize(mask, h, w, "spline64")
        return torch.clamp(mask, 0.0, 1.0)
    if did_resize:
        restored = resize(restored, h, w, "spline64")
        yuv_r = rgb_to_yuv(restored)
        restored = yuv_to_rgb(torch.stack([luma(a), yuv_r[..., 1], yuv_r[..., 2]], dim=-1))
    return weighted_merge(a, restored, b_weight)


def combine_models(
    a: torch.Tensor,
    b: torch.Tensor,
    method: int = 2,
    sat: tuple = (1.0, 1.0),
    hue: tuple = (0.0, 0.0),
    b_weight: float = 0.5,
    cmc_p=None,
    lmm_p=None,
    alm_p=None,
    crt_p=None,
    invert_clips: bool = False,
) -> torch.Tensor:
    """Dispatch over the merge methods.  ``a`` is the stable colorizer
    (DeOldify), ``b`` the vivid one (DDColor)."""
    cmc_p = list(cmc_p or DEF_CMC_p)
    lmm_p = list(lmm_p or DEF_LMM_p)
    alm_p = list(alm_p or DEF_ALM_p)
    crt_p = list(crt_p or DEF_CRT_p)
    if len(cmc_p) == 1:
        cmc_p = cmc_p + [True, 20, 24]
    if invert_clips:
        a, b = b, a
    if a is not None and (hue[0] != 0 or sat[0] != 1):
        a = tweak(a, hue=hue[0], sat=sat[0])
    if b is not None and (hue[1] != 0 or sat[1] != 1):
        b = tweak(b, hue=hue[1], sat=sat[1])
    if a is None:
        return b
    if b is None:
        return a

    if method == 2:
        return simple_merge(a, b, b_weight)
    if method == 3:
        return constrained_chroma_merge(a, b, b_weight, cmc_p[0], cmc_p[1])
    if method == 4:
        luma_mask_limit, luma_white_limit, luma_mask_sat = lmm_p
        c = tweak(a, sat=luma_mask_sat) if luma_mask_sat < 1 else a
        if luma_mask_limit == luma_white_limit:
            masked = luma_masked_merge(c, b, luma_mask_limit)
        else:
            masked = w_luma_masked_merge(c, b, luma_mask_limit, luma_white_limit)
        if b_weight < 1.0:
            return weighted_merge(a, masked, b_weight)
        return masked
    if method == 5:
        return adaptive_luma_merge(a, b, alm_p[0], alm_p[1], b_weight, alm_p[2])
    if method == 6:
        return chroma_retention_merge(
            a, b, sat=crt_p[0], tht=crt_p[1], b_weight=b_weight, alpha=crt_p[2],
            chroma_resize=crt_p[3], mask_weight=crt_p[4], algo=crt_p[5],
        )
    if method == 7:
        return chroma_bound_adaptive_merge(
            a, b, red_fix=cmc_p[1], base_tol=cmc_p[2], max_extra=cmc_p[3], b_weight=b_weight,
        )
    raise ValueError(f"HAVC: unsupported merge method {method}")
