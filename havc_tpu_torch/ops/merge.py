"""Model-combine ("merge") methods, in PyTorch.

Port of ``havc_tpu.ops.merge``.  Method ids match the reference:

* 2 ``SimpleMerge`` — weighted lerp (the method of the main path)
* 3-7 (ConstrainedChroma, LumaMasked, AdaptiveLuma, ChromaRetention,
  ChromaBoundAdaptive) are not ported yet and raise ``NotImplementedError``
  (ROADMAP, queue 1, "merge methods 3-7").

Functions take ``(..., H, W, 3)`` RGB in [0,1].
"""
from __future__ import annotations

import torch

from .chroma import mask_merge, tweak, weighted_merge
from .colorspace import luma

__all__ = [
    "simple_merge",
    "luma_masked_merge",
    "w_luma_masked_merge",
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

_METHOD_NAMES = {3: "ConstrainedChroma", 4: "LumaMasked", 5: "AdaptiveLuma",
                 6: "ChromaRetention", 7: "ChromaBoundAdaptive"}


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
    if method in _METHOD_NAMES:
        raise NotImplementedError(
            f"merge method {method} ({_METHOD_NAMES[method]}) is not ported to "
            "havc_tpu_torch yet (ROADMAP queue 1: merge methods 3-7)"
        )
    raise ValueError(f"HAVC: unsupported merge method {method}")
