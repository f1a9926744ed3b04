"""Motion-based scene detection (the SCXvid and MVTools roles).

Port of ``havc_tpu.scene.motion``.  The downscaled luma is cut into 16x16
blocks; for each block the best SAD against the previous frame over the
shifts of a +/-``search`` window (step 2) is the inter cost, its mean
absolute deviation from its own mean the intra cost.  MVTools' rule flags
a frame whose blocks mostly find no good match; Xvid's flags a frame whose
blocks mostly code cheaper as intra.  Both run where the frames are; the
per-frame fractions come to the host in one copy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..clip import SceneFlags
from ..ops.colorspace import luma
from ..ops.resize import resize
from ..utils.profiling import host_read, on_device
from .detect import _work_size

__all__ = ["motion_stats", "scene_detect_motion", "scene_detect_xvid"]

BLOCK = 16


def _block_reduce_sum(x: torch.Tensor, block: int) -> torch.Tensor:
    """(T, H, W) -> (T, H/b, W/b) summed over blocks."""
    t, h, w = x.shape
    return x.reshape(t, h // block, block, w // block, block).sum(dim=(2, 4))


def _motion_kernel(gray: torch.Tensor, search: int = 4) -> torch.Tensor:
    """Best block SAD per pixel against the previous frame over the
    shifted candidates, (T, H/B, W/B); frame 0 compares with itself."""
    t, h, w = gray.shape
    prev = gray[torch.clamp(torch.arange(t, device=gray.device) - 1, 0, t - 1)]
    best = None
    for dy in range(-search, search + 1, 2):
        for dx in range(-search, search + 1, 2):
            shifted = torch.roll(prev, (dy, dx), dims=(1, 2))
            sad = _block_reduce_sum((gray - shifted).abs(), BLOCK)
            best = sad if best is None else torch.minimum(best, sad)
    return best / (BLOCK * BLOCK)


def _intra_deviation(gray: torch.Tensor) -> torch.Tensor:
    """Per-block mean absolute deviation from the block mean (Xvid's
    ``dev16`` intra cost), (T, H/B, W/B)."""
    t, h, w = gray.shape
    blocks = gray.reshape(t, h // BLOCK, BLOCK, w // BLOCK, BLOCK)
    mean = blocks.mean(dim=(2, 4), keepdim=True)
    return (blocks - mean).abs().mean(dim=(2, 4))


def _block_gray(frames, device) -> torch.Tensor:
    """Luma downscaled (bilinear) to the work size cut to whole blocks."""
    gray = luma(on_device(frames, device))
    nh, nw = _work_size(gray.shape[-2], gray.shape[-1])
    nh, nw = (nh // BLOCK) * BLOCK, (nw // BLOCK) * BLOCK
    return resize(gray[..., None], nh, nw, "bilinear")[..., 0]


@torch.inference_mode()
def motion_stats(frames, search: int = 4, device=None):
    """numpy (best block SAD per pixel (T, H/B, W/B), mean luma (T,))."""
    gray = _block_gray(frames, device)
    best = _motion_kernel(gray, search)
    return host_read(best), host_read(gray.mean(dim=(-2, -1)))


def _fraction_and_luma(votes: torch.Tensor, gray: torch.Tensor):
    """Each frame's share of voting blocks (counted on the device, divided
    on the host in float64 as the JAX package's numpy mean does) and its
    mean luma, in one copy to the host."""
    counts, lumas = host_read(torch.stack([votes.sum(dim=1).float(), gray.mean(dim=(-2, -1))]))
    return counts.astype(np.float64) / votes.shape[1], lumas


def _flags(frac: np.ndarray, ratio: float, min_length: int) -> np.ndarray:
    """Frame 0, then every frame ``min_length`` past the last cut whose
    block fraction exceeds ``ratio``."""
    sc = np.zeros(len(frac), dtype=np.int8)
    last = 0
    for n in range(len(frac)):
        if n == 0 or ((n - last) >= min_length and frac[n] > ratio):
            sc[n] = 1
            last = n
    return sc


@torch.inference_mode()
def scene_detect_xvid(
    frames,
    kf_ratio: float = 0.50,
    intra_bias: float = 2.0 / 255.0,
    min_length: int = 1,
    search: int = 4,
    device=None,
) -> SceneFlags:
    """Xvid-keyframe-style detection: a block votes intra when its
    deviation is cheaper than its best motion-compensated SAD
    (``dev < sad - intra_bias``); a frame whose intra share exceeds
    ``kf_ratio`` starts a scene."""
    gray = _block_gray(frames, device)
    inter = _motion_kernel(gray, search)
    dev = _intra_deviation(gray)
    t = gray.shape[0]
    votes = (dev < inter - intra_bias).reshape(t, -1)
    intra_frac, lumas = _fraction_and_luma(votes, gray)
    return SceneFlags(
        sc_prev=_flags(intra_frac, kf_ratio, min_length),
        sc_next=np.zeros(t, np.int8),
        luma=lumas.astype(np.float32),
        ratio=intra_frac.astype(np.float32),
    )


@torch.inference_mode()
def scene_detect_motion(
    frames,
    bad_sad: float = 0.08,
    bad_ratio: float = 0.55,
    min_length: int = 1,
    search: int = 4,
    device=None,
) -> SceneFlags:
    """MVTools-style SCDetection: a frame whose blocks mostly have no
    match better than ``bad_sad`` in the previous frame starts a scene."""
    gray = _block_gray(frames, device)
    best = _motion_kernel(gray, search)
    t = gray.shape[0]
    fail_frac, lumas = _fraction_and_luma((best > bad_sad).reshape(t, -1), gray)
    return SceneFlags(
        sc_prev=_flags(fail_frac, bad_ratio, min_length),
        sc_next=np.zeros(t, np.int8),
        luma=lumas.astype(np.float32),
        ratio=fail_frac.astype(np.float32),
    )
