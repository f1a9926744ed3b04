"""Quality metrics and the golden-frame comparison harness.

Port of ``havc_tpu.metrics``: per-pixel CIEDE2000 (``ops.colorspace``)
between two RGB [0, 1] images or clips, PSNR, and the per-image, per-clip
and per-directory statistics.  LAB and CIEDE2000 are computed on the
device the frames are on (``device`` for numpy); only the statistics come
back to the host.

    from havc_tpu_torch.metrics import compare_clip
    stats = compare_clip(out_frames, reference_frames)
"""
from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch

from .ops.colorspace import ciede2000, rgb_to_lab
from .utils.profiling import on_device

__all__ = ["dE2000", "psnr", "compare_images", "compare_clip", "compare_dirs"]


def _pair(img1, img2, device=None):
    """Both images as tensors on ``img1``'s device (``device`` for numpy)."""
    a = on_device(img1, device)
    return a, on_device(img2, a.device)


def _de(img1, img2, device=None) -> torch.Tensor:
    a, b = _pair(img1, img2, device)
    return ciede2000(rgb_to_lab(a), rgb_to_lab(b))


@torch.inference_mode()
def dE2000(img1, img2, device=None):
    """Per-pixel CIEDE2000 between two RGB [0, 1] images (or clips): a
    tensor for tensor input, numpy for numpy input."""
    de = _de(img1, img2, device)
    return de if isinstance(img1, torch.Tensor) else de.cpu().numpy()


def _mse(img1, img2, device=None) -> float:
    a, b = _pair(img1, img2, device)
    return float(((a - b) ** 2).mean())


def _psnr_of(mse: float) -> float:
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


@torch.inference_mode()
def psnr(img1, img2, device=None) -> float:
    """Peak signal-to-noise ratio (peak 1) in dB; inf for equal images."""
    return _psnr_of(_mse(img1, img2, device))


def _percentile(de: torch.Tensor, q: float) -> float:
    """``np.percentile(de, q)`` (linear interpolation) by two order
    statistics (``torch.quantile`` refuses more than 2^24 values)."""
    flat = de.reshape(-1)
    pos = q / 100.0 * (flat.numel() - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    a = float(torch.kthvalue(flat, lo + 1).values)
    b = a if hi == lo else float(torch.kthvalue(flat, hi + 1).values)
    return a + (b - a) * (pos - lo)


@torch.inference_mode()
def compare_images(img1, img2, device=None) -> Dict[str, float]:
    de = _de(img1, img2, device)
    return {
        "dE2000_mean": float(de.mean()),
        "dE2000_p95": _percentile(de, 95),
        "dE2000_max": float(de.max()),
        "psnr": _psnr_of(_mse(img1, img2, device)),
    }


@torch.inference_mode()
def compare_clip(frames1, frames2, device=None) -> Dict[str, float]:
    """Frame-for-frame fidelity of two (T, H, W, 3) clips."""
    assert tuple(frames1.shape) == tuple(frames2.shape)
    de = _de(frames1, frames2, device)
    per_frame = de.reshape(de.shape[0], -1).mean(dim=1)
    return {
        "dE2000_mean": float(de.mean()),
        "dE2000_worst_frame": float(per_frame.max()),
        "dE2000_p95": _percentile(de, 95),
        "psnr": _psnr_of(_mse(frames1, frames2, device)),
        "frames": int(de.shape[0]),
    }


def compare_dirs(dir1: str, dir2: str, device=None) -> Dict[str, Dict[str, float]]:
    """Compare the images of matching file names in two directories."""
    from .io.video import read_image

    out = {}
    for name in sorted(os.listdir(dir1)):
        p1, p2 = os.path.join(dir1, name), os.path.join(dir2, name)
        if os.path.isfile(p1) and os.path.isfile(p2):
            a, b = read_image(p1), read_image(p2)
            if a.shape == b.shape:
                out[name] = compare_images(a, b, device)
    if out:
        out["__summary__"] = {
            "dE2000_mean": float(np.mean([v["dE2000_mean"] for v in out.values()])),
            "images": len(out),
        }
    return out
