"""Temporal chroma stabilization and luma deflicker over the time axis.

Port of ``havc_tpu.ops.temporal``:

* chroma (U, V) averaged over a window of up to 15 frames, arithmetic or
  center-weighted; luma passes through;
* per-offset gray-pixel restore: before a shifted frame enters the
  average, its gray pixels are repainted from the current frame;
* scene-change reset: no frame from another scene segment contributes;
* ReduceFlicker-style luma deflicker.

Each function takes the whole ``(T, H, W, 3)`` clip at once.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.profiling import host_upload
from .chroma import restore_color
from .colorspace import rgb_to_yuv, yuv_to_rgb_preserve_luma

__all__ = [
    "average_weights",
    "chroma_stabilizer",
    "reduce_flicker",
]


def average_weights(nframes: int, weighted: bool = False) -> np.ndarray:
    """Averaging weights for a window of ``nframes``: integer percentages
    summing to 100, returned /100.  Arithmetic gives each neighbour
    trunc(100/N) and the remainder to the center; the weighted variant
    puts the same ascending ramp on both sides (reference quirk)."""
    nframes = int(nframes)
    if nframes % 2 != 1 or nframes < 3:
        raise ValueError(f"average_weights: nframes must be odd and >= 3, got {nframes}")
    nh = round((nframes - 1) / 2)
    if not weighted:
        wi = math.trunc(100.0 / nframes)
        wc = 100 - (nframes - 1) * wi
        w = [wi] * nh + [wc] + [wi] * nh
    else:
        wbase = nframes * (nframes + 1) * 0.5
        ramp = [math.trunc(100.0 * (i + 1) / wbase) for i in range(nh)]
        wc = 100 - 2 * sum(ramp)
        w = ramp + [wc] + ramp
    return (np.asarray(w, np.float64) / 100.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _weights_on(nframes: int, weighted: bool, device: torch.device) -> torch.Tensor:
    # made once per device: a copy from pageable host memory waits for the card
    return torch.from_numpy(average_weights(nframes, weighted)).to(device)


def _segments(scenechange, T: int, device) -> torch.Tensor:
    """Scene segment id per frame: cumulative count of scene starts."""
    if scenechange is None:
        return torch.zeros((T,), dtype=torch.int32, device=device)
    sc = host_upload(scenechange, device).to(torch.int32)
    return torch.cumsum(sc, dim=0)


def chroma_stabilizer(
    frames: torch.Tensor,
    nframes: int = 5,
    weighted: bool = False,
    scenechange=None,
    sat: float = 1.0,
    tht: int = 15,
    weight: float = 0.2,
    tht_scen: float = 0.8,
    frame0: int = 0,
) -> torch.Tensor:
    """Temporal chroma averaging over ``(T, H, W, 3)`` RGB frames.

    Output frame t takes the weighted U/V average over ``t-Nh .. t+Nh``
    (edge-replicated at the clip bounds).  With ``tht`` > 0 each shifted
    neighbour first has its gray pixels restored from the center frame
    (``restore_color`` with ``weight`` as its inner merge weight);
    neighbours whose mean luma lies outside [0.22, 0.78] use
    ``min(weight, -0.8)`` instead.  The first 15 output frames skip the
    restore (the reference's warm-up); ``frame0`` is the global index of
    frames[0].  ``scenechange`` (shape (T,)) masks windows so that no
    frame from another scene segment contributes.
    """
    T = frames.shape[0]
    nframes = min(max(int(nframes), 3), 15)
    if nframes % 2 == 0:
        nframes += 1
    nh = (nframes - 1) // 2
    w = _weights_on(nframes, bool(weighted), frames.device)

    yuv = rgb_to_yuv(frames)
    y_c = yuv[..., 0]
    seg = _segments(scenechange, T, frames.device)
    t_idx = torch.arange(T, device=frames.device)

    acc_u = torch.zeros_like(y_c)
    acc_v = torch.zeros_like(y_c)
    bshape = (T,) + (1,) * (frames.ndim - 2)   # broadcasts over (T, H, W)
    fshape = (T,) + (1,) * (frames.ndim - 1)   # broadcasts over (T, H, W, C)
    acc_w = torch.zeros(bshape, dtype=frames.dtype, device=frames.device)
    warm = ((t_idx + frame0) < 15).reshape(fshape)

    for k, off in enumerate(range(-nh, nh + 1)):
        idx = torch.clamp(t_idx + off, 0, T - 1)
        shifted = frames[idx]
        if off != 0 and tht > 0:
            r_pos = restore_color(
                color=frames, gray=shifted, sat=sat, tht=tht,
                weight=weight, tht_scen=tht_scen,
            )
            r_neg = restore_color(
                color=frames, gray=shifted, sat=sat, tht=tht,
                weight=min(weight, -0.8), tht_scen=tht_scen,
            )
            y_mean = torch.mean(rgb_to_yuv(shifted)[..., 0],
                                dim=tuple(range(1, frames.ndim - 1)))
            standard = ((y_mean >= 0.22) & (y_mean <= 0.78)).reshape(fshape)
            restored = torch.where(standard, r_pos, r_neg)
            shifted = torch.where(warm, shifted, restored)
        yuv_s = rgb_to_yuv(shifted)
        same_scene = (seg[idx] == seg).to(frames.dtype)
        wk = w[k] * same_scene.reshape(bshape)
        acc_u = acc_u + yuv_s[..., 1] * wk
        acc_v = acc_v + yuv_s[..., 2] * wk
        acc_w = acc_w + wk

    u = acc_u / torch.clamp(acc_w, min=1e-6)
    v = acc_v / torch.clamp(acc_w, min=1e-6)
    return yuv_to_rgb_preserve_luma(torch.stack([y_c, u, v], dim=-1))


def reduce_flicker(
    frames: torch.Tensor, strength: int = 5, scenechange=None
) -> torch.Tensor:
    """Temporal luma deflicker over ``(T, H, W, 3)`` RGB frames: pull each
    frame's luma halfway toward the mean of its neighbours, bounded by
    ``strength/255``; scene cuts gate the correction."""
    T = frames.shape[0]
    yuv = rgb_to_yuv(frames)
    y = yuv[..., 0]
    t_idx = torch.arange(T, device=frames.device)
    prev_i = torch.clamp(t_idx - 1, 0, T - 1)
    next_i = torch.clamp(t_idx + 1, 0, T - 1)
    target = 0.5 * (y[prev_i] + y[next_i])
    limit = strength / 255.0
    corr = torch.clamp(0.5 * (target - y), -limit, limit)
    if scenechange is not None:
        seg = _segments(scenechange, T, frames.device)
        ok = ((seg[prev_i] == seg) & (seg[next_i] == seg)).to(y.dtype)
        corr = corr * ok.reshape((T,) + (1,) * (y.ndim - 1))
    y_new = torch.clamp(y + corr, 0.0, 1.0)
    return yuv_to_rgb_preserve_luma(torch.stack([y_new, yuv[..., 1], yuv[..., 2]], dim=-1))
