"""The one traffic generator: a pool of seeded gray clips made on the
device from a mix's parameters (``benchmark/traffic/<mix>.json``).

A mix names the clip geometry (``frames``, ``height``, ``width``), the pool
size (``pool``) and the content:

* ``"shots": null`` -- every frame its own smooth field (no scene
  structure): uniform random knots on a ``knots`` grid, bilinear up to the
  frame, plus uniform noise of amplitude ``noise``;
* ``"shots": {"median", "sigma", "min", "max"}`` -- a continuous film cut
  into the pool's consecutive clips: each shot one smooth field (knot
  values in ``[lo, hi]``) drifting ``drift_px`` to the left a frame.  The
  shot lengths are the log-normal's quantiles at ``round(N / median)``
  evenly spread probabilities (N the pool's frames), clamped to
  ``[min, max]`` and scaled to sum to N; the seed orders them.  So every
  seed has the same shots in another order, and a cut that would fall on
  a clip's first frame moves one frame later, so that each cut adds one
  reference to its clip.

Clips are 8-bit luma ``(T, H, W)`` on the device; ``as_rgb`` makes the
float32 ``(T, H, W, 3)`` in [0, 1] that ``HAVC_main`` takes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import torch
import torch.nn.functional as F

__all__ = ["Pool", "make_pool", "shot_lengths", "as_rgb"]


@dataclass
class Pool:
    clips: List[torch.Tensor]  # (T, H, W) uint8 luma each
    cuts: List[List[int]]  # per clip: the frames that start a shot, 0 included

    def refs(self, i: int) -> int:
        """References ``HAVC_main`` colorizes in clip ``i``: its first frame
        and each cut inside it."""
        return len(self.cuts[i])


def shot_lengths(n_frames: int, shots: dict, clip_frames: int, order: torch.Tensor) -> List[int]:
    """The film's shot lengths, ``order`` a permutation of them."""
    n = max(1, round(n_frames / shots["median"]))
    dist = NormalDist(math.log(shots["median"]), shots["sigma"])
    q = [min(max(math.exp(dist.inv_cdf((i + 0.5) / n)), shots["min"]), shots["max"])
         for i in range(n)]
    scale = n_frames / sum(q)
    lengths = [max(1, round(x * scale)) for x in q]
    lengths[-1] += n_frames - sum(lengths)
    lengths = [lengths[j] for j in order.tolist()]
    start = 0
    for j in range(len(lengths) - 1):  # no cut on a clip's first frame
        start += lengths[j]
        if start % clip_frames == 0:
            lengths[j] += 1
            lengths[j + 1] -= 1
            start += 1
    return lengths


def _field(knots, size, lo: float, hi: float, gen: torch.Generator, n: int = 1):
    """``n`` smooth fields of ``size`` (h, w): knot values uniform in
    [lo, hi], bilinear (corners aligned) in between."""
    device = gen.device
    k = lo + (hi - lo) * torch.rand((n, 1, *knots), generator=gen, device=device)
    return F.interpolate(k, size=size, mode="bilinear", align_corners=True)[:, 0]


def _to_u8(y: torch.Tensor) -> torch.Tensor:
    return torch.round(y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def make_pool(mix: dict, seed: int, device) -> Pool:
    """The mix's pool of clips from ``seed``, made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t, h, w, n_clips = mix["frames"], mix["height"], mix["width"], mix["pool"]
    lo, hi = mix["field_range"]
    if mix["shots"] is None:
        clips = []
        for _ in range(n_clips):
            y = _field(mix["knots"], (h, w), lo, hi, gen, n=t)
            y = (1.0 - mix["noise"]) * y + mix["noise"] * torch.rand(
                (t, h, w), generator=gen, device=device)
            clips.append(_to_u8(y))
        return Pool(clips, [[0] for _ in range(n_clips)])

    n_frames = t * n_clips
    n_shots = max(1, round(n_frames / mix["shots"]["median"]))
    order = torch.randperm(n_shots, generator=torch.Generator().manual_seed(seed))
    lengths = shot_lengths(n_frames, mix["shots"], t, order)
    drift = mix["drift_px"]
    film, starts = [], []
    for n in lengths:
        starts.append(sum(len(f) for f in film))
        field = _to_u8(_field(mix["knots"], (h, w + drift * n), lo, hi, gen)[0])
        film.append(torch.stack([field[:, drift * i:drift * i + w] for i in range(n)]))
    film = torch.cat(film)
    clips = [film[c * t:(c + 1) * t].clone() for c in range(n_clips)]
    cuts = [[0] + [s - c * t for s in starts if c * t < s < (c + 1) * t] for c in range(n_clips)]
    return Pool(clips, cuts)


def as_rgb(luma_u8: torch.Tensor) -> torch.Tensor:
    """8-bit luma (T, H, W) -> float32 gray RGB (T, H, W, 3) in [0, 1]."""
    y = luma_u8.to(torch.float32) / 255.0
    return y.unsqueeze(-1).expand(*y.shape, 3).contiguous()
