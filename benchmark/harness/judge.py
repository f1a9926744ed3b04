"""How ``correct`` is decided: the clips the timed path colorized, sampled
from the seed, against the plain reference on the same inputs.

Numbers, each the worst over the sampled clips:

* ``rgb_mean_abs``: the mean distance of the output's RGB values from the
  reference's;
* ``rgb_p999_abs``: the 99.9th percentile of that distance (the widest
  gaps of a clip but its last thousandth);
* ``cuts_wrong``: frames whose scene-change flag differs from the
  reference's (only where the configuration's ``limits`` hold it: where
  its path detects scenes).

The configuration's ``limits`` says which numbers are held and to what;
a run is correct when every held number is at or under its limit.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["sample_positions", "clip_numbers", "worst", "verdict", "format_checks"]


def sample_positions(seed: int, refs: List[int], among: int, k: int) -> List[int]:
    """``k`` hand-off positions among the first ``among``, drawn from the
    seed, always with the position whose clip has the most references
    (``refs[i]`` for position i)."""
    among = min(among, len(refs))
    longest = max(range(among), key=lambda i: (refs[i], -i))
    rest = [i for i in range(among) if i != longest]
    rng = random.Random(seed * 7919 + 17)
    return sorted([longest] + rng.sample(rest, min(k - 1, len(rest))))


def clip_numbers(got: torch.Tensor, got_sc: Optional[np.ndarray], want: torch.Tensor,
                 want_sc: Optional[np.ndarray]) -> Dict[str, float]:
    """The numbers of one clip: ``got`` and ``want`` (T, H, W, 3) on one
    device, the scene flags as numpy or None."""
    d = (got.float() - want.float()).abs().flatten()
    p999 = torch.kthvalue(d, max(1, int(np.ceil(0.999 * d.numel())))).values
    out = {"rgb_mean_abs": float(d.double().mean()), "rgb_p999_abs": float(p999)}
    if want_sc is not None:
        g = np.zeros(len(want_sc), bool) if got_sc is None else np.asarray(got_sc).astype(bool)
        out["cuts_wrong"] = float(np.sum(g != np.asarray(want_sc).astype(bool)))
    return out


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every held number present and within its limit (NaN fails)."""
    return bool(numbers) and all(k in numbers and numbers[k] <= v for k, v in limits.items())


def format_checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
