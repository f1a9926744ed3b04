"""The port's stage spans in a profiled stretch (``trace.Trace``): the
device's idle time put down to the top-level ``havc.<stage>`` span the
host was in, and the spans' host seconds.

``havc_tpu_torch.utils.profiling.stage_timer`` records a host operator
range ``havc.<stage>`` while a profiler runs; ``Trace.host`` keeps the
top-level ones.  A program without such spans gives None throughout."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from .trace import union_s

__all__ = ["PREFIX", "idle_intervals", "idle_by_span", "idle_pct", "host_s"]

PREFIX = "havc."


def idle_intervals(kernels: List[Tuple[float, float]], start: float,
                   stop: float) -> List[Tuple[float, float]]:
    """The stretches of [start, stop] in which no kernel ran."""
    gaps, end = [], start
    for lo, hi in sorted(kernels):
        if lo > end:
            gaps.append((end, min(lo, stop)))
        end = max(end, hi)
        if end >= stop:
            break
    if stop > end:
        gaps.append((end, stop))
    return [(lo, hi) for lo, hi in gaps if hi > lo]


def _spans(trace) -> List[Tuple[float, float, str]]:
    return sorted((lo, hi, name[len(PREFIX):]) for name, lo, hi in trace.host
                  if name.startswith(PREFIX))


def idle_by_span(trace) -> Dict[Optional[str], float]:
    """Idle seconds of the device by the stage whose span the host was in
    (``None``: in no span).  The values sum to the idle time of the
    profiled stretch."""
    spans = _spans(trace)
    starts = [lo for lo, _, _ in spans]
    out: Dict[Optional[str], float] = defaultdict(float)
    for lo, hi in idle_intervals([(a, b) for _, a, b in trace.kernels], trace.start,
                                 trace.stop):
        pieces = []
        for j in range(bisect.bisect_left(starts, hi) - 1, -1, -1):
            a, b, name = spans[j]
            if b <= lo:  # top-level spans of one thread end in order
                break
            piece = (max(a, lo), min(b, hi))
            out[name] += piece[1] - piece[0]
            pieces.append(piece)
        out[None] += (hi - lo) - union_s(pieces)
    return dict(out)


def idle_pct(trace, stages: Optional[Iterable[str]]) -> Optional[float]:
    """The share of the profiled wall time in which the device idled with
    the host inside a span of ``stages`` (``None``: in no span), in %;
    None where nothing ran on the device or no such span (or, for
    ``None``, no span at all) was recorded."""
    spans = _spans(trace)
    if not trace.kernels or not spans:
        return None
    if stages is not None:
        stages = set(stages)
        if not any(name in stages for _, _, name in spans):
            return None
    idle = idle_by_span(trace)
    keys = [None] if stages is None else stages
    return 100.0 * sum(idle.get(k, 0.0) for k in keys) / trace.wall_s


def host_s(trace, stage: str) -> Optional[float]:
    """Host seconds inside top-level ``havc.<stage>`` spans; None where
    there is none."""
    times = [hi - lo for lo, hi, name in _spans(trace) if name == stage]
    return sum(times) if times else None
