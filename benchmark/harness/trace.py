"""Reductions of a ``torch.profiler`` trace: the device's busy time (the
union of its kernel intervals), device time by kernel, and the idle gaps
between kernels named by what the host was doing meanwhile."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

__all__ = ["Trace", "union_s", "idle_gaps"]


def union_s(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy


def idle_gaps(kernels: List[Tuple[float, float]], host: List[Tuple[str, float, float]],
              start: float, stop: float) -> Dict[str, float]:
    """Seconds the device sat idle in [start, stop], summed by the host
    operation that overlapped each gap the most (``"host idle"`` where
    none did)."""
    gaps, end = [], start
    for lo, hi in sorted(kernels):
        if lo > end:
            gaps.append((end, lo))
        end = max(end, hi)
    if stop > end:
        gaps.append((end, stop))
    host = sorted(host, key=lambda e: e[1])
    starts = [a for _, a, _ in host]
    out: Dict[str, float] = defaultdict(float)
    for lo, hi in gaps:
        best, name = 0.0, "host idle"
        # top-level host operations of one thread do not overlap: walk back
        # from the last one that starts before the gap ends
        for j in range(bisect.bisect_left(starts, hi) - 1, -1, -1):
            n, a, b = host[j]
            over = min(b, hi) - max(a, lo)
            if over > best:
                best, name = over, n
            if b <= lo:
                break
        out[name] += hi - lo
    return dict(out)


class Trace:
    """The kernels (name, start s, end s) and top-level host operations of
    a profiled stretch of ``wall_s`` seconds."""

    def __init__(self, prof, wall_s: float):
        from torch.autograd import DeviceType

        self.wall_s = wall_s
        self.kernels: List[Tuple[str, float, float]] = []
        host = []
        for e in prof.events():
            lo, hi = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == DeviceType.CUDA:
                self.kernels.append((e.name, lo, hi))
            elif e.cpu_parent is None and not e.name.startswith("ProfilerStep"):
                host.append((e.name, lo, hi))
        self.host = host
        spans = [(lo, hi) for _, lo, hi in self.kernels] + [(lo, hi) for _, lo, hi in host]
        self.start = min((lo for lo, _ in spans), default=0.0)
        self.stop = self.start + wall_s

    def busy_s(self) -> float:
        return union_s([(lo, hi) for _, lo, hi in self.kernels])

    def by_kernel(self) -> Dict[str, Tuple[float, int]]:
        """{kernel name: (device seconds, launches)}."""
        out: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        for name, lo, hi in self.kernels:
            out[name][0] += hi - lo
            out[name][1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    def kernel_mean_s(self, fragment: str):
        """Mean device seconds a launch of the kernels whose name holds
        ``fragment``; None when none ran."""
        times = [hi - lo for name, lo, hi in self.kernels if fragment in name]
        return sum(times) / len(times) if times else None

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(((k, v[0]) for k, v in self.by_kernel().items()), key=lambda r: -r[1])
        gaps = idle_gaps([(lo, hi) for _, lo, hi in self.kernels], self.host,
                         self.start, self.stop)
        return {"device_ops": [[k[:120], s] for k, s in ops[:n]],
                "idle_gaps": [[k[:120], s] for k, s in
                              sorted(gaps.items(), key=lambda r: -r[1])[:n]]}
