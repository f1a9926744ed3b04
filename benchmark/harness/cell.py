"""One run of one cell: set-up, the measured window, the check.

Set-up makes the clip pool from the seed on the device, the seeded
engines, and runs ``HAVC_main`` once on a clip of each distinct reference
count in the pool (so every shape the window meets is built and its
kernels compiled).  The window is a closed loop with one client: it hands
clip ``i % pool`` (8-bit luma made float32 RGB by the harness) as soon as
the last output is synchronized, until ``seconds`` have passed and the
positions the check samples have been handed.  Their outputs stay on the
device until the check (a copy to the host would stall the loop).

With ``trace`` the window is split in two parts that do not overlap: the
first ``profiled_clips`` clips under ``torch.profiler`` alone (idle share,
kernel times, MFU), then the rest of ``seconds`` with the port's stage
timer on (stage times).

After the window the peak memory is read, the program's state freed,
and the reference runs the sampled inputs.  ``print_result`` prints the
result only if no module of JAX or the JAX package is loaded by then.
"""
from __future__ import annotations

import gc
import json
import statistics
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from . import judge, spec
from .program import Program
from .reference import Reference
from .trace import Trace
from .traffic import as_rgb, make_pool

__all__ = ["run_cell", "compare", "print_result", "forbidden_modules", "p90"]

FORBIDDEN = ("jax", "jaxlib", "flax", "havc_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``havc_tpu_torch`` is not ``havc_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def p90(times: List[float]) -> float:
    """The 90th percentile of every clip's time (inclusive quantiles)."""
    return statistics.quantiles(times, n=10, method="inclusive")[-1] if len(times) > 1 else times[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Loop:
    """The closed loop over the pool, one client."""

    def __init__(self, program: Callable, pool, device, keep: List[int]):
        self.program, self.pool, self.device, self.keep = program, pool, device, set(keep)
        self.i, self.times, self.frames, self.clips = 0, [], 0, []
        self.kept: Dict[int, tuple] = {}

    def step(self) -> float:
        """Hand one clip, wait for its output; its seconds."""
        n = self.i % len(self.pool.clips)
        t0 = time.perf_counter()
        out = self.program(as_rgb(self.pool.clips[n]))
        _sync(self.device)
        dt = time.perf_counter() - t0
        self.times.append(dt)
        self.frames += self.pool.clips[n].shape[0]
        self.clips.append(n)
        if self.i in self.keep:  # held on the device: a copy would stall the loop
            sc = None if out.sc is None else out.sc.sc_prev.copy()
            self.kept[self.i] = (n, out.frames, sc)
        self.i += 1
        return dt

    def run_for(self, seconds: float) -> float:
        """Clips until ``seconds`` have passed and every sampled position
        has been handed; the window's seconds, from the first hand-off to
        the last output."""
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            self.step()
            if time.perf_counter() - t0 >= seconds and self.i > max(self.keep, default=-1):
                return time.perf_counter() - t0


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, program_factory: Optional[Callable] = None) -> dict:
    """The cell's run: the contract's result, ``checks`` (each compared
    number beside its limit) last.  ``t_start`` is when the process
    started; ``program_factory`` builds the system under test (the port's
    ``HAVC_main`` by default)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    config, mix = cell.config, cell.mix
    pool = make_pool(mix, seed, device)
    refs = [pool.refs(i) for i in range(len(pool.clips))]
    make = program_factory or (lambda: Program(config, device))
    program = make()

    warm = {}
    for i, r in enumerate(refs):
        warm.setdefault(r, i)
    for i in warm.values():
        program(as_rgb(pool.clips[i]))
    _sync(device)
    if trace:  # the profiler's own first start is set-up too
        with torch.profiler.profile(activities=_activities(device)):
            torch.zeros(1, device=device).add_(1)
            _sync(device)
    keep = judge.sample_positions(seed, refs, mix["check_among"], mix["check_clips"])
    loop = _Loop(program, pool, device, keep)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    ctx = None
    if not trace:
        window_s = loop.run_for(seconds)
    else:
        ctx = _traced_window(loop, program, seconds, mix, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted, times, frames, kept = loop.i, loop.times, loop.frames, loop.kept
    del loop
    program.close()
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers, flops_per_frame = _check(config, pool, kept, device, trace)
    limits = config["limits"]
    correct = judge.verdict(numbers, limits) and len(kept) == len(keep)
    result = {"correct": correct, "attempted": attempted, "failed": attempted - len(times)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        ctx.flops_per_frame, ctx.config = flops_per_frame, config
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=ctx.trace.busy_s(), window_s=ctx.trace.wall_s)
        result.update(metrics=metrics, device=dev, breakdown=ctx.trace.breakdown())
    else:
        values = {"fps": frames / window_s, "clip_s_p90": p90(times),
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        # a metric named ``<quantity>.<family>`` (``fps.main``) is that quantity
        result.update(metrics={m["name"]: {"value": values[m["name"].split(".")[0]],
                                           "unit": m["unit"]} for m in cell.end_to_end},
                      device=dev)
    result["checks"] = judge.format_checks(numbers, limits)
    return result


def print_result(result: dict) -> int:
    """Each compared number beside its limit, as the last lines of
    standard error, and the result as the last line of standard output;
    0.  Where a module of JAX, flax or the JAX package is loaded by now,
    that on standard error instead, no result, and 4."""
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 4
    for name, chk in result["checks"].items():
        print(f"check {name}: {chk['value']!r} limit {chk['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def _activities(device: torch.device):
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


def _traced_window(loop: _Loop, program, seconds: float, mix: dict,
                   device) -> SimpleNamespace:
    """The first ``profiled_clips`` clips under the profiler alone, then
    the rest of ``seconds`` under the port's stage timer: what the
    per-layer readers read (``benchmark/metrics``)."""
    n_prof = mix["profiled_clips"]
    with torch.profiler.profile(activities=_activities(device)) as prof:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n_prof):
            loop.step()
        wall_s = time.perf_counter() - t0
    program.stage_timing(True)
    loop.run_for(max(seconds - wall_s, 0.0))
    stages = program.stage_times()
    program.stage_timing(False)
    pool = loop.pool
    part = lambda clips: dict(clips=len(clips),  # noqa: E731
                              frames=sum(pool.clips[n].shape[0] for n in clips),
                              refs=sum(pool.refs(n) for n in clips))
    return SimpleNamespace(trace=Trace(prof, wall_s), stages=stages,
                           profiled=part(loop.clips[:n_prof]), timed=part(loop.clips[n_prof:]),
                           mix=mix)


def compare(config: dict, pool, outputs: List[tuple], reference) -> Dict[str, float]:
    """The worst numbers (``judge``) of ``outputs``, each ``(clip index in
    the pool, frames, scene flags)``, against ``reference`` run on the
    same clips' inputs."""
    scenes = "cuts_wrong" in config["limits"]
    rows = []
    for n, got, got_sc in outputs:
        want = reference(as_rgb(pool.clips[n]))
        rows.append(judge.clip_numbers(got, got_sc, want.frames,
                                       want.sc.sc_prev if scenes else None))
    return judge.worst(rows)


def _check(config: dict, pool, kept: dict, device, count_flops: bool):
    """The sampled outputs against the reference on the same inputs: the
    worst numbers, and the FLOPs per frame of each engine family (with
    ``count_flops``)."""
    reference = Reference(config, device, count_flops=count_flops)
    outputs = [kept[pos] for pos in sorted(kept)]
    numbers = compare(config, pool, outputs, reference)
    frames = {}
    for n, got, _ in outputs:
        for e in config["engines"]:
            frames[e["family"]] = frames.get(e["family"], 0) + (
                pool.refs(n) if e["runs_on"] == "references" else got.shape[0])
    flops = reference.flops()
    reference.close()
    return numbers, {f: flops[f] / frames[f] for f in flops if frames.get(f)}
