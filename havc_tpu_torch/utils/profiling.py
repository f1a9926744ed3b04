"""Per-stage timing and the device rule of the port.

- ``stage_timer(name)`` — wall-clock context manager.  When profiling is
  on it synchronizes the CUDA device at exit, so work queued on the card
  is charged to the stage that queued it.  Times accumulate in a
  process-wide registry; ``stage_report()`` formats it, ``reset_stages()``
  clears it.  With profiling off it costs one flag test.
- ``resolve_device(device)`` — the port's entry points run on ``cuda``
  unless the caller names another device.  Without CUDA the default
  raises; it never falls back to the CPU.
- ``on_device(x, device)`` — frames as a float32 tensor: a tensor stays
  where it lies unless ``device`` names a device, numpy goes to
  ``resolve_device(device)``.
- ``device_trace(log_dir)`` — ``torch.profiler`` over the CPU and, when
  there is one, the CUDA device, written to ``log_dir`` as a Chrome trace
  (``chrome://tracing``, Perfetto, TensorBoard's profile plugin).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Optional, Union

import torch

__all__ = [
    "enable_profiling",
    "profiling_enabled",
    "stage_timer",
    "stage_times",
    "stage_report",
    "reset_stages",
    "resolve_device",
    "on_device",
    "device_trace",
]

_ENABLED = [False]
_STAGES: "OrderedDict[str, list]" = OrderedDict()  # name -> [total_s, calls]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without CUDA raises.  A
    CUDA device comes back with its index (``cuda`` -> ``cuda:N``, the
    current device) so that equal devices compare equal."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "havc_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor stays on its device unless
    ``device`` names one; numpy goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.float()
    return torch.as_tensor(x, dtype=torch.float32).to(resolve_device(device))


def enable_profiling(on: bool = True) -> None:
    _ENABLED[0] = bool(on)


def profiling_enabled() -> bool:
    if _ENABLED[0]:
        return True
    from ..api import _DEBUG_LEVEL  # debug level >= 1 implies stage timing

    return _DEBUG_LEVEL[0] >= 1


@contextlib.contextmanager
def stage_timer(name: str):
    """Time a pipeline stage, CUDA work included.  No-op when profiling
    is disabled."""
    if not profiling_enabled():
        yield
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ent = _STAGES.setdefault(name, [0.0, 0])
        ent[0] += dt
        ent[1] += 1


def stage_times() -> dict:
    """{stage: (total_seconds, calls)} accumulated since reset."""
    return {k: tuple(v) for k, v in _STAGES.items()}


def reset_stages() -> None:
    _STAGES.clear()


def stage_report() -> str:
    """Human-readable per-stage table, slowest first."""
    if not _STAGES:
        return "(no stages recorded)"
    rows = sorted(_STAGES.items(), key=lambda kv: -kv[1][0])
    width = max(len(k) for k, _ in rows)
    lines = [f"{'stage':<{width}}  total_s  calls  avg_ms"]
    for name, (tot, calls) in rows:
        lines.append(
            f"{name:<{width}}  {tot:7.3f}  {calls:5d}  {1e3 * tot / max(calls, 1):6.1f}"
        )
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, host_tracer_level: Optional[int] = None):
    """Trace the enclosed work with ``torch.profiler`` (CPU activity, and
    CUDA kernels when CUDA is available) and write it into ``log_dir`` as
    a Chrome trace, ``trace_<pid>_<n>.json``.  ``host_tracer_level`` maps
    jax.profiler's host detail onto the profiler's: 2 or more records the
    operators' input shapes, 3 their Python stacks; 1 or None neither."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    level = host_tracer_level or 1
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=level >= 2, with_stack=level >= 3) as prof:
        yield prof
        if torch.cuda.is_available():  # the queued kernels end inside the trace
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
