"""Stage spans, counters and the device rule of the port.

- ``stage_timer(name)`` — a span around a pipeline stage.  It never
  waits for the device.  With no profiler recording and stage timing
  off it costs two flag reads.  While a ``torch.profiler`` records, the
  span is a host operator range named ``havc.<name>`` in the same trace
  as the kernels (``RecordFunctionFast``: no user annotation, so no event
  on the device's timeline).  With stage timing on (``enable_profiling``,
  or ``HAVC_set_debug_level(1)`` and above) it records a pair of CUDA
  events on the current stream of the current device and the host's
  clock at entry and exit; the events are resolved as they complete.
  Each span keeps its parent (the span open when it began) and the index
  of the ``HAVC_main`` call it belongs to.  ``stage_times()`` waits once
  and gives ``{stage: (device_s, calls, host_s)}``; ``stage_report()``
  adds self time (a stage less its children) and the counters;
  ``reset_stages()`` clears the spans.
- ``count(name, n=1)`` — a process-wide counter, always on:
  ``host_syncs`` (every copy between host and device on ``HAVC_main``'s
  paths that waits for the card: ``host_read``, ``host_upload``),
  ``clips`` (``HAVC_main`` calls), the kernels' launches
  (``post_chain_launches``, ``window_attn_launches``,
  ``window_attn_launches_bf16``; a replayed CUDA graph adds what its
  capture counted), ColorMNet's frame steps (``cm_steps``; those run as a
  replay of a captured CUDA graph, ``cm_graph_replays``; the captures,
  ``cm_graph_captures``).  ``counters()`` reads them,
  ``reset_counters()`` clears them (``reset_stages()`` does not).
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
import itertools
import os
import time
from collections import OrderedDict, defaultdict, deque
from typing import Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = [
    "enable_profiling",
    "set_debug_timing",
    "profiling_enabled",
    "stage_timer",
    "stage_times",
    "stage_spans",
    "stage_report",
    "reset_stages",
    "count",
    "counters",
    "reset_counters",
    "host_read",
    "host_upload",
    "clip_scope",
    "resolve_device",
    "on_device",
    "device_trace",
]

# stage timing is on when either switch is: enable_profiling, and the
# operator's debug level (set by HAVC_set_debug_level)
_SWITCHES = {"profiling": False, "debug": False}
_TIMING = [False]
_COUNTS: "defaultdict[str, int]" = defaultdict(int)
MAX_SPANS = 1 << 16  # the spans kept one by one (the totals keep every span)


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


# --- counters ------------------------------------------------------------------


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def counters() -> dict:
    """{counter: count} since ``reset_counters()``."""
    return dict(_COUNTS)


def reset_counters(*names: str) -> None:
    """Clear the counters ``names``, or every counter."""
    for name in names or list(_COUNTS):
        _COUNTS.pop(name, None)


def host_read(t: torch.Tensor):
    """``t`` as a numpy array, counted in ``host_syncs``: on a card the
    copy waits for the work queued before it."""
    _COUNTS["host_syncs"] += 1
    return t.cpu().numpy()


def host_upload(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device``; a copy from the host (numpy, or a
    tensor elsewhere) is counted in ``host_syncs``: from pageable memory
    it waits for the card."""
    if not (isinstance(x, torch.Tensor) and x.device == torch.device(device)):
        _COUNTS["host_syncs"] += 1
    return torch.as_tensor(x, device=device)


# --- stage spans ---------------------------------------------------------------


def enable_profiling(on: bool = True) -> None:
    """Stage timing on or off (it is also on at debug level 1 and above)."""
    _SWITCHES["profiling"] = bool(on)
    _TIMING[0] = any(_SWITCHES.values())


def set_debug_timing(on: bool) -> None:
    """The operator's switch of stage timing (``HAVC_set_debug_level``)."""
    _SWITCHES["debug"] = bool(on)
    _TIMING[0] = any(_SWITCHES.values())


def profiling_enabled() -> bool:
    return _TIMING[0]


def _add(rows: dict, name: str, parent: Optional[str], device_s: float, host_s: float) -> None:
    """One span into ``rows``: {stage: [device_s, calls, host_s,
    children's device_s]}."""
    r = rows.setdefault(name, [0.0, 0, 0.0, 0.0])
    r[0] += device_s
    r[1] += 1
    r[2] += host_s
    if parent is not None:
        rows.setdefault(parent, [0.0, 0, 0.0, 0.0])[3] += device_s


class _Timed:
    """One span of stage timing: its events (None off CUDA) and host clock."""

    __slots__ = ("name", "parent", "clip", "dev", "start", "stop", "t0", "t1")

    def __init__(self, name: str, parent: Optional[str], clip: Optional[int]):
        self.name, self.parent, self.clip = name, parent, clip
        self.dev = self.start = self.stop = None
        self.t0 = self.t1 = 0.0


class _Stages:
    """The spans of stage timing: the open ones (a stack), those whose
    events are queued, the totals by stage and the last ``MAX_SPANS``
    spans one by one."""

    def __init__(self):
        self.open = []  # names of the spans open now
        self.pending = deque()  # spans closed on the host, events not yet resolved
        self.totals: "OrderedDict[str, list]" = OrderedDict()  # as ``_add`` keeps them
        self.spans = deque(maxlen=MAX_SPANS)  # (name, parent, clip, device_s, host_s)
        self.pool = defaultdict(list)  # device index -> free timing events
        self.clip = None  # the index of the HAVC_main call running now
        self.clip_ids = itertools.count()

    def _event(self, dev: int) -> "torch.cuda.Event":
        free = self.pool[dev]
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def enter(self, name: str) -> _Timed:
        span = _Timed(name, self.open[-1] if self.open else None, self.clip)
        if torch.cuda.is_initialized():
            span.dev = torch.cuda.current_device()
            span.start, span.stop = self._event(span.dev), self._event(span.dev)
            span.start.record()
        self.open.append(name)
        span.t0 = time.perf_counter()
        return span

    def exit(self, span: _Timed) -> None:
        span.t1 = time.perf_counter()
        if span.stop is not None:
            span.stop.record(torch.cuda.current_stream(span.dev))
        self.open.pop()
        self.pending.append(span)
        while self.pending:  # resolved in order, without waiting
            s = self.pending[0]
            if s.stop is not None and not s.stop.query():
                break
            self._resolve(self.pending.popleft())

    def _resolve(self, span: _Timed) -> None:
        host_s = span.t1 - span.t0
        device_s = host_s
        if span.start is not None:
            device_s = 1e-3 * span.start.elapsed_time(span.stop)
            self.pool[span.dev] += [span.start, span.stop]
        _add(self.totals, span.name, span.parent, device_s, host_s)
        self.spans.append((span.name, span.parent, span.clip, device_s, host_s))

    def wait(self) -> None:
        """Resolve every queued span, waiting for its events."""
        while self.pending:
            span = self.pending.popleft()
            if span.stop is not None:
                span.stop.synchronize()
            self._resolve(span)


_REG = _Stages()


class _Span:
    __slots__ = ("name", "rf", "timed")

    def __init__(self, name: str):
        self.name, self.rf, self.timed = name, None, None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _RecordFunctionFast("havc." + self.name)
            self.rf.__enter__()
        if _TIMING[0]:
            self.timed = _REG.enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.timed is not None:
            _REG.exit(self.timed)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def stage_timer(name: str):
    """A span around the stage ``name``; it never waits for the device."""
    if not (_TIMING[0] or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def clip_scope():
    """One ``HAVC_main`` call: counted in ``clips``; the spans opened
    inside carry the call's index, which it yields."""
    _COUNTS["clips"] += 1
    outer, _REG.clip = _REG.clip, next(_REG.clip_ids)
    try:
        yield _REG.clip
    finally:
        _REG.clip = outer


def stage_times() -> dict:
    """{stage: (device_s, calls, host_s)} accumulated since reset, once
    the device has run every span's work (this waits)."""
    _REG.wait()
    return {k: (v[0], v[1], v[2]) for k, v in _REG.totals.items() if v[1]}


def stage_spans() -> list:
    """The last ``MAX_SPANS`` spans, each ``(name, parent, clip, device_s,
    host_s)``, in the order they closed (this waits)."""
    _REG.wait()
    return list(_REG.spans)


def reset_stages() -> None:
    """Clear the spans (the counters stay)."""
    _REG.wait()
    _REG.totals.clear()
    _REG.spans.clear()


def stage_report(clip: Optional[int] = None) -> str:
    """Per stage (slowest first): device ms, host ms, self ms (device
    less the children's) and calls; then the counters.  ``clip`` limits
    the stages to the spans of that ``HAVC_main`` call."""
    _REG.wait()
    if clip is None:
        rows = _REG.totals
    else:
        rows = {}
        for name, parent, c, device_s, host_s in _REG.spans:
            if c == clip:
                _add(rows, name, parent, device_s, host_s)
    rows = {k: v for k, v in rows.items() if v[1]}
    lines = []
    if rows:
        width = max(len(k) for k in rows)
        lines.append(f"{'stage':<{width}}  device_ms    host_ms    self_ms  calls")
        for name, (dev_s, calls, host_s, child_s) in sorted(rows.items(),
                                                           key=lambda kv: -kv[1][0]):
            lines.append(f"{name:<{width}}  {1e3 * dev_s:9.3f}  {1e3 * host_s:9.3f}  "
                         f"{1e3 * (dev_s - child_s):9.3f}  {calls:5d}")
    else:
        lines.append("(no stages recorded)")
    lines.append("counters: " + (", ".join(f"{k} {v}" for k, v in sorted(_COUNTS.items()))
                                 or "none"))
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
