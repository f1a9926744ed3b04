"""CPU tests of the readers of the port's stage spans and counters
(``harness/spans.py``, ``metrics/*_idle_pct.py``,
``metrics/cm_loop_host_ms_per_frame.py``,
``metrics/host_syncs_per_clip.py``) on synthetic traces, and on traced
runs of the test-sized cells."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench_tiny import tiny_cell
from harness import cell, spans, spec, trace

SPAN_METRICS = ("cm_loop_idle_pct", "engines_idle_pct.main", "unspanned_idle_pct.main")


def _event(name, lo, hi, device=DeviceType.CPU, parent=None):
    """A profiler event at [lo, hi] seconds."""
    return SimpleNamespace(name=name, device_type=device, cpu_parent=parent,
                           time_range=SimpleNamespace(start=lo * 1e6, end=hi * 1e6))


def synthetic_trace(with_spans: bool = True) -> trace.Trace:
    """10 s: kernels busy in [0, 1], [2, 3], [4.5, 5], [7, 8] (3.5 s); the host in
    havc.deoldify [0, 2.5], havc.cm_frame_loop [3, 6] (an ATen operator and
    a nested span inside it), glue operators at [6.2, 6.5] and [9, 9.5]."""
    k = [_event(f"kernel{i}", lo, hi, DeviceType.CUDA)
         for i, (lo, hi) in enumerate([(0, 1), (2, 3), (4.5, 5), (7, 8)])]
    host = [_event("aten::cat", 6.2, 6.5), _event("aten::mul", 9.0, 9.5)]
    if with_spans:
        loop = _event("havc.cm_frame_loop", 3.0, 6.0)
        host += [_event("havc.deoldify", 0.0, 2.5), loop,
                 _event("aten::conv2d", 3.1, 3.5, parent=loop),
                 _event("havc.cm_key_encoder", 5.0, 5.5, parent=loop)]
    else:
        host += [_event("aten::conv2d", 3.1, 3.5)]
    return trace.Trace(SimpleNamespace(events=lambda: k + host), 10.0)


def _ctx(tr, frames=20):
    return SimpleNamespace(trace=tr, profiled={"clips": 2, "frames": frames, "refs": 2})


def test_idle_intervals_clip_to_the_stretch():
    assert spans.idle_intervals([(0, 1), (2, 3), (2.5, 4)], 0.0, 10.0) == [(1, 2), (4, 10)]
    assert spans.idle_intervals([(-1, 0.5), (3, 12)], 0.0, 10.0) == [(0.5, 3)]
    assert spans.idle_intervals([], 0.0, 2.0) == [(0.0, 2.0)]


def test_idle_by_span_definitions():
    """Idle [1, 2] under deoldify; [3, 4.5] and [5, 6] under the loop (the
    nested span counts for its top-level one); [6, 7] and [8, 10] in no
    span (the glue operators' time does not matter)."""
    tr = synthetic_trace()
    idle = spans.idle_by_span(tr)
    assert idle == pytest.approx({"deoldify": 1.0, "cm_frame_loop": 2.5, None: 3.0})
    assert "cm_key_encoder" not in idle
    assert spans.host_s(tr, "cm_frame_loop") == pytest.approx(3.0)
    assert spans.host_s(tr, "ddcolor") is None
    ctx = _ctx(tr)
    read = {m: spec.load_reader(m)(ctx) for m in SPAN_METRICS}
    assert read == pytest.approx({"cm_loop_idle_pct": 25.0, "engines_idle_pct.main": 10.0,
                                  "unspanned_idle_pct.main": 30.0})
    assert spec.load_reader("cm_loop_host_ms_per_frame")(ctx) == pytest.approx(150.0)


def test_span_shares_partition_device_idle():
    """The idle shares of every span and of no span sum to
    ``device_idle_pct``."""
    tr = synthetic_trace()
    whole = spec.load_reader("device_idle_pct.main")(_ctx(tr))
    assert whole == pytest.approx(100.0 * (10.0 - 3.5) / 10.0)
    assert 100.0 * sum(spans.idle_by_span(tr).values()) / tr.wall_s == pytest.approx(whole)
    ctx = _ctx(tr)
    parts = [spec.load_reader(m)(ctx) for m in SPAN_METRICS]
    assert sum(parts) == pytest.approx(whole)


def test_readers_without_spans_read_nothing():
    """A program without spans (the parent commit's) or a trace without
    kernels: every span reader gives None and none raises."""
    for tr in (synthetic_trace(with_spans=False),
               trace.Trace(SimpleNamespace(events=lambda: [_event("havc.deoldify", 0, 1)]),
                           1.0)):
        ctx = _ctx(tr)
        assert all(spec.load_reader(m)(ctx) is None for m in SPAN_METRICS)
    assert spec.load_reader("cm_loop_host_ms_per_frame")(
        _ctx(synthetic_trace(with_spans=False))) is None
    assert spec.load_reader("engines_idle_pct.exemplar")(
        _ctx(synthetic_trace())) == pytest.approx(10.0)


def test_host_syncs_per_clip_reads_the_registry(monkeypatch):
    read = spec.load_reader("host_syncs_per_clip.main")
    fake = SimpleNamespace(counters=lambda: {"host_syncs": 9, "clips": 3})
    monkeypatch.setitem(sys.modules, "havc_tpu_torch.utils.profiling", fake)
    assert read(None) == 3.0
    fake.counters = lambda: {"host_syncs": 4}
    assert read(None) is None
    monkeypatch.setitem(sys.modules, "havc_tpu_torch.utils.profiling", SimpleNamespace())
    assert read(None) is None


def test_traced_tiny_exemplar_cell_reads_spans_and_counters():
    """A traced run of the test-sized exemplar cell on the CPU: the span
    readers that need no device read their values; the engines' and the
    loop's spans are top-level host events of the profiled part."""
    out = cell.run_cell(tiny_cell("exemplar.film-1080p"), 2**31 + 5, 1.0, True, "cpu", 0.0)
    m = out["metrics"]
    assert m["cm_loop_host_ms_per_frame"]["value"] > 0
    assert m["host_syncs_per_clip.exemplar"]["value"] >= 1.0
    assert "cm_loop_idle_pct" not in m  # no kernels on the CPU: nothing to read
    names = {n for n, _ in out["breakdown"]["idle_gaps"]}
    assert any(n.startswith("havc.") for n in names)
