"""The reader of the ColorMNet layer's graph share
(``metrics/cm_graph_step_pct.py``) on the port's counters."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import bench_tiny  # noqa: F401  (puts the harness on the path)
from harness import spec


def test_cm_graph_step_pct_reads_the_registry(monkeypatch):
    read = spec.load_reader("cm_graph_step_pct")
    fake = SimpleNamespace(counters=lambda: {"cm_steps": 64, "cm_graph_replays": 61,
                                             "cm_graph_captures": 3})
    monkeypatch.setitem(sys.modules, "havc_tpu_torch.utils.profiling", fake)
    assert read(None) == pytest.approx(100.0 * 61 / 64)
    fake.counters = lambda: {"cm_steps": 16}  # every step eager: the CPU
    assert read(None) == 0.0
    fake.counters = lambda: {"host_syncs": 4, "clips": 1}  # a port without the counters
    assert read(None) is None
    monkeypatch.setitem(sys.modules, "havc_tpu_torch.utils.profiling", SimpleNamespace())
    assert read(None) is None
