"""The reader of the colorizer layer's fused-join share
(``metrics/unet_join_fused_pct.py``) on the port's counters."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import bench_tiny  # noqa: F401  (puts the harness on the path)
from harness import spec


def test_unet_join_fused_pct_reads_the_registry(monkeypatch):
    read = spec.load_reader("unet_join_fused_pct.main")
    assert read.__code__.co_filename.endswith("/metrics/unet_join_fused_pct.py")
    fake = SimpleNamespace(counters=lambda: {"unet_join_calls": 72, "unet_join_launches": 72})
    monkeypatch.setitem(sys.modules, "havc_tpu_torch.utils.profiling", fake)
    assert read(None) == 100.0
    fake.counters = lambda: {"unet_join_calls": 9, "unet_join_launches": 6}
    assert read(None) == pytest.approx(100.0 * 6 / 9)
    fake.counters = lambda: {"unet_join_calls": 9}  # every join plain: the CPU
    assert read(None) == 0.0
    fake.counters = lambda: {"host_syncs": 4, "clips": 1}  # a port without the counters
    assert read(None) is None
    monkeypatch.setitem(sys.modules, "havc_tpu_torch.utils.profiling", SimpleNamespace())
    assert read(None) is None
