"""Torch's intra-op thread count for a test process of the port's tests.

Every ``tests/test_torch_*.py`` imports this module; its import sets the
count once, before any of the port's tests runs (each xdist worker imports
every test file when it collects them). The count is the process's share of
the cores it may run on among the xdist workers, at least 1 and at most 2:
with every core busy, a wider pool waits on its slowest thread at each small
op, and the port's tests run tens of times slower.
"""
from __future__ import annotations

import os

import torch


def intra_op_threads() -> int:
    """Cores this process may use, divided by the xdist worker count (1
    without xdist), clamped to 1..2."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, min(2, len(os.sched_getaffinity(0)) // workers))


torch.set_num_threads(intra_op_threads())
