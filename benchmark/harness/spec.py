"""``BENCHMARK.json`` and the files it names, found by name:

* a cell's configuration: ``benchmark/configs/<config>.json``;
* its traffic mix: ``benchmark/traffic/<traffic>.json``;
* a per-layer metric's reader: ``benchmark/metrics/<metric name>.py``, a
  module with ``read(ctx) -> float | None``; a metric named
  ``<quantity>.<family>`` (``mfu_pct.main``: the quantity split by the
  end-to-end metric it moves) without a file of its own is read by
  ``<quantity>.py``.

Later cells, mixes and metrics are new files and new entries; nothing
here changes for them.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, List

__all__ = ["Cell", "load_cell", "load_reader", "bench_dir"]


def bench_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its
    configuration, mix and metrics."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"benchmark: no workload {name!r}; the workloads are {sorted(cells)}")
    w = cells[name]
    here = bench_dir()
    config = _read_json(os.path.join(here, "configs", f"{w['config']}.json"))
    mix = _read_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    return Cell(name=name, chips=w["chips"], config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, name)],
                per_layer=[m for m in bench["per_layer"] if _in_cell(m, name)])


def load_reader(metric: str) -> Callable:
    """``read`` of ``benchmark/metrics/<metric>.py``, else of the file of
    the part of the name before its first dot."""
    path = os.path.join(bench_dir(), "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(bench_dir(), "metrics", f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

