"""Test-sized cells of the benchmark, for the CPU, where the program and
the reference compute alike: each configuration file with the overrides
of ``benchmark/tests/tiny/<config>.json``, found by name, and small clips
of its traffic mix.

A tiny file gives its engines' ``name``, ``args`` and ``params`` (in the
configuration's order, each naming its ``family``), ``havc_main``
keywords that replace the configuration's, and any other key that
replaces the configuration's own (``work_size``, ``limits``); ``what``
says what it is."""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, os.path.join(BENCH, "reference"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import spec  # noqa: E402


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    here = spec.bench_dir()
    c = read_json(os.path.join(here, "configs", f"{name}.json"))
    tiny = read_json(os.path.join(here, "tests", "tiny", f"{name}.json"))
    if [e["family"] for e in tiny["engines"]] != [e["family"] for e in c["engines"]]:
        raise ValueError(f"tests/tiny/{name}.json: its engines are not the configuration's")
    for e, small in zip(c["engines"], tiny["engines"]):
        e.update(small)
    c["havc_main"].update(tiny["havc_main"])
    c.update({k: v for k, v in tiny.items() if k not in ("engines", "havc_main", "what")})
    return c


def tiny_mix(name: str) -> dict:
    m = read_json(os.path.join(spec.bench_dir(), "traffic", f"{name}.json"))
    m.update(frames=4, height=64, width=96, pool=4, check_among=2, check_clips=2,
             profiled_clips=1)
    if m["shots"]:
        m["shots"] = dict(m["shots"], median=6, min=2)
    return m


def tiny_cell(workload: str, root: str = ROOT) -> spec.Cell:
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    inside = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    return spec.Cell(name=workload, chips=1, config=tiny_config(w["config"]),
                     mix=tiny_mix(w["traffic"]),
                     end_to_end=[m for m in bench["end_to_end"] if inside(m)],
                     per_layer=[m for m in bench["per_layer"] if inside(m)])
