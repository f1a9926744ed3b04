"""Test-sized cells of the benchmark's two configurations: the same
configuration files with small engines (nano DeOldify, micro DDColor and
ColorMNet), small clips and limits for the CPU, where the program and the
reference compute alike."""
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

TINY_ENGINES = {
    "deoldify": dict(args={"encoder": "nano", "nf_factor": 1}, params=4346885),
    "ddcolor": dict(args={"encoder": "micro", "dim": 64, "num_queries": 16, "num_blocks": 3,
                          "unet_out": [64, 64, 32], "heads": 8, "ffn_dim": 128},
                    params=1523944),
    "colormnet": dict(name="micro", args={"config": "micro"}, params=12994122),
}
# on the CPU both sides compute in IEEE float32 with the same operations
TINY_LIMITS = {"rgb_mean_abs": 1e-6, "rgb_p999_abs": 1e-5, "cuts_wrong": 0}


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    c = read_json(os.path.join(BENCH, "configs", f"{name}.json"))
    for e in c["engines"]:
        e.update(TINY_ENGINES[e["family"]])
    if "engine_config" in c["havc_main"]:
        c["havc_main"]["engine_config"] = "micro"
    c["work_size"] = 96
    c["limits"] = {k: v for k, v in TINY_LIMITS.items() if k in c["limits"]}
    return c


def tiny_mix(name: str) -> dict:
    m = read_json(os.path.join(BENCH, "traffic", f"{name}.json"))
    m.update(frames=4, height=64, width=96, pool=4, check_among=2, check_clips=2,
             profiled_clips=1)
    if m["shots"]:
        m["shots"] = dict(m["shots"], median=6, min=2)
    return m


def tiny_cell(workload: str) -> spec.Cell:
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    inside = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    return spec.Cell(name=workload, chips=1, config=tiny_config(w["config"]),
                     mix=tiny_mix(w["traffic"]),
                     end_to_end=[m for m in bench["end_to_end"] if inside(m)],
                     per_layer=[m for m in bench["per_layer"] if inside(m)])
