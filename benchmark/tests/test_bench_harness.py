"""CPU tests of the benchmark's harness: traffic, window arithmetic, the
yardstick's byte and FLOP counts and seeded weights, discovery by name
(a cell, its reference and its test size as new files only), and what
its processes import."""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import zlib
from statistics import NormalDist

import pytest
import torch

from bench_tiny import BENCH, ROOT, read_json, tiny_cell, tiny_config, tiny_mix
from harness import cell, flops, spec, trace, traffic, weights
from harness.reference import Reference

FILM = read_json(os.path.join(BENCH, "traffic", "film-1080p.json"))


# --- traffic ------------------------------------------------------------------


@pytest.mark.parametrize("mix", ["clips-1080p", "film-1080p"])
def test_pool_is_deterministic_per_seed(mix):
    m = tiny_mix(mix)
    a, b = traffic.make_pool(m, 2**31 + 11, "cpu"), traffic.make_pool(m, 2**31 + 11, "cpu")
    c = traffic.make_pool(m, 7, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.clips, b.clips)) and a.cuts == b.cuts
    assert not all(torch.equal(x, y) for x, y in zip(a.clips, c.clips))
    assert a.clips[0].dtype == torch.uint8 and a.clips[0].shape == (4, 64, 96)


def test_film_shots_same_set_every_seed():
    """The pool's shot lengths are one set in a seed's order: the
    log-normal's quantiles scaled to the pool, the same number of cuts,
    each inside a clip (moved a frame at most)."""
    n, shots = FILM["frames"] * FILM["pool"], FILM["shots"]
    k = round(n / shots["median"])
    q = [shots["median"] * math.exp(shots["sigma"] * NormalDist().inv_cdf((i + 0.5) / k))
         for i in range(k)]
    want = [x * n / sum(q) for x in q]
    for seed in range(40):
        order = torch.randperm(k, generator=torch.Generator().manual_seed(seed))
        lengths = traffic.shot_lengths(n, shots, FILM["frames"], order)
        assert sum(lengths) == n and len(lengths) == k
        starts = [sum(lengths[:j]) for j in range(1, k)]
        assert all(s % FILM["frames"] for s in starts)  # never a clip's first frame
        assert all(abs(a - b) <= 2.5 for a, b in zip(sorted(lengths), sorted(want)))


def test_film_cuts_are_references():
    m = tiny_mix("film-1080p")
    pool = traffic.make_pool(m, 3, "cpu")
    film = torch.cat(pool.clips).float()
    jumps = (film[1:] - film[:-1]).abs().mean(dim=(1, 2))
    cuts = {c * m["frames"] + f for c, cs in enumerate(pool.cuts) for f in cs if f}
    assert cuts and all(jumps[f - 1] > 3 * jumps.median() for f in cuts)
    assert sum(pool.refs(i) for i in range(m["pool"])) == m["pool"] + len(cuts)


def test_as_rgb():
    y = torch.tensor([[[0, 255], [51, 102]]], dtype=torch.uint8)
    x = traffic.as_rgb(y)
    assert x.shape == (1, 2, 2, 3) and x.dtype == torch.float32 and x.is_contiguous()
    assert torch.equal(x[..., 0], x[..., 2]) and x[0, 0, 1, 1] == 1.0


# --- window arithmetic --------------------------------------------------------


class _Clock:
    def __init__(self, durations):
        self.t, self.durations = 0.0, list(durations)

    def __call__(self):
        return self.t


def test_window_rate_and_p90(monkeypatch):
    """fps is every frame completed over the whole window (first hand-off
    to last output); the p90 is over every clip's time."""
    durations = [0.5, 0.25, 0.25, 1.0, 0.25]
    clock = _Clock(durations)

    class Prog:
        def __call__(self, frames):
            clock.t += clock.durations.pop(0)
            return type("Out", (), {"sc": None, "frames": frames})()

    monkeypatch.setattr(cell.time, "perf_counter", clock)
    pool = traffic.Pool([torch.zeros((4, 2, 2), dtype=torch.uint8)] * 3, [[0]] * 3)
    loop = cell._Loop(Prog(), pool, torch.device("cpu"), keep=[1])
    window_s = loop.run_for(2.1)
    assert loop.i == 5 and window_s == 2.25 and loop.frames == 20
    assert loop.frames / window_s == pytest.approx(20 / 2.25)
    assert cell.p90(loop.times) == statistics.quantiles(durations, n=10, method="inclusive")[-1]
    assert list(loop.kept) == [1] and loop.kept[1][0] == 1


def test_idle_union_and_gaps():
    assert trace.union_s([(0.0, 1.0), (0.5, 1.5), (2.0, 3.0)]) == 2.5
    gaps = trace.idle_gaps([(1.0, 2.0), (3.0, 4.0)], [("aten::copy_", 2.0, 2.8)], 0.0, 5.0)
    assert gaps == {"host idle": 2.0, "aten::copy_": 1.0}


# --- the yardstick ------------------------------------------------------------


def test_kernel_bytes_match_the_kernel_table():
    assert flops.post_chain_bytes(24, 384, 384) == 84_934_656
    assert flops.post_chain_bytes(16, 384, 384) == 56_623_104
    assert flops.window_attn_bytes(1, 14, 28, 64, 1024) == 2_685_200
    assert flops.window_attn_bytes(6, 14, 28, 64, 1024) == 16_111_200
    assert flops.window_attn_ops(1, 14, 28, 64, 1024) == 236_780_544
    assert flops.roofline_s(2_685_200, 236_780_544) == pytest.approx(0.000802e-3, rel=1e-3)


def test_flop_count_at_a_tiny_shape():
    """FlopCounterMode through the reference's hooks: a 3x3 conv, 2 C_in
    C_out k^2 H W per frame, and a linear layer."""
    from harness.reference import _FlopHooks

    conv = torch.nn.Conv2d(4, 8, 3, padding=1)
    lin = torch.nn.Linear(16, 5)
    counter = _FlopHooks([conv, lin])
    with torch.no_grad():
        conv(torch.zeros(2, 4, 6, 7))
        lin(torch.zeros(3, 16))
    assert counter.flops == 2 * (2 * 4 * 8 * 9 * 6 * 7) + 2 * 3 * 16 * 5


def test_weights_seeded_and_strict():
    spec_ = dict(family="ddcolor", name="artistic", module="ddcolor", **{"class": "DDColor"},
                 args=dict(encoder="micro", dim=64, num_queries=16, num_blocks=3,
                           unet_out=[64, 64, 32], heads=8, ffn_dim=128), params=1523944)
    a = weights.make_state(spec_, 5, "cpu", "havc_ref")
    b = weights.make_state(spec_, 5, "cpu", "havc_ref")
    assert all(torch.equal(a[k], b[k]) for k in a)
    m = weights.build_engine(spec_, a, "havc_tpu_torch")
    assert weights.param_count(m) == 1523944
    k = next(k for k in a if k.endswith("weight") and a[k].dim() == 4)
    fan_in = a[k][0].numel()
    assert float(a[k].std()) == pytest.approx(fan_in ** -0.5, rel=0.15)
    with pytest.raises(ValueError):
        weights.build_engine(dict(spec_, params=1), a, "havc_ref")


# --- discovery by name --------------------------------------------------------


_NEW_REFERENCE = '''"""A test configuration's reference: the pipeline's ``havc_main``,
its calls counted."""
from . import pipeline

calls = 0


def havc_main(clip, *, dtypes, **havc_main):
    global calls
    calls += 1
    return pipeline.havc_main(clip, dtypes=dtypes, **havc_main)
'''


def test_new_config_mix_and_metric_are_files(tmp_path, monkeypatch):
    """A cell added as new files only, named in BENCHMARK.json: a
    configuration that names a new reference module, that module, the
    configuration's test size, a mix and a metric reader.  It runs without
    any other edit; the sound program reads ``correct`` true, the control
    in its place false."""
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = read_json(os.path.join(BENCH, "configs", "main-video-artistic.json"))
    cfg.update(name="main-test-tiny", reference="new_reference")
    tiny = read_json(os.path.join(BENCH, "tests", "tiny", "main-video-artistic.json"))
    mix = dict(read_json(os.path.join(BENCH, "traffic", "clips-1080p.json")), name="tiny-clips")
    root = tmp_path / "checkout"
    files = {"benchmark/configs/main-test-tiny.json": json.dumps(cfg),
             "benchmark/reference/havc_ref/new_reference.py": _NEW_REFERENCE,
             "benchmark/tests/tiny/main-test-tiny.json": json.dumps(tiny),
             "benchmark/traffic/tiny-clips.json": json.dumps(mix),
             "benchmark/metrics/clips_in_window.py":
                 "def read(ctx):\n    return float(ctx.profiled['clips'] + ctx.timed['clips'])\n"}
    for path, text in files.items():
        (root / path).parent.mkdir(parents=True, exist_ok=True)
        (root / path).write_text(text)
    bench["workloads"].append(dict(name="test.tiny", config="main-test-tiny",
                                   traffic="tiny-clips", chips=1, why="a test"))
    bench["per_layer"].append(dict(name="clips_in_window", unit="clips", better="higher",
                                   source="program_counter", layer="entry", moves="setup_s",
                                   workloads=["test.tiny"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    import havc_ref

    monkeypatch.setattr(spec, "bench_dir", lambda: str(root / "benchmark"))
    monkeypatch.setattr(havc_ref, "__path__",
                        [*havc_ref.__path__, str(root / "benchmark" / "reference" / "havc_ref")])
    try:
        c = spec.load_cell("test.tiny", str(root))
        assert c.config["reference"] == "new_reference" and c.mix["name"] == "tiny-clips"
        assert [m["name"] for m in c.per_layer] == ["clips_in_window"]
        c = tiny_cell("test.tiny", str(root))
        assert [e["params"] for e in c.config["engines"]] == [e["params"] for e in tiny["engines"]]
        out = cell.run_cell(c, 4, 1.0, True, "cpu", 0.0)
        assert out["correct"] is True, out["checks"]
        assert out["metrics"]["clips_in_window"]["value"] >= 2
        assert sys.modules["havc_ref.new_reference"].calls == 2  # the two sampled clips
        control = cell.run_cell(c, 4, 1.0, False, "cpu", 0.0, program_factory=lambda: Reference(
            c.config, "cpu", control=True))
        assert control["correct"] is False, control["checks"]
    finally:
        sys.modules.pop("havc_ref.new_reference", None)


def test_reference_rejects_what_it_does_not_run():
    """The pipeline raises on a ``HAVC_main`` keyword it does not implement,
    and on a dtype for an engine it does not run or cannot run in."""
    from havc_ref import pipeline
    from havc_ref.clip import Clip

    clip = Clip(frames=torch.zeros(2, 8, 8, 3))
    with pytest.raises(TypeError):
        pipeline.havc_main(clip, dtypes={}, Preset="Fast")
    for dtypes in ({"deoldify": torch.bfloat16}, {"deepex": torch.float32}):
        with pytest.raises(ValueError):
            pipeline.havc_main(clip, dtypes=dtypes)


def test_hooks_go_where_calls_says():
    from harness.reference import _hooked

    net = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.Linear(3, 1))
    assert _hooked(net, "whole") == [net] and _hooked(net, "parts") == list(net)
    with pytest.raises(ValueError):
        _hooked(net, "children")


def test_deepex_prelu_slopes_have_a_rule():
    """The port's Deep-Exemplar at its published widths: its 11 PReLU
    slopes take their own leaf rule, PyTorch's 0.25."""
    dx = dict(family="deepex", name="full", module="deepex", args={}, params=55_024_269,
              **{"class": "DeepEx"})
    state = weights.make_state(dx, 1406, "cpu", "havc_tpu_torch")
    assert weights.param_count(weights.build_engine(dx, state, "havc_tpu_torch")) == 55_024_269
    slopes = [v for k, v in state.items() if k.rsplit(".", 1)[-1] == "prelu"]
    assert len(slopes) == 11 and all(torch.equal(v, torch.full((1,), 0.25)) for v in slopes)


def test_leaf_without_a_rule_raises_naming_it():
    with pytest.raises(ValueError, match="'alpha'"):
        weights._rule("block.act.alpha", (1,))


@pytest.mark.parametrize("config", ["main-video-artistic", "exemplar-colormnet"])
def test_tiny_states_are_pinned(config):
    """Both configurations' engines at test size draw, key by key, the
    weights pinned in ``tiny_states.json``."""
    pinned = read_json(os.path.join(BENCH, "tests", "tiny_states.json"))
    c = tiny_config(config)
    assert c["weight_seed"] == pinned["weight_seed"]
    for e in c["engines"]:
        want = pinned["engines"][f"{e['family']}.{e['name']}"]
        state = weights.make_state(e, c["weight_seed"], "cpu", "havc_ref")
        got = {k: f"{zlib.crc32(v.contiguous().numpy().tobytes()):08x}" for k, v in state.items()}
        assert sorted(got) == sorted(want)
        assert [k for k in want if got[k] != want[k]] == []


def test_split_metric_reads_its_quantity():
    """``<quantity>.<family>`` without a file of its own is read by the
    quantity's reader."""
    assert spec.load_reader("mfu_pct.main").__code__.co_filename.endswith("/metrics/mfu_pct.py")
    ctx = type("Ctx", (), {"stages": {"deoldify": 0.2, "ddcolor": 0.1},
                           "timed": {"frames": 30, "refs": 3},
                           "config": tiny_cell("main.clips-1080p").config})()
    assert spec.load_reader("engines_ms_per_frame.main")(ctx) == pytest.approx(10.0)


# --- imports ------------------------------------------------------------------

_PROBE = """
import sys
sys.path[:0] = {paths!r}
{imports}
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'havc_tpu'))
port = sorted(m for m in sys.modules if m.split('.')[0] == 'havc_tpu_torch')
print(repr((bad, port)))
"""


def _probe(imports: str):
    paths = [BENCH, os.path.join(BENCH, "reference"), ROOT]
    code = _PROBE.format(paths=paths, imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    bad, port = _probe("import harness.cell, harness.program, harness.reference\n"
                       "from harness.program import Program\n"
                       "import importlib; importlib.import_module('havc_tpu_torch')\n"
                       "import havc_tpu_torch.exemplar, havc_tpu_torch.api")
    assert bad == [] and "havc_tpu_torch" in port


def test_reference_loads_nothing_of_the_port():
    bad, port = _probe("import havc_ref.pipeline, havc_ref.engines")
    assert bad == [] and port == []


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("havc_tpu_torch_fake_probe", type(sys)("havc_tpu_torch_fake_probe"))
    try:
        assert "havc_tpu_torch_fake_probe" not in cell.forbidden_modules()
    finally:
        del sys.modules["havc_tpu_torch_fake_probe"]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this test is for a machine without CUDA")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "main.clips-1080p", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
