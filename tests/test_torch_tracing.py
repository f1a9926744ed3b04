"""The port's stage spans and counters (``havc_tpu_torch.utils.profiling``):
spans that cost two flag reads when off, operator ranges named
``havc.<stage>`` under ``torch.profiler``, stage timing on CUDA events
that never waits for the card, and the counter registry (host syncs,
``HAVC_main`` calls, kernel launches).

The CPU tests run ``HAVC_main`` on both benchmarked configurations
(its defaults, and ``EnableDeepEx=True``) with tiny engines (nano
DeOldify Video, micro DDColor Artistic, micro ColorMNet, PyTorch's
default initialisation) on 8-frame 64x96 gray clips.  The card tests
(``-m cuda``) hold what only a card shows: a span adds no device event
to a trace, raises nothing under ``set_sync_debug_mode("error")``, and
``host_syncs`` counts what ``set_sync_debug_mode("warn")`` reports.
"""
import logging
import warnings

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import havc_tpu_torch
from havc_tpu_torch import engines, exemplar
from havc_tpu_torch.models import colormnet as tcm
from havc_tpu_torch.models import ddcolor as tdd
from havc_tpu_torch.models import deoldify as tdo
from havc_tpu_torch.utils import profiling

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

# the benchmark's two configurations (benchmark/configs/*.json), the
# exemplar's engine cut to the micro ColorMNet
CONFIGS = {"main": {}, "exemplar": {"EnableDeepEx": True, "engine_config": "micro"}}
# the stages each configuration's path must show as top-level spans
TOP_STAGES = {"main": {"deoldify", "ddcolor", "merge", "chroma_restore", "post_chain"},
              "exemplar": {"deoldify", "ddcolor", "scene_detect", "sc_gather", "sc_scatter",
                           "cm_key_encoder", "cm_frame_loop", "cm_restore"}}


@pytest.fixture(autouse=True)
def _tracing_off():
    profiling.enable_profiling(False)
    profiling.reset_stages()
    yield
    profiling.enable_profiling(False)
    profiling.set_debug_timing(False)
    havc_tpu_torch.HAVC_set_debug_level(0)
    profiling.reset_stages()


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def tiny_engines(mp, dev: torch.device):
    """The registry's DeOldify Video, DDColor Artistic and micro ColorMNet
    on ``dev`` replaced by tiny seeded ones, the classic engines at render
    factor 4 (64x64) and ColorMNet at 48x64, for ``mp``'s lifetime."""
    torch.manual_seed(0)
    mods = {("deoldify", "video"): tdo.DeOldifyWide(encoder="nano", nf_factor=1),
            ("ddcolor", "artistic"): tdd.DDColor.from_config("micro"),
            ("colormnet", "micro"): tcm.ColorMNet("micro")}
    for (family, name), m in mods.items():
        mp.setitem(engines.registry._cache, (family, name, dev),
                   m.to(dev).eval().requires_grad_(False))
    mp.setattr(exemplar, "_ENGINE_CACHE", {})
    mp.setattr(exemplar, "smart_resize_shape", lambda width, height, speed="medium": (48, 64))
    do_fn, dd_fn = engines.make_deoldify_fn, engines.make_ddcolor_fn
    mp.setattr(engines, "make_deoldify_fn",
               lambda model=0, render_factor=24, **kw: do_fn(model, 4, **kw))
    mp.setattr(engines, "make_ddcolor_fn",
               lambda model=1, render_factor=24, **kw: dd_fn(model, 4, **kw))


def gray_clip(dev, t: int = 8, h: int = 64, w: int = 96) -> torch.Tensor:
    """``t`` gray RGB frames in two scenes (a cut at ``t // 2``), each a
    smooth seeded field drifting a pixel a frame."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for s in range(2):
        a, b, c = rng.uniform(0.5, 3.0, 3)
        for i in range(t // 2):
            f = 0.45 + 0.3 * np.sin((xx + i) / (7 * a) + c) * np.cos(yy / (5 * b))
            frames.append(np.repeat(f[..., None], 3, axis=-1))
    return torch.from_numpy(np.stack(frames).astype(np.float32)).to(dev)


def run_main(config: str, dev, frames=None, **kw):
    frames = gray_clip(dev) if frames is None else frames
    return havc_tpu_torch.HAVC_main(havc_tpu_torch.Clip(frames=frames), batch_size=4,
                                    device=dev, **CONFIGS[config], **kw)


@pytest.fixture(scope="module")
def cpu_engines():
    with pytest.MonkeyPatch.context() as mp:
        tiny_engines(mp, torch.device("cpu"))
        yield


# --- spans -----------------------------------------------------------------------


def test_off_span_records_nothing_and_is_shared():
    """Off, a span is one shared no-op context: nothing timed, nothing in
    a profile started inside it."""
    assert not profiling.profiling_enabled()
    assert profiling.stage_timer("a") is profiling.stage_timer("b")
    with profiling.stage_timer("a"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(4).add_(1)
    assert profiling.stage_times() == {} and profiling.stage_spans() == []
    assert not [e for e in prof.events() if e.name.startswith("havc.")]


def test_profiler_spans_are_operator_ranges():
    """Under a profiler a span is a top-level host range ``havc.<stage>``
    (not a user annotation) whose children are its ATen operators; a span
    opened inside another is that span's child."""
    x = torch.randn(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage_timer("outer"):
            y = x @ x
            with profiling.stage_timer("inner"):
                y.add_(1)
        with profiling.stage_timer("after"):
            y.mul_(2)
    ev = {e.name: e for e in prof.events() if e.name.startswith("havc.")}
    assert set(ev) == {"havc.outer", "havc.inner", "havc.after"}
    assert all(not e.is_user_annotation and e.device_type == DeviceType.CPU
               for e in ev.values())
    assert ev["havc.outer"].cpu_parent is None and ev["havc.after"].cpu_parent is None
    assert ev["havc.inner"].cpu_parent.name == "havc.outer"
    kids = {c.name for c in ev["havc.outer"].cpu_children}
    assert "aten::matmul" in kids and "havc.inner" in kids
    assert {c.name for c in ev["havc.inner"].cpu_children} == {"aten::add_"}
    assert profiling.stage_times() == {}  # the profiler alone times nothing


def test_stage_timing_accumulates_with_parents_and_clips():
    """On the CPU a span's device seconds are its host seconds; calls,
    parents and the ``HAVC_main`` call index are kept; self time is the
    stage less its children; ``reset_stages`` leaves the counters and
    ``reset_counters`` clears them."""
    profiling.enable_profiling(True)
    profiling.reset_counters()
    with profiling.clip_scope() as k:
        for _ in range(3):
            with profiling.stage_timer("outer"):
                with profiling.stage_timer("inner"):
                    torch.ones(1000).sum()
    with profiling.stage_timer("outer"):
        pass
    t = profiling.stage_times()
    assert set(t) == {"outer", "inner"}
    assert t["outer"][1] == 4 and t["inner"][1] == 3
    assert all(v[0] == v[2] > 0 for v in t.values())
    assert t["outer"][0] >= t["inner"][0]
    spans = profiling.stage_spans()
    assert [s[:3] for s in spans[:2]] == [("inner", "outer", k), ("outer", None, k)]
    assert spans[-1][:3] == ("outer", None, None)
    assert profiling.counters()["clips"] == 1
    rep = profiling.stage_report()
    assert "self_ms" in rep and "counters: clips 1" in rep
    self_ms = float(next(r for r in rep.splitlines() if r.startswith("outer")).split()[3])
    assert self_ms == pytest.approx(1e3 * (t["outer"][0] - t["inner"][0]), abs=2e-3)
    profiling.count("host_syncs", 2)
    profiling.reset_stages()
    assert profiling.stage_times() == {} and profiling.stage_spans() == []
    assert profiling.counters() == {"clips": 1, "host_syncs": 2}
    profiling.reset_counters("clips")
    assert profiling.counters() == {"host_syncs": 2}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_debug_level_switches_stage_timing():
    havc_tpu_torch.HAVC_set_debug_level(1)
    assert profiling.profiling_enabled()
    havc_tpu_torch.HAVC_set_debug_level(0)
    assert not profiling.profiling_enabled()
    profiling.enable_profiling(True)
    havc_tpu_torch.HAVC_set_debug_level(0)  # the two switches are apart
    assert profiling.profiling_enabled()


def test_host_read_counts_each_copy():
    profiling.reset_counters("host_syncs")
    a = profiling.host_read(torch.arange(3))
    assert isinstance(a, np.ndarray) and a.tolist() == [0, 1, 2]
    assert profiling.counters()["host_syncs"] == 1


# --- HAVC_main on the benchmarked configurations ---------------------------------------


@pytest.mark.parametrize("config", ["main", "exemplar"])
def test_benchmarked_paths_spans_are_top_level(cpu_engines, config):
    """Every ``havc.*`` span of both configurations' paths is a top-level
    host event (what the benchmark's ``Trace.host`` keeps); the engines'
    and the ColorMNet loop's among them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_main(config, torch.device("cpu"))
    spans = [e for e in prof.events() if e.name.startswith("havc.")]
    assert spans and all(e.cpu_parent is None for e in spans)
    names = {e.name[len("havc."):] for e in spans}
    assert TOP_STAGES[config] <= names, TOP_STAGES[config] - names
    assert "colorizer" not in names


@pytest.mark.parametrize("config,syncs", [("main", 0), ("exemplar", 4)])
def test_host_syncs_over_tiny_havc_main(cpu_engines, config, syncs):
    """The copies that wait for the card in one call: none on the main
    path; on the exemplar path the scene detector's one copy of its
    statistics to the host, and the scene flags (numpy from there on)
    uploaded by the chroma stabilizer and both deflickers.  A clip handed
    as numpy adds the copy of the output back."""
    cpu = torch.device("cpu")
    profiling.reset_counters()
    run_main(config, cpu)
    assert profiling.counters().get("host_syncs", 0) == syncs
    assert profiling.counters()["clips"] == 1
    havc_tpu_torch.HAVC_main(havc_tpu_torch.Clip(frames=gray_clip(cpu).numpy()), batch_size=4,
                             device=cpu, **CONFIGS[config])
    assert profiling.counters()["host_syncs"] == 2 * syncs + 1
    assert profiling.counters()["clips"] == 2


def test_debug_level_logs_the_stage_table(cpu_engines, caplog):
    """At debug level 1 every ``HAVC_main`` call logs its own stages (device,
    host and self ms, calls) and the counters."""
    cpu = torch.device("cpu")
    with caplog.at_level(logging.INFO, logger="havc_tpu_torch"):
        run_main("exemplar", cpu, debug_level=1)
        run_main("exemplar", cpu, debug_level=1)
    reports = [r.getMessage() for r in caplog.records if "HAVC_main call" in r.getMessage()]
    assert len(reports) == 2
    for rep in reports:
        rows = {line.split()[0]: line.split()[1:] for line in rep.splitlines()[2:]}
        assert rows["cm_frame_loop"][3] == "1" and rows["deoldify"][3] == "1"
        assert "host_syncs" in rep.splitlines()[-1]
    run_main("exemplar", cpu)  # debug level 0 again: nothing logged, no timing
    assert not profiling.profiling_enabled()
    assert len([r for r in caplog.records if "HAVC_main call" in r.getMessage()]) == 2


# --- on the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_span_adds_no_device_event():
    """The same work traced with and without spans gives the same device
    events (a user annotation would add a ``gpu_user_annotation`` one)."""
    _need_cuda()
    x = torch.randn(8, 16, 64, 64, device="cuda")
    conv = torch.nn.Conv2d(16, 16, 3, padding=1).cuda()

    def work(spans: bool):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                with profiling.stage_timer(f"s{i}") if spans else profiling._OFF:
                    conv(x).relu_()
            torch.cuda.synchronize()
        return prof.events()

    work(False)  # cuDNN's choice made before either trace
    plain, spanned = work(False), work(True)
    dev = lambda evs: sorted(e.name for e in evs if e.device_type == DeviceType.CUDA)  # noqa: E731
    assert dev(plain) == dev(spanned) and dev(plain)
    assert len([e for e in spanned if e.name.startswith("havc.")]) == 3
    assert not [e for e in spanned if e.name.startswith("havc.")
                and e.device_type != DeviceType.CPU]


@pytest.mark.cuda
def test_span_never_waits_for_the_card():
    """Stage timing, with a profiler recording too, around queued work:
    nothing synchronizes (``set_sync_debug_mode("error")`` raises on a
    sync); the times are read after, and the stream time of a span is
    at least its kernels'."""
    _need_cuda()
    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    profiling.enable_profiling(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(20):
                with profiling.stage_timer("queued"):
                    with profiling.stage_timer("mm"):
                        y = x @ x
                    y.relu_()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    t = profiling.stage_times()
    assert t["queued"][1] == 20 and t["mm"][1] == 20
    assert t["queued"][0] >= t["mm"][0] > 0
    assert not profiling._REG.pending


def _sync_warnings(run):
    """(the syncs PyTorch's sync debug mode reports in ``run()``, their sites)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return len(sites), sites


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["main", "exemplar"])
def test_host_syncs_match_sync_debug_mode_on_card(config):
    """``host_syncs`` over one warm ``HAVC_main`` of each configuration
    equals the syncs the sync debug mode reports."""
    _need_cuda()
    dev = torch.device("cuda", torch.cuda.current_device())
    with pytest.MonkeyPatch.context() as mp:
        tiny_engines(mp, dev)
        frames = gray_clip(dev)
        run_main(config, dev, frames)  # the first call builds the cached resize matrices
        torch.cuda.synchronize()
        before = profiling.counters().get("host_syncs", 0)
        n, sites = _sync_warnings(lambda: run_main(config, dev, frames))
        counted = profiling.counters().get("host_syncs", 0) - before
    assert counted == n, sites
    assert n == {"main": 0, "exemplar": 4}[config], sites
