"""How ``correct`` is decided, at test size on the CPU: a sound program
passes; the control (the reference one precision step below the
configuration, in the program's place) and the timed path broken
underneath fail.  Each drives the rest of a run (``run_cell``) without the
look for a card.  The card test runs the control and a fault at the
cells' own size.  The cells are ``BENCHMARK.json``'s, each at the test
size of its configuration's ``tests/tiny`` file."""
from __future__ import annotations

import sys

import pytest
import torch

from bench_tiny import ROOT, read_json, tiny_cell
from harness import cell
from harness.program import Program
from harness.reference import Reference

CELLS = [w["name"] for w in read_json(f"{ROOT}/BENCHMARK.json")["workloads"]]
# the cells whose check compares scene changes
SCENE_CELLS = [w for w in CELLS if "cuts_wrong" in tiny_cell(w).config["limits"]]


class Broken:
    """The program with its output clip broken by ``fault(frames, out)``."""

    def __init__(self, program, fault):
        self.program, self.fault = program, fault

    def __call__(self, frames):
        return self.fault(frames, self.program(frames))

    def __getattr__(self, name):
        return getattr(self.program, name)


def _unchanged(frames, out):  # a step that returns its state unchanged: the input
    return out.with_frames(frames.clone())


def _half_left_out(frames, out):  # half of the frames never colorized
    half = out.frames.shape[0] // 2
    return out.with_frames(torch.cat([out.frames[:half], frames[half:]]))


def _answer_altered(frames, out):  # one frame's colours altered where produced
    y = out.frames.clone()
    y[1] = y[1].flip(-1)
    return out.with_frames(y)


def _cuts_dropped(frames, out):  # the scene changes inside a clip missed
    out.sc.sc_prev[1:] = 0
    return out


def _run(workload, factory, seed=3, trace=False):
    c = tiny_cell(workload)
    make = factory(c.config)
    return cell.run_cell(c, seed, 1.0, trace, "cpu", 0.0, program_factory=make)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_program_is_correct(workload):
    out = _run(workload, lambda cfg: lambda: Program(cfg, "cpu"))
    assert out["correct"] is True, out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {m["name"] for m in tiny_cell(workload).end_to_end}
    names = set(out["metrics"])
    assert {"peak_mem_gib", "setup_s"} <= names
    assert any(n.startswith("fps.") for n in names)
    assert any(n.startswith("clip_s_p90.") for n in names)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_layers(workload):
    """A traced run reports the cell's per-layer metrics that a CPU run
    has something for, among them every stage time per frame
    (``*_ms_per_frame*``: the spans' readers)."""
    out = _run(workload, lambda cfg: lambda: Program(cfg, "cpu"), trace=True)
    assert out["correct"] is True, out["checks"]
    names = {m["name"] for m in tiny_cell(workload).per_layer}
    assert set(out["metrics"]) <= names
    assert {n for n in names if "_ms_per_frame" in n} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    out = _run(workload, lambda cfg: lambda: Reference(cfg, "cpu", control=True))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(workload, fault):
    out = _run(workload, lambda cfg: lambda: Broken(Program(cfg, "cpu"), fault))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", SCENE_CELLS)
def test_wrong_cuts_are_not_correct(workload):
    """A scene change the program misses fails a cell that detects scenes."""
    c = tiny_cell(workload)
    c.mix["check_among"] = c.mix["pool"]
    out = cell.run_cell(c, 3, 1.0, False, "cpu", 0.0, program_factory=lambda: Broken(
        Program(c.config, "cpu"), _cuts_dropped))
    assert out["checks"]["cuts_wrong"]["value"] >= 1 and out["correct"] is False


def test_jax_loaded_after_the_window_prints_no_result(monkeypatch, capsys):
    """A module of JAX that comes in after the window (here while the
    reference checks) leaves the run without a result and exits non-zero."""
    check = cell._check

    def loads_jax(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
        return check(*args, **kwargs)

    monkeypatch.setattr(cell, "_check", loads_jax)
    out = _run(CELLS[0], lambda cfg: lambda: Program(cfg, "cpu"))
    capsys.readouterr()
    assert cell.print_result(out) != 0
    printed = capsys.readouterr()
    assert printed.out == "" and "jax" in printed.err


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_fault_fail_at_cell_size_on_card(workload):
    """On the card, at the cell's own size and load, through a run's own
    verdict: the control in the program's place, and the program with one
    frame altered where it is produced, each read ``correct`` false."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's size runs on the card")
    import time

    from harness import spec

    c = spec.load_cell(workload, ROOT)
    sides = {"control": lambda: Reference(c.config, "cuda", control=True),
             "answer altered": lambda: Broken(Program(c.config, "cuda"), _answer_altered)}
    for seed, (side, make) in zip((7, 8), sides.items()):
        out = cell.run_cell(c, seed, 1.0, False, "cuda", time.perf_counter(),
                            program_factory=make)
        print(workload, side, seed, out["checks"])
        assert out["correct"] is False, (side, out["checks"])
