"""The Deep-Exemplar, DeepRemaster and hybrid entry points of the port
against the JAX package's, on the CPU: ``HAVC_deepex`` and
``HAVC_restore_video`` with ``ex_model`` 1/2/3, ``HAVC_main`` with
``DeepExModel`` 1/2/3 and the DeepRemaster folder path (method 3),
``HAVC_main_restore`` with DeepEx.

The engines are tests/test_torch_exemplar_surface.py's (``exemplar_both``:
micro ColorMNet, nano DeOldify, micro DDColor, every SmartResize size cut
to 40x64) plus Deep-Exemplar and NetworkC at their published widths
(tests/test_torch_deepex.py's and tests/test_torch_remaster.py's seeded
trees, ``deepex_engines``).  DeepRemaster's /16 work geometry is cut to
32x48 in both packages.  The clips are 12 frames of 48x64 in three scenes.

Tolerance.  DeepEx runs at its temperature 1e-10, a hard argmax
over the correspondences, where a near tie flips on summation order
(tests/test_torch_deepex.py), and ``HAVC_main`` ends in the stabilizer's
colormap, whose hue ranges are thresholds (ROADMAP §3.2).  Those paths are
held as tests/test_torch_exemplar_main.py holds its thresholded ones: at
most 2 % of the values more than 1e-4 apart, none more than 0.02.
DeepRemaster and ColorMNet through ``HAVC_deepex``/``HAVC_restore_video``
hold 1e-4 everywhere.
"""
import numpy as np
import pytest
import torch

import havc_tpu
from havc_tpu import exemplar as jex

import havc_tpu_torch
import havc_tpu_torch.engines as tengines
from havc_tpu_torch import exemplar as tex

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_deepex import JaxDeepEx, deepex_net, deepex_trees
from test_torch_exemplar_main import _close
from test_torch_exemplar_surface import (  # noqa: F401  (fixtures)
    WORK, colored_clip, colormnet_both, exemplar_both, gray_clip, pair, seeded_colormnet)
from test_torch_remaster import JaxRemaster, remaster_net, remaster_tree

CPU = torch.device("cpu")
RM_WORK = (32, 48)  # DeepRemaster's work size in these tests (both sides /16)


@pytest.fixture(scope="module")
def deepex_engines(exemplar_both):
    """``exemplar_both`` and the seeded Deep-Exemplar and NetworkC in both
    packages, DeepRemaster's geometry cut to ``RM_WORK``."""
    dtrees, rtree = deepex_trees(*WORK), remaster_tree()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jex, "DeepExEngine", lambda speed="medium", seed=0: JaxDeepEx(dtrees, speed))
        mp.setattr(jex, "RemasterEngine", lambda **kw: JaxRemaster(rtree, **kw))
        mp.setitem(tengines.registry._cache, ("deepex", "full", CPU), deepex_net(dtrees))
        mp.setitem(tengines.registry._cache, ("remaster", "full", CPU), remaster_net(rtree))
        for mod in (jex, tex):
            mp.setattr(mod, "remaster_work_shape",
                       lambda width, height, frame_mindim=320: RM_WORK)
        yield


def flags_every(n):
    """References at frames 0, 4, 8 (the scene changes) as scene flags."""
    return lambda cls: cls.from_frame_list(len(gray_clip()), list(range(0, 12, n)))


# --- HAVC_deepex / HAVC_restore_video --------------------------------------------------


@pytest.mark.parametrize("ex_model,kw,binned", [
    (1, dict(), True),
    (1, dict(method=2, render_vivid=False), True),
    (2, dict(), False),
    (2, dict(max_memory_frames=2, render_vivid=False), False),
    (3, dict(ref_merge=2), True),
], ids=["deepex", "deepex_method2", "remaster_vivid", "remaster_buffer2", "hybrid_refmerge2"])
def test_havc_deepex(deepex_engines, ex_model, kw, binned):
    """Method 0 (or 2) from HAVC references at the scene changes; the
    hybrid with ref-merge 2 takes references at every frame."""
    clip_j, clip_t = pair(gray_clip())
    flags = (lambda cls: cls.every(12, 1)) if kw.get("ref_merge") else flags_every(4)
    ref_j, ref_t = pair(colored_clip(), flags)
    want = jex.HAVC_deepex(clip_j, ref_j, ex_model=ex_model, **kw)
    got = havc_tpu_torch.HAVC_deepex(clip_t, ref_t, ex_model=ex_model, device="cpu", **kw)
    _close(want, got, binned)


@pytest.mark.parametrize("ex_model,method", [(1, 6), (2, 6), (2, 5)],
                         ids=["deepex", "remaster", "remaster_method5"])
def test_havc_restore_video(deepex_engines, ex_model, method):
    """The colored clip's own scene changes (DeepRemaster: and every 10th
    frame) as references."""
    clip_j, clip_t = pair(gray_clip())
    ref_j, ref_t = pair(colored_clip())
    want = jex.HAVC_restore_video(clip_j, ref_j, method=method, ex_model=ex_model)
    got = havc_tpu_torch.HAVC_restore_video(clip_t, ref_t, method=method, ex_model=ex_model,
                                            device="cpu")
    _close(want, got, binned=ex_model == 1)
    assert np.array_equal(want.sc.sc_prev, got.sc.sc_prev)


# --- HAVC_main ------------------------------------------------------------------------


@pytest.mark.parametrize("model", [1, 2, 3], ids=["deepex", "remaster", "hybrid"])
def test_havc_main_deepex_model(deepex_engines, model):
    """``HAVC_main(EnableDeepEx=True, DeepExModel=...)``: the classic engines
    colorize the scene changes, the engine propagates, the fast
    stabilizer."""
    clip_j, clip_t = pair(gray_clip())
    want = havc_tpu.HAVC_main(clip_j, EnableDeepEx=True, DeepExModel=model, batch_size=4)
    got = havc_tpu_torch.HAVC_main(clip_t, EnableDeepEx=True, DeepExModel=model, batch_size=4,
                                   device="cpu")
    _close(want, got, binned=True)
    assert np.array_equal(want.sc.sc_prev, got.sc.sc_prev)


def test_havc_main_remaster_folder(deepex_engines, tmp_path):
    """``DeepExMethod=3`` with ``DeepExModel=2``: ``HAVC_DeepRemaster`` reads
    the reference directory itself (mode 0)."""
    refdir = str(tmp_path / "refs")
    colored = colored_clip(seed=9)
    havc_tpu_torch.io.export_reference_frames(
        havc_tpu_torch.Clip(frames=colored).with_sc(
            havc_tpu_torch.SceneFlags.from_frame_list(12, [0, 4, 8])), refdir, ext="png")
    clip_j, clip_t = pair(gray_clip())
    kw = dict(EnableDeepEx=True, DeepExMethod=3, DeepExModel=2, ScFrameDir=refdir)
    want = havc_tpu.HAVC_main(clip_j, **kw)
    got = havc_tpu_torch.HAVC_main(clip_t, device="cpu", **kw)
    _close(want, got)


def test_main_restore_deepex(deepex_engines):
    """``HAVC_main_restore(clip_colored=..., DeepExModel=1)``: the DeepEx
    re-color, then the light adjust and tweak."""
    clip_j, clip_t = pair(gray_clip())
    ref_j, ref_t = pair(colored_clip())
    want = havc_tpu.api.HAVC_main_restore(clip_j, ref_j, DeepExModel=1)
    got = havc_tpu_torch.HAVC_main_restore(clip_t, ref_t, DeepExModel=1, device="cpu")
    _close(want, got, binned=True)
