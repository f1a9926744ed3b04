"""FrameInterp 1-4 of the port against the JAX package's, on the CPU: the
classic engines colorize every n-th frame and the scene changes, and
Deep-Exemplar (``HAVC_deepex`` with ``ex_model=1`` and ``ref_freq=n``)
colors the frames between; plain, in Placebo, through
``HAVC_colorizer_fast`` and beside DeepEx's ref-merge.

The engines are tests/test_torch_deepex_surface.py's (``deepex_engines``:
nano DeOldify, micro DDColor and ColorMNet at the 40x64 work size,
Deep-Exemplar at its published width); the clip is the 12-frame 48x64
gray clip in three scenes.

Tolerance: Deep-Exemplar runs at temperature 1e-10 (a hard argmax) and
the paths end in the stabilizer's colormap (hue thresholds), so they are
held by the share of moved values: at most 2 % more than 1e-4 apart,
none more than 0.02 (tests/test_torch_exemplar_main.py's ``_close``).
VerySlow's passes bin their frames into CLAHE and ScaleAbs histograms
before the references reach Deep-Exemplar: there the references differ
by up to 3.1e-4 on 0.009 % of their values, and the WLS smoother (a global
solve along every row and column) spreads such a change over the rows and
columns it touches, so 5.9 % of the output values move by more than 1e-4
and 0.25 % by more than 1e-3.  That case is held at most 10 % more than
1e-4 apart, at most 1 % more than 1e-3, none more than 0.02.
"""
import numpy as np
import pytest

import havc_tpu

import havc_tpu_torch

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_deepex_surface import deepex_engines  # noqa: F401  (fixture)
from test_torch_exemplar_main import _close
from test_torch_exemplar_surface import (  # noqa: F401  (fixtures)
    colormnet_both, exemplar_both, gray_clip, pair, seeded_colormnet)


@pytest.mark.parametrize("kw", [
    dict(FrameInterp=2),
    dict(FrameInterp=4),
    dict(Preset="Placebo", FrameInterp=1),
    dict(Preset="VerySlow", FrameInterp=2),
    dict(FrameInterp=3, EnableDeepEx=True, DeepExRefMerge=2, ScMinFreq=1),
], ids=["frameinterp2", "frameinterp4", "placebo_frameinterp1", "veryslow_frameinterp2",
    "deepex_refmerge_frameinterp3"])
def test_havc_main_frame_interp(deepex_engines, kw):
    clip_j, clip_t = pair(gray_clip())
    want = havc_tpu.HAVC_main(clip_j, batch_size=4, **kw)
    got = havc_tpu_torch.HAVC_main(clip_t, batch_size=4, device="cpu", **kw)
    if kw.get("Preset") == "VerySlow":  # histogram bins before the references
        d = np.abs(got.frames - np.asarray(want.frames))
        assert np.mean(d > 1e-4) <= 0.10 and np.mean(d > 1e-3) <= 0.01 and d.max() <= 0.02
    else:
        _close(want, got, binned=True)
    assert float(np.abs(got.frames - got.frames.mean(-1, keepdims=True)).mean()) > 1e-3


def test_colorizer_fast_deepex(deepex_engines):
    """``frame_interp=3``: the engines on the scene changes and every 3rd
    frame, Deep-Exemplar between them."""
    clip_j, clip_t = pair(gray_clip())
    want = havc_tpu.api.HAVC_colorizer_fast(clip_j, frame_interp=3, batch_size=4)
    got = havc_tpu_torch.HAVC_colorizer_fast(clip_t, frame_interp=3, batch_size=4, device="cpu")
    _close(want, got, binned=True)
    assert np.array_equal(want.sc.sc_prev, got.sc.sc_prev)
    assert np.nonzero(got.sc.sc_prev)[0].tolist() == [0, 3, 4, 6, 8, 9]
