"""``HAVC_main``'s ColorMNet branches outside DeepEx, port against the JAX
package on the CPU: ColorTemp (the colorized clip re-colored by
``HAVC_cmnet2`` from references at every frame, with ref-merge), and
FrameInterp 5-10 (``HAVC_colorizer_fast``: every n-th frame colorized,
ColorMNet in between), plain, in Placebo and in VerySlow.

The engines and the cut work size are tests/test_torch_exemplar_surface.py's
(``exemplar_both``); the clip is its 12-frame 48x64 gray clip in three
scenes.

Tolerance.  The paths end in the stabilizer, whose colormap (ColorFix
Magenta/Violet) tests a hue against its range edges, and VerySlow's passes
bin their frames into CLAHE and ScaleAbs histograms; a value within float
noise of such an edge moves in one package only (ROADMAP §3.2).  Paths
with such a threshold after the propagation are held as the classic
presets are (tests/test_torch_classic_presets.py): the share of values
more than 1e-4 apart at most 2 %, none more than 0.02.  The others hold
1e-4 everywhere.
"""
import numpy as np
import pytest

import havc_tpu
from havc_tpu.clip import Clip as JClip

import havc_tpu_torch

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_exemplar_surface import (  # noqa: F401  (fixtures)
    colormnet_both, exemplar_both, gray_clip, pair, seeded_colormnet)

TOL = 1e-4
BIN_SHARE, BIN_MAX = 0.02, 0.02


def _close(want, got, binned=False):
    """Within 1e-4, or (``binned``) within the bounded share of moved
    values; returns the share moved beyond 1e-4."""
    w = np.asarray(want.frames)
    assert isinstance(got.frames, np.ndarray) and got.frames.shape == w.shape
    d = np.abs(got.frames - w)
    share = float(np.mean(d > TOL))
    print(f"max {d.max():.3g}, share > {TOL}: {share:.4%}")
    if binned:
        assert share <= BIN_SHARE and d.max() <= BIN_MAX, (share, d.max())
    else:
        assert d.max() <= TOL, d.max()
    return share


@pytest.mark.parametrize("kw,binned", [
    (dict(ColorTemp="Medium"), False),
    (dict(FrameInterp=5), False),
    (dict(FrameInterp=10), False),
    (dict(Preset="Placebo", FrameInterp=5), False),
    (dict(Preset="VerySlow", ColorTemp="Low"), True),
], ids=["colortemp", "frameinterp5", "frameinterp10", "placebo_frameinterp5",
        "veryslow_colortemp"])
def test_havc_main_matches_jax(exemplar_both, kw, binned):
    frames = gray_clip()
    want = havc_tpu.HAVC_main(JClip(frames=frames.copy()), batch_size=4, **kw)
    got = havc_tpu_torch.HAVC_main(havc_tpu_torch.Clip(frames=frames.copy()), batch_size=4,
                                   device="cpu", **kw)
    _close(want, got, binned)
    assert float(np.abs(got.frames - got.frames.mean(-1, keepdims=True)).mean()) > 1e-3


def test_colorizer_fast_matches_jax(exemplar_both):
    """The classic engines on the scene changes and every 6th frame, ColorMNet
    in between (``sc_min_freq`` is the legacy name of ``frame_interp``)."""
    clip_j, clip_t = pair(gray_clip())
    want = havc_tpu.api.HAVC_colorizer_fast(clip_j, sc_min_freq=6, batch_size=4)
    got = havc_tpu_torch.HAVC_colorizer_fast(clip_t, sc_min_freq=6, batch_size=4, device="cpu")
    _close(want, got)
    assert np.array_equal(want.sc.sc_prev, got.sc.sc_prev)
    assert np.nonzero(got.sc.sc_prev)[0].tolist() == [0, 4, 6, 8]


def test_deepex_with_colortemp_matches_jax(exemplar_both):
    """DeepEx with ColorTemp: the references are re-colored by ColorMNet
    before the propagation (``ScMinFreq`` forced to 1)."""
    frames = gray_clip()
    kw = dict(EnableDeepEx=True, ColorTemp="High", batch_size=4)
    want = havc_tpu.HAVC_main(JClip(frames=frames.copy()), **kw)
    got = havc_tpu_torch.HAVC_main(havc_tpu_torch.Clip(frames=frames.copy()), device="cpu", **kw)
    _close(want, got)
