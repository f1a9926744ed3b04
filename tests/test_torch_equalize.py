"""The port's equalizers (``havc_tpu_torch.ops.equalize``) against
``havc_tpu.ops.equalize`` on the CPU.

Inputs are seeded numpy images: a mid-gray, a dark (mean luma < 0.15,
gated off) and a bright frame, at sizes that are and are not multiples of
the CLAHE grid.  Histograms must be exactly equal; everything else within
1e-5 max abs (float32 sums in another order: the clip-limited CLAHE cdf,
the frame means).  No discrete decision sits near a threshold on these
inputs: the frames' mean lumas are far from the gates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havc_tpu.ops import equalize as jeq
from havc_tpu.ops import merge as jmerge
from havc_tpu_torch.ops import equalize as teq
from havc_tpu_torch.ops import merge as tmerge

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

TOL = 1e-5


def _frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    mid = rng.random((1, h, w, 3), dtype=np.float32)
    dark = 0.2 * rng.random((1, h, w, 3), dtype=np.float32)
    smooth = np.linspace(0.2, 0.9, w, dtype=np.float32)[None, None, :, None]
    bright = np.clip(smooth + 0.1 * rng.random((1, h, w, 3), dtype=np.float32), 0, 1)
    return np.concatenate([mid, dark, bright]).astype(np.float32)


def _close(want, got, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
def test_histogram_counts_exact(hw):
    x = _frames(*hw)[..., 0].reshape(3, -1)
    want = np.asarray(jeq.histogram256(jnp.asarray(x)))
    got = teq.histogram256(torch.from_numpy(x)).numpy()
    assert np.array_equal(want, got)
    assert got.sum(-1).tolist() == [hw[0] * hw[1]] * 3


@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (8, 8)])
@pytest.mark.parametrize("clip_limit", [2.0, 0.0])
def test_clahe_channel(hw, clip_limit):
    x = _frames(*hw)[..., 1]
    _close(jeq.clahe_channel(jnp.asarray(x), clip_limit, 8),
           teq.clahe_channel(torch.from_numpy(x), clip_limit, 8))


@pytest.mark.parametrize("name", ["equalize_hist_channel"])
def test_equalize_hist_channel(name):
    x = _frames(37, 53)[..., 2]
    _close(getattr(jeq, name)(jnp.asarray(x)), getattr(teq, name)(torch.from_numpy(x)))


@pytest.mark.parametrize("name", ["clahe_luma", "clahe_rgb", "equalize_rgb",
                                  "scale_abs_autolevels"])
def test_rgb_filters(name):
    x = _frames(37, 53, seed=1)
    _close(getattr(jeq, name)(jnp.asarray(x)), getattr(teq, name)(torch.from_numpy(x)))


@pytest.mark.parametrize("method", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("luma_blend_on", [True, False])
def test_rgb_equalizer(method, luma_blend_on):
    """Methods 0-5; method 5 (MSRCP) at a frame size where its sigma-250
    box filters still reach past the frame (radius 249)."""
    x = _frames(48, 64, seed=2)
    kw = dict(method=method, strength=0.7, weight3=0.3, luma_blend_on=luma_blend_on)
    want = jeq.rgb_equalizer(jnp.asarray(x), **kw)
    got = teq.rgb_equalizer(torch.from_numpy(x), **kw)
    _close(want, got)
    # the dark frame is gated off: it comes back as it went in (up to the
    # rounding of the final x * s + x * (1 - s) blend)
    assert np.abs(got[1].numpy() - x[1]).max() <= 1e-6


def test_rgb_equalizer_zero_strength_is_identity():
    x = torch.from_numpy(_frames(8, 8))
    assert teq.rgb_equalizer(x, strength=0.0) is x


@pytest.mark.parametrize("kw", [dict(), dict(factor=(1.1, 0.9, 1.0), bias=(5, 0, -3),
                                             gamma=(1.0, 0.9, 1.2))])
def test_adjust_rgb(kw):
    x = _frames(20, 30, seed=3)
    _close(jeq.adjust_rgb(jnp.asarray(x), **kw), teq.adjust_rgb(torch.from_numpy(x), **kw))


@pytest.mark.parametrize("kw", [dict(strength=0.5), dict(strength=0.3, rgb_factor=(0.98, 1.02, 1.0))])
def test_rgb_balance(kw):
    x = _frames(20, 30, seed=4)
    _close(jeq.rgb_balance(jnp.asarray(x), **kw), teq.rgb_balance(torch.from_numpy(x), **kw))


@pytest.mark.parametrize("args", [(0.40, 0.90, 0.35, 2.0), (0.40, 0.90, 0.15, 4.0)])
def test_luma_blend(args):
    a, b = _frames(20, 30, seed=5), _frames(20, 30, seed=6)
    _close(jmerge.luma_blend(jnp.asarray(a), jnp.asarray(b), *args),
           tmerge.luma_blend(torch.from_numpy(a), torch.from_numpy(b), *args))
