"""``HAVC_main``'s classic presets and tunes: the port against the JAX
package on the CPU.

Both packages run the whole path on the same seeded 6x136x240 gray clip
(large enough that the Placebo tiles overlap: 2x2 tiles of 100x152,
overlaps 64/64), batch_size 4, with small engines carried from flax under
the published names: DeOldifyWide "nano" (``video``), DeOldifyDeep "nano"
(``artistic``), DDColor ``micro`` (``artistic``) and the Zhang nets at
width 8 (``siggraph17``, ``eccv16``; the JAX nets built narrow through
tests/test_torch_classic_models.py's ``narrow_jax_zhang``).  The engine
factories run at render factor 4 (Zhang always at 256).

Tolerance.  The colorized frames agree to ~1e-6; the BlackWhiteTune
post-pass then bins them into CLAHE histograms (``int(x * 255)``), and a
value within that of a bin edge lands in the neighbouring bin in one
package, which moves its tile's LUT (17x30 pixels a tile here) by up to
1/510 over a range of bins; a retinex pass adds its box sums' order (see
tests/test_torch_retinex_lut_tiles.py).  So each path with a BW tune is
held to: the share of output values more than 1e-4 apart at most 2 %, and
none more than 0.02; the shares are printed (seen: 0 % for placebo and
veryslow, whose largest differences are 1.5e-6 and 4.5e-5; 0.11 %, at
most 3.1e-4, for the retinex pre-pass of medium_eccv16_lut).  Paths with
no histogram after the engines hold 1e-4 everywhere.  Torch runs on 2 threads, as in
tests/test_torch_streaming.py (with every core busy a full pool is slower).
"""
import numpy as np
import pytest
import torch

import havc_tpu
import havc_tpu.engines as jengines
from havc_tpu.clip import Clip as JClip
from havc_tpu.models import ddcolor as jdd
from havc_tpu.models import deoldify as jdo
from havc_tpu.utils import jitcache

import havc_tpu_torch
import havc_tpu_torch.engines as tengines
from havc_tpu_torch.models import ddcolor as tdd
from havc_tpu_torch.models import deoldify as tdo
from havc_tpu_torch.models.bridge import state_dict_from_flax

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_classic_models import carry_deep, carry_zhang, narrow_jax_zhang, perturb

TOL = 1e-4
BIN_SHARE, BIN_MAX = 0.02, 0.02
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def classic_engines():
    import jax
    import jax.numpy as jnp

    def carry(jm, tm, seed):
        p = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
        p = {"params": perturb(p["params"], seed)}
        tm.load_state_dict(state_dict_from_flax(p["params"]))
        return jm, p, tm.eval().requires_grad_(False)

    out = {
        ("deoldify", "video"): carry(jdo.DeOldifyWide(encoder="nano", nf_factor=1),
                                     tdo.DeOldifyWide(encoder="nano", nf_factor=1), 0),
        ("ddcolor", "artistic"): carry(jdd.DDColor.from_config("micro"),
                                       tdd.DDColor.from_config("micro"), 1),
    }
    p, tm = carry_deep(2)
    out[("deoldify", "artistic")] = (jdo.DeOldifyDeep(encoder="nano", nf_factor=1.5), p, tm)
    for i, name in enumerate(("siggraph17", "eccv16")):
        out[("zhang", name)] = carry_zhang(name, 3 + i)
    return out


@pytest.fixture
def engines_in_both(classic_engines, monkeypatch):
    monkeypatch.setattr(jitcache, "_CACHE", {})
    for key, (jm, p, tm) in classic_engines.items():
        monkeypatch.setitem(jengines.registry._cache, key, (jm, p))
        monkeypatch.setitem(tengines.registry._cache, key + (CPU,), tm)
    j_do, j_dd = jengines.make_deoldify_fn, jengines.make_ddcolor_fn
    monkeypatch.setattr(jengines, "make_deoldify_fn",
                        lambda model=0, render_factor=24: j_do(model, 4))
    monkeypatch.setattr(jengines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: j_dd(model, 4, **kw))
    t_do, t_dd = tengines.make_deoldify_fn, tengines.make_ddcolor_fn
    monkeypatch.setattr(tengines, "make_deoldify_fn",
                        lambda model=0, render_factor=24, **kw: t_do(model, 4, **kw))
    monkeypatch.setattr(tengines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: t_dd(model, 4, **kw))


def gray_clip(t=6, h=136, w=240, seed=7):
    """A smooth gray field with fine noise, drifting over time."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = [0.5 + 0.3 * np.sin(xx / 23.0 + i / 4.0) * np.cos(yy / 17.0) for i in range(t)]
    y = np.stack(frames)[..., None] + 0.05 * rng.random((t, h, w, 1))
    return np.repeat(np.clip(y, 0, 1), 3, axis=-1).astype(np.float32)


# name -> (entry point, its arguments)
CONFIGS = {
    # the chip_smoke placebo_path: 2x2 tiles, MSRCP prefilter, Exploration
    # LUT, CLAHE BW tune, deflicker
    "placebo": ("HAVC_main", dict(Preset="Placebo", ColorFix="Retinex/Red",
                                  BlackWhiteTune="Medium")),
    # the chip_smoke veryslow_path: DeOldify Artistic and Zhang Siggraph17,
    # the denoise postfilter, merge method 6, ColorAdjust's LUT remaps
    "veryslow": ("HAVC_main", dict(Preset="VerySlow", ColorModel="Artistic+Siggraph17",
                                   CombMethod="Chroma-Retention", ColorFix="None",
                                   BlackWhiteTune="Light", BlackWhiteMode=4)),
    # the retinex BW pre-pass (mode 6), Zhang ECCV16, a lut look (``lut`` is
    # HAVC_main_presets' own)
    "medium_eccv16_lut": ("HAVC_main_presets", dict(ColorModel="Video+ECCV16",
                                                    BlackWhiteTune="Strong", BlackWhiteMode=6,
                                                    lut=5)),
    # no histogram after the engines: 1e-4 everywhere
    "fast_artistic_stable": ("HAVC_main", dict(Preset="Fast", ColorModel="Artistic+Artistic",
                                               ColorFix="Yellow", ColorMap="blue->brown")),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_havc_main_classic_matches_jax(engines_in_both, name):
    entry, kw = CONFIGS[name]
    frames = gray_clip()
    with narrow_jax_zhang():
        want = np.asarray(getattr(havc_tpu, entry)(JClip(frames=frames.copy()), batch_size=4,
                                                   **kw).frames)
    got = getattr(havc_tpu_torch, entry)(havc_tpu_torch.Clip(frames=frames.copy()),
                                         batch_size=4, device="cpu", **kw).frames
    assert got.shape == want.shape == frames.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    share = float(np.mean(diff > TOL))
    print(f"{name}: max |diff| {diff.max():.3g}, {share:.3%} of values above {TOL}")
    if "BlackWhiteTune" in kw:
        assert share <= BIN_SHARE and diff.max() <= BIN_MAX, (share, diff.max())
    else:
        assert diff.max() <= TOL
    # the colorizer did something: chroma came through
    assert np.abs(got - got.mean(-1, keepdims=True)).mean() > 1e-3
