"""The port's tensor ops against the JAX package's, on the CPU.

Same numpy inputs (from a seed) go through the havc_tpu function and its
havc_tpu_torch counterpart.  Tolerance: max abs <= 1e-5 for values on the
[0, 1] scale (both sides compute the same float32 arithmetic; only the
rounding of individual operations differs).  LAB values span [0, 100], so
LAB is held to 1e-5 relative to that range (1e-3 absolute).
"""
import numpy as np
import pytest
import torch

import havc_tpu.filters as jfilters
import havc_tpu.presets as jpresets
from havc_tpu.ops import chroma as jchroma
from havc_tpu.ops import colorspace as jcs
from havc_tpu.ops import merge as jmerge
from havc_tpu.ops import resize as jresize
from havc_tpu.ops import temporal as jtemporal

import havc_tpu_torch.filters as tfilters
import havc_tpu_torch.presets as tpresets
from havc_tpu_torch.ops import chroma as tchroma
from havc_tpu_torch.ops import colorspace as tcs
from havc_tpu_torch.ops import merge as tmerge
from havc_tpu_torch.ops import resize as tresize
from havc_tpu_torch.ops import temporal as ttemporal

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

TOL = 1e-5


def _rgb(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).random(shape, dtype=np.float32) * scale).astype(np.float32)


def _away_from_gray_threshold(x, tht=15, margin=0.05):
    """Replace pixels whose HSV saturation (0..255 scale) lies within
    ``margin`` of ``tht`` by their gray value, so the binary ``s < tht/255``
    gray mask of restore_color cannot flip on rounding."""
    mx, mn = x.max(-1), x.min(-1)
    s = np.where(mx > 0, (mx - mn) / np.where(mx > 0, mx, 1), 0) * 255.0
    near = np.abs(s - tht) < margin
    out = x.copy()
    out[near] = x[near].mean(-1, keepdims=True)
    return out


def _check(jfn, tfn, *arrays, tol=TOL, **kw):
    want = np.asarray(jfn(*arrays, **kw))
    got = tfn(*[torch.from_numpy(np.array(a)) for a in arrays], **kw)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


# --- colorspace ---------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "luma", "rgb_to_gray", "rgb_to_yuv", "rgb_to_hsv", "srgb_to_linear",
    "linear_to_srgb",
])
def test_colorspace_from_rgb(name):
    _check(getattr(jcs, name), getattr(tcs, name), _rgb((2, 16, 24, 3), 0))


def test_yuv_and_hsv_inverses():
    x = _rgb((2, 16, 24, 3), 1)
    yuv = np.asarray(jcs.rgb_to_yuv(x))
    hsv = np.asarray(jcs.rgb_to_hsv(x))
    _check(jcs.yuv_to_rgb, tcs.yuv_to_rgb, yuv)
    _check(jcs.hsv_to_rgb, tcs.hsv_to_rgb, hsv)
    # chroma pushed out of gamut: the luma-preserving inverse desaturates
    wide = yuv.copy()
    wide[..., 1:] = (wide[..., 1:] - 0.5) * 3.0 + 0.5
    _check(jcs.yuv_to_rgb_preserve_luma, tcs.yuv_to_rgb_preserve_luma, wide)


def test_copy_chroma():
    _check(jcs.copy_chroma, tcs.copy_chroma, _rgb((2, 16, 24, 3), 2), _rgb((2, 16, 24, 3), 3))


def test_lab_both_ways():
    x = _rgb((2, 16, 24, 3), 4)
    _check(jcs.rgb_to_lab, tcs.rgb_to_lab, x, tol=1e-3)
    lab = np.asarray(jcs.rgb_to_lab(x))
    _check(jcs.lab_to_rgb, tcs.lab_to_rgb, lab)


# --- resize -------------------------------------------------------------------


@pytest.mark.parametrize("size,kernel,antialias", [
    ((40, 56), "spline64", True),   # up
    ((9, 13), "spline64", True),    # down
    ((64, 64), "bilinear", True),
    ((10, 14), "bilinear", True),
    ((10, 14), "bilinear", False),
    ((40, 56), "bilinear", False),
])
def test_resize(size, kernel, antialias):
    x = _rgb((2, 24, 32, 3), 5)
    np.testing.assert_array_equal(
        tresize.resize_kernel_matrix(24, size[0], kernel, antialias),
        jresize.resize_kernel_matrix(24, size[0], kernel, antialias))
    _check(jresize.resize, tresize.resize, x, height=size[0], width=size[1],
           kernel=kernel, antialias=antialias)


# --- chroma, presets ------------------------------------------------------------

_HUE_STRINGS = [
    "250:360|0.8,0.1", "300:360|0.8,0.1", "270:330|0.5,0.1", "180:280|+140,0.90",
    "300:360,0:20|+40,1.0", "red,blue|0.5,0.2", "magenta", "none", "", "bad|x",
    "60:90|12,0.1", "200:300|-30,0.2",
]


def _preset_strings():
    out = []
    for tune in jpresets._COLOR_TUNE:
        for fix in jpresets._COLOR_FIX:
            for dd_model in range(4):
                out += list(jpresets.get_color_tune(tune, fix, "none", dd_model)[1:3])
        for cmap in jpresets._COLORMAP:
            out.append(jpresets.get_colormap(cmap, tune))
    return sorted(set(out))


@pytest.mark.parametrize("s", _HUE_STRINGS + _preset_strings())
def test_parse_hue_adjust(s):
    want = jchroma.parse_hue_adjust(s)
    got = tchroma.parse_hue_adjust(s)
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)


def test_presets_match():
    for tune in jpresets._COLOR_TUNE:
        for fix in jpresets._COLOR_FIX:
            for cmap in ("none", "blue->brown", "180:280|+140,0.9"):
                for dd_model in range(4):
                    assert (tpresets.get_color_tune(tune, fix, cmap, dd_model)
                            == jpresets.get_color_tune(tune, fix, cmap, dd_model))
    for preset in jpresets._PRESETS:
        assert tpresets.get_render_factors(preset) == jpresets.get_render_factors(preset)
    for cm in ("Video+Artistic", "Stable+ModelScope", "DeOldify(Video)", "DDColor(Artistic)"):
        assert tpresets.get_color_model(cm) == jpresets.get_color_model(cm)


@pytest.mark.parametrize("kw", [
    dict(hue=20.0, sat=1.2, bright=0.1),
    dict(cont=1.1, gamma=1.2),
    dict(hue=-30.0, sat=0.7, bright=-0.2, cont=0.9, gamma=0.8),
], ids=["hsv", "contrast_gamma", "all"])
def test_tweak(kw):
    _check(jchroma.tweak, tchroma.tweak, _rgb((2, 16, 24, 3), 6), **kw)


@pytest.mark.parametrize("kw", [
    dict(sat=0.8, bright=-0.1),
    dict(hue_adjust="250:360|0.8,0.1"),
    dict(sat=1.1, hue=15, hue_adjust="180:280|+140,0.9"),
], ids=["sat_bright", "hue_fix", "hue_map"])
def test_chroma_tweak(kw):
    _check(jchroma.chroma_tweak, tchroma.chroma_tweak, _rgb((2, 16, 24, 3), 7), **kw)


def test_luma_adjusted_levels():
    # frame 0 dark (mean luma ~0.15: lift and gamma), frame 1 mid (gamma)
    x = np.stack([_rgb((16, 24, 3), 8, 0.3), _rgb((16, 24, 3), 9)])
    kw = dict(luma_min=0.3, gamma=2.5, gamma_luma_min=0.6, gamma_alpha=1.5, gamma_min=0.5)
    _check(jchroma.luma_adjusted_levels, tchroma.luma_adjusted_levels, x, **kw)
    _check(jchroma.luma_adjusted_levels, tchroma.luma_adjusted_levels, x,
           luma_min=0.2, gamma=1.5, gamma_luma_min=0.6)


@pytest.mark.parametrize("weight", [0.2, -0.8])
def test_restore_color(weight):
    # inputs drawn away from the s < 15/255 threshold (see
    # _away_from_gray_threshold) so the binary mask cannot flip
    color = _rgb((2, 16, 24, 3), 10)
    gray = _away_from_gray_threshold(_rgb((2, 16, 24, 3), 11) * 0.2 + 0.4)
    _check(jchroma.restore_color, tchroma.restore_color, color, gray,
           tht=15, weight=weight, tht_scen=0.8)


@pytest.mark.parametrize("kw", [
    dict(method=2, b_weight=0.4),
    dict(method=2, b_weight=0.6, sat=(0.9, 1.1), hue=(5.0, -5.0), invert_clips=True),
], ids=["simple", "simple_tweaked"])
def test_combine_models(kw):
    _check(jmerge.combine_models, tmerge.combine_models,
           _rgb((2, 16, 24, 3), 12), _rgb((2, 16, 24, 3), 13), **kw)


def _dark_to_bright(seed):
    """Four frames whose mean luma falls in each branch of the dark red
    fix: about 0.5, 0.25, 0.15 and 0.07."""
    x = _rgb((4, 16, 24, 3), seed)
    return (x * np.array([1.0, 0.5, 0.3, 0.14], np.float32)[:, None, None, None]).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(method=3, b_weight=0.5),
    dict(method=3, b_weight=1.0, cmc_p=[0.3]),
    dict(method=4, b_weight=0.6),
    dict(method=4, b_weight=1.0, lmm_p=[0.4, 0.4, 0.8]),
    dict(method=5, b_weight=0.4),
    dict(method=7, b_weight=0.5),
    dict(method=7, b_weight=1.0, cmc_p=[0.15, False, 10, 30]),
], ids=["constrained", "constrained_1", "luma_masked", "luma_masked_binary", "adaptive_luma",
        "chroma_bound", "chroma_bound_no_fix"])
def test_combine_models_methods_3_4_5_7(kw):
    _check(jmerge.combine_models, tmerge.combine_models,
           _dark_to_bright(20), _dark_to_bright(21), **kw)


def test_combine_models_unported_method_raises():
    """Every merge method of the JAX package is ported (method 6 with the
    classic surface); an id it does not know raises there and here."""
    a = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="unsupported merge method"):
        tmerge.combine_models(a, a, method=8)


# --- filters ------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("dark_tweak", dict(dark_threshold=0.2, dark_amount=0.8)),
    ("dark_tweak", dict(dark_threshold=0.3, dark_amount=0.6, dark_hue_adjust="250:360|0.8,0.1")),
    ("chroma_bright_tweak", dict(black_threshold=0.3, white_threshold=0.7, dark_sat=0.9, dark_bright=0.0)),
    ("chroma_bright_tweak", dict(black_threshold=0.4, white_threshold=0.4)),
    ("colormap_filter", dict(colormap_adjust="180:280|+140,0.9")),
    ("constrained_tweak", dict(luma_min=0.3, gamma=2.5, gamma_luma_min=0.6, gamma_alpha=1.5)),
])
def test_filters_one_clip(name, kw):
    _check(getattr(jfilters, name), getattr(tfilters, name), _rgb((2, 16, 24, 3), 14), **kw)


def test_filters_two_clips():
    hires, colored = _rgb((2, 32, 48, 3), 15), _rgb((2, 32, 48, 3), 16)
    _check(jfilters.recover_clip_luma, tfilters.recover_clip_luma, hires, colored)
    _check(jfilters.chroma_resize_restore, tfilters.chroma_resize_restore,
           hires, _rgb((2, 12, 12, 3), 17))


# --- temporal -----------------------------------------------------------------


def _clip_for_stabilizer(seed):
    """T=18 at 16x24 (crosses the 15-frame warm-up): mostly colorful
    frames, two dark ones (mean luma outside [0.22, 0.78]) and one nearly
    gray one, all away from the gray-mask threshold."""
    x = _rgb((18, 16, 24, 3), seed)
    x[[4, 16]] *= 0.3
    x[10] = x[10] * 0.03 + x[10].mean(-1, keepdims=True) * 0.97
    return _away_from_gray_threshold(x)


@pytest.mark.parametrize("sc", [None, "cuts"])
@pytest.mark.parametrize("kw", [
    dict(nframes=5, tht=15, weight=0.2, tht_scen=0.8),
    dict(nframes=7, weighted=True, tht=0),
], ids=["restore", "plain_average"])
def test_chroma_stabilizer(kw, sc):
    x = _clip_for_stabilizer(18)
    scv = None
    if sc:
        scv = np.zeros(18, np.int32)
        scv[[0, 7, 15]] = 1
    want = np.asarray(jtemporal.chroma_stabilizer(x, scenechange=scv, **kw))
    got = ttemporal.chroma_stabilizer(torch.from_numpy(x), scenechange=scv, **kw).numpy()
    assert np.abs(got - want).max() <= TOL


def test_chroma_stabilizer_frame0():
    x = _clip_for_stabilizer(19)[:8]
    want = np.asarray(jtemporal.chroma_stabilizer(x, frame0=10))
    got = ttemporal.chroma_stabilizer(torch.from_numpy(x), frame0=10).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("sc", [None, "cuts"])
def test_reduce_flicker(sc):
    x = _rgb((9, 16, 24, 3), 20)
    scv = None
    if sc:
        scv = np.zeros(9, np.int32)
        scv[[0, 4]] = 1
    want = np.asarray(jtemporal.reduce_flicker(x, strength=5, scenechange=scv))
    got = ttemporal.reduce_flicker(torch.from_numpy(x), strength=5, scenechange=scv).numpy()
    assert np.abs(got - want).max() <= TOL


def test_average_weights():
    for n in (3, 5, 7, 15):
        for weighted in (False, True):
            np.testing.assert_array_equal(ttemporal.average_weights(n, weighted),
                                          jtemporal.average_weights(n, weighted))
