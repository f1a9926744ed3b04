"""The classic surface's leftovers, against the JAX package on the CPU:
the overlay compositor (9 modes, with and without a mask, a mask per
plane, selected planes, cropped placements; ``HAVC_clip_overlay``), the
NLM degrain (strengths 1-3; ``HAVC_degrain``), ``pad_to_square``,
``copy_luma``, ``ciede2000`` (achromatic pairs, hue differences of
exactly 180 degrees, negative ``atan2`` angles), ``metrics``, the
reference-export helpers, the engine helpers (``deoldify_frames``,
``ddcolor_frames``, ``colorize_gated``), ``clip.from_frames``, the log
and its one ``HAVCError``, and the legacy wrappers.

Tolerances: 1e-5 on ops (``ciede2000`` 1e-5 relative to max(1, dE): its
float32 trigonometry rounds differently, 3e-6 of dE at most); 1e-4 on the
front ends, ``metrics`` (relative to max(1, value): LAB's powers and
cube roots round differently before CIEDE2000) and the paths through the
small engines (the engines and ColorMNet are
tests/test_torch_exemplar_surface.py's ``exemplar_both``).
The legacy wrappers are held against the JAX package's where their
targets run the classic engines; ``HAVC_cmnet`` and
``vs_frame_interpolation`` are held bit-identical to the port's
``HAVC_deepex`` and FrameInterp, which tests/test_torch_exemplar_*.py
hold against the JAX package.
"""
import ast
import logging
import os
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import havc_tpu
import havc_tpu.engines as jengines
from havc_tpu import clip as jclip
from havc_tpu import metrics as jmetrics
from havc_tpu.clip import Clip as JClip
from havc_tpu.ops import colorspace as jcs
from havc_tpu.ops import denoise as jdn
from havc_tpu.ops import overlay as jov
from havc_tpu.ops import resize as jrs
from havc_tpu.utils import log as jlog

import havc_tpu_torch
import havc_tpu_torch.engines as tengines
from havc_tpu_torch import api as tapi
from havc_tpu_torch import clip as tclip
from havc_tpu_torch import metrics as tmetrics
from havc_tpu_torch.exemplar import allrefs as tallrefs
from havc_tpu_torch.ops import colorspace as tcs
from havc_tpu_torch.ops import denoise as tdn
from havc_tpu_torch.ops import overlay as tov
from havc_tpu_torch.ops import resize as trs
from havc_tpu_torch.utils import log as tlog

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_exemplar_surface import (  # noqa: F401  (fixtures)
    colored_clip, colormnet_both, exemplar_both, gray_clip, seeded_colormnet)

OP_TOL = 1e-5
TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rgb(t=4, h=48, w=64, seed=0):
    return np.random.default_rng(seed).random((t, h, w, 3), dtype=np.float32)


def close(want, got, tol=OP_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


# --- overlay ------------------------------------------------------------------------------

PLACEMENTS = [(5, 7), (-6, -3), (50, 35), (0, 0)]


@pytest.mark.parametrize("mode", jov.BLEND_MODES)
def test_overlay_op(mode):
    """Every blend mode at placements inside, across the top-left and
    across the bottom-right corner, with a mask and opacity and without."""
    base, over = rgb(), rgb(h=20, w=30, seed=1)
    mask = np.random.default_rng(2).random((4, 20, 30), dtype=np.float32)
    for x, y in PLACEMENTS:
        close(jov.overlay(jnp.asarray(base), jnp.asarray(over), x, y, jnp.asarray(mask), 0.7,
                          mode),
              tov.overlay(torch.from_numpy(base), torch.from_numpy(over), x, y,
                          torch.from_numpy(mask), 0.7, mode))
        close(jov.overlay(jnp.asarray(base), jnp.asarray(over), x, y, None, 1.0, mode),
              tov.overlay(torch.from_numpy(base), torch.from_numpy(over), x, y, None, 1.0, mode))
    with pytest.raises(ValueError):
        tov.overlay(torch.from_numpy(base), torch.from_numpy(over), mode="screen")


OVERLAY_VARIANTS = {
    "mask_first_plane": dict(x=10, y=-4, opacity=0.7, masked=True),
    "mask_per_plane": dict(x=-3, y=12, opacity=0.9, masked=True, mask_first_plane=False),
    "planes_0_2": dict(x=40, y=30, planes=[0, 2]),
}


@pytest.mark.parametrize("variant", OVERLAY_VARIANTS.keys())
@pytest.mark.parametrize("mode", jov.BLEND_MODES)
def test_clip_overlay(mode, variant):
    kw = dict(OVERLAY_VARIANTS[variant], mode=mode, batch_size=4)
    masked = kw.pop("masked", False)
    base, over, mask = rgb(t=6), rgb(t=6, h=20, w=30, seed=1), rgb(t=6, h=20, w=30, seed=2)
    want = havc_tpu.api.HAVC_clip_overlay(JClip(frames=base.copy()), JClip(frames=over.copy()),
                                          mask=JClip(frames=mask.copy()) if masked else None,
                                          **kw)
    got = havc_tpu_torch.HAVC_clip_overlay(
        havc_tpu_torch.Clip(frames=base.copy()), overlay_clip=havc_tpu_torch.Clip(frames=over),
        mask=havc_tpu_torch.Clip(frames=mask) if masked else None, device="cpu", **kw)
    assert isinstance(got.frames, np.ndarray)
    close(want.frames, got.frames, TOL)


# --- degrain ------------------------------------------------------------------------------


@pytest.mark.parametrize("strength", [1, 2, 3])
def test_degrain(strength):
    x = np.clip(0.5 + 0.15 * np.random.default_rng(strength).standard_normal((6, 40, 56, 3)),
                0, 1).astype(np.float32)
    # jitted: the JAX package's eager NLM compiles each of its ops apart
    nlm = jax.jit(jdn.nlm_luma, static_argnums=(1, 2, 3))
    close(nlm(jnp.asarray(x[:2, ..., 0]), 0.8, strength, 4 - strength),
          tdn.nlm_luma(torch.from_numpy(x[:2, ..., 0].copy()), 0.8, strength, 4 - strength))
    want = havc_tpu.api.HAVC_degrain(JClip(frames=x.copy()), strength)
    got = havc_tpu_torch.HAVC_degrain(havc_tpu_torch.Clip(frames=torch.from_numpy(x)), strength,
                                      device="cpu")
    assert isinstance(got.frames, torch.Tensor)
    close(want.frames, got.frames, TOL)


# --- resize, colorspace, CIEDE2000 ----------------------------------------------------------


@pytest.mark.parametrize("hw", [(48, 80), (90, 50)], ids=["landscape", "portrait"])
def test_pad_to_square(hw):
    x = rgb(t=2, h=hw[0], w=hw[1])
    want, jmeta = jrs.pad_to_square(jnp.asarray(x), 64)
    got, tmeta = trs.pad_to_square(torch.from_numpy(x), 64)
    assert tuple(jmeta) == tuple(tmeta) and got.shape == (2, 64, 64, 3)
    close(want, got)
    close(jrs.unpad_from_square(want, jmeta, 64), trs.unpad_from_square(got, tmeta, 64))


def test_copy_luma():
    a, b = rgb(t=2), rgb(t=2, seed=1)
    close(jcs.copy_luma(jnp.asarray(a), jnp.asarray(b)),
          tcs.copy_luma(torch.from_numpy(a), torch.from_numpy(b)))


def lab_pairs(n=20000, seed=0):
    """LAB pairs from seeded RGB (near and far pairs), then the branches:
    achromatic pairs (a = b = 0), hue differences of exactly +-180 degrees,
    negative atan2 angles and one side achromatic."""
    rng = np.random.default_rng(seed)
    c1 = rng.random((n, 3), dtype=np.float32)
    c2 = np.clip(c1 + rng.normal(0, 0.08, c1.shape), 0, 1).astype(np.float32)
    c2[: n // 2] = rng.random((n // 2, 3), dtype=np.float32)
    lab1 = np.asarray(jcs.rgb_to_lab(jnp.asarray(c1)))
    lab2 = np.asarray(jcs.rgb_to_lab(jnp.asarray(c2)))
    special = np.array([
        [[50, 0, 0], [60, 0, 0]],        # both achromatic
        [[50, 0, 0], [50, 3, -2]],       # one side achromatic
        [[50, 5, 0], [50, -5, 0]],       # hue 0 vs 180
        [[50, 0, 5], [50, 0, -5]],       # hue 90 vs 270 (atan2 -90)
        [[60, -3, -4], [60, 3, 4]],      # exactly opposite, negative angles
        [[40, -7, -0.5], [45, -6, 0.5]],  # across the -180/180 seam
        [[70, 20, -30], [65, -25, 28]],
    ], np.float32)
    return (np.concatenate([lab1, special[:, 0]]).astype(np.float32),
            np.concatenate([lab2, special[:, 1]]).astype(np.float32))


def test_ciede2000():
    lab1, lab2 = lab_pairs()
    want = np.asarray(jcs.ciede2000(jnp.asarray(lab1), jnp.asarray(lab2)))
    got = tcs.ciede2000(torch.from_numpy(lab1), torch.from_numpy(lab2)).numpy()
    np.testing.assert_allclose(got, want, rtol=OP_TOL, atol=OP_TOL)
    # the branch cases land exactly where the JAX package's do
    np.testing.assert_allclose(got[-7:], want[-7:], rtol=0, atol=OP_TOL)
    assert np.isfinite(got).all() and got[-7] > 0


def test_metrics(tmp_path):
    a = rgb(t=3)
    b = np.clip(a + np.random.default_rng(1).normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    de = tmetrics.dE2000(a, b, device="cpu")
    assert isinstance(de, np.ndarray)
    np.testing.assert_allclose(de, jmetrics.dE2000(a, b), rtol=TOL, atol=TOL)
    assert isinstance(tmetrics.dE2000(torch.from_numpy(a), torch.from_numpy(b)), torch.Tensor)
    assert abs(tmetrics.psnr(a, b, device="cpu") - jmetrics.psnr(a, b)) <= TOL
    assert tmetrics.psnr(a, a, device="cpu") == float("inf")
    for want, got in ((jmetrics.compare_images(a[0], b[0]),
                       tmetrics.compare_images(a[0], b[0], device="cpu")),
                      (jmetrics.compare_clip(a, b), tmetrics.compare_clip(
                          torch.from_numpy(a), torch.from_numpy(b)))):
        assert want.keys() == got.keys()
        for k in want:
            assert abs(want[k] - got[k]) <= TOL * max(1.0, abs(want[k])), (k, want[k], got[k])
    for d, imgs in (("x", a), ("y", b)):
        os.makedirs(tmp_path / d)
        for i, img in enumerate(imgs):
            havc_tpu_torch.io.write_image(img, str(tmp_path / d / f"f{i}.png"))
    want = jmetrics.compare_dirs(str(tmp_path / "x"), str(tmp_path / "y"))
    got = tmetrics.compare_dirs(str(tmp_path / "x"), str(tmp_path / "y"), device="cpu")
    assert want.keys() == got.keys() and got["__summary__"]["images"] == 3
    for name in want:
        for k in want[name]:
            assert abs(want[name][k] - got[name][k]) <= TOL * max(1.0, abs(want[name][k]))


# --- reference export ---------------------------------------------------------------------


def test_export_helpers(tmp_path):
    """``HAVC_export_reference_frames`` (flags on the clip) and
    ``HAVC_export_list_frames`` (an explicit list; one element N = every
    N-th frame) write the same files as the JAX package's."""
    x = rgb(t=8, h=24, w=32)
    sc = havc_tpu_torch.SceneFlags.from_frame_list(8, [0, 3, 6])
    jsc = havc_tpu.clip.SceneFlags.from_frame_list(8, [0, 3, 6])
    runs = [
        ("HAVC_export_reference_frames", dict(ref_offset=5, ref_ext="png")),
        ("HAVC_export_list_frames", dict(ref_list=[3], ref_ext="png")),
        ("HAVC_export_list_frames", dict(frame_list=[1, 7], offset=2, ref_ext="jpg",
                                         ref_jpg_quality=80)),
    ]
    for i, (name, kw) in enumerate(runs):
        jdir, tdir = str(tmp_path / f"j{i}"), str(tmp_path / f"t{i}")
        want = getattr(havc_tpu.api, name)(JClip(frames=x.copy(), sc=jsc), jdir, **kw)
        got = getattr(havc_tpu_torch, name)(
            havc_tpu_torch.Clip(frames=torch.from_numpy(x), sc=sc), tdir, **kw)
        assert [os.path.basename(p) for p in want] == [os.path.basename(p) for p in got]
        assert got
        for a, b in zip(want, got):
            assert np.array_equal(cv2.imread(a), cv2.imread(b))
    assert havc_tpu_torch.HAVC_export_list_frames(havc_tpu_torch.Clip(frames=x), "unused") == []


# --- engine helpers, from_frames ------------------------------------------------------------


def test_engine_helpers(exemplar_both):
    """``deoldify_frames`` and ``ddcolor_frames`` (the small engines at
    render factor 4) and ``colorize_gated`` (scene frames gathered into
    padded batches) against the JAX package's; its eager wrappers are
    its ``make_*_fn`` functions applied once, here jitted (eagerly it
    compiles every op apart)."""
    x = gray_clip()[:5]
    jfn, jp = jengines.make_deoldify_fn(0, 24)
    close(jax.jit(jfn)(jp, jnp.asarray(x)), tengines.deoldify_frames(x, device="cpu"), TOL)
    flags, tweaks = (True, False, False), (list(tengines.DEF_TWEAK_p), "300:360|0.8,0.1")
    dfn, dp = jengines.make_ddcolor_fn(1, 24, tweaks_flags=flags, tweaks=tweaks)
    close(jax.jit(dfn)(dp, jnp.asarray(x)),
          tengines.ddcolor_frames(torch.from_numpy(x), 1, 24, flags, tweaks), TOL)
    sc = np.array([0, 1, 0, 1, 1], np.int8)  # frame 0 added; 3 frames in batches of 2
    jfn, jp = jengines.make_deoldify_fn(0, 24)
    want = jengines.colorize_gated(x, sc, jfn, batch_size=2, params=jp)
    got = tengines.colorize_gated(x, sc, lambda p, b: tengines.make_deoldify_fn(0, 24,
                                                                                 device="cpu")(b),
                                  batch_size=2, params="unused", device="cpu")
    assert isinstance(got, np.ndarray)
    close(want, got, TOL)
    np.testing.assert_array_equal(got[2], x[2])
    scale = tengines.colorize_gated(torch.from_numpy(x), None, lambda b: b * 0.5, batch_size=4)
    close(jengines.colorize_gated(x, None, lambda b: b * 0.5, batch_size=4), scale)


@pytest.mark.parametrize("kind", ["uint8", "float", "single_frame"])
def test_from_frames(kind):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (3, 8, 10, 3), dtype=np.uint8)
    if kind == "float":
        x = x.astype(np.float32) / 255.0
    if kind == "single_frame":
        x = x[0]
    want = jclip.from_frames(x, fps=30.0)
    got = tclip.from_frames(x, fps=30.0)
    assert got.fps == 30.0 and isinstance(got.frames, np.ndarray)
    close(want.frames, got.frames, 0)
    on = tclip.from_frames(x, device="cpu")
    assert isinstance(on.frames, torch.Tensor) and on.frames.dtype == torch.float32
    close(want.frames, on.frames, OP_TOL)


# --- the log --------------------------------------------------------------------------------


def test_log_and_one_havc_error(caplog):
    caplog.set_level(logging.DEBUG)
    for mt in (0, 1, 2, 3, 4):
        jlog.HAVC_LogMessage(jlog.MessageType(mt), "a", 1, 2.5)
        tlog.HAVC_LogMessage(tlog.MessageType(mt), "a", 1, 2.5)
    want = [(r.levelno, r.getMessage()) for r in caplog.records if r.name == "havc_tpu"]
    got = [(r.levelno, r.getMessage()) for r in caplog.records if r.name == "havc_tpu_torch"]
    assert got == want and got[0] == (logging.DEBUG, "a 1 2.5")
    assert tlog.get_logger().name == "havc_tpu_torch"
    with pytest.raises(havc_tpu_torch.HAVCError, match="x 3"):
        havc_tpu_torch.HAVC_LogMessage(havc_tpu_torch.MessageType.EXCEPTION, "x", 3)
    # the all-refs refusal is the same class
    assert tallrefs.HAVCError is havc_tpu_torch.HAVCError is tlog.HAVCError
    with pytest.raises(havc_tpu_torch.HAVCError, match="at least 2"):
        tallrefs.allrefs_feed_schedule(np.array([1, 0, 0, 0, 0, 0], np.int8))


# --- the legacy wrappers ----------------------------------------------------------------------

LEGACY = ("ddeoldify", "ddeoldify_main", "ddeoldify_stabilizer", "vs_frame_interpolation",
          "disable_warnings", "HAVC_ddeoldify", "HAVC_cmnet")


def _signatures(package):
    tree = ast.parse(open(os.path.join(REPO, package, "api.py")).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in LEGACY:
            a = node.args
            pos = a.posonlyargs + a.args
            defaults = {arg.arg: ast.unparse(d) for arg, d in
                        zip(pos[len(pos) - len(a.defaults):], a.defaults)}
            out[node.name] = ([x.arg for x in pos + a.kwonlyargs], defaults)
    return out


def test_legacy_signatures():
    """The wrappers outside ``HAVC_*`` take the JAX package's parameters in
    its order with its defaults, plus ``device`` where they compute."""
    want, got = _signatures("havc_tpu"), _signatures("havc_tpu_torch")
    assert set(want) == set(got) == set(LEGACY)
    for name, (names, defaults) in want.items():
        extra = [] if name == "disable_warnings" else ["device"]
        assert got[name][0] == names + extra, name
        assert {k: v for k, v in got[name][1].items() if k != "device"} == defaults, name


LEGACY_RUNS = {
    "HAVC_ddeoldify": dict(method=2, sc_threshold=0.1),
    "ddeoldify": dict(method=0, ddtweak=True),
    "ddeoldify_main": dict(),
    "ddeoldify_stabilizer": dict(dark=True, smooth=True, stab=True),
}
TARGETS = {
    "HAVC_ddeoldify": lambda clip, **kw: tapi.HAVC_colorizer(
        clip, method=2, sc_threshold=0.1, cmc_p=[0.2] + list(tapi.DEF_CMC_p[1:]), **kw),
    "ddeoldify": lambda clip, **kw: tapi.HAVC_colorizer(
        clip, method=0, ddtweak=(True, False, False), cmc_p=[0.2] + list(tapi.DEF_CMC_p[1:]),
        **kw),
    "ddeoldify_main": lambda clip, **kw: tapi.HAVC_main(
        clip, Preset="Fast", ColorFix="Violet/Red", **kw),
    "ddeoldify_stabilizer": lambda clip, **kw: tapi.HAVC_stabilizer(
        clip, dark=True, smooth=True, stab=True, **kw),
}


@pytest.mark.parametrize("name", LEGACY_RUNS.keys())
def test_legacy_wrappers(name, exemplar_both):
    """Each wrapper warns, equals the call it forwards to bit for bit, and
    the JAX package's wrapper within 1e-4."""
    frames = colored_clip()[:6] if name == "ddeoldify_stabilizer" else gray_clip()[:6]
    kw = dict(LEGACY_RUNS[name], batch_size=4)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        want = getattr(havc_tpu.api, name)(JClip(frames=frames.copy()), **kw)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = getattr(havc_tpu_torch, name)(havc_tpu_torch.Clip(frames=frames.copy()),
                                            device="cpu", **kw)
    target = TARGETS[name](havc_tpu_torch.Clip(frames=frames.copy()), batch_size=4, device="cpu")
    np.testing.assert_array_equal(got.frames, target.frames)
    close(want.frames, got.frames, TOL)


def test_cmnet_and_frame_interpolation_forward(exemplar_both):
    """``HAVC_cmnet`` is ``HAVC_deepex`` with ``ex_model=0`` and
    ``vs_frame_interpolation`` the FrameInterp interpolator, bit for bit."""
    gray = havc_tpu_torch.Clip(frames=gray_clip())
    ref = havc_tpu_torch.Clip(frames=colored_clip(),
                              sc=havc_tpu_torch.SceneFlags.from_frame_list(12, [0, 4, 8]))
    got = havc_tpu_torch.HAVC_cmnet(gray, ref, device="cpu", render_speed="fast")
    want = havc_tpu_torch.HAVC_deepex(gray, ref, ex_model=0, render_speed="fast", device="cpu")
    np.testing.assert_array_equal(got.frames, want.frames)
    got = tapi.vs_frame_interpolation(gray, ref, 5, process_id=2, batch_size=4, device="cpu")
    want = tapi._frame_interpolation(gray, ref, 5, "none", 2, 4, device="cpu")
    np.testing.assert_array_equal(got.frames, want.frames)
    assert got.frames.shape == gray.frames.shape


def test_disable_warnings():
    with warnings.catch_warnings():
        levels = {m: logging.getLogger(m).level for m in ("torch", "PIL", "numpy", "matplotlib")}
        try:
            havc_tpu_torch.disable_warnings()
            assert all(logging.getLogger(m).level == logging.ERROR for m in levels)
            warnings.warn("hidden", DeprecationWarning)  # filtered: no error under -W error
        finally:
            for m, lv in levels.items():
                logging.getLogger(m).setLevel(lv)


def test_legacy_defaults_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    clip = havc_tpu_torch.Clip(frames=rgb(t=2))
    for call in (lambda: havc_tpu_torch.HAVC_degrain(clip),
                 lambda: havc_tpu_torch.HAVC_clip_overlay(clip, clip),
                 lambda: tmetrics.compare_clip(clip.frames, clip.frames)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.warns(DeprecationWarning), pytest.raises(RuntimeError, match="device='cpu'"):
        havc_tpu_torch.ddeoldify_stabilizer(clip)
    assert jax.devices()[0].platform == "cpu"
