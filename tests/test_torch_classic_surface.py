"""The port's classic-surface filters and entry points against
``havc_tpu`` on the CPU, and the signature parity of the two APIs.

Every function runs in both packages on the same seeded numpy clip
(``device="cpu"`` in the port).  Tolerance: 1e-5 max abs for single ops
(merge method 6, ``HAVC_TimeCube``, tweaks, tiles), 1e-4 for the filter
chains that include the retinex (see tests/test_torch_retinex_lut_tiles.py
for why).  The BW tune's histogram bins are computed from the same input
values in both packages, so none can differ; the luma gates' frame means
lie far from their bounds on these clips.
"""
import ast
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import havc_tpu
from havc_tpu import api as japi
from havc_tpu.clip import Clip as JClip
from havc_tpu.ops import chroma as jchroma
from havc_tpu.ops import merge as jmerge

import havc_tpu_torch
from havc_tpu_torch import api as tapi
from havc_tpu_torch.ops import chroma as tchroma
from havc_tpu_torch.ops import merge as tmerge

from test_torch_deepex_surface import deepex_engines  # noqa: F401  (fixture)
from test_torch_exemplar_surface import (  # noqa: F401  (fixtures)
    colored_clip, colormnet_both, exemplar_both, gray_clip, seeded_colormnet)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
CHAIN_TOL = 1e-4


def _clip(t=3, h=40, w=56, seed=0, gray=False):
    """A mid, a dark and a bright frame of a smooth field with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.25 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    frames = []
    for i, (lo, gain) in enumerate([(0.0, 1.0), (-0.35, 0.4), (0.15, 1.0)][:t]):
        f = np.clip(lo + gain * base[..., None] + 0.1 * rng.random((h, w, 3)), 0, 1)
        frames.append(f)
    out = np.stack(frames).astype(np.float32)
    if gray:
        out = np.repeat(out.mean(-1, keepdims=True), 3, axis=-1)
    return out


def _close(want, got, tol=TOL):
    want = np.asarray(want.frames if hasattr(want, "frames") else want)
    got = got.frames if hasattr(got, "frames") else got
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _both(name, frames, *args, tol=TOL, **kw):
    want = getattr(havc_tpu, name)(JClip(frames=frames.copy()), *args, **kw)
    got = getattr(havc_tpu_torch, name)(havc_tpu_torch.Clip(frames=frames.copy()), *args,
                                        device="cpu", **kw)
    assert isinstance(got.frames, np.ndarray)
    _close(want, got, tol)
    return got


# --- merge method 6 -----------------------------------------------------------------


@pytest.mark.parametrize("algo", [0, 1, 2])
@pytest.mark.parametrize("kw", [dict(), dict(chroma_resize=True), dict(mask_weight=0.3, sat=1.2),
                                dict(mask_weight=-0.2, alpha=3.0)])
def test_chroma_retention_merge(algo, kw):
    gray = _clip(seed=1, gray=True)
    gray = 0.9 * gray + 0.1 * _clip(seed=3)  # a little color, some pixels under tht
    color = _clip(seed=2)
    args = dict(algo=algo, **kw)
    _close(jmerge.chroma_retention_merge(jnp.asarray(gray), jnp.asarray(color), **args),
           tmerge.chroma_retention_merge(torch.from_numpy(gray), torch.from_numpy(color), **args))


@pytest.mark.parametrize("kw", [dict(binary_mask=True), dict(return_mask=True),
                                dict(return_mask=True, chroma_resize=True, algo=2)])
def test_chroma_retention_merge_binary_and_mask(kw):
    gray, color = _clip(seed=1, gray=True), _clip(seed=2)
    _close(jmerge.chroma_retention_merge(jnp.asarray(gray), jnp.asarray(color), **kw),
           tmerge.chroma_retention_merge(torch.from_numpy(gray), torch.from_numpy(color), **kw))


@pytest.mark.parametrize("tht,algo", [(15, 0), (30, 1), (30, 2), (200, 1), (0, 2)])
def test_gradient_mask(tht, algo):
    s = np.linspace(0.0, 1.0, 1001, dtype=np.float32)
    _close(jchroma.gradient_mask(jnp.asarray(s), tht, 2.0, algo),
           tchroma.gradient_mask(torch.from_numpy(s), tht, 2.0, algo))


def test_combine_models_method_6():
    a, b = _clip(seed=4), _clip(seed=5)
    crt = [0.8, 30, 2, True, 0.2, 1]
    _close(jmerge.combine_models(jnp.asarray(a), jnp.asarray(b), method=6, b_weight=0.4,
                                 crt_p=crt),
           tmerge.combine_models(torch.from_numpy(a), torch.from_numpy(b), method=6, b_weight=0.4,
                                 crt_p=crt))


# --- filter entry points ------------------------------------------------------------


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("tune", ["Light", "Strong"])
def test_bw_tune_modes(mode, tune):
    _both("HAVC_bw_tune", _clip(seed=6, gray=True), tune, mode,
          tol=CHAIN_TOL if mode >= 5 else TOL)


def test_bw_tune_chroma_resize_and_none():
    """With ``chroma_resize`` the tune runs on spline64-resized frames,
    which the two packages compute 1.8e-7 apart (matrix products summed in
    another order): a resized value that lands within that of a bin edge
    goes to the neighbouring bin, which moves its CLAHE tile's LUT by
    about 1/1024 over a range of bins.  On this clip that touches 0.83 % of
    the output values, by at most 2.1e-4.  Bound: at most 2 % of the values
    more than 1e-5 apart, none more than 1e-3; the tune itself on the same
    resized input holds 1e-5."""
    from havc_tpu.ops.resize import resize as jresize

    frames = _clip(t=2, h=48, w=640, seed=7)
    want = np.asarray(havc_tpu.HAVC_bw_tune(JClip(frames=frames.copy()), "Medium", 2,
                                            chroma_resize=True).frames)
    got = havc_tpu_torch.HAVC_bw_tune(havc_tpu_torch.Clip(frames=frames.copy()), "Medium", 2,
                                      chroma_resize=True, device="cpu").frames
    diff = np.abs(got - want)
    assert np.mean(diff > TOL) <= 0.02 and diff.max() <= 1e-3, (np.mean(diff > TOL), diff.max())
    work = np.array(jresize(jnp.asarray(frames), 256, 256, "spline64"))
    _close(japi.bw_tune_frames(jnp.asarray(work), 2, 2), tapi.bw_tune_frames(
        torch.from_numpy(work), 2, 2))
    got = havc_tpu_torch.HAVC_bw_tune(havc_tpu_torch.Clip(frames=frames), "None", device="cpu")
    assert got.frames is frames


@pytest.mark.parametrize("lut_effect,strength", [(0, 1.0), (2, 0.8), (8, 0.4), (8, 1.0),
                                                 ("flat_pop", 0.6), (1, 0.0)])
def test_timecube(lut_effect, strength):
    """Built-in looks with their tweak; Amber_Light (8) below strength 1
    merges through the ChromaBound merge (method 7)."""
    _both("HAVC_TimeCube", _clip(seed=8), strength, lut_effect)


def test_timecube_factors_and_cube(tmp_path):
    from havc_tpu_torch.ops import lut3d

    _both("HAVC_TimeCube", _clip(seed=9), 0.7, 4, factors=(5.0, 0.9, 2.0, 1.0, 1.0))
    lattice = lut3d.make_look_lut("vintage_fox", size=9)
    path = tmp_path / "v.cube"
    with open(path, "w") as f:
        f.write("LUT_3D_SIZE 9\n")
        for b in range(9):
            for g in range(9):
                for r in range(9):
                    f.write("%.7f %.7f %.7f\n" % tuple(lattice[r, g, b]))
    _both("HAVC_TimeCube", _clip(seed=9), 1.0, str(path))


@pytest.mark.parametrize("name,args,kw,tol", [
    ("HAVC_auto_levels", ("Medium", 0), {}, TOL),
    ("HAVC_auto_levels", ("Light", 4), dict(luma_blend=True), TOL),
    ("HAVC_auto_levels", ("Strong", 5), dict(range_tv=False), CHAIN_TOL),
    ("HAVC_retinex", (), {}, CHAIN_TOL),
    ("HAVC_retinex", (), dict(blend=True, fast_mode=False), CHAIN_TOL),
    ("HAVC_retinex", (), dict(strength=0.5), CHAIN_TOL),
    ("HAVC_rgb_denoise", (), {}, TOL),
    ("HAVC_adjust_rgb", (), dict(strength=0.5, factor=(1.1, 1.0, 0.9), gamma=(1.0, 0.95, 1.0)),
     TOL),
    ("HAVC_tweak", (), dict(hue=10, sat=1.05, cont=0.9, gamma=0.98, bright=-1 / 255), TOL),
])
def test_filter_entry_points(name, args, kw, tol):
    _both(name, _clip(seed=10), *args, tol=tol, **kw)


@pytest.mark.parametrize("method", [0, 1, 2, 3, 6, 7])
def test_merge_with_luma(method):
    a, b, lum = _clip(seed=11), _clip(seed=12), _clip(seed=13, gray=True)
    kw = dict(weight=0.4, method=method)
    want = havc_tpu.HAVC_merge(JClip(frames=a), JClip(frames=b), JClip(frames=lum), **kw)
    got = havc_tpu_torch.HAVC_merge(havc_tpu_torch.Clip(frames=a), havc_tpu_torch.Clip(frames=b),
                                    havc_tpu_torch.Clip(frames=lum), device="cpu", **kw)
    _close(want, got)


@pytest.mark.parametrize("kw", [dict(), dict(algo=2, chroma_resize=False), dict(binary_mask=True),
                                dict(return_mask=True)])
def test_recover_clip_color(kw):
    a, b = _clip(seed=14, gray=True), _clip(seed=15)
    want = havc_tpu.HAVC_recover_clip_color(JClip(frames=a), JClip(frames=b), **kw)
    got = havc_tpu_torch.HAVC_recover_clip_color(havc_tpu_torch.Clip(frames=a),
                                                 havc_tpu_torch.Clip(frames=b), device="cpu", **kw)
    _close(want, got)


@pytest.mark.parametrize("slices", [2, 4])
def test_clip_slice_reconstruct(slices):
    frames = _clip(h=68, w=120, seed=16)
    jt = havc_tpu.HAVC_clip_slice(JClip(frames=frames), slices, 32, 20)
    tt = havc_tpu_torch.HAVC_clip_slice(havc_tpu_torch.Clip(frames=frames), slices, 32, 20,
                                        device="cpu")
    assert len(tt) == len(jt) == slices and tt.meta == jt.meta
    assert (tt.overlap_x, tt.overlap_y) == (jt.overlap_x, jt.overlap_y)
    assert np.array_equal(tt.tiles_clip.frames, np.asarray(jt.tiles_clip.frames))
    for tile_j, tile_t in zip(jt.tiles, tt.tiles):
        assert np.array_equal(tile_t.frames, np.asarray(tile_j.frames))
    proc = np.clip(np.asarray(jt.tiles_clip.frames) * 1.1, 0, 1).astype(np.float32)
    for cr in (False, True):
        want = havc_tpu.HAVC_clip_reconstruct(jt.with_tiles(JClip(frames=proc)), chroma_resize=cr)
        got = havc_tpu_torch.HAVC_clip_reconstruct(
            tt.with_tiles(havc_tpu_torch.Clip(frames=proc)), chroma_resize=cr, device="cpu")
        _close(want, got)


@pytest.mark.parametrize("tune,mode", [("Light", 0), ("Medium", 2), ("Strong", 4), ("Light", 5)])
def test_main_restore_bw_tune(tune, mode):
    frames = _clip(seed=17)
    kw = dict(BlackWhiteTune=tune, BlackWhiteMode=mode)
    want = havc_tpu.api.HAVC_main_restore(JClip(frames=frames), **kw)
    got = tapi.HAVC_main_restore(havc_tpu_torch.Clip(frames=frames), device="cpu", **kw)
    _close(want, got, CHAIN_TOL if mode == 5 else TOL)


@pytest.mark.parametrize("tune,mode", [("Light", 4), ("Medium", 4), ("Strong", 4), ("Light", 6),
                                       ("Medium", 6), ("Strong", 6), ("Medium", 1), ("None", 0)])
def test_color_adjust(tune, mode):
    """The BW tune and the BlackWhiteMode 4/6 film-LUT remaps."""
    frames = _clip(seed=18)
    kw = dict(BlackWhiteTune=tune, BlackWhiteMode=mode, ReColor=False)
    want = havc_tpu.api.HAVC_ColorAdjust(JClip(frames=frames), **kw)
    got = tapi.HAVC_ColorAdjust(havc_tpu_torch.Clip(frames=frames), device="cpu", **kw)
    _close(want, got)


def test_unported_restore_options_raise(deepex_engines):
    """A re-color by DeepEx is ported: ``HAVC_main_restore(clip_colored=...,
    DeepExModel=1)`` against the JAX package's (DeepEx at temperature
    1e-10, a hard argmax: at most 2 % of the values more than 1e-4 apart,
    none more than 0.02; tests/test_torch_deepex_surface.py's engines)."""
    gray, colored = gray_clip(), colored_clip()
    want = havc_tpu.api.HAVC_main_restore(JClip(frames=gray.copy()),
                                          JClip(frames=colored.copy()), DeepExModel=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # as tests/test_torch_streaming.py's workers do
    try:
        got = tapi.HAVC_main_restore(havc_tpu_torch.Clip(frames=gray.copy()),
                                     havc_tpu_torch.Clip(frames=colored.copy()), DeepExModel=1,
                                     device="cpu")
    finally:
        torch.set_num_threads(threads)
    d = np.abs(got.frames - np.asarray(want.frames))
    assert got.frames.shape == gray.shape
    assert np.mean(d > 1e-4) <= 0.02 and d.max() <= 0.02, (np.mean(d > 1e-4), d.max())


def test_setters_change_the_shared_packs():
    from havc_tpu_torch import engines as tengines
    from havc_tpu_torch.ops import merge as tm

    tweak0, crt0 = list(tengines.DEF_TWEAK_p), list(tm.DEF_CRT_p)
    try:
        out = tapi.HAVC_set_tweak_params(gamma=2.0, luma_min=0.25)
        assert out == tengines.DEF_TWEAK_p and out[2] == 2.0 and out[4] == 0.25
        assert tapi.HAVC_set_tweak_params(list(tweak0)) == tweak0
        got = tapi.HAVC_set_merge_params(6, [0.7, 25, 2, True, 0.1, 2])
        assert tm.DEF_CRT_p == [0.7, 25, 2, True, 0.1, 2] and got["crt"] == tm.DEF_CRT_p
        with pytest.raises(ValueError):
            tapi.HAVC_set_merge_params(9, [1])
    finally:
        tengines.DEF_TWEAK_p[:] = tweak0
        tm.DEF_CRT_p[:] = crt0


# --- signature parity ----------------------------------------------------------------

# public HAVC_* functions of havc_tpu the port does not have yet, by ROADMAP item
NOT_PORTED = {}
# the ones that compute nothing, so take no ``device``: the setters and the
# export helpers (they write frames that are already flagged or listed)
NO_DEVICE = ("HAVC_set_", "HAVC_export_")
MODULES = ("api.py", "streaming.py", os.path.join("exemplar", "__init__.py"))


def _functions(package):
    """name -> (parameter names, {name: default}) of the public HAVC_*
    functions of a package's api, streaming and exemplar modules (the
    fullest definition where one delegates to another)."""
    out = {}
    for mod in MODULES:
        tree = ast.parse(open(os.path.join(REPO, package, mod)).read())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.FunctionDef) and node.name.startswith("HAVC_")):
                continue
            a = node.args
            names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
            pos = a.posonlyargs + a.args
            defaults = {}
            for arg, d in list(zip(pos[len(pos) - len(a.defaults):], a.defaults)) + [
                    (k, d) for k, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]:
                try:
                    defaults[arg.arg] = ast.literal_eval(d)
                except ValueError:
                    defaults[arg.arg] = ast.unparse(d)
            if node.name not in out or len(names) > len(out[node.name][0]):
                out[node.name] = (names, defaults)
    return out


def test_api_signature_parity():
    """Every public HAVC_* function of the port accepts every parameter of
    its havc_tpu counterpart with the same default, plus ``device`` (default
    None) where it computes (``NO_DEVICE`` do not); the ones it lacks are
    exactly ``NOT_PORTED``, now none."""
    jax_f, port_f = _functions("havc_tpu"), _functions("havc_tpu_torch")
    assert sorted(set(jax_f) - set(port_f)) == sorted(NOT_PORTED)
    assert not set(port_f) - set(jax_f)
    for name, (port_names, port_defaults) in port_f.items():
        jax_names, jax_defaults = jax_f[name]
        if jax_names == ["args", "kwargs"]:
            continue
        assert set(jax_names) <= set(port_names), (name, set(jax_names) - set(port_names))
        assert set(port_names) - set(jax_names) <= {"device"}, name
        for k, v in jax_defaults.items():
            assert port_defaults.get(k) == v, (name, k)
        if not name.startswith(NO_DEVICE):
            assert port_defaults.get("device") is None and "device" in port_names, name


# --- the whole surface, module by module ----------------------------------------------

# public functions and classes of havc_tpu that the port has no counterpart
# for, as "<module file>:<name>" ("*": the whole module); ROADMAP.md lists
# the same set under "JAX-only functions that get no counterpart"
JAX_ONLY = {
    "utils/jitcache.py:*",  # XLA's compile cache
    "models/ddcolor.py:init_params", "models/deoldify.py:init_params",
    "models/remaster.py:init_params", "models/zhang.py:init_params",
    "models/deepex.py:init_deepex_params",  # flax init; the port seeds its modules
    "models/layers.py:PtConv", "models/layers.py:PtConvTranspose",
    "models/layers.py:resize_bilinear", "models/layers.py:leaky_relu",
    "models/vit.py:torch_bicubic_resize", "models/vit.py:torch_bilinear_resize",
    "models/colormnet.py:readout",
    "ops/pallas_kernels.py:*",  # counterpart: ops/post_chain.py
    "ops/pallas_attn.py:*",  # counterpart: ops/window_attn.py
}
# where the signatures are compared as well (name -> skipped JAX parameters)
SIGNATURE_MODULES = ("models/convert.py", "parallel/mesh.py", "parallel/halo.py")
SIGNATURE_FUNCTIONS = {"exemplar/__init__.py:colormnet_propagate_scenes": {"device_out"}}


def _public_defs(package):
    """{module file: {public module-level function or class name: node}}."""
    out = {}
    root = os.path.join(REPO, package)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                tree = ast.parse(open(os.path.join(d, f)).read())
                out[rel] = {n.name: n for n in tree.body
                            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                            and not n.name.startswith("_")}
    return out


def _signature(node, skip=()):
    a = node.args
    pos = a.posonlyargs + a.args
    defaults = dict(zip([x.arg for x in pos[len(pos) - len(a.defaults):]], a.defaults))
    defaults.update({k.arg: d for k, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None})
    return [(x.arg, ast.unparse(defaults[x.arg]) if x.arg in defaults else None)
            for x in pos + a.kwonlyargs if x.arg not in skip]


def test_every_public_function_has_a_counterpart():
    """Every public module-level function and class of havc_tpu exists in
    the same module of the port (defined or imported there), or stands in
    ``JAX_ONLY``, which holds nothing the port has; ROADMAP.md's JAX-only
    list is the same set."""
    import importlib

    missing = set()
    for mod, names in _public_defs("havc_tpu").items():
        dotted = "havc_tpu_torch." + mod[:-3].replace("/", ".").removesuffix(".__init__")
        try:
            port = importlib.import_module(dotted)
        except ModuleNotFoundError:
            missing.add(f"{mod}:*")
            continue
        missing |= {f"{mod}:{n}" for n in names if not hasattr(port, n)}
    assert missing == JAX_ONLY
    roadmap = open(os.path.join(REPO, "ROADMAP.md")).read()
    section = roadmap.split("JAX-only functions that get no counterpart")[1].split("\n#")[0]
    listed = set(re.findall(r"`([\w/]+\.py:[\w*]+)`", section))
    assert listed == JAX_ONLY


def test_signature_parity_of_this_slice():
    """``models/convert``, ``parallel/mesh`` and ``parallel/halo`` keep the
    JAX package's parameter names, order and defaults, and so does
    ``colormnet_propagate_scenes`` (without ``device_out``: the port
    returns a tensor on the engine's device)."""
    jax_defs, port_defs = _public_defs("havc_tpu"), _public_defs("havc_tpu_torch")
    pairs = [(f"{m}:{n}", node, ()) for m in SIGNATURE_MODULES
             for n, node in jax_defs[m].items() if isinstance(node, ast.FunctionDef)]
    for key, skip in SIGNATURE_FUNCTIONS.items():
        m, n = key.split(":")
        pairs.append((key, jax_defs[m][n], skip))
    assert len(pairs) == 24 + 6 + 2 + 1
    for key, jnode, skip in pairs:
        m, n = key.split(":")
        assert _signature(port_defs[m][n]) == _signature(jnode, skip), key
