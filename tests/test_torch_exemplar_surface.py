"""The rest of the port's ColorMNet exemplar surface against the JAX
package's, on the CPU: ref-merge, ``HAVC_restore_video`` and the restore
entry points (``HAVC_main_restore(clip_colored=...)``,
``HAVC_ColorAdjust`` with ReColor or ``clip_ref``).

Both packages run with the same weights, carried over with
``state_dict_from_flax``: the micro ColorMNet (the flax modules of
tests/test_torch_exemplar.py), and for the paths through the classic
colorizer nano DeOldify Video and micro DDColor Artistic, their factories
at render factor 4 (``exemplar_both``, used by
tests/test_torch_exemplar_main.py).  The weights are seeded with numpy at
the shapes ``jax.eval_shape`` gives (``seeded_params``), so no flax
``init`` is compiled: each module that uses them starts in seconds.  The
SmartResize work size of every render speed is cut to 40x64 in both
packages (a 112x112 ColorMNet engine) so the propagation stays cheap; the
code paths are the published ones.  The ``colormnet_both`` fixture (and
``exemplar_both``, which adds the classic engines) sets this up once per
module and keeps the JAX package's compiled functions for the module's
tests (they close over nothing test-specific: the parameters are
arguments).

Tolerance: 1e-4 on the output frames, as for the exemplar path (float32
convolutions and matrix products summed in another order).  No path here
has a CLAHE, a hue-range mask or a colormap after the propagation.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import havc_tpu
import havc_tpu.engines as jengines
from havc_tpu import exemplar as jex
from havc_tpu.clip import Clip as JClip
from havc_tpu.clip import SceneFlags as JFlags
from havc_tpu.models import ddcolor as jdd
from havc_tpu.models import deoldify as jdo
from havc_tpu.utils import jitcache

import havc_tpu_torch
import havc_tpu_torch.engines as tengines
from havc_tpu_torch import exemplar as tex
from havc_tpu_torch.models import colormnet as tcm
from havc_tpu_torch.models import ddcolor as tdd
from havc_tpu_torch.models import deoldify as tdo
from havc_tpu_torch.models.bridge import state_dict_from_flax

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_exemplar import _GROUPS, JM, _scene_clip

TOL = 1e-4
CPU = torch.device("cpu")
WORK = (40, 64)  # the SmartResize work size of every render speed in these tests
T = 12  # frames of every test clip (the JAX scans compile once per length)
_JaxEngine = jex.ColorMNetEngine


def seeded_params(module, seed, *args):
    """Parameters of a flax ``module`` without compiling its ``init``: the
    shapes from ``jax.eval_shape``, the values seeded with numpy by each
    leaf's role (kernels at fan-in scale, scales and variances near 1,
    biases and means near 0, DeOldify's attention gate at 0.3)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def leaf(name, sd):
        n = sd.shape
        if name == "kernel":
            v = rng.standard_normal(n) / math.sqrt(max(math.prod(n[:-1]), 1))
        elif name in ("scale", "bn_scale", "var", "bn_var", "temperature", "ls1_gamma",
                      "ls2_gamma"):
            v = rng.uniform(0.8, 1.2, n)
        elif name == "gamma":
            v = np.full(n, 0.3)
        elif name in ("bias", "bn_bias", "mean", "bn_mean"):
            v = 0.05 * rng.standard_normal(n)
        else:  # tokens, position and query embeddings
            v = 0.02 * rng.standard_normal(n)
        return v.astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in node.items()}

    return walk(dict(shapes))


@pytest.fixture(scope="module")
def seeded_colormnet():
    """The micro ColorMNet's tree (``seeded_params``, group by group at the
    shapes the JAX engine initialises) and the port's network carrying it."""
    x = jnp.zeros((1, 32, 32, 3))
    tree = {"key_encoder": seeded_params(JM["key_encoder"], 11, x)}
    g16, g8, g4 = jax.eval_shape(JM["key_encoder"].apply, {"params": tree["key_encoder"]}, x)
    hidden = jnp.zeros((2,) + g16.shape[1:3] + (8,))
    tree["key_proj"] = seeded_params(JM["key_proj"], 12, g16)
    tree["value_encoder"] = seeded_params(JM["value_encoder"], 13, x, g16, hidden,
                                          jnp.zeros((1, 2, 32, 32)))
    tree["decoder"] = seeded_params(JM["decoder"], 14, g16, g8, g4, hidden,
                                    jnp.zeros((2,) + g16.shape[1:3] + (16,)))
    k, v = jnp.zeros((1,) + g16.shape[1:3] + (8,)), jnp.zeros((1,) + g16.shape[1:3] + (32,))
    tree["short_term_attn"] = seeded_params(JM["short_term_attn"], 15, k, k, v)
    net = tcm.ColorMNet("micro")
    net.load_state_dict(state_dict_from_flax(tree))
    return tree, net.eval().requires_grad_(False)


class _SeededEngine(_JaxEngine):
    """The JAX package's micro engine with the shared tree for parameters."""

    def __init__(self, tree, config="micro", work_size=(224, 384), max_mem=0):
        self._tree = tree
        super().__init__(config=config, work_size=work_size, max_mem=max_mem)

    def _init_params(self, seed):
        for group, attr in _GROUPS:
            setattr(self, attr, {"params": self._tree[group]})
        self.g16_hw = (self.h // 16, self.w // 16)


@pytest.fixture(scope="module")
def colormnet_both(seeded_colormnet):
    """Both packages' ColorMNet swapped for the seeded micro one at the cut
    work size, for the whole module; the JAX compile cache kept across its
    tests."""
    tree, net = seeded_colormnet
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitcache, "_CACHE", {})
        mp.setattr(jex, "_ENGINE_CACHE", {})
        mp.setattr(jex, "ColorMNetEngine", lambda **kw: _SeededEngine(tree, **kw))
        mp.setattr(jex, "smart_resize_shape", lambda width, height, speed="medium": WORK)
        mp.setitem(tengines.registry._cache, ("colormnet", "micro", CPU), net)
        mp.setattr(tex, "_ENGINE_CACHE", {})
        mp.setattr(tex, "smart_resize_shape", lambda width, height, speed="medium": WORK)
        yield


def _carry(jmodel, tmodel, seed):
    params = seeded_params(jmodel, seed, jnp.zeros((1, 64, 64, 3)))
    tmodel.load_state_dict(state_dict_from_flax(params))
    return (jmodel, {"params": params}), tmodel.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def exemplar_both(colormnet_both):
    """``colormnet_both`` and the classic engines (nano DeOldify Video,
    micro DDColor Artistic, at render factor 4) in both packages."""
    j_do_m, tm_do = _carry(jdo.DeOldifyWide(encoder="nano", nf_factor=1),
                           tdo.DeOldifyWide(encoder="nano", nf_factor=1), 16)
    j_dd_m, tm_dd = _carry(jdd.DDColor.from_config("micro"), tdd.DDColor.from_config("micro"), 17)
    j_do, j_dd = jengines.make_deoldify_fn, jengines.make_ddcolor_fn
    t_do, t_dd = tengines.make_deoldify_fn, tengines.make_ddcolor_fn
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jengines.registry._cache, ("deoldify", "video"), j_do_m)
        mp.setitem(jengines.registry._cache, ("ddcolor", "artistic"), j_dd_m)
        mp.setattr(jengines, "make_deoldify_fn",
                   lambda model=0, render_factor=24: j_do(model, 4))
        mp.setattr(jengines, "make_ddcolor_fn",
                   lambda model=1, render_factor=24, **kw: j_dd(model, 4, **kw))
        mp.setitem(tengines.registry._cache, ("deoldify", "video", CPU), tm_do)
        mp.setitem(tengines.registry._cache, ("ddcolor", "artistic", CPU), tm_dd)
        mp.setattr(tengines, "make_deoldify_fn",
                   lambda model=0, render_factor=24, **kw: t_do(model, 4, **kw))
        mp.setattr(tengines, "make_ddcolor_fn",
                   lambda model=1, render_factor=24, **kw: t_dd(model, 4, **kw))
        yield


def gray_clip(seed=3, h=48, w=64):
    """T gray frames in three scenes of 4 (cuts [0, 4, 8])."""
    return _scene_clip(n_scenes=3, per=T // 3, h=h, w=w, seed=seed)


def colored_clip(seed=4, h=48, w=64, t=T):
    """A colored counterpart of ``gray_clip``: each scene tinted by a
    smooth seeded per-channel gain field."""
    gray = _scene_clip(n_scenes=-(-t // 4), per=4, h=h, w=w, seed=seed)[:t]
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty_like(gray)
    for s in range(0, t, 4):
        a, b = rng.uniform(-0.35, 0.35, (2, 3)).astype(np.float32)
        gain = 1.0 + a * np.sin(xx / 11.0)[..., None] + b * np.cos(yy / 7.0)[..., None]
        out[s:s + 4] = np.clip(gray[s:s + 4] * gain, 0.0, 1.0)
    return out


def pair(frames, flags=None):
    """The same frames (and flags) as a JAX and a port clip."""
    j, t = JClip(frames=frames.copy()), havc_tpu_torch.Clip(frames=frames.copy())
    if flags is not None:
        j = j.with_sc(flags(JFlags))
        t = t.with_sc(flags(havc_tpu_torch.SceneFlags))
    return j, t


def check(want, got, tol=TOL):
    assert isinstance(got.frames, np.ndarray) and got.frames.shape == np.shape(want.frames)
    err = np.abs(got.frames - np.asarray(want.frames)).max()
    assert err <= tol, err
    if want.sc is not None:
        assert np.array_equal(want.sc.sc_prev, got.sc.sc_prev)


# --- ref-merge -----------------------------------------------------------------------


@pytest.mark.parametrize("ref_merge,ref_norm", [(1, False), (3, True), (5, True)])
def test_ref_merge_matches_jax(colormnet_both, ref_merge, ref_norm):
    """``HAVC_deepex`` with references at every frame: a separate scene
    detection of the video picks the propagation references, and the other
    frames are blended with theirs at ``REFMERGE_WEIGHT[ref_merge]``."""
    clip_j, clip_t = pair(gray_clip())
    ref_j, ref_t = pair(colored_clip(), lambda cls: cls.every(T, 1))
    kw = dict(ref_merge=ref_merge, ref_norm=ref_norm, dark=True, smooth=True)
    want = jex.HAVC_deepex(clip_j, ref_j, **kw)
    got = havc_tpu_torch.HAVC_deepex(clip_t, ref_t, device="cpu", **kw)
    check(want, got)
    # the blend moved the non-reference frames toward the reference
    plain = havc_tpu_torch.HAVC_deepex(clip_t, ref_t, device="cpu", dark=True, smooth=True)
    assert np.abs(plain.frames[1:4] - got.frames[1:4]).max() > 1e-3


# --- HAVC_restore_video --------------------------------------------------------------


@pytest.mark.parametrize("method,ref_merge,ref_shape", [
    (5, 0, None), (6, 0, None), (5, 4, None), (6, 0, (14, 60, 80)),
], ids=["method5", "method6", "method5_ref_merge", "other_size_and_length"])
def test_restore_video_matches_jax(colormnet_both, method, ref_merge, ref_shape):
    """A B&W clip re-colored from a colored one: trimmed to the shorter
    length, the reference Spline36-resized to the clip's size, its scene
    changes inserted as exemplars (with ref-merge: blended elsewhere)."""
    clip_j, clip_t = pair(gray_clip())
    colored = colored_clip() if ref_shape is None else colored_clip(
        seed=6, h=ref_shape[1], w=ref_shape[2], t=ref_shape[0])
    ref_j, ref_t = pair(colored)
    kw = dict(method=method, ref_merge=ref_merge)
    want = jex.HAVC_restore_video(clip_j, ref_j, **kw)
    got = havc_tpu_torch.HAVC_restore_video(clip_t, ref_t, device="cpu", **kw)
    check(want, got)
    assert got.sc.frequency == (1 if ref_merge else 0)


def test_deepex_methods_5_6_delegate_to_restore(colormnet_both):
    clip_j, clip_t = pair(gray_clip())
    ref_j, ref_t = pair(colored_clip())
    want = jex.HAVC_deepex(clip_j, ref_j, method=6)
    got = havc_tpu_torch.HAVC_deepex(clip_t, ref_t, method=6, device="cpu")
    check(want, got)


# --- the restore entry points ---------------------------------------------------------


def test_main_restore_clip_colored_matches_jax(colormnet_both):
    """``HAVC_main_restore(clip_colored=...)``: the re-color, then the
    light RGB adjust and tweak of its BlackWhiteTune."""
    clip_j, clip_t = pair(gray_clip())
    ref_j, ref_t = pair(colored_clip())
    want = havc_tpu.api.HAVC_main_restore(clip_j, ref_j)
    got = havc_tpu_torch.HAVC_main_restore(clip_t, ref_t, device="cpu")
    check(want, got)


def test_color_adjust_defaults_match_jax(colormnet_both):
    """``HAVC_ColorAdjust(clip)``: ReColor (the colorized clip re-colored
    from itself at references on every frame, ref-merge 5, normalised
    scene detection), then the Light adjust."""
    clip_j, clip_t = pair(colored_clip(seed=8))
    want = havc_tpu.api.HAVC_ColorAdjust(clip_j)
    got = havc_tpu_torch.HAVC_ColorAdjust(clip_t, device="cpu")
    check(want, got)


def test_color_adjust_clip_ref_matches_jax(colormnet_both):
    clip_j, clip_t = pair(gray_clip())
    ref_j, ref_t = pair(colored_clip())
    kw = dict(ReColor=False, Strength=2, BlackWhiteTune="Strong")
    want = havc_tpu.api.HAVC_ColorAdjust(clip_j, clip_ref=ref_j, **kw)
    got = havc_tpu_torch.HAVC_ColorAdjust(clip_t, clip_ref=ref_t, device="cpu", **kw)
    check(want, got)
