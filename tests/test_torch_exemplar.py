"""The port's ColorMNet exemplar path against the JAX package's.

Every module of the path is held to havc_tpu on the CPU with the same
weights (a micro ColorMNet tree initialised by flax, its BatchNorm
statistics, LayerScale gammas, temperatures and embeddings moved off
their init values, carried over with ``state_dict_from_flax``) and the
same numpy inputs:

* the networks (DINOv2 segmentor, key encoder and projection, value
  encoder, decoder, local attention) within 1e-4, at a geometry where
  ``KeyEncoder.fit`` and the ViT's input resize run (32x32) and one where
  they do not;
* the memory store (inserts, readouts, consolidation, eviction) on
  states with tied keys and usages and free slots: the same slots within
  1e-5;
* scene detection (flags equal), the SmartResize pad/restore (1e-5);
* ``colormnet_propagate`` with vivid and frame_propagate on and off
  (1e-4), chunked runs resumed from the returned state;
* ``HAVC_main(EnableDeepEx=True)`` end to end with nano DeOldify, micro
  DDColor and micro ColorMNet (1e-4).

Tolerances: float32 convolutions and matrix products sum in another
order in XLA and PyTorch; 1e-4 on model outputs, 1e-5 where only a few
terms are summed.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import havc_tpu
import havc_tpu.engines as jengines
from havc_tpu import exemplar as jex
from havc_tpu.clip import Clip as JClip
from havc_tpu.models import colormnet as jcm
from havc_tpu.models import ddcolor as jdd
from havc_tpu.models import deoldify as jdo
from havc_tpu.models import memory as jmem
from havc_tpu.models import vit as jvit
from havc_tpu.ops import resize as jresize
from havc_tpu.scene import detect as jdetect
from havc_tpu.utils import jitcache

import havc_tpu_torch
import havc_tpu_torch.engines as tengines
from havc_tpu_torch import exemplar as tex
from havc_tpu_torch.models import colormnet as tcm
from havc_tpu_torch.models import ddcolor as tdd
from havc_tpu_torch.models import deoldify as tdo
from havc_tpu_torch.models import memory as tmem
from havc_tpu_torch.models import vit as tvit
from havc_tpu_torch.models.bridge import state_dict_from_flax
from havc_tpu_torch.ops import resize as tresize
from havc_tpu_torch.scene import detect as tdetect

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

TOL = 1e-4
CPU = torch.device("cpu")
_MUL = ("scale", "var", "bn_scale", "bn_var", "temperature", "ls1_gamma", "ls2_gamma")
_ADD = ("bias", "mean", "bn_bias", "bn_mean", "cls_token")


def _perturb(tree, seed):
    """Move every leaf that flax initialises to a constant off it."""
    rng = np.random.default_rng(seed)

    def leaf(name, v):
        v = np.array(v, dtype=np.float32)
        if name in _MUL:
            return v * rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        if name in _ADD:
            return v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
        return v

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in node.items()}

    return walk(jax.tree_util.tree_map(np.asarray, dict(tree)))


_GROUPS = (("key_encoder", "p_key"), ("key_proj", "p_proj"), ("value_encoder", "p_value"),
           ("decoder", "p_dec"), ("short_term_attn", "p_attn"))


# the micro engine's flax modules (havc_tpu.exemplar.ColorMNetEngine)
JM = dict(key_encoder=jcm.KeyEncoder(resnet="nano", vit="nano"),
          key_proj=jcm.KeyProjection(key_dim=8),
          value_encoder=jcm.ValueEncoder(value_dim=16, hidden_dim=8, resnet="nano"),
          decoder=jcm.Decoder(value_dim=16, hidden_dim=8),
          short_term_attn=jcm.LocalAttention(d_qk=8, d_vu=32, use_pallas=False))


def _jit_apply(group):
    """``JM[group].apply`` jitted, built once per group: each input shape
    compiles once instead of dispatching op by op."""
    def apply(params, *args, **kw):
        return JM[group].apply({"params": params}, *args, **kw)

    return jax.jit(apply, static_argnames=("deep_update",))


_JIT_APPLY = {group: _jit_apply(group) for group, _ in _GROUPS}


def _apply(group, tree, *args, **kw):
    return _JIT_APPLY[group](tree[group], *args, **kw)


class _TreeEngine(jex.ColorMNetEngine):
    """The JAX package's micro engine with the given tree for parameters
    (instead of its own random init)."""

    def __init__(self, tree, work_size):
        self._tree = tree
        super().__init__(config="micro", work_size=work_size)

    def _init_params(self, seed):
        for group, attr in _GROUPS:
            setattr(self, attr, {"params": self._tree[group]})
        self.g16_hw = (self.h // 16, self.w // 16)


@pytest.fixture(scope="module")
def cm_tree():
    """The micro ColorMNet tree (perturbed) shared by both packages,
    initialised as the JAX engine initialises it."""
    rng = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 32, 32, 3))
    p = {"key_encoder": jax.jit(JM["key_encoder"].init)(rng, x)}
    g16, g8, g4 = _JIT_APPLY["key_encoder"](p["key_encoder"]["params"], x)
    hidden = jnp.zeros((2,) + g16.shape[1:3] + (8,))
    p["key_proj"] = jax.jit(JM["key_proj"].init)(rng, g16)
    p["value_encoder"] = jax.jit(JM["value_encoder"].init)(rng, x, g16, hidden,
                                                           jnp.zeros((1, 2, 32, 32)))
    p["decoder"] = jax.jit(JM["decoder"].init)(rng, g16, g8, g4, hidden,
                                               jnp.zeros((2,) + g16.shape[1:3] + (16,)))
    k, v = jnp.zeros((1,) + g16.shape[1:3] + (8,)), jnp.zeros((1,) + g16.shape[1:3] + (32,))
    p["short_term_attn"] = jax.jit(JM["short_term_attn"].init)(rng, k, k, v)
    return _perturb({g: t["params"] for g, t in p.items()}, 5)


@pytest.fixture(scope="module")
def cm_net(cm_tree):
    net = tcm.ColorMNet("micro")
    net.load_state_dict(state_dict_from_flax(cm_tree))
    return net.eval().requires_grad_(False)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _close(jax_nhwc, torch_nchw, tol=TOL):
    got = torch_nchw.detach().numpy().transpose(0, 2, 3, 1)
    want = np.asarray(jax_nhwc)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol, err


# --- networks ----------------------------------------------------------------------


def test_dino_segmentor_matches_jax():
    x = np.random.default_rng(0).random((2, 56, 84, 3), dtype=np.float32)
    jm = jvit.DinoSegmentor(vit_config="micro")
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    params = {"params": _perturb(params["params"], 3)}
    tm = tvit.DinoSegmentor("micro")
    tm.load_state_dict(state_dict_from_flax(params["params"]))
    with torch.no_grad():
        _close(jm.apply(params, jnp.asarray(x)), tm(_nchw(x)))


@pytest.mark.parametrize("hw", [(32, 32), (64, 96)], ids=["fit_resizes", "aligned"])
def test_key_encoder_and_projection_match_jax(cm_tree, cm_net, hw):
    x = np.random.default_rng(1).random((2,) + hw + (3,), dtype=np.float32)
    with torch.no_grad():
        jg = _apply("key_encoder", cm_tree, jnp.asarray(x))
        tg = cm_net.key_encoder(_nchw(x))
        for a, b in zip(jg, tg):
            _close(a, b)
        for a, b in zip(_apply("key_proj", cm_tree, jg[0]), cm_net.key_proj(_nchw(jg[0]))):
            _close(a, b)


@pytest.mark.parametrize("deep_update", [True, False])
@pytest.mark.parametrize("hw", [(32, 32), (64, 96)], ids=["fit_resizes", "aligned"])
def test_value_encoder_matches_jax(cm_tree, cm_net, hw, deep_update):
    rng = np.random.default_rng(2)
    x = rng.random((1,) + hw + (3,), dtype=np.float32)
    g16 = _apply("key_encoder", cm_tree, jnp.asarray(x))[0]
    hidden = rng.standard_normal((2,) + g16.shape[1:3] + (8,)).astype(np.float32)
    chroma = rng.uniform(-1, 1, (1, 2) + hw).astype(np.float32)
    jv, jh = _apply("value_encoder", cm_tree, jnp.asarray(x), g16, jnp.asarray(hidden),
                    jnp.asarray(chroma), deep_update=deep_update)
    with torch.no_grad():
        tv, th = cm_net.value_encoder(_nchw(x), _nchw(g16), _nchw(hidden),
                                      torch.from_numpy(chroma), deep_update=deep_update)
    _close(jv, tv)
    _close(jh, th)


@pytest.mark.parametrize("hw", [(32, 32), (64, 96)], ids=["fit_resizes", "aligned"])
def test_decoder_matches_jax(cm_tree, cm_net, hw):
    rng = np.random.default_rng(3)
    x = rng.random((1,) + hw + (3,), dtype=np.float32)
    g16, g8, g4 = _apply("key_encoder", cm_tree, jnp.asarray(x))
    hidden = rng.standard_normal((2,) + g16.shape[1:3] + (8,)).astype(np.float32)
    readout = rng.standard_normal((2,) + g16.shape[1:3] + (16,)).astype(np.float32)
    jh, jl = _apply("decoder", cm_tree, g16, g8, g4, jnp.asarray(hidden), jnp.asarray(readout))
    with torch.no_grad():
        th, tl = cm_net.decoder(_nchw(g16), _nchw(g8), _nchw(g4), _nchw(hidden), _nchw(readout))
    _close(jh, th)
    _close(jl, tl)


def test_local_attention_matches_jax(cm_tree, cm_net):
    rng = np.random.default_rng(4)
    q, k = (rng.standard_normal((1, 5, 9, 8)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, 5, 9, 32)).astype(np.float32)
    want = _apply("short_term_attn", cm_tree, *map(jnp.asarray, (q, k, v)))
    with torch.no_grad():
        _close(want, cm_net.short_term_attn(_nchw(q), _nchw(k), _nchw(v)))


# --- memory --------------------------------------------------------------------------

MEM_CFG = dict(key_dim=4, value_dim=8, tokens_per_frame=6, max_mt_frames=3, min_mt_frames=1,
               lt_capacity=16, num_prototypes=4, top_k=4)


def _mem_frames(n, seed):
    """Inserts with duplicated tokens and repeated frames, so that keys,
    similarities and usages tie."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        keys = rng.normal(size=(6, 4)).astype(np.float32)
        keys[3:] = keys[:3]  # tied tokens inside the frame
        sel = (rng.random((6, 4)) * 0.9 + 0.05).astype(np.float32)
        values = rng.normal(size=(2, 6, 8)).astype(np.float32)
        shrink = (1.0 + rng.random(6)).astype(np.float32)
        if i % 4 == 3:  # a repeat of the previous frame
            keys, sel, values, shrink = out[-1]
        out.append((keys, sel, values, shrink))
    return out


def _state_close(js, ts, tol=1e-5):
    for name in ("work_valid", "lt_valid", "work_stamp"):
        assert np.array_equal(np.asarray(getattr(js, name)), getattr(ts, name).numpy()), name
    assert int(js.next_stamp) == ts.next_stamp
    assert np.array_equal(np.asarray(js.work_valid), ts.host_valid)
    for name in ("work_keys", "work_shrink", "work_sel", "work_values", "work_use", "work_life",
                 "lt_keys", "lt_shrink", "lt_values", "lt_use", "lt_life"):
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(a).max()), name


def test_memory_insert_read_consolidate_evict_match_jax():
    jcfg, tcfg = jmem.MemoryConfig(**MEM_CFG), tmem.MemoryConfig(**MEM_CFG)
    js, ts = jmem.init_memory(jcfg), tmem.init_memory(tcfg)
    j_insert = jax.jit(jmem.insert_working, static_argnums=1)
    j_read = jax.jit(jmem.read_memory, static_argnums=(1, 4))
    rng = np.random.default_rng(9)
    evicted = False
    for i, (keys, sel, values, shrink) in enumerate(_mem_frames(16, 8)):
        on = i % 5 != 2  # a masked insert now and then
        js = j_insert(js, jcfg, jnp.asarray(keys), jnp.asarray(shrink), jnp.asarray(sel),
                                 jnp.asarray(values), jnp.asarray(on))
        ts = tmem.insert_working(ts, tcfg, torch.from_numpy(keys), torch.from_numpy(shrink),
                                 torch.from_numpy(sel), torch.from_numpy(values), on)
        _state_close(js, ts)
        qk = rng.normal(size=(6, 4)).astype(np.float32)
        qk[1] = qk[0]
        qe = (rng.random((6, 4)) * 0.9 + 0.05).astype(np.float32)
        upd = i % 3 != 1
        jout, js = j_read(js, jcfg, jnp.asarray(qk), jnp.asarray(qe), upd)
        tout, ts = tmem.read_memory(ts, tcfg, torch.from_numpy(qk), torch.from_numpy(qe),
                                    update_usage=upd)
        assert np.abs(np.asarray(jout) - tout.numpy()).max() <= 1e-5
        _state_close(js, ts)
        evicted |= int(np.asarray(js.lt_valid).sum()) < 4 * (i // 2)
    assert int(np.asarray(js.lt_valid).sum()) > 0
    assert evicted, "the sequence never reached long-term eviction"


def test_empty_memory_reads_zero():
    cfg = tmem.MemoryConfig(**MEM_CFG)
    out, st = tmem.read_memory(tmem.init_memory(cfg), cfg, torch.ones(6, 4), None)
    assert out.abs().max().item() == 0.0
    assert st.work_use.abs().max().item() == 0.0


def test_stable_top_k_breaks_ties_as_jax():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0, 1.0], [0.0] * 7], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    tv, ti = tcm.stable_top_k(torch.from_numpy(x), 5)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


# --- scene detection and resize ---------------------------------------------------


def _scene_clip(n_scenes=3, per=4, h=60, w=96, seed=0):
    rng = np.random.default_rng(seed)
    ys = []
    for _ in range(n_scenes):
        coarse = torch.from_numpy(0.15 + 0.6 * rng.random((1, 1, 5, 8), dtype=np.float32))
        field = torch.nn.functional.interpolate(coarse, size=(h, w + 2 * per), mode="bilinear",
                                                align_corners=False)[0, 0].numpy()
        ys += [field[:, 2 * i:2 * i + w] for i in range(per)]
    y = np.stack(ys)
    return np.repeat(y[..., None], 3, axis=-1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(threshold=0.05, sc_tht_filter=0.55, min_length=3),
    dict(threshold=0.10, frequency=5, normalize=True),
], ids=["simple", "ssim_filter", "frequency"])
def test_scene_detect_matches_jax(kw):
    frames = _scene_clip()
    want = jdetect.scene_detect(frames, **kw)
    got = tdetect.scene_detect(torch.from_numpy(frames), **kw)
    assert np.array_equal(want.sc_prev, got.sc_prev)
    assert np.abs(want.luma - got.luma).max() <= 1e-6


@pytest.mark.parametrize("make", [
    lambda cls: cls.every(7, 3),
    lambda cls: cls.every(5, 0, threshold=0.2),
    lambda cls: cls.from_frame_list(6, [0, 2, 9, -1]),
    lambda cls: cls.from_frame_list(6, [1, 4], ref_frame_ext=False),
], ids=["every", "every_off", "frame_list", "frame_list_no_ext"])
def test_scene_flags_constructors_match_jax(make):
    want, got = make(jdetect.SceneFlags), make(havc_tpu_torch.SceneFlags)
    for name in ("sc_prev", "sc_next", "luma", "ratio"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (want.threshold, want.frequency) == (got.threshold, got.frequency)


def test_frame_stats_histograms_match_jax():
    frames = _scene_clip(seed=1)
    want = jdetect.frame_stats(frames, 2)
    got = tdetect.frame_stats(torch.from_numpy(frames), 2)
    for a, b in zip(want, got):
        assert np.abs(a - b).max() <= 1e-5


@pytest.mark.parametrize("hw", [(40, 90), (50, 60), (36, 64)], ids=["pad_h", "pad_w", "none"])
def test_smart_resize_pad_restore_match_jax(hw):
    x = np.random.default_rng(2).random((2,) + hw + (3,), dtype=np.float32)
    jw, jmeta = jresize.smart_resize_pad(jnp.asarray(x), 36, 64)
    tw, tmeta = tresize.smart_resize_pad(torch.from_numpy(x), 36, 64)
    assert tuple(jmeta) == tuple(tmeta)
    assert np.abs(np.asarray(jw) - tw.numpy()).max() <= 1e-5
    jr = jresize.smart_resize_restore(jw, jmeta)
    tr = tresize.smart_resize_restore(tw, tmeta)
    assert np.abs(np.asarray(jr) - tr.numpy()).max() <= 1e-5


def test_bilinear_nchw_matches_jax_image_resize():
    x = np.random.default_rng(3).standard_normal((2, 3, 16, 30)).astype(np.float32)
    for oh, ow in ((14, 28), (32, 60), (5, 7)):
        want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, oh, ow, 3), "bilinear")
        _close(want, tresize.bilinear_nchw(torch.from_numpy(x), oh, ow), 1e-5)


# --- propagation -------------------------------------------------------------------


@pytest.fixture(scope="module")
def prop_engines(cm_tree, cm_net):
    je = _TreeEngine(cm_tree, (32, 48))
    te = tex.ColorMNetEngine(config="micro", work_size=(32, 48), device="cpu")
    te.net = cm_net
    return je, te


def _prop_inputs(T=16, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.random((T, 26, 40, 3), dtype=np.float32)
    ref_ab = rng.random((T, 26, 40, 2), dtype=np.float32) * 2 - 1
    refs = rng.random((T, 26, 40, 3), dtype=np.float32)
    is_ref = np.zeros(T, bool)
    is_ref[[0, 9]] = True
    return frames, ref_ab, is_ref, refs


@pytest.mark.parametrize("frame_propagate,vivid", [(True, False), (True, True), (False, False)],
                         ids=["propagate", "vivid", "exemplar"])
def test_colormnet_propagate_matches_jax(prop_engines, frame_propagate, vivid):
    je, te = prop_engines
    frames, ref_ab, is_ref, refs = _prop_inputs()
    want = jex.colormnet_propagate(je, frames, ref_ab, is_ref, ref_frames=refs,
                                   frame_propagate=frame_propagate, vivid=vivid)
    got = tex.colormnet_propagate(te, frames, ref_ab, is_ref, ref_frames=refs,
                                  frame_propagate=frame_propagate, vivid=vivid).numpy()
    assert got.shape == want.shape == (16, 26, 40, 2)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("vivid", [False, True])
def test_resumed_chunks_equal_one_run(prop_engines, vivid):
    _, te = prop_engines
    frames, ref_ab, is_ref, refs = _prop_inputs(seed=1)
    kw = dict(frame_propagate=True, vivid=vivid)
    whole = tex.colormnet_propagate(te, frames, ref_ab, is_ref, ref_frames=refs, **kw)
    a, carry = tex.colormnet_propagate(te, frames[:7], ref_ab[:7], is_ref[:7],
                                       ref_frames=refs[:7], return_state=True, **kw)
    b = tex.colormnet_propagate(te, frames[7:], ref_ab[7:], is_ref[7:], ref_frames=refs[7:],
                                resume_state=carry, **kw)
    # the key encoder runs in batches of another size: 1e-5, not equality
    assert (torch.cat([a, b]) - whole).abs().max().item() <= 1e-5


# --- the entry point ------------------------------------------------------------------


def _carry_model(jmodel, tmodel, seed):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
    params = {"params": _perturb(params["params"], seed)}
    tmodel.load_state_dict(state_dict_from_flax(params["params"]))
    return params, tmodel.eval().requires_grad_(False)


def test_havc_main_deepex_matches_jax(cm_tree, cm_net, monkeypatch):
    jp_do, tm_do = _carry_model(jdo.DeOldifyWide(encoder="nano", nf_factor=1),
                                tdo.DeOldifyWide(encoder="nano", nf_factor=1), 0)
    jp_dd, tm_dd = _carry_model(jdd.DDColor.from_config("micro"), tdd.DDColor.from_config("micro"), 1)
    monkeypatch.setattr(jitcache, "_CACHE", {})
    monkeypatch.setitem(jengines.registry._cache, ("deoldify", "video"),
                        (jdo.DeOldifyWide(encoder="nano", nf_factor=1), jp_do))
    monkeypatch.setitem(jengines.registry._cache, ("ddcolor", "artistic"),
                        (jdd.DDColor.from_config("micro"), jp_dd))
    j_do, j_dd = jengines.make_deoldify_fn, jengines.make_ddcolor_fn
    monkeypatch.setattr(jengines, "make_deoldify_fn",
                        lambda model=0, render_factor=24: j_do(model, 4))
    monkeypatch.setattr(jengines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: j_dd(model, 4, **kw))
    # the Medium work size 216x384 pads to a 224x448 engine
    monkeypatch.setattr(jex, "_ENGINE_CACHE", {
        ("colormnet", (("config", "micro"), ("work_size", (224, 448)))):
            _TreeEngine(cm_tree, (224, 448))})

    monkeypatch.setitem(tengines.registry._cache, ("deoldify", "video", CPU), tm_do)
    monkeypatch.setitem(tengines.registry._cache, ("ddcolor", "artistic", CPU), tm_dd)
    monkeypatch.setitem(tengines.registry._cache, ("colormnet", "micro", CPU), cm_net)
    monkeypatch.setattr(tex, "_ENGINE_CACHE", {})
    t_do, t_dd = tengines.make_deoldify_fn, tengines.make_ddcolor_fn
    monkeypatch.setattr(tengines, "make_deoldify_fn",
                        lambda model=0, render_factor=24, **kw: t_do(model, 4, **kw))
    monkeypatch.setattr(tengines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: t_dd(model, 4, **kw))

    frames = _scene_clip(n_scenes=2, per=3, h=48, w=64, seed=3)
    want = havc_tpu.HAVC_main(JClip(frames=frames.copy()), EnableDeepEx=True, batch_size=4)
    got = havc_tpu_torch.HAVC_main(havc_tpu_torch.Clip(frames=frames.copy()), EnableDeepEx=True,
                                   batch_size=4, device="cpu")
    assert np.array_equal(np.nonzero(got.sc.sc_prev)[0], [0, 3])
    assert np.array_equal(want.sc.sc_prev, got.sc.sc_prev)
    assert isinstance(got.frames, np.ndarray) and got.frames.shape == frames.shape
    assert np.abs(got.frames - np.asarray(want.frames)).max() <= TOL


# --- loading, signatures, device rule -------------------------------------------------


def test_converted_colormnet_npz_loads(cm_tree, cm_net, tmp_path, monkeypatch):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk({"params": cm_tree}, ())
    np.savez(os.path.join(tmp_path, "colormnet.npz"), **flat)
    monkeypatch.setattr(tengines, "registry", tengines.EngineRegistry())
    monkeypatch.setattr(tex, "registry", tengines.registry)
    tengines.set_weights_dir(str(tmp_path))
    assert tex.resolve_engine_config(None) == "full"
    # the saved tree is micro-sized: the registry loads it as "full"
    monkeypatch.setitem(tcm.COLORMNET_CONFIGS, "full", tcm.COLORMNET_CONFIGS["micro"])
    net = tengines.registry.colormnet("full", "cpu")
    assert not tengines.registry.random_init_used
    for (name, a), b in zip(net.state_dict().items(), cm_net.state_dict().values()):
        assert torch.equal(a, b), name
    tengines.set_weights_dir(None)
    assert tex.resolve_engine_config(None) == "micro"


def test_deepex_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    frames = _scene_clip(n_scenes=1, per=2, h=32, w=32)
    ref = havc_tpu_torch.Clip(frames=frames).with_sc(havc_tpu_torch.SceneFlags.every(2, 1))
    for fn in (havc_tpu_torch.HAVC_deepex, havc_tpu_torch.HAVC_cmnet2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(havc_tpu_torch.Clip(frames=frames), ref)
