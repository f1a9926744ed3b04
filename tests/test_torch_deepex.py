"""The port's Deep-Exemplar modules, WLS smoother and ``deepex_propagate``
against the JAX package's, on the CPU.

Both packages run the published widths (VGG19 to relu5_2, WarpNet,
ColorVidNet: 55,024,269 parameters) with the same weights: seeded with
numpy at the shapes ``jax.eval_shape`` gives (``seeded_params`` of
tests/test_torch_exemplar_surface.py) and carried over with
``state_dict_from_flax``.  Frames are 40x64, where WarpNet's odd-size
rule runs (its r52 is 2x4, so ``x5`` comes out 8x16 against 10x16 and is
edge-padded by one row on each side).  Each JAX function is jitted once
for the module (``J``).

Tolerances, relative to the output's scale (its largest magnitude):
* VGG19, ``WarpNet.encode``, ``WarpNet.correlate`` at temperature 0.01,
  ``guided_filter_ab``: 1e-4.
* ColorVidNet (30 convolutions, seven instance norms down to 5x8 pixels)
  amplifies float32 rounding: with these weights each package's float32
  output is 1.5-2.5e-4 of the scale away from the float64 one, so two
  float32 implementations cannot agree to 1e-4.  It is held twice: in
  float64 in both packages (1e-9: the arithmetic is the same), and in
  float32 by ``floor_check``: each package's float32 result is within
  twice the other's distance from the float64 value, plus 1e-4 of the
  scale.  ``frame_colorization``, ``frame_colorization_batched`` and
  ``deepex_propagate`` at temperature 0.01 end in it and are held the same
  way (the float64 value from the port's networks in float64), their
  other outputs (features, warped LAB) at 1e-4.
* At temperature 1e-10 the warp is a hard argmax over the reference's
  tokens: a near tie flips on summation order alone and moves a whole
  4x4 block.  There the bound is a share of moved values: at most 2 % of
  the values more than 1e-3 of the scale apart (``deepex_propagate``'s
  RGB: 2 % more than 1e-4 apart).
* ``fgs_smooth``/``fgs_smooth_ab``: 1e-5 of the scale against the JAX
  functions, 1e-4 against tests/test_fgs.py's float64 numpy oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from havc_tpu import exemplar as jex
from havc_tpu.models import deepex as jdx
from havc_tpu.ops import fgs as jfgs
from havc_tpu.ops.colorspace import rgb_to_lab as jrgb_to_lab
from havc_tpu.utils import jitcache

from havc_tpu_torch import exemplar as tex
from havc_tpu_torch.models import deepex as tdx
from havc_tpu_torch.models.bridge import state_dict_from_flax
from havc_tpu_torch.ops import fgs as tfgs

from test_fgs import _numpy_fgs
from test_torch_exemplar_surface import seeded_params
from test_torch_streaming import _few_torch_threads  # noqa: F401  (autouse fixture)

H, W = 40, 64
CPU = torch.device("cpu")
MOVED = 1e-3  # a value "moved" by an argmax flip: more than this share of the scale apart


def deepex_trees(h=H, w=W):
    """The three networks' flax trees, seeded at the shapes the JAX engine
    initialises at (h, w)."""
    rgb = jnp.zeros((1, h, w, 3))
    vgg = seeded_params(jdx.VGG19Features(), 21, rgb)
    feats = jax.eval_shape(jdx.VGG19Features().apply, {"params": vgg}, rgb)
    warp = seeded_params(jdx.WarpNet(), 22, rgb, feats, feats)
    color = seeded_params(jdx.ColorVidNet(), 23, jnp.zeros((1, h, w, 7)))
    return {"vgg": vgg, "warpnet": warp, "colorvid": color}


def deepex_net(trees):
    net = tdx.DeepEx()
    net.load_state_dict(state_dict_from_flax(trees))
    return net.eval().requires_grad_(False)


class JaxDeepEx(jex.DeepExEngine):
    """The JAX package's engine with the shared trees for parameters."""

    def __init__(self, trees, speed="medium", seed=0):
        self.h, self.w = jex.smart_resize_shape(0, 0, speed)
        self.vgg, self.warp, self.color = jdx.VGG19Features(), jdx.WarpNet(), jdx.ColorVidNet()
        self.p_vgg, self.p_warp, self.p_color = ({"params": trees[k]}
                                                 for k in ("vgg", "warpnet", "colorvid"))


class PortDeepEx(tex.DeepExEngine):
    """The port's engine around a given network."""

    def __init__(self, net, size=(H, W)):
        self.h, self.w = size
        self.device = CPU
        self.vgg, self.warp, self.color = net.vgg, net.warpnet, net.colorvid


@pytest.fixture(scope="module")
def trees():
    return deepex_trees()


@pytest.fixture(scope="module")
def net(trees):
    return deepex_net(trees)


@pytest.fixture(scope="module")
def J(trees):
    """The JAX functions, jitted once for the module, and its parameters."""
    vgg, warp, color = jdx.VGG19Features(), jdx.WarpNet(), jdx.ColorVidNet()
    p = {k: {"params": v} for k, v in trees.items()}
    f = dict(
        vgg=jax.jit(vgg.apply),
        encode=jax.jit(lambda pw, feats: warp.apply(pw, feats, method="encode")),
        correlate=jax.jit(lambda pw, lab, a, b, t: warp.apply(pw, lab, a, b, t,
                                                              method="correlate"),
                          static_argnums=4),
        color=jax.jit(color.apply),
        frame=jax.jit(lambda pv, pw, pc, ia, ib, il, fb, t: jdx.frame_colorization(
            pv, pw, pc, ia, ib, il, fb, vgg, warp, color, temperature=t), static_argnums=7),
        encref=jax.jit(lambda pv, pw, ib: jdx.encode_reference(pv, pw, ib, vgg, warp)),
        batched=jax.jit(lambda pv, pw, pc, ia, ib, il, bf, t: jdx.frame_colorization_batched(
            pv, pw, pc, ia, ib, il, bf, vgg, warp, color, temperature=t), static_argnums=7),
    )
    return p, f


def frames_rgb(n=4, seed=0, h=H, w=W):
    """Smooth seeded RGB frames (T, h, w, 3) with some texture."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((n, 3, 5, 8), dtype=np.float32))
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                        align_corners=False).permute(0, 2, 3, 1).numpy()
    return np.clip(0.8 * x + 0.2 * rng.random((n, h, w, 3), dtype=np.float32), 0, 1)


def lab_of(x):
    return np.asarray(jrgb_to_lab(jnp.asarray(x)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-6))


def moved_share(want, got, scale):
    return float(np.mean(np.abs(np.asarray(want) - np.asarray(got)) > MOVED * scale))


def normalized(feats):
    return tuple(f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-10) for f in feats)


# --- the networks ---------------------------------------------------------------------


def test_vgg19_features(net, J):
    p, f = J
    x = frames_rgb(2, seed=1)
    want = f["vgg"](p["vgg"], jnp.asarray(x))
    with torch.no_grad():
        got = net.vgg(nchw(x))
    assert len(got) == 5
    for a, b in zip(want, got):
        assert rel(a, nhwc(b)) <= 1e-4


@pytest.fixture(scope="module")
def features(J):
    """Normalised VGG pyramids of two frames (a) and a reference (b), and
    the reference's LAB."""
    p, f = J
    x = frames_rgb(3, seed=2)
    feats = [np.asarray(t) for t in f["vgg"](p["vgg"], jnp.asarray(x))]
    a = normalized([t[:2] for t in feats])
    b = normalized([t[2:] for t in feats])
    return a, b, lab_of(x[2:])


def test_warpnet_encode_odd_size(net, J, features):
    """At 40x64 ``x5`` is 8x16 against ``x2``'s 10x16: the edge pad runs."""
    p, f = J
    a, _, _ = features
    assert a[4].shape[1:3] == (2, 4)
    want = f["encode"](p["warpnet"], tuple(jnp.asarray(t) for t in a))
    with torch.no_grad():
        got = net.warpnet.encode(tuple(nchw(t) for t in a))
    assert want.shape == (2, 10, 16, 256)
    assert rel(want, nhwc(got)) <= 1e-4


@pytest.mark.parametrize("temperature", [0.01, 1e-10], ids=["t0.01", "t1e-10"])
def test_warpnet_correlate(net, J, features, temperature):
    p, f = J
    a, b, b_lab = features
    a_feat = np.asarray(f["encode"](p["warpnet"], tuple(jnp.asarray(t) for t in a)))
    b_feat = np.asarray(f["encode"](p["warpnet"], tuple(jnp.asarray(t) for t in b)))
    lab_c = b_lab - np.float32([50.0, 0.0, 0.0])
    want_w, want_s = f["correlate"](p["warpnet"], jnp.asarray(lab_c), jnp.asarray(a_feat),
                                    jnp.asarray(b_feat), temperature)
    with torch.no_grad():
        got_w, got_s = net.warpnet.correlate(nchw(lab_c), nchw(a_feat), nchw(b_feat),
                                             temperature)
    assert rel(want_s, nhwc(got_s)) <= 1e-4  # the similarity is a plain max
    want_w, got_w = np.asarray(want_w), nhwc(got_w)
    scale = np.abs(want_w).max()
    if temperature == 0.01:
        assert rel(want_w, got_w) <= 1e-4
    else:  # a hard argmax: bound the share of moved values
        assert moved_share(want_w, got_w, scale) <= 0.02


def _x64(fn):
    with jax.enable_x64(True):
        return fn()


def _to64(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), tree)


@pytest.fixture(scope="module")
def net64(net):
    """The port's networks in float64: the high-precision value the float32
    results are measured from (its arithmetic is the JAX package's:
    ``test_colorvidnet`` holds the float64 ColorVidNet to JAX's at 1e-9)."""
    n = tdx.DeepEx()
    n.load_state_dict(net.state_dict())
    return n.double().eval().requires_grad_(False)


def floor_check(want32, exact, got32, what):
    """Both float32 results, the JAX package's and the port's, are within
    twice the other's distance from the high-precision value ``exact``,
    plus 1e-4 of the scale: the port agrees with the JAX package to the
    float32 floor of the function.  A fault in the port would move it, and
    not the JAX package's result, away from ``exact``."""
    scale = np.abs(exact).max()
    err_j = np.abs(np.asarray(want32, np.float64) - exact).max()
    err_p = np.abs(np.asarray(got32, np.float64) - exact).max()
    print(f"{what}: JAX float32 {err_j / scale:.3e}, port float32 {err_p / scale:.3e} "
          f"of {scale:.4f}, apart {rel(want32, got32):.3e}")
    assert err_j <= 2.0 * err_p + 1e-4 * scale, what
    assert err_p <= 2.0 * err_j + 1e-4 * scale, what


def test_colorvidnet(net, net64, J):
    """In float64 in both packages (1e-9), then in float32 against the
    JAX package's float64 output."""
    p, f = J
    rng = np.random.default_rng(3)
    lab = lab_of(frames_rgb(2, seed=3))
    x7 = np.concatenate([lab[..., :1] - 50.0, rng.uniform(-60, 60, (2, H, W, 2)),
                         rng.uniform(-1, 1, (2, H, W, 1)), lab - np.float32([50, 0, 0])],
                        axis=-1).astype(np.float32)
    want32 = np.asarray(f["color"](p["colorvid"], jnp.asarray(x7)))
    want64 = _x64(lambda: np.asarray(jax.jit(jdx.ColorVidNet().apply)(
        _to64(p["colorvid"]), jnp.asarray(x7, jnp.float64))))
    assert want64.dtype == np.float64
    with torch.no_grad():
        got32 = nhwc(net.colorvid(nchw(x7)))
        got64 = nhwc(net64.colorvid(nchw(x7.astype(np.float64))))
    assert rel(want64, got64) <= 1e-9
    floor_check(want32, want64, got32, "ColorVidNet")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("temperature", [0.01, 1e-10], ids=["t0.01", "t1e-10"])
def test_frame_colorization(net, net64, J, temperature):
    """One step: the predicted ab, the warped LAB and the frames' VGG
    features (the reference's features are the JAX package's)."""
    p, f = J
    x = frames_rgb(3, seed=4)
    lab = lab_of(x)
    ia, ib, il = lab[:2], lab[2:], lab[[2, 0]]
    feats_b = [np.asarray(t) for t in f["vgg"](p["vgg"], jnp.asarray(x[2:]))]
    want_ab, want_w, want_fa = f["frame"](p["vgg"], p["warpnet"], p["colorvid"], jnp.asarray(ia),
                                          jnp.asarray(ib), jnp.asarray(il),
                                          tuple(jnp.asarray(t) for t in feats_b), temperature)

    def port(n, dtype):
        with torch.no_grad():
            return tdx.frame_colorization(n.vgg, n.warpnet, n.colorvid, _t(ia, dtype),
                                          _t(ib, dtype), _t(il, dtype),
                                          tuple(nchw(t).to(dtype) for t in feats_b), temperature)

    got_ab, got_w, got_fa = port(net, torch.float32)
    for a, b in zip(want_fa, got_fa):
        assert rel(a, nhwc(b)) <= 1e-4
    want_ab, want_w = np.asarray(want_ab), np.asarray(want_w)
    if temperature == 0.01:
        assert rel(want_w, got_w.numpy()) <= 1e-4
        floor_check(want_ab, port(net64, torch.float64)[0].numpy(), got_ab.numpy(),
                    "frame_colorization")
    else:
        assert moved_share(want_w, got_w.numpy(), np.abs(want_w).max()) <= 0.02
        assert moved_share(want_ab, got_ab.numpy(), 128.0) <= 0.02


@pytest.mark.parametrize("temperature", [0.01, 1e-10], ids=["t0.01", "t1e-10"])
def test_frame_colorization_batched(net, net64, J, temperature):
    """A batch of four frames against one encoded reference and a pinned
    last prediction."""
    p, f = J
    lab = lab_of(frames_rgb(5, seed=5))
    ia, ib, il = lab[:4], lab[4:], lab[4:]
    b_feat = f["encref"](p["vgg"], p["warpnet"], jnp.asarray(ib))
    want = np.asarray(f["batched"](p["vgg"], p["warpnet"], p["colorvid"], jnp.asarray(ia),
                                   jnp.asarray(ib), jnp.asarray(il), b_feat, temperature))

    def port(n, dtype):
        with torch.no_grad():
            feat = tdx.encode_reference(n.vgg, n.warpnet, _t(ib, dtype))
            return feat, tdx.frame_colorization_batched(
                n.vgg, n.warpnet, n.colorvid, _t(ia, dtype), _t(ib, dtype), _t(il, dtype), feat,
                temperature).numpy()

    got_feat, got = port(net, torch.float32)
    assert rel(b_feat, nhwc(got_feat)) <= 1e-4
    if temperature == 0.01:
        floor_check(want, port(net64, torch.float64)[1], got, "frame_colorization_batched")
    else:
        assert moved_share(want, got, 128.0) <= 0.02


# --- the smoothers --------------------------------------------------------------------


def test_fgs_smooth_matches_jax_and_oracle():
    rng = np.random.default_rng(0)
    guide = (rng.random((2, 12, 16)) * 255).round().astype(np.float32)
    x = (rng.standard_normal((2, 12, 16, 2)) * 20).astype(np.float32)
    want = np.asarray(jax.jit(jfgs.fgs_smooth)(jnp.asarray(guide), jnp.asarray(x)))
    got = tfgs.fgs_smooth(torch.from_numpy(guide), torch.from_numpy(x)).numpy()
    assert rel(want, got) <= 1e-5
    assert rel(_numpy_fgs(guide, x), got) <= 1e-4


def test_fgs_smooth_ab_matches_jax():
    """Deep-Exemplar's call on a 40x64 LAB clip: the guide from L as uint8
    codes, ab in the DeepEx range."""
    lab = lab_of(frames_rgb(3, seed=6))
    ab = (np.random.default_rng(6).uniform(-100, 100, (3, H, W, 2))).astype(np.float32)
    want = np.asarray(jax.jit(jfgs.fgs_smooth_ab)(jnp.asarray(lab[..., :1]), jnp.asarray(ab)))
    got = tfgs.fgs_smooth_ab(torch.from_numpy(lab[..., :1]), torch.from_numpy(ab)).numpy()
    assert rel(want, got) <= 1e-5


def test_guided_filter_ab():
    lab = lab_of(frames_rgb(2, seed=7))
    ab = np.ascontiguousarray(lab[..., 1:3] * 1.2)
    want = np.asarray(jax.jit(jdx.guided_filter_ab)(jnp.asarray(lab[..., :1]), jnp.asarray(ab)))
    got = tdx.guided_filter_ab(torch.from_numpy(lab[..., :1]), torch.from_numpy(ab)).numpy()
    assert rel(want, got) <= 1e-4


def test_get_deepex_size():
    for speed in ("fast", "Medium", "SLOW", "slower"):
        assert tdx.get_deepex_size(speed) == jdx.get_deepex_size(speed)
        assert tex.smart_resize_shape(1920, 1080, speed) == jex.smart_resize_shape(1920, 1080,
                                                                                     speed)


# --- deepex_propagate -----------------------------------------------------------------


def scene_inputs(seed=8):
    """Seven frames in two scenes (cuts 0, 3) with a colored reference at
    each frame: batch 4 leaves ragged batches in both scenes."""
    x = frames_rgb(7, seed=seed)
    gray = np.repeat(x.mean(-1, keepdims=True), 3, axis=-1)
    is_ref = np.zeros(7, bool)
    is_ref[[0, 3]] = True
    return gray.astype(np.float32), x.astype(np.float32), is_ref


@pytest.fixture(scope="module")
def jcache():
    """The JAX package's compiled functions, kept for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitcache, "_CACHE", {})
        yield


@pytest.mark.parametrize("kw", [
    dict(temperature=0.01),
    dict(temperature=0.01, frame_propagate=False, vivid=True),
    dict(),
    dict(vivid=True, frame_propagate=False),
], ids=["t0.01", "t0.01-exemplar-vivid", "t1e-10", "t1e-10-exemplar-vivid"])
def test_deepex_propagate(trees, net, net64, jcache, monkeypatch, kw):
    """Two scenes, ragged batches.  At temperature 0.01 the port is held
    to the float32 floor (``floor_check``; the high-precision value is the
    port's float64 networks, the WLS smoother float32 as in both
    packages); at 1e-10 at most 2 % of the values move by more than 1e-4."""
    gray, refs, is_ref = scene_inputs()
    want = np.asarray(jex.deepex_propagate(JaxDeepEx(trees), gray, refs, is_ref, **kw))
    got = tex.deepex_propagate(PortDeepEx(net), gray, refs, is_ref, **kw)
    assert isinstance(got, torch.Tensor) and got.shape == (7, H, W, 3)
    got = got.numpy()
    diff = np.abs(want - got)
    print(f"deepex_propagate {kw}: max {diff.max():.3e}, over 1e-4 {np.mean(diff > 1e-4):.4%}")
    if kw.get("temperature") == 0.01:
        monkeypatch.setattr(tex, "_as_tensor", lambda x, dev: torch.as_tensor(x).double())
        exact = tex.deepex_propagate(PortDeepEx(net64), gray.astype(np.float64),
                                     refs.astype(np.float64), is_ref, **kw).double().numpy()
        floor_check(want, exact, got, f"deepex_propagate {kw}")
    else:
        assert np.mean(diff > 1e-4) <= 0.02
