"""``HAVC_main(clip)`` with its defaults: the port against the JAX package.

Both packages run the whole main path (work resize, DeOldify Video +
DDColor Artistic with its tweak prefilter and hue fix, Simple merge,
chroma restore, then the Medium stabilizer: fused post chain, temporal
chroma stabilizer, deflicker, chroma restore) on the same 6-frame 48x64
gray clip, batch_size 4.  In both, the registry holds a small DeOldifyWide
("nano", nf_factor 1) under ``video`` and DDColor ``micro`` under
``artistic`` with the same weights, and the engine factories are patched
to render factor 4, so the models run at 64x64.  Nothing else changes.
Tolerance: max abs <= 1e-4 on the RGB output (float32 convolutions sum in
another order in XLA and PyTorch).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
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

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _perturb(tree, seed):
    """Move BatchNorm statistics and the attention/layer-scale gates off
    their init values, so every carried leaf matters."""
    rng = np.random.default_rng(seed)

    def leaf(name, v):
        v = np.array(v, dtype=np.float32)
        if name in ("scale", "var"):
            return v * rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
        if name == "gamma":
            return np.full(v.shape, 0.3, np.float32)
        return v

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in node.items()}

    return walk(jax.tree_util.tree_map(np.asarray, dict(tree)))


def _carry(jmodel, tmodel, seed):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
    params = {"params": _perturb(params["params"], seed)}
    tmodel.load_state_dict(state_dict_from_flax(params["params"]))
    return params, tmodel.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def engines_pair():
    do_pair = _carry(jdo.DeOldifyWide(encoder="nano", nf_factor=1),
                     tdo.DeOldifyWide(encoder="nano", nf_factor=1), 0)
    dd_pair = _carry(jdd.DDColor.from_config("micro"), tdd.DDColor.from_config("micro"), 1)
    return do_pair, dd_pair


def _gray_clip():
    y = np.random.default_rng(7).random((6, 48, 64, 1), dtype=np.float32)
    return np.repeat(y, 3, axis=-1)


def test_havc_main_defaults_match_jax(engines_pair, monkeypatch):
    (jp_do, tm_do), (jp_dd, tm_dd) = engines_pair
    cpu = torch.device("cpu")
    # JAX package: small engines under the default names, factories at rf 4
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
    # the port: the same engines and weights
    monkeypatch.setitem(tengines.registry._cache, ("deoldify", "video", cpu), tm_do)
    monkeypatch.setitem(tengines.registry._cache, ("ddcolor", "artistic", cpu), tm_dd)
    t_do, t_dd = tengines.make_deoldify_fn, tengines.make_ddcolor_fn
    monkeypatch.setattr(tengines, "make_deoldify_fn",
                        lambda model=0, render_factor=24, **kw: t_do(model, 4, **kw))
    monkeypatch.setattr(tengines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: t_dd(model, 4, **kw))

    frames = _gray_clip()
    want = np.asarray(havc_tpu.HAVC_main(JClip(frames=frames.copy()), batch_size=4).frames)
    out = havc_tpu_torch.HAVC_main(havc_tpu_torch.Clip(frames=frames.copy()),
                                   batch_size=4, device="cpu")
    assert isinstance(out.frames, np.ndarray)  # numpy in -> numpy out
    assert out.frames.shape == want.shape == frames.shape
    assert np.abs(out.frames - want).max() <= TOL

    # a clip of tensors stays a tensor
    out_t = havc_tpu_torch.HAVC_main(
        havc_tpu_torch.Clip(frames=torch.from_numpy(frames.copy())), batch_size=4, device="cpu")
    assert isinstance(out_t.frames, torch.Tensor)
    assert np.abs(out_t.frames.numpy() - out.frames).max() == 0.0


def test_colorizer_with_scene_detection_matches_jax(engines_pair, monkeypatch):
    """HAVC_colorizer with scene detection: flags attached, only the
    scene-change frames colorized (gathered, scattered back), the others
    passed through."""
    (jp_do, _), (jp_dd, _) = engines_pair
    monkeypatch.setattr(jitcache, "_CACHE", {})
    monkeypatch.setitem(jengines.registry._cache, ("deoldify", "video"),
                        (jdo.DeOldifyWide(encoder="nano", nf_factor=1), jp_do))
    monkeypatch.setitem(jengines.registry._cache, ("ddcolor", "artistic"),
                        (jdd.DDColor.from_config("micro"), jp_dd))
    monkeypatch.setitem(tengines.registry._cache, ("deoldify", "video", torch.device("cpu")),
                        engines_pair[0][1])
    monkeypatch.setitem(tengines.registry._cache, ("ddcolor", "artistic", torch.device("cpu")),
                        engines_pair[1][1])
    rng = np.random.default_rng(11)
    y = np.concatenate([np.full((3, 48, 64, 1), 0.3, np.float32),
                        np.full((3, 48, 64, 1), 0.6, np.float32)])
    frames = np.repeat(y + 0.05 * rng.random(y.shape, dtype=np.float32), 3, axis=-1)
    kw = dict(deoldify_p=(0, 4, 1.0, 0.0), ddcolor_p=(1, 10, 1.0, 0.0, True), sc_threshold=0.1,
              batch_size=2)
    want = havc_tpu.HAVC_colorizer(JClip(frames=frames.copy()), **kw)
    got = havc_tpu_torch.HAVC_colorizer(havc_tpu_torch.Clip(frames=frames.copy()),
                                        device="cpu", **kw)
    assert np.array_equal(want.sc.sc_prev, got.sc.sc_prev)
    assert np.array_equal(np.nonzero(got.sc.sc_prev)[0], [0, 3])
    assert np.array_equal(got.frames[[1, 2, 4, 5]], frames[[1, 2, 4, 5]])
    assert np.abs(got.frames - np.asarray(want.frames)).max() <= TOL


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("colormap", ["none", "blue->brown"])
def test_stabilizer_matches_jax(use_pallas, colormap):
    """HAVC_stabilizer alone, fused (post-chain kernel's plain version) and
    unfused (the filter chain), with the temporal stabilizer and
    deflicker, on a colored 6-frame clip."""
    frames = np.random.default_rng(8).random((6, 48, 64, 3), dtype=np.float32)
    kw = dict(dark=True, smooth=True, colormap=colormap, stab=True, use_pallas=use_pallas,
              render_factor=16, batch_size=4)
    want = np.asarray(havc_tpu.HAVC_stabilizer(JClip(frames=frames.copy()), **kw).frames)
    got = havc_tpu_torch.HAVC_stabilizer(havc_tpu_torch.Clip(frames=frames.copy()),
                                         device="cpu", **kw).frames
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("name", [
    "HAVC_main", "HAVC_main_presets", "HAVC_main_colorizer", "HAVC_colorizer", "HAVC_stabilizer",
    "HAVC_deepex", "HAVC_cmnet2",
])
def test_entry_point_signatures_match_jax(name):
    """Same parameters, order and defaults as havc_tpu's, plus ``device``
    (last, or just before ``**kwargs`` where the JAX function has them)."""
    import inspect

    from havc_tpu import exemplar

    # havc_tpu's top level forwards the exemplar entry points as (*args, **kwargs)
    src = exemplar if name in ("HAVC_deepex", "HAVC_cmnet2") else havc_tpu
    want = list(inspect.signature(getattr(src, name)).parameters.values())
    got = list(inspect.signature(getattr(havc_tpu_torch, name)).parameters.values())
    names = [p.name for p in want]
    at = len(names) - (want[-1].kind is inspect.Parameter.VAR_KEYWORD)
    assert [p.name for p in got] == names[:at] + ["device"] + names[at:]
    by_name = {p.name: p for p in got}
    for w in want:
        assert by_name[w.name].default == w.default, w.name
    assert by_name["device"].default is None


def test_havc_main_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    clip = havc_tpu_torch.Clip(frames=_gray_clip())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        havc_tpu_torch.HAVC_main(clip)


def test_unported_branches_raise(engines_pair, monkeypatch):
    """DeepEx (``DeepExModel=1``) and FrameInterp 1-4 (Deep-Exemplar between
    the sparse references) are ported: they run and return the clip's
    shape (small classic engines at render factor 4, the registry's seeded
    Deep-Exemplar at a 40x64 work size; their parity with the JAX package
    is tests/test_torch_deepex_surface.py's and test_torch_deepex_interp.py's)."""
    from havc_tpu_torch import exemplar as tex

    cpu = torch.device("cpu")
    (_, tm_do), (_, tm_dd) = engines_pair
    monkeypatch.setitem(tengines.registry._cache, ("deoldify", "video", cpu), tm_do)
    monkeypatch.setitem(tengines.registry._cache, ("ddcolor", "artistic", cpu), tm_dd)
    t_do, t_dd = tengines.make_deoldify_fn, tengines.make_ddcolor_fn
    monkeypatch.setattr(tengines, "make_deoldify_fn",
                        lambda model=0, render_factor=24, **kw: t_do(model, 4, **kw))
    monkeypatch.setattr(tengines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: t_dd(model, 4, **kw))
    monkeypatch.setattr(tex, "smart_resize_shape", lambda width, height, speed="medium": (40, 64))
    frames = _gray_clip()
    # two intra-op threads: under parallel test workers a full pool waits
    # on its slowest thread at each of Deep-Exemplar's many small ops
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        for kw in (dict(EnableDeepEx=True, DeepExModel=1), dict(FrameInterp=1),
                   dict(FrameInterp=4)):
            out = havc_tpu_torch.HAVC_main(havc_tpu_torch.Clip(frames=frames.copy()),
                                           batch_size=4, device="cpu", **kw)
            assert isinstance(out.frames, np.ndarray) and out.frames.shape == frames.shape, kw
            assert np.isfinite(out.frames).all() and 0 <= out.frames.min() <= out.frames.max() <= 1
    finally:
        torch.set_num_threads(threads)


def test_port_imports_neither_jax_nor_havc_tpu():
    """Every module of the port imports (the classic-surface ones among
    them), and none pulls in jax, flax, havc_tpu or cv2 (the GPU machine
    has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import havc_tpu_torch\n"
        "for m in pkgutil.walk_packages(havc_tpu_torch.__path__, 'havc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'havc_tpu', 'cv2'))\n"
        "assert not bad, bad\n"
        "new = ['havc_tpu_torch.ops.' + m for m in ('equalize', 'retinex', 'lut3d', 'tiles')]\n"
        "new += ['havc_tpu_torch.models.zhang', 'havc_tpu_torch.exemplar.allrefs']\n"
        "new += ['havc_tpu_torch.models.deepex', 'havc_tpu_torch.models.remaster',\n"
        "        'havc_tpu_torch.ops.fgs']\n"
        "new += ['havc_tpu_torch.' + m for m in ('scene.edges', 'scene.motion', 'ops.overlay',\n"
        "        'ops.denoise', 'io.native', 'io.formats', 'metrics', 'utils.log')]\n"
        "new += ['havc_tpu_torch.' + m for m in ('parallel', 'parallel.mesh', 'parallel.halo',\n"
        "        'models.convert')]\n"
        "missing = [n for n in new if n not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('ok', len([n for n in sys.modules if n.startswith('havc_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
