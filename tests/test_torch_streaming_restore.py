"""``HAVC_restore_video_streaming`` with ColorMNet (``ex_model=0``): the
port against the JAX package's, on the CPU.

Both packages recolor the same 12-frame B&W mp4 from a colored reference
mp4 whose tint and luma jump every 5 frames (so the resumable scene scan
finds references inside chunks and at their edges), at work size 32x32
(a 112x112 engine), chunk 4, ``sink="null"``.  ColorMNet is the micro
configuration with the same weights in both (a flax tree with its
BatchNorm statistics, gates and embeddings moved off their init values,
carried with ``state_dict_from_flax``, as tests/test_torch_exemplar.py
does).  What each ``_WritePipeline._retire`` receives (the packed chroma
planes, and the host's studio-swing Y planes) is at most 1 code value
apart; the port's chunk 4 and chunk 12 runs too (the memory network's
state carried across chunks).
"""
import numpy as np
import pytest
import torch

import havc_tpu_torch.engines as tengines
from havc_tpu_torch import exemplar as tex
from havc_tpu_torch import streaming as tstream

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

T, H, W = 12, 64, 64
CPU = torch.device("cpu")
_MUL = ("scale", "var", "bn_scale", "bn_var", "temperature", "ls1_gamma", "ls2_gamma")
_ADD = ("bias", "mean", "bn_bias", "bn_mean", "cls_token")
_GROUPS = (("key_encoder", "p_key"), ("key_proj", "p_proj"), ("value_encoder", "p_value"),
           ("decoder", "p_dec"), ("short_term_attn", "p_attn"))


def _perturb(tree, seed):
    """Move every leaf that flax initialises to a constant off it."""
    import jax

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


@pytest.fixture(scope="module")
def cm_tree():
    """The micro ColorMNet tree (perturbed), initialised as the JAX
    engine initialises it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from havc_tpu.models import colormnet as jcm

    jm = dict(key_encoder=jcm.KeyEncoder(resnet="nano", vit="nano"),
              key_proj=jcm.KeyProjection(key_dim=8),
              value_encoder=jcm.ValueEncoder(value_dim=16, hidden_dim=8, resnet="nano"),
              decoder=jcm.Decoder(value_dim=16, hidden_dim=8),
              short_term_attn=jcm.LocalAttention(d_qk=8, d_vu=32, use_pallas=False))
    rng = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 32, 32, 3))
    p = {"key_encoder": jax.jit(jm["key_encoder"].init)(rng, x)}
    g16, g8, g4 = jax.jit(jm["key_encoder"].apply)(p["key_encoder"], x)
    hidden = jnp.zeros((2,) + g16.shape[1:3] + (8,))
    p["key_proj"] = jax.jit(jm["key_proj"].init)(rng, g16)
    p["value_encoder"] = jax.jit(jm["value_encoder"].init)(rng, x, g16, hidden,
                                                           jnp.zeros((1, 2, 32, 32)))
    p["decoder"] = jax.jit(jm["decoder"].init)(rng, g16, g8, g4, hidden,
                                               jnp.zeros((2,) + g16.shape[1:3] + (16,)))
    k, v = jnp.zeros((1,) + g16.shape[1:3] + (8,)), jnp.zeros((1,) + g16.shape[1:3] + (32,))
    p["short_term_attn"] = jax.jit(jm["short_term_attn"].init)(rng, k, k, v)
    return _perturb({g: t["params"] for g, t in p.items()}, 5)


@pytest.fixture(scope="module")
def scene_pair(tmp_path_factory):
    """A B&W mp4 and a colored reference mp4 whose tint and gain jump every
    5 frames."""
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("restore")
    src, ref = d / "in.mp4", d / "ref.mp4"
    rng = np.random.default_rng(7)
    base = rng.random((H, W, 3)).astype(np.float32)
    tints = [np.array([1.3, 0.85, 0.7]), np.array([0.7, 1.0, 1.3]), np.array([1.0, 1.25, 0.8])]
    w_in = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"mp4v"), 25, (W, H))
    w_ref = cv2.VideoWriter(str(ref), cv2.VideoWriter_fourcc(*"mp4v"), 25, (W, H))
    for i in range(T):
        f = np.clip(base * (0.5 + 0.4 * np.sin(i / 5.0)) + 0.1 * rng.random((H, W, 3)), 0, 1)
        g = f.mean(axis=-1, keepdims=True).repeat(3, axis=-1)
        w_in.write(cv2.cvtColor((g * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
        k = (i // 5) % len(tints)
        tinted = np.clip(g * tints[k] * (0.6 + 0.4 * ((i // 5) % 2)), 0, 1)
        w_ref.write(cv2.cvtColor((tinted * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    w_in.release()
    w_ref.release()
    return str(src), str(ref)


def _record(monkeypatch, cls, to_host):
    """Record what each ``_retire`` receives: the packed chunk and the Y
    planes the host provides."""
    orig = getattr(cls._retire, "__wrapped__", cls._retire)
    rec = []

    def spy(self, packed, meta, n):
        entry = {"packed": np.array(to_host(packed))[:n]}
        yp = self.y_provider

        def y_spy(m, k):
            entry["y"] = np.array(yp(m, k))[:k]
            return entry["y"]

        self.y_provider = y_spy
        try:
            orig(self, packed, meta, n)
        finally:
            self.y_provider = yp
        rec.append(entry)

    spy.__wrapped__ = orig
    monkeypatch.setattr(cls, "_retire", spy)
    return rec


def _joined(rec, key):
    return np.concatenate([e[key] for e in rec]).astype(np.int16)


def _codes_close(want, got, what):
    assert want.shape == got.shape, (what, want.shape, got.shape)
    diff = np.abs(want - got)
    print(f"{what}: max |diff| {diff.max()}, unequal {np.mean(diff > 0):.3%} of {diff.size}")
    assert diff.max() <= 1, what


ARGS = dict(work_size=(32, 32), sink="null", engine_config="micro")


def test_restore_streaming_colormnet_matches_jax(cm_tree, scene_pair, monkeypatch):
    from havc_tpu import exemplar as jex
    from havc_tpu import streaming as jstream
    from havc_tpu.utils import jitcache

    from havc_tpu_torch.models import colormnet as tcm
    from havc_tpu_torch.models.bridge import state_dict_from_flax

    class _TreeEngine(jex.ColorMNetEngine):
        """The JAX package's micro engine with the tree's parameters."""

        def _init_params(self, seed):
            for group, attr in _GROUPS:
                setattr(self, attr, {"params": cm_tree[group]})
            self.g16_hw = (self.h // 16, self.w // 16)

    monkeypatch.setattr(jitcache, "_CACHE", {})
    monkeypatch.setattr(jex, "_ENGINE_CACHE", {
        ("colormnet", (("config", "micro"), ("work_size", (112, 112)))):
            _TreeEngine(config="micro", work_size=(112, 112))})
    net = tcm.ColorMNet("micro")
    net.load_state_dict(state_dict_from_flax(cm_tree))
    monkeypatch.setitem(tengines.registry._cache, ("colormnet", "micro", CPU),
                        net.eval().requires_grad_(False))
    monkeypatch.setattr(tex, "_ENGINE_CACHE", {})

    flags = []
    real_propagate = tex.colormnet_propagate

    def propagate(engine, frames, ref_ab, is_ref, **kw):
        flags.append(np.array(is_ref))
        return real_propagate(engine, frames, ref_ab, is_ref, **kw)

    monkeypatch.setattr(tex, "colormnet_propagate", propagate)
    src, ref = scene_pair
    want = _record(monkeypatch, jstream._WritePipeline, np.asarray)
    assert jstream.HAVC_restore_video_streaming(src, ref, "unused.mp4", chunk_size=4,
                                                **ARGS) == T
    assert jstream.last_transfer() == "gray+uv420"
    got = {}
    for chunk in (4, 12):
        rec = _record(monkeypatch, tstream._WritePipeline, lambda p: p.wait())
        assert tstream.HAVC_restore_video_streaming(src, ref, "unused.mp4", chunk_size=chunk,
                                                    device="cpu", **ARGS) == T
        assert tstream.last_transfer() == "gray+uv420"
        got[chunk] = rec
    _codes_close(_joined(want, "packed"), _joined(got[4], "packed"), "port vs havc_tpu, chunk 4")
    assert np.array_equal(_joined(want, "y"), _joined(got[4], "y"))
    _codes_close(_joined(got[4], "packed"), _joined(got[12], "packed"), "port chunk 4 vs 12")
    # the resumable scene scan: the same references at chunk 4 and 12,
    # inside the chunks and on their edges
    by_chunk = [np.nonzero(np.concatenate(flags[:3]))[0], np.nonzero(flags[3])[0]]
    assert by_chunk[0].tolist() == by_chunk[1].tolist() == [0, 5, 10]

