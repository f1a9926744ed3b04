"""The port's scene-batched ColorMNet scan against the JAX package's.

``colormnet_propagate_scenes`` runs every scene of a vivid clip in one
step per frame of the longest scene (the port of
tests/test_exemplar_scenes.py, on the micro ColorMNet at 64x112, seeded
with numpy at the JAX engine's shapes and carried over with
``state_dict_from_flax``):

* against ``havc_tpu``'s ``colormnet_propagate_scenes`` (1e-4, the
  exemplar tolerance: float32 convolutions and products summed in another
  order);
* against the port's own sequential vivid scan (the JAX test's ``atol
  2e-5, rtol 1e-4``: the batched products round in another order), with
  equal, ragged and long scenes (the long ones consolidate into the
  long-term store and evict from it), exemplar mode, no crosstalk
  between scenes, ``is_ref[0]`` false raising and an empty clip;
* ``HAVC_deepex(scene_parallel=True)``: the scene-batched scan where the
  JAX package takes it, and the JAX package's warning and the sequential
  scan in each case it sends there (not vivid, one reference, the
  all-refs encode mode 2); ``scene_mesh`` reaches the scan;
* ``utils.device_trace``, which chip_smoke runs around the scene path,
  writes a Chrome trace of a port op.
"""
import ast
import json
import logging

import jax.numpy as jnp  # noqa: F401  (jax is configured by conftest before the models)
import numpy as np
import pytest
import torch

import havc_tpu_torch
from havc_tpu import exemplar as jex
from havc_tpu.utils import jitcache
from havc_tpu_torch import exemplar as tex
from havc_tpu_torch.parallel import make_mesh

from test_torch_exemplar import _scene_clip
from test_torch_exemplar_surface import (  # noqa: F401  (fixtures)
    _SeededEngine,
    colormnet_both,
    seeded_colormnet,
)
from test_torch_streaming import _few_torch_threads  # noqa: F401  (autouse fixture)

TOL = 1e-4
SEQ = dict(atol=2e-5, rtol=1e-4)  # batched against sequential, as the JAX test holds it
HW = (64, 112)


@pytest.fixture(scope="module")
def engines(seeded_colormnet):
    """The JAX engine with the seeded tree and the port's with the same
    network, at 64x112; the JAX compile cache kept for the module."""
    tree, net = seeded_colormnet
    te = tex.ColorMNetEngine(config="micro", work_size=HW, device="cpu")
    te.net = net
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitcache, "_CACHE", {})
        yield _SeededEngine(tree, work_size=HW), te


def _clip(T, refs, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.random((T,) + HW + (3,), dtype=np.float32)
    ref_ab = (rng.random((T,) + HW + (2,), dtype=np.float32) * 2 - 1) * 0.4
    is_ref = np.zeros(T, bool)
    is_ref[refs] = True
    return frames, ref_ab, is_ref


CASES = {"equal": (12, [0, 4, 8], True), "ragged": (11, [0, 2, 7], True),
         "exemplar": (8, [0, 4], False), "long": (30, [0, 13], True)}


def _exemplar_refs(frames):
    return np.clip(frames * 0.9 + 0.05, 0, 1)


@pytest.mark.parametrize("case", ["equal", "exemplar"])
def test_scenes_match_jax(engines, case):
    je, te = engines
    T, refs, fp = CASES[case]
    frames, ref_ab, is_ref = _clip(T, refs)
    kw = dict(frame_propagate=fp, ref_frames=None if fp else _exemplar_refs(frames))
    want = jex.colormnet_propagate_scenes(je, frames, ref_ab, is_ref, **kw)
    got = tex.colormnet_propagate_scenes(te, frames, ref_ab, is_ref, **kw)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape == (T,) + HW + (2,)
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_scenes_match_sequential(engines, case):
    """``long``: scenes of 13 and 17 frames with a long-term store of 16
    tokens, so the working store consolidates and the long-term store
    evicts inside the batched step."""
    _, te = engines
    T, refs, fp = CASES[case]
    if case == "long":
        te = tex.ColorMNetEngine(config="micro", work_size=HW, max_mem=16, device="cpu")
        te.net = engines[1].net
    frames, ref_ab, is_ref = _clip(T, refs, seed=1)
    kw = dict(frame_propagate=fp, ref_frames=None if fp else _exemplar_refs(frames))
    seq, carry = tex.colormnet_propagate(te, frames, ref_ab, is_ref, vivid=True,
                                         return_state=True, **kw)
    par = tex.colormnet_propagate_scenes(te, frames, ref_ab, is_ref, **kw)
    np.testing.assert_allclose(par.numpy(), seq.numpy(), **SEQ)
    if case == "long":
        assert carry[0].lt_valid.sum().item() == 16  # the store filled, then evicted


def test_no_crosstalk(engines):
    """Other frames in the middle scene leave the two others as they were."""
    _, te = engines
    frames, ref_ab, is_ref = _clip(11, [0, 2, 7], seed=2)
    a = tex.colormnet_propagate_scenes(te, frames, ref_ab, is_ref)
    frames2, ref_ab2 = frames.copy(), ref_ab.copy()
    frames2[2:7], ref_ab2[2:7] = frames[2:7][::-1], -ref_ab[2:7]
    b = tex.colormnet_propagate_scenes(te, frames2, ref_ab2, is_ref)
    keep = np.r_[0:2, 7:11]
    np.testing.assert_allclose(b[keep].numpy(), a[keep].numpy(), **SEQ)
    assert (b[2:7] - a[2:7]).abs().max().item() > 1e-3


def test_requires_leading_ref(engines):
    _, te = engines
    frames, ref_ab, is_ref = _clip(4, [1])
    with pytest.raises(ValueError, match="is_ref\\[0\\]"):
        tex.colormnet_propagate_scenes(te, frames, ref_ab, is_ref)


def test_empty_clip(engines):
    _, te = engines
    out = tex.colormnet_propagate_scenes(te, np.zeros((0,) + HW + (3,), np.float32),
                                         np.zeros((0,) + HW + (2,), np.float32),
                                         np.zeros(0, bool))
    assert isinstance(out, torch.Tensor) and out.shape == (0,) + HW + (2,)


# --- HAVC_deepex(scene_parallel=True) ---------------------------------------------------


def _jax_warning() -> str:
    """The text the JAX package logs when it sends a scene_parallel request
    to the sequential scan (read from its source)."""
    tree = ast.parse(open(jex.__file__).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "HAVC_LogMessage"
                and len(node.args) == 2 and isinstance(node.args[1], ast.Constant)
                and "scene_parallel" in node.args[1].value):
            return node.args[1].value
    raise AssertionError("no scene_parallel warning in havc_tpu.exemplar")


class _Spy:
    def __init__(self, mp):
        self.meshes = []
        real = tex.colormnet_propagate_scenes

        def spy(*a, **kw):
            self.meshes.append(kw.get("mesh"))
            return real(*a, **kw)

        mp.setattr(tex, "colormnet_propagate_scenes", spy)


def _deepex(frames, refs, **kw):
    flags = havc_tpu_torch.SceneFlags.from_frame_list(len(frames), refs)
    ref = havc_tpu_torch.Clip(frames=frames).with_sc(flags)
    out = havc_tpu_torch.HAVC_deepex(havc_tpu_torch.Clip(frames=frames), ref, device="cpu",
                                     **kw)
    return out.frames


@pytest.fixture(scope="module")
def dispatch_clip():
    return _scene_clip(n_scenes=4, per=2, h=40, w=64, seed=4).astype(np.float32)


@pytest.mark.parametrize("case", ["not_vivid", "one_reference", "encode_mode_2"])
def test_dispatch_falls_back_with_the_jax_warning(colormnet_both, dispatch_clip, case,
                                                  monkeypatch, caplog):
    frames = dispatch_clip
    refs = [0] if case == "one_reference" else [0, 2, 4, 6]
    kw = dict(render_vivid=case != "not_vivid", encode_mode=2 if case == "encode_mode_2" else 0)
    spy = _Spy(monkeypatch)
    caplog.set_level(logging.WARNING)
    got = _deepex(frames, refs, scene_parallel=True, **kw)
    msgs = [r.getMessage() for r in caplog.records if r.name == "havc_tpu_torch"]
    assert msgs == [_jax_warning()] and spy.meshes == []
    caplog.clear()
    want = _deepex(frames, refs, **kw)
    assert not caplog.records
    assert np.array_equal(got, want)


def test_dispatch_takes_the_scene_scan(colormnet_both, dispatch_clip, monkeypatch, caplog):
    frames = dispatch_clip
    spy = _Spy(monkeypatch)
    caplog.set_level(logging.WARNING)
    mesh = make_mesh(2, platform="cpu")
    par = _deepex(frames, [0, 2, 4, 6], scene_parallel=True)
    par_mesh = _deepex(frames, [0, 2, 4, 6], scene_parallel=True, scene_mesh=mesh)
    seq = _deepex(frames, [0, 2, 4, 6])
    assert not caplog.records and spy.meshes == [None, mesh]
    np.testing.assert_allclose(par_mesh, par, atol=1e-5)
    np.testing.assert_allclose(par, seq, **SEQ)


# --- device_trace -----------------------------------------------------------------------


@pytest.mark.parametrize("level", [None, 2])
def test_device_trace_writes_a_chrome_trace(tmp_path, level):
    """``utils.device_trace`` around a port op writes one Chrome trace that
    parses as JSON and holds the op's events (with their input shapes at
    ``host_tracer_level`` 2)."""
    from havc_tpu_torch.ops.colorspace import rgb_to_lab
    from havc_tpu_torch.utils import device_trace

    x = torch.rand((2, 16, 24, 3))
    with device_trace(str(tmp_path / "trace"), host_tracer_level=level):
        rgb_to_lab(x)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    ops = [e for e in events if e.get("name", "").startswith("aten::")]
    assert ops
    assert any("Input Dims" in e.get("args", {}) for e in ops) == (level == 2)
