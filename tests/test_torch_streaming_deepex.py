"""``HAVC_restore_video_streaming`` with Deep-Exemplar, DeepRemaster and
the hybrid (``ex_model`` 1/2/3): the port against the JAX package's, and
against itself whole and in memory, on the CPU.

Both packages recolor tests/test_torch_streaming_restore.py's 12-frame
B&W mp4 from its colored reference (tint and luma jump every 5 frames) at
work size 32x32, ``sink="null"``, with the same weights (seeded with
numpy, ``seeded_params``): Deep-Exemplar
and NetworkC at their published widths (tests/test_torch_deepex.py's and
tests/test_torch_remaster.py's seeded trees; DeepEx's own size cut to
the work size, as the Medium preset has it at 1080p) and the micro
ColorMNet for the hybrid.  Checked, on what each
``_WritePipeline._retire`` receives (the packed chroma planes, in codes):

* the port at chunk 4 against the JAX package at chunk 4 (DeepRemaster:
  a window of 4 references that slides, so the look-ahead cursor decodes
  ahead of the input; chunk 3 rounds up to 4);
* the port at chunk 4 against the port at chunk 12 (the engines' carries:
  DeepEx's scene reference, DeepRemaster's window, ColorMNet's memory);
* the port's stream against its in-memory ``HAVC_restore_video`` on the
  same decoded frames with the same settings (``frame_propagate=False``,
  vivid, the same references), packed the same way, for DeepEx and
  DeepRemaster.  Not for the hybrid: its ColorMNet half inserts each
  exemplar with the B&W frame's luma in the stream (as the JAX package's
  stream does) and with the reference's luma in memory.

Tolerance: 1 code value, at most 1 % of the codes unequal (DeepEx runs at
temperature 1e-10; a flipped argmax would move a block of codes).
"""
import numpy as np
import pytest
import torch

import havc_tpu_torch
import havc_tpu_torch.engines as tengines
from havc_tpu_torch import exemplar as tex
from havc_tpu_torch import streaming as tstream
from havc_tpu_torch.io.stream import FrameReader
from havc_tpu_torch.utils.transfer import rgb_unit_to_uv420_u8

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_deepex import JaxDeepEx, deepex_net, deepex_trees
from test_torch_exemplar_surface import seeded_colormnet  # noqa: F401  (fixture)
from test_torch_remaster import JaxRemaster, remaster_net, remaster_tree
from test_torch_streaming_restore import (  # noqa: F401  (fixtures)
    _GROUPS, _joined, _record, scene_pair)

CPU = torch.device("cpu")
T = 12
DX_SIZE = (32, 32)  # DeepEx's own size: the work size, as at the Medium preset
WORK = (32, 32)


@pytest.fixture(scope="module")
def engines_both(seeded_colormnet):
    """Deep-Exemplar, NetworkC and the micro ColorMNet in both packages, the
    JAX compile cache kept for the module."""
    from havc_tpu import exemplar as jex
    from havc_tpu.utils import jitcache

    cm_tree, net = seeded_colormnet

    class _TreeEngine(jex.ColorMNetEngine):
        def _init_params(self, seed):
            for group, attr in _GROUPS:
                setattr(self, attr, {"params": cm_tree[group]})
            self.g16_hw = (self.h // 16, self.w // 16)

    dtrees, rtree = deepex_trees(*DX_SIZE), remaster_tree()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitcache, "_CACHE", {})
        mp.setattr(jex, "_ENGINE_CACHE", {
            ("colormnet", (("config", "micro"), ("work_size", (112, 112)))):
                _TreeEngine(config="micro", work_size=(112, 112))})
        mp.setattr(jex, "DeepExEngine", lambda speed="medium", seed=0: JaxDeepEx(dtrees, speed))
        mp.setattr(jex, "RemasterEngine", lambda **kw: JaxRemaster(rtree, **kw))
        mp.setitem(tengines.registry._cache, ("colormnet", "micro", CPU), net)
        mp.setitem(tengines.registry._cache, ("deepex", "full", CPU), deepex_net(dtrees))
        mp.setitem(tengines.registry._cache, ("remaster", "full", CPU), remaster_net(rtree))
        mp.setattr(tex, "_ENGINE_CACHE", {})
        for mod in (jex, tex):
            mp.setattr(mod, "smart_resize_shape", lambda width, height, speed="medium": DX_SIZE)
        yield jex


def _codes_close(want, got, what):
    assert want.shape == got.shape, (what, want.shape, got.shape)
    diff = np.abs(want - got)
    share = float(np.mean(diff > 0))
    print(f"{what}: max |diff| {diff.max()}, unequal {share:.3%} of {diff.size}")
    assert diff.max() <= 1 and share <= 0.01, what


def _decoded(path, gray=False):
    with FrameReader(path) as r:
        u8 = r.read(T, gray=gray)
    x = torch.from_numpy(u8).float() / 255.0
    return x[..., None].expand(-1, -1, -1, 3).contiguous() if gray else x


KW = {1: dict(), 2: dict(max_memory_frames=4, chunk_size=3), 3: dict()}


@pytest.mark.parametrize("ex_model", [1, 2, 3], ids=["deepex", "remaster", "hybrid"])
def test_restore_streaming_engines(engines_both, scene_pair, monkeypatch, ex_model):
    from havc_tpu import streaming as jstream

    src, ref = scene_pair
    kw = dict(work_size=WORK, sink="null", engine_config="micro", ex_model=ex_model,
              frame_propagate=False, render_vivid=True, **KW[ex_model])
    kw.setdefault("chunk_size", 4)
    want = _record(monkeypatch, jstream._WritePipeline, np.asarray)
    assert jstream.HAVC_restore_video_streaming(src, ref, "unused.mp4", **kw) == T
    got = {}
    for chunk in (kw["chunk_size"], T):
        rec = _record(monkeypatch, tstream._WritePipeline, lambda p: p.wait())
        assert tstream.HAVC_restore_video_streaming(src, ref, "unused.mp4", device="cpu",
                                                    **dict(kw, chunk_size=chunk)) == T
        assert tstream.last_transfer() == "gray+uv420"
        got[chunk] = _joined(rec, "packed")
    assert len(rec) == 1 and len(want) == 3  # one chunk, and three of 4
    _codes_close(_joined(want, "packed"), got[kw["chunk_size"]], "port vs havc_tpu")
    _codes_close(got[kw["chunk_size"]], got[T], f"port chunk {kw['chunk_size']} vs {T}")

    if ex_model == 3:
        return
    # the in-memory restore on the same decoded frames, the same settings
    monkeypatch.setattr(tex, "remaster_work_shape", lambda width, height, frame_mindim=320: WORK)
    monkeypatch.setattr(tex, "smart_resize_shape", lambda width, height, speed="medium": WORK)
    monkeypatch.setattr(tex.DeepExEngine, "__init__", _deepex_at(DX_SIZE))
    colored = havc_tpu_torch.HAVC_restore_video(
        havc_tpu_torch.Clip(frames=_decoded(src, gray=True)),
        havc_tpu_torch.Clip(frames=_decoded(ref)), ex_model=ex_model, render_vivid=True,
        max_memory_frames=kw.get("max_memory_frames", 0), engine_config="micro", device="cpu")
    mem = rgb_unit_to_uv420_u8(colored.frames).numpy().astype(np.int16)
    _codes_close(mem, got[T], "port in memory vs streamed")


def _deepex_at(size):
    """``DeepExEngine.__init__`` with DeepEx's size fixed (the in-memory
    path reads it from the work-size rule, patched here to the stream's)."""
    real = tex.DeepExEngine.__init__

    def init(self, speed="medium", device=None):
        real(self, speed, device)
        self.h, self.w = size

    return init
