"""The port's streaming path against the JAX package's, on the CPU.

``HAVC_main_streaming`` runs in both packages on the same 40-frame mp4
(decoded by OpenCV on both sides), with a small DeOldifyWide ("nano",
nf_factor 1) under ``video`` and DDColor ``micro`` under ``artistic``
carried from flax with ``models/bridge``, and the engine factories patched
to render factor 4, as tests/test_torch_main_path.py does.  What each
package's ``_WritePipeline._retire`` receives (the packed uint8 chunk and,
in ``uv420`` mode, the host's studio-swing Y planes) is captured with
``sink="null"`` and compared: at most 1 code value apart, over chunk sizes
8 and 16 and the transfer modes gray+uv420, gray+i420 and rgb+rgb.  The
share of unequal codes is printed with each case; it comes from float32
sums in another order (convolutions, resize matrix products) landing on
the other side of a rounding boundary.

Also here: the transfer helpers bit-exact against havc_tpu and OpenCV,
the Y4M reader against a transcription of the native reader's conversion
and against the native reader itself, the bounded buffers, the write
pipeline's depth, the sinks and sources, the guards on the rolling
buffers, signatures, the options that are not ported, and the card tests
(marker ``cuda``).

The JAX package and OpenCV are imported inside fixtures only, so that
the card tests run where neither is installed (``python -m pytest
--noconftest tests/test_torch_streaming.py -m cuda`` on the machine with
the GPU).
"""
import copy
import inspect
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import havc_tpu_torch
import havc_tpu_torch.engines as tengines
from havc_tpu_torch import streaming as tstream
from havc_tpu_torch.io import y4m as ty4m
from havc_tpu_torch.utils import transfer as ttransfer

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
T, H, W = 40, 48, 64


# --- shared set-up -------------------------------------------------------------------


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import havc_tpu.engines as jengines
    from havc_tpu import streaming
    from havc_tpu.models import ddcolor as jdd
    from havc_tpu.models import deoldify as jdo
    from havc_tpu.utils import jitcache
    from havc_tpu.utils import transfer

    return types.SimpleNamespace(engines=jengines, streaming=streaming, dd=jdd, do=jdo,
                                 jitcache=jitcache, transfer=transfer)


@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


def _perturb(tree, seed):
    """Move BatchNorm statistics and the layer-scale gates off their init
    values, so every carried leaf matters."""
    import jax

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


@pytest.fixture(scope="module")
def engines_pair(J):
    """(flax params, torch module) for DeOldify nano and DDColor micro."""
    import jax
    import jax.numpy as jnp

    from havc_tpu_torch.models import ddcolor as tdd
    from havc_tpu_torch.models import deoldify as tdo
    from havc_tpu_torch.models.bridge import state_dict_from_flax

    def carry(jmodel, tmodel, seed):
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
        params = {"params": _perturb(params["params"], seed)}
        tmodel.load_state_dict(state_dict_from_flax(params["params"]))
        return params, tmodel.eval().requires_grad_(False)

    return (carry(J.do.DeOldifyWide(encoder="nano", nf_factor=1),
                  tdo.DeOldifyWide(encoder="nano", nf_factor=1), 0),
            carry(J.dd.DDColor.from_config("micro"), tdd.DDColor.from_config("micro"), 1))


# the JAX package's compiled stages are shared by this module's tests
# (same engines, same knobs) and dropped after it
_JIT_CACHE: dict = {}


@pytest.fixture
def small_engines(J, engines_pair, monkeypatch):
    """Both packages' registries hold the small engines under the default
    names; both engine factories run at render factor 4."""
    (jp_do, tm_do), (jp_dd, tm_dd) = engines_pair
    monkeypatch.setattr(J.jitcache, "_CACHE", _JIT_CACHE)
    monkeypatch.setitem(J.engines.registry._cache, ("deoldify", "video"),
                        (J.do.DeOldifyWide(encoder="nano", nf_factor=1), jp_do))
    monkeypatch.setitem(J.engines.registry._cache, ("ddcolor", "artistic"),
                        (J.dd.DDColor.from_config("micro"), jp_dd))
    j_do, j_dd = J.engines.make_deoldify_fn, J.engines.make_ddcolor_fn
    monkeypatch.setattr(J.engines, "make_deoldify_fn",
                        lambda model=0, render_factor=24: j_do(model, 4))
    monkeypatch.setattr(J.engines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: j_dd(model, 4, **kw))
    _torch_engines(monkeypatch, {CPU: (tm_do, tm_dd)})


def _torch_engines(monkeypatch, models):
    """The port's registry holds ``models[device] = (deoldify, ddcolor)``;
    its factories run at render factor 4."""
    for dev, (do, dd) in models.items():
        monkeypatch.setitem(tengines.registry._cache, ("deoldify", "video", dev), do)
        monkeypatch.setitem(tengines.registry._cache, ("ddcolor", "artistic", dev), dd)
    t_do, t_dd = tengines.make_deoldify_fn, tengines.make_ddcolor_fn
    monkeypatch.setattr(tengines, "make_deoldify_fn",
                        lambda model=0, render_factor=24, **kw: t_do(model, 4, **kw))
    monkeypatch.setattr(tengines, "make_ddcolor_fn",
                        lambda model=1, render_factor=24, **kw: t_dd(model, 4, **kw))


def _seeded_engines():
    """Small engines with seeded random weights, no JAX needed."""
    from havc_tpu_torch.models import ddcolor as tdd
    from havc_tpu_torch.models import deoldify as tdo
    from havc_tpu_torch.models.layers import init_flax_defaults

    gen = torch.Generator().manual_seed(3)
    out = []
    for m in (tdo.DeOldifyWide("nano", nf_factor=1), tdd.DDColor.from_config("micro")):
        init_flax_defaults(m, gen)
        out.append(m.eval().requires_grad_(False))
    return tuple(out)


@pytest.fixture
def seeded_engines(monkeypatch):
    _torch_engines(monkeypatch, {CPU: _seeded_engines()})


def _gray_frames(t=T, h=H, w=W, seed=0):
    """(t, h, w) uint8: a smooth random field that drifts and brightens
    over time (smooth at chroma scale, as real footage is)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.random(4) * 6.0
    out = []
    for i in range(t):
        g = (0.45 + 0.25 * np.sin(xx / 9.0 + ph[0] + i / 7.0) * np.cos(yy / 11.0 + ph[1])
             + 0.15 * np.sin((xx + yy) / 17.0 + ph[2] - i / 5.0) + 0.05 * np.sin(i / 3.0))
        out.append(np.clip(np.rint(g * 255.0), 0, 255).astype(np.uint8))
    return np.stack(out)


def _write_gray_mp4(cv2, path, frames):
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (frames.shape[2], frames.shape[1]))
    for g in frames:
        wr.write(cv2.merge([g, g, g]))
    wr.release()


def _write_y4m(path, y, u=None, v=None, colorspace="420mpeg2"):
    """(t, h, w) Y planes (and (t, h/2, w/2) U, V planes; neutral when
    omitted) as a .y4m file."""
    t, h, w = y.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{colorspace}\n".encode())
        for i in range(t):
            f.write(b"FRAME\n")
            f.write(y[i].tobytes())
            if colorspace != "mono":
                for c in (u, v):
                    plane = np.full(((h + 1) // 2, (w + 1) // 2), 128, np.uint8) if c is None else c[i]
                    f.write(plane.tobytes())


@pytest.fixture(scope="module")
def gray_mp4(cv2, tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / "in.mp4"
    _write_gray_mp4(cv2, path, _gray_frames())
    return str(path)


def _record_retire(monkeypatch, cls, to_host):
    """Patch ``cls._retire`` to record what each retire receives: the
    packed chunk's n frames and, in uv420 mode, the Y planes the host
    provides.  A second call replaces the first spy."""
    orig = getattr(cls._retire, "__wrapped__", cls._retire)
    rec = []

    def spy(self, packed, meta, n):
        entry = {"packed": np.array(to_host(packed))[:n]}
        yp = self.y_provider
        if self.use_uv420:
            def y_spy(m, k):
                y = yp(m, k)
                entry["y"] = np.array(y)[:k]
                return y

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
    """At most 1 code value apart; prints the share of unequal codes."""
    assert want.shape == got.shape, (what, want.shape, got.shape)
    diff = np.abs(want - got)
    print(f"{what}: max |diff| {diff.max()}, unequal {np.mean(diff > 0):.3%} of {diff.size}")
    assert diff.max() <= 1, what


# --- HAVC_main_streaming against havc_tpu --------------------------------------------


@pytest.mark.parametrize("mode,kw", [
    ("gray+uv420", {}),
    ("gray+i420", dict(transfer_format="i420")),
    ("rgb+rgb", dict(gray_input=False, transfer_format="rgb")),
], ids=["uv420", "i420", "rgb"])
@pytest.mark.parametrize("chunk_size", [8, 16])
def test_main_streaming_matches_jax(J, small_engines, gray_mp4, monkeypatch, chunk_size, mode,
                                    kw):
    want = _record_retire(monkeypatch, J.streaming._WritePipeline, np.asarray)
    got = _record_retire(monkeypatch, tstream._WritePipeline, lambda p: p.wait())
    args = dict(batch_size=8, chunk_size=chunk_size, sink="null", **kw)
    assert J.streaming.HAVC_main_streaming(gray_mp4, "unused.mp4", **args) == T
    assert J.streaming.last_transfer() == mode
    assert havc_tpu_torch.HAVC_main_streaming(gray_mp4, "unused.mp4", device="cpu", **args) == T
    assert tstream.last_transfer() == mode
    assert [len(e["packed"]) for e in got] == [len(e["packed"]) for e in want]
    _codes_close(_joined(want, "packed"), _joined(got, "packed"), f"{mode} chunk {chunk_size}")
    if mode == "gray+uv420":
        assert np.array_equal(_joined(want, "y"), _joined(got, "y"))
    assert not os.path.exists("unused.mp4")


def test_stage_matches_jax(J, small_engines):
    """The per-frame stage alone, on one gray uint8 batch: luma planes and
    the colorized work frames (merge method 3 and the filters)."""
    import jax.numpy as jnp

    from havc_tpu import presets as jpresets

    _, do_rf, dd_rf = jpresets.get_render_factors("medium")
    dd_tweak, hue_range, hue_range2, _, cmap2 = jpresets.get_color_tune(
        "light", "violet/red", "none", 1)
    args = (3, 0.5, 0, 1, do_rf, dd_rf, dd_tweak, hue_range, hue_range2, cmap2, W)
    frames = _gray_frames(t=8)
    jstage, params = J.streaming._build_frame_stage(*args)
    want = [np.asarray(a) for a in jstage(params, jnp.asarray(frames))]
    got = tstream._build_frame_stage(*args, device="cpu")(torch.from_numpy(frames))
    assert got[0].shape == want[0].shape == (8, H, W)
    assert got[1].shape == want[1].shape == (8, W, W, 3)
    assert np.abs(got[0].numpy() - want[0]).max() <= 1e-6
    assert np.abs(got[1].numpy() - want[1]).max() <= 1e-4


# --- bounded memory, depth, sinks and sources -----------------------------------------


def test_streaming_bounded_buffers(seeded_engines, tmp_path, monkeypatch):
    """The rolling device buffers stay within the un-emitted chunk (8),
    the retained window of 2 * halo (3: nframes 5 -> 2, +1 for the host
    deflicker) and one batch (4), whatever the clip's length."""
    src = tmp_path / "in.y4m"
    _write_y4m(src, _gray_frames(t=64))
    peak = {"n": 0}
    orig_append = tstream._FrameBuf.append

    def spy_append(self, batch):
        orig_append(self, batch)
        peak["n"] = max(peak["n"], len(self))

    monkeypatch.setattr(tstream._FrameBuf, "append", spy_append)
    n = tstream.HAVC_main_streaming(str(src), "unused.mp4", batch_size=4, chunk_size=8,
                                    sink="null", device="cpu")
    assert n == 64
    assert 0 < peak["n"] <= 8 + 2 * 3 + 4


def test_pipeline_depth_keeps_bytes(seeded_engines, tmp_path, monkeypatch):
    """Depth 1 (one chunk behind) and depth 3 retire the same bytes."""
    src = tmp_path / "in.y4m"
    _write_y4m(src, _gray_frames(t=24))
    outs = {}
    for depth in (1, 3):
        rec = _record_retire(monkeypatch, tstream._WritePipeline, lambda p: p.wait())
        n = tstream.HAVC_main_streaming(str(src), "unused.mp4", batch_size=8, chunk_size=8,
                                        pipeline_depth=depth, sink="null", device="cpu")
        assert n == 24
        outs[depth] = (_joined(rec, "packed"), _joined(rec, "y"))
    assert all(np.array_equal(a, b) for a, b in zip(outs[1], outs[3]))


def test_write_pipeline_depth_semantics():
    """``pipeline_depth`` counts chunks left in flight after the current
    one is queued: depth 1 retires the previous chunk, depth 3 holds
    three."""
    retired = []

    class _Spy(tstream._WritePipeline):
        def _retire(self, packed, meta, n):
            retired.append(meta)
            super()._retire(packed, meta, n)

    chunk = torch.zeros((2, 4, 4), dtype=torch.uint8)
    p1 = _Spy("device", None, 1, False, False)
    p1.push(chunk, "a", 2)
    assert retired == []
    p1.push(chunk, "b", 2)
    assert retired == ["a"]
    p1.finish()
    assert retired == ["a", "b"] and p1.written == 4

    retired.clear()
    p3 = _Spy("device", None, 3, False, False)
    for m in "abcd":
        p3.push(chunk, m, 2)
    assert retired == ["a"]
    p3.finish()
    assert retired == ["a", "b", "c", "d"] and p3.written == 8


def test_sinks_and_device_source(seeded_engines, tmp_path):
    """The null sink (download, no encode) and the device sink (no
    download) process every frame and write nothing; source="device"
    feeds count // batch_size batches and needs count >= batch_size."""
    src = tmp_path / "in.y4m"
    _write_y4m(src, _gray_frames(t=12))
    for sink in ("null", "device"):
        out = tmp_path / f"out_{sink}.mp4"
        n = tstream.HAVC_main_streaming(str(src), str(out), batch_size=8, chunk_size=8,
                                        sink=sink, device="cpu")
        assert n == 12 and not out.exists()
    kw = dict(batch_size=8, chunk_size=8, source="device", device="cpu")
    assert tstream.HAVC_main_streaming(str(src), "x.mp4", sink="device", count=24, **kw) == 24
    assert tstream.HAVC_main_streaming(str(src), "x.mp4", sink="null", count=20, **kw) == 16
    with pytest.raises(ValueError, match="requires count"):
        tstream.HAVC_main_streaming(str(src), "x.mp4", **kw)
    with pytest.raises(ValueError, match="batch_size"):
        tstream.HAVC_main_streaming(str(src), "x.mp4", count=4, **kw)
    with pytest.raises(ValueError, match="source"):
        tstream.HAVC_main_streaming(str(src), "x.mp4", source="bogus", device="cpu")
    with pytest.raises(ValueError, match="sink"):
        tstream.HAVC_main_streaming(str(src), "x.mp4", sink="bogus", device="cpu")


def test_video_sink_writes_the_clip(seeded_engines, cv2, tmp_path):
    """The video sink encodes every frame at the input's geometry."""
    src, out = tmp_path / "in.y4m", tmp_path / "out.mp4"
    _write_y4m(src, _gray_frames(t=10))
    assert tstream.HAVC_main_streaming(str(src), str(out), batch_size=4, chunk_size=8,
                                       device="cpu") == 10
    cap = cv2.VideoCapture(str(out))
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr)
    cap.release()
    assert len(frames) == 10 and frames[0].shape == (H, W, 3)


def test_transfer_mode_resolution():
    """uv420 only when the host owns the output luma (even sides, gray
    upload, no luma retune on the device); requests that fail the gate
    fall back as auto does; odd sides give rgb."""
    cases = [
        (("auto", True, True, False), (True, False, "gray+uv420")),
        (("auto", True, True, True), (False, True, "gray+i420")),
        (("auto", True, False, False), (False, True, "rgb+i420")),
        (("auto", False, True, False), (False, False, "gray+rgb")),
        (("uv420", True, True, False), (True, False, "gray+uv420")),
        (("uv420", True, False, False), (False, True, "rgb+i420")),
        (("uv420", False, True, False), (False, False, "gray+rgb")),
        (("i420", True, True, False), (False, True, "gray+i420")),
        (("i420", False, False, False), (False, False, "rgb+rgb")),
        (("rgb", True, True, False), (False, False, "gray+rgb")),
    ]
    for args, (uv, i420, last) in cases:
        assert tstream._resolve_transfer(*args) == (uv, i420), args
        assert tstream.last_transfer() == last, args


# --- guards -----------------------------------------------------------------------------


def test_frame_buffer_guards():
    buf = tstream._FrameBuf()
    with pytest.raises(ValueError, match="empty"):
        buf.window(0, 2)
    buf.append(torch.arange(4.0).reshape(4, 1))
    buf.append(torch.arange(4.0, 6.0).reshape(2, 1))
    with pytest.raises(ValueError, match="holds none"):
        buf.window(6, 8)
    with pytest.raises(ValueError, match="7"):
        buf.drop(7)
    assert buf.window(-2, 3)[:, 0].tolist() == [0, 0, 0, 1, 2]
    assert buf.window(4, 8)[:, 0].tolist() == [4, 5, 5, 5]
    buf.drop(5)
    assert len(buf) == 1 and buf.window(0, 2)[:, 0].tolist() == [5, 5]


def test_retire_counts_the_queued_frames():
    """A packed chunk that carries padding frames: every sink writes and
    counts the queued n only."""
    class _Writer:
        frames = 0

        def write(self, fr):
            _Writer.frames += 1

    chunk = torch.zeros((4, 6, 8, 3), dtype=torch.uint8)
    for sink, writer in (("null", None), ("video", _Writer()), ("device", None)):
        if writer is not None:
            pytest.importorskip("cv2")
        p = tstream._WritePipeline(sink, writer, 1, False, False)
        p.push(chunk, None, 2)
        p.finish()
        assert p.written == 2, sink
    assert _Writer.frames == 2


# --- transfer helpers and the Y4M reader ----------------------------------------------


def test_transfer_helpers_bit_exact(J, cv2):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    u8 = np.arange(256, dtype=np.uint8)
    unit = ttransfer.u8_to_unit(torch.from_numpy(u8)).numpy()
    assert np.array_equal(unit, np.asarray(J.transfer.u8_to_unit(jnp.asarray(u8))))
    assert np.array_equal(ttransfer.unit_to_u8(torch.from_numpy(unit)).numpy(), u8)
    # values on and between the code boundaries, out of range, and ties
    x = np.concatenate([rng.random(4096, dtype=np.float32) * 1.2 - 0.1,
                        (np.arange(256, dtype=np.float32) + 0.5) / 255.0]).astype(np.float32)
    assert np.array_equal(ttransfer.unit_to_u8(torch.from_numpy(x)).numpy(),
                          np.asarray(J.transfer.unit_to_u8(jnp.asarray(x))))
    frames = rng.random((3, 10, 14, 3), dtype=np.float32)
    frames[0, :2] = frames[0, :2].round(1)  # exact ties
    i420 = ttransfer.rgb_unit_to_i420_u8(torch.from_numpy(frames)).numpy()
    assert np.array_equal(i420, np.asarray(J.transfer.rgb_unit_to_i420_u8(jnp.asarray(frames))))
    for f, packed in zip(frames, i420):
        want = cv2.cvtColor(ttransfer.unit_to_u8(torch.from_numpy(f)).numpy(),
                            cv2.COLOR_RGB2YUV_I420)
        assert np.array_equal(packed, want)
    uv = ttransfer.rgb_unit_to_uv420_u8(torch.from_numpy(frames)).numpy()
    assert np.array_equal(uv, i420[:, 10:])
    g = rng.integers(0, 256, (2, 5, 7), dtype=np.uint8)
    rgb = ttransfer.gray_to_rgb(torch.from_numpy(g)).numpy()
    assert np.array_equal(rgb, np.asarray(J.transfer.gray_to_rgb(jnp.asarray(g))))
    # the host's studio-swing Y equals the Y plane of the pack
    assert np.array_equal(tstream._studio_y(g), np.asarray(J.streaming._studio_y(g)))


def _framepipe_rgb(y, u, v):
    """``yuv420_rows_to_rgb`` of native/framepipe.cpp, pixel by pixel in
    float32, then the round-half-even quantisation."""
    f = np.float32
    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    for r in range(h):
        for c in range(w):
            Y = f(y[r, c]) / f(255.0)
            U = f(u[r // 2, c // 2]) / f(255.0) - f(0.5)
            V = f(v[r // 2, c // 2]) / f(255.0) - f(0.5)
            rr = Y + V / f(0.877)
            bb = Y + U / f(0.492)
            gg = (Y - f(0.299) * rr - f(0.114) * bb) / f(0.587)
            for k, val in enumerate((rr, gg, bb)):
                val = min(max(val, f(0.0)), f(1.0))
                out[r, c, k] = np.uint8(np.rint(f(val) * f(255.0)))
    return out


def _yuv_clip(t, h, w, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (t, h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (t, (h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
    v = rng.integers(0, 256, (t, (h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
    return y, u, v


@pytest.mark.parametrize("h,w", [(6, 8), (5, 7)], ids=["even", "odd"])
def test_y4m_reader_matches_framepipe_transcription(tmp_path, h, w):
    y, u, v = _yuv_clip(3, h, w, 5)
    path = tmp_path / "c.y4m"
    _write_y4m(path, y, u, v)
    with ty4m.Y4MReader(str(path)) as r:
        assert (r.width, r.height, r.fps, r.colorspace) == (w, h, 25.0, "420mpeg2")
        rgb = r.read(2)
        rest = r.read(5)
        assert r.read(1) is None
    assert rgb.shape == (2, h, w, 3) and rest.shape == (1, h, w, 3)
    for i, got in enumerate(np.concatenate([rgb, rest])):
        assert np.array_equal(got, _framepipe_rgb(y[i], u[i], v[i]))
    with ty4m.Y4MReader(str(path)) as r:
        assert np.array_equal(r.read(3, gray=True), y)


def test_y4m_reader_matches_native_reader(J, tmp_path):
    """Against havc_tpu.io.native.Y4MStream (float32 RGB) where its
    library builds: each code is the rounding of the native value (its
    float32 arithmetic may fuse multiply-adds: within 1e-3 of a code)."""
    native = pytest.importorskip("havc_tpu.io.native")
    try:
        native.load_native()
    except native.NativeUnavailable as e:
        pytest.skip(f"the native frame pipeline does not build here: {e}")
    y, u, v = _yuv_clip(4, 16, 24, 6)
    path = str(tmp_path / "c.y4m")
    _write_y4m(path, y, u, v)
    stream = native.Y4MStream(path)
    try:
        want = np.stack(list(stream)) * 255.0
    finally:
        stream.close()
    with ty4m.Y4MReader(path) as r:
        got = r.read(8).astype(np.float32)
    assert got.shape == want.shape == (4, 16, 24, 3)
    assert np.abs(got - want).max() <= 0.5 + 1e-3


def test_y4m_mono_and_rejects(tmp_path):
    y = _yuv_clip(2, 4, 6, 7)[0]
    path = tmp_path / "m.y4m"
    _write_y4m(path, y, colorspace="mono")
    with ty4m.Y4MReader(str(path)) as r:
        rgb = r.read(4)
    assert np.array_equal(rgb, np.repeat(y[..., None], 3, axis=-1))
    bad = tmp_path / "b.y4m"
    bad.write_bytes(b"YUV4MPEG2 W4 H4 F25:1 C444\nFRAME\n" + bytes(48))
    with pytest.raises(ValueError, match="C444"):
        ty4m.Y4MReader(str(bad))
    junk = tmp_path / "j.y4m"
    junk.write_bytes(b"YUV4MPEG2 W4 H4 C420\nFRAMX\n" + bytes(24))
    with ty4m.Y4MReader(str(junk)) as r, pytest.raises(ValueError, match="FRAME"):
        r.read(1)


def test_stream_batches_y4m_and_errors(tmp_path):
    from havc_tpu_torch.io import stream_batches

    y = _gray_frames(t=11, h=8, w=10)
    path = tmp_path / "g.y4m"
    _write_y4m(path, y)
    got = list(stream_batches(str(path), batch_size=4, gray=True))
    assert [len(b) for b in got] == [4, 4, 3]
    assert np.array_equal(np.concatenate(got), y)
    assert [len(b) for b in stream_batches(str(path), batch_size=4, count=6)] == [4, 2]
    it = stream_batches(str(path), batch_size=1, prefetch=1)
    next(it)
    it.close()  # stops the decode thread
    with pytest.raises(FileNotFoundError):
        list(stream_batches(str(tmp_path / "missing.y4m")))


def test_video_io_matches_jax(J, cv2, gray_mp4, tmp_path):
    from havc_tpu.io import video as jvideo

    from havc_tpu_torch.io import video as tvideo

    want = jvideo.read_video(gray_mp4, start=3, count=5)
    got = tvideo.read_video(gray_mp4, start=3, count=5)
    assert got.fps == want.fps
    assert np.array_equal(got.frames, np.asarray(want.frames))
    # on a device the /255 is u8_to_unit's float32 reciprocal multiply
    on_cpu = tvideo.read_video(gray_mp4, start=3, count=5, device="cpu")
    assert np.array_equal(ttransfer.unit_to_u8(on_cpu.frames).numpy(),
                          np.rint(got.frames * 255.0).astype(np.uint8))
    out = tmp_path / "rt.mp4"
    tvideo.write_video(on_cpu, str(out))
    assert tvideo.read_video(str(out)).frames.shape == (5, H, W, 3)
    assert tvideo.ref_frame_name(7, "png") == jvideo.ref_frame_name(7, "png") == "ref_000007.png"
    for name in ("ref_000012.jpg", "x/ref_000003.PNG", "ref_12.jpg", "other.png"):
        assert tvideo.parse_ref_num(name) == jvideo.parse_ref_num(name)
    clip = havc_tpu_torch.Clip(frames=got.frames).with_sc(
        havc_tpu_torch.SceneFlags.from_frame_list(5, [0, 3]))
    paths = tvideo.export_reference_frames(clip, str(tmp_path / "refs"), ext="png", ref_offset=10)
    assert [os.path.basename(p) for p in paths] == ["ref_000010.png", "ref_000013.png"]
    refs = tvideo.read_reference_dir(str(tmp_path / "refs"))
    assert sorted(refs) == [10, 13]
    assert np.abs(refs[13] - got.frames[3]).max() <= 0.5 / 255


def test_process_video_matches_jax(J, cv2, gray_mp4, monkeypatch):
    """``process_video``: uint8 batches in, the function on [0, 1] floats,
    clip/round/quantise, uint8 out; the tail batch padded.  Both packages
    hand the encoder the same frames."""
    from havc_tpu.io import stream as jstream_io

    from havc_tpu_torch.io import process_video

    written = []

    class _Writer:
        def __init__(self, *args):
            written.append([])

        def isOpened(self):
            return True

        def write(self, bgr):
            written[-1].append(bgr.copy())

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoWriter", _Writer)

    def fn(x):  # out of [0, 1] below x = 1/6, so the clip matters
        return 1.2 * (1.0 - x)

    kw = dict(batch_size=3, count=7)
    assert jstream_io.process_video(gray_mp4, "unused.mp4", fn, **kw) == 7
    assert process_video(gray_mp4, "unused.mp4", fn, device="cpu", **kw) == 7
    want, got = (np.stack(w) for w in written)
    assert want.shape == got.shape == (7, H, W, 3)
    assert np.array_equal(want, got)


# --- surface ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["HAVC_main_streaming", "HAVC_restore_video_streaming"])
def test_streaming_signatures_match_jax(J, name):
    """Same parameters, order and defaults as havc_tpu's, plus ``device``
    last."""
    want = list(inspect.signature(getattr(J.streaming, name)).parameters.values())
    got = list(inspect.signature(getattr(tstream, name)).parameters.values())
    assert [p.name for p in got] == [p.name for p in want] + ["device"]
    by_name = {p.name: p for p in got}
    for w in want:
        assert by_name[w.name].default == w.default, w.name
    assert by_name["device"].default is None
    assert havc_tpu_torch.HAVC_main_streaming is tstream.HAVC_main_streaming


def test_unported_streaming_options_raise(tmp_path, monkeypatch):
    """Every ``ex_model`` of the restore stream is ported: DeepEx (1),
    DeepRemaster (2) and the hybrid (3) stream a tiny ``.y4m`` (the
    registry's seeded engines at a 32x32 work size; their parity with the
    JAX package is tests/test_torch_streaming_deepex.py's); an unknown
    model is refused."""
    from havc_tpu_torch import exemplar as tex

    monkeypatch.setattr(tex, "smart_resize_shape", lambda width, height, speed="medium": (32, 32))
    src = tmp_path / "in.y4m"
    _write_y4m(src, _gray_frames(t=2, h=8, w=8))
    for ex in (1, 2, 3):
        assert tstream.HAVC_restore_video_streaming(
            str(src), str(src), "x.mp4", ex_model=ex, work_size=(32, 32), sink="null",
            engine_config="micro", device="cpu") == 2, ex
    with pytest.raises(ValueError, match="unsupported ex_model"):
        tstream.HAVC_restore_video_streaming(str(src), str(src), "x.mp4", ex_model=4,
                                             device="cpu")


def test_streaming_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    src = tmp_path / "in.y4m"
    _write_y4m(src, _gray_frames(t=2, h=8, w=8))
    for fn, args in ((tstream.HAVC_main_streaming, (str(src), "x.mp4")),
                     (tstream.HAVC_restore_video_streaming, (str(src), str(src), "x.mp4"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(*args)


def test_y4m_stream_imports_no_cv2(tmp_path):
    """A .y4m stream on the CPU loads neither OpenCV nor JAX nor havc_tpu
    (the card's machine has none of them)."""
    src = tmp_path / "in.y4m"
    _write_y4m(src, _gray_frames(t=6, h=16, w=16))
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_streaming import _seeded_engines, _torch_engines\n"
        "import havc_tpu_torch.streaming as s\n"
        "class MP:\n"
        "    def setitem(self, d, k, v): d[k] = v\n"
        "    def setattr(self, o, k, v): setattr(o, k, v)\n"
        "_torch_engines(MP(), {torch.device('cpu'): _seeded_engines()})\n"
        f"n = s.HAVC_main_streaming({str(src)!r}, 'x.mp4', batch_size=4, chunk_size=4,\n"
        "                           sink='null', device='cpu')\n"
        "assert n == 6, n\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('cv2', 'jax', 'jaxlib', 'flax', 'havc_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


# --- on the card ------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_streaming_on_card_matches_cpu(tmp_path, monkeypatch):
    """The test-sized streaming path on the card and on the CPU: the same
    retired bytes within 1 code value."""
    _need_cuda()
    gpu = torch.device("cuda", torch.cuda.current_device())
    cpu_models = _seeded_engines()
    _torch_engines(monkeypatch, {CPU: cpu_models,
                                 gpu: tuple(copy.deepcopy(m).to(gpu) for m in cpu_models)})
    src = tmp_path / "in.y4m"
    _write_y4m(src, _gray_frames(t=T))
    outs = {}
    for dev in ("cpu", None):
        rec = _record_retire(monkeypatch, tstream._WritePipeline, lambda p: p.wait())
        assert tstream.HAVC_main_streaming(str(src), "x.mp4", chunk_size=16, sink="null",
                                           device=dev) == T
        outs[dev] = (_joined(rec, "packed"), _joined(rec, "y"))
    _codes_close(outs["cpu"][0], outs[None][0], "card vs CPU chroma")
    assert np.array_equal(outs["cpu"][1], outs[None][1])


@pytest.mark.cuda
def test_pinned_upload_ring_matches_plain_copy():
    """The pinned staging ring hands the card the same bytes as a plain
    ``.to(device)``, also when batches outnumber its buffers and change
    shape."""
    _need_cuda()
    dev = torch.device("cuda", torch.cuda.current_device())
    up = tstream._Uploader(dev, slots=2)
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, 256, (4, 9, 13), dtype=np.uint8) for _ in range(5)]
    batches.append(rng.integers(0, 256, (3, 9, 13, 3), dtype=np.uint8))
    got = [up(b) for b in batches]
    for b, g in zip(batches, got):
        assert g.is_cuda and torch.equal(g.cpu(), torch.from_numpy(b).to(dev).cpu())
