"""Where the port's ColorMNet references come from, against the JAX
package's on the CPU: ``HAVC_read_video``, reference directories
(``sc_framedir``: methods 1-4 of ``HAVC_deepex``, ``HAVC_main`` methods 3
and 5, the ``only_ref_frames`` export), the all-refs encode modes 2/3
(the two host schedules over many seeded flag patterns, and
``colormnet_propagate`` driven by them), the CLAHE tile coordinates of
the BW tune, and the CUDA default of the new entry points.

The ColorMNet engine and the cut work size are
tests/test_torch_exemplar_surface.py's (``colormnet_both``).  Files are
written to ``tmp_path`` with OpenCV (lossless PNG references, an mp4v
video that both packages decode the same way).

Tolerances: 1e-4 on propagated frames; 1e-5 for the decoded and resized
video and for CLAHE (a handful of float32 operations); the schedules are
integers and equal.
"""
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import havc_tpu
from havc_tpu import exemplar as jex
from havc_tpu.clip import Clip as JClip
from havc_tpu.exemplar import allrefs as jallrefs
from havc_tpu.ops import equalize as jeq
from havc_tpu.utils import jitcache
from havc_tpu.utils.log import HAVCError as JHAVCError

import havc_tpu_torch
from havc_tpu_torch import exemplar as tex
from havc_tpu_torch.exemplar import allrefs as tallrefs
from havc_tpu_torch.io import write_image
from havc_tpu_torch.ops import equalize as teq

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)
from test_torch_exemplar_surface import (  # noqa: F401  (fixtures)
    WORK, T, _SeededEngine, check, colored_clip, colormnet_both, gray_clip, pair,
    seeded_colormnet)

TOL = 1e-4


# --- CLAHE tile coordinates ------------------------------------------------------------


@pytest.mark.parametrize("hw", [(1080, 40), (137, 243)], ids=["1080_rows", "137x243"])
def test_clahe_matches_jitted_jax(hw):
    """The BW tune runs CLAHE under ``jax.jit``, where XLA computes the tile
    coordinates ``(i + 0.5) / t - 0.5`` as one fma: at 1080 rows (tile
    height 135) row 67 sits just below the first tile's centre and takes
    the second tile's LUT.  Eager JAX divides exactly, so the jitted
    function is the reference."""
    x = np.random.default_rng(0).random((2,) + hw, dtype=np.float32)
    want = np.asarray(jax.jit(jeq.clahe_channel)(x))
    got = teq.clahe_channel(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    # the planes reach the rows and columns where the two rules part
    assert np.abs(got - np.asarray(jeq.clahe_channel(x))).max() > 1e-3


# --- HAVC_read_video ---------------------------------------------------------------------


def _write_mp4(path, frames, fps=25.0):
    h, w = frames.shape[1:3]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        out.write(cv2.cvtColor((f * 255).round().astype(np.uint8), cv2.COLOR_RGB2BGR))
    out.release()


@pytest.mark.parametrize("kw", [dict(width=40), dict(width=40, height=30),
                                dict(fpsnum=30000, fpsden=1001)],
                         ids=["width", "width_height", "fps"])
def test_read_video_matches_jax(tmp_path, kw):
    path = tmp_path / "clip.mp4"
    _write_mp4(path, colored_clip(t=6))
    want = havc_tpu.api.HAVC_read_video(str(path), **kw)
    got = havc_tpu_torch.HAVC_read_video(str(path), device="cpu", **kw)
    assert isinstance(got.frames, torch.Tensor) and got.frames.device.type == "cpu"
    assert got.frames.shape == np.shape(want.frames) and got.fps == want.fps
    assert np.abs(got.frames.numpy() - np.asarray(want.frames)).max() <= 1e-5


# --- reference directories ------------------------------------------------------------


def _ref_dir(path, frames, nums):
    os.makedirs(path, exist_ok=True)
    for n in nums:
        write_image(frames[n], os.path.join(path, f"ref_{n:06d}.png"))
    return str(path)


@pytest.mark.parametrize("method", [1, 2, 3, 4])
def test_framedir_methods_match_jax(colormnet_both, tmp_path, method):
    """Methods 1/2: the directory's images override and extend the HAVC
    references; 3/4: they are the only references (on the clip's own
    frames elsewhere); 2 and 4 insert them as exemplars."""
    refdir = _ref_dir(tmp_path / "refs", colored_clip(seed=9), [2, 6])
    clip_j, clip_t = pair(gray_clip())
    ref_j = ref_t = None
    if method in (1, 2):
        ref_j, ref_t = pair(colored_clip(), lambda cls: cls.from_frame_list(T, [0, 4, 8], False))
    kw = dict(method=method, sc_framedir=refdir, dark=True)
    want = jex.HAVC_deepex(clip_j, ref_j, **kw)
    got = havc_tpu_torch.HAVC_deepex(clip_t, ref_t, device="cpu", **kw)
    check(want, got)
    assert np.array_equal(want.sc.sc_next, got.sc.sc_next)


def test_only_ref_frames_export_matches_jax(colormnet_both, tmp_path):
    frames = colored_clip()
    ref_j, ref_t = pair(frames, lambda cls: cls.from_frame_list(T, [0, 4, 8], False))
    clip_j, clip_t = pair(gray_clip())
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    jex.HAVC_deepex(clip_j, ref_j, sc_framedir=dirs["jax"], only_ref_frames=True)
    got = havc_tpu_torch.HAVC_deepex(clip_t, ref_t, sc_framedir=dirs["port"],
                                     only_ref_frames=True, device="cpu")
    assert np.array_equal(got.frames, frames)
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"])) == [f"ref_{n:06d}.jpg" for n in (0, 4, 8)]
    for name in names:
        a, b = (cv2.imread(os.path.join(dirs[k], name)) for k in ("jax", "port"))
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("kw", [dict(DeepExMethod=3), dict(DeepExMethod=5, RefRange=(1, 13))],
                         ids=["method3_directory", "method5_video"])
def test_havc_main_external_references_match_jax(colormnet_both, tmp_path, kw):
    """``HAVC_main`` with DeepEx from a reference directory (method 3) or a
    colored video cut to ``RefRange`` (method 5), then the fast
    stabilizer."""
    colored = colored_clip(t=14)
    if kw["DeepExMethod"] == 3:
        src = _ref_dir(tmp_path / "refs", colored, [0, 5, 9])
    else:
        src = str(tmp_path / "ref.mp4")
        _write_mp4(src, colored)
    frames = gray_clip()
    kw = dict(kw, EnableDeepEx=True, ScFrameDir=src, batch_size=4)
    want = havc_tpu.HAVC_main(JClip(frames=frames.copy()), **kw)
    got = havc_tpu_torch.HAVC_main(havc_tpu_torch.Clip(frames=frames.copy()), device="cpu", **kw)
    check(want, got)


# --- the all-refs encode modes --------------------------------------------------------


def _flag_patterns(seed):
    """Scene-change masks of many lengths and densities (frame 0 always a
    reference, as the detectors make it), long ones across the reference
    list's 500-frame buffers, and a few with too few references."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (1, 3, 9, 40, 130, 620, 1270):
        for density in (0.02, 0.1, 0.4, 0.9):
            sc = rng.random(n) < density
            sc[0] = True
            out.append(sc)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_allrefs_schedules_match_jax(seed):
    for sc in _flag_patterns(seed):
        kw = dict(ref_list_size=int(np.random.default_rng(seed + len(sc)).integers(1, 300)))
        try:
            want = jallrefs.allrefs_feed_schedule(sc, **kw)
        except JHAVCError as e:
            with pytest.raises(tallrefs.HAVCError, match="at least 2"):
                tallrefs.allrefs_feed_schedule(sc, **kw)
            assert "at least 2" in str(e)
            continue
        got = tallrefs.allrefs_feed_schedule(sc, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        for reset_on, mmf in ((True, 0), (False, 0), (True, 7), (False, 3)):
            w_eff, w_reset = jallrefs.allrefs_step_schedule(want, len(sc), reset_on, mmf)
            g_eff, g_reset = tallrefs.allrefs_step_schedule(got, len(sc), reset_on, mmf)
            assert np.array_equal(g_eff, w_eff) and np.array_equal(g_reset, w_reset)


@pytest.mark.parametrize("reset_on_ref_update,max_memory_frames",
                         [(True, 0), (False, 0), (False, 5)],
                         ids=["vivid", "plain", "max_memory_frames"])
def test_colormnet_propagate_schedules_match_jax(seeded_colormnet, reset_on_ref_update,
                                                 max_memory_frames):
    """Refs fed in the look-ahead order as exemplar inserts, the core rebuilt
    on the reset schedule (the vivid resets, or every 5 frames by the
    memory cap).  The engine geometry is the other tests' (112x112), so the
    JAX package compiles its scan once for the module."""
    rng = np.random.default_rng(2)
    frames = rng.random((T,) + WORK + (3,), dtype=np.float32)
    refs = rng.random((T,) + WORK + (3,), dtype=np.float32)
    ref_ab = rng.random((T,) + WORK + (2,), dtype=np.float32) * 2 - 1
    is_ref = np.zeros(T, bool)
    is_ref[[0, 3, 6, 9]] = True
    feed = tallrefs.allrefs_feed_schedule(is_ref)
    eff, reset = tallrefs.allrefs_step_schedule(feed, T, reset_on_ref_update, max_memory_frames)
    assert reset.any() == (reset_on_ref_update or max_memory_frames > 0)
    tree, net = seeded_colormnet
    je = _SeededEngine(tree, work_size=(112, 112))
    te = tex.ColorMNetEngine(config="micro", work_size=(112, 112), device="cpu")
    te.net = net
    kw = dict(ref_frames=refs, feed_schedule=eff, reset_schedule=reset)
    want = jex.colormnet_propagate(je, frames, ref_ab, is_ref, **kw)
    got = tex.colormnet_propagate(te, frames, ref_ab, is_ref, **kw).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("encode_mode,max_memory_frames", [(2, 0), (3, 8)])
def test_deepex_encode_modes_match_jax(colormnet_both, monkeypatch, encode_mode,
                                       max_memory_frames):
    if max_memory_frames:
        # the JAX package keys its compiled scan by geometry, not by the
        # long-term capacity that max_memory_frames sets: compile afresh
        monkeypatch.setattr(jitcache, "_CACHE", {})
    clip_j, clip_t = pair(gray_clip())
    ref_j, ref_t = pair(colored_clip(), lambda cls: cls.from_frame_list(T, [0, 3, 6, 9], False))
    kw = dict(encode_mode=encode_mode, max_memory_frames=max_memory_frames)
    want = jex.HAVC_deepex(clip_j, ref_j, **kw)
    got = havc_tpu_torch.HAVC_deepex(clip_t, ref_t, device="cpu", **kw)
    check(want, got)


# --- the CUDA default -----------------------------------------------------------------


def test_new_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    frames = gray_clip()
    clip = havc_tpu_torch.Clip(frames=frames)
    ref = havc_tpu_torch.Clip(frames=colored_clip())
    path = tmp_path / "clip.mp4"
    _write_mp4(path, frames[:2])
    for call in (lambda: havc_tpu_torch.HAVC_restore_video(clip, ref),
                 lambda: havc_tpu_torch.HAVC_colorizer_fast(clip),
                 lambda: havc_tpu_torch.HAVC_ColorAdjust(ref),
                 lambda: havc_tpu_torch.HAVC_main_restore(clip, ref),
                 lambda: havc_tpu_torch.HAVC_read_video(str(path)),
                 lambda: havc_tpu_torch.HAVC_DeepRemaster(clip, clip_ref=ref),
                 lambda: havc_tpu_torch.HAVC_deepex(clip, ref.with_sc(
                     havc_tpu_torch.SceneFlags.every(len(frames), 4)), ex_model=1),
                 lambda: havc_tpu_torch.HAVC_restore_video(clip, ref, ex_model=2),
                 lambda: tex.DeepExEngine(),
                 lambda: tex.RemasterEngine()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
