"""The port's scene detectors against the JAX package's on the CPU: the
luma detector's leftovers (the debug records and log, the resumable
passes, ``StreamSceneDetector`` fed in chunks of 1, 3 and 7), the edge
detector, the motion and Xvid detectors, the front ends
(``HAVC_SceneDetect``, ``HAVC_SceneDetectEdges``,
``HAVC_SceneDetectMotion``, ``HAVC_extract_reference_frames`` with
``sc_algo`` 0-3) and the device rule of the detectors.

The clips are seeded: 12 frames of 64x96 in three scenes (cuts at 0, 4
and 8), each a smooth random field drifting by a fraction of a pixel a
frame, with noise.  Every detector decides by strict comparisons of float
statistics with thresholds, so the statistics are held first (1e-4:
luma means, differences, edge statistics, block SADs and deviations),
then the flags exactly; a flag that differs is reported with the
statistic's distance from its threshold.  Ratios of voting blocks are held
within 2 blocks.
"""
import logging

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import havc_tpu
from havc_tpu.clip import Clip as JClip
from havc_tpu.scene import detect as jdetect
from havc_tpu.scene import edges as jedges
from havc_tpu.scene import motion as jmotion

import havc_tpu_torch
from havc_tpu_torch.scene import detect as tdetect
from havc_tpu_torch.scene import edges as tedges
from havc_tpu_torch.scene import motion as tmotion

import _torch_threads  # noqa: F401  (sets torch's thread count for this process)

STAT_TOL = 1e-4
OP_TOL = 1e-5
CUTS = (0, 4, 8)


def scene_clip(t=12, cuts=CUTS, h=64, w=96, seed=0):
    """``t`` RGB frames, a new smooth seeded field at each cut (mean luma
    0.3, 0.42, 0.54, ... by scene), drifting by (0.05, 0.075) coarse cells a
    frame, plus noise of sigma 0.01."""
    rng = np.random.default_rng(seed)
    frames = np.empty((t, h, w, 3), np.float32)
    bounds = list(cuts) + [t]
    for s in range(len(cuts)):
        base = rng.random((h // 8 + 3, w // 8 + 3, 3)).astype(np.float32)
        yy = np.linspace(0, base.shape[0] - 3, h)
        xx = np.linspace(0, base.shape[1] - 3, w)
        for i, n in enumerate(range(bounds[s], bounds[s + 1])):
            yi = np.clip(yy + i * 0.05, 0, base.shape[0] - 1.001)
            xi = np.clip(xx + i * 0.075, 0, base.shape[1] - 1.001)
            y0, x0 = yi.astype(int), xi.astype(int)
            fy, fx = (yi - y0)[:, None, None], (xi - x0)[None, :, None]
            f = (base[y0][:, x0] * (1 - fy) * (1 - fx) + base[y0 + 1][:, x0] * fy * (1 - fx)
                 + base[y0][:, x0 + 1] * (1 - fy) * fx + base[y0 + 1][:, x0 + 1] * fy * fx)
            frames[n] = np.clip(0.1 + 0.12 * s + 0.4 * f + rng.normal(0, 0.01, f.shape), 0, 1)
    return frames


@pytest.fixture(scope="module")
def clip():
    return scene_clip()


def same_flags(want, got, stat, thresholds):
    """Equal flags, or a message with each differing frame's statistic and
    its distance from its threshold."""
    want, got = np.asarray(want), np.asarray(got)
    bad = np.nonzero(want != got)[0]
    assert not len(bad), [(int(n), float(stat[n]), [float(stat[n] - t) for t in thresholds])
                          for n in bad]


def close(want, got, tol=STAT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


# --- the luma detector ------------------------------------------------------------------

DETECT_KW = {
    "defaults": dict(),
    "filter": dict(sc_tht_filter=0.5, min_length=4),
    "filter_ssim1": dict(sc_tht_filter=1.0, min_length=3),
    "custom_offset2": dict(threshold=0.05, tht_offset=2),
    "custom_freq5": dict(threshold=0.08, frequency=5, sc_tht_filter=0.6, min_length=2),
    "normalize": dict(normalize=True, sc_tht_filter=0.4),
    "off": dict(threshold=0.0, frequency=0),
    "every_3": dict(threshold=0.0, frequency=3),
}


@pytest.mark.parametrize("kw", DETECT_KW.values(), ids=DETECT_KW.keys())
def test_scene_detect_and_debug_records(clip, kw):
    """Flags, lumas and ratios of ``SceneDetector.detect`` with
    ``debug=True``, and its per-decision records (SSIM and histogram
    scores rounded to 4 places: held at 1e-4)."""
    jd = jdetect.SceneDetector(debug=True, **kw)
    td = tdetect.SceneDetector(debug=True, device="cpu", **kw)
    want, got = jd.detect(clip), td.detect(clip)
    close(want.luma, got.luma)
    close(want.ratio, got.ratio)
    _, _, diffs, _ = jdetect.frame_stats(clip, min(max(kw.get("tht_offset", 1), 1), 25))
    same_flags(want.sc_prev, got.sc_prev, diffs, [kw.get("threshold", 0.1)])
    assert len(jd.debug_records) == len(td.debug_records)
    for a, b in zip(jd.debug_records, td.debug_records):
        assert {k: a[k] for k in ("state", "frame", "prev", "reason")} == \
            {k: b[k] for k in ("state", "frame", "prev", "reason")}
        for k in ("ssim", "hist", "luma"):
            assert abs(a[k] - b[k]) <= STAT_TOL, (k, a, b)


def test_frame_stats(clip):
    """The device phase: gray maps, lumas, differences and histograms at 1e-5
    (the histograms count the same bins)."""
    for offset, normalize in ((1, False), (3, True)):
        want = jdetect.frame_stats(clip, offset, normalize=normalize)
        got = tdetect.frame_stats(torch.from_numpy(clip), offset, normalize=normalize)
        for w, g in zip(want, got):
            close(w, g, OP_TOL)
        _, lumas, diffs, maps = tdetect.frame_stats(clip, offset, normalize, need_maps=False,
                                                device="cpu")
        assert maps is None
        close(want[1], lumas, OP_TOL)
        close(want[2], diffs, OP_TOL)


STREAM_KW = {k: DETECT_KW[k] for k in ("defaults", "filter", "custom_freq5", "every_3")}


@pytest.mark.parametrize("chunk", [1, 3, 7])
@pytest.mark.parametrize("kw", STREAM_KW.values(), ids=STREAM_KW.keys())
def test_stream_detector_matches_whole_clip(clip, kw, chunk):
    """``StreamSceneDetector`` fed in chunks gives the whole-clip flags of
    both packages' ``SceneDetector.detect``, and the JAX package's stream
    gives the same."""
    want = jdetect.SceneDetector(**kw).detect(clip).sc_prev
    whole = tdetect.SceneDetector(device="cpu", **kw).detect(clip).sc_prev
    stream = tdetect.StreamSceneDetector(device="cpu", **kw)
    jstream = jdetect.StreamSceneDetector(**kw)
    got = np.concatenate([stream.feed(clip[s:s + chunk]) for s in range(0, len(clip), chunk)])
    jgot = np.concatenate([jstream.feed(clip[s:s + chunk]) for s in range(0, len(clip), chunk)])
    np.testing.assert_array_equal(whole, want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jgot, want)


def test_stream_detector_keeps_its_tail_on_the_tensor_device(clip):
    """The lag window stays a tensor on the frames' device between chunks,
    ``tht_offset`` frames deep."""
    stream = tdetect.StreamSceneDetector(tht_offset=3, threshold=0.05)
    stream.feed(torch.from_numpy(clip[:2]))
    assert isinstance(stream._tail, torch.Tensor) and stream._tail.shape[0] == 2
    stream.feed(torch.from_numpy(clip[2:7]))
    assert stream._tail.shape[0] == 3 and stream._tail.device.type == "cpu"


@pytest.mark.parametrize("front", ["scene_detect", "HAVC_SceneDetect"])
def test_debug_log_text(clip, front, caplog):
    """The debug log of both packages, line by line, with the same spacing
    (the arguments joined by one space)."""
    kw = dict(sc_tht_filter=0.5, min_length=4)
    caplog.set_level(logging.WARNING)
    if front == "scene_detect":
        jdetect.scene_detect(clip, debug=True, **kw)
        tdetect.scene_detect(clip, debug=True, device="cpu", **kw)
    else:
        hkw = dict(sc_tht_ssim=0.5, sc_min_int=4, sc_debug=True)
        havc_tpu.api.HAVC_SceneDetect(JClip(frames=clip.copy()), **hkw)
        havc_tpu_torch.HAVC_SceneDetect(havc_tpu_torch.Clip(frames=clip.copy()), device="cpu",
                                        **hkw)
    want = [r.getMessage() for r in caplog.records if r.name == "havc_tpu"]
    got = [r.getMessage() for r in caplog.records if r.name == "havc_tpu_torch"]
    assert want and len(want) == len(got)
    assert want[0].startswith("SC=[New], Frame_n=  0 , PrvFrame=  -1 ,"), want[0]
    for a, b in zip(want, got):
        fa, fb = a.split(), b.split()
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            if x != y:  # a score rounded to 4 places may differ in its last digit
                assert abs(float(x) - float(y)) <= STAT_TOL, (a, b)


# --- the edge detector ------------------------------------------------------------------


def test_edge_ops(clip):
    """Kirsch mask, Sobel magnitude and the draft edge mask on the gray
    maps, against the JAX package's (the Kirsch mask is a threshold: its
    mean is held at 1e-4)."""
    gray = jnp.asarray(clip[..., 0])
    tg = torch.from_numpy(clip[..., 0].copy())
    close(jedges.kirsch_edges(gray).mean(), float(tedges.kirsch_edges(tg).mean()))
    close(jedges.sobel_magnitude(gray), tedges.sobel_magnitude(tg), OP_TOL)
    close(jedges.retinex_edgemask_draft(gray), tedges.retinex_edgemask_draft(tg), OP_TOL)


def test_edge_stats(clip):
    want = jedges.edge_stats(clip, 2)
    got = tedges.edge_stats(clip, 2, device="cpu")
    for name, w, g in zip(("gray", "mask", "edge_diff", "ssim_diff", "lumas"), want, got):
        close(w, g, STAT_TOL if name in ("edge_diff", "ssim_diff") else OP_TOL)
    close(want[1].mean(), got[1].mean())


EDGE_KW = {
    "defaults": dict(),
    "front_end": dict(threshold=0.035, sc_diff_offset=2, sc_tht_ssim=0.8, sc_min_int=20,
                      sc_mult_tht=15, tht_black=0.10),
    "close_cuts": dict(threshold=0.035, sc_mult_tht=6, sc_min_int=3, sc_tht_ssim=0.8),
    "low_tht_freq": dict(threshold=0.02, sc_min_int=2, sc_mult_tht=0, frequency=5,
                         min_length=2),
}


@pytest.mark.parametrize("kw", EDGE_KW.values(), ids=EDGE_KW.keys())
def test_scene_detect_edges(clip, kw):
    want = jedges.scene_detect_edges(clip, **kw)
    got = tedges.scene_detect_edges(torch.from_numpy(clip), **kw)
    close(want.luma, got.luma)
    close(want.ratio, got.ratio)
    thr = kw.get("threshold", 0.07)
    same_flags(want.sc_prev, got.sc_prev, want.ratio,
               [thr, thr * (kw.get("sc_mult_tht", 7) or 7)])


# --- the motion detectors ---------------------------------------------------------------


def test_motion_stats(clip):
    """Best block SADs, intra deviations and lumas at 1e-5."""
    want_best, want_luma = jmotion.motion_stats(clip)
    got_best, got_luma = tmotion.motion_stats(clip, device="cpu")
    close(want_best, got_best, OP_TOL)
    close(want_luma, got_luma, OP_TOL)
    gray = jnp.asarray(clip[..., 1])
    close(jmotion._intra_deviation(gray), tmotion._intra_deviation(torch.from_numpy(
        clip[..., 1].copy())), OP_TOL)


MOTION_KW = {"defaults": dict(), "tight": dict(bad_sad=0.03, bad_ratio=0.3, min_length=2),
             "search2": dict(search=2, bad_ratio=0.4)}
XVID_KW = {"defaults": dict(), "low_ratio": dict(kf_ratio=0.2, min_length=3),
           "bias0": dict(intra_bias=0.0, search=2)}


@pytest.mark.parametrize("kw", MOTION_KW.values(), ids=MOTION_KW.keys())
def test_scene_detect_motion(clip, kw):
    want = jmotion.scene_detect_motion(clip, **kw)
    got = tmotion.scene_detect_motion(clip, device="cpu", **kw)
    blocks = (64 // 16) * (96 // 16)
    close(want.ratio, got.ratio, 2.0 / blocks)
    close(want.luma, got.luma)
    same_flags(want.sc_prev, got.sc_prev, want.ratio, [kw.get("bad_ratio", 0.55)])


@pytest.mark.parametrize("kw", XVID_KW.values(), ids=XVID_KW.keys())
def test_scene_detect_xvid(clip, kw):
    want = jmotion.scene_detect_xvid(clip, **kw)
    got = tmotion.scene_detect_xvid(torch.from_numpy(clip), **kw)
    blocks = (64 // 16) * (96 // 16)
    close(want.ratio, got.ratio, 2.0 / blocks)
    close(want.luma, got.luma)
    same_flags(want.sc_prev, got.sc_prev, want.ratio, [kw.get("kf_ratio", 0.5)])


def test_detectors_find_the_cuts(clip):
    """The clip has real cuts: each detector with its defaults (the edge
    detector with close-cut settings) finds scene changes past frame 0, so
    a flag that flips between the packages shows."""
    assert list(np.nonzero(tdetect.scene_detect(clip, device="cpu").sc_prev)[0]) == list(CUTS)
    for flags in (tedges.scene_detect_edges(clip, device="cpu", **EDGE_KW["close_cuts"]),
                  tmotion.scene_detect_motion(clip, device="cpu"),
                  tmotion.scene_detect_xvid(clip, device="cpu")):
        assert flags.sc_prev[0] == 1 and flags.sc_prev[1:].sum() >= 1


# --- the front ends ---------------------------------------------------------------------

FRONT_KW = {
    "HAVC_SceneDetect": [dict(), dict(sc_tht_ssim=0.5, sc_min_int=4),
                         dict(sc_threshold=0.05, sc_tht_offset=2, sc_normalize=True)],
    "HAVC_SceneDetectEdges": [dict(), dict(sc_mult_tht=6, sc_min_int=3)],
    "HAVC_SceneDetectMotion": [dict(), dict(bad_sad=0.03, bad_ratio=0.3)],
}


@pytest.mark.parametrize("name,kw", [(n, k) for n, ks in FRONT_KW.items() for k in ks])
def test_front_ends(clip, name, kw):
    """The front ends attach the flags and keep the frames as they were."""
    want = getattr(havc_tpu.api, name)(JClip(frames=clip.copy()), **kw)
    got = getattr(havc_tpu_torch, name)(havc_tpu_torch.Clip(frames=clip.copy()),
                                        device="cpu", **kw)
    assert isinstance(got.frames, np.ndarray) and np.array_equal(got.frames, clip)
    close(want.sc.luma, got.sc.luma)
    close(want.sc.ratio, got.sc.ratio)
    same_flags(want.sc.sc_prev, got.sc.sc_prev, want.sc.ratio, [])


@pytest.mark.parametrize("sc_algo", [0, 1, 2, 3])
def test_extract_reference_frames(clip, sc_algo, tmp_path):
    """``sc_algo`` 0-3 write the same reference files (names and pixels)."""
    kw = dict(sc_algo=sc_algo, ref_ext="png", ref_offset=2, sc_tht_ssim=0.3,
              sc_min_freq=6 if sc_algo == 1 else 0, sc_min_int=2 if sc_algo == 1 else 1)
    want = havc_tpu.api.HAVC_extract_reference_frames(
        JClip(frames=clip.copy()), sc_framedir=str(tmp_path / "jax"), **kw)
    got = havc_tpu_torch.HAVC_extract_reference_frames(
        havc_tpu_torch.Clip(frames=clip.copy()), sc_framedir=str(tmp_path / "port"),
        device="cpu", **kw)
    assert [p.split("/")[-1] for p in want] == [p.split("/")[-1] for p in got] and got
    for a, b in zip(want, got):
        assert np.array_equal(cv2.imread(a), cv2.imread(b))


# --- the device rule --------------------------------------------------------------------


def test_numpy_frames_default_to_cuda(clip):
    """Numpy frames without ``device`` go to CUDA: here, with no CUDA
    device, every detector raises the port's error; a CPU tensor is
    reduced where it lies."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    calls = [
        lambda x: tdetect.scene_detect(x),
        lambda x: tdetect.frame_stats(x),
        lambda x: tdetect.StreamSceneDetector().feed(x),
        lambda x: tedges.scene_detect_edges(x),
        lambda x: tedges.edge_stats(x),
        lambda x: tmotion.scene_detect_motion(x),
        lambda x: tmotion.scene_detect_xvid(x),
        lambda x: tmotion.motion_stats(x),
        lambda x: havc_tpu_torch.HAVC_SceneDetect(havc_tpu_torch.Clip(frames=x)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(clip)
    want = tdetect.scene_detect(clip, device="cpu").sc_prev
    np.testing.assert_array_equal(tdetect.scene_detect(torch.from_numpy(clip)).sc_prev, want)
