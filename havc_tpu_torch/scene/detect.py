"""Scene-change detection.

Port of ``havc_tpu.scene.detect``: a device phase (:func:`frame_stats`:
downscaled gray maps, mean luma, mean abs difference to the
``offset``-th previous frame, 256-bin histograms) and the host state
machine (:class:`SceneDetector`: adaptive ratio, luma gates, frequency
forcing, minimum scene length, optional SSIM + histogram confirmation),
which reads only per-frame numbers.  :class:`StreamSceneDetector` runs
the same machine chunk by chunk, carrying its state and the lag window of
gray maps (on the device) across chunks.

A tensor is reduced on the device it lies on; numpy frames go to
``device`` (``None``: CUDA; ``utils.on_device``).

The histograms count each frame's bins with ``scatter_add_`` instead of
the JAX package's one-hot sum, which at 1080p (288x512 work maps) would
hold 256 floats per pixel; both give the same L2-normalised counts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..clip import SceneFlags
from ..ops.colorspace import luma
from ..ops.resize import resize
from ..utils.profiling import host_read, on_device

__all__ = ["SceneFlags", "SceneDetector", "StreamSceneDetector", "scene_detect",
           "frame_stats"]

# Reference constants (vsslib/constants.py).
DEF_THRESHOLD = 0.10
DEF_THT_WHITE = 0.70
DEF_THT_BLACK = 0.10
DEF_THT_BLACK_MIN = 0.19
DEF_THT_WHITE_MIN = 0.70
DEF_THT_BLACK_FREQ = 0.14
DEF_ADAPTIVE_RATIO_LO = 1.02
DEF_ADAPTIVE_RATIO_MED = 1.12
DEF_ADAPTIVE_RATIO_RF = 2.0
DEF_ADAPTIVE_RATIO_VHI = 15.0
DEF_SSIM_SCORE_EQUAL = 0.69
DEF_HIST_SCORE_EQUAL = 0.70
DEF_HIST_SCORE_HIGH = 0.95
DEF_SC_MIN_DISTANCE = 15
DEF_MAX_RESIZE_W = 512
DEF_MAX_RESIZE_H = 480


def _work_size(h: int, w: int) -> tuple:
    """Downscale target <= (480, 512) with even dims."""
    scale = min(DEF_MAX_RESIZE_H / h, DEF_MAX_RESIZE_W / w, 1.0)
    nh, nw = int(h * scale) & ~1, int(w * scale) & ~1
    return max(nh, 2), max(nw, 2)


def _stats(gray_small: torch.Tensor, offset: int, need_hists: bool):
    """Luma means, mean abs difference to the offset-lagged frame, and
    (when asked for) L2-normalised 256-bin histograms."""
    T = gray_small.shape[0]
    lumas = gray_small.mean(dim=(-2, -1))
    idx = torch.clamp(torch.arange(T, device=gray_small.device) - offset, 0, T - 1)
    diffs = (gray_small - gray_small[idx]).abs().mean(dim=(-2, -1))
    if not need_hists:
        return lumas, diffs, None
    bins = torch.clamp((gray_small * 255.0).to(torch.int32), 0, 255).reshape(T, -1)
    hists = torch.zeros((T, 256), dtype=torch.float32, device=gray_small.device)
    hists.scatter_add_(1, bins.long(), torch.ones_like(bins, dtype=torch.float32))
    hists = hists / torch.clamp(torch.linalg.vector_norm(hists, dim=-1, keepdim=True), min=1e-6)
    return lumas, diffs, hists


def _normalize_luma(gray: torch.Tensor, tht_black: float = 0.19,
                    tht_white: float = 0.70) -> torch.Tensor:
    """Per-frame min-max luma stretch, gated to mid-luma frames."""
    mean = gray.mean(dim=(-2, -1), keepdim=True)
    lo = gray.amin(dim=(-2, -1), keepdim=True)
    hi = gray.amax(dim=(-2, -1), keepdim=True)
    stretched = (gray - lo) / torch.clamp(hi - lo, min=1e-6)
    return torch.where((mean > tht_black) & (mean < tht_white), stretched, gray)


def _gray_maps(frames: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """RGB frames -> downscaled (optionally normalised) gray maps."""
    gray = luma(frames)
    nh, nw = _work_size(gray.shape[-2], gray.shape[-1])
    gray_small = resize(gray[..., None], nh, nw, "bicubic")[..., 0]
    return _normalize_luma(gray_small) if normalize else gray_small


def frame_stats(frames, offset: int = 1, normalize: bool = False, need_maps: bool = True,
                device=None):
    """Device phase over (T, H, W, 3) RGB frames: returns numpy
    (gray_small[T,h,w], luma[T], diff[T], hist[T,256]); with
    ``need_maps=False`` the maps and histograms are ``None``."""
    with torch.inference_mode():
        gray_small = _gray_maps(on_device(frames, device), normalize)
        lumas, diffs, hists = _stats(gray_small, offset, need_maps)
        lumas, diffs = host_read(torch.stack([lumas, diffs]))
        if not need_maps:
            return None, lumas, diffs, None
        return host_read(gray_small), lumas, diffs, host_read(hists)


def _ssim_uniform(a: np.ndarray, b: np.ndarray, win: int = 7) -> float:
    """Mean SSIM with a uniform window (skimage structural_similarity
    defaults: win_size=7, uniform weights, K1=.01 K2=.03, data_range=1)."""
    from scipy.ndimage import uniform_filter

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    K1, K2, L = 0.01, 0.03, 1.0
    C1, C2 = (K1 * L) ** 2, (K2 * L) ** 2
    mu_a = uniform_filter(a, win)
    mu_b = uniform_filter(b, win)
    mu_aa = uniform_filter(a * a, win)
    mu_bb = uniform_filter(b * b, win)
    mu_ab = uniform_filter(a * b, win)
    n = win**2
    cov_norm = n / (n - 1)
    va = cov_norm * (mu_aa - mu_a * mu_a)
    vb = cov_norm * (mu_bb - mu_b * mu_b)
    vab = cov_norm * (mu_ab - mu_a * mu_b)
    ssim_map = ((2 * mu_a * mu_b + C1) * (2 * vab + C2)) / (
        (mu_a**2 + mu_b**2 + C1) * (va + vb + C2)
    )
    pad = (win - 1) // 2
    return float(ssim_map[pad:-pad, pad:-pad].mean())


def _hellinger(h1: np.ndarray, h2: np.ndarray) -> float:
    """cv2.HISTCMP_HELLINGER on L2-normalized histograms."""
    h1 = h1.astype(np.float64)
    h2 = h2.astype(np.float64)
    m1, m2 = h1.mean(), h2.mean()
    n = len(h1)
    denom = np.sqrt(m1 * m2) * n
    if denom <= 0:
        return 1.0
    bc = np.sum(np.sqrt(np.maximum(h1 * h2, 0.0))) / denom
    return float(np.sqrt(max(1.0 - bc, 0.0)))


@dataclass
class SceneDetector:
    """Host state machine mirroring vsscdect.SceneDetection."""

    threshold: float = DEF_THRESHOLD
    frequency: int = 0
    sc_tht_filter: float = 0.0
    min_length: int = 1
    tht_white: float = DEF_THT_WHITE
    tht_black: float = DEF_THT_BLACK
    tht_offset: int = 1
    normalize: bool = False
    adaptive_ratio: float = field(default=0.0)
    debug: bool = False
    device: Optional[object] = None

    def __post_init__(self):
        if self.adaptive_ratio == 0.0:
            self.adaptive_ratio = (
                DEF_ADAPTIVE_RATIO_MED if self.frequency > 0 else DEF_ADAPTIVE_RATIO_LO
            )
        # per-frame decisions of the confirmation pass, for the debug log
        self.debug_records: list = []

    def _record(self, state, n, prev, ssim, hist, luma, reason):
        if self.debug:
            self.debug_records.append({
                "state": state, "frame": int(n),
                "prev": -1 if prev is None else int(prev),
                "ssim": ssim, "hist": hist,
                "luma": round(float(luma), 4), "reason": int(reason),
            })

    # -- first pass: adaptive-ratio custom detector (vsscdect.py:281-342) --
    def _custom_pass(self, lumas, diffs, min_length, n0: int = 0,
                     state: Optional[tuple] = None) -> tuple:
        """``lumas``/``diffs`` of the frames from global index ``n0`` on;
        ``state`` is the ``(prev_diff, last_ref, ref_luma)`` carry at
        ``n0`` (global indices), so a stream resumes where it stopped.
        Returns ``(sc, ratios, state)``."""
        T = len(lumas)
        sc = np.zeros(T, dtype=np.int8)
        ratios = np.zeros(T, dtype=np.float32)
        prev_diff, last_ref, ref_luma = state or (0.0, None, 0.0)
        for i in range(T):
            n = n0 + i
            f_luma = round(float(lumas[i]), 4)
            f_bright = DEF_THT_BLACK_MIN <= f_luma <= DEF_THT_WHITE_MIN
            n_diff = round(max(float(diffs[i]), 0.0001), 5)
            if n == 0 or last_ref is None:
                is_sc = True
                prev_diff = n_diff
                ref_luma = f_luma
                last_ref = n
                ratio = 0.0
            elif n - last_ref < min_length:
                ratio = round(n_diff / prev_diff, 4)
                is_sc = False
            else:
                ratio = round(n_diff / prev_diff, 4)
                is_sc = ratio > self.adaptive_ratio and n_diff > self.threshold
                prev_diff = n_diff
                if self.frequency > 1:
                    is_sc = is_sc or (n % self.frequency == 0)
                is_sc = is_sc or (ratio > DEF_ADAPTIVE_RATIO_RF and f_bright)
                is_sc = is_sc or ratio > DEF_ADAPTIVE_RATIO_VHI
                is_sc = is_sc or (ref_luma < DEF_THT_BLACK_MIN and f_bright)
                is_sc = is_sc and self.tht_black < f_luma < self.tht_white
            ratios[i] = ratio
            if is_sc:
                last_ref = n
                ref_luma = f_luma
                sc[i] = 1
        return sc, ratios, (prev_diff, last_ref, ref_luma)

    # -- first pass: plain threshold detector + black/white filter
    #    (misc.SCDetect analog + vsscdect.filter_black_white) --
    def _simple_pass(self, lumas, diffs, n0: int = 0) -> tuple:
        """Stateless given the global index ``n0`` of the first frame."""
        T = len(lumas)
        sc = np.zeros(T, dtype=np.int8)
        ratios = np.zeros(T, dtype=np.float32)
        for i in range(T):
            n = n0 + i
            f_luma = round(float(lumas[i]), 4)
            is_sc = n == 0 or float(diffs[i]) > self.threshold
            if self.frequency > 1:
                is_sc = is_sc or (n % self.frequency == 0)
            if n == 0:
                sc[i] = 1
            elif is_sc and self.tht_black < f_luma < self.tht_white:
                sc[i] = 1
        return sc, ratios

    # -- second pass: SSIM + histogram confirmation (vsscdect.py:352-495) --
    def _filter_pass(self, sc, lumas, ratios, grays, hists, min_length,
                     n0: int = 0, state: Optional[tuple] = None):
        """Confirms each candidate against the last ACCEPTED reference;
        ``state`` is its ``(last_index, gray map, histogram, luma)`` at
        global index ``n0``.  Returns ``(out, state)``."""
        T = len(sc)
        out = np.zeros(T, dtype=np.int8)
        last_index, prev_y, prev_hist, prev_luma = state or (None, None, None, 0.0)
        tht_ssim = self.sc_tht_filter
        for i in range(T):
            n = n0 + i
            luma_n = float(lumas[i])
            is_sc = sc[i] == 1 or n == 0
            if is_sc and last_index is None:
                out[i] = 1
                self._record("New", n, last_index, -1, -1, luma_n, 1)
                last_index = n
                prev_y = grays[i]
                prev_hist = hists[i]
                prev_luma = luma_n
                continue
            if not is_sc:
                continue
            sc_reason = 0
            if n > 0 and (n - last_index) < min_length:
                if min_length > 1 and n > 1 and prev_luma >= DEF_THT_BLACK_MIN > luma_n:
                    self._record("Skip", n, last_index, -1, -1, luma_n, -1)
                    continue
                sc_reason = 4
            ssim_score = hist_score = 1
            if tht_ssim == 1:
                scene_change = self.tht_black < luma_n < self.tht_white
                sc_reason = (sc_reason + 1) if scene_change else 0
            else:
                ssim_score = round(_ssim_uniform(grays[i], prev_y), 4)
                hist_score = round(1.0 - _hellinger(prev_hist, hists[i]), 4)
                if ssim_score < tht_ssim and hist_score < DEF_HIST_SCORE_HIGH:
                    scene_change = self.tht_black < luma_n < self.tht_white
                    if scene_change and sc_reason == 0 and self.frequency > 1:
                        scene_change = not (
                            luma_n < DEF_THT_BLACK_FREQ
                            and ratios[i] < DEF_ADAPTIVE_RATIO_RF
                        )
                    sc_reason = (sc_reason + 1) if scene_change else 0
                elif (
                    ssim_score >= DEF_SSIM_SCORE_EQUAL
                    and prev_luma < DEF_THT_BLACK_MIN <= luma_n
                ):
                    scene_change = self.tht_black < luma_n < self.tht_white
                    sc_reason = (sc_reason + 2) if scene_change else 0
                elif (
                    ssim_score >= DEF_SSIM_SCORE_EQUAL
                    and hist_score < DEF_HIST_SCORE_EQUAL
                ):
                    scene_change = DEF_THT_BLACK_MIN < luma_n < DEF_THT_WHITE_MIN
                    sc_reason = (sc_reason + 3) if scene_change else 0
                else:
                    scene_change = False
                    sc_reason = 0
            if scene_change:
                out[i] = 1
                self._record("New", n, last_index, ssim_score, hist_score, luma_n, sc_reason)
                last_index = n
                prev_y = grays[i]
                prev_hist = hists[i]
                prev_luma = luma_n
            else:
                self._record("Skip", n, last_index, ssim_score, hist_score, luma_n, sc_reason)
        return out, (last_index, prev_y, prev_hist, prev_luma)

    def _trivial_frequency(self):
        """The frequency of a mode that reads no statistics (0: frame 0
        only), else ``None``."""
        if self.threshold == 0 and self.frequency == 0:
            return 0
        if self.frequency == 1 or (self.threshold == 0 and self.frequency > 1):
            return max(self.frequency, 1)
        return None

    def detect(self, frames) -> SceneFlags:
        T = len(frames)
        sc, lumas, ratios = StreamSceneDetector._of(self)._feed(frames)
        if lumas is None:
            return SceneFlags.every(T, freq=self._trivial_frequency())
        return SceneFlags(
            sc_prev=sc,
            sc_next=np.zeros(T, dtype=np.int8),
            luma=lumas.astype(np.float32),
            ratio=ratios,
            threshold=self.threshold,
            frequency=self.frequency,
        )


def scene_detect(
    frames,
    threshold: float = DEF_THRESHOLD,
    frequency: int = 0,
    sc_tht_filter: float = 0.0,
    min_length: int = 1,
    tht_white: float = DEF_THT_WHITE,
    tht_black: float = DEF_THT_BLACK,
    tht_offset: int = 1,
    normalize: bool = False,
    debug: bool = False,
    device=None,
) -> SceneFlags:
    """Scene-change flags of (T, H, W, 3) RGB frames (numpy or a tensor).
    ``debug=True`` logs each New/Skip decision of the confirmation pass
    with its SSIM, histogram, luma and reason (logger ``havc_tpu_torch``,
    level WARNING)."""
    det = SceneDetector(
        threshold=threshold,
        frequency=frequency,
        sc_tht_filter=sc_tht_filter,
        min_length=min_length,
        tht_white=tht_white,
        tht_black=tht_black,
        tht_offset=tht_offset,
        normalize=normalize,
        debug=debug,
        device=device,
    )
    flags = det.detect(frames)
    if debug:
        from ..utils.log import HAVC_LogMessage, MessageType

        for r in det.debug_records:
            HAVC_LogMessage(
                MessageType.WARNING,
                f"SC=[{r['state']}], Frame_n= ", r["frame"],
                ", PrvFrame= ", r["prev"], ", SSIM= ", r["ssim"],
                ", Hist= ", r["hist"], ", Luma= ", r["luma"],
                ", ScReason= ", r["reason"],
            )
    return flags


class StreamSceneDetector:
    """:class:`SceneDetector` fed chunk by chunk: ``feed`` returns the
    flags ``SceneDetector.detect`` gives those frames on the whole
    concatenation.  Carries the ``tht_offset`` lag window of gray maps (on
    the device), the adaptive-ratio state and the confirmation state (the
    last accepted reference's gray map, histogram and luma); one device
    pass and one copy to the host per chunk.  ``SceneDetector.detect`` is
    one feed of the whole clip."""

    def __init__(self, threshold: float = DEF_THRESHOLD, frequency: int = 0,
                 sc_tht_filter: float = 0.0, min_length: int = 1,
                 tht_white: float = DEF_THT_WHITE,
                 tht_black: float = DEF_THT_BLACK, tht_offset: int = 1,
                 normalize: bool = False, debug: bool = False, device=None):
        self._start(SceneDetector(
            threshold=threshold, frequency=frequency,
            sc_tht_filter=sc_tht_filter, min_length=min_length,
            tht_white=tht_white, tht_black=tht_black,
            tht_offset=tht_offset, normalize=normalize, debug=debug, device=device,
        ))

    @classmethod
    def _of(cls, det: SceneDetector) -> "StreamSceneDetector":
        """A stream at frame 0 that runs ``det`` (its records included)."""
        stream = cls.__new__(cls)
        stream._start(det)
        return stream

    def _start(self, det: SceneDetector) -> None:
        self.det = det
        self.t_offset = min(max(det.tht_offset, 1), 25)
        self.m_length = min(max(det.min_length, 1), 25)
        self.need_maps = 0.0 < det.sc_tht_filter < 1.0 or self.m_length > 1
        self.use_custom = det.sc_tht_filter > 0.0 or det.threshold < 0.10 or self.t_offset > 1
        self.n0 = 0  # global index of the next frame fed
        self._tail = None  # the last min(n0, t_offset) gray maps, on the device
        self._custom_state = None
        self._filter_state = None

    def feed(self, frames) -> np.ndarray:
        """Flags of the next chunk of (t, H, W, 3) frames, (t,) int8."""
        return self._feed(frames)[0]

    def _feed(self, frames) -> tuple:
        """``(flags, lumas, ratios)`` of the next chunk; the statistics are
        ``None`` in a mode that reads none."""
        det = self.det
        T = len(frames)
        n0 = self.n0
        self.n0 += T
        freq = det._trivial_frequency()
        if freq is not None:
            return SceneFlags.every(n0 + T, freq=freq).sc_prev[n0:], None, None

        with torch.inference_mode():
            gray_small = _gray_maps(on_device(frames, det.device), det.normalize)
            k = 0
            if self._tail is not None:
                # the lag window in front, so that diffs[i] compares with the
                # right global frame; it is min(n0, offset) deep, so the clamp
                # at the clip's start is the whole clip's
                k = self._tail.shape[0]
                gray_small = torch.cat([self._tail, gray_small], dim=0)
            lumas, diffs, hists = _stats(gray_small, self.t_offset, self.need_maps)
            lumas, diffs = host_read(torch.stack([lumas, diffs])[:, k:])
            self._tail = gray_small[-min(self.t_offset, gray_small.shape[0]):]
            if self.need_maps:
                grays = host_read(gray_small[k:])
                hists = host_read(hists[k:])

        if self.use_custom:
            ml = self.m_length if self.need_maps else DEF_SC_MIN_DISTANCE
            sc, ratios, self._custom_state = det._custom_pass(
                lumas, diffs, ml, n0=n0, state=self._custom_state)
        else:
            sc, ratios = det._simple_pass(lumas, diffs, n0=n0)
        if self.need_maps:
            sc, self._filter_state = det._filter_pass(
                sc, lumas, ratios, grays, hists, self.m_length,
                n0=n0, state=self._filter_state)
        return sc, lumas, ratios
