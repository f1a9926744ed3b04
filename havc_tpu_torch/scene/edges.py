"""Edge-based scene detection.

Port of ``havc_tpu.scene.edges`` (the reference's SceneDetectEdges:
Kirsch + TCanny-role edge mask, offset-frame difference, the ladder of
decision reasons and the SSIM confirmation).  The device phase (BT.709
limited-range gray, Spline36 downscale, the draft edge mask, the per-frame
statistics) runs where the frames are; the host decision loop reads
numpy copies made once per call.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..clip import SceneFlags
from ..ops.resize import resize
from ..utils.precision import ieee_precision
from ..utils.profiling import host_read, on_device
from .detect import DEF_THT_WHITE, _ssim_uniform, _work_size

__all__ = ["edge_stats", "scene_detect_edges", "kirsch_edges", "sobel_magnitude",
           "retinex_edgemask_draft"]

# The 8 Kirsch compass kernels (3x3), max response taken.
_KIRSCH = np.array(
    [
        [[5, 5, 5], [-3, 0, -3], [-3, -3, -3]],
        [[5, 5, -3], [5, 0, -3], [-3, -3, -3]],
        [[5, -3, -3], [5, 0, -3], [5, -3, -3]],
        [[-3, -3, -3], [5, 0, -3], [5, 5, -3]],
        [[-3, -3, -3], [-3, 0, -3], [5, 5, 5]],
        [[-3, -3, -3], [-3, 0, 5], [-3, 5, 5]],
        [[-3, -3, 5], [-3, 0, 5], [-3, -3, 5]],
        [[-3, 5, 5], [-3, 0, 5], [-3, -3, -3]],
    ],
    dtype=np.float32,
)
_SOBEL_X = np.array([[[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]], np.float32)
_SOBEL_Y = np.array([[[-1, -2, -1], [0, 0, 0], [1, 2, 1]]], np.float32)


def _gauss(sigma: float) -> np.ndarray:
    r = max(int(3 * sigma), 1)
    t = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-(t**2) / (2 * sigma * sigma))
    return k / k.sum()


def _correlate(xp: torch.Tensor, k: np.ndarray, h: int, w: int) -> torch.Tensor:
    """(T, h + kh - 1, w + kw - 1) correlated with one (kh, kw) kernel ->
    (T, h, w): the sum of its taps' shifted planes, in plain tensor
    arithmetic (the same on every device: no convolution algorithm is
    chosen at run time)."""
    out = None
    for (i, j), c in np.ndenumerate(k):
        if c != 0:
            term = float(c) * xp[:, i:i + h, j:j + w]
            out = term if out is None else out + term
    return out


@ieee_precision()
def _conv2d(x: torch.Tensor, bank: np.ndarray) -> torch.Tensor:
    """(T, H, W) correlated with a bank of (N, 3, 3) kernels over the
    edge-replicated border -> (T, N, H, W).  Pinned to IEEE float32 (its
    mul-adds read no flag today): the detectors' strict thresholds must
    decide on the card as on the CPU."""
    h, w = x.shape[-2:]
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return torch.stack([_correlate(xp, k, h, w) for k in bank], dim=1)


def kirsch_edges(gray: torch.Tensor, thresh: float = 0.25) -> torch.Tensor:
    """Kirsch compass edge mask over (T, H, W) luma in [0, 1]."""
    mag = _conv2d(gray, _KIRSCH).amax(dim=1) / 15.0  # the largest kernel gain
    return (mag > thresh).to(gray.dtype)


def _to_gray709_limited(rgb: torch.Tensor) -> torch.Tensor:
    """BT.709 luma in limited range [16/255, 235/255] (the reference's GRAY8
    working space, where its statistics and luma gates are computed)."""
    y = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    return y * (219.0 / 255.0) + 16.0 / 255.0


def sobel_magnitude(gray: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude (the TCanny-role edge strength), about [0, 1]."""
    gx = _conv2d(gray, _SOBEL_X)[:, 0]
    gy = _conv2d(gray, _SOBEL_Y)[:, 0]
    return torch.hypot(gx, gy) / 5.66


def _gaussian_blur_small(x: torch.Tensor, sigma: float = 1.2) -> torch.Tensor:
    """Separable Gaussian (radius 3 sigma) over the edge-replicated border."""
    k = _gauss(sigma)
    r = len(k) // 2
    h, w = x.shape[-2:]
    xp = F.pad(x[:, None], (r, r, r, r), mode="replicate")[:, 0]
    out = _correlate(xp, k[:, None], h, w + 2 * r)
    return _correlate(out, k[None, :], h, w)


def retinex_edgemask_draft(gray: torch.Tensor, sigma: float = 1.2) -> torch.Tensor:
    """The live detector's edge mask: the sqrt-boosted luma's blurred
    gradient magnitude plus the Kirsch response, each saturating at 1 (the
    reference's uint8 convolutions divide by a zero kernel sum as 1)."""
    enhanced = torch.sqrt(torch.clamp(gray, 0.0, 1.0))
    blurred = _gaussian_blur_small(enhanced, sigma)
    tcanny = torch.hypot(_conv2d(blurred, _SOBEL_X)[:, 0], _conv2d(blurred, _SOBEL_Y)[:, 0])
    kirsch_mag = torch.clamp(_conv2d(gray, _KIRSCH).abs().amax(dim=1), 0.0, 1.0)
    return torch.clamp(kirsch_mag + torch.clamp(tcanny, 0.0, 1.0), 0.0, 1.0)


def _edge_kernel(gray_small: torch.Tensor, offset: int = 2):
    t = gray_small.shape[0]
    mask = retinex_edgemask_draft(gray_small)
    nxt = gray_small[torch.clamp(torch.arange(t, device=gray_small.device) + offset, 0, t - 1)]
    diff = (gray_small - nxt).abs()
    edge_diff = 10.0 * (diff * mask).mean(dim=(-2, -1))
    ssim_diff = 4.0 * diff.mean(dim=(-2, -1))
    lumas = gray_small.mean(dim=(-2, -1))
    return mask, edge_diff, ssim_diff, lumas


def _gray_small(frames, device) -> torch.Tensor:
    gray = _to_gray709_limited(on_device(frames, device))
    nh, nw = _work_size(gray.shape[-2], gray.shape[-1])
    return resize(gray[..., None], nh, nw, "spline36")[..., 0]


@torch.inference_mode()
def edge_stats(frames, offset: int = 2, device=None):
    """Device phase: numpy (gray_small, edge mask, edge_diff (masked),
    ssim_diff (plain), lumas) of (T, H, W, 3) RGB frames."""
    gray_small = _gray_small(frames, device)
    mask, edge_diff, ssim_diff, lumas = _edge_kernel(gray_small, offset)
    edge_diff, ssim_diff, lumas = host_read(torch.stack([edge_diff, ssim_diff, lumas]))
    return host_read(gray_small), host_read(mask), edge_diff, ssim_diff, lumas


@torch.inference_mode()
def _detector_stats(frames, offset: int, need_maps: bool, device):
    """What the decision loop reads, in one copy to the host: edge_diff,
    ssim_diff, lumas, the mean abs difference to the previous frame (0 at
    frame 0), and the gray maps when the SSIM confirmation runs."""
    gray_small = _gray_small(frames, device)
    _, edge_diff, ssim_diff, lumas = _edge_kernel(gray_small, offset)
    t = gray_small.shape[0]
    prev = gray_small[torch.clamp(torch.arange(t, device=gray_small.device) - 1, 0, t - 1)]
    prev_diff = (gray_small - prev).abs().mean(dim=(-2, -1))
    stats = host_read(torch.stack([edge_diff, ssim_diff, lumas, prev_diff]))
    return stats, host_read(gray_small) if need_maps else None


def scene_detect_edges(
    frames,
    threshold: float = 0.07,
    frequency: int = 0,
    sc_tht_ssim: float = 0.0,
    sc_diff_offset: int = 2,
    sc_min_int: int = 30,
    sc_mult_tht: int = 7,
    tht_white: float = DEF_THT_WHITE,
    tht_black: float = 0.12,
    min_length: int | None = None,  # legacy alias of sc_min_int
    device=None,
) -> SceneFlags:
    """Edge-based detector with the reference's ladder of reasons, gated to
    ``tht_black <= luma <= tht_white``:

    * 3/4: the plain luma detector fired (mean abs difference to the
      previous frame > 0.10; 4 when the edge diff also exceeds
      ``sc_mult_tht`` x threshold),
    * 2: the edge diff alone exceeds ``sc_mult_tht`` x threshold,
    * 1: edge_diff > threshold and ssim_diff > 1.75 x threshold, at least
      ``sc_min_int`` frames after the last cut;

    a repeated 3/4 or 2 needs ``max(sc_mult_tht // 2, 3)`` frames of
    distance.  With 0 < ``sc_tht_ssim`` < 1 a cut whose SSIM against the
    last accepted one reaches it is dropped."""
    if min_length is not None:
        sc_min_int = min_length
    T = len(frames)
    sc_mult_tht = 7 if sc_mult_tht == 0 else sc_mult_tht
    sc_diff_offset = max(sc_diff_offset, 1)
    ssim_diff_threshold = round(1.75 * threshold, 5)
    use_ssim = 0.0 < sc_tht_ssim < 1.0

    stats, grays = _detector_stats(frames, sc_diff_offset, use_ssim, device)
    edge_diff, ssim_diff, lumas, prev_diff = stats
    prev_diff[0] = 0.0
    mandatory_1 = prev_diff > 0.10

    sc = np.zeros(T, dtype=np.int8)
    reason = np.zeros(T, dtype=np.int8)
    last_sc = -sc_min_int
    last_status = ""
    prev_ref = None
    min_dist_small = max(int(sc_mult_tht * 0.5), 3)
    for n in range(T):
        if n == 0:
            sc[n] = 1
            reason[n] = 4
            last_sc = 0
            last_status = "tht_max_first"
            prev_ref = 0
            continue
        f_luma = float(lumas[n])
        in_luma = tht_black <= f_luma <= tht_white
        above_tht = (float(edge_diff[n]) > threshold) and (
            float(ssim_diff[n]) > ssim_diff_threshold)
        above_dist_max = (n - last_sc) >= sc_min_int
        above_dist_min = (n - last_sc) >= min_dist_small
        m1 = bool(mandatory_1[n])
        m2 = float(edge_diff[n]) > threshold * sc_mult_tht
        accept = False
        if in_luma:
            if m1:
                if ("tht_max" not in last_status) or above_dist_min:
                    accept = True
                    reason[n] = 4 if m2 else 3
                    last_status = "tht_max+edge_max" if m2 else "tht_max"
            elif m2:
                if ("edge_max" not in last_status) or above_dist_min:
                    accept = True
                    reason[n] = 2
                    last_status = "edge_max"
            elif above_dist_max and above_tht:
                accept = True
                reason[n] = 1
                last_status = "accepted"
        if accept and use_ssim and _ssim_uniform(grays[n], grays[prev_ref]) >= sc_tht_ssim:
            accept = False
            reason[n] = 0
        if accept:
            sc[n] = 1
            last_sc = n
            prev_ref = n

    if frequency > 1:
        sc[::frequency] = 1  # frequency forcing on top of the detection
    return SceneFlags(
        sc_prev=sc,
        sc_next=np.zeros(T, dtype=np.int8),
        luma=lumas.astype(np.float32),
        ratio=edge_diff.astype(np.float32),
        threshold=threshold,
    )
