"""Public HAVC_* entry points, on :class:`Clip`.

Port of ``havc_tpu.api``:

* ``HAVC_main`` for every preset: Placebo -> ``HAVC_placebo_preset`` (2x2
  overlapping tiles), VerySlow -> ``HAVC_veryslow_preset`` (two darkened
  passes merged), the rest -> ``HAVC_main_presets`` (BlackWhiteTune pre-
  and post-passes, the Retinex/Red film LUT, ``lut``, deflicker) ->
  ``HAVC_main_colorizer``: the classic branch (``HAVC_colorizer``: work
  resize, DeOldify and DDColor or Zhang, merge methods 0-7, chroma
  restore; ``HAVC_stabilizer``: fused post-chain kernel or the filter
  chain, temporal chroma stabilizer, deflicker, chroma restore) and the
  DeepEx branch for methods 0/1/2 (``HAVC_colorizer`` with scene detection
  makes the reference frames, ``exemplar.HAVC_deepex`` propagates them
  with ColorMNet, Deep-Exemplar, DeepRemaster or the hybrid, then the
  fast stabilizer settings) and FrameInterp (every n-th frame colorized,
  Deep-Exemplar (1-4) or ColorMNet (5-10) in between);
* the filters: ``HAVC_merge``, ``HAVC_bw_tune``, ``HAVC_auto_levels``,
  ``HAVC_retinex``, ``HAVC_rgb_denoise``, ``HAVC_adjust_rgb``,
  ``HAVC_tweak``, ``HAVC_TimeCube``, ``HAVC_recover_clip_color``,
  ``HAVC_ColorAdjust`` (with ReColor), ``HAVC_main_restore``, the tiles
  (``HAVC_clip_slice``, ``HAVC_clip_reconstruct``), ``HAVC_read_video``,
  ``HAVC_DeepRemaster`` and the parameter setters;
* the scene detectors (``HAVC_SceneDetect``, ``HAVC_SceneDetectEdges``,
  ``HAVC_SceneDetectMotion``), the reference-frame export
  (``HAVC_extract_reference_frames`` with ``sc_algo`` 0-3,
  ``HAVC_export_reference_frames``, ``HAVC_export_list_frames``), the
  overlay compositor (``HAVC_clip_overlay``), the NLM degrain
  (``HAVC_degrain``) and the legacy wrappers (``HAVC_ddeoldify``,
  ``ddeoldify``, ``ddeoldify_main``, ``ddeoldify_stabilizer``,
  ``HAVC_cmnet``, ``vs_frame_interpolation``, ``disable_warnings``).

Parameter names, packs and defaults are the JAX package's.

Every entry point that computes takes ``device``: ``None`` means CUDA and
raises when there is none; ``device="cpu"`` runs on the CPU.  A clip of numpy frames
comes back with numpy frames; a clip of tensors comes back with tensors on
the device it ran on.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from . import engines, filters, presets
from .clip import Clip, SceneFlags
from .ops import chroma as chroma_ops
from .ops import equalize, lut3d
from .ops import merge as merge_ops
from .ops import retinex as retinex_ops
from .ops import temporal as temporal_ops
from .ops import tiles as tiles_ops
from .ops.post_chain import post_chain
from .ops.resize import resize
from .scene.detect import scene_detect
from .utils import profiling
from .utils.log import HAVC_LogMessage, MessageType
from .utils.profiling import resolve_device, stage_timer

__all__ = [
    "HAVC_main",
    "HAVC_main_presets",
    "HAVC_main_colorizer",
    "HAVC_colorizer",
    "HAVC_stabilizer",
    "HAVC_placebo_preset",
    "HAVC_veryslow_preset",
    "HAVC_merge",
    "HAVC_bw_tune",
    "HAVC_auto_levels",
    "HAVC_retinex",
    "HAVC_rgb_denoise",
    "HAVC_adjust_rgb",
    "HAVC_tweak",
    "HAVC_TimeCube",
    "HAVC_clip_slice",
    "HAVC_clip_reconstruct",
    "HAVC_recover_clip_color",
    "HAVC_main_restore",
    "HAVC_ColorAdjust",
    "HAVC_colorizer_fast",
    "HAVC_restore_video",
    "HAVC_DeepRemaster",
    "HAVC_read_video",
    "HAVC_set_tweak_params",
    "HAVC_set_merge_params",
    "HAVC_set_debug_level",
    "HAVC_SceneDetect",
    "HAVC_SceneDetectEdges",
    "HAVC_SceneDetectMotion",
    "HAVC_extract_reference_frames",
    "HAVC_export_reference_frames",
    "HAVC_export_list_frames",
    "HAVC_clip_overlay",
    "HAVC_degrain",
    "HAVC_ddeoldify",
    "HAVC_cmnet",
    "ddeoldify",
    "ddeoldify_main",
    "ddeoldify_stabilizer",
    "vs_frame_interpolation",
    "disable_warnings",
    "ClipTiles",
    "bw_tune_frames",
    "auto_levels_frames",
    "DEF_TWEAK_p",
]

from .ops.merge import DEF_ALM_p, DEF_CMC_p, DEF_CRT_p, DEF_LMM_p

DEF_TWEAK_p = engines.DEF_TWEAK_p
DEF_HAVC_METHOD_PLACEBO = 10  # the internal frame-interpolation method id

_DEBUG_LEVEL = [0]


def HAVC_set_debug_level(debug_level: int = 0):
    """0 = silent; 1 = info: stage timing on, and ``HAVC_main`` logs
    (``utils.log``, level INFO) once per call the table of its stages:
    each stage's device ms (CUDA events, no sync), host ms, self ms (less
    the stages inside it) and calls, then the counters (``host_syncs``,
    ``clips``, the kernels' launches); 2 = info + debug."""
    if debug_level in (0, 1, 2):
        _DEBUG_LEVEL[0] = debug_level
        profiling.set_debug_timing(debug_level >= 1)


def _on(clip: Clip, dev: torch.device):
    """(clip as a tensor on ``dev``, whether to hand numpy back)."""
    return clip.to_device(dev), not clip.on_device


@torch.inference_mode()
def _map(clip: Clip, fn, batch_size: int, dev: torch.device) -> Clip:
    """``fn`` over the clip's frames in batches on ``dev``; the result
    lives where the input did."""
    c, to_host = _on(clip, dev)
    out = c.map_batches(fn, batch_size)
    return out.to_host() if to_host else out


@torch.inference_mode()
def _map2(clipa: Clip, clipb: Clip, fn, batch_size: int, dev: torch.device) -> Clip:
    """``fn(a, b)`` over batches of two clips of one length on ``dev``; the
    result takes ``clipa``'s metadata and residency."""
    a, to_host = _on(clipa, dev)
    b = clipb.to_device(dev).frames
    out = a.with_frames(torch.cat([fn(a.frames[s:s + batch_size], b[s:s + batch_size])
                                   for s in range(0, a.num_frames, batch_size)], dim=0))
    return out.to_host() if to_host else out


# --------------------------------------------------------------------------
# HAVC_colorizer — the core colorize step
# --------------------------------------------------------------------------


@torch.inference_mode()
def HAVC_colorizer(
    clip: Clip,
    method: int = 2,
    mweight: float = 0.4,
    deoldify_p=(0, 24, 1.0, 0.0),
    ddcolor_p=(1, 24, 1.0, 0.0, True),
    ddtweak=(False, False, False),
    ddtweak_p=(DEF_TWEAK_p, "300:360|0.8,0.1"),
    cmc_p=DEF_CMC_p,
    lmm_p=DEF_LMM_p,
    alm_p=DEF_ALM_p,
    crt_p=DEF_CRT_p,
    cmb_sw: bool = False,
    sc_threshold: float = 0.0,
    sc_tht_offset: int = 1,
    sc_min_freq: int = 0,
    sc_tht_ssim: float = 0.0,
    sc_normalize: bool = False,
    sc_min_int: int = 1,
    sc_tht_white: float = 0.70,
    sc_tht_black: float = 0.10,
    device_index: int = 0,
    torch_dir: Optional[str] = None,
    debug_level: int = 0,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Colorize with DeOldify and/or DDColor and combine (method 0-7):
    spline64 square resize to ``max(rf)*16``, both engines, merge,
    chroma-resize restore.  With scene detection (``sc_threshold`` or
    ``sc_min_freq`` non-zero) the flags are attached and only the
    scene-change frames are colorized; the others pass through."""
    del device_index, torch_dir
    if debug_level:
        HAVC_set_debug_level(debug_level)
    if sc_threshold < 0:
        raise ValueError("HAVC_colorizer: sc_threshold must be >= 0")
    if sc_min_freq < 0:
        raise ValueError("HAVC_colorizer: sc_min_freq must be >= 0")
    dev = resolve_device(device)

    if method == 0:
        merge_weight = 0.0
    elif method == 1:
        merge_weight = 1.0
    else:
        merge_weight = mweight
    if merge_weight == 0.0:
        method = 0
    elif merge_weight == 1.0:
        method = 1

    do_model, do_rf, do_sat, do_hue = deoldify_p[:4]
    dd_model, dd_rf, dd_sat, dd_hue = ddcolor_p[:4]
    if dd_rf != 0 and dd_rf not in range(10, 65):
        raise ValueError("HAVC_colorizer: ddcolor render_factor must be between: 10-64")
    if dd_rf == 0:
        dd_rf = min(max(math.trunc(0.4 * clip.width / 16), 16), 32)
    frame_size = min(max(dd_rf, do_rf) * 16, clip.width)

    clip, to_host = _on(clip, dev)
    sc_idx = None
    if not (sc_threshold == 0 and sc_min_freq == 0):
        with stage_timer("scene_detect"):
            flags = scene_detect(
                clip.frames, threshold=sc_threshold, frequency=sc_min_freq,
                sc_tht_filter=sc_tht_ssim, min_length=sc_min_int, tht_white=sc_tht_white,
                tht_black=sc_tht_black, tht_offset=sc_tht_offset, normalize=sc_normalize,
                device=dev,
            )
        clip = clip.with_sc(flags)
        sc_idx = np.nonzero(flags.sc_prev.astype(bool))[0]
    out = _colorize_fused(
        clip, method, merge_weight, do_model, do_rf, do_sat, do_hue,
        dd_model, dd_rf, dd_sat, dd_hue, ddtweak, ddtweak_p,
        cmc_p, lmm_p, alm_p, crt_p, cmb_sw, frame_size, batch_size, dev, sc_idx,
    )
    return out.to_host() if to_host else out


def _colorize_fused(
    clip: Clip, method: int, merge_weight: float,
    do_model: int, do_rf: int, do_sat: float, do_hue: float,
    dd_model: int, dd_rf: int, dd_sat: float, dd_hue: float,
    ddtweak, ddtweak_p, cmc_p, lmm_p, alm_p, crt_p, cmb_sw: bool,
    frame_size: int, batch_size: int, dev: torch.device,
    sc_idx: Optional[np.ndarray] = None,
) -> Clip:
    """Work resize -> engines -> combine -> chroma restore, batch by batch
    over a clip of tensors on ``dev``.  ``sc_idx`` selects the frames to
    colorize (gathered, colorized, scattered back); the others pass
    through."""
    do_fn = dd_fn = None
    if method != 1:
        do_fn = engines.make_deoldify_fn(do_model, do_rf, device=dev)
    if method != 0:
        dd_fn = engines.make_ddcolor_fn(
            dd_model, dd_rf, tweaks_flags=tuple(ddtweak), tweaks=ddtweak_p, device=dev
        )

    def stage(frames):
        with stage_timer("work_resize"):
            work = torch.clamp(resize(frames, frame_size, frame_size, "spline64"), 0.0, 1.0)
        if method == 0:
            with stage_timer("deoldify"):
                combined = do_fn(work)
            if do_sat != 1 or do_hue != 0:
                combined = chroma_ops.tweak(combined, hue=do_hue, sat=do_sat)
        elif method == 1:
            with stage_timer("ddcolor"):
                combined = dd_fn(work)
            if dd_sat != 1 or dd_hue != 0:
                combined = chroma_ops.tweak(combined, hue=dd_hue, sat=dd_sat)
        else:
            with stage_timer("deoldify"):
                a = do_fn(work)
            with stage_timer("ddcolor"):
                b = dd_fn(work)
            with stage_timer("merge"):
                combined = merge_ops.combine_models(
                    a, b, method=method, sat=(do_sat, dd_sat), hue=(do_hue, dd_hue),
                    b_weight=merge_weight, cmc_p=cmc_p, lmm_p=lmm_p, alm_p=alm_p,
                    crt_p=crt_p, invert_clips=cmb_sw,
                )
        with stage_timer("chroma_restore"):
            return filters.chroma_resize_restore(frames, combined)

    if sc_idx is None:
        return clip.map_batches(stage, batch_size)
    if len(sc_idx) == 0:
        return clip
    with stage_timer("sc_gather"):
        picked = torch.cat([clip.frames[i:i + 1] for i in sc_idx])
    colored = Clip(frames=picked).map_batches(stage, batch_size).frames
    with stage_timer("sc_scatter"):
        out = clip.frames.clone()
        for j, i in enumerate(sc_idx):
            out[i] = colored[j]
    return clip.with_frames(out)


def _chroma_resize_clip(hires: Clip, lowres: Clip, batch_size: int = 8) -> Clip:
    """Spline64 chroma restore of ``lowres`` onto ``hires``'s luma, batch
    by batch; both clips hold tensors on one device."""
    return _map2(hires, lowres, filters.chroma_resize_restore, batch_size,
                 hires.frames.device).copy_sc_from(lowres)


# --------------------------------------------------------------------------
# HAVC_stabilizer — post chain
# --------------------------------------------------------------------------


@torch.inference_mode()
def HAVC_stabilizer(
    clip: Clip,
    dark: bool = False,
    dark_p=(0.2, 0.8),
    smooth: bool = False,
    smooth_p=(0.3, 0.7, 0.9, 0.0, "none"),
    colormap: str = "none",
    colormap_p: str = "none",
    stab: bool = False,
    stab_p=(5, "A", 1, 15, 0.2, 0.8),
    deflicker: bool = True,
    render_factor: int = 24,
    use_pallas: bool = True,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Post-process chain at chroma resolution: dark tweak -> chroma
    smoothing -> colormap (fused into the post-chain kernel when no hue-DSL
    extras are set and ``use_pallas``, the name kept for script parity) ->
    temporal chroma stabilization -> deflicker, then the full-resolution
    luma restored."""
    if render_factor != 0 and render_factor not in range(16, 65):
        raise ValueError("HAVC_stabilizer: render_factor must be between: 16-64")
    if render_factor == 0:
        render_factor = min(max(math.trunc(0.4 * clip.width / 16), 16), 32)
    dev = resolve_device(device)

    clip, to_host = _on(clip, dev)
    clip_orig = clip
    frame_size = min(render_factor * 16, clip.width)
    with stage_timer("stab_resize"):
        x = clip.map_batches(
            lambda f: torch.clamp(resize(f, frame_size, frame_size, "spline64"), 0.0, 1.0),
            batch_size,
        )

    dark_hue_adjust = dark_p[2] if len(dark_p) > 2 else "none"
    chroma_adjust = smooth_p[4] if len(smooth_p) > 4 else "none"
    cmap_l = (colormap or "none").lower()
    fusable = (
        use_pallas
        and dark and smooth
        and dark_hue_adjust in ("none", "")
        and chroma_adjust in ("none", "")
    )
    if fusable:
        cmap_ranges, cmap_hue, cmap_sat, cmap_w = (), 0.0, 1.0, 0.0
        if cmap_l not in ("none", ""):
            cmap_str = presets.get_colormap(cmap_l, "light") if "->" in cmap_l else cmap_l
            pa = chroma_ops.parse_hue_adjust(cmap_str)
            if pa is not None:
                cmap_ranges, cmap_sat, cmap_hue, cmap_w = (
                    pa.ranges, pa.sat, float(pa.hue), pa.weight
                )
        d_white = min(max(dark_p[0], 0.1), 0.50)
        d_sat = min(max(1.1 - dark_p[1], 0.10), 0.80)
        d_bright = -min(max(dark_p[1], 0.20), 0.90)
        with stage_timer("post_chain"):
            x = x.with_frames(post_chain(
                x.frames,
                dark_thr=0.1, dark_white=d_white, dark_sat=d_sat,
                dark_bright=d_bright,
                sm_black=smooth_p[0], sm_white=smooth_p[1],
                sm_sat=smooth_p[2], sm_bright=-smooth_p[3],
                cmap_ranges=cmap_ranges, cmap_hue_shift=cmap_hue,
                cmap_sat=cmap_sat, cmap_weight=cmap_w,
            ))
    if dark and not fusable:
        x = x.map_batches(
            lambda f: filters.dark_tweak(
                f, dark_threshold=dark_p[0], dark_amount=dark_p[1],
                dark_hue_adjust=dark_hue_adjust.lower(),
            ),
            batch_size,
        )
    if smooth and not fusable:
        x = x.map_batches(
            lambda f: filters.chroma_bright_tweak(
                f, black_threshold=smooth_p[0], white_threshold=smooth_p[1],
                dark_sat=smooth_p[2], dark_bright=-smooth_p[3],
                chroma_adjust=chroma_adjust.lower(),
            ),
            batch_size,
        )
    if cmap_l not in ("none", "") and not fusable:
        cmap_adjust = presets.get_colormap(cmap_l, "light") if "->" in cmap_l else cmap_l
        x = x.map_batches(lambda f: filters.colormap_filter(f, cmap_adjust), batch_size)
    if stab:
        nframes, mode, sat, tht, weight, tht_scen = stab_p[:6]
        sc = x.sc.sc_prev if x.sc is not None else None
        with stage_timer("chroma_stabilizer"):
            x = x.with_frames(temporal_ops.chroma_stabilizer(
                x.frames, nframes=nframes, weighted=(str(mode).upper() == "W"),
                scenechange=sc, sat=sat, tht=tht, weight=weight, tht_scen=tht_scen,
            ))
        if deflicker:
            with stage_timer("deflicker"):
                x = x.with_frames(temporal_ops.reduce_flicker(x.frames, scenechange=sc))

    with stage_timer("stab_chroma_restore"):
        out = _chroma_resize_clip(clip_orig, x, batch_size)
    return out.to_host() if to_host else out


# --------------------------------------------------------------------------
# merge / tune / misc public utilities
# --------------------------------------------------------------------------


def HAVC_merge(
    clipa: Clip = None,
    clipb: Optional[Clip] = None,
    clip_luma: Optional[Clip] = None,
    weight: float = 0.5,
    method: int = 2,
    cmc_p=DEF_CMC_p,
    lmm_p=DEF_LMM_p,
    alm_p=DEF_ALM_p,
    crt_p=DEF_CRT_p,
    cmb_sw: bool = False,
    mweight: Optional[float] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Combine two colorized clips: ``method`` 0/1 return clipa/clipb,
    2-7 the merge methods with ``weight`` the weight of clipb.  With
    ``clip_luma`` the result takes its luma (and its metadata).
    ``mweight`` is a legacy alias of weight."""
    if clipa is None:
        raise ValueError("HAVC_merge: clipa is required")
    if mweight is not None:
        weight = mweight
    dev = resolve_device(device)

    def _with_luma(c: Clip) -> Clip:
        if clip_luma is None:
            return c
        return _map2(clip_luma, c, filters.recover_clip_luma, batch_size, dev)

    if method == 0 or clipb is None:
        return _with_luma(clipa)
    if method == 1:
        return _with_luma(clipb)
    merged = _map2(clipa, clipb, lambda a, b: merge_ops.combine_models(
        a, b, method=method, b_weight=weight, cmc_p=cmc_p, lmm_p=lmm_p, alm_p=alm_p,
        crt_p=crt_p, invert_clips=cmb_sw), batch_size, dev)
    return _with_luma(merged)


def _lim(v):
    return v * (219.0 / 255.0) + 16.0 / 255.0


def _unlim(v):
    return (v - 16.0 / 255.0) * (255.0 / 219.0)


def bw_tune_frames(
    x: torch.Tensor,
    tn_id: int,
    method: int = 0,
    luma_blend: bool = True,
    range_tv: bool = True,
) -> torch.Tensor:
    """Per-frame core of HAVC_bw_tune: the strength tables of each tune
    level, ``rgb_balance`` with the per-channel warm-up factors (skipped
    for ScaleAbs/Retinex), then the equalizer, inside the reference's
    full->limited range bracket (the codes are compressed twice on entry
    and expanded twice on exit, as the reference does)."""
    b_strength = [0.0, 0.30, 0.40, 0.50]
    w_strength = [0.0, 0.30, 0.40, 0.50]
    r_factor = [1.0, 0.96, 0.94, 0.92]
    g_factor = [1.0, 1.03, 1.05, 1.08]
    b_factor = [1.0, 1.0, 1.0, 1.0]
    method = min(5, method)
    if method == 5:
        b_strength = [0.0, 0.98, 0.99, 1.0]
    weight3 = float(tn_id) if method == 4 else w_strength[tn_id]
    if range_tv:
        x = _lim(_lim(x))
    if method < 4:
        x = equalize.rgb_balance(
            x, strength=w_strength[tn_id],
            rgb_factor=(r_factor[tn_id], g_factor[tn_id], b_factor[tn_id]),
        )
    x = equalize.rgb_equalizer(x, method=method, strength=b_strength[tn_id], weight3=weight3,
                               luma_blend_on=luma_blend)
    if range_tv:
        x = torch.clamp(_unlim(_unlim(x)), 0.0, 1.0)
    return x


def HAVC_bw_tune(
    clip: Clip = None,
    bw_tune: str = "Light",
    bw_method: int = 0,
    luma_blend: bool = True,
    range_tv: bool = True,
    chroma_resize: bool = False,
    batch_size: int = 8,
    method: Optional[int] = None,
    device=None,
) -> Clip:
    """B&W contrast/luminosity restoration.  ``chroma_resize=True`` runs
    the filter at a reduced square size and marries the original luma
    back.  ``method`` is a deprecated alias of ``bw_method``."""
    if clip is None:
        raise ValueError("HAVC_bw_tune: clip is required")
    if method is not None:
        bw_method = method
    tn_id = presets.get_tune_id(bw_tune)
    if tn_id == 0:
        return clip
    dev = resolve_device(device)
    work, to_host = _on(clip, dev)
    full = work
    resized = False
    if chroma_resize:
        rf = min(max(int(0.4 * clip.width / 16), 16), 48)
        frame_size = min(rf * 16, clip.width)
        if frame_size < clip.width:
            work = _map(work, lambda x: resize(x, frame_size, frame_size, "spline64"),
                        batch_size, dev)
            resized = True
    out = _map(work, lambda x: bw_tune_frames(x, tn_id, bw_method, luma_blend, range_tv),
               batch_size, dev)
    if resized:
        out = _chroma_resize_clip(full, out, batch_size)
    return out.to_host() if to_host else out


def auto_levels_frames(
    x: torch.Tensor,
    tn_id: int,
    method: int = 0,
    luma_blend: bool = False,
    range_tv: bool = True,
) -> torch.Tensor:
    """Per-frame core of HAVC_auto_levels: no white-balance step, the
    strength table [0, 0.98, 0.99, 1.0] for every method, inside the same
    double full->limited range bracket."""
    b_strength = [0.0, 0.98, 0.99, 1.0]
    if range_tv:
        x = _lim(_lim(x))
    x = equalize.rgb_equalizer(x, method=min(5, method), strength=b_strength[tn_id],
                               luma_blend_on=luma_blend)
    if range_tv:
        x = torch.clamp(_unlim(_unlim(x)), 0.0, 1.0)
    return x


def HAVC_auto_levels(
    clip: Clip = None, mode: str = "Light", method: int = 0,
    luma_blend: bool = False, range_tv: bool = True, batch_size: int = 8, device=None,
) -> Clip:
    """Histogram-equalization / retinex contrast filter for B&W clips."""
    if clip is None:
        raise ValueError("HAVC_auto_levels: clip is required")
    tn_id = presets.get_tune_id(mode)
    if tn_id == 0:
        return clip
    return _map(clip, lambda x: auto_levels_frames(x, tn_id, method, luma_blend, range_tv),
                batch_size, resolve_device(device))


def HAVC_retinex(
    clip: Clip,
    luma_dark: float = 0.20,
    luma_bright: float = 0.80,
    sigmas=(25.0, 80.0, 250.0),
    range_tv_in: bool = True,
    range_tv_out: bool = True,
    blend: bool = False,
    chroma_resize: bool = False,
    fast_mode: bool = True,
    batch_size: int = 4,
    strength: Optional[float] = None,
    device=None,
) -> Clip:
    """MSRCP retinex on the frames whose mean luma lies in [luma_dark,
    luma_bright] (the others pass through), with an optional dark-frame
    blend.  ``strength`` (older scripts) instead mixes MSRCP with the
    input at that weight."""
    dev = resolve_device(device)
    if strength is not None:
        return _map(clip, lambda x: x * (1 - strength) + retinex_ops.msrcp_rgb(x, sigmas)
                    * strength, batch_size, dev)
    return _map(clip, lambda x: retinex_ops.retinex_filter(
        x, luma_dark=luma_dark, luma_bright=luma_bright, sigmas=sigmas, range_tv=range_tv_in,
        blend=blend, fast_mode=fast_mode), batch_size, dev)


def HAVC_rgb_denoise(
    clip: Clip,
    denoise_levels=(0.4, 0.3),
    rgb_factors=(0.95, 1.05, 1.01),
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Color/contrast denoise for DDColor/Zhang output: white balance at
    ``denoise_levels[0]`` with ``rgb_factors``, luma CLAHE at
    ``denoise_levels[1]``, inside the double range bracket."""
    w_str, b_str = float(denoise_levels[0]), float(denoise_levels[1])
    r, g, b = (float(v) for v in rgb_factors)

    def apply(x):
        x = _lim(_lim(x))
        x = equalize.rgb_balance(x, strength=w_str, rgb_factor=(r, g, b))
        x = equalize.rgb_equalizer(x, method=0, strength=b_str, luma_blend_on=False)
        return torch.clamp(_unlim(_unlim(x)), 0.0, 1.0)

    return _map(clip, apply, batch_size, resolve_device(device))


def HAVC_adjust_rgb(
    clip: Clip = None, strength: float = 0.0, factor=(1.0, 1.0, 1.0),
    bias=(0, 0, 0), gamma=(1.0, 1.0, 1.0), batch_size: int = 8, device=None,
) -> Clip:
    """Per-channel gain/bias/gamma after an optional white-balance pass at
    ``strength``."""
    if clip is None:
        raise ValueError("HAVC_adjust_rgb: clip is required")

    def apply(x):
        if strength > 0:
            x = equalize.rgb_balance(x, strength=min(strength, 1.0))
        return equalize.adjust_rgb(x, factor, bias, gamma)

    return _map(clip, apply, batch_size, resolve_device(device))


def HAVC_tweak(
    clip: Clip = None, hue: float = 0, sat: float = 1, bright: float = 0,
    cont: float = 1, gamma: float = 1, batch_size: int = 8, device=None,
) -> Clip:
    """Hue, saturation, brightness, contrast and gamma tweak."""
    if clip is None:
        raise ValueError("HAVC_tweak: clip is required")
    return _map(clip, lambda x: chroma_ops.tweak(x, hue=hue, sat=sat, bright=bright, cont=cont,
                                                 gamma=gamma), batch_size, resolve_device(device))


def HAVC_TimeCube(
    clip: Clip,
    strength: float = 1.0,
    lut_effect: int | str = 0,
    factors=None,
    lut: Optional[int | str] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """3D-LUT film look: a built-in look (id or name) or a user ``.cube``
    file, the per-look (hue, sat, bright, cont, gamma) tweak, then a merge
    with the input at ``strength`` (look 8, Amber_Light, through the
    ChromaBound merge, method 7; the others a weighted merge).
    ``factors`` overrides the tweak (bright on the 0..255 scale); ``lut``
    is a legacy alias of lut_effect."""
    if lut is not None:
        lut_effect = lut
    if strength == 0:
        return clip
    if isinstance(lut_effect, str) and lut_effect.endswith(".cube"):
        table, lut_id, tweaks = lut3d.load_cube(lut_effect), -1, None
    else:
        table = lut3d.make_look_lut(lut_effect)
        lut_id = lut_effect if isinstance(lut_effect, int) else lut3d.LUT_NAMES.index(lut_effect)
        tweaks = lut3d.LUT_TWEAKS.get(lut_id)
    if factors is not None:
        tweaks = tuple(factors)
    dev = resolve_device(device)
    tbl = lut3d.lattice_on(table, dev)

    def apply(x):
        out = lut3d.apply_lut3d(x, tbl)
        if tweaks is not None:
            hue, sat, bright, cont, gamma = tweaks
            out = chroma_ops.tweak(out, hue=hue, sat=sat, bright=bright / 255.0, cont=cont,
                                   gamma=gamma)
        if strength < 1.0:
            if lut_id == 8:
                out = merge_ops.combine_models(x, out, method=7, b_weight=strength,
                                               cmc_p=(0.15, True, 25, 25))
            else:
                out = x * (1.0 - strength) + out * strength
        return out

    return _map(clip, apply, batch_size, dev)


class ClipTiles:
    """Overlapping tiles of a clip: the original clip, the tiles stacked on
    the batch axis (tile-major) and the geometry to reconstruct it."""

    def __init__(self, clip_orig: Clip, tiles_clip: Clip, meta: dict,
                 overlap_x: int, overlap_y: int):
        self.clip_orig = clip_orig
        self.tiles_clip = tiles_clip
        self.meta = meta
        self.original_width = clip_orig.width
        self.original_height = clip_orig.height
        self.base_tile_w = meta["tw"]
        self.base_tile_h = meta["th"]
        self.overlap_x = overlap_x
        self.overlap_y = overlap_y

    @property
    def tiles(self) -> list:
        """Per-tile clips in order ([tl, tr] or [tl, tr, bl, br])."""
        t = self.meta["shape"][0]
        frames = self.tiles_clip.frames
        return [self.tiles_clip.with_frames(frames[i * t:(i + 1) * t]) for i in range(len(self))]

    def with_tiles(self, tiles_clip: Clip) -> "ClipTiles":
        """The same geometry with processed tile frames."""
        return ClipTiles(self.clip_orig, tiles_clip, self.meta, self.overlap_x, self.overlap_y)

    def __len__(self):
        return len(self.meta["ys"]) * len(self.meta["xs"])


@torch.inference_mode()
def HAVC_clip_slice(
    clip: Clip, slices: int = 2, overlap_x: int = 32, overlap_y: int = 32, device=None,
) -> ClipTiles:
    """Overlapping tiles: ``slices=2`` two side by side (overlap_x only),
    ``slices=4`` a 2x2 grid.  The tiles stack on the batch axis, so the
    colorizer sees one 2x/4x larger batch."""
    if slices == 4:
        rows, cols = 2, 2
    elif slices == 2:
        rows, cols = 1, 2
    else:
        raise ValueError("HAVC_clip_slice: slices must be 2 or 4")
    c, to_host = _on(clip, resolve_device(device))
    tiles, meta = tiles_ops.slice_tiles(c.frames, rows, cols, overlap_x, overlap_y=overlap_y)
    tiles_clip = Clip(frames=profiling.host_read(tiles) if to_host else tiles, fps=clip.fps)
    return ClipTiles(clip, tiles_clip, meta, overlap_x, overlap_y if slices == 4 else 0)


@torch.inference_mode()
def HAVC_clip_reconstruct(
    clip_tiles: ClipTiles, blend_weight: float = 0.5, chroma_resize: bool = False, device=None,
) -> Clip:
    """Blend the tiles back to the original geometry with linear ramps over
    the overlaps; ``chroma_resize=True`` marries the original clip's luma to
    the blended chroma.  ``blend_weight`` is accepted for parity: the ramp
    blend is always used."""
    del blend_weight
    dev = resolve_device(device)
    clip, to_host = _on(clip_tiles.clip_orig, dev)
    rec = tiles_ops.reconstruct_tiles(clip_tiles.tiles_clip.to_device(dev).frames,
                                      clip_tiles.meta,
                                      recover_luma=clip.frames if chroma_resize else None)
    out = clip.with_frames(rec)
    return out.to_host() if to_host else out


def HAVC_recover_clip_color(
    clip: Clip = None,
    clip_color: Clip = None,
    sat: float = 0.8,
    tht: int = 30,
    strength: float = 1.0,
    alpha: float = 2.0,
    mask_weight: float = 1.0,
    chroma_resize: bool = True,
    return_mask: bool = False,
    binary_mask: bool = False,
    algo: int = 0,
    weight: Optional[float] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Restore the colors of the gray pixels of ``clip`` from
    ``clip_color`` (the ChromaRetention merge): ``strength`` is the filter
    weight, ``mask_weight`` the masked-donor blend weight,
    ``return_mask=True`` returns the gray-pixel mask.  ``weight`` is a
    deprecated alias of ``mask_weight``."""
    if clip is None or clip_color is None:
        raise ValueError("HAVC_recover_clip_color: clip and clip_color are required")
    if weight is not None:
        mask_weight = weight
    return _map2(clip, clip_color, lambda a, b: merge_ops.chroma_retention_merge(
        a, b, sat=sat, tht=tht, b_weight=strength, alpha=alpha, mask_weight=mask_weight,
        chroma_resize=chroma_resize, binary_mask=binary_mask, algo=algo,
        return_mask=return_mask), batch_size, resolve_device(device))


# --------------------------------------------------------------------------
# HAVC_main_colorizer / HAVC_main_presets / HAVC_main
# --------------------------------------------------------------------------


def _check_deepex_input(DeepExOnlyRefFrames, ScFrameDir, DeepExMethod,
                        ScThreshold, ScMinFreq, DeepExRefMerge):
    """The DeepEx argument checks of the JAX package's HAVC_main."""
    if DeepExOnlyRefFrames and ScFrameDir is None:
        raise ValueError("HAVC_main: DeepExOnlyRefFrames is enabled but ScFrameDir is unset")
    if ScFrameDir is not None and DeepExMethod != 0 and DeepExOnlyRefFrames:
        raise ValueError("HAVC_main: DeepExOnlyRefFrames is enabled but method not = 0 (HAVC)")
    if DeepExMethod not in (0, DEF_HAVC_METHOD_PLACEBO) and ScFrameDir is None:
        raise ValueError("HAVC_main: DeepExMethod != 0 but ScFrameDir is unset")
    if (DeepExMethod in (0, 1, 2, 5, 6, DEF_HAVC_METHOD_PLACEBO)
            and ScThreshold == 0 and ScMinFreq == 0):
        raise ValueError("HAVC_main: DeepExMethod in (0, 1, 2, 5, 6) but ScThreshold and "
                         "ScMinFreq are not set")
    if DeepExMethod in (2, 6) and DeepExRefMerge > 0:
        raise ValueError("HAVC_main: RefMerge cannot be used with DeepExMethod in (2, 6)")


def _frame_interpolation(clip: Clip, clip_ref: Clip, frame_interp: int = 5,
                         chroma_adjust: str = "none", process_id: int = 1, batch_size: int = 8,
                         engine_config: Optional[str] = None, device=None) -> Clip:
    """Colors between the references of ``clip_ref`` (its own flags):
    ``frame_interp`` 1-4 by Deep-Exemplar (``HAVC_deepex`` with
    ``ex_model=1``), 5-10 by ColorMNet, where ``process_id`` 1 is
    ``HAVC_deepex`` and 2 ``HAVC_cmnet2`` with the dark and smooth
    prefilters.  ``ref_freq`` is passed as the JAX package passes it, but
    only ref-merge reads it, and ref-merge is off here."""
    from .exemplar import HAVC_cmnet2, HAVC_deepex

    common = dict(clip=clip, clip_ref=clip_ref, render_speed="medium", render_vivid=True,
                  ref_merge=0, ref_thresh=0.10, encode_mode=0, max_memory_frames=0,
                  colormap=chroma_adjust, batch_size=batch_size, engine_config=engine_config,
                  device=device)
    if frame_interp < 5:
        return HAVC_deepex(method=0, only_ref_frames=False, dark=False, ex_model=1,
                           ref_norm=False, smooth=False, ref_freq=frame_interp, **common)
    common["ref_freq"] = frame_interp * 2
    if process_id == 1:
        return HAVC_deepex(method=0, only_ref_frames=False, dark=False, ex_model=0,
                           ref_norm=False, smooth=False, **common)
    return HAVC_cmnet2(dark=True, dark_p=(0.2, 0.8), ref_norm=True, smooth=True,
                       smooth_p=(0.3, 0.7, 0.9, 0.0, "none"), **common)


def _colortemp_recolor(clip: Clip, clip_colored: Clip, color_temp: int, chroma_adjust: str,
                       engine_config=None, batch_size: int = 8, device=None) -> Clip:
    """ColorTemp: the colorized clip becomes the reference at every frame,
    and the B&W clip is re-colored through ``HAVC_cmnet2`` with
    ``ref_merge=color_temp``."""
    from .exemplar import HAVC_cmnet2

    ref = clip_colored.with_sc(SceneFlags.every(clip_colored.num_frames, freq=1))
    return HAVC_cmnet2(
        clip=clip, clip_ref=ref, render_speed="medium", render_vivid=True,
        ref_merge=color_temp, dark=True, dark_p=(0.2, 0.8), ref_thresh=0.10,
        encode_mode=0, max_memory_frames=0, ref_freq=0, ref_norm=True,
        smooth=True, smooth_p=(0.3, 0.7, 0.9, 0.0, "none"),
        colormap=chroma_adjust, engine_config=engine_config,
        batch_size=batch_size, device=device,
    )


def HAVC_main_colorizer(
    clip: Clip,
    Preset: str = "Medium",
    ColorModel: str = "Video+Artistic",
    CombMethod: str = "Simple",
    VideoTune: str = "Stable",
    ColorFix: str = "Magenta/Violet",
    ColorTemp: str = "None",
    ColorTune: str = "Medium",
    ColorMap: str = "None",
    EnableDeepEx: bool = False,
    DeepExMethod: int = 0,
    DeepExPreset: str = "Medium",
    DeepExRefMerge: int = 0,
    DeepExOnlyRefFrames: bool = False,
    ScFrameDir: Optional[str] = None,
    ScThreshold: float = 0.10,
    ScThtOffset: int = 1,
    ScMinFreq: int = 0,
    ScMinInt: int = 1,
    ScThtSSIM: float = 0.0,
    ScNormalize: bool = False,
    DeepExModel: int = 0,
    DeepExVivid: bool = True,
    DeepExEncMode: int = 0,
    DeepExMaxMemFrames: int = 0,
    FrameInterp: int = 0,
    RefRange: tuple = (0, 0),
    enable_fp16: bool = True,
    debug_level: int = 0,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Main HAVC coloring function.  Classic path: HAVC_colorizer (on 2x2
    or 1x2 overlapping tiles for Placebo and VerySlow, at the tiles'
    render factor) or, with FrameInterp, HAVC_colorizer_fast; the
    ColorTemp re-color; then the speed-tier stabilizer settings (colormap
    only for the fast presets; dark + smooth + colormap + stab for the
    others).  DeepEx methods 0/1/2 (and the internal frame-interpolation
    method): HAVC_colorizer with scene detection makes the reference
    frames, HAVC_deepex propagates them, then the fast stabilizer
    settings; methods 5/6 re-color from the video ``ScFrameDir`` (cut to
    ``RefRange``) through HAVC_restore_video; methods 3/4 read the
    reference directory ``ScFrameDir`` (with DeepExModel 2, HAVC_DeepRemaster
    reads it directly).  DeepExModel picks the engine: 0 ColorMNet, 1
    Deep-Exemplar, 2 DeepRemaster, 3 the hybrid; FrameInterp 1-4 fills in
    between the sparse references with Deep-Exemplar."""
    HAVC_set_debug_level(debug_level)
    dev = resolve_device(device)

    speed_id, deoldify_rf, ddcolor_rf = presets.get_render_factors(Preset)
    ddcolor_weight = presets.get_mweight(VideoTune)
    do_model, dd_model, dd_method = presets.get_color_model(ColorModel)
    if dd_method == 2:
        dd_method = presets.get_comb_method(CombMethod)
    dd_tweak, hue_range, hue_range2, chroma_adjust, chroma_adjust2 = (
        presets.get_color_tune(ColorTune, ColorFix, ColorMap, dd_model)
    )
    stab_enabled = not DeepExOnlyRefFrames and ColorTune.lower() != "none"

    color_temp = presets.get_temp_color(ColorTemp)
    if color_temp > 0:
        ScMinFreq = 1  # references at every frame
        DeepExVivid = EnableDeepEx
    if FrameInterp > 4:
        EnableDeepEx = False  # the two do not combine

    # Placebo/VerySlow tile geometry
    slices_n = 0
    overlap_x = int(round(max(min((0.5 * clip.width) * 0.2, 192), 64)) // 2 * 2)
    overlap_y = int(round(max(min((0.5 * clip.height) * 0.2, 108), 64)) // 2 * 2)
    deoldify_rf_n = min(max(math.trunc((0.5 * clip.width + overlap_x) / 16), 22), 32)
    ddcolor_rf_n = deoldify_rf_n
    if speed_id in (0, 1):
        slices_n = 4 if speed_id == 0 else 2

    clip, to_host = _on(clip, dev)

    def _colorize(c, do_rf, dd_rf, **sc):
        return HAVC_colorizer(
            c, method=dd_method, mweight=ddcolor_weight,
            deoldify_p=(do_model, do_rf, 1.0, 0.0),
            ddcolor_p=(dd_model, dd_rf, 1.0, 0.0, enable_fp16),
            ddtweak=tuple(dd_tweak), ddtweak_p=(DEF_TWEAK_p, hue_range),
            batch_size=batch_size, device=dev, **sc,
        )

    def _colorize_fast(c, do_rf, dd_rf):
        return HAVC_colorizer_fast(
            c, method=dd_method, mweight=ddcolor_weight,
            deoldify_p=(do_model, do_rf, 1.0, 0.0),
            ddcolor_p=(dd_model, dd_rf, 1.0, 0.0, enable_fp16),
            ddtweak=tuple(dd_tweak), ddtweak_p=(DEF_TWEAK_p, hue_range),
            frame_interp=FrameInterp, chroma_adjust=chroma_adjust, debug_level=debug_level,
            engine_config=engine_config, batch_size=batch_size, device=dev,
        )

    def _recolor(colored):
        with stage_timer("color_temp"):
            return _colortemp_recolor(clip, colored, color_temp, chroma_adjust, engine_config,
                                      batch_size, device=dev)

    if EnableDeepEx and DeepExMethod in (0, 1, 2, 5, 6, DEF_HAVC_METHOD_PLACEBO):
        from .exemplar import HAVC_deepex, HAVC_restore_video

        _check_deepex_input(DeepExOnlyRefFrames, ScFrameDir, DeepExMethod,
                            ScThreshold, ScMinFreq, DeepExRefMerge)
        ref_freq = ScMinFreq if ScMinFreq > 1 else 0
        if DeepExRefMerge > 0:
            ScMinFreq = 1
        ref_tresh = ScThreshold if ScThreshold is not None and 0 < ScThreshold < 1 else 0.10

        if DeepExMethod in (5, 6):  # an external colored video
            from .io.video import read_video

            clip_ref = read_video(ScFrameDir, device=dev)
            clip_s, clip_e = RefRange
            if clip_e > 0 and 0 <= clip_s <= clip_e:
                clip_ref = clip_ref[clip_s:clip_e]
            clip_colored = HAVC_restore_video(
                clip, clip_ref, method=DeepExMethod, render_speed=DeepExPreset,
                ex_model=DeepExModel, ref_merge=DeepExRefMerge, ref_thresh=ref_tresh,
                ref_freq=ref_freq, max_memory_frames=DeepExMaxMemFrames,
                render_vivid=DeepExVivid, encode_mode=DeepExEncMode, ref_norm=ScNormalize,
                engine_config=engine_config, batch_size=batch_size, device=dev,
            )
        else:  # HAVC references (and the internal frame-interpolation method)
            if FrameInterp == 0 or DeepExRefMerge == 0:
                clip_ref = _colorize(
                    clip, deoldify_rf, ddcolor_rf, sc_threshold=ScThreshold,
                    sc_tht_offset=ScThtOffset, sc_min_freq=ScMinFreq, sc_min_int=ScMinInt,
                    sc_tht_ssim=ScThtSSIM, sc_normalize=ScNormalize,
                )
            else:
                clip_ref = _colorize_fast(clip, deoldify_rf, ddcolor_rf)
            if color_temp > 0:
                clip_ref = _recolor(clip_ref)
            if DeepExMethod == DEF_HAVC_METHOD_PLACEBO:
                clip_colored = clip_ref
            else:
                clip_colored = HAVC_deepex(
                    clip=clip, clip_ref=clip_ref, method=DeepExMethod,
                    render_speed=DeepExPreset, render_vivid=DeepExVivid,
                    ref_merge=DeepExRefMerge, sc_framedir=ScFrameDir,
                    only_ref_frames=DeepExOnlyRefFrames, dark=True, dark_p=(0.2, 0.8),
                    ref_thresh=ref_tresh, ex_model=DeepExModel, encode_mode=DeepExEncMode,
                    max_memory_frames=DeepExMaxMemFrames, ref_freq=ScMinFreq,
                    ref_norm=ScNormalize, smooth=True, smooth_p=(0.3, 0.7, 0.9, 0.0, "none"),
                    colormap=chroma_adjust, engine_config=engine_config,
                    batch_size=batch_size, device=dev,
                )
        if DeepExMethod != DEF_HAVC_METHOD_PLACEBO:  # the faster stabilizer settings
            clip_colored = HAVC_stabilizer(
                clip_colored, stab=stab_enabled, stab_p=(3, "A", 1, 0, 0, 0),
                colormap=chroma_adjust2, render_factor=min(deoldify_rf, ddcolor_rf),
                batch_size=batch_size, device=dev,
            )
        return clip_colored.to_host() if to_host else clip_colored

    if EnableDeepEx and DeepExMethod in (3, 4):  # a reference directory
        from .exemplar import HAVC_DeepRemaster, HAVC_deepex

        if DeepExModel == 2:  # DeepRemaster reads the folder directly
            out = HAVC_DeepRemaster(clip, render_vivid=DeepExVivid, ref_dir=ScFrameDir,
                                    ref_buffer_size=DeepExMaxMemFrames or 20, mode=0, device=dev)
            return out.to_host() if to_host else out
        out = HAVC_deepex(
            clip=clip, clip_ref=None, method=DeepExMethod, render_speed=DeepExPreset,
            render_vivid=DeepExVivid, sc_framedir=ScFrameDir,
            ref_merge=0 if DeepExModel != 3 else DeepExRefMerge,
            only_ref_frames=DeepExOnlyRefFrames, dark=True, dark_p=(0.2, 0.8), smooth=True,
            smooth_p=(0.3, 0.7, 0.9, 0.0, "none"), ex_model=DeepExModel,
            encode_mode=DeepExEncMode, max_memory_frames=DeepExMaxMemFrames,
            colormap=chroma_adjust, engine_config=engine_config, batch_size=batch_size,
            device=dev,
        )
        return out.to_host() if to_host else out

    # the classic path colorizes every frame (every FrameInterp-th with it):
    # ScThreshold only gates the DeepEx reference frames
    colorize = _colorize if FrameInterp == 0 else _colorize_fast
    if slices_n == 0:
        clip_colored = colorize(clip, deoldify_rf, ddcolor_rf)
    else:
        with stage_timer("tiles"):
            ct = HAVC_clip_slice(clip, slices=slices_n, overlap_x=overlap_x,
                                 overlap_y=overlap_y, device=dev)
        tiles_colored = colorize(ct.tiles_clip, deoldify_rf_n, ddcolor_rf_n)
        with stage_timer("tiles"):
            clip_colored = HAVC_clip_reconstruct(ct.with_tiles(tiles_colored),
                                                 chroma_resize=True, device=dev)
    if color_temp > 0:
        clip_colored = _recolor(clip_colored)

    rf = min(deoldify_rf, ddcolor_rf)
    if speed_id > 4:  # fast / faster / veryfast: colormap only
        clip_colored = HAVC_stabilizer(
            clip_colored, colormap=chroma_adjust, render_factor=rf,
            batch_size=batch_size, device=dev,
        )
    elif speed_id > 1:  # slower / slow / medium
        clip_colored = HAVC_stabilizer(
            clip_colored, dark=True, dark_p=(0.2, 0.8),
            colormap=chroma_adjust, smooth=True,
            smooth_p=(0.3, 0.7, 0.9, 0.0, "none"),
            stab=(stab_enabled and dd_method != 0),
            stab_p=(5, "A", 1, 15, 0.2, 0.8), render_factor=rf,
            batch_size=batch_size, device=dev,
        )
    else:  # placebo / veryslow: every filter (stab_p carries hue_range2, unread)
        clip_colored = HAVC_stabilizer(
            clip_colored, dark=True, dark_p=(0.2, 0.8),
            colormap=chroma_adjust, smooth=True,
            smooth_p=(0.3, 0.7, 0.9, 0.0, "none"), stab=stab_enabled,
            stab_p=(5, "A", 1, 15, 0.2, 0.8, hue_range2), render_factor=rf,
            batch_size=batch_size, device=dev,
        )
    return clip_colored.to_host() if to_host else clip_colored


def HAVC_main_presets(
    clip: Clip,
    Preset: str = "Medium",
    FrameInterp: int = 0,
    ColorModel: str = "Video+Artistic",
    CombMethod: str = "Simple",
    VideoTune: str = "Stable",
    ColorFix: str = "Magenta/Violet",
    ColorTune: str = "Light",
    ColorMap: str = "None",
    ColorTemp: str = "None",
    BlackWhiteTune: str = "None",
    BlackWhiteMode: int = 0,
    BlackWhiteBlend: bool = True,
    EnableDeepEx: bool = False,
    DeepExMethod: int = 0,
    DeepExPreset: str = "Medium",
    DeepExRefMerge: int = 0,
    DeepExOnlyRefFrames: bool = False,
    ScFrameDir: Optional[str] = None,
    ScThreshold: float = 0.10,
    ScThtOffset: int = 1,
    ScMinFreq: int = 0,
    ScMinInt: int = 1,
    ScThtSSIM: float = 0.0,
    ScNormalize: bool = False,
    DeepExModel: int = 0,
    DeepExVivid: bool = True,
    DeepExEncMode: int = 0,
    DeepExMaxMemFrames: int = 0,
    RefRange: tuple = (0, 0),
    enable_fp16: bool = True,
    debug_level: int = 0,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    lut: Optional[int] = None,
    deflicker: bool = False,
    device=None,
) -> Clip:
    """Preset pipeline: BlackWhiteMode 6 runs the MSRCP retinex as a
    pre-pass on the B&W input (and the post-pass becomes Light CLAHE);
    HAVC_main_colorizer with every knob forwarded; the BlackWhiteTune
    post-pass; ColorFix Retinex/Red applies the film LUT its ColorTune
    selects; ``lut`` applies one more HAVC_TimeCube look; deflicker when
    DeepEx, ColorTemp or a retinex ran, or ``deflicker`` asks for it."""
    HAVC_set_debug_level(debug_level)
    dev = resolve_device(device)
    presets.get_render_factors(Preset)

    EnableRetinex = (ColorTune.lower() != "none"
                     and ColorFix.lower() == "retinex/red")
    BWTuneRetinex = BlackWhiteTune.lower() != "none" and BlackWhiteMode == 6
    DeFlicker = (EnableDeepEx or ColorTemp.lower() != "none"
                 or EnableRetinex or BWTuneRetinex or deflicker)

    clip, to_host = _on(clip, dev)
    work = clip
    if BWTuneRetinex:
        with stage_timer("bw_pre_tune"):
            work = HAVC_bw_tune(work, BlackWhiteTune, bw_method=5, luma_blend=BlackWhiteBlend,
                                batch_size=batch_size, device=dev)
        BlackWhiteTune, BlackWhiteMode, BlackWhiteBlend = "light", 0, True

    # no span around the colorizer: its stages are the top-level spans
    clip_colored = HAVC_main_colorizer(
        work, Preset, ColorModel, CombMethod, VideoTune, ColorFix,
        ColorTemp, ColorTune, ColorMap, EnableDeepEx, DeepExMethod,
        DeepExPreset, DeepExRefMerge, DeepExOnlyRefFrames, ScFrameDir,
        ScThreshold, ScThtOffset, ScMinFreq, ScMinInt, ScThtSSIM,
        ScNormalize, DeepExModel, DeepExVivid, DeepExEncMode,
        DeepExMaxMemFrames, FrameInterp, RefRange, enable_fp16,
        debug_level, engine_config, batch_size, device=dev,
    )

    if BWTuneRetinex:
        with stage_timer("retinex_tweak"):
            clip_colored = HAVC_tweak(clip_colored, hue=5.0, sat=0.95, bright=0, cont=0.98,
                                      gamma=0.98, batch_size=batch_size, device=dev)

    if BlackWhiteTune.lower() != "none":
        with stage_timer("bw_post_tune"):
            clip_colored = HAVC_bw_tune(clip_colored, BlackWhiteTune, BlackWhiteMode,
                                        BlackWhiteBlend, batch_size=batch_size, device=dev)

    clip_final = clip_colored
    if EnableRetinex:
        tune = ColorTune.lower()
        look = None
        if tune == "light":
            look = (0.8, "exploration")
        elif tune == "medium":
            look = (0.6, "city_skyline")
        elif tune == "strong":
            look = (0.4, "amber_light") if ColorMap.lower() == "red->brown" else (0.6, "fuj_film")
        if look is not None:
            with stage_timer("retinex_lut"):
                clip_final = HAVC_TimeCube(clip_colored, look[0], lut3d.LUT_NAMES.index(look[1]),
                                           batch_size=batch_size, device=dev)

    if lut is not None:
        with stage_timer("lut_effect"):
            clip_final = HAVC_TimeCube(clip_final, lut_effect=lut, batch_size=batch_size,
                                       device=dev)

    if DeFlicker:
        with stage_timer("deflicker"), torch.inference_mode():
            sc = clip_final.sc.sc_prev if clip_final.sc is not None else None
            clip_final = clip_final.with_frames(
                temporal_ops.reduce_flicker(clip_final.frames, scenechange=sc))
    return clip_final.to_host() if to_host else clip_final


def HAVC_veryslow_preset(
    clip: Clip,
    Preset: str = "Slower",
    FrameInterp: int = 0,
    ColorModel: str = "Video+Artistic",
    CombMethod: str = "Simple",
    VideoTune: str = "Stable",
    ColorFix: str = "Magenta/Violet",
    ColorTune: str = "Light",
    ColorMap: str = "None",
    ColorTemp: str = "None",
    BlackWhiteTune: str = "None",
    BlackWhiteMode: int = 0,
    BlackWhiteBlend: bool = True,
    EnableDeepEx: bool = False,
    DeepExMethod: int = 0,
    ScThreshold: float = 0.1,
    ScMinFreq: int = 0,
    RefRange: tuple = (0, 0),
    enable_fp16: bool = True,
    debug_level: int = 0,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """VerySlow dual pass: the color model split in two; the DeOldify half
    colorizes a hard-darkened clip (then a Medium ScaleAbs BW tune with its
    film LUT, and sat 0.95 / hue 5), the DDColor or Zhang half a lightly
    darkened one; both merged on the clip's luma at the VideoTune weight
    with the CombMethod; then the ColorTemp re-color, or with FrameInterp
    the passes make sparse references (the internal frame-interpolation
    DeepEx method) and ColorMNet fills in between; then the BlackWhiteTune
    adjust with a hue 10 / sat 1.05 / cont 0.90 tweak, blended 40/60 with
    the merge."""
    dev = resolve_device(device)
    do_name, dd_name = presets.split_color_model(ColorModel)
    clip, to_host = _on(clip, dev)
    color_temp = presets.get_temp_color(ColorTemp)
    interp = FrameInterp > 0
    # the references' spacing: every n-th frame for DeepEx, every 2n-th for ColorMNet
    extra = (dict(EnableDeepEx=True, DeepExMethod=DEF_HAVC_METHOD_PLACEBO, ScThreshold=0.1,
                  ScMinFreq=FrameInterp if FrameInterp < 5 else FrameInterp * 2)
             if interp else dict(EnableDeepEx=EnableDeepEx, DeepExMethod=DeepExMethod,
                                 ScThreshold=ScThreshold, ScMinFreq=ScMinFreq))

    def _pass(dark_gamma, dark_cont, model, cf, ctune, cmap):
        dark = HAVC_tweak(clip, bright=-1 / 255.0, gamma=dark_gamma, cont=dark_cont,
                          batch_size=batch_size, device=dev)
        return HAVC_main_presets(
            dark, Preset=Preset, ColorModel=model, ColorTemp="none", ColorFix=cf,
            ColorTune=ctune, ColorMap=cmap, BlackWhiteTune="light", BlackWhiteMode=0,
            BlackWhiteBlend=True, FrameInterp=0, RefRange=RefRange, enable_fp16=enable_fp16,
            debug_level=debug_level, engine_config=engine_config, batch_size=batch_size,
            device=dev, **extra,
        )

    clip1 = clip2 = None
    if do_name != "none":
        with stage_timer("pass_deoldify"):
            clip1 = _pass(0.90, 0.80, do_name, "none", "medium", "none")
            clip1 = HAVC_ColorAdjust(clip1, BlackWhiteTune="medium", BlackWhiteMode=4,
                                     BlackWhiteBlend=True, ReColor=False, chroma_resize=True,
                                     batch_size=batch_size, device=dev)
            clip1 = HAVC_tweak(clip1, sat=0.95, hue=5, batch_size=batch_size, device=dev)
    if dd_name != "none":
        with stage_timer("pass_ddcolor"):
            clip2 = _pass(0.95, 0.95, dd_name, ColorFix, ColorTune, ColorMap)

    with stage_timer("veryslow_merge"):
        if clip1 is None:
            clip_colored = HAVC_merge(clipa=clip2, clip_luma=clip, method=0,
                                      batch_size=batch_size, device=dev)
        elif clip2 is None:
            clip_colored = HAVC_merge(clipa=clip1, clip_luma=clip, method=0,
                                      batch_size=batch_size, device=dev)
        else:
            clip_colored = HAVC_merge(
                clipa=clip1, clipb=clip2, clip_luma=clip,
                weight=presets.get_mweight(VideoTune),
                method=presets.get_comb_method(CombMethod), batch_size=batch_size, device=dev,
            )
    if interp:
        with stage_timer("frame_interp"):
            ref = clip_colored.with_sc(SceneFlags.every(clip_colored.num_frames,
                                                        freq=extra["ScMinFreq"]))
            clip_colored = _frame_interpolation(
                clip, ref, FrameInterp, chroma_adjust="300:360|0.8,0.1", process_id=2,
                batch_size=batch_size, engine_config=engine_config, device=dev)
    elif color_temp > 0:
        with stage_timer("color_temp"):
            clip_colored = _colortemp_recolor(clip, clip_colored, color_temp,
                                              "300:360|0.8,0.1", engine_config, batch_size,
                                              device=dev)
    with stage_timer("veryslow_adjust"):
        clip_adjusted = HAVC_ColorAdjust(
            clip_colored, BlackWhiteTune=BlackWhiteTune, BlackWhiteMode=BlackWhiteMode,
            BlackWhiteBlend=BlackWhiteBlend, ReColor=False, batch_size=batch_size, device=dev,
        )
        clip_adjusted = HAVC_tweak(clip_adjusted, hue=10, sat=1.05, cont=0.90,
                                   batch_size=batch_size, device=dev)
        out = HAVC_merge(clipa=clip_adjusted, clipb=clip_colored, weight=0.4, method=2,
                         batch_size=batch_size, device=dev)
    return out.to_host() if to_host else out


def HAVC_placebo_preset(
    clip: Clip,
    CombMethod: str = "Simple",
    VideoTune: str = "Stable",
    ColorModel: str = "Video+Artistic",
    ColorFix: str = "Magenta/Violet",
    ColorTune: str = "Light",
    ColorMap: str = "None",
    ColorTemp: str = "None",
    FrameInterp: int = 0,
    BlackWhiteTune: str = "None",
    BlackWhiteMode: int = 0,
    BlackWhiteBlend: bool = True,
    RefRange: tuple = (0, 0),
    enable_fp16: bool = True,
    debug_level: int = 0,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Placebo: HAVC_main_presets at Preset 'placebo' (2x2 tiles inside
    HAVC_main_colorizer), then the ColorTemp re-color; with FrameInterp the
    untiled colorizer makes references every n-th frame (the internal
    frame-interpolation DeepEx method) and ColorMNet fills in between."""
    dev = resolve_device(device)
    kw = dict(
        ColorModel=ColorModel, CombMethod=CombMethod, VideoTune=VideoTune,
        ColorFix=ColorFix, ColorTune=ColorTune, ColorMap=ColorMap, ColorTemp="none",
        BlackWhiteTune=BlackWhiteTune, BlackWhiteMode=BlackWhiteMode,
        BlackWhiteBlend=BlackWhiteBlend, RefRange=RefRange, enable_fp16=enable_fp16,
        debug_level=debug_level, engine_config=engine_config, batch_size=batch_size,
        device=dev,
    )
    clip, to_host = _on(clip, dev)
    if FrameInterp == 0:
        out = HAVC_main_presets(clip, "placebo", 0, **kw)
        color_temp = presets.get_temp_color(ColorTemp)
        if color_temp > 0:
            with stage_timer("color_temp"):
                out = _colortemp_recolor(clip, out, color_temp, "300:360|0.8,0.1",
                                         engine_config, batch_size, device=dev)
        return out.to_host() if to_host else out
    # the references' spacing: every n-th frame for DeepEx, every 2n-th for ColorMNet
    ref_freq = FrameInterp if FrameInterp < 5 else FrameInterp * 2
    clip_colored = HAVC_main_presets(clip, "placebo", 0, EnableDeepEx=True,
                                     DeepExMethod=DEF_HAVC_METHOD_PLACEBO, ScThreshold=0.1,
                                     ScMinFreq=ref_freq, **kw)
    with stage_timer("frame_interp"):
        ref = clip_colored.with_sc(SceneFlags.every(clip_colored.num_frames, freq=ref_freq))
        out = _frame_interpolation(clip, ref, FrameInterp, chroma_adjust="300:360|0.8,0.1",
                                   process_id=2, batch_size=batch_size,
                                   engine_config=engine_config, device=dev)
    return out.to_host() if to_host else out


def HAVC_main(
    clip: Clip,
    Preset: str = "Medium",
    FrameInterp: int = 0,
    ColorModel: str = "Video+Artistic",
    CombMethod: str = "Simple",
    VideoTune: str = "Stable",
    ColorFix: str = "Magenta/Violet",
    ColorTune: str = "Light",
    ColorMap: str = "None",
    ColorTemp: str = "None",
    BlackWhiteTune: str = "None",
    BlackWhiteMode: int = 0,
    BlackWhiteBlend: bool = True,
    EnableDeepEx: bool = False,
    DeepExMethod: int = 0,
    DeepExPreset: str = "Medium",
    DeepExRefMerge: int = 0,
    DeepExOnlyRefFrames: bool = False,
    ScFrameDir: Optional[str] = None,
    ScThreshold: float = 0.10,
    ScThtOffset: int = 1,
    ScMinFreq: int = 0,
    ScMinInt: int = 1,
    ScThtSSIM: float = 0.0,
    ScNormalize: bool = False,
    DeepExModel: int = 0,
    DeepExVivid: bool = True,
    DeepExEncMode: int = 0,
    DeepExMaxMemFrames: int = 0,
    RefRange: tuple = (0, 0),
    enable_fp16: bool = True,
    debug_level: int = 0,
    BWTune: Optional[str] = None,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Top-level entry, same names and defaults as the JAX package's.
    Placebo runs HAVC_placebo_preset (tiled), VerySlow HAVC_veryslow_preset
    (two passes at 'Slower', DeepEx off), the others HAVC_main_presets.
    ``BWTune`` is a legacy alias of BlackWhiteTune.  Each call is counted
    in the ``clips`` counter; at ``debug_level`` 1 and above it logs its
    stages (``HAVC_set_debug_level``)."""
    if BWTune is not None:
        BlackWhiteTune = BWTune
    HAVC_set_debug_level(debug_level)
    dev = resolve_device(device)

    speed_id, _, _ = presets.get_render_factors(Preset)
    with profiling.clip_scope() as call:
        if speed_id == 0:
            out = HAVC_placebo_preset(
                clip, CombMethod, VideoTune, ColorModel, ColorFix, ColorTune,
                ColorMap, ColorTemp, FrameInterp, BlackWhiteTune,
                BlackWhiteMode, BlackWhiteBlend, RefRange, enable_fp16,
                debug_level, engine_config=engine_config, batch_size=batch_size, device=dev,
            )
        elif speed_id == 1:
            out = HAVC_veryslow_preset(
                clip, "slower", FrameInterp, ColorModel, CombMethod, VideoTune,
                ColorFix, ColorTune, ColorMap, ColorTemp, BlackWhiteTune,
                BlackWhiteMode, BlackWhiteBlend, EnableDeepEx=False,
                RefRange=RefRange, enable_fp16=enable_fp16, debug_level=debug_level,
                engine_config=engine_config, batch_size=batch_size, device=dev,
            )
        else:
            out = HAVC_main_presets(
                clip, Preset, FrameInterp, ColorModel, CombMethod, VideoTune,
                ColorFix, ColorTune, ColorMap, ColorTemp, BlackWhiteTune,
                BlackWhiteMode, BlackWhiteBlend, EnableDeepEx, DeepExMethod,
                DeepExPreset, DeepExRefMerge, DeepExOnlyRefFrames, ScFrameDir,
                ScThreshold, ScThtOffset, ScMinFreq, ScMinInt, ScThtSSIM,
                ScNormalize, DeepExModel, DeepExVivid, DeepExEncMode,
                DeepExMaxMemFrames, RefRange, enable_fp16, debug_level,
                engine_config, batch_size, device=dev,
            )
    if _DEBUG_LEVEL[0] >= 1:
        HAVC_LogMessage(MessageType.INFORMATION,
                        f"HAVC_main call {call}:\n{profiling.stage_report(clip=call)}")
    return out



# --------------------------------------------------------------------------
# HAVC_main_restore / HAVC_ColorAdjust
# --------------------------------------------------------------------------


def HAVC_main_restore(
    clip: Clip,
    clip_colored: Optional[Clip] = None,
    DeepExPreset: str = "medium",
    DeepExModel: int = 0,
    DeepExRefMerge: int = 0,
    ScThreshold: float = 0.10,
    ScMinFreq: int = 0,
    ScNormalize: bool = False,
    DeepExMaxMemFrames: int = 0,
    DeepExMethod: int = 5,
    DeepExVivid: bool = True,
    DeepExEncMode: int = 0,
    BlackWhiteTune: str = "Medium",
    BlackWhiteMode: int = 0,
    BlackWhiteBlend: bool = True,
    chroma_resize: bool = False,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Main HAVC restoring function: with ``clip_colored``, the exemplar
    re-color from it (``HAVC_restore_video``; BlackWhiteMode 6 runs the
    MSRCP retinex on the B&W clip first) and a light RGB adjust and tweak;
    without, the BW tune with the per-mode hue/sat/bright/cont/gamma tweak
    tables."""
    del chroma_resize  # the stages already run at chroma resolution
    BWTuneRetinex = BlackWhiteTune.lower() != "none" and BlackWhiteMode == 6
    if clip_colored is not None:
        from .exemplar import HAVC_restore_video

        dev = resolve_device(device)
        work = clip
        if BWTuneRetinex:
            work = HAVC_bw_tune(work, BlackWhiteTune, bw_method=5, luma_blend=BlackWhiteBlend,
                                batch_size=batch_size, device=dev)
            BlackWhiteTune, BlackWhiteMode = "none", 5
        out = HAVC_restore_video(
            work, clip_colored, method=DeepExMethod, render_speed=DeepExPreset,
            ex_model=DeepExModel, ref_merge=DeepExRefMerge, ref_thresh=ScThreshold,
            ref_freq=ScMinFreq, max_memory_frames=DeepExMaxMemFrames,
            render_vivid=DeepExVivid, encode_mode=DeepExEncMode, ref_norm=ScNormalize,
            engine_config=engine_config, batch_size=batch_size, device=dev,
        )
        if BWTuneRetinex:
            return HAVC_tweak(out, hue=5.0, sat=0.95, bright=0, cont=0.98, gamma=0.98,
                              batch_size=batch_size, device=dev)
        if BlackWhiteTune.lower() != "none":
            out = HAVC_adjust_rgb(out, strength=0.5, gamma=(1.0, 1.0, 0.98),
                                  batch_size=batch_size, device=dev)
            return HAVC_tweak(out, hue=5, sat=1.05, bright=0, cont=1.0, batch_size=batch_size,
                              device=dev)
        return out

    if BlackWhiteTune.lower() == "none":
        return clip
    dev = resolve_device(device)
    BlackWhiteMode = min(BlackWhiteMode, 5)
    i = BlackWhiteMode
    cont = [1.0, 0.95, 1.0, 0.95, 0.95, 0.90]
    hue = [-10.0, -10.0, -10.0, -10.0, -10.0, -5.0]
    sat = [1.10, 1.05, 1.10, 1.10, 0.95, 0.95]
    bright = [0.0, 0.0, 0.0, 0.0, 0.0, -1.0]
    if BlackWhiteTune.lower() == "light":
        gamma = [1.0, 0.98, 0.98, 0.98, 0.98, 0.98]
    else:
        gamma = [1.0, 0.95, 0.95, 0.95, 0.95, 0.95]
    out = HAVC_bw_tune(clip, BlackWhiteTune, i, BlackWhiteBlend, True, batch_size=batch_size,
                       device=dev)
    if BlackWhiteMode < 4:  # not after ScaleAbs / Retinex
        out = HAVC_tweak(out, hue[i], sat[i], bright[i] / 255.0, cont[i], gamma[i],
                         batch_size=batch_size, device=dev)
    return out


def HAVC_ColorAdjust(
    clip: Clip,
    BlackWhiteTune: str = "Light",
    BlackWhiteMode: int = 0,
    BlackWhiteBlend: bool = True,
    ReColor: bool = True,
    Strength: int = 0,
    ScThreshold: float = 0.10,
    ScNormalize: bool = True,
    DeepExVivid: bool = True,
    ScMinFreq: int = 0,
    chroma_resize: bool = False,
    clip_ref: Optional[Clip] = None,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """HAVC color post-processing: ``ReColor`` re-colors the clip by
    ColorMNet from itself (or from ``clip_ref``) at references on every
    frame, with ref-merge ``DeepExRefMerge = 1 + (4 - Strength)``;
    otherwise the BlackWhiteTune through HAVC_main_restore; and for
    BlackWhiteMode 4/6 the ColorTune film-LUT remap."""
    DeepExRefMerge = 1 + min(max(4 - Strength, 0), 4)
    if BlackWhiteTune.lower() == "none" and not ReColor and clip_ref is None:
        return clip
    dev = resolve_device(device)
    clip_colored = None
    if ReColor or clip_ref is not None:
        clip_colored = clip_ref if clip_ref is not None else clip
        clip_colored = clip_colored.with_sc(SceneFlags.every(clip_colored.num_frames, freq=1))
    tn_id = presets.get_tune_id(BlackWhiteTune)
    remap = tn_id != 0 and BlackWhiteMode in (4, 6)
    bw_tune, bw_mode = ("none", 4) if remap else (BlackWhiteTune, BlackWhiteMode)
    out = HAVC_main_restore(
        clip, clip_colored, "medium", 0, DeepExRefMerge, ScThreshold, ScMinFreq,
        ScNormalize, 0, 5, DeepExVivid, 0, BlackWhiteTune=bw_tune, BlackWhiteMode=bw_mode,
        BlackWhiteBlend=BlackWhiteBlend, chroma_resize=chroma_resize,
        engine_config=engine_config, batch_size=batch_size, device=dev,
    )
    if remap:
        lut_map = {
            (4, 1): (0.8, "exploration"), (4, 2): (0.6, "city_skyline"),
            (4, 3): (0.5, "amber_light"), (6, 1): (0.6, "fuj_film"),
            (6, 2): (0.7, "flat_pop"), (6, 3): (0.5, "warm_haze"),
        }
        strength, name = lut_map[(BlackWhiteMode, tn_id)]
        out = HAVC_TimeCube(out, strength, lut3d.LUT_NAMES.index(name), batch_size=batch_size,
                            device=dev)
    return out


# --------------------------------------------------------------------------
# HAVC_colorizer_fast / HAVC_restore_video / HAVC_read_video
# --------------------------------------------------------------------------


def HAVC_colorizer_fast(
    clip: Clip,
    method: int = 2,
    mweight: float = 0.4,
    deoldify_p=(0, 24, 1.0, 0.0),
    ddcolor_p=(1, 24, 1.0, 0.0, True),
    ddtweak=(False, False, False),
    ddtweak_p=(DEF_TWEAK_p, "300:360|0.8,0.1"),
    frame_interp: int = 5,
    chroma_adjust: str = "none",
    debug_level: int = 0,
    sc_min_freq: Optional[int] = None,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Fast colorizer: the classic engines colorize only the scene changes
    and every ``frame_interp``-th frame (``sc_threshold`` 0.1,
    ``sc_min_freq=frame_interp``), and ColorMNet propagates their colors
    in between (``frame_interp`` 5-10) or Deep-Exemplar (1-4).
    ``sc_min_freq`` is a legacy alias of ``frame_interp``;
    ``engine_config`` sizes the ColorMNet engine."""
    if sc_min_freq is not None:
        frame_interp = sc_min_freq
    HAVC_set_debug_level(debug_level)
    if frame_interp not in range(1, 11):
        raise ValueError("HAVC_colorizer_fast: frame_interp must be in range [1-10]")
    dev = resolve_device(device)
    clip, to_host = _on(clip, dev)
    ref = HAVC_colorizer(
        clip, method=method, mweight=mweight, deoldify_p=deoldify_p,
        ddcolor_p=ddcolor_p, ddtweak=ddtweak, ddtweak_p=ddtweak_p,
        sc_threshold=0.1, sc_tht_offset=1, sc_min_freq=frame_interp,
        sc_min_int=1, sc_tht_ssim=0.0, sc_normalize=False,
        batch_size=batch_size, device=dev,
    )
    with stage_timer("frame_interp"):
        out = _frame_interpolation(clip, ref, frame_interp, chroma_adjust, process_id=1,
                                   batch_size=batch_size, engine_config=engine_config,
                                   device=dev)
    return out.to_host() if to_host else out


def HAVC_restore_video(*args, **kwargs):
    """Re-export of ``exemplar.HAVC_restore_video``."""
    from .exemplar import HAVC_restore_video as _restore

    return _restore(*args, **kwargs)


def HAVC_DeepRemaster(*args, **kwargs):
    """Re-export of ``exemplar.HAVC_DeepRemaster``."""
    from .exemplar import HAVC_DeepRemaster as _remaster

    return _remaster(*args, **kwargs)


def HAVC_deepex(*args, **kwargs):
    """Re-export of ``exemplar.HAVC_deepex``."""
    from .exemplar import HAVC_deepex as _deepex

    return _deepex(*args, **kwargs)


def HAVC_cmnet2(*args, **kwargs):
    """Re-export of ``exemplar.HAVC_cmnet2``."""
    from .exemplar import HAVC_cmnet2 as _cmnet2

    return _cmnet2(*args, **kwargs)


def HAVC_read_video(
    source: str = None,
    fpsnum: int = 0,
    fpsden: int = 1,
    width: int = 0,
    height: int = 0,
    return_rgb: bool = True,
    path: Optional[str] = None,
    device=None,
    **kwargs,
) -> Clip:
    """Decode a video file into a clip of float RGB [0, 1] frames on
    ``device`` (uploaded as bytes); ``width``/``height`` > 0 resize it
    there with Spline36 (either alone keeps the other dimension);
    ``fpsnum/fpsden`` forces the frame rate.  ``return_rgb=False`` is
    accepted and the frames are RGB all the same; ``path`` is a deprecated
    alias of ``source``; ``kwargs`` go to ``io.read_video`` (``start``,
    ``count``)."""
    from .io.video import read_video

    if source is None:
        source = path
    if source is None:
        raise ValueError("HAVC_read_video: source is required")
    if not os.path.isfile(source):
        raise IOError(f"HAVC: invalid clip -> {source}")
    del return_rgb
    dev = resolve_device(device)
    fps_force = fpsnum / fpsden if fpsnum > 0 else None
    clip = read_video(source, fps_force=fps_force, device=dev, **kwargs)
    w = width if width > 0 else (clip.width if height > 0 else 0)
    h = height if height > 0 else (clip.height if width > 0 else 0)
    if w > 0 and h > 0 and (w != clip.width or h != clip.height):
        with torch.inference_mode():
            clip = clip.map_batches(lambda x: torch.clamp(resize(x, h, w, "spline36"), 0.0, 1.0))
    return clip


# --------------------------------------------------------------------------
# scene detection and reference-frame export
# --------------------------------------------------------------------------


def HAVC_SceneDetect(
    clip: Clip,
    sc_threshold: float = 0.10,
    sc_tht_offset: int = 1,
    sc_tht_ssim: float = 0.0,
    sc_min_int: int = 1,
    sc_min_freq: int = 0,
    sc_normalize: bool = False,
    sc_tht_white: float = 0.70,
    sc_tht_black: float = 0.10,
    sc_debug: bool = False,
    device=None,
) -> Clip:
    """The clip with its scene-change flags (``scene.detect``; the frames
    are reduced on ``device`` and stay as they were).  ``sc_debug=True``
    logs every New/Skip decision with its SSIM, histogram, luma and
    reason."""
    dev = resolve_device(device)
    flags = scene_detect(
        clip.frames, threshold=sc_threshold, frequency=sc_min_freq, sc_tht_filter=sc_tht_ssim,
        min_length=sc_min_int, tht_white=sc_tht_white, tht_black=sc_tht_black,
        tht_offset=sc_tht_offset, normalize=sc_normalize, debug=sc_debug, device=dev,
    )
    return clip.with_sc(flags)


def HAVC_SceneDetectEdges(
    clip: Clip,
    sc_threshold: float = 0.035,
    sc_tht_offset: int = 2,
    sc_tht_ssim: float = 0.80,
    sc_min_int: int = 20,
    sc_mult_tht: int = 15,
    sc_tht_white: float = 0.70,
    sc_tht_black: float = 0.10,
    sc_debug: bool = False,
    device=None,
) -> Clip:
    """Edge-based scene detection (``scene.edges``): the draft edge mask,
    the offset-frame difference (``sc_tht_offset`` is its offset), the
    reasons' ladder, the luma gates and the SSIM confirmation.
    ``sc_debug=True`` prints the cut indices."""
    from .scene.edges import scene_detect_edges

    flags = scene_detect_edges(
        clip.frames, threshold=sc_threshold, frequency=0, sc_diff_offset=sc_tht_offset,
        sc_min_int=sc_min_int, sc_mult_tht=sc_mult_tht, tht_white=sc_tht_white,
        tht_black=sc_tht_black, sc_tht_ssim=sc_tht_ssim, device=resolve_device(device),
    )
    if sc_debug:
        print("HAVC-SC-EDGES:", list(np.nonzero(flags.sc_prev)[0]))
    return clip.with_sc(flags)


def HAVC_SceneDetectMotion(
    clip: Clip,
    bad_sad: float = 0.08,
    bad_ratio: float = 0.55,
    sc_min_int: int = 1,
    device=None,
) -> Clip:
    """Block-motion scene detection (``scene.motion``, the MVTools
    SCDetection role)."""
    from .scene.motion import scene_detect_motion

    flags = scene_detect_motion(clip.frames, bad_sad=bad_sad, bad_ratio=bad_ratio,
                                min_length=sc_min_int, device=resolve_device(device))
    return clip.with_sc(flags)


def HAVC_extract_reference_frames(
    clip: Clip,
    sc_threshold: float = 0.10,
    sc_tht_offset: int = 1,
    sc_tht_ssim: float = 0.0,
    sc_min_int: int = 1,
    sc_min_freq: int = 0,
    sc_framedir: str = "./",
    sc_sequence: bool = False,
    sc_normalize: bool = False,
    ref_offset: int = 0,
    sc_tht_white: float = 0.70,
    sc_tht_black: float = 0.10,
    ref_ext: str = "jpg",
    ref_jpg_quality: int = 95,
    ref_override: bool = True,
    sc_algo: int = 0,
    sc_debug: bool = False,
    device=None,
) -> list:
    """Detect the scene changes and write them as ``ref_nnnnnn`` images
    into ``sc_framedir``; returns the written paths.  ``sc_algo``: 0 the
    luma detector (with the SSIM filter), 1 the edge detector, 2 the Xvid
    keyframe vote (``scene.motion.scene_detect_xvid``), 3 the block-motion
    SCDetection, its thresholds derived as the reference's (thscd1 ~
    ``sc_threshold`` * 2500, thscd2 ~ ``sc_tht_ssim`` * 300)."""
    from .io.video import export_reference_frames

    dev = resolve_device(device)
    if sc_algo == 1:
        clip = HAVC_SceneDetectEdges(
            clip, sc_threshold=sc_threshold, sc_tht_ssim=sc_tht_ssim,
            sc_tht_offset=sc_tht_offset, sc_min_int=sc_min_int,
            sc_mult_tht=sc_min_freq if sc_min_freq > 0 else 15, sc_tht_white=sc_tht_white,
            sc_tht_black=sc_tht_black, sc_debug=sc_debug, device=dev,
        )
    elif sc_algo == 2:
        from .scene.motion import scene_detect_xvid

        clip = clip.with_sc(scene_detect_xvid(clip.frames, min_length=sc_min_int, device=dev))
    elif sc_algo == 3:
        from .scene.motion import scene_detect_motion

        clip = clip.with_sc(scene_detect_motion(
            clip.frames,
            bad_sad=min(sc_threshold * 2500, 1000) / 4096.0,
            bad_ratio=min(sc_tht_ssim * 300, 300) / 300.0 * 0.6 + 0.2,
            min_length=sc_min_int, device=dev,
        ))
    else:
        clip = HAVC_SceneDetect(
            clip, sc_threshold=sc_threshold, sc_tht_offset=sc_tht_offset,
            sc_tht_ssim=sc_tht_ssim, sc_min_int=sc_min_int, sc_min_freq=sc_min_freq,
            sc_normalize=sc_normalize, sc_tht_white=sc_tht_white, sc_tht_black=sc_tht_black,
            sc_debug=sc_debug, device=dev,
        )
    return export_reference_frames(
        clip, sc_framedir, ext=ref_ext, ref_offset=ref_offset, ref_jpg_quality=ref_jpg_quality,
        ref_override=ref_override, sequence=sc_sequence,
    )


def HAVC_export_reference_frames(
    clip: Clip,
    sc_framedir: str = "./",
    ref_offset: int = 0,
    ref_ext: str = "jpg",
    ref_jpg_quality: int = 95,
    ref_override: bool = True,
) -> list:
    """Write the frames already flagged on the clip as ``ref_nnnnnn``
    images; returns the written paths (nothing is computed: no device)."""
    from .io.video import export_reference_frames

    return export_reference_frames(
        clip, sc_framedir, ext=ref_ext, ref_offset=ref_offset,
        ref_jpg_quality=ref_jpg_quality, ref_override=ref_override,
    )


def HAVC_export_list_frames(
    clip: Clip,
    sc_framedir: str = "./",
    ref_list: Optional[list] = None,
    offset: int = 0,
    ref_ext: str = "jpg",
    ref_jpg_quality: int = 95,
    ref_override: bool = True,
    fast_extract: bool = True,
    frame_list: Optional[list] = None,
) -> list:
    """Write an explicit list of frames as ``ref_nnnnnn`` images; a
    one-element ``ref_list=[N]`` writes every N-th frame.  ``fast_extract``
    is accepted and changes nothing (frames are random access here);
    ``frame_list`` is a deprecated alias of ``ref_list``."""
    from .io.video import export_reference_frames

    del fast_extract
    if ref_list is None:
        ref_list = frame_list
    if not ref_list:
        return []
    if len(ref_list) == 1:
        ref_list = list(range(0, clip.num_frames, max(int(ref_list[0]), 1)))
    return export_reference_frames(
        clip, sc_framedir, ext=ref_ext, frame_list=ref_list, ref_offset=offset,
        ref_jpg_quality=ref_jpg_quality, ref_override=ref_override,
    )


# --------------------------------------------------------------------------
# overlay and degrain
# --------------------------------------------------------------------------


@torch.inference_mode()
def HAVC_clip_overlay(
    base: Clip,
    overlay: Clip = None,
    x: int = 0,
    y: int = 0,
    mask: Optional[Clip] = None,
    opacity: float = 1.0,
    mode: str = "normal",
    planes=None,
    mask_first_plane: bool = True,
    overlay_clip: Optional[Clip] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Blend-mode compositor (``ops.overlay``): 9 modes, placement at
    (x, y), an optional mask and the opacity.  ``planes`` selects the RGB
    channels that are blended (the others keep the base);
    ``mask_first_plane=False`` takes each mask channel for its own plane.
    ``overlay_clip`` is a deprecated alias of ``overlay``."""
    from .ops.overlay import overlay as op_overlay

    if overlay is None:
        overlay = overlay_clip
    if overlay is None:
        raise ValueError("HAVC_clip_overlay: overlay clip is required")
    if planes is None:
        plane_sel = (0, 1, 2)
    elif isinstance(planes, int):
        plane_sel = (planes,)
    else:
        plane_sel = tuple(planes)
    dev = resolve_device(device)
    b_clip, to_host = _on(base, dev)
    b_all, o_all = b_clip.frames, overlay.to_device(dev).frames
    per_plane_mask = mask is not None and not mask_first_plane
    m_all = None
    if mask is not None:
        m_all = mask.to_device(dev).frames
        if not per_plane_mask:
            m_all = m_all[..., 0]
    keep = None
    if plane_sel != (0, 1, 2):
        keep = torch.tensor([1.0 if c in plane_sel else 0.0 for c in range(3)], device=dev)

    def compose(b, o, m):
        if per_plane_mask:
            out = torch.stack([op_overlay(b, o, x, y, m[..., c], opacity, mode)[..., c]
                               for c in range(3)], dim=-1)
        else:
            out = op_overlay(b, o, x, y, m, opacity, mode)
        return out if keep is None else out * keep + b * (1.0 - keep)

    outs = [compose(b_all[s:s + batch_size], o_all[s:s + batch_size],
                    None if m_all is None else m_all[s:s + batch_size])
            for s in range(0, b_clip.num_frames, batch_size)]
    out = b_clip.with_frames(torch.cat(outs, dim=0))
    return out.to_host() if to_host else out


def HAVC_degrain(clip: Clip, strength: int = 1, batch_size: int = 4, device=None) -> Clip:
    """Non-local-means luma degrain (``ops.denoise``, the KNLMeansCL
    role), strengths 1-3."""
    from .ops.denoise import degrain

    return _map(clip, lambda x: degrain(x, strength), batch_size, resolve_device(device))


# --------------------------------------------------------------------------
# global parameter setters
# --------------------------------------------------------------------------

_GLOBAL_PARAMS = {
    "tweak": list(DEF_TWEAK_p),
    "cmc": list(DEF_CMC_p),
    "lmm": list(DEF_LMM_p),
    "alm": list(DEF_ALM_p),
    "crt": list(DEF_CRT_p),
}


def HAVC_set_tweak_params(tweaks_param: Optional[list] = None, **kwargs):
    """Set the global DDColor tweak defaults: the 8-slot list [bright,
    cont, gamma, luma_constrained_tweak, luma_min, gamma_luma_min,
    gamma_alpha, gamma_min], or slots by keyword.  The shared DEF_TWEAK_p
    list is changed in place, so every default bound to it sees it."""
    if tweaks_param is not None:
        DEF_TWEAK_p[:] = list(tweaks_param)
    names = ["bright", "cont", "gamma", "luma_constrained_tweak", "luma_min",
             "gamma_luma_min", "gamma_alpha", "gamma_min"]
    for k, v in kwargs.items():
        if k in names:
            DEF_TWEAK_p[names.index(k)] = v
    _GLOBAL_PARAMS["tweak"] = list(DEF_TWEAK_p)
    return list(DEF_TWEAK_p)


def HAVC_set_merge_params(method: int = 2, merge_params: Optional[list] = None,
                          cmc_p=None, lmm_p=None, alm_p=None, crt_p=None):
    """Set the global parameter pack of a merge method: 3/7 CMC, 4 LMM,
    5 ALM, 6 CRT (0-2 take none); or a pack by keyword.  The packs are
    changed in place, so the defaults bound to them see it."""
    if merge_params is not None:
        if method in (3, 7):
            cmc_p = merge_params
        elif method == 4:
            lmm_p = merge_params
        elif method == 5:
            alm_p = merge_params
        elif method == 6:
            crt_p = merge_params
        elif method not in (0, 1, 2):
            raise ValueError(f"HAVC_set_merge_params: unsupported method: {method}")
    for key, pack, new in (("cmc", DEF_CMC_p, cmc_p), ("lmm", DEF_LMM_p, lmm_p),
                           ("alm", DEF_ALM_p, alm_p), ("crt", DEF_CRT_p, crt_p)):
        if new is not None:
            pack[:] = list(new)
            _GLOBAL_PARAMS[key] = list(new)
    return dict(_GLOBAL_PARAMS)


# --------------------------------------------------------------------------
# legacy wrappers
# --------------------------------------------------------------------------


def HAVC_ddeoldify(
    clip: Clip,
    method: int = 2,
    mweight: float = 0.4,
    deoldify_p=(0, 24, 1.0, 0.0),
    ddcolor_p=(1, 24, 1.0, 0.0, True),
    ddtweak: bool = False,
    ddtweak_p=(DEF_TWEAK_p, "300:360|0.8,0.1"),
    cmc_tresh: float = 0.2,
    lmm_p=(0.2, 0.8, 1.0),
    alm_p=(0.8, 1.0, 0.15),
    cmb_sw: bool = False,
    sc_threshold: float = 0.0,
    sc_tht_offset: int = 1,
    sc_min_freq: int = 0,
    sc_tht_ssim: float = 0.0,
    sc_normalize: bool = False,
    sc_min_int: int = 1,
    sc_tht_white: float = 0.70,
    sc_tht_black: float = 0.10,
    device_index: int = 0,
    torch_dir: Optional[str] = None,
    sc_debug: bool = False,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Deprecated: ``HAVC_colorizer`` with the scalar ``ddtweak`` as the
    3-flag pack and ``cmc_tresh`` as the first CMC parameter."""
    import warnings

    warnings.warn("HAVC_ddeoldify() is deprecated; use HAVC_colorizer()", DeprecationWarning)
    return HAVC_colorizer(
        clip, method=method, mweight=mweight, deoldify_p=deoldify_p, ddcolor_p=ddcolor_p,
        ddtweak=(bool(ddtweak), False, False), ddtweak_p=ddtweak_p,
        cmc_p=[cmc_tresh] + list(DEF_CMC_p[1:]), lmm_p=lmm_p, alm_p=alm_p, crt_p=DEF_CRT_p,
        cmb_sw=cmb_sw, sc_threshold=sc_threshold, sc_tht_offset=sc_tht_offset,
        sc_min_freq=sc_min_freq, sc_tht_ssim=sc_tht_ssim, sc_normalize=sc_normalize,
        sc_min_int=sc_min_int, sc_tht_white=sc_tht_white, sc_tht_black=sc_tht_black,
        device_index=device_index, torch_dir=torch_dir, debug_level=2 if sc_debug else 0,
        batch_size=batch_size, device=device,
    )


def ddeoldify(
    clip: Clip,
    method: int = 2,
    mweight: float = 0.4,
    deoldify_p=(0, 24, 1.0, 0.0),
    ddcolor_p=(1, 24, 1.0, 0.0, True),
    dotweak: bool = False,
    dotweak_p=(0.0, 1.0, 1.0, False, 0.2, 0.5, 1.5, 0.5),
    ddtweak: bool = False,
    ddtweak_p=(DEF_TWEAK_p, "300:360|0.8,0.1"),
    degrain_strength: int = 0,
    cmc_tresh: float = 0.2,
    lmm_p=(0.2, 0.8, 1.0),
    alm_p=(0.8, 1.0, 0.15),
    cmb_sw: bool = False,
    device_index: int = 0,
    torch_dir: Optional[str] = None,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Deprecated: ``HAVC_colorizer`` as ``HAVC_ddeoldify`` forwards it,
    without scene detection; ``dotweak``, ``dotweak_p`` and
    ``degrain_strength`` are accepted and dropped (as the reference does)."""
    import warnings

    warnings.warn("ddeoldify() is deprecated; use HAVC_colorizer()", DeprecationWarning)
    del dotweak, dotweak_p, degrain_strength
    return HAVC_colorizer(
        clip, method=method, mweight=mweight, deoldify_p=deoldify_p, ddcolor_p=ddcolor_p,
        ddtweak=(bool(ddtweak), False, False), ddtweak_p=ddtweak_p,
        cmc_p=[cmc_tresh] + list(DEF_CMC_p[1:]), lmm_p=lmm_p, alm_p=alm_p, crt_p=DEF_CRT_p,
        cmb_sw=cmb_sw, sc_threshold=0, sc_min_freq=0, device_index=device_index,
        torch_dir=torch_dir, batch_size=batch_size, device=device,
    )


def ddeoldify_main(
    clip: Clip,
    Preset: str = "Fast",
    VideoTune: str = "Stable",
    ColorFix: str = "Violet/Red",
    ColorTune: str = "Light",
    ColorMap: str = "None",
    degrain_strength: int = 0,
    enable_fp16: bool = True,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Deprecated: ``HAVC_main`` with these settings; ``degrain_strength``
    is accepted and dropped (as the reference does)."""
    import warnings

    warnings.warn("ddeoldify_main() is deprecated; use HAVC_main()", DeprecationWarning)
    del degrain_strength
    return HAVC_main(clip, Preset=Preset, VideoTune=VideoTune, ColorFix=ColorFix,
                     ColorTune=ColorTune, ColorMap=ColorMap, enable_fp16=enable_fp16,
                     batch_size=batch_size, device=device)


def ddeoldify_stabilizer(
    clip: Clip,
    dark: bool = False,
    dark_p=(0.2, 0.8),
    smooth: bool = False,
    smooth_p=(0.3, 0.7, 0.9, 0.0, "none"),
    stab: bool = False,
    stab_p=(5, "A", 1, 15, 0.2, 0.80),
    colormap: str = "none",
    render_factor: int = 24,
    batch_size: int = 8,
    device=None,
) -> Clip:
    """Deprecated: ``HAVC_stabilizer`` with these settings."""
    import warnings

    warnings.warn("ddeoldify_stabilizer() is deprecated; use HAVC_stabilizer()",
                  DeprecationWarning)
    return HAVC_stabilizer(clip, dark=dark, dark_p=dark_p, smooth=smooth, smooth_p=smooth_p,
                           stab=stab, stab_p=stab_p, colormap=colormap,
                           render_factor=render_factor, batch_size=batch_size, device=device)


def vs_frame_interpolation(clip: Clip, clip_ref: Clip, frame_interp: int = 5,
                           chroma_adjust: str = "none", process_id: int = 1,
                           batch_size: int = 8, device=None) -> Clip:
    """Colors between the references of ``clip_ref``: the public form of
    the interpolator of ``HAVC_colorizer_fast`` and FrameInterp."""
    return _frame_interpolation(clip, clip_ref, frame_interp, chroma_adjust, process_id,
                                batch_size, device=device)


def disable_warnings():
    """Silence the noisy loggers of the libraries the port runs on (torch,
    PIL, numpy, matplotlib) and the future, user and deprecation warnings."""
    import logging
    import warnings

    for module in ("torch", "PIL", "numpy", "matplotlib"):
        logging.getLogger(module).setLevel(logging.ERROR)
    warnings.simplefilter(action="ignore", category=FutureWarning)
    warnings.simplefilter(action="ignore", category=UserWarning)
    warnings.simplefilter(action="ignore", category=DeprecationWarning)


def HAVC_cmnet(clip: Clip, clip_ref: Optional[Clip] = None, device=None, **kwargs) -> Clip:
    """The first ColorMNet front end: ``HAVC_deepex`` with ``ex_model=0``
    unless the caller names another."""
    from .exemplar import HAVC_deepex

    kwargs.setdefault("ex_model", 0)
    return HAVC_deepex(clip, clip_ref, device=device, **kwargs)
