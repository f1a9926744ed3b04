"""Public HAVC_* entry points of the main path, on :class:`Clip`.

Port of the classic path of ``havc_tpu.api``: ``HAVC_main`` (speed ids
2-7) -> ``HAVC_main_presets`` -> the classic branch of
``HAVC_main_colorizer`` -> ``HAVC_colorizer`` (work resize, DeOldify and
DDColor, merge, chroma restore) and ``HAVC_stabilizer`` (fused post-chain
kernel or the filter chain, temporal chroma stabilizer, deflicker, chroma
restore).  Parameter names, packs and defaults are the JAX package's.

Every entry point takes ``device``: ``None`` means CUDA and raises when
there is none; ``device="cpu"`` runs on the CPU.  A clip of numpy frames
comes back with numpy frames; a clip of tensors comes back with tensors on
the device it ran on.  Branches that need a module not ported yet raise
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import engines, filters, presets
from .clip import Clip
from .ops import chroma as chroma_ops
from .ops import merge as merge_ops
from .ops import temporal as temporal_ops
from .ops.post_chain import post_chain
from .ops.resize import resize
from .utils.profiling import resolve_device, stage_timer

__all__ = [
    "HAVC_main",
    "HAVC_main_presets",
    "HAVC_main_colorizer",
    "HAVC_colorizer",
    "HAVC_stabilizer",
    "HAVC_set_debug_level",
    "DEF_TWEAK_p",
]

from .ops.merge import DEF_ALM_p, DEF_CMC_p, DEF_CRT_p, DEF_LMM_p

DEF_TWEAK_p = engines.DEF_TWEAK_p

_DEBUG_LEVEL = [0]


def HAVC_set_debug_level(debug_level: int = 0):
    """0 = silent, 1 = info (stage timing), 2 = info + debug."""
    if debug_level in (0, 1, 2):
        _DEBUG_LEVEL[0] = debug_level


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to havc_tpu_torch yet (ROADMAP queue 1: {item})"
    )


def _on(clip: Clip, dev: torch.device):
    """(clip as a tensor on ``dev``, whether to hand numpy back)."""
    return clip.to_device(dev), not clip.on_device


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
    chroma-resize restore.  Scene detection (``sc_threshold`` or
    ``sc_min_freq`` non-zero) is not ported yet."""
    del device_index, torch_dir
    if debug_level:
        HAVC_set_debug_level(debug_level)
    if sc_threshold < 0:
        raise ValueError("HAVC_colorizer: sc_threshold must be >= 0")
    if sc_min_freq < 0:
        raise ValueError("HAVC_colorizer: sc_min_freq must be >= 0")
    if not (sc_threshold == 0 and sc_min_freq == 0):
        raise _not_ported("scene detection", "the rest of the classic surface")
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
    out = _colorize_fused(
        clip, method, merge_weight, do_model, do_rf, do_sat, do_hue,
        dd_model, dd_rf, dd_sat, dd_hue, ddtweak, ddtweak_p,
        cmc_p, lmm_p, alm_p, crt_p, cmb_sw, frame_size, batch_size, dev,
    )
    return out.to_host() if to_host else out


def _colorize_fused(
    clip: Clip, method: int, merge_weight: float,
    do_model: int, do_rf: int, do_sat: float, do_hue: float,
    dd_model: int, dd_rf: int, dd_sat: float, dd_hue: float,
    ddtweak, ddtweak_p, cmc_p, lmm_p, alm_p, crt_p, cmb_sw: bool,
    frame_size: int, batch_size: int, dev: torch.device,
) -> Clip:
    """Work resize -> engines -> combine -> chroma restore, batch by batch
    over a clip of tensors on ``dev``."""
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

    return clip.map_batches(stage, batch_size)


def _chroma_resize_clip(hires: Clip, lowres: Clip, batch_size: int = 8) -> Clip:
    """Spline64 chroma restore of ``lowres`` onto ``hires``'s luma, batch
    by batch; both clips hold tensors on one device."""
    outs = [
        filters.chroma_resize_restore(hires.frames[s:s + batch_size],
                                      lowres.frames[s:s + batch_size])
        for s in range(0, hires.num_frames, batch_size)
    ]
    return hires.with_frames(torch.cat(outs, dim=0)).copy_sc_from(lowres)


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
# HAVC_main_colorizer / HAVC_main_presets / HAVC_main
# --------------------------------------------------------------------------


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
    """Main HAVC coloring function, classic path: HAVC_colorizer, then the
    speed-tier stabilizer settings (colormap only for the fast presets;
    dark + smooth + colormap + stab for slower / slow / medium).  DeepEx,
    FrameInterp, ColorTemp and the Placebo/VerySlow tiling raise."""
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

    if EnableDeepEx:
        raise _not_ported("the DeepEx exemplar path (EnableDeepEx)",
                          "exemplar path, ColorMNet / DeepEx and DeepRemaster")
    if presets.get_temp_color(ColorTemp) > 0:
        raise _not_ported("ColorTemp re-colorization", "exemplar path, ColorMNet")
    if FrameInterp != 0:
        raise _not_ported("FrameInterp (HAVC_colorizer_fast)", "the rest of the classic surface")
    if speed_id in (0, 1):
        raise _not_ported("Placebo/VerySlow tile slicing (ops/tiles.py)",
                          "the rest of the classic surface")

    clip, to_host = _on(clip, dev)
    clip_colored = HAVC_colorizer(
        clip, method=dd_method, mweight=ddcolor_weight,
        deoldify_p=(do_model, deoldify_rf, 1.0, 0.0),
        ddcolor_p=(dd_model, ddcolor_rf, 1.0, 0.0, enable_fp16),
        ddtweak=tuple(dd_tweak), ddtweak_p=(DEF_TWEAK_p, hue_range),
        batch_size=batch_size, device=dev,
    )

    rf = min(deoldify_rf, ddcolor_rf)
    if speed_id > 4:  # fast / faster / veryfast: colormap only
        clip_colored = HAVC_stabilizer(
            clip_colored, colormap=chroma_adjust, render_factor=rf,
            batch_size=batch_size, device=dev,
        )
    else:  # slower / slow / medium
        clip_colored = HAVC_stabilizer(
            clip_colored, dark=True, dark_p=(0.2, 0.8),
            colormap=chroma_adjust, smooth=True,
            smooth_p=(0.3, 0.7, 0.9, 0.0, "none"),
            stab=(stab_enabled and dd_method != 0),
            stab_p=(5, "A", 1, 15, 0.2, 0.8), render_factor=rf,
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
    """Preset pipeline: HAVC_main_colorizer with every knob forwarded, then
    deflicker when asked for.  BlackWhiteTune, the retinex/red film LUT
    and ``lut`` raise."""
    HAVC_set_debug_level(debug_level)
    dev = resolve_device(device)
    presets.get_render_factors(Preset)

    EnableRetinex = (ColorTune.lower() != "none"
                     and ColorFix.lower() == "retinex/red")
    if BlackWhiteTune.lower() != "none":
        raise _not_ported("BlackWhiteTune (HAVC_bw_tune)", "the rest of the classic surface")
    if EnableRetinex or lut is not None:
        raise _not_ported("the film LUTs (ops/lut3d.py)", "the rest of the classic surface")
    DeFlicker = EnableDeepEx or ColorTemp.lower() != "none" or deflicker

    clip, to_host = _on(clip, dev)
    with stage_timer("colorizer"):
        clip_final = HAVC_main_colorizer(
            clip, Preset, ColorModel, CombMethod, VideoTune, ColorFix,
            ColorTemp, ColorTune, ColorMap, EnableDeepEx, DeepExMethod,
            DeepExPreset, DeepExRefMerge, DeepExOnlyRefFrames, ScFrameDir,
            ScThreshold, ScThtOffset, ScMinFreq, ScMinInt, ScThtSSIM,
            ScNormalize, DeepExModel, DeepExVivid, DeepExEncMode,
            DeepExMaxMemFrames, FrameInterp, RefRange, enable_fp16,
            debug_level, engine_config, batch_size, device=dev,
        )
    if DeFlicker:
        with stage_timer("deflicker"), torch.inference_mode():
            sc = clip_final.sc.sc_prev if clip_final.sc is not None else None
            clip_final = clip_final.with_frames(
                temporal_ops.reduce_flicker(clip_final.frames, scenechange=sc))
    return clip_final.to_host() if to_host else clip_final


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
    Presets Medium..VeryFast run HAVC_main_presets; Placebo and VerySlow
    raise."""
    if BWTune is not None:
        BlackWhiteTune = BWTune
    HAVC_set_debug_level(debug_level)
    dev = resolve_device(device)

    speed_id, _, _ = presets.get_render_factors(Preset)
    if speed_id in (0, 1):
        raise _not_ported(f"Preset {Preset!r} (HAVC_placebo/veryslow_preset)",
                          "the rest of the classic surface")
    return HAVC_main_presets(
        clip, Preset, FrameInterp, ColorModel, CombMethod, VideoTune,
        ColorFix, ColorTune, ColorMap, ColorTemp, BlackWhiteTune,
        BlackWhiteMode, BlackWhiteBlend, EnableDeepEx, DeepExMethod,
        DeepExPreset, DeepExRefMerge, DeepExOnlyRefFrames, ScFrameDir,
        ScThreshold, ScThtOffset, ScMinFreq, ScMinInt, ScThtSSIM,
        ScNormalize, DeepExModel, DeepExVivid, DeepExEncMode,
        DeepExMaxMemFrames, RefRange, enable_fp16, debug_level,
        engine_config, batch_size, device=dev,
    )
