"""Frozen copy of the port's ``havc_tpu_torch/presets.py`` (the benchmark's plain
reference).

Preset tables and resolution logic, copied whole from ``havc_tpu.presets``.

All string choices and numeric tables match the reference exactly so a
vs-deoldify user's presets behave identically.
"""
from __future__ import annotations

from .ops.chroma import parse_hue_adjust

__all__ = [
    "get_render_factors",
    "get_mweight",
    "get_comb_method",
    "get_color_model",
    "get_color_tune",
    "get_colormap",
    "get_temp_color",
    "split_color_model",
    "get_tune_id",
]

_PRESETS = ["placebo", "veryslow", "slower", "slow", "medium", "fast", "faster", "veryfast"]
_PRESET0_RF = [32, 32, 32, 28, 24, 22, 20, 16]
_PRESET1_RF = [32, 32, 32, 28, 24, 22, 20, 16]

_VIDEO_TUNE = ["verystable", "morestable", "stable", "balanced", "vivid", "morevivid", "veryvivid"]
_DDCOLOR_WEIGHT = [0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]

_COMB = ["simple", "constrained-chroma", "luma-masked", "adaptive-luma",
         "chroma-retention", "chromabound adaptive"]
_COMB_ID = [2, 3, 4, 5, 6, 7]

_DDCOLOR_LIST = ["modelscope", "artistic", "siggraph17", "eccv16"]
_DEOLDIFY_LIST = ["video", "stable", "artistic"]

_COLOR_TEMP = ["none", "veryhigh", "high", "medium", "low", "verylow"]

_COLOR_TUNE = ["none", "light", "medium", "strong"]
_COLOR_FIX = ["none", "magenta", "magenta/violet", "violet", "violet/red",
              "blue/magenta", "yellow", "yellow/orange", "yellow/green", "retinex/red"]
_HUE_FIX = ["none", "270:300", "250:360", "300:330", "300:360", "220:280",
            "60:90", "30:90", "60:120", "none"]

_COLORMAP = ["none", "blue->brown", "blue->red", "blue->green", "green->brown",
             "green->red", "green->blue", "redrose->brown", "redrose->blue",
             "red->brown", "red->blue", "yellow->rose"]
_HUE_MAP = ["none", "180:280|+140", "180:280|+100", "180:280|+220", "80:180|+260",
            "80:180|+220", "80:180|+140", "300:360,0:20|+40", "300:360,0:20|+260",
            "320:360|+50", "300:360|+260", "30:90|+300"]
_HUE_W = ["1.0", "0.90", "0.80", "0.75"]


def get_render_factors(preset: str):
    """preset -> (speed_id, deoldify_rf, ddcolor_rf)."""
    preset = preset.lower()
    try:
        pr_id = _PRESETS.index(preset)
    except ValueError:
        raise ValueError(f"HAVC_main: Preset choice is invalid for '{preset}'")
    return pr_id, _PRESET0_RF[pr_id], _PRESET1_RF[pr_id]


def get_mweight(video_tune: str) -> float:
    video_tune = video_tune.lower()
    try:
        return _DDCOLOR_WEIGHT[_VIDEO_TUNE.index(video_tune)]
    except ValueError:
        raise ValueError(f"HAVC_main: VideoTune choice is invalid for '{video_tune}'")


def get_comb_method(comb: str) -> int:
    comb = comb.lower()
    try:
        return _COMB_ID[_COMB.index(comb)]
    except ValueError:
        raise ValueError(f"HAVC_main: CombMethod choice is invalid for '{comb}'")


def get_color_model(color_model: str):
    """'video+artistic' etc. -> (do_model, dd_model, dd_method)."""
    cm = color_model.lower()
    if "+" in cm:
        a, b = cm.split("+")
        return _DEOLDIFY_LIST.index(a), _DDCOLOR_LIST.index(b), 2
    if "deoldify" in cm:
        name = cm.replace("deoldify", "").replace("(", "").replace(")", "")
        return _DEOLDIFY_LIST.index(name), 0, 0
    if "ddcolor" in cm:
        name = cm.replace("ddcolor", "").replace("(", "").replace(")", "")
    elif "zhang" in cm:
        name = cm.replace("zhang", "").replace("(", "").replace(")", "")
    else:
        raise ValueError(f"HAVC_main: ColorModel choice is invalid for '{color_model}'")
    return 0, _DDCOLOR_LIST.index(name), 1


def get_temp_color(color_temp) -> int:
    if color_temp is None:
        color_temp = "none"
    return _COLOR_TEMP.index(color_temp.lower().replace(" ", ""))


def get_tune_id(bw_tune: str) -> int:
    return _COLOR_TUNE.index(bw_tune.lower())


def get_color_tune(color_tune, color_fix, color_map, dd_model: int):
    """-> (dd_tweak_flags, hue_range, hue_range2, chroma_adjust, chroma_adjust2).

    Mirrors havc_utils._get_color_tune including the per-dd-model saturation
    tables and the retinex/red special case (co_id 9).
    """
    dd_tweak = [False, False, False]
    color_tune = (color_tune or "none").lower()
    if dd_model == 0:
        hue_tune = ["1.0,0.0", "0.7,0.1", "0.5,0.1", "0.2,0.1"]
    elif dd_model == 2:
        hue_tune = ["1.0,0.0", "0.6,0.1", "0.4,0.2", "0.2,0.1"]
    elif dd_model == 3:
        hue_tune = ["1.0,0.0", "0.7,0.1", "0.6,0.1", "0.3,0.1"]
    else:
        hue_tune = ["1.0,0.0", "0.8,0.1", "0.5,0.1", "0.2,0.1"]
    hue_tune2 = ["1.0,0.0", "0.9,0", "0.7,0", "0.5,0"]

    try:
        tn_id = _COLOR_TUNE.index(color_tune)
    except ValueError:
        raise ValueError(f"HAVC_main: ColorTune choice is invalid for '{color_tune}'")

    color_fix = (color_fix or "none").lower()
    try:
        co_id = _COLOR_FIX.index(color_fix)
    except ValueError:
        raise ValueError(f"HAVC_main: ColorFix choice is invalid for '{color_fix}'")

    if tn_id == 0:
        hue_range, hue_range2 = "none", "none"
        dd_tweak[0] = False
    elif co_id == 0:
        hue_range, hue_range2 = "none", "none"
        dd_tweak[0] = True
        dd_tweak[1] = True
    elif co_id == 9:
        hue_range = _HUE_FIX[4] + "|" + hue_tune[2]
        hue_range2 = _HUE_FIX[4] + "|" + hue_tune2[2]
        dd_tweak[0] = True
        dd_tweak[2] = True
    else:
        hue_range = _HUE_FIX[co_id] + "|" + hue_tune[tn_id]
        hue_range2 = _HUE_FIX[co_id] + "|" + hue_tune2[tn_id]
        dd_tweak[0] = True

    color_map = (color_map or "none").lower()
    try:
        cl_id = _COLORMAP.index(color_map)
    except ValueError:
        if parse_hue_adjust(color_map) is None:
            raise ValueError(f"HAVC_main: ColorMap choice is invalid for '{color_map}'")
        cl_id = -1

    if cl_id == 0:
        chroma_adjust, chroma_adjust2 = "none", "none"
    elif cl_id == -1:
        chroma_adjust, chroma_adjust2 = color_map, "none"
    else:
        chroma_adjust = _HUE_MAP[cl_id] + "," + _HUE_W[tn_id]
        chroma_adjust2 = "none" if tn_id == 0 else chroma_adjust

    return dd_tweak, hue_range, hue_range2, chroma_adjust, chroma_adjust2


def get_colormap(color_map: str = "red->brown", color_tune: str = "light") -> str:
    try:
        tn_id = _COLOR_TUNE.index(color_tune)
    except ValueError:
        raise ValueError(f"HAVC: ColorTune choice is invalid for '{color_tune}'")
    cm = color_map.lower()
    try:
        cl_id = _COLORMAP.index(cm)
    except ValueError:
        if parse_hue_adjust(cm) is None:
            raise ValueError(f"HAVC: ColorMap choice is invalid for '{color_map}'")
        return cm
    if cl_id == 0:
        return "none"
    return _HUE_MAP[cl_id] + "," + _HUE_W[tn_id]


def split_color_model(color_model: str):
    """'video+artistic' -> ('deoldify(video)', 'ddcolor(artistic)');
    single-model strings return 'none' for the other half
    (havc_utils._spit_color_model:380-401)."""
    cm = (color_model or "").lower()
    if "+" not in cm:
        if "deoldify" in cm:
            return cm, "none"
        return "none", cm
    a, b = cm.split("+")
    deoldify = f"deoldify({a})"
    if b in ("siggraph17", "eccv16"):
        return deoldify, f"zhang({b})"
    return deoldify, f"ddcolor({b})"
