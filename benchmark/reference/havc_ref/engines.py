"""The engines' registry and the colorizer adapters of the port's
``havc_tpu_torch/engines.py``, frozen: DeOldify, DDColor and ColorMNet.

``registry`` holds one ``nn.Module`` per (family, name, device); the
benchmark installs each module with its weights (``install``) before a
path asks for it.  The networks run inside
``utils.precision.engine_precision``, the filters around them at IEEE
float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch.nn as nn

from .filters import constrained_tweak, recover_clip_luma
from .ops import equalize
from .ops.chroma import chroma_tweak
from .ops.chroma import tweak as op_tweak
from .utils.precision import engine_precision
from .utils.profiling import resolve_device

DEF_STABLE_WEIGHT = 0.5  # reference constants.py:56
DEF_ARTISTIC_WEIGHT = 0.5  # reference constants.py:57
DEF_TWEAK_p = [0.0, 1.0, 2.5, True, 0.3, 0.6, 1.5, 0.5]  # constants.py:23


class EngineRegistry:
    """One module per (family, name, device), installed by the caller."""

    def __init__(self):
        self._cache: Dict[tuple, nn.Module] = {}

    def install(self, family: str, name: str, device, module: nn.Module) -> None:
        self._cache[(family, name, resolve_device(device))] = module

    def clear(self):
        self._cache.clear()

    def _get(self, family: str, name: str, device) -> nn.Module:
        key = (family, name, resolve_device(device))
        if key not in self._cache:
            raise KeyError(f"no {family} {name!r} engine installed on {key[2]}")
        return self._cache[key]

    def deoldify(self, name: str, device=None) -> nn.Module:
        return self._get("deoldify", name, device)

    def ddcolor(self, name: str, device=None) -> nn.Module:
        return self._get("ddcolor", name, device)

    def colormnet(self, config: str, device=None) -> nn.Module:
        return self._get("colormnet", config, device)


registry = EngineRegistry()


# --- frame-batch colorizers --------------------------------------------------


def make_deoldify_fn(model: int = 0, render_factor: int = 24, device=None) -> Callable:
    """DeOldify adapter: model 0=Video, 1=Stable, 2=Artistic; the Stable
    output is blended 50/50 with the Video output (DEF_STABLE_WEIGHT)."""
    from .models import deoldify as do

    names = {0: "video", 1: "stable", 2: "artistic"}
    name = names.get(model, "video")
    m = registry.deoldify(name, device)
    mv = None if name == "video" else registry.deoldify("video", device)
    w = DEF_STABLE_WEIGHT if name == "stable" else DEF_ARTISTIC_WEIGHT

    def fn(frames):
        with engine_precision(frames.device):
            out = do.colorize(m, frames, render_factor=render_factor)
            if mv is None:
                return out
            out_video = do.colorize(mv, frames, render_factor=render_factor)
        return out_video * (1 - w) + out * w

    return fn


def make_ddcolor_fn(
    model: int = 1,
    render_factor: int = 24,
    tweaks_flags=(False, False, False),
    tweaks=(DEF_TWEAK_p, "none"),
    device=None,
) -> Callable:
    """DDColor adapter: models 0=modelscope, 1=artistic.  DDColor runs at
    ``trunc(rf/2)*32``.  Prefilters: the
    retinex equalizer (``tweaks_flags[2]``) or the tweak (luma-constrained
    or plain); then the hue fix, the denoise postfilter (white balance and
    luma CLAHE, ``tweaks_flags[1]``) and luma recovery when a prefilter
    ran."""
    input_size = math.trunc(render_factor / 2) * 32
    tweaks_enabled, denoise_enabled, retinex_enabled = tweaks_flags
    if len(tweaks) == 2:
        t = list(tweaks[0])
        hue_adjust = tweaks[1].lower()
    else:
        t = list(tweaks[:8])
        hue_adjust = tweaks[8] if len(tweaks) > 8 else "none"
    bright, cont, gamma, luma_constrained = t[0], t[1], t[2], t[3]
    luma_min, gamma_luma_min, gamma_alpha, gamma_min = t[4], t[5], t[6], t[7]

    from .models import ddcolor as dd

    m = registry.ddcolor("modelscope" if model == 0 else "artistic", device)
    core = lambda x: dd.colorize(m, x, input_size=input_size)  # noqa: E731

    def fn(frames):
        x = frames
        if tweaks_enabled:
            if retinex_enabled:
                x = equalize.rgb_equalizer(x, method=5, strength=1.0)
            elif luma_constrained:
                x = op_tweak(x, bright=bright, cont=cont)
                x = constrained_tweak(
                    x, luma_min=luma_min, gamma=gamma,
                    gamma_luma_min=gamma_luma_min, gamma_alpha=gamma_alpha,
                    gamma_min=gamma_min,
                )
            else:
                x = op_tweak(x, bright=bright, cont=cont, gamma=gamma)
        with engine_precision(x.device):
            out = core(x)
        if hue_adjust not in ("none", ""):
            out = chroma_tweak(out, hue_adjust=hue_adjust)
        if denoise_enabled:
            out = equalize.rgb_balance(out, strength=0.3, rgb_factor=(0.98, 1.02, 1.0))
            out = equalize.rgb_equalizer(out, method=0, strength=0.2, luma_blend_on=False)
        if tweaks_enabled:
            out = recover_clip_luma(frames, out)
        return out

    return fn
