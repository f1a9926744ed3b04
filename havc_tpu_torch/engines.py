"""Model engine registry and the colorizer adapters.

Port of ``havc_tpu.engines``.  The registry caches one ``nn.Module`` per
(family, name, device).  With a weights directory set
(``set_weights_dir``) it loads the same converted ``<family>_<name>.npz``
files the JAX registry reads (``colormnet.npz`` for the full ColorMNet,
``deepex.npz`` and ``remaster.npz`` for the other exemplar engines),
through the weight bridge; otherwise each engine gets seeded random
weights made on its device from a ``torch.Generator`` (flax's default
initialisers), and ``random_init_used`` is set.

``make_deoldify_fn`` / ``make_ddcolor_fn`` return ``fn(frames)`` over
``(B, H, W, 3)`` tensors on the engine's device; ``make_ddcolor_fn`` also
runs the Zhang nets (DDColor model ids 2 and 3) and the tweak, retinex
and denoise filters around the engine.  The networks run inside
``utils.precision.engine_precision`` (TF32 on the card unless the caller
set PyTorch's flags to IEEE), the filters around them at IEEE float32.
"""
from __future__ import annotations

import math
import os
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from .filters import constrained_tweak, recover_clip_luma
from .ops import equalize
from .ops.chroma import chroma_tweak
from .ops.chroma import tweak as op_tweak
from .utils.precision import engine_precision
from .utils.profiling import host_read, on_device, resolve_device

__all__ = [
    "EngineRegistry",
    "registry",
    "set_weights_dir",
    "load_npz_params",
    "make_deoldify_fn",
    "make_ddcolor_fn",
    "deoldify_frames",
    "ddcolor_frames",
    "zhang_frames",
    "colorize_gated",
    "DEF_STABLE_WEIGHT",
    "DEF_ARTISTIC_WEIGHT",
    "DEF_TWEAK_p",
]

DEF_STABLE_WEIGHT = 0.5  # reference constants.py:56
DEF_ARTISTIC_WEIGHT = 0.5  # reference constants.py:57
DEF_TWEAK_p = [0.0, 1.0, 2.5, True, 0.3, 0.6, 1.5, 0.5]  # constants.py:23


def load_npz_params(path: str) -> dict:
    """Load a flattened ``{'a/b/c': array}`` npz into a nested tree of
    numpy arrays."""
    tree: dict = {}
    with np.load(path) as flat:
        for k in flat.files:
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[k]
    return tree


def _npz_config(tree: dict) -> Optional[dict]:
    """The ``__config__/json`` geometry blob of a converted DDColor npz."""
    import json

    blob = tree.get("__config__", {}).get("json")
    if blob is None:
        return None
    return json.loads(bytes(np.asarray(blob)).decode())


@dataclass
class EngineRegistry:
    """Caches one module per (family, name, device)."""

    weights_dir: Optional[str] = None
    _cache: Dict[tuple, nn.Module] = field(default_factory=dict)
    random_init_used: bool = False

    def clear(self):
        self._cache.clear()

    def deoldify(self, name: str, device=None) -> nn.Module:
        from .models import deoldify as do

        return self._get("deoldify", name, device, lambda cfg: do.make_model(name),
                         f"deoldify_{name}.npz")

    def ddcolor(self, name: str, device=None) -> nn.Module:
        from .models import ddcolor as dd

        def build(cfg):
            return dd.DDColor(**cfg) if cfg else dd.DDColor.from_config(name)

        return self._get("ddcolor", name, device, build, f"ddcolor_{name}.npz")

    def zhang(self, name: str, device=None) -> nn.Module:
        """Zhang ``eccv16`` or ``siggraph17`` at the published width."""
        from .models import zhang as zh

        return self._get("zhang", name, device,
                         lambda cfg: zh.ECCV16() if name == "eccv16" else zh.Siggraph17(),
                         f"zhang_{name}.npz")

    def colormnet(self, config: str, device=None) -> nn.Module:
        """ColorMNet's five parameter groups: the converted checkpoint
        ``colormnet.npz`` for ``config="full"`` when one is configured,
        else seeded weights."""
        from .models import colormnet as cm

        return self._get("colormnet", config, device, lambda _: cm.ColorMNet(config),
                         "colormnet.npz" if config == "full" else None)

    def deepex(self, device=None) -> nn.Module:
        """Deep-Exemplar's three networks (``vgg``, ``warpnet``,
        ``colorvid``): ``deepex.npz`` when one is configured, else seeded
        weights."""
        from .models import deepex as dx

        return self._get("deepex", "full", device, lambda _: dx.DeepEx(), "deepex.npz")

    def remaster(self, device=None) -> nn.Module:
        """DeepRemaster's NetworkC: ``remaster.npz`` when one is configured,
        else seeded weights."""
        from .models import remaster as rm

        return self._get("remaster", "full", device, lambda _: rm.NetworkC(), "remaster.npz")

    def checkpoint(self, file: Optional[str]) -> Optional[str]:
        """The path of the converted checkpoint ``<weights_dir>/<file>``, or
        None when there is none."""
        if self.weights_dir is None or file is None:
            return None
        path = os.path.join(self.weights_dir, file)
        return path if os.path.exists(path) else None

    def _get(self, family: str, name: str, device, build, npz: Optional[str]) -> nn.Module:
        dev = resolve_device(device)
        key = (family, name, dev)
        if key not in self._cache:
            self._cache[key] = self._make(family, name, dev, build, npz)
        return self._cache[key]

    def _make(self, family: str, name: str, dev: torch.device, build,
              npz: Optional[str]) -> nn.Module:
        from .models.bridge import state_dict_from_flax
        from .models.layers import init_flax_defaults

        path = self.checkpoint(npz)
        tree = load_npz_params(path) if path is not None else None
        # built without storage, then materialised on the target device:
        # a full-width model is never initialised on the host
        with torch.device("meta"):
            model = build(_npz_config(tree) if tree is not None else None)
        model = model.to_empty(device=dev)
        if tree is not None:
            model.load_state_dict(state_dict_from_flax(tree["params"]))
        else:
            self.random_init_used = True
            gen = torch.Generator(device=dev)
            gen.manual_seed(zlib.crc32(f"{family}_{name}".encode()))
            init_flax_defaults(model, gen)
        return model.eval().requires_grad_(False)


registry = EngineRegistry()


def set_weights_dir(path: Optional[str]):
    """Point the registry at converted checkpoints (``family_name.npz``)."""
    registry.weights_dir = path
    registry.clear()


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


def _residency(frames, out: torch.Tensor):
    """``out`` as numpy when ``frames`` was numpy."""
    return out if isinstance(frames, torch.Tensor) else host_read(out)


@torch.inference_mode()
def deoldify_frames(frames, model: int = 0, render_factor: int = 24, device=None):
    """``make_deoldify_fn`` applied once to (B, H, W, 3) frames, on their
    device (``device`` for numpy)."""
    x = on_device(frames, device)
    return _residency(frames, make_deoldify_fn(model, render_factor, device=x.device)(x))


def make_ddcolor_fn(
    model: int = 1,
    render_factor: int = 24,
    tweaks_flags=(False, False, False),
    tweaks=(DEF_TWEAK_p, "none"),
    device=None,
) -> Callable:
    """DDColor adapter: models 0=modelscope, 1=artistic, 2=Zhang
    siggraph17, 3=Zhang eccv16.  DDColor runs at ``trunc(rf/2)*32``, Zhang
    always at 256 (the reference's colorize call hardcodes it).  Prefilters: the
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

    if model > 1:
        from .models import zhang as zh

        m = registry.zhang("siggraph17" if model == 2 else "eccv16", device)
        core = lambda x: zh.colorize(m, x, input_size=256)  # noqa: E731
    else:
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


@torch.inference_mode()
def ddcolor_frames(
    frames,
    model: int = 1,
    render_factor: int = 24,
    tweaks_flags=(False, False, False),
    tweaks=(DEF_TWEAK_p, "none"),
    device=None,
):
    """``make_ddcolor_fn`` applied once to (B, H, W, 3) frames, on their
    device (``device`` for numpy)."""
    x = on_device(frames, device)
    fn = make_ddcolor_fn(model, render_factor, tweaks_flags=tweaks_flags, tweaks=tweaks,
                         device=x.device)
    return _residency(frames, fn(x))


def zhang_frames(frames: torch.Tensor, model_name: str = "siggraph17", frame_size: int = 256,
                 device=None) -> torch.Tensor:
    """Zhang adapter: ``frames`` colorized by the ``model_name`` net at
    ``frame_size``."""
    from .models import zhang as zh

    m = registry.zhang(model_name, device)
    with engine_precision(frames.device):
        return zh.colorize(m, frames, input_size=frame_size)


@torch.inference_mode()
def colorize_gated(
    frames,
    sc_prev: Optional[np.ndarray],
    colorize_fn: Callable,
    batch_size: int = 8,
    jit_key=None,
    params=None,
    device=None,
):
    """``colorize_fn`` on the scene-change frames only (frame 0 always),
    the other frames passed through: the flagged frames are gathered into
    batches of ``batch_size``, a short last batch padded by repeating its
    last frame.  With ``sc_prev=None`` every frame is colorized.
    ``params``, when given, is passed first (``colorize_fn(params,
    batch)``); ``jit_key`` named a compile cache in the JAX package and is
    not used.  Runs on the frames' device (``device`` for numpy); the
    result lives where the input did."""
    del jit_key
    x = on_device(frames, device)
    if sc_prev is None:
        idx = np.arange(x.shape[0])
    else:
        idx = np.nonzero(np.asarray(sc_prev))[0]
        if len(idx) == 0 or sc_prev[0] == 0:
            idx = np.unique(np.concatenate([[0], idx]))
    fn = colorize_fn if params is None else (lambda chunk: colorize_fn(params, chunk))
    out = x.clone()
    for start in range(0, len(idx), batch_size):
        sel = torch.from_numpy(idx[start:start + batch_size]).to(x.device)
        chunk = x[sel]
        n = chunk.shape[0]
        if n < batch_size:
            chunk = torch.cat([chunk, chunk[-1:].expand(batch_size - n, *chunk.shape[1:])])
        out[sel] = fn(chunk)[:n]
    return _residency(frames, out)
