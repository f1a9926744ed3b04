"""``HAVC_main`` on the two configurations the benchmark runs, in plain
PyTorch: a frozen copy of the port's orchestration (``havc_tpu_torch/api.py``
and ``havc_tpu_torch/exemplar/__init__.py``), cut to the branches these
settings take.

* ``havc_main(clip)``: Preset Medium, ColorModel Video+Artistic, CombMethod
  Simple, ColorFix Magenta/Violet, ColorTune Light: work resize, DeOldify
  Video and DDColor Artistic, merge, chroma restore, the stabilizer with the
  post chain, the temporal chroma stabilizer and deflicker.
* ``havc_main(clip, exemplar=True)``: the same colorizer on the scene
  changes that scene detection finds at ``ScThreshold`` 0.10, ColorMNet
  (vivid: a fresh memory at each reference) propagating them at the
  Medium work size, the fast stabilizer settings, deflicker.

Every network runs in the dtype its module holds and, in float32, at
whatever precision the caller's flags give (``utils.precision``); the
benchmark calls it at IEEE float32.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch

from . import engines, filters, presets
from .clip import Clip
from .models import colormnet as cm
from .models import memory as mem
from .ops import chroma as chroma_ops
from .ops import merge as merge_ops
from .ops import temporal as temporal_ops
from .ops.colorspace import lab_to_rgb, rgb_to_lab
from .ops.post_chain import post_chain
from .ops.resize import resize, smart_resize_pad, smart_resize_restore
from .scene.detect import scene_detect
from .utils.precision import engine_precision

__all__ = ["havc_main", "ColorMNetEngine", "colormnet_propagate"]

DEF_TWEAK_p = engines.DEF_TWEAK_p
ENC_BATCH = 8  # frames per batched key-encoder call
DEEPEX_SIZES = {"fast": (144, 256), "medium": (216, 384), "slow": (288, 512),
                "slower": (360, 640)}  # SmartResize work size (H, W) of a render speed


# --- the classic colorizer and the stabilizer (api.py) -----------------------


def colorizer(clip: Clip, method: int, mweight: float, deoldify_p, ddcolor_p, ddtweak,
              ddtweak_p, sc_threshold: float = 0.0, batch_size: int = 8) -> Clip:
    """``HAVC_colorizer``: spline64 square resize to ``max(rf)*16``, both
    engines, merge, chroma-resize restore; with ``sc_threshold`` only the
    scene changes that scene detection flags are colorized."""
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
    frame_size = min(max(dd_rf, do_rf) * 16, clip.width)
    dev = clip.frames.device

    sc_idx = None
    if sc_threshold != 0:
        flags = scene_detect(clip.frames, threshold=sc_threshold, frequency=0,
                             sc_tht_filter=0.0, min_length=1, tht_white=0.70, tht_black=0.10,
                             tht_offset=1, normalize=False, device=dev)
        clip = clip.with_sc(flags)
        sc_idx = np.nonzero(flags.sc_prev.astype(bool))[0]

    do_fn = engines.make_deoldify_fn(do_model, do_rf, device=dev) if method != 1 else None
    dd_fn = (engines.make_ddcolor_fn(dd_model, dd_rf, tweaks_flags=tuple(ddtweak),
                                     tweaks=ddtweak_p, device=dev) if method != 0 else None)

    def stage(frames):
        work = torch.clamp(resize(frames, frame_size, frame_size, "spline64"), 0.0, 1.0)
        if method == 0:
            combined = do_fn(work)
            if do_sat != 1 or do_hue != 0:
                combined = chroma_ops.tweak(combined, hue=do_hue, sat=do_sat)
        elif method == 1:
            combined = dd_fn(work)
            if dd_sat != 1 or dd_hue != 0:
                combined = chroma_ops.tweak(combined, hue=dd_hue, sat=dd_sat)
        else:
            combined = merge_ops.combine_models(
                do_fn(work), dd_fn(work), method=method, sat=(do_sat, dd_sat),
                hue=(do_hue, dd_hue), b_weight=merge_weight,
            )
        return filters.chroma_resize_restore(frames, combined)

    if sc_idx is None:
        return clip.map_batches(stage, batch_size)
    if len(sc_idx) == 0:
        return clip
    picked = torch.cat([clip.frames[i:i + 1] for i in sc_idx])
    colored = Clip(frames=picked).map_batches(stage, batch_size).frames
    out = clip.frames.clone()
    for j, i in enumerate(sc_idx):
        out[i] = colored[j]
    return clip.with_frames(out)


def _chroma_resize_clip(hires: Clip, lowres: Clip, batch_size: int = 8) -> Clip:
    """Spline64 chroma restore of ``lowres`` onto ``hires``'s luma."""
    a, b = hires.frames, lowres.frames
    out = torch.cat([filters.chroma_resize_restore(a[s:s + batch_size], b[s:s + batch_size])
                     for s in range(0, hires.num_frames, batch_size)], dim=0)
    return hires.with_frames(out).copy_sc_from(lowres)


def stabilizer(clip: Clip, dark: bool = False, dark_p=(0.2, 0.8), smooth: bool = False,
               smooth_p=(0.3, 0.7, 0.9, 0.0, "none"), colormap: str = "none",
               stab: bool = False, stab_p=(5, "A", 1, 15, 0.2, 0.8), deflicker: bool = True,
               render_factor: int = 24, batch_size: int = 8) -> Clip:
    """``HAVC_stabilizer``: at chroma resolution the post chain (dark
    tweak, chroma smoothing, colormap) when both tweaks are on, else the
    colormap alone; the temporal chroma stabilizer and deflicker; then the
    full-resolution luma restored."""
    clip_orig = clip
    frame_size = min(render_factor * 16, clip.width)
    x = clip.map_batches(
        lambda f: torch.clamp(resize(f, frame_size, frame_size, "spline64"), 0.0, 1.0),
        batch_size,
    )
    cmap_l = (colormap or "none").lower()
    fused = dark and smooth
    if fused:
        cmap_ranges, cmap_hue, cmap_sat, cmap_w = (), 0.0, 1.0, 0.0
        if cmap_l not in ("none", ""):
            cmap_str = presets.get_colormap(cmap_l, "light") if "->" in cmap_l else cmap_l
            pa = chroma_ops.parse_hue_adjust(cmap_str)
            if pa is not None:
                cmap_ranges, cmap_sat, cmap_hue, cmap_w = (
                    pa.ranges, pa.sat, float(pa.hue), pa.weight
                )
        x = x.with_frames(post_chain(
            x.frames,
            dark_thr=0.1, dark_white=min(max(dark_p[0], 0.1), 0.50),
            dark_sat=min(max(1.1 - dark_p[1], 0.10), 0.80),
            dark_bright=-min(max(dark_p[1], 0.20), 0.90),
            sm_black=smooth_p[0], sm_white=smooth_p[1],
            sm_sat=smooth_p[2], sm_bright=-smooth_p[3],
            cmap_ranges=cmap_ranges, cmap_hue_shift=cmap_hue,
            cmap_sat=cmap_sat, cmap_weight=cmap_w,
        ))
    elif dark or smooth:
        raise ValueError("stabilizer: the benchmark's settings run both tweaks or neither")
    if cmap_l not in ("none", "") and not fused:
        cmap_adjust = presets.get_colormap(cmap_l, "light") if "->" in cmap_l else cmap_l
        x = x.map_batches(lambda f: filters.colormap_filter(f, cmap_adjust), batch_size)
    if stab:
        nframes, mode, sat, tht, weight, tht_scen = stab_p[:6]
        sc = x.sc.sc_prev if x.sc is not None else None
        x = x.with_frames(temporal_ops.chroma_stabilizer(
            x.frames, nframes=nframes, weighted=(str(mode).upper() == "W"),
            scenechange=sc, sat=sat, tht=tht, weight=weight, tht_scen=tht_scen,
        ))
        if deflicker:
            x = x.with_frames(temporal_ops.reduce_flicker(x.frames, scenechange=sc))
    return _chroma_resize_clip(clip_orig, x, batch_size)


# --- ColorMNet (exemplar/__init__.py) ----------------------------------------


def pad112_geometry(wh: int, ww: int):
    """ColorMNet input geometry: padded to multiples of 112 = lcm(14, 16)
    with symmetric borders.  Returns ``(ph, pw, lh, lw, uh, uw)``."""
    ph = -(-wh // 112) * 112
    pw = -(-ww // 112) * 112
    lh, lw = (ph - wh) // 2, (pw - ww) // 2
    return ph, pw, lh, lw, ph - wh - lh, pw - ww - lw


class ColorMNetEngine:
    """One ColorMNet: its network (the registry's module, cast to
    ``dtype`` when that differs) and its memory configuration."""

    def __init__(self, config: str, work_size, dtype: torch.dtype, device):
        c = cm.COLORMNET_CONFIGS[config]
        self.device = torch.device(device)
        self.dtype = dtype
        self.key_dim, self.value_dim, self.hidden_dim = c["key_dim"], c["value_dim"], c["hidden_dim"]
        self.h, self.w = work_size
        self.g16_hw = (self.h // 16, self.w // 16)
        P = self.g16_hw[0] * self.g16_hw[1]
        if config == "micro":
            self.mem_cfg = mem.MemoryConfig(
                key_dim=self.key_dim, value_dim=self.value_dim, tokens_per_frame=P,
                max_mt_frames=3, min_mt_frames=1, num_prototypes=8, top_k=8, lt_capacity=64,
            )
        else:
            self.mem_cfg = mem.MemoryConfig(key_dim=self.key_dim, value_dim=self.value_dim,
                                            tokens_per_frame=P)
        net = engines.registry.colormnet(config, self.device)
        self.net = net if dtype == torch.float32 else copy.deepcopy(net).to(dtype)


def _lab_l3(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,1] (..., 3) -> normalised L, (L - 50) / 50, in 3 channels."""
    l = rgb_to_lab(rgb)[..., 0:1]
    return ((l - 50.0) / 50.0).expand(*l.shape[:-1], 3)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, h, w) -> (N, h*w, C)."""
    return x.flatten(2).transpose(1, 2)


def _cm_init_carry(engine: ColorMNetEngine):
    """Fresh carry: empty memory, zero hidden and short-term state, frame
    counter and last memory frame 0."""
    h16, w16 = engine.g16_hw
    kw = dict(device=engine.device, dtype=engine.dtype)
    return (mem.init_memory(engine.mem_cfg, **kw),
            torch.zeros((2, engine.hidden_dim, h16, w16), **kw),
            torch.zeros((1, engine.key_dim, h16, w16), **kw),
            torch.zeros((2, engine.value_dim, h16, w16), **kw),
            0, 0)


def _cm_prepare(engine: ColorMNetEngine, frames: torch.Tensor, ref_ab: torch.Tensor,
                ref_frames: torch.Tensor, ref_idx):
    """pad112 in normalised-LAB space, cast to the engine's dtype, and the
    batched key encoder: the per-frame inputs, the exemplars' (for
    ``ref_idx``) and the unpad geometry ``(lh, lw, fh, fw)``."""
    fh, fw = int(frames.shape[1]), int(frames.shape[2])
    lh, lw = (engine.h - fh) // 2, (engine.w - fw) // 2
    pads = (lw, engine.w - fw - lw, lh, engine.h - fh - lh)

    def l3(x):  # zeros in normalised space = L*=50, neutral ab
        return torch.nn.functional.pad(_lab_l3(x).permute(0, 3, 1, 2).to(engine.dtype), pads)

    net = engine.net

    def encode(x):
        outs = []
        for s in range(0, x.shape[0], ENC_BATCH):
            g16, g8, g4 = net.key_encoder(x[s:s + ENC_BATCH])
            outs.append((g16, g8, g4, *net.key_proj(g16)))
        return [torch.cat([o[i] for o in outs]) for i in range(6)]

    frames_l3 = l3(frames)
    rab = torch.nn.functional.pad(ref_ab.permute(0, 3, 1, 2).to(engine.dtype), pads)
    g16, g8, g4, key, shrink, sel = encode(frames_l3)
    refs_l3 = l3(torch.cat([ref_frames[i:i + 1] for i in ref_idx]))
    rg16, _, _, rkey, rshrink, rsel = encode(refs_l3)
    ref_pre = (refs_l3, rg16, rkey, rshrink, rsel, torch.cat([rab[i:i + 1] for i in ref_idx]))
    return (frames_l3, g16, g8, g4, key, shrink, sel, rab), ref_pre, (lh, lw, fh, fw)


def _build_cm_step(engine: ColorMNetEngine, vivid: bool, frame_propagate: bool):
    """The per-frame InferenceCore step ``step(carry, x, ref, reset) ->
    (carry, ab)``; every branch is taken on the host from the flags and the
    carry's frame counters."""
    cfg = engine.mem_cfg
    h16, w16 = engine.g16_hw
    P, Cv = h16 * w16, engine.value_dim
    net = engine.net
    exemplar_insert = (not frame_propagate) or vivid

    def tok(x):  # (1, C, h, w) -> (P, C)
        return _tokens(x)[0]

    def step(carry, x, ref, reset):
        frame_l3, g16, g8, g4, key, shrink, sel, rab, ref_flag = x
        if vivid and reset:  # the whole InferenceCore is rebuilt
            carry = _cm_init_carry(engine)
        state, hidden, last_key, last_value, frame_idx, last_mem_t = carry
        qk, qe = tok(key), tok(sel)
        is_mem = ref_flag or frame_idx - last_mem_t >= cfg.mem_every
        exem = ref_flag and exemplar_insert
        is_deep = is_mem and not exem
        normal_upd = not is_mem

        if exem:  # insert the exemplar's own key and value first
            ref_l3, rg16, rkey, rshrink, rsel, ref_rab = ref
            rvalue, _ = net.value_encoder(ref_l3, rg16, torch.zeros_like(hidden), ref_rab,
                                          deep_update=False)
            state = mem.insert_working(state, cfg, tok(rkey), rshrink.reshape((P,)),
                                       tok(rsel), _tokens(rvalue).reshape((2, P, Cv)), True)
            last_key, last_value, last_mem_t = rkey, rvalue, frame_idx

        seg_ran = exemplar_insert or (frame_idx > 0 and not ref_flag)
        mem_read, state = mem.read_memory(state, cfg, qk, qe, update_usage=seg_ran)
        readout = mem_read.transpose(-1, -2).reshape(2, Cv, h16, w16)
        if not exem:  # the short-term read is skipped on exemplar inserts
            short = net.short_term_attn(key, last_key, last_value.reshape(1, 2 * Cv, h16, w16))
            readout = readout + short.reshape(2, Cv, h16, w16)

        hidden_dec, logits = net.decoder(g16, g8, g4, hidden, readout)
        if ref_flag and not exemplar_insert:
            ab = rab
        else:
            ab = torch.tanh(logits)[:, 0].reshape((1, 2) + logits.shape[-2:])
        h1 = hidden_dec if (seg_ran and normal_upd) else hidden

        hidden = h1
        if is_mem:  # encode the current frame with its ab and insert it
            value16, hidden_reinf = net.value_encoder(frame_l3, g16, h1, ab)
            if is_deep:
                hidden = hidden_reinf
            state = mem.insert_working(state, cfg, qk, shrink.reshape((P,)), qe,
                                       _tokens(value16).reshape((2, P, Cv)), True)
            last_key, last_value, last_mem_t = key, value16, frame_idx
        return (state, hidden, last_key, last_value, frame_idx + 1, last_mem_t), ab[0]

    return step


def colormnet_propagate(engine: ColorMNetEngine, frames: torch.Tensor, ref_ab: torch.Tensor,
                        is_ref: np.ndarray, ref_frames: torch.Tensor,
                        frame_propagate: bool = True, vivid: bool = False) -> torch.Tensor:
    """The clip through the memory network, frame by frame: (T, H, W, 2)
    normalised ab, float32."""
    is_ref = np.asarray(is_ref).astype(bool)
    exemplar_insert = (not frame_propagate) or vivid
    if not exemplar_insert:
        raise ValueError("colormnet_propagate: the benchmark's settings insert exemplars")
    ref_idx = np.nonzero(is_ref)[0]
    ref_pos = {int(t): j for j, t in enumerate(ref_idx)}
    step = _build_cm_step(engine, vivid, frame_propagate)
    precision = (engine_precision(engine.device) if engine.dtype == torch.float32
                 else contextlib.nullcontext())
    with torch.inference_mode(), precision:
        xs, ref_pre, (lh, lw, fh, fw) = _cm_prepare(engine, frames, ref_ab, ref_frames, ref_idx)
        carry = _cm_init_carry(engine)
        outs = []
        for t in range(len(is_ref)):
            r = ref_pos.get(t)
            ref = None if r is None else tuple(a[r:r + 1] for a in ref_pre)
            carry, ab = step(carry, tuple(a[t:t + 1] for a in xs) + (bool(is_ref[t]),), ref,
                             bool(is_ref[t]))
            outs.append(ab)
        return torch.stack(outs).permute(0, 2, 3, 1)[:, lh:lh + fh, lw:lw + fw].float()


def _prefilter_refs(ref_frames: torch.Tensor, colormap: str, batch_size: int) -> torch.Tensor:
    """Reference-frame pre-filters: dark tweak (0.2, 0.8), chroma smoothing
    (0.3, 0.7, 0.9, 0.0), the colormap."""
    cmap = presets.get_colormap(colormap, "light") if "->" in colormap else colormap

    def prefilter(x):
        x = filters.dark_tweak(x, dark_threshold=0.2, dark_amount=0.8)
        x = filters.chroma_bright_tweak(x, black_threshold=0.3, white_threshold=0.7,
                                        dark_sat=0.9, dark_bright=-0.0)
        if colormap not in ("none", ""):
            x = filters.colormap_filter(x, cmap)
        return x

    return torch.cat([prefilter(ref_frames[s:s + batch_size])
                      for s in range(0, ref_frames.shape[0], batch_size)])


def deepex_colormnet(clip: Clip, clip_ref: Clip, colormap: str, config: str,
                     cm_dtype: torch.dtype, batch_size: int = 8) -> Clip:
    """``HAVC_deepex`` method 0 with ColorMNet, vivid, at render speed
    Medium: the references are the scene changes of ``clip_ref``."""
    is_ref = clip_ref.sc.sc_prev.astype(bool).copy()
    if len(is_ref) and not is_ref[0]:
        is_ref[0] = True
    ref_frames = _prefilter_refs(clip_ref.frames, colormap, batch_size)
    wh, ww = DEEPEX_SIZES["medium"]
    work_frames, pad_meta = smart_resize_pad(clip.frames, wh, ww, "spline64")
    work_refs = smart_resize_pad(ref_frames, wh, ww, "spline64")[0]
    ph, pw = pad112_geometry(wh, ww)[:2]
    engine = ColorMNetEngine(config, (ph, pw), cm_dtype, clip.frames.device)
    ref_ab = torch.clamp(rgb_to_lab(work_refs)[..., 1:3] / 110.0, -1.0, 1.0)
    ab = colormnet_propagate(engine, work_frames, ref_ab, is_ref, work_refs,
                             frame_propagate=True, vivid=True)
    lab = torch.cat([rgb_to_lab(work_frames)[..., 0:1], ab * 110.0], dim=-1)
    colored_small = torch.clamp(lab_to_rgb(lab), 0.0, 1.0)
    outs = [filters.recover_clip_luma(clip.frames[s:s + batch_size],
                                      smart_resize_restore(colored_small[s:s + batch_size],
                                                           pad_meta))
            for s in range(0, clip.num_frames, batch_size)]
    return clip.with_frames(torch.cat(outs)).with_sc(clip_ref.sc)


# --- HAVC_main ---------------------------------------------------------------


@torch.inference_mode()
def havc_main(clip: Clip, exemplar: bool = False, engine_config: str = "full",
              cm_dtype: Optional[torch.dtype] = None, batch_size: int = 8) -> Clip:
    """``HAVC_main(clip)`` with its defaults, or with ``EnableDeepEx=True``
    (method 0, ColorMNet ``engine_config``, ``ScThreshold`` 0.10): a clip of
    float32 RGB frames on one device, colorized there.  ``cm_dtype`` is
    ColorMNet's dtype (float32 when None)."""
    speed_id, deoldify_rf, ddcolor_rf = presets.get_render_factors("Medium")
    mweight = presets.get_mweight("Stable")
    do_model, dd_model, dd_method = presets.get_color_model("Video+Artistic")
    if dd_method == 2:
        dd_method = presets.get_comb_method("Simple")
    dd_tweak, hue_range, _, chroma_adjust, chroma_adjust2 = presets.get_color_tune(
        "Light", "Magenta/Violet", "None", dd_model)
    colorize = dict(method=dd_method, mweight=mweight,
                    deoldify_p=(do_model, deoldify_rf, 1.0, 0.0),
                    ddcolor_p=(dd_model, ddcolor_rf, 1.0, 0.0, True),
                    ddtweak=tuple(dd_tweak), ddtweak_p=(DEF_TWEAK_p, hue_range),
                    batch_size=batch_size)
    if not exemplar:
        colored = colorizer(clip, **colorize)
        return stabilizer(colored, dark=True, dark_p=(0.2, 0.8), colormap=chroma_adjust,
                          smooth=True, smooth_p=(0.3, 0.7, 0.9, 0.0, "none"),
                          stab=dd_method != 0, stab_p=(5, "A", 1, 15, 0.2, 0.8),
                          render_factor=min(deoldify_rf, ddcolor_rf), batch_size=batch_size)
    clip_ref = colorizer(clip, sc_threshold=0.10, **colorize)
    colored = deepex_colormnet(clip, clip_ref, chroma_adjust, engine_config,
                               cm_dtype or torch.float32, batch_size)
    colored = stabilizer(colored, stab=True, stab_p=(3, "A", 1, 0, 0, 0),
                         colormap=chroma_adjust2, render_factor=min(deoldify_rf, ddcolor_rf),
                         batch_size=batch_size)
    sc = colored.sc.sc_prev if colored.sc is not None else None
    return colored.with_frames(temporal_ops.reduce_flicker(colored.frames, scenechange=sc))
