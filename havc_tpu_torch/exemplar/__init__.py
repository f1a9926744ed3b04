"""Exemplar-based colorization: the ColorMNet, Deep-Exemplar and
DeepRemaster engines and their API.

Port of ``havc_tpu.exemplar``: reference frames (HAVC-colorized scene
changes, a directory of images or an external colored video) propagate
their color through the clip by one of three engines.

ColorMNet (``ex_model`` 0) propagates by its memory network.  ``colormnet_propagate`` runs the key encoder batched over
the clip, then one step per frame: memory readout, local window attention
(the CUDA kernel on the card), decoder, gated value encoder and memory
insert.  Everything the JAX scan decides with ``lax.cond`` from the
reference flags, the all-refs schedules and the frame counter (memory
cadence, exemplar inserts, deep updates, the vivid reset) is decided here
on the host before any device work is queued, so the loop never waits for
the card.  On the card each of those plans of a step runs as a replay of
a CUDA graph captured at its first step, over the engine's own carry.

Deep-Exemplar (``ex_model`` 1, ``deepex_propagate``) pins each scene's
reference and last prediction, so every frame of a scene is independent:
the reference is encoded once per scene and the frames run in batches
(VGG19, WarpNet's correlation, ColorVidNet), then the WLS smoother
(``ops/fgs.py``) over the whole clip.  DeepRemaster (``ex_model`` 2,
``remaster_propagate``) colorizes windows of ``length`` frames with
NetworkC against a sliding window of ``ref_buffer_size`` references, at
its own /16 geometry (``remaster_work_shape``).  The hybrid (``ex_model``
3) blends ColorMNet with a vivid DeepEx.  Scene bounds, batches, window
starts and the reference cache are decided on the host from numpy.

ColorMNet and DeepRemaster run in the engine's ``dtype``: by default
bfloat16 on the card and float32 on the CPU, as the JAX package runs them
in bf16 on its accelerator (``device.type == "cuda"`` stands for its
``jax.default_backend() == "tpu"``).  The engine casts its network's
float tensors once; the propagations cast their inputs at the engine's
door and return float32.  Deep-Exemplar stays float32, as in the JAX
package.  A float32 network runs inside ``utils.precision.engine_precision``
(TF32 on the card unless the caller set PyTorch's flags to IEEE); a bf16
one runs its products in bf16, or at IEEE float32 where pinned.

In vivid mode every reference rebuilds ColorMNet's core, so the scenes
are independent: ``colormnet_propagate_scenes`` runs them all in one step
per frame of the longest scene (``HAVC_deepex(scene_parallel=True)``).
A ``parallel.Mesh`` splits the scenes, DeepEx's frame batches or
DeepRemaster's window groups over its ``data`` axis (``mesh=``), the
networks replicated on each device.

Entry points: ``HAVC_deepex`` (methods 0-6), ``HAVC_cmnet2``,
``HAVC_restore_video`` and ``HAVC_DeepRemaster``, with ref-merge
(``ref_merge`` 1-5), reference directories (``sc_framedir``, the
``only_ref_frames`` export) and the all-refs encode modes 2/3
(``exemplar/allrefs.py``).
"""
from __future__ import annotations

import contextlib
import copy
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..clip import Clip, SceneFlags
from ..engines import registry
from ..filters import chroma_bright_tweak, colormap_filter, dark_tweak, recover_clip_luma
from ..io.video import export_reference_frames, read_reference_dir
from ..models import colormnet as cm
from ..models import deepex as dx
from ..models import memory as mem
from ..ops.chroma import chroma_tweak
from ..ops.colorspace import lab_to_rgb, luma, rgb_to_lab
from ..ops.fgs import fgs_smooth_ab
from ..ops.resize import resize, smart_resize_pad, smart_resize_restore
from ..presets import get_colormap
from ..scene.detect import scene_detect
from ..utils.log import HAVC_LogMessage, MessageType
from ..utils.precision import engine_precision
from ..utils.profiling import count, counters, host_read, resolve_device, stage_timer
from .allrefs import allrefs_feed_schedule, allrefs_step_schedule

__all__ = [
    "HAVC_deepex",
    "HAVC_cmnet2",
    "HAVC_restore_video",
    "HAVC_DeepRemaster",
    "ColorMNetEngine",
    "DeepExEngine",
    "RemasterEngine",
    "colormnet_propagate",
    "colormnet_propagate_scenes",
    "deepex_propagate",
    "remaster_propagate",
    "resolve_engine_config",
    "smart_resize_shape",
    "remaster_work_shape",
    "pad112_geometry",
]

ENC_BATCH = 8  # frames per batched key-encoder call

# DeepExRefMerge / ref_merge level -> weight of the reference in the blend
REFMERGE_WEIGHT = [0.0, 0.3, 0.4, 0.5, 0.6, 0.7]

# vivid tweaks: DeepRemaster's pre-tweak on the references (hue +3, sat
# x1.30) and post-tweak on its output (hue +5, sat x1.15)
DEF_VIVID_HUE_LOW = 3.0
DEF_VIVID_SAT_HIGH = 1.30
DEF_VIVID_HUE_HIGH = 5.0
DEF_VIVID_SAT_LOW = 1.15


def resolve_engine_config(requested: Optional[str] = None) -> str:
    """``None``/"auto" -> "full" when a converted ColorMNet checkpoint
    (``<weights_dir>/colormnet.npz``) is configured, else the dev-scale
    "micro"; an explicit "micro" beside converted weights warns."""
    has_weights = registry.checkpoint("colormnet.npz") is not None
    if requested in (None, "auto"):
        return "full" if has_weights else "micro"
    if requested == "micro" and has_weights:
        warnings.warn(
            "HAVC: engine_config='micro' ignores the converted ColorMNet checkpoint in the "
            "configured weights_dir; pass 'full' (or leave unset) to use it"
        )
    return requested


def smart_resize_shape(width: int, height: int, speed: str = "medium"):
    """SmartResize working size of a render speed: (H, W)
    (``models.deepex.get_deepex_size``)."""
    return dx.get_deepex_size(speed)


def remaster_work_shape(width: int, height: int, frame_mindim: int = 320):
    """DeepRemaster's working geometry (H, W): scaled so that the smaller
    side is ``frame_mindim``, then each side rounded to a multiple of 16
    (NetworkC's decoder joins a 2x-upsampled 1/16 feature with the 1/8
    one, so both sides must divide by 16; the DeepEx sizes do not)."""
    minwh = min(width, height)
    scale = 1.0 if minwh == frame_mindim else frame_mindim / minwh
    fw = max(round(width * scale / 16.0), 1) * 16
    fh = max(round(height * scale / 16.0), 1) * 16
    return fh, fw


def _engine_dtype(dtype, device: torch.device) -> torch.dtype:
    """``None`` -> bfloat16 on a CUDA device, float32 elsewhere."""
    if dtype is None:
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    return dtype


def _cast_net(net: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """The registry's float32 module itself, or a copy with its float
    parameters and buffers cast to ``dtype`` (the registry's stays
    float32 for other engines)."""
    return net if dtype == torch.float32 else copy.deepcopy(net).to(dtype)


def _float32_precision(engine):
    """``engine_precision`` for an engine whose network runs float32; a
    bf16 network's products are bf16 or pinned to IEEE float32."""
    if getattr(engine, "dtype", torch.float32) == torch.float32:
        return engine_precision(engine.device)
    return contextlib.nullcontext()


def pad112_geometry(wh: int, ww: int):
    """ColorMNet input geometry: padded to multiples of 112 = lcm(14, 16)
    with symmetric borders so the DINOv2 1/14 and ResNet 1/16 grids align.
    Returns ``(ph, pw, lh, lw, uh, uw)``."""
    ph = -(-wh // 112) * 112
    pw = -(-ww // 112) * 112
    lh, lw = (ph - wh) // 2, (pw - ww) // 2
    return ph, pw, lh, lw, ph - wh - lh, pw - ww - lw


class ColorMNetEngine:
    """One ColorMNet instance: its network on ``device`` in ``dtype`` and
    its memory configuration.  ``config="micro"`` is the test scale,
    ``"full"`` the published geometry (ResNet50 + DINOv2-S/14, Ck 64, Cv
    512).  ``dtype=None`` is bfloat16 on a CUDA device and float32 on the
    CPU; pass ``torch.float32`` for float32 on the card."""

    def __init__(self, config: str = "full", work_size=(224, 384), dtype=None,
                 max_mem: int = 0, device=None):
        c = cm.COLORMNET_CONFIGS[config]
        self.cfg_name = config
        self.device = resolve_device(device)
        self.dtype = _engine_dtype(dtype, self.device)
        self.key_dim, self.value_dim, self.hidden_dim = c["key_dim"], c["value_dim"], c["hidden_dim"]
        self.h, self.w = work_size
        self.g16_hw = (self.h // 16, self.w // 16)
        P = self.g16_hw[0] * self.g16_hw[1]
        if config == "micro":
            self.mem_cfg = mem.MemoryConfig(
                key_dim=self.key_dim, value_dim=self.value_dim, tokens_per_frame=P,
                max_mt_frames=3, min_mt_frames=1, num_prototypes=8, top_k=8,
                lt_capacity=int(max_mem) if max_mem > 0 else 64,
            )
        else:
            # max_mem > 0 bounds the long-term store (max_long_term_elements)
            self.mem_cfg = mem.MemoryConfig(
                key_dim=self.key_dim, value_dim=self.value_dim, tokens_per_frame=P,
                **({"lt_capacity": int(max_mem)} if max_mem > 0 else {}),
            )
        if config == "full" and registry.checkpoint("colormnet.npz") is None \
                and registry.weights_dir is not None:
            warnings.warn("ColorMNet engine: weights_dir is set but no converted checkpoint "
                          "(colormnet.npz) was found; random init")
        self.net = _cast_net(registry.colormnet(config, self.device), self.dtype)
        # the frame loop's own carry and its captured step graphs, made on
        # the first ``colormnet_propagate`` that needs them
        self.carry = None
        self.step_graphs = None


def _lab_l3(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,1] (..., 3) -> normalised L, (L - 50) / 50, in 3 channels."""
    l = rgb_to_lab(rgb)[..., 0:1]
    return ((l - 50.0) / 50.0).expand(*l.shape[:-1], 3)


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, h, w) -> (N, h*w, C)."""
    return x.flatten(2).transpose(1, 2)


def _cm_init_carry(engine: ColorMNetEngine, scenes: Optional[int] = None):
    """Fresh carry in the engine's dtype: empty memory, zero hidden and
    short-term state, frame counter and last memory frame 0; ``scenes`` S
    batches every device part over a leading scene axis (the hidden and
    short-term values are scene-major: scene s's objects at rows 2s,
    2s + 1)."""
    h16, w16 = engine.g16_hw
    kw = dict(device=engine.device, dtype=engine.dtype)
    b = 1 if scenes is None else scenes
    return (mem.init_memory(engine.mem_cfg, scenes=scenes, **kw),
            torch.zeros((2 * b, engine.hidden_dim, h16, w16), **kw),
            torch.zeros((b, engine.key_dim, h16, w16), **kw),
            torch.zeros((2 * b, engine.value_dim, h16, w16), **kw),
            0, 0)


def _cm_clear_device(carry) -> None:
    """The device part of ``carry`` refilled in place with
    ``_cm_init_carry``'s values."""
    state, hidden, last_key, last_value = carry[:4]
    mem.clear_device(state)
    for t in (hidden, last_key, last_value):
        t.zero_()


def _cm_owned_carry(engine: ColorMNetEngine):
    """The engine's own carry, emptied in place (made on first use): the
    storage every call without ``resume_state`` or ``return_state`` runs
    on, and the step graphs read and write, so an engine runs one such
    call at a time."""
    if engine.carry is None:
        engine.carry = _cm_init_carry(engine)
    else:
        mem.clear_host(engine.carry[0])
        _cm_clear_device(engine.carry)
    engine.carry = engine.carry[:4] + (0, 0)
    return engine.carry


def _cm_prepare(engine: ColorMNetEngine, frames: torch.Tensor, ref_ab: torch.Tensor,
                ref_frames: torch.Tensor, ref_idx):
    """pad112 in normalised-LAB space, cast to the engine's dtype, and the
    batched key encoder.

    Returns the per-frame inputs (NCHW with leading T), the exemplars'
    (only for the reference frames ``ref_idx``, in that order, or None)
    and the unpad geometry ``(lh, lw, fh, fw)``."""
    fh, fw = int(frames.shape[1]), int(frames.shape[2])
    if fh > engine.h or fw > engine.w:
        raise ValueError(f"frames {fh}x{fw} exceed engine work size {engine.h}x{engine.w}"
                         " - size the engine with pad112_geometry(h, w)")
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
    with stage_timer("cm_key_encoder"):
        g16, g8, g4, key, shrink, sel = encode(frames_l3)
        ref_pre = None
        if ref_idx is not None and len(ref_idx):
            refs_l3 = l3(torch.cat([ref_frames[i:i + 1] for i in ref_idx]))
            rg16, _, _, rkey, rshrink, rsel = encode(refs_l3)
            ref_pre = (refs_l3, rg16, rkey, rshrink, rsel,
                       torch.cat([rab[i:i + 1] for i in ref_idx]))
    return (frames_l3, g16, g8, g4, key, shrink, sel, rab), ref_pre, (lh, lw, fh, fw)


class _StepPlan(NamedTuple):
    """The host's decisions of one frame step, taken from the reference
    flags and the carry's counters before any of its device work: the key
    of its captured graph."""

    reset: bool  # a vivid rebuild of the core comes first
    ref: bool  # the frame is a reference
    is_mem: bool  # the frame is encoded and inserted into the memory
    seg_ran: bool  # the readout counts its matches (usage)
    exem_full: bool  # the exemplar's insert fills the working store: consolidate
    frame_full: bool  # the frame's insert fills it: consolidate


# the most plans one (engine, vivid, frame_propagate) can meet (see
# ``_build_cm_step``); ``_StepGraphs`` refuses a plan past it
MAX_STEP_PLANS = 14


class _CMStep(NamedTuple):
    """A frame step in two parts: ``plan(carry, ref_flag, reset) -> (plan,
    carry)`` takes every decision and keeps the host's counters, ``run(carry,
    x, ref, plan) -> ab`` queues the device work, in place on the carry's
    tensors."""

    plan: Callable
    run: Callable


def _build_cm_step(engine: ColorMNetEngine, vivid: bool, frame_propagate: bool,
                   scenes: Optional[int] = None) -> _CMStep:
    """The per-frame InferenceCore step (``_CMStep``): ``ref_flag`` says
    whether the frame is a reference, ``reset`` whether a vivid run
    rebuilds the core first; ``x`` holds the frame's precomputed inputs,
    ``ref`` the exemplar's (or None); ``ab`` is the (2, H, W) prediction.
    Every branch is taken on the host from the flags and the carry's frame
    counters.

    The step updates the carry's tensors in place and never replaces one
    (a rebuild refills them), so a captured CUDA graph of ``run`` reads and
    writes the same storage on every replay.  The plans it can meet, for
    one engine, ``vivid`` and ``frame_propagate``: with exemplar inserts
    (``vivid`` or not ``frame_propagate``) ``seg_ran`` is always set and
    a step is a reference (``exem_full``, ``frame_full`` free: 4), a
    memory frame (``frame_full`` free: 2) or neither (1), each with
    ``reset`` set or not where ``vivid``: at most 14; without them
    ``reset`` is never set, a reference has ``seg_ran`` unset (2), a
    memory frame (4) and a plain frame (2) have it either way: at most 8.

    ``scenes`` S runs S independent scenes in one step: ``x`` and ``ref``
    hold one frame per scene (leading S), the carry is
    ``_cm_init_carry(engine, S)``'s and ``ab`` is (S, 2, H, W).  The flags
    are shared: every scene is at the same step of its own scan."""
    cfg = engine.mem_cfg
    h16, w16 = engine.g16_hw
    P, Cv = h16 * w16, engine.value_dim
    net = engine.net
    exemplar_insert = (not frame_propagate) or vivid
    b = 1 if scenes is None else scenes
    lead = () if scenes is None else (scenes,)

    def tok(x):  # (b, C, h, w) -> (P, C), or (S, P, C) in a scene batch
        return _tokens(x)[0] if scenes is None else _tokens(x)

    def plan(carry, ref_flag, reset):
        count("cm_steps")
        state, hidden, last_key, last_value, frame_idx, last_mem_t = carry
        reset = vivid and reset
        if reset:  # the whole InferenceCore is rebuilt
            mem.clear_host(state)
            frame_idx = last_mem_t = 0
        is_mem = ref_flag or frame_idx - last_mem_t >= cfg.mem_every
        # the exemplar's own key and value go in first
        exem_full = ref_flag and exemplar_insert and mem.note_insert(state, cfg)
        # a match counts (usage) on every step in exemplar mode, else off
        # reference frames and after the first frame
        seg_ran = exemplar_insert or (frame_idx > 0 and not ref_flag)
        frame_full = is_mem and mem.note_insert(state, cfg)
        if is_mem:
            last_mem_t = frame_idx
        return (_StepPlan(reset, ref_flag, is_mem, seg_ran, exem_full, frame_full),
                (state, hidden, last_key, last_value, frame_idx + 1, last_mem_t))

    def run(carry, x, ref, p):
        frame_l3, g16, g8, g4, key, shrink, sel, rab = x
        if p.reset:
            _cm_clear_device(carry)
        state, hidden, last_key, last_value = carry[:4]
        qk, qe = tok(key), tok(sel)
        exem = p.ref and exemplar_insert
        # deep update on every memory frame except exemplar inserts; the
        # decoder's hidden is kept only off memory frames
        is_deep = p.is_mem and not exem
        normal_upd = not p.is_mem

        if exem:  # insert the exemplar's own key and value first
            ref_l3, rg16, rkey, rshrink, rsel, ref_rab = ref
            rvalue, _ = net.value_encoder(ref_l3, rg16, torch.zeros_like(hidden), ref_rab,
                                          deep_update=False)
            mem.write_working(state, cfg, tok(rkey), rshrink.reshape(lead + (P,)), tok(rsel),
                              _tokens(rvalue).reshape(lead + (2, P, Cv)), p.exem_full)
            last_key, last_value = rkey, rvalue

        mem_read, state = mem.read_memory(state, cfg, qk, qe, update_usage=p.seg_ran)
        readout = mem_read.transpose(-1, -2).reshape(2 * b, Cv, h16, w16)
        if not exem:  # the short-term read is skipped on exemplar inserts
            short = net.short_term_attn(key, last_key, last_value.reshape(b, 2 * Cv, h16, w16))
            readout = readout + short.reshape(2 * b, Cv, h16, w16)

        hidden_dec, logits = net.decoder(g16, g8, g4, hidden, readout)
        if p.ref and not exemplar_insert:
            ab = rab
        else:
            ab = torch.tanh(logits)[:, 0].reshape((b, 2) + logits.shape[-2:])
        h1 = hidden_dec if (p.seg_ran and normal_upd) else hidden

        hidden = h1
        if p.is_mem:  # encode the current frame with its ab and insert it
            value16, hidden_reinf = net.value_encoder(frame_l3, g16, h1, ab)
            if is_deep:
                hidden = hidden_reinf
            mem.write_working(state, cfg, qk, shrink.reshape(lead + (P,)), qe,
                              _tokens(value16).reshape(lead + (2, P, Cv)), p.frame_full)
            last_key, last_value = key, value16
        # the new hidden and short-term state into the carry's own storage
        for own, new in zip(carry[1:4], (hidden, last_key, last_value)):
            if new is not own:
                own.copy_(new)
        return ab[0] if scenes is None else ab

    return _CMStep(plan, run)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    ab: torch.Tensor  # the graph's output
    launches: tuple  # (counter, launches) its capture counted


class _StepGraphs:
    """One engine's frame step as captured CUDA graphs, one a plan
    (``_StepPlan``) of each ``vivid``, ``frame_propagate``: at most
    ``MAX_STEP_PLANS`` each, decided by the flags and counters the step
    reads, never by a caller's setting.  The graphs run on the engine's own
    carry and read the frame's inputs from static buffers; they share one
    memory pool.

    A plan's first step runs eagerly (its output is the step's), then
    ``run`` is captured over the static buffers on a side stream; a
    capture queues nothing, waits for nothing (unlike ``torch.cuda.graph``,
    which synchronizes the device first) and ``run`` keeps no host state,
    so the carry is left as the eager step left it.  Every later step with
    that plan copies its inputs into the static buffers on the stream and
    replays.  The launch counters a capture counted are taken back and
    added again on each replay, as the eager step counts them."""

    def __init__(self, device: torch.device):
        self.device = device  # the engine's card, current or not
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device=device)  # captures run on it
        self.graphs = {}  # (vivid, frame_propagate, plan) -> _Graph
        self.x = self.ref = None  # the static inputs

    def step(self, step: _CMStep, key, carry, x, ref, p: _StepPlan) -> torch.Tensor:
        """The step's ``ab``; a graph's own output, valid until its next
        replay.  Captures and replays run on the engine's card, whichever
        card is current: a replay launches on the current card's stream."""
        with torch.cuda.device(self.device):
            g = self.graphs.get(key)
            if g is None:
                if sum(k[:2] == key[:2] for k in self.graphs) >= MAX_STEP_PLANS:
                    raise RuntimeError(f"ColorMNet step graphs: a plan past the "
                                       f"{MAX_STEP_PLANS} the step can meet: {key}")
                ab = step.run(carry, x, ref, p)
                self._capture(step, key, carry, x, ref, p)
                return ab
            torch._foreach_copy_(self.x, x)
            if ref is not None:
                torch._foreach_copy_(self.ref, ref)
            g.graph.replay()
        for name, n in g.launches:
            count(name, n)
        count("cm_graph_replays")
        return g.ab

    def _capture(self, step: _CMStep, key, carry, x, ref, p: _StepPlan) -> None:
        if self.x is None:
            self.x = [torch.empty_like(a) for a in x]
        if ref is not None and self.ref is None:
            self.ref = [torch.empty_like(a) for a in ref]
        before = counters()
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                ab = step.run(carry, tuple(self.x), None if ref is None else tuple(self.ref), p)
            finally:
                graph.capture_end()
        current.wait_stream(self.stream)
        launches = tuple((k, n - before.get(k, 0)) for k, n in counters().items()
                         if n != before.get(k, 0))
        for name, n in launches:  # the capture launched nothing
            count(name, -n)
        self.graphs[key] = _Graph(graph, ab, launches)
        count("cm_graph_captures")


def _host_flags(is_ref) -> np.ndarray:
    return (host_read(is_ref) if isinstance(is_ref, torch.Tensor) else np.asarray(is_ref)
            ).astype(bool)


def colormnet_propagate(
    engine: ColorMNetEngine,
    frames,  # (T, H, W, 3) RGB [0,1]; (H, W) <= engine size
    ref_ab,  # (T, H, W, 2) normalised ab in [-1, 1] (read on reference frames)
    is_ref,  # (T,) bool: reference frames
    ref_frames=None,  # (T, H, W, 3) reference RGB
    frame_propagate: bool = True,  # refs are colorized copies of the video frames
    vivid: bool = False,  # rebuild the whole memory at every reference
    resume_state=None,  # carry of a previous chunk
    return_state: bool = False,
    feed_schedule=None,  # (T,) all-refs feed order: reference frame fed at each step, -1 none
    reset_schedule=None,  # (T,) all-refs core rebuilds
):
    """Run the clip through the memory network: (T, H, W, 2) normalised ab,
    a float32 tensor on the engine's device (the network runs in the
    engine's dtype).

    The InferenceCore of the JAX package's scan, frame by frame, in sync
    mode with long-term memory on: ``frame_propagate=True`` outputs the
    reference ab on reference frames and inserts the frame with it;
    ``frame_propagate=False`` (or ``vivid``) first inserts the exemplar's
    own key and value, skips the short-term attention on that step and
    outputs the prediction.  A memory frame every ``mem_every`` frames and
    on every reference; ``vivid`` rebuilds the whole carry at each
    reference.  ``return_state`` also returns the carry, which
    ``resume_state`` continues from (the state is updated in place).

    Without either, the loop runs on the engine's own carry, emptied in
    place at the start, and on a CUDA device every step is a replay of the
    engine's captured graph of its plan (``_StepGraphs``).  The resumed
    and returned carries of the streaming paths, the scene batch
    (``colormnet_propagate_scenes``) and the CPU run the same in-place step
    eagerly.

    ``feed_schedule``/``reset_schedule`` are the all-refs mode (encode
    modes 2/3; make them with ``allrefs.allrefs_feed_schedule`` and
    ``allrefs.allrefs_step_schedule``): step ``n`` inserts reference frame
    ``feed[n]`` as an exemplar (none where -1), the core is rebuilt where
    ``reset[n]``, and ``is_ref``, ``frame_propagate`` and ``vivid`` are not
    read."""
    dev = engine.device
    frames = _as_tensor(frames, dev)
    ref_frames = frames if ref_frames is None else _as_tensor(ref_frames, dev)
    if feed_schedule is not None:
        src = np.asarray(feed_schedule, np.int64)  # the reference frame of each step
        if len(src) != len(frames):
            raise ValueError("feed_schedule length must match frames")
        reset = (np.zeros(len(src), bool) if reset_schedule is None
                 else np.asarray(reset_schedule).astype(bool))
        is_ref = src >= 0
        frame_propagate = False  # fed refs are always exemplar inserts
        vivid = bool(reset.any())  # the rebuild follows the reset flag
    else:
        is_ref = _host_flags(is_ref)
        src, reset = np.arange(len(is_ref)), is_ref
    exemplar_insert = (not frame_propagate) or vivid
    # the exemplars' own keys and values are encoded once per reference
    # frame inserted (the feed repeats frames), in one batched pass
    ref_idx = np.unique(src[is_ref]) if exemplar_insert else None
    ref_pos = ({int(t): int(np.searchsorted(ref_idx, src[t])) for t in np.nonzero(is_ref)[0]}
               if exemplar_insert else {})
    step = _build_cm_step(engine, vivid, frame_propagate)

    with torch.inference_mode(), _float32_precision(engine):
        xs, ref_pre, (lh, lw, fh, fw) = _cm_prepare(engine, frames, _as_tensor(ref_ab, dev),
                                                    ref_frames,
                                                    ref_idx)
        if resume_state is not None:
            carry = resume_state
        elif return_state:  # the caller keeps it: its own storage
            carry = _cm_init_carry(engine)
        else:
            carry = _cm_owned_carry(engine)
        graphs = None
        if dev.type == "cuda" and resume_state is None and not return_state:
            if engine.step_graphs is None:
                engine.step_graphs = _StepGraphs(dev)
            graphs = engine.step_graphs
        out = torch.empty((len(is_ref), 2, engine.h, engine.w), dtype=engine.dtype, device=dev)
        with stage_timer("cm_frame_loop"):
            for t in range(len(is_ref)):
                p, carry = step.plan(carry, bool(is_ref[t]), bool(reset[t]))
                x = tuple(a[t:t + 1] for a in xs)
                r = ref_pos.get(t)
                ref = None if r is None else tuple(a[r:r + 1] for a in ref_pre)
                if graphs is None:
                    ab = step.run(carry, x, ref, p)
                else:
                    ab = graphs.step(step, (vivid, frame_propagate, p), carry, x, ref, p)
                out[t].copy_(ab)
        ab = out.permute(0, 2, 3, 1)[:, lh:lh + fh, lw:lw + fw].float()
    if return_state:
        return ab, carry
    return ab


def _data_shards(engine, mesh):
    """``(device, engine on it)`` for each index of ``mesh``'s ``data``
    axis (its first ``model`` column), the network replicated through
    ``parallel.replicate``; without a mesh the engine alone."""
    if mesh is None:
        return [(engine.device, engine)]
    from ..parallel import replicate

    nets = replicate(engine.net, mesh)
    out = []
    for dev in mesh.data_devices():
        view = copy.copy(engine)
        view.device, view.net = dev, nets[dev]
        out.append((dev, view))
    return out


def colormnet_propagate_scenes(
    engine: ColorMNetEngine,
    frames,  # (T, H, W, 3) RGB [0,1]
    ref_ab,  # (T, H, W, 2) normalised ab (read on reference frames)
    is_ref,  # (T,) bool; is_ref[0] must be True
    ref_frames=None,
    frame_propagate: bool = True,
    mesh=None,  # parallel.Mesh: scenes split over its ``data`` axis
):
    """Vivid propagation with the scenes batched: (T, H, W, 2) normalised
    ab, a float32 tensor on the engine's device.

    In vivid mode every reference rebuilds the InferenceCore, so each
    scene (a reference and the frames up to the next) is independent.
    Instead of one step per frame of the clip, one step per frame of the
    longest scene runs every scene at once: the value encoder at batch S,
    the decoder at batch 2S, the memory readout as batched products and
    the window-attention kernel at B = S.  The scenes share the host's
    schedule of inserts (each starts with a rebuild and an exemplar insert
    of its reference), so the loop still decides every branch on the host.
    Equal to ``colormnet_propagate(..., vivid=True)`` up to the rounding of
    the batched products and the ties they can move in the top-k.

    Scenes are right-padded to the longest by repeating their last frame
    (those steps' outputs are dropped).  ``mesh`` splits the scenes over
    its ``data`` axis, the scene count padded to a multiple of it with
    copies of scene 0, the network replicated on each device; the results
    are gathered onto the engine's device with one index."""
    is_ref = _host_flags(is_ref)
    dev = engine.device
    frames = _as_tensor(frames, dev)
    T = int(frames.shape[0])
    if T == 0:
        return torch.zeros_like(_as_tensor(ref_ab, dev))
    if not is_ref[0]:
        raise ValueError("colormnet_propagate_scenes: is_ref[0] must be True (every scene "
                         "starts at a reference)")
    ref_frames = frames if ref_frames is None else _as_tensor(ref_frames, dev)
    starts = [int(i) for i in np.nonzero(is_ref)[0]]
    bounds = starts + [T]
    lengths = [b - a for a, b in zip(bounds[:-1], bounds[1:])]
    S, L = len(starts), max(lengths)
    n_data = 1 if mesh is None else int(mesh.shape.get("data", 1))
    S_pad = -(-S // n_data) * n_data
    rows = [(starts[i], lengths[i]) if i < S else (starts[0], lengths[0]) for i in range(S_pad)]

    with torch.inference_mode(), _float32_precision(engine):
        xs, ref_pre, (lh, lw, fh, fw) = _cm_prepare(engine, frames, _as_tensor(ref_ab, dev),
                                                    ref_frames, starts)
        # (L, S_pad) step-major frame index: scene i's frame min(l, len - 1),
        # made on the device (a host index would be a copy that waits)
        at = torch.arange(L, device=dev)
        flat = torch.stack([torch.clamp(at, max=ln - 1) + s0 for s0, ln in rows], dim=1)
        flat = flat.reshape(-1)
        xs = [a.index_select(0, flat).reshape((L, S_pad) + a.shape[1:]) for a in xs]
        if S_pad > S:  # padding scenes take scene 0's reference
            ref_pre = [torch.cat([a, a[:1].expand((S_pad - S,) + a.shape[1:])]) for a in ref_pre]
        n = S_pad // n_data
        shards = []
        for d, (sdev, eng) in enumerate(_data_shards(engine, mesh)):
            lo, hi = d * n, (d + 1) * n
            shards.append(dict(
                step=_build_cm_step(eng, vivid=True, frame_propagate=frame_propagate, scenes=n),
                xs=[a[:, lo:hi].to(sdev, non_blocking=True) for a in xs],
                ref=tuple(a[lo:hi].to(sdev, non_blocking=True) for a in ref_pre),
                carry=_cm_init_carry(eng, n), outs=[]))
        with stage_timer("cm_frame_loop"):
            for l in range(L):  # the shards' launches interleave, so their devices overlap
                for sh in shards:
                    p, sh["carry"] = sh["step"].plan(sh["carry"], l == 0, l == 0)
                    sh["outs"].append(sh["step"].run(sh["carry"], tuple(a[l] for a in sh["xs"]),
                                                     sh["ref"] if l == 0 else None, p))
        # (L, S_pad, H, W, 2) on the engine's device, then one gather of
        # each clip frame's (step, scene) row
        ab = torch.cat([torch.stack(sh["outs"]).to(dev, non_blocking=True) for sh in shards],
                       dim=1)
        ab = ab.permute(0, 1, 3, 4, 2)[:, :, lh:lh + fh, lw:lw + fw]
        out_idx = torch.cat([torch.arange(ln, device=dev) * S_pad + i
                             for i, ln in enumerate(lengths)])
        return ab.reshape((L * S_pad,) + ab.shape[2:]).index_select(0, out_idx).float()


# ---------------------------------------------------------------------------
# Deep-Exemplar
# ---------------------------------------------------------------------------


class DeepExEngine:
    """VGG19, WarpNet and ColorVidNet on ``device`` (the registry's
    ``deepex.npz`` when one is configured, else seeded weights), at the
    SmartResize size of ``speed``."""

    def __init__(self, speed: str = "medium", device=None):
        self.h, self.w = smart_resize_shape(0, 0, speed)
        self.device = resolve_device(device)
        net = registry.deepex(self.device)
        self.vgg, self.warp, self.color = net.vgg, net.warpnet, net.colorvid


@torch.inference_mode()
def deepex_propagate(
    engine: DeepExEngine,
    frames,  # (T, H, W, 3) RGB [0,1] at the engine's size
    refs,  # (T, H, W, 3) reference RGB (read on the reference frames)
    is_ref,  # (T,) bool
    wls_filter: bool = True,
    frame_propagate: bool = True,
    vivid: bool = False,
    batch_size: int = 4,
    mesh=None,
    temperature: float = 1e-10,
) -> torch.Tensor:
    """Reference-conditioned colorization: (T, H, W, 3) RGB in [0, 1], a
    tensor on the engine's device.

    A scene runs from each reference frame to the next (frame 0 always
    starts one).  The last prediction is pinned to the scene's
    reference LAB (``frame_propagate``) or to neutral (50, 0, 0), so the
    reference is encoded once per scene and the scene's frames run in
    batches of ``batch_size``, the last padded by repeating its final
    frame.  ``temperature`` 1e-10 (the entry points') makes the warp a hard
    argmax over the correspondences; 0.01 is the smooth softmax.
    ``vivid`` scales ab by 1.25 before the WLS smoother (``wls_filter``).
    ``mesh`` (a ``parallel.Mesh``) splits each batch's frames over its
    ``data`` axis, ``batch_size`` rounded up to a multiple of it, with the
    networks and the scene's reference features on every device; the
    results are gathered onto the engine's device."""
    dev = engine.device
    nets, devs = (engine.vgg, engine.warp, engine.color), [dev]
    on = {dev: nets}
    if mesh is not None:
        from ..parallel import replicate

        n_data = int(mesh.shape.get("data", 1))
        batch_size = -(-max(batch_size, n_data) // n_data) * n_data
        on, devs = replicate(nets, mesh), mesh.data_devices()
    per = batch_size // len(devs)
    frames, refs = _as_tensor(frames, dev), _as_tensor(refs, dev)
    T = len(frames)
    starts = list(np.nonzero(np.asarray(is_ref, bool))[0])
    if not starts or starts[0] != 0:
        starts = [0] + starts
    bounds = starts + [T]
    lab_frames = rgb_to_lab(frames)
    ab_chunks = []
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        if s1 <= s0:
            continue
        ib_lab = rgb_to_lab(refs[s0:s0 + 1])
        with engine_precision(dev):
            b_feat = dx.encode_reference(engine.vgg, engine.warp, ib_lab)
        if frame_propagate:
            last_lab = ib_lab
        else:
            last_lab = torch.cat([torch.full_like(ib_lab[..., :1], 50.0),
                                  torch.zeros_like(ib_lab[..., 1:])], dim=-1)
        ref = (ib_lab, last_lab, b_feat)
        ref_on = {dev: ref} if mesh is None else replicate(ref, mesh)
        for c0 in range(s0, s1, batch_size):
            n = min(c0 + batch_size, s1) - c0
            chunk = lab_frames[c0:c0 + n]
            if n < batch_size:
                chunk = torch.cat([chunk, chunk[-1:].expand(batch_size - n, -1, -1, -1)])
            # one slice of the batch per data shard, each on its device
            with engine_precision(dev):
                ab = [dx.frame_colorization_batched(
                    *on[d], chunk[k * per:(k + 1) * per].to(d, non_blocking=True), *ref_on[d],
                    temperature) for k, d in enumerate(devs)]
            ab = torch.cat([a.to(dev, non_blocking=True) for a in ab])
            ab_chunks.append(ab[:n])
    ab_seq = torch.cat(ab_chunks)
    if vivid:  # +25 % saturation
        ab_seq = ab_seq * 1.25
    l_seq = lab_frames[..., 0:1]
    if wls_filter:
        with stage_timer("deepex_wls"):
            ab_seq = fgs_smooth_ab(l_seq, ab_seq)
    return torch.clamp(lab_to_rgb(torch.cat([l_seq, ab_seq], dim=-1)), 0.0, 1.0)


# ---------------------------------------------------------------------------
# DeepRemaster
# ---------------------------------------------------------------------------

REMASTER_GROUP = 4  # frame windows per NetworkC forward


class RemasterEngine:
    """NetworkC on ``device`` in ``dtype`` (the registry's
    ``remaster.npz`` when one is configured, else seeded weights).
    ``frame_size`` is the work size's smaller side
    (``remaster_work_shape``).  ``dtype=None`` is bfloat16 on a CUDA
    device and float32 on the CPU; pass ``torch.float32`` for float32 on
    the card."""

    def __init__(self, frame_size: int = 320, device=None, dtype=None):
        self.size = frame_size
        self.device = resolve_device(device)
        self.dtype = _engine_dtype(dtype, self.device)
        self.model = _cast_net(registry.remaster(self.device), self.dtype)


def _remaster_window_starts(T: int, length: int, S: int, R: int, ref_positions,
                            future_frame_weight: float, frame0: int):
    """The reference window's first index for each forward position: the
    window of ``S`` of the ``R`` references advances one slot whenever the
    frame passes its past/future split (``half_idx``)."""
    half_idx = max(round(S * (1.0 - future_frame_weight)) - 1, 0)
    win_starts, ws = [], 0
    for st in range(0, T, length):
        if ref_positions is not None:
            while ws + S < R and frame0 + st > ref_positions[ws + half_idx]:
                ws += 1
        win_starts.append(ws)
    return win_starts


@torch.inference_mode()
def remaster_propagate(
    engine: RemasterEngine,
    frames,  # (T, H, W, 3) [0,1] at the work size
    ref_frames,  # (R, H, W, 3) every reference frame, in time order
    length: int = 2,
    ref_positions=None,  # (R,) frame index of each reference
    ref_buffer_size: int = 20,
    future_frame_weight: float = 0.5,
    mesh=None,
    frame0: int = 0,  # global index of frames[0] (streaming chunks)
) -> torch.Tensor:
    """Windowed NetworkC colorization: (T, H, W, 3) RGB in [0, 1], a float32
    tensor on the engine's device (the luma and the references enter
    NetworkC in the engine's dtype).

    ``length`` frames a forward against a sliding window of
    ``ref_buffer_size`` consecutive references, which advances one slot
    whenever the window's first frame passes the reference at its
    past/future split; without ``ref_positions`` the window stays on the
    first references.  ``frame0`` offsets the frames so that a streaming
    chunk replays the whole clip's schedule (``ref_positions`` are global;
    ``ref_frames`` may be a slice).  Up to ``REMASTER_GROUP`` windows that
    share a reference window run in one forward, the encoded references
    cached per window start.  Input: rec601 luma; output: LAB of (luma *
    100, clip(ab01 * 255 - 128, -100, 100)).  ``mesh`` (a
    ``parallel.Mesh``) splits each forward's windows over its ``data`` axis
    (the group rounded up to a multiple of it), with NetworkC and the
    encoded references on every device; the results are gathered onto the
    engine's device."""
    dev = engine.device
    dtype = getattr(engine, "dtype", torch.float32)  # as the JAX package reads it
    group, devs, on = REMASTER_GROUP, [dev], {dev: engine.model}
    if mesh is not None:
        from ..parallel import replicate

        n_data = int(mesh.shape.get("data", 1))
        group = -(-max(group, n_data) // n_data) * n_data
        on, devs = replicate(engine.model, mesh), mesh.data_devices()
    per = group // len(devs)
    frames, refs = _as_tensor(frames, dev), _as_tensor(ref_frames, dev)
    T, R = frames.shape[0], refs.shape[0]
    S = min(ref_buffer_size, R)
    pos = None if ref_positions is None else np.asarray(ref_positions)
    win_starts = _remaster_window_starts(T, length, S, R, pos, future_frame_weight, frame0)
    starts = list(range(0, T, length))
    l01 = luma(frames)[..., None]  # (T, H, W, 1)
    outs, ref_cache, i = [], {}, 0
    while i < len(starts):
        ws, j = win_starts[i], i
        while j < len(starts) and win_starts[j] == ws and j - i < group:
            j += 1
        if ws not in ref_cache:  # only the current window's encoding is kept
            with stage_timer("remaster_encode_refs"), _float32_precision(engine):
                window = refs[ws:ws + S].permute(3, 0, 1, 2)[None].to(dtype)
                feats = engine.model.encode_refs(window)
                ref_cache = {ws: {dev: feats} if mesh is None else replicate(feats, mesh)}
        chunks = []
        for st in starts[i:j]:
            c = l01[st:st + length]
            if c.shape[0] < length:
                c = torch.cat([c, c[-1:].expand(length - c.shape[0], -1, -1, -1)])
            chunks.append(c)
        n_real = len(chunks)
        chunks += [chunks[-1]] * (group - n_real)
        with stage_timer("remaster_windows"), _float32_precision(engine):
            batch = torch.stack(chunks).permute(0, 4, 1, 2, 3).to(dtype)  # (G, 1, T, H, W)
            ab01g = [on[d].colorize_with_refs(batch[k * per:(k + 1) * per].to(
                d, non_blocking=True), *ref_cache[ws][d]) for k, d in enumerate(devs)]
            ab01g = torch.cat([a.to(dev, non_blocking=True) for a in ab01g]).permute(0, 2, 3, 4, 1)
            ab01g = ab01g.float()
        for k in range(n_real):
            outs.append(ab01g[k][:min(length, T - starts[i + k])])
        i = j
    ab = torch.clamp(torch.cat(outs) * 255.0 - 128.0, -100.0, 100.0)
    return torch.clamp(lab_to_rgb(torch.cat([l01 * 100.0, ab], dim=-1)), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Public exemplar API
# ---------------------------------------------------------------------------

_ENGINE_CACHE: dict = {}


def _get_engine(**kw) -> ColorMNetEngine:
    key = tuple(sorted((k, str(v)) for k, v in kw.items()))
    if key not in _ENGINE_CACHE:
        _ENGINE_CACHE[key] = ColorMNetEngine(**kw)
    return _ENGINE_CACHE[key]


def _restore_full(clip: Clip, colored_small: torch.Tensor, meta, batch_size: int) -> Clip:
    """Back to the clip's geometry (resize to the padded size, crop the
    borders), then the clip's own luma under the new chroma."""
    outs = [recover_clip_luma(clip.frames[s:s + batch_size],
                              smart_resize_restore(colored_small[s:s + batch_size], meta))
            for s in range(0, clip.num_frames, batch_size)]
    return clip.with_frames(torch.cat(outs))


def _prefilter_refs(ref_frames: torch.Tensor, dark, dark_p, smooth, smooth_p, colormap,
                    batch_size: int) -> torch.Tensor:
    """Reference-frame pre-filters (dark tweak, chroma smoothing, colormap),
    ``batch_size`` frames at a time on the frames' device."""
    if not (dark or smooth or colormap not in ("none", "")):
        return ref_frames
    cmap = get_colormap(colormap, "light") if "->" in colormap else colormap

    def prefilter(x):
        if dark:
            x = dark_tweak(x, dark_threshold=dark_p[0], dark_amount=dark_p[1])
        if smooth:
            x = chroma_bright_tweak(x, black_threshold=smooth_p[0], white_threshold=smooth_p[1],
                                    dark_sat=smooth_p[2], dark_bright=-smooth_p[3])
        if colormap not in ("none", ""):
            x = colormap_filter(x, cmap)
        return x

    return torch.cat([prefilter(ref_frames[s:s + batch_size])
                      for s in range(0, ref_frames.shape[0], batch_size)])


def _vivid_tweak(frames: torch.Tensor, sat: float, hue: float, batch_size: int) -> torch.Tensor:
    """DeepRemaster's vivid tweak, ``batch_size`` frames at a time."""
    return torch.cat([chroma_tweak(frames[s:s + batch_size], sat=sat, hue=int(hue))
                      for s in range(0, frames.shape[0], batch_size)])


def _exemplar_dispatch(clip: Clip, ref_frames: torch.Tensor, is_ref: np.ndarray,
                       render_speed: str, ex_model: int, frame_propagate: bool,
                       render_vivid: bool, ref_weight: float, merge_enabled: bool, ref_merge: int,
                       max_memory_frames: int, engine_config: str, dev: torch.device,
                       use_all_refs: bool = False, frame_mindim: int = 320,
                       batch_size: int = 8, scene_parallel: bool = False, scene_mesh=None):
    """Work-size prep -> the engine of ``ex_model`` -> ref-merge blend: the
    colored frames at work size and the pad geometry.

    ColorMNet (0) and DeepEx (1) work at the SmartResize size of
    ``render_speed`` (DeepEx at its own size, spline64 there and back);
    DeepRemaster (2) at ``remaster_work_shape``, with the vivid pre-tweak
    on the references and post-tweak on its output, over a reference
    window of ``max_memory_frames`` (20 when 0); the hybrid (3) blends
    ColorMNet with a vivid DeepEx at ``max(REFMERGE_WEIGHT[ref_merge],
    0.3)``.  ``use_all_refs`` (encode modes 2/3, ColorMNet) feeds the
    scene-change references in the all-refs look-ahead order
    (``exemplar/allrefs.py``).  ``scene_parallel`` runs a vivid ColorMNet
    with more than one reference through ``colormnet_propagate_scenes``
    (over ``scene_mesh``'s ``data`` axis when given); in any other case it
    logs a warning and the sequential scan runs.  With ``merge_enabled``
    the frames that are not references are blended with their reference,
    ``color * (1 - ref_weight) + ref * ref_weight``."""
    if ex_model not in (0, 1, 2, 3):
        raise ValueError(f"HAVC_deepex: unsupported ex_model {ex_model}")
    if render_vivid and ex_model == 2:
        with stage_timer("remaster_vivid"):
            ref_frames = _vivid_tweak(ref_frames, DEF_VIVID_SAT_HIGH, DEF_VIVID_HUE_LOW,
                                      batch_size)
    if ex_model == 2:  # NetworkC needs /16 sides
        wh, ww = remaster_work_shape(clip.width, clip.height, frame_mindim)
    else:
        wh, ww = smart_resize_shape(clip.width, clip.height, render_speed)
    with stage_timer("cm_work_resize"):  # aspect-preserving SmartResize
        work_frames, pad_meta = smart_resize_pad(clip.frames, wh, ww, "spline64")
        work_refs = smart_resize_pad(ref_frames, wh, ww, "spline64")[0]

    def run_colormnet(vivid):
        # the engine runs at the pad112 geometry; propagate pads in
        # normalised-LAB space and unpads back
        ph, pw = pad112_geometry(wh, ww)[:2]
        kw = dict(config=engine_config, work_size=(ph, pw), device=dev)
        if max_memory_frames > 0:
            kw["max_mem"] = int(max_memory_frames)
        engine = _get_engine(**kw)
        ref_ab = torch.clamp(rgb_to_lab(work_refs)[..., 1:3] / 110.0, -1.0, 1.0)
        # vivid resets make the scenes independent: one step for all of them
        use_scenes = (not use_all_refs and scene_parallel and vivid and bool(is_ref[0])
                      and int(is_ref.sum()) > 1)
        if scene_parallel and not use_scenes:
            HAVC_LogMessage(
                MessageType.WARNING,
                "HAVC: scene_parallel=True requested but the scene-batched "
                "scan requires render_vivid=True, is_ref[0]=True, >1 "
                "reference and encode_mode in (0, 1) — falling back to the "
                "sequential scan",
            )
        if use_all_refs:
            eff, reset = allrefs_step_schedule(
                allrefs_feed_schedule(is_ref), vid_length=len(work_frames),
                reset_on_ref_update=vivid, max_memory_frames=max_memory_frames)
            ab = colormnet_propagate(engine, work_frames, ref_ab, is_ref, ref_frames=work_refs,
                                     feed_schedule=eff, reset_schedule=reset)
        elif use_scenes:
            ab = colormnet_propagate_scenes(engine, work_frames, ref_ab, is_ref,
                                            ref_frames=work_refs,
                                            frame_propagate=frame_propagate, mesh=scene_mesh)
        else:
            ab = colormnet_propagate(engine, work_frames, ref_ab, is_ref, ref_frames=work_refs,
                                     frame_propagate=frame_propagate, vivid=vivid)
        with stage_timer("cm_join"):
            lab = torch.cat([rgb_to_lab(work_frames)[..., 0:1], ab * 110.0], dim=-1)
            return torch.clamp(lab_to_rgb(lab), 0.0, 1.0)

    def run_deepex(vivid):
        engine = DeepExEngine(render_speed, dev)
        with stage_timer("deepex_resize"):
            dx_frames = resize(work_frames, engine.h, engine.w, "spline64")
            dx_refs = resize(work_refs, engine.h, engine.w, "spline64")
        out = deepex_propagate(engine, dx_frames, dx_refs, is_ref,
                               frame_propagate=frame_propagate, vivid=vivid)
        with stage_timer("deepex_resize"):
            return resize(out, wh, ww, "spline64")

    if ex_model == 0:
        colored_small = run_colormnet(render_vivid)
    elif ex_model == 1:
        colored_small = run_deepex(render_vivid)
    elif ex_model == 3:  # DeepEx always vivid, weighted by the ref-merge level
        a = run_colormnet(render_vivid)
        b = run_deepex(True)
        mw = max(REFMERGE_WEIGHT[ref_merge], 0.3)
        colored_small = a * (1.0 - mw) + b * mw
    else:  # the references' window slides over every scene change
        ref_pos = np.nonzero(is_ref)[0]
        colored_small = remaster_propagate(
            RemasterEngine(frame_mindim, dev), work_frames,
            torch.stack([work_refs[i] for i in ref_pos]), ref_positions=ref_pos,
            ref_buffer_size=int(max_memory_frames) if max_memory_frames > 0 else 20)
        if render_vivid:
            with stage_timer("remaster_vivid"):
                colored_small = _vivid_tweak(colored_small, DEF_VIVID_SAT_LOW,
                                             DEF_VIVID_HUE_HIGH, batch_size)
    if merge_enabled and 0.0 < ref_weight < 1.0:
        with stage_timer("cm_ref_merge"):  # the references pass through unblended
            blend = colored_small * (1.0 - ref_weight) + work_refs * ref_weight
            for t in np.nonzero(is_ref)[0]:
                blend[t] = colored_small[t]
            colored_small = blend
    return colored_small, pad_meta


def _dir_references(clip: Clip, clip_ref: Optional[Clip], dir_refs: dict, method: int) -> Clip:
    """The reference clip of ``sc_framedir`` images, each Lanczos-resized to
    the clip's size on the clip's device.  Methods 3/4 (no ``clip_ref``):
    the directory alone, on the clip's own frames; methods 1/2: the
    directory overrides and extends the HAVC references.  Methods 2 and 4
    mark the directory frames as external (``sc_next``)."""
    T, dev = clip.num_frames, clip.frames.device
    base = clip if clip_ref is None else clip_ref.to_device(dev)
    frames = base.frames.clone()
    for n, img in dir_refs.items():
        if n < T:
            frames[n] = resize(torch.from_numpy(img).to(dev), clip.height, clip.width, "lanczos")
    if clip_ref is None:
        flags = SceneFlags.from_frame_list(T, sorted(dir_refs))
        if method == 4:
            flags.sc_next[flags.sc_prev.astype(bool)] = 1
        return clip.with_frames(frames).with_sc(flags)
    flags = base.sc
    sc_prev, sc_next = flags.sc_prev.copy(), flags.sc_next.copy()
    for n in dir_refs:
        if n < T:
            sc_prev[n] = 1
            if method == 2:  # external refs propagate as exemplar inserts
                sc_next[n] = 1
    flags = SceneFlags(sc_prev=sc_prev, sc_next=sc_next, luma=flags.luma, ratio=flags.ratio,
                       threshold=flags.threshold, frequency=flags.frequency)
    return base.with_frames(frames).with_sc(flags)


@torch.inference_mode()
def HAVC_deepex(
    clip: Clip = None,
    clip_ref: Optional[Clip] = None,
    method: int = 0,
    render_speed: str = "medium",
    render_vivid: bool = True,
    ref_merge: int = 0,
    sc_framedir: Optional[str] = None,
    ref_norm: bool = False,
    only_ref_frames: bool = False,
    dark: bool = False,
    dark_p=(0.2, 0.8),
    smooth: bool = False,
    smooth_p=(0.3, 0.7, 0.9, 0.0, "none"),
    colormap: str = "none",
    ref_weight: Optional[float] = None,
    ref_thresh: Optional[float] = None,
    ref_freq: Optional[int] = None,
    ex_model: int = 0,
    encode_mode: int = 0,
    max_memory_frames: int = 0,
    torch_dir: Optional[str] = None,
    enable_resize: bool = True,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    vivid: Optional[bool] = None,
    scene_parallel: bool = False,
    scene_mesh=None,
    frame_mindim: int = 320,
    device=None,
) -> Clip:
    """Exemplar-based colorization: ``ex_model`` 0 = ColorMNet, 1 =
    Deep-Exemplar, 2 = DeepRemaster (at its /16 geometry with
    ``frame_mindim`` as the smaller side), 3 = the hybrid.

    ``method``: 0 = HAVC refs same as video, 1 = + RF same as video, 2 = +
    RF different, 3 = external RF same as video, 4 = external RF
    different, 5/6 = external ClipRef same/different (delegated to
    ``HAVC_restore_video``).  Methods 0-2 take ``clip_ref`` (HAVC-colorized,
    flags attached); with ``sc_framedir`` the directory's ``ref_nnnnnn``
    images override and extend its references (methods 1/2) or are the
    only ones (methods 3/4).  "Different" methods insert the exemplar's
    own key and value.  ``only_ref_frames`` returns the references (and
    with ``sc_framedir`` and method 0 exports them there).

    ``ref_merge`` 1-5 (references at every frame, ``sc_frequency`` 1): a
    separate scene detection of the video at ``ref_thresh``/``ref_freq``/
    ``ref_norm`` picks the propagation references, and the other frames
    are blended with their reference at ``REFMERGE_WEIGHT[ref_merge]``.
    ``encode_mode`` 2/3 feed the references in the all-refs look-ahead
    order.  ``scene_parallel`` with ``render_vivid`` runs ColorMNet's
    scenes batched (``colormnet_propagate_scenes``), over ``scene_mesh``'s
    ``data`` axis when one is given.  Same parameters and defaults as the
    JAX package's, plus ``device``."""
    del enable_resize
    if clip is None:
        raise ValueError("HAVC_deepex: clip is required")
    if vivid is not None:
        render_vivid = vivid
    if torch_dir is not None:
        from ..engines import set_weights_dir

        set_weights_dir(torch_dir)
    engine_config = resolve_engine_config(engine_config)
    if ref_merge not in range(6):
        raise ValueError("HAVC_deepex: ref_merge must be in range [0-5]")
    if ref_merge > 0 and method not in (0, 1, 5) and ex_model != 3:
        raise ValueError("HAVC_deepex: method must be in (0, 1, 5) to be used with ref_merge > 0")
    if method in (2, 6) and ref_weight is not None and ref_weight < 1.0:
        raise ValueError("HAVC_deepex: RefMerge cannot be used with method in (2, 6)")
    if encode_mode not in (0, 1, 2, 3):
        raise ValueError("HAVC_deepex: unknown encode mode: " + str(encode_mode))
    if method in (0, 1, 2) and clip_ref is None:
        raise ValueError(f"HAVC_deepex: method {method} requires clip_ref")
    if method in (3, 4) and sc_framedir is None:
        raise ValueError(f"HAVC_deepex: method {method} requires sc_framedir")
    if method in (5, 6) and clip_ref is None:
        raise ValueError(f"HAVC_deepex: method {method} requires clip_ref (external video)")
    if clip_ref is None and sc_framedir is None:
        raise ValueError("HAVC_deepex: no reference source (clip_ref/sc_framedir)")

    if method in (5, 6):  # an external colored clip
        return HAVC_restore_video(
            clip, clip_ref, method=method, render_speed=render_speed, ex_model=ex_model,
            ref_merge=ref_merge, ref_weight=ref_weight, ref_thresh=ref_thresh,
            ref_freq=ref_freq, ref_norm=ref_norm, max_memory_frames=max_memory_frames,
            render_vivid=render_vivid, encode_mode=encode_mode, engine_config=engine_config,
            batch_size=batch_size, device=device,
        )
    if clip_ref is not None and clip_ref.sc is None:
        raise ValueError(
            "HAVC_deepex: reference clip has no scene-change flags "
            "(run HAVC_colorizer with sc_threshold/sc_min_freq or HAVC_SceneDetect)"
        )
    dev = resolve_device(device)
    to_host = not clip.on_device
    clip = clip.to_device(dev)
    dir_refs = None
    if sc_framedir is not None and method in (1, 2, 3, 4):
        dir_refs = read_reference_dir(sc_framedir)
        if clip_ref is None or method in (1, 2):  # else the directory is not read
            clip_ref = _dir_references(clip, clip_ref, dir_refs, method)
    if only_ref_frames:
        if sc_framedir is not None and method == 0:
            export_reference_frames(clip_ref, sc_framedir)
        return clip_ref.to_host() if to_host else clip_ref

    # ref-merge needs references at every frame (sc_frequency 1); the
    # propagation references come from a separate detection of the video
    enable_refmerge = ref_merge > 0 and int(getattr(clip_ref.sc, "frequency", 0) or 0) == 1
    if enable_refmerge:
        if ref_weight is None:
            ref_weight = REFMERGE_WEIGHT[ref_merge]
        if ref_thresh is None:
            ref_thresh = 0.10
        if ref_freq is None or ref_freq == 1:
            ref_freq = 0
        with stage_timer("cm_scene_detect"):
            is_ref = scene_detect(clip.frames, threshold=ref_thresh, frequency=ref_freq,
                                  normalize=ref_norm, device=dev).sc_prev.astype(bool).copy()
        if dir_refs is not None and method in (1, 2):
            for n in dir_refs:
                if n < len(is_ref):
                    is_ref[n] = True
    else:
        ref_weight = 1.0
        is_ref = clip_ref.sc.sc_prev.astype(bool).copy()
    if len(is_ref) and not is_ref[0]:
        is_ref[0] = True
    with stage_timer("cm_prefilter"):
        ref_frames = _prefilter_refs(clip_ref.to_device(dev).frames, dark, dark_p, smooth,
                                     smooth_p, colormap, batch_size)
    # "same as video" methods propagate the video's own colorized frames;
    # "different" methods insert the exemplar's own key/value
    frame_propagate = method in (0, 1, 3, 5)
    if ex_model in (0, 3) and max_memory_frames > 0:
        render_vivid = False  # a bounded ColorMNet memory cannot survive resets
    colored_small, pad_meta = _exemplar_dispatch(
        clip, ref_frames, is_ref, render_speed, ex_model, frame_propagate, render_vivid,
        ref_weight, enable_refmerge, ref_merge, max_memory_frames, engine_config, dev,
        encode_mode in (2, 3), frame_mindim, batch_size, scene_parallel, scene_mesh)
    with stage_timer("cm_restore"):
        out = _restore_full(clip, colored_small, pad_meta, batch_size).with_sc(clip_ref.sc)
    return out.to_host() if to_host else out


def HAVC_cmnet2(
    clip: Clip = None,
    clip_ref: Optional[Clip] = None,
    render_speed: str = "medium",
    render_vivid: bool = True,
    ref_merge: int = 0,
    ref_norm: bool = False,
    dark: bool = False,
    dark_p=(0.2, 0.8),
    smooth: bool = False,
    smooth_p=(0.3, 0.7, 0.9, 0.0, "none"),
    colormap: str = "none",
    ref_weight: Optional[float] = None,
    ref_thresh: Optional[float] = None,
    ref_freq: Optional[int] = None,
    encode_mode: int = 0,
    max_memory_frames: int = 0,
    torch_dir: Optional[str] = None,
    device=None,
    **kwargs,
) -> Clip:
    """The second ColorMNet instance: ``HAVC_deepex`` with method 0 and
    ColorMNet, its own memory per call."""
    return HAVC_deepex(
        clip, clip_ref, method=0, render_speed=render_speed, render_vivid=render_vivid,
        ref_merge=ref_merge, ref_norm=ref_norm, dark=dark, dark_p=dark_p, smooth=smooth,
        smooth_p=smooth_p, colormap=colormap, ref_weight=ref_weight, ref_thresh=ref_thresh,
        ref_freq=ref_freq, ex_model=0, encode_mode=encode_mode,
        max_memory_frames=max_memory_frames, torch_dir=torch_dir, device=device, **kwargs,
    )


@torch.inference_mode()
def HAVC_restore_video(
    clip: Clip = None,
    clip_ref: Clip = None,
    method: int = 6,
    render_speed: str = "medium",
    ex_model: int = 0,
    ref_merge: int = 0,
    ref_weight: Optional[float] = None,
    ref_thresh: Optional[float] = None,
    ref_freq: Optional[int] = None,
    ref_norm: bool = False,
    max_memory_frames: int = 0,
    render_vivid: bool = True,
    encode_mode: int = 0,
    encode_first: bool = True,
    torch_dir: Optional[str] = None,
    engine_config: Optional[str] = None,
    batch_size: int = 8,
    frame_mindim: int = 320,
    device=None,
) -> Clip:
    """Re-colorize a B&W clip from an externally colored one: both are cut
    to the shorter length, the reference is resized (Spline36) to the
    clip's size, scene-detected, and its frames are inserted as exemplars
    (``frame_propagate=False``).  ``ref_merge`` > 0 with method 5: the
    reference stands at every frame, the detection gives the propagation
    references, and the other frames are blended with the reference at
    ``REFMERGE_WEIGHT[ref_merge]``.  ``ex_model`` picks the engine as in
    ``HAVC_deepex``; DeepRemaster takes a reference every 10 frames unless
    ``ref_freq`` says otherwise.  ``encode_first`` chose one of two
    servers in the reference implementation and changes nothing here.
    Same parameters and defaults as the JAX package's, plus ``device``."""
    del encode_first
    if clip is None or clip_ref is None:
        raise ValueError("HAVC_restore_video: clip and clip_ref are required")
    if method not in (5, 6):
        raise ValueError("HAVC: Video restore is supported only with methods: 5, 6")
    if torch_dir is not None:
        from ..engines import set_weights_dir

        set_weights_dir(torch_dir)
    engine_config = resolve_engine_config(engine_config)
    dev = resolve_device(device)
    to_host = not clip.on_device
    clip, clip_ref = clip.to_device(dev), clip_ref.to_device(dev)

    if clip_ref.num_frames != clip.num_frames:
        t = min(clip_ref.num_frames, clip.num_frames)
        clip, clip_ref = clip[:t], clip_ref[:t]
    if (clip_ref.height, clip_ref.width) != (clip.height, clip.width):
        with stage_timer("cm_ref_resize"):
            clip_ref = clip_ref.map_batches(
                lambda x: resize(x, clip.height, clip.width, "spline36"), batch_size)

    if ref_thresh is None or ref_thresh == 0:
        ref_thresh = 0.10
    if ref_freq is None or ref_freq == 0:
        ref_freq = 10 if ex_model == 2 else 0  # DeepRemaster needs periodic references
    # the propagation references come from a detection of the colored
    # reference; with ref-merge the reference's flags are every frame
    with stage_timer("cm_scene_detect"):
        detected = scene_detect(clip_ref.frames, threshold=ref_thresh, frequency=ref_freq,
                                normalize=ref_norm, device=dev)
    merge_enabled = not (ref_merge == 0 or method == 6)
    if merge_enabled:
        if ref_weight is None or ref_weight == 0:
            ref_weight = REFMERGE_WEIGHT[ref_merge]
        flags = SceneFlags.every(clip_ref.num_frames, freq=1)
    else:
        ref_weight = 1.0
        flags = detected
    is_ref = detected.sc_prev.astype(bool).copy()
    if len(is_ref) and not is_ref[0]:
        is_ref[0] = True
    clip_ref = clip_ref.with_sc(flags)
    if ex_model in (0, 3) and max_memory_frames > 0:
        render_vivid = False  # a bounded ColorMNet memory cannot survive resets

    colored_small, pad_meta = _exemplar_dispatch(
        clip, clip_ref.frames, is_ref, render_speed, ex_model, False, render_vivid, ref_weight,
        merge_enabled, ref_merge, max_memory_frames, engine_config, dev, encode_mode in (2, 3),
        frame_mindim, batch_size)
    with stage_timer("cm_restore"):
        out = _restore_full(clip, colored_small, pad_meta, batch_size).with_sc(clip_ref.sc)
    return out.to_host() if to_host else out


@torch.inference_mode()
def HAVC_DeepRemaster(
    clip: Clip,
    length: int = 2,
    render_vivid: bool = False,
    ref_dir: Optional[str] = None,
    ref_minedge: int = 256,
    frame_mindim: int = 320,
    ref_buffer_size: int = 20,
    device_index: int = 0,
    inference_mode: bool = False,
    mode: int = 0,
    clip_ref: Optional[Clip] = None,
    render_speed: str = "medium",
    device=None,
) -> Clip:
    """DeepRemaster from a folder of reference images or a colored clip.

    ``ref_dir``: the first ``ref_buffer_size`` ``ref_nnnnnn`` images,
    Lanczos-resized to the clip's size; mode 0 keeps the window on them,
    mode 1 slides it by their frame numbers.  ``clip_ref``:
    ``ref_buffer_size`` frames spread evenly over it, at their positions.
    ``length`` frames a forward (at least 2); the work geometry is
    ``remaster_work_shape`` with ``frame_mindim``; ``render_vivid`` tweaks
    the references (hue +3, sat x1.30) and the output (hue +5, sat
    x1.15).  ``ref_minedge``, ``device_index`` and ``inference_mode`` are
    accepted for the reference implementation's signature and change
    nothing.  Same parameters and defaults as the JAX package's, plus
    ``device``."""
    del device_index, inference_mode, ref_minedge, render_speed
    dev = resolve_device(device)
    to_host = not clip.on_device
    clip = clip.to_device(dev)
    ref_positions = None
    if ref_dir is not None:
        refs_map = read_reference_dir(ref_dir)
        keys = sorted(refs_map)[:max(ref_buffer_size, 1)]
        refs = torch.stack([resize(torch.from_numpy(refs_map[k]).to(dev), clip.height,
                                   clip.width, "lanczos") for k in keys])
        if mode != 0:  # the window slides by the references' frame numbers
            ref_positions = np.asarray(keys)
    elif clip_ref is not None:
        idx = np.linspace(0, clip_ref.num_frames - 1,
                          min(ref_buffer_size, clip_ref.num_frames), dtype=int)
        ref_frames = clip_ref.to_device(dev).frames
        refs = torch.stack([ref_frames[int(i)] for i in idx])
        ref_positions = idx
    else:
        raise ValueError("HAVC_DeepRemaster: ref_dir is unset")
    wh, ww = remaster_work_shape(clip.width, clip.height, frame_mindim)
    with stage_timer("cm_work_resize"):
        work_frames, pad_meta = smart_resize_pad(clip.frames, wh, ww, "spline64")
    if render_vivid:
        with stage_timer("remaster_vivid"):
            refs = _vivid_tweak(refs, DEF_VIVID_SAT_HIGH, DEF_VIVID_HUE_LOW, 8)
    with stage_timer("cm_work_resize"):
        work_refs = smart_resize_pad(refs, wh, ww, "spline64")[0]
    colored_small = remaster_propagate(RemasterEngine(frame_mindim, dev), work_frames, work_refs,
                                       length=max(2, length), ref_positions=ref_positions,
                                       ref_buffer_size=ref_buffer_size)
    if render_vivid:
        with stage_timer("remaster_vivid"):
            colored_small = _vivid_tweak(colored_small, DEF_VIVID_SAT_LOW, DEF_VIVID_HUE_HIGH, 8)
    with stage_timer("cm_restore"):
        out = _restore_full(clip, colored_small, pad_meta, 8)
    return out.to_host() if to_host else out
