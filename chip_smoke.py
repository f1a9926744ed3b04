"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``havc_tpu_torch/csrc`` (one ``nvcc``
per source, started together), then runs these phases, each printing one
JSON line; any failure exits non-zero:

1. ``device``: the card's name and power limit, torch/CUDA versions; TF32
   is switched off for matmuls and cuDNN (the JAX package computes in f32).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at its path's shape and at ragged, misaligned and odd ones, with
   CUDA-event timings (median of 10 batches of 20 calls) beside the card's
   bound and, where one PyTorch call computes the same function, that
   call's time; window attention's two launches (weights, weighted sum)
   also timed apart; the post chain's range-limited forms checked over
   every float of their ranges; window attention also at the
   scene-batched scan's B = 6.  The ``build`` line before it gives each
   kernel function's registers, stack, spills and static shared memory
   (``-Xptxas -v``) and its SASS instruction count (``cuobjdump``).
3. ``main_path``: ``havc_tpu_torch.HAVC_main(clip)`` with its defaults on a
   seeded 24-frame 1080x1920 gray clip held as CUDA tensors, with
   full-width DeOldify Video and DDColor Artistic (seeded random weights
   made on the card).  Kernel launch counts are zeroed just before the
   measured run and read just after it.
4. ``profile``: one more main-path run under ``torch.profiler``: device
   kernel time, its share of the measured wall time, the top kernels.
5. ``exemplar_path``: ``HAVC_main(clip, EnableDeepEx=True,
   engine_config="full")`` on a seeded 24-frame 1080x1920 gray clip of
   three scenes: scene detection, the classic colorizer on the three
   scene changes, the full-width ColorMNet (ResNet50 + DINOv2-S/14,
   seeded weights) through the window-attention kernel, the stabilizer;
   then its ``profile`` run.
6. ``exemplar_memory``: ``colormnet_propagate`` with the full engine over
   60 frames from one reference, so the working store fills and the
   long-term store is written on the card; it must not wait for the card
   (``torch.cuda.set_sync_debug_mode`` counts the host syncs).
7. ``parity_cpu_gpu`` (after phase 16): the test-sized main path and
   exemplar path (tiny models, render factor 4) with ``device="cpu"`` and
   on CUDA; max abs <= 1e-4.
8. ``streaming``: ``HAVC_main_streaming`` with its defaults (Medium,
   constrained-chroma, batch 8, chunk 64) and the full-width engines on a
   seeded 136-frame 1080x1920 gray ``.y4m`` (written to a temporary
   directory, no OpenCV needed), ``sink="null"``: wall time and fps of
   the second call with the transfers, the selected transfer modes, peak
   device memory, the host syncs ``torch.cuda.set_sync_debug_mode``
   reports and the event waits; ``source="device", sink="device",
   count=128`` for the compute-only rate; peak memory at 72 and 136
   frames within 2 %; a profiled run (busy share) and a stage-timed one;
   a 520-frame clip with the transfers and compute only (steady state:
   the retires overlap the card's work);
   the test-sized streaming path on the CPU and on the card, the same
   packed bytes within 1 code value.
9. ``restore_streaming``: ``streaming.HAVC_restore_video_streaming``
   (ColorMNet, ``engine_config="full"``, chunk 16, ``sink="null"``) on a
   seeded 48-frame 1080p gray ``.y4m`` and a colored reference ``.y4m`` of
   three scenes: fps, window-attention launches, peak memory, host syncs,
   the scene flags ([0, 16, 32]), and chunk 16 against chunk 48 within 1
   code value; a stage-timed run, then its profiled run.

10. ``bw_tune_memory`` (run before any model is on the card):
    ``HAVC_bw_tune`` on 8 frames of 1080x1920 with ``bw_method`` 0 (luma
    CLAHE) and 2 (CLAHE per channel): peak device memory after a reset.
11. ``placebo_path``: ``HAVC_main(clip, Preset="Placebo",
    ColorFix="Retinex/Red", BlackWhiteTune="Medium")`` on the main path's
    clip: 2x2 tiles of 594x1056 colorized at render factor 32 (512x512),
    the DDColor MSRCP prefilter, the Exploration LUT, the CLAHE BW tune at
    1080p, deflicker, one post-chain launch; then its ``profile`` run.
12. ``veryslow_path``: ``HAVC_main(clip, Preset="VerySlow",
    ColorModel="Artistic+Siggraph17", CombMethod="Chroma-Retention",
    ColorFix="None", BlackWhiteTune="Light", BlackWhiteMode=4)``:
    full-width DeOldify Artistic (with Video) and Zhang Siggraph17, the
    denoise postfilter, merge method 6, ``HAVC_ColorAdjust``'s LUT remaps,
    one post-chain launch in each pass; then its ``profile`` run.
13. ``streaming_tuned``: ``HAVC_main_streaming`` with ``BWTune="Light",
    LUT=2`` on 72 frames of the streaming phase's ``.y4m``: transfer modes
    (``gray+i420``), fps, host syncs per retired chunk, peak memory.
14. ``recolor_path``: ``HAVC_ColorAdjust(clip, engine_config="full")`` with
    its other defaults on a colored 24-frame 1080p clip of three scenes:
    ReColor (the full ColorMNet re-colors the clip from itself at
    references on every frame, ref-merge 5 at weight 0.7, the propagation
    references from a normalised scene detection), then the Light RGB
    adjust and tweak; then its ``profile`` run.
15. ``colortemp_path``: ``HAVC_main(clip, ColorTemp="Medium")`` on the
    exemplar clip: the classic engines on every frame, ``HAVC_cmnet2`` over
    references at every frame with ref-merge 3, the stabilizer with one
    post-chain launch; then its ``profile`` run.
16. ``frameinterp_path``: ``HAVC_main(clip, FrameInterp=5)``: the classic
    engines on the scene changes and every 5th frame, ColorMNet between
    them, the stabilizer with one post-chain launch.
17. ``exemplar_sources``: on a 12-frame 1080p clip of four scenes,
    ``HAVC_main(EnableDeepEx=True)`` with method 5 and ref-merge 2 from a
    colored mp4 (OpenCV writes it), method 3 from a directory written by
    ``export_reference_frames``, and the all-refs encode mode 2.
18. ``deepex_path``: ``HAVC_main(clip, EnableDeepEx=True, DeepExModel=1)``
    on the exemplar clip: the classic engines on the three references,
    Deep-Exemplar (VGG19, WarpNet, ColorVidNet: 55,024,269 parameters) at
    216x384 with the WLS smoother, the fast stabilizer; then each of
    Deep-Exemplar's convolutions on one batch through cuDNN and through
    PyTorch's own kernels (``deepex_conv_paths``), the WLS smoother alone
    on the path's 24x216x384 (its launches and device time,
    torch.profiler) and the path's ``profile`` run.
19. ``hybrid_path``: the same with ``DeepExModel=3``: the full ColorMNet
    (window attention) blended with a vivid Deep-Exemplar.
20. ``remaster_path``: ``HAVC_DeepRemaster(clip, clip_ref=<the exemplar
    clip tinted per scene>)``: 20 references, 12 windows of 2 frames at
    320x576 (NetworkC: 54,303,374 parameters); its ``profile`` run; then
    ``HAVC_main(EnableDeepEx=True, DeepExModel=2)`` on the exemplar clip.
21. ``frameinterp_deepex_path``: ``HAVC_main(clip, FrameInterp=2)``: the
    classic engines on every 2nd frame, Deep-Exemplar between, the
    stabilizer with one post-chain launch.
22. ``restore_streaming/ex_model1`` and ``/ex_model2``: the restore
    phase's 48-frame pair through Deep-Exemplar and DeepRemaster (the
    look-ahead cursor over the reference video): fps, host syncs, chunk 16
    against chunk 48 within 1 code.
23. ``scene_detectors`` (after phase 22's engines): on the exemplar clip
    as CUDA tensors, ``HAVC_SceneDetect`` (defaults: cuts [0, 8, 16]; with
    ``sc_min_int=4`` and ``sc_tht_ssim`` 0.5, which confirms no cut, and
    0.8, which confirms 8 and 16), ``HAVC_SceneDetectEdges``,
    ``HAVC_SceneDetectMotion`` and ``HAVC_extract_reference_frames(
    sc_algo=2)`` into a temporary directory: cuts, wall time of a second
    call, host syncs of a third; the same detector on the CPU from numpy
    gives the same flags, lumas and ratios within 1e-4, the same
    confirmation decisions, and each candidate's SSIM and histogram scores
    within 1e-4 (printed beside their thresholds);
    ``StreamSceneDetector`` fed chunks of 5 gives the whole-clip flags.
24. ``overlay_degrain``: ``HAVC_clip_overlay`` (mode overlay, a 540x960
    overlay at x=100, y=50, a mask, opacity 0.7) and ``HAVC_degrain`` at
    strengths 1 and 3 on the main path's clip: wall time, fps, peak
    memory and kernel launches (none) of a timed call after a warm-up;
    both CPU against card at 6x48x64 (1e-4).
25. ``restore_format`` (right after phase 3, on its output):
    ``io.write_video_y4m`` (BT.709 limited 4:2:0, Floyd-Steinberg in the
    native library built with ``g++``): the device part and the host
    dither timed apart, the file read back by ``Y4MReader`` equal to the
    planes written, the round trip's PSNR, at most 1 code against the
    same write from the CPU's float planes, which are within 1e-3 code of
    the card's.
26. ``legacy_paths``: ``ddeoldify_main(clip)`` at 1080p (the Fast
    stabilizer: no post-chain launch), ``ddeoldify_stabilizer(clip,
    dark=True, smooth=True)`` (one post-chain launch) and
    ``HAVC_cmnet(clip, clip_ref)`` on the exemplar clip (the full
    ColorMNet, 21 window-attention calls); at test size (after phase 7's
    parity) ``HAVC_ddeoldify`` and ``HAVC_cmnet`` bit-identical to the
    calls they forward to.
27. ``metrics``: ``metrics.compare_clip`` of the test-sized main path's
    card output against its CPU output, and ``ciede2000`` on 10^6 seeded
    LAB pairs (achromatic and opposite-hue ones among them) on the card
    against the CPU within 1e-4 (random pairs within 1e-3 degrees of a
    180-degree hue difference, where the mean hue's branch flips on
    rounding, counted apart).
28. ``scene_parallel_path`` (after phase 26): ``HAVC_deepex(clip,
    clip_ref, render_vivid=True, scene_parallel=True,
    engine_config="full")`` on a seeded 48-frame 1080p clip of six scenes
    of 8 frames (references from ``HAVC_colorizer`` with scene detection:
    cuts every 8 frames), then with ``scene_parallel=False``: wall time,
    fps, peak memory, window-attention calls (7 at B = 6 against 42 at
    B = 1), host syncs inside both scans (none allowed), the propagated ab
    of the two against each other (``SCENE_TOL``); a third scene-batched
    call under ``utils.device_trace`` writes a Chrome trace (its size
    printed, parsed as JSON) into ``$HAVC_TRACE_DIR`` when that is set,
    else into a temporary directory.
29. ``mesh_paths``: ``parallel.make_mesh(1)`` and a ``Mesh`` of two shards
    that are both cuda:0: ``colormnet_propagate_scenes``,
    ``deepex_propagate``, ``remaster_propagate``, ``spatial_halo_call`` (a
    5x5 box blur, halo 2, on 8x1080x1920, rows over two shards) and
    ``sharded_classic_pipeline`` at its production geometry (resnet101,
    large, render factor 24, 384; 8 frames of 1080p), each against its
    unsharded run: the mesh of one bit-identical, two shards within
    ``MESH2_TOL``; the classic pipeline's post-chain launches (one a shard).
30. ``convert_roundtrip``: a synthesized DeOldify Video checkpoint (the
    reference's full key set at the resnet101 shapes, spectral- and
    weight-normed) converted by ``python -m havc_tpu_torch.models.convert``,
    loaded through ``engines.set_weights_dir`` on the card, one 8x384x384
    batch colorized: times, converted tensors, the output's checksum.
Each of 14-21 prints the wall time of a second call, fps, peak device
memory, the stage times of a third call (18-22 name ``deepex_vgg``,
``deepex_warp``, ``deepex_colorvid``, ``deepex_wls``,
``remaster_encode_refs``, ``remaster_windows`` apart), the kernels'
launches and the host syncs inside ``colormnet_propagate``,
``deepex_propagate`` and ``remaster_propagate`` (any fails the phase).
``parity_cpu_gpu`` also covers the test-sized Placebo and VerySlow paths
(6x136x240, tiny engines with DeOldify Deep "nano" and Zhang at width 8),
the paths of phases 14-17 at 6x48x64 (the restore with ref-merge 2 and
the encode mode 2 for 17), CLAHE on a 1080x1920 plane (1e-5), tuned
streaming (within 1 code), and the paths of 18-21 at 6x48x64 with
Deep-Exemplar and NetworkC at full width and their work sizes cut to
40x64 and 32x48 (DeepEx runs a hard argmax and ``HAVC_main`` a hue
threshold: at most 2 % of the values more than 1e-4 apart; DeepRemaster
1e-4).  Each kernel's ``launches_by_path`` gives its
launches on every path driven (counts zeroed just before each path and
read just after; ``exemplar_sources`` sums its three calls).

Then the ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` name and
power-limit line, and last the result line.  Without CUDA, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
H100_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_TOL = 1e-5
PARITY_TOL = 1e-4
MAIN_SHAPE = (24, 1080, 1920)
WORK_SHAPE = (24, 384, 384, 3)  # the stabilizer's work clip at 1080p
WORK_SHAPE_RF32 = (24, 512, 512, 3)  # Placebo / VerySlow: render factor 32
EX_CUTS = [0, 8, 16]  # the exemplar clip's scene changes


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def smi_max_sm_clock_hz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def short_name(mangled: str) -> str:
    """``_Z26window_attn_weights_kernelILi4EEv...`` -> ``window_attn_weights_kernel<4>``."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    name = mangled[m.end():m.end() + int(m.group(1))]
    t = re.match(r"ILi(\d+)EE", mangled[m.end() + int(m.group(1)):])
    return f"{name}<{t.group(1)}>" if t else name


def ptxas_report(log: str) -> dict:
    """Per kernel function: registers, stack, spills and static shared
    memory, from nvcc's ``-Xptxas -v`` output (dynamic shared memory is
    sized at launch and does not appear there)."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = short_name(m.group(1))
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[fn].update(registers=int(m.group(1)), static_smem=int(smem.group(1)) if smem else 0)
    return out


def cuda_ms(fn, reps: int = 10, inner: int = 20) -> float:
    """Device time of one call of ``fn``: the median over ``reps`` of CUDA
    events around ``inner`` back-to-back calls, after a warm-up call.  A
    spin kernel (~2.5 ms) ahead of the start event lets the host queue the
    calls before the card reaches them, so host overhead is not timed."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# --- phase 2: kernels against their plain versions ------------------------------

# operations per pixel of the post chain, counted from csrc/post_chain.cu:
# each tweak is RGB->HSV (~24), HSV->RGB (~20), clamps and scales (~6),
# luma and ramp (~8), blend (~9); the colormap adds RGB->HSV, HSV->RGB,
# the range tests and two blends (~80); the final clamp 6
POST_CHAIN_OPS = {False: 2 * 67 + 6, True: 2 * 67 + 80 + 6}
KW_COLORMAP = dict(cmap_ranges=((180.0, 280.0),), cmap_hue_shift=140.0, cmap_weight=0.1)
KW_MAIN = dict(dark_thr=0.1, dark_white=0.2, dark_sat=min(max(1.1 - 0.8, 0.10), 0.80),
               dark_bright=-0.8, sm_black=0.3, sm_white=0.7, sm_sat=0.9, sm_bright=-0.0)


def phase_kernels(pc, card: str, sass_per_pixel: float, sms: int, clock_hz: float) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # (name, shape, kw, start): start 1 takes the contiguous slice x[1:],
    # whose data begin 4 B past a 16-byte boundary; "l2_resident" (8
    # frames, 28 MB in and out) stays in the 50 MB L2, so its time per
    # pixel against the main path's says whether device memory or the
    # arithmetic limits
    cases = [("main_path", WORK_SHAPE, KW_MAIN, 0), ("colormap", WORK_SHAPE, KW_COLORMAP, 0),
             ("placebo_veryslow", WORK_SHAPE_RF32, KW_MAIN, 0),
             ("l2_resident", (8,) + WORK_SHAPE[1:], KW_MAIN, 0),
             ("odd_sizes", (1, 30, 50, 3), KW_COLORMAP, 0), ("ragged", (1, 7, 11, 3), KW_MAIN, 0),
             ("misaligned", (2, 5, 7, 3), KW_COLORMAP, 1)]
    rows, worst = [], 0.0
    main = None
    for name, shape, kw, start in cases:
        x = torch.rand(shape, generator=gen, device="cuda")[start:]
        got = pc.post_chain_cuda(x, **kw)
        want = pc.post_chain_reference(x, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        n_pix = x.numel() // 3
        n_bytes = 24 * n_pix  # 12 B read + 12 B written per pixel
        ops = POST_CHAIN_OPS[bool(kw.get("cmap_ranges"))] * n_pix
        bytes_ms, ops_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
        kernel_ms = cuda_ms(lambda: pc.post_chain_cuda(x, **kw))
        row = dict(case=name, shape=list(x.shape), data_offset_bytes=x.data_ptr() % 16,
                   max_abs_err=err, kernel_ms=kernel_ms, ns_per_pixel=kernel_ms * 1e6 / n_pix,
                   plain_ms=cuda_ms(lambda: pc.post_chain_reference(x, **kw)),
                   bytes=n_bytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=None)
        rows.append(row)
        if name == "main_path":
            main = row
            # the time the card takes to issue the kernel's instructions,
            # counted statically per pixel (an upper estimate: it includes
            # the colormap and the divisions' slow paths, which the main
            # path does not run)
            row["issue_ms_static"] = sass_per_pixel * n_pix / 32 / (4 * sms) / clock_hz * 1e3
        if err > KERNEL_TOL:
            emit(dict(phase="kernels", name="post_chain", cases=rows))
            fail(f"post_chain {name}: max abs err {err} > {KERNEL_TOL}")
    forms = pc.check_range_forms()
    emit(dict(phase="kernels", name="post_chain", card=card, tol=KERNEL_TOL, cases=rows,
              sass_per_pixel=sass_per_pixel, sm_clock_max_hz=clock_hz, sms=sms,
              range_form_mismatches=forms,
              note="library_ms null: no single PyTorch call computes this function; "
                   "range_form_mismatches: [py_mod(x, 6), py_mod(h, 1), sextant] against the "
                   "generic forms over every float of their ranges"))
    if forms != [0, 0, 0]:
        fail(f"post_chain: range-limited forms differ from the generic ones: {forms}")
    return dict(name="post_chain", route="cuda", source="havc_tpu_torch/csrc/post_chain.cu",
                replaces="havc_tpu/ops/pallas_kernels.py:208", launches=None,
                max_abs_err=worst, ms=main["kernel_ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None)


WIN = 15  # window-attention window (max_dis 7)


def window_pairs(h: int, w: int) -> int:
    """(pixel, offset) pairs of one frame whose offset lies in the frame:
    the kernel skips the others (their weight is exactly 0), so only these
    count toward the bound's operations."""
    m = WIN // 2
    along = lambda n: sum(min(i + m, n - 1) - max(i - m, 0) + 1 for i in range(n))  # noqa: E731
    return along(h) * along(w)


def window_attn_inputs(b, h, w, d_qk, d_vu, seed):
    """q, k, v at 0.3 and rel at 0.1 standard deviations, seeded with numpy
    as the JAX package's kernel test seeds them."""
    rng = np.random.default_rng(seed)
    mk = lambda c, sd: torch.from_numpy(  # noqa: E731
        (rng.standard_normal((b, h, w, c)) * sd).astype(np.float32)).cuda()
    return mk(d_qk, 0.3), mk(d_qk, 0.3), mk(d_vu, 0.3), mk(WIN * WIN, 0.1)


def window_sdpa_mask(rel):
    """The dense (B, 1, HW, HW) additive mask under which one
    scaled_dot_product_attention over all keys computes window attention:
    ``rel`` at each in-frame window offset, -inf off the window (offsets
    outside the frame have no key, as their -1e8 logits have no weight)."""
    b, h, w, _ = rel.shape
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ys, xs = ys.reshape(-1).cuda(), xs.reshape(-1).cuda()
    dy = ys[None, :] - ys[:, None]
    dx = xs[None, :] - xs[:, None]
    m = WIN // 2
    inside = (dy.abs() <= m) & (dx.abs() <= m)
    off = ((dy + m) * WIN + (dx + m)).clamp(0, WIN * WIN - 1)
    vals = rel.reshape(b, h * w, WIN * WIN).gather(2, off[None].expand(b, -1, -1))
    return torch.where(inside[None], vals, -torch.inf)[:, None]


def phase_window_attn(wa, card: str) -> dict:
    import torch.nn.functional as F

    # path, batch 4, a width that is not a multiple of the 4-pixel tile,
    # channel counts that take the kernels' 4-byte paths, the odd test
    # shape, and the scene-batched scan's B = S (six scenes)
    cases = [("path", (1, 14, 28, 64, 1024), 0), ("batched", (4, 14, 28, 64, 1024), 1),
             ("ragged", (1, 14, 27, 64, 1024), 2), ("scalar", (2, 5, 11, 6, 10), 3),
             ("odd", (2, 6, 9, 16, 32), 0), ("scene_batch", (SCENE_S, 14, 28, 64, 1024), 4)]
    rows, worst, main = [], 0.0, None
    for name, (b, h, w, d_qk, d_vu), seed in cases:
        q, k, v, rel = window_attn_inputs(b, h, w, d_qk, d_vu, seed)
        got = wa.window_attn_cuda(q, k, v, rel)
        want = wa.window_attn_reference(q, k, v, rel)
        mask = window_sdpa_mask(rel)

        def sdpa():
            flat = lambda t: t.reshape(b, 1, h * w, t.shape[-1])  # noqa: E731
            return F.scaled_dot_product_attention(flat(q), flat(k), flat(v), attn_mask=mask,
                                                  scale=1.0 / d_qk ** 0.5)

        lib = sdpa().reshape(b, h, w, d_vu)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        n_bytes = 4 * b * h * w * (2 * d_qk + WIN * WIN + 2 * d_vu)
        ops = b * window_pairs(h, w) * (2 * d_qk + 2 * d_vu)
        bytes_ms, ops_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
        wts, out = wa.scratch(q, WIN // 2), torch.empty_like(got)

        def half(stages):  # one of the two launches alone
            return lambda: wa.launch_stages(q, k, v, rel, wts, out, WIN // 2, stages)

        row = dict(case=name, shape=[b, h, w, d_qk, d_vu], max_abs_err=err,
                   library_max_abs_err=(lib - want).abs().max().item(),
                   kernel_ms=cuda_ms(lambda: wa.window_attn_cuda(q, k, v, rel)),
                   weights_ms=cuda_ms(half(1)), weighted_sum_ms=cuda_ms(half(2)),
                   plain_ms=cuda_ms(lambda: wa.window_attn_reference(q, k, v, rel)),
                   library_ms=cuda_ms(sdpa), bytes=n_bytes, ops=ops,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        rows.append(row)
        if name == "path":
            main = row
        if err > KERNEL_TOL:
            emit(dict(phase="kernels", name="window_attn", cases=rows))
            fail(f"window_attn {name}: max abs err {err} > {KERNEL_TOL}")
    emit(dict(phase="kernels", name="window_attn", card=card, tol=KERNEL_TOL, cases=rows,
              note="library_ms: one scaled_dot_product_attention over all keys under the "
                   "dense window mask (mask built outside the timing); weights_ms and "
                   "weighted_sum_ms: each of the two launches alone (kernel_ms runs them as "
                   "one call, the second starting while the first runs)"))
    return dict(name="window_attn", route="cuda", source="havc_tpu_torch/csrc/window_attn.cu",
                replaces="havc_tpu/ops/pallas_attn.py:107", launches=None,
                max_abs_err=worst, ms=main["kernel_ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"])


# --- phase 3: the main path at full width -------------------------------------------


def gray_clip_1080p() -> torch.Tensor:
    """Seeded 24-frame 1080x1920 gray clip on the card: a smooth random
    field (bilinear up from 34x60) with fine noise, in [0, 1]."""
    t, h, w = MAIN_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    coarse = torch.rand((t, 1, 34, 60), generator=gen, device="cuda")
    y = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                        align_corners=False)
    y = 0.85 * y + 0.15 * torch.rand((t, 1, h, w), generator=gen, device="cuda")
    return y.clamp(0.0, 1.0).permute(0, 2, 3, 1).expand(t, h, w, 3).contiguous()


def phase_main_path(ht, pc, wa, card: str):
    from havc_tpu_torch import engines
    from havc_tpu_torch.utils import enable_profiling, reset_stages, stage_times

    frames = gray_clip_1080p()
    t0 = time.perf_counter()
    do = engines.registry.deoldify("video")
    dd = engines.registry.ddcolor("artistic")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_do = sum(p.numel() for p in do.parameters())
    n_dd = sum(p.numel() for p in dd.parameters())

    def run():
        out = ht.HAVC_main(ht.Clip(frames=frames))
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()  # first call: cuDNN algorithm selection, resize matrices
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    zero_launches(pc, wa)
    t0 = time.perf_counter()
    out = run()
    wall_s = time.perf_counter() - t0
    by_kernel = read_launches(pc, wa)
    launches = by_kernel["post_chain"]
    peak = torch.cuda.max_memory_allocated()

    # a third run with per-stage timing (each stage synchronizes the card)
    enable_profiling(True)
    reset_stages()
    t0 = time.perf_counter()
    run()
    profiled_s = time.perf_counter() - t0
    enable_profiling(False)
    stages = {k: v[0] for k, v in stage_times().items()}

    f = out.frames
    ok_shape = isinstance(f, torch.Tensor) and f.is_cuda and tuple(f.shape) == MAIN_SHAPE + (3,)
    finite = bool(torch.isfinite(f).all().item())
    lo, hi = f.min().item(), f.max().item()
    chroma = (f - f.mean(-1, keepdim=True)).abs().mean().item()
    emit(dict(phase="main_path", card=card, clip=list(MAIN_SHAPE) + [3], params_deoldify=n_do,
              params_ddcolor=n_dd, engine_init_s=init_s, first_call_s=first_s,
              wall_s=wall_s, fps=MAIN_SHAPE[0] / wall_s, profiled_wall_s=profiled_s,
              stages_s=stages, max_memory_allocated=peak, post_chain_launches=launches,
              out_min=lo, out_max=hi, mean_abs_chroma=chroma))
    if not ok_shape:
        fail(f"main_path: output {type(f)} {tuple(f.shape)} is not a CUDA tensor of "
             f"shape {MAIN_SHAPE + (3,)}")
    if not finite or lo < 0.0 or hi > 1.0:
        fail(f"main_path: output not finite in [0,1] (finite={finite}, min={lo}, max={hi})")
    if launches < 1:
        fail("main_path: the post-chain kernel was not launched")
    if n_do < 2e8 or n_dd < 2e8:
        fail(f"main_path: models not at full width ({n_do}, {n_dd} parameters)")
    return by_kernel, frames, wall_s, out


# --- phase 4: where the device time goes ---------------------------------------------


# the classic surface's filters by the PyTorch kernels they run: CLAHE
# and the histograms count with scatter_add; MSRCP's quantiles and the
# tweaks' percentiles sort; the box filters are cumulative sums; the LUT
# and CLAHE lookups gather (index kernels)
FILTER_KERNELS = {"scatter_add (histograms)": ("scatter",), "sort (quantiles)": ("sort", "Sort"),
                  "cumsum (box filters)": ("scan", "Scan", "cumsum"),
                  "gather (LUT, CLAHE lookups)": ("index", "gather")}


def phase_profile(path: str, run, wall_s, card: str, kernel: str, groups=None) -> None:
    """One more run of a path under torch.profiler: the card's busy time
    (the union of its kernel intervals) against the run's wall time, the
    device time summed per kernel, the kernels that take the most, the
    device time of the port's kernels whose names contain ``kernel``, and
    of each of ``groups`` (label -> name fragments)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    dev = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    if not dev:
        emit(dict(phase="profile", path=path, device_time="not measured",
                  note="torch.profiler recorded no CUDA kernels"))
        return
    dev.sort(key=lambda a: -a.self_device_time_total)
    device_s = sum(a.self_device_time_total for a in dev) * 1e-6
    busy_us, end_us = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                         if e.device_type == DeviceType.CUDA):
        busy_us += max(0.0, hi - max(lo, end_us))
        end_us = max(end_us, hi)
    emit(dict(phase="profile", path=path, card=card, device_kernel_s=device_s,
              busy_s=busy_us * 1e-6,
              profiled_wall_s=profiled_s, busy_share=busy_us * 1e-6 / profiled_s,
              unprofiled_wall_s=wall_s,
              kernels=len(dev), launches=sum(a.count for a in dev),
              top=[dict(name=a.key[:90], s=a.self_device_time_total * 1e-6, count=a.count)
                   for a in dev[:12]],
              kernel=kernel, kernel_s=sum(a.self_device_time_total for a in dev
                                          if kernel in a.key) * 1e-6,
              kernel_launches={a.key[:60]: a.count for a in dev if kernel in a.key},
              groups_s={label: sum(a.self_device_time_total for a in dev
                                   if any(f in a.key for f in frags)) * 1e-6
                        for label, frags in (groups or {}).items()}))


# --- phases 10-13: the classic surface ------------------------------------------------

BW_SHAPE = (8, 1080, 1920)
PLACEBO_KW = dict(Preset="Placebo", ColorFix="Retinex/Red", BlackWhiteTune="Medium")
VERYSLOW_KW = dict(Preset="VerySlow", ColorModel="Artistic+Siggraph17",
                   CombMethod="Chroma-Retention", ColorFix="None", BlackWhiteTune="Light",
                   BlackWhiteMode=4)
BW_TUNE_LIMIT = 4e9  # bytes: no per-pixel 256-wide one-hot or LUT tensor


def phase_bw_tune_memory(ht, card: str) -> None:
    """HAVC_bw_tune on 8 frames of 1080p with the luma CLAHE (method 0) and
    the per-channel CLAHE (method 2), before any model is on the card: the
    peak device memory after a reset holds the input, the output and the
    filter's temporaries only."""
    frames = gray_clip_1080p()[:BW_SHAPE[0]].contiguous()
    rows = []
    for method in (0, 2):
        run = lambda: ht.HAVC_bw_tune(ht.Clip(frames=frames), "Light", bw_method=method)  # noqa: E731,B023
        timed(run)  # first call
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, wall_s = timed(run)
        peak = torch.cuda.max_memory_allocated()
        f = out.frames
        rows.append(dict(bw_method=method, wall_s=wall_s, fps=BW_SHAPE[0] / wall_s,
                         max_memory_allocated=peak, allocated_before=before,
                         peak_over_before=peak - before,
                         finite=bool(torch.isfinite(f).all().item()),
                         mean_abs_change=float((f - frames).abs().mean().item())))
        del out, f
    emit(dict(phase="bw_tune_memory", card=card, clip=list(BW_SHAPE) + [3],
              input_bytes=frames.numel() * 4, limit_bytes=BW_TUNE_LIMIT, runs=rows))
    for r in rows:
        if r["max_memory_allocated"] >= BW_TUNE_LIMIT or not r["finite"]:
            fail(f"bw_tune_memory: method {r['bw_method']} peaked at "
                 f"{r['max_memory_allocated']} B (limit {BW_TUNE_LIMIT:.0f}) or not finite")
        if r["mean_abs_change"] <= 1e-4:
            fail(f"bw_tune_memory: method {r['bw_method']} left the frames unchanged")


def zero_launches(pc, wa) -> None:
    pc.post_chain_cuda.launches = wa.window_attn_cuda.launches = 0


def read_launches(pc, wa) -> dict:
    return dict(post_chain=pc.post_chain_cuda.launches, window_attn=wa.window_attn_cuda.launches)


def phase_classic_path(ht, pc, wa, card: str, name: str, kw: dict, want_post_chain: int):
    """A classic-surface preset of ``HAVC_main`` on the main path's 1080p
    clip with full-width engines: wall time of a second call, fps, peak
    memory, per-stage times of a third, the kernels' launches."""
    from havc_tpu_torch import engines
    from havc_tpu_torch.utils import enable_profiling, reset_stages, stage_times

    frames = gray_clip_1080p()

    def run():
        out = ht.HAVC_main(ht.Clip(frames=frames), **kw)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()  # first call: engines made on the card, cuDNN algorithm selection
    first_s = time.perf_counter() - t0
    params = {"_".join(k[:2]): sum(p.numel() for p in m.parameters())
              for k, m in engines.registry._cache.items()}

    torch.cuda.reset_peak_memory_stats()
    zero_launches(pc, wa)
    t0 = time.perf_counter()
    out = run()
    wall_s = time.perf_counter() - t0
    launches = read_launches(pc, wa)
    peak = torch.cuda.max_memory_allocated()

    enable_profiling(True)
    reset_stages()
    t0 = time.perf_counter()
    run()
    profiled_s = time.perf_counter() - t0
    enable_profiling(False)
    stages = {k: v[0] for k, v in stage_times().items()}

    f = out.frames
    ok_shape = isinstance(f, torch.Tensor) and f.is_cuda and tuple(f.shape) == MAIN_SHAPE + (3,)
    finite = bool(torch.isfinite(f).all().item())
    lo, hi = f.min().item(), f.max().item()
    chroma = (f - f.mean(-1, keepdim=True)).abs().mean().item()
    emit(dict(phase=name, card=card, clip=list(MAIN_SHAPE) + [3], kwargs=kw, params=params,
              first_call_s=first_s, wall_s=wall_s, fps=MAIN_SHAPE[0] / wall_s,
              stage_timed_wall_s=profiled_s, stages_s=stages, max_memory_allocated=peak,
              launches=launches, post_chain_launches=launches["post_chain"],
              out_min=lo, out_max=hi, mean_abs_chroma=chroma))
    if not ok_shape:
        fail(f"{name}: output {type(f)} {tuple(f.shape)} is not a CUDA tensor of shape "
             f"{MAIN_SHAPE + (3,)}")
    if not finite or lo < 0.0 or hi > 1.0:
        fail(f"{name}: output not finite in [0,1] (finite={finite}, min={lo}, max={hi})")
    if launches["post_chain"] != want_post_chain:
        fail(f"{name}: the post-chain kernel ran {launches['post_chain']} times, expected "
             f"{want_post_chain}")
    if chroma <= 1e-4:
        fail(f"{name}: no chroma in the output")
    return launches, run, wall_s


def phase_streaming_tuned(ht, pc, wa, card: str, src: str, tmp: str):
    """HAVC_main_streaming with BWTune and LUT on 72 frames of the
    streaming phase's 1080p .y4m: both retune luma on the card, so the
    download is i420; fps, host syncs per retired chunk, peak memory, and a
    stage-timed run (``bw_tune`` is the BW tune; ``restore`` holds the
    look)."""
    from havc_tpu_torch import streaming
    from havc_tpu_torch.utils import enable_profiling, reset_stages, stage_times

    n_frames, chunk = 72, 64

    def run():
        return ht.HAVC_main_streaming(src, f"{tmp}/unused.mp4", BWTune="Light", LUT=2,
                                      count=n_frames, chunk_size=chunk, sink="null")

    first_n, first_s = timed(run)
    zero_launches(pc, wa)
    torch.cuda.reset_peak_memory_stats()
    with Recorder(streaming) as rec:
        (n, sync_n, sync_sites), wall_s = timed(lambda: count_syncs(run))
    launches = read_launches(pc, wa)
    peak = torch.cuda.max_memory_allocated()
    transfer = streaming.last_transfer()
    packed = rec.joined("packed")

    enable_profiling(True)
    reset_stages()
    _, stage_timed_s = timed(run)
    enable_profiling(False)
    stages = {k: v[0] for k, v in stage_times().items()}
    h, w = MAIN_SHAPE[1:]
    chunks = -(-n_frames // chunk)
    emit(dict(phase="streaming_tuned", card=card, clip=[n_frames, h, w], BWTune="Light", LUT=2,
              stage_timed_wall_s=stage_timed_s, stages_s=stages,
              first_call_s=first_s, frames=n, wall_s=wall_s, fps=n / wall_s, transfer=transfer,
              host_syncs=sync_n, sync_sites=sync_sites, chunks=chunks,
              host_syncs_per_chunk=sync_n / chunks, **rec.waits(), max_memory_allocated=peak,
              launches=launches, out_shape=list(packed.shape),
              out_y_range=[int(packed[:, :h].min()), int(packed[:, :h].max())],
              **chroma_stats(packed[:, h:])))
    if (first_n, n) != (n_frames, n_frames):
        fail(f"streaming_tuned: frames written {first_n}, {n} != {n_frames}")
    if transfer != "gray+i420" or tuple(packed.shape) != (n_frames, h * 3 // 2, w):
        fail(f"streaming_tuned: transfer {transfer}, packed shape {packed.shape}")
    if sync_n > chunks + 1:
        fail(f"streaming_tuned: {sync_n} host syncs over {chunks} chunks")
    return run, wall_s, launches


# --- phase 5: the exemplar path at full width -----------------------------------------


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) linear interpolation from n_in knots spread over
    n_out samples."""
    xs = np.linspace(0.0, n_in - 1.0, n_out)
    eye = np.eye(n_in)
    return np.stack([np.interp(xs, np.arange(n_in), eye[j]) for j in range(n_in)], axis=1)


def smooth_frames(t: int, per_scene: int, seed: int, h: int = 1080, w: int = 1920):
    """Yield ``t`` seeded (h, w) float32 gray frames in scenes of
    ``per_scene``: each scene a fresh smooth random field (9x16 knots,
    values in [0.15, 0.75]) that drifts 2 px to the left per frame."""
    rng = np.random.default_rng(seed)
    a = _interp_matrix(h, 9).astype(np.float32)
    b = _interp_matrix(w + 2 * per_scene, 16).astype(np.float32)
    for s in range(-(-t // per_scene)):
        field = a @ (0.15 + 0.6 * rng.random((9, 16), dtype=np.float32)) @ b.T
        for i in range(min(per_scene, t - per_scene * s)):
            yield field[:, 2 * i:2 * i + w]


def scene_clip_1080p(seed: int = 5) -> np.ndarray:
    """Seeded 24-frame 1080x1920 gray clip in three scenes of 8 frames,
    (T, H, W, 3)."""
    t, h, w = MAIN_SHAPE
    y = np.stack(list(smooth_frames(t, 8, seed, h, w)))
    return np.repeat(y[..., None], 3, axis=-1)


def phase_exemplar_path(ht, pc, wa, card: str):
    from havc_tpu_torch import exemplar
    from havc_tpu_torch.utils import enable_profiling, reset_stages, stage_times

    frames = torch.from_numpy(scene_clip_1080p()).cuda()

    def run():
        out = ht.HAVC_main(ht.Clip(frames=frames), EnableDeepEx=True, engine_config="full")
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()  # first call: builds the full ColorMNet on the card, cuDNN selection
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    zero_launches(pc, wa)
    t0 = time.perf_counter()
    out = run()
    wall_s = time.perf_counter() - t0
    by_kernel = read_launches(pc, wa)
    launches = by_kernel["window_attn"]
    peak = torch.cuda.max_memory_allocated()

    enable_profiling(True)
    reset_stages()
    t0 = time.perf_counter()
    run()
    profiled_s = time.perf_counter() - t0
    enable_profiling(False)
    stages = {k: v[0] for k, v in stage_times().items()}

    engines = [e for e in exemplar._ENGINE_CACHE.values() if e.cfg_name == "full"]
    eng = engines[0] if engines else None
    vit = eng.net.key_encoder.network2.backbone if eng else None
    geometry = dict(key_dim=eng.key_dim, value_dim=eng.value_dim, dino_dim=vit.dim,
                    dino_depth=vit.depth, work=[eng.h, eng.w]) if eng else None
    n_params = sum(p.numel() for p in eng.net.parameters()) if eng else 0
    cuts = np.nonzero(out.sc.sc_prev)[0].tolist() if out.sc is not None else None
    f = out.frames
    ok_shape = isinstance(f, torch.Tensor) and f.is_cuda and tuple(f.shape) == MAIN_SHAPE + (3,)
    finite = bool(torch.isfinite(f).all().item())
    lo, hi = f.min().item(), f.max().item()
    emit(dict(phase="exemplar_path", card=card, clip=list(MAIN_SHAPE) + [3], scene_cuts=cuts,
              engine=geometry, params_colormnet=n_params, first_call_s=first_s, wall_s=wall_s,
              fps=MAIN_SHAPE[0] / wall_s, profiled_wall_s=profiled_s, stages_s=stages,
              max_memory_allocated=peak, window_attn_launches=launches, out_min=lo,
              out_max=hi, mean_abs_chroma=(f - f.mean(-1, keepdim=True)).abs().mean().item()))
    if cuts != EX_CUTS:
        fail(f"exemplar_path: scene cuts {cuts} != {EX_CUTS}")
    if geometry is None or (geometry["key_dim"], geometry["value_dim"], geometry["dino_dim"],
                            geometry["dino_depth"]) != (64, 512, 384, 12):
        fail(f"exemplar_path: the ColorMNet engine is not the full one: {geometry}")
    if not ok_shape:
        fail(f"exemplar_path: output {type(f)} {tuple(f.shape)} is not a CUDA tensor of "
             f"shape {MAIN_SHAPE + (3,)}")
    if not finite or lo < 0.0 or hi > 1.0:
        fail(f"exemplar_path: output not finite in [0,1] (finite={finite}, min={lo}, max={hi})")
    if launches < MAIN_SHAPE[0] - len(EX_CUTS):
        fail(f"exemplar_path: window attention launched {launches} times, expected at least "
             f"{MAIN_SHAPE[0] - len(EX_CUTS)}")
    return by_kernel, run, wall_s


def phase_exemplar_memory(card: str) -> None:
    """60 frames at the Medium work size from one reference at frame 0
    (frame_propagate, no vivid reset): with a memory frame every 5, the
    working store reaches its 10 frames and consolidates into the
    long-term store."""
    from havc_tpu_torch import exemplar
    from havc_tpu_torch.ops.colorspace import rgb_to_lab

    n, (wh, ww) = 60, exemplar.smart_resize_shape(1920, 1080, "medium")
    ph, pw = exemplar.pad112_geometry(wh, ww)[:2]
    eng = exemplar._get_engine(config="full", work_size=(ph, pw), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    coarse = torch.rand((n, 3, 9, 16), generator=gen, device="cuda")
    frames = torch.nn.functional.interpolate(coarse, size=(wh, ww), mode="bilinear",
                                             align_corners=False).permute(0, 2, 3, 1)
    ref_ab = torch.clamp(rgb_to_lab(frames)[..., 1:3] / 110.0, -1.0, 1.0)
    is_ref = np.zeros(n, bool)
    is_ref[0] = True
    # the propagation must not wait for the card: count the host syncs
    # PyTorch reports while it runs (the resize matrices and the LAB white
    # point it reads are on the card since the exemplar_path phase)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            ab, carry = exemplar.colormnet_propagate(eng, frames, ref_ab, is_ref,
                                                     frame_propagate=True, vivid=False,
                                                     return_state=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    state = carry[0]
    lt_valid = int(state.lt_valid.sum().item())
    finite = bool(torch.isfinite(ab).all().item())
    emit(dict(phase="exemplar_memory", card=card, frames=n, work=[wh, ww], engine=[ph, pw],
              wall_s=wall_s, fps=n / wall_s, host_syncs=len(syncs), sync_sites=syncs[:5],
              inserts=state.next_stamp,
              working_valid=int(state.host_valid.sum()), long_term_valid=lt_valid,
              lt_capacity=eng.mem_cfg.lt_capacity, out_shape=list(ab.shape), finite=finite))
    if lt_valid <= 0 or not finite or tuple(ab.shape) != (n, wh, ww, 2):
        fail(f"exemplar_memory: long-term valid {lt_valid}, finite {finite}, "
             f"shape {tuple(ab.shape)}")
    if syncs:
        fail(f"exemplar_memory: the propagation waited for the card {len(syncs)} times")


# --- phases 14-17: the rest of the ColorMNet exemplar surface ----------------------------

# per-scene (a, b) gains of the colored clips: each channel scaled by
# 1 + a sin(6x) + b cos(4y) over the frame (x, y in [0, 1])
TINTS = [((0.30, -0.10, -0.25), (0.10, 0.05, -0.15)),
         ((-0.20, 0.25, 0.05), (-0.10, 0.15, 0.10)),
         ((0.05, -0.20, 0.30), (0.20, -0.05, 0.05)),
         ((-0.15, 0.10, 0.20), (0.05, 0.20, -0.10))]
SOURCES_T, SOURCES_PER = 12, 3  # the exemplar_sources clip: four scenes of 3 frames
SOURCES_CUTS = [0, 3, 6, 9]


def tinted(gray: torch.Tensor, per: int) -> torch.Tensor:
    """A colored counterpart of a gray clip on the card: scene ``s`` of
    ``per`` frames scaled per channel by TINTS[s % 4]'s smooth gain field."""
    _, h, w, _ = gray.shape
    yy = torch.linspace(0.0, 1.0, h, device=gray.device)[:, None, None]
    xx = torch.linspace(0.0, 1.0, w, device=gray.device)[None, :, None]
    out = torch.empty_like(gray)
    for s in range(0, gray.shape[0], per):
        a, b = (torch.tensor(v, device=gray.device) for v in TINTS[(s // per) % len(TINTS)])
        gain = 1.0 + a * torch.sin(6.0 * xx) + b * torch.cos(4.0 * yy)
        out[s:s + per] = (gray[s:s + per] * gain).clamp(0.0, 1.0)
    return out


class LoopSyncs:
    """While active: the host syncs PyTorch reports inside every call of
    the exemplar propagations ``names`` (ColorMNet's: the batched key
    encoder and the frame loop), summed over the calls and per name."""

    def __init__(self, exemplar, names=("colormnet_propagate",)):
        self.ex, self.names, self.calls, self.syncs, self.sites = exemplar, names, 0, 0, []
        self.by_name = {n: dict(calls=0, host_syncs=0) for n in names}

    def __enter__(self):
        self.real = {n: getattr(self.ex, n) for n in self.names}
        for name, real in self.real.items():
            def spy(*a, _name=name, _real=real, **kw):
                out, n, sites = count_syncs(lambda: _real(*a, **kw))
                self.calls, self.syncs = self.calls + 1, self.syncs + n
                self.by_name[_name]["calls"] += 1
                self.by_name[_name]["host_syncs"] += n
                self.sites += sites
                return out

            setattr(self.ex, name, spy)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.ex, name, real)


def drive_exemplar_path(ht, pc, wa, card: str, name: str, run, frames_n: int,
                        want_post_chain=None) -> dict:
    """A ColorMNet path at full width: a first call (the engines made on the
    card, cuDNN algorithm selection), a measured second call (wall time,
    fps, peak memory, the kernels' launches, the host syncs inside
    ``colormnet_propagate``), a stage-timed third.  Returns the row emitted
    (``out`` and ``wall_s`` kept for the caller)."""
    from havc_tpu_torch import exemplar
    from havc_tpu_torch.utils import enable_profiling, reset_stages, stage_times

    _, first_s = timed(run)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(pc, wa)
    with LoopSyncs(exemplar) as loop:
        out, wall_s = timed(run)
    launches = read_launches(pc, wa)
    peak = torch.cuda.max_memory_allocated()
    enable_profiling(True)
    reset_stages()
    _, stage_timed_s = timed(run)
    enable_profiling(False)
    stages = {k: v[0] for k, v in stage_times().items()}
    engines = [e for e in exemplar._ENGINE_CACHE.values() if e.cfg_name == "full"]
    f = out.frames
    ok_shape = isinstance(f, torch.Tensor) and f.is_cuda and f.shape[0] == frames_n
    finite = bool(torch.isfinite(f).all().item())
    lo, hi = f.min().item(), f.max().item()
    row = dict(phase=name, card=card, clip=list(f.shape), first_call_s=first_s, wall_s=wall_s,
               fps=frames_n / wall_s, stage_timed_wall_s=stage_timed_s, stages_s=stages,
               max_memory_allocated=peak, launches=launches,
               window_attn_calls=launches["window_attn"],
               window_attn_launches=2 * launches["window_attn"],
               post_chain_launches=launches["post_chain"], propagate_calls=loop.calls,
               loop_host_syncs=loop.syncs, loop_sync_sites=loop.sites[:6],
               colormnet_full=bool(engines), out_min=lo, out_max=hi,
               mean_abs_chroma=(f - f.mean(-1, keepdim=True)).abs().mean().item())
    emit(row)
    if not ok_shape:
        fail(f"{name}: output {type(f)} {tuple(f.shape)} is not a CUDA clip of {frames_n} frames")
    if not finite or lo < 0.0 or hi > 1.0:
        fail(f"{name}: output not finite in [0,1] (finite={finite}, min={lo}, max={hi})")
    if not engines or loop.calls < 1:
        fail(f"{name}: the full ColorMNet did not run ({loop.calls} propagations)")
    if launches["window_attn"] < 1:
        fail(f"{name}: the window-attention kernel was not launched")
    if want_post_chain is not None and launches["post_chain"] != want_post_chain:
        fail(f"{name}: the post-chain kernel ran {launches['post_chain']} times, expected "
             f"{want_post_chain}")
    if loop.syncs:
        fail(f"{name}: the ColorMNet frame loop waited for the card {loop.syncs} times")
    if row["mean_abs_chroma"] <= 1e-4:
        fail(f"{name}: no chroma in the output")
    return dict(row, out=out)


def phase_recolor_path(ht, pc, wa, card: str):
    """``HAVC_ColorAdjust(clip)`` with its defaults on a colored 24-frame
    1080p clip of three scenes: ReColor, the clip re-colored by the full
    ColorMNet from itself at references on every frame (ref-merge 5,
    weight 0.7), its scene changes found by a normalised detection; then
    the Light RGB adjust and tweak (a re-color runs no CLAHE)."""
    frames = tinted(torch.from_numpy(scene_clip_1080p()).cuda(), 8)

    def run():
        return ht.HAVC_ColorAdjust(ht.Clip(frames=frames), engine_config="full")

    row = drive_exemplar_path(ht, pc, wa, card, "recolor_path", run, MAIN_SHAPE[0],
                              want_post_chain=0)
    if row["out"].sc is None or int(row["out"].sc.frequency) != 1:
        fail("recolor_path: the output does not carry the every-frame reference flags")
    return row["launches"], run, row["wall_s"]


def phase_colortemp_path(ht, pc, wa, card: str):
    """``HAVC_main(clip, ColorTemp="Medium")`` on the exemplar path's gray
    clip: the classic engines on every frame, ``HAVC_cmnet2`` over
    references at every frame with ref-merge 3, then the stabilizer with
    the post chain."""
    frames = torch.from_numpy(scene_clip_1080p()).cuda()

    def run():
        return ht.HAVC_main(ht.Clip(frames=frames), ColorTemp="Medium", engine_config="full")

    row = drive_exemplar_path(ht, pc, wa, card, "colortemp_path", run, MAIN_SHAPE[0],
                              want_post_chain=1)
    return row["launches"], run, row["wall_s"]


def phase_frameinterp_path(ht, pc, wa, card: str):
    """``HAVC_main(clip, FrameInterp=5)``: the classic engines on the scene
    changes and every 5th frame (``HAVC_colorizer_fast``), the full
    ColorMNet in between, then the stabilizer with the post chain."""
    frames = torch.from_numpy(scene_clip_1080p()).cuda()

    def run():
        return ht.HAVC_main(ht.Clip(frames=frames), FrameInterp=5, engine_config="full")

    row = drive_exemplar_path(ht, pc, wa, card, "frameinterp_path", run, MAIN_SHAPE[0],
                              want_post_chain=1)
    cuts = np.nonzero(row["out"].sc.sc_prev)[0].tolist() if row["out"].sc is not None else None
    emit(dict(phase="frameinterp_path", reference_frames=cuts))
    if not cuts or cuts[0] != 0 or len(cuts) < 5:
        fail(f"frameinterp_path: reference frames {cuts}, expected the cuts and every 5th")
    return row["launches"], run, row["wall_s"]


def phase_exemplar_sources(ht, pc, wa, card: str, tmp: str) -> dict:
    """Three DeepEx reference sources on a 12-frame 1080p gray clip of four
    scenes, each at full width: method 5 with ref-merge 2 from a colored
    mp4 (written with OpenCV), method 3 from a directory written by
    ``export_reference_frames``, and the all-refs encode mode 2 (HAVC
    references, ScMinFreq 3 so that there are the four the mode needs)."""
    import cv2

    from havc_tpu_torch.io import export_reference_frames

    h, w = MAIN_SHAPE[1:]
    gray_np = np.stack(list(smooth_frames(SOURCES_T, SOURCES_PER, 13, h, w)))
    gray = torch.from_numpy(np.repeat(gray_np[..., None], 3, axis=-1)).cuda()
    colored = tinted(gray, SOURCES_PER)
    video = f"{tmp}/sources_ref.mp4"
    out = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (w, h))
    for fr in (colored * 255.0).round().to(torch.uint8).cpu().numpy():
        out.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
    out.release()
    refdir = f"{tmp}/sources_refs"
    export_reference_frames(ht.Clip(frames=colored).with_sc(
        ht.SceneFlags.from_frame_list(SOURCES_T, SOURCES_CUTS)), refdir)
    calls = {
        "method5_video_refmerge2": dict(DeepExMethod=5, DeepExRefMerge=2, ScFrameDir=video),
        "method3_directory": dict(DeepExMethod=3, ScFrameDir=refdir),
        "encode_mode2": dict(DeepExEncMode=2, ScMinFreq=3),
    }
    total = dict(post_chain=0, window_attn=0)
    rows = {}
    for call, kw in calls.items():
        def run(kw=kw):
            return ht.HAVC_main(ht.Clip(frames=gray), EnableDeepEx=True, engine_config="full",
                                **kw)

        row = drive_exemplar_path(ht, pc, wa, card, f"exemplar_sources/{call}", run, SOURCES_T)
        rows[call] = row
        for k in total:
            total[k] += row["launches"][k]
    emit(dict(phase="exemplar_sources", card=card, clip=[SOURCES_T, h, w],
              reference_files=sorted(os.listdir(refdir)),
              wall_s={c: r["wall_s"] for c, r in rows.items()},
              fps={c: r["fps"] for c, r in rows.items()}, launches=total))
    if sorted(os.listdir(refdir)) != [f"ref_{n:06d}.jpg" for n in SOURCES_CUTS]:
        fail(f"exemplar_sources: exported {sorted(os.listdir(refdir))}")
    return total


# --- phases 18-22: Deep-Exemplar, the hybrid and DeepRemaster ---------------------------

PROPAGATES = ("colormnet_propagate", "deepex_propagate", "remaster_propagate")
ENGINE_STAGES = ("deepex_vgg", "deepex_warp", "deepex_colorvid", "deepex_wls", "deepex_resize",
                 "remaster_encode_refs", "remaster_windows", "remaster_vivid")
PARAMS_DEEPEX, PARAMS_NETWORKC = 55_024_269, 54_303_374  # the published widths


def wls_profile(t: int, h: int, w: int) -> dict:
    """``fgs_smooth_ab`` alone on a (t, h, w) LAB clip on the card: its
    kernel launches (torch.profiler), device time and wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from havc_tpu_torch.ops.fgs import fgs_smooth_ab

    gen = torch.Generator(device="cuda").manual_seed(17)
    lum = 100.0 * torch.rand((t, h, w, 1), generator=gen, device="cuda")
    ab = 200.0 * torch.rand((t, h, w, 2), generator=gen, device="cuda") - 100.0
    fgs_smooth_ab(lum, ab)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_s = timed(lambda: fgs_smooth_ab(lum, ab))
    dev = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    return dict(wls_shape=[t, h, w], wls_launches=sum(a.count for a in dev) if dev else
                "not measured", wls_device_s=sum(a.self_device_time_total for a in dev) * 1e-6
                if dev else "not measured", wls_wall_s=wall_s)


def deepex_conv_paths(card: str) -> dict:
    """Every Deep-Exemplar convolution of one batch (4 frames at the Medium
    216x384, ``frame_colorization_batched``) timed with CUDA events, once
    through cuDNN and once through PyTorch's own kernels (im2col and
    SGEMM; direct for the dilated ones), f32 with TF32 off: the
    measurement behind ``models.deepex._Conv2d``, which runs the undilated
    ones without cuDNN."""
    import torch.nn as nn

    from havc_tpu_torch import engines
    from havc_tpu_torch.models import deepex as dx

    net = engines.registry.deepex("cuda")
    h, w = exemplar_size()
    gen = torch.Generator(device="cuda").manual_seed(23)
    lab = torch.rand((4, h, w, 3), generator=gen, device="cuda") * 100.0
    lab = torch.cat([lab[..., :1], lab[..., 1:] - 50.0], dim=-1)
    ib = lab[:1].clone()
    convs = {n: m for n, m in net.named_modules() if isinstance(m, nn.Conv2d)}
    events, hooks = {}, []
    for name, m in convs.items():
        def pre(mod, inp, n=name):
            events[n] = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
            events[n][0].record()

        hooks += [m.register_forward_pre_hook(pre),
                  m.register_forward_hook(lambda mod, inp, out, n=name: events[n][1].record())]
    times, real = {}, dx._Conv2d.forward
    try:
        for mode in ("cudnn", "native"):
            dx._Conv2d.forward = nn.Conv2d.forward
            with torch.inference_mode(), torch.backends.cudnn.flags(
                    enabled=mode == "cudnn", benchmark=False, deterministic=False,
                    allow_tf32=False):
                for _ in range(2):  # the second call is timed
                    b_feat = dx.encode_reference(net.vgg, net.warpnet, ib)
                    dx.frame_colorization_batched(net.vgg, net.warpnet, net.colorvid, lab, ib,
                                                  ib, b_feat, 1e-10)
                    torch.cuda.synchronize()
                    times[mode] = {n: a.elapsed_time(b) for n, (a, b) in events.items()}
    finally:
        dx._Conv2d.forward = real
        for hk in hooks:
            hk.remove()
    port = {n: times["cudnn" if convs[n].dilation != (1, 1) else "native"][n] for n in convs}
    top = sorted(convs, key=lambda n: -abs(times["cudnn"][n] - times["native"][n]))[:6]
    row = dict(phase="deepex_conv_paths", card=card, batch=[4, h, w],
               cudnn_ms=sum(times["cudnn"].values()), native_ms=sum(times["native"].values()),
               port_ms=sum(port.values()),
               top=[dict(conv=n, dilation=convs[n].dilation[0],
                         cudnn_ms=times["cudnn"][n], native_ms=times["native"][n]) for n in top])
    emit(row)
    return row


def drive_engine_path(ht, pc, wa, card: str, name: str, run, frames_n: int, want: dict,
                      want_window_attn: bool, want_post_chain: int) -> dict:
    """A Deep-Exemplar / DeepRemaster path at full width: a first call (the
    engines made on the card, cuDNN selection), a measured second call
    (wall time, fps, peak memory, the kernels' launches, the host syncs
    inside each propagation), a stage-timed third.  ``want``: the
    propagations that must run, with their call counts."""
    from havc_tpu_torch import engines, exemplar
    from havc_tpu_torch.utils import enable_profiling, reset_stages, stage_times

    _, first_s = timed(run)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(pc, wa)
    with LoopSyncs(exemplar, PROPAGATES) as loop:
        out, wall_s = timed(run)
    launches = read_launches(pc, wa)
    peak = torch.cuda.max_memory_allocated()
    enable_profiling(True)
    reset_stages()
    _, stage_timed_s = timed(run)
    enable_profiling(False)
    stages = {k: v[0] for k, v in stage_times().items()}
    params = {k[0]: sum(p.numel() for p in m.parameters())
              for k, m in engines.registry._cache.items() if k[0] in ("deepex", "remaster")}
    f = out.frames
    ok_shape = isinstance(f, torch.Tensor) and f.is_cuda and f.shape[0] == frames_n
    finite = bool(torch.isfinite(f).all().item())
    lo, hi = f.min().item(), f.max().item()
    row = dict(phase=name, card=card, clip=list(f.shape), first_call_s=first_s, wall_s=wall_s,
               fps=frames_n / wall_s, stage_timed_wall_s=stage_timed_s, stages_s=stages,
               engine_stages_s={k: stages[k] for k in ENGINE_STAGES if k in stages},
               max_memory_allocated=peak, params=params, launches=launches,
               window_attn_calls=launches["window_attn"],
               window_attn_launches=2 * launches["window_attn"],
               post_chain_launches=launches["post_chain"], propagate=loop.by_name,
               propagate_host_syncs=loop.syncs, sync_sites=loop.sites[:6], out_min=lo,
               out_max=hi, mean_abs_chroma=(f - f.mean(-1, keepdim=True)).abs().mean().item())
    if "deepex_wls" in stages:
        row["deepex_wls_share_of_wall"] = stages["deepex_wls"] / stage_timed_s
    emit(row)
    if not ok_shape:
        fail(f"{name}: output {type(f)} {tuple(f.shape)} is not a CUDA clip of {frames_n} frames")
    if not finite or lo < 0.0 or hi > 1.0:
        fail(f"{name}: output not finite in [0,1] (finite={finite}, min={lo}, max={hi})")
    for prop, calls in want.items():
        if loop.by_name[prop]["calls"] != calls:
            fail(f"{name}: {prop} ran {loop.by_name[prop]['calls']} times, expected {calls}")
    if params.get("deepex", PARAMS_DEEPEX) != PARAMS_DEEPEX or \
            params.get("remaster", PARAMS_NETWORKC) != PARAMS_NETWORKC:
        fail(f"{name}: the engines are not at their published widths: {params}")
    if loop.syncs:
        fail(f"{name}: the propagation loops waited for the card {loop.syncs} times: "
             f"{loop.sites[:6]}")
    if (launches["window_attn"] > 0) != want_window_attn:
        fail(f"{name}: window attention launched {launches['window_attn']} times")
    if launches["post_chain"] != want_post_chain:
        fail(f"{name}: the post-chain kernel ran {launches['post_chain']} times, expected "
             f"{want_post_chain}")
    if row["mean_abs_chroma"] <= 1e-4:
        fail(f"{name}: no chroma in the output")
    return dict(row, out=out)


def phase_engine_paths(ht, pc, wa, card: str) -> dict:
    """Deep-Exemplar, the hybrid, DeepRemaster and FrameInterp 2 on the
    exemplar clip (24x1080p, cuts [0, 8, 16]) at full width; the first two
    DeepEx-running paths and DeepRemaster also under ``phase_profile``.
    Returns {path: the kernels' launches}."""
    frames = torch.from_numpy(scene_clip_1080p()).cuda()
    colored = tinted(frames, 8)
    n = MAIN_SHAPE[0]

    def main(**kw):
        return lambda: ht.HAVC_main(ht.Clip(frames=frames), **kw)

    by_path = {}
    row = drive_engine_path(ht, pc, wa, card, "deepex_path",
                            main(EnableDeepEx=True, DeepExModel=1), n,
                            dict(deepex_propagate=1), False, 0)
    deepex_conv_paths(card)
    wls = wls_profile(n, *exemplar_size())
    emit(dict(phase="deepex_path", card=card, **wls,
              wls_share_of_stage_timed_wall=row["stages_s"].get("deepex_wls", 0.0)
              / row["stage_timed_wall_s"]))
    if row["out"].sc is None or np.nonzero(row["out"].sc.sc_prev)[0].tolist() != EX_CUTS:
        fail("deepex_path: the output does not carry the scene cuts")
    by_path["deepex_path"] = row["launches"]
    phase_profile("deepex_path", main(EnableDeepEx=True, DeepExModel=1), row["wall_s"], card,
                  "deepex")
    del row
    row = drive_engine_path(ht, pc, wa, card, "hybrid_path",
                            main(EnableDeepEx=True, DeepExModel=3, engine_config="full"), n,
                            dict(colormnet_propagate=1, deepex_propagate=1), True, 0)
    by_path["hybrid_path"] = row["launches"]
    remaster = lambda: ht.HAVC_DeepRemaster(ht.Clip(frames=frames),  # noqa: E731
                                            clip_ref=ht.Clip(frames=colored))
    row = drive_engine_path(ht, pc, wa, card, "remaster_path", remaster, n,
                            dict(remaster_propagate=1), False, 0)
    by_path["remaster_path"] = row["launches"]
    phase_profile("remaster_path", remaster, row["wall_s"], card, "gemm")
    row2 = drive_engine_path(ht, pc, wa, card, "remaster_path/main_model2",
                             main(EnableDeepEx=True, DeepExModel=2), n,
                             dict(remaster_propagate=1), False, 0)
    for k in by_path["remaster_path"]:
        by_path["remaster_path"][k] += row2["launches"][k]
    row = drive_engine_path(ht, pc, wa, card, "frameinterp_deepex_path", main(FrameInterp=2), n,
                            dict(deepex_propagate=1), False, 1)
    by_path["frameinterp_deepex_path"] = row["launches"]
    cuts = np.nonzero(row["out"].sc.sc_prev)[0].tolist() if row["out"].sc is not None else None
    emit(dict(phase="frameinterp_deepex_path", reference_frames=cuts))
    if not cuts or cuts[:2] != [0, 2]:
        fail(f"frameinterp_deepex_path: reference frames {cuts}, expected every 2nd")
    return by_path


def exemplar_size():
    from havc_tpu_torch import exemplar

    return exemplar.smart_resize_shape(MAIN_SHAPE[2], MAIN_SHAPE[1], "medium")


# --- phase 7: CPU <-> GPU parity at test size ---------------------------------------


def tiny_engines(device_list):
    """DeOldifyWide("nano", nf_factor 1), DDColor "micro", ColorMNet
    "micro", DeOldifyDeep("nano", nf_factor 1.5) and Zhang Siggraph17 at
    width 8 with seeded weights (BatchNorm statistics and gates moved off
    their init values), one copy per device."""
    from havc_tpu_torch.models import colormnet as tcm
    from havc_tpu_torch.models import ddcolor as tdd
    from havc_tpu_torch.models import deoldify as tdo
    from havc_tpu_torch.models import zhang as tzh
    from havc_tpu_torch.models.layers import BatchNormInference, init_flax_defaults

    gen = torch.Generator().manual_seed(3)
    models = {}
    for key, m in ((("deoldify", "video"), tdo.DeOldifyWide("nano", nf_factor=1)),
                   (("ddcolor", "artistic"), tdd.DDColor.from_config("micro")),
                   (("colormnet", "micro"), tcm.ColorMNet("micro")),
                   (("deoldify", "artistic"), tdo.DeOldifyDeep("nano", nf_factor=1.5)),
                   (("zhang", "siggraph17"), tzh.Siggraph17(width=8))):
        init_flax_defaults(m, gen)
        with torch.no_grad():
            for mod in m.modules():
                if isinstance(mod, BatchNormInference):
                    mod.running_mean.add_(0.05 * torch.randn(mod.running_mean.shape, generator=gen))
                    mod.running_var.mul_(0.8 + 0.4 * torch.rand(mod.running_var.shape, generator=gen))
            for name, p in m.named_parameters():
                if name.endswith("gamma"):
                    p.fill_(0.3)
        m.eval().requires_grad_(False)
        for dev in device_list:
            models[key + (dev,)] = copy.deepcopy(m).to(dev)
    return models


def two_scene_clip() -> np.ndarray:
    """6 gray 48x64 frames, two scenes of 3: smooth fields drifting 2 px."""
    rng = np.random.default_rng(3)
    a, b = _interp_matrix(48, 6).astype(np.float32), _interp_matrix(64 + 4, 8).astype(np.float32)
    y = np.empty((6, 48, 64), np.float32)
    for s in range(2):
        field = a @ (0.2 + 0.6 * rng.random((6, 8), dtype=np.float32)) @ b.T
        for i in range(3):
            y[3 * s + i] = field[:, 2 * i:2 * i + 64]
    return np.repeat(y[..., None], 3, axis=-1)


def classic_test_clip() -> np.ndarray:
    """6 gray 136x240 frames (the Placebo tiles overlap: 2x2 tiles of
    100x152): a drifting smooth field with fine noise."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:136, 0:240].astype(np.float32)
    y = np.stack([0.5 + 0.3 * np.sin(xx / 23.0 + i / 4.0) * np.cos(yy / 17.0) for i in range(6)])
    y = np.clip(y[..., None] + 0.05 * rng.random((6, 136, 240, 1)), 0, 1).astype(np.float32)
    return np.repeat(y, 3, axis=-1)


def phase_parity(ht) -> None:
    from havc_tpu_torch import engines, exemplar

    cpu, gpu = torch.device("cpu"), torch.device("cuda", torch.cuda.current_device())
    saved = dict(engines.registry._cache)
    saved_ex = dict(exemplar._ENGINE_CACHE)
    real_do, real_dd = engines.make_deoldify_fn, engines.make_ddcolor_fn
    engines.registry._cache.update(tiny_engines([cpu, gpu]))
    exemplar._ENGINE_CACHE.clear()
    engines.make_deoldify_fn = lambda model=0, render_factor=24, **kw: real_do(model, 4, **kw)
    engines.make_ddcolor_fn = lambda model=1, render_factor=24, **kw: real_dd(model, 4, **kw)
    try:
        y = np.random.default_rng(7).random((6, 48, 64, 1), dtype=np.float32)
        two = two_scene_clip()
        colored = tinted(torch.from_numpy(two), 3).numpy()

        def main(frames, **kw):
            return lambda dev: ht.HAVC_main(ht.Clip(frames=frames.copy()), batch_size=4,
                                            device=dev, **kw)

        def allrefs(dev):  # four references: the all-refs mode needs them
            ref = ht.Clip(frames=colored.copy()).with_sc(ht.SceneFlags.from_frame_list(
                6, [0, 2, 3, 5], False))
            return ht.HAVC_deepex(ht.Clip(frames=two.copy()), ref, encode_mode=2,
                                  batch_size=4, device=dev)

        cases = [("main_path", main(np.repeat(y, 3, axis=-1))),
                 ("exemplar_path", main(two, EnableDeepEx=True)),
                 ("placebo", main(classic_test_clip(), **PLACEBO_KW)),
                 ("veryslow", main(classic_test_clip(), **VERYSLOW_KW)),
                 ("recolor_path", lambda dev: ht.HAVC_ColorAdjust(
                     ht.Clip(frames=colored.copy()), batch_size=4, device=dev)),
                 ("colortemp_path", main(two, ColorTemp="Medium")),
                 ("frameinterp_path", main(two, FrameInterp=5)),
                 ("exemplar_sources/restore_refmerge2", lambda dev: ht.HAVC_restore_video(
                     ht.Clip(frames=two.copy()), ht.Clip(frames=colored.copy()), method=5,
                     ref_merge=2, batch_size=4, device=dev)),
                 ("exemplar_sources/encode_mode2", allrefs)]
        for name, run in cases:
            out_cpu = run("cpu").frames
            out_gpu = run(None).frames
            out_gpu = out_gpu.cpu().numpy() if isinstance(out_gpu, torch.Tensor) else out_gpu
            out_cpu = out_cpu.numpy() if isinstance(out_cpu, torch.Tensor) else out_cpu
            err = float(np.abs(out_cpu - out_gpu).max())
            emit(dict(phase="parity_cpu_gpu", path=name, clip=list(out_gpu.shape),
                      max_abs_err=err, tol=PARITY_TOL,
                      mean_abs_chroma=float(np.abs(out_gpu - out_gpu.mean(-1, keepdims=True)).mean())))
            if not err <= PARITY_TOL:
                fail(f"parity_cpu_gpu {name}: max abs err {err} > {PARITY_TOL}")
    finally:
        engines.registry._cache.clear()
        engines.registry._cache.update(saved)
        exemplar._ENGINE_CACHE.clear()
        exemplar._ENGINE_CACHE.update(saved_ex)
        engines.make_deoldify_fn, engines.make_ddcolor_fn = real_do, real_dd
    phase_clahe_parity()


def engine_nets(device_list):
    """Deep-Exemplar and NetworkC at their published widths with seeded
    weights made once on the host (BatchNorm statistics moved off their
    init values, the attention gates at 0.3), one copy per device."""
    from havc_tpu_torch.models import deepex as tdx
    from havc_tpu_torch.models import remaster as trm
    from havc_tpu_torch.models.layers import init_flax_defaults

    gen = torch.Generator().manual_seed(5)
    models = {}
    for key, m in ((("deepex", "full"), tdx.DeepEx()), (("remaster", "full"), trm.NetworkC())):
        init_flax_defaults(m, gen)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith(("bn_mean", "bn_bias")):
                    p.add_(0.05 * torch.randn(p.shape, generator=gen))
                elif name.endswith(("bn_var", "bn_scale")):
                    p.mul_(0.8 + 0.4 * torch.rand(p.shape, generator=gen))
                elif name.endswith("gamma"):
                    p.fill_(0.3)
        m.eval().requires_grad_(False)
        for dev in device_list:
            models[key + (dev,)] = copy.deepcopy(m).to(dev)
    return models


ENGINE_WORK, REMASTER_WORK = (40, 64), (32, 48)  # the parity cases' cut work sizes


def phase_engine_parity(ht) -> None:
    """Deep-Exemplar, the hybrid, DeepRemaster and FrameInterp 2 at test
    size (the two-scene 6x48x64 clip; tiny classic engines and ColorMNet,
    Deep-Exemplar and NetworkC at full width with their work sizes cut to
    40x64 and 32x48) with ``device="cpu"`` and on the card.  DeepEx runs
    at temperature 1e-10, a hard argmax, and ``HAVC_main`` ends in the
    colormap's hue thresholds: those paths are held by the share of moved
    values (at most 2 % more than 1e-4 apart, none more than 0.02);
    DeepRemaster within 1e-4."""
    from havc_tpu_torch import engines, exemplar

    cpu, gpu = torch.device("cpu"), torch.device("cuda", torch.cuda.current_device())
    saved = dict(engines.registry._cache)
    saved_ex = dict(exemplar._ENGINE_CACHE)
    real = (engines.make_deoldify_fn, engines.make_ddcolor_fn, exemplar.smart_resize_shape,
            exemplar.remaster_work_shape)
    engines.registry._cache.update(tiny_engines([cpu, gpu]))
    engines.registry._cache.update(engine_nets([cpu, gpu]))
    exemplar._ENGINE_CACHE.clear()
    engines.make_deoldify_fn = lambda model=0, render_factor=24, **kw: real[0](model, 4, **kw)
    engines.make_ddcolor_fn = lambda model=1, render_factor=24, **kw: real[1](model, 4, **kw)
    exemplar.smart_resize_shape = lambda width, height, speed="medium": ENGINE_WORK
    exemplar.remaster_work_shape = lambda width, height, frame_mindim=320: REMASTER_WORK
    try:
        two = two_scene_clip()
        colored = tinted(torch.from_numpy(two), 3).numpy()

        def main(**kw):
            return lambda dev: ht.HAVC_main(ht.Clip(frames=two.copy()), batch_size=4,
                                            device=dev, **kw)

        cases = [("deepex_path", main(EnableDeepEx=True, DeepExModel=1), True),
                 ("hybrid_path", main(EnableDeepEx=True, DeepExModel=3), True),
                 ("remaster_path", lambda dev: ht.HAVC_DeepRemaster(
                     ht.Clip(frames=two.copy()), clip_ref=ht.Clip(frames=colored.copy()),
                     device=dev), False),
                 ("frameinterp_deepex_path", main(FrameInterp=2), True)]
        for name, run, binned in cases:
            out_cpu = run("cpu").frames
            out_gpu = run(None).frames
            out_gpu = out_gpu.cpu().numpy() if isinstance(out_gpu, torch.Tensor) else out_gpu
            out_cpu = out_cpu.numpy() if isinstance(out_cpu, torch.Tensor) else out_cpu
            d = np.abs(out_cpu - out_gpu)
            err, share = float(d.max()), float(np.mean(d > PARITY_TOL))
            emit(dict(phase="parity_cpu_gpu", path=name, clip=list(out_gpu.shape),
                      max_abs_err=err, share_over_tol=share, tol=PARITY_TOL,
                      tol_rule="share <= 0.02, max <= 0.02" if binned else "max",
                      mean_abs_chroma=float(np.abs(out_gpu - out_gpu.mean(-1, keepdims=True))
                                            .mean())))
            if binned and not (share <= 0.02 and err <= 0.02):
                fail(f"parity_cpu_gpu {name}: {share:.4%} of values over {PARITY_TOL}, "
                     f"max {err}")
            if not binned and not err <= PARITY_TOL:
                fail(f"parity_cpu_gpu {name}: max abs err {err} > {PARITY_TOL}")
    finally:
        engines.registry._cache.clear()
        engines.registry._cache.update(saved)
        exemplar._ENGINE_CACHE.clear()
        exemplar._ENGINE_CACHE.update(saved_ex)
        (engines.make_deoldify_fn, engines.make_ddcolor_fn, exemplar.smart_resize_shape,
         exemplar.remaster_work_shape) = real


def phase_clahe_parity() -> None:
    """CLAHE on a 1080x1920 plane (tile height 135) on the CPU and on the
    card: the tile coordinates are XLA's rounding of ``(i + 0.5) / t - 0.5``
    on both (row 67 falls just below the first tile's centre)."""
    from havc_tpu_torch.ops import equalize

    x = torch.rand((1, 1080, 1920), generator=torch.Generator().manual_seed(4))
    got = equalize.clahe_channel(x.cuda()).cpu()
    want = equalize.clahe_channel(x)
    err = float((got - want).abs().max())
    row67 = float(equalize._tile_coords(1080, 135, torch.device("cuda"))[67].item())
    emit(dict(phase="parity_cpu_gpu", path="clahe_1080", clip=[1, 1080, 1920], max_abs_err=err,
              tol=KERNEL_TOL, tile_coordinate_row_67=row67))
    if not err <= KERNEL_TOL or not row67 < 0.0:
        fail(f"parity_cpu_gpu clahe_1080: max abs err {err}, row 67 coordinate {row67}")


# --- phases 23-27: the classic surface's leftovers --------------------------------------

SCENE_STAT_TOL = 1e-4  # lumas, ratios and confirmation scores, card against CPU
FLOAT_PLANE_TOL = 1e-3  # codes: the YUV planes before the dither, card against CPU
CIEDE_PAIRS = 1_000_000


# sc_tht_ssim of the confirmation runs (sc_min_int 4): at 0.5 it rejects every
# candidate of the exemplar clip (their SSIM to the last reference is about 0.6), at
# 0.8 it rejects the custom pass's candidate at frame 4 and accepts those at 8 and 16
CONFIRM_SSIM = (0.5, 0.8)
CUTS_EXPECTED = ("HAVC_SceneDetect", "HAVC_SceneDetect/ssim_0.8_min_int_4")


def flags_row(flags) -> dict:
    return dict(cuts=np.nonzero(flags.sc_prev)[0].tolist())


def phase_scene_detectors(ht, pc, wa, card: str, tmp: str) -> dict:
    """The scene detectors on the exemplar clip (24x1080p, cuts [0, 8,
    16]) held as CUDA tensors: ``HAVC_SceneDetect`` with its defaults and
    with ``sc_tht_ssim`` 0.5 and 0.8 at ``sc_min_int=4`` (the custom and
    confirmation passes), ``HAVC_SceneDetectEdges``,
    ``HAVC_SceneDetectMotion`` and ``HAVC_extract_reference_frames(sc_algo=2)``
    into a temporary directory.  For each: the cuts, the wall time of a
    second call, the host syncs of a third; the same detector on the CPU
    from numpy must give the same flags, its lumas and ratios within 1e-4.
    The confirmation's decisions and scores are held apart
    (``confirmation_rows``).  ``StreamSceneDetector`` fed the clip in
    chunks of 5 must give the whole-clip flags.  The defaults and the 0.8
    confirmation must find the clip's cuts; at 0.5 the confirmation drops
    them (its smooth scenes are alike in structure).  Returns the kernels'
    launches by path, which must be none: the detectors are plain tensor
    code."""
    from havc_tpu_torch.scene import StreamSceneDetector, edges, motion, scene_detect

    host = scene_clip_1080p()
    frames = torch.from_numpy(host).cuda()
    runs = {
        "HAVC_SceneDetect": (lambda: ht.HAVC_SceneDetect(ht.Clip(frames=frames)).sc,
                             lambda: scene_detect(host, device="cpu")),
    }
    for tht in CONFIRM_SSIM:
        runs[f"HAVC_SceneDetect/ssim_{tht}_min_int_4"] = (
            lambda tht=tht: ht.HAVC_SceneDetect(ht.Clip(frames=frames), sc_tht_ssim=tht,
                                                sc_min_int=4).sc,
            lambda tht=tht: scene_detect(host, sc_tht_filter=tht, min_length=4, device="cpu"))
    runs.update({
        "HAVC_SceneDetectEdges": (
            lambda: ht.HAVC_SceneDetectEdges(ht.Clip(frames=frames)).sc,
            lambda: edges.scene_detect_edges(host, threshold=0.035, sc_diff_offset=2,
                                             sc_min_int=20, sc_mult_tht=15, tht_black=0.10,
                                             sc_tht_ssim=0.80, device="cpu")),
        "HAVC_SceneDetectMotion": (lambda: ht.HAVC_SceneDetectMotion(ht.Clip(frames=frames)).sc,
                                   lambda: motion.scene_detect_motion(host, device="cpu")),
    })
    by_path = {}
    for name, (run, run_cpu) in runs.items():
        run()
        zero_launches(pc, wa)
        flags, wall_s = timed(run)
        by_path[name] = read_launches(pc, wa)
        _, syncs, sites = count_syncs(run)
        cpu_flags, cpu_s = timed(run_cpu)
        luma_err = float(np.abs(flags.luma - cpu_flags.luma).max())
        ratio_err = float(np.abs(flags.ratio - cpu_flags.ratio).max())
        same = np.array_equal(flags.sc_prev, cpu_flags.sc_prev)
        emit(dict(phase="scene_detectors", card=card, path=name, clip=list(frames.shape),
                  cuts=flags_row(flags)["cuts"], cpu_cuts=flags_row(cpu_flags)["cuts"],
                  wall_s=wall_s, fps=frames.shape[0] / wall_s, host_syncs=syncs,
                  sync_sites=sites, cpu_wall_s=cpu_s, luma_max_abs_err=luma_err,
                  ratio_max_abs_err=ratio_err, tol=SCENE_STAT_TOL))
        if not same:
            fail(f"scene_detectors {name}: card cuts {flags_row(flags)['cuts']} != CPU cuts "
                 f"{flags_row(cpu_flags)['cuts']}")
        if not (luma_err <= SCENE_STAT_TOL and ratio_err <= SCENE_STAT_TOL):
            fail(f"scene_detectors {name}: statistics differ from the CPU's ({luma_err}, "
                 f"{ratio_err})")
        if name in CUTS_EXPECTED and flags_row(flags)["cuts"] != EX_CUTS:
            fail(f"scene_detectors {name}: cuts {flags_row(flags)['cuts']} != {EX_CUTS}")
        if any(by_path[name].values()):
            fail(f"scene_detectors {name}: kernel launches {by_path[name]} (expected none)")
    for tht in CONFIRM_SSIM:
        confirmation_rows(frames, host, tht, card)

    # the reference export with the Xvid keyframe vote
    def extract():
        return ht.HAVC_extract_reference_frames(ht.Clip(frames=frames), sc_framedir=f"{tmp}/refs",
                                                sc_algo=2, ref_ext="png")

    extract()
    zero_launches(pc, wa)
    written, wall_s = timed(extract)
    by_path["HAVC_extract_reference_frames/sc_algo2"] = read_launches(pc, wa)
    _, syncs, sites = count_syncs(extract)
    gpu_x = motion.scene_detect_xvid(frames)
    cpu_x = motion.scene_detect_xvid(host, device="cpu")
    x_err = max(float(np.abs(gpu_x.luma - cpu_x.luma).max()),
                float(np.abs(gpu_x.ratio - cpu_x.ratio).max()))
    emit(dict(phase="scene_detectors", card=card, path="HAVC_extract_reference_frames/sc_algo2",
              written=[os.path.basename(p) for p in written], cuts=flags_row(gpu_x)["cuts"],
              cpu_cuts=flags_row(cpu_x)["cuts"], wall_s=wall_s, host_syncs=syncs,
              sync_sites=sites, stat_max_abs_err=x_err, tol=SCENE_STAT_TOL))
    want_files = [f"ref_{n:06d}.png" for n in flags_row(gpu_x)["cuts"]]
    if [os.path.basename(p) for p in written] != want_files:
        fail(f"scene_detectors extract: wrote {written}, expected {want_files}")
    if any(by_path["HAVC_extract_reference_frames/sc_algo2"].values()):
        fail(f"scene_detectors extract: kernel launches "
             f"{by_path['HAVC_extract_reference_frames/sc_algo2']} (expected none)")
    if not np.array_equal(gpu_x.sc_prev, cpu_x.sc_prev) or not x_err <= SCENE_STAT_TOL:
        fail(f"scene_detectors extract: card and CPU differ ({flags_row(gpu_x)}, "
             f"{flags_row(cpu_x)}, {x_err})")

    # the streaming detector, fed in chunks of 5, against the whole clip
    for name, kw in [("defaults", {})] + [(f"ssim_{tht}_min_int_4",
                                           dict(sc_tht_filter=tht, min_length=4))
                                          for tht in CONFIRM_SSIM]:
        stream = StreamSceneDetector(**kw)

        def feed():
            return np.concatenate([stream.feed(frames[s:s + 5])
                                   for s in range(0, frames.shape[0], 5)])

        got, wall_s = timed(feed)
        want = scene_detect(frames, **kw).sc_prev
        emit(dict(phase="scene_detectors", card=card, path=f"StreamSceneDetector/{name}",
                  chunk=5, cuts=np.nonzero(got)[0].tolist(), wall_s=wall_s,
                  tail_on_card=bool(stream._tail.is_cuda)))
        if not np.array_equal(got, want) or not stream._tail.is_cuda:
            fail(f"scene_detectors StreamSceneDetector {name}: {np.nonzero(got)[0].tolist()} != "
                 f"{np.nonzero(want)[0].tolist()}")
    return by_path


def confirmation_rows(frames: torch.Tensor, host: np.ndarray, tht_ssim: float,
                      card: str) -> None:
    """The confirmation pass (``sc_tht_ssim``, ``sc_min_int=4``) on the card
    and on the CPU: its decisions must be equal, and each candidate's SSIM
    and histogram scores against the last accepted reference, unrounded
    and computed from each side's gray maps, within 1e-4.  Each row shows
    the scores' distances from their thresholds (SSIM from ``sc_tht_ssim``,
    histogram from ``DEF_HIST_SCORE_HIGH``)."""
    from havc_tpu_torch.scene import detect as d

    records = {}
    for side, x, dev in (("card", frames, None), ("cpu", host, "cpu")):
        det = d.SceneDetector(sc_tht_filter=tht_ssim, min_length=4, debug=True, device=dev)
        det.detect(x)
        records[side] = det.debug_records
    maps = {"card": d.frame_stats(frames), "cpu": d.frame_stats(host, device="cpu")}
    key = ("state", "frame", "prev", "reason")
    decisions = {side: [tuple(r[k] for k in key) for r in recs]
                 for side, recs in records.items()}
    rows, worst = [], 0.0
    for r in records["card"]:
        n, prev = r["frame"], r["prev"]
        if prev < 0:
            continue
        score = {}
        for side, (grays, _, _, hists) in maps.items():
            score[side] = (d._ssim_uniform(grays[n], grays[prev]),
                           1.0 - d._hellinger(hists[prev], hists[n]))
        err = max(abs(a - b) for a, b in zip(score["card"], score["cpu"]))
        worst = max(worst, err)
        rows.append(dict(frame=n, prev=prev, state=r["state"], reason=r["reason"],
                         ssim=score["card"][0], ssim_cpu=score["cpu"][0],
                         ssim_minus_threshold=score["card"][0] - tht_ssim,
                         hist=score["card"][1], hist_cpu=score["cpu"][1],
                         hist_minus_threshold=score["card"][1] - d.DEF_HIST_SCORE_HIGH))
    accepted = [r["frame"] for r in rows if r["state"] == "New"]
    emit(dict(phase="scene_detectors", card=card, path=f"confirmation/ssim_{tht_ssim}_min_int_4",
              candidates=rows, accepted=accepted, score_max_abs_err=worst, tol=SCENE_STAT_TOL))
    if decisions["card"] != decisions["cpu"]:
        fail(f"scene_detectors confirmation {tht_ssim}: card decisions {decisions['card']} != "
             f"CPU decisions {decisions['cpu']}")
    if not rows or not worst <= SCENE_STAT_TOL:
        fail(f"scene_detectors confirmation {tht_ssim}: {len(rows)} candidates scored, scores "
             f"{worst} apart (at most {SCENE_STAT_TOL})")


OVERLAY_KW = dict(x=100, y=50, opacity=0.7, mode="overlay")


def peak_run(run, pc, wa):
    """(result, seconds, peak device memory, kernel launches) of a call
    after a warm-up; the launch counts are set to 0 just before it."""
    run()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(pc, wa)
    out, wall_s = timed(run)
    return out, wall_s, torch.cuda.max_memory_allocated(), read_launches(pc, wa)


def phase_overlay_degrain(ht, pc, wa, card: str) -> dict:
    """``HAVC_clip_overlay`` (mode overlay, a 540x960 colored overlay at
    x=100, y=50 with a mask, opacity 0.7) and ``HAVC_degrain`` at strengths
    1 and 3 (search windows of 9 and 49 offsets) on the main path's
    24x1080p clip: wall time, fps, peak memory and kernel launches of a
    second call (none: the paths are plain tensor code); then
    both on the CPU and on the card at test size (6x48x64) within 1e-4."""
    base = gray_clip_1080p()
    over = tinted(base[:, 200:740, 300:1260].contiguous(), 8)
    mask = torch.linspace(0.0, 1.0, 960, device="cuda").expand(24, 540, 960)[..., None]
    mask = mask.expand(24, 540, 960, 3).contiguous()
    runs = {
        "HAVC_clip_overlay": lambda: ht.HAVC_clip_overlay(
            ht.Clip(frames=base), ht.Clip(frames=over), mask=ht.Clip(frames=mask),
            **OVERLAY_KW),
        "HAVC_degrain/1": lambda: ht.HAVC_degrain(ht.Clip(frames=base), 1),
        "HAVC_degrain/3": lambda: ht.HAVC_degrain(ht.Clip(frames=base), 3),
    }
    by_path = {}
    for name, run in runs.items():
        out, wall_s, peak, by_path[name] = peak_run(run, pc, wa)
        f = out.frames
        finite = bool(torch.isfinite(f).all().item())
        lo, hi = f.min().item(), f.max().item()
        changed = float((f - base).abs().mean())
        emit(dict(phase="overlay_degrain", card=card, path=name, clip=list(f.shape),
                  wall_s=wall_s, fps=f.shape[0] / wall_s, max_memory_allocated=peak,
                  mean_abs_change=changed, out_min=lo, out_max=hi))
        if tuple(f.shape) != tuple(base.shape) or not finite or lo < 0.0 or hi > 1.0:
            fail(f"overlay_degrain {name}: output {tuple(f.shape)} finite={finite} in "
                 f"[{lo}, {hi}]")
        if not changed > 0.0:
            fail(f"overlay_degrain {name}: the output equals the input")
        if any(by_path[name].values()):
            fail(f"overlay_degrain {name}: kernel launches {by_path[name]} on a path of plain "
                 f"tensor code (expected none)")
    small = np.random.default_rng(9).random((6, 48, 64, 3), dtype=np.float32)
    small_over, small_mask = small[:, 5:25, 10:40] * 0.8, small[:, 10:30, 20:50]
    cases = {
        "overlay": lambda dev: ht.HAVC_clip_overlay(
            ht.Clip(frames=small.copy()), ht.Clip(frames=small_over.copy()),
            mask=ht.Clip(frames=small_mask.copy()), x=-4, y=30, opacity=0.7, mode="overlay",
            mask_first_plane=False, device=dev),
        "degrain_3": lambda dev: ht.HAVC_degrain(ht.Clip(frames=small.copy()), 3, device=dev),
    }
    for name, run in cases.items():
        err = float(np.abs(run("cpu").frames - run(None).frames).max())
        emit(dict(phase="parity_cpu_gpu", path=f"overlay_degrain/{name}", clip=list(small.shape),
                  max_abs_err=err, tol=PARITY_TOL))
        if not err <= PARITY_TOL:
            fail(f"parity_cpu_gpu overlay_degrain/{name}: max abs err {err} > {PARITY_TOL}")
    return by_path


def phase_restore_format(ht, out_frames: torch.Tensor, fps: float, card: str, tmp: str) -> None:
    """``io.write_video_y4m`` of the main path's 24x1080p output (BT.709,
    limited range, 4:2:0, Floyd-Steinberg): the device part (matrix,
    range, subsample, one copy to the host) and the host dither timed
    apart, then the whole write; read back with ``Y4MReader``, the planes
    equal what was written, the round trip's PSNR, and the largest code
    gap against the same write from the CPU's float planes (at most 1
    code: error diffusion passes an error of at most half a code on; the
    float planes before the dither within 1e-3 code)."""
    from havc_tpu_torch.io import Y4MReader, formats, native
    from havc_tpu_torch.io.video import write_video_y4m

    t0 = time.perf_counter()
    native.load_native()
    build_s = time.perf_counter() - t0
    args = ("709", False, 8, "420")
    formats._code_planes(out_frames, *args)
    planes, device_s = timed(lambda: formats._code_planes(out_frames, *args))
    t0 = time.perf_counter()
    codes = formats._quantize(planes, 8, False, "error_diffusion")
    dither_s = time.perf_counter() - t0
    path = f"{tmp}/main_out.y4m"
    clip = ht.Clip(frames=out_frames, fps=fps)
    _, write_s = timed(lambda: write_video_y4m(clip, path))
    _, syncs, _ = count_syncs(lambda: formats._code_planes(out_frames, *args))
    with Y4MReader(path) as reader:
        back = reader.read_planes(out_frames.shape[0] + 1)
        geometry = (reader.width, reader.height, reader.fps)
    same = all(np.array_equal(a, b) for a, b in zip(back, codes))
    rgb = formats.yuv420p8_to_rgb(*back)
    mse = float(((rgb - out_frames) ** 2).mean())
    psnr = 10.0 * np.log10(1.0 / mse)
    host = out_frames.cpu().numpy()
    cpu_planes, cpu_s = timed(lambda: formats._code_planes(host, *args, device="cpu"))
    plane_err = max(float(np.abs(a - b).max()) for a, b in zip(planes, cpu_planes))
    cpu_codes = formats._quantize(cpu_planes, 8, False, "error_diffusion")
    gaps = [int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
            for a, b in zip(codes, cpu_codes)]
    moved = [float(np.mean(a != b)) for a, b in zip(codes, cpu_codes)]
    emit(dict(phase="restore_format", card=card, clip=list(out_frames.shape),
              native_build_s=build_s, device_part_s=device_s, host_dither_s=dither_s,
              write_video_y4m_s=write_s, bytes=os.path.getsize(path), device_part_host_syncs=syncs,
              read_back_equal=same, geometry=list(geometry), psnr_round_trip_db=psnr,
              cpu_device_part_s=cpu_s, float_plane_max_abs_err_codes=plane_err,
              max_code_gap_vs_cpu=gaps, share_codes_moved_vs_cpu=moved))
    if not same or back[0].shape != tuple(out_frames.shape[:3]):
        fail("restore_format: the .y4m read back differs from the planes written")
    if max(gaps) > 1:
        fail(f"restore_format: codes {gaps} apart from the CPU's (at most 1)")
    if not psnr > 30.0:
        fail(f"restore_format: round-trip PSNR {psnr} dB")
    if not plane_err <= FLOAT_PLANE_TOL:
        fail(f"restore_format: float planes {plane_err} codes apart from the CPU's "
             f"(at most {FLOAT_PLANE_TOL})")


def hue_branch_pairs(lab1: torch.Tensor, lab2: torch.Tensor, within: float = 1e-3):
    """Pairs whose hue difference lies within ``within`` degrees of 180
    (float64): there CIEDE2000's mean hue takes one branch or the other
    (180 degrees apart) on rounding alone."""
    a1, b1 = lab1[:, 1].double(), lab1[:, 2].double()
    a2, b2 = lab2[:, 1].double(), lab2[:, 2].double()
    cbar = 0.5 * (torch.hypot(a1, b1) + torch.hypot(a2, b2))
    g = 0.5 * (1.0 - torch.sqrt(cbar**7 / (cbar**7 + 25.0**7)))
    h1 = torch.rad2deg(torch.atan2(b1, (1 + g) * a1)) % 360.0
    h2 = torch.rad2deg(torch.atan2(b2, (1 + g) * a2)) % 360.0
    return ((h1 - h2).abs() - 180.0).abs() < within


def phase_metrics(ht, main_cpu: np.ndarray, main_gpu: torch.Tensor) -> None:
    """``metrics.compare_clip`` of the test-sized main path's card output
    against its CPU output (on the card), and ``ciede2000`` on 10^6 seeded
    LAB pairs on the card against the CPU within 1e-4: LAB of seeded RGB
    pairs (near and far), achromatic pairs and axis-aligned opposite hues
    (exactly 180 degrees apart).  Pairs of random hues within 1e-3 degrees
    of 180 apart, where the formula's mean hue flips branch on rounding,
    are counted and their error shown apart."""
    from havc_tpu_torch import metrics
    from havc_tpu_torch.ops.colorspace import ciede2000, rgb_to_lab

    stats, wall_s = timed(lambda: metrics.compare_clip(main_gpu, main_cpu))
    gen = torch.Generator().manual_seed(11)
    c1 = torch.rand((CIEDE_PAIRS, 3), generator=gen)
    c2 = (c1 + 0.1 * torch.randn((CIEDE_PAIRS, 3), generator=gen)).clamp(0, 1)
    c2[: CIEDE_PAIRS // 2] = torch.rand((CIEDE_PAIRS // 2, 3), generator=gen)
    lab1, lab2 = rgb_to_lab(c1), rgb_to_lab(c2)
    lab1[:1000, 1:] = 0.0  # achromatic against colored
    lab2[1000:2000, 1:] = 0.0  # both achromatic
    lab1[1000:2000, 1:] = 0.0
    lab1[2000:3000, 2] = 0.0  # hues 0 and 180 degrees
    lab2[2000:3000, 1:] = torch.stack([-lab1[2000:3000, 1], lab1[2000:3000, 2]], dim=-1)
    lab1[3000:4000, 1] = 0.0  # hues 90 and 270 degrees (atan2 -90)
    lab2[3000:4000, 1:] = torch.stack([lab1[3000:4000, 1], -lab1[3000:4000, 2]], dim=-1)
    want = ciede2000(lab1, lab2)
    g1, g2 = lab1.cuda(), lab2.cuda()
    got = ciede2000(g1, g2).cpu()
    d = (got - want).abs()
    branch = hue_branch_pairs(lab1, lab2)
    branch[:4000] = False  # the axis-aligned pairs: atan2 is exact there
    err = float(d[~branch].max())
    branch_err = float(d[branch].max()) if bool(branch.any()) else 0.0
    special_err = float(d[:4000].max())
    ms = cuda_ms(lambda: ciede2000(g1, g2), reps=5, inner=5)
    emit(dict(phase="metrics", path="main_path parity size (card vs CPU)",
              compare_clip=stats, compare_clip_s=wall_s, ciede2000_pairs=CIEDE_PAIRS,
              ciede2000_max_abs_err=err, ciede2000_special_pairs_max_abs_err=special_err,
              ciede2000_hue_branch_pairs=int(branch.sum()),
              ciede2000_hue_branch_max_abs_err=branch_err, ciede2000_max=float(want.max()),
              ciede2000_ms=ms, tol=PARITY_TOL))
    if not err <= PARITY_TOL:
        fail(f"metrics: ciede2000 card vs CPU {err} > {PARITY_TOL}")
    if not (np.isfinite(stats["dE2000_mean"]) and stats["dE2000_mean"] < 0.1):
        fail(f"metrics: the main path's CPU and card outputs differ by dE2000 {stats}")


def phase_legacy_paths(ht, pc, wa, card: str) -> dict:
    """The legacy wrappers at 1080p: ``ddeoldify_main(clip)`` on the main
    path's clip (Fast, Stable, Violet/Red: the Fast presets' stabilizer
    runs the colormap only, so no post-chain launch, as in the JAX
    package), ``ddeoldify_stabilizer(clip, dark=True, smooth=True)`` on
    that clip tinted (the fused post chain: one launch) and
    ``HAVC_cmnet(clip, clip_ref)`` on the exemplar clip with its tinted
    references at the cuts (the full ColorMNet: window attention on the 21
    other frames).  Their launches go into ``launches_by_path``."""
    frames = gray_clip_1080p()
    colored = tinted(frames, 8)
    runs = {
        "ddeoldify_main": (lambda: ht.ddeoldify_main(ht.Clip(frames=frames)), 0),
        "ddeoldify_stabilizer": (lambda: ht.ddeoldify_stabilizer(
            ht.Clip(frames=colored), dark=True, smooth=True), 1),
    }
    by_path = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for name, (run, want) in runs.items():
            _, first_s = timed(run)
            zero_launches(pc, wa)
            out, wall_s = timed(run)
            by_path[name] = read_launches(pc, wa)
            f = out.frames
            finite = bool(torch.isfinite(f).all().item())
            emit(dict(phase="legacy_paths", card=card, path=name, clip=list(f.shape),
                      first_call_s=first_s, wall_s=wall_s, fps=f.shape[0] / wall_s,
                      launches=by_path[name],
                      mean_abs_chroma=(f - f.mean(-1, keepdim=True)).abs().mean().item()))
            if by_path[name]["post_chain"] != want or not finite:
                fail(f"legacy_paths {name}: post chain {by_path[name]['post_chain']} launches "
                     f"(expected {want}), finite={finite}")
        del out, f, colored
        ex = torch.from_numpy(scene_clip_1080p()).cuda()
        ref = ht.Clip(frames=tinted(ex, 8)).with_sc(
            ht.SceneFlags.from_frame_list(ex.shape[0], EX_CUTS, False))

        def run_cmnet():
            return ht.HAVC_cmnet(ht.Clip(frames=ex), ref, engine_config="full")

        row = drive_exemplar_path(ht, pc, wa, card, "legacy_paths/HAVC_cmnet", run_cmnet,
                                  ex.shape[0])
    want_calls = ex.shape[0] - len(EX_CUTS)
    if row["window_attn_calls"] != want_calls:
        fail(f"legacy_paths HAVC_cmnet: window attention {row['window_attn_calls']} calls, "
             f"expected {want_calls}")
    by_path["HAVC_cmnet"] = row["launches"]
    return by_path


def phase_leftover_parity(ht) -> None:
    """At test size with the tiny engines of ``parity_cpu_gpu``:
    ``HAVC_ddeoldify`` and ``HAVC_cmnet`` on the card bit-identical to
    ``HAVC_colorizer`` and ``HAVC_deepex(ex_model=0)``, which they forward
    to; then the main path on the CPU and on the card for ``metrics``."""
    from havc_tpu_torch import api, engines, exemplar

    cpu, gpu = torch.device("cpu"), torch.device("cuda", torch.cuda.current_device())
    saved = dict(engines.registry._cache)
    saved_ex = dict(exemplar._ENGINE_CACHE)
    real_do, real_dd = engines.make_deoldify_fn, engines.make_ddcolor_fn
    engines.registry._cache.update(tiny_engines([cpu, gpu]))
    exemplar._ENGINE_CACHE.clear()
    engines.make_deoldify_fn = lambda model=0, render_factor=24, **kw: real_do(model, 4, **kw)
    engines.make_ddcolor_fn = lambda model=1, render_factor=24, **kw: real_dd(model, 4, **kw)
    try:
        two = two_scene_clip()
        gray = torch.from_numpy(two).cuda()
        ref = ht.Clip(frames=tinted(gray, 3)).with_sc(ht.SceneFlags.from_frame_list(6, [0, 3],
                                                                                    False))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            pairs = {
                "HAVC_ddeoldify": (
                    ht.HAVC_ddeoldify(ht.Clip(frames=gray), sc_threshold=0.1, batch_size=4),
                    api.HAVC_colorizer(ht.Clip(frames=gray), sc_threshold=0.1, batch_size=4,
                                       cmc_p=[0.2] + list(api.DEF_CMC_p[1:]),
                                       lmm_p=(0.2, 0.8, 1.0), alm_p=(0.8, 1.0, 0.15))),
                "HAVC_cmnet": (ht.HAVC_cmnet(ht.Clip(frames=gray), ref, batch_size=4),
                               ht.HAVC_deepex(ht.Clip(frames=gray), ref, ex_model=0,
                                              batch_size=4)),
            }
        for name, (got, want) in pairs.items():
            equal = bool(torch.equal(got.frames, want.frames))
            emit(dict(phase="legacy_paths", path=f"{name} (test size)", clip=list(gray.shape),
                      bit_identical_to_target=equal))
            if not equal:
                fail(f"legacy_paths {name}: not bit-identical to the call it forwards to")
        y = np.random.default_rng(7).random((6, 48, 64, 1), dtype=np.float32)
        main = np.repeat(y, 3, axis=-1)
        out_cpu = ht.HAVC_main(ht.Clip(frames=main.copy()), batch_size=4, device="cpu").frames
        out_gpu = ht.HAVC_main(ht.Clip(frames=torch.from_numpy(main).cuda()),
                               batch_size=4).frames
    finally:
        engines.registry._cache.clear()
        engines.registry._cache.update(saved)
        exemplar._ENGINE_CACHE.clear()
        exemplar._ENGINE_CACHE.update(saved_ex)
        engines.make_deoldify_fn, engines.make_ddcolor_fn = real_do, real_dd
    phase_metrics(ht, out_cpu, out_gpu)


# --- phases 8, 9: the streaming paths ---------------------------------------------------

STREAM_T = 136  # frames of the streaming clip (about 0.42 GB of .y4m)
STEADY_T = 520  # frames of the steady-state clip (about 1.6 GB of .y4m)
RESTORE_T, RESTORE_CUTS = 48, [0, 16, 32]


def write_y4m(path: str, frames, h: int, w: int, chroma=None) -> None:
    """A C420mpeg2 .y4m of float [0, 1] gray ``frames`` (Y = round(255 y));
    ``chroma(i)`` gives frame i's (U, V) planes, else neutral 128."""
    neutral = np.full(h * w // 2, 128, np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C420mpeg2\n".encode())
        for i, y in enumerate(frames):
            f.write(b"FRAME\n")
            f.write(np.rint(np.clip(y, 0.0, 1.0) * 255.0).astype(np.uint8).tobytes())
            if chroma is None:
                f.write(neutral)
            else:
                for plane in chroma(i):
                    f.write(plane.tobytes())


class Recorder:
    """While active: what every ``_WritePipeline._retire`` receives (the
    packed chunk and, in uv420 mode, the host's Y planes), and every write
    pipeline and upload ring made, for their event-wait counts."""

    def __init__(self, streaming, keep_bytes: bool = True):
        self.s, self.keep = streaming, keep_bytes
        self.packed, self.y, self.pipes, self.uploaders = [], [], [], []

    def __enter__(self):
        s, rec = self.s, self
        self.saved = (s._WritePipeline._retire, s._WritePipeline.__init__, s._Uploader.__init__)
        retire, pipe_init, up_init = self.saved

        def spy_retire(pipe, packed, meta, n):
            if rec.keep:
                rec.packed.append(np.array(packed.wait())[:n])
                yp = pipe.y_provider
                if pipe.use_uv420:
                    def y_spy(m, k):
                        y = yp(m, k)
                        rec.y.append(np.array(y)[:k])
                        return y
                    pipe.y_provider = y_spy
                try:
                    return retire(pipe, packed, meta, n)
                finally:
                    pipe.y_provider = yp
            return retire(pipe, packed, meta, n)

        def spy_pipe_init(pipe, *a, **kw):
            pipe_init(pipe, *a, **kw)
            rec.pipes.append(pipe)

        def spy_up_init(up, *a, **kw):
            up_init(up, *a, **kw)
            rec.uploaders.append(up)

        s._WritePipeline._retire = spy_retire
        s._WritePipeline.__init__ = spy_pipe_init
        s._Uploader.__init__ = spy_up_init
        return self

    def __exit__(self, *exc):
        s = self.s
        s._WritePipeline._retire, s._WritePipeline.__init__, s._Uploader.__init__ = self.saved

    def waits(self) -> dict:
        """Retires that found their chunk's event pending, and uploads that
        found their staging buffer in flight."""
        return dict(retire_event_waits=sum(p.waits for p in self.pipes),
                    upload_slot_waits=sum(u.waits for u in self.uploaders))

    def joined(self, what: str) -> np.ndarray:
        return np.concatenate(getattr(self, what)).astype(np.int16)


def count_syncs(run):
    """Run ``run()`` with the CUDA sync debug mode on: (its result, the
    host syncs PyTorch reported, their first sites)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return out, len(syncs), sorted(set(syncs))[:6]


def timed(run):
    """(result, seconds) of ``run()``, ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def chroma_stats(uv: np.ndarray) -> dict:
    """Mean distance of the U/V bytes from neutral 128."""
    return dict(mean_abs_uv_minus_128=float(np.abs(uv.astype(np.float32) - 128.0).mean()))


def phase_streaming(ht, pc, wa, card: str, tmp: str, has_cv2: bool):
    from havc_tpu_torch import streaming
    from havc_tpu_torch.utils import enable_profiling, reset_stages, stage_times

    h, w = MAIN_SHAPE[1:]
    src = f"{tmp}/stream_gray.y4m"
    t0 = time.perf_counter()
    write_y4m(src, smooth_frames(STREAM_T, 17, 9, h, w), h, w)
    write_s = time.perf_counter() - t0

    def run(**kw):
        return ht.HAVC_main_streaming(src, f"{tmp}/unused.mp4", **dict(dict(sink="null"), **kw))

    t0 = time.perf_counter()
    first_n = run(count=72)  # first call: cuDNN algorithm selection, resize matrices
    first_s = time.perf_counter() - t0

    # the second call, every frame with its transfers; the kernel counts
    # are zeroed just before it and read just after
    zero_launches(pc, wa)
    torch.cuda.reset_peak_memory_stats()
    with Recorder(streaming, keep_bytes=False) as rec:
        (n, sync_n, sync_sites), wall_s = timed(lambda: count_syncs(lambda: run()))
    launches = read_launches(pc, wa)
    transfer = streaming.last_transfer()
    peak_136 = torch.cuda.max_memory_allocated()
    waits = rec.waits()

    torch.cuda.reset_peak_memory_stats()
    with Recorder(streaming) as rec72:
        (n72, wall72_s) = timed(lambda: run(count=72))
    peak_72 = torch.cuda.max_memory_allocated()
    uv72, y72 = rec72.joined("packed"), rec72.joined("y")

    (n_dev, dev_s) = timed(lambda: run(source="device", sink="device", count=128))

    enable_profiling(True)
    reset_stages()
    _, profiled_s = timed(lambda: run(count=72))
    enable_profiling(False)
    stages = {k: v[0] for k, v in stage_times().items()}

    # steady state: with pipeline depth 3 and chunk 64, 192 frames and a
    # halo are in flight, so in the 136-frame clip no chunk retires before
    # the decode ends; in a clip several times longer the retires (and
    # their host Y tail) overlap the card's work, as in a film
    long_src = f"{tmp}/stream_long.y4m"
    write_y4m(long_src, smooth_frames(STEADY_T, 17, 11, h, w), h, w)
    (n_long, long_s) = timed(lambda: ht.HAVC_main_streaming(long_src, f"{tmp}/unused.mp4",
                                                            sink="null"))
    os.remove(long_src)
    (n_long_dev, long_dev_s) = timed(lambda: run(source="device", sink="device", count=STEADY_T))

    peak_ratio = abs(peak_136 - peak_72) / peak_136
    chunks = -(-STREAM_T // 64)
    emit(dict(phase="streaming", card=card, clip=[STREAM_T, h, w], source_y4m_bytes=os.path.getsize(src),
              write_y4m_s=write_s, first_call_frames=first_n, first_call_s=first_s,
              frames=n, wall_s=wall_s, fps=n / wall_s, transfer=transfer,
              host_syncs=sync_n, sync_sites=sync_sites, chunks=chunks,
              host_syncs_per_chunk=sync_n / chunks, **waits,
              max_memory_allocated_136=peak_136, max_memory_allocated_72=peak_72,
              peak_memory_rel_diff=peak_ratio, frames_72=n72, wall_72_s=wall72_s,
              compute_only_frames=n_dev, compute_only_s=dev_s, compute_only_fps=n_dev / dev_s,
              stage_timed_wall_72_s=profiled_s, stages_s=stages, launches=launches,
              steady_frames=n_long, steady_wall_s=long_s, steady_fps=n_long / long_s,
              steady_compute_only_frames=n_long_dev, steady_compute_only_s=long_dev_s,
              steady_compute_only_fps=n_long_dev / long_dev_s,
              out_uv_shape=list(uv72.shape), out_y_range=[int(y72.min()), int(y72.max())],
              **chroma_stats(uv72)))
    if (n, n72, n_dev, n_long, n_long_dev) != (STREAM_T, 72, 128, STEADY_T, STEADY_T):
        fail(f"streaming: frames written {n}, {n72}, {n_dev}, {n_long}, {n_long_dev} != "
             f"{STREAM_T}, 72, 128, {STEADY_T}, {STEADY_T}")
    if transfer != "gray+uv420":
        fail(f"streaming: transfer modes {transfer} != gray+uv420")
    if tuple(uv72.shape) != (72, h // 2, w) or tuple(y72.shape) != (72, h, w):
        fail(f"streaming: retired shapes {uv72.shape}, {y72.shape}")
    if y72.min() < 16 or y72.max() > 235 or chroma_stats(uv72)["mean_abs_uv_minus_128"] <= 0.0:
        fail("streaming: studio-swing Y out of [16, 235] or no chroma")
    if peak_ratio > 0.02:
        fail(f"streaming: peak memory at 72 and {STREAM_T} frames differ by {peak_ratio:.2%}")
    if sync_n > chunks + 1:
        fail(f"streaming: {sync_n} host syncs over {chunks} chunks")
    if has_cv2:
        phase_streaming_video_sink(streaming, tmp)
    return run, wall_s, launches


def phase_streaming_video_sink(streaming, tmp: str) -> None:
    """One ``sink="video"`` round trip: encode an mp4 and decode it back."""
    import cv2

    src, out = f"{tmp}/small.y4m", f"{tmp}/small.mp4"
    write_y4m(src, smooth_frames(24, 8, 4, 180, 320), 180, 320)
    n = streaming.HAVC_main_streaming(src, out, chunk_size=16)
    cap = cv2.VideoCapture(out)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr)
    cap.release()
    emit(dict(phase="streaming_video_sink", frames_written=n, frames_decoded=len(frames),
              shape=list(frames[0].shape) if frames else None))
    if n != 24 or len(frames) != 24 or frames[0].shape != (180, 320, 3):
        fail("streaming_video_sink: the encoded mp4 does not decode to 24 frames of 180x320")


def phase_streaming_parity(tmp: str) -> None:
    """The test-sized streaming path (tiny engines, render factor 4) with
    ``device="cpu"`` and on the card: the packed bytes within 1 code."""
    from havc_tpu_torch import engines, streaming

    cpu, gpu = torch.device("cpu"), torch.device("cuda", torch.cuda.current_device())
    src = f"{tmp}/parity.y4m"
    write_y4m(src, smooth_frames(40, 10, 6, 48, 64), 48, 64)
    saved = dict(engines.registry._cache)
    real_do, real_dd = engines.make_deoldify_fn, engines.make_ddcolor_fn
    engines.registry._cache.update(tiny_engines([cpu, gpu]))
    engines.make_deoldify_fn = lambda model=0, render_factor=24, **kw: real_do(model, 4, **kw)
    engines.make_ddcolor_fn = lambda model=1, render_factor=24, **kw: real_dd(model, 4, **kw)
    try:
        outs = {}
        for name, kw in (("streaming", {}), ("streaming_tuned", dict(BWTune="Light", LUT=2))):
            for dev in ("cpu", None):
                with Recorder(streaming) as rec:
                    streaming.HAVC_main_streaming(src, "unused.mp4", chunk_size=16, sink="null",
                                                  device=dev, **kw)
                outs[name, dev] = (rec.joined("packed"), rec.y and rec.joined("y"))
    finally:
        engines.registry._cache.clear()
        engines.registry._cache.update(saved)
        engines.make_deoldify_fn, engines.make_ddcolor_fn = real_do, real_dd
    for name in ("streaming", "streaming_tuned"):
        (p_cpu, y_cpu), (p_gpu, y_gpu) = outs[name, "cpu"], outs[name, None]
        diff = np.abs(p_cpu - p_gpu)
        y_equal = bool(np.array_equal(y_cpu, y_gpu))  # uv420: the host's Y planes
        emit(dict(phase="parity_cpu_gpu", path=name, clip=[40, 48, 64],
                  packed_shape=list(p_gpu.shape), max_abs_code_diff=int(diff.max()),
                  unequal_share=float(np.mean(diff > 0)), y_planes_equal=y_equal, tol_codes=1))
        if diff.max() > 1 or not y_equal:
            fail(f"parity_cpu_gpu {name}: max code diff {diff.max()}, Y planes equal {y_equal}")


def restore_chroma(i: int, h: int, w: int):
    """The colored reference's (U, V) planes at frame ``i``: a tint per
    scene of 16 frames, varying smoothly across the frame."""
    scene = i // 16
    du, dv = [(-40, 30), (35, -25), (20, 40)][scene % 3]
    yy, xx = np.mgrid[0:h // 2, 0:w // 2].astype(np.float32)
    ramp = 12.0 * np.sin(xx / 97.0 + scene) * np.cos(yy / 71.0)
    u = np.clip(np.rint(128 + du + ramp), 0, 255).astype(np.uint8)
    v = np.clip(np.rint(128 + dv - ramp), 0, 255).astype(np.uint8)
    return u, v


def phase_restore_streaming(pc, wa, card: str, tmp: str):
    from havc_tpu_torch import exemplar, streaming
    from havc_tpu_torch.utils import enable_profiling, reset_stages, stage_times

    h, w = MAIN_SHAPE[1:]
    src, ref = f"{tmp}/restore_gray.y4m", f"{tmp}/restore_ref.y4m"
    write_y4m(src, smooth_frames(RESTORE_T, 16, 49, h, w), h, w)
    write_y4m(ref, smooth_frames(RESTORE_T, 16, 49, h, w), h, w,
              chroma=lambda i: restore_chroma(i, h, w))
    flags = []
    real_propagate = exemplar.colormnet_propagate

    def propagate(engine, frames, ref_ab, is_ref, **kw):
        flags.append(np.asarray(is_ref))
        return real_propagate(engine, frames, ref_ab, is_ref, **kw)

    def run(chunk_size=16):
        return streaming.HAVC_restore_video_streaming(
            src, ref, f"{tmp}/unused.mp4", ex_model=0, engine_config="full",
            chunk_size=chunk_size, sink="null")

    exemplar.colormnet_propagate = propagate
    try:
        with Recorder(streaming) as rec16:
            first_n, first_s = timed(run)  # first call: the chunk shapes' cuDNN selection
    finally:
        exemplar.colormnet_propagate = real_propagate
    cuts = np.nonzero(np.concatenate(flags))[0].tolist()

    zero_launches(pc, wa)
    torch.cuda.reset_peak_memory_stats()
    (n, sync_n, sync_sites), wall_s = timed(lambda: count_syncs(run))
    by_kernel = read_launches(pc, wa)
    launches = by_kernel["window_attn"]
    peak = torch.cuda.max_memory_allocated()
    transfer = streaming.last_transfer()

    with Recorder(streaming) as rec48:
        n48, wall48_s = timed(lambda: run(chunk_size=RESTORE_T))
    uv16, uv48 = rec16.joined("packed"), rec48.joined("packed")

    enable_profiling(True)
    reset_stages()
    _, profiled_s = timed(run)
    enable_profiling(False)
    stages = {k: v[0] for k, v in stage_times().items()}
    diff = np.abs(uv16 - uv48)
    emit(dict(phase="restore_streaming", card=card, clip=[RESTORE_T, h, w], scene_cuts=cuts,
              first_call_s=first_s, frames=n, wall_s=wall_s, fps=n / wall_s, transfer=transfer,
              host_syncs=sync_n, sync_sites=sync_sites, chunks=-(-RESTORE_T // 16),
              max_memory_allocated=peak, window_attn_calls=launches,
              window_attn_launches=2 * launches, chunk48_s=wall48_s,
              chunk16_vs_48_max_code_diff=int(diff.max()),
              chunk16_vs_48_unequal_share=float(np.mean(diff > 0)),
              stage_timed_wall_s=profiled_s, stages_s=stages,
              out_uv_shape=list(uv16.shape), **chroma_stats(uv16)))
    if first_n != RESTORE_T or n != RESTORE_T or n48 != RESTORE_T:
        fail(f"restore_streaming: frames written {first_n}, {n}, {n48} != {RESTORE_T}")
    if cuts != RESTORE_CUTS:
        fail(f"restore_streaming: scene cuts {cuts} != {RESTORE_CUTS}")
    if transfer != "gray+uv420" or tuple(uv16.shape) != (RESTORE_T, h // 2, w):
        fail(f"restore_streaming: transfer {transfer}, retired shape {uv16.shape}")
    if launches < RESTORE_T:
        fail(f"restore_streaming: window attention ran {launches} times, expected {RESTORE_T}")
    if diff.max() > 1:
        fail(f"restore_streaming: chunk 16 and chunk 48 differ by {diff.max()} codes")
    if chroma_stats(uv16)["mean_abs_uv_minus_128"] <= 1.0:
        fail("restore_streaming: no chroma came through from the reference")
    return run, wall_s, by_kernel


def phase_restore_streaming_engines(pc, wa, card: str, tmp: str) -> dict:
    """``HAVC_restore_video_streaming`` with Deep-Exemplar (``ex_model=1``,
    at the Medium work size) and DeepRemaster (``ex_model=2``, at 320x576,
    a reference every 10 frames, the look-ahead cursor over the reference
    video) on the restore phase's 48-frame 1080p pair: fps of a second
    call, its host syncs, peak memory, the host syncs inside each
    propagation, chunk 16 against chunk 48 within 1 code, stage times."""
    from havc_tpu_torch import exemplar, streaming
    from havc_tpu_torch.utils import enable_profiling, reset_stages, stage_times

    src, ref = f"{tmp}/restore_gray.y4m", f"{tmp}/restore_ref.y4m"
    h, w = MAIN_SHAPE[1:]
    total = dict(post_chain=0, window_attn=0)
    for ex_model, prop in ((1, "deepex_propagate"), (2, "remaster_propagate")):
        name = f"restore_streaming/ex_model{ex_model}"

        def run(chunk_size=16, ex_model=ex_model):
            return streaming.HAVC_restore_video_streaming(
                src, ref, f"{tmp}/unused.mp4", ex_model=ex_model, chunk_size=chunk_size,
                sink="null")

        with Recorder(streaming) as rec16:
            first_n, first_s = timed(run)
        zero_launches(pc, wa)
        torch.cuda.reset_peak_memory_stats()
        (n, sync_n, sync_sites), wall_s = timed(lambda: count_syncs(run))
        launches = read_launches(pc, wa)
        peak = torch.cuda.max_memory_allocated()
        with Recorder(streaming) as rec48, LoopSyncs(exemplar, (prop,)) as loop:
            n48, wall48_s = timed(lambda: run(chunk_size=RESTORE_T))
        enable_profiling(True)
        reset_stages()
        _, stage_timed_s = timed(run)
        enable_profiling(False)
        stages = {k: v[0] for k, v in stage_times().items()}
        uv16, uv48 = rec16.joined("packed"), rec48.joined("packed")
        diff = np.abs(uv16 - uv48)
        for k in total:
            total[k] += launches[k]
        emit(dict(phase=name, card=card, clip=[RESTORE_T, h, w], first_call_s=first_s,
                  frames=n, wall_s=wall_s, fps=n / wall_s, transfer=streaming.last_transfer(),
                  host_syncs=sync_n, sync_sites=sync_sites, max_memory_allocated=peak,
                  launches=launches, chunk48_s=wall48_s, propagate=loop.by_name,
                  chunk16_vs_48_max_code_diff=int(diff.max()),
                  chunk16_vs_48_unequal_share=float(np.mean(diff > 0)),
                  stage_timed_wall_s=stage_timed_s, stages_s=stages,
                  out_uv_shape=list(uv16.shape), **chroma_stats(uv16)))
        if (first_n, n, n48) != (RESTORE_T,) * 3:
            fail(f"{name}: frames written {first_n}, {n}, {n48} != {RESTORE_T}")
        if tuple(uv16.shape) != (RESTORE_T, h // 2, w) or diff.max() > 1:
            fail(f"{name}: retired {uv16.shape}; chunk 16 and 48 differ by {diff.max()} codes")
        if loop.by_name[prop]["calls"] < 1 or loop.syncs:
            fail(f"{name}: {prop} ran {loop.by_name[prop]['calls']} times with "
                 f"{loop.syncs} host syncs inside")
        # seeded NetworkC's sigmoid sits near 0.5: its ab stays within a few
        # units of neutral, so DeepRemaster's least chroma is lower
        if chroma_stats(uv16)["mean_abs_uv_minus_128"] <= (1.0 if ex_model == 1 else 0.25):
            fail(f"{name}: no chroma came through from the reference")
    return total


# --- phases 28-30: the scene-batched scan, the mesh paths, checkpoint conversion ---------

SCENE_T, SCENE_PER = 48, 8  # the scene path's clip: six scenes of 8 frames
SCENE_S = SCENE_T // SCENE_PER
SCENE_TOL = dict(max_abs=1e-3, moved_share=0.01)  # batched against sequential, per value
MESH2_TOL = dict(max_abs=1e-3, moved_share=0.01)  # two shards against one device


def moved(a: torch.Tensor, b: torch.Tensor, over: float = 1e-4) -> dict:
    d = (a.float() - b.float()).abs()
    return dict(max_abs=d.max().item(), moved_share=(d > over).float().mean().item())


class Captured:
    """While active: the ab that ``colormnet_propagate`` and
    ``colormnet_propagate_scenes`` return, in call order."""

    def __init__(self, exemplar):
        self.ex, self.ab = exemplar, []

    def __enter__(self):
        self.real = {n: getattr(self.ex, n)
                     for n in ("colormnet_propagate", "colormnet_propagate_scenes")}
        for name, real in self.real.items():
            def spy(*a, _real=real, **kw):
                out = _real(*a, **kw)
                self.ab.append(out)
                return out

            setattr(self.ex, name, spy)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.ex, name, real)


def phase_scene_parallel_path(ht, pc, wa, card: str) -> dict:
    """``HAVC_deepex(clip, clip_ref, render_vivid=True, scene_parallel=True,
    engine_config="full")`` on a seeded 48-frame 1080p clip of six scenes
    (references from the classic colorizer with scene detection), then the
    same call with ``scene_parallel=False``: wall time, fps, peak memory,
    window-attention calls (at B = 6 against B = 1), the host syncs inside
    both scans, and the propagated ab of the two against each other.  One
    more scene-parallel call runs under ``utils.device_trace`` (into
    ``$HAVC_TRACE_DIR`` when set, else a temporary directory)."""
    from havc_tpu_torch import exemplar
    from havc_tpu_torch.utils import device_trace

    gray = torch.from_numpy(np.repeat(np.stack(list(smooth_frames(SCENE_T, SCENE_PER, 9)))[
        ..., None], 3, axis=-1)).cuda()
    clip = ht.Clip(frames=gray)
    t0 = time.perf_counter()
    ref = ht.HAVC_colorizer(clip, sc_threshold=0.10)
    torch.cuda.synchronize()
    refs_s = time.perf_counter() - t0
    cuts = np.nonzero(ref.sc.sc_prev)[0].tolist()
    want_cuts = list(range(0, SCENE_T, SCENE_PER))
    if cuts != want_cuts:
        fail(f"scene_parallel_path: reference cuts {cuts} != {want_cuts}")
    rows, by_path, outs = {}, {}, {}
    for name, par in (("scene_parallel", True), ("sequential", False)):
        def run(par=par):
            return ht.HAVC_deepex(clip, ref, render_vivid=True, scene_parallel=par,
                                  engine_config="full")

        _, first_s = timed(run)
        torch.cuda.reset_peak_memory_stats()
        zero_launches(pc, wa)
        with LoopSyncs(exemplar, ("colormnet_propagate", "colormnet_propagate_scenes")) as loop, \
                Captured(exemplar) as cap:
            out, wall_s = timed(run)
        launches = read_launches(pc, wa)
        by_path[name] = launches
        outs[name] = (out.frames, cap.ab[0])
        rows[name] = dict(first_call_s=first_s, wall_s=wall_s, fps=SCENE_T / wall_s,
                          max_memory_allocated=torch.cuda.max_memory_allocated(),
                          window_attn_calls=launches["window_attn"],
                          window_attn_launches=2 * launches["window_attn"],
                          scan_host_syncs=loop.by_name, scan_sync_sites=loop.sites[:6],
                          ab_shape=list(cap.ab[0].shape))
        if loop.syncs:
            fail(f"scene_parallel_path {name}: the scan waited for the card {loop.syncs} times")
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = os.path.join(os.environ.get("HAVC_TRACE_DIR", tmp), "scene_parallel_trace")
        with device_trace(trace_dir):
            ht.HAVC_deepex(clip, ref, render_vivid=True, scene_parallel=True,
                           engine_config="full")
        traces = sorted(os.path.join(trace_dir, f) for f in os.listdir(trace_dir))
        trace_bytes = sum(os.path.getsize(t) for t in traces)
        with open(traces[0]) as fh:
            trace_events = len(json.load(fh).get("traceEvents", []))
    ab = moved(outs["scene_parallel"][1], outs["sequential"][1])
    rgb = moved(outs["scene_parallel"][0], outs["sequential"][0])
    f = outs["scene_parallel"][0]
    finite = bool(torch.isfinite(f).all().item())
    emit(dict(phase="scene_parallel_path", card=card, clip=[SCENE_T, *MAIN_SHAPE[1:], 3],
              scenes=SCENE_S, reference_cuts=cuts, references_s=refs_s, runs=rows,
              ab_scene_vs_sequential=ab, rgb_scene_vs_sequential=rgb, tol=SCENE_TOL,
              trace_files=[os.path.basename(t) for t in traces], trace_bytes=trace_bytes,
              trace_events=trace_events,
              finite=finite, mean_abs_chroma=(f - f.mean(-1, keepdim=True)).abs().mean().item()))
    if rows["scene_parallel"]["window_attn_calls"] != SCENE_PER - 1:
        fail(f"scene_parallel_path: window attention ran "
             f"{rows['scene_parallel']['window_attn_calls']} times at B = {SCENE_S}, expected "
             f"{SCENE_PER - 1}")
    if rows["sequential"]["window_attn_calls"] != SCENE_T - SCENE_S:
        fail(f"scene_parallel_path: the sequential scan ran window attention "
             f"{rows['sequential']['window_attn_calls']} times, expected {SCENE_T - SCENE_S}")
    if not finite or ab["max_abs"] > SCENE_TOL["max_abs"] or \
            ab["moved_share"] > SCENE_TOL["moved_share"]:
        fail(f"scene_parallel_path: scene-batched against sequential ab {ab} (tol {SCENE_TOL}), "
             f"finite={finite}")
    if not trace_events:
        fail("scene_parallel_path: device_trace wrote no events")
    return {f"scene_parallel_path/{k}": v for k, v in by_path.items()}


def box_blur5(x: torch.Tensor) -> torch.Tensor:
    """5x5 box blur of (T, H, W, C) with edge padding, as 25 shifted sums
    (the same arithmetic at every size)."""
    h, w = x.shape[1], x.shape[2]
    xp = torch.cat([x[:, :1].expand(-1, 2, -1, -1), x, x[:, -1:].expand(-1, 2, -1, -1)], 1)
    xp = torch.cat([xp[:, :, :1].expand(-1, -1, 2, -1), xp,
                    xp[:, :, -1:].expand(-1, -1, 2, -1)], 2)
    acc = torch.zeros_like(x)
    for i in range(5):
        for j in range(5):
            acc += xp[:, i:i + h, j:j + w]
    return acc / 25.0


def classic_unsharded(frames, do_model, dd_model):
    """``sharded_classic_pipeline``'s stages called directly on one device."""
    from havc_tpu_torch.filters import chroma_resize_restore
    from havc_tpu_torch.models import ddcolor as dd
    from havc_tpu_torch.models import deoldify as do
    from havc_tpu_torch.ops import merge as merge_ops
    from havc_tpu_torch.ops.colorspace import luma
    from havc_tpu_torch.ops.post_chain import post_chain
    from havc_tpu_torch.ops.resize import resize
    from havc_tpu_torch.parallel.mesh import POST_KW

    with torch.inference_mode():
        w = torch.clamp(resize(frames, 384, 384, "spline64"), 0.0, 1.0)
        merged = merge_ops.combine_models(do.colorize(do_model, w, 24),
                                          dd.colorize(dd_model, w, 384), method=3,
                                          b_weight=0.5)
        out = chroma_resize_restore(frames, post_chain(merged, **POST_KW))
        return out, luma(out).mean()


def phase_mesh_paths(ht, pc, wa, card: str) -> dict:
    """The mesh paths on the card: ``make_mesh(1)`` (cuda:0) and a ``Mesh``
    of two shards that are both cuda:0 (``data`` 2; rows split over
    ``model`` 2 for the halo call).  Under both: ``colormnet_propagate_scenes``
    (the full ColorMNet, six scenes of 8 frames at the Medium work size),
    ``deepex_propagate`` (24 frames at 216x384, three scenes),
    ``remaster_propagate`` (24 frames at 320x576, 20 references),
    ``spatial_halo_call`` (a 5x5 box blur, halo 2, on 8x1080x1920) and
    ``sharded_classic_pipeline`` at its production geometry (resnet101
    DeOldify, large DDColor, render factor 24, 384, 8 frames of 1080p),
    each against its unsharded run: the mesh of one exactly, two shards
    within ``MESH2_TOL`` (Deep-Exemplar's argmax by the share moved)."""
    from havc_tpu_torch import exemplar
    from havc_tpu_torch.models import ddcolor as dd
    from havc_tpu_torch.models import deoldify as do
    from havc_tpu_torch.ops.colorspace import rgb_to_lab
    from havc_tpu_torch.parallel import Mesh, make_mesh, sharded_classic_pipeline, \
        spatial_halo_call

    cuda0 = torch.device("cuda", 0)
    mesh1 = make_mesh(1)
    mesh2 = Mesh(np.array([[cuda0], [cuda0]], dtype=object))
    rows, by_path, bad = {}, {}, []

    def check(name, one, shards, exact, tol=MESH2_TOL):
        r = dict(mesh1_equal=bool(torch.equal(one[0], one[1])), mesh2=moved(shards, one[1]))
        rows[name] = r
        if exact and not r["mesh1_equal"]:
            bad.append(f"{name}: the mesh of one differs from the unsharded run")
        if r["mesh2"]["max_abs"] > tol["max_abs"] or r["mesh2"]["moved_share"] > \
                tol["moved_share"]:
            bad.append(f"{name}: two shards {r['mesh2']} (tol {tol})")

    # ColorMNet's scene scan at the Medium work size
    wh, ww = exemplar.smart_resize_shape(1920, 1080, "medium")
    eng = exemplar._get_engine(config="full", work_size=exemplar.pad112_geometry(wh, ww)[:2],
                               device="cuda")
    gray = torch.from_numpy(np.stack(list(smooth_frames(SCENE_T, SCENE_PER, 10, wh, ww)))).cuda()
    frames = gray[..., None].expand(-1, -1, -1, 3).contiguous()
    colored = tinted(frames, SCENE_PER)
    ref_ab = torch.clamp(rgb_to_lab(colored)[..., 1:3] / 110.0, -1.0, 1.0)
    is_ref = np.zeros(SCENE_T, bool)
    is_ref[::SCENE_PER] = True
    cm = [exemplar.colormnet_propagate_scenes(eng, frames, ref_ab, is_ref, ref_frames=colored,
                                              mesh=m) for m in (None, mesh1, mesh2)]
    check("colormnet_propagate_scenes", cm[:2], cm[2], True)
    # Deep-Exemplar's frame batches (no WLS smoother: it runs after the gather)
    dx_eng = exemplar.DeepExEngine("medium", "cuda")
    dxf = torch.nn.functional.interpolate(frames[:24].permute(0, 3, 1, 2), size=(
        dx_eng.h, dx_eng.w), mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    dxr = tinted(dxf.contiguous(), 8)
    dx_ref = np.zeros(24, bool)
    dx_ref[::8] = True
    dx = [exemplar.deepex_propagate(dx_eng, dxf, dxr, dx_ref, wls_filter=False, mesh=m)
          for m in (None, mesh1, mesh2)]
    check("deepex_propagate", dx[:2], dx[2], True, dict(max_abs=1.0, moved_share=0.02))
    # DeepRemaster's window groups
    rh, rw = exemplar.remaster_work_shape(1920, 1080)
    rmf = torch.from_numpy(np.stack(list(smooth_frames(24, 8, 11, rh, rw)))).cuda()
    rmf = rmf[..., None].expand(-1, -1, -1, 3).contiguous()
    rm_refs = tinted(torch.cat([rmf] * 2)[:20].contiguous(), 4)
    rm_eng = exemplar.RemasterEngine(device="cuda")
    rm = [exemplar.remaster_propagate(rm_eng, rmf, rm_refs, ref_positions=np.arange(20),
                                      mesh=m) for m in (None, mesh1, mesh2)]
    check("remaster_propagate", rm[:2], rm[2], True)
    # a row-sharded stencil: the halo exchange
    x = torch.rand((8, *MAIN_SHAPE[1:], 3), generator=torch.Generator(device="cuda").manual_seed(
        12), device="cuda")
    whole = box_blur5(x)
    rows_mesh = Mesh(np.array([[cuda0, cuda0]], dtype=object))
    halo = [spatial_halo_call(m, box_blur5, 2)(x) for m in (mesh1, rows_mesh)]
    check("spatial_halo_call", (whole, halo[0]), halo[1], True, dict(max_abs=0.0,
                                                                     moved_share=0.0))
    del x, whole, halo
    # the classic pipeline at its production geometry
    kw = dict(do_encoder="resnet101", dd_config="large", rf=24, input_size=384)
    clip8 = torch.from_numpy(scene_clip_1080p()[:8]).cuda()
    step1, (do_p, dd_p) = sharded_classic_pipeline(mesh1, **kw)
    step2, _ = sharded_classic_pipeline(mesh2, **kw)
    with torch.device("meta"):
        do_m, dd_m = do.DeOldifyWide(encoder="resnet101", nf_factor=1), dd.DDColor.from_config(
            "large")
    do_m = do_m.to_empty(device=cuda0).eval()
    dd_m = dd_m.to_empty(device=cuda0).eval()
    do_m.load_state_dict(do_p)
    dd_m.load_state_dict(dd_p)
    ref_out, ref_l = classic_unsharded(clip8, do_m, dd_m)
    del do_m, dd_m
    steps = {}
    for name, step in (("mesh1", step1), ("mesh2", step2)):
        step(do_p, dd_p, clip8)
        zero_launches(pc, wa)
        (out, lum), wall_s = timed(lambda: step(do_p, dd_p, clip8))
        by_path[f"mesh_paths/classic_{name}"] = read_launches(pc, wa)
        steps[name] = (out, lum, wall_s)
    check("sharded_classic_pipeline", (ref_out, steps["mesh1"][0]), steps["mesh2"][0], True)
    rows["sharded_classic_pipeline"].update(
        wall_s={k: v[2] for k, v in steps.items()},
        fps={k: 8 / v[2] for k, v in steps.items()},
        mean_luma={k: v[1].item() for k, v in steps.items()}, mean_luma_unsharded=ref_l.item(),
        post_chain_launches={k: by_path[f"mesh_paths/classic_{k}"]["post_chain"]
                             for k in steps})
    emit(dict(phase="mesh_paths", card=card, meshes={"mesh1": repr(mesh1), "mesh2": repr(mesh2),
                                                     "rows": repr(rows_mesh)},
              tol=MESH2_TOL, results=rows))
    launches = rows["sharded_classic_pipeline"]["post_chain_launches"]
    if launches != {"mesh1": 1, "mesh2": 2}:
        bad.append(f"sharded_classic_pipeline: post-chain launches {launches}, expected one a "
                   f"shard")
    if bad:
        fail("mesh_paths: " + "; ".join(bad))
    return by_path


def reference_deoldify_video(model, seed: int = 13) -> dict:
    """A DeOldify Video checkpoint in the reference's layout (fastai's
    ``model`` wrapper, the key map's full key set), its tensors seeded at
    the shapes of the port's resnet101 model: every conv outside the ResNet
    body spectral-normed (``weight_orig``, ``weight_u``, ``weight_v``), the
    final pixel shuffle weight-normed (``weight_g``, ``weight_v``)."""
    from havc_tpu_torch.models import convert
    from havc_tpu_torch.models.bridge import torch_key

    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for prefix, (path, kind) in convert.deoldify_wide_key_map().items():
        for suffix, (leaf, _) in convert._KIND_RULES[kind].items():
            if torch_key(path + (leaf,)) not in shapes:  # a conv without bias
                continue
            shape = shapes[torch_key(path + (leaf,))]
            if kind == "conv1d_2d" and leaf == "kernel":
                shape = shape[:-1]  # torch Conv1d (O, I, 1)
            t = torch.randn(shape, generator=gen)
            if len(shape) > 1:  # fan-in scale, so that the unnormed ResNet body stays finite
                t /= float(np.prod(shape[1:])) ** 0.5
            elif suffix in ("weight", "running_var"):  # scales and variances near 1
                t = 1.0 + 0.1 * t.abs()
            else:
                t *= 0.05
            sd[f"{prefix}.{suffix}"] = t
        if kind in ("conv", "conv1d_2d") and not prefix.startswith("layers.0."):
            w = sd.pop(f"{prefix}.weight")
            if prefix == "layers.8.conv.0":
                sd[f"{prefix}.weight_v"] = w
                sd[f"{prefix}.weight_g"] = torch.rand((w.shape[0],) + (1,) * (w.dim() - 1),
                                                      generator=gen) + 0.5
            else:
                v = torch.nn.functional.normalize(torch.rand(w[0].numel(), generator=gen), dim=0)
                sd[f"{prefix}.weight_orig"] = w
                sd[f"{prefix}.weight_u"] = torch.nn.functional.normalize(w.reshape(w.shape[0], -1)
                                                                         @ v, dim=0)
                sd[f"{prefix}.weight_v"] = v
    return {"model": sd}


def phase_convert_roundtrip(ht, card: str, tmp: str) -> None:
    """A synthesized DeOldify Video checkpoint (``reference_deoldify_video``)
    converted by ``python -m havc_tpu_torch.models.convert``, loaded through
    ``engines.set_weights_dir`` on the card, and one 8-frame 384x384 batch
    colorized with it: the conversion time, the converted tensors, the
    colorize time and the output's checksum."""
    from havc_tpu_torch import engines
    from havc_tpu_torch.models import deoldify as do

    with torch.device("meta"):
        skeleton = do.make_model("video")
    src, out = os.path.join(tmp, "ckpt"), os.path.join(tmp, "weights")
    os.makedirs(src)
    torch.save(reference_deoldify_video(skeleton), os.path.join(src, "ColorizeVideo_gen.pth"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "havc_tpu_torch.models.convert", src, out],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    convert_s = time.perf_counter() - t0
    if res.returncode != 0 or "deoldify_video.npz: converted" not in res.stdout:
        fail(f"convert_roundtrip: the converter failed ({res.returncode}): "
             f"{res.stdout[-500:]} {res.stderr[-2000:]}")
    with np.load(os.path.join(out, "deoldify_video.npz")) as f:
        n_tensors = len(f.files)
        head = torch.from_numpy(f["params/head_conv/Conv_0/kernel"]).permute(3, 2, 0, 1)
    engines.set_weights_dir(out)
    engines.registry.random_init_used = False  # the earlier phases' seeded engines set it
    try:
        model = engines.registry.deoldify("video", "cuda")
        random_init = engines.registry.random_init_used
        loaded = bool(torch.equal(model.head_conv.weight.cpu(), head))
        x = torch.rand((8, 384, 384, 3), generator=torch.Generator(device="cuda").manual_seed(14),
                       device="cuda")
        with torch.inference_mode():
            do.colorize(model, x, 24)
            y, colorize_s = timed(lambda: do.colorize(model, x, 24))
        checksum = y.double().sum().item()
        finite = bool(torch.isfinite(y).all().item())
    finally:
        engines.set_weights_dir(None)
    emit(dict(phase="convert_roundtrip", card=card, checkpoint="ColorizeVideo_gen.pth",
              checkpoint_bytes=os.path.getsize(os.path.join(src, "ColorizeVideo_gen.pth")),
              convert_s=convert_s, converted_tensors=n_tensors, colorize_s=colorize_s,
              batch=list(x.shape), out_checksum=checksum, finite=finite,
              loaded_random_init=random_init, head_conv_equals_npz=loaded))
    if random_init or not loaded or not finite:
        fail(f"convert_roundtrip: random init {random_init}, head conv from the npz {loaded}, "
             f"finite {finite}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    import havc_tpu_torch as ht
    from havc_tpu_torch import kernels
    from havc_tpu_torch.ops import post_chain as pc
    from havc_tpu_torch.ops import window_attn as wa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_name_and_limit()
    emit(dict(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), host_cpus=os.cpu_count(),
              torch_cpu_threads=torch.get_num_threads(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32))

    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    sass = {name: {short_name(f): n for f, n in kernels.sass_counts(kernels._target(name)).items()}
            for name in kernels.SOURCES}
    emit(dict(phase="build", seconds=build_s,
              ptxas={k: ptxas_report(v) for k, v in kernels.build_logs.items()},
              sass_instructions=sass))
    # the post chain's function holds the pixel program five times: four
    # interleaved in the vector loop, one for the scalar head and tail
    sass_per_pixel = sass["post_chain"]["post_chain_kernel"] / 5

    summary = [phase_kernels(pc, smi, sass_per_pixel,
                             torch.cuda.get_device_properties(0).multi_processor_count,
                             smi_max_sm_clock_hz()),
               phase_window_attn(wa, smi)]
    by_path = {}  # path -> {kernel: launches in that path's measured run}
    # before any model is on the card, so its peak is the filter's own
    phase_bw_tune_memory(ht, smi)
    by_path["main_path"], frames, wall_s, main_out = phase_main_path(ht, pc, wa, smi)
    with tempfile.TemporaryDirectory() as tmp:
        phase_restore_format(ht, main_out.frames, main_out.fps, smi, tmp)
    del main_out
    phase_profile("main_path", lambda: ht.HAVC_main(ht.Clip(frames=frames)), wall_s, smi,
                  "post_chain", FILTER_KERNELS)
    del frames
    for name, kw, want in (("placebo_path", PLACEBO_KW, 1), ("veryslow_path", VERYSLOW_KW, 2)):
        by_path[name], run_classic, cl_wall_s = phase_classic_path(ht, pc, wa, smi, name, kw, want)
        phase_profile(name, run_classic, cl_wall_s, smi, "post_chain", FILTER_KERNELS)
        del run_classic
    by_path["exemplar_path"], run_exemplar, ex_wall_s = phase_exemplar_path(ht, pc, wa, smi)
    phase_profile("exemplar_path", run_exemplar, ex_wall_s, smi, "window_attn")
    del run_exemplar
    phase_exemplar_memory(smi)
    by_path["recolor_path"], run_recolor, rc_wall_s = phase_recolor_path(ht, pc, wa, smi)
    phase_profile("recolor_path", run_recolor, rc_wall_s, smi, "window_attn")
    del run_recolor
    by_path["colortemp_path"], run_ct, ct_wall_s = phase_colortemp_path(ht, pc, wa, smi)
    phase_profile("colortemp_path", run_ct, ct_wall_s, smi, "window_attn")
    del run_ct
    by_path["frameinterp_path"], _, _ = phase_frameinterp_path(ht, pc, wa, smi)
    by_path.update(phase_engine_paths(ht, pc, wa, smi))
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(phase_scene_detectors(ht, pc, wa, smi, tmp))
    by_path.update(phase_overlay_degrain(ht, pc, wa, smi))
    by_path.update(phase_legacy_paths(ht, pc, wa, smi))
    by_path.update(phase_scene_parallel_path(ht, pc, wa, smi))
    by_path.update(phase_mesh_paths(ht, pc, wa, smi))
    with tempfile.TemporaryDirectory() as tmp:
        phase_convert_roundtrip(ht, smi, tmp)
    phase_parity(ht)
    phase_engine_parity(ht)
    phase_leftover_parity(ht)
    has_cv2 = importlib.util.find_spec("cv2") is not None
    with tempfile.TemporaryDirectory() as tmp:
        if not has_cv2:
            fail("exemplar_sources: OpenCV is needed to write the reference video")
        by_path["exemplar_sources"] = phase_exemplar_sources(ht, pc, wa, smi, tmp)
        run_stream, st_wall_s, by_path["streaming"] = phase_streaming(ht, pc, wa, smi, tmp,
                                                                      has_cv2)
        phase_profile("streaming", run_stream, st_wall_s, smi, "post_chain")
        del run_stream
        _, _, by_path["streaming_tuned"] = phase_streaming_tuned(
            ht, pc, wa, smi, f"{tmp}/stream_gray.y4m", tmp)
        phase_streaming_parity(tmp)
        run_restore, rs_wall_s, by_path["restore_streaming"] = phase_restore_streaming(
            pc, wa, smi, tmp)
        phase_profile("restore_streaming", run_restore, rs_wall_s, smi, "window_attn")
        del run_restore
        by_path["restore_streaming_engines"] = phase_restore_streaming_engines(pc, wa, smi, tmp)

    # `launches`: each kernel's slice's own path (the post chain: HAVC_main
    # with its defaults; window attention: the exemplar path), in calls
    summary[0]["launches"] = by_path["main_path"]["post_chain"]
    summary[1]["launches"] = by_path["exemplar_path"]["window_attn"]
    for row in summary:
        row["launches_by_path"] = {p: k[row["name"]] for p, k in by_path.items()}
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
