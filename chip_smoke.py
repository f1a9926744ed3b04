"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``havc_tpu_torch/csrc`` (one ``nvcc``
per source, started together), then runs these phases, each printing one
JSON line; any failure exits non-zero:

1. ``device``: the card's name and power limit, torch/CUDA versions; TF32
   is switched off for matmuls and cuDNN (the JAX package computes in f32).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   at the main path's shape and at two more, with CUDA-event timings
   (median of 10 batches of 20 calls) beside the card's bound.
3. ``main_path``: ``havc_tpu_torch.HAVC_main(clip)`` with its defaults on a
   seeded 24-frame 1080x1920 gray clip held as CUDA tensors, with
   full-width DeOldify Video and DDColor Artistic (seeded random weights
   made on the card).  Kernel launch counts are zeroed just before the
   measured run and read just after it.
4. ``profile``: one more main-path run under ``torch.profiler``: device
   kernel time, its share of the measured wall time, the top kernels.
5. ``parity_cpu_gpu``: the test-sized main path (tiny models, render
   factor 4) with ``device="cpu"`` and on CUDA; max abs <= 1e-4.

Then the ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` name and
power-limit line, and last the result line.  Without CUDA, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
H100_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_TOL = 1e-5
PARITY_TOL = 1e-4
MAIN_SHAPE = (24, 1080, 1920)
WORK_SHAPE = (24, 384, 384, 3)  # the stabilizer's work clip at 1080p


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


def phase_kernels(pc, card: str) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [("main_path", WORK_SHAPE, KW_MAIN), ("colormap", WORK_SHAPE, KW_COLORMAP),
             ("odd_sizes", (1, 30, 50, 3), KW_COLORMAP)]
    rows, worst = [], 0.0
    main = None
    for name, shape, kw in cases:
        x = torch.rand(shape, generator=gen, device="cuda")
        got = pc.post_chain_cuda(x, **kw)
        want = pc.post_chain_reference(x, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        n_pix = x.numel() // 3
        n_bytes = 24 * n_pix  # 12 B read + 12 B written per pixel
        ops = POST_CHAIN_OPS[bool(kw.get("cmap_ranges"))] * n_pix
        bytes_ms, ops_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
        row = dict(case=name, shape=list(shape), max_abs_err=err,
                   kernel_ms=cuda_ms(lambda: pc.post_chain_cuda(x, **kw)),
                   plain_ms=cuda_ms(lambda: pc.post_chain_reference(x, **kw)),
                   bytes=n_bytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=None)
        rows.append(row)
        if name == "main_path":
            main = row
        if err > KERNEL_TOL:
            emit(dict(phase="kernels", name="post_chain", cases=rows))
            fail(f"post_chain {name}: max abs err {err} > {KERNEL_TOL}")
    emit(dict(phase="kernels", name="post_chain", card=card, tol=KERNEL_TOL, cases=rows,
              note="library_ms null: no single PyTorch call computes this function"))
    return dict(name="post_chain", route="cuda", source="havc_tpu_torch/csrc/post_chain.cu",
                replaces="havc_tpu/ops/pallas_kernels.py:208", launches=None,
                max_abs_err=worst, ms=main["kernel_ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None)


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


def phase_main_path(ht, pc, card: str):
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
    pc.post_chain_cuda.launches = 0
    t0 = time.perf_counter()
    out = run()
    wall_s = time.perf_counter() - t0
    launches = pc.post_chain_cuda.launches
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
    return launches, frames, wall_s


# --- phase 4: where the device time goes ---------------------------------------------


def phase_profile(ht, frames, wall_s, card: str) -> None:
    """One more main-path run under torch.profiler: the card's busy time
    (the union of its kernel intervals) against the run's wall time, the
    device time summed per kernel, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ht.HAVC_main(ht.Clip(frames=frames))
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    dev = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    if not dev:
        emit(dict(phase="profile", device_time="not measured",
                  note="torch.profiler recorded no CUDA kernels"))
        return
    dev.sort(key=lambda a: -a.self_device_time_total)
    device_s = sum(a.self_device_time_total for a in dev) * 1e-6
    busy_us, end_us = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                         if e.device_type == DeviceType.CUDA):
        busy_us += max(0.0, hi - max(lo, end_us))
        end_us = max(end_us, hi)
    emit(dict(phase="profile", card=card, device_kernel_s=device_s, busy_s=busy_us * 1e-6,
              profiled_wall_s=profiled_s, busy_share=busy_us * 1e-6 / profiled_s,
              unprofiled_wall_s=wall_s,
              kernels=len(dev), launches=sum(a.count for a in dev),
              top=[dict(name=a.key[:90], s=a.self_device_time_total * 1e-6, count=a.count)
                   for a in dev[:12]],
              post_chain_kernel_s=sum(a.self_device_time_total for a in dev
                                      if "post_chain_kernel" in a.key) * 1e-6))


# --- phase 5: CPU <-> GPU parity at test size ---------------------------------------


def tiny_engines(device_list):
    """DeOldifyWide("nano", nf_factor 1) and DDColor "micro" with seeded
    weights (BatchNorm statistics and gates moved off their init values),
    one copy per device."""
    from havc_tpu_torch.models import ddcolor as tdd
    from havc_tpu_torch.models import deoldify as tdo
    from havc_tpu_torch.models.layers import BatchNormInference, init_flax_defaults

    gen = torch.Generator().manual_seed(3)
    models = {}
    for key, m in ((("deoldify", "video"), tdo.DeOldifyWide("nano", nf_factor=1)),
                   (("ddcolor", "artistic"), tdd.DDColor.from_config("micro"))):
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


def phase_parity(ht) -> None:
    from havc_tpu_torch import engines

    cpu, gpu = torch.device("cpu"), torch.device("cuda", torch.cuda.current_device())
    saved = dict(engines.registry._cache)
    real_do, real_dd = engines.make_deoldify_fn, engines.make_ddcolor_fn
    engines.registry._cache.update(tiny_engines([cpu, gpu]))
    engines.make_deoldify_fn = lambda model=0, render_factor=24, **kw: real_do(model, 4, **kw)
    engines.make_ddcolor_fn = lambda model=1, render_factor=24, **kw: real_dd(model, 4, **kw)
    try:
        y = np.random.default_rng(7).random((6, 48, 64, 1), dtype=np.float32)
        frames = np.repeat(y, 3, axis=-1)
        out_cpu = ht.HAVC_main(ht.Clip(frames=frames.copy()), batch_size=4, device="cpu").frames
        out_gpu = ht.HAVC_main(ht.Clip(frames=frames.copy()), batch_size=4).frames
    finally:
        engines.registry._cache.clear()
        engines.registry._cache.update(saved)
        engines.make_deoldify_fn, engines.make_ddcolor_fn = real_do, real_dd
    err = float(np.abs(out_cpu - out_gpu).max())
    emit(dict(phase="parity_cpu_gpu", clip=list(frames.shape), max_abs_err=err,
              tol=PARITY_TOL, mean_abs_chroma=float(np.abs(out_gpu - out_gpu.mean(-1, keepdims=True)).mean())))
    if not err <= PARITY_TOL:
        fail(f"parity_cpu_gpu: max abs err {err} > {PARITY_TOL}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    import havc_tpu_torch as ht
    from havc_tpu_torch import kernels
    from havc_tpu_torch.ops import post_chain as pc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_name_and_limit()
    emit(dict(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32))

    t0 = time.perf_counter()
    kernels.build_all()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              ptxas={k: [ln for ln in v.splitlines() if "ptxas" in ln]
                     for k, v in kernels.build_logs.items()}))

    summary = [phase_kernels(pc, smi)]
    launches, frames, wall_s = phase_main_path(ht, pc, smi)
    summary[0]["launches"] = launches
    phase_profile(ht, frames, wall_s, smi)
    del frames
    phase_parity(ht)

    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
