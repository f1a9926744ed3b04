"""Local window attention: ColorMNet's short-term memory read.

For every query pixel, a softmax over the ``(2*max_dis+1)**2`` offsets of
its window of ``(q * scale) . k + rel`` (``scale = 1/sqrt(d_qk)``,
out-of-frame offsets set to -1e8), then the weighted sum of ``v``.
Channel-last: q, k ``(B, H, W, d_qk)``, v ``(B, H, W, d_vu)``,
rel ``(B, H, W, win*win)`` in offset order ``(dy + max_dis) * win + (dx +
max_dis)``; the result is ``(B, H, W, d_vu)`` float32.  The inputs are
all float32 or all bfloat16: bf16 values are computed with in float32, as
the JAX package's kernel computes them, and reach their own kernel on the
card without a cast.

Three functions, as for the post chain:

* ``window_attn_reference`` — the plain PyTorch version, a line-for-line
  copy of ``havc_tpu.ops.pallas_attn.local_window_attention_reference``
  (unfold + einsum);
* ``window_attn_cuda`` — the CUDA C++ kernels on CUDA tensors: float32
  inputs in two launches (``csrc/window_attn.cu``: weights, then the
  weighted sum), bf16 inputs in one launch on the tensor cores
  (``csrc/window_attn_tc.cu``); the counter ``window_attn_launches``
  (``utils.profiling.counters()``) counts its calls,
  ``window_attn_launches_bf16`` those on bf16 inputs;
* ``window_attn`` — the dispatcher: the plain version for CPU tensors, the
  kernel for CUDA tensors, no fallback.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import kernels
from ..utils.precision import ieee_precision
from ..utils.profiling import count

__all__ = ["window_attn", "window_attn_cuda", "window_attn_reference"]


@ieee_precision()
def window_attn_reference(q, k, v, rel, max_dis: int = 7) -> torch.Tensor:
    """Unfold-einsum version: the windows of k and v are materialised,
    in IEEE float32 whatever the inputs' type and the process's flags
    (the kernel is held against it)."""
    q, k, v, rel = (t.float() for t in (q, k, v, rel))
    win = 2 * max_dis + 1
    b, h, w, _ = q.shape

    def unfold(x):  # (N, H, W, C) -> (N, H, W, win*win, C), zero-padded
        n, c = x.shape[0], x.shape[-1]
        patches = F.unfold(x.permute(0, 3, 1, 2), (win, win), padding=max_dis)
        return patches.reshape(n, c, win * win, h, w).permute(0, 3, 4, 2, 1)

    scale = 1.0 / math.sqrt(q.shape[-1])
    qk = torch.einsum("bhwc,bhwnc->bhwn", q * scale, unfold(k))
    mask = unfold(torch.ones((1, h, w, 1), dtype=q.dtype, device=q.device))[..., 0]
    qk = qk + rel
    qk = torch.where(mask > 0.5, qk, -1e8)
    attn = torch.softmax(qk, dim=-1)
    return torch.einsum("bhwn,bhwnc->bhwc", attn, unfold(v))


def _check(q, k, v, rel, max_dis: int):
    """Raise on what the kernel does not take."""
    win = 2 * max_dis + 1
    for name, t in (("q", q), ("k", k), ("v", v), ("rel", rel)):
        if not t.is_cuda:
            raise ValueError(f"window_attn_cuda: {name} must be a CUDA tensor")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(f"window_attn_cuda: {name} must be float32 or bfloat16 like q, "
                             f"got {t.dtype}")
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"window_attn_cuda: {name} must be a contiguous 4-d tensor")
        if t.device != q.device:
            raise ValueError("window_attn_cuda: all inputs must be on one device")
    b, h, w, d_qk = q.shape
    if tuple(k.shape) != (b, h, w, d_qk) or tuple(v.shape[:3]) != (b, h, w) \
            or tuple(rel.shape) != (b, h, w, win * win):
        raise ValueError(
            f"window_attn_cuda: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} rel {tuple(rel.shape)} do not match (max_dis {max_dis})"
        )


def launch_stages(q, k, v, rel, wts, out, max_dis: int, stages: int) -> None:
    """Launch the float32 kernels: the weights kernel (``stages & 1``,
    writes the scratch ``wts``) and the weighted sum (``stages & 2``, reads
    ``wts``, writes ``out``).  ``window_attn_cuda`` launches both; one half
    alone is for timing it."""
    b, h, w, d_qk = q.shape
    lib = kernels.load("window_attn")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.window_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), wts.data_ptr(),
            out.data_ptr(), b, h, w, d_qk, v.shape[-1], max_dis, 1.0 / math.sqrt(d_qk),
            stages, stream,
        )
    if rc != 0:
        raise RuntimeError(f"window_attn_cuda: launch failed with CUDA error {rc} "
                           f"(a window or d_qk too large for shared memory gives 1)")


def _launch_tc(q, k, v, rel, out, max_dis: int) -> None:
    """Launch the bf16 kernel: one launch, no scratch."""
    b, h, w, d_qk = q.shape
    lib = kernels.load("window_attn_tc")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.window_attn_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(), b, h, w,
            d_qk, v.shape[-1], max_dis, 1.0 / math.sqrt(d_qk), stream,
        )
    if rc != 0:
        raise RuntimeError(f"window_attn_cuda: bf16 launch failed with CUDA error {rc} "
                           f"(a window or d_qk too large for shared memory gives 1)")


def scratch(q, max_dis: int) -> torch.Tensor:
    """The float32 kernels' weights scratch of one call: a padded weight
    block per tile of output pixels (451,584 B at the path shape)."""
    b, h, w, _ = q.shape
    n = kernels.load("window_attn").window_attn_scratch_floats(b, h, w, max_dis)
    return torch.empty(n, dtype=torch.float32, device=q.device)


def window_attn_cuda(q, k, v, rel, max_dis: int = 7) -> torch.Tensor:
    """Launch the CUDA kernels; every input a contiguous CUDA tensor on
    one device, all float32 (two launches) or all bfloat16 (one launch).
    Each call is counted once in ``window_attn_launches`` and, on bf16
    inputs, in ``window_attn_launches_bf16`` too."""
    _check(q, k, v, rel, max_dis)
    b, h, w, _ = q.shape
    out = torch.empty((b, h, w, v.shape[-1]), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        _launch_tc(q, k, v, rel, out, max_dis)
        count("window_attn_launches_bf16")
    else:
        launch_stages(q, k, v, rel, scratch(q, max_dis), out, max_dis, 3)
    count("window_attn_launches")
    return out


def window_attn(q, k, v, rel, max_dis: int = 7) -> torch.Tensor:
    """The plain version for CPU tensors, the CUDA kernel for CUDA
    tensors."""
    if q.device.type == "cpu":
        return window_attn_reference(q, k, v, rel, max_dis)
    if q.is_cuda:
        return window_attn_cuda(q, k, v, rel, max_dis)
    raise ValueError(f"window_attn: no implementation for device {q.device}")
