"""The yardstick's arithmetic: the card's published peaks, and the bytes
and operations of the port's two hand-written kernels at a shape.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): HBM3 3.35 TB/s,
TF32 tensor cores 495 TFLOP/s, bf16 989 TFLOP/s, float32 outside the
tensor cores 67 TFLOP/s.  A kernel's roofline time is the larger of its
operations over the peak rate and its bytes over the bandwidth, each input
byte read once and each output byte written once.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "post_chain_bytes", "window_pairs",
           "window_attn_bytes", "window_attn_ops", "roofline_s"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"tf32": 495e12, "bf16": 989e12, "float32": 67e12}
WIN = 15  # window attention's window (max_dis 7)


def post_chain_bytes(frames: int, h: int, w: int) -> int:
    """The fused post chain over (frames, h, w, 3) float32: read once,
    written once."""
    return frames * h * w * 3 * 4 * 2


def window_pairs(h: int, w: int) -> int:
    """(pixel, offset) pairs of one frame whose offset lies in the frame:
    the kernel skips the others (their weight is exactly 0)."""
    m = WIN // 2
    along = lambda n: sum(min(i + m, n - 1) - max(i - m, 0) + 1 for i in range(n))  # noqa: E731
    return along(h) * along(w)


def window_attn_bytes(b: int, h: int, w: int, d_qk: int, d_vu: int, in_bytes: int = 2) -> int:
    """q, k, v and the relative-position logits read in their type, the
    float32 result written."""
    return b * h * w * (in_bytes * (2 * d_qk + WIN * WIN + d_vu) + 4 * d_vu)


def window_attn_ops(b: int, h: int, w: int, d_qk: int, d_vu: int) -> int:
    """The bf16 kernel's tensor-core operations: per in-frame pair one
    q.k product (2 d_qk) and the weighted sum with the weights in two bf16
    terms (4 d_vu)."""
    return b * window_pairs(h, w) * (2 * d_qk + 4 * d_vu)


def roofline_s(n_bytes: float, ops: float = 0.0, rate: float = PEAK_FLOPS["bf16"]) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / rate)
