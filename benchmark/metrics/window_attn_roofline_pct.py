"""Kernels layer (``csrc/window_attn_tc.cu``): the least time of one
launch at the path's shape (``window_attn_shape``: batch, the 1/16 grid,
key and value channels), the larger of its bytes at the card's bandwidth
and its tensor-core operations at the bf16 rate, over the profiled mean
time of ``window_attn_tc_kernel``, in %."""

from harness import flops


def read(ctx):
    mean = ctx.trace.kernel_mean_s("window_attn_tc_kernel")
    shape = ctx.config.get("window_attn_shape")
    if mean is None or shape is None:
        return None
    least = flops.roofline_s(flops.window_attn_bytes(*shape), flops.window_attn_ops(*shape),
                             flops.PEAK_FLOPS["bf16"])
    return 100.0 * least / mean
