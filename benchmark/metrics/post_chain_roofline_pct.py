"""Kernels layer (``csrc/post_chain.cu``): the least time of one launch
at the timed shape, (frames, work, work, 3) float32 read and written once
at the card's bandwidth, over the profiled mean time of
``post_chain_kernel``, in %."""

from harness import flops


def read(ctx):
    mean = ctx.trace.kernel_mean_s("post_chain_kernel")
    if mean is None:
        return None
    ws = ctx.config["work_size"]
    return 100.0 * flops.roofline_s(flops.post_chain_bytes(ctx.mix["frames"], ws, ws)) / mean
