"""Device: the share of the profiled part's wall time in which no kernel
ran (100 - the union of the kernel intervals over the wall time), in %."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return 100.0 - 100.0 * ctx.trace.busy_s() / ctx.trace.wall_s
