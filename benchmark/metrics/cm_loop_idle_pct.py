"""ColorMNet layer (``exemplar.colormnet_propagate``): the share of the
profiled part's wall time in which no kernel ran while the host was
inside a ``havc.cm_frame_loop`` span (the port's stage spans,
``harness/spans.py``), in %."""

from harness import spans


def read(ctx):
    return spans.idle_pct(ctx.trace, ("cm_frame_loop",))
