"""Colorizer layer (``api._colorize_fused``, ``engines.py``): the share
of the profiled part's wall time in which no kernel ran while the host
was inside a ``havc.deoldify`` or ``havc.ddcolor`` span
(``harness/spans.py``), in %."""

from harness import spans


def read(ctx):
    return spans.idle_pct(ctx.trace, ("deoldify", "ddcolor"))
