"""Entry layer (``api.HAVC_main``'s glue between its stages, and the
harness's hand-off): the share of the profiled part's wall time in which
no kernel ran while the host was in no ``havc.*`` span
(``harness/spans.py``), in %.  With the other ``*_idle_pct`` shares of
the stages it partitions ``device_idle_pct``."""

from harness import spans


def read(ctx):
    return spans.idle_pct(ctx.trace, None)
