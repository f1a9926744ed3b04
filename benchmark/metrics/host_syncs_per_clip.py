"""Entry layer: the port's ``host_syncs`` counter (every read of a tensor
to the host on ``HAVC_main``'s paths, each a wait for the card) over its
``clips`` counter (``HAVC_main`` calls), both over the whole run: the
warm-up, the profiled and the stage-timed parts.  The reference in the
check never calls the port.  None where the port has no counters."""

import sys


def read(ctx):
    profiling = sys.modules.get("havc_tpu_torch.utils.profiling")
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    return c.get("host_syncs", 0) / c["clips"] if c.get("clips") else None
