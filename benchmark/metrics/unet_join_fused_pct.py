"""Colorizer layer: the port's ``unet_join_launches`` counter (U-Net
decoder joins that ran as one launch of the hand-written kernel) over its
``unet_join_calls`` counter (every join), in %, both over the whole run:
the warm-up, the profiled and the stage-timed parts.  None where the port
has no such counters."""

import sys


def read(ctx):
    profiling = sys.modules.get("havc_tpu_torch.utils.profiling")
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    calls = c.get("unet_join_calls")
    return 100.0 * c.get("unet_join_launches", 0) / calls if calls else None
