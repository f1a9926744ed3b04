"""ColorMNet layer: the port's ``cm_graph_replays`` counter (frame steps
that ran as a replay of a captured CUDA graph) over its ``cm_steps``
counter (every frame step), in %, both over the whole run: the warm-up
(where each plan's first step runs eagerly and is captured), the
profiled and the stage-timed parts.  None where the port has no such
counters."""

import sys


def read(ctx):
    profiling = sys.modules.get("havc_tpu_torch.utils.profiling")
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    return 100.0 * c.get("cm_graph_replays", 0) / c["cm_steps"] if c.get("cm_steps") else None
