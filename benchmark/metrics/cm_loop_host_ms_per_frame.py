"""ColorMNet layer: the host's seconds inside ``havc.cm_frame_loop``
spans over the frames of the profiled part's clips, in ms.  Close to
``cm_loop_ms_per_frame`` (the loop's stream time), the loop is
host-bound."""

from harness import spans


def read(ctx):
    s = spans.host_s(ctx.trace, "cm_frame_loop")
    if s is None or not ctx.profiled["frames"]:
        return None
    return 1e3 * s / ctx.profiled["frames"]
