"""Stabilizer layer (``api.HAVC_stabilizer``): the stage timer's
``post_chain`` (where it runs), ``chroma_stabilizer``, ``deflicker``,
``stab_resize`` and ``stab_chroma_restore`` seconds over the frames of the
stage-timed part, in ms."""

STAGES = ("post_chain", "chroma_stabilizer", "deflicker", "stab_resize", "stab_chroma_restore")


def read(ctx):
    if "stab_resize" not in ctx.stages or not ctx.timed["frames"]:
        return None
    return 1e3 * sum(ctx.stages.get(k, 0.0) for k in STAGES) / ctx.timed["frames"]
