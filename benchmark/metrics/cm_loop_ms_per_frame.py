"""ColorMNet layer (``exemplar.colormnet_propagate``,
``models/colormnet.py``, ``models/memory.py``): the stage timer's
``cm_frame_loop`` seconds over every frame of the stage-timed part (the
loop steps over each frame, a reference included), in ms."""


def read(ctx):
    if "cm_frame_loop" not in ctx.stages or not ctx.timed["frames"]:
        return None
    return 1e3 * ctx.stages["cm_frame_loop"] / ctx.timed["frames"]
