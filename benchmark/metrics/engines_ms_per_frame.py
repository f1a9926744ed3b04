"""Colorizer layer (``api._colorize_fused``, ``engines.py``): the stage
timer's ``deoldify`` + ``ddcolor`` seconds over the frames the engines
colorized in the stage-timed part, in ms."""


def read(ctx):
    s = ctx.stages
    if "deoldify" not in s and "ddcolor" not in s:
        return None
    spec = next(e for e in ctx.config["engines"] if e["family"] in ("deoldify", "ddcolor"))
    frames = ctx.timed["refs" if spec["runs_on"] == "references" else "frames"]
    return 1e3 * (s.get("deoldify", 0.0) + s.get("ddcolor", 0.0)) / frames if frames else None
