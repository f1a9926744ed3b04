"""Model step: the engines' FLOPs in the profiled part (each engine's
FLOPs per frame, counted with ``FlopCounterMode`` on the reference's
models in the check, times the frames it ran) over the card's peak at the
engine's precision (TF32 495, bf16 989 TFLOP/s) and the profiled part's
wall time, in %."""

from harness import flops


def read(ctx):
    total = 0.0
    for e in ctx.config["engines"]:
        per_frame = ctx.flops_per_frame.get(e["family"])
        if per_frame is None:
            return None
        frames = ctx.profiled["refs" if e["runs_on"] == "references" else "frames"]
        total += per_frame * frames / flops.PEAK_FLOPS[e["precision"]]
    return 100.0 * total / ctx.trace.wall_s if total else None
