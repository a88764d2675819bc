"""decide_launches_per_frame: kernels of the traced frames whose device
start lies in a "decide" span (the innermost span there), per traced
frame; nothing where the traced frames record no such span."""

from hevc_bench import phases


def read(ctx):
    return phases.launches_in(ctx.tracer, "decide")
