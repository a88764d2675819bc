"""lookahead_ms_per_frame: the lookahead's and b-adapt's host wall ms (stages
"lookahead" and "b_adapt") per window frame."""


def read(ctx):
    return ctx.stage_per_frame("lookahead", "b_adapt")
