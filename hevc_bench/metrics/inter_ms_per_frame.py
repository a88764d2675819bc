"""inter_ms_per_frame: the P and B programs' host wall ms (the session's
stages "inter" and "inter_b") per window frame."""


def read(ctx):
    return ctx.stage_per_frame("inter", "inter_b")
