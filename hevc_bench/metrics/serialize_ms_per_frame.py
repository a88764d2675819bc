"""serialize_ms_per_frame: the slice writer's host wall ms (stage
"serialize") per window frame."""


def read(ctx):
    return ctx.stage_per_frame("serialize")
