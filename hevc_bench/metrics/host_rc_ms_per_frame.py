"""host_rc_ms_per_frame: rate control, the per-CU QP map and weighted
prediction's analysis on the host (stages "rc", "qp_map", "weights") per
window frame."""


def read(ctx):
    return ctx.stage_per_frame("rc", "qp_map", "weights")
