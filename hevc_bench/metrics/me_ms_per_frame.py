"""me_ms_per_frame: the inter programs' motion search (stage "me": K1's
sweeps of each list, HME's coarse sweep with it, and each size's subpel
refinement), its spans' host wall ms per window frame; nothing where the
program records no such phase."""


def read(ctx):
    return ctx.stage_per_frame("me")
