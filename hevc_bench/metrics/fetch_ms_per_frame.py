"""fetch_ms_per_frame: the inter programs' reads of their decisions to the
host (stage "fetch"), its spans' host wall ms per window frame: mostly the
host's wait for the card to finish the work queued before each read, a
reading of that wait with no device trace; nothing where the program
records no such phase."""


def read(ctx):
    return ctx.stage_per_frame("fetch")
