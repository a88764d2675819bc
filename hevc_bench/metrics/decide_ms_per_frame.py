"""decide_ms_per_frame: the inter programs' dense decisions (stage
"decide": each size's motion decision, leaf RD and intra candidate, then
the split decisions and the inter leaves' planes), its spans' host wall
ms per window frame; nothing where the program records no such phase."""


def read(ctx):
    return ctx.stage_per_frame("decide")
