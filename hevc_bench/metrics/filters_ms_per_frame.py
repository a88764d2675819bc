"""filters_ms_per_frame: the in-loop filters' host wall ms (stages "filters",
"deblock", "sao") per window frame; nothing where no filter runs."""


def read(ctx):
    return ctx.stage_per_frame("filters", "deblock", "sao")
