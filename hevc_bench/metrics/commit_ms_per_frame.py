"""commit_ms_per_frame: the inter programs' intra commit (stage "commit":
the decided intra leaves reconstructed along the CTU wavefront), its
spans' host wall ms per window frame; nothing where the program records
no such phase."""


def read(ctx):
    return ctx.stage_per_frame("commit")
