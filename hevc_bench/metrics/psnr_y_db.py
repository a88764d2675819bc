"""psnr_y_db: mean PSNR-Y of the window's frames as the independent
decoder gives them back, against their source."""


def read(ctx):
    vals = [f["psnr_y"] for f in ctx.frames]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
