"""kbps: bits of the window's frames at the input's frame rate, in kbit/s."""


def read(ctx):
    if not ctx.frames:
        return None
    bits = sum(f["bits"] for f in ctx.frames)
    return bits * ctx.fps_num / ctx.fps_den / len(ctx.frames) / 1000
