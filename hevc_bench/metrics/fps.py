"""fps: frames returned in the window over the window's seconds."""


def read(ctx):
    return len(ctx.frames) / ctx.window_s if ctx.frames else None
