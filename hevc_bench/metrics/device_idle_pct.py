"""device_idle_pct: the share of the traced frames' wall time in which no
kernel or copy ran on the card (1 - union of their intervals / wall)."""


def read(ctx):
    if ctx.tracer is None or not ctx.tracer.calls:
        return None
    return 100 * (1 - ctx.tracer.busy_s() / ctx.tracer.window_s())
