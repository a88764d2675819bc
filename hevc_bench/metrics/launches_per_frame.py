"""launches_per_frame: CUDA kernels the card ran in the traced frames, per
traced frame."""


def read(ctx):
    if ctx.tracer is None or not ctx.tracer.calls:
        return None
    return len(ctx.tracer.kernels()) / len(ctx.tracer.calls)
