"""k1_roofline_pct: the least time of the K1 sweeps launched in the traced
frames (k1.bound_s from their shapes and the table of peaks) over the
device time of their kernels ("k1_kernel" in the trace)."""

from hevc_bench import k1


def read(ctx):
    if ctx.tracer is None or ctx.peaks is None or not ctx.k1_traced:
        return None
    ns = sum(e - s for s, e, name in ctx.tracer.kernels()
             if "k1_kernel" in name)
    if ns <= 0:
        return None
    least = sum(k1.bound_s(ctx.peaks, r["H"], r["W"], r["R"], r["elem"],
                           r["n"], r["base"]) for r in ctx.k1_traced)
    return 100 * least / (ns / 1e9)
