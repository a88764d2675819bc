"""The program phases of the traced calls: each kernel put down to the
session stage whose span holds its device start (the innermost span, as
trace.Tracer.idle_gaps puts down an idle gap), read by the launch
metrics of the inter program's phases.

A kernel starts on the card after the host has launched it, so a start
time names the launching span only while the device keeps pace with the
host; launch_check.py measures how far that holds.
"""

from __future__ import annotations

from bisect import bisect_right

from .trace import is_copy


def segments(spans):
    """(edges, names): from edges[i] up to edges[i + 1] the innermost of
    the spans (stage, t0, t1), each [t0, t1), is names[i] (None: none)."""
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    names = []
    for a in edges[:-1]:
        inner = [sp for sp in spans if sp[1] <= a < sp[2]]
        names.append(min(inner, key=lambda sp: sp[2] - sp[1])[0]
                     if inner else None)
    return edges, names


def stage_at(edges, names, t):
    """The innermost span's stage at time t (None outside every span)."""
    i = bisect_right(edges, t) - 1
    return names[i] if 0 <= i < len(names) else None


def launches_in(tracer, stage: str):
    """Kernels of the traced calls whose device start lies in a span of
    `stage` (the innermost span there), per traced call; None where no
    traced call has such a span."""
    if tracer is None or not tracer.calls or not any(
            sp[0] == stage for c in tracer.calls for sp in c["spans"]):
        return None
    n = 0
    for c in tracer.calls:
        edges, names = segments(c["spans"])
        n += sum(stage_at(edges, names, s) == stage
                 for s, _, name in c["events"] if not is_copy(name))
    return n / len(tracer.calls)
