"""The traced run's device trace and host spans.

`Tracer.wrap` profiles chosen calls with torch.profiler, device activity
only (tracing every host operator would cost more than the frame), and
keeps for each call its host wall time and its device events. While a
call is traced, the session's stage spans (encoder_top._timed, wrapped
from outside) are kept on the same clock, so that each idle gap of the
device can be put down to the stage the host was in.

The arithmetic is a frozen copy of profile_1080p.py's, with the busy time
taken as the union of the kernel and copy intervals (two streams' kernels
that overlap count once). CUPTI's tracing slows every launch of a traced
call, so its host wall, and with it the idle share, reads higher than an
untraced frame's would.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

OUTSIDE = "outside the stages"


def union(intervals):
    """Sorted disjoint (start, end) intervals covering the given ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals) -> int:
    return sum(e - s for s, e in union(intervals))


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Tracer:
    """Profiles the first call of each wrapped function made while
    `armed` is on."""

    def __init__(self):
        self.armed = False
        self.calls = []          # dicts: label, t0_ns, t1_ns, events, spans
        self._spans = None
        self._done = set()
        self._labels = set()

    def complete(self) -> bool:
        """Whether every wrapped function has had its call traced."""
        return self._done >= self._labels

    def wrap(self, fn, label: str):
        self._labels.add(label)

        def traced(*a, **k):
            if not self.armed or label in self._done:
                return fn(*a, **k)
            self._done.add(label)
            return self._profile(fn, label, a, k)
        return traced

    def wrap_timed(self, timed):
        """encoder_top._timed with the stage spans of traced calls kept."""
        def spanned(stage_ms, stage, fn, *a, **k):
            if self._spans is None:
                return timed(stage_ms, stage, fn, *a, **k)
            t0 = time.time_ns()
            try:
                return timed(stage_ms, stage, fn, *a, **k)
            finally:
                self._spans.append((stage, t0, time.time_ns()))
        return spanned

    def _profile(self, fn, label, a, k):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            self._spans = []
            t0 = time.time_ns()
            try:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                t1 = time.time_ns()
                spans, self._spans = self._spans, None
        dev = torch.autograd.DeviceType.CUDA
        events = [(e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == dev]
        self.calls.append(dict(label=label, t0_ns=t0, t1_ns=t1,
                               events=events, spans=spans))
        return out

    # -- readings over all traced calls ------------------------------------
    def window_s(self) -> float:
        return sum(c["t1_ns"] - c["t0_ns"] for c in self.calls) / 1e9

    def busy_s(self) -> float:
        return sum(busy_ns((s, e) for s, e, _ in c["events"])
                   for c in self.calls) / 1e9

    def kernels(self):
        return [ev for c in self.calls for ev in c["events"]
                if not is_copy(ev[2])]

    def top_device_ops(self, n: int = 10):
        """[[name, seconds]] of the device operations with most time."""
        by = defaultdict(int)
        for c in self.calls:
            for s, e, name in c["events"]:
                by[name[:96]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10):
        """[[stage, seconds]]: the device's idle time in the traced calls,
        summed by the session stage the host was in at each gap's middle
        (the innermost span), the largest first."""
        by = defaultdict(int)
        for c in self.calls:
            busy = union((s, e) for s, e, _ in c["events"])
            edges = [c["t0_ns"]] + [x for iv in busy for x in iv] \
                + [c["t1_ns"]]
            for s, e in zip(edges[0::2], edges[1::2]):
                if e <= s:
                    continue
                mid = (s + e) // 2
                inner = [sp for sp in c["spans"] if sp[1] <= mid < sp[2]]
                stage = min(inner, key=lambda sp: sp[2] - sp[1])[0] \
                    if inner else OUTSIDE
                by[f"{c['label']}:{stage}"] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]
