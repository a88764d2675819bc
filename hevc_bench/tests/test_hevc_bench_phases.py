"""The inter program's phase metrics on made-up readings: the four ms
readers, the two launch readers on a made-up trace (kernels in nested
spans, in no span, on a span's edge; copies are no launches), and both
silent on a program that records no phases. The card test (-m gpu) holds
the traced run's span clock to the profiler's device clock."""

import statistics

import pytest
import torch

from hevc_bench import harness, phases
from hevc_bench.trace import Tracer

MS = ("me_ms_per_frame", "decide_ms_per_frame", "commit_ms_per_frame",
      "fetch_ms_per_frame")
LAUNCHES = ("decide_launches_per_frame", "commit_launches_per_frame")


def ctx(**kw):
    base = dict(frames=[], stage_ms={}, window_s=1.0, setup_s=1.0,
                fps_num=25, fps_den=1, tracer=None, k1_traced=[],
                peaks=None)
    return harness.Ctx(**dict(base, **kw))


def read(name, c):
    return harness.reader(name).read(c)


def phase_tracer():
    t = Tracer()
    # a B frame: the phases flat inside inter_b, the filters after the
    # commit, serialize after the program
    t.calls.append(dict(label="B", t0_ns=0, t1_ns=1200, spans=[
        ("me", 0, 100), ("decide", 100, 500), ("fetch", 500, 550),
        ("commit", 550, 800), ("filters", 800, 900), ("inter_b", 0, 1000),
        ("serialize", 1000, 1100)], events=[
        (50, 60, "k1_kernel"),                # me
        (150, 160, "gemm"), (499, 510, "gemm"),           # decide
        (200, 300, "Memcpy HtoD (Pageable -> Device)"),   # no launch
        (500, 505, "Memcpy DtoH (Device -> Pageable)"),   # no launch
        (500, 520, "reduce"),                 # fetch's start edge
        (600, 610, "gemm"), (700, 710, "gemm"),           # commit
        (800, 810, "deblock"),                # the filters' start edge
        (950, 960, "elementwise"),            # inter_b alone
        (1150, 1160, "elementwise")]))        # in no span
    # a P frame whose spans' edges fall on kernel starts
    t.calls.append(dict(label="P", t0_ns=2000, t1_ns=3000, spans=[
        ("decide", 2000, 2400), ("commit", 2400, 2600), ("inter", 2000,
                                                         2700)], events=[
        (2000, 2010, "gemm"), (2400, 2410, "gemm"), (2500, 2510, "gemm"),
        (2600, 2610, "gemm")]))
    return t


def test_ms_readers_read_their_phase_per_window_frame():
    frames = [dict(type="b", display=i, bits=1, psnr_y=40.0)
              for i in range(4)]
    c = ctx(frames=frames, stage_ms={"inter": 900.0, "inter_b": 3100.0,
                                     "me": 40.0, "decide": 1000.0,
                                     "commit": 2000.0, "fetch": 400.0})
    assert [read(n, c) for n in MS] == pytest.approx(
        [10.0, 250.0, 500.0, 100.0])
    # a program without phases: nothing to read
    c = ctx(frames=frames, stage_ms={"inter": 900.0, "inter_b": 3100.0})
    assert [read(n, c) for n in MS] == [None] * 4


def test_launch_readers_count_kernels_by_the_innermost_span():
    c = ctx(tracer=phase_tracer())
    # decide: 150 and 499 in B (500 is fetch's), 2000 in P (its start
    # edge); commit: 600 and 700 in B (800 is the filters'), 2400 and
    # 2500 in P (2600, its end, is inter's)
    assert read("decide_launches_per_frame", c) == pytest.approx(1.5)
    assert read("commit_launches_per_frame", c) == pytest.approx(2.0)


def test_innermost_segments():
    t = phase_tracer()
    edges, names = phases.segments(t.calls[0]["spans"])
    at = {x: phases.stage_at(edges, names, x)
          for x in (-1, 0, 99, 100, 550, 850, 950, 1000, 1100, 1150)}
    assert at == {-1: None, 0: "me", 99: "me", 100: "decide", 550: "commit",
                  850: "filters", 950: "inter_b", 1000: "serialize",
                  1100: None, 1150: None}
    assert phases.segments([]) == ([], [])


def test_launch_readers_are_silent_without_phase_spans():
    t = phase_tracer()
    for call in t.calls:
        call["spans"] = [sp for sp in call["spans"]
                         if sp[0] in ("inter", "inter_b", "serialize")]
    for c in (ctx(tracer=t), ctx(tracer=Tracer()), ctx()):
        assert [read(n, c) for n in LAUNCHES] == [None, None]


@pytest.mark.gpu
def test_span_clock_agrees_with_the_device_trace(card):
    """Spans of the traced run (time.time_ns) against the profiler's
    device events: after a synchronize, a span that launches one kernel
    sees it start on the card within 0.1 ms of the span's start, and not
    before it (the median over 30 spans)."""
    x = torch.zeros(1 << 20, device=card)
    t = Tracer()
    spanned = t.wrap_timed(lambda stage_ms, stage, fn, *a, **k: fn(*a, **k))

    def spans():
        for _ in range(30):
            torch.cuda.synchronize()
            spanned(None, "span", x.add_, 1)
    run = t.wrap(spans, "S")
    spans()                                   # the kernel's first launch
    t.armed = True
    run()
    call = t.calls[0]
    kernels = sorted(e[0] for e in call["events"])
    starts = sorted(sp[1] for sp in call["spans"])
    assert len(kernels) == len(starts) == 30
    offsets = [(k - s) / 1e6 for k, s in zip(kernels, starts)]
    print("span start to its kernel's device start, ms:", offsets)
    assert 0.0 <= statistics.median(offsets) <= 0.1
