"""A check of the inter program's phase spans on the card, for PERF.md.

    python3 -m hevc_bench.launch_check --workload <cell> --seed <n>
        [--out <file.json>]

Builds the cell's session as the benchmark's run does and pushes frames
until the set-up's frames are back, then:

  * sync sites: the next mini-GOP under torch.cuda.set_sync_debug_mode
    ("warn"): each place where the host waited for the card, with the
    session stage (the innermost span) it waited in, and how often;
  * launches: the next B frame under torch.profiler with CPU and CUDA
    activities; each kernel is put down to the phase whose span holds its
    device start (what the launch metrics read, phases.py) and to the one
    whose span holds the host call that launched it (joined by the
    profiler's correlation id). Counts per phase both ways, and the share
    of kernels that start on the card after the span that launched them
    has ended;
  * clock: for each span, its start against its first launch call's and
    its first kernel's start (the spans' clock, time.time_ns, against the
    profiler's).

Prints one JSON object (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import warnings
from collections import Counter, defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hevc_bench import harness  # noqa: E402
from hevc_bench.phases import segments, stage_at  # noqa: E402
from hevc_bench.trace import is_copy  # noqa: E402

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def spread(xs):
    """(least, median, largest) of some values."""
    return (min(xs), statistics.median(xs), max(xs))


def innermost(spans, t):
    """The innermost span (stage, t0, t1) holding t, or None."""
    inner = [sp for sp in spans if sp[1] <= t < sp[2]]
    return min(inner, key=lambda sp: sp[2] - sp[1]) if inner else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hevc_bench.launch_check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top
    from x265_yuuki_asuna_tpu_torch.utils import build
    from x265_yuuki_asuna_tpu_torch.utils import io as IO
    from x265_yuuki_asuna_tpu_torch.utils import param as P
    from hevc_bench.content import Content

    harness.use_cache_dirs()
    for name in ("me_sad", "asuna_native"):
        build.load(name)
    wl, cfg, mix = harness.load_cell(args.workload)
    inp = cfg["input"]
    w, h = inp["width"], inp["height"]
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    content = Content(mix, w, h, args.seed, dev)
    cargs, prm = cli.parse(["input.y4m", "-o", "output.hevc"] + cfg["argv"])
    info = IO.VideoInfo(w, h, *inp["fps"], P.CSP_I420, 8)
    sess = cli.configure(cargs, prm, info, None)

    # every span on time.time_ns, and the stack of open stages
    state = {"spans": None, "stack": []}
    timed = encoder_top._timed

    def spanned(stage_ms, stage, fn, *a, **k):
        state["stack"].append(stage)
        t0 = time.time_ns()
        try:
            return timed(stage_ms, stage, fn, *a, **k)
        finally:
            state["stack"].pop()
            if state["spans"] is not None:
                state["spans"].append((stage, t0, time.time_ns()))
    encoder_top._timed = spanned

    i = 0

    def push():
        nonlocal i
        out = sess.push_frame(*content.frame(i))
        i += 1
        return out

    anchors, types = 0, set()
    while not ({"I", "P", "b"} <= types
               and anchors >= cfg.get("warmup_minigops", 1)):
        back = push()
        types |= {f.frame_type.replace("B", "b") for f in back}
        anchors += sum(f.frame_type == "P" for f in back)
    torch.cuda.synchronize()

    # sync sites over the next mini-GOP, by the stage the host was in
    sites = Counter()
    shown = warnings.showwarning

    def note(message, category, filename, lineno, *a, **k):
        if "synchroniz" in str(message):
            stage = state["stack"][-1] if state["stack"] else "outside"
            where = os.path.relpath(filename, harness.ROOT)
            sites[f"{stage} {where}:{lineno}"] += 1
    gop = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            while not gop:
                gop = push()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    by_stage = defaultdict(int)
    for key, n in sites.items():
        by_stage[key.split(" ")[0]] += n

    # one B frame under the profiler, CPU and CUDA activities
    orig = sess._encode_b
    prof_out = {}

    def profiled(*a, **k):
        if prof_out:
            return orig(*a, **k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state["spans"] = []
            t0 = time.time_ns()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            t1 = time.time_ns()
        prof_out.update(prof=prof, t0=t0, t1=t1, spans=state["spans"])
        state["spans"] = None
        return out
    sess._encode_b = profiled
    while not prof_out:
        push()
    encoder_top._timed = timed

    tp = time.perf_counter()
    spans = prof_out["spans"]
    cuda = torch.autograd.DeviceType.CUDA
    launch, kernels = {}, []
    for e in prof_out["prof"].profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not is_copy(e.name()) and e.duration_ns() > 0 and not \
                    getattr(e, "is_user_annotation", lambda: False)():
                corr = e.correlation_id() or getattr(
                    e, "linked_correlation_id", lambda: 0)()
                kernels.append((e.start_ns(), corr))
        elif e.name() in LAUNCH_CALLS:
            launch[e.correlation_id()] = e.start_ns()
    edges, names = segments(spans)
    by_start, by_launch = Counter(), Counter()
    late, joined = 0, 0
    first_launch, first_kernel = {}, {}
    for ks, corr in kernels:
        by_start[stage_at(edges, names, ks) or "outside"] += 1
        ls = launch.get(corr)
        if ls is None:
            by_launch["no launch call"] += 1
            continue
        joined += 1
        sp = innermost(spans, ls)
        by_launch[sp[0] if sp else "outside"] += 1
        if sp is not None:
            late += ks >= sp[2]
            first_launch[sp] = min(first_launch.get(sp, ls), ls)
            first_kernel[sp] = min(first_kernel.get(sp, ks), ks)
    phases = sorted(set(by_start) | set(by_launch))
    clock = {}
    for stage in sorted({sp[0] for sp in first_launch}):
        mine = [sp for sp in first_launch if sp[0] == stage]
        clock[stage] = {
            "spans": len(mine),
            "first_launch_call_ms": spread(
                [(first_launch[sp] - sp[1]) / 1e6 for sp in mine]),
            "first_kernel_start_ms": spread(
                [(first_kernel[sp] - sp[1]) / 1e6 for sp in mine])}
    result = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(0),
        "sync_sites": dict(sites.most_common()),
        "sync_by_stage": dict(by_stage),
        "sync_gop_frames": [f.frame_type for f in gop],
        "b_frame_ms": (prof_out["t1"] - prof_out["t0"]) / 1e6,
        "kernels": len(kernels), "joined_to_a_launch_call": joined,
        "launch_calls": len(launch),
        "launches": {p: {"by_device_start": by_start.get(p, 0),
                         "by_launch_call": by_launch.get(p, 0)}
                     for p in phases},
        "share_starting_after_their_span": late / max(joined, 1),
        "clock": clock,
        "spans": Counter(sp[0] for sp in spans),
        "analysis_s": time.perf_counter() - tp}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
