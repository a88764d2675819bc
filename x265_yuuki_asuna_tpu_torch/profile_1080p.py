"""Where the time of a 1080p CQP frame goes, on the card.

    python -m x265_yuuki_asuna_tpu_torch.profile_1080p [--frames 3]
        [--max-depth 0 2] [--bframes 3]

For each session (the uniform 16x16 grid, max_depth 0, and the CTU32
depth-2 quadtree, max_depth 2) encodes a synthetic 1080p clip (the chip
smoke test's): the first frames warm up, then torch.profiler records one I
frame and one P frame of a fresh session through
VideoEncoderSession.encode_frame (so the first of them is an IDR). With
--bframes N the quadtree session is a B session instead (N B frames per
mini-GOP, B-pyramid, b_adapt=0): a warm-up session codes an IDR and one
mini-GOP through push_frame, then a fresh session does the same with each
coded frame (I, P, then the B frames) recorded on its own; the lookahead,
which push_frame runs before the frame is coded, is outside the records.
Prints one JSON object per session with, for each recorded frame: its
type and POC, its wall ms, device busy ms (the sum of CUDA kernel times)
and so the device's idle share, its number of kernel launches, its stage
ms, and the top operators by self device time and by self host time.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def synth_clip(n, w, h, seed=7):
    rng = np.random.default_rng(seed)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 32, (h, w)).astype(np.uint8)
    return [((base + np.roll(tex, (i * 2, i * 3), axis=(0, 1)) + i * 2)
             .astype(np.uint8),
             ((base[::2, ::2] // 2) + i).astype(np.uint8),
             ((255 - base[::2, ::2]) // 2).astype(np.uint8))
            for i in range(n)]


def _top(events, key, n=10):
    rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)[:n]
    return [{"op": e.key, "calls": e.count,
             "self_device_ms": e.self_device_time_total / 1e3,
             "self_host_ms": e.self_cpu_time_total / 1e3} for e in rows]


def _recorded(sess, fn, out: list):
    """fn (a call that codes one frame and returns its FrameResult, or
    (FrameResult, recon)) wrapped to run under torch.profiler and append
    the frame's record to `out`."""
    def run(*a, **k):
        stage0 = dict(sess.stage_ms)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        r = res[0] if isinstance(res, tuple) else res
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        ev = prof.key_averages()
        out.append({"frame_type": r.frame_type, "poc": r.poc,
                    "wall_ms": wall, "device_busy_ms": busy,
                    "device_idle_share": 1 - busy / wall,
                    "device_kernels": len(kernels),
                    "stage_ms": {k: v - stage0.get(k, 0.0)
                                 for k, v in sess.stage_ms.items()},
                    "top_by_device": _top(ev, "self_device_time_total"),
                    "top_by_host": _top(ev, "self_cpu_time_total")})
        return res
    return run


def profile_session(max_depth: int, warm_frames: int,
                    bframes: int = 0) -> dict:
    from .models.encoder_top import VideoEncoderSession
    kw = dict(qp=32, keyint=250, hash_sei=True, max_depth=max_depth)
    out = []
    if bframes:
        kw.update(bframes=bframes, b_adapt=0)
        frames = synth_clip(bframes + 2, 1920, 1080)
        warm = VideoEncoderSession(1920, 1080, **kw)
        for f in frames:
            warm.push_frame(*f)
        sess = VideoEncoderSession(1920, 1080, **kw)
        for name in ("_encode_idr_anchor", "_encode_p_anchor", "_encode_b"):
            setattr(sess, name, _recorded(sess, getattr(sess, name), out))
        torch.cuda.synchronize()
        for f in frames:
            sess.push_frame(*f)
    else:
        frames = synth_clip(warm_frames + 2, 1920, 1080)
        warm = VideoEncoderSession(1920, 1080, **kw)
        for f in frames[:warm_frames]:
            warm.encode_frame(*f)
        sess = VideoEncoderSession(1920, 1080, **kw)
        torch.cuda.synchronize()
        encode = _recorded(sess, sess.encode_frame, out)
        for f in frames[warm_frames:]:
            encode(*f)
    name = ("qt2" if max_depth else "uniform") + ("_b" if bframes else "")
    return {"session": name, "card": torch.cuda.get_device_name(0),
            "frames": out}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3,
                    help="warm-up frames before the recorded I + P pair")
    ap.add_argument("--max-depth", type=int, nargs="+", default=[0, 2],
                    help="sessions to profile: 0 uniform grid, 2 quadtree")
    ap.add_argument("--bframes", type=int, default=0,
                    help="B frames per mini-GOP of the quadtree session "
                         "(the port codes B frames on the quadtree only)")
    args = ap.parse_args()
    for md in args.max_depth:
        print(json.dumps(profile_session(md, args.frames,
                                         args.bframes if md else 0)),
              flush=True)


if __name__ == "__main__":
    main()
