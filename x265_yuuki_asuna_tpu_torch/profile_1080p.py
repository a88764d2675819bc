"""Where the time of a 1080p frame goes, on the card.

    python -m x265_yuuki_asuna_tpu_torch.profile_1080p [--frames 3]
        [--max-depth 0 1 2] [--bframes 3] [--deblock] [--sao] [--sbh]
        [--rdoq] [--aq-mode 2] [--cutree] [--rc-mode crf] [--crf 28]
        [--bitrate 27000] [--vbv-maxrate 27000] [--vbv-bufsize 27000]
        [--hme] [--b-adapt 2] [--weightp] [--fade 6]
        [--flagship [--hme-turns 3]] [--cli "--preset superfast"
        [--bit-depth 10]] [--intra] [--batch 4] [--device-only]

For each session (the uniform 16x16 grid, max_depth 0, and the CTU32
quadtree of depth 1 or 2; by default 0 and 2) encodes a synthetic 1080p
clip (the chip
smoke test's): the first frames warm up, then torch.profiler records one I
frame and one P frame of a fresh session through
VideoEncoderSession.encode_frame (so the first of them is an IDR). With
--bframes N each session is a B session instead (N B frames per
mini-GOP, B-pyramid, b_adapt=0 or --b-adapt's): a warm-up session codes an
IDR and N + 1 frames through push_frame and flush, then a fresh session
does the same with each coded frame (I, P, then the B frames) recorded on
its own; the lookahead and the b-adapt decision, which push_frame runs
before a frame is coded, are outside the records (their ms are the
session's stages "lookahead" and "b_adapt", printed per session).
--hme switches the quadtree sessions' hierarchical search on, --weightp
the video sessions' weighted prediction (on the quadtree: the host-filter
path; its host work is the stage "weights"); --fade N lowers the clip's
luma by N a frame (clipped), so the weight analysis has a fade to find.
--cli
profiles the session the command line (x265_yuuki_asuna_tpu_torch.cli)
builds from the given flags for a 1920x1080 25 fps input, in place of
the other sessions (with B frames: each coded frame recorded, as above;
e.g. "--preset superfast --no-b-intra", "--preset superfast --psy-rd
0", or "--preset medium" with --fade: x265's default, weighted); with
--bit-depth 10 or 12 the input and so the session are that deep (the
clip's samples times 2^(bd - 8): Main10 / Main12). --flagship
profiles bench.py's session (its constructor verbatim: the quadtree B
session with HME, b-adapt 2, CRF 28, AQ 2, cuTree, deblock, SAO, sign
hiding, no hash SEI, no recon to the host) in place of the other
sessions; with --hme-turns N it profiles nothing and instead times that
session's last B frame's inter program N times with and N times without
HME, in turns (HME's cost on a B frame).
--deblock / --sao switch the sessions' in-loop filters on, --sbh / --rdoq
sign-bit hiding / RDOQ, --aq-mode / --cutree adaptive quantization /
cuTree (the per-CU QP map: its host work is the stage "qp_map");
--rc-mode / --crf / --bitrate / --vbv-maxrate / --vbv-bufsize the video
sessions' rate control (CQP at qp 32 by default; its host work is the
stage "rc"). --intra profiles the all-intra session instead
(IntraEncoderSession): after the warm-up, one frame through encode_frame
and, with --batch N, one batch of N frames through encode_batch, recorded
as one entry (its launches and device time are the batch's; divide by
"frames" for a frame's). --device-only traces the card's activity alone:
tracing every host operator as well costs more than the frame itself
once a frame launches millions of kernels (the quadtree I frame with
RDOQ); the host columns and the filters' span are then empty.
Prints one JSON object per session with, for each recorded frame: its
type and POC, its wall ms, device busy ms (the sum of CUDA kernel times)
and so the device's idle share, its number of kernel launches, its stage
ms, the filter chain's launches and device ms (the kernels that start
inside the device-side span of its "filters" profiler range), and the
top operators by self device time and by self host time.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def synth_clip(n, w, h, seed=7, fade=0, bit_depth=8):
    """The chip smoke test's clip (bench.py's synth_clip); fade > 0 lowers
    frame i's luma by fade * i, clipped at 0 (a fade to black); at
    bit_depth > 8 every sample times 2^(bit_depth - 8), as uint16."""
    if bit_depth > 8:
        return [tuple(p.astype(np.uint16) << (bit_depth - 8) for p in f)
                for f in synth_clip(n, w, h, seed, fade)]
    rng = np.random.default_rng(seed)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 32, (h, w)).astype(np.uint8)
    return [(np.clip((base + np.roll(tex, (i * 2, i * 3), axis=(0, 1))
                      + i * 2).astype(np.uint8).astype(np.int32)
                     - fade * i, 0, 255).astype(np.uint8),
             ((base[::2, ::2] // 2) + i).astype(np.uint8),
             ((255 - base[::2, ::2]) // 2).astype(np.uint8))
            for i in range(n)]


def _top(events, key, n=10):
    rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)[:n]
    return [{"op": e.key, "calls": e.count,
             "self_device_ms": e.self_device_time_total / 1e3,
             "self_host_ms": e.self_cpu_time_total / 1e3} for e in rows]


def _filter_record(kernels, spans) -> dict:
    """The filter chain's device work: the kernels (and copies) that start
    inside its "filters" range on the device timeline (`spans`): their
    count, their summed device ms, the span's ms and the kernels with the
    most device time."""
    fk = [e for e in kernels
          if any(s.start <= e.time_range.start <= s.end for s in spans)]
    by_name = {}
    for e in fk:
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"launches": len(fk),
            "device_ms": sum(ms for _, ms in by_name.values()),
            "span_ms": sum(s.elapsed_us() for s in spans) / 1e3,
            "top": [{"kernel": k[:80], "calls": n, "device_ms": ms}
                    for k, (n, ms) in top]}


def _recorded(sess, fn, out: list, device_only: bool = False):
    """fn (a call that codes one frame and returns its FrameResult, or
    (FrameResult, recon), or a batch's list of FrameResults) wrapped to
    run under torch.profiler and append the frame's record to `out`."""
    acts = [ProfilerActivity.CUDA] if device_only else \
        [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def run(*a, **k):
        stage0 = dict(sess.stage_ms)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        batch = res if isinstance(res, list) else None
        r = res[0] if isinstance(res, (tuple, list)) else res
        # device events: kernels and copies, and (user annotations) the
        # device-side spans of record_function ranges
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        span = lambda e: e.name == "filters" or \
            getattr(e, "is_user_annotation", False)
        kernels = [e for e in dev if not span(e)]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        spans = [e.time_range for e in dev if e.name == "filters"]
        ev = prof.key_averages()
        out.append({"frame_type": r.frame_type, "poc": r.poc,
                    "frames": len(batch) if batch else 1,
                    "wall_ms": wall, "device_busy_ms": busy,
                    "device_idle_share": 1 - busy / wall,
                    "device_kernels": len(kernels),
                    "filters": _filter_record(kernels, spans),
                    "stage_ms": {k: v - stage0.get(k, 0.0)
                                 for k, v in sess.stage_ms.items()},
                    "top_by_device": _top(ev, "self_device_time_total"),
                    "top_by_host": _top(ev, "self_cpu_time_total")})
        return res
    return run


def _name(max_depth: int, bframes: int, kw: dict, intra: bool = False):
    return ("intra_" if intra else "") \
        + (f"qt{max_depth}" if max_depth else "uniform") \
        + ("_b" if bframes else "") \
        + ("_lf" if kw.get("deblock") or kw.get("sao") else "") \
        + ("_sbh" if kw.get("sbh") else "") \
        + ("_rdoq" if kw.get("rdoq") else "") \
        + (f"_aq{kw['aq_mode']}" if kw.get("aq_mode") else "") \
        + ("_cutree" if kw.get("cutree") else "") \
        + (f"_{kw['rc_mode']}" if kw.get("rc_mode", "cqp") != "cqp"
           else "") + ("_vbv" if kw.get("vbv_maxrate_kbps") else "") \
        + ("_hme" if kw.get("hme") else "") \
        + ("_weightp" if kw.get("weightp") else "") \
        + (f"_badapt{kw.get('b_adapt', 2)}" if bframes else "")


def profile_intra(max_depth: int, warm_frames: int, batch: int,
                  opts: dict, device_only: bool = False) -> dict:
    """The all-intra session: one frame through encode_frame and one batch
    through encode_batch, each recorded."""
    from .models.encoder_top import IntraEncoderSession
    kw = dict(qp=32, hash_sei=True, max_depth=max_depth, **opts)
    frames = synth_clip(max(warm_frames, batch, 1) + 1, 1920, 1080)
    sess = IntraEncoderSession(1920, 1080, **kw)
    for f in frames[:warm_frames]:
        sess.encode_frame(*f)
    if batch:
        sess.encode_batch(frames[:batch])           # warm-up of the batch
    torch.cuda.synchronize()
    out = []
    _recorded(sess, sess.encode_frame, out, device_only)(*frames[-1])
    if batch:
        _recorded(sess, sess.encode_batch, out, device_only)(frames[:batch])
    return {"session": _name(max_depth, 0, kw, True),
            "card": torch.cuda.get_device_name(0), "frames": out}


# bench.py's session constructor (the flagship configuration)
FLAGSHIP = dict(keyint=250, bframes=3, b_pyramid=True, max_depth=2,
                rc_mode="crf", crf=28.0, aq_mode=2, cutree=True,
                deblock=True, sao=True, sbh=True, hash_sei=False, hme=True,
                quality_metrics=False, recon_out=False)


def profile_session(max_depth: int, warm_frames: int,
                    bframes: int = 0, opts: dict = None,
                    device_only: bool = False, kw: dict = None,
                    make=None, name: str = None, fade: int = 0,
                    bit_depth: int = 8) -> dict:
    """One video session's recorded frames; kw: the constructor's
    keywords verbatim (else qp 32, keyint 250, the hash SEI, max_depth,
    bframes and opts); make: a function that returns a new session (in
    place of the constructor), name its record's name; fade: the clip's
    luma ramp and bit_depth its samples' (synth_clip)."""
    from .models.encoder_top import VideoEncoderSession
    if make is None:
        if kw is None:
            kw = dict(qp=32, keyint=250, hash_sei=True, max_depth=max_depth,
                      **opts)
            if bframes:
                kw.update(bframes=bframes)
        make = lambda: VideoEncoderSession(1920, 1080, **kw)
    probe = make()
    bframes = probe.bframes
    out = []
    if bframes:
        frames = synth_clip(bframes + 2, 1920, 1080, fade=fade,
                            bit_depth=bit_depth)
        warm = probe
        for f in frames:
            warm.push_frame(*f)
        warm.flush()
        sess = make()
        for fn in ("_encode_idr_anchor", "_encode_p_anchor", "_encode_b"):
            setattr(sess, fn, _recorded(sess, getattr(sess, fn), out,
                                        device_only))
        torch.cuda.synchronize()
        for f in frames:
            sess.push_frame(*f)
        sess.flush()
    else:
        frames = synth_clip(warm_frames + 2, 1920, 1080, fade=fade,
                            bit_depth=bit_depth)
        warm = probe
        for f in frames[:warm_frames]:
            warm.encode_frame(*f)
        sess = make()
        torch.cuda.synchronize()
        encode = _recorded(sess, sess.encode_frame, out, device_only)
        for f in frames[warm_frames:]:
            encode(*f)
    return {"session": name or _name(kw.get("max_depth", 0), bframes, kw),
            "card": torch.cuda.get_device_name(0), "frames": out,
            "stage_ms": dict(sess.stage_ms)}


def cli_session(flags: str, bit_depth: int = 8):
    """A function that returns a new session of the command line with
    these flags (a string) for a 1920x1080 25 fps 4:2:0 input of
    bit_depth-bit samples."""
    from . import cli
    from .utils import io as IO
    info = IO.VideoInfo(1920, 1080, 25, 1, IO.CSP_I420, bit_depth)

    def make():
        args, prm = cli.parse(["in.y4m", "-o", "out.hevc"] + flags.split())
        return cli.configure(args, prm, info)
    return make


def hme_turns(turns: int) -> dict:
    """bench.py's session over five 1080p frames (the IDR and one
    mini-GOP), then its last B frame's inter program again, timed with and
    without HME in turns (with, without, without, with, ...): wall ms of
    each synchronised call."""
    from .models.encoder_top import VideoEncoderSession
    sess = VideoEncoderSession(1920, 1080, **FLAGSHIP)
    enc = sess.inter_encoder
    calls, run = [], enc.encode_frame
    enc.encode_frame = lambda *a, **k: calls.append((a, k)) or run(*a, **k)
    for f in synth_clip(5, 1920, 1080):
        sess.push_frame(*f)
    sess.flush()
    args, kw = calls[-1]
    if kw.get("ref1") is None:
        raise AssertionError("the last inter call is not a B frame")
    ms = {True: [], False: []}
    for i in range(turns):
        for hme in ((True, False) if i % 2 == 0 else (False, True)):
            enc.hme = hme
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(*args, **kw)
            torch.cuda.synchronize()
            ms[hme].append((time.perf_counter() - t0) * 1e3)
    return {"session": "flagship_b_frame_hme_turns",
            "card": torch.cuda.get_device_name(0),
            "b_frame_ms_with_hme": ms[True],
            "b_frame_ms_without_hme": ms[False]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3,
                    help="warm-up frames before the recorded I + P pair")
    ap.add_argument("--max-depth", type=int, nargs="+", default=[0, 2],
                    help="sessions to profile: 0 uniform grid, 1 or 2 "
                         "the quadtree of that depth")
    ap.add_argument("--bframes", type=int, default=0,
                    help="B frames per mini-GOP of each session")
    ap.add_argument("--deblock", action="store_true",
                    help="switch the deblocking filter on")
    ap.add_argument("--sao", action="store_true",
                    help="switch SAO on")
    ap.add_argument("--sbh", action="store_true",
                    help="switch sign-bit hiding on")
    ap.add_argument("--rdoq", action="store_true", help="switch RDOQ on")
    ap.add_argument("--aq-mode", type=int, default=0,
                    help="adaptive quantization mode (1-4)")
    ap.add_argument("--cutree", action="store_true",
                    help="switch cuTree on (video sessions)")
    ap.add_argument("--rc-mode", default="cqp", choices=("cqp", "crf", "abr"),
                    help="rate control of the video sessions")
    ap.add_argument("--crf", type=float, default=28.0,
                    help="with --rc-mode crf: the rate factor")
    ap.add_argument("--bitrate", type=int, default=0,
                    help="with --rc-mode abr: the target, kbit/s")
    ap.add_argument("--vbv-maxrate", type=int, default=0,
                    help="VBV maximum rate, kbit/s (with --vbv-bufsize)")
    ap.add_argument("--vbv-bufsize", type=int, default=0,
                    help="VBV buffer size, kbit")
    ap.add_argument("--hme", action="store_true",
                    help="switch HME on (quadtree sessions)")
    ap.add_argument("--b-adapt", type=int, default=0, choices=(0, 1, 2),
                    help="with --bframes: the B sessions' b-adapt")
    ap.add_argument("--weightp", action="store_true",
                    help="switch weighted prediction on (video sessions)")
    ap.add_argument("--fade", type=int, default=0,
                    help="lower the clip's luma by this much a frame")
    ap.add_argument("--cli", default=None,
                    help="profile the command line's session of these "
                         "flags (one string) alone")
    ap.add_argument("--bit-depth", type=int, default=8, choices=(8, 10, 12),
                    help="with --cli: the input's bit depth")
    ap.add_argument("--flagship", action="store_true",
                    help="profile bench.py's session alone")
    ap.add_argument("--hme-turns", type=int, default=0,
                    help="with --flagship: instead of profiling, time its "
                         "last B frame's inter program this many times "
                         "with and without HME, in turns")
    ap.add_argument("--intra", action="store_true",
                    help="profile the all-intra session")
    ap.add_argument("--batch", type=int, default=0,
                    help="with --intra: also one batch of this many frames")
    ap.add_argument("--device-only", action="store_true",
                    help="trace the card's activity alone")
    args = ap.parse_args()
    opts = dict(deblock=args.deblock, sao=args.sao, sbh=args.sbh,
                rdoq=args.rdoq, aq_mode=args.aq_mode)
    if args.flagship and args.hme_turns:
        print(json.dumps(hme_turns(args.hme_turns)), flush=True)
        return
    if args.flagship:
        print(json.dumps(profile_session(2, args.frames, kw=FLAGSHIP,
                                         device_only=args.device_only)),
              flush=True)
        return
    if args.cli:
        print(json.dumps(profile_session(
            2, args.frames, device_only=args.device_only,
            make=cli_session(args.cli, args.bit_depth),
            name=f"cli {args.cli}" + (f" ({args.bit_depth}-bit)"
                                      if args.bit_depth > 8 else ""),
            fade=args.fade, bit_depth=args.bit_depth)), flush=True)
        return
    for md in args.max_depth:
        if args.intra:
            rec = profile_intra(md, args.frames, args.batch, opts,
                                args.device_only)
        else:
            rc = dict(rc_mode=args.rc_mode, crf=args.crf,
                      bitrate_kbps=args.bitrate,
                      vbv_maxrate_kbps=args.vbv_maxrate,
                      vbv_bufsize_kbps=args.vbv_bufsize)
            vid = dict(cutree=args.cutree, weightp=args.weightp, **rc)
            if args.bframes:
                vid["b_adapt"] = args.b_adapt
            if md:
                vid["hme"] = args.hme
            rec = profile_session(md, args.frames, args.bframes,
                                  dict(opts, **vid), args.device_only,
                                  fade=args.fade)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
