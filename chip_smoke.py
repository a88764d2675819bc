"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits nonzero):
  1. the card's name, power limit and maximum SM clock (nvidia-smi); build
     every native library of the port (K1 with nvcc for sm_90a, the CABAC
     writer with g++), all compilers started together; K1's -Xptxas -v
     summary;
  2. K1's two entry points against their plain PyTorch versions on the
     card, exactly equal: the surface kernel (sad_block8_sweep) and the
     fused sweep-and-argmin kernel (sad_sweep_best, n = 8 and 16) at the
     main paths' shapes (lookahead 544x960 n=8, P-frame ME 1088x1920 uint8:
     the uniform path's n=16 and the quadtree's surface), at 24x32 and
     32x48 with R=16 (range larger than the plane), on a flat plane with
     lambda_bits=0 (every cost ties: the answer must be (-R, -R)), in
     uint8, int16 and int32; then, at the main paths' shapes, each
     kernel's time (CUDA events, after warm-up), its plain version's time
     and its bound, and the whole sweep as the main path pays it: the
     surface route (surface kernel + PyTorch tail) against the fused
     route;
  3. the golden clips through the port's sessions on the card: the IPPP
     CQP stream md5 must equal tests/golden/manifest.json["ippp_cqp"]
     (golden), the CTU32 depth-2 quadtree stream its "qt2_ippp"
     (golden_qt2), and the quadtree B session (bframes=3, B-pyramid,
     b_adapt=0, keyint 5, 8 frames through push_frame / flush) the JAX
     package's md5 pinned below (golden_qt2_b);
  4. qt2_cpu_vs_card: the quadtree IPPP session (3 frames) and the
     quadtree B session (5 frames: I, P, B, b, b) on a 416x240 synthetic
     clip, on the card and with device="cpu": equal stream md5s;
  5. the main paths over a synthetic 1080p clip (qp 32, keyint 250, hash
     SEI) with fps, per-stage ms, bytes, PSNR-Y, peak device memory and
     K1's launch counts, each path's counts set to 0 just before it: the
     uniform IPPP path (1080p, encode_frame; sad_sweep_best = frames + P
     frames: one lookahead sweep per frame, one ME sweep per P frame;
     sad_block8_sweep = 0), the quadtree path (1080p_qt2, encode_frame, I
     + 3 P frames; sad_sweep_best = frames, the lookahead's;
     sad_block8_sweep = P frames, the multi-size ME surface) and the
     quadtree B path (1080p_qt2_b, 5 frames through push_frame / flush:
     IDR, P 4, B 2, b 1, b 3; sad_sweep_best = 5, sad_block8_sweep = 1 +
     2 x 3, one surface per P anchor and one per list per B frame); after
     each, its last P or B frame again with both entry points patched to
     their plain versions, whose decision dict must be identical;
  6. the kernels line (launches on the B path, and on each path); then
     the card line and, last, the ok line.
Exits nonzero without a result when no CUDA device is present.
"""

import hashlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
W1080, H1080 = 1920, 1080
FRAMES = 7          # the uniform IPPP path
QT_FRAMES = 4       # the quadtree path: I + 3 P
QT_B_FRAMES = 5     # the B path: I, then one mini-GOP (P, B, b, b)
B_KW = dict(max_depth=2, bframes=3, b_pyramid=True, b_adapt=0)
# md5 of the JAX package's stream of the quadtree B session on the golden
# clip (64x48, 8 frames, qp 30, keyint 5, no hash SEI)
GOLDEN_QT2_B_MD5 = "0eca13bc30dfb501333206d7751facc6"
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
INT32_LANES_PER_SM = 64        # Hopper SM: 4 partitions x 16 INT32 lanes


def emit(**kw):
    print(json.dumps(kw), flush=True)


def golden_clip(w=64, h=48, n=6, seed=3):
    """tests/golden_corpus.clip (copied: the script imports no test code)."""
    rng = np.random.default_rng(seed)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 48, (h, w)).astype(np.uint8)
    frames = []
    for i in range(n):
        y = (base + np.roll(tex, (2 * i, 3 * i), (0, 1)) + 2 * i)
        frames.append((y.astype(np.uint8),
                       ((base[::2, ::2] // 2) + i).astype(np.uint8),
                       ((255 - base[::2, ::2]) // 2).astype(np.uint8)))
    return frames


def synth_clip(n, w, h, seed=7):
    """bench.py synth_clip (copied): gradient base + moving texture."""
    rng = np.random.default_rng(seed)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 32, (h, w)).astype(np.uint8)
    frames = []
    for i in range(n):
        y = (base + np.roll(tex, (i * 2, i * 3), axis=(0, 1)) + i * 2)
        frames.append((y.astype(np.uint8),
                       ((base[::2, ::2] // 2) + i).astype(np.uint8),
                       ((255 - base[::2, ::2]) // 2).astype(np.uint8)))
    return frames


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms (CUDA events, one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def int_ops_per_s(sms: int, clock_mhz: float, dtype) -> float:
    """Abs-diff-adds per second on the card's INT32 lanes: 64 x SMs x the
    maximum SM clock, four to a packed instruction on 8-bit input."""
    packed = 4 if dtype == torch.uint8 else 1
    return INT32_LANES_PER_SM * sms * clock_mhz * 1e6 * packed


def k1_bound_ms(H: int, W: int, R: int, dtype, ops_rate: float,
                n: int = None):
    """Least time for the sweep: the larger of the bytes (both planes read
    once; the [D, D, H/8, W/8] int32 surface, or with n the three int32
    [nblocks] outputs of the fused kernel, written once) over the memory
    rate and the abs-diff-adds over the INT32-lane rate."""
    D = 2 * R + 1
    out = D * D * (H // 8) * (W // 8) * 4 if n is None \
        else 3 * (H // n) * (W // n) * 4
    nbytes = 2 * H * W * torch.empty((), dtype=dtype).element_size() + out
    t_b, t_o = nbytes / H100_BYTES_PER_S, D * D * H * W / ops_rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    from x265_yuuki_asuna_tpu_torch.utils import build
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in logs["me_sad"].splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit(phase="build", card=smi, clocks_max_sm_mhz=clock, sms=sms,
         int32_abs_diff_adds_per_s=int_ops_per_s(sms, clock, torch.int32),
         build_s=build_s, libraries=sorted(logs), ptxas=ptxas)
    return smi, (sms, clock)


def _planes(dev):
    """(name, ref, src, R, sizes, lambdas) of the K1 parity cases."""
    from x265_yuuki_asuna_tpu_torch.models.lookahead import downscale_half
    fr = synth_clip(2, W1080, H1080)
    pad = lambda y: np.pad(y, ((0, 8), (0, 0)), mode="edge")   # 1080 -> 1088
    y0 = torch.as_tensor(pad(fr[0][0]), device=dev)
    y1 = torch.as_tensor(pad(fr[1][0]), device=dev)
    low = lambda y: downscale_half(y)[:544, :960].contiguous()
    g = golden_clip()
    g0, g1 = (torch.as_tensor(g[i][0], device=dev) for i in (0, 1))
    l0, l1 = (downscale_half(p).to(torch.uint8) for p in (g0, g1))
    rng = np.random.default_rng(11)
    tex = lambda dt: torch.as_tensor(rng.integers(0, 256, (48, 64)),
                                     dtype=dt, device=dev)
    flat = torch.full((48, 64), 77, dtype=torch.uint8, device=dev)
    return [
        ("lookahead 544x960", low(y0).to(torch.uint8),
         low(y1).to(torch.uint8), 16, (8,), (1,)),
        ("P-frame ME 1088x1920", y0, y1, 16, (16,), (2,)),
        ("lookahead 544x960 int32", low(y0), low(y1), 16, (8,), (1,)),
        ("24x32 R>plane", l0[:24, :32].contiguous(),
         l1[:24, :32].contiguous(), 16, (8,), (0, 1, 2)),
        ("32x48 R>plane", g0[:32, :48].contiguous(),
         g1[:32, :48].contiguous(), 16, (8, 16), (0, 1, 2)),
        ("flat lambda=0", flat, flat, 16, (8, 16), (0,)),
        ("48x64 int16", tex(torch.int16), tex(torch.int16), 16, (8, 16),
         (0, 2)),
        ("48x64 int32", tex(torch.int32), tex(torch.int32), 16, (8, 16),
         (0, 2)),
    ]


def phase_k1(dev, card):
    """Both K1 entry points vs their plain versions; times and bounds at
    the main path's shapes."""
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    err = 0
    cases = _planes(dev)
    for name, ref, src, R, sizes, lams in cases:
        k = me_sad.sad_block8_sweep(ref, src, R)
        p = me_sad.sad_block8_sweep_plain(ref, src, R)
        torch.cuda.synchronize()
        e = int((k.long() - p.long()).abs().max())
        best = {}
        for n in sizes:
            for lam in lams:
                kb = me_sad.sad_sweep_best(ref, src, R, n, lam)
                pb = me_sad.sad_sweep_best_plain(ref, src, R, n, lam)
                torch.cuda.synchronize()
                eb = max(int((a.long() - b.long()).abs().max())
                         for a, b in zip(kb, pb))
                best[f"n{n} lambda{lam}"] = eb
                e = max(e, eb)
                if name.startswith("flat") and not (
                        bool((kb[0] == -R).all()) and bool((kb[1] == -R).all())
                        and bool((kb[2] == 0).all())):
                    raise AssertionError(f"flat plane: the first minimum "
                                         f"must be (-R, -R) at n={n}")
        emit(phase="k1_parity", shape=name, dtype=str(src.dtype), R=R,
             surface_max_abs_err=int((k.long() - p.long()).abs().max()),
             best_max_abs_err=best)
        if e:
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"{name}: max abs err {e}")
        err = max(err, e)
    rows = {}
    for name, ref, src, R, (n,), (lam,) in cases[:3]:
        H, W = src.shape
        rate = int_ops_per_s(*card, src.dtype)
        row = dict(shape=name, H=H, W=W, R=R, dtype=str(src.dtype))
        row["surface_ms"] = cuda_ms(
            lambda: me_sad.sad_block8_sweep(ref, src, R), 20)
        row["surface_plain_ms"] = cuda_ms(
            lambda: me_sad.sad_block8_sweep_plain(ref, src, R), 2)
        row["surface_bound_ms"], row["surface_bound_by"] = k1_bound_ms(
            H, W, R, src.dtype, rate)
        # the surface route: the surface kernel, then the PyTorch tail
        row["surface_route_ms"] = cuda_ms(lambda: me_sad.best_of_surface(
            me_sad.sad_block8_sweep(ref, src, R), n, R, lam), 10)
        if src.dtype == torch.uint8:
            shift, kdt = me_sad.key_layout(src.dtype, n, R, lam)
            keys = torch.full(((H // n) * (W // n),), -1, dtype=kdt,
                              device=dev)
            # the fused kernel alone (keys left as they are: the atomicMin
            # work is the same), then the wrapper as the main path calls it
            row["best_ms"] = cuda_ms(lambda: me_sad._launch(
                "best", src, ref.data_ptr(), src.data_ptr(),
                keys.data_ptr(), H, W, R, n, lam, shift, keys.element_size(),
                0), 50)
            row["best_route_ms"] = cuda_ms(
                lambda: me_sad.sad_sweep_best(ref, src, R, n, lam), 20)
            row["best_plain_ms"] = cuda_ms(
                lambda: me_sad.sad_sweep_best_plain(ref, src, R, n, lam), 2)
            row["best_bound_ms"], row["best_bound_by"] = k1_bound_ms(
                H, W, R, src.dtype, rate, n)
            row.update(n=n, lambda_bits=lam)
        emit(phase="k1", **row)
        rows[name] = row
    return rows, err


def phase_golden(dev, key: str, **kw):
    """The golden clip through the port's session on the card; its stream
    md5 must be the manifest's `key`."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    with open(os.path.join(REPO, "tests", "golden", "manifest.json")) as f:
        want = json.load(f)[key]
    sess = VideoEncoderSession(64, 48, keyint=100, hash_sei=False,
                               device=dev, **kw)
    out = sess.headers()
    for fr in golden_clip():
        out += sess.encode_frame(*fr).nals
    got = hashlib.md5(out).hexdigest()
    emit(phase="golden" if key == "ippp_cqp" else "golden_qt2", clip=key,
         md5=got, want=want, match=got == want)
    if got != want:
        raise AssertionError(f"golden {key} md5 {got} != {want}")


def push_all(sess, frames):
    """Every result of a B session over `frames` (push_frame, then
    flush), in coding order."""
    res = []
    for fr in frames:
        res += sess.push_frame(*fr)
    return res + sess.flush()


def phase_golden_qt2_b(dev):
    """The golden clip through the port's quadtree B session on the card;
    its stream md5 must be the JAX package's (GOLDEN_QT2_B_MD5)."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    sess = VideoEncoderSession(64, 48, qp=30, keyint=5, hash_sei=False,
                               device=dev, **B_KW)
    res = push_all(sess, golden_clip(n=8))
    got = hashlib.md5(sess.headers() + b"".join(r.nals for r in res)) \
        .hexdigest()
    emit(phase="golden_qt2_b", md5=got, want=GOLDEN_QT2_B_MD5,
         match=got == GOLDEN_QT2_B_MD5,
         frames=[[r.poc, r.frame_type] for r in res])
    if got != GOLDEN_QT2_B_MD5:
        raise AssertionError(f"golden qt2 B md5 {got} != {GOLDEN_QT2_B_MD5}")


def phase_qt2_cpu_vs_card(dev):
    """The quadtree IPPP and B sessions on a 416x240 clip, on the card and
    on the CPU: each pair of streams must be equal."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    for name, kw, n in (("ippp", {"max_depth": 2}, 3), ("b", B_KW, 5)):
        frames = synth_clip(n, 416, 240)
        md5, secs = {}, {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            sess = VideoEncoderSession(416, 240, qp=30, keyint=100,
                                       hash_sei=True, device=where, **kw)
            res = push_all(sess, frames) if sess.bframes else \
                [sess.encode_frame(*f) for f in frames]
            out = sess.headers() + b"".join(r.nals for r in res)
            md5[str(where)] = hashlib.md5(out).hexdigest()
            secs[str(where)] = time.perf_counter() - t0
        same = len(set(md5.values())) == 1
        emit(phase="qt2_cpu_vs_card", session=name, frames=n, md5=md5,
             seconds=secs, equal=same)
        if not same:
            raise AssertionError(f"416x240 quadtree {name} streams differ: "
                                 f"{md5}")


def _same_decisions(a: dict, b: dict) -> bool:
    def eq(x, y):
        if x is None or y is None:
            return x is None and y is None
        if isinstance(x, tuple):
            return all(torch.equal(p, q) for p, q in zip(x, y))
        return np.array_equal(x, y)
    return sorted(a) == sorted(b) and all(eq(a[k], b[k]) for k in a)


def phase_1080p(dev, name: str, max_depth: int, n_frames: int):
    """One main path at 1080p; returns its K1 launch counts."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    from x265_yuuki_asuna_tpu_torch.utils import geometry as G
    frames = synth_clip(n_frames, W1080, H1080)
    sess = VideoEncoderSession(W1080, H1080, qp=32, keyint=250,
                               hash_sei=True, max_depth=max_depth,
                               device=dev)
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, t_frames = [], []
    last_p = None
    me_sad.sad_block8_sweep.launches = 0          # the main path starts
    me_sad.sad_sweep_best.launches = 0
    for i, fr in enumerate(frames):
        if i == len(frames) - 1:
            last_p = (fr, sess.ref)
        t0 = time.perf_counter()
        r = sess.encode_frame(*fr)
        t_frames.append(time.perf_counter() - t0)
        results.append(r)
        total += len(r.nals)
    launches = {"sad_sweep_best": me_sad.sad_sweep_best.launches,
                "sad_block8_sweep": me_sad.sad_block8_sweep.launches}
    n_p = sum(r.frame_type == "P" for r in results)
    fps = (len(frames) - 1) / sum(t_frames[1:])
    psnr = [r.psnr_y for r in results]
    ok_out = all(np.isfinite(psnr)) and all(
        r.recon[0].shape == (H1080, W1080) for r in results) and \
        results[0].frame_type == "I" and n_p == len(frames) - 1
    # each stage's ms per frame that runs it: intra on I frames, inter on
    # P frames, lookahead and serialize on every frame
    runs = {"intra": len(frames) - n_p, "inter": n_p}
    emit(phase=name, max_depth=max_depth, frames=len(frames), p_frames=n_p,
         fps=fps, frame_ms=[t * 1e3 for t in t_frames],
         stage_ms_per_frame={k: v / max(runs.get(k, len(frames)), 1)
                             for k, v in sess.stage_ms.items()},
         bytes=total, psnr_y=psnr, qp=[r.qp for r in results],
         k1_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if not ok_out:
        raise AssertionError(f"{name} output malformed")
    if max_depth:        # lookahead: fused; ME: the multi-size surface
        want = {"sad_sweep_best": len(frames), "sad_block8_sweep": n_p}
    else:                # lookahead and ME both fused
        want = {"sad_sweep_best": len(frames) + n_p, "sad_block8_sweep": 0}
    if launches != want:
        raise AssertionError(f"{name}: K1 launches {launches} != {want}")
    # the last P frame again: kernel path vs plain path, same inputs
    (y, u, v), ref = last_p
    yp = G.pad_plane(y, sess.coded_h, sess.coded_w)
    up = G.pad_plane(u, sess.coded_h // 2, sess.coded_w // 2)
    vp = G.pad_plane(v, sess.coded_h // 2, sess.coded_w // 2)
    qp = results[-1].qp
    out_k = sess.inter_encoder.encode_frame(yp, up, vp, *ref, qp)
    with mock.patch.object(me_sad, "sad_block8_sweep",
                           me_sad.sad_block8_sweep_plain), \
            mock.patch.object(me_sad, "sad_sweep_best",
                              me_sad.sad_sweep_best_plain):
        out_p = sess.inter_encoder.encode_frame(yp, up, vp, *ref, qp)
    same = _same_decisions(out_k, out_p)
    emit(phase=f"{name}_p_frame_plain_rerun", identical=same)
    if not same:
        raise AssertionError(f"{name}: kernel and plain P-frame decisions "
                             "differ")
    return launches


def phase_1080p_b(dev):
    """The quadtree B path at 1080p through push_frame / flush; returns its
    K1 launch counts."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    name = "1080p_qt2_b"
    frames = synth_clip(QT_B_FRAMES, W1080, H1080)
    sess = VideoEncoderSession(W1080, H1080, qp=32, keyint=250,
                               hash_sei=True, device=dev, **B_KW)
    # record the inter program's calls, to rerun the last B frame
    enc = sess.inter_encoder
    calls, run = [], enc.encode_frame
    enc.encode_frame = lambda *a, **k: calls.append((a, k)) or run(*a, **k)
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, call_ms, per_call = [], [], []
    me_sad.sad_block8_sweep.launches = 0          # the main path starts
    me_sad.sad_sweep_best.launches = 0
    for fr in frames + [None]:
        t0 = time.perf_counter()
        got = sess.push_frame(*fr) if fr is not None else sess.flush()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append([[r.poc, r.frame_type] for r in got])
        results += got
    launches = {"sad_sweep_best": me_sad.sad_sweep_best.launches,
                "sad_block8_sweep": me_sad.sad_block8_sweep.launches}
    order = [(r.poc, r.frame_type) for r in results]
    total += sum(len(r.nals) for r in results)
    # frames after the IDR over the calls after the IDR's
    fps = (len(results) - 1) / (sum(call_ms[1:]) / 1e3)
    runs = {k: sum(r.frame_type in t for r in results)
            for k, t in (("intra", "I"), ("inter", "P"), ("inter_b", "Bb"),
                         ("serialize", "IPBb"))}
    runs["lookahead"] = len(frames)
    psnr = [r.psnr_y for r in results]
    emit(phase=name, max_depth=2, bframes=3, frames=len(results),
         fps=fps, call_ms=call_ms, call_frames=per_call,
         stage_ms_per_frame={k: v / max(runs[k], 1)
                             for k, v in sess.stage_ms.items()},
         bytes=total, frame_bytes=[len(r.nals) for r in results],
         psnr_y=psnr, qp=[r.qp for r in results], k1_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    want_order = [(0, "I"), (4, "P"), (2, "B"), (1, "b"), (3, "b")]
    if order != want_order or not all(np.isfinite(psnr)) or not all(
            r.recon[0].shape == (H1080, W1080) for r in results):
        raise AssertionError(f"{name} output malformed: {order}")
    want = {"sad_sweep_best": len(frames), "sad_block8_sweep": 1 + 2 * 3}
    if launches != want:
        raise AssertionError(f"{name}: K1 launches {launches} != {want}")
    # the last B frame again: kernel path vs plain path, same inputs
    a, k = calls[-1]
    if k.get("ref1") is None:
        raise AssertionError(f"{name}: the last inter call is not a B frame")
    out_k = run(*a, **k)
    with mock.patch.object(me_sad, "sad_block8_sweep",
                           me_sad.sad_block8_sweep_plain), \
            mock.patch.object(me_sad, "sad_sweep_best",
                              me_sad.sad_sweep_best_plain):
        out_p = run(*a, **k)
    same = _same_decisions(out_k, out_p)
    emit(phase=f"{name}_b_frame_plain_rerun", identical=same,
         pdir_counts={int(d): int(c) for d, c in zip(*np.unique(
             out_k["pdir8"], return_counts=True))})
    if not same:
        raise AssertionError(f"{name}: kernel and plain B-frame decisions "
                             "differ")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi, card = phase_build()
    k1, err = phase_k1(dev, card)
    phase_golden(dev, "ippp_cqp", qp=32, cu_size=16)
    phase_golden(dev, "qt2_ippp", qp=30, max_depth=2)
    phase_golden_qt2_b(dev)
    phase_qt2_cpu_vs_card(dev)
    by_path = {"1080p": phase_1080p(dev, "1080p", 0, FRAMES),
               "1080p_qt2": phase_1080p(dev, "1080p_qt2", 2, QT_FRAMES),
               "1080p_qt2_b": phase_1080p_b(dev)}
    launches = by_path["1080p_qt2_b"]
    me = k1["P-frame ME 1088x1920"]
    common = {"route": "cuda",
              "source": "x265_yuuki_asuna_tpu_torch/csrc/me_sad.cu",
              "replaces": "x265_yuuki_asuna_tpu/ops/pallas/me_sad.py:56",
              "max_abs_err": err, "library_ms": None}
    per_path = lambda k: {p: c[k] for p, c in by_path.items()}
    emit(kernels=[
        {"name": "sad_block8_sweep", **common,
         "launches": launches["sad_block8_sweep"],
         "launches_by_path": per_path("sad_block8_sweep"),
         "ms": me["surface_ms"], "plain_ms": me["surface_plain_ms"],
         "bound_ms": me["surface_bound_ms"],
         "bound_by": me["surface_bound_by"]},
        {"name": "sad_sweep_best", **common,
         "launches": launches["sad_sweep_best"],
         "launches_by_path": per_path("sad_sweep_best"),
         "ms": me["best_ms"], "plain_ms": me["best_plain_ms"],
         "bound_ms": me["best_bound_ms"], "bound_by": me["best_bound_by"]}])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
