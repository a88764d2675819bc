"""Command-line encoder (reference analog: source/x265.cpp + x265cli.cpp).

Usage:
    python -m x265_yuuki_asuna_tpu_torch.cli in.y4m -o out.hevc --preset superfast
    python -m x265_yuuki_asuna_tpu_torch.cli in.yuv --input-res WxH --fps 25 -o out.hevc

Port of x265_yuuki_asuna_tpu/cli.py `main`: the same flags, the preset and
tune resolution through utils/param.py, and the same sessions (the
all-intra session for --keyint 1 under CQP, else the video session; x265's
default CTU 64 / minimum CU 8 becomes the CTU32 depth-2 quadtree,
ultrafast's CTU 32 / minimum CU 16 the depth-1 one, and a minimum CU equal
to a CTU of 16 or 32 the uniform grid of that CU size; --lossless,
--slices and --wpp put the all-intra session on the uniform grid of
--ctu, at most 32, 16 by default), on the CUDA card (main(argv,
device="cpu") runs every kernel's plain version). Every preset runs, the
default (medium) and veryfast through placebo with weighted prediction,
on 8-, 10- and 12-bit y4m input, with the all-intra stream options
(--lossless, --slices, --wpp, --scaling-lists), --hash 1 / 2 / 3 and
the P-frame options of the uniform grid (--ref 2 and --tmvp without B
frames, --max-merge, --frame-dup with --dup-threshold), and every
all-intra option: 4:4:4 input (all-intra under CQP on the CTU16 grid,
no loop filters, as in the reference), --nr-intra and --ctu 64 with
--keyint 1 (the CTU64 quadtree, depth 2 or 3); as in the reference,
--wpp is an all-intra option (off CTU64) and --ref 2 falls back to one
reference with B frames, the quadtree or weighted prediction. --rqt
splits inter CU32 TUs on the quadtree; --analysis-save / --analysis-load
(with --scale-factor) put the session on the uniform IPPP grid of --ctu
(16 by default: no quadtree, B frames or weighted prediction, as in the
reference); --ladder WxH:kbps[,...] codes every rung of an ABR ladder in
one pass (models/ladder.py), one output per rung named
{stem}_{W}x{H}.{ext}; --dhdr10-info adds each frame's HDR10+ SEI and
--dolby-vision-rpu one Dolby Vision RPU NAL per frame (the last one
repeated); --recon-y4m-exec pipes the recon as y4m into a command;
--devices N (2 or more) codes P-chains across N pipeline slots
(parallel/session.PipelinedEncoder: CQP or, with --bitrate, per-chain
ABR, CTU16, no loop filters), each slot a stream, round-robin over the
cards. Frames are read ahead on a thread (utils/io.PrefetchReader).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .bitstream import sei as SEI
from .bitstream.bitio import parse_annexb_nals, wrap_nal
from .models.encoder_top import IntraEncoderSession, VideoEncoderSession
from .models.ladder import LadderEncoder, parse_ladder
from .utils import io as IO
from .utils import param as P

_PRIM = {'bt709': 1, 'unknown': 2, 'bt470m': 4, 'bt470bg': 5, 'smpte170m': 6,
         'smpte240m': 7, 'film': 8, 'bt2020': 9, 'smpte428': 10,
         'smpte431': 11, 'smpte432': 12}
_TRC = {'bt709': 1, 'unknown': 2, 'bt470m': 4, 'bt470bg': 5, 'smpte170m': 6,
        'smpte240m': 7, 'linear': 8, 'log100': 9, 'log316': 10,
        'iec61966-2-4': 11, 'bt1361e': 12, 'iec61966-2-1': 13,
        'bt2020-10': 14, 'bt2020-12': 15, 'smpte2084': 16, 'smpte428': 17,
        'arib-std-b67': 18}
_MAT = {'gbr': 0, 'bt709': 1, 'unknown': 2, 'fcc': 4, 'bt470bg': 5,
        'smpte170m': 6, 'smpte240m': 7, 'ycgco': 8, 'bt2020nc': 9,
        'bt2020c': 10, 'smpte2085': 11, 'chroma-derived-nc': 12,
        'chroma-derived-c': 13, 'ictcp': 14}

def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="x265-cuda", add_help=True)
    ap.add_argument("input", help="input .y4m or raw .yuv")
    ap.add_argument("-o", "--output", required=True,
                    help="output Annex-B .hevc")
    ap.add_argument("--input-res", default=None, help="WxH (raw yuv input)")
    ap.add_argument("--fps", default="25")
    ap.add_argument("--qp", type=int, default=None)
    ap.add_argument("--ctu", type=int, default=None, choices=[16, 32, 64])
    ap.add_argument("--min-cu-size", type=int, default=None,
                    choices=[0, 8, 16, 32],
                    help="min CU size; < --ctu enables quadtree RDO")
    ap.add_argument("--frames", "-f", type=int, default=0, help="max frames")
    ap.add_argument("--preset", default="medium")
    ap.add_argument("--tune", default=None,
                    help="psnr|ssim|grain|fastdecode|zerolatency|animation")
    ap.add_argument("--recon", default=None, help="write recon yuv")
    ap.add_argument("--no-hash", action="store_true", help="skip hash SEI")
    ap.add_argument("--scaling-lists", default=None,
                    help="'default' (spec matrices) or scaling list file")
    ap.add_argument("--nr-intra", type=int, default=0,
                    help="intra noise reduction strength 0..2000")
    ap.add_argument("--hash", type=int, default=1, choices=[1, 2, 3],
                    help="decoded picture hash: 1=MD5 2=CRC 3=checksum")
    ap.add_argument("--frame-batch", type=int, default=4,
                    help="frames encoded per device batch (all-intra)")
    ap.add_argument("--keyint", type=int, default=None,
                    help="GOP length: 0/1 = all-intra, N>1 = IDR every N")
    ap.add_argument("--merange", type=int, default=16,
                    help="ME search range")
    ap.add_argument("--ref", type=int, default=1, choices=[1, 2],
                    help="L0 references (2: multi-ref IPPP sessions)")
    ap.add_argument("--tmvp", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="temporal MVP (uniform IPPP sessions)")
    ap.add_argument("--b-intra", dest="b_intra",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="evaluate intra modes in B slices (reference "
                         "bIntraInBFrames)")
    ap.add_argument("--rqt", action="store_true",
                    help="residual TU quadtree on inter CTU32 leaves "
                         "(quadtree sessions)")
    ap.add_argument("--hrd", action="store_true",
                    help="HRD signaling (needs --vbv-maxrate/bufsize)")
    ap.add_argument("--frame-dup", action="store_true",
                    help="encode near-identical frames as all-skip "
                         "P slices (IPPP sessions)")
    ap.add_argument("--dup-threshold", type=int, default=70,
                    help="PSNR (dB) above which a frame is a duplicate")
    ap.add_argument("--hist-scenecut", action="store_true",
                    help="histogram-based scene cut detection")
    ap.add_argument("--scenecut-aware-qp", action="store_true",
                    help="raise QP in the masked window after cuts")
    ap.add_argument("--qpmin", type=int, default=4,
                    help="rate-control QP floor")
    ap.add_argument("--qpmax", type=int, default=51,
                    help="rate-control QP ceiling")
    ap.add_argument("--max-merge", type=int, default=3,
                    choices=[1, 2, 3, 4, 5], help="max merge candidates")
    ap.add_argument("--b-adapt", type=int, default=None, choices=[0, 1, 2],
                    help="adaptive B placement: 0 fixed, 1 fast, 2 full")
    ap.add_argument("--no-preset-defaults", action="store_true",
                    help="all-intra CQP32 unless flags given")
    ap.add_argument("--open-gop", action=argparse.BooleanOptionalAction,
                    default=None, help="CRA keyframes with RASL leading "
                                       "pictures (reference --open-gop)")
    ap.add_argument("--bframes", type=int, default=None,
                    help="max consecutive B frames (mini-GOP size - 1)")
    ap.add_argument("--rdoq-level", type=int, default=None, choices=(0, 1),
                    help="rate-distortion optimized quantization")
    ap.add_argument("--wpp", action="store_true",
                    help="wavefront parallel processing (entry points)")
    ap.add_argument("--weightp", action=argparse.BooleanOptionalAction,
                    default=None, help="weighted prediction for P slices")
    ap.add_argument("--signhide", action=argparse.BooleanOptionalAction,
                    default=None, help="sign-bit hiding")
    ap.add_argument("--colorprim", default=None, choices=list(_PRIM))
    ap.add_argument("--transfer", default=None, choices=list(_TRC))
    ap.add_argument("--colormatrix", default=None, choices=list(_MAT))
    ap.add_argument("--range", default=None, choices=["limited", "full"])
    ap.add_argument("--chromaloc", type=int, default=None,
                    choices=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--master-display", default=None,
                    help="HDR10 mastering display: "
                         "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)")
    ap.add_argument("--max-cll", default=None, help="HDR10 MaxCLL,MaxFALL")
    ap.add_argument("--dhdr10-info", default=None,
                    help="HDR10+ dynamic metadata JSON (per-frame T.35 SEI)")
    ap.add_argument("--dolby-vision-rpu", default=None,
                    help="Dolby Vision RPU file (Annex-B NALs, one per "
                         "frame) injected as NAL 62 per access unit")
    ap.add_argument("--recon-y4m-exec", default=None,
                    help="pipe recon as y4m into this command's stdin "
                         "(reference reconplay)")
    ap.add_argument("--rc-lookahead", type=int, default=None,
                    help="lookahead window (frames) for cuTree backward "
                         "propagation (reference --rc-lookahead)")
    ap.add_argument("--cutree", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="lookahead cost propagation -> per-CU QP offsets")
    ap.add_argument("--analysis-save", default=None,
                    help="save per-CU analysis for reuse")
    ap.add_argument("--analysis-load", default=None,
                    help="reuse saved analysis (skip full motion search)")
    ap.add_argument("--scale-factor", type=int, default=1, choices=[1, 2, 4],
                    help="upscale loaded analysis from a 1/N-resolution "
                         "pass (cross-resolution reuse)")
    ap.add_argument("--zones", default=None,
                    help="per-range overrides: start,end,q=N|b=M[/...]")
    ap.add_argument("--devices", type=int, default=0,
                    help="pipelined encode: P-chains across N slots (a "
                    "stream each, round-robin over the cards; CQP, CTU16, "
                    "no loop filters)")
    ap.add_argument("--ladder", default=None,
                    help="ABR ladder: WxH:kbps[,WxH:kbps...] -> per-rung "
                         "outputs suffixed _WxH")
    ap.add_argument("--vbv-maxrate", type=int, default=0,
                    help="VBV max rate (kbit/s)")
    ap.add_argument("--vbv-bufsize", type=int, default=0,
                    help="VBV buffer size (kbit)")
    ap.add_argument("--crf", type=float, default=None,
                    help="CRF rate control")
    ap.add_argument("--bitrate", type=int, default=None,
                    help="ABR bitrate (kbps)")
    ap.add_argument("--lossless", action="store_true")
    ap.add_argument("--sao", action=argparse.BooleanOptionalAction,
                    default=None, help="sample adaptive offset")
    ap.add_argument("--deblock", action=argparse.BooleanOptionalAction,
                    default=None, help="deblocking filter")
    ap.add_argument("--aq-mode", type=int, default=None,
                    choices=[0, 1, 2, 3, 4])
    ap.add_argument("--psy-rdoq", type=float, default=None,
                    help="psy-RDOQ strength (needs --rdoq-level)")
    ap.add_argument("--psy-rd", type=float, default=None,
                    help="psycho-visual RD strength (quadtree sessions)")
    ap.add_argument("--aq-strength", type=float, default=1.0)
    ap.add_argument("--slices", type=int, default=1,
                    help="independent slice bands per frame (intra)")
    ap.add_argument("--pass", dest="rc_pass", type=int, default=0,
                    choices=[0, 1, 2])
    ap.add_argument("--stats", default="x265_2pass.log")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--csv-log-level", type=int, default=1, choices=[1, 2],
                    help="2: append per-frame stage timings (device, "
                         "filters, serialize ms)")
    ap.add_argument("--qpfile", default=None,
                    help="per-frame QP/type overrides: "
                         "'<frame> <type> <qp>'")
    ap.add_argument("--chunk-start", type=int, default=0,
                    help="first source frame to encode (job splitting)")
    ap.add_argument("--chunk-end", type=int, default=0,
                    help="last source frame to encode (0 = end of input)")
    return ap


def _csv_line(n: int, fr, qp: int) -> str:
    return (f"{n}, {fr.frame_type or 'I'}, {fr.poc}, {fr.qp or qp}, "
            f"{fr.bits}, {fr.psnr_y:.4f}, {fr.psnr_u:.4f}, "
            f"{fr.psnr_v:.4f}, {fr.ssim_y:.5f}")


def configure(args, prm, info, device=None):
    """The session the command line asks for (args: _parser()'s
    namespace, prm: the Param of its preset, tune and extra options,
    info: the input's VideoInfo): the all-intra session for --keyint 1
    under CQP without B frames, else the video session; resolves the
    preset's defaults as the reference CLI does (the preset configures
    everything, explicit flags override) and updates args.qp,
    args.keyint, args.crf and args.frame_batch to what they resolve
    to."""
    csp_name = "i444" if info.csp == P.CSP_I444 else "i420"

    def pick(flag_val, preset_val):
        return preset_val if flag_val is None else flag_val

    if args.no_preset_defaults:
        keyint = args.keyint or 0
        bframes = args.bframes or 0
        weightp = bool(args.weightp)
        sao = bool(args.sao)
        deblock = bool(args.deblock)
        aq_mode = args.aq_mode or 0
        cutree = bool(args.cutree)
        rdoq_level = args.rdoq_level or 0
        psy_rd = args.psy_rd or 0.0
        sbh = bool(args.signhide)
        qp = 32 if args.qp is None else args.qp
        ctu = args.ctu or 16
        min_cu = args.min_cu_size or 0
        rc_mode = "crf" if args.crf is not None else (
            "abr" if args.bitrate else "cqp")
    else:
        keyint = pick(args.keyint, prm.keyframe_max)
        bframes = pick(args.bframes, prm.bframes)
        weightp = bool(pick(args.weightp, prm.b_enable_weighted_pred))
        sao = bool(pick(args.sao, prm.b_enable_sao))
        deblock = bool(pick(args.deblock, prm.b_enable_loop_filter))
        aq_mode = pick(args.aq_mode, prm.rc.aq_mode)
        cutree = bool(pick(args.cutree, prm.rc.cu_tree))
        rdoq_level = pick(args.rdoq_level, min(prm.rdoq_level, 1))
        psy_rd = float(pick(args.psy_rd, prm.psy_rd))
        sbh = bool(pick(args.signhide, prm.b_enable_sign_hiding))
        ctu = pick(args.ctu, min(prm.max_cu_size, 32))
        min_cu = pick(args.min_cu_size, max(prm.min_cu_size, 8))
        if args.qp is not None:
            rc_mode, qp = "cqp", args.qp
        elif args.bitrate:
            rc_mode, qp = "abr", 32
        else:
            rc_mode, qp = "crf", 32
            if args.crf is None:
                args.crf = float(prm.rc.rf_constant)
    if args.lossless:
        keyint, bframes, rc_mode = 0, 0, "cqp"
        qp = 32 if args.qp is None else args.qp
    if args.keyint is not None and args.keyint <= 1:
        keyint, bframes = 0, 0        # --keyint 1 = all-intra (reference)
    if csp_name == "i444":
        # 4:4:4 is the all-intra CTU16 path (the reference's choice)
        keyint, bframes = 0, 0
        args.vbv_maxrate = 0
        rc_mode = "cqp"
        deblock = sao = False
        ctu = 16
    qt_depth = 0
    if min_cu and ctu and min_cu < ctu:
        qt_depth = ctu.bit_length() - min_cu.bit_length()
    args.qp = qp
    if args.keyint is None:
        args.keyint = keyint
    psy_rdoq = args.psy_rdoq if args.psy_rdoq is not None else prm.psy_rdoq
    if keyint > 1 or rc_mode != "cqp" or bframes or args.vbv_maxrate:
        if args.analysis_save or args.analysis_load:
            qt_depth, bframes, weightp = 0, 0, False
            ctu = args.ctu or 16
        if ctu == 64:            # inter quadtree is CTU32 (CTU64 = intra)
            ctu, qt_depth = 32, min(qt_depth, 2)
        args.frame_batch = 1     # P frames are sequentially dependent
        return VideoEncoderSession(
            info.width, info.height, qp=qp, cu_size=ctu,
            bit_depth=info.bit_depth, max_depth=qt_depth,
            n_refs=(args.ref if not (bframes or qt_depth or weightp)
                    else 1),
            tmvp=args.tmvp, rqt=args.rqt and qt_depth > 0, hrd=args.hrd,
            frame_dup=args.frame_dup, dup_threshold=args.dup_threshold,
            hist_scenecut=args.hist_scenecut,
            scenecut_aware_qp=args.scenecut_aware_qp,
            hme=args.merange > 16 and qt_depth > 0,
            hme_range=min(max(args.merange // 2, 16), 32),
            fps=(info.fps_num, info.fps_denom),
            keyint=max(keyint, 2) if keyint > 1 else 250,
            search_range=min(args.merange, 16),
            qp_min=args.qpmin, qp_max=args.qpmax,
            max_merge=args.max_merge,
            b_adapt=(args.b_adapt if args.b_adapt is not None
                     else min(prm.b_frame_adaptive, 2)),
            hash_sei=not args.no_hash, hash_type=args.hash - 1,
            rc_mode=rc_mode,
            crf=args.crf if args.crf is not None else 28.0,
            bitrate_kbps=args.bitrate or 0,
            stats_write=args.stats if args.rc_pass == 1 else None,
            stats_read=args.stats if args.rc_pass == 2 else None,
            bframes=bframes, deblock=deblock, sao=sao,
            vbv_maxrate_kbps=args.vbv_maxrate,
            vbv_bufsize_kbps=args.vbv_bufsize,
            rdoq=rdoq_level > 0, weightp=weightp, sbh=sbh, zones=args.zones,
            analysis_save=args.analysis_save,
            analysis_load=args.analysis_load,
            scale_factor=args.scale_factor, aq_mode=aq_mode,
            aq_strength=args.aq_strength,
            open_gop=bool(pick(args.open_gop, prm.b_open_gop)),
            cutree=cutree, psy_rd=psy_rd,
            rc_lookahead=(args.rc_lookahead if args.rc_lookahead is not None
                          else (prm.lookahead_depth if cutree and not bframes
                                else 0)),
            psy_rdoq=psy_rdoq,
            b_intra=bool(pick(args.b_intra, prm.b_intra_in_bframes)),
            device=device)
    if args.lossless or args.slices > 1 or args.wpp:
        qt_depth = 0
        ctu = min(args.ctu or 16, 32)
    if ctu == 64:
        qt_depth = max(2, min(qt_depth, 3))
    return IntraEncoderSession(
        info.width, info.height, qp=qp, cu_size=ctu,
        bit_depth=info.bit_depth, fps=(info.fps_num, info.fps_denom),
        hash_sei=not args.no_hash, hash_type=args.hash - 1,
        nr_intra=args.nr_intra, scaling_lists=args.scaling_lists,
        lossless=args.lossless, sao=sao, deblock=deblock,
        aq_mode=aq_mode, aq_strength=args.aq_strength,
        slices=args.slices, rdoq=rdoq_level > 0, wpp=args.wpp, sbh=sbh,
        master_display=args.master_display, max_cll=args.max_cll,
        csp=csp_name, max_depth=qt_depth if csp_name == "i420" else 0,
        psy_rd=psy_rd, psy_rdoq=psy_rdoq, device=device)


def add_metadata(sess, args) -> None:
    """The per-frame metadata of the command line through the session's
    sei_provider: --dhdr10-info's HDR10+ SEI (when its JSON has
    records), then --dolby-vision-rpu's RPU NALs (when its file holds
    any), one UNSPEC62 NAL per frame, the last one repeated."""
    if args.dhdr10_info:
        recs = SEI.load_hdr10plus_json(args.dhdr10_info)
        if recs:
            sess.sei_provider = (
                lambda idx: SEI.hdr10plus_sei_for_frame(recs, idx))
    if args.dolby_vision_rpu:
        with open(args.dolby_vision_rpu, "rb") as f:
            rpus = parse_annexb_nals(f.read())
        if rpus:
            prev = sess.sei_provider

            def dovi(idx):
                head = prev(idx) if prev else b""
                return head + wrap_nal(62, rpus[min(idx, len(rpus) - 1)])
            sess.sei_provider = dovi


def _run_ladder(args, reader, device=None) -> int:
    """--ladder: one pass over the source, every rung scaled and coded
    (LadderEncoder with the hand-off; --qp, 32 by default, for a rung
    without a bitrate), each rung's stream in {stem}_{W}x{H}.{ext}. As in
    the reference, --keyint must be given (keyint > 1 is compared
    first: without it, TypeError)."""
    info = reader.info
    rungs = parse_ladder(args.ladder)
    lad = LadderEncoder(info.width, info.height, rungs,
                        fps=(info.fps_num, info.fps_denom),
                        qp=32 if args.qp is None else args.qp,
                        keyint=max(args.keyint, 2) if args.keyint > 1
                        else 250, hash_sei=not args.no_hash, device=device)
    stem, _, ext = args.output.rpartition(".")
    outs = [IO.RawBitstreamWriter(f"{stem}_{r.width}x{r.height}.{ext}")
            for r in rungs]
    for w, hdr in zip(outs, lad.headers()):
        w.write(hdr)
    n = 0
    t0 = time.time()
    frames = IO.PrefetchReader(reader)
    for y, u, v in frames:
        for w, fr in zip(outs, lad.encode_frame(y, u, v)):
            w.write(fr.nals)
        n += 1
        if args.frames and n >= args.frames:
            break
    frames.close()
    for w in outs:
        w.close()
    print(f"\nladder: {n} frames x {len(rungs)} rungs in "
          f"{time.time() - t0:.2f}s", file=sys.stderr)
    return 0


def _run_pipeline(args, reader, device=None) -> int:
    """--devices N: the frame pipeline across N slots
    (parallel/session.PipelinedEncoder), as the reference's: --qp (32 by
    default), per-chain ABR with --bitrate, --frames; no hash SEI, and
    the flags of the other paths are not read. Reads the input through
    PrefetchReader (the reference iterates its reader, which its readers
    do not support: ROADMAP Queue 3)."""
    from .parallel.session import PipelinedEncoder
    info = reader.info
    enc = PipelinedEncoder(
        info.width, info.height, qp=32 if args.qp is None else args.qp,
        n_devices=args.devices, fps=(info.fps_num, info.fps_denom),
        rc_mode="abr" if args.bitrate else "cqp",
        bitrate_kbps=args.bitrate or 0, device=device)
    frames = []
    src = IO.PrefetchReader(reader)
    for f in src:
        frames.append(f)
        if args.frames and len(frames) >= args.frames:
            break
    src.close()
    t0 = time.time()
    results = enc.encode_clip(frames)
    out = IO.RawBitstreamWriter(args.output)
    out.write(enc.headers())
    total_bits = 0
    for fr in results:
        out.write(fr.nals)
        total_bits += fr.bits
    out.close()
    el = time.time() - t0
    kbps = total_bits * info.fps_num / max(
        len(results) * info.fps_denom, 1) / 1000
    print(f"\nencoded {len(results)} frames on {enc.n} devices in "
          f"{el:.2f}s ({len(results) / max(el, 1e-9):.2f} fps), "
          f"{kbps:.2f} kb/s", file=sys.stderr)
    return 0


def parse(argv):
    """(args, Param) of a command line: the flags, then the Param of its
    preset and tune with the unknown "--name=value" options applied
    through param_parse (ParamError for a bad one)."""
    args, extra = _parser().parse_known_args(argv)
    prm = P.param_default_preset(args.preset, args.tune)
    for opt in extra:
        if not opt.startswith("--"):
            raise P.ParamError(f"unknown arg {opt}")
        name, _, val = opt[2:].partition("=")
        P.param_parse(prm, name, val if val else None)
    return args, prm


def main(argv=None, device=None):
    """Encode one input as the reference CLI does; returns the exit code.
    device: None runs the sessions on the CUDA card (and fails without
    one); "cpu" runs every kernel's plain PyTorch version."""
    try:
        args, prm = parse(argv)
    except P.ParamError as e:
        print(f"x265-cuda: {e}", file=sys.stderr)
        return 1

    try:
        if args.input.endswith(".y4m"):
            reader = IO.open_input(args.input)
        else:
            if not args.input_res:
                print("raw yuv input needs --input-res WxH", file=sys.stderr)
                return 1
            w, h = (int(x) for x in args.input_res.lower().split("x"))
            fps = args.fps
            num, den = (int(x) for x in fps.split("/")) if "/" in fps \
                else (int(float(fps)), 1)
            reader = IO.open_input(args.input, w, h, (num, den))
    except (OSError, ValueError) as e:
        print(f"x265-cuda: cannot open input: {e}", file=sys.stderr)
        return 1
    info = reader.info
    if args.ladder:
        return _run_ladder(args, reader, device)
    if args.devices and args.devices >= 2:
        return _run_pipeline(args, reader, device)
    if info.csp not in (P.CSP_I420, P.CSP_I444):
        print("x265-cuda: only 4:2:0 and 4:4:4 inputs supported",
              file=sys.stderr)
        return 1
    sess = configure(args, prm, info, device)
    add_metadata(sess, args)
    qpfile = {}
    if args.qpfile:
        # reference --qpfile format: "<frameNumber> <frameType> <QP>"
        try:
            with open(args.qpfile) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        fno = int(parts[0])
                        ftype = parts[1].upper()
                        fqp = int(parts[2]) if len(parts) > 2 else -1
                        qpfile[fno] = (ftype, fqp)
        except (OSError, ValueError) as e:
            print(f"x265-cuda: bad qpfile: {e}", file=sys.stderr)
            return 1
    if args.colorprim or args.transfer or args.colormatrix:
        sess.sps.colour_description = (
            _PRIM.get(args.colorprim, 2), _TRC.get(args.transfer, 2),
            _MAT.get(args.colormatrix, 2))
    if args.range == "full":
        sess.sps.video_full_range = 1
    if args.chromaloc is not None:
        sess.sps.chroma_loc = args.chromaloc
    out = IO.RawBitstreamWriter(args.output)
    out.write(sess.headers())
    recon_writer = IO.YUVWriter(args.recon) if args.recon else None
    recon_play = IO.ReconPlay(args.recon_y4m_exec, info) \
        if args.recon_y4m_exec else None

    csv_header = ("Encode Order, Type, POC, QP, Bits, PSNR Y, PSNR U, "
                  "PSNR V, SSIM Y")
    csv_timing = args.csv and args.csv_log_level >= 2
    stage_prev = {}
    if csv_timing:
        csv_header += ", Device ms, Deblock ms, SAO ms, Serialize ms"

    def stage_ms():
        """The session's stage ms since the last call, in the reference's
        columns: the programs (device work and its launches, with the
        device-DPB filter chain that runs inside them), the host-form
        deblock, the host-form SAO, the writer."""
        cur = dict(sess.stage_ms)
        vals = [sum(cur.get(k, 0.0) - stage_prev.get(k, 0.0) for k in keys)
                for keys in (("intra", "inter", "inter_b", "filters"),
                             ("deblock",), ("sao",), ("serialize",))]
        stage_prev.clear()
        stage_prev.update(cur)
        return [round(v, 1) for v in vals]

    csv_lines = [csv_header] if args.csv else None
    psnr_acc = []  # (psnr_y, psnr_u, psnr_v, ssim)
    n = 0
    total_bits = 0
    t0 = time.time()
    pending = []
    use_bframes = getattr(sess, "bframes", 0) > 0

    def record(fr):
        """One frame's recon, CSV line and quality, in display order."""
        nonlocal n
        if recon_writer:
            recon_writer.write_frame(*fr.recon)
        if recon_play:
            recon_play.write_frame(*fr.recon)
        if csv_lines is not None:
            line = _csv_line(n, fr, args.qp)
            if csv_timing:
                line += ", " + ", ".join(str(v) for v in stage_ms())
            csv_lines.append(line)
        if fr.psnr_y:
            psnr_acc.append((fr.psnr_y, fr.psnr_u, fr.psnr_v, fr.ssim_y))
        n += 1

    def emit(results):
        """Results of B sessions: the stream in coding order; recon and
        stats in display order, each burst a contiguous display range (an
        IDR, POC 0, starts a new GOP segment)."""
        nonlocal total_bits
        for fr in results:
            out.write(fr.nals)
            total_bits += fr.bits
        segments, cur = [], []
        for fr in results:
            if fr.poc == 0 and cur:
                segments.append(cur)
                cur = []
            cur.append(fr)
        segments.append(cur)
        for seg in segments:
            for fr in sorted(seg, key=lambda f: f.poc):
                record(fr)

    def write_in_order(results):
        nonlocal total_bits
        for fr in results:
            out.write(fr.nals)
            total_bits += fr.bits
            record(fr)

    def flush_batch():
        if not pending:
            return
        if use_bframes:
            for f in pending:
                emit(sess.push_frame(*f))
            pending.clear()
            return
        if getattr(sess, "la_depth", 0):
            results = [fr for f in pending for fr in sess.push_la(*f)]
        elif len(pending) > 1 and hasattr(sess, "encode_batch"):
            results = sess.encode_batch(
                pending, need_recon=bool(recon_writer or csv_lines
                                         or recon_play))
        else:
            results = [sess.encode_frame(*f) for f in pending]
        write_in_order(results)
        pending.clear()
        elapsed = time.time() - t0
        print(f"\r[{n} frames, {n / max(elapsed, 1e-9):.2f} fps, "
              f"{total_bits * info.fps_num / max(n * info.fps_denom, 1) / 1000:.2f} kb/s]",
              end="", file=sys.stderr)

    seen = 0
    src_idx = -1
    frames = IO.PrefetchReader(reader)
    for frame in frames:
        src_idx += 1
        if src_idx < args.chunk_start:
            continue              # reference --chunk-start lead-in skip
        if args.chunk_end and src_idx > args.chunk_end:
            break
        if qpfile:
            ov = qpfile.get(src_idx)
            if ov is not None:
                ftype, fqp = ov
                if ftype in ("I", "K") and hasattr(sess, "intra_refresh"):
                    sess.intra_refresh()
                if fqp >= 0 and hasattr(sess, "rc"):
                    sess.rc.cfg.qp = fqp
                    sess.qp = fqp
        pending.append(frame)
        seen += 1
        if len(pending) >= max(args.frame_batch, 1):
            flush_batch()
        if args.frames and seen >= args.frames:
            break
    frames.close()
    flush_batch()
    if use_bframes:
        emit(sess.flush())       # close the tail mini-GOP
    elif getattr(sess, "la_depth", 0):
        # drain the lookahead window through the same per-frame writer
        write_in_order(sess.flush_la())
    elapsed = time.time() - t0
    print(f"\nencoded {n} frames in {elapsed:.2f}s "
          f"({n / max(elapsed, 1e-9):.2f} fps), "
          f"{total_bits * info.fps_num / max(n * info.fps_denom, 1) / 1000:.2f} kb/s",
          file=sys.stderr)
    out.close()
    if recon_writer:
        recon_writer.close()
    if recon_play:
        recon_play.close()
    if args.csv:
        # summary row (reference CSV encode-summary analog)
        if n:
            kbps = total_bits * (info.fps_num
                                 / max(info.fps_denom, 1)) / n / 1000.0
            if psnr_acc:
                g = np.mean(np.asarray(psnr_acc), axis=0)
                csv_lines.append(
                    f"Summary, frames={n}, kbps={kbps:.2f}, "
                    f"Global PSNR Y={g[0]:.4f}, U={g[1]:.4f}, V={g[2]:.4f}, "
                    f"SSIM Y={g[3]:.5f}")
            else:
                csv_lines.append(f"Summary, frames={n}, kbps={kbps:.2f}")
        with open(args.csv, "w") as f:
            f.write("\n".join(csv_lines) + "\n")
    if getattr(sess, "stats_writer", None) is not None:
        sess.stats_writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
