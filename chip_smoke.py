"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--workers N]

Phases 1 and 2 run in this process with the card to themselves. The
phases after them (JOBS) run on a pool of N worker processes (default 4)
that share the card, each taking the next phase when it finishes one: the
paths are launch-bound on the host, so four processes keep the card busier
without slowing each other much, and the script ends well inside its time
limit. Each phase runs whole in one process, with its K1 counts set to 0
just before its main path and read just after. The parent prints every
JSON line as it arrives; phases from different workers interleave, and
the times a phase reports are taken while other phases run (--workers 1
runs everything in this process, one phase after another, for a clean
measurement). A failed phase stops every worker and fails the run.

Phases, each printing one JSON line (any failure raises and exits nonzero):
  1. the card's name, power limit and maximum SM clock (nvidia-smi); build
     every native library of the port (K1 and the intra commit with nvcc
     for sm_90a, the CABAC writer with g++), all compilers started
     together; the two CUDA libraries' -Xptxas -v summaries;
  2. K1's three entry points against their plain PyTorch versions on the
     card, exactly equal: the surface kernel (sad_block8_sweep), the 4x4
     surface (sad_block4_sweep: HME's coarse sweep, at 544x960 uint8 and
     int32, 24x32, int16, and a flat plane whose answer must be (-R, -R)
     at lambda 0 and (0, 0) at lambda 2 for the sizes 4, 8 and 16) and the
     fused sweep-and-argmin kernel (sad_sweep_best, n = 8 and 16) at the
     main paths' shapes (lookahead 544x960 n=8, P-frame ME 1088x1920 uint8:
     the uniform path's n=16 and the quadtree's surface), at 24x32 and
     32x48 with R=16 (range larger than the plane), on a flat plane with
     lambda_bits=0 (every cost ties: the answer must be (-R, -R)), in
     uint8, int16 and int32, and at the library's R=24 (1088x1920, 24x32,
     the flat plane); then, at the main paths' shapes (and the surface at
     R=24), each
     kernel's time (CUDA events, after warm-up), its plain version's time
     and its bound, and the whole sweep as the main path pays it: the
     surface route (surface kernel + PyTorch tail) against the fused
     route; k1_int16: the three entry points on the int16 planes of the
     10- and 12-bit path (the fused keys sized from the samples' peak:
     32 bits, 64 at R = 24 and 12 bits) against their plain versions,
     with each one's time, plain time and bound at the main paths'
     shapes; k1_n32: the fused sweep at n = 32 (the uniform CTU32 grid's
     ME) at 1088x1920 in uint8 and in int16 at 10 and 12 bits (keys of
     29, 31 and 33 bits: int32, int32, int64), a 64x96 crop at lambda 0,
     1 and 2 and a flat plane, each equal to its plain version, with its
     time, plain time and bound in uint8 and at 10 bits;
  3. the golden clips through the port's sessions on the card: the IPPP
     CQP stream md5 must equal tests/golden/manifest.json["ippp_cqp"]
     (golden), the CTU32 depth-2 quadtree stream its "qt2_ippp"
     (golden_qt2), and the quadtree B session (bframes=3, B-pyramid,
     b_adapt=0, keyint 5, 8 frames through push_frame / flush) the JAX
     package's md5 pinned below (golden_qt2_b);
     golden_lf: the same clips with the in-loop filters on (deblock=True,
     sao=True): the uniform IPPP stream against the manifest's
     "ippp_deblock_sao", and with the hash SEI on (so every filtered recon
     is held) the uniform, quadtree IPPP and quadtree B streams against
     the JAX package's md5s pinned below (LF_PINS);
     golden_intra: the five golden intra streams of the manifest
     (intra_cqp_ctu16, intra_qp26_deblock, intra_sao, intra_sbh,
     intra_rdoq) through the port's IntraEncoderSession;
  4. qt2_cpu_vs_card: the quadtree IPPP session (3 frames) and the
     quadtree B session (5 frames: I, P, B, b, b) on a 416x240 synthetic
     clip, on the card and with device="cpu": equal stream md5s;
     lf_cpu_vs_card: the B session again with both filters on;
     intra_cpu_vs_card: the quadtree intra session with sign hiding and
     both filters, and the uniform intra session with RDOQ (2 frames
     each);
     golden_aq: the adaptive-quantization / cuTree goldens of the
     manifest (intra_aq2, ippp_aq_cutree, ippp_rc_lookahead through
     push_la / flush_la) and the pinned JAX md5s of the quadtree AQ
     sessions (AQ_PINS, the flagship configuration among them), then
     aq_cpu_vs_card: the 416x240 quadtree IPPP session with AQ 2, cuTree
     and both filters on the card and on the CPU;
     golden_rc: the rate-controlled sessions against the JAX package's
     md5s pinned below: the uniform IPPP session under CRF 28, under ABR
     + VBV + HRD (with VBV re-encodes), with zones and with
     scene-cut-aware QP (RC_PINS), two-pass (RC_TWO_PASS_PINS: the pass-1
     stats and .cutree sidecar, the pass-2 stream), and the quadtree B
     session with the flagship's tools under CRF 28, ABR and CQP + VBV
     (RC_B_PINS, with each frame's QP); rc_cpu_vs_card: the 416x240
     quadtree B session with the flagship's tools under CRF 28 on the
     card and on the CPU (equal streams and QPs);
     golden_flagship: the flagship session (bench.py's constructor: HME,
     b-adapt 2, recon_out=False with the flagship's tools under CRF 28)
     and its variants with b_adapt=1, the histogram scene cut and the
     rc-lookahead window over the 160x96 clip of tests/flagship_pins.py
     against the JAX package's md5s and (POC, type, QP) pinned there,
     then the flagship constructor over a 416x240 clip on the card and on
     the CPU (equal streams and frames);
     golden_cli: the golden intra_qt2_psy stream (psy-rd), then the
     command line (cli.main) at --preset superfast, at --preset superfast
     --keyint 4 (open GOP: CRA + RASL_N), at --preset medium
     --no-weightp, and with weighted prediction over the clip fading by 6
     a frame with no preset flag (medium) and at --preset veryfast, and
     the library (api.Encoder at param_default_preset("superfast"),
     search range 24) over the 96x64 clip of tests/preset_pins.py against
     the JAX package's md5s, NAL types and CSV logs pinned there;
     cli_cpu_vs_card: the command line at --preset medium --no-weightp on
     a 416x240 clip on the card and on the CPU (equal streams and CSV
     logs); golden_weightp: the golden ippp_weightp stream, the quadtree
     sessions of tests/weightp_pins.py (weighted IPPP with and without
     HME, the weighted B session with the host-form filters, the
     host-filter path without weightp under AQ), the library at
     param_default_preset("medium") and the CLI's default over a 416x240
     fade against the JAX package's md5s, frames and chosen weights;
     weightp_cpu_vs_card: the command line with no preset flag on a
     416x240 clip fading by 6 a frame on the card and on the CPU (equal
     streams and CSV logs), and its bytes beside --preset medium
     --no-weightp on the same clip; golden_main10: the golden
     intra_main10 stream, the 10- and 12-bit sessions and the 10-bit
     command lines of tests/main10_pins.py against the JAX package's
     md5s, frames, NAL types and CSV logs (K1 on int16 planes, HME's 4x4
     surface among them); main10_cpu_vs_card: the command line with no
     preset flag on a 416x240 10-bit clip on the card and on the CPU;
     golden_stream_opts: the goldens intra_lossless, intra_wpp,
     intra_slices2 and intra_scaling_default, and the sessions, command
     lines and library cases of tests/stream_opts_pins.py (the uniform
     CTU32 grid's intra and video sessions, the quadtree's WPP, lossless,
     slices, scaling lists, the CRC and checksum) against the JAX
     package's pins; lossless_cpu_vs_card: --lossless on a 416x240 clip
     on the card and on the CPU, equal streams, every recon frame equal to
     its source; golden_p_options: the golden ippp_multiref_tmvp and the
     sessions, command lines and library cases of tests/p_options_pins.py
     (two references, TMVP, max_merge, frame duplication, the P / B WPP
     substreams) against the JAX package's pins; p_options_cpu_vs_card:
     the library's uniform P-only cases and those command lines on a
     416x240 clip on the card and on the CPU, equal streams;
  5. the main paths over a synthetic 1080p clip (qp 32, keyint 250, hash
     SEI) with fps, per-stage ms, bytes, PSNR-Y, peak device memory and
     K1's launch counts, each path's counts set to 0 just before it: the
     uniform IPPP path (1080p, encode_frame; sad_sweep_best = frames + P
     frames: one lookahead sweep per frame, one ME sweep per P frame;
     sad_block8_sweep = 0; I + P), the quadtree path (1080p_qt2,
     encode_frame, I + P; sad_sweep_best = frames, the lookahead's;
     sad_block8_sweep = P frames, the multi-size ME surface) and the
     quadtree B path (1080p_qt2_b, 5 frames through push_frame / flush:
     IDR, P 4, B 2, b 1, b 3; sad_sweep_best = 5, sad_block8_sweep = 1 +
     2 x 3, one surface per P anchor and one per list per B frame), and
     the same B path with both in-loop filters on (1080p_qt2_b_lf: the
     same launches; the filters' ms per frame type); after each, its last
     P or B frame again with both entry points patched to their plain
     versions, whose decision dict (with the filtered recon and the SAO
     parameters) must be identical; then the filtered B path with sign
     hiding (1080p_qt2_b_lf_sbh: the same launches; bytes and PSNR beside
     the run without), an I and a P frame of the quadtree IPPP session
     with RDOQ (1080p_qt2_rdoq: K1 fused 2, surface 1), and the all-intra
     session with sign hiding and both filters (1080p_intra: a frame through
     encode_frame, then a batch of 2 through encode_batch, each batched
     frame's decisions equal to its single-frame encode; ms per frame,
     launches per frame in each mode under torch.profiler, bytes, PSNR
     Y/U/V, SSIM-Y, peak memory; it runs no K1); then the flagship's
     tools under CQP (1080p_qt2_b_lf_sbh_aq: the filtered B path with
     sign hiding, AQ 2 and cuTree; the same launches; each frame's QP-map
     statistics and the "qp_map" stage; bytes, PSNR-Y/U/V and SSIM-Y per
     frame beside the run without AQ, aq_vs_no_aq; the plain rerun's QP
     map identical too) and the uniform IPPP path with AQ 2, cuTree and
     the rc-lookahead window (1080p_aq_la, rc_lookahead=3, 5 frames
     through push_la / flush_la: K1 fused = frames + P frames, surface 0;
     the last P frame's plain rerun identical); then the rate control at
     1080p: the flagship's constructor (bench.py) without HME and with
     b_adapt=0, CRF 28 (1080p_qt2_b_crf: 5 frames, the IDR and a
     mini-GOP; each frame's QP, type, bytes and quality, kbps at 25 fps,
     the "rc" stage; K1 exactly 5 fused + 1 + 2 x 3 surface; the last b
     frame's plain rerun identical), its five frames beside the
     CQP-32 run of 1080p_qt2_b_lf_sbh_aq (crf_vs_cqp), and the uniform
     IPPP path under ABR 27,000 kbps with VBV at that rate, a one-second
     buffer and the HRD (1080p_abr_vbv, 7 frames: bits, QP, VBV overshoot
     and buffer fill per frame, the re-encodes and their wall time, kbps
     against the target; K1 fused = frames + P-frame program calls);
     then the flagship itself: bench.py's constructor verbatim over 5
     frames (1080p_flagship: fps, the mini-GOP lengths b-adapt chose, QPs,
     bytes, stage ms, the share of blocks that took HME's coarse MV, peak
     memory; K1 exactly frames + K + K(K-1)/2 per trellis decision fused,
     and one 8x8 and one 4x4 surface per P anchor, two of each per B
     frame; the last B frame's plain rerun identical); then the entry
     points users call: the command line at --preset superfast over a
     1080p y4m (1080p_cli_superfast, 3 frames: fps, each frame's type,
     POC, QP and bytes from the CSV log, stage ms, peak memory; K1 exactly
     3 fused + one surface per P anchor and two per B frame; the last B
     frame's launches with and without intra candidates, its program's ms
     with and without psy-rd in turns and the last P anchor's, and its
     plain rerun identical) and the library at superfast
     (1080p_api_superfast, 5 frames: K1 frames + 10 per trellis fused,
     the R = 24 surfaces one per P anchor and two per B frame; the last B
     frame's plain rerun identical), then x265's default command line,
     no preset flag, over a 1080p y4m fading by 6 a frame
     (1080p_cli_medium, 3 frames, --csv-log-level 2: fps, each frame's
     type, POC, QP and bytes, the weights each P anchor chose, each
     frame's device, deblock, SAO and serialize ms, peak memory; K1 frames
     + the trellis's fused, one surface per P anchor and two per B frame;
     the weighted P anchor's plain rerun identical), and the same command
     line over a 10-bit y4m of synth_clip times 4
     (1080p_cli_medium_main10, 3 frames: fps, bytes, PSNR at the 10-bit
     peak, peak memory, K1's launches by entry point on int16 planes; the
     last B frame's plain rerun identical), then the slice's two command
     lines: --keyint 1 --qp 32 --ctu 32 --wpp over a 1080p y4m, 2 frames
     in one batch (1080p_cli_intra_ctu32_wpp: ms per frame, the Python
     CABAC's serialize ms, bytes, PSNR-Y, peak memory; no K1) and --ctu 32
     --min-cu-size 32 at x265's default preset, 5 frames (1080p_cli_ctu32:
     fps, K1's launches by entry point and the fused sweep's by size, 8
     for the lookahead and the trellis, 32 for the ME, CUDA launches of
     the last P and B program, the last B frame's plain rerun identical);
     then the P-frame options: the library at medium without B frames on
     the uniform 16x16 grid, two references and TMVP (1080p_api_p_only,
     3 frames: fps, stage ms per frame, the P slices' Python CABAC, K1 3
     fused at n = 8 and 4 at n = 16, the share of CUs on reference index
     1, CUDA launches of the last P program, its plain rerun identical)
     and the uniform B session with WPP (1080p_wpp_b, 4 frames: 68
     substreams a slice through the Python CABAC, K1 9 fused, the last B
     frame's plain rerun identical); then the all-intra session's last
     options: golden_intra_opts (tests/intra_opts_pins.py's 4:4:4, NR,
     fast-intra and CTU64 program decision dicts against the JAX
     programs' digests, its sessions and command lines against the JAX
     md5s, frames, NAL types and CSV logs), intra_opts_cpu_vs_card (4:4:4,
     NR over 3 frames one by one, fast intra and CTU64 depth 3 at
     416x240, card against CPU) and 1080p_intra_opts (--ctu 64 --keyint 1
     --qp 32 through cli.main, a CTU64 depth-2 frame beside the CTU32
     depth-2 quadtree's, a 4:4:4 frame, fast intra beside the plain
     uniform grid in turns, three NR frames beside three without: ms,
     launches, bytes, PSNR-Y/U/V, peak memory; K1 none); then the last
     options at the entry points (tests/tools_pins.py): golden_rqt (the
     RQT P program at one QP, at a QP map and with RDOQ and the B
     program against the JAX programs' digests, tests/test_rqt.py's P
     and B sessions, the deblocked P session whose stream decodes to
     another picture as the reference's does, --rqt through cli.main),
     golden_analysis (tests/test_analysis_reuse.py's and
     tests/test_scale_factor.py's passes, streams and record files, and
     --analysis-save / --analysis-load), golden_ladder (the two-rung
     ladder with and without the hand-off, --ladder through cli.main),
     golden_sei_tools (the HDR10+ session, --dolby-vision-rpu and
     --dhdr10-info through cli.main, --recon-y4m-exec's y4m against
     --recon's planes), each against the JAX package's md5s;
     tools_cpu_vs_card (416x240: the RQT P and B sessions, the save and
     load passes with their record files, the 416x240 + 208x120 ladder
     with the hand-off, card against CPU); 1080p_rqt (the depth-2
     quadtree, I + P, with rqt=True and rqt=False: bytes, PSNR-Y, K1 2
     fused + 1 surface in both, the share of unsplit inter CU32 leaves
     whose TU split, the P program's ms with the split variant on and off
     in turns and its CUDA launches each way, the plain rerun identical);
     1080p_analysis (the uniform IPPP path, a save pass then a load pass
     of 3 frames: fps, bytes, PSNR-Y, K1's launches by frame: the load
     pass's P frames launch no ME sweep; the plain rerun identical) and
     1080p_ladder (--keyint 250 --ladder 1920x1080:6000,960x540:2000
     through cli.main, 4 frames: fps, each rung's kbps against its
     target, the scaler's ms per frame, K1's launches per rung: the 1080p
     rung, hinted by the 540p one, launches its lookahead's only);
     then the multi-slot pipeline (tests/parallel_pins.py), its slots as
     four streams of card 0 and, on a machine of two cards or more,
     across the cards: golden_pipeline (the frame- and band-parallel
     programs, the P-chain fill and steady state against the JAX
     programs' digests, the pipelined sessions at QP 32 and 30 and under
     per-chain ABR, the int8 refusal and its sequential stream, --devices
     4 through cli.main, the video session's flush(count), each against
     the JAX package's md5s; every session's K1 launches on its slots'
     streams, one a P frame), pipeline_cpu_vs_card (416x240, the IDR and
     two chains of 4: encode_clip on the card against the CPU's and
     against encode_clip_sequential, --devices 4 through cli.main; the
     host's waits for the card under set_sync_debug_mode) and
     1080p_pipeline (the IDR and two chains of 4, encode_clip and
     encode_clip_sequential in turns: fps after the IDR, bytes, PSNR-Y,
     K1 one fused sweep a P frame either way, the share of K1 launches on
     the slots' own streams; profiled over the IDR and one chain each
     way: the device's idle share and the overlap of the streams);
     then the uniform 8x8 grid (tests/cu8_pins.py): k1_n8 (in phase 2,
     with the card to itself: the fused sweep at n = 8 on 1080x1920, 135
     block rows, in uint8 and 10-bit int16, a 40x48 crop of 5 block rows
     at lambda 0, 1 and 2 and a flat plane at lambda 0 and 2, each equal
     to its plain version; time, plain time, bound), golden_cu8 (every
     pin of the uniform 8x8 grid's sessions, PipelinedEncoder, analysis
     save / load and two passes against the JAX package's md5s and
     frames, the AQ sessions refused with the reason, and the CTU64 P / B
     writer's outputs of tests/native_writer_pins.py), cu8_cpu_vs_card
     (416x240: the IPPP session with the filters and the B session, card
     against CPU) and 1080p_cu8 (cu_size=8 with the deblock and SAO over
     synth_clip, I + 2 P timed and a P frame profiled: fps after the IDR,
     launches a P frame, the device's idle share, K1's launches by entry
     point and the fused sweep's by size, bytes, PSNR-Y, peak memory; the
     last P frame's plain rerun identical);
     intra_commit (in phase 2, with the card to itself): the intra commit
     kernel against the batched commit on the first P anchor's commit of
     medium-psnr-1080p.pan (the benchmark's configuration and content),
     equal on rec and levels; the time, host wall and launches of each,
     and the kernel's bounds (bytes; the chain of its diagonals, as the
     same launches over a table with no leaf);
  6. intra_commit_paths: the intra commit's counters on each path's main
     path (the kernel's launches and leaves, the batched commit's
     leaves): the batched commit takes no leaf where the dispatch rule
     sends them to the kernel (IC_KERNEL_PATHS), the kernel none under
     RDOQ (IC_BATCHED_PATHS); the kernels line (launches on the
     flagship's path, and on each path; each entry point's int16 time,
     plain time, bound and launches on the 10-bit path; the intra
     commit's row: the replay's time, bounds and agreement, and the
     counters of each path); then the card line and, last, the ok line.
Exits nonzero without a result when no CUDA device is present.
"""

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
W1080, H1080 = 1920, 1080
FRAMES = 2          # the uniform IPPP path: I + P [4]
QT_FRAMES = 2       # the quadtree path: I + P [4]
QT_B_FRAMES = 5     # the B path: I, then one mini-GOP (P, B, b, b)
B_KW = dict(max_depth=2, bframes=3, b_pyramid=True, b_adapt=0)
# md5 of the JAX package's stream of the quadtree B session on the golden
# clip (64x48, 8 frames, qp 30, keyint 5, no hash SEI)
GOLDEN_QT2_B_MD5 = "0eca13bc30dfb501333206d7751facc6"
LF = dict(deblock=True, sao=True)
# md5 of the JAX package's streams on the golden clip with both in-loop
# filters and the hash SEI on: the uniform IPPP session (qp 32, keyint
# 100), the quadtree IPPP session (qp 30, keyint 100) and the quadtree B
# session (as GOLDEN_QT2_B_MD5's)
LF_PINS = {"uniform": "0b71ca6e5ad866cf844df3036a46daa9",
           "qt2_ippp": "25599653a857fb705ce2eeac6aa750da",
           "qt2_b": "001a8cbb356be2cc980690bd99ba8630"}
# md5 of the JAX package's streams on the golden clip with the hash SEI
# on: the quadtree intra session with sign hiding and both filters (qp
# 30), and the quadtree B session (as GOLDEN_QT2_B_MD5's) with sign hiding
# and both filters
SBH_PINS = {"intra_qt2_sbh_lf": "250afb785a78a94b42d0296bdc099eab",
            "qt2_b_sbh_lf": "2734e716459f0c1887d6c689eff0055b"}
# md5 of the JAX package's streams on the golden clip with adaptive
# quantization: the quadtree IPPP session with AQ 2, cuTree and both
# filters (qp 30, keyint 100, hash SEI), the quadtree intra session with AQ
# 2 and both filters (qp 30, hash SEI), and tests/golden_corpus.py's
# qt2_bframes_flagship configuration on this tree (its manifest md5
# predates the reference's parked B-session cuTree average)
AQ_PINS = {"qt2_aq_cutree_lf_sei": "795879673f782275c42823a944f8d503",
           "intra_qt2_aq_lf_sei": "33836641495f1c374bf9fbd94e7b6d2e",
           "qt2_bframes_flagship": "f9c048f1d7f69982d48dabf30d1a146f"}
AQ = dict(aq_mode=2, cutree=True)
# rate control: the uniform IPPP sessions on the golden clip (64x48, 6
# frames; the scene-cut clip: 10 frames with a cut at frame 2) and md5 of
# the JAX package's stream of each; two-pass: pass 1 (ABR with cuTree)
# writes the stats and the .cutree sidecar (md5 of the two files, one
# after the other), pass 2 reads them
RC_UNI = dict(qp=32, cu_size=16, keyint=100, hash_sei=False)
RC_PINS = {
    "ippp_crf28": (dict(RC_UNI, rc_mode="crf", crf=28.0),
                   "ef4ae31880633349ceac03ec8677ee55"),
    "ippp_abr_vbv_hrd": (dict(RC_UNI, rc_mode="abr", bitrate_kbps=200,
                              vbv_maxrate_kbps=100, vbv_bufsize_kbps=6,
                              hrd=True, hash_sei=True),
                         "2614e6bb5bf5afa654d8b07335476356"),
    "ippp_zones_crf": (dict(RC_UNI, rc_mode="crf", crf=30.0,
                            zones="1,2,q=20/3,4,b=0.5"),
                       "f2f7d61bd535834a435a3221fae33982"),
    "ippp_scenecut_aware": (dict(RC_UNI, keyint=20, rc_mode="crf", crf=28.0,
                                 scenecut_aware_qp=True, scenecut_qp_delta=6,
                                 scenecut_window=6),
                            "00210aa051e8917399516bcec52d0fc4")}
RC_TWO_PASS = dict(RC_UNI, keyint=4, rc_mode="abr", bitrate_kbps=300)
RC_TWO_PASS_PINS = {"stats": "105089c1cabb55d4f51d3d4f9b64ea81",
                    "pass2": "869c1e57a9a04416292993c773903572"}
# the quadtree B session with the flagship's tools (tests/golden_corpus.py's
# qt2_bframes_flagship, 8 frames) under rate control: md5 of the JAX
# package's stream, and its QPs in coding order
FLAG = dict(qp=30, max_depth=2, keyint=100, bframes=3, b_pyramid=True,
            b_adapt=0, hash_sei=False, sbh=True, **AQ, **LF)
RC_B_PINS = {
    "flagship_crf28": (dict(FLAG, rc_mode="crf", crf=28.0),
                       "58a9fea10900601709701be6a60ecdcf",
                       [25, 35, 39, 39, 38, 36, 37, 38]),
    "flagship_abr150": (dict(FLAG, rc_mode="abr", bitrate_kbps=150),
                        "9c2dfce1699e8658d8758f970acf85d2",
                        [34, 37, 31, 31, 28, 25, 26, 25]),
    "flagship_cqp_vbv": (dict(FLAG, vbv_maxrate_kbps=20, vbv_bufsize_kbps=10),
                         "e80b573bc27e2a797d61a31522e4b956",
                         [27, 37, 38, 39, 39, 30, 31, 32])}
# the flagship session (bench.py's constructor) without HME, b_adapt=0
FLAGSHIP_CRF = dict(keyint=250, bframes=3, b_pyramid=True, max_depth=2,
                    b_adapt=0, rc_mode="crf", crf=28.0, sbh=True,
                    hash_sei=False, quality_metrics=True, **AQ, **LF)
QT_B_CRF_FRAMES = 5   # the IDR and a mini-GOP (1080p_flagship runs two)
FLAGSHIP_FRAMES = 5   # the 1080p flagship: the IDR, a trellis decision [13, 9]
CLI_FRAMES = 3        # the CLI at ultrafast: the IDR, a P, a b [9, 5]
SUPERFAST_FRAMES = 3  # the CLI at superfast: the IDR, a P anchor, a B [5]
API_FRAMES = 5        # the library at superfast: the IDR, one trellis
MEDIUM_FRAMES = 3     # the CLI's default (medium): the IDR, P, b [6, 5]
B_UNIFORM_FRAMES = 3  # the uniform B session: the IDR, a P, a b [9, 5]
MAIN10_FRAMES = 3     # the CLI's default at 10 bits: the IDR, P, b [5]
API_P_FRAMES = 3      # the library's uniform P-only session: I + 2 P [5]
WPP_B_FRAMES = 4      # the uniform WPP B session: the IDR, P 3, B 2, b 1
R24_ME = "P-frame ME 1088x1920 R=24"
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
INT32_LANES_PER_SM = 64        # Hopper SM: 4 partitions x 16 INT32 lanes


T0 = time.perf_counter()


def emit(**kw):
    """One JSON line, with the seconds since the script started (in a
    worker of the pool, sent to the parent, which prints it)."""
    line = json.dumps(dict(kw, elapsed_s=time.perf_counter() - T0))
    if _SINK is not None:
        _SINK.put(("line", None, line))
    else:
        print(line, flush=True)


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


def flagship_pins():
    """tests/flagship_pins.py: the flagship session's 160x96 test clip,
    the JAX package's md5s and (POC, type, QP) over it, and the counter
    of HME's coarse winners."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import flagship_pins as pins
    return pins


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
                n: int = None, base: int = 8):
    """Least time for the sweep: the larger of the bytes (both planes read
    once; the [D, D, H/base, W/base] int32 surface, or with n the three
    int32 [nblocks] outputs of the fused kernel, written once) over the
    memory rate and the abs-diff-adds over the INT32-lane rate."""
    D = 2 * R + 1
    out = D * D * (H // base) * (W // base) * 4 if n is None \
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
    ptxas = {lib: [ln.strip() for ln in logs[lib].splitlines()
                   if "registers" in ln or "spill" in ln or "smem" in ln]
             for lib in ("me_sad", "intra_commit")}
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
        # the library's search range, min(merange, 24)
        (R24_ME, y0, y1, 24, (8, 16), (2,)),
        ("24x32 R=24>plane", l0[:24, :32].contiguous(),
         l1[:24, :32].contiguous(), 24, (8,), (0, 1, 2)),
        ("flat lambda=0 R=24", flat, flat, 24, (8, 16), (0,)),
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
    # the surface at the library's search range: 2401 displacements
    _, ref, src, R, _, _ = next(c for c in cases if c[0] == R24_ME)
    H, W = src.shape
    row = dict(shape=R24_ME, H=H, W=W, R=R, dtype=str(src.dtype))
    row["surface_ms"] = cuda_ms(
        lambda: me_sad.sad_block8_sweep(ref, src, R), 20)
    row["surface_plain_ms"] = cuda_ms(
        lambda: me_sad.sad_block8_sweep_plain(ref, src, R), 2)
    row["surface_bound_ms"], row["surface_bound_by"] = k1_bound_ms(
        H, W, R, src.dtype, int_ops_per_s(*card, src.dtype))
    emit(phase="k1", **row)
    rows[R24_ME] = row
    # the 4x4-base surface (HME's coarse sweep): 544x960 planes (the
    # downscaled 1080p frames, as HME's) in uint8 and int32, smaller and
    # wider types, a flat plane
    from x265_yuuki_asuna_tpu_torch.ops import me
    la, la32 = cases[0], cases[2]
    g = golden_clip()
    g0, g1 = (torch.as_tensor(g[i][0], device=dev) for i in (0, 1))
    rng = np.random.default_rng(12)
    tex = lambda dt: torch.as_tensor(rng.integers(0, 256, (48, 80)),
                                     dtype=dt, device=dev)
    flat = torch.full((48, 80), 77, dtype=torch.uint8, device=dev)
    for name, ref, src in (
            ("hme 544x960", la[1], la[2]), ("hme 544x960 int32", la32[1],
                                            la32[2]),
            ("24x32 R>plane", g0[:24, :32].contiguous(),
             g1[:24, :32].contiguous()),
            ("48x80 int16", tex(torch.int16), tex(torch.int16)),
            ("flat", flat, flat)):
        k = me_sad.sad_block4_sweep(ref, src, 16)
        p = me_sad.sad_block4_sweep_plain(ref, src, 16)
        torch.cuda.synchronize()
        e = int((k.long() - p.long()).abs().max())
        sizes = (4, 8, 16) if src.shape[0] % 16 == 0 else (4, 8)
        multi = {lam: me.sad_sweep_multi(ref, src, sizes, 16, lam)
                 for lam in (0, 2)}
        flat_ok = None
        if name == "flat":   # all SADs 0: (-R, -R) at lambda 0, (0, 0) at 2
            flat_ok = all(bool((multi[0][n][0] == -16).all())
                          and bool((multi[0][n][1] == -16).all())
                          and bool((multi[2][n][0] == 0).all())
                          and bool((multi[2][n][1] == 0).all())
                          for n in sizes)
        emit(phase="k1_parity", shape=name, entry="sad_block4_sweep",
             dtype=str(src.dtype), R=16, surface_max_abs_err=e,
             flat_answer_ok=flat_ok)
        if e or flat_ok is False:
            raise AssertionError(f"K1 4x4 surface differs from its plain "
                                 f"version at {name}: max abs err {e}, "
                                 f"flat {flat_ok}")
        err = max(err, e)
        if name.startswith("hme"):
            H, W = src.shape
            row = dict(shape=name, H=H, W=W, R=16, dtype=str(src.dtype),
                       entry="sad_block4_sweep")
            row["ms"] = cuda_ms(
                lambda: me_sad.sad_block4_sweep(ref, src, 16), 20)
            row["plain_ms"] = cuda_ms(
                lambda: me_sad.sad_block4_sweep_plain(ref, src, 16), 2)
            row["bound_ms"], row["bound_by"] = k1_bound_ms(
                H, W, 16, src.dtype, int_ops_per_s(*card, src.dtype),
                base=4)
            row["route_ms"] = cuda_ms(
                lambda: me.sad_sweep_multi(ref, src, (4, 8, 16), 16, 2), 10)
            emit(phase="k1", **row)
            rows[name] = row
    return rows, err


def phase_k1_int16(dev, card):
    """K1's three entry points on the int16 planes of the 10- and 12-bit
    paths against their plain versions, then each one's time, plain time
    and bound at the main paths' shapes: the lookahead's fused sweep
    (544x960, n = 8), the P frame's surface and the uniform grid's fused
    sweep (1088x1920, n = 16), both at R = 24 at 12 bits (where the fused
    keys take 64 bits), and HME's 4x4 surface (544x960). The fused
    sweeps' keys are sized from the samples' peak, as the sessions call
    them."""
    from x265_yuuki_asuna_tpu_torch.models.lookahead import downscale_half
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    fr = synth_clip(2, W1080, H1080)
    rng = np.random.default_rng(13)

    def deep(y, bd):
        p = np.pad(y, ((0, 8), (0, 0)), mode="edge").astype(np.int16)
        s = bd - 8
        return torch.as_tensor((p << s) + rng.integers(0, 1 << s, p.shape)
                               .astype(np.int16), device=dev)
    y10 = [deep(f[0], 10) for f in fr]
    y12 = [deep(f[0], 12) for f in fr]
    low = lambda y: downscale_half(y)[:544, :960].to(torch.int16) \
        .contiguous()
    cases = [
        # (name, bit depth, ref, src, R, fused (n, lambda) or None, base)
        ("lookahead 544x960 int16", 10, low(y10[0]), low(y10[1]), 16,
         (8, 1), 8),
        ("P-frame ME 1088x1920 int16", 10, y10[0], y10[1], 16, (16, 2), 8),
        ("P-frame ME 1088x1920 int16 12-bit R=24", 12, y12[0], y12[1], 24,
         (16, 2), 8),
        ("hme 544x960 int16", 10, low(y10[0]), low(y10[1]), 16, None, 4),
    ]
    rows, err = {}, 0
    for name, bd, ref, src, R, fused, base in cases:
        H, W = src.shape
        peak = (1 << bd) - 1
        sweep = me_sad.sad_block4_sweep if base == 4 else \
            me_sad.sad_block8_sweep
        plain = me_sad.sad_block4_sweep_plain if base == 4 else \
            me_sad.sad_block8_sweep_plain
        k, p = sweep(ref, src, R), plain(ref, src, R)
        torch.cuda.synchronize()
        e = int((k.long() - p.long()).abs().max())
        rate = int_ops_per_s(*card, src.dtype)
        row = dict(shape=name, H=H, W=W, R=R, dtype=str(src.dtype),
                   bit_depth=bd, surface_max_abs_err=e,
                   surface_entry=sweep.__name__)
        row["surface_ms"] = cuda_ms(lambda: sweep(ref, src, R), 20)
        row["surface_plain_ms"] = cuda_ms(lambda: plain(ref, src, R), 2)
        row["surface_bound_ms"], row["surface_bound_by"] = k1_bound_ms(
            H, W, R, src.dtype, rate, base=base)
        if fused:
            n, lam = fused
            kb = me_sad.sad_sweep_best(ref, src, R, n, lam, peak)
            pb = me_sad.sad_sweep_best_plain(ref, src, R, n, lam)
            torch.cuda.synchronize()
            eb = max(int((a.long() - b.long()).abs().max())
                     for a, b in zip(kb, pb))
            e = max(e, eb)
            shift, kdt = me_sad.key_layout(src.dtype, n, R, lam, peak)
            keys = torch.full(((H // n) * (W // n),), -1, dtype=kdt,
                              device=dev)
            row.update(n=n, lambda_bits=lam, best_max_abs_err=eb,
                       key_dtype=str(kdt))
            row["best_ms"] = cuda_ms(lambda: me_sad._launch(
                "best", src, ref.data_ptr(), src.data_ptr(),
                keys.data_ptr(), H, W, R, n, lam, shift, keys.element_size(),
                1), 50)
            row["best_route_ms"] = cuda_ms(
                lambda: me_sad.sad_sweep_best(ref, src, R, n, lam, peak), 20)
            row["best_plain_ms"] = cuda_ms(
                lambda: me_sad.sad_sweep_best_plain(ref, src, R, n, lam), 2)
            row["best_bound_ms"], row["best_bound_by"] = k1_bound_ms(
                H, W, R, src.dtype, rate, n)
        emit(phase="k1_int16", **row)
        if e:
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"{name}: max abs err {e}")
        want = torch.int64 if R == 24 and bd == 12 else torch.int32
        if fused and row["key_dtype"] != str(want):
            raise AssertionError(f"{name}: fused keys {row['key_dtype']}")
        err = max(err, e)
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


def phase_golden_lf(dev):
    """The golden clip through the port's filtered sessions on the card:
    the manifest's ippp_deblock_sao, and the pinned JAX md5s (LF_PINS)."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    with open(os.path.join(REPO, "tests", "golden", "manifest.json")) as f:
        manifest = json.load(f)["ippp_deblock_sao"]
    uni = dict(qp=32, cu_size=16, keyint=100)
    cases = (("ippp_deblock_sao", dict(uni, hash_sei=False), manifest),
             ("uniform", dict(uni, hash_sei=True), LF_PINS["uniform"]),
             ("qt2_ippp", dict(qp=30, max_depth=2, keyint=100,
                               hash_sei=True), LF_PINS["qt2_ippp"]),
             ("qt2_b", dict(B_KW, qp=30, keyint=5, hash_sei=True),
              LF_PINS["qt2_b"]))
    got = {}
    for name, kw, want in cases:
        sess = VideoEncoderSession(64, 48, device=dev, **kw, **LF)
        res = push_all(sess, golden_clip(n=8)) if sess.bframes else \
            [sess.encode_frame(*fr) for fr in golden_clip()]
        got[name] = hashlib.md5(sess.headers() + b"".join(
            r.nals for r in res)).hexdigest()
        got[name + "_match"] = got[name] == want
    emit(phase="golden_lf", **got)
    bad = [k for k in got if k.endswith("_match") and not got[k]]
    if bad:
        raise AssertionError(f"filtered golden md5s differ: {bad}")


def phase_qt2_cpu_vs_card(dev, phase="qt2_cpu_vs_card", opts=None,
                          sessions=None):
    """The quadtree IPPP and B sessions (or with opts, the B session with
    those options; or `sessions`: (name, keywords, frames) each) on a
    416x240 clip, on the card and on the CPU: each pair of streams must be
    equal."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    if sessions is None:
        sessions = (("ippp", {"max_depth": 2}, 3), ("b", B_KW, 5)) \
            if opts is None else (("b", dict(B_KW, **opts), 5),)
    for name, kw, n in sessions:
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
        emit(phase=phase, session=name, frames=n, md5=md5,
             seconds=secs, equal=same)
        if not same:
            raise AssertionError(f"416x240 quadtree {name} streams differ: "
                                 f"{md5}")


GOLDEN_INTRA = (
    ("intra_cqp_ctu16", dict(qp=32)), ("intra_qp26_deblock",
                                       dict(qp=26, deblock=True)),
    ("intra_sao", dict(qp=32, sao=True)), ("intra_sbh", dict(qp=32, sbh=True)),
    ("intra_rdoq", dict(qp=32, rdoq=True)))


def phase_golden_intra(dev):
    """The five golden intra clips through the port's IntraEncoderSession
    on the card: each stream md5 must be the manifest's; and the sign-
    hiding sessions' pinned JAX md5s (SBH_PINS)."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        IntraEncoderSession, VideoEncoderSession
    with open(os.path.join(REPO, "tests", "golden", "manifest.json")) as f:
        manifest = json.load(f)
    got = {}
    for key, kw in GOLDEN_INTRA:
        sess = IntraEncoderSession(64, 48, hash_sei=False, device=dev, **kw)
        out = sess.headers() + b"".join(sess.encode_frame(*fr).nals
                                        for fr in golden_clip())
        got[key] = hashlib.md5(out).hexdigest()
        got[key + "_match"] = got[key] == manifest[key]
    sess = IntraEncoderSession(64, 48, qp=30, max_depth=2, sbh=True,
                               hash_sei=True, device=dev, **LF)
    res = [sess.encode_frame(*fr) for fr in golden_clip()]
    b = VideoEncoderSession(64, 48, qp=30, keyint=5, hash_sei=True, sbh=True,
                            device=dev, **B_KW, **LF)
    for key, s_, r in (("intra_qt2_sbh_lf", sess, res),
                       ("qt2_b_sbh_lf", b, push_all(b, golden_clip(n=8)))):
        got[key] = hashlib.md5(s_.headers() + b"".join(
            x.nals for x in r)).hexdigest()
        got[key + "_match"] = got[key] == SBH_PINS[key]
    emit(phase="golden_intra", **got)
    bad = [k for k in got if k.endswith("_match") and not got[k]]
    if bad:
        raise AssertionError(f"golden intra md5s differ: {bad}")


def phase_intra_cpu_vs_card(dev):
    """The quadtree intra session with sign hiding and both filters, and
    the uniform intra session with RDOQ, on a 416x240 clip on the card and
    on the CPU: equal streams."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        IntraEncoderSession
    frames = synth_clip(2, 416, 240)
    for name, kw in (("qt2_sbh_lf", dict(max_depth=2, sbh=True, **LF)),
                     ("uniform_rdoq", dict(rdoq=True))):
        md5, secs = {}, {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            sess = IntraEncoderSession(416, 240, qp=30, hash_sei=True,
                                       device=where, **kw)
            out = sess.headers() + b"".join(sess.encode_frame(*f).nals
                                            for f in frames)
            md5[str(where)] = hashlib.md5(out).hexdigest()
            secs[str(where)] = time.perf_counter() - t0
        same = len(set(md5.values())) == 1
        emit(phase="intra_cpu_vs_card", session=name, frames=len(frames),
             md5=md5, seconds=secs, equal=same)
        if not same:
            raise AssertionError(f"416x240 intra {name} streams differ: "
                                 f"{md5}")


def _md5_of(sess, results) -> str:
    return hashlib.md5(sess.headers() + b"".join(
        r.nals for r in results)).hexdigest()


def phase_golden_aq(dev):
    """The golden AQ / cuTree clips through the port's sessions on the
    card (the manifest's intra_aq2, ippp_aq_cutree and ippp_rc_lookahead,
    the last through push_la / flush_la) and the pinned JAX md5s of the
    quadtree AQ sessions (AQ_PINS); then the 416x240 quadtree IPPP session
    with AQ 2, cuTree and both filters, card against CPU."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        IntraEncoderSession, VideoEncoderSession
    with open(os.path.join(REPO, "tests", "golden", "manifest.json")) as f:
        manifest = json.load(f)
    uni = dict(qp=32, cu_size=16, keyint=100, hash_sei=False)
    got = {}

    def check(key, sess, results, want):
        got[key] = _md5_of(sess, results)
        got[key + "_match"] = got[key] == want

    s = IntraEncoderSession(64, 48, qp=32, aq_mode=2, hash_sei=False,
                            device=dev)
    check("intra_aq2", s, [s.encode_frame(*f) for f in golden_clip()],
          manifest["intra_aq2"])
    s = VideoEncoderSession(64, 48, device=dev, **uni, **AQ)
    check("ippp_aq_cutree", s, [s.encode_frame(*f) for f in golden_clip()],
          manifest["ippp_aq_cutree"])
    s = VideoEncoderSession(64, 48, device=dev, cutree=True, rc_lookahead=3,
                            **uni)
    res = []
    for f in golden_clip():
        res += s.push_la(*f)
    check("ippp_rc_lookahead", s, res + s.flush_la(),
          manifest["ippp_rc_lookahead"])
    s = VideoEncoderSession(64, 48, qp=30, max_depth=2, keyint=100,
                            hash_sei=True, device=dev, **AQ, **LF)
    check("qt2_aq_cutree_lf_sei", s,
          [s.encode_frame(*f) for f in golden_clip()],
          AQ_PINS["qt2_aq_cutree_lf_sei"])
    s = IntraEncoderSession(64, 48, qp=30, max_depth=2, aq_mode=2,
                            hash_sei=True, device=dev, **LF)
    check("intra_qt2_aq_lf_sei", s,
          [s.encode_frame(*f) for f in golden_clip()],
          AQ_PINS["intra_qt2_aq_lf_sei"])
    s = VideoEncoderSession(64, 48, qp=30, keyint=100, hash_sei=False,
                            sbh=True, device=dev, **B_KW, **AQ, **LF)
    check("qt2_bframes_flagship", s, push_all(s, golden_clip()),
          AQ_PINS["qt2_bframes_flagship"])
    emit(phase="golden_aq", **got)
    bad = [k for k in got if k.endswith("_match") and not got[k]]
    if bad:
        raise AssertionError(f"AQ golden md5s differ: {bad}")
    phase_qt2_cpu_vs_card(dev, "aq_cpu_vs_card", sessions=(
        ("ippp_aq_cutree_lf", dict(max_depth=2, **AQ, **LF), 3),))


def _qp_map_stats(maps) -> list:
    """Per frame: min / mean / max offset of the per-CU QP map from the
    slice QP and the share of CUs off it (maps: (slice qp, map) each)."""
    out = []
    for qp, m in maps:
        off = np.asarray(m, np.int64) - qp
        out.append({"slice_qp": int(qp), "min": int(off.min()),
                    "mean": float(off.mean()), "max": int(off.max()),
                    "share_off_slice_qp": float((off != 0).mean())})
    return out


K1_ENTRIES = ("sad_sweep_best", "sad_block8_sweep", "sad_block4_sweep")


def k1_start():
    """Set every K1 entry point's launch count, and the intra commit's
    counters, to 0 (a main path starts)."""
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    for name in K1_ENTRIES:
        getattr(me_sad, name).launches = 0
    me_sad.sad_sweep_best.launches_by_size = dict.fromkeys(
        me_sad.BEST_SIZES, 0)
    ic_counts(reset=True)


def k1_read() -> dict:
    """Every K1 entry point's launch count since k1_start(); the intra
    commit's counters since then are kept as the job's main path's
    (_IC_MAIN, which _run_job returns beside the phase's result)."""
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    _IC_MAIN[0] = ic_counts()
    return {name: getattr(me_sad, name).launches for name in K1_ENTRIES}


_IC_MAIN = [None]


def ic_counts(reset: bool = False) -> dict:
    """The intra commit's counters: the kernel's launches and leaves and
    the batched commit's leaves (models/qt_common.commit_intra's
    dispatch); reset: set them to 0 first."""
    from x265_yuuki_asuna_tpu_torch.models import qt_common as QT
    from x265_yuuki_asuna_tpu_torch.ops.kernels import intra_commit as IC
    if reset:
        IC.intra_commit.launches = IC.intra_commit.leaves = 0
        QT.commit_intra.batched_leaves = 0
    return {"launches": IC.intra_commit.launches,
            "leaves": IC.intra_commit.leaves,
            "batched_leaves": QT.commit_intra.batched_leaves}


@contextlib.contextmanager
def plain_k1():
    """Every K1 entry point patched to its plain PyTorch version."""
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    with contextlib.ExitStack() as stack:
        for name in K1_ENTRIES:
            stack.enter_context(mock.patch.object(
                me_sad, name, getattr(me_sad, name + "_plain")))
        yield


def _launches(fn) -> int:
    """CUDA kernel launches of fn() (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the raw events: building prof.events() costs seconds per 100k
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.device_type() == cuda and e.name() != "filters" and
               not getattr(e, "is_user_annotation", lambda: False)()
               for e in prof.profiler.kineto_results.events())


def phase_1080p_intra(dev, n_single=1, n_batch=2):
    """The all-intra session at 1080p with sign hiding and both filters:
    frames through encode_frame, then a batch through encode_batch; each
    batched frame's decisions (modes, levels) equal its single-frame
    encode's; returns K1's launch counts (none)."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        IntraEncoderSession
    kw = dict(qp=32, deblock=True, sao=True, sbh=True)
    frames = synth_clip(max(n_single, n_batch), W1080, H1080)
    sess = IntraEncoderSession(W1080, H1080, hash_sei=True, device=dev, **kw)
    sess.encode_frame(*frames[0])             # warm-up (not counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_start()                                    # the main path starts
    res, t_single = [], []
    for fr in frames[:n_single]:
        t0 = time.perf_counter()
        res.append(sess.encode_frame(*fr))
        t_single.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    batch = sess.encode_batch(frames[:n_batch])
    t_batch = time.perf_counter() - t0
    k1 = k1_read()
    peak = torch.cuda.max_memory_allocated()
    launches = {"single": _launches(lambda: sess.encode_frame(*frames[0])),
                "batch": _launches(lambda: sess.encode_batch(
                    frames[:n_batch])) / n_batch}
    # the program's decisions for the batch, and for each frame alone
    keys = ("modes", "levels_y", "levels_cb", "levels_cr")
    padded = [sess._pad(*f) for f in frames[:n_batch]]
    outs = sess.frame_encoder.encode_frames(*zip(*padded), sess.qp)
    same = [all(np.array_equal(o[q], sess.frame_encoder.encode_frame(
        *p, sess.qp)[q]) for q in keys) for o, p in zip(outs, padded)]
    single_ms = sum(t_single) / len(t_single) * 1e3
    emit(phase="1080p_intra", frames_single=n_single, batch=n_batch,
         ms_per_frame_single=single_ms, fps_single=1e3 / single_ms,
         ms_per_frame_batch=t_batch / n_batch * 1e3,
         fps_batch=n_batch / t_batch,
         batch_speedup=single_ms / (t_batch / n_batch * 1e3),
         launches_per_frame=launches,
         bytes_single=[len(r.nals) for r in res],
         bytes_batch=[len(r.nals) for r in batch],
         psnr_y=[r.psnr_y for r in res], psnr_u=[r.psnr_u for r in res],
         psnr_v=[r.psnr_v for r in res], ssim_y=[r.ssim_y for r in res],
         batch_psnr_y=[r.psnr_y for r in batch],
         stage_ms=dict(sess.stage_ms), k1_launches=k1,
         batch_decisions_equal=same, max_memory_allocated=peak)
    if not all(same) or len(same) != n_batch:
        raise AssertionError("1080p_intra: a batched frame's decisions "
                             "differ from its single-frame encode")
    if any(k1.values()) or not all(
            np.isfinite([r.psnr_y, r.psnr_u, r.psnr_v, r.ssim_y]).all()
            and r.recon[0].shape == (H1080, W1080) for r in res + batch):
        raise AssertionError("1080p_intra output malformed")
    return k1


def _same_decisions(a: dict, b: dict) -> bool:
    def eq(x, y):
        if x is None or y is None:
            return x is None and y is None
        if isinstance(x, tuple):
            return all(torch.equal(p, q) for p, q in zip(x, y))
        return np.array_equal(x, y)
    return sorted(a) == sorted(b) and all(eq(a[k], b[k]) for k in a)


def phase_1080p(dev, name: str, max_depth: int, n_frames: int,
                opts=None):
    """One main path at 1080p (with opts, e.g. RDOQ); returns its K1
    launch counts."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    from x265_yuuki_asuna_tpu_torch.utils import geometry as G
    frames = synth_clip(n_frames, W1080, H1080)
    sess = VideoEncoderSession(W1080, H1080, qp=32, keyint=250,
                               hash_sei=True, max_depth=max_depth,
                               device=dev, **(opts or {}))
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, t_frames = [], []
    last_p = None
    k1_start()                                    # the main path starts
    for i, fr in enumerate(frames):
        if i == len(frames) - 1:
            last_p = (fr, sess.ref)
        t0 = time.perf_counter()
        r = sess.encode_frame(*fr)
        t_frames.append(time.perf_counter() - t0)
        results.append(r)
        total += len(r.nals)
    launches = k1_read()
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
         opts=opts or {}, fps=fps, frame_ms=[t * 1e3 for t in t_frames],
         stage_ms_per_frame={k: v / max(runs.get(k, len(frames)), 1)
                             for k, v in sess.stage_ms.items()},
         bytes=total, psnr_y=psnr, psnr_u=[r.psnr_u for r in results],
         psnr_v=[r.psnr_v for r in results],
         ssim_y=[r.ssim_y for r in results], qp=[r.qp for r in results],
         k1_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if not ok_out:
        raise AssertionError(f"{name} output malformed")
    if max_depth:        # lookahead: fused; ME: the multi-size surface
        want = {"sad_sweep_best": len(frames), "sad_block8_sweep": n_p,
                "sad_block4_sweep": 0}
    else:                # lookahead and ME both fused
        want = {"sad_sweep_best": len(frames) + n_p, "sad_block8_sweep": 0,
                "sad_block4_sweep": 0}
    if launches != want:
        raise AssertionError(f"{name}: K1 launches {launches} != {want}")
    # the last P frame again: kernel path vs plain path, same inputs
    (y, u, v), ref = last_p
    yp = G.pad_plane(y, sess.coded_h, sess.coded_w)
    up = G.pad_plane(u, sess.coded_h // 2, sess.coded_w // 2)
    vp = G.pad_plane(v, sess.coded_h // 2, sess.coded_w // 2)
    qp = results[-1].qp
    out_k = sess.inter_encoder.encode_frame(yp, up, vp, *ref, qp)
    with plain_k1():
        out_p = sess.inter_encoder.encode_frame(yp, up, vp, *ref, qp)
    same = _same_decisions(out_k, out_p)
    emit(phase=f"{name}_p_frame_plain_rerun", identical=same)
    if not same:
        raise AssertionError(f"{name}: kernel and plain P-frame decisions "
                             "differ")
    return launches


def minigop_order(n: int, bframes: int = 3):
    """(POC, type) in coding order of n frames of a B session with the
    B-pyramid and b_adapt=0 (one GOP): the IDR, then each mini-GOP's P
    anchor, its referenced middle B and the other B frames."""
    order, prev = [(0, "I")], 0
    while prev < n - 1:
        k = min(bframes + 1, n - 1 - prev)
        order.append((prev + k, "P"))
        m = (k - 1) // 2 if k - 1 >= 2 else None
        if m is not None:
            order.append((prev + 1 + m, "B"))
        order += [(prev + 1 + i, "b") for i in range(k - 1) if i != m]
        prev += k
    return order


def phase_1080p_b(dev, name="1080p_qt2_b", opts=None,
                  n_frames=QT_B_FRAMES):
    """The quadtree B path at 1080p through push_frame / flush (qp 32,
    keyint 250, hash SEI, with opts over them, e.g. the in-loop filters,
    AQ or the rate control) over n_frames frames; returns its K1 launch
    counts and its fps, bytes, QPs and per-frame quality. With a per-CU
    QP map (AQ / cuTree) it also reports each frame's map statistics and
    checks that the plain rerun of the last b frame reproduces its map."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        FILTER_STAGES, VideoEncoderSession
    frames = synth_clip(n_frames, W1080, H1080)
    sess = VideoEncoderSession(W1080, H1080, device=dev, **dict(
        dict(qp=32, keyint=250, hash_sei=True, **B_KW), **(opts or {})))
    # record the inter program's calls, to rerun the last B frame, and
    # each frame's QP map (each frame's filter ms are its span totals)
    enc = sess.inter_encoder
    calls, run, maps = [], enc.encode_frame, []
    enc.encode_frame = lambda *a, **k: calls.append((a, k)) or run(*a, **k)
    qp_map_fn = sess._qp_map

    def qp_map(yp, qp):
        m = qp_map_fn(yp, qp)
        if m is not None:
            maps.append((qp, m, yp))
        return m
    sess._qp_map = qp_map
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, call_ms, per_call = [], [], []
    k1_start()                                    # the main path starts
    for fr in frames + [None]:
        t0 = time.perf_counter()
        got = sess.push_frame(*fr) if fr is not None else sess.flush()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append([[r.poc, r.frame_type] for r in got])
        results += got
    launches = k1_read()
    order = [(r.poc, r.frame_type) for r in results]
    total += sum(len(r.nals) for r in results)
    # frames after the IDR over the calls after the IDR's
    fps = (len(results) - 1) / (sum(call_ms[1:]) / 1e3)
    runs = {k: sum(r.frame_type in t for r in results)
            for k, t in (("intra", "I"), ("inter", "P"), ("inter_b", "Bb"),
                         ("serialize", "IPBb"), ("filters", "IPBb"),
                         ("qp_map", "IPBb"), ("rc", "IPBb"), ("me", "PBb"),
                         ("decide", "PBb"), ("commit", "PBb"),
                         ("fetch", "PBb"))}
    runs["lookahead"] = len(frames)
    quality = dict(frame_bytes=[len(r.nals) for r in results],
                   psnr_y=[r.psnr_y for r in results],
                   psnr_u=[r.psnr_u for r in results],
                   psnr_v=[r.psnr_v for r in results],
                   ssim_y=[r.ssim_y for r in results])
    extra = {}
    if maps:
        extra = dict(qp_map_stats=_qp_map_stats([m[:2] for m in maps]),
                     qp_map_ms=sess.stage_ms["qp_map"])
    stage = {k: v / max(runs[k], 1) for k, v in sess.stage_ms.items()}
    kbps = total * 8 / 1e3 / (len(results) / 25.0)
    emit(phase=name, max_depth=2, bframes=3, frames=len(results),
         opts=opts or {}, fps=fps, call_ms=call_ms, call_frames=per_call,
         stage_ms_per_frame=stage, bytes=total, kbps_at_25fps=kbps,
         qp=[r.qp for r in results],
         frame_type=[r.frame_type for r in results], k1_launches=launches,
         filters_ms_by_frame=[[r.frame_type, sum(r.stage_ms.get(k, 0.0)
                                                 for k in FILTER_STAGES)]
                              for r in results],
         max_memory_allocated=torch.cuda.max_memory_allocated(), **quality,
         **extra)
    psnr = quality["psnr_y"]
    want_order = minigop_order(len(frames))
    if order != want_order or not all(np.isfinite(psnr)) or not all(
            r.recon[0].shape == (H1080, W1080) for r in results):
        raise AssertionError(f"{name} output malformed: {order}")
    # the lookahead once per frame; one surface per P anchor, two per B
    n_p = sum(t == "P" for _, t in want_order)
    want = {"sad_sweep_best": len(frames),
            "sad_block8_sweep": n_p + 2 * (len(frames) - 1 - n_p),
            "sad_block4_sweep": 0}
    if launches != want:
        raise AssertionError(f"{name}: K1 launches {launches} != {want}")
    # the last B frame again: kernel path vs plain path, same inputs
    a, k = calls[-1]
    if k.get("ref1") is None:
        raise AssertionError(f"{name}: the last inter call is not a B frame")
    out_k = run(*a, **k)
    if opts and opts.get("sao") and "sao" not in out_k:
        raise AssertionError(f"{name}: the B frame has no SAO parameters")
    with plain_k1():
        out_p = run(*a, **k)
        same_map = True
        if maps:
            qp, m, yp = maps[-1]
            same_map = np.array_equal(qp_map_fn(yp, qp), m) and \
                np.array_equal(np.asarray(a[6]), m)
    same = _same_decisions(out_k, out_p)
    emit(phase=f"{name}_b_frame_plain_rerun", identical=same,
         qp_map_identical=same_map,
         pdir_counts={int(d): int(c) for d, c in zip(*np.unique(
             out_k["pdir8"], return_counts=True))})
    if not (same and same_map):
        raise AssertionError(f"{name}: kernel and plain B-frame decisions "
                             "or QP maps differ")
    return launches, dict(fps=fps, bytes=total, kbps_at_25fps=kbps,
                          qp=[r.qp for r in results],
                          frame_type=[r.frame_type for r in results],
                          stage_ms_per_frame=stage, **quality)


def scenecut_clip():
    """tests/test_scenecut_aware_qp.py's clip (copied): 10 frames of
    noise, the cut at frame 2."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 80, (48, 64)).astype(np.uint8)
    b = rng.integers(150, 256, (48, 64)).astype(np.uint8)
    u = np.full((24, 32), 128, np.uint8)
    return [(a, u, u)] * 2 + [(b, u, u)] * 8


def phase_golden_rc(dev):
    """The rate-controlled sessions on the card: the uniform IPPP streams
    (RC_PINS), two-pass (RC_TWO_PASS_PINS: pass 1's stats and sidecar, the
    pass-2 stream) and the quadtree B streams with their QPs (RC_B_PINS),
    each against the JAX package's md5."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    got = {}

    def check(key, md5, want):
        got[key] = md5
        got[key + "_match"] = md5 == want

    def encode(kw, frames):
        s = VideoEncoderSession(64, 48, device=dev, **kw)
        res = push_all(s, frames) if s.bframes else \
            [s.encode_frame(*f) for f in frames]
        return _md5_of(s, res), [r.qp for r in res], s

    for name, (kw, want) in RC_PINS.items():
        md5, got[name + "_qp"], _ = encode(
            kw, scenecut_clip() if "scenecut" in name else golden_clip())
        check(name, md5, want)
    with tempfile.TemporaryDirectory(dir=REPO) as d:
        path = os.path.join(d, "pass1.log")
        s = encode(dict(RC_TWO_PASS, cutree=True, stats_write=path),
                   golden_clip())[2]
        s.stats_writer.close()
        with open(path, "rb") as f, open(path + ".cutree", "rb") as c:
            check("two_pass_stats", hashlib.md5(f.read() + c.read())
                  .hexdigest(), RC_TWO_PASS_PINS["stats"])
        md5, got["two_pass_pass2_qp"], _ = encode(
            dict(RC_TWO_PASS, stats_read=path), golden_clip())
        check("two_pass_pass2", md5, RC_TWO_PASS_PINS["pass2"])
    for name, (kw, want, qps) in RC_B_PINS.items():
        md5, got[name + "_qp"], _ = encode(kw, golden_clip(n=8))
        check(name, md5, want)
        got[name + "_qp_match"] = got[name + "_qp"] == qps
    emit(phase="golden_rc", **got)
    bad = [k for k in got if k.endswith("_match") and not got[k]]
    if bad:
        raise AssertionError(f"rate-control md5s or QPs differ: {bad}")


def phase_rc_cpu_vs_card(dev, n=3):
    """The 416x240 quadtree B session with the flagship's tools under CRF
    28 (and the hash SEI), on the card and on the CPU: equal streams and
    QPs."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    frames = synth_clip(n, 416, 240)
    md5, qps, secs = {}, {}, {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        sess = VideoEncoderSession(416, 240, device=where, **dict(
            FLAG, rc_mode="crf", crf=28.0, hash_sei=True))
        res = push_all(sess, frames)
        md5[str(where)] = _md5_of(sess, res)
        qps[str(where)] = [r.qp for r in res]
        secs[str(where)] = time.perf_counter() - t0
    same = len(set(md5.values())) == 1 and qps[str(dev)] == qps["cpu"]
    emit(phase="rc_cpu_vs_card", session="qt2_b_flagship_crf28", frames=n,
         md5=md5, qp=qps, seconds=secs, equal=same)
    if not same:
        raise AssertionError(f"416x240 CRF B streams differ: {md5} {qps}")


def phase_golden_flagship(dev, n=3):
    """The flagship session and its variants on the card against the
    JAX package's md5s and (POC, type, QP) (tests/flagship_pins.py), then
    the flagship constructor over a 416x240 clip of n frames on the card
    and on the CPU: equal streams and frame lists."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    from x265_yuuki_asuna_tpu_torch.profile_1080p import FLAGSHIP
    pins = flagship_pins()
    got = {}
    for name, extra in pins.SESSIONS.items():
        sess = VideoEncoderSession(pins.W, pins.H, device=dev,
                                   **dict(FLAGSHIP, **extra))
        res = push_all(sess, pins.clip())
        got[name] = _md5_of(sess, res)
        got[name + "_frames"] = [(r.poc, r.frame_type, r.qp) for r in res]
        got[name + "_match"] = (got[name], got[name + "_frames"]) == \
            pins.PINS[name]
    frames = synth_clip(n, 416, 240)
    md5, order, secs = {}, {}, {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        sess = VideoEncoderSession(416, 240, device=where, **FLAGSHIP)
        res = push_all(sess, frames)
        md5[str(where)] = _md5_of(sess, res)
        order[str(where)] = [(r.poc, r.frame_type, r.qp) for r in res]
        secs[str(where)] = time.perf_counter() - t0
    got["cpu_vs_card_match"] = len(set(md5.values())) == 1 and \
        order[str(dev)] == order["cpu"]
    emit(phase="golden_flagship", **got, cpu_vs_card_md5=md5,
         cpu_vs_card_frames=order[str(dev)], cpu_vs_card_seconds=secs)
    bad = [k for k in got if k.endswith("_match") and not got[k]]
    if bad:
        raise AssertionError(f"flagship md5s or frames differ: {bad}")


def phase_1080p_flagship(dev, n_frames=FLAGSHIP_FRAMES):
    """bench.py's constructor verbatim at 1080p over synth_clip, through
    push_frame / flush: fps, the mini-GOP lengths b-adapt chose, QPs,
    bytes, stage ms, the share of blocks whose integer winner was HME's
    coarse MV, K1's launches by entry (fused: the lookahead's one per
    frame and the trellis's K + K(K-1)/2 per decision; each surface: one
    per P anchor and two per B frame), peak memory; then the last B frame
    again with every K1 entry patched to its plain version, whose
    decision dict must be identical."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    from x265_yuuki_asuna_tpu_torch.profile_1080p import FLAGSHIP
    frames = synth_clip(n_frames, W1080, H1080)
    sess = VideoEncoderSession(W1080, H1080, device=dev, **FLAGSHIP)
    enc = sess.inter_encoder
    calls, run, trellis = [], enc.encode_frame, []
    enc.encode_frame = lambda *a, **k: calls.append((a, k)) or run(*a, **k)
    costs_fn = sess.lookahead.badapt_path_costs

    def badapt(anchor, lows):
        trellis.append(len(lows))
        return costs_fn(anchor, lows)
    sess.lookahead.badapt_path_costs = badapt
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_start()                                    # the main path starts
    results, call_ms = [], []
    with flagship_pins().coarse_mvs_counted() as coarse:
        for fr in frames + [None]:
            t0 = time.perf_counter()
            got = sess.push_frame(*fr) if fr is not None else sess.flush()
            call_ms.append((time.perf_counter() - t0) * 1e3)
            results += got
    torch.cuda.synchronize()
    launches = k1_read()
    order = [(r.poc, r.frame_type) for r in results]
    anchors = [p for p, t in order if t in "IP"]
    gops = [b - a for a, b in zip(anchors, anchors[1:])]
    total += sum(len(r.nals) for r in results)
    n_p = sum(t == "P" for _, t in order)
    n_b = sum(t in "Bb" for _, t in order)
    fps = (len(results) - 1) / (sum(call_ms[1:]) / 1e3)
    runs = {"inter": n_p, "inter_b": n_b, "intra": len(results) - n_p - n_b}
    stage = {k: v / max(runs.get(k, len(results)), 1)
             for k, v in sess.stage_ms.items()}
    emit(phase="1080p_flagship", frames=len(results), fps=fps,
         call_ms=call_ms, minigop_lengths=gops, trellis_sizes=trellis,
         frame_type=[t for _, t in order], poc=[p for p, _ in order],
         qp=[r.qp for r in results], bytes=total,
         frame_bytes=[len(r.nals) for r in results],
         kbps_at_25fps=total * 8 / 1e3 / (len(results) / 25.0),
         stage_ms_per_frame=stage, stage_ms_total=dict(sess.stage_ms),
         hme_coarse_share=float(coarse["taken"]) / max(coarse["blocks"], 1),
         hme_blocks=coarse["blocks"],
         k1_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if len(results) != n_frames or order[0] != (0, "I") or any(
            r.recon is not None or r.psnr_y != 0.0 for r in results):
        raise AssertionError(f"1080p_flagship output malformed: {order}")
    want = {"sad_sweep_best": n_frames + sum(k + k * (k - 1) // 2
                                             for k in trellis),
            "sad_block8_sweep": n_p + 2 * n_b,
            "sad_block4_sweep": n_p + 2 * n_b}
    if launches != want:
        raise AssertionError(f"1080p_flagship: K1 launches {launches} != "
                             f"{want}")
    a, k = calls[-1]
    if k.get("ref1") is None:
        raise AssertionError("1080p_flagship: the last inter call is not "
                             "a B frame")
    out_k = run(*a, **k)
    with plain_k1():
        out_p = run(*a, **k)
    same = _same_decisions(out_k, out_p)
    emit(phase="1080p_flagship_b_frame_plain_rerun", identical=same)
    if not same:
        raise AssertionError("1080p_flagship: kernel and plain B-frame "
                             "decisions differ")
    return launches


def phase_1080p_abr_vbv(dev, n_frames=7, kbps=27000):
    """The uniform IPPP path at 1080p under ABR at kbps with VBV (maxrate
    kbps, a buffer of one second) and the HRD: per frame its bits, QP,
    VBV overshoot(s) and the buffer's fill after it; the re-encodes and
    their wall time; kbps against the target; K1's fused launches (one
    lookahead sweep per frame, one ME sweep per P-frame program call)."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    frames = synth_clip(n_frames, W1080, H1080)
    sess = VideoEncoderSession(
        W1080, H1080, qp=32, keyint=250, hash_sei=True, device=dev,
        rc_mode="abr", bitrate_kbps=kbps, vbv_maxrate_kbps=kbps,
        vbv_bufsize_kbps=kbps, hrd=True)
    over, calls = [], []
    orig = sess.rc.vbv_overshoot
    sess.rc.vbv_overshoot = lambda bits: over.append(orig(bits)) or over[-1]
    for stage in ("_code_idr", "_code_p"):
        fn = getattr(sess, stage)

        def timed(*a, fn=fn, stage=stage, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            calls[-1].append((stage, (time.perf_counter() - t0) * 1e3))
            return out
        setattr(sess, stage, timed)
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, t_frames, fill, overs = [], [], [], []
    k1_start()                                    # the main path starts
    for fr in frames:
        calls.append([])
        n_over = len(over)
        t0 = time.perf_counter()
        results.append(sess.encode_frame(*fr))
        t_frames.append(time.perf_counter() - t0)
        fill.append(sess.rc.buffer_fill)
        overs.append(over[n_over:])
    launches = k1_read()
    total += sum(len(r.nals) for r in results)
    reencodes = sum(len(c) - 1 for c in calls)
    got_kbps = total * 8 / 1e3 / (len(results) / 25.0)
    emit(phase="1080p_abr_vbv", frames=len(results), target_kbps=kbps,
         vbv_maxrate_kbps=kbps, vbv_bufsize_kbps=kbps, hrd=True,
         fps=(len(frames) - 1) / sum(t_frames[1:]),
         frame_ms=[t * 1e3 for t in t_frames],
         frame_bits=[r.bits for r in results], qp=[r.qp for r in results],
         frame_type=[r.frame_type for r in results],
         buffer_fill_after=fill, vbv_overshoot=overs,
         vbv_reencodes=reencodes,
         vbv_reencode_ms=sum(ms for c in calls for _, ms in c[1:]),
         kbps_at_25fps=got_kbps, kbps_over_target=got_kbps / kbps,
         stage_ms_per_frame={k: v / len(results)
                             for k, v in sess.stage_ms.items()},
         psnr_y=[r.psnr_y for r in results],
         psnr_u=[r.psnr_u for r in results],
         psnr_v=[r.psnr_v for r in results],
         ssim_y=[r.ssim_y for r in results], k1_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if [r.frame_type for r in results] != ["I"] + ["P"] * (n_frames - 1) \
            or not all(np.isfinite([r.psnr_y, r.psnr_u, r.psnr_v, r.ssim_y])
                       .all() and r.recon[0].shape == (H1080, W1080)
                       for r in results) or sess.sps.hrd is None:
        raise AssertionError("1080p_abr_vbv output malformed")
    p_calls = sum(stage == "_code_p" for c in calls for stage, _ in c)
    want = {"sad_sweep_best": n_frames + p_calls, "sad_block8_sweep": 0,
            "sad_block4_sweep": 0}
    if launches != want:
        raise AssertionError(f"1080p_abr_vbv: K1 launches {launches} != "
                             f"{want}")
    return launches


def phase_1080p_aq_la(dev, n_frames=5):
    """The uniform IPPP path at 1080p with AQ 2, cuTree and the
    rc-lookahead window (rc_lookahead=3) through push_la / flush_la: fps,
    the QP maps, K1's fused launches (one lookahead sweep per frame, one
    ME sweep per P frame), quality; then its last P frame again with K1's
    plain versions: identical decisions."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    frames = synth_clip(n_frames, W1080, H1080)
    sess = VideoEncoderSession(W1080, H1080, qp=32, keyint=250,
                               hash_sei=True, rc_lookahead=3, device=dev,
                               **AQ)
    enc = sess.inter_encoder
    calls, run, maps = [], enc.encode_frame, []
    enc.encode_frame = lambda *a, **k: calls.append((a, k)) or run(*a, **k)
    qp_map_fn = sess._qp_map
    sess._qp_map = lambda yp, qp: maps.append(
        (qp, qp_map_fn(yp, qp))) or maps[-1][1]
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, call_ms, per_call = [], [], []
    k1_start()                                    # the main path starts
    for fr in frames + [None]:
        t0 = time.perf_counter()
        got = sess.push_la(*fr) if fr is not None else sess.flush_la()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append([[r.poc, r.frame_type] for r in got])
        results += got
    launches = k1_read()
    total += sum(len(r.nals) for r in results)
    first = next(i for i, c in enumerate(per_call) if c)   # the IDR's call
    fps = (len(results) - 1) / (sum(call_ms[first + 1:]) / 1e3)
    n_p = sum(r.frame_type == "P" for r in results)
    emit(phase="1080p_aq_la", frames=len(results), p_frames=n_p,
         rc_lookahead=3, opts=AQ, fps=fps, call_ms=call_ms,
         call_frames=per_call,
         stage_ms_per_frame={k: v / len(results)
                             for k, v in sess.stage_ms.items()},
         qp_map_ms=sess.stage_ms["qp_map"],
         qp_map_stats=_qp_map_stats(maps), bytes=total,
         frame_bytes=[len(r.nals) for r in results],
         psnr_y=[r.psnr_y for r in results],
         psnr_u=[r.psnr_u for r in results],
         psnr_v=[r.psnr_v for r in results],
         ssim_y=[r.ssim_y for r in results], qp=[r.qp for r in results],
         k1_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if [r.frame_type for r in results] != ["I"] + ["P"] * (n_frames - 1) \
            or not all(np.isfinite([r.psnr_y, r.psnr_u, r.psnr_v, r.ssim_y])
                       .all() and r.recon[0].shape == (H1080, W1080)
                       for r in results):
        raise AssertionError("1080p_aq_la output malformed")
    want = {"sad_sweep_best": n_frames + n_p, "sad_block8_sweep": 0,
            "sad_block4_sweep": 0}
    if launches != want:
        raise AssertionError(f"1080p_aq_la: K1 launches {launches} != "
                             f"{want}")
    a, k = calls[-1]
    out_k = run(*a, **k)
    with plain_k1():
        out_p = run(*a, **k)
    same = _same_decisions(out_k, out_p)
    emit(phase="1080p_aq_la_p_frame_plain_rerun", identical=same)
    if not same:
        raise AssertionError("1080p_aq_la: kernel and plain P-frame "
                             "decisions differ")
    return launches


def preset_pins():
    """tests/preset_pins.py: the CLI's and the library's 96x64 test clip
    and the JAX package's pins over it."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import preset_pins as pins
    return pins


def grid_pins():
    """tests/grid_pins.py: the depth-1 quadtree's and the uniform grid's B
    sessions over the golden clip, their golden configurations and the
    JAX package's pins over them."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import grid_pins as pins
    return pins


def weightp_pins():
    """tests/weightp_pins.py: weighted prediction's and the host-filter
    path's test clips (fades) and sessions, the JAX package's pins over
    them and the recorder of the weights a session chooses."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import weightp_pins as pins
    return pins


def phase_golden_weightp(dev):
    """Weighted prediction's pins on the card: the golden ippp_weightp
    stream (the uniform grid), the quadtree sessions of
    tests/weightp_pins.py (weighted IPPP with and without HME, the
    weighted B session with the host-form filters, the host-filter path
    without weightp under AQ, and the unweighted twin) against the JAX
    package's md5s, (POC, type, QP) and chosen weights, the library at
    param_default_preset("medium") (tests/preset_pins.py) and the command
    line with no preset flag over a 416x240 fade (CLI_FADE_PIN); the
    CLI's weighted pins over the 96x64 clip run in golden_cli."""
    from x265_yuuki_asuna_tpu_torch import api, cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    wp, pp = weightp_pins(), preset_pins()
    with open(os.path.join(REPO, "tests", "golden", "manifest.json")) as f:
        want = json.load(f)["ippp_weightp"]
    sess = top.VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                                   weightp=True, hash_sei=False, device=dev)
    with wp.weights_recorded(top.VideoEncoderSession) as weights:
        out = sess.headers() + b"".join(
            sess.encode_frame(*f).nals for f in wp.golden_fade(6))
    got = {"ippp_weightp": hashlib.md5(out).hexdigest()}
    ok = {"ippp_weightp": got["ippp_weightp"] == want}
    chosen = {"ippp_weightp": weights}
    for name in wp.SESSIONS:
        res = wp.encode(top, name, device=dev)
        got[name], chosen[name] = res[0], res[2]
        ok[name] = res == wp.PINS[name]
    with wp.weights_recorded(top.VideoEncoderSession) as weights:
        res = pp.run_api(api, "medium")
    got["api_medium"], chosen["api_medium"] = res[0], weights
    ok["api_medium"] = res == pp.API_MEDIUM_PIN and \
        weights == pp.WEIGHTS["api_medium"]
    with tempfile.TemporaryDirectory() as tmp:
        res = wp.run_cli_fade(cli.main, tmp)
    got["cli_fade_416x240"] = res[0]
    ok["cli_fade_416x240"] = res == wp.CLI_FADE_PIN
    emit(phase="golden_weightp", md5=got, weights=chosen, match=ok)
    if not all(ok.values()):
        raise AssertionError(f"golden_weightp: streams differ: {ok}")


def phase_weightp_cpu_vs_card(dev, n=3):
    """The command line with no preset flag (x265's medium: weighted
    prediction, so the host-filter quadtree path) on a 416x240 clip of n
    frames whose luma falls by 6 a frame, on the card and with
    device="cpu": equal streams and CSV logs; then the same clip at
    --preset medium --no-weightp on the card, for the bytes weighted
    prediction saves."""
    from x265_yuuki_asuna_tpu_torch import cli
    md5, csv, secs, size = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        _write_y4m(src, weightp_pins().synth_fade(n, 416, 240))
        for tag, where, flags in (("card", None, []), ("cpu", "cpu", []),
                                  ("card_no_weightp", None,
                                   ["--preset", "medium", "--no-weightp"])):
            dst, log = os.path.join(tmp, tag + ".hevc"), \
                os.path.join(tmp, tag + ".csv")
            t0 = time.perf_counter()
            rc = cli.main([src, "-o", dst, "--csv", log] + flags,
                          device=where)
            secs[tag] = time.perf_counter() - t0
            with open(dst, "rb") as f:
                data = f.read()
            md5[tag], size[tag] = hashlib.md5(data).hexdigest(), len(data)
            with open(log) as f:
                csv[tag] = f.read().splitlines()
            if rc != 0:
                raise AssertionError(f"weightp_cpu_vs_card: rc {rc} ({tag})")
    same = md5["card"] == md5["cpu"] and csv["card"] == csv["cpu"]
    emit(phase="weightp_cpu_vs_card", frames=n, md5=md5, csv=csv["card"],
         csv_no_weightp=csv["card_no_weightp"], seconds=secs, bytes=size,
         bytes_change_weightp=size["card"] / size["card_no_weightp"] - 1,
         match=same)
    if not same:
        raise AssertionError("weightp_cpu_vs_card: the card's stream or "
                             "CSV differs from the CPU's")


def phase_golden_cli(dev):
    """The golden intra_qt2_psy stream (psy-rd 1 on the all-intra
    quadtree), then the command line and the library on the card against
    the JAX package's pins (tests/preset_pins.py): --preset superfast
    (psy-rd, intra in B slices), the same with --keyint 4 (the open GOP's
    CRA and RASL_N pictures), --preset medium --no-weightp, no preset
    flag and --preset veryfast (weighted prediction, over the faded
    clip), and the library at param_default_preset("superfast") (search
    range 24): stream md5s, NAL types and CSV logs."""
    from x265_yuuki_asuna_tpu_torch import api, cli
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        IntraEncoderSession
    with open(os.path.join(REPO, "tests", "golden", "manifest.json")) as f:
        want = json.load(f)["intra_qt2_psy"]
    sess = IntraEncoderSession(64, 48, qp=30, max_depth=2, psy_rd=1.0,
                               hash_sei=False, device=dev)
    out = sess.headers()
    for fr in golden_clip():
        out += sess.encode_frame(*fr).nals
    got = {"intra_qt2_psy": hashlib.md5(out).hexdigest()}
    ok = {"intra_qt2_psy": got["intra_qt2_psy"] == want}
    pins = preset_pins()
    with tempfile.TemporaryDirectory() as tmp:
        for name in pins.CLI:
            res = pins.run_cli(cli.main, name, tmp)
            got[name] = res[0]
            ok[name] = res == pins.CLI_PINS[name]
    res = pins.run_api(api)
    got["api_superfast"] = res[0]
    ok["api_superfast"] = res == pins.API_PIN
    res = pins.run_api(api, "ultrafast")
    got["api_ultrafast"] = res[0]
    ok["api_ultrafast"] = res == pins.API_ULTRAFAST_PIN
    emit(phase="golden_cli", md5=got, match=ok)
    if not all(ok.values()):
        raise AssertionError(f"golden_cli: streams differ: {ok}")


def phase_golden_grids(dev):
    """The two grids this slice adds, on the card (tests/grid_pins.py):
    golden_qt1, the golden intra_qt1 stream (the depth-1 intra session)
    and the depth-1 video sessions (IPPP, B-pyramid, filtered on the
    device chain and on the host-filter path under weightp and under AQ)
    against the JAX package's md5s, (POC, type, QP) and NAL types; then
    golden_uniform_b, the goldens bframes3_pyramid, bframes_badapt and
    open_gop and the uniform B sessions (filters with AQ 2, open GOP with
    a RASL_N picture) against theirs."""
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    pins = grid_pins()
    got = {"intra_qt1": pins.golden_md5(top, "intra_qt1", device=dev)}
    ok = {"intra_qt1": got["intra_qt1"] == pins.manifest("intra_qt1")}
    for name in pins.QT1_SESSIONS:
        stream, frames = pins.run_qt1(top, name, device=dev)
        got[name] = pins.qt1_pin_of(stream, frames, name)
        ok[name] = got[name] == pins.QT1_PINS[name] and \
            pins.nal_types(stream) == pins.QT1_NALS[name]
    emit(phase="golden_qt1", md5=got, match=ok)
    if not all(ok.values()):
        raise AssertionError(f"golden_qt1: streams differ: {ok}")
    got, ok = {}, {}
    for name in ("bframes3_pyramid", "bframes_badapt", "open_gop"):
        got[name] = pins.golden_md5(top, name, device=dev)
        ok[name] = got[name] == pins.manifest(name)
    for name in pins.UNI_B_SESSIONS:
        got[name] = pins.run_uni_b(top, name, device=dev)
        ok[name] = got[name] == pins.UNI_B_PINS[name]
    emit(phase="golden_uniform_b", md5=got, match=ok)
    if not all(ok.values()):
        raise AssertionError(f"golden_uniform_b: streams differ: {ok}")


def main10_pins():
    """tests/main10_pins.py: the 10- and 12-bit clips, sessions and
    command lines and the JAX package's pins over them."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import main10_pins as pins
    return pins


def deep10(frames):
    """synth_clip's frames at 10 bits: every sample times 4, as uint16."""
    return [tuple(p.astype(np.uint16) * 4 for p in f) for f in frames]


def phase_golden_main10(dev):
    """Main10 / Main12 on the card (tests/main10_pins.py): the golden
    intra_main10 stream, the 10-bit sessions (the uniform grid's IPPP
    and B frames with both filters, the depth-1 and depth-2 quadtree's I,
    P and B frames with the device filter chain, sign hiding and RDOQ,
    weighted prediction on the host-filter path, the flagship's tools
    with HME, b-adapt 2, AQ, cuTree and CRF, and with the histogram scene
    cut) and the two 12-bit ones, then the command line over a 10-bit
    y4m with no preset flag, at superfast, at ultrafast and all-intra,
    against the JAX package's md5s, (POC, type, QP), NAL types and CSV
    logs; K1's launches on their int16 planes."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    pins = main10_pins()
    k1_start()
    got = {"intra_main10": pins.golden_md5(top, device=dev)}
    ok = {"intra_main10": got["intra_main10"] == grid_pins().manifest(
        "intra_main10")}
    for name in pins.SESSIONS:
        md5, frames, _ = pins.run(top, name, device=dev)
        got[name] = md5
        ok[name] = (md5, frames) == pins.PINS[name]
    with tempfile.TemporaryDirectory() as tmp:
        for name in pins.CLI:
            res = pins.run_cli(cli.main, name, tmp)
            got["cli_" + name] = res[0]
            ok["cli_" + name] = res == pins.CLI_PINS[name]
    launches = k1_read()
    emit(phase="golden_main10", md5=got, match=ok, k1_launches=launches)
    if not all(ok.values()):
        raise AssertionError(f"golden_main10: streams differ: {ok}")
    return launches


def _write_y4m(path, frames, bit_depth=8):
    from x265_yuuki_asuna_tpu_torch.utils import io as IO
    h, w = frames[0][0].shape
    wr = IO.Y4MWriter(path, IO.VideoInfo(w, h, 25, 1, IO.CSP_I420,
                                         bit_depth))
    for fr in frames:
        wr.write_frame(*fr)
    wr.close()


def phase_cli_cpu_vs_card(dev, n=3, phase="cli_cpu_vs_card",
                          argv=("--preset", "medium", "--no-weightp"),
                          bit_depth=8):
    """The command line with argv (by default --preset medium --no-weightp:
    SAO, AQ 2, cuTree, b-adapt 2, bframes 4, psy-rd, intra in B slices;
    ultrafast_cpu_vs_card: --preset ultrafast, the depth-1 quadtree with
    HME; main10_cpu_vs_card: no flag, x265's default, over the clip at 10
    bits) on a 416x240 clip of n frames, on the card and with
    device="cpu": equal streams and CSV logs."""
    from x265_yuuki_asuna_tpu_torch import cli
    md5, csv, secs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        clip = synth_clip(n, 416, 240)
        _write_y4m(src, deep10(clip) if bit_depth == 10 else clip,
                   bit_depth)
        for where in (None, "cpu"):
            tag = "cpu" if where else "card"
            dst, log = os.path.join(tmp, tag + ".hevc"), \
                os.path.join(tmp, tag + ".csv")
            t0 = time.perf_counter()
            rc = cli.main([src, "-o", dst, *argv, "--csv", log],
                          device=where)
            secs[tag] = time.perf_counter() - t0
            with open(dst, "rb") as f:
                md5[tag] = hashlib.md5(f.read()).hexdigest()
            with open(log) as f:
                csv[tag] = f.read().splitlines()
            if rc != 0:
                raise AssertionError(f"{phase}: rc {rc} ({tag})")
    same = md5["card"] == md5["cpu"] and csv["card"] == csv["cpu"]
    emit(phase=phase, argv=" ".join(argv), bit_depth=bit_depth, frames=n,
         md5=md5,
         csv=csv["card"], seconds=secs, match=same)
    if not same:
        raise AssertionError(f"{phase}: the card's stream or CSV differs "
                             "from the CPU's")


class _Instrumented:
    """A video session's push_frame / flush (with ippp, its encode_frame)
    timed and its results kept, with each call's stage ms; its inter
    program's calls recorded (to rerun the last P and B frame), with the
    share of CUs a two-reference P program put on index 1; and the
    b-adapt trellis sizes counted."""

    def __init__(self, sess, ippp: bool = False):
        self.sess, self.call_ms, self.results = sess, [], []
        self.calls, enc = [], sess.inter_encoder
        self.run = enc.encode_frame
        # each inter program call's K1 launches: ("P" or "B", counts)
        self.k1_calls = []
        self.stage_calls, self.ref1_share = [], []

        def recorded(*a, **k):
            self.calls.append((a, k))
            before = k1_read()
            out = self.run(*a, **k)
            self.k1_calls.append((
                "B" if k.get("ref1") is not None else "P",
                {n: c - before[n] for n, c in k1_read().items()}))
            if out.get("ref") is not None:
                self.ref1_share.append(float(np.mean(out["ref"])))
            return out
        enc.encode_frame = recorded
        self.trellis, costs = [], sess.lookahead.badapt_path_costs

        def badapt(anchor, lows):
            self.trellis.append(len(lows))
            return costs(anchor, lows)
        sess.lookahead.badapt_path_costs = badapt
        for name in ("push_frame", "flush") + (("encode_frame",) if ippp
                                               else ()):
            setattr(sess, name, self._timed(getattr(sess, name),
                                            name == "encode_frame"))

    def _timed(self, fn, one: bool = False):
        def call(*a):
            torch.cuda.synchronize()
            before = dict(self.sess.stage_ms)
            t0 = time.perf_counter()
            got = fn(*a)
            torch.cuda.synchronize()
            self.call_ms.append((time.perf_counter() - t0) * 1e3)
            self.stage_calls.append({k: v - before.get(k, 0.0) for k, v in
                                     self.sess.stage_ms.items()})
            self.results += [got] if one else got
            return got
        return call

    def last(self, bi: bool):
        """The last inter call of a B (bi) or a P frame."""
        return next((a, k) for a, k in reversed(self.calls)
                    if (k.get("ref1") is not None) == bi)

    def report(self):
        """(fps after the IDR, frames' (POC, type), per-stage ms per frame
        that runs the stage, K1 counts a B session must launch)."""
        res = self.results
        order = [(r.poc, r.frame_type) for r in res]
        fps = (len(res) - 1) / (sum(self.call_ms[1:]) / 1e3)
        n_p = sum(t == "P" for _, t in order)
        n_b = sum(t in "Bb" for _, t in order)
        runs = {"inter": n_p, "inter_b": n_b,
                "intra": len(res) - n_p - n_b}
        stage = {k: v / max(runs.get(k, len(res)), 1)
                 for k, v in self.sess.stage_ms.items()}
        want = {"sad_sweep_best": len(res) + sum(
                    k + k * (k - 1) // 2 for k in self.trellis),
                "sad_block8_sweep": n_p + 2 * n_b,
                "sad_block4_sweep": 0}
        return fps, order, stage, want


    def k1_by_frame_type(self) -> dict:
        """K1's launches of each inter program call, by frame type (the
        distinct counts seen; one each on a fixed configuration)."""
        out = {}
        for t, c in self.k1_calls:
            if c not in out.setdefault(t, []):
                out[t].append(c)
        return out


def _plain_rerun(name, inst, bi: bool = True):
    """The last B (bi) or P frame again with every K1 entry plain:
    identical."""
    a, k = inst.last(bi)
    out_k = inst.run(*a, **k)
    with plain_k1():
        out_p = inst.run(*a, **k)
    same = _same_decisions(out_k, out_p)
    kind = "B" if bi else "P"
    emit(phase=f"{name}_{kind.lower()}_frame_plain_rerun", identical=same)
    if not same:
        raise AssertionError(f"{name}: kernel and plain {kind}-frame "
                             "decisions differ")


def _turns_ms(fn, set_on, turns=2):
    """Wall ms of fn() with an option on and off, in turns (on, off, off,
    on, ...): {True: [...], False: [...]}."""
    ms = {True: [], False: []}
    for i in range(turns):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            set_on(on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[on].append((time.perf_counter() - t0) * 1e3)
    set_on(True)
    return ms


def phase_1080p_cli_superfast(dev, n_frames=SUPERFAST_FRAMES):
    """The command line at --preset superfast over a 1080p y4m of
    synth_clip (n_frames frames: the IDR and fixed mini-GOPs of 4):
    fps after the IDR, each frame's type, POC, QP and bytes from the CSV
    log, stage ms per frame, peak memory and K1's launches (fused: one
    lookahead sweep per frame; the surface: one per P anchor, two per B
    frame), then on the last B frame: its launches with and without
    intra candidates (torch.profiler), its program's ms with and without
    psy-rd in turns (and the last P anchor's once each), and its plain
    rerun, which must be identical."""
    from x265_yuuki_asuna_tpu_torch import cli
    frames = synth_clip(n_frames, W1080, H1080)
    made = []
    configure = cli.configure

    def instrumented(*a, **k):
        made.append(_Instrumented(configure(*a, **k)))
        return made[-1].sess
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "o.hevc")
        log = os.path.join(tmp, "log.csv")
        _write_y4m(src, frames)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1_start()                                # the main path starts
        with mock.patch.object(cli, "configure", instrumented):
            rc = cli.main([src, "-o", dst, "--preset", "superfast",
                           "--frames", str(n_frames), "--csv", log])
        launches = k1_read()
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rows = [r.split(", ") for r in f.read().splitlines()[1:-1]]
        total = os.path.getsize(dst)
    inst = made[0]
    fps, order, stage, want = inst.report()
    enc = inst.sess.inter_encoder
    a, k = inst.last(True)
    b_launches = {}
    for on in (True, False):
        enc.b_intra = on
        b_launches["with_b_intra" if on else "without_b_intra"] = \
            _launches(lambda: inst.run(*a, **k))
    enc.b_intra = True
    psy = lambda on: setattr(enc, "psy_rd", 2.0 if on else 0.0)
    b_psy = _turns_ms(lambda: inst.run(*a, **k), psy, turns=1)
    ap, kp = inst.last(False)
    p_psy = _turns_ms(lambda: inst.run(*ap, **kp), psy, turns=1)
    emit(phase="1080p_cli_superfast", argv="--preset superfast",
         rc=rc, frames=len(rows), fps=fps, call_ms=inst.call_ms,
         frame_type=[r[1] for r in rows], poc=[int(r[2]) for r in rows],
         qp=[int(r[3]) for r in rows],
         frame_bytes=[int(r[4]) // 8 for r in rows], bytes=total,
         psnr_y=[float(r[5]) for r in rows],
         coding_order=order, stage_ms_per_frame=stage,
         stage_ms_total=dict(inst.sess.stage_ms), k1_launches=launches,
         b_frame_launches=b_launches, b_frame_ms_psy_turns=b_psy,
         p_anchor_ms_psy_turns=p_psy, max_memory_allocated=peak)
    if rc != 0 or order != minigop_order(n_frames) or len(rows) != n_frames \
            or not all(np.isfinite(float(r[5])) for r in rows):
        raise AssertionError(f"1080p_cli_superfast output malformed: "
                             f"{order}")
    if launches != want:
        raise AssertionError(f"1080p_cli_superfast: K1 launches "
                             f"{launches} != {want}")
    _plain_rerun("1080p_cli_superfast", inst)
    return launches


def phase_1080p_cli_medium(dev, n_frames=MEDIUM_FRAMES):
    """The command line as a user calls it, with no preset flag (x265's
    medium: weighted prediction on the host-filter quadtree path, SAO, AQ
    2, cuTree, b-adapt 2, bframes 4, psy-rd, intra in B slices, CRF 28),
    over a 1080p y4m of synth_clip whose luma falls by 6 a frame (n_frames
    frames, --csv-log-level 2): fps after the IDR, each frame's type, POC,
    QP and bytes, the weights each P anchor chose (non-identity luma
    required), each coded frame's stage ms (deblock and SAO apart), the
    CSV's level-2 columns (each burst of frames' stages on the first
    frame written after it, as the reference's CLI logs them), peak
    memory and K1's launches
    (fused: the lookahead's per frame and the trellis's; the surface one
    per P anchor, two per B frame), then the last weighted P anchor's
    plain rerun, which must be identical."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    frames = weightp_pins().synth_fade(n_frames, W1080, H1080)
    made, per_frame = [], []
    configure = cli.configure

    def instrumented(*a, **k):
        made.append(_Instrumented(configure(*a, **k)))
        sess, finish, prev = made[-1].sess, made[-1].sess._finish, {}

        def finished(*fa, **fk):
            # each coded frame's stage ms (coding order): the session's
            # stages since the frame before it finished
            r = finish(*fa, **fk)
            cur = dict(sess.stage_ms)
            per_frame.append([r.poc, r.frame_type, {
                st: ms - prev.get(st, 0.0) for st, ms in cur.items()
                if ms != prev.get(st, 0.0)}])
            prev.clear()
            prev.update(cur)
            return r
        sess._finish = finished
        return sess
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "o.hevc")
        log = os.path.join(tmp, "log.csv")
        _write_y4m(src, frames)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1_start()                                # the main path starts
        with mock.patch.object(cli, "configure", instrumented), \
                weightp_pins().weights_recorded(top.VideoEncoderSession) \
                as weights:
            rc = cli.main([src, "-o", dst, "--frames", str(n_frames),
                           "--csv", log, "--csv-log-level", "2"])
        launches = k1_read()
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            lines = f.read().splitlines()
        head, rows = lines[0].split(", "), [r.split(", ")
                                            for r in lines[1:-1]]
        total = os.path.getsize(dst)
    inst = made[0]
    fps, order, stage, want = inst.report()
    col = lambda name: [float(r[head.index(name)]) for r in rows]
    emit(phase="1080p_cli_medium", argv="(no preset flag)", rc=rc,
         frames=len(rows), fps=fps, call_ms=inst.call_ms,
         trellis_sizes=inst.trellis, frame_type=[r[1] for r in rows],
         poc=[int(r[2]) for r in rows], qp=[int(r[3]) for r in rows],
         frame_bytes=[int(r[4]) // 8 for r in rows], bytes=total,
         psnr_y=[float(r[5]) for r in rows], coding_order=order,
         p_anchor_weights=weights, stage_ms_by_frame=per_frame,
         csv_device_ms=col("Device ms"), csv_deblock_ms=col("Deblock ms"),
         csv_sao_ms=col("SAO ms"), csv_serialize_ms=col("Serialize ms"),
         stage_ms_per_frame=stage, stage_ms_total=dict(inst.sess.stage_ms),
         dpb_device=inst.sess.dpb_device, k1_launches=launches,
         max_memory_allocated=peak)
    weighted = any(w and w.get("luma", (64, 0)) != (64, 0) for w in weights)
    if rc != 0 or len(rows) != n_frames or order[0] != (0, "I") \
            or inst.sess.dpb_device or not weighted \
            or not all(np.isfinite(float(r[5])) for r in rows):
        raise AssertionError(f"1080p_cli_medium output malformed: {order} "
                             f"weights {weights}")
    if launches != want:
        raise AssertionError(f"1080p_cli_medium: K1 launches "
                             f"{launches} != {want}")
    a, k = inst.last(False)
    out_k = inst.run(*a, **k)
    with plain_k1():
        out_p = inst.run(*a, **k)
    same = _same_decisions(out_k, out_p)
    emit(phase="1080p_cli_medium_p_anchor_plain_rerun",
         weights=k.get("weights"), identical=same)
    if not same:
        raise AssertionError("1080p_cli_medium: kernel and plain weighted "
                             "P-anchor decisions differ")
    return launches


def phase_1080p_cli_medium_main10(dev, n_frames=MAIN10_FRAMES):
    """x265's default command line (no preset flag: weighted P anchors on
    the host-filter quadtree path, SAO, AQ 2, cuTree, b-adapt 2, bframes
    4, psy-rd, intra in B slices, CRF 28) over a 1080p 10-bit y4m of
    synth_clip times 4 (n_frames frames): fps after the IDR, each frame's
    type, POC, QP, bytes and PSNR-Y at the 10-bit peak from the CSV log,
    stage ms, peak memory and K1's launches by entry point, all on the
    int16 planes (the fused sweeps' keys sized from the 10-bit peak: 32
    bits); then the last B frame's plain rerun, which must be
    identical."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    frames = deep10(synth_clip(n_frames, W1080, H1080))
    made = []
    configure = cli.configure

    def instrumented(*a, **k):
        made.append(_Instrumented(configure(*a, **k)))
        return made[-1].sess
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "o.hevc")
        log = os.path.join(tmp, "log.csv")
        _write_y4m(src, frames, 10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1_start()                                # the main path starts
        with mock.patch.object(cli, "configure", instrumented):
            rc = cli.main([src, "-o", dst, "--frames", str(n_frames),
                           "--csv", log])
        launches = k1_read()
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            lines = f.read().splitlines()
        rows = [r.split(", ") for r in lines[1:-1]]
        total = os.path.getsize(dst)
    inst = made[0]
    sess = inst.sess
    fps, order, stage, want = inst.report()
    ref_dtype = str(sess.anchor[0][0].dtype)
    keys = me_sad.key_layout(torch.int16, 16, sess.inter_encoder.search_range,
                             2, (1 << 10) - 1)[1]
    emit(phase="1080p_cli_medium_main10", argv="(no preset flag)", rc=rc,
         bit_depth=sess.bit_depth, frames=len(rows), fps=fps,
         call_ms=inst.call_ms, trellis_sizes=inst.trellis,
         frame_type=[r[1] for r in rows], poc=[int(r[2]) for r in rows],
         qp=[int(r[3]) for r in rows],
         frame_bytes=[int(r[4]) // 8 for r in rows], bytes=total,
         psnr_y_10bit_peak=[float(r[5]) for r in rows],
         psnr_u=[float(r[6]) for r in rows],
         psnr_v=[float(r[7]) for r in rows], coding_order=order,
         stage_ms_per_frame=stage, stage_ms_total=dict(sess.stage_ms),
         reference_plane_dtype=ref_dtype, fused_key_dtype=str(keys),
         k1_launches=launches,
         k1_launches_by_frame_type=inst.k1_by_frame_type(),
         max_memory_allocated=peak)
    if rc != 0 or len(rows) != n_frames or order[0] != (0, "I") \
            or sess.bit_depth != 10 or ref_dtype != "torch.int16" \
            or keys != torch.int32 \
            or not all(np.isfinite(float(r[5])) for r in rows):
        raise AssertionError(f"1080p_cli_medium_main10 output malformed: "
                             f"{order} {ref_dtype}")
    if launches != want:
        raise AssertionError(f"1080p_cli_medium_main10: K1 launches "
                             f"{launches} != {want}")
    a, k = inst.last(True)
    out_k = inst.run(*a, **k)
    with plain_k1():
        out_p = inst.run(*a, **k)
    same = _same_decisions(out_k, out_p)
    emit(phase="1080p_cli_medium_main10_b_frame_plain_rerun", identical=same)
    if not same:
        raise AssertionError("1080p_cli_medium_main10: kernel and plain B "
                             "frame decisions differ")
    return launches


def phase_1080p_api_superfast(dev, n_frames=API_FRAMES):
    """The library (api.Encoder at param_default_preset("superfast"):
    search range 24, b-adapt 2, psy-rd, CRF 28, no hash SEI) over
    n_frames 1080p frames: fps after the IDR, frame types, QPs and bytes,
    peak memory, K1's launches (fused: the lookahead's per frame and the
    trellis's K + K(K-1)/2 per decision; the R = 24 surface one per P
    anchor, two per B frame), and the last B frame's plain rerun (the
    surface at R = 24 against its plain version on the main path)."""
    from x265_yuuki_asuna_tpu_torch import api
    frames = synth_clip(n_frames, W1080, H1080)
    p = api.param_default_preset("superfast")
    api.param_parse(p, "input-res", f"{W1080}x{H1080}")
    enc = api.encoder_open(p)
    inst = _Instrumented(enc._sess)
    stream = api.encoder_headers(enc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_start()                                    # the main path starts
    for fr in frames + [None]:
        pic = None
        if fr is not None:
            pic = api.picture_init(p, api.picture_alloc())
            pic.planes = fr
        for nals in api.encoder_encode(enc, pic):
            stream += nals
    launches = k1_read()
    peak = torch.cuda.max_memory_allocated()
    fps, order, stage, want = inst.report()
    res = inst.results
    R = inst.sess.inter_encoder.search_range
    emit(phase="1080p_api_superfast", search_range=R, frames=len(res),
         fps=fps, call_ms=inst.call_ms, trellis_sizes=inst.trellis,
         frame_type=[t for _, t in order], poc=[q for q, _ in order],
         qp=[r.qp for r in res], frame_bytes=[len(r.nals) for r in res],
         bytes=len(stream), psnr_y=[r.psnr_y for r in res],
         stage_ms_per_frame=stage, k1_launches=launches,
         stats=dataclasses.asdict(api.encoder_get_stats(enc)),
         max_memory_allocated=peak)
    if R != 24 or len(res) != n_frames or order[0] != (0, "I") or not all(
            np.isfinite([r.psnr_y for r in res])):
        raise AssertionError(f"1080p_api_superfast output malformed: "
                             f"R={R} {order}")
    if launches != want:
        raise AssertionError(f"1080p_api_superfast: K1 launches "
                             f"{launches} != {want}")
    _plain_rerun("1080p_api_superfast", inst)
    return launches


def _program_launches(inst, bi: bool) -> int:
    """CUDA kernel launches of the last P (bi False) or B frame's inter
    program again (torch.profiler)."""
    a, k = inst.last(bi)
    return _launches(lambda: inst.run(*a, **k))


def phase_1080p_cli_ultrafast(dev, n_frames=CLI_FRAMES):
    """The command line at --preset ultrafast over a 1080p y4m of
    synth_clip (n_frames frames: the IDR and fixed mini-GOPs of 4):
    the CTU32 depth-1 quadtree, intra candidates in B slices, psy-rd 2,
    CRF 28, no filters, and no HME (the CLI's --merange stays 16). fps
    after the IDR, each frame's type, POC, QP and bytes from the CSV log,
    stage ms per frame, peak memory, K1's launches (fused: one lookahead
    sweep per frame; the 8x8 surface: per list one sweep at sizes 32 and
    16, so one per P anchor and two per B frame, twice that with HME,
    whose coarse sweep at 16 and 8 takes the same surface; no 4x4
    surface) in all and per program call by frame type, the CUDA launches
    of the last P and B frame's program, and the last B frame's plain
    rerun, which must be identical."""
    from x265_yuuki_asuna_tpu_torch import cli
    frames = synth_clip(n_frames, W1080, H1080)
    made = []
    configure = cli.configure

    def instrumented(*a, **k):
        made.append(_Instrumented(configure(*a, **k)))
        return made[-1].sess
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "o.hevc")
        log = os.path.join(tmp, "log.csv")
        _write_y4m(src, frames)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1_start()                                # the main path starts
        with mock.patch.object(cli, "configure", instrumented):
            rc = cli.main([src, "-o", dst, "--preset", "ultrafast",
                           "--frames", str(n_frames), "--csv", log])
        launches = k1_read()
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rows = [r.split(", ") for r in f.read().splitlines()[1:-1]]
        total = os.path.getsize(dst)
    inst = made[0]
    fps, order, stage, _ = inst.report()
    enc = inst.sess.inter_encoder
    n_p = sum(t == "P" for _, t in order)
    n_b = sum(t in "Bb" for _, t in order)
    want = {"sad_sweep_best": len(order),
            "sad_block8_sweep": (2 if enc.hme else 1) * (n_p + 2 * n_b),
            "sad_block4_sweep": 0}
    emit(phase="1080p_cli_ultrafast", argv="--preset ultrafast", rc=rc,
         max_depth=inst.sess.max_depth, hme=enc.hme,
         hme_range=enc.hme_range, search_range=enc.search_range,
         b_intra=enc.b_intra, psy_rd=enc.psy_rd, frames=len(rows), fps=fps,
         call_ms=inst.call_ms, frame_type=[r[1] for r in rows],
         poc=[int(r[2]) for r in rows], qp=[int(r[3]) for r in rows],
         frame_bytes=[int(r[4]) // 8 for r in rows], bytes=total,
         psnr_y=[float(r[5]) for r in rows], coding_order=order,
         stage_ms_per_frame=stage, stage_ms_total=dict(inst.sess.stage_ms),
         k1_launches=launches, k1_launches_want=want,
         k1_by_frame_type=inst.k1_by_frame_type(),
         cuda_launches_by_frame_type={"P": _program_launches(inst, False),
                                      "B": _program_launches(inst, True)},
         max_memory_allocated=peak)
    if rc != 0 or order != minigop_order(n_frames) or len(rows) != n_frames \
            or inst.sess.max_depth != 1 \
            or not all(np.isfinite(float(r[5])) for r in rows):
        raise AssertionError(f"1080p_cli_ultrafast output malformed: "
                             f"{order}")
    if launches != want:
        raise AssertionError(f"1080p_cli_ultrafast: K1 launches "
                             f"{launches} != {want}")
    _plain_rerun("1080p_cli_ultrafast", inst)
    return launches


def phase_1080p_b_uniform(dev, n_frames=B_UNIFORM_FRAMES):
    """The uniform 16x16 grid's B session at 1080p:
    VideoEncoderSession(1920, 1080, cu_size=16, bframes=3, b_pyramid=True,
    b_adapt=0, deblock=True, sao=True) at CQP 32 with the hash SEI, over
    n_frames frames of synth_clip through push_frame / flush (the IDR and
    a mini-GOP). fps after the IDR, each frame's type, POC, QP and
    bytes, stage ms per frame, peak memory, K1's launches (all fused: one
    lookahead sweep per frame, the P anchor's ME sweep, one per list per B
    frame) in all and per program call by frame type, the CUDA launches
    of the last P and B frame's program, and the last B frame's plain
    rerun, which must be identical."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    frames = synth_clip(n_frames, W1080, H1080)
    sess = VideoEncoderSession(W1080, H1080, qp=32, keyint=250,
                               hash_sei=True, cu_size=16, bframes=3,
                               b_pyramid=True, b_adapt=0, deblock=True,
                               sao=True, device=dev)
    inst = _Instrumented(sess)
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_start()                                    # the main path starts
    for fr in frames:
        sess.push_frame(*fr)
    sess.flush()
    launches = k1_read()
    peak = torch.cuda.max_memory_allocated()
    res = inst.results
    fps, order, stage, _ = inst.report()
    n_p = sum(t == "P" for _, t in order)
    n_b = sum(t in "Bb" for _, t in order)
    want = {"sad_sweep_best": len(order) + n_p + 2 * n_b,
            "sad_block8_sweep": 0, "sad_block4_sweep": 0}
    total += sum(len(r.nals) for r in res)
    emit(phase="1080p_b_uniform", cu_size=sess.cu, max_depth=sess.max_depth,
         frames=len(res), fps=fps, call_ms=inst.call_ms, coding_order=order,
         frame_type=[t for _, t in order], poc=[q for q, _ in order],
         qp=[r.qp for r in res], frame_bytes=[len(r.nals) for r in res],
         bytes=total, psnr_y=[r.psnr_y for r in res],
         psnr_u=[r.psnr_u for r in res], psnr_v=[r.psnr_v for r in res],
         ssim_y=[r.ssim_y for r in res], stage_ms_per_frame=stage,
         stage_ms_total=dict(sess.stage_ms), k1_launches=launches,
         k1_launches_want=want, k1_by_frame_type=inst.k1_by_frame_type(),
         cuda_launches_by_frame_type={"P": _program_launches(inst, False),
                                      "B": _program_launches(inst, True)},
         max_memory_allocated=peak)
    if order != minigop_order(n_frames) or not all(
            np.isfinite([r.psnr_y for r in res])) or not all(
            r.recon[0].shape == (H1080, W1080) for r in res):
        raise AssertionError(f"1080p_b_uniform output malformed: {order}")
    if launches != want:
        raise AssertionError(f"1080p_b_uniform: K1 launches {launches} != "
                             f"{want}")
    _plain_rerun("1080p_b_uniform", inst)
    return launches


# ---------------------------------------------------------------------------
# the uniform CTU32 grid and the all-intra stream options
# ---------------------------------------------------------------------------

def stream_opts_pins():
    """tests/stream_opts_pins.py: the uniform CTU32 and stream-option
    sessions, command lines and library cases, and the JAX package's pins
    over them."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import stream_opts_pins as pins
    return pins


def k1_sizes() -> dict:
    """The fused sweep's launches by block size since k1_start()."""
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    return dict(me_sad.sad_sweep_best.launches_by_size)


def phase_k1_n32(dev, card):
    """K1's fused sweep at n = 32 (the uniform CTU32 grid's P and B ME,
    R = 16, lambda_bits 2) against its plain version: 1088x1920 planes in
    uint8 (29-bit keys), int16 at 10 bits (31-bit keys) and at 12 bits
    (33 bits: int64 keys), a 64x96 crop at lambda 0, 1 and 2 and a flat
    plane (every cost ties at lambda 0: (-R, -R)); then its time, plain
    time, bound and the wrapper's time at 1088x1920 in uint8 and 10-bit
    int16."""
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    fr = synth_clip(2, W1080, H1080)
    rng = np.random.default_rng(17)
    pad = lambda y: np.pad(y, ((0, 8), (0, 0)), mode="edge")  # 1080 -> 1088

    def deep(y, bd):
        s = bd - 8
        p = pad(y).astype(np.int16)
        return torch.as_tensor((p << s) + rng.integers(0, 1 << s, p.shape)
                               .astype(np.int16), device=dev)
    u8 = [torch.as_tensor(pad(f[0]), device=dev) for f in fr]
    cases = [("ME 1088x1920 n=32", 8, u8[0], u8[1], (2,)),
             ("ME 1088x1920 n=32 int16", 10, deep(fr[0][0], 10),
              deep(fr[1][0], 10), (2,)),
             ("ME 1088x1920 n=32 int16 12-bit", 12, deep(fr[0][0], 12),
              deep(fr[1][0], 12), (2,)),
             ("64x96 n=32", 8, u8[0][:64, :96].contiguous(),
              u8[1][5:69, 3:99].contiguous(), (0, 1, 2)),
             ("flat n=32", 8, torch.full((64, 64), 77, dtype=torch.uint8,
                                         device=dev),
              torch.full((64, 64), 77, dtype=torch.uint8, device=dev), (0,))]
    want_keys = {8: torch.int32, 10: torch.int32, 12: torch.int64}
    rows, err = {}, 0
    for name, bd, ref, src, lams in cases:
        peak = (1 << bd) - 1
        H, W = src.shape
        e = {}
        for lam in lams:
            kb = me_sad.sad_sweep_best(ref, src, 16, 32, lam, peak)
            pb = me_sad.sad_sweep_best_plain(ref, src, 16, 32, lam)
            torch.cuda.synchronize()
            e[lam] = max(int((a.long() - b.long()).abs().max())
                         for a, b in zip(kb, pb))
            if name.startswith("flat") and not (
                    bool((kb[0] == -16).all()) and bool((kb[1] == -16).all())
                    and bool((kb[2] == 0).all())):
                raise AssertionError("flat n=32: the first minimum must be "
                                     "(-R, -R)")
        shift, kdt = me_sad.key_layout(src.dtype, 32, 16, max(lams), peak)
        row = dict(shape=name, H=H, W=W, R=16, n=32, dtype=str(src.dtype),
                   bit_depth=bd, key_dtype=str(kdt), key_shift=shift,
                   max_abs_err=e)
        if name.startswith("ME") and kdt != want_keys[bd]:
            raise AssertionError(f"{name}: keys {kdt}")
        if name.startswith("ME") and bd < 12:
            keys = torch.full(((H // 32) * (W // 32),), -1, dtype=kdt,
                              device=dev)
            row["ms"] = cuda_ms(lambda: me_sad._launch(
                "best", src, ref.data_ptr(), src.data_ptr(), keys.data_ptr(),
                H, W, 16, 32, 2, shift, keys.element_size(),
                me_sad._DTYPES[src.dtype]), 50)
            row["route_ms"] = cuda_ms(
                lambda: me_sad.sad_sweep_best(ref, src, 16, 32, 2, peak), 20)
            row["plain_ms"] = cuda_ms(
                lambda: me_sad.sad_sweep_best_plain(ref, src, 16, 32, 2), 2)
            row["bound_ms"], row["bound_by"] = k1_bound_ms(
                H, W, 16, src.dtype, int_ops_per_s(*card, src.dtype), 32)
        emit(phase="k1_n32", **row)
        if any(e.values()):
            raise AssertionError(f"K1 n=32 differs from its plain version "
                                 f"at {name}: {e}")
        rows[name] = row
        err = max(err, *e.values())
    return rows, err


def phase_golden_stream_opts(dev):
    """The slice's streams on the card: the four golden intra option
    streams of the manifest (intra_lossless, intra_wpp, intra_slices2,
    intra_scaling_default), then tests/stream_opts_pins.py's sessions
    (the uniform CTU32 intra grid with WPP, sign hiding, AQ, lossless,
    slices, the CRC and the checksum; the depth-1 and depth-2 quadtree
    with WPP; a one-column WPP picture; the uniform CTU32 IPPP and B
    sessions with the filters, AQ, cuTree, weighted prediction, x265's
    medium, open GOP and 10 bits), command lines (--lossless, --slices 3,
    --wpp --ctu 32, the scaling lists, --hash 2 / 3, --ctu 32
    --min-cu-size 32 at medium and superfast) and library cases, each
    against the JAX package's md5s, (POC, type, QP), NAL types and CSV
    logs pinned there (the CPU's, which the tests hold)."""
    from x265_yuuki_asuna_tpu_torch import api, cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    pins = stream_opts_pins()
    gp = grid_pins()
    got, ok = {}, {}
    for name, kw in (("intra_lossless", dict(qp=4, lossless=True)),
                     ("intra_wpp", dict(qp=32, wpp=True)),
                     ("intra_slices2", dict(qp=32, slices=3)),
                     ("intra_scaling_default",
                      dict(qp=32, scaling_lists="default"))):
        s = top.IntraEncoderSession(64, 48, hash_sei=False, device=dev, **kw)
        got[name] = _md5_of(s, [s.encode_frame(*f) for f in golden_clip()])
        ok[name] = got[name] == gp.manifest(name)
    k1_start()
    for name in pins.SESSIONS:
        md5, frames, _ = pins.run(top, name, device=dev)
        got[name] = md5
        ok[name] = (md5, frames) == pins.PINS[name]
    with tempfile.TemporaryDirectory() as tmp:
        for name in pins.CLI:
            res = pins.run_cli(cli.main, name, tmp)
            got["cli_" + name] = res[0]
            ok["cli_" + name] = res == pins.CLI_PINS[name]
    for name in pins.API:
        res = pins.run_api(api, name)
        got["api_" + name] = res[0]
        ok["api_" + name] = res == pins.API_PINS[name]
    launches, sizes = k1_read(), k1_sizes()
    emit(phase="golden_stream_opts", md5=got, match=ok, k1_launches=launches,
         k1_fused_by_size=sizes)
    if not all(ok.values()):
        raise AssertionError(f"golden_stream_opts: streams differ: "
                             f"{[k for k, v in ok.items() if not v]}")
    if not sizes[32]:
        raise AssertionError("golden_stream_opts: no n=32 sweep launched")
    return launches


def phase_lossless_cpu_vs_card(dev, n=2):
    """The command line with --lossless on a 416x240 clip of n frames, on
    the card and with device="cpu": equal streams and CSV logs, and every
    recon frame (--recon) equal to its source."""
    from x265_yuuki_asuna_tpu_torch import cli
    clip = synth_clip(n, 416, 240)
    md5, csv, secs, recon_ok = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        _write_y4m(src, clip)
        for where in (None, "cpu"):
            tag = "cpu" if where else "card"
            dst, log, rec = (os.path.join(tmp, tag + x)
                             for x in (".hevc", ".csv", ".yuv"))
            t0 = time.perf_counter()
            rc = cli.main([src, "-o", dst, "--lossless", "--csv", log,
                           "--recon", rec], device=where)
            secs[tag] = time.perf_counter() - t0
            with open(dst, "rb") as f:
                md5[tag] = hashlib.md5(f.read()).hexdigest()
            with open(log) as f:
                csv[tag] = f.read().splitlines()
            got = np.fromfile(rec, np.uint8)
            want = np.concatenate([np.concatenate([p.reshape(-1) for p in f])
                                   for f in clip])
            recon_ok[tag] = bool(np.array_equal(got, want))
            if rc != 0:
                raise AssertionError(f"lossless_cpu_vs_card: rc {rc} ({tag})")
    same = md5["card"] == md5["cpu"] and csv["card"] == csv["cpu"]
    emit(phase="lossless_cpu_vs_card", frames=n, md5=md5, csv=csv["card"],
         seconds=secs, match=same, recon_equals_source=recon_ok)
    if not same or not all(recon_ok.values()):
        raise AssertionError("lossless_cpu_vs_card: streams differ or the "
                             f"recon is not the source: {recon_ok}")


def phase_1080p_cli_intra_ctu32_wpp(dev, n_frames=2):
    """The command line --keyint 1 --qp 32 --ctu 32 --wpp (x265's medium
    otherwise: the uniform CTU32 all-intra grid, RDOQ, the deblock, AQ
    and SAO, which a batch leaves out, as the reference's does; without
    --qp the preset's CRF makes it a video session, as in the
    reference) over a
    1080p y4m of synth_clip, n_frames frames in one batch: ms per
    frame, the session's stage ms per frame (serialize: the Python CABAC's
    WPP substreams, 34 per picture), bytes, PSNR-Y, peak memory; K1
    launches none."""
    from x265_yuuki_asuna_tpu_torch import cli
    frames = synth_clip(n_frames, W1080, H1080)
    made = []
    configure = cli.configure

    def captured(*a, **k):
        made.append(configure(*a, **k))
        return made[-1]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "o.hevc")
        log = os.path.join(tmp, "log.csv")
        _write_y4m(src, frames)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1_start()                                # the main path starts
        t0 = time.perf_counter()
        with mock.patch.object(cli, "configure", captured):
            rc = cli.main([src, "-o", dst, "--keyint", "1", "--qp", "32",
                           "--ctu", "32", "--wpp", "--frames", str(n_frames),
                           "--csv", log])
        wall = time.perf_counter() - t0
        launches = k1_read()
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rows = [r.split(", ") for r in f.read().splitlines()[1:-1]]
        total = os.path.getsize(dst)
    sess = made[0]
    stage = {k: v / n_frames for k, v in sess.stage_ms.items()}
    emit(phase="1080p_cli_intra_ctu32_wpp",
         argv="--keyint 1 --qp 32 --ctu 32 --wpp", rc=rc, frames=len(rows),
         cu_size=sess.cu, max_depth=sess.max_depth, wpp=sess.wpp,
         rdoq=sess.quant_fn.rdoq, substreams=sess.rows,
         ms_per_frame=wall / n_frames * 1e3, fps=n_frames / wall,
         stage_ms_per_frame=stage, serialize_ms_per_frame=stage.get(
             "serialize", 0.0),
         frame_bytes=[int(r[4]) // 8 for r in rows], bytes=total,
         psnr_y=[float(r[5]) for r in rows], k1_launches=launches,
         max_memory_allocated=peak)
    if rc != 0 or len(rows) != n_frames or sess.cu != 32 or not sess.wpp \
            or sess.max_depth or any(launches.values()) \
            or not all(np.isfinite(float(r[5])) for r in rows):
        raise AssertionError("1080p_cli_intra_ctu32_wpp output malformed")
    return launches


def phase_1080p_cli_ctu32(dev, n_frames=5):
    """The command line --ctu 32 --min-cu-size 32 at x265's default
    preset (medium: bframes 4, b-adapt 2, weighted P, AQ 2, cuTree, SAO,
    the deblock, psy-rd, CRF 28) over a 1080p y4m of synth_clip, n_frames
    frames (the IDR and one mini-GOP): the uniform CTU32 grid's IPPP and
    B programs. fps after the IDR, each frame's type, POC, QP and bytes,
    stage ms per frame, peak memory, K1's launches by entry point and the
    fused sweep's by block size (8: the lookahead's per frame and the
    trellis's; 32: the ME, one per P anchor and two per B frame), CUDA
    launches of the last P and B program (torch.profiler) and the last B
    frame's plain rerun, which must be identical."""
    from x265_yuuki_asuna_tpu_torch import cli
    frames = synth_clip(n_frames, W1080, H1080)
    made = []
    configure = cli.configure

    def instrumented(*a, **k):
        made.append(_Instrumented(configure(*a, **k)))
        return made[-1].sess
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "o.hevc")
        log = os.path.join(tmp, "log.csv")
        _write_y4m(src, frames)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1_start()                                # the main path starts
        with mock.patch.object(cli, "configure", instrumented):
            rc = cli.main([src, "-o", dst, "--ctu", "32", "--min-cu-size",
                           "32", "--frames", str(n_frames), "--csv", log])
        launches, sizes = k1_read(), k1_sizes()
        peak = torch.cuda.max_memory_allocated()
        with open(log) as f:
            rows = [r.split(", ") for r in f.read().splitlines()[1:-1]]
        total = os.path.getsize(dst)
    inst = made[0]
    fps, order, stage, _ = inst.report()
    n_p = sum(t == "P" for _, t in order)
    n_b = sum(t in "Bb" for _, t in order)
    la = len(order) + sum(k + k * (k - 1) // 2 for k in inst.trellis)
    want = {"sad_sweep_best": la + n_p + 2 * n_b, "sad_block8_sweep": 0,
            "sad_block4_sweep": 0}
    want_sizes = {8: la, 16: 0, 32: n_p + 2 * n_b}
    per_frame = {"P": _program_launches(inst, False),
                 "B": _program_launches(inst, True)}
    emit(phase="1080p_cli_ctu32", argv="--ctu 32 --min-cu-size 32", rc=rc,
         cu_size=inst.sess.cu, max_depth=inst.sess.max_depth,
         frames=len(rows), fps=fps, call_ms=inst.call_ms,
         trellis_sizes=inst.trellis, frame_type=[r[1] for r in rows],
         poc=[int(r[2]) for r in rows], qp=[int(r[3]) for r in rows],
         frame_bytes=[int(r[4]) // 8 for r in rows], bytes=total,
         psnr_y=[float(r[5]) for r in rows], coding_order=order,
         stage_ms_per_frame=stage, stage_ms_total=dict(inst.sess.stage_ms),
         k1_launches=launches, k1_launches_want=want,
         k1_fused_by_size=sizes, k1_fused_by_size_want=want_sizes,
         k1_by_frame_type=inst.k1_by_frame_type(),
         cuda_launches_by_frame_type=per_frame,
         launches_per_frame=(per_frame["P"] * n_p + per_frame["B"] * n_b)
         / max(n_p + n_b, 1), max_memory_allocated=peak)
    if rc != 0 or len(rows) != n_frames or inst.sess.cu != 32 \
            or inst.sess.max_depth or order[0] != (0, "I") or not n_b \
            or not all(np.isfinite(float(r[5])) for r in rows):
        raise AssertionError(f"1080p_cli_ctu32 output malformed: {order}")
    if launches != want or sizes != want_sizes:
        raise AssertionError(f"1080p_cli_ctu32: K1 launches {launches} "
                             f"{sizes} != {want} {want_sizes}")
    _plain_rerun("1080p_cli_ctu32", inst)
    return launches, sizes


# ---------------------------------------------------------------------------
# the P-frame options (two L0 references, TMVP, max_merge, frame
# duplication) and the P / B WPP substreams
# ---------------------------------------------------------------------------

def p_options_pins():
    """tests/p_options_pins.py: the P-option and WPP sessions, command
    lines and library cases, and the JAX package's pins over them."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import p_options_pins as pins
    return pins


def phase_golden_p_options(dev):
    """The slice's streams on the card: the golden ippp_multiref_tmvp, then
    tests/p_options_pins.py's sessions (two references, TMVP with one and
    two, the uniform CTU32 grid, 10 bits, max_merge 1 / 2 / 5 and on a B
    session and the depth-1 quadtree, frame duplication, the WPP P and B
    substreams), command lines (--ref 2 --tmvp, --max-merge 2,
    --frame-dup) and library cases (medium without B frames, with and
    without weightp), each against the JAX package's md5s, (POC, type,
    QP), NAL types and CSV logs pinned there (the CPU's, which the tests
    hold); K1's launches over them by entry point and size."""
    from x265_yuuki_asuna_tpu_torch import api, cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    pins = p_options_pins()
    gp = grid_pins()
    k1_start()
    s = top.VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                                n_refs=2, tmvp=True, hash_sei=False,
                                device=dev)
    got = {"ippp_multiref_tmvp": _md5_of(s, [s.encode_frame(*f)
                                             for f in golden_clip()])}
    ok = {"ippp_multiref_tmvp": got["ippp_multiref_tmvp"]
          == gp.manifest("ippp_multiref_tmvp")}
    for name in pins.SESSIONS:
        md5, frames, _ = pins.run(top, name, device=dev)
        got[name] = md5
        ok[name] = (md5, frames) == pins.PINS[name]
    with tempfile.TemporaryDirectory() as tmp:
        for name in pins.CLI:
            res = pins.run_cli(cli.main, name, tmp)
            pin = pins.CLI_PINS[name]
            got["cli_" + name] = res[0]
            ok["cli_" + name] = res[:2] == pin[:2] and pins.csv_view(
                name, res[2]) == pins.csv_view(name, pin[2])
    for name in pins.API:
        res = pins.run_api(api, name)
        got["api_" + name] = res[0]
        ok["api_" + name] = res == pins.API_PINS[name]
    launches, sizes = k1_read(), k1_sizes()
    emit(phase="golden_p_options", md5=got, match=ok, k1_launches=launches,
         k1_fused_by_size=sizes)
    if not all(ok.values()):
        raise AssertionError(f"golden_p_options: streams differ: "
                             f"{[k for k, v in ok.items() if not v]}")
    return launches


def _api_stream(api, opts: dict, frames, device=None):
    """The library at param_default_preset("medium") with opts over
    frames (the picture size from the first): the stream's md5 and each
    call's NAL bytes."""
    h, w = frames[0][0].shape
    p = api.param_default_preset("medium")
    api.param_parse(p, "input-res", f"{w}x{h}")
    for k, v in opts.items():
        api.param_parse(p, k, v)
    enc = api.encoder_open(p, device=device)
    stream, sizes = api.encoder_headers(enc), []
    for f in frames + [None]:
        pic = None
        if f is not None:
            pic = api.picture_init(p, api.picture_alloc())
            pic.planes = f
        for nals in api.encoder_encode(enc, pic):
            stream += nals
            sizes.append(len(nals))
    api.encoder_close(enc)
    return hashlib.md5(stream).hexdigest(), sizes


def phase_p_options_cpu_vs_card(dev, n=2):
    """The library's uniform P-only cases (medium without B frames, with
    and without weightp) and the command lines of tests/p_options_pins.py
    on a 416x240 clip of n frames (the IDR and two P frames: the second
    with two references), on the card and with device="cpu": equal
    streams (and CSV logs)."""
    from x265_yuuki_asuna_tpu_torch import api, cli
    pins = p_options_pins()
    clip = synth_clip(n, 416, 240)
    got, secs = {}, {}
    for name, opts in pins.API.items():
        for where in (None, "cpu"):
            t0 = time.perf_counter()
            got[("api_" + name, where or "card")] = _api_stream(
                api, opts, clip, where)
            secs[f"api_{name}_{where or 'card'}"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        _write_y4m(src, clip)
        for name, argv in pins.CLI.items():
            for where in (None, "cpu"):
                tag = where or "card"
                dst, log = os.path.join(tmp, tag + ".hevc"), \
                    os.path.join(tmp, tag + ".csv")
                t0 = time.perf_counter()
                rc = cli.main([src, "-o", dst, "--csv", log] + argv,
                              device=where)
                secs[f"cli_{name}_{tag}"] = time.perf_counter() - t0
                with open(dst, "rb") as f, open(log) as g:
                    got[("cli_" + name, tag)] = (
                        rc, hashlib.md5(f.read()).hexdigest(), g.read())
    match = {k: got[(k, "card")] == got[(k, "cpu")]
             for k, _ in got if _ == "card"}
    emit(phase="p_options_cpu_vs_card", frames=n,
         md5={f"{k}_{t}": v[1] if k.startswith("cli") else v[0]
              for (k, t), v in got.items()},
         api_nal_bytes={k: got[(k, "card")][1] for k in match
                        if k.startswith("api")},
         seconds=secs, match=match)
    if not all(match.values()) or any(v[0] for (k, _), v in got.items()
                                      if k.startswith("cli")):
        raise AssertionError(f"p_options_cpu_vs_card: the card's streams "
                             f"differ from the CPU's: {match}")


def phase_1080p_api_p_only(dev, n_frames=API_P_FRAMES):
    """The library at param_default_preset("medium") with bframes 0, ctu
    16, min-cu-size 16 and weightp 0 (the uniform 16x16 grid with two L0
    references and TMVP, CRF 28, AQ 2, cuTree, the deblock and SAO, no
    hash SEI: the P slices through the Python CABAC) over n_frames frames
    of synth_clip: fps after the IDR, each frame's type, QP and bytes,
    stage ms per frame (inter, serialize), peak memory, the share of CUs
    each P program put on reference index 1, K1's launches (fused: the
    lookahead's one per frame at n = 8, the P program's two per P frame
    at n = 16), the CUDA launches of the last P program and its plain
    rerun, which must be identical."""
    from x265_yuuki_asuna_tpu_torch import api
    frames = synth_clip(n_frames, W1080, H1080)
    p = api.param_default_preset("medium")
    for k, v in (("input-res", f"{W1080}x{H1080}"), ("bframes", "0"),
                 ("ctu", "16"), ("min-cu-size", "16"), ("weightp", "0")):
        api.param_parse(p, k, v)
    enc = api.encoder_open(p)
    sess = enc._sess
    inst = _Instrumented(sess, ippp=True)
    stream = api.encoder_headers(enc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_start()                                    # the main path starts
    for fr in frames + [None]:
        pic = None
        if fr is not None:
            pic = api.picture_init(p, api.picture_alloc())
            pic.planes = fr
        for nals in api.encoder_encode(enc, pic):
            stream += nals
    launches, sizes = k1_read(), k1_sizes()
    peak = torch.cuda.max_memory_allocated()
    res = inst.results
    fps = (len(res) - 1) / (sum(inst.call_ms[1:len(res)]) / 1e3)
    types = [r.frame_type for r in res]
    n_p = types.count("P")
    want = {"sad_sweep_best": len(res) + 2 * n_p, "sad_block8_sweep": 0,
            "sad_block4_sweep": 0}
    want_sizes = {8: len(res), 16: 2 * n_p, 32: 0}
    p_launches = _program_launches(inst, False)
    emit(phase="1080p_api_p_only", n_refs=sess.n_refs, tmvp=sess.tmvp,
         frames=len(res), fps=fps, call_ms=inst.call_ms[:len(res)],
         frame_type=types, qp=[r.qp for r in res],
         frame_bytes=[len(r.nals) for r in res], bytes=len(stream),
         psnr_y=[r.psnr_y for r in res],
         stage_ms_per_frame=inst.stage_calls[:len(res)],
         stage_ms_total=dict(sess.stage_ms),
         ref1_share=inst.ref1_share, k1_launches=launches,
         k1_launches_want=want, k1_fused_by_size=sizes,
         k1_fused_by_size_want=want_sizes,
         k1_by_frame_type=inst.k1_by_frame_type(),
         cuda_launches_p_program=p_launches, max_memory_allocated=peak)
    if sess.n_refs != 2 or not sess.tmvp or types != ["I"] + ["P"] * (
            n_frames - 1) or not all(np.isfinite([r.psnr_y for r in res])):
        raise AssertionError(f"1080p_api_p_only output malformed: {types}")
    if launches != want or sizes != want_sizes:
        raise AssertionError(f"1080p_api_p_only: K1 launches {launches} "
                             f"{sizes} != {want} {want_sizes}")
    _plain_rerun("1080p_api_p_only", inst, bi=False)
    return launches, sizes


def phase_1080p_wpp_b(dev, n_frames=WPP_B_FRAMES):
    """The uniform 16x16 grid's B session with WPP
    (VideoEncoderSession(1920, 1080, cu_size=16, wpp=True, bframes=2,
    b_adapt=0) at CQP 32 with the hash SEI) over n_frames frames of
    synth_clip (the IDR, then a P anchor and two B frames): every slice
    as 68 substreams through the Python CABAC. fps after the IDR, each
    frame's type, POC, QP and bytes, stage ms per call (serialize), peak
    memory, K1's launches (fused: one lookahead sweep per frame, the P
    anchor's ME, one per list per B frame) and the last B frame's plain
    rerun, which must be identical."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    frames = synth_clip(n_frames, W1080, H1080)
    sess = VideoEncoderSession(W1080, H1080, qp=32, keyint=250,
                               hash_sei=True, cu_size=16, wpp=True,
                               bframes=2, b_adapt=0, device=dev)
    inst = _Instrumented(sess)
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_start()                                    # the main path starts
    for fr in frames:
        sess.push_frame(*fr)
    sess.flush()
    launches, sizes = k1_read(), k1_sizes()
    peak = torch.cuda.max_memory_allocated()
    res = inst.results
    fps, order, stage, _ = inst.report()
    n_p = sum(t == "P" for _, t in order)
    n_b = sum(t in "Bb" for _, t in order)
    want = {"sad_sweep_best": len(order) + n_p + 2 * n_b,
            "sad_block8_sweep": 0, "sad_block4_sweep": 0}
    total += sum(len(r.nals) for r in res)
    emit(phase="1080p_wpp_b", wpp=sess.wpp, substreams=sess.rows,
         frames=len(res), fps=fps, call_ms=inst.call_ms,
         coding_order=order, qp=[r.qp for r in res],
         frame_bytes=[len(r.nals) for r in res], bytes=total,
         psnr_y=[r.psnr_y for r in res], stage_ms_per_frame=stage,
         stage_ms_per_call=inst.stage_calls,
         stage_ms_total=dict(sess.stage_ms), k1_launches=launches,
         k1_launches_want=want, k1_fused_by_size=sizes,
         max_memory_allocated=peak)
    if not sess.wpp or order != minigop_order(n_frames, 2) or not all(
            np.isfinite([r.psnr_y for r in res])):
        raise AssertionError(f"1080p_wpp_b output malformed: {order}")
    if launches != want:
        raise AssertionError(f"1080p_wpp_b: K1 launches {launches} != "
                             f"{want}")
    _plain_rerun("1080p_wpp_b", inst)
    return launches


# ---------------------------------------------------------------------------
# the all-intra session complete: 4:4:4, noise reduction, fast intra and
# the CTU64 quadtree
# ---------------------------------------------------------------------------

def intra_opts_pins():
    """tests/intra_opts_pins.py: the 4:4:4, NR, fast-intra and CTU64
    programs, sessions and command lines, and the JAX package's pins over
    them."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import intra_opts_pins as pins
    return pins


def to444(frames):
    """4:2:0 frames at 4:4:4: each chroma plane doubled in size."""
    return [(y, u.repeat(2, 0).repeat(2, 1), v.repeat(2, 0).repeat(2, 1))
            for y, u, v in frames]


def phase_golden_intra_opts(dev):
    """The slice's pins on the card: tests/intra_opts_pins.py's program
    decision dicts (4:4:4, NR, fast intra, CTU64 depth 2 and 3 with a QP
    map, RDOQ, sign hiding, psy-rd, 10 bits) against the JAX programs'
    digests, its sessions (tests/test_i444.py's, test_nr.py's,
    test_fast_intra.py's and test_ctu64.py's cases, CTU64 with RDOQ, SBH,
    psy-rd, 10 bits, a batch, WPP) and command lines (--ctu 64 --keyint 1
    --qp 32, --nr-intra 500 batched and at --frame-batch 1, a 4:4:4 y4m)
    against the JAX package's md5s, frames, NAL types and CSV logs; K1
    launches none (no path of the slice runs ME)."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    pins = intra_opts_pins()
    got, ok = {}, {}
    k1_start()
    for name in pins.PROGRAMS:
        d = pins.digest(pins.run_program_port(name, dev))
        got["program_" + name] = d
        ok["program_" + name] = d == pins.DIGESTS[name]
    for name in pins.SESSIONS:
        md5, frames, _, _ = pins.run(top, name, device=dev)
        got[name] = md5
        ok[name] = (md5, frames) == pins.PINS[name]
    with tempfile.TemporaryDirectory() as tmp:
        for name in pins.CLI:
            res = pins.run_cli(cli.main, name, tmp)
            got["cli_" + name] = res[0]
            ok["cli_" + name] = res == pins.CLI_PINS[name]
    launches = k1_read()
    emit(phase="golden_intra_opts", md5=got, match=ok, k1_launches=launches)
    if not all(ok.values()):
        raise AssertionError(f"golden_intra_opts: results differ: "
                             f"{[k for k, v in ok.items() if not v]}")
    if any(launches.values()):
        raise AssertionError(f"golden_intra_opts: K1 launched {launches}")
    return launches


def phase_intra_opts_cpu_vs_card(dev):
    """The slice's sessions on a 416x240 clip on the card and with
    device="cpu": 4:4:4 at CTU16 (2 frames), NR at 500 over 3 frames one
    by one (the CLI's --frame-batch 1), fast intra (2 frames) and CTU64
    depth 3 with sign hiding and the deblock (1 frame); equal streams."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        IntraEncoderSession
    clip = synth_clip(3, 416, 240)
    cases = (("i444", to444(clip[:2]), dict(csp="i444")),
             ("nr500", clip, dict(nr_intra=500)),
             ("fast_intra", clip[:2], dict(fast_intra=True)),
             ("ctu64_d3", clip[:1], dict(cu_size=64, max_depth=3, sbh=True,
                                         deblock=True)))
    for name, frames, kw in cases:
        md5, secs = {}, {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            sess = IntraEncoderSession(416, 240, qp=30, hash_sei=True,
                                       device=where, **kw)
            md5[str(where)] = _md5_of(sess, [sess.encode_frame(*f)
                                             for f in frames])
            secs[str(where)] = time.perf_counter() - t0
        same = len(set(md5.values())) == 1
        emit(phase="intra_opts_cpu_vs_card", session=name,
             frames=len(frames), md5=md5, seconds=secs, equal=same)
        if not same:
            raise AssertionError(f"416x240 {name} streams differ: {md5}")


def _intra_run(sess, frame, traced: bool) -> dict:
    """One frame of an all-intra session: wall ms, its stage ms, bytes,
    PSNR-Y/U/V and, traced, the CUDA launches of a second encode of the
    same frame (torch.profiler; None untraced)."""
    sess.stage_ms.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = sess.encode_frame(*frame)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3, "bytes": len(r.nals),
           "psnr_y": r.psnr_y, "psnr_u": r.psnr_u, "psnr_v": r.psnr_v,
           "stage_ms": dict(sess.stage_ms), "launches": None}
    if traced:
        out["launches"] = _launches(lambda: sess.encode_frame(*frame))
    if not (np.isfinite([r.psnr_y, r.psnr_u, r.psnr_v]).all()
            and r.recon[0].shape == frame[0].shape):
        raise AssertionError("1080p_intra_opts: a frame is malformed")
    return out


def phase_1080p_intra_opts(dev, trace_quadtrees: bool = False):
    """The slice's paths at 1080p (1920x1088 coded) on synth_clip, QP 32:
    each run's ms per frame, CUDA launches per frame, bytes, PSNR-Y/U/V
    and peak memory, K1's counts read before and after (all 0).
    ctu64_cli: one frame of --ctu 64 --keyint 1 --qp 32 through cli.main
    (x265's medium otherwise: the CTU64 depth-3 quadtree with psy-rd 2,
    sign hiding, AQ 2 and the deblock); ctu64_d2 / ctu32_d2: a CTU64
    depth-2 frame beside the CTU32 depth-2 quadtree's, each with sign
    hiding and the deblock, one after the other; i444: one 4:4:4 frame at
    CTU16; fast_intra / uniform: the uniform CTU16 grid with and without
    fast intra, in turns (each twice; the 4:4:4 run before them warms the
    uniform grid's code); nr500 / nr0: three frames at nr_intra=500 one
    by one (--frame-batch 1) beside three without, each frame's bytes
    (nr0's first frame is the uniform run's: its launches are those).
    The quadtree runs' launches
    (0.5-2.8 M a frame: minutes of tracing) are traced only with
    trace_quadtrees (a focused call), else reported as None."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        IntraEncoderSession
    frames = synth_clip(3, W1080, H1080)
    mk = lambda **kw: IntraEncoderSession(W1080, H1080, qp=32, device=dev,
                                          **kw)
    before = k1_read()
    k1_start()                                    # the main path starts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, peaks = {}, {}
    # the command line (depth 3); its session's launches on the same frame
    made = []
    configure = cli.configure

    def captured(*a, **k):
        made.append(configure(*a, **k))
        return made[-1]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "o.hevc")
        log = os.path.join(tmp, "log.csv")
        _write_y4m(src, frames[:1])
        t0 = time.perf_counter()
        with mock.patch.object(cli, "configure", captured):
            rc = cli.main([src, "-o", dst, "--ctu", "64", "--keyint", "1",
                           "--qp", "32", "--frames", "1", "--csv", log])
        wall = time.perf_counter() - t0
        with open(log) as f:
            row = f.read().splitlines()[1].split(", ")
    sess = made[0]
    runs["ctu64_cli"] = {
        "rc": rc, "cu_size": sess.cu, "max_depth": sess.max_depth,
        "psy_rd": sess.frame_encoder.psy_rd, "sbh": sess.sbh,
        "aq_mode": sess.aq_mode, "deblock": sess.deblock,
        "ms": wall * 1e3, "stage_ms": dict(sess.stage_ms),
        "bytes": int(row[4]) // 8, "psnr_y": float(row[5]),
        "psnr_u": float(row[6]), "psnr_v": float(row[7]),
        "launches": _launches(lambda: sess.encode_frame(*frames[0]))
        if trace_quadtrees else None}
    peaks["ctu64_cli"] = torch.cuda.max_memory_allocated()
    for name, kw in (("ctu64_d2", dict(cu_size=64, max_depth=2)),
                     ("ctu32_d2", dict(max_depth=2))):
        s = mk(sbh=True, deblock=True, **kw)
        torch.cuda.reset_peak_memory_stats()
        runs[name] = _intra_run(s, frames[0], trace_quadtrees)
        peaks[name] = torch.cuda.max_memory_allocated()
    s = mk(csp="i444")
    torch.cuda.reset_peak_memory_stats()
    runs["i444"] = _intra_run(s, to444(frames[:1])[0], True)
    peaks["i444"] = torch.cuda.max_memory_allocated()
    turns = {"fast_intra": mk(fast_intra=True), "uniform": mk()}
    for name, s in turns.items():
        torch.cuda.reset_peak_memory_stats()
        runs[name] = _intra_run(s, frames[0], True)
        peaks[name] = torch.cuda.max_memory_allocated()
    for name, s in turns.items():                 # the second turn
        runs[name]["ms_turns"] = [runs[name]["ms"], _intra_run(
            s, frames[0], False)["ms"]]
    for name, kw in (("nr500", dict(nr_intra=500)), ("nr0", {})):
        s = mk(**kw)
        torch.cuda.reset_peak_memory_stats()
        res = [_intra_run(s, f, False) for f in frames]
        peaks[name] = torch.cuda.max_memory_allocated()
        # the launches of a first frame, on a session of its own (a
        # traced rerun would add to the NR sums); without NR the first
        # frame is the uniform run's
        s = mk(**kw)
        runs[name] = {"ms": [r["ms"] for r in res],
                      "frame_bytes": [r["bytes"] for r in res],
                      "launches": _launches(lambda: s.encode_frame(
                          *frames[0])) if kw else
                      runs["uniform"]["launches"],
                      **{k: [r[k] for r in res]
                         for k in ("psnr_y", "psnr_u", "psnr_v")}}
    launches = k1_read()
    emit(phase="1080p_intra_opts", runs=runs, max_memory_allocated=peaks,
         k1_launches_before=before, k1_launches=launches)
    if rc != 0 or sess.cu != 64 or sess.max_depth != 3 \
            or any(launches.values()):
        raise AssertionError(f"1080p_intra_opts malformed: rc {rc}, "
                             f"K1 {launches}")
    return launches


# ---------------------------------------------------------------------------
# the last options at the entry points: RQT, analysis save / load / share
# with scale_factor, the ABR ladder and its scaler, the HDR10+ / Dolby
# Vision metadata and reconplay
# ---------------------------------------------------------------------------

def tools_pins():
    """tests/tools_pins.py: the RQT programs, sessions and command line,
    the analysis passes, the ladder and the metadata command lines, and
    the JAX package's pins over them."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import tools_pins as pins
    return pins


def _check(phase: str, ok: dict):
    if not all(ok.values()):
        raise AssertionError(f"{phase}: differ from the pins: "
                             f"{[k for k, v in ok.items() if not v]}")


def phase_golden_rqt(dev):
    """RQT on the card: the P program at one QP, at a per-CTU QP map and
    with RDOQ and the B program on tools_pins.rqt_inputs() against the
    JAX programs' pinned digests (every key, recon included), the P and B
    sessions of tests/test_rqt.py and the deblocked P session (the
    reference's fault: the stream decodes to another picture) against the
    pinned md5s, and --preset ultrafast --qp 22 --rqt through cli.main;
    K1's launches over them."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    from x265_yuuki_asuna_tpu_torch.models.inter_encoder import \
        InterQTEncoder
    from x265_yuuki_asuna_tpu_torch.ops.quant import Quantizer
    pins = tools_pins()
    k1_start()
    dicts = pins.rqt_dicts(InterQTEncoder, Quantizer, dev)
    got = {k: pins.digest(d) for k, d in dicts.items()}
    ok = {k: got[k] == pins.RQT_DIGEST[k] for k in got}
    split = {k: int((d["tu_split32"] & ~d["split"] & ~d["use_intra"]).sum())
             for k, d in dicts.items()}
    for name in pins.RQT_SESSIONS:
        got[name] = pins.run_session(top, name, device=dev)[0]
        ok["session_" + name] = got[name] == pins.RQT_PINS[name]
    with tempfile.TemporaryDirectory() as tmp:
        src = pins.write_cli_inputs(tmp, _write_y4m)
        got["cli_rqt"] = pins.run_cli(cli.main, "rqt", tmp, src)
        ok["cli_rqt"] = got["cli_rqt"] == pins.CLI_PINS["rqt"]
    launches = k1_read()
    emit(phase="golden_rqt", got=got, match=ok, split_inter_cu32=split,
         k1_launches=launches)
    _check("golden_rqt", ok)
    return launches


def _resize_np(dev):
    from x265_yuuki_asuna_tpu_torch.ops import scaler
    return lambda p, h, w: scaler.resize_plane(p, h, w, device=dev).cpu() \
        .numpy()


def phase_golden_analysis(dev):
    """Analysis reuse on the card: tests/test_analysis_reuse.py's save and
    load passes and tests/test_scale_factor.py's (pass 1 at half size
    through the port's scaler on the card, pass 2 with scale_factor 2):
    the streams and record files against the JAX package's md5s; then
    --analysis-save and --analysis-load through cli.main; K1's launches
    over them."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    pins = tools_pins()
    k1_start()
    with tempfile.TemporaryDirectory() as tmp:
        got = {"analysis": pins.run_analysis(top, tmp, device=dev),
               "scale_factor": pins.run_scale_factor(top, _resize_np(dev),
                                                     tmp, device=dev)}
        ok = {"analysis": got["analysis"] == pins.ANALYSIS_PINS,
              "scale_factor": got["scale_factor"] == pins.SCALE_PINS}
        src = pins.write_cli_inputs(tmp, _write_y4m)
        for name in ("analysis_save", "analysis_load"):
            got["cli_" + name] = pins.run_cli(cli.main, name, tmp, src)
            ok["cli_" + name] = got["cli_" + name] == pins.CLI_PINS[name]
        got["cli_record"] = pins.file_md5(os.path.join(tmp, "cli.dat"))
        ok["cli_record"] = got["cli_record"] == \
            pins.CLI_PINS["analysis_record"]
    launches = k1_read()
    emit(phase="golden_analysis", got=got, match=ok, k1_launches=launches)
    _check("golden_analysis", ok)
    return launches


def phase_golden_ladder(dev):
    """The ladder on the card: the 128x96 + 64x48 rungs over
    tools_pins.ladder_clip() with and without the analysis hand-off, and
    --keyint 5 --ladder 64x48:300,32x24:100 through cli.main, each rung's
    stream against the JAX package's md5; K1's launches over them."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import ladder
    pins = tools_pins()
    k1_start()
    got = {str(s): pins.run_ladder(ladder, s, device=dev)[0]
           for s in (True, False)}
    ok = {k: got[k] == pins.LADDER_PINS[k == "True"] for k in got}
    with tempfile.TemporaryDirectory() as tmp:
        src = pins.write_cli_inputs(tmp, _write_y4m)
        got["cli_ladder"] = pins.run_cli(cli.main, "ladder", tmp, src)
        ok["cli_ladder"] = got["cli_ladder"] == pins.CLI_PINS["ladder"]
    launches = k1_read()
    emit(phase="golden_ladder", got=got, match=ok, k1_launches=launches)
    _check("golden_ladder", ok)
    return launches


def phase_golden_sei_tools(dev):
    """The metadata and reconplay on the card: tests/test_sei_extras.py's
    session with each frame's HDR10+ SEI, --dolby-vision-rpu (all-intra)
    and --dhdr10-info with --dolby-vision-rpu (a video session) through
    cli.main against the JAX package's md5s; --recon-y4m-exec into dd,
    whose file must be the y4m of the --recon planes."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.bitstream import sei
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    pins = tools_pins()
    got = {"hdr10p": pins.run_hdr10p_session(top, sei, device=dev)[0]}
    ok = {"hdr10p": got["hdr10p"] == pins.SEI_PINS["hdr10p"]}
    with tempfile.TemporaryDirectory() as tmp:
        src = pins.write_cli_inputs(tmp, _write_y4m)
        for name in ("dovi", "hdr10p_dovi"):
            got[name] = pins.run_cli(cli.main, name, tmp, src)
            ok[name] = got[name] == pins.CLI_PINS[name]
        sink, recon = os.path.join(tmp, "sink.y4m"), \
            os.path.join(tmp, "r.yuv")
        rc = cli.main([src, "-o", os.path.join(tmp, "o.hevc"), "--keyint",
                       "1", "--qp", "32", "--recon", recon,
                       "--recon-y4m-exec", f"dd of={sink} status=none"])
        with open(sink, "rb") as f, open(recon, "rb") as g:
            data, body = f.read(), g.read()
        size = 64 * 48 * 3 // 2
        ok["reconplay"] = rc == 0 and data == (
            b"YUV4MPEG2 W64 H48 F25:1 Ip A1:1 C420\n" + b"".join(
                b"FRAME\n" + body[i * size:(i + 1) * size]
                for i in range(pins.CLI_FRAMES)))
    emit(phase="golden_sei_tools", got=got, match=ok)
    _check("golden_sei_tools", ok)


def phase_tools_cpu_vs_card(dev, n=3):
    """The slice's paths on a 416x240 synth_clip, on the card and with
    device="cpu": the quadtree P session with RQT (QP 22, 2 frames), the
    quadtree B session with RQT (bframes 1, b_adapt 0: I, P, B), the
    uniform save and load passes (3 frames, the record files too) and the
    416x240 + 208x120 ladder with the hand-off (3 frames): equal streams."""
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    from x265_yuuki_asuna_tpu_torch.models import ladder
    pins = tools_pins()
    clip = synth_clip(n, 416, 240)
    rqt = dict(qp=22, max_depth=2, keyint=100, hash_sei=True, rqt=True)
    got, secs, split = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for where in (None, "cpu"):
            tag = where or "card"
            t0 = time.perf_counter()
            s = top.VideoEncoderSession(416, 240, device=where, **rqt)
            res = [s.encode_frame(*f) for f in clip[:2]]
            got[("rqt_p", tag)] = pins.md5(
                s.headers() + b"".join(r.nals for r in res))
            s = top.VideoEncoderSession(416, 240, bframes=1, b_adapt=0,
                                        device=where, **rqt)
            res = push_all(s, clip)
            got[("rqt_b", tag)] = pins.md5(
                s.headers() + b"".join(r.nals for r in res))
            secs["rqt_" + tag] = time.perf_counter() - t0
            t0 = time.perf_counter()
            streams = []
            dat = os.path.join(tmp, tag + ".dat")
            for kw in (dict(analysis_save=dat), dict(analysis_load=dat)):
                s = top.VideoEncoderSession(416, 240, device=where, qp=32,
                                            hash_sei=True, **kw)
                streams.append(pins.md5(s.headers() + b"".join(
                    s.encode_frame(*f).nals for f in clip)))
                if "analysis_save" in kw:
                    s.analysis_save.close()
            got[("analysis", tag)] = streams + [pins.file_md5(dat)]
            secs["analysis_" + tag] = time.perf_counter() - t0
            t0 = time.perf_counter()
            lad = ladder.LadderEncoder(
                416, 240, [ladder.Rung(416, 240, 800),
                           ladder.Rung(208, 120, 250)], keyint=250,
                device=where)
            streams = lad.headers()
            for f in clip:
                for j, fr in enumerate(lad.encode_frame(*f)):
                    streams[j] += fr.nals
            got[("ladder", tag)] = [pins.md5(x) for x in streams]
            secs["ladder_" + tag] = time.perf_counter() - t0
    match = {k: got[(k, "card")] == got[(k, "cpu")]
             for k, t in got if t == "card"}
    emit(phase="tools_cpu_vs_card", frames=n,
         md5={f"{k}_{t}": v for (k, t), v in got.items()}, seconds=secs,
         match=match)
    if not all(match.values()):
        raise AssertionError(f"tools_cpu_vs_card: the card's streams "
                             f"differ from the CPU's: {match}")


def phase_1080p_rqt(dev, turns=2):
    """RQT at 1080p: synth_clip, the CTU32 depth-2 quadtree at QP 32, an
    I and a P frame with rqt=True and with rqt=False (two sessions, one
    after the other): each run's bytes, PSNR-Y, K1's launches (the same:
    RQT adds no sweep) and the share of the P frame's unsplit inter CU32
    leaves whose TU split; then the P program of the RQT session again
    with the split variant on and off in turns (ms) and each one's CUDA
    launches (torch.profiler), and its plain rerun, which must be
    identical."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    frames = synth_clip(2, W1080, H1080)
    runs = {}
    for rqt in (True, False):
        sess = VideoEncoderSession(W1080, H1080, qp=32, keyint=250,
                                   hash_sei=True, max_depth=2, rqt=rqt,
                                   device=dev)
        inst = _Instrumented(sess, ippp=True)
        total = len(sess.headers())
        torch.cuda.synchronize()
        k1_start()                                # the main path starts
        res = [sess.encode_frame(*f) for f in frames]
        launches = k1_read()
        a, k = inst.last(False)
        out = inst.run(*a, **k)
        leaf = ~out["split"] & ~out["use_intra"]
        runs[rqt] = dict(
            sess=sess, inst=inst, out=out, res=res,
            report=dict(bytes=total + sum(len(r.nals) for r in res),
                        frame_bytes=[len(r.nals) for r in res],
                        psnr_y=[r.psnr_y for r in res],
                        frame_ms=inst.call_ms, k1_launches=launches,
                        inter_cu32_leaves=int(leaf.sum()),
                        split_share=(float((out["tu_split32"] & leaf).sum()
                                           / max(leaf.sum(), 1))
                                     if rqt else None)))
        if [r.frame_type for r in res] != ["I", "P"] or not all(
                np.isfinite([r.psnr_y for r in res])):
            raise AssertionError("1080p_rqt output malformed")
    on = runs[True]
    enc = on["sess"].inter_encoder
    a, k = on["inst"].last(False)

    def set_on(v):
        enc.rqt = v
    p_ms = _turns_ms(lambda: on["inst"].run(*a, **k), set_on, turns)
    p_launches = {}
    for v in (True, False):
        set_on(v)
        p_launches[str(v)] = _launches(lambda: on["inst"].run(*a, **k))
    set_on(True)
    want = {"sad_sweep_best": 2, "sad_block8_sweep": 1,
            "sad_block4_sweep": 0}
    emit(phase="1080p_rqt", rqt=runs[True]["report"],
         no_rqt=runs[False]["report"],
         bytes_change=runs[True]["report"]["bytes"]
         / runs[False]["report"]["bytes"] - 1,
         p_program_ms={str(v): m for v, m in p_ms.items()},
         p_program_launches=p_launches, k1_launches_want=want)
    for v in (True, False):
        if runs[v]["report"]["k1_launches"] != want:
            raise AssertionError(f"1080p_rqt: K1 launches "
                                 f"{runs[v]['report']['k1_launches']} != "
                                 f"{want}")
    _plain_rerun("1080p_rqt", on["inst"], bi=False)
    return runs[True]["report"]["k1_launches"]


def phase_1080p_analysis(dev, n_frames=3):
    """Analysis reuse at 1080p on the uniform 16x16 IPPP path (QP 32, hash
    SEI): a save pass, then a load pass over the same n_frames frames of
    synth_clip: each pass's fps after the IDR, bytes, PSNR-Y, ms per
    frame and K1's launches by frame (the fused sweep: the lookahead's one
    a frame in both passes, the P frame's ME one in the save pass and
    none in the load pass); the load pass's last P frame's plain rerun
    identical."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    frames = synth_clip(n_frames, W1080, H1080)
    out, total = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dat = os.path.join(tmp, "a.dat")
        for name, kw in (("save", dict(analysis_save=dat)),
                         ("load", dict(analysis_load=dat))):
            sess = VideoEncoderSession(W1080, H1080, qp=32, keyint=250,
                                       hash_sei=True, device=dev, **kw)
            inst = _Instrumented(sess, ippp=True)
            nbytes = len(sess.headers())
            per_frame = []
            k1_start()                            # the main path starts
            for f in frames:
                before = k1_read()
                nbytes += len(sess.encode_frame(*f).nals)
                per_frame.append({k: v - before[k]
                                  for k, v in k1_read().items()})
            total[name] = k1_read()
            if name == "save":
                sess.analysis_save.close()
            res = inst.results
            out[name] = dict(
                fps=(len(res) - 1) / (sum(inst.call_ms[1:]) / 1e3),
                frame_ms=inst.call_ms, bytes=nbytes,
                psnr_y=[r.psnr_y for r in res],
                frame_type=[r.frame_type for r in res],
                k1_by_frame=per_frame, k1_launches=total[name],
                stage_ms_total=dict(sess.stage_ms))
            if [r.frame_type for r in res] != ["I"] + ["P"] * (
                    n_frames - 1) or not all(np.isfinite(
                        [r.psnr_y for r in res])):
                raise AssertionError("1080p_analysis output malformed")
    want = {"save": {"sad_sweep_best": 2 * n_frames - 1,
                     "sad_block8_sweep": 0, "sad_block4_sweep": 0},
            "load": {"sad_sweep_best": n_frames, "sad_block8_sweep": 0,
                     "sad_block4_sweep": 0}}
    emit(phase="1080p_analysis", **out, k1_launches_want=want,
         bytes_change=out["load"]["bytes"] / out["save"]["bytes"] - 1)
    if total != want:
        raise AssertionError(f"1080p_analysis: K1 launches {total} != "
                             f"{want}")
    _plain_rerun("1080p_analysis_load", inst, bi=False)
    return total


def phase_1080p_ladder(dev, n_frames=4):
    """--ladder 1920x1080:6000,960x540:2000 --keyint 250 through cli.main
    over an n_frames 1080p y4m of synth_clip (the 960x540 rung codes first
    and hands its MVs, scaled by 2, to the 1080p rung): fps after the
    first frame (both rungs), each rung's kbps at 25 fps against its
    target, bytes and frame types, the scaler's ms per frame, and K1's
    launches per rung (the donor's lookahead and ME sweeps, the
    consumer's lookahead sweeps only)."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import ladder
    frames = synth_clip(n_frames, W1080, H1080)
    made = []

    def capture(*a, **k):
        lad = ladder.LadderEncoder(*a, **k)
        made.append(lad)
        per = [dict.fromkeys(K1_ENTRIES, 0) for _ in lad.sessions]
        res = [[] for _ in lad.sessions]
        for i, s in enumerate(lad.sessions):
            def counted(*f, _run=s.encode_frame, _i=i):
                before = k1_read()
                r = _run(*f)
                for n, c in k1_read().items():
                    per[_i][n] += c - before[n]
                res[_i].append(r)
                return r
            s.encode_frame = counted
        lad.k1_per_rung, lad.res = per, res
        call, ms = lad.encode_frame, []

        def timed(*f):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = call(*f)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return got
        lad.encode_frame, lad.frame_ms = timed, ms
        return lad

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        _write_y4m(src, frames)
        argv = [src, "-o", os.path.join(tmp, "out.hevc"), "--keyint",
                "250", "--ladder", "1920x1080:6000,960x540:2000"]
        k1_start()                                # the main path starts
        with mock.patch.object(cli, "LadderEncoder", side_effect=capture):
            rc = cli.main(argv)
        launches = k1_read()
        sizes = {r: os.path.getsize(os.path.join(tmp, f"out_{r}.hevc"))
                 for r in ("1920x1080", "960x540")}
    lad = made[0]
    rungs = []
    for i, r in enumerate(lad.rungs):
        size = sizes[f"{r.width}x{r.height}"]
        rungs.append(dict(
            rung=f"{r.width}x{r.height}", target_kbps=r.bitrate_kbps,
            kbps_at_25fps=size * 8 * 25 / n_frames / 1000, bytes=size,
            frame_type=[x.frame_type for x in lad.res[i]],
            qp=[x.qp for x in lad.res[i]],
            psnr_y=[x.psnr_y for x in lad.res[i]],
            k1_launches=lad.k1_per_rung[i],
            analysis_hints=lad.sessions[i].hinted))
    fps = (n_frames - 1) / (sum(lad.frame_ms[1:]) / 1e3)
    emit(phase="1080p_ladder", frames=n_frames, fps=fps,
         frame_ms=lad.frame_ms, rungs=rungs,
         scale_ms_per_frame=lad.scale_ms / n_frames, k1_launches=launches)
    want = [{"sad_sweep_best": n_frames, "sad_block8_sweep": 0,
             "sad_block4_sweep": 0},
            {"sad_sweep_best": 2 * n_frames - 1, "sad_block8_sweep": 0,
             "sad_block4_sweep": 0}]
    if rc != 0 or any(not np.isfinite(r["psnr_y"]).all() or r["frame_type"]
                      != ["I"] + ["P"] * (n_frames - 1) for r in rungs):
        raise AssertionError("1080p_ladder output malformed")
    if lad.k1_per_rung != want:
        raise AssertionError(f"1080p_ladder: K1 launches per rung "
                             f"{lad.k1_per_rung} != {want}")
    return launches


def parallel_pins():
    """tests/parallel_pins.py: the multi-slot pipeline's inputs, runners
    and the JAX package's pins over them."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import parallel_pins as pins
    return pins


def _stream_start():
    """Set K1's launches by CUDA stream to 0."""
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    me_sad.launches_by_stream.clear()


def _stream_share(slots) -> dict:
    """K1's launches since _stream_start() by slot (each slot's stream),
    the launches on no slot's stream, and the share that went to the slot
    streams."""
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    by = dict(me_sad.launches_by_stream)
    mine = {s.index: by.pop(s.stream.cuda_stream, 0) for s in slots}
    total = sum(mine.values()) + sum(by.values())
    return {"by_slot": mine, "elsewhere": sum(by.values()),
            "slot_share": sum(mine.values()) / max(total, 1)}


def _slot_layouts():
    """Four streams of card 0, and across the cards where there are two
    or more (slot k on card k % the card count)."""
    out = {"streams_of_card0": ["cuda:0"]}
    if torch.cuda.device_count() >= 2:
        out["across_cards"] = None
    return out


def phase_golden_pipeline(dev):
    """The multi-slot pipeline on the card against the JAX package's pins
    (tests/parallel_pins.py), with the slots as four streams of card 0
    and, where the machine has two cards or more, across the cards: the
    frame-parallel dicts (8 slots), the band-parallel stream (4), the
    P-chain fill's and steady state's dicts, the pipelined sessions (QP
    32, QP 30, per-chain ABR: every frame's NALs and QPs), the int8
    refusal and its sequential stream, --devices 4 (and --bitrate)
    through cli.main, and the video session's flush(count). Each
    session's K1 launches must all land on the slots' streams, one
    fused sweep per P frame coded by the slot."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch import parallel as par
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    from x265_yuuki_asuna_tpu_torch.models.inter_encoder import \
        InterFrameEncoder
    from x265_yuuki_asuna_tpu_torch.models.intra_encoder import \
        IntraFrameEncoder
    from x265_yuuki_asuna_tpu_torch.parallel.session import \
        PipelinedEncoder
    pins = parallel_pins()
    ok, streams = {}, {}
    k1_start()                                    # the main path starts
    for lay, devices in _slot_layouts().items():
        kw = dict(devices=devices)
        ok[lay + "/frame_parallel"] = [pins.digest(d) for d in
                                       pins.frame_parallel_dicts(
                                           par, IntraFrameEncoder, **kw)] \
            == pins.FRAME_PARALLEL_DIGESTS
        ok[lay + "/bands"] = pins.md5(pins.band_stream(par, top, **kw)) == \
            pins.BANDS_MD5
        ok[lay + "/pipeline"] = [pins.digest(d) for d in pins.pipeline_dicts(
            par, InterFrameEncoder, **kw)] == pins.PIPELINE_DIGESTS
        ok[lay + "/pipeline_stream"] = [
            [pins.digest(d) for d in row] for row in
            pins.pipeline_stream_dicts(par, InterFrameEncoder, **kw)] == \
            pins.PIPELINE_STREAM_DIGESTS
        for name in pins.SESSIONS:
            _stream_start()
            enc, res, stream = pins.run_session(PipelinedEncoder, name, **kw)
            ok[f"{lay}/{name}"] = pins.session_pin_of(res, stream) == \
                pins.SESSION_PINS[name]
            share = _stream_share(enc.slots)
            # every chain codes N frames (the last one padded)
            chains = -(-(pins.SESSIONS[name]["frames"] - 1) // enc.n)
            ok[f"{lay}/{name}/k1_on_slot_streams"] = share == {
                "by_slot": dict.fromkeys(range(enc.n), chains),
                "elsewhere": 0, "slot_share": 1.0}
            streams[f"{lay}/{name}"] = share
        frames = pins.noise_clip()
        try:
            PipelinedEncoder(64, 48, qp=pins.OVERFLOW_QP, n_devices=4,
                             **kw).encode_clip(frames)
            ok[lay + "/int8_refusal"] = False
        except RuntimeError as e:
            ok[lay + "/int8_refusal"] = "overflowed int8" in str(e)
        enc = PipelinedEncoder(64, 48, qp=pins.OVERFLOW_QP, n_devices=4,
                               **kw)
        res = enc.encode_clip_sequential(frames)
        ok[lay + "/int8_sequential"] = pins.md5(enc.headers() + b"".join(
            r.nals for r in res)) == pins.OVERFLOW_SEQ_MD5
    with tempfile.TemporaryDirectory() as tmp:
        src = pins.write_cli_input(tmp, _write_y4m)
        for name in ("d4", "d4_abr"):
            ok["cli_" + name] = pins.run_cli(cli.main, name, tmp, src) == \
                pins.CLI_PINS[name]
    pin = pins.FLUSH_COUNT_PIN
    ok["flush_count"] = pins.run_flush_count(top, device=dev) == (
        pin["stream"], pin["frames"], pin["after_flush2"])
    launches = k1_read()
    emit(phase="golden_pipeline", layouts=list(_slot_layouts()),
         cards=torch.cuda.device_count(), match=ok,
         k1_by_slot_stream=streams, k1_launches=launches)
    _check("golden_pipeline", ok)
    return launches


def _sync_sites(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): its result and
    the port's source lines that made the host wait for the card, with
    their counts."""
    import warnings
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in ws:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return got, sites


def phase_pipeline_cpu_vs_card(dev, n_chains=2):
    """A 416x240 clip of synth_clip, the IDR and n_chains chains of 4,
    through PipelinedEncoder(n_devices=4) on the card (four streams of
    card 0) and on the CPU: the card's encode_clip stream equals the
    CPU's and the card's encode_clip_sequential; --devices 4 through
    cli.main on the card codes the same stream. The card's pipeline runs
    once more under torch.cuda.set_sync_debug_mode("warn"): where the
    host waits for the card."""
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.parallel.session import \
        PipelinedEncoder
    w, h = 416, 240
    frames = synth_clip(1 + 4 * n_chains, w, h)
    k1_start()                                    # the main path starts
    got = {}
    for name, kw in (("card", dict(devices=["cuda:0"])),
                     ("cpu", dict(device="cpu"))):
        enc = PipelinedEncoder(w, h, qp=32, n_devices=4, **kw)
        res = enc.encode_clip(frames)
        got[name] = enc.headers() + b"".join(r.nals for r in res)
        if name == "card":
            seq = enc.encode_clip_sequential(frames)
            got["card_sequential"] = enc.headers() + b"".join(
                r.nals for r in seq)
            _, sites = _sync_sites(lambda: enc.encode_clip(frames))
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "o.hevc")
        _write_y4m(src, frames)
        assert cli.main([src, "-o", out, "--devices", "4"]) == 0
        with open(out, "rb") as f:
            got["cli"] = f.read()
    launches = k1_read()
    md5 = {k: hashlib.md5(v).hexdigest() for k, v in got.items()}
    ok = {k: v == md5["cpu"] for k, v in md5.items()}
    emit(phase="pipeline_cpu_vs_card", frames=len(frames), md5=md5,
         match=ok, sync_sites=sites, k1_launches=launches)
    _check("pipeline_cpu_vs_card", ok)
    return launches


def _busy_union(intervals) -> float:
    """ms covered by at least one of the (start, end) us intervals."""
    busy, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _device_record(fn):
    """fn() under torch.profiler (CUDA only): its result, wall ms, the
    kernels' launches, the device's busy ms (kernel time on any stream)
    and idle share, and the kernel time summed over streams against the
    busy time (above 1 when streams overlapped)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    ks = [(e.start_ns() / 1e3, e.end_ns() / 1e3)
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and e.duration_ns() > 0 and
          not getattr(e, "is_user_annotation", lambda: False)()]
    busy = _busy_union(ks)
    summed = sum(b - a for a, b in ks) / 1e3
    return got, {"wall_ms": wall, "launches": len(ks), "device_busy_ms": busy,
                 "device_idle_share": 1 - busy / wall,
                 "kernel_ms_over_busy_ms": summed / max(busy, 1e-9)}


def phase_1080p_pipeline(dev, n_chains=2):
    """PipelinedEncoder(1920, 1080, qp=32, n_devices=4) over synth_clip,
    the IDR and n_chains chains of 4, with the slots as four streams of
    card 0: encode_clip and encode_clip_sequential in turns (pipeline,
    sequential, sequential, pipeline): each run's fps after the IDR, ms,
    bytes and PSNR-Y, K1's fused launches per P frame (one either way),
    the share of the pipeline's K1 launches each slot issued on its own
    stream; then one profiled run each way over the IDR and one chain:
    the device's idle share, and whether kernels of different streams
    overlapped (kernel ms summed over streams against busy ms). Both
    ways' streams are equal."""
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    from x265_yuuki_asuna_tpu_torch.parallel.session import \
        PipelinedEncoder
    frames = synth_clip(1 + 4 * n_chains, W1080, H1080)
    enc = PipelinedEncoder(W1080, H1080, qp=32, n_devices=4,
                           devices=["cuda:0"])
    sess, idr_ms = enc.sess, []
    code_idr = sess._encode_idr_anchor

    def timed_idr(*f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = code_idr(*f)
        torch.cuda.synchronize()
        idr_ms.append((time.perf_counter() - t0) * 1e3)
        return got
    sess._encode_idr_anchor = timed_idr
    ways = {"pipeline": enc.encode_clip,
            "sequential": enc.encode_clip_sequential}
    runs = {"pipeline": [], "sequential": []}
    streams, n_p = {}, len(frames) - 1
    k1_start()                                    # the main path starts
    for way in ("pipeline", "sequential", "sequential", "pipeline"):
        before = me_sad.sad_sweep_best.launches
        _stream_start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ways[way](frames)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        p_ms = ms - idr_ms[-1]
        runs[way].append(dict(
            ms=ms, idr_ms=idr_ms[-1], fps_after_idr=n_p / (p_ms / 1e3),
            bytes=len(enc.headers()) + sum(len(r.nals) for r in res),
            psnr_y=[r.psnr_y for r in res],
            k1_fused_per_p_frame=(me_sad.sad_sweep_best.launches
                                  - before) / n_p,
            md5=hashlib.md5(b"".join(r.nals for r in res)).hexdigest(),
            frame_type=[r.frame_type for r in res]))
        if way == "pipeline":
            streams = _stream_share(enc.slots)
    launches = k1_read()
    short = frames[:5]
    _, dev_pipe = _device_record(lambda: enc.encode_clip(short))
    _, dev_seq = _device_record(lambda: enc.encode_clip_sequential(short))
    emit(phase="1080p_pipeline", frames=len(frames), slots=enc.n,
         card=torch.cuda.get_device_name(0), runs=runs,
         k1_by_slot_stream=streams,
         device={"pipeline": dev_pipe, "sequential": dev_seq,
                 "frames": len(short)},
         k1_launches=launches)
    md5s = {r["md5"] for rs in runs.values() for r in rs}
    per_p = {r["k1_fused_per_p_frame"] for rs in runs.values() for r in rs}
    if len(md5s) != 1 or per_p != {1.0} or any(
            r["frame_type"] != ["I"] + ["P"] * n_p or
            not np.isfinite(r["psnr_y"]).all()
            for rs in runs.values() for r in rs):
        raise AssertionError(f"1080p_pipeline: streams {md5s}, K1 per P "
                             f"frame {per_p}")
    if streams.get("slot_share") != 1.0 or \
            set(streams["by_slot"].values()) != {n_chains}:
        raise AssertionError(f"1080p_pipeline: K1 by slot {streams}")
    return launches


# ---------------------------------------------------------------------------
# the uniform 8x8 grid (tests/cu8_pins.py) and the writers no session
# reaches (tests/native_writer_pins.py)
# ---------------------------------------------------------------------------

def cu8_pins():
    """tests/cu8_pins.py: the uniform 8x8 grid's sessions and the JAX
    package's pins over them."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import cu8_pins as pins
    return pins


def native_writer_pins():
    """tests/native_writer_pins.py: the CTU64 P / B writer's seeded
    inputs and the JAX package's md5s of its output."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import native_writer_pins as pins
    return pins


def phase_k1_n8(dev, card):
    """K1's fused sweep at n = 8 on a full-resolution plane (the uniform
    8x8 grid's P and B ME: 1080x1920, 135 block rows, R = 16, lambda_bits
    2) against its plain version in uint8 and in int16 at 10 bits, then a
    40x48 crop (5 block rows, an odd count) at lambda 0, 1 and 2 and a
    flat plane at lambda 0 (every cost ties: (-R, -R)) and 2 ((0, 0)),
    and the lookahead's sweep at cu 8 (lambda 1 on the half-resolution
    planes trimmed to whole 8x8 blocks: 536x960, 67 block rows) in uint8
    and 10-bit int16; then its time, plain time, bound and the wrapper's
    time at 1080x1920 and at the lookahead's 536x960, in uint8 and 10-bit
    int16."""
    from x265_yuuki_asuna_tpu_torch.models.lookahead import downscale_half
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    fr = synth_clip(2, W1080, H1080)
    rng = np.random.default_rng(19)

    def deep(y):
        p = y.astype(np.int16)
        return torch.as_tensor((p << 2) + rng.integers(0, 4, p.shape)
                               .astype(np.int16), device=dev)
    u8 = [torch.as_tensor(f[0], device=dev) for f in fr]
    d16 = [deep(f[0]) for f in fr]
    flat = torch.full((64, 64), 77, dtype=torch.uint8, device=dev)
    # Lookahead(1920, 1080): lh = (1080 // 2) // 8 * 8, lw = 960
    low = lambda y, dt: downscale_half(y)[:536, :960].to(dt).contiguous()
    cases = [("ME 1080x1920 n=8", 8, u8[0], u8[1], (2,)),
             ("ME 1080x1920 n=8 int16", 10, d16[0], d16[1], (2,)),
             ("lookahead 536x960 n=8", 8, low(u8[0], torch.uint8),
              low(u8[1], torch.uint8), (1,)),
             ("lookahead 536x960 n=8 int16", 10, low(d16[0], torch.int16),
              low(d16[1], torch.int16), (1,)),
             ("40x48 n=8", 8, u8[0][:40, :48].contiguous(),
              u8[1][3:43, 5:53].contiguous(), (0, 1, 2)),
             ("flat n=8", 8, flat, flat, (0, 2))]
    rows, err = {}, 0
    for name, bd, ref, src, lams in cases:
        peak = (1 << bd) - 1
        H, W = src.shape
        e = {}
        for lam in lams:
            kb = me_sad.sad_sweep_best(ref, src, 16, 8, lam, peak)
            pb = me_sad.sad_sweep_best_plain(ref, src, 16, 8, lam)
            torch.cuda.synchronize()
            e[lam] = max(int((a.long() - b.long()).abs().max())
                         for a, b in zip(kb, pb))
            want = -16 if lam == 0 else 0
            if name.startswith("flat") and not (
                    bool((kb[0] == want).all()) and
                    bool((kb[1] == want).all()) and bool((kb[2] == 0).all())):
                raise AssertionError(f"flat n=8 at lambda {lam}: the first "
                                     f"minimum must be ({want}, {want})")
        shift, kdt = me_sad.key_layout(src.dtype, 8, 16, max(lams), peak)
        row = dict(shape=name, H=H, W=W, R=16, n=8, dtype=str(src.dtype),
                   bit_depth=bd, block_rows=H // 8, key_dtype=str(kdt),
                   key_shift=shift, max_abs_err=e)
        if name.startswith(("ME", "lookahead")):
            lam = lams[0]
            keys = torch.full(((H // 8) * (W // 8),), -1, dtype=kdt,
                              device=dev)
            row["ms"] = cuda_ms(lambda: me_sad._launch(
                "best", src, ref.data_ptr(), src.data_ptr(), keys.data_ptr(),
                H, W, 16, 8, lam, shift, keys.element_size(),
                me_sad._DTYPES[src.dtype]), 50)
            row["route_ms"] = cuda_ms(
                lambda: me_sad.sad_sweep_best(ref, src, 16, 8, lam, peak), 20)
            row["plain_ms"] = cuda_ms(
                lambda: me_sad.sad_sweep_best_plain(ref, src, 16, 8, lam), 2)
            row["bound_ms"], row["bound_by"] = k1_bound_ms(
                H, W, 16, src.dtype, int_ops_per_s(*card, src.dtype), 8)
        emit(phase="k1_n8", **row)
        if any(e.values()):
            raise AssertionError(f"K1 n=8 differs from its plain version "
                                 f"at {name}: {e}")
        rows[name] = row
        err = max(err, *e.values())
    return rows, err


def _commit_bytes(table: np.ndarray, sizes: np.ndarray) -> int:
    """Bytes the intra commit must move for the leaves of `table` (the
    luma size of each ZPOS entry: `sizes`): each leaf's source samples
    read, recon and levels written and reference samples read, luma and
    both 4:2:0 chroma planes, int32; the table uploaded and the CTUs' QPs
    read."""
    sizes = np.broadcast_to(sizes, table.shape)[table >= 0]
    per = lambda m: 3 * m * m + 4 * m + 1
    return int(4 * (per(sizes).sum() + 2 * per(sizes // 2).sum())
               + table.nbytes + 8 * table.shape[0])


def phase_intra_commit(dev, seed=23, iters=20, batched_iters=2):
    """The intra commit kernel (ops/kernels/intra_commit.py) against the
    batched commit on one 1080p P anchor's decisions in the shape of
    medium-psnr-1080p.pan: the benchmark's configuration and content, the
    session's first P anchor's commit inputs captured and replayed (the
    commit is idempotent on them: each leaf reads only inter samples and
    leaves committed before it). Both must agree on rec and levels. Times
    (CUDA events over `iters` calls, and host wall to a synchronize),
    kernel launches and copies of one profiled call each way, and the
    kernel's two bounds: its bytes at the card's rate, and its chain of
    dependent diagonals, measured as the same launches over a table with
    no leaf (every CTA returns at once)."""
    from torch.profiler import ProfilerActivity, profile
    from hevc_bench import harness
    from hevc_bench.content import Content
    from x265_yuuki_asuna_tpu_torch import cli
    from x265_yuuki_asuna_tpu_torch.models import qt_common as QT
    from x265_yuuki_asuna_tpu_torch.ops.kernels import intra_commit as IC
    from x265_yuuki_asuna_tpu_torch.utils import io as IO
    from x265_yuuki_asuna_tpu_torch.utils import param as P
    cell = "medium-psnr-1080p.pan"
    _, cfg, mix = harness.load_cell(cell)
    args, prm = cli.parse(["input.y4m", "-o", "out.hevc"] + cfg["argv"])
    sess = cli.configure(args, prm, IO.VideoInfo(W1080, H1080, 25, 1,
                                                  P.CSP_I420, 8), None)
    content = Content(mix, W1080, H1080, seed, dev)
    got, commit = [], QT.commit_intra

    def spy(table, geo, src, rec, lv, fq, intra_slice, quant_fn=QT.PLAIN,
            states=None):
        if not intra_slice and not got:
            got.append((table.copy(), geo, src, tuple(p.clone() for p in rec),
                        tuple(p.clone() for p in lv), fq, quant_fn))
        return commit(table, geo, src, rec, lv, fq, intra_slice, quant_fn,
                      states)
    with mock.patch.object(QT, "commit_intra", spy):
        for i in range(4 * (sess.bframes + 1)):
            sess.push_frame(*content.frame(i))
            if got:
                break
    table, geo, src, rec0, lv0, fq, q = got[0]
    fresh = lambda: ([p.clone() for p in rec0], [p.clone() for p in lv0])
    k_rec, k_lv = fresh()
    b_rec, b_lv = fresh()
    IC.intra_commit(table, geo, src, k_rec, k_lv, fq, False, q)
    QT.commit_batched(table, geo, src, b_rec, b_lv, fq, False, q)
    torch.cuda.synchronize()
    agree = all(torch.equal(a, b) for a, b in zip(k_rec + k_lv,
                                                  b_rec + b_lv))
    kernel = lambda: IC.intra_commit(table, geo, src, k_rec, k_lv, fq,
                                     False, q)
    batched = lambda: QT.commit_batched(table, geo, src, b_rec, b_lv, fq,
                                        False, q)
    diags = IC.diagonals(table, geo.cols)
    sizes = np.array([n for _, _, n in QT.ZPOS])
    empty = torch.full(table.shape, -1, dtype=torch.int32, device=dev)
    chain = lambda: IC.launch(empty, diags, geo, src, k_rec, k_lv, fq,
                              False, q)

    def wall_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def launches(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type.name == "CUDA"]
        copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in ev)
        return len(ev) - copies, copies

    row = dict(
        cell=cell, seed=seed, frame_pushed=i, quantizer=dict(
            sbh=q.sbh, rdoq=q.rdoq, bit_depth=q.bit_depth),
        leaves=int((table >= 0).sum()), ctus_with_leaves=int(
            (table >= 0).any(1).sum()), diagonals=len(diags),
        leaves_by_size={n: int(((table >= 0) & (sizes == n)).sum())
                        for n in (32, 16, 8)},
        agree=agree,
        kernel_ms=cuda_ms(kernel, iters), kernel_wall_ms=wall_ms(kernel,
                                                                 iters),
        chain_floor_ms=cuda_ms(chain, iters),
        batched_ms=cuda_ms(batched, batched_iters),
        batched_wall_ms=wall_ms(batched, batched_iters),
        kernel_launches_copies=launches(kernel),
        batched_launches_copies=launches(batched))
    nbytes = _commit_bytes(table, sizes)
    row.update(bytes=nbytes, bound_bytes_ms=nbytes / H100_BYTES_PER_S * 1e3)
    emit(phase="intra_commit", **row)
    if not agree:
        raise AssertionError("the intra commit kernel differs from the "
                             "batched commit")
    return row


def phase_golden_cu8(dev):
    """The uniform 8x8 grid on the card against the JAX package's pins
    (tests/cu8_pins.py): every session's md5 and (POC, type, QP),
    PipelinedEncoder on four streams of card 0 (encode_clip and
    encode_clip_sequential), analysis save / load and two passes with
    their files, the AQ sessions refused with the reason; then the CTU64
    P / B writer's streams (tests/native_writer_pins.py). Returns K1's
    launch counts and the fused sweep's by size."""
    from x265_yuuki_asuna_tpu_torch.bitstream import native
    from x265_yuuki_asuna_tpu_torch.models import encoder_top as top
    from x265_yuuki_asuna_tpu_torch.parallel.session import \
        PipelinedEncoder
    P, NW = cu8_pins(), native_writer_pins()
    ok, t0 = {}, time.perf_counter()
    k1_start()                                    # the main path starts
    for name in P.SESSIONS:
        ok[name] = P.run(top, name, device=dev)[:2] == P.PINS[name]
    for seq in (False, True):
        ok[f"pipeline_{'sequential' if seq else 'clip'}"] = \
            P.run_pipeline(PipelinedEncoder, seq,
                           devices=["cuda:0"]) == P.PIPE_PIN
    with tempfile.TemporaryDirectory() as d:
        for kind, pin in P.TWO_FILE_PINS.items():
            ok[kind] = P.run_two_files(top, d, kind, device=dev) == pin
    launches, sizes = k1_read(), k1_sizes()
    for name in P.REFUSED:
        try:
            P.run(top, name, device=dev)
            ok[f"refused_{name}"] = False
        except ValueError as e:
            ok[f"refused_{name}"] = "AQ at cu_size=8" in str(e)
    for name in NW.QT64_CASES:
        args, kw = NW.qt64_args(name)
        ok[f"qt64_{name}"] = NW.digest(native.encode_slice_qt64(
            *args, **kw)) == NW.QT64_PINS[name]
    emit(phase="golden_cu8", pins=len(ok), held=sum(ok.values()),
         failed=[k for k, v in ok.items() if not v],
         seconds=time.perf_counter() - t0, k1_launches=launches,
         k1_fused_by_size=sizes)
    if not all(ok.values()):
        raise AssertionError(
            f"golden_cu8: {[k for k, v in ok.items() if not v]}")
    if not launches["sad_sweep_best"] or not sizes[8]:
        raise AssertionError(f"golden_cu8: K1 launches {launches} {sizes}")
    return dict(launches, fused_by_size=sizes)


def phase_cu8_cpu_vs_card(dev):
    """The uniform 8x8 grid at 416x240 on the card and on the CPU: the
    IPPP session with the deblock and SAO (I + 2 P) and the B session
    (bframes 2, b-adapt 0: I, P, b, b); equal streams and frames."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    frames = synth_clip(4, 416, 240)
    out = {}
    for name, kw, n in (("ippp_lf", dict(deblock=True, sao=True), 3),
                        ("b", dict(bframes=2, b_adapt=0), 4)):
        got = {}
        for where in (dev, "cpu"):
            s = VideoEncoderSession(416, 240, qp=32, cu_size=8, keyint=250,
                                    device=where, **kw)
            res = push_all(s, frames[:n]) if kw.get("bframes") else \
                [s.encode_frame(*f) for f in frames[:n]]
            got[str(where)] = (_md5_of(s, res),
                               [(r.frame_type, r.qp) for r in res])
        out[name] = got
    same = {k: len({repr(v) for v in g.values()}) == 1
            for k, g in out.items()}
    emit(phase="cu8_cpu_vs_card", streams={k: {w: v[0] for w, v in g.items()}
                                           for k, g in out.items()},
         frames={k: next(iter(g.values()))[1] for k, g in out.items()},
         identical=same)
    if not all(same.values()):
        raise AssertionError(f"cu8_cpu_vs_card: {same}")
    return same


def phase_1080p_cu8(dev, n_frames=3):
    """The uniform 8x8 grid at 1080p: VideoEncoderSession(1920, 1080,
    qp=32, cu_size=8, keyint=250) with the deblock and SAO over
    synth_clip, I + 2 P timed (fps after the IDR, stage ms, bytes,
    PSNR-Y, peak memory), then one more P frame under torch.profiler
    (its launches and the device's idle share); K1's launches by entry
    point and the fused sweep's by size (every sweep at n = 8: one
    lookahead sweep a frame, one ME sweep a P frame on the 1080x1920
    plane); the last P frame's program again with K1 patched to its plain
    version, identical."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    from x265_yuuki_asuna_tpu_torch.utils import geometry as G
    frames = synth_clip(n_frames + 1, W1080, H1080)
    sess = VideoEncoderSession(W1080, H1080, qp=32, cu_size=8, keyint=250,
                               deblock=True, sao=True, device=dev)
    total = len(sess.headers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, t_frames = [], []
    k1_start()                                    # the main path starts
    for fr in frames[:n_frames]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(sess.encode_frame(*fr))
        torch.cuda.synchronize()
        t_frames.append(time.perf_counter() - t0)
        total += len(results[-1].nals)
    last_ref = sess.ref
    r_prof, rec = _device_record(lambda: sess.encode_frame(*frames[-1]))
    results.append(r_prof)
    launches, sizes = k1_read(), k1_sizes()
    peak = torch.cuda.max_memory_allocated()
    n_p = sum(r.frame_type == "P" for r in results)
    psnr = [r.psnr_y for r in results]
    emit(phase="1080p_cu8", frames=len(results), p_frames=n_p,
         coded=[sess.coded_w, sess.coded_h], cus=[sess.cols, sess.rows],
         fps_after_idr=(n_frames - 1) / sum(t_frames[1:]),
         frame_ms=[t * 1e3 for t in t_frames],
         stage_ms={k: v for k, v in sess.stage_ms.items()},
         profiled_p_frame=rec, bytes=total, frame_bytes=[
             len(r.nals) for r in results], psnr_y=psnr,
         frame_type=[r.frame_type for r in results],
         k1_launches=launches, k1_fused_by_size=sizes,
         max_memory_allocated=peak)
    want = {"sad_sweep_best": len(results) + n_p, "sad_block8_sweep": 0,
            "sad_block4_sweep": 0}
    if launches != want or sizes[8] != want["sad_sweep_best"]:
        raise AssertionError(f"1080p_cu8: K1 launches {launches} {sizes} "
                             f"!= {want}")
    if not (np.isfinite(psnr).all() and results[0].frame_type == "I" and
            n_p == len(results) - 1 and all(
                r.recon[0].shape == (H1080, W1080) for r in results)):
        raise AssertionError("1080p_cu8 output malformed")
    y, u, v = frames[-1]
    yp = G.pad_plane(y, sess.coded_h, sess.coded_w)
    up = G.pad_plane(u, sess.coded_h // 2, sess.coded_w // 2)
    vp = G.pad_plane(v, sess.coded_h // 2, sess.coded_w // 2)
    qp = results[-1].qp
    out_k = sess.inter_encoder.encode_frame(yp, up, vp, *last_ref, qp)
    with plain_k1():
        out_p = sess.inter_encoder.encode_frame(yp, up, vp, *last_ref, qp)
    same = _same_decisions(out_k, out_p)
    emit(phase="1080p_cu8_p_frame_plain_rerun", identical=same)
    if not same:
        raise AssertionError("1080p_cu8: kernel and plain P-frame "
                             "decisions differ")
    # the same frames on the uniform 16x16 grid, for the bytes and PSNR
    ref16 = VideoEncoderSession(W1080, H1080, qp=32, cu_size=16,
                                keyint=250, deblock=True, sao=True,
                                device=dev)
    t0 = time.perf_counter()
    res16 = [ref16.encode_frame(*fr) for fr in frames[:n_frames]]
    torch.cuda.synchronize()
    emit(phase="cu8_vs_cu16", frames=n_frames,
         frame_bytes=[[len(r.nals) for r in results[:n_frames]],
                      [len(r.nals) for r in res16]],
         psnr_y=[psnr[:n_frames], [r.psnr_y for r in res16]],
         bytes_change=sum(len(r.nals) for r in results[:n_frames])
         / sum(len(r.nals) for r in res16) - 1,
         ms=[sum(t_frames) * 1e3, (time.perf_counter() - t0) * 1e3])
    return dict(launches, fused_by_size=sizes)


# The phases after K1, as (key, phase function, keyword arguments), the
# longest first (by earlier runs' times) so that the pool ends together;
# each runs whole in one process, its K1 counts set to 0 just before its
# main path and read just after, as when the script ran them one by one.
# the paths whose every intra leaf the kernel commits (on the card, the
# plain or sign-hiding quantizer, 4:2:0), and those that keep the batched
# commit (RDOQ); main() checks both with _run_job's counters
IC_KERNEL_PATHS = ("1080p_qt2", "1080p_qt2_b", "1080p_qt2_b_lf",
                   "1080p_qt2_b_lf_sbh", "1080p_qt2_b_lf_sbh_aq",
                   "1080p_qt2_b_crf", "1080p_cli_medium",
                   "1080p_cli_ultrafast", "1080p_cli_superfast",
                   "1080p_cli_medium_main10", "1080p_flagship")
IC_BATCHED_PATHS = ("1080p_qt2_rdoq",)

JOBS = (
    ("1080p_intra_opts", "phase_1080p_intra_opts", {}),
    ("golden_cu8", "phase_golden_cu8", {}),
    ("1080p_cu8", "phase_1080p_cu8", {}),
    ("1080p_cli_superfast", "phase_1080p_cli_superfast", {}),
    ("1080p_qt2_rdoq", "phase_1080p", dict(name="1080p_qt2_rdoq",
                                           max_depth=2, n_frames=2,
                                           opts={"rdoq": True})),
    ("1080p_cli_medium_main10", "phase_1080p_cli_medium_main10", {}),
    ("1080p_intra", "phase_1080p_intra", {}),
    ("golden_intra_opts", "phase_golden_intra_opts", {}),
    ("1080p_cli_medium", "phase_1080p_cli_medium", {}),
    ("1080p_pipeline", "phase_1080p_pipeline", {}),
    ("cu8_cpu_vs_card", "phase_cu8_cpu_vs_card", {}),
    ("1080p_cli_ultrafast", "phase_1080p_cli_ultrafast", {}),
    ("1080p_api_p_only", "phase_1080p_api_p_only", {}),
    ("1080p_wpp_b", "phase_1080p_wpp_b", {}),
    ("1080p_qt2_b_lf_sbh", "phase_1080p_b", dict(
        name="1080p_qt2_b_lf_sbh", opts=dict(LF, sbh=True))),
    ("1080p_flagship", "phase_1080p_flagship", {}),
    ("1080p_rqt", "phase_1080p_rqt", {}),
    ("tools_cpu_vs_card", "phase_tools_cpu_vs_card", {}),
    ("1080p_ladder", "phase_1080p_ladder", {}),
    ("1080p_qt2_b_crf", "phase_1080p_b", dict(
        name="1080p_qt2_b_crf", opts=FLAGSHIP_CRF,
        n_frames=QT_B_CRF_FRAMES)),
    ("qt2_cpu_vs_card", "phase_qt2_cpu_vs_card", {}),
    ("1080p_qt2_b_lf_sbh_aq", "phase_1080p_b", dict(
        name="1080p_qt2_b_lf_sbh_aq", opts=dict(LF, sbh=True, **AQ))),
    ("golden_flagship", "phase_golden_flagship", {}),
    ("intra_opts_cpu_vs_card", "phase_intra_opts_cpu_vs_card", {}),
    ("1080p_api_superfast", "phase_1080p_api_superfast", {}),
    ("golden_main10", "phase_golden_main10", {}),
    ("lf_cpu_vs_card", "phase_qt2_cpu_vs_card", dict(
        phase="lf_cpu_vs_card", opts=LF)),
    ("1080p_b_uniform", "phase_1080p_b_uniform", {}),
    ("1080p_qt2_b_lf", "phase_1080p_b", dict(name="1080p_qt2_b_lf",
                                             opts=LF)),
    ("1080p_cli_ctu32", "phase_1080p_cli_ctu32", {}),
    ("1080p_qt2_b", "phase_1080p_b", {}),
    ("golden_cli", "phase_golden_cli", {}),
    ("weightp_cpu_vs_card", "phase_weightp_cpu_vs_card", {}),
    ("1080p_cli_intra_ctu32_wpp", "phase_1080p_cli_intra_ctu32_wpp", {}),
    ("golden_p_options", "phase_golden_p_options", {}),
    ("1080p_analysis", "phase_1080p_analysis", {}),
    ("golden_rqt", "phase_golden_rqt", {}),
    ("golden_pipeline", "phase_golden_pipeline", {}),
    ("pipeline_cpu_vs_card", "phase_pipeline_cpu_vs_card", {}),
    ("1080p_qt2", "phase_1080p", dict(name="1080p_qt2", max_depth=2,
                                      n_frames=QT_FRAMES)),
    ("main10_cpu_vs_card", "phase_cli_cpu_vs_card", dict(
        phase="main10_cpu_vs_card", argv=(), bit_depth=10)),
    ("golden_aq", "phase_golden_aq", {}),
    ("intra_cpu_vs_card", "phase_intra_cpu_vs_card", {}),
    ("1080p_aq_la", "phase_1080p_aq_la", {}),
    ("golden_weightp", "phase_golden_weightp", {}),
    ("golden_stream_opts", "phase_golden_stream_opts", {}),
    ("p_options_cpu_vs_card", "phase_p_options_cpu_vs_card", {}),
    ("cli_cpu_vs_card", "phase_cli_cpu_vs_card", {}),
    ("golden_grids", "phase_golden_grids", {}),
    ("golden_rc", "phase_golden_rc", {}),
    ("1080p_abr_vbv", "phase_1080p_abr_vbv", {}),
    ("rc_cpu_vs_card", "phase_rc_cpu_vs_card", {}),
    ("ultrafast_cpu_vs_card", "phase_cli_cpu_vs_card", dict(
        phase="ultrafast_cpu_vs_card", argv=("--preset", "ultrafast"))),
    ("golden_intra", "phase_golden_intra", {}),
    ("golden_lf", "phase_golden_lf", {}),
    ("1080p", "phase_1080p", dict(name="1080p", max_depth=0,
                                  n_frames=FRAMES)),
    ("golden_qt2", "phase_golden", dict(key="qt2_ippp", qp=30,
                                        max_depth=2)),
    ("golden_qt2_b", "phase_golden_qt2_b", {}),
    ("golden", "phase_golden", dict(key="ippp_cqp", qp=32, cu_size=16)),
    ("lossless_cpu_vs_card", "phase_lossless_cpu_vs_card", {}),
    ("golden_analysis", "phase_golden_analysis", {}),
    ("golden_ladder", "phase_golden_ladder", {}),
    ("golden_sei_tools", "phase_golden_sei_tools", {}),
)
WORKERS = 4     # processes sharing the card (8 host cores)
_SINK = None    # a worker's queue to the parent (emit's lines, results)


def _run_job(dev, job):
    """(the phase's result, its intra commit counters: its main path's,
    from k1_start to its last k1_read, or the whole job's where it has
    no main path)."""
    key, fn, kw = job
    _IC_MAIN[0] = None
    ic_counts(reset=True)
    res = globals()[fn](dev, **kw)
    return res, _IC_MAIN[0] or dict(ic_counts(), span="job")


def _worker(t0, nxt, sink, go, threads):
    """One process of the pool: takes the next job of JOBS until none is
    left; sends each JSON line, each result and any failure to sink."""
    import traceback
    global T0, _SINK
    T0, _SINK = t0, sink
    torch.set_num_threads(threads)
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)            # the context, while K1 runs
    go.wait()
    while True:
        with nxt.get_lock():
            i, nxt.value = nxt.value, nxt.value + 1
        if i >= len(JOBS):
            break
        try:
            res = _run_job(dev, JOBS[i])
        except BaseException:
            sink.put(("error", JOBS[i][0], traceback.format_exc()))
            return
        sink.put(("result", JOBS[i][0], res))
    sink.put(("done", None, None))


def run_jobs(dev, workers: int, start) -> dict:
    """Every job of JOBS, on `workers` processes sharing the card (1: in
    this process, one after the other); start() runs here first, while
    the workers reach the card. Returns start()'s result, {key: the
    phase's result} and {key: its intra commit counters} (_run_job). A
    failed job fails the run, and every worker is stopped."""
    import multiprocessing as mp
    import queue
    if workers <= 1:
        out = start()
        results = {job[0]: _run_job(dev, job) for job in JOBS}
        return (out, {k: r for k, (r, _) in results.items()},
                {k: ic for k, (_, ic) in results.items()})
    ctx = mp.get_context("spawn")
    nxt, sink, go = ctx.Value("i", 0), ctx.Queue(), ctx.Event()
    threads = max(1, (os.cpu_count() or 8) // workers)
    procs = [ctx.Process(target=_worker, args=(T0, nxt, sink, go, threads),
                         daemon=True) for _ in range(workers)]
    for p in procs:
        p.start()
    results, done = {}, 0
    try:
        out = start()
        go.set()
        while done < workers:
            try:
                kind, key, val = sink.get(timeout=10)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead or not any(p.is_alive() for p in procs):
                    raise RuntimeError(f"a worker ended without its "
                                       f"jobs done: exit codes {dead}")
                continue
            if kind == "line":
                print(val, flush=True)
            elif kind == "result":
                results[key] = val
            elif kind == "error":
                raise AssertionError(f"phase {key} failed:\n{val}")
            else:
                done += 1
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    missing = [job[0] for job in JOBS if job[0] not in results]
    if missing:
        raise RuntimeError(f"jobs without a result: {missing}")
    return (out, {k: r for k, (r, _) in results.items()},
            {k: ic for k, (_, ic) in results.items()})


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--workers", type=int, default=WORKERS,
                    help="processes that share the card for the phases "
                    "after K1 (1: all in this process)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    def start():
        # the build and K1's timings, with no other process on the card
        smi, card = phase_build()
        k1, err = phase_k1(dev, card)
        k1_16, err16 = phase_k1_int16(dev, card)
        k1_32, err32 = phase_k1_n32(dev, card)
        k1_8, err8 = phase_k1_n8(dev, card)
        ic = phase_intra_commit(dev)
        return smi, k1, k1_16, k1_32, k1_8, ic, max(err, err16, err32,
                                                    err8)
    (smi, k1, k1_16, k1_32, k1_8, ic, err), res, ic_by_path = run_jobs(
        dev, args.workers, start)
    # the intra commit on each path: the kernel takes every intra leaf
    # where the dispatch rule holds (on the card, no RDOQ or scaling
    # lists, 4:2:0), none under RDOQ
    bad = {p: ic_by_path[p] for p in IC_KERNEL_PATHS
           if ic_by_path[p]["batched_leaves"]}
    bad.update({p: ic_by_path[p] for p in IC_BATCHED_PATHS
                if ic_by_path[p]["launches"]})
    emit(phase="intra_commit_paths", by_path=ic_by_path, mismatched=bad)
    if bad:
        raise AssertionError(f"intra commit dispatch: {bad}")
    golden10, golden_opts, golden_popts = (
        res["golden_main10"], res["golden_stream_opts"],
        res["golden_p_options"])
    by_path = {k: res[k] for k in ("1080p", "1080p_qt2")}
    by_path["1080p_qt2_b"] = res["1080p_qt2_b"][0]
    by_path["1080p_qt2_b_lf"], lf = res["1080p_qt2_b_lf"]
    by_path["1080p_qt2_b_lf_sbh"], sbh = res["1080p_qt2_b_lf_sbh"]
    emit(phase="sbh_vs_no_sbh", fps=[sbh["fps"], lf["fps"]],
         bytes=[sbh["bytes"], lf["bytes"]],
         bytes_change=sbh["bytes"] / lf["bytes"] - 1,
         psnr_y_change=[a - b for a, b in zip(sbh["psnr_y"], lf["psnr_y"])])
    by_path["1080p_qt2_b_lf_sbh_aq"], aq = res["1080p_qt2_b_lf_sbh_aq"]
    emit(phase="aq_vs_no_aq", fps=[aq["fps"], sbh["fps"]],
         bytes=[aq["bytes"], sbh["bytes"]],
         bytes_change=aq["bytes"] / sbh["bytes"] - 1,
         frame_bytes_change=[a / b - 1 for a, b in zip(
             aq["frame_bytes"], sbh["frame_bytes"])],
         **{f"{k}_change": [a - b for a, b in zip(aq[k], sbh[k])]
            for k in ("psnr_y", "psnr_u", "psnr_v", "ssim_y")})
    by_path["1080p_aq_la"] = res["1080p_aq_la"]
    by_path["1080p_qt2_b_crf"], crf = res["1080p_qt2_b_crf"]
    # the frames both runs coded (the IDR and the first mini-GOP); the
    # CQP run's frames carry a hash SEI, the flagship's do not
    k = len(aq["frame_bytes"])
    emit(phase="crf_vs_cqp", crf="1080p_qt2_b_crf", cqp="1080p_qt2_b_lf_sbh_aq",
         fps=[crf["fps"], aq["fps"]], frames=[len(crf["qp"]), k],
         frame_type=crf["frame_type"][:k], qp=[crf["qp"][:k], aq["qp"]],
         frame_bytes=[crf["frame_bytes"][:k], aq["frame_bytes"]],
         bytes_first_frames=[sum(crf["frame_bytes"][:k]),
                             sum(aq["frame_bytes"])],
         kbps_at_25fps=[crf["kbps_at_25fps"], aq["kbps_at_25fps"]],
         rc_ms_per_frame=[crf["stage_ms_per_frame"].get("rc", 0.0),
                          aq["stage_ms_per_frame"].get("rc", 0.0)],
         **{k_: [crf[k_][:k], aq[k_]]
            for k_ in ("psnr_y", "psnr_u", "psnr_v", "ssim_y")})
    for key in ("1080p_abr_vbv", "1080p_qt2_rdoq", "1080p_intra",
                "1080p_flagship", "1080p_cli_superfast",
                "1080p_api_superfast", "1080p_cli_medium",
                "1080p_cli_ultrafast", "1080p_b_uniform",
                "1080p_cli_medium_main10", "1080p_cli_intra_ctu32_wpp"):
        by_path[key] = res[key]
    by_path["1080p_cli_ctu32"], sizes32 = res["1080p_cli_ctu32"]
    by_path["1080p_api_p_only"], sizes_p = res["1080p_api_p_only"]
    for key in ("1080p_wpp_b", "golden_intra_opts", "1080p_intra_opts",
                "golden_rqt", "golden_analysis", "golden_ladder",
                "1080p_rqt", "1080p_ladder", "golden_pipeline",
                "pipeline_cpu_vs_card", "1080p_pipeline", "golden_cu8",
                "1080p_cu8"):
        by_path[key] = res[key]
    analysis = res["1080p_analysis"]
    for name, counts in analysis.items():
        by_path[f"1080p_analysis_{name}"] = counts
    # the flagship's path: every entry point runs there
    launches = by_path["1080p_flagship"]
    me = k1["P-frame ME 1088x1920"]
    r24 = k1[R24_ME]
    hme = k1["hme 544x960"]
    common = {"route": "cuda",
              "source": "x265_yuuki_asuna_tpu_torch/csrc/me_sad.cu",
              "replaces": "x265_yuuki_asuna_tpu/ops/pallas/me_sad.py:56",
              "max_abs_err": err, "library_ms": None}
    per_path = lambda k: {p: c[k] for p, c in by_path.items()}
    la16, me16 = k1_16["lookahead 544x960 int16"], \
        k1_16["P-frame ME 1088x1920 int16"]
    me16_r24 = k1_16["P-frame ME 1088x1920 int16 12-bit R=24"]
    hme16 = k1_16["hme 544x960 int16"]
    me32 = k1_32["ME 1088x1920 n=32"]
    me32_16 = k1_32["ME 1088x1920 n=32 int16"]
    me8, me8_16 = k1_8["ME 1080x1920 n=8"], k1_8["ME 1080x1920 n=8 int16"]
    la8, la8_16 = (k1_8["lookahead 536x960 n=8"],
                   k1_8["lookahead 536x960 n=8 int16"])
    pick = lambda r: {k: r[k] for k in ("shape", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "route_ms")}
    # each entry point on the 10-bit path's int16 planes: its time, plain
    # time and bound, and its launches there (the 1080p path; HME's 4x4
    # surface runs on the 10-bit flagship session of golden_main10)
    i16 = lambda r, pre: {"shape": r["shape"], "ms": r[pre + "ms"],
                          "plain_ms": r[pre + "plain_ms"],
                          "bound_ms": r[pre + "bound_ms"],
                          "bound_by": r[pre + "bound_by"]}
    main10 = {"1080p_cli_medium_main10": by_path["1080p_cli_medium_main10"],
              "golden_main10": golden10}
    emit(kernels=[
        {"name": "sad_block8_sweep", **common,
         "launches": launches["sad_block8_sweep"],
         "launches_by_path": per_path("sad_block8_sweep"),
         "ms": me["surface_ms"], "plain_ms": me["surface_plain_ms"],
         "bound_ms": me["surface_bound_ms"],
         "bound_by": me["surface_bound_by"],
         "r24": {"ms": r24["surface_ms"],
                 "plain_ms": r24["surface_plain_ms"],
                 "bound_ms": r24["surface_bound_ms"],
                 "bound_by": r24["surface_bound_by"]},
         "int16": dict(i16(me16, "surface_"), r24_12bit=i16(
             me16_r24, "surface_"), launches_main10={
                 p: c["sad_block8_sweep"] for p, c in main10.items()}),
         # RQT: the quadtree P frame's one surface, as without it
         "rqt": {"1080p_rqt": res["1080p_rqt"]["sad_block8_sweep"],
                 "golden_rqt": res["golden_rqt"]["sad_block8_sweep"]}},
        {"name": "sad_sweep_best", **common,
         "launches": launches["sad_sweep_best"],
         "launches_by_path": per_path("sad_sweep_best"),
         "ms": me["best_ms"], "plain_ms": me["best_plain_ms"],
         "bound_ms": me["best_bound_ms"], "bound_by": me["best_bound_by"],
         "int16": dict(i16(me16, "best_"), lookahead=i16(la16, "best_"),
                       r24_12bit=i16(me16_r24, "best_"),
                       key_dtype=me16["key_dtype"], launches_main10={
                           p: c["sad_sweep_best"] for p, c in main10.items()
                       }),
         # n = 32: the uniform CTU32 grid's ME (1080p_cli_ctu32)
         "n32": {"shape": me32["shape"], "ms": me32["ms"],
                 "plain_ms": me32["plain_ms"], "bound_ms": me32["bound_ms"],
                 "bound_by": me32["bound_by"],
                 "route_ms": me32["route_ms"],
                 "launches": sizes32[32],
                 "launches_golden_stream_opts":
                     golden_opts["sad_sweep_best"],
                 "key_dtypes": {r["bit_depth"]: r["key_dtype"]
                                for r in k1_32.values()},
                 "int16": {k: me32_16[k] for k in (
                     "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                     "route_ms")}},
         # n = 8 on a full-resolution plane: the uniform 8x8 grid's ME
         # (1080p_cu8: every fused sweep there is n = 8, the lookahead's
         # and the ME's)
         "n8_full": dict(pick(me8), launches=res["1080p_cu8"][
             "fused_by_size"][8], launches_golden_cu8=res["golden_cu8"][
                 "fused_by_size"][8], int16=pick(me8_16),
             lookahead=dict(pick(la8), int16=pick(la8_16)),
             crop_flat_max_abs_err={r["shape"]: r["max_abs_err"]
                                    for r in k1_8.values()}),
         # the P-frame options: two sweeps per two-reference P frame
         "p_options": {"1080p_api_p_only_by_size": sizes_p,
                       "launches_golden_p_options":
                           golden_popts["sad_sweep_best"]},
         # analysis reuse: the loaded P frames run no ME sweep (the
         # lookahead's one a frame stays); the ladder's rungs
         "analysis": {f"1080p_analysis_{k}": v["sad_sweep_best"]
                      for k, v in analysis.items()},
         "ladder": res["1080p_ladder"]["sad_sweep_best"],
         # the pipeline: one fused sweep per P frame, on its slot's stream
         "pipeline": {k: res[k]["sad_sweep_best"] for k in (
             "golden_pipeline", "pipeline_cpu_vs_card", "1080p_pipeline")}},
        {"name": "sad_block4_sweep", **common,
         "launches": launches["sad_block4_sweep"],
         "launches_by_path": per_path("sad_block4_sweep"),
         "ms": hme["ms"], "plain_ms": hme["plain_ms"],
         "bound_ms": hme["bound_ms"], "bound_by": hme["bound_by"],
         "int16": dict(i16(hme16, "surface_"), launches_main10={
             p: c["sad_block4_sweep"] for p, c in main10.items()})},
        # the intra commit: one 1080p P anchor of medium-psnr-1080p.pan
        # (its time, bounds and agreement), launches and leaves on each
        # path's main path
        {"name": "intra_commit", "route": "cuda",
         "source": "x265_yuuki_asuna_tpu_torch/csrc/intra_commit.cu",
         "replaces": None, "max_abs_err": 0 if ic["agree"] else None,
         "library_ms": None,
         "launches": ic_by_path["1080p_flagship"]["launches"],
         "launches_by_path": {p: c["launches"]
                              for p, c in ic_by_path.items()},
         "leaves_by_path": {p: c["leaves"] for p, c in ic_by_path.items()},
         "batched_leaves_by_path": {p: c["batched_leaves"]
                                    for p, c in ic_by_path.items()},
         "ms": ic["kernel_ms"],
         "plain_ms": ic["batched_ms"], "bound_ms": max(
             ic["bound_bytes_ms"], ic["chain_floor_ms"]),
         "bound_by": "chain" if ic["chain_floor_ms"] >= ic["bound_bytes_ms"]
         else "bytes"}])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
