"""Top-level encoder sessions: the all-intra session, and the video
session (IPPP with one or, on the uniform grid, two L0 references, and
mini-GOPs with B frames fixed or chosen by b-adapt, one reference per
list, on the uniform grid of 16x16 or 32x32 CUs or the CTU32 quadtree of
depth 1 or 2), under CQP, CRF or ABR rate control with VBV.

Port of x265_yuuki_asuna_tpu/models/encoder_top.py: IntraEncoderSession
(encode_frame, the frame batches submit_batch / finish_batch /
encode_batch, headers with the info, mastering-display and
content-light-level SEI, the sei_provider hook, lossless, slices, WPP,
scaling lists, the three hash SEI types, 4:4:4, noise reduction, fast
intra and the CTU64 quadtree with its deblock and writer) and
VideoEncoderSession.encode_frame with its headers, I/P slice assembly,
hash SEI, scenecut (the cost rule or the histogram rule) and keyint_min;
push_frame / flush with b_adapt 0, 1 and 2, the rc-lookahead window, the
B-pyramid, open GOP (CRA keyframes with RASL leading pictures) and the B
slice assembly; RQT on the quadtree's P and B frames; analysis save /
load / share with scale_factor on the uniform IPPP path
(scale_analysis_rec, read_analysis). As in the reference, the video
session codes its I frames through an IntraEncoderSession. Device work
(lookahead, intra and inter programs) runs on `device`; the CABAC pass
runs on the host through the native writer (WPP substreams, and P slices
with two references or TMVP, through the Python CABAC of
bitstream/cabac.py and inter_syntax.py). The streams are byte-identical
to the JAX package's.

The uniform IPPP session's P-frame options, with the reference's rules:
n_refs=2 (two L0 references: the P program searches both and picks one
per CU, the slice signals ref_idx_l0; the first P frame after an IDR has
one, which the program searches twice), tmvp (temporal MV prediction:
the previous frame's motion field is the collocated one; dropped on B
and quadtree sessions), max_merge (the merge candidates, every path) and
frame_dup with dup_threshold (a frame whose luma PSNR against the
previous source reaches the threshold is coded as an all-skip P slice
with no program, its recon the reference's; not with B frames, two
references or TMVP). wpp (the uniform grid; dropped on the quadtree)
codes every slice as WPP substreams through the Python CABAC, P and B
slices too.

With max_depth=2 the sessions code CTU32 quadtrees down to 8x8 CUs, with
max_depth=1 down to 16x16 (x265's ultrafast: the programs decide over
sizes 32 and 16, the leaf at 16 codes no split flag; the JAX video
session's device-DPB quadtree path): the reference pictures
stay on the device between frames and are copied to the host only for
the hash SEI, the quality metrics and the returned recon (recon_out=False
with neither of the others: never, and FrameResult.recon is None). With
dpb_device=False, and always under weightp, the session codes the JAX
session's host-filter quadtree path instead: its references stay on the
device too, but every frame's filters run in the reference's host form
(the SAO cost's float32 rounding, ops/sao.py) and a B session takes each
frame's QP as it codes it. hme
adds the hierarchical search to the quadtree P and B programs, psy_rd
the psycho-visual term to their leaf RD (and the intra program's), and
b_intra intra candidates to the B program (then committed as in P
frames).

deblock and sao switch on the in-loop filters (each alone or both), on
every path: on the uniform grid the sessions filter each coded picture as
the JAX sessions' host paths do (the SAO "CTU" is the CU); the
quadtree programs run the JAX device-DPB filter chain after the commit
(the intra session without dpb_device runs the same deblock and the
host form of SAO). The filtered picture is the reference, the recon
returned and the one the hash SEI hashes; the SAO parameters go into the
slice data.

weightp turns on explicit weighted prediction of P frames (the IPPP
frames and a B session's P anchors; the PPS's weighted_pred_flag, a
pred_weight_table in every P slice): per frame, _decide_weights picks a
weight and offset per component from the 4x-subsampled source and
reference planes (numpy float64 on the host, in the reference's order),
and the P program searches on the weighted reference and predicts
through the normative weighted combine.

sbh (sign-bit hiding) and rdoq (RDOQ, with psy_rdoq) change how every
program picks its levels (ops/quant.Quantizer); sign hiding is off under
RDOQ, as in the reference.

aq_mode (1-4, with aq_strength) and cutree give every frame a per-CU QP
map (the CTU's on the quadtree): adaptive quantization's offsets from the
source's AC energy (the intra session's with the chroma planes', the
video session's luma only, as in the reference) and cuTree's from the
lookahead's motion, clipped around the frame QP. The map goes into every
program, the deblock (at the decoder-side QP: a CTU with no coded residual
keeps the previous one's) and the writers (PPS cu_qp_delta, one delta per
CTU). cuTree takes a causal average over the frames so far; with
rc_lookahead > 0 an IPPP session delays its frames through push_la /
flush_la and propagates the costs of the window after each frame
backwards (models/slicetype.py). B sessions keep the reference's parked
average, whose offsets stay 0.

Rate control (models/ratecontrol.py) gives each frame its QP: rc_mode
"cqp", "crf" (crf) or "abr" (bitrate_kbps), with VBV (vbv_maxrate_kbps
and vbv_bufsize_kbps), qp_min / qp_max and zones; stats_write /
stats_read run the two passes. On the IPPP path, as in the reference,
the QP comes from the lookahead's cost of the frame and of the frames
still in the rc-lookahead window (or from pass 2), then the zone, then
scene-cut-aware QP's window after a cut; hrd adds the HRD to the VUI and
a buffering-period / pic-timing SEI to each access unit; a frame that
would underflow the VBV buffer is coded again, at most twice, at a
higher QP (the retry drops the prefix SEI, the reference's fault: ROADMAP
Queue 3); stats_write records each frame. The B path takes each frame's
QP from the rate control and the zone only (the reference has neither
the HRD SEI, the scene-cut window nor pass-1 records there, though the
VUI signals the HRD).

With bframes > 0 (on either grid) frames go through push_frame and flush:
each mini-GOP codes its last frame as a P anchor, then the frames before
it as B frames between the two anchors; with b_pyramid and two or more B
frames the middle one is a referenced B (TRAIL_R) that the outer ones
predict from. b_adapt=0 closes every mini-GOP at bframes + 1 frames;
b_adapt=1 closes it early at a frame the lookahead predicts poorly
(from the frame before, then from the anchor); b_adapt=2 (the default)
runs the trellis over bframes + 1 pending frames and closes the mini-GOP
at the P placement of least cost per frame, the rest staying pending.
With cutree and rc_lookahead > 0 each frame waits in the rc-lookahead
window until rc_lookahead later frames are analysed, and its QP map
takes cuTree's offsets propagated back from them. The port codes a
mini-GOP's frames one after another. The JAX session pipelines them under
CQP without two-pass: it takes every frame's QP at submit, before any of
the mini-GOP's frames is fed back. With a constant QP that codes the same
stream as in order; under CQP with VBV the buffer moves between frames,
so the port then takes the mini-GOP's QPs first, in submit order, and
feeds the frames back in coding order after them. CRF, ABR and two-pass
B sessions run in order in the reference too.
"""

from __future__ import annotations

import hashlib
import math
import pickle
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..bitstream import ctu_syntax as CS
from ..bitstream import headers as HDR
from ..bitstream import inter_syntax as IS
from ..bitstream import native, sei as SEI
from ..bitstream.cabac import CabacEncoder
from ..bitstream.scaling import ScalingListData
from ..bitstream.tables import CTX_OFFSET
from ..bitstream.bitio import (BitWriter, wrap_nal, NAL_CRA, NAL_IDR_W_RADL,
                               NAL_RASL_N, NAL_SUFFIX_SEI, NAL_TRAIL_N,
                               NAL_TRAIL_R)
from ..ops import deblock as DB
from ..ops import filters as FL
from ..ops import quant
from ..ops import sao as SAO
from ..ops.pixel import ssim_plane
from ..ops.quant import Quantizer
from ..utils import geometry as G
from ..utils.device import exact_fp32_matmul, resolve_device
from .inter_encoder import InterFrameEncoder, InterQTEncoder
from .intra_encoder import (IntraFrameEncoder, IntraQT64Encoder,
                            IntraQTEncoder, chroma_qp_from_luma)
from . import slicetype
from .lookahead import Lookahead
from .ratecontrol import (RateControl, RCConfig, StatsWriter, TwoPassRC,
                          compute_aq_offsets)

FPS = (25, 1)      # default signalled frame rate (VUI timing, level)

def scale_analysis_rec(rec: dict, sf: int, rows: int, cols: int) -> dict:
    """An analysis record's CU-grid MV hints for a session sf times the
    size (--scale-factor, the ladder's hand-off): each grid repeated sf
    times along both axes, cropped to rows x cols, the missing rows and
    columns filled from the edge, and the vectors multiplied by sf."""
    out = dict(rec)
    for k in ("mvx", "mvy"):
        if k in rec:
            g = np.repeat(np.repeat(rec[k], sf, 0), sf, 1)[:rows, :cols]
            pr, pc = rows - g.shape[0], cols - g.shape[1]
            if pr > 0 or pc > 0:
                g = np.pad(g, ((0, max(pr, 0)), (0, max(pc, 0))),
                           mode="edge")
            out[k] = (g * sf).astype(np.int32)
    return out


def read_analysis(path: str) -> list:
    """The records of an --analysis-save file (pickled one after
    another), in order."""
    recs = []
    with open(path, "rb") as f:
        try:
            while True:
                recs.append(pickle.load(f))
        except EOFError:
            pass
    return recs


def _grid(max_depth: int, cu_size: int, intra: bool = False) -> int:
    """The CTU size of a session: cu_size (8, 16 or 32) on the uniform
    grid; with a quadtree, 64 for the all-intra session's cu_size=64
    (max_depth 2 or 3, else ValueError: the 64x64 CU always splits, as the
    reference's program asserts), else 32 (max_depth 1 or 2, whatever
    cu_size, as in the reference's sessions: its video sessions code
    CTU32). Other geometries raise NotImplementedError. The uniform 8x8
    grid writes a CTU of 8, outside every HEVC profile (CTUs of 16 to 64),
    as the reference does: libde265 decodes its streams, FFmpeg refuses
    them."""
    if intra and max_depth and cu_size == 64:
        if max_depth not in (2, 3):
            raise ValueError(
                f"max_depth={max_depth} with cu_size=64: the 64x64 CU "
                "always splits, so max_depth is 2 or 3 (the reference's "
                "assertion)")
        return 64
    if max_depth not in (0, 1, 2):
        raise NotImplementedError(
            f"max_depth={max_depth}: the port codes the uniform grid "
            "(0), the CTU32 quadtree of depth 1 or 2 and, in the "
            "all-intra session with cu_size=64, the CTU64 quadtree of "
            "depth 2 or 3. Deeper on CTU32 means CUs under 8x8, which "
            "HEVC does not allow: the reference codes them but cannot "
            "write its SPS (log2_min_luma_coding_block_size_minus3 = -1 "
            "fails its assertion), so it has no stream (ROADMAP Queue 1 "
            "item 9b)")
    if max_depth:
        return 32
    if cu_size not in (8, 16, 32):
        raise NotImplementedError(
            f"cu_size={cu_size}: the uniform grid codes 8x8, 16x16 and "
            "32x32 CUs, as the reference's does; CTU64 is the all-intra "
            "session's quadtree (max_depth 2 or 3)")
    return cu_size


def _aq_grid_check(yp, cu: int) -> None:
    """AQ on a CU grid finer than 16x16 raises ValueError for a plane of
    a 16x16 block or more: compute_aq_offsets' map comes on the 16x16
    grid, a quarter of the 8x8 CUs, and the reference's session fails on
    the shapes at the frame's QP map."""
    if cu < 16 and min(np.shape(yp)) >= 16:
        raise ValueError(
            f"AQ at cu_size={cu}: the offsets come on the 16x16 grid, a "
            "quarter of the 8x8 CU grid's blocks, and the reference fails "
            "on the shapes there (ROADMAP Queue 3)")


def psnr(a, b, bit_depth: int = 8) -> float:
    """PSNR of a plane against its source at the bit depth's peak (the
    reference's numpy expression)."""
    pk = (1 << bit_depth) - 1
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 99.99 if mse == 0 else 10 * np.log10(pk * pk / mse)


def frame_quality(recon, y, u, v, device="cpu", bit_depth: int = 8):
    """PSNR of Y, U and V and SSIM of Y against the source at the bit
    depth's peak (port of the reference's frame_quality; every value
    equals the reference's bit for bit: the SSIM windows run on
    `device`)."""
    return (psnr(recon[0], y, bit_depth), psnr(recon[1], u, bit_depth),
            psnr(recon[2], v, bit_depth),
            ssim_plane(np.asarray(recon[0]), np.asarray(y), device,
                       bit_depth))


def host_planes(out: dict, h: int, w: int, bit_depth: int,
                c_shift: int = 1):
    """The decision dict's recon planes cropped to h x w (chroma h x w
    shifted right by c_shift: 1 in 4:2:0, 0 in 4:4:4), as the
    reference's sessions return them: uint8 at 8 bits, uint16 above."""
    pdt = np.uint16 if bit_depth > 8 else np.uint8
    ch, cw = h >> c_shift, w >> c_shift
    return (out["recon_y"][:h, :w].astype(pdt),
            out["recon_u"][:ch, :cw].astype(pdt),
            out["recon_v"][:ch, :cw].astype(pdt))


def effective_qp_map(out: dict, qp_map, slice_qp: int):
    """The decoder-side QP of every CU of a per-CU QP map ([rows, cols]), or
    None without one: a CU with no coded residual codes no cu_qp_delta, so
    its QP stays the previous coded CU's (the slice QP before the first;
    spec 8.6.1). The loop filter must use these values."""
    if qp_map is None:
        return None
    rows, cols = qp_map.shape
    has = (np.asarray(out["levels_y"]).reshape(rows, cols, -1).any(-1)
           | np.asarray(out["levels_cb"]).reshape(rows, cols, -1).any(-1)
           | np.asarray(out["levels_cr"]).reshape(rows, cols, -1).any(-1))
    return FL.effective_qp(torch.as_tensor(qp_map.reshape(-1)),
                           torch.as_tensor(has.reshape(-1)),
                           slice_qp).numpy().reshape(rows, cols)


def filter_uniform(out: dict, qp: int, is_idr: bool, cu: int, deblock: bool,
                   sao: bool, src3, device, stage_ms,
                   bit_depth: int = 8, deblock_bit_depth: int = None) -> None:
    """The uniform grid's in-loop filters on a decision dict's recon (the
    JAX sessions' host path): the IDR deblocked with every CU edge at BS
    2, a P or B frame with per-edge BS (a B frame's from its pdir and each
    list's MVs, an unused list's zeroed), at the slice QP qp or, with a
    "qp_map" in out, at each CU's decoder-side QP; then SAO per cu x cu CU
    in the host form at the slice QP. src3: the padded source planes. Sets
    the filtered recon_* and, with sao, "sao" (packed [ncu, 18]). Each
    filter is timed as its stage of stage_ms ("deblock", "sao"), inside a
    profiler range named "filters". bit_depth: the samples'; the deblock
    runs at deblock_bit_depth (default bit_depth): the reference's video
    session deblocks its uniform grid at 8 bits whatever the samples'
    depth (ROADMAP Queue 3)."""
    bd = bit_depth
    dbd = bit_depth if deblock_bit_depth is None else deblock_bit_depth
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    with torch.profiler.record_function("filters"):
        t0 = time.perf_counter()
        rec = tuple(t(out[k]).to(torch.int32)
                    for k in ("recon_y", "recon_u", "recon_v"))
        qpc = chroma_qp_from_luma(qp)
        qmap = effective_qp_map(out, out.get("qp_map"), qp)
        qarg = qp if qmap is None else qmap
        if deblock and is_idr:
            rec = DB.deblock_frame_uniform(*rec, cu, qarg, qpc, dbd)
        elif deblock:
            cbf = t(out["levels_y"]).ne(0).flatten(2).any(2)
            pdir = out.get("pdir")
            mvs = (out["mvx"], out["mvy"]) if pdir is None else _b_mvs(out)
            bs_v, bs_h = DB.compute_bs_uniform(
                t(out["use_intra"]), cbf, None if pdir is None else t(pdir),
                *(t(m) for m in mvs))
            rec = DB.deblock_frame_inter(*rec, cu, qarg, qpc, bs_v, bs_h, dbd)
        if deblock:
            sync()
            t1 = time.perf_counter()
            stage_ms["deblock"] += (t1 - t0) * 1e3
            t0 = t1
        if sao:
            src = tuple(t(p).to(torch.int32) for p in src3)
            rec, params = SAO.sao_frame(rec, src, cu, qp, "host", bd)
            out["sao"] = params.cpu().numpy()
        out["recon_y"], out["recon_u"], out["recon_v"] = (
            p.cpu().numpy() for p in rec)
        stage_ms["sao" if sao else "deblock"] += \
            (time.perf_counter() - t0) * 1e3


def _amvp_choice(mv, preds):
    """(mvp flag, MVD) of mv against the two AMVP predictors: the one
    nearer in L1 distance, the first on a tie."""
    costs = [abs(mv[0] - p[0]) + abs(mv[1] - p[1]) for p in preds]
    flag = 0 if costs[0] <= costs[1] else 1
    return flag, (mv[0] - preds[flag][0], mv[1] - preds[flag][1])


def _dup_psnr(y, prev) -> float:
    """The luma PSNR of a source frame against the previous one at the
    peak 255, whatever the bit depth (the reference's duplicate-frame
    test)."""
    diff = np.abs(y.astype(np.int32) - prev.astype(np.int32))
    mse = float(np.mean(diff.astype(np.float64) ** 2))
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _b_mvs(out: dict):
    """A uniform B frame's (mv0x, mv0y, mv1x, mv1y), each list's MVs zeroed
    where its CU does not predict from that list (pdir bit 1: L0, bit 2:
    L1), as the reference session hands them to the deblock and the
    writer."""
    pd = out["pdir"]
    m0, m1 = (pd & 1).astype(bool), (pd & 2).astype(bool)
    return (np.where(m0, out["mvx"], 0), np.where(m0, out["mvy"], 0),
            np.where(m1, out["mv1x"], 0), np.where(m1, out["mv1y"], 0))


@dataclass
class FrameResult:
    """One coded picture: its NAL units (slice + hash SEI), the recon
    cropped to the source size (None for a batch frame coded without
    one), its picture order count, its type: "I" (IDR), "P", "B" (a
    referenced B, the pyramid's middle) or "b" (a non-referenced B), and
    its quality: PSNR of Y, U and V and SSIM of Y."""
    nals: bytes
    recon: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    bits: int
    psnr_y: float
    frame_type: str = ""   # I / P / B / b
    qp: int = 0
    poc: int = 0
    psnr_u: float = 0.0
    psnr_v: float = 0.0
    ssim_y: float = 0.0


def _timed(stage_ms, stage: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    stage_ms[stage] += (time.perf_counter() - t0) * 1e3
    return out


def _program(stage_ms, stage: str, enc, *args, **kw) -> dict:
    """A frame program's decision dict; the quadtree programs' filters
    are timed as their own stages ("filters" for the device-DPB chain,
    "deblock" and "sao" for the host form), the rest as `stage`."""
    out = _timed(stage_ms, stage, enc.encode_frame, *args, **kw)
    flt = getattr(enc, "filters", None)
    for k, ms in (flt.ms.items() if flt is not None else ()):
        stage_ms[stage] -= ms
        stage_ms[k] += ms
    return out


def _slice_nal(bw: BitWriter, res, nal_type: Optional[int]) -> bytes:
    """The CABAC result res = (bytes, tail, tail bits) after the header
    in bw, with the stop bit and byte alignment: a NAL of nal_type, or
    with None the raw bytes (a WPP substream)."""
    data, tail, tail_bits = res
    bw.write_bytes(data)
    bw.write_bits(tail, tail_bits)
    bw.rbsp_trailing_bits()
    return bw.get_bytes() if nal_type is None else \
        wrap_nal(nal_type, bw.get_bytes())


def wpp_substreams(rows: int, cols: int, init_type: int, qp: int,
                   code_ctu) -> List[bytes]:
    """A slice's CTU rows as WPP substreams through the Python CABAC (the
    reference's _wpp_substreams): code_ctu(enc, r, c) codes one CTU; row
    r > 0 starts from the contexts saved after the second CTU of row r - 1
    (spec 9.3.2.4; a one-column picture initialises every row from
    init_type and qp); each row ends with end_of_subset_one_bit (but the
    last), the stop bit and byte alignment."""
    sync_c = 1 if cols > 1 else None
    blobs, saved = [], None
    for r in range(rows):
        enc = CabacEncoder()
        if saved is None:
            enc.init_contexts(init_type, qp)
        else:
            enc.ctx = bytearray(saved)
        for c in range(cols):
            code_ctu(enc, r, c)
            if c == sync_c:
                saved = bytearray(enc.ctx)
            enc.encode_bin_trm(int(r == rows - 1 and c == cols - 1))
        if r < rows - 1:
            enc.encode_bin_trm(1)                # end_of_subset_one_bit
        blobs.append(_slice_nal(BitWriter(), enc.finish(), None))
    return blobs


def wpp_nal(sps, pps, nal_type: int, blobs: List[bytes], **header) -> bytes:
    """A slice NAL of WPP substreams: its header with the entry point
    offsets (the substreams' sizes before emulation prevention, as in
    the reference), then the substreams."""
    bw = HDR.write_slice_header(sps, pps, nal_type=nal_type,
                                entry_point_offsets=[len(b)
                                                     for b in blobs[:-1]],
                                **header)
    for b in blobs:
        bw.write_bytes(b)
    return wrap_nal(nal_type, bw.get_bytes())


def code_sao(enc, sao, r: int, c: int, cols: int, bit_depth: int) -> None:
    """The SAO syntax of CU or CTU (r, c) from the packed [ncu, 18]
    parameters, merged against its left and upper neighbours'."""
    i = r * cols + c
    CS.encode_sao_ctu(enc, sao[i], sao[i - 1] if c > 0 else None,
                      sao[i - cols] if r > 0 else None, bit_depth)


def hash_sei(out: dict, bit_depth: int = 8, hash_type: int = 0) -> bytes:
    """Decoded-picture-hash suffix SEI of each coded-size recon plane
    (spec D.3.19; its bytes as uint8 at 8 bits, as little-endian uint16
    above): hash_type 0 MD5, 1 CRC-16 (native.crc16), 2 the 32-bit
    checksum of the reference's picyuv.cpp (each sample's low byte, and
    above 8 bits its high byte, xored with a mask of its position,
    summed)."""
    pdt = np.uint16 if bit_depth > 8 else np.uint8
    bw = BitWriter()
    bw.write_bits(132, 8)          # payload type: decoded_picture_hash
    payload = bytearray([hash_type])
    for plane in ("recon_y", "recon_u", "recon_v"):
        pix = out[plane].astype(pdt)
        if hash_type == 1:
            crc = native.crc16(pix.tobytes())
            payload += bytes([(crc >> 8) & 0xff, crc & 0xff])
        elif hash_type == 2:
            h, w = pix.shape
            xs = np.arange(w, dtype=np.uint32)
            ys = np.arange(h, dtype=np.uint32)[:, None]
            xor = (xs & 0xff) ^ (ys & 0xff) ^ (xs >> 8) ^ (ys >> 8)
            p32 = pix.astype(np.uint32)
            cks = int(((p32 & 0xff) ^ xor).sum(dtype=np.uint64)
                      & 0xffffffff)
            if bit_depth > 8:
                cks = (cks + int(((p32 >> 8) ^ xor).sum(dtype=np.uint64))) \
                    & 0xffffffff
            payload += cks.to_bytes(4, "big")
        else:
            payload += hashlib.md5(pix.tobytes()).digest()
    bw.write_bits(len(payload), 8)
    bw.write_bytes(payload)
    bw.rbsp_trailing_bits()
    return wrap_nal(NAL_SUFFIX_SEI, bw.get_bytes())


class IntraEncoderSession:
    """All-intra CQP session, 4:2:0 at 8, 10 or 12 bits (bit_depth: Main,
    Main10, Main12 with the Range Extensions' constraint flags; deeper
    planes come in and go out as uint16), or 4:4:4 (csp="i444": Main
    4:4:4, chroma planes at luma size; the uniform grid, lossy, with no
    slices, WPP or loop filters, as in the reference).

    cu_size=16 or 32 codes the uniform grid of 16x16 or 32x32 CUs;
    max_depth=2 codes CTU32 quadtrees down to 8x8 CUs, max_depth=1 down
    to 16x16 (cu_size is then 32, as in the reference); cu_size=64 with
    max_depth=2 or 3 codes CTU64 quadtrees (the 64x64 CU always splits;
    CUs down to 16x16 or 8x8; no SAO, no device DPB: the deblock runs
    after the program; under wpp the PPS signals WPP but the slice is one
    substream, the reference's fault, ROADMAP Queue 3). deblock / sao:
    the in-loop filters; on the quadtree they run in the program
    (dpb_device=True: the video session's chain) or, as in the
    reference's intra session, after it in the host form. sbh / rdoq /
    psy_rdoq: sign-bit hiding, RDOQ (sign hiding off under RDOQ),
    psy-RDOQ. fps sets the VUI timing and the level. info_sei,
    master_display and max_cll choose the headers' SEI. aq_mode (1-4) /
    aq_strength: adaptive quantization from the luma and chroma energies
    of each frame coded through encode_frame (as in the reference, a
    batch codes its frames at the session QP, with the PPS's cu_qp_delta
    on and no delta in its slices). sei_provider, when set, is called
    with each frame's display index and returns bytes that go before its
    slice. device=None runs on the CUDA card (and raises when there is
    none); device="cpu" runs every kernel's plain PyTorch version.
    recon_host=False, with dpb_device (the video session's I frames when
    nothing reads their recon on the host): the quadtree program's recon
    stays on the device. psy_rd: psycho-visual RD in the quadtree's leaf
    decisions (the uniform grid has none, as in the reference).

    The stream options, with the reference's rules (uniform grid unless
    stated): lossless (transquant bypass: QP 4 signalled, no deblock, SAO,
    AQ, sign hiding or RDOQ); slices (horizontal bands of CTU rows, each
    its own slice and coded as its own frame, all bands as one batch; 1
    unless the rows split evenly; no sign hiding; as in the reference the
    bands are neither filtered nor coded with a QP map, the cu_qp_delta
    or, under lossless, the bypass flag, ROADMAP Queue 3); wpp (uniform
    grid and quadtree, not with slices: one substream per CTU row through
    the Python CABAC, as in the reference: the uniform grid's rows carry
    neither a QP map's cu_qp_delta nor the bypass flag); scaling_lists
    ("default" or a scaling-list file; ignored under lossless, RDOQ or
    the quadtree); hash_type (the hash SEI's 0 MD5, 1 CRC, 2 checksum).

    nr_intra (0-2000; the uniform grid, zeroed under lossless, the
    quadtree, slices and WPP): noise reduction, each frame's transformed
    blocks lowered by per-coefficient offsets from the |coef| sums of the
    frames before it (a batch's frames by zero offsets, adding nothing,
    as in the reference; in 4:4:4 the reference's chroma offsets have the
    4:2:0 size, so the first frame raises ValueError as its program
    does). fast_intra (the uniform grid, not lossless): every CU's luma
    mode decided up front from the source's neighbours. The session
    takes every keyword of the JAX one."""

    def __init__(self, width: int, height: int, qp: int = 32,
                 cu_size: int = 16, fps: Tuple[int, int] = FPS,
                 hash_sei: bool = True, deblock: bool = False,
                 sao: bool = False, rdoq: bool = False, sbh: bool = False,
                 psy_rdoq: float = 0.0, info_sei: bool = True,
                 master_display: str = None, max_cll: str = None,
                 max_depth: int = 0, dpb_device: bool = False,
                 aq_mode: int = 0, aq_strength: float = 1.0, device=None,
                 recon_host: bool = True, psy_rd: float = 0.0,
                 bit_depth: int = 8, lossless: bool = False,
                 slices: int = 1, wpp: bool = False, hash_type: int = 0,
                 scaling_lists: str = None, nr_intra: int = 0,
                 fast_intra: bool = False, csp: str = "i420"):
        cu_size = _grid(max_depth, cu_size, intra=True)
        if bit_depth not in (8, 10, 12):
            raise ValueError(f"bit_depth={bit_depth}: 8, 10 or 12")
        if csp not in ("i420", "i444"):
            raise ValueError(f"csp={csp!r}: 'i420' or 'i444'")
        i444 = csp == "i444"
        if max_depth and (lossless or slices > 1):
            raise NotImplementedError(
                "lossless and slices run on the uniform grid: the "
                "reference's quadtree intra session refuses them (its "
                "assertions 'quadtree + lossless / slices unsupported')")
        if i444 and (lossless or max_depth or slices > 1 or wpp or sao
                     or deblock):
            raise NotImplementedError(
                "4:4:4 runs on the uniform grid, lossy, with no slices, "
                "WPP or loop filters: the reference's intra session refuses "
                "the rest (its assertion '4:4:4: uniform-grid lossy path, "
                "no loop filters')")
        if i444 and scaling_lists:
            raise ValueError(
                "scaling lists with 4:4:4: the reference's program takes "
                "the chroma matrices one size below the chroma TUs and "
                "fails")
        self.csp, self.c_shift = csp, 0 if i444 else 1
        # noise reduction: the uniform grid's lossy path, zeroed silently
        # under lossless, the quadtree, slices and WPP (the arguments as
        # given, as in the reference)
        self.nr_intra = 0 if (lossless or max_depth or slices > 1 or wpp) \
            else min(max(int(nr_intra), 0), 2000)
        self.fast_intra = bool(fast_intra) and not max_depth \
            and not lossless
        if hash_type not in (0, 1, 2):
            raise ValueError(f"hash_type={hash_type}: 0 MD5, 1 CRC, 2 "
                             "checksum")
        self.bit_depth = bit_depth
        # the uniform grid's deblock depth (the video session sets 8: the
        # reference's fault, ROADMAP Queue 3)
        self.deblock_bit_depth = bit_depth
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            exact_fp32_matmul()
        self.src_w, self.src_h = width, height
        self.lossless = bool(lossless)
        # lossless signals QP 4 and codes no filter, AQ, SBH or RDOQ
        qp = 4 if self.lossless else qp
        self.qp, self.cu, self.max_depth = qp, cu_size, max_depth
        self.hash_sei, self.hash_type = hash_sei, hash_type
        self.deblock = bool(deblock) and not self.lossless
        # CTU64 codes no SAO (the reference's)
        self.sao = bool(sao) and not self.lossless and cu_size != 64
        rdoq = bool(rdoq) and not self.lossless
        self.scaling = None
        if scaling_lists and not (self.lossless or rdoq or max_depth):
            self.scaling = ScalingListData.default() \
                if scaling_lists == "default" \
                else ScalingListData.from_file(scaling_lists)
        rows = G.cdiv(height, cu_size)
        # equal bands of CTU rows only, else one slice
        self.slices = max(1, min(slices, rows))
        if rows % self.slices:
            self.slices = 1
        self.wpp = bool(wpp) and self.slices == 1
        self.sbh = bool(sbh) and not rdoq and not self.lossless \
            and self.slices == 1
        self.aq_mode = 0 if self.lossless else aq_mode
        self.aq_strength = aq_strength
        self.quant_fn = Quantizer(self.sbh, rdoq, psy_rdoq, bit_depth,
                                  self.scaling, csp420=not i444)
        self.dpb_device = bool(dpb_device) and max_depth > 0 \
            and cu_size == 32
        self.info_sei = info_sei
        self.master_display, self.max_cll = master_display, max_cll
        self.sei_provider = None      # callable(display_idx) -> bytes
        self._display_counter = 0
        self.coded_w = G.cdiv(width, cu_size) * cu_size
        self.coded_h = rows * cu_size
        self.rows, self.cols = rows, self.coded_w // cu_size
        self.band_rows = rows // self.slices
        log2cu = cu_size.bit_length() - 1
        self.sps = HDR.SPSInfo(
            width=self.coded_w, height=self.coded_h,
            conf_win=(0, self.coded_w - width, 0, self.coded_h - height),
            ptl=HDR.ProfileTierLevel(
                profile_idc=4 if bit_depth > 10 or i444 else
                2 if bit_depth > 8 else 1,
                bit_depth_constraint=bit_depth,
                chroma_constraint=3 if i444 else 1,
                level_idc=SEI.pick_level(self.coded_w, self.coded_h,
                                         fps[0] / max(fps[1], 1))),
            chroma_format_idc=3 if i444 else 1, bit_depth=bit_depth,
            log2_min_cb=log2cu - max_depth, log2_diff_max_min_cb=max_depth,
            log2_min_tb=2, log2_diff_max_min_tb=min(log2cu, 5) - 2,
            strong_intra_smoothing=0, timing_info=(fps[1], fps[0]),
            sao_enabled=int(self.sao), scaling_list=self.scaling)
        self.pps = HDR.PPSInfo(init_qp=26,
                               deblocking_disabled=int(not self.deblock),
                               sign_hiding=int(self.sbh),
                               cu_qp_delta=int(bool(self.aq_mode)),
                               transquant_bypass=int(self.lossless),
                               entropy_coding_sync=int(self.wpp))
        if cu_size == 64:
            self.frame_encoder = IntraQT64Encoder(
                self.coded_w, self.coded_h, self.device, self.quant_fn,
                psy_rd, max_depth, self.deblock)
        elif max_depth:
            self.frame_encoder = IntraQTEncoder(
                self.coded_w, self.coded_h, self.device, self.deblock,
                self.sao, self.quant_fn,
                "program" if self.dpb_device else "host",
                recon_host or not self.dpb_device, psy_rd, max_depth)
        else:
            # a sliced session codes each band as a frame of its own
            self.frame_encoder = IntraFrameEncoder(
                self.coded_w, self.band_rows * cu_size, cu_size,
                self.device, self.quant_fn, self.lossless, csp,
                self.fast_intra, bool(self.nr_intra))
        if self.nr_intra:
            # the running |coef| sums and block counts of luma and chroma
            # (sized, as in the reference, for 4:2:0 chroma)
            self._nr = {"sum_y": np.zeros(cu_size * cu_size, np.int64),
                        "cnt_y": 0,
                        "sum_c": np.zeros((cu_size // 2) ** 2, np.int64),
                        "cnt_c": 0}
        # wall-clock ms per stage, summed over frames
        self.stage_ms = defaultdict(float)

    # ------------------------------------------------------------------
    def headers(self) -> bytes:
        out = (HDR.write_vps(self.sps) + HDR.write_sps(self.sps)
               + HDR.write_pps(self.pps))
        msgs = []
        if self.info_sei:
            msgs.append(SEI.active_parameter_sets())
            # same info string as the JAX package, so the two streams can
            # be compared byte for byte
            msgs.append(SEI.user_data_unregistered(
                "x265-yuuki-asuna-tpu - TPU-native HEVC encoder - "
                f"{self.src_w}x{self.src_h} qp={self.qp} ctu={self.cu}"))
        if self.master_display:
            vals = SEI.parse_master_display(self.master_display)
            if vals:
                msgs.append(SEI.mastering_display(vals))
        if self.max_cll:
            try:
                cll, fall = (int(x) for x in self.max_cll.split(","))
                msgs.append(SEI.content_light_level(cll, fall))
            except ValueError:
                pass
        return out + SEI.wrap_sei(msgs) if msgs else out

    def _pad(self, y, u, v):
        ch, cw = self.coded_h >> self.c_shift, self.coded_w >> self.c_shift
        return (G.pad_plane(y, self.coded_h, self.coded_w),
                G.pad_plane(u, ch, cw), G.pad_plane(v, ch, cw))

    def code(self, yp, up, vp, qp: int, with_sao: bool = True,
             qp_map=None, nr: bool = False) -> dict:
        """The decision dict of one intra picture from padded planes at the
        slice QP qp and, when given, the per-CU QP map qp_map (kept under
        "qp_map"), its recon filtered (with_sao=False: deblocked only)
        and, with SAO, its parameters under "sao". nr: with noise
        reduction, denoise at the offsets of the sums so far and add this
        picture's sums to them (a batch's frames denoise by zero offsets
        and add nothing, as in the reference)."""
        st = self.stage_ms
        q = qp if qp_map is None else qp_map
        if self.max_depth:
            out = _program(st, "intra", self.frame_encoder, yp, up, vp, q,
                           with_sao=with_sao, slice_qp=qp)
        elif self.nr_intra and nr:
            out = _program(st, "intra", self.frame_encoder, yp, up, vp, q,
                           nr_off=self._nr_offsets())
            self._nr_accumulate(out)
        else:
            out = _program(st, "intra", self.frame_encoder, yp, up, vp, q)
        if qp_map is not None:
            out["qp_map"] = qp_map
        if not self.max_depth:
            self._filter(out, qp, (yp, up, vp), with_sao)
        return out

    def _nr_offsets(self):
        """The denoise offsets of the next picture from the running |coef|
        sums (the reference's _nr_offsets, after x265's
        noiseReductionUpdate): luma [cu, cu], chroma [cu/2, cu/2] (the
        reference's size, in 4:4:4 too)."""
        st, log2 = self._nr, self.cu.bit_length() - 1
        offy, st["sum_y"], st["cnt_y"] = quant.nr_update_offsets(
            st["sum_y"], st["cnt_y"], self.nr_intra,
            1 << (18 - 2 * (log2 - 2)))
        offc, st["sum_c"], st["cnt_c"] = quant.nr_update_offsets(
            st["sum_c"], st["cnt_c"], self.nr_intra,
            1 << (18 - 2 * (log2 - 3)))
        nc = self.cu // 2
        return offy.reshape(self.cu, self.cu), offc.reshape(nc, nc)

    def _nr_accumulate(self, out: dict) -> None:
        st = self._nr
        st["sum_y"] = st["sum_y"] + out["nr_sum_y"]
        st["cnt_y"] += self.rows * self.cols
        st["sum_c"] = st["sum_c"] + out["nr_sum_c"]
        st["cnt_c"] += 2 * self.rows * self.cols

    def aq_map(self, yp, up, vp):
        """The per-CU QP map of a frame from padded planes under AQ
        (luma and chroma energies), or None without AQ."""
        if not self.aq_mode:
            return None
        _aq_grid_check(yp, self.cu)
        offs = compute_aq_offsets(yp, self.cu, self.aq_strength,
                                  mode=self.aq_mode, u_plane=up, v_plane=vp,
                                  bit_depth=self.bit_depth)
        return np.clip(self.qp + offs, 0, 51).astype(np.int32)

    def _filter(self, out: dict, qp: int, src3, with_sao: bool) -> None:
        sao = self.sao and with_sao
        if self.deblock or sao:
            filter_uniform(out, qp, True, self.cu, self.deblock, sao, src3,
                           self.device, self.stage_ms, self.bit_depth,
                           self.deblock_bit_depth)

    def assemble_slice(self, out: dict, qp: int,
                       nal_type: int = NAL_IDR_W_RADL, poc: int = 0) -> bytes:
        """The I slice NAL of a coded picture: an IDR, or with nal_type
        NAL_CRA an open GOP's CRA at poc; under wpp its CTU rows' WPP
        substreams (not at CTU64: the reference's CTU64 writer codes one
        substream under the PPS's WPP flag, ROADMAP Queue 3)."""
        if self.wpp and self.cu != 64:
            return self._assemble_wpp(out, qp, nal_type, poc)
        sao = out.get("sao")
        bw = HDR.write_slice_header(self.sps, self.pps, slice_type=2,
                                    slice_qp=qp, nal_type=nal_type, poc=poc,
                                    sao=sao is not None)
        qp_map = out.get("qp_map")
        if self.cu == 64:
            res = native.encode_intra_slice_qt64(
                out, self.rows, self.cols, qp, self.max_depth,
                sign_hiding=self.sbh, sao=sao, qp_map=qp_map,
                bit_depth=self.bit_depth)
        elif self.max_depth:
            res = native.encode_slice_qt2(2, self.max_depth, out, qp,
                                          sign_hiding=self.sbh, sao=sao,
                                          qp_map=qp_map,
                                          bit_depth=self.bit_depth)
        else:
            res = native.encode_intra_slice(
                out["modes"], out["levels_y"], out["levels_cb"],
                out["levels_cr"], self.cu.bit_length() - 1, qp,
                sign_hiding=self.sbh, sao=sao, qp_map=qp_map,
                bit_depth=self.bit_depth, lossless=self.lossless,
                chroma444=self.csp == "i444")
        return _slice_nal(bw, res, nal_type)

    def _assemble_wpp(self, out: dict, qp: int, nal_type: int,
                      poc: int) -> bytes:
        """The slice as WPP substreams (the reference's
        _assemble_slice_wpp and _assemble_slice_qt_wpp; wpp_substreams).
        The quadtree's rows restart the QP predictor at the slice QP; the
        uniform grid's code no cu_qp_delta and no transquant bypass flag
        (the reference's writer)."""
        sao, qp_map = out.get("sao"), out.get("qp_map")
        cols = self.cols
        g = 1 << self.max_depth
        maps = (np.zeros((g * self.rows, g * cols), np.int32),
                np.zeros((g * self.rows, g * cols), np.int32))
        qp_state = [qp]

        def code_ctu(enc, r, c):
            if c == 0:
                qp_state[0] = qp          # qPY_PREV restarts on every row
            if sao is not None:
                code_sao(enc, sao, r, c, cols, self.bit_depth)
            if self.max_depth:
                self._write_ctu_qt(enc, out, r, c, *maps,
                                   None if qp_map is None
                                   else int(qp_map[r, c]), qp_state)
            else:
                CS.encode_intra_ctu_full(
                    enc, CS.CTUDecisions(int(out["modes"][r, c]),
                                         out["levels_y"][r, c],
                                         out["levels_cb"][r, c],
                                         out["levels_cr"][r, c]),
                    self.cu.bit_length() - 1,
                    int(out["modes"][r, c - 1]) if c > 0 else CS.DC_MODE,
                    CS.DC_MODE, sign_hiding=self.sbh)

        return wpp_nal(self.sps, self.pps, nal_type,
                       wpp_substreams(self.rows, cols, 2, qp, code_ctu),
                       slice_type=2, slice_qp=qp, poc=poc,
                       sao=sao is not None)

    def _write_ctu_qt(self, enc, out: dict, r: int, c: int, mode_map,
                      depth_map, ctu_qp, qp_state) -> None:
        """One CTU32 quadtree CTU through the Python CABAC (the
        reference's _write_ctu_qt): split_cu_flag with its context from
        the neighbours' depths (9.3.4.2.2), each CU's intra syntax with
        MPMs from the cell mode map (an above candidate outside the CTU
        is DC, spec 8.4.2) and, with ctu_qp, the CTU's cu_qp_delta at its
        first CU with a coded cbf (qp_state: [the QP predictor])."""
        md = self.max_depth
        g = 1 << md                      # cells per CTU side
        cell = 32 // g
        gy, gx = g * r, g * c
        lv_y, lv_cb, lv_cr = (out[k][r, c] for k in (
            "levels_y", "levels_cb", "levels_cr"))
        pending = [ctu_qp is not None]

        def split_flag(cy, cx, d, sp):
            ctx = int(cx > 0 and depth_map[cy, cx - 1] > d) + \
                int(cy > 0 and depth_map[cy - 1, cx] > d)
            enc.encode_bin(int(sp), CTX_OFFSET["split_cu"] + ctx)

        def code_cu(cy, cx, sc, mode, depth):
            px = sc * cell
            oy, ox = (cy - gy) * cell, (cx - gx) * cell
            d = CS.CTUDecisions(
                mode, lv_y[oy:oy + px, ox:ox + px],
                lv_cb[oy // 2:(oy + px) // 2, ox // 2:(ox + px) // 2],
                lv_cr[oy // 2:(oy + px) // 2, ox // 2:(ox + px) // 2])
            left = int(mode_map[cy, cx - 1]) if cx > 0 else CS.DC_MODE
            above = int(mode_map[cy - 1, cx]) if cy % g else CS.DC_MODE
            delta = None
            if pending[0] and (d.luma_levels.any() or d.cb_levels.any()
                               or d.cr_levels.any()):
                delta = ctu_qp - qp_state[0]
                qp_state[0] = ctu_qp
                pending[0] = False       # one delta per QG (the CTU)
            log2 = px.bit_length() - 1
            CS.encode_intra_ctu_full(enc, d, log2, left, above,
                                     part_mode_coded=log2 == 5 - md,
                                     sign_hiding=self.sbh, cu_qp_delta=delta)
            mode_map[cy:cy + sc, cx:cx + sc] = mode
            depth_map[cy:cy + sc, cx:cx + sc] = depth

        sp0 = bool(out["split"][r, c])
        split_flag(gy, gx, 0, sp0)
        if not sp0:
            code_cu(gy, gx, g, int(out["modes"][r, c]), 0)
            return
        half = g // 2
        for q, (qy, qx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            cy, cx = gy + qy * half, gx + qx * half
            if md == 1:
                code_cu(cy, cx, 1, int(out["modes4"][r, c, q]), 1)
                continue
            sp1 = bool(out["split16"][r, c, q])
            split_flag(cy, cx, 1, sp1)
            if not sp1:
                code_cu(cy, cx, 2, int(out["modes4"][r, c, q]), 1)
                continue
            for sq, (sy, sx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                code_cu(cy + sy, cx + sx, 1, int(out["modes8"][r, c, q, sq]),
                        2)

    def _result(self, out: dict, slice_nal: bytes, frame,
                with_recon: bool = True) -> FrameResult:
        """Prefix and hash SEI around the slice, the cropped recon and the
        quality metrics (with_recon=False: no recon, metrics 0)."""
        nals = slice_nal
        if self.sei_provider is not None:
            nals = self.sei_provider(self._display_counter) + nals
        self._display_counter += 1
        if self.hash_sei:
            nals += _timed(self.stage_ms, "serialize", hash_sei, out,
                           self.bit_depth, self.hash_type)
        if not with_recon:
            return FrameResult(nals=nals, recon=None, bits=len(nals) * 8,
                               psnr_y=0.0, frame_type="I", qp=self.qp)
        recon = host_planes(out, self.src_h, self.src_w, self.bit_depth,
                            self.c_shift)
        py, pu, pv, ssim = frame_quality(recon, *frame, self.device,
                                         self.bit_depth)
        return FrameResult(nals=nals, recon=recon, bits=len(nals) * 8,
                           psnr_y=py, frame_type="I", qp=self.qp,
                           psnr_u=pu, psnr_v=pv, ssim_y=ssim)

    # ------------------------------------------------------------------
    def encode_frame(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> FrameResult:
        """Code one frame (planes at the source size, uint8 at 8 bits,
        uint16 above) as an IDR."""
        if self.slices > 1:
            return self._encode_sliced(y, u, v)
        padded = self._pad(y, u, v)
        qp_map = self._timed_aq(padded)
        out = self.code(*padded, self.qp, qp_map=qp_map, nr=True)
        nal = _timed(self.stage_ms, "serialize", self.assemble_slice, out,
                     self.qp)
        return self._result(out, nal, (y, u, v))

    def _encode_sliced(self, y, u, v) -> FrameResult:
        """One frame as self.slices slices of band_rows CTU rows (the
        reference's _encode_frame_sliced): the bands coded as one batch of
        frames, no prediction across them, at the session QP, unfiltered;
        each band's slice NAL with its slice_segment_address, then the
        whole picture's hash SEI. As the reference's, the result carries
        PSNR-Y only, no frame type or QP, and calls no sei_provider."""
        yp, up, vp = self._pad(y, u, v)
        bh = self.band_rows * self.cu
        bands = [(yp[i * bh:(i + 1) * bh], up[i * bh // 2:(i + 1) * bh // 2],
                  vp[i * bh // 2:(i + 1) * bh // 2])
                 for i in range(self.slices)]
        outs = _timed(self.stage_ms, "intra", self.frame_encoder.encode_frames,
                      *zip(*bands), self.qp)
        addr_bits = max(1, (self.rows * self.cols - 1).bit_length())
        nals = b"".join(
            _timed(self.stage_ms, "serialize", self._band_slice, out,
                   i * self.band_rows * self.cols, addr_bits)
            for i, out in enumerate(outs))
        whole = {k: np.concatenate([o[k] for o in outs]) for k in (
            "recon_y", "recon_u", "recon_v")}
        if self.hash_sei:
            nals += _timed(self.stage_ms, "serialize", hash_sei, whole,
                           self.bit_depth, self.hash_type)
        recon = host_planes(whole, self.src_h, self.src_w, self.bit_depth)
        return FrameResult(nals=nals, recon=recon, bits=len(nals) * 8,
                           psnr_y=psnr(recon[0], y, self.bit_depth))

    def _band_slice(self, out: dict, slice_addr: int,
                    addr_bits: int) -> bytes:
        """One band's slice NAL, starting at CTU slice_addr (the
        reference's _assemble_band_slice: no SAO, QP map or bypass
        flag)."""
        bw = HDR.write_slice_header(self.sps, self.pps, slice_type=2,
                                    slice_qp=self.qp, slice_addr=slice_addr,
                                    slice_addr_bits=addr_bits)
        res = native.encode_intra_slice(
            out["modes"], out["levels_y"], out["levels_cb"],
            out["levels_cr"], self.cu.bit_length() - 1, self.qp)
        return _slice_nal(bw, res, NAL_IDR_W_RADL)

    def _timed_aq(self, padded):
        return _timed(self.stage_ms, "qp_map", self.aq_map, *padded) \
            if self.aq_mode else None

    def submit_batch(self, frames, need_recon: bool = False):
        """Start a batch of frames ((y, u, v) each); returns a handle for
        finish_batch. On the uniform grid the frames share the wavefront's
        launches (IntraFrameEncoder.encode_frames); quadtree frames run
        one after another. As in the reference, a batch deblocks but never
        runs SAO (its slices code SAO off even with sao=True), except in
        the device-DPB program chain, and with neither the hash SEI, the
        deblock nor need_recon it returns no recon. A sliced session codes
        the frames one after another (encode_frame), as the reference
        does."""
        if self.slices > 1:
            return [self.encode_frame(*f) for f in frames], None, None
        need_recon = self.hash_sei or self.deblock or need_recon
        padded = [self._pad(*f) for f in frames]
        if self.max_depth:
            outs = [self.code(*p, self.qp, with_sao=self.dpb_device)
                    for p in padded]
        else:
            outs = _timed(self.stage_ms, "intra",
                          self.frame_encoder.encode_frames,
                          *zip(*padded), self.qp)
            for out, p in zip(outs, padded):
                self._filter(out, self.qp, p, with_sao=False)
        return outs, frames, need_recon

    def finish_batch(self, handle) -> List[FrameResult]:
        """The batch's frames, serialized in order."""
        outs, frames, need_recon = handle
        if frames is None:                   # a sliced session's results
            return outs
        return [self._result(out, _timed(self.stage_ms, "serialize",
                                         self.assemble_slice, out, self.qp),
                             f, need_recon)
                for out, f in zip(outs, frames)]

    def encode_batch(self, frames, need_recon: bool = False) \
            -> List[FrameResult]:
        """Code a list of (y, u, v) frames through the frame-batched
        wavefront, then serialize each (submit_batch + finish_batch)."""
        return self.finish_batch(self.submit_batch(frames, need_recon))


class VideoEncoderSession:
    """GOP session, one reference per list (two L0 references with
    n_refs=2 on the uniform IPPP path).

    bit_depth: 8, 10 or 12 (deeper planes come in and go out as uint16;
    on the device they are int16). max_depth=0 codes the uniform grid of
    cu_size (16 or 32); max_depth=2 codes CTU32
    quadtrees down to 8x8 CUs, max_depth=1 down to 16x16 (cu_size is then
    32, as in the JAX session). bframes=0 codes IDR + P frames through
    encode_frame; bframes > 0 (either grid) codes mini-GOPs with B frames
    through push_frame and flush, with the B-pyramid when b_pyramid is
    set, closed by b_adapt (0 fixed, 1 fast, 2 trellis); the uniform
    grid's B frames filter in the session like its P frames (the deblock's
    BS from each CU's pdir and both lists' MVs). hme / hme_range: the
    hierarchical search
    on the quadtree (ignored on the uniform grid, as in the reference);
    hist_scenecut: the histogram scene cut in place of the cost rule.
    hash_type: the hash SEI's 0 MD5, 1 CRC, 2 checksum.
    deblock / sao switch the in-loop filters on; sbh / rdoq / psy_rdoq
    choose the levels (sign hiding is off under RDOQ); aq_mode /
    aq_strength / cutree give each frame a per-CU QP map, and with cutree
    rc_lookahead > 0 delays an IPPP session's frames through push_la /
    flush_la (a B session's inside push_frame) for cuTree's window; fps
    sets the VUI timing, the level and keyint_min; quality_metrics=False
    leaves PSNR-U/V and SSIM out of the results, and with recon_out=False
    and no hash SEI the quadtree path returns no recon (and PSNR-Y 0).
    Rate control: rc_mode ("cqp", "crf" with crf, "abr" with
    bitrate_kbps), vbv_maxrate_kbps / vbv_bufsize_kbps (VBV, both > 0),
    hrd (the HRD in the VUI and, on the IPPP path, its SEI; with VBV
    only), qp_min / qp_max, zones ("start,end,q=N" or "start,end,b=F"
    parts joined by "/", display indices), scenecut_aware_qp with
    scenecut_qp_delta / scenecut_window (IPPP), stats_write (pass-1 stats
    of the IPPP path, written by stats_writer.close()) and stats_read
    (pass 2). search_range: the integer motion search's +-range on both
    grids; psy_rd: psycho-visual RD in the quadtree's leaf decisions;
    b_intra: intra candidates in the quadtree's B slices; open_gop: every
    keyframe after the first of a B session is a CRA with the frames
    pending at it as RASL leading pictures; weightp: weighted prediction
    of P frames; dpb_device (quadtree; None: on unless weightp, which
    turns it off, as in the reference): False codes the host-filter
    path. The P-frame options, with the reference's rules: n_refs
    (clamped to 1..2; 2 asserts the uniform grid, no B frames and no
    weightp), tmvp (kept on the uniform IPPP path only), max_merge (1..5
    merge candidates), frame_dup / dup_threshold (kept without B frames,
    two references or TMVP; a quadtree session stops at its first
    duplicate frame, as the reference does), wpp (kept on the uniform
    grid, asserts no AQ or cuTree; its P slices signal no weights under
    weightp, the reference's fault). rqt: the quadtree's inter CU32
    leaves may code four 16x16 TUs (max_transform_hierarchy_depth_inter
    1; dropped on the uniform grid). Analysis reuse on the uniform IPPP
    path (the quadtree and two references assert, as in the reference):
    analysis_save (a file of pickled per-frame records), analysis_share
    ("save": the records kept in shared_analysis; a list: records read
    from it as a donor appends them) and analysis_load (scaled by
    scale_factor onto this grid) give each P frame its record's MVs as
    hints, refined in place of the integer search (K1 is not launched
    for that frame's ME); weighted P frames ignore them, and a B
    session's P anchors fail on them (ValueError), as in the reference.
    device=None runs on the CUDA card (and raises when there is none);
    device="cpu" runs every kernel's plain PyTorch version. Geometries
    the port does not code raise NotImplementedError."""

    def __init__(self, width: int, height: int, qp: int = 32,
                 cu_size: int = 16, fps: Tuple[int, int] = FPS,
                 keyint: int = 25, hash_sei: bool = True,
                 max_depth: int = 0, bframes: int = 0,
                 b_pyramid: bool = True, b_adapt: int = 2,
                 deblock: bool = False, sao: bool = False,
                 rdoq: bool = False, sbh: bool = False,
                 psy_rdoq: float = 0.0, quality_metrics: bool = True,
                 aq_mode: int = 0, aq_strength: float = 1.0,
                 cutree: bool = False, rc_lookahead: int = 0,
                 rc_mode: str = "cqp", crf: float = 28.0,
                 bitrate_kbps: int = 0, vbv_maxrate_kbps: int = 0,
                 vbv_bufsize_kbps: int = 0, hrd: bool = False,
                 zones: str = None, qp_min: int = 4, qp_max: int = 51,
                 scenecut_aware_qp: bool = False,
                 scenecut_qp_delta: int = 5, scenecut_window: int = 12,
                 stats_write: str = None, stats_read: str = None,
                 hme: bool = False, hme_range: int = 16,
                 hist_scenecut: bool = False, recon_out: bool = True,
                 dpb_device: bool = None, search_range: int = 16,
                 psy_rd: float = 0.0, b_intra: bool = False,
                 open_gop: bool = False, weightp: bool = False, device=None,
                 bit_depth: int = 8, hash_type: int = 0, n_refs: int = 1,
                 tmvp: bool = False, max_merge: int = 3,
                 frame_dup: bool = False, dup_threshold: int = 70,
                 wpp: bool = False, analysis_save: str = None,
                 analysis_load: str = None, analysis_share=None,
                 scale_factor: int = 1, rqt: bool = False):
        cu_size = _grid(max_depth, cu_size)
        # the reference's P-frame options: two L0 references on the
        # uniform IPPP path only (asserted), TMVP kept there only, WPP on
        # the uniform grid without a QP map (asserted), frame duplication
        # without B frames, two references or TMVP
        self.n_refs = max(1, min(n_refs, 2))
        if self.n_refs > 1 and (bframes or max_depth or weightp
                                or analysis_load or analysis_save
                                or analysis_share):
            raise AssertionError("multi-ref: uniform IPPP sessions (the "
                                 "reference's assertion)")
        # RQT: the quadtree's inter CU32 leaves may split their TU into
        # four 16x16 TUs (dropped on the uniform grid, as in the
        # reference); analysis save / load: the uniform grid only
        self.rqt = bool(rqt) and max_depth > 0
        if max_depth and (analysis_load or analysis_save):
            raise AssertionError("inter quadtree: no analysis reuse (the "
                                 "reference's assertion)")
        self.tmvp = bool(tmvp) and not bframes and not max_depth
        self.wpp = bool(wpp) and not max_depth
        if self.wpp and (aq_mode or cutree):
            raise AssertionError("WPP inter sessions: no per-CU QP (the "
                                 "reference's assertion)")
        self.frame_dup = bool(frame_dup) and not bframes \
            and self.n_refs == 1 and not tmvp
        self.dup_threshold = min(max(dup_threshold, 1), 99)
        self.max_merge = max_merge
        # frames wait rc_lookahead frames for cuTree's window (cuTree only)
        self.la_depth = max(0, rc_lookahead) if cutree else 0
        # the reference's device DPB: the quadtree without weightp; off,
        # the quadtree frames take the host-filter path
        dpb_ok = bool(max_depth) and not weightp
        self.dpb_device = dpb_ok if dpb_device is None \
            else bool(dpb_device) and dpb_ok
        self.weightp = bool(weightp)
        # the quadtree programs' recon planes come to the host only for
        # the hash SEI, the returned recon and the quality metrics
        recon_host = bool(recon_out or quality_metrics or hash_sei)
        # the I frames go through an intra session, whose parameter sets
        # this session shares
        self.intra_sess = IntraEncoderSession(
            width, height, qp, cu_size, fps, hash_sei=False,
            deblock=deblock, sao=sao, rdoq=rdoq, sbh=sbh, psy_rdoq=psy_rdoq,
            max_depth=max_depth, dpb_device=self.dpb_device,
            recon_host=recon_host, psy_rd=psy_rd, device=device,
            bit_depth=bit_depth, hash_type=hash_type, wpp=self.wpp)
        self.device = self.intra_sess.device
        self.bit_depth = bit_depth
        # the reference's video session deblocks its uniform grid (its IDRs
        # too) at 8-bit thresholds and range whatever the bit depth: its
        # fault, kept (ROADMAP Queue 3); its quadtree filters at the depth
        if not max_depth:
            self.intra_sess.deblock_bit_depth = 8
        self.src_w, self.src_h = width, height
        self.qp = qp
        self.cu = cu_size
        self.max_depth = max_depth
        self.keyint = max(keyint, 1)
        # reference keyframeMin: scenecut IDRs are suppressed closer than
        # this to the last keyframe
        self.keyint_min = max(1, min(int(round(fps[0] / max(fps[1], 1))),
                                     self.keyint // 10))
        self.hash_sei = hash_sei
        self.quality_metrics = bool(quality_metrics)
        self.recon_out = bool(recon_out)
        self.deblock, self.sao = bool(deblock), bool(sao)
        self.sbh = self.intra_sess.sbh
        # the uniform grid's filters run in the session, the quadtree's in
        # its programs (in the host form without the device DPB)
        self.session_filters = (self.deblock or self.sao) and not max_depth
        self.coded_w = self.intra_sess.coded_w
        self.coded_h = self.intra_sess.coded_h
        self.bframes = max(0, bframes)
        self.b_pyramid = b_pyramid and self.bframes >= 2
        # the DPB holds the two anchors (and the pyramid's middle B) while
        # the B frames between them are decoded
        self.sps, self.pps = self.intra_sess.sps, self.intra_sess.pps
        self.sps.max_dec_pic_buffering, self.sps.num_reorder_pics = \
            ((5, 2) if self.b_pyramid else (4, 1)) if self.bframes else (2, 0)
        self.aq_mode, self.aq_strength, self.cutree = aq_mode, aq_strength, \
            bool(cutree)
        # the PPS signals cu_qp_delta and weighted prediction for the
        # whole session, the SPS TMVP; as in the reference the DPB stays
        # at two pictures under two references (ROADMAP Queue 3)
        self.pps.cu_qp_delta = int(bool(aq_mode or cutree))
        self.pps.weighted_pred = int(self.weightp)
        self.sps.temporal_mvp = int(self.tmvp)
        self.sps.max_transform_hierarchy_depth_inter = int(self.rqt)
        self.rows, self.cols = self.coded_h // cu_size, self.coded_w // cu_size
        # analysis reuse: analysis_save pickles a record per IPPP frame
        # ({"t": "I" | "P"} and a P frame's "mvx" / "mvy" on the CU grid)
        # into that file, analysis_share="save" keeps the records in
        # shared_analysis, and analysis_load (scaled by scale_factor to
        # this grid) or an analysis_share list (read as a donor session
        # appends to it: the ladder) gives each P frame the MVs of its
        # record as hints; records are read by frame index, the last one
        # past the end, and an I record hints zero MVs
        self.analysis_save = open(analysis_save, "wb") \
            if analysis_save else None
        self.analysis_data = None
        self.analysis_idx = 0
        self.shared_analysis = [] if isinstance(analysis_share, str) \
            and analysis_share == "save" else None
        if isinstance(analysis_share, list):
            self.analysis_data = analysis_share
        if analysis_load:
            recs = read_analysis(analysis_load)
            if scale_factor > 1:
                recs = [scale_analysis_rec(r, scale_factor, self.rows,
                                           self.cols) for r in recs]
            self.analysis_data = recs
        if max_depth and self.analysis_data is not None:
            raise AssertionError("inter quadtree: CTU32; no analysis reuse "
                                 "(the reference's assertion)")
        # the hinted P program: the reference's weighted program takes no
        # hint (its search runs in full), and a B session's P anchors give
        # it none (ValueError there, as in the reference)
        self.hinted = self.analysis_data is not None and not self.weightp
        quant_fn = self.intra_sess.quant_fn
        # B slices evaluate intra candidates with b_intra (the
        # reference's bIntraInBFrames: x265's presets and --b-intra
        # switch it on, the session's default is off)
        self.b_intra = bool(b_intra)
        if max_depth:
            # HME and psy-rd run on the quadtree only, as in the
            # reference
            self.inter_encoder = InterQTEncoder(
                self.coded_w, self.coded_h, self.device, self.deblock,
                self.sao, quant_fn, hme=hme, hme_range=hme_range,
                recon_host=recon_host, psy_rd=psy_rd, b_intra=self.b_intra,
                search_range=search_range, weightp=self.weightp,
                sao_form="program" if self.dpb_device else "host",
                max_depth=max_depth, rqt=self.rqt)
        else:
            self.inter_encoder = InterFrameEncoder(
                self.coded_w, self.coded_h, cu_size, self.device, quant_fn,
                search_range, self.weightp)
        self.lookahead = Lookahead(self.coded_w, self.coded_h, self.device,
                                   hist_scenecut=hist_scenecut,
                                   bit_depth=bit_depth)
        # the lookahead's scene cut places keyframes (the host API's
        # reconfig switches it with its scenecut threshold)
        self.scenecut_enabled = True
        # open GOP: keyframes after the first are CRA pictures, and the
        # frames pending at one become its RASL leading pictures (B
        # sessions; an IPPP session has none, as in the reference)
        self.open_gop = bool(open_gop)
        fps_f = fps[0] / max(fps[1], 1)
        # the rate control sees the source size
        self.rc = RateControl(RCConfig(
            mode=rc_mode, qp=qp, crf=crf, bitrate_kbps=bitrate_kbps,
            fps=fps_f, width=width, height=height, qp_min=qp_min,
            qp_max=qp_max, vbv_maxrate_kbps=vbv_maxrate_kbps,
            vbv_bufsize_kbps=vbv_bufsize_kbps))
        # HRD: the CPB is the VBV buffer, so it needs both rates
        self.hrd = bool(hrd) and vbv_maxrate_kbps > 0 \
            and vbv_bufsize_kbps > 0
        if self.hrd:
            self.sps.hrd = (vbv_maxrate_kbps * 1000, vbv_bufsize_kbps * 1000,
                            0)
            self._au_count = 0
        # scene-cut-aware QP: the frames of the window after a cut get a
        # higher QP, in three steps
        self.scenecut_aware_qp = bool(scenecut_aware_qp)
        self.scenecut_qp_delta = scenecut_qp_delta
        self.scenecut_window = max(scenecut_window, 3)
        self._since_scenecut = 10 ** 9
        # two-pass; the #options header holds the fields x265's pass-2
        # parser checks
        opts = (f"input-res={width}x{height} fps={fps[0]}/{fps[1]} "
                f"bitdepth={bit_depth} weightp={int(self.weightp)} "
                f"bframes={max(0, bframes)} "
                f"b-pyramid={int(bool(b_pyramid))} "
                f"open-gop={int(bool(open_gop))} "
                f"keyint={keyint} scenecut=40 intra-refresh=0 frame-dup=0 "
                f"b-adapt={b_adapt} rc-lookahead={rc_lookahead} "
                f"vbv-maxrate={vbv_maxrate_kbps} "
                f"vbv-bufsize={vbv_bufsize_kbps} ctu={cu_size} ref=1")
        self.stats_writer = (StatsWriter(stats_write, options=opts)
                             if stats_write else None)
        self.two_pass = TwoPassRC(stats_read, bitrate_kbps, fps_f) \
            if stats_read else None
        # pass-1 cuTree offsets: every frame carries a QP map
        self._tp_delta_on = bool(
            self.two_pass is not None
            and any("cuoff" in r for r in self.two_pass.records))
        if self._tp_delta_on:
            self.pps.cu_qp_delta = 1
        self._tp_cuoff = None       # the pass-1 offsets of this frame
        # per-CU QP offsets [rows, cols] from the host API's ctu_info
        # (x265_encoder_ctu_info), added to every later frame's map
        self.ctu_info_offsets = None
        # zones: (first, last display index, QP or None, bitrate factor
        # or None)
        self.zones = []
        self.gop_display_base = 0   # display index of the GOP's POC 0
        if zones:
            for part in zones.split("/"):
                first, last, opt = part.split(",", 2)
                zq = zb = None
                k, _, val = opt.partition("=")
                if k == "q":
                    zq = int(val)
                elif k == "b":
                    zb = float(val)
                self.zones.append((int(first), int(last), zq, zb))
        self.sei_provider = None    # callable(display_idx) -> prefix bytes
        # cuTree's causal average on the lowres 8x8 grid (_cutree_update);
        # the window of lookahead details of the frame being coded with
        # rc_lookahead (its own first), and the frames waiting for theirs:
        # (y, u, v, icost, pcost, scenecut, detail, display index,
        # force_idr, qp)
        self.cutree_acc = np.zeros((self.lookahead.lh // 8,
                                    self.lookahead.lw // 8))
        self.cutree_icost = np.maximum(self.cutree_acc, 1.0)
        self.cutree_strength = 2.0
        self._cutree_window = None
        self.la_queue = []
        self._force_idr = False
        self.frame_idx = 0
        self.poc = 0
        self.display_idx = 0
        # (y, u, v) padded recon planes of the reference picture: host
        # arrays on the uniform grid, device tensors for quadtrees (uint8
        # at 8 bits, int16 above); with n_refs=2 the one before it (None
        # after an IDR), the POC distances of the last P frame's
        # references and, under TMVP, its motion field (the next frame's
        # collocated one); frame_dup's previous source luma
        self.ref = None
        self.ref2 = None
        self._last_ref_deltas = [1]
        self.col_field = None
        self._prev_src_y = None
        # push_frame state: display-order frames of the open mini-GOP, their
        # lowres planes (device tensors) and rc-lookahead windows, the
        # last anchor's (recon planes, poc) and lowres plane, the last
        # IDR's display index; b_adapt: 0 fixed mini-GOPs, 1 the fast
        # early close, 2 the trellis
        self.b_adapt = b_adapt
        self.pending = []
        self.pending_lowres = []
        self.pending_windows = []
        self.anchor = None
        self.anchor_lowres = None
        self._last_idr_didx = -10 ** 9
        # wall-clock ms per stage, summed over frames (each stage ends in a
        # device->host copy, so the times include the device work); the
        # intra session adds its own stages here
        self.stage_ms = self.intra_sess.stage_ms

    @property
    def intra_encoder(self):
        """The I frames' program (the intra session's)."""
        return self.intra_sess.frame_encoder

    # ------------------------------------------------------------------
    def headers(self) -> bytes:
        return self.intra_sess.headers()

    def _timed(self, stage: str, fn, *args, **kw):
        return _timed(self.stage_ms, stage, fn, *args, **kw)

    def _pad(self, y, u, v):
        return self.intra_sess._pad(y, u, v)

    def _zone_qp(self, display_idx: int, qp: int) -> int:
        """The QP of the frame at display_idx in its zone: the zone's QP,
        or qp - 6 log2(factor) clipped to 0..51; qp outside every zone."""
        for first, last, zq, zb in self.zones:
            if first <= display_idx <= last:
                if zq is not None:
                    return zq
                if zb:
                    return int(round(min(max(qp - 6 * math.log2(zb), 0),
                                         51)))
        return qp

    def intra_refresh(self):
        """Code the next frame as an IDR (x265_encoder_intra_refresh); with
        rc_lookahead, the next frame pushed."""
        self._force_idr = True

    # ------------------------------------------------------------------
    def push_la(self, y, u, v) -> List[FrameResult]:
        """Take one display-order frame into the rc-lookahead window (an
        IPPP session with cutree and rc_lookahead > 0); once rc_lookahead
        frames wait behind the oldest, code it with cuTree's offsets
        propagated back from them. Returns 0 or 1 results."""
        if not self.la_depth:
            raise RuntimeError("push_la needs cutree and rc_lookahead > 0")
        yp = G.pad_plane(y, self.coded_h, self.coded_w)
        icost, pcost, scenecut = self._timed("lookahead",
                                             self.lookahead.push, yp)
        det = dict(self.lookahead.last_detail, scenecut=scenecut)
        # a forced IDR and the QP apply to this frame when it leaves the
        # window
        self.la_queue.append((y, u, v, icost, pcost, scenecut, det,
                              self.display_idx, self._force_idr,
                              self.rc.cfg.qp))
        self._force_idr = False
        self.display_idx += 1
        if len(self.la_queue) > self.la_depth:
            return [self._pop_la()]
        return []

    def flush_la(self) -> List[FrameResult]:
        """End of stream: code every frame left in the window."""
        out = []
        while self.la_queue:
            out.append(self._pop_la())
        return out

    def _pop_la(self) -> FrameResult:
        (y, u, v, icost, pcost, scenecut, det, didx, force_idr,
         qp_cfg) = self.la_queue.pop(0)
        window = [det] + [q[6] for q in self.la_queue]
        self.rc.cfg.qp = self.qp = qp_cfg
        if force_idr:
            self._force_idr = True
        return self.encode_frame(y, u, v, _la=(icost, pcost, scenecut,
                                               window, didx))

    # ------------------------------------------------------------------
    def encode_frame(self, y, u, v, _la=None) -> FrameResult:
        """Code the next frame of an IPPP session (bframes=0)."""
        if self.bframes:
            raise RuntimeError(
                "encode_frame codes IPPP sessions; a session with bframes "
                "> 0 takes its frames through push_frame and flush")
        yp, up, vp = self._pad(y, u, v)
        if _la is None:
            icost, pcost, scenecut = self._timed("lookahead",
                                                 self.lookahead.push, yp)
            didx = self.display_idx
            self.display_idx += 1
            self._cutree_window = None
        else:
            icost, pcost, scenecut, self._cutree_window, didx = _la
        is_idr = (self.frame_idx % self.keyint == 0) or self.ref is None \
            or (self.scenecut_enabled and scenecut
                and self.frame_idx >= self.keyint_min) \
            or self._force_idr
        self._force_idr = False
        la_cost = icost if is_idr else pcost
        qp = self._timed("rc", self._ippp_qp, is_idr, la_cost)
        qp = self._zone_qp(didx, qp)
        if self.scenecut_aware_qp:
            qp = self._scenecut_qp(qp, is_idr and (scenecut
                                                   or self.frame_idx == 0))
        if _la is None:
            self._cutree_update()
        if is_idr:
            self.poc = 0
            self.frame_idx = 0   # scenecut restarts the GOP
        else:
            self.poc += 1

        def attempt(qp):
            qp_map = self._qp_map(yp, qp)
            if is_idr:
                return self._code_idr(yp, up, vp, qp, qp_map)
            return self._code_p(yp, up, vp, self.ref, qp, self.poc, 1,
                                qp_map, self._analysis_hint())

        # frame duplication: a P frame whose luma PSNR against the
        # previous source reaches dup_threshold is coded as an all-skip
        # slice
        is_dup = (self.frame_dup and not is_idr
                  and self._prev_src_y is not None
                  and _dup_psnr(y, self._prev_src_y) >= self.dup_threshold)
        self._prev_src_y = y
        out, nals = self._code_skip(qp) if is_dup else attempt(qp)
        if self.hrd:
            nals = self._hrd_sei(is_idr) + nals
        if self.sei_provider is not None:
            nals = self.sei_provider(didx) + nals
        # VBV: a frame the buffer cannot take is coded again at a higher
        # QP (the retry's NALs have no prefix SEI, as in the reference)
        for _ in range(2):
            over = self.rc.vbv_overshoot(len(nals) * 8)
            if over <= 1.08 or qp >= 51:
                break
            qp = min(qp + max(1, int(round(6 * math.log2(over)))), 51)
            out, nals = attempt(qp)
        self._analysis_record(out, is_idr)
        self.ref2 = None if is_idr else self.ref
        self.ref = self._recon_ref(out)
        if self.tmvp:
            self.col_field = self._motion_field(out, is_idr)
        self.frame_idx += 1
        return self._finish(out, nals, (y, u, v), qp, self.poc,
                            "I" if is_idr else "P", la_cost)

    def _analysis_hint(self):
        """This P frame's (mvx, mvy) hints from its analysis record (the
        one at the frame index, the last past the end; zero MVs from an
        I record), or None without records."""
        if self.analysis_data is None:
            return None
        rec = self.analysis_data[min(self.analysis_idx,
                                     len(self.analysis_data) - 1)]
        ncu = self.rows * self.cols
        return tuple(rec.get(k, np.zeros(ncu, np.int32)).reshape(-1)
                     for k in ("mvx", "mvy"))

    def _analysis_record(self, out: dict, is_idr: bool) -> None:
        """Write the frame's analysis record (analysis_save / the shared
        list) and move the record index on."""
        if self.analysis_save is not None or \
                self.shared_analysis is not None:
            rec = {"t": "I" if is_idr else "P"}
            if not is_idr:
                rec["mvx"] = out["mvx"].astype(np.int32)
                rec["mvy"] = out["mvy"].astype(np.int32)
            if self.analysis_save is not None:
                pickle.dump(rec, self.analysis_save)
                self.analysis_save.flush()
            if self.shared_analysis is not None:
                self.shared_analysis.append(rec)
        self.analysis_idx += 1

    def _motion_field(self, out: dict, is_idr: bool) -> dict:
        """A coded picture's motion field as the next frame's collocated
        one under TMVP (on the CU grid: HEVC keeps collocated motion at
        16x16): all intra for an IDR, else each CU's intra flag, MV and
        reference index, with the POC distances of its references."""
        shape = (self.rows, self.cols)
        zeros = np.zeros(shape, np.int32)
        if is_idr:
            return {"intra": np.ones(shape, bool), "mvx": zeros,
                    "mvy": zeros, "ref": zeros, "ref_deltas": [1]}
        ref = out.get("ref")
        return {"intra": np.asarray(out["use_intra"], bool),
                "mvx": np.asarray(out["mvx"], np.int32),
                "mvy": np.asarray(out["mvy"], np.int32),
                "ref": zeros if ref is None else np.asarray(ref, np.int32),
                "ref_deltas": self._last_ref_deltas}

    def _code_skip(self, qp: int):
        """(decision dict, slice NAL) of a duplicate frame: every CU a skip
        with merge index 0 (at (0, 0) the first candidate is the zero MV,
        and every later CU inherits it), no residual, no program and no
        filter, the recon the reference's (the reference's
        encode_skip_frame). The reference has no such slice on the
        quadtree (its writer fails on the missing split flags): the port
        stops there too."""
        if self.max_depth:
            raise NotImplementedError(
                "frame_dup on a quadtree session: the reference accepts it "
                "but fails at the first duplicate frame (its quadtree "
                "writer has no skip slice; ROADMAP Queue 3)")
        n, nc = self.cu, self.cu // 2
        shape = (self.rows, self.cols)
        zc = np.zeros(shape + (nc, nc), np.int32)
        out = {"use_intra": np.zeros(shape, bool),
               "modes": np.zeros(shape, np.int32),
               "mvx": np.zeros(shape, np.int32),
               "mvy": np.zeros(shape, np.int32), "ref": None, "pdir": None,
               "levels_y": np.zeros(shape + (n, n), np.int32),
               "levels_cb": zc, "levels_cr": zc}
        for k, p in zip(("recon_y", "recon_u", "recon_v"), self.ref):
            out[k] = np.asarray(p, np.int32)
        return out, self._timed("serialize", self._assemble_p_slice, out,
                                qp, self.poc, 1)

    def _ippp_qp(self, is_idr: bool, la_cost: float) -> int:
        """The IPPP frame's QP before its zone: pass 2's (and its cuTree
        offsets, kept for the QP map), or the rate control's from the
        frame's lookahead cost and those of the frames in the window."""
        self._tp_cuoff = None
        if self.two_pass is not None:
            qp = self.two_pass.frame_qp()
            off = self.two_pass.frame_cuoff()
            rows, cols = self.coded_h // self.cu, self.coded_w // self.cu
            if off is not None and off.size == rows * cols:
                self._tp_cuoff = off.reshape(rows, cols)
            return qp
        return self.rc.frame_qp(is_idr, lookahead_cost=la_cost,
                                future_costs=[q[4] for q in self.la_queue])

    def _scenecut_qp(self, qp: int, cut: bool) -> int:
        """Scene-cut-aware QP: + delta in the first third of the window
        after a cut (cut: this frame is one), + 2/3 delta in the second,
        + 1/3 delta in the last."""
        if cut:
            self._since_scenecut = 0
        else:
            self._since_scenecut += 1
        w3, k = self.scenecut_window, self._since_scenecut
        if k < w3 // 3:
            qp = min(qp + self.scenecut_qp_delta, 51)
        elif k < 2 * w3 // 3:
            qp = min(qp + (2 * self.scenecut_qp_delta) // 3, 51)
        elif k < w3:
            qp = min(qp + self.scenecut_qp_delta // 3, 51)
        return qp

    def _hrd_sei(self, is_idr: bool) -> bytes:
        """The access unit's HRD prefix SEI: a buffering period at an IDR
        (the initial CPB fill as a 90 kHz delay), then its picture
        timing."""
        cfg = self.rc.cfg
        msgs = []
        if is_idr:
            init = (cfg.vbv_bufsize_kbps * cfg.vbv_init
                    / max(cfg.vbv_maxrate_kbps, 1))
            msgs.append(SEI.buffering_period(int(init * 90000)))
            self._au_count = 0
        msgs.append(SEI.pic_timing(max(self._au_count - 1, 0),
                                   self.sps.num_reorder_pics))
        self._au_count += 1
        return SEI.wrap_sei(msgs)

    # ------------------------------------------------------------------
    # mini-GOPs with B frames (bframes > 0): the JAX session's push_frame
    # with its rc-lookahead window and b-adapt, and its sequential
    # mini-GOP flush
    # ------------------------------------------------------------------
    def push_frame(self, y, u, v) -> List[FrameResult]:
        """Take one display-order frame; returns the frames it completes
        (none, or whole mini-GOPs in coding order). With cutree and
        rc_lookahead > 0 the frame first waits in the window until
        rc_lookahead later frames are analysed; it then reaches the
        mini-GOP with the window's details for cuTree."""
        if not self.bframes:
            raise RuntimeError("push_frame needs bframes > 0; IPPP sessions "
                               "use encode_frame")
        yp = G.pad_plane(y, self.coded_h, self.coded_w)
        icost, pcost, scenecut = self._timed("lookahead",
                                             self.lookahead.push, yp)
        det = dict(self.lookahead.last_detail, scenecut=scenecut)
        low = self.lookahead.prev_lowres      # stays on the device
        if self.la_depth:
            self.la_queue.append((y, u, v, icost, pcost, scenecut, det, low))
            if len(self.la_queue) > self.la_depth:
                return self._pop_la_b()
            return []
        return self._push_frame_now(y, u, v, icost, pcost, scenecut, low)

    def _pop_la_b(self) -> List[FrameResult]:
        """The oldest frame of the window into the mini-GOP, with the
        details of itself and the frames behind it."""
        y, u, v, icost, pcost, scenecut, det, low = self.la_queue.pop(0)
        window = [det] + [q[6] for q in self.la_queue]
        return self._push_frame_now(y, u, v, icost, pcost, scenecut, low,
                                    window)

    def _push_frame_now(self, y, u, v, icost: float, pcost: float,
                        scenecut: bool, low, window=None) \
            -> List[FrameResult]:
        """A keyframe at keyint or a scene cut (keyint_min after the
        last): an IDR, or with open_gop after the first a CRA; else the
        frame joins the open mini-GOP, which closes at bframes + 1 frames
        or, with b_adapt, where the lookahead says."""
        results = []
        if (self.display_idx % self.keyint == 0 or self.anchor is None
                or (self.scenecut_enabled and scenecut
                    and self.display_idx - self._last_idr_didx
                    >= self.keyint_min)):
            self._last_idr_didx = self.display_idx
            if self.open_gop and self.anchor is not None:
                results += self._encode_cra_gop(y, u, v)
            else:
                results += self._flush_minigop()
                self._cutree_window = window
                results.append(self._encode_idr_anchor(y, u, v))
            self.anchor_lowres = low
        else:
            self.pending.append((y, u, v))
            self.pending_lowres.append(low)
            self.pending_windows.append(window)
            full = len(self.pending) == self.bframes + 1
            if self.b_adapt >= 2:
                if full and self.anchor_lowres is not None:
                    results += self._flush_minigop(
                        self._timed("b_adapt", self._trellis) + 1)
                elif full:
                    results += self._flush_minigop()
            else:
                # fast b-adapt: close early when this frame predicts
                # poorly from the one before, then from the anchor
                poor = bool(self.b_adapt) and pcost > 0.45 * max(icost, 1)
                if (self.b_adapt and not poor
                        and self.anchor_lowres is not None
                        and len(self.pending) > 1):
                    far = self._timed("b_adapt", self.lookahead.pair_cost,
                                      self.anchor_lowres, low)
                    poor = far > 0.65 * max(icost, 1)
                if full or poor:
                    results += self._flush_minigop()
        self.display_idx += 1
        return results

    def _trellis(self) -> int:
        """b-adapt 2: the index of the pending frame that becomes the P
        anchor, the least normalised path cost scanning from the longest
        mini-GOP down (a strict <, so ties keep the longer one)."""
        costs = self.lookahead.badapt_path_costs(self.anchor_lowres,
                                                 self.pending_lowres)
        best_k, best = len(costs) - 1, None
        for k in range(len(costs) - 1, -1, -1):
            if best is None or costs[k] < best:
                best_k, best = k, costs[k]
        return best_k

    def flush(self, count: int = None) -> List[FrameResult]:
        """End of stream: drain the rc-lookahead window (each frame with
        what remains of its window), then code the open mini-GOP (its last
        frame as the P anchor). flush(count): a direct caller's mini-GOP
        close, _flush_minigop(count), with nothing drained (the
        reference's)."""
        if count is not None:
            return self._flush_minigop(count)
        out = []
        while self.la_queue:
            out += self._pop_la_b()
        return out + self._flush_minigop()

    def _flush_minigop(self, count: int = None) -> List[FrameResult]:
        """Code the first `count` pending frames (default all): the last
        as a P anchor, the others as B frames between the previous anchor
        and it; the rest stay pending. With b_pyramid and two or more B
        frames the middle one is a referenced B and the others predict
        from it and the nearer anchor. Under CQP without two-pass, on the
        device DPB, the frames' QPs are taken first, in this order (the
        reference's pipelined mini-GOP)."""
        if not self.pending:
            return []
        if count is None or count >= len(self.pending):
            count = len(self.pending)
        frames, self.pending = self.pending[:count], self.pending[count:]
        windows = self.pending_windows[:count]
        self.pending_windows = self.pending_windows[count:]
        self.anchor_lowres = self.pending_lowres[count - 1]
        self.pending_lowres = self.pending_lowres[count:]
        prev_anchor, prev_poc = self.anchor
        anchor_poc = prev_poc + len(frames)
        nb = len(frames) - 1
        # coding order: (frame, POC, QP offset: None for the P anchor, 1
        # for the referenced B, 2 for the others; its two references by
        # name and POC; its RPS)
        plan = [(nb, anchor_poc, None, None, None)]
        if self.b_pyramid and nb >= 2:
            m = nb // 2
            bref_poc = prev_poc + 1 + m
            plan.append((m, bref_poc, 1,
                         ("prev", prev_poc, "anchor", anchor_poc), None))
            for i in range(nb):
                poc = prev_poc + 1 + i
                if i < m:
                    # refs (previous anchor, middle B); the next anchor
                    # stays in the RPS, unused, for the Bs after this one
                    plan.append((i, poc, 2, ("prev", prev_poc, "bref",
                                             bref_poc),
                                 ([(poc - prev_poc, 1)],
                                  [(bref_poc - poc, 1),
                                   (anchor_poc - poc, 0)])))
                elif i > m:
                    plan.append((i, poc, 2, ("bref", bref_poc, "anchor",
                                             anchor_poc),
                                 ([(poc - bref_poc, 1)],
                                  [(anchor_poc - poc, 1)])))
        else:
            plan += [(i, prev_poc + 1 + i, 2,
                      ("prev", prev_poc, "anchor", anchor_poc), None)
                     for i in range(nb)]
        pipelined = (self.dpb_device and self.rc.cfg.mode == "cqp"
                     and self.two_pass is None)
        qps = [self._timed("rc", self._minigop_qp, p[1], p[2])
               for p in plan] if pipelined else [None] * len(plan)
        refs, out = {"prev": prev_anchor}, []
        for (i, poc, b_off, r, rps), qp in zip(plan, qps):
            if qp is None:
                qp = self._timed("rc", self._minigop_qp, poc, b_off)
            self._cutree_window = windows[i]
            if b_off is None:
                out.append(self._encode_p_anchor(*frames[i], poc,
                                                 poc - prev_poc, qp))
                refs["anchor"] = self.anchor[0]
                continue
            fr, rec = self._encode_b(*frames[i], poc, refs[r[0]], r[1],
                                     refs[r[2]], r[3], qp,
                                     is_ref=b_off == 1, rps=rps)
            out.append(fr)
            if b_off == 1:
                refs["bref"] = rec
        return out

    def _minigop_qp(self, poc: int, b_off: Optional[int]) -> int:
        """The QP of a mini-GOP frame at poc: the rate control's (+ b_off
        for a B frame, at most 51), then its zone."""
        qp = self.rc.frame_qp(False)
        if b_off is not None:
            qp = min(qp + b_off, 51)
        return self._zone_qp(self.gop_display_base + poc, qp)

    def _encode_idr_anchor(self, y, u, v) -> FrameResult:
        """The GOP's IDR anchor at POC 0 (the reference's
        _encode_anchor(..., idr=True)), at the rate control's QP in its
        zone; also the pipeline's IDR (parallel/session.py)."""
        qp = self._timed("rc", self.rc.frame_qp, True)
        self.gop_display_base = self.display_idx
        qp = self._zone_qp(self.display_idx, qp)
        yp, up, vp = self._pad(y, u, v)
        out, nals = self._code_idr(yp, up, vp, qp, self._qp_map(yp, qp))
        nals = self._provided(0) + nals
        self.anchor = (self._recon_ref(out), 0)
        return self._finish(out, nals, (y, u, v), qp, 0, "I")

    def _encode_cra_gop(self, y, u, v) -> List[FrameResult]:
        """Open-GOP keyframe: this frame as a CRA whose POC continues the
        stream, then the pending frames, in display order, as RASL_N
        leading pictures (non-referenced B frames between the previous
        anchor and the CRA), which a decoder starting at the CRA drops.
        As in the reference (faults in ROADMAP Queue 3): the CRA keeps
        the cuTree window of the frame coded before it, feeds the rate
        control as no slice type (the P predictor) and signals the
        default one-picture RPS; the leading pictures take their QPs one
        after another."""
        prev_anchor, prev_poc = self.anchor
        pending, windows = self.pending, self.pending_windows
        self.pending, self.pending_lowres, self.pending_windows = [], [], []
        cra_poc = prev_poc + len(pending) + 1
        qp = self._timed("rc", self.rc.frame_qp, True)
        qp = self._zone_qp(self.display_idx, qp)
        yp, up, vp = self._pad(y, u, v)
        out = self.intra_sess.code(yp, up, vp, qp,
                                   qp_map=self._qp_map(yp, qp))
        nals = self._timed("serialize", self.intra_sess.assemble_slice, out,
                           qp, NAL_CRA, cra_poc)
        if self.sei_provider is not None:
            nals = self.sei_provider(self.display_idx) + nals
        cra = self._recon_ref(out)
        results = [self._finish(out, nals, (y, u, v), qp, cra_poc, "I",
                                rc_type=None)]
        self.gop_display_base = self.display_idx - cra_poc
        for i, f in enumerate(pending):
            self._cutree_window = windows[i]
            poc = prev_poc + 1 + i
            qp = self._timed("rc", self._minigop_qp, poc, 2)
            results.append(self._encode_b(*f, poc, prev_anchor, prev_poc,
                                          cra, cra_poc, qp,
                                          nal_type=NAL_RASL_N)[0])
        self.anchor = (cra, cra_poc)
        return results

    def _encode_p_anchor(self, y, u, v, poc: int, ref_delta: int,
                         qp: int) -> FrameResult:
        """The mini-GOP's P anchor, ref_delta pictures after the previous
        anchor, at the QP qp."""
        yp, up, vp = self._pad(y, u, v)
        out, nals = self._code_p(yp, up, vp, self.anchor[0], qp, poc,
                                 ref_delta, self._qp_map(yp, qp))
        nals = self._provided(poc) + nals
        self.anchor = (self._recon_ref(out), poc)
        return self._finish(out, nals, (y, u, v), qp, poc, "P")

    def _encode_b(self, y, u, v, poc: int, ref0, poc0: int, ref1, poc1: int,
                  qp: int, is_ref: bool = False, rps=None, nal_type=None):
        """One B frame at the QP qp from ref0 (L0, at poc0) and ref1 (L1,
        at poc1), each (y, u, v) recon planes. is_ref: the pyramid's
        referenced middle B, coded TRAIL_R; nal_type overrides the NAL
        type (an open GOP's RASL_N). Returns the FrameResult and the recon
        planes."""
        yp, up, vp = self._pad(y, u, v)
        qp_map = self._qp_map(yp, qp)
        kw = {"slice_qp": qp} if self.max_depth else {}
        out = _program(self.stage_ms, "inter_b", self.inter_encoder, yp, up,
                       vp, *ref0, qp if qp_map is None else qp_map,
                       ref1=ref1, **kw)
        if qp_map is not None:
            out["qp_map"] = qp_map
        if self.session_filters:
            filter_uniform(out, qp, False, self.cu, self.deblock, self.sao,
                           (yp, up, vp), self.device, self.stage_ms,
                           self.bit_depth, self.intra_sess.deblock_bit_depth)
        nals = self._timed("serialize", self._assemble_b_slice, out, qp, poc,
                           poc0, poc1, is_ref, rps, nal_type)
        nals = self._provided(poc) + nals
        return (self._finish(out, nals, (y, u, v), qp, poc,
                             "B" if is_ref else "b"), self._recon_ref(out))

    def _provided(self, poc: int) -> bytes:
        """sei_provider's bytes for the mini-GOP frame at poc."""
        if self.sei_provider is None:
            return b""
        return self.sei_provider(self.gop_display_base + poc)

    # ------------------------------------------------------------------
    def _code_idr(self, yp, up, vp, qp: int, qp_map=None):
        """(decision dict, slice NAL) of an IDR picture from padded
        planes (at the per-CU QP map qp_map when given), through the intra
        session."""
        out = self.intra_sess.code(yp, up, vp, qp, qp_map=qp_map)
        return out, self._timed("serialize", self.intra_sess.assemble_slice,
                                out, qp)

    def _code_p(self, yp, up, vp, ref, qp: int, poc: int, ref_delta: int,
                qp_map=None, hint=None):
        """(decision dict, slice NAL) of a P picture predicted from the
        recon planes `ref`, ref_delta pictures before it (at the per-CU
        QP map qp_map when given), with weightp at the weights
        _decide_weights picks against `ref`; with n_refs=2 also from
        self.ref2, the picture before `ref` (the first P frame after an
        IDR has none: the program searches `ref` twice and the slice
        signals one reference, as in the reference). hint: the (mvx, mvy)
        of the frame's analysis record, which the hinted program refines
        in place of its full search."""
        kw = {"slice_qp": qp} if self.max_depth else {}
        if self.hinted:
            if hint is None:
                raise ValueError(
                    "the analysis-hinted P program needs hints, and a B "
                    "session's P anchors give none (the reference fails "
                    "there too: ROADMAP Queue 3)")
            kw["hint"] = hint
        weights = None
        if self.weightp:
            weights = self._timed("weights", self._decide_weights, yp, up,
                                  vp, ref)
            kw["weights"] = weights
        n_active = 1
        if self.n_refs > 1:
            kw["ref2"] = ref if self.ref2 is None else self.ref2
            n_active = 1 if self.ref2 is None else 2
        out = _program(self.stage_ms, "inter", self.inter_encoder, yp, up,
                       vp, *ref, qp if qp_map is None else qp_map, **kw)
        if n_active == 1 and out.get("ref") is not None:
            out["ref"] = np.zeros_like(out["ref"])
        self._last_ref_deltas = list(range(1, n_active + 1))
        if qp_map is not None:
            out["qp_map"] = qp_map
        if self.session_filters:
            filter_uniform(out, qp, False, self.cu, self.deblock, self.sao,
                           (yp, up, vp), self.device, self.stage_ms,
                           self.bit_depth, self.intra_sess.deblock_bit_depth)
        return out, self._timed("serialize", self._assemble_p_slice, out, qp,
                                poc, ref_delta, weights, n_active)

    @staticmethod
    def _decide_weights(yp, up, vp, ref):
        """The P frame's explicit weights against the reference planes
        `ref` (host arrays or device tensors; only their [::4, ::4]
        samples are read): per component, from the 4x-subsampled planes
        in float64, a weight from the ratio of the standard deviations
        (none when the reference's is under 0.5), an offset from the
        means, each rounded and clipped, kept when it is not the identity
        and cuts the subsampled SAD below 99% of the unweighted one.
        Returns {"luma" / "cb" / "cr": (w, o)} at denominator 6, or None
        (the reference's weightAnalyse shape, in its order). As in the
        reference, the weighted reference is clipped at 255 whatever the
        bit depth (ROADMAP Queue 3)."""
        out = {}
        for comp, src, rp in (("luma", yp, ref[0]), ("cb", up, ref[1]),
                              ("cr", vp, ref[2])):
            s = np.asarray(src)[::4, ::4].astype(np.float64)
            r = rp[::4, ::4]
            r = (r.cpu().numpy() if isinstance(r, torch.Tensor)
                 else np.asarray(r)).astype(np.float64)
            sd_r = r.std()
            if sd_r < 0.5:
                continue
            w = int(round(64.0 * min(max(s.std() / sd_r, 0.1), 1.99)))
            w = min(max(w, 1), 127)
            o = int(round(s.mean() - w * r.mean() / 64.0))
            o = min(max(o, -128), 127)
            if (w, o) == (64, 0):
                continue
            wr = np.clip((r * w / 64.0) + o, 0, 255)
            if np.abs(s - wr).sum() < 0.99 * np.abs(s - r).sum():
                out[comp] = (w, o)
        return out or None

    @staticmethod
    def _recon_ref(out: dict):
        """A coded picture as a reference: its device recon planes (the
        quadtree programs), else its host recon planes."""
        return out.get("recon_dev") or \
            (out["recon_y"], out["recon_u"], out["recon_v"])

    def _finish(self, out: dict, nals: bytes, frame, qp: int, poc: int,
                frame_type: str, la_cost: float = None,
                rc_type: str = "") -> FrameResult:
        """Append the hash SEI, feed the rate control (as the slice type
        rc_type, by default the frame's; and on the IPPP path pass 2 and
        the pass-1 stats, with the frame's lookahead cost la_cost), and
        make the frame's result (recon cropped to the source, the quality
        metrics against the source planes `frame`)."""
        if self.hash_sei:
            nals += self._timed("serialize", hash_sei, out, self.bit_depth,
                                self.intra_sess.hash_type)
        if rc_type == "":
            rc_type = "B" if frame_type in "Bb" else frame_type
        self._timed("rc", self._rc_done, qp, len(nals) * 8, frame_type,
                    la_cost, rc_type)
        if out.get("recon_y") is None:
            # recon_out=False without the quality metrics or the hash SEI
            # on the quadtree path: the recon never left the device
            return FrameResult(nals=nals, recon=None, bits=len(nals) * 8,
                               psnr_y=0.0, frame_type=frame_type, qp=qp,
                               poc=poc)
        bd = self.bit_depth
        recon = host_planes(out, self.src_h, self.src_w, bd)
        q = frame_quality(recon, *frame, self.device, bd) \
            if self.quality_metrics else (psnr(recon[0], frame[0], bd), 0.0,
                                          0.0, 0.0)
        return FrameResult(nals=nals, recon=recon, bits=len(nals) * 8,
                           psnr_y=q[0], frame_type=frame_type, qp=qp,
                           poc=poc, psnr_u=q[1], psnr_v=q[2], ssim_y=q[3])

    def _rc_done(self, qp: int, bits: int, frame_type: str,
                 la_cost: float, rc_type: str) -> None:
        self.rc.frame_done(qp, bits, slice_type=rc_type)
        if self.bframes:     # the reference's B path stops here
            return
        if self.two_pass is not None:
            self.two_pass.frame_done(bits)
        if self.stats_writer is not None:
            co = None
            if self.cutree and self._cutree_window:
                co = self._window_offsets().reshape(-1).tolist()
            elif self.cutree:
                co = self._cutree_offsets().reshape(-1).tolist()
            self.stats_writer.add(frame_type, qp, bits, la_cost, cuoff=co)

    def _assemble_p_slice(self, out: dict, qp: int, poc: int,
                          ref_delta: int, weights=None,
                          n_refs: int = 1, rps=None) -> bytes:
        """P slice referencing the picture ref_delta before it (with
        n_refs=2 also the one before that), with the explicit weights
        `weights` under weightp; rps: the slice's own short-term RPS
        ((negative pictures, positive pictures), each (delta POC,
        used_by_curr)), None for the one of ref_delta (and of the two
        references). The native writer codes one reference without TMVP;
        two references or TMVP go through the Python CABAC (with the
        cu_qp_delta chain of a QP map), WPP through its substreams."""
        sao, qp_map = out.get("sao"), out.get("qp_map")
        if rps is None and n_refs == 2:
            rps = ([(1, 1), (2, 1)], [])
        hdr = dict(slice_type=1, slice_qp=qp, poc=poc,
                   ref_poc_delta=ref_delta, max_merge=self.max_merge,
                   sao=sao is not None, num_ref_l0=n_refs, rps=rps)
        if self.wpp:
            # the reference's WPP P slice passes no weights (ROADMAP
            # Queue 3) and no QP map
            def code_ctu(enc, r, c):
                self._code_p_ctu(enc, out, grid, r, c, n_refs, None)
            grid = [[None] * self.cols for _ in range(self.rows)]
            return wpp_nal(self.sps, self.pps, NAL_TRAIL_R,
                           wpp_substreams(self.rows, self.cols, 1, qp,
                                          code_ctu), **hdr)
        bw = HDR.write_slice_header(self.sps, self.pps,
                                    nal_type=NAL_TRAIL_R, weights=weights,
                                    **hdr)
        if self.max_depth:
            res = native.encode_slice_qt2(1, self.max_depth, out, qp,
                                          self.max_merge,
                                          sign_hiding=self.sbh, sao=sao,
                                          qp_map=qp_map,
                                          bit_depth=self.bit_depth,
                                          max_tt=int(self.rqt))
        elif n_refs == 1 and not self.tmvp:
            res = native.encode_p_slice(
                out["use_intra"], out["modes"], out["mvx"], out["mvy"],
                out["levels_y"], out["levels_cb"], out["levels_cr"],
                self.cu.bit_length() - 1, qp, self.max_merge,
                sign_hiding=self.sbh, sao=sao, qp_map=qp_map,
                bit_depth=self.bit_depth)
        else:
            res = self._p_slice_py(out, qp, n_refs)
        return _slice_nal(bw, res, NAL_TRAIL_R)

    def _p_slice_py(self, out: dict, qp: int, n_refs: int):
        """The uniform grid's P slice data through the Python CABAC (the
        reference's fallback writer): each CU's SAO and syntax in raster
        order, a QP map's deltas chained through the decoder's qPY_PREV.
        Returns (bytes, tail, tail bits)."""
        enc = CabacEncoder()
        enc.init_contexts(1, qp)
        grid = [[None] * self.cols for _ in range(self.rows)]
        qp_map = out.get("qp_map")
        qp_prev = [qp]
        last = self.rows * self.cols - 1
        for r in range(self.rows):
            for c in range(self.cols):
                self._code_p_ctu(enc, out, grid, r, c, n_refs,
                                 None if qp_map is None
                                 else (int(qp_map[r, c]), qp_prev))
                enc.encode_bin_trm(int(r * self.cols + c == last))
        return enc.finish()

    def _code_p_ctu(self, enc, out: dict, grid, r: int, c: int,
                    n_refs: int, qp_chain) -> None:
        """One CU of a uniform P slice through the Python CABAC: its SAO,
        then its coding unit; qp_chain (the CU's QP, [the QP predictor])
        adds the cu_qp_delta of a CU with a residual."""
        sao = out.get("sao")
        if sao is not None:
            code_sao(enc, sao, r, c, self.cols, self.bit_depth)
        d = self._decide_cu(out, grid, r, c, n_refs)
        delta = None
        if qp_chain is not None and d.has_residual:
            cu_qp, prev = qp_chain
            delta, prev[0] = cu_qp - prev[0], cu_qp
        IS.encode_inter_ctu(enc, d, grid, r, c, self.cu.bit_length() - 1,
                            self.max_merge, sign_hiding=self.sbh,
                            cu_qp_delta=delta, n_refs=n_refs)

    def _decide_cu(self, out: dict, grid, r: int, c: int,
                   n_refs: int = 1) -> IS.InterCTUDecision:
        """A P-slice CU's signalling from the program's decision (the
        reference's _decide_cu): intra, or its (MV, reference) as a merge
        candidate when one of the decoder's list equals it (the first),
        else AMVP against the predictor nearer in L1 distance (ties keep
        the first), under TMVP with the collocated field's candidates."""
        lv = [out[k][r, c] for k in ("levels_y", "levels_cb", "levels_cr")]
        if out["use_intra"][r, c]:
            return IS.InterCTUDecision(True, int(out["modes"][r, c]),
                                       luma_levels=lv[0], cb_levels=lv[1],
                                       cr_levels=lv[2])
        mv = (int(out["mvx"][r, c]), int(out["mvy"][r, c]))
        ref = int(out["ref"][r, c]) if (n_refs > 1 and out.get("ref")
                                        is not None) else 0
        deltas = list(range(1, n_refs + 1))
        col = self.col_field if self.tmvp else None
        cands = IS.merge_candidates_ref(grid, r, c, self.max_merge, n_refs,
                                        col=col, ref_deltas=deltas)
        d = IS.InterCTUDecision(False, mv=mv, ref=ref, luma_levels=lv[0],
                                cb_levels=lv[1], cr_levels=lv[2])
        if (mv, ref) in cands:
            d.merge_idx = cands.index((mv, ref))
            return d
        preds = IS.amvp_candidates(grid, r, c, target_ref=ref,
                                   ref_deltas=deltas, col=col)
        d.mvp_flag, d.mvd = _amvp_choice(mv, preds)
        return d

    def _assemble_b_slice(self, out: dict, qp: int, poc: int, poc0: int,
                          poc1: int, is_ref: bool, rps,
                          nal_type: int = None) -> bytes:
        """B slice between the pictures at poc0 (L0) and poc1 (L1); a
        referenced B is TRAIL_R, the others TRAIL_N, unless nal_type says
        otherwise; under WPP as substreams (no QP map)."""
        if nal_type is None:
            nal_type = NAL_TRAIL_R if is_ref else NAL_TRAIL_N
        sao, qp_map = out.get("sao"), out.get("qp_map")
        hdr = dict(slice_type=0, slice_qp=qp, poc=poc,
                   ref_poc_delta=poc - poc0, pos_poc_delta=poc1 - poc,
                   rps=rps, max_merge=self.max_merge, sao=sao is not None)
        if self.wpp:
            grid = [[None] * self.cols for _ in range(self.rows)]

            def code_ctu(enc, r, c):
                if sao is not None:
                    code_sao(enc, sao, r, c, self.cols, self.bit_depth)
                IS.encode_b_ctu(enc, self._decide_cu_b(out, grid, r, c, poc,
                                                       poc0, poc1),
                                grid, r, c, self.cu.bit_length() - 1,
                                self.max_merge, sign_hiding=self.sbh)
            return wpp_nal(self.sps, self.pps, nal_type,
                           wpp_substreams(self.rows, self.cols, 0, qp,
                                          code_ctu), **hdr)
        bw = HDR.write_slice_header(self.sps, self.pps, nal_type=nal_type,
                                    **hdr)
        if self.max_depth:
            res = native.encode_slice_qt2(0, self.max_depth, out, qp,
                                          self.max_merge, poc=poc,
                                          poc_l0=poc0, poc_l1=poc1,
                                          sign_hiding=self.sbh, sao=sao,
                                          qp_map=qp_map,
                                          bit_depth=self.bit_depth,
                                          max_tt=int(self.rqt))
        else:
            res = native.encode_b_slice(
                out["use_intra"], out["modes"], out["pdir"], *_b_mvs(out),
                out["levels_y"], out["levels_cb"], out["levels_cr"],
                self.cu.bit_length() - 1, qp, self.max_merge, poc, poc0,
                poc1, sign_hiding=self.sbh, sao=sao, qp_map=qp_map,
                bit_depth=self.bit_depth)
        return _slice_nal(bw, res, nal_type)

    def _decide_cu_b(self, out: dict, grid, r: int, c: int, poc: int,
                     poc0: int, poc1: int) -> IS.BCTUDecision:
        """A B-slice CU's signalling (the reference's _decide_cu_b): intra,
        a merge candidate equal to its motion, else each used list's AMVP
        predictor and MVD."""
        lv = [out[k][r, c] for k in ("levels_y", "levels_cb", "levels_cr")]
        if out["use_intra"][r, c]:
            return IS.BCTUDecision(True, int(out["modes"][r, c]),
                                   luma_levels=lv[0], cb_levels=lv[1],
                                   cr_levels=lv[2])
        pdir = int(out["pdir"][r, c])
        mv0 = (int(out["mvx"][r, c]), int(out["mvy"][r, c])) \
            if pdir & 1 else (0, 0)
        mv1 = (int(out["mv1x"][r, c]), int(out["mv1y"][r, c])) \
            if pdir & 2 else (0, 0)
        motion = IS.BMotion(pdir, mv0, mv1)
        d = IS.BCTUDecision(False, motion=motion, luma_levels=lv[0],
                            cb_levels=lv[1], cr_levels=lv[2])
        for i, cand in enumerate(IS.merge_candidates_b(grid, r, c,
                                                       self.max_merge)):
            if cand.key() == motion.key():
                d.merge_idx = i
                return d
        if pdir & 1:
            d.mvp_flag0, d.mvd0 = _amvp_choice(mv0, IS.amvp_candidates_b(
                grid, r, c, 0, poc, poc0, poc1))
        if pdir & 2:
            d.mvp_flag1, d.mvd1 = _amvp_choice(mv1, IS.amvp_candidates_b(
                grid, r, c, 1, poc, poc0, poc1))
        return d

    # ------------------------------------------------------------------
    # per-CU QP: the host API's CTU offsets, AQ, cuTree and pass 2's
    # cuTree offsets (the reference's _frame_qp_map)
    # ------------------------------------------------------------------
    def _qp_map(self, yp, qp: int):
        """The frame's per-CU QP map around the frame QP qp (None without
        CTU offsets, AQ, cuTree and pass-1 offsets), timed as the stage
        "qp_map"."""
        if not (self.aq_mode or self.cutree or self._tp_delta_on
                or self.ctu_info_offsets is not None):
            return None
        return self._timed("qp_map", self._frame_qp_map, yp, qp)

    def _frame_qp_map(self, yp, qp: int) -> np.ndarray:
        """The host API's CTU offsets, AQ's (luma only) and cuTree's:
        pass 2's from the pass-1 stats when the frame has them, else from
        the window's backward propagation while a delayed frame is coded,
        else from the causal average; clipped to 0..51."""
        off = np.zeros((self.rows, self.cols), np.int32)
        if self.ctu_info_offsets is not None:
            off = off + self.ctu_info_offsets
        if self.aq_mode:
            _aq_grid_check(yp, self.cu)
            off = off + compute_aq_offsets(yp, self.cu, self.aq_strength,
                                           mode=self.aq_mode,
                                           bit_depth=self.bit_depth)
        if self._tp_cuoff is not None:
            off = off + self._tp_cuoff
        elif self.cutree and self._cutree_window:
            off = off + self._window_offsets()
        elif self.cutree:
            off = off + self._cutree_offsets()
        return np.clip(qp + off, 0, 51).astype(np.int32)

    def _window_offsets(self) -> np.ndarray:
        """Per-CU integer QP offsets [rows, cols] from the rc-lookahead
        window's backward propagation."""
        off_blk = slicetype.cutree_propagate(self._cutree_window,
                                             strength=self.cutree_strength)
        return slicetype.pool_to_cu(off_blk, self.cu, self.coded_h // self.cu,
                                    self.coded_w // self.cu)

    def _cutree_update(self):
        """Fold the lookahead's last frame into cuTree's causal average:
        each lowres block's intra cost, times the share of it its motion
        explains, scattered (area-weighted) into the previous frame's
        grid; the average halves at every frame."""
        d = self.lookahead.last_detail
        if d is None:
            return
        nbx, nby = d["nb_x"], d["nb_y"]
        if not d["has_prev"]:
            self.cutree_acc *= 0.5
            return
        icost = d["icost"].reshape(nby, nbx).astype(np.float64)
        sad = d["sad"].reshape(nby, nbx).astype(np.float64)
        frac = np.clip(1.0 - sad / np.maximum(icost, 1.0), 0.0, 1.0)
        acc = np.zeros_like(self.cutree_acc)
        slicetype._bilinear_scatter(acc, icost * frac,
                                    d["mvx"].reshape(nby, nbx),
                                    d["mvy"].reshape(nby, nbx))
        self.cutree_acc = 0.5 * self.cutree_acc + acc
        self.cutree_icost = np.maximum(icost, 1.0)

    def _cutree_offsets(self) -> np.ndarray:
        """Per-CU integer QP offsets [rows, cols] from the causal
        average. Each CU pools cu // 16 lowres blocks a side: none at
        cu 8, whose offsets are then all 0 (the reference's fault:
        cuTree's causal average does nothing on the 8x8 grid, where the
        window's pooling takes one block a CU; ROADMAP Queue 3)."""
        rows, cols = self.coded_h // self.cu, self.coded_w // self.cu
        if self.cu < 16:
            return np.zeros((rows, cols), np.int32)
        ratio = (self.cutree_icost + self.cutree_acc) / self.cutree_icost
        off_blk = np.clip(-self.cutree_strength * np.log2(ratio), -6.0, 0.0)
        return slicetype.pool_to_cu(off_blk, self.cu, rows, cols)
