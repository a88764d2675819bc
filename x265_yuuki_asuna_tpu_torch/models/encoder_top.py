"""Top-level encoder session: CQP, one reference per list; IPPP on the
uniform CU grid or the CTU32 depth-2 quadtree, and fixed mini-GOPs with B
frames on the quadtree.

Port of the CQP paths of x265_yuuki_asuna_tpu/models/encoder_top.py
(VideoEncoderSession.encode_frame with its headers, I/P slice assembly,
hash SEI, scenecut and keyint_min; push_frame / flush with b_adapt=0, the
B-pyramid and the B slice assembly; the IntraEncoderSession parts it uses
are folded in). Device work (lookahead, intra and inter programs) runs on
`device`; the CABAC pass runs on the host through the native writer. The
streams are byte-identical to the JAX package's.

With max_depth=2 the session codes CTU32 quadtrees down to 8x8 CUs (the
JAX session's device-DPB quadtree path with both loop filters off): the
reference pictures stay on the device between frames and are copied to
the host only for the hash SEI, PSNR and the returned recon.

With bframes > 0 (max_depth=2, b_adapt=0) frames go through push_frame
and flush: each mini-GOP of bframes + 1 frames codes its last frame as a P
anchor, then the frames before it as B frames between the two anchors;
with b_pyramid and two or more B frames the middle one is a referenced B
(TRAIL_R) that the outer ones predict from. The JAX session pipelines a
mini-GOP's device programs under CQP; the port runs them in order, which
codes the same stream.
"""

from __future__ import annotations

import hashlib
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..bitstream import headers as HDR
from ..bitstream import native, sei as SEI
from ..bitstream.bitio import (BitWriter, wrap_nal, NAL_IDR_W_RADL,
                               NAL_SUFFIX_SEI, NAL_TRAIL_N, NAL_TRAIL_R)
from ..utils import geometry as G
from ..utils.device import exact_fp32_matmul, resolve_device
from .inter_encoder import InterFrameEncoder, InterQTEncoder
from .intra_encoder import IntraFrameEncoder, IntraQTEncoder
from .lookahead import Lookahead
from .ratecontrol import RateControl

FPS = (25, 1)      # signalled frame rate (VUI timing, level, keyint_min)
MAX_MERGE = 3      # merge candidates (five_minus_max_num_merge_cand = 2)

# options of the JAX session that later slices of the port add
_LATER = {
    "deblock": "the in-program filters slice",
    "sao": "the in-program filters slice",
    "rc_mode": "the CRF/AQ/cuTree rate-control slice",
    "aq_mode": "the CRF/AQ/cuTree rate-control slice",
    "cutree": "the CRF/AQ/cuTree rate-control slice",
    "weightp": "a later P-frame slice", "rdoq": "the RDOQ/SBH slice",
    "sbh": "the RDOQ/SBH slice", "wpp": "a later P-frame slice",
    "n_refs": "a later P-frame slice", "bit_depth": "a later P-frame slice",
    "hme": "the HME slice", "tmvp": "a later P-frame slice",
    "frame_dup": "a later P-frame slice", "rqt": "the RQT slice",
    "psy_rd": "the psy-rd slice",
    "open_gop": "the open-GOP slice (CRA keyframes with leading pictures)",
    "b_intra": "a later B-frame slice (intra candidates in B slices)",
}
_DEFAULTS = {"deblock": False, "sao": False,
             "rc_mode": "cqp", "aq_mode": 0, "cutree": False,
             "weightp": False, "rdoq": False, "sbh": False, "wpp": False,
             "n_refs": 1, "bit_depth": 8, "hme": False, "tmvp": False,
             "frame_dup": False, "rqt": False, "psy_rd": 0.0,
             "open_gop": False, "b_intra": False}


@dataclass
class FrameResult:
    """One coded picture: its NAL units (slice + hash SEI), the recon
    cropped to the source size, its picture order count and its type:
    "I" (IDR), "P", "B" (a referenced B, the pyramid's middle) or "b" (a
    non-referenced B)."""
    nals: bytes
    recon: Tuple[np.ndarray, np.ndarray, np.ndarray]   # cropped to source size
    bits: int
    psnr_y: float
    frame_type: str = ""   # I / P / B / b
    qp: int = 0
    poc: int = 0


class VideoEncoderSession:
    """GOP session, CQP, one reference per list.

    max_depth=0 codes the uniform cu_size=16 grid; max_depth=2 codes CTU32
    quadtrees down to 8x8 CUs (cu_size is then 32, as in the JAX session).
    bframes=0 codes IDR + P frames through encode_frame; bframes > 0 (with
    max_depth=2 and b_adapt=0) codes fixed mini-GOPs with B frames through
    push_frame and flush, with the B-pyramid when b_pyramid is set.
    device=None runs on the CUDA card (and raises when there is none);
    device="cpu" runs every kernel's plain PyTorch version. Options of the
    JAX session outside these slices raise NotImplementedError."""

    def __init__(self, width: int, height: int, qp: int = 32,
                 cu_size: int = 16, keyint: int = 25, hash_sei: bool = True,
                 max_depth: int = 0, bframes: int = 0,
                 b_pyramid: bool = True, b_adapt: int = 2, device=None,
                 **options):
        for k, val in options.items():
            if k not in _DEFAULTS:
                raise TypeError(f"unknown option {k!r}")
            if val != _DEFAULTS[k]:
                raise NotImplementedError(
                    f"{k}={val!r} is not in the port's CQP slices; "
                    f"{_LATER[k]} adds it")
        if max_depth not in (0, 2):
            raise NotImplementedError(
                f"max_depth={max_depth}: the port codes the uniform grid "
                "(0) and the CTU32 depth-2 quadtree (2); the max_depth=1 "
                "slice adds depth 1")
        if max_depth and cu_size == 64:
            raise NotImplementedError(
                "max_depth with cu_size=64: the CTU64 slice adds CTU64 "
                "quadtrees")
        if bframes > 0 and not max_depth:
            raise NotImplementedError(
                f"bframes={bframes} with max_depth=0: the port codes B "
                "frames on the CTU32 depth-2 quadtree only; B frames on the "
                "uniform 16x16 grid are still to come (a later B-frame "
                "slice)")
        if bframes > 0 and b_adapt:
            raise NotImplementedError(
                f"bframes={bframes} with b_adapt={b_adapt}: the port closes "
                "each mini-GOP at bframes + 1 frames (b_adapt=0); the "
                "lookahead b-adapt slice adds b_adapt 1 and 2")
        if max_depth:
            cu_size = 32
        elif cu_size != 16:
            raise NotImplementedError(
                "cu_size != 16: the port's uniform slice codes the 16x16 "
                "CU grid")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            exact_fp32_matmul()
        self.src_w, self.src_h = width, height
        self.qp = qp
        self.cu = cu_size
        self.max_depth = max_depth
        self.keyint = max(keyint, 1)
        # reference keyframeMin: scenecut IDRs are suppressed closer than
        # this to the last keyframe
        self.keyint_min = max(1, min(FPS[0] // FPS[1], self.keyint // 10))
        self.hash_sei = hash_sei
        self.coded_w = G.cdiv(width, cu_size) * cu_size
        self.coded_h = G.cdiv(height, cu_size) * cu_size
        log2cu = cu_size.bit_length() - 1
        self.bframes = max(0, bframes)
        self.b_pyramid = b_pyramid and self.bframes >= 2
        # the DPB holds the two anchors (and the pyramid's middle B) while
        # the B frames between them are decoded
        dpb, reorder = ((5, 2) if self.b_pyramid else (4, 1)) \
            if self.bframes else (2, 0)
        self.sps = HDR.SPSInfo(
            width=self.coded_w, height=self.coded_h,
            conf_win=(0, self.coded_w - width, 0, self.coded_h - height),
            ptl=HDR.ProfileTierLevel(level_idc=SEI.pick_level(
                self.coded_w, self.coded_h, FPS[0] / FPS[1])),
            log2_min_cb=log2cu - max_depth, log2_diff_max_min_cb=max_depth,
            log2_min_tb=2, log2_diff_max_min_tb=min(log2cu, 5) - 2,
            strong_intra_smoothing=0, max_dec_pic_buffering=dpb,
            num_reorder_pics=reorder, timing_info=(FPS[1], FPS[0]))
        self.pps = HDR.PPSInfo(init_qp=26, deblocking_disabled=1)
        if max_depth:
            self.intra_encoder = IntraQTEncoder(self.coded_w, self.coded_h,
                                                self.device)
            self.inter_encoder = InterQTEncoder(self.coded_w, self.coded_h,
                                                self.device)
        else:
            self.intra_encoder = IntraFrameEncoder(
                self.coded_w, self.coded_h, cu_size, self.device)
            self.inter_encoder = InterFrameEncoder(
                self.coded_w, self.coded_h, cu_size, self.device)
        self.lookahead = Lookahead(self.coded_w, self.coded_h, self.device)
        self.rc = RateControl(qp)
        self.frame_idx = 0
        self.poc = 0
        self.display_idx = 0
        # (y, u, v) padded recon planes of the reference picture: host
        # arrays on the uniform grid, uint8 device tensors for quadtrees
        self.ref = None
        # push_frame state: display-order frames of the open mini-GOP, the
        # last anchor's (recon planes, poc), the last IDR's display index
        self.pending = []
        self.anchor = None
        self._last_idr_didx = -10 ** 9
        # wall-clock ms per stage, summed over frames (each stage ends in a
        # device->host copy, so the times include the device work)
        self.stage_ms = defaultdict(float)

    # ------------------------------------------------------------------
    def headers(self) -> bytes:
        out = (HDR.write_vps(self.sps) + HDR.write_sps(self.sps)
               + HDR.write_pps(self.pps))
        return out + SEI.wrap_sei([
            SEI.active_parameter_sets(),
            # same info string as the JAX package, so the two streams can
            # be compared byte for byte
            SEI.user_data_unregistered(
                "x265-yuuki-asuna-tpu - TPU-native HEVC encoder - "
                f"{self.src_w}x{self.src_h} qp={self.qp} ctu={self.cu}")])

    def _timed(self, stage: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.stage_ms[stage] += (time.perf_counter() - t0) * 1e3
        return out

    def _pad(self, y, u, v):
        return (G.pad_plane(y, self.coded_h, self.coded_w),
                G.pad_plane(u, self.coded_h // 2, self.coded_w // 2),
                G.pad_plane(v, self.coded_h // 2, self.coded_w // 2))

    # ------------------------------------------------------------------
    def encode_frame(self, y, u, v) -> FrameResult:
        """Code the next frame of an IPPP session (bframes=0)."""
        if self.bframes:
            raise RuntimeError(
                "encode_frame codes IPPP sessions; a session with bframes "
                "> 0 takes its frames through push_frame and flush")
        yp, up, vp = self._pad(y, u, v)
        icost, pcost, scenecut = self._timed("lookahead",
                                             self.lookahead.push, yp)
        self.display_idx += 1
        is_idr = (self.frame_idx % self.keyint == 0) or self.ref is None \
            or (scenecut and self.frame_idx >= self.keyint_min)
        qp = self.rc.frame_qp(is_idr, lookahead_cost=icost if is_idr
                              else pcost)
        if is_idr:
            self.poc = 0
            self.frame_idx = 0   # scenecut restarts the GOP
            out, nals = self._code_idr(yp, up, vp, qp)
        else:
            self.poc += 1
            out, nals = self._code_p(yp, up, vp, self.ref, qp, self.poc, 1)
        self.ref = self._recon_ref(out)
        self.frame_idx += 1
        return self._finish(out, nals, y, qp, self.poc,
                            "I" if is_idr else "P")

    # ------------------------------------------------------------------
    # mini-GOPs with B frames (bframes > 0): the JAX session's push_frame
    # at la_depth 0 with b_adapt=0, and its sequential mini-GOP flush
    # ------------------------------------------------------------------
    def push_frame(self, y, u, v) -> List[FrameResult]:
        """Take one display-order frame; returns the frames it completes
        (none, or a whole mini-GOP in coding order)."""
        if not self.bframes:
            raise RuntimeError("push_frame needs bframes > 0; IPPP sessions "
                               "use encode_frame")
        yp = G.pad_plane(y, self.coded_h, self.coded_w)
        _, _, scenecut = self._timed("lookahead", self.lookahead.push, yp)
        results = []
        if (self.display_idx % self.keyint == 0 or self.anchor is None
                or (scenecut and self.display_idx - self._last_idr_didx
                    >= self.keyint_min)):
            self._last_idr_didx = self.display_idx
            results += self._flush_minigop()
            results.append(self._encode_idr_anchor(y, u, v))
        else:
            self.pending.append((y, u, v))
            if len(self.pending) == self.bframes + 1:
                results += self._flush_minigop()
        self.display_idx += 1
        return results

    def flush(self) -> List[FrameResult]:
        """End of stream: code the open mini-GOP (its last frame as the P
        anchor)."""
        return self._flush_minigop()

    def _flush_minigop(self) -> List[FrameResult]:
        """Code the pending frames: the last as a P anchor, the others as B
        frames between the previous anchor and it. With b_pyramid and two
        or more B frames the middle one is a referenced B and the others
        predict from it and the nearer anchor."""
        if not self.pending:
            return []
        frames, self.pending = self.pending, []
        prev_anchor, prev_poc = self.anchor
        anchor_poc = prev_poc + len(frames)
        out = [self._encode_p_anchor(*frames[-1], anchor_poc,
                                     anchor_poc - prev_poc)]
        new_anchor = self.anchor[0]
        nb = len(frames) - 1
        if self.b_pyramid and nb >= 2:
            m = nb // 2
            bref_poc = prev_poc + 1 + m
            fr, bref = self._encode_b(*frames[m], bref_poc, prev_anchor,
                                      prev_poc, new_anchor, anchor_poc,
                                      is_ref=True)
            out.append(fr)
            for i, f in enumerate(frames[:-1]):
                if i == m:
                    continue
                poc = prev_poc + 1 + i
                if i < m:
                    # refs (previous anchor, middle B); the next anchor
                    # stays in the RPS, unused, for the Bs after this one
                    rps = ([(poc - prev_poc, 1)],
                           [(bref_poc - poc, 1), (anchor_poc - poc, 0)])
                    refs = (prev_anchor, prev_poc, bref, bref_poc)
                else:
                    rps = ([(poc - bref_poc, 1)], [(anchor_poc - poc, 1)])
                    refs = (bref, bref_poc, new_anchor, anchor_poc)
                out.append(self._encode_b(*f, poc, *refs, rps=rps)[0])
        else:
            for i, f in enumerate(frames[:-1]):
                out.append(self._encode_b(*f, prev_poc + 1 + i, prev_anchor,
                                          prev_poc, new_anchor,
                                          anchor_poc)[0])
        return out

    def _encode_idr_anchor(self, y, u, v) -> FrameResult:
        qp = self.rc.frame_qp(True)
        out, nals = self._code_idr(*self._pad(y, u, v), qp)
        self.anchor = (self._recon_ref(out), 0)
        return self._finish(out, nals, y, qp, 0, "I")

    def _encode_p_anchor(self, y, u, v, poc: int,
                         ref_delta: int) -> FrameResult:
        """The mini-GOP's P anchor, ref_delta pictures after the previous
        anchor."""
        qp = self.rc.frame_qp(False)
        out, nals = self._code_p(*self._pad(y, u, v), self.anchor[0], qp,
                                 poc, ref_delta)
        self.anchor = (self._recon_ref(out), poc)
        return self._finish(out, nals, y, qp, poc, "P")

    def _encode_b(self, y, u, v, poc: int, ref0, poc0: int, ref1, poc1: int,
                  is_ref: bool = False, rps=None):
        """One B frame from ref0 (L0, at poc0) and ref1 (L1, at poc1), each
        (y, u, v) recon planes. is_ref: the pyramid's referenced middle B,
        coded TRAIL_R at a QP offset of 1 instead of 2. Returns the
        FrameResult and the recon planes."""
        yp, up, vp = self._pad(y, u, v)
        qp = min(self.rc.frame_qp(False) + (1 if is_ref else 2), 51)
        out = self._timed("inter_b", self.inter_encoder.encode_frame,
                          yp, up, vp, *ref0, qp, ref1=ref1)
        nals = self._timed("serialize", self._assemble_b_slice, out, qp, poc,
                           poc0, poc1, is_ref, rps)
        return (self._finish(out, nals, y, qp, poc, "B" if is_ref else "b"),
                self._recon_ref(out))

    # ------------------------------------------------------------------
    def _code_idr(self, yp, up, vp, qp: int):
        """(decision dict, slice NAL) of an IDR picture from padded
        planes."""
        out = self._timed("intra", self.intra_encoder.encode_frame,
                          yp, up, vp, qp)
        return out, self._timed("serialize", self._assemble_slice, out, qp)

    def _code_p(self, yp, up, vp, ref, qp: int, poc: int, ref_delta: int):
        """(decision dict, slice NAL) of a P picture predicted from the
        recon planes `ref`, ref_delta pictures before it."""
        out = self._timed("inter", self.inter_encoder.encode_frame,
                          yp, up, vp, *ref, qp)
        return out, self._timed("serialize", self._assemble_p_slice, out, qp,
                                poc, ref_delta)

    @staticmethod
    def _recon_ref(out: dict):
        """A coded picture as a reference: its device recon planes (the
        quadtree programs), else its host recon planes."""
        return out.get("recon_dev") or \
            (out["recon_y"], out["recon_u"], out["recon_v"])

    def _finish(self, out: dict, nals: bytes, y, qp: int, poc: int,
                frame_type: str) -> FrameResult:
        """Append the hash SEI, feed the rate control, and make the
        frame's result (recon cropped to the source, PSNR-Y)."""
        if self.hash_sei:
            nals += self._timed("serialize", self._hash_sei, out)
        # CQP's history counters do not read the slice type
        self.rc.frame_done(qp, len(nals) * 8)
        rec_y = out["recon_y"][:self.src_h, :self.src_w]
        mse = float(np.mean((rec_y.astype(np.float64) - y) ** 2))
        psnr = 99.99 if mse == 0 else 10 * np.log10(255 * 255 / mse)
        ch, cw = self.src_h // 2, self.src_w // 2
        recon = (rec_y.astype(np.uint8),
                 out["recon_u"][:ch, :cw].astype(np.uint8),
                 out["recon_v"][:ch, :cw].astype(np.uint8))
        return FrameResult(nals=nals, recon=recon, bits=len(nals) * 8,
                           psnr_y=psnr, frame_type=frame_type, qp=qp,
                           poc=poc)

    def _slice_nal(self, bw: BitWriter, res, nal_type: int) -> bytes:
        data, tail, tail_bits = res
        bw.write_bytes(data)
        bw.write_bits(tail, tail_bits)
        bw.rbsp_trailing_bits()
        return wrap_nal(nal_type, bw.get_bytes())

    def _assemble_slice(self, out: dict, qp: int) -> bytes:
        """IDR I slice."""
        bw = HDR.write_slice_header(self.sps, self.pps, slice_type=2,
                                    slice_qp=qp, nal_type=NAL_IDR_W_RADL)
        if self.max_depth:
            res = native.encode_slice_qt2(2, self.max_depth, out, qp)
        else:
            res = native.encode_intra_slice(
                out["modes"], out["levels_y"], out["levels_cb"],
                out["levels_cr"], self.cu.bit_length() - 1, qp)
        return self._slice_nal(bw, res, NAL_IDR_W_RADL)

    def _assemble_p_slice(self, out: dict, qp: int, poc: int,
                          ref_delta: int) -> bytes:
        """P slice referencing the picture ref_delta before it."""
        bw = HDR.write_slice_header(self.sps, self.pps, slice_type=1,
                                    slice_qp=qp, nal_type=NAL_TRAIL_R,
                                    poc=poc, ref_poc_delta=ref_delta,
                                    max_merge=MAX_MERGE)
        if self.max_depth:
            res = native.encode_slice_qt2(1, self.max_depth, out, qp,
                                          MAX_MERGE)
        else:
            res = native.encode_p_slice(
                out["use_intra"], out["modes"], out["mvx"], out["mvy"],
                out["levels_y"], out["levels_cb"], out["levels_cr"],
                self.cu.bit_length() - 1, qp, MAX_MERGE)
        return self._slice_nal(bw, res, NAL_TRAIL_R)

    def _assemble_b_slice(self, out: dict, qp: int, poc: int, poc0: int,
                          poc1: int, is_ref: bool, rps) -> bytes:
        """Quadtree B slice between the pictures at poc0 (L0) and poc1
        (L1); a referenced B is TRAIL_R, the others TRAIL_N."""
        nal_type = NAL_TRAIL_R if is_ref else NAL_TRAIL_N
        bw = HDR.write_slice_header(self.sps, self.pps, slice_type=0,
                                    slice_qp=qp, nal_type=nal_type, poc=poc,
                                    ref_poc_delta=poc - poc0,
                                    pos_poc_delta=poc1 - poc, rps=rps,
                                    max_merge=MAX_MERGE)
        res = native.encode_slice_qt2(0, self.max_depth, out, qp, MAX_MERGE,
                                      poc=poc, poc_l0=poc0, poc_l1=poc1)
        return self._slice_nal(bw, res, nal_type)

    def _hash_sei(self, out: dict) -> bytes:
        """Decoded-picture-hash suffix SEI (MD5 of each coded-size recon
        plane)."""
        bw = BitWriter()
        bw.write_bits(132, 8)          # payload type: decoded_picture_hash
        payload = bytearray([0])       # hash_type 0 = MD5
        for plane in ("recon_y", "recon_u", "recon_v"):
            payload += hashlib.md5(out[plane].astype(np.uint8)
                                   .tobytes()).digest()
        bw.write_bits(len(payload), 8)
        bw.write_bytes(payload)
        bw.rbsp_trailing_bits()
        return wrap_nal(NAL_SUFFIX_SEI, bw.get_bytes())
