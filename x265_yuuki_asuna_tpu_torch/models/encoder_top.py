"""Top-level encoder session: IPPP, CQP, one L0 reference; the uniform CU
grid or the CTU32 depth-2 quadtree.

Port of the IPPP CQP paths of x265_yuuki_asuna_tpu/models/encoder_top.py
(VideoEncoderSession.encode_frame with its headers, I/P slice assembly,
hash SEI, scenecut and keyint_min; the IntraEncoderSession parts it uses
are folded in). Device work (lookahead, intra and inter programs) runs on
`device`; the CABAC pass runs on the host through the native writer. The
streams are byte-identical to the JAX package's.

With max_depth=2 the session codes CTU32 quadtrees down to 8x8 CUs (the
JAX session's device-DPB quadtree path with both loop filters off): the
reference picture stays on the device between frames and is copied to
the host only for the hash SEI, PSNR and the returned recon.
"""

from __future__ import annotations

import hashlib
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..bitstream import headers as HDR
from ..bitstream import native, sei as SEI
from ..bitstream.bitio import (BitWriter, wrap_nal, NAL_IDR_W_RADL,
                               NAL_SUFFIX_SEI, NAL_TRAIL_R)
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
    "bframes": "the B-frame slice",
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
}
_DEFAULTS = {"bframes": 0, "deblock": False, "sao": False,
             "rc_mode": "cqp", "aq_mode": 0, "cutree": False,
             "weightp": False, "rdoq": False, "sbh": False, "wpp": False,
             "n_refs": 1, "bit_depth": 8, "hme": False, "tmvp": False,
             "frame_dup": False, "rqt": False, "psy_rd": 0.0}


@dataclass
class FrameResult:
    nals: bytes
    recon: Tuple[np.ndarray, np.ndarray, np.ndarray]   # cropped to source size
    bits: int
    psnr_y: float
    frame_type: str = ""   # I / P
    qp: int = 0


class VideoEncoderSession:
    """GOP session: IDR + P frames (IPPP), CQP, one L0 reference.

    max_depth=0 codes the uniform cu_size=16 grid; max_depth=2 codes CTU32
    quadtrees down to 8x8 CUs (cu_size is then 32, as in the JAX session).
    device=None runs on the CUDA card (and raises when there is none);
    device="cpu" runs every kernel's plain PyTorch version. Options of the
    JAX session outside these slices raise NotImplementedError."""

    def __init__(self, width: int, height: int, qp: int = 32,
                 cu_size: int = 16, keyint: int = 25, hash_sei: bool = True,
                 max_depth: int = 0, device=None, **options):
        for k, val in options.items():
            if k not in _DEFAULTS:
                raise TypeError(f"unknown option {k!r}")
            if val != _DEFAULTS[k]:
                raise NotImplementedError(
                    f"{k}={val!r} is not in the port's IPPP CQP slices; "
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
        self.sps = HDR.SPSInfo(
            width=self.coded_w, height=self.coded_h,
            conf_win=(0, self.coded_w - width, 0, self.coded_h - height),
            ptl=HDR.ProfileTierLevel(level_idc=SEI.pick_level(
                self.coded_w, self.coded_h, FPS[0] / FPS[1])),
            log2_min_cb=log2cu - max_depth, log2_diff_max_min_cb=max_depth,
            log2_min_tb=2, log2_diff_max_min_tb=min(log2cu, 5) - 2,
            strong_intra_smoothing=0, max_dec_pic_buffering=2,
            timing_info=(FPS[1], FPS[0]))
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

    def _timed(self, stage: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.stage_ms[stage] += (time.perf_counter() - t0) * 1e3
        return out

    # ------------------------------------------------------------------
    def encode_frame(self, y, u, v) -> FrameResult:
        yp = G.pad_plane(y, self.coded_h, self.coded_w)
        icost, pcost, scenecut = self._timed("lookahead",
                                             self.lookahead.push, yp)
        self.display_idx += 1
        is_idr = (self.frame_idx % self.keyint == 0) or self.ref is None \
            or (scenecut and self.frame_idx >= self.keyint_min)
        qp = self.rc.frame_qp(is_idr, lookahead_cost=icost if is_idr
                              else pcost)
        up = G.pad_plane(u, self.coded_h // 2, self.coded_w // 2)
        vp = G.pad_plane(v, self.coded_h // 2, self.coded_w // 2)
        if is_idr:
            self.poc = 0
            self.frame_idx = 0   # scenecut restarts the GOP
            out = self._timed("intra", self.intra_encoder.encode_frame,
                              yp, up, vp, qp)
            nals = self._timed("serialize", self._assemble_slice, out, qp)
        else:
            self.poc += 1
            out = self._timed("inter", self.inter_encoder.encode_frame,
                              yp, up, vp, *self.ref, qp)
            nals = self._timed("serialize", self._assemble_p_slice, out, qp)
        if self.hash_sei:
            nals += self._timed("serialize", self._hash_sei, out)
        self.ref = out.get("recon_dev") or \
            (out["recon_y"], out["recon_u"], out["recon_v"])
        self.frame_idx += 1
        self.rc.frame_done(qp, len(nals) * 8)
        rec_y = out["recon_y"][:self.src_h, :self.src_w]
        mse = float(np.mean((rec_y.astype(np.float64) - y) ** 2))
        psnr = 99.99 if mse == 0 else 10 * np.log10(255 * 255 / mse)
        ch, cw = self.src_h // 2, self.src_w // 2
        recon = (rec_y.astype(np.uint8),
                 out["recon_u"][:ch, :cw].astype(np.uint8),
                 out["recon_v"][:ch, :cw].astype(np.uint8))
        return FrameResult(nals=nals, recon=recon, bits=len(nals) * 8,
                           psnr_y=psnr, frame_type="I" if is_idr else "P",
                           qp=qp)

    # ------------------------------------------------------------------
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

    def _assemble_p_slice(self, out: dict, qp: int) -> bytes:
        """P slice referencing the previous picture."""
        bw = HDR.write_slice_header(self.sps, self.pps, slice_type=1,
                                    slice_qp=qp, nal_type=NAL_TRAIL_R,
                                    poc=self.poc, ref_poc_delta=1,
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
