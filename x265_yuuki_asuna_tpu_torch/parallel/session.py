"""The pipelined multi-slot session, the frame pipeline as a product path
(CLI --devices N): port of x265_yuuki_asuna_tpu/parallel/session.py.

GOP shape, as in the reference: one IDR, then P-chains of N frames (N =
the slot count), each chain re-anchored at the IDR recon, the last one
padded with the clip's last frame. Frame k of a chain is coded by slot k
against the recon of frame k-1 (frame 0: the IDR's) through
pipeline.frame_pipeline_stream_fn; the host writes each frame's slice
(the RPS of frame 0 holds the IDR, that of frame k > 0 the frame before
it and the IDR, unused, so that decoders keep the IDR for the next
chain). The session under it is a plain CTU16 CQP session without loop
filters (none may run in the handoff).

Kept from the reference byte for byte (ROADMAP Queue 3):
  * the P programs of every chain run at the QP chosen before the first
    chain; under ABR (rc_mode="abr") the rate control picks a QP per
    chain, from the bits of the chain before (and the IDR's, fed once),
    which only the slice headers and the results carry, so the stream
    decodes to another picture from the second chain on;
  * a frame with a level outside [-128, 127] raises RuntimeError (the
    reference's program packs levels as int8 pairs and refuses); the
    sequential path codes it;
  * encode_clip_sequential, the host-loop comparator, writes no hash SEI
    and takes the session QP.
Each result carries PSNR of Y, U and V and SSIM of Y against its own
source frame (the reference measures U and V against the IDR's).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.encoder_top import (FrameResult, VideoEncoderSession,
                                  frame_quality, hash_sei, host_planes)
from ..models.ratecontrol import RateControl, RCConfig
from ..utils import geometry as G
from .mesh import make_slots
from .pipeline import frame_pipeline_stream_fn

_OVERFLOW = ("pipeline frame levels overflowed int8 packing (very low "
             "QP?); use the sequential path for this configuration")


def _overflows(out: dict) -> bool:
    """Whether a level lies outside the reference's int8 packing."""
    return any(np.any((out[k] > 127) | (out[k] < -128))
               for k in ("levels_y", "levels_cb", "levels_cr"))


class PipelinedEncoder:
    """IDR + P-chains across n_devices slots (None: one per card; slots
    wrap round-robin over the cards, or the CPU with device="cpu"; see
    mesh.make_slots). qp: the CQP, or the first chain's QP under
    rc_mode="abr" with bitrate_kbps; hash_sei: an MD5 hash SEI after each
    picture of encode_clip."""

    def __init__(self, width: int, height: int, qp: int = 32,
                 cu_size: int = 16, n_devices: int = None,
                 fps=(25, 1), hash_sei: bool = False,
                 rc_mode: str = "cqp", bitrate_kbps: int = 0,
                 device=None, devices=None):
        self.slots = make_slots(n_devices, device, devices)
        self.n = len(self.slots)
        self.sess = VideoEncoderSession(
            width, height, qp=qp, cu_size=cu_size, fps=fps, keyint=10 ** 9,
            hash_sei=hash_sei, deblock=False, sao=False, rc_mode="cqp",
            qp_min=qp, qp_max=qp, device=self.slots[0].device)
        self.qp = qp
        self.rc_mode = rc_mode
        if rc_mode == "abr":
            self.rc = RateControl(RCConfig(
                mode="abr", qp=qp, bitrate_kbps=bitrate_kbps,
                fps=fps[0] / max(fps[1], 1), width=width, height=height))

    def headers(self) -> bytes:
        return self.sess.headers()

    def _pad(self, frame):
        sess = self.sess
        H, W = sess.coded_h, sess.coded_w
        return (G.pad_plane(frame[0], H, W),
                G.pad_plane(frame[1], H // 2, W // 2),
                G.pad_plane(frame[2], H // 2, W // 2))

    @staticmethod
    def _rps(poc: int, k: int):
        """A chain frame's RPS: the IDR (frame 0), else the frame before
        it, with the IDR kept unused."""
        return ([(poc, 1)], []) if k == 0 else ([(1, 1), (poc, 0)], [])

    def _result(self, out: dict, nals: bytes, qp: int, poc: int,
                frame) -> FrameResult:
        sess = self.sess
        bd = sess.bit_depth
        recon = host_planes(out, sess.src_h, sess.src_w, bd)
        q = frame_quality(recon, *frame, sess.device, bd)
        return FrameResult(nals=nals, recon=recon, bits=len(nals) * 8,
                           psnr_y=q[0], frame_type="P", qp=qp, poc=poc,
                           psnr_u=q[1], psnr_v=q[2], ssim_y=q[3])

    def encode_clip(self, frames) -> List[FrameResult]:
        """frames: display-order [(y, u, v)] planes. Frame 0 is coded as
        the IDR; the rest stream through the pipeline in chains of N."""
        sess, N = self.sess, self.n
        results = [sess._encode_idr_anchor(*frames[0])]
        idr_rec = sess.anchor[0]
        rest = frames[1:]
        if not rest:
            return results
        nchains = -(-len(rest) // N)
        qp = self.qp
        if self.rc_mode == "abr":
            self.rc.frame_done(results[0].qp, results[0].bits,
                               slice_type="I")
            qp = self.rc.frame_qp(False)
        padded = [self._pad(f) for f in
                  rest + [rest[-1]] * (nchains * N - len(rest))]
        chains = [[padded[t * N + k] for k in range(N)]
                  for t in range(nchains)]
        fn = frame_pipeline_stream_fn(sess.inter_encoder, self.slots,
                                      nchains, qp=qp)
        outs = fn(*([[f[i] for f in c] for c in chains] for i in range(3)),
                  *idr_rec)
        idx = 0
        for t in range(nchains):
            for k in range(N):
                if idx >= len(rest):
                    break
                idx += 1
                out = outs[t][k]
                if _overflows(out):
                    raise RuntimeError(_OVERFLOW)
                poc = t * N + k + 1
                nals = sess._assemble_p_slice(out, qp, poc, 1,
                                              rps=self._rps(poc, k))
                if sess.hash_sei:
                    nals += hash_sei(out, sess.bit_depth,
                                     sess.intra_sess.hash_type)
                results.append(self._result(out, nals, qp, poc,
                                            rest[idx - 1]))
            if self.rc_mode == "abr":
                # the last N results, as the reference feeds them (a short
                # last chain takes frames of the chain before it)
                for fr in results[-N:]:
                    self.rc.frame_done(fr.qp, fr.bits, slice_type="P")
                qp = self.rc.frame_qp(False)
        return results

    def encode_clip_sequential(self, frames) -> List[FrameResult]:
        """The host-loop comparator: the same chains coded one frame at a
        time on the session's device, byte for byte encode_clip's at a
        fixed QP without the hash SEI."""
        sess, N = self.sess, self.n
        results = [sess._encode_idr_anchor(*frames[0])]
        idr_rec = ref = sess.anchor[0]
        enc = sess.inter_encoder
        for i, frame in enumerate(frames[1:]):
            k = i % N
            if k == 0:
                ref = idr_rec
            out = enc.encode_frame(*self._pad(frame), *ref, self.qp)
            poc = i + 1
            nals = sess._assemble_p_slice(out, self.qp, poc, 1,
                                          rps=self._rps(poc, k))
            results.append(self._result(out, nals, self.qp, poc, frame))
            ref = (out["recon_y"], out["recon_u"], out["recon_v"])
        return results
