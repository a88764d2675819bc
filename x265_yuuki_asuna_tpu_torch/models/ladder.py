"""ABR-ladder encoding (reference analog: x265's abrEncApp): one pass over
the source codes it at several resolutions and bitrates, each frame
scaled to every rung by ops/scaler.py.

Port of x265_yuuki_asuna_tpu/models/ladder.py (Rung, parse_ladder,
LadderEncoder). Each rung is one VideoEncoderSession (IPPP on the
uniform 16x16 grid, ABR at the rung's bitrate, CQP without one); a frame
goes through every rung before the next frame is read. The analysis
hand-off: the smallest rung codes first and its MV field, scaled by
scale_analysis_rec, becomes the hints of every rung that is an exact 2x
or 4x of it (the reference AbrEncoder's shared analysis).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Tuple

from ..ops import scaler as SC
from .encoder_top import FrameResult, VideoEncoderSession, scale_analysis_rec


@dataclass
class Rung:
    width: int
    height: int
    bitrate_kbps: int


def parse_ladder(spec: str) -> List[Rung]:
    """Rungs from "1280x720:2000,640x360:800" (a rung without ":kbps" is
    coded at a constant QP)."""
    rungs = []
    for part in spec.split(","):
        res, _, rate = part.strip().partition(":")
        w, h = (int(x) for x in res.lower().split("x"))
        rungs.append(Rung(w, h, int(rate) if rate else 0))
    return rungs


class LadderEncoder:
    """The rungs' sessions over one source of src_w x src_h (8-bit 4:2:0
    planes), each scaled to its rung on the sessions' device (the scaler's
    8-bit clip, as in the reference). share_analysis: the smallest rung
    (`donor`) codes first and hands its records to the rungs
    consumer_sf maps to their scale factor. session_kw go to every
    session (e.g. hash_sei, device)."""

    def __init__(self, src_w: int, src_h: int, rungs: List[Rung],
                 fps: Tuple[int, int] = (25, 1), qp: int = 32,
                 keyint: int = 250, share_analysis: bool = True,
                 **session_kw):
        self.src_w, self.src_h = src_w, src_h
        self.rungs = rungs
        areas = [r.width * r.height for r in rungs]
        self.donor = areas.index(min(areas)) if share_analysis else -1
        self.consumer_sf = {}
        if share_analysis:
            dw, dh = rungs[self.donor].width, rungs[self.donor].height
            for i, r in enumerate(rungs):
                if i == self.donor:
                    continue
                if (r.width % dw == 0 and r.height % dh == 0
                        and r.width // dw == r.height // dh
                        and r.width // dw in (2, 4)):
                    self.consumer_sf[i] = r.width // dw
        self.sessions = []
        self._feeds = {}
        for i, r in enumerate(rungs):
            share = None
            if i == self.donor and self.consumer_sf:
                share = "save"
            elif i in self.consumer_sf:
                share = []
                self._feeds[i] = share
            self.sessions.append(VideoEncoderSession(
                r.width, r.height, qp=qp, fps=fps, keyint=keyint,
                rc_mode="abr" if r.bitrate_kbps else "cqp",
                bitrate_kbps=r.bitrate_kbps, analysis_share=share,
                **session_kw))
        # wall-clock ms of the scaler, summed over frames
        self.scale_ms = 0.0

    def headers(self) -> List[bytes]:
        return [s.headers() for s in self.sessions]

    def encode_frame(self, y, u, v) -> List[FrameResult]:
        """Code one source frame on every rung; the results in rung
        order."""
        out = [None] * len(self.rungs)
        order = list(range(len(self.rungs)))
        if self.donor >= 0 and self.consumer_sf:
            order.remove(self.donor)
            order.insert(0, self.donor)
        for i in order:
            r, sess = self.rungs[i], self.sessions[i]
            if (r.width, r.height) != (self.src_w, self.src_h):
                t0 = time.perf_counter()
                ys, us, vs = SC.resize_frame(y, u, v, r.width, r.height,
                                             device=sess.device)
                self.scale_ms += (time.perf_counter() - t0) * 1000.0
            else:
                ys, us, vs = y, u, v
            out[i] = sess.encode_frame(ys, us, vs)
            if i == self.donor and self.consumer_sf:
                rec = self.sessions[self.donor].shared_analysis[-1]
                for ci, sf in self.consumer_sf.items():
                    cs = self.sessions[ci]
                    self._feeds[ci].append(
                        scale_analysis_rec(rec, sf, cs.rows, cs.cols))
        return out
