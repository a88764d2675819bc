"""Rate control, CQP mode, and adaptive quantization: host copy of the
part of x265_yuuki_asuna_tpu/models/ratecontrol.py that a CQP session
runs (RateControl, compute_aq_offsets).

The frame QP is the configured QP, I frames coded finer by the reference's
ipFactor offset (qpConstant[I] = qp - 6*log2(ipFactor), applied in every
mode incl. CQP). The history counters are updated after each frame exactly
as the JAX package's RateControl.frame_done does, so a session's state
carries over; CRF / ABR / VBV belong to a later slice.
"""

from __future__ import annotations

import math

import numpy as np

QP_TO_QSCALE = lambda qp: 0.85 * (2.0 ** ((qp - 12.0) / 6.0))
IP_FACTOR = 1.4
QP_MIN, QP_MAX = 4, 51


class RateControl:
    def __init__(self, qp: int):
        self.qp = qp
        self.frame = 0
        self.total_bits = 0.0
        self.cplx_sum = 0.0
        self.cplx_count = 0.0
        self.short_term_cplx = 0.0
        self.short_term_count = 0.0
        self.last_qscale = QP_TO_QSCALE(qp)
        self.last_satd = 0.0
        self.window_bits = []     # sliding window of the last 20 frames

    def frame_qp(self, is_intra: bool, lookahead_cost: float = None) -> int:
        if lookahead_cost is not None and lookahead_cost > 0:
            self.last_satd = lookahead_cost
        qp = float(self.qp)
        if is_intra:
            qp -= 6.0 * math.log2(IP_FACTOR)
        return int(round(min(max(qp, QP_MIN), QP_MAX)))

    def frame_done(self, qp_used: int, bits: int):
        cplx = bits * QP_TO_QSCALE(qp_used)
        self.cplx_sum = self.cplx_sum * 0.95 + cplx
        self.cplx_count = self.cplx_count * 0.95 + 1
        self.short_term_cplx = self.short_term_cplx * 0.6 + cplx
        self.short_term_count = self.short_term_count * 0.6 + 1
        self.total_bits += bits
        self.frame += 1
        self.window_bits.append(bits)
        if len(self.window_bits) > 20:
            self.window_bits.pop(0)


# ---------------------------------------------------------------------------
# adaptive quantization: per-CU QP offsets from the source's AC energy
# (numpy on the host, float64, in the reference's exact order: its rounding
# of half-way offsets must be reproduced)
# ---------------------------------------------------------------------------

def _block_ac_energy(plane, bsz: int) -> np.ndarray:
    """Per-block AC energy: ssd - sum^2 >> shift (the reference's
    acEnergyVar, slicetype.cpp:49), integer, returned as float64."""
    H, W = plane.shape
    rows, cols = H // bsz, W // bsz
    blocks = (plane[:rows * bsz, :cols * bsz]
              .reshape(rows, bsz, cols, bsz).astype(np.int64))
    s = blocks.sum(axis=(1, 3))
    ssd = (blocks * blocks).sum(axis=(1, 3))
    shift = 2 * (bsz.bit_length() - 1)
    return (ssd - ((s * s) >> shift)).astype(np.float64)


def _ac_energy_cu(y, u, v) -> np.ndarray:
    """AC energy of each 16x16 luma block, plus the co-sited 8x8 chroma
    blocks' when u is given (reference acEnergyCu, slicetype.cpp:256)."""
    e = _block_ac_energy(y, 16)
    if u is not None:
        e = e + _block_ac_energy(u, 8) + _block_ac_energy(v, 8)
    return e


def _edge_maps(y):
    """Gaussian blur, then a Scharr-like gradient (reference edgeFilter /
    computeEdge, slicetype.cpp:151,100): (edge bitmap at the reference's
    whitePixel 255, per-pixel angle in degrees 0..180)."""
    src = y.astype(np.float64)
    H, W = src.shape
    # 5x5 Gaussian, 1/159 kernel (slicetype.cpp:183-209)
    k = np.array([[2, 4, 5, 4, 2], [4, 9, 12, 9, 4], [5, 12, 15, 12, 5],
                  [4, 9, 12, 9, 4], [2, 4, 5, 4, 2]], np.float64)
    pad = np.pad(src, 2, mode="edge")
    sm = np.zeros_like(src)
    for dy in range(5):
        for dx in range(5):
            sm += k[dy, dx] * pad[dy:dy + H, dx:dx + W]
    ref = np.floor(sm / 159.0)
    # the two-sample border keeps the source
    ref[:2, :] = src[:2, :]
    ref[-2:, :] = src[-2:, :]
    ref[:, :2] = src[:, :2]
    ref[:, -2:] = src[:, -2:]
    p = np.pad(ref, 1, mode="edge")
    gh = (-3 * p[:-2, :-2] + 3 * p[:-2, 2:]
          - 10 * p[1:-1, :-2] + 10 * p[1:-1, 2:]
          - 3 * p[2:, :-2] + 3 * p[2:, 2:])
    gv = (-3 * p[:-2, :-2] - 10 * p[:-2, 1:-1] - 3 * p[:-2, 2:]
          + 3 * p[2:, :-2] + 10 * p[2:, 1:-1] + 3 * p[2:, 2:])
    mag = np.sqrt(gh * gh + gv * gv)
    theta = np.degrees(np.arctan2(gv, gh))
    theta = np.where(theta < 0, 180.0 + theta, theta)
    edge = np.where(mag >= 255.0, 255.0, 0.0)
    edge[:1, :] = 0
    edge[-1:, :] = 0
    edge[:, :1] = 0
    edge[:, -1:] = 0
    return edge, theta


def compute_aq_offsets(y_plane, cu_size: int, strength: float = 1.0,
                       qp_range: int = 6, mode: int = 2, u_plane=None,
                       v_plane=None) -> np.ndarray:
    """Per-CU integer QP offsets [rows, cols] of adaptive quantization,
    8-bit (the reference's calcAdaptiveQuantFrame, slicetype.cpp:444):
      1 variance:         strength * 1.0397 * (log2 max(energy, 1) - 14.427)
      2 auto-variance:    e = (energy + 1)^0.1, s = strength * mean(e),
                          adj = s * (e - (mean - 0.5 * (mean_sq - 11) / mean))
      3 auto-var-biased:  mode 2 + strength * (1 - 11 / e^2)
      4 edge:             mode 2 on the edge density where a block has
                          edges, (s + 0.5) on inclined (30-60 / 120-150
                          degree) blocks above the mean.
    The 16x16 offsets average onto the CU grid; u_plane / v_plane add the
    chroma energies."""
    H, W = y_plane.shape
    rows16, cols16 = H // 16, W // 16
    if rows16 == 0 or cols16 == 0:
        return np.zeros((max(H // cu_size, 1), max(W // cu_size, 1)),
                        np.int32)
    energy = _ac_energy_cu(y_plane, u_plane, v_plane)[:rows16, :cols16]
    if mode in (2, 3, 4):
        if mode == 4:
            edge, theta = _edge_maps(y_plane)
            edens = _block_ac_energy(edge, 16)[:rows16, :cols16]
            # per-16x16 mean angle (findAvgAngle, slicetype.cpp:221)
            ang = (theta[:rows16 * 16, :cols16 * 16]
                   .reshape(rows16, 16, cols16, 16).mean(axis=(1, 3)))
            inclined = (((ang >= 30) & (ang <= 60))
                        | ((ang >= 120) & (ang <= 150)))
            qa = np.where(edens > 0, np.power(edens + 1.0, 0.1),
                          np.power(energy + 1.0, 0.1))
            inclined = inclined & (edens > 0)
        else:
            qa = np.power(energy + 1.0, 0.1)
            inclined = None
        avg = qa.mean()
        avg_pow2 = (qa * qa).mean()
        s = strength * avg
        avg_adj = avg - 0.5 * (avg_pow2 - 11.0) / max(avg, 1e-9)
        adj = s * (qa - avg_adj)
        if mode == 3:
            adj = adj + strength * (1.0 - 11.0 / np.maximum(qa * qa, 1e-9))
        if mode == 4:
            adj = np.where(inclined & (qa - avg_adj > 0),
                           (s + 0.5) * (qa - avg_adj), adj)
    else:
        s = strength * 1.0397
        adj = s * (np.log2(np.maximum(energy, 1.0)) - 14.427)
    # the 16x16 grid onto the CU grid (mean)
    f = cu_size // 16
    if f > 1:
        rcu, ccu = rows16 // f, cols16 // f
        adj = adj[:rcu * f, :ccu * f].reshape(rcu, f, ccu, f).mean(
            axis=(1, 3))
    return np.clip(np.round(adj), -qp_range, qp_range).astype(np.int32)
