"""Rate control and adaptive quantization: host copy of
x265_yuuki_asuna_tpu/models/ratecontrol.py (RCConfig, Predictor,
RateControl, StatsWriter, TwoPassRC, compute_aq_offsets).

The frame QP comes from the mode: CQP's configured QP; CRF's complexity
curve qscale = blurred_cost^(1 - qcomp) / rate_factor on the lookahead's
cost; ABR's self-normalising rate factor with the overflow and
sliding-window feedback; each smoothed within x/÷2.2 of the last, I
frames coded finer by the ipFactor offset, then (with VBV) clipped so the
decoder buffer holds over the planned window, and clamped to
qp_min..qp_max. frame_done feeds the coded size back. Everything is
Python float arithmetic in the reference's order (int(round()) rounds
half to even), so every QP and every state attribute equals the JAX
package's; no numpy or torch scalar enters the QP path.

Two-pass: StatsWriter writes the reference's x265_2pass.log text and its
fix8 .cutree sidecar; TwoPassRC reads that format or JSON lines and gives
pass-2 QPs with the overflow feedback and the pass-1 cuTree offsets.

Reference behavior (studied, not copied): encoder/ratecontrol.cpp
(getQScale, tuneAbrQScaleFromFeedback, rateEstimateQscale, clipQscale,
predictSize / updatePredictor, rateControlEnd, the 2-pass stats).
"""

from __future__ import annotations

import json
import math
import os
import re
from dataclasses import dataclass

import numpy as np

QP_TO_QSCALE = lambda qp: 0.85 * (2.0 ** ((qp - 12.0) / 6.0))


def qscale_to_qp(qscale: float) -> float:
    return 12.0 + 6.0 * math.log2(max(qscale, 1e-6) / 0.85)


@dataclass
class RCConfig:
    mode: str = "cqp"            # cqp | crf | abr
    qp: int = 32
    crf: float = 28.0
    bitrate_kbps: int = 0
    fps: float = 25.0
    width: int = 0
    height: int = 0
    q_compress: float = 0.6
    ip_factor: float = 1.4
    qp_min: int = 4
    qp_max: int = 51
    vbv_maxrate_kbps: int = 0    # 0 = VBV off
    vbv_bufsize_kbps: int = 0    # decoder buffer size (kbit)
    vbv_init: float = 0.9        # initial buffer fullness fraction


class Predictor:
    """Linear bits predictor of one slice type, decayed history:
    bits ~= (coeff * var + offset) / (q * count)."""

    def __init__(self, coeff: float = 0.25, count: float = 1.0,
                 offset: float = 0.0, decay: float = 0.5):
        self.coeff = coeff
        self.count = count
        self.offset = offset
        self.decay = decay

    def predict(self, q: float, var: float) -> float:
        return (self.coeff * var + self.offset) / (q * self.count)

    def update(self, q: float, var: float, bits: float):
        if var < 10.0:
            return
        new_coeff = bits * q / var
        new_coeff = min(max(new_coeff, self.coeff / 2.0), self.coeff * 2.0)
        self.count *= self.decay
        self.coeff *= self.decay
        self.count += 1.0
        self.coeff += new_coeff


class RateControl:
    """Frame QPs of a session (frame_qp before each frame, frame_done
    after it). The attributes la_blur (CRF / ABR, from the first
    lookahead cost) and _last_rceq (CRF / ABR) exist only after their
    first use, as in the reference."""

    def __init__(self, cfg: RCConfig):
        self.cfg = cfg
        self.frame = 0
        self.total_bits = 0.0
        self.cplx_sum = 0.0
        self.cplx_count = 0.0
        self.short_term_cplx = 0.0
        self.short_term_count = 0.0
        self.last_qscale = QP_TO_QSCALE(cfg.qp)
        self.pred = {"I": Predictor(), "P": Predictor(), "B": Predictor()}
        self.last_satd = 0.0
        self.window_bits = []     # sliding window of the last 20 frames
        # I-frame amortisation (ABR): 15% of an I frame's bits count at
        # once, the rest over the next 75 frames
        self.amortize_per_frame = 0.0
        self.amortize_left = 0
        if cfg.mode == "abr":
            self.bits_per_frame = cfg.bitrate_kbps * 1000.0 / cfg.fps
            guess_cplx = 0.01 * (cfg.width * cfg.height) ** 1.0 + 1
            self.rate_factor = (guess_cplx ** (1 - cfg.q_compress)) / \
                QP_TO_QSCALE(max(cfg.qp, 1))
            # self-normalising state (cplxrSum / wantedBitsWindow)
            self.cplxr_sum = 0.01 * (7.0e5 ** cfg.q_compress) \
                * ((cfg.width * cfg.height / 256.0) ** 0.5)
            self.wanted_bits_window = 0.01 * self.bits_per_frame
        elif cfg.mode == "crf":
            base_cplx = (cfg.width * cfg.height) / 256.0 * 120.0
            self.rate_factor = (base_cplx ** (1 - cfg.q_compress)) / \
                QP_TO_QSCALE(cfg.crf)
        # the VBV decoder-buffer model
        self.vbv = cfg.vbv_maxrate_kbps > 0 and cfg.vbv_bufsize_kbps > 0
        if self.vbv:
            self.buffer_size = cfg.vbv_bufsize_kbps * 1000.0
            self.buffer_rate = cfg.vbv_maxrate_kbps * 1000.0 / cfg.fps
            self.buffer_fill = self.buffer_size * cfg.vbv_init

    # ------------------------------------------------------------------
    def frame_qp(self, is_intra: bool, lookahead_cost: float = None,
                 future_costs=None) -> int:
        """The next frame's QP. lookahead_cost: its lowres cost (None: the
        coded history stands in); future_costs: the lowres costs of the
        frames planned after it (the VBV clip's window)."""
        cfg = self.cfg
        if lookahead_cost is not None and lookahead_cost > 0:
            self.last_satd = lookahead_cost
        if cfg.mode == "cqp":
            qp = cfg.qp
        else:
            if lookahead_cost is not None and lookahead_cost > 0:
                self.la_blur = getattr(self, "la_blur", lookahead_cost) \
                    * 0.6 + lookahead_cost * 0.4
                cplx = self.la_blur
            elif self.short_term_count > 0:
                cplx = self.short_term_cplx / self.short_term_count
            else:
                cplx = (cfg.width * cfg.height) / 256.0 * 120.0
            rceq = cplx ** (1 - cfg.q_compress)
            if cfg.mode == "abr" and self.cplxr_sum > 0:
                self.rate_factor = self.wanted_bits_window / self.cplxr_sum
            qscale = rceq / self.rate_factor
            self._last_rceq = rceq
            if cfg.mode == "abr" and self.frame > 0:
                wanted = self.bits_per_frame * self.frame
                abr_buffer = 0.5 * self.bits_per_frame \
                    * max(self.frame ** 0.5, 4)
                overflow = 1.0 + (self.total_bits - wanted) / abr_buffer
                overflow = min(max(overflow, 0.5), 2.0)
                if len(self.window_bits) >= 20:
                    wbits = sum(self.window_bits)
                    wwant = self.bits_per_frame * len(self.window_bits)
                    wover = 1.0 + (wbits - wwant) / (2.0 * wwant)
                    overflow = max(overflow, min(max(wover, 0.9), 1.6))
                qscale *= overflow
            qscale = min(max(qscale, self.last_qscale / 2.2),
                         self.last_qscale * 2.2)
            self.last_qscale = qscale
            qp = qscale_to_qp(qscale)
        if is_intra:
            qp -= 6.0 * math.log2(cfg.ip_factor)
        if self.vbv:
            qp = self._clip_qp_vbv(qp, is_intra, future_costs)
        return int(round(min(max(qp, cfg.qp_min), cfg.qp_max)))

    # ------------------------------------------------------------------
    def _predict_bits(self, slice_type: str, qscale: float,
                      var: float) -> float:
        p = self.pred[slice_type]
        return max(p.predict(qscale, max(var, 1.0)), 0.0)

    def _clip_qp_vbv(self, qp: float, is_intra: bool,
                     future_costs=None) -> float:
        """Raise the QP (x1.12 per step, at most 16) until this frame and
        the planned window (up to 8 future costs) keep the decoder buffer
        above its underflow margins; then lower it when even this frame
        would leave the buffer overflowing."""
        cfg = self.cfg
        qscale = QP_TO_QSCALE(qp)
        st = "I" if is_intra else "P"
        use_pred = self.last_satd > 0 and self.frame >= 1

        def predict(q, sat, s):
            if use_pred:
                return self._predict_bits(s, q, sat)
            cplx = (self.short_term_cplx / self.short_term_count
                    if self.short_term_count > 0
                    else (cfg.width * cfg.height) / 256.0
                    * (400.0 if s == "I" else 120.0))
            if s == "I":
                cplx *= cfg.ip_factor * 2.0
            return cplx / q

        sat0 = self.last_satd
        for _ in range(16):
            ok = True
            bits0 = predict(qscale, sat0, st)
            fill = self.buffer_fill - bits0 + self.buffer_rate
            if fill < self.buffer_rate * 0.5:
                ok = False
            elif future_costs:
                f = fill
                for sat in future_costs[:8]:
                    f = f - predict(qscale, sat, "P") + self.buffer_rate
                    f = min(f, self.buffer_size)
                    if f < self.buffer_rate * 0.3:
                        ok = False
                        break
            if ok:
                break
            qscale *= 1.12
        bits_pred = predict(qscale, sat0, st)
        min_bits = self.buffer_fill + self.buffer_rate - self.buffer_size
        if min_bits > 0 and bits_pred < min_bits:
            qscale = max(qscale * bits_pred / min_bits, 1e-6)
        return qscale_to_qp(qscale)

    # ------------------------------------------------------------------
    def vbv_overshoot(self, bits: int) -> float:
        """A coded frame's size over what the decoder buffer can take now
        (> 1: it would underflow; the session then codes it again at a
        higher QP); 0.0 without VBV."""
        if not self.vbv:
            return 0.0
        max_bits = self.buffer_fill + self.buffer_rate * 0.5
        return bits / max(max_bits, 1.0)

    # ------------------------------------------------------------------
    def frame_done(self, qp_used: int, bits: int, slice_type: str = None,
                   satd: float = None):
        """Feed back a coded frame: the complexity history, the slice
        type's bits predictor, ABR's accumulators and the VBV buffer."""
        qscale = QP_TO_QSCALE(qp_used)
        acc_bits = bits
        if self.cfg.mode == "abr":
            if self.amortize_left > 0:
                acc_bits += self.amortize_per_frame
                self.amortize_left -= 1
            if slice_type == "I":
                self.amortize_per_frame += bits * 0.85 / 75.0
                self.amortize_left = 75
                acc_bits -= bits * 0.85
        cplx = bits * qscale
        self.cplx_sum = self.cplx_sum * 0.95 + cplx
        self.cplx_count = self.cplx_count * 0.95 + 1
        self.short_term_cplx = self.short_term_cplx * 0.6 + cplx
        self.short_term_count = self.short_term_count * 0.6 + 1
        self.total_bits += acc_bits
        self.frame += 1
        sat = self.last_satd if satd is None else satd
        if sat > 0:
            self.pred[slice_type or "P"].update(qscale, sat, bits)
        if self.cfg.mode == "abr":
            rceq = getattr(self, "_last_rceq", None)
            if rceq:
                self.cplxr_sum += bits * qscale / rceq
                self.wanted_bits_window += self.bits_per_frame
        self.window_bits.append(bits)
        if len(self.window_bits) > 20:
            self.window_bits.pop(0)
        if self.vbv:
            self.buffer_fill -= bits
            self.buffer_fill = max(self.buffer_fill, 0.0)   # underflow clamp
            self.buffer_fill = min(self.buffer_fill + self.buffer_rate,
                                   self.buffer_size)
        if self.cfg.mode == "abr" and self.frame >= 2:
            # renormalise the rate factor towards the target (slowly)
            cplx_avg = self.cplx_sum / self.cplx_count
            ideal_qscale = (cplx_avg / max(self.bits_per_frame, 1.0))
            want_rf = (cplx_avg ** (1 - self.cfg.q_compress)) / \
                max(ideal_qscale, 1e-6)
            self.rate_factor = 0.9 * self.rate_factor + 0.1 * want_rf


# ---------------------------------------------------------------------------
# two-pass: the reference's x265_2pass.log text (+ the fix8 .cutree
# sidecar) written in pass 1; pass 2 reads it (or JSON lines) and assigns
# bits'_i = cplx_i^qcomp * rf, rf chosen so the total hits the target
# ---------------------------------------------------------------------------

class StatsWriter:
    """Pass-1 stats: '#options: ...' and one 'in:... out:... type:C q:...'
    line per frame, written by close(); with cuTree offsets, the .cutree
    sidecar: per referenced frame one slice-type byte and the offsets x
    256 as little-endian int16."""

    def __init__(self, path: str, options: str = None):
        self.path = path
        self.options = options or ""
        self.records = []

    def add(self, frame_type: str, qp: int, bits: int, cost: float,
            cuoff=None, poc: int = None):
        self.records.append({"type": frame_type, "qp": qp, "bits": bits,
                             "cost": cost, "cuoff": cuoff,
                             "poc": len(self.records) if poc is None
                             else poc})

    def close(self):
        with open(self.path, "w") as f:
            f.write(f"#options: {self.options}\n")
            for i, r in enumerate(self.records):
                q = float(r["qp"])
                f.write(f"in:{r['poc']} out:{i} type:{r['type']} "
                        f"q:{q:.2f} q-aq:{q:.2f} q-noVbv:{q:.2f} "
                        f"q-Rceq:{q:.2f} tex:{r['bits']} mv:0 misc:0 "
                        f"icu:{1.0 if r['type'] == 'I' else 0.0:.2f} "
                        f"pcu:{0.0 if r['type'] == 'I' else 1.0:.2f} "
                        f"scu:0.00 sc:0 ;\n")
        if any(r["cuoff"] is not None for r in self.records):
            with open(self.path + ".cutree", "wb") as f:
                for r in self.records:
                    if r["cuoff"] is None or r["type"] == "b":
                        continue
                    st = {"B": 0, "P": 1, "I": 2, "i": 2, "b": 0}[r["type"]]
                    f.write(bytes([st]))
                    arr = np.round(np.asarray(r["cuoff"], np.float64)
                                   * 256.0)
                    f.write(arr.astype("<i2").tobytes())


class TwoPassRC:
    """Pass-2 QPs from pass-1 stats (x265 text or JSON lines), clamped to
    qp_min..qp_max (the sessions build it with the defaults 4..51)."""

    def __init__(self, stats_path: str, bitrate_kbps: int, fps: float,
                 qp_min: int = 4, qp_max: int = 51):
        with open(stats_path) as f:
            text = f.read()
        self.records = []
        if text.lstrip().startswith("{"):
            for line in text.splitlines():
                if line.strip():
                    self.records.append(json.loads(line))
        else:
            for m in re.finditer(
                    r"in:(-?\d+) out:(-?\d+) type:(\w) q:([0-9.]+) "
                    r"q-aq:([0-9.]+) q-noVbv:([0-9.]+) q-Rceq:([0-9.]+) "
                    r"tex:(\d+) mv:(\d+) misc:(\d+)", text):
                bits = int(m.group(8)) + int(m.group(9)) + int(m.group(10))
                self.records.append({"type": m.group(3),
                                     "qp": float(m.group(4)),
                                     "bits": bits, "cost": 0.0})
            cutree = stats_path + ".cutree"
            if os.path.exists(cutree):
                self._attach_cutree(cutree)
        if not self.records:
            raise ValueError(f"empty/unparseable stats file: {stats_path}")
        qcomp = 0.6
        target_total = bitrate_kbps * 1000.0 / fps * len(self.records)
        cplx = [max(r["bits"], 1.0) * QP_TO_QSCALE(float(r["qp"]))
                for r in self.records]
        denom = sum(c ** qcomp for c in cplx)
        rf = target_total / max(denom, 1e-9)
        for r, c in zip(self.records, cplx):
            qscale = (c ** (1.0 - qcomp)) / max(rf, 1e-9)
            r["qp2"] = qscale_to_qp(qscale)
            r["expected_bits"] = (c ** qcomp) * rf
        self.qp_min, self.qp_max = qp_min, qp_max
        self.idx = 0
        # closed loop: actual against expected bits so far
        self.actual_bits = 0.0
        self.expected_so_far = 0.0

    def _attach_cutree(self, path: str):
        """The .cutree sidecar's offsets onto the referenced frames'
        records (skipped when its size does not fit them)."""
        sz = os.path.getsize(path)
        nref = sum(1 for r in self.records if r["type"] != "b")
        if nref == 0:
            return
        per = (sz - nref) // (2 * nref)
        if per <= 0 or (sz - nref) % (2 * nref):
            return
        with open(path, "rb") as f:
            for r in self.records:
                if r["type"] == "b":
                    continue
                f.read(1)
                raw = np.frombuffer(f.read(2 * per), dtype="<i2")
                r["cuoff"] = (raw.astype(np.float64) / 256.0).tolist()

    def frame_qp(self) -> int:
        r = self.records[min(self.idx, len(self.records) - 1)]
        self.last_record = r
        self.idx += 1
        qp = r["qp2"]
        if self.expected_so_far > 0 and self.actual_bits > 0:
            overflow = self.actual_bits / self.expected_so_far
            overflow = min(max(overflow, 0.5), 2.0)
            qp = qscale_to_qp(QP_TO_QSCALE(qp) * overflow)
        return int(round(min(max(qp, self.qp_min), self.qp_max)))

    def frame_done(self, bits: float):
        """The coded size of the frame the last frame_qp() issued."""
        r = getattr(self, "last_record", None)
        if r is not None:
            self.actual_bits += bits
            self.expected_so_far += r.get("expected_bits", bits)

    def frame_cuoff(self):
        """The pass-1 cuTree offsets (int32, rounded) of the frame the last
        frame_qp() issued, or None."""
        r = getattr(self, "last_record", None)
        if not r or r.get("cuoff") is None:
            return None
        return np.round(np.asarray(r["cuoff"], np.float64)).astype(np.int32)


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
                       v_plane=None, bit_depth: int = 8) -> np.ndarray:
    """Per-CU integer QP offsets [rows, cols] of adaptive quantization
    (the reference's calcAdaptiveQuantFrame, slicetype.cpp:444), with
    bdc = 2^(-2 (bit_depth - 8)) scaling the energies:
      1 variance:         strength * 1.0397 * (log2 max(energy, 1)
                          - (14.427 + 2 (bit_depth - 8)))
      2 auto-variance:    e = (energy bdc + 1)^0.1, s = strength * mean(e),
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
    bdc = 1.0 / (1 << (2 * (bit_depth - 8)))
    if mode in (2, 3, 4):
        if mode == 4:
            edge, theta = _edge_maps(y_plane)
            edens = _block_ac_energy(edge, 16)[:rows16, :cols16]
            # per-16x16 mean angle (findAvgAngle, slicetype.cpp:221)
            ang = (theta[:rows16 * 16, :cols16 * 16]
                   .reshape(rows16, 16, cols16, 16).mean(axis=(1, 3)))
            inclined = (((ang >= 30) & (ang <= 60))
                        | ((ang >= 120) & (ang <= 150)))
            qa = np.where(edens > 0, np.power(edens * bdc + 1.0, 0.1),
                          np.power(energy * bdc + 1.0, 0.1))
            inclined = inclined & (edens > 0)
        else:
            qa = np.power(energy * bdc + 1.0, 0.1)
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
        adj = s * (np.log2(np.maximum(energy, 1.0))
                   - (14.427 + 2.0 * (bit_depth - 8)))
    # the 16x16 grid onto the CU grid (mean)
    f = cu_size // 16
    if f > 1:
        rcu, ccu = rows16 // f, cols16 // f
        adj = adj[:rcu * f, :ccu * f].reshape(rcu, f, ccu, f).mean(
            axis=(1, 3))
    return np.clip(np.round(adj), -qp_range, qp_range).astype(np.int32)
