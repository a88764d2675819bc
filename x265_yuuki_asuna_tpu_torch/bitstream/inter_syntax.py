"""Inter CU syntax of the uniform 2Nx2N grid (spec 7.3.8.5-7.3.8.9)
through the Python CABAC engine, with the merge and AMVP candidate lists
the decoder derives (8.5.3.2.2-8.5.3.2.8).

Port of the encoder half of x265_yuuki_asuna_tpu/bitstream/inter_syntax.py
cut to the uniform grid: the P side (CUInfo, temporal_candidate,
merge_candidates_ref, amvp_candidates with _scale_mv, encode_ref_idx,
encode_merge_idx, encode_mvd, InterCTUDecision, skip_ctx,
encode_inter_ctu: one or two L0 references, the temporal candidate of
TMVP) and the B side (BMotion, merge_candidates_b, amvp_candidates_b,
BCTUDecision, encode_b_ctu: one reference per list), with the readers of
both sides (decode_inter_ctu, decode_b_ctu and their elements), which
only the tests run. The native writer
codes the one-reference P and B slices; this one serves what it has no
entry for: the P slices with two references or TMVP, and the P / B WPP
substreams. The encoder must signal merge_idx and the MVP flags against
the exact lists a decoder derives, so both are the reference's, line for
line.

Reference behavior (studied, not copied): encoder/entropy.cpp
codePredInfo / codeMvd / codeRefFrmIdx; common/cudata.cpp
getInterMergeCandidates / getPMV / getColMVP.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import tables as T
from .cabac import CabacDecoder, CabacEncoder
from .ctu_syntax import (decode_intra_chroma_mode, decode_intra_luma_mode,
                         derive_mpm, encode_cu_qp_delta,
                         encode_intra_luma_mode)
from .residual import decode_residual, encode_residual

CTX = T.CTX_OFFSET
DC_MODE = 1


@dataclass
class CUInfo:
    """A coded P-slice CU as the decoder sees it."""
    is_intra: bool
    mv: Tuple[int, int] = (0, 0)       # quarter-pel, L0
    intra_mode: int = DC_MODE
    skip: bool = False
    ref: int = 0                       # L0 reference index


def _scale_mv(mv, tb: int, td: int):
    """Spec 8.5.3.2.8 POC-distance motion scaling of mv from a distance td
    to tb."""
    tx = (16384 + (abs(td) >> 1)) // td if td > 0 \
        else -((16384 + (abs(td) >> 1)) // -td)
    dsf = min(max((tb * tx + 32) >> 6, -4096), 4095)

    def s(v):
        val = dsf * v
        sign = 1 if val >= 0 else -1
        return min(max(sign * ((abs(val) + 127) >> 8), -32768), 32767)
    return (s(mv[0]), s(mv[1]))


def temporal_candidate(col, r: int, c: int, target_tb: int):
    """The TMVP candidate of CU (r, c) (spec 8.5.3.2.8 on the uniform
    grid): the bottom-right position lies in the next CTU row, so the
    collocated CU's centre applies, and motion is stored on this grid.
    col: the collocated picture's field {intra, mvx, mvy, ref: [rows,
    cols], ref_deltas: the POC distance of each of its references} or
    None. Returns its MV scaled to the distance target_tb, or None."""
    if col is None or col["intra"][r][c]:
        return None
    mv = (int(col["mvx"][r][c]), int(col["mvy"][r][c]))
    ref = int(col["ref"][r][c]) if col.get("ref") is not None else 0
    td = col["ref_deltas"][ref]
    if td == target_tb:
        return mv
    return _scale_mv(mv, target_tb, td)


def _inter_mi(grid, rr: int, cc: int):
    """(mv, ref) of an inter CU at (rr, cc) of the grid, else None."""
    if 0 <= rr < len(grid) and 0 <= cc < len(grid[0]):
        cu = grid[rr][cc]
        if cu is not None and not cu.is_intra:
            return (cu.mv, cu.ref)
    return None


def merge_candidates_ref(grid, r: int, c: int, max_cands: int,
                         n_refs: int = 1, col=None, ref_deltas=None):
    """The merge list of CU (r, c) as (mv, refIdx) pairs (spec
    8.5.3.2.2-8.5.3.2.4): A1 (left), B1 (above), B0 (above right), B2
    (above left; A0, below left, is not coded yet), each pruned against
    the full motion of the ones the spec names; then the temporal
    candidate at refIdx 0 (not pruned); then zero MVs at refIdx 0 ..
    n_refs - 1, then 0."""
    a1 = _inter_mi(grid, r, c - 1)
    b1 = _inter_mi(grid, r - 1, c)
    b0 = _inter_mi(grid, r - 1, c + 1)
    b2 = _inter_mi(grid, r - 1, c - 1)
    cands = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and b1 != a1:
        cands.append(b1)
    if b0 is not None and b0 != b1:
        cands.append(b0)
    if len(cands) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        cands.append(b2)
    if col is not None and len(cands) < max_cands:
        t = temporal_candidate(col, r, c, (ref_deltas or [1])[0])
        if t is not None:
            cands.append((t, 0))
    zero_idx = 0
    while len(cands) < max_cands:
        cands.append(((0, 0), zero_idx if zero_idx < n_refs else 0))
        zero_idx += 1
    return cands[:max_cands]


def amvp_candidates(grid, r: int, c: int, target_ref: int = 0,
                    ref_deltas=None, col=None) -> List[Tuple[int, int]]:
    """The two AMVP predictors of CU (r, c) for L0 reference target_ref
    (spec 8.5.3.2.7): A from the left CU, its MV scaled when its reference
    differs; B from the first of B0 / B1 / B2 with the same reference;
    without a left CU (isScaledFlag 0) A takes B and B is derived again
    over B0 / B1 / B2 with scaling; equal pair pruned; then the temporal
    candidate while fewer than two; then zeros. ref_deltas: the POC
    distance of each L0 reference (None: one reference, [1])."""
    if ref_deltas is None:
        ref_deltas = [1]
    tb = ref_deltas[target_ref]
    a = _inter_mi(grid, r, c - 1)
    is_scaled = a is not None
    cand_a = None
    if a is not None:
        cand_a = a[0] if a[1] == target_ref \
            else _scale_mv(a[0], tb, ref_deltas[a[1]])
    bs = [_inter_mi(grid, rr, cc)
          for rr, cc in ((r - 1, c + 1), (r - 1, c), (r - 1, c - 1))]
    cand_b = next((mi[0] for mi in bs
                   if mi is not None and mi[1] == target_ref), None)
    if not is_scaled:
        cand_a = cand_b
        cand_b = None
        for mi in bs:
            if mi is not None:
                cand_b = mi[0] if mi[1] == target_ref \
                    else _scale_mv(mi[0], tb, ref_deltas[mi[1]])
                break
    out = []
    if cand_a is not None:
        out.append(cand_a)
    if cand_b is not None and cand_b != cand_a:
        out.append(cand_b)
    if len(out) < 2 and col is not None:
        t = temporal_candidate(col, r, c, tb)
        if t is not None:
            out.append(t)
    while len(out) < 2:
        out.append((0, 0))
    return out[:2]


# ---------------------------------------------------------------------------
# bins
# ---------------------------------------------------------------------------

def encode_ref_idx(enc: CabacEncoder, ref: int, n_refs: int):
    """ref_idx_l0 (truncated rice): two context bins, then bypass bins;
    nothing with one active reference."""
    if n_refs <= 1:
        return
    enc.encode_bin(1 if ref > 0 else 0, CTX["ref_idx"])
    if ref > 0 and n_refs > 2:
        enc.encode_bin(1 if ref > 1 else 0, CTX["ref_idx"] + 1)
        for _ in range(2, ref):
            enc.encode_bin_ep(1)
        if 2 <= ref < n_refs - 1:
            enc.encode_bin_ep(0)


def encode_merge_idx(enc: CabacEncoder, idx: int, max_cands: int):
    """merge_idx: one context bin, then a bypass truncated unary code."""
    if max_cands <= 1:
        return
    enc.encode_bin(1 if idx > 0 else 0, CTX["merge_idx"])
    if idx > 0:
        for _ in range(1, idx):
            enc.encode_bin_ep(1)
        if idx < max_cands - 1:
            enc.encode_bin_ep(0)


def _write_eg1(enc: CabacEncoder, value: int):
    """First-order Exp-Golomb in bypass bins (spec 9.3.3.3)."""
    k = 1
    while value >= (1 << k):
        enc.encode_bin_ep(1)
        value -= 1 << k
        k += 1
    enc.encode_bin_ep(0)
    enc.encode_bins_ep(value, k)


def encode_mvd(enc: CabacEncoder, mvd_x: int, mvd_y: int):
    """mvd_coding (spec 7.3.8.9): greater-than-0 and -1 flags of both
    components, then each one's EG1 remainder and sign."""
    gx0, gy0 = mvd_x != 0, mvd_y != 0
    enc.encode_bin(int(gx0), CTX["mvd"])
    enc.encode_bin(int(gy0), CTX["mvd"])
    if gx0:
        enc.encode_bin(int(abs(mvd_x) > 1), CTX["mvd"] + 1)
    if gy0:
        enc.encode_bin(int(abs(mvd_y) > 1), CTX["mvd"] + 1)
    for v in (mvd_x, mvd_y):
        if v:
            if abs(v) > 1:
                _write_eg1(enc, abs(v) - 2)
            enc.encode_bin_ep(1 if v < 0 else 0)


def _has(levels) -> int:
    return 1 if np.any(levels) else 0


def _residuals(enc, d, log2_cu: int, mode: int, sign_hiding: bool,
               cu_qp_delta, intra: bool):
    """The transform unit of a CU with a coded residual: the chroma cbfs,
    the luma cbf (inferred 1 for an inter CU with neither chroma cbf),
    cu_qp_delta at the first coded cbf, then each coded block."""
    cbf_cb, cbf_cr, cbf_y = (_has(d.cb_levels), _has(d.cr_levels),
                             _has(d.luma_levels))
    enc.encode_bin(cbf_cb, CTX["qt_cbf"] + 2)
    enc.encode_bin(cbf_cr, CTX["qt_cbf"] + 2)
    if intra or cbf_cb or cbf_cr:
        enc.encode_bin(cbf_y, CTX["qt_cbf"] + 1)
    else:
        assert cbf_y, "rqt_root_cbf=1 with no coded cbf"
    if cu_qp_delta is not None and (cbf_y or cbf_cb or cbf_cr):
        encode_cu_qp_delta(enc, cu_qp_delta)
    if cbf_y:
        encode_residual(enc, d.luma_levels, log2_cu, True, mode, sign_hiding)
    for lv, cbf in ((d.cb_levels, cbf_cb), (d.cr_levels, cbf_cr)):
        if cbf:
            encode_residual(enc, lv, log2_cu - 1, False, mode, sign_hiding)


def _intra_cu(enc, d, grid, r: int, c: int, log2_cu: int, sign_hiding: bool,
              cu_qp_delta):
    """An intra CU of an inter slice: 2Nx2N, the luma mode against the
    MPMs of its left neighbour (the CU above is in another CTU: DC), DM
    chroma, its residual."""
    enc.encode_bin(1, CTX["part_size"])
    left = grid[r][c - 1] if c > 0 else None
    cl = left.intra_mode if (left is not None and left.is_intra) else DC_MODE
    encode_intra_luma_mode(enc, d.intra_mode, derive_mpm(cl, DC_MODE))
    enc.encode_bin(0, CTX["intra_chroma"])
    _residuals(enc, d, log2_cu, d.intra_mode, sign_hiding, cu_qp_delta, True)


def skip_ctx(grid, r: int, c: int) -> int:
    """The skip flag's context: how many of the left and above CUs are
    skipped."""
    left = grid[r][c - 1] if c > 0 else None
    above = grid[r - 1][c] if r > 0 else None
    return int(left is not None and left.skip) + \
        int(above is not None and above.skip)



@dataclass
class InterCTUDecision:
    """The signalling of one CU of a P slice."""
    is_intra: bool
    intra_mode: int = DC_MODE
    mv: Tuple[int, int] = (0, 0)
    merge_idx: int = -1            # >= 0: merge with this candidate
    mvp_flag: int = 0              # the AMVP predictor when not merged
    mvd: Tuple[int, int] = (0, 0)
    ref: int = 0                   # L0 reference index
    luma_levels: Optional[np.ndarray] = None
    cb_levels: Optional[np.ndarray] = None
    cr_levels: Optional[np.ndarray] = None

    @property
    def has_residual(self) -> bool:
        return bool(np.any(self.luma_levels) or np.any(self.cb_levels)
                    or np.any(self.cr_levels))


def encode_inter_ctu(enc: CabacEncoder, d: InterCTUDecision, grid, r: int,
                     c: int, log2_cu: int, max_merge: int,
                     sign_hiding: bool = False, cu_qp_delta=None,
                     n_refs: int = 1):
    """coding_unit() of a P slice on the uniform grid: skip (a merge with
    no residual), intra, merge with a residual, or AMVP (ref_idx_l0 with
    n_refs > 1 active references, the MVD, the predictor flag,
    rqt_root_cbf); cu_qp_delta (the delta to signal, or None) goes with
    the first coded cbf. Records the CU in grid[r][c]."""
    is_skip = not d.is_intra and d.merge_idx >= 0 and not d.has_residual
    enc.encode_bin(int(is_skip), CTX["skip"] + skip_ctx(grid, r, c))
    if is_skip:
        encode_merge_idx(enc, d.merge_idx, max_merge)
        grid[r][c] = CUInfo(False, d.mv, skip=True, ref=d.ref)
        return
    enc.encode_bin(int(d.is_intra), CTX["pred_mode"])
    if d.is_intra:
        _intra_cu(enc, d, grid, r, c, log2_cu, sign_hiding, cu_qp_delta)
        grid[r][c] = CUInfo(True, (0, 0), d.intra_mode)
        return
    enc.encode_bin(1, CTX["part_size"])                 # 2Nx2N
    if d.merge_idx >= 0:
        enc.encode_bin(1, CTX["merge_flag"])
        encode_merge_idx(enc, d.merge_idx, max_merge)
        # rqt_root_cbf is inferred 1 for a 2Nx2N merge
        assert d.has_residual, "2Nx2N merge without residual must be skip"
        root = 1
    else:
        enc.encode_bin(0, CTX["merge_flag"])
        encode_ref_idx(enc, d.ref, n_refs)
        encode_mvd(enc, *d.mvd)
        enc.encode_bin(d.mvp_flag, CTX["mvp_idx"])
        root = int(d.has_residual)
        enc.encode_bin(root, CTX["qt_root_cbf"])
    if root:
        _residuals(enc, d, log2_cu, -1, sign_hiding, cu_qp_delta, False)
    grid[r][c] = CUInfo(False, d.mv, skip=False, ref=d.ref)


# ---------------------------------------------------------------------------
# B slices: pdir 1 (L0), 2 (L1) or 3 (bi), one reference per list
# ---------------------------------------------------------------------------

@dataclass
class BMotion:
    dir: int = 1                       # 1 L0, 2 L1, 3 bi
    mv0: Tuple[int, int] = (0, 0)
    mv1: Tuple[int, int] = (0, 0)

    def key(self):
        return (self.dir, self.mv0 if self.dir & 1 else None,
                self.mv1 if self.dir & 2 else None)


@dataclass
class BCUState:
    """A coded B-slice CU as the decoder sees it."""
    is_intra: bool
    motion: Optional[BMotion] = None
    intra_mode: int = DC_MODE
    skip: bool = False


def _b_motion(grid, rr: int, cc: int):
    if 0 <= rr < len(grid) and 0 <= cc < len(grid[0]):
        s = grid[rr][cc]
        if s is not None and not s.is_intra:
            return s.motion
    return None


# the combined bi-predictive candidates' (L0 of, L1 of) index pairs in
# their order (spec 8.5.3.2.3)
_PAIRS = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
          (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))


def merge_candidates_b(grid, r: int, c: int, max_cands: int) \
        -> List[BMotion]:
    """The merge list of a B-slice CU: the spatial candidates pruned on
    their full motion, the combined bi-predictive ones (the two lists'
    pictures always differ; not pruned), then bi zero MVs."""
    a1 = _b_motion(grid, r, c - 1)
    b1 = _b_motion(grid, r - 1, c)
    b0 = _b_motion(grid, r - 1, c + 1)
    b2 = _b_motion(grid, r - 1, c - 1)
    differs = lambda m, o: o is None or m.key() != o.key()
    cands = []
    if a1 is not None:
        cands.append(a1)
    if b1 is not None and differs(b1, a1):
        cands.append(b1)
    if b0 is not None and differs(b0, b1):
        cands.append(b0)
    if len(cands) < 4 and b2 is not None and differs(b2, a1) \
            and differs(b2, b1):
        cands.append(b2)
    n = len(cands)
    for i, j in _PAIRS[:n * (n - 1)]:
        if len(cands) >= max_cands:
            break
        if (cands[i].dir & 1) and (cands[j].dir & 2):
            cands.append(BMotion(3, cands[i].mv0, cands[j].mv1))
    while len(cands) < max_cands:
        cands.append(BMotion(3, (0, 0), (0, 0)))
    return cands[:max_cands]


def amvp_candidates_b(grid, r: int, c: int, lx: int, poc_cur: int,
                      poc_l0: int, poc_l1: int) -> List[Tuple[int, int]]:
    """The two AMVP predictors of list lx of a B-slice CU (one reference
    per list, no temporal candidate): the left CU's unscaled MV (same
    list, or the other list at the same POC), else scaled by the POC
    distances; the first unscaled above MV (B0, B1, B2); without a left
    one, a second, scaled above MV; equal pair pruned; zeros."""
    poc_t = poc_l0 if lx == 0 else poc_l1
    poc_of = lambda w: poc_l0 if w == 0 else poc_l1
    mv_of = lambda m, w: m.mv0 if w == 0 else m.mv1

    def noscale(m):
        if m.dir & (1 << lx):
            return mv_of(m, lx)
        oy = 1 - lx
        if (m.dir & (1 << oy)) and poc_of(oy) == poc_t:
            return mv_of(m, oy)
        return None

    def scaled(m):
        for w in (lx, 1 - lx):
            if m.dir & (1 << w):
                tb, td = poc_cur - poc_t, poc_cur - poc_of(w)
                if td == 0:
                    return None
                return mv_of(m, w) if tb == td \
                    else _scale_mv(mv_of(m, w), tb, td)
        return None

    a1 = _b_motion(grid, r, c - 1)
    cand_a = None
    if a1 is not None:
        cand_a = noscale(a1)
        if cand_a is None:
            cand_a = scaled(a1)
    above = [_b_motion(grid, rr, cc)
             for rr, cc in ((r - 1, c + 1), (r - 1, c), (r - 1, c - 1))]
    out = [] if cand_a is None else [cand_a]
    for m in above:
        v = noscale(m) if m is not None else None
        if v is not None:
            out.append(v)
            break
    if cand_a is None and len(out) < 2:
        for m in above:
            v = scaled(m) if m is not None else None
            if v is not None:
                out.append(v)
                break
    if len(out) == 2 and out[0] == out[1]:
        out.pop()
    while len(out) < 2:
        out.append((0, 0))
    return out[:2]


@dataclass
class BCTUDecision:
    """The signalling of one CU of a B slice."""
    is_intra: bool
    intra_mode: int = DC_MODE
    motion: Optional[BMotion] = None
    merge_idx: int = -1
    mvp_flag0: int = 0
    mvp_flag1: int = 0
    mvd0: Tuple[int, int] = (0, 0)
    mvd1: Tuple[int, int] = (0, 0)
    luma_levels: Optional[np.ndarray] = None
    cb_levels: Optional[np.ndarray] = None
    cr_levels: Optional[np.ndarray] = None

    @property
    def has_residual(self) -> bool:
        return bool(np.any(self.luma_levels) or np.any(self.cb_levels)
                    or np.any(self.cr_levels))


def encode_b_ctu(enc: CabacEncoder, d: BCTUDecision, grid, r: int, c: int,
                 log2_cu: int, max_merge: int, sign_hiding: bool = False,
                 cu_qp_delta=None):
    """coding_unit() of a B slice on the uniform grid: skip, intra, merge
    with a residual, or AMVP (inter_pred_idc, then each used list's MVD
    and predictor flag, rqt_root_cbf). Records the CU in grid[r][c]."""
    is_skip = not d.is_intra and d.merge_idx >= 0 and not d.has_residual
    enc.encode_bin(int(is_skip), CTX["skip"] + skip_ctx(grid, r, c))
    if is_skip:
        encode_merge_idx(enc, d.merge_idx, max_merge)
        grid[r][c] = BCUState(False, d.motion, skip=True)
        return
    enc.encode_bin(int(d.is_intra), CTX["pred_mode"])
    if d.is_intra:
        _intra_cu(enc, d, grid, r, c, log2_cu, sign_hiding, cu_qp_delta)
        grid[r][c] = BCUState(True, None, d.intra_mode)
        return
    enc.encode_bin(1, CTX["part_size"])                 # 2Nx2N
    if d.merge_idx >= 0:
        enc.encode_bin(1, CTX["merge_flag"])
        encode_merge_idx(enc, d.merge_idx, max_merge)
        assert d.has_residual, "residual-less merge must be skip"
        root = 1
    else:
        enc.encode_bin(0, CTX["merge_flag"])
        m = d.motion
        # inter_pred_idc: bi? (context of depth 0), else L1? (context 4)
        enc.encode_bin(int(m.dir == 3), CTX["inter_dir"])
        if m.dir != 3:
            enc.encode_bin(int(m.dir != 1), CTX["inter_dir"] + 4)
        if m.dir & 1:
            encode_mvd(enc, *d.mvd0)
            enc.encode_bin(d.mvp_flag0, CTX["mvp_idx"])
        if m.dir & 2:
            encode_mvd(enc, *d.mvd1)
            enc.encode_bin(d.mvp_flag1, CTX["mvp_idx"])
        root = int(d.has_residual)
        enc.encode_bin(root, CTX["qt_root_cbf"])
    if root:
        _residuals(enc, d, log2_cu, -1, sign_hiding, cu_qp_delta, False)
    grid[r][c] = BCUState(False, d.motion, skip=False)



# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def decode_ref_idx(dec: CabacDecoder, n_refs: int) -> int:
    if n_refs <= 1 or not dec.decode_bin(CTX["ref_idx"]):
        return 0
    if n_refs == 2 or not dec.decode_bin(CTX["ref_idx"] + 1):
        return 1
    ref = 2
    while ref < n_refs - 1 and dec.decode_bin_ep():
        ref += 1
    return ref


def decode_merge_idx(dec: CabacDecoder, max_cands: int) -> int:
    if max_cands <= 1 or not dec.decode_bin(CTX["merge_idx"]):
        return 0
    idx = 1
    while idx < max_cands - 1 and dec.decode_bin_ep():
        idx += 1
    return idx


def _read_eg1(dec: CabacDecoder) -> int:
    k, base = 1, 0
    while dec.decode_bin_ep():
        base += 1 << k
        k += 1
    return base + dec.decode_bins_ep(k)


def decode_mvd(dec: CabacDecoder) -> Tuple[int, int]:
    """mvd_coding() read back: (mvd_x, mvd_y)."""
    gx0 = dec.decode_bin(CTX["mvd"])
    gy0 = dec.decode_bin(CTX["mvd"])
    gx1 = dec.decode_bin(CTX["mvd"] + 1) if gx0 else 0
    gy1 = dec.decode_bin(CTX["mvd"] + 1) if gy0 else 0
    out = []
    for g0, g1 in ((gx0, gx1), (gy0, gy1)):
        if not g0:
            out.append(0)
            continue
        mag = 2 + _read_eg1(dec) if g1 else 1
        out.append(-mag if dec.decode_bin_ep() else mag)
    return out[0], out[1]


def _decode_intra_cu(dec, grid, r: int, c: int, log2_cu: int,
                     sign_hiding: bool):
    """An intra CU of a P or B slice after its pred_mode_flag: (luma mode,
    luma, cb, cr levels); its MPMs take the left CU's mode and DC
    above."""
    if dec.decode_bin(CTX["part_size"]) != 1:
        raise ValueError("an NxN intra partition: the writers code 2Nx2N")
    left = grid[r][c - 1] if c > 0 else None
    cl = left.intra_mode if (left is not None and left.is_intra) else DC_MODE
    mode = decode_intra_luma_mode(dec, derive_mpm(cl, DC_MODE))
    cmode = decode_intra_chroma_mode(dec, mode)
    cbf_cb = dec.decode_bin(CTX["qt_cbf"] + 2)
    cbf_cr = dec.decode_bin(CTX["qt_cbf"] + 2)
    cbf_y = dec.decode_bin(CTX["qt_cbf"] + 1)
    n = 1 << log2_cu
    z = lambda k: np.zeros((k, k), np.int32)
    return (mode,
            decode_residual(dec, log2_cu, True, mode, sign_hiding)
            if cbf_y else z(n),
            decode_residual(dec, log2_cu - 1, False, cmode, sign_hiding)
            if cbf_cb else z(n // 2),
            decode_residual(dec, log2_cu - 1, False, cmode, sign_hiding)
            if cbf_cr else z(n // 2))


def _decode_inter_residual(dec, log2_cu: int, sign_hiding: bool):
    """An inter CU's transform tree of one TU a component (after
    rqt_root_cbf 1): the luma cbf is inferred 1 without a chroma cbf."""
    n = 1 << log2_cu
    z = lambda k: np.zeros((k, k), np.int32)
    cbf_cb = dec.decode_bin(CTX["qt_cbf"] + 2)
    cbf_cr = dec.decode_bin(CTX["qt_cbf"] + 2)
    cbf_y = dec.decode_bin(CTX["qt_cbf"] + 1) if (cbf_cb or cbf_cr) else 1
    return (decode_residual(dec, log2_cu, True, -1, sign_hiding)
            if cbf_y else z(n),
            decode_residual(dec, log2_cu - 1, False, -1, sign_hiding)
            if cbf_cb else z(n // 2),
            decode_residual(dec, log2_cu - 1, False, -1, sign_hiding)
            if cbf_cr else z(n // 2))


def decode_inter_ctu(dec: CabacDecoder, grid, r: int, c: int, log2_cu: int,
                     max_merge: int, sign_hiding: bool = False,
                     n_refs: int = 1, ref_deltas=None, col=None):
    """encode_inter_ctu read back (no cu_qp_delta): (CUInfo, luma, cb, cr
    levels), the CU entered into grid."""
    n = 1 << log2_cu
    z = lambda k: np.zeros((k, k), np.int32)
    if dec.decode_bin(CTX["skip"] + skip_ctx(grid, r, c)):
        idx = decode_merge_idx(dec, max_merge)
        mv, ref = merge_candidates_ref(grid, r, c, max_merge, n_refs,
                                       col=col, ref_deltas=ref_deltas)[idx]
        grid[r][c] = CUInfo(False, mv, skip=True, ref=ref)
        return grid[r][c], z(n), z(n // 2), z(n // 2)
    if dec.decode_bin(CTX["pred_mode"]):
        mode, ly, cb, cr = _decode_intra_cu(dec, grid, r, c, log2_cu,
                                            sign_hiding)
        grid[r][c] = CUInfo(True, (0, 0), mode)
        return grid[r][c], ly, cb, cr
    if dec.decode_bin(CTX["part_size"]) != 1:
        raise ValueError("an inter partition other than 2Nx2N")
    if dec.decode_bin(CTX["merge_flag"]):
        idx = decode_merge_idx(dec, max_merge)
        mv, ref = merge_candidates_ref(grid, r, c, max_merge, n_refs,
                                       col=col, ref_deltas=ref_deltas)[idx]
        rqt_root_cbf = 1
    else:
        ref = decode_ref_idx(dec, n_refs)
        mvd = decode_mvd(dec)
        mvp = dec.decode_bin(CTX["mvp_idx"])
        pred = amvp_candidates(grid, r, c, target_ref=ref,
                               ref_deltas=ref_deltas, col=col)[mvp]
        mv = (pred[0] + mvd[0], pred[1] + mvd[1])
        rqt_root_cbf = dec.decode_bin(CTX["qt_root_cbf"])
    ly, cb, cr = _decode_inter_residual(dec, log2_cu, sign_hiding) \
        if rqt_root_cbf else (z(n), z(n // 2), z(n // 2))
    grid[r][c] = CUInfo(False, mv, skip=False, ref=ref)
    return grid[r][c], ly, cb, cr


def decode_b_ctu(dec: CabacDecoder, grid, r: int, c: int, log2_cu: int,
                 max_merge: int, poc_cur: int, poc_l0: int, poc_l1: int,
                 sign_hiding: bool = False):
    """encode_b_ctu read back (no cu_qp_delta): (BCUState, luma, cb, cr
    levels), the CU entered into grid."""
    n = 1 << log2_cu
    z = lambda k: np.zeros((k, k), np.int32)
    if dec.decode_bin(CTX["skip"] + skip_ctx(grid, r, c)):
        idx = decode_merge_idx(dec, max_merge)
        grid[r][c] = BCUState(False, merge_candidates_b(grid, r, c,
                                                        max_merge)[idx],
                              skip=True)
        return grid[r][c], z(n), z(n // 2), z(n // 2)
    if dec.decode_bin(CTX["pred_mode"]):
        mode, ly, cb, cr = _decode_intra_cu(dec, grid, r, c, log2_cu,
                                            sign_hiding)
        grid[r][c] = BCUState(True, None, mode)
        return grid[r][c], ly, cb, cr
    if dec.decode_bin(CTX["part_size"]) != 1:
        raise ValueError("an inter partition other than 2Nx2N")
    if dec.decode_bin(CTX["merge_flag"]):
        idx = decode_merge_idx(dec, max_merge)
        motion = merge_candidates_b(grid, r, c, max_merge)[idx]
        rqt = 1
    else:
        if dec.decode_bin(CTX["inter_dir"] + 0):
            dirv = 3
        else:
            dirv = 2 if dec.decode_bin(CTX["inter_dir"] + 4) else 1
        mvs = [(0, 0), (0, 0)]
        for lx in (0, 1):
            if dirv & (1 << lx):
                mvd = decode_mvd(dec)
                f = dec.decode_bin(CTX["mvp_idx"])
                pred = amvp_candidates_b(grid, r, c, lx, poc_cur, poc_l0,
                                         poc_l1)[f]
                mvs[lx] = (pred[0] + mvd[0], pred[1] + mvd[1])
        motion = BMotion(dirv, mvs[0], mvs[1])
        rqt = dec.decode_bin(CTX["qt_root_cbf"])
    ly, cb, cr = _decode_inter_residual(dec, log2_cu, sign_hiding) \
        if rqt else (z(n), z(n // 2), z(n // 2))
    grid[r][c] = BCUState(False, motion, skip=False)
    return grid[r][c], ly, cb, cr
