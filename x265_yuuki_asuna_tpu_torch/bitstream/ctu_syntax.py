"""CTU-level slice-data syntax of intra CUs (spec 7.3.8.x) through the
Python CABAC engine: the intra modes, the transform tree of one TU per
component, SAO parameters and cu_qp_delta.

Port of x265_yuuki_asuna_tpu/bitstream/ctu_syntax.py (derive_mpm,
encode_intra_luma_mode, encode_intra_chroma_mode, encode_intra_ctu_full,
encode_sao_ctu, encode_cu_qp_delta, and their readers decode_*, which
only the tests run), 4:2:0 only.
SAO parameters come in the port's packed form: one CTU's [18] int row,
[luma, cb, cr] x [type, aux, o0..o3] (ops/sao.py). The native writer
codes the same syntax for the sessions' slices; this one serves the WPP
substreams.

Reference behavior (studied, not copied): encoder/entropy.cpp encodeCTU /
codeIntraDirLumaAng / codeIntraDirChroma / codeTransformUnit / codeSaoCtu
/ codeDeltaQP.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from . import tables as T
from .cabac import CabacDecoder, CabacEncoder
from .residual import decode_residual, encode_residual

CTX = T.CTX_OFFSET
DC_MODE = 1
PLANAR_MODE = 0
VER_MODE = 26


def derive_mpm(cand_left: int, cand_above: int) -> List[int]:
    """Spec 8.4.2 most-probable-mode list. Unavailable neighbors must be
    passed as DC (1)."""
    a, b = cand_left, cand_above
    if a == b:
        if a < 2:
            return [PLANAR_MODE, DC_MODE, VER_MODE]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    mpm = [a, b]
    if PLANAR_MODE not in mpm:
        mpm.append(PLANAR_MODE)
    elif DC_MODE not in mpm:
        mpm.append(DC_MODE)
    else:
        mpm.append(VER_MODE)
    return mpm


def encode_intra_luma_mode(enc: CabacEncoder, mode: int, mpm: List[int]):
    if mode in mpm:
        enc.encode_bin(1, CTX["intra_luma"])
        idx = mpm.index(mode)
        enc.encode_bin_ep(0 if idx == 0 else 1)
        if idx:
            enc.encode_bin_ep(idx - 1)
    else:
        enc.encode_bin(0, CTX["intra_luma"])
        rem = mode
        for m in sorted(mpm, reverse=True):
            if rem > m:
                rem -= 1
        enc.encode_bins_ep(rem, 5)


def decode_intra_luma_mode(dec: CabacDecoder, mpm: List[int]) -> int:
    if dec.decode_bin(CTX["intra_luma"]):
        idx = 0
        if dec.decode_bin_ep():
            idx = 1 + dec.decode_bin_ep()
        return mpm[idx]
    rem = dec.decode_bins_ep(5)
    for m in sorted(mpm):
        if rem >= m:
            rem += 1
    return rem


def encode_intra_chroma_mode(enc: CabacEncoder, chroma_mode: int,
                             luma_mode: int):
    """DM (derived from luma) is the single bin 0; otherwise bin 1 + 2
    bypass bits indexing {planar, ver, hor, dc} with 34 substituted for
    the luma mode."""
    if chroma_mode == luma_mode:
        enc.encode_bin(0, CTX["intra_chroma"])
        return
    allowed = [PLANAR_MODE, VER_MODE, 10, DC_MODE]
    table = [(34 if m == luma_mode else m) for m in allowed]
    idx = table.index(chroma_mode)
    enc.encode_bin(1, CTX["intra_chroma"])
    enc.encode_bins_ep(idx, 2)


def decode_intra_chroma_mode(dec: CabacDecoder, luma_mode: int) -> int:
    if not dec.decode_bin(CTX["intra_chroma"]):
        return luma_mode
    allowed = [PLANAR_MODE, VER_MODE, 10, DC_MODE]
    m = allowed[dec.decode_bins_ep(2)]
    return 34 if m == luma_mode else m


@dataclass
class CTUDecisions:
    """One intra CU's decisions: its luma mode (chroma takes DM) and the
    levels of its luma TU [N, N] and chroma TUs [N/2, N/2]."""
    luma_mode: int
    luma_levels: np.ndarray
    cb_levels: np.ndarray
    cr_levels: np.ndarray


def encode_intra_ctu_full(enc: CabacEncoder, d: CTUDecisions, log2_cu: int,
                          cand_left: int, cand_above: int,
                          part_mode_coded: bool = True,
                          sign_hiding: bool = False,
                          tq_bypass: bool = False,
                          bypass_enabled: bool = False,
                          cu_qp_delta=None):
    """coding_unit() of an intra 2Nx2N CU with one TU per component:
    cu_transquant_bypass_flag (when the PPS enables it), part_mode (when
    coded), the luma mode against the MPMs of cand_left / cand_above,
    DM chroma, the cbfs, cu_qp_delta (when given and a cbf is set) and
    the residuals."""
    if bypass_enabled:
        enc.encode_bin(1 if tq_bypass else 0, CTX["tq_bypass"])
    if part_mode_coded:
        enc.encode_bin(1, CTX["part_size"])   # PART_2Nx2N
    encode_intra_luma_mode(enc, d.luma_mode, derive_mpm(cand_left,
                                                        cand_above))
    encode_intra_chroma_mode(enc, d.luma_mode, d.luma_mode)   # DM chroma

    cbf_luma = 1 if np.any(d.luma_levels) else 0
    cbf_cb = 1 if np.any(d.cb_levels) else 0
    cbf_cr = 1 if np.any(d.cr_levels) else 0
    # transform_tree depth 0: the chroma cbfs, then the luma cbf (always
    # coded for intra)
    enc.encode_bin(cbf_cb, CTX["qt_cbf"] + 2)
    enc.encode_bin(cbf_cr, CTX["qt_cbf"] + 2)
    enc.encode_bin(cbf_luma, CTX["qt_cbf"] + 1)

    if cu_qp_delta is not None and (cbf_luma or cbf_cb or cbf_cr):
        encode_cu_qp_delta(enc, cu_qp_delta)
    if cbf_luma:
        encode_residual(enc, d.luma_levels, log2_cu, True, d.luma_mode,
                        sign_hiding)
    if cbf_cb:
        encode_residual(enc, d.cb_levels, log2_cu - 1, False, d.luma_mode,
                        sign_hiding)
    if cbf_cr:
        encode_residual(enc, d.cr_levels, log2_cu - 1, False, d.luma_mode,
                        sign_hiding)


def decode_intra_ctu_full(dec: CabacDecoder, log2_cu: int, cand_left: int,
                          cand_above: int, part_mode_coded: bool = True,
                          sign_hiding: bool = False,
                          bypass_enabled: bool = False,
                          qp_delta_enabled: bool = False):
    """encode_intra_ctu_full read back: (luma mode, chroma mode, luma
    levels [N, N], Cb and Cr levels [N/2, N/2]); cu_qp_delta is read (and
    dropped) when qp_delta_enabled and a cbf is set."""
    if bypass_enabled:
        dec.decode_bin(CTX["tq_bypass"])
    if part_mode_coded and dec.decode_bin(CTX["part_size"]) != 1:
        raise ValueError("an NxN intra partition: the writers code 2Nx2N")
    luma_mode = decode_intra_luma_mode(dec, derive_mpm(cand_left,
                                                       cand_above))
    chroma_mode = decode_intra_chroma_mode(dec, luma_mode)
    n = 1 << log2_cu
    cbf_cb = dec.decode_bin(CTX["qt_cbf"] + 2)
    cbf_cr = dec.decode_bin(CTX["qt_cbf"] + 2)
    cbf_luma = dec.decode_bin(CTX["qt_cbf"] + 1)
    if qp_delta_enabled and (cbf_luma or cbf_cb or cbf_cr):
        decode_cu_qp_delta(dec)
    z = lambda k: np.zeros((k, k), np.int32)
    luma = decode_residual(dec, log2_cu, True, luma_mode, sign_hiding) \
        if cbf_luma else z(n)
    cb = decode_residual(dec, log2_cu - 1, False, chroma_mode,
                         sign_hiding) if cbf_cb else z(n // 2)
    cr = decode_residual(dec, log2_cu - 1, False, chroma_mode,
                         sign_hiding) if cbf_cr else z(n // 2)
    return luma_mode, chroma_mode, luma, cb, cr


# ---------------------------------------------------------------------------
# SAO (spec 7.3.8.3): one CTU's packed row [luma, cb, cr] x [type, aux,
# o0..o3]; type 0 off, 1 band offset (aux: band position), 2 edge offset
# (aux: EO class, Cr's taken from Cb's)
# ---------------------------------------------------------------------------

SAO_OFF, SAO_BO, SAO_EO = 0, 1, 2


def _enc_offsets_abs(enc, offs, cmax):
    for o in offs:
        a = abs(int(o))
        for _ in range(a):
            enc.encode_bin_ep(1)
        if a < cmax:
            enc.encode_bin_ep(0)


def _enc_type(enc, t):
    enc.encode_bin(0 if t == SAO_OFF else 1, CTX["sao_type"])
    if t != SAO_OFF:
        enc.encode_bin_ep(1 if t == SAO_EO else 0)


def encode_sao_ctu(enc: CabacEncoder, params, left_params, up_params,
                   bit_depth: int = 8):
    """sao() of one CTU with luma and chroma SAO on: merge-left /
    merge-up against the neighbours' rows (None where outside the
    slice), else each group's type and offsets."""
    cmax = (1 << (min(bit_depth, 10) - 5)) - 1
    p = [int(x) for x in params]
    for nb in (left_params, up_params):
        if nb is not None:
            merge = p == [int(x) for x in nb]
            enc.encode_bin(1 if merge else 0, CTX["sao_merge"])
            if merge:
                return
    for group in ((0,), (1, 2)):             # luma; cb with cr
        t = p[6 * group[0]]
        _enc_type(enc, t)
        if t == SAO_OFF:
            continue
        for k in group:
            typ, aux, offs = p[6 * k], p[6 * k + 1], p[6 * k + 2:6 * k + 6]
            _enc_offsets_abs(enc, offs, cmax)
            if typ == SAO_BO:
                for o in offs:
                    if o != 0:
                        enc.encode_bin_ep(1 if o < 0 else 0)
                enc.encode_bins_ep(aux, 5)
            elif k < 2:
                enc.encode_bins_ep(aux, 2)   # eo_class (cr inherits cb's)


def _dec_offsets_abs(dec, cmax):
    out = []
    for _ in range(4):
        a = 0
        while a < cmax and dec.decode_bin_ep():
            a += 1
        out.append(a)
    return out


def _dec_type(dec):
    if not dec.decode_bin(CTX["sao_type"]):
        return SAO_OFF
    return SAO_EO if dec.decode_bin_ep() else SAO_BO


def decode_sao_ctu(dec: CabacDecoder, left_params, up_params,
                   bit_depth: int = 8):
    """encode_sao_ctu read back: the CTU's packed row [18] (a merged
    neighbour's row copied; edge offsets' signs inferred, positive for
    categories 1 and 2)."""
    cmax = (1 << (min(bit_depth, 10) - 5)) - 1
    for nb in (left_params, up_params):
        if nb is not None and dec.decode_bin(CTX["sao_merge"]):
            return [int(x) for x in nb]
    p = [0] * 18
    for group in ((0,), (1, 2)):             # luma; cb with cr
        t = _dec_type(dec)
        if t == SAO_OFF:
            continue
        for k in group:
            a = _dec_offsets_abs(dec, cmax)
            if t == SAO_BO:
                offs = [-x if x and dec.decode_bin_ep() else x for x in a]
                aux = dec.decode_bins_ep(5)
            else:
                aux = dec.decode_bins_ep(2) if k < 2 else p[7]
                offs = [a[0], a[1], -a[2], -a[3]]
            p[6 * k:6 * k + 6] = [t, aux, *offs]
    return p


def encode_cu_qp_delta(enc: CabacEncoder, delta: int):
    """cu_qp_delta_abs (spec 9.3.3.10: TU prefix of cMax 5, context bin 0
    then bins 1+, EG0 bypass suffix) and its sign."""
    a = abs(delta)
    prefix = min(a, 5)
    for i in range(prefix):
        enc.encode_bin(1, CTX["delta_qp"] + (0 if i == 0 else 1))
    if prefix < 5:
        enc.encode_bin(0, CTX["delta_qp"] + (0 if prefix == 0 else 1))
    else:
        v = a - 5
        k = 0
        while v >= (1 << k):
            enc.encode_bin_ep(1)
            v -= 1 << k
            k += 1
        enc.encode_bin_ep(0)
        if k:
            enc.encode_bins_ep(v, k)
    if a:
        enc.encode_bin_ep(1 if delta < 0 else 0)


def decode_cu_qp_delta(dec: CabacDecoder) -> int:
    """encode_cu_qp_delta read back: the signed delta."""
    prefix = 0
    while prefix < 5 and dec.decode_bin(
            CTX["delta_qp"] + (0 if prefix == 0 else 1)):
        prefix += 1
    a = prefix
    if prefix == 5:
        k, base = 0, 0
        while dec.decode_bin_ep():
            base += 1 << k
            k += 1
        a = 5 + base + (dec.decode_bins_ep(k) if k else 0)
    return -a if a and dec.decode_bin_ep() else a
