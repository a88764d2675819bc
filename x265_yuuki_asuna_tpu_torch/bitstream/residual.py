"""residual_coding() syntax: the entropy coding of one TU's levels
(spec 7.3.8.11, 9.3.4.2.5-9.3.4.2.7), through the Python CABAC engine.

Port of x265_yuuki_asuna_tpu/bitstream/residual.py (`encode_residual`,
and its reader `decode_residual`, which only the tests run). The native
writer (`native.py`) codes the same syntax for the sessions' slices;
this one serves the WPP substreams.
Levels come as a dense signed int array [N, N] in raster order.

Reference behavior (studied, not copied): encoder/entropy.cpp
codeCoeffNxN, common/quant.h context helpers.
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from .cabac import CabacDecoder, CabacEncoder

C1FLAG_NUMBER = 8
C2FLAG_NUMBER = 1
COEF_REMAIN_BIN_REDUCTION = 3
SBH_THRESHOLD = 4

# context sub-offsets within our layout
CTX = T.CTX_OFFSET


def select_scan(log2_size: int, is_luma: bool, intra_mode: int):
    """Mode-dependent coefficient scan of 4:2:0 (cudata.cpp
    getTUEntropyCodingParameters): intra luma TUs up to 8x8 and chroma
    TUs of 4x4 scan horizontally for modes 22-30, vertically for 6-14.
    intra_mode < 0 means inter (always diagonal)."""
    if intra_mode >= 0:
        if log2_size <= (3 if is_luma else 2):
            if 22 <= intra_mode <= 30:
                return T.SCAN_HOR
            if 6 <= intra_mode <= 14:
                return T.SCAN_VER
    return T.SCAN_DIAG


def first_sig_map_ctx(log2_size: int, is_luma: bool, scan_type: int) -> int:
    if log2_size == 2:
        return 0
    if log2_size == 3:
        return 15 if (scan_type != T.SCAN_DIAG and is_luma) else 9
    return 21 if is_luma else 12


def _pattern_sig_ctx(cg_flags: np.ndarray, cgx: int, cgy: int,
                     ncg: int) -> int:
    right = int(cg_flags[cgy, cgx + 1]) if cgx + 1 < ncg else 0
    below = int(cg_flags[cgy + 1, cgx]) if cgy + 1 < ncg else 0
    return right + 2 * below


def _cg_ctx(cg_flags: np.ndarray, cgx: int, cgy: int, ncg: int) -> int:
    right = int(cg_flags[cgy, cgx + 1]) if cgx + 1 < ncg else 0
    below = int(cg_flags[cgy + 1, cgx]) if cgy + 1 < ncg else 0
    return right | below


def _sig_ctx(log2_size, is_luma, pattern, blk_pos, first_ctx, n):
    """sig_coeff_flag ctxInc (9.3.4.2.5), as a delta into luma/chroma bank."""
    x, y = blk_pos & (n - 1), blk_pos >> log2_size
    if log2_size == 2:
        return int(T.SIG_CTX_PATTERN[4][(y << 2) | x])
    if blk_pos == 0:
        return 0
    xp, yp = x & 3, y & 3
    cnt = int(T.SIG_CTX_PATTERN[pattern][(yp << 2) | xp])
    in_first_cg = (x < 4 and y < 4)
    offset = cnt + first_ctx + (3 if (is_luma and not in_first_cg) else 0)
    return offset


def encode_residual(enc: CabacEncoder, levels: np.ndarray, log2_size: int,
                    is_luma: bool, intra_mode: int, sign_hiding: bool = False):
    """Encode one TU's quantized levels (raster [N, N], signed int)."""
    n = 1 << log2_size
    flat = levels.reshape(-1)
    scan_type = select_scan(log2_size, is_luma, intra_mode)
    scan = T.scan_order(scan_type, log2_size)
    ncg = max(1, n >> 2)
    cg_scan = T.scan_order_cg(scan_type, max(0, log2_size - 2))
    first_ctx = first_sig_map_ctx(log2_size, is_luma, scan_type)

    vals = flat[scan]
    nz = np.nonzero(vals)[0]
    assert len(nz), "encode_residual called with all-zero TU"
    last_scan_pos = int(nz[-1])
    pos_last = int(scan[last_scan_pos])

    # CG nonzero map
    cg_flags = np.zeros((ncg, ncg), dtype=np.int32)
    for sp in nz:
        p = int(scan[sp])
        cg_flags[(p >> log2_size) >> 2, (p & (n - 1)) >> 2] = 1

    # ---- last position ----
    lx, ly = pos_last & (n - 1), pos_last >> log2_size
    if scan_type == T.SCAN_VER:
        lx, ly = ly, lx
    max_group = (log2_size << 1) - 1
    if is_luma:
        off = 3 * (log2_size - 2) + (1 if log2_size == 5 else 0)
        ctx_base_x = CTX["last_x"] + off
        ctx_base_y = CTX["last_y"] + off
        shift = (log2_size + 1) >> 2
    else:
        ctx_base_x = CTX["last_x"] + 15
        ctx_base_y = CTX["last_y"] + 15
        shift = log2_size - 2
    suffix_bits = 0
    suffix_len = 0
    for pos, base in ((lx, ctx_base_x), (ly, ctx_base_y)):
        g = int(T.GROUP_IDX[pos])
        for i in range(g):
            enc.encode_bin(1, base + (i >> shift))
        if g < max_group:
            enc.encode_bin(0, base + (g >> shift))
        if g > 3:
            sl = (g >> 1) - 1
            suffix_bits = (suffix_bits << sl) | (pos & ((1 << sl) - 1))
            suffix_len += sl
    if suffix_len:
        enc.encode_bins_ep(suffix_bits, suffix_len)

    # ---- per-CG coding, reverse scan ----
    last_cg = last_scan_pos >> 4
    sig_bank = CTX["sig"] + (0 if is_luma else 27)
    cg_bank = CTX["sig_cg"] + (0 if is_luma else 2)
    one_bank = CTX["one"] + (0 if is_luma else 16)
    abs_bank = CTX["abs"] + (0 if is_luma else 4)

    c1 = 1
    for cg in range(last_cg, -1, -1):
        cg_blk = int(cg_scan[cg]) if ncg > 1 else 0
        cgy, cgx = divmod(cg_blk, ncg)
        in_cg = vals[cg * 16:(cg + 1) * 16]
        nz_in_cg = np.nonzero(in_cg)[0]
        num_nz = len(nz_in_cg)

        if cg == last_cg or cg == 0:
            # csbf inferred 1: sig flags are coded even if the CG is empty
            cg_flags[cgy, cgx] = 1
        else:
            ctx = _cg_ctx(cg_flags, cgx, cgy, ncg)
            enc.encode_bin(1 if num_nz else 0, cg_bank + ctx)
            if not num_nz:
                continue

        pattern = _pattern_sig_ctx(cg_flags, cgx, cgy, ncg) if ncg > 1 else 0

        # significant_coeff_flag (skip the last coeff itself)
        start = 15 if cg < last_cg else (last_scan_pos & 15) - 1
        coded_any = 1 if cg == last_cg else 0
        for k in range(start, -1, -1):
            sp = cg * 16 + k
            sig = 1 if vals[sp] else 0
            # inferSbDcSigCoeffFlag: DC of an explicitly-signaled CG with no
            # other nonzero is inferred significant
            if k == 0 and cg > 0 and cg != last_cg and coded_any == 0:
                break
            ctx = _sig_ctx(log2_size, is_luma, pattern, int(scan[sp]),
                           first_ctx, n)
            enc.encode_bin(sig, sig_bank + ctx)
            coded_any += sig

        if num_nz == 0:     # inferred-significant CG that is actually empty
            continue

        # level data (reverse scan order within CG)
        abs_vals = np.abs(in_cg[nz_in_cg])[::-1].astype(int)
        signs = (in_cg[nz_in_cg] < 0).astype(int)[::-1]
        first_nz = int(nz_in_cg[0])
        last_nz = int(nz_in_cg[-1])
        hide = sign_hiding and (last_nz - first_nz >= SBH_THRESHOLD)

        ctx_set = (2 if (cg > 0 and is_luma) else 0) + (0 if (c1 & 3) else 1)
        c1 = 1
        base1 = one_bank + 4 * ctx_set
        num_c1 = min(num_nz, C1FLAG_NUMBER)
        first_c2 = -1
        for i in range(num_c1):
            sym = 1 if abs_vals[i] > 1 else 0
            enc.encode_bin(sym, base1 + c1)
            if sym:
                c1 = 0
                if first_c2 < 0:
                    first_c2 = i
            elif 0 < c1 < 3:
                c1 += 1
        if c1 == 0 and first_c2 >= 0:
            enc.encode_bin(1 if abs_vals[first_c2] > 2 else 0,
                           abs_bank + ctx_set)

        # signs (reverse-scan order; hidden sign is the coefficient closest
        # to DC, which is last in our reversed arrays)
        sign_bits = 0
        nsign = num_nz - (1 if hide else 0)
        for i in range(nsign):
            sign_bits = (sign_bits << 1) | int(signs[i])
        if nsign:
            enc.encode_bins_ep(sign_bits, nsign)

        # remaining levels
        if c1 == 0 or num_nz > C1FLAG_NUMBER:
            go_rice = 0
            threshold = COEF_REMAIN_BIN_REDUCTION
            first_coeff2 = 1
            for i in range(first_c2 if first_c2 >= 0 else 0, num_nz):
                if first_c2 < 0 and i < C1FLAG_NUMBER:
                    continue
                base_level = (2 + first_coeff2) if i < C1FLAG_NUMBER else 1
                if abs_vals[i] >= base_level:
                    _write_remain(enc, int(abs_vals[i]) - base_level, go_rice)
                    if abs_vals[i] > threshold and go_rice <= 3:
                        go_rice += 1
                        threshold <<= 1
                if i >= (first_c2 if first_c2 >= 0 else 0):
                    first_coeff2 = 0


def _write_remain(enc: CabacEncoder, code: int, rice: int):
    """coeff_abs_level_remaining Golomb-Rice (entropy.cpp:1470 behavior)."""
    if (code >> rice) < COEF_REMAIN_BIN_REDUCTION:
        length = code >> rice
        enc.encode_bins_ep((((1 << (length + 1)) - 2) << rice) +
                           (code & ((1 << rice) - 1)), length + 1 + rice)
    else:
        cn = (code >> rice) - COEF_REMAIN_BIN_REDUCTION
        length = (cn + 1).bit_length() - 1
        cn -= (1 << length) - 1
        cn = (cn << rice) + (code & ((1 << rice) - 1))
        enc.encode_bins_ep((1 << (COEF_REMAIN_BIN_REDUCTION + length + 1)) - 2,
                           COEF_REMAIN_BIN_REDUCTION + length + 1)
        enc.encode_bins_ep(cn, length + rice)


def decode_residual(dec: CabacDecoder, log2_size: int, is_luma: bool,
                    intra_mode: int, sign_hiding: bool = False) -> np.ndarray:
    """One TU's residual_coding() read back: the levels [N, N] int32 in
    raster order (encode_residual's inverse, the hidden sign taken from
    the parity of the group's level sum)."""
    n = 1 << log2_size
    out = np.zeros(n * n, dtype=np.int32)
    scan_type = select_scan(log2_size, is_luma, intra_mode)
    scan = T.scan_order(scan_type, log2_size)
    ncg = max(1, n >> 2)
    cg_scan = T.scan_order_cg(scan_type, max(0, log2_size - 2))
    first_ctx = first_sig_map_ctx(log2_size, is_luma, scan_type)

    max_group = (log2_size << 1) - 1
    if is_luma:
        off = 3 * (log2_size - 2) + (1 if log2_size == 5 else 0)
        ctx_base_x, ctx_base_y = CTX["last_x"] + off, CTX["last_y"] + off
        shift = (log2_size + 1) >> 2
    else:
        ctx_base_x, ctx_base_y = CTX["last_x"] + 15, CTX["last_y"] + 15
        shift = log2_size - 2

    def read_last(base):
        g = 0
        while g < max_group and dec.decode_bin(base + (g >> shift)):
            g += 1
        return g

    gx, gy = read_last(ctx_base_x), read_last(ctx_base_y)
    lx, ly = int(T.MIN_IN_GROUP[gx]), int(T.MIN_IN_GROUP[gy])
    if gx > 3:
        lx += dec.decode_bins_ep((gx >> 1) - 1)
    if gy > 3:
        ly += dec.decode_bins_ep((gy >> 1) - 1)
    if scan_type == T.SCAN_VER:
        lx, ly = ly, lx
    pos_last = (ly << log2_size) | lx
    last_scan_pos = int(np.nonzero(scan == pos_last)[0][0])

    sig_bank = CTX["sig"] + (0 if is_luma else 27)
    cg_bank = CTX["sig_cg"] + (0 if is_luma else 2)
    one_bank = CTX["one"] + (0 if is_luma else 16)
    abs_bank = CTX["abs"] + (0 if is_luma else 4)

    last_cg = last_scan_pos >> 4
    cg_flags = np.zeros((ncg, ncg), dtype=np.int32)
    c1 = 1
    for cg in range(last_cg, -1, -1):
        cgy, cgx = divmod(int(cg_scan[cg]) if ncg > 1 else 0, ncg)
        if cg == last_cg or cg == 0:
            csbf = 1
        else:
            csbf = dec.decode_bin(cg_bank + _cg_ctx(cg_flags, cgx, cgy, ncg))
        cg_flags[cgy, cgx] = csbf
        if not csbf:
            continue
        pattern = _pattern_sig_ctx(cg_flags, cgx, cgy, ncg) if ncg > 1 else 0
        # significant flags, in descending scan position k
        sig_pos = []
        if cg == last_cg:
            sig_pos.append(last_scan_pos & 15)
            start = (last_scan_pos & 15) - 1
        else:
            start = 15
        for k in range(start, -1, -1):
            if k == 0 and cg > 0 and cg != last_cg and not sig_pos:
                sig_pos.append(0)            # the inferred DC
                break
            ctx = _sig_ctx(log2_size, is_luma, pattern,
                           int(scan[cg * 16 + k]), first_ctx, n)
            if dec.decode_bin(sig_bank + ctx):
                sig_pos.append(k)
        num_nz = len(sig_pos)
        if num_nz == 0:
            continue
        ctx_set = (2 if (cg > 0 and is_luma) else 0) + (0 if (c1 & 3) else 1)
        c1 = 1
        base1 = one_bank + 4 * ctx_set
        gt1 = [0] * num_nz
        first_c2 = -1
        for i in range(min(num_nz, C1FLAG_NUMBER)):
            sym = dec.decode_bin(base1 + c1)
            gt1[i] = sym
            if sym:
                c1 = 0
                if first_c2 < 0:
                    first_c2 = i
            elif 0 < c1 < 3:
                c1 += 1
        gt2 = dec.decode_bin(abs_bank + ctx_set) \
            if c1 == 0 and first_c2 >= 0 else 0
        hide = sign_hiding and (sig_pos[0] - sig_pos[-1] >= SBH_THRESHOLD)
        signs = [dec.decode_bins_ep(1)
                 for _ in range(num_nz - (1 if hide else 0))]
        # the levels the flags imply; coeff_abs_level_remaining wherever
        # the writer coded one
        lv = [1 + (gt1[i] if i < C1FLAG_NUMBER else 0)
              + (gt2 if i == first_c2 else 0) for i in range(num_nz)]
        if c1 == 0 or num_nz > C1FLAG_NUMBER:
            rice, threshold, first_coeff2 = 0, COEF_REMAIN_BIN_REDUCTION, 1
            for i in range(first_c2 if first_c2 >= 0 else 0, num_nz):
                if first_c2 < 0 and i < C1FLAG_NUMBER:
                    continue
                if i < C1FLAG_NUMBER:
                    base = 2 + first_coeff2
                    coded = gt1[i] == 1 and (i != first_c2 or gt2 == 1)
                else:
                    base, coded = 1, True
                if coded:
                    lv[i] = base + _read_remain(dec, rice)
                    if lv[i] > threshold and rice <= 3:
                        rice += 1
                        threshold <<= 1
                first_coeff2 = 0
        for i, k in enumerate(sig_pos):
            p = int(scan[cg * 16 + k])
            neg = (sum(lv) & 1) if hide and i == num_nz - 1 else signs[i]
            out[p] = -lv[i] if neg else lv[i]
    return out.reshape(n, n)


def _read_remain(dec: CabacDecoder, rice: int) -> int:
    """coeff_abs_level_remaining (9.3.3.11): a unary prefix, then rice
    bits, or past COEF_REMAIN_BIN_REDUCTION an Exp-Golomb escape."""
    prefix = 0
    while prefix < 32 and dec.decode_bins_ep(1):
        prefix += 1
    if prefix < COEF_REMAIN_BIN_REDUCTION:
        return (prefix << rice) + (dec.decode_bins_ep(rice) if rice else 0)
    length = prefix - COEF_REMAIN_BIN_REDUCTION
    val = dec.decode_bins_ep(length + rice)
    return (((1 << length) - 1 + COEF_REMAIN_BIN_REDUCTION) << rice) + val
