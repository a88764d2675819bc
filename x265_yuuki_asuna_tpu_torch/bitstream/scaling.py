"""Quantization scaling lists (HEVC 7.3.4 scaling_list_data).

Port of x265_yuuki_asuna_tpu/bitstream/scaling.py: the spec's default
matrices (H.265 tables 7-5 / 7-6), ScalingListData (default, from_file
in the x265 / HM file format, the upsampled matrices, is_default and
quant_tables) and write_scaling_list_data. Four sizes (4x4..32x32) x six
lists (intra / inter x Y / Cb / Cr); matrices above 8x8 are signalled at
8x8 granularity plus a DC coefficient and upsampled by repetition.

Reference behavior (studied, not copied): common/scalinglist.cpp
(parseScalingList, processScalingListEnc / Dec), encoder/entropy.cpp
codeScalingList.
"""

from __future__ import annotations

import numpy as np

# H.265 table 7-5/7-6 default matrices
FLAT_4x4 = np.full(16, 16, np.int32)

DEFAULT_INTRA_8x8 = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], np.int32)

DEFAULT_INTER_8x8 = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], np.int32)

NUM_SIZES = 4      # 4x4, 8x8, 16x16, 32x32
NUM_LISTS = 6      # intra Y/Cb/Cr, inter Y/Cb/Cr

MATRIX_NAMES = [
    ["INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV",
     "INTER4X4_LUMA", "INTER4X4_CHROMAU", "INTER4X4_CHROMAV"],
    ["INTRA8X8_LUMA", "INTRA8X8_CHROMAU", "INTRA8X8_CHROMAV",
     "INTER8X8_LUMA", "INTER8X8_CHROMAU", "INTER8X8_CHROMAV"],
    ["INTRA16X16_LUMA", "INTRA16X16_CHROMAU", "INTRA16X16_CHROMAV",
     "INTER16X16_LUMA", "INTER16X16_CHROMAU", "INTER16X16_CHROMAV"],
    ["INTRA32X32_LUMA", "", "", "INTER32X32_LUMA", "", ""],
]
DC_NAMES = [
    None, None,
    ["INTRA16X16_LUMA_DC", "INTRA16X16_CHROMAU_DC", "INTRA16X16_CHROMAV_DC",
     "INTER16X16_LUMA_DC", "INTER16X16_CHROMAU_DC", "INTER16X16_CHROMAV_DC"],
    ["INTRA32X32_LUMA_DC", "", "", "INTER32X32_LUMA_DC", "", ""],
]


def plain_diag_scan(n: int) -> np.ndarray:
    """Up-right diagonal scan over the whole n x n matrix (6.5.3) — used by
    scaling_list_data (NOT the CG-based residual scan)."""
    order = []
    for d in range(2 * n - 1):
        for x in range(max(0, d - n + 1), min(d, n - 1) + 1):
            order.append((d - x) * n + x)
    return np.asarray(order, np.int32)


def default_coef(size_id: int, list_id: int) -> np.ndarray:
    """The spec's default list at signaling granularity (16 or 64 values)."""
    if size_id == 0:
        return FLAT_4x4.copy()
    return (DEFAULT_INTRA_8x8 if list_id < 3 else DEFAULT_INTER_8x8).copy()


class ScalingListData:
    """Holds coef[size][list] at signaling granularity + dc[size][list]."""

    def __init__(self):
        self.coef = [[default_coef(s, l) for l in range(NUM_LISTS)]
                     for s in range(NUM_SIZES)]
        self.dc = [[16] * NUM_LISTS for _ in range(NUM_SIZES)]

    # -- construction --------------------------------------------------
    @classmethod
    def default(cls) -> "ScalingListData":
        return cls()

    @classmethod
    def from_file(cls, path: str) -> "ScalingListData":
        """Parse the x265/HM scaling list file format: a MATRIX_NAMES header
        line followed by comma-separated values (parseScalingList,
        scalinglist.cpp)."""
        sld = cls()
        with open(path) as f:
            text = f.read()
        toks = text.replace(",", " ").split()
        for s in range(NUM_SIZES):
            count = 16 if s == 0 else 64
            step = 3 if s == 3 else 1
            for l in range(0, NUM_LISTS, step):
                name = MATRIX_NAMES[s][l]
                try:
                    i = toks.index(name)
                except ValueError:
                    raise ValueError(
                        f"scaling list file missing {name}") from None
                vals = [int(x) for x in toks[i + 1:i + 1 + count]]
                sld.coef[s][l] = np.asarray(vals, np.int32)
                sld.dc[s][l] = vals[0]
                if s >= 2:
                    dcn = DC_NAMES[s][l]
                    j = toks.index(dcn)
                    sld.dc[s][l] = int(toks[j + 1])
                if s == 3:       # 32x32 chroma inherits luma (not signaled)
                    for k in (1, 2):
                        sld.coef[s][l + k] = sld.coef[s][l].copy()
                        sld.dc[s][l + k] = sld.dc[s][l]
        return sld

    # -- derived matrices ----------------------------------------------
    def matrix(self, log2_size: int, list_id: int) -> np.ndarray:
        """Full NxN matrix m (int32): repetition-upsampled from the 8x8
        signal with the DC override (processScalingListDec)."""
        size_id = log2_size - 2
        n = 1 << log2_size
        g = 4 if size_id == 0 else 8
        src = self.coef[size_id][list_id].reshape(g, g)
        ratio = n // g
        m = np.repeat(np.repeat(src, ratio, axis=0), ratio, axis=1)
        if ratio > 1:
            m[0, 0] = self.dc[size_id][list_id]
        return m.astype(np.int32)

    def is_default(self, size_id: int, list_id: int) -> bool:
        return (np.array_equal(self.coef[size_id][list_id],
                               default_coef(size_id, list_id))
                and (size_id < 2 or self.dc[size_id][list_id] == 16))

    # -- quant/dequant tables (encoder side) ----------------------------
    def quant_tables(self, log2_size: int, list_id: int):
        """Returns (qtab [6,N,N], dqtab [6,N,N]) int32:
        qtab = (QUANT_SCALES[rem] << 4) // m ; dqtab = INV_SCALES[rem] * m
        (processScalingListEnc/Dec, scalinglist.cpp:378-380)."""
        from ..ops.quant import QUANT_SCALES, INV_QUANT_SCALES
        m = self.matrix(log2_size, list_id)
        q = np.stack([(int(QUANT_SCALES[r]) << 4) // m for r in range(6)])
        dq = np.stack([int(INV_QUANT_SCALES[r]) * m for r in range(6)])
        return q.astype(np.int32), dq.astype(np.int32)


def write_scaling_list_data(bw, sld: ScalingListData):
    """scaling_list_data() syntax (7.3.4), matching the reference's
    codeScalingList (entropy.cpp:501)."""
    for size_id in range(NUM_SIZES):
        step = 3 if size_id == 3 else 1
        for list_id in range(0, NUM_LISTS, step):
            use_default = sld.is_default(size_id, list_id)
            bw.write_flag(0 if use_default else 1)  # scaling_list_pred_mode
            if use_default:
                bw.write_ue(0)                      # pred_matrix_id_delta
                continue
            coef_num = 16 if size_id == 0 else 64
            n = 4 if size_id == 0 else 8
            scan = plain_diag_scan(n)
            src = sld.coef[size_id][list_id]
            next_coef = 8
            if size_id > 1:
                bw.write_se(sld.dc[size_id][list_id] - 8)
                next_coef = sld.dc[size_id][list_id]
            for i in range(coef_num):
                d = int(src[scan[i]]) - next_coef
                if d < -128:
                    d += 256
                if d > 127:
                    d -= 256
                next_coef = (next_coef + d + 256) % 256
                bw.write_se(d)
