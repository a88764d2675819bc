"""CABAC context layout, init values, state tables and scan orders
(ITU-T H.265).

The port's copy of x265_yuuki_asuna_tpu/bitstream/tables.py: the
arithmetic coder's state tables (rangeTabLps, Table 9-46; transIdxLps,
Table 9-47), the context layout (CTX_OFFSET), the per-slice-type init
values (Tables 9-5..9-32, rows ordered B, P, I) and their initialisation
(9.3.2.2), the diagonal scans (6.5.3), the last-position groups
(9.3.3.1.2) and the significance context patterns (9.3.4.2.5). All numbers
are spec constants.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# rangeTabLps[pStateIdx][(range >> 6) & 3] (Table 9-46)
LPS_TABLE = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216),
    (123, 150, 178, 205), (116, 142, 169, 195), (111, 135, 160, 185),
    (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158),
    (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99),
    (56, 69, 81, 94), (53, 65, 77, 89), (51, 62, 73, 85), (48, 59, 69, 80),
    (46, 56, 66, 76), (43, 53, 63, 72), (41, 50, 59, 69), (39, 48, 56, 65),
    (37, 45, 54, 62), (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53),
    (30, 37, 43, 50), (29, 35, 41, 48), (27, 33, 39, 45), (26, 31, 37, 43),
    (24, 30, 35, 41), (23, 28, 33, 39), (22, 27, 32, 37), (21, 26, 30, 35),
    (20, 24, 29, 33), (19, 23, 27, 31), (18, 22, 26, 30), (17, 21, 25, 28),
    (16, 20, 23, 27), (15, 19, 22, 25), (14, 18, 21, 24), (14, 17, 20, 23),
    (13, 16, 19, 22), (12, 15, 18, 21), (12, 14, 17, 20), (11, 14, 16, 19),
    (11, 13, 15, 18), (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15),
    (9, 11, 12, 14), (8, 10, 12, 14), (8, 9, 11, 13), (7, 9, 11, 12),
    (7, 9, 10, 12), (7, 8, 10, 11), (6, 8, 9, 11), (6, 7, 9, 10),
    (6, 7, 8, 9), (2, 2, 2, 2))

# transIdxLps (Table 9-47); the MPS transition is min(s + 1, 62), the
# terminal state 63 stays
TRANS_IDX_LPS = (
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63)
TRANS_IDX_MPS = tuple(min(s + 1, 62) for s in range(63)) + (63,)

CNU = 154

_CTX_DEFS = [
    # (name, count, [B init], [P init], [I init])   — spec tables 9-5..9-32
    ("split_cu",        3, [107, 139, 126], [107, 139, 126], [139, 141, 157]),
    ("skip",            3, [197, 185, 201], [197, 185, 201], [CNU, CNU, CNU]),
    ("merge_flag",      1, [154], [110], [CNU]),
    ("merge_idx",       1, [137], [122], [CNU]),
    ("part_size",       4, [154, 139, 154, 154], [154, 139, 154, 154],
     [184, CNU, CNU, CNU]),
    ("pred_mode",       1, [134], [149], [CNU]),
    ("intra_luma",      1, [183], [154], [184]),
    ("intra_chroma",    2, [152, 139], [152, 139], [63, 139]),
    ("delta_qp",        3, [154] * 3, [154] * 3, [154] * 3),
    ("inter_dir",       5, [95, 79, 63, 31, 31], [95, 79, 63, 31, 31],
     [CNU] * 5),
    ("ref_idx",         2, [153, 153], [153, 153], [CNU, CNU]),
    ("mvd",             2, [169, 198], [140, 198], [CNU, CNU]),
    ("qt_cbf",          7, [153, 111, 149, 92, 167, 154, 154],
                           [153, 111, 149, 107, 167, 154, 154],
                           [111, 141, 94, 138, 182, 154, 154]),
    ("trans_subdiv",    3, [224, 167, 122], [124, 138, 94], [153, 138, 138]),
    ("qt_root_cbf",     1, [79], [79], [CNU]),
    ("sig_cg",          4, [121, 140, 61, 154], [121, 140, 61, 154],
     [91, 171, 134, 141]),
    ("sig",            42,
     [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154,
      166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138,
      138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140],
     [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154,
      166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123,
      123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140],
     [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125,
      107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182,
      182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111]),
    ("last_x",         18,
     [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
      108, 123, 93],
     [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
      108, 123, 108],
     [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
      79, 108, 123, 63]),
    ("last_y",         18,
     [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
      108, 123, 93],
     [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
      108, 123, 108],
     [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111,
      79, 108, 123, 63]),
    ("one",            24,
     [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
      136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
     [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
      136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
     [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122,
      152, 140, 179, 166, 182, 140, 227, 122, 197]),
    ("abs",             6, [107, 167, 91, 107, 107, 167],
     [107, 167, 91, 122, 107, 167], [138, 153, 136, 167, 152, 152]),
    ("mvp_idx",         1, [168], [168], [CNU]),
    ("sao_merge",       1, [153], [153], [153]),
    ("sao_type",        1, [160], [185], [200]),
    ("transform_skip",  2, [139, 139], [139, 139], [139, 139]),
    ("tq_bypass",       1, [154], [154], [154]),
]

CTX_OFFSET = {}
_off = 0
for _name, _cnt, _b, _p, _i in _CTX_DEFS:
    CTX_OFFSET[_name] = _off
    _off += _cnt
NUM_CTX = _off

# init values [slice type (0 = B, 1 = P, 2 = I), NUM_CTX]
INIT_ROWS = np.concatenate(
    [np.array([_b, _p, _i], np.int32) for _n, _c, _b, _p, _i in _CTX_DEFS],
    axis=1)



def init_all_contexts(slice_type: int, qp: int) -> bytearray:
    """Spec 9.3.2.2 context init for slice type 0 = B, 1 = P, 2 = I at the
    slice QP: the packed states (pStateIdx << 1) | valMps of every
    context, as a bytearray [NUM_CTX]."""
    iv = INIT_ROWS[slice_type]
    slope = (iv >> 4) * 5 - 45
    offset = ((iv & 15) << 3) - 16
    pre = np.clip(((slope * int(np.clip(qp, 0, 51))) >> 4) + offset, 1, 126)
    return bytearray(np.where(pre <= 63, (63 - pre) << 1,
                              ((pre - 64) << 1) | 1).astype(np.uint8))


SCAN_DIAG = 0
SCAN_HOR = 1
SCAN_VER = 2


def _scan_block(scan_type: int, h: int, w: int) -> np.ndarray:
    """Raster indices of an h x w block in scan order: diagonal up-right
    (spec 6.5.3), horizontal (6.5.4) or vertical (6.5.5)."""
    out = []
    if scan_type == SCAN_HOR:
        out = [y * w + x for y in range(h) for x in range(w)]
    elif scan_type == SCAN_VER:
        out = [y * w + x for x in range(w) for y in range(h)]
    else:
        for d in range(h + w - 1):
            y = min(d, h - 1)
            x = d - y
            while y >= 0 and x < w:
                out.append(y * w + x)
                y -= 1
                x += 1
    return np.array(out, dtype=np.int32)


@lru_cache(maxsize=None)
def scan_order(scan_type: int, log2_size: int) -> np.ndarray:
    """Raster indices in scan order for a 2^n x 2^n block: 4x4 coefficient
    groups in CG scan order, each scanned internally (7.4.9.11)."""
    n = 1 << log2_size
    inner = _scan_block(scan_type, 4, 4)
    if log2_size == 2:
        return inner
    out = []
    for cgi in _scan_block(scan_type, n // 4, n // 4):
        cy, cx = divmod(int(cgi), n // 4)
        base = (cy * 4) * n + cx * 4
        out += [base + (int(p) // 4) * n + int(p) % 4 for p in inner]
    return np.array(out, dtype=np.int32)


@lru_cache(maxsize=None)
def scan_order_cg(scan_type: int, log2_size_cg: int) -> np.ndarray:
    return _scan_block(scan_type, 1 << log2_size_cg, 1 << log2_size_cg)


def _min_in_group(g: int) -> int:
    return g if g < 4 else (2 + (g & 1)) << ((g >> 1) - 1)


# the first position of each last_sig_coeff prefix group (9.3.3.1.2)
MIN_IN_GROUP = np.array([_min_in_group(g) for g in range(10)],
                        dtype=np.int32)

# last_sig_coeff prefix group of each position (9.3.3.1.2)
GROUP_IDX = np.array([max(g for g in range(10) if _min_in_group(g) <= pos)
                      for pos in range(32)], dtype=np.int32)

# sig_coeff_flag context patterns [patternSigCtx][raster pos in the 4x4
# group]; row 4 is the dedicated 4x4 map (9.3.4.2.5)
SIG_CTX_PATTERN = np.array([
    [2, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
    [2, 2, 2, 2, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0],
    [2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0],
    [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8],
], dtype=np.int32)
