"""ctypes binding for the native C++ CABAC / slice-syntax writer
(`csrc/asuna_native.cpp`, the port's copy of the JAX package's runtime).

Built with g++ on first use into `build/`. A build or load failure raises:
there is no Python fallback writer.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import build

_lib = None


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed); raises on failure."""
    global _lib
    if _lib is None:
        lib = build.load("asuna_native")
        out = [ctypes.c_void_p, ctypes.c_int,
               ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int)]
        extras = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.asuna_encode_intra_slice.restype = ctypes.c_int
        lib.asuna_encode_intra_slice.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + extras
            + [ctypes.c_int] * 2 + out)
        lib.asuna_encode_p_slice.restype = ctypes.c_int
        lib.asuna_encode_p_slice.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + extras + out)
        lib.asuna_encode_b_slice.restype = ctypes.c_int
        lib.asuna_encode_b_slice.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + extras + out)
        lib.asuna_crc16.restype = ctypes.c_uint32
        lib.asuna_crc16.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_uint32]
        lib.asuna_encode_intra_slice_qt64.restype = ctypes.c_int
        lib.asuna_encode_intra_slice_qt64.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + extras + out)
        lib.asuna_encode_slice_qt2.restype = ctypes.c_int
        lib.asuna_encode_slice_qt2.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * len(_QT2_SHAPES)
            + [ctypes.c_int] * 8 + extras + [ctypes.c_void_p, ctypes.c_int]
            + out)
        lib.asuna_encode_slice_qt64.restype = ctypes.c_int
        lib.asuna_encode_slice_qt64.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * (6 + len(_QT2_SHAPES))
            + [ctypes.c_int] * 8 + extras + [ctypes.c_void_p, ctypes.c_int]
            + out)
        lib.asuna_encode_residual_test.restype = ctypes.c_int
        lib.asuna_encode_residual_test.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 4 + out)
        _lib = lib
    return _lib


def _sao_ptr(sao, ncu: int, keep: list):
    """The writer's pointer to per-CTU SAO parameters ([ncu, 18] int32:
    [luma, cb, cr] x [type, aux, o0..o3]), None without SAO."""
    if sao is None:
        return None
    a = np.ascontiguousarray(sao, np.int32)
    if a.shape != (ncu, 18):
        raise ValueError(f"sao: shape {a.shape}, want ({ncu}, 18)")
    keep.append(a)
    return a.ctypes.data


def _qp_ptr(qp_map, ncu: int, keep: list):
    """The writer's pointer to each CTU's QP ([ncu] int32, from a [rows,
    cols] map), None without a QP map (no cu_qp_delta syntax)."""
    if qp_map is None:
        return None
    q = np.ascontiguousarray(np.asarray(qp_map).reshape(-1), np.int32)
    if q.shape != (ncu,):
        raise ValueError(f"qp_map: {q.size} QPs for {ncu} CTUs")
    keep.append(q)
    return q.ctypes.data


def _finish(nbytes: int, out: np.ndarray, tail, tail_bits):
    if nbytes < 0:
        raise RuntimeError("native slice writer: output buffer too small")
    return bytes(out[:nbytes]), int(tail.value), int(tail_bits.value)


def encode_intra_slice(modes: np.ndarray, levels_y: np.ndarray,
                       levels_cb: np.ndarray, levels_cr: np.ndarray,
                       log2cu: int, qp: int, sign_hiding: bool = False,
                       sao=None, qp_map=None, bit_depth: int = 8,
                       lossless: bool = False, chroma444: bool = False):
    """I-slice CABAC data on the uniform CU grid, with each CU's SAO
    parameters when sao ([ncu, 18]) is given (their offsets' range from
    bit_depth) and its cu_qp_delta from qp_map ([rows, cols]) when given;
    sign_hiding leaves out the hidden signs; lossless codes every CU's
    cu_transquant_bypass_flag as 1; chroma444: 4:4:4, the chroma TUs at
    the CU's size. Returns (payload_bytes, tail_value, tail_bits)."""
    lib = load()
    rows, cols = modes.shape
    keep = []
    m = np.ascontiguousarray(modes, np.int32)
    ly = np.ascontiguousarray(levels_y, np.int32)
    lcb = np.ascontiguousarray(levels_cb, np.int32)
    lcr = np.ascontiguousarray(levels_cr, np.int32)
    cap = int(ly.nbytes + lcb.nbytes + lcr.nbytes + 65536)
    out = np.empty(cap, np.uint8)
    tail, tail_bits = ctypes.c_uint32(), ctypes.c_int()
    nbytes = lib.asuna_encode_intra_slice(
        m.ctypes.data, ly.ctypes.data, lcb.ctypes.data, lcr.ctypes.data,
        rows, cols, log2cu, qp,
        1, 1, int(sign_hiding),  # part_mode coded, chroma present
        _sao_ptr(sao, rows * cols, keep), _qp_ptr(qp_map, rows * cols, keep),
        bit_depth, int(lossless), int(chroma444),
        out.ctypes.data, cap, ctypes.byref(tail), ctypes.byref(tail_bits))
    return _finish(nbytes, out, tail, tail_bits)


def encode_p_slice(use_intra: np.ndarray, intra_modes: np.ndarray,
                   mvx_q: np.ndarray, mvy_q: np.ndarray,
                   levels_y: np.ndarray, levels_cb: np.ndarray,
                   levels_cr: np.ndarray, log2cu: int, qp: int,
                   max_merge: int = 3, sign_hiding: bool = False, sao=None,
                   qp_map=None, bit_depth: int = 8):
    """P-slice CABAC data incl. the merge/AMVP/skip signaling decisions
    (and each CU's SAO parameters when sao is given, their offsets' range
    from bit_depth, its cu_qp_delta from qp_map when given; sign_hiding
    leaves out the hidden signs). Returns (payload, tail, tail_bits)."""
    lib = load()
    rows, cols = use_intra.shape
    keep = []
    ui = np.ascontiguousarray(use_intra, np.uint8)
    im = np.ascontiguousarray(intra_modes, np.int32)
    mx = np.ascontiguousarray(mvx_q, np.int32)
    my = np.ascontiguousarray(mvy_q, np.int32)
    ly = np.ascontiguousarray(levels_y, np.int32)
    lcb = np.ascontiguousarray(levels_cb, np.int32)
    lcr = np.ascontiguousarray(levels_cr, np.int32)
    cap = int(ly.nbytes + lcb.nbytes + lcr.nbytes + 65536)
    out = np.empty(cap, np.uint8)
    tail, tail_bits = ctypes.c_uint32(), ctypes.c_int()
    nbytes = lib.asuna_encode_p_slice(
        ui.ctypes.data, im.ctypes.data, mx.ctypes.data, my.ctypes.data,
        ly.ctypes.data, lcb.ctypes.data, lcr.ctypes.data,
        rows, cols, log2cu, qp, max_merge, int(sign_hiding),
        _sao_ptr(sao, rows * cols, keep), _qp_ptr(qp_map, rows * cols, keep),
        bit_depth, out.ctypes.data, cap, ctypes.byref(tail),
        ctypes.byref(tail_bits))
    return _finish(nbytes, out, tail, tail_bits)


def encode_b_slice(use_intra: np.ndarray, intra_modes: np.ndarray,
                   pdir: np.ndarray, mv0x_q: np.ndarray, mv0y_q: np.ndarray,
                   mv1x_q: np.ndarray, mv1y_q: np.ndarray,
                   levels_y: np.ndarray, levels_cb: np.ndarray,
                   levels_cr: np.ndarray, log2cu: int, qp: int,
                   max_merge: int, poc_cur: int, poc_l0: int, poc_l1: int,
                   sign_hiding: bool = False, sao=None, qp_map=None,
                   bit_depth: int = 8):
    """B-slice CABAC data on the uniform CU grid: per CU pdir (1 = L0, 2 =
    L1, 3 = bi) and each list's MV, an unused list's MV zeroed; the
    merge / AMVP / skip decisions with the AMVP candidates scaled by the
    POC distances (poc_cur, poc_l0, poc_l1); each CU's SAO parameters when
    sao ([ncu, 18]) is given (their offsets' range from bit_depth) and its
    cu_qp_delta from qp_map when given; sign_hiding leaves out the hidden
    signs. Returns (payload, tail, tail_bits)."""
    lib = load()
    rows, cols = use_intra.shape
    keep = []
    c = lambda a, dt: np.ascontiguousarray(a, dt)
    arrs = [c(use_intra, np.uint8)] + [
        c(a, np.int32) for a in (intra_modes, pdir, mv0x_q, mv0y_q, mv1x_q,
                                 mv1y_q, levels_y, levels_cb, levels_cr)]
    n = 1 << log2cu
    want = [(rows, cols)] * 7 + [(rows, cols, n, n)] + \
        [(rows, cols, n // 2, n // 2)] * 2
    for i, (a, shp) in enumerate(zip(arrs, want)):
        if a.shape != shp:
            raise ValueError(f"encode_b_slice argument {i}: shape {a.shape}"
                             f", want {shp}")
    cap = int(sum(a.nbytes for a in arrs[-3:]) + 65536)
    out = np.empty(cap, np.uint8)
    tail, tail_bits = ctypes.c_uint32(), ctypes.c_int()
    nbytes = lib.asuna_encode_b_slice(
        *(a.ctypes.data for a in arrs), rows, cols, log2cu, qp, max_merge,
        poc_cur, poc_l0, poc_l1, int(sign_hiding),
        _sao_ptr(sao, rows * cols, keep), _qp_ptr(qp_map, rows * cols, keep),
        bit_depth, out.ctypes.data, cap, ctypes.byref(tail),
        ctypes.byref(tail_bits))
    return _finish(nbytes, out, tail, tail_bits)


def encode_intra_slice_qt64(out: dict, rows: int, cols: int, qp: int,
                            max_depth: int, sign_hiding: bool = False,
                            sao=None, qp_map=None, bit_depth: int = 8):
    """CTU64 intra quadtree slice CABAC data (max_depth 2 or 3) from the
    CTU64 program's decision dict (split32, modes32, split16, modes16,
    modes8, levels_*): the 64x64 CU always splits. sao / qp_map /
    bit_depth / sign_hiding as encode_slice_qt2's. Returns (payload,
    tail, tail_bits)."""
    lib = load()
    keep = []
    shapes = {"split32": (4,), "modes32": (4,), "split16": (4, 4),
              "modes16": (4, 4), "modes8": (4, 4, 4), "levels_y": (64, 64),
              "levels_cb": (32, 32), "levels_cr": (32, 32)}
    args = []
    for key, shp in shapes.items():
        a = np.ascontiguousarray(
            out[key], np.uint8 if key.startswith("split") else np.int32)
        if a.shape != (rows, cols) + shp:
            raise ValueError(f"{key}: shape {a.shape} for a {rows}x{cols} "
                             "CTU64 grid")
        keep.append(a)
        args.append(a.ctypes.data)
    cap = int(sum(a.nbytes for a in keep[-3:]) + 65536)
    buf = np.empty(cap, np.uint8)
    tail, tail_bits = ctypes.c_uint32(), ctypes.c_int()
    nbytes = lib.asuna_encode_intra_slice_qt64(
        *args, rows, cols, qp, max_depth, int(sign_hiding),
        _sao_ptr(sao, rows * cols, keep), _qp_ptr(qp_map, rows * cols, keep),
        bit_depth, buf.ctypes.data, cap, ctypes.byref(tail),
        ctypes.byref(tail_bits))
    return _finish(nbytes, buf, tail, tail_bits)


# decision-dict keys only B slices code, those a P slice codes too (an I
# slice codes neither), and those only depth-2 trees code
_QT2_B = {"pdir", "mv1x", "mv1y", "pdir4", "mv41x", "mv41y", "pdir8",
          "mv81x", "mv81y"}
_QT2_INTER = _QT2_B | {"use_intra", "mvx", "mvy", "use_intra4", "mv4x",
                       "mv4y", "use_intra8", "mv8x", "mv8y"}
_QT2_DEPTH2 = {"split16", "use_intra8", "modes8", "pdir8", "mv8x", "mv8y",
               "mv81x", "mv81y"}
# each array's shape per CTU, in the writer's argument order
_QT2_SHAPES = {"split": (), "split16": (4,), "use_intra": (), "modes": (),
               "pdir": (), "mvx": (), "mvy": (), "mv1x": (), "mv1y": (),
               "use_intra4": (4,), "modes4": (4,), "pdir4": (4,),
               "mv4x": (4,), "mv4y": (4,), "mv41x": (4,), "mv41y": (4,),
               "use_intra8": (4, 4), "modes8": (4, 4), "pdir8": (4, 4),
               "mv8x": (4, 4), "mv8y": (4, 4), "mv81x": (4, 4),
               "mv81y": (4, 4), "levels_y": (32, 32), "levels_cb": (16, 16),
               "levels_cr": (16, 16)}


def _qt2_ptr(out: dict, key: str, rows: int, cols: int, keep: list,
             what: str):
    """The writer's pointer to out[key], of shape (rows, cols) +
    _QT2_SHAPES[key]."""
    if out.get(key) is None:
        raise ValueError(f"{key}: missing from the decision dict of {what}")
    a = np.ascontiguousarray(out[key], np.uint8 if key.startswith(
        ("split", "use_intra")) else np.int32)
    if a.shape != (rows, cols) + _QT2_SHAPES[key]:
        raise ValueError(f"{key}: shape {a.shape} for a {rows}x{cols} CTU "
                         "grid")
    keep.append(a)
    return a.ctypes.data


def _grid_layout(out: dict, rows: int, cols: int) -> dict:
    """out with each _QT2_SHAPES array given CTU-major, as the reference's
    test writers take it ([rows * cols] + shape, or [rows * cols, its
    size]), reshaped to (rows, cols) + shape; other arrays as they are
    (_qt2_ptr then checks them)."""
    res = dict(out)
    for key, shape in _QT2_SHAPES.items():
        if out.get(key) is None:
            continue
        a = np.asarray(out[key])
        if a.shape in ((rows * cols,) + shape,
                       (rows * cols, int(np.prod(shape)))):
            res[key] = a.reshape((rows, cols) + shape)
    return res


def _qt2_args(out: dict, rows: int, cols: int, skip, keep: list,
              slice_type: int) -> list:
    """The pointers of _QT2_SHAPES' arrays in the writers' order, None for
    the keys skip(key) leaves out."""
    return [None if skip(k) else
            _qt2_ptr(out, k, rows, cols, keep,
                     f"a slice of type {slice_type}") for k in _QT2_SHAPES]


def _tu_split_ptr(out: dict, rows: int, cols: int, max_tt: int,
                  keep: list):
    """The pointer to out["tu_split32"] with max_tt >= 1, else None."""
    if max_tt < 1 or out.get("tu_split32") is None:
        return None
    a = np.ascontiguousarray(out["tu_split32"], np.uint8)
    if a.shape != (rows, cols):
        raise ValueError(f"tu_split32: shape {a.shape} for a {rows}x{cols} "
                         "CTU grid")
    keep.append(a)
    return a.ctypes.data


def encode_slice_qt2(slice_type: int, max_depth: int, out: dict, qp: int,
                     max_merge: int = 3, poc: int = 0, poc_l0: int = 0,
                     poc_l1: int = 0, sign_hiding: bool = False, sao=None,
                     qp_map=None, bit_depth: int = 8, max_tt: int = 0):
    """CTU32 quadtree slice CABAC data (slice_type 2 = I, 1 = P, 0 = B;
    depth 1 or 2) from the quadtree programs' decision dict. A B slice
    reads pdir* (1 = L0, 2 = L1, 3 = bi) and the L1 MVs mv1x/mv41x/mv81x
    (and y); poc, poc_l0 and poc_l1 scale its AMVP candidates.
    sign_hiding leaves out the hidden signs. sao: each CTU's SAO parameters
    ([ncu, 18]), coded before the CTU, or None. qp_map: each CTU's QP
    ([rows, cols]; its cu_qp_delta is coded at its first CU with a coded
    cbf), or None. bit_depth: the samples' (the SAO offsets' range).
    max_tt: the SPS's max_transform_hierarchy_depth_inter; at 1 every
    inter CU above 4x4 codes a split_transform_flag, and an unsplit inter
    CU32 whose out["tu_split32"] is set codes four 16x16 TUs (RQT).
    Returns (payload, tail, tail_bits)."""
    if slice_type not in (0, 1, 2):
        raise ValueError(f"slice type {slice_type}: 0 = B, 1 = P, 2 = I")
    lib = load()
    rows, cols = out["split"].shape
    keep = []      # the arrays must outlive the call

    skip = lambda key: (slice_type == 2 and key in _QT2_INTER) or \
        (slice_type == 1 and key in _QT2_B) or \
        (max_depth < 2 and key in _QT2_DEPTH2)
    args = _qt2_args(out, rows, cols, skip, keep, slice_type)
    ts32 = _tu_split_ptr(out, rows, cols, max_tt, keep)
    cap = int(rows * cols * (32 * 32 + 2 * 16 * 16) * 4 + 65536)
    buf = np.empty(cap, np.uint8)
    tail, tail_bits = ctypes.c_uint32(), ctypes.c_int()
    nbytes = lib.asuna_encode_slice_qt2(
        slice_type, max_depth, *args, rows, cols, qp, max_merge, poc,
        poc_l0, poc_l1, int(sign_hiding), _sao_ptr(sao, rows * cols, keep),
        _qp_ptr(qp_map, rows * cols, keep), bit_depth, ts32, int(max_tt),
        buf.ctypes.data, cap, ctypes.byref(tail), ctypes.byref(tail_bits))
    return _finish(nbytes, buf, tail, tail_bits)


def crc16(data: bytes, init: int = 0xffff) -> int:
    """CRC-16 of the decoded-picture-hash SEI (the reference's picyuv.cpp
    updateCRC / crcFinish: poly 0x1021, MSB first, over the bytes, then
    16 zero bits)."""
    arr = np.frombuffer(data, np.uint8)
    crc = load().asuna_crc16(arr.ctypes.data, len(arr), init)
    for _ in range(16):
        msb = (crc >> 15) & 1
        crc = ((crc << 1) & 0xffff) ^ (msb * 0x1021)
    return crc


# the arrays a CTU64 slice needs; without the others the writer takes a
# CU32 inter (use_intra 0, mode DC), 16x16 CUs intra-free, no 8x8 level,
# L0 motion (pdir 1) and zero MVs
_QT64_NEEDS = ("split", "modes4", "levels_y", "levels_cb", "levels_cr")


def encode_slice_qt64(slice_type: int, out: dict, split64, mot64,
                      rows64: int, cols64: int, qp: int,
                      max_merge: int = 3, sign_hiding: bool = False,
                      poc: int = 0, poc_l0: int = 0, poc_l1: int = 0,
                      sao=None, qp_map=None, bit_depth: int = 8,
                      max_tt: int = 0):
    """CTU64 P / B slice CABAC data (slice_type 1 = P, 0 = B; the SPS's CTB
    64, min CB 8): split64 [rows64 * cols64] chooses, per CTU64, one CU64
    (its motion from mot64 = (pdir, mv0x, mv0y, mv1x, mv1y), each
    [rows64 * cols64]; its four TU32s' levels from the four CTU32 slots of
    out) or the four CTU32 trees of out (a depth-2 quadtree decision dict
    in the CTU32 grid of 2 * rows64 x 2 * cols64; arrays missing from it
    take the defaults _QT64_NEEDS names). sao ([n64, 18]) and
    qp_map ([rows64, cols64]) are per CTU64; the rest as for
    encode_slice_qt2. Returns (payload, tail, tail_bits)."""
    if slice_type not in (0, 1):
        raise ValueError(f"slice type {slice_type}: the CTU64 writer codes "
                         "0 = B, 1 = P")
    lib = load()
    rows, cols = out["split"].shape
    if (rows, cols) != (2 * rows64, 2 * cols64):
        raise ValueError(f"a {rows}x{cols} CTU32 grid for {rows64}x{cols64} "
                         "CTU64s")
    n64, keep = rows64 * cols64, []
    out = _grid_layout(out, rows, cols)

    def flat64(a, dt):
        a = np.ascontiguousarray(a, dt).reshape(-1)
        if a.size != n64:
            raise ValueError(f"a CTU64 array of {a.size} for {n64} CTU64s")
        keep.append(a)
        return a.ctypes.data

    head = [flat64(split64, np.uint8)] + [flat64(m, np.int32) for m in mot64]
    args = _qt2_args(out, rows, cols, lambda k: out.get(k) is None and
                     k not in _QT64_NEEDS, keep, slice_type)
    ts32 = _tu_split_ptr(out, rows, cols, max_tt, keep)
    cap = int(rows * cols * (32 * 32 + 2 * 16 * 16) * 4 + 65536)
    buf = np.empty(cap, np.uint8)
    tail, tail_bits = ctypes.c_uint32(), ctypes.c_int()
    nbytes = lib.asuna_encode_slice_qt64(
        slice_type, *head, *args, rows64, cols64, qp, max_merge,
        int(sign_hiding), poc, poc_l0, poc_l1, _sao_ptr(sao, n64, keep),
        _qp_ptr(qp_map, n64, keep), bit_depth, ts32, int(max_tt),
        buf.ctypes.data, cap, ctypes.byref(tail), ctypes.byref(tail_bits))
    return _finish(nbytes, buf, tail, tail_bits)


def encode_intra_slice_qt(split, mode32, modes4, levels_y, levels_cb,
                          levels_cr, qp: int, sign_hiding: bool = False):
    """CTU32 quadtree I slice of depth 1 (one 32x32 CU or four 16x16 CUs a
    CTU): split [rows, cols], mode32 [rows, cols], modes4 [ncu, 4] in
    z-order, levels_y [ncu, 32*32] (a split CTU's 16x16 TUs at their
    places), levels_cb / _cr [ncu, 16*16]. The quadtree writer at depth
    1. Returns (payload, tail, tail_bits)."""
    return encode_slice_qt2(2, 1, _grid_layout({
        "split": split, "modes": mode32, "modes4": modes4,
        "levels_y": levels_y, "levels_cb": levels_cb,
        "levels_cr": levels_cr}, *np.shape(split)), qp,
        sign_hiding=sign_hiding)


def encode_p_slice_qt(split, use_intra32, modes32, mv32x, mv32y,
                      use_intra4, modes4, mv4x, mv4y, levels_y, levels_cb,
                      levels_cr, qp: int, max_merge: int,
                      sign_hiding: bool = False):
    """CTU32 quadtree P slice of depth 1: each CTU's CU32 (use_intra32,
    modes32, mv32x / y [rows, cols]) or its four 16x16 CUs (use_intra4,
    modes4, mv4x / y [ncu, 4], z-order), the levels as for
    encode_intra_slice_qt. The quadtree writer at depth 1. Returns
    (payload, tail, tail_bits)."""
    return encode_slice_qt2(1, 1, _grid_layout({
        "split": split, "use_intra": use_intra32, "modes": modes32,
        "mvx": mv32x, "mvy": mv32y, "use_intra4": use_intra4,
        "modes4": modes4, "mv4x": mv4x, "mv4y": mv4y,
        "levels_y": levels_y, "levels_cb": levels_cb,
        "levels_cr": levels_cr}, *np.shape(split)), qp, max_merge,
        sign_hiding=sign_hiding)


def encode_residual_test(levels: np.ndarray, log2: int, is_luma: bool,
                         intra_mode: int, qp: int):
    """One TU's residual_coding() alone (the I slice's contexts at qp,
    then the terminating bin): levels [2^log2, 2^log2], intra_mode < 0
    for an inter TU. Returns (payload, tail, tail_bits)."""
    lv = np.ascontiguousarray(levels, np.int32)
    cap = lv.nbytes + 4096
    buf = np.empty(cap, np.uint8)
    tail, tail_bits = ctypes.c_uint32(), ctypes.c_int()
    nbytes = load().asuna_encode_residual_test(
        lv.ctypes.data, log2, int(is_luma), intra_mode, qp,
        buf.ctypes.data, cap, ctypes.byref(tail), ctypes.byref(tail_bits))
    return _finish(nbytes, buf, tail, tail_bits)


def pack_sao(sao_params, rows: int, cols: int):
    """Per-CTU SAO parameters as rows of dicts {"luma" | "cb" | "cr":
    (type, aux, [o0..o3])} packed into the writers' [ncu, 18] int32
    ([luma, cb, cr] x [type, aux, o0..o3]); None for None."""
    if sao_params is None:
        return None
    arr = np.zeros((rows * cols, 18), np.int32)
    for r in range(rows):
        for c in range(cols):
            for k, name in enumerate(("luma", "cb", "cr")):
                t, a, offs = sao_params[r][c][name]
                arr[r * cols + c, 6 * k:6 * k + 6] = [t, a, *offs]
    return arr


def unpack_sao(arr, rows: int, cols: int):
    """pack_sao's inverse: [ncu, 18] int32 to rows of dicts."""
    return [[{name: (int(b[6 * k]), int(b[6 * k + 1]),
                     [int(x) for x in b[6 * k + 2:6 * k + 6]])
              for k, name in enumerate(("luma", "cb", "cr"))}
             for b in arr[r * cols:(r + 1) * cols]] for r in range(rows)]
