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
        lib.asuna_encode_slice_qt2.restype = ctypes.c_int
        lib.asuna_encode_slice_qt2.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * len(_QT2_SHAPES)
            + [ctypes.c_int] * 7 + out)
        _lib = lib
    return _lib


def _finish(nbytes: int, out: np.ndarray, tail, tail_bits):
    if nbytes < 0:
        raise RuntimeError("native slice writer: output buffer too small")
    return bytes(out[:nbytes]), int(tail.value), int(tail_bits.value)


def encode_intra_slice(modes: np.ndarray, levels_y: np.ndarray,
                       levels_cb: np.ndarray, levels_cr: np.ndarray,
                       log2cu: int, qp: int):
    """I-slice CABAC data on the uniform CU grid. Returns (payload_bytes,
    tail_value, tail_bits)."""
    lib = load()
    rows, cols = modes.shape
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
        1, 1, 0,                 # part_mode coded, chroma present, no SBH
        None, None, 8,           # no SAO, no QP map, 8-bit
        0, 0,                    # not lossless, 4:2:0
        out.ctypes.data, cap, ctypes.byref(tail), ctypes.byref(tail_bits))
    return _finish(nbytes, out, tail, tail_bits)


def encode_p_slice(use_intra: np.ndarray, intra_modes: np.ndarray,
                   mvx_q: np.ndarray, mvy_q: np.ndarray,
                   levels_y: np.ndarray, levels_cb: np.ndarray,
                   levels_cr: np.ndarray, log2cu: int, qp: int,
                   max_merge: int = 3):
    """P-slice CABAC data incl. the merge/AMVP/skip signaling decisions.
    Returns (payload, tail, tail_bits)."""
    lib = load()
    rows, cols = use_intra.shape
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
        rows, cols, log2cu, qp, max_merge, 0,
        None, None, 8,           # no SAO, no QP map, 8-bit
        out.ctypes.data, cap, ctypes.byref(tail), ctypes.byref(tail_bits))
    return _finish(nbytes, out, tail, tail_bits)


# decision-dict keys only B slices code, those a P slice codes too (an I
# slice codes neither), and those of depth-2 trees
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


def encode_slice_qt2(slice_type: int, max_depth: int, out: dict, qp: int,
                     max_merge: int = 3, poc: int = 0, poc_l0: int = 0,
                     poc_l1: int = 0):
    """CTU32 quadtree slice CABAC data (slice_type 2 = I, 1 = P, 0 = B;
    depth 1 or 2) from the quadtree programs' decision dict. A B slice
    reads pdir* (1 = L0, 2 = L1, 3 = bi) and the L1 MVs mv1x/mv41x/mv81x
    (and y); poc, poc_l0 and poc_l1 scale its AMVP candidates. Returns
    (payload, tail, tail_bits)."""
    if slice_type not in (0, 1, 2):
        raise ValueError(f"slice type {slice_type}: 0 = B, 1 = P, 2 = I")
    lib = load()
    rows, cols = out["split"].shape
    keep = []      # the arrays must outlive the call

    def ptr(key, dt):
        if (slice_type == 2 and key in _QT2_INTER) or \
                (slice_type == 1 and key in _QT2_B) or \
                (max_depth < 2 and key in _QT2_DEPTH2):
            return None
        if out.get(key) is None:
            raise ValueError(f"{key}: missing from the decision dict of a "
                             f"slice of type {slice_type}")
        a = np.ascontiguousarray(out[key], dt)
        if a.shape != (rows, cols) + _QT2_SHAPES[key]:
            raise ValueError(f"{key}: shape {a.shape} for a {rows}x{cols} "
                             "CTU grid")
        keep.append(a)
        return a.ctypes.data

    args = [ptr(k, np.uint8 if k.startswith(("split", "use_intra"))
                else np.int32) for k in _QT2_SHAPES]
    cap = int(rows * cols * (32 * 32 + 2 * 16 * 16) * 4 + 65536)
    buf = np.empty(cap, np.uint8)
    tail, tail_bits = ctypes.c_uint32(), ctypes.c_int()
    nbytes = lib.asuna_encode_slice_qt2(
        slice_type, max_depth, *args, rows, cols, qp, max_merge, poc,
        poc_l0, poc_l1, buf.ctypes.data, cap, ctypes.byref(tail),
        ctypes.byref(tail_bits))
    return _finish(nbytes, buf, tail, tail_bits)
