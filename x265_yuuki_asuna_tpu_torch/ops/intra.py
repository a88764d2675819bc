"""HEVC intra prediction: all 35 modes at once as one matrix product.

Port of x265_yuuki_asuna_tpu/ops/intra.py (substitute_references,
filter_references, allangs_matrix, predict_all_modes_matmul,
predict_mode_matmul). Spec: ITU-T H.265 sec 8.4.4.2 (reference
substitution, [1 2 1] smoothing, planar/DC/angular prediction, boundary
filters). Reference behavior (studied, not copied): common/intrapred.cpp.

Reference sample layout ("v vector"):
    v[k], k in [0, 4N]:  k=0..2N-1   -> left[2N-1-k]   (bottom-left .. left-top)
                         k=2N        -> top-left corner
                         k=2N+1..4N  -> top[0..2N-1]   (left .. top-right)

Exactness of the float32 product: every weight is a non-negative integer,
each output row's weights sum to 2^T <= 64 and samples are <= 255, so
every partial sum is an integer below 2^24 and float32 accumulates it
exactly in any order — but only in full float32. On the card TF32 would
round the inputs, so the product asserts TF32 is off.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

# intraPredAngle per mode 2..34 (H.265 table 8-5)
ANGLES = np.array([32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21,
                   -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13,
                   17, 21, 26, 32], dtype=np.int32)
# invAngle per mode 11..25 (H.265 table 8-6): Round(8192 / angle)
INV_ANGLES = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
              -21: -390, -26: -315, -32: -256}

PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 10
VER_IDX = 26


def _ref_index_to_v(t: int, n: int, vertical: bool, inv_angle: int) -> int:
    """Map spec ref[] index t to a v index, projecting t<0 via invAngle."""
    two_n = 2 * n
    if t >= 0:
        if vertical:        # ref[t] = p[t-1][-1]: t=0 corner, else top[t-1]
            return two_n if t == 0 else two_n + t
        return two_n if t == 0 else two_n - t   # horizontal: left[t-1]
    proj = -1 + ((t * inv_angle + 128) >> 8)
    if vertical:
        return two_n - 1 - proj     # from left[proj]
    return two_n + 1 + proj         # from top[proj]


@lru_cache(maxsize=None)
def angular_tables(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For the 33 angular modes (2..34) at size n: (idx1, idx2, frac), each
    [33, n, n], with pred = ((32-frac)*v[idx1] + frac*v[idx2] + 16) >> 5."""
    idx1 = np.zeros((33, n, n), dtype=np.int32)
    idx2 = np.zeros((33, n, n), dtype=np.int32)
    frac = np.zeros((33, n, n), dtype=np.int32)
    for mi, mode in enumerate(range(2, 35)):
        a = int(ANGLES[mode - 2])
        vertical = mode >= 18
        inv = INV_ANGLES.get(a, 0)
        for q in range(n):          # the "stride" coordinate (y for V, x for H)
            i = ((q + 1) * a) >> 5
            f = ((q + 1) * a) & 31
            for p_ in range(n):     # along the main reference
                vt1 = _ref_index_to_v(p_ + i + 1, n, vertical, inv)
                vt2 = _ref_index_to_v(p_ + i + 2, n, vertical, inv) if f \
                    else vt1
                y, x = (q, p_) if vertical else (p_, q)
                idx1[mi, y, x] = vt1
                idx2[mi, y, x] = vt2
                frac[mi, y, x] = f
    return idx1, idx2, frac


@lru_cache(maxsize=None)
def mode_filter_flags(n: int) -> np.ndarray:
    """filterFlag per mode (35,) for luma at size n (H.265 8.4.4.2.3)."""
    flags = np.zeros(35, dtype=bool)
    if n == 4:
        return flags
    thresh = {8: 7, 16: 1, 32: 0}[n]
    for mode in range(35):
        if mode == DC_IDX:
            continue
        if mode == PLANAR_IDX:
            flags[mode] = True
            continue
        min_dist = min(abs(mode - VER_IDX), abs(mode - HOR_IDX))
        flags[mode] = min_dist > thresh
    return flags


def substitute_references(v_raw: torch.Tensor, avail: torch.Tensor,
                          bit_depth: int = 8) -> torch.Tensor:
    """Spec 8.4.4.2.2 substitution, vectorized. v_raw: [..., 4N+1] boundary
    samples (garbage where unavailable); avail: [..., 4N+1] bool. Each
    unavailable sample copies the nearest available one before it in scan
    order (samples before the first available copy that one); with nothing
    available the vector fills with 1 << (bd-1)."""
    L = v_raw.shape[-1]
    idx = torch.arange(L, dtype=torch.int64, device=v_raw.device)
    marked = torch.where(avail, idx, torch.full_like(idx, -1))
    ffill = torch.cummax(marked, dim=-1).values
    first_avail = torch.argmax(avail.to(torch.int32), dim=-1, keepdim=True)
    src = torch.where(ffill >= 0, ffill, first_avail)
    out = torch.gather(v_raw, -1, src)
    none_avail = ~avail.any(dim=-1, keepdim=True)
    return torch.where(none_avail, torch.full_like(out, 1 << (bit_depth - 1)),
                       out)


def filter_references(v: torch.Tensor) -> torch.Tensor:
    """[1 2 1]/4 reference smoothing along v; endpoints unchanged
    (spec 8.4.4.2.3; strong smoothing applies to 32x32 only)."""
    vi = v.to(torch.int32)
    mid = (vi[..., :-2] + 2 * vi[..., 1:-1] + vi[..., 2:] + 2) >> 2
    return torch.cat([vi[..., :1], mid, vi[..., -1:]], dim=-1)


@lru_cache(maxsize=None)
def allangs_matrix(n: int, luma: bool) -> Tuple[np.ndarray, int]:
    """Weight matrix [35*n*n, 2*(4n+1)] (float32) and the common shift T.
    Row layout: mode-major, raster within mode. Column layout:
    [0 .. 4n] unfiltered v, [4n+1 .. 8n+1] filtered v. Planar, DC and the
    angular modes are all linear in the references; weights are pre-scaled
    to the common shift T."""
    L = 4 * n + 1
    log2n = n.bit_length() - 1
    T = max(5, log2n + 1)
    W = np.zeros((35, n * n, 2 * L), dtype=np.float64)
    fflags = mode_filter_flags(n) if (luma and n > 4) else np.zeros(35, bool)
    two_n = 2 * n

    def vcol(k, filt):
        return k + (L if filt else 0)

    sc = 1 << (T - (log2n + 1))     # planar / DC: shift log2n+1
    f = bool(fflags[PLANAR_IDX])
    for y in range(n):
        for x in range(n):
            W[0, y * n + x, vcol(two_n - 1 - y, f)] += (n - 1 - x) * sc  # left[y]
            W[0, y * n + x, vcol(two_n + 1 + n, f)] += (x + 1) * sc      # top[n]
            W[0, y * n + x, vcol(two_n + 1 + x, f)] += (n - 1 - y) * sc  # top[x]
            W[0, y * n + x, vcol(two_n - 1 - n, f)] += (y + 1) * sc      # left[n]
    for k in range(n):
        for p in range(n * n):
            W[1, p, vcol(two_n - 1 - k, False)] += sc    # left[k]
            W[1, p, vcol(two_n + 1 + k, False)] += sc    # top[k]
    idx1, idx2, frac = angular_tables(n)
    asc = 1 << (T - 5)
    for mi in range(33):
        mode = mi + 2
        f = bool(fflags[mode])
        for y in range(n):
            for x in range(n):
                p = y * n + x
                fr = int(frac[mi, y, x])
                W[mode, p, vcol(int(idx1[mi, y, x]), f)] += (32 - fr) * asc
                if fr:
                    W[mode, p, vcol(int(idx2[mi, y, x]), f)] += fr * asc
    return W.reshape(35 * n * n, 2 * L).astype(np.float32), T


_W_CACHE = {}


def _weights_t(n: int, luma: bool, device) -> Tuple[torch.Tensor, int]:
    """[2L, 35*n*n] float32 weights on `device` (cached)."""
    key = (n, luma, str(device))
    if key not in _W_CACHE:
        W, T = allangs_matrix(n, luma)
        _W_CACHE[key] = (torch.as_tensor(W.T.copy(), device=device), T)
    return _W_CACHE[key]


def predict_all_modes_matmul(v: torch.Tensor, n: int, bit_depth: int = 8,
                             luma: bool = True,
                             chroma444: bool = False) -> torch.Tensor:
    """All 35 modes for a batch of blocks. v: [B, 4n+1] substituted
    references. Returns [B, 35, n, n] int32 (spec-exact incl. the DC/H/V
    boundary filters for luma n < 32). chroma444: 4:4:4 chroma, whose
    references are filtered as luma's (spec 8.4.4.2.3 applies when cIdx
    is 0 or ChromaArrayType is 3) but whose DC / H / V edges are not
    (cIdx 0 only)."""
    filt = luma or chroma444
    Wt, T = _weights_t(n, filt, v.device)
    if v.is_cuda:
        assert not torch.backends.cuda.matmul.allow_tf32 and \
            torch.get_float32_matmul_precision() == "highest", \
            "intra prediction needs full-precision float32 products"
    vi = v.to(torch.int32)
    B = vi.shape[0]
    two_n = 2 * n
    vf = filter_references(vi) if (filt and n > 4) else vi
    vcat = torch.cat([vi, vf], dim=-1).to(torch.float32)      # [B, 2L]
    acc = (vcat @ Wt).to(torch.int32)
    pred = ((acc + (1 << (T - 1))) >> T).reshape(B, 35, n, n)
    if not (luma and n < 32):
        return pred
    # --- boundary fixups (masked elementwise) ---
    left = vi[:, two_n - n:two_n].flip(-1)          # left[0..n-1]
    top = vi[:, two_n + 1:two_n + 1 + n]            # top[0..n-1]
    corner = vi[:, two_n]
    maxv = (1 << bit_depth) - 1
    dev = v.device
    modes = torch.arange(35, device=dev).reshape(1, 35, 1, 1)
    row0 = torch.arange(n, device=dev).reshape(1, 1, n, 1) == 0   # y == 0
    col0 = torch.arange(n, device=dev).reshape(1, 1, 1, n) == 0   # x == 0
    # DC (mode 1) edge filtering
    dc = (left.sum(-1) + top.sum(-1) + n) >> (n.bit_length())
    dcr = (top + 3 * dc[:, None] + 2) >> 2                        # [B, n]
    dcc = (left + 3 * dc[:, None] + 2) >> 2
    dc00 = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
    m_dc = modes == DC_IDX
    pred = torch.where(m_dc & row0, dcr[:, None, None, :].to(torch.int32), pred)
    pred = torch.where(m_dc & col0, dcc[:, None, :, None].to(torch.int32), pred)
    pred = torch.where(m_dc & row0 & col0,
                       dc00[:, None, None, None].to(torch.int32), pred)
    # mode 26 (V): first column adjusted; mode 10 (H): first row adjusted
    v26c = (top[:, :1] + ((left - corner[:, None]) >> 1)).clamp(0, maxv)
    pred = torch.where((modes == VER_IDX) & col0, v26c[:, None, :, None], pred)
    v10r = (left[:, :1] + ((top - corner[:, None]) >> 1)).clamp(0, maxv)
    pred = torch.where((modes == HOR_IDX) & row0, v10r[:, None, None, :], pred)
    return pred


def predict_mode_matmul(v: torch.Tensor, modes: torch.Tensor, n: int,
                        bit_depth: int = 8, luma: bool = True,
                        chroma444: bool = False) -> torch.Tensor:
    """One chosen mode per block. v: [B, 4n+1]; modes: [B]. Returns
    [B, n, n] int32 — the all-modes product followed by a gather on the
    mode axis (bit-exact with the all-modes path)."""
    allp = predict_all_modes_matmul(v, n, bit_depth, luma=luma,
                                    chroma444=chroma444)
    idx = modes.to(torch.int64).reshape(-1, 1, 1, 1).expand(-1, 1, n, n)
    return torch.gather(allp, 1, idx)[:, 0]
