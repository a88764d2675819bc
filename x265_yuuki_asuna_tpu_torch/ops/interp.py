"""Motion-compensation interpolation: 8-tap luma / 4-tap chroma, batched
over blocks with per-block fractional MVs.

Port of x265_yuuki_asuna_tpu/ops/interp.py (mc_block_batch, mc_luma_qpel,
mc_chroma_qpel, the short-domain mc_block_batch_ps / mc_luma_qpel_ps /
mc_chroma_qpel_ps, the bi average add_avg, the explicit-weight combine
weight_uni, gather_luma_window, subpel_refine_win) and of the weighted
motion search's reference transform (weight_plane, written inline in the
JAX package's models/inter_encoder.py). Filter taps are spec constants (H.265 tables
8-11/8-13); reference behavior (studied, not copied): common/ipfilter.cpp.

One two-stage path serves all fractions: horizontal pixel->short with the
-IF_INTERNAL_OFFS bias, then vertical short->pixel; for zero fractions it
equals the dedicated copy paths. The short-domain variant stops after the
vertical stage with a plain >> 6 (no offset, no clip), and add_avg adds
back 2 * IF_INTERNAL_OFFS with the rounding before its shift, as the JAX
package does. Out-of-picture samples clamp their index (the decoder's
border extension). All sums are int32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .pixel import peak, plane_dtype

LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], dtype=np.int32)

CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2]], dtype=np.int32)

IF_INTERNAL_OFFS = 1 << 13   # 8192


@lru_cache(maxsize=None)
def _filters(luma: bool, device) -> torch.Tensor:
    """The luma or chroma filter taps on `device`, made once (a host copy
    per call would make the host wait for the card's stream)."""
    return torch.as_tensor(LUMA_FILTERS if luma else CHROMA_FILTERS,
                           device=device)


def _two_stage(ref_plane: torch.Tensor, px, py, mv_int_x, mv_int_y, frac_x,
               frac_y, n: int, luma: bool, bit_depth: int) -> torch.Tensor:
    """The vertical stage's int32 sums [B, n, n] before its shift: both
    filter stages over a border-clamped window."""
    dev = ref_plane.device
    taps = 8 if luma else 4
    half = taps // 2 - 1          # 3 luma, 1 chroma
    filters = _filters(luma, dev)
    H, W = ref_plane.shape
    B = px.shape[0]
    ext = n + taps - 1

    # gather the extended window [B, ext, ext] with clamped indices
    off = torch.arange(ext, device=dev) - half
    rows = ((py + mv_int_y).long()[:, None] + off[None, :]).clamp(0, H - 1)
    cols = ((px + mv_int_x).long()[:, None] + off[None, :]).clamp(0, W - 1)
    win = ref_plane.reshape(-1)[rows[:, :, None] * W + cols[:, None, :]]
    win = win.to(torch.int32)

    cfx = filters[frac_x.long()]                    # [B, taps]
    cfy = filters[frac_y.long()]
    headroom = 14 - bit_depth                       # IF_INTERNAL_PREC - bd
    shift1 = 6 - headroom                           # horizontal ps shift
    acc = torch.zeros((B, ext, n), dtype=torch.int32, device=dev)
    for k in range(taps):
        acc = acc + cfx[:, k, None, None] * win[:, :, k:k + n]
    mid = (acc - (IF_INTERNAL_OFFS << shift1)) >> shift1
    acc2 = torch.zeros((B, n, n), dtype=torch.int32, device=dev)
    for k in range(taps):
        acc2 = acc2 + cfy[:, k, None, None] * mid[:, k:k + n, :]
    return acc2


def mc_block_batch(ref_plane: torch.Tensor, px, py, mv_int_x, mv_int_y,
                   frac_x, frac_y, n: int, luma: bool = True,
                   bit_depth: int = 8) -> torch.Tensor:
    """Motion-compensate a batch of n x n blocks.

    ref_plane: [H, W] int; px/py: [B] block top-left; mv_int_*: [B] integer
    offsets; frac_*: [B] fraction (0..3 luma, 0..7 chroma).
    Returns [B, n, n] predicted pixels (int32)."""
    acc2 = _two_stage(ref_plane, px, py, mv_int_x, mv_int_y, frac_x, frac_y,
                      n, luma, bit_depth)
    shift2 = 6 + 14 - bit_depth
    offset2 = (1 << (shift2 - 1)) + (IF_INTERNAL_OFFS << 6)
    return ((acc2 + offset2) >> shift2).clamp(0, (1 << bit_depth) - 1)


def mc_block_batch_ps(ref_plane: torch.Tensor, px, py, mv_int_x, mv_int_y,
                      frac_x, frac_y, n: int, luma: bool = True,
                      bit_depth: int = 8) -> torch.Tensor:
    """MC to the 14-bit short domain for bi-prediction: the same two stages
    as mc_block_batch, the vertical one ending in >> 6 with no offset and
    no clip. Returns [B, n, n] int32."""
    return _two_stage(ref_plane, px, py, mv_int_x, mv_int_y, frac_x, frac_y,
                      n, luma, bit_depth) >> 6


def add_avg(ps0: torch.Tensor, ps1: torch.Tensor,
            bit_depth: int = 8) -> torch.Tensor:
    """Bi-prediction combine of two short-domain predictions: the clipped,
    rounded mean (the reference's addAvg)."""
    shift = 15 - bit_depth
    offset = (1 << (shift - 1)) + 2 * IF_INTERNAL_OFFS
    return ((ps0 + ps1 + offset) >> shift).clamp(0, (1 << bit_depth) - 1)


def weight_uni(ps: torch.Tensor, w, o, denom: int = 6,
               bit_depth: int = 8) -> torch.Tensor:
    """Explicit weighted uni-prediction of a short-domain prediction ps
    (spec 8.5.3.3.4.3): ((ps + IF_INTERNAL_OFFS) * w + round) >> log2WD,
    then + o << (bit_depth - 8), clipped; log2WD = denom + 14 - bit_depth.
    w / o: the signalled weight and offset (ints or int32 tensors)."""
    log2wd = denom + 14 - bit_depth
    return ((((ps + IF_INTERNAL_OFFS) * w + (1 << (log2wd - 1))) >> log2wd)
            + (o << (bit_depth - 8))).clamp(0, (1 << bit_depth) - 1)


def weight_plane(ref: torch.Tensor, w: int, o: int,
                 bit_depth: int = 8) -> torch.Tensor:
    """The weighted motion search's reference plane: each sample
    clip(((ref * w + 32) >> 6) + o, 0, 2^bd - 1), in the device plane
    type (K1's input: uint8 at 8 bits, int16 above). As in the
    reference, the offset is added unscaled at every bit depth (the
    prediction scales it by 2^(bd - 8)). This guides the search only; the
    prediction is weight_uni of the MC of the unweighted plane."""
    return (((ref.to(torch.int32) * w + 32) >> 6) + o) \
        .clamp(0, peak(bit_depth)).to(plane_dtype(bit_depth))


def mc_luma_qpel(ref_plane, px, py, mv_qpel_x, mv_qpel_y, n: int,
                 bit_depth: int = 8):
    """Luma MC with quarter-pel MVs [B]."""
    return mc_block_batch(ref_plane, px, py, mv_qpel_x >> 2, mv_qpel_y >> 2,
                          mv_qpel_x & 3, mv_qpel_y & 3, n, True, bit_depth)


def mc_chroma_qpel(ref_plane, px_c, py_c, mv_qpel_x, mv_qpel_y, n: int,
                   bit_depth: int = 8):
    """Chroma MC for 4:2:0: a luma quarter-pel MV is a chroma eighth-pel
    MV. px_c/py_c are chroma-plane coordinates."""
    return mc_block_batch(ref_plane, px_c, py_c, mv_qpel_x >> 3,
                          mv_qpel_y >> 3, mv_qpel_x & 7, mv_qpel_y & 7,
                          n, False, bit_depth)


def mc_luma_qpel_ps(ref_plane, px, py, mv_qpel_x, mv_qpel_y, n: int,
                    bit_depth: int = 8):
    """Short-domain luma MC with quarter-pel MVs [B]."""
    return mc_block_batch_ps(ref_plane, px, py, mv_qpel_x >> 2,
                             mv_qpel_y >> 2, mv_qpel_x & 3, mv_qpel_y & 3, n,
                             True, bit_depth)


def mc_chroma_qpel_ps(ref_plane, px_c, py_c, mv_qpel_x, mv_qpel_y, n: int,
                      bit_depth: int = 8):
    """Short-domain 4:2:0 chroma MC (chroma eighth-pel from the luma
    quarter-pel MV)."""
    return mc_block_batch_ps(ref_plane, px_c, py_c, mv_qpel_x >> 3,
                             mv_qpel_y >> 3, mv_qpel_x & 7, mv_qpel_y & 7, n,
                             False, bit_depth)


def gather_luma_window(ref_plane: torch.Tensor, px, py, mv_int_x, mv_int_y,
                       n: int) -> torch.Tensor:
    """One [B, n+8, n+8] int32 reference window per block, border-clamped,
    with win[:, 4, 4] the sample at the integer MV: it serves every qpel
    offset in [-3, 3]^2 of subpel_refine_win."""
    H, W = ref_plane.shape
    off = torch.arange(n + 8, device=ref_plane.device) - 4
    rows = ((py + mv_int_y).long()[:, None] + off[None, :]).clamp(0, H - 1)
    cols = ((px + mv_int_x).long()[:, None] + off[None, :]).clamp(0, W - 1)
    return ref_plane.reshape(-1)[rows[:, :, None] * W + cols[:, None, :]] \
        .to(torch.int32)


def subpel_refine_win(win: torch.Tensor, src_blocks: torch.Tensor, n: int,
                      bit_depth: int = 8):
    """Half- then quarter-pel SATD refinement on a gather_luma_window
    window: (dqx, dqy, best_satd) [B], dq* in [-3, 3] qpel from the
    window's integer centre. Each round evaluates its candidates in one
    batch: the half-pel round the centre then the 8 neighbours, the
    quarter-pel round the half-pel winner (the incumbent) then its 8
    neighbours; the first minimum wins, so ties keep the earlier one."""
    from . import pixel
    dev = win.device
    filters = _filters(True, dev)
    B = win.shape[0]
    headroom = 14 - bit_depth
    shift1, shift2 = 6 - headroom, 6 + headroom
    offset2 = (1 << (shift2 - 1)) + (IF_INTERNAL_OFFS << 6)
    maxv = (1 << bit_depth) - 1
    src = src_blocks.to(torch.int32)

    def filt(sub, cfx, cfy):
        # sub: [K, n+7, n+7] local windows; cf*: [K, 8] per-block taps
        K = sub.shape[0]
        acc = torch.zeros((K, n + 7, n), dtype=torch.int32, device=dev)
        for k in range(8):
            acc = acc + cfx[:, k, None, None] * sub[:, :, k:k + n]
        mid = (acc - (IF_INTERNAL_OFFS << shift1)) >> shift1
        acc2 = torch.zeros((K, n, n), dtype=torch.int32, device=dev)
        for k in range(8):
            acc2 = acc2 + cfy[:, k, None, None] * mid[:, k:k + n, :]
        return ((acc2 + offset2) >> shift2).clamp(0, maxv)

    nbr = ((-1, 0), (1, 0), (0, -1), (0, 1),
           (-1, -1), (1, -1), (-1, 1), (1, 1))
    # half-pel round: the centre, then the 8 neighbours
    cand_h = [(0, 0)] + [(2 * dx, 2 * dy) for dx, dy in nbr]
    K = len(cand_h)
    sub_b = torch.cat([win[:, (dy >> 2) + 1:(dy >> 2) + 8 + n,
                           (dx >> 2) + 1:(dx >> 2) + 8 + n]
                       for dx, dy in cand_h])
    cfx = torch.cat([filters[dx & 3].expand(B, 8) for dx, _ in cand_h])
    cfy = torch.cat([filters[dy & 3].expand(B, 8) for _, dy in cand_h])
    src_b = src.expand(K, B, n, n).reshape(K * B, n, n)
    c_h = pixel.satd(src_b, filt(sub_b, cfx, cfy)).reshape(K, B)
    a_h = torch.argmin(c_h, dim=0)
    best = torch.gather(c_h, 0, a_h[None])[0]
    hx = torch.tensor([d[0] for d in cand_h], dtype=torch.int32, device=dev)
    hy = torch.tensor([d[1] for d in cand_h], dtype=torch.int32, device=dev)
    bx, by = hx[a_h], hy[a_h]

    # quarter-pel round: the 8 neighbours of the half-pel winner; the
    # integer part of each offset is -1 or 0, so each window is one of
    # four static slices
    dxq = torch.cat([bx + d for d, _ in nbr])
    dyq = torch.cat([by + d for _, d in nbr])
    winq = win.repeat(len(nbr), 1, 1)
    oy_m = (dyq >> 2 < 0)[:, None, None]
    ox_m = (dxq >> 2 < 0)[:, None, None]
    sub_q = torch.where(
        oy_m, torch.where(ox_m, winq[:, :n + 7, :n + 7], winq[:, :n + 7, 1:]),
        torch.where(ox_m, winq[:, 1:, :n + 7], winq[:, 1:, 1:]))
    src_q = src.expand(len(nbr), B, n, n).reshape(len(nbr) * B, n, n)
    c_q = pixel.satd(src_q, filt(sub_q, filters[(dxq & 3).long()],
                                 filters[(dyq & 3).long()]))
    c_all = torch.cat([best[None], c_q.reshape(len(nbr), B)])
    dx_all = torch.cat([bx[None], dxq.reshape(len(nbr), B)])
    dy_all = torch.cat([by[None], dyq.reshape(len(nbr), B)])
    a_q = torch.argmin(c_all, dim=0)[None]
    return (torch.gather(dx_all, 0, a_q)[0], torch.gather(dy_all, 0, a_q)[0],
            torch.gather(c_all, 0, a_q)[0])
