"""HEVC deblocking (spec 8.7.2) on whole planes.

Port of x265_yuuki_asuna_tpu/ops/deblock.py: the spec tables, the batched
luma and chroma edge filters, and the uniform-grid frames (the IDR, every
CU edge at BS 2; the P frame, per-edge BS; the CTU64 intra quadtree's
BS, compute_bs_qt64_intra), at any bit depth (beta and
tc scaled by 2^(bd - 8), samples clipped to the bd-bit range), with one
QP per frame or a per-CU QP map (AQ / cuTree: each edge at the average of its two
CUs' QPs, `edge_qps`).

Every vertical edge of the picture is filtered in one batched pass (the
edges are at least 8 samples apart, so no two edges read what the other
writes), then every horizontal edge on the vertically filtered samples:
the horizontal pass is the vertical one on the transposed planes. Planes
are int32 tensors on any device.
"""

from __future__ import annotations

import numpy as np
import torch

# Table 8-12 (spec constants)
TC_TABLE = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
    13, 14, 16, 18, 20, 22, 24)
BETA_TABLE = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
    44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64)
DEFAULT_INTRA_TC_OFFSET = 2
# spec table 8-10 (4:2:0): the chroma QP of a per-edge averaged luma QP
CHROMA_QP = tuple(range(30)) + (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36,
                                36, 37, 37) + tuple(range(38, 52))


def table(values, device) -> torch.Tensor:
    """A spec table as an int32 tensor on `device`."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def _clip(x, lo, hi):
    """np.clip with scalar or tensor bounds: max with lo, then min with
    hi."""
    if not torch.is_tensor(lo) and not torch.is_tensor(hi):
        return x.clamp(lo, hi)
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def luma_thresholds(qp: int, beta_offset: int = 0, tc_offset: int = 0,
                    bs: int = 2, bit_depth: int = 8):
    """(beta, tc) of one edge QP and boundary strength, scaled to the bit
    depth."""
    idx_b = min(max(qp + beta_offset, 0), 51)
    idx_tc = min(max(qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1) + tc_offset, 0),
                 53)
    shift = bit_depth - 8
    return BETA_TABLE[idx_b] << shift, TC_TABLE[idx_tc] << shift


def _edge_samples(plane, edge_cols, k: int):
    """The k samples on each side of every edge: (p, q) [H, k, E] with
    p[:, i] = plane[:, x0-1-i] and q[:, i] = plane[:, x0+i], and their
    column indices [k, E]."""
    dev = plane.device
    x0 = torch.tensor(edge_cols, dtype=torch.int64, device=dev)
    ar = torch.arange(k, device=dev)[:, None]
    cols_p, cols_q = x0[None] - 1 - ar, x0[None] + ar
    return plane[:, cols_p], plane[:, cols_q], cols_p, cols_q


def filter_vertical_edges(plane, edge_cols, beta, tc, maxv: int = 255):
    """Filter the vertical luma edges at columns `edge_cols` (a list).
    plane: int32 [H, W]. beta: an int or an [H/4, E] tensor; tc: an int
    (uniform BS) or an [H/4, E] per-segment tensor (0 disables a segment);
    maxv: the largest sample value.
    Decisions are made per 4-row segment from rows 0 and 3 (spec
    8.7.2.5.3). Returns the filtered plane."""
    if not edge_cols:
        return plane
    tc_arr = torch.is_tensor(tc)
    if not tc_arr and tc == 0:
        return plane
    H, E = plane.shape[0], len(edge_cols)
    tc_seg = tc
    if tc_arr:
        tc = tc.repeat_interleave(4, 0)                 # [H, E]
    p, q, cols_p, cols_q = _edge_samples(plane, edge_cols, 4)
    p0, p1, p2, p3 = p.unbind(1)
    q0, q1, q2, q3 = q.unbind(1)

    def seg(v):
        return v.reshape(H // 4, 4, E)

    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()
    dp_s, dq_s = seg(dp), seg(dq)
    dp0, dp3 = dp_s[:, 0], dp_s[:, 3]                   # [H/4, E]
    dq0, dq3 = dq_s[:, 0], dq_s[:, 3]
    dpq0, dpq3 = dp0 + dq0, dp3 + dq3
    filter_on = (dpq0 + dpq3) < beta
    side_th = (beta + (beta >> 1)) >> 3
    side_p = (dp0 + dp3) < side_th
    side_q = (dq0 + dq3) < side_th
    sdist = seg(p3 - p0).abs() + seg(q0 - q3).abs()
    pq = seg(p0 - q0).abs()

    def strong_line(i, dpq):
        return ((2 * dpq < (beta >> 2)) & (sdist[:, i] < (beta >> 3))
                & (pq[:, i] < ((5 * tc_seg + 1) >> 1)))

    strong = strong_line(0, dpq0) & strong_line(3, dpq3)

    def rows(m):
        return m.repeat_interleave(4, 0)                # [H, E]

    filter_on, strong = rows(filter_on), rows(strong)
    side_p, side_q = rows(side_p), rows(side_q)

    def clip_tc2(v, ref):
        return _clip(v, ref - 2 * tc, ref + 2 * tc)

    sp0 = clip_tc2((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = clip_tc2((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = clip_tc2((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = clip_tc2((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, q0)
    sq1 = clip_tc2((q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = clip_tc2((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = delta0.abs() < 10 * tc
    delta = _clip(delta0, -tc, tc)
    wp0 = (p0 + delta).clamp(0, maxv)
    wq0 = (q0 - delta).clamp(0, maxv)
    half_tc = tc >> 1
    wp1 = (p1 + _clip((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -half_tc,
                      half_tc)).clamp(0, maxv)
    wq1 = (q1 + _clip((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -half_tc,
                      half_tc)).clamp(0, maxv)

    weak = filter_on & ~strong & weak_on
    strong = filter_on & strong
    w = torch.where
    out = plane.clone()
    out[:, cols_p[0]] = w(strong, sp0, w(weak, wp0, p0))
    out[:, cols_p[1]] = w(strong, sp1, w(weak & side_p, wp1, p1))
    out[:, cols_p[2]] = w(strong, sp2, p2)
    out[:, cols_q[0]] = w(strong, sq0, w(weak, wq0, q0))
    out[:, cols_q[1]] = w(strong, sq1, w(weak & side_q, wq1, q1))
    out[:, cols_q[2]] = w(strong, sq2, q2)
    return out


def filter_vertical_edges_chroma(plane, edge_cols, tc, mask=None,
                                 maxv: int = 255):
    """Chroma deblocking of BS-2 edges: one sample each side (spec
    8.7.2.5.5). tc: an int or an [Hc, E] tensor; mask: optional [Hc, E]
    bool, the rows where the edge has BS 2; maxv: the largest sample
    value."""
    if not edge_cols or (not torch.is_tensor(tc) and tc == 0):
        return plane
    p, q, cols_p, cols_q = _edge_samples(plane, edge_cols, 2)
    p0, p1 = p.unbind(1)
    q0, q1 = q.unbind(1)
    delta = _clip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc)
    np0 = (p0 + delta).clamp(0, maxv)
    nq0 = (q0 - delta).clamp(0, maxv)
    if mask is not None:
        np0 = torch.where(mask, np0, p0)
        nq0 = torch.where(mask, nq0, q0)
    out = plane.clone()
    out[:, cols_p[0]] = np0
    out[:, cols_q[0]] = nq0
    return out


def filter_plane(plane, vcols, hrows, luma: bool, v_args, h_args,
                 maxv: int = 255):
    """Vertical edges, then horizontal edges on the transposed result.
    v_args / h_args: the edge filter's (beta, tc) for luma, (tc, mask)
    for chroma; maxv: the largest sample value."""
    f = filter_vertical_edges if luma else filter_vertical_edges_chroma
    plane = f(plane, vcols, *v_args, maxv=maxv)
    return f(plane.t(), hrows, *h_args, maxv=maxv).t().contiguous()


def edge_qps(qp_map, device, bit_depth: int = 8) -> dict:
    """Per-edge QPs of a per-CU QP map [rows, cols] (AQ / cuTree; spec
    8.7.2.5.3: qPL = (QpQ + QpP + 1) >> 1): the luma QP "qv" [rows,
    cols-1] / "qh" [rows-1, cols] of the vertical / horizontal CU edges,
    their beta, and the chroma tc of each through table 8-10 (beta and tc
    scaled to the bit depth)."""
    shift = bit_depth - 8
    q = torch.as_tensor(np.asarray(qp_map), device=device).to(torch.int32)
    bt, tt, cq = (table(t, device) for t in (BETA_TABLE, TC_TABLE,
                                              CHROMA_QP))
    qv = (q[:, :-1] + q[:, 1:] + 1) >> 1
    qh = (q[:-1, :] + q[1:, :] + 1) >> 1
    tc_c = lambda qe: tt[(cq[qe.clamp(0, 51).long()]
                          + DEFAULT_INTRA_TC_OFFSET).clamp(0, 53).long()] \
        << shift
    return {"qv": qv, "qh": qh, "beta_v": bt[qv.clamp(0, 51).long()] << shift,
            "beta_h": bt[qh.clamp(0, 51).long()] << shift,
            "tc_c_v": tc_c(qv), "tc_c_h": tc_c(qh)}


def _per_cu(qp_y) -> bool:
    """A per-CU QP map ([rows, cols]) rather than one QP for the frame."""
    return np.ndim(qp_y) == 2


def deblock_frame_uniform(y, u, v, cu_size: int, qp_y, qp_c: int,
                          bit_depth: int = 8):
    """Deblock an all-intra uniform-CU-grid frame: every CU edge BS 2.
    qp_y: one QP, or a per-CU map [rows, cols] whose edges take their
    averaged QP (chroma through table 8-10, qp_c unused). y, u, v: int32
    planes of bit_depth-bit samples. Returns the filtered (y, u, v)."""
    H, W = y.shape
    n = cu_size
    shift, maxv = bit_depth - 8, (1 << bit_depth) - 1
    if _per_cu(qp_y):
        e = edge_qps(qp_y, y.device, bit_depth)
        tt = table(TC_TABLE, y.device)
        tc_l = lambda qe: tt[(qe + DEFAULT_INTRA_TC_OFFSET).clamp(0, 53)
                             .long()] << shift
        rep = lambda a, k: a.repeat_interleave(k, 0)
        luma_v = (rep(e["beta_v"], n // 4), rep(tc_l(e["qv"]), n // 4))
        luma_h = (rep(e["beta_h"].t(), n // 4), rep(tc_l(e["qh"]).t(),
                                                    n // 4))
        chroma_v = (rep(e["tc_c_v"], n // 2),)
        chroma_h = (rep(e["tc_c_h"].t(), n // 2),)
    else:
        beta, tc = luma_thresholds(int(qp_y), bit_depth=bit_depth)
        luma_v = luma_h = (beta, tc)
        chroma_v = chroma_h = (luma_thresholds(qp_c,
                                               bit_depth=bit_depth)[1],)
    # chroma edges on the 16-luma grid: every multiple of 8 in chroma
    c_step = max(n // 2, 8)
    vc, hc = list(range(c_step, W // 2, c_step)), \
        list(range(c_step, H // 2, c_step))
    y = filter_plane(y, list(range(n, W, n)), list(range(n, H, n)), True,
                     luma_v, luma_h, maxv)
    u, v = (filter_plane(p, vc, hc, False, chroma_v, chroma_h, maxv)
            for p in (u, v))
    return y, u, v


def compute_bs(maps: dict):
    """Boundary strengths (spec 8.7.2.4, the reference's rule) between
    neighbouring blocks of a grid: 2 where either is intra, else 1 where
    either has coded luma, their prediction directions differ or an MV
    component of either list differs by 4 quarter-pels or more, else 0;
    and 0 between blocks of one CU (equal cu_id). maps: [r, c] tensors
    is_intra, cbf (bool), pdir, mvx, mvy, mv1x, mv1y, cu_id. Returns
    (bs_v [r, c-1], bs_h [r-1, c]) int32."""
    ii, cbf, cid = maps["is_intra"], maps["cbf"], maps["cu_id"]
    mvs = [maps[k] for k in ("mvx", "mvy", "mv1x", "mv1y")]
    pdir = maps["pdir"]

    def pair(sa, sb):
        mis = pdir[sa] != pdir[sb]
        for m in mvs:
            mis = mis | ((m[sa] - m[sb]).abs() >= 4)
        bs = torch.where(ii[sa] | ii[sb], 2,
                         (cbf[sa] | cbf[sb] | mis).to(torch.int32))
        return torch.where(cid[sa] != cid[sb], bs, 0).to(torch.int32)

    return (pair(np.s_[:, :-1], np.s_[:, 1:]),
            pair(np.s_[:-1, :], np.s_[1:, :]))


def compute_bs_uniform(is_intra, cbf, pdir, mv0x, mv0y, mv1x=None,
                       mv1y=None):
    """compute_bs on the uniform grid, where every block is its own CU.
    is_intra / cbf: [rows, cols] bool; pdir: [rows, cols] (None: a P
    frame, all L0); a missing list's MVs are zero."""
    zero = torch.zeros_like(mv0x)
    return compute_bs({
        "is_intra": is_intra.bool(), "cbf": cbf.bool(),
        "pdir": zero + 1 if pdir is None else pdir, "mvx": mv0x,
        "mvy": mv0y, "mv1x": zero if mv1x is None else mv1x,
        "mv1y": zero if mv1y is None else mv1y,
        "cu_id": torch.arange(mv0x.numel(), device=mv0x.device)
        .reshape(mv0x.shape)})


def tc_seg_from_bs(bs_seg, qp, tc_offset: int = 0, bit_depth: int = 8):
    """Per-segment tc from BS (0 disables the segment), scaled to the bit
    depth; qp an int or a tensor shaped like bs_seg (per-edge averaged
    QP)."""
    tt = table(TC_TABLE, bs_seg.device)
    idx = (qp + DEFAULT_INTRA_TC_OFFSET * (bs_seg - 1) + tc_offset).clamp(0,
                                                                         53)
    return torch.where(bs_seg > 0, tt[idx.long()] << (bit_depth - 8),
                       0).to(torch.int32)


def deblock_frame_inter(y, u, v, cu_size: int, qp_y, qp_c: int, bs_v,
                        bs_h, bit_depth: int = 8):
    """Deblock an inter frame on the uniform grid with per-edge BS
    (bs_v [rows, cols-1], bs_h [rows-1, cols]); qp_y one QP or a per-CU
    map (as deblock_frame_uniform's). Chroma is filtered on BS-2 edges
    only. Returns the filtered (y, u, v)."""
    H, W = y.shape
    n, nc = cu_size, cu_size // 2
    bd, maxv = bit_depth, (1 << bit_depth) - 1
    if _per_cu(qp_y):
        e = edge_qps(qp_y, y.device, bd)
        beta_v = e["beta_v"].repeat_interleave(n // 4, 0)
        beta_h = e["beta_h"].t().repeat_interleave(n // 4, 0)
        qp_v, qp_h = e["qv"], e["qh"]
        tc_c_v = e["tc_c_v"].repeat_interleave(nc, 0)
        tc_c_h = e["tc_c_h"].t().repeat_interleave(nc, 0)
    else:
        qp_v = qp_h = int(qp_y)
        beta_v = beta_h = luma_thresholds(qp_v, bit_depth=bd)[0]
        tc_c_v = tc_c_h = luma_thresholds(qp_c, bit_depth=bd)[1]
    tc_v = tc_seg_from_bs(bs_v, qp_v, 0, bd).repeat_interleave(n // 4, 0)
    tc_h = tc_seg_from_bs(bs_h, qp_h, 0, bd).t().repeat_interleave(n // 4, 0)
    y = filter_plane(y, list(range(n, W, n)), list(range(n, H, n)), True,
                     (beta_v, tc_v), (beta_h, tc_h), maxv)
    mask_v = (bs_v == 2).repeat_interleave(nc, 0)       # [Hc, cols-1]
    mask_h = (bs_h == 2).t().repeat_interleave(nc, 0)   # [Wc, rows-1]
    vc, hc = list(range(nc, W // 2, nc)), list(range(nc, H // 2, nc))
    u, v = (filter_plane(p, vc, hc, False, (tc_c_v, mask_v),
                         (tc_c_h, mask_h), maxv) for p in (u, v))
    return y, u, v


def compute_bs_qt64_intra(split32, split16, max_depth: int):
    """Boundary strengths of a CTU64 intra quadtree frame on the 8-sample
    cell grid (host numpy): 2 on every CU edge, 0 inside a CU. split32
    [rows, cols, 4] and split16 [rows, cols, 4, 4] are the z-order split
    flags (split16 unread at max_depth 2). Returns (bs_v [gr, gc-1], bs_h
    [gr-1, gc]) int32, gr = 8 rows, gc = 8 cols."""
    split32 = np.asarray(split32, bool)
    split16 = np.asarray(split16, bool)
    rows, cols = split32.shape[:2]
    cu_id = np.zeros((8 * rows, 8 * cols), np.int64)
    nid = 1
    qoff = ((0, 0), (0, 1), (1, 0), (1, 1))
    for r in range(rows):
        for c in range(cols):
            for q, (qy, qx) in enumerate(qoff):
                y32, x32 = 8 * r + 4 * qy, 8 * c + 4 * qx
                if not split32[r, c, q]:
                    cu_id[y32:y32 + 4, x32:x32 + 4] = nid
                    nid += 1
                    continue
                for sq, (sy, sx) in enumerate(qoff):
                    y16, x16 = y32 + 2 * sy, x32 + 2 * sx
                    if max_depth == 2 or not split16[r, c, q, sq]:
                        cu_id[y16:y16 + 2, x16:x16 + 2] = nid
                        nid += 1
                        continue
                    for uy, ux in qoff:
                        cu_id[y16 + uy, x16 + ux] = nid
                        nid += 1
    bs_v = np.where(cu_id[:, :-1] != cu_id[:, 1:], 2, 0).astype(np.int32)
    bs_h = np.where(cu_id[:-1, :] != cu_id[1:, :], 2, 0).astype(np.int32)
    return bs_v, bs_h
