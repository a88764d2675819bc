"""The loop-filter chain of the CTU32 quadtree programs (depth 1 or 2):
deblock, then SAO, on the whole frame on the device.

Port of x265_yuuki_asuna_tpu/ops/filters_dev.py (qt_loopfilter_dev and the
functions it calls; BS through ops/deblock.compute_bs, SAO through
ops/sao.py in its "program" form). The boundary-strength inputs are the
reference's, not the spec's: a cell's cbf is any nonzero luma level in
its CU (not its TU, not chroma), intra cells have direction 0 and zero
MVs, and edges inside one CU are not filtered. Luma edges lie on the
8-sample grid, chroma edges on the 16-luma grid at BS 2.
"""

from __future__ import annotations

import torch

from . import deblock as DB
from . import sao as SAO

N = 32      # CTU size


def effective_qp(qp_cu, cbf_cu, slice_qp: int):
    """The decoder-side QP of each CTU: a CTU with no coded residual sends
    no cu_qp_delta, so it keeps the previous coded CTU's QP (the slice QP
    before the first; spec 8.6.1). qp_cu [ncu] int, cbf_cu [ncu] bool."""
    dev = qp_cu.device
    q = torch.cat([torch.tensor([slice_qp], dtype=torch.int32, device=dev),
                   qp_cu.to(torch.int32)])
    v = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                   cbf_cu.bool()])
    last = torch.cummax(torch.where(v, torch.arange(q.shape[0], device=dev),
                                    0), 0).values
    return q[last][1:]


def deblock_qt2(rec3, cell_q, bs_v, bs_h, bit_depth: int = 8):
    """Deblock with luma edges on the 8-sample grid and chroma edges on the
    16-luma grid (BS-2 segments). rec3: int32 (y, u, v) of bit_depth-bit
    samples; cell_q [H/8, W/8] the decoder-side luma QP per cell;
    thresholds from the per-edge average QP (qa + qb + 1) >> 1, chroma tc
    through CHROMA_QP, each scaled to the bit depth."""
    y, u, v = rec3
    H, W = y.shape
    dev = y.device
    bd, shift, maxv = bit_depth, bit_depth - 8, (1 << bit_depth) - 1
    bt, tt, cq = (DB.table(t, dev) for t in (DB.BETA_TABLE, DB.TC_TABLE,
                                              DB.CHROMA_QP))
    q = cell_q.to(torch.int32)
    qv = (q[:, :-1] + q[:, 1:] + 1) >> 1
    qh = (q[:-1, :] + q[1:, :] + 1) >> 1
    beta = lambda qe: bt[qe.clamp(0, 51).long()] << shift
    tc_c = lambda qe: tt[(cq[qe.clamp(0, 51).long()]
                          + DB.DEFAULT_INTRA_TC_OFFSET).clamp(0, 53)
                         .long()] << shift
    tc_v = DB.tc_seg_from_bs(bs_v, qv, 0, bd).repeat_interleave(2, 0)
    tc_h = DB.tc_seg_from_bs(bs_h, qh, 0, bd).t().repeat_interleave(2, 0)
    y = DB.filter_plane(y, list(range(8, W, 8)), list(range(8, H, 8)), True,
                        (beta(qv).repeat_interleave(2, 0), tc_v),
                        (beta(qh).t().repeat_interleave(2, 0), tc_h), maxv)
    # chroma: 8-chroma-sample edges = the odd edges of the 8-luma grid
    cv = (tc_c(qv)[:, 1::2].repeat_interleave(4, 0),
          (bs_v[:, 1::2] == 2).repeat_interleave(4, 0))
    ch = (tc_c(qh)[1::2, :].t().repeat_interleave(4, 0),
          (bs_h[1::2, :] == 2).t().repeat_interleave(4, 0))
    vc, hc = list(range(8, W // 2, 8)), list(range(8, H // 2, 8))
    u, v = (DB.filter_plane(p, vc, hc, False, cv, ch, maxv) for p in (u, v))
    return y, u, v


def _cell_maps(split, split16, ui_sizes, mv_sizes, pdir_sizes, lv_y, rows,
               cols):
    """Per 8x8 cell: intra, cbf, MVs, prediction direction and CU id, from
    the CTU32 / 16 / 8 dense decisions (frame raster order at each size;
    split16 None at depth 1, where no 16x16 CU splits)."""
    gr, gc = 4 * rows, 4 * cols
    dev = split.device
    up4 = lambda a: a.reshape(rows, cols).repeat_interleave(4, 0) \
        .repeat_interleave(4, 1)
    up2 = lambda a: a.reshape(gr // 2, gc // 2).repeat_interleave(2, 0) \
        .repeat_interleave(2, 1)
    # depth of each cell's CU: 0 = CU32, 1 = CU16, 2 = CU8
    lvl8 = torch.where(up4(split), 1, 0) if split16 is None else \
        torch.where(up4(split), torch.where(up2(split16), 2, 1), 0)

    def sel8(a32, a16, a8):
        m = torch.where(lvl8 == 1, up2(a16), up4(a32))
        return m if a8 is None else torch.where(lvl8 == 2,
                                                a8.reshape(gr, gc), m)

    z = torch.zeros((gr, gc), dtype=torch.int32, device=dev)
    if ui_sizes is None:                  # an I frame: every cell intra
        ui = torch.ones((gr, gc), dtype=torch.bool, device=dev)
    else:
        ui = sel8(*(None if a is None else a.to(torch.int32)
                    for a in ui_sizes)).bool()
    mv = [z] * 4
    if mv_sizes is not None:
        # a missing list (a P frame's L1) is zero
        mv = [sel8(*(None if s is None else
                     (torch.zeros_like(s[0]) if s[k] is None else s[k])
                     for s in mv_sizes)) for k in range(4)]
    pdir = z + 1 if pdir_sizes is None else sel8(*pdir_sizes)
    pdir = torch.where(ui, 0, pdir)
    l0, l1 = ui | ((pdir & 1) == 0), ui | ((pdir & 2) == 0)
    mv = [torch.where(l1 if k >= 2 else l0, 0, m) for k, m in enumerate(mv)]
    # cbf: any nonzero luma level in the cell's CU
    a8 = (lv_y != 0).reshape(gr, 8, gc, 8).any(3).any(1)
    a16 = a8.reshape(gr // 2, 2, gc // 2, 2).any(3).any(1)
    a32 = a8.reshape(rows, 4, cols, 4).any(3).any(1)
    cbf = torch.where(lvl8 == 2, a8, torch.where(lvl8 == 1, up2(a16),
                                                 up4(a32)))
    # CU id (distinct per CU): CTU * 21 + 0 / 1 + quadrant / 5 + cell
    cr = torch.arange(gr, device=dev) % 4
    cc = torch.arange(gc, device=dev) % 4
    ctu = (torch.arange(gr, device=dev) // 4)[:, None] * cols \
        + (torch.arange(gc, device=dev) // 4)[None, :]
    kk = torch.where(lvl8 == 0, 0, torch.where(
        lvl8 == 1, 1 + (cr[:, None] // 2) * 2 + cc[None, :] // 2,
        5 + cr[:, None] * 4 + cc[None, :]))
    return {"is_intra": ui, "cbf": cbf, "mvx": mv[0], "mvy": mv[1],
            "mv1x": mv[2], "mv1y": mv[3], "pdir": pdir,
            "cu_id": ctu * 21 + kk}


def qt_loopfilter(rec3, src3, qp_cu, slice_qp: int, split, split16,
                  ui_sizes, mv_sizes, pdir_sizes, lv3, deblock: bool,
                  sao: bool, sao_form: str = "program", bit_depth: int = 8):
    """The loop-filter chain of one CTU32 quadtree frame (the reference's
    qt_loopfilter_dev, depth2 when split16 is given).

    rec3 / src3: int32 (y [H, W], u, v [H/2, W/2]) planes; qp_cu [ncu] the
    intended per-CTU QP; split [ncu] / split16 [n16] bool (None at depth
    1: the cells' depth is the CTU's split, and no size-8 input is read;
    the 8-sample luma edges inside a 16x16 CU are CU interiors, BS 0, so
    the deblock equals the reference's host form on the 16-sample grid);
    ui_sizes:
    (ui32, ui16, ui8) bool per size (ui8 may be None), or None for an I
    frame; mv_sizes: per size (mv0x, mv0y, mv1x, mv1y) quarter-pel (a
    missing list None), or None; pdir_sizes: (pdir32, pdir16, pdir8), or
    None (a P frame: L0); lv3: the level planes (y, u, v); sao_form: the
    SAO cost's form, "program" (the quadtree programs') or "host" (the
    intra session's host filters after a quadtree frame, whose deblock is
    this one: under one QP per frame the effective QP changes nothing);
    bit_depth: the samples'. Returns the filtered planes and the SAO parameters packed [ncu, 18]
    (None without SAO)."""
    H, W = rec3[0].shape
    rows, cols = H // N, W // N
    out3 = rec3
    if deblock:
        maps = _cell_maps(split, split16, ui_sizes, mv_sizes, pdir_sizes,
                          lv3[0], rows, cols)
        bs_v, bs_h = DB.compute_bs(maps)
        tiles = lambda p, k: (p != 0).reshape(rows, k, cols, k).any(3) \
            .any(1).reshape(-1)
        cbf_ctu = tiles(lv3[0], N) | tiles(lv3[1], N // 2) | \
            tiles(lv3[2], N // 2)
        q_eff = effective_qp(qp_cu, cbf_ctu, slice_qp)
        cell_q = q_eff.reshape(rows, cols).repeat_interleave(4, 0) \
            .repeat_interleave(4, 1)
        out3 = deblock_qt2(out3, cell_q, bs_v, bs_h, bit_depth)
    params = None
    if sao:
        out3, params = SAO.sao_frame(out3, src3, N, slice_qp, sao_form,
                                     bit_depth)
    return out3, params
