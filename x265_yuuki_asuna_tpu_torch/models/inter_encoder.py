"""P-frame encoder on the uniform CU grid: dense ME/MC, then a wavefront
for the intra-vs-inter decision and reconstruction.

Port of the single-reference uni-prediction P branch of
x265_yuuki_asuna_tpu/models/inter_encoder.py (`_build` + `_unpack`).
Phase A runs for every CU at once: integer full search through K1
(`ops.me.full_search_sad`), half- then quarter-pel SATD refinement, motion
compensation. Phase B walks the CU diagonals (a Python loop, one batch of
CUs per diagonal): the 35-mode intra candidate from reconstructed
neighbors, the SATD decision against the inter prediction, then transform,
quantization and reconstruction. Levels come back at full width, so the
decision dict equals `InterFrameEncoder._unpack(..., compact=False)`.

The CTU32 depth-2 quadtree's P and B frames (`InterQTEncoder`) are the
port of `_build_qt` + `_unpack_qt` of the same module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitcost as BC
from ..ops import interp, me, pixel
from . import qt_common as QT
from .intra_encoder import (WaveState, Wavefront, chroma_qp_from_luma,
                            from_blocks, gather_mode, planes_to_blocks,
                            to_blocks, tq_recon)

SEARCH_RANGE = 16    # integer full search over [-16, 16]^2

# subpel refinement neighbors, in evaluation order (ties keep the earlier)
_NBR = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 1), (1, 1))


class InterFrameEncoder:
    """Uniform-grid P-frame encoder (one L0 reference) for one geometry."""

    def __init__(self, width: int, height: int, cu_size: int, device):
        self.n = cu_size
        self.rows, self.cols = height // cu_size, width // cu_size
        self.device = torch.device(device)
        self.wave = Wavefront(self.rows, self.cols, cu_size, self.device)
        ncu = self.rows * self.cols
        idx = torch.arange(ncu, dtype=torch.int32, device=self.device)
        self.px = (idx % self.cols) * cu_size
        self.py = (idx // self.cols) * cu_size

    # ---------- phase A: dense ME + MC over all CUs ----------------------
    def motion_phase(self, y: torch.Tensor, ref_y: torch.Tensor,
                     ref_u: torch.Tensor, ref_v: torch.Tensor):
        """y, ref_*: uint8 planes. Returns quarter-pel (mvx, mvy), the
        luma/chroma predictions [ncu, n, n] / [ncu, n/2, n/2] and the
        inter SATD [ncu]."""
        n, px, py = self.n, self.px, self.py
        yb = to_blocks(y.to(torch.int32), n)
        ry = ref_y.to(torch.int32)
        mvx_i, mvy_i, _ = me.full_search_sad(ref_y, y, n, SEARCH_RANGE,
                                             lambda_bits=2)
        mvx, mvy = mvx_i * 4, mvy_i * 4

        def eval_mv(mx, my):
            return pixel.satd(yb, interp.mc_luma_qpel(ry, px, py, mx, my, n))

        # half-pel then quarter-pel refinement, 8 neighbors each
        # (reference: motion.cpp subpel iterations, SATD-costed)
        best = eval_mv(mvx, mvy)
        for stepq in (2, 1):
            bx, by = mvx, mvy
            for dx, dy in _NBR:
                mx, my = mvx + dx * stepq, mvy + dy * stepq
                c = eval_mv(mx, my)
                better = c < best
                bx = torch.where(better, mx, bx)
                by = torch.where(better, my, by)
                best = torch.minimum(c, best)
            mvx, mvy = bx, by
        pred_y = interp.mc_luma_qpel(ry, px, py, mvx, mvy, n)
        # chroma: a quarter-luma-pel MV is an eighth-chroma-pel MV
        pred_u = interp.mc_chroma_qpel(ref_u.to(torch.int32), px // 2,
                                       py // 2, mvx, mvy, n // 2)
        pred_v = interp.mc_chroma_qpel(ref_v.to(torch.int32), px // 2,
                                       py // 2, mvx, mvy, n // 2)
        return mvx, mvy, pred_y, pred_u, pred_v, pixel.satd(yb, pred_y)

    # ---------------------------------------------------------------------
    def encode_frame(self, y, u, v, ref_y, ref_u, ref_v, qp: int) -> dict:
        """All planes 8-bit, padded to the coded size; ref_* are the
        decoded reference planes. Returns the decision dict (numpy)."""
        dev = self.device
        n = self.n
        ncu = self.rows * self.cols
        log2n = n.bit_length() - 1
        qpc = chroma_qp_from_luma(qp)
        pl = lambda p: torch.as_tensor(np.ascontiguousarray(p, np.uint8),
                                       device=dev)
        mvx, mvy, pred_yb, pred_ub, pred_vb, isatd = self.motion_phase(
            pl(y), pl(ref_y), pl(ref_u), pl(ref_v))
        yb, ub, vb = planes_to_blocks(y, u, v, n, dev)

        # ---------- phase B: wavefront decision + recon ------------------
        ws = WaveState(ncu, n, dev)
        use_intra = torch.zeros(ncu, dtype=torch.bool, device=dev)
        for cu, nbr, avail in self.wave.steps:
            src = yb[cu]
            # intra candidate: all 35 luma modes, then its DM-mode chroma
            preds = ws.luma_all_modes(nbr, avail[n])
            icosts = pixel.satd(src[:, None], preds)
            m = torch.argmin(icosts, dim=1)
            ui = icosts.min(dim=1).values < isatd[cu]
            ipc = ws.chroma_dm(nbr, avail[n // 2], m)
            sel = ui[:, None, None]
            pred = torch.where(sel, gather_mode(preds, m), pred_yb[cu])
            predc = torch.where(sel.repeat(2, 1, 1), ipc,
                                torch.cat([pred_ub[cu], pred_vb[cu]]))
            # P slice: the inter rounding offset for every CU, intra too
            lv, rec = tq_recon(src, pred, qp, log2n, False)
            lvc, recc = tq_recon(torch.cat([ub[cu], vb[cu]]), predc, qpc,
                                 log2n - 1, False)
            use_intra[cu] = ui
            ws.commit(cu, m, lv, rec, lvc, recc)

        rows, cols = self.rows, self.cols
        out = ws.result(rows, cols)
        out.update({
            "use_intra": use_intra.cpu().numpy().reshape(rows, cols),
            "mvx": mvx.cpu().numpy().reshape(rows, cols),
            "mvy": mvy.cpu().numpy().reshape(rows, cols),
            "ref": None, "pdir": None, "mv1x": None, "mv1y": None})
        return out


# ---------------------------------------------------------------------------
# CTU32 depth-2 quadtree P and B frames
# ---------------------------------------------------------------------------

def _plane_u8(p, dev) -> torch.Tensor:
    """A uint8 plane on `dev` from a host array or a tensor."""
    if isinstance(p, torch.Tensor):
        return p.to(dev, torch.uint8)
    return torch.as_tensor(np.array(p, np.uint8), device=dev)


def median_mv(mv: torch.Tensor) -> torch.Tensor:
    """The reference's int32(jnp.median(mv)): for an even count the mean of
    the two middle values, truncated toward zero (torch.median would take
    the lower one)."""
    s = torch.sort(mv.reshape(-1)).values
    k = s.shape[0]
    if k % 2:
        return s[k // 2]
    return torch.div(s[k // 2 - 1] + s[k // 2], 2, rounding_mode="trunc")


def shift_grid(a: torch.Tensor, rn: int, cn: int, dr: int, dc: int):
    """The value of the block (dr, dc) away on an rn x cn block grid, 0
    outside the picture (the spec's zero-MV fill)."""
    g = torch.nn.functional.pad(
        a.reshape(rn, cn), (max(-dc, 0), max(dc, 0), max(-dr, 0), max(dr, 0)))
    return g[max(dr, 0):max(dr, 0) + rn, max(dc, 0):max(dc, 0) + cn] \
        .reshape(-1)


def win_at_imv(ref: torch.Tensor, px, py, ix, iy, nn: int) -> torch.Tensor:
    """[B, nn, nn] int32 reference window at per-block integer MVs
    (border-clamped)."""
    Hh, Ww = ref.shape
    ar = torch.arange(nn, device=ref.device)
    rows = ((py + iy).long()[:, None] + ar[None, :]).clamp(0, Hh - 1)
    cols = ((px + ix).long()[:, None] + ar[None, :]).clamp(0, Ww - 1)
    return ref.reshape(-1)[rows[:, :, None] * Ww + cols[:, None, :]] \
        .to(torch.int32)


def bilerp_at_qmv(ref: torch.Tensor, px, py, qx, qy, nn: int):
    """[B, nn, nn] bilinear prediction at per-block quarter-pel MVs: the
    merge-candidate scoring metric (both the ME winner and the candidates
    are scored with it)."""
    fx, fy = qx & 3, qy & 3
    w = win_at_imv(ref, px, py, qx >> 2, qy >> 2, nn + 1)
    w00 = ((4 - fx) * (4 - fy))[:, None, None]
    w10 = (fx * (4 - fy))[:, None, None]
    w01 = ((4 - fx) * fy)[:, None, None]
    w11 = (fx * fy)[:, None, None]
    return (w00 * w[:, :nn, :nn] + w10 * w[:, :nn, 1:]
            + w01 * w[:, 1:, :nn] + w11 * w[:, 1:, 1:] + 8) >> 4


def _mv_bits(mx, my, states) -> torch.Tensor:
    """Estimated bits of one list's motion: both MVD components at the K9
    contexts (|mv| stands in for |mvd|) plus 2 for the mvp/merge flags."""
    return (BC.mvd_bits(mx, states) + BC.mvd_bits(my, states)) + 2.0


def _mc3(refs, px, py, mx, my, nn: int, ps: bool = False):
    """(y, u, v) predictions of every nn-block from the reference planes
    `refs` at quarter-pel MVs: pixels, or with ps the short-domain form."""
    luma = interp.mc_luma_qpel_ps if ps else interp.mc_luma_qpel
    chroma = interp.mc_chroma_qpel_ps if ps else interp.mc_chroma_qpel
    return (luma(refs[0], px, py, mx, my, nn),
            chroma(refs[1], px // 2, py // 2, mx, my, nn // 2),
            chroma(refs[2], px // 2, py // 2, mx, my, nn // 2))


# decision-dict keys of each size's motion: (pdir, L0 x, L0 y, L1 x, L1 y)
_MOTION_KEYS = {QT.N: ("pdir", "mvx", "mvy", "mv1x", "mv1y"),
                16: ("pdir4", "mv4x", "mv4y", "mv41x", "mv41y"),
                8: ("pdir8", "mv8x", "mv8y", "mv81x", "mv81y")}


class InterQTEncoder:
    """CTU32 depth-2 quadtree P- and B-frame encoder, one reference per
    list: dense decide, then (P) commit. Port of
    InterFrameEncoder._build_qt + _unpack_qt with bi=False and with
    bi=True, intra_in_b=False (max_depth=2, 8-bit, no HME / RQT / weighted
    prediction / RDOQ / sign hiding / psy-rd, loop filters off).

    Dense phase, for every block of every size (32, 16, 8): K1's frame
    sweep per list (the surface kernel, then the first-minimum argmin per
    size at lambda_bits 2), half- then quarter-pel SATD refinement on a
    gathered window, then the motion decision, then the leaf RD; then the
    bottom-up split decisions. The inter leaves' levels and recon are
    exact from the dense phase.

    P frames: merge-candidate RD of the ME winner against the left /
    above / above-right neighbours, the zero MV and the frame-median MV,
    all scored by bilinear-qpel SATD; the source-neighbour intra candidate
    at 32 and 16 (P slices have no 8x8 intra); the commit reconstructs the
    decided intra leaves over the inter ones.

    B frames (a second reference): per block the luma-only choice of L0,
    L1 or bi (SATD + lambda * MV bits, first minimum; bi predicts with
    add_avg of the two short-domain predictions), then the merge stage
    over the neighbours' (pdir, mv0, mv1), the zero candidate as bi zero
    MV and the two lists' median MVs as bi, scored by bilinear-qpel SATD
    (bi: the rounded mean of the two bilinear predictions). B slices have
    no intra candidate (--b-intra off), so the decided inter leaves are
    the frame: there is no commit."""

    def __init__(self, width: int, height: int, device):
        self.geo = QT.QtGeometry(height // QT.N, width // QT.N,
                                 torch.device(device))

    def _refine(self, nn: int, y32, ref_y, fine):
        """Every nn-block's quarter-pel ME winner around K1's integer
        winner: (mvx, mvy, satd)."""
        px, py = self.geo.pxpy[nn]
        fx, fy, _ = fine[nn]
        win = interp.gather_luma_window(ref_y, px, py, fx, fy, nn)
        dqx, dqy, satd = interp.subpel_refine_win(win, to_blocks(y32, nn),
                                                  nn)
        return fx * 4 + dqx, fy * 4 + dqy, satd

    def _merge_cands(self, nn: int, fields):
        """The spatial merge candidates of every nn-block from per-block
        fields: the left, above and above-right neighbours' values (0
        outside the picture), then the zero candidate."""
        rn, cn = self.geo.H // nn, self.geo.W // nn
        cands = [tuple(shift_grid(f, rn, cn, dr, dc) for f in fields)
                 for dr, dc in ((0, -1), (-1, 0), (-1, 1))]
        cands.append(tuple(torch.zeros_like(f) for f in fields))
        return cands

    def _motion(self, nn: int, y32, ref_y, mv, states, qp: int):
        """The P winner motion of every nn-block: (mvx, mvy) quarter-pel
        and its bits (MVD bits + 2, or the merge bits)."""
        px, py = self.geo.pxpy[nn]
        yb = to_blocks(y32, nn)
        mvx, mvy, _ = mv
        lam = torch.tensor(QT.lam(qp), device=y32.device)
        score = lambda cx, cy: pixel.satd(
            yb, bilerp_at_qmv(ref_y, px, py, cx, cy, nn))
        cands = self._merge_cands(nn, (mvx, mvy))
        cands.append((median_mv(mvx).expand(mvx.shape),
                      median_mv(mvy).expand(mvy.shape)))
        bx, by = mvx, mvy
        bb = _mv_bits(mvx, mvy, states)
        bcost = score(mvx, mvy).float() + lam * bb
        for idx, (cx, cy) in enumerate(cands):
            b = 2.0 + min(idx, 3)        # merge_flag + unary merge_idx
            c = score(cx, cy).float() + lam * b
            upd = c < bcost
            bx, by = torch.where(upd, cx, bx), torch.where(upd, cy, by)
            bb = torch.where(upd, b, bb)
            bcost = torch.minimum(c, bcost)
        return bx, by, bb

    def _motion_b(self, nn: int, y32, refs0, refs1, mv0, mv1, states,
                  qp: int):
        """The B winner motion of every nn-block: ((pdir, mv0x, mv0y, mv1x,
        mv1y) with an unused list's MV zero, the (y, u, v) prediction, the
        bits)."""
        px, py = self.geo.pxpy[nn]
        yb = to_blocks(y32, nn)
        lam = torch.tensor(QT.lam(qp), device=y32.device)
        (mv0x, mv0y, s0), (mv1x, mv1y, s1) = mv0, mv1
        sbi = pixel.satd(yb, interp.add_avg(
            interp.mc_luma_qpel_ps(refs0[0], px, py, mv0x, mv0y, nn),
            interp.mc_luma_qpel_ps(refs1[0], px, py, mv1x, mv1y, nn)))
        b0, b1 = _mv_bits(mv0x, mv0y, states), _mv_bits(mv1x, mv1y, states)
        bits = torch.stack([b0, b1 + 1.0, b0 + b1 + 2.0], 1)
        costs = torch.stack([s0 + lam * bits[:, 0], s1 + lam * bits[:, 1],
                             sbi + lam * bits[:, 2]], 1)
        sel = torch.argmin(costs, 1)           # the first minimum
        pdir = torch.where(sel == 2, 3, sel + 1).to(torch.int32)
        fb = bits.gather(1, sel[:, None])[:, 0]
        m0, m1 = pdir & 1, (pdir & 2) >> 1
        cur = (pdir, mv0x * m0, mv0y * m0, mv1x * m1, mv1y * m1)

        def score(cp, c0x, c0y, c1x, c1y):
            w0 = bilerp_at_qmv(refs0[0], px, py, c0x, c0y, nn)
            w1 = bilerp_at_qmv(refs1[0], px, py, c1x, c1y, nn)
            cp = cp[:, None, None]
            return pixel.satd(yb, torch.where(cp == 1, w0, torch.where(
                cp == 2, w1, (w0 + w1 + 1) >> 1)))

        fcost = score(*cur).float() + lam * fb
        cands = self._merge_cands(nn, cur)
        cands.append((torch.full_like(pdir, 3),
                      median_mv(mv0x).expand(mv0x.shape),
                      median_mv(mv0y).expand(mv0y.shape),
                      median_mv(mv1x).expand(mv1x.shape),
                      median_mv(mv1y).expand(mv1y.shape)))
        for idx, cand in enumerate(cands):
            # pdir 0 (outside the picture, the zero candidate): bi zero MV
            cand = (torch.where(cand[0] == 0, 3, cand[0]),) + cand[1:]
            b = 2.0 + min(idx, 3)
            c = score(*cand).float() + lam * b
            upd = c < fcost
            cur = tuple(torch.where(upd, a, f) for a, f in zip(cand, cur))
            fb = torch.where(upd, b, fb)
            fcost = torch.minimum(c, fcost)
        pdir = cur[0]
        m0, m1 = pdir & 1, (pdir & 2) >> 1
        mo = (pdir, cur[1] * m0, cur[2] * m0, cur[3] * m1, cur[4] * m1)
        # the full 3-plane prediction at the winner
        p0 = _mc3(refs0, px, py, mo[1], mo[2], nn)
        p1 = _mc3(refs1, px, py, mo[3], mo[4], nn)
        pbi = [interp.add_avg(a, b) for a, b in zip(
            _mc3(refs0, px, py, mo[1], mo[2], nn, ps=True),
            _mc3(refs1, px, py, mo[3], mo[4], nn, ps=True))]
        sel = pdir[:, None, None]
        pred = tuple(torch.where(sel == 1, a, torch.where(sel == 2, b, c))
                     for a, b, c in zip(p0, p1, pbi))
        return mo, pred, fb

    def encode_frame(self, y, u, v, ref_y, ref_u, ref_v, qp: int,
                     ref1=None) -> dict:
        """y, u, v: 8-bit planes padded to the coded size; ref_*: the L0
        reference picture's recon planes (numpy or device tensors, uint8);
        ref1: the L1 reference's (y, u, v) for a B frame, None for a P
        frame. Returns the decision dict (numpy) and "recon_dev", the recon
        planes as uint8 device tensors."""
        geo = self.geo
        dev = geo.device
        bi = ref1 is not None
        y8, u8, v8 = (_plane_u8(p, dev) for p in (y, u, v))
        r8 = [tuple(_plane_u8(p, dev) for p in (ref_y, ref_u, ref_v))]
        if bi:
            r8.append(tuple(_plane_u8(p, dev) for p in ref1))
        y32, u32, v32 = (p.to(torch.int32) for p in (y8, u8, v8))
        refs = [tuple(p.to(torch.int32) for p in r) for r in r8]
        qpc = chroma_qp_from_luma(qp)
        # K1 on the uint8 planes, per list: the surface, then each size's
        # argmin
        fine = [me.sad_sweep_multi(r[0], y8, (8, 16, QT.N), SEARCH_RANGE,
                                   lambda_bits=2) for r in r8]
        states = BC.init_states_dev(0 if bi else 1, qp)   # B / P contexts
        l2 = torch.tensor(QT.lam2(qp), device=dev)
        leaf, motion = {}, {}
        for nn in (QT.N, 16, 8):
            px, py = geo.pxpy[nn]
            mvs = [self._refine(nn, y32, r[0], f)
                   for r, f in zip(refs, fine)]
            if bi:
                motion[nn], epred, ebits_mv = self._motion_b(
                    nn, y32, refs[0], refs[1], *mvs, states, qp)
            else:
                bx, by, ebits_mv = self._motion(nn, y32, refs[0][0], mvs[0],
                                                states, qp)
                motion[nn] = (None, bx, by, None, None)
                epred = _mc3(refs[0], px, py, bx, by, nn)
            nb = px.shape[0]
            qp_blk = torch.full((nb,), qp, dtype=torch.int32, device=dev)
            qpc_blk = torch.full((nb,), qpc, dtype=torch.int32, device=dev)
            srcs3 = QT.sources3(y32, u32, v32, nn)
            # the inter rounding offset for both candidates (P and B)
            elv, erec, edist, ebits = QT.rd_leaf(nn, srcs3, epred, qp_blk,
                                                 qpc_blk, states, False)
            if bi or nn == 8:    # no intra in B slices, no 8x8 intra in P
                ui = torch.zeros(nb, dtype=torch.bool, device=dev)
                modes = torch.zeros(nb, dtype=torch.int32, device=dev)
                dist, bits = edist, ebits + ebits_mv
            else:
                modes, *ipred = QT.dense_intra(nn, y32, u32, v32)
                _, _, idist, ibits = QT.rd_leaf(nn, srcs3, ipred, qp_blk,
                                                qpc_blk, states, False)
                ci = idist + l2 * (ibits + QT.MODE_BITS)
                ce = edist + l2 * (ebits + ebits_mv)
                ui = ci < ce
                dist = torch.where(ui, idist, edist)
                bits = torch.where(ui, ibits + QT.MODE_BITS,
                                   ebits + ebits_mv)
            leaf[nn] = {"ui": ui, "modes": modes, "dist": dist,
                        "bits": bits, "elv": elv, "erec": erec}
        split16, split = QT.split_rd(leaf, geo, l2)

        # the inter leaves' recon and levels, each position from its level
        H, W, rows, cols = geo.H, geo.W, geo.rows, geo.cols
        lvl = torch.where(split.reshape(rows, cols), 1, 0) \
            .repeat_interleave(4, 0).repeat_interleave(4, 1)
        lvl = lvl + torch.where(split16.reshape(rows * 2, cols * 2), 1, 0) \
            .repeat_interleave(2, 0).repeat_interleave(2, 1) * lvl
        rec, lv = [], []
        for i, sub in enumerate((1, 2, 2)):
            up = lvl.repeat_interleave(8 // sub, 0) \
                .repeat_interleave(8 // sub, 1)
            for key, dst in (("erec", rec), ("elv", lv)):
                p = {nn: from_blocks(leaf[nn][key][i], nn // sub, H // sub,
                                     W // sub) for nn in (QT.N, 16, 8)}
                dst.append(torch.where(up == 2, p[8], torch.where(
                    up == 1, p[16], p[QT.N])).contiguous())

        h = lambda a: a.cpu().numpy()
        per_size = {QT.N: lambda a: h(a).reshape(rows, cols),
                    16: lambda a: QT.by_ctu(a, geo.map16, (rows, cols, 4)),
                    8: lambda a: QT.by_ctu(a, geo.map8, (rows, cols, 4, 4))}
        out = {"split": h(split).reshape(rows, cols), "tu_split32": None,
               "split16": per_size[16](split16)}
        for nn, (ki, km) in ((QT.N, ("use_intra", "modes")),
                             (16, ("use_intra4", "modes4")),
                             (8, ("use_intra8", "modes8"))):
            out[ki] = per_size[nn](leaf[nn]["ui"])
            out[km] = per_size[nn](leaf[nn]["modes"])
            for k, a in zip(_MOTION_KEYS[nn], motion[nn]):
                out[k] = None if a is None else per_size[nn](a)
        if not bi:
            leaves = QT.intra_leaves(
                out["split"].reshape(-1), out["split16"].reshape(-1, 4),
                out["modes"].reshape(-1), out["modes4"].reshape(-1, 4),
                None, out["use_intra"].reshape(-1),
                out["use_intra4"].reshape(-1, 4),
                np.zeros((rows * cols, 4, 4), bool))
            QT.commit_intra(leaves, geo, (y32, u32, v32), rec, lv, qp, qpc,
                            False)
        out.update(QT.decision_planes(geo, rec, lv))
        out["recon_dev"] = tuple(p.to(torch.uint8) for p in rec)
        return out
