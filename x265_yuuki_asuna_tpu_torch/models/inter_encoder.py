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
# CTU32 depth-2 quadtree P frames
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


class InterQTEncoder:
    """CTU32 depth-2 quadtree P-frame encoder, one L0 reference: dense
    decide, then commit (port of InterFrameEncoder._build_qt with bi=False
    + _unpack_qt: max_depth=2, 8-bit, no HME / RQT / weighted prediction /
    RDOQ / sign hiding / psy-rd, loop filters off).

    Dense phase, for every block of every size (32, 16, 8): K1's frame
    sweep (the surface kernel, then the first-minimum argmin per size at
    lambda_bits 2), half- then quarter-pel SATD refinement on a gathered
    window, merge-candidate RD (left / above / above-right neighbours, the
    zero MV and the frame-median MV, all scored by bilinear-qpel SATD),
    the source-neighbour intra candidate at 32 and 16 (P slices have no
    8x8 intra), and the leaf RD of both candidates; then the bottom-up
    split decisions. The inter leaves' levels and recon are exact from the
    dense phase; the commit reconstructs the intra leaves over them."""

    def __init__(self, width: int, height: int, device):
        self.geo = QT.QtGeometry(height // QT.N, width // QT.N,
                                 torch.device(device))

    def _motion(self, nn: int, y32, ref_y, fine, states, qp: int):
        """The winner motion of every nn-block: (mvx, mvy) quarter-pel and
        its bits (MVD bits + 2, or the merge bits)."""
        geo = self.geo
        px, py = geo.pxpy[nn]
        yb = to_blocks(y32, nn)
        fx, fy, _ = fine[nn]
        win = interp.gather_luma_window(ref_y, px, py, fx, fy, nn)
        dqx, dqy, _ = interp.subpel_refine_win(win, yb, nn)
        mvx, mvy = fx * 4 + dqx, fy * 4 + dqy
        lam = torch.tensor(QT.lam(qp), device=y32.device)
        score = lambda cx, cy: pixel.satd(
            yb, bilerp_at_qmv(ref_y, px, py, cx, cy, nn))
        rn, cn = geo.H // nn, geo.W // nn
        cands = [(shift_grid(mvx, rn, cn, dr, dc),
                  shift_grid(mvy, rn, cn, dr, dc))
                 for dr, dc in ((0, -1), (-1, 0), (-1, 1))]
        cands.append((torch.zeros_like(mvx), torch.zeros_like(mvy)))
        cands.append((median_mv(mvx).expand(mvx.shape),
                      median_mv(mvy).expand(mvy.shape)))
        bx, by = mvx, mvy
        bb = (BC.mvd_bits(mvx, states) + BC.mvd_bits(mvy, states)) + 2.0
        bcost = score(mvx, mvy).float() + lam * bb
        for idx, (cx, cy) in enumerate(cands):
            b = 2.0 + min(idx, 3)        # merge_flag + unary merge_idx
            c = score(cx, cy).float() + lam * b
            upd = c < bcost
            bx, by = torch.where(upd, cx, bx), torch.where(upd, cy, by)
            bb = torch.where(upd, b, bb)
            bcost = torch.minimum(c, bcost)
        return bx, by, bb

    def encode_frame(self, y, u, v, ref_y, ref_u, ref_v, qp: int) -> dict:
        """y, u, v: 8-bit planes padded to the coded size; ref_*: the
        reference picture's recon planes (numpy or device tensors, uint8).
        Returns the decision dict (numpy) and "recon_dev", the recon
        planes as uint8 device tensors."""
        geo = self.geo
        dev = geo.device
        y8, u8, v8 = (_plane_u8(p, dev) for p in (y, u, v))
        r8 = tuple(_plane_u8(p, dev) for p in (ref_y, ref_u, ref_v))
        y32, u32, v32 = (p.to(torch.int32) for p in (y8, u8, v8))
        refs = tuple(p.to(torch.int32) for p in r8)
        qpc = chroma_qp_from_luma(qp)
        # K1 on the uint8 planes: the surface, then each size's argmin
        fine = me.sad_sweep_multi(r8[0], y8, (8, 16, QT.N), SEARCH_RANGE,
                                  lambda_bits=2)
        states = BC.init_states_dev(1, qp)       # P-slice contexts
        l2 = torch.tensor(QT.lam2(qp), device=dev)
        leaf, motion = {}, {}
        for nn in (QT.N, 16, 8):
            px, py = geo.pxpy[nn]
            bx, by, ebits_mv = self._motion(nn, y32, refs[0], fine, states,
                                            qp)
            epred = (interp.mc_luma_qpel(refs[0], px, py, bx, by, nn),
                     interp.mc_chroma_qpel(refs[1], px // 2, py // 2, bx, by,
                                           nn // 2),
                     interp.mc_chroma_qpel(refs[2], px // 2, py // 2, bx, by,
                                           nn // 2))
            nb = bx.shape[0]
            qp_blk = torch.full((nb,), qp, dtype=torch.int32, device=dev)
            qpc_blk = torch.full((nb,), qpc, dtype=torch.int32, device=dev)
            srcs3 = QT.sources3(y32, u32, v32, nn)
            # the P slice's inter rounding offset for both candidates
            elv, erec, edist, ebits = QT.rd_leaf(nn, srcs3, epred, qp_blk,
                                                 qpc_blk, states, False)
            if nn == 8:                  # no 8x8 intra in P slices
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
            motion[nn] = (bx, by)
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
        m16 = lambda a: QT.by_ctu(a, geo.map16, (rows, cols, 4))
        m8 = lambda a: QT.by_ctu(a, geo.map8, (rows, cols, 4, 4))
        out = {"split": h(split).reshape(rows, cols), "tu_split32": None,
               "use_intra": h(leaf[QT.N]["ui"]).reshape(rows, cols),
               "modes": h(leaf[QT.N]["modes"]).reshape(rows, cols),
               "mvx": h(motion[QT.N][0]).reshape(rows, cols),
               "mvy": h(motion[QT.N][1]).reshape(rows, cols),
               "use_intra4": m16(leaf[16]["ui"]),
               "modes4": m16(leaf[16]["modes"]),
               "mv4x": m16(motion[16][0]), "mv4y": m16(motion[16][1]),
               "split16": m16(split16), "use_intra8": m8(leaf[8]["ui"]),
               "modes8": m8(leaf[8]["modes"]),
               "mv8x": m8(motion[8][0]), "mv8y": m8(motion[8][1])}
        for k in ("mv81x", "mv81y", "pdir", "pdir4", "pdir8", "mv1x",
                  "mv1y", "mv41x", "mv41y"):
            out[k] = None
        leaves = QT.intra_leaves(
            out["split"].reshape(-1), out["split16"].reshape(-1, 4),
            out["modes"].reshape(-1), out["modes4"].reshape(-1, 4), None,
            out["use_intra"].reshape(-1), out["use_intra4"].reshape(-1, 4),
            np.zeros((rows * cols, 4, 4), bool))
        QT.commit_intra(leaves, geo, (y32, u32, v32), rec, lv, qp, qpc,
                        False)
        out.update(QT.decision_planes(geo, rec, lv))
        out["recon_dev"] = tuple(p.to(torch.uint8) for p in rec)
        return out
