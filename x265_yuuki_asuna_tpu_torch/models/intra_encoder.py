"""All-intra frame encoder on the uniform CU grid: a wavefront over CU
diagonals.

Port of the default branch of x265_yuuki_asuna_tpu/models/intra_encoder.py
(`_build` + `_unpack`: uniform grid, 8-bit 4:2:0, plain quant, no RDOQ /
sign hiding / noise reduction / scaling lists). The JAX program scans the
wavefront diagonals with `lax.scan` over fixed-width slots; here a Python
loop walks the diagonals and each step batches exactly that diagonal's
CUs (the JAX program's padding slots never reach its outputs, so the
results are the same). Each step predicts all 35 luma modes with one
matrix product, picks the SATD argmin, then transforms, quantizes and
reconstructs luma and the DM-mode chroma of its CUs.

The levels come back at full width (the JAX package's int8 compaction
only saves transfer bytes), so the decision dict equals
`IntraFrameEncoder._unpack(..., compact=False)`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitcost as BC
from ..ops import intra, pixel, quant, transforms
from ..utils.geometry import wavefront_schedule


def chroma_qp_from_luma(qp_y: int, offset: int = 0) -> int:
    """H.265 table 8-10 chroma QP mapping for 4:2:0."""
    qpi = min(max(qp_y + offset, 0), 57)
    if qpi < 30:
        return qpi
    if qpi > 43:
        return qpi - 6
    return [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37][qpi - 30]


def to_blocks(plane: torch.Tensor, nn: int) -> torch.Tensor:
    """[H, W] -> [ncu, nn, nn] in raster CU order."""
    hh, ww = plane.shape
    return (plane.reshape(hh // nn, nn, ww // nn, nn).permute(0, 2, 1, 3)
            .reshape(-1, nn, nn))


def from_blocks(blocks: torch.Tensor, nn: int, hh: int, ww: int):
    return (blocks.reshape(hh // nn, ww // nn, nn, nn).permute(0, 2, 1, 3)
            .reshape(hh, ww))


class Wavefront:
    """Static per-diagonal CU indices and intra neighbor lookups for one CU
    grid: for each diagonal, the CU indices, the state rows holding the
    left / top / top-right / top-left neighbors (the sentinel row `ncu`
    where a neighbor is unavailable) and the reference availability masks
    of the luma (n) and chroma (n/2) boundary vectors."""

    def __init__(self, rows: int, cols: int, n: int, device):
        nd, _, rc, valid = wavefront_schedule(rows, cols, slope=2)
        ncu = rows * cols
        self.steps = []
        for d in range(nd):
            r = rc[d, valid[d], 0].astype(np.int64)
            c = rc[d, valid[d], 1].astype(np.int64)
            cu = r * cols + c
            al, at = c > 0, r > 0
            atr, atl = (r > 0) & (c < cols - 1), (r > 0) & (c > 0)
            nbr = [np.where(al, cu - 1, ncu), np.where(at, cu - cols, ncu),
                   np.where(atr, cu - cols + 1, ncu),
                   np.where(atl, cu - cols - 1, ncu)]
            avail = {nn: np.concatenate([
                np.zeros((len(cu), nn), bool),
                np.repeat(al[:, None], nn, 1), atl[:, None],
                np.repeat(at[:, None], nn, 1),
                np.repeat(atr[:, None], nn, 1)], axis=1)
                for nn in (n, n // 2)}
            t = lambda a: torch.as_tensor(a, device=device)
            self.steps.append((t(cu), [t(x) for x in nbr],
                               {k: t(a) for k, a in avail.items()}))


def boundary_vector(botrow: torch.Tensor, rightcol: torch.Tensor, nbr,
                    nn: int) -> torch.Tensor:
    """Raw reference vector [S, 4nn+1] from the carried bottom-row /
    right-column state [ncu+1, nn]: below-left (never available),
    left bottom-to-top, corner, top, top-right."""
    left_cu, top_cu, tr_cu, tl_cu = nbr
    left = rightcol[left_cu]
    corner = botrow[tl_cu][:, nn - 1:nn]
    return torch.cat([left[:, nn - 1:nn].expand(-1, nn), left.flip(-1),
                      corner, botrow[top_cu], botrow[tr_cu]], dim=1)


def tq_recon(src: torch.Tensor, pred: torch.Tensor, qp: int, log2n: int,
             intra_slice: bool):
    """Transform, quantize, dequantize, inverse transform and reconstruct:
    (levels, recon) [B, n, n] int32."""
    coef = transforms.forward_transform(src - pred)
    levels = quant.quant(coef, qp, log2n, 8, intra_slice)
    rr = transforms.inverse_transform(quant.dequant(levels, qp, log2n))
    return levels, (pred + rr).clamp(0, 255)


class WaveState:
    """One frame's wavefront state on the device: the carried bottom row
    and right column of every CU's recon (luma; Cb and Cr side by side),
    with the sentinel row `ncu` left at the fill value, and the per-CU
    results committed so far."""

    def __init__(self, ncu: int, n: int, device):
        nc = n // 2
        self.n = n
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                       device=device)
        st = lambda k: torch.full((ncu + 1, k), 128, dtype=torch.int32,
                                  device=device)
        self.bry, self.rcy, self.bruv, self.rcuv = st(n), st(n), st(2 * nc), \
            st(2 * nc)
        self.modes = z(ncu)
        self.lv_y, self.rec_y = z(ncu, n, n), z(ncu, n, n)
        self.lv_c, self.rec_c = z(2, ncu, nc, nc), z(2, ncu, nc, nc)

    def luma_all_modes(self, nbr, avail) -> torch.Tensor:
        """All 35 luma intra predictions [S, 35, n, n] from the
        reconstructed neighbors."""
        v = intra.substitute_references(
            boundary_vector(self.bry, self.rcy, nbr, self.n), avail)
        return intra.predict_all_modes_matmul(v, self.n, luma=True)

    def chroma_dm(self, nbr, avail, modes) -> torch.Tensor:
        """Chroma intra predictions in the DM mode (= the luma mode),
        [2S, n/2, n/2]: the S Cb blocks, then the S Cr blocks."""
        nc = self.n // 2
        v = torch.cat([boundary_vector(self.bruv[:, :nc], self.rcuv[:, :nc],
                                       nbr, nc),
                       boundary_vector(self.bruv[:, nc:], self.rcuv[:, nc:],
                                       nbr, nc)])
        v = intra.substitute_references(v, avail.repeat(2, 1))
        return intra.predict_mode_matmul(v, modes.repeat(2), nc, luma=False)

    def commit(self, cu, modes, lv, rec, lvc, recc):
        """Store the results of the diagonal's CUs `cu` and their edges."""
        n, nc, S = self.n, self.n // 2, cu.shape[0]
        self.modes[cu] = modes.to(torch.int32)
        self.lv_y[cu], self.rec_y[cu] = lv, rec
        self.lv_c[:, cu] = lvc.reshape(2, S, nc, nc)
        self.rec_c[:, cu] = recc.reshape(2, S, nc, nc)
        self.bry[cu], self.rcy[cu] = rec[:, n - 1, :], rec[:, :, n - 1]
        self.bruv[cu] = torch.cat([recc[:S, nc - 1, :], recc[S:, nc - 1, :]],
                                  1)
        self.rcuv[cu] = torch.cat([recc[:S, :, nc - 1], recc[S:, :, nc - 1]],
                                  1)

    def result(self, rows: int, cols: int) -> dict:
        """Modes, levels and recon planes in the JAX package's decision
        dict layout (numpy)."""
        n, nc = self.n, self.n // 2
        H, W = rows * n, cols * n
        h = lambda t: t.cpu().numpy()
        return {
            "modes": h(self.modes).reshape(rows, cols),
            "levels_y": h(self.lv_y).reshape(rows, cols, n, n),
            "levels_cb": h(self.lv_c[0]).reshape(rows, cols, nc, nc),
            "levels_cr": h(self.lv_c[1]).reshape(rows, cols, nc, nc),
            "recon_y": h(from_blocks(self.rec_y, n, H, W)),
            "recon_u": h(from_blocks(self.rec_c[0], nc, H // 2, W // 2)),
            "recon_v": h(from_blocks(self.rec_c[1], nc, H // 2, W // 2)),
        }


def gather_mode(preds: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """preds [S, 35, n, n], modes [S] -> the chosen predictions [S, n, n]."""
    n = preds.shape[-1]
    return torch.gather(preds, 1, modes.reshape(-1, 1, 1, 1)
                        .expand(-1, 1, n, n))[:, 0]


def planes_to_blocks(y, u, v, n: int, device):
    """Host 8-bit planes -> int32 CU blocks on the device ([ncu, n, n]
    luma, [ncu, n/2, n/2] chroma)."""
    t = lambda p: torch.as_tensor(np.ascontiguousarray(p), device=device) \
        .to(torch.int32)
    return to_blocks(t(y), n), to_blocks(t(u), n // 2), \
        to_blocks(t(v), n // 2)


class IntraFrameEncoder:
    """Uniform-grid intra frame encoder for one (coded) geometry."""

    def __init__(self, width: int, height: int, cu_size: int, device):
        self.n = cu_size
        self.rows, self.cols = height // cu_size, width // cu_size
        self.device = torch.device(device)
        self.wave = Wavefront(self.rows, self.cols, cu_size, self.device)

    def encode_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     qp: int) -> dict:
        """y: [H, W] 8-bit pixels padded to the coded size; u, v: [H/2, W/2].
        Returns the decision dict (numpy): modes, levels_*, recon_*."""
        n = self.n
        log2n = n.bit_length() - 1
        qpc = chroma_qp_from_luma(qp)
        yb, ub, vb = planes_to_blocks(y, u, v, n, self.device)
        ws = WaveState(self.rows * self.cols, n, self.device)
        for cu, nbr, avail in self.wave.steps:
            # luma: all 35 modes, SATD argmin (first minimum)
            preds = ws.luma_all_modes(nbr, avail[n])
            src = yb[cu]
            m = torch.argmin(pixel.satd(src[:, None], preds), dim=1)
            lv, rec = tq_recon(src, gather_mode(preds, m), qp, log2n, True)
            # chroma, Cb and Cr in one batch
            lvc, recc = tq_recon(torch.cat([ub[cu], vb[cu]]),
                                 ws.chroma_dm(nbr, avail[n // 2], m), qpc,
                                 log2n - 1, True)
            ws.commit(cu, m, lv, rec, lvc, recc)
        return ws.result(self.rows, self.cols)


class IntraQTEncoder:
    """CTU32 depth-2 quadtree intra frame encoder: dense decide, then
    commit (port of IntraFrameEncoder._build_qt + _unpack_qt with
    max_depth=2, 8-bit, no RDOQ / sign hiding / psy-rd, loop filters off).

    Every CU size's intra mode is decided densely from source-pixel
    neighbours (the reference's fast-intra approximation); each leaf's RD
    (SSD + lambda2 * (K9 bits + MODE_BITS)) feeds the bottom-up split
    decisions; the commit then reconstructs the decided tree with true
    neighbour references (qt_common.commit_intra)."""

    def __init__(self, width: int, height: int, device):
        from . import qt_common as QT      # qt_common imports this module
        self.QT = QT
        self.geo = QT.QtGeometry(height // QT.N, width // QT.N,
                                 torch.device(device))

    def encode_frame(self, y, u, v, qp: int) -> dict:
        """y, u, v: 8-bit planes padded to the coded size (numpy or device
        tensors). Returns the decision dict (numpy) and "recon_dev", the
        recon planes as uint8 device tensors."""
        QT, geo = self.QT, self.geo
        dev = geo.device
        pl = lambda p: torch.as_tensor(np.array(p, np.int32), device=dev)
        y32, u32, v32 = pl(y), pl(u), pl(v)
        qpc = chroma_qp_from_luma(qp)
        states = BC.init_states_dev(2, qp)       # I-slice contexts
        leaf = {}
        for nn in (QT.N, 16, 8):
            modes, py, pu, pv = QT.dense_intra(nn, y32, u32, v32)
            nb = modes.shape[0]
            qp_blk = torch.full((nb,), qp, dtype=torch.int32, device=dev)
            qpc_blk = torch.full((nb,), qpc, dtype=torch.int32, device=dev)
            _, _, dist, bits = QT.rd_leaf(nn, QT.sources3(y32, u32, v32, nn),
                                          (py, pu, pv), qp_blk, qpc_blk,
                                          states, True)
            leaf[nn] = {"modes": modes, "dist": dist,
                        "bits": bits + QT.MODE_BITS}
        l2 = torch.tensor(QT.lam2(qp), device=dev)
        split16, split = QT.split_rd(leaf, geo, l2)

        rows, cols = geo.rows, geo.cols
        h = lambda a: a.cpu().numpy()
        out = {"split": h(split).reshape(rows, cols),
               "modes": h(leaf[QT.N]["modes"]).reshape(rows, cols),
               "modes4": QT.by_ctu(leaf[16]["modes"], geo.map16,
                                   (rows, cols, 4)),
               "split16": QT.by_ctu(split16, geo.map16, (rows, cols, 4)),
               "modes8": QT.by_ctu(leaf[8]["modes"], geo.map8,
                                   (rows, cols, 4, 4))}
        z = lambda p: torch.zeros_like(p)
        rec = (z(y32), z(u32), z(v32))
        lv = (z(y32), z(u32), z(v32))
        leaves = QT.intra_leaves(out["split"].reshape(-1),
                                 out["split16"].reshape(-1, 4),
                                 out["modes"].reshape(-1),
                                 out["modes4"].reshape(-1, 4),
                                 out["modes8"].reshape(-1, 4, 4))
        QT.commit_intra(leaves, geo, (y32, u32, v32), rec, lv, qp, qpc, True)
        out.update(QT.decision_planes(geo, rec, lv))
        out["recon_dev"] = tuple(p.to(torch.uint8) for p in rec)
        return out
