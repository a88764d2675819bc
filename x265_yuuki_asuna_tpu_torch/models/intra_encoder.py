"""All-intra frame encoder on the uniform CU grid: a wavefront over CU
diagonals.

Port of the default branch of x265_yuuki_asuna_tpu/models/intra_encoder.py
(`_build` + `_unpack`, and `submit_frames` / `collect_frames` /
`encode_frames` for batches of frames: uniform grid of 16x16 or 32x32
CUs, 4:2:0 at 8, 10 or 12 bits (the quantizer's), plain quant (with the
scaling lists' matrices when the quantizer has them), sign-bit hiding
or static-bit RDOQ with psy-RDOQ, or transquant bypass (lossless: the
levels are the residual and the recon is the source), one QP or a
per-CU QP map per frame; no noise reduction). The JAX program scans the
wavefront diagonals with `lax.scan` over fixed-width slots; here a
Python loop walks the
diagonals and each step batches exactly that diagonal's CUs (the JAX
program's padding slots never reach its outputs, so the results are the
same), of every frame of a batch at once: frames are independent, so F
frames share each step's launches with their CUs stacked on the block
axis. Each step predicts all 35 luma modes with one matrix product, picks
the SATD argmin, then transforms, quantizes and reconstructs luma and the
DM-mode chroma of its CUs.

The levels come back at full width, so the decision dict equals
`IntraFrameEncoder._unpack(..., compact=False)`. The JAX program packs
levels into int8 lanes for its transfer and reruns a frame whose levels
overflow int8 through an int16 variant (`_full`; lossless always takes
the int16 form); the port has no packing to overflow, so it has no
rerun.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitcost as BC
from ..ops import intra, pixel, transforms
from ..ops.quant import PLAIN, Quantizer
from ..utils.geometry import wavefront_schedule


def chroma_qp_from_luma(qp_y: int, offset: int = 0) -> int:
    """H.265 table 8-10 chroma QP mapping for 4:2:0."""
    qpi = min(max(qp_y + offset, 0), 57)
    if qpi < 30:
        return qpi
    if qpi > 43:
        return qpi - 6
    return [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37][qpi - 30]


def cu_qps(qp, n: int, device):
    """(luma, chroma) QPs of n blocks: ints for one QP (qp an int), else
    int32 tensors [n] from a per-block QP array (AQ / cuTree), the chroma
    QP of each through table 8-10."""
    if np.ndim(qp) == 0:
        return int(qp), chroma_qp_from_luma(int(qp))
    q = torch.as_tensor(np.array(qp, np.int32).reshape(-1), device=device)
    if q.numel() != n:
        raise ValueError(f"{q.numel()} QPs for {n} blocks")
    tab = torch.tensor([chroma_qp_from_luma(k) for k in range(58)],
                       dtype=torch.int32, device=device)
    return q, tab[q.clamp(0, 57).long()]


def cb_cr(qc):
    """The chroma QPs of a batch of Cb blocks followed by their Cr
    blocks."""
    return qc if isinstance(qc, int) else qc.repeat(2)


def to_blocks(plane: torch.Tensor, nn: int) -> torch.Tensor:
    """[H, W] -> [ncu, nn, nn] in raster CU order."""
    hh, ww = plane.shape
    return (plane.reshape(hh // nn, nn, ww // nn, nn).permute(0, 2, 1, 3)
            .reshape(-1, nn, nn))


def from_blocks(blocks: torch.Tensor, nn: int, hh: int, ww: int):
    return (blocks.reshape(hh // nn, ww // nn, nn, nn).permute(0, 2, 1, 3)
            .reshape(hh, ww))


class Wavefront:
    """Static per-diagonal CU indices and intra neighbor lookups for F
    frames of one CU grid, the frames' CUs numbered f * ncu + cu: for each
    diagonal, the CU indices of every frame, the state rows holding the
    left / top / top-right / top-left neighbors (the sentinel row F * ncu
    where a neighbor is unavailable) and the reference availability masks
    of the luma (n) and chroma (n/2) boundary vectors."""

    def __init__(self, rows: int, cols: int, n: int, device, frames: int = 1):
        nd, _, rc, valid = wavefront_schedule(rows, cols, slope=2)
        ncu = rows * cols
        fo = np.arange(frames)[:, None] * ncu          # frame offsets
        self.steps = []
        for d in range(nd):
            r = rc[d, valid[d], 0].astype(np.int64)
            c = rc[d, valid[d], 1].astype(np.int64)
            cu = r * cols + c
            al, at = c > 0, r > 0
            atr, atl = (r > 0) & (c < cols - 1), (r > 0) & (c > 0)
            nbr = [np.where(a, (fo + k).reshape(-1), frames * ncu)
                   for a, k in ((np.tile(al, frames), cu - 1),
                                (np.tile(at, frames), cu - cols),
                                (np.tile(atr, frames), cu - cols + 1),
                                (np.tile(atl, frames), cu - cols - 1))]
            avail = {nn: np.tile(np.concatenate([
                np.zeros((len(cu), nn), bool),
                np.repeat(al[:, None], nn, 1), atl[:, None],
                np.repeat(at[:, None], nn, 1),
                np.repeat(atr[:, None], nn, 1)], axis=1), (frames, 1))
                for nn in (n, n // 2)}
            t = lambda a: torch.as_tensor(a, device=device)
            self.steps.append((t((fo + cu).reshape(-1)), [t(x) for x in nbr],
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


def tq_recon(src: torch.Tensor, pred: torch.Tensor, qp, log2n: int,
             intra_slice: bool, quant_fn: Quantizer = PLAIN, luma=True,
             modes=None, is_intra=None, states=None):
    """Transform, quantize (quant_fn, with the blocks' luma flag, modes,
    intra flags and the slice's frozen contexts), dequantize, inverse
    transform and reconstruct at quant_fn's bit depth: (levels, recon)
    [B, n, n] int32."""
    bd = quant_fn.bit_depth
    coef = transforms.forward_transform(src - pred, bd)
    levels = quant_fn(coef, qp, log2n, intra_slice, luma, modes, is_intra,
                      states)
    rr = transforms.inverse_transform(quant_fn.dequant(levels, qp, log2n,
                                                       luma), bd)
    return levels, (pred + rr).clamp(0, pixel.peak(bd))


class WaveState:
    """One frame's wavefront state on the device: the carried bottom row
    and right column of every CU's recon (luma; Cb and Cr side by side),
    with the sentinel row `ncu` left at the fill value 1 << (bd - 1), and
    the per-CU results committed so far."""

    def __init__(self, ncu: int, n: int, device, bit_depth: int = 8):
        nc = n // 2
        self.n, self.bd = n, bit_depth
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                       device=device)
        st = lambda k: torch.full((ncu + 1, k), 1 << (bit_depth - 1),
                                  dtype=torch.int32, device=device)
        self.bry, self.rcy, self.bruv, self.rcuv = st(n), st(n), st(2 * nc), \
            st(2 * nc)
        self.modes = z(ncu)
        self.lv_y, self.rec_y = z(ncu, n, n), z(ncu, n, n)
        self.lv_c, self.rec_c = z(2, ncu, nc, nc), z(2, ncu, nc, nc)

    def luma_all_modes(self, nbr, avail) -> torch.Tensor:
        """All 35 luma intra predictions [S, 35, n, n] from the
        reconstructed neighbors."""
        v = intra.substitute_references(
            boundary_vector(self.bry, self.rcy, nbr, self.n), avail, self.bd)
        return intra.predict_all_modes_matmul(v, self.n, self.bd, luma=True)

    def chroma_dm(self, nbr, avail, modes) -> torch.Tensor:
        """Chroma intra predictions in the DM mode (= the luma mode),
        [2S, n/2, n/2]: the S Cb blocks, then the S Cr blocks."""
        nc = self.n // 2
        v = torch.cat([boundary_vector(self.bruv[:, :nc], self.rcuv[:, :nc],
                                       nbr, nc),
                       boundary_vector(self.bruv[:, nc:], self.rcuv[:, nc:],
                                       nbr, nc)])
        v = intra.substitute_references(v, avail.repeat(2, 1), self.bd)
        return intra.predict_mode_matmul(v, modes.repeat(2), nc, self.bd,
                                         luma=False)

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

    def result(self, rows: int, cols: int, frames: int = 1) -> list:
        """Each frame's modes, levels and recon planes in the JAX
        package's decision dict layout (numpy)."""
        n, nc = self.n, self.n // 2
        H, W = rows * n, cols * n
        h = lambda t: t.cpu().numpy()
        modes, lv_y, lv_c = h(self.modes), h(self.lv_y), h(self.lv_c)
        rec_y, rec_c = self.rec_y, self.rec_c
        ncu = rows * cols
        out = []
        for f in range(frames):
            s = slice(f * ncu, (f + 1) * ncu)
            out.append({
                "modes": modes[s].reshape(rows, cols),
                "levels_y": lv_y[s].reshape(rows, cols, n, n),
                "levels_cb": lv_c[0, s].reshape(rows, cols, nc, nc),
                "levels_cr": lv_c[1, s].reshape(rows, cols, nc, nc),
                "recon_y": h(from_blocks(rec_y[s], n, H, W)),
                "recon_u": h(from_blocks(rec_c[0, s], nc, H // 2, W // 2)),
                "recon_v": h(from_blocks(rec_c[1, s], nc, H // 2, W // 2)),
            })
        return out


def gather_mode(preds: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """preds [S, 35, n, n], modes [S] -> the chosen predictions [S, n, n]."""
    n = preds.shape[-1]
    return torch.gather(preds, 1, modes.reshape(-1, 1, 1, 1)
                        .expand(-1, 1, n, n))[:, 0]


def planes_to_blocks(y, u, v, n: int, device):
    """Host planes -> int32 CU blocks on the device ([ncu, n, n]
    luma, [ncu, n/2, n/2] chroma)."""
    t = lambda p: torch.as_tensor(np.ascontiguousarray(p), device=device) \
        .to(torch.int32)
    return to_blocks(t(y), n), to_blocks(t(u), n // 2), \
        to_blocks(t(v), n // 2)


class IntraFrameEncoder:
    """Uniform-grid intra frame encoder for one (coded) geometry and CU
    size (16 or 32); quant_fn picks the levels (plain, sign-bit hiding or
    static RDOQ, with or without scaling lists); lossless bypasses
    transform and quantization (the levels are the residual, the recon
    the source)."""

    def __init__(self, width: int, height: int, cu_size: int, device,
                 quant_fn: Quantizer = PLAIN, lossless: bool = False):
        self.n = cu_size
        self.lossless = bool(lossless)
        self.rows, self.cols = height // cu_size, width // cu_size
        self.device = torch.device(device)
        self.quant_fn = quant_fn
        self._waves = {}

    def wave(self, frames: int) -> Wavefront:
        if frames not in self._waves:
            self._waves[frames] = Wavefront(self.rows, self.cols, self.n,
                                            self.device, frames)
        return self._waves[frames]

    def encode_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     qp) -> dict:
        """y: [H, W] pixels padded to the coded size; u, v: [H/2, W/2];
        qp: one QP, or the per-CU QP map ([rows, cols] or [ncu]). Returns
        the decision dict (numpy): modes, levels_*, recon_*."""
        return self.encode_frames([y], [u], [v],
                                  qp if np.ndim(qp) == 0 else [qp])[0]

    def encode_frames(self, ys, us, vs, qp) -> list:
        """A batch of independent frames (sequences of padded planes), each
        wavefront step batching the step's CUs of every frame; one
        decision dict per frame, each equal to its frame's encode_frame.
        qp: one QP for every CU, or a per-CU QP map for each frame (a
        sequence of F [rows, cols] or [ncu] arrays)."""
        n, F = self.n, len(ys)
        log2n = n.bit_length() - 1
        qp, qpc = cu_qps(qp, F * self.rows * self.cols, self.device)
        at = lambda q, cu: q if isinstance(q, int) else q[cu]
        blk = [planes_to_blocks(y, u, v, n, self.device)
               for y, u, v in zip(ys, us, vs)]
        yb, ub, vb = (torch.cat([b[i] for b in blk]) for i in range(3))
        ws = WaveState(F * self.rows * self.cols, n, self.device,
                       self.quant_fn.bit_depth)
        q = self.quant_fn
        for cu, nbr, avail in self.wave(F).steps:
            # luma: all 35 modes, SATD argmin (first minimum)
            preds = ws.luma_all_modes(nbr, avail[n])
            src = yb[cu]
            m = torch.argmin(pixel.satd(src[:, None], preds), dim=1)
            srcc = torch.cat([ub[cu], vb[cu]])     # Cb and Cr in one batch
            predc = ws.chroma_dm(nbr, avail[n // 2], m)
            if self.lossless:
                lv, rec = src - gather_mode(preds, m), src
                lvc, recc = srcc - predc, srcc
            else:
                lv, rec = tq_recon(src, gather_mode(preds, m), at(qp, cu),
                                   log2n, True, q, True, m)
                lvc, recc = tq_recon(srcc, predc, cb_cr(at(qpc, cu)),
                                     log2n - 1, True, q, False, m.repeat(2))
            ws.commit(cu, m, lv, rec, lvc, recc)
        return ws.result(self.rows, self.cols, F)


class IntraQTEncoder:
    """CTU32 quadtree intra frame encoder: dense decide, commit, then the
    in-loop filters (port of IntraFrameEncoder._build_qt + _unpack_qt with
    max_depth 1 (CUs 32 and 16) or 2 (down to 8), at quant_fn's bit
    depth; quant_fn: plain,
    mode-dependent
    sign-bit hiding or context RDOQ; psy_rd: the psycho-visual term of
    the leaf RD; with the device-DPB filter chain when deblock or sao is
    set).

    Every CU size's intra mode is decided densely from source-pixel
    neighbours (the reference's fast-intra approximation); each leaf's RD
    (SSD + lambda2 * (K9 bits + MODE_BITS)) feeds the bottom-up split
    decisions; the commit then reconstructs the decided tree with true
    neighbour references (qt_common.commit_intra)."""

    def __init__(self, width: int, height: int, device,
                 deblock: bool = False, sao: bool = False,
                 quant_fn: Quantizer = PLAIN, sao_form: str = "program",
                 recon_host: bool = True, psy_rd: float = 0.0,
                 max_depth: int = 2):
        from . import qt_common as QT      # qt_common imports this module
        self.QT = QT
        self.sizes = QT.sizes_of(max_depth)
        self.quant_fn = quant_fn
        self.psy_rd = psy_rd
        self.geo = QT.QtGeometry(height // QT.N, width // QT.N,
                                 torch.device(device))
        self.bd = quant_fn.bit_depth
        self.filters = QT.LoopFilters(deblock, sao, sao_form, self.bd)
        # the decision dict carries the recon planes on the host
        # (recon_y / _u / _v); off, only recon_dev holds them
        self.recon_host = recon_host

    def encode_frame(self, y, u, v, qp, with_sao: bool = True,
                     slice_qp: int = None) -> dict:
        """y, u, v: planes padded to the coded size (numpy); qp: one QP or
        the per-CTU QP map (AQ / cuTree), slice_qp the slice's (the
        filters' default QP; default the map's largest). Returns the
        decision dict (numpy), "recon_dev", the (filtered) recon planes as
        device tensors (uint8 at 8 bits, int16 above), and with SAO "sao",
        its parameters packed [ncu, 18] (with_sao=False: this frame
        without SAO)."""
        QT, geo = self.QT, self.geo
        dev = geo.device
        pl = lambda p: torch.as_tensor(np.array(p, np.int32), device=dev)
        y32, u32, v32 = pl(y), pl(u), pl(v)
        fq = QT.FrameQp(geo, qp, slice_qp)
        # I-slice contexts, at the first CTU's QP as in the reference
        states = BC.init_states_dev(2, fq.first)
        leaf = {}
        for nn in self.sizes:
            modes, py, pu, pv = QT.dense_intra(nn, y32, u32, v32, self.bd)
            _, _, dist, bits = QT.rd_leaf(nn, QT.sources3(y32, u32, v32, nn),
                                          (py, pu, pv), fq.blk(nn, fq.cu),
                                          fq.blk(nn, fq.c), states, True,
                                          self.quant_fn, modes, self.psy_rd)
            leaf[nn] = {"modes": modes, "dist": dist,
                        "bits": bits + QT.MODE_BITS}
        split16, split = QT.split_rd(leaf, geo, QT.lam2(fq.cu))

        rows, cols = geo.rows, geo.cols
        h = lambda a: a.cpu().numpy()
        out = {"split": h(split).reshape(rows, cols),
               "modes": h(leaf[QT.N]["modes"]).reshape(rows, cols),
               "modes4": QT.by_ctu(leaf[16]["modes"], geo.map16,
                                   (rows, cols, 4)),
               "split16": None, "modes8": None}
        if split16 is not None:
            out["split16"] = QT.by_ctu(split16, geo.map16, (rows, cols, 4))
            out["modes8"] = QT.by_ctu(leaf[8]["modes"], geo.map8,
                                      (rows, cols, 4, 4))
        z = lambda p: torch.zeros_like(p)
        rec = (z(y32), z(u32), z(v32))
        lv = (z(y32), z(u32), z(v32))
        rs = lambda a, *shape: None if a is None else a.reshape(-1, *shape)
        leaves = QT.intra_leaves(out["split"].reshape(-1),
                                 rs(out["split16"], 4),
                                 out["modes"].reshape(-1),
                                 out["modes4"].reshape(-1, 4),
                                 rs(out["modes8"], 4, 4))
        QT.commit_intra(leaves, geo, (y32, u32, v32), rec, lv, fq, True,
                        self.quant_fn, states)
        rec, sao = self.filters(rec, (y32, u32, v32), lv, fq, split, split16,
                                with_sao=with_sao)
        if sao is not None:
            out["sao"] = sao
        out.update(QT.decision_planes(geo, rec, lv, self.recon_host))
        out["recon_dev"] = tuple(p.to(pixel.plane_dtype(self.bd))
                                 for p in rec)
        return out
