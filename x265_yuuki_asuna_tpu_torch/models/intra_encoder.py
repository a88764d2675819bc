"""All-intra frame encoder on the uniform CU grid: a wavefront over CU
diagonals.

Port of the default branch of x265_yuuki_asuna_tpu/models/intra_encoder.py
(`_build` + `_unpack`, and `submit_frames` / `collect_frames` /
`encode_frames` for batches of frames: uniform grid of 16x16 or 32x32
CUs, 4:2:0 or 4:4:4 at 8, 10 or 12 bits (the quantizer's), plain quant
(with the scaling lists' matrices when the quantizer has them),
sign-bit hiding or static-bit RDOQ with psy-RDOQ, or transquant bypass
(lossless: the levels are the residual and the recon is the source),
one QP or a per-CU QP map per frame, noise reduction (the `nr_off`
inputs and |coef| sums) and fast intra (modes decided from the source
before the wavefront: `decide_modes_from_source`)), and of its CTU64
quadtree (`_build_qt64` + `_unpack_qt64`, IntraQT64Encoder below). The
JAX program scans the wavefront diagonals with `lax.scan` over
fixed-width slots; here a Python loop walks the diagonals and each step
batches exactly that diagonal's CUs (the JAX
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

import math
import time

import numpy as np
import torch

from ..ops import bitcost as BC
from ..ops import fp32
from ..ops import intra, pixel, quant, transforms
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


# ChromaArrayType 3 (4:4:4): QpC = min(qPi, 51), no table (spec 8.6.1)
CHROMA_QP_TABLE_444 = np.minimum(np.arange(58), 51).astype(np.int32)


def chroma_qp(qp_y: int, i444: bool = False) -> int:
    """The chroma QP of a luma QP: table 8-10 in 4:2:0, min(QP, 51) in
    4:4:4."""
    return int(CHROMA_QP_TABLE_444[min(max(qp_y, 0), 57)]) if i444 \
        else chroma_qp_from_luma(qp_y)


def cu_qps(qp, n: int, device, i444: bool = False):
    """(luma, chroma) QPs of n blocks: ints for one QP (qp an int), else
    int32 tensors [n] from a per-block QP array (AQ / cuTree), the chroma
    QP of each through table 8-10 (4:4:4: CHROMA_QP_TABLE_444)."""
    if np.ndim(qp) == 0:
        return int(qp), chroma_qp(int(qp), i444)
    q = torch.as_tensor(np.array(qp, np.int32).reshape(-1), device=device)
    if q.numel() != n:
        raise ValueError(f"{q.numel()} QPs for {n} blocks")
    tab = torch.tensor([chroma_qp(k, i444) for k in range(58)],
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
    of the luma (n) and 4:2:0 chroma (n/2) boundary vectors (4:4:4 chroma
    takes luma's)."""

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
             modes=None, is_intra=None, states=None, denoise=None):
    """Transform, quantize (quant_fn, with the blocks' luma flag, modes,
    intra flags and the slice's frozen contexts), dequantize, inverse
    transform and reconstruct at quant_fn's bit depth: (levels, recon)
    [B, n, n] int32. denoise: a function of the coefficients applied
    before quantization (noise reduction)."""
    bd = quant_fn.bit_depth
    coef = transforms.forward_transform(src - pred, bd)
    if denoise is not None:
        coef = denoise(coef)
    levels = quant_fn(coef, qp, log2n, intra_slice, luma, modes, is_intra,
                      states)
    rr = transforms.inverse_transform(quant_fn.dequant(levels, qp, log2n,
                                                       luma), bd)
    return levels, (pred + rr).clamp(0, pixel.peak(bd))


class WaveState:
    """One frame's wavefront state on the device: the carried bottom row
    and right column of every CU's recon (luma; Cb and Cr side by side),
    with the sentinel row `ncu` left at the fill value 1 << (bd - 1), and
    the per-CU results committed so far. Chroma blocks are n/2 (4:2:0) or
    n (i444: 4:4:4) wide."""

    def __init__(self, ncu: int, n: int, device, bit_depth: int = 8,
                 i444: bool = False):
        nc = n if i444 else n // 2
        self.n, self.nc, self.bd, self.i444 = n, nc, bit_depth, i444
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

    def luma_mode(self, nbr, avail, modes) -> torch.Tensor:
        """The luma predictions [S, n, n] in given modes (fast intra)."""
        v = intra.substitute_references(
            boundary_vector(self.bry, self.rcy, nbr, self.n), avail, self.bd)
        return intra.predict_mode_matmul(v, modes, self.n, self.bd,
                                         luma=True)

    def chroma_dm(self, nbr, avail, modes) -> torch.Tensor:
        """Chroma intra predictions in the DM mode (= the luma mode),
        [2S, nc, nc]: the S Cb blocks, then the S Cr blocks."""
        nc = self.nc
        v = torch.cat([boundary_vector(self.bruv[:, :nc], self.rcuv[:, :nc],
                                       nbr, nc),
                       boundary_vector(self.bruv[:, nc:], self.rcuv[:, nc:],
                                       nbr, nc)])
        v = intra.substitute_references(v, avail.repeat(2, 1), self.bd)
        return intra.predict_mode_matmul(v, modes.repeat(2), nc, self.bd,
                                         luma=False, chroma444=self.i444)

    def commit(self, cu, modes, lv, rec, lvc, recc):
        """Store the results of the diagonal's CUs `cu` and their edges."""
        n, nc, S = self.n, self.nc, cu.shape[0]
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
        n, nc = self.n, self.nc
        H, W = rows * n, cols * n
        CH, CW = rows * nc, cols * nc
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
                "recon_u": h(from_blocks(rec_c[0, s], nc, CH, CW)),
                "recon_v": h(from_blocks(rec_c[1, s], nc, CH, CW)),
            })
        return out


def gather_mode(preds: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """preds [S, 35, n, n], modes [S] -> the chosen predictions [S, n, n]."""
    n = preds.shape[-1]
    return torch.gather(preds, 1, modes.reshape(-1, 1, 1, 1)
                        .expand(-1, 1, n, n))[:, 0]


def planes_to_blocks(y, u, v, n: int, device, nc: int = None):
    """Host planes (or tensors) -> int32 CU blocks on the device ([ncu,
    n, n] luma, [ncu, nc, nc] chroma, nc n/2 by default)."""
    nc = n // 2 if nc is None else nc
    t = lambda p: (p if isinstance(p, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(p))).to(device, torch.int32)
    return to_blocks(t(y), n), to_blocks(t(u), nc), to_blocks(t(v), nc)


class IntraFrameEncoder:
    """Uniform-grid intra frame encoder for one (coded) geometry and CU
    size (16 or 32); quant_fn picks the levels (plain, sign-bit hiding or
    static RDOQ, with or without scaling lists); lossless bypasses
    transform and quantization (the levels are the residual, the recon
    the source). csp "i444" codes 4:4:4 (chroma planes and CUs at luma
    size, chroma references filtered as luma's, QpC = min(QP, 51));
    fast_intra decides every CU's luma mode up front from the
    edge-replicated source's neighbours (all 35 modes, the SATD argmin),
    and the wavefront then predicts only that mode; nr denoises every
    transformed block by per-coefficient offsets before quantization and
    returns each frame's |coef| sums (noise reduction)."""

    def __init__(self, width: int, height: int, cu_size: int, device,
                 quant_fn: Quantizer = PLAIN, lossless: bool = False,
                 csp: str = "i420", fast_intra: bool = False,
                 nr: bool = False):
        self.n = cu_size
        self.lossless = bool(lossless)
        self.i444 = csp == "i444"
        self.nc = cu_size if self.i444 else cu_size // 2
        self.fast_intra, self.nr = bool(fast_intra), bool(nr)
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
                     qp, nr_off=None) -> dict:
        """y: [H, W] pixels padded to the coded size; u, v: [H/2, W/2]
        ([H, W] in 4:4:4); qp: one QP, or the per-CU QP map ([rows,
        cols] or [ncu]); nr_off: with nr, the denoise offsets (luma [n,
        n], chroma [nc, nc]; None: zeros). Returns the decision dict
        (numpy): modes, levels_*, recon_* and with nr "nr_sum_y" /
        "nr_sum_c", the frame's |coef| sums (int64 [n*n], [nc*nc])."""
        return self.encode_frames([y], [u], [v],
                                  qp if np.ndim(qp) == 0 else [qp],
                                  nr_off)[0]

    def encode_frames(self, ys, us, vs, qp, nr_off=None) -> list:
        """A batch of independent frames (sequences of padded planes), each
        wavefront step batching the step's CUs of every frame; one
        decision dict per frame, each equal to its frame's encode_frame.
        qp: one QP for every CU, or a per-CU QP map for each frame (a
        sequence of F [rows, cols] or [ncu] arrays); nr_off: one set of
        denoise offsets for every frame of the batch."""
        return self.finish_frames(self.submit_frames(ys, us, vs, qp, nr_off))

    def submit_frames(self, ys, us, vs, qp, nr_off=None):
        """Launch encode_frames' program and fetch nothing; returns the
        handle finish_frames takes."""
        n, nc, F = self.n, self.nc, len(ys)
        ncu = self.rows * self.cols
        log2n = n.bit_length() - 1
        log2c = nc.bit_length() - 1
        qp, qpc = cu_qps(qp, F * ncu, self.device, self.i444)
        at = lambda q, cu: q if isinstance(q, int) else q[cu]
        blk = [planes_to_blocks(y, u, v, n, self.device, nc)
               for y, u, v in zip(ys, us, vs)]
        yb, ub, vb = (torch.cat([b[i] for b in blk]) for i in range(3))
        ws = WaveState(F * ncu, n, self.device, self.quant_fn.bit_depth,
                       self.i444)
        q = self.quant_fn
        modes_all = self._source_modes(ys) if self.fast_intra else None
        nr = None
        if self.nr:
            if nr_off is None:
                nr_off = (np.zeros((n, n), np.int32),
                          np.zeros((n // 2,) * 2, np.int32))
            offs = tuple(torch.as_tensor(np.asarray(o, np.int32),
                                         device=self.device) for o in nr_off)
            nr = (offs, torch.zeros((F, n * n), dtype=torch.int64,
                                    device=self.device),
                  torch.zeros((F, nc * nc), dtype=torch.int64,
                              device=self.device))

        def tq(src, pred, qp_, log2, luma, m, k):
            def denoise(coef):
                coef, a = quant.denoise_dct(coef, nr[0][k])
                # each block's frame: CU numbers are f * ncu + cu, and a
                # chroma batch is Cb blocks then Cr blocks
                f = (cu if luma else cu.repeat(2)) // ncu
                nr[1 + k].index_add_(0, f, a.flatten(1).to(torch.int64))
                return coef
            return tq_recon(src, pred, qp_, log2, True, q, luma, m,
                            denoise=None if nr is None else denoise)

        for cu, nbr, avail in self.wave(F).steps:
            src = yb[cu]
            if modes_all is None:
                # luma: all 35 modes, SATD argmin (first minimum)
                preds = ws.luma_all_modes(nbr, avail[n])
                m = torch.argmin(pixel.satd(src[:, None], preds), dim=1)
                pred = gather_mode(preds, m)
            else:
                m = modes_all[cu]
                pred = ws.luma_mode(nbr, avail[n], m)
            srcc = torch.cat([ub[cu], vb[cu]])     # Cb and Cr in one batch
            predc = ws.chroma_dm(nbr, avail[nc], m)
            if self.lossless:
                lv, rec = src - pred, src
                lvc, recc = srcc - predc, srcc
            else:
                lv, rec = tq(src, pred, at(qp, cu), log2n, True, m, 0)
                lvc, recc = tq(srcc, predc, cb_cr(at(qpc, cu)), log2c, False,
                               m.repeat(2), 1)
            ws.commit(cu, m, lv, rec, lvc, recc)
        return ws, nr, F

    def finish_frames(self, handle) -> list:
        """Fetch the decision dicts of a submit_frames handle."""
        ws, nr, F = handle
        out = ws.result(self.rows, self.cols, F)
        if nr is not None:
            sy, sc = nr[1].cpu().numpy(), nr[2].cpu().numpy()
            for f, o in enumerate(out):
                o["nr_sum_y"], o["nr_sum_c"] = sy[f], sc[f]
        return out

    def to(self, device) -> "IntraFrameEncoder":
        """The same encoder with its tables on `device`."""
        return IntraFrameEncoder(
            self.cols * self.n, self.rows * self.n, self.n, device,
            self.quant_fn, self.lossless, "i444" if self.i444 else "i420",
            self.fast_intra, self.nr)

    def _source_modes(self, ys) -> torch.Tensor:
        """Fast intra: every CU's luma mode from the edge-replicated source
        plane's neighbours (all 35 modes, the SATD argmin; [F * ncu])."""
        from .qt_common import source_v       # qt_common imports this
        n, bd = self.n, self.quant_fn.bit_depth
        out = []
        for y in ys:
            y32 = torch.as_tensor(np.ascontiguousarray(y),
                                  device=self.device).to(torch.int32)
            preds = intra.predict_all_modes_matmul(source_v(y32, n), n, bd,
                                                   luma=True)
            out.append(torch.argmin(pixel.satd(to_blocks(y32, n)[:, None],
                                               preds), dim=1))
        return torch.cat(out)


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


class IntraQT64Encoder:
    """CTU64 quadtree intra frame encoder (port of
    IntraFrameEncoder._build_qt64 + _unpack_qt64, the reference's default
    CTU size): the 64x64 CU always splits; each 32x32 block chooses
    between one CU and four 16x16 subtrees, each 16x16 block (max_depth
    3) between one CU and four 8x8 CUs, bottom-up by RD (SSD + lambda2 *
    (static TU bits + MODE_BITS), + 1 bit for each split flag below the
    minimum size), inside the wavefront. quant_fn: plain, mode-dependent
    sign-bit hiding or static-bit RDOQ (psy-RDOQ on luma); psy_rd: the
    psycho-visual term of the RD; deblock: the in-loop deblock after the
    frame (every CU edge at BS 2, on the 8-sample grid).

    Every CU of every size predicts from the recon of what precedes it
    in z-order, each size choosing its luma mode by the SATD argmin over
    the 35 modes, chroma taking the DM mode. The reference's scan step
    holds a CTU tile and its carried neighbour edges and masks its
    writes; the port keeps frame planes and, for the CTUs of one
    wavefront diagonal, codes each z-order position as one batch: a
    block reads its references from the plane, which holds the recon of
    the z-earlier blocks as decided so far (a candidate's own region is
    never among its references) and the final recon of the left, top
    and top-right CTUs (qt_common.block_v gives the spec's availability
    inside the 64 tile); after a subtree the RD choice writes the
    unsplit candidate back over the region where it wins."""

    def __init__(self, width: int, height: int, device,
                 quant_fn: Quantizer = PLAIN, psy_rd: float = 0.0,
                 max_depth: int = 3, deblock: bool = False):
        from . import qt_common as QT      # qt_common imports this module
        if max_depth not in (2, 3):
            raise ValueError("CTU64: the 64x64 CU always splits, so "
                             f"max_depth is 2 or 3, not {max_depth} (the "
                             "reference's assertion)")
        self.QT = QT
        self.n = 64
        self.rows, self.cols = height // 64, width // 64
        self.H, self.W = height, width
        self.device = torch.device(device)
        self.quant_fn, self.psy_rd = quant_fn, float(psy_rd)
        self.bd = quant_fn.bit_depth
        self.depth3 = max_depth >= 3
        self.max_depth = max_depth
        self.filters = Deblock64(bool(deblock), self.bd)
        nd, _, rc, valid = wavefront_schedule(self.rows, self.cols, slope=2)
        self.diags = [(rc[d, valid[d], 0].astype(np.int64),
                       rc[d, valid[d], 1].astype(np.int64))
                      for d in range(nd)]
        self._idx = {}

    def _index(self, d: int, y0: int, x0: int, nn: int):
        """Device indices of the nn-blocks at (y0, x0) of diagonal d's
        CTUs: luma (references, availability, samples), then chroma's."""
        key = (d, y0, x0, nn)
        if key not in self._idx:
            QT, t = self.QT, lambda a: torch.as_tensor(a, device=self.device)
            r, c = self.diags[d]
            hc = nn // 2
            vi, va = QT.block_v(r, c, y0, x0, nn, 64, self.cols, self.W)
            vc, vac = QT.block_v(r, c, y0 // 2, x0 // 2, hc, 32, self.cols,
                                 self.W // 2)
            self._idx[key] = (
                t(vi), t(va), t(QT.block_index(r, c, y0, x0, nn, 64,
                                               self.W)),
                t(vc), t(vac), t(QT.block_index(r, c, y0 // 2, x0 // 2, hc,
                                                32, self.W // 2)))
        return self._idx[key]

    def encode_frame(self, y, u, v, qp, with_sao: bool = True,
                     slice_qp: int = None) -> dict:
        """y, u, v: planes padded to the coded size (numpy); qp: one QP or
        the per-CTU QP map (AQ; [rows, cols] or [ncu]); slice_qp: the
        deblock's QP before the first coded CTU (default the map's
        largest). with_sao is accepted for the sessions' call (CTU64
        codes no SAO). Returns the decision dict (numpy): split32 /
        modes32 [rows, cols, 4], split16 / modes16 [rows, cols, 4, 4],
        modes8 [rows, cols, 4, 4, 4], levels_y [rows, cols, 64, 64],
        levels_cb / _cr [rows, cols, 32, 32] and the recon planes."""
        rows, cols, dev = self.rows, self.cols, self.device
        ncu = rows * cols
        pl = lambda p: torch.as_tensor(np.array(p, np.int32), device=dev)
        src = (pl(y), pl(u), pl(v))
        rec = tuple(torch.zeros_like(p) for p in src)
        lv = tuple(torch.zeros_like(p) for p in src)
        qmap = np.broadcast_to(np.asarray(qp, np.int32).reshape(-1)
                               if np.ndim(qp) else np.int32(qp), (ncu,))
        qy, qc = cu_qps(qmap, ncu, dev)
        l2 = self.QT.lam2(qy)
        z = lambda *shape, dt=torch.int32: torch.zeros(shape, dtype=dt,
                                                       device=dev)
        dec = {"split32": z(ncu, 4, dt=torch.bool), "modes32": z(ncu, 4),
               "split16": z(ncu, 4, 4, dt=torch.bool),
               "modes16": z(ncu, 4, 4), "modes8": z(ncu, 4, 4, 4)}
        for d, (r, c) in enumerate(self.diags):
            ctu = torch.as_tensor(r * cols + c, device=dev)
            one = (qmap == qmap[0]).all()
            ctx = (d, int(qmap[0]) if one else qy[ctu],
                   chroma_qp_from_luma(int(qmap[0])) if one else qc[ctu],
                   l2[ctu])
            for q, (qy_, qx_) in enumerate(self.QT.QOFF):
                sp32, m32, sp16, m16, m8 = self._tree32(
                    ctx, src, rec, lv, 32 * qy_, 32 * qx_)
                dec["split32"][ctu, q], dec["modes32"][ctu, q] = sp32, m32
                dec["split16"][ctu, q], dec["modes16"][ctu, q] = sp16, m16
                dec["modes8"][ctu, q] = m8
        h = lambda a: a.cpu().numpy()
        out = {k: h(a).reshape((rows, cols) + tuple(a.shape[1:]))
               for k, a in dec.items()}
        rec = self.filters(rec, lv, out, self.max_depth, qmap, slice_qp)
        tiles = lambda p, k: h(to_blocks(p, k)).reshape(rows, cols, k, k)
        out.update(levels_y=tiles(lv[0], 64), levels_cb=tiles(lv[1], 32),
                   levels_cr=tiles(lv[2], 32), recon_y=h(rec[0]),
                   recon_u=h(rec[1]), recon_v=h(rec[2]))
        return out

    def _code(self, ctx, src, rec, y0: int, x0: int, nn: int):
        """One candidate CU of size nn at (y0, x0) of the diagonal's CTUs,
        nothing written: [mode, (levels y, levels Cb + Cr), (recon y,
        recon Cb + Cr), dist, bits], the bits None until _bits prices
        them."""
        d, qy, qc, _ = ctx
        q, bd = self.quant_fn, self.bd
        vi, va, bi, vc, vac, bc = self._index(d, y0, x0, nn)
        S, hc = bi.shape[0], nn // 2
        v = intra.substitute_references(rec[0].reshape(-1)[vi], va, bd)
        preds = intra.predict_all_modes_matmul(v, nn, bd, luma=True)
        sy = src[0].reshape(-1)[bi].reshape(S, nn, nn)
        m = torch.argmin(pixel.satd(sy[:, None], preds), dim=1)
        lvy, ry = tq_recon(sy, gather_mode(preds, m), qy, nn.bit_length() - 1,
                           True, q, True, m)
        v = intra.substitute_references(
            torch.cat([rec[1].reshape(-1)[vc], rec[2].reshape(-1)[vc]]),
            vac.repeat(2, 1), bd)
        predc = intra.predict_mode_matmul(v, m.repeat(2), hc, bd, luma=False)
        sc = torch.cat([src[1].reshape(-1)[bc], src[2].reshape(-1)[bc]]) \
            .reshape(2 * S, hc, hc)
        lvc, rc_ = tq_recon(sc, predc, cb_cr(qc), hc.bit_length() - 1, True,
                            q, False, m.repeat(2))
        QT = self.QT
        dist = (QT.ssd(sy, ry) + QT.ssd(sc[:S], rc_[:S])) + \
            QT.ssd(sc[S:], rc_[S:])
        if self.psy_rd > 0:
            e = (pixel.psy_energy(sy) - pixel.psy_energy(ry)).abs().float()
            psy = np.float32(self.psy_rd)
            # the reference's contracted multiply-add; at a power of two
            # (the presets' 1, 2, 4) the product is exact, so the plain
            # float32 add rounds once too
            dist = dist + e * psy if math.frexp(self.psy_rd)[0] == 0.5 \
                else fp32.fma(e, psy, dist)
        return [m.to(torch.int32), (lvy, lvc), (ry, rc_), dist, None]

    def _bits(self, cands) -> None:
        """Price candidates' levels on the host in one round trip: each
        one's bits, ((Y + Cb) + Cr) + MODE_BITS in float32 (the reference's
        order), set on the device."""
        levels = [t for c in cands for t in c[1]]
        host = torch.cat([t.flatten() for t in levels]).cpu().numpy()
        out, o = [], 0
        for c in cands:
            lvy, lvc = c[1]
            S = lvy.shape[0]
            by = quant.est_tu_bits(host[o:o + lvy.numel()].reshape(S, -1))
            o += lvy.numel()
            bc = quant.est_tu_bits(host[o:o + lvc.numel()].reshape(2 * S,
                                                                    -1))
            o += lvc.numel()
            out.append(((by + bc[:S]) + bc[S:]) + np.float32(
                self.QT.MODE_BITS))
        dev = torch.as_tensor(np.stack(out)).to(self.device)
        for c, b in zip(cands, dev):
            c[4] = b

    def _put(self, ctx, rec, lv, y0: int, x0: int, nn: int, cand,
             keep=None):
        """Write a candidate's recon and levels into the planes (where
        keep [S] is False, when given: the rest keeps the planes')."""
        _, lvs, recs, _, _ = cand
        _, _, bi, _, _, bc = self._index(ctx[0], y0, x0, nn)
        S = bi.shape[0]
        for planes, (ya, ca) in ((rec, recs), (lv, lvs)):
            for p, idx, a in ((planes[0], bi, ya), (planes[1], bc, ca[:S]),
                              (planes[2], bc, ca[S:])):
                new = a.reshape(S, -1)
                if keep is not None:
                    new = torch.where(keep[:, None], p.view(-1)[idx], new)
                p.view(-1)[idx] = new

    def _tree16(self, ctx, src, rec, lv, y0: int, x0: int):
        """A 16x16 block: one CU, or (max_depth 3) four 8x8 CUs by RD.
        Returns (dist, bits, split, mode16, modes8 [S, 4]); at max_depth 2
        bits is the CU candidate, unpriced (its bits + 1 once priced)."""
        c16 = self._code(ctx, src, rec, y0, x0, 16)
        m16, d16 = c16[0], c16[3]
        S = m16.shape[0]
        if not self.depth3:
            self._put(ctx, rec, lv, y0, x0, 16, c16)
            zs = torch.zeros(S, dtype=torch.int32, device=m16.device)
            return d16, c16, \
                torch.zeros(S, dtype=torch.bool, device=m16.device), m16, \
                torch.stack([zs] * 4, 1)
        c8s = []
        for sy, sx in self.QT.QOFF:
            yy, xx = y0 + 8 * sy, x0 + 8 * sx
            c8s.append(self._code(ctx, src, rec, yy, xx, 8))
            self._put(ctx, rec, lv, yy, xx, 8, c8s[-1])
        self._bits([c16] + c8s)
        d8 = torch.zeros(S, dtype=torch.float32, device=m16.device)
        b8 = torch.zeros_like(d8)
        for c8 in c8s:
            d8, b8 = d8 + c8[3], b8 + c8[4]
        l2, b16 = ctx[3], c16[4]
        one = np.float32(1.0)
        sp = (d8 + l2 * (b8 + one)) < (d16 + l2 * (b16 + one))
        self._put(ctx, rec, lv, y0, x0, 16, c16, keep=sp)
        return (torch.where(sp, d8, d16),
                torch.where(sp, b8 + one, b16 + one), sp, m16,
                torch.stack([c[0] for c in c8s], 1))

    def _tree32(self, ctx, src, rec, lv, y0: int, x0: int):
        """A 32x32 block: one CU or four 16x16 subtrees by RD. Returns
        (split, mode32, split16 [S, 4], modes16 [S, 4], modes8 [S, 4, 4])."""
        c32 = self._code(ctx, src, rec, y0, x0, 32)
        subs = [self._tree16(ctx, src, rec, lv, y0 + 16 * qy, x0 + 16 * qx)
                for qy, qx in self.QT.QOFF]
        one = np.float32(1.0)
        # depth 2: the 16x16 CUs are priced with the 32x32 one
        self._bits([c32] + ([] if self.depth3 else [t[1] for t in subs]))
        dq = torch.zeros_like(c32[3])
        bq = torch.zeros_like(dq)
        for dd, bb, _, _, _ in subs:
            dq, bq = dq + dd, bq + (bb if self.depth3 else bb[4] + one)
        l2 = ctx[3]
        sp = (dq + l2 * (bq + one)) < (c32[3] + l2 * (c32[4] + one))
        self._put(ctx, rec, lv, y0, x0, 32, c32, keep=sp)
        return sp, c32[0], torch.stack([t[2] for t in subs], 1), \
            torch.stack([t[3] for t in subs], 1), \
            torch.stack([t[4] for t in subs], 1)


class Deblock64:
    """The CTU64 intra frame's deblock (the reference's session runs it
    after the program: BS 2 on every CU edge of the 8-sample grid,
    ops/deblock.compute_bs_qt64_intra, each CTU at its decoder-side QP),
    and the wall-clock ms of the last frame's, as the stage "deblock"."""

    def __init__(self, on: bool, bit_depth: int = 8):
        self.on, self.bd = on, bit_depth
        self.ms = {}

    def __call__(self, rec, lv, out: dict, max_depth: int,
                 qmap: np.ndarray, slice_qp=None):
        """The deblocked (y, u, v) planes (rec itself when off). out: the
        decision dict's split32 / split16; qmap: each CTU's QP [ncu];
        slice_qp: the QP before the first coded CTU (default the map's
        largest)."""
        self.ms = {}
        if not self.on:
            return rec
        from ..ops import deblock as DB, filters as FL
        t0 = time.perf_counter()
        dev = rec[0].device
        rows, cols = out["split32"].shape[:2]
        bs_v, bs_h = (torch.as_tensor(b, device=dev) for b in
                      DB.compute_bs_qt64_intra(out["split32"],
                                               out["split16"], max_depth))
        tiles = lambda p, k: (p != 0).reshape(rows, k, cols, k).any(3) \
            .any(1).reshape(-1)
        cbf = tiles(lv[0], 64) | tiles(lv[1], 32) | tiles(lv[2], 32)
        q_eff = FL.effective_qp(torch.as_tensor(np.array(qmap), device=dev),
                                cbf, int(qmap.max()) if slice_qp is None
                                else int(slice_qp))
        cell_q = q_eff.reshape(rows, cols).repeat_interleave(8, 0) \
            .repeat_interleave(8, 1)
        out3 = FL.deblock_qt2(rec, cell_q, bs_v, bs_h, self.bd)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.ms = {"deblock": (time.perf_counter() - t0) * 1e3}
        return out3
