"""P- and B-frame encoder on the uniform CU grid: dense ME/MC, then a
wavefront for the intra-vs-inter decision and reconstruction.

Port of the uniform-grid branches of
x265_yuuki_asuna_tpu/models/inter_encoder.py (`_build` + `_unpack`): the
uni-prediction P frame, with explicit weighted prediction (weightp), the
P frame with two L0 references (`motion_phase_2ref`) and the B frame
(`motion_phase_b`), each with sign-bit hiding (diagonal scan) or
static-bit RDOQ, at one QP or a per-CU QP map; analysis reuse's hinted P
frame (`analysis_load`: no integer search, the subpel refinement starts
at each CU's hint).
Phase A runs for every CU at once: integer full search through K1
(`ops.me.full_search_sad`, per reference), half- then quarter-pel SATD
refinement, motion compensation and, with two references, the choice of
one (a P frame's L0 index, a B frame's L0, L1 or bi). Phase B walks the CU diagonals (a Python loop, one batch of CUs
per diagonal): the 35-mode intra candidate from reconstructed neighbors,
the SATD decision against the inter prediction, then transform,
quantization and reconstruction. Levels come back at full width, so the
decision dict equals `InterFrameEncoder._unpack(..., compact=False)`.

The CTU32 quadtree's P and B frames (`InterQTEncoder`, depth 1 or 2) are
the port of `_build_qt` + `_unpack_qt` of the same module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitcost as BC
from ..ops import fp32, interp, me, pixel
from ..ops.quant import PLAIN, Quantizer
from . import qt_common as QT
from .lookahead import downscale_half
from .intra_encoder import (WaveState, Wavefront, cb_cr, cu_qps,
                            from_blocks, gather_mode, planes_to_blocks,
                            to_blocks, tq_recon)

# subpel refinement neighbors, in evaluation order (ties keep the earlier)
_NBR = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 1), (1, 1))


def frame_weights(weights) -> tuple:
    """The ((w, o) luma, cb, cr) a weighted P program runs with: the
    chosen weights, (64, 0) for each component without one (weights None:
    all three)."""
    weights = weights or {}
    return tuple(weights.get(c) or (64, 0) for c in ("luma", "cb", "cr"))


def weighted_preds(refs, px, py, mx, my, nn: int, wts, bd: int = 8):
    """The normative weighted prediction (y, u, v) of every nn-block: the
    short-domain MC of the unweighted reference planes refs at the
    quarter-pel MVs, then weight_uni with each component's (w, o), at
    bit depth bd."""
    pxc, pyc = px // 2, py // 2
    ps = (interp.mc_luma_qpel_ps(refs[0], px, py, mx, my, nn, bd),
          interp.mc_chroma_qpel_ps(refs[1], pxc, pyc, mx, my, nn // 2, bd),
          interp.mc_chroma_qpel_ps(refs[2], pxc, pyc, mx, my, nn // 2, bd))
    return tuple(interp.weight_uni(p, w, o, 6, bd)
                 for p, (w, o) in zip(ps, wts))


def bi_costs(satds, mv0, mv1, qp: int) -> torch.Tensor:
    """The uniform B program's [L0, L1, bi] costs of every CU ([ncu, 3]
    float32): SATD + lambda * bits, lambda = 0.9 * 2^((qp - 12) / 6), the
    bits of a list 4 + 2 log2(1 + |mvx|) + 2 log2(1 + |mvy|), + 1 for L1,
    both lists' + 2 for bi. satds: the three predictions' SATDs (int);
    mv0 / mv1: each list's (mvx, mvy). Every float32 value is XLA's:
    lambda from fp32.lambda_table, the bits from fp32.mv_log_bits, each
    cost one multiply-add contraction (fp32.fma)."""
    lam = QT.lam(qp)
    b0, b1 = fp32.mv_log_bits(*mv0), fp32.mv_log_bits(*mv1)
    s0, s1, sbi = (s.float() for s in satds)
    return torch.stack([fp32.fma(b0, lam, s0), fp32.fma(b1 + 1.0, lam, s1),
                        fp32.fma((b0 + b1) + 2.0, lam, sbi)], 1)


def ref2_costs(satds, mv0, mv1, qp: int) -> torch.Tensor:
    """The two-reference P program's cost of each L0 reference for every
    CU ([ncu, 2] float32): SATD + lambda * (the MV bits + 1 for ref_idx),
    in bi_costs' terms (XLA's float32 lambda and MV bits, the sum one
    multiply-add contraction). satds: the two predictions' SATDs (int);
    mv0 / mv1: each reference's (mvx, mvy); qp: the program's QP."""
    lam = QT.lam(qp)
    return torch.stack([fp32.fma(fp32.mv_log_bits(*mv) + 1.0, lam, s.float())
                        for s, mv in zip(satds, (mv0, mv1))], 1)


class InterFrameEncoder:
    """Uniform-grid P- and B-frame encoder (one reference per list) for
    one geometry. weightp: every P frame takes the weighted branch (the
    search on the weight-transformed reference, the normative weighted
    prediction), with the identity weight for a component that has none,
    as the reference's program does; B frames are never weighted. The
    samples' bit depth is quant_fn's: planes go to the device as uint8 at
    8 bits, int16 above (K1's input either way)."""

    def __init__(self, width: int, height: int, cu_size: int, device,
                 quant_fn: Quantizer = PLAIN, search_range: int = 16,
                 weightp: bool = False):
        self.n = cu_size
        self.weightp = bool(weightp)
        # integer full search over [-search_range, search_range]^2
        self.search_range = search_range
        self.rows, self.cols = height // cu_size, width // cu_size
        self.device = torch.device(device)
        self.quant_fn = quant_fn
        self.bd = quant_fn.bit_depth
        self.wave = Wavefront(self.rows, self.cols, cu_size, self.device)
        ncu = self.rows * self.cols
        idx = torch.arange(ncu, dtype=torch.int32, device=self.device)
        self.px = (idx % self.cols) * cu_size
        self.py = (idx // self.cols) * cu_size

    # ---------- phase A: dense ME + MC over all CUs ----------------------
    def _search(self, yb: torch.Tensor, y: torch.Tensor,
                search: torch.Tensor, hint=None):
        """Every CU's quarter-pel MV against the luma plane `search` (the
        device plane type): K1's integer full search of y, or with a hint
        (analysis reuse: each CU's quarter-pel (mvx, mvy), host arrays)
        no search, then half- then quarter-pel SATD refinement around it
        (8 neighbours each, the first of equal costs kept)."""
        n, px, py, bd = self.n, self.px, self.py, self.bd
        ry = search.to(torch.int32)
        if hint is not None:
            mvx, mvy = (torch.as_tensor(np.asarray(h, np.int32),
                                        device=self.device) for h in hint)
        else:
            mvx_i, mvy_i, _ = me.full_search_sad(
                search, y, n, self.search_range, lambda_bits=2,
                peak=pixel.peak(bd))
            mvx, mvy = mvx_i * 4, mvy_i * 4

        def eval_mv(mx, my):
            return pixel.satd(yb, interp.mc_luma_qpel(ry, px, py, mx, my, n,
                                                      bd))

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
        return mvx, mvy

    def motion_phase(self, y: torch.Tensor, ref_y: torch.Tensor,
                     ref_u: torch.Tensor, ref_v: torch.Tensor, wts=None,
                     hint=None):
        """y, ref_*: device planes; wts: ((w, o) luma, cb, cr) for the
        weighted branch, or None; hint: the analysis hints _search starts
        from, or None. Returns quarter-pel (mvx, mvy), the luma/chroma
        predictions [ncu, n, n] / [ncu, n/2, n/2] and the inter SATD
        [ncu]."""
        n, px, py, bd = self.n, self.px, self.py, self.bd
        yb = to_blocks(y.to(torch.int32), n)
        # the weighted branch searches (integer and subpel) on the
        # weight-transformed luma reference
        search = ref_y if wts is None else interp.weight_plane(
            ref_y, *wts[0], bd)
        ry = search.to(torch.int32)
        mvx, mvy = self._search(yb, y, search, hint)
        if wts is not None:
            pred_y, pred_u, pred_v = weighted_preds(
                tuple(p.to(torch.int32) for p in (ref_y, ref_u, ref_v)),
                px, py, mvx, mvy, n, wts, bd)
            return mvx, mvy, pred_y, pred_u, pred_v, pixel.satd(yb, pred_y)
        pred_y = interp.mc_luma_qpel(ry, px, py, mvx, mvy, n, bd)
        # chroma: a quarter-luma-pel MV is an eighth-chroma-pel MV
        pred_u = interp.mc_chroma_qpel(ref_u.to(torch.int32), px // 2,
                                       py // 2, mvx, mvy, n // 2, bd)
        pred_v = interp.mc_chroma_qpel(ref_v.to(torch.int32), px // 2,
                                       py // 2, mvx, mvy, n // 2, bd)
        return mvx, mvy, pred_y, pred_u, pred_v, pixel.satd(yb, pred_y)

    def motion_phase_2ref(self, y: torch.Tensor, refs0, refs1, qp: int):
        """The P frame with two L0 references (y: device plane; refs0 /
        refs1: the (y, u, v) device planes of L0 index 0 and 1; qp: the
        program's QP, the largest of a map): one search against each, then
        per CU index 1 where its ref2_costs is strictly the lower (ties
        keep index 0). Returns (the index, mvx, mvy, the chosen (y, u, v)
        predictions, the chosen SATD)."""
        n, px, py, bd = self.n, self.px, self.py, self.bd
        yb = to_blocks(y.to(torch.int32), n)
        r32 = [tuple(p.to(torch.int32) for p in r) for r in (refs0, refs1)]
        mvs = [self._search(yb, y, r[0]) for r in (refs0, refs1)]
        preds = [_mc3(r, px, py, *mv, n, bd) for r, mv in zip(r32, mvs)]
        satds = [pixel.satd(yb, p[0]) for p in preds]
        costs = ref2_costs(satds, *mvs, qp)
        sel = costs[:, 1] < costs[:, 0]
        mvx, mvy = (torch.where(sel, b, a) for a, b in zip(*mvs))
        pred = tuple(torch.where(sel[:, None, None], b, a)
                     for a, b in zip(*preds))
        return (sel.to(torch.int32), mvx, mvy) + pred + (
            torch.where(sel, satds[1], satds[0]),)

    def motion_phase_b(self, y: torch.Tensor, refs0, refs1, qp: int):
        """The B frame's two searches and its per-CU choice of L0, L1 or
        bi (y: device plane; refs0 / refs1: each list's (y, u, v) device
        planes; qp: the program's QP, the largest of a map): the first
        minimum of bi_costs (ties favour uni-prediction); bi predicts with
        add_avg of the two short-domain predictions, as the decoder does.
        Returns (pdir 1 / 2 / 3, mv0x, mv0y, mv1x, mv1y, the chosen (y,
        u, v) predictions, the least cost, float32)."""
        n, px, py, bd = self.n, self.px, self.py, self.bd
        yb = to_blocks(y.to(torch.int32), n)
        r32 = [tuple(p.to(torch.int32) for p in r) for r in (refs0, refs1)]
        (mv0x, mv0y), (mv1x, mv1y) = (self._search(yb, y, r[0])
                                      for r in (refs0, refs1))
        p0 = _mc3(r32[0], px, py, mv0x, mv0y, n, bd)
        p1 = _mc3(r32[1], px, py, mv1x, mv1y, n, bd)
        pbi = [interp.add_avg(a, b, bd) for a, b in zip(
            _mc3(r32[0], px, py, mv0x, mv0y, n, bd, ps=True),
            _mc3(r32[1], px, py, mv1x, mv1y, n, bd, ps=True))]
        costs = bi_costs([pixel.satd(yb, p[0]) for p in (p0, p1, pbi)],
                         (mv0x, mv0y), (mv1x, mv1y), qp)
        sel = torch.argmin(costs, 1)              # the first minimum
        pdir = torch.where(sel == 2, 3, sel + 1).to(torch.int32)
        s = sel[:, None, None]
        pred = tuple(torch.where(s == 0, a, torch.where(s == 1, b, c))
                     for a, b, c in zip(p0, p1, pbi))
        return (pdir, mv0x, mv0y, mv1x, mv1y) + pred + (costs.min(1).values,)

    # ---------------------------------------------------------------------
    def encode_frame(self, y, u, v, ref_y, ref_u, ref_v, qp,
                     weights=None, ref1=None, ref2=None, hint=None) -> dict:
        """The decision dict of one frame: submit_frame, then
        finish_frame (the arguments are submit_frame's)."""
        return self.finish_frame(self.submit_frame(
            y, u, v, ref_y, ref_u, ref_v, qp, weights, ref1, ref2, hint))

    def submit_frame(self, y, u, v, ref_y, ref_u, ref_v, qp,
                     weights=None, ref1=None, ref2=None, hint=None) -> dict:
        """Launch one frame's program and fetch nothing: the handle holds
        its decisions and recon on the device (recon_planes reads the
        recon there, finish_frame fetches the dict; the reference's
        submit_frame / finish_frame). All planes padded to the coded
        size (host arrays or tensors); ref_* are the
        decoded reference planes (L0); ref1: the L1 reference's (y, u, v)
        planes for a B frame, None for a P frame; ref2: a P frame's second
        L0 reference's (y, u, v) planes (the two-reference program, the
        chosen index under "ref"), None for one; qp one QP or the per-CU
        QP map (AQ / cuTree); weights (weightp, P frames): {"luma" / "cb" /
        "cr": (w, o)} at denominator 6, a missing component the identity;
        hint (a P frame with one reference, unweighted: analysis reuse):
        each CU's quarter-pel (mvx, mvy) [ncu], refined in place of K1's
        full search, which is then not launched.
        finish_frame returns the decision dict (numpy; a B frame's with
        pdir and the L1 MVs, each list's MVs as searched: the session
        masks them by pdir)."""
        dev = self.device
        n = self.n
        ncu = self.rows * self.cols
        log2n = n.bit_length() - 1
        qmax = int(np.max(qp))
        qp, qpc = cu_qps(qp, ncu, dev)
        at = lambda q, cu: q if isinstance(q, int) else q[cu]
        pl = lambda p: _plane(p, dev, self.bd)
        pdir = mv1x = mv1y = ref_sel = None
        if ref2 is not None:
            (ref_sel, mvx, mvy, pred_yb, pred_ub, pred_vb,
             isatd) = self.motion_phase_2ref(
                pl(y), (pl(ref_y), pl(ref_u), pl(ref_v)),
                tuple(pl(p) for p in ref2), qmax)
        elif ref1 is not None:
            (pdir, mvx, mvy, mv1x, mv1y, pred_yb, pred_ub, pred_vb,
             isatd) = self.motion_phase_b(
                pl(y), (pl(ref_y), pl(ref_u), pl(ref_v)),
                tuple(pl(p) for p in ref1), qmax)
        else:
            mvx, mvy, pred_yb, pred_ub, pred_vb, isatd = self.motion_phase(
                pl(y), pl(ref_y), pl(ref_u), pl(ref_v),
                frame_weights(weights) if self.weightp else None, hint)
        yb, ub, vb = planes_to_blocks(y, u, v, n, dev)

        # ---------- phase B: wavefront decision + recon ------------------
        ws = WaveState(ncu, n, dev, self.bd)
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
            lv, rec = tq_recon(src, pred, at(qp, cu), log2n, False,
                               self.quant_fn)
            lvc, recc = tq_recon(torch.cat([ub[cu], vb[cu]]), predc,
                                 cb_cr(at(qpc, cu)), log2n - 1, False,
                                 self.quant_fn, False)
            use_intra[cu] = ui
            ws.commit(cu, m, lv, rec, lvc, recc)
        return {"ws": ws, "use_intra": use_intra, "mvx": mvx, "mvy": mvy,
                "ref": ref_sel, "pdir": pdir, "mv1x": mv1x, "mv1y": mv1y}

    def upload(self, *planes):
        """Host planes (or tensors) on the device in the plane type; from
        the host through pinned memory, so the copy does not wait for the
        work queued on the stream."""
        dt = pixel.plane_dtype(self.bd)
        out = []
        for p in planes:
            if not isinstance(p, torch.Tensor):
                p = torch.from_numpy(np.ascontiguousarray(p).astype(
                    np.uint8 if dt == torch.uint8 else np.int16))
                if self.device.type == "cuda":
                    p = p.pin_memory()
            out.append(p.to(self.device, dt, non_blocking=True))
        return tuple(out)

    def recon_planes(self, handle: dict):
        """The submitted frame's recon (y, u, v) as device planes of the
        plane type (a reference for the next frame), without a fetch."""
        rows, cols, n, nc = self.rows, self.cols, self.n, self.n // 2
        ws = handle["ws"]
        dt = pixel.plane_dtype(self.bd)
        return (from_blocks(ws.rec_y, n, rows * n, cols * n).to(dt),
                from_blocks(ws.rec_c[0], nc, rows * nc, cols * nc).to(dt),
                from_blocks(ws.rec_c[1], nc, rows * nc, cols * nc).to(dt))

    def finish_frame(self, handle: dict) -> dict:
        """Fetch a submitted frame's decision dict (numpy)."""
        rows, cols = self.rows, self.cols
        out = handle["ws"].result(rows, cols)[0]
        h = lambda a: None if a is None else a.cpu().numpy().reshape(rows,
                                                                     cols)
        out.update({k: h(handle[k]) for k in (
            "use_intra", "mvx", "mvy", "ref", "pdir", "mv1x", "mv1y")})
        return out

    def to(self, device) -> "InterFrameEncoder":
        """The same encoder with its tables on `device`."""
        return InterFrameEncoder(self.cols * self.n, self.rows * self.n,
                                 self.n, device, self.quant_fn,
                                 self.search_range, self.weightp)


# ---------------------------------------------------------------------------
# CTU32 quadtree P and B frames (depth 1 or 2)
# ---------------------------------------------------------------------------

def _plane(p, dev, bd: int) -> torch.Tensor:
    """A plane of bd-bit samples on `dev` in the device plane type (uint8
    at 8 bits, int16 above) from a host array or a tensor."""
    dt = pixel.plane_dtype(bd)
    if isinstance(p, torch.Tensor):
        return p.to(dev, dt)
    return torch.as_tensor(np.ascontiguousarray(p).astype(
        np.uint8 if dt == torch.uint8 else np.int16), device=dev)


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


def _mc3(refs, px, py, mx, my, nn: int, bd: int = 8, ps: bool = False):
    """(y, u, v) predictions of every nn-block from the reference planes
    `refs` at quarter-pel MVs: bd-bit pixels, or with ps the short-domain
    form."""
    luma = interp.mc_luma_qpel_ps if ps else interp.mc_luma_qpel
    chroma = interp.mc_chroma_qpel_ps if ps else interp.mc_chroma_qpel
    return (luma(refs[0], px, py, mx, my, nn, bd),
            chroma(refs[1], px // 2, py // 2, mx, my, nn // 2, bd),
            chroma(refs[2], px // 2, py // 2, mx, my, nn // 2, bd))


# decision-dict keys of each size's motion: (pdir, L0 x, L0 y, L1 x, L1 y)
_MOTION_KEYS = {QT.N: ("pdir", "mvx", "mvy", "mv1x", "mv1y"),
                16: ("pdir4", "mv4x", "mv4y", "mv41x", "mv41y"),
                8: ("pdir8", "mv8x", "mv8y", "mv81x", "mv81y")}


def hme_takes_coarse(csad, cx, cy, fsad, fx, fy):
    """Per block, whether HME's doubled coarse MV (cx, cy) with its
    full-resolution SAD replaces the fine winner: strictly cheaper at a
    rate of 2 (|mvx| + |mvy|)."""
    return csad + 2 * (cx.abs() + cy.abs()) < fsad + 2 * (fx.abs() + fy.abs())


class InterQTEncoder:
    """CTU32 quadtree P- and B-frame encoder, one reference per list:
    dense decide, then the commit of the intra leaves. Port of
    InterFrameEncoder._build_qt + _unpack_qt with bi=False and with
    bi=True (max_depth 1: CUs 32 and 16, or 2: down to 8; at quant_fn's
    bit depth; rqt: the TU split of inter CU32 leaves;
    quant_fn: plain, sign-bit hiding
    under the mode-dependent scan or context RDOQ; psy_rd: the
    psycho-visual term of the leaf RD; b_intra: intra candidates in B
    slices (intra_in_b); the filter chain runs last when deblock or sao is
    set, with SAO in sao_form: "program" (the device-DPB chain) or "host"
    (the reference's host filters, ops/filters.py); hme: the hierarchical
    search; weightp: explicit weighted prediction of P frames).

    Dense phase, for every block of every size (32, 16, 8; 32 and 16 at
    depth 1): K1's frame sweep per list over +-search_range (the surface
    kernel, then the first-minimum argmin per size at lambda_bits 2); with
    hme, K1's sweep of the half-resolution planes over +-hme_range at the
    halved sizes (16, 8, 4 on the 4x4-base surface; 16 and 8 on the 8x8
    one at depth 1), whose MV,
    doubled, replaces the fine winner where its SAD on the full-resolution
    plane plus 2 (|mvx| + |mvy|) is strictly less than the fine winner's;
    half- then quarter-pel SATD refinement on a gathered window around the
    winner, then the motion decision, then the leaf RD; then the bottom-up
    split decisions. The inter leaves' levels and recon are
    exact from the dense phase.

    RQT (rqt): every CU32's inter candidate is also coded as four 16x16
    TUs (chroma four 8x8 TUs per plane), all CTUs in one batch; the split
    variant replaces the single TU where its SSD + lambda2 (bits + 1) is
    strictly less (its bits + 12 for the cbf flags, no psycho-visual
    term), before the intra and split decisions. "tu_split32" carries the
    choice of every CTU's CU32 leaf ([rows, cols]; the writer reads it
    where that leaf is an inter CU), the split leaf's levels in quadrant
    layout.

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
    (bi: the rounded mean of the two bilinear predictions). With b_intra
    the source-neighbour intra candidate competes at every size, 8x8
    included, and the commit reconstructs the decided intra leaves as in
    a P frame; without it (--no-b-intra) the decided inter leaves are the
    frame: there is no commit.

    Weighted P frames (weightp; B frames are never weighted): K1's
    surface, HME's coarse sweep, the coarse MV's SAD and the subpel
    refinement run on the weight-transformed luma reference
    (interp.weight_plane), and the motion decision keeps the ME winner:
    no merge candidate is scored; its bits are the MVD bits + 2 and its
    prediction the normative weighted MC of the unweighted planes. A
    component without a weight takes the identity (64, 0), so a weightp
    frame with no weights chosen still takes this branch, as in the
    reference."""

    def __init__(self, width: int, height: int, device,
                 deblock: bool = False, sao: bool = False,
                 quant_fn: Quantizer = PLAIN, hme: bool = False,
                 hme_range: int = 16, recon_host: bool = True,
                 psy_rd: float = 0.0, b_intra: bool = False,
                 search_range: int = 16, weightp: bool = False,
                 sao_form: str = "program", max_depth: int = 2,
                 rqt: bool = False):
        self.geo = QT.QtGeometry(height // QT.N, width // QT.N,
                                 torch.device(device))
        self.rqt = bool(rqt)
        self.sizes = QT.sizes_of(max_depth)
        self.quant_fn = quant_fn
        self.psy_rd, self.b_intra = psy_rd, bool(b_intra)
        self.search_range = search_range
        self.weightp = bool(weightp)
        self.bd = quant_fn.bit_depth
        self.filters = QT.LoopFilters(deblock, sao, sao_form, self.bd)
        # the span call of the program's phases (a session's recorder,
        # else none)
        self.span = QT.no_span
        self.hme, self.hme_range = hme, hme_range
        # the decision dict carries the recon planes on the host
        # (recon_y / _u / _v); off, only recon_dev holds them
        self.recon_host = recon_host

    def _allow_intra(self, bi: bool, nn: int) -> bool:
        """Whether the nn-blocks of a frame have an intra candidate: in
        B slices with b_intra, in P slices at 32 and 16 (the reference
        leaves 8x8 intra out of P slices at depth 2)."""
        return self.b_intra if bi else nn != 8

    def _refine(self, nn: int, y32, ref_y, fine, coarse=None):
        """Every nn-block's quarter-pel ME winner around K1's integer
        winner (or HME's doubled coarse MV where it costs less): (mvx, mvy,
        satd)."""
        px, py = self.geo.pxpy[nn]
        fx, fy, fsad = fine[nn]
        if coarse is not None:
            cx, cy = coarse[nn // 2][0] * 2, coarse[nn // 2][1] * 2
            csad = me.sad_at_mv(ref_y, to_blocks(y32, nn), px, py, cx, cy,
                                nn)
            use_c = hme_takes_coarse(csad, cx, cy, fsad, fx, fy)
            fx, fy = torch.where(use_c, cx, fx), torch.where(use_c, cy, fy)
        win = interp.gather_luma_window(ref_y, px, py, fx, fy, nn)
        dqx, dqy, satd = interp.subpel_refine_win(win, to_blocks(y32, nn),
                                                  nn, self.bd)
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

    def _motion(self, nn: int, y32, ref_y, mv, states, qp_blk):
        """The P winner motion of every nn-block (at its QP, qp_blk):
        (mvx, mvy) quarter-pel and its bits (MVD bits + 2, or the merge
        bits)."""
        px, py = self.geo.pxpy[nn]
        yb = to_blocks(y32, nn)
        mvx, mvy, _ = mv
        lam = QT.lam(qp_blk)
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
                  qp_blk):
        """The B winner motion of every nn-block (at its QP, qp_blk):
        ((pdir, mv0x, mv0y, mv1x, mv1y) with an unused list's MV zero, the
        (y, u, v) prediction, the bits)."""
        px, py = self.geo.pxpy[nn]
        bd = self.bd
        yb = to_blocks(y32, nn)
        lam = QT.lam(qp_blk)
        (mv0x, mv0y, s0), (mv1x, mv1y, s1) = mv0, mv1
        sbi = pixel.satd(yb, interp.add_avg(
            interp.mc_luma_qpel_ps(refs0[0], px, py, mv0x, mv0y, nn, bd),
            interp.mc_luma_qpel_ps(refs1[0], px, py, mv1x, mv1y, nn, bd),
            bd))
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
        p0 = _mc3(refs0, px, py, mo[1], mo[2], nn, bd)
        p1 = _mc3(refs1, px, py, mo[3], mo[4], nn, bd)
        pbi = [interp.add_avg(a, b, bd) for a, b in zip(
            _mc3(refs0, px, py, mo[1], mo[2], nn, bd, ps=True),
            _mc3(refs1, px, py, mo[3], mo[4], nn, bd, ps=True))]
        sel = pdir[:, None, None]
        pred = tuple(torch.where(sel == 1, a, torch.where(sel == 2, b, c))
                     for a, b, c in zip(p0, p1, pbi))
        return mo, pred, fb

    def encode_frame(self, y, u, v, ref_y, ref_u, ref_v, qp, ref1=None,
                     slice_qp: int = None, weights=None) -> dict:
        """y, u, v: planes padded to the coded size; ref_*: the L0
        reference picture's recon planes (numpy or device tensors);
        qp: one QP or the per-CTU QP map (AQ / cuTree), slice_qp the
        slice's (the filters' default QP; default the map's largest);
        ref1: the L1 reference's (y, u, v) for a B frame, None for a P
        frame; weights (weightp, P frames): {"luma" / "cb" / "cr": (w, o)}
        at denominator 6. Returns the decision dict (numpy), "recon_dev",
        the (filtered) recon planes as device tensors (uint8 at 8 bits,
        int16 above), and with SAO "sao", its parameters packed [ncu,
        18].

        The program runs as flat phases, each a span of self.span: "me"
        (K1's sweeps, then each size's subpel refinement), "decide" (each
        size's motion decision and leaf RD, then the split decisions and
        the inter leaves' planes), "fetch" (the host's reads of the
        decisions), "commit" (the intra leaves' wavefront), the filters'
        stages, "fetch" (the levels and recon planes)."""
        geo = self.geo
        dev = geo.device
        bd = self.bd
        span = self.span
        bi = ref1 is not None
        wts = frame_weights(weights) if self.weightp and not bi else None
        y8, u8, v8 = (_plane(p, dev, bd) for p in (y, u, v))
        r8 = [tuple(_plane(p, dev, bd) for p in (ref_y, ref_u, ref_v))]
        if bi:
            r8.append(tuple(_plane(p, dev, bd) for p in ref1))
        y32, u32, v32 = (p.to(torch.int32) for p in (y8, u8, v8))
        refs = [tuple(p.to(torch.int32) for p in r) for r in r8]
        fq = QT.FrameQp(geo, qp, slice_qp)
        search32, fine, coarse = span("me", self._sweeps, y8, r8, refs, wts)
        # B / P contexts, at the first CTU's QP as in the reference
        states = BC.init_states_dev(0 if bi else 1, fq.first)
        leaf, motion = {}, {}
        for nn in self.sizes:
            mvs = span("me", lambda: [self._refine(nn, y32, sp, f, c)
                                      for sp, f, c in zip(search32, fine,
                                                          coarse)])
            leaf[nn], motion[nn] = span("decide", self._decide, nn,
                                        (y32, u32, v32), refs, mvs, wts,
                                        states, fq)
        split16, split, rec, lv = span("decide", self._inter_leaves, leaf,
                                       fq)
        out = span("fetch", self._decisions, leaf, motion, split, split16)
        if not bi or self.b_intra:
            span("commit", self._commit, out, (y32, u32, v32), rec, lv, fq,
                 states)
        sizes = (QT.N, 16, 8)
        rec, sao = self.filters(
            span, rec, (y32, u32, v32), lv, fq, split, split16,
            tuple(leaf[nn]["ui"] if nn in leaf else None for nn in sizes),
            tuple(motion[nn][1:] if nn in motion else None for nn in sizes),
            tuple(motion[nn][0] if nn in motion else None for nn in sizes)
            if bi else None)
        if sao is not None:
            out["sao"] = sao
        out.update(span("fetch", QT.decision_planes, geo, rec, lv,
                        self.recon_host))
        out["recon_dev"] = tuple(p.to(pixel.plane_dtype(bd)) for p in rec)
        return out

    def _sweeps(self, y8, r8, refs, wts):
        """K1's sweeps of each list: (the int32 luma search planes, each
        list's {size: (mvx, mvy, sad)} integer winners, each list's
        half-resolution winners with hme, else None). Each list's search
        plane is its reference's luma; the weighted P frame's (wts) is
        the weight-transformed reference. r8 / refs: each list's planes
        in the device plane type / in int32."""
        bd = self.bd
        search, search32 = [r[0] for r in r8], [r[0] for r in refs]
        if wts is not None:
            search[0] = interp.weight_plane(search[0], *wts[0], bd)
            search32[0] = search[0].to(torch.int32)
        # K1 on the device planes, per list: the surface, then each size's
        # argmin
        fine = [me.sad_sweep_multi(sp, y8, self.sizes, self.search_range,
                                   lambda_bits=2, peak=pixel.peak(bd))
                for sp in search]
        coarse = [None] * len(r8)
        if self.hme:
            # the half-resolution planes stay within the bit depth's
            # range: the device plane type for K1
            low = lambda p: downscale_half(p).to(pixel.plane_dtype(bd))
            low_y = low(y8)
            low_refs = [low(r[0]) for r in r8]
            if wts is not None:
                low_refs[0] = interp.weight_plane(low_refs[0], *wts[0], bd)
            coarse = [me.sad_sweep_multi(lr, low_y,
                                         tuple(nn // 2 for nn in self.sizes),
                                         self.hme_range, lambda_bits=2,
                                         peak=pixel.peak(bd))
                      for lr in low_refs]
        return search32, fine, coarse

    def _decide(self, nn: int, src3, refs, mvs, wts, states, fq):
        """The nn-blocks' decisions: the motion decision and its
        prediction, the inter leaf's RD (with RQT's split variant at 32),
        then the intra candidate's where the slice allows one. src3: the
        int32 source planes; refs: each list's int32 planes; mvs: each
        list's refined (mvx, mvy, satd). Returns (the leaf's dict: "ui",
        "modes", "dist", "bits", "elv", "erec", with RQT at 32
        "tu_split"; the motion (pdir or None, mvx, mvy, mv1x or None,
        mv1y or None))."""
        geo = self.geo
        bd = self.bd
        bi = len(refs) > 1
        y32, u32, v32 = src3
        px, py = geo.pxpy[nn]
        qp_blk, qpc_blk = fq.blk(nn, fq.cu), fq.blk(nn, fq.c)
        l2 = QT.lam2(qp_blk)
        if bi:
            motion, epred, ebits_mv = self._motion_b(
                nn, y32, refs[0], refs[1], *mvs, states, qp_blk)
        elif wts is not None:
            # the ME winner, no merge candidates
            bx, by, _ = mvs[0]
            motion = (None, bx, by, None, None)
            ebits_mv = _mv_bits(bx, by, states)
            epred = weighted_preds(refs[0], px, py, bx, by, nn, wts, bd)
        else:
            bx, by, ebits_mv = self._motion(nn, y32, refs[0][0], mvs[0],
                                            states, qp_blk)
            motion = (None, bx, by, None, None)
            epred = _mc3(refs[0], px, py, bx, by, nn, bd)
        nb = px.shape[0]
        srcs3 = QT.sources3(y32, u32, v32, nn)
        # the inter rounding offset for both candidates (P and B)
        elv, erec, edist, ebits = QT.rd_leaf(nn, srcs3, epred, qp_blk,
                                             qpc_blk, states, False,
                                             self.quant_fn,
                                             psy_rd=self.psy_rd)
        lf = {}
        if self.rqt and nn == QT.N:
            lv2, rec2, dist2, bits2 = QT.rd_leaf_split(
                nn, srcs3, epred, qp_blk, qpc_blk, states, self.quant_fn)
            tu_split = QT.tu_split_rd(dist2, bits2, edist, ebits, l2)
            ts = tu_split[:, None, None]
            elv = tuple(torch.where(ts, a, b) for a, b in zip(lv2, elv))
            erec = tuple(torch.where(ts, a, b) for a, b in zip(rec2, erec))
            edist = torch.where(tu_split, dist2, edist)
            ebits = torch.where(tu_split, bits2, ebits)
            lf["tu_split"] = tu_split
        if not self._allow_intra(bi, nn):
            ui = torch.zeros(nb, dtype=torch.bool, device=geo.device)
            modes = torch.zeros(nb, dtype=torch.int32, device=geo.device)
            dist, bits = edist, ebits + ebits_mv
        else:
            modes, *ipred = QT.dense_intra(nn, y32, u32, v32, bd)
            _, _, idist, ibits = QT.rd_leaf(nn, srcs3, ipred, qp_blk,
                                            qpc_blk, states, False,
                                            self.quant_fn, modes,
                                            self.psy_rd)
            ci = idist + l2 * (ibits + QT.MODE_BITS)
            ce = edist + l2 * (ebits + ebits_mv)
            ui = ci < ce
            dist = torch.where(ui, idist, edist)
            bits = torch.where(ui, ibits + QT.MODE_BITS, ebits + ebits_mv)
        lf.update(ui=ui, modes=modes, dist=dist, bits=bits, elv=elv,
                  erec=erec)
        return lf, motion

    def _inter_leaves(self, leaf: dict, fq):
        """The split decisions and the inter leaves' (y, u, v) recon and
        levels planes: (split16 or None at depth 1, split, rec, lv), each
        position's from its level (0: CU32, 1: CU16, 2: CU8) on the 8x8
        cell grid."""
        geo = self.geo
        split16, split = QT.split_rd(leaf, geo, QT.lam2(fq.cu))
        H, W, rows, cols = geo.H, geo.W, geo.rows, geo.cols
        lvl = torch.where(split.reshape(rows, cols), 1, 0) \
            .repeat_interleave(4, 0).repeat_interleave(4, 1)
        if split16 is not None:
            lvl = lvl + torch.where(split16.reshape(rows * 2, cols * 2), 1,
                                    0).repeat_interleave(2, 0) \
                .repeat_interleave(2, 1) * lvl
        rec, lv = [], []
        for i, sub in enumerate((1, 2, 2)):
            up = lvl.repeat_interleave(8 // sub, 0) \
                .repeat_interleave(8 // sub, 1)
            for key, dst in (("erec", rec), ("elv", lv)):
                p = [from_blocks(leaf[nn][key][i], nn // sub, H // sub,
                                 W // sub) for nn in self.sizes]
                sel = p[0]
                for k in range(1, len(p)):
                    sel = torch.where(up == k, p[k], sel)
                dst.append(sel.contiguous())
        return split16, split, rec, lv

    def _decisions(self, leaf: dict, motion: dict, split, split16) -> dict:
        """The decision dict's splits, TU splits, intra flags, modes and
        motion of every size, read to the host (numpy)."""
        geo = self.geo
        rows, cols = geo.rows, geo.cols
        h = lambda a: a.cpu().numpy()
        per_size = {QT.N: lambda a: h(a).reshape(rows, cols),
                    16: lambda a: QT.by_ctu(a, geo.map16, (rows, cols, 4)),
                    8: lambda a: QT.by_ctu(a, geo.map8, (rows, cols, 4, 4))}
        out = {"split": h(split).reshape(rows, cols),
               "tu_split32": per_size[QT.N](leaf[QT.N]["tu_split"])
               if self.rqt else None,
               "split16": None if split16 is None else per_size[16](split16)}
        for nn, (ki, km) in ((QT.N, ("use_intra", "modes")),
                             (16, ("use_intra4", "modes4")),
                             (8, ("use_intra8", "modes8"))):
            lf, mo = leaf.get(nn), motion.get(nn, (None,) * 5)
            out[ki] = None if lf is None else per_size[nn](lf["ui"])
            out[km] = None if lf is None else per_size[nn](lf["modes"])
            for k, a in zip(_MOTION_KEYS[nn], mo):
                out[k] = None if a is None else per_size[nn](a)
        return out

    def _commit(self, out: dict, src3, rec, lv, fq, states) -> None:
        """The decided intra leaves (from the host decision dict out)
        reconstructed over the inter ones in rec / lv, in place."""
        rs = lambda k, *shape: None if out[k] is None else \
            out[k].reshape(-1, *shape)
        table = QT.leaf_table(
            rs("split"), rs("split16", 4), rs("modes"), rs("modes4", 4),
            rs("modes8", 4, 4), rs("use_intra"), rs("use_intra4", 4),
            rs("use_intra8", 4, 4))
        QT.commit_intra(table, self.geo, src3, rec, lv, fq, False,
                        self.quant_fn, states)
