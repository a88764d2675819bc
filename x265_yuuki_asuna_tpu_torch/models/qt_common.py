"""Shared parts of the CTU32 quadtree programs (intra, P and B; max depth
1 or 2).

Port of x265_yuuki_asuna_tpu/models/qt_common.py (QOFF, morton,
_tr_available, _bl_available, block_v, source_v) and of the pieces the two
`_build_qt` programs share: the static block maps, the frame's QPs (one,
or one per CTU under AQ / cuTree) and the per-QP lambdas,
the SSD, the dense source-neighbour intra decision, the leaf RD (the
transform/quant/recon step with the program's quantizer: plain,
mode-dependent sign-bit hiding or context RDOQ at the slice's frozen
states) and RQT's split variant of an inter leaf (tq_quads,
rd_leaf_split, tu_split_rd), the commit of the decided intra leaves and
the in-loop filter chain (ops/filters.py) that runs after it.

The commit. The reference scans the CTU wavefront diagonals; each step
computes, for every CTU of the diagonal, the whole-CTU intra variant and
then every 16x16 / 8x8 position in z-order, and keeps the decided ones
(masked writes into a CTU tile, neighbours carried as CTU edges). The
port copies the decided tree to the host once per frame and runs only the
leaves that exist: for each diagonal, each z-order position with at least
one intra leaf on that diagonal is one batch. Each leaf reads its
reference samples straight from the frame's recon plane, which at that
point holds exactly what the reference's tile and carried edges hold at
the positions the spec makes available (z-earlier leaves of the CTU, the
final recon of the left, top, top-left and top-right CTUs), so the
results are the same with far fewer launches.
"""

from __future__ import annotations

import time
from functools import lru_cache

import numpy as np
import torch

from ..ops import bitcost as BC
from ..ops import fp32
from ..ops import filters as FL
from ..ops import intra, pixel
from ..ops.quant import PLAIN, Quantizer
from .intra_encoder import cb_cr, cu_qps, gather_mode, to_blocks, tq_recon

N = 32          # CTU size
MODE_BITS = 7.0
# z-order offsets of the 4 quadrants of any block
QOFF = ((0, 0), (0, 1), (1, 0), (1, 1))


def morton(y: int, x: int) -> int:
    """Z-order index of a unit cell (y, x) — both < 256."""
    z = 0
    for b in range(8):
        z |= ((x >> b) & 1) << (2 * b) | ((y >> b) & 1) << (2 * b + 1)
    return z


def _tr_available(y0: int, x0: int, nn: int, N: int) -> bool:
    """In-tile top-right samples (y0-1, x0+nn..) decoded before (y0, x0)?"""
    g = nn
    return morton((y0 - 1) // g, (x0 + nn) // g) < morton(y0 // g, x0 // g)


def _bl_available(y0: int, x0: int, nn: int, N: int) -> bool:
    """In-tile below-left samples (y0+nn.., x0-1) decoded before (y0, x0)?"""
    g = nn
    return morton((y0 + nn) // g, (x0 - 1) // g) < morton(y0 // g, x0 // g)


def block_v(r, c, y0: int, x0: int, nn: int, ctu: int, cols: int,
            width: int):
    """Reference samples of the nn-block at (y0, x0) of CTUs (r, c)
    (int arrays [S]) in a plane `width` wide with CTUs of `ctu` samples:
    (flat plane indices [S, 4nn+1] int64, availability [S, 4nn+1] bool),
    host numpy, in the v layout [below-left (bottom..top), left
    (bottom..top), corner, top (left..right), top-right (left..right)].

    Availability is the reference's block_v (spec 8.4.4.2.1): inside the
    CTU by z-order (_tr_available / _bl_available), across CTU edges from
    the left / top / top-right / top-left CTU flags; below-left beyond
    the CTU's bottom and top-right beyond its right edge below its top
    row are never available. Unavailable samples index 0: reference
    substitution replaces them before anything reads them."""
    r = np.asarray(r, np.int64)
    c = np.asarray(c, np.int64)
    S = len(r)
    al, at = c > 0, r > 0
    atr, atl = (r > 0) & (c < cols - 1), (r > 0) & (c > 0)
    T, F = np.ones(S, bool), np.zeros(S, bool)
    if x0 == 0 and y0 + 2 * nn <= ctu:
        a_bl = al
    elif x0 > 0 and y0 + 2 * nn <= ctu and _bl_available(y0, x0, nn, ctu):
        a_bl = T
    else:
        a_bl = F
    a_l = al if x0 == 0 else T
    if y0 == 0 and x0 == 0:
        a_c = atl
    elif y0 == 0:
        a_c = at
    elif x0 == 0:
        a_c = al
    else:
        a_c = T
    a_t = at if y0 == 0 else T
    if y0 == 0:
        a_tr = at if x0 + 2 * nn <= ctu else atr
    else:
        a_tr = T if (x0 + 2 * nn <= ctu
                     and _tr_available(y0, x0, nn, ctu)) else F
    Y0, X0 = r * ctu + y0, c * ctu + x0
    ar = np.arange(nn)
    ys = np.concatenate([
        Y0[:, None] + 2 * nn - 1 - ar, Y0[:, None] + nn - 1 - ar,
        Y0[:, None] - 1, np.repeat(Y0[:, None] - 1, 2 * nn, 1)], 1)
    xs = np.concatenate([
        np.repeat(X0[:, None] - 1, 2 * nn + 1, 1), X0[:, None] + ar,
        X0[:, None] + nn + ar], 1)
    avail = np.concatenate([np.repeat(a[:, None], k, 1) for a, k in (
        (a_bl, nn), (a_l, nn), (a_c, 1), (a_t, nn), (a_tr, nn))], 1)
    return np.where(avail, ys * width + xs, 0), avail


def source_v(plane: torch.Tensor, nn: int) -> torch.Tensor:
    """Boundary vectors [nblocks, 4nn+1] of every aligned nn-block, gathered
    from the edge-replicated SOURCE plane (the fast-intra decision's
    references: no wavefront)."""
    hh, ww = plane.shape
    idx = torch.as_tensor(_source_v_index(hh, ww, nn), device=plane.device)
    return plane.reshape(-1)[idx]


@lru_cache(maxsize=None)
def _source_v_index(hh: int, ww: int, nn: int) -> np.ndarray:
    """Flat plane indices of source_v: the reference's sample positions in
    the plane padded by one edge-replicated sample, mapped back to the
    plane by clamping."""
    cn = ww // nn
    nb = (hh // nn) * cn
    y0 = (np.arange(nb) // cn) * nn + 1          # padded coordinates
    x0 = (np.arange(nb) % cn) * nn + 1
    ar = np.arange(nn)[None, :]
    one = np.ones((1, 1), np.int64)
    rows = np.concatenate([
        np.minimum(y0[:, None] + 2 * nn - 1 - ar, hh),        # below-left
        y0[:, None] + nn - 1 - ar,                            # left
        (y0 - 1)[:, None] * one,                              # corner
        np.repeat((y0 - 1)[:, None], 2 * nn, 1)], 1)          # top, top-right
    cols = np.concatenate([
        np.repeat((x0 - 1)[:, None], 2 * nn + 1, 1),
        x0[:, None] + ar, np.minimum(x0[:, None] + nn + ar, ww + 1)], 1)
    rows = np.clip(rows - 1, 0, hh - 1)
    cols = np.clip(cols - 1, 0, ww - 1)
    return (rows * ww + cols).astype(np.int64)


# ---------------------------------------------------------------------------
# per-QP lambdas: 0.9 * 2^((qp-12)/6) and 0.85 * 2^((qp-12)/3) in float32,
# 2^x as the reference's compiled program evaluates it (fp32.lambda_table)
# ---------------------------------------------------------------------------

def _lam_of(table: np.ndarray, qp):
    """table[qp]: a float32 for an int QP, a float32 tensor of each QP of
    a tensor (per-block QPs: AQ / cuTree)."""
    if isinstance(qp, torch.Tensor):
        return torch.as_tensor(table, device=qp.device)[qp.long()]
    return table[qp]


def lam(qp):
    """Motion-decision lambda (SATD units) of a QP or of each QP of a
    tensor, float32."""
    return _lam_of(fp32.lambda_table(0.9, 6.0), qp)


def lam2(qp):
    """Mode/split-decision lambda (SSD units) of a QP or of each QP of a
    tensor, float32."""
    return _lam_of(fp32.lambda_table(0.85, 3.0), qp)


# ---------------------------------------------------------------------------
# static block maps of one CTU32 geometry
# ---------------------------------------------------------------------------

class QtGeometry:
    """Index maps of a rows x cols CTU32 grid (frame raster block order):
    pxpy[nn] block origins, map16 [ncu, 4] / map8 [ncu, 4, 4] the z-order
    16 / 8 blocks of each CTU, ch8 [n16, 4] the z-order 8-children of each
    16-block, ctu_of[nn] the CTU of every nn-block."""

    def __init__(self, rows: int, cols: int, device):
        self.rows, self.cols = rows, cols
        self.ncu = ncu = rows * cols
        self.H, self.W = rows * N, cols * N
        self.device = device
        t = lambda a: torch.as_tensor(a, device=device)
        self.pxpy = {}
        for nn in (N, 16, 8):
            cn = self.W // nn
            nb = (self.H // nn) * cn
            self.pxpy[nn] = (t((np.arange(nb) % cn * nn).astype(np.int32)),
                             t((np.arange(nb) // cn * nn).astype(np.int32)))
        g_r, g_c = np.arange(ncu) // cols, np.arange(ncu) % cols
        map16 = np.stack([(g_r * 2 + qy) * cols * 2 + g_c * 2 + qx
                          for qy, qx in QOFF], 1)
        map8 = np.stack([np.stack([(g_r * 4 + 2 * qy + sy) * cols * 4
                                   + g_c * 4 + 2 * qx + sx
                                   for sy, sx in QOFF], 1)
                         for qy, qx in QOFF], 1)
        # the CTU of every block of each size
        self.ctu_of = {nn: (y // N) * cols + x // N
                       for nn, (x, y) in self.pxpy.items()}
        n16 = 4 * ncu
        r16, c16 = np.arange(n16) // (cols * 2), np.arange(n16) % (cols * 2)
        ch8 = np.stack([(r16 * 2 + qy) * cols * 4 + c16 * 2 + qx
                        for qy, qx in QOFF], 1)
        self.map16, self.map8, self.ch8 = t(map16), t(map8), t(ch8)


def sum4(x: torch.Tensor) -> torch.Tensor:
    """[B, 4] -> [B]: left to right (the reference's 4-term float32 sums)."""
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) + x[:, 3]


def split_rd(leaf: dict, geo: QtGeometry, l2_ctu: torch.Tensor):
    """The bottom-up split decisions: (split16 [n16] bool, or None at
    depth 1; split [ncu] bool). leaf[nn]["dist"] / ["bits"] are float32
    [nblocks] per size (no 8 in leaf: depth 1); l2_ctu is each CTU's split
    lambda (float32 [ncu]), a 16-block's that of its CTU. At depth 1 the
    16x16 CU is the smallest and codes no split flag, so its bits take no
    + 1 (the reference's b16 + 0.0)."""
    d16, b16 = leaf[16]["dist"], leaf[16]["bits"]
    split16 = None
    if 8 in leaf:
        l2_16 = l2_ctu[geo.ctu_of[16]]
        d8sum = sum4(leaf[8]["dist"][geo.ch8])
        b8sum = sum4(leaf[8]["bits"][geo.ch8])
        split16 = (d8sum + l2_16 * (b8sum + 1.0)) < \
            (d16 + l2_16 * (b16 + 1.0))
        t16d = torch.where(split16, d8sum, d16)
        t16b = torch.where(split16, b8sum + 1.0, b16 + 1.0)
    else:
        t16d, t16b = d16, b16
    dB = sum4(t16d[geo.map16])
    bB = sum4(t16b[geo.map16]) + 1.0
    dA, bA = leaf[N]["dist"], leaf[N]["bits"] + 1.0
    return split16, (dB + l2_ctu * bB) < (dA + l2_ctu * bA)


def sizes_of(max_depth: int) -> tuple:
    """The CU sizes of a CTU32 quadtree of max_depth 1 or 2."""
    return (N, 16, 8)[:max_depth + 1]


class FrameQp:
    """The QPs of one quadtree frame: "cu" / "c" each CTU's luma / chroma
    QP (int32 [ncu] on the device), "slice" the slice QP, "first" the first
    CTU's QP (the programs start the K9 contexts at it, as the reference
    does), blk(nn, q) a per-CTU array's value for every nn-block and
    leaves(ctu) the QPs of leaves in the CTUs ctu.

    qp is one QP or a per-CTU map (AQ / cuTree; [rows, cols] or [ncu]);
    slice_qp defaults, as in the reference's programs, to the largest QP
    of the map."""

    def __init__(self, geo: QtGeometry, qp, slice_qp: int = None):
        q = np.broadcast_to(np.asarray(qp, np.int32).reshape(-1)
                            if np.ndim(qp) else np.int32(qp), (geo.ncu,))
        self.geo = geo
        self.cu, self.c = cu_qps(q, geo.ncu, geo.device)
        self.first = int(q[0])
        self.slice = int(q.max()) if slice_qp is None else int(slice_qp)
        # one QP for the frame: the commit's batches quantize at ints,
        # with no per-leaf gathers
        self.one = cu_qps(self.first, 1, geo.device) \
            if (q == q[0]).all() else None

    def blk(self, nn: int, q: torch.Tensor) -> torch.Tensor:
        return q[self.geo.ctu_of[nn]]

    def leaves(self, ctu: np.ndarray):
        """(luma, chroma) QPs of leaves in the CTUs `ctu` (host indices):
        ints when the frame has one QP, else int32 tensors."""
        if self.one is not None:
            return self.one
        i = torch.as_tensor(ctu, device=self.geo.device)
        return self.cu[i], self.c[i]


# ---------------------------------------------------------------------------
# transform / quant / recon and distortion
# ---------------------------------------------------------------------------

def ssd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences over the last two axes as float32. The
    sum is exact (int64), so it equals the reference's float32 sum in any
    order while the block's SSD is below 2^24 (at 10 bits a 32x32 block's
    mean squared error must stay below 16384 for that, at 12 bits too:
    the decisions are held to the reference's pinned streams)."""
    d = (a - b).to(torch.int64)
    return (d * d).sum((-2, -1)).float()


def dense_intra(nn: int, y32, u32, v32, bd: int = 8):
    """Fast-intra decision at one size for every aligned nn-block: modes
    from source-neighbour SATD over all 35 luma modes, and the luma and
    DM-chroma predictions from the source neighbours (bd-bit samples)."""
    preds = intra.predict_all_modes_matmul(source_v(y32, nn), nn, bd,
                                           luma=True)
    yb = to_blocks(y32, nn)
    modes = torch.argmin(pixel.satd(yb[:, None], preds), dim=1)
    hc = nn // 2
    return (modes.to(torch.int32), gather_mode(preds, modes),
            intra.predict_mode_matmul(source_v(u32, hc), modes, hc, bd,
                                      luma=False),
            intra.predict_mode_matmul(source_v(v32, hc), modes, hc, bd,
                                      luma=False))


def rd_leaf(nn: int, srcs3, pred3, qp_y, qp_c, states, intra_slice: bool,
            quant_fn: Quantizer = PLAIN, modes=None, psy_rd: float = 0.0):
    """TU levels, recon, distortion and K9 bits of one candidate at one
    size: ((lv_y, lv_cb, lv_cr), (rec_y, rec_u, rec_v), dist, bits).
    modes: the blocks' intra modes for an intra candidate (the
    sign-hiding scan), None for an inter one; states: the slice's frozen
    contexts (K9 and the context RDOQ). dist is the SSD of the three
    planes, plus with psy_rd > 0 psy_rd times the luma's change of
    psycho-visual energy, |E(source) - E(recon)|, in float32 as the
    reference's compiled program adds it: the multiply contracted into
    the add (exact for psy_rd a power of two, as the presets' 1, 2 and
    4 are)."""
    log2nn = nn.bit_length() - 1
    sy, su, sv = srcs3
    tq = lambda src, pred, qp, log2, luma: tq_recon(
        src, pred, qp, log2, intra_slice, quant_fn, luma, modes, None, states)
    lv_y, rec_y = tq(sy, pred3[0], qp_y, log2nn, True)
    lv_cb, rec_u = tq(su, pred3[1], qp_c, log2nn - 1, False)
    lv_cr, rec_v = tq(sv, pred3[2], qp_c, log2nn - 1, False)
    dist = (ssd(sy, rec_y) + ssd(su, rec_u)) + ssd(sv, rec_v)
    if psy_rd > 0:
        e = (pixel.psy_energy(sy) - pixel.psy_energy(rec_y)).abs().float()
        dist = fp32.fma(e, np.float32(psy_rd), dist)
    sh = quant_fn.sbh
    bits = ((BC.est_tu_bits_ctx(lv_y, log2nn, True, states, sh)
             + BC.est_tu_bits_ctx(lv_cb, log2nn - 1, False, states, sh))
            + BC.est_tu_bits_ctx(lv_cr, log2nn - 1, False, states, sh))
    return (lv_y, lv_cb, lv_cr), (rec_y, rec_u, rec_v), dist, bits


def tq_quads(src, pred, qp, log2nn: int, quant_fn: Quantizer, luma: bool,
             states):
    """The residual of [B, nn, nn] blocks (nn = 1 << log2nn) coded as four
    half-size TUs (the RQT split variant; inter rounding, the diagonal
    scan): (levels, recon) [B, nn, nn] with each TU at its quadrant, and
    the levels [B, 4, nn/2, nn/2] in z-order. qp: one QP or the blocks'
    [B] QPs."""
    B, nn = src.shape[0], 1 << log2nn
    h2 = nn // 2
    quad = lambda a: a.reshape(B, 2, h2, 2, h2).permute(0, 1, 3, 2, 4) \
        .reshape(B * 4, h2, h2)
    back = lambda a: a.reshape(B, 2, 2, h2, h2).permute(0, 1, 3, 2, 4) \
        .reshape(B, nn, nn)
    if not isinstance(qp, int):
        qp = qp.repeat_interleave(4)
    lv, rec = tq_recon(quad(src), quad(pred), qp, log2nn - 1, False,
                       quant_fn, luma, None, None, states)
    return back(lv), back(rec), lv.reshape(B, 4, h2, h2)


def rd_leaf_split(nn: int, srcs3, pred3, qp_y, qp_c, states,
                  quant_fn: Quantizer = PLAIN):
    """The RQT split variant of an inter candidate at one size: its
    residual as four nn/2 luma TUs and, following luma in 4:2:0, four
    nn/4 chroma TUs per plane (tq_quads): ((lv_y, lv_cb, lv_cr), (rec_y,
    rec_u, rec_v), dist, bits), the levels in quadrant layout. dist is the
    SSD of the three planes (no psycho-visual term, as in the
    reference); bits each plane's four TUs' K9 bits summed left to right,
    the planes' sums in turn, + 12 for the cbf flags."""
    log2nn = nn.bit_length() - 1
    sy, su, sv = srcs3
    lv_y, rec_y, q_y = tq_quads(sy, pred3[0], qp_y, log2nn, quant_fn, True,
                                states)
    lv_cb, rec_u, q_cb = tq_quads(su, pred3[1], qp_c, log2nn - 1, quant_fn,
                                  False, states)
    lv_cr, rec_v, q_cr = tq_quads(sv, pred3[2], qp_c, log2nn - 1, quant_fn,
                                  False, states)
    dist = (ssd(sy, rec_y) + ssd(su, rec_u)) + ssd(sv, rec_v)
    sh = quant_fn.sbh
    bits = ((sum4(BC.est_tu_bits_ctx(q_y, log2nn - 1, True, states, sh))
             + sum4(BC.est_tu_bits_ctx(q_cb, log2nn - 2, False, states, sh)))
            + sum4(BC.est_tu_bits_ctx(q_cr, log2nn - 2, False, states, sh))) \
        + 12.0
    return (lv_y, lv_cb, lv_cr), (rec_y, rec_u, rec_v), dist, bits


def rqt_cost(dist, bits, l2) -> torch.Tensor:
    """A TU variant's RD cost dist + l2 (bits + 1) in float32 as XLA's CPU
    code computes it: the multiply contracted into the add (fp32.fma)."""
    return fp32.fma(bits + 1.0, l2, dist)


def tu_split_rd(dist2, bits2, dist, bits, l2) -> torch.Tensor:
    """RQT's choice per block: the split variant (dist2, bits2) where its
    rqt_cost is strictly below the single TU's (dist, bits)."""
    return rqt_cost(dist2, bits2, l2) < rqt_cost(dist, bits, l2)


def sources3(y32, u32, v32, nn: int):
    return to_blocks(y32, nn), to_blocks(u32, nn // 2), to_blocks(v32, nn // 2)


# ---------------------------------------------------------------------------
# the commit of the decided intra leaves
# ---------------------------------------------------------------------------

# z-order positions of a CTU32 tree: (y0, x0, nn)
ZPOS = [(0, 0, N)]
for _qy, _qx in QOFF:
    ZPOS.append((_qy * 16, _qx * 16, 16))
    ZPOS += [(_qy * 16 + 8 * _sy, _qx * 16 + 8 * _sx, 8) for _sy, _sx in QOFF]
ZINDEX = {p: k for k, p in enumerate(ZPOS)}


def intra_leaves(split, sp16, mA, m16, m8, intraA=None, intra16=None,
                 intra8=None):
    """Host list of the decided intra leaves: (ctu, zpos index, mode).
    split [ncu], sp16 [ncu, 4] (None at depth 1: no 16x16 CU splits), mA
    [ncu], m16 [ncu, 4], m8 [ncu, 4, 4] (None at depth 1);
    intra* the per-leaf intra flags (None: every leaf is intra, as in an I
    slice)."""
    out = []
    for i in range(len(split)):
        if not split[i]:
            if intraA is None or intraA[i]:
                out.append((i, 0, int(mA[i])))
            continue
        for q, (qy, qx) in enumerate(QOFF):
            if sp16 is None or not sp16[i, q]:
                if intra16 is None or intra16[i, q]:
                    out.append((i, ZINDEX[(qy * 16, qx * 16, 16)],
                                int(m16[i, q])))
                continue
            for sq, (sy, sx) in enumerate(QOFF):
                if intra8 is None or intra8[i, q, sq]:
                    out.append((i, ZINDEX[(qy * 16 + 8 * sy,
                                           qx * 16 + 8 * sx, 8)],
                                int(m8[i, q, sq])))
    return out


def block_index(r, c, y0: int, x0: int, nn: int, ctu: int, width: int):
    """Flat plane indices [S, nn*nn] of the nn-blocks at (y0, x0) of CTUs
    (r, c), raster within each block (host numpy)."""
    ar = np.arange(nn)
    ys = (np.asarray(r) * ctu + y0)[:, None, None] + ar[None, :, None]
    xs = (np.asarray(c) * ctu + x0)[:, None, None] + ar[None, None, :]
    return (ys * width + xs).reshape(len(r), nn * nn)


def commit_intra(leaves, geo: QtGeometry, src, rec, lv, fq: FrameQp,
                 intra_slice: bool, quant_fn: Quantizer = PLAIN,
                 states=None):
    """Reconstruct the intra leaves in decoding order, in place.

    src, rec, lv: (y, u, v) int32 frame planes on the device (source,
    recon, levels); rec and lv hold the inter leaves already (P) or
    nothing yet (I). leaves: intra_leaves(). For each wavefront diagonal
    (CTU (r, c) on diagonal 2r + c) and each z-order position, the leaves
    there form one batch: luma, then Cb and Cr together, each leaf at its
    CTU's QPs (fq). quant_fn and states: the program's quantizer and the
    slice's frozen contexts; the samples' bit depth is quant_fn's."""
    rows, cols, W = geo.rows, geo.cols, geo.W
    bd = quant_fn.bit_depth
    dev = geo.device
    steps = {}
    for ctu, k, mode in leaves:
        r, c = divmod(ctu, cols)
        steps.setdefault((2 * r + c, k), []).append((r, c, mode))
    t = lambda a: torch.as_tensor(a, device=dev)
    for (_, k), items in sorted(steps.items()):
        y0, x0, nn = ZPOS[k]
        r = np.array([it[0] for it in items])
        c = np.array([it[1] for it in items])
        modes = t(np.array([it[2] for it in items], np.int64))
        S = len(items)
        qy, qc = fq.leaves(r * cols + c)
        nc, ctu_c = nn // 2, N // 2
        # luma
        vi, va = block_v(r, c, y0, x0, nn, N, cols, W)
        v = intra.substitute_references(rec[0].reshape(-1)[t(vi)], t(va),
                                        bd)
        bi = t(block_index(r, c, y0, x0, nn, N, W))
        pred = intra.predict_mode_matmul(v, modes, nn, bd, luma=True)
        lvy, ry = tq_recon(src[0].reshape(-1)[bi].reshape(S, nn, nn), pred,
                           qy, nn.bit_length() - 1, intra_slice, quant_fn,
                           True, modes, None, states)
        rec[0].view(-1)[bi] = ry.reshape(S, -1)
        lv[0].view(-1)[bi] = lvy.reshape(S, -1)
        # chroma: Cb then Cr in one batch
        vi, va = block_v(r, c, y0 // 2, x0 // 2, nc, ctu_c, cols, W // 2)
        vi, va = t(vi), t(va)
        v = intra.substitute_references(
            torch.cat([rec[1].reshape(-1)[vi], rec[2].reshape(-1)[vi]]),
            va.repeat(2, 1), bd)
        bi = t(block_index(r, c, y0 // 2, x0 // 2, nc, ctu_c, W // 2))
        pred = intra.predict_mode_matmul(v, modes.repeat(2), nc, bd,
                                         luma=False)
        s = torch.cat([src[1].reshape(-1)[bi], src[2].reshape(-1)[bi]])
        lvc, rc_ = tq_recon(s.reshape(2 * S, nc, nc), pred, cb_cr(qc),
                            nc.bit_length() - 1, intra_slice, quant_fn, False,
                            modes.repeat(2), None, states)
        for p in (1, 2):
            sl = slice((p - 1) * S, p * S)
            rec[p].view(-1)[bi] = rc_[sl].reshape(S, -1)
            lv[p].view(-1)[bi] = lvc[sl].reshape(S, -1)


def decision_planes(geo: QtGeometry, rec, lv, recon: bool = True) -> dict:
    """Levels as CTU tiles and (with recon) the recon planes, numpy, in the
    reference's decision dict layout."""
    rows, cols = geo.rows, geo.cols
    h = lambda x: x.cpu().numpy()
    tiles = lambda p, k: h(to_blocks(p, k)).reshape(rows, cols, k, k)
    out = {"levels_y": tiles(lv[0], N), "levels_cb": tiles(lv[1], N // 2),
           "levels_cr": tiles(lv[2], N // 2)}
    if recon:
        out.update(recon_y=h(rec[0]), recon_u=h(rec[1]), recon_v=h(rec[2]))
    return out


def by_ctu(a: torch.Tensor, m: torch.Tensor, shape) -> np.ndarray:
    """Per-block values a [nblocks] gathered into CTU z-order m [ncu, ...],
    as a host array of `shape`."""
    return a[m].cpu().numpy().reshape(shape)



class LoopFilters:
    """The quadtree programs' in-loop filters (deblock, SAO; each may be
    off; SAO in its "program" or "host" form) and the wall-clock ms of
    the last frame's chain by stage: "filters" for the program form (the
    device-DPB chain), "deblock" and "sao" apart for the host form (the
    reference's host filters), on bit_depth-bit samples."""

    def __init__(self, deblock: bool, sao: bool, sao_form: str = "program",
                 bit_depth: int = 8):
        self.deblock, self.sao, self.sao_form = deblock, sao, sao_form
        self.bit_depth = bit_depth
        self.ms = {}

    def __call__(self, rec, src3, lv, fq: FrameQp, split, split16,
                 ui_sizes=None, mv_sizes=None, pdir_sizes=None,
                 with_sao: bool = True):
        """The filtered recon planes of a frame (the same planes when both
        filters are off) and its SAO parameters ([ncu, 18] int32 numpy,
        or None); the arguments of FL.qt_loopfilter, with the frame's
        per-CTU and slice QPs (fq); with_sao=False leaves SAO out of this
        frame. Each timed stage runs between two device synchronisations,
        inside a profiler range named "filters"."""
        self.ms = {}
        sao_on = self.sao and with_sao
        if not (self.deblock or sao_on):
            return rec, None
        dev = rec[0].device
        sync = torch.cuda.synchronize if dev.type == "cuda" else \
            (lambda: None)
        host = self.sao_form == "host"
        # the host form's two stages one after the other, the program
        # form's chain as one
        steps = [("deblock", self.deblock, False), ("sao", False, sao_on)] \
            if host else [("filters", self.deblock, sao_on)]
        rec, sao = tuple(rec), None
        sync()
        for stage, db, so in steps:
            if not (db or so):
                continue
            t0 = time.perf_counter()
            with torch.profiler.record_function("filters"):
                rec, p = FL.qt_loopfilter(rec, src3, fq.cu, fq.slice, split,
                                          split16, ui_sizes, mv_sizes,
                                          pdir_sizes, lv, db, so,
                                          self.sao_form, self.bit_depth)
                if p is not None:
                    sao = p.cpu().numpy()
                sync()
            self.ms[stage] = (time.perf_counter() - t0) * 1e3
        return rec, sao
