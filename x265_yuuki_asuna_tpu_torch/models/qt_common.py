"""Shared parts of the CTU32 quadtree programs (intra and P).

Port of x265_yuuki_asuna_tpu/models/qt_common.py (QOFF, morton,
_tr_available, _bl_available, block_v, source_v) and of the pieces the two
`_build_qt` programs share: the static block maps, the per-QP lambdas, the
transform/quant/recon step, the SSD, the dense source-neighbour intra
decision and the commit of the decided intra leaves.

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

from functools import lru_cache

import numpy as np
import torch

from ..ops import bitcost as BC
from ..ops import intra, pixel, quant, transforms
from .intra_encoder import gather_mode, to_blocks

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
# with 2^x evaluated as exp(x * ln 2) like the reference's compiled program
# ---------------------------------------------------------------------------

_LN2 = float(np.float32(np.log(2.0)))


@lru_cache(maxsize=None)
def _lambda_table(scale: float, div: float) -> np.ndarray:
    q = torch.arange(52, dtype=torch.float32)
    return (scale * torch.exp((q - 12.0) / div * _LN2)).numpy()


def lam(qp: int) -> np.float32:
    """Motion-decision lambda (SATD units) of a QP, float32."""
    return _lambda_table(0.9, 6.0)[qp]


def lam2(qp: int) -> np.float32:
    """Mode/split-decision lambda (SSD units) of a QP, float32."""
    return _lambda_table(0.85, 3.0)[qp]


# ---------------------------------------------------------------------------
# static block maps of one CTU32 geometry
# ---------------------------------------------------------------------------

class QtGeometry:
    """Index maps of a rows x cols CTU32 grid (frame raster block order):
    pxpy[nn] block origins, map16 [ncu, 4] / map8 [ncu, 4, 4] the z-order
    16 / 8 blocks of each CTU, ch8 [n16, 4] the z-order 8-children of each
    16-block."""

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
        n16 = 4 * ncu
        r16, c16 = np.arange(n16) // (cols * 2), np.arange(n16) % (cols * 2)
        ch8 = np.stack([(r16 * 2 + qy) * cols * 4 + c16 * 2 + qx
                        for qy, qx in QOFF], 1)
        self.map16, self.map8, self.ch8 = t(map16), t(map8), t(ch8)


def sum4(x: torch.Tensor) -> torch.Tensor:
    """[B, 4] -> [B]: left to right (the reference's 4-term float32 sums)."""
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) + x[:, 3]


def split_rd(leaf: dict, geo: QtGeometry, l2: torch.Tensor):
    """The bottom-up split decisions: (split16 [n16], split [ncu]) bool.
    leaf[nn]["dist"] / ["bits"] are float32 [nblocks] per size; l2 is the
    split lambda (float32, 0-dim)."""
    d16, b16 = leaf[16]["dist"], leaf[16]["bits"]
    d8sum = sum4(leaf[8]["dist"][geo.ch8])
    b8sum = sum4(leaf[8]["bits"][geo.ch8])
    split16 = (d8sum + l2 * (b8sum + 1.0)) < (d16 + l2 * (b16 + 1.0))
    t16d = torch.where(split16, d8sum, d16)
    t16b = torch.where(split16, b8sum + 1.0, b16 + 1.0)
    dB = sum4(t16d[geo.map16])
    bB = sum4(t16b[geo.map16]) + 1.0
    dA, bA = leaf[N]["dist"], leaf[N]["bits"] + 1.0
    return split16, (dB + l2 * bB) < (dA + l2 * bA)


# ---------------------------------------------------------------------------
# transform / quant / recon and distortion
# ---------------------------------------------------------------------------

def tq_rec(src, pred, qp, log2n: int, intra_slice: bool):
    """(levels, recon) of residual blocks src - pred [B, n, n]; qp an int
    or [B] tensor; the rounding offset is the slice's (intra_slice)."""
    coef = transforms.forward_transform(src - pred)
    levels = quant.quant(coef, qp, log2n, 8, intra_slice)
    rr = transforms.inverse_transform(quant.dequant(levels, qp, log2n))
    return levels, (pred + rr).clamp(0, 255)


def ssd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences over the last two axes as float32. The
    sum is exact (int64), so it equals the reference's float32 sum in any
    order while the block's SSD is below 2^24."""
    d = (a - b).to(torch.int64)
    return (d * d).sum((-2, -1)).float()


def dense_intra(nn: int, y32, u32, v32):
    """Fast-intra decision at one size for every aligned nn-block: modes
    from source-neighbour SATD over all 35 luma modes, and the luma and
    DM-chroma predictions from the source neighbours."""
    preds = intra.predict_all_modes_matmul(source_v(y32, nn), nn, luma=True)
    yb = to_blocks(y32, nn)
    modes = torch.argmin(pixel.satd(yb[:, None], preds), dim=1)
    hc = nn // 2
    return (modes.to(torch.int32), gather_mode(preds, modes),
            intra.predict_mode_matmul(source_v(u32, hc), modes, hc,
                                      luma=False),
            intra.predict_mode_matmul(source_v(v32, hc), modes, hc,
                                      luma=False))


def rd_leaf(nn: int, srcs3, pred3, qp_y, qp_c, states, intra_slice: bool):
    """TU levels, recon, SSD and K9 bits of one candidate at one size:
    ((lv_y, lv_cb, lv_cr), (rec_y, rec_u, rec_v), dist, bits)."""
    log2nn = nn.bit_length() - 1
    sy, su, sv = srcs3
    lv_y, rec_y = tq_rec(sy, pred3[0], qp_y, log2nn, intra_slice)
    lv_cb, rec_u = tq_rec(su, pred3[1], qp_c, log2nn - 1, intra_slice)
    lv_cr, rec_v = tq_rec(sv, pred3[2], qp_c, log2nn - 1, intra_slice)
    dist = (ssd(sy, rec_y) + ssd(su, rec_u)) + ssd(sv, rec_v)
    bits = ((BC.est_tu_bits_ctx(lv_y, log2nn, True, states)
             + BC.est_tu_bits_ctx(lv_cb, log2nn - 1, False, states))
            + BC.est_tu_bits_ctx(lv_cr, log2nn - 1, False, states))
    return (lv_y, lv_cb, lv_cr), (rec_y, rec_u, rec_v), dist, bits


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
    split [ncu], sp16 [ncu, 4], mA [ncu], m16 [ncu, 4], m8 [ncu, 4, 4];
    intra* the per-leaf intra flags (None: every leaf is intra, as in an I
    slice)."""
    out = []
    for i in range(len(split)):
        if not split[i]:
            if intraA is None or intraA[i]:
                out.append((i, 0, int(mA[i])))
            continue
        for q, (qy, qx) in enumerate(QOFF):
            if not sp16[i, q]:
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


def commit_intra(leaves, geo: QtGeometry, src, rec, lv, qp: int, qpc: int,
                 intra_slice: bool):
    """Reconstruct the intra leaves in decoding order, in place.

    src, rec, lv: (y, u, v) int32 frame planes on the device (source,
    recon, levels); rec and lv hold the inter leaves already (P) or
    nothing yet (I). leaves: intra_leaves(). For each wavefront diagonal
    (CTU (r, c) on diagonal 2r + c) and each z-order position, the leaves
    there form one batch: luma, then Cb and Cr together."""
    rows, cols, W = geo.rows, geo.cols, geo.W
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
        nc, ctu_c = nn // 2, N // 2
        # luma
        vi, va = block_v(r, c, y0, x0, nn, N, cols, W)
        v = intra.substitute_references(rec[0].reshape(-1)[t(vi)], t(va))
        bi = t(block_index(r, c, y0, x0, nn, N, W))
        pred = intra.predict_mode_matmul(v, modes, nn, luma=True)
        lvy, ry = tq_rec(src[0].reshape(-1)[bi].reshape(S, nn, nn), pred,
                         qp, nn.bit_length() - 1, intra_slice)
        rec[0].view(-1)[bi] = ry.reshape(S, -1)
        lv[0].view(-1)[bi] = lvy.reshape(S, -1)
        # chroma: Cb then Cr in one batch
        vi, va = block_v(r, c, y0 // 2, x0 // 2, nc, ctu_c, cols, W // 2)
        vi, va = t(vi), t(va)
        v = intra.substitute_references(
            torch.cat([rec[1].reshape(-1)[vi], rec[2].reshape(-1)[vi]]),
            va.repeat(2, 1))
        bi = t(block_index(r, c, y0 // 2, x0 // 2, nc, ctu_c, W // 2))
        pred = intra.predict_mode_matmul(v, modes.repeat(2), nc, luma=False)
        s = torch.cat([src[1].reshape(-1)[bi], src[2].reshape(-1)[bi]])
        lvc, rc_ = tq_rec(s.reshape(2 * S, nc, nc), pred, qpc,
                          nc.bit_length() - 1, intra_slice)
        for p in (1, 2):
            sl = slice((p - 1) * S, p * S)
            rec[p].view(-1)[bi] = rc_[sl].reshape(S, -1)
            lv[p].view(-1)[bi] = lvc[sl].reshape(S, -1)


def decision_planes(geo: QtGeometry, rec, lv) -> dict:
    """Levels as CTU tiles and recon planes, numpy, in the reference's
    decision dict layout."""
    rows, cols = geo.rows, geo.cols
    h = lambda x: x.cpu().numpy()
    tiles = lambda p, k: h(to_blocks(p, k)).reshape(rows, cols, k, k)
    return {"levels_y": tiles(lv[0], N), "levels_cb": tiles(lv[1], N // 2),
            "levels_cr": tiles(lv[2], N // 2), "recon_y": h(rec[0]),
            "recon_u": h(rec[1]), "recon_v": h(rec[2])}


def by_ctu(a: torch.Tensor, m: torch.Tensor, shape) -> np.ndarray:
    """Per-block values a [nblocks] gathered into CTU z-order m [ncu, ...],
    as a host array of `shape`."""
    return a[m].cpu().numpy().reshape(shape)

