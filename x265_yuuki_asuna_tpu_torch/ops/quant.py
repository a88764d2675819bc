"""Quantization / dequantization with flat or signalled scaling lists,
sign-bit hiding and rate-distortion optimised quantization (RDOQ),
batched.

Port of x265_yuuki_asuna_tpu/ops/quant.py (quant, dequant, quant_matrix,
dequant_matrix, sign_bit_hiding, sign_bit_hiding_mdcs, quant_rdoq,
quant_rdoq_ctx, est_tu_bits, denoise_dct, nr_update_offsets,
sign_at_scan). The QP is a Python int (one QP for the
call) or an int tensor [B] (one QP per block of a [B, N, N] batch, as
the programs pass it).
Reference behavior (studied, not copied): common/dct.cpp quant_c /
dequant_normal_c, common/quant.cpp shift derivations and signBitHidingHDQ:
    transformShift = 15 - bitDepth - log2N
    qbits   = 14 + qp // 6 + transformShift
    dqshift = 20 - 14 - transformShift
Integer arithmetic is elementwise int32 (|coef| * scale < 2^30).

RDOQ prices candidate levels in float32. The reference's float32 costs
are those of its programs compiled by XLA for the CPU; the port follows
that order exactly (ops/fp32.py: the multiply-add contractions, XLA's
log, constants folded in float32, and the blocked prefix sums below), so
its levels equal the reference's on the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream import tables as T
from . import bitcost as BC, fp32

# Spec constants (H.265 sec 8.6.3)
QUANT_SCALES = (26214, 23302, 20560, 18396, 16384, 14564)
INV_QUANT_SCALES = (40, 45, 51, 57, 64, 72)
SBH_THRESHOLD = 4       # first-to-last distance in a CG that hides a sign
_F32 = np.float32


def transform_shift(log2_tr_size: int, bit_depth: int) -> int:
    return 15 - bit_depth - log2_tr_size


def _per_rem(qp, scales, like: torch.Tensor):
    """(qp // 6, scales[qp % 6]): ints, or int32 tensors [B, 1, 1]."""
    if isinstance(qp, int):
        return qp // 6, scales[qp % 6]
    q = qp.to(torch.int32).reshape(-1, 1, 1)
    tab = torch.tensor(scales, dtype=torch.int32, device=like.device)
    return q // 6, tab[(q % 6).long()]


def _matrix_at(tab: torch.Tensor, qp):
    """(qp // 6, tab's matrix at qp % 6): tab [1 or B, 6, N, N] (one
    table, or one per block); an int qp gives int and [1 or B, N, N], a
    per-block qp int32 [B, 1, 1] and [B, N, N]."""
    if isinstance(qp, int):
        return qp // 6, tab[:, qp % 6]
    q = qp.to(torch.int32).reshape(-1)
    t = tab.expand(q.shape[0], -1, -1, -1)
    return (q // 6).reshape(-1, 1, 1), \
        t[torch.arange(q.shape[0], device=tab.device), (q % 6).long()]


def quant(coef: torch.Tensor, qp, log2_tr_size: int, bit_depth: int = 8,
          is_intra_slice: bool = True, return_delta: bool = False,
          qtab: torch.Tensor = None):
    """Forward quant with the reference's RDO-less rounding offset
    (171/512 in I slices, 85/512 in P and B slices): int32 levels
    [..., N, N]; with return_delta also delta_u, each coefficient's
    rounding remainder in 1/256 steps (sign-bit hiding reads it). qtab:
    a scaling list's quant matrices [1 or B, 6, N, N] (quant_matrix: the
    scale of each coefficient, ScalingListData.quant_tables), None: the
    flat scale."""
    per, scale = _per_rem(qp, QUANT_SCALES, coef) if qtab is None else \
        _matrix_at(qtab, qp)
    qbits = 14 + per + transform_shift(log2_tr_size, bit_depth)
    off = 171 if is_intra_slice else 85
    add = off << (qbits - 9) if isinstance(qbits, int) else \
        torch.full_like(qbits, off) << (qbits - 9)
    c = coef.to(torch.int32)
    tmp = c.abs() * scale
    level = (tmp + add) >> qbits
    out = (level * torch.sign(c)).clamp(-32768, 32767)
    if not return_delta:
        return out
    return out, (tmp - (level << qbits)) >> (qbits - 8)


def dequant(levels: torch.Tensor, qp, log2_tr_size: int,
            bit_depth: int = 8, dqtab: torch.Tensor = None) -> torch.Tensor:
    """Flat-list dequant (dequant_normal): levels -> int32 coefficients;
    with dqtab, a scaling list's dequant matrices [1 or B, 6, N, N]
    (dequant_matrix)."""
    shift = 20 - 14 - transform_shift(log2_tr_size, bit_depth)
    if dqtab is not None:
        return dequant_matrix(levels, qp, shift, dqtab)
    per, scale = _per_rem(qp, INV_QUANT_SCALES, levels)
    scale = scale << per
    c = (levels.to(torch.int32) * scale + (1 << (shift - 1))) >> shift
    return c.clamp(-32768, 32767)


def dequant_matrix(levels: torch.Tensor, qp, shift: int,
                   dqtab: torch.Tensor) -> torch.Tensor:
    """Scaling-list dequant (the reference's dequant_scaling): with the
    flat shift + 4 - qp // 6 positive, (level * m + half) >> it, else the
    product clipped to int16 and shifted left; clipped to int16."""
    per, dq = _matrix_at(dqtab, qp)
    sp = shift + 4 - per
    prod = levels.to(torch.int32) * dq
    if isinstance(sp, int):
        out = (prod + (1 << (sp - 1))) >> sp if sp > 0 else \
            prod.clamp(-32768, 32767) << (-sp)
    else:
        spp = sp.clamp(min=1)
        out = torch.where(sp > 0,
                          (prod + (torch.ones_like(spp) << (spp - 1)))
                          >> spp,
                          prod.clamp(-32768, 32767) << (-sp).clamp(min=0))
    return out.clamp(-32768, 32767)


# ---------------------------------------------------------------------------
# sign-bit hiding
# ---------------------------------------------------------------------------

def _scans(log2n: int, device) -> torch.Tensor:
    """[3, nn] raster index of every scan position: diagonal, horizontal,
    vertical."""
    return torch.as_tensor(np.stack([T.scan_order(s, log2n) for s in (
        T.SCAN_DIAG, T.SCAN_HOR, T.SCAN_VER)]), device=device).long()


def sign_bit_hiding(levels: torch.Tensor, delta_u: torch.Tensor, log2n: int,
                    scan_type=T.SCAN_DIAG) -> torch.Tensor:
    """Sign-bit hiding (spec 7.4.9.11 signHidden): in each 4x4 coefficient
    group whose first and last nonzero coefficients (in scan order) are
    SBH_THRESHOLD or more apart, the decoder infers the first one's sign
    from the parity of the group's absolute sum. Where the parity
    disagrees, the coefficient of the span with the largest |delta_u|
    (the first such in scan order) moves one step away from zero (a zero
    becomes 1), which never moves the first or last nonzero position.

    levels / delta_u [B, N, N]; scan_type: one scan for every block, or an
    int tensor [B] (T.SCAN_DIAG / HOR / VER per block)."""
    n = 1 << log2n
    nn = n * n
    shp = levels.shape
    B = levels.numel() // nn
    dev = levels.device
    scans = _scans(log2n, dev)
    if isinstance(scan_type, int):
        idx = scans[scan_type].expand(B, nn)
    else:
        idx = scans[scan_type.reshape(-1).long()]
    rs = torch.gather(levels.reshape(B, nn), 1, idx).reshape(B, nn // 16, 16)
    rdu = torch.gather(delta_u.reshape(B, nn), 1, idx) \
        .reshape(B, nn // 16, 16)
    nz = rs != 0
    pos = torch.arange(16, device=dev)
    first = torch.where(nz, pos, 99).amin(-1)
    last = torch.where(nz, pos, -1).amax(-1)
    vfirst = torch.gather(rs, 2, first.clamp(max=15)[..., None])[..., 0]
    need = ((last - first) >= SBH_THRESHOLD) & \
        ((rs.abs().sum(-1) & 1) != (vfirst < 0).to(torch.int64))
    span = (pos >= first[..., None]) & (pos <= last[..., None])
    pick = torch.where(span, rdu.abs(), -1).argmax(-1)     # first maximum
    pv = torch.gather(rs, 2, pick[..., None])[..., 0]
    step = torch.where(need, torch.where(pv < 0, -1, 1), 0).to(rs.dtype)
    rs = rs + (pos == pick[..., None]).to(rs.dtype) * step[..., None]
    out = torch.empty_like(rs.reshape(B, nn))
    out.scatter_(1, idx, rs.reshape(B, nn))
    return out.reshape(shp)


def _mdcs_scan(log2n: int, modes: torch.Tensor, is_luma: bool,
              is_intra=None, csp420: bool = True) -> torch.Tensor:
    """The mode-dependent coefficient scan of each block (cudata.cpp
    getTUEntropyCodingParameters): intra TUs up to 8x8 luma (4x4 chroma
    in 4:2:0) scan horizontally for modes 22-30 and vertically for modes
    6-14; everything else, and inter blocks (is_intra False), scans
    diagonally. int64 [B], or the int T.SCAN_DIAG for a TU size that
    always scans diagonally."""
    if log2n > (3 if is_luma else 3 - int(csp420)):
        return T.SCAN_DIAG
    m = modes.reshape(-1).to(torch.int64)
    hor = (m >= 22) & (m <= 30)
    ver = (m >= 6) & (m <= 14)
    if is_intra is not None:
        hor = hor & is_intra.reshape(-1)
        ver = ver & is_intra.reshape(-1)
    return torch.where(hor, T.SCAN_HOR, torch.where(ver, T.SCAN_VER,
                                                    T.SCAN_DIAG))


def sign_bit_hiding_mdcs(levels, delta_u, log2n: int, modes, is_luma: bool,
                         is_intra=None, csp420: bool = True):
    """Sign-bit hiding under each block's mode-dependent scan (_mdcs_scan):
    the scan the writer codes the block with."""
    return sign_bit_hiding(levels, delta_u, log2n,
                           _mdcs_scan(log2n, modes, is_luma, is_intra, csp420))


# ---------------------------------------------------------------------------
# RDOQ
# ---------------------------------------------------------------------------

def seq_cumsum(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Prefix sums over the last axis, left to right, in x's dtype."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        if exclusive:
            out[..., i] = acc
        acc = acc + x[..., i]
        if not exclusive:
            out[..., i] = acc
    return out


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums over the last axis in the order of
    XLA's CPU rewrite of a cumulative sum: up to 16 entries left to
    right; longer axes in blocks of 16, each scanned so, plus the
    exclusive prefix sum of the block totals (the same rewrite, one level
    up)."""
    L = x.shape[-1]
    if L <= 16:
        return seq_cumsum(x)
    blocks = seq_cumsum(x.reshape(x.shape[:-1] + (L // 16, 16)))
    tot = blocks[..., -1]
    pre = seq_cumsum(tot, exclusive=True) if tot.shape[-1] <= 16 else \
        torch.cat([torch.zeros_like(tot[..., :1]),
                   xla_cumsum(tot)[..., :-1]], -1)
    return (blocks + pre[..., None]).reshape(x.shape)


def _lam_exp(qp: torch.Tensor) -> torch.Tensor:
    """2^((qp - 12) / 3) per block as the reference's programs compute it
    in float32 ([B, 1])."""
    tab = torch.as_tensor(fp32.lambda_table(1.0, 3.0), device=qp.device)
    return tab[qp.reshape(-1).long()].reshape(-1, 1)


def _rdoq_qp(qp, log2n: int, bit_depth: int, B: int, device):
    """(scale, iscale, qbits) as ints or [B, 1] int32 tensors."""
    tshift = transform_shift(log2n, bit_depth)
    if isinstance(qp, int):
        per, rem = qp // 6, qp % 6
        return (QUANT_SCALES[rem], INV_QUANT_SCALES[rem] << per,
                14 + per + tshift)
    q = qp.to(torch.int32).reshape(-1, 1).expand(B, 1)
    per, rem = q // 6, (q % 6).long()
    tab = lambda s: torch.tensor(s, dtype=torch.int32, device=device)[rem]
    return tab(QUANT_SCALES), tab(INV_QUANT_SCALES) << per, 14 + per + tshift


def _rdoq_levels(a, scale, qbits):
    """(lmax, llow): the rounded level (clipped to 32767) and one below."""
    add = (1 << (qbits - 1)) if isinstance(qbits, int) else \
        torch.ones_like(qbits) << (qbits - 1)
    lmax = ((a * scale + add) >> qbits).clamp(0, 32767)
    return lmax, (lmax - 1).clamp(min=0)


def _static_level_bits(lv: torch.Tensor) -> torch.Tensor:
    """The static RDOQ's bits of coding |level| lv (int): 1 for a zero (the
    significance flag), else 3 (flag, greater1, sign) + 1 above one + an
    Exp-Golomb-like 2 * log2(rem + 1) + 1 for rem = lv - 2 > 0."""
    rem = (lv - 2).clamp(min=0)
    rb = torch.where(rem > 0, fp32.eg_bits_int(rem + 1), _F32(0.0))
    return torch.where(lv <= 0, _F32(1.0),
                       torch.where(lv > 1, _F32(4.0), _F32(3.0)) + rb)


def _cg_sum16(x: torch.Tensor, n: int) -> torch.Tensor:
    """Sums of [..., n, n] float32 values over each 4x4 coefficient group,
    [..., n/4, n/4], raster order within the group."""
    g = x.reshape(x.shape[:-2] + (n // 4, 4, n // 4, 4)).transpose(-3, -2)
    g = g.reshape(g.shape[:-2] + (16,))
    return BC.seq_sum(g)


def quant_rdoq(coef: torch.Tensor, qp, log2_tr_size: int, bit_depth: int = 8,
               lambda_scale: float = 0.25, psy_scale: float = 0.0):
    """RD-optimised quantization with static bit estimates (the uniform
    programs' RDOQ): per coefficient the cheapest of {rounded level, one
    less, 0} at d^2 * 2^(-2 transformShift) + lambda2 * bits, then each
    4x4 group dropped when coding it costs more than leaving it out (plus
    2 lambda2 for its flag). lambda2 = 9.728 * 2^((qp - 12) / 3) *
    lambda_scale. psy_scale > 0 (psy-RDOQ, luma) subtracts psy_scale *
    lambda * recon >> (2 transformShift + 1) from the non-DC costs.
    Returns int32 signed levels [B, N, N]."""
    n = 1 << log2_tr_size
    tshift = transform_shift(log2_tr_size, bit_depth)
    c = coef.to(torch.int32)
    B = c.numel() // (n * n)
    dev = c.device
    scale, iscale, qbits = _rdoq_qp(qp, log2_tr_size, bit_depth, B, dev)
    if isinstance(qp, int):
        # one QP: the lambdas are host doubles rounded once to float32
        lam2_d = 9.728 * float(2.0 ** ((qp - 12) / 3.0)) * lambda_scale
        lam2 = _F32(lam2_d)
        if psy_scale > 0:
            lam1 = _F32(psy_scale * (lam2_d / (9.728 * lambda_scale)) ** 0.5)
    else:
        # a QP per block: float32 in the program, where XLA folds
        # lambda2 / (9.728 * lambda_scale) into 2^x times one constant
        e = _lam_exp(qp)
        lam2 = ((e * _F32(9.728)) * _F32(lambda_scale)).reshape(-1, 1, 1)
        if psy_scale > 0:
            k = (_F32(9.728) * _F32(lambda_scale)) * \
                (_F32(1.0) / _F32(9.728 * lambda_scale))
            lam1 = (torch.sqrt(e * k) * _F32(psy_scale)).reshape(-1, 1, 1)
    shp3 = lambda t: t.reshape(-1, 1, 1) if isinstance(t, torch.Tensor) \
        else t
    scale, iscale, qbits = shp3(scale), shp3(iscale), shp3(qbits)
    dqshift = 20 - 14 - tshift
    dqadd = 1 << (dqshift - 1)
    sign = torch.sign(c)
    a = c.abs()
    lmax, llow = _rdoq_levels(a, scale, qbits)
    unq = lambda l: (l * iscale + dqadd) >> dqshift
    sfac = _F32(2.0 ** (-2 * tshift))
    if psy_scale > 0:
        psy_w = lam1 * _F32(2.0 ** (-(2 * tshift + 1)))
        ac = torch.ones((n, n), dtype=torch.float32, device=dev)
        ac[0, 0] = 0.0
        psy_wa = psy_w * ac

    # float32 order as in quant_rdoq_ctx
    def cost(l):
        d = (a - unq(l)).float()
        cc = (d * d) * sfac
        bits = _static_level_bits(l)
        cc = cc + bits * lam2
        if psy_scale > 0:
            cc = fp32.fma(unq(l).float(), -psy_wa, cc)
        return cc

    c0, cmax, clow = cost(torch.zeros_like(a)), cost(lmax), cost(llow)
    best = torch.where(clow < cmax, llow, lmax)
    bc = torch.minimum(clow, cmax)
    best = torch.where(c0 < bc, 0, best)
    bc = torch.minimum(c0, bc)
    if n >= 8:
        coded, zero = _cg_sum16(bc, n), _cg_sum16(c0, n)
        drop = zero < coded + lam2 * _F32(2.0)
        drop = drop.repeat_interleave(4, -2).repeat_interleave(4, -1)
        best = torch.where(drop, 0, best)
    return (best * sign).clamp(-32768, 32767)


def quant_rdoq_ctx(coef: torch.Tensor, qp, log2_tr_size: int, bit_depth: int,
                   states, is_luma: bool, psy_scale: float = 0.0,
                   lambda_scale: float = 1.0) -> torch.Tensor:
    """RDOQ with CABAC-context bit costs at K9's frozen slice-init states
    (the quadtree programs' RDOQ): every candidate level is priced with the
    significance flag's context (the CG neighbour pattern from the
    rounded levels), the greater1 / greater2 flags at each CG's context
    set (c1 = 1), a Golomb-Rice remainder at a per-CG rice parameter
    bounded by the rounded levels, and one sign bit; then the last
    position is chosen over every candidate with its last_sig_coeff
    prefix cost, and CGs are dropped at their coded_sub_block_flag cost.
    lambda2 = 0.85 * 2^((qp - 12) / 3) * lambda_scale; psy_scale > 0 adds
    psy-RDOQ on luma. coef [B, N, N]; states: the packed slice-init
    context states (bitcost.init_states_dev). Returns int32 signed levels
    [B, N, N]."""
    n = 1 << log2_tr_size
    nn = n * n
    ncg = max(1, (n // 4) ** 2)
    dev = coef.device
    L = BC._luts(states, log2_tr_size, is_luma, dev)
    st = BC._tu_static(log2_tr_size, bool(is_luma))
    scan = L["scan"]
    tshift = transform_shift(log2_tr_size, bit_depth)
    c = coef.to(torch.int32).reshape(-1, nn)
    B = c.shape[0]
    scale, iscale, qbits = _rdoq_qp(qp, log2_tr_size, bit_depth, B, dev)
    if isinstance(qp, int):
        lam2_d = 0.85 * float(2.0 ** ((qp - 12) / 3.0)) * lambda_scale
        lam2 = _F32(lam2_d)
        if psy_scale > 0:
            lam1 = _F32(psy_scale * (lam2_d / (0.85 * lambda_scale)) ** 0.5)
    else:
        # a QP per block: as in quant_rdoq (XLA drops the * 1.0)
        e = _lam_exp(qp)
        lam2 = e * _F32(0.85)
        if lambda_scale != 1.0:
            lam2 = lam2 * _F32(lambda_scale)
        if psy_scale > 0:
            k = (_F32(0.85) * _F32(lambda_scale)) * \
                (_F32(1.0) / _F32(0.85 * lambda_scale))
            lam1 = torch.sqrt(e * k) * _F32(psy_scale)
    dqshift = 20 - 14 - tshift
    dqadd = 1 << (dqshift - 1)
    a = c.abs()
    lmax, llow = _rdoq_levels(a, scale, qbits)
    unq = lambda l: (l * iscale + dqadd) >> dqshift
    sfac = _F32(2.0 ** (-2 * tshift))
    asc, lmax_sc, llow_sc = a[:, scan], lmax[:, scan], llow[:, scan]
    sgn_sc = sign_at_scan(torch.sign(c), scan)
    if not isinstance(iscale, int):
        iscale = iscale.reshape(B, 1)

    # ---- context costs at the frozen states ------------------------------
    b0v, b1v = L["b0"], L["b1"]
    rep16 = lambda t: t.repeat_interleave(16, dim=-1)
    cg_nz = (lmax_sc.reshape(B, ncg, 16) > 0).any(-1)
    cg_idx = torch.arange(ncg, device=dev)
    if ncg > 1:
        side = n // 4
        grid = torch.zeros((B, ncg), dtype=torch.int32, device=dev)
        grid[:, L["cg_scan"]] = cg_nz.to(torch.int32)
        g2 = grid.reshape(B, side, side)
        right = torch.nn.functional.pad(g2[:, :, 1:], (0, 1))
        below = torch.nn.functional.pad(g2[:, 1:, :], (0, 0, 0, 1))
        rightf = right.reshape(B, ncg)[:, L["cg_scan"]]
        belowf = below.reshape(B, ncg)[:, L["cg_scan"]]
    else:
        rightf = belowf = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pattern = rep16(rightf + 2 * belowf)
    ctx_rel = torch.gather(L["sig_ctx"].t().expand(B, nn, 4), 2,
                           pattern.long()[..., None])[..., 0]
    sig_bank = BC.CTX["sig"] + (0 if is_luma else 27)
    sig0, sig1 = b0v[sig_bank + ctx_rel], b1v[sig_bank + ctx_rel]
    ctx_set = (2 if is_luma else 0) * (cg_idx > 0).long() + 1
    one_bank = BC.CTX["one"] + (0 if is_luma else 16)
    abs_bank = BC.CTX["abs"] + (0 if is_luma else 4)
    g1c0 = rep16(b0v[one_bank + 4 * ctx_set + 1])[None]
    g1c1 = rep16(b1v[one_bank + 4 * ctx_set + 1])[None]
    g2c0 = rep16(b0v[abs_bank + ctx_set])[None]
    g2c1 = rep16(b1v[abs_bank + ctx_set])[None]
    maxcg = lmax_sc.reshape(B, ncg, 16).amax(-1)
    rice = rep16((fp32.floor_log2_third(maxcg.clamp(min=1)) + 1).clamp(0, 4))

    def level_bits(l):
        """Bits of coding |level| l (scan order), the significance flag
        included."""
        b = (sig1 + torch.where(l > 1, g1c1, g1c0)) + _F32(1.0)
        b = b + torch.where(l > 1, torch.where(l > 2, g2c1, g2c0), _F32(0))
        b = b + torch.where(l > 2, BC._rice_len((l - 3).clamp(min=0), rice),
                            _F32(0))
        return torch.where(l > 0, b, sig0)

    def dist(l):
        d = (asc - unq(l)).float()
        return (d * d) * sfac

    if psy_scale > 0 and is_luma:
        psy_w = lam1 * _F32(2.0 ** (-(2 * tshift + 1)))
        ac = torch.ones(nn, dtype=torch.float32, device=dev)
        ac[0] = 0.0                              # scan slot 0 is DC
        psy_wa = (psy_w * ac[None]) * torch.ones((B, 1), device=dev)
    else:
        psy_wa = None

    # float32 order: d^2 * 2^-2s + lambda2 * bits rounds twice (LLVM
    # contracts the distortion's own product, exact by a power of two); a
    # product added to anything else contracts into one rounding
    def cost(l):
        cc = dist(l) + level_bits(l) * lam2
        if psy_wa is not None:
            cc = fp32.fma(unq(l).float(), -psy_wa, cc)
        return cc

    czer = cost(torch.zeros_like(asc))
    cmax = cost(lmax_sc)
    clow = cost(llow_sc)
    best = torch.where(clow < cmax, llow_sc, lmax_sc)
    bc = torch.minimum(clow, cmax)
    best = torch.where(czer < bc, 0, best)
    bc = torch.minimum(czer, bc)

    # ---- the last position ------------------------------------------------
    lastbits = L["valx"][(scan & (n - 1))] + L["valy"][(scan >> log2_tr_size)]
    cost_k = dist(best) + (level_bits(best) - sig1) * lam2
    cost_k = fp32.fma(lastbits[None].expand(B, nn), lam2, cost_k)
    if psy_wa is not None:
        cost_k = fp32.fma(-psy_wa, unq(best).float(), cost_k)
    cost_sfx = dist(torch.zeros_like(best))
    # both prefix sums in one pass (stacked): the chosen costs forward,
    # the uncoded distortions backward
    fwd, bwd = xla_cumsum(torch.stack([bc, cost_sfx.flip(-1)]))
    pre = fwd - bc
    sfx = torch.cat([bwd.flip(-1)[:, 1:], torch.zeros((B, 1), device=dev)],
                    -1)
    total = torch.where(best > 0, (pre + cost_k) + sfx, _F32(1e30))
    all_zero = BC.xla_sum(cost_sfx, 1)
    k_best = total.argmin(-1)                      # the first minimum
    keep = torch.arange(nn, device=dev)[None] <= k_best[:, None]
    use_zero = total.amin(-1) >= all_zero
    best = torch.where(keep & ~use_zero[:, None], best, 0)

    # ---- CG zeroing at the coded_sub_block_flag cost ---------------------
    if ncg > 1:
        cbase = BC.CTX["sig_cg"] + (0 if is_luma else 2)
        csbf1 = torch.where((rightf | belowf) > 0, b1v[cbase + 1], b1v[cbase])
        bcg = torch.where(best > 0, cost(best), czer)
        coded, zero = BC.seq_sum(torch.stack([bcg, czer]).reshape(
            2, B, ncg, 16))
        has_nz = (best.reshape(B, ncg, 16) > 0).any(-1)
        last_cg = cg_idx[None] == (k_best[:, None] // 16)
        drop = (zero < fp32.fma(csbf1, lam2, coded)) & has_nz & ~last_cg
        best = torch.where(rep16(drop), 0, best)

    out = torch.empty_like(best)
    out[:, scan] = best * sgn_sc
    return out.clamp(-32768, 32767).reshape(coef.shape)


def est_tu_bits(levels: np.ndarray) -> np.ndarray:
    """The static bit estimate of TUs (the CTU64 program's RD), on the
    host: levels [B, N*N] (numpy) -> float32 [B], each nonzero level's
    static RDOQ bits (_static_level_bits) summed left to right in raster
    order in float32, as the reference's compiled program sums them
    (numpy's add.accumulate is strictly sequential; on the device the
    chain would take a launch per element), plus 6 for a TU with any."""
    a = np.abs(levels)
    rem = np.maximum(a - 2, 0)
    rb = np.where(rem > 0, fp32.eg_bits_host(rem + 1), _F32(0.0))
    bits = np.where(a > 0, np.where(a > 1, _F32(4.0), _F32(3.0)) + rb,
                    _F32(0.0)).astype(_F32)
    return (np.add.accumulate(bits, axis=1, dtype=_F32)[:, -1]
            + np.where(a.any(1), _F32(6.0), _F32(0.0))).astype(_F32)


# ---------------------------------------------------------------------------
# noise reduction (the reference's --nr-intra: dct.cpp denoiseDct_c and
# frameencoder.cpp noiseReductionUpdate)
# ---------------------------------------------------------------------------

def denoise_dct(coef: torch.Tensor, offset):
    """|coef| lowered by offset (>= 0, broadcast against coef's last two
    axes) and clamped at 0, its sign restored: (denoised coef, |coef|
    before), int32. A shape that does not broadcast raises ValueError,
    as the reference's program does."""
    c = coef.to(torch.int32)
    off = torch.as_tensor(offset, dtype=torch.int32, device=c.device)
    if off.ndim and tuple(off.shape) != tuple(c.shape[-off.ndim:]):
        raise ValueError("Incompatible shapes for broadcasting: shapes="
                         f"[{tuple(c.shape)}, {tuple(off.shape)}]")
    a = c.abs()
    return (a - off).clamp(min=0) * torch.sign(c), a


def nr_update_offsets(res_sum: np.ndarray, count: int, strength: int,
                      max_blocks: int):
    """The denoise offsets from running |coef| sums (host): res_sum int64
    [ncoef] over count blocks; past max_blocks both are halved first.
    Returns (offsets int32 [ncoef] with a zero DC, res_sum, count)."""
    if count > max_blocks:
        res_sum = res_sum >> 1
        count >>= 1
    off = ((int(strength) * int(count) + res_sum // 2) // (res_sum + 1)) \
        .astype(np.int32)
    off[0] = 0
    return off, res_sum, count


def sign_at_scan(sign: torch.Tensor, scan: torch.Tensor) -> torch.Tensor:
    """Signs [B, nn] (raster) in scan order."""
    return sign[:, scan]


class Quantizer:
    """A program's choice of levels for its residual blocks: the plain
    rounding, with sign-bit hiding, or RDOQ (static bits on the uniform
    grid, context bits at K9's frozen states in the quadtree programs).
    sbh and rdoq exclude each other (the sessions switch sign hiding off
    under RDOQ); psy_rdoq is the psy-RDOQ strength on luma. bit_depth is
    the samples': the programs pass the signalled QP, and the quantizer
    adds QpBdOffset = 6 (bit_depth - 8) before it quantizes or
    dequantizes, as the reference's programs add it to every QP they
    quantize at (RDOQ's lambda included). scaling: a ScalingListData
    (bitstream/scaling.py) whose intra matrices scale the plain rounding
    and the dequant (the reference's uniform intra program; the sessions
    drop it under RDOQ); a chroma batch is its Cb blocks, then its Cr
    blocks, each half at its own list."""

    def __init__(self, sbh: bool = False, rdoq: bool = False,
                 psy_rdoq: float = 0.0, bit_depth: int = 8, scaling=None,
                 csp420: bool = True):
        self.sbh, self.rdoq = bool(sbh) and not rdoq, bool(rdoq)
        # the chroma format of the sign-hiding scan (4:4:4 chroma scans
        # as luma by size)
        self.csp420 = bool(csp420)
        self.psy_rdoq = float(psy_rdoq) if rdoq else 0.0
        self.bit_depth = bit_depth
        self.qp_offset = 6 * (bit_depth - 8)
        self.scaling = None if rdoq else scaling
        self._tabs = {}

    def tables(self, log2n: int, luma: bool, nblocks: int, device):
        """(quant, dequant) matrices of the scaling lists for a batch of
        nblocks blocks ([1, 6, N, N] luma; chroma: Cb's for the first
        half, Cr's for the second, [nblocks, 6, N, N]), or (None, None)
        without scaling lists."""
        if self.scaling is None:
            return None, None
        key = (log2n, luma, str(device))
        if key not in self._tabs:
            t = [self.scaling.quant_tables(log2n, k)
                 for k in ((0,) if luma else (1, 2))]
            self._tabs[key] = tuple(
                torch.as_tensor(np.stack([a[i] for a in t]), device=device)
                for i in (0, 1))
        q, dq = self._tabs[key]
        if luma:
            return q, dq
        half = nblocks // 2
        pick = (torch.arange(nblocks, device=device) >= half).long()
        return q[pick], dq[pick]

    def __call__(self, coef: torch.Tensor, qp, log2n: int,
                 intra_slice: bool, luma: bool = True, modes=None,
                 is_intra=None, states=None) -> torch.Tensor:
        """Levels of coef [B, N, N] at qp (int or [B]). modes / is_intra:
        the blocks' intra modes and intra flags for the mode-dependent
        sign-hiding scan (modes None: the diagonal scan; is_intra None:
        every block intra). states: the slice's frozen contexts (the
        quadtree programs' context RDOQ; None: static RDOQ)."""
        bd = self.bit_depth
        qp = qp + self.qp_offset
        if self.rdoq:
            # the programs pass a QP per block, and RDOQ's float32 lambda
            # is that form's
            if isinstance(qp, int):
                qp = torch.full((coef.shape[0],), qp, dtype=torch.int32,
                                device=coef.device)
            psy = self.psy_rdoq if luma else 0.0
            if states is None:
                return quant_rdoq(coef, qp, log2n, bd, psy_scale=psy)
            return quant_rdoq_ctx(coef, qp, log2n, bd, states, luma,
                                  psy_scale=psy)
        qtab = self.tables(log2n, luma, coef.shape[0], coef.device)[0]
        if not self.sbh:
            return quant(coef, qp, log2n, bd, intra_slice, qtab=qtab)
        lv, du = quant(coef, qp, log2n, bd, intra_slice, return_delta=True,
                       qtab=qtab)
        if modes is None:
            return sign_bit_hiding(lv, du, log2n)
        return sign_bit_hiding_mdcs(lv, du, log2n, modes, luma, is_intra,
                                    self.csp420)

    def dequant(self, levels: torch.Tensor, qp, log2n: int,
                luma: bool = True) -> torch.Tensor:
        """dequant at the signalled qp (int or [B]) and the samples' bit
        depth (with the scaling lists' matrices of luma or chroma)."""
        dqtab = self.tables(log2n, luma, levels.shape[0], levels.device)[1]
        return dequant(levels, qp + self.qp_offset, log2n, self.bit_depth,
                       dqtab)


PLAIN = Quantizer()
