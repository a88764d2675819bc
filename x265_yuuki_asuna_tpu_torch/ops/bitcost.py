"""K9 — the frozen-context CABAC bit model that prices the quadtree RD.

Port of x265_yuuki_asuna_tpu/ops/bitcost.py (entropy_bits_table,
init_states_dev, state_bit_luts, chain_lookup, _tu_static, _rice_len,
est_tu_bits_ctx with its sign_hiding branch, mvd_bits). Every context is frozen at its slice-init
state (spec 9.3.2.2) and a bin costs the entropy of the state's LPS
probability, pLPS(sigma) = 0.5 * alpha^sigma with alpha =
(0.01875/0.5)^(1/63), the model behind the spec's rangeTabLps. A TU's
residual_coding() cost (last position, coded-sub-block flags, the
significance map with the spec's context derivation, greater1/greater2
chains, signs and Golomb-Rice remainders) is one vectorised pass over a
batch of TUs. It is plain PyTorch: the reference computes it in jnp, not
in a Pallas kernel.

Exactness. The bit values are float32 sums of fractional bin costs, and
a float32 sum depends on its order. The reference's order is the one
XLA's CPU compiler emits, which the port reproduces where it has been
measured (`xla_sum`, `cg_sum`, `_matvec18`: the standalone program's
reductions and last-position table). Inside a larger fusion XLA may emit
another order, so a TU's estimate can differ from the reference's in the
last place; the RD decisions differ only on costs that tie to within
that place. The slice-init states and the tables derived from them are
computed once per slice on the host, so the card and the CPU price a TU
alike.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..bitstream import tables as T
from . import fp32

CTX = T.CTX_OFFSET

_ALPHA = (0.01875 / 0.5) ** (1.0 / 63.0)


@lru_cache(maxsize=None)
def entropy_bits_table() -> np.ndarray:
    """[128, 2] float32: bits of coding bin b from packed state
    s = (sigma << 1) | MPS."""
    out = np.zeros((128, 2), np.float32)
    for s in range(128):
        sigma, mps = s >> 1, s & 1
        p_lps = 0.5 * (_ALPHA ** sigma)
        out[s, mps] = -np.log2(1.0 - p_lps)
        out[s, 1 - mps] = -np.log2(p_lps)
    return out


def init_states_dev(slice_type: int, qp: int) -> np.ndarray:
    """Spec 9.3.2.2 context init for slice type 0 = B, 1 = P, 2 = I:
    packed states [NUM_CTX] int32 (host)."""
    return np.frombuffer(T.init_all_contexts(slice_type, qp),
                         np.uint8).astype(np.int32)


def state_bit_luts(states: np.ndarray):
    """(b0, b1) [NUM_CTX] float32: bits of coding bin 0 / bin 1 in every
    context at its frozen state."""
    f = entropy_bits_table().reshape(-1)
    s = np.asarray(states)
    return f[s * 2], f[s * 2 + 1]


def chain_lookup(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec[idx]. The reference's K-way select chain (a TPU gather
    workaround) adds exact zeros to the one selected entry, so it equals
    this gather."""
    return vec[idx.long()]


@lru_cache(maxsize=None)
def _tu_static(log2n: int, is_luma: bool):
    """Static geometry of one TU size: scan maps, per-position context
    bases, last-position prefix tables."""
    n = 1 << log2n
    nn = n * n
    scan = T.scan_order(T.SCAN_DIAG, log2n)            # scan slot -> raster
    ncg_side = max(1, n >> 2)
    ncg = ncg_side * ncg_side
    cg_scan = (T.scan_order_cg(T.SCAN_DIAG, max(0, log2n - 2))
               if ncg > 1 else np.zeros(1, np.int32))  # cg slot -> cg raster
    first_ctx = 0
    if log2n == 3:
        first_ctx = 9
    elif log2n >= 4:
        first_ctx = 21 if is_luma else 12
    pos_in_cg = np.zeros(nn, np.int32)
    in_first_cg = np.zeros(nn, np.int32)
    for sp in range(nn):
        p = int(scan[sp])
        x, y = p & (n - 1), p >> log2n
        pos_in_cg[sp] = ((y & 3) << 2) | (x & 3)
        in_first_cg[sp] = 1 if (x < 4 and y < 4) else 0
    # sig ctx of every (pattern, scan slot): [4, nn]
    sig_ctx = np.zeros((4, nn), np.int32)
    for pat in range(4):
        for sp in range(nn):
            if log2n == 2:
                sig_ctx[pat, sp] = int(T.SIG_CTX_PATTERN[4][pos_in_cg[sp]])
            elif int(scan[sp]) == 0:
                sig_ctx[pat, sp] = 0
            else:
                cnt = int(T.SIG_CTX_PATTERN[pat][pos_in_cg[sp]])
                sig_ctx[pat, sp] = (cnt + first_ctx
                                    + (3 if (is_luma and not in_first_cg[sp])
                                       else 0))
    # last-position prefix: per coordinate value v < n, the count of 1-bins
    # and 0-bins in each context (relative to the last_x/last_y bank) and
    # the bypass suffix length
    max_group = (log2n << 1) - 1
    if is_luma:
        base_rel = 3 * (log2n - 2) + (1 if log2n == 5 else 0)
        shift = (log2n + 1) >> 2
    else:
        base_rel = 15
        shift = log2n - 2
    last_ones = np.zeros((n, 18), np.float32)
    last_zeros = np.zeros((n, 18), np.float32)
    last_ep = np.zeros(n, np.float32)
    for v in range(n):
        g = int(T.GROUP_IDX[v])
        for i in range(g):
            last_ones[v, base_rel + (i >> shift)] += 1
        if g < max_group:
            last_zeros[v, base_rel + (g >> shift)] += 1
        if g > 3:
            last_ep[v] = (g >> 1) - 1
    return dict(n=n, nn=nn, scan=scan, ncg_side=ncg_side, ncg=ncg,
                cg_scan=cg_scan, sig_ctx=sig_ctx, last_ones=last_ones,
                last_zeros=last_zeros, last_ep=last_ep)


def _rice_len(code: torch.Tensor, rice: torch.Tensor) -> torch.Tensor:
    """Golomb-Rice coeff_abs_level_remaining length in bits (float32);
    code >= 0."""
    q = code >> rice
    short = q + 1 + rice
    cn = (q - 3).clamp(min=0)
    length = fp32.floor_log2_int(cn + 1)
    long_ = (3 + length + 1) + (length + rice)
    return torch.where(q < 3, short, long_).float()


def _matvec18(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """float32 m @ v for m [n, 18] in the reference's order (XLA's CPU
    matrix-vector emitter): products of columns 0-7 and 8-15 add
    lane-wise, the 8 lanes fold as a tree (adjacent pairs from 8 rows up,
    halves for 4 rows), then the sum of columns 16 and 17 adds on."""
    f32 = np.float32
    p = (m * v[None, :]).astype(f32)
    acc = (p[:, 0:8] + p[:, 8:16]).astype(f32)
    while acc.shape[1] > 1:
        if m.shape[0] >= 8:
            acc = (acc[:, 0::2] + acc[:, 1::2]).astype(f32)
        else:
            h = acc.shape[1] // 2
            acc = (acc[:, :h] + acc[:, h:]).astype(f32)
    return (acc[:, 0] + (p[:, 16] + p[:, 17])).astype(f32)


_LUT_CACHE = {}


def _luts(states, log2n: int, is_luma: bool, device):
    """Per-slice tables on `device`: (b0v, b1v, valx, valy, static device
    tensors). valx[v] / valy[v] is the cost of last coordinate v, computed
    on the host in float32 as the reference's small matmuls do."""
    st_np = np.asarray(states, np.int32)
    key = (st_np.tobytes(), log2n, is_luma, str(device))
    if key not in _LUT_CACHE:
        st = _tu_static(log2n, bool(is_luma))
        b0, b1 = state_bit_luts(st_np)
        lo, lz, lep = st["last_ones"], st["last_zeros"], st["last_ep"]
        val = {}
        for ax in ("last_x", "last_y"):
            c = CTX[ax]
            val[ax] = (_matvec18(lo, b1[c:c + 18])
                       + _matvec18(lz, b0[c:c + 18])) + lep
        d = lambda a: torch.as_tensor(a).to(device)
        valx, valy = val["last_x"], val["last_y"]
        _LUT_CACHE[key] = dict(
            b0=d(b0), b1=d(b1), valx=d(valx), valy=d(valy),
            scan=d(st["scan"]).long(), cg_scan=d(st["cg_scan"]).long(),
            sig_ctx=d(st["sig_ctx"]).long())
    return _LUT_CACHE[key]


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right, in x's dtype."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def xla_sum(x: torch.Tensor, nd: int) -> torch.Tensor:
    """float32 sum over the last `nd` axes in the reference's order: the
    reduced elements in row-major order, left to right, where the first
    reduced axis has at most 32 entries; a longer first axis is cut into
    windows of 32 entries, each window summed so, then the window sums
    likewise (the tree-reduction rewrite of XLA's CPU compiler). Sums of
    fractional bits differ in their last place under any other order."""
    lead, red = x.shape[:-nd], x.shape[-nd:]
    m, k = red[0], int(np.prod(red[1:]))
    flat = x.reshape(lead + (m * k,))
    if m <= 32:
        return seq_sum(flat)
    assert m % 32 == 0, red
    return xla_sum(seq_sum(flat.reshape(lead + (m // 32, 32 * k))), 1)


def cg_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of [B, ncg, 16] per-CG values over both axes in the
    reference's order. Up to 32 CGs XLA's CPU compiler fuses the sum and
    LLVM vectorises its inner loop: per CG, the running sum enters lane 0
    of an 8-lane accumulator, the two 8-wide halves of the CG add
    lane-wise, and the lanes fold as a tree (4, 2, 1). 64 CGs are summed
    as two windows of 32 CGs, each left to right over its 512 values."""
    B, ncg, _ = x.shape
    if ncg > 32:
        return xla_sum(x, 2)
    s = torch.zeros(B, dtype=x.dtype, device=x.device)
    for r in range(ncg):
        v = x[:, r, :8] + x[:, r, 8:]
        v[:, 0] = (s + x[:, r, 0]) + x[:, r, 8]
        v = v[:, :4] + v[:, 4:]
        v = v[:, :2] + v[:, 2:]
        s = v[:, 0] + v[:, 1]
    return s


def _prev_gt1_cg(cg_nz: torch.Tensor, had_gt1: torch.Tensor) -> torch.Tensor:
    """For each CG j, had_gt1 of the nearest coded CG after j in scan order
    (0 when there is none): the ctxSet carry of the reverse CG scan."""
    B, ncg = cg_nz.shape
    idx = torch.arange(ncg, device=cg_nz.device)
    # mark coded CGs; for each j the smallest coded index > j
    marked = torch.where(cg_nz, idx, torch.full_like(idx, ncg))
    nxt = marked.flip(-1).cummin(-1).values.flip(-1)      # smallest >= j
    nxt = torch.cat([nxt[:, 1:], torch.full((B, 1), ncg, dtype=nxt.dtype,
                                            device=nxt.device)], 1)
    padded = torch.cat([had_gt1.to(torch.int32),
                        torch.zeros((B, 1), dtype=torch.int32,
                                    device=had_gt1.device)], 1)
    return torch.gather(padded, 1, nxt)


def est_tu_bits_ctx(levels: torch.Tensor, log2n: int, is_luma: bool,
                    states, sign_hiding: bool = False) -> torch.Tensor:
    """Estimated residual_coding() bits for a batch of TUs.

    levels: int [..., N, N] quantized levels (raster). states: [NUM_CTX]
    packed slice-init states (init_states_dev). sign_hiding: each CG whose
    first and last nonzero levels are 4 or more scan positions apart
    codes one sign fewer. Returns float32 [...]; all-zero TUs cost 0 (the
    caller prices the cbf flags)."""
    L = _luts(states, log2n, is_luma, levels.device)
    st = _tu_static(log2n, bool(is_luma))
    n, nn, ncg = st["n"], st["nn"], st["ncg"]
    side = st["ncg_side"]
    dev = levels.device
    shp = levels.shape[:-2]
    B = int(np.prod(shp)) if len(shp) else 1
    b0v, b1v = L["b0"], L["b1"]
    a = levels.reshape(B, nn).to(torch.int32).abs()[:, L["scan"]]
    sig = (a > 0).to(torch.int32)
    pos = torch.arange(nn, dtype=torch.int32, device=dev)
    lastp = torch.where(sig > 0, pos, -1).amax(-1)                 # [B]
    any_nz = lastp >= 0
    lastp_c = lastp.clamp(min=0)

    # ---- last position prefix/suffix ------------------------------------
    last_raster = L["scan"][lastp_c.long()]
    lx = last_raster & (n - 1)
    ly = last_raster >> log2n
    bits_last = chain_lookup(L["valx"], lx) + chain_lookup(L["valy"], ly)

    # ---- CG-level maps ----------------------------------------------------
    acg = a.reshape(B, ncg, 16)
    sigcg = sig.reshape(B, ncg, 16)
    cg_nz = (acg > 0).any(-1)                                     # scan order
    cg_idx = torch.arange(ncg, dtype=torch.int32, device=dev)
    last_cg = lastp_c >> 4
    if ncg > 1:
        grid = torch.zeros((B, ncg), dtype=torch.int32, device=dev)
        grid[:, L["cg_scan"]] = cg_nz.to(torch.int32)
        g2 = grid.reshape(B, side, side)
        right = torch.nn.functional.pad(g2[:, :, 1:], (0, 1))
        below = torch.nn.functional.pad(g2[:, 1:, :], (0, 0, 0, 1))
        rightf = right.reshape(B, ncg)[:, L["cg_scan"]]
        belowf = below.reshape(B, ncg)[:, L["cg_scan"]]
    else:
        rightf = belowf = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pattern = rightf + 2 * belowf

    # ---- coded_sub_block_flag ---------------------------------------------
    mid = (cg_idx[None, :] > 0) & (cg_idx[None, :] < last_cg[:, None])
    cbase = CTX["sig_cg"] + (0 if is_luma else 2)
    rb = (rightf | belowf) > 0
    csbf_cost = torch.where(cg_nz, torch.where(rb, b1v[cbase + 1], b1v[cbase]),
                            torch.where(rb, b0v[cbase + 1], b0v[cbase]))
    bits_csbf = xla_sum(torch.where(mid, csbf_cost, 0.0), 1)

    # ---- significance map -------------------------------------------------
    rep16 = lambda t: t.repeat_interleave(16, dim=-1)
    cg_coded = (cg_nz | (cg_idx[None, :] == 0)
                | (cg_idx[None, :] == last_cg[:, None]))
    sig_coded = (pos[None, :] < lastp[:, None]) & rep16(cg_coded)
    others_nz = sigcg[:, :, 1:].sum(-1) > 0
    infer_dc = mid & cg_nz & ~others_nz
    sig_coded = sig_coded & ~(((pos & 15) == 0)[None, :] & rep16(infer_dc))
    ctx_rel = torch.gather(L["sig_ctx"].t().expand(B, nn, 4), 2,
                           rep16(pattern).long()[..., None])[..., 0]
    sig_bank = CTX["sig"] + (0 if is_luma else 27)
    sig_cost = torch.where(sig > 0, chain_lookup(b1v[sig_bank:], ctx_rel),
                           chain_lookup(b0v[sig_bank:], ctx_rel))
    bits_sig = xla_sum(torch.where(sig_coded, sig_cost, 0.0), 1)

    # ---- level flags (greater1 / greater2), reverse scan per CG -----------
    arev = acg.flip(-1)
    srev = (arev > 0).to(torch.int32)
    rank = srev.cumsum(-1) - srev
    g1_coded = (srev > 0) & (rank < 8)
    g1val = (arev > 1).to(torch.int32)
    g1c = g1val * g1_coded
    prev_gt1 = g1c.cumsum(-1) - g1c
    c1 = torch.where(prev_gt1 > 0, 0, (1 + rank).clamp(max=3))
    had_gt1 = (g1c > 0).any(-1)
    ctx_set = ((2 if is_luma else 0) * (cg_idx[None, :] > 0).to(torch.int32)
               + torch.where(_prev_gt1_cg(cg_nz, had_gt1) > 0, 0, 1))
    one_bank = CTX["one"] + (0 if is_luma else 16)
    abs_bank = CTX["abs"] + (0 if is_luma else 4)
    g1_rel = 4 * ctx_set[..., None] + c1
    g1_cost = torch.where(g1val > 0, chain_lookup(b1v[one_bank:], g1_rel),
                          chain_lookup(b0v[one_bank:], g1_rel))
    bits_g1 = cg_sum(torch.where(g1_coded, g1_cost, 0.0))
    first_c2 = g1_coded & (g1val > 0) & (prev_gt1 == 0)
    g2_rel = ctx_set[..., None].expand(g1val.shape)
    g2_cost = torch.where(arev > 2, chain_lookup(b1v[abs_bank:], g2_rel),
                          chain_lookup(b0v[abs_bank:], g2_rel))
    bits_g2 = cg_sum(torch.where(first_c2, g2_cost, 0.0))

    # ---- signs ------------------------------------------------------------
    nsig_cg = srev.sum(-1)
    if sign_hiding:
        posk = torch.arange(16, device=dev)
        firstk = torch.where(sigcg > 0, posk, 99).amin(-1)
        lastk = torch.where(sigcg > 0, posk, -1).amax(-1)
        nsig_cg = (nsig_cg - ((lastk - firstk) >= 4).to(nsig_cg.dtype)) \
            .clamp(min=0)
    bits_sign = nsig_cg.sum(-1).float()

    # ---- remaining levels (Golomb-Rice, running-max rice bound) -----------
    base_level = torch.where(rank >= 8, 1, torch.where(first_c2, 3, 2)) * srev
    rem_coded = (srev > 0) & (arev >= base_level) & (base_level > 0)
    prevmax = torch.cat([torch.zeros((B, ncg, 1), dtype=torch.int32,
                                     device=dev),
                         torch.where(srev > 0, arev, 0)[..., :-1]], -1)
    runmax = prevmax.cummax(-1).values
    rice = (fp32.floor_log2_third(runmax.clamp(min=1)) + 1).clamp(0, 4)
    rem = (arev - base_level).clamp(min=0)
    bits_rem = torch.where(rem_coded, _rice_len(rem, rice), 0.0).sum((-2, -1))

    total = (bits_last + bits_csbf + bits_sig + bits_g1 + bits_g2
             + bits_sign + bits_rem)
    total = torch.where(any_nz, total, 0.0)
    return total.reshape(shp) if len(shp) else total[0]


def mvd_bits(mvd: torch.Tensor, states) -> torch.Tensor:
    """abs_mvd bits of one component (spec 7.3.8.9): greater0 + greater1
    flags (context-coded) + EG1 remainder + sign (bypass), float32."""
    b0v, b1v = (torch.as_tensor(b).to(mvd.device)
                for b in state_bit_luts(states))
    a = mvd.to(torch.int32).abs()
    c0, c1 = CTX["mvd"], CTX["mvd"] + 1
    b0 = torch.where(a > 0, b1v[c0], b0v[c0])
    b1 = torch.where(a > 0, torch.where(a > 1, b1v[c1], b0v[c1]), 0.0)
    v = (a - 2).clamp(min=0).float()
    k = torch.floor(torch.log2(v / 2.0 + 1.0))
    eg1 = torch.where(a > 1, 2.0 * k + 2.0, 0.0)
    sign = torch.where(a > 0, 1.0, 0.0)
    return b0 + b1 + eg1 + sign
