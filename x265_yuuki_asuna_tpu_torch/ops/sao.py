"""Sample Adaptive Offset: classification, per-CTU statistics, decision and
application, on whole planes (spec 8.7.3; the syntax is the native
writer's).

Port of x265_yuuki_asuna_tpu/ops/sao.py (the host form the uniform-grid
session runs) and of the SAO half of ops/filters_dev.py (the form inside
the quadtree programs). The two forms compute the same statistics and the
same offsets; they differ only in how the float32 cost `d + lam * bits`
rounds and in the lambda's last place, so one implementation serves both
and takes the form as an argument:

- "host": the lambda from numpy's float32 exp2, the cost rounded after
  the product and again after the sum;
- "program": the lambda as the compiled program evaluates it, the cost
  rounded once (the compiler contracts the product and the sum into a
  fused multiply-add).

One plane's SAO keys every sample once per EO class and once for its BO
band: key = tile * 52 + bin, with bins 5 * class + category (20 EO bins)
then 20 + band. The statistics are one bincount and one index_add_ over
those keys (exact integers), and the application gathers the per-tile
offset table at the same keys.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SAO_OFF, SAO_BO, SAO_EO = 0, 1, 2
NBINS = 52                  # 4 EO classes x 5 categories + 32 bands

# EO neighbour offsets per class: 0 = horizontal, 1 = vertical, 2 = 135
# degrees, 3 = 45 degrees
EO_NEIGHBORS = (((0, -1), (0, 1)), ((-1, 0), (1, 0)), ((-1, -1), (1, 1)),
                ((-1, 1), (1, -1)))
_SENT = 1 << 30             # padding: a missing neighbour
_CAT = (1, 2, 0, 3, 4)      # 2 + sign + sign -> EO category

# SSD-per-bit lambda 0.85 * 2^((qp - 12) / 3) in float32 per QP 0..51, as
# IEEE bit patterns: numpy's float32 exp2 ("host") and the compiled
# program's exp(x ln 2) ("program") differ in the last place at 24 QPs.
_LAMBDA_BITS = {
    "host": (
        0x3d59999a, 0x3d891454, 0x3dacb591, 0x3dd9999a, 0x3e091454,
        0x3e2cb591, 0x3e59999a, 0x3e891455, 0x3eacb591, 0x3ed9999a,
        0x3f091454, 0x3f2cb591, 0x3f59999a, 0x3f891455, 0x3facb591,
        0x3fd9999a, 0x40091455, 0x402cb591, 0x4059999a, 0x40891454,
        0x40acb591, 0x40d9999a, 0x41091454, 0x412cb591, 0x4159999a,
        0x41891456, 0x41acb590, 0x41d9999a, 0x42091456, 0x422cb590,
        0x4259999a, 0x42891456, 0x42acb590, 0x42d9999a, 0x43091456,
        0x432cb590, 0x4359999a, 0x43891452, 0x43acb593, 0x43d9999a,
        0x44091452, 0x442cb593, 0x4459999a, 0x44891452, 0x44acb593,
        0x44d9999a, 0x45091452, 0x452cb593, 0x4559999a, 0x45891452,
        0x45acb593, 0x45d9999a),
    "program": (
        0x3d59999a, 0x3d891455, 0x3dacb591, 0x3dd9999a, 0x3e091455,
        0x3e2cb591, 0x3e59999a, 0x3e891455, 0x3eacb591, 0x3ed9999a,
        0x3f091455, 0x3f2cb591, 0x3f59999a, 0x3f891455, 0x3facb591,
        0x3fd9999a, 0x40091455, 0x402cb591, 0x4059999a, 0x40891455,
        0x40acb591, 0x40d9999a, 0x41091455, 0x412cb591, 0x4159999a,
        0x41891455, 0x41acb591, 0x41d9999a, 0x42091455, 0x422cb591,
        0x4259999a, 0x42891455, 0x42acb591, 0x42d9999a, 0x43091455,
        0x432cb591, 0x4359999a, 0x43891455, 0x43acb591, 0x43d9999a,
        0x44091455, 0x442cb591, 0x4459999a, 0x44891455, 0x44acb591,
        0x44d9999a, 0x45091455, 0x452cb597, 0x4559999a, 0x45891450,
        0x45acb591, 0x45d999a1)}
FORMS = tuple(_LAMBDA_BITS)


def sao_lambda(qp: int, form: str) -> np.float32:
    """The SAO decision's lambda at a slice QP, float32."""
    return np.uint32(_LAMBDA_BITS[form][qp]).view(np.float32)


def eo_category(plane: torch.Tensor, eo_class: int) -> torch.Tensor:
    """Per-sample EO category (0 = none, 1..4) of one class; samples whose
    neighbour lies outside the picture are category 0. plane: int32."""
    H, W = plane.shape
    pp = F.pad(plane, (1, 1, 1, 1), value=_SENT)
    (dy0, dx0), (dy1, dx1) = EO_NEIGHBORS[eo_class]
    n0 = pp[1 + dy0:1 + dy0 + H, 1 + dx0:1 + dx0 + W]
    n1 = pp[1 + dy1:1 + dy1 + H, 1 + dx1:1 + dx1 + W]
    valid = (n0 != _SENT) & (n1 != _SENT)
    raw = 2 + torch.sign(plane - torch.where(valid, n0, plane)) \
        + torch.sign(plane - torch.where(valid, n1, plane))
    cat = torch.tensor(_CAT, dtype=torch.int32, device=plane.device)[raw.long()]
    return torch.where(valid, cat, 0)


def max_offset(bit_depth: int) -> int:
    """The largest |offset|: (1 << (min(bd, 10) - 5)) - 1 (7 at 8 bits,
    31 above). The offsets apply unscaled at every bit depth: the PPS
    signals no log2_sao_offset_scale (the range extension's, 0)."""
    return (1 << (min(bit_depth, 10) - 5)) - 1


def bo_band(plane: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """The BO band (of 32) of each sample: its top 5 bits."""
    return plane >> (bit_depth - 5)


def sao_keys(rec: torch.Tensor, n: int, bit_depth: int = 8) -> torch.Tensor:
    """[5, H, W] int64 keys tile * 52 + bin of every sample: its EO
    category under each class, then its band."""
    H, W = rec.shape
    dev = rec.device
    tile = ((torch.arange(H, device=dev) // n)[:, None] * (W // n)
            + (torch.arange(W, device=dev) // n)[None, :]) * NBINS
    bins = [5 * c + eo_category(rec, c) for c in range(4)] + \
        [20 + bo_band(rec, bit_depth)]
    return tile + torch.stack(bins).long()


def sao_stats(rec: torch.Tensor, src: torch.Tensor, n: int, keys=None,
              bit_depth: int = 8):
    """Per-CTU (n x n tiles) sums of src - rec and sample counts, int64:
    ((eo_s, eo_c) [4, 5, rows, cols], (bo_s, bo_c) [32, rows, cols])."""
    H, W = rec.shape
    rows, cols = H // n, W // n
    keys = sao_keys(rec, n, bit_depth) if keys is None else keys
    flat = keys.reshape(-1)
    size = rows * cols * NBINS
    cnt = torch.bincount(flat, minlength=size)
    d = (src.to(torch.int64) - rec.to(torch.int64)).expand(5, H, W)
    s = torch.zeros(size, dtype=torch.int64, device=rec.device) \
        .index_add_(0, flat, d.reshape(-1))
    out = []
    for a in (s, cnt):
        a = a.reshape(rows, cols, NBINS).permute(2, 0, 1)
        out.append((a[:20].reshape(4, 5, rows, cols), a[20:]))
    (eo_s, bo_s), (eo_c, bo_c) = out
    return (eo_s, eo_c), (bo_s, bo_c)


def best_offsets(s, c, sign=None, max_abs: int = 7):
    """The offset of each (sum s, count c) that minimises the distortion
    change c*h^2 - 2*h*s among 0..rint(s/c) (clipped to +-max_abs; sign
    "pos" / "neg": the EO category's sign rule). Returns (h int32,
    delta_d float64 <= 0). The values are integers, exact in float64 as
    in the host form; the program's float32 numbers equal them while they
    stay below 2^24 (|2 h s| < 2^24: at 8 bits always, above only while
    a category's summed error stays below 2^24 / 62, some 270,000)."""
    s, c = s.double(), c.double()
    h0 = torch.round(s / c.clamp(min=1.0)).clamp(-max_abs, max_abs)
    if sign == "pos":
        h0 = h0.clamp(min=0.0)
    elif sign == "neg":
        h0 = h0.clamp(max=0.0)
    sgn = torch.sign(h0)
    cands = torch.arange(max_abs + 1, dtype=torch.float64, device=s.device)
    d = c[..., None] * cands * cands - 2.0 * cands * (s * sgn)[..., None]
    d = torch.where(cands <= h0.abs()[..., None], d, 0.0)
    k = torch.argmin(d, dim=-1)                 # the first minimum
    best_d = torch.gather(d, -1, k[..., None])[..., 0]
    return (k * sgn).to(torch.int32), best_d


def _eo_best(eo_s, eo_c, max_abs: int):
    """Per class and category: (h, d) [4, 4, rows, cols] with the sign
    rule (categories 1, 2 non-negative; 3, 4 non-positive)."""
    s, c = eo_s[:, 1:5], eo_c[:, 1:5]
    h_pos, d_pos = best_offsets(s, c, "pos", max_abs)
    h_neg, d_neg = best_offsets(s, c, "neg", max_abs)
    sel = (torch.arange(4, device=s.device) < 2)[None, :, None, None]
    return torch.where(sel, h_pos, h_neg), torch.where(sel, d_pos, d_neg)


def _take(a, idx):
    """a [K, ...] at index idx [...] along the first axis."""
    return torch.gather(a, 0, idx[None])[0]


def _bo_best(bo_s, bo_c, max_abs: int):
    """The best window of 4 consecutive bands: (band, d, offsets [r, c,
    4])."""
    hb, db = best_offsets(bo_s, bo_c, None, max_abs)    # [32, r, c]
    wins = db.unfold(0, 4, 1).sum(-1)                   # [29, r, c]
    wb = torch.argmin(wins, dim=0)
    bi = wb[None] + torch.arange(4, device=wb.device)[:, None, None]
    return wb, _take(wins, wb), torch.gather(hb, 0, bi).permute(1, 2, 0)


def _cost(d, bits, lam: np.float32, form: str):
    """float32 d + lam * bits, rounded as `form` rounds it."""
    if form == "program":
        # one rounding: the float64 sum is exact (d an integer below 2^24,
        # lam * bits a 31-bit integer times a power of two)
        return (d + float(lam) * bits.double()).float()
    return d.float() + bits.float() * float(lam)


def _choose(eo_d, eo_bits, bo_d, bo_bits, lam, form):
    """(use_eo, use_bo): the cheaper of EO and BO where it beats off."""
    eo_cost = _cost(eo_d, eo_bits, lam, form)
    bo_cost = _cost(bo_d, bo_bits, lam, form)
    use_eo = (eo_cost < 0) & (eo_cost <= bo_cost)
    return use_eo, (bo_cost < 0) & ~use_eo


def decide_luma(eo_stats, bo_stats, lam, form: str, bit_depth: int = 8):
    """Per-CTU luma decision at SSD + lam * estimated bits. Returns (type,
    aux, offsets [rows, cols, 4]) int32."""
    ma = max_offset(bit_depth)
    h, d = _eo_best(*eo_stats, ma)
    dtot = d.sum(1)                                     # [4, r, c]
    cls = torch.argmin(dtot, dim=0)
    eo_offs = torch.gather(h, 0, cls[None, None].expand(1, 4, *cls.shape))[0]
    eo_offs = eo_offs.permute(1, 2, 0)                  # [r, c, 4]
    wb, bo_d, bo_offs = _bo_best(*bo_stats, ma)
    eo_bits = 3 + (eo_offs.abs() + 1).sum(-1)
    bo_bits = 6 + (bo_offs.abs() + 1 + (bo_offs != 0).int()).sum(-1)
    use_eo, use_bo = _choose(_take(dtot, cls), eo_bits, bo_d, bo_bits, lam,
                             form)
    t = torch.where(use_eo, SAO_EO, torch.where(use_bo, SAO_BO, SAO_OFF))
    aux = torch.where(use_eo, cls, wb)
    offs = torch.where(use_eo[..., None], eo_offs,
                       torch.where(use_bo[..., None], bo_offs, 0))
    return t.int(), aux.int(), offs.int()


def decide_chroma(stats_cb, stats_cr, lam, form: str, bit_depth: int = 8):
    """Joint chroma decision: Cb and Cr share the type and the EO class;
    offsets and band positions are per component. stats_*: (eo_stats,
    bo_stats). Returns (type, aux_cb, aux_cr, offs_cb, offs_cr)."""
    ma = max_offset(bit_depth)
    hs, ds = zip(*(_eo_best(*st[0], ma) for st in (stats_cb, stats_cr)))
    dtot = ds[0].sum(1) + ds[1].sum(1)
    cls = torch.argmin(dtot, dim=0)
    eo_offs = [torch.gather(h, 0, cls[None, None].expand(1, 4, *cls.shape))
               [0].permute(1, 2, 0) for h in hs]
    bos = [_bo_best(*st[1], ma) for st in (stats_cb, stats_cr)]
    bo_d = bos[0][1] + bos[1][1]
    eo_bits = 3 + sum((o.abs() + 1).sum(-1) for o in eo_offs)
    bo_bits = 11 + sum((o.abs() + 1 + (o != 0).int()).sum(-1)
                       for _, _, o in bos)
    use_eo, use_bo = _choose(_take(dtot, cls), eo_bits, bo_d, bo_bits, lam,
                             form)
    t = torch.where(use_eo, SAO_EO, torch.where(use_bo, SAO_BO, SAO_OFF))
    aux = [torch.where(use_eo, cls, wb).int() for wb, _, _ in bos]
    offs = [torch.where(use_eo[..., None], e,
                        torch.where(use_bo[..., None], b[2], 0)).int()
            for e, b in zip(eo_offs, bos)]
    return t.int(), aux[0], aux[1], offs[0], offs[1]


def offset_table(t, aux, offs) -> torch.Tensor:
    """Per-tile offsets by bin [rows * cols * 52] int32: the EO class's
    categories 1..4, or the four bands from the band position."""
    rows, cols = t.shape
    dev = t.device
    lut = torch.zeros(rows * cols, NBINS, dtype=torch.int32, device=dev)
    tiles = torch.arange(rows * cols, device=dev)[:, None]
    k = torch.arange(4, device=dev)[None]
    t, aux, offs = t.reshape(-1, 1), aux.reshape(-1, 1).long(), \
        offs.reshape(-1, 4)
    eo = t == SAO_EO
    # aux is the EO class on EO tiles and a band position elsewhere
    lut[tiles, 5 * torch.where(eo, aux, 0) + 1 + k] = \
        torch.where(eo, offs, 0)
    lut[tiles, 20 + (aux + k) % 32] = torch.where(t == SAO_BO, offs, 0)
    return lut.reshape(-1)


def apply_sao(rec, keys, t, aux, offs, bit_depth: int = 8) -> torch.Tensor:
    """The SAO-filtered plane: rec plus its tile's offset at each of its
    keys (only the tile's own class or band carries one), clipped to the
    bit depth's range."""
    lut = offset_table(t, aux, offs)
    return (rec + lut[keys].sum(0)).clamp(0, (1 << bit_depth) - 1) \
        .to(torch.int32)


def sao_frame(rec3, src3, n: int, qp: int, form: str, bit_depth: int = 8):
    """SAO over a frame: statistics of the (deblocked) recon against the
    source per n x n CTU (n/2 in chroma), the per-CTU decision at the
    slice QP's lambda, and the application. rec3 / src3: int32 (y, u, v)
    of bit_depth-bit samples. Returns the filtered planes and the
    parameters packed [ncu, 18]."""
    bd = bit_depth
    sizes = (n, n // 2, n // 2)
    keys = [sao_keys(r, k, bd) for r, k in zip(rec3, sizes)]
    st = [sao_stats(r, s, k, kk)
          for r, s, k, kk in zip(rec3, src3, sizes, keys)]
    lam = sao_lambda(qp, form)
    ty, ay, oy = decide_luma(*st[0], lam, form, bd)
    tc, acb, acr, ocb, ocr = decide_chroma(st[1], st[2], lam, form, bd)
    out = tuple(apply_sao(r, kk, tt, a, o, bd) for r, kk, tt, a, o in zip(
        rec3, keys, (ty, tc, tc), (ay, acb, acr), (oy, ocb, ocr)))
    return out, pack_sao_params(ty, ay, oy, tc, acb, acr, ocb, ocr)


def pack_sao_params(t_y, aux_y, off_y, t_c, aux_cb, aux_cr, off_cb,
                    off_cr) -> torch.Tensor:
    """The per-CTU decisions in the native writer's [ncu, 18] int32
    layout: [luma, cb, cr] x [type, aux, o0..o3]."""
    g = lambda a: a.reshape(-1, 1).int()
    g4 = lambda a: a.reshape(-1, 4).int()
    return torch.cat([g(t_y), g(aux_y), g4(off_y), g(t_c), g(aux_cb),
                      g4(off_cb), g(t_c), g(aux_cr), g4(off_cr)], 1)
