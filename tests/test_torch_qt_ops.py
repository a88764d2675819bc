"""Modules of the port's quadtree slice against the JAX package's (CPU,
small shapes): the K9 bit model and its tables, the lambdas, per-block QP
quant, the window gather and subpel refinement, K1's multi-size sweep,
the quadtree helpers (source_v, block_v availability, the median MV), the
native quadtree slice writer (I, P and B) and the B-frame slice headers.
Integer results are compared exactly, streams byte for byte; so are the
float32 lambdas and MVD bits."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from x265_yuuki_asuna_tpu.bitstream import headers as j_hdr
from x265_yuuki_asuna_tpu.bitstream import native as j_native
from x265_yuuki_asuna_tpu.bitstream import tables as j_tables
from x265_yuuki_asuna_tpu.models import qt_common as j_qt
from x265_yuuki_asuna_tpu.ops import bitcost as j_bc
from x265_yuuki_asuna_tpu.ops import interp as j_interp
from x265_yuuki_asuna_tpu.ops import me as j_me
from x265_yuuki_asuna_tpu.ops import quant as j_quant
from x265_yuuki_asuna_tpu_torch.bitstream import headers as t_hdr
from x265_yuuki_asuna_tpu_torch.bitstream import native as t_native
from x265_yuuki_asuna_tpu_torch.bitstream import tables as t_tables
from x265_yuuki_asuna_tpu_torch.models import inter_encoder as t_inter
from x265_yuuki_asuna_tpu_torch.models import qt_common as t_qt
from x265_yuuki_asuna_tpu_torch.ops import bitcost as t_bc
from x265_yuuki_asuna_tpu_torch.ops import interp as t_interp
from x265_yuuki_asuna_tpu_torch.ops import me as t_me
from x265_yuuki_asuna_tpu_torch.ops import quant as t_quant

torch.set_num_threads(2)


def _levels(rng, B, n):
    """Quantized-level-like blocks: mostly zeros and ones, a few large."""
    mag = rng.geometric(0.5, (B, n, n)) - 1
    mag = np.where(rng.random((B, n, n)) < rng.random((B, 1, 1)) * 0.6,
                   mag, 0)
    mag[rng.random(B) < 0.03] *= 20
    lv = (mag * rng.choice([-1, 1], (B, n, n))).astype(np.int32)
    lv[:3] = 0
    return lv


def test_cabac_tables_match_jax():
    assert t_tables.CTX_OFFSET == j_tables.CTX_OFFSET
    assert np.array_equal(t_tables.INIT_ROWS, j_tables._INIT_ROWS)
    assert np.array_equal(t_tables.GROUP_IDX, j_tables.GROUP_IDX)
    assert np.array_equal(t_tables.SIG_CTX_PATTERN, j_tables.SIG_CTX_PATTERN)
    for log2n in (2, 3, 4, 5):
        assert np.array_equal(t_tables.scan_order(0, log2n),
                              j_tables.scan_order(0, log2n))
        assert np.array_equal(t_tables.scan_order_cg(0, log2n - 2),
                              j_tables.scan_order_cg(0, log2n - 2))


@pytest.mark.parametrize("slice_type", [0, 1, 2])
def test_init_states_and_bit_luts_match_jax(slice_type):
    for qp in range(52):
        js = j_bc.init_states_dev(slice_type, jnp.int32(qp), xp=jnp)
        ts = t_bc.init_states_dev(slice_type, qp)
        assert np.array_equal(np.asarray(js), ts)
        for a, b in zip(j_bc.state_bit_luts(js, xp=jnp),
                        t_bc.state_bit_luts(ts)):
            assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
@pytest.mark.parametrize("luma", [True, False])
def test_est_tu_bits_ctx_matches_jax(log2n, luma):
    """The K9 TU estimate on seeded levels (I- and P-slice contexts). Zero
    TUs, the sign and remainder bits and every integer part agree
    exactly; the float32 total agrees to the last place: XLA may sum the
    fractional bin costs in another order inside another fusion (see
    ops/bitcost), and the programs' decisions are held exactly in
    test_torch_qt_programs."""
    rng = np.random.default_rng(log2n * 2 + luma)
    n = 1 << log2n
    lv = _levels(rng, 600 if log2n < 5 else 200, n)
    est = jax.jit(lambda x, st: j_bc.est_tu_bits_ctx(x, log2n, luma, st,
                                                     xp=jnp))
    for slice_type, qp in ((2, 30), (1, 32)):
        js = j_bc.init_states_dev(slice_type, jnp.int32(qp), xp=jnp)
        j = np.asarray(est(jnp.asarray(lv), js))
        t = t_bc.est_tu_bits_ctx(torch.as_tensor(lv), log2n, luma,
                                 t_bc.init_states_dev(slice_type, qp)).numpy()
        assert t.dtype == np.float32
        assert np.array_equal(j == 0, t == 0)
        np.testing.assert_allclose(t, j, rtol=4e-7, atol=0)


def test_mvd_bits_match_jax():
    mv = np.arange(-300, 301, dtype=np.int32)
    bits = jax.jit(lambda m, st: j_bc.mvd_bits(m, st, xp=jnp))
    for slice_type, qp in ((1, 22), (1, 32), (1, 45)):
        js = j_bc.init_states_dev(slice_type, jnp.int32(qp), xp=jnp)
        j = np.asarray(bits(jnp.asarray(mv), js))
        t = t_bc.mvd_bits(torch.as_tensor(mv),
                          t_bc.init_states_dev(slice_type, qp)).numpy()
        assert np.array_equal(j, t)


def test_chain_lookup_matches_jax():
    rng = np.random.default_rng(3)
    vec = rng.random(16).astype(np.float32)
    idx = rng.integers(0, 16, (50, 16)).astype(np.int32)
    j = j_bc.chain_lookup(jnp.asarray(vec), jnp.asarray(idx), 16, xp=jnp)
    t = t_bc.chain_lookup(torch.as_tensor(vec), torch.as_tensor(idx))
    assert np.array_equal(np.asarray(j), t.numpy())


def test_lambdas_match_jax_for_every_qp():
    qp = jnp.arange(52, dtype=jnp.int32)
    f = jax.jit(lambda q: (
        0.9 * jnp.exp2((q.astype(jnp.float32) - 12.0) / 6.0),
        0.85 * jnp.exp2((q.astype(jnp.float32) - 12.0) / 3.0)))
    jl, jl2 = (np.asarray(a) for a in f(qp))
    assert np.array_equal(jl, np.array([t_qt.lam(q) for q in range(52)]))
    assert np.array_equal(jl2, np.array([t_qt.lam2(q) for q in range(52)]))
    assert t_qt.lam(30).dtype == np.float32


@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
def test_quant_dequant_per_block_qp_match_jax(log2n):
    rng = np.random.default_rng(log2n)
    n = 1 << log2n
    coef = rng.integers(-6000, 6000, (40, n, n)).astype(np.int32)
    qp = rng.integers(0, 52, 40).astype(np.int32)
    for intra_slice in (True, False):
        jl, _ = j_quant.quant(jnp.asarray(coef), jnp.asarray(qp), log2n, 8,
                              intra_slice, xp=jnp)
        tl = t_quant.quant(torch.as_tensor(coef), torch.as_tensor(qp), log2n,
                           8, intra_slice)
        assert np.array_equal(np.asarray(jl), tl.numpy())
    jd = j_quant.dequant(jl, jnp.asarray(qp), log2n, 8, xp=jnp)
    td = t_quant.dequant(tl, torch.as_tensor(qp), log2n)
    assert np.array_equal(np.asarray(jd), td.numpy())


@pytest.mark.parametrize("n", [8, 16, 32])
def test_window_gather_and_subpel_refine_match_jax(n):
    rng = np.random.default_rng(n)
    H, W = 96, 128
    ref = rng.integers(0, 256, (H, W)).astype(np.int32)
    nb = (H // n) * (W // n)
    px = (np.arange(nb) % (W // n) * n).astype(np.int32)
    py = (np.arange(nb) // (W // n) * n).astype(np.int32)
    mx = rng.integers(-20, 20, nb).astype(np.int32)
    my = rng.integers(-20, 20, nb).astype(np.int32)
    src = np.clip(ref.reshape(H // n, n, W // n, n).transpose(0, 2, 1, 3)
                  .reshape(-1, n, n) + rng.integers(-9, 9, (nb, n, n)),
                  0, 255).astype(np.int32)
    jw = j_interp.gather_luma_window(jnp.asarray(ref), jnp.asarray(px),
                                     jnp.asarray(py), jnp.asarray(mx),
                                     jnp.asarray(my), n, xp=jnp)
    tw = t_interp.gather_luma_window(*(torch.as_tensor(a) for a in (
        ref, px, py, mx, my)), n)
    assert np.array_equal(np.asarray(jw), tw.numpy())
    j = j_interp.subpel_refine_win(jw, jnp.asarray(src), n, xp=jnp)
    t = t_interp.subpel_refine_win(tw, torch.as_tensor(src), n)
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert (t[0] != 0).any() and (t[1] != 0).any()


@pytest.mark.parametrize("H,W", [(64, 64), (96, 128)])
def test_k1_multi_size_sweep_matches_jax(H, W):
    """K1's multi-size route (the surface, then each size's first-minimum
    argmin, lambda_bits 2) on uint8 planes, as the P quadtree runs it, and
    on int32 planes, against the JAX sweep on int32 planes of the same
    values (the JAX quadtree program casts its planes to int32)."""
    rng = np.random.default_rng(H + W)
    base = (np.add.outer(np.arange(H), np.arange(W)) * 3 % 256)
    ref = np.clip(base + rng.integers(0, 40, (H, W)), 0, 255)
    src = np.clip(np.roll(ref, (3, -5), (0, 1))
                  + rng.integers(-6, 6, (H, W)), 0, 255)
    j = j_me.sad_sweep_multi(jnp.asarray(ref, jnp.int32),
                             jnp.asarray(src, jnp.int32), (8, 16, 32), 16,
                             lambda_bits=2)
    for dt in (torch.uint8, torch.int32):
        t = t_me.sad_sweep_multi(torch.as_tensor(ref, dtype=dt),
                                 torch.as_tensor(src, dtype=dt),
                                 (8, 16, 32), 16, lambda_bits=2)
        assert sorted(t) == [8, 16, 32]
        for nn in (8, 16, 32):
            for a, b in zip(j[nn], t[nn]):
                assert np.array_equal(np.asarray(a), b.numpy()), (dt, nn)


@pytest.mark.parametrize("nn", [4, 8, 16, 32])
def test_source_v_matches_jax(nn):
    rng = np.random.default_rng(nn)
    plane = rng.integers(0, 256, (64, 96)).astype(np.int32)
    j = j_qt.source_v(jnp.asarray(plane), nn)
    t = t_qt.source_v(torch.as_tensor(plane), nn)
    assert np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("ctu", [32, 16])
def test_block_v_availability_matches_jax(ctu):
    """Every quadtree position of every CTU of a 3x4 grid (luma CTU 32,
    chroma 16): the port's plane-index form of block_v gives the
    reference's availability, and the reference's samples where they are
    available."""
    rows, cols = 3, 4
    H, W = rows * ctu, cols * ctu
    plane = np.random.default_rng(ctu).integers(0, 256, (H, W)) \
        .astype(np.int32)
    r, c = np.divmod(np.arange(rows * cols), cols)
    tile = plane.reshape(rows, ctu, cols, ctu).transpose(0, 2, 1, 3) \
        .reshape(-1, ctu, ctu)
    pad = np.zeros((1, ctu, ctu), np.int32)
    tiles = np.concatenate([tile, pad])
    nb = lambda rr, cc, ok: np.where(ok, rr * cols + cc, rows * cols)
    al, at = c > 0, r > 0
    atr, atl = (r > 0) & (c < cols - 1), (r > 0) & (c > 0)
    lrc = tiles[nb(r, c - 1, al)][:, :, ctu - 1]
    tbr = tiles[nb(r - 1, c, at)][:, ctu - 1, :]
    trbr = tiles[nb(r - 1, c + 1, atr)][:, ctu - 1, :]
    tlbr = tiles[nb(r - 1, c - 1, atl)][:, ctu - 1, :]
    n_checked = 0
    for y0, x0, nn in t_qt.ZPOS:
        y0, x0, nn = y0 // (32 // ctu), x0 // (32 // ctu), nn // (32 // ctu)
        jv, ja = j_qt.block_v(
            jnp.asarray(tile), jnp.asarray(lrc), jnp.asarray(tbr),
            jnp.asarray(trbr), jnp.asarray(tlbr), jnp.asarray(al),
            jnp.asarray(at), jnp.asarray(atr), jnp.asarray(atl), y0, x0, nn)
        idx, av = t_qt.block_v(r, c, y0, x0, nn, ctu, cols, W)
        assert np.array_equal(np.asarray(ja), av), (y0, x0, nn)
        assert np.array_equal(np.where(av, np.asarray(jv), 0),
                              np.where(av, plane.reshape(-1)[idx], 0))
        n_checked += int(av.sum())
    assert n_checked > 0


def test_median_mv_matches_jax_median():
    """jnp.median of an even count is the mean of the middle pair, which
    int32 truncates toward zero; torch.median would take the lower one."""
    mv = np.array([-9, -3, -1, 2, 5, 12], np.int32)     # pair (-1, 2)
    j = np.asarray(jnp.median(jnp.asarray(mv)).astype(jnp.int32))
    t = t_inter.median_mv(torch.as_tensor(mv))
    assert int(t) == int(j) == 0 and int(torch.median(torch.as_tensor(mv))) \
        == -1
    rng = np.random.default_rng(0)
    for k in (4, 16, 64, 17):
        mv = rng.integers(-40, 40, k).astype(np.int32)
        assert int(t_inter.median_mv(torch.as_tensor(mv))) == int(
            np.asarray(jnp.median(jnp.asarray(mv)).astype(jnp.int32)))


def _random_tree(rng, rows, cols, slice_type):
    """A synthetic decided tree (splits, modes, MVs, sparse levels)."""
    ncu = rows * cols
    lv = lambda *s: (rng.integers(-3, 4, s) * (rng.random(s) < 0.1)) \
        .astype(np.int32)
    out = {"split": rng.random((rows, cols)) < 0.6,
           "split16": rng.random((rows, cols, 4)) < 0.4,
           "modes": rng.integers(0, 35, (rows, cols)),
           "modes4": rng.integers(0, 35, (rows, cols, 4)),
           "modes8": rng.integers(0, 35, (rows, cols, 4, 4)),
           "levels_y": lv(rows, cols, 32, 32),
           "levels_cb": lv(rows, cols, 16, 16),
           "levels_cr": lv(rows, cols, 16, 16)}
    # MVs from a small set, so merge candidates often match (and often
    # do not)
    mv = lambda *s: rng.choice([-8, -4, 0, 4, 8, 5], s).astype(np.int32)
    if slice_type in (0, 1):
        out.update({"use_intra": rng.random((rows, cols)) < 0.2,
                    "use_intra4": rng.random((rows, cols, 4)) < 0.2,
                    "use_intra8": np.zeros((rows, cols, 4, 4), bool),
                    "mvx": mv(rows, cols), "mvy": mv(rows, cols),
                    "mv4x": mv(rows, cols, 4), "mv4y": mv(rows, cols, 4),
                    "mv8x": mv(rows, cols, 4, 4),
                    "mv8y": mv(rows, cols, 4, 4)})
    if slice_type == 0:
        pd = lambda *s: rng.integers(1, 4, s).astype(np.int32)
        out.update({"use_intra8": rng.random((rows, cols, 4, 4)) < 0.1,
                    "pdir": pd(rows, cols), "pdir4": pd(rows, cols, 4),
                    "pdir8": pd(rows, cols, 4, 4),
                    "mv1x": mv(rows, cols), "mv1y": mv(rows, cols),
                    "mv41x": mv(rows, cols, 4), "mv41y": mv(rows, cols, 4),
                    "mv81x": mv(rows, cols, 4, 4),
                    "mv81y": mv(rows, cols, 4, 4)})
    assert ncu
    return out


@pytest.mark.parametrize("slice_type", [2, 1])
def test_native_qt2_writer_matches_jax(slice_type):
    rng = np.random.default_rng(slice_type)
    out = _random_tree(rng, 3, 4, slice_type)
    j = j_native.encode_slice_qt2(slice_type, 2, out, 30, 3)
    t = t_native.encode_slice_qt2(slice_type, 2, out, 30, 3)
    assert j is not None and t == j


# (poc, L0 poc, L1 poc): distances 1, 2 and 3 on either side, so AMVP
# scales the other list's neighbour MVs (scaleMvB) by every ratio
B_POCS = [(1, 0, 2), (2, 0, 4), (1, 0, 4), (3, 0, 4), (2, 1, 4), (3, 1, 4)]


@pytest.mark.parametrize("pocs", B_POCS)
def test_native_qt2_b_writer_matches_jax(pocs):
    """B slices: every pdir at 32, 16 and 8, intra CUs among them, merge
    hits and misses, AMVP across the two lists' POC distances."""
    poc, poc0, poc1 = pocs
    rng = np.random.default_rng(poc * 10 + poc0)
    out = _random_tree(rng, 3, 4, 0)
    kw = dict(poc=poc, poc_l0=poc0, poc_l1=poc1)
    j = j_native.encode_slice_qt2(0, 2, out, 31, 3, **kw)
    t = t_native.encode_slice_qt2(0, 2, out, 31, 3, **kw)
    assert j is not None and t == j
    assert all(set(np.unique(out[k])) == {1, 2, 3}
               for k in ("pdir4", "pdir8"))


def test_native_qt2_writer_refuses_b_slices():
    """A B slice without its B fields (a P decision dict) is refused."""
    out = _random_tree(np.random.default_rng(0), 2, 2, 1)
    with pytest.raises(ValueError, match="pdir"):
        t_native.encode_slice_qt2(0, 2, out, 30, 3)


def test_native_qt2_writer_checks_shapes():
    out = _random_tree(np.random.default_rng(0), 2, 2, 1)
    out["levels_cb"] = out["levels_cb"][:, :, :8, :8]
    with pytest.raises(ValueError, match="levels_cb"):
        t_native.encode_slice_qt2(1, 2, out, 30, 3)


# (slice_type, nal_type, poc, ref_poc_delta, pos_poc_delta, rps): the
# pyramid's referenced middle B, its leaves (the first keeps the later
# anchor in its RPS, unused), a flat B, and a P anchor 4 pictures on
SLICE_HEADERS = [
    (0, 1, 2, 2, 2, None),
    (0, 0, 1, 1, 1, ([(1, 1)], [(1, 1), (3, 0)])),
    (0, 0, 3, 1, 1, ([(1, 1)], [(1, 1)])),
    (0, 0, 1, 1, 1, None),
    (0, 0, 5, 2, 3, None),
    (1, 1, 4, 4, 0, None),
]


@pytest.mark.parametrize("case", SLICE_HEADERS)
def test_b_and_anchor_slice_headers_match_jax(case):
    slice_type, nal_type, poc, d0, d1, rps = case
    kw = dict(nal_type=nal_type, poc=poc, ref_poc_delta=d0,
              pos_poc_delta=d1, rps=rps, max_merge=3)
    j = j_hdr.write_slice_header(
        j_hdr.SPSInfo(), j_hdr.PPSInfo(init_qp=26, deblocking_disabled=1),
        slice_type, 33, **kw)
    t = t_hdr.write_slice_header(
        t_hdr.SPSInfo(), t_hdr.PPSInfo(init_qp=26, deblocking_disabled=1),
        slice_type, 33, **kw)
    assert t.get_bytes() == j.get_bytes()
