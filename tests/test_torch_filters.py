"""The port's in-loop filters against the JAX package's (CPU), exactly:
the deblocking edge filters and uniform-grid frames (ops/deblock.py,
called with xp=np), the quadtree chain's BS, effective QP and deblock
(ops/filters_dev.py), SAO statistics, decisions (natural and crafted
near-tie statistics), application and lambda against both JAX forms (the
host form of ops/sao.py and the in-program form of ops/filters_dev.py),
and qt_loopfilter_dev as one compiled program per frame kind at 128x96."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from golden_corpus import clip
from x265_yuuki_asuna_tpu.ops import deblock as j_db
from x265_yuuki_asuna_tpu.ops import filters_dev as j_fd
from x265_yuuki_asuna_tpu.ops import sao as j_sao
from x265_yuuki_asuna_tpu_torch.ops import deblock as t_db
from x265_yuuki_asuna_tpu_torch.ops import filters as t_fl
from x265_yuuki_asuna_tpu_torch.ops import sao as t_sao

torch.set_num_threads(2)
QPS = [20, 26, 29, 33, 37, 41, 45]

t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
h = lambda a: a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _blocky(rng, H, W, blk=8):
    """A smooth gradient with per-block steps of random height and a
    little noise: edges that take the strong, the normal and no filter."""
    base = np.add.outer(np.arange(H), np.arange(W)) // 3 + 70
    amp = rng.choice([0, 2, 5, 12, 30], (H // blk + 1, W // blk + 1))
    step = rng.integers(-1, 2, amp.shape) * amp
    off = np.repeat(np.repeat(step, blk, 0), blk, 1)[:H, :W]
    noise = rng.integers(0, 3, (H, W)) * (rng.random((H, W)) < 0.5)
    return np.clip(base + off + noise, 0, 255).astype(np.int32)


def _planes(rng, H, W, blk=8):
    return (_blocky(rng, H, W, blk), _blocky(rng, H // 2, W // 2, blk),
            _blocky(rng, H // 2, W // 2, blk))


def _eq(j, p):
    assert np.array_equal(h(j), h(p))


# ---------------------------------------------------------------------------
# deblocking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qp", QPS)
def test_luma_edge_filter_matches_jax(qp):
    """Scalar thresholds, and per-segment beta and tc (BS 0 / 1 / 2)."""
    rng = np.random.default_rng(qp)
    y = _blocky(rng, 64, 96)
    cols = list(range(8, 96, 8))
    beta, tc = j_db.luma_thresholds(qp)
    assert (beta, tc) == t_db.luma_thresholds(qp)
    _eq(j_db._filter_vertical_edges(y, cols, beta, tc, 255, np),
        t_db.filter_vertical_edges(t(y), cols, beta, tc))
    bs = rng.integers(0, 3, (16, len(cols)))
    qe = rng.integers(qp - 3, qp + 4, bs.shape)
    tc_seg = j_db._tc_seg_from_bs(bs, qe, 0, 0)
    _eq(tc_seg, t_db.tc_seg_from_bs(t(bs), t(qe)))
    beta_seg = j_db.BETA_TABLE[np.clip(qe, 0, 51)].astype(np.int32)
    out = j_db._filter_vertical_edges(y, cols, beta_seg, tc_seg, 255, np)
    assert not np.array_equal(out, y)
    _eq(out, t_db.filter_vertical_edges(t(y), cols, t(beta_seg),
                                        t(tc_seg)))


@pytest.mark.parametrize("qp", QPS)
def test_chroma_edge_filter_matches_jax(qp):
    rng = np.random.default_rng(100 + qp)
    u = _blocky(rng, 32, 48)
    cols = list(range(8, 48, 8))
    tc = t_db.luma_thresholds(qp)[1]
    _eq(j_db._filter_vertical_edges_chroma(u, cols, tc, 255, np),
        t_db.filter_vertical_edges_chroma(t(u), cols, tc))
    tc_rows = rng.integers(0, 6, (32, len(cols))).astype(np.int32)
    mask = rng.random((32, len(cols))) < 0.6
    _eq(j_db._filter_vertical_edges_chroma(u, cols, tc_rows, 255, np, mask),
        t_db.filter_vertical_edges_chroma(t(u), cols, t(tc_rows), t(mask)))


@pytest.mark.parametrize("qp", QPS)
def test_uniform_intra_deblock_matches_jax(qp):
    rng = np.random.default_rng(200 + qp)
    y, u, v = _planes(rng, 48, 64, 16)
    qpc = min(qp, 45)
    j = j_db.deblock_frame_uniform(y, u, v, 16, qp, qpc)
    p = t_db.deblock_frame_uniform(t(y), t(u), t(v), 16, qp, qpc)
    for a, b in zip(j, p):
        _eq(a, b)


@pytest.mark.parametrize("qp", QPS)
def test_uniform_inter_bs_and_deblock_match_jax(qp):
    """P frames: BS 0, 1 and 2 from intra, coded luma and MV differences
    (pdir None, one list)."""
    rng = np.random.default_rng(300 + qp)
    rows, cols = 6, 8
    y, u, v = _planes(rng, 16 * rows, 16 * cols, 16)
    intra = rng.random((rows, cols)) < 0.2
    cbf = rng.random((rows, cols)) < 0.3
    mv = lambda: rng.choice([0, 0, 0, 3, 4, -8], (rows, cols))
    mvx, mvy = mv().astype(np.int32), mv().astype(np.int32)
    jv, jh = j_db.compute_bs_uniform(intra, cbf, None, mvx, mvy)
    tv, th = t_db.compute_bs_uniform(t(intra), t(cbf), None, t(mvx), t(mvy))
    _eq(jv, tv)
    _eq(jh, th)
    assert set(np.unique(jv)) == {0, 1, 2}
    qpc = min(qp, 45)
    j = j_db.deblock_frame_inter(y, u, v, 16, qp, qpc, jv, jh)
    p = t_db.deblock_frame_inter(t(y), t(u), t(v), 16, qp, qpc, tv, th)
    for a, b in zip(j, p):
        _eq(a, b)


def test_uniform_deblock_refuses_a_qp_map():
    """A per-CU QP map is taken now (AQ / cuTree; tests/test_torch_aq_ops.py
    holds it against the JAX package): a map at one QP filters as that QP
    does."""
    rng = np.random.default_rng(12)
    y = torch.as_tensor(rng.integers(0, 256, (32, 32)), dtype=torch.int32)
    u = torch.as_tensor(rng.integers(0, 256, (16, 16)), dtype=torch.int32)
    a = t_db.deblock_frame_uniform(y, u, u, 16, np.full((2, 2), 38), 35)
    b = t_db.deblock_frame_uniform(y, u, u, 16, 38, 35)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def _cell_maps(rng, gr, gc):
    """Random 8x8-cell attributes: CU ids over 2x2 groups and single
    cells, intra cells, coded cells, MVs near the BS threshold, pdir."""
    cid = (np.arange(gr)[:, None] // 2 * gc + np.arange(gc)[None] // 2)
    cid = np.where(rng.random((gr, gc)) < 0.3,
                   1000 + np.arange(gr * gc).reshape(gr, gc), cid)
    mv = lambda: rng.choice([-8, -4, -3, 0, 3, 4, 8], (gr, gc)) \
        .astype(np.int32)
    return {"is_intra": rng.random((gr, gc)) < 0.15,
            "cbf": rng.random((gr, gc)) < 0.3, "mvx": mv(), "mvy": mv(),
            "mv1x": mv(), "mv1y": mv(),
            "pdir": rng.integers(0, 4, (gr, gc)).astype(np.int32),
            "cu_id": cid.astype(np.int32)}


def test_compute_bs_and_effective_qp_match_jax():
    rng = np.random.default_rng(7)
    maps = _cell_maps(rng, 12, 16)
    jv, jh = jax.jit(j_fd.compute_bs_dev)(
        {k: jnp.asarray(a) for k, a in maps.items()})
    tv, th = t_db.compute_bs({k: t(a) for k, a in maps.items()})
    _eq(jv, tv)
    _eq(jh, th)
    assert set(np.unique(h(tv))) == {0, 1, 2}
    qp_cu = rng.integers(22, 40, 12).astype(np.int32)
    for cbf in (rng.random(12) < 0.5, np.zeros(12, bool), np.ones(12, bool)):
        j = jax.jit(j_fd.effective_qp_dev)(jnp.asarray(qp_cu),
                                           jnp.asarray(cbf), jnp.int32(31))
        _eq(j, t_fl.effective_qp(t(qp_cu), t(cbf), 31))


@pytest.mark.parametrize("qp", [22, 30, 38, 45])
def test_deblock_qt2_matches_jax(qp):
    """Luma on the 8-grid, chroma on the 16-grid at BS 2, per-cell QPs
    around the frame's."""
    rng = np.random.default_rng(400 + qp)
    gr, gc = 12, 16
    rec = _planes(rng, 8 * gr, 8 * gc)
    bs_v = rng.integers(0, 3, (gr, gc - 1)).astype(np.int32)
    bs_h = rng.integers(0, 3, (gr - 1, gc)).astype(np.int32)
    cell_q = np.repeat(np.repeat(rng.integers(qp - 4, qp + 5, (3, 4)), 4,
                                 0), 4, 1).astype(np.int32)
    j = jax.jit(j_fd.deblock_qt2_dev)(
        tuple(jnp.asarray(p) for p in rec), jnp.asarray(cell_q),
        jnp.asarray(bs_v), jnp.asarray(bs_h))
    p = t_fl.deblock_qt2(tuple(t(x) for x in rec), t(cell_q), t(bs_v),
                         t(bs_h))
    for a, b in zip(j, p):
        _eq(a, b)
    # the host form of the same filter
    hy, hu, hv = j_db.deblock_frame_qt2(*rec, cell_q[::4, ::4], 0, bs_v,
                                        bs_h, cells=4)
    for a, b in zip((hy, hu, hv), p):
        _eq(a, b)


# ---------------------------------------------------------------------------
# SAO
# ---------------------------------------------------------------------------

_LAM_PROGRAM = jax.jit(
    # the in-program lambda (filters_dev.qt_loopfilter_dev) of a run-time
    # slice QP
    lambda q: (0.85 * jnp.exp2((q.astype(jnp.float32) - 12.0) / 3.0))
    .astype(jnp.float32))


def test_sao_lambda_matches_both_forms_at_every_qp():
    diff = 0
    for qp in range(52):
        host, prog = t_sao.sao_lambda(qp, "host"), \
            t_sao.sao_lambda(qp, "program")
        assert host == j_sao.sao_lambda(qp) and host.dtype == np.float32
        assert prog == np.asarray(_LAM_PROGRAM(jnp.int32(qp)))
        diff += host != prog
    assert diff == 24          # the two forms differ in the last place


def test_sao_cost_rounding_matches_both_forms():
    """d + lam * bits: the host form rounds twice, the program's compiler
    contracts it into one fused multiply-add."""
    rng = np.random.default_rng(5)
    d = -rng.integers(0, 4_000_000, 20000).astype(np.float64)
    bits = rng.integers(7, 84, 20000)
    lam = t_sao.sao_lambda(43, "program")
    prog = np.asarray(jax.jit(lambda a, b: a + lam * b)(
        d.astype(np.float32), bits.astype(np.float32)))
    host = d.astype(np.float32) + lam * bits.astype(np.float32)
    tp = h(t_sao._cost(t(d), t(bits), lam, "program"))
    th = h(t_sao._cost(t(d), t(bits), lam, "host"))
    assert np.array_equal(tp, prog) and np.array_equal(th, host)
    assert (tp != th).any()


def _frame_pair(rng, H, W):
    """A deblocked-looking recon and a source near it."""
    rec = _planes(rng, H, W)
    src = tuple(np.clip(p + rng.integers(-6, 7, p.shape), 0, 255)
                .astype(np.int32) for p in rec)
    return rec, src


def _stats_dict(eo, bo):
    (es, ec), (bs, bc) = eo, bo
    return {"eo": np.stack([h(es), h(ec)], -1),
            "bo": np.stack([h(bs), h(bc)], -1)}


@pytest.mark.parametrize("n", [32, 16])
def test_sao_stats_match_both_forms(n):
    rng = np.random.default_rng(n)
    (y, _, _), (sy, _, _) = _frame_pair(rng, 96, 128)
    eo, bo = t_sao.sao_stats(t(y), t(sy), n)
    host = j_sao.sao_stats(y.astype(np.uint8), sy.astype(np.uint8), n)
    got = _stats_dict(eo, bo)
    _eq(host["eo"], got["eo"])
    _eq(host["bo"], got["bo"])
    es, ec = jax.jit(j_fd._sao_stats_dev, static_argnums=2)(
        jnp.asarray(y), jnp.asarray(sy), n)
    bs, bc = jax.jit(j_fd._sao_bo_stats_dev, static_argnums=(2, 3))(
        jnp.asarray(y), jnp.asarray(sy), n, 8)
    for a, b in ((es, eo[0]), (ec, eo[1]), (bs, bo[0]), (bc, bo[1])):
        _eq(np.asarray(a).astype(np.int64), b)


def _crafted_luma_stats():
    """Per-tile crafted statistics [4, 5, 1, T] / [32, 1, T] (sums, counts)
    of decisions on a knife edge, at QP 30 (lambda 54.4 in both forms):
      0: EO d = -1089 at 20 bits, BO d = -817 at 15 bits: equal costs
         when lam * bits is rounded (the host form keeps EO), EO dearer
         when it is not (the program's fused form takes BO);
      1: EO cost exactly 0 after rounding (not below 0: off);
      2: two EO classes with equal distortion (the first wins);
      3: s/c = 2.5 and 3.5 (rint to even; then a tie between offsets 3
         and 4, the first wins);
      4: the best band windows tie at both ends of the band range;
      5: EO and BO with equal distortion and bits (EO wins the tie)."""
    T = 6
    es, ec = np.zeros((4, 5, 1, T)), np.zeros((4, 5, 1, T))
    bs, bc = np.zeros((32, 1, T)), np.zeros((32, 1, T))

    def eo(tile, cls, cat, s, c):
        es[cls, cat, 0, tile], ec[cls, cat, 0, tile] = s, c

    def bo(tile, band, s, c):
        bs[band, 0, tile], bc[band, 0, tile] = s, c

    eo(0, 0, 1, 63, 9), eo(0, 0, 2, 108, 18)
    bo(0, 10, 400, 200), bo(0, 11, 17, 17)
    eo(1, 0, 1, 140, 20), eo(1, 0, 2, 18, 3)
    eo(2, 0, 3, -400, 100), eo(2, 2, 3, -400, 100)
    eo(3, 1, 1, 500, 200), eo(3, 1, 2, 700, 200)
    bo(4, 0, 300, 100), bo(4, 31, 300, 100)
    eo(5, 3, 1, 200, 40), bo(5, 20, 1000, 1000)
    return ((es, ec), (bs, bc))


def _decide_jax(form, eo, bo, qp, chroma=None):
    """The JAX decision of stats ((eo_s, eo_c), (bo_s, bo_c)) numpy, in
    the host form (sao.py) or the program form (filters_dev.py, jitted)."""
    if form == "host":
        lam = j_sao.sao_lambda(qp)
        st = _stats_dict(eo, bo)
        if chroma is None:
            return j_sao.decide_sao_luma_all(st, 8, lam)
        return j_sao.decide_sao_chroma_all(st, _stats_dict(*chroma), 8, lam)
    lam = _LAM_PROGRAM(jnp.int32(qp))
    f32 = lambda st: tuple(jnp.asarray(h(a), jnp.float32)
                           for pair in st for a in pair)
    if chroma is None:
        return jax.jit(j_fd._decide_luma_dev, static_argnums=4)(
            *f32((eo, bo)), 8, lam)
    return jax.jit(j_fd._decide_chroma_dev, static_argnums=2)(
        f32((eo, bo)), f32(chroma), 8, lam)


def _decide_port(form, eo, bo, qp, chroma=None):
    tt = lambda st: tuple(tuple(t(np.asarray(h(a), np.int64)) for a in p)
                          for p in st)
    lam = t_sao.sao_lambda(qp, form)
    if chroma is None:
        return t_sao.decide_luma(*tt((eo, bo)), lam, form)
    return t_sao.decide_chroma(tt((eo, bo)), tt(chroma), lam, form)


@pytest.mark.parametrize("form", t_sao.FORMS)
def test_sao_decide_matches_jax_on_crafted_near_ties(form):
    eo, bo = _crafted_luma_stats()
    j = _decide_jax(form, eo, bo, 30)
    p = _decide_port(form, eo, bo, 30)
    for a, b in zip(j, p):
        _eq(a, b)
    t_, aux, offs = (h(x)[0] for x in p)
    assert list(t_[1:]) == [0, 2, 2, 1, 2]
    assert aux[2] == 0 and list(offs[3]) == [2, 3, 0, 0] and aux[4] == 0
    # tile 0 is where the two forms part: EO kept on the tie, BO taken
    # when the cost is rounded once
    assert t_[0] == (2 if form == "host" else 1)
    # chroma: the crafted tiles as Cb, a mirrored copy as Cr
    cr = ((eo[0][::-1].copy(), eo[1][::-1].copy()), bo)
    j = _decide_jax(form, eo, bo, 30, chroma=cr)
    p = _decide_port(form, eo, bo, 30, chroma=cr)
    for a, b in zip(j, p):
        _eq(a, b)


@pytest.mark.parametrize("form", t_sao.FORMS)
@pytest.mark.parametrize("qp", [22, 30, 37, 44, 51])
def test_sao_decide_and_apply_match_jax_on_a_frame(form, qp):
    """Statistics of a natural frame at CTU32 (luma) / 16 (chroma), the
    decision in each form, and the application."""
    rng = np.random.default_rng(qp)
    rec, src = _frame_pair(rng, 96, 128)
    st = [t_sao.sao_stats(t(r), t(s), k)
          for r, s, k in zip(rec, src, (32, 16, 16))]
    j = _decide_jax(form, *st[0], qp)
    p = _decide_port(form, *st[0], qp)
    for a, b in zip(j, p):
        _eq(a, b)
    jc = _decide_jax(form, *st[1], qp, chroma=st[2])
    pc = _decide_port(form, *st[1], qp, chroma=st[2])
    for a, b in zip(jc, pc):
        _eq(a, b)
    ty, ay, oy = (h(x) for x in p)
    tc, acb, acr, ocb, ocr = (h(x) for x in pc)
    for r, k, args in ((rec[0], 32, (ty, ay, oy)), (rec[1], 16,
                       (tc, acb, ocb)), (rec[2], 16, (tc, acr, ocr))):
        want = j_sao.apply_sao_component_vec(r, *args, k)
        got = t_sao.apply_sao(t(r), t_sao.sao_keys(t(r), k),
                              *(t(a) for a in args))
        _eq(want, got)
        dev = jax.jit(j_fd._apply_sao_dev, static_argnums=(4, 5))(
            jnp.asarray(r), *(jnp.asarray(a) for a in args), k, 8)
        _eq(dev, got)
    if form == "host":
        # the whole frame at once, packed as the writer takes it
        out, packed = t_sao.sao_frame(tuple(t(x) for x in rec),
                                      tuple(t(x) for x in src), 32, qp,
                                      form)
        _eq(packed, j_fd.pack_sao_params(tuple(
            jnp.asarray(a) for a in (ty, ay, oy, tc, acb, acr, ocb, ocr))))


# ---------------------------------------------------------------------------
# the whole quadtree chain, one compiled JAX program per frame kind
# ---------------------------------------------------------------------------

_ROWS, _COLS = 3, 4


def _qt_inputs(kind: str):
    """128x96 inputs of qt_loopfilter_dev for an I, P or B frame (the
    arguments of the JAX I program and of its P / B program)."""
    rng = np.random.default_rng({"I": 1, "P": 2, "B": 3}[kind])
    rows, cols = _ROWS, _COLS
    ncu, n16, n8 = rows * cols, 4 * rows * cols, 16 * rows * cols
    y, u, v = clip(32 * cols, 32 * rows, n=1, seed=9)[0]
    src = tuple(p.astype(np.int32) for p in (y, u, v))
    rec = tuple(np.clip(p + rng.integers(-9, 10, p.shape), 0, 255)
                .astype(np.int32) for p in src)
    lv = lambda *s: (rng.integers(-2, 3, s) * (rng.random(s) < 0.02)) \
        .astype(np.int32)
    lv3 = (lv(ncu, 32, 32), lv(ncu, 16, 16), lv(ncu, 16, 16))
    lv3[0][5] = lv3[1][5] = lv3[2][5] = 0       # a CTU with no residual
    inp = {"rec3": rec, "src3": src,
           "qp_cu": rng.integers(27, 36, ncu).astype(np.int32),
           "split": rng.random(ncu) < 0.6, "split16": rng.random(n16) < 0.4,
           "lv3": lv3, "ui": None, "mv": None, "pdir": None}
    if kind == "I":
        return inp
    mv = lambda k: rng.choice([-8, -4, -3, 0, 3, 4, 9], k).astype(np.int32)
    sizes = (ncu, n16, n8)
    inp["ui"] = tuple(rng.random(k) < (0.2 if kind == "P" else 0)
                      for k in sizes)
    if kind == "P":
        inp["mv"] = tuple((mv(k), mv(k), None, None) for k in sizes)
    else:
        inp["mv"] = tuple((mv(k), mv(k), mv(k), mv(k)) for k in sizes)
        inp["pdir"] = tuple(rng.integers(1, 4, k).astype(np.int32)
                            for k in sizes)
    return inp


@pytest.fixture(scope="module")
def jax_loopfilter():
    """qt_loopfilter_dev compiled once per argument structure (the I
    program's, and the P and B programs' shared one)."""
    def run(rec3, src3, qp_cu, slice_qp, split, split16, ui, mv, pdir, lv3):
        out3, arrs = j_fd.qt_loopfilter_dev(
            rec3, src3, qp_cu, slice_qp, split, split16, ui, mv, pdir, lv3,
            _ROWS, _COLS, True, True, True, 8)
        return out3, j_fd.pack_sao_params(arrs)
    return jax.jit(run)


@pytest.mark.parametrize("kind", ["I", "P", "B"])
def test_qt_loopfilter_matches_jax(jax_loopfilter, kind):
    inp = _qt_inputs(kind)
    qp = 31
    ja = lambda a: None if a is None else jnp.asarray(a)
    jmv = jpd = None
    if inp["mv"] is not None:
        # the JAX P program passes pdir 1 and zero L1 MVs
        jmv = tuple(tuple(ja(a if a is not None else np.zeros_like(s[0]))
                          for a in s) for s in inp["mv"])
        jpd = tuple(ja(a) for a in inp["pdir"]) if inp["pdir"] else \
            tuple(jnp.ones(len(u), jnp.int32) for u in inp["ui"])
    j3, jsao = jax_loopfilter(
        tuple(map(ja, inp["rec3"])), tuple(map(ja, inp["src3"])),
        ja(inp["qp_cu"]), jnp.int32(qp), ja(inp["split"]),
        ja(inp["split16"]),
        None if inp["ui"] is None else tuple(map(ja, inp["ui"])), jmv, jpd,
        tuple(map(ja, inp["lv3"])))
    # the port takes level planes; the JAX program CTU-blocked levels
    rows, cols = _ROWS, _COLS
    planes = [t(a.reshape(rows, cols, k, k).transpose(0, 2, 1, 3)
                .reshape(rows * k, cols * k))
              for a, k in zip(inp["lv3"], (32, 16, 16))]
    tt = lambda a: None if a is None else t(a)
    p3, psao = t_fl.qt_loopfilter(
        tuple(map(t, inp["rec3"])), tuple(map(t, inp["src3"])),
        t(inp["qp_cu"]), qp, t(inp["split"]), t(inp["split16"]),
        None if inp["ui"] is None else tuple(map(t, inp["ui"])),
        None if inp["mv"] is None else tuple(tuple(map(tt, s))
                                             for s in inp["mv"]),
        None if inp["pdir"] is None else tuple(map(t, inp["pdir"])),
        planes, True, True)
    for a, b in zip(j3, p3):
        _eq(a, b)
    _eq(jsao, psao)
    assert (h(psao)[:, 0] != 0).any()           # SAO fires somewhere
    assert not np.array_equal(h(p3[0]), inp["rec3"][0])
