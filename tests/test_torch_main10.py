"""Main10 and Main12: the port's 10- and 12-bit path against the JAX
package (CPU, exact).

- Ops at bit depths 10 and 12 on seeded inputs above 255: the headers'
  profile and the hash SEI over 16-bit samples; intra reference
  substitution and prediction; the transforms; quant, dequant, sign
  hiding and RDOQ (static and context) at QpBdOffset; the deblock
  (uniform, inter with a QP map, the quadtree's host form); SAO
  statistics, decisions and application; motion compensation, bi
  averaging, weighted prediction and the weighted search plane;
  AQ's offsets; PSNR / SSIM at the bit depth's peak; the weight analysis
  and the histogram scene cut with their 8-bit faults; K1's plain
  version on int16 planes (held to a pinned digest of the Pallas kernel
  in interpret mode) and its key layout.
- Streams: the golden `intra_main10`, the sessions and command lines of
  tests/main10_pins.py held to the JAX package's pinned md5s with each
  frame's POC, type and QP (the CLI's NAL types and CSV log too), and no
  uint8 tensor anywhere on the 10-bit path.
- `-m slow` recomputes every pin from the JAX package (the sessions,
  the CLI and the Pallas digest); `-m gpu` runs the sessions and K1's
  int16 entry points on the card."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import golden_corpus
import grid_pins
import main10_pins as M
from test_torch_qt_ops import digest
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.models import ratecontrol as j_rc
from x265_yuuki_asuna_tpu.ops import bitcost as j_bc
from x265_yuuki_asuna_tpu.ops import deblock as j_db
from x265_yuuki_asuna_tpu.ops import intra as j_intra
from x265_yuuki_asuna_tpu.ops import interp as j_interp
from x265_yuuki_asuna_tpu.ops import quant as j_quant
from x265_yuuki_asuna_tpu.ops import sao as j_sao
from x265_yuuki_asuna_tpu.ops import transforms as j_tr
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import lookahead as t_la
from x265_yuuki_asuna_tpu_torch.models import ratecontrol as t_rc
from x265_yuuki_asuna_tpu_torch.ops import deblock as t_db
from x265_yuuki_asuna_tpu_torch.ops import filters as t_fl
from x265_yuuki_asuna_tpu_torch.ops import intra as t_intra
from x265_yuuki_asuna_tpu_torch.ops import interp as t_interp
from x265_yuuki_asuna_tpu_torch.ops import quant as t_quant
from x265_yuuki_asuna_tpu_torch.ops import sao as t_sao
from x265_yuuki_asuna_tpu_torch.ops import transforms as t_tr
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)
BDS = [10, 12]
t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
h = lambda a: a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _eq(j, p):
    assert np.array_equal(h(j), h(p))


def _peak(bd):
    return (1 << bd) - 1


# ---------------------------------------------------------------------------
# headers and the hash SEI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bd", [8] + BDS)
def test_headers_signal_the_profile(bd):
    """Main (1), Main10 (2), Main12 (4, the RExt constraint flags) and
    the SPS bit depths: the JAX session's parameter sets byte for byte."""
    kw = dict(qp=30, cu_size=16, bit_depth=bd, hash_sei=False)
    assert t_top.IntraEncoderSession(64, 48, device="cpu", **kw).headers() \
        == j_top.IntraEncoderSession(64, 48, **kw).headers()


@pytest.mark.parametrize("bd", [8] + BDS)
def test_hash_sei_hashes_the_deep_samples(bd):
    rng = np.random.default_rng(bd)
    out = {k: rng.integers(0, _peak(bd) + 1, s).astype(np.int32)
           for k, s in (("recon_y", (48, 64)), ("recon_u", (24, 32)),
                        ("recon_v", (24, 32)))}
    ref = types.SimpleNamespace(hash_type=0, bit_depth=bd)
    assert t_top.hash_sei(out, bd) == \
        j_top.IntraEncoderSession._hash_sei(ref, out)


# ---------------------------------------------------------------------------
# intra, transforms, quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_intra_prediction_matches_jax(bd, n):
    rng = np.random.default_rng(100 * bd + n)
    v = rng.integers(0, _peak(bd) + 1, (24, 4 * n + 1)).astype(np.int32)
    avail = rng.random((24, 4 * n + 1)) < 0.7
    avail[:3] = False                      # nothing available: the fill
    vs = j_intra.substitute_references(v, avail, bd)
    _eq(vs, t_intra.substitute_references(t(v), t(avail), bd))
    modes = rng.integers(0, 35, 24).astype(np.int32)
    for luma in (True, False):
        _eq(j_intra.predict_all_modes_matmul(vs, n, bd, luma=luma),
            t_intra.predict_all_modes_matmul(t(vs), n, bd, luma=luma))
        _eq(j_intra.predict_mode_matmul(vs, modes, n, bd, luma=luma),
            t_intra.predict_mode_matmul(t(vs), t(modes), n, bd, luma=luma))


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_transforms_match_jax(bd, n):
    rng = np.random.default_rng(200 * bd + n)
    res = rng.integers(-_peak(bd), _peak(bd) + 1, (6, n, n)).astype(np.int32)
    c = j_tr.forward_transform(res, bd)
    _eq(c, t_tr.forward_transform(t(res), bd))
    _eq(j_tr.inverse_transform(c, bd), t_tr.inverse_transform(t(c), bd))


def _coefs(bd, log2n, seed):
    """Forward-transformed residuals of deep samples: a block of noise, a
    smooth one and a nearly flat one per kind."""
    rng = np.random.default_rng(seed)
    n = 1 << log2n
    k = 1 << (bd - 8)
    res = np.concatenate([
        rng.integers(-40 * k, 40 * k, (4, n, n)),
        np.cumsum(rng.integers(-3 * k, 4 * k, (4, n, n)), -1),
        rng.integers(-2 * k, 3 * k, (4, n, n))]).astype(np.int32)
    return np.asarray(j_tr.forward_transform(res, bd), np.int32)


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
def test_quant_dequant_and_sign_hiding_at_qp_bd_offset(bd, log2n):
    """The Quantizer takes the signalled QP and quantizes at QP + 6 (bd -
    8), as the reference's programs do; sign hiding on top."""
    c = _coefs(bd, log2n, 300 * bd + log2n)
    off = 6 * (bd - 8)
    for qp in (22, 32, 41):
        for intra in (True, False):
            lv, du = j_quant.quant(c, qp + off, log2n, bd, intra)
            _eq(lv, t_quant.Quantizer(bit_depth=bd)(t(c), qp, log2n, intra))
            q = t_quant.Quantizer(sbh=True, bit_depth=bd)
            _eq(j_quant.sign_bit_hiding(lv, du, log2n),
                q(t(c), qp, log2n, intra))
        _eq(j_quant.dequant(lv, qp + off, log2n, bd),
            t_quant.Quantizer(bit_depth=bd).dequant(t(lv), qp, log2n))


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("log2n", [3, 5])
def test_rdoq_matches_jax_at_qp_bd_offset(bd, log2n):
    """Static and context RDOQ, per-block QPs around 30, with psy-RDOQ on
    luma: the reference's lambdas at QP + 6 (bd - 8), past 51 at 12
    bits."""
    c = _coefs(bd, log2n, 400 * bd + log2n)
    q = (30 + np.arange(c.shape[0]) % 5 - 2).astype(np.int32)
    off = 6 * (bd - 8)
    j = jax.jit(lambda a, b: j_quant.quant_rdoq(
        a, b, log2n, bd, psy_scale=1.0, xp=jnp))(c, q + off)
    _eq(j, t_quant.Quantizer(rdoq=True, psy_rdoq=1.0, bit_depth=bd)(
        t(c), t(q), log2n, True))
    states = j_bc.init_states_dev(2, 30)
    j = jax.jit(lambda a, b: j_quant.quant_rdoq_ctx(
        a, b, log2n, bd, jnp.asarray(states), True, psy_scale=1.0,
        xp=jnp))(c, q + off)
    _eq(j, t_quant.Quantizer(rdoq=True, psy_rdoq=1.0, bit_depth=bd)(
        t(c), t(q), log2n, True, states=states))


# ---------------------------------------------------------------------------
# deblock and SAO
# ---------------------------------------------------------------------------

def _blocky(rng, H, W, bd):
    """Steps between 8x8 blocks of every height, over a gradient: edges
    that take the strong, the normal and no filter, near both ends of the
    range."""
    k = 1 << (bd - 8)
    base = (np.add.outer(np.arange(H), np.arange(W)) // 3 + 70) * k
    amp = rng.choice([0, 2, 5, 12, 30], (H // 8 + 1, W // 8 + 1)) * k
    step = rng.integers(-1, 2, amp.shape) * amp
    off = np.repeat(np.repeat(step, 8, 0), 8, 1)[:H, :W]
    noise = rng.integers(0, 3 * k, (H, W))
    p = base + off + noise
    p[: H // 4] += _peak(bd) - p.max() + 2        # clipped at the top
    return np.clip(p, 0, _peak(bd)).astype(np.int32)


def _frame(rng, H, W, bd):
    return tuple(_blocky(rng, hh, ww, bd)
                 for hh, ww in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))


@pytest.mark.parametrize("bd", BDS)
def test_deblock_matches_jax(bd):
    rng = np.random.default_rng(bd)
    rec = _frame(rng, 64, 96, bd)
    for qp in (30, 45):
        j = j_db.deblock_frame_uniform(*rec, 16, qp, 33, bd)
        for a, b in zip(j, t_db.deblock_frame_uniform(
                *(t(p) for p in rec), 16, qp, 33, bd)):
            _eq(a, b)
    qmap = rng.integers(28, 46, (4, 6))
    bs_v = rng.integers(0, 3, (4, 5)).astype(np.int32)
    bs_h = rng.integers(0, 3, (3, 6)).astype(np.int32)
    j = j_db.deblock_frame_inter(*rec, 16, qmap, 33, bs_v, bs_h, bd)
    p = t_db.deblock_frame_inter(*(t(x) for x in rec), 16, qmap, 33,
                                 t(bs_v), t(bs_h), bd)
    for a, b in zip(j, p):
        _eq(a, b)
    # the quadtree's deblock on the 8-grid (the reference's host form)
    bs_v = rng.integers(0, 3, (8, 11)).astype(np.int32)
    bs_h = rng.integers(0, 3, (7, 12)).astype(np.int32)
    cell_q = np.repeat(np.repeat(rng.integers(30, 40, (2, 3)), 4, 0), 4, 1)
    j = j_db.deblock_frame_qt2(*rec, cell_q[::4, ::4], 0, bs_v, bs_h, bd,
                               cells=4)
    p = t_fl.deblock_qt2(tuple(t(x) for x in rec), t(cell_q), t(bs_v),
                         t(bs_h), bd)
    for a, b in zip(j, p):
        _eq(a, b)


def _stats_dict(eo, bo):
    (es, ec), (bs, bc) = eo, bo
    return {"eo": np.stack([h(es), h(ec)], -1),
            "bo": np.stack([h(bs), h(bc)], -1)}


@pytest.mark.parametrize("bd", BDS)
def test_sao_matches_jax(bd):
    """Band classes at bd - 5 bits, offsets up to 31: the host form's
    statistics, luma and chroma decisions and the application, then the
    whole frame in both forms against the host and program forms."""
    rng = np.random.default_rng(50 + bd)
    rec = _frame(rng, 64, 96, bd)
    k = 1 << (bd - 8)
    src = tuple(np.clip(p + rng.integers(-6 * k, 7 * k, p.shape) + 9 * k,
                        0, _peak(bd)).astype(np.int32) for p in rec)
    st = [t_sao.sao_stats(t(r), t(s), n, bit_depth=bd)
          for r, s, n in zip(rec, src, (32, 16, 16))]
    for (r, s, n), got in zip(zip(rec, src, (32, 16, 16)), st):
        want = j_sao.sao_stats(r.astype(np.uint16), s.astype(np.uint16), n,
                               bd)
        _eq(want["eo"], _stats_dict(*got)["eo"])
        _eq(want["bo"], _stats_dict(*got)["bo"])
    for qp in (22, 37):
        lam = j_sao.sao_lambda(qp)
        jy = j_sao.decide_sao_luma_all(_stats_dict(*st[0]), bd, lam)
        py = t_sao.decide_luma(*st[0], t_sao.sao_lambda(qp, "host"), "host",
                               bd)
        jc = j_sao.decide_sao_chroma_all(_stats_dict(*st[1]),
                                         _stats_dict(*st[2]), bd, lam)
        pc = t_sao.decide_chroma(st[1], st[2], t_sao.sao_lambda(qp, "host"),
                                 "host", bd)
        for a, b in zip(jy + jc, py + pc):
            _eq(a, b)
        assert np.abs(h(py[2])).max() > 7 or np.abs(h(pc[3])).max() > 7
        args = ((jy[0], jy[1], jy[2]), (jc[0], jc[1], jc[3]),
                (jc[0], jc[2], jc[4]))
        for r, n, a in zip(rec, (32, 16, 16), args):
            _eq(j_sao.apply_sao_component_vec(r, *a, n, bd),
                t_sao.apply_sao(t(r), t_sao.sao_keys(t(r), n, bd),
                                *(t(x) for x in a), bd))


# ---------------------------------------------------------------------------
# inter prediction, AQ, quality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bd", BDS)
def test_motion_compensation_and_weights_match_jax(bd):
    rng = np.random.default_rng(60 + bd)
    ref = rng.integers(0, _peak(bd) + 1, (64, 96)).astype(np.int32)
    refc = rng.integers(0, _peak(bd) + 1, (32, 48)).astype(np.int32)
    n, B = 8, 20
    px = (rng.integers(0, 11, B) * 8).astype(np.int32)
    py = (rng.integers(0, 7, B) * 8).astype(np.int32)
    mx = rng.integers(-40, 41, B).astype(np.int32)
    my = rng.integers(-40, 41, B).astype(np.int32)
    a = (t(ref), t(px), t(py), t(mx), t(my), n, bd)
    _eq(j_interp.mc_luma_qpel(ref, px, py, mx, my, n, bd),
        t_interp.mc_luma_qpel(*a))
    _eq(j_interp.mc_chroma_qpel(refc, px // 2, py // 2, mx, my, n // 2, bd),
        t_interp.mc_chroma_qpel(t(refc), t(px // 2), t(py // 2), t(mx),
                                t(my), n // 2, bd))
    p0 = j_interp.mc_luma_qpel_ps(ref, px, py, mx, my, n, bd)
    p1 = j_interp.mc_luma_qpel_ps(ref, px, py, my, mx, n, bd)
    _eq(p0, t_interp.mc_luma_qpel_ps(*a))
    _eq(j_interp.add_avg(p0, p1, bd),
        t_interp.add_avg(t(p0), t(p1), bd))
    for w, o in ((64, 0), (50, -20), (90, 127), (20, -128)):
        _eq(j_interp.weight_uni(p0, w, o, 6, bd),
            t_interp.weight_uni(t(p0), w, o, 6, bd))
        # the weighted search plane: clipped at the peak, the offset
        # unscaled (the reference's inter_encoder expression)
        want = np.clip(((ref * w + 32) >> 6) + o, 0, _peak(bd))
        got = t_interp.weight_plane(t(ref), w, o, bd)
        assert got.dtype == torch.int16
        _eq(want, got)


@pytest.mark.parametrize("bd", BDS)
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_aq_offsets_match_jax(bd, mode):
    rng = np.random.default_rng(70 + mode)
    y = _blocky(rng, 64, 96, bd)
    u, v = (_blocky(rng, 32, 48, bd) for _ in range(2))
    for kw in ({}, {"u_plane": u, "v_plane": v}):
        _eq(j_rc.compute_aq_offsets(y, 16, 1.0, mode=mode, bit_depth=bd,
                                    **kw),
            t_rc.compute_aq_offsets(y, 16, 1.0, mode=mode, bit_depth=bd,
                                    **kw))


@pytest.mark.parametrize("bd", BDS)
def test_quality_at_the_bit_depths_peak(bd):
    rng = np.random.default_rng(80 + bd)
    src = _frame(rng, 48, 64, bd)
    rec = tuple(np.clip(p + rng.integers(-9, 10, p.shape), 0, _peak(bd))
                .astype(np.uint16) for p in src)
    assert t_top.frame_quality(rec, *src, "cpu", bd) == \
        j_top.frame_quality(rec, *src, bd)


def test_distortions_of_full_range_12bit_noise_match_jax():
    """SATD, sa8d and the psycho-visual energy of 32x32 blocks of
    full-range 12-bit noise against flat and inverted blocks: the largest
    sums the programs form, equal to the reference's int32 ones (neither
    wraps)."""
    from x265_yuuki_asuna_tpu.ops import pixel as j_px
    from x265_yuuki_asuna_tpu_torch.ops import pixel as t_px
    rng = np.random.default_rng(12)
    a = rng.integers(0, 4096, (6, 32, 32)).astype(np.int32)
    for b in (np.zeros_like(a), 4095 - a, np.full_like(a, 4095)):
        _eq(j_px.satd(a, b), t_px.satd(t(a), t(b)))
        _eq(j_px.sa8d(a, b), t_px.sa8d(t(a), t(b)))
    _eq(j_px.psy_energy(a), t_px.psy_energy(t(a)))


def test_weight_analysis_keeps_the_8bit_clip():
    """_decide_weights clips the weighted reference at 255 whatever the
    bit depth, as the reference does (ROADMAP Queue 3)."""
    f = M.fade10(M.deep(golden_corpus.clip(n=3)), 60)
    ref = types.SimpleNamespace(weightp=True)
    for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
        want = j_top.VideoEncoderSession._decide_weights(ref, *b, a)
        assert t_top.VideoEncoderSession._decide_weights(*b, a) == want


def test_histogram_cut_drops_deep_samples():
    """Bins of low >> 2 stop at 64: a 10-bit lowres plane whose samples
    all lie above 255 has an empty histogram (the reference's fault)."""
    la = t_la.Lookahead(64, 48, "cpu", hist_scenecut=True, bit_depth=10)
    rng = np.random.default_rng(9)
    for lo in (0, 300, 100):
        low = rng.integers(lo, lo + 200, (24, 32)).astype(np.int32)
        hist = np.bincount(low.reshape(-1) >> 2, minlength=64)[:64] \
            .astype(np.float64)
        want = la._prev_hist is not None and float(np.abs(
            hist / max(hist.sum(), 1.0) - la._prev_hist).sum()) > 0.35
        assert la._hist_cut(t(low)) == want
    assert la._prev_hist.sum() > 0


# ---------------------------------------------------------------------------
# K1 on int16 planes
# ---------------------------------------------------------------------------

def _k1_planes(bd, H=32, W=64):
    rng = np.random.default_rng(bd)
    src = rng.integers(0, _peak(bd) + 1, (H, W)).astype(np.int16)
    ref = np.roll(src, (2, -3), (0, 1))
    ref[H // 4:H // 2, W // 4:W // 2] = rng.integers(0, _peak(bd) + 1,
                                                     (H // 4, W // 4))
    return ref, src


K1_SIZES = (8, 16)
K1_R = 6
# digest() of the Pallas kernel's (interpret mode) (mvx, mvy, sad) per size
# of sad_sweep_multi_pallas on _k1_planes, lambda_bits 2, then of its
# fused n=16 sweep alone, per bit depth
K1_DIGEST = {
    10: "440cc68cacce6f335f329fe68b6715edf13c13078000cebe16515a244325cb2f",
    12: "a0eea8d9f090f88be7dc160bdb84fb86792543ff315b5a5a56ae37701de6f082"}


def _k1_port(bd):
    ref, src = (torch.from_numpy(p) for p in _k1_planes(bd))
    surf = me_sad.sad_block8_sweep(ref, src, K1_R)
    multi = [a for n in K1_SIZES
             for a in me_sad.best_of_surface(surf, n, K1_R, 2)]
    best = me_sad.sad_sweep_best(ref, src, K1_R, 16, 2, _peak(bd))
    return digest(multi + list(best))


@pytest.mark.parametrize("bd", BDS)
def test_k1_plain_on_int16_matches_pallas(bd):
    assert _k1_port(bd) == K1_DIGEST[bd]


@pytest.mark.slow
@pytest.mark.parametrize("bd", BDS)
def test_k1_digest_from_pallas_interpret(bd):
    from x265_yuuki_asuna_tpu.ops.pallas.me_sad import sad_sweep_multi_pallas
    ref, src = (jnp.asarray(p) for p in _k1_planes(bd))
    p = sad_sweep_multi_pallas(ref, src, K1_SIZES, K1_R, lambda_bits=2,
                               interpret=True)
    b = sad_sweep_multi_pallas(ref, src, (16,), K1_R, lambda_bits=2,
                               interpret=True)
    want = digest([a for n in K1_SIZES for a in p[n]] + list(b[16]))
    assert want == _k1_port(bd) == K1_DIGEST[bd]


def test_k1_plain_versions_take_the_wrappers_arguments():
    """The card's plain reruns patch each K1 entry point with its plain
    version, so both take the same arguments (the fused sweep's peak
    too)."""
    import inspect
    for name in ("sad_block8_sweep", "sad_block4_sweep", "sad_sweep_best"):
        assert list(inspect.signature(getattr(me_sad, name)).parameters) \
            == list(inspect.signature(getattr(me_sad, name + "_plain"))
                    .parameters)


def test_k1_keys_from_the_samples_peak():
    """Sized from the samples' peak the fused keys stay 32 bits at n = 16,
    R = 16 (10 bits: 18 + 11, 12 bits: 20 + 11); the int16 type's own
    range would take 64; R = 24 at 12 bits takes 64 (20 + 12)."""
    lay = me_sad.key_layout
    assert lay(torch.int16, 16, 16, 2)[1] == torch.int64
    for bd in BDS:
        assert lay(torch.int16, 16, 16, 2, _peak(bd)) == (11, torch.int32)
        assert lay(torch.int16, 8, 16, 1, _peak(bd)) == (11, torch.int32)
    assert lay(torch.int16, 16, 24, 2, _peak(10)) == (12, torch.int32)
    assert lay(torch.int16, 16, 24, 2, _peak(12)) == (12, torch.int64)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def test_golden_intra_main10():
    assert M.golden_md5(t_top, device="cpu") == \
        grid_pins.manifest("intra_main10")


class _DtypeWatch(torch.overrides.TorchFunctionMode):
    """Records the dtype of every tensor a torch call returns."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, _types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.seen.add(o.dtype)
        return out


@pytest.mark.parametrize("name", sorted(set(M.SESSIONS) - {"uni_b",
                                                            "flagship"}))
def test_session_pin(name):
    md5, frames, _ = M.run(t_top, name, device="cpu")
    assert (md5, frames) == M.PINS[name]


@pytest.mark.parametrize("name", ["uni_b", "flagship"])
def test_session_pin_with_no_uint8_tensor(name):
    """The uniform B session and the flagship's tools at 10 bits (the
    lookahead and b-adapt's sweeps, HME, the quadtree's P and B programs,
    the filters): their pins, and no torch call returns a uint8 tensor,
    where a cast would wrap the deep samples."""
    with _DtypeWatch() as watch:
        md5, frames, _ = M.run(t_top, name, device="cpu")
    assert (md5, frames) == M.PINS[name]
    assert torch.int16 in watch.seen and torch.uint8 not in watch.seen


@pytest.mark.parametrize("name", sorted(M.CLI))
def test_cli_pin(name, tmp_path):
    assert M.run_cli(t_cli.main, name, str(tmp_path), device="cpu") == \
        M.CLI_PINS[name]


def _cli_recon_and_decode(tmp_path, extra):
    """The 10-bit all-intra command line over 2 frames with --recon: (the
    recon file's frames, the decoder's frames), luma and Cb."""
    from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
    src, dst = str(tmp_path / "in.y4m"), str(tmp_path / "out.hevc")
    M.write_clip10(src, 2)
    assert t_cli.main([src, "-o", dst, "--recon", str(tmp_path / "r.yuv")]
                      + M.CLI["intra"] + extra, device="cpu") == 0
    rec = np.fromfile(tmp_path / "r.yuv", np.uint16)
    with open(dst, "rb") as f:
        dec = decode_hevc(f.read(), 96, 64, bit_depth=10)
    fs = 96 * 64 * 3 // 2
    assert len(dec) == 2 and rec.size == 2 * fs
    split = lambda r: (r[:96 * 64].reshape(64, 96),
                       r[96 * 64:96 * 64 + 48 * 32].reshape(32, 48))
    return ([split(rec[i * fs:(i + 1) * fs]) for i in range(2)],
            [tuple(p.astype(np.uint16) for p in d[:2]) for d in dec])


def test_cli_recon_is_the_decoded_10bit_picture(tmp_path):
    """--recon writes each frame's 10-bit recon as little-endian 16-bit
    samples (the reference's raw YUV): with one frame per batch, the
    picture a decoder makes of the stream. In batches of 4 (the CLI's
    default) under AQ the slices lack the cu_qp_delta syntax the PPS
    announces, as the reference's do (ROADMAP Queue 3): a decoder then
    makes another picture."""
    rec, dec = _cli_recon_and_decode(tmp_path, ["--frame-batch", "1"])
    for r, d in zip(rec, dec):
        _eq(r[0], d[0])
        _eq(r[1], d[1])
    rec, dec = _cli_recon_and_decode(tmp_path, [])
    assert not np.array_equal(rec[0][0], dec[0][0])


def test_uniform_video_deblock_keeps_the_8bit_fault():
    """The reference's video session deblocks its uniform grid at 8-bit
    thresholds and range (ROADMAP Queue 3), and so does the port: a
    decoder, deblocking at 10 bits, reproduces the IDR of the golden clip
    but not the P frames after it; without the deblock it reproduces
    every frame."""
    from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
    got = {}
    for deblock in (True, False):
        s = t_top.VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                                      bit_depth=10, deblock=deblock,
                                      sao=True, device="cpu")
        assert s.intra_sess.deblock_bit_depth == 8
        out, recs = s.headers(), []
        for f in M.deep(golden_corpus.clip(n=3)):
            r = s.encode_frame(*f)
            out += r.nals
            recs.append(r.recon[0])
        got[deblock] = [np.array_equal(d[0].astype(np.uint16), r) for d, r
                        in zip(decode_hevc(out, 64, 48, bit_depth=10), recs)]
    assert got == {True: [True, False, False], False: [True, True, True]}


def test_bit_depth_is_a_session_keyword():
    with pytest.raises(ValueError):
        t_top.IntraEncoderSession(64, 48, bit_depth=9, device="cpu")
    s = t_top.VideoEncoderSession(64, 48, bit_depth=12, max_depth=2,
                                  device="cpu")
    assert s.sps.bit_depth == 12 and s.sps.ptl.profile_idc == 4


# ---------------------------------------------------------------------------
# slow twins: the pins from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(M.SESSIONS))
def test_session_pin_from_jax(name):
    md5, frames, _ = M.run(j_top, name)
    assert (md5, frames) == M.PINS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(M.CLI))
def test_cli_pin_from_jax(name, tmp_path):
    from x265_yuuki_asuna_tpu import cli as j_cli
    assert M.run_cli(j_cli.main, name, str(tmp_path)) == M.CLI_PINS[name]


@pytest.mark.slow
def test_golden_intra_main10_from_jax():
    assert M.golden_md5(j_top) == grid_pins.manifest("intra_main10")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


@pytest.mark.gpu
def test_golden_and_pins_on_the_card(tmp_path):
    _need_card()
    assert M.golden_md5(t_top) == grid_pins.manifest("intra_main10")
    for name in M.SESSIONS:
        assert M.run(t_top, name)[:2] == M.PINS[name], name
    for name in M.CLI:
        assert M.run_cli(t_cli.main, name, str(tmp_path)) == \
            M.CLI_PINS[name], name


@pytest.mark.gpu
@pytest.mark.parametrize("bd", BDS)
def test_k1_int16_kernels_match_plain_on_the_card(bd):
    _need_card()
    rng = np.random.default_rng(bd)
    src = rng.integers(0, _peak(bd) + 1, (544, 960)).astype(np.int16)
    ref = np.roll(src, (3, -5), (0, 1))
    r, s = torch.from_numpy(ref).cuda(), torch.from_numpy(src).cuda()
    for sweep, plain in ((me_sad.sad_block8_sweep,
                          me_sad.sad_block8_sweep_plain),
                         (me_sad.sad_block4_sweep,
                          me_sad.sad_block4_sweep_plain)):
        assert torch.equal(sweep(r, s, 16).cpu(), plain(r.cpu(), s.cpu(), 16))
    for n, lam in ((8, 1), (16, 2)):
        got = me_sad.sad_sweep_best(r, s, 16, n, lam, _peak(bd))
        want = me_sad.sad_sweep_best_plain(r.cpu(), s.cpu(), 16, n, lam)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
