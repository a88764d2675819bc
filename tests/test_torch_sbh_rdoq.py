"""The port's sign-bit hiding and RDOQ against the JAX package's, op by
op (CPU, exact): quant's delta_u, sign_bit_hiding under each scan,
sign_bit_hiding_mdcs with intra flags, the static quant_rdoq (one QP or a
QP per block, psy-RDOQ on and off), the context quant_rdoq_ctx (every TU
size, luma and chroma, three QPs, psy-RDOQ on and off), K9 with sign
hiding, and the float32 building blocks the RDOQ costs rest on (XLA's
log tables, the contracted multiply-add, the blocked prefix sum). The
reference side is the jitted JAX function: its float32 order is XLA's on
the CPU, which the port reproduces, so the levels must be equal integer
for integer. The coefficients are seeded: blocks of decaying Gaussian
coefficients at amplitudes from 1 to 3000 with a random share of zeros,
so every candidate level, CG drop and last position occurs."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265_yuuki_asuna_tpu.bitstream import tables as j_tables
from x265_yuuki_asuna_tpu.ops import bitcost as j_bc
from x265_yuuki_asuna_tpu.ops import quant as j_quant
from x265_yuuki_asuna_tpu_torch.ops import bitcost as t_bc
from x265_yuuki_asuna_tpu_torch.ops import fp32
from x265_yuuki_asuna_tpu_torch.ops import quant as t_quant

torch.set_num_threads(2)
B = 192


def coefs(seed: int, log2n: int, b: int = B) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = 1 << log2n
    amp = np.exp(rng.uniform(0, np.log(3000), (b, 1, 1)))
    decay = np.exp(-rng.uniform(0, 0.5, (b, 1, 1))
                   * (np.arange(n)[:, None] + np.arange(n)[None, :]))
    c = rng.standard_normal((b, n, n)) * amp * decay
    c = np.where(rng.random((b, n, n)) < rng.uniform(0, 0.7, (b, 1, 1)),
                 0, c)
    return np.clip(np.round(c), -32768, 32767).astype(np.int32)


def block_qps(seed: int, qp: int, b: int = B) -> np.ndarray:
    return np.random.default_rng(seed).integers(qp - 3, qp + 4, b) \
        .astype(np.int32)


T = lambda a: torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("per_block", [False, True])
def test_quant_delta_u_matches_jax(log2n, intra, per_block):
    c = coefs(log2n, log2n)
    qp = block_qps(1, 30) if per_block else 30
    jl, jd = j_quant.quant(c, qp, log2n, 8, intra)
    tl, td = t_quant.quant(T(c), T(qp) if per_block else qp, log2n, 8,
                           intra, return_delta=True)
    assert np.array_equal(tl.numpy(), jl) and np.array_equal(td.numpy(), jd)
    assert np.array_equal(t_quant.quant(T(c), T(qp) if per_block else qp,
                                        log2n, 8, intra).numpy(), jl)


def _levels_du(log2n, seed=3):
    c = coefs(seed, log2n) // (8 if log2n > 2 else 1)
    lv, du = j_quant.quant(c, 32, log2n, 8, True)
    return lv, du


@pytest.mark.parametrize("scan", [j_tables.SCAN_DIAG, j_tables.SCAN_HOR,
                                  j_tables.SCAN_VER])
@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
def test_sign_bit_hiding_matches_jax(scan, log2n):
    lv, du = _levels_du(log2n)
    j = np.asarray(jax.jit(lambda a, b: j_quant.sign_bit_hiding(
        a, b, log2n, xp=jnp, scan_type=scan))(lv, du))
    t = t_quant.sign_bit_hiding(T(lv), T(du), log2n, scan).numpy()
    assert np.array_equal(t, j)
    assert not np.array_equal(j, lv)          # some parity was fixed


@pytest.mark.parametrize("log2n,luma", [(2, True), (3, True), (4, True),
                                        (2, False), (3, False)])
def test_sign_bit_hiding_mdcs_matches_jax(log2n, luma):
    lv, du = _levels_du(log2n, seed=9)
    rng = np.random.default_rng(log2n)
    modes = rng.integers(0, 35, B).astype(np.int32)
    is_intra = rng.random(B) < 0.7
    j = np.asarray(jax.jit(lambda a, b, m, f: j_quant.sign_bit_hiding_mdcs(
        a, b, log2n, m, luma, xp=jnp, is_intra=f))(lv, du, modes, is_intra))
    t = t_quant.sign_bit_hiding_mdcs(T(lv), T(du), log2n, T(modes), luma,
                                     T(is_intra)).numpy()
    assert np.array_equal(t, j)
    # without intra flags every block is intra
    j = np.asarray(jax.jit(lambda a, b, m: j_quant.sign_bit_hiding_mdcs(
        a, b, log2n, m, luma, xp=jnp))(lv, du, modes))
    assert np.array_equal(t_quant.sign_bit_hiding_mdcs(
        T(lv), T(du), log2n, T(modes), luma).numpy(), j)


@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
@pytest.mark.parametrize("per_block", [False, True])
@pytest.mark.parametrize("psy", [0.0, 1.0])
def test_quant_rdoq_matches_jax(log2n, per_block, psy):
    for i, qp in enumerate((22, 32, 37)):
        c = coefs(10 * log2n + i, log2n)
        if per_block:
            q = block_qps(i, qp)
            j = jax.jit(lambda a, b: j_quant.quant_rdoq(
                a, b, log2n, 8, psy_scale=psy, xp=jnp))(c, q)
            t = t_quant.quant_rdoq(T(c), T(q), log2n, psy_scale=psy)
        else:
            j = jax.jit(lambda a: j_quant.quant_rdoq(
                a, qp, log2n, 8, psy_scale=psy, xp=jnp))(c)
            t = t_quant.quant_rdoq(T(c), qp, log2n, psy_scale=psy)
        assert np.array_equal(t.numpy(), np.asarray(j)), qp


@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("qp", [22, 32, 37])
@pytest.mark.parametrize("psy", [0.0, 1.0])
def test_quant_rdoq_ctx_matches_jax(log2n, luma, qp, psy):
    """Per-block QPs around qp (the programs' form) at the I-slice
    contexts of qp; the scalar-QP form on half the cases."""
    states = j_bc.init_states_dev(2, qp)
    st = jnp.asarray(states)
    c = coefs(100 * log2n + qp, log2n)
    q = block_qps(qp, qp)
    j = jax.jit(lambda a, b: j_quant.quant_rdoq_ctx(
        a, b, log2n, 8, st, luma, psy_scale=psy, xp=jnp))(c, q)
    t = t_quant.quant_rdoq_ctx(T(c), T(q), log2n, 8, states, luma,
                               psy_scale=psy)
    assert np.array_equal(t.numpy(), np.asarray(j))
    if psy:
        j = jax.jit(lambda a: j_quant.quant_rdoq_ctx(
            a, qp, log2n, 8, st, luma, psy_scale=psy, xp=jnp))(c)
        t = t_quant.quant_rdoq_ctx(T(c), qp, log2n, 8, states, luma,
                                   psy_scale=psy)
        assert np.array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("log2n", [2, 3, 4, 5])
@pytest.mark.parametrize("luma", [True, False])
def test_k9_sign_hiding_matches_jax(log2n, luma):
    """K9 with sign hiding: the hidden signs are the only difference, an
    integer number of bits per TU, so the sums agree with the reference's
    as the plain estimate does (exact, but for the one 8x8 chroma sum
    whose float32 order is measured in the full programs only)."""
    lv = coefs(7 * log2n, log2n) // np.random.default_rng(1).integers(
        1, 200, (B, 1, 1))
    states = j_bc.init_states_dev(2, 30)
    st = jnp.asarray(states)
    for sh in (False, True):
        j = np.asarray(jax.jit(lambda a: j_bc.est_tu_bits_ctx(
            a, log2n, luma, st, xp=jnp, sign_hiding=sh))(lv))
        t = t_bc.est_tu_bits_ctx(T(lv), log2n, luma, states,
                                 sign_hiding=sh).numpy()
        np.testing.assert_allclose(t, j, rtol=4e-7, atol=0)
        if not (log2n == 3 and not luma):
            assert np.array_equal(t, j)
    hidden = t_bc.est_tu_bits_ctx(T(lv), log2n, luma, states, False) - \
        t_bc.est_tu_bits_ctx(T(lv), log2n, luma, states, True)
    assert (hidden >= 0).all() and (hidden > 0).any()


def test_fp32_tables_match_xla():
    """XLA's log2 of every integer the tables cover, its floor (the floor
    of log2(8192) is 12 there), floor(log2(k / 3)), and the static RDOQ's
    2 * log2(k) + 1, each against the jitted expression."""
    k = np.arange(1, (1 << 16) + 1, dtype=np.float32)
    kt = T(k.astype(np.int64))
    jl = np.asarray(jax.jit(jnp.log2)(k))
    assert np.array_equal(fp32.xla_log2(k), jl)
    assert np.array_equal(fp32.floor_log2_int(kt).numpy(), np.floor(jl))
    assert np.array_equal(fp32.floor_log2_third(kt).numpy(), np.asarray(
        jax.jit(lambda x: jnp.floor(jnp.log2(x / 3.0)))(k)))
    lv = np.arange(0, 32768, dtype=np.int32)
    jb = np.asarray(jax.jit(lambda l: j_quant._level_bits(l, jnp))(lv))
    assert np.array_equal(t_quant._static_level_bits(T(lv)).numpy(), jb)


def test_fma_rounds_once():
    """fp32.fma against exact rational arithmetic: random operands, and
    sums the float64 intermediate puts exactly on a float32 midpoint."""
    rng = np.random.default_rng(4)
    a = (rng.standard_normal(4000) * 1e3).astype(np.float32)
    b = (rng.standard_normal(4000) * 1e-3).astype(np.float32)
    c = rng.standard_normal(4000).astype(np.float32)
    # a * b = 2^-24 + 2^-60: 1 + a * b rounds to the float64 midpoint
    # 1 + 2^-24 of two float32s; the exact sum lies past it, above (and
    # below, negated)
    u, v = 1 + 2.0 ** -12, (1 - 2.0 ** -12 + 2.0 ** -24) * 2.0 ** -24
    a = np.concatenate([a, np.float32([u, -u])])
    b = np.concatenate([b, np.float32([v, v])])
    c = np.concatenate([c, np.float32([1.0, -1.0])])
    got = fp32.fma(T(a), T(b), T(c)).numpy()
    assert got[-2] == np.float32(1 + 2.0 ** -23)    # not 1.0
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert g == best


@pytest.mark.parametrize("length", [16, 64, 256, 1024])
def test_xla_cumsum_matches_jax(length):
    rng = np.random.default_rng(length)
    x = (rng.standard_normal((32, length))
         * rng.uniform(0.1, 1000, (32, length))).astype(np.float32)
    j = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x))
    assert np.array_equal(t_quant.xla_cumsum(T(x)).numpy(), j)


def test_quantizer_routes():
    """The programs' quantizer: sign hiding is off under RDOQ, psy-RDOQ
    only with RDOQ, and the plain form is quant itself."""
    q = t_quant.Quantizer(sbh=True, rdoq=True, psy_rdoq=1.0)
    assert q.rdoq and not q.sbh and q.psy_rdoq == 1.0
    assert t_quant.Quantizer(psy_rdoq=1.0).psy_rdoq == 0.0
    c = T(coefs(5, 3))
    assert torch.equal(t_quant.PLAIN(c, 30, 3, True),
                       t_quant.quant(c, 30, 3, 8, True))
