"""B frames on the uniform 16x16 grid in the port against the JAX package
(CPU, exact).

- The goldens bframes3_pyramid, bframes_badapt (b-adapt 2) and open_gop
  (a CRA keyframe) against the manifest.
- The B program's float32 selection terms, exhaustively against XLA:
  lambda = 0.9 * 2^((qp - 12) / 6) at QP 0-51, the MV bits 4 + 2 log2(1 +
  |mvx|) + 2 log2(1 + |mvy|) at every |mv| up to 4 * (64 + 3) quarter-pels
  (any search range up to 64), and the [L0, L1, bi] costs with their
  multiply-add contractions on seeded SATDs and MVs at 12 QPs.
- The B program's decision dict at 128x96 (at one QP and a per-CU map)
  held to digests of the JAX program's pinned here; the slow test
  recomputes them and compares key by key.
- The B writer (encode_b_slice) against the JAX ctypes writer on seeded
  dicts across POC distances, with SAO and a QP map; the B frame's
  deblock (BS from pdir and the masked MVs of both lists) against the
  JAX host functions.
- Uniform B sessions over the golden clip, one with deblock, SAO and AQ
  2, one with open GOP's RASL_N leading pictures, held to the JAX
  sessions' pinned md5s, (POC, type, QP) lists and NAL types.
- Card twins (gpu): the goldens, and one B frame's K1 path against its
  plain path."""
from unittest import mock

import numpy as np
import pytest
import torch

import grid_pins as GP
import jax
import jax.numpy as jnp
import test_torch_qt_programs as QP
from golden_corpus import clip
from test_torch_qt_ops import _random_sao
from x265_yuuki_asuna_tpu.bitstream import native as j_native
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.ops import deblock as j_db
from x265_yuuki_asuna_tpu_torch.bitstream import native as t_native
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import inter_encoder as t_inter
from x265_yuuki_asuna_tpu_torch.models.intra_encoder import \
    chroma_qp_from_luma
from x265_yuuki_asuna_tpu_torch.ops import fp32
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)
W, H = QP.W, QP.H
t = lambda a: torch.as_tensor(np.ascontiguousarray(a))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


UNI_GOLDENS = ("bframes3_pyramid", "bframes_badapt", "open_gop")


@pytest.mark.parametrize("name", UNI_GOLDENS)
def test_uniform_b_golden_matches_the_manifest(name):
    assert GP.golden_md5(t_top, name, device="cpu") == GP.manifest(name)


def test_open_gop_golden_codes_a_cra():
    """open_gop's keyint 4 over 6 frames: frame 4 is a CRA (NAL type 21)
    at POC 4 with no frame pending, so no leading picture."""
    stream, res = GP.push_all(t_top, GP.GOLDENS["open_gop"], clip(),
                              device="cpu")
    assert [(r.poc, r.frame_type) for r in res] == [
        (0, "I"), (3, "P"), (2, "B"), (1, "b"), (4, "I"), (5, "P")]
    assert GP.nal_types(stream) == [32, 33, 34, 39, 19, 1, 1, 0, 21, 1]


# ---------------------------------------------------------------------------
# the selection's float32 terms against XLA
# ---------------------------------------------------------------------------

def test_lambda_matches_xla_at_every_qp():
    """0.9 * exp2((qp - 12) / 6) as XLA computes it (torch's exp2 differs
    at 21 of the 52 QPs)."""
    lam = jax.jit(lambda q: 0.9 * jnp.exp2((q.astype(jnp.float32) - 12.0)
                                           / 6.0))
    want = np.array([np.asarray(lam(jnp.int32(q))) for q in range(52)])
    got = np.array([t_inter.QT.lam(q) for q in range(52)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


K = 4 * (64 + 3)        # |mv| in quarter-pels: search range 64 + 3


def test_mv_bits_match_xla_at_every_mv():
    """4 + 2 log2(1 + |mx|) + 2 log2(1 + |my|) at every (mx, my) with
    |mx|, |my| <= K, bit for bit (torch's log2 differs at about a third
    of them)."""
    bits = jax.jit(lambda mx, my: (
        4.0 + 2.0 * jnp.log2(1.0 + jnp.abs(mx).astype(jnp.float32))
        + 2.0 * jnp.log2(1.0 + jnp.abs(my).astype(jnp.float32))))
    ks = np.arange(-K, K + 1, dtype=np.int32)
    mx, my = (a.reshape(-1) for a in np.meshgrid(ks, ks))
    want = np.asarray(bits(jnp.asarray(mx), jnp.asarray(my)))
    got = fp32.mv_log_bits(t(mx), t(my)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    naive = (4.0 + 2.0 * torch.log2(1.0 + t(mx).abs().float())
             + 2.0 * torch.log2(1.0 + t(my).abs().float())).numpy()
    assert (naive != want).any()


def test_bi_costs_match_xla():
    """The [L0, L1, bi] costs of motion_phase_b's expression compiled by
    XLA (each SATD + lambda * bits contracted into one multiply-add) on
    seeded SATDs and MVs, at 12 QPs: every cost bit for bit."""
    @jax.jit
    def costs(s0, s1, sbi, m0x, m0y, m1x, m1y, qp):
        lam = 0.9 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 6.0)

        def mvbits(mx, my):
            return (4.0 + 2.0 * jnp.log2(1.0 + jnp.abs(mx).astype(
                jnp.float32)) + 2.0 * jnp.log2(1.0 + jnp.abs(my).astype(
                    jnp.float32)))
        b0, b1 = mvbits(m0x, m0y), mvbits(m1x, m1y)
        return jnp.stack([s0 + lam * b0, s1 + lam * (b1 + 1.0),
                          sbi + lam * (b0 + b1 + 2.0)], axis=1)
    rng = np.random.default_rng(11)
    n = 50000
    sats = [rng.integers(0, 30000, n).astype(np.int32) for _ in range(3)]
    mvs = [rng.integers(-K, K + 1, n).astype(np.int32) for _ in range(4)]
    for qp in (0, 4, 12, 18, 22, 27, 30, 32, 35, 37, 44, 51):
        want = np.asarray(costs(*sats, *mvs, jnp.int32(qp)))
        got = t_inter.bi_costs([t(s) for s in sats], (t(mvs[0]), t(mvs[1])),
                               (t(mvs[2]), t(mvs[3])), qp).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), qp


# ---------------------------------------------------------------------------
# the B program's decision dict
# ---------------------------------------------------------------------------

# a per-CU QP map of the 6 x 8 CUs of 128x96 (the program's lambda at its
# largest QP)
QMAP = np.random.default_rng(12).integers(28, 38, (6, 8)).astype(np.int32)
# sha256 (QP.digest) of the JAX package's uniform B dicts of _b_inputs()
# at qp 33 and at QMAP
DIGEST = {"b":
            "1229a00fcfc074c19e6b2c6dc39e345094245bf4567b238fe3d4a592301ca8f6",
          "b_aq":
            "05135653d4a47c679f22797485bd4f88a69ac144c1b95f97c155ff053b9e4103"}


def _b_inputs():
    """QP._frames()' two frames as L0 and L1 and, as the source, their
    mix (QP._b_frame) with a new noise patch: L0, L1, bi and intra CUs."""
    f0, f1 = QP._frames()
    y, u, v = QP._b_frame(f0, f1)
    y = y.copy()
    y[8:40, 8:56] = np.random.default_rng(4).integers(0, 256, (32, 48))
    return (y, u, v), f0, f1


def port_b_dicts():
    src, f0, f1 = _b_inputs()
    enc = t_inter.InterFrameEncoder(W, H, 16, "cpu")
    return {"b": enc.encode_frame(*src, *f0, 33, ref1=f1),
            "b_aq": enc.encode_frame(*src, *f0, QMAP, ref1=f1)}


def jax_b_dicts():
    from x265_yuuki_asuna_tpu.models.inter_encoder import (
        InterFrameConfig, InterFrameEncoder)
    src, f0, f1 = _b_inputs()
    enc = InterFrameEncoder(InterFrameConfig(width=W, height=H, cu_size=16,
                                             qp=33, bi=True))
    run = lambda q: enc.encode_frame(*src, *f0, qp=q, ref1_y=f1[0],
                                     ref1_u=f1[1], ref1_v=f1[2])
    return {"b": run(33), "b_aq": run(QMAP.reshape(-1))}


@pytest.fixture(scope="module")
def port_dicts():
    return port_b_dicts()


@pytest.mark.parametrize("name", sorted(DIGEST))
def test_uniform_b_decisions_match_jax(port_dicts, name):
    d = port_dicts[name]
    assert QP.digest(d) == DIGEST[name]
    assert set(np.unique(d["pdir"])) == {1, 2, 3}
    assert d["use_intra"].any() and not d["use_intra"].all()


@pytest.mark.slow
def test_uniform_b_digests_recomputed_from_the_jax_program(port_dicts):
    jd = jax_b_dicts()
    for name in DIGEST:
        assert QP.digest(jd[name]) == DIGEST[name], name
        for k, v in jd[name].items():
            if v is None:
                assert port_dicts[name][k] is None, k
            else:
                assert np.array_equal(v, port_dicts[name][k]), k


# ---------------------------------------------------------------------------
# the writer and the deblock
# ---------------------------------------------------------------------------

def _random_b(rng, rows=3, cols=4):
    """A seeded uniform B dict: intra CUs, every pdir, MVs from a small
    set (merge hits and misses), sparse levels; the unused list's MVs
    zeroed as the session hands them over."""
    lv = lambda *s: (rng.integers(-3, 4, s) * (rng.random(s) < 0.1)) \
        .astype(np.int32)
    mv = lambda: rng.choice([-8, -4, 0, 4, 8, 5], (rows, cols)) \
        .astype(np.int32)
    pd = rng.integers(1, 4, (rows, cols)).astype(np.int32)
    m0, m1 = (pd & 1) > 0, (pd & 2) > 0
    return dict(use_intra=rng.random((rows, cols)) < 0.2,
                modes=rng.integers(0, 35, (rows, cols)).astype(np.int32),
                pdir=pd, mvx=np.where(m0, mv(), 0), mvy=np.where(m0, mv(), 0),
                mv1x=np.where(m1, mv(), 0), mv1y=np.where(m1, mv(), 0),
                levels_y=lv(rows, cols, 16, 16),
                levels_cb=lv(rows, cols, 8, 8),
                levels_cr=lv(rows, cols, 8, 8))


# (poc, L0 poc, L1 poc)
B_POCS = [(1, 0, 2), (2, 0, 4), (1, 0, 4), (3, 0, 4), (2, 1, 4), (3, 1, 4)]


@pytest.mark.parametrize("pocs", B_POCS)
@pytest.mark.parametrize("extras", ["plain", "sao_qp_map"])
def test_native_b_writer_matches_jax(pocs, extras):
    rng = np.random.default_rng(sum(pocs) * 7 + len(extras))
    d = _random_b(rng)
    kw = {}
    if extras != "plain":
        kw = dict(sao=_random_sao(rng, 3, 4),
                  qp_map=rng.integers(26, 38, (3, 4)).astype(np.int32))
    args = (d["use_intra"], d["modes"], d["pdir"], d["mvx"], d["mvy"],
            d["mv1x"], d["mv1y"], d["levels_y"], d["levels_cb"],
            d["levels_cr"], 4, 32, 3, *pocs)
    j = j_native.encode_b_slice(*args, **kw)
    p = t_native.encode_b_slice(*args, **kw)
    assert j is not None and p == j


def test_native_b_writer_checks_shapes():
    """Arrays of the wrong shape are refused before the native call."""
    d = _random_b(np.random.default_rng(0))
    args = [d["use_intra"], d["modes"], d["pdir"], d["mvx"], d["mvy"],
            d["mv1x"], d["mv1y"], d["levels_y"], d["levels_cb"],
            d["levels_cr"], 4, 32, 3, 1, 0, 2]
    args[8] = args[8][:, :, :4, :4]
    with pytest.raises(ValueError, match="argument 8"):
        t_native.encode_b_slice(*args)


@pytest.mark.parametrize("qmap", [False, True])
def test_b_frame_deblock_matches_jax(qmap):
    """filter_uniform on a B dict (deblock only): BS from use_intra, the
    luma cbf, pdir and both lists' MVs masked by pdir, as the JAX
    session's _deblock_frame computes it, at one QP or a per-CU map."""
    rng = np.random.default_rng(30 + qmap)
    rows, cols = 4, 6
    d = _random_b(rng, rows, cols)
    # the program's unmasked MVs: the masking is the session's
    d["mvx"] = np.where(d["mvx"] == 0, 4, d["mvx"])
    y, u, v = clip(16 * cols, 16 * rows, n=1, seed=2)[0]
    noisy = lambda p: np.clip(p + rng.integers(-6, 7, p.shape), 0, 255)
    d.update(recon_y=noisy(y), recon_u=noisy(u), recon_v=noisy(v))
    qp = 34
    if qmap:
        d["qp_map"] = rng.integers(30, 40, (rows, cols)).astype(np.int32)
    out = dict(d)
    st = {"deblock": 0.0, "sao": 0.0}
    t_top.filter_uniform(out, qp, False, 16, True, False, None,
                         torch.device("cpu"), st)
    qm = j_top.effective_qp_map(d, d.get("qp_map"), qp)
    m0, m1 = (d["pdir"] & 1) > 0, (d["pdir"] & 2) > 0
    bs_v, bs_h = j_db.compute_bs_uniform(
        d["use_intra"], d["levels_y"].any(axis=(2, 3)), d["pdir"],
        np.where(m0, d["mvx"], 0), np.where(m0, d["mvy"], 0),
        np.where(m1, d["mv1x"], 0), np.where(m1, d["mv1y"], 0))
    want = j_db.deblock_frame_inter(d["recon_y"], d["recon_u"],
                                    d["recon_v"], 16,
                                    qp if qm is None else qm,
                                    chroma_qp_from_luma(qp), bs_v, bs_h)
    for k, w in zip(("recon_y", "recon_u", "recon_v"), want):
        assert np.array_equal(out[k], np.asarray(w)), k
    assert not np.array_equal(out["recon_y"], d["recon_y"])


# ---------------------------------------------------------------------------
# a filtered session with AQ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GP.UNI_B_SESSIONS))
def test_uniform_b_session_matches_pinned_jax_stream(name):
    """The stream md5, each result's (POC, type, QP) and the NAL types
    (tests/grid_pins.py)."""
    assert GP.run_uni_b(t_top, name, device="cpu") == GP.UNI_B_PINS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(GP.UNI_B_SESSIONS))
def test_session_pins_recomputed_from_the_jax_session(name):
    assert GP.run_uni_b(j_top, name) == GP.UNI_B_PINS[name]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_uniform_b_goldens_and_pin_on_the_card():
    _need_card()
    for name in UNI_GOLDENS:
        assert GP.golden_md5(t_top, name) == GP.manifest(name), name
    for name in GP.UNI_B_SESSIONS:
        assert GP.run_uni_b(t_top, name) == GP.UNI_B_PINS[name], name


@pytest.mark.gpu
def test_uniform_b_frame_kernel_vs_plain_on_the_card():
    """The last b frame of a 128x96 uniform B session again, K1's fused
    sweep against its plain version: every decision and the recon."""
    _need_card()
    kw = dict(GP.UNI_B_SESSIONS["lf_aq"], hash_sei=False)
    s = t_top.VideoEncoderSession(128, 96, **kw)
    enc = s.inter_encoder
    calls, run = [], enc.encode_frame
    enc.encode_frame = lambda *a, **k: calls.append((a, k)) or run(*a, **k)
    for f in clip(128, 96, n=5):
        s.push_frame(*f)
    a, k = calls[-1]
    assert k.get("ref1") is not None
    out_k = run(*a, **k)
    with mock.patch.object(me_sad, "sad_sweep_best",
                           me_sad.sad_sweep_best_plain):
        out_p = run(*a, **k)
    for key, v in out_k.items():
        if v is None:
            assert out_p[key] is None
        else:
            assert np.array_equal(v, out_p[key]), key
