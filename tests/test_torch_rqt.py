"""RQT (--rqt: the residual TU quadtree of the CTU32 quadtree's inter
CU32 leaves) in the port against the JAX package (CPU, exact).

The split variant (qt_common.tq_quads / rd_leaf_split) against the JAX
package's transform and quantizer in quadrant layout; its float32 choice
(rqt_cost) bit for bit against a standalone XLA compile of the
reference's expression; the P and B programs' decision dicts with
rqt=True against pinned digests of the JAX programs' (tools_pins); the
native writer's transform tree against the JAX package's writer on the
same dicts; the sessions of tests/test_rqt.py and the command line's
--rqt against pinned JAX md5s, decoded by libavcodec; and the reference's
fault under the deblock (its filters do not deblock the inner TU edges
of a split CU32, so the stream decodes to another picture), which the
port keeps. The slow tests recompute every pin from the JAX package."""
import jax
import numpy as np
import pytest
import torch

import tools_pins as TP
from test_torch_qt_programs import _assert_same_dict, _jax_dict
from x265_yuuki_asuna_tpu import cli as j_cli
from x265_yuuki_asuna_tpu.bitstream import native as j_native
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.models.inter_encoder import (InterFrameConfig,
                                                       InterFrameEncoder)
from x265_yuuki_asuna_tpu.ops import quant as j_quant
from x265_yuuki_asuna_tpu.ops import transforms as j_tr
from x265_yuuki_asuna_tpu.utils import io as j_io
from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.bitstream import native as t_native
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import qt_common as QT
from x265_yuuki_asuna_tpu_torch.models.inter_encoder import InterQTEncoder
from x265_yuuki_asuna_tpu_torch.ops.quant import Quantizer
from x265_yuuki_asuna_tpu_torch.utils import io as t_io

torch.set_num_threads(2)
W, H, QP = TP.RQT_W, TP.RQT_H, TP.RQT_QP


def _jax_tq_quads(src, pred, qp, log2nn, sbh):
    """The reference's tq_quads on numpy: the residual in quadrant layout
    as four half-size TUs (inter rounding; sign hiding on the diagonal
    scan), back to the block layout: (levels, recon)."""
    B, nn = src.shape[0], 1 << log2nn
    h2 = nn // 2
    quad = lambda a: a.reshape(B, 2, h2, 2, h2).transpose(0, 1, 3, 2, 4) \
        .reshape(B * 4, h2, h2)
    back = lambda a: a.reshape(B, 2, 2, h2, h2).transpose(0, 1, 3, 2, 4) \
        .reshape(B, nn, nn)
    q = np.repeat(qp, 4)
    coef = j_tr.forward_transform(quad(src - pred), 8)
    lv, du = j_quant.quant(coef, q, log2nn - 1, 8, False)
    if sbh:
        lv = j_quant.sign_bit_hiding(lv, du, log2nn - 1)
    rr = j_tr.inverse_transform(j_quant.dequant(lv, q, log2nn - 1, 8), 8)
    return back(lv), np.clip(pred + back(rr), 0, 255)


@pytest.mark.parametrize("sbh", [False, True], ids=["plain", "sbh"])
@pytest.mark.parametrize("log2nn", [5, 4], ids=["luma32", "chroma16"])
def test_tq_quads_matches_jax(log2nn, sbh):
    """tq_quads' levels and recon at per-block QPs equal the reference's
    on seeded blocks."""
    rng = np.random.default_rng(40 + log2nn)
    nn, B = 1 << log2nn, 24
    src = rng.integers(0, 256, (B, nn, nn)).astype(np.int32)
    pred = np.clip(src + rng.integers(-40, 41, (B, nn, nn)), 0,
                   255).astype(np.int32)
    qp = rng.integers(18, 40, B).astype(np.int32)
    want_lv, want_rec = _jax_tq_quads(src, pred, qp, log2nn, sbh)
    t = torch.as_tensor
    lv, rec, quads = QT.tq_quads(t(src), t(pred), t(qp), log2nn,
                                 Quantizer(sbh=sbh), log2nn == 5, None)
    assert np.array_equal(lv.numpy(), want_lv)
    assert np.array_equal(rec.numpy(), want_rec)
    h2 = nn // 2
    assert np.array_equal(quads.numpy()[:, 1], want_lv[:, :h2, h2:])
    assert want_lv.any()


@jax.jit
def _xla_rqt(q_y, q_cb, q_cr, dist2, dist, bits, lam2):
    """The reference's split choice as XLA compiles it on the CPU: the
    four quadrants' bits of each plane summed, + 12, then the costs of
    both variants (inter_encoder.py's dense_leaf_rd)."""
    bits2 = q_y.sum(-1) + q_cb.sum(-1) + q_cr.sum(-1) + 12.0
    c2 = dist2 + lam2 * (bits2 + 1.0)
    c1 = dist + lam2 * (bits + 1.0)
    return bits2, c2, c1, c2 < c1


def test_rqt_cost_matches_xla():
    """Every bits2 and both costs bit for bit on seeded float32 inputs at
    the QPs' lambdas, and the choice (ties included: some pairs are made
    equal)."""
    rng = np.random.default_rng(23)
    n = 40000
    f = lambda *s, hi: rng.uniform(0, hi, s).astype(np.float32)
    qs = [f(n, 4, hi=900.0) for _ in range(3)]
    dist2, dist = f(n, hi=4e5), f(n, hi=4e5)
    bits = f(n, hi=3000.0)
    dist[:500] = dist2[:500]
    lam2 = QT.lam2(torch.as_tensor(rng.integers(0, 52, n)))
    got_bits2 = ((QT.sum4(torch.as_tensor(qs[0]))
                  + QT.sum4(torch.as_tensor(qs[1])))
                 + QT.sum4(torch.as_tensor(qs[2]))) + 12.0
    want = [np.asarray(a) for a in _xla_rqt(*qs, dist2, dist, bits,
                                             lam2.numpy())]
    t = torch.as_tensor
    got = [got_bits2, QT.rqt_cost(t(dist2), got_bits2, lam2),
           QT.rqt_cost(t(dist), t(bits), lam2)]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32))
    split = QT.tu_split_rd(t(dist2), got_bits2, t(dist), t(bits), lam2)
    assert np.array_equal(split.numpy(), want[3])
    assert 0 < want[3].mean() < 1


@pytest.fixture(scope="module")
def port_dicts():
    return TP.rqt_dicts(InterQTEncoder, Quantizer, "cpu")


@pytest.mark.parametrize("name", sorted(TP.RQT_DIGEST))
def test_rqt_decisions_match_jax(port_dicts, name):
    """The P program at one QP, at a per-CTU QP map and with RDOQ, and
    the B program: every key equal to the JAX program's (pinned digest);
    the P and B dicts split the TU of unsplit inter CU32 leaves."""
    d = port_dicts[name]
    assert TP.digest(d) == TP.RQT_DIGEST[name]
    leaf = d["tu_split32"] & ~d["split"] & ~d["use_intra"]
    assert leaf.any() and not d["tu_split32"].all()


@pytest.mark.parametrize("name,slice_type", [("p", 1), ("b", 0)])
def test_rqt_writer_matches_jax(port_dicts, name, slice_type):
    """The native writer with max_tt 1 (split_transform_flag on every
    inter CU above 4x4, the split CU32s' four TUs) equals the JAX
    package's writer on the same dict, and differs from max_tt 0."""
    d = dict(port_dicts[name])
    d.pop("recon_dev")
    kw = dict(poc=2, poc_l0=0, poc_l1=4) if slice_type == 0 else {}
    want = j_native.encode_slice_qt2(slice_type, 2, d, QP, 3, max_tt=1,
                                     **kw)
    got = t_native.encode_slice_qt2(slice_type, 2, d, QP, 3, max_tt=1, **kw)
    assert got == want
    unsplit = dict(d, tu_split32=np.zeros_like(d["tu_split32"]))
    assert t_native.encode_slice_qt2(slice_type, 2, unsplit, QP, 3,
                                     max_tt=1, **kw) == \
        j_native.encode_slice_qt2(slice_type, 2, unsplit, QP, 3, max_tt=1,
                                  **kw)
    assert got != t_native.encode_slice_qt2(slice_type, 2, d, QP, 3, **kw)


def _decodes_to_recon(stream, res):
    """Whether libavcodec decodes the stream (one GOP) to the results'
    recon, frame by frame in display order."""
    dec = decode_hevc(stream, W, H)
    return len(dec) == len(res) and all(
        np.array_equal(d[p].astype(np.uint8), r.recon[p])
        for d, r in zip(dec, sorted(res, key=lambda r: r.poc))
        for p in range(3))


@pytest.mark.parametrize("name", sorted(TP.RQT_SESSIONS))
def test_rqt_sessions_match_pins(name):
    """tests/test_rqt.py's P and B sessions (and the deblocked P session
    of rqt_inputs) code the JAX package's streams; without the deblock
    they decode to their recon, with it the split CU32s' inner TU edges
    stay unfiltered in the port's recon, as in the reference's, and the
    decoder's picture differs (the reference's fault, kept)."""
    got, sess, res = TP.run_session(t_top, name, device="cpu")
    assert got == TP.RQT_PINS[name]
    assert sess.sps.max_transform_hierarchy_depth_inter == 1
    stream = sess.headers() + b"".join(r.nals for r in res)
    assert _decodes_to_recon(stream, res) == (name != "p_deblock")


def test_deblock_fault_needs_rqt():
    """The same deblocked session without RQT decodes to its recon."""
    clip, _, opts = TP.RQT_SESSIONS["p_deblock"]
    opts = dict(opts, rqt=False)
    opts.pop("width"), opts.pop("height")
    s = t_top.VideoEncoderSession(W, H, device="cpu", **opts)
    res = [s.encode_frame(*f) for f in clip()]
    assert _decodes_to_recon(s.headers() + b"".join(r.nals for r in res),
                             res)


def test_rqt_is_dropped_on_the_uniform_grid():
    """As in the reference, rqt only acts on the quadtree: the uniform
    session's stream is rqt=False's."""
    frames = TP.rqt_clip(3)
    md5 = []
    for rqt in (False, True):
        s = t_top.VideoEncoderSession(W, H, qp=30, hash_sei=False,
                                      rqt=rqt, device="cpu")
        assert not s.rqt
        md5.append(TP.md5(s.headers() + b"".join(
            s.encode_frame(*f).nals for f in frames)))
    assert md5[0] == md5[1]


def _write_clip(path, frames):
    w = t_io.Y4MWriter(path, t_io.VideoInfo(64, 48, 25, 1, 1, 8))
    for f in frames:
        w.write_frame(*f)
    w.close()


def test_cli_rqt_matches_pin(tmp_path):
    """--preset ultrafast --qp 22 --rqt (the depth-1 quadtree, whose
    CU32 leaves split their TUs) codes the JAX CLI's stream."""
    src = TP.write_cli_inputs(str(tmp_path), _write_clip)
    got = TP.run_cli(t_cli.main, "rqt", str(tmp_path), src, device="cpu")
    assert got == TP.CLI_PINS["rqt"]


# ---------------------------------------------------------------------------
# the pins recomputed from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_digests_recomputed_from_the_jax_programs(port_dicts):
    src, ref, bsrc = TP.rqt_inputs()
    cfg = dict(width=W, height=H, cu_size=32, qp=QP, max_depth=2, dpb=True,
               rqt=True)
    enc = lambda **k: InterFrameEncoder(InterFrameConfig(**dict(cfg, **k)))
    jp = _jax_dict(enc().encode_frame(*src, *ref, qp=QP))
    r1 = (jp["recon_y"], jp["recon_u"], jp["recon_v"])
    got = {"p": jp,
           "p_aq": _jax_dict(enc().encode_frame(
               *src, *ref, qp=TP.RQT_QMAP.reshape(-1))),
           "p_rdoq": _jax_dict(enc(rdoq=True).encode_frame(*src, *ref,
                                                           qp=QP)),
           "b": _jax_dict(enc(bi=True, intra_in_b=False).encode_frame(
               *bsrc, *ref, qp=QP, ref1_y=r1[0], ref1_u=r1[1],
               ref1_v=r1[2]))}
    for name, d in got.items():
        assert TP.digest(d) == TP.RQT_DIGEST[name], name
        _assert_same_dict(d, port_dicts[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(TP.RQT_SESSIONS))
def test_session_pins_recomputed_from_jax(name):
    assert TP.run_session(j_top, name)[0] == TP.RQT_PINS[name]


@pytest.mark.slow
def test_cli_pin_recomputed_from_jax(tmp_path):
    def write(path, frames):
        w = j_io.Y4MWriter(path, j_io.VideoInfo(64, 48, 25, 1, 1, 8))
        for f in frames:
            w.write_frame(*f)
        w.close()
    src = TP.write_cli_inputs(str(tmp_path), write)
    assert TP.run_cli(j_cli.main, "rqt", str(tmp_path), src) == \
        TP.CLI_PINS["rqt"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_pins_on_the_card(tmp_path):
    """The RQT programs (through K1's surface), sessions and --rqt on the
    card: the pinned JAX digests and md5s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    for name, d in TP.rqt_dicts(InterQTEncoder, Quantizer, "cuda").items():
        assert TP.digest(d) == TP.RQT_DIGEST[name], name
    for name in TP.RQT_SESSIONS:
        assert TP.run_session(t_top, name)[0] == TP.RQT_PINS[name], name
    src = TP.write_cli_inputs(str(tmp_path), _write_clip)
    assert TP.run_cli(t_cli.main, "rqt", str(tmp_path), src) == \
        TP.CLI_PINS["rqt"]
