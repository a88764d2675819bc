"""psy-rd and intra candidates in B slices in the port (CPU, exact).

psy_energy against the JAX package's on seeded blocks of every size; the
golden `intra_qt2_psy` stream (the all-intra quadtree with psy_rd=1.0)
through the port's IntraEncoderSession; and the quadtree P and B decision
dicts with psy_rd=2.0 (the P dict at 0.4 too) and the B dict with
b_intra=True at 128x96, held to digests of the JAX dicts pinned here.
The P and B frames predict from
the port's intra and P recon of test_torch_qt_programs.py's frames
(equal to the JAX recon while that file's digests hold). The b_intra B
frame's source carries a ramp and flat blocks that neither reference
has, so intra leaves win at 32 and 8. The slow test recomputes the
digests from the live JAX programs (a program compile of minutes each)
and compares the dicts key by key."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from golden_corpus import clip
from test_torch_qt_programs import (H, W, _assert_same_dict, _b_frame,
                                    _frames, _jax_dict, _recon, digest)
from x265_yuuki_asuna_tpu.models.inter_encoder import (InterFrameConfig,
                                                       InterFrameEncoder)
from x265_yuuki_asuna_tpu.ops import pixel as j_pixel
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import qt_common as t_qt
from x265_yuuki_asuna_tpu_torch.models.inter_encoder import InterQTEncoder
from x265_yuuki_asuna_tpu_torch.models.intra_encoder import IntraQTEncoder
from x265_yuuki_asuna_tpu_torch.ops import pixel as t_pixel

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "manifest.json")
# sha256 of the JAX package's decision dicts (test_torch_qt_programs's
# digest): the P frame at qp 32 and the B frame at qp 27 with
# psy_rd=2.0 (at qp 33, that file's B QP, psy-rd moves no decision of
# this frame), the P frame with --tune animation's psy_rd=0.4, and the B
# frame of _b_intra_frame at qp 33 with b_intra
DIGEST = {
    "p_psy":
        "87148ffe60a8806cc2321de203222fbf657f1705e4e7cb15eff1e47a4451d509",
    "p_psy04":
        "037e23edb32ac49045cd4c3cd1eb4b69f535d74a971a9d2f92215f1f99d0111a",
    "b_psy":
        "6661c37d0fb3dc261adf23ea22dac1496a87230dca86e67cab33150a40386d40",
    "b_intra":
        "468092c33a32e1c28ed58e4daa5107c2462f30b8018cd0e5a8e1ecaa8e81211a"}


@pytest.mark.parametrize("nn", [8, 16, 32])
def test_psy_energy_matches_jax(nn):
    rng = np.random.default_rng(nn)
    blocks = [rng.integers(0, 256, (6, nn, nn)),
              np.full((2, nn, nn), 77),                    # flat: no AC
              np.broadcast_to(np.arange(nn) * (255 // nn), (3, nn, nn)),
              rng.integers(250, 256, (2, nn, nn))]
    a = np.concatenate(blocks).astype(np.int32)
    j = np.asarray(jax.jit(lambda x: j_pixel.psy_energy(x, xp=jnp))(a))
    t = t_pixel.psy_energy(torch.as_tensor(a)).numpy()
    assert np.array_equal(t, j) and t.dtype == np.int32
    assert (t[6:8] == 0).all() and (t[:6] > 0).all()


def test_sa8d_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (5, 16, 24)).astype(np.int32)
    b = rng.integers(0, 256, (5, 16, 24)).astype(np.int32)
    j = np.asarray(j_pixel.sa8d(a, b))
    assert np.array_equal(t_pixel.sa8d(torch.as_tensor(a),
                                       torch.as_tensor(b)).numpy(), j)


def test_golden_intra_qt2_psy_stream():
    """The manifest's intra_qt2_psy (64x48, 6 frames, qp 30, psy_rd 1.0)
    through the port. On this clip psy-rd 1 moves no decision (the stream
    without it is the same), so the dict pins below carry psy-rd's
    effect."""
    def stream(psy):
        sess = t_top.IntraEncoderSession(64, 48, qp=30, max_depth=2,
                                         psy_rd=psy, hash_sei=False,
                                         device="cpu")
        out = sess.headers()
        for f in clip(64, 48, n=6):
            out += sess.encode_frame(*f).nals
        return hashlib.md5(out).hexdigest()
    with open(GOLDEN) as f:
        assert stream(1.0) == json.load(f)["intra_qt2_psy"]


def _b_intra_frame(f0, f1):
    """The B frame of _b_frame with content neither reference has: a
    32x32 ramp, a flat 16x16 block and two flat 8x8 blocks."""
    y, u, v = _b_frame(f0, f1)
    y = y.copy()
    y[0:32, 0:32] = np.add.outer(np.arange(32) * 6, np.arange(32) * 2) % 256
    y[32:48, 48:64] = 230
    y[64:72, 8:16] = 20
    y[72:80, 16:24] = 240
    return y, u, v


@pytest.fixture(scope="module")
def port_dicts():
    f0, f1 = _frames()
    ti = IntraQTEncoder(W, H, "cpu").encode_frame(*f0, 30)
    tp = InterQTEncoder(W, H, "cpu").encode_frame(*f1, *_recon(ti), 32)
    enc = lambda **kw: InterQTEncoder(W, H, "cpu", **kw)
    return {
        "p_psy": enc(psy_rd=2.0).encode_frame(*f1, *_recon(ti), 32),
        "p_psy04": enc(psy_rd=0.4).encode_frame(*f1, *_recon(ti), 32),
        "b_psy": enc(psy_rd=2.0).encode_frame(*_b_frame(f0, f1),
                                              *_recon(ti), 27,
                                              ref1=_recon(tp)),
        "b_intra": enc(b_intra=True).encode_frame(
            *_b_intra_frame(f0, f1), *_recon(ti), 33, ref1=_recon(tp)),
        "refs": (ti, tp)}


def _leaf_sizes(d):
    """The sizes of the decided intra leaves of a dict."""
    leaves = t_qt.intra_leaves(
        d["split"].reshape(-1), d["split16"].reshape(-1, 4),
        d["modes"].reshape(-1), d["modes4"].reshape(-1, 4),
        d["modes8"].reshape(-1, 4, 4), d["use_intra"].reshape(-1),
        d["use_intra4"].reshape(-1, 4), d["use_intra8"].reshape(-1, 4, 4))
    return {t_qt.ZPOS[k][2] for _, k, _ in leaves}


def test_p_qt_psy_decisions_match_jax(port_dicts):
    d = port_dicts["p_psy"]
    assert digest(d) == DIGEST["p_psy"]
    assert _leaf_sizes(d) and not d["use_intra8"].any()


def test_p_qt_psy_animation_decisions_match_jax(port_dicts):
    """psy_rd 0.4 (--tune animation), where psy_rd * |dE| is not exact in
    float32: the port's contracted multiply-add gives the JAX dict (on
    this frame the decisions are the same with two roundings too)."""
    d = port_dicts["p_psy04"]
    assert digest(d) == DIGEST["p_psy04"]
    assert digest(d) not in (DIGEST["p_psy"], digest(InterQTEncoder(
        W, H, "cpu").encode_frame(*_frames()[1],
                                  *_recon(port_dicts["refs"][0]), 32)))


def test_b_qt_psy_decisions_match_jax(port_dicts):
    d = port_dicts["b_psy"]
    assert digest(d) == DIGEST["b_psy"]
    assert not any(d[k].any() for k in ("use_intra", "use_intra4",
                                        "use_intra8"))


def test_b_qt_intra_decisions_match_jax(port_dicts):
    """Intra leaves in the B frame, 8x8 ones among them (which P slices
    never have), committed over the inter ones: their recon differs from
    the dense inter recon. (Intra wins at 16 too, inside 16-blocks the
    tree splits to 8.)"""
    d = port_dicts["b_intra"]
    assert digest(d) == DIGEST["b_intra"]
    assert _leaf_sizes(d) == {8, 32} and d["use_intra4"].any()
    f0, f1 = _frames()
    ti, tp = port_dicts["refs"]
    plain = InterQTEncoder(W, H, "cpu").encode_frame(
        *_b_intra_frame(f0, f1), *_recon(ti), 33, ref1=_recon(tp))
    assert not np.array_equal(plain["recon_y"], d["recon_y"])


def test_psy_rd_moves_the_decisions(port_dicts):
    """psy_rd 2 changes the P and the B frame's dicts (the pins would not
    tell a program that ignored it)."""
    f0, f1 = _frames()
    ti, tp = port_dicts["refs"]
    enc = InterQTEncoder(W, H, "cpu")
    assert digest(enc.encode_frame(*f1, *_recon(ti), 32)) \
        != digest(port_dicts["p_psy"])
    assert digest(enc.encode_frame(*_b_frame(f0, f1), *_recon(ti), 27,
                                   ref1=_recon(tp))) \
        != digest(port_dicts["b_psy"])


def jax_dicts(port):
    """The JAX programs' dicts of port_dicts' frames, from the port's
    references (four program compiles)."""
    f0, f1 = _frames()
    ti, tp = port["refs"]

    def enc(qp, **kw):
        return InterFrameEncoder(InterFrameConfig(
            width=W, height=H, cu_size=32, qp=qp, max_depth=2, dpb=True,
            **kw))

    ref1 = dict(ref1_y=tp["recon_y"], ref1_u=tp["recon_u"],
                ref1_v=tp["recon_v"])
    return {
        "p_psy": _jax_dict(enc(32, psy_rd=2.0).encode_frame(
            *f1, *_recon(ti), qp=32)),
        "p_psy04": _jax_dict(enc(32, psy_rd=0.4).encode_frame(
            *f1, *_recon(ti), qp=32)),
        "b_psy": _jax_dict(enc(27, psy_rd=2.0, bi=True, intra_in_b=False)
                           .encode_frame(*_b_frame(f0, f1), *_recon(ti),
                                         qp=27, **ref1)),
        "b_intra": _jax_dict(enc(33, bi=True, intra_in_b=True).encode_frame(
            *_b_intra_frame(f0, f1), *_recon(ti), qp=33, **ref1))}


@pytest.fixture(scope="module")
def jax_frames(port_dicts):
    return jax_dicts(port_dicts)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(DIGEST))
def test_digests_recomputed_from_the_jax_programs(name, jax_frames,
                                                   port_dicts):
    assert digest(jax_frames[name]) == DIGEST[name]
    _assert_same_dict(jax_frames[name], port_dicts[name])
