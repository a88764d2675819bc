"""Sign-bit hiding and RDOQ in the port's quadtree programs and video
sessions (CPU). The intra and P decision dicts with sign hiding and the
intra dict with context RDOQ against the JAX programs at 128x96, exact,
on test_torch_qt_programs.py's content (the P frame predicts from the
intra frame's recon), held to digests of the JAX dicts pinned here; and
the video sessions with sign hiding or RDOQ over the golden clip, hash
SEI on, against the JAX sessions' md5s pinned here: the quadtree IPPP
session with each, the uniform IPPP session with each (sign hiding with
the filters), and the B-pyramid session with sign hiding and the filters
(the flagship's set). The slow tests recompute the digests from the live
JAX programs and the md5s from the JAX sessions; the card twins
(gpu-marked) hold the md5s on the card."""
import hashlib

import numpy as np
import pytest
import torch

from golden_corpus import clip
from test_torch_qt_b_session import B_KW, encode_push
from test_torch_qt_programs import W, H, _assert_same_dict, _frames, \
    _jax_dict, _recon, digest
from x265_yuuki_asuna_tpu.models.inter_encoder import (InterFrameConfig,
                                                       InterFrameEncoder)
from x265_yuuki_asuna_tpu.models.intra_encoder import (IntraFrameConfig,
                                                       IntraFrameEncoder)
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models.inter_encoder import InterQTEncoder
from x265_yuuki_asuna_tpu_torch.models.intra_encoder import IntraQTEncoder
from x265_yuuki_asuna_tpu_torch.ops.quant import Quantizer

torch.set_num_threads(2)

LF = dict(deblock=True, sao=True)
QT2 = dict(qp=30, max_depth=2, keyint=100, hash_sei=True)
UNI = dict(qp=32, cu_size=16, keyint=100, hash_sei=True)
SESSIONS = {
    "qt2_sbh_sei": dict(QT2, sbh=True),
    "qt2_rdoq_sei": dict(QT2, rdoq=True),
    "uniform_sbh_lf_sei": dict(UNI, sbh=True, **LF),
    "uniform_rdoq_sei": dict(UNI, rdoq=True),
    "qt2_b_sbh_lf_sei": dict(B_KW, hash_sei=True, sbh=True, **LF),
}
MD5 = {"qt2_sbh_sei": "af92aec53e249fc7931649e5d144417b",
       "qt2_rdoq_sei": "1412dcc346a0bec9a3e16cdda21e59fd",
       "uniform_sbh_lf_sei": "86134eabdce143334d707d4340d084a3",
       "uniform_rdoq_sei": "dcf4dbd51a89fa62ffd089ef3bfb2ed0",
       "qt2_b_sbh_lf_sei": "2734e716459f0c1887d6c689eff0055b"}
# digest() of the JAX programs' dicts at 128x96: the intra frame at qp 30
# with sign hiding and with RDOQ, the P frame at qp 32 with sign hiding
# from the first's recon
DIGEST = {"intra_sbh":
            "ae9948963aaa0ffe956a205609f05ef39b4b68376c64f561bcf87f89dc102b04",
          "intra_rdoq":
            "10d09f954c7ff0c3e34792daea7e1807031646f3b508071c293579bc22ad8fa4",
          "p_sbh":
            "9b974cd78e812524d7fcc0690459d3bbbab714bf541b5d71f87b9f7c7bbd4c84"}


def encode(top, name, **extra):
    """md5 of session `name` of the encoder_top module `top` over the
    golden clip (IPPP: clip(), 6 frames; B: clip(64, 48, n=8) through
    push_frame / flush)."""
    kw = SESSIONS[name]
    if kw.get("bframes"):
        hdr, res = encode_push(top, kw, **extra)
    else:
        s = top.VideoEncoderSession(64, 48, **kw, **extra)
        hdr, res = s.headers(), [s.encode_frame(*f) for f in clip()]
    return hashlib.md5(hdr + b"".join(r.nals for r in res)).hexdigest()


@pytest.fixture(scope="module")
def port_frames():
    """The port's dicts: the intra frame with sign hiding and with RDOQ,
    and the P frame with sign hiding from the first's recon."""
    f0, f1 = _frames()
    ti = IntraQTEncoder(W, H, "cpu", quant_fn=Quantizer(sbh=True)) \
        .encode_frame(*f0, 30)
    tr = IntraQTEncoder(W, H, "cpu", quant_fn=Quantizer(rdoq=True)) \
        .encode_frame(*f0, 30)
    tp = InterQTEncoder(W, H, "cpu", quant_fn=Quantizer(sbh=True)) \
        .encode_frame(*f1, *_recon(ti), 32)
    return {"intra_sbh": ti, "intra_rdoq": tr, "p_sbh": tp}


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX intra program with sign hiding and with RDOQ, and the P
    program with sign hiding from the first's recon (three compiles)."""
    f0, f1 = _frames()
    cfg = dict(width=W, height=H, cu_size=32, max_depth=2, dpb=True)
    ji = _jax_dict(IntraFrameEncoder(IntraFrameConfig(
        qp=30, sbh=True, **cfg)).encode_frame(*f0, qp=30))
    jr = _jax_dict(IntraFrameEncoder(IntraFrameConfig(
        qp=30, rdoq=True, **cfg)).encode_frame(*f0, qp=30))
    jp = _jax_dict(InterFrameEncoder(InterFrameConfig(
        qp=32, sbh=True, **cfg)).encode_frame(*f1, *_recon(ji), qp=32))
    return {"intra_sbh": ji, "intra_rdoq": jr, "p_sbh": jp}


def test_intra_qt_sbh_decisions_match_jax(port_frames):
    to = port_frames["intra_sbh"]
    assert digest(to) == DIGEST["intra_sbh"]
    plain = IntraQTEncoder(W, H, "cpu").encode_frame(*_frames()[0], 30)
    assert not np.array_equal(plain["levels_y"], to["levels_y"])


def test_intra_qt_rdoq_decisions_match_jax(port_frames):
    assert digest(port_frames["intra_rdoq"]) == DIGEST["intra_rdoq"]


def test_p_qt_sbh_decisions_match_jax(port_frames):
    to = port_frames["p_sbh"]
    assert digest(to) == DIGEST["p_sbh"]
    assert to["use_intra"].any() or to["use_intra4"].any()


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(DIGEST))
def test_digests_recomputed_from_the_jax_programs(name, jax_frames,
                                                   port_frames):
    """Where the digests come from: the JAX programs' dicts, which the
    port's equal key by key."""
    assert digest(jax_frames[name]) == DIGEST[name]
    _assert_same_dict(jax_frames[name], port_frames[name])


@pytest.mark.parametrize("name", sorted(MD5))
def test_session_matches_pinned_jax_md5(name):
    assert encode(t_top, name, device="cpu") == MD5[name]


def test_sbh_and_rdoq_move_the_stream():
    """Each option changes the stream it is set on, and sign hiding is
    off under RDOQ (the PPS flag and the stream are RDOQ's alone)."""
    plain = t_top.VideoEncoderSession(64, 48, device="cpu", **UNI)
    both = t_top.VideoEncoderSession(64, 48, device="cpu", sbh=True,
                                     rdoq=True, **UNI)
    assert not both.sbh and not both.pps.sign_hiding
    assert encode(t_top, "uniform_rdoq_sei", device="cpu") == \
        hashlib.md5(both.headers() + b"".join(
            both.encode_frame(*f).nals for f in clip())).hexdigest()
    assert plain.headers() != t_top.VideoEncoderSession(
        64, 48, device="cpu", sbh=True, **UNI).headers()


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(MD5))
def test_pins_recomputed_from_the_jax_session(name):
    """Where the pins come from: the JAX session of the same
    configuration (its quadtree programs compile for minutes)."""
    from x265_yuuki_asuna_tpu.models import encoder_top as j_top
    assert encode(j_top, name) == MD5[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qt2_b_sbh_lf_sei", "qt2_rdoq_sei",
                                  "uniform_rdoq_sei"])
def test_pinned_session_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    assert encode(t_top, name) == MD5[name]
