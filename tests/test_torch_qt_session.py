"""The port's CTU32 depth-2 quadtree sessions against the JAX package's
(CPU): the golden qt2_ippp clip byte for byte (headers, every frame's
NALs, the blessed md5), a session resumed mid-GOP from the JAX session's
state, the B session (bframes=3, B-pyramid, b_adapt=0, push_frame /
flush) on the golden clip byte for byte, and the card tests (gpu-marked:
the golden stream and the kernel-vs-plain identity of a P frame on the
card). The JAX B session runs in this module so that it takes the JAX
IPPP session's I and P programs (the same configuration) and compiles
only its B program; test_torch_qt_b_session.py holds the other B-session
tests."""
import hashlib
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from golden_corpus import clip
from test_torch_qt_b_session import B_KW, MD5, ORDER, encode_push
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models.state import load_session_state
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "manifest.json")
QT2 = dict(qp=30, max_depth=2, keyint=100, hash_sei=False)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


def _golden_md5():
    with open(GOLDEN) as fh:
        return json.load(fh)["qt2_ippp"]


def _state(s):
    """A JAX quadtree session's state as load_session_state takes it (its
    reference planes are device arrays)."""
    st = {"ref_y": np.asarray(s.ref[0]), "ref_u": np.asarray(s.ref[1]),
          "ref_v": np.asarray(s.ref[2]),
          "prev_lowres": np.asarray(s.lookahead.prev_lowres),
          "frame_idx": s.frame_idx, "poc": s.poc,
          "display_idx": s.display_idx,
          "rc_window_bits": list(s.rc.window_bits)}
    for k in ("frame", "total_bits", "cplx_sum", "cplx_count",
              "short_term_cplx", "short_term_count", "last_qscale",
              "last_satd"):
        st["rc_" + k] = getattr(s.rc, k)
    return st


@pytest.fixture(scope="module")
def jax_qt2_session():
    """The golden qt2_ippp encode in JAX: the session, its headers,
    per-frame NALs and the session state before frame 3."""
    s = j_top.VideoEncoderSession(64, 48, **QT2)
    hdr, nals, state = s.headers(), [], None
    for i, f in enumerate(clip()):
        if i == 3:
            state = _state(s)
        nals.append(s.encode_frame(*f).nals)
    return s, hdr, nals, state


@pytest.fixture(scope="module")
def jax_qt2(jax_qt2_session):
    return jax_qt2_session[1:]


@pytest.fixture(scope="module")
def jax_qt2_b(jax_qt2_session):
    """The JAX B session over the golden clip: (headers, results). Its I
    and P frame encoders are the IPPP session's, whose configuration is
    the same, so their compiled programs are reused."""
    ippp = jax_qt2_session[0]

    def share(s):
        s.inter_encoder = ippp.inter_encoder
        s.intra_sess.frame_encoder = ippp.intra_sess.frame_encoder

    return encode_push(j_top, B_KW, setup=share)


def test_qt2_ippp_stream_matches_jax_and_golden(jax_qt2):
    hdr, nals, _ = jax_qt2
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **QT2)
    assert s.cu == 32
    out = s.headers()
    assert out == hdr
    types = []
    for f, jn in zip(clip(), nals):
        r = s.encode_frame(*f)
        assert r.nals == jn
        types.append(r.frame_type)
        out += r.nals
    assert types == ["I"] + ["P"] * 5
    assert hashlib.md5(out).hexdigest() == _golden_md5()


def test_qt2_load_session_state_mid_gop(jax_qt2):
    _, nals, state = jax_qt2
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **QT2)
    load_session_state(s, state)
    assert all(isinstance(p, torch.Tensor) and p.dtype == torch.uint8
               for p in s.ref)
    frames = clip()
    for i in (3, 4, 5):
        r = s.encode_frame(*frames[i])
        assert r.frame_type == "P" and r.nals == nals[i], i


def test_qt2_b_stream_matches_jax(jax_qt2_b):
    jh, jres = jax_qt2_b
    th, tres = encode_push(t_top, B_KW, device="cpu")
    assert th == jh
    assert [(r.poc, r.frame_type) for r in jres] == ORDER["pyramid"]
    assert [(r.poc, r.frame_type) for r in tres] == ORDER["pyramid"]
    for t, j in zip(tres, jres):
        assert t.nals == j.nals, (t.poc, t.frame_type)
    stream = lambda h, res: hashlib.md5(
        h + b"".join(r.nals for r in res)).hexdigest()
    assert stream(jh, jres) == stream(th, tres) == MD5["pyramid"]


def test_qt2_session_recon_and_hash_sei():
    """With the hash SEI on, the recon the session returns is the one the
    SEI hashes, and the next frame's reference stays on the device."""
    s = t_top.VideoEncoderSession(64, 64, qp=30, max_depth=2, keyint=100,
                                  hash_sei=True, device="cpu")
    for f in clip(64, 64, n=2):
        r = s.encode_frame(*f)
        md5 = hashlib.md5(r.recon[0].tobytes()).digest()
        assert md5 in r.nals and np.isfinite(r.psnr_y)
        assert isinstance(s.ref[0], torch.Tensor)


@pytest.mark.gpu
def test_qt2_golden_on_the_card():
    _need_card()
    s = t_top.VideoEncoderSession(64, 48, **QT2)
    out = s.headers() + b"".join(s.encode_frame(*f).nals for f in clip())
    assert hashlib.md5(out).hexdigest() == _golden_md5()


@pytest.mark.gpu
def test_qt2_p_frame_kernel_vs_plain_on_the_card():
    _need_card()
    s = t_top.VideoEncoderSession(128, 96, qp=30, max_depth=2, keyint=100,
                                  hash_sei=False)
    frames = clip(128, 96, n=2)
    s.encode_frame(*frames[0])
    y, u, v = frames[1]
    before = me_sad.sad_block8_sweep.launches
    out_k = s.inter_encoder.encode_frame(y, u, v, *s.ref, 30)
    assert me_sad.sad_block8_sweep.launches == before + 1
    with mock.patch.object(me_sad, "sad_block8_sweep",
                           me_sad.sad_block8_sweep_plain):
        out_p = s.inter_encoder.encode_frame(y, u, v, *s.ref, 30)
    for k, a in out_k.items():
        if k == "recon_dev":
            assert all(torch.equal(x, z) for x, z in zip(a, out_p[k]))
        elif a is None:
            assert out_p[k] is None
        else:
            assert np.array_equal(a, out_p[k]), k
