"""Session-level parity of the PyTorch port with the JAX package (CPU):
the intra and inter decision dicts, the whole IPPP CQP stream (byte for
byte, and against the blessed golden md5), the hash-SEI variant, and a
session resumed mid-GOP from a JAX session's state."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from golden_corpus import clip
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.models.inter_encoder import (InterFrameConfig,
                                                       InterFrameEncoder)
from x265_yuuki_asuna_tpu.models.intra_encoder import (IntraFrameConfig,
                                                       IntraFrameEncoder)
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import inter_encoder as t_inter
from x265_yuuki_asuna_tpu_torch.models import intra_encoder as t_intra
from x265_yuuki_asuna_tpu_torch.models.state import load_session_state

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "manifest.json")


def _assert_same_dict(j, t):
    for k, v in j.items():
        if v is None:
            assert t.get(k) is None, k
            continue
        assert np.array_equal(np.asarray(v), t[k]), k


@pytest.mark.parametrize("w,h", [(64, 48), (128, 96)])
def test_intra_decisions_match_jax(w, h):
    y, u, v = clip(w, h, n=1)[0]
    jo = IntraFrameEncoder(IntraFrameConfig(width=w, height=h, cu_size=16,
                                            qp=29)).encode_frame(y, u, v,
                                                                 qp=29)
    to = t_intra.IntraFrameEncoder(w, h, 16, "cpu").encode_frame(y, u, v, 29)
    assert set(jo) == set(to)
    _assert_same_dict(jo, to)


@pytest.mark.parametrize("w,h", [(64, 48), (128, 96)])
def test_inter_decisions_match_jax(w, h):
    f0, f1 = clip(w, h, n=2, seed=5)
    ref = IntraFrameEncoder(IntraFrameConfig(width=w, height=h, cu_size=16,
                                             qp=29)).encode_frame(*f0, qp=29)
    refs = (ref["recon_y"], ref["recon_u"], ref["recon_v"])
    jo = InterFrameEncoder(InterFrameConfig(width=w, height=h, cu_size=16,
                                            qp=32)).encode_frame(*f1, *refs,
                                                                 qp=32)
    to = t_inter.InterFrameEncoder(w, h, 16, "cpu").encode_frame(*f1, *refs,
                                                                32)
    assert set(jo) == set(to)
    assert to["use_intra"].any() or to["mvx"].any()
    _assert_same_dict(jo, to)


def _state(s):
    """A JAX session's state as load_session_state takes it."""
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
def jax_ippp():
    """The golden ippp_cqp encode in JAX: headers, per-frame NALs and the
    session state before frame 3 (part-way through the GOP)."""
    s = j_top.VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                                  hash_sei=False)
    hdr, nals, state = s.headers(), [], None
    for i, f in enumerate(clip()):
        if i == 3:
            state = _state(s)
        nals.append(s.encode_frame(*f).nals)
    return hdr, nals, state


def test_ippp_cqp_stream_matches_jax_and_golden(jax_ippp):
    hdr, nals, _ = jax_ippp
    s = t_top.VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                                  hash_sei=False, device="cpu")
    out = s.headers()
    assert out == hdr
    types = []
    for f, jn in zip(clip(), nals):
        r = s.encode_frame(*f)
        assert r.nals == jn
        types.append(r.frame_type)
        out += r.nals
    assert types == ["I"] + ["P"] * 5
    with open(GOLDEN) as fh:
        assert hashlib.md5(out).hexdigest() == json.load(fh)["ippp_cqp"]


@pytest.mark.parametrize("w,h", [(64, 48), (72, 40)])   # 72x40 pads to 80x48
def test_hash_sei_keyint3_matches_jax(w, h):
    kw = dict(qp=32, cu_size=16, keyint=3, hash_sei=True)
    js = j_top.VideoEncoderSession(w, h, **kw)
    ts = t_top.VideoEncoderSession(w, h, device="cpu", **kw)
    assert ts.headers() == js.headers()
    types = []
    for f in clip(w, h):
        jr, tr = js.encode_frame(*f), ts.encode_frame(*f)
        assert tr.nals == jr.nals
        assert (tr.frame_type, tr.qp, tr.bits) == (jr.frame_type, jr.qp,
                                                   jr.bits)
        assert tr.psnr_y == pytest.approx(jr.psnr_y, abs=1e-9)
        for a, b in zip(tr.recon, jr.recon):
            assert np.array_equal(a, b)
        types.append(tr.frame_type)
    assert types == ["I", "P", "P"] * 2


def test_load_session_state_mid_gop(jax_ippp):
    _, nals, state = jax_ippp
    s = t_top.VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                                  hash_sei=False, device="cpu")
    load_session_state(s, state)
    frames = clip()
    for i in (3, 4, 5):
        r = s.encode_frame(*frames[i])
        assert r.frame_type == "P" and r.nals == nals[i], i


def test_load_session_state_rejects_wrong_geometry(jax_ippp):
    state = dict(jax_ippp[2])
    state["ref_y"] = state["ref_y"][:32]
    s = t_top.VideoEncoderSession(64, 48, device="cpu")
    with pytest.raises(ValueError):
        load_session_state(s, state)


@pytest.mark.parametrize("option", [
    {"bframes": 3}, {"max_depth": 1}, {"deblock": True}, {"sao": True},
    {"rc_mode": "crf"}, {"aq_mode": 2}, {"cutree": True}, {"weightp": True},
    {"rdoq": True}, {"sbh": True}, {"wpp": True}, {"n_refs": 2},
    {"bit_depth": 10}, {"hme": True}, {"tmvp": True}, {"frame_dup": True},
    {"max_depth": 2, "cu_size": 64},
])
def test_options_outside_the_slice_raise(option):
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        t_top.VideoEncoderSession(64, 48, device="cpu", **option)


@pytest.mark.parametrize("option", [
    {"deblock": True}, {"sao": True}, {"rdoq": True}, {"sbh": True},
    {"hme": True}, {"psy_rd": 2.0}, {"weightp": True}, {"rqt": True},
    {"bframes": 3},
])
def test_quadtree_options_outside_the_slice_raise(option):
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        t_top.VideoEncoderSession(64, 48, max_depth=2, device="cpu",
                                  **option)


B_SESSION = dict(max_depth=2, bframes=3, b_adapt=0)


@pytest.mark.parametrize("option,match", [
    ({"b_adapt": 1}, "b_adapt=1"), ({"b_adapt": 2}, "b_adapt=2"),
    ({"open_gop": True}, "open_gop"), ({"max_depth": 0}, "max_depth=0"),
    ({"b_intra": True}, "b_intra"),
])
def test_b_session_options_outside_the_slice_raise(option, match):
    with pytest.raises(NotImplementedError, match=match):
        t_top.VideoEncoderSession(64, 48, device="cpu",
                                  **{**B_SESSION, **option})


def test_b_session_takes_frames_through_push_frame_only():
    y, u, v = clip(64, 48, n=1)[0]
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **B_SESSION)
    with pytest.raises(RuntimeError, match="push_frame"):
        s.encode_frame(y, u, v)
    s = t_top.VideoEncoderSession(64, 48, device="cpu", max_depth=2)
    with pytest.raises(RuntimeError, match="bframes"):
        s.push_frame(y, u, v)


def test_load_session_state_refuses_b_sessions(jax_ippp):
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **B_SESSION)
    with pytest.raises(NotImplementedError, match="bframes"):
        load_session_state(s, jax_ippp[2])
