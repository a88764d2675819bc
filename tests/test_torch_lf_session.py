"""The port's sessions with the in-loop filters (CPU, port only): the
golden ippp_deblock_sao stream against the manifest, and the quadtree
IPPP (deblock only, SAO only, both) and B-pyramid streams against the JAX
session's md5s pinned here, with the hash SEI on so that every filtered
recon is held too; a mid-GOP resume of filtered IPPP sessions; the
recomputation of the pins from the JAX session (slow); and the card
twins (gpu-marked) of the golden streams and of a filtered B frame's
kernel-vs-plain identity."""
import hashlib
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from golden_corpus import clip
from test_torch_qt_b_session import B_KW, ORDER, encode_push
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models.state import rc_state, \
    load_session_state
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "manifest.json")
LF = dict(deblock=True, sao=True)
UNI = dict(qp=32, cu_size=16, keyint=100)
QT2 = dict(qp=30, max_depth=2, keyint=100)
# the sessions over the golden clip (IPPP: clip(), 6 frames; B: clip(64,
# 48, n=8) through push_frame / flush), and the md5 of the JAX package's
# stream of each
SESSIONS = {
    "uniform_lf_sei": dict(UNI, hash_sei=True, **LF),
    "qt2_lf": dict(QT2, hash_sei=False, **LF),
    "qt2_lf_sei": dict(QT2, hash_sei=True, **LF),
    "qt2_deblock_sei": dict(QT2, hash_sei=True, deblock=True),
    "qt2_sao_sei": dict(QT2, hash_sei=True, sao=True),
    "qt2_b_lf_sei": dict(B_KW, hash_sei=True, **LF),
}
MD5 = {"uniform_lf_sei": "0b71ca6e5ad866cf844df3036a46daa9",
       "qt2_lf": "8652adbe48b9c73dc3281aab30aaa627",
       "qt2_lf_sei": "25599653a857fb705ce2eeac6aa750da",
       "qt2_deblock_sei": "2d90faddf7006deecc338c2158e3cf93",
       "qt2_sao_sei": "26fde88783d0cff2df089b4fb0afa6b4",
       "qt2_b_lf_sei": "001a8cbb356be2cc980690bd99ba8630"}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


def encode(top, name, **extra):
    """md5 and results of session `name` of the encoder_top module
    `top` over the golden clip."""
    kw = dict(SESSIONS[name], **extra)
    if kw.get("bframes"):
        hdr, res = encode_push(top, kw)
    else:
        s = top.VideoEncoderSession(64, 48, **kw)
        hdr, res = s.headers(), [s.encode_frame(*f) for f in clip()]
    return hashlib.md5(hdr + b"".join(r.nals for r in res)).hexdigest(), res


def test_ippp_deblock_sao_matches_the_golden_manifest():
    with open(GOLDEN) as fh:
        want = json.load(fh)["ippp_deblock_sao"]
    s = t_top.VideoEncoderSession(64, 48, hash_sei=False, device="cpu",
                                  **UNI, **LF)
    out = s.headers() + b"".join(s.encode_frame(*f).nals for f in clip())
    assert hashlib.md5(out).hexdigest() == want


@pytest.mark.parametrize("name", sorted(MD5))
def test_filtered_stream_matches_pinned_jax_md5(name):
    md5, res = encode(t_top, name, device="cpu")
    if SESSIONS[name].get("bframes"):
        assert [(r.poc, r.frame_type) for r in res] == ORDER["pyramid"]
    assert md5 == MD5[name]


def test_filtered_recon_is_the_hashed_reference():
    """The recon a filtered session returns is the filtered picture: the
    one its hash SEI hashes (each plane), not the unfiltered one (64x64:
    the coded size of both grids)."""
    for kw in (UNI, QT2):
        on = t_top.VideoEncoderSession(64, 64, device="cpu", **kw, **LF)
        off = t_top.VideoEncoderSession(64, 64, device="cpu", **kw)
        differ = False
        for f in clip(64, 64, n=3):
            r_on, r_off = on.encode_frame(*f), off.encode_frame(*f)
            for a, b in zip(r_on.recon, r_off.recon):
                assert hashlib.md5(a.tobytes()).digest() in r_on.nals
                differ |= not np.array_equal(a, b)
        assert differ


def _port_state(s):
    """A port session's state as load_session_state takes it."""
    host = lambda a: a.cpu().numpy() if torch.is_tensor(a) \
        else np.asarray(a)
    st = {"ref_y": host(s.ref[0]), "ref_u": host(s.ref[1]),
          "ref_v": host(s.ref[2]),
          "prev_lowres": host(s.lookahead.prev_lowres),
          "frame_idx": s.frame_idx, "poc": s.poc,
          "display_idx": s.display_idx}
    st.update(rc_state(s.rc))
    return st


@pytest.mark.parametrize("kw", [UNI, QT2], ids=["uniform", "qt2"])
def test_load_session_state_mid_gop_with_filters(kw):
    """A filtered session resumed before frame 3 from the state of one
    that ran frames 0-2 codes frames 3-5 exactly as the unbroken one: the
    reference it carries is the filtered recon."""
    frames = clip()
    s = t_top.VideoEncoderSession(64, 48, hash_sei=True, device="cpu",
                                  **kw, **LF)
    nals, state = [], None
    for i, f in enumerate(frames):
        if i == 3:
            state = _port_state(s)
        nals.append(s.encode_frame(*f).nals)
    r = t_top.VideoEncoderSession(64, 48, hash_sei=True, device="cpu",
                                  **kw, **LF)
    load_session_state(r, state)
    assert [r.encode_frame(*f).nals for f in frames[3:]] == nals[3:]


def test_filters_do_not_open_other_later_options():
    # (rqt and the analysis options run now with the filters: the
    # geometries outside the port still raise, and the quadtree keeps
    # the reference's assertion against analysis reuse)
    with pytest.raises(NotImplementedError, match="max_depth"):
        t_top.VideoEncoderSession(64, 48, device="cpu", max_depth=3,
                                  rqt=True, **LF)
    with pytest.raises(AssertionError, match="analysis"):
        t_top.VideoEncoderSession(64, 48, device="cpu", max_depth=2,
                                  analysis_share=[], **LF)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(MD5))
def test_pins_recomputed_from_the_jax_session(name):
    """Where the pinned md5s come from: the JAX session's stream of the
    same configuration (its quadtree programs with the filters compile on
    the CPU for 1-2 minutes each, hence slow)."""
    from x265_yuuki_asuna_tpu.models import encoder_top as j_top
    assert encode(j_top, name)[0] == MD5[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qt2_lf_sei", "qt2_b_lf_sei",
                                  "uniform_lf_sei"])
def test_filtered_golden_on_the_card(name):
    _need_card()
    assert encode(t_top, name)[0] == MD5[name]


@pytest.mark.gpu
def test_filtered_b_frame_kernel_vs_plain_on_the_card():
    """The last b frame of a filtered 128x96 B session again, K1 against
    its plain version: decisions, filtered recon and SAO parameters."""
    _need_card()
    s = t_top.VideoEncoderSession(128, 96, **dict(B_KW, **LF))
    enc = s.inter_encoder
    calls, run = [], enc.encode_frame
    enc.encode_frame = lambda *a, **k: calls.append((a, k)) or run(*a, **k)
    for f in clip(128, 96, n=5):
        s.push_frame(*f)
    a, k = calls[-1]
    out_k = run(*a, **k)
    with mock.patch.object(me_sad, "sad_block8_sweep",
                           me_sad.sad_block8_sweep_plain):
        out_p = run(*a, **k)
    assert "sao" in out_k
    for key, v in out_k.items():
        if key == "recon_dev":
            assert all(torch.equal(x, z) for x, z in zip(v, out_p[key]))
        elif v is None:
            assert out_p[key] is None
        else:
            assert np.array_equal(v, out_p[key]), key
