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
from x265_yuuki_asuna_tpu_torch.models.state import (load_session_state,
                                                     rc_state)

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


def test_load_session_state_mid_gop_crf_vbv():
    """A JAX CRF + VBV session stopped after 3 frames continues in the
    port: the CRF blur, the bits predictors and the VBV buffer carry over,
    so the next QPs and NALs are the JAX session's."""
    kw = dict(qp=32, cu_size=16, keyint=100, hash_sei=False, rc_mode="crf",
              crf=26.0, vbv_maxrate_kbps=150, vbv_bufsize_kbps=40)
    js = j_top.VideoEncoderSession(64, 48, **kw)
    frames, res, state = clip(), [], None
    for i, f in enumerate(frames):
        if i == 3:
            state = dict(_state(js), **rc_state(js.rc))
        res.append(js.encode_frame(*f))
    assert {"rc_la_blur", "rc_buffer_fill", "rc_rate_factor",
            "rc_pred_P_coeff", "rc__last_rceq"} <= set(state)
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    load_session_state(s, state)
    got = [s.encode_frame(*frames[i]) for i in (3, 4, 5)]
    assert [(r.nals, r.qp) for r in got] == \
        [(r.nals, r.qp) for r in res[3:]]
    # a fresh rate control would code them otherwise
    fresh = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    load_session_state(fresh, {k: v for k, v in state.items()
                               if not k.startswith("rc_")})
    assert [fresh.encode_frame(*frames[i]).qp for i in (3, 4, 5)] != \
        [r.qp for r in got]


def test_load_session_state_rejects_wrong_geometry(jax_ippp):
    state = dict(jax_ippp[2])
    state["ref_y"] = state["ref_y"][:32]
    s = t_top.VideoEncoderSession(64, 48, device="cpu")
    with pytest.raises(ValueError):
        load_session_state(s, state)


NIE, AE = NotImplementedError, AssertionError


@pytest.mark.parametrize("option,exc,match", [
    # (the cases bframes and max_depth=1 had: both run now, the uniform
    # B session and the depth-1 quadtree)
    # (the case cu_size=64 took the place of cu_size=32, and scale_factor
    # 4 and analysis_share "load" those of hash_type 1 and 2: the uniform
    # CTU32 grid and the CRC and checksum SEI run now; cu_size 8 and 128,
    # max_depth 4, analysis_load / analysis_save "b.dat", scale_factor 3
    # and analysis_share [] took the places of max_merge 5, wpp, n_refs,
    # max_merge 2, dup_threshold, tmvp and frame_dup: the P-frame options
    # run now, tests/test_torch_p_options.py)
    # (the analysis options and rqt run now, tests/test_torch_analysis.py
    # and test_torch_rqt.py: their cases hold a geometry still outside
    # the port, or a combination the reference asserts against)
    pytest.param({"max_depth": 3}, NIE, "max_depth", id="option0"),
    pytest.param({"cu_size": 64}, NIE, "cu_size", id="option1"),
    pytest.param({"rqt": True, "max_depth": 3}, NIE, "max_depth",
                 id="option2"),
    # (the case cu_size 4 took the place of cu_size 8: the uniform 8x8
    # grid codes now, tests/test_torch_cu8.py)
    pytest.param({"cu_size": 4}, NIE, "cu_size", id="option3"),
    pytest.param({"scale_factor": 2, "cu_size": 24}, NIE, "cu_size",
                 id="option4"),
    pytest.param({"analysis_save": "a.dat", "n_refs": 2}, AE, "multi-ref",
                 id="option5"),
    pytest.param({"scale_factor": 4, "max_depth": 4}, NIE, "max_depth",
                 id="option6"),
    # (the cases bit_depth 12 and 10 had: both run now, Main12 and Main10)
    pytest.param({"analysis_share": "load", "cu_size": 128}, NIE,
                 "cu_size", id="option7"),
    pytest.param({"analysis_load": "a.dat", "n_refs": 2}, AE, "multi-ref",
                 id="option8"),
    pytest.param({"analysis_share": "save", "n_refs": 2}, AE, "multi-ref",
                 id="option9"),
    pytest.param({"analysis_load": "b.dat", "max_depth": 2}, AE,
                 "no analysis reuse", id="option10"),
    pytest.param({"scale_factor": 3, "max_depth": 3}, NIE, "max_depth",
                 id="option11"),
    pytest.param({"max_depth": 4}, NIE, "max_depth", id="option12"),
    pytest.param({"analysis_save": "b.dat", "max_depth": 1}, AE,
                 "no analysis reuse", id="option13"),
    pytest.param({"cu_size": 128}, NIE, "cu_size", id="option14"),
    pytest.param({"analysis_share": [], "max_depth": 2}, AE,
                 "no analysis reuse", id="option15"),
    # (the case max_depth 3 with cu_size 64 took the place of max_depth 2
    # with cu_size 64: the video session's quadtree codes CTU32 whatever
    # cu_size, as the reference's does; CTU64 is the all-intra session's)
    pytest.param({"max_depth": 3, "cu_size": 64}, NIE, "max_depth",
                 id="option16"),
])
def test_options_outside_the_slice_raise(option, exc, match):
    """A geometry the port does not code raises NotImplementedError
    naming it; an option the reference asserts against raises
    AssertionError with the reference's reason (before any file is
    opened)."""
    with pytest.raises(exc, match=match):
        t_top.VideoEncoderSession(64, 48, device="cpu", **option)


@pytest.mark.parametrize("option", [
    {"rc_mode": "crf"}, {"scenecut_aware_qp": True}, {"qp_min": 10},
    {"zones": "0,10,q=20"},
    {"hrd": True, "vbv_maxrate_kbps": 400, "vbv_bufsize_kbps": 200},
], ids=["rc_mode", "scenecut_aware_qp", "qp_min", "zones", "hrd"])
def test_rate_control_options_code_a_frame(option):
    """The rate-control keywords that raised before their slice now code
    frames: an IDR and a P frame, at the QP the option gives the IDR."""
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **option)
    res = [s.encode_frame(*f) for f in clip()[:2]]
    assert [r.frame_type for r in res] == ["I", "P"]
    assert all(r.nals for r in res)
    want = {"qp_min": 29, "zones": 20}.get(next(iter(option)))
    if want is not None:
        assert res[0].qp == want
    if "hrd" in option:
        assert s.sps.hrd == (400000, 200000, 0)


@pytest.mark.parametrize("option,exc,match", [
    # (scale_factor and analysis_share took the places of hash_type 1 and
    # 2: the CRC and checksum SEI run now; scale_factor 3, analysis_load,
    # analysis_save, cu_size 64 and analysis_share "load" / [] took the
    # places of frame_dup, dup_threshold, max_merge, tmvp, wpp and n_refs:
    # the quadtree keeps max_merge and frame_dup, drops tmvp and wpp and
    # asserts one reference, as the reference does)
    # (rqt, scale_factor and analysis_share "save" run on the quadtree
    # now: the reference asserts against analysis reuse there, and
    # against a second reference)
    pytest.param({"scale_factor": 3, "analysis_load": "b.dat"}, AE,
                 "no analysis reuse", id="option0"),
    pytest.param({"analysis_load": "b.dat"}, AE, "no analysis reuse",
                 id="option1"),
    pytest.param({"scale_factor": 2, "analysis_save": "b.dat"}, AE,
                 "no analysis reuse", id="option2"),
    # (bit_depth 10 runs now: Main10)
    # (scale_factor 4 took the place of cu_size 64: the video session's
    # quadtree codes CTU32 whatever cu_size, as the reference's does)
    pytest.param({"analysis_save": "b.dat"}, AE, "no analysis reuse",
                 id="option3"),
    pytest.param({"scale_factor": 4, "analysis_share": []}, AE,
                 "no analysis reuse", id="option4"),
    pytest.param({"analysis_share": "save", "n_refs": 2}, AE, "multi-ref",
                 id="option5"),
    pytest.param({"analysis_share": "load", "n_refs": 2}, AE, "multi-ref",
                 id="option6"),
    pytest.param({"rqt": True, "n_refs": 2}, AE, "multi-ref", id="option7"),
    pytest.param({"analysis_share": []}, AE, "no analysis reuse",
                 id="option8"),
])
def test_quadtree_options_outside_the_slice_raise(option, exc, match):
    with pytest.raises(exc, match=match):
        t_top.VideoEncoderSession(64, 48, max_depth=2, device="cpu",
                                  **option)


B_SESSION = dict(max_depth=2, bframes=3, b_adapt=0)


@pytest.mark.parametrize("option,exc,match", [
    # (the ids of the cases weightp, wpp, tmvp and max_merge had: weightp
    # and max_merge run on B sessions, which drop wpp on the quadtree and
    # tmvp, as the reference does)
    # (rqt and scale_factor run on B sessions now: their cases and the
    # analysis options' meet the reference's assertions)
    pytest.param({"analysis_load": "b.dat"}, AE, "no analysis reuse",
                 id="option0-weightp"),
    pytest.param({"rqt": True, "n_refs": 2}, AE, "multi-ref",
                 id="option1-rqt"),
    pytest.param({"scale_factor": 3, "analysis_share": []}, AE,
                 "no analysis reuse", id="option2-tmvp"),
    # (the case max_depth=0 had: the uniform 16x16 grid's B session runs
    # now, and its CTU32 grid; CTU64 is still to come)
    pytest.param({"max_depth": 0, "cu_size": 64}, NIE, "cu_size=64",
                 id="option3-max_depth=0"),
    pytest.param({"analysis_save": "b.dat"}, AE, "no analysis reuse",
                 id="option4-max_merge"),
])
def test_b_session_options_outside_the_slice_raise(option, exc, match):
    with pytest.raises(exc, match=match):
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
