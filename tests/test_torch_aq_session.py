"""Adaptive quantization and cuTree through the port's sessions and
uniform programs (CPU): the golden intra_aq2, ippp_aq_cutree and
ippp_rc_lookahead streams of the manifest (no JAX compile); the quadtree
IPPP session with AQ 2, cuTree and both filters, the quadtree intra
session with AQ 2 and both filters, and the manifest's
qt2_bframes_flagship configuration (whose blessed md5 predates the
reference's parked B-session cuTree average) against the JAX sessions'
md5s pinned here, recomputed by the slow tests; uniform sessions against
the live JAX sessions (intra AQ modes 1, 3 and 4, the intra batch, IPPP
with the filters, the rc-lookahead window with a forced IDR); the uniform
intra program with a different map per frame of a batch and the uniform
P program under a map; the option rules. The card twins (gpu-marked)
hold the streams on the card and the lookahead's K1 launches against
their plain version."""
import hashlib
import json
import os
from unittest import mock

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
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "manifest.json")
LF = dict(deblock=True, sao=True)
# (session class, keywords, how frames go in: encode_frame, push_la /
# flush_la, or push_frame / flush)
GOLDEN_AQ = {
    "intra_aq2": ("IntraEncoderSession", dict(qp=32, aq_mode=2,
                                              hash_sei=False), "frame"),
    "ippp_aq_cutree": ("VideoEncoderSession", dict(
        qp=32, cu_size=16, keyint=100, aq_mode=2, cutree=True,
        hash_sei=False), "frame"),
    "ippp_rc_lookahead": ("VideoEncoderSession", dict(
        qp=32, cu_size=16, keyint=100, cutree=True, rc_lookahead=3,
        hash_sei=False), "la"),
}
PINNED = {
    "qt2_aq_cutree_lf_sei": ("VideoEncoderSession", dict(
        qp=30, max_depth=2, keyint=100, aq_mode=2, cutree=True,
        hash_sei=True, **LF), "frame"),
    "intra_qt2_aq_lf_sei": ("IntraEncoderSession", dict(
        qp=30, max_depth=2, aq_mode=2, hash_sei=True, **LF), "frame"),
    # tests/golden_corpus.py's qt2_bframes_flagship
    "qt2_bframes_flagship": ("VideoEncoderSession", dict(
        qp=30, max_depth=2, keyint=100, bframes=3, b_pyramid=True,
        b_adapt=0, aq_mode=2, cutree=True, sbh=True, hash_sei=False, **LF),
        "push"),
}
# md5 of the JAX package's stream of each PINNED session on this tree
MD5 = {"qt2_aq_cutree_lf_sei": "795879673f782275c42823a944f8d503",
       "intra_qt2_aq_lf_sei": "33836641495f1c374bf9fbd94e7b6d2e",
       "qt2_bframes_flagship": "f9c048f1d7f69982d48dabf30d1a146f"}


def encode(top, cls, kw, how, frames=None, **extra):
    """(stream md5, results, session) of a session of the encoder_top
    module `top` over the golden clip (6 frames)."""
    s = getattr(top, cls)(64, 48, **kw, **extra)
    res = []
    for f in frames or clip():
        if how == "frame":
            res.append(s.encode_frame(*f))
        else:
            res += (s.push_la if how == "la" else s.push_frame)(*f)
    if how != "frame":
        res += s.flush_la() if how == "la" else s.flush()
    out = s.headers() + b"".join(r.nals for r in res)
    return hashlib.md5(out).hexdigest(), res, s


def _golden(name):
    with open(GOLDEN) as fh:
        return json.load(fh)[name]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


def _same_result(t, j, metrics=True):
    assert t.nals == j.nals
    assert (t.frame_type, t.qp, t.bits) == (j.frame_type, j.qp, j.bits)
    for a, b in zip(t.recon, j.recon):
        assert np.array_equal(a, b)
    if metrics:          # the JAX IPPP path fills PSNR-Y only
        assert (t.psnr_y, t.psnr_u, t.psnr_v, t.ssim_y) == \
            (j.psnr_y, j.psnr_u, j.psnr_v, j.ssim_y)


@pytest.mark.parametrize("name", sorted(GOLDEN_AQ))
def test_golden_aq_stream(name):
    md5, res, s = encode(t_top, *GOLDEN_AQ[name], device="cpu")
    assert md5 == _golden(name)
    assert s.pps.cu_qp_delta == 1 and s.stage_ms["qp_map"] > 0
    assert len(res) == 6


@pytest.mark.parametrize("name", sorted(MD5))
def test_aq_session_matches_pinned_jax_md5(name):
    md5, res, s = encode(t_top, *PINNED[name], device="cpu")
    assert md5 == MD5[name]
    if name == "qt2_bframes_flagship":
        # the B session's cuTree average is parked as in the reference:
        # it never moves, so cuTree adds no offset there
        assert not s.cutree_acc.any() and not s._cutree_offsets().any()
        assert [r.frame_type for r in res] == ["I", "P", "B", "b", "b", "P"]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(MD5))
def test_pins_recomputed_from_the_jax_session(name):
    """Where the pins come from: the JAX session of the same
    configuration (its quadtree programs compile for minutes)."""
    assert encode(j_top, *PINNED[name])[0] == MD5[name]


@pytest.mark.parametrize("mode,kw", [
    (1, dict(aq_strength=1.0)), (3, dict(aq_strength=0.8, deblock=True)),
    (4, dict(aq_strength=1.3, sbh=True, **LF))])
def test_uniform_intra_aq_modes_match_jax(mode, kw):
    """Modes 1, 3 and 4 through the intra session (chroma energies, the
    uniform deblock's per-CU branch), NAL for NAL with the recon and
    metrics."""
    kw = dict(qp=32, aq_mode=mode, hash_sei=True, **kw)
    js = j_top.IntraEncoderSession(64, 48, **kw)
    ts = t_top.IntraEncoderSession(64, 48, device="cpu", **kw)
    assert ts.headers() == js.headers()
    for f in clip():
        _same_result(ts.encode_frame(*f), js.encode_frame(*f))


def test_intra_batch_with_aq_matches_jax():
    """The reference's intra batch codes every frame at the session QP
    with no cu_qp_delta in its slices, though the PPS enables it (ROADMAP
    Queue 3); the port reproduces it."""
    kw = dict(qp=32, aq_mode=2, hash_sei=True, deblock=True)
    frames = clip()[:3]
    jb = j_top.IntraEncoderSession(64, 48, **kw).encode_batch(frames)
    ts = t_top.IntraEncoderSession(64, 48, device="cpu", **kw)
    tb = ts.encode_batch(frames)
    for t, j in zip(tb, jb):
        _same_result(t, j)
    assert tb[0].nals != ts.encode_frame(*frames[0]).nals


def test_uniform_ippp_aq_cutree_with_filters_matches_jax():
    """The uniform IPPP session with AQ 3, cuTree and both filters (the
    P frames' per-CU deblock), NAL for NAL."""
    kw = dict(qp=32, cu_size=16, keyint=4, aq_mode=3, cutree=True,
              hash_sei=True, **LF)
    js = j_top.VideoEncoderSession(64, 48, **kw)
    ts = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    for f in clip():
        _same_result(ts.encode_frame(*f), js.encode_frame(*f), False)


def test_rc_lookahead_window_with_a_forced_idr_matches_jax():
    """push_la / flush_la with rc_lookahead 2, AQ 1 and a forced IDR set
    before the third push: the IDR lands on the third frame when it
    leaves the window, as in the reference."""
    kw = dict(qp=32, cu_size=16, keyint=100, aq_mode=1, cutree=True,
              rc_lookahead=2, hash_sei=True)
    js = j_top.VideoEncoderSession(64, 48, **kw)
    ts = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    jr, tr = [], []
    for i, f in enumerate(clip()):
        if i == 2:
            js.intra_refresh()
            ts.intra_refresh()
        jr += js.push_la(*f)
        tr += ts.push_la(*f)
        assert len(tr) == len(jr) == max(0, i - 1)
    jr += js.flush_la()
    tr += ts.flush_la()
    assert [r.frame_type for r in tr] == ["I", "P", "I", "P", "P", "P"]
    for t, j in zip(tr, jr):
        _same_result(t, j, False)


def test_uniform_intra_batch_with_a_map_per_frame_matches_jax():
    """The uniform intra program over a batch of 3 frames, each at its own
    per-CU QP map, against the JAX frame batch (submit_frames)."""
    frames = clip(64, 48, n=3, seed=9)
    rng = np.random.default_rng(4)
    maps = rng.integers(24, 40, (3, 12)).astype(np.int32)
    ys, us, vs = (np.stack(p) for p in zip(*frames))
    je = IntraFrameEncoder(IntraFrameConfig(width=64, height=48, cu_size=16,
                                            qp=32))
    jo = je.collect_frames(je.submit_frames(ys, us, vs, qp=maps),
                           rerun_inputs=(ys, us, vs, maps))
    to = t_intra.IntraFrameEncoder(64, 48, 16, "cpu").encode_frames(
        *zip(*frames), list(maps))
    for j, t in zip(jo, to):
        assert set(j) == set(t)
        for k in j:
            assert np.array_equal(np.asarray(j[k]), t[k]), k
    assert not np.array_equal(to[0]["levels_y"], to[1]["levels_y"])


def test_uniform_p_program_with_a_qp_map_matches_jax():
    f0, f1 = clip(64, 48, n=2, seed=5)
    ref = IntraFrameEncoder(IntraFrameConfig(width=64, height=48, cu_size=16,
                                             qp=29)).encode_frame(*f0, qp=29)
    refs = (ref["recon_y"], ref["recon_u"], ref["recon_v"])
    qmap = np.random.default_rng(8).integers(26, 40, 12).astype(np.int32)
    jo = InterFrameEncoder(InterFrameConfig(width=64, height=48, cu_size=16,
                                            qp=32)).encode_frame(
        *f1, *refs, qp=qmap)
    to = t_inter.InterFrameEncoder(64, 48, 16, "cpu").encode_frame(
        *f1, *refs, qmap.reshape(3, 4))
    assert set(jo) == set(to)
    for k, v in jo.items():
        if v is None:
            assert to[k] is None, k
        else:
            assert np.array_equal(np.asarray(v), to[k]), k


def test_rc_lookahead_with_bframes_names_its_slice():
    """A B session with cuTree takes the rc-lookahead window inside
    push_frame (the b-adapt slice added it; tests/test_torch_badapt.py
    holds its stream to the JAX session's); encode_frame and push_la stay
    the IPPP session's."""
    s = t_top.VideoEncoderSession(64, 48, device="cpu", max_depth=2,
                                  bframes=3, b_adapt=0, cutree=True,
                                  rc_lookahead=3)
    assert s.la_depth == 3
    assert s.push_frame(*clip(64, 48, n=1)[0]) == [] and len(s.la_queue) == 1
    with pytest.raises(RuntimeError, match="push_frame"):
        s.encode_frame(*clip(64, 48, n=1)[0])
    # without cuTree the window is off, as in the reference
    s = t_top.VideoEncoderSession(64, 48, device="cpu", rc_lookahead=3)
    assert s.la_depth == 0 and not s.pps.cu_qp_delta
    with pytest.raises(RuntimeError, match="rc_lookahead"):
        s.push_la(*clip(64, 48, n=1)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GOLDEN_AQ))
def test_golden_aq_stream_on_the_card(name):
    _need_card()
    assert encode(t_top, *GOLDEN_AQ[name])[0] == _golden(name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MD5))
def test_pinned_aq_session_on_the_card(name):
    _need_card()
    assert encode(t_top, *PINNED[name])[0] == MD5[name]


@pytest.mark.gpu
def test_lookahead_k1_feeds_cutree_as_its_plain_version():
    """The lookahead's fused K1 launches on the card give cuTree the same
    per-block costs and MVs (last_detail) as K1's plain version."""
    _need_card()
    from x265_yuuki_asuna_tpu_torch.models.lookahead import Lookahead
    kernel = me_sad.sad_sweep_best
    frames = [f[0] for f in clip(416, 240, n=3)]
    details = []
    for fn in (kernel, me_sad.sad_sweep_best_plain):
        la, got = Lookahead(416, 240, "cuda"), []
        n0 = kernel.launches
        with mock.patch.object(me_sad, "sad_sweep_best", fn):
            for y in frames:
                la.push(y)
                got.append(la.last_detail)
        assert kernel.launches - n0 == (len(frames) if fn is kernel else 0)
        details.append(got)
    for a, b in zip(*details):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
