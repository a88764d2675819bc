"""Rate control through the port's sessions against the JAX sessions
(CPU): the uniform IPPP path at 64x48 under CRF, ABR, ABR + VBV + HRD
(with VBV re-encodes), zones, scene-cut-aware QP, qp_min / qp_max, CRF
with AQ + cuTree + the rc-lookahead window, and two-pass (the pass-1
stats and sidecar byte for byte, the pass-2 stream); each stream and
every frame's QP equal. The quadtree B session with the flagship's tools
under CRF 28 and under ABR, and under CQP + VBV (which the JAX session
pipelines), against the JAX md5s pinned here, recomputed by the slow
tests; the card twins (gpu-marked) hold the same pins on the card."""
import hashlib
import os

import numpy as np
import pytest
import torch

from golden_corpus import clip
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top

torch.set_num_threads(2)

UNI = dict(qp=32, cu_size=16, keyint=100, hash_sei=False)
VBV_HRD = dict(rc_mode="abr", bitrate_kbps=200, vbv_maxrate_kbps=100,
               vbv_bufsize_kbps=6, hrd=True, hash_sei=True)
# uniform IPPP sessions: (keywords, how frames go in)
IPPP = {
    "crf28": (dict(UNI, rc_mode="crf", crf=28.0), "frame"),
    "abr300": (dict(UNI, rc_mode="abr", bitrate_kbps=300), "frame"),
    "zones_crf": (dict(UNI, rc_mode="crf", crf=30.0,
                       zones="1,2,q=20/3,4,b=0.5"), "frame"),
    "crf_qp_range": (dict(UNI, rc_mode="crf", crf=24.0, qp_min=30,
                          qp_max=33), "frame"),
    "crf_aq_cutree_la": (dict(UNI, rc_mode="crf", crf=28.0, aq_mode=2,
                              cutree=True, rc_lookahead=3), "la"),
}
# the quadtree B session: tests/golden_corpus.py's qt2_bframes_flagship
# configuration (8 frames: the IDR and two mini-GOPs) under rate control
FLAG = dict(qp=30, max_depth=2, keyint=100, bframes=3, b_pyramid=True,
            b_adapt=0, aq_mode=2, cutree=True, sbh=True, hash_sei=False,
            deblock=True, sao=True)
B_PINNED = {"flagship_crf28": dict(FLAG, rc_mode="crf", crf=28.0),
            "flagship_abr150": dict(FLAG, rc_mode="abr", bitrate_kbps=150),
            "flagship_cqp_vbv": dict(FLAG, vbv_maxrate_kbps=20,
                                     vbv_bufsize_kbps=10)}
# md5 of the JAX package's stream of each B_PINNED session, and its QPs
# in coding order
B_MD5 = {"flagship_crf28": "58a9fea10900601709701be6a60ecdcf",
         "flagship_abr150": "9c2dfce1699e8658d8758f970acf85d2",
         "flagship_cqp_vbv": "e80b573bc27e2a797d61a31522e4b956"}
B_QPS = {"flagship_crf28": [25, 35, 39, 39, 38, 36, 37, 38],
         "flagship_abr150": [34, 37, 31, 31, 28, 25, 26, 25],
         "flagship_cqp_vbv": [27, 37, 38, 39, 39, 30, 31, 32]}


# the first JAX uniform session's I and P frame encoders and lookahead
# program; the others (same 64x48 geometry and program configuration)
# reuse them compiled
_JAX_UNIFORM = []


def _share_jax_programs(s):
    if not _JAX_UNIFORM:
        _JAX_UNIFORM.append(s)
    first = _JAX_UNIFORM[0]
    s.inter_encoder = first.inter_encoder
    s.intra_sess.frame_encoder = first.intra_sess.frame_encoder
    s.lookahead._fn = first.lookahead._fn


def run(top, kw, how="frame", frames=None, w=64, h=48, **extra):
    """(stream, results, session) of a video session of the encoder_top
    module `top` over the golden clip (or `frames`)."""
    s = top.VideoEncoderSession(w, h, **kw, **extra)
    if top is j_top and not kw.get("max_depth"):
        _share_jax_programs(s)
    res = []
    for f in frames or clip():
        if how == "frame":
            res.append(s.encode_frame(*f))
        else:
            res += (s.push_la if how == "la" else s.push_frame)(*f)
    if how != "frame":
        res += s.flush_la() if how == "la" else s.flush()
    return s.headers() + b"".join(r.nals for r in res), res, s


def _same(t, j):
    """The same stream and, frame for frame, NALs, type and QP."""
    assert t[0] == j[0]
    assert [(r.nals, r.frame_type, r.qp) for r in t[1]] == \
        [(r.nals, r.frame_type, r.qp) for r in j[1]]


@pytest.mark.parametrize("name", sorted(IPPP))
def test_uniform_rc_session_matches_jax(name):
    kw, how = IPPP[name]
    t = run(t_top, kw, how, device="cpu")
    _same(t, run(j_top, kw, how))
    qps = [r.qp for r in t[1]]
    if name == "zones_crf":
        assert qps[1:3] == [20, 20]
    if name == "crf_qp_range":
        assert min(qps) >= 30 and max(qps) <= 33
    assert len(set(qps)) > 1 or name == "crf_qp_range"


def _spy_overshoot(sess):
    """Record each vbv_overshoot of the session's rate control."""
    seen, orig = [], sess.rc.vbv_overshoot
    sess.rc.vbv_overshoot = lambda bits: seen.append(orig(bits)) \
        or seen[-1]
    return seen


def _provider(didx):
    """Prefix bytes naming the display index (a stand-in prefix NAL)."""
    return bytes([0, 0, 1, 0x4e, 1, didx])


def test_abr_vbv_hrd_reencodes_as_jax():
    """ABR + VBV with a buffer that binds, HRD, the hash SEI and a
    sei_provider: the JAX session codes frames again (up to twice) at a
    higher QP; the port does the same, and like the reference drops the
    HRD SEI and the provider's bytes of a re-coded frame."""
    got = []
    for top, extra in ((j_top, {}), (t_top, {"device": "cpu"})):
        s = top.VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                                    **VBV_HRD, **extra)
        if top is j_top:
            _share_jax_programs(s)
        s.sei_provider = _provider
        seen = _spy_overshoot(s)
        res = [s.encode_frame(*f) for f in clip()]
        got.append(((s.headers() + b"".join(r.nals for r in res)),
                    [(r.nals, r.qp) for r in res], seen))
        if top is t_top:
            assert s.sps.hrd == (100000, 6000, 0)
    assert got[1] == got[0]
    assert sum(o > 1.08 for o in got[1][2]) == 5
    # frames coded once start with the provider's bytes, then the HRD SEI;
    # the re-coded ones with their slice
    prefixed = [n.startswith(_provider(i)) for i, (n, _) in
                enumerate(got[1][1])]
    assert any(prefixed) and not all(prefixed)


def test_scenecut_aware_qp_matches_jax():
    """The tests/test_scenecut_aware_qp.py clip (a cut at frame 2), with
    keyint 20 so the cut is an IDR: the window restarts at frame 0 and at
    the cut."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 80, (48, 64)).astype(np.uint8)
    b = rng.integers(150, 256, (48, 64)).astype(np.uint8)
    u = np.full((24, 32), 128, np.uint8)
    frames = [(a, u, u)] * 2 + [(b, u, u)] * 8
    kw = dict(UNI, keyint=20, rc_mode="crf", crf=28.0,
              scenecut_aware_qp=True, scenecut_qp_delta=6,
              scenecut_window=6)
    t = run(t_top, kw, frames=frames, device="cpu")
    _same(t, run(j_top, kw, frames=frames))
    assert [r.frame_type for r in t[1]][:3] == ["I", "P", "I"]
    assert t[2]._since_scenecut == 7


def test_two_pass_matches_jax(tmp_path):
    """Pass 1 (ABR with cuTree) writes the same stats file and .cutree
    sidecar as the JAX session; pass 2 reads it (a QP map on every frame)
    and codes the JAX pass 2's stream."""
    kw = dict(UNI, keyint=4, rc_mode="abr", bitrate_kbps=300)
    paths = {}
    for top, tag, extra in ((j_top, "j", {}), (t_top, "t", {"device": "cpu"})):
        paths[tag] = str(tmp_path / f"{tag}.log")
        s = run(top, dict(kw, cutree=True, stats_write=paths[tag]),
                **extra)[2]
        s.stats_writer.close()
    for suffix in ("", ".cutree"):
        with open(paths["j"] + suffix, "rb") as fj, \
                open(paths["t"] + suffix, "rb") as ft:
            assert ft.read() == fj.read(), suffix
    t = run(t_top, dict(kw, stats_read=paths["t"]), device="cpu")
    _same(t, run(j_top, dict(kw, stats_read=paths["j"])))
    assert t[2].pps.cu_qp_delta == 1 and t[2]._tp_delta_on
    assert os.path.getsize(paths["t"] + ".cutree") > 0


@pytest.mark.parametrize("name", sorted(B_MD5))
def test_b_session_rc_matches_pinned_jax_md5(name):
    stream, res, s = run(t_top, B_PINNED[name], "push", clip(n=8),
                         device="cpu")
    assert hashlib.md5(stream).hexdigest() == B_MD5[name]
    assert [r.qp for r in res] == B_QPS[name]
    assert [r.frame_type for r in res] == ["I", "P", "B", "b", "b", "P",
                                           "B", "b"]
    assert s.stage_ms["rc"] > 0


def test_cqp_vbv_b_session_takes_its_qps_at_submit():
    """Under CQP + VBV the reference takes a mini-GOP's QPs before any of
    its frames is fed back; fed back one by one, the QPs would differ."""
    kw = B_PINNED["flagship_cqp_vbv"]
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    s.two_pass = "in order"      # any pass 2 turns the submit order off
    res = []
    for f in clip(n=5):          # the IDR and the first mini-GOP
        res += s.push_frame(*f)
    res += s.flush()
    assert [r.qp for r in res] != B_QPS["flagship_cqp_vbv"][:5]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(B_MD5))
def test_b_pins_recomputed_from_the_jax_session(name):
    """Where the pins come from: the JAX session of the same
    configuration (its quadtree programs compile for minutes)."""
    stream, res, _ = run(j_top, B_PINNED[name], "push", clip(n=8))
    assert hashlib.md5(stream).hexdigest() == B_MD5[name]
    assert [r.qp for r in res] == B_QPS[name]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(B_MD5))
def test_b_session_rc_pin_on_the_card(name):
    _need_card()
    stream, res, _ = run(t_top, B_PINNED[name], "push", clip(n=8))
    assert hashlib.md5(stream).hexdigest() == B_MD5[name]
    assert [r.qp for r in res] == B_QPS[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(IPPP))
def test_uniform_rc_session_card_equals_cpu(name):
    _need_card()
    kw, how = IPPP[name]
    _same(run(t_top, kw, how), run(t_top, kw, how, device="cpu"))


def test_sei_provider_prefixes_each_b_frame():
    """On the B path sei_provider's bytes go before each frame's slice,
    by display index (the IDR and a mini-GOP)."""
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **dict(
        B_PINNED["flagship_crf28"]))
    s.sei_provider = _provider
    res = []
    for f in clip(n=5):
        res += s.push_frame(*f)
    res += s.flush()
    assert [r.poc for r in res] == [0, 4, 2, 1, 3]
    assert all(r.nals.startswith(_provider(r.poc)) for r in res)
