"""The port's all-intra session against the JAX package's (CPU): the five
golden intra streams of the manifest (no JAX compile), a sign-hiding
session NAL for NAL with its recon and quality metrics, a frame batch
with deblock and SAO (the reference's batches deblock but code SAO off)
and each batched frame against its single-frame encode, the headers with
the mastering-display and content-light-level SEI, the quadtree intra
session with sign hiding and the filters (and with RDOQ) against the JAX
md5s pinned here (recomputed from the JAX session by the slow tests), and
every keyword of the two JAX session constructors: the port runs it or
names the slice that adds it. The card twins (gpu-marked) hold the golden
streams on the card."""
import hashlib
import inspect
import json
import os

import numpy as np
import pytest
import torch

from golden_corpus import clip
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "manifest.json")
# the manifest's intra configurations the port codes (golden_corpus.py)
GOLDEN_INTRA = {
    "intra_cqp_ctu16": dict(qp=32, hash_sei=False),
    "intra_qp26_deblock": dict(qp=26, deblock=True, hash_sei=False),
    "intra_sao": dict(qp=32, sao=True, hash_sei=False),
    "intra_sbh": dict(qp=32, sbh=True, hash_sei=False),
    "intra_rdoq": dict(qp=32, rdoq=True, hash_sei=False),
}
LF = dict(deblock=True, sao=True)
# quadtree intra sessions over the golden clip, hash SEI on (every recon
# held), and the md5 of the JAX package's stream of each
PINNED = {
    "qt2_sbh_lf_sei": dict(qp=30, max_depth=2, sbh=True, hash_sei=True,
                           **LF),
    "qt2_rdoq_sei": dict(qp=30, max_depth=2, rdoq=True, hash_sei=True),
    "rdoq_psy_lf_sei": dict(qp=30, rdoq=True, psy_rdoq=1.0, hash_sei=True,
                            **LF),
}
MD5 = {"qt2_sbh_lf_sei": "250afb785a78a94b42d0296bdc099eab",
       "qt2_rdoq_sei": "3329442fee0e8f60fc75de24bdea4c3b",
       "rdoq_psy_lf_sei": "1ccc0593fdf84cc5d4dc0d1971e5fa73"}
MASTER = "G(13250,34500)B(7500,3000)R(34000,16000)WP(15635,16450)" \
    "L(10000000,1)"


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def encode(top, kw, frames=None, **extra):
    """(stream md5, results) of an intra session of the encoder_top
    module `top` over the golden clip."""
    s = top.IntraEncoderSession(64, 48, **kw, **extra)
    res = [s.encode_frame(*f) for f in (frames or clip())]
    out = s.headers() + b"".join(r.nals for r in res)
    return hashlib.md5(out).hexdigest(), res


def _golden(name):
    with open(GOLDEN) as fh:
        return json.load(fh)[name]


@pytest.mark.parametrize("name", sorted(GOLDEN_INTRA))
def test_golden_intra_stream(name):
    assert encode(t_top, GOLDEN_INTRA[name], device="cpu")[0] == \
        _golden(name)


def _same_result(t, j):
    assert t.nals == j.nals
    assert (t.frame_type, t.qp, t.bits) == (j.frame_type, j.qp, j.bits)
    for a, b in zip(t.recon, j.recon):
        assert np.array_equal(a, b)
    # the quality metrics, float for float
    assert (t.psnr_y, t.psnr_u, t.psnr_v, t.ssim_y) == \
        (j.psnr_y, j.psnr_u, j.psnr_v, j.ssim_y)


def test_sbh_session_matches_jax_nal_for_nal():
    kw = dict(qp=32, sbh=True, hash_sei=True)
    js = j_top.IntraEncoderSession(64, 48, **kw)
    ts = t_top.IntraEncoderSession(64, 48, device="cpu", **kw)
    assert ts.headers() == js.headers()
    for f in clip():
        _same_result(ts.encode_frame(*f), js.encode_frame(*f))


def test_batch_with_filters_matches_jax():
    """encode_batch with deblock and SAO: the reference's batch deblocks
    but never runs SAO, so its slices code SAO off (unlike encode_frame);
    the port reproduces it, frame for frame."""
    kw = dict(qp=32, hash_sei=True, **LF)
    frames = clip()[:3]
    js = j_top.IntraEncoderSession(64, 48, **kw)
    ts = t_top.IntraEncoderSession(64, 48, device="cpu", **kw)
    jb, tb = js.encode_batch(frames), ts.encode_batch(frames)
    for t, j in zip(tb, jb):
        _same_result(t, j)
    single = t_top.IntraEncoderSession(64, 48, device="cpu", **kw)
    assert tb[0].nals != single.encode_frame(*frames[0]).nals


def test_batched_frames_decide_as_single_frames():
    """A batch of 3 through the frame-batched wavefront (RDOQ on, so the
    float32 costs are batched too) against 3 single-frame encodes."""
    enc = t_top.IntraEncoderSession(64, 48, rdoq=True, psy_rdoq=1.0,
                                    device="cpu").frame_encoder
    frames = clip(64, 48, n=3, seed=11)        # 64x48: the coded size
    batch = enc.encode_frames(*zip(*frames), 30)
    for f, b in zip(frames, batch):
        one = enc.encode_frame(*f, 30)
        assert set(one) == set(b)
        for k in one:
            assert np.array_equal(one[k], b[k]), k


def test_batch_without_recon_returns_none():
    s = t_top.IntraEncoderSession(64, 48, hash_sei=False, device="cpu")
    res = s.encode_batch(clip()[:2])
    assert all(r.recon is None and r.psnr_y == 0.0 for r in res)
    assert len(s.encode_batch(clip()[:1], need_recon=True)[0].recon) == 3


def test_headers_with_master_display_and_max_cll():
    for kw in (dict(master_display=MASTER, max_cll="1000,400"),
               dict(master_display=MASTER, info_sei=False),
               dict(max_cll="not,numbers", info_sei=False),
               dict(info_sei=False)):
        assert t_top.IntraEncoderSession(64, 48, device="cpu", **kw) \
            .headers() == j_top.IntraEncoderSession(64, 48, **kw).headers()


def test_frame_quality_matches_jax():
    rng = np.random.default_rng(2)
    y, u, v = clip(72, 40, n=1)[0]
    rec = tuple(np.clip(p.astype(np.int32) + rng.integers(-6, 7, p.shape),
                        0, 255).astype(np.uint8) for p in (y, u, v))
    assert t_top.frame_quality(rec, y, u, v) == \
        j_top.frame_quality(rec, y, u, v)
    assert t_top.frame_quality((y, u, v), y, u, v)[:3] == (99.99,) * 3


def test_sei_provider_prefixes_each_slice():
    s = t_top.IntraEncoderSession(64, 48, hash_sei=False, device="cpu")
    plain = s.encode_frame(*clip()[0]).nals
    s.sei_provider = lambda i: bytes([0, 0, 1, 0x4e, 1, i])
    for i, f in enumerate(clip()[:2]):
        assert s.encode_frame(*f).nals[:6] == bytes([0, 0, 1, 0x4e, 1,
                                                     i + 1])
    assert len(plain) > 0


@pytest.mark.parametrize("name", sorted(MD5))
def test_intra_session_matches_pinned_jax_md5(name):
    md5, res = encode(t_top, PINNED[name], device="cpu")
    assert md5 == MD5[name]
    assert all(np.isfinite(r.ssim_y) and r.psnr_u > 0 for r in res)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(MD5))
def test_intra_pins_recomputed_from_the_jax_session(name):
    """Where the pins come from: the JAX intra session of the same
    configuration (its quadtree program compiles for 1-2 minutes)."""
    assert encode(j_top, PINNED[name])[0] == MD5[name]


# ---------------------------------------------------------------------------
# every keyword of both JAX constructors
# ---------------------------------------------------------------------------

# a value other than the default, where the generic choice would not do
NON_DEFAULT = {"cu_size": 32, "fps": (30, 1), "max_depth": 2,
               "master_display": MASTER, "max_cll": "1000,400",
               "csp": "i444", "scaling_lists": "default", "zones": "0,5,q=20",
               "rc_mode": "crf", "analysis_share": "save", "b_adapt": 0,
               "stats_write": "stats.log", "stats_read": "stats.log",
               "analysis_save": "analysis.dat", "analysis_load": "a.dat",
               "bit_depth": 10}


def _non_default(p: inspect.Parameter):
    if p.name in NON_DEFAULT:
        return NON_DEFAULT[p.name]
    d = p.default
    if isinstance(d, bool) or d is None:
        return not d
    if isinstance(d, (int, float)):
        return d + 1
    raise AssertionError(p.name)


def _keywords(cls):
    return [(cls.__name__, p) for p in
            inspect.signature(cls.__init__).parameters.values()
            if p.name not in ("self", "width", "height")]


@pytest.mark.parametrize("cls,param", _keywords(
    j_top.VideoEncoderSession) + _keywords(j_top.IntraEncoderSession),
    ids=lambda x: x if isinstance(x, str) else x.name)
def test_every_jax_keyword_runs_or_names_its_slice(cls, param, tmp_path):
    """A non-default value of each keyword either codes a frame in the
    port or raises NotImplementedError naming the slice that adds it;
    never TypeError. The stats and analysis files live in a temporary
    directory; pass 2 reads a pass-1 file the port wrote there, and
    analysis_load a record file."""
    val = _non_default(param)
    assert val != param.default
    if param.name in ("stats_write", "stats_read", "analysis_save",
                      "analysis_load"):
        val = str(tmp_path / val)
    if param.name == "stats_read":
        p1 = t_top.VideoEncoderSession(64, 48, device="cpu",
                                       stats_write=val)
        p1.encode_frame(*clip(64, 48, n=1)[0])
        p1.stats_writer.close()
    if param.name == "analysis_load":
        p1 = t_top.VideoEncoderSession(64, 48, device="cpu",
                                       analysis_save=val)
        p1.encode_frame(*clip(64, 48, n=1)[0])
        p1.analysis_save.close()
    top = getattr(t_top, cls)
    try:
        s = top(64, 48, device="cpu", **{param.name: val})
    except NotImplementedError as e:
        assert "slice" in str(e), str(e)
        return
    f = clip(64, 48, n=1)[0]
    if param.name == "csp":              # 4:4:4: chroma at luma size
        f = (f[0],) + tuple(p.repeat(2, 0).repeat(2, 1) for p in f[1:])
    if getattr(s, "bframes", 0):
        res = s.push_frame(*f) + s.flush()
    else:
        res = [s.encode_frame(*f)]
    assert res and res[0].nals


def test_unknown_keyword_is_a_type_error():
    for top in (t_top.VideoEncoderSession, t_top.IntraEncoderSession):
        with pytest.raises(TypeError):
            top(64, 48, device="cpu", no_such_option=1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GOLDEN_INTRA))
def test_golden_intra_stream_on_the_card(name):
    _need_card()
    assert encode(t_top, GOLDEN_INTRA[name])[0] == _golden(name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MD5))
def test_pinned_intra_session_on_the_card(name):
    _need_card()
    assert encode(t_top, PINNED[name])[0] == MD5[name]
