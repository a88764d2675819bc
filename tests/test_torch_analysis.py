"""Analysis reuse in the port against the JAX package (CPU, exact): the
video session's analysis_save / analysis_load / analysis_share and
scale_factor, scale_analysis_rec, the library's set_analysis_data and
the command line's --analysis-save / --analysis-load.

The two passes of tests/test_analysis_reuse.py and of
tests/test_scale_factor.py run in both packages at those tests' shapes:
the streams and the pickled record files are byte for byte the JAX
session's (and the pins of tools_pins, which chip_smoke.py holds on the
card). A loaded P frame refines its hints and runs no integer search;
the reference's rules hold (the uniform IPPP path only: the quadtree and
two references assert, a B session's P anchors fail; weighted P frames
ignore the hints)."""
import os
import pickle

import numpy as np
import pytest
import torch

import tools_pins as TP
from x265_yuuki_asuna_tpu import cli as j_cli
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.ops import scaler as j_scaler
from x265_yuuki_asuna_tpu.utils import io as j_io
from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
from x265_yuuki_asuna_tpu_torch import api as t_api
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.ops import me as t_me
from x265_yuuki_asuna_tpu_torch.ops import scaler as t_scaler
from x265_yuuki_asuna_tpu_torch.utils import io as t_io

torch.set_num_threads(2)

def _dirs(tmp_path):
    out = []
    for tag in ("jax", "port"):
        os.makedirs(tmp_path / tag)
        out.append(str(tmp_path / tag))
    return out


def test_save_load_matches_jax(tmp_path):
    """Pass 1 saves, pass 2 loads: both streams and the record file equal
    the JAX session's and the pins."""
    dj, dp = _dirs(tmp_path)
    want = TP.run_analysis(j_top, dj)
    assert TP.run_analysis(t_top, dp, device="cpu") == want == \
        TP.ANALYSIS_PINS
    with open(os.path.join(dp, "analysis.dat"), "rb") as f:
        first = pickle.load(f)
        second = pickle.load(f)
    assert first == {"t": "I"} and second["t"] == "P"
    assert second["mvx"].dtype == np.int32 and second["mvx"].shape == (3, 4)


def test_scale_factor_matches_jax(tmp_path):
    """Pass 1 at half size (the clip scaled by each package's scaler),
    pass 2 at full size with scale_factor 2: streams and records equal the
    JAX session's and the pins."""
    dj, dp = _dirs(tmp_path)
    want = TP.run_scale_factor(j_top, j_scaler.resize_plane, dj)
    got = TP.run_scale_factor(
        t_top, lambda p, h, w: t_scaler.resize_plane(p, h, w).numpy(), dp,
        device="cpu")
    assert got == want == TP.SCALE_PINS


def test_scale_analysis_rec_matches_jax():
    """Records scaled by 2 and 4 onto grids that crop and that pad (from
    the edge), an I record untouched."""
    rng = np.random.default_rng(2)
    rec = {"t": "P", "mvx": rng.integers(-64, 64, (3, 5)).astype(np.int32),
           "mvy": rng.integers(-64, 64, (3, 5)).astype(np.int32)}
    for sf, rows, cols in ((2, 6, 10), (2, 5, 9), (2, 7, 11), (4, 13, 19),
                           (4, 12, 20)):
        a = j_top.scale_analysis_rec(rec, sf, rows, cols)
        b = t_top.scale_analysis_rec(rec, sf, rows, cols)
        assert a.keys() == b.keys() and a["t"] == b["t"]
        for k in ("mvx", "mvy"):
            assert b[k].dtype == np.int32 and np.array_equal(a[k], b[k])
    assert t_top.scale_analysis_rec({"t": "I"}, 2, 4, 4) == {"t": "I"}


def test_loaded_p_frames_run_no_search(tmp_path, monkeypatch):
    """A loaded session's P frames refine their hints: the integer full
    search (K1's sweep on the card) is never called; the saving pass
    calls it once a P frame. The lookahead's sweeps run either way."""
    frames = TP.moving_scene(64, 48, 4)
    dat = str(tmp_path / "a.dat")
    calls = []
    search = t_me.full_search_sad
    monkeypatch.setattr(t_me, "full_search_sad",
                        lambda *a, **k: calls.append(1) or search(*a, **k))
    s1 = t_top.VideoEncoderSession(64, 48, analysis_save=dat, device="cpu",
                                   **TP.ANALYSIS_KW)
    for f in frames:
        s1.encode_frame(*f)
    s1.analysis_save.close()
    assert len(calls) == 3
    s2 = t_top.VideoEncoderSession(64, 48, analysis_load=dat, device="cpu",
                                   **TP.ANALYSIS_KW)
    res = [s2.encode_frame(*f) for f in frames]
    assert len(calls) == 3 and s2.analysis_idx == 4
    stream = s2.headers() + b"".join(r.nals for r in res)
    dec = decode_hevc(stream, 64, 48)
    assert len(dec) == 4 and all(np.array_equal(d[p].astype(np.uint8),
                                                r.recon[p])
                                 for d, r in zip(dec, res)
                                 for p in range(3))


def test_shared_list_is_read_as_it_grows():
    """analysis_share=[]: the session reads the caller's list object,
    records appended after it was made included; "save" keeps the
    session's own records."""
    frames = TP.moving_scene(64, 48, 3)
    donor = t_top.VideoEncoderSession(64, 48, analysis_share="save",
                                      device="cpu", **TP.ANALYSIS_KW)
    feed = []
    user = t_top.VideoEncoderSession(64, 48, analysis_share=feed,
                                     device="cpu", **TP.ANALYSIS_KW)
    assert user.analysis_data is feed and user.hinted
    got = []
    for f in frames:
        donor.encode_frame(*f)
        feed.append(donor.shared_analysis[-1])
        got.append(user.encode_frame(*f).nals)
    assert [r["t"] for r in donor.shared_analysis] == ["I", "P", "P"]
    # the same records from a file code the same stream
    frames_md5 = TP.md5(b"".join(got))
    loaded = t_top.VideoEncoderSession(64, 48, device="cpu",
                                       analysis_share=list(feed),
                                       **TP.ANALYSIS_KW)
    assert TP.md5(b"".join(loaded.encode_frame(*f).nals
                           for f in frames)) == frames_md5


def test_set_analysis_data():
    """The library's set_analysis_data: 0 and the records in place (the
    index back at 0) on a video encoder, -1 on the all-intra one; as in
    the reference, the library's sessions build no hinted program, so
    the stream is the one without records."""
    frames = TP.moving_scene(64, 48, 3)

    def run(api, p, recs):
        enc = api.encoder_open(p, device="cpu") if api is t_api else \
            api.encoder_open(p)
        stream = api.encoder_headers(enc)
        for i, f in enumerate(frames + [None]):
            if i == 1 and recs is not None:
                assert api.set_analysis_data(enc, recs) == 0
                assert enc._sess.analysis_data is recs
                assert enc._sess.analysis_idx == 0
            pic = None
            if f is not None:
                pic = api.picture_init(p, api.picture_alloc())
                pic.planes = f
            stream += b"".join(api.encoder_encode(enc, pic))
        return TP.md5(stream)

    def param(api):
        p = api.param_default_preset("ultrafast")
        for k, v in (("input-res", "64x48"), ("bframes", "0"),
                     ("ctu", "16"), ("min-cu-size", "16"),
                     ("weightp", "0")):
            api.param_parse(p, k, v)
        return p
    recs = [{"t": "I"}] + [{"t": "P", "mvx": np.full((3, 4), 8, np.int32),
                            "mvy": np.zeros((3, 4), np.int32)}]
    assert run(t_api, param(t_api), recs) == run(t_api, param(t_api), None)
    p = param(t_api)
    t_api.param_parse(p, "keyint", "1")
    t_api.param_parse(p, "qp", "32")
    intra = t_api.encoder_open(p, device="cpu")
    assert not intra._video
    assert t_api.set_analysis_data(intra, recs) == -1


def test_set_records_steer_a_hinted_session(tmp_path):
    """On a session made with analysis_share=[] (a hinted program), the
    records handed in later steer the search: the stream equals the one
    loaded from a file of the same records."""
    frames = TP.moving_scene(64, 48, 4)
    dat = str(tmp_path / "a.dat")
    s1 = t_top.VideoEncoderSession(64, 48, analysis_save=dat, device="cpu",
                                   **TP.ANALYSIS_KW)
    for f in frames:
        s1.encode_frame(*f)
    s1.analysis_save.close()
    recs = t_top.read_analysis(dat)
    s2 = t_top.VideoEncoderSession(64, 48, analysis_share=[], device="cpu",
                                   **TP.ANALYSIS_KW)
    s2.analysis_data, s2.analysis_idx = recs, 0
    s3 = t_top.VideoEncoderSession(64, 48, analysis_load=dat, device="cpu",
                                   **TP.ANALYSIS_KW)
    a = b"".join(s2.encode_frame(*f).nals for f in frames)
    b = b"".join(s3.encode_frame(*f).nals for f in frames)
    assert a == b


@pytest.mark.parametrize("opts,exc,match", [
    (dict(max_depth=2, analysis_save="x.dat"), AssertionError,
     "no analysis reuse"),
    (dict(max_depth=1, analysis_load="x.dat"), AssertionError,
     "no analysis reuse"),
    (dict(max_depth=2, analysis_share=[]), AssertionError,
     "no analysis reuse"),
    (dict(n_refs=2, analysis_share="save"), AssertionError, "multi-ref"),
    (dict(n_refs=2, analysis_load="x.dat"), AssertionError, "multi-ref")])
def test_reference_assertions(tmp_path, opts, exc, match):
    """Where the reference asserts, the port raises with its reason,
    before any file is opened."""
    with pytest.raises(exc, match=match):
        t_top.VideoEncoderSession(64, 48, device="cpu", **opts)
    assert not os.path.exists("x.dat")


def test_b_session_p_anchor_fails_with_hints(tmp_path):
    """A uniform B session made with records builds the hinted P program,
    and its P anchors give it no hints: ValueError at the first one, as
    the reference fails there (ROADMAP Queue 3). Saving codes no record:
    the reference writes them from encode_frame only."""
    frames = TP.moving_scene(64, 48, 5)
    s = t_top.VideoEncoderSession(64, 48, bframes=2, b_adapt=0,
                                  analysis_share=[{"t": "I"}], device="cpu",
                                  **TP.ANALYSIS_KW)
    with pytest.raises(ValueError, match="hints"):
        for f in frames:
            s.push_frame(*f)
    dat = str(tmp_path / "b.dat")
    s = t_top.VideoEncoderSession(64, 48, bframes=2, b_adapt=0,
                                  analysis_save=dat, device="cpu",
                                  **TP.ANALYSIS_KW)
    for f in frames:
        s.push_frame(*f)
    s.flush()
    s.analysis_save.close()
    assert os.path.getsize(dat) == 0


def test_weighted_p_frames_ignore_the_hints(tmp_path):
    """Under weightp the reference's P program takes no hints: a loaded
    weighted session codes the stream of the weighted session without
    records."""
    frames = TP.moving_scene(64, 48, 4)
    dat = str(tmp_path / "w.dat")
    s = t_top.VideoEncoderSession(64, 48, analysis_save=dat, device="cpu",
                                  **TP.ANALYSIS_KW)
    for f in frames:
        s.encode_frame(*f)
    s.analysis_save.close()
    md5 = []
    for kw in ({}, {"analysis_load": dat}):
        s = t_top.VideoEncoderSession(64, 48, weightp=True, device="cpu",
                                      **TP.ANALYSIS_KW, **kw)
        assert not s.hinted
        md5.append(TP.md5(b"".join(s.encode_frame(*f).nals
                                   for f in frames)))
    assert md5[0] == md5[1]


def test_cli_forces_the_uniform_ippp_grid():
    """--analysis-save at x265's default preset: the uniform 16x16 IPPP
    session without weighted prediction (the reference's rule), the
    preset's other tools kept."""
    args, prm = t_cli.parse(["in.y4m", "-o", "o.hevc", "--analysis-save",
                             "/dev/null"])
    info = t_io.VideoInfo(64, 48, 25, 1, 1, 8)
    s = t_cli.configure(args, prm, info, device="cpu")
    assert (s.max_depth, s.bframes, s.weightp, s.cu) == (0, 0, False, 16)
    assert s.aq_mode and s.analysis_save is not None


def _write_clip(path, frames):
    w = t_io.Y4MWriter(path, t_io.VideoInfo(64, 48, 25, 1, 1, 8))
    for f in frames:
        w.write_frame(*f)
    w.close()


def test_cli_save_load_match_pins(tmp_path):
    """--analysis-save then --analysis-load over the command lines' clip:
    the JAX CLI's streams and record file."""
    src = TP.write_cli_inputs(str(tmp_path), _write_clip)
    for name in ("analysis_save", "analysis_load"):
        got = TP.run_cli(t_cli.main, name, str(tmp_path), src, device="cpu")
        assert got == TP.CLI_PINS[name], name
    assert TP.file_md5(str(tmp_path / "cli.dat")) == \
        TP.CLI_PINS["analysis_record"]


@pytest.mark.slow
def test_cli_pins_recomputed_from_jax(tmp_path):
    def write(path, frames):
        w = j_io.Y4MWriter(path, j_io.VideoInfo(64, 48, 25, 1, 1, 8))
        for f in frames:
            w.write_frame(*f)
        w.close()
    src = TP.write_cli_inputs(str(tmp_path), write)
    for name in ("analysis_save", "analysis_load"):
        assert TP.run_cli(j_cli.main, name, str(tmp_path), src) == \
            TP.CLI_PINS[name]
    assert TP.file_md5(str(tmp_path / "cli.dat")) == \
        TP.CLI_PINS["analysis_record"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_pins_on_the_card(tmp_path):
    """The save / load and scale_factor passes on the card (the scaler
    there too): the pinned JAX md5s; the loaded P frames launch no ME
    sweep, only the lookahead's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    dj, dp = _dirs(tmp_path)
    before = me_sad.sad_sweep_best.launches
    assert TP.run_analysis(t_top, dp) == TP.ANALYSIS_PINS
    # 5 frames a pass: 5 lookahead sweeps each, 4 ME sweeps when saving
    assert me_sad.sad_sweep_best.launches - before == 5 + 4 + 5
    resize = lambda p, h, w: t_scaler.resize_plane(p, h, w, device="cuda") \
        .cpu().numpy()
    assert TP.run_scale_factor(t_top, resize, dj) == TP.SCALE_PINS
