"""The uniform 8x8 grid (cu_size=8, a CTU of 8) of the port against the
JAX package (CPU, exact): the intra and P programs' decision dicts
against the live JAX programs', the parameter sets, every option the JAX
sessions code at cu 8 held to the pinned md5s and frame lists of
tests/cu8_pins.py (both sessions, PipelinedEncoder, analysis save / load,
two passes), the options the JAX sessions fail on refused with the
reason, and the reference's faults the port keeps. `-m slow` recomputes
every pin from the JAX package and decodes the streams with libde265;
`-m gpu` runs the pins on the card."""
import numpy as np
import pytest
import torch

import cu8_pins as P
from golden_corpus import clip
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.models.inter_encoder import (InterFrameConfig,
                                                       InterFrameEncoder)
from x265_yuuki_asuna_tpu.models.intra_encoder import (IntraFrameConfig,
                                                       IntraFrameEncoder)
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import inter_encoder as t_inter
from x265_yuuki_asuna_tpu_torch.models import intra_encoder as t_intra
from x265_yuuki_asuna_tpu_torch.parallel.session import PipelinedEncoder

torch.set_num_threads(2)


def _assert_same_dict(j, t):
    assert set(j) == set(t)
    for k, v in j.items():
        if v is None:
            assert t.get(k) is None, k
            continue
        assert np.array_equal(np.asarray(v), t[k]), k


@pytest.fixture(scope="module")
def jax_intra():
    """The live JAX intra program's dict at 64x48, cu 8, QP 29, and the
    frames it codes."""
    f0, f1 = clip(64, 48, n=2, seed=5)
    jo = IntraFrameEncoder(IntraFrameConfig(width=64, height=48, cu_size=8,
                                            qp=29)).encode_frame(*f0, qp=29)
    return f0, f1, jo


def test_intra_decisions_match_jax(jax_intra):
    f0, _, jo = jax_intra
    to = t_intra.IntraFrameEncoder(64, 48, 8, "cpu").encode_frame(*f0, 29)
    _assert_same_dict(jo, to)


def test_inter_decisions_match_jax(jax_intra):
    _, f1, ref = jax_intra
    refs = (ref["recon_y"], ref["recon_u"], ref["recon_v"])
    jo = InterFrameEncoder(InterFrameConfig(width=64, height=48, cu_size=8,
                                            qp=32)).encode_frame(*f1, *refs,
                                                                 qp=32)
    to = t_inter.InterFrameEncoder(64, 48, 8, "cpu").encode_frame(*f1, *refs,
                                                                 32)
    assert to["mvx"].shape == (6, 8)
    assert to["use_intra"].any() or to["mvx"].any()
    _assert_same_dict(jo, to)


def test_cu8_parameter_sets_match_jax():
    """CtbLog2SizeY 3 (log2_min_cb 3, no deeper CU), TUs of 4 and 8, on
    both sessions, with the filters, B frames and AQ's delta QP signalled
    as the reference does."""
    s = t_top.VideoEncoderSession(100, 60, cu_size=8, device="cpu")
    assert (s.cu, s.rows, s.cols, s.inter_encoder.n) == (8, 8, 13, 8)
    sps = s.sps
    assert (sps.log2_min_cb, sps.log2_diff_max_min_cb, sps.log2_min_tb,
            sps.log2_diff_max_min_tb) == (3, 0, 2, 1)
    for cls, kw in (("VideoEncoderSession", dict(keyint=100, bframes=3,
                                                 deblock=True, sao=True,
                                                 wpp=True)),
                    ("VideoEncoderSession", dict(aq_mode=2, cutree=True,
                                                 weightp=True)),
                    ("IntraEncoderSession", dict(sao=True, lossless=True)),
                    ("IntraEncoderSession", dict(csp="i444",
                                                 nr_intra=100))):
        assert getattr(t_top, cls)(100, 60, cu_size=8, device="cpu",
                                   **kw).headers() == \
            getattr(j_top, cls)(100, 60, cu_size=8, **kw).headers()


@pytest.mark.parametrize("name", list(P.SESSIONS))
def test_session_pin(name):
    """Every option the JAX sessions code at cu 8: the stream's md5 and
    each frame's (POC, type, QP)."""
    assert P.run(t_top, name, device="cpu")[:2] == P.PINS[name]


def test_base_pin_is_the_parallel_pin():
    import parallel_pins
    assert P.PINS["base"][0] == parallel_pins.CU8_MD5


@pytest.mark.parametrize("sequential", [False, True])
def test_pipeline_pin(sequential):
    assert P.run_pipeline(PipelinedEncoder, sequential, device="cpu") == \
        P.PIPE_PIN


@pytest.mark.parametrize("kind", list(P.TWO_FILE_PINS))
def test_two_file_pins(kind, tmp_path):
    assert P.run_two_files(t_top, str(tmp_path), kind, device="cpu") == \
        P.TWO_FILE_PINS[kind]


@pytest.mark.parametrize("name", list(P.REFUSED))
def test_refused_options_raise_naming_the_reason(name):
    """AQ at cu 8 fails in the JAX sessions at the first frame coded
    alone (its offsets come on the 16x16 grid); the port raises
    ValueError there, naming the reason."""
    with pytest.raises(ValueError, match="AQ at cu_size=8") as e:
        P.run(t_top, name, device="cpu")
    assert "16x16" in str(e.value)


def test_reference_faults_the_port_keeps():
    """cuTree's causal average pools cu // 16 lowres blocks a CU: none at
    cu 8, so its offsets are all 0 though the average holds costs (the
    QP map still switches on cu_qp_delta); the rc-lookahead window pools
    one block a CU. An intra batch ignores AQ, so it codes at cu 8 where
    a single frame fails (the pins "intra_batch_aq" and "intra_aq")."""
    kw = dict(qp=32, cu_size=8, keyint=100, cutree=True)
    t = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    j = j_top.VideoEncoderSession(64, 48, **kw)
    for f in clip(n=3):
        t.encode_frame(*f)
        j.encode_frame(*f)
    assert np.abs(t.cutree_acc).sum() > 0
    assert np.array_equal(np.asarray(j.cutree_acc), t.cutree_acc)
    assert not t._cutree_offsets().any() and not j._cutree_offsets().any()
    assert t._cutree_offsets().shape == (6, 8)
    assert t.intra_sess.pps.cu_qp_delta == j.intra_sess.pps.cu_qp_delta == 1
    assert P.PINS["intra_batch_aq"][1] == [(0, "I", 30)] * 2


# ---------------------------------------------------------------------------
# slow twins: the pins from the JAX package, the streams in libde265
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", list(P.SESSIONS))
def test_session_pin_from_jax(name):
    assert P.run(j_top, name)[:2] == P.PINS[name]


@pytest.mark.slow
def test_refusals_pipeline_and_files_from_jax(tmp_path):
    from x265_yuuki_asuna_tpu.parallel.session import \
        PipelinedEncoder as JPipe
    for name in P.REFUSED:
        with pytest.raises(ValueError):
            P.run(j_top, name)
    for seq in (False, True):
        assert P.run_pipeline(JPipe, seq) == P.PIPE_PIN
    for kind, pin in P.TWO_FILE_PINS.items():
        assert P.run_two_files(j_top, str(tmp_path), kind) == pin


# each stream: True where libde265 decodes it to the recon; False where
# the reference's fault makes it decode to another picture (ROADMAP
# Queue 3): the P / B deblock filters chroma edges the spec does not at
# cu 8, TMVP reads the collocated field per 8x8 CU (frames from the
# second P on), open GOP's leading pictures lose their reference
DECODES = {"base": True, "pad_100x60": True, "sao": True, "sbh": True,
           "rdoq": True, "ref2": True, "wpp": True, "bframes3": True,
           "wpp_b": True, "weightp": True, "main10": True, "cutree": True,
           "frame_dup": True, "intra": True, "intra_lf": True,
           "intra_wpp": True, "intra_slices": True, "intra_lossless": True,
           "intra_i444": True, "intra_scaling": True, "deblock": False,
           "deblock_sao": False, "b_lf": False, "tmvp": False,
           "open_gop": False}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(DECODES))
def test_cu8_streams_in_libde265(name):
    """libde265 decodes the CTU of 8 (FFmpeg refuses it); each stream
    decodes to the recon or, where DECODES says so, does not."""
    from x265_yuuki_asuna_tpu_torch.utils import de265_decode as D
    if not D.available():
        pytest.skip("libde265 is not installed")
    _, frames, stream, res = P.run(t_top, name, device="cpu")
    order = sorted(range(len(res)), key=lambda i: frames[i][0]) \
        if P.SESSIONS[name][1] == "push" else range(len(res))
    dec = D.decode_hevc_de265(stream)
    assert len(dec) == len(res)
    same = all(np.array_equal(np.asarray(d[p]), np.asarray(res[i].recon[p]))
               for d, i in zip(dec, order) for p in range(3))
    assert same == DECODES[name]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10])
def test_k1_n8_full_plane_matches_plain_on_the_card(bd):
    """The fused kernel at n = 8 on a 1080x1920 plane (135 block rows),
    on a 40x48 crop (5 rows) at lambda 0-2 and on a flat plane (the first
    minimum (-R, -R) at lambda 0), equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    rng = np.random.default_rng(bd)
    peak = (1 << bd) - 1
    dt = torch.uint8 if bd == 8 else torch.int16
    src = rng.integers(0, peak + 1, (1080, 1920))
    ref = np.roll(src, (3, -5), (0, 1))
    flat = np.full((64, 64), peak // 3)
    for r, s_, lams in ((ref, src, (2,)), (ref[:40, :48], src[:40, :48],
                                            (0, 1, 2)), (flat, flat, (0,))):
        tr, ts = (torch.as_tensor(np.ascontiguousarray(a)).to(dt)
                  for a in (r, s_))
        for lam in lams:
            got = me_sad.sad_sweep_best(tr.cuda(), ts.cuda(), 16, 8, lam,
                                        peak)
            want = me_sad.sad_sweep_best_plain(tr, ts, 16, 8, lam)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_cu8_pins_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
    before = me_sad.sad_sweep_best.launches_by_size[8]
    for name in P.SESSIONS:
        assert P.run(t_top, name)[:2] == P.PINS[name], name
    assert P.run_pipeline(PipelinedEncoder, devices=["cuda:0"]) == \
        P.PIPE_PIN
    assert me_sad.sad_sweep_best.launches_by_size[8] > before
