"""The multi-slot pipeline in the port against the JAX package (CPU,
exact): parallel/mesh.py's frame- and band-parallel programs,
parallel/pipeline.py's P-chain fill and steady state, the PipelinedEncoder
session (CQP, per-chain ABR, the int8 refusal) and the CLI's --devices,
held to the JAX package's pins (tests/parallel_pins.py: the JAX side
compiles shard_map programs over 4 or 8 virtual devices, so tier-1 reads
pins and the slow tests recompute them), and to the port's own
sequential paths; the video session's flush(count) and the item-9b
refusals. The card tests run the slots as streams of one card, and as
cards where there are two or more."""
import os

import numpy as np
import pytest
import torch

import parallel_pins as PP
from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch import parallel as t_par
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models.inter_encoder import \
    InterFrameEncoder
from x265_yuuki_asuna_tpu_torch.models.intra_encoder import \
    IntraFrameEncoder
from x265_yuuki_asuna_tpu_torch.parallel.session import PipelinedEncoder
from x265_yuuki_asuna_tpu_torch.utils import io as t_io

torch.set_num_threads(2)


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        (a[k] is None and b[k] is None) or np.array_equal(a[k], b[k])
        for k in a)


def _write_clip(path, frames):
    w = t_io.Y4MWriter(path, t_io.VideoInfo(64, 48, 25, 1, 1, 8))
    for f in frames:
        w.write_frame(*f)
    w.close()


def _chain(enc, ys, us, vs, idr):
    """The sequential chain: frame k against frame k-1's recon."""
    ref, out = idr, []
    for y, u, v in zip(ys, us, vs):
        out.append(enc.encode_frame(y, u, v, *ref, 32))
        ref = tuple(out[-1][k] for k in ("recon_y", "recon_u", "recon_v"))
    return out


# ---------------------------------------------------------------------------
# slots
# ---------------------------------------------------------------------------

def test_make_slots_on_the_cpu():
    slots = t_par.make_slots(4, "cpu")
    assert [(s.index, s.device.type, s.stream) for s in slots] == \
        [(k, "cpu", None) for k in range(4)]
    # fewer than two slots: the reference's assertion
    for n in (1, 0):
        with pytest.raises(AssertionError, match="needs >= 2"):
            t_par.make_slots(n, "cpu")
    with pytest.raises(AssertionError):      # None: one per card, the CPU
        t_par.make_slots(None, "cpu")
    with pytest.raises(AssertionError):
        PipelinedEncoder(64, 48, n_devices=1, device="cpu")


def test_slots_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_par.make_slots(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelinedEncoder(64, 48, n_devices=4)


# ---------------------------------------------------------------------------
# frame and band parallel
# ---------------------------------------------------------------------------

def test_frame_parallel_equals_the_batch_and_the_jax_mesh():
    """8 frames, one per CPU slot: each dict equals the port's batch of
    the 8 frames and the JAX mesh output's _unpack (pinned digests)."""
    got = PP.frame_parallel_dicts(t_par, IntraFrameEncoder, "cpu")
    batch = IntraFrameEncoder(64, 48, 16, "cpu").encode_frames(
        *PP.frame_parallel_inputs(), 32)
    assert all(_same(a, b) for a, b in zip(got, batch))
    assert [PP.digest(d) for d in got] == PP.FRAME_PARALLEL_DIGESTS


def test_band_parallel_assembles_the_sliced_stream():
    """4 bands of one picture, one per slot: the assembled stream equals
    the port's --slices 4 session and the JAX golden's md5."""
    stream = PP.band_stream(t_par, t_top, "cpu")
    assert PP.md5(stream) == PP.BANDS_MD5
    sess = t_top.IntraEncoderSession(64, 64, qp=32, cu_size=16,
                                     hash_sei=False, slices=4,
                                     device="cpu")
    assert sess.headers() + sess.encode_frame(*PP.band_inputs()).nals == \
        stream


# ---------------------------------------------------------------------------
# the P-chain pipeline
# ---------------------------------------------------------------------------

def test_frame_pipeline_equals_the_chain_and_the_jax_program():
    got = PP.pipeline_dicts(t_par, InterFrameEncoder, "cpu")
    ys, us, vs, *idr = PP.pipeline_inputs()
    enc = InterFrameEncoder(PP.PIPE_W, PP.PIPE_H, 16, "cpu",
                            search_range=PP.SEARCH_RANGE)
    assert all(_same(a, b) for a, b in zip(got, _chain(enc, ys, us, vs,
                                                        idr)))
    assert [PP.digest(d) for d in got] == PP.PIPELINE_DIGESTS


def test_frame_pipeline_stream_equals_each_chain_and_the_jax_program():
    """T = 3 chains through N = 4 slots in T + N - 1 steps: every chain
    equals its sequential chain from the IDR, every dict the JAX
    program's."""
    got = PP.pipeline_stream_dicts(t_par, InterFrameEncoder, "cpu")
    ys, us, vs, *idr = PP.pipeline_stream_inputs()
    enc = InterFrameEncoder(PP.STREAM_W, PP.STREAM_H, 16, "cpu",
                            search_range=PP.SEARCH_RANGE)
    for t in range(PP.STREAM_T):
        assert all(_same(a, b) for a, b in zip(
            got[t], _chain(enc, ys[t], us[t], vs[t], idr)))
    assert [[PP.digest(d) for d in row] for row in got] == \
        PP.PIPELINE_STREAM_DIGESTS


def test_submit_finish_equals_encode_frame():
    """The P program's submit / finish split: the recon planes read on
    the device before the fetch equal the fetched dict's."""
    ys, us, vs, *idr = PP.pipeline_inputs()
    enc = InterFrameEncoder(PP.PIPE_W, PP.PIPE_H, 16, "cpu",
                            search_range=PP.SEARCH_RANGE)
    h = enc.submit_frame(ys[0], us[0], vs[0], *idr, 32)
    rec = enc.recon_planes(h)
    out = enc.finish_frame(h)
    assert _same(out, enc.encode_frame(ys[0], us[0], vs[0], *idr, 32))
    for p, k in zip(rec, ("recon_y", "recon_u", "recon_v")):
        assert p.dtype == torch.uint8 and np.array_equal(p.numpy(), out[k])


# ---------------------------------------------------------------------------
# the pipelined session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qp32", "qp30"])
def test_pipelined_session_matches_the_jax_pins(name):
    """tests/test_pipeline_session.py's clips (IDR + 9 P: two chains of
    4 and one of 1; IDR + 8 P): each frame's NALs equal the JAX
    session's, and encode_clip equals encode_clip_sequential."""
    enc, res, stream = PP.run_session(PipelinedEncoder, name, device="cpu")
    assert PP.session_pin_of(res, stream) == PP.SESSION_PINS[name]
    assert [r.frame_type for r in res] == ["I"] + ["P"] * (len(res) - 1)
    assert [r.poc for r in res] == list(range(len(res)))
    _, seq, seq_stream = PP.run_session(PipelinedEncoder, name, True,
                                        device="cpu")
    assert seq_stream == stream
    # no loop filter runs in the handoff (the reference's session)
    assert not (enc.sess.deblock or enc.sess.sao)
    assert enc.sess.pps.deblocking_disabled == 1


def test_chains_reanchor_at_the_idr():
    """Each chain's first frame is coded against the IDR's recon (the
    reference's re-anchoring), and its slice's RPS holds only the IDR."""
    enc, res, _ = PP.run_session(PipelinedEncoder, "qp32", device="cpu")
    frames = PP.session_clip(64, 48, 10)
    sess = enc.sess
    idr = [np.asarray(p) for p in sess.anchor[0]]
    for poc in (1, 5, 9):
        out = sess.inter_encoder.encode_frame(*enc._pad(frames[poc]), *idr,
                                              32)
        assert sess._assemble_p_slice(out, 32, poc, 1,
                                      rps=([(poc, 1)], [])) == res[poc].nals
    assert enc._rps(5, 0) == ([(5, 1)], [])
    assert enc._rps(6, 1) == ([(1, 1), (6, 0)], [])


def test_pipelined_stream_decodes_to_the_recon():
    """The QP 30 clip through an independent decoder (OpenCV's FFmpeg,
    the JAX package's test decoder): every picture equals the port's
    recon."""
    pytest.importorskip("cv2")
    enc, res, stream = PP.run_session(PipelinedEncoder, "qp30",
                                      device="cpu")
    dec = decode_hevc(stream, enc.sess.coded_w, enc.sess.coded_h)
    assert len(dec) == len(res) == 9
    for d, r in zip(dec, res):
        for p in range(3):
            h, w = r.recon[p].shape
            assert np.array_equal(d[p][:h, :w].astype(np.uint8), r.recon[p])


def test_per_chain_abr_matches_the_jax_pin():
    """Per-chain ABR: the stream, each frame's NALs and QPs equal the JAX
    session's. The rate control sees the IDR's bits once, then each
    chain's, and picks a QP per chain; the programs run at the first
    chain's QP and only the later slices carry theirs (the reference's
    fault), so an independent decoder reproduces the first chain and
    not the rest."""
    pytest.importorskip("cv2")
    _, res, stream = PP.run_session(PipelinedEncoder, "abr100",
                                    device="cpu")
    assert PP.session_pin_of(res, stream) == PP.SESSION_PINS["abr100"]
    dec = decode_hevc(stream, 64, 48)
    same = [all(np.array_equal(d[p][:r.recon[p].shape[0],
                                    :r.recon[p].shape[1]].astype(np.uint8),
                               r.recon[p]) for p in range(3))
            for d, r in zip(dec, res)]
    assert same == [True] * 5 + [False] * 5


def test_int8_refusal_and_the_sequential_path():
    """Noise at QP 12 puts levels outside [-128, 127]: encode_clip raises
    the reference's RuntimeError (its program packs levels in int8),
    encode_clip_sequential codes the clip, equal to the JAX sequential
    path (which reruns the frame in int16)."""
    frames = PP.noise_clip()
    enc = PipelinedEncoder(64, 48, qp=PP.OVERFLOW_QP, n_devices=4,
                           device="cpu")
    with pytest.raises(RuntimeError, match="overflowed int8"):
        enc.encode_clip(frames)
    enc = PipelinedEncoder(64, 48, qp=PP.OVERFLOW_QP, n_devices=4,
                           device="cpu")
    res = enc.encode_clip_sequential(frames)
    assert PP.md5(enc.headers() + b"".join(r.nals for r in res)) == \
        PP.OVERFLOW_SEQ_MD5
    assert max(int(np.abs(r.recon[0]).max()) for r in res) <= 255


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PP.CLI))
def test_cli_devices_matches_the_jax_cli(tmp_path, name):
    """--devices N (with --bitrate, --frames and --qp) through
    cli.main(device="cpu"): the stream equals the JAX CLI's."""
    src = PP.write_cli_input(str(tmp_path), _write_clip)
    assert PP.run_cli(t_cli.main, name, str(tmp_path), src,
                      device="cpu") == PP.CLI_PINS[name]


def test_cli_devices_1_takes_the_ordinary_path(tmp_path):
    src = str(tmp_path / "in.y4m")
    _write_clip(src, PP.session_clip(64, 48, 3))
    base = ["--preset", "ultrafast", "--qp", "32"]
    out = []
    for extra in ([], ["--devices", "1"]):
        dst = str(tmp_path / f"o{len(extra)}.hevc")
        assert t_cli.main([src, "-o", dst] + base + extra,
                          device="cpu") == 0
        out.append(open(dst, "rb").read())
    assert out[0] == out[1]
    # the pipeline's stream differs (CTU16, IDR + P-chains)
    dst = str(tmp_path / "p.hevc")
    assert t_cli.main([src, "-o", dst] + base + ["--devices", "2"],
                      device="cpu") == 0
    assert open(dst, "rb").read() != out[0]


# ---------------------------------------------------------------------------
# the video session's flush(count) and item 9b
# ---------------------------------------------------------------------------

def test_flush_count_closes_a_minigop_as_the_reference():
    """flush(2) codes the first two pending frames (a P anchor and a b)
    and drains nothing; the stream equals the JAX session's."""
    got = PP.run_flush_count(t_top, device="cpu")
    pin = PP.FLUSH_COUNT_PIN
    assert got == (pin["stream"], pin["frames"], pin["after_flush2"])


def test_item_9b_geometries_stay_refused():
    """CTU32 at max_depth=3 means 4x4 CUs: the JAX session codes them but
    cannot write its SPS (log2_min_luma_coding_block_size_minus3 = -1
    fails its writer's assertion), and the port refuses it, naming the
    reason. The uniform 8x8 grid codes now: its CTU of 8 lies outside
    every profile (CtbLog2SizeY 4-6), libde265 decodes it and FFmpeg
    refuses it (the slow test); the port's stream of the pinned session
    is the JAX package's (more in tests/test_torch_cu8.py)."""
    from x265_yuuki_asuna_tpu.models.encoder_top import \
        VideoEncoderSession as JS
    with pytest.raises(AssertionError):
        JS(64, 48, max_depth=3).headers()
    with pytest.raises(NotImplementedError, match="item 9b") as e:
        t_top.VideoEncoderSession(64, 48, max_depth=3, device="cpu")
    assert "SPS" in str(e.value)
    s = t_top.VideoEncoderSession(64, 48, qp=32, keyint=10, cu_size=8,
                                  device="cpu")
    assert s.sps.log2_min_cb + s.sps.log2_diff_max_min_cb == 3
    res = [s.encode_frame(*f) for f in PP.session_clip(64, 48, 3)]
    assert PP.md5(s.headers() + b"".join(r.nals for r in res)) == \
        PP.CU8_MD5


# ---------------------------------------------------------------------------
# the pins, recomputed from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_program_pins_recomputed_from_jax():
    import jax
    from x265_yuuki_asuna_tpu.models.encoder_top import \
        IntraEncoderSession
    from x265_yuuki_asuna_tpu.models.inter_encoder import (
        InterFrameConfig, InterFrameEncoder as JInter)
    from x265_yuuki_asuna_tpu.models.intra_encoder import (
        IntraFrameConfig, IntraFrameEncoder as JIntra)
    from x265_yuuki_asuna_tpu.parallel import (frame_parallel_fn,
                                               frame_pipeline_fn,
                                               frame_pipeline_stream_fn,
                                               make_mesh)
    assert len(jax.devices()) >= 8
    enc = JIntra(IntraFrameConfig(width=64, height=48, cu_size=16, qp=32))
    buf = np.asarray(frame_parallel_fn(enc, make_mesh(8))(
        *PP.frame_parallel_inputs()))
    assert [PP.digest(enc._unpack(b)) for b in buf] == \
        PP.FRAME_PARALLEL_DIGESTS
    sess = IntraEncoderSession(64, 64, qp=32, cu_size=16, hash_sei=False,
                               slices=PP.BANDS)
    assert PP.md5(sess.headers() + sess.encode_frame(
        *PP.band_inputs()).nals) == PP.BANDS_MD5
    mesh = make_mesh(PP.PIPE_N)
    for fn, (w, h), inputs, pin in (
            (lambda e: frame_pipeline_fn(e, mesh), (PP.PIPE_W, PP.PIPE_H),
             PP.pipeline_inputs(), PP.PIPELINE_DIGESTS),
            (lambda e: frame_pipeline_stream_fn(e, mesh, PP.STREAM_T),
             (PP.STREAM_W, PP.STREAM_H), PP.pipeline_stream_inputs(),
             PP.PIPELINE_STREAM_DIGESTS)):
        enc = JInter(InterFrameConfig(width=w, height=h, cu_size=16, qp=32,
                                      search_range=PP.SEARCH_RANGE))
        packed = np.asarray(fn(enc)(*inputs))
        flat = packed.reshape(-1, packed.shape[-1])
        assert not flat[:, -1].any()            # no int8 overflow
        digests = [PP.digest(enc._unpack(b)) for b in flat]
        assert digests == (pin if packed.ndim == 2 else
                           [d for row in pin for d in row])


@pytest.mark.slow
def test_session_and_cli_pins_recomputed_from_jax(tmp_path, monkeypatch):
    from x265_yuuki_asuna_tpu import cli as j_cli
    from x265_yuuki_asuna_tpu.models import encoder_top as j_top
    from x265_yuuki_asuna_tpu.parallel.session import \
        PipelinedEncoder as JPipe
    from x265_yuuki_asuna_tpu.utils import io as j_io
    for name in PP.SESSIONS:
        _, res, stream = PP.run_session(JPipe, name)
        assert PP.session_pin_of(res, stream) == PP.SESSION_PINS[name]
        if name != "abr100":
            assert PP.run_session(JPipe, name, True)[2] == stream
    with pytest.raises(RuntimeError, match="overflowed int8"):
        JPipe(64, 48, qp=PP.OVERFLOW_QP, n_devices=4).encode_clip(
            PP.noise_clip())
    enc = JPipe(64, 48, qp=PP.OVERFLOW_QP, n_devices=4)
    res = enc.encode_clip_sequential(PP.noise_clip())
    assert PP.md5(enc.headers() + b"".join(r.nals for r in res)) == \
        PP.OVERFLOW_SEQ_MD5
    got = PP.run_flush_count(j_top)
    pin = PP.FLUSH_COUNT_PIN
    assert got == (pin["stream"], pin["frames"], pin["after_flush2"])

    def write(path, frames):
        w = j_io.Y4MWriter(path, j_io.VideoInfo(64, 48, 25, 1, 1, 8))
        for f in frames:
            w.write_frame(*f)
        w.close()
    src = PP.write_cli_input(str(tmp_path), write)
    # the reference's --devices iterates its reader, which has no
    # __iter__: the fault the port does not keep
    with pytest.raises(TypeError, match="not iterable"):
        j_cli.main([src, "-o", str(tmp_path / "x.hevc"), "--devices", "4"])
    monkeypatch.setattr(j_io.Y4MReader, "__iter__",
                        lambda self: iter(self.read_frame, None),
                        raising=False)
    for name in PP.CLI:
        assert PP.run_cli(j_cli.main, name, str(tmp_path), src) == \
            PP.CLI_PINS[name]


@pytest.mark.slow
def test_item_9b_cu8_stream_decodes_in_libde265_only():
    """The JAX uniform 8x8 session's stream (the pin): libde265 decodes it
    to the recon, FFmpeg decodes no picture."""
    pytest.importorskip("cv2")
    from x265_yuuki_asuna_tpu.models.encoder_top import \
        VideoEncoderSession as JS
    from x265_yuuki_asuna_tpu.utils import de265_decode as D
    s = JS(64, 48, qp=32, keyint=10, cu_size=8)
    res = [s.encode_frame(*f) for f in PP.session_clip(64, 48, 3)]
    stream = s.headers() + b"".join(r.nals for r in res)
    assert PP.md5(stream) == PP.CU8_MD5
    assert len(decode_hevc(stream, 64, 48)) == 0
    if D.available():
        dec = D.decode_hevc_de265(stream)
        assert len(dec) == 3
        for d, r in zip(dec, res):
            for p in range(3):
                assert np.array_equal(np.asarray(d[p]), r.recon[p])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _slot_layouts():
    """Four streams of card 0, and across the cards where there are two
    or more."""
    out = [dict(devices=["cuda:0"])]
    if torch.cuda.device_count() >= 2:
        out.append(dict(devices=None))
    return out


@pytest.mark.gpu
def test_pipeline_on_the_card():
    """The programs and sessions with the slots on the card: the dicts
    and streams equal the pins (and so the CPU's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    for lay in _slot_layouts():
        assert [PP.digest(d) for d in PP.frame_parallel_dicts(
            t_par, IntraFrameEncoder, **lay)] == PP.FRAME_PARALLEL_DIGESTS
        assert PP.md5(PP.band_stream(t_par, t_top, **lay)) == PP.BANDS_MD5
        assert [PP.digest(d) for d in PP.pipeline_dicts(
            t_par, InterFrameEncoder, **lay)] == PP.PIPELINE_DIGESTS
        assert [[PP.digest(d) for d in row] for row in
                PP.pipeline_stream_dicts(t_par, InterFrameEncoder, **lay)] \
            == PP.PIPELINE_STREAM_DIGESTS
        for name in PP.SESSIONS:
            _, res, stream = PP.run_session(PipelinedEncoder, name, **lay)
            assert PP.session_pin_of(res, stream) == PP.SESSION_PINS[name]


@pytest.mark.gpu
def test_cli_devices_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    src = PP.write_cli_input(str(tmp_path), _write_clip)
    for name in ("d4", "d4_abr"):
        assert PP.run_cli(t_cli.main, name, str(tmp_path), src) == \
            PP.CLI_PINS[name]
    assert os.path.getsize(os.path.join(str(tmp_path), "d4.hevc")) > 0
