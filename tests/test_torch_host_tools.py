"""The host tools of the port against the JAX package (CPU, exact): the
HDR10+ T.35 SEI and the Annex-B NAL split of the Dolby Vision RPUs, the
sessions and command lines that carry them (tools_pins), the frame
prefetch and reconplay of utils/io.py, and the library's last entry
points (cleanup, dither_image, calculate_vmaf,
get_slicetype_poc_and_scenecut, get_ref_frame_list)."""
import json

import numpy as np
import pytest
import torch

import tools_pins as TP
from x265_yuuki_asuna_tpu import api as j_api
from x265_yuuki_asuna_tpu import cli as j_cli
from x265_yuuki_asuna_tpu.bitstream import bitio as j_bitio
from x265_yuuki_asuna_tpu.bitstream import sei as j_sei
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.utils import io as j_io
from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
from x265_yuuki_asuna_tpu_torch import api as t_api
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.bitstream import bitio as t_bitio
from x265_yuuki_asuna_tpu_torch.bitstream import sei as t_sei
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.utils import io as t_io

torch.set_num_threads(2)

RECORDS = TP.HDR10P + [
    {"NumberOfWindows": 1, "TargetedSystemDisplayMaximumLuminance": 4000,
     "LuminanceParameters": {
         "MaxScl": [70000, 0, 131071], "AverageRGB": 123,
         "LuminanceDistributions": {"DistributionIndex": list(range(20)),
                                    "DistributionValues": list(range(16))}},
     "BezierCurveData": {"KneePointX": 4095, "KneePointY": 0,
                         "Anchors": list(range(0, 1000, 50))}},
    {"LuminanceParameters": {"MaxScl": "bad"}},
    {}]


def test_t35_payloads_match_jax():
    """Every record's T.35 payload and SEI NAL (a full record, a bare
    one, one past the 15-entry limits, one that cannot be coded, an
    empty one) and the frame index past the records' end."""
    for rec in RECORDS:
        try:
            want = j_sei.hdr10plus_t35_payload(rec)
        except (KeyError, TypeError, ValueError) as e:
            with pytest.raises(type(e)):
                t_sei.hdr10plus_t35_payload(rec)
        else:
            assert t_sei.hdr10plus_t35_payload(rec) == want
    for i in range(len(RECORDS) + 2):
        assert t_sei.hdr10plus_sei_for_frame(RECORDS, i) == \
            j_sei.hdr10plus_sei_for_frame(RECORDS, i)
    assert t_sei.hdr10plus_sei_for_frame([], 0) == b""
    assert t_sei.user_data_t35(b"\xb5x") == j_sei.user_data_t35(b"\xb5x")


@pytest.mark.parametrize("doc", [
    {"SceneInfo": TP.HDR10P}, {"frames": TP.HDR10P}, TP.HDR10P, {"x": 1},
    "text", None], ids=["SceneInfo", "frames", "list", "other", "str",
                        "missing"])
def test_load_hdr10plus_json_matches_jax(tmp_path, doc):
    path = str(tmp_path / "d.json")
    if doc is not None:
        with open(path, "w") as f:
            if doc == "text":
                f.write("{not json")
            else:
                json.dump(doc, f)
    assert t_sei.load_hdr10plus_json(path) == \
        j_sei.load_hdr10plus_json(path)


def test_parse_annexb_nals_matches_jax():
    """Start codes of 3 and 4 bytes, trailing zeros, NALs of two bytes or
    fewer, payloads with emulation-prevention bytes, and seeded random
    streams."""
    cases = [b"", b"\x00\x00\x01", b"\x00\x00\x01\x7c\x01",
             b"\x00\x00\x00\x01\x7c\x01abc\x00\x00\x01\x7c\x01de\x00\x00",
             b"junk\x00\x00\x01\x7c\x01\x00\x00\x03\x01x\x00\x00\x00\x01"
             b"\x7c\x01yz",
             t_bitio.wrap_nal(62, b"\x01rpu-0\x00\x00\x02")
             + t_bitio.wrap_nal(62, b"\x01rpu-1")]
    rng = np.random.default_rng(8)
    for _ in range(200):
        a = rng.integers(0, 4, int(rng.integers(0, 64))).astype(np.uint8)
        cases.append(bytes(a))
    for data in cases:
        assert t_bitio.parse_annexb_nals(data) == \
            j_bitio.parse_annexb_nals(data)
    assert t_bitio.parse_annexb_nals(cases[-201]) == [b"\x01rpu-0\x00\x00"
                                                      b"\x03\x02",
                                                      b"\x01rpu-1"]


def test_hdr10p_session_matches_pin():
    """tests/test_sei_extras.py's session with each frame's HDR10+ SEI:
    the JAX session's stream, one T.35 SEI a frame, decoded to its
    recon."""
    got, res = TP.run_hdr10p_session(t_top, t_sei, device="cpu")
    assert got == TP.SEI_PINS["hdr10p"]
    stream = b"".join(r.nals for r in res)
    assert stream.count(b"\xb5\x00\x3c\x00\x01\x04\x01") == 3
    s = t_top.VideoEncoderSession(64, 48, qp=32, keyint=10, device="cpu")
    dec = decode_hevc(s.headers() + stream, 64, 48)
    assert len(dec) == 3 and all(np.array_equal(d[0][:48, :64], r.recon[0])
                                 for d, r in zip(dec, res))


def _write_clip(path, frames):
    w = t_io.Y4MWriter(path, t_io.VideoInfo(64, 48, 25, 1, 1, 8))
    for f in frames:
        w.write_frame(*f)
    w.close()


def _nal_types(data: bytes):
    out, i = [], 0
    while (j := data.find(b"\x00\x00\x01", i)) >= 0:
        out.append((data[j + 3] >> 1) & 0x3f)
        i = j + 3
    return out


@pytest.mark.parametrize("name", ["dovi", "hdr10p_dovi"])
def test_cli_metadata_matches_pins(tmp_path, name):
    """--dolby-vision-rpu on the all-intra session (one RPU NAL a frame,
    the last of the file's two repeated) and with --dhdr10-info on the
    video session (the HDR10+ SEI first): the JAX CLI's streams."""
    src = TP.write_cli_inputs(str(tmp_path), _write_clip)
    got = TP.run_cli(t_cli.main, name, str(tmp_path), src, device="cpu")
    assert got == TP.CLI_PINS[name]
    with open(tmp_path / f"{name}.hevc", "rb") as f:
        data = f.read()
    assert _nal_types(data).count(62) == TP.CLI_FRAMES
    assert data.count(b"rpu-frame-1") == TP.CLI_FRAMES - 1
    assert (b"\xb5\x00\x3c\x00\x01\x04\x01" in data) == ("hdr10p" in name)


def test_prefetch_reader(tmp_path):
    """Every frame in order, then the end; close() mid-stream stops the
    thread and closes the reader."""
    rng = np.random.default_rng(3)
    frames = [(rng.integers(0, 256, (48, 64)).astype(np.uint8),
               rng.integers(0, 256, (24, 32)).astype(np.uint8),
               rng.integers(0, 256, (24, 32)).astype(np.uint8))
              for _ in range(9)]
    path = str(tmp_path / "c.y4m")
    _write_clip(path, frames)
    pre = t_io.PrefetchReader(t_io.open_input(path), depth=2)
    got = list(pre)
    assert len(got) == 9 and all(np.array_equal(a, b) for g, f in
                                 zip(got, frames) for a, b in zip(g, f))
    pre.close()
    pre = t_io.PrefetchReader(t_io.open_input(path), depth=2)
    first = next(iter(pre))
    assert np.array_equal(first[0], frames[0][0])
    pre.close()
    assert not pre.thread.is_alive() and pre.reader.f.closed


def test_reconplay_pipes_y4m(tmp_path):
    """--recon-y4m-exec pipes the recon as y4m into the command: the
    header of the input's geometry, then each frame (the --recon file's
    samples); the JAX reconplay writes the same bytes."""
    src = TP.write_cli_inputs(str(tmp_path), _write_clip)
    sink, recon = tmp_path / "sink.y4m", tmp_path / "r.yuv"
    assert t_cli.main([src, "-o", str(tmp_path / "o.hevc"), "--keyint", "1",
                       "--qp", "32", "--recon", str(recon),
                       "--recon-y4m-exec", f"dd of={sink} status=none"],
                      device="cpu") == 0
    data = sink.read_bytes()
    head = b"YUV4MPEG2 W64 H48 F25:1 Ip A1:1 C420\n"
    assert data.startswith(head) and data.count(b"FRAME\n") == TP.CLI_FRAMES
    size = 64 * 48 * 3 // 2
    body = recon.read_bytes()
    assert data == head + b"".join(
        b"FRAME\n" + body[i * size:(i + 1) * size]
        for i in range(TP.CLI_FRAMES))
    info = t_io.VideoInfo(64, 48, 25, 1, 1, 8)
    jsink = tmp_path / "jsink.y4m"
    jp = j_io.ReconPlay(f"dd of={jsink} status=none", info)
    tp = t_io.ReconPlay(f"dd of={tmp_path / 'tsink.y4m'} status=none", info)
    planes = (np.zeros((48, 64), np.uint8), np.ones((24, 32), np.uint8),
              np.full((24, 32), 2, np.uint8))
    for play in (jp, tp):
        play.write_frame(*planes)
        play.close()
    assert (tmp_path / "tsink.y4m").read_bytes() == jsink.read_bytes()


def test_reconplay_survives_a_closed_pipe(tmp_path):
    """A command that exits without reading: writes are dropped."""
    play = t_io.ReconPlay("true", t_io.VideoInfo(64, 48, 25, 1, 1, 8))
    play.proc.wait(10)
    big = np.zeros((48, 64 * 400), np.uint8)
    for _ in range(4):
        play.write_frame(big, None, None)
    play.close()


def test_library_extras():
    """cleanup, dither_image (10 and 12 bits to 8 and 10, same depth) and
    calculate_vmaf as the reference's; the slice type / POC / scene cut
    of the last picture and the reference list of a library encode."""
    assert t_api.cleanup() is None and not t_api.VMAF_AVAILABLE
    with pytest.raises(RuntimeError, match="VMAF"):
        t_api.calculate_vmaf(None, None)
    rng = np.random.default_rng(6)
    for bi, bo in ((10, 8), (12, 8), (12, 10), (10, 10)):
        p = rng.integers(0, 1 << bi, (17, 31)).astype(np.uint16)
        a, b = t_api.dither_image(p, bi, bo), j_api.dither_image(p, bi, bo)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    p = t_api.param_default_preset("ultrafast")
    t_api.param_parse(p, "input-res", "64x48")
    t_api.param_parse(p, "bframes", "2")
    t_api.param_parse(p, "b-adapt", "0")
    enc = t_api.encoder_open(p, device="cpu")
    assert t_api.get_slicetype_poc_and_scenecut(enc) == \
        {"sliceType": None, "poc": None, "bScenecut": 0}
    assert t_api.get_ref_frame_list(enc) == ([], [])
    got = []
    for f in TP.sei_frames(4):
        pic = t_api.picture_init(p, t_api.picture_alloc())
        pic.planes = f
        if t_api.encoder_encode(enc, pic):
            got.append(t_api.get_slicetype_poc_and_scenecut(enc))
    assert got[0] == {"sliceType": "I", "poc": 0, "bScenecut": 1}
    assert got[-1]["sliceType"] in "Bb" and got[-1]["bScenecut"] == 0
    assert t_api.get_ref_frame_list(enc) == ([enc._sess.anchor[1]], [])


@pytest.mark.slow
def test_pins_recomputed_from_jax(tmp_path):
    assert TP.run_hdr10p_session(j_top, j_sei)[0] == TP.SEI_PINS["hdr10p"]

    def write(path, frames):
        w = j_io.Y4MWriter(path, j_io.VideoInfo(64, 48, 25, 1, 1, 8))
        for f in frames:
            w.write_frame(*f)
        w.close()
    src = TP.write_cli_inputs(str(tmp_path), write)
    for name in ("dovi", "hdr10p_dovi"):
        assert TP.run_cli(j_cli.main, name, str(tmp_path), src) == \
            TP.CLI_PINS[name]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_metadata_pins_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    assert TP.run_hdr10p_session(t_top, t_sei)[0] == TP.SEI_PINS["hdr10p"]
    src = TP.write_cli_inputs(str(tmp_path), _write_clip)
    for name in ("dovi", "hdr10p_dovi"):
        assert TP.run_cli(t_cli.main, name, str(tmp_path), src) == \
            TP.CLI_PINS[name], name
