"""The port's host entry points against the JAX package's (CPU, exact):
utils/param.py (every preset x tune, the option table through
param_parse, check_params, param_to_string), utils/io.py (the y4m / yuv
readers and writers), the command line (`cli.main`) and the library
(`api.Encoder`).

The command lines and the library run on tests/preset_pins.py's 96x64
clip and are held to the JAX CLI's and library's md5s, NAL types and CSV
logs pinned there (the JAX CLI takes minutes to compile its quadtree
programs); the slow tests recompute each pin from the live JAX code.
Every CLI preset x tune runs in the port."""
import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

import preset_pins as PP
from x265_yuuki_asuna_tpu.utils import io as j_io
from x265_yuuki_asuna_tpu.utils import param as j_param
from x265_yuuki_asuna_tpu_torch import api as t_api
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.utils import io as t_io
from x265_yuuki_asuna_tpu_torch.utils import param as t_param

torch.set_num_threads(2)
PRESETS = j_param.PRESET_NAMES
TUNES = [None] + j_param.TUNE_NAMES
# values tried on every option of the table (each parser takes some)
VALUES = [None, "0", "1", "2", "3", "17", "-3", "0.5", "2.5", "true", "no",
          "64x48", "30000/1001", "25", "i444", "hex", "star", "main10",
          "bt709", "full", "1:1", "0,10,q=20/11,20,b=0.5", "x"]


def _state(p):
    return dataclasses.asdict(p)


def _same(a, b):
    """Equal Param contents (zones compared field by field)."""
    assert _state(a) == _state(b)


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_and_tunes_match_jax(preset):
    for tune in TUNES:
        _same(t_param.param_default_preset(preset, tune),
              j_param.param_default_preset(preset, tune))
    for bad in ("superfastest", "11"):
        with pytest.raises(t_param.ParamError):
            t_param.param_default_preset(bad)
        with pytest.raises(j_param.ParamError):
            j_param.param_default_preset(bad)


def test_option_table_matches_jax():
    """Every option of the table, under its name and with "no-", parses
    every value of VALUES into the same Param, or refuses it with the
    same error."""
    assert t_param.known_options() == j_param.known_options()
    for name in j_param.known_options():
        for neg in ("", "no-"):
            for val in VALUES:
                j, t = j_param.param_default(), t_param.param_default()
                errs = []
                for mod, p in ((j_param, j), (t_param, t)):
                    try:
                        mod.param_parse(p, neg + name, val)
                        errs.append(None)
                    except Exception as e:       # noqa: BLE001
                        errs.append((type(e).__name__, str(e)))
                assert errs[0] == errs[1], (name, neg, val)
                _same(t, j)
    with pytest.raises(t_param.ParamError):
        t_param.param_parse(t_param.param_default(), "no-such-option", "1")


def test_check_params_and_param_to_string_match_jax():
    cases = [(p, t) for p in PRESETS for t in TUNES]
    for preset, tune in cases + [("medium", None)] * 3:
        j = j_param.param_default_preset(preset, tune)
        t = t_param.param_default_preset(preset, tune)
        for p, mod in ((j, j_param), (t, t_param)):
            mod.param_parse(p, "input-res", "96x64")
        assert t_param.param_to_string(t) == j_param.param_to_string(j)
        assert t_param.check_params(t) == j_param.check_params(j)
        _same(t, j)        # the same fix-ups
    bad = [("input-res", "0x0"), ("bframes", "20"), ("min-cu-size", "64"),
           ("keyint", "0"), ("lossless", "1"), ("aq-strength", "4")]
    for name, val in bad:
        j, t = j_param.param_default(), t_param.param_default()
        j_param.param_parse(j, name, val)
        t_param.param_parse(t, name, val)
        errs = t_param.check_params(t)
        assert errs == j_param.check_params(j)
        _same(t, j)


def _yuv_frames(rng, w, h, csp, depth, n=3):
    dt = np.uint16 if depth > 8 else np.uint8
    hs, ws = {t_param.CSP_I420: (1, 1), t_param.CSP_I444: (0, 0),
              t_param.CSP_I422: (0, 1), t_param.CSP_I400: (0, 0)}[csp]
    out = []
    for _ in range(n):
        y = rng.integers(0, 1 << depth, (h, w)).astype(dt)
        if csp == t_param.CSP_I400:
            out.append((y, None, None))
            continue
        c = lambda: rng.integers(0, 1 << depth, (h >> hs, w >> ws)) \
            .astype(dt)
        out.append((y, c(), c()))
    return out


@pytest.mark.parametrize("csp,depth", [
    (t_param.CSP_I420, 8), (t_param.CSP_I420, 10), (t_param.CSP_I444, 8),
    (t_param.CSP_I422, 12), (t_param.CSP_I400, 8)])
def test_y4m_and_yuv_io_match_jax(tmp_path, csp, depth):
    """The same bytes from both writers, the same frames and info from
    both readers, and the frames read back equal those written."""
    rng = np.random.default_rng(csp * 16 + depth)
    w, h = 48, 32
    frames = _yuv_frames(rng, w, h, csp, depth)
    info = dict(width=w, height=h, fps_num=30000, fps_denom=1001, csp=csp,
                bit_depth=depth)
    for ext in ("y4m", "yuv"):
        paths = {}
        for tag, io in (("t", t_io), ("j", j_io)):
            paths[tag] = str(tmp_path / f"{tag}.{ext}")
            wr = io.Y4MWriter(paths[tag], io.VideoInfo(**info)) \
                if ext == "y4m" else io.YUVWriter(paths[tag])
            for f in frames:
                wr.write_frame(*f)
            wr.close()
        with open(paths["t"], "rb") as a, open(paths["j"], "rb") as b:
            assert a.read() == b.read()
        readers = []
        for io in (t_io, j_io):
            r = io.open_input(paths["t"], w, h, (30000, 1001), csp, depth)
            got = []
            while (f := r.read_frame()) is not None:
                got.append(f)
            r.close()
            readers.append((dataclasses.asdict(r.info), got))
        assert readers[0][0] == readers[1][0]
        assert readers[0][0]["frame_count"] == len(frames)
        for got in (readers[0][1], readers[1][1]):
            assert len(got) == len(frames)
            for a, b in zip(got, frames):
                for pa, pb in zip(a, b):
                    assert (pa is None and pb is None) or \
                        np.array_equal(pa, pb)


def test_bitstream_writer_and_bad_input(tmp_path):
    p = str(tmp_path / "s.hevc")
    wr = t_io.RawBitstreamWriter(p)
    wr.write(b"\x00\x00\x01\x40")
    wr.write(b"\x01\x0c")
    wr.close()
    assert wr.bytes_written == 6 and open(p, "rb").read() == \
        b"\x00\x00\x01\x40\x01\x0c"
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"RIFF W8 H8\n")
    with pytest.raises(ValueError):
        t_io.Y4MReader(str(bad))


def test_clip_matches_the_jax_cli_test_clip(tmp_path):
    """preset_pins writes test_cli_presets.py's clip byte for byte: the
    md5s of that file's `_write_clip(path, n)` for n = 6 and 8 (the JAX
    writer; importing that file would point JAX's compilation cache at
    the home directory)."""
    want = {6: "59d23d74b5618fbb6f08859990ff9661",
            8: "411770110b8a41d5eb50a771dd2f748c"}
    for n, md5 in want.items():
        PP.write_clip(str(tmp_path / "t.y4m"), n)
        assert hashlib.md5((tmp_path / "t.y4m").read_bytes()).hexdigest() \
            == md5


@pytest.mark.parametrize("name", sorted(PP.CLI))
def test_cli_matches_pinned_jax_stream(tmp_path, name):
    """The stream, its NAL types (the open GOP's CRA and RASL_N among
    them) and the CSV log, frame by frame."""
    md5, types, csv = PP.run_cli(t_cli.main, name, str(tmp_path),
                                 device="cpu")
    assert (md5, types, csv) == PP.CLI_PINS[name]


def test_api_matches_pinned_jax_stream():
    assert PP.run_api(t_api, device="cpu") == PP.API_PIN


def test_api_ultrafast_matches_pinned_jax_stream():
    assert PP.run_api(t_api, "ultrafast", device="cpu") == \
        PP.API_ULTRAFAST_PIN


def test_cli_streams_decode(tmp_path):
    """An independent decoder (OpenCV's FFmpeg) takes every frame of the
    port's superfast streams, the open GOP's leading pictures included,
    of the ultrafast (depth-1) and of the uniform-grid B stream."""
    cv2 = pytest.importorskip("cv2")
    for name in ("superfast", "superfast_keyint4", "ultrafast",
                 "uniform_b"):
        PP.run_cli(t_cli.main, name, str(tmp_path), device="cpu")
        cap = cv2.VideoCapture(str(tmp_path / f"{name}.hevc"))
        n = 0
        while cap.read()[0]:
            n += 1
        assert n == PP.CLI[name][0], name


def _empty_clip(path):
    """A y4m with a header and no frames: main builds the session and
    writes the headers, and codes nothing."""
    t_io.Y4MWriter(path, t_io.VideoInfo(96, 64, 25, 1, t_param.CSP_I420,
                                        8)).close()


@pytest.mark.parametrize("preset", PRESETS)
def test_every_preset_and_tune_runs_or_names_its_slice(tmp_path, preset):
    """Every preset (ultrafast's depth-1 quadtree included) with every
    tune, with or without weighted prediction, configures its session and
    writes the headers: none raises any more."""
    src, dst = str(tmp_path / "e.y4m"), str(tmp_path / "e.hevc")
    _empty_clip(src)
    for tune in TUNES:
        for extra in ((), ("--no-weightp",)):
            argv = [src, "-o", dst, "--preset", preset, *extra]
            if tune:
                argv += ["--tune", tune]
            assert t_cli.main(argv, device="cpu") == 0
            assert os.path.getsize(dst) > 0


@pytest.mark.parametrize("argv", [
    ["--preset", "superfast", "--tune", "zerolatency"],
    ["--preset", "slow", "--no-weightp", "--bframes", "2"],
    ["--preset", "veryfast", "--tune", "fastdecode", "--keyint", "1"],
], ids=["zerolatency", "slow_no_weightp", "all_intra"])
def test_other_presets_code_decodable_streams(tmp_path, argv):
    """The quadtree IPPP path (zerolatency), RDOQ with intra in B slices
    (slow), and the all-intra session through the CLI: three frames each
    that an independent decoder takes."""
    cv2 = pytest.importorskip("cv2")
    src, dst = str(tmp_path / "c.y4m"), str(tmp_path / "c.hevc")
    PP.write_clip(src, 3)
    assert t_cli.main([src, "-o", dst] + argv, device="cpu") == 0
    cap = cv2.VideoCapture(dst)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 3


@pytest.mark.parametrize("preset", [None] + PRESETS[PRESETS.index(
    "veryfast"):])
def test_weighted_presets_code_decodable_streams(tmp_path, preset):
    """The default command line (no preset flag: medium) and every preset
    from veryfast through placebo, with weighted prediction, over 3 frames
    of the clip fading by 6 a frame: every frame decodes with an
    independent decoder (OpenCV's FFmpeg)."""
    cv2 = pytest.importorskip("cv2")
    src, dst = str(tmp_path / "w.y4m"), str(tmp_path / "w.hevc")
    PP.write_clip(src, 3, -6)
    argv = [src, "-o", dst] + (["--preset", preset] if preset else [])
    assert t_cli.main(argv, device="cpu") == 0
    cap = cv2.VideoCapture(dst)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 3


@pytest.mark.parametrize("flag", [
    # (--ladder, --dhdr10-info, --dolby-vision-rpu and --recon-y4m-exec
    # run in tests/test_torch_ladder.py and test_torch_host_tools.py;
    # --devices in tests/test_torch_parallel.py: these cases hold it with
    # other counts and flags)
    ["--devices", "4"], ["--devices", "2"],
    ["--devices", "2", "--dhdr10-info", "m.json"],
    ["--devices", "3", "--dolby-vision-rpu", "r.bin"],
    ["--devices", "8", "--recon-y4m-exec", "cat"]])
def test_cli_features_without_a_slice_raise(tmp_path, flag):
    """No flag is left without a slice: --devices N codes the pipelined
    stream (parallel/session.PipelinedEncoder), and, as in the
    reference, the flags of the other paths are not read there."""
    from x265_yuuki_asuna_tpu_torch.parallel.session import \
        PipelinedEncoder
    src, dst = str(tmp_path / "e.y4m"), tmp_path / "o.hevc"
    PP.write_clip(src, 2)
    assert t_cli.main([src, "-o", str(dst)] + flag, device="cpu") == 0
    enc = PipelinedEncoder(PP.W, PP.H, n_devices=int(flag[1]),
                           device="cpu")
    res = enc.encode_clip(PP.clip_frames(2))
    assert dst.read_bytes() == enc.headers() + b"".join(r.nals
                                                         for r in res)


def _api_encoder(**parse):
    p = t_api.param_default_preset("superfast")
    t_api.param_parse(p, "input-res", "96x64")
    for k, v in parse.items():
        t_api.param_parse(p, k.replace("_", "-"), v)
    return p, t_api.encoder_open(p, device="cpu")


def _encode_all(enc, p, frames):
    out = []
    for f in frames + [None]:
        pic = None
        if f is not None:
            pic = t_api.picture_init(p, t_api.picture_alloc())
            pic.planes = f
        out += t_api.encoder_encode(enc, pic)
    return out


def test_api_reconfig_ctu_info_and_stats():
    """reconfig changes the rate control mid-stream and refuses geometry;
    ctu_info's offsets reach the QP map; stats count every frame."""
    frames = PP.clip_frames(3)
    p, enc = _api_encoder(bframes="0")
    base = _encode_all(enc, p, frames)
    assert enc.get_stats().encoded_picture_count == 3
    p2, enc2 = _api_encoder(bframes="0")
    q = p2.copy()
    t_api.param_parse(q, "crf", "40")
    assert t_api.encoder_reconfig(enc2, q) == 0
    assert enc2._sess.rc.cfg.crf == 40.0
    geo = p2.copy()
    t_api.param_parse(geo, "input-res", "64x64")
    assert t_api.encoder_reconfig(enc2, geo) == -1
    assert sum(map(len, _encode_all(enc2, p2, frames))) < \
        sum(map(len, base))
    p3, enc3 = _api_encoder(bframes="0")
    assert enc3.ctu_info(np.zeros((1, 1))) == -1
    assert enc3.ctu_info(np.full((2, 3), -6)) == 0
    assert enc3._sess.pps.cu_qp_delta == 1
    out3 = _encode_all(enc3, p3, frames)
    assert sum(map(len, out3)) > sum(map(len, base))
    assert enc3.get_stats().encoded_picture_count == 3


def test_api_all_intra_session():
    p = t_api.param_default_preset("superfast")
    for k, v in (("input-res", "96x64"), ("qp", "30"), ("keyint", "1"),
                 ("bframes", "0")):
        t_api.param_parse(p, k, v)
    enc = t_api.encoder_open(p, device="cpu")
    assert not enc._video and enc._sess.max_depth == 2
    assert len(_encode_all(enc, p, PP.clip_frames(2))) == 2
    assert enc.reconfig(p) == -1 and enc.ctu_info(None) == -1


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(PP.CLI))
def test_cli_pins_recomputed_from_the_jax_cli(tmp_path, name):
    """Where the CLI pins come from: the JAX CLI on the same clip (its
    quadtree programs compile for minutes)."""
    from x265_yuuki_asuna_tpu import cli as j_cli
    assert PP.run_cli(j_cli.main, name, str(tmp_path)) == \
        PP.CLI_PINS[name]


@pytest.mark.slow
def test_api_pin_recomputed_from_the_jax_library():
    from x265_yuuki_asuna_tpu import api as j_api
    assert PP.run_api(j_api) == PP.API_PIN


@pytest.mark.slow
def test_api_ultrafast_pin_recomputed_from_the_jax_library():
    from x265_yuuki_asuna_tpu import api as j_api
    assert PP.run_api(j_api, "ultrafast") == PP.API_ULTRAFAST_PIN


def test_open_gop_session_codes_cra_and_rasl():
    """A quadtree B session with open_gop and keyint 4: frame 4 is a CRA
    at POC 4 (not an IDR) coded before its three RASL_N leading pictures,
    the next mini-GOP continues the POCs; without open_gop frame 4 is an
    IDR after the mini-GOP it closes. An IPPP session ignores open_gop, as
    the reference does."""
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    frames = PP.clip_frames(8)

    def run(**kw):
        s = VideoEncoderSession(PP.W, PP.H, qp=30, max_depth=2, keyint=4,
                                device="cpu", **kw)
        if not kw.get("bframes"):
            res = [s.encode_frame(*f) for f in frames]
        else:
            res = [r for f in frames for r in s.push_frame(*f)] + s.flush()
        stream = s.headers() + b"".join(r.nals for r in res)
        types = [t for t in PP.nal_types(stream) if t < 32]
        return [(r.poc, r.frame_type) for r in res], types, stream

    b = dict(bframes=3, b_adapt=0)
    order, types, _ = run(open_gop=True, **b)
    assert order[:5] == [(0, "I"), (4, "I"), (1, "b"), (2, "b"), (3, "b")]
    assert types[:5] == [19, 21, 8, 8, 8]
    assert order[5:] == [(7, "P"), (6, "B"), (5, "b")]
    order, types, _ = run(**b)
    assert order[4:6] == [(0, "I"), (3, "P")] and types.count(19) == 2
    assert run(open_gop=True)[2] == run()[2]


def _jax_csv_header(level2: bool) -> str:
    """The JAX CLI's CSV header, read from the source of its main (running
    it would compile its quadtree programs)."""
    import inspect
    import re
    from x265_yuuki_asuna_tpu import cli as j_cli
    src = inspect.getsource(j_cli.main)
    base = re.search(r'csv_header = \(\s*"([^"]*)"\s*"([^"]*)"\)', src)
    extra = re.search(r'csv_header \+= "([^"]*)"', src)
    return base.group(1) + base.group(2) + (extra.group(1) if level2 else "")


def test_csv_level2_columns_match_jax(tmp_path):
    """--csv-log-level 2 writes the reference's header (Device, Deblock,
    SAO and Serialize ms after the quality columns) and a value in each of
    its columns on every frame line. x265's default preset without B
    frames takes the host-filter quadtree path, whose deblock and SAO are
    timed in their own columns."""
    src, dst = str(tmp_path / "c.y4m"), str(tmp_path / "c.hevc")
    csv = str(tmp_path / "c.csv")
    PP.write_clip(src, 3, -6)
    assert t_cli.main([src, "-o", dst, "--bframes", "0", "--csv", csv,
                       "--csv-log-level", "2"], device="cpu") == 0
    with open(csv) as f:
        lines = f.read().splitlines()
    head = _jax_csv_header(True)
    assert head.endswith(", Device ms, Deblock ms, SAO ms, Serialize ms")
    assert lines[0] == head
    rows = [r.split(", ") for r in lines[1:-1]]
    assert len(rows) == 3
    assert all(len(r) == len(head.split(", ")) for r in rows)
    assert sum(float(r[-3]) + float(r[-2]) for r in rows) > 0
    # level 1 keeps the reference's quality columns only
    assert t_cli.main([src, "-o", dst, "--bframes", "0", "--csv", csv],
                      device="cpu") == 0
    with open(csv) as f:
        assert f.readline().rstrip("\n") == _jax_csv_header(False)


def test_qpfile_qp_goes_through_the_ip_offset(tmp_path):
    """Why tests/test_cli_presets.py::test_cli_qpfile_and_chunk fails (its
    command line, weighted prediction on): the reference CLI writes a
    qpfile QP into the rate control's
    base QP, so a forced I frame at "25" is coded at 25 - 3 = 22 (CQP's
    I-frame offset), and the QP stays 25 for the P frames after it until
    the next line; x265 codes the line's QP on that frame alone. The
    port reproduces it."""
    src, dst = str(tmp_path / "in.y4m"), str(tmp_path / "o.hevc")
    csv, qpf = str(tmp_path / "log.csv"), str(tmp_path / "qp.txt")
    PP.write_clip(src, 8)
    with open(qpf, "w") as f:
        f.write("3 I 25\n5 P 40\n")
    assert t_cli.main([src, "-o", dst, "--qp", "32", "--keyint", "100",
                       "--bframes", "0", "--qpfile", qpf, "--csv", csv,
                       "--chunk-start", "1", "--chunk-end", "6",
                       "--no-hash"], device="cpu") == 0
    with open(csv) as f:
        rows = [r.split(", ") for r in f.read().splitlines()[1:-1]]
    assert [(r[1], int(r[3])) for r in rows] == [
        ("I", 29), ("P", 32), ("I", 22), ("P", 25), ("P", 40), ("P", 40)]


def test_open_gop_leading_pictures_lose_their_reference(tmp_path):
    """A reference fault the port reproduces (ROADMAP Queue 3): the CRA's
    slice header carries the default one-picture RPS (POC - 1, used), so
    decoding the CRA marks the previous anchor (POC 0) unused while its
    RASL pictures still reference it. libde265, which follows the spec,
    substitutes a generated picture: the three leading pictures decode
    off the encoder's recon (by up to 128), every other frame exactly;
    FFmpeg keeps the picture and matches everywhere."""
    from x265_yuuki_asuna_tpu.utils import av_decode, de265_decode
    if not de265_decode.available():
        pytest.skip("libde265 is not installed")
    src, dst = str(tmp_path / "in.y4m"), str(tmp_path / "o.hevc")
    rec = str(tmp_path / "rec.yuv")
    PP.write_clip(src, 8)
    assert t_cli.main([src, "-o", dst, "--preset", "superfast", "--keyint",
                       "4", "--recon", rec], device="cpu") == 0
    with open(dst, "rb") as f:
        data = f.read()
    want = np.fromfile(rec, np.uint8).reshape(8, -1)[:, :PP.W * PP.H]
    err = lambda frames: [int(np.abs(np.asarray(f[0], np.int32).reshape(-1)
                                     - w).max())
                          for f, w in zip(frames, want)]
    de265 = err(de265_decode.decode_hevc_de265(data))
    assert [e > 0 for e in de265] == [False, True, True, True, False,
                                      False, False, False]
    assert err(av_decode.decode_hevc(data, PP.W, PP.H)) == [0] * 8
