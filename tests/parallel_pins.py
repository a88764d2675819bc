"""The multi-slot pipeline (parallel/*, PipelinedEncoder, --devices):
inputs, runners and the JAX package's pins over them, shared by
tests/test_torch_parallel.py and chip_smoke.py (this module imports
neither JAX nor the JAX package).

The inputs are those of tests/test_multichip.py and
tests/test_pipeline_session.py. The digests are sha256 (tools_pins.digest)
of the JAX programs' dicts (`_unpack` of the mesh outputs, 8 or 4 virtual
CPU devices); the streams' entries are md5s of the JAX package's
streams. Every pin was computed from the JAX package on the CPU; the slow
tests of tests/test_torch_parallel.py recompute them. The JAX CLI's
--devices fails on every input (its readers are not iterable, ROADMAP
Queue 3): CLI_PINS were taken with the reader made iterable, which is
the stream its pipeline writes."""
import hashlib
import os

import numpy as np

from tools_pins import digest  # noqa: F401  (the dicts' sha256)

# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def frame_parallel_inputs():
    """test_frame_parallel_mesh_bit_exact's 8 random 64x48 frames."""
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (8, 48, 64)).astype(np.uint8),
            rng.integers(0, 256, (8, 24, 32)).astype(np.uint8),
            rng.integers(0, 256, (8, 24, 32)).astype(np.uint8))


BANDS, BAND_W, BAND_H = 4, 64, 64


def band_inputs():
    """test_slice_bands_mesh_stream_bit_exact's 64x64 picture."""
    rng = np.random.default_rng(1)
    H, W = BAND_H, BAND_W
    return (rng.integers(0, 256, (H, W)).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8))


def _idr(rng, H, W):
    return [rng.integers(0, 256, s).astype(np.uint8)
            for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]


PIPE_N, PIPE_W, PIPE_H = 4, 64, 48          # the fill: one chain
STREAM_T, STREAM_W, STREAM_H = 3, 64, 32    # T chains of PIPE_N
SEARCH_RANGE = 8


def pipeline_inputs():
    """test_frame_pipeline_cross_device_bit_exact's chain: (y[N], u, v,
    idr_y, idr_u, idr_v)."""
    N, W, H = PIPE_N, PIPE_W, PIPE_H
    rng = np.random.default_rng(3)
    base = rng.integers(0, 200, (H, W)).astype(np.int32)
    ys = np.stack([(base + 3 * i).clip(0, 255).astype(np.uint8)
                   for i in range(N)])
    us = rng.integers(0, 256, (N, H // 2, W // 2)).astype(np.uint8)
    vs = rng.integers(0, 256, (N, H // 2, W // 2)).astype(np.uint8)
    return (ys, us, vs, *_idr(rng, H, W))


def pipeline_stream_inputs():
    """test_frame_pipeline_stream_steady_state's T chains: (y[T, N], u,
    v, idr_y, idr_u, idr_v)."""
    N, T, W, H = PIPE_N, STREAM_T, STREAM_W, STREAM_H
    rng = np.random.default_rng(4)
    ys = rng.integers(0, 256, (T, N, H, W)).astype(np.uint8)
    us = rng.integers(0, 256, (T, N, H // 2, W // 2)).astype(np.uint8)
    vs = rng.integers(0, 256, (T, N, H // 2, W // 2)).astype(np.uint8)
    return (ys, us, vs, *_idr(rng, H, W))


def session_clip(w: int, h: int, n: int):
    """tests/test_pipeline_session.py's clip: a gradient with a moving
    texture."""
    rng = np.random.default_rng(9)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 40, (h, w)).astype(np.uint8)
    out = []
    for i in range(n):
        y = (base + np.roll(tex, (i, 2 * i), (0, 1)) + i).astype(np.uint8)
        out.append((y, (base[::2, ::2] // 2 + i).astype(np.uint8),
                    ((255 - base[::2, ::2]) // 2).astype(np.uint8)))
    return out


def noise_clip(n: int = 5, w: int = 64, h: int = 48, seed: int = 21):
    """Random planes: at OVERFLOW_QP their levels leave int8."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the JAX package's pins
# ---------------------------------------------------------------------------

FRAME_PARALLEL_DIGESTS = [
    "308da483ed9a9b8775eaa4db34a7bf4c0688514d36c0bce34eebfb24c145d265",
    "5cb61c2c22688bc6e73c57b563086849990094fc6812457cb937fac2d1ace6dd",
    "8a0c954a6e30fd85a9d1d2bb826d743f27fd399e144f6d7992f8981815d65c0c",
    "8c1c0a871f276fdfbf5d1baee2175132f7238311a32f977da8c2b8e7fddfe006",
    "db70090d0ef3d1238716477de49f2b926ec3e99811175d32c2a6d297e6047472",
    "ff6e4b3bbb579943890911bd0746104813eb2a14fdf9f4688c2cdf2fb0fe94f7",
    "a9b4bc998a041c1cf9ecceb9d1366cc5a50ada1084ed4b6f9050bff8011a0d0f",
    "1091aa9643819a5f3fed0e91e7f353c40e6403d7009f2ed6051ae00ec0fa2fb1"]
# the sliced session's stream (headers + the 4 bands), which the mesh's
# bands assemble into
BANDS_MD5 = "b593cab1a6f6191067783fc524395ecf"
PIPELINE_DIGESTS = [
    "32fc10572672cb37bd5ab55ce0a1fd6f8d6bce2231ceabff45aade6075c63b46",
    "687d30f05edf02dbfb09f3186627fb542829d9ae7ac55442e5295ba8dda6f286",
    "8c5b76f0a2d5d529c9a01b4289adcd484eba2030612d92dbc0c15ad865921830",
    "d8f157101022d0e7b07dc3bc24012e69f9c6ed96c6902c0b711a2913ced927f0"]
PIPELINE_STREAM_DIGESTS = [
    ["15b53bfcb3f512dd74cf1ecd5338b02ff4c06052262bba3f5e96b70be83eebb4",
     "b1d8514ac1df7f86134869ef8b2b55da73218aa692699a31545911c255639560",
     "f3831832f5e0b75e2da077f9c63f7a05fc760ba30cde19b7f03804725f0882a5",
     "e8c4ba71cf212b52d6f74ec9d8122eea58f586e78f3e5d62b0dc224bb4718879"],
    ["7063a6ff78ab055e0a43e308e823ff107b61ceecbc4590f9c37e827ff81d3dde",
     "e6d8eb853a99b5fb6a07c9cb5e15f45d9cb565492077e3d0d7752a6479a244be",
     "533cd5c8ff0355a9452500e2386031304ef49cc3ef56a7a32b03af5cca5b33d9",
     "fad17f7f3aea7c92bb4522341cc2b72d3fb7120f0ec9d0da043537b19024afbb"],
    ["53748473ecd6b44a3c7ddfbf7ca81cc39f18711859107722e8ade68ab6906d40",
     "320268a674e43f01fc8a2eef03b949d63721a822332e1ed0d47ada519b4dde12",
     "852d0ce0804e15ce4fe7ce9642575ba8d921f2072e2656fa73334a5279507472",
     "917174e29a9b28d42c5cda57d4325d2841c028d7a34a3ce39b972f130e0de8dd"]]

# PipelinedEncoder(64, 48, n_devices=4, **opts).encode_clip over
# session_clip(64, 48, frames): each frame's NALs' md5 and each result's
# QP (the IDR first), and the whole stream's md5
SESSIONS = {
    "qp32": dict(frames=10, opts=dict(qp=32)),
    "qp30": dict(frames=9, opts=dict(qp=30)),
    # per-chain ABR: the programs run at the first chain's QP 39, the
    # later chains' slices carry the rate control's 32 and 25
    "abr100": dict(frames=10, opts=dict(qp=32, rc_mode="abr",
                                        bitrate_kbps=100))}
SESSION_PINS = {
    "qp32": dict(
        stream="0a7e20a01946d17d0fc48d17925b2047", qps=[32] * 10,
        frames=["1f0830e1417e135375d73f6437365334",
                "56379a3e0bace064eadb7e39bfef2b66",
                "6b815c9e59578f4de43fa30e5157c48f",
                "4411587baa57079a2f5f9c5d7c091a76",
                "c154aeec344d675aa6a0777fee18f2a2",
                "8425484f750b9aaaec8a3c5466d3312f",
                "c748d7be786b583791c05b524d764ee4",
                "9713977c50bcf73c37550839a923904b",
                "41aa770101181d3d2cec9dfc816c4b50",
                "b78145c3fbd37a890a1ba453a073245e"]),
    "qp30": dict(
        stream="1862505e33976ab8dc6001ccbe738b0b", qps=[30] * 9,
        frames=["86a3dada06225c6630bf933f525fa098",
                "dfb7a8b3fd78fb88686f1818c77a602e",
                "7067d852f25bdf02fb409c213ce968b0",
                "15d48954f0c718add79af8a0b96d2c7a",
                "fec49aae4d6e9b6b5184abf59507f47c",
                "3257379724479f172fbd7b51225a2783",
                "cdc45d380fea82be00ad433af0d3565d",
                "20b076678e64a69987c4bec073da4ead",
                "7b93cbd843e26c6ae668a1d67cd65763"]),
    "abr100": dict(
        stream="50fec075fbe0dbc47ae067f6b0302269",
        qps=[32, 39, 39, 39, 39, 32, 32, 32, 32, 25],
        frames=["1f0830e1417e135375d73f6437365334",
                "9f7de27371a8e741a0d68bcaad9daa7c",
                "a08135b09c2d25526e4ea687ecb67463",
                "b90995e8c774c009974d15b419b439f1",
                "9c38b95303891041bfdf94b248e9258c",
                "c0149ba3efac01340a747e9b0090ce02",
                "ebfb26c3fe2e5475bd3740cad41a4479",
                "c2d0730ffe6a0cac6075c07814807874",
                "80ec043fe146194d319ae5e201cb0421",
                "081c57d3cab4eca5300a2dd328a5d11f"])}

# encode_clip raises on noise_clip() at this QP (a level outside int8);
# encode_clip_sequential codes it (the stream's md5)
OVERFLOW_QP = 12
OVERFLOW_SEQ_MD5 = "0fedada4bc6552cf39aefd6374693c4c"

# command lines over the y4m of session_clip(64, 48, 10)
CLI_FRAMES = 10
CLI = {"d4": ["--devices", "4"],
       "d4_abr": ["--devices", "4", "--bitrate", "100"],
       "d4_f6_qp27": ["--devices", "4", "--frames", "6", "--qp", "27"],
       "d2": ["--devices", "2"], "d3": ["--devices", "3"],
       "d8": ["--devices", "8"]}
CLI_PINS = {"d4": "0a7e20a01946d17d0fc48d17925b2047",
            "d4_abr": "50fec075fbe0dbc47ae067f6b0302269",
            "d4_f6_qp27": "a6f6b3f8faffa94e296e380962880adb",
            "d2": "f7f37b43f2f98540ccd1cd758cbe9e22",
            "d3": "d577587b74bfb5c498e1f33c608e4233",
            "d8": "7b317378fda4674d578f56d5b85ed784"}

# VideoEncoderSession(64, 48, qp=32, keyint=100, bframes=3) over
# session_clip(64, 48, 7): push 4 frames, flush(2), push 3, flush()
FLUSH_COUNT_PIN = dict(
    stream="ad787cdd167a9a83b3ff187beb5e795b", after_flush2=3,
    frames=[[0, "I", 29], [2, "P", 32], [1, "b", 34], [3, "P", 32],
            [6, "P", 32], [5, "B", 33], [4, "b", 34]])

# item 9b: the JAX video session's uniform 8x8 grid (cu_size=8, qp 32,
# keyint 10) over session_clip(64, 48, 3); libde265 decodes it to the
# recon, FFmpeg refuses its CTU of 8
CU8_MD5 = "8ea7d1716a9cfc8cc3c56272ca6ca669"

# ---------------------------------------------------------------------------
# runners (the port's modules and the slots' device as arguments)
# ---------------------------------------------------------------------------


def md5(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def _home(device):
    """The encoders' own device: the card for device None."""
    return "cuda" if device is None else device


def frame_parallel_dicts(parallel, intra_frame_encoder, device=None,
                         devices=None):
    """The port's frame_parallel_fn over 8 slots (make_slots' device and
    devices) on frame_parallel_inputs."""
    enc = intra_frame_encoder(64, 48, 16, _home(device))
    return parallel.frame_parallel_fn(enc, parallel.make_slots(
        8, device, devices))(*frame_parallel_inputs())


def band_stream(parallel, top, device=None, devices=None) -> bytes:
    """The stream of band_inputs' picture from band_parallel_fn's bands
    (one per slot), through the sliced session's band writer."""
    y, u, v = band_inputs()
    sess = top.IntraEncoderSession(BAND_W, BAND_H, qp=32, cu_size=16,
                                   hash_sei=False, slices=BANDS,
                                   device=_home(device))
    bh = BAND_H // BANDS
    outs = parallel.band_parallel_fn(
        sess.frame_encoder, parallel.make_slots(BANDS, device, devices))(
            y.reshape(BANDS, bh, BAND_W),
            u.reshape(BANDS, bh // 2, BAND_W // 2),
            v.reshape(BANDS, bh // 2, BAND_W // 2))
    addr_bits = max(1, (sess.rows * sess.cols - 1).bit_length())
    return sess.headers() + b"".join(
        sess._band_slice(o, i * sess.band_rows * sess.cols, addr_bits)
        for i, o in enumerate(outs))


def pipeline_dicts(parallel, inter_frame_encoder, device=None,
                   devices=None):
    """frame_pipeline_fn's N dicts on pipeline_inputs."""
    enc = inter_frame_encoder(PIPE_W, PIPE_H, 16, _home(device),
                              search_range=SEARCH_RANGE)
    return parallel.frame_pipeline_fn(enc, parallel.make_slots(
        PIPE_N, device, devices))(*pipeline_inputs())


def pipeline_stream_dicts(parallel, inter_frame_encoder, device=None,
                          devices=None):
    """frame_pipeline_stream_fn's [T][N] dicts on
    pipeline_stream_inputs."""
    enc = inter_frame_encoder(STREAM_W, STREAM_H, 16, _home(device),
                              search_range=SEARCH_RANGE)
    return parallel.frame_pipeline_stream_fn(
        enc, parallel.make_slots(PIPE_N, device, devices), STREAM_T)(
            *pipeline_stream_inputs())


def run_session(pipelined_encoder, name: str, sequential: bool = False,
                **kw):
    """The PipelinedEncoder session `name` of SESSIONS (kw: its device /
    devices): (the encoder, the results, the stream)."""
    spec = SESSIONS[name]
    enc = pipelined_encoder(64, 48, n_devices=4, **spec["opts"], **kw)
    frames = session_clip(64, 48, spec["frames"])
    res = (enc.encode_clip_sequential if sequential
           else enc.encode_clip)(frames)
    return enc, res, enc.headers() + b"".join(r.nals for r in res)


def session_pin_of(res, stream: bytes) -> dict:
    """A session's entry in SESSION_PINS' form."""
    return dict(stream=md5(stream), qps=[int(r.qp) for r in res],
                frames=[md5(r.nals) for r in res])


def write_cli_input(workdir: str, write_clip) -> str:
    """in.y4m of session_clip(64, 48, CLI_FRAMES) in workdir, written by
    write_clip(path, frames); returns its path."""
    src = os.path.join(workdir, "in.y4m")
    write_clip(src, session_clip(64, 48, CLI_FRAMES))
    return src


def run_cli(cli_main, name: str, workdir: str, src: str, **kw) -> str:
    """The command line `name` of CLI over src: the output's md5, after
    the exit code 0 is checked (kw: cli_main's device)."""
    out = os.path.join(workdir, f"{name}.hevc")
    assert cli_main([src, "-o", out] + CLI[name], **kw) == 0
    with open(out, "rb") as f:
        return md5(f.read())


def run_flush_count(top, **kw):
    """FLUSH_COUNT_PIN's session of the encoder_top module `top`:
    (stream md5, the results' [POC, type, QP], the result count after
    flush(2))."""
    fr = session_clip(64, 48, 7)
    s = top.VideoEncoderSession(64, 48, qp=32, keyint=100, bframes=3, **kw)
    res = []
    for f in fr[:4]:
        res += s.push_frame(*f)
    res += s.flush(2)
    mid = len(res)
    for f in fr[4:]:
        res += s.push_frame(*f)
    res += s.flush()
    return (md5(s.headers() + b"".join(r.nals for r in res)),
            [[int(r.poc), r.frame_type, int(r.qp)] for r in res], mid)
