"""The command line's and the library's test clip and the JAX package's
pins over it, shared by tests/test_torch_cli_api.py and chip_smoke.py
(this module imports neither JAX nor the JAX package).

The clip is tests/test_cli_presets.py's (`_write_clip`): 96x64 8-bit 4:2:0
at 25 fps, a random texture moving 1 pixel down and 2 right a frame, flat
chroma; write_clip writes the same y4m bytes with the port's writer.

CLI holds, for each command line, the frames it reads and its flags;
RAMP the luma ramp (added to Y per frame, clipped) of the command lines
and the library preset that run weighted prediction; CLI_PINS the md5 of the JAX CLI's stream
(x265_yuuki_asuna_tpu.cli.main with `--csv`), its NAL unit types and its
CSV log. API_PIN is the JAX library's stream of the clip's 6 frames at
param_default_preset("superfast") (api.Encoder: the CTU32 depth-2
quadtree, b-adapt 2, search range 24, psy-rd 2, CRF 28, deblock, sign
hiding, no hash SEI), API_MEDIUM_PIN the same at "medium" over the
ramped clip (weighted prediction, SAO, AQ 2, cuTree, bframes 4).
API_ULTRAFAST_PIN the same at "ultrafast". WEIGHTS holds the weights each
weighted case's session chose for its P frames, in coding order. The pins
up to medium_no_weightp were computed from the JAX package at commit
1f6f0ca, the weighted ones at 59bcfbb, ultrafast, uniform_b and
API_ULTRAFAST_PIN at d580939, on the CPU; the slow tests of
tests/test_torch_cli_api.py and tests/test_torch_weightp.py recompute
them."""
import hashlib

import numpy as np

W, H = 96, 64
CLI = {
    # x265's superfast: the quadtree, fixed mini-GOPs of 4, CRF 28,
    # deblock, sign hiding, psy-rd 2, intra in B slices, open GOP, MD5 SEI
    "superfast": (6, ["--preset", "superfast"]),
    # the same with a keyframe every 4 frames: the CRA at POC 4 and its
    # three RASL_N leading pictures
    "superfast_keyint4": (8, ["--preset", "superfast", "--keyint", "4"]),
    # x265's default preset without weighted prediction: + SAO, AQ 2,
    # cuTree, b-adapt 2, bframes 4
    "medium_no_weightp": (6, ["--preset", "medium", "--no-weightp"]),
    # x265's default command line (no preset flag: medium) and veryfast,
    # both with weighted prediction, over the clip fading by 6 a frame
    "medium": (6, []),
    "veryfast": (6, ["--preset", "veryfast"]),
    # x265's ultrafast: the CTU32 depth-1 quadtree (min CU 16), fixed
    # mini-GOPs of 4, CRF 28, no deblock, SAO, AQ or cuTree, psy-rd 2,
    # intra in B slices (no HME: the CLI's --merange stays 16)
    "ultrafast": (6, ["--preset", "ultrafast"]),
    # the default preset on the uniform 16x16 grid with three B frames
    # (b-adapt 2, weighted P anchors, SAO, AQ 2) over the fading clip
    "uniform_b": (6, ["--ctu", "16", "--min-cu-size", "16", "--bframes",
                      "3"]),
}
# by CLI case or library preset
RAMP = {"medium": -6, "veryfast": -6, "uniform_b": -6}
_HEAD = "Encode Order, Type, POC, QP, Bits, PSNR Y, PSNR U, PSNR V, SSIM Y\n"
CLI_PINS = {
    "superfast": (
        "320c78feeaa5c38d63564114fb747e37",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40, 1, 40],
        _HEAD +
        "0, I, 0, 25, 31576, 36.7834, 99.9900, 99.9900, 0.99873\n"
        "1, b, 1, 40, 784, 31.7768, 44.7729, 99.9900, 0.99709\n"
        "2, B, 2, 41, 784, 30.4615, 42.1102, 99.9900, 0.99614\n"
        "3, b, 3, 39, 832, 30.2747, 41.1547, 99.9900, 0.99577\n"
        "4, P, 4, 35, 4656, 30.3667, 40.3493, 99.9900, 0.99527\n"
        "5, P, 5, 36, 2952, 29.5218, 37.8867, 99.9900, 0.99474\n"
        "Summary, frames=6, kbps=173.27, Global PSNR Y=31.5308, "
        "U=51.0440, V=99.9900, SSIM Y=0.99629\n"),
    "superfast_keyint4": (
        "520cb0e5ff9fb0fde7d134e988c61610",
        [32, 33, 34, 39, 19, 40, 21, 40, 8, 40, 8, 40, 8, 40, 1, 40, 1, 40,
         0, 40],
        _HEAD +
        "0, I, 0, 25, 31576, 36.7834, 99.9900, 99.9900, 0.99873\n"
        "1, b, 1, 44, 720, 31.4952, 43.8711, 99.9900, 0.99677\n"
        "2, b, 2, 42, 776, 31.2036, 42.1557, 99.9900, 0.99658\n"
        "3, b, 3, 41, 832, 31.9996, 41.7626, 99.9900, 0.99709\n"
        "4, I, 4, 32, 23232, 29.4786, 99.9900, 55.9123, 0.99304\n"
        "5, b, 5, 39, 816, 27.7360, 48.1365, 56.4729, 0.99104\n"
        "6, B, 6, 39, 936, 27.2769, 46.9133, 56.7725, 0.99007\n"
        "7, P, 7, 37, 3880, 26.8078, 40.1145, 57.3940, 0.98888\n"
        "Summary, frames=8, kbps=196.15, Global PSNR Y=30.3476, "
        "U=57.8667, V=78.3140, SSIM Y=0.99403\n"),
    "medium_no_weightp": (
        "3f8c9b1981b96c7ebd25efa7128c06b2",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 28120, 33.9182, 99.9900, 99.9900, 0.99756\n"
        "1, b, 1, 40, 720, 28.6447, 45.7952, 99.9900, 0.99422\n"
        "2, b, 2, 38, 832, 28.1596, 41.7528, 99.9900, 0.99294\n"
        "3, B, 3, 40, 920, 27.2132, 40.9921, 99.9900, 0.99046\n"
        "4, b, 4, 37, 928, 26.9735, 39.2269, 99.9900, 0.98936\n"
        "5, P, 5, 35, 4976, 26.4896, 39.4234, 99.9900, 0.98752\n"
        "Summary, frames=6, kbps=152.07, Global PSNR Y=28.5665, "
        "U=51.1967, V=99.9900, SSIM Y=0.99201\n"),
    # veryfast differs from medium only in options the sessions do not
    # read (lookahead depth, subpel, references, RD level, early skip,
    # fast intra, merge candidates): the same stream on this clip
    "medium": (
        "7201e08089f3aef8b5b2e4e5beef92e2",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 1, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 28120, 33.9182, 99.9900, 99.9900, 0.99756\n"
        "1, b, 1, 39, 816, 28.4076, 48.2222, 99.9900, 0.99359\n"
        "2, B, 2, 40, 832, 27.4178, 42.4719, 99.9900, 0.99154\n"
        "3, P, 3, 35, 3968, 27.3818, 40.1145, 99.9900, 0.99077\n"
        "4, b, 4, 39, 872, 26.5698, 41.8290, 99.9900, 0.98828\n"
        "5, P, 5, 36, 3208, 25.9996, 49.6364, 99.9900, 0.98581\n"
        "Summary, frames=6, kbps=157.57, "
        "Global PSNR Y=28.2825, U=53.7107, V=99.9900, SSIM Y=0.99126\n"),
    "veryfast": (
        "7201e08089f3aef8b5b2e4e5beef92e2",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 1, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 28120, 33.9182, 99.9900, 99.9900, 0.99756\n"
        "1, b, 1, 39, 816, 28.4076, 48.2222, 99.9900, 0.99359\n"
        "2, B, 2, 40, 832, 27.4178, 42.4719, 99.9900, 0.99154\n"
        "3, P, 3, 35, 3968, 27.3818, 40.1145, 99.9900, 0.99077\n"
        "4, b, 4, 39, 872, 26.5698, 41.8290, 99.9900, 0.98828\n"
        "5, P, 5, 36, 3208, 25.9996, 49.6364, 99.9900, 0.98581\n"
        "Summary, frames=6, kbps=157.57, "
        "Global PSNR Y=28.2825, U=53.7107, V=99.9900, SSIM Y=0.99126\n"),
    "ultrafast": (
        "c2e6da9576d460784fb8e3a2bcb9c6b9",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40, 1, 40],
        _HEAD +
        "0, I, 0, 25, 31920, 36.7952, 99.9900, 99.9900, 0.99873\n"
        "1, b, 1, 40, 936, 28.5469, 45.3677, 99.9900, 0.99397\n"
        "2, B, 2, 41, 1024, 27.9449, 42.2950, 99.9900, 0.99247\n"
        "3, b, 3, 39, 992, 28.0234, 44.7742, 99.9900, 0.99240\n"
        "4, P, 4, 35, 6592, 28.4697, 99.9900, 99.9900, 0.99242\n"
        "5, P, 5, 36, 3744, 27.7919, 48.1308, 99.9900, 0.99190\n"
        "Summary, frames=6, kbps=188.37, Global PSNR Y=29.5953, "
        "U=63.4246, V=99.9900, SSIM Y=0.99365\n"),
    "uniform_b": (
        "51f65c4d6628704cf286928ad5746827",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 1, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 28544, 33.7532, 99.9900, 99.9900, 0.99745\n"
        "1, b, 1, 40, 928, 25.5365, 48.1308, 99.9900, 0.98804\n"
        "2, B, 2, 40, 920, 24.9203, 42.1102, 99.9900, 0.98494\n"
        "3, P, 3, 35, 4792, 25.2102, 38.5884, 99.9900, 0.98427\n"
        "4, b, 4, 39, 1184, 23.8638, 39.5274, 99.9900, 0.97882\n"
        "5, P, 5, 37, 3328, 23.2319, 99.9900, 99.9900, 0.97310\n"
        "Summary, frames=6, kbps=165.40, Global PSNR Y=26.0860, "
        "U=61.3895, V=99.9900, SSIM Y=0.98444\n"),
}
API_FRAMES = 6
# (md5, NAL unit types, bytes of each frame's NALs in coding order)
API_PIN = ("41404b38e465bb9fe63219d4da47b58f",
           [32, 33, 34, 39, 19, 1, 1, 0, 1, 0],
           [3889, 497, 40, 44, 439, 49])
API_MEDIUM_PIN = ("3d25cb9e510e276314d2999beaa3c03c",
                  [32, 33, 34, 39, 19, 1, 1, 0, 1, 0],
                  [3457, 443, 46, 44, 368, 53])
# the library at "ultrafast": the depth-1 quadtree, b-adapt 2 (the
# library passes none), search range 24, psy-rd 2, no filters, CRF 28
API_ULTRAFAST_PIN = ("f0ddfcab41d13eede1d1c95baabe0d4b",
                     [32, 33, 34, 39, 19, 1, 1, 0, 1, 0],
                     [3932, 690, 53, 56, 551, 69])
# the weights of each weighted case's P frames in coding order (None: no
# component's weight was kept)
WEIGHTS = {name: [None, {"luma": (60, -8), "cb": (6, 86)}]
           for name in ("medium", "veryfast", "api_medium")}


def clip_frames(n: int, ramp: int = 0):
    """The clip's first n frames, (y, u, v) uint8 planes; ramp * i is
    added to frame i's luma (clipped to 0..255)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (H + 32, W + 32)).astype(np.uint8)
    return [(np.clip(base[i:i + H, 2 * i:2 * i + W].astype(np.int32)
                     + ramp * i, 0, 255).astype(np.uint8),
             np.full((H // 2, W // 2), 90 + i, np.uint8),
             np.full((H // 2, W // 2), 140, np.uint8)) for i in range(n)]


def write_clip(path: str, n: int, ramp: int = 0) -> None:
    """The clip's first n frames as a y4m file (the port's writer)."""
    from x265_yuuki_asuna_tpu_torch.utils import io as IO
    wr = IO.Y4MWriter(path, IO.VideoInfo(W, H, 25, 1, IO.CSP_I420, 8))
    for f in clip_frames(n, ramp):
        wr.write_frame(*f)
    wr.close()


def nal_types(stream: bytes) -> list:
    """The NAL unit type of every NAL of an Annex-B stream, in order."""
    out, i = [], 0
    while True:
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            return out
        out.append((stream[j + 3] >> 1) & 63)
        i = j + 3


def run_cli(cli_main, name: str, workdir: str, **kw):
    """One CLI case in workdir: (stream md5, NAL types, CSV text)."""
    n, flags = CLI[name]
    src, dst = f"{workdir}/{name}.y4m", f"{workdir}/{name}.hevc"
    csv = f"{workdir}/{name}.csv"
    write_clip(src, n, RAMP.get(name, 0))
    assert cli_main([src, "-o", dst, "--csv", csv] + flags, **kw) == 0
    with open(dst, "rb") as f:
        data = f.read()
    with open(csv) as f:
        return hashlib.md5(data).hexdigest(), nal_types(data), f.read()


def run_api(api, preset: str = "superfast", **kw):
    """The library case at `preset` ("superfast", or "medium" over the
    ramped clip): (stream md5, NAL types, each call's NAL bytes)."""
    p = api.param_default_preset(preset)
    api.param_parse(p, "input-res", f"{W}x{H}")
    api.param_parse(p, "fps", "25")
    enc = api.encoder_open(p, **kw)
    stream, sizes = api.encoder_headers(enc), []
    for f in clip_frames(API_FRAMES, RAMP.get(preset, 0)) + [None]:
        pic = None
        if f is not None:
            pic = api.picture_init(p, api.picture_alloc())
            pic.planes = f
        for nals in api.encoder_encode(enc, pic):
            stream += nals
            sizes.append(len(nals))
    api.encoder_close(enc)
    return hashlib.md5(stream).hexdigest(), nal_types(stream), sizes
