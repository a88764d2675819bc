"""10- and 12-bit test clips, sessions and command lines, and the JAX
package's pins over them, shared by tests/test_torch_main10.py and
chip_smoke.py (this module imports neither JAX nor the JAX package).

deep(frames, bd) lifts 8-bit frames to bd bits: each sample times
2^(bd-8) plus seeded noise below that step, so every plane holds samples
above 255 and uses its low bits. SESSIONS holds, for each video or intra
session, its clip, its keywords and whether it runs through push_frame /
flush; PINS the md5 of the JAX package's stream of it and each result's
(POC, type, QP) in coding order (an IPPP frame's POC is its distance from
the last IDR). CLI holds the command lines over a 10-bit y4m of
tests/preset_pins.py's clip, CLI_PINS the JAX CLI's stream md5, NAL unit
types and CSV log. All pins were computed from the JAX package at commit
635690c on the CPU; the slow tests of tests/test_torch_main10.py
recompute them."""
import hashlib

import numpy as np

import flagship_pins
import golden_corpus
import preset_pins


def deep(frames, bd: int = 10, seed: int = 11):
    """8-bit (y, u, v) frames lifted to bd bits as uint16 planes."""
    rng = np.random.default_rng(seed)
    s = bd - 8
    return [tuple((p.astype(np.uint16) << s)
                  + rng.integers(0, 1 << s, p.shape).astype(np.uint16)
                  for p in f) for f in frames]


def fade10(frames, step: int = 24):
    """10-bit frames with frame i's luma lowered by step * i (clipped)."""
    return [(np.clip(y.astype(np.int32) - step * i, 0, 1023)
             .astype(np.uint16), u, v) for i, (y, u, v) in enumerate(frames)]


def main12_intra():
    """tests/test_main12.py's intra frame: full-range 12-bit noise."""
    rng = np.random.default_rng(6)
    return [tuple(rng.integers(0, 4096, s).astype(np.uint16)
                  for s in ((48, 64), (24, 32), (24, 32)))]


def main12_inter():
    """tests/test_main12.py's IPPP clip: noise panning 1 pixel a frame,
    flat chroma."""
    rng = np.random.default_rng(8)
    base = rng.integers(0, 4096, (48, 64))
    return [(np.roll(base, i, axis=1).astype(np.uint16),
             np.full((24, 32), 2000 + i, np.uint16),
             np.full((24, 32), 1000 - i, np.uint16)) for i in range(4)]


# bench.py's flagship constructor at 10 bits with the MD5 SEI and recon
FLAGSHIP10 = dict(keyint=250, bframes=3, b_pyramid=True, max_depth=2,
                  rc_mode="crf", crf=28.0, aq_mode=2, cutree=True,
                  deblock=True, sao=True, sbh=True, hash_sei=True, hme=True,
                  bit_depth=10)
LF = dict(deblock=True, sao=True)
B3 = dict(bframes=3, b_pyramid=True, b_adapt=0)

# name: (clip, "intra" | "ippp" | "push", keywords with width and height)
SESSIONS = {
    # the golden clip's uniform grid, 10 bits: deblock + SAO on IPPP
    "uni_lf": (lambda: deep(golden_corpus.clip(n=4)), "ippp",
               dict(width=64, height=48, qp=32, cu_size=16, keyint=100,
                    bit_depth=10, hash_sei=True, **LF)),
    # the uniform grid's B frames (bframes 3, B-pyramid) with the filters
    "uni_b": (lambda: deep(golden_corpus.clip(n=8)), "push",
              dict(width=64, height=48, qp=32, cu_size=16, keyint=100,
                   bit_depth=10, hash_sei=True, **B3, **LF)),
    # the CTU32 quadtree of depth 1 and 2: I, P and B frames, the device
    # filter chain, sign hiding and RDOQ
    "qt1_b_lf": (lambda: deep(golden_corpus.clip(n=8)), "push",
                 dict(width=64, height=48, qp=30, max_depth=1, keyint=100,
                      bit_depth=10, hash_sei=True, sbh=True, **B3, **LF)),
    "qt2_b_lf": (lambda: deep(golden_corpus.clip(n=8)), "push",
                 dict(width=64, height=48, qp=30, max_depth=2, keyint=100,
                      bit_depth=10, hash_sei=True, rdoq=True, **B3, **LF)),
    # weighted prediction on a fade: the host-filter quadtree path
    "qt2_weightp": (lambda: fade10(deep(golden_corpus.clip(n=5))), "ippp",
                    dict(width=64, height=48, qp=30, max_depth=2,
                         keyint=100, bit_depth=10, hash_sei=True,
                         weightp=True, **LF)),
    # the flagship's tools (HME, b-adapt 2, AQ 2, cuTree, CRF 28, SAO,
    # SBH) over flagship_pins' clip, and with the histogram scene cut
    "flagship": (lambda: deep(flagship_pins.clip(8)), "push",
                 dict(width=160, height=96, **FLAGSHIP10)),
    "hist_scenecut": (lambda: deep(flagship_pins.clip()), "push",
                      dict(width=160, height=96, **dict(
                          FLAGSHIP10, hist_scenecut=True, keyint=20))),
    # tests/test_main12.py's two configurations
    "main12_intra": (main12_intra, "intra",
                     dict(width=64, height=48, qp=30, cu_size=16,
                          bit_depth=12, hash_sei=True)),
    "main12_ippp": (main12_inter, "ippp",
                    dict(width=64, height=48, qp=30, cu_size=16, keyint=4,
                         bit_depth=12, hash_sei=True)),
}

PINS = {
    "uni_lf": (
        "a436deaa4afd440c453b1bd3148a4595",
        [(0, "I", 29), (1, "P", 32), (2, "P", 32), (3, "P", 32)]),
    "uni_b": (
        "474e328683f73cede9de63e3fd450021",
        [(0, "I", 29), (4, "P", 32), (2, "B", 33), (1, "b", 34),
         (3, "b", 34), (7, "P", 32), (6, "B", 33), (5, "b", 34)]),
    "qt1_b_lf": (
        "06941802ac46e59a0cc62b532e355812",
        [(0, "I", 27), (4, "P", 30), (2, "B", 31), (1, "b", 32),
         (3, "b", 32), (7, "P", 30), (6, "B", 31), (5, "b", 32)]),
    "qt2_b_lf": (
        "1c8958ca24474c41e7f91b9b6cb07a93",
        [(0, "I", 27), (4, "P", 30), (2, "B", 31), (1, "b", 32),
         (3, "b", 32), (7, "P", 30), (6, "B", 31), (5, "b", 32)]),
    "qt2_weightp": (
        "9fa07a6bb7ab70b28959723c6cb61284",
        [(0, "I", 27), (1, "P", 30), (2, "P", 30), (3, "P", 30),
         (4, "P", 30)]),
    "flagship": (
        "84399769e126c74b29d703ed920da668",
        [(0, "I", 25), (2, "P", 35), (1, "b", 37), (6, "P", 33),
         (4, "B", 37), (3, "b", 37), (5, "b", 37), (7, "P", 34)]),
    "hist_scenecut": (
        "6f611e2e9e530adc08161f320848c672",
        [(0, "I", 25), (1, "P", 35), (0, "I", 32), (1, "P", 36),
         (0, "I", 34), (1, "P", 38), (0, "I", 33), (1, "P", 37),
         (0, "I", 33), (3, "P", 37), (2, "B", 38), (1, "b", 39)]),
    "main12_intra": (
        "65903f82bb38e417dd2f74987c4a4503",
        [(0, "I", 30)]),
    "main12_ippp": (
        "42cdc051dbe5aa05133efa0d8d63d32c",
        [(0, "I", 27), (1, "P", 30), (2, "P", 30), (3, "P", 30)]),
}

# the command lines over CLI_FRAMES of preset_pins' clip at 10 bits
CLI_FRAMES = 5
CLI = {
    "medium": [],
    "superfast": ["--preset", "superfast"],
    "ultrafast": ["--preset", "ultrafast"],
    "intra": ["--keyint", "1", "--qp", "32"],
}
_HEAD = "Encode Order, Type, POC, QP, Bits, PSNR Y, PSNR U, PSNR V, SSIM Y\n"
CLI_PINS = {
    "medium": (
        "80c11944bbfdd7ff2b9b82678174defb",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 28920, 34.0715, 58.7634, 58.7451, 0.99761\n"
        "1, b, 1, 40, 736, 29.4669, 45.5762, 58.3600, 0.99495\n"
        "2, B, 2, 40, 856, 28.2014, 43.9480, 58.5146, 0.99337\n"
        "3, b, 3, 38, 1224, 27.7596, 45.1241, 58.7858, 0.99232\n"
        "4, P, 4, 35, 4744, 27.6167, 43.0084, 58.5319, 0.99128\n"
        "Summary, frames=5, kbps=182.40, Global PSNR Y=29.4232, "
        "U=47.2840, V=58.5875, SSIM Y=0.99391\n"),
    "superfast": (
        "5493e0e1716f4acdceac519e6d7f4e21",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 31688, 36.9338, 54.7046, 54.6847, 0.99876\n"
        "1, b, 1, 40, 816, 31.8826, 49.3766, 54.7901, 0.99709\n"
        "2, B, 2, 41, 776, 30.3694, 43.5950, 54.6728, 0.99591\n"
        "3, b, 3, 39, 912, 30.2727, 42.4131, 54.6863, 0.99567\n"
        "4, P, 4, 35, 4640, 30.3480, 41.1845, 54.6122, 0.99527\n"
        "Summary, frames=5, kbps=194.16, Global PSNR Y=31.9613, "
        "U=46.2547, V=54.6892, SSIM Y=0.99654\n"),
    "ultrafast": (
        "e4fc42313be583074c085ac88dfabf9f",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 32016, 36.9052, 54.7046, 54.6847, 0.99875\n"
        "1, b, 1, 40, 944, 29.0027, 46.1178, 54.7901, 0.99432\n"
        "2, B, 2, 41, 1008, 27.9647, 43.5365, 54.6728, 0.99252\n"
        "3, b, 3, 39, 1048, 28.1199, 46.3114, 54.6863, 0.99254\n"
        "4, P, 4, 35, 6592, 28.5032, 58.6372, 54.6122, 0.99251\n"
        "Summary, frames=5, kbps=208.04, Global PSNR Y=30.0991, "
        "U=49.8615, V=54.6892, SSIM Y=0.99413\n"),
    "intra": (
        "857761721cf05262e7118d634c1ab7d7",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 32, 23696, 29.7085, 54.9662, 54.9299, 0.99337\n"
        "1, I, 0, 32, 23416, 29.5326, 58.2957, 50.7200, 0.99313\n"
        "2, I, 0, 32, 23824, 29.7557, 48.8846, 48.3321, 0.99343\n"
        "3, I, 0, 32, 23656, 29.7495, 48.8919, 54.9823, 0.99345\n"
        "4, I, 0, 32, 21304, 26.7820, 57.0222, 56.6394, 0.98702\n"
        "Summary, frames=5, kbps=579.48, Global PSNR Y=29.1057, "
        "U=53.6121, V=53.1207, SSIM Y=0.99208\n"),
}


def run(top, name: str, **kw):
    """The session `name` of the encoder_top module `top` (the port's or
    the JAX package's) over its clip: (stream md5, [(POC, type, QP)] in
    coding order). kw goes to the session (the port's device)."""
    clip, mode, opts = SESSIONS[name]
    opts = dict(opts)
    w, h = opts.pop("width"), opts.pop("height")
    if mode == "intra":
        s = top.IntraEncoderSession(w, h, **opts, **kw)
    else:
        s = top.VideoEncoderSession(w, h, **opts, **kw)
    stream, res = s.headers(), []
    for f in clip():
        res += s.push_frame(*f) if mode == "push" else [s.encode_frame(*f)]
    if mode == "push":
        res += s.flush()
    stream += b"".join(r.nals for r in res)
    frames, poc = [], 0
    for r in res:
        poc = r.poc if mode == "push" else (0 if r.frame_type == "I"
                                            else poc + 1)
        frames.append((poc, r.frame_type, r.qp))
    return hashlib.md5(stream).hexdigest(), frames, res


def golden_md5(top, **kw) -> str:
    """The golden `intra_main10` (tests/golden_corpus.py): the golden clip
    times 4 at 10 bits through the intra session at QP 32, no hash SEI;
    its md5 is the manifest's."""
    s = top.IntraEncoderSession(64, 48, qp=32, bit_depth=10, hash_sei=False,
                                **kw)
    out = s.headers()
    for f in golden_corpus.clip():
        out += s.encode_frame(*(p.astype(np.uint16) * 4 for p in f)).nals
    return hashlib.md5(out).hexdigest()


def write_clip10(path: str, n: int = CLI_FRAMES, bd: int = 10) -> None:
    """preset_pins' clip's first n frames at bd bits as a y4m file (the
    port's writer)."""
    from x265_yuuki_asuna_tpu_torch.utils import io as IO
    wr = IO.Y4MWriter(path, IO.VideoInfo(preset_pins.W, preset_pins.H, 25, 1,
                                         IO.CSP_I420, bd))
    for f in deep(preset_pins.clip_frames(n), bd):
        wr.write_frame(*f)
    wr.close()


def run_cli(cli_main, name: str, workdir: str, **kw):
    """One 10-bit command line in workdir: (stream md5, NAL types, CSV
    text)."""
    src, dst = f"{workdir}/{name}10.y4m", f"{workdir}/{name}10.hevc"
    csv = f"{workdir}/{name}10.csv"
    write_clip10(src)
    assert cli_main([src, "-o", dst, "--csv", csv] + CLI[name], **kw) == 0
    with open(dst, "rb") as f:
        data = f.read()
    with open(csv) as f:
        return (hashlib.md5(data).hexdigest(), preset_pins.nal_types(data),
                f.read())
