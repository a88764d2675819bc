"""Weighted prediction's test clips and sessions and the JAX package's pins
over them, shared by tests/test_torch_weightp.py and chip_smoke.py (this
module imports neither JAX nor the JAX package).

SESSIONS names each session: its clip, its keywords, and whether it takes
its frames through push_frame / flush (a B session). PINS holds, for each,
the md5 of the JAX package's stream, each frame's (POC, type, QP) in
coding order and the weights the session chose for each P frame in coding
order ({"luma" / "cb" / "cr": (w, o)} at denominator 6, or None).
CLI_FADE_PIN holds the JAX CLI's stream and CSV log with no preset flag
over synth_fade at 416x240; the CLI's and the library's pins over the
96x64 clip live in tests/preset_pins.py with the other CLI pins. All were computed from the JAX package at commit
59bcfbb on the CPU; the slow tests of tests/test_torch_weightp.py
recompute them."""
import contextlib
import hashlib
from unittest import mock

import numpy as np


def rqt_fade(n: int = 5):
    """tests/test_rqt.py::test_qt_weightp_conformance's clip: 64x64 random
    texture fading by 25 a frame, flat chroma."""
    rng = np.random.default_rng(6)
    base = rng.integers(60, 200, (64, 64)).astype(np.int32)
    return [(np.clip(base - 25 * i, 0, 255).astype(np.uint8),
             np.full((32, 32), 110, np.uint8),
             np.full((32, 32), 140, np.uint8)) for i in range(n)]


def golden_fade(n: int):
    """tests/golden_corpus.py's 64x48 clip with the golden ippp_weightp's
    luma ramp: -6 a frame, chroma untouched."""
    rng = np.random.default_rng(3)
    w, h = 64, 48
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 48, (h, w)).astype(np.uint8)
    frames = []
    for i in range(n):
        y = (base + np.roll(tex, (2 * i, 3 * i), (0, 1)) + 2 * i) \
            .astype(np.uint8)
        frames.append((np.clip(y.astype(np.int32) - 6 * i, 0, 255)
                       .astype(np.uint8),
                       ((base[::2, ::2] // 2) + i).astype(np.uint8),
                       ((255 - base[::2, ::2]) // 2).astype(np.uint8)))
    return frames


def golden_clip(n: int):
    """tests/golden_corpus.py's 64x48 clip, no ramp."""
    rng = np.random.default_rng(3)
    w, h = 64, 48
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 48, (h, w)).astype(np.uint8)
    return [((base + np.roll(tex, (2 * i, 3 * i), (0, 1)) + 2 * i)
             .astype(np.uint8),
             ((base[::2, ::2] // 2) + i).astype(np.uint8),
             ((255 - base[::2, ::2]) // 2).astype(np.uint8))
            for i in range(n)]


def pan_fade(n: int, w: int = 160, h: int = 96):
    """A smooth texture panning 20 pixels right and 2 down a frame (past
    the +-16 fine search: HME's coarse MV has to find it) while its luma
    falls by 8 a frame; chroma flat."""
    from flagship_pins import smooth_texture
    t = smooth_texture(np.random.default_rng(8), h + 32, w + 20 * n)
    return [(np.clip(t[2 * i:2 * i + h, 20 * i:20 * i + w] * 0.8 + 20
                     - 8 * i, 0, 255).astype(np.uint8),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 130, np.uint8)) for i in range(n)]


def synth_fade(n: int, w: int = 416, h: int = 240, step: int = 6):
    """bench.py's synth_clip (gradient + moving texture) with its luma
    falling by step a frame (clipped at 0), chroma untouched."""
    rng = np.random.default_rng(7)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 32, (h, w)).astype(np.uint8)
    return [(np.clip((base + np.roll(tex, (i * 2, i * 3), axis=(0, 1))
                      + i * 2).astype(np.uint8).astype(np.int32) - step * i,
                     0, 255).astype(np.uint8),
             ((base[::2, ::2] // 2) + i).astype(np.uint8),
             ((255 - base[::2, ::2]) // 2).astype(np.uint8))
            for i in range(n)]


# name: (clip, session keywords, push_frame / flush)
SESSIONS = {
    # the quadtree IPPP session of tests/test_rqt.py:84 with weightp
    "qt_ippp_weightp": (
        lambda: rqt_fade(5),
        dict(width=64, height=64, qp=30, max_depth=2, keyint=100,
             hash_sei=False, weightp=True), False),
    # its twin without weightp (a stream that must differ from it)
    "qt_ippp_no_weightp": (
        lambda: rqt_fade(5),
        dict(width=64, height=64, qp=30, max_depth=2, keyint=100,
             hash_sei=False), False),
    # fixed mini-GOPs of 4 with the B-pyramid: weighted P anchors 4
    # frames apart, the filters in the host form (SAO at QPs where the
    # host and program forms differ: 29, 32, 34)
    "qt_b_weightp_lf": (
        lambda: golden_fade(9),
        dict(width=64, height=48, qp=32, max_depth=2, keyint=100,
             bframes=3, b_adapt=0, deblock=True, sao=True, hash_sei=True,
             weightp=True), True),
    # HME with weightp: the coarse sweep on the weighted half-resolution
    # reference, the filters in the host form
    "qt_ippp_weightp_hme": (
        lambda: pan_fade(4),
        dict(width=160, height=96, qp=30, max_depth=2, keyint=100,
             hme=True, deblock=True, sao=True, hash_sei=True,
             weightp=True), False),
    # the host-filter path without weightp: deblock and SAO in the host
    # form, AQ 2's per-CTU QP through the host effective QP
    "qt_ippp_host_lf_aq": (
        lambda: golden_clip(6),
        dict(width=64, height=48, qp=32, max_depth=2, keyint=100,
             deblock=True, sao=True, aq_mode=2, dpb_device=False,
             hash_sei=True), False),
}

PINS = {
    "qt_ippp_weightp": (
        "60db3ddf1071b1a4e9bbec0f60502a38",
        [(0, "I", 27), (1, "P", 30), (2, "P", 30), (3, "P", 30),
         (4, "P", 30)],
        [{"luma": (67, -31)}, {"luma": (64, -25)}, {"luma": (62, -21)},
         {"luma": (55, -12)}]),
    "qt_ippp_no_weightp": (
        "372a9a035755c423df8d45f2f2c8e075",
        [(0, "I", 27), (1, "P", 30), (2, "P", 30), (3, "P", 30),
         (4, "P", 30)], []),
    "qt_b_weightp_lf": (
        "6afba09f2d18ea3a4d49d663fe4aa038",
        [(0, "I", 29), (4, "P", 32), (2, "B", 33), (1, "b", 34),
         (3, "b", 34), (8, "P", 32), (6, "B", 33), (5, "b", 34),
         (7, "b", 34)],
        [{"luma": (63, -15), "cb": (66, 3)},
         {"luma": (64, -16), "cb": (73, -1), "cr": (71, -11)}]),
    "qt_ippp_weightp_hme": (
        "e4d92ae3ff3ee719b473ce6ddce51c9f",
        [(0, "I", 27), (1, "P", 30), (2, "P", 30), (3, "P", 30)],
        [None, {"luma": (48, 20)}, None]),
    "qt_ippp_host_lf_aq": (
        "ed4915fd550adf7b432338645025531b",
        [(0, "I", 29), (1, "P", 32), (2, "P", 32), (3, "P", 32),
         (4, "P", 32), (5, "P", 32)], []),
}


@contextlib.contextmanager
def weights_recorded(cls):
    """While open, the weights every session of class cls chose, one
    entry per P frame in coding order (cls._decide_weights wrapped)."""
    got = []
    orig = cls.__dict__["_decide_weights"]
    static = isinstance(orig, staticmethod)
    fn = orig.__func__ if static else orig

    def rec(*args):
        w = fn(*args)
        got.append(None if w is None else
                   {k: tuple(int(x) for x in v) for k, v in w.items()})
        return w
    with mock.patch.object(cls, "_decide_weights",
                           staticmethod(rec) if static else rec):
        yield got


def encode(top, name: str, **kw):
    """The session `name` of the encoder_top module `top` (the port's or
    the JAX package's) over its clip: (stream md5, [(POC, type, QP)] in
    coding order, the weights of each P frame of a weightp session). kw
    goes to the session (the port's device). An IPPP frame's POC is its
    distance from the last IDR (the JAX IPPP path leaves
    FrameResult.poc at 0)."""
    clip, opts, push = SESSIONS[name]
    opts = dict(opts)
    w, h = opts.pop("width"), opts.pop("height")
    with weights_recorded(top.VideoEncoderSession) as weights:
        s = top.VideoEncoderSession(w, h, **opts, **kw)
        stream, res = s.headers(), []
        for f in clip():
            got = s.push_frame(*f) if push else [s.encode_frame(*f)]
            res += got
        if push:
            res += s.flush()
    stream += b"".join(r.nals for r in res)
    frames, poc = [], 0
    for r in res:
        poc = r.poc if push else (0 if r.frame_type == "I" else poc + 1)
        frames.append((poc, r.frame_type, r.qp))
    return (hashlib.md5(stream).hexdigest(), frames,
            weights if opts.get("weightp") else [])


# the command line with no preset flag (x265's medium) over 3 frames of
# synth_fade at 416x240 (104 CTUs): the JAX CLI's stream md5 and CSV log
CLI_FADE_FRAMES = 3
CLI_FADE_PIN = (
    "0074cc926e7325ae8cfedb581a0531d3",
    "Encode Order, Type, POC, QP, Bits, PSNR Y, PSNR U, PSNR V, SSIM Y\n"
    "0, I, 0, 25, 262352, 36.4002, 45.6028, 45.3907, 0.94942\n"
    "1, b, 1, 40, 32536, 26.4314, 34.9135, 34.9899, 0.90565\n"
    "2, P, 2, 35, 67472, 27.6149, 37.5755, 37.8321, 0.58010\n"
    "Summary, frames=3, kbps=3019.67, Global PSNR Y=30.1488, U=39.3639, "
    "V=39.4042, SSIM Y=0.81172\n")


def run_cli_fade(cli_main, workdir: str, **kw):
    """The command line with no preset flag over synth_fade: (stream md5,
    CSV text)."""
    from x265_yuuki_asuna_tpu_torch.utils import io as IO
    src, dst = f"{workdir}/fade.y4m", f"{workdir}/fade.hevc"
    csv = f"{workdir}/fade.csv"
    frames = synth_fade(CLI_FADE_FRAMES)
    wr = IO.Y4MWriter(src, IO.VideoInfo(416, 240, 25, 1, IO.CSP_I420, 8))
    for f in frames:
        wr.write_frame(*f)
    wr.close()
    assert cli_main([src, "-o", dst, "--csv", csv], **kw) == 0
    with open(dst, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    with open(csv) as f:
        return md5, f.read()
