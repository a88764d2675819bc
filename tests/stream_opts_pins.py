"""The uniform CTU32 grid and the all-intra stream options (WPP, slices,
lossless, scaling lists, the CRC and checksum hash SEI): test clips,
sessions, command lines and library calls, and the JAX package's pins
over them, shared by tests/test_torch_stream_opts.py,
tests/test_torch_ctu32.py and chip_smoke.py (this module imports neither
JAX nor the JAX package).

SESSIONS holds, for each session, its clip, its mode ("intra", "batch":
one encode_batch of the whole clip, "ippp", or "push": push_frame /
flush) and its keywords; PINS the md5 of the JAX package's stream of it
and each result's (POC, type, QP) in coding order. CLI holds command
lines over GOLDEN_FRAMES frames of the golden clip (64x48; a scaling-list
file argument "{SL}" is the file write_scaling_file writes),
CLI_PINS the JAX CLI's stream md5, NAL unit types and CSV log. API holds
the library's cases (param_default_preset("medium") with the options
given) over the same frames, API_PINS the JAX library's md5, NAL types
and each call's NAL bytes. All pins were computed from the JAX package
at commit 66ab535 on the CPU; the slow tests of
tests/test_torch_stream_opts.py and tests/test_torch_ctu32.py recompute
them."""
import hashlib

import numpy as np

import golden_corpus
import preset_pins

W, H = 160, 96             # the sessions' clip: 5 x 3 CTUs of 32
GOLDEN_FRAMES = 5          # the command lines' and the library's frames


def synth(n: int, w: int = W, h: int = H, seed: int = 7):
    """bench.py's synth_clip: a gradient with a texture moving 3 pixels
    right and 2 down a frame."""
    rng = np.random.default_rng(seed)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 32, (h, w)).astype(np.uint8)
    return [((base + np.roll(tex, (i * 2, i * 3), axis=(0, 1)) + i * 2)
             .astype(np.uint8), ((base[::2, ::2] // 2) + i).astype(np.uint8),
             ((255 - base[::2, ::2]) // 2).astype(np.uint8))
            for i in range(n)]


def fade(frames, step: int = 6):
    """frames with frame i's luma lowered by step * i (clipped)."""
    return [(np.clip(y.astype(np.int32) - step * i, 0, 255).astype(np.uint8),
             u, v) for i, (y, u, v) in enumerate(frames)]


def deep10(frames):
    """8-bit frames at 10 bits: each sample times 4, as uint16."""
    return [tuple(p.astype(np.uint16) * 4 for p in f) for f in frames]


def one_column(frames, w: int = 16):
    """The frames' first w luma columns (one CTU16 column)."""
    return [(y[:, :w], u[:, :w // 2], v[:, :w // 2]) for y, u, v in frames]


def scaling_lists_text(seed: int = 5) -> str:
    """A scaling-list file in the x265 / HM format (every list of every
    size, the 16x16 and 32x32 DC values) with seeded entries in 8..63."""
    names = (
        ("INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV",
         "INTER4X4_LUMA", "INTER4X4_CHROMAU", "INTER4X4_CHROMAV"),
        ("INTRA8X8_LUMA", "INTRA8X8_CHROMAU", "INTRA8X8_CHROMAV",
         "INTER8X8_LUMA", "INTER8X8_CHROMAU", "INTER8X8_CHROMAV"),
        ("INTRA16X16_LUMA", "INTRA16X16_CHROMAU", "INTRA16X16_CHROMAV",
         "INTER16X16_LUMA", "INTER16X16_CHROMAU", "INTER16X16_CHROMAV"),
        ("INTRA32X32_LUMA", "INTER32X32_LUMA"))
    rng = np.random.default_rng(seed)
    lines = []
    for size, group in enumerate(names):
        for name in group:
            vals = rng.integers(8, 64, 16 if size == 0 else 64)
            lines += [name, ",".join(str(int(x)) for x in vals)]
            if size >= 2:
                lines += [name + "_DC", str(int(rng.integers(8, 64)))]
    return "\n".join(lines) + "\n"


def write_scaling_file(path: str) -> str:
    with open(path, "w") as f:
        f.write(scaling_lists_text())
    return path


B3 = dict(bframes=3, b_pyramid=True, b_adapt=0)
LF = dict(deblock=True, sao=True)
# x265's medium at CTU32 with 32x32 CUs, as the CLI builds it
MEDIUM32 = dict(bframes=4, b_pyramid=True, b_adapt=2, weightp=True, aq_mode=2,
                cutree=True, rc_mode="crf", crf=28.0, **LF)

# name: (clip, mode, keywords with width and height)
SESSIONS = {
    # the uniform CTU32 all-intra grid: WPP over 5 x 3 CTUs with SAO
    # and the deblock, in one batch; single frames with sign hiding, AQ
    # and the CRC; lossless; three slices; a scaling-list file
    "intra32_wpp_lf": (lambda: synth(3), "batch",
                       dict(width=W, height=H, qp=30, cu_size=32, wpp=True,
                            **LF)),
    "intra32_sbh_aq_crc": (lambda: synth(2), "intra",
                           dict(width=W, height=H, qp=30, cu_size=32,
                                sbh=True, aq_mode=2, hash_type=1, **LF)),
    "intra32_lossless": (lambda: synth(2), "intra",
                         dict(width=W, height=H, cu_size=32, lossless=True)),
    "intra32_slices": (lambda: synth(2), "intra",
                       dict(width=W, height=H, qp=32, cu_size=32, slices=3,
                            hash_type=2)),
    # the quadtree intra session with WPP: depth 2 with SAO, the deblock
    # and AQ (QP deltas restart per row), depth 1 plain
    "qt2_wpp_lf_aq": (lambda: synth(2), "intra",
                      dict(width=W, height=H, qp=30, max_depth=2, wpp=True,
                           aq_mode=2, **LF)),
    "qt1_wpp": (lambda: synth(2), "intra",
                dict(width=W, height=H, qp=30, max_depth=1, wpp=True)),
    # one CTU column: every row starts from the slice's contexts
    "wpp_one_column": (lambda: one_column(golden_corpus.clip(n=2)), "intra",
                       dict(width=16, height=48, qp=32, wpp=True)),
    # the checksum at 10 bits, lossless at 10 bits
    "checksum10": (lambda: deep10(golden_corpus.clip(n=2)), "intra",
                   dict(width=64, height=48, qp=32, bit_depth=10,
                        hash_type=2)),
    "lossless10_wpp": (lambda: deep10(golden_corpus.clip(n=2)), "intra",
                       dict(width=64, height=48, bit_depth=10, lossless=True,
                            wpp=True)),
    # the uniform CTU32 video grid: IPPP with the filters, AQ, cuTree and
    # the checksum; weighted IPPP on a fade with the CRC; x265's medium
    # (b-adapt 2, weightp, CRF 28); b-adapt 1 with open GOP; B frames at
    # 10 bits
    "ippp32_lf_aq": (lambda: synth(4), "ippp",
                     dict(width=W, height=H, qp=32, cu_size=32, keyint=100,
                          aq_mode=2, cutree=True, hash_type=2, **LF)),
    "ippp32_weightp": (lambda: fade(synth(4)), "ippp",
                       dict(width=W, height=H, qp=32, cu_size=32, keyint=100,
                            weightp=True, hash_type=1)),
    "b32_medium": (lambda: fade(synth(6)), "push",
                   dict(width=W, height=H, qp=32, cu_size=32, keyint=250,
                        **MEDIUM32)),
    "b32_open_gop": (lambda: synth(8), "push",
                     dict(width=W, height=H, qp=32, cu_size=32, keyint=4,
                          bframes=2, b_adapt=1, open_gop=True)),
    "b32_10bit": (lambda: deep10(golden_corpus.clip(n=5)), "push",
                  dict(width=64, height=48, qp=32, cu_size=32, keyint=100,
                       bit_depth=10, hash_type=1, **B3, **LF)),
}

PINS = {
    "intra32_wpp_lf": (
        "6023e77f3e80c5e74b1c13553a075dbe",
        [(0, 'I', 30), (0, 'I', 30), (0, 'I', 30)]),
    "intra32_sbh_aq_crc": (
        "70d41cb98fad5b15cb5bf1a773f21487",
        [(0, 'I', 30), (0, 'I', 30)]),
    "intra32_lossless": (
        "423fd2cd2dd33bc19543cdbe85e90dc9",
        [(0, 'I', 4), (0, 'I', 4)]),
    "intra32_slices": (
        "0e47a092b2e53937e7a2cd30298014f9",
        [(0, '', 0), (0, '', 0)]),
    "qt2_wpp_lf_aq": (
        "c8e0e3b281817afdb6e8438b49e8fb04",
        [(0, 'I', 30), (0, 'I', 30)]),
    "qt1_wpp": (
        "8d6d9a317fadeaf38f38ce74de2ff31c",
        [(0, 'I', 30), (0, 'I', 30)]),
    "wpp_one_column": (
        "f35826d59aecd960aebb790dc01dfd96",
        [(0, 'I', 32), (0, 'I', 32)]),
    "checksum10": (
        "8911cdc29bdde81aa8f2d7694f5c1e32",
        [(0, 'I', 32), (0, 'I', 32)]),
    "lossless10_wpp": (
        "c81faafba0931dcad6f57e5de0152547",
        [(0, 'I', 4), (0, 'I', 4)]),
    "ippp32_lf_aq": (
        "9602335d37301c904b94e48dbe9188e5",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
    "ippp32_weightp": (
        "d076c39997871de964075ed3fadfea1c",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
    "b32_medium": (
        "0d12427f457be7beaa65d8fd9fa32544",
        [(0, 'I', 25), (3, 'P', 35), (2, 'B', 38), (1, 'b', 38),
         (5, 'P', 36), (4, 'b', 38)]),
    "b32_open_gop": (
        "cea0fa4853f43e5f60a6ab83c191f7f0",
        [(0, 'I', 29), (3, 'P', 32), (2, 'B', 33), (1, 'b', 34),
         (4, 'I', 29), (7, 'P', 32), (6, 'B', 33), (5, 'b', 34)]),
    "b32_10bit": (
        "7b8d6d16d21f7c33ede44e35b56117d9",
        [(0, 'I', 29), (4, 'P', 32), (2, 'B', 33), (1, 'b', 34),
         (3, 'b', 34)]),
}

# the command lines over GOLDEN_FRAMES frames of the golden clip
CLI = {
    "lossless": ["--lossless"],
    "slices3": ["--keyint", "1", "--qp", "32", "--slices", "3"],
    "wpp_ctu32": ["--keyint", "1", "--qp", "32", "--wpp", "--ctu", "32"],
    "scaling_default": ["--no-preset-defaults", "--keyint", "1",
                        "--scaling-lists", "default"],
    "scaling_file": ["--no-preset-defaults", "--keyint", "1",
                     "--scaling-lists", "{SL}"],
    "hash2": ["--hash", "2"],
    "hash3": ["--hash", "3", "--keyint", "1", "--qp", "32"],
    "ctu32_medium": ["--ctu", "32", "--min-cu-size", "32"],
    "ctu32_superfast": ["--ctu", "32", "--min-cu-size", "32", "--preset",
                        "superfast"],
}
_HEAD = "Encode Order, Type, POC, QP, Bits, PSNR Y, PSNR U, PSNR V, SSIM Y\n"
CLI_PINS = {
    "lossless": (
        "544e6e907794ef8dc601073e7ba68aa5",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 4, 28648, 99.9900, 99.9900, 99.9900, 1.00000\n"
        "1, I, 0, 4, 29568, 99.9900, 99.9900, 99.9900, 1.00000\n"
        "2, I, 0, 4, 28944, 99.9900, 99.9900, 99.9900, 1.00000\n"
        "3, I, 0, 4, 29576, 99.9900, 99.9900, 99.9900, 1.00000\n"
        "4, I, 0, 4, 29696, 99.9900, 99.9900, 99.9900, 1.00000\n"
        "Summary, frames=5, kbps=732.16, Global PSNR Y=99.9900, "
        "U=99.9900, V=99.9900, SSIM Y=1.00000\n"),
    "slices3": (
        "a41eaa2dd994f9d76187957aa4f2824d",
        [32, 33, 34, 39, 19, 19, 19, 40, 19, 19, 19, 40, 19, 19, 19, 40,
         19, 19, 19, 40, 19, 19, 19, 40],
        _HEAD +
        "0, I, 0, 32, 4632, 29.6530, 0.0000, 0.0000, 0.00000\n"
        "1, I, 0, 32, 4776, 29.8794, 0.0000, 0.0000, 0.00000\n"
        "2, I, 0, 32, 4632, 29.8004, 0.0000, 0.0000, 0.00000\n"
        "3, I, 0, 32, 4656, 29.8887, 0.0000, 0.0000, 0.00000\n"
        "4, I, 0, 32, 4672, 29.7927, 0.0000, 0.0000, 0.00000\n"
        "Summary, frames=5, kbps=116.84, Global PSNR Y=29.8028, "
        "U=0.0000, V=0.0000, SSIM Y=0.00000\n"),
    "wpp_ctu32": (
        "78a46254641c38e2e122a959236ebe47",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 32, 5008, 28.7298, 46.6141, 43.8226, 0.79579\n"
        "1, I, 0, 32, 5016, 28.7858, 45.9498, 44.6140, 0.79720\n"
        "2, I, 0, 32, 4888, 28.5339, 48.3930, 44.7729, 0.77935\n"
        "3, I, 0, 32, 4832, 28.6905, 47.5003, 46.8224, 0.78635\n"
        "4, I, 0, 32, 5592, 29.5876, 46.9498, 45.7069, 0.81867\n"
        "Summary, frames=5, kbps=126.68, Global PSNR Y=28.8655, "
        "U=47.0814, V=45.1478, SSIM Y=0.79547\n"),
    "scaling_default": (
        "d96a229dc2a518b2a4439d7e82dfe672",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 32, 2648, 26.8978, 43.3483, 43.0364, 0.62785\n"
        "1, I, 0, 32, 2768, 26.9996, 43.1570, 42.9981, 0.64258\n"
        "2, I, 0, 32, 2776, 27.1977, 41.5301, 41.4468, 0.66302\n"
        "3, I, 0, 32, 2688, 27.0558, 41.7288, 41.6747, 0.64685\n"
        "4, I, 0, 32, 2728, 26.9676, 43.3747, 44.5416, 0.64279\n"
        "Summary, frames=5, kbps=68.04, Global PSNR Y=27.0237, "
        "U=42.6278, V=42.7395, SSIM Y=0.64462\n"),
    "scaling_file": (
        "c9eecf4c8bbb75418024862b5933eeb4",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 32, 2840, 26.1300, 37.7728, 37.9687, 0.55572\n"
        "1, I, 0, 32, 2936, 26.4266, 37.8947, 37.8383, 0.57690\n"
        "2, I, 0, 32, 2768, 26.2159, 37.4127, 36.8814, 0.56075\n"
        "3, I, 0, 32, 2680, 26.1792, 37.6430, 36.9628, 0.54391\n"
        "4, I, 0, 32, 2808, 26.1325, 37.2425, 36.3402, 0.54863\n"
        "Summary, frames=5, kbps=70.16, Global PSNR Y=26.2168, "
        "U=37.5931, V=37.1983, SSIM Y=0.55718\n"),
    "hash2": (
        "171bfaa2500a27c0cd0bcbadeba50e6b",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 8880, 37.0274, 50.5302, 49.8748, 0.97092\n"
        "1, b, 1, 39, 496, 30.8576, 42.8097, 43.3146, 0.90783\n"
        "2, B, 2, 40, 616, 28.4994, 41.1366, 41.3639, 0.78012\n"
        "3, b, 3, 38, 584, 28.8430, 40.7036, 41.7587, 0.76070\n"
        "4, P, 4, 35, 2352, 26.5874, 39.1964, 38.7804, 0.57234\n"
        "Summary, frames=5, kbps=64.64, Global PSNR Y=30.3630, "
        "U=42.8753, V=43.0185, SSIM Y=0.79838\n"),
    "hash3": (
        "66256a534334460d6acf8f16b3a74db0",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 32, 4432, 28.9619, 43.4491, 44.4851, 0.81256\n"
        "1, I, 0, 32, 4528, 29.0802, 43.8142, 44.4124, 0.81573\n"
        "2, I, 0, 32, 4416, 28.9047, 43.6018, 44.2567, 0.81327\n"
        "3, I, 0, 32, 4440, 28.7753, 46.0362, 45.8283, 0.80208\n"
        "4, I, 0, 32, 5016, 30.1512, 45.1149, 44.3599, 0.85220\n"
        "Summary, frames=5, kbps=114.16, Global PSNR Y=29.1747, "
        "U=44.4032, V=44.6685, SSIM Y=0.81917\n"),
    "ctu32_medium": (
        "f51d74a4cc9c5c3c88416db3a644f130",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 10928, 36.7261, 50.5499, 49.8917, 0.96849\n"
        "1, b, 1, 40, 912, 29.7982, 46.6421, 46.1998, 0.88197\n"
        "2, B, 2, 40, 1024, 25.8746, 45.6267, 45.1290, 0.52801\n"
        "3, b, 3, 40, 928, 26.4637, 41.7940, 42.4466, 0.56113\n"
        "4, P, 4, 35, 2688, 26.2994, 42.5942, 42.9929, 0.55508\n"
        "Summary, frames=5, kbps=82.40, Global PSNR Y=29.0324, "
        "U=45.4414, V=45.3320, SSIM Y=0.69893\n"),
    "ctu32_superfast": (
        "eb38c83a7af27e39adb78f0d61eb6550",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40],
        _HEAD +
        "0, I, 0, 25, 10096, 36.1233, 50.0209, 50.8354, 0.96377\n"
        "1, b, 1, 40, 880, 29.5424, 46.7808, 47.6445, 0.86020\n"
        "2, B, 2, 40, 944, 25.7483, 44.1946, 43.8945, 0.51533\n"
        "3, b, 3, 40, 864, 26.1928, 43.6018, 44.7055, 0.53262\n"
        "4, P, 4, 35, 2152, 25.4843, 42.9207, 43.3277, 0.48186\n"
        "Summary, frames=5, kbps=74.68, Global PSNR Y=28.6182, "
        "U=45.5038, V=46.0815, SSIM Y=0.67075\n"),
}

# the library at param_default_preset("medium") with these options:
# all-intra (keyint 1, CQP) on the uniform grid with x265's default
# wavefront, and lossless
API = {
    "intra16_wpp": {"keyint": "1", "bframes": "0", "qp": "32", "ctu": "16",
                    "min-cu-size": "16"},
    "intra32_wpp": {"keyint": "1", "bframes": "0", "qp": "32", "ctu": "32",
                    "min-cu-size": "32"},
    "lossless": {"keyint": "1", "bframes": "0", "qp": "32", "lossless": "1",
                 "ctu": "16", "min-cu-size": "16"},
}
API_PINS = {
    "intra16_wpp": (
        "ea05c24842d4f569ffb5a4928b69dc65",
        [32, 33, 34, 39, 19, 19, 19, 19, 19],
        [514, 518, 498, 512, 514]),
    "intra32_wpp": (
        "bcbbe4ff84540c91cf85ad01019685ac",
        [32, 33, 34, 39, 19, 19, 19, 19, 19],
        [576, 578, 561, 554, 546]),
    "lossless": (
        "b97a73dea7a87c1a57fe64b90a35f236",
        [32, 33, 34, 39, 19, 19, 19, 19, 19],
        [3539, 3653, 3576, 3651, 3669]),
}


def run(top, name: str, **kw):
    """The session `name` of the encoder_top module `top` (the port's or
    the JAX package's) over its clip: (stream md5, [(POC, type, QP)] in
    coding order, the results). kw goes to the session (the port's
    device)."""
    clip, mode, opts = SESSIONS[name]
    opts = dict(opts)
    w, h = opts.pop("width"), opts.pop("height")
    cls = top.IntraEncoderSession if mode in ("intra", "batch") \
        else top.VideoEncoderSession
    s = cls(w, h, **opts, **kw)
    stream, res = s.headers(), []
    frames = clip()
    if mode == "batch":
        res = s.encode_batch(frames)
    for f in frames if mode != "batch" else ():
        res += s.push_frame(*f) if mode == "push" else [s.encode_frame(*f)]
    if mode == "push":
        res += s.flush()
    stream += b"".join(r.nals for r in res)
    out, poc = [], 0
    for r in res:
        poc = r.poc if mode == "push" else (0 if r.frame_type in ("I", "")
                                            else poc + 1)
        out.append((poc, r.frame_type, r.qp))
    return hashlib.md5(stream).hexdigest(), out, res


def write_golden_clip(path: str, n: int = GOLDEN_FRAMES) -> None:
    """The golden clip's first n frames as a y4m file (the port's
    writer)."""
    from x265_yuuki_asuna_tpu_torch.utils import io as IO
    wr = IO.Y4MWriter(path, IO.VideoInfo(64, 48, 25, 1, IO.CSP_I420, 8))
    for f in golden_corpus.clip(n=n):
        wr.write_frame(*f)
    wr.close()


def run_cli(cli_main, name: str, workdir: str, **kw):
    """One command line in workdir: (stream md5, NAL types, CSV text)."""
    src, dst = f"{workdir}/{name}.y4m", f"{workdir}/{name}.hevc"
    csv = f"{workdir}/{name}.csv"
    write_golden_clip(src)
    sl = write_scaling_file(f"{workdir}/lists.txt")
    argv = [a.replace("{SL}", sl) for a in CLI[name]]
    assert cli_main([src, "-o", dst, "--csv", csv] + argv, **kw) == 0
    with open(dst, "rb") as f:
        data = f.read()
    with open(csv) as f:
        return (hashlib.md5(data).hexdigest(), preset_pins.nal_types(data),
                f.read())


def run_api(api, name: str, **kw):
    """The library case `name` over the golden clip: (stream md5, NAL
    types, each call's NAL bytes)."""
    p = api.param_default_preset("medium")
    api.param_parse(p, "input-res", "64x48")
    api.param_parse(p, "fps", "25")
    for k, v in API[name].items():
        api.param_parse(p, k, v)
    enc = api.encoder_open(p, **kw)
    stream, sizes = api.encoder_headers(enc), []
    for f in golden_corpus.clip(n=GOLDEN_FRAMES) + [None]:
        pic = None
        if f is not None:
            pic = api.picture_init(p, api.picture_alloc())
            pic.planes = f
        for nals in api.encoder_encode(enc, pic):
            stream += nals
            sizes.append(len(nals))
    api.encoder_close(enc)
    return (hashlib.md5(stream).hexdigest(), preset_pins.nal_types(stream),
            sizes)
