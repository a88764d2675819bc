"""The video session's P-frame options (two L0 references, TMVP,
max_merge, frame duplication) and the P / B WPP substreams: test clips,
sessions, command lines and library calls, and the JAX package's pins
over them, shared by tests/test_torch_p_options.py,
tests/test_torch_wpp_inter.py and chip_smoke.py (this module imports
neither JAX nor the JAX package).

SESSIONS holds, for each session, its clip, its mode ("ippp":
encode_frame, or "push": push_frame / flush) and its keywords; PINS the
md5 of the JAX package's stream of it and each result's (POC, type, QP)
in coding order. CLI holds command lines over GOLDEN_FRAMES frames of the
golden clip (64x48), CLI_PINS the JAX CLI's stream md5, NAL unit types
and CSV log (compared through csv_view). API holds the library's cases
(param_default_preset("medium") with the options given) over the same
frames, API_PINS the JAX library's md5, NAL types and each call's NAL
bytes. All pins were computed from the JAX package at commit bee3014 on
the CPU; the slow tests of tests/test_torch_p_options.py and
tests/test_torch_wpp_inter.py recompute them."""
import hashlib

import numpy as np

import golden_corpus
import preset_pins
import stream_opts_pins

GOLDEN_FRAMES = 5          # the command lines' and the library's frames


def flicker(w: int = 64, h: int = 48, n: int = 8):
    """tests/test_multiref.py's clip: even frames share one random
    texture, odd frames another, each shifted a pixel every two frames;
    the reference two frames back predicts every frame best."""
    rng = np.random.default_rng(21)
    a = rng.integers(0, 256, (h, w)).astype(np.uint8)
    b = rng.integers(0, 256, (h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return [(np.roll(a if i % 2 == 0 else b, i // 2, axis=1).copy(),
             u.copy(), v.copy()) for i in range(n)]


def pan(w: int = 64, h: int = 48, n: int = 7):
    """tests/test_tmvp.py's clip: a window panning 4 pixels a frame over
    a random texture (a steady motion field for TMVP)."""
    rng = np.random.default_rng(13)
    big = rng.integers(0, 256, (h, w + 4 * n)).astype(np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return [(big[:, 4 * i:4 * i + w].copy(), u.copy(), v.copy())
            for i in range(n)]


def repeated(w: int = 64, h: int = 48):
    """tests/test_frame_dup.py's clip: a random frame three times, then
    the same shifted 2 pixels right twice (frames 1, 2 and 4 are
    duplicates)."""
    rng = np.random.default_rng(9)
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    y2 = np.roll(y, 2, axis=1)
    return [(y, u, v), (y, u, v), (y, u, v), (y2, u, v), (y2, u, v)]


def wpp_clip(n: int, w: int = 96, h: int = 64):
    """tests/test_wpp_inter.py's clip: a gradient with a texture moving 1
    pixel down and 2 right a frame (4 CTU rows of 16)."""
    rng = np.random.default_rng(3)
    base = (np.add.outer(np.arange(h), np.arange(w)) % 256).astype(np.uint8)
    tex = rng.integers(0, 40, (h, w)).astype(np.uint8)
    return [((base + np.roll(tex, (i, 2 * i), (0, 1)) + i).astype(np.uint8),
             (base[::2, ::2] // 2 + i).astype(np.uint8),
             ((255 - base[::2, ::2]) // 2).astype(np.uint8))
            for i in range(n)]


UNI = dict(qp=32, cu_size=16, keyint=100, hash_sei=True)
LF = dict(deblock=True, sao=True)
REF2 = dict(n_refs=2, tmvp=True)

# name: (clip, mode, keywords with width and height)
SESSIONS = {
    # two L0 references alone on the flicker clip
    "ref2_flicker": (flicker, "ippp", dict(width=64, height=48, n_refs=2,
                                           **UNI)),
    # TMVP with one and two references on the pan
    "tmvp1_pan": (pan, "ippp", dict(width=64, height=48, tmvp=True, **UNI)),
    "tmvp2_pan": (pan, "ippp", dict(width=64, height=48, **REF2, **UNI)),
    # the uniform CTU32 grid with two references, TMVP, the filters and
    # the CRC
    "ctu32_ref2_tmvp": (lambda: stream_opts_pins.synth(4), "ippp",
                        dict(width=160, height=96, qp=32, cu_size=32,
                             keyint=100, hash_type=1, **REF2, **LF)),
    # 10 bits, two references and TMVP under AQ and cuTree
    "ref2_tmvp_10bit": (lambda: stream_opts_pins.deep10(
        golden_corpus.clip(n=5)), "ippp",
        dict(width=64, height=48, bit_depth=10, aq_mode=2, cutree=True,
             **REF2, **UNI)),
    # max_merge 1 (no merge_idx bins), 2 with the filters, 5 with two
    # references and TMVP; 2 on a uniform B session and on the depth-1
    # quadtree (the native writers)
    "merge1": (golden_corpus.clip, "ippp",
               dict(width=64, height=48, max_merge=1, **UNI)),
    "merge2_lf": (golden_corpus.clip, "ippp",
                  dict(width=64, height=48, max_merge=2, **UNI, **LF)),
    "merge5_ref2_tmvp": (golden_corpus.clip, "ippp",
                         dict(width=64, height=48, max_merge=5, **REF2,
                              **UNI)),
    "merge2_b": (lambda: golden_corpus.clip(n=8), "push",
                 dict(width=64, height=48, max_merge=2, bframes=3,
                      b_adapt=0, **UNI)),
    "merge4_qt1": (lambda: golden_corpus.clip(n=4), "ippp",
                   dict(width=64, height=48, qp=30, max_depth=1, keyint=100,
                        max_merge=4)),
    # frame duplication: frames 1, 2 and 4 are all-skip slices; again
    # with WPP, the filters and AQ off
    "frame_dup": (repeated, "ippp", dict(width=64, height=48, qp=30,
                                         cu_size=16, keyint=100,
                                         frame_dup=True)),
    "frame_dup_wpp": (repeated, "ippp", dict(width=64, height=48, qp=30,
                                             cu_size=16, keyint=100,
                                             frame_dup=True, wpp=True,
                                             **LF)),
    # WPP P and B substreams: IPPP with SAO and the deblock; B frames with
    # b-adapt 0; two references and TMVP; weighted P on a fade (the
    # reference's WPP P slice signals no weight: ROADMAP Queue 3)
    "wpp_ippp_lf": (lambda: wpp_clip(5), "ippp",
                    dict(width=96, height=64, wpp=True, **UNI, **LF)),
    "wpp_b": (lambda: wpp_clip(7), "push",
              dict(width=96, height=64, wpp=True, bframes=2, b_adapt=0,
                   **UNI)),
    "wpp_ref2_tmvp": (lambda: wpp_clip(5), "ippp",
                      dict(width=96, height=64, wpp=True, **REF2, **UNI)),
    "wpp_weightp_fade": (lambda: stream_opts_pins.fade(wpp_clip(4)),
                         "ippp", dict(width=96, height=64, wpp=True,
                                      weightp=True, **UNI)),
    # the golden clip without hash SEI: WPP with SAO and the deblock, and
    # CTU32 with two references and TMVP
    "wpp_golden_lf": (golden_corpus.clip, "ippp",
                      dict(width=64, height=48, wpp=True,
                           **dict(UNI, hash_sei=False), **LF)),
    "ctu32_ref2_tmvp_golden": (golden_corpus.clip, "ippp",
                               dict(width=64, height=48,
                                    **dict(UNI, cu_size=32, hash_sei=False),
                                    **REF2)),
}

PINS = {
    "ref2_flicker": (
        "f2283d6e13884b7853976fc52b51b00a",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32), (4, 'P', 32),
         (5, 'P', 32), (6, 'P', 32), (7, 'P', 32)]),
    "tmvp1_pan": (
        "e53bf562749c9895cc70c349393d5acd",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32), (4, 'P', 32),
         (5, 'P', 32), (6, 'P', 32)]),
    "tmvp2_pan": (
        "2fc8e2f2bc97fd4a07153d995a90b119",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32), (4, 'P', 32),
         (5, 'P', 32), (6, 'P', 32)]),
    "ctu32_ref2_tmvp": (
        "d420777ca041c0040023c4270c352ef9",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
    "ref2_tmvp_10bit": (
        "350406bf83e7630b506cd287f7e3c590",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32),
         (4, 'P', 32)]),
    "merge1": (
        "ed16653b6b1fe9052b45bd4b0755e876",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32), (4, 'P', 32),
         (5, 'P', 32)]),
    "merge2_lf": (
        "83f079d9bcceb86056e2b02c619e3f72",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32), (4, 'P', 32),
         (5, 'P', 32)]),
    "merge5_ref2_tmvp": (
        "d87cc2e51f1a33833b99c955322c667a",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32), (4, 'P', 32),
         (5, 'P', 32)]),
    "merge2_b": (
        "7025367f14fb467f233c1ab4afa780b2",
        [(0, 'I', 29), (4, 'P', 32), (2, 'B', 33), (1, 'b', 34), (3, 'b', 34),
         (7, 'P', 32), (6, 'B', 33), (5, 'b', 34)]),
    "merge4_qt1": (
        "9395160e61321dcdd995ff5153ffd19d",
        [(0, 'I', 27), (1, 'P', 30), (2, 'P', 30), (3, 'P', 30)]),
    "frame_dup": (
        "f07999d4bf3dc354d0192d3d4f08c45e",
        [(0, 'I', 27), (1, 'P', 30), (2, 'P', 30), (3, 'P', 30),
         (4, 'P', 30)]),
    "frame_dup_wpp": (
        "e0f956d0b020b36611d35d8f1a1dfc8a",
        [(0, 'I', 27), (1, 'P', 30), (2, 'P', 30), (3, 'P', 30),
         (4, 'P', 30)]),
    "wpp_ippp_lf": (
        "8dcb7d62e4b40dd03cab0450fce32ff1",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32),
         (4, 'P', 32)]),
    "wpp_b": (
        "29f68b34867dc006d31ea37386678b0d",
        [(0, 'I', 29), (3, 'P', 32), (2, 'B', 33), (1, 'b', 34), (6, 'P', 32),
         (5, 'B', 33), (4, 'b', 34)]),
    "wpp_ref2_tmvp": (
        "54401347a95adc18912917906d448181",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32),
         (4, 'P', 32)]),
    "wpp_weightp_fade": (
        "0e918c5f194ac312b7b8d95985916347",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32)]),
    "wpp_golden_lf": (
        "358f5e8f36c9d0a05c5877645487ec3f",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32), (4, 'P', 32),
         (5, 'P', 32)]),
    "ctu32_ref2_tmvp_golden": (
        "a9f7fa426e7aa23109be63b782b41cb0",
        [(0, 'I', 29), (1, 'P', 32), (2, 'P', 32), (3, 'P', 32), (4, 'P', 32),
         (5, 'P', 32)]),
}

# the command lines over GOLDEN_FRAMES frames of the golden clip, on the
# uniform 16x16 grid at x265's default preset
UNI16 = ["--ctu", "16", "--min-cu-size", "16"]
CLI = {
    "ref2_tmvp": UNI16 + ["--bframes", "0", "--no-weightp", "--ref", "2",
                          "--tmvp"],
    "max_merge2": UNI16 + ["--max-merge", "2"],
    "frame_dup": UNI16 + ["--bframes", "0", "--frame-dup",
                          "--dup-threshold", "1"],
}
_HEAD = "Encode Order, Type, POC, QP, Bits, PSNR Y, PSNR U, PSNR V, SSIM Y\n"
# the command lines that build an IPPP session (see csv_view)
IPPP_CLI = ("ref2_tmvp", "frame_dup")
CLI_PINS = {
    "ref2_tmvp": (
        "99cd82fd0a500b7d4ace536a377ccfe8",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 1, 40, 1, 40],
        _HEAD +
        '0, I, 0, 32, 6192, 31.9058, 0.0000, 0.0000, 0.00000\n'
        '1, P, 0, 34, 1584, 30.6617, 0.0000, 0.0000, 0.00000\n'
        '2, P, 0, 33, 2024, 30.8950, 0.0000, 0.0000, 0.00000\n'
        '3, P, 0, 33, 1960, 30.8222, 0.0000, 0.0000, 0.00000\n'
        '4, P, 0, 33, 1360, 30.2428, 0.0000, 0.0000, 0.00000\n'
        'Summary, frames=5, kbps=65.60, '
        'Global PSNR Y=30.9055, U=0.0000, V=0.0000, SSIM Y=0.00000\n'),
    "max_merge2": (
        "8f28bd06fb6fea35d79e607e8e5db065",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40],
        _HEAD +
        '0, I, 0, 25, 8976, 37.2347, 48.7432, 48.8888, 0.97225\n'
        '1, b, 1, 40, 704, 31.2253, 37.9999, 39.2627, 0.92755\n'
        '2, B, 2, 40, 976, 26.6779, 38.4462, 39.5212, 0.58168\n'
        '3, b, 3, 39, 784, 27.3410, 40.0454, 39.9096, 0.66235\n'
        '4, P, 4, 35, 2496, 26.4681, 40.0771, 39.3908, 0.57486\n'
        'Summary, frames=5, kbps=69.68, '
        'Global PSNR Y=29.7894, U=41.0624, V=41.3946, SSIM Y=0.74374\n'),
    "frame_dup": (
        "966d83966d07520515a9591ad4ea4494",
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 1, 40, 1, 40],
        _HEAD +
        '0, I, 0, 32, 6192, 31.9058, 0.0000, 0.0000, 0.00000\n'
        '1, P, 0, 34, 576, 22.2797, 0.0000, 0.0000, 0.00000\n'
        '2, P, 0, 33, 576, 22.2173, 0.0000, 0.0000, 0.00000\n'
        '3, P, 0, 33, 576, 21.9990, 0.0000, 0.0000, 0.00000\n'
        '4, P, 0, 33, 576, 21.8172, 0.0000, 0.0000, 0.00000\n'
        'Summary, frames=5, kbps=42.48, '
        'Global PSNR Y=24.0438, U=0.0000, V=0.0000, SSIM Y=0.00000\n'),
}

# the library at param_default_preset("medium") on the uniform 16x16 grid
# without B frames: weighted prediction with TMVP and one reference, and
# without weightp two references and TMVP (with CRF 28, AQ 2, cuTree, the
# deblock and SAO)
API = {
    "p_only": {"bframes": "0", "ctu": "16", "min-cu-size": "16"},
    "p_only_no_weightp": {"bframes": "0", "ctu": "16", "min-cu-size": "16",
                          "weightp": "0"},
}
API_PINS = {
    "p_only": (
        "31cd7603caead88c2f929aa7d2bf081d",
        [32, 33, 34, 39, 19, 1, 1, 1, 1],
        [565, 173, 240, 244, 208]),
    "p_only_no_weightp": (
        "c4554ed3b9dc1c9db26cd71fb78f1850",
        [32, 33, 34, 39, 19, 1, 1, 1, 1],
        [565, 179, 242, 237, 203]),
}


def run(top, name: str, **kw):
    """The session `name` of the encoder_top module `top` (the port's or
    the JAX package's) over its clip: (stream md5, [(POC, type, QP)] in
    coding order, the results). kw goes to the session (the port's
    device)."""
    clip, mode, opts = SESSIONS[name]
    opts = dict(opts)
    w, h = opts.pop("width"), opts.pop("height")
    s = top.VideoEncoderSession(w, h, **opts, **kw)
    stream, res = s.headers(), []
    for f in clip():
        res += s.push_frame(*f) if mode == "push" else [s.encode_frame(*f)]
    if mode == "push":
        res += s.flush()
    stream += b"".join(r.nals for r in res)
    out, poc = [], 0
    for r in res:
        poc = r.poc if mode == "push" else (0 if r.frame_type == "I"
                                            else poc + 1)
        out.append((poc, r.frame_type, r.qp))
    return hashlib.md5(stream).hexdigest(), out, res


def run_cli(cli_main, name: str, workdir: str, **kw):
    """One command line in workdir: (stream md5, NAL types, CSV text)."""
    src, dst = f"{workdir}/{name}.y4m", f"{workdir}/{name}.hevc"
    csv = f"{workdir}/{name}.csv"
    stream_opts_pins.write_golden_clip(src, GOLDEN_FRAMES)
    assert cli_main([src, "-o", dst, "--csv", csv] + CLI[name], **kw) == 0
    with open(dst, "rb") as f:
        data = f.read()
    with open(csv) as f:
        return (hashlib.md5(data).hexdigest(), preset_pins.nal_types(data),
                f.read())


def csv_view(name: str, text: str) -> str:
    """A command line's CSV log as both packages fill it: under an IPPP
    session (IPPP_CLI) the JAX session's results carry POC 0 and no
    PSNR-U/V or SSIM, so its log writes 0 there and the port's the
    values; those columns and the summary's U, V and SSIM are left out."""
    if name not in IPPP_CLI:
        return text
    rows = text.splitlines()
    keep = [", ".join(f for i, f in enumerate(r.split(", "))
                      if i in (0, 1, 3, 4, 5)) for r in rows[:-1]]
    summary = rows[-1]
    return "\n".join(keep + [summary[:summary.index(", U=")]]) + "\n"


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
