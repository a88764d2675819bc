"""The depth-1 quadtree's and the uniform grid's B sessions over the
golden clip, and the JAX package's pins over them, shared by
tests/test_torch_qt1.py, tests/test_torch_uniform_b.py and chip_smoke.py
(this module imports neither JAX nor the JAX package).

GOLDENS: the golden configurations of tests/golden_corpus.py these
sessions code (intra_qt1 through the intra session, the three uniform B
ones through push_frame / flush), md5s in tests/golden/manifest.json.
QT1_SESSIONS / QT1_PINS: depth-1 video sessions (IPPP over clip(), the
weightp one over the clip fading by 6 a frame; the B one through
push_frame / flush over clip(64, 48, n=8)), each pinned as (md5, (POC,
type, QP) of each result in coding order; the JAX IPPP results carry POC
0) with QT1_NALS, the NAL unit types. UNI_B_SESSIONS / UNI_B_PINS: uniform
B sessions over clip(64, 48, n=8), pinned as (md5, (POC, type, QP), NAL
types). All pins were computed from the JAX package at commit d580939 on
the CPU; the slow tests of the two test files recompute them."""
import hashlib
import json
import os

import numpy as np

from golden_corpus import clip

MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "manifest.json")
GOLDENS = {
    "intra_qt1": dict(qp=30, max_depth=1, hash_sei=False),
    "bframes3_pyramid": dict(qp=32, cu_size=16, keyint=100, bframes=3,
                             b_pyramid=True, b_adapt=0, hash_sei=False),
    "bframes_badapt": dict(qp=32, cu_size=16, keyint=100, bframes=2,
                           b_adapt=2, hash_sei=False),
    "open_gop": dict(qp=32, cu_size=16, keyint=4, bframes=2, b_adapt=0,
                     open_gop=True, hash_sei=False),
}

QT1 = dict(qp=30, max_depth=1, keyint=100, hash_sei=True)
LF = dict(deblock=True, sao=True)
QT1_SESSIONS = {
    "qt1_ippp": QT1,
    "qt1_b": dict(qp=30, max_depth=1, keyint=5, hash_sei=True, bframes=3,
                  b_pyramid=True, b_adapt=0),
    # the device-DPB filter chain
    "qt1_lf": dict(QT1, **LF),
    # the host-filter path: under weightp, and without the device DPB
    # under AQ
    "qt1_lf_weightp": dict(QT1, weightp=True, **LF),
    "qt1_lf_host_aq": dict(QT1, dpb_device=False, aq_mode=2, **LF),
}
_IPPP = [(0, "I", 27)] + [(0, "P", 30)] * 5
QT1_PINS = {
    "qt1_ippp": ("9a393f590b3334d6f5679a22ef8d57f3", _IPPP),
    "qt1_b": ("7542e39164553ed7ddc09564aaf90fe7",
              [(0, "I", 27), (4, "P", 30), (2, "B", 31), (1, "b", 32),
               (3, "b", 32), (0, "I", 27), (2, "P", 30), (1, "b", 32)]),
    "qt1_lf": ("d8bd41a7b576fdd9d444e7b9ce505f86", _IPPP),
    "qt1_lf_weightp": ("272675b0031b2d79ba573c65a54d2646", _IPPP),
    "qt1_lf_host_aq": ("5a5c09c2cbaa48f3f428084df498c33c", _IPPP),
}
# VPS, SPS, PPS, prefix SEI, then each frame's slice and its hash SEI
# (IDR_W_RADL 19, TRAIL_R 1, TRAIL_N 0, CRA 21, RASL_N 8, suffix SEI 40)
QT1_NALS = {name: [32, 33, 34, 39, 19, 40] + [1, 40] * 5
            for name in QT1_PINS}
QT1_NALS["qt1_b"] = [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40,
                     19, 40, 1, 40, 0, 40]

UNI_B_SESSIONS = {
    # deblock, SAO and AQ 2 on every frame
    "lf_aq": dict(qp=32, cu_size=16, keyint=100, hash_sei=True, bframes=3,
                  b_pyramid=True, b_adapt=0, aq_mode=2, **LF),
    # open GOP at keyint 5: the CRA at POC 5 with POC 4 as its RASL_N
    # leading picture
    "open_gop_rasl": dict(qp=32, cu_size=16, keyint=5, bframes=2,
                          b_adapt=0, open_gop=True, hash_sei=True),
}
UNI_B_PINS = {
    "lf_aq": (
        "c4883d10cfcaf2d1373a66ae46b24825",
        [(0, "I", 29), (4, "P", 32), (2, "B", 33), (1, "b", 34),
         (3, "b", 34), (7, "P", 32), (6, "B", 33), (5, "b", 34)],
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 0, 40, 1, 40, 1, 40,
         0, 40]),
    "open_gop_rasl": (
        "ba96338e6792f42e7e6dd79dbf6e8d3f",
        [(0, "I", 29), (3, "P", 32), (2, "B", 33), (1, "b", 34),
         (5, "I", 29), (4, "b", 34), (7, "P", 32), (6, "b", 34)],
        [32, 33, 34, 39, 19, 40, 1, 40, 1, 40, 0, 40, 21, 40, 8, 40, 1, 40,
         0, 40]),
}


def manifest(name: str) -> str:
    with open(MANIFEST) as fh:
        return json.load(fh)[name]


def nal_types(stream: bytes) -> list:
    """The NAL unit type of every NAL of an Annex-B stream, in order."""
    out, i = [], 0
    while True:
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            return out
        out.append((stream[j + 3] >> 1) & 63)
        i = j + 3


def fade(frames):
    """frames with frame i's luma lowered by 6 i (clipped)."""
    return [(np.clip(y.astype(np.int32) - 6 * i, 0, 255).astype(np.uint8),
             u, v) for i, (y, u, v) in enumerate(frames)]


def push_all(top, kw, frames, **extra):
    """(stream, results) of a push / flush session of the encoder_top
    module `top` at 64x48 over `frames`."""
    s = top.VideoEncoderSession(64, 48, **kw, **extra)
    out, res = s.headers(), []
    for f in frames:
        res += s.push_frame(*f)
    res += s.flush()
    return out + b"".join(r.nals for r in res), res


def golden_md5(top, name: str, **extra) -> str:
    """md5 of the golden configuration `name` through the encoder_top
    module `top` over clip()."""
    kw = GOLDENS[name]
    if kw.get("max_depth") and not kw.get("bframes"):
        s = top.IntraEncoderSession(64, 48, **kw, **extra)
        out = s.headers() + b"".join(s.encode_frame(*f).nals
                                     for f in clip())
    else:
        out = push_all(top, kw, clip(), **extra)[0]
    return hashlib.md5(out).hexdigest()


def run_qt1(top, name: str, **extra):
    """(stream, [(POC, type, QP)]) of QT1_SESSIONS[name] through the
    encoder_top module `top`."""
    kw = dict(QT1_SESSIONS[name], **extra)
    if kw.get("bframes"):
        stream, res = push_all(top, kw, clip(64, 48, n=8))
    else:
        s = top.VideoEncoderSession(64, 48, **kw)
        frames = fade(clip()) if kw.get("weightp") else clip()
        res = [s.encode_frame(*f) for f in frames]
        stream = s.headers() + b"".join(r.nals for r in res)
    return stream, [(r.poc, r.frame_type, r.qp) for r in res]


def qt1_pin_of(stream: bytes, frames, name: str):
    """The (md5, frames) of a QT1 session's run as QT1_PINS holds them
    (an IPPP session's POCs as 0, as the JAX results carry them)."""
    if not QT1_SESSIONS[name].get("bframes"):
        frames = [(0,) + f[1:] for f in frames]
    return hashlib.md5(stream).hexdigest(), frames


def run_uni_b(top, name: str, **extra):
    """(md5, [(POC, type, QP)], NAL types) of UNI_B_SESSIONS[name]
    through the encoder_top module `top`."""
    stream, res = push_all(top, UNI_B_SESSIONS[name], clip(64, 48, n=8),
                           **extra)
    return (hashlib.md5(stream).hexdigest(),
            [(r.poc, r.frame_type, r.qp) for r in res], nal_types(stream))
