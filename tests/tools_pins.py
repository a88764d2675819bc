"""The last options at the entry points: RQT on the quadtree P and B
programs, analysis save / load / share with scale_factor, the ABR
ladder and its scaler, and the HDR10+ / Dolby Vision metadata. Test
clips, sessions, command lines and the JAX package's pins over them,
shared by tests/test_torch_rqt.py, test_torch_analysis.py,
test_torch_ladder.py, test_torch_host_tools.py and chip_smoke.py (this
module imports neither JAX nor the JAX package).

RQT_DIGEST holds the sha256 (digest(), as test_torch_qt_programs.py's)
of the JAX quadtree programs' decision dicts with rqt=True on rqt_inputs(); the
sessions' and command lines' entries hold the md5 of the JAX package's
streams (and record files). Every pin was computed from the JAX package
on the CPU; the slow tests of the four test files recompute them."""
import hashlib
import json
import os

import numpy as np

# ---------------------------------------------------------------------------
# RQT
# ---------------------------------------------------------------------------

RQT_W, RQT_H = 96, 64


def rqt_clip(n: int, w: int = RQT_W, h: int = RQT_H):
    """tests/test_rqt.py's clip: a flat frame whose top half is noise,
    moving 3 pixels a frame."""
    rng = np.random.default_rng(17)
    frames = []
    base = np.full((h, w), 80, np.uint8)
    for i in range(n):
        y = base.copy()
        y[: h // 2] = rng.integers(0, 256, (h // 2, w))
        y = np.roll(y, 3 * i, axis=1)
        frames.append((y, np.full((h // 2, w // 2), 100, np.uint8),
                       np.full((h // 2, w // 2), 160, np.uint8)))
    return frames


def rqt_inputs():
    """(P source, its reference, the B source) at 96x64: a smooth
    pattern moving (3, 2) pixels, with noise in one 16x16 quadrant of
    three CTUs of the P source (their CU32 TUs split: tu_split32) and of
    three others in the B source (the mean of the reference and the P
    source); flat chroma."""
    w, h = RQT_W, RQT_H
    rng = np.random.default_rng(5)
    xs, ys = np.meshgrid(np.arange(w + 8), np.arange(h + 8))
    base = (128 + 60 * np.sin(xs / 5.0) * np.cos(ys / 7.0)).astype(np.int32)
    ref = base[:h, :w]
    cur = base[2:h + 2, 3:w + 3].copy()
    for r, c in ((0, 0), (0, 2), (1, 1)):
        cur[32 * r + 16:32 * r + 32, 32 * c:32 * c + 16] += \
            rng.integers(-12, 13, (16, 16))
    cur = np.clip(cur, 0, 255).astype(np.uint8)
    u = np.full((h // 2, w // 2), 110, np.uint8)
    v = np.full((h // 2, w // 2), 140, np.uint8)
    rng = np.random.default_rng(9)
    b = (ref + cur.astype(np.int32)) // 2
    for r, c in ((0, 1), (1, 0), (1, 2)):
        b[32 * r:32 * r + 16, 32 * c + 16:32 * c + 32] += \
            rng.integers(-16, 17, (16, 16))
    b = np.clip(b, 0, 255).astype(np.uint8)
    return (cur, u, v), (ref.astype(np.uint8), u.copy(), v.copy()), \
        (b, u.copy(), v.copy())


RQT_QP = 22
# a per-CTU QP map of the 2 x 3 CTUs (AQ / cuTree)
RQT_QMAP = np.array([[20, 24, 22], [26, 21, 23]], np.int32)
# sha256 of the JAX package's dicts on rqt_inputs() (quadtree depth 2,
# the device DPB, rqt=True): the P frame at RQT_QP, at RQT_QMAP and with
# RDOQ; the B frame (no intra candidates) from the reference and the P
# frame's recon at RQT_QP
RQT_DIGEST = {
    "p": "eb85148e4264313b3568489193c2c3a4166a976323c018a16ade21cef8f76f89",
    "p_aq":
        "29a8444d47adcfcf3d5df8edfe117d0f73c12ecea753422ce95aaea7ba0687dc",
    "p_rdoq":
        "2cc87d6b1c3db98ccac900a48b66b96e55303dc7e9cc6c918b38286b4d5f5a06",
    "b": "9815da6315ce39b6ee69f9dbb9eb91c697cfa4575b67cfe6bf76b9a1716aaf31"}

RQT_KW = dict(width=RQT_W, height=RQT_H, qp=30, max_depth=2, keyint=100,
              hash_sei=False, rqt=True)
# name: (clip, "ippp" | "push", session keywords)
RQT_SESSIONS = {
    # tests/test_rqt.py's sessions
    "p": (lambda: rqt_clip(6), "ippp", RQT_KW),
    "b": (lambda: rqt_clip(6), "push", dict(RQT_KW, bframes=2, b_adapt=0)),
    # the reference fault: with the deblock on, RQT's inner 16x16 TU
    # edges are not filtered, so the stream decodes to another picture
    "p_deblock": (lambda: [rqt_inputs()[1], rqt_inputs()[0]], "ippp",
                  dict(RQT_KW, qp=RQT_QP, deblock=True)),
}
RQT_PINS = {"p": "5df52b0d71f7a5127a40a91f0c5a4d7f",
            "b": "e911c0ae7723dfb4f643f0cffe6faaac",
            "p_deblock": "48a23eceb0a7e57365f6beee6969972e"}

# ---------------------------------------------------------------------------
# analysis save / load / share, scale_factor
# ---------------------------------------------------------------------------


def moving_scene(w: int, h: int, n: int, seed: int = 0):
    """tests/test_inter_deblock.py's clip: gradients with blocks moving
    one step a frame."""
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    out = []
    for i in range(n):
        y = ((xs * 1.5 + ys * 0.8 + i * 6 + seed * 11) % 256).astype(np.uint8)
        y[(ys // 8 + xs // 8 + i) % 7 == 0] = 200
        u = ((xs[:h // 2, :w // 2] * 0.5 + i * 3) % 256).astype(np.uint8)
        v = ((ys[:h // 2, :w // 2] * 0.7 + 128 - i * 2) % 256).astype(
            np.uint8)
        out.append((y, u, v))
    return out


def scale_clip(w: int = 128, h: int = 96, n: int = 4):
    """tests/test_scale_factor.py's clip: a random texture moving 2
    pixels a frame, flat chroma."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (h, w))
    return [(np.roll(base, 2 * i, axis=1).astype(np.uint8),
             np.full((h // 2, w // 2), 90, np.uint8),
             np.full((h // 2, w // 2), 170, np.uint8)) for i in range(n)]


ANALYSIS_KW = dict(qp=32, cu_size=16, keyint=100, hash_sei=False)


def run_analysis(top, workdir: str, **kw):
    """tests/test_analysis_reuse.py's two passes (64x48, 5 frames of
    moving_scene) in workdir: {"save": pass 1's stream md5, "record": its
    record file's md5, "load": pass 2's stream md5}. kw go to the
    sessions (the port's device)."""
    frames = moving_scene(64, 48, 5)
    dat = os.path.join(workdir, "analysis.dat")
    s1 = top.VideoEncoderSession(64, 48, analysis_save=dat, **ANALYSIS_KW,
                                 **kw)
    st1 = s1.headers() + b"".join(s1.encode_frame(*f).nals for f in frames)
    s1.analysis_save.close()
    s2 = top.VideoEncoderSession(64, 48, analysis_load=dat, **ANALYSIS_KW,
                                 **kw)
    st2 = s2.headers() + b"".join(s2.encode_frame(*f).nals for f in frames)
    return {"save": md5(st1), "record": file_md5(dat), "load": md5(st2)}


def run_scale_factor(top, resize_plane, workdir: str, **kw):
    """tests/test_scale_factor.py's two passes in workdir: pass 1 at half
    size over the clip scaled by resize_plane (the JAX package's numpy
    scaler or the port's), pass 2 at full size loading its records with
    scale_factor 2: {"half": pass 1's md5, "record": the record file's,
    "full": pass 2's}."""
    w, h = 128, 96
    frames = scale_clip(w, h)
    dat = os.path.join(workdir, "an.dat")
    kf = dict(ANALYSIS_KW, keyint=len(frames) + 1)
    s1 = top.VideoEncoderSession(w // 2, h // 2, analysis_save=dat, **kf,
                                 **kw)
    half = lambda p, hh, ww: np.asarray(resize_plane(p, hh, ww)).astype(
        np.uint8)
    st1 = s1.headers()
    for y, u, v in frames:
        st1 += s1.encode_frame(half(y, h // 2, w // 2),
                               half(u, h // 4, w // 4),
                               half(v, h // 4, w // 4)).nals
    s1.analysis_save.close()
    s2 = top.VideoEncoderSession(w, h, analysis_load=dat, scale_factor=2,
                                 **kf, **kw)
    st2 = s2.headers() + b"".join(s2.encode_frame(*f).nals for f in frames)
    return {"half": md5(st1), "record": file_md5(dat), "full": md5(st2)}


ANALYSIS_PINS = {"save": "f2503795af6e6e6c5490856e9a5ff00e",
                 "record": "e60ec35cb91d630745224fd23074d0d1",
                 "load": "5c3888a1b95a04749db985eedccd3c3c"}
SCALE_PINS = {"half": "c1282e8efc9df14bfa28c3a70dc3c060",
              "record": "2c59f9085b7d628608c0a4ef50dd9ee6",
              "full": "3aa2cac52ab66f57df2e54dbc2ed6403"}

# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------


def ladder_clip(n: int = 4, w: int = 128, h: int = 96):
    """tests/test_scaler_ladder.py's hand-off clip: a random texture
    moving a pixel a frame, flat chroma."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (h, w))
    return [(np.roll(base, i, axis=1).astype(np.uint8),
             np.full((h // 2, w // 2), 100, np.uint8),
             np.full((h // 2, w // 2), 150, np.uint8)) for i in range(n)]


def run_ladder(ladder, share: bool, **kw):
    """The two-rung ladder (128x96 at 400 kbps, 64x48 at 120 kbps, keyint
    9, no hash SEI) of the models.ladder module `ladder` over
    ladder_clip(): each rung's stream md5, in rung order, and the encoder.
    kw go to the sessions (the port's device)."""
    lad = ladder.LadderEncoder(
        128, 96, [ladder.Rung(128, 96, 400), ladder.Rung(64, 48, 120)],
        keyint=9, hash_sei=False, share_analysis=share, **kw)
    streams = lad.headers()
    for f in ladder_clip():
        for j, fr in enumerate(lad.encode_frame(*f)):
            streams[j] += fr.nals
    return [md5(s) for s in streams], lad


# share_analysis: each rung's md5 (128x96, then 64x48)
LADDER_PINS = {True: ["bbc8b784e99919d1221d3ac0d473eb87",
                      "35142dd19e0a2bea4a68566195336439"],
               False: ["6c50bfa1907ea9866f6299ca707c1d83",
                       "35142dd19e0a2bea4a68566195336439"]}

# ---------------------------------------------------------------------------
# the command lines (a clip of CLI_FRAMES random 64x48 frames)
# ---------------------------------------------------------------------------

CLI_FRAMES = 3
HDR10P = [{"TargetedSystemDisplayMaximumLuminance": 400,
           "LuminanceParameters": {
               "MaxScl": [1, 2, 3], "AverageRGB": 7,
               "LuminanceDistributions": {"DistributionIndex": [50],
                                          "DistributionValues": [100]}},
           "BezierCurveData": {"KneePointX": 1, "KneePointY": 2,
                               "Anchors": [3, 4]}},
          {"TargetedSystemDisplayMaximumLuminance": 1000}]
RPUS = (b"\x01rpu-frame-0", b"\x01rpu-frame-1")
# name: argv after "in.y4m -o out.hevc"; {dir} is the work directory
# (which holds d.json with HDR10P and rpu.bin with RPUS)
CLI = {
    "dovi": ["--keyint", "1", "--qp", "32", "--dolby-vision-rpu",
             "{dir}/rpu.bin"],
    "hdr10p_dovi": ["--keyint", "5", "--qp", "32", "--bframes", "0",
                    "--ctu", "16", "--min-cu-size", "16", "--dhdr10-info",
                    "{dir}/d.json", "--dolby-vision-rpu", "{dir}/rpu.bin"],
    "ladder": ["--keyint", "5", "--ladder", "64x48:300,32x24:100",
               "--no-hash"],
    "analysis_save": ["--keyint", "5", "--qp", "30", "--analysis-save",
                      "{dir}/cli.dat"],
    "analysis_load": ["--keyint", "5", "--qp", "30", "--analysis-load",
                      "{dir}/cli.dat"],
    "rqt": ["--preset", "ultrafast", "--qp", "22", "--rqt"],
}
# md5 of each output file of the JAX CLI, by name (the ladder's per rung)
CLI_PINS = {
    "dovi": {"dovi.hevc": "830660b2414b7391944bf9969f07bf4a"},
    "hdr10p_dovi": {"hdr10p_dovi.hevc": "aeb3b332926063b9fd0fb657a2aea75f"},
    "ladder": {"ladder_32x24.hevc": "0cb891748d3c6da019ec59ccac384e96",
               "ladder_64x48.hevc": "1af5c56515156fc6ff3a5e14d041ed4b"},
    "analysis_save":
        {"analysis_save.hevc": "6d625af23ca9e848fe11e015f12e4057"},
    "analysis_load":
        {"analysis_load.hevc": "6d625af23ca9e848fe11e015f12e4057"},
    "rqt": {"rqt.hevc": "15054fd09ff56ff73cb57a50e9d0c216"},
    # the record file --analysis-save writes
    "analysis_record": "477385be80cad8f4e398b5abd3c6aeda"}


def write_cli_inputs(workdir: str, write_clip) -> str:
    """The command lines' inputs in workdir: in.y4m (CLI_FRAMES random
    64x48 frames, written by write_clip(path, frames)), d.json and
    rpu.bin; returns the y4m's path."""
    from_nal = lambda p: b"\x00\x00\x00\x01" + bytes([62 << 1, 1]) + p
    with open(os.path.join(workdir, "rpu.bin"), "wb") as f:
        f.write(b"".join(from_nal(p) for p in RPUS))
    with open(os.path.join(workdir, "d.json"), "w") as f:
        json.dump({"SceneInfo": HDR10P}, f)
    rng = np.random.default_rng(0)
    frames = [(rng.integers(0, 256, (48, 64)).astype(np.uint8),
               np.full((24, 32), 100, np.uint8),
               np.full((24, 32), 150, np.uint8)) for _ in range(CLI_FRAMES)]
    src = os.path.join(workdir, "in.y4m")
    write_clip(src, frames)
    return src


def run_cli(cli_main, name: str, workdir: str, src: str, **kw):
    """One command line of CLI over src in workdir: {output file name:
    md5} (the ladder writes one file per rung), after the exit code 0
    is checked. kw go to cli_main (the port's device)."""
    out = os.path.join(workdir, f"{name}.hevc")
    argv = [a.replace("{dir}", workdir) for a in CLI[name]]
    assert cli_main([src, "-o", out] + argv, **kw) == 0
    return {f: file_md5(os.path.join(workdir, f))
            for f in sorted(os.listdir(workdir))
            if f.startswith(name) and f.endswith(".hevc")}


# ---------------------------------------------------------------------------
# the HDR10+ SEI on a session (tests/test_sei_extras.py's)
# ---------------------------------------------------------------------------


def sei_frames(n: int = 3, w: int = 64, h: int = 48, seed: int = 0):
    """tests/test_sei_extras.py's frames: random planes."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
            for _ in range(n)]


def run_hdr10p_session(top, sei, **kw):
    """tests/test_sei_extras.py's session (64x48, qp 32, keyint 10, three
    frames) with each frame's HDR10+ SEI of HDR10P through sei_provider:
    the stream's md5 and the results."""
    s = top.VideoEncoderSession(64, 48, qp=32, keyint=10, **kw)
    s.sei_provider = lambda i: sei.hdr10plus_sei_for_frame(HDR10P, i)
    res = [s.encode_frame(*f) for f in sei_frames()]
    return md5(s.headers() + b"".join(r.nals for r in res)), res


SEI_PINS = {"hdr10p": "3f167ec04bcf51b00dd06f8580322682"}

# ---------------------------------------------------------------------------


def digest(d: dict) -> str:
    """sha256 of a decision dict: each key in sorted order with its
    array's shape and int64 values (None as such); recon_dev left out."""
    h = hashlib.sha256()
    for k in sorted(d):
        if k == "recon_dev":
            continue
        h.update(k.encode())
        v = d[k]
        if v is None:
            h.update(b"None")
        else:
            a = np.ascontiguousarray(np.asarray(v), np.int64)
            h.update(repr(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def rqt_dicts(inter_qt_encoder, quantizer, device):
    """The port's decision dicts of RQT_DIGEST (the InterQTEncoder and
    Quantizer classes of the port, on `device`)."""
    src, ref, bsrc = rqt_inputs()
    enc = lambda **k: inter_qt_encoder(RQT_W, RQT_H, device, rqt=True, **k)
    p = enc().encode_frame(*src, *ref, RQT_QP)
    r1 = (p["recon_y"], p["recon_u"], p["recon_v"])
    return {"p": p,
            "p_aq": enc().encode_frame(*src, *ref, RQT_QMAP),
            "p_rdoq": enc(quant_fn=quantizer(rdoq=True)).encode_frame(
                *src, *ref, RQT_QP),
            "b": enc().encode_frame(*bsrc, *ref, RQT_QP, ref1=r1)}


def md5(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def file_md5(path: str) -> str:
    with open(path, "rb") as f:
        return md5(f.read())


def run_session(top, name: str, **kw):
    """The RQT session `name` of the encoder_top module `top` over its
    clip: (stream md5, the session, the results in coding order)."""
    clip, mode, opts = RQT_SESSIONS[name]
    opts = dict(opts)
    w, h = opts.pop("width"), opts.pop("height")
    s = top.VideoEncoderSession(w, h, **opts, **kw)
    res = []
    for f in clip():
        res += s.push_frame(*f) if mode == "push" else [s.encode_frame(*f)]
    if mode == "push":
        res += s.flush()
    return md5(s.headers() + b"".join(r.nals for r in res)), s, res
