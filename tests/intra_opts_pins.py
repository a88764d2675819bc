"""The all-intra session's last options: 4:4:4 input, noise reduction
(nr_intra), fast intra and the CTU64 quadtree (max_depth 2 or 3): test
clips, programs, sessions and command lines, and the JAX package's pins
over them, shared by tests/test_torch_intra_opts.py and chip_smoke.py
(this module imports neither JAX nor the JAX package).

PROGRAMS holds, for each frame program, its kind ("uniform": the
uniform-grid intra program, "qt64": the CTU64 quadtree), its frame and
its configuration; DIGESTS the sha256 (digest()) of the JAX program's
decision dict on it (the uniform program's unpacked at full width,
_unpack(..., compact=False)). SESSIONS holds, for each session, its
clip, its mode ("intra": encode_frame per frame, "batch": one
encode_batch of the clip) and its keywords; PINS the md5 of the JAX
package's stream and each result's (POC, type, QP). CLI holds command
lines over GOLDEN_FRAMES frames of the golden clip (64x48; the "i444"
cases over a 4:4:4 y4m of it), CLI_PINS the JAX CLI's stream md5, NAL unit
types and CSV log. All pins were computed from the JAX package at commit
05560b5 on the CPU; the slow tests of tests/test_torch_intra_opts.py
recompute them."""
import hashlib

import numpy as np

import golden_corpus
import preset_pins

GOLDEN_FRAMES = 5          # the command lines' frames


# ---------------------------------------------------------------------------
# clips (each the JAX package's test of its option, or a synthetic one)
# ---------------------------------------------------------------------------

def i444_clip(w: int, h: int, n: int = 1, seed: int = 11, flat_u=False):
    """Random 4:4:4 frames (tests/test_i444.py's): every plane w x h; with
    flat_u frame i's Cb is 80 + i everywhere."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        u = np.full((h, w), 80 + i, np.uint8) if flat_u else \
            rng.integers(0, 256, (h, w)).astype(np.uint8)
        v = rng.integers(0, 256, (h, w)).astype(np.uint8)
        out.append((y, u, v))
    return out


def nr_clip(n: int = 6, w: int = 64, h: int = 48, seed: int = 7):
    """A noisy still (tests/test_nr.py's clip): each frame a base picture
    plus fresh uniform noise of +-20 in luma, +-15 in chroma."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (h, w))
    out = []
    for _ in range(n):
        y = np.clip(base + rng.integers(-20, 21, (h, w)), 0, 255)
        u = np.clip(128 + rng.integers(-15, 16, (h // 2, w // 2)), 0, 255)
        v = np.clip(128 + rng.integers(-15, 16, (h // 2, w // 2)), 0, 255)
        out.append(tuple(p.astype(np.uint8) for p in (y, u, v)))
    return out


def fast_clip(w: int = 96, h: int = 64, seed: int = 2):
    """tests/test_fast_intra.py's frame: a diagonal ramp with noise in
    luma, random chroma."""
    rng = np.random.default_rng(seed)
    base = np.add.outer(np.arange(h), np.arange(w)) * 3 % 256
    y = np.clip(base + rng.integers(-10, 10, (h, w)), 0, 255)
    u = rng.integers(60, 200, (h // 2, w // 2))
    v = rng.integers(60, 200, (h // 2, w // 2))
    return [tuple(p.astype(np.uint8) for p in (y, u, v))]


def mixed(w: int, h: int, seed: int):
    """tests/test_ctu64.py's frame: a flat left half (large CUs) and a
    noisy right half (splits)."""
    rng = np.random.default_rng(seed)
    y = np.full((h, w), 120, np.uint8)
    y[:, w // 2:] = rng.integers(0, 256, (h, w // 2))
    u = np.full((h // 2, w // 2), 128, np.uint8)
    u[:, w // 4:] = rng.integers(0, 256, (h // 2, w // 4))
    return y, u, 255 - u


def rand_clip(w: int, h: int, n: int = 1, seed: int = 9):
    """Random 4:2:0 frames."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
            for _ in range(n)]


def synth(n: int, w: int = 128, h: int = 128):
    """The golden clip's gradient and moving texture at w x h."""
    return golden_corpus.clip(w, h, n=n)


def deep10(frames):
    """8-bit frames at 10 bits: each sample times 4, as uint16."""
    return [tuple(p.astype(np.uint16) * 4 for p in f) for f in frames]


def nr_offsets(n: int = 16, seed: int = 4):
    """Seeded denoise offsets (luma n x n, chroma n/2 x n/2), a zero DC."""
    rng = np.random.default_rng(seed)
    oy = rng.integers(0, 40, (n, n)).astype(np.int32)
    oc = rng.integers(0, 40, (n // 2, n // 2)).astype(np.int32)
    oy[0, 0] = oc[0, 0] = 0
    return oy, oc


def digest(d: dict) -> str:
    """sha256 of a decision dict: each key in sorted order with its
    array's shape and int64 values (None as such)."""
    h = hashlib.sha256()
    for k in sorted(d):
        h.update(k.encode())
        v = d[k]
        if v is None:
            h.update(b"None")
            continue
        a = np.ascontiguousarray(np.asarray(v), np.int64)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# frame programs: name -> (kind, frame, configuration)
# ---------------------------------------------------------------------------

# configuration keys: width, height, qp (one, or a per-CTU map), cu_size
# (uniform), csp, fast_intra, nr (the offsets nr_offsets() give), sbh,
# rdoq, psy_rdoq, psy_rd, max_depth (qt64), bit_depth
PROGRAMS = {
    "i444": ("uniform", lambda: i444_clip(64, 48)[0],
             dict(width=64, height=48, qp=30, cu_size=16, csp="i444")),
    "i444_rdoq": ("uniform", lambda: i444_clip(64, 48, seed=3)[0],
                  dict(width=64, height=48, qp=27, cu_size=16, csp="i444",
                       rdoq=True, psy_rdoq=1.0)),
    "nr": ("uniform", lambda: nr_clip(1)[0],
           dict(width=64, height=48, qp=30, cu_size=16, nr=True)),
    "nr_sbh": ("uniform", lambda: nr_clip(1, seed=8)[0],
               dict(width=64, height=48, qp=26, cu_size=16, nr=True,
                    sbh=True)),
    "fast_intra": ("uniform", lambda: fast_clip()[0],
                   dict(width=96, height=64, qp=30, cu_size=16,
                        fast_intra=True)),
    "qt64_d2": ("qt64", lambda: synth(1)[0],
                dict(width=128, height=128, qp=30, max_depth=2)),
    "qt64_d3": ("qt64", lambda: synth(1)[0],
                dict(width=128, height=128, qp=30, max_depth=3)),
    "qt64_d3_aq": ("qt64", lambda: mixed(128, 128, 5),
                   dict(width=128, height=128,
                        qp=np.array([[29, 33], [31, 27]], np.int32),
                        max_depth=3)),
    "qt64_d3_rdoq": ("qt64", lambda: synth(1)[0],
                     dict(width=128, height=128, qp=30, max_depth=3,
                          rdoq=True, psy_rdoq=1.0)),
    "qt64_d3_sbh": ("qt64", lambda: synth(1)[0],
                    dict(width=128, height=128, qp=30, max_depth=3,
                         sbh=True)),
    "qt64_d3_psy": ("qt64", lambda: synth(1)[0],
                    dict(width=128, height=128, qp=30, max_depth=3,
                         psy_rd=2.0)),
    "qt64_d2_10bit": ("qt64", lambda: deep10(synth(1))[0],
                      dict(width=128, height=128, qp=30, max_depth=2,
                           bit_depth=10)),
}

DIGESTS = {
    "i444":
        "f189c9e936f02ab7086cae04922cab0b6e41cb3072312ba406715604bcfcf313",
    "i444_rdoq":
        "06f0dedcbf3c3d70e0ce3987ffb8027d85b8730af729466c0939a943e8857cbd",
    "nr":
        "12e5f01408a22bbaaf70cc478c3dd0c529e26369cf6c7e1a0a34c1e505354b24",
    "nr_sbh":
        "93c8acc8e73c22d6708830feb4722c70619ce8594606ddb687ef15edc735581e",
    "fast_intra":
        "dbcbe987571bff3e9f3b5c27a55668231903022842eebaf7f5be958c6a9ef85a",
    "qt64_d2":
        "b8622f24d96e36cd159b1406e9c1b80657c1b4f8a80c709f88861fa9f18cc486",
    "qt64_d3":
        "8e434a3153a970f798c4d5288eb57d0b64f93c4bd8b93e31fd8e1a0140813731",
    "qt64_d3_aq":
        "355dd3220f138d27df8af0b185427c4f0e83571317048e4e88063541008036fb",
    "qt64_d3_rdoq":
        "4c018d810950618ed21b2b7959bed8d39c9d6f6e86ddcb6ad530b90bba105e1b",
    "qt64_d3_sbh":
        "eb87b667d1d38b33781cd16da26ab065fab96a3cb3f95ff9aefb1bccbffff319",
    "qt64_d3_psy":
        "cf172cd06389af1b4fbe92c445093a40948f0464cac8dea470b14c7a7b0f37e3",
    "qt64_d2_10bit":
        "0b9f05141f6fea9fa1a18573f6c3aa8b232544b62f2f6d55f8da7f847f751543",
}


def program_args(name: str):
    """(kind, frame, cfg, qp, nr_off) of a program case; cfg is the
    configuration less qp (a per-CTU map flattened to [ncu])."""
    kind, frame, cfg = PROGRAMS[name]
    cfg = dict(cfg)
    qp = cfg.pop("qp")
    nr_off = nr_offsets(cfg["cu_size"]) if cfg.get("nr") else None
    return kind, frame(), cfg, qp, nr_off


def run_program_port(name: str, device="cpu") -> dict:
    """The port's decision dict of a program case."""
    from x265_yuuki_asuna_tpu_torch.models import intra_encoder as IE
    from x265_yuuki_asuna_tpu_torch.ops.quant import Quantizer
    kind, (y, u, v), cfg, qp, nr_off = program_args(name)
    q = Quantizer(cfg.get("sbh", False), cfg.get("rdoq", False),
                  cfg.get("psy_rdoq", 0.0), cfg.get("bit_depth", 8),
                  csp420=cfg.get("csp", "i420") == "i420")
    W, H = cfg["width"], cfg["height"]
    if kind == "qt64":
        enc = IE.IntraQT64Encoder(W, H, device, q, cfg.get("psy_rd", 0.0),
                                  cfg["max_depth"])
        return enc.encode_frame(y, u, v, qp)
    enc = IE.IntraFrameEncoder(W, H, cfg["cu_size"], device, q,
                               csp=cfg.get("csp", "i420"),
                               fast_intra=cfg.get("fast_intra", False),
                               nr=cfg.get("nr", False))
    return enc.encode_frame(y, u, v, qp, nr_off=nr_off)


# ---------------------------------------------------------------------------
# sessions: name -> (clip, mode, keywords with width and height)
# ---------------------------------------------------------------------------

SESSIONS = {
    # tests/test_i444.py's two cases, and a 4:4:4 batch at CTU32 with
    # sign hiding and the CRC
    "i444_intra": (lambda: i444_clip(64, 48), "intra",
                   dict(width=64, height=48, qp=30, cu_size=16,
                        hash_sei=False, csp="i444")),
    "i444_multiframe": (lambda: i444_clip(48, 32, n=2, seed=12,
                                          flat_u=True), "intra",
                        dict(width=48, height=32, qp=32, cu_size=16,
                             hash_sei=False, csp="i444", aq_mode=0)),
    "i444_batch_ctu32": (lambda: i444_clip(96, 64, n=2, seed=5), "batch",
                         dict(width=96, height=64, qp=34, cu_size=32,
                              csp="i444", sbh=True, hash_type=1)),
    # tests/test_nr.py's clip with and without NR, and NR in a batch
    "nr_1000": (lambda: nr_clip(), "intra",
                dict(width=64, height=48, qp=30, cu_size=16, hash_sei=False,
                     nr_intra=1000)),
    "nr_0": (lambda: nr_clip(), "intra",
             dict(width=64, height=48, qp=30, cu_size=16, hash_sei=False)),
    "nr_batch": (lambda: nr_clip(3), "batch",
                 dict(width=64, height=48, qp=30, cu_size=16,
                      nr_intra=1000)),
    # tests/test_fast_intra.py's frame, and fast intra over two frames
    # with AQ
    "fast_intra": (lambda: fast_clip(), "intra",
                   dict(width=96, height=64, qp=30, cu_size=16,
                        hash_sei=False, fast_intra=True)),
    "fast_intra_aq": (lambda: synth(2, 96, 64), "intra",
                      dict(width=96, height=64, qp=30, cu_size=16,
                           fast_intra=True, aq_mode=2)),
    # tests/test_ctu64.py's three cases
    "ctu64_d2": (lambda: [mixed(128, 64, 3)], "intra",
                 dict(width=128, height=64, qp=30, cu_size=64, max_depth=2,
                      hash_sei=False)),
    "ctu64_d3_deblock": (lambda: [mixed(128, 64, 3)], "intra",
                         dict(width=128, height=64, qp=30, cu_size=64,
                              max_depth=3, hash_sei=False, deblock=True)),
    "ctu64_aq_cropped": (lambda: rand_clip(96, 80), "intra",
                         dict(width=96, height=80, qp=32, cu_size=64,
                              max_depth=2, hash_sei=False, aq_mode=2)),
    # CTU64 depth 3 with RDOQ, sign hiding, psy-rd; depth 2 at 10 bits;
    # a batch of 2
    "ctu64_rdoq": (lambda: synth(1), "intra",
                   dict(width=128, height=128, qp=30, cu_size=64,
                        max_depth=3, rdoq=True, psy_rdoq=1.0,
                        deblock=True)),
    "ctu64_sbh": (lambda: synth(1), "intra",
                  dict(width=128, height=128, qp=30, cu_size=64,
                       max_depth=3, sbh=True, deblock=True)),
    "ctu64_psy": (lambda: synth(1), "intra",
                  dict(width=128, height=128, qp=30, cu_size=64,
                       max_depth=3, psy_rd=2.0, deblock=True)),
    "ctu64_10bit": (lambda: deep10(synth(1)), "intra",
                    dict(width=128, height=128, qp=30, cu_size=64,
                         max_depth=2, bit_depth=10, deblock=True,
                         hash_type=2)),
    "ctu64_batch2": (lambda: synth(2, 128, 64), "batch",
                     dict(width=128, height=64, qp=30, cu_size=64,
                          max_depth=2, deblock=True)),
    # the reference's fault: CTU64 under wpp signals WPP in the PPS and
    # codes one substream (two CTU rows)
    "ctu64_wpp": (lambda: synth(1), "intra",
                  dict(width=128, height=128, qp=30, cu_size=64, max_depth=2,
                       wpp=True)),
}

PINS = {
    "i444_intra": ("f28c2f2d24292c99c82c5502574c12a5", [(0, 'I', 30)]),
    "i444_multiframe": (
        "24cf69509063d985d3046a6a88c32c4d",
        [(0, 'I', 32), (0, 'I', 32)]),
    "i444_batch_ctu32": (
        "10db34cb44d264e985e01c315c566bb2",
        [(0, 'I', 34), (0, 'I', 34)]),
    "nr_1000": (
        "90b5028fc574505d655e4b5ceda2abec",
        [(0, 'I', 30), (0, 'I', 30), (0, 'I', 30), (0, 'I', 30), (0, 'I', 30),
         (0, 'I', 30)]),
    "nr_0": (
        "ad2f4a1ed1ce90c3fe057a0999b67964",
        [(0, 'I', 30), (0, 'I', 30), (0, 'I', 30), (0, 'I', 30), (0, 'I', 30),
         (0, 'I', 30)]),
    "nr_batch": (
        "81ea8aa04bba31608b2f1789e4e15e01",
        [(0, 'I', 30), (0, 'I', 30), (0, 'I', 30)]),
    "fast_intra": ("97c5d03cebfcdb4992024598f554da36", [(0, 'I', 30)]),
    "fast_intra_aq": (
        "1f07316e35f7c7925d3784dc0af88476",
        [(0, 'I', 30), (0, 'I', 30)]),
    "ctu64_d2": ("943ec998a24cb00de51f4b62f91482f7", [(0, 'I', 30)]),
    "ctu64_d3_deblock": ("8b758bab7e1f18770cd2184d31280a87", [(0, 'I', 30)]),
    "ctu64_aq_cropped": ("d6922db334c94c8ab0209ce6f5d18d20", [(0, 'I', 32)]),
    "ctu64_rdoq": ("186b6b763027312de6cbe5ea7f7da9cd", [(0, 'I', 30)]),
    "ctu64_sbh": ("1a1a43fac9337c4c4810b6b05f2c02fd", [(0, 'I', 30)]),
    "ctu64_psy": ("ba871894cc07d0e2efeee3fc05722705", [(0, 'I', 30)]),
    "ctu64_10bit": ("0005a2b34a4759d6eadf017409650efa", [(0, 'I', 30)]),
    "ctu64_batch2": (
        "72a86101dd5db3155fd6a628a3803403",
        [(0, 'I', 30), (0, 'I', 30)]),
    "ctu64_wpp": ("9bfe64ec1ae98398e1d5b23194ace6e8", [(0, 'I', 30)]),
}


def run(top, name: str, **kw):
    """The session `name` of the encoder_top module `top` (the port's or
    the JAX package's) over its clip: (stream md5, [(POC, type, QP)], the
    stream, the results). kw goes to the session (the port's device)."""
    clip, mode, opts = SESSIONS[name]
    opts = dict(opts)
    w, h = opts.pop("width"), opts.pop("height")
    s = top.IntraEncoderSession(w, h, **opts, **kw)
    frames = clip()
    res = s.encode_batch(frames) if mode == "batch" else \
        [s.encode_frame(*f) for f in frames]
    stream = s.headers() + b"".join(r.nals for r in res)
    return (hashlib.md5(stream).hexdigest(),
            [(0, r.frame_type, r.qp) for r in res], stream, res)


# ---------------------------------------------------------------------------
# command lines over the golden clip
# ---------------------------------------------------------------------------

CLI = {
    "ctu64": ["--ctu", "64", "--keyint", "1", "--qp", "32"],
    "nr500": ["--keyint", "1", "--qp", "30", "--nr-intra", "500"],
    "nr500_fb1": ["--keyint", "1", "--qp", "30", "--nr-intra", "500",
                  "--frame-batch", "1"],
    # a 4:4:4 y4m: one batch of 4 frames (no AQ in a batch), and 5 frames
    # without AQ (the fifth coded alone: the reference's AQ fails on
    # 4:4:4 planes, ROADMAP Queue 3)
    "i444": ["--keyint", "1", "--qp", "30", "--frames", "4"],
    "i444_aq0": ["--keyint", "1", "--qp", "30", "--aq-mode", "0"],
}
_HEAD = "Encode Order, Type, POC, QP, Bits, PSNR Y, PSNR U, PSNR V, SSIM Y\n"
CLI_PINS = {
    "ctu64": (
        "101dbcef6b24b334e443327c74a6743b",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 32, 4664, 29.2098, 44.0156, 44.2290, 0.82306\n"
        "1, I, 0, 32, 4640, 29.0167, 45.1432, 45.1603, 0.81800\n"
        "2, I, 0, 32, 4616, 28.8322, 46.8899, 45.7688, 0.80587\n"
        "3, I, 0, 32, 4584, 28.8190, 46.6987, 46.3850, 0.80462\n"
        "4, I, 0, 32, 5184, 30.0499, 45.8383, 45.7199, 0.85365\n"
        "Summary, frames=5, kbps=118.44, Global PSNR Y=29.1855, "
        "U=45.7171, V=45.4526, SSIM Y=0.82104\n"),
    "nr500": (
        "82adba2c3af3d7df1d2401fa97a8dec3",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 30, 5736, 31.3541, 45.6363, 44.6927, 0.89173\n"
        "1, I, 0, 30, 5664, 30.8557, 46.5469, 47.2072, 0.87882\n"
        "2, I, 0, 30, 5840, 31.2619, 46.7068, 45.7459, 0.88988\n"
        "3, I, 0, 30, 5752, 30.8650, 46.6542, 45.8084, 0.87608\n"
        "4, I, 0, 30, 6296, 31.8869, 46.0292, 46.6825, 0.90521\n"
        "Summary, frames=5, kbps=146.44, Global PSNR Y=31.2447, "
        "U=46.3147, V=46.0273, SSIM Y=0.88835\n"),
    "nr500_fb1": (
        "4db39a2f440c50c8cb7f8f2b7acf6e3d",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 30, 6320, 32.0021, 46.4498, 45.2380, 0.90752\n"
        "1, I, 0, 30, 6232, 31.9254, 46.5469, 47.2072, 0.90504\n"
        "2, I, 0, 30, 6312, 31.7558, 47.8041, 46.6261, 0.89945\n"
        "3, I, 0, 30, 6160, 32.0592, 48.1992, 48.1026, 0.90681\n"
        "4, I, 0, 30, 6296, 31.8869, 46.0292, 46.6825, 0.90521\n"
        "Summary, frames=5, kbps=156.60, Global PSNR Y=31.9259, "
        "U=47.0058, V=46.7713, SSIM Y=0.90481\n"),
    "i444": (
        "f6ee360b6d6af7d4352a8c66e5eb7c50",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 30, 5784, 31.0808, 36.3836, 36.5905, 0.88544\n"
        "1, I, 0, 30, 5752, 31.0825, 36.4341, 36.3659, 0.88715\n"
        "2, I, 0, 30, 5656, 30.9856, 36.3703, 36.3702, 0.88329\n"
        "3, I, 0, 30, 5744, 31.1121, 36.1557, 36.3599, 0.88469\n"
        "Summary, frames=4, kbps=143.35, Global PSNR Y=31.0653, "
        "U=36.3359, V=36.4216, SSIM Y=0.88514\n"),
    "i444_aq0": (
        "c6debe9a4a5fc9a00f68d27567f37baa",
        [32, 33, 34, 39, 19, 40, 19, 40, 19, 40, 19, 40, 19, 40],
        _HEAD +
        "0, I, 0, 30, 5784, 31.0808, 36.3836, 36.5905, 0.88544\n"
        "1, I, 0, 30, 5752, 31.0825, 36.4341, 36.3659, 0.88715\n"
        "2, I, 0, 30, 5656, 30.9856, 36.3703, 36.3702, 0.88329\n"
        "3, I, 0, 30, 5744, 31.1121, 36.1557, 36.3599, 0.88469\n"
        "4, I, 0, 30, 5624, 31.2061, 36.3798, 36.4883, 0.88717\n"
        "Summary, frames=5, kbps=142.80, Global PSNR Y=31.0934, "
        "U=36.3447, V=36.4350, SSIM Y=0.88555\n"),
}


def golden444(n: int = GOLDEN_FRAMES):
    """The golden clip at 4:4:4: its chroma planes doubled in size, with
    seeded noise so that the samples differ."""
    rng = np.random.default_rng(6)
    out = []
    for y, u, v in golden_corpus.clip(n=n):
        up = lambda p: np.clip(p.repeat(2, 0).repeat(2, 1).astype(np.int32)
                               + rng.integers(-6, 7, y.shape), 0, 255)
        out.append((y, up(u).astype(np.uint8), up(v).astype(np.uint8)))
    return out


def write_clip(path: str, i444: bool = False,
               n: int = GOLDEN_FRAMES) -> None:
    """The golden clip's first n frames (4:4:4 with i444) as a y4m file
    (the port's writer)."""
    from x265_yuuki_asuna_tpu_torch.utils import io as IO
    csp = IO.CSP_I444 if i444 else IO.CSP_I420
    wr = IO.Y4MWriter(path, IO.VideoInfo(64, 48, 25, 1, csp, 8))
    for f in golden444(n) if i444 else golden_corpus.clip(n=n):
        wr.write_frame(*f)
    wr.close()


def run_cli(cli_main, name: str, workdir: str, **kw):
    """One command line in workdir: (stream md5, NAL types, CSV text)."""
    src, dst = f"{workdir}/{name}.y4m", f"{workdir}/{name}.hevc"
    csv = f"{workdir}/{name}.csv"
    write_clip(src, i444=name.startswith("i444"))
    assert cli_main([src, "-o", dst, "--csv", csv] + CLI[name], **kw) == 0
    with open(dst, "rb") as f:
        data = f.read()
    with open(csv) as f:
        return (hashlib.md5(data).hexdigest(), preset_pins.nal_types(data),
                f.read())
