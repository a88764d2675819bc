"""Seeded decision arrays for the CTU64 P / B CABAC writer
(`bitstream/native.encode_slice_qt64`) and the md5 of the JAX package's
output over them, shared by tests/test_torch_native_writers.py and
chip_smoke.py (this module imports neither JAX nor the JAX package).
The pins were computed from the JAX package's writer at commit e5e1e58;
the test file also compares the two writers live."""
import hashlib

import numpy as np

QP = 30
R64, C64 = 2, 3                 # CTU64s; the CTU32 grid is 4 x 6
R32, C32 = 2 * R64, 2 * C64


def levels(rng, shape, density=0.08, peak=6):
    """Sparse signed levels: each entry nonzero with the given density."""
    lv = rng.integers(-peak, peak + 1, shape).astype(np.int32)
    return np.where(rng.random(shape) < density, lv, 0).astype(np.int32)


def qt2_dict(rng, b: bool) -> dict:
    """A depth-2 quadtree decision dict of the CTU32 grid (the JAX
    quadtree programs' keys), with B motion when b."""
    n = R32 * C32
    mv = lambda shape, k: rng.integers(-k, k + 1, shape).astype(np.int32)
    pdir = lambda shape: (rng.integers(1, 4, shape) if b
                          else np.ones(shape)).astype(np.int32)
    out = {"split": (rng.random((R32, C32)) < 0.6).astype(np.uint8),
           "split16": (rng.random((n, 4)) < 0.4).astype(np.uint8),
           "tu_split32": (rng.random((R32, C32)) < 0.5).astype(np.uint8),
           "use_intra": (rng.random((R32, C32)) < 0.1).astype(np.uint8),
           "modes": rng.integers(0, 35, (R32, C32)).astype(np.int32),
           "use_intra4": (rng.random((n, 4)) < 0.1).astype(np.uint8),
           "modes4": rng.integers(0, 35, (n, 4)).astype(np.int32),
           "use_intra8": (rng.random((n, 16)) < 0.1).astype(np.uint8),
           "modes8": rng.integers(0, 35, (n, 16)).astype(np.int32),
           "levels_y": levels(rng, (R32, C32, 32, 32)),
           "levels_cb": levels(rng, (R32, C32, 16, 16)),
           "levels_cr": levels(rng, (R32, C32, 16, 16))}
    for sfx, shape in (("", (R32, C32)), ("4", (n, 4)), ("8", (n, 16))):
        out["pdir" + sfx] = pdir(shape)
        out[f"mv{sfx}x"], out[f"mv{sfx}y"] = mv(shape, 12), mv(shape, 8)
        out[f"mv{sfx}1x"], out[f"mv{sfx}1y"] = mv(shape, 12), mv(shape, 8)
    return out


# (slice type, extras): CTU64s that split into CTU32 trees (depth 2
# inside) and CTU64s coded as one CU64 ("whole64"), with SAO and a QP map
# per CTU64 and the RQT's split flag
QT64_CASES = {"p": (1, "plain"), "b": (0, "plain"), "p_sao_qp": (1, "sao_qp"),
              "b_sao_qp_rqt": (0, "sao_qp_rqt"), "p_whole64": (1, "whole64")}


def qt64_args(name: str):
    """encode_slice_qt64's (positional arguments, keywords) of a case."""
    slice_type, extras = QT64_CASES[name]
    rng = np.random.default_rng(40 + slice_type + len(extras))
    out = qt2_dict(rng, slice_type == 0)
    split64 = (np.zeros(R64 * C64) if extras == "whole64"
               else rng.random(R64 * C64) < 0.5).astype(np.uint8)
    mot64 = ((rng.integers(1, 4, R64 * C64) if slice_type == 0
              else np.ones(R64 * C64)).astype(np.int32),
             *(rng.integers(-9, 10, R64 * C64).astype(np.int32)
               for _ in range(4)))
    kw = dict(max_merge=int(rng.integers(1, 6)), sign_hiding=True,
              poc=4, poc_l0=2, poc_l1=8 if slice_type == 0 else 0)
    if extras.startswith("sao_qp"):
        sao = np.zeros((R64 * C64, 18), np.int32)
        sao[:, 0] = sao[:, 6] = sao[:, 12] = rng.integers(0, 3, R64 * C64)
        sao[:, 1] = sao[:, 7] = rng.integers(0, 4, R64 * C64)
        sao[:, 2:6] = sao[:, 8:12] = sao[:, 14:18] = rng.integers(
            0, 4, (R64 * C64, 4))
        kw.update(sao=sao, qp_map=QP + rng.integers(-3, 4, (R64, C64)))
    if extras.endswith("rqt"):
        kw.update(max_tt=1)
    return (slice_type, out, split64, mot64, R64, C64, QP), kw


def digest(res) -> str:
    """md5 of a writer's (payload, tail, tail_bits)."""
    data, tail, tail_bits = res
    return hashlib.md5(data + f"|{tail}|{tail_bits}".encode()).hexdigest()


QT64_PINS = {'p': '581bebda324a99ad3e01c523ab072ea2',
 'b': '6bf3c23ce8a318983f5fe839e603477c',
 'p_sao_qp': '0c307244b0ddae5a1df19079dc4f1cff',
 'b_sao_qp_rqt': 'a9cd79a9cbd36c0b33ce2cb345eeb9d3',
 'p_whole64': '36e3c48323608a1460a2770a6246b2c6'}
