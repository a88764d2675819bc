"""The port's CTU32 depth-2 quadtree programs against the JAX package's
(CPU, 128x96, exact): every key of the intra, the P and the B decision
dict, recon included, and of the intra dict under a non-uniform per-CTU
QP map (AQ / cuTree). The content mixes smooth gradients, strong texture
and, in the P frame, a patch the reference picture does not have, so the
decided trees hold 32, 16 and 8 leaves and the P frame has intra leaves.
The B frame takes the I frame's recon as L0 and the P frame's as L1; its
source is the first frame on top, the second at the bottom and their mean
between, so L0, L1 and bi each win somewhere.

The JAX programs take minutes to compile on the CPU, so the tier-1 tests
hold the port's dicts to digests of the JAX dicts pinned here (sha256 of
every array in key order; the P and B frames predict from the port's own
recon, which equals the JAX recon while the intra digest holds); the slow
test recomputes the digests from the live JAX programs and compares the
dicts key by key."""
import hashlib

import numpy as np
import pytest
import torch

from golden_corpus import clip
from x265_yuuki_asuna_tpu.models.inter_encoder import (InterFrameConfig,
                                                       InterFrameEncoder)
from x265_yuuki_asuna_tpu.models.intra_encoder import (IntraFrameConfig,
                                                       IntraFrameEncoder)
from x265_yuuki_asuna_tpu_torch.models.inter_encoder import InterQTEncoder
from x265_yuuki_asuna_tpu_torch.models.intra_encoder import IntraQTEncoder

torch.set_num_threads(2)
W, H = 128, 96
# a non-uniform per-CTU QP map of the 3 x 4 CTUs, and its slice QP
QMAP = np.array([[24, 30, 36, 27], [33, 38, 25, 31], [29, 35, 26, 32]],
                np.int32)
QMAP_SLICE = 30
# sha256 (digest()) of the JAX package's decision dicts: the intra frame
# at qp 30, the P frame at qp 32, the B frame at qp 33 and the intra frame
# at QMAP
DIGEST = {"intra":
            "9b58e85e956c5f676fa14f64db063a70fff2179d3e67221a1c2d9cf3258fff34",
          "p":
            "7c86f5a97b283ab0059880bb81ea6cbb4c8a36a7aafd1a94525e0dc4117c141d",
          "b":
            "d89ea336841008d3c40e6c22d8353a4f24b5bcd9f2f7de693bddeb98c3cb0f16",
          "intra_aq":
            "7b4283d9137db05eaeff741499b6349998314ee34772eb4c2c5371c20af6922b"}


def _frames():
    """Two frames: the golden clip's moving texture, with strong noise in
    the left half (deep splits), and in the second frame a new noise
    patch (intra leaves)."""
    rng = np.random.default_rng(21)
    f0, f1 = clip(W, H, n=2, seed=5)
    noise = rng.integers(-40, 40, (H, W // 2))
    out = []
    for i, (y, u, v) in enumerate((f0, f1)):
        y = y.astype(np.int32)
        y[:, :W // 2] += np.roll(noise, 2 * i, 1)
        if i:
            y[40:72, 72:112] = rng.integers(0, 256, (32, 40))
        out.append((np.clip(y, 0, 255).astype(np.uint8), u, v))
    return out


def _b_frame(f0, f1):
    """The B frame's source: f0's top third, the mean of both, f1's
    bottom third (per plane)."""
    out = []
    for a, b in zip(f0, f1):
        t = a.shape[0] // 3
        m = ((a.astype(np.int32) + b + 1) // 2).astype(np.uint8)
        out.append(np.concatenate([a[:t], m[t:2 * t], b[2 * t:]]))
    return tuple(out)


def _jax_dict(out):
    """A JAX device-DPB decision dict with its recon materialised."""
    out = dict(out)
    rec = out.pop("recon_dev")
    out.pop("sao_dev")
    for k, p in zip(("recon_y", "recon_u", "recon_v"), rec):
        out[k] = np.asarray(p).astype(np.int32)
    return out


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


def _assert_same_dict(j, t):
    t = dict(t)
    t.pop("recon_dev")
    assert set(j) == set(t)
    for k, v in j.items():
        if v is None:
            assert t[k] is None, k
        else:
            assert np.array_equal(np.asarray(v), t[k]), k


def _recon(d):
    return d["recon_y"], d["recon_u"], d["recon_v"]


@pytest.fixture(scope="module")
def port_frames():
    """The port's dicts: I (qp 30), P (qp 32) from the I recon, B (qp 33)
    from both, and I at QMAP."""
    f0, f1 = _frames()
    ti = IntraQTEncoder(W, H, "cpu").encode_frame(*f0, 30)
    tp = InterQTEncoder(W, H, "cpu").encode_frame(*f1, *_recon(ti), 32)
    fb = _b_frame(f0, f1)
    tb = InterQTEncoder(W, H, "cpu").encode_frame(*fb, *_recon(ti), 33,
                                                  ref1=_recon(tp))
    taq = IntraQTEncoder(W, H, "cpu").encode_frame(*f0, QMAP,
                                                   slice_qp=QMAP_SLICE)
    return {"intra": ti, "p": tp, "b": tb, "intra_aq": taq}


def test_intra_qt_decisions_match_jax(port_frames):
    to = port_frames["intra"]
    assert digest(to) == DIGEST["intra"]
    assert to["split"].any() and to["split16"].any() and not to["split"].all()


def test_p_qt_decisions_match_jax(port_frames):
    to = port_frames["p"]
    assert digest(to) == DIGEST["p"]
    assert to["split"].any() and to["split16"].any()
    assert to["use_intra"].any() or to["use_intra4"].any()
    assert not to["use_intra8"].any()          # P slices: no 8x8 intra


def test_b_qt_decisions_match_jax(port_frames):
    to = port_frames["b"]
    assert digest(to) == DIGEST["b"]
    # every prediction direction occurs, at some size, and no leaf is intra
    pdirs = np.concatenate([to[k].reshape(-1)
                            for k in ("pdir", "pdir4", "pdir8")])
    assert set(np.unique(pdirs)) == {1, 2, 3}
    assert not any(to[k].any() for k in ("use_intra", "use_intra4",
                                         "use_intra8"))


def test_intra_qt_aq_decisions_match_jax(port_frames):
    """The intra program under a per-CTU QP map: per-block QPs and
    lambdas, the commit at each leaf's CTU QP, the K9 contexts from the
    first CTU's QP."""
    to = port_frames["intra_aq"]
    assert digest(to) == DIGEST["intra_aq"]
    plain = port_frames["intra"]
    assert not np.array_equal(to["levels_y"], plain["levels_y"])
    assert not np.array_equal(to["split16"], plain["split16"])


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's dicts of port_frames' frames (four program
    compiles of minutes each)."""
    f0, f1 = _frames()
    enc = IntraFrameEncoder(IntraFrameConfig(
        width=W, height=H, cu_size=32, qp=30, max_depth=2, dpb=True))
    ji = _jax_dict(enc.encode_frame(*f0, qp=30))
    jp = _jax_dict(InterFrameEncoder(InterFrameConfig(
        width=W, height=H, cu_size=32, qp=32, max_depth=2, dpb=True))
        .encode_frame(*f1, *_recon(ji), qp=32))
    fb = _b_frame(f0, f1)
    jb = _jax_dict(InterFrameEncoder(InterFrameConfig(
        width=W, height=H, cu_size=32, qp=33, max_depth=2, dpb=True,
        bi=True, intra_in_b=False)).encode_frame(
            *fb, *_recon(ji), qp=33, ref1_y=jp["recon_y"],
            ref1_u=jp["recon_u"], ref1_v=jp["recon_v"]))
    jaq = _jax_dict(enc.encode_frame(*f0, qp=QMAP.reshape(-1),
                                     slice_qp=QMAP_SLICE))
    return {"intra": ji, "p": jp, "b": jb, "intra_aq": jaq}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(DIGEST))
def test_digests_recomputed_from_the_jax_programs(name, jax_frames,
                                                   port_frames):
    """Where the digests come from: the JAX programs' dicts, which the
    port's equal key by key."""
    assert digest(jax_frames[name]) == DIGEST[name]
    _assert_same_dict(jax_frames[name], port_frames[name])
