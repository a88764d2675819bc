"""The port's CTU32 depth-2 quadtree programs against the JAX package's
(CPU, 128x96, exact): every key of the intra, the P and the B decision
dict, recon included. The content mixes smooth gradients, strong texture
and, in the P frame, a patch the reference picture does not have, so the
decided trees hold 32, 16 and 8 leaves and the P frame has intra leaves.
The B frame takes the I frame's recon as L0 and the P frame's as L1; its
source is the first frame on top, the second at the bottom and their mean
between, so L0, L1 and bi each win somewhere."""
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


def _assert_same_dict(j, t):
    t = dict(t)
    t.pop("recon_dev")
    assert set(j) == set(t)
    for k, v in j.items():
        if v is None:
            assert t[k] is None, k
        else:
            assert np.array_equal(np.asarray(v), t[k]), k


@pytest.fixture(scope="module")
def jax_frames():
    f0, f1 = _frames()
    ji = _jax_dict(IntraFrameEncoder(IntraFrameConfig(
        width=W, height=H, cu_size=32, qp=30, max_depth=2, dpb=True))
        .encode_frame(*f0, qp=30))
    refs = (ji["recon_y"], ji["recon_u"], ji["recon_v"])
    jp = _jax_dict(InterFrameEncoder(InterFrameConfig(
        width=W, height=H, cu_size=32, qp=32, max_depth=2, dpb=True))
        .encode_frame(*f1, *refs, qp=32))
    fb = _b_frame(f0, f1)
    jb = _jax_dict(InterFrameEncoder(InterFrameConfig(
        width=W, height=H, cu_size=32, qp=33, max_depth=2, dpb=True,
        bi=True, intra_in_b=False)).encode_frame(
            *fb, *refs, qp=33, ref1_y=jp["recon_y"], ref1_u=jp["recon_u"],
            ref1_v=jp["recon_v"]))
    return f0, f1, ji, jp, fb, jb


def test_intra_qt_decisions_match_jax(jax_frames):
    f0, _, ji, *_ = jax_frames
    to = IntraQTEncoder(W, H, "cpu").encode_frame(*f0, 30)
    _assert_same_dict(ji, to)
    assert to["split"].any() and to["split16"].any() and not to["split"].all()


def test_p_qt_decisions_match_jax(jax_frames):
    _, f1, ji, jp, *_ = jax_frames
    refs = (ji["recon_y"], ji["recon_u"], ji["recon_v"])
    to = InterQTEncoder(W, H, "cpu").encode_frame(*f1, *refs, 32)
    _assert_same_dict(jp, to)
    assert to["split"].any() and to["split16"].any()
    assert to["use_intra"].any() or to["use_intra4"].any()
    assert not to["use_intra8"].any()          # P slices: no 8x8 intra


def test_b_qt_decisions_match_jax(jax_frames):
    _, _, ji, jp, fb, jb = jax_frames
    ref0 = (ji["recon_y"], ji["recon_u"], ji["recon_v"])
    ref1 = (jp["recon_y"], jp["recon_u"], jp["recon_v"])
    to = InterQTEncoder(W, H, "cpu").encode_frame(*fb, *ref0, 33, ref1=ref1)
    _assert_same_dict(jb, to)
    # every prediction direction occurs, at some size, and no leaf is intra
    pdirs = np.concatenate([to[k].reshape(-1)
                            for k in ("pdir", "pdir4", "pdir8")])
    assert set(np.unique(pdirs)) == {1, 2, 3}
    assert not any(to[k].any() for k in ("use_intra", "use_intra4",
                                         "use_intra8"))
