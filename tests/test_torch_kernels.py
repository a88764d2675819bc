"""K1 (the SAD-sweep CUDA kernels) of the PyTorch port: the plain versions
of the surface (sad_block8_sweep) and of the fused sweep-and-argmin
(sad_sweep_best) against brute-force numpy sweeps, the fused kernel's key
layout, and the wrappers' checks on the CPU; both kernels against their
plain versions, and the golden stream, on the card:
    python -m pytest -m gpu tests/test_torch_*.py
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "manifest.json")


def _brute(ref, src, R):
    """[D, D, H/8, W/8] block SADs by explicit displacement loops over an
    edge-padded numpy reference."""
    H, W = src.shape
    D = 2 * R + 1
    pad = np.pad(ref.astype(np.int64), R, mode="edge")
    out = np.zeros((D, D, H // 8, W // 8), np.int64)
    for dy in range(D):
        for dx in range(D):
            d = np.abs(pad[dy:dy + H, dx:dx + W] - src)
            out[dy, dx] = d.reshape(H // 8, 8, W // 8, 8).sum(axis=(1, 3))
    return out


@pytest.mark.parametrize("kind,H,W,R", [("textured", 16, 24, 3),
                                        ("flat", 16, 24, 3),
                                        ("textured", 24, 32, 16)])
def test_k1_plain_matches_brute_force(kind, H, W, R):
    rng = np.random.default_rng(H + R)
    src = rng.integers(0, 256, (H, W)) if kind == "textured" \
        else np.full((H, W), 9)
    ref = rng.integers(0, 256, (H, W))
    got = me_sad.sad_block8_sweep(torch.as_tensor(ref, dtype=torch.int16),
                                  torch.as_tensor(src, dtype=torch.int16), R)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _brute(ref, src, R))


def test_k1_wrapper_rejects_bad_planes():
    a = torch.zeros((24, 30), dtype=torch.int32)
    with pytest.raises(ValueError):
        me_sad.sad_block8_sweep(a, a, 4)
    b = torch.zeros((24, 32), dtype=torch.float32)
    with pytest.raises(TypeError):
        me_sad.sad_block8_sweep(b, b, 4)
    with pytest.raises(TypeError):
        me_sad.sad_block8_sweep(b.to(torch.uint8), b.to(torch.int32), 4)


def _brute_best(ref, src, R, n, lam):
    """(mvx, mvy, sad) of each n x n block: the first minimum of SAD +
    lam * (|dx| + |dy|) over (dy, dx) in row-major order."""
    H, W = src.shape
    D = 2 * R + 1
    f = n // 8
    s = _brute(ref, src, R).reshape(D, D, H // n, f, W // n, f) \
        .sum(axis=(3, 5)).reshape(D * D, -1)
    d = np.abs(np.arange(D) - R)
    cost = s + lam * (d[:, None] + d[None, :]).reshape(D * D, 1)
    best = np.argmin(cost, axis=0)                 # the first minimum
    return best % D - R, best // D - R, s[best, np.arange(s.shape[1])]


@pytest.mark.parametrize("kind,H,W,R,n,lam", [
    ("textured", 16, 32, 3, 8, 1),
    ("textured", 32, 48, 4, 16, 2),
    ("flat", 16, 32, 3, 16, 0),           # every cost ties: (-R, -R)
    ("textured", 16, 16, 16, 8, 0),       # range larger than the plane
])
def test_sweep_best_plain_matches_brute_force(kind, H, W, R, n, lam):
    rng = np.random.default_rng(H + R + n)
    src = rng.integers(0, 256, (H, W)) if kind == "textured" \
        else np.full((H, W), 9)
    ref = rng.integers(0, 256, (H, W)) if kind == "textured" else src
    got = me_sad.sad_sweep_best(torch.as_tensor(ref, dtype=torch.uint8),
                                torch.as_tensor(src, dtype=torch.uint8), R,
                                n, lam)
    for g, w in zip(got, _brute_best(ref, src, R, n, lam)):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)


def test_sweep_best_key_layout():
    """The fused kernel's key width, and keys cost << shift | (dyi*D + dxi)
    sorting as (cost, dy, dx) and unpacking to (mvx, mvy, sad)."""
    assert me_sad.key_layout(torch.uint8, 16, 16, 2) == (11, torch.int32)
    assert me_sad.key_layout(torch.uint8, 8, 16, 1) == (11, torch.int32)
    assert me_sad.key_layout(torch.uint8, 16, 3, 0) == (6, torch.int32)
    assert me_sad.key_layout(torch.int16, 16, 16, 2) == (11, torch.int64)
    assert me_sad.key_layout(torch.int32, 8, 16, 1) == (11, torch.int64)
    with pytest.raises(ValueError):
        me_sad.key_layout(torch.uint8, 16, 16, 2 ** 60)
    rng = np.random.default_rng(3)
    R, lam = 16, 2
    D = 2 * R + 1
    for kdt in (torch.int32, torch.int64):
        shift = 11
        dyi, dxi = rng.integers(0, D, 500), rng.integers(0, D, 500)
        sad = rng.integers(0, 16 * 16 * 255 + 1, 500)
        sad[:100] = 7                                # ties on the cost
        cost = sad + lam * (np.abs(dyi - R) + np.abs(dxi - R))
        keys = torch.as_tensor((cost << shift) | (dyi * D + dxi), dtype=kdt)
        order = torch.argsort(keys, stable=True).numpy()
        want = np.lexsort((dxi, dyi, cost))
        assert np.array_equal(np.stack((cost, dyi, dxi))[:, order],
                              np.stack((cost, dyi, dxi))[:, want])
        mvx, mvy, got_sad = me_sad.unpack_keys(keys, R, shift, lam)
        assert np.array_equal(mvx.numpy(), dxi - R)
        assert np.array_equal(mvy.numpy(), dyi - R)
        assert np.array_equal(got_sad.numpy(), sad)


def test_sweep_best_wrapper_rejects_bad_input():
    a = torch.zeros((24, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        me_sad.sad_sweep_best(a, a, 4, 32, 1)        # block size
    with pytest.raises(ValueError):
        me_sad.sad_sweep_best(a, a, 4, 16, 1)        # 24 rows, n = 16
    with pytest.raises(ValueError):
        me_sad.sad_sweep_best(a, a, 4, 8, -1)
    with pytest.raises(TypeError):
        me_sad.sad_sweep_best(a, a.to(torch.int16), 4, 8, 1)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,dtype", [(544, 960, torch.int32),
                                       (1088, 1920, torch.uint8),
                                       (24, 32, torch.int32)])
def test_k1_kernel_matches_plain_on_card(H, W, dtype):
    _need_card()
    rng = np.random.default_rng(H)
    ref, src = (torch.as_tensor(rng.integers(0, 256, (H, W)), dtype=dtype,
                                device="cuda") for _ in range(2))
    before = me_sad.sad_block8_sweep.launches
    k = me_sad.sad_block8_sweep(ref, src, 16)
    torch.cuda.synchronize()
    assert me_sad.sad_block8_sweep.launches == before + 1
    assert torch.equal(k, me_sad.sad_block8_sweep_plain(ref, src, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,dtype,n,lam,flat", [
    (544, 960, torch.uint8, 8, 1, False),          # lookahead
    (1088, 1920, torch.uint8, 16, 2, False),       # P-frame ME
    (24, 32, torch.uint8, 8, 2, False),            # range > plane
    (32, 48, torch.uint8, 16, 0, True),            # all tie: (-R, -R)
    (48, 64, torch.int16, 16, 2, False),
    (48, 64, torch.int32, 8, 1, False)])
def test_sweep_best_kernel_matches_plain_on_card(H, W, dtype, n, lam, flat):
    _need_card()
    rng = np.random.default_rng(H + n)
    ref, src = (torch.as_tensor(np.full((H, W), 77) if flat
                                else rng.integers(0, 256, (H, W)),
                                dtype=dtype, device="cuda") for _ in range(2))
    before = me_sad.sad_sweep_best.launches
    k = me_sad.sad_sweep_best(ref, src, 16, n, lam)
    torch.cuda.synchronize()
    assert me_sad.sad_sweep_best.launches == before + 1
    for a, b in zip(k, me_sad.sad_sweep_best_plain(ref, src, 16, n, lam)):
        assert torch.equal(a, b)
    if flat:
        assert bool((k[0] == -16).all()) and bool((k[1] == -16).all())


@pytest.mark.gpu
def test_golden_stream_on_card():
    _need_card()
    from golden_corpus import clip
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        VideoEncoderSession
    s = VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                            hash_sei=False)
    out = s.headers()
    for f in clip():
        out += s.encode_frame(*f).nals
    with open(GOLDEN) as fh:
        assert hashlib.md5(out).hexdigest() == json.load(fh)["ippp_cqp"]
