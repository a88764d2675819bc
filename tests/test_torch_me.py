"""Motion-estimation parity of the PyTorch port with the JAX package (CPU):
the K1 sweep and fused sweep-and-argmin (their plain versions here; the
CUDA kernels are held against them in test_torch_kernels.py on the card),
the full search, and the lookahead built on them. Exact integer
equality. The sweeps are held to pinned digests of the Pallas-interpret
and XLA outputs (equal to each other; the interpret mode takes seconds a
case), which the slow tests recompute."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x265_yuuki_asuna_tpu.models import lookahead as j_la
from x265_yuuki_asuna_tpu.ops import me as j_me
from x265_yuuki_asuna_tpu.ops.pallas.me_sad import sad_sweep_multi_pallas
from x265_yuuki_asuna_tpu_torch.models import lookahead as t_la
from x265_yuuki_asuna_tpu_torch.ops import me as t_me
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
from test_torch_qt_ops import digest

torch.set_num_threads(2)


def _planes(kind, H, W, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "flat":                    # every displacement ties
        src = np.full((H, W), 77, np.int32)
        return src.copy(), src
    src = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = np.roll(src, (2, -3), (0, 1))
    ref[H // 4:H // 2, W // 4:W // 2] = rng.integers(0, 256,
                                                     (H // 4, W // 4))
    return ref, src


def _same(a, b):
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())


SWEEPS = [
    ("textured", 48, 64, 6, (8, 16)),
    ("flat", 48, 64, 6, (8, 16)),
    ("textured", 24, 32, 16, (8,)),       # range larger than the plane
]
BESTS = [
    ("textured", 48, 64, 6, 8, 0),
    ("textured", 48, 64, 6, 16, 1),
    ("flat", 48, 64, 6, 16, 0),           # every cost ties: (-R, -R)
    ("flat", 48, 64, 6, 8, 1),
    ("textured", 32, 48, 16, 16, 2),      # range larger than the plane
]
# digest() of the Pallas-interpret and XLA sweeps' (mvx, mvy, sad) of each
# size in order, per case of SWEEPS (kind, H, W, R) and BESTS
SWEEP_DIGEST = {
    ("textured", 48, 64, 6):
        "5a9a68886823a64dfd15b2338daf817d463886b3618105fceebfbb2843df19e7",
    ("flat", 48, 64, 6):
        "fa8323a1713905b2965279f76ff8749c3992a1094af724d831de09bff67c1e38",
    ("textured", 24, 32, 16):
        "d18c0e6b75ae84e768bc11245466df8b92b1c3d447a551780cf8c0dbd5b8d276"}
BEST_DIGEST = {
    ("textured", 48, 64, 6, 8, 0):
        "11a7fb575dff4ba011d3b882616fda44caccb16ea5b40e9fbb92879d35d9a0e5",
    ("textured", 48, 64, 6, 16, 1):
        "12d0272b2e31a7d518bc964f43ddf856ef84350fd2197b1f8cbae85f4ea55526",
    ("flat", 48, 64, 6, 16, 0):
        "89b2e92224c56548f2b31dcd841833227e1479839aa01524b82190e7a86f35f5",
    ("flat", 48, 64, 6, 8, 1):
        "2cf88feccc6385a39f371658494a7a550b9164ab486d400709f67085bece63e6",
    ("textured", 32, 48, 16, 16, 2):
        "523398119590345e988dfda829d8d0c42c5b6a1d6b9d1e4e7a84da76bdfcf917"}


def _jax_sweeps(ref, src, sizes, R, lam):
    """The Pallas kernel (interpret mode) and the XLA sweep: {n: (mvx,
    mvy, sad)} each."""
    p = sad_sweep_multi_pallas(jnp.asarray(ref), jnp.asarray(src), sizes, R,
                               lambda_bits=lam, interpret=True)
    x = j_me.sad_sweep_multi(jnp.asarray(ref), jnp.asarray(src), sizes, R,
                             lambda_bits=lam)
    return p, x


def _port_best(kind, H, W, R, n, lam):
    """K1's fused plain version and the single-size route of
    sad_sweep_multi (which takes the fused entry point)."""
    ref, src = _planes(kind, H, W)
    tr, ts = torch.from_numpy(ref), torch.from_numpy(src)
    return (me_sad.sad_sweep_best_plain(tr, ts, R, n, lam),
            t_me.sad_sweep_multi(tr, ts, (n,), R, lambda_bits=lam)[n])


@pytest.mark.parametrize("kind,H,W,R,sizes", SWEEPS)
def test_sweep_matches_pallas_and_xla(kind, H, W, R, sizes):
    ref, src = _planes(kind, H, W)
    t = t_me.sad_sweep_multi(torch.from_numpy(ref), torch.from_numpy(src),
                             sizes, R, lambda_bits=2)
    assert digest([a for n in sizes for a in t[n]]) == \
        SWEEP_DIGEST[(kind, H, W, R)]


@pytest.mark.parametrize("kind,H,W,R,n,lam", BESTS)
def test_sweep_best_matches_pallas_and_xla(kind, H, W, R, n, lam):
    """K1's fused plain version and the single-size route against the
    digest of the JAX sweep and the Pallas kernel with its XLA tail."""
    plain, routed = _port_best(kind, H, W, R, n, lam)
    for t in (plain, routed):
        assert digest(t) == BEST_DIGEST[(kind, H, W, R, n, lam)]
    if kind == "flat" and lam == 0:
        assert (plain[0] == -R).all() and (plain[1] == -R).all()


@pytest.mark.slow
@pytest.mark.parametrize("kind,H,W,R,sizes", SWEEPS)
def test_sweep_digest_from_pallas_and_xla(kind, H, W, R, sizes):
    """Where SWEEP_DIGEST comes from: the live Pallas and XLA sweeps,
    equal to the port's plain surface route array for array."""
    ref, src = _planes(kind, H, W)
    t = t_me.sad_sweep_multi(torch.from_numpy(ref), torch.from_numpy(src),
                             sizes, R, lambda_bits=2)
    p, x = _jax_sweeps(ref, src, sizes, R, 2)
    for n in sizes:
        _same(p[n], t[n])
        _same(x[n], t[n])
    assert digest([a for n in sizes for a in x[n]]) == \
        SWEEP_DIGEST[(kind, H, W, R)]


@pytest.mark.slow
@pytest.mark.parametrize("kind,H,W,R,n,lam", BESTS)
def test_sweep_best_digest_from_pallas_and_xla(kind, H, W, R, n, lam):
    """Where BEST_DIGEST comes from: the live Pallas and XLA sweeps, equal
    to the port's fused plain version and single-size route."""
    ref, src = _planes(kind, H, W)
    p, x = _jax_sweeps(ref, src, (n,), R, lam)
    for t in _port_best(kind, H, W, R, n, lam):
        _same(p[n], t)
        _same(x[n], t)
    assert digest(x[n]) == BEST_DIGEST[(kind, H, W, R, n, lam)]


@pytest.mark.parametrize("kind", ["textured", "flat"])
def test_full_search_matches_jax(kind):
    H, W, n, R = 96, 128, 16, 16
    ref, src = _planes(kind, H, W, seed=9)
    rows, cols = H // n, W // n
    blocks = src.reshape(rows, n, cols, n).transpose(0, 2, 1, 3) \
        .reshape(-1, n, n)
    px = (np.arange(rows * cols) % cols * n).astype(np.int32)
    py = (np.arange(rows * cols) // cols * n).astype(np.int32)
    j = j_me.full_search_sad(jnp.asarray(ref), jnp.asarray(blocks),
                             jnp.asarray(px), jnp.asarray(py), n, R,
                             lambda_bits=2, xp=jnp)
    t = t_me.full_search_sad(torch.from_numpy(ref.astype(np.uint8)),
                             torch.from_numpy(src.astype(np.uint8)), n, R,
                             lambda_bits=2)
    _same(j, t)


def test_sad_at_mv_and_downscale():
    rng = np.random.default_rng(4)
    plane = rng.integers(0, 256, (24, 32)).astype(np.int32)
    blocks = rng.integers(0, 256, (12, 8, 8)).astype(np.int32)
    px = (np.arange(12) % 4 * 8).astype(np.int32)
    py = (np.arange(12) // 4 * 8).astype(np.int32)
    mvx = rng.integers(-20, 20, (12,)).astype(np.int32)
    mvy = rng.integers(-20, 20, (12,)).astype(np.int32)
    j = j_me.sad_at_mv(jnp.asarray(plane), jnp.asarray(blocks),
                       jnp.asarray(px), jnp.asarray(py), jnp.asarray(mvx),
                       jnp.asarray(mvy), 8, xp=jnp)
    t = t_me.sad_at_mv(*(torch.from_numpy(a) for a in
                         (plane, blocks, px, py, mvx, mvy)), 8)
    assert np.array_equal(np.asarray(j), t.numpy())
    y = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    assert np.array_equal(np.asarray(j_la.downscale_half(jnp.asarray(y),
                                                         xp=jnp)),
                          t_la.downscale_half(torch.from_numpy(y)).numpy())


def test_lookahead_push_sequence():
    W, H = 128, 96
    rng = np.random.default_rng(1)
    base = (np.add.outer(np.arange(H), np.arange(W)) % 256).astype(np.uint8)
    tex = rng.integers(0, 40, (H, W)).astype(np.uint8)
    frames = [base + np.roll(tex, (i, 2 * i), (0, 1)) for i in range(3)]
    frames.append((255 - base) // 2 + rng.integers(0, 60, (H, W))
                  .astype(np.uint8))                           # a cut
    frames.append(frames[-1])
    ja = j_la.Lookahead(W, H)
    ta = t_la.Lookahead(W, H, "cpu")
    cuts = []
    for y in frames:
        jr, tr = ja.push(y), ta.push(y)
        assert jr == tr
        for k, v in ja.last_detail.items():
            assert np.array_equal(np.asarray(v), np.asarray(
                ta.last_detail[k])), k
        cuts.append(tr[2])
    assert cuts == [False, False, False, True, False]
