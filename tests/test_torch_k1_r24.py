"""K1 at search range 24, the library's (api.Encoder: min(merange, 24)),
against the JAX package (CPU, exact): the plain surface with the
per-size argmin and the plain fused sweep-and-argmin against the Pallas
kernel in interpret mode and the JAX XLA sweep (as test_torch_me.py holds
them at R = 6 and 16), the uniform grid's full search, and the fused
kernel's key layout at 1080p. The sweeps are held to pinned digests of
the Pallas-interpret and XLA outputs (equal to each other; the interpret
mode takes seconds a case), which the slow tests recompute. The CUDA
kernels are held against these plain versions at R = 24 on the card (the
gpu test below and chip_smoke.py's k1 phase)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_me import _planes, _same
from test_torch_qt_ops import digest
from x265_yuuki_asuna_tpu.ops import me as j_me
from x265_yuuki_asuna_tpu.ops.pallas.me_sad import sad_sweep_multi_pallas
from x265_yuuki_asuna_tpu_torch.ops import me as t_me
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)
R = 24


SWEEPS = [
    ("textured", 32, 64, (8, 16, 32)),    # the quadtree's three sizes
    ("flat", 32, 64, (8, 16, 32)),
    ("textured", 24, 32, (8,)),           # range larger than the plane
]
BESTS = [
    ("textured", 8, 2), ("textured", 16, 1),
    ("flat", 16, 0),                      # every cost ties: (-R, -R)
    ("flat", 8, 2),                       # the rate breaks the tie: (0, 0)
]
# digest() of the Pallas-interpret and XLA sweeps' (mvx, mvy, sad) of each
# size in order, per case of SWEEPS and BESTS
SWEEP_DIGEST = {
    ("textured", 32, 64):
        "8fe18fb641606aefc48bd6977f04d5cafabba6e931dce8f122239d4fc921ee08",
    ("flat", 32, 64):
        "a20cf59a0f312e182e98849e3bef84e8bd16a6556d86db5206a731e27887613d",
    ("textured", 24, 32):
        "4472b893dfe15dec4922b10983980651f944377fee0e940f9e16e4ab17351504"}
BEST_DIGEST = {
    ("textured", 8, 2):
        "1ae6a0951df24d78e0807feff2edbd19b2302d840ca7594c48e08340a5e98a0b",
    ("textured", 16, 1):
        "37db7c16fd5fce5bdc2797d5a361a3d64c1f53fc6f8201c23c21e3462f3655a5",
    ("flat", 16, 0):
        "1cd26b6c54a280898dfb158e2b426293614e1fc2bbf8e21d38441c3f706b6712",
    ("flat", 8, 2):
        "de75186f9667c9384dcf87372ca0509ac85e7a465663d5205294f162c507351e"}


def _jax_sweeps(ref, src, sizes, lam):
    """The Pallas kernel (interpret mode) and the XLA sweep at R = 24:
    {n: (mvx, mvy, sad)} each."""
    p = sad_sweep_multi_pallas(jnp.asarray(ref), jnp.asarray(src), sizes, R,
                               lambda_bits=lam, interpret=True)
    x = j_me.sad_sweep_multi(jnp.asarray(ref), jnp.asarray(src), sizes, R,
                             lambda_bits=lam)
    return p, x


@pytest.mark.parametrize("kind,H,W,sizes", SWEEPS)
def test_r24_sweep_matches_pallas_and_xla(kind, H, W, sizes):
    ref, src = _planes(kind, H, W, seed=24)
    t = t_me.sad_sweep_multi(torch.from_numpy(ref), torch.from_numpy(src),
                             sizes, R, lambda_bits=2)
    assert digest([a for n in sizes for a in t[n]]) == \
        SWEEP_DIGEST[(kind, H, W)]


@pytest.mark.parametrize("kind,n,lam", BESTS)
def test_r24_sweep_best_matches_pallas_and_xla(kind, n, lam):
    ref, src = _planes(kind, 64, 96, seed=25)
    tr, ts = torch.from_numpy(ref), torch.from_numpy(src)
    plain = me_sad.sad_sweep_best_plain(tr, ts, R, n, lam)
    assert digest(plain) == BEST_DIGEST[(kind, n, lam)]
    if kind == "flat":
        want = -R if lam == 0 else 0
        assert (plain[0] == want).all() and (plain[1] == want).all()


@pytest.mark.slow
@pytest.mark.parametrize("kind,H,W,sizes", SWEEPS)
def test_r24_sweep_digest_from_pallas_and_xla(kind, H, W, sizes):
    """Where SWEEP_DIGEST comes from: the live Pallas and XLA sweeps,
    equal to the port's plain surface route array for array."""
    ref, src = _planes(kind, H, W, seed=24)
    t = t_me.sad_sweep_multi(torch.from_numpy(ref), torch.from_numpy(src),
                             sizes, R, lambda_bits=2)
    p, x = _jax_sweeps(ref, src, sizes, 2)
    for n in sizes:
        _same(p[n], t[n])
        _same(x[n], t[n])
    assert digest([a for n in sizes for a in x[n]]) == \
        SWEEP_DIGEST[(kind, H, W)]


@pytest.mark.slow
@pytest.mark.parametrize("kind,n,lam", BESTS)
def test_r24_sweep_best_digest_from_pallas_and_xla(kind, n, lam):
    """Where BEST_DIGEST comes from: the live Pallas and XLA sweeps,
    equal to the port's plain fused sweep."""
    ref, src = _planes(kind, 64, 96, seed=25)
    plain = me_sad.sad_sweep_best_plain(torch.from_numpy(ref),
                                        torch.from_numpy(src), R, n, lam)
    p, x = _jax_sweeps(ref, src, (n,), lam)
    _same(p[n], plain)
    _same(x[n], plain)
    assert digest(x[n]) == BEST_DIGEST[(kind, n, lam)]


def test_r24_full_search_matches_jax():
    H, W, n = 64, 96, 16
    ref, src = _planes("textured", H, W, seed=26)
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


def test_r24_key_layout_fits_int32():
    """49 x 49 displacements need 12 index bits; a 16x16 uint8 block's
    cost with the rate 17 bits: the key stays int32."""
    assert me_sad.key_layout(torch.uint8, 16, R, 2) == (12, torch.int32)
    assert me_sad.key_layout(torch.uint8, 8, R, 2) == (12, torch.int32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1's kernels run on the card only)")


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,sizes", [(1088, 1920, (8, 16)),
                                       (24, 32, (8,))])
def test_r24_kernels_match_plain_on_the_card(H, W, sizes):
    _need_card()
    ref, src = _planes("textured", H, W, seed=27)
    r8 = torch.from_numpy(ref.astype(np.uint8)).cuda()
    s8 = torch.from_numpy(src.astype(np.uint8)).cuda()
    surf = me_sad.sad_block8_sweep(r8, s8, R)
    assert torch.equal(surf.cpu(), me_sad.sad_block8_sweep_plain(
        r8.cpu(), s8.cpu(), R))
    for n in sizes:
        got = me_sad.sad_sweep_best(r8, s8, R, n, 2)
        want = me_sad.sad_sweep_best_plain(r8.cpu(), s8.cpu(), R, n, 2)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
