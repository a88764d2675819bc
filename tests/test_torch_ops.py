"""Op-level parity of the PyTorch port with the JAX package (CPU).

The same seeded numpy inputs go through the JAX function and its port;
every comparison is exact integer equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x265_yuuki_asuna_tpu.ops import (interp as j_interp, intra as j_intra,
                                      pixel as j_pixel, quant as j_quant,
                                      transforms as j_tr)
from x265_yuuki_asuna_tpu_torch.ops import (interp as t_interp,
                                            intra as t_intra,
                                            pixel as t_pixel,
                                            quant as t_quant,
                                            transforms as t_tr)

torch.set_num_threads(2)


def _eq(a, b):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("n", [8, 16])
def test_transforms_roundtrip(n):
    rng = np.random.default_rng(n)
    resid = rng.integers(-255, 256, (12, n, n)).astype(np.int32)
    coef_j = j_tr.forward_transform(jnp.asarray(resid), 8, xp=jnp)
    coef_t = t_tr.forward_transform(torch.from_numpy(resid), 8)
    _eq(coef_j, coef_t)
    big = rng.integers(-32768, 32768, (12, n, n)).astype(np.int32)
    _eq(j_tr.inverse_transform(jnp.asarray(big), 8, xp=jnp),
        t_tr.inverse_transform(torch.from_numpy(big), 8))


@pytest.mark.parametrize("intra_slice", [True, False])
@pytest.mark.parametrize("qp", [0, 22, 37, 51])
def test_quant_dequant(intra_slice, qp):
    rng = np.random.default_rng(qp)
    coef = rng.integers(-20000, 20000, (10, 16, 16)).astype(np.int32)
    lj, _ = j_quant.quant(jnp.asarray(coef), qp, 4, 8, intra_slice, xp=jnp)
    lt = t_quant.quant(torch.from_numpy(coef), qp, 4, 8, intra_slice)
    _eq(lj, lt)
    _eq(j_quant.dequant(lj, qp, 3, 8, xp=jnp), t_quant.dequant(lt, qp, 3, 8))


@pytest.mark.parametrize("n", [8, 16])
def test_satd_broadcast(n):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (5, 1, n, n)).astype(np.int32)
    b = rng.integers(0, 256, (5, 35, n, n)).astype(np.int32)
    _eq(j_pixel.satd(jnp.asarray(a), jnp.asarray(b), xp=jnp),
        t_pixel.satd(torch.from_numpy(a), torch.from_numpy(b)))


def _refs(rng, B, n):
    L = 4 * n + 1
    v = rng.integers(0, 256, (B, L)).astype(np.int32)
    avail = rng.random((B, L)) < 0.7
    avail[0] = False                      # nothing available
    avail[1] = True
    return v, avail


@pytest.mark.parametrize("n,luma", [(16, True), (8, False), (8, True)])
def test_intra_all_modes_and_one_mode(n, luma):
    rng = np.random.default_rng(n + luma)
    v_raw, avail = _refs(rng, 9, n)
    vj = j_intra.substitute_references(jnp.asarray(v_raw), jnp.asarray(avail),
                                       8, xp=jnp)
    vt = t_intra.substitute_references(torch.from_numpy(v_raw),
                                       torch.from_numpy(avail), 8)
    _eq(vj, vt)
    _eq(j_intra.filter_references(vj, n, 8, xp=jnp),
        t_intra.filter_references(vt))
    _eq(j_intra.predict_all_modes_matmul(vj, n, 8, luma=luma, xp=jnp),
        t_intra.predict_all_modes_matmul(vt, n, 8, luma=luma))
    modes = rng.integers(0, 35, (9,)).astype(np.int32)
    _eq(j_intra.predict_mode_matmul(vj, jnp.asarray(modes), n, 8, luma=luma,
                                    xp=jnp),
        t_intra.predict_mode_matmul(vt, torch.from_numpy(modes), n, 8,
                                    luma=luma))


@pytest.mark.parametrize("luma", [True, False])
def test_interp_qpel(luma):
    rng = np.random.default_rng(11)
    H, W = (48, 64) if luma else (24, 32)
    n = 16 if luma else 8
    ref = rng.integers(0, 256, (H, W)).astype(np.int32)
    B = 12
    px = (rng.integers(0, W // n, (B,)) * n).astype(np.int32)
    py = (rng.integers(0, H // n, (B,)) * n).astype(np.int32)
    mvx = rng.integers(-90, 90, (B,)).astype(np.int32)
    mvy = rng.integers(-90, 90, (B,)).astype(np.int32)
    jf = j_interp.mc_luma_qpel if luma else j_interp.mc_chroma_qpel
    tf = t_interp.mc_luma_qpel if luma else t_interp.mc_chroma_qpel
    _eq(jf(jnp.asarray(ref), jnp.asarray(px), jnp.asarray(py),
           jnp.asarray(mvx), jnp.asarray(mvy), n, 8, xp=jnp),
        tf(torch.from_numpy(ref), torch.from_numpy(px), torch.from_numpy(py),
           torch.from_numpy(mvx), torch.from_numpy(mvy), n, 8))


@pytest.mark.parametrize("luma,n", [(True, 8), (True, 16), (True, 32),
                                    (False, 4), (False, 8), (False, 16)])
def test_interp_ps_and_add_avg(luma, n):
    """The short-domain MC of both lists and their bi average, against the
    JAX functions run on numpy: every fraction pair (16 luma, 64 chroma)
    at the picture's corners and inside, with MVs reaching past the
    border."""
    rng = np.random.default_rng(n + 100 * luma)
    H, W = (64, 96) if luma else (32, 48)
    nf, unit = (4, 4) if luma else (8, 8)
    pos = [(0, 0), (0, W - n), (H - n, 0), (H - n, W - n), (n, 2 * n)]
    fx, fy = (a.reshape(-1) for a in np.meshgrid(range(nf), range(nf)))
    py, px = (np.repeat(np.array(c, np.int32), nf * nf) for c in zip(*pos))
    B = len(px)
    fx, fy = np.tile(fx, len(pos)), np.tile(fy, len(pos))
    refs = [rng.integers(0, 256, (H, W)).astype(np.int32) for _ in (0, 1)]

    def mv(frac):
        ip = rng.integers(-6, 7, B)
        far = rng.random(B) < 0.2           # past the picture's border
        ip = np.where(far, rng.choice([-1, 1], B) * (W + 8), ip)
        return (ip * unit + frac).astype(np.int32)

    mvs = [(mv(fx), mv(fy)), (mv(np.roll(fx, 3)), mv(np.roll(fy, 5)))]
    jf = j_interp.mc_luma_qpel_ps if luma else j_interp.mc_chroma_qpel_ps
    tf = t_interp.mc_luma_qpel_ps if luma else t_interp.mc_chroma_qpel_ps
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    jps = [jf(r, px, py, mx, my, n, 8, xp=np) for r, (mx, my) in
           zip(refs, mvs)]
    tps = [tf(t(r), t(px), t(py), t(mx), t(my), n, 8) for r, (mx, my) in
           zip(refs, mvs)]
    for a, b in zip(jps, tps):
        _eq(a, b)
    _eq(j_interp.add_avg(*jps, 8, xp=np), t_interp.add_avg(*tps, 8))
