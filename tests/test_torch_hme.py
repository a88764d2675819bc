"""HME in the port against the JAX package (CPU, exact).

K1's 4x4-base surface (its plain version here; the CUDA kernel is held
against it on the card by the gpu tests) against a numpy brute force, and
the port's sad_sweep_multi with the sizes (4, 8, 16) of HME's coarse
sweep against the JAX sad_sweep_multi on int32 planes (the XLA scan the
reference's coarse sweep runs), the port fed uint8 and int32 planes,
textured and flat (every cost ties). sad_at_mv at MVs past the search
range, where the border clamp decides.

The quadtree P and B decision dicts with hme=True at 160x96 on the 24
pixel/frame pan of tests/test_inter_quadtree.py (past the +-16 fine
search): the I frame, the P frame from its recon, a second P frame from
that one, and a B frame between the I frame and the second P frame, all
through the flagship session's programs (deblock, SAO, sign hiding, a
per-CTU QP map). The JAX programs take minutes to compile, so the tier-1
tests hold the port's dicts to digests of the JAX dicts pinned here; the
slow test recomputes them from the live JAX programs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flagship_pins import H, W, coarse_mvs_counted
from test_torch_qt_programs import _assert_same_dict, digest
from x265_yuuki_asuna_tpu.ops import me as j_me
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.ops import me as t_me
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
from x265_yuuki_asuna_tpu_torch.profile_1080p import FLAGSHIP

torch.set_num_threads(2)

# a per-CTU QP map of the 3 x 5 CTUs, and its slice QP
QMAP = np.array([[30, 33, 28, 31, 34], [29, 32, 35, 30, 27],
                 [31, 28, 33, 36, 30]], np.int32)
QMAP_SLICE = 31
# sha256 of the JAX package's decision dicts (digest()): the I frame, the
# P frame, the second P frame and the B frame
DIGEST = {"i":
            "ea7bfa1f9b9ae506ae9c7f977613f18bb7f8cf8199a5ec09030515ff00c368c2",
          "p":
            "a40a186b230322ab74852c620cf3d1561af744ef0ddf5f451ce8751b2b803021",
          "p2":
            "369610512b0df65a5956772b38ad9465d3f016e19e511164127c2012def4f6f0",
          "b":
            "9dd3bc452e9d83d84af810162349fc5c3cef9764b4ea153544a62d8485953f12"}


def _planes(kind, H, W, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "flat":
        src = np.full((H, W), 91, np.int32)
        return src.copy(), src
    src = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = np.roll(src, (3, -5), (0, 1))
    ref[H // 3:H // 2, W // 3:W // 2] = rng.integers(0, 256,
                                                     (H - H // 2 - H // 3,
                                                      W // 2 - W // 3))
    return ref, src


def _brute4(ref, src, R):
    """[D, D, H/4, W/4] 4x4-block SADs on the edge-extended reference."""
    H, W = src.shape
    D = 2 * R + 1
    pad = np.pad(ref.astype(np.int64), R, mode="edge")
    out = np.empty((D, D, H // 4, W // 4), np.int64)
    for dy in range(D):
        for dx in range(D):
            d = np.abs(pad[dy:dy + H, dx:dx + W] - src)
            out[dy, dx] = d.reshape(H // 4, 4, W // 4, 4).sum(axis=(1, 3))
    return out


@pytest.mark.parametrize("kind,H,W", [("textured", 24, 32),
                                      ("textured", 48, 80),
                                      ("flat", 24, 32)])
def test_block4_plain_surface_matches_brute_force(kind, H, W):
    ref, src = _planes(kind, H, W)
    got = me_sad.sad_block4_sweep(torch.from_numpy(ref).to(torch.uint8),
                                  torch.from_numpy(src).to(torch.uint8), 16)
    assert got.dtype == torch.int32 and got.shape == (33, 33, H // 4, W // 4)
    assert np.array_equal(got.numpy(), _brute4(ref, src, 16))
    assert me_sad.sad_block4_sweep.launches == 0      # CPU: no kernel


@pytest.mark.parametrize("kind,H,W,sizes", [
    ("textured", 48, 80, (4, 8, 16)), ("flat", 48, 80, (4, 8, 16)),
    ("textured", 24, 32, (4, 8)), ("flat", 24, 32, (4, 8))])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_coarse_sweep_matches_jax(kind, H, W, sizes, dtype):
    ref, src = _planes(kind, H, W)
    want = j_me.sad_sweep_multi(jnp.asarray(ref), jnp.asarray(src), sizes,
                                16, lambda_bits=2)
    got = t_me.sad_sweep_multi(torch.from_numpy(ref).to(dtype),
                               torch.from_numpy(src).to(dtype), sizes, 16,
                               lambda_bits=2)
    for n in sizes:
        for a, b in zip(want[n], got[n]):
            assert np.array_equal(np.asarray(a), b.numpy()), n
    if kind == "flat":                    # every SAD 0: the rate bias
        assert all(bool((got[n][0] == 0).all() & (got[n][1] == 0).all())
                   for n in sizes)


def test_sad_at_mv_past_the_range_matches_jax():
    ref, src = _planes("textured", 48, 80)
    rng = np.random.default_rng(3)
    px = np.repeat(np.arange(0, 80, 8), 6)[:48].astype(np.int32)
    py = np.tile(np.arange(0, 48, 8), 10)[:48].astype(np.int32)
    mvx = rng.integers(-90, 90, 48).astype(np.int32)
    mvy = rng.integers(-60, 60, 48).astype(np.int32)
    blocks = np.stack([src[y:y + 8, x:x + 8] for x, y in zip(px, py)])
    want = j_me.sad_at_mv(jnp.asarray(ref), jnp.asarray(blocks),
                          jnp.asarray(px), jnp.asarray(py), jnp.asarray(mvx),
                          jnp.asarray(mvy), 8, xp=jnp)
    t = torch.from_numpy
    got = t_me.sad_at_mv(t(ref), t(blocks), t(px), t(py), t(mvx), t(mvy), 8)
    assert np.array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# the quadtree programs with HME
# ---------------------------------------------------------------------------

def pan_frames():
    """tests/test_inter_quadtree.py's fast pan: noise moving 24 pixels a
    frame, flat chroma; three frames."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (120, 360)).astype(np.uint8)
    return [(base[8:8 + H, 24 * i:24 * i + W].copy(),
             np.full((H // 2, W // 2), 100, np.uint8),
             np.full((H // 2, W // 2), 140, np.uint8)) for i in range(3)]


def _recon(d):
    return d["recon_y"], d["recon_u"], d["recon_v"]


def code_frames(intra, inter, bi, recon):
    """{"i", "p", "p2", "b"} dicts of pan_frames through the programs
    intra(f, qp, slice_qp), inter(f, ref, qp, slice_qp) and bi(f, ref0,
    ref1, qp, slice_qp); recon(dict) is a dict's reference planes."""
    f0, f1, f2 = pan_frames()
    out = {"i": intra(f0, QMAP, QMAP_SLICE)}
    out["p"] = inter(f1, recon(out["i"]), QMAP, QMAP_SLICE)
    out["p2"] = inter(f2, recon(out["p"]), QMAP, QMAP_SLICE)
    out["b"] = bi(f1, recon(out["i"]), recon(out["p2"]), QMAP + 1,
                  QMAP_SLICE + 1)
    return out


@pytest.fixture(scope="module")
def port_dicts():
    s = t_top.VideoEncoderSession(W, H, device="cpu",
                                  **dict(FLAGSHIP, recon_out=True))
    ie, pe = s.intra_encoder, s.inter_encoder
    with coarse_mvs_counted() as count:
        dicts = code_frames(
            lambda f, q, sq: ie.encode_frame(*f, q, slice_qp=sq),
            lambda f, r, q, sq: pe.encode_frame(*f, *r, q, slice_qp=sq),
            lambda f, r0, r1, q, sq: pe.encode_frame(*f, *r0, q, ref1=r1,
                                                     slice_qp=sq),
            _recon)
    return dicts, count


@pytest.mark.parametrize("name", ["i", "p", "p2", "b"])
def test_hme_decisions_match_jax(port_dicts, name):
    d = port_dicts[0][name]
    assert digest(d) == DIGEST[name]


def test_hme_takes_coarse_mvs_past_the_fine_range(port_dicts):
    """Some blocks' winners are HME's coarse MVs, beyond +-16 pels (64
    quarter pels): the P frames' L0 and the B frame's both lists."""
    dicts, count = port_dicts
    assert int(count["taken"]) > 0
    big = lambda d, k: int(np.abs(d[k]).max()) > 64
    for name in ("p", "p2"):
        assert big(dicts[name], "mvx") or big(dicts[name], "mv4x")
    b = dicts["b"]
    assert any(big(b, k) for k in ("mvx", "mv4x", "mv8x"))
    assert any(big(b, k) for k in ("mv1x", "mv41x", "mv81x"))


def _jax_dict(out):
    """A JAX device-DPB decision dict with its recon on the host and its
    packed SAO parameters under "sao", as the port's."""
    out = dict(out)
    for k, p in zip(("recon_y", "recon_u", "recon_v"), out.pop("recon_dev")):
        out[k] = np.asarray(p).astype(np.int32)
    sao = out.pop("sao_dev")
    if sao is not None:
        out["sao"] = np.asarray(sao)
    return out


@pytest.mark.slow
def test_digests_recomputed_from_the_jax_programs(port_dicts):
    """Where DIGEST comes from: the JAX flagship session's programs,
    whose dicts the port's equal key by key."""
    from x265_yuuki_asuna_tpu.models import encoder_top as j_top
    s = j_top.VideoEncoderSession(W, H, **FLAGSHIP)
    ie, pe, be = s.intra_sess.frame_encoder, s.inter_encoder, s.bi_encoder
    flat = lambda q: q.reshape(-1)
    jd = code_frames(
        lambda f, q, sq: _jax_dict(ie.encode_frame(*f, qp=flat(q),
                                                   slice_qp=sq)),
        lambda f, r, q, sq: _jax_dict(pe.encode_frame(*f, *r, qp=flat(q),
                                                      slice_qp=sq)),
        lambda f, r0, r1, q, sq: _jax_dict(be.encode_frame(
            *f, *r0, qp=flat(q), ref1_y=r1[0], ref1_u=r1[1], ref1_v=r1[2],
            slice_qp=sq)),
        _recon)
    for name, d in jd.items():
        assert digest(d) == DIGEST[name], name
        _assert_same_dict(d, port_dicts[0][name])


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,H,W", [("textured", 24, 32),
                                      ("textured", 48, 80),
                                      ("flat", 48, 80)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
def test_block4_surface_kernel_on_the_card(kind, H, W, dtype):
    _need_card()
    ref, src = (torch.from_numpy(p).to(dtype).cuda()
                for p in _planes(kind, H, W))
    before = me_sad.sad_block4_sweep.launches
    got = me_sad.sad_block4_sweep(ref, src, 16)
    assert me_sad.sad_block4_sweep.launches == before + 1
    want = me_sad.sad_block4_sweep_plain(ref, src, 16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_hme_decisions_on_the_card():
    _need_card()
    s = t_top.VideoEncoderSession(W, H, **dict(FLAGSHIP, recon_out=True))
    ie, pe = s.intra_encoder, s.inter_encoder
    dicts = code_frames(
        lambda f, q, sq: ie.encode_frame(*f, q, slice_qp=sq),
        lambda f, r, q, sq: pe.encode_frame(*f, *r, q, slice_qp=sq),
        lambda f, r0, r1, q, sq: pe.encode_frame(*f, *r0, q, ref1=r1,
                                                 slice_qp=sq),
        _recon)
    for name, d in dicts.items():
        assert digest(d) == DIGEST[name], name
