"""The uniform CTU32 grid of the port against the JAX package (CPU,
exact): K1's fused sweep at n = 32 (its plain version against the JAX
package's numpy full search, its key layout), the grid's geometry, and
the uniform CTU32 video sessions (IPPP and B frames with the filters,
AQ, cuTree, weighted prediction, b-adapt 1 / 2, open GOP, CRF, 10 bits,
the CRC and checksum SEI) of tests/stream_opts_pins.py held to the JAX
package's pinned md5s with each frame's POC, type and QP. `-m slow`
recomputes the pins from the JAX package; `-m gpu` runs K1's n = 32
kernel at its three key widths and the sessions on the card."""
import numpy as np
import pytest
import torch

import stream_opts_pins as S
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.ops import me as j_me
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.ops import me as t_me
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)


def _planes(kind, H, W, peak=255, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "flat":                    # every displacement ties
        src = np.full((H, W), peak // 3, np.int32)
        return src.copy(), src
    src = rng.integers(0, peak + 1, (H, W)).astype(np.int32)
    ref = np.roll(src, (5, -7), (0, 1))
    ref[H // 4:H // 2, W // 4:W // 2] = rng.integers(0, peak + 1,
                                                     (H // 4, W // 4))
    return ref, src


CASES = [("textured", 64, 96, 16, 2), ("textured", 96, 64, 6, 0),
         ("flat", 64, 64, 16, 0), ("flat", 64, 64, 16, 2),
         ("textured", 32, 32, 16, 1)]      # range larger than the plane


@pytest.mark.parametrize("kind,H,W,R,lam", CASES)
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_fused_sweep_n32_matches_jax_full_search(kind, H, W, R, lam, bd):
    """K1's plain version at n = 32 and the single-size route (the
    uniform CTU32 grid's ME) against the JAX package's full_search_sad
    (its numpy form) on the grid's blocks: equal MVs and SADs."""
    peak = (1 << bd) - 1
    ref, src = _planes(kind, H, W, peak)
    n, rows, cols = 32, H // 32, W // 32
    blocks = src.reshape(rows, n, cols, n).transpose(0, 2, 1, 3) \
        .reshape(-1, n, n)
    px = (np.arange(rows * cols) % cols * n).astype(np.int32)
    py = (np.arange(rows * cols) // cols * n).astype(np.int32)
    want = j_me.full_search_sad(ref, blocks, px, py, n, R, lambda_bits=lam)
    dt = torch.uint8 if bd == 8 else torch.int16
    tr, ts = (torch.from_numpy(a).to(dt) for a in (ref, src))
    for got in (me_sad.sad_sweep_best_plain(tr, ts, R, n, lam),
                t_me.full_search_sad(tr, ts, n, R, lambda_bits=lam,
                                     peak=peak)):
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b.numpy())
    if kind == "flat" and lam == 0:
        assert (want[0] == -R).all() and (want[1] == -R).all()


def test_key_layout_at_n32():
    """The fused kernel's packed keys at n = 32, R = 16: 29 bits at 8 bits
    and 31 at 10 (int32), 33 at 12 bits (int64)."""
    lay = me_sad.key_layout
    for bd, bits, kdt in ((8, 29, torch.int32), (10, 31, torch.int32),
                          (12, 33, torch.int64)):
        dt = torch.uint8 if bd == 8 else torch.int16
        shift, got = lay(dt, 32, 16, 2, (1 << bd) - 1)
        cost = 32 * 32 * ((1 << bd) - 1) + 2 * 2 * 16
        assert (shift, got) == (11, kdt)
        assert cost.bit_length() + shift == bits


def test_fused_sizes_and_counts():
    assert me_sad.BEST_SIZES == (8, 16, 32)
    assert set(me_sad.sad_sweep_best.launches_by_size) == {8, 16, 32}
    with pytest.raises(ValueError):
        me_sad.sad_sweep_best(torch.zeros(64, 64, dtype=torch.uint8),
                              torch.zeros(64, 64, dtype=torch.uint8), 16, 64,
                              2)


def test_grid_takes_ctu32_and_refuses_ctu64():
    """The uniform grid takes CUs of 32 (and, since the 8x8 grid codes,
    8: tests/test_torch_cu8.py); a uniform CTU64 is refused."""
    s = t_top.VideoEncoderSession(64, 48, cu_size=32, device="cpu")
    assert (s.cu, s.rows, s.cols, s.inter_encoder.n) == (32, 2, 2, 32)
    assert s.sps.log2_min_cb == 5 and s.sps.log2_diff_max_min_cb == 0
    with pytest.raises(NotImplementedError, match="CTU64"):
        t_top.IntraEncoderSession(64, 48, cu_size=64, device="cpu")
    s = t_top.IntraEncoderSession(64, 48, cu_size=8, device="cpu")
    assert (s.cu, s.rows, s.cols) == (8, 6, 8)


def test_ctu32_parameter_sets_match_jax():
    for kw in (dict(cu_size=32, keyint=100, bframes=3, deblock=True,
                    sao=True),
               dict(cu_size=32, keyint=100, aq_mode=2, cutree=True,
                    weightp=True)):
        assert t_top.VideoEncoderSession(160, 96, device="cpu", **kw) \
            .headers() == j_top.VideoEncoderSession(160, 96, **kw).headers()


VIDEO_PINS = [n for n, (_, mode, _) in S.SESSIONS.items()
              if mode in ("ippp", "push")]


@pytest.mark.parametrize("name", VIDEO_PINS)
def test_session_pin(name):
    assert S.run(t_top, name, device="cpu")[:2] == S.PINS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", VIDEO_PINS)
def test_session_pin_from_jax(name):
    assert S.run(j_top, name)[:2] == S.PINS[name]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_k1_n32_matches_plain_on_the_card(bd):
    """The CUDA kernel at n = 32 with 32-bit keys (8 and 10 bits) and
    64-bit keys (12 bits) on 1088x1920 planes, and at lambda 0 on a flat
    plane (the first minimum (-R, -R)), equal to its plain version."""
    _need_card()
    peak = (1 << bd) - 1
    dt = torch.uint8 if bd == 8 else torch.int16
    for kind, H, W, lam in (("textured", 1088, 1920, 2),
                            ("flat", 64, 64, 0), ("textured", 64, 96, 1)):
        ref, src = (torch.from_numpy(a).to(dt) for a in _planes(
            kind, H, W, peak, seed=bd))
        got = me_sad.sad_sweep_best(ref.cuda(), src.cuda(), 16, 32, lam,
                                    peak)
        want = me_sad.sad_sweep_best_plain(ref, src, 16, 32, lam)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_ctu32_pins_on_the_card():
    _need_card()
    before = me_sad.sad_sweep_best.launches_by_size[32]
    for name in VIDEO_PINS:
        assert S.run(t_top, name)[:2] == S.PINS[name], name
    assert me_sad.sad_sweep_best.launches_by_size[32] > before
