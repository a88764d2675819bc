"""The ABR ladder and its scaler in the port against the JAX package
(CPU, exact): ops/scaler.py against the JAX numpy scaler (the path the
ladder calls) at 8 and 10 bits, models/ladder.py's rungs with and
without the analysis hand-off against the JAX LadderEncoder's streams,
and the command line's --ladder output files against the JAX CLI's
(tools_pins)."""
import os

import numpy as np
import pytest
import torch

import tools_pins as TP
from x265_yuuki_asuna_tpu import cli as j_cli
from x265_yuuki_asuna_tpu.models import ladder as j_ladder
from x265_yuuki_asuna_tpu.ops import scaler as j_scaler
from x265_yuuki_asuna_tpu.utils import io as j_io
from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.models import ladder as t_ladder
from x265_yuuki_asuna_tpu_torch.ops import scaler as t_scaler
from x265_yuuki_asuna_tpu_torch.utils import io as t_io

torch.set_num_threads(2)


def test_filter_bank_equals_jax():
    assert np.array_equal(t_scaler.BANK, j_scaler._BANK)
    assert (t_scaler.BANK.sum(1) == 1 << t_scaler.PREC).all()


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("src,dst", [
    ((48, 64), (36, 44)), ((96, 128), (48, 64)), ((240, 416), (120, 208)),
    ((48, 64), (96, 128)), ((37, 53), (101, 17)), ((64, 96), (64, 48)),
    ((1080, 1920), (540, 960))], ids=lambda s: "x".join(map(str, s)))
def test_resize_plane_matches_jax_numpy(bit_depth, src, dst):
    """Down, up, odd and one-axis sizes (positions in float64, the
    phase's rounding, the edge replication, the clip to the depth)."""
    rng = np.random.default_rng(sum(src) + bit_depth)
    p = rng.integers(0, 1 << bit_depth, src).astype(
        np.uint16 if bit_depth > 8 else np.uint8)
    want = j_scaler.resize_plane(p, *dst, bit_depth)
    got = t_scaler.resize_plane(p, *dst, bit_depth)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_resize_frame_matches_jax_numpy(bit_depth):
    """A 4:2:0 frame: chroma at half the luma geometry, the input's
    dtype out."""
    rng = np.random.default_rng(bit_depth)
    dt = np.uint16 if bit_depth > 8 else np.uint8
    pk = 1 << bit_depth
    y = rng.integers(0, pk, (96, 128)).astype(dt)
    u, v = (rng.integers(0, pk, (48, 64)).astype(dt) for _ in range(2))
    want = j_scaler.resize_frame(y, u, v, 80, 60, bit_depth)
    got = t_scaler.resize_frame(y, u, v, 80, 60, bit_depth)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[1].shape == (30, 40)


def test_parse_ladder():
    rungs = t_ladder.parse_ladder("1920x1080:6000, 960X540:2000,64x48")
    assert [(r.width, r.height, r.bitrate_kbps) for r in rungs] == \
        [(1920, 1080, 6000), (960, 540, 2000), (64, 48, 0)]
    assert rungs == [t_ladder.Rung(r.width, r.height, r.bitrate_kbps)
                     for r in j_ladder.parse_ladder(
                         "1920x1080:6000, 960X540:2000,64x48")]


def test_ladder_handoff_matches_jax():
    """The two rungs with the hand-off (the 64x48 rung codes first and its
    records, scaled by 2, are the 128x96 rung's hints): each rung's
    stream equals the JAX ladder's and the pins; every record reached the
    consumer's list, and both streams decode to their recon."""
    want, _ = TP.run_ladder(j_ladder, True)
    got, lad = TP.run_ladder(t_ladder, True, device="cpu")
    assert got == want == TP.LADDER_PINS[True]
    assert lad.donor == 1 and lad.consumer_sf == {0: 2}
    feed = lad.sessions[0].analysis_data
    assert feed is lad._feeds[0] and len(feed) == len(TP.ladder_clip())
    assert len(lad.sessions[1].shared_analysis) == len(feed)
    assert feed[1]["mvx"].shape == (lad.sessions[0].rows,
                                    lad.sessions[0].cols)


def test_ladder_without_handoff_matches_pins():
    """share_analysis=False: every rung searches on its own (the JAX
    ladder's streams, pinned); the smaller rung's stream is the same as
    with the hand-off, the larger one's differs."""
    got, lad = TP.run_ladder(t_ladder, False, device="cpu")
    assert got == TP.LADDER_PINS[False]
    assert lad.donor == -1 and not lad.consumer_sf
    assert got[1] == TP.LADDER_PINS[True][1]
    assert got[0] != TP.LADDER_PINS[True][0]


def test_ladder_rungs_decode():
    """tests/test_scaler_ladder.py's two rungs (64x48 and 32x32, not a 2x
    pair: no hand-off): three frames decode on each."""
    rungs = t_ladder.parse_ladder("64x48:300,32x32:100")
    rng = np.random.default_rng(1)
    lad = t_ladder.LadderEncoder(64, 48, rungs, qp=32, keyint=10,
                                 hash_sei=False, device="cpu")
    assert not lad.consumer_sf
    streams = lad.headers()
    for _ in range(3):
        y = rng.integers(0, 256, (48, 64)).astype(np.uint8)
        u = rng.integers(0, 256, (24, 32)).astype(np.uint8)
        v = rng.integers(0, 256, (24, 32)).astype(np.uint8)
        for k, fr in enumerate(lad.encode_frame(y, u, v)):
            streams[k] += fr.nals
    for k, s in enumerate(lad.sessions):
        assert len(decode_hevc(streams[k], s.coded_w, s.coded_h)) == 3
    assert lad.scale_ms > 0


def _write_clip(path, frames):
    w = t_io.Y4MWriter(path, t_io.VideoInfo(64, 48, 25, 1, 1, 8))
    for f in frames:
        w.write_frame(*f)
    w.close()


def test_cli_ladder_matches_pins(tmp_path):
    """--keyint 5 --ladder 64x48:300,32x24:100: one file per rung,
    {stem}_{W}x{H}.hevc, each the JAX CLI's."""
    src = TP.write_cli_inputs(str(tmp_path), _write_clip)
    got = TP.run_cli(t_cli.main, "ladder", str(tmp_path), src, device="cpu")
    assert got == TP.CLI_PINS["ladder"]


def test_cli_ladder_needs_keyint(tmp_path):
    """The reference's fault, kept: --ladder without --keyint compares
    None > 1 and fails with TypeError before it writes anything."""
    src = TP.write_cli_inputs(str(tmp_path), _write_clip)
    with pytest.raises(TypeError):
        t_cli.main([src, "-o", str(tmp_path / "l.hevc"), "--ladder",
                    "32x24:100"], device="cpu")
    assert not any(f.startswith("l_") for f in os.listdir(tmp_path))


@pytest.mark.slow
def test_pins_recomputed_from_jax(tmp_path):
    assert TP.run_ladder(j_ladder, False)[0] == TP.LADDER_PINS[False]

    def write(path, frames):
        w = j_io.Y4MWriter(path, j_io.VideoInfo(64, 48, 25, 1, 1, 8))
        for f in frames:
            w.write_frame(*f)
        w.close()
    src = TP.write_cli_inputs(str(tmp_path), write)
    assert TP.run_cli(j_cli.main, "ladder", str(tmp_path), src) == \
        TP.CLI_PINS["ladder"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_scaler_and_ladder_on_the_card(tmp_path):
    """The scaler on the card equals the JAX numpy scaler; the ladder's
    rungs and --ladder there code the pinned JAX streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    rng = np.random.default_rng(5)
    for bd in (8, 10):
        p = rng.integers(0, 1 << bd, (1080, 1920)).astype(np.uint16)
        got = t_scaler.resize_plane(p, 540, 960, bd, device="cuda")
        assert got.is_cuda and np.array_equal(
            got.cpu().numpy(), j_scaler.resize_plane(p, 540, 960, bd))
    for share in (True, False):
        assert TP.run_ladder(t_ladder, share)[0] == TP.LADDER_PINS[share]
    src = TP.write_cli_inputs(str(tmp_path), _write_clip)
    assert TP.run_cli(t_cli.main, "ladder", str(tmp_path), src) == \
        TP.CLI_PINS["ladder"]
