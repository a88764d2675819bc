"""The all-intra session complete: 4:4:4 input, noise reduction, fast
intra and the CTU64 quadtree, held against the JAX package.

Module parity (no JAX program): the denoise and the offset update, the
CTU64 boundary strengths, the 4:4:4 parameter sets and chroma QP table,
4:4:4 chroma prediction, the CTU64 slice writer on seeded decisions, and
the sessions' headers. Programs and streams: the port's decision dicts
are held to the sha256 of the JAX programs' (intra_opts_pins.DIGESTS),
its streams to the JAX sessions' and CLI's md5s (PINS, CLI_PINS), and
every pinned stream decodes to the port's recon through libavcodec. The
reference's faults are kept. `-m slow` recomputes the pins from the JAX
package (minutes: the CTU64 programs compile for 20 s to 2 min each);
`-m gpu` codes every pin on the card.
"""
import functools

import numpy as np
import pytest
import torch

import intra_opts_pins as P
from x265_yuuki_asuna_tpu.bitstream import headers as j_hdr
from x265_yuuki_asuna_tpu.bitstream import native as j_native
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.models import intra_encoder as j_ie
from x265_yuuki_asuna_tpu.ops import deblock as j_db
from x265_yuuki_asuna_tpu.ops import intra as j_intra
from x265_yuuki_asuna_tpu.ops import quant as j_quant
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.bitstream import headers as t_hdr
from x265_yuuki_asuna_tpu_torch.bitstream import native as t_native
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import intra_encoder as t_ie
from x265_yuuki_asuna_tpu_torch.ops import deblock as t_db
from x265_yuuki_asuna_tpu_torch.ops import intra as t_intra
from x265_yuuki_asuna_tpu_torch.ops import quant as t_quant

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def port_run(name: str):
    """The port's session `name` on the CPU (P.run), once per worker: the
    pin, decode and fault tests read the same run."""
    return P.run(t_top, name, device="cpu")


# ---------------------------------------------------------------------------
# module parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_denoise_dct_matches_jax(seed):
    rng = np.random.default_rng(seed)
    coef = rng.integers(-3000, 3000, (5, 16, 16)).astype(np.int32)
    off = rng.integers(0, 200, (16, 16)).astype(np.int32)
    want = j_quant.denoise_dct(coef, off)
    got = t_quant.denoise_dct(torch.as_tensor(coef), off)
    for a, b in zip(want, got):
        assert np.array_equal(a, b.numpy())


def test_denoise_refuses_offsets_of_another_size():
    """A 4:4:4 chroma block with the reference's 4:2:0-sized offsets
    fails as the reference's program does."""
    with pytest.raises(ValueError, match="broadcast"):
        t_quant.denoise_dct(torch.zeros(2, 16, 16, dtype=torch.int32),
                            np.zeros((8, 8), np.int32))


@pytest.mark.parametrize("count", [0, 10, 1 << 14, (1 << 14) + 1, 1 << 15])
def test_nr_update_offsets_matches_jax(count):
    """Including the halving past max_blocks and the zero DC."""
    rng = np.random.default_rng(count)
    rs = rng.integers(0, 1 << 22, 64).astype(np.int64)
    want = j_quant.nr_update_offsets(rs, count, 500, 1 << 14)
    got = t_quant.nr_update_offsets(rs, count, 500, 1 << 14)
    assert np.array_equal(want[0], got[0]) and got[0].dtype == np.int32
    assert np.array_equal(want[1], got[1]) and want[2] == got[2]
    assert got[0][0] == 0


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("seed", range(3))
def test_bs_qt64_matches_jax(depth, seed):
    rng = np.random.default_rng(seed)
    sp32 = rng.random((2, 3, 4)) < 0.6
    sp16 = rng.random((2, 3, 4, 4)) < 0.5
    for a, b in zip(j_db.compute_bs_qt64_intra(sp32, sp16, depth),
                    t_db.compute_bs_qt64_intra(sp32, sp16, depth)):
        assert np.array_equal(a, b) and b.dtype == np.int32


def test_chroma_qp_table_444():
    assert np.array_equal(t_ie.CHROMA_QP_TABLE_444, j_ie.CHROMA_QP_TABLE_444)
    assert [t_ie.chroma_qp(q, True) for q in range(-2, 60)] == \
        [int(j_ie.CHROMA_QP_TABLE_444[min(max(q, 0), 57)])
         for q in range(-2, 60)]


@pytest.mark.parametrize("bd", [8, 10])
def test_parameter_sets_444_match_jax(bd):
    """VPS / SPS at chroma_format_idc 3 (profile 4, chroma constraint 3,
    separate_colour_plane_flag, the window in 4:4:4 units) on a cropped
    frame."""
    out = []
    for hdr in (j_hdr, t_hdr):
        ptl = hdr.ProfileTierLevel(profile_idc=4, bit_depth_constraint=bd,
                                   level_idc=93)
        ptl.chroma_constraint = 3
        sps = hdr.SPSInfo(width=96, height=64, conf_win=(0, 6, 0, 9),
                          ptl=ptl, chroma_format_idc=3, bit_depth=bd,
                          log2_min_cb=4, log2_diff_max_min_cb=0,
                          log2_min_tb=2, log2_diff_max_min_tb=2,
                          strong_intra_smoothing=0, timing_info=(1, 25))
        out.append(hdr.write_vps(sps) + hdr.write_sps(sps))
    assert out[0] == out[1]


@pytest.mark.parametrize("kw", [
    dict(csp="i444"), dict(csp="i444", cu_size=32, bit_depth=10),
    dict(cu_size=64, max_depth=3), dict(cu_size=64, max_depth=2,
                                        aq_mode=2, deblock=True),
    dict(cu_size=64, max_depth=2, wpp=True, sao=True),
    dict(nr_intra=300, fast_intra=True)], ids=str)
def test_session_headers_match_jax(kw):
    """The sessions' VPS / SPS / PPS / SEI (no program runs: JAX compiles
    on the first frame)."""
    j = j_top.IntraEncoderSession(90, 70, qp=31, **kw)
    t = t_top.IntraEncoderSession(90, 70, qp=31, device="cpu", **kw)
    assert t.headers() == j.headers()
    assert (t.cu, t.rows, t.cols, t.sao, t.nr_intra, t.fast_intra) == (
        j.cu, j.rows, j.cols, j.sao, j.nr_intra,
        j.frame_encoder.cfg.fast_intra)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_chroma444_prediction_matches_jax(n):
    """4:4:4 chroma: luma's reference filtering, no DC / H / V edge
    filters (the JAX numpy form)."""
    rng = np.random.default_rng(n)
    v = rng.integers(0, 256, (6, 4 * n + 1)).astype(np.int32)
    modes = rng.integers(0, 35, 6)
    want = j_intra.predict_all_modes_matmul(v, n, luma=False,
                                            chroma444=True)
    got = t_intra.predict_all_modes_matmul(torch.as_tensor(v), n,
                                           luma=False, chroma444=True)
    assert np.array_equal(want, got.numpy())
    one = t_intra.predict_mode_matmul(torch.as_tensor(v),
                                      torch.as_tensor(modes), n, luma=False,
                                      chroma444=True)
    assert np.array_equal(want[np.arange(6), modes], one.numpy())


def _qt64_decisions(rng, rows, cols, depth):
    sp32 = rng.random((rows, cols, 4)) < 0.6
    sp16 = (rng.random((rows, cols, 4, 4)) < 0.5) & (depth == 3)
    lv = lambda n: np.where(rng.random((rows, cols, n, n)) < 0.15,
                            rng.integers(-40, 41, (rows, cols, n, n)), 0)
    return {"split32": sp32, "modes32": rng.integers(0, 35, (rows, cols, 4)),
            "split16": sp16,
            "modes16": rng.integers(0, 35, (rows, cols, 4, 4)),
            "modes8": rng.integers(0, 35, (rows, cols, 4, 4, 4)),
            "levels_y": lv(64), "levels_cb": lv(32), "levels_cr": lv(32)}


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("extras", ["plain", "sbh_qp_map", "sao10"])
def test_qt64_writer_matches_jax(depth, extras):
    rng = np.random.default_rng(depth * 7 + len(extras))
    rows, cols = 2, 3
    out = _qt64_decisions(rng, rows, cols, depth)
    kw = {}
    if extras == "sbh_qp_map":
        kw = dict(sign_hiding=True,
                  qp_map=rng.integers(24, 40, (rows, cols)).astype(np.int32))
    elif extras == "sao10":
        sao = np.zeros((rows * cols, 18), np.int32)
        sao[:, 0::6] = rng.integers(0, 3, (rows * cols, 3))
        sao[:, 1::6] = rng.integers(0, 4, (rows * cols, 3))
        for k in range(4):
            sao[:, 2 + k::6] = rng.integers(-7, 8, (rows * cols, 3))
        kw = dict(sao=sao, bit_depth=10)
    want = j_native.encode_intra_slice_qt64(out, rows, cols, 31, depth, **kw)
    assert want is not None
    assert t_native.encode_intra_slice_qt64(out, rows, cols, 31, depth,
                                            **kw) == want


# ---------------------------------------------------------------------------
# programs, sessions and command lines against the pinned JAX results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(P.PROGRAMS))
def test_program_digest(name):
    assert P.digest(P.run_program_port(name)) == P.DIGESTS[name]


@pytest.mark.parametrize("name", sorted(P.SESSIONS))
def test_session_pin(name):
    assert port_run(name)[:2] == P.PINS[name]


@pytest.mark.parametrize("name", sorted(P.CLI))
def test_cli_pin(name, tmp_path):
    assert P.run_cli(t_cli.main, name, str(tmp_path), device="cpu") == \
        P.CLI_PINS[name]


def _decodes_to(stream, res, w, h, i444=False, bd=8):
    from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
    dec = decode_hevc(stream, w, h, bit_depth=bd,
                      csp_shifts=(0, 0) if i444 else (1, 1))
    ch, cw = (h, w) if i444 else (h // 2, w // 2)
    return len(dec) == len(res) and all(
        np.array_equal(np.asarray(d[k])[:(h, ch, ch)[k], :(w, cw, cw)[k]],
                       r.recon[k]) for d, r in zip(dec, res)
        for k in range(3))


DECODED = [n for n in sorted(P.SESSIONS) if n != "ctu64_wpp"]


@pytest.mark.parametrize("name", DECODED)
def test_pinned_streams_decode_to_the_recon(name):
    pytest.importorskip("cv2")
    md5, _, stream, res = port_run(name)
    assert md5 == P.PINS[name][0]
    kw = P.SESSIONS[name][2]
    assert _decodes_to(stream, res, kw["width"], kw["height"],
                       kw.get("csp") == "i444", kw.get("bit_depth", 8))


def test_noise_reduction_saves_bits_after_the_first_frame():
    """tests/test_nr.py's claim on the port: the first frame codes as
    without NR (no sums yet), the later ones spend fewer bits."""
    b1 = [r.bits for r in port_run("nr_1000")[3]]
    b0 = [r.bits for r in port_run("nr_0")[3]]
    assert b1[0] == b0[0] and sum(b1[1:]) < sum(b0[1:])


def test_reference_faults_the_port_keeps():
    """4:4:4 with noise reduction fails at the first frame (the chroma
    offsets have the 4:2:0 size), and so does 4:4:4 with AQ (the energies
    of full-size chroma planes meet luma's at half their size); a batch
    codes zero offsets and adds nothing to the sums; CTU64 under wpp
    signals WPP but writes one substream, so a picture of two CTU rows
    decodes to another picture (ROADMAP Queue 3)."""
    y, u, v = P.i444_clip(32, 32)[0]
    for kw in (dict(nr_intra=500), dict(aq_mode=2)):
        for top, dev in ((j_top, {}), (t_top, {"device": "cpu"})):
            s = top.IntraEncoderSession(32, 32, qp=30, cu_size=16,
                                        csp="i444", **kw, **dev)
            with pytest.raises(ValueError):
                s.encode_frame(y, u, v)
    md5 = port_run("nr_batch")[0]
    s = t_top.IntraEncoderSession(64, 48, qp=30, device="cpu")
    plain = s.headers() + b"".join(r.nals
                                   for r in s.encode_batch(P.nr_clip(3)))
    import hashlib
    assert md5 == hashlib.md5(plain).hexdigest() == P.PINS["nr_batch"][0]
    md5, _, stream, res = port_run("ctu64_wpp")
    assert md5 == P.PINS["ctu64_wpp"][0]
    s = t_top.IntraEncoderSession(128, 128, cu_size=64, max_depth=2,
                                  wpp=True, device="cpu")
    assert s.wpp and s.pps.entropy_coding_sync == 1
    pytest.importorskip("cv2")
    assert not _decodes_to(stream, res, 128, 128)


def test_option_rules():
    """The reference's rules: NR zeroed under lossless, the quadtree,
    slices and WPP, and clipped to 2000; fast intra off on the quadtree
    and under lossless; 4:4:4 only on the lossy uniform grid without
    filters; CTU64 with max_depth 2 or 3, without SAO or the device DPB;
    the video session's quadtree stays CTU32."""
    mk = lambda **kw: t_top.IntraEncoderSession(64, 48, device="cpu", **kw)
    assert mk(nr_intra=5000).nr_intra == 2000
    for kw in (dict(lossless=True), dict(max_depth=2), dict(slices=3),
               dict(slices=2), dict(wpp=True)):
        assert mk(nr_intra=100, **kw).nr_intra == 0
    assert not mk(fast_intra=True, max_depth=2).fast_intra
    assert not mk(fast_intra=True, lossless=True).fast_intra
    for kw in (dict(lossless=True), dict(max_depth=2), dict(slices=3),
               dict(wpp=True), dict(sao=True), dict(deblock=True)):
        with pytest.raises(NotImplementedError, match="4:4:4"):
            mk(csp="i444", **kw)
    # the reference's program fails on 4:4:4 with scaling lists (its
    # chroma matrices one size too small); the port refuses the session
    with pytest.raises(ValueError, match="scaling"):
        mk(csp="i444", scaling_lists="default")
    s = mk(cu_size=64, max_depth=3, sao=True, dpb_device=True)
    assert (s.cu, s.sao, s.dpb_device, s.sps.sao_enabled) == \
        (64, False, False, 0)
    assert isinstance(s.frame_encoder, t_ie.IntraQT64Encoder)
    for d in (1,):
        with pytest.raises(ValueError, match="max_depth"):
            mk(cu_size=64, max_depth=d)
    with pytest.raises(NotImplementedError, match="cu_size=64"):
        mk(cu_size=64)
    v = t_top.VideoEncoderSession(64, 48, cu_size=64, max_depth=2,
                                  device="cpu")
    assert v.cu == 32
    with pytest.raises(NotImplementedError, match="max_depth"):
        t_top.VideoEncoderSession(64, 48, cu_size=64, max_depth=3,
                                  device="cpu")


# ---------------------------------------------------------------------------
# slow twins: the pins from the JAX package
# ---------------------------------------------------------------------------

def run_program_jax(name: str) -> dict:
    """The JAX program's decision dict of a program case (the uniform
    program's levels unpacked at full width)."""
    kind, (y, u, v), cfg, qp, nr_off = P.program_args(name)
    enc = j_ie.IntraFrameEncoder(j_ie.IntraFrameConfig(
        width=cfg["width"], height=cfg["height"],
        cu_size=64 if kind == "qt64" else cfg["cu_size"],
        csp=cfg.get("csp", "i420"), fast_intra=cfg.get("fast_intra", False),
        nr=cfg.get("nr", False), sbh=cfg.get("sbh", False),
        rdoq=cfg.get("rdoq", False), psy_rdoq=cfg.get("psy_rdoq", 0.0),
        psy_rd=cfg.get("psy_rd", 0.0), max_depth=cfg.get("max_depth", 0),
        bit_depth=cfg.get("bit_depth", 8)))
    q = np.asarray(qp, np.int32).reshape(-1) if np.ndim(qp) else qp
    kw = {} if nr_off is None else {"nr_off": nr_off}
    return enc.encode_frame(y, u, v, qp=q, **kw)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(P.PROGRAMS))
def test_program_digest_from_jax(name):
    assert P.digest(run_program_jax(name)) == P.DIGESTS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(P.SESSIONS))
def test_session_pin_from_jax(name):
    assert P.run(j_top, name)[:2] == P.PINS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(P.CLI))
def test_cli_pin_from_jax(name, tmp_path):
    from x265_yuuki_asuna_tpu import cli as j_cli
    assert P.run_cli(j_cli.main, name, str(tmp_path)) == P.CLI_PINS[name]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_pins_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in P.PROGRAMS:
        assert P.digest(P.run_program_port(name, "cuda")) == \
            P.DIGESTS[name], name
    for name in P.SESSIONS:
        assert P.run(t_top, name)[:2] == P.PINS[name], name
    for name in P.CLI:
        assert P.run_cli(t_cli.main, name, str(tmp_path)) == \
            P.CLI_PINS[name], name
