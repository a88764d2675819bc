"""The port's CABAC writers that no session of either package reaches:
the CTU64 P / B writer (`encode_slice_qt64`), the CTU32 depth-1 I and P
writers (`encode_intra_slice_qt`, `encode_p_slice_qt`), one TU's
residual (`encode_residual_test`) and the SAO packing helpers, each held
to the JAX package's wrapper on seeded decision arrays: the same
(payload, tail, tail_bits), exactly. The CTU64 writer's stream is also
decoded by libavcodec (as tests/test_native_qt64_inter.py does for the
JAX writer; skipped without cv2)."""
import numpy as np
import pytest

import native_writer_pins as NW
from x265_yuuki_asuna_tpu.bitstream import native as j_native
from x265_yuuki_asuna_tpu_torch.bitstream import native as t_native

QP = NW.QP
levels = NW.levels


@pytest.mark.parametrize("log2,is_luma,mode", [
    (2, True, 0), (2, True, 26), (2, False, 10), (3, True, 8),
    (3, True, -1), (3, False, 24), (4, True, 1), (4, False, -1),
    (5, True, 18), (5, True, -1)])
def test_residual_test_matches_jax(log2, is_luma, mode):
    """One TU (4x4 to 32x32, luma and chroma, intra scans and inter)."""
    rng = np.random.default_rng(100 * log2 + mode + 7 * is_luma)
    n = 1 << log2
    lv = levels(rng, (n, n), density=0.3, peak=40)
    lv[0, 0] = 3
    assert t_native.encode_residual_test(lv, log2, is_luma, mode, QP) == \
        j_native.encode_residual_test(lv, log2, is_luma, mode, QP)


def qt_inputs(seed: int, rows: int = 3, cols: int = 4):
    """A CTU32 depth-1 decision set: splits, modes, MVs, intra flags and
    levels ([ncu, 32*32] luma, [ncu, 16*16] chroma)."""
    rng = np.random.default_rng(seed)
    ncu = rows * cols
    return dict(
        split=(rng.random((rows, cols)) < 0.5).astype(np.uint8),
        use_intra32=(rng.random((rows, cols)) < 0.2).astype(np.uint8),
        modes32=rng.integers(0, 35, (rows, cols)).astype(np.int32),
        mv32x=rng.integers(-3, 4, (rows, cols)).astype(np.int32) * 4,
        mv32y=rng.integers(-2, 3, (rows, cols)).astype(np.int32) * 2,
        use_intra4=(rng.random((ncu, 4)) < 0.2).astype(np.uint8),
        modes4=rng.integers(0, 35, (ncu, 4)).astype(np.int32),
        mv4x=rng.integers(-3, 4, (ncu, 4)).astype(np.int32) * 4,
        mv4y=rng.integers(-2, 3, (ncu, 4)).astype(np.int32),
        levels_y=levels(rng, (ncu, 32 * 32)),
        levels_cb=levels(rng, (ncu, 16 * 16)),
        levels_cr=levels(rng, (ncu, 16 * 16)))


@pytest.mark.parametrize("sbh", [False, True])
def test_intra_slice_qt_matches_jax(sbh):
    d = qt_inputs(5 + sbh)
    args = (d["split"], d["modes32"], d["modes4"], d["levels_y"],
            d["levels_cb"], d["levels_cr"], QP)
    assert t_native.encode_intra_slice_qt(*args, sign_hiding=sbh) == \
        j_native.encode_intra_slice_qt(*args, sign_hiding=sbh)


@pytest.mark.parametrize("max_merge,sbh", [(1, False), (3, False),
                                           (5, True)])
def test_p_slice_qt_matches_jax(max_merge, sbh):
    d = qt_inputs(11 + max_merge)
    args = tuple(d[k] for k in (
        "split", "use_intra32", "modes32", "mv32x", "mv32y", "use_intra4",
        "modes4", "mv4x", "mv4y", "levels_y", "levels_cb", "levels_cr"))
    assert t_native.encode_p_slice_qt(*args, QP, max_merge, sbh) == \
        j_native.encode_p_slice_qt(*args, QP, max_merge, sbh)


@pytest.mark.parametrize("name", list(NW.QT64_CASES))
def test_slice_qt64_matches_jax(name):
    """The CTU64 P / B writer (tests/native_writer_pins.py's cases) equals
    the JAX package's, and the pin chip_smoke.py checks."""
    args, kw = NW.qt64_args(name)
    got = t_native.encode_slice_qt64(*args, **kw)
    assert got == j_native.encode_slice_qt64(*args, **kw)
    assert NW.digest(got) == NW.QT64_PINS[name]


@pytest.mark.parametrize("case", ["transposed", "other_grid"])
def test_misshapen_decisions_raise(case):
    """The writers take a decision array in the grid's shape or CTU-major
    ([ncu, ...]); a transposed array, or one laid out for a grid of other
    dimensions with as many elements, raises ValueError and codes
    nothing."""
    d = qt_inputs(17, rows=3, cols=4)
    if case == "transposed":
        d["modes32"] = np.ascontiguousarray(d["modes32"].T)
    else:
        d["modes4"] = d["modes4"].reshape(4, 3, 4)
    args = (d["split"], d["modes32"], d["modes4"], d["levels_y"],
            d["levels_cb"], d["levels_cr"], QP)
    key = "modes" if case == "transposed" else "modes4"
    with pytest.raises(ValueError, match=f"{key}: shape"):
        t_native.encode_intra_slice_qt(*args)
    out = {"split": d["split"], "modes": d["modes32"],
           "modes4": d["modes4"], "levels_y": d["levels_y"].reshape(
               3, 4, 32, 32), "levels_cb": d["levels_cb"].reshape(
               3, 4, 16, 16), "levels_cr": d["levels_cr"].reshape(
               3, 4, 16, 16)}
    with pytest.raises(ValueError, match=f"{key}: shape"):
        t_native.encode_slice_qt2(2, 1, out, QP)


def test_sao_packing_matches_jax():
    rng = np.random.default_rng(3)
    rows, cols = 2, 3
    params = [[{name: (int(rng.integers(0, 3)), int(rng.integers(0, 32)),
                       [int(x) for x in rng.integers(-7, 8, 4)])
                for name in ("luma", "cb", "cr")} for _ in range(cols)]
              for _ in range(rows)]
    packed = t_native.pack_sao(params, rows, cols)
    assert np.array_equal(packed, j_native.pack_sao(params, rows, cols))
    assert t_native.unpack_sao(packed, rows, cols) == \
        j_native.unpack_sao(packed, rows, cols) == params
    assert t_native.pack_sao(None, rows, cols) is None


# ---------------------------------------------------------------------------
# the CTU64 writer's stream through libavcodec
# ---------------------------------------------------------------------------

W = H = 128


@pytest.mark.parametrize("whole64", [False, True])
def test_qt64_inter_slice_decodes(whole64):
    """A CTU64 intra IDR from the port's session, then a B slice from the
    port's CTU64 writer at one quarter-pel MV everywhere: libavcodec
    decodes the motion-compensated reference (plus, for the one-CU64
    case, one TU32 and one chroma TU16 of residual)."""
    pytest.importorskip("cv2")
    from x265_yuuki_asuna_tpu.models.intra_encoder import \
        chroma_qp_from_luma
    from x265_yuuki_asuna_tpu.ops import interp, quant as Q, \
        transforms as TR
    from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
    from x265_yuuki_asuna_tpu_torch.bitstream import headers as HDR
    from x265_yuuki_asuna_tpu_torch.bitstream.bitio import (NAL_TRAIL_N,
                                                            wrap_nal)
    from x265_yuuki_asuna_tpu_torch.models.encoder_top import \
        IntraEncoderSession
    rng = np.random.default_rng(99)
    sess = IntraEncoderSession(W, H, qp=30, cu_size=64, max_depth=3,
                               hash_sei=False, device="cpu")
    sess.sps.max_dec_pic_buffering = 2
    frame = (rng.integers(0, 256, (H, W)).astype(np.uint8),
             rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
             rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8))
    idr = sess.encode_frame(*frame)
    ref3 = [np.asarray(p).astype(np.int32) for p in idr.recon]
    mvqx, mvqy = 6, -5
    out = {"split": np.zeros((H // 32, W // 32), np.uint8),
           "modes4": np.zeros((H // 32 * W // 32, 4), np.int32),
           "mvx": np.full((H // 32, W // 32), mvqx, np.int32),
           "mvy": np.full((H // 32, W // 32), mvqy, np.int32),
           "levels_y": np.zeros((H // 32, W // 32, 32, 32), np.int32),
           "levels_cb": np.zeros((H // 32, W // 32, 16, 16), np.int32),
           "levels_cr": np.zeros((H // 32, W // 32, 16, 16), np.int32)}
    n64 = (H // 64) * (W // 64)
    split64 = np.full(n64, 0 if whole64 else 1, np.uint8)
    mot64 = (np.ones(n64, np.int32), np.full(n64, mvqx, np.int32),
             np.full(n64, mvqy, np.int32), np.zeros(n64, np.int32),
             np.zeros(n64, np.int32))
    if whole64:
        out["levels_y"][0, 0, 0, 0] = 3        # CTU64 0's first TU32
        out["levels_cb"][1, 1, 0, 0] = -2      # its last chroma TU16
    data, tail, tail_bits = t_native.encode_slice_qt64(
        0, out, split64, mot64, H // 64, W // 64, 30, poc=1)
    bw = HDR.write_slice_header(sess.sps, sess.pps, slice_type=0,
                                slice_qp=30, nal_type=NAL_TRAIL_N, poc=1,
                                max_merge=3, ref_poc_delta=1,
                                pos_poc_delta=0)
    bw.write_bytes(data)
    bw.write_bits(tail, tail_bits)
    bw.rbsp_trailing_bits()
    stream = sess.headers() + idr.nals + wrap_nal(NAL_TRAIL_N,
                                                  bw.get_bytes())
    frames = decode_hevc(stream, W, H)
    assert len(frames) == 2

    nb = (H // 64) * (W // 64)
    px = (np.arange(nb) % (W // 64)) * 64
    py = (np.arange(nb) // (W // 64)) * 64
    mvx, mvy = np.full(nb, mvqx, np.int32), np.full(nb, mvqy, np.int32)

    def plane(blocks, n, h, w):
        return (blocks.reshape(h // n, w // n, n, n).transpose(0, 2, 1, 3)
                .reshape(h, w))
    exp = [plane(interp.mc_luma_qpel(ref3[0], px, py, mvx, mvy, 64, 8,
                                     xp=np), 64, H, W)]
    for p in (1, 2):
        exp.append(plane(interp.mc_chroma_qpel(
            ref3[p], px // 2, py // 2, mvx, mvy, 32, 8, xp=np),
            32, H // 2, W // 2))
    if whole64:
        ry = TR.inverse_transform(Q.dequant(out["levels_y"][0, 0][None], 30,
                                            5, 8, xp=np), 8, xp=np)[0]
        exp[0][:32, :32] = np.clip(exp[0][:32, :32] + ry, 0, 255)
        rc = TR.inverse_transform(Q.dequant(
            out["levels_cb"][1, 1][None], int(chroma_qp_from_luma(30)), 4,
            8, xp=np), 8, xp=np)[0]
        exp[1][16:32, 16:32] = np.clip(exp[1][16:32, 16:32] + rc, 0, 255)
    for p in range(3):
        assert np.array_equal(frames[1][p].astype(np.int32), exp[p])
