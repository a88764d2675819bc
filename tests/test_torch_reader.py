"""The port's bitstream reader (bitio.BitReader / split_annexb /
strip_emulation, cabac.CabacDecoder, the decode_* functions of
ctu_syntax, residual and inter_syntax) and its two test decoders
(utils/av_decode.py, utils/de265_decode.py): what the port's writers code
reads back, as tests/test_cabac.py holds the JAX package's; and the port's
streams parse to the same syntax elements through the port's reader as
through the JAX package's (the reader tests/tools/py_decoder.py drives),
CU for CU."""
import types

import numpy as np
import pytest

import golden_corpus
from x265_yuuki_asuna_tpu_torch.bitstream import bitio as t_bitio
from x265_yuuki_asuna_tpu_torch.bitstream import cabac as t_cabac
from x265_yuuki_asuna_tpu_torch.bitstream import ctu_syntax as t_cs
from x265_yuuki_asuna_tpu_torch.bitstream import inter_syntax as t_is
from x265_yuuki_asuna_tpu_torch.bitstream import residual as t_res
from x265_yuuki_asuna_tpu_torch.bitstream import tables as t_tables
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top

CTX = t_tables.CTX_OFFSET


def finish(enc) -> bytes:
    """A CABAC encoder's bytes after the terminating bin 1 (end of slice),
    with its tail and the RBSP trailing bits."""
    enc.encode_bin_trm(1)
    data, tail, tail_bits = enc.finish()
    bw = t_bitio.BitWriter()
    bw.write_bytes(data)
    bw.write_bits(tail, tail_bits)
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def coder(slice_type: int = 2, qp: int = 30):
    enc = t_cabac.CabacEncoder()
    enc.init_contexts(slice_type, qp)
    return enc


def reader(data: bytes, slice_type: int = 2, qp: int = 30):
    dec = t_cabac.CabacDecoder(data)
    dec.init_contexts(slice_type, qp)
    return dec


# ---------------------------------------------------------------------------
# round trips through the port's writer and reader
# ---------------------------------------------------------------------------

def test_bit_reader_expgolomb_and_emulation_round_trip():
    bw = t_bitio.BitWriter()
    vals, svals = [0, 1, 2, 3, 7, 100, 255, 1000], [0, 1, -1, 5, -7, 200]
    for v in vals:
        bw.write_ue(v)
    for v in svals:
        bw.write_se(v)
    bw.write_bits(5, 3)
    bw.rbsp_trailing_bits()
    br = t_bitio.BitReader(bw.get_bytes())
    assert [br.read_ue() for _ in vals] == vals
    assert [br.read_se() for _ in svals] == svals
    assert br.read_bits(3) == 5 and not br.more_rbsp_data()
    rbsp = bytes([0, 0, 1, 0, 0, 0, 0, 0, 3, 7, 0, 0, 2])
    assert t_bitio.strip_emulation(t_bitio.anti_emulation(rbsp)) == rbsp
    nals = [t_bitio.wrap_nal(t, bytes([t, 0, 0, 1, 5])) for t in (1, 32)]
    assert [n[2:] for n in t_bitio.split_annexb(b"".join(nals))] == \
        [t_bitio.anti_emulation(bytes([t, 0, 0, 1, 5])) for t in (1, 32)]


def test_cabac_bins_round_trip():
    rng = np.random.default_rng(1)
    ops = [(int(rng.integers(0, 3)), int(rng.integers(0, 2)),
            int(rng.integers(0, 40))) for _ in range(3000)]
    enc = coder(1, 27)
    for kind, b, ctx in ops:
        if kind == 0:
            enc.encode_bin(b, ctx)
        elif kind == 1:
            enc.encode_bin_ep(b)
        else:
            enc.encode_bins_ep(ctx, 6)
    dec = reader(finish(enc), 1, 27)
    for kind, b, ctx in ops:
        got = (dec.decode_bin(ctx) if kind == 0 else dec.decode_bin_ep()
               if kind == 1 else dec.decode_bins_ep(6))
        assert got == (ctx if kind == 2 else b)
    assert dec.decode_bin_trm() == 1


@pytest.mark.parametrize("log2,is_luma,mode,sbh", [
    (2, True, 0, False), (2, False, 26, True), (3, True, 10, True),
    (3, True, -1, False), (4, True, 18, True), (4, False, -1, False),
    (5, True, 1, True), (5, True, -1, True)])
def test_residual_round_trip(log2, is_luma, mode, sbh):
    """Several TUs in one slice (the contexts carry), dense and sparse,
    levels past the Rice escapes; with SBH each group's first sign is
    hidden in its parity, so the levels are made to agree with it."""
    rng = np.random.default_rng(10 * log2 + mode + sbh)
    n = 1 << log2
    tus = []
    for density, peak in ((0.9, 3), (0.2, 60), (0.05, 2000)):
        lv = np.where(rng.random((n, n)) < density,
                      rng.integers(-peak, peak + 1, (n, n)), 0)
        lv[0, 0] = lv[0, 0] or 1
        tus.append(_hide_parity(lv.astype(np.int32), log2, is_luma, mode)
                   if sbh else lv.astype(np.int32))
    enc = coder()
    for lv in tus:
        t_res.encode_residual(enc, lv, log2, is_luma, mode, sbh)
    dec = reader(finish(enc))
    for lv in tus:
        assert np.array_equal(t_res.decode_residual(dec, log2, is_luma,
                                                    mode, sbh), lv)


def _hide_parity(lv, log2, is_luma, mode):
    """lv with each group's first (lowest scan) nonzero level's sign set
    by its group's level-sum parity where SBH hides it."""
    scan_type = t_res.select_scan(log2, is_luma, mode)
    scan = t_tables.scan_order(scan_type, log2)
    flat = lv.reshape(-1).copy()
    for cg in range(len(scan) // 16):
        pos = [int(p) for p in scan[cg * 16:(cg + 1) * 16]]
        nz = [k for k, p in enumerate(pos) if flat[p]]
        if nz and nz[-1] - nz[0] >= t_res.SBH_THRESHOLD:
            p = pos[nz[0]]
            odd = int(np.abs(flat[[pos[k] for k in nz]]).sum()) & 1
            flat[p] = -abs(flat[p]) if odd else abs(flat[p])
    return flat.reshape(lv.shape)


def test_intra_cu_sao_and_qp_delta_round_trip():
    rng = np.random.default_rng(4)
    cus = []
    for i in range(12):
        d = t_cs.CTUDecisions(int(rng.integers(0, 35)),
                              _sparse(rng, 8), _sparse(rng, 4),
                              _sparse(rng, 4))
        cus.append((d, int(rng.integers(0, 35)), int(rng.integers(0, 35)),
                    int(rng.integers(-30, 31))))
    sao = [[int(rng.integers(0, 3)), int(rng.integers(0, 4))]
           + [int(x) for x in rng.integers(0, 8, 4)] for _ in range(3)]
    for p in sao:                        # edge offsets: signs inferred
        if p[0] == 2:
            p[2:6] = [abs(p[2]), abs(p[3]), -abs(p[4]), -abs(p[5])]
        elif p[0] == 1:
            p[1] = int(rng.integers(0, 32))
            p[2:6] = [int(x) for x in rng.integers(-7, 8, 4)]
    row = [v for p in sao for v in p]
    row[6] = row[12]                     # chroma shares its type
    row[13] = row[7] if row[6] == 2 else row[13]
    if row[6] == 0:
        row[6:] = [0] * 12
    enc = coder()
    t_cs.encode_sao_ctu(enc, row, None, None)
    t_cs.encode_sao_ctu(enc, row, row, None)
    for d, cl, ca, dqp in cus:
        t_cs.encode_intra_ctu_full(enc, d, 3, cl, ca, cu_qp_delta=dqp)
        t_cs.encode_cu_qp_delta(enc, dqp)
    dec = reader(finish(enc))
    assert t_cs.decode_sao_ctu(dec, None, None) == row
    assert t_cs.decode_sao_ctu(dec, row, None) == row
    for d, cl, ca, dqp in cus:
        got = t_cs.decode_intra_ctu_full(dec, 3, cl, ca,
                                         qp_delta_enabled=True)
        assert got[:2] == (d.luma_mode, d.luma_mode)
        for a, b in zip(got[2:], (d.luma_levels, d.cb_levels, d.cr_levels)):
            assert np.array_equal(a, b)
        assert t_cs.decode_cu_qp_delta(dec) == dqp


def _sparse(rng, n):
    lv = np.where(rng.random((n, n)) < 0.3, rng.integers(-9, 10, (n, n)), 0)
    return lv.astype(np.int32)


def test_inter_elements_round_trip():
    rng = np.random.default_rng(8)
    mvds = [tuple(int(x) for x in rng.integers(-300, 301, 2))
            for _ in range(40)] + [(0, 0), (1, -1), (0, 2)]
    enc = coder(1, 32)
    for m in mvds:
        t_is.encode_mvd(enc, *m)
    for idx, mc in ((0, 1), (0, 3), (2, 3), (4, 5), (3, 5)):
        t_is.encode_merge_idx(enc, idx, mc)
    for ref, nr in ((0, 1), (1, 2), (0, 2), (2, 4), (3, 4)):
        t_is.encode_ref_idx(enc, ref, nr)
    dec = reader(finish(enc), 1, 32)
    assert [t_is.decode_mvd(dec) for _ in mvds] == mvds
    assert [t_is.decode_merge_idx(dec, mc) for mc in (1, 3, 3, 5, 5)] == \
        [0, 0, 2, 4, 3]
    assert [t_is.decode_ref_idx(dec, nr) for nr in (1, 2, 2, 4, 4)] == \
        [0, 1, 0, 2, 3]


# ---------------------------------------------------------------------------
# the port's streams through both readers
# ---------------------------------------------------------------------------

def _modules(pkg: str):
    """The reader's modules of the package named pkg."""
    import importlib
    m = lambda name: importlib.import_module(f"{pkg}.bitstream.{name}")
    return types.SimpleNamespace(bitio=m("bitio"), cabac=m("cabac"),
                                 cs=m("ctu_syntax"), inter=m("inter_syntax"))


def parse_stream(M, stream: bytes, rows: int, cols: int, cu: int,
                 log2_max_poc: int, sign_hiding: bool = False,
                 max_merge: int = 3):
    """The syntax elements of a uniform-grid stream without SAO, TMVP or
    weights (one slice a picture, one reference a list), read through the
    modules M: per slice (type, QP, [per CU: its decisions and levels as
    bytes])."""
    log2cu = cu.bit_length() - 1
    out = []
    for nal in M.bitio.split_annexb(stream):
        ntype = (nal[0] >> 1) & 0x3F
        if ntype >= 32:
            continue
        rbsp = M.bitio.strip_emulation(nal[2:])
        br = M.bitio.BitReader(rbsp)
        br.read_flag()                                 # first slice
        if 16 <= ntype <= 23:
            br.read_flag()                             # no_output_of_prior
        br.read_ue()                                   # PPS id
        stype = br.read_ue()
        poc = poc0 = poc1 = 0
        if ntype not in (19, 20):
            poc = br.read_bits(log2_max_poc)
            br.read_flag()                             # RPS in the slice
            nneg, npos = br.read_ue(), br.read_ue()
            used = [[], []]
            for lst, cnt in ((0, nneg), (1, npos)):
                d = 0
                for _ in range(cnt):
                    d += br.read_ue() + 1
                    if br.read_flag():
                        used[lst].append(d)
            poc0 = poc - used[0][0]
            poc1 = poc + used[1][0] if used[1] else poc0
        if stype != 2:
            assert br.read_flag() == 0                 # no ref override
            if stype == 0:
                br.read_flag()                         # mvd_l1_zero
            br.read_ue()                               # merge candidates
        qp = 26 + br.read_se()
        assert br.read_flag() == 1
        while br.pos % 8:
            assert br.read_flag() == 0
        dec = M.cabac.CabacDecoder(rbsp, start_bitpos=br.pos)
        dec.init_contexts(stype, qp)
        grid = [[None] * cols for _ in range(rows)]
        modes = [[1] * cols for _ in range(rows)]
        cus = []
        for r in range(rows):
            for c in range(cols):
                if stype == 2:
                    got = M.cs.decode_intra_ctu_full(
                        dec, log2cu, modes[r][c - 1] if c else 1, 1,
                        sign_hiding=sign_hiding)
                    modes[r][c] = got[0]
                    info, lv = got[:2], got[2:]
                elif stype == 1:
                    cu_, *lv = M.inter.decode_inter_ctu(
                        dec, grid, r, c, log2cu, max_merge, sign_hiding)
                    info = (cu_.is_intra, cu_.mv, cu_.intra_mode, cu_.skip)
                else:
                    cu_, *lv = M.inter.decode_b_ctu(
                        dec, grid, r, c, log2cu, max_merge, poc, poc0, poc1,
                        sign_hiding)
                    m = cu_.motion
                    info = (cu_.is_intra, cu_.intra_mode, cu_.skip,
                            None if m is None else (m.dir, m.mv0, m.mv1))
                cus.append((info, tuple(np.asarray(a, np.int32).tobytes()
                                        for a in lv)))
                assert dec.decode_bin_trm() == int(
                    (r, c) == (rows - 1, cols - 1))
        out.append((stype, qp, cus))
    return out


STREAMS = {
    # the uniform 8x8 grid, IPPP; the uniform 16x16 grid with SBH; a
    # uniform B session
    "cu8_ippp": dict(cu_size=8, n=4),
    "cu16_sbh": dict(cu_size=16, n=3, sbh=True),
    "cu8_b": dict(cu_size=8, n=5, bframes=2, b_adapt=0),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_port_streams_parse_alike_in_both_readers(name):
    kw = dict(STREAMS[name])
    n, cu = kw.pop("n"), kw["cu_size"]
    s = t_top.VideoEncoderSession(64, 48, qp=30, keyint=100, hash_sei=False,
                                  device="cpu", **kw)
    res = []
    for f in golden_corpus.clip(n=n):
        res += s.push_frame(*f) if kw.get("bframes") else \
            [s.encode_frame(*f)]
    if kw.get("bframes"):
        res += s.flush()
    stream = s.headers() + b"".join(r.nals for r in res)
    args = (stream, 48 // cu, 64 // cu, cu, s.sps.log2_max_poc_lsb,
            kw.get("sbh", False))
    port = parse_stream(_modules("x265_yuuki_asuna_tpu_torch"), *args)
    assert port == parse_stream(_modules("x265_yuuki_asuna_tpu"), *args)
    assert [t for t, _, _ in port] == [{"I": 2, "P": 1}.get(
        r.frame_type, 0) for r in res]
    assert any(info[0] is False for _, _, cus in port[1:]
               for info, _ in cus)             # inter CUs were read


def test_test_decoders_decode_a_port_stream():
    """The port's av_decode and de265_decode decode the port's 16x16 IPPP
    stream to its recon (each skipped where its library is missing)."""
    from x265_yuuki_asuna_tpu_torch.utils import av_decode, de265_decode
    s = t_top.VideoEncoderSession(64, 48, qp=30, keyint=100, device="cpu")
    res = [s.encode_frame(*f) for f in golden_corpus.clip(n=3)]
    stream = s.headers() + b"".join(r.nals for r in res)
    decoded = []
    if av_decode.available():
        decoded.append(av_decode.decode_hevc(stream, 64, 48))
    if de265_decode.available():
        decoded.append(de265_decode.decode_hevc_de265(stream))
    if not decoded:
        pytest.skip("neither cv2 nor libde265 is installed")
    for frames in decoded:
        assert len(frames) == len(res)
        for f, r in zip(frames, res):
            for p in range(3):
                assert np.array_equal(np.asarray(f[p]), r.recon[p])
