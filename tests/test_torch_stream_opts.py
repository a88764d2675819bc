"""The all-intra stream options of the port against the JAX package (CPU,
exact): lossless, slices, WPP, scaling lists and the CRC / checksum hash
SEI.

- The Python CABAC writers (bitstream/cabac.py, residual.py,
  ctu_syntax.py) against the JAX package's on seeded bins, levels, modes,
  SAO parameters and QP deltas, byte for byte; scaling.py and the
  scaled quantizer (quant_matrix / dequant_matrix) against the JAX
  functions; the headers' scaling lists, transquant bypass, WPP entry
  points and slice addresses; crc16 and the hash SEI's three types at 8
  and 10 bits.
- The slice assemblers (WPP at one and two CTU columns, on the uniform
  grid and the quadtree, with SAO, QP maps and lossless; the sliced
  frame's bands) against the JAX session's on the same decisions, with
  no JAX program compile.
- Streams: the goldens intra_lossless, intra_wpp, intra_slices2 and
  intra_scaling_default; the intra sessions, command lines and library
  cases of tests/stream_opts_pins.py held to the JAX package's pinned
  md5s; the lossless recon equal to the source; libavcodec and libde265
  decoding the streams, and the reference's faults the port keeps
  (ROADMAP Queue 3); the session's option rules.
- `-m slow` recomputes every pin from the JAX package; `-m gpu` codes
  the streams on the card."""
import types

import numpy as np
import pytest
import torch

import golden_corpus
import grid_pins
import stream_opts_pins as S
from x265_yuuki_asuna_tpu.bitstream import cabac as j_cabac
from x265_yuuki_asuna_tpu.bitstream import ctu_syntax as j_cs
from x265_yuuki_asuna_tpu.bitstream import headers as j_hdr
from x265_yuuki_asuna_tpu.bitstream import native as j_native
from x265_yuuki_asuna_tpu.bitstream import residual as j_res
from x265_yuuki_asuna_tpu.bitstream import scaling as j_sc
from x265_yuuki_asuna_tpu.bitstream import tables as j_tab
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.ops import quant as j_quant
from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
from x265_yuuki_asuna_tpu.utils.de265_decode import decode_hevc_de265
from x265_yuuki_asuna_tpu_torch import api as t_api
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.bitstream import cabac as t_cabac
from x265_yuuki_asuna_tpu_torch.bitstream import ctu_syntax as t_cs
from x265_yuuki_asuna_tpu_torch.bitstream import headers as t_hdr
from x265_yuuki_asuna_tpu_torch.bitstream import native as t_native
from x265_yuuki_asuna_tpu_torch.bitstream import residual as t_res
from x265_yuuki_asuna_tpu_torch.bitstream import scaling as t_sc
from x265_yuuki_asuna_tpu_torch.bitstream import tables as t_tab
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.ops import quant as t_quant

torch.set_num_threads(2)
t = lambda a: torch.as_tensor(np.ascontiguousarray(a))


def _pair():
    j, p = j_cabac.CabacEncoder(), t_cabac.CabacEncoder()
    return j, p


# ---------------------------------------------------------------------------
# the Python CABAC writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slice_type", [0, 1, 2])
def test_context_init_matches_jax(slice_type):
    for qp in range(-2, 55):
        assert bytes(t_tab.init_all_contexts(slice_type, qp)) == \
            bytes(j_tab.init_all_contexts(slice_type, qp))


@pytest.mark.parametrize("seed", range(4))
def test_cabac_engine_matches_jax(seed):
    """A seeded mix of context, bypass, multi-bypass and terminating bins,
    with skewed bins so the states run to their ends and carries
    propagate: the same bytes and tail."""
    rng = np.random.default_rng(seed)
    encs = _pair()
    for e in encs:
        e.init_contexts(seed % 3, 20 + 5 * seed)
    p1 = rng.random(40) ** 3
    for _ in range(6000):
        kind = rng.integers(0, 10)
        if kind < 7:
            ctx = int(rng.integers(0, 40))
            b = int(rng.random() < p1[ctx])
            for e in encs:
                e.encode_bin(b, ctx)
        elif kind < 8:
            b = int(rng.integers(0, 2))
            for e in encs:
                e.encode_bin_ep(b)
        elif kind < 9:
            n = int(rng.integers(1, 17))
            v = int(rng.integers(0, 1 << n))
            for e in encs:
                e.encode_bins_ep(v, n)
        else:
            b = int(rng.random() < 0.05)
            for e in encs:
                e.encode_bin_trm(b)
    j, p = encs
    assert p.finish() == j.finish()
    assert bytes(p.ctx) == bytes(j.ctx)


def _levels(rng, n, density, big=False):
    lv = np.where(rng.random((n, n)) < density,
                  rng.integers(-3, 4, (n, n)), 0)
    if big:                    # a lossless-like block: wide residuals
        lv = lv * rng.integers(1, 90, (n, n))
    lv[0, 0] = rng.integers(1, 40)
    return lv.astype(np.int32)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_residual_coding_matches_jax(log2):
    rng = np.random.default_rng(log2)
    encs = _pair()
    for e in encs:
        e.init_contexts(2, 30)
    for k in range(24):
        lv = _levels(rng, 1 << log2, (0.05, 0.3, 0.8)[k % 3], k % 4 == 3)
        args = (lv, log2, bool(k % 2), int(rng.integers(0, 35)),
                bool(k % 5 == 1))
        j_res.encode_residual(encs[0], *args)
        t_res.encode_residual(encs[1], *args)
    assert encs[1].finish() == encs[0].finish()


@pytest.mark.parametrize("log2", [3, 4, 5])
def test_intra_cu_syntax_matches_jax(log2):
    """coding_unit() with the bypass flag, part_mode, MPMs from seeded
    neighbours, the cbfs, cu_qp_delta and the residuals."""
    rng = np.random.default_rng(10 + log2)
    encs = _pair()
    for e in encs:
        e.init_contexts(2, 27)
    n = 1 << log2
    for k in range(16):
        mode = int(rng.integers(0, 35))
        lv = [_levels(rng, s, 0.2) * (k % 3 != i) for i, s in
              enumerate((n, n // 2, n // 2))]
        kw = dict(part_mode_coded=bool(k % 2), sign_hiding=bool(k % 3 == 0),
                  tq_bypass=k % 4 == 1, bypass_enabled=k % 4 in (1, 2),
                  cu_qp_delta=int(rng.integers(-26, 26)) if k % 2 else None)
        left, above = (int(x) for x in rng.integers(0, 35, 2))
        j_cs.encode_intra_ctu_full(encs[0], j_cs.CTUDecisions(mode, *lv),
                                   log2, left, above, **kw)
        t_cs.encode_intra_ctu_full(encs[1], t_cs.CTUDecisions(mode, *lv),
                                   log2, left, above, **kw)
    assert encs[1].finish() == encs[0].finish()


@pytest.mark.parametrize("bd", [8, 10])
def test_sao_syntax_matches_jax(bd):
    """Seeded packed SAO rows ([luma, cb, cr] x [type, aux, o0..o3]),
    each CTU merging left or up where it repeats its neighbour: the port's
    packed form against the JAX writer's dicts (JAX native.unpack_sao)."""
    rng = np.random.default_rng(bd)
    rows, cols = 4, 5
    cmax = (1 << (min(bd, 10) - 5)) - 1
    sao = np.zeros((rows * cols, 18), np.int32)
    for i in range(rows * cols):
        if i and rng.random() < 0.3:               # repeat a neighbour
            sao[i] = sao[i - 1 if rng.random() < 0.5 or i < cols
                         else i - cols]
            continue
        luma, chroma = (int(x) for x in rng.integers(0, 3, 2))
        for k, typ in ((0, luma), (1, chroma), (2, chroma)):
            row = sao[i, 6 * k:6 * k + 6]
            row[0] = typ
            if typ == 1:                           # band offset
                row[1] = rng.integers(0, 32)
                row[2:] = rng.integers(-cmax, cmax + 1, 4)
            elif typ == 2:                         # edge offset
                row[1] = sao[i, 7] if k == 2 else rng.integers(0, 4)
                a = rng.integers(0, cmax + 1, 4)
                row[2:] = (a[0], a[1], -a[2], -a[3])
    dicts = j_native.unpack_sao(sao, rows, cols)
    encs = _pair()
    for e in encs:
        e.init_contexts(2, 32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            j_cs.encode_sao_ctu(encs[0], dicts[r][c],
                                dicts[r][c - 1] if c else None,
                                dicts[r - 1][c] if r else None, True, True,
                                bd)
            t_cs.encode_sao_ctu(encs[1], sao[i], sao[i - 1] if c else None,
                                sao[i - cols] if r else None, bd)
    assert encs[1].finish() == encs[0].finish()


def test_cu_qp_delta_syntax_matches_jax():
    encs = _pair()
    for e in encs:
        e.init_contexts(2, 30)
    for d in list(range(-26, 26)) + [-26, 25, 0, 5, -5, 6, -6]:
        j_cs.encode_cu_qp_delta(encs[0], d)
        t_cs.encode_cu_qp_delta(encs[1], d)
    assert encs[1].finish() == encs[0].finish()


# ---------------------------------------------------------------------------
# scaling lists and the scaled quantizer
# ---------------------------------------------------------------------------

@pytest.fixture
def lists_file(tmp_path):
    return S.write_scaling_file(str(tmp_path / "lists.txt"))


@pytest.mark.parametrize("which", ["default", "file"])
def test_scaling_lists_match_jax(which, lists_file):
    mk = (lambda m: m.ScalingListData.default()) if which == "default" \
        else (lambda m: m.ScalingListData.from_file(lists_file))
    j, p = mk(j_sc), mk(t_sc)
    for log2 in (2, 3, 4, 5):
        for lid in (range(6) if log2 < 5 else (0, 3)):
            assert np.array_equal(p.matrix(log2, lid), j.matrix(log2, lid))
            for a, b in zip(p.quant_tables(log2, lid),
                            j.quant_tables(log2, lid)):
                assert np.array_equal(a, b)
    bws = [m.BitWriter() for m in (j_hdr, t_hdr)]
    j_sc.write_scaling_list_data(bws[0], j)
    t_sc.write_scaling_list_data(bws[1], p)
    for bw in bws:
        bw.write_align_zero()
    assert bws[1].get_bytes() == bws[0].get_bytes()


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_scaled_quant_matches_jax(bd, log2, lists_file):
    """quant / dequant with a scaling list's matrices at one QP and at a
    QP per block (the quantizer's QpBdOffset added), and sign hiding on
    their levels."""
    rng = np.random.default_rng(bd * 10 + log2)
    n = 1 << log2
    sld = j_sc.ScalingListData.from_file(lists_file)
    qtab, dqtab = sld.quant_tables(log2, 0)
    coef = rng.integers(-3000, 3001, (12, n, n)).astype(np.int32)
    off = 6 * (bd - 8)
    for qp in (22, 37, rng.integers(0, 52, 12).astype(np.int32)):
        jq = qp + off if np.ndim(qp) == 0 else qp + off
        lv, du = j_quant.quant_matrix(coef, jq, log2, qtab, bd, True)
        tq = int(qp) + off if np.ndim(qp) == 0 else t(qp + off)
        plv, pdu = t_quant.quant(t(coef), tq, log2, bd, True, True,
                                 t(qtab[None]))
        assert np.array_equal(plv.numpy(), lv)
        assert np.array_equal(pdu.numpy(), du)
        shift = 20 - 14 - t_quant.transform_shift(log2, bd)
        assert np.array_equal(
            t_quant.dequant_matrix(t(lv), tq, shift, t(dqtab[None])).numpy(),
            j_quant.dequant_matrix(lv, jq, log2, dqtab, bd))
        q = t_quant.Quantizer(bit_depth=bd, scaling=t_sc.ScalingListData
                              .from_file(lists_file))
        pq = int(qp) if np.ndim(qp) == 0 else t(qp)
        assert np.array_equal(q(t(coef), pq, log2, True).numpy(), lv)


def test_chroma_batches_take_each_lists_matrix(lists_file):
    """A chroma batch is its Cb blocks, then its Cr blocks: each half at
    its own list's matrices (they differ in the file)."""
    sld = t_sc.ScalingListData.from_file(lists_file)
    q = t_quant.Quantizer(scaling=sld)
    rng = np.random.default_rng(3)
    coef = rng.integers(-2000, 2001, (8, 8, 8)).astype(np.int32)
    lv = q(t(coef), 30, 3, True, luma=False).numpy()
    for half, lid in ((slice(0, 4), 1), (slice(4, 8), 2)):
        want, _ = j_quant.quant_matrix(coef[half], 30, 3,
                                       sld.quant_tables(3, lid)[0], 8, True)
        assert np.array_equal(lv[half], want)


# ---------------------------------------------------------------------------
# headers, crc16 and the hash SEI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(lossless=True), dict(wpp=True), dict(scaling_lists="default"),
    dict(scaling_lists="file"), dict(slices=3, deblock=True)])
def test_parameter_sets_match_jax(kw, lists_file):
    kw = {k: (lists_file if v == "file" else v) for k, v in kw.items()}
    assert t_top.IntraEncoderSession(64, 48, device="cpu", **kw).headers() \
        == j_top.IntraEncoderSession(64, 48, **kw).headers()


@pytest.mark.parametrize("offsets", [[], [1], [5, 300, 2], [70000, 3]])
def test_slice_header_entry_points_and_address(offsets):
    jk = dict(entry_point_offsets=offsets)
    for addr, bits in ((0, 0), (8, 4), (13, 5)):
        sps, pps = j_hdr.SPSInfo(width=64, height=64), \
            j_hdr.PPSInfo(entropy_coding_sync=1)
        tsps, tpps = t_hdr.SPSInfo(width=64, height=64), \
            t_hdr.PPSInfo(entropy_coding_sync=1)
        jb = j_hdr.write_slice_header(sps, pps, 2, 30, first_slice=addr == 0,
                                      slice_addr=addr, slice_addr_bits=bits,
                                      **jk)
        tb = t_hdr.write_slice_header(tsps, tpps, 2, 30, slice_addr=addr,
                                      slice_addr_bits=bits, **jk)
        assert tb.get_bytes() == jb.get_bytes()


def test_crc16_matches_jax():
    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 4096):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert t_native.crc16(data) == j_native.crc16(data)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("hash_type", [0, 1, 2])
def test_hash_sei_types_match_jax(bd, hash_type):
    rng = np.random.default_rng(bd + hash_type)
    out = {k: rng.integers(0, 1 << bd, s).astype(np.int32)
           for k, s in (("recon_y", (48, 320)), ("recon_u", (24, 160)),
                        ("recon_v", (24, 160)))}
    ref = types.SimpleNamespace(hash_type=hash_type, bit_depth=bd)
    assert t_top.hash_sei(out, bd, hash_type) == \
        j_top.IntraEncoderSession._hash_sei(ref, out)


# ---------------------------------------------------------------------------
# the slice assemblers on the port's decisions
# ---------------------------------------------------------------------------

ASSEMBLERS = {
    # WPP at one and at two CTU16 columns, with sign hiding
    "wpp_one_column": (16, 48, dict(qp=32, wpp=True, sbh=True)),
    "wpp_two_columns": (32, 48, dict(qp=32, wpp=True)),
    # WPP with SAO after the deblock, at 10 bits (the offsets' range)
    "wpp_sao_10bit": (64, 48, dict(qp=32, wpp=True, sao=True, deblock=True,
                                   bit_depth=10)),
    # the uniform CTU32 grid's WPP and lossless WPP (no bypass flag)
    "wpp_ctu32": (64, 64, dict(qp=30, cu_size=32, wpp=True)),
    "wpp_lossless": (64, 48, dict(wpp=True, lossless=True)),
    # the quadtree's WPP: depth 2 with AQ's QP map (the predictor restarts
    # on every row) and SAO, depth 1
    "qt2_wpp_aq_sao": (96, 64, dict(qp=30, max_depth=2, wpp=True,
                                    aq_mode=2, sao=True)),
    "qt1_wpp": (96, 64, dict(qp=30, max_depth=1, wpp=True)),
}


def _frame(w, h, bd):
    y, u, v = golden_corpus.clip(w=w, h=h, n=1)[0]
    if bd > 8:
        return tuple(p.astype(np.uint16) * 4 for p in (y, u, v))
    return y, u, v


@pytest.mark.parametrize("name", sorted(ASSEMBLERS))
def test_wpp_assembler_matches_jax(name):
    """The port session's decisions of one frame through its WPP writer
    and the JAX session's (built, never run: no compile): the same slice
    NAL."""
    w, h, kw = ASSEMBLERS[name]
    ts = t_top.IntraEncoderSession(w, h, device="cpu", **kw)
    js = j_top.IntraEncoderSession(w, h, **kw)
    assert ts.wpp and js.wpp
    padded = ts._pad(*_frame(w, h, ts.bit_depth))
    out = ts.code(*padded, ts.qp, qp_map=ts.aq_map(*padded))
    sao = None
    if "sao" in out:
        sao = j_native.unpack_sao(out["sao"], ts.rows, ts.cols)
    assert ts.assemble_slice(out, ts.qp) == \
        js._assemble_slice(out, sao_params=sao)


def test_band_slices_match_jax():
    """Three bands of one CTU row each: every band's slice NAL (its
    segment address after the first) equals the JAX writer's."""
    ts = t_top.IntraEncoderSession(64, 48, qp=32, slices=3, device="cpu")
    js = j_top.IntraEncoderSession(64, 48, qp=32, slices=3)
    yp, up, vp = ts._pad(*_frame(64, 48, 8))
    bands = [(yp[16 * i:16 * (i + 1)], up[8 * i:8 * (i + 1)],
              vp[8 * i:8 * (i + 1)]) for i in range(3)]
    outs = ts.frame_encoder.encode_frames(*zip(*bands), 32)
    for i, out in enumerate(outs):
        assert ts._band_slice(out, 4 * i, 4) == \
            js._assemble_band_slice(out, i == 0, 4 * i, 4)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

GOLDENS = {"intra_lossless": dict(qp=4, lossless=True),
           "intra_wpp": dict(qp=32, wpp=True),
           "intra_slices2": dict(qp=32, slices=3),
           "intra_scaling_default": dict(qp=32, scaling_lists="default")}


def _golden(top, name, **kw):
    import hashlib
    s = top.IntraEncoderSession(64, 48, hash_sei=False, **GOLDENS[name],
                                **kw)
    out = s.headers() + b"".join(s.encode_frame(*f).nals
                                 for f in golden_corpus.clip())
    return hashlib.md5(out).hexdigest()


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden(name):
    assert _golden(t_top, name, device="cpu") == grid_pins.manifest(name)


INTRA_PINS = [n for n, (_, mode, _) in S.SESSIONS.items()
              if mode in ("intra", "batch")]


@pytest.mark.parametrize("name", INTRA_PINS)
def test_session_pin(name):
    assert S.run(t_top, name, device="cpu")[:2] == S.PINS[name]


@pytest.mark.parametrize("name", sorted(S.CLI))
def test_cli_pin(name, tmp_path):
    assert S.run_cli(t_cli.main, name, str(tmp_path), device="cpu") == \
        S.CLI_PINS[name]


@pytest.mark.parametrize("name", sorted(S.API))
def test_api_pin(name):
    assert S.run_api(t_api, name, device="cpu") == S.API_PINS[name]


def _decoded(stream, w, h, bd=8):
    """Both decoders' pictures of a stream."""
    return {"libavcodec": decode_hevc(stream, w, h, bit_depth=bd),
            "libde265": decode_hevc_de265(stream)}


def _code(w=64, h=48, n=2, **kw):
    s = t_top.IntraEncoderSession(w, h, device="cpu", **kw)
    frames = golden_corpus.clip(n=n)
    res = [s.encode_frame(*f) for f in frames]
    return s.headers() + b"".join(r.nals for r in res), res, frames


def _decodes_to_recon(stream, res, skip=()):
    got = {}
    for name, pics in _decoded(stream, 64, 48).items():
        if name in skip:
            continue
        got[name] = len(pics) == len(res) and all(
            np.array_equal(np.asarray(d[k])[:48 // (1 + (k > 0)),
                                             :64 // (1 + (k > 0))],
                           r.recon[k])
            for d, r in zip(pics, res) for k in range(3))
    return got


def test_lossless_recon_is_the_source_and_decodes():
    stream, res, frames = _code(lossless=True, qp=30)
    assert all(np.array_equal(r.recon[k], f[k]) for r, f in zip(res, frames)
               for k in range(3))
    assert all(r.qp == 4 for r in res)
    assert all(_decodes_to_recon(stream, res).values())


@pytest.mark.parametrize("kw", [dict(wpp=True), dict(wpp=True, sao=True,
                                                     deblock=True),
                                dict(slices=3), dict(wpp=True, cu_size=32)])
def test_streams_decode_to_the_recon(kw):
    stream, res, _ = _code(**kw)
    assert all(_decodes_to_recon(stream, res).values())


@pytest.mark.parametrize("kw", [dict(wpp=True, lossless=True),
                                dict(wpp=True, aq_mode=2),
                                dict(slices=3, deblock=True),
                                dict(slices=3, lossless=True)])
def test_reference_faults_the_port_keeps(kw):
    """The reference's faults (ROADMAP Queue 3), which the port keeps
    byte for byte: the uniform grid's WPP writer codes neither the
    transquant bypass flag nor a QP map's cu_qp_delta, and the sliced
    frame neither deblocks its bands nor codes the bypass flag, while
    the parameter sets announce them. No decoder makes the recon of such
    a stream."""
    stream, res, _ = _code(**kw)
    assert not any(_decodes_to_recon(stream, res, ("libavcodec",))
                   .values())


def test_library_streams_decode():
    """The library's all-intra WPP stream decodes (to a picture near the
    source); its lossless one, WPP too, keeps the missing bypass flag's
    fault: no decoder makes the source of it."""
    got = {}
    for name in ("intra16_wpp", "lossless"):
        p = t_api.param_default_preset("medium")
        for k, v in [("input-res", "64x48")] + list(S.API[name].items()):
            t_api.param_parse(p, k, v)
        enc = t_api.Encoder(p, device="cpu")
        stream = enc.headers()
        frames = golden_corpus.clip(n=2)
        for f in frames:
            pic = t_api.picture_init(p, t_api.picture_alloc())
            pic.planes = f
            stream += b"".join(enc.encode(pic))
        stream += b"".join(enc.encode(None))
        dec = decode_hevc_de265(stream)
        assert len(dec) == 2
        got[name] = [t_top.psnr(np.asarray(d[0])[:48, :64], f[0])
                     for d, f in zip(dec, frames)]
    assert min(got["intra16_wpp"]) > 25
    assert max(got["lossless"]) < 99


def test_option_rules():
    """The reference's rules: lossless signals QP 4 and codes no filter,
    AQ, sign hiding or RDOQ; slices fall back to 1 unless the rows split
    evenly, and switch sign hiding and WPP off; scaling lists are
    ignored under lossless, RDOQ and the quadtree."""
    mk = lambda **kw: t_top.IntraEncoderSession(64, 48, device="cpu", **kw)
    s = mk(qp=30, lossless=True, deblock=True, sao=True, aq_mode=2, sbh=True,
           rdoq=True, scaling_lists="default")
    assert (s.qp, s.deblock, s.sao, s.aq_mode, s.sbh, s.quant_fn.rdoq,
            s.scaling) == (4, False, False, 0, False, False, None)
    assert s.pps.transquant_bypass == 1
    assert mk(slices=2).slices == 1 and mk(slices=3).slices == 3
    s = mk(slices=3, sbh=True, wpp=True)
    assert not s.sbh and not s.wpp and s.pps.entropy_coding_sync == 0
    assert mk(rdoq=True, scaling_lists="default").scaling is None
    assert mk(max_depth=2, scaling_lists="default").scaling is None
    assert mk(max_depth=2, wpp=True).wpp
    for kw in (dict(lossless=True), dict(slices=3)):
        with pytest.raises(NotImplementedError):
            mk(max_depth=2, **kw)
    # the video session's wpp (the uniform grid only) reaches its intra
    # session
    assert t_top.VideoEncoderSession(64, 48, wpp=True,
                                     device="cpu").intra_sess.wpp
    assert not t_top.VideoEncoderSession(64, 48, wpp=True, max_depth=2,
                                         device="cpu").intra_sess.wpp
    # (the all-intra session's last options run now, with the reference's
    # rules: tests/test_torch_intra_opts.py::test_option_rules)
    assert (mk(nr_intra=100).nr_intra, mk(fast_intra=True).fast_intra,
            mk(csp="i444").sps.chroma_format_idc) == (100, True, 3)


def test_library_uniform_p_session_waits_for_multiref():
    """The library's uniform P-only session asks for two references and
    TMVP, as the reference's does: the port builds it since the P-frame
    options' slice (its stream is pinned in tests/p_options_pins.py)."""
    p = t_api.param_default_preset("medium")
    for k, v in (("input-res", "64x48"), ("bframes", "0"), ("ctu", "16"),
                 ("min-cu-size", "16"), ("weightp", "0")):
        t_api.param_parse(p, k, v)
    sess = t_api.Encoder(p, device="cpu")._sess
    assert (sess.n_refs, sess.tmvp, sess.sps.temporal_mvp) == (2, True, 1)


# ---------------------------------------------------------------------------
# slow twins: the pins from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", INTRA_PINS)
def test_session_pin_from_jax(name):
    assert S.run(j_top, name)[:2] == S.PINS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(S.CLI))
def test_cli_pin_from_jax(name, tmp_path):
    from x265_yuuki_asuna_tpu import cli as j_cli
    assert S.run_cli(j_cli.main, name, str(tmp_path)) == S.CLI_PINS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(S.API))
def test_api_pin_from_jax(name):
    from x265_yuuki_asuna_tpu import api as j_api
    assert S.run_api(j_api, name) == S.API_PINS[name]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


@pytest.mark.gpu
def test_goldens_and_pins_on_the_card(tmp_path):
    _need_card()
    for name in GOLDENS:
        assert _golden(t_top, name) == grid_pins.manifest(name), name
    for name in INTRA_PINS:
        assert S.run(t_top, name)[:2] == S.PINS[name], name
    for name in S.CLI:
        assert S.run_cli(t_cli.main, name, str(tmp_path)) == \
            S.CLI_PINS[name], name
    for name in S.API:
        assert S.run_api(t_api, name) == S.API_PINS[name], name
