"""WPP substreams on the uniform grid's P and B slices in the port against
the JAX package (CPU, exact), and the B side of bitstream/inter_syntax.py.

- merge_candidates_b and amvp_candidates_b at every CU of seeded B grids
  across POC layouts, and the bins of B coding units (encode_b_ctu), byte
  for byte and context for context with the JAX module's.
- The WPP writers (one substream per CTU row, the contexts carried from
  the row above) of P slices with one and two references, TMVP and SAO,
  and of B slices with SAO, against the JAX session's on the same
  decisions, with no JAX program compile.
- The WPP sessions of tests/p_options_pins.py (IPPP with SAO and the
  deblock, B frames, two references with TMVP, frame duplication, the
  golden clip, weighted P on a fade) held to the JAX package's pinned
  md5s and frame lists; libavcodec and libde265 decode the streams to the
  recon but the weighted one, whose WPP P slices signal no weight (the
  reference's fault, ROADMAP Queue 3).
- `-m slow` recomputes the pins from the JAX package; `-m gpu` codes the
  streams on the card."""
from unittest import mock

import numpy as np
import pytest
import torch

import p_options_pins as P
from x265_yuuki_asuna_tpu.bitstream import cabac as j_cabac
from x265_yuuki_asuna_tpu.bitstream import inter_syntax as j_is
from x265_yuuki_asuna_tpu.bitstream import native as j_native
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
from x265_yuuki_asuna_tpu.utils.de265_decode import decode_hevc_de265
from x265_yuuki_asuna_tpu_torch.bitstream import cabac as t_cabac
from x265_yuuki_asuna_tpu_torch.bitstream import inter_syntax as t_is
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the B side of inter_syntax.py
# ---------------------------------------------------------------------------

def _b_spec(rng, rows, cols):
    """A seeded B grid: each CU absent, intra, or inter with a direction
    and each used list's MV (often repeated, so pruning runs)."""
    mvs = [tuple(int(x) for x in rng.integers(-40, 41, 2)) for _ in range(4)]
    pick = lambda: mvs[rng.integers(0, 4)] if rng.random() < 0.5 else \
        tuple(int(x) for x in rng.integers(-300, 301, 2))
    spec = []
    for _ in range(rows * cols):
        k = rng.integers(0, 10)
        if k == 0:
            spec.append(None)
        elif k < 3:
            spec.append((True, None, int(rng.integers(0, 35)), False))
        else:
            d = int(rng.integers(1, 4))
            spec.append((False, (d, pick() if d & 1 else (0, 0),
                                 pick() if d & 2 else (0, 0)), 1,
                         bool(rng.integers(0, 2))))
    return spec


def _b_grid(mod, spec, rows, cols):
    cell = lambda s: None if s is None else mod.BCUState(
        s[0], None if s[1] is None else mod.BMotion(*s[1]), s[2], s[3])
    return [[cell(s) for s in spec[r * cols:(r + 1) * cols]]
            for r in range(rows)]


# (POC, L0 POC, L1 POC): a B between two anchors, a pyramid leaf, a RASL
# leading picture, both references on one side
POCS = [(2, 0, 4), (1, 0, 2), (3, 2, 4), (5, 4, 8), (3, 1, 2)]


@pytest.mark.parametrize("seed", range(4))
def test_b_candidate_lists_match_jax(seed):
    rng = np.random.default_rng(seed)
    rows, cols = 4, 5
    spec = _b_spec(rng, rows, cols)
    jg, tg = _b_grid(j_is, spec, rows, cols), _b_grid(t_is, spec, rows, cols)
    for r in range(rows):
        for c in range(cols):
            for mm in range(1, 6):
                assert [m.key() for m in t_is.merge_candidates_b(
                    tg, r, c, mm)] == [m.key() for m in
                                       j_is.merge_candidates_b(jg, r, c, mm)]
            for pocs in POCS:
                for lx in (0, 1):
                    assert t_is.amvp_candidates_b(tg, r, c, lx, *pocs) == \
                        j_is.amvp_candidates_b(jg, r, c, lx, *pocs)


def _levels(rng, n, density):
    return np.where(rng.random((n, n)) < density,
                    rng.integers(-4, 5, (n, n)), 0).astype(np.int32)


def _b_decision(mod, rng, n):
    kind = rng.integers(0, 3)
    lv = [_levels(rng, n, 0.1) if rng.random() < 0.6
          else np.zeros((n, n), np.int32),
          *(_levels(rng, n // 2, 0.1) if rng.random() < 0.4
            else np.zeros((n // 2, n // 2), np.int32) for _ in range(2))]
    if kind == 0:
        return mod.BCTUDecision(True, int(rng.integers(0, 35)),
                                luma_levels=lv[0], cb_levels=lv[1],
                                cr_levels=lv[2])
    d = int(rng.integers(1, 4))
    motion = mod.BMotion(d, *(tuple(int(x) for x in rng.integers(-300, 301,
                                                                 2))
                              for _ in range(2)))
    dec = mod.BCTUDecision(False, motion=motion, luma_levels=lv[0],
                           cb_levels=lv[1], cr_levels=lv[2])
    if kind == 1:
        dec.merge_idx = int(rng.integers(0, 5))
    else:
        dec.mvp_flag0, dec.mvp_flag1 = (int(x) for x in rng.integers(0, 2,
                                                                     2))
        dec.mvd0, dec.mvd1 = (tuple(int(x) for x in rng.integers(-600, 601,
                                                                 2))
                              for _ in range(2))
    return dec


@pytest.mark.parametrize("log2,sbh", [(4, False), (4, True), (5, False)])
def test_b_cu_bins_match_jax(log2, sbh):
    rng = np.random.default_rng(log2 + 7 * sbh)
    encs = (j_cabac.CabacEncoder(), t_cabac.CabacEncoder())
    for e in encs:
        e.init_contexts(0, 33)
    grids = ([[None] * 6 for _ in range(4)], [[None] * 6 for _ in range(4)])
    for r in range(4):
        for c in range(6):
            state = rng.bit_generator.state
            ds = []
            for mod in (j_is, t_is):
                rng.bit_generator.state = state
                ds.append(_b_decision(mod, rng, 1 << log2))
            delta = int(rng.integers(-8, 9)) if rng.random() < 0.3 else None
            for mod, e, g, d in zip((j_is, t_is), encs, grids, ds):
                mod.encode_b_ctu(e, d, g, r, c, log2, 5, sign_hiding=sbh,
                                 cu_qp_delta=delta)
    assert encs[0].finish() == encs[1].finish()
    assert bytes(encs[0].ctx) == bytes(encs[1].ctx)


# ---------------------------------------------------------------------------
# the WPP writers against the JAX session's, on the same decisions
# ---------------------------------------------------------------------------

UNI = dict(qp=32, cu_size=16, keyint=100, hash_sei=False, wpp=True)


@pytest.mark.parametrize("kw", [dict(sao=True, deblock=True),
                                dict(n_refs=2, tmvp=True, sao=True),
                                dict(max_merge=2)],
                         ids=["sao", "ref2_tmvp", "merge2"])
def test_wpp_p_writer_matches_jax(kw):
    """Three frames of a 96x64 clip (four CTU rows) through the port
    session; the last frame's decisions through both sessions' WPP P
    writers (the JAX one built, never run): the same slice NAL."""
    ts = t_top.VideoEncoderSession(96, 64, device="cpu", **UNI, **kw)
    js = j_top.VideoEncoderSession(96, 64, **UNI, **kw)
    calls = []
    with mock.patch.object(ts, "_assemble_p_slice",
                           wraps=ts._assemble_p_slice) as spy:
        for f in P.wpp_clip(3):
            calls.append(ts.col_field)
            ts.encode_frame(*f)
    out, qp, poc, ref_delta, weights, n_refs = spy.call_args.args
    js.col_field = ts.col_field = calls[-1]
    sao = None if "sao" not in out else j_native.unpack_sao(
        out["sao"], ts.rows, ts.cols)
    want = js._assemble_p_slice_wpp(out, qp, poc, ref_delta, sao,
                                    ([(1, 1), (2, 1)], [])
                                    if n_refs == 2 else None, n_refs)
    assert ts._assemble_p_slice(out, qp, poc, ref_delta, weights,
                                n_refs) == want


@pytest.mark.parametrize("kw", [dict(sao=True, deblock=True), {}],
                         ids=["sao", "plain"])
def test_wpp_b_writer_matches_jax(kw):
    """A B session (b-adapt 0, mini-GOPs of 3) over 5 frames of the 96x64
    clip; every B frame's decisions through both sessions' WPP B
    writers: the same slice NALs."""
    ts = t_top.VideoEncoderSession(96, 64, device="cpu", bframes=2,
                                   b_adapt=0, **UNI, **kw)
    js = j_top.VideoEncoderSession(96, 64, bframes=2, b_adapt=0, **UNI,
                                   **kw)
    with mock.patch.object(ts, "_assemble_b_slice",
                           wraps=ts._assemble_b_slice) as spy:
        for f in P.wpp_clip(5):
            ts.push_frame(*f)
        ts.flush()
    assert spy.call_count == 2
    for call in spy.call_args_list:
        out, qp, poc, poc0, poc1, is_ref, rps, nal_type = call.args
        sao = None if "sao" not in out else j_native.unpack_sao(
            out["sao"], ts.rows, ts.cols)
        assert ts._assemble_b_slice(*call.args) == js._assemble_b_slice_wpp(
            out, qp, poc, poc0, poc1, sao, is_ref, rps, nal_type)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

WPP_SESSIONS = [n for n, (_, _, kw) in P.SESSIONS.items() if kw.get("wpp")]


@pytest.mark.parametrize("name", WPP_SESSIONS)
def test_session_pin(name):
    assert P.run(t_top, name, device="cpu")[:2] == P.PINS[name]


def _decodes_to_recon(name):
    """Whether each decoder's pictures of the session `name` are its
    recon, frame by frame in display order."""
    _, _, res = P.run(t_top, name, device="cpu")
    clip, _, kw = P.SESSIONS[name]
    s = t_top.VideoEncoderSession(kw["width"], kw["height"], device="cpu",
                                  **{k: v for k, v in kw.items()
                                     if k not in ("width", "height")})
    stream = s.headers() + b"".join(r.nals for r in res)
    res = sorted(res, key=lambda r: r.poc) if kw.get("bframes") else res
    h, w = kw["height"], kw["width"]
    got = {}
    for dec, pics in (("libavcodec", decode_hevc(stream, w, h)),
                      ("libde265", decode_hevc_de265(stream))):
        got[dec] = [all(np.array_equal(np.asarray(d[k])[:h >> (k > 0),
                                                          :w >> (k > 0)],
                                       r.recon[k]) for k in range(3))
                    for d, r in zip(pics, res)] + [False] * (len(res)
                                                           - len(pics))
    return got


@pytest.mark.parametrize("name", ["wpp_ippp_lf", "wpp_b", "wpp_ref2_tmvp",
                                  "frame_dup_wpp"])
def test_wpp_streams_decode_to_the_recon(name):
    assert all(all(v) for v in _decodes_to_recon(name).values())


def test_reference_fault_wpp_weightp_signals_no_weight():
    """The reference's WPP P slice is written without the frame's weights
    (its pred_weight_table flags 0) while the PPS keeps weighted
    prediction and the recon is the weighted one (ROADMAP Queue 3): a
    decoder makes the IDR and then other pictures. The port keeps it byte
    for byte (the pin)."""
    got = _decodes_to_recon("wpp_weightp_fade")["libavcodec"]
    assert got[0] and not any(got[1:])


@pytest.mark.slow
@pytest.mark.parametrize("name", WPP_SESSIONS)
def test_session_pin_from_jax(name):
    assert P.run(j_top, name)[:2] == P.PINS[name]


@pytest.mark.gpu
def test_wpp_pins_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    for name in WPP_SESSIONS:
        assert P.run(t_top, name)[:2] == P.PINS[name], name
