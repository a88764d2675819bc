"""The video session's P-frame options in the port against the JAX package
(CPU, exact): two L0 references, TMVP, max_merge and frame duplication.

- The golden ippp_multiref_tmvp against the manifest.
- The two-reference P program: its per-CU cost, SATD + lambda * (MV
  bits + 1), against XLA's compile of the reference's expression bit for
  bit at every QP on seeded SATDs and MVs and at the MV range's edges;
  its decision dict at 128x96 (one QP and a per-CU map) held to digests
  of the JAX program's (the slow test recomputes them and compares key
  by key); with one picture as both references it equals the
  one-reference program but for "ref".
- bitstream/inter_syntax.py against the JAX module on seeded grids: the
  merge and AMVP lists with one and two references, TMVP and POC
  scaling, and the bins of P coding units, byte for byte and context for
  context.
- The P writers (the native one; the Python one with two references,
  TMVP and a QP map) against the JAX session's on the same decisions,
  with no JAX program compile.
- The sessions, command lines and library cases of
  tests/p_options_pins.py that are not WPP's held to the JAX package's
  pinned md5s and frame lists (tests/test_torch_wpp_inter.py holds the
  rest); a port session resumed before frame 3 from the JAX golden
  session's state (pinned in tests/golden/ippp_multiref_tmvp_state_f3.npz)
  continues the golden stream.
- The option rules against the JAX session's (kept, dropped, asserted)
  and the reference's faults the port keeps (ROADMAP Queue 3): the DPB
  of two pictures under two references, the silent drops, the quadtree
  session's duplicate frame, no entry point passing wpp to the video
  session.
- `-m slow` recomputes every pin from the JAX package; `-m gpu` codes the
  streams on the card and runs the two-reference program through K1."""
import hashlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

import golden_corpus
import grid_pins as GP
import jax
import jax.numpy as jnp
import p_options_pins as P
import test_torch_qt_programs as QP
from test_torch_wpp_inter import _decodes_to_recon
from x265_yuuki_asuna_tpu.bitstream import cabac as j_cabac
from x265_yuuki_asuna_tpu.bitstream import inter_syntax as j_is
from x265_yuuki_asuna_tpu.bitstream.bitio import (BitReader, split_annexb,
                                                  strip_emulation)
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu_torch import api as t_api
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.bitstream import cabac as t_cabac
from x265_yuuki_asuna_tpu_torch.bitstream import inter_syntax as t_is
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import inter_encoder as t_inter
from x265_yuuki_asuna_tpu_torch.models.state import (load_session_state,
                                                     rc_state)
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad
from x265_yuuki_asuna_tpu_torch.utils import io as IO

torch.set_num_threads(2)
t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
W, H = QP.W, QP.H
GOLDEN = dict(qp=32, cu_size=16, keyint=100, n_refs=2, tmvp=True,
              hash_sei=False)
STATE = os.path.join(os.path.dirname(__file__), "golden",
                     "ippp_multiref_tmvp_state_f3.npz")


def _golden_stream(**kw):
    s = t_top.VideoEncoderSession(64, 48, **GOLDEN, **kw)
    res = [s.encode_frame(*f) for f in golden_corpus.clip()]
    return s.headers(), [r.nals for r in res]


@pytest.fixture(scope="module")
def golden():
    return _golden_stream(device="cpu")


def test_golden_multiref_tmvp_matches_the_manifest(golden):
    hdr, nals = golden
    assert hashlib.md5(hdr + b"".join(nals)).hexdigest() == \
        GP.manifest("ippp_multiref_tmvp")


# ---------------------------------------------------------------------------
# the two-reference P program
# ---------------------------------------------------------------------------

K = 4 * (64 + 3)        # |mv| in quarter-pels: search range 64 + 3


@jax.jit
def _xla_costs(s0, s1, m0x, m0y, m1x, m1y, qp):
    """motion_phase_2ref's costs as the reference writes them."""
    lam = 0.9 * jnp.exp2((qp.astype(jnp.float32) - 12.0) / 6.0)

    def mvbits(mx, my):
        return (4.0 + 2.0 * jnp.log2(1.0 + jnp.abs(mx).astype(jnp.float32))
                + 2.0 * jnp.log2(1.0 + jnp.abs(my).astype(jnp.float32)))
    return jnp.stack([s0 + lam * (mvbits(m0x, m0y) + 1.0),
                      s1 + lam * (mvbits(m1x, m1y) + 1.0)], 1)


def test_ref2_costs_match_xla():
    """Every cost bit for bit at QP 0-51 on seeded SATDs and MVs, and on
    the MV range's edges (0, +-1, +-K) with the SATD's (0, 2^16)."""
    rng = np.random.default_rng(31)
    n = 20000
    edge = np.array([0, 1, -1, 2, K, -K, K - 1], np.int32)
    ex, ey = (a.reshape(-1) for a in np.meshgrid(edge, edge))
    sats = [np.concatenate([rng.integers(0, 30000, n),
                            np.resize([0, 65535], ex.size)]).astype(np.int32)
            for _ in range(2)]
    mvs = [np.concatenate([rng.integers(-K, K + 1, n), e]).astype(np.int32)
           for e in (ex, ey, ey, ex)]
    for qp in range(52):
        want = np.asarray(_xla_costs(*sats, *mvs, jnp.int32(qp)))
        got = t_inter.ref2_costs([t(s) for s in sats],
                                 (t(mvs[0]), t(mvs[1])),
                                 (t(mvs[2]), t(mvs[3])), qp).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), qp


QMAP = np.random.default_rng(12).integers(28, 38, (6, 8)).astype(np.int32)
# sha256 (QP.digest) of the JAX package's two-reference P dicts of
# _ref2_inputs() at qp 33 and at QMAP
DIGEST = {"ref2":
            "897498b996c19782e77b9a3152969869db1ab62e519ea050113c95f1be150a4e",
          "ref2_aq":
            "08af8516029a6f96ee8cebaa023f65afe32b55ed5201fc4066b7988b258e1e08"}


def _ref2_inputs():
    """QP._frames()' second frame as L0 index 0 and its first as index 1;
    the source is the first frame's top half over the second's bottom
    half (so both references win CUs), with a flat block and a noise
    patch (intra CUs)."""
    f0, f1 = QP._frames()
    y = np.concatenate([f0[0][:H // 2], f1[0][H // 2:]])
    y[16:48, 32:64] = 128
    y[56:88, 96:128] = np.random.default_rng(4).integers(0, 256, (32, 32))
    return (y, f1[1], f1[2]), f1, f0


def port_ref2_dicts():
    src, r0, r1 = _ref2_inputs()
    enc = t_inter.InterFrameEncoder(W, H, 16, "cpu")
    return {"ref2": enc.encode_frame(*src, *r0, 33, ref2=r1),
            "ref2_aq": enc.encode_frame(*src, *r0, QMAP, ref2=r1)}


@pytest.fixture(scope="module")
def port_dicts():
    return port_ref2_dicts()


@pytest.mark.parametrize("name", sorted(DIGEST))
def test_ref2_decisions_match_jax(port_dicts, name):
    d = port_dicts[name]
    assert QP.digest(d) == DIGEST[name]
    assert set(np.unique(d["ref"])) == {0, 1}
    assert d["use_intra"].any() and not d["use_intra"].all()


def test_one_picture_as_both_references_is_the_one_reference_program():
    """The first P frame after an IDR: its one reference searched twice
    gives the one-reference program's dict with every CU on index 0 (the
    session then zeroes "ref", as the reference does)."""
    src, r0, _ = _ref2_inputs()
    enc = t_inter.InterFrameEncoder(W, H, 16, "cpu")
    two, one = enc.encode_frame(*src, *r0, 33, ref2=r0), \
        enc.encode_frame(*src, *r0, 33)
    assert not two.pop("ref").any() and one.pop("ref") is None
    assert all(np.array_equal(v, one[k]) if v is not None else one[k] is None
               for k, v in two.items())


@pytest.mark.slow
def test_ref2_digests_recomputed_from_the_jax_program(port_dicts):
    from x265_yuuki_asuna_tpu.models.inter_encoder import (
        InterFrameConfig, InterFrameEncoder)
    src, r0, r1 = _ref2_inputs()
    enc = InterFrameEncoder(InterFrameConfig(width=W, height=H, cu_size=16,
                                             qp=33, n_refs=2))
    for name, q in (("ref2", 33), ("ref2_aq", QMAP.reshape(-1))):
        jd = enc.encode_frame(*src, *r0, qp=q, ref1_y=r1[0], ref1_u=r1[1],
                              ref1_v=r1[2])
        assert QP.digest(jd) == DIGEST[name], name
        for k, v in jd.items():
            if v is None:
                assert port_dicts[name][k] is None, k
            else:
                assert np.array_equal(v, port_dicts[name][k]), k


# ---------------------------------------------------------------------------
# bitstream/inter_syntax.py against the JAX module
# ---------------------------------------------------------------------------

def _grid_spec(rng, rows, cols, n_refs):
    """A seeded P grid: each CU absent (not yet coded), intra, or inter
    with a quarter-pel MV (often repeated, so pruning runs), a reference
    index and a skip flag."""
    mvs = [tuple(int(x) for x in rng.integers(-40, 41, 2)) for _ in range(4)]
    spec = []
    for _ in range(rows * cols):
        k = rng.integers(0, 10)
        if k == 0:
            spec.append(None)
        elif k < 3:
            spec.append((True, (0, 0), int(rng.integers(0, 35)), False, 0))
        else:
            mv = mvs[rng.integers(0, 4)] if rng.random() < 0.5 else \
                tuple(int(x) for x in rng.integers(-300, 301, 2))
            spec.append((False, mv, 1, bool(rng.integers(0, 2)),
                         int(rng.integers(0, n_refs))))
    return spec


def _grid(mod, spec, rows, cols):
    return [[None if s is None else mod.CUInfo(*s)
             for s in spec[r * cols:(r + 1) * cols]] for r in range(rows)]


def _col(rng, rows, cols):
    return {"intra": rng.random((rows, cols)) < 0.25,
            "mvx": rng.integers(-200, 201, (rows, cols)).astype(np.int32),
            "mvy": rng.integers(-200, 201, (rows, cols)).astype(np.int32),
            "ref": rng.integers(0, 2, (rows, cols)).astype(np.int32),
            "ref_deltas": [1, 2] if rng.random() < 0.5 else [1, 3]}


@pytest.mark.parametrize("seed", range(6))
def test_p_candidate_lists_match_jax(seed):
    """merge_candidates_ref and amvp_candidates at every CU of seeded
    grids, with one and two references, with and without a collocated
    field, at max_merge 1-5: the same lists."""
    rng = np.random.default_rng(seed)
    rows, cols = 4, 5
    for n_refs in (1, 2):
        spec = _grid_spec(rng, rows, cols, n_refs)
        jg, tg = _grid(j_is, spec, rows, cols), _grid(t_is, spec, rows, cols)
        deltas = list(range(1, n_refs + 1))
        for col in (None, _col(rng, rows, cols)):
            for r in range(rows):
                for c in range(cols):
                    for mm in range(1, 6):
                        assert t_is.merge_candidates_ref(
                            tg, r, c, mm, n_refs, col, deltas) == \
                            j_is.merge_candidates_ref(jg, r, c, mm, n_refs,
                                                      col, deltas)
                    for ref in range(n_refs):
                        assert t_is.amvp_candidates(tg, r, c, ref, deltas,
                                                    col) == \
                            j_is.amvp_candidates(jg, r, c, ref, deltas, col)


def test_scale_mv_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(3000):
        mv = tuple(int(x) for x in rng.integers(-40000, 40001, 2))
        tb, td = (int(x) for x in rng.choice([-16, -3, -2, -1, 1, 2, 3, 7,
                                              16], 2))
        assert t_is._scale_mv(mv, tb, td) == j_is._scale_mv(mv, tb, td)


def _levels(rng, n, density):
    lv = np.where(rng.random((n, n)) < density,
                  rng.integers(-4, 5, (n, n)), 0).astype(np.int32)
    if rng.random() < 0.2:
        lv[0, 0] = rng.integers(-300, 301)
    return lv


def _p_decision(mod, rng, n, n_refs):
    """A seeded P decision: intra, merge (skip without residual) or AMVP
    with a residual in each component at random."""
    kind = rng.integers(0, 3)
    lv = [_levels(rng, n, 0.1) if rng.random() < 0.6
          else np.zeros((n, n), np.int32),
          *(_levels(rng, n // 2, 0.1) if rng.random() < 0.4
            else np.zeros((n // 2, n // 2), np.int32) for _ in range(2))]
    if kind == 0:
        return mod.InterCTUDecision(True, int(rng.integers(0, 35)),
                                    luma_levels=lv[0], cb_levels=lv[1],
                                    cr_levels=lv[2])
    mv = tuple(int(x) for x in rng.integers(-300, 301, 2))
    d = mod.InterCTUDecision(False, mv=mv, ref=int(rng.integers(0, n_refs)),
                             luma_levels=lv[0], cb_levels=lv[1],
                             cr_levels=lv[2])
    if kind == 1:
        d.merge_idx = int(rng.integers(0, 5))
    else:
        d.mvp_flag = int(rng.integers(0, 2))
        d.mvd = tuple(int(x) for x in rng.integers(-600, 601, 2))
    return d


@pytest.mark.parametrize("log2,n_refs,sbh", [(4, 1, False), (4, 2, True),
                                             (5, 2, False), (5, 1, True)])
def test_p_cu_bins_match_jax(log2, n_refs, sbh):
    """encode_inter_ctu over a 4 x 6 grid of seeded decisions (skip,
    merge with residual, AMVP with ref_idx, intra; QP deltas on some), at
    max_merge 5: the same bytes, tail and contexts."""
    rng = np.random.default_rng(log2 * 10 + n_refs)
    encs = (j_cabac.CabacEncoder(), t_cabac.CabacEncoder())
    for e in encs:
        e.init_contexts(1, 30)
    grids = ([[None] * 6 for _ in range(4)], [[None] * 6 for _ in range(4)])
    for r in range(4):
        for c in range(6):
            state = rng.bit_generator.state
            ds = []
            for mod in (j_is, t_is):
                rng.bit_generator.state = state
                ds.append(_p_decision(mod, rng, 1 << log2, n_refs))
            delta = int(rng.integers(-8, 9)) if rng.random() < 0.3 else None
            for mod, e, g, d in zip((j_is, t_is), encs, grids, ds):
                mod.encode_inter_ctu(e, d, g, r, c, log2, 5,
                                     sign_hiding=sbh, cu_qp_delta=delta,
                                     n_refs=n_refs)
            assert grids[0][r][c] == grids[1][r][c] or \
                vars(grids[0][r][c]) == vars(grids[1][r][c])
    assert encs[0].finish() == encs[1].finish()
    assert bytes(encs[0].ctx) == bytes(encs[1].ctx)


# ---------------------------------------------------------------------------
# the P writers against the JAX session's, on the same decisions
# ---------------------------------------------------------------------------

WRITERS = {
    # the Python writer: two references with TMVP; TMVP alone under a QP
    # map; two references with SAO; the native writer at max_merge 2
    "ref2_tmvp": dict(n_refs=2, tmvp=True),
    "tmvp_qpmap": dict(tmvp=True, aq_mode=2),
    "ref2_sao": dict(n_refs=2, sao=True, deblock=True),
    "native_merge2": dict(max_merge=2, sao=True),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_p_writers_match_jax(name):
    """Three frames of the golden clip through the port session; its last
    frame's decisions (two references active) through both sessions' P
    writers (the JAX one built, never run), with the motion field of the
    frame before under TMVP: the same slice NAL."""
    from x265_yuuki_asuna_tpu.bitstream import native as j_native
    kw = dict(qp=32, cu_size=16, keyint=100, hash_sei=False, **WRITERS[name])
    ts = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    js = j_top.VideoEncoderSession(64, 48, **kw)
    outs = []
    with mock.patch.object(ts, "_assemble_p_slice",
                           wraps=ts._assemble_p_slice) as spy:
        for f in golden_corpus.clip(n=3):
            col = ts.col_field
            ts.encode_frame(*f)
            outs.append((col, spy.call_args))
    col, call = outs[-1]
    out, qp, poc, ref_delta, weights, n_refs = call.args
    assert n_refs == ts.n_refs
    js.col_field, js.poc = col, poc
    sao = None if "sao" not in out else j_native.unpack_sao(
        out["sao"], ts.rows, ts.cols)
    want = js._assemble_p_slice(out, qp, poc, ref_delta, sao_params=sao,
                                qp_map=out.get("qp_map"), n_refs=n_refs,
                                rps=([(1, 1), (2, 1)], [])
                                if n_refs == 2 else None)
    ts.col_field = col
    assert ts._assemble_p_slice(out, qp, poc, ref_delta, None,
                                n_refs) == want


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

P_SESSIONS = [n for n, (_, _, kw) in P.SESSIONS.items()
              if not kw.get("wpp")]


@pytest.mark.parametrize("name", P_SESSIONS)
def test_session_pin(name):
    assert P.run(t_top, name, device="cpu")[:2] == P.PINS[name]


def _same_cli(got, name) -> bool:
    pin = P.CLI_PINS[name]
    return got[:2] == pin[:2] and \
        P.csv_view(name, got[2]) == P.csv_view(name, pin[2])


@pytest.mark.parametrize("name", sorted(P.CLI))
def test_cli_pin(name, tmp_path):
    assert _same_cli(P.run_cli(t_cli.main, name, str(tmp_path),
                               device="cpu"), name)


@pytest.mark.parametrize("name", sorted(P.API))
def test_api_pin(name):
    assert P.run_api(t_api, name, device="cpu") == P.API_PINS[name]


@pytest.mark.parametrize("name", ["ref2_flicker", "tmvp2_pan", "merge1",
                                  "frame_dup"])
def test_streams_decode_to_the_recon(name):
    """libavcodec and libde265 make each frame's recon (two references with
    their ref_idx, TMVP's temporal candidates, one merge candidate, the
    all-skip duplicates)."""
    assert all(all(v) for v in _decodes_to_recon(name).values())


def test_frame_dup_codes_skip_slices():
    """frames 1, 2 and 4 of the repeated clip are duplicates: all-skip
    slices a tenth of the IDR's size or less, their recon the
    reference's."""
    _, _, res = P.run(t_top, "frame_dup", device="cpu")
    bits = [r.bits for r in res]
    assert all(bits[i] < bits[0] // 10 for i in (1, 2, 4)) and \
        bits[3] > bits[1]
    for i in (1, 2, 4):
        assert all(np.array_equal(a, b) for a, b in zip(res[i].recon,
                                                        res[i - 1].recon))


# ---------------------------------------------------------------------------
# resuming a JAX session
# ---------------------------------------------------------------------------

def _jax_state(s):
    """A JAX two-reference TMVP session's state as load_session_state
    takes it."""
    st = {f"{name}_{c}": np.asarray(p)
          for name, planes in (("ref", s.ref), ("ref2", s.ref2))
          for c, p in zip("yuv", planes)}
    st.update({"prev_lowres": np.asarray(s.lookahead.prev_lowres),
               "frame_idx": s.frame_idx, "poc": s.poc,
               "display_idx": s.display_idx,
               "last_ref_deltas": np.asarray(s._last_ref_deltas)})
    st.update({f"col_{k}": np.asarray(v) for k, v in s.col_field.items()})
    st.update({k: np.asarray(v) for k, v in rc_state(s.rc).items()})
    return st


def _as_state(flat):
    """load_session_state's dict from the flat (npz) form."""
    st = {k: np.asarray(v).item() if np.ndim(v) == 0 else v
          for k, v in flat.items() if not k.startswith("col_")}
    st["col_field"] = {k[4:]: v for k, v in flat.items()
                       if k.startswith("col_")}
    st["rc_window_bits"] = list(np.asarray(flat["rc_window_bits"]))
    return st


def _pinned_state():
    with np.load(STATE) as z:
        return {k: z[k] for k in z.files}


def _resume(state, nals):
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **GOLDEN)
    load_session_state(s, _as_state(state))
    frames = golden_corpus.clip()
    assert [s.encode_frame(*frames[i]).nals for i in (3, 4, 5)] == nals[3:]


def test_load_session_state_from_the_jax_session(golden):
    """A session resumed before frame 3 from the JAX golden session's
    state (two references, the collocated field, the rate control; pinned
    in STATE) continues the golden stream."""
    _resume(_pinned_state(), golden[1])


def test_load_session_state_resumes_frame_dup():
    """A frame_dup session resumed before frame 2 from the state of one
    that coded frames 0-1 (the previous source luma among it) finds frame
    2 a duplicate and codes frames 2-4 as the unbroken one."""
    clip, _, kw = P.SESSIONS["frame_dup"]
    kw = {k: v for k, v in kw.items() if k not in ("width", "height")}
    frames = clip()
    s = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    nals, state = [], None
    for i, f in enumerate(frames):
        if i == 2:
            state = {"ref_y": s.ref[0], "ref_u": s.ref[1], "ref_v": s.ref[2],
                     "prev_lowres": s.lookahead.prev_lowres.numpy(),
                     "frame_idx": s.frame_idx, "poc": s.poc,
                     "display_idx": s.display_idx,
                     "prev_src_y": s._prev_src_y, **rc_state(s.rc)}
        nals.append(s.encode_frame(*f).nals)
    r = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    load_session_state(r, state)
    assert [r.encode_frame(*f).nals for f in frames[2:]] == nals[2:]


@pytest.mark.slow
def test_state_recomputed_from_the_jax_session(golden):
    s = j_top.VideoEncoderSession(64, 48, **GOLDEN)
    frames, nals = golden_corpus.clip(), []
    for i, f in enumerate(frames):
        if i == 3:
            state = _jax_state(s)
        nals.append(s.encode_frame(*f).nals)
    assert nals == golden[1]
    pinned = _pinned_state()
    assert sorted(state) == sorted(pinned)
    for k, v in state.items():
        assert np.array_equal(v, pinned[k]), k
    _resume(state, nals)


# ---------------------------------------------------------------------------
# the option rules and the reference's faults
# ---------------------------------------------------------------------------

RULES = [dict(n_refs=3), dict(n_refs=0, tmvp=True), dict(tmvp=True,
                                                         bframes=2),
         dict(tmvp=True, max_depth=1), dict(wpp=True, max_depth=2),
         dict(wpp=True, bframes=2, deblock=True),
         dict(frame_dup=True, dup_threshold=150),
         dict(frame_dup=True, bframes=3), dict(frame_dup=True, n_refs=2),
         dict(frame_dup=True, tmvp=True, bframes=2),
         dict(frame_dup=True, max_depth=2, dup_threshold=0),
         dict(max_merge=1, max_depth=2), dict(n_refs=2, rc_mode="crf",
                                              aq_mode=2, cutree=True)]
ASSERTED = [dict(n_refs=2, bframes=2), dict(n_refs=2, max_depth=1),
            dict(n_refs=2, weightp=True), dict(wpp=True, aq_mode=2),
            dict(wpp=True, cutree=True)]


def _options(s):
    return (s.n_refs, s.tmvp, s.wpp, s.frame_dup, s.dup_threshold,
            s.max_merge, s.sps.temporal_mvp, s.pps.entropy_coding_sync,
            s.sps.max_dec_pic_buffering, s.dpb_device)


@pytest.mark.parametrize("kw", RULES)
def test_option_rules_match_jax(kw):
    """What the session keeps and drops: the JAX session's settings (built,
    never run)."""
    ts = t_top.VideoEncoderSession(64, 48, device="cpu", **kw)
    js = j_top.VideoEncoderSession(64, 48, **kw)
    jsps, jpps = js.intra_sess.sps, js.intra_sess.pps
    js.sps, js.pps = jsps, jpps
    assert _options(ts) == _options(js)


@pytest.mark.parametrize("kw", ASSERTED)
def test_asserted_options_match_jax(kw):
    for top, extra in ((t_top, {"device": "cpu"}), (j_top, {})):
        with pytest.raises(AssertionError):
            top.VideoEncoderSession(64, 48, **kw, **extra)


def _sps_dpb(stream: bytes) -> int:
    """sps_max_dec_pic_buffering_minus1 of a stream's SPS."""
    sps = next(n for n in split_annexb(stream) if (n[0] >> 1) & 63 == 33)
    br = BitReader(strip_emulation(sps[2:]))
    br.read_bits(8 + 96)          # ids, sub-layers, profile_tier_level
    for _ in range(3):
        br.read_ue()              # sps id, chroma format, width
    br.read_ue()                  # height
    if br.read_flag():            # conformance window
        for _ in range(4):
            br.read_ue()
    for _ in range(3):
        br.read_ue()              # bit depths, log2_max_poc_lsb_minus4
    br.read_flag()                # sub_layer_ordering_info_present_flag
    return br.read_ue()


def _negative_pics(stream: bytes):
    """num_negative_pics of every non-IDR slice (PPS without extra slice
    header bits, POC LSBs of 8 bits)."""
    out = []
    for n in split_annexb(stream):
        if (n[0] >> 1) & 63 in (0, 1):
            br = BitReader(strip_emulation(n[2:]))
            br.read_flag()
            br.read_ue()
            br.read_ue()
            br.read_bits(8)
            br.read_flag()
            out.append(br.read_ue())
    return out


def test_reference_faults_the_port_keeps(golden):
    """As the reference (ROADMAP Queue 3): the golden two-reference
    stream's SPS keeps a DPB of two pictures (max_dec_pic_buffering_minus1
    1) while its P slices from the second on hold two negative pictures
    (spec 7.4.8 asks them to fit in it); B and quadtree sessions drop
    tmvp, the quadtree session wpp; neither the command line nor the
    library passes wpp to the video session."""
    hdr, nals = golden
    stream = hdr + b"".join(nals)
    assert _sps_dpb(stream) == 1
    assert _negative_pics(stream) == [1, 2, 2, 2, 2]
    for kw in (dict(bframes=2), dict(max_depth=2), dict(max_depth=1)):
        s = t_top.VideoEncoderSession(64, 48, device="cpu", tmvp=True,
                                      wpp=True, **kw)
        assert not s.tmvp and s.sps.temporal_mvp == 0
        assert s.wpp == (not kw.get("max_depth"))
    args, prm = t_cli.parse(["x.y4m", "-o", "x.hevc", "--wpp", "--bframes",
                             "0"] + P.UNI16)
    s = t_cli.configure(args, prm, IO.VideoInfo(64, 48, 25, 1, IO.CSP_I420,
                                                8), device="cpu")
    assert isinstance(s, t_top.VideoEncoderSession) and not s.wpp
    p = t_api.param_default_preset("medium")
    for k, v in [("input-res", "64x48")] + list(P.API["p_only"].items()):
        t_api.param_parse(p, k, v)
    assert p.b_enable_wavefront
    s = t_api.Encoder(p, device="cpu")._sess
    assert not s.wpp and s.pps.entropy_coding_sync == 0


def test_frame_dup_on_the_quadtree_stops_at_the_duplicate():
    """The quadtree IPPP session keeps frame_dup and stops at the first
    duplicate frame, as the reference does (its quadtree writer has no
    skip slice; the slow twin shows the reference's KeyError)."""
    s = t_top.VideoEncoderSession(64, 48, device="cpu", qp=30, max_depth=1,
                                  frame_dup=True, keyint=100)
    assert s.frame_dup
    f = golden_corpus.clip(n=1)[0]
    s.encode_frame(*f)
    with pytest.raises(NotImplementedError, match="frame_dup"):
        s.encode_frame(*f)


@pytest.mark.slow
def test_frame_dup_on_the_jax_quadtree_fails():
    s = j_top.VideoEncoderSession(64, 48, qp=30, max_depth=1,
                                  frame_dup=True, keyint=100)
    f = golden_corpus.clip(n=1)[0]
    s.encode_frame(*f)
    with pytest.raises(KeyError, match="split"):
        s.encode_frame(*f)


# ---------------------------------------------------------------------------
# slow twins: the pins from the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", P_SESSIONS)
def test_session_pin_from_jax(name):
    assert P.run(j_top, name)[:2] == P.PINS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(P.CLI))
def test_cli_pin_from_jax(name, tmp_path):
    from x265_yuuki_asuna_tpu import cli as j_cli
    assert P.run_cli(j_cli.main, name, str(tmp_path)) == P.CLI_PINS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(P.API))
def test_api_pin_from_jax(name):
    from x265_yuuki_asuna_tpu import api as j_api
    assert P.run_api(j_api, name) == P.API_PINS[name]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


@pytest.mark.gpu
def test_golden_and_pins_on_the_card(tmp_path):
    _need_card()
    hdr, nals = _golden_stream()
    assert hashlib.md5(hdr + b"".join(nals)).hexdigest() == \
        GP.manifest("ippp_multiref_tmvp")
    for name in P_SESSIONS:
        if name != "merge4_qt1" and not name.startswith("frame_dup"):
            assert P.run(t_top, name)[:2] == P.PINS[name], name
    for name in P.CLI:
        assert _same_cli(P.run_cli(t_cli.main, name, str(tmp_path)),
                         name), name
    for name in P.API:
        assert P.run_api(t_api, name) == P.API_PINS[name], name


@pytest.mark.gpu
def test_ref2_program_kernel_vs_plain_on_the_card():
    """The two-reference program through K1 on the card (two fused
    sweeps) equals its plain version on the CPU."""
    _need_card()
    src, r0, r1 = _ref2_inputs()
    enc = t_inter.InterFrameEncoder(W, H, 16, "cuda")
    before = me_sad.sad_sweep_best.launches
    d = enc.encode_frame(*src, *r0, 33, ref2=r1)
    assert me_sad.sad_sweep_best.launches - before == 2
    assert QP.digest(d) == DIGEST["ref2"]
