"""The CTU32 depth-1 quadtree (CUs 32 and 16: x265's ultrafast geometry)
in the port against the JAX package (CPU, exact).

- The golden intra_qt1 stream against the manifest.
- The intra, P (with and without HME, whose coarse sweep runs at sizes 16
  and 8 on the 8x8 surface), B (with intra candidates, so the commit
  runs) and per-CTU-QP intra decision dicts at 128x96, held to digests of
  the JAX dicts pinned here; the slow test recomputes them from the JAX
  programs (minutes of compiling each) and compares key by key.
- split_rd's depth-1 branch against the reference's expression in jnp.
- The depth-1 filter chain: the device form against
  qt_loopfilter_dev(depth2=False), and the host form (the
  session's path without the device DPB) against the reference's host
  functions (expand_qt_maps, compute_bs_qt and deblock_frame_inter on the
  16-sample grid, then the intra session's SAO decision), at one QP and
  under a per-CTU QP map.
- The qt2 writer at max_depth=1 (I, P and B slices, with SAO and a QP
  map) against the JAX ctypes writer on seeded decision dicts.
- Sessions over the golden clip held to the JAX sessions' pinned md5s,
  with their (POC, type, QP) lists and NAL types: IPPP, a B-pyramid,
  filtered IPPP on the device chain and on the host-filter path (under
  weightp, and under AQ with dpb_device=False); a mid-GOP resume through
  load_session_state; the slow test recomputes the pins.
- Card twins (gpu): the golden, and one B frame's K1 path against its
  plain path."""
import hashlib
import types
from unittest import mock

import numpy as np
import pytest
import torch

import grid_pins as GP
import jax
import jax.numpy as jnp
import test_torch_qt_programs as QP
from golden_corpus import clip
from test_torch_filters import _qt_inputs
from test_torch_qt_ops import _random_sao, _random_tree
from x265_yuuki_asuna_tpu.bitstream import native as j_native
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.models.intra_encoder import chroma_qp_from_luma
from x265_yuuki_asuna_tpu.ops import deblock as j_db
from x265_yuuki_asuna_tpu.ops import filters_dev as j_fd
from x265_yuuki_asuna_tpu_torch.bitstream import native as t_native
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import qt_common as t_qt
from x265_yuuki_asuna_tpu_torch.models.inter_encoder import InterQTEncoder
from x265_yuuki_asuna_tpu_torch.models.intra_encoder import IntraQTEncoder
from x265_yuuki_asuna_tpu_torch.models.state import (load_session_state,
                                                     rc_state)
from x265_yuuki_asuna_tpu_torch.ops import filters as t_fl
from x265_yuuki_asuna_tpu_torch.ops.kernels import me_sad

torch.set_num_threads(2)
W, H = QP.W, QP.H
DEPTH2_KEYS = ("split16", "use_intra8", "modes8", "mv8x", "mv8y", "pdir8",
               "mv81x", "mv81y")

t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
h = lambda a: a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


def test_intra_qt1_matches_the_golden_manifest():
    assert GP.golden_md5(t_top, "intra_qt1", device="cpu") == \
        GP.manifest("intra_qt1")


# ---------------------------------------------------------------------------
# the programs' decision dicts
# ---------------------------------------------------------------------------

# sha256 of the JAX package's depth-1 decision dicts (QP.digest) of
# QP._frames(): the intra frame at qp 30, the P frame at qp 32 (without
# and with HME), the B frame at qp 33 with intra candidates and the intra
# frame at QP.QMAP
DIGEST = {"intra":
            "24439a72f16f9fd3d3d5c7bb5d06e5bb3bcc7004093f0f7ebbd4581e25a3b8a6",
          "p":
            "63ebbe20f684c074f5951f7c793d5b85790857143368219f6591a2ae0b4fc5c4",
          "p_hme":
            "94de55875cfc5dbcb0095f4c7b6a008870618d3fded44fece625d45490781ad2",
          "b_intra":
            "c7f71bce848b50ef0accd6a60e2ced20f24ee682216f2bb6d2f1f8c6f23e8566",
          "intra_aq":
            "ed2de61357f1f533425c330f2918ac892218b5e58cd8e713df9e4f9bd2e7db0a"}


def _programs(intra_cls, inter_cls, jax_side: bool):
    """The five depth-1 dicts from the given encoders (the port's, or
    constructors of the JAX ones); the P and B frames predict from the
    intra frame's recon (and B from the P frame's as L1); the B frame is
    QP._b_frame's with a new noise patch."""
    f0, f1 = QP._frames()
    y, u, v = QP._b_frame(f0, f1)
    y = y.copy()
    # a patch neither reference has: intra leaves in the B frame
    y[8:40, 8:56] = np.random.default_rng(4).integers(0, 256, (32, 48))
    fb = (y, u, v)
    ti = intra_cls(30).encode_frame(*f0, qp=30)
    out = {"intra": ti}
    out["p"] = inter_cls(32, {}).encode_frame(*f1, *QP._recon(ti), 32)
    out["p_hme"] = inter_cls(32, {"hme": True}).encode_frame(
        *f1, *QP._recon(ti), 32)
    rec1 = QP._recon(out["p"])
    if jax_side:
        out["b_intra"] = inter_cls(33, {"bi": True}).encode_frame(
            *fb, *QP._recon(ti), 33, ref1_y=rec1[0], ref1_u=rec1[1],
            ref1_v=rec1[2])
        out["intra_aq"] = intra_cls(30).encode_frame(
            *f0, qp=QP.QMAP.reshape(-1), slice_qp=QP.QMAP_SLICE)
    else:
        out["b_intra"] = inter_cls(33, {"b_intra": True}).encode_frame(
            *fb, *QP._recon(ti), 33, ref1=rec1)
        out["intra_aq"] = intra_cls(30).encode_frame(
            *f0, QP.QMAP, slice_qp=QP.QMAP_SLICE)
    return out


@pytest.fixture(scope="module")
def port_frames():
    return _programs(
        lambda qp: IntraQTEncoder(W, H, "cpu", max_depth=1),
        lambda qp, kw: InterQTEncoder(W, H, "cpu", max_depth=1, **kw),
        False)


def jax_programs():
    """The JAX package's dicts of port_frames' frames (five program
    compiles of minutes each)."""
    from x265_yuuki_asuna_tpu.models.inter_encoder import (
        InterFrameConfig, InterFrameEncoder)
    from x265_yuuki_asuna_tpu.models.intra_encoder import (
        IntraFrameConfig, IntraFrameEncoder)
    intra = IntraFrameEncoder(IntraFrameConfig(
        width=W, height=H, cu_size=32, qp=30, max_depth=1, dpb=True))

    class Jax:
        def __init__(self, enc):
            self.enc = enc

        def encode_frame(self, *a, **k):
            return QP._jax_dict(self.enc.encode_frame(*a, **k))

    def inter(qp, kw):
        return Jax(InterFrameEncoder(InterFrameConfig(
            width=W, height=H, cu_size=32, qp=qp, max_depth=1, dpb=True,
            intra_in_b=True, **kw)))
    return _programs(lambda qp: Jax(intra), inter, True)


@pytest.mark.parametrize("name", sorted(DIGEST))
def test_qt1_decisions_match_jax(port_frames, name):
    d = port_frames[name]
    assert QP.digest(d) == DIGEST[name]
    assert all(d.get(k) is None for k in DEPTH2_KEYS)
    assert d["split"].any() and not d["split"].all()


def test_qt1_decisions_reach_every_branch(port_frames):
    """The P frame has intra leaves at 32 or 16; HME moves some MV; the B
    frame has every prediction direction and intra leaves; the QP map
    changes the intra decisions."""
    p, ph, b = port_frames["p"], port_frames["p_hme"], port_frames["b_intra"]
    assert p["use_intra"].any() or p["use_intra4"].any()
    assert not (np.array_equal(p["mv4x"], ph["mv4x"])
                and np.array_equal(p["mvx"], ph["mvx"]))
    pdirs = np.concatenate([b["pdir"].reshape(-1), b["pdir4"].reshape(-1)])
    assert set(np.unique(pdirs)) == {1, 2, 3}
    assert b["use_intra"].any() or b["use_intra4"].any()
    assert not np.array_equal(port_frames["intra_aq"]["levels_y"],
                              port_frames["intra"]["levels_y"])


@pytest.mark.slow
def test_qt1_digests_recomputed_from_the_jax_programs(port_frames):
    jf = jax_programs()
    for name in DIGEST:
        assert QP.digest(jf[name]) == DIGEST[name], name
        QP._assert_same_dict(jf[name], port_frames[name])


def test_split_rd_depth1_matches_the_reference_expression():
    """split_rd without 8-leaves: the 16x16 CU's bits take no split flag
    (the reference's t16b = b16 + 0.0), bB = sum of the four + 1; the
    reference's jnp lines of the depth-1 branch on seeded float32 costs,
    ties included."""
    geo = t_qt.QtGeometry(3, 4, torch.device("cpu"))
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.integers(0, 4000, s).astype(np.float32) / 8
    d16, b16, dA, bA = f32(48), f32(48), f32(12), f32(12)
    dA[:4] = [d16[m].sum() for m in h(geo.map16)[:4]]   # near ties
    lam = (0.85 * jnp.exp2((jnp.arange(26, 38).astype(jnp.float32)
                            - 12.0) / 3.0)).astype(jnp.float32)
    m16 = jnp.asarray(h(geo.map16))
    dB = jnp.take(jnp.asarray(d16), m16).sum(1)
    bB = jnp.take(jnp.asarray(b16) + 0.0, m16).sum(1) + 1.0
    want = (dB + lam * bB) < (jnp.asarray(dA) + lam * (jnp.asarray(bA)
                                                        + 1.0))
    leaf = {32: {"dist": t(dA), "bits": t(bA)},
            16: {"dist": t(d16), "bits": t(b16)}}
    sp16, split = t_qt.split_rd(leaf, geo, t(np.array(lam)))
    assert sp16 is None
    assert np.array_equal(h(split), np.asarray(want))
    assert 0 < h(split).sum() < 12


# ---------------------------------------------------------------------------
# the filter chain at depth 1
# ---------------------------------------------------------------------------

def _depth1_inputs(kind):
    """test_torch_filters' 128x96 chain inputs with the depth-2 parts
    dropped (no split16, no 8x8 sizes)."""
    inp = _qt_inputs(kind)
    inp["split16"] = None
    for k in ("ui", "mv", "pdir"):
        if inp[k] is not None:
            inp[k] = tuple(inp[k][:2]) + (None,)
    return inp


@pytest.fixture(scope="module")
def jax_loopfilter_depth1():
    """qt_loopfilter_dev with depth2=False, compiled once for the I
    frame's argument structure (deblock and SAO) and once for the P / B
    frames' (deblock)."""
    def run(rec3, src3, qp_cu, slice_qp, split, ui, mv, pdir, lv3):
        intra = ui is None
        out3, arrs = j_fd.qt_loopfilter_dev(
            rec3, src3, qp_cu, slice_qp, split, None, ui, mv, pdir, lv3, 3,
            4, False, True, intra, 8)
        return out3, j_fd.pack_sao_params(arrs) if intra else None
    return jax.jit(run)


@pytest.mark.parametrize("kind,qmap", [("I", False), ("P", True),
                                       ("B", False), ("B", True)])
def test_qt_loopfilter_depth1_matches_jax(jax_loopfilter_depth1, kind,
                                          qmap):
    """The port's chain with split16=None against qt_loopfilter_dev with
    depth2=False, at one QP or the per-CTU map: the deblock, the part
    that depth changes (the cells' depth, BS and QPs; SAO runs on the
    deblocked planes at either depth, and test_torch_filters holds it),
    with SAO on the I frame."""
    inp = _depth1_inputs(kind)
    rows, cols = 3, 4
    qp = 31
    qp_cu = inp["qp_cu"] if qmap else np.full(rows * cols, qp, np.int32)
    ja = lambda a: None if a is None else jnp.asarray(a)
    jmv = jpd = None
    if inp["mv"] is not None:
        # the JAX P program passes pdir 1 and zero L1 MVs
        jmv = tuple(None if s is None else tuple(
            ja(a if a is not None else np.zeros_like(s[0])) for a in s)
            for s in inp["mv"])
        jpd = tuple(ja(a) for a in inp["pdir"]) if inp["pdir"] else \
            (jnp.ones(rows * cols, jnp.int32),
             jnp.ones(4 * rows * cols, jnp.int32), None)
    j3, jsao = jax_loopfilter_depth1(
        tuple(map(ja, inp["rec3"])), tuple(map(ja, inp["src3"])),
        ja(qp_cu), jnp.int32(qp), ja(inp["split"]),
        None if inp["ui"] is None else tuple(map(ja, inp["ui"])), jmv, jpd,
        tuple(map(ja, inp["lv3"])))
    planes = [t(a.reshape(rows, cols, k, k).transpose(0, 2, 1, 3)
                .reshape(rows * k, cols * k))
              for a, k in zip(inp["lv3"], (32, 16, 16))]
    tt = lambda a: None if a is None else t(a)
    p3, psao = t_fl.qt_loopfilter(
        tuple(map(t, inp["rec3"])), tuple(map(t, inp["src3"])), t(qp_cu),
        qp, t(inp["split"]), None,
        None if inp["ui"] is None else tuple(map(tt, inp["ui"])),
        None if inp["mv"] is None else tuple(
            None if s is None else tuple(map(tt, s)) for s in inp["mv"]),
        None if inp["pdir"] is None else tuple(map(tt, inp["pdir"])),
        planes, True, kind == "I")
    for a, b in zip(j3, p3):
        assert np.array_equal(np.asarray(a), h(b))
    if kind == "I":
        assert np.array_equal(np.asarray(jsao), h(psao))
        assert not np.array_equal(h(p3[0]), inp["rec3"][0])


# (frame, QP or a per-CTU map, slice QP)
HOST_CASES = {"p": ("p", 32, 32), "b": ("b", 26, 26),
              "p_aq": ("p", QP.QMAP, 32), "b_aq": ("b", QP.QMAP - 6, 26)}


def _jax_host_filters_depth1(out, qp, slice_qp, src):
    """The JAX video session's host path at depth 1 on an unfiltered
    decision dict: _deblock_frame's max_depth=1 branch (expand_qt_maps,
    compute_bs_qt, deblock_frame_inter on the 16-sample grid with the CTU
    map repeated 2x2), then the intra session's _sao_decide. Returns the
    recon planes and the SAO parameters packed [ncu, 18]."""
    out = dict(out)
    if np.ndim(qp):
        out["qp_map"] = qp
    qmap = j_top.effective_qp_map(out, out.get("qp_map"), slice_qp)
    bs_v, bs_h = j_db.compute_bs_qt(j_db.expand_qt_maps(out))
    q16 = slice_qp if qmap is None else \
        np.repeat(np.repeat(qmap, 2, 0), 2, 1)
    dy, du, dv = j_db.deblock_frame_inter(
        out["recon_y"], out["recon_u"], out["recon_v"], 16, q16,
        chroma_qp_from_luma(slice_qp), bs_v, bs_h)
    out["recon_y"], out["recon_u"], out["recon_v"] = (
        np.asarray(dy), np.asarray(du), np.asarray(dv))
    stub = types.SimpleNamespace(bit_depth=8, cu=32, rows=H // 32,
                                 cols=W // 32, qp=slice_qp)
    params = j_top.IntraEncoderSession._sao_decide(stub, out, *src,
                                                   qp=slice_qp)
    packed = np.array([[x for c in ("luma", "cb", "cr")
                        for x in (p[c][0], p[c][1], *p[c][2])]
                       for row in params for p in row], np.int32)
    return (out["recon_y"], out["recon_u"], out["recon_v"]), packed


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_filter_chain_depth1_matches_jax(port_frames, case):
    """InterQTEncoder(max_depth=1) with sao_form="host" equals the JAX
    session's depth-1 host filters on the same decisions, for a P and a B
    frame, at one QP and under a per-CTU map."""
    frame, qp, slice_qp = HOST_CASES[case]
    f0, f1 = QP._frames()
    src = f1 if frame == "p" else QP._b_frame(f0, f1)
    ref0 = QP._recon(port_frames["intra"])
    kw = dict(ref1=QP._recon(port_frames["p"]) if frame == "b" else None,
              slice_qp=slice_qp)
    raw = InterQTEncoder(W, H, "cpu", max_depth=1).encode_frame(
        *src, *ref0, qp, **kw)
    host = InterQTEncoder(W, H, "cpu", deblock=True, sao=True,
                          sao_form="host", max_depth=1).encode_frame(
        *src, *ref0, qp, **kw)
    rec, packed = _jax_host_filters_depth1(raw, qp, slice_qp, src)
    for k, want in zip(("recon_y", "recon_u", "recon_v"), rec):
        assert np.array_equal(host[k], want), k
    assert np.array_equal(host["sao"], packed)
    assert not np.array_equal(host["recon_y"], raw["recon_y"])


# ---------------------------------------------------------------------------
# the writer at max_depth=1
# ---------------------------------------------------------------------------

def _depth1_tree(rng, slice_type):
    out = _random_tree(rng, 3, 4, slice_type)
    for k in DEPTH2_KEYS:
        out.pop(k, None)
    return out


# (slice type, poc, L0 poc, L1 poc)
WRITER_CASES = [(2, 0, 0, 0), (1, 0, 0, 0), (0, 1, 0, 2), (0, 3, 0, 4),
                (0, 2, 1, 4)]


@pytest.mark.parametrize("case", WRITER_CASES)
@pytest.mark.parametrize("extras", ["plain", "sao_qp_map"])
def test_native_qt1_writer_matches_jax(case, extras):
    """I, P and B slices at max_depth=1 (the B slices across POC
    distances, so AMVP scales the other list's MVs), bare and with SAO
    and a per-CTU QP map."""
    slice_type, poc, poc0, poc1 = case
    rng = np.random.default_rng(100 + 10 * slice_type + poc)
    out = _depth1_tree(rng, slice_type)
    kw = dict(poc=poc, poc_l0=poc0, poc_l1=poc1) if slice_type == 0 else {}
    if extras != "plain":
        kw.update(sao=_random_sao(rng, 3, 4),
                  qp_map=rng.integers(26, 38, (3, 4)).astype(np.int32))
    j = j_native.encode_slice_qt2(slice_type, 1, out, 31, 3, **kw)
    p = t_native.encode_slice_qt2(slice_type, 1, out, 31, 3, **kw)
    assert j is not None and p == j
    assert p != t_native.encode_slice_qt2(slice_type, 2, dict(
        out, split16=np.ones((3, 4, 4), bool),
        **{k: np.zeros((3, 4, 4, 4), np.int32) for k in DEPTH2_KEYS[1:]}),
        31, 3, **kw)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GP.QT1_SESSIONS))
def test_qt1_session_matches_pinned_jax_stream(name):
    """The stream md5, each result's (POC, type, QP) and the NAL types
    (tests/grid_pins.py)."""
    stream, frames = GP.run_qt1(t_top, name, device="cpu")
    assert GP.qt1_pin_of(stream, frames, name) == GP.QT1_PINS[name]
    assert GP.nal_types(stream) == GP.QT1_NALS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(GP.QT1_SESSIONS))
def test_qt1_session_pins_recomputed_from_the_jax_session(name):
    """Where the pins come from: the JAX session's stream (its depth-1
    programs compile for a minute or two)."""
    stream, frames = GP.run_qt1(j_top, name)
    assert (hashlib.md5(stream).hexdigest(), frames) == GP.QT1_PINS[name]
    assert GP.nal_types(stream) == GP.QT1_NALS[name]


def _port_state(s):
    st = {"ref_y": h(s.ref[0]), "ref_u": h(s.ref[1]), "ref_v": h(s.ref[2]),
          "prev_lowres": h(s.lookahead.prev_lowres),
          "frame_idx": s.frame_idx, "poc": s.poc,
          "display_idx": s.display_idx}
    st.update(rc_state(s.rc))
    return st


@pytest.mark.parametrize("lf", [False, True], ids=["plain", "filtered"])
def test_qt1_load_session_state_mid_gop(lf):
    """A depth-1 IPPP session resumed before frame 3 from the state of one
    that ran frames 0-2 codes frames 3-5 as the unbroken one."""
    kw = dict(GP.QT1_SESSIONS["qt1_lf" if lf else "qt1_ippp"],
              device="cpu")
    frames = clip()
    s = t_top.VideoEncoderSession(64, 48, **kw)
    nals, state = [], None
    for i, f in enumerate(frames):
        if i == 3:
            state = _port_state(s)
        nals.append(s.encode_frame(*f).nals)
    r = t_top.VideoEncoderSession(64, 48, **kw)
    load_session_state(r, state)
    assert [r.encode_frame(*f).nals for f in frames[3:]] == nals[3:]


@pytest.mark.slow
def test_qt1_load_session_state_from_the_jax_session():
    """A port session resumed from a JAX depth-1 session's state after
    frame 2 codes frames 3-5 as the JAX session does."""
    frames = clip()
    j = j_top.VideoEncoderSession(64, 48, **GP.QT1_SESSIONS["qt1_ippp"])
    for f in frames[:3]:
        j.encode_frame(*f)
    state = {"ref_y": np.asarray(j.ref[0]), "ref_u": np.asarray(j.ref[1]),
             "ref_v": np.asarray(j.ref[2]),
             "prev_lowres": np.asarray(j.lookahead.prev_lowres),
             "frame_idx": j.frame_idx, "poc": j.poc,
             "display_idx": j.display_idx}
    state.update(rc_state(j.rc))
    want = [j.encode_frame(*f).nals for f in frames[3:]]
    r = t_top.VideoEncoderSession(64, 48, device="cpu",
                                  **GP.QT1_SESSIONS["qt1_ippp"])
    load_session_state(r, state)
    assert [r.encode_frame(*f).nals for f in frames[3:]] == want


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_qt1_golden_and_pins_on_the_card():
    _need_card()
    assert GP.golden_md5(t_top, "intra_qt1") == GP.manifest("intra_qt1")
    for name in GP.QT1_SESSIONS:
        stream, frames = GP.run_qt1(t_top, name)
        assert GP.qt1_pin_of(stream, frames, name) == GP.QT1_PINS[name], \
            name


@pytest.mark.gpu
def test_qt1_b_frame_kernel_vs_plain_on_the_card():
    """The last b frame of a depth-1 B session with intra candidates and
    HME again, K1 against its plain version: every decision and the
    recon."""
    _need_card()
    s = t_top.VideoEncoderSession(128, 96, hme=True, b_intra=True,
                                  **dict(GP.QT1_SESSIONS["qt1_b"],
                                         hash_sei=False))
    enc = s.inter_encoder
    calls, run = [], enc.encode_frame
    enc.encode_frame = lambda *a, **k: calls.append((a, k)) or run(*a, **k)
    for f in clip(128, 96, n=5):
        s.push_frame(*f)
    a, k = calls[-1]
    out_k = run(*a, **k)
    with mock.patch.object(me_sad, "sad_block8_sweep",
                           me_sad.sad_block8_sweep_plain):
        out_p = run(*a, **k)
    for key, v in out_k.items():
        if key == "recon_dev":
            assert all(torch.equal(x, z) for x, z in zip(v, out_p[key]))
        elif v is None:
            assert out_p[key] is None
        else:
            assert np.array_equal(v, out_p[key]), key
