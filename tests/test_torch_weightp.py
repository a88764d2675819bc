"""Weighted prediction (weightp) and the host-filter quadtree session of the
port against the JAX package (CPU, exact).

Ops, with no JAX program compiled: the weighted combine weight_uni and the
search's reference transform, the session's weight decision, the PPS and
P slice headers with the pred_weight_table, and the host filter chain
(deblock through DB.expand_qt_maps8 / compute_bs_qt2 / deblock_frame_qt2,
then the host SAO) on quadtree P and B decision dicts. Streams: the golden
ippp_weightp md5, the JAX weightp test's fade decoded by the JAX tests'
decoder, and the quadtree sessions and the library at the medium preset
held to the JAX md5s, frame lists and chosen weights pinned in
tests/weightp_pins.py and tests/preset_pins.py (the JAX quadtree programs
take minutes to compile on the CPU); the slow tests recompute each pin
from the live JAX package, the gpu tests run the streams on the card."""
import hashlib
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import preset_pins as PP
import weightp_pins as WP
from golden_corpus import clip
from x265_yuuki_asuna_tpu.bitstream import headers as j_hdr
from x265_yuuki_asuna_tpu.models import encoder_top as j_top
from x265_yuuki_asuna_tpu.models.intra_encoder import chroma_qp_from_luma
from x265_yuuki_asuna_tpu.ops import deblock as j_db
from x265_yuuki_asuna_tpu.ops import interp as j_interp
from x265_yuuki_asuna_tpu_torch import api as t_api
from x265_yuuki_asuna_tpu_torch.bitstream import headers as t_hdr
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models.inter_encoder import InterQTEncoder
from x265_yuuki_asuna_tpu_torch.models.intra_encoder import IntraQTEncoder
from x265_yuuki_asuna_tpu_torch.ops import interp as t_interp

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "manifest.json")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_weight_uni_matches_jax():
    """Every weight 1..127 and offset -128..127 over seeded short-domain
    predictions (the 8-bit MC's range), at denominator 6."""
    rng = np.random.default_rng(11)
    w = np.arange(1, 128, dtype=np.int32)[:, None, None]
    o = np.arange(-128, 128, dtype=np.int32)[None, :, None]
    ps = rng.integers(-10000, 25000, (127, 256, 8)).astype(np.int32)
    want = j_interp.weight_uni(ps, w, o, 6, 8, xp=np)
    got = t_interp.weight_uni(torch.as_tensor(ps), torch.as_tensor(w),
                              torch.as_tensor(o), 6)
    assert np.array_equal(got.numpy(), want)
    assert want.min() == 0 and want.max() == 255


@pytest.mark.parametrize("w,o", [(64, 0), (1, -128), (127, 127), (60, -8),
                                 (71, -11), (6, 86)])
def test_search_plane_transform_matches_jax(w, o):
    """The weighted search's reference plane: the JAX programs' inline
    clip(((ref * w + 32) >> 6) + o, 0, 255) (inter_encoder.py:281-282,
    :763-767, :775-779), here as jnp on the int32 plane."""
    ref = np.random.default_rng(w).integers(0, 256, (48, 64)) \
        .astype(np.int32)
    want = np.asarray(jnp.clip(jnp.right_shift(jnp.asarray(ref) * w + 32, 6)
                               + o, 0, 255))
    got = t_interp.weight_plane(torch.as_tensor(ref).to(torch.uint8), w, o)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy().astype(np.int32), want)


def _wcase(kind: str):
    """Seeded (y, u, v) source and reference planes for one branch of the
    weight decision."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    ref = [rng.integers(40, 200, (64, 96)).astype(np.uint8),
           rng.integers(60, 180, (32, 48)).astype(np.uint8),
           rng.integers(60, 180, (32, 48)).astype(np.uint8)]
    src = [p.astype(np.float64) for p in ref]
    if kind == "fade":          # luma and cb fade, cr unchanged (identity)
        src[0] = src[0] * 0.8 - 12
        src[1] = src[1] * 1.1 + 3
    elif kind == "flat":        # a flat reference: sd < 0.5, no weight
        ref[0][:] = 128
        ref[1][:] = 90
        src[0] = src[0] * 0 + 100
        src[2] = src[2] - 20
    elif kind == "clips":       # w and o past their ranges
        ref[0] = (ref[0] // 40 + 100).astype(np.uint8)
        src[0] = rng.integers(0, 256, (64, 96)).astype(np.float64)
        src[1] = src[1] * 0.02 + 250
    elif kind == "no_gain":     # weights that do not cut the SAD by 1%
        src = [rng.integers(0, 256, p.shape).astype(np.float64) for p in ref]
    src = [np.clip(np.round(p), 0, 255).astype(np.uint8) for p in src]
    return src, ref


@pytest.mark.parametrize("kind", ["fade", "flat", "clips", "no_gain"])
def test_decide_weights_matches_jax(kind):
    src, ref = _wcase(kind)
    stub = types.SimpleNamespace(weightp=True)
    want = j_top.VideoEncoderSession._decide_weights(stub, *src, ref)
    got = t_top.VideoEncoderSession._decide_weights(*src, ref)
    # the reference planes may be device tensors (the port's DPB)
    dev = t_top.VideoEncoderSession._decide_weights(
        *src, [torch.as_tensor(p) for p in ref])
    assert got == want and dev == want
    expect = {"fade": lambda d: set(d) == {"luma", "cb"},
              "flat": lambda d: d is not None and set(d) == {"cr"},
              "clips": lambda d: d["luma"][0] == 127 and d["cb"][1] == 127,
              "no_gain": lambda d: d is None}
    assert expect[kind](want), want


WEIGHTS = [None, {"luma": (60, -8)}, {"luma": (63, -15), "cb": (66, 3)},
           {"cb": (73, -1)}, {"cr": (71, -11)},
           {"luma": (127, 127), "cb": (1, -128), "cr": (6, 86)}]


@pytest.mark.parametrize("weights", WEIGHTS)
def test_pps_and_p_slice_header_with_weights_match_jax(weights):
    """The PPS's weighted_pred_flag and the P slice's pred_weight_table
    (no weights: all flags 0; one chroma component alone), byte-equal to
    the JAX writers; B slices carry no table."""
    sps = dict(width=64, height=48, sao_enabled=1, timing_info=(1, 25))
    pps = dict(init_qp=26, weighted_pred=1)
    js, jp = j_hdr.SPSInfo(**sps), j_hdr.PPSInfo(**pps)
    ts, tp = t_hdr.SPSInfo(**sps), t_hdr.PPSInfo(**pps)
    assert t_hdr.write_pps(tp) == j_hdr.write_pps(jp)
    assert t_hdr.write_pps(tp) != t_hdr.write_pps(t_hdr.PPSInfo(init_qp=26))
    for slice_type, poc in ((1, 4), (0, 2)):
        kw = dict(nal_type=1, poc=poc, ref_poc_delta=2,
                  pos_poc_delta=2 if slice_type == 0 else 0, max_merge=3)
        j = j_hdr.write_slice_header(js, jp, slice_type, 31, sao_luma=1,
                                     sao_chroma=1, weights=weights, **kw)
        t = t_hdr.write_slice_header(ts, tp, slice_type, 31, sao=True,
                                     weights=weights, **kw)
        assert t.get_bytes() == j.get_bytes(), slice_type


# the host filter chain on decision dicts --------------------------------

W, H = 128, 96


def _frames():
    """Three frames of the golden clip at 128x96 with noise on the left
    (deep splits) and a new patch in the second (intra leaves)."""
    rng = np.random.default_rng(21)
    frames = clip(W, H, n=2, seed=5)
    noise = rng.integers(-40, 40, (H, W // 2))
    out = []
    for i, (y, u, v) in enumerate(frames):
        y = y.astype(np.int32)
        y[:, :W // 2] += np.roll(noise, 2 * i, 1)
        if i:
            y[40:72, 72:112] = rng.integers(0, 256, (32, 40))
        out.append((np.clip(y, 0, 255).astype(np.uint8), u, v))
    mid = tuple(((a.astype(np.int32) + b + 1) // 2).astype(np.uint8)
                for a, b in zip(*out))
    return out + [mid]


@pytest.fixture(scope="module")
def qt_dicts():
    """The port's I recon (qp 30) and P recon (qp 32) as references."""
    f0, f1, fb = _frames()
    ti = IntraQTEncoder(W, H, "cpu").encode_frame(*f0, 30)
    rec = lambda d: (d["recon_y"], d["recon_u"], d["recon_v"])
    tp = InterQTEncoder(W, H, "cpu").encode_frame(*f1, *rec(ti), 32)
    return {"p": (f1, rec(ti), None), "b": (fb, rec(ti), rec(tp))}


# (frame, QP or a per-CTU map, slice QP): the SAO forms' lambdas differ at
# 26 and 32; the map's CTUs without residual keep the previous QP
QMAP = np.array([[33, 30, 36, 27], [31, 38, 25, 32], [29, 35, 26, 34]],
                np.int32)
HOST_CASES = {"p": ("p", 32, 32), "b": ("b", 26, 26),
              "p_aq": ("p", QMAP, 32), "b_aq": ("b", QMAP - 6, 26)}


def _jax_host_filters(out, qp, slice_qp, src):
    """The JAX video session's host path on an unfiltered decision dict:
    _deblock_frame's depth-2 branch, then the intra session's
    _sao_decide. Returns the recon planes and the SAO parameters packed
    [ncu, 18] as the port packs them."""
    out = dict(out)
    if np.ndim(qp):
        out["qp_map"] = qp
    qmap = j_top.effective_qp_map(out, out.get("qp_map"), slice_qp)
    bs_v, bs_h = j_db.compute_bs_qt2(j_db.expand_qt_maps8(out))
    dy, du, dv = j_db.deblock_frame_qt2(
        out["recon_y"], out["recon_u"], out["recon_v"],
        qmap if qmap is not None else slice_qp,
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
def test_host_filter_chain_matches_jax(qt_dicts, case):
    """The quadtree program's host-form chain (InterQTEncoder with
    sao_form="host") equals the JAX session's host filters on the same
    decisions, for a P and a B frame, at one QP and under a per-CTU map."""
    frame, qp, slice_qp = HOST_CASES[case]
    src, ref0, ref1 = qt_dicts[frame]
    kw = dict(ref1=ref1, slice_qp=slice_qp)
    raw = InterQTEncoder(W, H, "cpu").encode_frame(*src, *ref0, qp, **kw)
    host = InterQTEncoder(W, H, "cpu", deblock=True, sao=True,
                          sao_form="host").encode_frame(*src, *ref0, qp,
                                                        **kw)
    rec, packed = _jax_host_filters(raw, qp, slice_qp, src)
    for k, want in zip(("recon_y", "recon_u", "recon_v"), rec):
        assert np.array_equal(host[k], want), k
    assert np.array_equal(host["sao"], packed)
    assert (packed[:, 0] > 0).any()          # SAO took effect somewhere
    assert not np.array_equal(host["recon_y"], raw["recon_y"])


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def _golden_weightp(device):
    frames = WP.golden_fade(6)
    s = t_top.VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                                  weightp=True, hash_sei=False,
                                  device=device)
    with WP.weights_recorded(t_top.VideoEncoderSession) as weights:
        out = s.headers() + b"".join(s.encode_frame(*f).nals for f in frames)
    return hashlib.md5(out).hexdigest(), weights


def _manifest(name):
    with open(GOLDEN) as fh:
        return json.load(fh)[name]


def test_golden_ippp_weightp():
    md5, weights = _golden_weightp("cpu")
    assert md5 == _manifest("ippp_weightp")
    assert any(w and w.get("luma", (64, 0)) != (64, 0) for w in weights)


def _fade_run(weightp: bool):
    """tests/test_weightp.py's fade through the port, decoded by the JAX
    tests' decoder: (bits, decoded == recon for every plane)."""
    from test_weightp import _fade
    from x265_yuuki_asuna_tpu.utils.av_decode import decode_hevc
    s = t_top.VideoEncoderSession(64, 48, qp=32, cu_size=16, keyint=100,
                                  hash_sei=False, weightp=weightp,
                                  device="cpu")
    res = [s.encode_frame(*f) for f in _fade(64, 48, 5)]
    dec = decode_hevc(s.headers() + b"".join(r.nals for r in res),
                      s.coded_w, s.coded_h)
    same = len(dec) == len(res) and all(
        np.array_equal(d[p][:r.recon[p].shape[0], :r.recon[p].shape[1]]
                       .astype(np.uint8), r.recon[p])
        for d, r in zip(dec, res) for p in range(3))
    return sum(r.bits for r in res), same


def test_weightp_fade_decodes_and_costs_fewer_bits():
    pytest.importorskip("cv2")
    bits_w, same_w = _fade_run(True)
    bits_p, same_p = _fade_run(False)
    assert same_w and same_p
    assert bits_w < bits_p, (bits_w, bits_p)


@pytest.mark.parametrize("name", sorted(WP.SESSIONS))
def test_session_matches_pinned_jax_stream(name):
    got = WP.encode(t_top, name, device="cpu")
    assert got == WP.PINS[name]
    if WP.SESSIONS[name][1].get("weightp"):
        assert any(w and w.get("luma", (64, 0)) != (64, 0) for w in got[2])


def test_weighted_hme_takes_coarse_mvs():
    """The weighted pan's HME session: blocks take HME's coarse MV, found
    on the weighted half-resolution reference (the pan is past the fine
    search's +-16)."""
    from flagship_pins import coarse_mvs_counted
    with coarse_mvs_counted() as count:
        got = WP.encode(t_top, "qt_ippp_weightp_hme", device="cpu")
    assert got == WP.PINS["qt_ippp_weightp_hme"]
    assert int(count["taken"]) > 0


def test_weightp_changes_the_quadtree_p_stream():
    """The weighted quadtree P frame keeps its ME winner (no merge
    candidates): its stream differs from the session without weightp."""
    assert WP.PINS["qt_ippp_weightp"][0] != \
        WP.PINS["qt_ippp_no_weightp"][0]


def test_library_at_medium_matches_pinned_jax_stream():
    """param_default_preset("medium"), x265's default, over the ramped
    clip: weighted P anchors, SAO, AQ 2, cuTree, b-adapt 2."""
    with WP.weights_recorded(t_top.VideoEncoderSession) as weights:
        got = PP.run_api(t_api, "medium", device="cpu")
    assert got == PP.API_MEDIUM_PIN
    assert weights == PP.WEIGHTS["api_medium"]


def test_cli_default_on_a_416x240_fade_matches_pinned_jax_stream(tmp_path):
    """x265's default command line over bench.py's clip fading by 6 a
    frame at 416x240 (104 CTUs): the weighted P anchor at distance 2."""
    from x265_yuuki_asuna_tpu_torch import cli as t_cli
    assert WP.run_cli_fade(t_cli.main, str(tmp_path), device="cpu") == \
        WP.CLI_FADE_PIN


def test_weighted_cli_pins_carry_a_luma_weight():
    """The pinned weighted command lines (held stream for stream in
    tests/test_torch_cli_api.py) chose a luma weight that is not the
    identity; the stream md5 covers their pred_weight_tables."""
    for name in ("medium", "veryfast", "api_medium"):
        assert any(w and w.get("luma", (64, 0)) != (64, 0)
                   for w in PP.WEIGHTS[name]), name


# ---------------------------------------------------------------------------
# slow: the pins from the live JAX package; gpu: the streams on the card
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(WP.SESSIONS) + [
    "api_medium", "medium", "veryfast", "cli_fade"])
def test_pins_recomputed_from_the_jax_package(name, tmp_path):
    """Where the pins come from: the JAX sessions, library and command
    line with their weights recorded (minutes each on the CPU)."""
    if name in WP.SESSIONS:
        assert WP.encode(j_top, name) == WP.PINS[name]
        return
    if name == "cli_fade":
        from x265_yuuki_asuna_tpu import cli as j_cli
        assert WP.run_cli_fade(j_cli.main, str(tmp_path)) == WP.CLI_FADE_PIN
        return
    with WP.weights_recorded(j_top.VideoEncoderSession) as weights:
        if name == "api_medium":
            from x265_yuuki_asuna_tpu import api as j_api
            assert PP.run_api(j_api, "medium") == PP.API_MEDIUM_PIN
        else:
            from x265_yuuki_asuna_tpu import cli as j_cli
            assert PP.run_cli(j_cli.main, name, str(tmp_path)) == \
                PP.CLI_PINS[name]
    assert weights == PP.WEIGHTS[name]


@pytest.mark.gpu
def test_golden_ippp_weightp_on_the_card():
    _need_card()
    assert _golden_weightp("cuda")[0] == _manifest("ippp_weightp")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WP.SESSIONS))
def test_session_pin_on_the_card(name):
    _need_card()
    assert WP.encode(t_top, name, device="cuda") == WP.PINS[name]


@pytest.mark.gpu
def test_library_at_medium_on_the_card():
    _need_card()
    assert PP.run_api(t_api, "medium", device="cuda") == PP.API_MEDIUM_PIN
