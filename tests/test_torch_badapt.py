"""The lookahead's b-adapt path and the flagship session of the port
against the JAX package's (CPU, exact).

The lookahead at 96x160: pair_cost, bidir_cost and the trellis's
badapt_path_costs for K = 1..4 (float64 costs compared with ==), and the
histogram scene cut's flag on every frame, against the JAX Lookahead,
which compiles in seconds.

The sessions at 160x96 over tests/flagship_pins.py's CLIP, 12 frames: a
slow pan, a new scene panning 6 pixels a frame from frame 3 (the P
anchors of full mini-GOPs then sit 24 pixels away, past the +-16 fine
search: HME's range), and a brightness inversion from frame 9 (the
histogram cut). The flagship
session is bench.py's constructor (HME, b-adapt 2, CRF 28, AQ 2, cuTree,
deblock, SAO, sign hiding, recon_out=False); then with b_adapt=1, with
the histogram scene cut (keyint 20, so that keyint_min = 2 lets the cut
through), and with the rc-lookahead window (rc_lookahead=3). b-adapt 2
closes the first mini-GOP after 2 frames and keeps the next one at 4.
The JAX sessions take minutes to compile on the CPU, so the tier-1 tests
hold the port's streams to the JAX md5s pinned there, with each frame's
(POC, type, QP) in coding order; the slow test recomputes them from the
live JAX sessions (one set of compiled programs shared by the four)."""
import hashlib

import numpy as np
import pytest
import torch

from flagship_pins import (H, PINS, SESSIONS, W, clip,
                           coarse_mvs_counted)
from x265_yuuki_asuna_tpu.models import lookahead as j_la
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import lookahead as t_la
from x265_yuuki_asuna_tpu_torch.profile_1080p import FLAGSHIP

torch.set_num_threads(2)


def encode(top, name: str, setup=None, **extra):
    """(md5, [(poc, type, qp)], results, session) of the session `name` of
    the encoder_top module `top` over CLIP; setup(session) runs first."""
    s = top.VideoEncoderSession(W, H, **dict(FLAGSHIP, **SESSIONS[name]),
                                **extra)
    if setup is not None:
        setup(s)
    res = []
    for f in clip():
        res += s.push_frame(*f)
    res += s.flush()
    md5 = hashlib.md5(s.headers() + b"".join(r.nals for r in res)) \
        .hexdigest()
    return md5, [(r.poc, r.frame_type, r.qp) for r in res], res, s


def minigops(order) -> list:
    """The mini-GOP lengths of a coding order: each anchor's POC distance
    from the one before (0 at an IDR)."""
    anchors = [poc for poc, t, _ in order if t in "IP"]
    return [b - a if b else 0 for a, b in zip(anchors, anchors[1:])]


def fixed_order(order, bframes: int = 3) -> list:
    """(POC, type) in coding order of b_adapt=0 at the same IDRs: fixed
    mini-GOPs of bframes + 1 frames, the last one cut by the next IDR or
    the end."""
    out, gop = [], []

    def close():
        if not gop:
            return
        base, k = gop[0] - 1, len(gop)
        out.append((base + k, "P"))
        m = (k - 1) // 2 if k >= 3 else None
        if m is not None:
            out.append((base + 1 + m, "B"))
        out.extend((base + 1 + i, "b") for i in range(k - 1) if i != m)
        gop.clear()

    # display index of each coded frame: POCs restart at each IDR
    idr_at, disp = [], []
    for poc, t, _ in order:
        if t == "I":
            idr_at.append(len(disp) and max(disp) + 1)
        disp.append(idr_at[-1] + poc)
    n = max(disp) + 1
    for d in range(n):
        if d in idr_at:
            close()
            out.append((0, "I"))
            base = d
        else:
            gop.append(d - base)
            if len(gop) == bframes + 1:
                close()
    close()
    return out


# ---------------------------------------------------------------------------
# the lookahead (the JAX Lookahead compiles in seconds)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lookaheads():
    """Both lookaheads (histogram cut on) after every CLIP frame: the
    per-frame (icost, pcost, scenecut) and the lowres planes."""
    jl = j_la.Lookahead(W, H, hist_scenecut=True)
    tl = t_la.Lookahead(W, H, "cpu", hist_scenecut=True)
    pushed, jlows, tlows = [], [], []
    for y, _, _ in clip():
        pushed.append((jl.push(y), tl.push(y)))
        jlows.append(jl.prev_lowres)
        tlows.append(tl.prev_lowres)
    return jl, tl, pushed, jlows, tlows


def test_histogram_scenecut_matches_jax(lookaheads):
    pushed = lookaheads[2]
    assert [t for _, t in pushed] == [j for j, _ in pushed]
    cuts = [i for i, (j, _) in enumerate(pushed) if j[2]]
    assert cuts == [9]                    # the brightness inversion only


def test_pair_and_bidir_costs_match_jax(lookaheads):
    jl, tl, _, jlows, tlows = lookaheads
    for r, c in ((0, 1), (0, 2), (2, 6), (8, 9)):
        assert tl.pair_cost(tlows[r], tlows[c]) == \
            jl.pair_cost(jlows[r], jlows[c])
    for r0, r1, c in ((0, 2, 1), (2, 6, 4), (6, 8, 7)):
        assert tl.bidir_cost(tlows[r0], tlows[r1], tlows[c]) == \
            jl.bidir_cost(jlows[r0], jlows[r1], jlows[c])


@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_badapt_path_costs_match_jax(lookaheads, K):
    jl, tl, _, jlows, tlows = lookaheads
    for a in (0, 2):                      # the anchor before each scene
        want = jl.badapt_path_costs(jlows[a], jlows[a + 1:a + 1 + K])
        got = tl.badapt_path_costs(tlows[a], tlows[a + 1:a + 1 + K])
        assert got.dtype == np.float64 and np.array_equal(got, want), K


def test_histogram_cut_waits_for_keyint_min():
    """The clip of the reference's failing
    test_hist_scenecut.py::test_hist_scenecut_triggers_idr on the port's
    uniform IPPP session: the histogram rule fires at the cut (frame 3),
    and the keyframeMin guard suppresses it at keyint 100 (keyint_min 10,
    the reference's test expects an IDR there) and lets it through at
    keyint 20 (keyint_min 2), as in the reference (ROADMAP Queue 3)."""
    rng = np.random.default_rng(12)
    dark = rng.integers(0, 40, (48, 64)).astype(np.uint8)
    bright = rng.integers(200, 256, (48, 64)).astype(np.uint8)
    u = np.full((24, 32), 128, np.uint8)
    frames = [(dark, u, u)] * 3 + [(bright, u, u)] * 2
    types = {}
    for keyint in (100, 20):
        s = t_top.VideoEncoderSession(64, 48, qp=32, keyint=keyint,
                                      hash_sei=False, hist_scenecut=True,
                                      device="cpu")
        types[keyint] = [s.encode_frame(*f).frame_type for f in frames]
    assert types == {100: ["I", "P", "P", "P", "P"],
                     20: ["I", "P", "P", "I", "P"]}


# ---------------------------------------------------------------------------
# the sessions
# ---------------------------------------------------------------------------

_MV_KEYS = ("mvx", "mvy", "mv4x", "mv4y", "mv8x", "mv8y", "mv1x", "mv1y",
            "mv41x", "mv41y", "mv81x", "mv81y")


def _record_mvs(s):
    """Wrap the session's inter program to record the largest |MV|
    (quarter pels) of each frame it codes, under s.max_mv."""
    run, s.max_mv = s.inter_encoder.encode_frame, []

    def call(*args, **kw):
        out = run(*args, **kw)
        s.max_mv.append(max(int(abs(out[key]).max()) for key in _MV_KEYS
                            if out.get(key) is not None))
        return out
    s.inter_encoder.encode_frame = call


@pytest.fixture(scope="module")
def port_sessions():
    out = {}
    for name in SESSIONS:
        with coarse_mvs_counted() as count:
            out[name] = encode(t_top, name, setup=_record_mvs, device="cpu")
        out[name][3].coarse_mvs = count
    return out


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_matches_pinned_jax_stream(port_sessions, name):
    md5, order, res, s = port_sessions[name]
    assert (md5, order) == PINS[name]
    # recon_out=False with neither the metrics nor the hash SEI: the
    # recon never leaves the device
    assert all(r.recon is None and r.psnr_y == 0.0 for r in res)
    assert [(p, t) for p, t, _ in order] != fixed_order(order)
    gops = minigops(order)
    if name != "b_adapt1":
        # the trellis closed a mini-GOP early (not at an IDR or the end)
        # and kept one at bframes + 1
        assert 4 in gops and any(0 < g < 4 for g in gops[:-1]), gops
        assert s.stage_ms["b_adapt"] > 0
    if name == "hist_scenecut":
        assert sum(t == "I" for _, t, _ in order) == 2
    assert s.coarse_mvs["blocks"] and int(s.coarse_mvs["taken"])
    # MVs past +-16 pels (HME's) went through the merge stage and the
    # writer's MVD, and the stream is still the JAX session's
    assert max(s.max_mv) > 64


def test_fixed_order_is_the_b_adapt0_session():
    """fixed_order (the b_adapt=0 reference of the test above) is what a
    b_adapt=0 session codes: checked on the pinned flagship order's IDRs
    with a short clip of the port."""
    s = t_top.VideoEncoderSession(64, 64, device="cpu", max_depth=2,
                                  bframes=3, b_adapt=0, keyint=4,
                                  hash_sei=False, quality_metrics=False)
    res = []
    for f in clip(7, 64, 64):
        res += s.push_frame(*f)
    res += s.flush()
    order = [(r.poc, r.frame_type, r.qp) for r in res]
    assert [(p, t) for p, t, _ in order] == fixed_order(order)
    assert fixed_order(PINS["flagship"][1])[:3] == [(0, "I"), (4, "P"),
                                                    (2, "B")]


@pytest.mark.slow
def test_pins_recomputed_from_the_jax_sessions():
    """Where PINS come from: the JAX sessions, which share the first
    one's compiled programs (the same encoder configuration), and which
    the port's sessions equal NAL for NAL."""
    from x265_yuuki_asuna_tpu.models import encoder_top as j_top
    first = {}

    def share(s):
        if not first:
            first["s"] = s
            return
        f = first["s"]
        s.inter_encoder, s.bi_encoder = f.inter_encoder, f.bi_encoder
        s.intra_sess.frame_encoder = f.intra_sess.frame_encoder

    for name in sorted(SESSIONS):
        md5, order, jres, _ = encode(j_top, name, setup=share)
        assert (md5, order) == PINS[name], name
        tres = encode(t_top, name, device="cpu")[2]
        assert [r.nals for r in tres] == [r.nals for r in jres], name


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_pinned_session_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    md5, order, res, _ = encode(t_top, name)
    assert (md5, order) == PINS[name]
    assert all(r.recon is None for r in res)
