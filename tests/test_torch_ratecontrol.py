"""The port's rate control against the JAX package's, with no session
(CPU, host arithmetic only): RateControl driven through the same seeded
frames in every mode (every QP and every state attribute equal after
every frame, `==`), vbv_overshoot, StatsWriter's bytes, TwoPassRC on a
JAX-written x265-format stats file and on a JSON one, and the HRD
writers (the SPS with hrd_parameters, buffering_period, pic_timing)."""
import dataclasses
import json
import os

import numpy as np
import pytest

from x265_yuuki_asuna_tpu.bitstream import headers as j_hdr
from x265_yuuki_asuna_tpu.bitstream import sei as j_sei
from x265_yuuki_asuna_tpu.models import ratecontrol as j_rc
from x265_yuuki_asuna_tpu.models.lookahead import Lookahead as JLookahead
from x265_yuuki_asuna_tpu_torch.bitstream import headers as t_hdr
from x265_yuuki_asuna_tpu_torch.bitstream import sei as t_sei
from x265_yuuki_asuna_tpu_torch.models import ratecontrol as t_rc
from x265_yuuki_asuna_tpu_torch.models.lookahead import Lookahead

BASE = dict(width=416, height=240, fps=25.0)
# (mode keywords); the VBV cases' buffers bind on the frames below
CASES = {
    "cqp": dict(mode="cqp", qp=30),
    "crf20": dict(mode="crf", crf=20.0),
    "crf28": dict(mode="crf", crf=28.0),
    "crf40": dict(mode="crf", crf=40.0),
    "abr300": dict(mode="abr", bitrate_kbps=300),
    "abr1500": dict(mode="abr", bitrate_kbps=1500),
    "crf28_vbv": dict(mode="crf", crf=28.0, vbv_maxrate_kbps=400,
                      vbv_bufsize_kbps=300),
    "abr300_vbv": dict(mode="abr", bitrate_kbps=300, vbv_maxrate_kbps=300,
                       vbv_bufsize_kbps=200),
    "cqp_vbv": dict(mode="cqp", qp=24, vbv_maxrate_kbps=400,
                    vbv_bufsize_kbps=250),
    "crf28_qp_range": dict(mode="crf", crf=28.0, qp_min=26, qp_max=33),
}


def _frames(n=56, seed=12):
    """(is_intra, lookahead cost or None, future costs or None, size
    factor) per frame: an I frame every 15 frames and on a few random
    ones, costs from a heavy-tailed draw (float32-rounded sums, as the
    lookahead gives them), sometimes missing."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        intra = i % 15 == 0 or rng.random() < 0.06
        cost = float(np.float32(rng.lognormal(11.5 if intra else 10.0, 0.7)))
        if rng.random() < 0.15:
            cost = None
        fut = None
        if rng.random() < 0.8:
            fut = [float(np.float32(c))
                   for c in rng.lognormal(10.0, 0.6, rng.integers(0, 11))]
        out.append((intra, cost, fut, float(rng.uniform(0.6, 1.5))))
    return out


def _bits(qp: int, intra: bool, factor: float) -> int:
    """A coded size that falls as the QP rises (halving per 6)."""
    return int(factor * (60000 if intra else 14000) * 2.0 ** ((30 - qp) / 6))


def _state(rc) -> dict:
    st = {k: v for k, v in vars(rc).items() if k not in ("cfg", "pred")}
    st["cfg"] = dataclasses.asdict(rc.cfg)
    st["pred"] = {t: vars(p) for t, p in rc.pred.items()}
    return st


def _drive(rc, frames, types=True):
    """QPs of rc over frames, closed loop; the states after each frame."""
    qps, states = [], []
    for i, (intra, cost, fut, factor) in enumerate(frames):
        qp = rc.frame_qp(intra, lookahead_cost=cost, future_costs=fut)
        st = ("I" if intra else "PB"[i % 2]) if types else None
        rc.frame_done(qp, _bits(qp, intra, factor), slice_type=st)
        qps.append(qp)
        states.append(_state(rc))
    return qps, states


@pytest.mark.parametrize("name", sorted(CASES))
def test_rate_control_matches_jax(name):
    kw = dict(BASE, **CASES[name])
    frames = _frames()
    jq, js = _drive(j_rc.RateControl(j_rc.RCConfig(**kw)), frames)
    tq, ts = _drive(t_rc.RateControl(t_rc.RCConfig(**kw)), frames)
    assert tq == jq
    for i, (a, b) in enumerate(zip(ts, js)):
        assert a == b, i
        # Python floats and ints only: no numpy scalar in the state
        assert all(type(v) in (int, float, bool, list, dict, str)
                   for v in a.values()), i
    if "vbv" in name:      # the buffer binds: the QPs differ without it
        free = {k: v for k, v in kw.items() if not k.startswith("vbv")}
        fq, _ = _drive(t_rc.RateControl(t_rc.RCConfig(**free)), frames)
        assert fq != tq
        assert "buffer_fill" in ts[-1]
    if name == "crf28_qp_range":
        assert min(tq) == 26 and max(tq) == 33
    if name.startswith(("crf", "abr")):
        assert "la_blur" in ts[-1] and "_last_rceq" in ts[-1]
    if name == "cqp":      # the I frames finer by the ipFactor offset
        assert set(tq) == {27, 30}


def test_lookahead_costs_past_2_24_give_the_jax_qps():
    """Costs the float32 pack rounds: on 768x512 frames of 2x2-pixel
    black / white noise the lookahead's frame sums pass 2^24, so their
    float32 values are rounded integers. The port's lookahead gives the
    JAX lookahead's values, and the IPPP CRF + VBV QPs (the session's
    frame_qp calls with them: the IDR's intra cost, then each P frame's
    inter cost with the next frames' as the planned window) are the JAX
    ones."""
    w, h, rng = 768, 512, np.random.default_rng(21)
    frames = [(rng.integers(0, 2, (h // 2, w // 2)) * 255).astype(np.uint8)
              .repeat(2, 0).repeat(2, 1) for _ in range(4)]
    jla, tla = JLookahead(w, h), Lookahead(w, h, "cpu")
    costs = []
    for y in frames:
        j, t = jla.push(y), tla.push(y)
        assert t == j and type(t[0]) is float
        exact = int(tla.last_detail["icost"].astype(np.int64).sum())
        costs.append((t[0], t[1], exact))
    assert max(c[0] for c in costs) > 2 ** 24
    assert any(c[0] != c[2] for c in costs)      # the cast rounded
    kw = dict(width=w, height=h, fps=25.0, mode="crf", crf=27.0,
              vbv_maxrate_kbps=12000, vbv_bufsize_kbps=6000)
    qps = []
    for m in (j_rc, t_rc):
        rc, got = m.RateControl(m.RCConfig(**kw)), []
        for i, (ic, pc, _) in enumerate(costs):
            qp = rc.frame_qp(i == 0, lookahead_cost=ic if i == 0 else pc,
                             future_costs=[c[1] for c in costs[i + 1:]])
            rc.frame_done(qp, _bits(qp, i == 0, 9.0), "I" if i == 0 else "P")
            got.append((qp, _state(rc)))
        qps.append(got)
    assert qps[1] == qps[0]


def test_rate_control_without_slice_types_matches_jax():
    """frame_done without a slice type updates the P predictor, as the
    reference's CRA path calls it."""
    kw = dict(BASE, mode="crf", crf=26.0, vbv_maxrate_kbps=500,
              vbv_bufsize_kbps=400)
    frames = _frames(40, seed=3)
    jq, js = _drive(j_rc.RateControl(j_rc.RCConfig(**kw)), frames, False)
    tq, ts = _drive(t_rc.RateControl(t_rc.RCConfig(**kw)), frames, False)
    assert (tq, ts) == (jq, js)


@pytest.mark.parametrize("mode", ["cqp", "abr"])
def test_vbv_overshoot_matches_jax(mode):
    kw = dict(BASE, mode=mode, bitrate_kbps=300, vbv_maxrate_kbps=300,
              vbv_bufsize_kbps=200)
    rcs = [m.RateControl(m.RCConfig(**kw)) for m in (j_rc, t_rc)]
    frames = _frames(12, seed=5)
    for intra, cost, fut, factor in frames:
        qps = [rc.frame_qp(intra, cost, fut) for rc in rcs]
        assert qps[0] == qps[1]
        for bits in (0, 900, 12000, 181000, 10 ** 7):
            assert rcs[1].vbv_overshoot(bits) == rcs[0].vbv_overshoot(bits)
        for rc in rcs:
            rc.frame_done(qps[0], _bits(qps[0], intra, factor * 3),
                          "I" if intra else "P")
    assert rcs[1].vbv_overshoot(10 ** 6) > 1.08
    free = t_rc.RateControl(t_rc.RCConfig(**dict(BASE, mode=mode,
                                                 bitrate_kbps=300)))
    assert free.vbv_overshoot(10 ** 9) == 0.0


def _records(n=9, seed=8, rows=3, cols=4):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        t = "I" if i % 5 == 0 else "Pb"[i % 2]
        co = None
        if t != "b" and i != 3:
            co = (rng.integers(-6 * 256, 256, rows * cols) / 256.0
                  + rng.choice([0.0, 1 / 512], rows * cols)).tolist()
        recs.append((t, int(rng.integers(18, 45)),
                     int(rng.integers(200, 90000)),
                     float(rng.uniform(1e3, 1e6)), co))
    return recs


def _write_stats(mod, path, recs, opts="input-res=64x48 fps=25/1"):
    w = mod.StatsWriter(path, options=opts)
    for t, qp, bits, cost, co in recs:
        w.add(t, qp, bits, cost, cuoff=co)
    w.close()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_stats_writer_bytes_match_jax(tmp_path):
    recs = _records()
    jp, tp = str(tmp_path / "j.log"), str(tmp_path / "t.log")
    _write_stats(j_rc, jp, recs)
    _write_stats(t_rc, tp, recs)
    assert _read(tp) == _read(jp)
    assert _read(tp + ".cutree") == _read(jp + ".cutree")
    assert _read(tp).startswith(b"#options: input-res=64x48")
    # without offsets there is no sidecar
    _write_stats(t_rc, str(tmp_path / "n.log"),
                 [r[:4] + (None,) for r in recs])
    assert not os.path.exists(str(tmp_path / "n.log.cutree"))


def _drive_two_pass(tp, n):
    qps, offs = [], []
    for i in range(n):
        qps.append(tp.frame_qp())
        off = tp.frame_cuoff()
        offs.append(None if off is None else off.tolist())
        tp.frame_done(float(1500 + 700 * (i % 4)))
    return qps, offs, tp.actual_bits, tp.expected_so_far


@pytest.mark.parametrize("fmt", ["x265", "json"])
def test_two_pass_matches_jax(fmt, tmp_path):
    """TwoPassRC on a stats file the JAX package wrote (the x265 text with
    its sidecar) and on a JSON-lines file: the same records and pass-2
    QPs, the same QP sequence under fed-back bits (past the records' end
    too), the same pass-1 offsets; qp_min / qp_max clamp."""
    recs = _records()
    path = str(tmp_path / "p1.log")
    if fmt == "x265":
        _write_stats(j_rc, path, recs)
    else:
        with open(path, "w") as f:
            for t, qp, bits, cost, co in recs:
                r = {"type": t, "qp": qp, "bits": bits, "cost": cost}
                if co is not None:
                    r["cuoff"] = co
                f.write(json.dumps(r) + "\n")
    for kw in ({}, {"qp_min": 20, "qp_max": 30}):
        j = j_rc.TwoPassRC(path, 200, 25.0, **kw)
        t = t_rc.TwoPassRC(path, 200, 25.0, **kw)
        assert t.records == j.records
        assert any("cuoff" in r for r in t.records)
        got, want = _drive_two_pass(t, 11), _drive_two_pass(j, 11)
        assert got == want
        assert any(o is not None for o in got[1])
        if kw:
            assert min(got[0]) >= 20 and max(got[0]) <= 30


def test_two_pass_rejects_an_empty_file(tmp_path):
    path = str(tmp_path / "empty.log")
    with open(path, "w") as f:
        f.write("#options: none\n")
    with pytest.raises(ValueError, match="empty"):
        t_rc.TwoPassRC(path, 100, 25.0)


SPS_COMMON = dict(width=64, height=48, conf_win=(0, 0, 0, 0),
                  log2_min_cb=3, log2_diff_max_min_cb=2, log2_min_tb=2,
                  log2_diff_max_min_tb=3, strong_intra_smoothing=0,
                  max_dec_pic_buffering=2, timing_info=(1, 25))


@pytest.mark.parametrize("hrd", [(27_000_000, 27_000_000, 0),
                                 (400_000, 200_000, 0), (1, 1, 1),
                                 (1025, 1023, 0), None])
def test_hrd_sps_matches_jax(hrd):
    js = j_hdr.SPSInfo(**SPS_COMMON, hrd=hrd)
    ts = t_hdr.SPSInfo(**SPS_COMMON, hrd=hrd)
    assert t_hdr.write_sps(ts) == j_hdr.write_sps(js)
    if hrd is not None:
        assert t_hdr.hrd_units(ts) == j_hdr.hrd_units(js)


@pytest.mark.parametrize("args", [(81000,), (0,), (1 << 25, 5), (900, -3)])
def test_buffering_period_matches_jax(args):
    assert t_sei.buffering_period(*args) == j_sei.buffering_period(*args)
    assert t_sei.wrap_sei([t_sei.buffering_period(*args)]) == \
        j_sei.wrap_sei([j_sei.buffering_period(*args)])


@pytest.mark.parametrize("args", [(0, 0), (7, 2), (1 << 25, 1 << 24)])
def test_pic_timing_matches_jax(args):
    assert t_sei.pic_timing(*args) == j_sei.pic_timing(*args)
