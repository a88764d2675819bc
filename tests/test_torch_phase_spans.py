"""The port's phase spans (CPU): the quadtree P and B programs record their
phases ("me", "decide", "commit", "fetch") and filters through the
session's one span call, encoder_top._timed, looked up at every call; a
wrapper set on that attribute, as the benchmark's traced run sets it, sees
each phase directly inside its program stage ("inter" / "inter_b"). The
program stage plus its filters is the program call's wall; every frame's
span totals (FrameResult.stage_ms, under its display index) add up to the
session's; the CLI's level-2 CSV gives each frame its own."""
import time

import pytest
import torch

import preset_pins as PP
from golden_corpus import clip
from x265_yuuki_asuna_tpu_torch import cli as t_cli
from x265_yuuki_asuna_tpu_torch.models import encoder_top as t_top
from x265_yuuki_asuna_tpu_torch.models import qt_common as QT

torch.set_num_threads(2)

PHASES = ("me", "decide", "commit", "fetch")
PROGRAMS = ("inter", "inter_b")
# depth 1 on the device DPB (the filter chain: "filters"); depth 2 under
# weightp, the host filters ("deblock", "sao"); intra in B, so that B
# frames commit too
KW = {1: dict(max_depth=1),
      2: dict(max_depth=2, weightp=True)}


def _wrapped(monkeypatch):
    """Spans (stage, t0, t1, ms) of every _timed call, recorded by a
    wrapper on the module attribute, as the benchmark's tracer records
    them."""
    spans = []
    timed = t_top._timed

    def spanned(stage_ms, stage, fn, *a, **k):
        t0 = time.perf_counter()
        try:
            return timed(stage_ms, stage, fn, *a, **k)
        finally:
            t1 = time.perf_counter()
            spans.append((stage, t0, t1, (t1 - t0) * 1e3))
    monkeypatch.setattr(t_top, "_timed", spanned)
    return spans


@pytest.fixture(scope="module", params=sorted(KW))
def coded(request):
    """(depth, session, results, spans) of an IDR, a P anchor and one B
    frame (bframes=1, fixed mini-GOPs) at 64x48 with the deblock, SAO
    and intra in B."""
    mp = pytest.MonkeyPatch()
    try:
        spans = _wrapped(mp)
        s = t_top.VideoEncoderSession(
            64, 48, qp=30, keyint=50, bframes=1, b_adapt=0, deblock=True,
            sao=True, b_intra=True, device="cpu", **KW[request.param])
        res = []
        for f in clip(64, 48, n=3):
            res += s.push_frame(*f)
    finally:
        mp.undo()
    return request.param, s, res, spans


def _inside(outer, inner):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_wrapper_on_timed_sees_the_phases_inside_the_programs(coded):
    _, _, res, spans = coded
    assert [(r.frame_type, r.display) for r in res] == \
        [("I", 0), ("P", 2), ("b", 1)]
    for program in PROGRAMS:
        outer = [sp for sp in spans if sp[0] == program]
        assert len(outer) == 1
        inner = [sp for sp in spans if _inside(outer[0], sp)
                 and sp is not outer[0]]
        assert set(PHASES) <= {sp[0] for sp in inner}
    # flat: no phase span holds another span
    for sp in spans:
        if sp[0] in PHASES:
            assert not [o for o in spans if o is not sp and _inside(sp, o)]


def test_program_stage_and_filters_are_the_call_wall(coded):
    depth, s, res, spans = coded
    filters = ("filters",) if depth == 1 else ("deblock", "sao")
    for fr, program in zip(res[1:], PROGRAMS):
        wall = next(sp[3] for sp in spans if sp[0] == program)
        assert all(fr.stage_ms.get(k, 0.0) > 0 for k in filters)
        assert fr.stage_ms[program] + sum(fr.stage_ms[k] for k in filters) \
            == pytest.approx(wall, abs=0.5)
        # the phases lie inside the program stage
        assert sum(fr.stage_ms[k] for k in PHASES) <= fr.stage_ms[program]


def test_frame_totals_add_up_to_the_session(coded):
    _, s, res, _ = coded
    stages = set(s.stage_ms) - set(t_top.SESSION_STAGES)
    assert set(PHASES) | set(PROGRAMS) | {"intra", "serialize"} <= stages
    for k in stages:
        assert sum(r.stage_ms.get(k, 0.0) for r in res) == \
            pytest.approx(s.stage_ms[k], rel=1e-9, abs=1e-9)
    assert not any(k in r.stage_ms for r in res
                   for k in t_top.SESSION_STAGES)


def test_a_program_built_outside_a_session_records_no_span(monkeypatch):
    spans = _wrapped(monkeypatch)
    enc = t_top.InterQTEncoder(64, 64, "cpu", deblock=True, max_depth=1)
    assert enc.span is QT.no_span
    y, u, v = (torch.full(s, 128, dtype=torch.uint8).numpy()
               for s in ((64, 64), (32, 32), (32, 32)))
    out = enc.encode_frame(y, u, v, y, u, v, 30)
    assert out["split"].shape == (2, 2) and spans == []


def test_csv_level2_gives_each_b_session_frame_its_own_timing(
        tmp_path, monkeypatch):
    """--bframes 3 over 9 frames: every P and B line has its own program
    ms (before, a mini-GOP's first line carried the whole mini-GOP), and
    each column sums to the session's totals within the rounding."""
    made = []
    configure = t_cli.configure
    monkeypatch.setattr(t_cli, "configure",
                        lambda *a, **k: made.append(configure(*a, **k))
                        or made[-1])
    src, dst = str(tmp_path / "c.y4m"), str(tmp_path / "c.hevc")
    csv = str(tmp_path / "c.csv")
    PP.write_clip(src, 9)
    assert t_cli.main([src, "-o", dst, "--bframes", "3", "--csv", csv,
                       "--csv-log-level", "2"], device="cpu") == 0
    with open(csv) as f:
        rows = [r.split(", ") for r in f.read().splitlines()[1:-1]]
    assert len(rows) == 9
    types = [r[1] for r in rows]
    assert {"P", "B"} <= set(t.upper() for t in types)
    device = [float(r[-4]) for r in rows]
    assert all(d > 0 for d, t in zip(device, types) if t in "PBb")
    st = made[0].stage_ms
    for col, keys in ((-4, ("intra", "inter", "inter_b", "filters")),
                      (-3, ("deblock",)), (-2, ("sao",)),
                      (-1, ("serialize",))):
        assert sum(float(r[col]) for r in rows) == pytest.approx(
            sum(st[k] for k in keys), abs=0.05 * len(rows) + 1e-9)
