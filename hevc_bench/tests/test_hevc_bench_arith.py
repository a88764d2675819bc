"""The metrics' arithmetic on made-up readings: fps, kbps, the union of
device intervals and the idle share, launches, K1's bound against the
figures PERF.md records, and the reference's plain motion search."""

import pytest
import torch

from hevc_bench import harness, k1, reference
from hevc_bench.trace import Tracer, busy_ns, union

H100 = k1.peaks("NVIDIA H100 80GB HBM3")


def ctx(**kw):
    base = dict(frames=[], stage_ms={}, window_s=1.0, setup_s=1.0,
                fps_num=25, fps_den=1, tracer=None, k1_traced=[],
                peaks=H100)
    return harness.Ctx(**dict(base, **kw))


def frames(bits):
    return [dict(type="b", display=i, bits=b, psnr_y=40.0 + i)
            for i, b in enumerate(bits)]


def test_fps_counts_every_frame_over_the_whole_window():
    c = ctx(frames=frames([1000] * 5), window_s=20.0)
    assert harness.reader("fps").read(c) == pytest.approx(0.25)
    assert harness.reader("fps").read(ctx()) is None


def test_kbps_is_bits_at_the_frame_rate():
    c = ctx(frames=frames([100_000, 50_000, 30_000, 20_000]))
    # 200,000 bits over 4 frames at 25 frames/s: 1,250 kbit/s
    assert harness.reader("kbps").read(c) == pytest.approx(1250.0)


def test_psnr_is_the_mean_and_needs_every_frame():
    c = ctx(frames=frames([1, 1, 1]))
    assert harness.reader("psnr_y_db").read(c) == pytest.approx(41.0)
    c.frames[1]["psnr_y"] = None
    assert harness.reader("psnr_y_db").read(c) is None


def test_stage_readers_sum_their_stages_per_frame():
    c = ctx(frames=frames([1] * 4),
            stage_ms={"inter": 1000.0, "inter_b": 3000.0, "rc": 4.0,
                      "qp_map": 8.0, "weights": 4.0, "lookahead": 20.0,
                      "b_adapt": 20.0, "serialize": 40.0})
    read = lambda n: harness.reader(n).read(c)
    assert read("inter_ms_per_frame") == pytest.approx(1000.0)
    assert read("host_rc_ms_per_frame") == pytest.approx(4.0)
    assert read("lookahead_ms_per_frame") == pytest.approx(10.0)
    assert read("serialize_ms_per_frame") == pytest.approx(10.0)
    assert read("filters_ms_per_frame") is None


def test_union_of_intervals():
    assert union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    assert busy_ns([(0, 10), (2, 3), (10, 12), (20, 21)]) == 13
    assert busy_ns([]) == 0


def fake_tracer():
    t = Tracer()
    # a frame of 1,000 ns wall: two overlapping kernels (100-300,
    # 200-400), a copy (600-700) and K1 (800-900): busy 500 ns; and a
    # frame of 1,000 ns with one kernel of 500: idle 50% over both
    t.calls.append(dict(label="B", t0_ns=0, t1_ns=1000, spans=[
        ("inter_b", 0, 700), ("serialize", 700, 1000)], events=[
        (100, 300, "gemm"), (200, 400, "elementwise"),
        (600, 700, "Memcpy DtoH (Device -> Pageable)"),
        (800, 900, "void k1_kernel<unsigned char, 8, false>")]))
    t.calls.append(dict(label="P", t0_ns=2000, t1_ns=3000, spans=[],
                        events=[(2000, 2500, "gemm")]))
    return t


def test_idle_share_launches_and_breakdown():
    t = fake_tracer()
    c = ctx(tracer=t)
    assert t.busy_s() == pytest.approx(1000e-9)
    assert t.window_s() == pytest.approx(2000e-9)
    assert harness.reader("device_idle_pct").read(c) == \
        pytest.approx(50.0)
    # three kernels in B (the copy is no launch), one in P
    assert harness.reader("launches_per_frame").read(c) == 2.0
    ops = dict(t.top_device_ops())
    assert ops["gemm"] == pytest.approx(700e-9)
    gaps = dict(t.idle_gaps())
    # B: 0-100 and 400-600 in inter_b, 700-800 and 900-1000 in
    # serialize; P: 2500-3000 outside every stage
    assert gaps["B:inter_b"] == pytest.approx(300e-9)
    assert gaps["B:serialize"] == pytest.approx(200e-9)
    assert gaps["P:outside the stages"] == pytest.approx(500e-9)


@pytest.mark.parametrize("H,W,n,ms", [
    (1080, 1920, 8, 0.0338),      # PERF.md: n=8 1080x1920, operations
    (1088, 1920, 16, 0.0340),     # n=16 1088x1920
    (1088, 1920, 32, 0.0340),     # n=32
    (544, 960, 8, 0.0085),        # the lookahead's n=8
    (536, 960, 8, 0.00838)])      # the lookahead's n=8 at cu 8
def test_k1_fused_bound_matches_perf_md(H, W, n, ms):
    assert k1.bound_s(H100, H, W, 16, 1, n) * 1e3 == \
        pytest.approx(ms, abs=6e-5)


def test_k1_surface_bounds_match_perf_md():
    assert k1.bound_s(H100, 1088, 1920, 16, 1) * 1e3 == \
        pytest.approx(0.0437, abs=1e-4)       # bytes
    assert k1.bound_s(H100, 1088, 1920, 24, 1) * 1e3 == \
        pytest.approx(0.0948, abs=1e-4)
    assert k1.bound_s(H100, 544, 960, 16, 1, None, 4) * 1e3 == \
        pytest.approx(0.0428, abs=1e-4)
    assert k1.bound_s(H100, 1088, 1920, 16, 2, 16) * 1e3 == \
        pytest.approx(0.1360, abs=1e-4)       # int16 planes


def test_k1_roofline_reader():
    t = fake_tracer()
    launch = dict(entry="sad_sweep_best", H=1088, W=1920, R=16, elem=1,
                  n=16, base=8)
    c = ctx(tracer=t, k1_traced=[launch])
    want = 100 * k1.bound_s(H100, 1088, 1920, 16, 1, 16) / 100e-9
    assert harness.reader("k1_roofline_pct").read(c) == pytest.approx(want)
    assert harness.reader("k1_roofline_pct").read(ctx(tracer=t)) is None


def brute(ref, src, R, n, lam):
    H, W = src.shape
    out = []
    for by in range(0, H, n):
        for bx in range(0, W, n):
            best = None
            for dy in range(-R, R + 1):
                for dx in range(-R, R + 1):
                    ys = (torch.arange(n) + by + dy).clamp(0, H - 1)
                    xs = (torch.arange(n) + bx + dx).clamp(0, W - 1)
                    sad = int((ref[ys][:, xs].int()
                               - src[by:by + n, bx:bx + n].int())
                              .abs().sum())
                    cost = sad + lam * (abs(dx) + abs(dy))
                    if best is None or cost < best[0]:
                        best = (cost, dx, dy, sad)
            out.append(best[1:])
    return out


@pytest.mark.parametrize("n,lam", [(8, 1), (16, 4)])
def test_plain_search_equals_brute_force(n, lam):
    g = torch.Generator().manual_seed(3)
    src = torch.randint(0, 256, (16, 32), generator=g, dtype=torch.uint8)
    ref = torch.roll(src, (1, -2), (0, 1))
    ref[0, 0] = 0
    R = 3
    mvx, mvy, sad = reference.best_moves(
        reference.sad_surface(ref, src, R, 8), n, R, lam)
    got = list(zip(mvx.tolist(), mvy.tolist(), sad.tolist()))
    assert got == brute(ref, src, R, n, lam)


class _FakeK1:
    """me_sad's three entry points, answering with zeros: on flat planes
    and a lambda over 0 the plain search's answers."""

    @staticmethod
    def sad_sweep_best(ref, src, srange, n, lam):
        nb = (src.shape[0] // n) * (src.shape[1] // n)
        return tuple(torch.zeros(nb, dtype=torch.int32) for _ in range(3))

    @staticmethod
    def _surface(ref, src, srange, base):
        d = 2 * srange + 1
        return torch.zeros((d, d, src.shape[0] // base,
                            src.shape[1] // base), dtype=torch.int32)

    def sad_block8_sweep(self, ref, src, srange):
        return self._surface(ref, src, srange, 8)

    def sad_block4_sweep(self, ref, src, srange):
        return self._surface(ref, src, srange, 4)


@pytest.mark.parametrize("fault", [None, "k1_answer"])
def test_k1_recorder_keeps_a_seeded_sample_and_the_faulted_launch(fault):
    plane = torch.zeros((16, 16), dtype=torch.uint8)

    def kept(seed):
        mod = _FakeK1()
        rec = k1.Recorder(mod, seed, fault)
        rec.install()
        mod.sad_block8_sweep(plane, plane, 1)      # before the window
        rec.keep = True
        for j in range(3 * k1.KEPT):
            mod.sad_sweep_best(plane, plane, 1, 8, j + 1)
        rec.keep = False
        rec.uninstall()
        assert len(rec.launches) == 3 * k1.KEPT + 1
        assert rec.in_window == 3 * k1.KEPT
        return rec.kept()

    a, b = kept(7), kept(7)
    assert [k["lam"] for k in a] == [k["lam"] for k in b]
    assert len(a) == k1.KEPT + (fault is not None)
    assert len({k["lam"] for k in a}) == len(a)
    if fault:
        assert a[0]["lam"] == 1 and k1.check(a[:1], "cpu") == 1
        a = a[1:]
    assert max(k["lam"] for k in a) > k1.KEPT    # not just the first KEPT
    assert k1.check(a, "cpu") == 0


def test_tracer_is_complete_once_each_wrapped_call_is_traced():
    t = Tracer()
    t.wrap(lambda: None, "P")
    t.wrap(lambda: None, "B")
    assert not t.complete()
    t._done.update({"P", "B"})
    assert t.complete()
