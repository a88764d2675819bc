"""The content generator: the same frames for a seed, and a frame
structure (motion, cuts) that does not depend on the seed."""

import numpy as np
import pytest

from hevc_bench import harness
from hevc_bench.content import Content, derive_seed

W, H = 192, 128
SEEDS = (2 ** 31 + 7, 12345)


def mix(name):
    return harness.load_json(harness.HERE, "traffic", name + ".json")


def frames(name, seed, n, **over):
    m = dict(mix(name), **over)
    c = Content(m, W, H, seed, "cpu")
    return [c.frame(i) for i in range(n)]


@pytest.mark.parametrize("name", ["pan", "static", "cuts"])
def test_a_seed_repeats_exactly(name):
    a, b = frames(name, SEEDS[0], 3), frames(name, SEEDS[0], 3)
    for fa, fb in zip(a, b):
        for pa, pb in zip(fa, fb):
            assert pa.dtype == np.uint8 and np.array_equal(pa, pb)
    assert a[0][0].shape == (H, W) and a[0][1].shape == (H // 2, W // 2)
    c = frames(name, SEEDS[1], 1)[0]
    assert not np.array_equal(a[0][0], c[0])


def test_frame_i_alone_equals_frame_i_in_order():
    m = mix("pan")
    seq = frames("pan", SEEDS[0], 4)
    alone = Content(m, W, H, SEEDS[0], "cpu").frame(3)
    assert all(np.array_equal(p, q) for p, q in zip(alone, seq[3]))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_pan_moves_the_background_by_the_file_not_the_seed(seed):
    # without objects and noise, frame 1 is frame 0 moved by the pan
    f = frames("pan", seed, 2, objects=[], noise_sigma=0.0)
    px, py = mix("pan")["pan_px_per_frame"]
    assert np.array_equal(f[1][0][:H - py, :W - px], f[0][0][py:, px:])


@pytest.mark.parametrize("seed", SEEDS)
def test_cuts_sit_where_the_file_puts_them(seed):
    every = mix("cuts")["scene_cut_every"]
    f = frames("cuts", seed, every + 2)
    diff = [np.abs(f[i + 1][0].astype(int) - f[i][0]).mean()
            for i in range(every + 1)]
    cut = int(np.argmax(diff)) + 1
    assert cut == every
    assert max(diff[:every - 1] + diff[every:]) * 3 < diff[every - 1]


def test_static_moves_only_its_region():
    # at the deployment's size, without noise, only the moving region
    # (5% of the picture) changes from one frame to the next
    m = dict(mix("static"), noise_sigma=0.0)
    c = Content(m, 1920, 1080, SEEDS[0], "cpu")
    moved = (c.frame(0)[0] != c.frame(1)[0]).mean()
    assert 0.01 < moved <= 0.05 + 1e-9


def test_derive_seed_is_fixed_and_63_bit():
    assert derive_seed(5, 1, 2) == derive_seed(5, 1, 2)
    assert derive_seed(5, 1, 2) != derive_seed(5, 2, 1)
    assert 0 <= derive_seed(2 ** 40, 7) < 2 ** 63


def test_si_of_a_step_edge_and_ti_of_a_half_change():
    import torch
    from hevc_bench.characterise import si_frame, si_ti
    w, a = 34, 10.0
    step = torch.zeros((8, w))
    step[:, w // 2:] = a
    # the Sobel magnitude is 4a in the two columns beside the edge, 0 in
    # the other w - 4 of the w - 2 inner columns
    p = 2 / (w - 2)
    want_si = 4 * a * (p * (1 - p)) ** 0.5
    half = step.clone()
    half[:4] += 2.0                          # half the samples change by 2
    assert si_frame(step) == pytest.approx(want_si)
    out = si_ti([step, half])
    assert out["si_max"] == max(si_frame(step), si_frame(half))
    assert out["ti_max"] == pytest.approx(1.0)
    flat = si_ti([torch.arange(40.0).repeat(6, 1)] * 2)
    assert flat["si_max"] == pytest.approx(0.0, abs=1e-9)
    assert flat["ti_max"] == 0.0
