"""Whole runs at a small size on the CPU (the port's plain versions): the
result line's keys, the JAX check by whole top-level names, the refusal
without a card, and every fault a cell can have turning `correct` false.
The card tests (-m gpu) make the same runs with the CUDA kernels."""

import json
import subprocess
import sys

import pytest
import torch

from hevc_bench import harness

SIZE = (256, 160)
# a seed at which every planted fault changes what is coded: at 256x160 a
# stale reference can lose to intra prediction everywhere, and the stream
# is then right
SEED = 2 ** 31 + 21
CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["x265_yuuki_asuna_tpu_torch", "x265_yuuki_asuna_tpu_torch.cli",
             "jaxtyping", "flaxen", "numpy", "jax", "jax.numpy",
             "jaxlib.xla_client", "flax.linen", "x265_yuuki_asuna_tpu",
             "x265_yuuki_asuna_tpu.ops.me"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "x265_yuuki_asuna_tpu", "x265_yuuki_asuna_tpu.ops.me"]


def test_the_port_passes_the_check():
    import x265_yuuki_asuna_tpu_torch.cli  # noqa: F401
    assert "x265_yuuki_asuna_tpu_torch" in sys.modules
    assert not any(m.startswith("x265_yuuki_asuna_tpu_torch")
                   for m in harness.forbidden_modules())


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, json, torch; torch.set_num_threads(2); "
            "from hevc_bench import harness; "
            f"o = harness.run_cell({CELLS[-1]!r}, {SEED}, 0.5, False, "
            f"device='cpu', size={SIZE}); "
            "print(json.dumps([o['correct'], harness.forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == [True, []]


def test_without_a_card_no_result_and_a_nonzero_exit():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "-m", "hevc_bench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
def test_the_line_and_a_sound_run(cell):
    out = harness.run_cell(cell, SEED, 0.5, False, device="cpu", size=SIZE)
    assert list(out)[:5] == LINE_KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    assert set(out["metrics"]) == {
        m["name"] for m in harness.metrics_of(bench, cell, "end_to_end")}
    assert all(v["limit"] == 0 and v["value"] == 0
               for v in out["checks"].values())
    json.dumps(out)


# each fault the cells can have: the DPB's reference left unchanged,
# half of a K1 batch's blocks left out, a bit of a slice altered where it
# is written (the control), one K1 answer altered where it is made
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", harness.FAULTS)
def test_each_fault_makes_the_run_incorrect(cell, fault):
    out = harness.run_cell(cell, SEED, 0.5, False, device="cpu", size=SIZE,
                           fault=fault)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [None, "flipped_bit"])
def test_on_the_card_sound_and_control(card, fault):
    out = harness.run_cell(CELLS[0], SEED, 0.5, False, size=(416, 240),
                           fault=fault)
    assert out["correct"] is (fault is None)
    assert out["device"]["platform"] == "gpu"
