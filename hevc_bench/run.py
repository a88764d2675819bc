"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 -m hevc_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

run from the root of a checkout. Prints progress on standard error, then
as the last line of standard output one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `checks` (each number compared, with its limit),
which also close standard error. Exits with 2, and prints no result, where
there is no CUDA card; with 4 where a module of JAX or of the JAX package
was loaded. `--fault <name>` plants one of harness.FAULTS in the run:
the control runs (`flipped_bit`) and the benchmark's tests use them.

Run as a program, it first starts itself again with PYTHONHASHSEED=0 in
its environment, so that every run iterates sets and dicts of strings in
one order.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hevc_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hevc_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    ap.add_argument("--fault", choices=harness.FAULTS, default=None)
    args = ap.parse_args(argv)
    wl = harness.load_cell(args.workload)[0]
    harness.use_cache_dirs()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"hevc_bench: the cell needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), fault=args.fault)
    bad = harness.forbidden_modules()
    if out is None or bad:
        print(f"hevc_bench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable,
                  [sys.executable, "-m", "hevc_bench.run"] + sys.argv[1:],
                  dict(os.environ, PYTHONHASHSEED="0"))
    sys.exit(main())
