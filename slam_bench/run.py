"""Runs one cell of the benchmark once.

    python3 slam_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds BENCHMARK.json. Set-up (weights,
kernels, the scene, the warm-up), then a closed-loop window of S seconds,
then, with --trace 1, a span of the cell under torch.profiler, then the
comparison with the reference. The last line of standard output is one
JSON object: with --trace 0 the cell's end-to-end metrics, with --trace 1
its per-layer metrics. The numbers compared, each with its limit, are the
last lines of standard error and the last key of that object.

Exit codes: 0 a result; 2 bad arguments or a missing file; 3 no card, or
fewer cards than the cell asks for; 4 JAX or the JAX package loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One host thread for the CPU math libraries: the program's host path is a
# single Python thread, and idle pool threads spinning beside it on a
# shared host only add noise.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slam_bench import harness

    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        res = harness.resolve(bench, args.workload, ROOT)
    except (OSError, KeyError, ValueError) as e:
        print(f"slam_bench: {e}", file=sys.stderr)
        return 2

    import torch

    torch.set_num_threads(1)
    chips = int(res.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slam_bench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}: no result", file=sys.stderr)
        return 3
    try:
        import maveric_slam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"slam_bench: the system under test is missing ({e}): no result", file=sys.stderr)
        return 2

    out = harness.run_cell(res, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                           T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"slam_bench: forbidden modules loaded: {', '.join(found)}: no result", file=sys.stderr)
        return 4
    line = harness.result_line(out, torch.cuda.get_device_name(0), chips)
    print(json.dumps({"build_seconds": out["build_seconds"], "numbers": out["numbers"],
                      "detail": out["detail"], "window": out["window"]}), file=sys.stderr)
    for text in harness.comparison_lines(out["compared"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
