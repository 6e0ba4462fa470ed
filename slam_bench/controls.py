"""The readings that the limits of `correct` are set from, and the planted
faults that the tests hold the comparison to.

    python3 slam_bench/controls.py --workload NAME --plant none --seeds 11 12 13 --seconds 8

runs the cell once for each seed in one process (set-up is paid once for
the kernels and the imports) and prints one JSON line a run with every
number compared. The control lowers each stage of the timed path to the
precision below the one the configuration states, against the same
reference: `--plant control_int4` cuts the net's int8 weights to int4
levels, `--plant control_tf32` switches TF32 on for the float32 products
of the geometry and the backend (the net's int8 products are exact in
TF32, so it cannot reach the net). The two run apart: with int4 weights
the tracker loses the scene and the backend gets nothing to solve. Each
fault of FAULTS plants that fault in the timed path. The controls and the
faults must come out not correct; the benchmark's own runs plant nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

INT4_STEP = 16  # an int8 weight w keeps round(w / 16) * 16: 16 levels in [-128, 112]


def int4_weights(path: Path) -> str:
    """The configuration's weights file with every int8 weight cut to int4
    levels, scales and biases kept; written once under `path`."""
    import numpy as np

    from slam_bench.reference.frozen.models import superpoint as rsp

    path.parent.mkdir(parents=True, exist_ok=True)
    raw = dict(np.load(rsp.DEFAULT_WEIGHTS))
    for name in rsp.LAYERS:
        w = raw[f"{name}_w"].astype(np.int32)
        raw[f"{name}_w"] = (np.clip(np.round(w / INT4_STEP), -8, 7) * INT4_STEP).astype(np.int8)
    np.savez(path, **raw)
    return str(path)


def plant_control_int4(port, ctx) -> None:
    ctx.weights = int4_weights(ROOT / "build" / "slam_bench" / "superpoint_int4.npz")


def plant_control_tf32(port, ctx) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def _wrap_steps(port, make):
    """Replaces the tracker's step entry points by `make(original)`."""
    for name in ("track_step", "track_step_batched"):
        setattr(port.tracker, name, make(getattr(port.tracker, name)))


def plant_state_unchanged(port, ctx) -> None:
    """A step that returns its state unchanged."""
    _wrap_steps(port, lambda fn: lambda params, state, images, cfg, *a: (state, fn(params, state, images, cfg, *a)[1]))


def _turned(R):
    """R turned by 1 degree about the camera's y axis."""
    import torch

    c, s = math.cos(math.radians(1.0)), math.sin(math.radians(1.0))
    return R @ torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], device=R.device)


def plant_answer_altered(port, ctx) -> None:
    """Each step's rotation turned by 1 degree where it is produced."""
    def make(fn):
        def step(params, state, images, cfg, *a):
            new, res = fn(params, state, images, cfg, *a)
            return new, res._replace(R=_turned(res.R))
        return step

    _wrap_steps(port, make)


def plant_one_slot_altered(port, ctx) -> None:
    """The rotation turned by 1 degree in one slot only: the first stream of
    a batched step, and every fourth step of a single stream (the engine's
    keyframes)."""
    import torch

    trk = port.tracker
    batched, single = trk.track_step_batched, trk.track_step
    calls = [0]

    def step_batched(params, state, images, cfg, *a):
        new, res = batched(params, state, images, cfg, *a)
        return new, res._replace(R=torch.cat([_turned(res.R[:1]), res.R[1:]]))

    def step(params, state, images, cfg, *a):
        new, res = single(params, state, images, cfg, *a)
        calls[0] += 1
        return new, (res._replace(R=_turned(res.R)) if calls[0] % 4 == 0 else res)

    trk.track_step_batched, trk.track_step = step_batched, step


def plant_ba_unchanged(port, ctx) -> None:
    """A window BA that returns its problem unchanged."""
    fn = port.ba.bundle_adjust
    port.ba.bundle_adjust = lambda problem, *a, **kw: (problem, fn(problem, *a, **kw)[1])


def plant_pg_unchanged(port, ctx) -> None:
    """A pose-graph solve that returns its graph unchanged."""
    fn = port.pose_graph.optimize
    port.pose_graph.optimize = lambda graph, *a, **kw: (graph, fn(graph, *a, **kw)[1])


def plant_half_batch(port, ctx) -> None:
    """Half of the streams left out: the first half is tracked and its
    results stand for the rest."""
    import torch

    trk = port.tracker
    fn = trk.track_step_batched

    def step(params, state, images, cfg, *a):
        h = images.shape[0] // 2
        sub = trk.TrackerState(*(f[:h] for f in state[:-1]), generator=state.generator[:h])
        new, res = fn(params, sub, images[:h], cfg, *a)
        full = trk.TrackerState(*(torch.cat([f, f]) for f in new[:-1]), generator=state.generator)
        return full, type(res)(*(torch.cat([f, f]) for f in res))

    trk.track_step_batched = step


PATCHED = (("tracker", "track_step"), ("tracker", "track_step_batched"), ("ba", "bundle_adjust"),
           ("pose_graph", "optimize"))


@contextlib.contextmanager
def restored(port):
    """Puts back every entry point that a plant may replace, so that the
    plants of successive runs in one process do not stack."""
    saved = [(getattr(port, m), n, getattr(getattr(port, m), n)) for m, n in PATCHED]
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


FAULTS = {"state_unchanged": plant_state_unchanged, "answer_altered": plant_answer_altered,
          "one_slot_altered": plant_one_slot_altered, "half_batch": plant_half_batch,
          "ba_unchanged": plant_ba_unchanged, "pg_unchanged": plant_pg_unchanged}
PLANTS = {"none": None, "control_int4": plant_control_int4, "control_tf32": plant_control_tf32,
          **FAULTS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the readings behind the limits of correct")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plant", choices=sorted(PLANTS), default="none")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from slam_bench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    res = harness.resolve(bench, args.workload, ROOT)
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.perf_counter()
        with restored(harness.port_modules()):
            out = harness.run_cell(res, seed, args.seconds, False, torch.device("cuda"), t0,
                                   plant=PLANTS[args.plant])
        line = {"workload": args.workload, "plant": args.plant, "seed": seed,
                "correct": out["correct"], "frames": out["frames"], "numbers": out["numbers"],
                "detail": out["detail"], "window": out["window"],
                "metrics": out["metrics"], "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
