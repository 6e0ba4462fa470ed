"""How far the port's engine moves when only the order of the window BA's
sums changes: the spread behind the mesh-mode engine's trajectory bars.

    python tools/torch_mesh_spread.py [--scene test|chip] [--orders N] [--ranks R [R ...]]
        [--device cpu|cuda] [--verbose]
    torchrun --nproc-per-node N tools/torch_mesh_spread.py [--scene ...] [--device ...]

Runs `SlamSystem` (loop closure on, BA every 4, fetch_delay 0) on one
device, then again N times with the landmarks of every window BA problem
in another seeded order (`TrackTable.window_problem`'s live rows
permuted), then the mesh-mode engine over each R ranks given (gloo on
the CPU, or the ranks sharing the card; 0: none). The mesh engine sums the BA's reduced system
in R blocks, another order; a reordered single engine is the same
arithmetic moved the same way, with no mesh in it. Prints each run's
largest position gap to the first run (per frame with --verbose), the
RMSE between the two trajectories after a similarity alignment
(`evaluation.ate` of the run against the first run: the gap once the
monocular scale, which drifts along the chain, is taken out), its ATE
against the ground truth (chip scene), whether its odometry steps are
bitwise equal, its BA windows and loop closures.

Under torchrun (WORLD_SIZE set) each process is one rank of the mesh
engine instead, one card a rank over NCCL when there are enough cards; rank
0 first runs the engine alone on its card as the reference (the other ranks
wait for it in their first collective) and prints both, with the mesh
engine's wall, and the ranks' trajectories are checked bitwise equal.

- test: tests/test_torch_mesh_slam.py's scene, orbit frames 0-12 at 96x320
  with the JAX engine's noise (drawn with JAX on the CPU).
- chip: chip_smoke.py's [slam] scene (250 frames at 192x640, its noise),
  on the card by default.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_mesh_worker as worker  # noqa: E402
from maveric_slam_tpu_torch import tracks  # noqa: E402
from maveric_slam_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402


def _scene(name):
    """(config, frames, tracking noise, verification noise, ground truth)."""
    if name == "test":
        import test_torch_mesh_slam as tm

        frames, steps, verifications = tm.scene()
        return tm.TCFG, frames, steps, verifications, None
    import chip_smoke as smoke

    cfg = smoke._config()
    frames, gt, noises = smoke.slam_scene(cfg, {})
    # the verifications draw from each engine's own generator, seeded alike
    return cfg, frames, [tuple(g.numpy() for g in n) for n in noises], None, gt


def _permuted(seed):
    """TrackTable.window_problem with the live landmark rows in a seeded order."""
    rng = np.random.default_rng(seed)
    orig = tracks.TrackTable.window_problem

    def window_problem(self, *a, **k):
        uv, mask, tids = orig(self, *a, **k)
        live = np.nonzero(mask.any(1))[0]
        perm = np.arange(mask.shape[0])
        perm[live] = rng.permutation(live)
        return uv[perm], mask[perm], np.asarray(tids)[perm]
    return orig, window_problem


def _report(label, run, ref, gt, seconds, verbose):
    """Prints the run against the reference run; returns (max |dt|, aligned RMSE)."""
    from maveric_slam_tpu_torch.utils import evaluation

    d = np.abs(run["poses"][:, :3, 3] - ref["poses"][:, :3, 3]).max(-1)
    aligned = evaluation.ate(run["poses"], ref["poses"])["ate_rmse"]
    truth = "" if gt is None else f"; ATE {evaluation.ate(run['poses'], gt)['ate_rmse']:.4f} m"
    same_odo = all(np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0])
                   for a, b in zip(run["rel"], ref["rel"]))
    print(f"[spread] {label}: max |dt| {d.max():.6g} m (frame {int(d.argmax())}), aligned RMSE "
          f"{aligned:.6g} m{truth}; odometry {'bitwise equal' if same_odo else 'DIFFERS'}; "
          f"{len(run['windows'])} BA windows; loop closures {[e[:3] for e in run['loops']]}; "
          f"{seconds:.1f} s", flush=True)
    if verbose:
        print("[spread]   per frame: " + " ".join(f"{x:.3g}" for x in d), flush=True)
    return float(d.max()), float(aligned)


def _torchrun_rank(cfg, frames, steps, verifications, gt, device, verbose):
    import torch.distributed as dist

    mesh_lib.maybe_init_distributed(device)
    mesh = mesh_lib.make_mesh(device=device)
    ref = None
    if mesh.rank == 0:
        t0 = time.perf_counter()
        ref = worker.engine(cfg, frames, steps, verifications, device=mesh.device)
        _report(f"one device ({mesh.device})", ref, ref, gt, time.perf_counter() - t0, False)
    t0 = time.perf_counter()
    run = worker.engine(cfg, frames, steps, verifications, mesh=mesh)
    seconds = time.perf_counter() - t0
    mesh_lib.check_replicas(run["poses"], mesh, "the end of the run")  # raises if the ranks differ
    if mesh.rank == 0:
        _report(f"mesh of {mesh.size} over {mesh.backend}, rank 0 on {mesh.device}", run, ref, gt,
                seconds, verbose)
        print(f"[spread] mesh of {mesh.size}: ranks bitwise equal True; {len(frames) / seconds:.2f} "
              f"frames/s on rank 0 (engine construction included)", flush=True)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="test", choices=["test", "chip"])
    ap.add_argument("--orders", type=int, default=6)
    ap.add_argument("--ranks", type=int, nargs="+", default=[4])
    ap.add_argument("--device", default=None)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    device = args.device or ("cpu" if args.scene == "test" else "cuda")
    cfg, frames, steps, verifications, gt = _scene(args.scene)
    if device == "cpu":
        torch.set_num_threads(1)  # as the mesh tests' ranks
    if "WORLD_SIZE" in os.environ:
        _torchrun_rank(cfg, frames, steps, verifications, gt, device, args.verbose)
        return
    t0 = time.perf_counter()
    ref = worker.engine(cfg, frames, steps, verifications, device=device)
    _report("one device", ref, ref, gt, time.perf_counter() - t0, False)
    gaps = []
    for seed in range(args.orders):
        orig, permuted = _permuted(seed)
        tracks.TrackTable.window_problem = permuted
        try:
            t0 = time.perf_counter()
            run = worker.engine(cfg, frames, steps, verifications, device=device)
        finally:
            tracks.TrackTable.window_problem = orig
        gaps.append(_report(f"one device, landmark order {seed}", run, ref, gt,
                            time.perf_counter() - t0, args.verbose))
    if gaps:
        d, a = np.array(gaps).T
        print(f"[spread] reordered, over {len(gaps)} orders: max |dt| largest {d.max():.6g} m, median "
              f"{np.median(d):.6g} m; aligned RMSE largest {a.max():.6g} m, median "
              f"{np.median(a):.6g} m", flush=True)
    for ranks in (r for r in args.ranks if r):
        t0 = time.perf_counter()
        runs = mesh_lib.spawn(worker.mesh_engine, ranks,
                              args=(cfg, frames, steps, verifications, device),
                              device=device,
                              threads=1 if device == "cpu" else None, timeout_s=3000)
        _report(f"mesh of {ranks}", runs[0], ref, gt, time.perf_counter() - t0, args.verbose)
        print(f"[spread] mesh of {ranks}: ranks bitwise equal "
              f"{all(np.array_equal(r['poses'], runs[0]['poses']) for r in runs)}", flush=True)


if __name__ == "__main__":
    main()
