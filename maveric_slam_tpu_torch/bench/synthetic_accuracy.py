"""The engine's accuracy on the exact-ground-truth closing orbit (the
port's tools/synthetic_accuracy.py), over seeds.

    python -m maveric_slam_tpu_torch.bench.synthetic_accuracy [--seeds N]
        [--out build/bench/synthetic_accuracy.json] [--device cpu]

The full engine (tracking, window BA every 4 frames, loop closure, the pose
graph) and its odometry alone over tests/test_synthetic_accuracy.py's
125-frame closing orbit (96x320, fx = 400, 96 frames a turn, ~1.3 turns).
Seed s seeds the engine (its tracker's generator s, its loop verification's
s + 1). Per seed, SYNTH_ACCURACY.json's keys; over the seeds, the
distribution of the two ATEs. Accuracy is not a device metric: the CPU
gives it too, when asked with --device cpu; without it the run needs a
card. Writes to --out, never to SYNTH_ACCURACY.json (the JAX package's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..models import superpoint as sp
from ..slam import SlamSystem
from ..utils import evaluation
from . import common

H, W, FRAMES = 96, 320, 125


def run_seed(params, cfg, frames, gt, seed: int, device) -> dict:
    slam = SlamSystem(params, cfg, seed=seed, ba_every=4, enable_loop_closure=True, device=device)
    for f in frames:
        slam.process(f)
    traj, odo = slam.trajectory(), slam.odometry_trajectory()
    slam.close()
    full, odom = evaluation.ate(traj, gt), evaluation.ate(odo, gt)
    return {
        "seed": seed,
        "ate_rmse_full_engine_m": full["ate_rmse"],
        "ate_rmse_odometry_only_m": odom["ate_rmse"],
        "improvement": odom["ate_rmse"] / full["ate_rmse"],
        "rpe_rot_deg_mean": evaluation.rpe(traj, gt)["rpe_rot_deg_mean"],
        "valid_steps": sum(s["valid"] for s in slam.stats),
        "loop_closures": [{"frame": e.frame, "matched_frame": e.matched_frame,
                           "num_inliers": e.num_inliers} for e in slam.loop_events],
    }


def _spread(a) -> dict:
    a = np.asarray(a)
    return {"median": float(np.median(a)), "q25": float(np.percentile(a, 25)),
            "q75": float(np.percentile(a, 75)), "min": float(a.min()), "max": float(a.max())}


def run(device, seeds: int = 1, frames_n: int = FRAMES) -> dict:
    device = torch.device(device)
    cfg = common.config(H, W)
    orbit = common.Orbit(H, W)
    gt = np.stack([orbit.poses[k % orbit.n] for k in range(frames_n)])
    frames = orbit.frames(range(frames_n))
    params = sp.load_params(device=device)
    rows = []
    for seed in range(seeds):
        rows.append(run_seed(params, cfg, frames, gt, seed, device))
        print(json.dumps(rows[-1]), flush=True)
    full = [r["ate_rmse_full_engine_m"] for r in rows]
    odo = [r["ate_rmse_odometry_only_m"] for r in rows]
    return {
        "scenario": f"closing orbit, {frames_n} frames, exact rendered GT",
        "config": f"{H}x{W}, fx={common.focal(W):g}, ba_every=4, loop closure on",
        **{k: v for k, v in rows[0].items() if k != "seed"},
        "seeds": rows,
        "ate_rmse_full_engine_m_over_seeds": _spread(full),
        "ate_rmse_odometry_only_m_over_seeds": _spread(odo),
        "full_below_0.85_odometry": int(sum(f < 0.85 * o for f, o in zip(full, odo))),
        "device": common.device_info(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(common.OUT_DIR, "synthetic_accuracy.json"))
    ap.add_argument("--device", default=None, help="cpu to run there; the card otherwise")
    args = ap.parse_args(argv)
    device = torch.device(args.device) if args.device else common.require_cuda("bench.synthetic_accuracy")
    out = run(device, args.seeds)
    print(json.dumps({k: out[k] for k in ("ate_rmse_full_engine_m_over_seeds",
                                          "ate_rmse_odometry_only_m_over_seeds",
                                          "full_below_0.85_odometry", "device")}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
