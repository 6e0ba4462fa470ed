"""Strong scaling of the landmark-sharded window BA over ranks (the port's
tools/scaling_bench.py).

    python -m maveric_slam_tpu_torch.bench.scaling [--landmarks 65536] [--poses 8]
        [--iterations 4] [--out build/bench/scaling.md]

One problem (`build_problem`, the JAX tool's generator in numpy) solved by
`parallel/sharded_ba.py` over 1, 2 and 4 ranks, each a process started by
`parallel.mesh.spawn`: NCCL with one rank a card where there are as many
cards as ranks, else gloo with the ranks sharing the card. Per mesh size:
ms an iteration, the per-rank compute (one rank alone on L/n landmarks)
and the rest, collectives and the replicated reduced solve, the strong-
scaling efficiency T1 / (n Tn), landmarks/s and the final cost. Prints one
JSON line and writes the markdown report to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..backend import ba
from ..parallel import mesh as mesh_lib
from ..parallel import sharded_ba
from . import common

def build_problem(num_landmarks: int, num_poses: int = 8) -> ba.BAProblem:
    """tools/scaling_bench.py:28's window problem as numpy arrays: landmarks
    in a box ahead of a forward-moving camera, observed exactly, then moved
    by 0.05 m."""
    rng = np.random.default_rng(0)
    K = np.array([[370.0, 0.0, 320.0], [0.0, 370.0, 96.0], [0.0, 0.0, 1.0]], np.float32)
    X = np.stack([rng.uniform(-40, 40, num_landmarks), rng.uniform(-5, 5, num_landmarks),
                  rng.uniform(8, 80, num_landmarks)], axis=-1).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (num_poses, 3, 3)).copy()
    t = np.stack([np.array([0.0, 0.0, -0.8 * p], np.float32) for p in range(num_poses)])
    p_cam = np.einsum("pij,lj->lpi", R, X) + t[None]
    uv = np.stack([K[0, 0] * p_cam[..., 0] / p_cam[..., 2] + K[0, 2],
                   K[1, 1] * p_cam[..., 1] / p_cam[..., 2] + K[1, 2]], axis=-1).astype(np.float32)
    mask = p_cam[..., 2] > 1.0
    return ba.BAProblem(K=K, R=R, t=t, X=X + 0.05, uv=uv, mask=mask)


def _rank_solve(problem: ba.BAProblem, iterations: int, rounds: int, device: str):
    """One rank: a warm-up solve, then `rounds` timed solves; (seconds an
    iteration, the last solve's costs, the process group's backend)."""
    mesh = mesh_lib.make_mesh(device=device)
    shard = sharded_ba.shard_problem(problem, mesh)
    dev = mesh.device
    sharded_ba.sharded_bundle_adjust(shard, mesh, iterations=iterations)
    common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(rounds):
        _, costs = sharded_ba.sharded_bundle_adjust(shard, mesh, iterations=iterations)
        common.sync(dev)
    return (time.perf_counter() - t0) / rounds / iterations, costs.cpu().numpy(), mesh.backend


def time_mesh(problem: ba.BAProblem, ranks: int, iterations: int, rounds: int = 3,
              device: str = "cuda"):
    """(seconds an iteration, costs, backend) of the sharded solve over
    `ranks` spawned ranks (rank 0's figures; every rank waits on the same
    collectives)."""
    out = mesh_lib.spawn(_rank_solve, ranks, args=(problem, iterations, rounds, device), device=device)
    return out[0]


def sweep(device: str = "cuda", landmarks: int = 65536, poses: int = 8, iterations: int = 4,
          ranks=(1, 2, 4), rounds: int = 3) -> dict:
    problem = build_problem(landmarks, poses)
    rows, t1 = [], None
    for n in ranks:
        per_iter, costs, backend = time_mesh(problem, n, iterations, rounds, device)
        comp_iter = per_iter if n == 1 else time_mesh(build_problem(landmarks // n, poses), 1,
                                                      iterations, rounds, device)[0]
        t1 = per_iter if t1 is None else t1
        common.check(bool(np.isfinite(costs).all()) and costs[-1] < costs[0],
                     f"{n} ranks: costs {costs.tolist()} do not fall")
        rows.append({"ranks": n, "backend": backend, "ms_per_iteration": per_iter * 1e3,
                     "compute_ms": comp_iter * 1e3, "comm_ms": (per_iter - comp_iter) * 1e3,
                     "efficiency": t1 / (n * per_iter), "landmarks_per_s": landmarks / per_iter,
                     "final_cost": float(costs[-1])})
    return {"workload": f"sharded window BA, {landmarks} landmarks x {poses} poses, "
                        f"{iterations} iterations",
            "rows": rows, "device": common.device_info(torch.device(device))}


def render_markdown(report: dict) -> str:
    dev = report["device"]
    lines = [
        "# Sharded window BA over ranks (maveric_slam_tpu_torch.bench.scaling)",
        "",
        f"Workload: {report['workload']}. Device: {dev['name']}, power limit {dev['power_limit']}, "
        f"{dev['count']} card(s).",
        "",
        "| ranks | backend | ms/iter | compute ms | comm+solve ms | strong-scaling eff. | landmarks/s |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in report["rows"]:
        lines.append(f"| {r['ranks']} | {r['backend']} | {r['ms_per_iteration']:.3f} "
                     f"| {r['compute_ms']:.3f} | {r['comm_ms']:.3f} | {r['efficiency']:.3f} "
                     f"| {r['landmarks_per_s'] / 1e6:.3f}M |")
    lines += [
        "",
        "Compute is one rank alone on L/n landmarks (the same solve, no peer); the rest of an",
        "iteration (the difference as measured, negative when the one-rank solve took longer) is",
        "the collectives (three all-reduces an iteration) and the replicated reduced solve. Ranks",
        "on one card share it over gloo, which stages every collective through the host: such a",
        "row measures what sharing costs, not scaling.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--landmarks", type=int, default=65536)
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(common.OUT_DIR, "scaling.md"))
    args = ap.parse_args(argv)
    common.require_cuda("bench.scaling")
    report = sweep("cuda", args.landmarks, args.poses, args.iterations)
    for r in report["rows"]:
        print(f"ranks={r['ranks']} ({r['backend']}): {r['ms_per_iteration']:.3f} ms/iter (compute "
              f"{r['compute_ms']:.3f} + comm {r['comm_ms']:.3f}), eff={r['efficiency']:.3f}, "
              f"{r['landmarks_per_s'] / 1e6:.3f}M landmarks/s", flush=True)
    print(json.dumps(report), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(render_markdown(report))
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
