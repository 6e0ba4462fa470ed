"""Every workload of bench_all.py on the card (the port's bench_all.py).

    python -m maveric_slam_tpu_torch.bench.suite [--skip-multi-rank] [--out build/bench/suite.json]

Six measurements, one JSON line each, and the report written to --out
(never to BENCH_ALL.json, which holds the JAX package's TPU figures):

1. pairwise: `pairwise_pose` (golden extractor, NN match, RANSAC at
   K = M = 1000) on orbit frames 0 -> 1, 64 seeded generators in turn;
   pairs/s. Checked: inliers and the rotation error against the exact pose.
2. tracking: headline.py's single stream.
3. the integrated engine: `SlamSystem` (fetch_delay 3, BA every 4, loop
   closure on) over 80 content-unique frames that ping-pong over the first
   10 orbit frames. bench_all.py cycles KITTI's 10 frames, so its engine
   revisits them; the ping-pong revisits them without a jump, and past the
   LCD's 50-frame gap (from frame ~56) its keyframes close loops: the
   timed run must verify and accept at least one, so the figure holds loop
   verification and the pose graph. A first pass, its last 8 frames under
   torch.profiler (device busy ms a frame), then a fresh engine timed
   under a `Timer.recording()` of its spans (utils/profiling.py). Its ms a
   frame is split into the fetch wait (`slam.fetch_wait`: the host blocked
   on a frame's device-to-host copy), the host bookkeeping (the rest of
   `slam.consume`, loop verification and the pose graph included, also
   given alone: `slam.loop`) and the rest of the wall (the step's dispatch
   and its own host work). Its checks carry the engine's counters
   (`SlamSystem.counters`).
4. window BA: dense `bundle_adjust` at L = 1024, P = 8, 10 iterations
   (scaling.build_problem); `relin.between_residual_jacobians` on 256
   factors; the factor-list solver and the dense one with 35% of the
   observations kept. Checked: costs finite and falling.
5. BoW + LCD: `assign_words` on frame 0's 100 features; `lcd.query` against
   4096 stored frames (random 64-word rows, seed 7), the query a stored
   row. Checked: the query finds its own frame.
6. multi-rank BA: scaling.time_mesh at 65536 x 8, 4 iterations, 4 ranks:
   NCCL with a card each where there are 4 cards, else gloo ranks sharing
   the card (labelled so).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import slam as slam_lib
from ..backend import ba, relin, sparse_ba
from ..frontend import extractor, pairwise
from ..loopclosure import lcd, vocab as vocab_lib
from ..ops import lie
from ..utils import profiling
from ..utils.trajectory import relative_from_poses
from . import common, headline, scaling

PAIRWISE_ITERS, ENGINE_FRAMES, BA_ITERS, LCD_FRAMES = 30, 80, 20, 4096
ENGINE_IMAGES = 10  # the engine's stream ping-pongs over this many orbit frames
TRACED_FRAMES = 8  # the engine's frames under torch.profiler: two BA windows
# pairwise: orbit frames 0 -> 1 with at least this many inliers and a
# rotation error below this (deg). The port measures ~0.12 deg there at
# 192x640 (chip_smoke.py's [pairwise]) and 95 inliers at 96x320; random
# matches put ~1% of ~1000 points within 3 px of an epipolar line.
PAIRWISE_MIN_INLIERS, PAIRWISE_ROT_DEG = 50, 1.0


def bench_pairwise(params, orbit, device, iters=PAIRWISE_ITERS):
    cfg = common.config(orbit.h, orbit.w)
    img0, img1 = (torch.from_numpy(f).to(device) for f in orbit.frames([0, 1]))
    gens = [torch.Generator(device=device).manual_seed(k) for k in range(64)]
    k = iter(range(1 << 30))
    results = []

    def call():
        out = pairwise.pairwise_pose(params, img0, img1, cfg, generator=gens[next(k) % 64])
        results.append(out)
        return out

    sec = common.median_call_s(call, device, iters)
    R_gt = relative_from_poses(orbit.poses[:2])[0][0]
    last = results[-iters:]
    inl = torch.stack([r.num_inliers for r in last]).cpu().numpy()
    rot = common.rot_err_deg(torch.stack([r.R for r in last]).cpu().numpy(), R_gt)
    checks = {"min_inliers": int(inl.min()), "max_rot_err_deg": float(rot.max())}
    common.check(checks["min_inliers"] >= PAIRWISE_MIN_INLIERS
                 and checks["max_rot_err_deg"] < PAIRWISE_ROT_DEG, f"pairwise: {checks}")
    return {"metric": "pairwise_pnp_pairs_per_s", "value": 1.0 / sec, "unit": "pairs/s",
            "ms_per_pair": sec * 1e3, "checks": checks}


def bench_tracking(params, orbit, device, rounds=headline.ROUNDS):
    single = headline.measure_single(params, orbit, device, rounds)
    return {"metric": "tracked_frames_per_s_chip", "value": single["fps"], "unit": "frames/s",
            "ms_per_frame": single["ms_per_frame"], "checks": single["checks"],
            "protocol": "headline.py's single stream"}


def engine_stream(orbit, n_frames=ENGINE_FRAMES) -> list:
    """The engine's frames: the first ENGINE_IMAGES orbit frames
    ping-ponged, each made content-unique."""
    idx = [common.ping_pong(f, ENGINE_IMAGES) for f in range(n_frames)]
    return common.unique_frames(orbit.frames(idx), 11)


def bench_slam(params, orbit, device, n_frames=ENGINE_FRAMES):
    cfg = common.config(orbit.h, orbit.w)
    stream = engine_stream(orbit, n_frames)

    def engine():
        return slam_lib.SlamSystem(params, cfg, ba_every=4, enable_loop_closure=True, fetch_delay=3,
                                   device=device)

    # First pass (allocator, cuBLAS and cuSOLVER handles, kernel loads); its
    # last frames, warm by then, under the profiler.
    first = engine()
    for f in stream[:-TRACED_FRAMES]:
        first.process(f)

    def tail():
        for f in stream[-TRACED_FRAMES:]:
            first.process(f)
        first.finish()

    busy, launches = common.device_busy_ms(tail, device)

    spans = profiling.Timer()

    def run_engine():
        s = engine()
        with spans.recording():
            for f in stream:
                s.process(f)
            s.finish()
        return s

    dt, s = common.wall_s(run_engine, device)
    valid = np.array([st["valid"] for st in s.stats])
    inl = np.array([st["inliers"] for st in s.stats])
    checks = {"valid_share": float(valid.mean()), "median_inliers": float(np.median(inl)),
              "loop_verifications": s.verifications, "loop_closures": len(s.loop_events),
              "counters": dict(s.counters)}
    common.check(checks["valid_share"] >= headline.CHECKS["valid_share"]
                 and checks["median_inliers"] >= headline.CHECKS["median_inliers"]
                 and checks["loop_closures"] > 0, f"engine: {checks}")
    ms = dt / n_frames * 1e3
    tot = spans.totals
    wait_s, consume_s = tot["slam.fetch_wait"], tot["slam.consume"]
    return {
        "metric": "slam_fps_integrated", "value": n_frames / dt,
        "unit": "frames/s (full engine: track + BA + LCD + loop verification + pose graph)",
        "ms_per_frame": ms,
        "slam_device_busy_ms": None if busy is None else busy / TRACED_FRAMES,
        "slam_kernels_per_frame": None if launches is None else launches / TRACED_FRAMES,
        "slam_host_ms": (consume_s - wait_s) / n_frames * 1e3,
        "slam_loop_ms": tot["slam.loop"] / n_frames * 1e3,
        "slam_fetch_wait_ms": wait_s / n_frames * 1e3,
        "slam_other_ms": ms - consume_s / n_frames * 1e3,
        "checks": checks,
        "decomposition": "the timed run's spans (utils/profiling.py, host time): fetch_wait = "
                         "slam.fetch_wait, blocking on a frame's device-to-host copy; host = "
                         "slam.consume less slam.fetch_wait (slam.track_table, slam.ba.problem, "
                         "slam.ba.dispatch, slam.ba.apply, slam.lcd, slam.loop); loop = "
                         "slam.loop, a candidate's verification (slam.loop.verify), its edge "
                         "and the BA apply and pose graph (slam.pose_graph) it forces (within "
                         "host); other = the wall outside slam.consume "
                         "(tracker.step and slam.words: the step's dispatch and its host work); "
                         "device busy from torch.profiler over the first pass's last "
                         f"{TRACED_FRAMES} frames (two BA windows)",
    }


def _ba_check(label, costs):
    costs = np.asarray(costs)
    common.check(bool(np.isfinite(costs).all()) and costs[-1] < costs[0],
                 f"{label}: costs {costs.tolist()} do not fall")


def bench_window_ba(device, landmarks=1024, poses=8, iters=10, calls=BA_ITERS, relin_calls=50):
    problem = ba.BAProblem(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                             for a in scaling.build_problem(landmarks, poses)))
    _ba_check("dense", ba.bundle_adjust(problem, iterations=iters)[1].cost.cpu())
    sec = common.median_call_s(lambda: ba.bundle_adjust(problem, iterations=iters), device, calls)

    rng = np.random.default_rng(3)
    f = 256
    w = torch.from_numpy((rng.normal(size=(f, 3)) * 0.1).astype(np.float32)).to(device)
    R_i, R_j = lie.so3_exp(w), lie.so3_exp(-w * 0.5)
    t_i = torch.from_numpy(rng.normal(size=(f, 3)).astype(np.float32)).to(device)
    t_j = t_i + 0.1
    r, J_i, _ = relin.between_residual_jacobians(R_i, t_i, R_j, t_j, R_i, t_i)
    common.check(bool(torch.isfinite(r).all() and torch.isfinite(J_i).all()), "relin: not finite")
    relin_sec = common.median_call_s(
        lambda: relin.between_residual_jacobians(R_i, t_i, R_j, t_j, R_i, t_i), device, relin_calls)

    keep = np.random.default_rng(5).random((landmarks, poses)) < 0.35
    keep[:, :2] = True  # solvable
    dense35 = problem._replace(mask=problem.mask & torch.from_numpy(keep).to(device))
    sparse = sparse_ba.from_dense(dense35)
    _ba_check("factor list at 35%", sparse_ba.bundle_adjust(sparse, iterations=iters)[1].cpu())
    _ba_check("dense at 35%", ba.bundle_adjust(dense35, iterations=iters)[1].cost.cpu())
    sparse_sec = common.median_call_s(lambda: sparse_ba.bundle_adjust(sparse, iterations=iters),
                                      device, calls)
    dense35_sec = common.median_call_s(lambda: ba.bundle_adjust(dense35, iterations=iters), device, calls)
    return {
        "metric": "window_ba_ms_per_iteration", "value": sec * 1e3 / iters,
        "unit": f"ms/iter at {landmarks}x{poses}",
        "landmark_iters_per_s": landmarks * iters / sec,
        "relin_factors_per_s": f / relin_sec,
        "dense_ms_per_iter_35pct": dense35_sec * 1e3 / iters,
        "sparse_ms_per_iter_35pct": sparse_sec * 1e3 / iters,
    }


def bench_bow_lcd(params, orbit, device, cap=LCD_FRAMES, iters=50):
    cfg = common.config(orbit.h, orbit.w)
    vocab = vocab_lib.load_reference_vocabulary(device=device)
    feats = extractor.extract_quantized(params, torch.from_numpy(orbit.frames([0])[0]).to(device), cfg)
    n_top = cfg.loop.top_n_features
    desc = feats.desc_q.reshape(-1, 256)[feats.top.cells.long()][:n_top]
    mask = feats.top.mask[:n_top]
    words = vocab_lib.assign_words(desc, feats.desc_scale, mask, vocab).word_id
    common.check(int((words[mask] >= 0).sum()) == int(mask.sum()) > 0, "assign_words: unassigned")
    assign_sec = common.median_call_s(
        lambda: vocab_lib.assign_words(desc, feats.desc_scale, mask, vocab), device, iters)

    db = lcd.create_database(cap, cfg.loop.vocab_size, device=device)
    rows = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.loop.vocab_size, (cap, 64), dtype=np.int64).astype(np.int32)).to(device)
    for f in range(cap):
        db = lcd.add_frame(db, rows[f], f)
    q = rows[cap // 2]
    res = lcd.query(db, q, cap, min_frame_gap=50, min_score=0.05)
    common.check(int(res.best_frame) == cap // 2, f"lcd.query found frame {int(res.best_frame)}, "
                 f"not its own {cap // 2}")
    query_sec = common.median_call_s(lambda: lcd.query(db, q, cap, min_frame_gap=50, min_score=0.05),
                                     device, iters)
    return {"metric": "lcd_queries_per_s", "value": 1.0 / query_sec,
            "unit": f"queries/s vs {cap} stored frames", "assign_us_per_frame": assign_sec * 1e6,
            "query_us": query_sec * 1e6}


def bench_multi_rank_ba(device, landmarks=65536, poses=8, iterations=4, ranks=4, rounds=3):
    dev = str(device)
    per_iter, costs, backend = scaling.time_mesh(scaling.build_problem(landmarks, poses), ranks,
                                                 iterations, rounds, dev)
    _ba_check("multi-rank BA", costs)
    where = ("one card each" if backend == "nccl" else
             "sharing one card" if dev != "cpu" else "on the CPU")
    return {"metric": "multi_rank_ba_ms_per_iteration", "value": per_iter * 1e3,
            "unit": f"ms/iter, {landmarks}x{poses} over {ranks} ranks ({backend}, {where})"}


def run(device, h=common.H, w=common.W, multi_rank=True, pairwise_iters=PAIRWISE_ITERS,
        rounds=headline.ROUNDS, engine_frames=ENGINE_FRAMES, ba_calls=BA_ITERS, relin_calls=50,
        lcd_frames=LCD_FRAMES, lcd_calls=50, multi_rank_landmarks=65536, ba_landmarks=1024) -> dict:
    device = torch.device(device)
    params = headline.load(device)
    orbit = common.Orbit(h, w)
    results = [
        bench_pairwise(params, orbit, device, pairwise_iters),
        bench_tracking(params, orbit, device, rounds),
        bench_slam(params, orbit, device, engine_frames),
        bench_window_ba(device, landmarks=ba_landmarks, calls=ba_calls, relin_calls=relin_calls),
        bench_bow_lcd(params, orbit, device, lcd_frames, lcd_calls),
    ]
    if multi_rank:
        results.append(bench_multi_rank_ba(device, multi_rank_landmarks))
    return {"device": common.device_info(device), "size": f"{h}x{w}", "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-multi-rank", action="store_true")
    ap.add_argument("--out", default=os.path.join(common.OUT_DIR, "suite.json"))
    args = ap.parse_args(argv)
    device = common.require_cuda("bench.suite")
    report = run(device, multi_rank=not args.skip_multi_rank)
    for r in report["results"]:
        print(json.dumps({**r, "device": report["device"]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
