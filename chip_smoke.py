#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`maveric_slam_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py [--qconv]

(`--qconv`: the build and the qconv phase alone, then its profiler numbers.)
Phases, in order; any failure raises and exits non-zero:
  1. build the seven CUDA kernels from `maveric_slam_tpu_torch/csrc` (nvcc,
     all sources at once), print the build time and ptxas's resource lines,
     and check that the stem's and qconv's SASS hold tensor-core (IMMA)
     instructions;
  2. hold each kernel against its plain PyTorch version on the card, on
     inputs taken from the tracking step at 192x640 (stem bitwise at
     (1, 192, 640), (16, 192, 640), (2, 36, 44), (1, 6, 10) and on all-0/all-1
     images; detector C=1920 and at S=16 per stream, each stream alone
     equal to its row, plus ties across lane boundaries, cells without a
     keypoint, extremes, winners on the 8x8 border, Taylor degrees 1-12,
     one row, a ragged 6x10 grid and an unaligned view; match N=100 against
     C=1920 and at S=16 per stream, cells equal and scores bitwise, with
     each stream alone equal to its row, plus ties, windows clipped at the
     four grid edges by a shift and signed=False; nullspace n=9 at
     B=256/64/3, at the batched step's B=4096/1024/48 and on zero and
     rank-8 matrices, n=4 at B=100; svd3 at B=256/64/1, at the batched
     step's B=4096/1024/16, on degenerate matrices, repeated singular values
     and scales 1e-4 and 1e4, each matrix bitwise the same alone as in its
     batch), at the bars of ROADMAP.md; refine_pose at the step's S=1 and
     S=16 (N=100) against the plain version run in float64 (within four
     times the plain float32 version's own gap to it), num_used exact,
     each pose of the S=16 call bitwise equal to the S=1 call and a rerun
     bitwise equal; [qconv] the ten layers after the stem bitwise equal to
     the plain version at the net calls (1, 192, 640), (16, 192, 640) and
     (16, 376, 1240), on orbit activations and seeded int8 inputs, each
     layer and the ten timed (call, plain, floor: one copy of the input,
     bound);
  3. drive `Tracker` over a synthetic orbit at 192x640 (the main path) with
     every launch count set to 0 just before and read just after; check the
     counts, the step statistics and the poses against the exact ground truth;
  4. run the same frames and RANSAC noise through the port on the CPU and
     split each step's card-against-CPU difference: the new frame's
     features on both (top-N cells, descriptors bitwise, keypoint xy), the
     tail on the CPU from the card's own state and features (within twice
     the JAX package's jit/eager spread of that step), and the two chains
     (within 1 deg);
  5. drive `track_step_batched` over 16 streams (16 phases of the orbit, 6
     frames each) and `PipelinedTracker` (chunks of 8, 17 frames), each with
     its own launch counts, and hold them against single-stream `Tracker`
     runs on the same frames and noise;
  5b. [pairwise] drive `pairwise_pose` (golden extractor, NN match, RANSAC
     at K = M = 1000) on two orbit pairs with its own launch counts (2 stem,
     4 nullspace, 3 svd3 launches a call); the poses against the ground
     truth at bars from the JAX package's own errors, the card against the
     CPU; the nullspace and svd3 kernels against their plain versions on
     its inputs; [nms] `extract_quantized(apply_nms=True)` at S = 1 and 16,
     card against CPU; [ba] dense and factor-list `bundle_adjust` at
     P = 8, L = 1024, 10 iterations (cost never rising, RMSE within the JAX
     package's, sparse equal to dense, card against CPU); [pose-graph]
     `pose_graph.optimize` at 256 nodes, 288 edges, 8 iterations (drift
     reduced, card against CPU, two calls on the card bitwise equal); each
     timed a call (host clock);
  5c. [slam] drive `SlamSystem` (the engine behind the `track` CLI, loop
     closure on, BA every 4 frames, synchronous) over 250 frames of the
     closing orbit at DEFAULT_CONFIG's width, with its own launch counts
     (per frame and per loop verification); valid steps, inliers, loop
     closures on the revisit arc, the full engine's ATE against the
     odometry's; host wall per frame, per BA window and per loop closure;
     [slam-cpu] its first 12 frames through the port on the CPU with the
     same noise (word ids, pool sightings and counts equal), and
     `assign_words` / `lcd.query` card against CPU on the run's data;
  5d. [resume] the [slam] run checkpointed after frame 180 (before its
     first loop closure) with `utils.checkpoint.save`, restored into a
     fresh engine on the card that runs frames 181-249 (all five loop
     closures) with the same noise: bitwise equal to the unbroken run in
     everything a checkpoint holds and in both trajectories; save and
     restore wall, the checkpoint's size; [elastic] `ElasticRunner` on the
     card over 12 orbit frames (the generators' noise, no BA, no loop
     closure): unbroken, a crash injected at frame 7 and a hang at frame 6
     under a deadline set from the measured steps, each recovered with
     exactly one restart and a trajectory bitwise equal to the unbroken
     run's; recovery wall (restore + replay); [host-pool] the native host
     pool built with g++ on this machine, the 100-frame stress sequence
     with its invariant held on every frame, `observe_batch` host time, and
     the ASan/UBSan stress driver where the toolchain has sanitizers;
  5e. [mesh] 4 ranks started by `parallel.mesh.spawn`, gloo, all on the one
     card: landmark-sharded BA at [ba]'s problem against `bundle_adjust` on
     the card (R 1e-4, t 1e-3, cost rtol 1e-3), the 4096 x 10000 LCD ring
     filled through `sharded_add_frame` and `sharded_query` (rows, slot,
     frame and score equal, a tie across ranks included), the 10000-word
     sharded pool (exact) and the stream-sharded step at S = 16
     (`make_stream_mesh`, `track_step_sharded`) against
     `track_step_batched` (rotation < 0.05 deg, cos t > 0.99999, inliers
     within 3); walls of a sharded BA call, of its collectives and of a
     sharded query; [mesh-slam] the mesh-mode SlamSystem on the same 4 ranks
     over [slam]'s scene with its own launch counts per rank: ranks bitwise
     equal, [slam]'s BA-window count and loop pairs, [slam]'s bars, the
     trajectory against [slam]'s within MESH_SLAM_ALIGNED_BAR and
     MESH_SLAM_ATE_BAR; rank 0's frame
     latency and rate; the mesh engine checkpoints after frame 180
     (`checkpoint.save`, collective: the ring and pool gathered, rank 0
     writes); [mesh-resume] a fresh group of 4 ranks restores it and runs
     frames 181-249 (all five loop closures): on every rank bitwise equal to
     the unbroken rank in `checkpoint.engine_state`, its replica digest and
     both trajectories; save, restore walls and bytes on disk; [mesh-nccl]
     the same components and engine on one rank over NCCL, bitwise equal to
     the single-device port, and in that rank [resume]'s single-engine
     checkpoint restored into a fresh one-rank mesh engine over frames
     181-249, bitwise equal to [slam];
  5f. [mesh-elastic] `MeshElasticRunner` over 2 gloo ranks on the card, 16
     orbit frames, loop closure on, BA every 4, a checkpoint every 4:
     unbroken, then a crash injected in rank 1 before frame 7 (attempt 0)
     and a hang in rank 0 at frame 10 (attempt 1) under a deadline set from
     the unbroken steps: exactly two restarts of the whole group and a
     trajectory bitwise equal to the unbroken run's; each recovery's spawn,
     engine, restore and replay wall; [surface] `polar_decomposition`,
     `decompose_essential` and `recover_pose` on the pairwise path's 256
     essential matrices (one svd3 launch each): polar against the CPU at
     the svd3 bars, the decomposition on what E's conditioning does not
     move and against numpy's float64 one where t is well determined,
     recover_pose's choice against a float64 count of its candidates'
     votes up to f32 rounding's reach; `ransac_essential` with two LO
     rounds on the pairwise path's matches, card against CPU (5 nullspace
     and 4 svd3 launches); and `superpoint_float` at (1, 192,
     640), TF32 off, its error against the CPU's float64 at most twice the
     CPU's f32 error;
  5g. [degenerate] tests/test_degenerate.py's tracker sequences (orbit frames
     0-2 with a black frame; frame 0 repeated) through `Tracker` on the
     card, each with its own launch counts: the black frame a flagged
     constant-velocity fallback with every kernel launched, the recovery,
     finite repeats, the valid flags and fallback poses against the CPU;
     [long] tests/test_long_sequence.py on the first 10 orbit frames
     ping-ponged: 520 frames with a 24-slot LCD ring and 32 pose-graph
     nodes (bounded state, keyframe cadence, the ring wrapped, loop pairs on
     matching images, closures after three wraps, the pose graph's node set
     subsampled, a finite trajectory; wall a frame), then the fault-repair
     pair (270 frames, black frames 88-92, loop closure on and off: the
     drift from the first epoch); [bench] the port's roofline profile
     (`maveric_slam_tpu_torch.bench.profile`) at its smallest rounds, every
     number finite and positive, and every device-busy time given by the
     profiler;
  6. time each kernel, its plain version and a one-call PyTorch yardstick
     where there is one (never used by the port) with CUDA events (the stem,
     detector and matcher also at S=16, the nullspace and svd3 at every
     main-path shape of step 2, with the plain versions and
     torch.linalg.eigh / torch.linalg.svd at the svd3 and batched
     nullspace shapes, the nullspace and svd3 at the pairwise path's
     inputs, and refine_pose at S=1 and 16 with its floor, the same kernel
     at 0 iterations), each layer of the step alone with the host clock, the
     batched step and the chunked tracker;
  7. then, under torch.profiler, each kernel's own device time (the stem,
     detector, matcher and refine_pose also at S=16, the nullspace and svd3
     at every main-path shape of step 2; refine_pose's floor), each
     layer's and each phase 5b call's device-busy time and launches, the
     single and batched steps' and the engine's device-busy shares, and
     one loop verification's (last, so that no untraced timing runs after
     a profiler).
The last three lines are the card's name and power limit, a JSON object of
per-kernel numbers, and `{"ok": true, "device": {...}}`.

It needs a card (torch.cuda.is_available()) and the checkout beside it; it
imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, FOCAL = 192, 640, 800.0  # the 96x320 camera of tests/test_synthetic_accuracy.py, doubled
# Orbit frames per turn: twice tests/test_synthetic_accuracy.py's 96, so that
# a step moves the image as many 8-px cells as there (~3.3), inside the
# matcher's 4-cell window; 96 would move it ~6.5 cells at this focal length.
ORBIT_N = 192
N_FRAMES = 11  # 10 tracking steps
WARMUP_STEPS = 2  # steps left out of the median step time
STREAMS, STREAM_FRAMES = 16, 6  # the batched phase: 16 orbit phases, 5 steps each
# The batched phase's bar on every step's rotation error (deg). Stream 0's
# first step (frames 0 -> 1) errs by 1.996 deg on the card; with the same
# frames and noise the JAX package errs by 1.9787 deg and the port on the
# CPU by 1.9958 (`python tools/torch_smoke_vs_jax.py stream0`): the scene,
# not the port. Every other stream's worst is <= 0.421 deg.
BATCHED_ROT_BAR = 3.0
# [cpu-vs-card]'s tail bar (ROADMAP Faults (g)): per step of [track], the
# JAX package's own spread between its jitted step and the same step with
# jit disabled, from the same state, on these frames with this noise (max
# |dR|, max |dt|; `python tools/torch_smoke_vs_jax.py steps --size 192x640
# --eager`). The card's step and the CPU's tail on the card's state and
# features must lie within twice it, or 1e-4 where it is smaller (Faults
# (c)'s rule); the whole chains within 1 deg of each other.
TAIL_SPREAD = ((2.85e-3, 0.0401), (4.2e-5, 3.93e-3), (2.45e-5, 4.2e-3), (5e-5, 0.0355),
               (9.78e-6, 3.13e-4), (7.45e-5, 6.38e-3), (3.22e-5, 3.42e-3), (4.33e-3, 0.283),
               (2.05e-4, 0.01), (3.17e-6, 0.019))
CHUNK, CHUNK_FRAMES = 8, 17  # the chunked phase: two full chunks after the first frame
QCONV = 10  # ops.kernels.qconv launches a SuperPoint call: the ten layers after the stem
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # int8, dense
PAIRS = ((0, 1), (0, 4))  # [pairwise]: a consecutive orbit pair, and one 4 frames apart
PAIRWISE_CALLS = 12  # timed calls after 2 warm-ups
# [pairwise] bars on the error against the orbit's exact ground truth,
# (rotation deg, t-direction deg) per pair: twice the JAX package's own
# errors on the same frames and noise on the CPU (0.1189 / 8.746 deg on
# 0->1, 0.3868 / 3.720 deg on 0->4: `python tools/torch_smoke_vs_jax.py
# pairwise`; the port on the CPU: 0.1241 / 8.751 and 0.3888 / 3.723).
PAIRWISE_BARS = {(0, 1): (0.24, 17.5), (0, 4): (0.78, 7.5)}
BA_POSES, BA_LANDMARKS, BA_DENSITY = 8, 1024, 0.35  # BAConfig's window, tests/test_ba.py's density
BA_K = ((370.0, 0.0, 320.0), (0.0, 370.0, 96.0), (0.0, 0.0, 1.0))  # tests/test_ba.py's camera
# The final reprojection RMSE bar (px): the JAX package's dense and sparse
# solves of the same scene reach 0.50233 px from 11.3794 (`python
# tools/torch_smoke_vs_jax.py ba`); the bar is 1% above.
BA_RMSE_BAR = 0.5074
# slam.py's pose graph: max_graph_nodes nodes, + 24 loop + 8 edges, 8 iterations.
GRAPH_NODES, GRAPH_PAD_NODES, GRAPH_PAD_EDGES, GRAPH_ITERS = 240, 256, 288, 8
# The last pose's position error after the solve (m): twice the JAX
# package's 0.0047 m on the same graph (`python tools/torch_smoke_vs_jax.py
# pose-graph`; 12.0755 m before).
GRAPH_END_BAR = 0.01
# Card against CPU after the pose-graph solve. Its 1536-unknown f32 system
# (the 1e8 gauge on pose 0) is ill-conditioned and 8 iterations stop short
# of convergence, so the absolute poses follow the order of every sum: on
# the CPU alone, the same edges summed in 10 other orders move them by up to
# max |dR| 9.9e-3 and |dt| 0.553 m and the final cost by 1.7e-3, along a
# smooth bend of the loop that moves each consecutive relative pose by at
# most 5.0e-4 (R) and 8.0e-5 m (t); the JAX package and the port differ by
# 3.6e-3, 0.193 m, 2.2e-4 and 5.8e-5 (`python tools/torch_smoke_vs_jax.py
# pose-graph`). Bars (`graph_gaps`): absolute R and t twice that spread,
# relative R and t four times, the final cost within 1%.
GRAPH_CARD_BARS = {"R": 2e-2, "t": 1.2, "rel R": 2e-3, "rel t": 3.2e-4, "cost": 1e-2}
# [slam]: SlamSystem (loop closure on, BA every 4 frames, synchronous) over
# ~1.3 turns of the orbit, so that the revisit arc (frames ORBIT_N..) lies
# beyond the LCD's 50-frame gap; the checks scale
# tests/test_synthetic_accuracy.py's (96-frame orbit, loop pairs within 6 of
# a turn) to this orbit.
SLAM_FRAMES, SLAM_BA_EVERY = 250, 4
# Steps that may be not valid: the JAX package loses tracking on frame 154 of
# these frames too (0 inliers, 248 of 249 steps valid, with its own noise:
# `python tools/torch_smoke_vs_jax.py slam --size 192x640`); every other step
# must be valid.
SLAM_LOST_AS_JAX = {154}
SLAM_GAP_BAR = 12  # |frame - matched_frame - ORBIT_N| of every loop closure
SLAM_MIN_MEDIAN_INLIERS, SLAM_MIN_LOOP_INLIERS = 40, 30
SLAM_ATE_RATIO = 0.85  # full-engine ATE below this share of the odometry-only ATE
SLAM_CPU_FRAMES = 12  # [slam-cpu]: the run's first frames through the port on the CPU
SLAM_SAVE_AT = 180  # [resume]: the [slam] run's checkpoint, before its first loop closure (194)
ELASTIC_FRAMES, ELASTIC_EVERY = 12, 4  # [elastic]: orbit frames, checkpoint interval
ELASTIC_CRASH_AT, ELASTIC_HANG_AT = 7, 6  # the frames of the injected crash and hang
# [mesh] / [mesh-slam]: gloo ranks sharing the one card (NCCL refuses two
# ranks on one GPU); [mesh-nccl] is one NCCL rank. Every spawned phase has a
# wall limit, and `spawn` kills the other ranks when one fails.
MESH_RANKS, MESH_TIMEOUT_S = 4, 600
MESH_BA_CALLS, MESH_QUERY_CALLS = 5, 10  # timed sharded BA calls / queries a probe
MESH_LCD_FRAMES = 4096 + 50  # [mesh]: the 4096-frame ring filled and wrapped
MESH_POOL_FRAMES = 20
# [mesh-slam]: the 4-rank engine against the single-device [slam] run. The
# chain is sensitive to the order of the window BA's sums (ROADMAP Faults
# (l), (o)): the single engine with the landmarks of every BA problem in 6
# other orders moves by 0.294-0.479 m after a similarity alignment, its ATE
# by up to 0.0449 m (`python tools/torch_mesh_spread.py --scene chip
# --orders 6` on the card). The JAX package's own mesh engine on this
# scene and noise moves 0.30607 / 3.16773 / 0.609992 m (aligned) from its
# single engine at 2 / 4 / 8 devices, with the same windows and loop pairs
# (`python tools/torch_smoke_vs_jax.py mesh`, Faults (o)). Bars: the aligned
# RMSE against [slam]'s trajectory within twice JAX's 4-device figure, and
# the ATE within twice the reordered runs' largest ATE change of [slam]'s.
MESH_SLAM_ALIGNED_BAR, MESH_SLAM_ATE_BAR = 6.335, 0.0898
# [mesh-elastic]: 2 gloo ranks on the card over [elastic]'s orbit frames
# extended to 16 (loop closure on, BA every 4: windows at 4, 8 and 12), a
# checkpoint every 4; a crash in rank 1 before frame 7 in the first
# attempt, a hang in rank 0 at frame 10 in the second.
MESH_ELASTIC_RANKS, MESH_ELASTIC_FRAMES, MESH_ELASTIC_EVERY = 2, 16, 4
MESH_ELASTIC_FAULTS = (("crash", 0, 1, 7), ("hang", 1, 0, 10))
SURFACE_GAP = 1e-2  # [surface]: (s1 - |s2|) / s0 below this leaves t, and so the pair, ill-determined
SURFACE_LO_ROUNDS, SURFACE_LO_SEED = 2, 5  # [surface]: LO rounds; the seed of the rounds after the first
# [degenerate]: tests/test_degenerate.py's tracker sequences on orbit frames
# 0-2 (that test reads KITTI frames 160-162, which the repository does not
# hold): frames 0, 1, a black frame, 1, 2; and frame 0 four times. The RANSAC
# noise comes from a host generator seeded DEGENERATE_SEED, the same on the
# card and the CPU.
DEGENERATE_SEED = 4
# [long]: tests/test_long_sequence.py on the first LONG_IMAGES orbit frames
# ping-ponged (that test ping-pongs KITTI frames 160-169): its structural run
# (a 24-slot LCD ring, a 12-frame gap, min_score 0.3, 32 pose-graph nodes,
# no BA, 520 frames) and its fault-repair pair (128 slots, 270 frames, loop
# closure on and off, black frames 88-92 around the turnaround, image noise
# sigma 0.02 from seed 42).
LONG_IMAGES = 10
LONG_FRAMES, LONG_RING, LONG_GAP, LONG_MIN_SCORE, LONG_NODES = 520, 24, 12, 0.3, 32
LONG_REPAIR_FRAMES, LONG_REPAIR_RING, LONG_BLACK = 270, 128, (88, 89, 90, 91, 92)
# Loop pairs of the structural run may show images this far apart. The test's
# bar is 1 on KITTI, whose frames are ~1 m apart; on the orbit a turn takes
# 192 frames, so frames a few apart still share most of the view: the JAX
# package's engine on these frames pairs images up to 3 apart (126 pairs:
# 117 at 0, 1 at 1, 5 at 2, 3 at 3; `python tools/torch_smoke_vs_jax.py
# long`), so the bar is its figure, 3 (ROADMAP Faults (r)).
LONG_IMAGE_GAP = 3


def _log(*a):
    print(*a, flush=True)


def _require(ok, what):
    """A check of this run's results; raises (also under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _config():
    from maveric_slam_tpu_torch.config import DEFAULT_CONFIG, CameraConfig

    cam = CameraConfig(fx=FOCAL, fy=FOCAL, cx=W / 2, cy=H / 2, width=W, height=H)
    return dataclasses.replace(
        DEFAULT_CONFIG,
        camera=cam,
        frontend=dataclasses.replace(DEFAULT_CONFIG.frontend, height=H, width=W),
        ransac=dataclasses.replace(DEFAULT_CONFIG.ransac, inlier_thresh=3.0 / FOCAL),
    )


def _rot_deg(R, R_ref):
    c = (np.trace(R.T @ R_ref) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _dir_deg(t, t_ref):
    c = t @ t_ref / max(np.linalg.norm(t) * np.linalg.norm(t_ref), 1e-30)
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def phase_build():
    from maveric_slam_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    _log(f"[build] {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.2f} s "
         f"(nvcc {_build.build_seconds})")
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            _log("[build]   " + line.strip())
    code = _build.sass("stem_kernel")
    counts = {op: code.count(op) for op in ("IMMA", "IDP", "LDSM")}
    _log(f"[build] stem_kernel SASS: {json.dumps(counts)} (IMMA: conv1b on the int8 tensor cores; "
         f"IDP: conv1a's dp4a; LDSM: ldmatrix)")
    _require(counts["IMMA"] > 0, "stem_kernel has no tensor-core (IMMA) instruction")
    code = _build.sass("qconv_kernel")
    counts = {op: code.count(op) for op in ("IMMA", "LDSM", "LDGSTS")}
    _log(f"[build] qconv_kernel SASS (its eight instantiations): {json.dumps(counts)} (IMMA: the "
         f"int8 tensor cores; LDSM: ldmatrix; LDGSTS: cp.async)")
    _require(counts["IMMA"] > 0, "qconv_kernel has no tensor-core (IMMA) instruction")


def kernel_inputs(dev, frames, noise, cfg, streams):
    """The six kernels' inputs as the tracking step forms them, from frames
    0 and 1: the images for the stem, detector logits, match queries and
    cells, the 8-point normal matrices of the minimal, LO and refit stages,
    their nullspaces as 3x3 matrices for svd3, and the pose refinement's
    problem (RANSAC's pose, the triangulated points, the matches, the
    depth-gated inliers); the batched step's stem images, detector logits
    and match inputs from the first two frames of the 16 streams, and the
    refinement's problem for every stream."""
    from maveric_slam_tpu_torch.geometry import epipolar, ransac
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import matching, softmax_topn as st
    from maveric_slam_tpu_torch.ops.kernels import detector, nullspace

    fc, mc = cfg.frontend, cfg.matcher
    params = sp.load_params(device=dev)
    imgs = torch.from_numpy(np.stack(frames[:2])).to(dev)
    semi, desc, scales = sp.superpoint_int8(params, imgs)
    semi = semi.reshape(2, -1, 65)
    desc = desc.reshape(2, -1, 256)
    det = [detector.detector_postproc_plain(semi[k], scales["semi_scale"]) for k in (0, 1)]
    grid1 = st.SoftmaxGrid(det[1][0].reshape(fc.grid_h, fc.grid_w),
                           det[1][1].reshape(fc.grid_h, fc.grid_w))
    top = st.top_n_select(grid1, n=fc.top_n, valid_thresh=fc.valid_prob_thresh,
                          mode=fc.top_n_mode)
    m = matching.windowed_match(
        desc[0], det[0][0], det[0][1], desc[1], top.cells, top.indices, top.mask,
        grid_h=fc.grid_h, grid_w=fc.grid_w, shift=mc.window_shift,
        radius=mc.window_radius, match_threshold=mc.match_threshold,
        min_prob=mc.min_prob, xy0_cells=det[0][2], xy1_cells=det[1][2])
    K = torch.from_numpy(cfg.working_camera.K).to(dev)
    p1, p2 = epipolar.normalize_points(m.xy0, K), epipolar.normalize_points(m.xy1, K)
    logits = torch.where(m.mask, 0.0, -torch.inf)
    gmin, glo = (g.to(dev) for g in noise)

    def normal(idx=None, w=None):
        a = epipolar.eight_point_design(p1 if idx is None else p1[idx],
                                        p2 if idx is None else p2[idx])
        a = a if w is None else a * w[..., None]
        return a.transpose(-1, -2) @ a

    ata_min = normal(st.top_k(logits + gmin, 8)[1])  # (256, 9, 9)
    ata_lo = normal(st.top_k(logits + glo, 16)[1])  # (64, 9, 9)
    w = m.mask[None] / torch.tensor([[1.0], [2.0], [4.0]], device=dev)
    ata_refit = normal(w=w.to(torch.float32))  # (3, 9, 9)
    res = ransac.ransac_essential(p1, p2, m.mask, inlier_thresh=cfg.ransac.inlier_thresh,
                                  num_hypotheses=cfg.ransac.num_hypotheses, gumbel_min=gmin,
                                  gumbel_lo=glo)
    X = epipolar.triangulate(res.R, res.t, p1, p2)
    depth_ok = res.inliers & (X[..., 2] > 1e-3) & (X[..., 2] < 1e3)
    pnp1 = tuple(x[None].contiguous() for x in (res.R, res.t, X, m.xy1, depth_ok))
    a4 = torch.from_numpy(np.random.default_rng(4).normal(size=(100, 4, 4)).astype(np.float32))
    ata4 = (a4 @ a4.transpose(-1, -2)).to(dev)  # (100, 4, 4), the DLT size
    E = [nullspace.nullspace_plain(a).reshape(-1, 3, 3) for a in (ata_min, ata_lo, ata_refit)]
    v8 = torch.from_numpy(np.random.default_rng(9).normal(size=(9, 8)).astype(np.float32))
    null_edge = torch.stack([torch.zeros(9, 9), v8 @ v8.T, 1e3 * (v8 @ v8.T)]).to(dev)
    # Rank-2 essential-like, negative determinant, rank-1, zero, and
    # repeated singular values: I, diag(2, 2, 1), diag(3, 1, 1).
    degenerate = torch.zeros(7, 3, 3)
    degenerate[0, 0, 1], degenerate[0, 1, 0] = 1.0, -1.0
    degenerate[1] = torch.diag(torch.tensor([1.0, 2.0, -3.0]))
    degenerate[2] = torch.outer(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.5, -1.0, 2.0]))
    for k, diag in enumerate(([1.0, 1.0, 1.0], [2.0, 2.0, 1.0], [3.0, 1.0, 1.0])):
        degenerate[4 + k] = torch.diag(torch.tensor(diag))

    s = len(streams)
    first = torch.from_numpy(np.stack([f[0] for f in streams])).to(dev)
    second = torch.from_numpy(np.stack([f[1] for f in streams])).to(dev)
    semi16, desc16, sc16 = sp.superpoint_int8(params, torch.cat([first, second]))
    semi16, desc16 = semi16.reshape(2, s, -1, 65), desc16.reshape(2, s, -1, 256)
    d0 = detector.detector_postproc_plain(semi16[0], sc16["semi_scale"])
    d1 = detector.detector_postproc_plain(semi16[1], sc16["semi_scale"])
    top16 = st.top_n_select(st.SoftmaxGrid(d1[0].reshape(s, fc.grid_h, fc.grid_w),
                                           d1[1].reshape(s, fc.grid_h, fc.grid_w)),
                            n=fc.top_n, valid_thresh=fc.valid_prob_thresh, mode=fc.top_n_mode)
    rng = np.random.default_rng(3)
    return {
        "stem_args": sp.stem_args(params),
        "stem": {"(1, 192, 640) orbit": imgs[:1].contiguous(), "(16, 192, 640) streams": first,
                 "(2, 36, 44) seeded": torch.from_numpy(rng.random((2, 36, 44), dtype=np.float32)).to(dev),
                 "(1, 6, 10) under one tile": torch.from_numpy(rng.random((1, 6, 10), dtype=np.float32)).to(dev),
                 "(2, 192, 640) all 0 / all 1": torch.stack([torch.zeros(H, W), torch.ones(H, W)]).to(dev)},
        "detector16": (semi16[1].contiguous(), sc16["semi_scale"]),
        "match16": (torch.take_along_dim(desc16[1], top16.cells.long()[..., None], dim=1),
                    desc16[0].contiguous(), d0[0], d0[1], top16.cells),
        "detector": (semi[1].contiguous(), scales["semi_scale"]),
        "match": (desc[1][top.cells.long()], desc[0], det[0][0], det[0][1], top.cells),
        "match_kw": dict(grid_h=fc.grid_h, grid_w=fc.grid_w, shift=mc.window_shift,
                         radius=mc.window_radius, min_prob=mc.min_prob),
        "nullspace": [ata_min, ata_lo, ata_refit, ata4],
        # The batched step's calls at S = 16 (B = 4096, 1024, 48): the single
        # step's matrices for every stream.
        "nullspace16": [a.expand(s, *a.shape).contiguous() for a in (ata_min, ata_lo, ata_refit)],
        "nullspace_edge": [null_edge],
        "svd3": [E[0], E[1], E[2][:1], degenerate.to(dev), 1e-4 * E[0], 1e4 * E[0]],
        # The batched step's calls at S = 16 (B = 4096, 1024, 16).
        "svd3_16": [e.expand(s, *e.shape).contiguous() for e in (E[0], E[1], E[2][:1])],
        # refine_pose's arguments at S = 1, and at S = 16 the single step's
        # problem for every stream.
        "refine_pose": (K, *pnp1),
        "refine_pose16": (K, *(x.expand(s, *x.shape[1:]).contiguous() for x in pnp1)),
        "refine_kw": dict(huber_delta=cfg.ba.huber_delta, damping=cfg.ba.lm_damping),
    }


def match_cases(q, d0, pr0, ix0, cells, kw):
    """[(label, args, kw, lower)]: the matcher's contract at its corners, on
    the main path's inputs: "tie" (the first 3 queries' own descriptors
    copied to two cells of their windows, `lower` the lower of each pair:
    the best cell is no higher, at score 1), "edges shift
    (sx, sy)" (queries at the grid's corners, edge midpoints and centre,
    windows shifted so that they clip on every side, and with (-6, 0) leave
    the grid at the left edge: (-1, cell 0)), "unsigned" (signed=False)."""
    gh, gw = kw["grid_h"], kw["grid_w"]
    cases = []
    d_tie, p_tie, i_tie = d0.clone(), pr0.clone(), ix0.clone()
    lower = []
    for k in range(3):
        r, c = divmod(int(cells[k]), gw)
        r, c = min(max(r, 2), gh - 3), min(max(c, 2), gw - 3)  # both cells inside the window
        a, b = (r - 2) * gw + c + 1, r * gw + c - 2
        d_tie[[a, b]] = q[k]
        p_tie[[a, b]], i_tie[[a, b]] = 1.0, 0
        lower.append(min(a, b))
    cases.append(("tie", (q[:3], d_tie, p_tie, i_tie, cells[:3]), dict(kw, shift=(0, 0)), lower))
    edge = torch.tensor([r * gw + c for r in (0, gh // 2, gh - 1) for c in (0, gw // 2, gw - 1)],
                        dtype=torch.int32, device=q.device)
    for shift in ((3, -2), (-3, 2), (-6, 0)):
        cases.append((f"edges shift {shift}", (d0[edge.long()], d0, pr0, ix0, edge),
                      dict(kw, shift=shift), None))
    cases.append(("unsigned", (q, d0, pr0, ix0, cells), dict(kw, signed=False), None))
    return cases


def detector_cases(semi, scale):
    """[(label, semi, scale, kw, expect)]: the detector's contract at its
    corners, on the main path's (1920, 65) logits: maxima tied across the
    kernel's lane boundaries (the lower channel wins), cells with no
    non-negative point logit (64), all 0 / all 127 / all -128 / one 127
    among -128s, winners on the 8x8 layout's border with a clipped 3x3
    window, Taylor degrees 1, 2, 5, 8 at scales 1e-7 and 4 and degrees 9
    and 12, one row (C = 80), a 6x10 grid (a ragged tile) and a view whose
    base is not 16-byte aligned. `expect`: the winning channels where the
    case fixes them."""
    dev, kw = semi.device, dict(degree=5, grid_w=80)
    cases = []
    ties = semi[:80].clone()
    pairs = torch.tensor([(7, 8), (55, 56), (0, 63), (15, 16), (31, 32), (47, 48), (8, 15), (62, 63)],
                         device=dev)[torch.arange(80, device=dev) % 8]
    ties[:, :64] = ties[:, :64].clamp(max=100)
    ties.scatter_(1, pairs, 120)
    cases.append(("lane-boundary ties", ties, scale, kw, pairs.min(1).values))
    neg = -(semi[:80].clamp(min=-127).abs()) - 1  # every logit in -128..-1
    neg[40:, 64] = semi[40:80, 64].clamp(min=-127).abs()  # and only the dustbin >= 0
    cases.append(("negative / dustbin only", neg, scale, kw,
                  torch.full((80,), 64, device=dev)))
    ext = torch.full((80, 65), -128, dtype=torch.int8, device=dev)
    ext[:20], ext[20:40] = 0, 127
    lone = torch.arange(60, 80, device=dev) * 11 % 64
    ext[torch.arange(60, 80, device=dev), lone] = 127
    cases.append(("zero and extremes", ext, scale, kw,
                  torch.cat([torch.zeros(40, device=dev), torch.full((20,), 64, device=dev), lone])))
    border = semi[:80].clamp(max=59)
    win = torch.tensor([0, 7, 56, 63, 3, 24, 31, 59, 27, 36], device=dev)[torch.arange(80, device=dev) % 10]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            y, x = win // 8 + dy, win % 8 + dx
            ok = (y >= 0) & (y < 8) & (x >= 0) & (x < 8)
            border[ok.nonzero()[:, 0], (8 * y + x)[ok]] = 100
    border[torch.arange(80, device=dev), win] = 120
    cases.append(("8x8 border winners", border, scale, kw, win))
    for degree, s in [(d, s) for d in (1, 2, 5, 8) for s in (1e-7, 4.0)] + [(9, None), (12, None)]:
        sc = scale if s is None else torch.tensor(s, device=dev)
        cases.append((f"degree {degree} scale {float(sc):.4g}", semi, sc, dict(kw, degree=degree), None))
    mid = semi.shape[0] // 2  # a middle row of the frame, where it has keypoints
    cases.append(("one row (C = 80)", semi[mid:mid + 80], scale, kw, None))
    cases.append(("6x10 grid", semi[mid:mid + 60], scale, dict(kw, grid_w=10), None))
    unaligned = torch.cat([semi[:1], semi])[1:]
    _require(unaligned.data_ptr() % 16 != 0, "the unaligned view is aligned")
    cases.append(("unaligned view", unaligned, scale, kw, None))
    return cases


def _check_detector(semi, scale, **kw):
    """Kernel against plain: argmax equal, probs rtol 1e-6, xy atol 1e-3
    where a cell has a keypoint; returns (kernel outputs, max |dprob|,
    max |dxy|)."""
    from maveric_slam_tpu_torch.ops.kernels import detector

    got = detector.detector_postproc(semi, scale, **kw)
    p, i, xy = got
    pp, ip, xyp = detector.detector_postproc_plain(semi, scale, **kw)
    v = ip != 64
    _require(torch.equal(i, ip), "detector: argmax differs")
    torch.testing.assert_close(p, pp, rtol=1e-6, atol=0)
    torch.testing.assert_close(xy[v], xyp[v], rtol=0, atol=1e-3)
    dxy = float((xy[v] - xyp[v]).abs().max()) if bool(v.any()) else 0.0
    return got, float((p - pp).abs().max()), dxy


QCONV_SIZES = ((1, 192, 640), (16, 192, 640), (16, 376, 1240))  # the main path's net calls
QCONV_FOCAL = {192: FOCAL, 376: 1550.0}  # slam_bench's sp_kitti_376x1240 camera at 376 rows


def qconv_layers(params, images):
    """The ten layers after the stem on `images` (S, H, W), each fed the
    kernel's own output of the layer before: [(name, x, args, relu, pool)],
    args = `superpoint.qconv_args`."""
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops.kernels import qconv, stem

    spec = {name: (relu, pool) for name, _, relu, pool in sp._AFTER_STEM}
    layers = []

    def run(x, name):
        args = sp.qconv_args(params, name)
        layers.append((name, x, args) + spec[name])
        return qconv.qconv(x, *args, relu=spec[name][0], pool=spec[name][1])

    x = stem.fused_stem(images, *sp.stem_args(params))
    for name in sp._ENCODER[2:]:
        x = run(x, name)
    run(run(x, "convPa"), "convPb")
    run(run(x, "convDa"), "convDb")
    return layers


def _qconv_work(x, args, pool):
    """(bytes, int8 operations) of one qconv layer: input, weights, bias
    and output once; 2 k^2 cin cout operations a (pre-pool) pixel."""
    w, b, _, k = args
    s, h, wd, cin = x.shape
    out = s * (h // 2) * (wd // 2) if pool else s * h * wd
    return x.numel() + w.numel() + 4 * b.numel() + out * b.numel(), 2 * s * h * wd * cin * b.numel() * k * k


def qconv_images(size):
    """Orbit frames at `size` (S, H, W): stream s at orbit phase 12 s."""
    from maveric_slam_tpu_torch.data import synthetic

    s, h, w = size
    f = QCONV_FOCAL[h]
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    poses = synthetic.orbit_poses(ORBIT_N if h == H else 372)
    return torch.from_numpy(np.stack([synthetic.render_box_room(K, poses[12 * k], h, w)
                                      for k in range(s)])).cuda()


def phase_qconv():
    """The qconv kernel against its plain version, bit for bit, at every
    layer of the main path's net calls (QCONV_SIZES), on orbit activations
    and on seeded int8 inputs of the same shapes; then each layer's and the
    ten's call ms (CUDA events), plain ms, floor (one copy of the layer's
    input) and bound. Returns {size: [(name, call, plain call, x, args,
    pool)]}, the calls for the profiler."""
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops.kernels import qconv

    params = sp.load_params(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(19)
    calls = {}
    for size in QCONV_SIZES:
        layers = qconv_layers(params, qconv_images(size))
        rows, total = [], {"call": 0.0, "plain": 0.0, "floor": 0.0, "bound": 0.0, "bytes": 0, "ops": 0}
        calls[size] = []
        for name, x, args, relu, pool in layers:
            seeded = torch.randint(0, 128, x.shape, dtype=torch.int8, device="cuda", generator=gen)
            for label, inp in (("orbit", x), ("seeded", seeded)):
                got = qconv.qconv(inp, *args, relu=relu, pool=pool)
                ref = qconv.qconv_plain(inp, *args, relu=relu, pool=pool)
                torch.cuda.synchronize()
                _require(torch.equal(got, ref), f"qconv {name} at {size} on {label} input: not bitwise "
                                                f"equal to the plain version")
            call = (lambda x=x, args=args, relu=relu, pool=pool:
                    qconv.qconv(x, *args, relu=relu, pool=pool))
            plain_call = (lambda x=x, args=args, relu=relu, pool=pool:
                          qconv.qconv_plain(x, *args, relu=relu, pool=pool))
            calls[size].append((name, call, plain_call, x, args, pool))
            nbytes, ops = _qconv_work(x, args, pool)
            bound, by = _bound(nbytes, ops, INT8_OPS_PER_S)
            plain = _event_ms(plain_call, 5)
            kern = _event_ms(call, 50)
            floor = _event_ms(lambda x=x: x.clone(), 50)
            for key, v in (("call", kern), ("plain", plain), ("floor", floor), ("bound", bound),
                           ("bytes", nbytes), ("ops", ops)):
                total[key] += v
            _log(f"[qconv] {size} {name} {tuple(x.shape)} -> {tuple(ref.shape)}: bitwise equal on orbit "
                 f"and seeded inputs ({100 * float((ref != 0).float().mean()):.1f}% nonzero); call "
                 f"{kern:.4f} ms, plain {plain:.4f} ms, floor (input copy) {floor:.4f} ms, bound "
                 f"{bound:.2e} ms ({by}: {nbytes} B, {ops} ops), {ops / kern / 1e9:.1f} TOP/s")
        ten = _event_ms(lambda layers=calls[size]: [c() for _, c, _, _, _, _ in layers], 20)
        _log(f"[qconv] {size} the ten layers: sum of calls {total['call']:.4f} ms, back to back "
             f"{ten:.4f} ms, plain {total['plain']:.4f} ms, floor {total['floor']:.4f} ms, bound "
             f"{total['bound']:.4f} ms ({total['bytes']} B, {total['ops']} ops), "
             f"{total['ops'] / ten / 1e9:.1f} TOP/s")
    torch.cuda.empty_cache()  # the plain path's im2col at 376 (~7.8 GB cached) is not needed again
    return calls


def qconv_traced(calls):
    """Each layer's and the ten's device ms per call (torch.profiler)."""
    for size, layers in calls.items():
        total = 0.0
        for name, call, _, x, args, pool in layers:
            dev = _device_ms(call, ("qconv_kernel",), 20)
            nbytes, ops = _qconv_work(x, args, pool)
            bound = _bound(nbytes, ops, INT8_OPS_PER_S)[0]
            total += dev or 0.0
            rate = "" if dev is None else f", {ops / dev / 1e9:.1f} TOP/s, {100 * bound / dev:.1f}% of its bound"
            _log(f"[traced] qconv {size} {name}: device {dev} ms/launch{rate}")
        ten, count = _kernel_events(lambda layers=layers: [c() for _, c, _, _, _, _ in layers], 10)
        _log(f"[traced] qconv {size} the ten layers: device {total:.4f} ms (sum of layers); back to "
             f"back device busy {ten:.4f} ms/call, {count:.0f} kernels/call")


def phase_kernels(inp):
    """Each kernel against its plain version on the same card inputs."""
    from maveric_slam_tpu_torch.ops.kernels import match, nullspace, refine_pose, stem, svd3

    errs = {"fused_stem": 0.0}
    for label, img in inp["stem"].items():
        got = stem.fused_stem(img, *inp["stem_args"])
        ref = stem.fused_stem_plain(img, *inp["stem_args"])
        _require(torch.equal(got, ref), f"fused_stem {label}: not bitwise equal to the layered stage 1")
        errs["fused_stem"] = max(errs["fused_stem"], float((got.int() - ref.int()).abs().max()))
        _log(f"[kernels] fused_stem {label}: bitwise equal to the layered stage 1, "
             f"{tuple(got.shape)} int8, {100 * float((ref > 0).float().mean()):.1f}% nonzero, "
             f"{100 * float((ref == 127).float().mean()):.2f}% at 127")

    semi16, scale16 = inp["detector16"]
    (p, i, xy), dp, dxy = _check_detector(semi16, scale16)
    for k in range(p.shape[0]):
        alone, _, _ = _check_detector(semi16[k], scale16)
        _require(all(torch.equal(a, b[k]) for a, b in zip(alone, (p, i, xy))),
                 f"detector stream {k} alone differs from its row of the S=16 call")
    _log(f"[kernels] detector S={p.shape[0]} C={p.shape[1]} (one launch): argmax equal per stream, "
         f"max |dprob| {dp:.3g}, max |dxy| {dxy:.3g}; each stream alone equals its row")
    s16, c16 = match.windowed_match(*inp["match16"], **inp["match_kw"])
    sp16, cp16 = match.windowed_match_plain(*inp["match16"], **inp["match_kw"])
    for k in range(s16.shape[0]):
        _require(torch.equal(c16[k], cp16[k]), f"batched match stream {k}: best cells differ")
        _require(torch.equal(s16[k], sp16[k]), f"batched match stream {k}: scores not bitwise equal")
        alone = match.windowed_match(*(a[k] for a in inp["match16"]), **inp["match_kw"])
        _require(torch.equal(alone[0], s16[k]) and torch.equal(alone[1], c16[k]),
                 f"match stream {k} alone differs from its row of the S=16 call")
    _log(f"[kernels] match S={s16.shape[0]} N={s16.shape[1]} (one launch): cells equal and scores "
         f"bitwise equal per stream; each stream alone equals its row")

    (p, i, xy), dp, dxy = _check_detector(*inp["detector"])
    errs["detector_postproc"] = max(dp, dxy)
    _log(f"[kernels] detector C={p.shape[0]}: argmax equal, {int((i != 64).sum())} keypoint cells, "
         f"max |dprob| {dp:.3g}, max |dxy| {dxy:.3g}")
    for label, semi, scale, kw, expect in detector_cases(*inp["detector"]):
        (p, i, xy), dp, dxy = _check_detector(semi, scale, **kw)
        _require(expect is None or torch.equal(i, expect.to(i.dtype)),
                 f"detector {label}: winners {i.tolist()}, expected {expect}")
        _log(f"[kernels] detector {label}: argmax equal{'' if expect is None else ' and as expected'}, "
             f"{int((i != 64).sum())} of {i.numel()} keypoint cells, max |dprob| {dp:.3g}, "
             f"max |dxy| {dxy:.3g}")

    s, c = match.windowed_match(*inp["match"], **inp["match_kw"])
    sp_, cp = match.windowed_match_plain(*inp["match"], **inp["match_kw"])
    _require(torch.equal(c, cp), "match: best cells differ")
    _require(torch.equal(s, sp_), "match: scores not bitwise equal")
    errs["windowed_match"] = float((s - sp_).abs().max())
    _log(f"[kernels] match N={s.shape[0]} C={inp['match'][1].shape[0]}: cells equal, scores bitwise "
         f"equal, {int((sp_ > 0.64).sum())} above 0.8^2")
    for label, args, kw, lower in match_cases(*inp["match"], inp["match_kw"]):
        s, c = match.windowed_match(*args, **kw)
        sp_, cp = match.windowed_match_plain(*args, **kw)
        _require(torch.equal(c, cp) and torch.equal(s, sp_), f"match {label}: differs from plain")
        _require(lower is None or (s.tolist() == [1.0] * len(lower)
                                   and all(x <= y for x, y in zip(c.tolist(), lower))),
                 f"match {label}: {s.tolist()} at {c.tolist()}, expected 1.0 at or below {lower}")
        _log(f"[kernels] match {label}: cells equal, scores bitwise equal; "
             f"{int((s == -1).sum())} of {s.shape[0]} queries without a usable cell")

    errs["nullspace_inverse_iteration"] = 0.0
    for a in inp["nullspace"] + inp["nullspace16"] + inp["nullspace_edge"]:
        got, ref = nullspace.nullspace_inverse_iteration(a), nullspace.nullspace_plain(a)
        d = (got * torch.sign(torch.sum(ref * got, -1, keepdim=True)) - ref).abs().max()
        _require(float(d) <= 1e-3, f"nullspace {tuple(a.shape)}: {float(d)}")
        errs["nullspace_inverse_iteration"] = max(errs["nullspace_inverse_iteration"], float(d))
        _log(f"[kernels] nullspace {tuple(a.shape)}: sign-aligned max |dx| {float(d):.3g} (bar 1e-3)")

    errs["svd3"] = 0.0
    for a in inp["svd3"] + inp["svd3_16"]:
        U, s3, V = svd3.svd3(a)
        _, s3p, _ = svd3.svd3_plain(a)
        m = max(1.0, float(a.abs().max()))
        ds = float((s3 - s3p).abs().max())
        recon = float((U @ torch.diag_embed(s3) @ V.transpose(-1, -2) - a).abs().max())
        ddet = max(float((torch.linalg.det(U) - 1).abs().max()),
                   float((torch.linalg.det(V) - 1).abs().max()))
        _require(ds <= 2e-4 * m and recon <= 1e-3 * m and ddet <= 1e-3, (tuple(a.shape), ds, recon, ddet))
        errs["svd3"] = max(errs["svd3"], ds)
        _log(f"[kernels] svd3 {tuple(a.shape)}: max |ds| {ds:.3g}, recon {recon:.3g}, "
             f"|det-1| {ddet:.3g} (bars 2e-4, 1e-3, 1e-3 x max|A|={m:.3g})")
    # A matrix's result does not depend on its batch: alone, in the single
    # step's batch of 256 and in the batched step's 4096 (16 copies).
    E, E16 = inp["svd3"][0], inp["svd3_16"][0]
    full, batched = svd3.svd3(E), svd3.svd3(E16)
    for k in (0, 1, 31, 32, 100, E.shape[0] - 1):
        for a, f, b in zip(svd3.svd3(E[k:k + 1]), full, batched):
            _require(torch.equal(a[0], f[k]) and torch.equal(a[0], b[-1, k]),
                     f"svd3 of matrix {k} alone differs from its row in a batch")
    _log(f"[kernels] svd3: matrices alone equal their rows of the B={E.shape[0]} and "
         f"{tuple(E16.shape[:2])} calls bit for bit")
    errs["refine_pose"] = 0.0
    kw = inp["refine_kw"]
    for args in (inp["refine_pose"], inp["refine_pose16"]):
        got = refine_pose.refine_pose(*args, **kw)
        plain = refine_pose.refine_pose_plain(*args, **kw)
        f64 = refine_pose.refine_pose_plain(*(a.double() if a.is_floating_point() else a for a in args), **kw)
        gaps = []
        for name in ("R", "t", "cost"):
            g, p, x = (getattr(r, name).double() for r in (got, plain, f64))
            bar = 4 * float((p - x).abs().max()) + 8 * 2.0 ** -23 * max(1.0, float(x.abs().max()))
            gaps.append((name, float((g - x).abs().max()), float((p - x).abs().max()), bar,
                         float((g - p).abs().max())))
            _require(gaps[-1][1] <= bar, f"refine_pose S={args[1].shape[0]} {name}: {gaps[-1]}")
        _require(torch.equal(got.num_used, plain.num_used), f"refine_pose S={args[1].shape[0]}: num_used")
        errs["refine_pose"] = max(errs["refine_pose"], *(d for *_, d in gaps[:2]))
        _log(f"[kernels] refine_pose S={args[1].shape[0]} N={args[3].shape[1]} (one launch, "
             f"{int(got.num_used[0])} factors used): " + "; ".join(
                 f"{n}: |kernel - f64| {g:.3g}, |plain - f64| {p:.3g} (bar {b:.3g}), |kernel - plain| {d:.3g}"
                 for n, g, p, b, d in gaps) + "; num_used equal")
    one = refine_pose.refine_pose(*inp["refine_pose"], **kw)
    many = refine_pose.refine_pose(*inp["refine_pose16"], **kw)
    again = refine_pose.refine_pose(*inp["refine_pose16"], **kw)
    _require(all(torch.equal(a, b) for a, b in zip(many, again)), "refine_pose: a rerun differs")
    _require(all(torch.equal(a[0], b[k]) for a, b in zip(one, many) for k in range(b.shape[0])),
             "refine_pose: a pose of the S=16 call differs from the S=1 call")
    _log("[kernels] refine_pose: every pose of the S=16 call equals the S=1 call bit for bit; a rerun "
         "is bitwise equal")
    torch.cuda.synchronize()
    return errs


def track(dev, frames, noises, cfg, seed=0):
    """The main path: `Tracker` over the frames on `dev`; returns the
    per-step results (host copies) and step times."""
    from maveric_slam_tpu_torch.frontend.tracker import Tracker
    from maveric_slam_tpu_torch.models import superpoint as sp

    tr = Tracker(sp.load_params(device=dev), cfg, seed=seed, device=dev)
    tr.process(frames[0])
    steps, times = [], []
    for f, (gmin, glo) in zip(frames[1:], noises):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = tr.process(f, gmin.to(dev), glo.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        steps.append({"R": step.R.cpu().numpy(), "t": step.t.cpu().numpy(), **tr.stats[-1]})
    return steps, times


def check_poses(steps, gt_R, gt_t, label):
    rot = [_rot_deg(s["R"], R) for s, R in zip(steps, gt_R)]
    tdir = [_dir_deg(s["t"], t) for s, t in zip(steps, gt_t)]
    for k, s in enumerate(steps):
        _log(f"[{label}] step {k}: matches {s['matches']} inliers {s['inliers']} "
             f"valid {s['valid']} rot err {rot[k]:.3f} deg t-dir err {tdir[k]:.2f} deg")
    # A broken pipeline lands far from the exact ground truth: rotation
    # errors of degrees and translation directions at random. The port at
    # 96x320 (96-frame orbit) on the CPU measured <= 1.1 deg and a mean t-dir
    # of <= 13 deg.
    _require(sum(s["valid"] and s["matches"] >= 8 for s in steps) >= 8,
             f"{label}: fewer than 8 valid steps with >= 8 matches")
    _require(max(rot) < 2.0 and float(np.mean(tdir)) < 25.0, f"{label}: pose errors {rot} {tdir}")


def _to_cpu(x, dtype=None):
    """Tensors (alone or nested in tuples, named tuples, lists and dicts) on
    the CPU; floating ones cast to `dtype` when given."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.to(dtype) if dtype is not None and x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _to_cpu(v, dtype) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        items = [_to_cpu(v, dtype) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def phase_cpu_vs_card(frames, noises, cfg, steps, cpu_steps):
    """[cpu-vs-card]: the card's [track] run against the CPU's, split
    (ROADMAP Faults (g)). The card's chain runs again from its own states
    (each step bitwise [track]'s) and, at each step: the features of the
    new frame on the card and on the CPU (the same top-N cells, descriptors
    bitwise equal, keypoint xy within 1e-3: the detector's bars); the tail
    (`_step_from_feats`) on the CPU from the card's state and the card's
    features with the same noise, against the card's step (within twice
    JAX's jit/eager spread of that step, or 1e-4: TAIL_SPREAD); the two
    whole chains ([track], [cpu]) within 1 deg."""
    from maveric_slam_tpu_torch.frontend import extractor
    from maveric_slam_tpu_torch.frontend import tracker as trk
    from maveric_slam_tpu_torch.models import superpoint as sp

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    params = {"card": sp.load_params(device=cuda), "cpu": sp.load_params(device=cpu)}
    state = trk._batched(trk.init_state(params["card"], torch.from_numpy(frames[0]).to(cuda), cfg, 0))
    fails = []
    for j, (f, (gmin, glo), g, c) in enumerate(zip(frames[1:], noises, steps, cpu_steps)):
        img = torch.from_numpy(f)[None]
        feats = extractor.extract_quantized_batched(params["card"], img.to(cuda), cfg)
        fg, fc = _to_cpu(feats), extractor.extract_quantized_batched(params["cpu"], img, cfg)
        sel_g, sel_c = (x.top.cells[x.top.mask].tolist() for x in (fg, fc))
        dxy = float((fg.xy - fc.xy)[fc.indices != 64].abs().max())
        same_cells, same_desc = sorted(sel_g) == sorted(sel_c), torch.equal(fg.desc_q, fc.desc_q)
        on_cpu = trk.TrackerState(*(x.cpu() for x in state[:-1]), generator=(torch.Generator(),))
        _, tail = trk._step_from_feats(on_cpu, fg, cfg, gmin[None], glo[None])
        state, card = trk._step_from_feats(state, feats, cfg, gmin[None].to(cuda), glo[None].to(cuda))
        card, tail = (trk.StepResult(*(x[0] for x in _to_cpu(r))) for r in (card, tail))
        _require(np.array_equal(card.R.numpy(), g["R"]) and np.array_equal(card.t.numpy(), g["t"]),
                 f"cpu-vs-card: the card's step {j}, run again, differs from [track]'s")
        dR, dt = (float((getattr(card, n) - getattr(tail, n)).abs().max()) for n in ("R", "t"))
        bar_R, bar_t = (max(2.0 * x, 1e-4) for x in TAIL_SPREAD[j])
        counts = [(int(getattr(card, n)), int(getattr(tail, n)))
                  for n in ("num_matches", "num_inliers", "num_scale_pairs")]
        same_mask = torch.equal(card.match_mask, tail.match_mask)
        _log(f"[cpu-vs-card] step {j}: features: top-N cells {'equal' if same_cells else 'DIFFER'} "
             f"({'same order' if sel_g == sel_c else 'another order'}), descriptors "
             f"{'bitwise equal' if same_desc else 'DIFFER'}, xy max |d| {dxy:.3g}; "
             f"tail (CPU on the card's state and features): max |dR| {dR:.3g} (bar {bar_R:.3g}) |dt| "
             f"{dt:.3g} (bar {bar_t:.3g}), (matches, inliers, scale pairs) card/CPU {counts}, inlier masks "
             f"{'equal' if same_mask else 'differ'}, scale "
             f"{float(card.scale):.6g}/{float(tail.scale):.6g}; total (the chains): max |dR| "
             f"{np.abs(g['R'] - c['R']).max():.3g} |dt| {np.abs(g['t'] - c['t']).max():.3g}, rot diff "
             f"{_rot_deg(g['R'], c['R']):.4f} deg, matches {c['matches']}/{g['matches']} inliers "
             f"{c['inliers']}/{g['inliers']}")
        if not (same_cells and same_desc and dxy <= 1e-3):
            fails.append(f"step {j}: the features differ beyond the detector's bars")
        if dR > bar_R or dt > bar_t:
            fails.append(f"step {j}: the tail differs by |dR| {dR:.3g} |dt| {dt:.3g} (bars {bar_R:.3g}, "
                         f"{bar_t:.3g})")
    _require(not fails, "cpu-vs-card: " + "; ".join(fails))
    _require(max(_rot_deg(g["R"], c["R"]) for g, c in zip(steps, cpu_steps)) < 1.0,
             "card and CPU rotations differ by 1 deg or more")


def phase_batched(streams, noises, cfg):
    """`track_step_batched` over S streams of 192x640 with injected noise,
    counts set to 0 just before `init_states_batched` and read after the
    last step. Every stream is checked against the ground truth and against
    a single-stream `Tracker` over its frames and noise on the card.
    Returns the step wall times (host clock, synchronised)."""
    from maveric_slam_tpu_torch.frontend import tracker
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels
    from maveric_slam_tpu_torch.utils.trajectory import relative_from_poses

    cuda = torch.device("cuda")
    params = sp.load_params(device=cuda)
    seq = torch.from_numpy(np.stack([f for f, _ in streams], axis=1)).to(cuda)  # (T, S, H, W)
    n_steps, s = seq.shape[0] - 1, seq.shape[1]
    dev_noise = [(g.to(cuda), l.to(cuda)) for g, l in noises]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    states = tracker.init_states_batched(params, seq[0], cfg)
    results, times = [], []
    for j in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, res = tracker.track_step_batched(params, states, seq[j + 1], cfg, *dev_noise[j])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        results.append(res)
    launches = kernels.launch_counts()
    _log(f"[batched] S={s} at {H}x{W}, {n_steps} steps, kernels {json.dumps(launches)}")
    expected = {"detector_postproc": n_steps + 1, "windowed_match": n_steps,
                "nullspace_inverse_iteration": 4 * n_steps, "svd3": 3 * n_steps,
                "fused_stem": n_steps + 1, "refine_pose": n_steps, "qconv": QCONV * (n_steps + 1)}
    _require(launches == expected, f"batched launches {launches}, expected {expected}")

    worst, failures, tdirs = {"dR": 0.0, "dt": 0.0, "rot": 0.0}, [], []
    for k, (frames, poses) in enumerate(streams):
        gt_R, gt_t = relative_from_poses(poses)
        steps = [{"R": r.R[k].cpu().numpy(), "t": r.t[k].cpu().numpy(),
                  "matches": int(r.num_matches[k]), "inliers": int(r.num_inliers[k]),
                  "valid": bool(r.valid[k])} for r in results]
        rot = [_rot_deg(st["R"], R) for st, R in zip(steps, gt_R)]
        tdir = [_dir_deg(st["t"], t) for st, t in zip(steps, gt_t)]
        n_ok = sum(st["valid"] and st["matches"] >= 8 for st in steps)
        single, _ = track(cuda, frames, [(g[k], l[k]) for g, l in noises], cfg)
        dR = max(float(np.abs(a["R"] - b["R"]).max()) for a, b in zip(steps, single))
        dt = max(float(np.abs(a["t"] - b["t"]).max()) for a, b in zip(steps, single))
        drot = max(_rot_deg(a["R"], b["R"]) for a, b in zip(steps, single))
        # check_poses's bars on 5 steps: 4 valid where it asks 8 of 10, every
        # rotation error under BATCHED_ROT_BAR, and the translation-direction error
        # under 25 deg at the median per stream and at the mean over all
        # streams' steps (below). One step of 5 whose translation flips
        # (121-136 deg on 3 of 16 streams, the single-stream Tracker alike)
        # would move a 5-step mean past 25 deg on its own. All streams are
        # printed before any check fails.
        tdirs.extend(tdir)
        for ok, what in ((n_ok >= n_steps - 1, f"{n_ok} valid steps with >= 8 matches"),
                         (max(rot) < BATCHED_ROT_BAR and float(np.median(tdir)) < 25.0,
                          f"pose errors {rot} {tdir}"),
                         ([a["matches"] for a in steps] == [b["matches"] for b in single],
                          "match counts differ from the single-stream run"),
                         (drot < 1.0, f"rotations differ from the single stream by {drot} deg")):
            if not ok:
                failures.append(f"batched stream {k}: {what}")
        worst = {"dR": max(worst["dR"], dR), "dt": max(worst["dt"], dt), "rot": max(worst["rot"], drot)}
        _log(f"[batched] stream {k}: valid {n_ok}/{n_steps}, matches {[a['matches'] for a in steps]}, "
             f"inliers {[a['inliers'] for a in steps]} (single {[b['inliers'] for b in single]}), "
             f"rot err max {max(rot):.3f} deg, t-dir err median {np.median(tdir):.2f} mean "
             f"{np.mean(tdir):.2f} deg; vs single: "
             f"max |dR| {dR:.3g} max |dt| {dt:.3g} rot {drot:.4f} deg")
    _log(f"[batched] all streams vs single: max |dR| {worst['dR']:.3g} max |dt| {worst['dt']:.3g} "
         f"max rot diff {worst['rot']:.4f} deg; t-dir err mean over all {len(tdirs)} steps "
         f"{np.mean(tdirs):.2f} deg")
    if not np.mean(tdirs) < 25.0:
        failures.append(f"mean t-dir error over all streams {np.mean(tdirs)} deg")
    _require(not failures, "; ".join(failures))
    return times


def phase_chunk(frames, noises, cfg):
    """`PipelinedTracker` (chunks of CHUNK) over the frames on the card, with
    its own launch counts, against `Tracker` on the same frames and noise.
    Returns the wall time of each chunk (host clock, synchronised)."""
    from maveric_slam_tpu_torch.frontend.tracker import PipelinedTracker
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels

    cuda = torch.device("cuda")
    pipe = PipelinedTracker(sp.load_params(device=cuda), cfg, chunk=CHUNK, device=cuda)
    dev_noise = [(g.to(cuda), l.to(cuda)) for g, l in noises]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    pipe.process(frames[0])
    chunk_s = []
    for c in range(0, len(frames) - 1, CHUNK):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f, nz in zip(frames[1 + c:1 + c + CHUNK], dev_noise[c:c + CHUNK]):
            pipe.process(f, *nz)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    n_steps, n_chunks = len(frames) - 1, len(chunk_s)
    _require(not pipe._buf and len(pipe.rel_poses) == n_steps, "chunked: frames left in the buffer")
    _log(f"[chunk] chunk={CHUNK}, {n_steps} steps, kernels {json.dumps(launches)}")
    expected = {"detector_postproc": n_chunks + 1, "windowed_match": n_steps,
                "nullspace_inverse_iteration": 4 * n_steps, "svd3": 3 * n_steps,
                "fused_stem": n_chunks + 1, "refine_pose": n_steps, "qconv": QCONV * (n_chunks + 1)}
    _require(launches == expected, f"chunked launches {launches}, expected {expected}")
    single, _ = track(cuda, frames, noises, cfg)
    dR = max(float(np.abs(R - b["R"]).max()) for (R, _), b in zip(pipe.rel_poses, single))
    dt = max(float(np.abs(t - b["t"]).max()) for (_, t), b in zip(pipe.rel_poses, single))
    for key in ("matches", "inliers"):
        _require([a[key] for a in pipe.stats] == [b[key] for b in single],
                 f"chunked: {key} differ from Tracker")
    _require(dR <= 1e-5 and dt <= 1e-5, f"chunked: poses differ from Tracker by {dR}, {dt}")
    _log(f"[chunk] vs Tracker: matches and inliers equal, max |dR| {dR:.3g} max |dt| {dt:.3g}; "
         f"matches {[a['matches'] for a in pipe.stats]}")
    return chunk_s


def _rotvec(w) -> np.ndarray:
    """Rotation matrix of a rotation vector (Rodrigues, float64)."""
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * kx + (1.0 - np.cos(th)) * kx @ kx


def pairwise_noise(cfg, seed=2):
    """[pairwise]'s RANSAC noise, (gumbel_min, gumbel_lo) for each of PAIRS,
    drawn on the host from a seeded generator over M = max_keypoints."""
    from maveric_slam_tpu_torch.geometry import ransac

    gen = torch.Generator().manual_seed(seed)
    n, m = cfg.ransac.num_hypotheses, cfg.frontend.max_keypoints
    return [(ransac.gumbel((n, m), gen, "cpu"), ransac.gumbel((ransac.lo_hypotheses(n), m), gen, "cpu"))
            for _ in PAIRS]


def ba_scene(seed=11, num_poses=BA_POSES, num_landmarks=BA_LANDMARKS, density=BA_DENSITY):
    """tests/test_ba.py's scene at BAConfig's size: a camera moving forward
    0.8 m a pose through a static cloud (x in [-8, 8], y in [-3, 3], z in
    [8, 30] m), 0.5 px pixel noise, poses 1.. and the points perturbed, and
    ~35% of the visible observations kept (every landmark keeps >= 2), as
    tests/test_ba.py::TestSparseBA. Returns ((K, R, t, X, uv, mask) numpy,
    (R_gt, t_gt, X_gt))."""
    rng = np.random.default_rng(seed)
    K = np.array(BA_K, np.float32)
    X = np.stack([rng.uniform(-8, 8, num_landmarks), rng.uniform(-3, 3, num_landmarks),
                  rng.uniform(8, 30, num_landmarks)], axis=-1)
    R_gt = np.stack([_rotvec(rng.normal(size=3) * 0.01) for _ in range(num_poses)]).astype(np.float32)
    t_gt = np.stack([np.array([0.0, 0.0, -0.8 * p]) + rng.normal(size=3) * 0.01
                     for p in range(num_poses)]).astype(np.float32)
    p_cam = np.einsum("pij,lj->lpi", R_gt, X) + t_gt[None]
    uv = np.stack([K[0, 0] * p_cam[..., 0] / p_cam[..., 2] + K[0, 2],
                   K[1, 1] * p_cam[..., 1] / p_cam[..., 2] + K[1, 2]], axis=-1)
    visible = ((p_cam[..., 2] > 1.0) & (uv[..., 0] > 0) & (uv[..., 0] < W)
               & (uv[..., 1] > 0) & (uv[..., 1] < H))
    uv = uv + rng.normal(size=uv.shape) * 0.5
    R0 = [R_gt[0]] + [_rotvec(rng.normal(size=3) * 0.015) @ R_gt[p] for p in range(1, num_poses)]
    t0 = [t_gt[0]] + [t_gt[p] + rng.normal(size=3) * 0.05 for p in range(1, num_poses)]
    X0 = X + rng.normal(size=X.shape) * 0.2
    mask = visible & (rng.random(visible.shape) < density)
    need = mask.sum(1) < 2
    mask[need, :2] = visible[need, :2]
    scene = (K, np.stack(R0).astype(np.float32), np.stack(t0).astype(np.float32),
             X0.astype(np.float32), uv.astype(np.float32), mask)
    return scene, (R_gt, t_gt, X)


def loop_graph(n=GRAPH_NODES, pad_nodes=GRAPH_PAD_NODES, pad_edges=GRAPH_PAD_EDGES, drift=0.02,
               seed=33):
    """tests/test_pose_graph.py's drifting loop at slam.py's size: n poses
    1 m apart around a circle (world-from-camera), odometry measured with
    drift (0.01 rad and 0.02 m of noise an edge), the initial poses its
    integral, and 4 loop edges from the last two poses to the first two at
    the truth (weight 10); nodes padded with identity poses to `pad_nodes`
    and edges with weight-0 identity edges (0, 0) to `pad_edges`, as
    slam.py:1134-1150 pads. Returns (PoseGraph fields as numpy, (R_gt, t_gt))."""
    rng = np.random.default_rng(seed)
    R_gt = np.stack([_rotvec([0.0, 2 * np.pi * i / n, 0.0]) for i in range(n)])
    t_gt = np.zeros((n, 3))
    for i in range(1, n):
        t_gt[i] = t_gt[i - 1] + R_gt[i - 1] @ np.array([0.0, 0.0, 1.0])

    def rel(i, j):  # T_ci_cj
        return R_gt[i].T @ R_gt[j], R_gt[i].T @ (t_gt[j] - t_gt[i])

    edges, R_m, t_m, w = [], [], [], []
    for i in range(n - 1):
        Rr, tr = rel(i, i + 1)
        edges.append((i, i + 1))
        R_m.append(_rotvec(rng.normal(size=3) * drift * 0.5) @ Rr)
        t_m.append(tr + rng.normal(size=3) * drift)
        w.append(1.0)
    R0, t0 = [R_gt[0]], [t_gt[0]]
    for i in range(n - 1):
        t0.append(t0[-1] + R0[-1] @ t_m[i])
        R0.append(R0[-1] @ R_m[i])
    for i, j in ((n - 1, 0), (n - 2, 0), (n - 1, 1), (n - 2, 1)):
        Rr, tr = rel(i, j)
        edges.append((i, j))
        R_m.append(Rr)
        t_m.append(tr)
        w.append(10.0)
    e, dn, de = len(edges), pad_nodes - n, pad_edges - len(edges)
    fields = (
        np.concatenate([np.stack(R0), np.tile(np.eye(3), (dn, 1, 1))]).astype(np.float32),
        np.concatenate([np.stack(t0), np.zeros((dn, 3))]).astype(np.float32),
        np.pad(np.array([a for a, _ in edges], np.int64), (0, de)),
        np.pad(np.array([b for _, b in edges], np.int64), (0, de)),
        np.concatenate([np.stack(R_m), np.tile(np.eye(3), (de, 1, 1))]).astype(np.float32),
        np.concatenate([np.stack(t_m), np.zeros((de, 3))]).astype(np.float32),
        np.pad(np.array(w, np.float32), (0, de)),
    )
    assert e <= pad_edges and n <= pad_nodes
    return fields, (R_gt.astype(np.float32), t_gt.astype(np.float32))


def _wall_ms(fn, calls, warmup=2):
    """Median host-clock ms of `calls` synchronised calls after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def run_pairwise(dev, frames, noise, cfg):
    """`pairwise_pose` on each of PAIRS on `dev`; host copies of the results."""
    from maveric_slam_tpu_torch.frontend import pairwise
    from maveric_slam_tpu_torch.models import superpoint as sp

    params = sp.load_params(device=dev)
    out = []
    for (a, b), (gmin, glo) in zip(PAIRS, noise):
        r = pairwise.pairwise_pose(params, torch.from_numpy(frames[a]).to(dev),
                                   torch.from_numpy(frames[b]).to(dev), cfg, gmin.to(dev), glo.to(dev))
        out.append({"R": r.R.cpu().numpy(), "t": r.t.cpu().numpy(), "E": r.E.cpu().numpy(),
                    "matches": int(r.num_matches), "inliers": int(r.num_inliers)})
    return out


def _golden_matches(dev, img0, img1, cfg):
    from maveric_slam_tpu_torch.frontend import extractor
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import matching

    params = sp.load_params(device=dev)
    f0 = extractor.extract_golden(params, torch.from_numpy(img0).to(dev), cfg)
    f1 = extractor.extract_golden(params, torch.from_numpy(img1).to(dev), cfg)
    m = matching.nn_match_dot(f0.desc, f1.desc, f0.mask, f1.mask, dot_thresh=cfg.matcher.dot_thresh)
    dots = torch.where(f1.mask[None], f0.desc @ f1.desc.T, -torch.inf)
    second = torch.topk(dots, 2, dim=-1).values[:, 1]
    return {k: v.cpu() for k, v in dict(xy0=f0.xy, xy1=f1.xy, index=m.index, score=m.score,
                                        mask=m.mask, second=second).items()}


def explain_pairwise_counts(frames, cfg, pair):
    """Where the card's and the CPU's match counts differ: the keypoints that
    moved and each match that differs, with its best dot on both devices,
    its gap to the 0.8 threshold and to the runner-up."""
    a, b = pair
    g = _golden_matches(torch.device("cuda"), frames[a], frames[b], cfg)
    c = _golden_matches(torch.device("cpu"), frames[a], frames[b], cfg)
    moved = int((g["xy0"] != c["xy0"]).any(-1).sum() + (g["xy1"] != c["xy1"]).any(-1).sum())
    diff = ((g["mask"] != c["mask"]) | (g["mask"] & (g["index"] != c["index"]))).nonzero()[:, 0]
    _log(f"[pairwise]   pair {pair}: {moved} golden keypoints at other positions, "
         f"{len(diff)} matches differ")
    for i in diff.tolist():
        _log(f"[pairwise]     query {i}: card -> {int(g['index'][i])} dot {float(g['score'][i]):.7f} "
             f"(gap to 0.8 {float(g['score'][i]) - 0.8:.3g}, to runner-up "
             f"{float(g['score'][i] - g['second'][i]):.3g}), cpu -> {int(c['index'][i])} dot "
             f"{float(c['score'][i]):.7f}")


def phase_pairwise(frames, poses, cfg):
    """`pairwise_pose` at 192x640 (K = M = 1000 keypoints, 256 + 64
    hypotheses) on PAIRS, counts set to 0 just before and read just after;
    the poses against the orbit's ground truth at bars taken from the JAX
    package's own errors; card against CPU; the wall time of a call.
    Returns (launches a call, the kernels' pairwise inputs, the call for the
    profiler)."""
    from maveric_slam_tpu_torch.frontend import pairwise
    from maveric_slam_tpu_torch.geometry import epipolar
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels, softmax_topn as st
    from maveric_slam_tpu_torch.ops.kernels import nullspace
    from maveric_slam_tpu_torch.utils.trajectory import relative_from_poses

    cuda = torch.device("cuda")
    noise = pairwise_noise(cfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    card = run_pairwise(cuda, frames, noise, cfg)
    launches = kernels.launch_counts()
    n = len(PAIRS)
    per_call = {"detector_postproc": 0, "windowed_match": 0, "nullspace_inverse_iteration": 4,
                "svd3": 3, "fused_stem": 2, "refine_pose": 0, "qconv": 2 * QCONV}
    _log(f"[pairwise] {len(PAIRS)} calls at {H}x{W}, K = M = {cfg.frontend.max_keypoints}, "
         f"kernels {json.dumps(launches)}")
    _require(launches == {k: v * n for k, v in per_call.items()},
             f"pairwise launches {launches}, expected {per_call} a call")
    cpu = run_pairwise(torch.device("cpu"), frames, noise, cfg)
    for (a, b), g, c in zip(PAIRS, card, cpu):
        gt_R, gt_t = relative_from_poses(poses[[a, b]])
        rot, tdir = _rot_deg(g["R"], gt_R[0]), _dir_deg(g["t"], gt_t[0])
        rot_bar, tdir_bar = PAIRWISE_BARS[(a, b)]
        drot = _rot_deg(g["R"], c["R"])
        _log(f"[pairwise] frames {a}->{b}: matches {g['matches']} inliers {g['inliers']}; rot err "
             f"{rot:.4f} deg (bar {rot_bar}) t-dir err {tdir:.3f} deg (bar {tdir_bar}); vs CPU: matches "
             f"{c['matches']} inliers {c['inliers']}, rot diff {drot:.5f} deg, max |dR| "
             f"{np.abs(g['R'] - c['R']).max():.3g} max |dt| {np.abs(g['t'] - c['t']).max():.3g}")
        _require(rot < rot_bar and tdir < tdir_bar, f"pairwise {a}->{b}: pose errors {rot}, {tdir}")
        _require(drot < 1.0, f"pairwise {a}->{b}: card and CPU rotations differ by {drot} deg")
        if (g["matches"], g["inliers"]) != (c["matches"], c["inliers"]):
            explain_pairwise_counts(frames, cfg, (a, b))

    params = sp.load_params(device=cuda)
    (a, b), (gmin, glo) = PAIRS[0], (x.to(cuda) for x in noise[0])
    img0, img1 = (torch.from_numpy(frames[k]).to(cuda) for k in (a, b))

    def call():
        return pairwise.pairwise_pose(params, img0, img1, cfg, gmin, glo)

    med, times = _wall_ms(call, PAIRWISE_CALLS)
    _log(f"[pairwise] wall {med:.3f} ms a call (median of {PAIRWISE_CALLS} after 2 warm-ups; all "
         f"{' '.join(f'{t:.3f}' for t in times)})")
    # The nullspace and svd3 kernels' pairwise inputs: the minimal
    # hypotheses' 8-point normal matrices at M = 1000 and their nullspaces.
    g = _golden_matches(cuda, frames[a], frames[b], cfg)
    K = torch.from_numpy(cfg.working_camera.K)
    p1 = epipolar.normalize_points(g["xy0"], K).to(cuda)
    p2 = epipolar.normalize_points(g["xy1"][g["index"].long()], K).to(cuda)
    idx = st.top_k(torch.where(g["mask"].to(cuda), 0.0, -torch.inf) + gmin, 8)[1]
    A = epipolar.eight_point_design(p1[idx], p2[idx])
    ata = A.transpose(-1, -2) @ A
    return per_call, {"ata": ata, "E": nullspace.nullspace_plain(ata).reshape(-1, 3, 3), "p1": p1,
                      "p2": p2, "mask": g["mask"].to(cuda), "gmin": gmin, "glo": glo}, call


def check_pairwise_kernels(pw_inp):
    """The nullspace and svd3 kernels against their plain versions on the
    pairwise path's inputs, at the bars of phase_kernels; returns their
    largest errors."""
    from maveric_slam_tpu_torch.ops.kernels import nullspace, svd3

    ata, E = pw_inp["ata"], pw_inp["E"]
    got, ref = nullspace.nullspace_inverse_iteration(ata), nullspace.nullspace_plain(ata)
    dn = float((got * torch.sign(torch.sum(ref * got, -1, keepdim=True)) - ref).abs().max())
    U, s3, V = svd3.svd3(E)
    ds = float((s3 - svd3.svd3_plain(E)[1]).abs().max())
    m = max(1.0, float(E.abs().max()))
    recon = float((U @ torch.diag_embed(s3) @ V.transpose(-1, -2) - E).abs().max())
    _log(f"[pairwise] kernels at M=1000: nullspace {tuple(ata.shape)} sign-aligned max |dx| {dn:.3g} "
         f"(bar 1e-3); svd3 {tuple(E.shape)} max |ds| {ds:.3g}, recon {recon:.3g} (bars 2e-4, 1e-3 x {m:.3g})")
    _require(dn <= 1e-3 and ds <= 2e-4 * m and recon <= 1e-3 * m, "pairwise kernels: outside the bars")
    return {"nullspace_err": dn, "svd3_err": ds}


def _nms_explained(cell, probs, rtol=1e-6):
    """The neighbours of `cell` (r, c) whose prob lies within rtol of its own."""
    r, c = cell
    hc, wc = probs.shape
    p = float(probs[r, c])
    return [(r + dr, c + dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)
            if (dr or dc) and 0 <= r + dr < hc and 0 <= c + dc < wc
            and abs(float(probs[r + dr, c + dc]) - p) <= rtol * max(abs(p), 1e-30)]


def phase_nms(frames, streams, cfg):
    """`extract_quantized(apply_nms=True)` at S = 1 and
    `extract_quantized_batched` at S = 16, card against CPU: the suppressed
    cells must be equal, except where a neighbour's prob lies within the
    detector's card bar (rtol 1e-6) of the cell's, which is listed."""
    from maveric_slam_tpu_torch.frontend import extractor
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels

    cuda = torch.device("cuda")
    pg, pc = sp.load_params(device=cuda), sp.load_params(device="cpu")
    for label, imgs in (("S=1", frames[1][None]), (f"S={len(streams)}", np.stack([f[1] for f in streams]))):
        x = torch.from_numpy(imgs)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        if len(imgs) == 1:
            gi = extractor.extract_quantized(pg, x[0].to(cuda), cfg, apply_nms=True).indices[None]
        else:
            gi = extractor.extract_quantized_batched(pg, x.to(cuda), cfg, apply_nms=True).indices
        launches = kernels.launch_counts()
        _require(launches["fused_stem"] == 1 and launches["detector_postproc"] == 1,
                 f"nms {label}: launches {launches}")
        c = extractor.extract_quantized_batched(pc, x, cfg, apply_nms=True)
        raw = extractor.extract_quantized_batched(pg, x.to(cuda), cfg).indices.cpu()  # argmax: exact on both
        gi, ci, cp = gi.cpu(), c.indices, c.probs
        sup_g, sup_c = (raw != 64) & (gi == 64), (raw != 64) & (ci == 64)
        listed = []
        for s, r, col in (gi != ci).nonzero().tolist():
            near = _nms_explained((r, col), cp[s])
            listed.append((s, r, col, near))
            _log(f"[nms] {label} stream {s} cell ({r}, {col}): card index {int(gi[s, r, col])}, CPU "
                 f"{int(ci[s, r, col])}; neighbours within rtol 1e-6: {near}")
        _require(all(near for *_, near in listed), f"nms {label}: unexplained differences {listed}")
        _log(f"[nms] {label}: kernels {json.dumps(launches)}; suppressed cells card "
             f"{int(sup_g.sum())}, CPU {int(sup_c.sum())}, {len(listed)} cells differ "
             f"(all beside a tie within rtol 1e-6); of {int((raw != 64).sum())} keypoint cells")


def _ba_problem(dev, scene):
    from maveric_slam_tpu_torch.backend import ba

    return ba.BAProblem(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in scene))


def _reproj_rmse(problem):
    from maveric_slam_tpu_torch.backend import ba

    r, _, _ = ba._residuals(problem)
    return float(torch.sqrt(torch.mean(torch.sum(r * r, dim=-1)[problem.mask])))


def phase_ba(cfg):
    """Dense and factor-list `bundle_adjust` at BAConfig's size (P = 8,
    L = 1024, 10 iterations, its damping and Huber delta) on `ba_scene`:
    the cost never rises, the final RMSE within the JAX package's, sparse
    equal to dense at tests/test_ba.py's tolerances, card against CPU.
    Returns the calls for the profiler."""
    from maveric_slam_tpu_torch.backend import ba, sparse_ba

    bc = cfg.ba
    scene, _ = ba_scene()
    kw = dict(iterations=bc.max_iterations, damping=bc.lm_damping, huber_delta=bc.huber_delta)
    out = {}
    for name in ("cuda", "cpu"):
        prob = _ba_problem(torch.device(name), scene)
        sparse = sparse_ba.from_dense(prob)
        out[name] = (prob, ba.bundle_adjust(prob, **kw), sparse, sparse_ba.bundle_adjust(sparse, **kw))
    prob, (dense, stats), sparse, (solved_s, costs_s) = out["cuda"]
    _, (dense_c, stats_c), _, (solved_sc, _) = out["cpu"]
    rmse0, rmse, rmse_s = _reproj_rmse(prob), _reproj_rmse(dense), _reproj_rmse(dense._replace(
        R=solved_s.R, t=solved_s.t, X=solved_s.X))
    c, cs = stats.cost.cpu().numpy(), costs_s.cpu().numpy()
    _log(f"[ba] P={prob.R.shape[0]} L={prob.X.shape[0]} {int(stats.num_factors)} observations "
         f"({100 * float(prob.mask.float().mean()):.1f}%), {bc.max_iterations} iterations: cost "
         f"{' '.join(f'{v:.6g}' for v in c)}; RMSE {rmse0:.4f} -> dense {rmse:.5f} px, sparse "
         f"{rmse_s:.5f} px (bar {BA_RMSE_BAR} px)")
    _require(np.all(np.diff(c) <= 0) and np.all(np.diff(cs) <= 0), f"ba: cost rose {c} {cs}")
    _require(rmse < BA_RMSE_BAR and rmse_s < BA_RMSE_BAR, f"ba: RMSE {rmse}, {rmse_s}")
    gap = {f: float((getattr(solved_s, f) - getattr(dense, f)).abs().max()) for f in "RtX"}
    _log(f"[ba] sparse vs dense on the card: max |dR| {gap['R']:.3g} |dt| {gap['t']:.3g} "
         f"|dX| {gap['X']:.3g}, costs rtol {float(np.abs(cs / c - 1).max()):.3g} "
         f"(bars 2e-4, 2e-3, 5e-3, 1e-3)")
    _require(gap["R"] <= 2e-4 and gap["t"] <= 2e-3 and gap["X"] <= 5e-3
             and np.allclose(cs, c, rtol=1e-3), f"ba: sparse differs from dense {gap}")
    for label, a, b in (("dense", dense, dense_c), ("sparse", solved_s, solved_sc)):
        d = {f: float((getattr(a, f).cpu() - getattr(b, f)).abs().max()) for f in "RtX"}
        _log(f"[ba] {label} card vs CPU: max |dR| {d['R']:.3g} |dt| {d['t']:.3g} |dX| {d['X']:.3g} "
             f"(bars: R 1e-4, t 1e-3)")
        _require(d["R"] <= 1e-4 and d["t"] <= 1e-3, f"ba {label}: card and CPU poses differ {d}")

    calls = {"bundle_adjust (dense)": lambda: ba.bundle_adjust(prob, **kw),
             "bundle_adjust (sparse)": lambda: sparse_ba.bundle_adjust(sparse, **kw)}
    one = dict(kw, iterations=1)
    for (name, fn), fn1 in zip(calls.items(), (lambda: ba.bundle_adjust(prob, **one),
                                               lambda: sparse_ba.bundle_adjust(sparse, **one))):
        med, _ = _wall_ms(fn, 10)
        med1, _ = _wall_ms(fn1, 10)
        _log(f"[ba] {name}: wall {med:.3f} ms a call of {bc.max_iterations} iterations, "
             f"{(med - med1) / (bc.max_iterations - 1):.3f} ms an iteration (median of 10)")
    return calls


def graph_gaps(a, b, n):
    """Max |dR| and |dt| between two solutions (R, t) of a pose graph over
    its first n poses, and between their consecutive relative poses
    T_i^-1 T_(i+1) ("rel R", "rel t"), in float64."""
    (Ra, ta), (Rb, tb) = ((np.asarray(R, np.float64)[:n], np.asarray(t, np.float64)[:n]) for R, t in (a, b))

    def rel(R, t):
        Rt = R[:-1].transpose(0, 2, 1)
        return Rt @ R[1:], np.einsum("nij,nj->ni", Rt, t[1:] - t[:-1])

    (rRa, rta), (rRb, rtb) = rel(Ra, ta), rel(Rb, tb)
    return {"R": float(np.abs(Ra - Rb).max()), "t": float(np.abs(ta - tb).max()),
            "rel R": float(np.abs(rRa - rRb).max()), "rel t": float(np.abs(rta - rtb).max())}


def phase_pose_graph():
    """`pose_graph.optimize` at slam.py's size (256 nodes, 288 edges with
    weight-0 padding, 8 iterations) on `loop_graph`: drift reduced as
    tests/test_pose_graph.py requires, card against CPU, two calls on the
    card bitwise equal ([resume] needs it). Returns the call for the
    profiler."""
    from maveric_slam_tpu_torch.backend import pose_graph

    fields, (_, t_gt) = loop_graph()
    n = t_gt.shape[0]
    res = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        graph = pose_graph.PoseGraph(*(torch.from_numpy(a).to(dev) for a in fields))
        res[name] = (graph, *pose_graph.optimize(graph, iterations=GRAPH_ITERS))
    graph, opt, costs = res["cuda"]
    _, opt_c, costs_c = res["cpu"]
    c = costs.cpu().numpy()
    before = np.linalg.norm(fields[1][:n] - t_gt, axis=-1)
    after = np.linalg.norm(opt.t.cpu().numpy()[:n] - t_gt, axis=-1)
    _log(f"[pose-graph] {graph.R.shape[0]} nodes ({n} real), {graph.edge_i.shape[0]} edges "
         f"({int((graph.weight > 0).sum())} weighted), {GRAPH_ITERS} iterations: cost "
         f"{' '.join(f'{v:.6g}' for v in c)}; position error mean {before.mean():.4f} -> "
         f"{after.mean():.4f} m, last pose {before[-1]:.4f} -> {after[-1]:.4f} m")
    _require(c[-1] < c[0] / 100 and after.mean() < before.mean() and after[-1] < GRAPH_END_BAR,
             f"pose graph: drift not reduced ({c[0]} -> {c[-1]}, {after.mean()}, {after[-1]})")
    gaps = graph_gaps((opt.R.cpu(), opt.t.cpu()), (opt_c.R, opt_c.t), n)
    gaps["cost"] = abs(float(costs[-1]) / float(costs_c[-1]) - 1.0)
    _log(f"[pose-graph] card vs CPU: {', '.join(f'{k} {v:.3g}' for k, v in gaps.items())} (bars "
         f"{GRAPH_CARD_BARS}); costs CPU {' '.join(f'{v:.6g}' for v in costs_c.numpy())}")
    _require(all(gaps[k] <= bar for k, bar in GRAPH_CARD_BARS.items()),
             f"pose graph: card and CPU differ by {gaps}")

    def call():
        return pose_graph.optimize(graph, iterations=GRAPH_ITERS)

    again, again_costs = call()
    same = all(torch.equal(x, y) for x, y in ((opt.R, again.R), (opt.t, again.t), (costs, again_costs)))
    _log(f"[pose-graph] two calls on one graph on the card: {'bitwise equal' if same else 'DIFFER'}")
    _require(same, "pose graph: two calls on one graph differ on the card")
    med, _ = _wall_ms(call, 10)
    med1, _ = _wall_ms(lambda: pose_graph.optimize(graph, iterations=1), 10)
    _log(f"[pose-graph] wall {med:.3f} ms a call of {GRAPH_ITERS} iterations, "
         f"{(med - med1) / (GRAPH_ITERS - 1):.3f} ms an iteration (median of 10)")
    return call


def slam_scene(cfg, renders):
    """[slam]'s frames (orbit index k % ORBIT_N, rendered once each, on a
    thread pool), ground truth and tracking noise (from a seeded host
    generator, so that the CPU run can take the same)."""
    from concurrent.futures import ThreadPoolExecutor

    from maveric_slam_tpu_torch.data import synthetic
    from maveric_slam_tpu_torch.geometry import ransac

    orbit = synthetic.orbit_poses(ORBIT_N)
    idx = np.arange(SLAM_FRAMES) % ORBIT_N
    todo = sorted(set(idx.tolist()) - set(renders))
    K = cfg.working_camera.K
    with ThreadPoolExecutor(8) as pool:
        for k, img in zip(todo, pool.map(lambda k: synthetic.render_box_room(K, orbit[k], H, W), todo)):
            renders[k] = img
    gen = torch.Generator().manual_seed(3)
    m, k = cfg.frontend.top_n, cfg.ransac.num_hypotheses
    noises = [(ransac.gumbel((k, m), gen, "cpu"), ransac.gumbel((ransac.lo_hypotheses(k), m), gen, "cpu"))
              for _ in range(SLAM_FRAMES - 1)]
    return [renders[k] for k in idx], orbit[idx], noises


def run_slam(dev, frames, noises, cfg, save_at=None, ckpt_dir=None):
    """`SlamSystem` on `dev` over the frames with the tracking noise
    injected; launch counts set to 0 just before it starts. Returns the
    engine, a record per frame (host wall, launch counts after it, its packed
    step's word ids, cells, descriptors and sightings) and the wall times of
    each window BA (dispatch + apply) and loop verification (+ pose graph
    when accepted). With `save_at`, the engine is checkpointed into
    `ckpt_dir` after that frame, outside the frame's wall (spans["save"])."""
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels
    from maveric_slam_tpu_torch.slam import SlamSystem
    from maveric_slam_tpu_torch.utils import checkpoint

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    slam = SlamSystem(sp.load_params(device=dev), cfg, ba_every=SLAM_BA_EVERY,
                      enable_loop_closure=True, fetch_delay=0, device=dev)
    spans = {"ba": [], "loop": [], "verify": []}
    views = []
    unpack, dispatch, apply = slam._packer.unpack, slam._dispatch_window_ba, slam._apply_pending_ba
    close, verify = slam._verify_and_close_loop, slam._verify_loop

    def keep(flat):
        v = unpack(flat)
        views.append({"word_ids": v.word_ids, "cells": v.cells_new, "desc": v.desc_top,
                      "desc_scale": v.desc_scale, "sightings": v.sightings})
        return v

    def timed(fn, sink, when=lambda: True):
        def run(*a):
            if not when():
                return fn(*a)
            sync()
            t0 = time.perf_counter()
            out = fn(*a)
            sync()
            sink.append((time.perf_counter() - t0, out))
            return out
        return run

    slam._packer.unpack = keep
    slam._dispatch_window_ba = timed(dispatch, spans["ba"])
    slam._apply_pending_ba = timed(apply, spans["ba"], lambda: slam._pending_ba is not None)
    slam._verify_and_close_loop = timed(close, spans["loop"])
    flats = []

    def verify_keep(flat):
        flats.append(flat)
        return verify(flat)

    slam._verify_loop = timed(verify_keep, spans["verify"])
    sync()
    kernels.reset_launch_counts()
    record = []
    for j, f in enumerate(frames):
        sync()
        t0 = time.perf_counter()
        slam.process(f, *(() if j == 0 else noises[j - 1]))
        sync()
        record.append({"wall": time.perf_counter() - t0, "launches": kernels.launch_counts()})
        if j == save_at:
            t0 = time.perf_counter()
            checkpoint.save(slam, ckpt_dir)
            spans["save"] = time.perf_counter() - t0
    slam.finish()
    launches = kernels.launch_counts()
    for r, v in zip(record[1:], views):
        r.update(v)
    # dispatch and apply alternate at fetch_delay 0: one BA window is a pair
    ba = [a[0] + b[0] for a, b in zip(spans["ba"][::2], spans["ba"][1::2])]
    spans["flats"] = flats
    return slam, record, launches, ba, spans


def _launch_patterns(record):
    """The run's per-frame launch counts: {counts as JSON: [frames]}."""
    out, prev = {}, {k: 0 for k in record[0]["launches"]}
    for j, r in enumerate(record):
        out.setdefault(json.dumps({k: v - prev[k] for k, v in r["launches"].items()}), []).append(j)
        prev = r["launches"]
    return out


def phase_slam(cfg, renders):
    """The engine the `track` CLI runs, at DEFAULT_CONFIG's width (192x640,
    top_n 100, the 10 x 1000-word vocabulary, a 4096-frame LCD ring, an
    8-pose x 1024-landmark BA window) on the card: every step valid, the
    median inlier count, loop closures on the revisit arc with the right
    frames, the full engine's ATE against the odometry-only ATE; launch
    counts per frame and per loop verification; host wall per frame, per BA
    window and per loop closure. Returns the scene, the engine and its
    records for [slam-cpu] and the profiler."""
    from maveric_slam_tpu_torch.utils import evaluation

    import tempfile

    frames, gt, noises = slam_scene(cfg, renders)
    cuda = torch.device("cuda")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    slam, record, launches, ba_s, spans = run_slam(cuda, frames, noises, cfg, SLAM_SAVE_AT, ckpt)
    n, v = len(frames), slam.verifications
    for counts, js in sorted(_launch_patterns(record).items(), key=lambda kv: -len(kv[1])):
        _log(f"[slam] {len(js)} frames launch {counts} each: frames "
             f"{js if len(js) < 80 else f'{js[:3]} .. {js[-3:]}'}")
    expected = {"detector_postproc": n, "windowed_match": n - 1,
                "nullspace_inverse_iteration": 4 * (n - 1) + 4 * v, "svd3": 3 * (n - 1) + 3 * v,
                "fused_stem": n, "refine_pose": n - 1, "qconv": QCONV * n}
    _log(f"[slam] {n} frames at {H}x{W}, {v} loop verifications, kernels {json.dumps(launches)} "
         f"(expected {json.dumps(expected)}: 1 stem, 1 detector a frame, 1 match, 4 nullspace, "
         f"3 svd3, 1 refine_pose a tracked frame, 4 nullspace and 3 svd3 a verification)")
    _require(launches == expected, f"slam launches {launches}, expected {expected}")

    st = slam.stats
    lost = {j + 1 for j, s in enumerate(st) if not s["valid"]}
    traj, odo = slam.trajectory(), slam.odometry_trajectory()
    full, odom = evaluation.ate(traj, gt), evaluation.ate(odo, gt)
    inl = [s["inliers"] for s in st]
    ev = [(e.frame, e.matched_frame, e.num_inliers, round(e.score, 4)) for e in slam.loop_events]
    _log(f"[slam] valid {sum(s['valid'] for s in st)}/{len(st)} (frames not valid: {sorted(lost)}; "
         f"allowed: {sorted(SLAM_LOST_AS_JAX)}), inliers median {np.median(inl)} "
         f"min {min(inl)}; keyframes {len(slam.kf_frames)}; loop closures (frame, matched, inliers, "
         f"score) {ev}")
    _log(f"[slam] inliers a frame: {' '.join(str(i) for i in inl)}")
    _log(f"[slam] ATE full engine {full['ate_rmse']:.4f} m, odometry only {odom['ate_rmse']:.4f} m "
         f"(ratio {full['ate_rmse'] / odom['ate_rmse']:.4f}, bar {SLAM_ATE_RATIO}), scale "
         f"{full['scale']:.4f} / {odom['scale']:.4f}")
    wall = np.array([r["wall"] for r in record[1:]]) * 1e3
    _log(f"[slam] wall a frame median {np.median(wall):.3f} ms, p90 {np.percentile(wall, 90):.3f} ms, "
         f"max {wall.max():.3f} ms; engine {n / (sum(r['wall'] for r in record)):.2f} frames/s over "
         f"{n} frames")
    _log(f"[slam] window BA: {len(ba_s)} windows, wall median {1e3 * np.median(ba_s):.3f} ms, max "
         f"{1e3 * max(ba_s):.3f} ms (dispatch + apply)")
    acc = [s for s, out in spans["loop"] if out is not None]
    rej = [s for s, out in spans["loop"] if out is None]
    ver = [s for s, _ in spans["verify"]]
    _log(f"[slam] loop verification: {len(ver)} calls, wall median "
         f"{1e3 * np.median(ver) if ver else float('nan'):.3f} ms; "
         f"closures accepted {len(acc)} (verification + pose graph: median "
         f"{1e3 * np.median(acc) if acc else float('nan'):.3f} ms, max "
         f"{1e3 * max(acc) if acc else float('nan'):.3f} ms), rejected {len(rej)}")

    checks = [
        (lost <= SLAM_LOST_AS_JAX, f"steps not valid at frames {sorted(lost)}"),
        (np.median(inl) >= SLAM_MIN_MEDIAN_INLIERS, f"median inliers {np.median(inl)}"),
        (bool(slam.loop_events), "no loop closure on the closing orbit"),
        (all(abs(e.frame - e.matched_frame - ORBIT_N) <= SLAM_GAP_BAR for e in slam.loop_events),
         f"loop pairs off the revisit {ev}"),
        (all(e.num_inliers >= SLAM_MIN_LOOP_INLIERS for e in slam.loop_events), f"loop inliers {ev}"),
        (full["ate_rmse"] < SLAM_ATE_RATIO * odom["ate_rmse"],
         f"ATE {full['ate_rmse']} not below {SLAM_ATE_RATIO} x odometry {odom['ate_rmse']}"),
    ]
    _require(all(ok for ok, _ in checks), "slam: " + "; ".join(w for ok, w in checks if not ok))
    flat = spans["flats"][0] if spans["flats"] else None
    return {"frames": frames, "noises": noises, "slam": slam, "record": record,
            "launches": launches, "verify_flat": flat, "ckpt": ckpt, "save_s": spans["save"],
            "gt": gt, "ba_windows": ba_s}


def phase_slam_cpu(cfg, run):
    """[slam]'s first SLAM_CPU_FRAMES frames through the port on the CPU with
    the same noise: per frame the (cell, word id) pairs and the pool's
    sightings equal the card's, and the counts; the pose differences per
    step (bar: 1 deg, Faults (g)). Then `assign_words` and `lcd.query` on the
    card against the CPU on the run's own descriptors and database."""
    from maveric_slam_tpu_torch.loopclosure import lcd, vocab as vocab_lib

    n = SLAM_CPU_FRAMES
    card = run["slam"]
    cpu, record, _, _, _ = run_slam(torch.device("cpu"), run["frames"][:n], run["noises"], cfg)
    failures = []
    for j in range(1, n):
        g, c = run["record"][j], record[j]
        same_order = np.array_equal(g["word_ids"], c["word_ids"])
        pairs = [sorted(zip(r["cells"][r["cells"] >= 0].tolist(), r["word_ids"][r["cells"] >= 0].tolist()))
                 for r in (g, c)]
        sights = np.array_equal(g["sightings"], c["sightings"])
        gs, cs = card.stats[j - 1], cpu.stats[j - 1]
        counts = all(gs[k] == cs[k] for k in ("matches", "inliers", "valid"))
        (gR, gt_), (cR, ct) = card.rel_poses[j - 1], cpu.rel_poses[j - 1]
        rot = _rot_deg(gR, cR)
        _log(f"[slam-cpu] frame {j}: (cell, word) pairs {'equal' if pairs[0] == pairs[1] else 'DIFFER'}"
             f" (in the same order: {same_order}), sightings {'equal' if sights else 'DIFFER'}, matches "
             f"{gs['matches']}/{cs['matches']} inliers {gs['inliers']}/{cs['inliers']}; max |dR| "
             f"{np.abs(gR - cR).max():.3g} max |dt| {np.abs(gt_ - ct).max():.3g} rot diff {rot:.4f} deg")
        for ok, what in ((pairs[0] == pairs[1], "word ids"), (sights, "sightings"), (counts, "counts"),
                         (rot < 1.0, f"rotation {rot} deg")):
            if not ok:
                failures.append(f"frame {j}: {what}")
    _require(card.kf_frames[:len(cpu.kf_frames)] == cpu.kf_frames, "slam-cpu: keyframes differ")

    # assign_words on the card against the CPU, on the run's own descriptors.
    vg, vc = card.vocab, vocab_lib.load_reference_vocabulary(device="cpu")
    recs = run["record"][1::10]
    for r in recs:
        mask = torch.from_numpy(r["cells"] >= 0)
        desc, scale = torch.from_numpy(r["desc"]), torch.tensor(float(r["desc_scale"]))
        a = vocab_lib.assign_words(desc.to(card.device), scale.to(card.device), mask.to(card.device), vg)
        b = vocab_lib.assign_words(desc, scale, mask, vc)
        if not all(torch.equal(x.cpu(), y) for x, y in zip(a, b)):
            failures.append("assign_words card differs from the CPU")
        if not np.array_equal(b.word_id.numpy(), r["word_ids"]):
            failures.append("assign_words differs from the engine's word ids")
    # lcd.query on the card against the CPU, on the run's database.
    db = card.db
    db_cpu = db._replace(**{k: getattr(db, k).cpu() for k in ("multihot", "counts", "frames", "valid")})
    frame = len(run["frames"]) - 1
    kfs = [kf for kf in card.kf_frames[-8:] if kf > 0]  # frame 0 has no step
    for kf in kfs:
        ids = torch.from_numpy(run["record"][kf]["word_ids"])
        a = lcd.query(db, ids.to(card.device), frame, cfg.loop.min_frame_gap, cfg.loop.min_score)
        b = lcd.query(db_cpu, ids, frame, cfg.loop.min_frame_gap, cfg.loop.min_score)
        if not all(torch.equal(x.cpu(), y) for x, y in zip(a, b)):
            failures.append(f"lcd.query of keyframe {kf}: card differs from the CPU")
    _log(f"[slam-cpu] assign_words on {len(recs)} of the run's frames and lcd.query of "
         f"{len(kfs)} keyframes against the run's database ({int(db.valid.sum())} "
         f"stored frames): card {'equal to' if not failures else 'against'} the CPU")
    _require(not failures, "slam-cpu: " + "; ".join(failures))


def _state_differences(a, b):
    """The names of what differs between two engines' checkpoint states
    (arrays bitwise, dtypes included; meta fields), and their trajectories."""
    from maveric_slam_tpu_torch.utils import checkpoint

    (xa, ma), (xb, mb) = checkpoint.engine_state(a), checkpoint.engine_state(b)
    diff = [k for k in sorted(set(xa) | set(xb)) if k not in xa or k not in xb
            or xa[k].dtype != xb[k].dtype or not np.array_equal(xa[k], xb[k])]
    diff += [f"meta {k}" for k in sorted(set(ma) | set(mb)) if ma.get(k) != mb.get(k)]
    diff += [fn for fn in ("trajectory", "odometry_trajectory")
             if not np.array_equal(getattr(a, fn)(), getattr(b, fn)())]
    return diff


def phase_resume(cfg, run):
    """[slam]'s checkpoint after frame SLAM_SAVE_AT restored into a fresh
    engine on the card, which runs the remaining frames (every loop closure
    of the run) with the same noise: bitwise equal to the unbroken engine in
    everything the checkpoint holds (tracker state and generators, poses,
    tracks, the LCD database, the pool, keyframes, loop edges, stats, loop
    events) and in both trajectories. The checkpoint stays for [mesh-resume]."""
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels
    from maveric_slam_tpu_torch.slam import SlamSystem
    from maveric_slam_tpu_torch.utils import checkpoint

    cuda = torch.device("cuda")
    path, frames, noises = run["ckpt"], run["frames"], run["noises"]
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    slam = SlamSystem(sp.load_params(device=cuda), cfg, ba_every=SLAM_BA_EVERY,
                      enable_loop_closure=True, fetch_delay=0, device=cuda)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore(slam, path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_verifications = slam.verifications
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for j in range(SLAM_SAVE_AT + 1, len(frames)):
        slam.process(frames[j], *noises[j - 1])
    slam.finish()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    n, v = len(frames) - SLAM_SAVE_AT - 1, slam.verifications - restored_verifications
    expected = {"detector_postproc": n, "windowed_match": n, "nullspace_inverse_iteration": 4 * (n + v),
                "svd3": 3 * (n + v), "fused_stem": n, "refine_pose": n, "qconv": QCONV * n}
    _log(f"[resume] kernels over the {n} resumed frames and {v} verifications: {json.dumps(launches)}")
    _require(launches == expected, f"resume launches {launches}, expected {expected}")
    diff = _state_differences(run["slam"], slam)
    ev = [(e.frame, e.matched_frame, e.num_inliers) for e in slam.loop_events if e.frame > SLAM_SAVE_AT]
    _log(f"[resume] checkpoint after frame {SLAM_SAVE_AT}: save {1e3 * run['save_s']:.3f} ms, "
         f"{size} bytes on disk; restore into a fresh engine {1e3 * restore_s:.3f} ms; frames "
         f"{SLAM_SAVE_AT + 1}-{len(frames) - 1} in {run_s:.3f} s, loop closures there {ev}, "
         f"{slam.verifications} verifications in all")
    _log(f"[resume] against the unbroken [slam] engine: "
         f"{'bitwise equal' if not diff else 'DIFFERS in ' + ', '.join(diff)}")
    _require(len(ev) == len([e for e in run["slam"].loop_events if e.frame > SLAM_SAVE_AT]) > 0,
             f"resume: loop closures after the checkpoint {ev}")
    _require(not diff, f"resume: the resumed engine differs from the unbroken one in {diff}")


def phase_elastic(cfg, frames):
    """`ElasticRunner` on the card over the first ELASTIC_FRAMES orbit
    frames (its RANSAC noise from the generators, no BA, no loop closure,
    a checkpoint every ELASTIC_EVERY frames): unbroken, with a crash
    injected before frame ELASTIC_CRASH_AT, and with frame ELASTIC_HANG_AT's
    step hung past a deadline set from the unbroken run's steps. Each fault
    costs exactly one restart, and each trajectory equals the unbroken one
    bitwise. Prints the steps' wall and each recovery's (restore + replay)."""
    import threading

    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels
    from maveric_slam_tpu_torch.utils import elastic

    cuda = torch.device("cuda")
    params = sp.load_params(device=cuda)
    seq = frames[:ELASTIC_FRAMES]
    kw = dict(checkpoint_every=ELASTIC_EVERY, ba_every=0, enable_loop_closure=False, device=cuda)

    def timed_run(runner):
        """runner.run(seq) with the launch counts set to 0 just before; its
        trajectory, every attempted step as (frame, wall s), each recovery
        (fresh engine + restore) as ("recover", wall s), and the counts."""
        log, run_step, recover = [], runner.detector.run_step, runner._recover

        def step(system, image, frame=None):
            t0 = time.perf_counter()
            try:
                run_step(system, image, frame)
            finally:
                log.append((frame, time.perf_counter() - t0))

        def rec():
            t0 = time.perf_counter()
            recover()
            log.append(("recover", time.perf_counter() - t0))

        runner.detector.run_step, runner._recover = step, rec
        kernels.reset_launch_counts()
        system = runner.run(seq)
        runner.close()
        return system.trajectory(), log, kernels.launch_counts()

    def expected(frames):
        """Launches of `frames` processed frames, the first one's extraction only."""
        return {"detector_postproc": frames, "windowed_match": frames - 1,
                "nullspace_inverse_iteration": 4 * (frames - 1), "svd3": 3 * (frames - 1),
                "fused_stem": frames, "refine_pose": frames - 1, "qconv": QCONV * frames}

    def recovery_s(log, failed):
        """Restore + replay: the recovery and the steps after it up to the
        failed frame."""
        k = next(i for i, (f, _) in enumerate(log) if f == "recover")
        return log[k][1] + sum(s for f, s in log[k + 1:] if f != "recover" and f < failed)

    runner = elastic.ElasticRunner(params, cfg, **kw)
    want, log, unbroken_launches = timed_run(runner)
    steps = [s for _, s in log]
    deadline = max(2.0, 20 * max(steps))
    _require(runner.restarts == 0, f"elastic: the unbroken run restarted {runner.failures}")

    fired = []

    def crash(i, img):
        if i == ELASTIC_CRASH_AT and not fired:
            fired.append(i)
            raise RuntimeError("injected device fault")

    runner = elastic.ElasticRunner(params, cfg, fault_hook=crash, **kw)
    crashed, crash_log, crash_launches = timed_run(runner)
    crash_runs = (runner.restarts, runner.failures)

    runner = elastic.ElasticRunner(params, cfg, step_timeout_s=deadline, **kw)
    process, hung = runner.system.process, []

    def sluggish(image):
        if runner.system.frame_idx + 1 == ELASTIC_HANG_AT and not hung:
            hung.append(ELASTIC_HANG_AT)
            time.sleep(2 * deadline)
        return process(image)

    runner.system.process = sluggish
    threads = set(threading.enumerate())
    hanged, hang_log, hang_launches = timed_run(runner)
    hang_runs = (runner.restarts, runner.failures)
    for t in set(threading.enumerate()) - threads:  # the abandoned step finishes its frame
        t.join(timeout=4 * deadline)

    _log(f"[elastic] {ELASTIC_FRAMES} frames at {H}x{W}, checkpoint every {ELASTIC_EVERY}: unbroken "
         f"steps median {1e3 * np.median(steps):.3f} ms, max {1e3 * max(steps):.3f} ms; hang deadline "
         f"{deadline:.3f} s against a {2 * deadline:.3f} s sleep")
    for name, (restarts, failures), log, at in (("crash", crash_runs, crash_log, ELASTIC_CRASH_AT),
                                                ("hang", hang_runs, hang_log, ELASTIC_HANG_AT)):
        rec = recovery_s(log, at) if restarts else float("nan")
        _log(f"[elastic] {name} at frame {at}: restarts {restarts}, failures {failures}; recovery "
             f"(fresh engine + restore + replay to frame {at}) {1e3 * rec:.3f} ms")
    # The crash run processes frames 0..CRASH_AT - 1, then, restored at the
    # last checkpoint, the frames after it again and on to the end.
    replayed = ELASTIC_CRASH_AT - (ELASTIC_CRASH_AT // ELASTIC_EVERY) * ELASTIC_EVERY
    _log(f"[elastic] kernels: unbroken {json.dumps(unbroken_launches)}, crash "
         f"{json.dumps(crash_launches)} ({replayed} frames replayed), hang {json.dumps(hang_launches)}")
    checks = [
        (unbroken_launches == expected(ELASTIC_FRAMES), f"unbroken launches {unbroken_launches}"),
        (crash_launches == expected(ELASTIC_FRAMES + replayed), f"crash launches {crash_launches}"),
        (all(hang_launches.values()), f"hang launches {hang_launches}"),
        (crash_runs[0] == 1 and f"frame {ELASTIC_CRASH_AT}" in crash_runs[1][0], f"crash {crash_runs}"),
        (hang_runs[0] == 1 and f"frame {ELASTIC_HANG_AT}" in hang_runs[1][0], f"hang {hang_runs}"),
        (np.array_equal(crashed, want), "the crash run's trajectory differs from the unbroken run's"),
        (np.array_equal(hanged, want), "the hang run's trajectory differs from the unbroken run's"),
    ]
    _log(f"[elastic] trajectories bitwise equal to the unbroken run: crash "
         f"{np.array_equal(crashed, want)}, hang {np.array_equal(hanged, want)}")
    _require(all(ok for ok, _ in checks), "elastic: " + "; ".join(w for ok, w in checks if not ok))


def pool_stress_frames(rng, num_frames=100, per_frame=200, overlap=75, max_id=5000):
    """tests/test_feature_pool.py's stress sequence: frames of `per_frame`
    ids, `overlap` of them carried over from the previous frame."""
    frames = [rng.choice(max_id, per_frame, replace=False)]
    for _ in range(num_frames - 1):
        keep = rng.choice(frames[-1], overlap, replace=False)
        fresh = rng.choice(np.setdiff1d(np.arange(max_id), keep), per_frame - overlap, replace=False)
        frames.append(np.concatenate([keep, fresh]))
    return frames


def phase_host_pool():
    """The native host pool built with g++ here (the first use builds it),
    over tests/test_feature_pool.py's stress sequence (seed 41, 100 frames,
    capacity 3000, window 8): the invariant on every frame, the last 8
    frames' ids left; `observe_batch` timed on the host clock. Then the
    ASan/UBSan stress driver, where the toolchain has sanitizers."""
    from maveric_slam_tpu_torch.runtime import pool

    t0 = time.perf_counter()
    p = pool.FeaturePool(capacity=3000, max_frames=8)
    build_s = time.perf_counter() - t0
    frames = pool_stress_frames(np.random.default_rng(41))
    walls, bad = [], []
    for f, ids in enumerate(frames):
        t0 = time.perf_counter()
        p.observe_batch(ids, f)
        walls.append(time.perf_counter() - t0)
        p.remove_old(f)
        code = p.check_invariant(f)
        if code:
            bad.append((f, code))
    want = set().union(*(set(ids.tolist()) for ids in frames[-8:]))
    us = np.array(walls) * 1e6
    _log(f"[host-pool] built and loaded in {build_s:.2f} s; {len(frames)} frames of {len(frames[0])} "
         f"ids: invariant violations {bad}, {len(p)} features left (load factor {p.load_factor:.4f}); "
         f"observe_batch host time median {np.median(us):.2f} us, p90 {np.percentile(us, 90):.2f} us, "
         f"max {us.max():.2f} us")
    _require(not bad and set(p.valid_keys().tolist()) == want, f"host pool: invariant {bad}")
    try:
        binary = pool.stress_binary()
    except pool.SanitizersUnavailable as e:
        _log(f"[host-pool] sanitizer stress driver not built, the toolchain lacks the sanitizers: "
             f"{' | '.join(str(e).splitlines()[1:])}")
        return
    res = subprocess.run([str(binary)], capture_output=True, text=True, timeout=300)
    _log(f"[host-pool] ASan/UBSan stress driver: exit {res.returncode}, {res.stdout.strip()}")
    _require(res.returncode == 0 and "pool_stress: OK" in res.stdout,
             f"host pool stress driver: {res.stdout[-500:]}{res.stderr[-2000:]}")


# ---------------------------------------------------------------------- #
# The mesh: [mesh], [mesh-slam] (4 gloo ranks sharing the card) and
# [mesh-nccl] (one NCCL rank). Each rank runs `_mesh_rank`, in a process of
# its own that `parallel.mesh.spawn` starts.
# ---------------------------------------------------------------------- #


def _sync():
    torch.cuda.synchronize()


@contextlib.contextmanager
def _timed_collectives(mesh_lib, sink):
    """Within the block, each call of mesh_lib's collectives puts its wall
    (synchronised before and after) into `sink`."""
    saved = mesh_lib.psum, mesh_lib.all_gather

    def wrap(fn):
        def run(*a):
            _sync()
            t0 = time.perf_counter()
            out = fn(*a)
            _sync()
            sink.append(time.perf_counter() - t0)
            return out
        return run

    mesh_lib.psum, mesh_lib.all_gather = wrap(saved[0]), wrap(saved[1])
    try:
        yield
    finally:
        mesh_lib.psum, mesh_lib.all_gather = saved


def _mesh_components(mesh, cfg, comp):
    """[mesh]'s components on this rank: sharded BA at [ba]'s problem (walls
    of MESH_BA_CALLS calls, then one with its collectives timed), the LCD
    ring filled through sharded_add_frame, sharded queries (walls), the
    word-sharded pool, and one stream-sharded tracking step at S = 16."""
    from maveric_slam_tpu_torch.backend import ba
    from maveric_slam_tpu_torch.frontend import tracker
    from maveric_slam_tpu_torch.loopclosure import sharded_lcd
    from maveric_slam_tpu_torch.mapping import feature_pool, sharded_pool
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.parallel import mesh as mesh_lib
    from maveric_slam_tpu_torch.parallel import sharded_ba, sharded_tracker

    dev, out = mesh.device, {}
    bc = cfg.ba

    def solve():
        solved, costs = sharded_ba.sharded_bundle_adjust(
            sharded_ba.shard_problem(ba.BAProblem(*comp["ba"]), mesh), mesh,
            iterations=bc.max_iterations, damping=bc.lm_damping, huber_delta=bc.huber_delta)
        return solved, costs, sharded_ba.gather_landmarks(solved.X, mesh)

    walls = []
    for _ in range(MESH_BA_CALLS + 1):
        _sync()
        t0 = time.perf_counter()
        solved, costs, X = solve()
        _sync()
        walls.append(time.perf_counter() - t0)
    coll = []
    with _timed_collectives(mesh_lib, coll):
        _sync()
        t0 = time.perf_counter()
        solve()
        _sync()
        timed = time.perf_counter() - t0
    out["ba"] = {"R": solved.R.cpu().numpy(), "t": solved.t.cpu().numpy(), "X": X.cpu().numpy(),
                 "cost": costs.cpu().numpy(), "walls": walls[1:], "timed_wall": timed,
                 "collectives": coll}

    db = sharded_lcd.create_database(cfg.loop.max_db_frames, cfg.loop.vocab_size, mesh)
    for f, ids in enumerate(comp["lcd_sets"]):
        db = sharded_lcd.sharded_add_frame(db, torch.from_numpy(ids).to(dev), f, mesh)
    out["ring"] = {k: getattr(db, k).cpu().numpy() for k in ("multihot", "counts", "frames", "valid")}
    out["ring"]["next_slot"] = db.next_slot
    answers, qwalls = [], []
    current = len(comp["lcd_sets"])
    for ids in comp["lcd_probes"]:
        q = torch.from_numpy(ids).to(dev)
        for _ in range(MESH_QUERY_CALLS):
            _sync()
            t0 = time.perf_counter()
            r = sharded_lcd.sharded_query(db, q, mesh, current, cfg.loop.min_frame_gap,
                                          cfg.loop.min_score)
            _sync()
            qwalls.append(time.perf_counter() - t0)
        answers.append((int(r.best), int(r.best_frame), float(r.best_score)))
    out["query"], out["query_walls"] = answers, qwalls

    pool = sharded_pool.create(cfg.loop.vocab_size, cfg.pool.max_frames, mesh)
    weights = []
    for f, (ids, q) in enumerate(comp["pool"]):
        pool = sharded_pool.observe_batch(pool, torch.from_numpy(ids).to(dev), f, mesh)
        pool = sharded_pool.remove_old(pool, f, mesh)
        weights.append(sharded_pool.covisibility_weights(pool, torch.from_numpy(q).to(dev),
                                                         mesh).cpu().numpy())
    out["pool"] = {"weights": weights, **{k: mesh_lib.all_gather(getattr(pool, k), mesh)
                                         .reshape(-1).cpu().numpy()
                                         for k in ("first_seen", "last_seen", "num_sightings")}}

    images0, images1, gmin, glo = comp["streams"]
    smesh = sharded_tracker.make_stream_mesh(mesh.size, device=dev)
    params = sharded_tracker.replicate_params(sp.load_params(device=dev), smesh)
    states = tracker.init_states_batched(params, torch.from_numpy(images0).to(dev), cfg)
    states, images = sharded_tracker.shard_streams(states, torch.from_numpy(images1), smesh)
    _, step = sharded_tracker.track_step_sharded(params, states, images, cfg,
                                                 torch.from_numpy(gmin), torch.from_numpy(glo))
    step = sharded_tracker.gather_steps(step, smesh)
    out["streams"] = {k: getattr(step, k).cpu().numpy() for k in ("R", "t", "valid", "num_inliers")}
    return out


def fingerprint(arrays):
    """{key: (dtype, shape, sha256 of the bytes)} of a checkpoint state:
    equal for bitwise-equal arrays, and small enough to send from a rank."""
    return {k: (str(a.dtype), a.shape, hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest())
            for k, a in arrays.items()}


def _engine_record(slam):
    """What the resume phases compare of an engine: the fingerprint of
    `checkpoint.engine_state` (collective in mesh mode) and its meta,
    `checkpoint.replica_digest`, both trajectories and the loop events."""
    from maveric_slam_tpu_torch.utils import checkpoint

    state, meta = checkpoint.engine_state(slam)
    return {"state": fingerprint(state), "meta": meta, "digest": checkpoint.replica_digest(slam),
            "trajectory": slam.trajectory(), "odometry": slam.odometry_trajectory(),
            "loops": [(e.frame, e.matched_frame, e.num_inliers, e.score) for e in slam.loop_events]}


def _mesh_engine(mesh, cfg, renders, idx, noises, ckpt=None):
    """The mesh-mode SlamSystem on this rank over [slam]'s frames and noise
    (loop closure on, BA every SLAM_BA_EVERY, fetch_delay 0); launch counts
    set to 0 just before its first frame and read after `finish`. Walls
    (host clock, synchronised): each frame, each sharded BA call and each
    sharded LCD query inside it. With `ckpt`, a collective
    `checkpoint.save` there after frame SLAM_SAVE_AT, outside the frame's
    wall (its wall: the gather, and on rank 0 the write)."""
    from maveric_slam_tpu_torch.loopclosure import sharded_lcd
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels
    from maveric_slam_tpu_torch.parallel import sharded_ba
    from maveric_slam_tpu_torch.slam import SlamSystem
    from maveric_slam_tpu_torch.utils import checkpoint

    spans = {"ba": [], "query": []}

    def timed(mod, name, sink):
        fn = getattr(mod, name)

        def run(*a, **k):
            _sync()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            _sync()
            sink.append(time.perf_counter() - t0)
            return res
        setattr(mod, name, run)
        return fn

    saved = [(sharded_ba, "sharded_bundle_adjust", timed(sharded_ba, "sharded_bundle_adjust", spans["ba"])),
             (sharded_lcd, "sharded_query", timed(sharded_lcd, "sharded_query", spans["query"]))]
    slam = SlamSystem(sp.load_params(device=mesh.device), cfg, ba_every=SLAM_BA_EVERY,
                      enable_loop_closure=True, fetch_delay=0, mesh=mesh)
    _sync()
    kernels.reset_launch_counts()
    walls, save_s = [], None
    for j, k in enumerate(idx):
        _sync()
        t0 = time.perf_counter()
        slam.process(renders[k], *(() if j == 0 else noises[j - 1]))
        _sync()
        walls.append(time.perf_counter() - t0)
        if ckpt is not None and j == SLAM_SAVE_AT:
            t0 = time.perf_counter()
            checkpoint.save(slam, ckpt)
            save_s = time.perf_counter() - t0
    slam.finish()
    launches = kernels.launch_counts()
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    return {"poses": np.stack(slam.poses), "rel": slam.rel_poses, "stats": slam.stats,
            "kf_frames": slam.kf_frames, "verifications": slam.verifications,
            "launches": launches, "walls": walls, "ba_walls": spans["ba"],
            "query_walls": spans["query"], "save_s": save_s, **_engine_record(slam)}


def _mesh_resumed(mesh, cfg, renders, idx, noises, path):
    """A fresh mesh engine on this rank restored from the checkpoint at
    `path` (taken after frame SLAM_SAVE_AT), over the frames after it with
    [slam]'s noise; launch counts set to 0 just after the restore."""
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels
    from maveric_slam_tpu_torch.slam import SlamSystem
    from maveric_slam_tpu_torch.utils import checkpoint

    slam = SlamSystem(sp.load_params(device=mesh.device), cfg, ba_every=SLAM_BA_EVERY,
                      enable_loop_closure=True, fetch_delay=0, mesh=mesh)
    _sync()
    t0 = time.perf_counter()
    checkpoint.restore(slam, path)
    _sync()
    restore_s = time.perf_counter() - t0
    restored_verifications = slam.verifications
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for j in range(SLAM_SAVE_AT + 1, len(idx)):
        slam.process(renders[idx[j]], *noises[j - 1])
    slam.finish()
    _sync()
    return {"restore_s": restore_s, "run_s": time.perf_counter() - t0,
            "launches": kernels.launch_counts(), "frames": len(idx) - SLAM_SAVE_AT - 1,
            "verifications": slam.verifications - restored_verifications, **_engine_record(slam)}


def _mesh_rank(cfg, comp, scene, ckpt=None, resume=None):
    """One rank of a mesh phase on the card: the components, then the engine
    (saving into `ckpt` when given), then, with `resume`, a fresh engine
    restored from that checkpoint over the frames after it."""
    from maveric_slam_tpu_torch.parallel import mesh as mesh_lib

    out = {"t_enter": time.time()}  # the wall clock: comparable across the processes
    mesh = mesh_lib.make_mesh()
    out.update(rank=mesh.rank, backend=mesh.backend, device=str(mesh.device))
    t0 = time.perf_counter()
    out["components"] = _mesh_components(mesh, cfg, comp)
    out["components_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["engine"] = _mesh_engine(mesh, cfg, *scene, ckpt=ckpt)
    out["engine_s"] = time.perf_counter() - t0
    if resume is not None:
        out["resumed"] = _mesh_resumed(mesh, cfg, *scene, resume)
    out["t_exit"] = time.time()
    return out


def _mesh_resume_rank(cfg, scene, path):
    """One rank of [mesh-resume]'s fresh group: the restored engine alone."""
    from maveric_slam_tpu_torch.parallel import mesh as mesh_lib

    t_enter = time.time()
    mesh = mesh_lib.make_mesh()
    return {"t_enter": t_enter, "rank": mesh.rank, "backend": mesh.backend,
            **_mesh_resumed(mesh, cfg, *scene, path)}


def _spawn_mesh(label, world, cfg, comp, scene, ckpt=None, resume=None):
    """`_mesh_rank` on `world` ranks; logs where the wall went."""
    from maveric_slam_tpu_torch.parallel import mesh as mesh_lib

    t0 = time.time()
    runs = mesh_lib.spawn(_mesh_rank, world, args=(cfg, comp, scene, ckpt, resume),
                          timeout_s=MESH_TIMEOUT_S)
    t1, r0 = time.time(), runs[0]
    _log(f"[{label}] {world} rank(s) over {r0['backend']} on {r0['device']}: {t1 - t0:.1f} s from "
         f"spawn to the last result: rank 0 began {r0['t_enter'] - t0:.1f} s after the spawn "
         f"(start, imports, joining the group), ran the components {r0['components_s']:.1f} s and "
         f"the engine {r0['engine_s']:.1f} s, and the last result was back "
         f"{t1 - max(r['t_exit'] for r in runs):.1f} s after the last rank finished")
    return runs


def mesh_inputs(cfg, streams, noises_b, slam_run, renders):
    """The mesh phases' inputs, as numpy: [ba]'s problem, MESH_LCD_FRAMES
    word sets over the 10000-word vocabulary (two of them equal, in
    different ranks' blocks, for a tie), probes, pool frames, the 16
    streams' first two frames and the batched phase's first noise; and
    [slam]'s scene (its unique renders, the orbit index of each frame, the
    noise)."""
    rng = np.random.default_rng(12)
    v = cfg.loop.vocab_size
    sets = [rng.choice(v, cfg.frontend.top_n, replace=False).astype(np.int32)
            for _ in range(MESH_LCD_FRAMES)]
    sets[3000] = sets[1000]  # slots 1000 and 3000: ranks 0 and 2 of 4 tie; slot 1000 must win
    probes = [sets[1000], sets[2000], sets[MESH_LCD_FRAMES - 1], sets[10]]
    pool = [(rng.integers(-1, v, (cfg.frontend.top_n,)).astype(np.int32),
             rng.integers(-1, v, (64,)).astype(np.int32)) for _ in range(MESH_POOL_FRAMES)]
    gmin, glo = (g.numpy() for g in noises_b[0])
    comp = {"ba": ba_scene()[0], "lcd_sets": sets, "lcd_probes": probes, "pool": pool,
            "streams": (np.stack([f[0] for f, _ in streams]), np.stack([f[1] for f, _ in streams]),
                        gmin, glo)}
    idx = (np.arange(SLAM_FRAMES) % ORBIT_N).tolist()
    scene = ({k: renders[k] for k in set(idx)}, idx,
             [tuple(g.numpy() for g in n) for n in slam_run["noises"]])
    return comp, scene


def _mesh_references(cfg, comp):
    """The single-device port on the card on [mesh]'s component inputs."""
    from maveric_slam_tpu_torch.backend import ba
    from maveric_slam_tpu_torch.frontend import tracker
    from maveric_slam_tpu_torch.loopclosure import lcd
    from maveric_slam_tpu_torch.mapping import feature_pool
    from maveric_slam_tpu_torch.models import superpoint as sp

    cuda, bc = torch.device("cuda"), cfg.ba
    prob = ba.BAProblem(*(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in comp["ba"]))
    solved, stats = ba.bundle_adjust(prob, iterations=bc.max_iterations, damping=bc.lm_damping,
                                     huber_delta=bc.huber_delta)
    walls = []
    for _ in range(MESH_BA_CALLS):
        _sync()
        t0 = time.perf_counter()
        ba.bundle_adjust(prob, iterations=bc.max_iterations, damping=bc.lm_damping,
                         huber_delta=bc.huber_delta)
        _sync()
        walls.append(time.perf_counter() - t0)
    out = {"ba": {"R": solved.R.cpu().numpy(), "t": solved.t.cpu().numpy(),
                  "X": solved.X.cpu().numpy(), "cost": stats.cost[:-1].cpu().numpy(),
                  "walls": walls}}
    db = lcd.create_database(cfg.loop.max_db_frames, cfg.loop.vocab_size, device=cuda)
    for f, ids in enumerate(comp["lcd_sets"]):
        db = lcd.add_frame(db, torch.from_numpy(ids).to(cuda), f)
    out["ring"] = {k: getattr(db, k).cpu().numpy() for k in ("multihot", "counts", "frames", "valid")}
    out["ring"]["next_slot"] = db.next_slot
    answers, qwalls = [], []
    for ids in comp["lcd_probes"]:
        q = torch.from_numpy(ids).to(cuda)
        for _ in range(MESH_QUERY_CALLS):
            _sync()
            t0 = time.perf_counter()
            r = lcd.query(db, q, len(comp["lcd_sets"]), cfg.loop.min_frame_gap, cfg.loop.min_score)
            _sync()
            qwalls.append(time.perf_counter() - t0)
        answers.append((int(r.best), int(r.best_frame), float(r.best_score)))
    out["query"], out["query_walls"] = answers, qwalls
    pool = feature_pool.create(cfg.loop.vocab_size, window=cfg.pool.max_frames, device=cuda)
    weights = []
    for f, (ids, q) in enumerate(comp["pool"]):
        pool = feature_pool.remove_old(feature_pool.observe_batch(pool, torch.from_numpy(ids).to(cuda),
                                                                  f), f)
        weights.append(feature_pool.covisibility_weights(pool, torch.from_numpy(q).to(cuda)).cpu().numpy())
    out["pool"] = {"weights": weights, **{k: getattr(pool, k).cpu().numpy()
                                         for k in ("first_seen", "last_seen", "num_sightings")}}
    images0, images1, gmin, glo = comp["streams"]
    params = sp.load_params(device=cuda)
    states = tracker.init_states_batched(params, torch.from_numpy(images0).to(cuda), cfg)
    _, step = tracker.track_step_batched(params, states, torch.from_numpy(images1).to(cuda), cfg,
                                         torch.from_numpy(gmin).to(cuda), torch.from_numpy(glo).to(cuda))
    out["streams"] = {k: getattr(step, k).cpu().numpy() for k in ("R", "t", "valid", "num_inliers")}
    return out


def _rot_deg_robust(R, R_ref):
    """The angle of R R_ref^T from its skew and symmetric parts in f64 (the
    arccos of the trace alone reads an f32 rotation's own departure from
    orthonormality as 0.03-0.06 deg)."""
    dR = np.asarray(R, np.float64) @ np.asarray(R_ref, np.float64).T
    w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(np.linalg.norm(w), (np.trace(dR) - 1.0) / 2.0)))


def check_mesh_components(label, runs, ref, bitwise):
    """Every rank's components against the single-device port on the card:
    BA at R 1e-4, t 1e-3, cost rtol 1e-3 (bit for bit when `bitwise`), the
    ring's blocks, the queries and the pool exact, the streams at
    tests/test_parallel.py's bars (bit for bit when `bitwise`); ranks equal."""
    failures = []
    n = len(runs)
    comps = [r["components"] for r in runs]
    c0, b = comps[0], comps[0]["ba"]
    gap = {k: float(np.abs(b[k] - ref["ba"][k]).max()) for k in ("R", "t", "X")}
    cost_rel = float(np.abs(b["cost"] - ref["ba"]["cost"]).max() / np.abs(ref["ba"]["cost"]).max())
    same = all(np.array_equal(b[k], ref["ba"][k]) for k in ("R", "t", "X", "cost"))
    _log(f"[{label}] sharded BA (P=8, L=1024, 10 iterations) on {n} rank(s) vs bundle_adjust on the "
         f"card: max |dR| {gap['R']:.3g} |dt| {gap['t']:.3g} |dX| {gap['X']:.3g}, cost rel "
         f"{cost_rel:.3g}; bitwise {same}")
    if not (gap["R"] <= 1e-4 and gap["t"] <= 1e-3 and cost_rel <= 1e-3) or (bitwise and not same):
        failures.append(f"sharded BA {gap} cost {cost_rel} bitwise {same}")
    coll = b["collectives"]
    _log(f"[{label}] sharded BA wall {1e3 * np.median(b['walls']):.3f} ms a call (median of "
         f"{len(b['walls'])}; bundle_adjust alone {1e3 * np.median(ref['ba']['walls']):.3f} ms); "
         f"one call with each collective synchronised: {1e3 * b['timed_wall']:.3f} ms, of which "
         f"{len(coll)} collectives {1e3 * sum(coll):.3f} ms ({1e3 * np.median(coll):.3f} ms median)")
    blocks = {k: np.concatenate([c["ring"][k] for c in comps]) for k in ("multihot", "counts",
                                                                          "frames", "valid")}
    ring_ok = all(np.array_equal(blocks[k], ref["ring"][k]) for k in blocks) and all(
        c["ring"]["next_slot"] == ref["ring"]["next_slot"] for c in comps)
    _log(f"[{label}] LCD ring {blocks['multihot'].shape} after {MESH_LCD_FRAMES} sharded_add_frame "
         f"calls: rows {'equal' if ring_ok else 'DIFFER'}, cursor {c0['ring']['next_slot']}")
    q_ok = all(c["query"] == ref["query"] for c in comps)
    _log(f"[{label}] sharded_query {c0['query']} vs lcd.query {ref['query']}: "
         f"{'equal' if q_ok else 'DIFFER'}; wall {1e3 * np.median(c0['query_walls']):.3f} ms a query "
         f"(lcd.query alone {1e3 * np.median(ref['query_walls']):.3f} ms)")
    pool_ok = all(all(np.array_equal(a, w) for a, w in zip(c["pool"]["weights"], ref["pool"]["weights"]))
                  and all(np.array_equal(c["pool"][k], ref["pool"][k]) for k in
                          ("first_seen", "last_seen", "num_sightings")) for c in comps)
    _log(f"[{label}] word-sharded pool ({ref['pool']['num_sightings'].shape[0]} words, "
         f"{MESH_POOL_FRAMES} frames): tables and weights {'equal' if pool_ok else 'DIFFER'}")
    s, rs = c0["streams"], ref["streams"]
    rot = max(_rot_deg_robust(a, r) for a, r in zip(s["R"], rs["R"]))
    cos_t = min(float(np.dot(a, r) / (np.linalg.norm(a) * np.linalg.norm(r) + 1e-12))
                for a, r in zip(s["t"].astype(np.float64), rs["t"].astype(np.float64)))
    d_inl = int(np.abs(s["num_inliers"].astype(np.int64) - rs["num_inliers"]).max())
    s_same = all(np.array_equal(s[k], rs[k]) for k in s)
    _log(f"[{label}] stream-sharded step S={len(s['R'])} ({len(s['R']) // n} a rank) vs "
         f"track_step_batched: max rot {rot:.4g} deg, min cos t {cos_t:.8f}, inliers within "
         f"{d_inl}; bitwise {s_same}")
    if not (rot < 0.05 and cos_t > 0.99999 and d_inl <= 3 and s["valid"].all()) or (
            bitwise and not s_same):
        failures.append(f"streams rot {rot} cos {cos_t} inliers {d_inl} bitwise {s_same}")
    for ok, what in ((ring_ok, "LCD ring"), (q_ok, "LCD query"), (pool_ok, "pool")):
        if not ok:
            failures.append(what)
    for k, c in enumerate(comps[1:], 1):
        if not (all(np.array_equal(c["ba"][f], b[f]) for f in ("R", "t", "X", "cost"))
                and c["query"] == c0["query"]
                and all(np.array_equal(c["streams"][f], s[f]) for f in s)):
            failures.append(f"rank {k}'s replicated results differ from rank 0's")
    _require(not failures, f"{label}: " + "; ".join(failures))


def check_mesh_engine(label, runs, slam_run, cfg, gt, bitwise):
    """Every rank's mesh engine: launch counts exact, the ranks bitwise
    equal, the [slam] run's BA-window count and loop pairs, [slam]'s own
    bars, and the trajectory against the single-device [slam] run: bit for
    bit when `bitwise`, else within MESH_SLAM_ALIGNED_BAR (similarity-aligned
    RMSE) and MESH_SLAM_ATE_BAR (ATE change). Returns rank 0's engine."""
    from maveric_slam_tpu_torch.utils import evaluation

    failures = []
    e0 = runs[0]["engine"]
    n = len(e0["walls"])
    for r in runs:
        e, v = r["engine"], r["engine"]["verifications"]
        expected = {"detector_postproc": n, "windowed_match": n - 1,
                    "nullspace_inverse_iteration": 4 * (n - 1) + 4 * v,
                    "svd3": 3 * (n - 1) + 3 * v, "fused_stem": n, "refine_pose": n - 1,
                    "qconv": QCONV * n}
        if e["launches"] != expected:
            failures.append(f"rank {r['rank']} launches {e['launches']}, expected {expected}")
    _log(f"[{label}] {len(runs)} rank(s) over {runs[0]['backend']} on {runs[0]['device']}, {n} "
         f"frames at {H}x{W}; rank 0 kernels {json.dumps(e0['launches'])} ({e0['verifications']} "
         f"loop verifications)")
    for r in runs[1:]:
        e = r["engine"]
        same = (np.array_equal(e["poses"], e0["poses"]) and e["loops"] == e0["loops"]
                and len(e["ba_walls"]) == len(e0["ba_walls"]) and e["stats"] == e0["stats"]
                and e["kf_frames"] == e0["kf_frames"])
        if not same:
            failures.append(f"rank {r['rank']} differs from rank 0")
    single = slam_run["slam"]
    windows = len(slam_run["ba_windows"])
    ref = np.stack(single.poses)
    gap = np.abs(e0["poses"][:, :3, 3] - ref[:, :3, 3]).max(-1)
    aligned = evaluation.ate(e0["poses"], ref)["ate_rmse"]
    ate_single = evaluation.ate(ref, gt)["ate_rmse"]
    same = np.array_equal(e0["poses"], ref)
    st = e0["stats"]
    lost = {j + 1 for j, s in enumerate(st) if not s["valid"]}
    inl = [s["inliers"] for s in st]
    pairs = [(f, m) for f, m, _, _ in e0["loops"]]
    full = evaluation.ate(e0["poses"], gt)["ate_rmse"]
    odo = evaluation.ate(e0["odometry"], gt)["ate_rmse"]
    _log(f"[{label}] ranks bitwise equal: {not any('differs' in f for f in failures)}; BA windows "
         f"{len(e0['ba_walls'])} ([slam] {windows}); loop closures {[(f, m, i) for f, m, i, _ in e0['loops']]} "
         f"([slam] {[(e.frame, e.matched_frame, e.num_inliers) for e in single.loop_events]}); "
         f"valid {n - 1 - len(lost)}/{n - 1} (not valid {sorted(lost)}); inliers median {np.median(inl)}")
    _log(f"[{label}] vs the single-device [slam] run: max |dt| {gap.max():.6g} m (frame "
         f"{int(gap.argmax())}), aligned RMSE {aligned:.6g} m (bar "
         f"{0 if bitwise else MESH_SLAM_ALIGNED_BAR}), bitwise {same}; ATE full {full:.4f} m "
         f"([slam] {ate_single:.4f} m, bar +-{0 if bitwise else MESH_SLAM_ATE_BAR}), odometry "
         f"{odo:.4f} m (ratio {full / odo:.4f})")
    wall = np.array(e0["walls"][1:]) * 1e3
    _log(f"[{label}] rank 0: a frame median {np.median(wall):.3f} ms, p90 "
         f"{np.percentile(wall, 90):.3f} ms, {n / sum(e0['walls']):.2f} frames/s; sharded BA "
         f"{len(e0['ba_walls'])} calls, median {1e3 * np.median(e0['ba_walls']):.3f} ms; sharded LCD "
         f"query {len(e0['query_walls'])} calls, median {1e3 * np.median(e0['query_walls']):.3f} ms")
    checks = [
        (len(e0["ba_walls"]) == windows, f"BA windows {len(e0['ba_walls'])}, [slam] {windows}"),
        (pairs == [(e.frame, e.matched_frame) for e in single.loop_events], f"loop pairs {pairs}"),
        (lost <= SLAM_LOST_AS_JAX, f"steps not valid at {sorted(lost)}"),
        (np.median(inl) >= SLAM_MIN_MEDIAN_INLIERS, f"median inliers {np.median(inl)}"),
        (full < SLAM_ATE_RATIO * odo, f"ATE {full} not below {SLAM_ATE_RATIO} x {odo}"),
        (same if bitwise else (aligned <= MESH_SLAM_ALIGNED_BAR
                               and abs(full - ate_single) <= MESH_SLAM_ATE_BAR),
         f"trajectory: bitwise {same}, aligned RMSE {aligned}, ATE {full} against {ate_single}"),
    ]
    failures += [what for ok, what in checks if not ok]
    _require(not failures, f"{label}: " + "; ".join(failures))
    return e0


def phase_mesh(cfg, streams, noises_b, slam_run, renders):
    """[mesh] and [mesh-slam]: MESH_RANKS gloo ranks sharing the card run
    the components, then the mesh engine over [slam]'s scene, which
    checkpoints after frame SLAM_SAVE_AT for [mesh-resume]."""
    import tempfile

    comp, scene = mesh_inputs(cfg, streams, noises_b, slam_run, renders)
    ref = _mesh_references(cfg, comp)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    runs = _spawn_mesh("mesh", MESH_RANKS, cfg, comp, scene, ckpt=ckpt)
    _require(all(r["backend"] == "gloo" for r in runs), "mesh: the shared card's ranks are not on gloo")
    check_mesh_components("mesh", runs, ref, bitwise=False)
    return comp, scene, ref, runs, ckpt


def phase_mesh_slam(cfg, slam_run, runs):
    return check_mesh_engine("mesh-slam", runs, slam_run, cfg, slam_run["gt"], bitwise=False)


def _record_differences(a, b):
    """What differs between two `_engine_record`s (fingerprinted arrays,
    meta fields, the replica digest, trajectories, loop events)."""
    diff = [k for k in sorted(set(a["state"]) | set(b["state"])) if a["state"].get(k) != b["state"].get(k)]
    diff += [f"meta {k}" for k in sorted(set(a["meta"]) | set(b["meta"]))
             if a["meta"].get(k) != b["meta"].get(k)]
    diff += [k for k in ("digest", "trajectory", "odometry") if not np.array_equal(a[k], b[k])]
    return diff + (["loops"] if a["loops"] != b["loops"] else [])


def _resume_launches(r):
    n, v = r["frames"], r["verifications"]
    return {"detector_postproc": n, "windowed_match": n, "nullspace_inverse_iteration": 4 * (n + v),
            "svd3": 3 * (n + v), "fused_stem": n, "refine_pose": n, "qconv": QCONV * n}


def phase_mesh_resume(cfg, scene, runs, ckpt):
    """[mesh-resume]: [mesh-slam]'s checkpoint after frame SLAM_SAVE_AT
    restored into a fresh group of MESH_RANKS gloo ranks, which runs the
    frames after it (all five loop closures) with the same noise: on every
    rank bitwise equal to the unbroken [mesh-slam] rank in everything
    `checkpoint.engine_state` holds (the gathered ring and pool included),
    its replica digest and both trajectories."""
    import shutil

    from maveric_slam_tpu_torch.parallel import mesh as mesh_lib

    size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
    t0 = time.time()
    resumed = mesh_lib.spawn(_mesh_resume_rank, MESH_RANKS, args=(cfg, scene, ckpt),
                             timeout_s=MESH_TIMEOUT_S)
    wall = time.time() - t0
    shutil.rmtree(ckpt)
    failures = []
    for r, u in zip(resumed, runs):
        diff = _record_differences(u["engine"], r)
        if diff:
            failures.append(f"rank {r['rank']} differs from the unbroken run in {diff}")
        if r["launches"] != _resume_launches(r):
            failures.append(f"rank {r['rank']} launches {r['launches']}, expected {_resume_launches(r)}")
    ev = [(f, m) for f, m, _, _ in resumed[0]["loops"] if f > SLAM_SAVE_AT]
    saves = ", ".join(f"{1e3 * u['engine']['save_s']:.3f}" for u in runs)
    restores = ", ".join(f"{1e3 * r['restore_s']:.3f}" for r in resumed)
    _log(f"[mesh-resume] {MESH_RANKS} gloo ranks: checkpoint after frame {SLAM_SAVE_AT}, {size} bytes "
         f"on disk; save (gather + rank 0's write) {saves} ms on ranks 0..; a fresh group "
         f"{wall:.1f} s from spawn to the last result, rank 0 began "
         f"{resumed[0]['t_enter'] - t0:.1f} s after the spawn; restore {restores} ms on ranks 0..; frames "
         f"{SLAM_SAVE_AT + 1}-{SLAM_FRAMES - 1} in {resumed[0]['run_s']:.3f} s on rank 0, loop "
         f"closures there {ev}; kernels on rank 0 {json.dumps(resumed[0]['launches'])}")
    _log(f"[mesh-resume] against the unbroken [mesh-slam] ranks: "
         f"{'bitwise equal on every rank' if not failures else '; '.join(failures)}")
    _require(len(ev) == 5, f"mesh-resume: loop closures after the checkpoint {ev}")
    _require(not failures, "mesh-resume: " + "; ".join(failures))


def phase_mesh_nccl(cfg, slam_run, comp, scene, ref):
    """[mesh-nccl]: one rank over NCCL, the same components and the mesh
    engine over [slam]'s scene; bitwise equal to the single-device port.
    Then, in that rank, [resume]'s single-engine checkpoint restored into a
    fresh one-rank mesh engine over the frames after it: bitwise equal to
    the unbroken [slam] engine ([mesh-resume])."""
    import shutil

    from maveric_slam_tpu_torch.utils import checkpoint

    runs = _spawn_mesh("mesh-nccl", 1, cfg, comp, scene, resume=slam_run["ckpt"])
    shutil.rmtree(slam_run["ckpt"])
    _require(runs[0]["backend"] == "nccl", f"mesh-nccl: backend {runs[0]['backend']}")
    check_mesh_components("mesh-nccl", runs, ref, bitwise=True)
    engine = check_mesh_engine("mesh-nccl", runs, slam_run, cfg, slam_run["gt"], bitwise=True)
    single = slam_run["slam"]
    state, meta = checkpoint.engine_state(single)
    want = {"state": fingerprint(state), "meta": meta, "digest": checkpoint.replica_digest(single),
            "trajectory": single.trajectory(), "odometry": single.odometry_trajectory(),
            "loops": [(e.frame, e.matched_frame, e.num_inliers, e.score) for e in single.loop_events]}
    r = runs[0]["resumed"]
    diff = _record_differences(want, r)
    _log(f"[mesh-resume] [resume]'s single-engine checkpoint restored into the one NCCL rank: restore "
         f"{1e3 * r['restore_s']:.3f} ms, frames {SLAM_SAVE_AT + 1}-{SLAM_FRAMES - 1} in "
         f"{r['run_s']:.3f} s, kernels {json.dumps(r['launches'])}; against the unbroken [slam] engine: "
         f"{'bitwise equal' if not diff else 'DIFFERS in ' + ', '.join(diff)}")
    _require(r["launches"] == _resume_launches(r), f"mesh-resume (nccl) launches {r['launches']}")
    _require(not diff, f"mesh-resume (nccl): differs from [slam] in {diff}")
    return engine


class ElasticFault:
    """[mesh-elastic]'s fault hook (picklable for the ranks): each fault
    (kind, attempt, rank, frame) fires on that rank before that frame's
    step in that attempt; "crash" raises, "hang" sleeps past any deadline."""

    def __init__(self, faults):
        self.faults = faults

    def __call__(self, attempt, rank, frame, system):
        for kind, a, r, f in self.faults:
            if (a, r, f) == (attempt, rank, frame):
                if kind == "crash":
                    raise RuntimeError("injected device fault")
                time.sleep(3600.0)


def phase_mesh_elastic(cfg, frames):
    """[mesh-elastic]: `MeshElasticRunner` over MESH_ELASTIC_RANKS gloo
    ranks on the card and MESH_ELASTIC_FRAMES orbit frames (loop closure
    on, BA every SLAM_BA_EVERY, a collective checkpoint every
    MESH_ELASTIC_EVERY): unbroken, then one run with MESH_ELASTIC_FAULTS,
    the hang under a deadline set from the unbroken run's steps: exactly
    two restarts of the whole group and a trajectory bitwise equal to the
    unbroken run's. Prints each recovery's wall: spawn, engine, restore
    and the replay up to the failed frame."""
    from maveric_slam_tpu_torch.utils import elastic

    seq = frames[:MESH_ELASTIC_FRAMES]
    kw = dict(checkpoint_every=MESH_ELASTIC_EVERY, device="cuda", attempt_timeout_s=MESH_TIMEOUT_S,
              ba_every=SLAM_BA_EVERY, enable_loop_closure=True)
    t0 = time.time()
    runner = elastic.MeshElasticRunner(MESH_ELASTIC_RANKS, cfg, **kw)
    want = runner.run(seq)
    unbroken_s = time.time() - t0
    (a0,) = runner.attempts
    runner.close()
    _require(runner.restarts == 0, f"mesh-elastic: the unbroken run restarted {runner.failures}")
    steps = a0["steps"]
    deadline = max(3.0, 4 * max(steps.values()))
    t0 = time.time()
    runner = elastic.MeshElasticRunner(MESH_ELASTIC_RANKS, cfg, step_timeout_s=deadline,
                                       fault_hook=ElasticFault(MESH_ELASTIC_FAULTS), **kw)
    got = runner.run(seq)
    faulted_s = time.time() - t0
    runner.close()
    _log(f"[mesh-elastic] {MESH_ELASTIC_RANKS} gloo ranks, {MESH_ELASTIC_FRAMES} frames at {H}x{W}, a "
         f"checkpoint every {MESH_ELASTIC_EVERY}: unbroken {unbroken_s:.1f} s (spawn to rank 0's start "
         f"{a0['spawn_s']:.1f} s, engine {a0['build_s']:.1f} s), steps median "
         f"{1e3 * np.median(list(steps.values())):.3f} ms, max {1e3 * max(steps.values()):.3f} ms, "
         f"collective saves {[round(1e3 * v, 1) for v in a0['saves'].values()]} ms; hang "
         f"deadline {deadline:.3f} s; faulted run {faulted_s:.1f} s, restarts {runner.restarts}, "
         f"failures {runner.failures}")
    for prev, a in zip(runner.attempts, runner.attempts[1:]):
        replay = [f for f in a["steps"] if f < prev["failed_at"]]
        _log(f"[mesh-elastic] recovery from the failure at frame {prev['failed_at']} (attempt "
             f"{a['attempt']}): spawn to rank 0's start {a['spawn_s']:.3f} s, engine "
             f"{a['build_s']:.3f} s, restore of frame {a['resumed_at']} {1e3 * a['restore_s']:.3f} ms, "
             f"replay of frames {replay} {1e3 * sum(a['steps'][f] for f in replay):.3f} ms")
    same = {k: np.array_equal(getattr(got, k), getattr(want, k)) for k in ("trajectory", "odometry")}
    _log(f"[mesh-elastic] against the unbroken run: trajectory bitwise {same['trajectory']}, odometry "
         f"bitwise {same['odometry']}, stats equal {got.stats == want.stats}, keyframes "
         f"{got.kf_frames}")
    checks = [
        (runner.restarts == 2, f"restarts {runner.restarts}"),
        (runner.failures[0].startswith("frame 7: rank 1:") and "injected" in runner.failures[0]
         and runner.failures[1].startswith("frame 10:") and "exceeded" in runner.failures[1],
         f"failures {runner.failures}"),
        (all(same.values()) and got.stats == want.stats, "the recovered run differs from the unbroken"),
    ]
    _require(all(ok for ok, _ in checks), "mesh-elastic: " + "; ".join(w for ok, w in checks if not ok))


def phase_profile_slam(cfg, run, warm=8, frames=8):
    """The engine under torch.profiler: a fresh SlamSystem over [slam]'s
    first frames, `warm` untraced, then `frames` traced (two BA windows);
    device-busy share and launches a frame. Then one loop verification
    (`_verify_loop_device` on the run's first candidate) alone."""
    from torch.profiler import ProfilerActivity, profile

    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.slam import SlamSystem, _verify_loop_device

    cuda = torch.device("cuda")
    slam = SlamSystem(sp.load_params(device=cuda), cfg, ba_every=SLAM_BA_EVERY, device=cuda)
    seq, noises = run["frames"], run["noises"]
    for j in range(warm):
        slam.process(seq[j], *(() if j == 0 else noises[j - 1]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(warm, warm + frames):
            slam.process(seq[j], *noises[j - 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    _log(f"[traced] SlamSystem.process, frames {warm}-{warm + frames - 1} (BA every {SLAM_BA_EVERY}): "
         f"wall {wall_ms / frames:.3f} ms/frame, device busy {busy_ms / frames:.3f} ms/frame "
         f"({100 * busy_ms / wall_ms:.1f}%), {len(kern) / frames:.0f} kernels/frame")
    if run["verify_flat"] is not None:
        flat = torch.from_numpy(run["verify_flat"]).to(cuda)
        gen = torch.Generator(device=cuda).manual_seed(0)

        def verify():
            return _verify_loop_device(flat, cfg, cfg.frontend.top_n, generator=gen)

        med, _ = _wall_ms(verify, 10)
        busy, count = _kernel_events(verify, 3)
        _log(f"[traced] loop verification (_verify_loop_device, N={cfg.frontend.top_n}): wall "
             f"{med:.3f} ms a call, device busy {busy:.3f} ms/call, {count:.0f} kernels/call")


def phase_profile(frames, noises, cfg, steps=3):
    """Where a tracking step's time goes on the card: torch.profiler over
    `steps` steps; prints the device-busy share of the wall time and the
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from maveric_slam_tpu_torch.frontend.tracker import Tracker
    from maveric_slam_tpu_torch.models import superpoint as sp

    cuda = torch.device("cuda")
    tr = Tracker(sp.load_params(device=cuda), cfg, device=cuda)
    tr.process(frames[0])
    tr.process(frames[1], *(g.to(cuda) for g in noises[0]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f, (gmin, glo) in zip(frames[2:2 + steps], noises[1:1 + steps]):
            tr.process(f, gmin.to(cuda), glo.to(cuda))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    _log(f"[profile] {steps} steps: wall {wall_ms / steps:.3f} ms/step, device busy "
         f"{busy_ms / steps:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}%), "
         f"{len(kern) / steps:.0f} kernels/step")
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        _log(f"[profile]   {t / steps:8.3f} ms/step {n / steps:6.1f}x  {name[:100]}")


def _kernel_events(fn, iters):
    """(device-busy ms, kernel launches) per call of `fn`, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kern) / 1e3 / iters, len(kern) / iters


def step_layers(frames, noises, cfg):
    """Each layer of a tracking step as a call on the card, on frames 0 and
    1, in step order: [(name, fn)]."""
    from maveric_slam_tpu_torch.frontend import extractor
    from maveric_slam_tpu_torch.geometry import epipolar, pnp, ransac
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import matching

    cuda = torch.device("cuda")
    fc, mc, rc = cfg.frontend, cfg.matcher, cfg.ransac
    params = sp.load_params(device=cuda)
    img0, img1 = (torch.from_numpy(f).to(cuda) for f in frames[:2])
    f0 = extractor.extract_quantized(params, img0, cfg)
    f1 = extractor.extract_quantized(params, img1, cfg)
    n = fc.num_cells
    K = torch.from_numpy(cfg.working_camera.K).to(cuda)
    gmin, glo = (g.to(cuda) for g in noises[0])

    def match():
        return matching.windowed_match(
            f0.desc_q.reshape(n, 256), f0.probs.reshape(n), f0.indices.reshape(n),
            f1.desc_q.reshape(n, 256), f1.top.cells, f1.top.indices, f1.top.mask,
            grid_h=fc.grid_h, grid_w=fc.grid_w, shift=mc.window_shift, radius=mc.window_radius,
            match_threshold=mc.match_threshold, min_prob=mc.min_prob,
            xy0_cells=f0.xy.reshape(n, 2), xy1_cells=f1.xy.reshape(n, 2))

    m = match()
    p1, p2 = epipolar.normalize_points(m.xy0, K), epipolar.normalize_points(m.xy1, K)

    def rans():
        return ransac.ransac_essential(p1, p2, m.mask, inlier_thresh=rc.inlier_thresh,
                                       num_hypotheses=rc.num_hypotheses, gumbel_min=gmin,
                                       gumbel_lo=glo)

    res = rans()
    X = epipolar.triangulate(res.R, res.t, p1, p2)
    return [
        ("superpoint_int8", lambda: sp.superpoint_int8(params, img1[None])),
        ("extract_quantized", lambda: extractor.extract_quantized(params, img1, cfg)),
        ("windowed_match", match),
        ("ransac_essential", rans),
        ("triangulate", lambda: epipolar.triangulate(res.R, res.t, p1, p2)),
        ("refine_pose", lambda: pnp.refine_pose(K, res.R, res.t, X, m.xy1, res.inliers,
                                                huber_delta=cfg.ba.huber_delta,
                                                damping=cfg.ba.lm_damping)),
    ]


def phase_layers(layers, reps=5):
    """Wall time per call of each layer alone (host clock around
    synchronised calls)."""
    for name, fn in layers:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        _log(f"[layers] {name}: wall {(time.perf_counter() - t0) / reps * 1e3:.3f} ms/call")


def _event_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(fn, names, iters=50):
    """Mean device time per call of the CUDA kernels whose names contain one
    of `names`, from torch.profiler; None if it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if any(n in ev.key for n in names):
            total += ev.device_time_total
    return total / iters / 1e3 if total > 0 else None


def _nullspace_ops(n, iters=10):
    chol = sum(2 * j + 1 for i in range(n) for j in range(i + 1)) + n
    solve = 2 * sum(2 * i + 1 for i in range(n))
    return chol + iters * (solve + 2 * n + 1 + n)


SVD3_OPS = 1600  # f32 operations a matrix: A^T A, 18 Jacobi rotations, B = AV, sort, U


def _stem_work(s, h, w):
    """(bytes, int8 operations) of the stem at (s, h, w): the f32 images,
    the weights and constants read once, the pooled int8 output written
    once; conv1a's 9 and conv1b's 576 multiply-adds per output channel and
    pixel."""
    bytes_ = s * h * w * 4 + 9 * 64 * 4 + 9 * 64 * 64 + 4 * (3 + 2 * 64) + s * (h // 2) * (w // 2) * 64
    return bytes_, 2 * s * h * w * 64 * (9 + 576)


def _bound(bytes_, ops, rate):
    """(the least ms the card could take for the work, "bytes" or
    "operations": whichever of bytes over the memory rate and operations
    over `rate` is larger)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _detector_work(s, c):
    """(bytes, f32 operations) of the detector on S streams of C cells."""
    return s * (c * 65 + c * 16) + 4, s * c * (65 * 3 * 4 + 65 + 64 + 9 * 5 + 6)


def _match_work(cells, c, kw):
    """(bytes, int8 operations, window pairs) of the matcher for the query
    cells ([S,] N) against C cells a stream: every input read once, the
    outputs written once; the dots and norms of the (query, window cell)
    pairs these queries visit."""
    r, gh, gw = kw["radius"], kw["grid_h"], kw["grid_w"]
    rows = cells.long() // gw + kw["shift"][1]
    cols = cells.long() % gw + kw["shift"][0]
    win_r = (torch.clamp(rows + r, max=gh - 1) - torch.clamp(rows - r, min=0) + 1).clamp(min=0)
    win_c = (torch.clamp(cols + r, max=gw - 1) - torch.clamp(cols - r, min=0) + 1).clamp(min=0)
    pairs = int((win_r * win_c).sum())
    nq, s = cells.numel(), cells.numel() // cells.shape[-1]
    return nq * (256 + 4 + 8) + s * c * (256 + 8), 2 * 256 * (pairs + nq + s * c), pairs


def _refine_pose_work(s, n, iterations=8):
    """(bytes, f32 operations) of refine_pose on S poses of N factors: K,
    the poses, X, z and the mask read once, R, t, cost and num_used written
    once; 235 operations a factor an iteration (transform, residual, Huber
    weight, Jacobian, its terms of the 27 sums), 340 a pose an iteration
    (Cholesky, the two substitutions, se3_exp, the update) and 37 a factor
    for the final cost."""
    return 36 + s * (48 + 21 * n + 56), s * (iterations * (235 * n + 340) + 37 * n)


def phase_timing(inp, launches, errs, pw_per_call, pw_inp):
    from maveric_slam_tpu_torch.ops.kernels import detector, match, nullspace, refine_pose, stem, svd3

    semi, scale = inp["detector"]
    c = semi.shape[0]
    q, d0, pr0, ix0, cells = inp["match"]
    kw = inp["match_kw"]
    n = q.shape[0]
    m_bytes, m_ops, pairs = _match_work(cells, c, kw)
    d_bytes, d_ops = _detector_work(1, c)
    ata = inp["nullspace"][0]
    E = inp["svd3"][0]
    b9, b3 = ata.shape[0], E.shape[0]
    img1 = inp["stem"]["(1, 192, 640) orbit"]
    img16 = inp["stem"]["(16, 192, 640) streams"]
    sargs = inp["stem_args"]
    st_bytes, st_ops = _stem_work(*img1.shape)
    rp1, rkw = inp["refine_pose"], inp["refine_kw"]
    rp_bytes, rp_ops = _refine_pose_work(1, rp1[3].shape[1])
    spec = [
        dict(name="fused_stem", src="stem.cu", replaces="maveric_slam_tpu/ops/pallas_kernels.py:737",
             kern=lambda: stem.fused_stem(img1, *sargs),
             plain=lambda: stem.fused_stem_plain(img1, *sargs), lib=None,
             names=("stem_kernel",), bytes=st_bytes, ops=st_ops, rate=INT8_OPS_PER_S,
             shape=f"S=1 {img1.shape[1]}x{img1.shape[2]}"),
        dict(name="detector_postproc", src="detector.cu", replaces="maveric_slam_tpu/ops/pallas_kernels.py:93",
             kern=lambda: detector.detector_postproc(semi, scale),
             plain=lambda: detector.detector_postproc_plain(semi, scale), lib=None,
             names=("detector_kernel",), bytes=d_bytes, ops=d_ops, rate=F32_OPS_PER_S,
             shape=f"C={c}"),
        dict(name="windowed_match", src="match.cu", replaces="maveric_slam_tpu/ops/pallas_kernels.py:173",
             kern=lambda: match.windowed_match(q, d0, pr0, ix0, cells, **kw),
             plain=lambda: match.windowed_match_plain(q, d0, pr0, ix0, cells, **kw), lib=None,
             names=("match_kernel",), bytes=m_bytes, ops=m_ops, rate=INT8_OPS_PER_S,
             shape=f"N={n} C={c} window pairs={pairs}"),
        dict(name="nullspace_inverse_iteration", src="nullspace.cu",
             replaces="maveric_slam_tpu/ops/pallas_kernels.py:293",
             kern=lambda: nullspace.nullspace_inverse_iteration(ata),
             plain=lambda: nullspace.nullspace_plain(ata),
             lib=lambda: torch.linalg.eigh(ata),
             names=("nullspace_kernel",), bytes=b9 * (81 + 9) * 4,
             ops=b9 * _nullspace_ops(9), rate=F32_OPS_PER_S, shape=f"B={b9} n=9"),
        dict(name="svd3", src="svd3.cu", replaces="maveric_slam_tpu/ops/pallas_kernels.py:463",
             kern=lambda: svd3.svd3(E), plain=lambda: svd3.svd3_plain(E),
             lib=lambda: torch.linalg.svd(E),
             names=("svd3_kernel",), bytes=b3 * (9 + 9 + 3 + 9) * 4,
             ops=b3 * SVD3_OPS, rate=F32_OPS_PER_S, shape=f"B={b3}"),
        dict(name="refine_pose", src="refine_pose.cu",
             replaces="none, new in the port (maveric_slam_tpu/geometry/pnp.py refine_pose, jnp)",
             kern=lambda: refine_pose.refine_pose(*rp1, **rkw),
             plain=lambda: refine_pose.refine_pose_plain(*rp1, **rkw), lib=None,
             floor=lambda: refine_pose.refine_pose(*rp1, **rkw, iterations=0),
             names=("refine_pose_kernel",), bytes=rp_bytes, ops=rp_ops, rate=F32_OPS_PER_S,
             shape=f"S=1 N={rp1[3].shape[1]}"),
    ]
    ql = inp["qconv"]  # the ten layers at (1, H, W)
    q_work = [_qconv_work(x, args, pool) for _, _, _, x, args, pool in ql]
    spec.append(dict(
        name="qconv", src="qconv.cu",
        replaces="none, new in the port (the layers after the stem, XLA convolutions in the JAX package)",
        kern=lambda: [c() for _, c, _, _, _, _ in ql], plain=lambda: [p() for _, _, p, _, _, _ in ql],
        lib=None, names=("qconv_kernel",), bytes=sum(b for b, _ in q_work), ops=sum(o for _, o in q_work),
        rate=INT8_OPS_PER_S, shape=f"S=1 {H}x{W}, the ten layers after the stem (10 launches)"))
    for k in spec:
        k.update(launches=launches[k["name"]], err=errs[k["name"]])
    # The pairwise path's launch shapes: its minimal hypotheses at M = 1000.
    ata_pw, E_pw = pw_inp["ata"], pw_inp["E"]
    spec += [
        dict(spec[3], kern=lambda: nullspace.nullspace_inverse_iteration(ata_pw),
             plain=lambda: nullspace.nullspace_plain(ata_pw), lib=lambda: torch.linalg.eigh(ata_pw),
             launches=pw_per_call["nullspace_inverse_iteration"], err=pw_inp["nullspace_err"],
             shape=f"pairwise B={ata_pw.shape[0]} n=9 (M=1000), launches a pairwise call"),
        dict(spec[4], kern=lambda: svd3.svd3(E_pw), plain=lambda: svd3.svd3_plain(E_pw),
             lib=lambda: torch.linalg.svd(E_pw), launches=pw_per_call["svd3"], err=pw_inp["svd3_err"],
             shape=f"pairwise B={E_pw.shape[0]} (M=1000), launches a pairwise call"),
    ]
    out = []
    for k in spec:
        bound, bound_by = _bound(k["bytes"], k["ops"], k["rate"])
        # plain, kernel, kernel, plain: the pairs are compared within one run
        plain1 = _event_ms(k["plain"], 50)
        kern1 = _event_ms(k["kern"], 500)
        kern2 = _event_ms(k["kern"], 500)
        plain2 = _event_ms(k["plain"], 50)
        lib = _event_ms(k["lib"], 200) if k["lib"] else None
        floor = _event_ms(k["floor"], 500) if k.get("floor") else None
        row = {
            "name": k["name"], "route": "cuda",
            "source": f"maveric_slam_tpu_torch/csrc/{k['src']}", "replaces": k["replaces"],
            "launches": k["launches"], "max_abs_err": k["err"],
            "ms": min(kern1, kern2), "plain_ms": min(plain1, plain2),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib, "device_ms": None, "shape": k["shape"],
        }
        if floor is not None:
            row["floor_ms"] = floor
        _log(f"[timing] {k['name']} ({k['shape']}): call {kern1:.4f}/{kern2:.4f} ms, "
             f"plain {plain1:.4f}/{plain2:.4f} ms, "
             f"library {lib if lib is None else f'{lib:.4f}'} ms, "
             + ("" if floor is None else f"floor (0 iterations) {floor:.4f} ms, ")
             + f"bound {row['bound_ms']:.2e} ms "
             f"({row['bound_by']}: {k['bytes']} B, {k['ops']} ops)")
        out.append(row)
    b16, o16 = _stem_work(*img16.shape)
    k16 = _event_ms(lambda: stem.fused_stem(img16, *sargs), 50)
    p16 = _event_ms(lambda: stem.fused_stem_plain(img16, *sargs), 5)
    _log(f"[timing] fused_stem (S=16 {H}x{W}): call {k16:.4f} ms, layered stage 1 {p16:.4f} ms, "
         f"bound {_bound(b16, o16, INT8_OPS_PER_S)[0]:.2e} ms")
    det16, m16 = inp["detector16"], inp["match16"]
    s16, c16 = det16[0].shape[0], det16[0].shape[1]
    db, dops = _detector_work(s16, c16)
    mb, mops, mpairs = _match_work(m16[4], c16, kw)
    bound, by = _bound(db, dops, F32_OPS_PER_S)
    _log(f"[timing] detector_postproc (S={s16} C={c16}): call "
         f"{_event_ms(lambda: detector.detector_postproc(*det16), 200):.4f} ms, plain "
         f"{_event_ms(lambda: detector.detector_postproc_plain(*det16), 20):.4f} ms, bound "
         f"{bound:.2e} ms ({by}: {db} B, {dops} ops)")
    bound, by = _bound(mb, mops, INT8_OPS_PER_S)
    _log(f"[timing] windowed_match (S={s16} N={m16[0].shape[1]} window pairs={mpairs}): call "
         f"{_event_ms(lambda: match.windowed_match(*m16, **kw), 200):.4f} ms, plain "
         f"{_event_ms(lambda: match.windowed_match_plain(*m16, **kw), 20):.4f} ms, bound "
         f"{bound:.2e} ms ({by}: {mb} B, {mops} ops)")
    for a in inp["nullspace"][1:]:
        _log(f"[timing] nullspace {tuple(a.shape)}: "
             f"call {_event_ms(lambda a=a: nullspace.nullspace_inverse_iteration(a), 500):.4f} ms")
    for a in inp["svd3"][1:3] + inp["svd3_16"]:
        b = a.numel() // 9
        bound, by = _bound(b * (9 + 9 + 3 + 9) * 4, b * SVD3_OPS, F32_OPS_PER_S)
        _log(f"[timing] svd3 {tuple(a.shape)}: call {_event_ms(lambda a=a: svd3.svd3(a), 500):.4f} ms, "
             f"plain {_event_ms(lambda a=a: svd3.svd3_plain(a), 5):.4f} ms, library "
             f"{_event_ms(lambda a=a: torch.linalg.svd(a), 50):.4f} ms (torch.linalg.svd), bound "
             f"{bound:.2e} ms ({by})")
    rp16 = inp["refine_pose16"]
    bound, by = _bound(*_refine_pose_work(rp16[1].shape[0], rp16[3].shape[1]), F32_OPS_PER_S)
    _log(f"[timing] refine_pose (S={rp16[1].shape[0]} N={rp16[3].shape[1]}): call "
         f"{_event_ms(lambda: refine_pose.refine_pose(*rp16, **rkw), 500):.4f} ms, plain "
         f"{_event_ms(lambda: refine_pose.refine_pose_plain(*rp16, **rkw), 20):.4f} ms, floor (0 "
         f"iterations) {_event_ms(lambda: refine_pose.refine_pose(*rp16, **rkw, iterations=0), 500):.4f} "
         f"ms, bound {bound:.2e} ms ({by})")
    for a in inp["nullspace16"]:
        b = a.numel() // 81
        bound, by = _bound(b * (81 + 9) * 4, b * _nullspace_ops(9), F32_OPS_PER_S)
        _log(f"[timing] nullspace {tuple(a.shape)}: call "
             f"{_event_ms(lambda a=a: nullspace.nullspace_inverse_iteration(a), 500):.4f} ms, plain "
             f"{_event_ms(lambda a=a: nullspace.nullspace_plain(a), 5):.4f} ms, library "
             f"{_event_ms(lambda a=a: torch.linalg.eigh(a), 50):.4f} ms (torch.linalg.eigh), bound "
             f"{bound:.2e} ms ({by})")
    return out, spec


def phase_profile_batched(streams, noises, cfg, steps=2):
    """The batched step under torch.profiler: device-busy share of the wall
    time and launches per step, after one untraced warm-up step."""
    from torch.profiler import ProfilerActivity, profile

    from maveric_slam_tpu_torch.frontend import tracker
    from maveric_slam_tpu_torch.models import superpoint as sp

    cuda = torch.device("cuda")
    params = sp.load_params(device=cuda)
    seq = torch.from_numpy(np.stack([f for f, _ in streams], axis=1)).to(cuda)
    dev_noise = [(g.to(cuda), l.to(cuda)) for g, l in noises]
    states = tracker.init_states_batched(params, seq[0], cfg)
    states, _ = tracker.track_step_batched(params, states, seq[1], cfg, *dev_noise[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(1, 1 + steps):
            states, _ = tracker.track_step_batched(params, states, seq[j + 1], cfg, *dev_noise[j])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    _log(f"[profile] batched S={seq.shape[1]}, {steps} steps: wall {wall_ms / steps:.3f} ms/step, "
         f"device busy {busy_ms / steps:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}%), "
         f"{len(kern) / steps:.0f} kernels/step")


def phase_traced(rows, spec, layers, frames, noises, cfg, inp, streams, noises_b, slice_calls, slam_run):
    """The profiler's numbers, taken after every untraced timing: each
    kernel's own device time, the layered stage 1's device time beside the
    stem's, each layer's device-busy time and launches per call, the
    pairwise and backend calls' device-busy time and launches, the single
    and batched steps' device-busy shares and heaviest kernels, and the
    engine's."""
    from maveric_slam_tpu_torch.ops.kernels import detector, match, nullspace, refine_pose, stem, svd3

    for row, k in zip(rows, spec):
        row["device_ms"] = _device_ms(k["kern"], k["names"])
        _log(f"[traced] {row['name']}: device {row['device_ms']} ms/launch")
    qconv_traced(inp["qconv_calls"])
    rkw = inp["refine_kw"]
    for args in (inp["refine_pose"], inp["refine_pose16"]):
        dev_ms = _device_ms(lambda args=args: refine_pose.refine_pose(*args, **rkw), ("refine_pose_kernel",))
        floor_ms = _device_ms(lambda args=args: refine_pose.refine_pose(*args, **rkw, iterations=0),
                              ("refine_pose_kernel",))
        _log(f"[traced] refine_pose (S={args[1].shape[0]} N={args[3].shape[1]}): device {dev_ms} "
             f"ms/launch; floor (0 iterations) device {floor_ms} ms/launch")
    for a in inp["nullspace"][1:] + inp["nullspace16"]:
        dev_ms = _device_ms(lambda a=a: nullspace.nullspace_inverse_iteration(a), ("nullspace_kernel",))
        _log(f"[traced] nullspace {tuple(a.shape)}: device {dev_ms} ms/launch")
    for a in inp["svd3"][1:3] + inp["svd3_16"]:
        dev_ms = _device_ms(lambda a=a: svd3.svd3(a), ("svd3_kernel",))
        _log(f"[traced] svd3 {tuple(a.shape)}: device {dev_ms} ms/launch")
    det16, m16 = inp["detector16"], inp["match16"]
    dev_ms = _device_ms(lambda: detector.detector_postproc(*det16), ("detector_kernel",))
    _log(f"[traced] detector_postproc (S=16 C={det16[0].shape[1]}): device {dev_ms} ms/launch")
    dev_ms = _device_ms(lambda: match.windowed_match(*m16, **inp["match_kw"]), ("match_kernel",))
    _log(f"[traced] windowed_match (S=16 N={m16[0].shape[1]}): device {dev_ms} ms/launch")
    for label in ("(1, 192, 640) orbit", "(16, 192, 640) streams"):
        img = inp["stem"][label]
        kern = _device_ms(lambda: stem.fused_stem(img, *inp["stem_args"]), ("stem_kernel",), 20)
        busy, count = _kernel_events(lambda: stem.fused_stem_plain(img, *inp["stem_args"]), 3)
        _log(f"[traced] stage 1 at {label}: fused_stem device {kern} ms/launch; layered stage 1 "
             f"(the path it replaces) device busy {busy:.3f} ms/call, {count:.0f} kernels/call")
    for name, fn in layers:
        busy, count = _kernel_events(fn, 5)
        _log(f"[traced] {name}: device busy {busy:.3f} ms/call, {count:.0f} kernels/call")
    for name, fn in slice_calls.items():
        busy, count = _kernel_events(fn, 3)
        _log(f"[traced] {name}: device busy {busy:.3f} ms/call, {count:.0f} kernels/call")
    phase_profile(frames, noises, cfg)
    phase_profile_batched(streams, noises_b, cfg)
    phase_profile_slam(cfg, slam_run)




def decomposition_reference(E):
    """numpy float64, independent of the port: E's singular values and its
    decomposition (R1, R2, t) = (U W V^T, U W^T V^T, U[:, 2]) with U and V
    turned into proper rotations."""
    U, s, Vt = np.linalg.svd(E.astype(np.float64))
    V = np.swapaxes(Vt, -1, -2)
    for M in (U, V):
        M[np.linalg.det(M) < 0, :, 2] *= -1
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    Vt = np.swapaxes(V, -1, -2)
    return s, U @ W @ Vt, U @ W.T @ Vt, U[..., 2]


def check_decomposition(E, dec, ref):
    """The largest faults of a decomposition (R1, R2, t) of each of E's
    matrices, none of them moved by E's conditioning: |R^T R - I| and
    |det R - 1| of both rotations, ||t| - 1|, R1 R2^T against the half turn
    about t (2 t t^T - I), and how far [t]x R2 falls short of E's best
    essential fit, s0 + s1 - <E, [t]x R2> over max|E| (Ehat = U diag(1, 1,
    0) V^T does not move when s0 and s1 meet). Where t is well determined
    ((s1 - |s2|) / s0 >= SURFACE_GAP), the pair (in either order) and t (up
    to sign) against the float64 reference."""
    from maveric_slam_tpu_torch.ops.lie import hat

    s, R1r, R2r, tr = ref
    R1, R2, t = (x.double() for x in dec)
    Ed = E.double()
    eye = torch.eye(3, dtype=torch.float64)
    ortho = max(float((R.transpose(-1, -2) @ R - eye).abs().max()) for R in (R1, R2))
    det = max(float((torch.linalg.det(R) - 1).abs().max()) for R in (R1, R2))
    norm = float((t.norm(dim=-1) - 1).abs().max())
    half = float((R1 @ R2.transpose(-1, -2) - (2 * t[..., :, None] * t[..., None, :] - eye)).abs().max())
    fit = (torch.from_numpy(s[:, 0] + s[:, 1]) - (Ed * (hat(t) @ R2)).sum((-1, -2))) / float(Ed.abs().max())
    well = torch.from_numpy((s[:, 1] - s[:, 2]) / s[:, 0] >= SURFACE_GAP)
    R1r, R2r, tr = (torch.from_numpy(x) for x in (R1r, R2r, tr))
    same = torch.maximum((R1 - R1r).abs().amax((-1, -2)), (R2 - R2r).abs().amax((-1, -2)))
    swapped = torch.maximum((R1 - R2r).abs().amax((-1, -2)), (R2 - R1r).abs().amax((-1, -2)))
    pair = torch.minimum(same, swapped)[well]
    tgap = torch.minimum((t - tr).abs().amax(-1), (t + tr).abs().amax(-1))[well]
    return {"ortho": ortho, "det": det, "|t|": norm, "half turn": half, "fit": float(fit.max()),
            "well determined": int(well.sum()), "pair": float(pair.max()), "t": float(tgap.max())}


def votes_in_reach(R, t, p1, p2, w, safety=2.0):
    """The cheirality vote of `choose_pose_by_cheirality` for candidates
    (R, t) (..., 3, 3), (..., 3) and points p1, p2 (M, 2), weights w (M,):
    the midpoint triangulation's depths in both cameras, written out here in
    float64 on the CPU. Returns the votes (..., M) and the votes an f32
    evaluation of the same formulas, in any summation order, can flip: a
    depth within `safety` times its first-order f32 rounding bound of 0
    (each product, sum of 3 and difference of products carrying its
    inputs' bounds and its own rounding)."""
    eps = 2.0 ** -24
    R, t, p1, p2, w = (x.double() for x in (R, t, p1, p2, w))
    a = torch.cat([p1, torch.ones_like(p1[:, :1])], -1).expand(*R.shape[:-2], -1, -1)
    d2 = torch.cat([p2, torch.ones_like(p2[:, :1])], -1)
    Rt = R.transpose(-1, -2)[..., None, :, :]
    b, eb = (Rt @ d2[..., None])[..., 0], 3 * eps * (Rt.abs() @ d2.abs()[..., None])[..., 0]
    c2 = -(Rt @ t[..., None, :, None])[..., 0]
    ec = 3 * eps * (Rt.abs() @ t.abs()[..., None, :, None])[..., 0]

    def dot(x, ex, y, ey):
        return ((x * y).sum(-1), 3 * eps * (x * y).abs().sum(-1) + (ex * y.abs()).sum(-1)
                + (x.abs() * ey).sum(-1))

    def diff(x, y, p, q):  # x y - p q, each a (value, bound) pair
        (x, ex), (y, ey), (p, ep), (q, eq) = x, y, p, q
        return (x * y - p * q, ex * y.abs() + x.abs() * ey + ep * q.abs() + p.abs() * eq
                + 2 * eps * ((x * y).abs() + (p * q).abs()))

    zero = torch.zeros_like(a)
    aa, bb, ab = dot(a, zero, a, zero), dot(b, eb, b, eb), dot(a, zero, b, eb)
    ac, bc = dot(a, zero, c2, ec), dot(b, eb, c2, ec)
    (den, eden), (ns, ens), (nu, enu) = diff(aa, bb, ab, ab), diff(ac, bb, bc, ab), diff(ac, ab, bc, aa)
    s, u = ns / den, nu / den
    es = (ens + s.abs() * eden) / den.abs() + eps * s.abs()
    eu = (enu + u.abs() * eden) / den.abs() + eps * u.abs()
    X = 0.5 * (s[..., None] * a + c2 + u[..., None] * b)
    eX = (0.5 * (es[..., None] * a.abs() + ec + eu[..., None] * b.abs() + u.abs()[..., None] * eb)
          + 2 * eps * ((s[..., None] * a).abs() + c2.abs() + (u[..., None] * b).abs()))
    RX = R[..., None, 2, :] * X
    z1, ez1 = X[..., 2], safety * eX[..., 2]
    z2 = RX.sum(-1) + t[..., None, 2]
    ez2 = safety * ((R[..., None, 2, :].abs() * eX).sum(-1)
                    + 4 * eps * (RX.abs().sum(-1) + t[..., None, 2].abs()))
    votes = (z1 > 0) & (z2 > 0) & (w > 0)
    reach = ((z1.abs() <= ez1) & (z2 > -ez2) | (z2.abs() <= ez2) & (z1 > -ez1)) & (w > 0)
    return votes, reach


def check_recover_pose(dec, rec, p1, p2, w):
    """recover_pose's choice against one counting function
    (`votes_in_reach`) applied to the same decomposition's four candidates.
    Per matrix: the chosen (R, t) is one of the four bitwise; its count lies
    between its sure votes and its sure or reachable ones; and those reach
    the largest count of sure votes among the four. Returns the number of
    matrices outside each, and the reachable votes."""
    R1, R2, t = dec
    Rc, tc, n = rec
    cands_R, cands_t = torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])
    votes, reach = votes_in_reach(cands_R, cands_t, p1, p2, w)
    sure, maybe = (votes & ~reach).sum(-1), (votes | reach).sum(-1)  # (4, B)
    hit = (cands_R == Rc).flatten(-2).all(-1) & (cands_t == tc).all(-1)
    k = torch.argmax(hit.int(), 0)
    lo, hi = sure.gather(0, k[None])[0], maybe.gather(0, k[None])[0]
    return {"not a candidate": int((~hit.any(0)).sum()),
            "count outside its votes": int(((n < lo) | (n > hi)).sum()),
            "not the most votes": int((hi < sure.amax(0)).sum()),
            "reachable votes": int(reach.sum())}


def phase_surface(cfg, frames, pw_inp):
    """[surface]: the JAX package's library surface on the card.
    `polar_decomposition`, `decompose_essential` and `recover_pose` on the
    pairwise path's 256 essential matrices (its matched points, M = 1000,
    for the cheirality vote), launch counts set to 0 just before: one svd3
    launch each and no other kernel. Polar: R P reconstructs E within 1e-3
    max|E|, det R within 1e-3 of 1, P within 1e-3 max|E| of the CPU's. The
    decomposition (`check_decomposition`): rotations, |t|, the half turn
    and the essential fit within 1e-3 on every matrix, and the pair and t
    within 1e-3 of numpy's float64 decomposition where t is well
    determined. recover_pose (`check_recover_pose`): a candidate of the
    card's decomposition with the most votes by one float64 count, up to
    votes within f32 rounding's reach. `_surface_lo_rounds`: two LO
    rounds, card against CPU. `superpoint_float` at (1, H, W) with
    TF32 off: the card's largest error against the network in float64 on
    the CPU at most twice the CPU's f32 error (the planned rtol 1e-5 / atol
    1e-5 does not hold between two f32 summation orders: ROADMAP Faults
    (q))."""
    from maveric_slam_tpu_torch.geometry import epipolar
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels, svd3 as svd3_ops

    E, p1, p2, w = pw_inp["E"], pw_inp["p1"], pw_inp["p2"], pw_inp["mask"].float()
    _sync()
    kernels.reset_launch_counts()
    card = {"polar": svd3_ops.polar_decomposition(E), "decompose": epipolar.decompose_essential(E),
            "recover": epipolar.recover_pose(E, p1, p2, w)}
    _sync()
    launches = kernels.launch_counts()
    card = {k: [x.cpu() for x in v] for k, v in card.items()}
    Ec = E.cpu()
    m = float(Ec.abs().max())
    (R, P), Pc = card["polar"], svd3_ops.polar_decomposition(Ec)[1]
    recon = float((R @ P - Ec).abs().max())
    det = float((torch.linalg.det(R) - 1).abs().max())
    dP = float((P - Pc).abs().max())
    ref = decomposition_reference(Ec.numpy())
    dec = check_decomposition(Ec, card["decompose"], ref)
    rec = check_recover_pose(card["decompose"], card["recover"], p1.cpu(), p2.cpu(), w.cpu())
    _log(f"[surface] on the pairwise path's {tuple(E.shape)} essential matrices (max |E| {m:.3g}) and "
         f"its {int(w.sum())} matches: kernels {json.dumps(launches)}; polar: recon {recon:.3g}, "
         f"|det R - 1| {det:.3g}, P card-CPU {dP:.3g}; decompose_essential (bars 1e-3; pair and t "
         f"on the matrices with (s1 - |s2|) / s0 >= {SURFACE_GAP}): {json.dumps(dec)}; recover_pose: "
         f"{json.dumps(rec)}; counts median {float(card['recover'][2].float().median()):.0f}")
    expected = {"detector_postproc": 0, "windowed_match": 0, "nullspace_inverse_iteration": 0, "svd3": 3,
                "fused_stem": 0, "refine_pose": 0, "qconv": 0}
    bars = ("ortho", "det", "|t|", "half turn", "fit", "pair", "t")
    checks = [
        (launches == expected, f"launches {launches}, expected {expected}"),
        (recon <= 1e-3 * m and det <= 1e-3 and dP <= 1e-3 * m, f"polar {recon} {det} {dP}"),
        (all(dec[k] <= 1e-3 for k in bars), f"decompose_essential {dec}"),
        (not any(v for k, v in rec.items() if k != "reachable votes"), f"recover_pose {rec}"),
    ]

    checks += [_surface_lo_rounds(cfg, pw_inp)]

    torch.cuda.synchronize()
    _require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
             "surface: TF32 is on")
    img = torch.from_numpy(np.stack([frames[0]]))
    cpu = torch.device("cpu")
    runs = {"card": (torch.device("cuda"), torch.float32), "cpu": (cpu, torch.float32),
            "f64": (cpu, torch.float64)}
    out = {}
    for name, (dev, dtype) in runs.items():
        params = sp.load_params(device=dev)
        if dtype == torch.float64:
            params = {k: v.double() if v.is_floating_point() else v for k, v in params.items()}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out[name] = [x.cpu().double() for x in sp.superpoint_float(params, img.to(dev, dtype), dtype)]
        if name == "card":
            _sync()
            float_s, float_launches = time.perf_counter() - t0, kernels.launch_counts()
    errs = []
    for k, name in enumerate(("semi", "desc")):
        g, c, x = (out[key][k] for key in ("card", "cpu", "f64"))
        off = float(((g - c).abs() > 1e-5 + 1e-5 * c.abs()).float().mean())
        errs.append((name, float((g - x).abs().max()), float((c - x).abs().max()), off,
                     float((g - c).abs().max()), float(x.abs().max())))
    _log(f"[surface] superpoint_float at (1, {H}, {W}) on the card in {1e3 * float_s:.3f} ms (first "
         f"call), kernels {json.dumps(float_launches)}; " + "; ".join(
             f"{n}: max |card - CPU f64| {ge:.3g}, |CPU - CPU f64| {ce:.3g}, card-CPU {d:.3g} (max |x| "
             f"{mx:.3g}), {100 * off:.4f}% outside rtol 1e-5 / atol 1e-5" for n, ge, ce, off, d, mx in errs))
    checks += [(all(ge <= 2 * ce for _, ge, ce, _, _, _ in errs), f"superpoint_float errors {errs}"),
               (not any(float_launches.values()), f"superpoint_float launched {float_launches}")]
    _require(all(ok for ok, _ in checks), "surface: " + "; ".join(w for ok, w in checks if not ok))


def _surface_lo_rounds(cfg, pw_inp):
    """`ransac_essential(..., lo_rounds=SURFACE_LO_ROUNDS)` on pair 0->1's
    matches (M = 1000) with its noise, the later rounds' rows drawn from a
    generator seeded SURFACE_LO_SEED, on the card (launch counts set to 0
    just before) and on the CPU; returns the check. Each LO round is one
    `estimate_essential` of its resamples: one nullspace launch and one svd3
    launch (the projection) more than the call with one round's 4 and 3."""
    from maveric_slam_tpu_torch.geometry import ransac
    from maveric_slam_tpu_torch.ops import kernels

    glo = pw_inp["glo"].cpu()
    gen = torch.Generator().manual_seed(SURFACE_LO_SEED)
    glo = torch.stack([glo] + [ransac.gumbel(glo.shape, gen, "cpu") for _ in range(SURFACE_LO_ROUNDS - 1)])
    out = {}
    for name, dev in (("card", torch.device("cuda")), ("cpu", torch.device("cpu"))):
        p1, p2, mask, gmin, gl = [pw_inp[k].to(dev) for k in ("p1", "p2", "mask", "gmin")] + [glo.to(dev)]
        _sync()
        kernels.reset_launch_counts()
        r = ransac.ransac_essential(p1, p2, mask, cfg.ransac.inlier_thresh,
                                    num_hypotheses=cfg.ransac.num_hypotheses,
                                    lo_rounds=SURFACE_LO_ROUNDS, gumbel_min=gmin, gumbel_lo=gl)
        _sync()
        out[name] = _to_cpu(r), kernels.launch_counts()
    (g, launches), (c, _) = out["card"], out["cpu"]
    extra = SURFACE_LO_ROUNDS - 1
    expected = {"detector_postproc": 0, "windowed_match": 0, "nullspace_inverse_iteration": 4 + extra,
                "svd3": 3 + extra, "fused_stem": 0, "refine_pose": 0, "qconv": 0}
    drot = _rot_deg(g.R.numpy(), c.R.numpy())
    _log(f"[surface] ransac_essential(lo_rounds={SURFACE_LO_ROUNDS}) on pair {PAIRS[0]}'s "
         f"{int(pw_inp['mask'].sum())} matches: kernels {json.dumps(launches)} (expected "
         f"{json.dumps(expected)}); inliers card {int(g.num_inliers)} CPU {int(c.num_inliers)}, rot "
         f"diff {drot:.5f} deg, max |dR| {float((g.R - c.R).abs().max()):.3g} max |dt| "
         f"{float((g.t - c.t).abs().max()):.3g}")
    return (launches == expected and drot < 1.0 and int(g.num_inliers) > 30,
            f"lo_rounds={SURFACE_LO_ROUNDS}: launches {launches}, rot diff {drot} deg, inliers "
            f"{int(g.num_inliers)}")


def degenerate_sequences(frames):
    """tests/test_degenerate.py's two tracker sequences on three frames:
    {name: [first frame, the frame of each step]}."""
    black = np.zeros_like(frames[0])
    return {"black": [frames[0], frames[1], black, frames[1], frames[2]],
            "repeated": [frames[0]] * 4}


def phase_degenerate(cfg, frames):
    """tests/test_degenerate.py's tracker cases through `Tracker` at 192x640
    on the card, each sequence with its own launch counts (set to 0 before
    it, read after each step): real -> black gives a step that is not valid,
    the previous step's R and t (atol 1e-6) and no match; black -> real stays
    not valid; real -> real recovers with > 20 inliers; three repeats of a
    frame stay finite. Every kernel launches on the black frame (the stem on
    an all-zero image, top-N with no cell selected). The same sequences and
    noise through the port on the CPU: the valid flags equal, and each
    fallback pose (a step that is not valid) within the [cpu-vs-card] bar of
    1 deg of the CPU's (Faults (g)). A repeated frame's own pose is not
    compared: a pair without baseline leaves the translation, and so the
    chosen decomposition, undetermined."""
    from maveric_slam_tpu_torch.frontend.tracker import Tracker
    from maveric_slam_tpu_torch.geometry import ransac
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels

    m, k = cfg.frontend.top_n, cfg.ransac.num_hypotheses
    gen = torch.Generator().manual_seed(DEGENERATE_SEED)
    noise = [(ransac.gumbel((k, m), gen, "cpu"), ransac.gumbel((ransac.lo_hypotheses(k), m), gen, "cpu"))
             for _ in range(4)]
    per_step = {"fused_stem": 1, "detector_postproc": 1, "windowed_match": 1,
                "nullspace_inverse_iteration": 4, "svd3": 3, "refine_pose": 1, "qconv": QCONV}

    def run(dev, seq):
        tr = Tracker(sp.load_params(device=dev), cfg, device=dev)
        steps = []
        _sync()
        kernels.reset_launch_counts()
        tr.process(seq[0])
        for f, (gmin, glo) in zip(seq[1:], noise):
            before = kernels.launch_counts()
            s = tr.process(f, gmin.to(dev), glo.to(dev))
            _sync()
            after = kernels.launch_counts()
            steps.append({
                "R": s.R.cpu().numpy(), "t": s.t.cpu().numpy(), "matched": bool(s.match_mask.any()),
                "finite": all(bool(torch.isfinite(x).all()) for x in s if x.is_floating_point())
                and bool(torch.isfinite(tr.state.scale)),
                "launches": {n: after[n] - before[n] for n in after}, **tr.stats[-1]})
        return steps, kernels.launch_counts()

    checks = []
    for name, seq in degenerate_sequences(frames).items():
        card, launches = run(torch.device("cuda"), seq)
        cpu, _ = run(torch.device("cpu"), seq)
        want = {n: c * (len(seq) - 1) for n, c in per_step.items()}
        want.update(fused_stem=len(seq), detector_postproc=len(seq), qconv=QCONV * len(seq))
        for j, (g, c) in enumerate(zip(card, cpu)):
            _log(f"[degenerate] {name} step {j}: valid {g['valid']}/{c['valid']} (card/CPU), matches "
                 f"{g['matches']}/{c['matches']}, inliers {g['inliers']}/{c['inliers']}, finite "
                 f"{g['finite']}, rot diff {_rot_deg(g['R'], c['R']):.4f} deg, max |dt| "
                 f"{np.abs(g['t'] - c['t']).max():.3g}; launches {json.dumps(g['launches'])}")
        _log(f"[degenerate] {name}: kernels {json.dumps(launches)} (expected {json.dumps(want)})")
        checks += [
            (launches == want, f"{name}: launches {launches}, expected {want}"),
            (all(g["finite"] for g in card), f"{name}: a step is not finite"),
            ([g["valid"] for g in card] == [c["valid"] for c in cpu], f"{name}: valid flags differ"),
            (all(_rot_deg(g["R"], c["R"]) < 1.0 for g, c in zip(card, cpu) if not c["valid"]),
             f"{name}: card and CPU fallback rotations differ by 1 deg or more"),
        ]
        if name == "black":
            s0, s1, s2, s3 = card
            checks += [
                (s1["launches"] == per_step, f"black frame launched {s1['launches']}"),
                (s0["valid"] and not s1["valid"] and not s2["valid"] and s3["valid"],
                 f"valid flags {[s['valid'] for s in card]}"),
                (np.abs(s1["R"] - s0["R"]).max() <= 1e-6 and np.abs(s1["t"] - s0["t"]).max() <= 1e-6,
                 "the black frame's pose is not the previous step's"),
                (not s1["matched"], "the black frame matched"),
                (s3["inliers"] > 20, f"recovered with {s3['inliers']} inliers"),
            ]
    _require(all(ok for ok, _ in checks), "degenerate: " + "; ".join(w for ok, w in checks if not ok))


def img_of(frame, images=LONG_IMAGES):
    """The image shown at a ping-pong frame (tests/test_long_sequence.py:31)."""
    from maveric_slam_tpu_torch.bench.common import ping_pong

    return ping_pong(frame, images)


def long_config(cfg, ring, nodes=LONG_NODES):
    """tests/test_long_sequence.py's loop-closure settings on `cfg`."""
    return dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, max_db_frames=ring, min_frame_gap=LONG_GAP, min_score=LONG_MIN_SCORE,
        max_graph_nodes=nodes))


def record_skeletons(slam):
    """The engine with each pose-graph node set kept in `slam.skeletons`:
    (matched frame, current frame, nodes, whether the stride subsampled
    them). Works on either package's SlamSystem."""
    slam.skeletons = []
    nodes_of = slam._skeleton_nodes

    def keep(matched, cur):
        nodes = nodes_of(matched, cur)
        ends = {f for e in slam.loop_edges for f in e[:2]} | {0, matched, cur}
        every = sorted(f for f in set(slam.kf_frames) | ends if f < len(slam.poses))
        slam.skeletons.append((matched, cur, nodes, nodes != every))
        return nodes

    slam._skeleton_nodes = keep
    return slam


def long_checks(slam, n_frames, cfg, image_gap=LONG_IMAGE_GAP):
    """tests/test_long_sequence.py:60-96 on an engine that has run
    `n_frames` ping-pong frames, scaled to its ring: [(ok, what)]. Works on
    either package's SlamSystem."""
    ring, kc = cfg.loop.max_db_frames, cfg.keyframe
    stored = sorted(e["frame"] for e in slam.kf_store if e is not None)
    db = slam.db.frames
    db = set((db.cpu().numpy() if isinstance(db, torch.Tensor) else np.asarray(db)).tolist())
    n_kf = len(slam.kf_frames)
    wrap = ring * kc.max_interval  # frames until the ring first wraps
    pairs = [(e.frame, e.matched_frame) for e in slam.loop_events]
    traj = slam.trajectory()
    return [
        (len(slam.kf_store) == ring == len(stored), f"{len(stored)} of {len(slam.kf_store)} slots filled "
                                                    f"(ring {ring})"),
        (slam.db.multihot.shape[0] == ring, f"a database of {slam.db.multihot.shape[0]} rows"),
        (n_frames // kc.max_interval - 1 <= n_kf <= n_frames // kc.min_interval,
         f"{n_kf} keyframes (cadence bounds {n_frames // kc.max_interval - 1}.."
         f"{n_frames // kc.min_interval})"),
        (n_kf > 3 * ring, f"{n_kf} keyframes: {n_kf / ring:.2f} turns of the ring (at least 3)"),
        (len(slam.tracks.observations) <= 4 * cfg.frontend.num_cells,
         f"{len(slam.tracks.observations)} tracks (at most {4 * cfg.frontend.num_cells})"),
        (stored[0] >= n_frames - wrap - 1, f"oldest stored keyframe {stored[0]} (at least "
                                           f"{n_frames - wrap - 1})"),
        (db == set(stored), f"the database's frames are the store's: {db == set(stored)}"),
        (bool(pairs), f"{len(pairs)} loop closures"),
        (any(f > 3 * wrap for f, _ in pairs),
         f"{sum(f > 3 * wrap for f, _ in pairs)} loop closures after frame {3 * wrap}"),
        (all(abs(img_of(f) - img_of(m)) <= image_gap for f, m in pairs),
         f"loop pairs' images at most {max((abs(img_of(f) - img_of(m)) for f, m in pairs), default=0)} "
         f"apart (bar {image_gap})"),
        (all(f - m >= cfg.loop.min_frame_gap for f, m in pairs),
         f"loop pairs at least {min((f - m for f, m in pairs), default=0)} frames apart (bar "
         f"{cfg.loop.min_frame_gap})"),
        (traj.shape == (n_frames, 4, 4) and bool(np.isfinite(traj).all()),
         f"trajectory {traj.shape}, finite {bool(np.isfinite(traj).all())}"),
    ]


def repair_stream(images, n=LONG_REPAIR_FRAMES, black=LONG_BLACK, seed=42):
    """tests/test_long_sequence.py:114-126: the ping-pong frames with noise,
    the `black` frames replaced by a flat 0.02."""
    rng = np.random.default_rng(seed)
    out = [np.clip(images[img_of(f)] + rng.normal(0, 0.02, images[0].shape).astype(np.float32), 0, 1
                   ).astype(np.float32) for f in range(n)]
    for g in black:
        out[g] = np.zeros_like(out[g]) + 0.02
    return out


def epoch_drift(P):
    """Distance of each late mid-corridor frame's position from its
    first-epoch twin's (tests/test_long_sequence.py:152)."""
    period = 2 * (LONG_IMAGES - 1)
    return np.array([np.linalg.norm(P[f] - P[f % period]) for f in range(160, len(P))
                     if 3 <= img_of(f) <= 7])


def phase_long(cfg, renders):
    """tests/test_long_sequence.py on the card at 192x640 over the first
    LONG_IMAGES orbit frames ping-ponged, each engine drawing its own noise:
    the structural run (LONG_FRAMES frames, a LONG_RING-slot ring) with
    every check of `long_checks`, the pose graph's node set subsampled at
    least once, every kernel launched; median and p90 wall a frame, loop
    closures after the ring's first wrap. Then the fault-repair pair: with
    loop closure the late frames' drift from their first-epoch twins below
    0.8 of the odometry's on average, and at most 1.5 m above its largest."""
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops import kernels
    from maveric_slam_tpu_torch.slam import SlamSystem

    cuda = torch.device("cuda")
    params = sp.load_params(device=cuda)
    images = [renders[k] for k in range(LONG_IMAGES)]
    lcfg = long_config(cfg, LONG_RING)
    slam = record_skeletons(SlamSystem(params, lcfg, ba_every=0, enable_loop_closure=True, device=cuda))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    wall = []
    for f in range(LONG_FRAMES):
        t0 = time.perf_counter()
        slam.process(images[img_of(f)])
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    checks = long_checks(slam, LONG_FRAMES, lcfg)
    launches = kernels.launch_counts()
    wrap = LONG_RING * lcfg.keyframe.max_interval
    pairs = [(e.frame, e.matched_frame, e.num_inliers) for e in slam.loop_events]
    strided = [len(nodes) for *_, nodes, s in slam.skeletons if s]
    w = np.array(wall[1:]) * 1e3
    _log(f"[long] {LONG_FRAMES} frames, ring {LONG_RING}: {len(slam.kf_frames)} keyframes, "
         f"{sum(s['valid'] for s in slam.stats)}/{len(slam.stats)} valid; wall a frame median "
         f"{np.median(w):.3f} ms, p90 {np.percentile(w, 90):.3f} ms; {len(pairs)} loop closures, "
         f"{sum(f > wrap for f, _, _ in pairs)} after the ring's first wrap (frame {wrap}); pose graph "
         f"{len(slam.skeletons)} solves, {len(strided)} on a subsampled node set (sizes {strided})")
    _log(f"[long] loop closures (frame, matched, inliers), images: "
         f"{[(p, img_of(p[0]), img_of(p[1])) for p in pairs]}")
    _log(f"[long] kernels {json.dumps(launches)}")
    checks += [(bool(strided), f"{len(strided)} pose-graph solves on a subsampled node set"),
               (all(v > 0 for v in launches.values()), f"launches {launches}")]
    for ok, what in checks:
        _log(f"[long] {'holds' if ok else 'FAILS'}: {what}")
    _require(all(ok for ok, _ in checks), "long: " + "; ".join(w for ok, w in checks if not ok))

    stream = repair_stream(images)
    rcfg = long_config(cfg, LONG_REPAIR_RING)
    P = {}
    for lc in (True, False):
        s = SlamSystem(params, rcfg, ba_every=0, enable_loop_closure=lc, device=cuda)
        for f in stream:
            s.process(f)
        P[lc] = s.trajectory()[:, :3, 3]
        if lc:
            _log(f"[long] repair, loop closure on: {len(s.loop_events)} closures "
                 f"{[(e.frame, e.matched_frame) for e in s.loop_events]}")
    d_on, d_off = epoch_drift(P[True]), epoch_drift(P[False])
    _log(f"[long] repair over {LONG_REPAIR_FRAMES} frames, black {LONG_BLACK}: drift from the first "
         f"epoch mean {d_on.mean():.4f} m with loop closure, {d_off.mean():.4f} m without (ratio "
         f"{d_on.mean() / d_off.mean():.4f}, bar 0.8); max {d_on.max():.4f} / {d_off.max():.4f} m "
         f"(bar +1.5)")
    _require(bool(np.isfinite(d_on).all() and np.isfinite(d_off).all()), "repair: drift not finite")
    _require(d_on.mean() < 0.8 * d_off.mean() and d_on.max() < d_off.max() + 1.5,
             f"repair: drift {d_on.mean()} / {d_off.mean()}, max {d_on.max()} / {d_off.max()}")


def _numbers(x, path=""):
    """(path, number) of every number in a nest of dicts and lists."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _numbers(v, f"{path}.{k}")
    elif isinstance(x, list):
        for k, v in enumerate(x):
            yield from _numbers(v, f"{path}[{k}]")
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield path, x


def phase_bench():
    """The port's roofline profile (`maveric_slam_tpu_torch.bench.profile`)
    at its smallest rounds: every number it reports finite and positive, and
    every device-busy time (the net's, each layer's) given by the profiler.
    The full profile runs alone: `python -m maveric_slam_tpu_torch.bench.profile
    roofline`."""
    from maveric_slam_tpu_torch.bench import profile

    t0 = time.perf_counter()
    roofline = profile.roofline(torch.device("cuda"), iters=20)
    _log(f"[bench] roofline: {time.perf_counter() - t0:.1f} s")
    for r in roofline["rows"]:
        _log(f"[bench] roofline {r['layer']}: {r['ms']:.5f} ms a call, device busy "
             f"{r['device_busy_ms']} ms ({r['kernels']} kernels), {r['tflops']:.3f} TFLOP/s a call, "
             f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    bad = [(p, v) for p, v in _numbers(roofline) if not (np.isfinite(v) and v > 0)]
    _require(not bad, f"bench numbers not finite and positive: {bad}")
    busy = [roofline["net_device_busy_ms"]] + [r["device_busy_ms"] for r in roofline["rows"]]
    _require(None not in busy, f"a device-busy time the profiler did not give: {busy}")


def _phased(label, phase, *args):
    """Run one phase and log its wall time (the script's time budget)."""
    t0 = time.perf_counter()
    out = phase(*args)
    _log(f"[{label}] phase wall {time.perf_counter() - t0:.1f} s")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import maveric_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    from maveric_slam_tpu_torch.data import synthetic
    from maveric_slam_tpu_torch.geometry import ransac
    from maveric_slam_tpu_torch.ops import kernels
    from maveric_slam_tpu_torch.utils.trajectory import relative_from_poses

    cuda = torch.device("cuda")
    _log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device "
         f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_all = time.perf_counter()
    phase_build()
    if "--qconv" in sys.argv[1:]:  # the qconv kernel alone: bitwise, timed, traced
        qconv_traced(_phased("qconv", phase_qconv))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}}))
        return

    cfg = _config()
    orbit = synthetic.orbit_poses(ORBIT_N)
    K = cfg.working_camera.K
    poses = orbit[:CHUNK_FRAMES]
    frames = [synthetic.render_box_room(K, p, H, W) for p in poses]
    gt_R, gt_t = relative_from_poses(poses[:N_FRAMES])
    gen = torch.Generator().manual_seed(0)
    m, k = cfg.frontend.top_n, cfg.ransac.num_hypotheses
    lo_k = ransac.lo_hypotheses(k)
    noises = [(ransac.gumbel((k, m), gen, "cpu"), ransac.gumbel((lo_k, m), gen, "cpu"))
              for _ in range(CHUNK_FRAMES - 1)]
    # The batched phase: stream s runs the orbit from frame s * ORBIT_N / STREAMS.
    streams = []
    for s in range(STREAMS):
        sp_ = orbit[s * ORBIT_N // STREAMS:][:STREAM_FRAMES]
        streams.append(([synthetic.render_box_room(K, p, H, W) for p in sp_], sp_))
    gen_b = torch.Generator().manual_seed(1)
    noises_b = [(ransac.gumbel((STREAMS, k, m), gen_b, "cpu"),
                 ransac.gumbel((STREAMS, lo_k, m), gen_b, "cpu")) for _ in range(STREAM_FRAMES - 1)]

    # Renders by orbit index, reused by [slam].
    renders = {k: f for k, f in enumerate(frames)}
    for s, (imgs, _) in enumerate(streams):
        renders.update({s * ORBIT_N // STREAMS + j: f for j, f in enumerate(imgs)})
    _log(f"[env] scenes rendered in {time.perf_counter() - t_all:.1f} s")

    inp = kernel_inputs(cuda, frames, noises[0], cfg, [f for f, _ in streams])
    errs = _phased("kernels", phase_kernels, inp)
    inp["qconv_calls"] = _phased("qconv", phase_qconv)
    inp["qconv"], errs["qconv"] = inp["qconv_calls"][(1, H, W)], 0.0

    kernels.reset_launch_counts()
    steps, times = track(cuda, frames[:N_FRAMES], noises, cfg)
    launches = kernels.launch_counts()
    _log(f"[track] {H}x{W}, {len(steps)} steps, step time median "
         f"{np.median(times[WARMUP_STEPS:]) * 1e3:.3f} ms over steps {WARMUP_STEPS}.., all (ms): "
         + " ".join(f"{t * 1e3:.3f}" for t in times))
    _log(f"[track] kernels {json.dumps(launches)}")
    n_steps = len(steps)
    expected = {"detector_postproc": N_FRAMES, "windowed_match": n_steps,
                "nullspace_inverse_iteration": 4 * n_steps, "svd3": 3 * n_steps,
                "fused_stem": N_FRAMES, "refine_pose": n_steps, "qconv": QCONV * N_FRAMES}
    _require(launches == expected, f"launches {launches}, expected {expected}")
    check_poses(steps, gt_R, gt_t, "track")

    t0 = time.perf_counter()
    cpu_steps, _ = track(torch.device("cpu"), frames[:N_FRAMES], noises, cfg)
    _log(f"[cpu] phase wall {time.perf_counter() - t0:.1f} s")
    check_poses(cpu_steps, gt_R, gt_t, "cpu")
    _phased("cpu-vs-card", phase_cpu_vs_card, frames[:N_FRAMES], noises, cfg, steps, cpu_steps)

    b_times = _phased("batched", phase_batched, streams, noises_b, cfg)
    chunk_s = _phased("chunk", phase_chunk, frames, noises, cfg)
    pw_per_call, pw_inp, pw_call = _phased("pairwise", phase_pairwise, frames, orbit, cfg)
    pw_inp.update(check_pairwise_kernels(pw_inp))
    _phased("nms", phase_nms, frames, [f for f, _ in streams], cfg)
    backend_calls = {**_phased("ba", phase_ba, cfg),
                     "pose_graph.optimize": _phased("pose-graph", phase_pose_graph)}
    slam_run = _phased("slam", phase_slam, cfg, renders)
    _phased("slam-cpu", phase_slam_cpu, cfg, slam_run)
    _phased("resume", phase_resume, cfg, slam_run)
    _phased("elastic", phase_elastic, cfg, frames)
    _phased("host-pool", phase_host_pool)
    comp, scene, mesh_ref, mesh_runs, mesh_ckpt = _phased("mesh", phase_mesh, cfg, streams, noises_b,
                                                          slam_run, renders)
    mesh_engine = _phased("mesh-slam", phase_mesh_slam, cfg, slam_run, mesh_runs)
    _phased("mesh-resume", phase_mesh_resume, cfg, scene, mesh_runs, mesh_ckpt)
    _phased("mesh-nccl", phase_mesh_nccl, cfg, slam_run, comp, scene, mesh_ref)
    _phased("mesh-elastic", phase_mesh_elastic, cfg, frames)
    _phased("surface", phase_surface, cfg, frames, pw_inp)
    _phased("degenerate", phase_degenerate, cfg, frames[:3])
    _phased("long", phase_long, cfg, renders)
    _phased("bench", phase_bench)
    single_ms = float(np.median(times[WARMUP_STEPS:]) * 1e3)
    batched_ms = float(np.median(b_times[1:]) * 1e3)
    _log(f"[timing] single-stream step median {single_ms:.3f} ms = {1e3 / single_ms:.2f} frames/s")
    _log(f"[timing] batched step (S={STREAMS}) median {batched_ms:.3f} ms over steps 1.. "
         f"(all: {' '.join(f'{t * 1e3:.3f}' for t in b_times)}) = {STREAMS * 1e3 / batched_ms:.2f} "
         f"frames/s aggregate")
    _log(f"[timing] chunked (K={CHUNK}) chunks {' '.join(f'{t * 1e3:.3f}' for t in chunk_s)} ms = "
         f"{' '.join(f'{CHUNK / t:.2f}' for t in chunk_s)} frames/s")

    rows, spec = _phased("timing", phase_timing, inp, launches, errs, pw_per_call, pw_inp)
    layers = step_layers(frames, noises, cfg)
    _phased("layers", phase_layers, layers)
    _phased("traced", phase_traced, rows, spec, layers, frames, noises, cfg, inp, streams, noises_b,
            {"pairwise_pose": pw_call, **backend_calls}, slam_run)
    # The engine's path launches the same kernels at the same shapes as the
    # tracking step (and the verification's RANSAC at M = top_n): its rows
    # carry the [slam] run's launch counts beside the same measurements.
    rows += [dict(r, launches=slam_run["launches"][r["name"]],
                  shape=f"{r['shape']}; launches of the [slam] run ({SLAM_FRAMES} frames)")
             for r in rows[:len(kernels.MODULES)]]
    rows += [dict(r, launches=mesh_engine["launches"][r["name"]],
                  shape=f"{r['shape']}; launches of rank 0 of the [mesh-slam] run ({MESH_RANKS} "
                        f"ranks, {SLAM_FRAMES} frames)")
             for r in rows[:len(kernels.MODULES)]]
    _log(f"[done] {time.perf_counter() - t_all:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else f"nvidia-smi: {smi.stderr.strip()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
