#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`maveric_slam_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. build the five CUDA kernels from `maveric_slam_tpu_torch/csrc` (nvcc,
     all sources at once), print the build time and ptxas's resource lines,
     and check that the stem's SASS holds tensor-core (IMMA) instructions;
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
     batch), at the bars of ROADMAP.md;
  3. drive `Tracker` over a synthetic orbit at 192x640 (the main path) with
     every launch count set to 0 just before and read just after; check the
     counts, the step statistics and the poses against the exact ground truth;
  4. run the same frames and RANSAC noise through the port on the CPU and
     print the per-step differences from the card;
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
     reduced, card against CPU); each timed a call (host clock);
  6. time each kernel, its plain version and a one-call PyTorch yardstick
     where there is one (never used by the port) with CUDA events (the stem,
     detector and matcher also at S=16, the nullspace and svd3 at every
     main-path shape of step 2, with the plain versions and
     torch.linalg.eigh / torch.linalg.svd at the svd3 and batched
     nullspace shapes, and the nullspace and svd3 at the pairwise path's
     inputs), each layer of the step alone with the host clock, the
     batched step and the chunked tracker;
  7. then, under torch.profiler, each kernel's own device time (the stem,
     detector and matcher also at S=16, the nullspace and svd3 at every
     main-path shape of step 2), each layer's and each phase 5b call's
     device-busy time and launches, and the single and batched steps'
     device-busy shares (last, so that no untraced timing runs after a
     profiler).
The last three lines are the card's name and power limit, a JSON object of
per-kernel numbers, and `{"ok": true, "device": {...}}`.

It needs a card (torch.cuda.is_available()) and the checkout beside it; it
imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
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
CHUNK, CHUNK_FRAMES = 8, 17  # the chunked phase: two full chunks after the first frame
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


def kernel_inputs(dev, frames, noise, cfg, streams):
    """The five kernels' inputs as the tracking step forms them, from frames
    0 and 1: the images for the stem, detector logits, match queries and
    cells, the 8-point normal matrices of the minimal, LO and refit stages,
    and their nullspaces as 3x3 matrices for svd3; and the batched step's
    stem images, detector logits and match inputs from the first two frames
    of the 16 streams."""
    from maveric_slam_tpu_torch.geometry import epipolar
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


def phase_kernels(inp):
    """Each kernel against its plain version on the same card inputs."""
    from maveric_slam_tpu_torch.ops.kernels import match, nullspace, stem, svd3

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
                "fused_stem": n_steps + 1}
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
                "fused_stem": n_chunks + 1}
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
                "svd3": 3, "fused_stem": 2}
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
    return per_call, {"ata": ata, "E": nullspace.nullspace_plain(ata).reshape(-1, 3, 3)}, call


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
    tests/test_pose_graph.py requires, card against CPU. Returns the call
    for the profiler."""
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

    med, _ = _wall_ms(call, 10)
    med1, _ = _wall_ms(lambda: pose_graph.optimize(graph, iterations=1), 10)
    _log(f"[pose-graph] wall {med:.3f} ms a call of {GRAPH_ITERS} iterations, "
         f"{(med - med1) / (GRAPH_ITERS - 1):.3f} ms an iteration (median of 10)")
    return call


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


def phase_timing(inp, launches, errs, pw_per_call, pw_inp):
    from maveric_slam_tpu_torch.ops.kernels import detector, match, nullspace, stem, svd3

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
    ]
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
        row = {
            "name": k["name"], "route": "cuda",
            "source": f"maveric_slam_tpu_torch/csrc/{k['src']}", "replaces": k["replaces"],
            "launches": k["launches"], "max_abs_err": k["err"],
            "ms": min(kern1, kern2), "plain_ms": min(plain1, plain2),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib, "device_ms": None, "shape": k["shape"],
        }
        _log(f"[timing] {k['name']} ({k['shape']}): call {kern1:.4f}/{kern2:.4f} ms, "
             f"plain {plain1:.4f}/{plain2:.4f} ms, "
             f"library {lib if lib is None else f'{lib:.4f}'} ms, bound {row['bound_ms']:.2e} ms "
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


def phase_traced(rows, spec, layers, frames, noises, cfg, inp, streams, noises_b, slice_calls):
    """The profiler's numbers, taken after every untraced timing: each
    kernel's own device time, the layered stage 1's device time beside the
    stem's, each layer's device-busy time and launches per call, the
    pairwise and backend calls' device-busy time and launches, and the
    single and batched steps' device-busy shares and heaviest kernels."""
    from maveric_slam_tpu_torch.ops.kernels import detector, match, nullspace, stem, svd3

    for row, k in zip(rows, spec):
        row["device_ms"] = _device_ms(k["kern"], k["names"])
        _log(f"[traced] {row['name']}: device {row['device_ms']} ms/launch")
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

    inp = kernel_inputs(cuda, frames, noises[0], cfg, [f for f, _ in streams])
    errs = phase_kernels(inp)

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
                "fused_stem": N_FRAMES}
    _require(launches == expected, f"launches {launches}, expected {expected}")
    check_poses(steps, gt_R, gt_t, "track")

    cpu_steps, _ = track(torch.device("cpu"), frames[:N_FRAMES], noises, cfg)
    check_poses(cpu_steps, gt_R, gt_t, "cpu")
    for j, (g, c) in enumerate(zip(steps, cpu_steps)):
        _log(f"[cpu-vs-card] step {j}: matches {c['matches']}/{g['matches']} inliers "
             f"{c['inliers']}/{g['inliers']} max |dR| {np.abs(g['R'] - c['R']).max():.3g} "
             f"max |dt| {np.abs(g['t'] - c['t']).max():.3g} rot diff {_rot_deg(g['R'], c['R']):.4f} deg")
    _require(max(_rot_deg(g["R"], c["R"]) for g, c in zip(steps, cpu_steps)) < 1.0,
             "card and CPU rotations differ by 1 deg or more")

    b_times = phase_batched(streams, noises_b, cfg)
    chunk_s = phase_chunk(frames, noises, cfg)
    pw_per_call, pw_inp, pw_call = _phased("pairwise", phase_pairwise, frames, orbit, cfg)
    pw_inp.update(check_pairwise_kernels(pw_inp))
    _phased("nms", phase_nms, frames, [f for f, _ in streams], cfg)
    backend_calls = {**_phased("ba", phase_ba, cfg),
                     "pose_graph.optimize": _phased("pose-graph", phase_pose_graph)}
    single_ms = float(np.median(times[WARMUP_STEPS:]) * 1e3)
    batched_ms = float(np.median(b_times[1:]) * 1e3)
    _log(f"[timing] single-stream step median {single_ms:.3f} ms = {1e3 / single_ms:.2f} frames/s")
    _log(f"[timing] batched step (S={STREAMS}) median {batched_ms:.3f} ms over steps 1.. "
         f"(all: {' '.join(f'{t * 1e3:.3f}' for t in b_times)}) = {STREAMS * 1e3 / batched_ms:.2f} "
         f"frames/s aggregate")
    _log(f"[timing] chunked (K={CHUNK}) chunks {' '.join(f'{t * 1e3:.3f}' for t in chunk_s)} ms = "
         f"{' '.join(f'{CHUNK / t:.2f}' for t in chunk_s)} frames/s")

    rows, spec = phase_timing(inp, launches, errs, pw_per_call, pw_inp)
    layers = step_layers(frames, noises, cfg)
    phase_layers(layers)
    phase_traced(rows, spec, layers, frames, noises, cfg, inp, streams, noises_b,
                 {"pairwise_pose": pw_call, **backend_calls})
    _log(f"[done] {time.perf_counter() - t_all:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else f"nvidia-smi: {smi.stderr.strip()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
