"""Headline bench: tracked frames/s on one card (the port's bench.py).

    python -m maveric_slam_tpu_torch.bench.headline [--quick]

Prints one JSON line with bench.py's keys where their meaning holds:

- `value`: one stream's frames/s: `track_step` over ROUNDS content-unique
  orbit frames in orbit order, chained on its state;
- `aggregate_fps_16_streams`, `aggregate_fps_32_streams`:
  `track_step_batched` over S streams, stream s from orbit phase 12 s, over
  BATCHED_ROUNDS steps (S frames a step);
- `chunked_fps_k8`: `track_chunk` over CHUNKS chunks of K = 8 frames;
- `vs_baseline`: `value` over the frames/s of SuperPoint's float forward
  pass alone in PyTorch on the host's CPU (the reference's engine, a lower
  bound on its frame time), measured on the same machine;
- `mfu`: the frame's least time, summed over SuperPoint's layers (each
  layer's operations over the peak of the unit it runs on: int8 tensor
  cores 1979 TOP/s for stage 1, f32 CUDA cores 67 TFLOP/s for the rest), over
  the measured time a frame at the best aggregate rate (`frame_least_s` x
  the best of the rates above);
- `device` (the card's name, power limit and count) and `sync` (the
  protocol).

Each mode checks its steps before it reports: the share of valid steps,
the median inlier count and the median rotation error against the orbit's
exact ground truth, at bars a broken path cannot reach (CHECKS). `--quick`
(tools/quickbench.py's role) runs the single stream and 16 streams only, at
fewer rounds. The card's timings: inputs are uploaded before the clock
starts; the clock is the host's around work that ends in
`torch.cuda.synchronize()`.

tools/profile_modes.py needs no twin: it times these three modes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..frontend import tracker as trk
from ..models import superpoint as sp
from ..utils.trajectory import relative_from_poses
from . import common

ROUNDS, BATCHED_ROUNDS, CHUNK, CHUNKS, STREAMS = 128, 48, 8, 32, 12
# A step's checks: at least this share valid, this median inlier count (of
# top_n 100), and a median rotation error below this (deg) against the exact
# relative pose. On the orbit the port measures ~1.00 / 60-100 / < 0.3 deg
# (chip_smoke.py's [track]); features that do not match, a RANSAC that
# fits noise or a wrong pose fail them.
CHECKS = {"valid_share": 0.9, "median_inliers": 30, "median_rot_err_deg": 1.0}


def load(device: torch.device):
    """The weights on `device`; the kernels built before any clock runs."""
    if device.type == "cuda":
        from ..ops.kernels import _build

        _build.library()
    return sp.load_params(device=device)


def step_checks(label: str, valid, inliers, R, orbit: common.Orbit) -> dict:
    """The steps' validity figures against CHECKS; raises when one fails.
    Every step here moves one orbit frame, so its exact rotation is the
    orbit's first relative rotation."""
    R_gt = relative_from_poses(orbit.poses[:2])[0][0]
    out = {"valid_share": float(np.mean(valid)), "median_inliers": float(np.median(inliers)),
           "median_rot_err_deg": float(np.median(common.rot_err_deg(R, R_gt))), "steps": int(np.size(valid))}
    common.check(out["valid_share"] >= CHECKS["valid_share"]
                 and out["median_inliers"] >= CHECKS["median_inliers"]
                 and out["median_rot_err_deg"] < CHECKS["median_rot_err_deg"],
                 f"{label}: {out} against {CHECKS}")
    return out


def _stats(steps):
    """(valid, inliers, R) of the steps, one host copy each."""
    return (torch.stack([s.valid for s in steps]).cpu().numpy(),
            torch.stack([s.num_inliers for s in steps]).cpu().numpy(),
            torch.stack([s.R for s in steps]).cpu().numpy())


def measure_single(params, orbit: common.Orbit, device: torch.device, rounds: int = ROUNDS,
                   seed: int = 0) -> dict:
    """One stream: frames/s over `rounds` chained steps after 2 warm-ups."""
    cfg = common.config(orbit.h, orbit.w)
    imgs = [torch.from_numpy(f).to(device)
            for f in common.unique_frames(orbit.frames(range(rounds + 3)), seed)]
    state = trk.init_state(params, imgs[0], cfg)
    for img in imgs[1:3]:
        state, _ = trk.track_step(params, state, img, cfg)
    steps = []

    def run():
        nonlocal state
        for img in imgs[3:]:
            state, step = trk.track_step(params, state, img, cfg)
            steps.append(step)

    dt, _ = common.wall_s(run, device)
    return {"fps": rounds / dt, "ms_per_frame": dt / rounds * 1e3,
            "checks": step_checks("single stream", *_stats(steps), orbit)}


def measure_batched(params, orbit: common.Orbit, device: torch.device, streams: int,
                    rounds: int = BATCHED_ROUNDS, seed: int = 1) -> dict:
    """S streams, stream s from orbit phase 12 s: aggregate frames/s over
    `rounds` steps after one warm-up."""
    cfg = common.config(orbit.h, orbit.w)
    phase = [STREAMS * s for s in range(streams)]
    batches = [torch.from_numpy(b).to(device) for b in common.unique_frames(
        [np.stack(orbit.frames([p + r for p in phase])) for r in range(rounds + 2)], seed)]
    states = trk.init_states_batched(params, batches[0], cfg)
    states, _ = trk.track_step_batched(params, states, batches[1], cfg)
    steps = []

    def run():
        nonlocal states
        for b in batches[2:]:
            states, res = trk.track_step_batched(params, states, b, cfg)
            steps.append(res)

    dt, _ = common.wall_s(run, device)
    valid, inliers, R = _stats(steps)
    return {"fps": streams * rounds / dt, "ms_per_step": dt / rounds * 1e3,
            "checks": step_checks(f"{streams} streams", valid, inliers, R, orbit)}


def measure_chunked(params, orbit: common.Orbit, device: torch.device, chunk: int = CHUNK,
                    chunks: int = CHUNKS, seed: int = 2) -> dict:
    """One stream `chunk` frames a call: frames/s over `chunks` chunks after
    one warm-up chunk."""
    cfg = common.config(orbit.h, orbit.w)
    frames = common.unique_frames(orbit.frames(range(1 + chunk * (chunks + 1))), seed)
    state = trk.init_state(params, torch.from_numpy(frames[0]).to(device), cfg)
    stacks = [torch.from_numpy(np.stack(frames[1 + chunk * c:1 + chunk * (c + 1)])).to(device)
              for c in range(chunks + 1)]
    state, _ = trk.track_chunk(params, state, stacks[0], cfg)
    steps = []

    def run():
        nonlocal state
        for s in stacks[1:]:
            state, res = trk.track_chunk(params, state, s, cfg)
            steps.append(res)

    dt, _ = common.wall_s(run, device)
    valid, inliers, R = _stats(steps)
    return {"fps": chunk * chunks / dt, "ms_per_chunk": dt / chunks * 1e3,
            "checks": step_checks(f"chunks of {chunk}", valid, inliers, R, orbit)}


def measure_torch_cpu_baseline(orbit: common.Orbit, iters: int = 10) -> float:
    """Frames/s of SuperPoint's float forward pass alone, PyTorch's convs on
    the host's CPU (bench.py:171), on the orbit's frames."""
    import torch.nn.functional as F

    raw = np.load(sp.DEFAULT_WEIGHTS)
    conv = {n: (torch.from_numpy(raw[f"{n}_w"].astype(np.float32) * raw[f"{n}_wscale"]),
                torch.from_numpy(raw[f"{n}_b"].astype(np.float32))) for n in sp.LAYERS}

    def c(x, n, relu=True):
        w, b = conv[n]
        y = F.conv2d(x, w, b, padding=w.shape[-1] // 2)
        return F.relu(y) if relu else y

    def forward(img):
        x = torch.from_numpy(img)[None, None]
        for a, b in (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b")):
            x = F.max_pool2d(c(c(x, a), b), 2)
        x = c(c(x, "conv4a"), "conv4b")
        return c(c(x, "convPa"), "convPb", False), c(c(x, "convDa"), "convDb", False)

    frames = orbit.frames(range(iters))
    with torch.no_grad():
        forward(frames[0])
        t0 = time.perf_counter()
        for f in frames:
            forward(f)
        return iters / (time.perf_counter() - t0)


def run(device: torch.device, h: int = common.H, w: int = common.W, rounds: int = ROUNDS,
        batched_rounds: int = BATCHED_ROUNDS, chunks: int = CHUNKS, streams=(16, 32),
        chunk: int = CHUNK, baseline_iters: int = 10, quick: bool = False) -> dict:
    """Every mode at h x w on `device`; the headline record."""
    device = torch.device(device)
    params = load(device)
    orbit = common.Orbit(h, w)
    single = measure_single(params, orbit, device, rounds)
    modes = {"single": single}
    extras = {}
    for s in streams:
        modes[f"streams_{s}"] = measure_batched(params, orbit, device, s, batched_rounds)
        extras[f"aggregate_fps_{s}_streams"] = modes[f"streams_{s}"]["fps"]
    if not quick:
        modes[f"chunked_k{chunk}"] = measure_chunked(params, orbit, device, chunk, chunks)
        extras[f"chunked_fps_k{chunk}"] = modes[f"chunked_k{chunk}"]["fps"]
    baseline = None if quick else measure_torch_cpu_baseline(orbit, baseline_iters)
    best = max([v for k, v in extras.items() if k.startswith("aggregate")] or [single["fps"]])
    gflop = sum(layer["ops"] for layer in common.superpoint_flops(h, w)) / 1e9
    return {
        "metric": "tracked_frames_per_s_chip",
        "value": single["fps"],
        "unit": "frames/s",
        "vs_baseline": None if baseline is None else single["fps"] / baseline,
        **extras,
        "ms_per_frame_single": single["ms_per_frame"],
        "baseline_fps_torch_cpu_superpoint": baseline,
        "superpoint_gflop_per_frame": gflop,
        "achieved_tflops_best": best * gflop / 1e3,
        "frame_least_ms": common.frame_least_s(h, w) * 1e3,
        "mfu": common.frame_least_s(h, w) * best,
        "size": f"{h}x{w}",
        "checks": {k: v["checks"] for k, v in modes.items()},
        "device": common.device_info(device),
        "sync": "host clock around work ending in torch.cuda.synchronize(); inputs content-unique "
                "(noise sigma 0.02), uploaded before the clock; state chained step to step",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="single stream and 16 streams, fewer rounds")
    args = ap.parse_args(argv)
    device = common.require_cuda("bench.headline")
    if args.quick:
        out = run(device, rounds=24, batched_rounds=12, streams=(16,), quick=True)
    else:
        out = run(device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
