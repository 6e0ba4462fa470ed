#!/usr/bin/env python3
"""Time the port's kernels of two checkouts on one card, in turns (other,
this, this, other), so that a redesign is compared with the kernel it
replaced within one run.

    python3 tools/torch_kernel_ab.py OTHER_CHECKOUT [KERNEL ...]   # e.g. a `git archive` of the parent

Each turn is a subprocess run from the checkout's root, which builds that
checkout's kernels and times its wrappers (all of them, or the KERNELs
named): `fused_stem` (S = 1 and 16 at 192x640, orbit frames),
`detector_postproc` (C = 1920 and S = 16 x 1920 cells: the int8 logits of
orbit frames 12s + 1, s < 16, from the port's SuperPoint),
`nullspace_inverse_iteration` (n = 9 at the single step's B = 256, 64, 3
and the batched step's 4096, 1024, 48, seeded PSD matrices), `svd3` (the
single step's B = 256, 64, 1 and the batched step's 4096, 1024, 16, seeded
normal matrices) and `windowed_match` (the single step's N = 100 queries
against 1920 cells and the batched step's 16 x 100, from orbit frames 12s
and 12s + 1 through the detector and top-N): "call" is CUDA events over
back-to-back wrapper calls, "device" the kernel's own time from
torch.profiler. Prints one line per kernel and shape with both checkouts'
minima, then the card's name and power limit. Needs a card; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

H, W, FOCAL = 192, 640, 800.0
NULLSPACE_B = (256, 64, 3, 4096, 1024, 48)
SVD3_B = (256, 64, 1, 4096, 1024, 16)
KERNELS = ("fused_stem", "detector_postproc", "nullspace_inverse_iteration", "svd3", "windowed_match")


def _event_ms(torch, fn, iters):
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


def _device_ms(torch, fn, name, iters):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages() if name in ev.key)
    return total / iters / 1e3 if total > 0 else None


def _match_inputs(torch, sp, params, frames, cuda):
    """The S = 16 matcher inputs of orbit frames (12s, 12s + 1), s < 16, as
    the tracking step forms them: queries at the second frames' top-100
    cells against the first frames' 1920 cells."""
    from maveric_slam_tpu_torch.config import DEFAULT_CONFIG
    from maveric_slam_tpu_torch.ops import softmax_topn as st
    from maveric_slam_tpu_torch.ops.kernels import detector

    fc = DEFAULT_CONFIG.frontend
    s = frames.shape[0] // 2
    semi, desc, scales = sp.superpoint_int8(params, torch.from_numpy(frames).to(cuda))
    semi, desc = semi.reshape(2, s, -1, 65), desc.reshape(2, s, -1, 256)
    p0, i0, _ = detector.detector_postproc_plain(semi[0], scales["semi_scale"])
    p1, i1, _ = detector.detector_postproc_plain(semi[1], scales["semi_scale"])
    top = st.top_n_select(st.SoftmaxGrid(p1.reshape(s, 24, 80), i1.reshape(s, 24, 80)), n=fc.top_n,
                          valid_thresh=fc.valid_prob_thresh, mode=fc.top_n_mode)
    q = torch.take_along_dim(desc[1], top.cells.long()[..., None], dim=1)
    return q, desc[0].contiguous(), p0, i0, top.cells


def measure(kernels):
    """One turn, in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from maveric_slam_tpu_torch.config import DEFAULT_CONFIG
    from maveric_slam_tpu_torch.data import synthetic
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops.kernels import detector, match, nullspace, stem, svd3

    cuda = torch.device("cuda")
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    poses = synthetic.orbit_poses(192)
    frames = np.stack([synthetic.render_box_room(K, poses[12 * s + j], H, W)
                       for j in (0, 1) for s in range(16)])
    params = sp.load_params(device=cuda)
    rows = []

    def row(kernel, shape, fn, name, iters, dev_iters):
        rows.append({"kernel": kernel, "shape": shape, "call_ms": _event_ms(torch, fn, iters),
                     "device_ms": _device_ms(torch, fn, name, dev_iters)})

    if "fused_stem" in kernels:
        args = sp.stem_args(params)
        for s, iters in ((1, 200), (16, 20)):
            img = torch.from_numpy(frames[:s]).to(cuda)
            row("fused_stem", f"({s}, {H}, {W})", lambda img=img: stem.fused_stem(img, *args),
                "stem_kernel", iters, iters)
    if "detector_postproc" in kernels:
        semi, _, scales = sp.superpoint_int8(params, torch.from_numpy(frames[16:]).to(cuda))
        semi16, scale = semi.reshape(16, -1, 65), scales["semi_scale"]
        for label, x in ((f"C={semi16.shape[1]}", semi16[0]), (f"S=16 C={semi16.shape[1]}", semi16)):
            row("detector_postproc", label, lambda x=x: detector.detector_postproc(x, scale),
                "detector_kernel", 500, 100)
    rng = np.random.default_rng(0)
    if "nullspace_inverse_iteration" in kernels:
        for b in NULLSPACE_B:
            a = rng.normal(size=(b, 9, 9)).astype(np.float32)
            A = torch.from_numpy(a @ a.transpose(0, 2, 1)).to(cuda)
            row("nullspace_inverse_iteration", f"({b}, 9, 9)",
                lambda A=A: nullspace.nullspace_inverse_iteration(A), "nullspace_kernel", 500, 100)
    if "svd3" in kernels:
        for b in SVD3_B:
            A = torch.from_numpy(rng.normal(size=(b, 3, 3)).astype(np.float32)).to(cuda)
            row("svd3", f"({b}, 3, 3)", lambda A=A: svd3.svd3(A), "svd3_kernel", 500, 100)
    if "windowed_match" in kernels:
        m16 = _match_inputs(torch, sp, params, frames, cuda)
        mc = DEFAULT_CONFIG.matcher
        kw = dict(grid_h=24, grid_w=80, shift=mc.window_shift, radius=mc.window_radius,
                  min_prob=mc.min_prob)
        for label, args in (("N=100", [a[0] for a in m16]), ("S=16 N=100", m16)):
            row("windowed_match", label, lambda args=args: match.windowed_match(*args, **kw),
                "match_kernel", 500, 100)
    print(json.dumps(rows))


def main():
    if len(sys.argv) >= 2 and sys.argv[1] == "--measure":
        measure(sys.argv[2:])
        return
    kernels = sys.argv[2:] or list(KERNELS)
    if len(sys.argv) < 2 or any(k not in KERNELS for k in kernels):
        sys.exit(__doc__)
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: no CUDA device (torch.cuda.is_available() is False)")
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", *kernels],
                             cwd=this if side == "this" else other, capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            sys.exit(f"torch_kernel_ab: the {side} turn failed:\n{res.stdout}{res.stderr}")
        runs[side].append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(f"other = {other}, this = {this}; minimum of two turns each (ms)")
    for k, row in enumerate(runs["this"][0]):
        def best(side, key):
            vals = [r[k][key] for r in runs[side] if r[k][key] is not None]
            return min(vals) if vals else None
        print(f"[ab] {row['kernel']} {row['shape']}: device other {best('other', 'device_ms')} "
              f"this {best('this', 'device_ms')}; call other {best('other', 'call_ms')} "
              f"this {best('this', 'call_ms')}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
