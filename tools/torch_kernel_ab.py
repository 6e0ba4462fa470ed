#!/usr/bin/env python3
"""Time the port's stem and nullspace kernels of two checkouts on one card,
in turns (other, this, this, other), so that a redesign is compared with
the kernel it replaced within one run.

    python3 tools/torch_kernel_ab.py OTHER_CHECKOUT   # e.g. a `git archive` of the parent

Each turn is a subprocess run from the checkout's root, which builds that
checkout's kernels and times its wrappers `fused_stem` (S = 1 and 16 at
192x640, orbit frames) and `nullspace_inverse_iteration` (n = 9 at the
single step's B = 256, 64, 3 and the batched step's 4096, 1024, 48, seeded
PSD matrices): "call" is CUDA events over back-to-back wrapper calls,
"device" the kernel's own time from torch.profiler. Prints one line per
kernel and shape with both checkouts' minima, then the card's name and
power limit. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

H, W, FOCAL = 192, 640, 800.0
NULLSPACE_B = (256, 64, 3, 4096, 1024, 48)


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


def measure():
    """One turn, in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from maveric_slam_tpu_torch.data import synthetic
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops.kernels import nullspace, stem

    cuda = torch.device("cuda")
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]], np.float32)
    poses = synthetic.orbit_poses(192)
    frames = np.stack([synthetic.render_box_room(K, poses[12 * s], H, W) for s in range(16)])
    args = sp.stem_args(sp.load_params(device=cuda))
    rows = []
    for s, iters in ((1, 200), (16, 20)):
        img = torch.from_numpy(frames[:s]).to(cuda)
        fn = lambda img=img: stem.fused_stem(img, *args)  # noqa: E731
        rows.append({"kernel": "fused_stem", "shape": f"({s}, {H}, {W})",
                     "call_ms": _event_ms(torch, fn, iters),
                     "device_ms": _device_ms(torch, fn, "stem_kernel", iters)})
    rng = np.random.default_rng(0)
    for b in NULLSPACE_B:
        a = rng.normal(size=(b, 9, 9)).astype(np.float32)
        A = torch.from_numpy(a @ a.transpose(0, 2, 1)).to(cuda)
        fn = lambda A=A: nullspace.nullspace_inverse_iteration(A)  # noqa: E731
        rows.append({"kernel": "nullspace_inverse_iteration", "shape": f"({b}, 9, 9)",
                     "call_ms": _event_ms(torch, fn, 500),
                     "device_ms": _device_ms(torch, fn, "nullspace_kernel", 100)})
    print(json.dumps(rows))


def main():
    if len(sys.argv) == 2 and sys.argv[1] == "--measure":
        measure()
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: no CUDA device (torch.cuda.is_available() is False)")
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure"],
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
