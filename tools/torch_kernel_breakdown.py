#!/usr/bin/env python3
"""Where the device time of the port's stem and nullspace kernels goes, by
timing copies of their sources with one part taken out.

    python3 tools/torch_kernel_breakdown.py

Each copy of `maveric_slam_tpu_torch/csrc/{stem,nullspace}.cu` is edited by
an exact text substitution (the script fails if a pattern is missing),
built with the port's nvcc flags into `build/kernel_breakdown/`, loaded
with ctypes and timed under torch.profiler on seeded inputs (the copies'
outputs are timing only, except where stated):

- stem at (1, 192, 640) and (16, 192, 640): the kernel; without conv1a
  (its work items write zeros); with one k-step of conv1b's 18; both;
- nullspace at B = 256 and 4096 (n = 9): the substitution block kBlock =
  1, 3 and 5 (checked bitwise equal to each other); 0, 1 and 10 rounds; and
  a copy kernel of the same launch shape as the floor.

Prints one line a variant, then the card's name and power limit. Needs a
card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from maveric_slam_tpu_torch.ops.kernels import _build  # noqa: E402

OUT = os.path.join(ROOT, "build", "kernel_breakdown")
P, I = ctypes.c_void_p, ctypes.c_int

CONV1A = "      if (r >= 0 && r < H && c >= 0 && c < W) {\n        const int8_t* xp"
NO_CONV1A = "      if (r < -(1 << 30)) {\n        const int8_t* xp"
KSTEPS = "    for (int ks = 0; ks < kKSteps; ++ks) {"
ONE_KSTEP = "    for (int ks = 0; ks < 1; ++ks) {"
KBLOCK = "constexpr int kBlock = 3;"
FLOOR = """#include <cuda_runtime.h>
__global__ void nullspace_kernel_floor(const float* a, float* x, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = a[i];
}
extern "C" int nullspace_inverse_iteration(const void* a, void* x, int batch, int n, int it,
                                           void* s) {
  nullspace_kernel_floor<<<(batch * n + 127) / 128, 128, 0, (cudaStream_t)s>>>(
      (const float*)a, (float*)x, batch * n);
  return (int)cudaGetLastError();
}
"""


def _edit(src, *pairs):
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"pattern not in the kernel source: {old!r}")
        src = src.replace(old, new)
    return src


def _build_all(variants):
    """{name: source} -> {name: ctypes library}, nvcc processes in parallel."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", cu, "-o", so]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(so)
    return libs


def _device_ms(fn, name, iters):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages() if name in ev.key)
    return total / iters / 1e3


def stem_breakdown():
    src = open(os.path.join(_build.CSRC, "stem.cu")).read()
    libs = _build_all({
        "stem_full": src,
        "stem_no_conv1a": _edit(src, (CONV1A, NO_CONV1A)),
        "stem_one_kstep": _edit(src, (KSTEPS, ONE_KSTEP)),
        "stem_neither": _edit(src, (CONV1A, NO_CONV1A), (KSTEPS, ONE_KSTEP)),
    })
    g = torch.Generator().manual_seed(0)
    w1a = torch.randint(-128, 128, (9, 64), generator=g, dtype=torch.int32).cuda()
    w1b = torch.randint(-128, 128, (18, 4, 32, 16), generator=g, dtype=torch.int8).cuda()
    s_in, m1, m2 = (torch.tensor(v, dtype=torch.float32).cuda() for v in (1 / 127, 2e-3, 5e-4))
    b1, b2 = torch.zeros(64).cuda(), torch.zeros(64).cuda()
    for s in (1, 16):
        img = torch.rand(s, 192, 640, generator=g).cuda()
        out = torch.empty(s, 96, 320, 64, dtype=torch.int8, device="cuda")
        for name, lib in libs.items():
            f = lib.fused_stem
            f.argtypes = [P] * 9 + [I, I, I, P]

            def run(f=f):
                err = f(img.data_ptr(), w1a.data_ptr(), w1b.data_ptr(), s_in.data_ptr(), b1.data_ptr(),
                        m1.data_ptr(), b2.data_ptr(), m2.data_ptr(), out.data_ptr(), s, 192, 640,
                        torch.cuda.current_stream().cuda_stream)
                _build.check(err, name)

            print(f"[stem] S={s} {name}: device {_device_ms(run, 'stem_kernel', 50):.5f} ms", flush=True)


def nullspace_breakdown():
    src = open(os.path.join(_build.CSRC, "nullspace.cu")).read()
    blocks = (1, 3, 5)
    libs = _build_all({**{f"nullspace_block{b}": _edit(src, (KBLOCK, f"constexpr int kBlock = {b};"))
                          for b in blocks}, "nullspace_floor": FLOOR})
    rng = np.random.default_rng(0)
    for batch in (256, 4096):
        a = rng.normal(size=(batch, 9, 9)).astype(np.float32)
        A = torch.from_numpy(a @ a.transpose(0, 2, 1)).cuda()
        outs = {}
        for name, lib in libs.items():
            f = lib.nullspace_inverse_iteration
            f.argtypes = [P, P, I, I, I, P]
            for it in ((0, 1, 10) if name != "nullspace_floor" else (10,)):
                x = torch.empty(batch, 9, device="cuda")

                def run(f=f, it=it, x=x):
                    _build.check(f(A.data_ptr(), x.data_ptr(), batch, 9, it,
                                   torch.cuda.current_stream().cuda_stream), name)

                ms = _device_ms(run, "nullspace_kernel", 100)
                if it == 10:
                    outs[name] = x.clone()
                print(f"[nullspace] B={batch} {name} rounds={it}: device {ms:.5f} ms", flush=True)
        same = all(torch.equal(outs[f"nullspace_block{b}"], outs["nullspace_block1"]) for b in blocks)
        print(f"[nullspace] B={batch}: kBlock {blocks} bitwise equal: {same}", flush=True)
        if not same:
            raise RuntimeError("the substitution blocks disagree")


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_breakdown: no CUDA device (torch.cuda.is_available() is False)")
    stem_breakdown()
    nullspace_breakdown()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
