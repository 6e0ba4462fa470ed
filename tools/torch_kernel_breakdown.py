#!/usr/bin/env python3
"""Where the device time of the port's stem, detector, nullspace, svd3 and
match kernels goes, by timing copies of their sources with one part taken
out.

    python3 tools/torch_kernel_breakdown.py [--csrc DIR] [stem] [detector] [nullspace] [svd3] [match]

With no section named, all five run. `--csrc DIR` reads the kernel sources
from DIR (for example the `csrc/` of a `git archive` of another commit)
instead of this checkout's `maveric_slam_tpu_torch/csrc`. Each copy of a
source is edited by an exact text substitution (the script fails if a
pattern is missing),
built with the port's nvcc flags into `build/kernel_breakdown/`, loaded
with ctypes and timed under torch.profiler on seeded inputs (the copies'
outputs are timing only, except where stated):

- stem at (1, 192, 640) and (16, 192, 640): the kernel; without conv1a
  (its work items write zeros); with one k-step of conv1b's 18; both;
- detector at C = 1920 and S = 16 x 1920 (seeded int8 logits): the
  kernel at Taylor degree 5 and 1 (no Taylor terms); a copy kernel of the
  same launch shape (16 cells, 128 threads a block: each lane reads its
  cell's bytes, one lane writes 16 bytes) as the floor; every tile staged
  by bytes in place of 16-byte cp.async; the tile
  as one bulk copy (cp.async.bulk completed on an mbarrier); 1, 2, 4 and
  8 lanes a cell forced at both sizes (the kernel picks 8 or 1 from the
  number of cells). Each variant is checked bitwise equal to the kernel
  (the sums' order does not depend on the lanes). Variants whose pattern
  a `--csrc` source lacks are left out;
- nullspace at B = 256 and 4096 (n = 9): the substitution block kBlock =
  1, 3 and 5 (checked bitwise equal to each other); 0, 1 and 10 rounds; and
  a copy kernel of the same launch shape as the floor;
- svd3 at B = 256 and 4096: a copy kernel of the same launch shape (9
  floats in, 21 out a matrix) as the floor; 0, 1 and 6 sweeps; 6 sweeps
  without the U rebuild (U and s taken from B's columns as they are); where
  the source has the rcp.approx `recip` helper, its reciprocal as the
  correctly rounded __frcp_rn (0, 1 and 6 sweeps, with the largest change
  in s);
- match at N = 100 and S = 16 x 100 (seeded descriptors, a window of
  radius 4 around each query, every cell usable): kQueries = 1, 2 and 4
  queries a block, checked bitwise equal to each other; and as the floor a
  kernel of the one-query launch shape that reads each query's cell and
  writes its two outputs.

Prints one line a variant, then the card's name and power limit. Needs a
card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from maveric_slam_tpu_torch.ops.kernels import _build  # noqa: E402

OUT = os.path.join(ROOT, "build", "kernel_breakdown")
CSRC = str(_build.CSRC)  # the sources to take apart (--csrc)
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


SVD3_FLOOR = """#include <cuda_runtime.h>
__global__ void svd3_kernel_floor(const float* __restrict__ a, float* __restrict__ u,
                                  float* __restrict__ s, float* __restrict__ v, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = a[b * 9 + i];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    u[b * 9 + i] = m[i];
    v[b * 9 + i] = m[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) s[b * 3 + i] = m[4 * i];
}
extern "C" int svd3(const void* A, void* U, void* s, void* V, int batch, int sweeps, void* st) {
  svd3_kernel_floor<<<(batch + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)st>>>(
      (const float*)A, (float*)U, (float*)s, (float*)V, batch);
  return (int)cudaGetLastError();
}
"""
# svd3's angle reciprocal (MUFU.RCP, ~1 ulp), and the correctly rounded
# one tried in its place.
RECIP = """  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;"""
RECIP_RN = "  return __frcp_rn(x);"
# The U rebuild of svd3.cu, from its first line to the stores, and what
# takes its place: U's columns and s straight from B. One pair for each
# layout of the source (the previous kernel's Mat struct; the plain arrays now).
SVD3_NO_U = (
    ("  const float s0 = sqrtf(norm2_col(B, 0));", "  float* U = U_out + (size_t)b * 9;",
     "  const float s0 = B.m[0][0], s1 = B.m[1][1], s2 = B.m[2][2];\n"
     "  const float u0[3] = {B.m[0][0], B.m[1][0], B.m[2][0]};\n"
     "  const float u1[3] = {B.m[0][1], B.m[1][1], B.m[2][1]};\n"
     "  const float u2[3] = {B.m[0][2], B.m[1][2], B.m[2][2]};\n"),
    ("  // The U rebuild.", "  // The stores.",
     "  const float s0 = B[0][0], s1 = B[1][1], s2 = B[2][2];\n"
     "  const float u0[3] = {B[0][0], B[1][0], B[2][0]};\n"
     "  const float u1[3] = {B[0][1], B[1][1], B[2][1]};\n"
     "  const float u2[3] = {B[0][2], B[1][2], B[2][2]};\n"),
)
DET_LANES = "const int lanes = num_cells >= sms * kThreads ? 1 : 8;"
DET_LAUNCH1 = "return launch<1>("
DET_STAGING = "  const bool vector = n == kCells"
DET_TABLE = "  __shared__ float table[128];  // e(x) for x = 0..127\n"
DET_VECTOR_COPY = ("    for (int i = t; i < kChunks; i += kThreads) cp_async16(smem_addr(tile + 16 * i), "
                   "src + 16 * i);\n")
DET_VECTOR_WAIT = "  if (vector) cp_async_wait_all();\n  __syncthreads();\n"
# The tile as one bulk copy: thread 0 sets up an mbarrier for the tile's
# bytes and starts the copy; after the block barrier (which publishes the
# mbarrier) every thread waits for its phase 0 to complete.
DET_BULK = (
    (DET_TABLE, DET_TABLE + "  __shared__ __align__(8) uint64_t bar;\n"),
    (DET_VECTOR_COPY, r"""    if (t == 0) {
      const uint32_t b = smem_addr(&bar);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(kTileBytes)
                   : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                   ::"r"(smem_addr(tile)), "l"(src), "r"(kTileBytes), "r"(b) : "memory");
    }
"""),
    (DET_VECTOR_WAIT, r"""  __syncthreads();
  if (vector) {
    uint32_t done = 0;
    while (!done)
      asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_addr(&bar)) : "memory");
  }
"""),
)
DET_FLOOR = """#include <cuda_runtime.h>
#include <stdint.h>
__global__ void detector_kernel_floor(const int8_t* __restrict__ semi, float* __restrict__ probs,
                                      int* __restrict__ idx, float* __restrict__ xy, int n) {
  const int c = blockIdx.x * 16 + threadIdx.x / 8, lane = threadIdx.x % 8;
  int v = 0;
  if (c < n)
    for (int k = lane; k < 65; k += 8) v += semi[(size_t)c * 65 + k];
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (c < n && lane == 0) {
    probs[c] = (float)v;
    idx[c] = v;
    xy[2 * c] = 0.0f;
    xy[2 * c + 1] = (float)v;
  }
}
extern "C" int detector_postproc(const void* semi, const void*, void* probs, void* idx, void* xy, int n,
                                 int, int, int, void* st) {
  detector_kernel_floor<<<(n + 15) / 16, 128, 0, (cudaStream_t)st>>>(
      (const int8_t*)semi, (float*)probs, (int*)idx, (float*)xy, n);
  return (int)cudaGetLastError();
}
"""
KQUERIES = "constexpr int kQueries = 1;"
MATCH_FLOOR = """#include <cuda_runtime.h>
__global__ void match_kernel_floor(const int* __restrict__ cells1, float* __restrict__ score,
                                   int* __restrict__ best, int n) {
  const size_t q = (size_t)blockIdx.y * n + blockIdx.x;
  if (threadIdx.x == 0) {
    const int c = cells1[q];
    score[q] = 0.0f;
    best[q] = c;
  }
}
extern "C" int windowed_match(const void*, const void*, const void*, const void*, const void* cells1,
                              void* score, void* best, int n, int s, int, int, int, int, int, float,
                              int, void* st) {
  match_kernel_floor<<<dim3(n, s), 128, 0, (cudaStream_t)st>>>((const int*)cells1, (float*)score,
                                                              (int*)best, n);
  return (int)cudaGetLastError();
}
"""


def _cut(src, alternatives):
    """Replace the text from `start` up to `end` (kept) by `new`, for the
    first (start, end, new) whose markers the source holds."""
    for start, end, new in alternatives:
        i = src.find(start)
        j = src.find(end, i + 1) if i >= 0 else -1
        if i >= 0 and j >= 0:
            return src[:i] + new + src[j:]
    raise RuntimeError("no known U-rebuild markers in the svd3 source")


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
    if total <= 0:
        raise RuntimeError(f"torch.profiler recorded no device time for {name}")
    return total / iters / 1e3


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def stem_breakdown():
    src = _source("stem.cu")
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


def detector_breakdown():
    src = _source("detector.cu")
    variants = {"detector_kernel": src, "detector_floor": DET_FLOOR}
    if DET_STAGING in src:
        variants["detector_bytes"] = _edit(src, (DET_STAGING, "  const bool vector = false && n == kCells"))
    if all(old in src for old, _ in DET_BULK):
        variants["detector_bulk"] = _edit(src, *DET_BULK)
    if DET_LANES in src:
        for lanes in (1, 2, 4, 8):  # forced, whatever the number of cells
            variants[f"detector_lanes{lanes}"] = _edit(
                src, (DET_LANES, "const int lanes = 1;"), (DET_LAUNCH1, f"return launch<{lanes}>("))
    libs = _build_all(variants)
    g = torch.Generator().manual_seed(0)
    scale = torch.tensor(0.3562, device="cuda")
    for streams in (1, 16):
        semi = torch.randint(-128, 128, (streams * 1920, 65), generator=g, dtype=torch.int8).cuda()
        n = semi.shape[0]
        outs = {}
        for name, lib in libs.items():
            f = lib.detector_postproc
            f.argtypes = [P] * 5 + [I] * 4 + [P]
            for degree in ((5, 1) if name == "detector_kernel" else (5,)):
                probs = torch.empty(n, device="cuda")
                idx = torch.empty(n, dtype=torch.int32, device="cuda")
                xy = torch.empty(n, 2, device="cuda")

                def run(f=f, degree=degree, probs=probs, idx=idx, xy=xy):
                    _build.check(f(semi.data_ptr(), scale.data_ptr(), probs.data_ptr(), idx.data_ptr(),
                                   xy.data_ptr(), n, 1920, 80, degree,
                                   torch.cuda.current_stream().cuda_stream), name)

                ms = _device_ms(run, "detector_kernel", 100)
                if degree == 5 and name != "detector_floor":
                    outs[name] = (probs, idx, xy)
                print(f"[detector] S={streams} C=1920 {name} degree={degree}: device {ms:.5f} ms", flush=True)
        ref = outs["detector_kernel"]
        for name, out in outs.items():
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            dp = float(((out[0] - ref[0]).abs() / ref[0].abs().clamp(min=1e-30)).max())
            print(f"[detector] S={streams}: {name} bitwise equal to the kernel: {same}, argmax equal: "
                  f"{torch.equal(out[1], ref[1])}, max relative |dprob| {dp:.3g}", flush=True)
            if not same and (name in ("detector_bytes", "detector_bulk") or DET_LANES in src):
                raise RuntimeError(f"detector variant {name} disagrees with the kernel")


def nullspace_breakdown():
    src = _source("nullspace.cu")
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


def svd3_breakdown():
    src = _source("svd3.cu")
    threads = re.search(r"(?:const int threads|constexpr int kThreads) = (\d+);", src)
    if threads is None:
        raise RuntimeError("svd3.cu: block size not found")
    variants = {"svd3_kernel": src, "svd3_no_u_rebuild": _cut(src, SVD3_NO_U),
                "svd3_floor": SVD3_FLOOR.replace("THREADS", threads.group(1))}
    if RECIP in src:
        variants["svd3_rcp_rn"] = _edit(src, (RECIP, RECIP_RN))
    libs = _build_all(variants)
    print(f"[svd3] {CSRC}: {threads.group(1)} threads a block", flush=True)
    rng = np.random.default_rng(0)
    for batch in (256, 4096):
        A = torch.from_numpy(rng.normal(size=(batch, 3, 3)).astype(np.float32)).cuda()
        U, s, V = (torch.empty(batch, *shape, device="cuda") for shape in ((3, 3), (3,), (3, 3)))
        runs = [("svd3_floor", 6), ("svd3_kernel", 0), ("svd3_kernel", 1), ("svd3_kernel", 6),
                ("svd3_no_u_rebuild", 6)] + [("svd3_rcp_rn", k) for k in (0, 1, 6) if "svd3_rcp_rn" in libs]
        outs = {}
        for name, sweeps in runs:
            f = libs[name].svd3
            f.argtypes = [P, P, P, P, I, I, P]

            def run(f=f, sweeps=sweeps):
                _build.check(f(A.data_ptr(), U.data_ptr(), s.data_ptr(), V.data_ptr(), batch, sweeps,
                               torch.cuda.current_stream().cuda_stream), name)

            ms = _device_ms(run, "svd3_kernel", 100)
            if sweeps == 6 and name in ("svd3_kernel", "svd3_rcp_rn"):
                outs[name] = s.clone()
            print(f"[svd3] B={batch} {name} sweeps={sweeps}: device {ms:.5f} ms", flush=True)
        if "svd3_rcp_rn" in outs:
            d = float((outs["svd3_rcp_rn"] - outs["svd3_kernel"]).abs().max())
            print(f"[svd3] B={batch}: rcp.approx against __frcp_rn, max |ds| {d:.3g}", flush=True)


def match_breakdown():
    src = _source("match.cu")
    per_block = (1, 2, 4)
    libs = _build_all({**{f"match_q{k}": _edit(src, (KQUERIES, f"constexpr int kQueries = {k};"))
                          for k in per_block}, "match_floor": MATCH_FLOOR})
    g = torch.Generator().manual_seed(0)
    grid_h, grid_w, n = 24, 80, 100
    for streams in (1, 16):
        c = grid_h * grid_w
        d0 = torch.randint(-128, 128, (streams, c, 256), generator=g, dtype=torch.int8).cuda()
        q = torch.randint(-128, 128, (streams, n, 256), generator=g, dtype=torch.int8).cuda()
        probs = torch.ones(streams, c).cuda()
        idx = torch.zeros(streams, c, dtype=torch.int32).cuda()
        cells = torch.randint(0, c, (streams, n), generator=g, dtype=torch.int32).cuda()
        outs = {}
        for name, lib in libs.items():
            f = lib.windowed_match
            f.argtypes = [P] * 7 + [I] * 7 + [ctypes.c_float, I, P]
            score = torch.empty(streams, n, device="cuda")
            best = torch.empty(streams, n, dtype=torch.int32, device="cuda")

            def run(f=f, score=score, best=best):
                _build.check(f(q.data_ptr(), d0.data_ptr(), probs.data_ptr(), idx.data_ptr(),
                               cells.data_ptr(), score.data_ptr(), best.data_ptr(), n, streams,
                               grid_h, grid_w, 0, 0, 4, 0.1, 1,
                               torch.cuda.current_stream().cuda_stream), name)

            ms = _device_ms(run, "match_kernel", 100)
            if name != "match_floor":
                outs[name] = (score.clone(), best.clone())
            print(f"[match] S={streams} N={n} {name}: device {ms:.5f} ms", flush=True)
        ref = outs["match_q1"]
        same = all(torch.equal(a, b) for o in outs.values() for a, b in zip(o, ref))
        print(f"[match] S={streams}: kQueries {per_block} bitwise equal: {same}", flush=True)
        if not same:
            raise RuntimeError("the match variants disagree")


SECTIONS = {"stem": stem_breakdown, "detector": detector_breakdown, "nullspace": nullspace_breakdown,
            "svd3": svd3_breakdown, "match": match_breakdown}


def main():
    global CSRC
    args = sys.argv[1:]
    if args[:1] == ["--csrc"] and len(args) >= 2:
        CSRC = os.path.abspath(args[1])
        args = args[2:]
    if any(a not in SECTIONS for a in args):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_breakdown: no CUDA device (torch.cuda.is_available() is False)")
    for name in args or SECTIONS:
        SECTIONS[name]()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
