// Fused detector post-processing: approximate softmax, first-max argmax and
// sub-pixel soft-argmax for every cell of a SuperPoint semi grid.
//
// Replaces: maveric_slam_tpu/ops/pallas_kernels.py fused_detector_postproc
// (:92-125, kernel _detector_kernel :38-89).
//
// Per cell c of S x C (S streams, each C cells row-major over its Hc x Wc
// grid; rows are counted within each stream), from 65 int8 logits:
//   e_k   = 1 + sum_{i<degree} p_i x^i   (Taylor exp, p_i = p_{i-1}*scale/i,
//           the operation order of top_N.c:61-65), 0 where x < 0;
//   denom = sum_k e_k + FLT_MIN;  first max over channels 0..63;
//   idx   = argmax, or 64 (dustbin) when the max is 0;  prob = max/denom or -1;
//   xy    = (col*8 + ex, row*8 + ey), the soft-argmax over the winner's 3x3
//           channel neighbourhood of the 8x8 sub-cell layout.
//
// Exactness: the approximate exps of neighbouring channels are often equal,
// so the argmax depends on every rounding. A channel's exp depends on its
// int8 logit alone, and is 0 for a negative one: each block forms the 128
// exps of logits 0..127 once, one a thread, with __fmul_rn/__fadd_rn (never
// contracted into an FMA, also enforced by -fmad=false) and __fdiv_rn in the
// JAX reference's order, and looks every channel up in that table: the same
// value, bit for bit, that the reference forms for the channel. The maximum
// is the first one: ties go to the lower channel. The sums are taken in
// another order than the reference's, which the contract allows (probs rtol
// 1e-6, xy atol 1e-3), and it is one fixed order whatever the launch: a
// row's 8 exps left to right (the dustbin added to row 0's sum), the 8 row
// sums as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), and the 3x3 window
// row-major. So a stream alone gives its row of a batched call bit for bit.
//
// Bound on this card: bytes. The main path's 24x80 grid is 1920 x 65 int8
// read and 16 bytes a cell written, ~156 KB, ~0.05 us at 3.35 TB/s (2.5 MB,
// 0.74 us, at S = 16). At C = 1920 the work is far under a launch, so the
// time is latency: the previous kernel, one thread a cell, ran 15 blocks
// on 132 SMs, read each cell's 65 bytes one at a time at a 65-byte stride
// from its neighbour's, and made each thread a chain of 65 polynomials, a
// 65-long sum and two scans. At S = 16 (30720 cells) the issue rate counts
// as well: 65 polynomials a cell were most of the instructions. Design:
//   - a block of 128 threads owns a tile of cells whose bytes are whole
//     16-byte chunks (16 x 65 = 1040 bytes = 65 chunks); it stages them in
//     shared memory in one round trip of 16-byte cp.async copies (a ragged
//     last tile, or a base pointer that is not 16-byte aligned, takes a
//     byte copy inside the same kernel) and forms the exp table while they
//     fly, so the Taylor degree (any >= 1) costs one polynomial a thread;
//   - L lanes a cell, each lane 8/L consecutive rows of the 8x8 layout
//     (lane 0 also the dustbin). The launch takes L = 8 (16 cells a block:
//     120 blocks at C = 1920, latency) unless the cells fill every SM with
//     L = 1 blocks (128 cells a block), as S = 16 does (issue rate);
//   - the row sums go through the fixed tree, within a lane and then by
//     __shfl_xor_sync across lanes; the maximum by a shuffle tree, and the
//     first channel holding it is the lowest lane's (lanes own increasing
//     channels) by one ballot;
//   - lane 0 sums the winner's 3x3 window from the tile and the table and
//     writes the cell's 16 bytes.
// Tensor cores, wgmma and TMA tiles do not apply: there is no matrix
// product. tools/torch_kernel_breakdown.py times this source against a copy
// kernel of the same launch shape, degree 1, byte staging, a bulk copy
// (cp.async.bulk on an mbarrier) and 1, 2, 4 or 8 lanes a cell at either
// size; PERF.md has the numbers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 65;
constexpr int kDustbin = 64;
constexpr int kThreads = 128;
constexpr float kFltMin = 1.175494e-38f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// L lanes a cell, each taking rows kRows * lane .. of the 8x8 layout.
template <int L>
__global__ void __launch_bounds__(kThreads)
detector_kernel(const int8_t* __restrict__ semi, const float* __restrict__ scale_ptr,
                float* __restrict__ probs, int* __restrict__ idx_out, float* __restrict__ xy,
                int num_cells, int cells_per_stream, int grid_w, int degree) {
  constexpr int kRows = 8 / L;                 // rows a lane
  constexpr int kPer = 8 * kRows;              // point channels a lane
  constexpr int kCells = kThreads / L;         // cells a block: one tile
  constexpr int kTileBytes = kCells * kChannels;
  constexpr int kChunks = kTileBytes / 16;     // 16-byte copies a tile
  static_assert(8 % L == 0 && kTileBytes % 16 == 0, "whole rows a lane, whole chunks a tile");
  static_assert(kThreads == 128, "one thread an entry of the exp table");
  __shared__ __align__(16) int8_t tile[kTileBytes];
  __shared__ float table[128];  // e(x) for x = 0..127
  const int t = threadIdx.x;
  const int first = blockIdx.x * kCells;
  const int n = min(num_cells - first, kCells);  // cells of this tile
  const int8_t* src = semi + (size_t)first * kChannels;
  const float scale = *scale_ptr;
  // A tile starts kTileBytes * blockIdx.x bytes in, so it is 16-byte
  // aligned exactly when the base pointer is.
  const bool vector = n == kCells && (reinterpret_cast<uintptr_t>(semi) & 15) == 0;
  if (vector) {
    for (int i = t; i < kChunks; i += kThreads) cp_async16(smem_addr(tile + 16 * i), src + 16 * i);
  } else {
    for (int i = t; i < n * kChannels; i += kThreads) tile[i] = src[i];
  }
  // While the tile is in flight: thread t forms e(t), the exp of logit t,
  // exactly as the reference forms a channel's (x < 0 gives 0: no entry).
  {
    const float x = (float)t;
    float acc = 1.0f, xp = x, p = 1.0f;
    for (int i = 1; i < degree; ++i) {
      p = __fdiv_rn(__fmul_rn(p, scale), (float)i);
      acc = __fadd_rn(acc, __fmul_rn(p, xp));
      xp = __fmul_rn(xp, x);
    }
    table[t] = acc;
  }
  if (vector) cp_async_wait_all();
  __syncthreads();

  // Lanes of a cell beyond n compute on stale bytes and write nothing; they
  // stay to the end, as the shuffles need every lane of the warp.
  const int lane = t % L, local = t / L;
  const int8_t* cell_bytes = tile + local * kChannels;
  auto exp_of = [&](int k) {
    const int v = cell_bytes[k];
    return v >= 0 ? table[v] : 0.0f;
  };

  // Row sums (left to right) and this lane's first maximum.
  float rows[kRows];
  float best = -1.0f;
  int arg = 0;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane * kPer + 8 * q + j;
      const float e = exp_of(k);
      rows[q] = j == 0 ? e : __fadd_rn(rows[q], e);
      if (e > best) {
        best = e;
        arg = k;
      }
    }
  }
  if (lane == 0) rows[0] = __fadd_rn(rows[0], exp_of(kDustbin));

  // The denominator: the fixed tree over the 8 rows, first within the lane,
  // then across lanes (both lanes of a pair form the same sum).
#pragma unroll
  for (int o = 1; o < kRows; o <<= 1) {
#pragma unroll
    for (int q = 0; q < kRows; q += 2 * o) rows[q] = __fadd_rn(rows[q], rows[q + o]);
  }
  float den = rows[0];
  float top = best;
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
    den = __fadd_rn(den, __shfl_xor_sync(0xffffffffu, den, o));
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, o));
  }
  if (L > 1) {
    // The cell's first maximum is that of the lowest lane holding it.
    const int base = (t % 32) - lane;
    const unsigned held = (__ballot_sync(0xffffffffu, best == top) >> base) & ((1u << L) - 1);
    arg = __shfl_sync(0xffffffffu, arg, base + __ffs(held) - 1);
  }

  if (lane == 0 && local < n) {
    den = __fadd_rn(den, kFltMin);
    const bool has = top > 0.0f;
    const int idx = has ? arg : kDustbin;
    const int wx = idx % 8, wy = idx / 8;
    float den3 = 0.0f, sx = 0.0f, sy = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int iy = wy + dy, ix = wx + dx;
        if (iy >= 0 && iy < 8 && ix >= 0 && ix < 8) {
          const float v = exp_of(8 * iy + ix);
          den3 = __fadd_rn(den3, v);
          sx = __fadd_rn(sx, __fmul_rn(v, (float)ix));
          sy = __fadd_rn(sy, __fmul_rn(v, (float)iy));
        }
      }
    }
    const int c = first + local;
    probs[c] = has ? __fdiv_rn(top, den) : -1.0f;
    idx_out[c] = idx;
    den3 = fmaxf(den3, 1e-20f);
    const int cell = c % cells_per_stream;
    const float col = (float)(cell % grid_w), row = (float)(cell / grid_w);
    reinterpret_cast<float2*>(xy)[c] = make_float2(
        __fadd_rn(__fmul_rn(col, 8.0f), __fdiv_rn(sx, den3)),
        __fadd_rn(__fmul_rn(row, 8.0f), __fdiv_rn(sy, den3)));
  }
}

template <int L>
int launch(const void* semi, const void* scale, void* probs, void* idx, void* xy, int num_cells,
           int cells_per_stream, int grid_w, int degree, cudaStream_t stream) {
  constexpr int kCells = kThreads / L;
  detector_kernel<L><<<(num_cells + kCells - 1) / kCells, kThreads, 0, stream>>>(
      (const int8_t*)semi, (const float*)scale, (float*)probs, (int*)idx, (float*)xy,
      num_cells, cells_per_stream, grid_w, degree);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int detector_postproc(const void* semi, const void* scale, void* probs,
                                 void* idx, void* xy, int num_cells,
                                 int cells_per_stream, int grid_w, int degree,
                                 void* stream) {
  if (num_cells <= 0) return (int)cudaSuccess;
  if (degree < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // 1 lane a cell once its blocks (128 cells each) fill every SM.
  const int lanes = num_cells >= sms * kThreads ? 1 : 8;
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 1)
    return launch<1>(semi, scale, probs, idx, xy, num_cells, cells_per_stream, grid_w, degree, s);
  return launch<8>(semi, scale, probs, idx, xy, num_cells, cells_per_stream, grid_w, degree, s);
}
