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
// Bound on this card: bytes. At the main path's 24x80 grid the kernel
// reads 1920*65 int8 and writes 16 bytes a cell, ~156 KB, which is ~0.05 us
// at 3.35 TB/s; its ~1.8 M flops take less. Both are far under a launch.
// What the kernel does take is latency: 1920 cells are 15 blocks, so the
// time is one thread's chain of ~65 x 3 x (degree - 1) dependent f32
// operations. Design: one thread per cell, its 65 exps in registers, one
// pass; the Taylor coefficients (IEEE divisions, the costliest operations
// here) are formed once per thread, not once per channel.
//
// Exactness: the approximate exps of neighbouring channels are often equal,
// so the argmax depends on every rounding. The Taylor polynomial is written
// with __fmul_rn/__fadd_rn (never contracted into an FMA, also enforced by
// -fmad=false) in the JAX reference's order, and the first maximum is taken
// explicitly with a strict `>` scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 65;
constexpr int kDustbin = 64;
constexpr int kMaxDegree = 8;  // Taylor degrees the kernel takes (the wrapper checks)
constexpr float kFltMin = 1.175494e-38f;

__global__ void detector_kernel(const int8_t* __restrict__ semi,
                                const float* __restrict__ scale_ptr,
                                float* __restrict__ probs,
                                int* __restrict__ idx_out,
                                float* __restrict__ xy,
                                int num_cells, int cells_per_stream, int grid_w,
                                int degree) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_cells) return;
  const float scale = *scale_ptr;
  const int8_t* row = semi + (size_t)c * kChannels;

  // The coefficients p_i = p_{i-1} * scale / i are shared by every channel:
  // formed once, in the reference's order, so each is the same f32 value.
  float coef[kMaxDegree];
  coef[0] = 1.0f;
#pragma unroll
  for (int i = 1; i < kMaxDegree; ++i)
    coef[i] = i < degree ? __fdiv_rn(__fmul_rn(coef[i - 1], scale), (float)i) : 0.0f;

  float e[kChannels];
  float denom = 0.0f;
#pragma unroll
  for (int k = 0; k < kChannels; ++k) {
    const float x = (float)row[k];
    float acc = 1.0f;
    float xp = x;
#pragma unroll
    for (int i = 1; i < kMaxDegree; ++i) {
      if (i < degree) {
        acc = __fadd_rn(acc, __fmul_rn(coef[i], xp));
        xp = __fmul_rn(xp, x);
      }
    }
    e[k] = x >= 0.0f ? acc : 0.0f;
    denom = __fadd_rn(denom, e[k]);
  }
  denom = __fadd_rn(denom, kFltMin);

  float best = e[0];
  int arg = 0;
#pragma unroll
  for (int k = 1; k < kDustbin; ++k) {
    if (e[k] > best) {
      best = e[k];
      arg = k;
    }
  }
  const bool has = best > 0.0f;
  const int idx = has ? arg : kDustbin;
  probs[c] = has ? __fdiv_rn(best, denom) : -1.0f;
  idx_out[c] = idx;

  const int wx = idx % 8, wy = idx / 8;
  float den3 = 0.0f, sx = 0.0f, sy = 0.0f;
#pragma unroll
  for (int k = 0; k < kDustbin; ++k) {
    const int ix = k % 8, iy = k / 8;
    if (abs(ix - wx) <= 1 && abs(iy - wy) <= 1) {
      den3 = __fadd_rn(den3, e[k]);
      sx = __fadd_rn(sx, __fmul_rn(e[k], (float)ix));
      sy = __fadd_rn(sy, __fmul_rn(e[k], (float)iy));
    }
  }
  den3 = fmaxf(den3, 1e-20f);
  const int cell = c % cells_per_stream;
  const float col = (float)(cell % grid_w), rowf = (float)(cell / grid_w);
  xy[2 * c] = __fadd_rn(__fmul_rn(col, 8.0f), __fdiv_rn(sx, den3));
  xy[2 * c + 1] = __fadd_rn(__fmul_rn(rowf, 8.0f), __fdiv_rn(sy, den3));
}

}  // namespace

extern "C" int detector_postproc(const void* semi, const void* scale, void* probs,
                                 void* idx, void* xy, int num_cells,
                                 int cells_per_stream, int grid_w, int degree,
                                 void* stream) {
  if (num_cells <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (num_cells + threads - 1) / threads;
  detector_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)semi, (const float*)scale, (float*)probs, (int*)idx,
      (float*)xy, num_cells, cells_per_stream, grid_w, degree);
  return (int)cudaGetLastError();
}
