// Fused windowed int8 descriptor match: for each query descriptor, the best
// squared cosine over the previous frame's usable cells inside a window.
//
// Replaces: maveric_slam_tpu/ops/pallas_kernels.py fused_windowed_match
// (:169-218, kernel _match_kernel :128-166).
//
// Contract (that of the jnp path, maveric_slam_tpu/ops/matching.py:82-114):
//   dot  = <q, d0[c]> in int32 (exact);  n1, n0 = squared norms in int32;
//   cos2 = (dot*dot) / max(n1*n0, 1) in f32, in that order; 0 where dot <= 0
//          when `signed`;
//   score[c] = cos2 where |row(c) - (row1+shift_y)| <= r and
//          |col(c) - (col1+shift_x)| <= r and indices0[c] != 64 and
//          probs0[c] >= min_prob, else -1;
//   result = (max_c score, FIRST argmax over the whole row).
// Usable window cells score >= 0 > -1, so the first maximum of the full row
// is the lowest-index usable window cell that reaches the maximum, and when
// no window cell is usable it is (-1, cell 0). The kernel therefore visits
// only the (2r+1)^2 window and returns exactly the full-row answer. (The
// Pallas kernel's plain argmax takes the LAST maximum under Mosaic; the
// first is the contract.)
//
// Streams: with S streams the queries are (S, N) and the cells (S, C), and
// stream s's queries see only stream s's cells; best_cell is within the
// stream. Block (q, s) of an (N, S) grid takes query q of stream s.
//
// Bound on this card: bytes. The main path (N=100 queries, C=1920 cells of
// 256 int8) reads ~0.53 MB once, ~0.16 us at 3.35 TB/s; the window's int8
// products are ~4 M operations. Both are far under a launch; the kernel's
// own time is the latency of a warp's serial walk over its share of the
// window (~20 of the 81 cells, two shuffle reductions each). Design: one
// block of four warps per query, 100 blocks in all; each lane holds
// 8 query bytes, a warp takes one window cell at a time (256 bytes, one
// coalesced load), forms the dot and the cell norm with __dp4a and a
// shuffle reduction, and the block reduces (score, cell) with a lower-cell
// tie-break. The product and quotient of cos2 use __fmul_rn/__fdiv_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 256;
constexpr int kWarps = 4;
constexpr int kDustbin = 64;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool better(float s, int c, float bs, int bc) {
  return s > bs || (s == bs && c < bc);
}

__global__ void match_kernel(const int8_t* __restrict__ desc1_sel,
                             const int8_t* __restrict__ desc0,
                             const float* __restrict__ probs0,
                             const int* __restrict__ indices0,
                             const int* __restrict__ cells1,
                             float* __restrict__ best_score,
                             int* __restrict__ best_cell,
                             int grid_h, int grid_w, int shift_x, int shift_y,
                             int radius, float min_prob, int is_signed) {
  __shared__ float s_score[kWarps];
  __shared__ int s_cell[kWarps];
  const int num_cells = grid_h * grid_w;
  const size_t q = (size_t)blockIdx.y * gridDim.x + blockIdx.x;  // query row of all S * N
  desc0 += (size_t)blockIdx.y * num_cells * kDim;
  probs0 += (size_t)blockIdx.y * num_cells;
  indices0 += (size_t)blockIdx.y * num_cells;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int2 qv = reinterpret_cast<const int2*>(desc1_sel + (size_t)q * kDim)[lane];
  const int n1 = warp_sum(__dp4a(qv.x, qv.x, __dp4a(qv.y, qv.y, 0)));
  const float n1f = (float)n1;

  const int cell1 = cells1[q];
  const int rc = cell1 / grid_w + shift_y;
  const int cc = cell1 % grid_w + shift_x;
  const int r_lo = max(rc - radius, 0), r_hi = min(rc + radius, grid_h - 1);
  const int c_lo = max(cc - radius, 0), c_hi = min(cc + radius, grid_w - 1);
  const int nr = r_hi - r_lo + 1, nc = c_hi - c_lo + 1;
  const int count = (nr > 0 && nc > 0) ? nr * nc : 0;

  float bs = -1.0f;
  int bc = 0;
  for (int j = warp; j < count; j += kWarps) {
    const int cell = (r_lo + j / nc) * grid_w + (c_lo + j % nc);
    const int2 dv = reinterpret_cast<const int2*>(desc0 + (size_t)cell * kDim)[lane];
    const int dot = warp_sum(__dp4a(qv.x, dv.x, __dp4a(qv.y, dv.y, 0)));
    const int n0 = warp_sum(__dp4a(dv.x, dv.x, __dp4a(dv.y, dv.y, 0)));
    if (indices0[cell] == kDustbin || !(probs0[cell] >= min_prob)) continue;
    const float df = (float)dot;
    const float denom = fmaxf(__fmul_rn(n1f, (float)n0), 1.0f);
    float cos2 = __fdiv_rn(__fmul_rn(df, df), denom);
    if (is_signed && !(df > 0.0f)) cos2 = 0.0f;
    if (better(cos2, cell, bs, bc)) {
      bs = cos2;
      bc = cell;
    }
  }
  if (lane == 0) {
    s_score[warp] = bs;
    s_cell[warp] = bc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_score[w], s_cell[w], bs, bc)) {
        bs = s_score[w];
        bc = s_cell[w];
      }
    }
    best_score[q] = bs;
    best_cell[q] = bc;
  }
}

}  // namespace

extern "C" int windowed_match(const void* desc1_sel, const void* desc0,
                              const void* probs0, const void* indices0,
                              const void* cells1, void* best_score, void* best_cell,
                              int n, int num_streams, int grid_h, int grid_w, int shift_x,
                              int shift_y, int radius, float min_prob,
                              int is_signed, void* stream) {
  if (n <= 0 || num_streams <= 0) return (int)cudaSuccess;
  match_kernel<<<dim3(n, num_streams), 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)desc1_sel, (const int8_t*)desc0, (const float*)probs0,
      (const int*)indices0, (const int*)cells1, (float*)best_score,
      (int*)best_cell, grid_h, grid_w, shift_x, shift_y, radius, min_prob,
      is_signed);
  return (int)cudaGetLastError();
}
