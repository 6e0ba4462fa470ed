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
// first is the contract.) The integers are exact and the two roundings of
// cos2 are __fmul_rn/__fdiv_rn, so scores equal the plain version's bit for
// bit.
//
// Streams: with S streams the queries are (S, N) and the cells (S, C), and
// stream s's queries see only stream s's cells; best_cell is within the
// stream. Blocks (x, s) of an (N / kQueries, S) grid take stream s.
//
// Bound on this card: bytes, and far under a launch. The main path (N = 100
// queries, C = 1920 cells of 256 int8) must read ~0.53 MB, ~0.16 us at
// 3.35 TB/s, and its window products are ~4 M int8 operations; at S = 16
// 7.9 MB of cells stay in L2, from which the 1600 windows read ~33 MB. The
// kernel's own time is latency: four warps walking a query's 81 cells one
// cell a warp at a time make a serial chain of loads and shuffle
// reductions, ~20 dependent memory round trips a warp (the previous
// kernel, ~10.7 us at N = 100). Design, against that chain: a block of
// kThreads threads takes a query; it puts the query's descriptor and every window
// cell's descriptor in flight at once (16-byte cp.async, ~10 a thread,
// each window row a contiguous run of cells) together with each cell's
// probs0/indices0, waits once, and then each thread takes one window cell
// from shared memory: 64 x 3 __dp4a (dot, n0 and n1) over 16-byte reads,
// with no shuffle and no memory round trip. Rows sit 272 bytes apart
// (17 chunks of 16 bytes), so the 8 threads of a 16-byte shared-memory
// phase read 8 distinct bank groups. The block then takes the (score, cell)
// maximum with the lower-cell tie rule: a 5-step shuffle tree per warp and
// one pass over the warps. Measured on an H100 (PERF.md): ~3 us at
// N = 100 and ~10 us at S = 16; 2 or 4 queries a block (kQueries) were
// slower at both. Tensor cores do not serve this: each query meets its own
// 81 cells (an M = 1 product per query, with no operand shared between
// queries), and the dp4a work is ~0.3 us of a thread's chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 256;
constexpr int kThreads = 128;               // threads a query; a tile is up to kThreads cells
constexpr int kQueries = 1;                 // queries a block
constexpr int kChunks = kDim / 16;          // 16-byte chunks a descriptor
constexpr int kRowBytes = kDim + 16;        // shared row stride: 17 chunks
constexpr int kCellsPerPass = kThreads / kChunks;  // cells a copy pass covers
constexpr int kWarps = kThreads / 32;
constexpr int kDustbin = 64;
static_assert(kThreads % kChunks == 0 && kThreads % 32 == 0, "whole cells and warps a pass");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool better(float s, int c, float bs, int bc) {
  return s > bs || (s == bs && c < bc);
}

__global__ void __launch_bounds__(kThreads * kQueries)
match_kernel(const int8_t* __restrict__ desc1_sel, const int8_t* __restrict__ desc0,
             const float* __restrict__ probs0, const int* __restrict__ indices0,
             const int* __restrict__ cells1, float* __restrict__ best_score,
             int* __restrict__ best_cell, int n, int grid_h, int grid_w, int shift_x,
             int shift_y, int radius, float min_prob, int is_signed, int window_max,
             int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_score[kQueries][kWarps];
  __shared__ int s_cell[kQueries][kWarps];
  // This query's rows: row 0 its descriptor, rows 1..tile the window cells.
  unsigned char* rows = smem + (size_t)threadIdx.y * (tile + 1) * kRowBytes;
  const int t = threadIdx.x;
  const int qi = blockIdx.x * kQueries + threadIdx.y;
  const bool active = qi < n;
  const size_t q = (size_t)blockIdx.y * n + (active ? qi : 0);
  const int num_cells = grid_h * grid_w;
  desc0 += (size_t)blockIdx.y * num_cells * kDim;
  probs0 += (size_t)blockIdx.y * num_cells;
  indices0 += (size_t)blockIdx.y * num_cells;

  if (active && t < kChunks) cp_async16(smem_addr(rows + t * 16), desc1_sel + q * kDim + t * 16);
  const int cell1 = active ? cells1[q] : 0;
  const int rc = cell1 / grid_w + shift_y;
  const int cc = cell1 % grid_w + shift_x;
  const int r_lo = max(rc - radius, 0), r_hi = min(rc + radius, grid_h - 1);
  const int c_lo = max(cc - radius, 0), c_hi = min(cc + radius, grid_w - 1);
  const int nr = r_hi - r_lo + 1, nc = c_hi - c_lo + 1;
  const int count = (active && nr > 0 && nc > 0) ? nr * nc : 0;

  float bs = -1.0f;
  int bc = 0;
  // window_max bounds every query's count, so all threads of the block pass
  // the same barriers.
  for (int j0 = 0; j0 < window_max; j0 += tile) {
    const int m = min(count - j0, tile);  // cells of this tile (<= 0: none)
    int jj = t / kChunks;
    if (jj < m) {
      const int part = t % kChunks;
      int wr = (j0 + jj) / nc, wc = (j0 + jj) - wr * nc;
      for (; jj < m; jj += kCellsPerPass) {
        const int cell = (r_lo + wr) * grid_w + c_lo + wc;
        cp_async16(smem_addr(rows + (1 + jj) * kRowBytes + part * 16),
                   desc0 + (size_t)cell * kDim + part * 16);
        wc += kCellsPerPass;
        while (wc >= nc) {
          wc -= nc;
          ++wr;
        }
      }
    }
    // This thread's cell: its mask inputs load while the copies fly.
    int cell = 0, idx0 = kDustbin;
    float p0 = 0.0f;
    if (t < m) {
      const int wr = (j0 + t) / nc;
      cell = (r_lo + wr) * grid_w + c_lo + (j0 + t) - wr * nc;
      idx0 = indices0[cell];
      p0 = probs0[cell];
    }
    cp_async_wait_all();
    __syncthreads();
    if (t < m) {
      const int4* qrow = reinterpret_cast<const int4*>(rows);
      const int4* drow = reinterpret_cast<const int4*>(rows + (1 + t) * kRowBytes);
      int dot[2] = {0, 0}, n0[2] = {0, 0}, n1[2] = {0, 0};  // two chains each
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int4 a = qrow[k], d = drow[k];
        const int h = k & 1;
        dot[h] = __dp4a(a.x, d.x, __dp4a(a.y, d.y, __dp4a(a.z, d.z, __dp4a(a.w, d.w, dot[h]))));
        n0[h] = __dp4a(d.x, d.x, __dp4a(d.y, d.y, __dp4a(d.z, d.z, __dp4a(d.w, d.w, n0[h]))));
        n1[h] = __dp4a(a.x, a.x, __dp4a(a.y, a.y, __dp4a(a.z, a.z, __dp4a(a.w, a.w, n1[h]))));
      }
      if (idx0 != kDustbin && p0 >= min_prob) {
        const float df = (float)(dot[0] + dot[1]);
        const float denom = fmaxf(__fmul_rn((float)(n1[0] + n1[1]), (float)(n0[0] + n0[1])), 1.0f);
        float cos2 = __fdiv_rn(__fmul_rn(df, df), denom);
        if (is_signed && !(df > 0.0f)) cos2 = 0.0f;
        if (better(cos2, cell, bs, bc)) {
          bs = cos2;
          bc = cell;
        }
      }
    }
    __syncthreads();  // the next tile overwrites the rows
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, bs, o);
    const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
    if (better(os, oc, bs, bc)) {
      bs = os;
      bc = oc;
    }
  }
  const int warp = t / 32;
  if (t % 32 == 0) {
    s_score[threadIdx.y][warp] = bs;
    s_cell[threadIdx.y][warp] = bc;
  }
  __syncthreads();
  if (t == 0 && active) {
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_score[threadIdx.y][w], s_cell[threadIdx.y][w], bs, bc)) {
        bs = s_score[threadIdx.y][w];
        bc = s_cell[threadIdx.y][w];
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
  // The most cells any query's window can hold, clipped to the grid.
  const int span = radius < 0 ? 0 : 2 * radius + 1;
  const int window_max = min(span, grid_h) * min(span, grid_w);
  const int tile = max(1, min(window_max, kThreads));
  const size_t smem = (size_t)kQueries * (tile + 1) * kRowBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  match_kernel<<<dim3((n + kQueries - 1) / kQueries, num_streams), dim3(kThreads, kQueries),
                 smem, (cudaStream_t)stream>>>(
      (const int8_t*)desc1_sel, (const int8_t*)desc0, (const float*)probs0,
      (const int*)indices0, (const int*)cells1, (float*)best_score, (int*)best_cell, n,
      grid_h, grid_w, shift_x, shift_y, radius, min_prob, is_signed, window_max, tile);
  return (int)cudaGetLastError();
}
