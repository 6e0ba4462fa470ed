// Smallest eigenvector of a batch of small symmetric PSD matrices by
// trace-shifted Cholesky and inverse iteration.
//
// Replaces: maveric_slam_tpu/ops/pallas_kernels.py nullspace_inverse_iteration
// (:292-322, kernel _nullspace_kernel :239-289), the dispatch target of
// maveric_slam_tpu/ops/linalg.py smallest_eigvec_inverse_iteration.
//
// Per matrix A (n x n, row-major):
//   delta = 1e-7 * max(tr A, 1e-30) / n;  L = chol(A + delta I) with
//   pivots sqrt(max(s, 1e-30));  x = 1/sqrt(n) * ones;
//   `iterations` times: x = solve(L L^T, x); x /= max(|x|, 1e-30).
// The trace and the Cholesky keep the operation order of cholesky_small
// (ops/linalg.py): each entry subtracts its terms in increasing k, and the
// off-diagonal entries divide by the pivot. The solves differ from
// cholesky_solve_small in two ways: they multiply by the pivots'
// reciprocals, formed once (the TPU kernel normalises by a reciprocal too),
// and the back substitution subtracts its terms in decreasing k (column by
// column, below). The norm is a sum over lanes in butterfly order. Against
// the plain version the result differs by rounding only (PERF.md): on the
// main path's matrices the sign-aligned max |dx| is 7.9e-5, bar 1e-3 (the
// previous one-thread design: 6.6e-5).
//
// Bound on this card: bytes, and even those are tiny. The main path's
// largest call is 256 matrices of 9x9 f32 (~83 KB in, 9 KB out, ~0.03 us at
// 3.35 TB/s) and ~2.2 k flops a matrix; the batched step's is 4096. Both
// are far under a launch, so what the kernel takes is the latency of its
// dependent chain. Design, against that chain: a matrix is spread over a
// group of G lanes (G = 16 for n = 9, two matrices a warp; G = 4 for n = 4,
// eight a warp); lane i holds row i of A and then of L, column i of L
// (L[k][i], k > i) and x_i, in registers. The Cholesky runs column by
// column: the diagonal lane's pivot is broadcast, the lanes below divide in
// parallel, and each new column entry L[j][k] is broadcast for the trailing
// update (and kept by lane k as its column). A substitution runs kBlock = 3
// columns at a time: the block's lanes broadcast their partial sums, every
// lane finishes the block's three unknowns itself (it holds the pivot
// reciprocals and L's band next to the diagonal), and the lanes still
// waiting subtract their terms. The values are those of one column at a
// time, bit for bit; a round's chain is 2n/3 shuffles instead of one
// thread's ~80 dependent multiply-subtracts and 18 divisions. With
// 128-thread blocks the main call (B = 256) covers 32 blocks and B = 4096
// covers 512, where one thread a matrix filled 2 and 32. Measured on an
// H100 (PERF.md): ~3.5 us of a call at B = 256 is the loads and the
// Cholesky (its 9 square roots and divisions in a chain), ~0.4 us each of
// the 10 rounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlock = 3;  // columns of a substitution finished per broadcast
constexpr unsigned kFull = 0xffffffffu;

template <int N, int G>
__global__ void __launch_bounds__(kThreads)
nullspace_kernel(const float* __restrict__ A, float* __restrict__ x_out, int batch,
                 int iterations) {
  static_assert(N <= G && (G & (G - 1)) == 0 && 32 % G == 0, "a group is a power of 2 >= n");
  const int lane = threadIdx.x & (G - 1);
  const int b = (blockIdx.x * kThreads + threadIdx.x) / G;
  // Every lane of the warp takes part in the shuffles: a group past the
  // batch works on the last matrix and stores nothing.
  const float* a = A + (size_t)(b < batch ? b : batch - 1) * N * N;
  const bool row = lane < N;

  float tr = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) tr = tr + a[i * N + i];
  const float delta = (1e-7f * fmaxf(tr, 1e-30f)) / (float)N;

  // r[j]: row `lane` of A + delta I, then of L (entries j <= lane are used).
  float r[N], col[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    r[j] = row ? a[lane * N + j] : 0.0f;
    if (j == lane) r[j] = r[j] + delta;
    col[j] = 0.0f;
  }
  float diag = 1.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float piv = __shfl_sync(kFull, sqrtf(fmaxf(r[k], 1e-30f)), k, G);
    if (lane == k) diag = piv;
    r[k] = (lane == k) ? piv : r[k] / piv;  // L[lane][k] for lane >= k
#pragma unroll
    for (int j = k + 1; j < N; ++j) {
      const float v = __shfl_sync(kFull, r[k], j, G);  // L[j][k]
      if (lane >= j) r[j] = r[j] - r[k] * v;
      if (lane == k) col[j] = v;
    }
  }
  // Every lane gets the pivot reciprocals and the band of L within
  // kBlock - 1 of the diagonal: band[i][d] = L[i][i - d].
  const float rinv = 1.0f / diag;
  float rinvs[N], band[N][kBlock];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    rinvs[i] = __shfl_sync(kFull, rinv, i, G);
#pragma unroll
    for (int d = 0; d < kBlock; ++d)
      band[i][d] = (d > 0 && d <= i) ? __shfl_sync(kFull, r[i - d], i, G) : 0.0f;
  }

  float x = row ? 1.0f / sqrtf((float)N) : 0.0f;
#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
    // Forward, L y = x, kBlock columns at a time: every lane takes the
    // block's partial sums from their lanes, finishes the block's unknowns
    // itself, and the lanes below subtract their terms.
    float s = x;
#pragma unroll
    for (int kb = 0; kb < N; kb += kBlock) {
      float v[kBlock];
#pragma unroll
      for (int e = 0; e < kBlock; ++e)
        if (kb + e < N) v[e] = __shfl_sync(kFull, s, kb + e, G);
#pragma unroll
      for (int e = 0; e < kBlock; ++e) {
        if (kb + e < N) {
          float t = v[e];
#pragma unroll
          for (int f = 0; f < e; ++f) t = t - band[kb + e][e - f] * v[f];
          v[e] = t * rinvs[kb + e];
        }
      }
#pragma unroll
      for (int e = 0; e < kBlock; ++e) {
        if (kb + e < N) {
          if (lane > kb + e) s = s - r[kb + e] * v[e];
          if (lane == kb + e) s = v[e];
        }
      }
    }
    // Backward, L^T z = y, the mirror image from the last column.
#pragma unroll
    for (int kt = N - 1; kt >= 0; kt -= kBlock) {
      float v[kBlock];
#pragma unroll
      for (int e = 0; e < kBlock; ++e)
        if (kt - e >= 0) v[e] = __shfl_sync(kFull, s, kt - e, G);
#pragma unroll
      for (int e = 0; e < kBlock; ++e) {
        if (kt - e >= 0) {
          float t = v[e];
#pragma unroll
          for (int f = 0; f < e; ++f) t = t - band[kt - f][e - f] * v[f];
          v[e] = t * rinvs[kt - e];
        }
      }
#pragma unroll
      for (int e = 0; e < kBlock; ++e) {
        if (kt - e >= 0) {
          if (lane < kt - e) s = s - col[kt - e] * v[e];
          if (lane == kt - e) s = v[e];
        }
      }
    }
    float n2 = row ? s * s : 0.0f;
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1) n2 = n2 + __shfl_xor_sync(kFull, n2, m, G);
    x = row ? s * (1.0f / fmaxf(sqrtf(n2), 1e-30f)) : 0.0f;
  }

  if (b < batch && row) x_out[(size_t)b * N + lane] = x;
}

}  // namespace

extern "C" int nullspace_inverse_iteration(const void* A, void* x, int batch, int n,
                                           int iterations, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 9) {
    const int per_block = kThreads / 16;
    nullspace_kernel<9, 16><<<(batch + per_block - 1) / per_block, kThreads, 0, s>>>(
        (const float*)A, (float*)x, batch, iterations);
  } else if (n == 4) {
    const int per_block = kThreads / 4;
    nullspace_kernel<4, 4><<<(batch + per_block - 1) / per_block, kThreads, 0, s>>>(
        (const float*)A, (float*)x, batch, iterations);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
