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
// The operation order is that of cholesky_small / cholesky_solve_small
// (ops/linalg.py) so the plain PyTorch version and this kernel round alike.
//
// Bound on this card: bytes, and even those are tiny. The main path's
// largest call is 256 matrices of 9x9 f32 (~83 KB in, 9 KB out, ~0.03 us at
// 3.35 TB/s) and ~2.2 k flops a matrix. Both are far under a launch; what
// the kernel takes is the latency of one thread's dependent chain (the
// Cholesky and ten solves, ~200 IEEE divisions among them), since 256
// matrices fill only two blocks. The TPU kernel
// laid the batch across vector lanes (component-major (n*n, B)); here one
// thread owns one matrix and keeps A's lower triangle, L and x in
// registers (n is a template parameter, 9 for the 8-point nullspace and 4
// for DLT triangulation), so the whole recurrence is one launch with no
// shared memory and no synchronisation.

#include <cuda_runtime.h>

namespace {

template <int N>
__global__ void nullspace_kernel(const float* __restrict__ A,
                                 float* __restrict__ x_out, int batch,
                                 int iterations) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const float* a = A + (size_t)b * N * N;

  float tr = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) tr = tr + a[i * N + i];
  const float delta = (1e-7f * fmaxf(tr, 1e-30f)) / (float)N;

  float L[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = a[i * N + j];
      if (i == j) s = s + delta;
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-30f)) : s / L[j][j];
    }
  }

  float x[N];
  const float x0 = 1.0f / sqrtf((float)N);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x0;

  for (int it = 0; it < iterations; ++it) {
    float y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = x[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
      y[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
      x[i] = s / L[i][i];
    }
    float nrm2 = x[0] * x[0];
#pragma unroll
    for (int i = 1; i < N; ++i) nrm2 = nrm2 + x[i] * x[i];
    const float nrm = fmaxf(sqrtf(nrm2), 1e-30f);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = x[i] / nrm;
  }

  float* out = x_out + (size_t)b * N;
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = x[i];
}

}  // namespace

extern "C" int nullspace_inverse_iteration(const void* A, void* x, int batch, int n,
                                           int iterations, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 9) {
    nullspace_kernel<9><<<blocks, threads, 0, s>>>((const float*)A, (float*)x, batch, iterations);
  } else if (n == 4) {
    nullspace_kernel<4><<<blocks, threads, 0, s>>>((const float*)A, (float*)x, batch, iterations);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
