// Signed 3x3 SVD of a batch of matrices: A = U diag(s) V^T with U, V proper
// rotations, |s0| >= |s1| >= |s2| and s2 carrying sign(det A).
//
// Replaces: maveric_slam_tpu/ops/pallas_kernels.py svd3_pallas (:462-493,
// kernel _svd3_kernel :325-459), the dispatch target of
// maveric_slam_tpu/ops/svd3.py svd3.
//
// Algorithm (McAdams et al. 2011, as in _svd3_kernel): `sweeps` cyclic
// Jacobi sweeps on S = A^T A with the closed-form approximate Givens angle;
// B = A V; columns sorted by norm with conditional swaps that negate one
// column to keep det V = +1; u0 = b0/|b0| (e0 for the zero matrix);
// u1 = b1 orthogonalised against u0 (rank-1 fallback: u0 x least-aligned
// axis); u2 = u0 x u1; s2 = <b2, u2>.
//
// Bound on this card: bytes, and tiny. The main path's largest call is 256
// matrices (9 KB in, 21 KB out, ~0.01 us at 3.35 TB/s; ~1.5 k flops a
// matrix), far under a launch; the kernel's own time is the latency of one
// thread's chain of 18 dependent Jacobi rotations. The TPU kernel laid the
// batch across vector lanes; here one thread owns one matrix in registers,
// every branch of the algorithm is a per-thread select, and the whole
// decomposition is one launch.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-12f;

struct Mat {
  float m[3][3];
};

template <int P, int Q>
__device__ __forceinline__ void jacobi(Mat& S, Mat& V, float gamma, float cos_pi8,
                                       float sin_pi8) {
  const float app = S.m[P][P], aqq = S.m[Q][Q], apq = S.m[P][Q];
  const float ch = 2.0f * (app - aqq);
  const float sh = apq;
  const bool use_big = gamma * sh * sh < ch * ch;
  const float w = use_big ? 1.0f / sqrtf(fmaxf(ch * ch + sh * sh, kEps)) : 0.0f;
  const float ch_h = use_big ? w * ch : cos_pi8;
  const float sh_h = use_big ? w * sh : sin_pi8;
  const float nrm = ch_h * ch_h + sh_h * sh_h;
  const float c = (ch_h * ch_h - sh_h * sh_h) / nrm;
  const float s = (2.0f * ch_h * sh_h) / nrm;

  Mat T = S;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T.m[i][P] = S.m[i][P] * c + S.m[i][Q] * s;
    T.m[i][Q] = -S.m[i][P] * s + S.m[i][Q] * c;
  }
  S = T;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    S.m[P][j] = c * T.m[P][j] + s * T.m[Q][j];
    S.m[Q][j] = -s * T.m[P][j] + c * T.m[Q][j];
  }
  Mat Vn = V;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Vn.m[i][P] = V.m[i][P] * c + V.m[i][Q] * s;
    Vn.m[i][Q] = -V.m[i][P] * s + V.m[i][Q] * c;
  }
  V = Vn;
}

__device__ __forceinline__ float norm2_col(const Mat& M, int j) {
  return M.m[0][j] * M.m[0][j] + M.m[1][j] * M.m[1][j] + M.m[2][j] * M.m[2][j];
}

template <int I, int J>
__device__ __forceinline__ void cond_swap(Mat& B, Mat& V) {
  const bool swap = norm2_col(B, I) < norm2_col(B, J);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float bi = B.m[r][I], bj = B.m[r][J];
    B.m[r][I] = swap ? bj : bi;
    B.m[r][J] = swap ? -bi : bj;
    const float vi = V.m[r][I], vj = V.m[r][J];
    V.m[r][I] = swap ? vj : vi;
    V.m[r][J] = swap ? -vi : vj;
  }
}

__global__ void svd3_kernel(const float* __restrict__ A_in, float* __restrict__ U_out,
                            float* __restrict__ s_out, float* __restrict__ V_out,
                            int batch, int sweeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  // The f32 constants of the JAX package (3 + 2 sqrt 2, cos pi/8 and
  // sin pi/8 evaluated in f32, ops/svd3.py:26-28), bit for bit.
  const float gamma = 5.828427314758301f;
  const float cos_pi8 = 0.9238795042037964f;
  const float sin_pi8 = 0.3826834559440613f;

  Mat A;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A.m[i][j] = A_in[(size_t)b * 9 + i * 3 + j];

  Mat S, V;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      S.m[i][j] = A.m[0][i] * A.m[0][j] + A.m[1][i] * A.m[1][j] + A.m[2][i] * A.m[2][j];
      V.m[i][j] = (i == j) ? 1.0f : 0.0f;
    }

  for (int k = 0; k < sweeps; ++k) {
    jacobi<0, 1>(S, V, gamma, cos_pi8, sin_pi8);
    jacobi<0, 2>(S, V, gamma, cos_pi8, sin_pi8);
    jacobi<1, 2>(S, V, gamma, cos_pi8, sin_pi8);
  }

  Mat B;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      B.m[i][j] = A.m[i][0] * V.m[0][j] + A.m[i][1] * V.m[1][j] + A.m[i][2] * V.m[2][j];

  cond_swap<0, 1>(B, V);
  cond_swap<0, 2>(B, V);
  cond_swap<1, 2>(B, V);

  const float s0 = sqrtf(norm2_col(B, 0));
  const float s1 = sqrtf(norm2_col(B, 1));

  float u0[3];
  const float inv0 = 1.0f / fmaxf(s0, kEps);
  const bool big0 = s0 > 1e-8f;
  u0[0] = big0 ? B.m[0][0] * inv0 : 1.0f;
  u0[1] = big0 ? B.m[1][0] * inv0 : 0.0f;
  u0[2] = big0 ? B.m[2][0] * inv0 : 0.0f;

  const float dot10 = B.m[0][1] * u0[0] + B.m[1][1] * u0[1] + B.m[2][1] * u0[2];
  float b1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) b1[k] = B.m[k][1] - dot10 * u0[k];
  const float b1n = sqrtf(b1[0] * b1[0] + b1[1] * b1[1] + b1[2] * b1[2]);
  const float ax0 = fabsf(u0[0]), ax1 = fabsf(u0[1]), ax2 = fabsf(u0[2]);
  const bool pick0 = (ax0 <= ax1) && (ax0 <= ax2);
  const bool pick1 = !pick0 && (ax1 <= ax2);
  const float e0 = pick0 ? 1.0f : 0.0f;
  const float e1 = pick1 ? 1.0f : 0.0f;
  const float e2 = (pick0 || pick1) ? 0.0f : 1.0f;
  float alt[3] = {u0[1] * e2 - u0[2] * e1, u0[2] * e0 - u0[0] * e2,
                  u0[0] * e1 - u0[1] * e0};
  const float altn =
      fmaxf(sqrtf(alt[0] * alt[0] + alt[1] * alt[1] + alt[2] * alt[2]), kEps);
  const float invb1 = 1.0f / fmaxf(b1n, kEps);
  const bool bigb1 = b1n > 1e-8f;
  float u1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) u1[k] = bigb1 ? b1[k] * invb1 : alt[k] / altn;

  const float u2[3] = {u0[1] * u1[2] - u0[2] * u1[1], u0[2] * u1[0] - u0[0] * u1[2],
                       u0[0] * u1[1] - u0[1] * u1[0]};
  const float s2 = B.m[0][2] * u2[0] + B.m[1][2] * u2[1] + B.m[2][2] * u2[2];

  float* U = U_out + (size_t)b * 9;
  float* Vo = V_out + (size_t)b * 9;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[i * 3 + 0] = u0[i];
    U[i * 3 + 1] = u1[i];
    U[i * 3 + 2] = u2[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) Vo[i * 3 + j] = V.m[i][j];
  }
  s_out[(size_t)b * 3 + 0] = s0;
  s_out[(size_t)b * 3 + 1] = s1;
  s_out[(size_t)b * 3 + 2] = s2;
}

}  // namespace

extern "C" int svd3(const void* A, void* U, void* s, void* V, int batch, int sweeps,
                    void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  svd3_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)A, (float*)U, (float*)s, (float*)V, batch, sweeps);
  return (int)cudaGetLastError();
}
