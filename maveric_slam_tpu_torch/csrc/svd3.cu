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
// axis); u2 = u0 x u1; s2 = <b2, u2>. The same sweeps, f32 constants,
// thresholds, fallbacks and sort as the plain version; the arithmetic is
// reordered (below), so results agree with it to rounding, within the bars
// of ROADMAP.md, not bit for bit. A matrix's result depends on that matrix
// alone (one thread, one instruction stream), so it is the same bit for bit
// at any batch size and position.
//
// Bound on this card: bytes, and tiny. The main path's largest call is 256
// matrices (9 KB in, 21 KB out, ~0.01 us at 3.35 TB/s; ~1 k flops a
// matrix), the batched step's 4096; both are far under a launch. What the
// kernel takes is the latency of one matrix's dependent chain: 18 Jacobi
// rotations, each an angle and an update of S that the next rotation needs.
// The previous kernel spent ~6 us on that chain (PERF.md): each rotation took
// an IEEE square root, an IEEE reciprocal and two IEEE divisions, and formed
// the full two-sided 3x3 product, with every multiply-add split
// (-fmad=false). Design, against that chain:
//   - the angle from t = sh/ch: c = (1 - t^2)/(1 + t^2), s = 2t/(1 + t^2),
//     the same rotation as normalising (w ch, w sh), with two hardware
//     reciprocals (rcp.approx) and no square root or division. On the
//     "big" branch |t| < 0.42 and ch != 0, so nothing overflows where the
//     old clamp at 1e-12 was needed; the small-angle (c, s) are the
//     constants' own, formed once. With correctly rounded reciprocals a
//     sweep took 0.40 us, with rcp.approx 0.21 us, and s moved by < 1e-6;
//   - only the 6 unique entries of the symmetric S, updated in closed form
//     for the pair (p, q) (3 diagonal/off-diagonal entries of the pair and 2
//     of the third row), V's two columns off the chain;
//   - explicit __fmaf_rn for every multiply-add (the build keeps
//     -fmad=false for the detector's exact ties);
//   - reciprocal norms in the U rebuild by rsqrtf beside the square roots
//     that give s, not after them;
//   - 32-thread blocks, so B = 256 spreads over 8 SMs and B = 4096 over 128
//     (with 128 threads: 2 and 32).
// Measured on an H100 (PERF.md): of ~2.7 us at B = 256, ~1.2 us is the
// launch and the loads and stores (a copy kernel of the same shape), ~0.2
// us the set-up and U rebuild, ~1.3 us the 6 sweeps. One matrix stays on
// one thread: spreading it over lanes would put a shuffle (~30 cycles) on
// each rotation of a chain whose length is the angle, not the update.
// wgmma and TMA do not apply: a
// 36-byte matrix has no product of tensor-core size to give wgmma, and its
// 9 loads are one round trip that TMA could only add a barrier to.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 32;

// The angle's reciprocals: MUFU.RCP alone (rcp.approx, within 1 ulp,
// subnormals kept, 1/0 = inf). The correctly rounded __frcp_rn adds a
// refinement and a range check to each; tools/torch_kernel_breakdown.py
// times it in this one's place.
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One Jacobi rotation on the pair (P, Q). S is held as its diagonal d and
// off-diagonal o, where o[K] = S[P][Q] for K the index not in {P, Q}.
template <int P, int Q>
__device__ __forceinline__ void jacobi(float (&d)[3], float (&o)[3], float (&V)[3][3],
                                       float gamma, float c_small, float s_small) {
  constexpr int K = 3 - P - Q;
  const float app = d[P], aqq = d[Q], apq = o[K];
  const float ch = __fmul_rn(2.0f, __fsub_rn(app, aqq));
  const float sh = apq;
  const bool use_big = __fmul_rn(__fmul_rn(gamma, sh), sh) < __fmul_rn(ch, ch);
  const float t = __fmul_rn(sh, recip(ch));
  const float t2 = __fmul_rn(t, t);
  const float r = recip(__fadd_rn(1.0f, t2));
  const float c = use_big ? __fmul_rn(__fsub_rn(1.0f, t2), r) : c_small;
  const float s = use_big ? __fmul_rn(__fmul_rn(2.0f, t), r) : s_small;

  const float cc = __fmul_rn(c, c), ss = __fmul_rn(s, s), cs = __fmul_rn(c, s);
  const float cs2apq = __fmul_rn(__fmul_rn(2.0f, cs), apq);
  const float akp = o[Q], akq = o[P];  // S[K][P], S[K][Q]
  d[P] = __fmaf_rn(cc, app, __fmaf_rn(ss, aqq, cs2apq));
  d[Q] = __fmaf_rn(ss, app, __fmaf_rn(cc, aqq, -cs2apq));
  o[K] = __fmaf_rn(cs, __fsub_rn(aqq, app), __fmul_rn(__fsub_rn(cc, ss), apq));
  o[Q] = __fmaf_rn(c, akp, __fmul_rn(s, akq));
  o[P] = __fmaf_rn(c, akq, -__fmul_rn(s, akp));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vp = V[i][P], vq = V[i][Q];
    V[i][P] = __fmaf_rn(c, vp, __fmul_rn(s, vq));
    V[i][Q] = __fmaf_rn(c, vq, -__fmul_rn(s, vp));
  }
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return __fmaf_rn(a0, b0, __fmaf_rn(a1, b1, __fmul_rn(a2, b2)));
}

__device__ __forceinline__ float norm2_col(const float (&M)[3][3], int j) {
  return dot3(M[0][j], M[1][j], M[2][j], M[0][j], M[1][j], M[2][j]);
}

// Columns I and J of B and V swap, the moved one negated, where |b_I| < |b_J|.
template <int I, int J>
__device__ __forceinline__ void cond_swap(float (&B)[3][3], float (&V)[3][3], float (&n)[3]) {
  const bool swap = n[I] < n[J];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float bi = B[r][I], bj = B[r][J];
    B[r][I] = swap ? bj : bi;
    B[r][J] = swap ? -bi : bj;
    const float vi = V[r][I], vj = V[r][J];
    V[r][I] = swap ? vj : vi;
    V[r][J] = swap ? -vi : vj;
  }
  const float ni = n[I], nj = n[J];
  n[I] = swap ? nj : ni;
  n[J] = swap ? ni : nj;
}

__global__ void __launch_bounds__(kThreads)
svd3_kernel(const float* __restrict__ A_in, float* __restrict__ U_out,
            float* __restrict__ s_out, float* __restrict__ V_out, int batch, int sweeps) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  // The f32 constants of the JAX package (3 + 2 sqrt 2, cos pi/8 and
  // sin pi/8 evaluated in f32, ops/svd3.py:26-28), bit for bit, and the
  // rotation they give where the angle test fails.
  const float gamma = 5.828427314758301f;
  const float cos_pi8 = 0.9238795042037964f;
  const float sin_pi8 = 0.3826834559440613f;
  const float cn = __fmul_rn(cos_pi8, cos_pi8), sn = __fmul_rn(sin_pi8, sin_pi8);
  const float nrm_small = __fadd_rn(cn, sn);
  const float c_small = __fdiv_rn(__fsub_rn(cn, sn), nrm_small);
  const float s_small = __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, cos_pi8), sin_pi8), nrm_small);

  float A[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = A_in[(size_t)b * 9 + i * 3 + j];

  float d[3], o[3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d[i] = dot3(A[0][i], A[1][i], A[2][i], A[0][i], A[1][i], A[2][i]);
#pragma unroll
    for (int j = 0; j < 3; ++j) V[i][j] = (i == j) ? 1.0f : 0.0f;
  }
  o[0] = dot3(A[0][1], A[1][1], A[2][1], A[0][2], A[1][2], A[2][2]);  // S[1][2]
  o[1] = dot3(A[0][0], A[1][0], A[2][0], A[0][2], A[1][2], A[2][2]);  // S[0][2]
  o[2] = dot3(A[0][0], A[1][0], A[2][0], A[0][1], A[1][1], A[2][1]);  // S[0][1]

  for (int k = 0; k < sweeps; ++k) {
    jacobi<0, 1>(d, o, V, gamma, c_small, s_small);
    jacobi<0, 2>(d, o, V, gamma, c_small, s_small);
    jacobi<1, 2>(d, o, V, gamma, c_small, s_small);
  }

  float B[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) B[i][j] = dot3(A[i][0], A[i][1], A[i][2], V[0][j], V[1][j], V[2][j]);

  float n[3] = {norm2_col(B, 0), norm2_col(B, 1), norm2_col(B, 2)};
  cond_swap<0, 1>(B, V, n);
  cond_swap<0, 2>(B, V, n);
  cond_swap<1, 2>(B, V, n);

  // The U rebuild.
  const float s0 = __fsqrt_rn(n[0]);
  const float s1 = __fsqrt_rn(n[1]);
  const float inv0 = rsqrtf(fmaxf(n[0], kEps * kEps));  // 1 / max(s0, eps)
  const bool big0 = s0 > 1e-8f;
  const float u0[3] = {big0 ? __fmul_rn(B[0][0], inv0) : 1.0f,
                       big0 ? __fmul_rn(B[1][0], inv0) : 0.0f,
                       big0 ? __fmul_rn(B[2][0], inv0) : 0.0f};

  const float dot10 = dot3(B[0][1], B[1][1], B[2][1], u0[0], u0[1], u0[2]);
  float b1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) b1[k] = __fmaf_rn(-dot10, u0[k], B[k][1]);
  const float b1n2 = dot3(b1[0], b1[1], b1[2], b1[0], b1[1], b1[2]);
  const bool bigb1 = __fsqrt_rn(b1n2) > 1e-8f;
  const float invb1 = rsqrtf(fmaxf(b1n2, kEps * kEps));  // 1 / max(|b1|, eps)
  const float ax0 = fabsf(u0[0]), ax1 = fabsf(u0[1]), ax2 = fabsf(u0[2]);
  const bool pick0 = (ax0 <= ax1) && (ax0 <= ax2);
  const bool pick1 = !pick0 && (ax1 <= ax2);
  // u0 x e for the least-aligned axis e.
  const float alt[3] = {pick0 ? 0.0f : (pick1 ? -u0[2] : u0[1]),
                        pick0 ? u0[2] : (pick1 ? 0.0f : -u0[0]),
                        pick0 ? -u0[1] : (pick1 ? u0[0] : 0.0f)};
  const float inv_alt = rsqrtf(fmaxf(dot3(alt[0], alt[1], alt[2], alt[0], alt[1], alt[2]), kEps * kEps));
  float u1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) u1[k] = bigb1 ? __fmul_rn(b1[k], invb1) : __fmul_rn(alt[k], inv_alt);

  const float u2[3] = {__fmaf_rn(u0[1], u1[2], -__fmul_rn(u0[2], u1[1])),
                       __fmaf_rn(u0[2], u1[0], -__fmul_rn(u0[0], u1[2])),
                       __fmaf_rn(u0[0], u1[1], -__fmul_rn(u0[1], u1[0]))};
  const float s2 = dot3(B[0][2], B[1][2], B[2][2], u2[0], u2[1], u2[2]);

  // The stores.
  float* U = U_out + (size_t)b * 9;
  float* Vo = V_out + (size_t)b * 9;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[i * 3 + 0] = u0[i];
    U[i * 3 + 1] = u1[i];
    U[i * 3 + 2] = u2[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) Vo[i * 3 + j] = V[i][j];
  }
  s_out[(size_t)b * 3 + 0] = s0;
  s_out[(size_t)b * 3 + 1] = s1;
  s_out[(size_t)b * 3 + 2] = s2;
}

}  // namespace

extern "C" int svd3(const void* A, void* U, void* s, void* V, int batch, int sweeps,
                    void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  svd3_kernel<<<(batch + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)A, (float*)U, (float*)s, (float*)V, batch, sweeps);
  return (int)cudaGetLastError();
}
