// Pose-only damped Gauss-Newton PnP, every iteration in one launch, for a
// batch of poses.
//
// Replaces no TPU kernel. The JAX package runs this loop as jnp under jit
// (maveric_slam_tpu/geometry/pnp.py refine_pose), where XLA fuses it; the
// port's plain version (ops/kernels/refine_pose.py refine_pose_plain) runs
// it as eager PyTorch, ~300 launches an iteration (the unrolled 6x6
// Cholesky and its substitutions alone are one small op per scalar entry),
// ~2450 a call. That made it the largest host cost of the tracking step.
//
// Per pose (R, t), with K's fx, fy, cx, cy and N factors (X_i, z_i, m_i):
//   `iterations` times:
//     p = R X_i + t; zc = max(p_z, 1e-6); r_i = (fx p_x / zc + cx,
//     fy p_y / zc + cy) - z_i; w_i = huber(|r_i|, delta) * m_i;
//     J_i = dpi(p) [I | -[p]_x] (2x6);
//     H = sum w_i J_i^T J_i + damping I;  b = -sum w_i J_i^T r_i;
//     xi = chol_solve(H, b) (pivots sqrt(max(s, 1e-30)));
//     (dR, dt) = se3_exp(xi);  R <- dR R;  t <- dR t + dt
//   then cost = sum w_i |r_i|^2 at the final pose, num_used = sum m_i.
// The arithmetic is the plain version's, in float32, with its clamps and
// se3_exp's branches and constants (ops/lie.py). A clamp is written as a
// comparison that passes NaN through, as torch.clamp does (fmaxf would
// replace it). The sums run in another order than the plain version's
// batched products, so the two agree to rounding, not bit for bit.
//
// Bound on this card: neither bytes nor operations. The main path's call
// is S = 16 poses of N = 100 factors (~34 KB in, ~1 KB out: ~0.01 us at
// 3.35 TB/s; ~3.1 MFLOP over 8 iterations: ~0.05 us at 67 TFLOP/s). What
// the kernel takes is the latency of its chain: a block-wide reduction and
// a serial 6x6 solve per iteration. Design, against that chain: one block
// of 128 threads a pose, so the poses of a call run side by side on
// separate SMs; thread k takes factors k, k + 128, ..., and keeps the
// first kCached of them in registers for every iteration (X, z and the
// mask are read from memory once; past 128 x kCached factors the rest are
// reread, from L1/L2, each iteration). The 27 sums (H's upper triangle, b)
// are reduced by warp shuffles in a fixed tree and the four warps'
// partials added in a fixed order, with no atomics, so a pose's result is
// bitwise the same on every run and whatever batch it is in. Thread 0 then
// solves and updates R and t in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCached = 4;  // factors a thread keeps in registers
constexpr int kSums = 27;   // 21 entries of H's upper triangle, then 6 of b
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

struct Camera {
  float fx, fy, cx, cy;
};

struct Factor {
  float X0, X1, X2, z0, z1, m;
};

// Residual r, Huber weight (times the mask) and, when `jac`, the 2x6
// Jacobian rows J0, J1 of one factor at pose (R, t), in the plain
// version's operation order (geometry/projection.py).
template <bool jac>
__device__ __forceinline__ void residual(const float* R, const float* t, const Camera& c,
                                         const Factor& f, float huber_delta, float& r0,
                                         float& r1, float& w, float* J0, float* J1) {
  const float p0 = f.X0 * R[0] + f.X1 * R[1] + f.X2 * R[2] + t[0];
  const float p1 = f.X0 * R[3] + f.X1 * R[4] + f.X2 * R[5] + t[1];
  const float p2 = f.X0 * R[6] + f.X1 * R[7] + f.X2 * R[8] + t[2];
  const float zc = clamp_min(p2, 1e-6f);
  r0 = (c.fx * p0) / zc + c.cx - f.z0;
  r1 = (c.fy * p1) / zc + c.cy - f.z1;
  const float norm = sqrtf(r0 * r0 + r1 * r1);
  w = (norm <= huber_delta ? 1.0f : huber_delta / clamp_min(norm, 1e-12f)) * f.m;
  if (jac) {
    const float inv_z = 1.0f / zc;
    const float dpi[2][3] = {{c.fx * inv_z, 0.0f, -c.fx * p0 * inv_z * inv_z},
                             {0.0f, c.fy * inv_z, -c.fy * p1 * inv_z * inv_z}};
    const float dp[3][6] = {{1.0f, 0.0f, 0.0f, -0.0f, p2, -p1},
                            {0.0f, 1.0f, 0.0f, -p2, -0.0f, p0},
                            {0.0f, 0.0f, 1.0f, p1, -p0, -0.0f}};  // [I | -[p]_x]
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      J0[k] = dpi[0][0] * dp[0][k] + dpi[0][1] * dp[1][k] + dpi[0][2] * dp[2][k];
      J1[k] = dpi[1][0] * dp[0][k] + dpi[1][1] * dp[1][k] + dpi[1][2] * dp[2][k];
    }
  }
}

__device__ __forceinline__ void accumulate(const float* R, const float* t, const Camera& c,
                                           const Factor& f, float huber_delta, float* acc) {
  float r0, r1, w, J0[6], J1[6];
  residual<true>(R, t, c, f, huber_delta, r0, r1, w, J0, J1);
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float wJ0 = J0[i] * w, wJ1 = J1[i] * w;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += wJ0 * J0[j] + wJ1 * J1[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += J0[i] * w * r0 + J1[i] * w * r1;
}

__device__ __forceinline__ Factor load_factor(const float* X, const float* z, const bool* mask,
                                              int i) {
  return {X[3 * i], X[3 * i + 1], X[3 * i + 2], z[2 * i], z[2 * i + 1], mask[i] ? 1.0f : 0.0f};
}

// Sum `v` over the block: a shuffle tree in each warp, then the warps'
// partials in order. The result is valid in thread 0 only. `slot` is this
// value's column of `red`; the caller synchronises before reading.
__device__ __forceinline__ void warp_sum_to(float v, float (*red)[kSums], int slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][slot] = v;
}

__device__ __forceinline__ float block_total(const float (*red)[kSums], int slot) {
  float s = red[0][slot];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = s + red[w][slot];
  return s;
}

// H (upper triangle, row by row) + damping I and b -> the solve of
// chol(H) chol(H)^T xi = b, in cholesky_small / cholesky_solve_small's
// order (ops/linalg.py).
__device__ void solve6(const float* sums, float damping, float* xi) {
  float A[6][6], L[6][6], b[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = sums[k++];
      A[j][i] = A[i][j];
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = A[i][i] + damping;
    b[i] = -sums[21 + i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) s = s - L[i][m] * L[j][m];
      L[i][j] = (i == j) ? sqrtf(clamp_min(s, 1e-30f)) : s / L[j][j];
    }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int m = 0; m < i; ++m) s = s - L[i][m] * y[m];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s = s - L[m][i] * xi[m];
    xi[i] = s / L[i][i];
  }
}

// se3_exp (ops/lie.py): xi = (rho, omega) -> dR = so3_exp(omega),
// dt = J_l(omega) rho; then R <- dR R, t <- dR t + dt.
__device__ void apply_update(const float* xi, float* R, float* t) {
  const float o0 = xi[3], o1 = xi[4], o2 = xi[5];
  const float theta2 = o0 * o0 + o1 * o1 + o2 * o2;
  const float theta = sqrtf(clamp_min(theta2, 1e-8f));
  const bool small = theta2 < 1e-8f;
  const float sn = sinf(theta), cs = cosf(theta);
  const float a = small ? 1.0f - theta2 / 6.0f : sn / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cs) / theta2;
  const float c = small ? (float)(1.0 / 6.0) - theta2 / 120.0f : (theta - sn) / (theta2 * theta);
  const float W[3][3] = {{0.0f, -o2, o1}, {o2, 0.0f, -o0}, {-o1, o0, 0.0f}};
  float W2[3][3], dR[3][3], Jl[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      dR[i][j] = e + a * W[i][j] + b * W2[i][j];
      Jl[i][j] = e + b * W[i][j] + c * W2[i][j];
    }
  float Rn[9], tn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Rn[3 * i + j] = dR[i][0] * R[j] + dR[i][1] * R[3 + j] + dR[i][2] * R[6 + j];
    const float dt = Jl[i][0] * xi[0] + Jl[i][1] * xi[1] + Jl[i][2] * xi[2];
    tn[i] = dR[i][0] * t[0] + dR[i][1] * t[1] + dR[i][2] * t[2] + dt;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = tn[k];
}

__global__ void __launch_bounds__(kThreads)
refine_pose_kernel(const float* __restrict__ K, const float* __restrict__ R0,
                   const float* __restrict__ t0, const float* __restrict__ X,
                   const float* __restrict__ z, const bool* __restrict__ mask, int n,
                   float huber_delta, float damping, int iterations, float* __restrict__ R_out,
                   float* __restrict__ t_out, float* __restrict__ cost_out,
                   int* __restrict__ used_out) {
  __shared__ float pose[12];  // R row-major, then t
  __shared__ float red[kWarps][kSums];
  const int tid = threadIdx.x;
  const size_t s = blockIdx.x;
  X += s * n * 3;
  z += s * n * 2;
  mask += s * n;
  if (tid < 9) pose[tid] = R0[s * 9 + tid];
  else if (tid < 12) pose[tid] = t0[s * 3 + tid - 9];
  const Camera cam{K[0], K[4], K[2], K[5]};

  Factor cached[kCached];
#pragma unroll
  for (int k = 0; k < kCached; ++k) {
    const int i = tid + k * kThreads;
    cached[k] = i < n ? load_factor(X, z, mask, i) : Factor{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  }
  __syncthreads();

#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = pose[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < kCached; ++k)
      if (tid + k * kThreads < n) accumulate(R, t, cam, cached[k], huber_delta, acc);
    for (int i = tid + kCached * kThreads; i < n; i += kThreads)
      accumulate(R, t, cam, load_factor(X, z, mask, i), huber_delta, acc);
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sum_to(acc[k], red, k);
    __syncthreads();
    if (tid == 0) {
      float sums[kSums], xi[6];
      for (int k = 0; k < kSums; ++k) sums[k] = block_total(red, k);
      solve6(sums, damping, xi);
      apply_update(xi, pose, pose + 9);
    }
    __syncthreads();
  }

  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];
  float cost = 0.0f, used = 0.0f;
  for (int i = tid; i < n; i += kThreads) {
    const Factor f = load_factor(X, z, mask, i);
    float r0, r1, w;
    residual<false>(R, t, cam, f, huber_delta, r0, r1, w, nullptr, nullptr);
    cost += w * (r0 * r0 + r1 * r1);
    used += f.m;
  }
  warp_sum_to(cost, red, 0);
  warp_sum_to(used, red, 1);
  __syncthreads();
  if (tid < 9) R_out[s * 9 + tid] = R[tid];
  else if (tid < 12) t_out[s * 3 + tid - 9] = t[tid - 9];
  if (tid == 0) {
    cost_out[s] = block_total(red, 0);
    used_out[s] = (int)block_total(red, 1);
  }
}

}  // namespace

extern "C" int refine_pose(const void* K, const void* R0, const void* t0, const void* X,
                           const void* z, const void* mask, int batch, int n, float huber_delta,
                           float damping, int iterations, void* R, void* t, void* cost,
                           void* num_used, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  refine_pose_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)K, (const float*)R0, (const float*)t0, (const float*)X, (const float*)z,
      (const bool*)mask, n, huber_delta, damping, iterations, (float*)R, (float*)t, (float*)cost,
      (int*)num_used);
  return (int)cudaGetLastError();
}
