// Fused SuperPoint stage 1: quantize -> conv1a 3x3 1->64 + requant ->
// conv1b 3x3 64->64 SAME + requant -> 2x2 max-pool, int8 NHWC out.
//
// Replaces: maveric_slam_tpu/ops/pallas_kernels.py fused_stem (:737-784),
// with _fused_stem_impl (:626-733), pallas_call :711, kernel
// _stem_pair_kernel (:500-590) and weights _stem_pair_weights (:593-616).
// The TPU layout (column pairs in 128 lanes, bf16 carriers, block-structured
// paired weights, halo DMA double buffer) is not carried over; the contract is.
//
// Contract, per stream s of S and image pixel (r, c) of H x W (H, W even):
//   x    = clip(rint(img / s_in), -128, 127), 0 outside the image;
//   a    = clip(rint((sum_{u,v} x[r-1+u][c-1+v] w1a[u][v][o] + b1[o]) * m1), 0, 127)
//          inside the image, and literally 0 outside it (conv1b's SAME
//          padding; the `inside` mask of pallas_kernels.py:698-703);
//   y    = clip(rint((sum_{u,v,i} a[r-1+u][c-1+v][i] w1b[u][v][i][o] + b2[o]) * m2), 0, 127);
//   out[s][r/2][c/2][o] = max of y over the 2x2 window.
// Sums are exact in int32; the requant is f32 `(float(acc) + b) * m`, one
// rounding each, then rint (round-half-even, as torch.round/jnp.round).
// So the result equals the layered path bit for bit. The division is IEEE
// (__fdiv_rn), and -fmad=false keeps the add and multiply apart.
//
// Bound on this card at (1, 192, 640): operations. conv1a + conv1b are
// 2 * 122,880 * 64 * (9 + 576) = 9.2e9 int8 operations, 4.7 us at the
// 1,979 TOP/s of the int8 tensor cores; the bytes are 0.49 MB in and
// 1.97 MB out, 0.73 us at 3.35 TB/s. This first design runs on the CUDA
// cores with __dp4a, far below the tensor-core rate (mma/wgmma
// s8*s8->s32 is a later change). What it does about the bound: nothing of
// stage 1 touches device memory except the f32 image and the pooled int8
// output (the layered path writes and reads a 576-wide im2col of conv1b).
//
// Design: one block of 8 warps per (stream, 8-row band, 32-column tile) of
// conv1b outputs. The block quantizes a 12 x 36 input window (2-px halo)
// into shared memory, computes conv1a for the 10 x 34 window (1-px halo)
// into shared memory as int8 packed by four channels, then each warp takes
// 4 x 4-pixel tiles of conv1b with lane l owning output channels l and
// l + 32: per group of four input channels it loads the 6 x 6 patch words
// (one shared-memory broadcast each) and its 9 x 2 weight words, and does
// 288 __dp4a. The conv1b weights (36 KB, [tap][in/4][out] words, laid out
// once when the params are loaded) sit in shared memory beside them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                       // channels of conv1a and conv1b
constexpr int kWords = kC / 4;               // int8x4 words per pixel
constexpr int kTaps = 9;
constexpr int kTH = 8, kTW = 32;             // conv1b (pre-pool) tile of a block
constexpr int kAH = kTH + 2, kAW = kTW + 2;  // conv1a window, 1-px halo
constexpr int kIH = kTH + 4, kIW = kTW + 4;  // quantized input window, 2-px halo
constexpr int kSub = 4;                      // a thread's conv1b sub-tile is kSub x kSub
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kSmemW1b = kTaps * kWords * kC;  // int words
constexpr int kSmemW1a = kTaps * kC;           // ints
constexpr int kSmemA = kAH * kAW * kWords;     // int words
constexpr int kSmemX = kIH * kIW;              // ints
constexpr size_t kSmemBytes = sizeof(int) * (kSmemW1b + kSmemW1a + kSmemA + kSmemX) +
                              sizeof(float) * 2 * kC;

__device__ __forceinline__ float requant(float acc, float b, float m) {
  const float q = rintf(__fmul_rn(__fadd_rn(acc, b), m));
  return fminf(fmaxf(q, 0.0f), 127.0f);
}

__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ images, const int* __restrict__ w1a_g,
            const int* __restrict__ w1b_g, const float* __restrict__ s_in_p,
            const float* __restrict__ b1_g, const float* __restrict__ m1_p,
            const float* __restrict__ b2_g, const float* __restrict__ m2_p,
            int8_t* __restrict__ out, int H, int W) {
  extern __shared__ int smem[];
  int* s_w1b = smem;                  // [tap][in/4][out] int8x4 words
  int* s_w1a = s_w1b + kSmemW1b;      // [tap][out]
  int* s_a = s_w1a + kSmemW1a;        // [row][col][in/4] int8x4 words of conv1a
  int* s_x = s_a + kSmemA;            // [row][col] quantized input
  float* s_b1 = reinterpret_cast<float*>(s_x + kSmemX);
  float* s_b2 = s_b1 + kC;

  const int tid = threadIdx.x;
  const int stream = blockIdx.z;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;  // tile origin (image pixels)
  const float* img = images + (size_t)stream * H * W;
  const float s_in = *s_in_p, m1 = *m1_p, m2 = *m2_p;

  for (int i = tid; i < kSmemW1b; i += kThreads) s_w1b[i] = w1b_g[i];
  for (int i = tid; i < kSmemW1a; i += kThreads) s_w1a[i] = w1a_g[i];
  if (tid < kC) {
    s_b1[tid] = b1_g[tid];
    s_b2[tid] = b2_g[tid];
  }
  // Window index (i, j) is image pixel (r0 - 2 + i, c0 - 2 + j).
  for (int i = tid; i < kSmemX; i += kThreads) {
    const int r = r0 - 2 + i / kIW, c = c0 - 2 + i % kIW;
    int q = 0;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      const float v = rintf(__fdiv_rn(img[(size_t)r * W + c], s_in));
      q = (int)fminf(fmaxf(v, -128.0f), 127.0f);
    }
    s_x[i] = q;
  }
  __syncthreads();

  // conv1a: word k of window pixel p = channels 4k..4k+3. Window index
  // (i, j) is image pixel (r0 - 1 + i, c0 - 1 + j).
  for (int i = tid; i < kSmemA; i += kThreads) {
    const int k = i % kWords, p = i / kWords;
    const int ar = p / kAW, ac = p % kAW;
    const int r = r0 - 1 + ar, c = c0 - 1 + ac;
    int word = 0;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const int xv = s_x[(ar + u) * kIW + ac + v];
          const int* w = s_w1a + (u * 3 + v) * kC + 4 * k;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] += xv * w[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = (int)requant((float)acc[j], s_b1[4 * k + j], m1);
        word |= (q & 0xff) << (8 * j);
      }
    }
    s_a[i] = word;
  }
  __syncthreads();

  // conv1b + requant + 2x2 max-pool.
  const int lane = tid & 31, warp = tid >> 5;
  const int o0 = lane, o1 = lane + 32;
  const float bb0 = s_b2[o0], bb1 = s_b2[o1];
  const int Ho = H / 2, Wo = W / 2;
  constexpr int kSubCols = kTW / kSub;
  constexpr int kSubTiles = (kTH / kSub) * kSubCols;
  for (int t = warp; t < kSubTiles; t += kWarps) {
    const int ty = (t / kSubCols) * kSub, tx = (t % kSubCols) * kSub;
    int acc0[kSub][kSub], acc1[kSub][kSub];
#pragma unroll
    for (int y = 0; y < kSub; ++y)
#pragma unroll
      for (int x = 0; x < kSub; ++x) acc0[y][x] = acc1[y][x] = 0;

    for (int k = 0; k < kWords; ++k) {
      int w0[kTaps], w1[kTaps];
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        w0[tap] = s_w1b[(tap * kWords + k) * kC + o0];
        w1[tap] = s_w1b[(tap * kWords + k) * kC + o1];
      }
      // Output (ty+y, tx+x) reads conv1a window (ty+y+u, tx+x+v): patch
      // row pr = y + u, column pc = x + v.
#pragma unroll
      for (int pr = 0; pr < kSub + 2; ++pr) {
        int a[kSub + 2];
#pragma unroll
        for (int pc = 0; pc < kSub + 2; ++pc)
          a[pc] = s_a[((ty + pr) * kAW + tx + pc) * kWords + k];
#pragma unroll
        for (int y = 0; y < kSub; ++y) {
          const int u = pr - y;
          if (u < 0 || u > 2) continue;
#pragma unroll
          for (int x = 0; x < kSub; ++x) {
#pragma unroll
            for (int v = 0; v < 3; ++v) {
              acc0[y][x] = __dp4a(a[x + v], w0[u * 3 + v], acc0[y][x]);
              acc1[y][x] = __dp4a(a[x + v], w1[u * 3 + v], acc1[y][x]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int py = 0; py < kSub / 2; ++py) {
#pragma unroll
      for (int px = 0; px < kSub / 2; ++px) {
        float q0 = 0.0f, q1 = 0.0f;  // every requantized value is >= 0
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            q0 = fmaxf(q0, requant((float)acc0[2 * py + dy][2 * px + dx], bb0, m2));
            q1 = fmaxf(q1, requant((float)acc1[2 * py + dy][2 * px + dx], bb1, m2));
          }
        }
        const int oy = (r0 + ty) / 2 + py, ox = (c0 + tx) / 2 + px;
        if (oy < Ho && ox < Wo) {
          int8_t* o = out + (((size_t)stream * Ho + oy) * Wo + ox) * kC;
          o[o0] = (int8_t)(int)q0;
          o[o1] = (int8_t)(int)q1;
        }
      }
    }
  }
}

}  // namespace

extern "C" int fused_stem(const void* images, const void* w1a, const void* w1b,
                          const void* s_in, const void* b1, const void* m1,
                          const void* b2, const void* m2, void* out, int S, int H,
                          int W, void* stream) {
  if (S <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, S);
  stem_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)images, (const int*)w1a, (const int*)w1b, (const float*)s_in,
      (const float*)b1, (const float*)m1, (const float*)b2, (const float*)m2,
      (int8_t*)out, H, W);
  return (int)cudaGetLastError();
}
