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
// 1.97 MB out, 0.73 us at 3.35 TB/s. conv1b is 98% of the operations.
//
// Design, and what each part does about the bound:
// - conv1b is an implicit GEMM on the tensor cores: M = the tile's 8 x 32
//   conv1b pixels, N = 64 output channels, K = 9 taps x 64 input channels
//   = 576, 18 k-steps of 32, with mma.sync m16n8k32 s8 x s8 -> s32 (exact
//   int32 sums, so the requant sees the same integers as the layered path).
//   The A operand is read by ldmatrix straight from the conv1a window that
//   the block keeps in shared memory as [pixel][64 ch] int8: a tap's shift
//   is an address offset per row, no im2col is built. The pixel stride is
//   80 bytes (64 + 16 of pad), so the 8 rows of an ldmatrix phase, 8
//   neighbouring pixels, fall on 8 distinct groups of 4 banks.
// - The weights are laid out once, at load time, in mma B-fragment order
//   ([k-step][n-pair][lane][16 bytes], `stem_weights` in ops/kernels/stem.py):
//   a warp reads a k-step's B fragments for all 64 channels as four
//   conflict-free 16-byte loads a lane. The grid is persistent (as many
//   blocks as fit on the card, each looping over (stream, tile)), so each
//   block copies the 36 KB of conv1b weights into shared memory once.
// - While a tile computes, the next tile's f32 input window (12 x 36 with
//   the 2-px halo) comes in by cp.async into the other of two buffers;
//   outside the image the copy zero-fills, and 0 quantizes to 0.
// - Epilogue in registers: an m16 tile is 8 columns of two neighbouring
//   rows, so a lane's accumulator rows g and g + 8 are vertical neighbours
//   and the horizontal neighbour is one __shfl_xor_sync(4) away. The
//   requant is monotone in the sum (nondecreasing for m2 >= 0, and the sums
//   are bit-flipped to pool the minimum when m2 < 0), so the 2x2 max is
//   taken on the int32 sums and one requant is done per pooled value,
//   which is exactly the max of the four requantized values. A 4 x 4 word
//   transpose across the 4 lanes of a row group (4 shuffles) gives each
//   lane 16 contiguous channels, stored as one 16-byte write.
// - conv1a (1.5% of the operations) and the quantize stay on the CUDA
//   cores: conv1a as 3 __dp4a a channel on the 9 taps packed into words,
//   16 channels a work item, with a requant that uses no conversion
//   instruction (int -> f32 and rint by the 1.5 * 2^23 magic number, exact
//   for |sum| < 2^22; conv1a's sums are below 9 * 128 * 128).
// - mma.sync rather than wgmma: wgmma would need A in its m64 warpgroup
//   register layout per tap and B behind shared-memory matrix descriptors,
//   and its higher rate could only shorten the tensor-core part. Measured
//   on an H100 (tools/torch_kernel_breakdown.py, PERF.md), the mma.sync
//   phase is ~35% of the kernel's time at 16 streams and the CUDA-core
//   work (conv1a ~31%; quantize, staging and the epilogue the rest) ~65%.
// Tiles: 8 x 32 conv1b pixels a block step, 8 warps each owning 2 x 16
// pixels (two m16 tiles) for all 64 channels; H and W need only be even:
// pixels past the image are computed from zero windows and not stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                       // channels of conv1a and conv1b
constexpr int kTaps = 9;
constexpr int kKSteps = kTaps * kC / 32;     // 18 k-steps of 32
constexpr int kTH = 8, kTW = 32;             // conv1b (pre-pool) tile of a block step
constexpr int kAH = kTH + 2, kAW = kTW + 2;  // conv1a window, 1-px halo
constexpr int kIH = kTH + 4, kIW = kTW + 4;  // input window, 2-px halo
constexpr int kAPix = kAH * kAW;
constexpr int kIPix = kIH * kIW;
constexpr int kPixBytes = 80;                // 64 channels + 16 bytes of pad
constexpr int kThreads = 256;
constexpr int kItems = kAPix * (kC / 16);    // conv1a work items: (pixel, 16 channels)
constexpr int kW1bVecs = kKSteps * 4 * 32;   // uint4 of B fragments

constexpr int kOffW1b = 0;
constexpr int kOffW1a = kOffW1b + kW1bVecs * 16;  // int4 {taps 0-3, taps 4-7, tap 8, b1} per channel
constexpr int kOffB2 = kOffW1a + kC * 16;
constexpr int kOffA = kOffB2 + kC * 4;
constexpr int kOffImg = kOffA + kAPix * kPixBytes;  // 2 x f32 input windows
constexpr int kOffX = kOffImg + 2 * kIPix * 4;      // int8 quantized window
constexpr int kSmemBytes = (kOffX + kIPix + 15) / 16 * 16;
static_assert(kOffA % 16 == 0 && kOffImg % 16 == 0, "16-byte aligned regions");

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMagicI = 0x4B400000;  // bit pattern of 1.5 * 2^23
constexpr float kMagicF = 12582912.0f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The low bytes of four ints, packed into one word (a in byte 0).
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// clip(rint(y), 0, 127) for f32 y, in the low byte of the result (rint and
// the clip commute, the bounds being integers): y clipped to [0, 127] plus
// 1.5 * 2^23 rounds to the nearest integer, ties to even, in the mantissa.
__device__ __forceinline__ int round_clip(float y) {
  return __float_as_int(__fadd_rn(fminf(fmaxf(y, 0.0f), 127.0f), kMagicF));
}

// requant of an int32 sum carried as sum + kMagicI (|sum| < 2^22): the f32
// value of the sum is exact without a conversion instruction.
__device__ __forceinline__ int requant_magic(int acc_m, float b, float m) {
  const float f = __fsub_rn(__int_as_float(acc_m), kMagicF);
  return round_clip(__fmul_rn(__fadd_rn(f, b), m));
}

__device__ __forceinline__ int requant(int acc, float b, float m) {
  return round_clip(__fmul_rn(__fadd_rn(__int2float_rn(acc), b), m));
}

__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const float* __restrict__ images, const int* __restrict__ w1a_g,
            const uint4* __restrict__ w1b_g, const float* __restrict__ s_in_p,
            const float* __restrict__ b1_g, const float* __restrict__ m1_p,
            const float* __restrict__ b2_g, const float* __restrict__ m2_p,
            int8_t* __restrict__ out, int S, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* s_w1b = reinterpret_cast<uint4*>(smem + kOffW1b);
  int4* s_w1a = reinterpret_cast<int4*>(smem + kOffW1a);
  float* s_b2 = reinterpret_cast<float*>(smem + kOffB2);
  unsigned char* s_a = smem + kOffA;  // [10][34] pixels x 80 bytes of conv1a
  float* s_img = reinterpret_cast<float*>(smem + kOffImg);
  int8_t* s_x = reinterpret_cast<int8_t*>(smem + kOffX);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const int per_img = tiles_x * tiles_y, n_tiles = S * per_img;
  const int Ho = H / 2, Wo = W / 2;
  const float s_in = *s_in_p, m1 = *m1_p, m2 = *m2_p;

  // Input window index (i, j) is image pixel (r0 - 2 + i, c0 - 2 + j).
  auto prefetch = [&](int t, int buf) {
    const int rem = t % per_img;
    const int r0 = (rem / tiles_x) * kTH, c0 = (rem % tiles_x) * kTW;
    const float* img = images + (size_t)(t / per_img) * H * W;
    const uint32_t dst = smem_addr(s_img + buf * kIPix);
    for (int i = tid; i < kIPix; i += kThreads) {
      const int r = r0 - 2 + i / kIW, c = c0 - 2 + i % kIW;
      const bool in = r >= 0 && r < H && c >= 0 && c < W;
      cp_async4(dst + 4 * i, in ? img + (size_t)r * W + c : images, in);
    }
  };
  prefetch(blockIdx.x, 0);
  cp_async_commit();

  for (int i = tid; i < kW1bVecs; i += kThreads) s_w1b[i] = w1b_g[i];
  if (tid < kC) {
    uint32_t p[3] = {0u, 0u, 0u};
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
      p[t / 4] |= (uint32_t)(w1a_g[t * kC + tid] & 0xff) << (8 * (t % 4));
    s_w1a[tid] = make_int4((int)p[0], (int)p[1], (int)p[2], __float_as_int(b1_g[tid]));
    s_b2[tid] = b2_g[tid];
  }

  // conv1b: warp w owns tile rows wy, wy + 1 and columns wx .. wx + 15 as
  // two m16 tiles (rows 0-7 of an m16 tile: row wy, columns +0..7; rows
  // 8-15: row wy + 1). Output (y, x) with tap (u, v) reads conv1a window
  // pixel (y + u, x + v). ldmatrix lanes 0-7 / 8-15 / 16-23 / 24-31 give
  // the rows of the four 8 x 16-byte matrices: (row wy, k 0-15), (row
  // wy + 1, k 0-15), (row wy, k 16-31), (row wy + 1, k 16-31).
  const int g = lane >> 2, tig = lane & 3;
  const int wy = (warp >> 1) * 2, wx = (warp & 1) * 16;
  const uint32_t a_base = smem_addr(s_a) +
                          ((wy + ((lane >> 3) & 1)) * kAW + wx + (lane & 7)) * kPixBytes +
                          (lane >> 4) * 16;
  const int flip = m2 < 0.0f ? -1 : 0;  // requant nonincreasing: pool the minimum sum

  int buf = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, buf ^= 1) {
    if (t + (int)gridDim.x < n_tiles) prefetch(t + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this tile's input window (and, first time, the weights) is in
    const int s = t / per_img, rem = t % per_img;
    const int r0 = (rem / tiles_x) * kTH, c0 = (rem % tiles_x) * kTW;

    const float* win = s_img + buf * kIPix;
    for (int i = tid; i < kIPix; i += kThreads) {
      const float v = rintf(__fdiv_rn(win[i], s_in));
      s_x[i] = (int8_t)(int)fminf(fmaxf(v, -128.0f), 127.0f);
    }
    __syncthreads();

    // conv1a: item = (channel quarter cq, window pixel p); window pixel
    // (ai, aj) is image pixel (r0 - 1 + ai, c0 - 1 + aj). Taps 3u + v packed
    // as bytes: taps 0-3, 4-7 and 8, as the weights in s_w1a.
    for (int item = tid; item < kItems; item += kThreads) {
      const int cq = item / kAPix, p = item - cq * kAPix;
      const int ai = p / kAW, aj = p - ai * kAW;
      const int r = r0 - 1 + ai, c = c0 - 1 + aj;
      uint4 word = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0 && r < H && c >= 0 && c < W) {
        const int8_t* xp = s_x + ai * kIW + aj;
        const int x0 = (int)pack4(xp[0], xp[1], xp[2], xp[kIW]);
        const int x1 = (int)pack4(xp[kIW + 1], xp[kIW + 2], xp[2 * kIW], xp[2 * kIW + 1]);
        const int x2 = (int)(uint8_t)xp[2 * kIW + 2];
        int q[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int4 w = s_w1a[cq * 16 + k];
          const int acc = __dp4a(x0, w.x, __dp4a(x1, w.y, __dp4a(x2, w.z, kMagicI)));
          q[k] = requant_magic(acc, __int_as_float(w.w), m1);
        }
        word = make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                          pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
      }
      *reinterpret_cast<uint4*>(s_a + p * kPixBytes + cq * 16) = word;
    }
    __syncthreads();

    int acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int tap = ks >> 1;
      const uint32_t off = ((tap / 3) * kAW + tap % 3) * kPixBytes + (ks & 1) * 32;
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a_base + off, a0);
      ldmatrix_x4(a_base + off + 8 * kPixBytes, a1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // n-tiles 2q and 2q + 1: {b0, b1} of each
        const uint4 b = s_w1b[(ks * 4 + q) * 32 + lane];
        mma_s8(acc[0][2 * q], a0, b.x, b.y);
        mma_s8(acc[1][2 * q], a1, b.x, b.y);
        mma_s8(acc[0][2 * q + 1], a0, b.z, b.w);
        mma_s8(acc[1][2 * q + 1], a1, b.z, b.w);
      }
    }

    // Epilogue: lane (g, tig) holds, per n-tile j, channels 8j + 2tig + {0, 1}
    // of pixel (wy, x) in accumulators 0-1 and of (wy + 1, x) in 2-3, with
    // x = wx + 8mt + g; lane g ^ 1 holds column x ^ 1.
    const int oy = (r0 + wy) >> 1;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t wv[4];  // word k: channels 16k + 2tig + {0, 1}, 16k + 8 + 2tig + {0, 1}
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int v0 = max(acc[mt][j][0] ^ flip, acc[mt][j][2] ^ flip);
        int v1 = max(acc[mt][j][1] ^ flip, acc[mt][j][3] ^ flip);
        v0 = max(v0, __shfl_xor_sync(kFull, v0, 4));
        v1 = max(v1, __shfl_xor_sync(kFull, v1, 4));
        const int ch = 8 * j + 2 * tig;
        const uint32_t pair = __byte_perm(requant(v0 ^ flip, s_b2[ch], m2),
                                          requant(v1 ^ flip, s_b2[ch + 1], m2), 0x0040);
        wv[j >> 1] = (j & 1) ? __byte_perm(wv[j >> 1], pair, 0x5410) : pair;
      }
      // 4 x 4 transpose of the words across the lanes tig = 0..3: lane tig
      // ends with word tig of every lane, wv[k] coming from lane k.
      const bool hi2 = tig & 2, hi1 = tig & 1;
      uint32_t x0 = hi2 ? wv[0] : wv[2], x1 = hi2 ? wv[1] : wv[3];
      x0 = __shfl_xor_sync(kFull, x0, 2);
      x1 = __shfl_xor_sync(kFull, x1, 2);
      if (hi2) { wv[0] = x0; wv[1] = x1; } else { wv[2] = x0; wv[3] = x1; }
      x0 = hi1 ? wv[0] : wv[1];
      x1 = hi1 ? wv[2] : wv[3];
      x0 = __shfl_xor_sync(kFull, x0, 1);
      x1 = __shfl_xor_sync(kFull, x1, 1);
      if (hi1) { wv[0] = x0; wv[2] = x1; } else { wv[1] = x0; wv[3] = x1; }
      // wv[k] holds channels 16tig + 2k + {0, 1} (bytes 0-1) and 16tig + 8 + 2k + {0, 1}.
      const int ox = (c0 + wx + 8 * mt + g) >> 1;
      if (!(g & 1) && oy < Ho && ox < Wo) {
        const uint4 o = make_uint4(__byte_perm(wv[0], wv[1], 0x5410), __byte_perm(wv[2], wv[3], 0x5410),
                                   __byte_perm(wv[0], wv[1], 0x7632), __byte_perm(wv[2], wv[3], 0x7632));
        *reinterpret_cast<uint4*>(out + (((size_t)s * Ho + oy) * Wo + ox) * kC + 16 * tig) = o;
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
  // The persistent grid's size (blocks that fit at once), found once per device.
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSmemBytes)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel, kThreads,
                                                             kSmemBytes)) != cudaSuccess)
      return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const long long tiles = (long long)S * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  const int grid = (int)(tiles < resident[dev] ? tiles : resident[dev]);
  stem_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)images, (const int*)w1a, (const uint4*)w1b, (const float*)s_in,
      (const float*)b1, (const float*)m1, (const float*)b2, (const float*)m2,
      (int8_t*)out, S, H, W);
  return (int)cudaGetLastError();
}
