// SuperPoint's int8 layers after the stem (conv2a ... convDb): one
// convolution a launch, int8 NHWC in and out, as an implicit GEMM on the
// int8 tensor cores, with the requant, the ReLU and (conv2b, conv3b) the
// 2x2 max-pool in the epilogue.
//
// Replaces no TPU kernel: the JAX package leaves these layers to XLA's
// convolution (maveric_slam_tpu/models/superpoint.py superpoint_int8). The
// port's plain path carries the int8 values in f32 through F.unfold and one
// f32 matrix product a layer (ops/kernels/qconv.py qconv_plain).
//
// Contract, per stream s of S and pixel (r, c) of the layer's H x W:
//   acc[o]  = sum_{u,v,i} x[s][r-P+u][c-P+v][i] w[o][i][u][v]  (k x k, P = k/2,
//             0 outside the image: SAME padding with zero point 0);
//   y[o]    = clip(rint((float(acc[o]) + bias_q[o]) * m), lo, 127),
//             lo = 0 with the ReLU, -128 without;
//   out     = y, or with `pool` the max of y over each 2x2 window
//             (floor(H/2) x floor(W/2), as F.max_pool2d).
// The sums are exact in int32 (and exact in the plain path's f32 below
// 2^24, which superpoint.int8_accumulator_maxima audits); the requant is an
// IEEE add then an IEEE multiply (__fadd_rn, __fmul_rn; -fmad=false) and
// round-half-even, the plain path's operations in its order. The pool is
// taken on the int32 sums: the requant is monotone (nondecreasing for
// m >= 0; for m < 0 the sums are bit-flipped so that the minimum is pooled),
// so one requant of the pooled sum is the max of the four requants. So the
// result equals the plain path bit for bit.
//
// Bound on this card. The ten layers at (16, 376, 1240) are 704 GOP of
// int8 products: 0.36 ms at 1,979 TOP/s. Their activations are ~0.6 GB of
// int8 NHWC read and written once: 0.18 ms at 3.35 TB/s. Operations bound.
//
// Design, and what each part does about the bound:
// - Implicit GEMM, M = output pixels, N = output channels, K = taps x Cin,
//   with mma.sync m16n8k32 s8 x s8 -> s32. A block stages its tile's input
//   window (the tile plus a 1-pixel halo for 3x3) once in shared memory as
//   [pixel][Cin] int8 at a pixel stride of Cin + 16 bytes, and ldmatrix
//   reads the A fragments straight from it: a tap is an address offset, no
//   im2col exists anywhere. The stride puts the 8 rows of an ldmatrix phase
//   (8 neighbouring pixels) on 8 distinct groups of 4 banks.
// - The weights are packed once at load time (`qconv_weights`) in B-fragment
//   order, [n-group][k-step][n-pair][lane][16 bytes], so a warp reads a
//   k-step's fragments for 16 channels as one conflict-free 16-byte load a
//   lane. The grid is persistent: each block keeps its n-group's weights
//   (at most 144 KB) in shared memory for the whole launch and walks over
//   spatial tiles, the next tile's window coming in by 16-byte cp.async
//   (zero-filled outside the image) into the other of two buffers while
//   the current one computes.
// - A warp owns MT m16 tiles (each 8 columns of two neighbouring rows) by NT
//   n8 tiles. The epilogue works in registers: a lane's accumulator rows g
//   and g + 8 are vertical neighbours, its horizontal neighbour is one
//   __shfl_xor_sync(4) away (the pool); a 4 x 4 word transpose across the
//   four lanes of a row group gives each lane 16 contiguous channels of a
//   pixel, stored as one 16-byte write. convPb's 65 channels (rows of 65
//   bytes) are padded to 80 with zero weights, computed, and stored a byte
//   at a time, the pad never stored.
// - mma.sync rather than wgmma, as in stem.cu: the A operand comes from
//   shifted windows of one staged tile, which ldmatrix reads at any row
//   address, and the layers' shapes (N = 64 ... 256, K = 256 ... 1152) keep
//   every warp busy with 16-32 independent MMAs a k-step.
// Instantiations (Cin, k; MT, NT; warps along M x N; tile rows x columns):
//   conv2a, conv2b (64 -> 64, 3x3):  4, 8; 8 x 1; 16 x 32
//   conv3a (64 -> 128, 3x3):         4, 8; 4 x 2;  8 x 32
//   conv3b ... convDa (128 -> 128 | 256, 3x3): 2, 8; 4 x 2; 8 x 16
//   convPb (256 -> 65, 1x1):         2, 10; 8 x 1; 16 x 16
//   convDb (256 -> 256, 1x1):        4, 8; 4 x 2;  8 x 32
// Tiles need H and W of at least 1 only: pixels past the image are computed
// from zero windows and not stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMagicF = 12582912.0f;  // 1.5 * 2^23

template <int CIN_, int K_, int MT_, int NT_, int WM_, int WN_, int TW_>
struct Cfg {
  static constexpr int CIN = CIN_, K = K_, MT = MT_, NT = NT_, WM = WM_, WN = WN_, TW = TW_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int WX = TW / (8 * MT);  // warps across a tile row
  static constexpr int TH = 2 * WM / WX;    // tile rows
  static constexpr int HALO = K / 2;
  static constexpr int HH = TH + 2 * HALO, HW = TW + 2 * HALO;  // input window
  static constexpr int HPIX = HH * HW;
  static constexpr int PSTRIDE = CIN + 16;  // bytes a pixel in shared memory
  static constexpr int CHUNKS = CIN / 16;   // 16-byte chunks a pixel
  static constexpr int CSTEPS = CIN / 32;   // k-steps a tap
  static constexpr int KSTEPS = K * K * CSTEPS;
  static constexpr int BN = WN * NT * 8;    // channels of a block (an n-group)
  static constexpr int NPB = BN / 16;       // n-pairs of a block
  static constexpr int W_VECS = KSTEPS * NPB * 32;  // uint4 of B fragments
  static constexpr int HALO_BYTES = HPIX * PSTRIDE;
  static constexpr int OFF_B = W_VECS * 16;
  static constexpr int OFF_HALO = OFF_B + BN * 4;
  static constexpr int SMEM = OFF_HALO + 2 * HALO_BYTES;
  static_assert(TW % (8 * MT) == 0 && (2 * WM) % WX == 0, "warps tile the block");
  static_assert(CIN % 32 == 0 && NT % 2 == 0, "k-steps of 32, n-tiles in pairs");
  static_assert(OFF_HALO % 16 == 0 && HALO_BYTES % 16 == 0, "16-byte aligned regions");
  static_assert(SMEM <= 232448, "fits the shared memory of a block");
};

using CfgC64 = Cfg<64, 3, 4, 8, 8, 1, 32>;     // conv2a, conv2b
using CfgC64N128 = Cfg<64, 3, 4, 8, 4, 2, 32>; // conv3a
using CfgC128 = Cfg<128, 3, 2, 8, 4, 2, 16>;   // conv3b, conv4a, conv4b, convPa, convDa
using CfgPb = Cfg<256, 1, 2, 10, 8, 1, 16>;    // convPb
using CfgDb = Cfg<256, 1, 4, 8, 4, 2, 32>;     // convDb

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// clip(rint((float(acc) + b) * m), lo, 127) in the low byte of the result:
// the clipped value plus 1.5 * 2^23 rounds to the nearest integer, ties to
// even, in the mantissa (rint and the clip commute, the bounds being
// integers); the low byte is that integer in two's complement.
__device__ __forceinline__ int requant(int acc, float b, float m, float lo) {
  const float y = __fmul_rn(__fadd_rn(__int2float_rn(acc), b), m);
  return __float_as_int(__fadd_rn(fminf(fmaxf(y, lo), 127.0f), kMagicF));
}

// The low bytes of q0 and q1 as bytes 0 and 1.
__device__ __forceinline__ uint32_t pair2(int q0, int q1) { return __byte_perm(q0, q1, 0x0040); }

// Lane (g, tig) holds wv[k] = the pairs of n-tiles 2k and 2k + 1: channels
// 16k + 2tig + {0, 1} (bytes 0-1) and 16k + 8 + 2tig + {0, 1} (bytes 2-3)
// of one pixel. A 4 x 4 word transpose across the lanes tig = 0..3 leaves
// lane tig channels 16tig .. 16tig + 15 of that pixel, in order.
__device__ __forceinline__ uint4 transpose16(uint32_t (&wv)[4], int tig) {
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
  // wv[k]: channels 16tig + 2k + {0, 1} (bytes 0-1), 16tig + 8 + 2k + {0, 1}.
  return make_uint4(__byte_perm(wv[0], wv[1], 0x5410), __byte_perm(wv[2], wv[3], 0x5410),
                    __byte_perm(wv[0], wv[1], 0x7632), __byte_perm(wv[2], wv[3], 0x7632));
}

template <class C, bool POOL>
__global__ void __launch_bounds__(C::kThreads, 1)
qconv_kernel(const int8_t* __restrict__ in, const uint4* __restrict__ w_g,
             const float* __restrict__ bias_g, const float* __restrict__ m_p,
             int8_t* __restrict__ out, int S, int H, int W, int cout, float lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint4* s_w = reinterpret_cast<const uint4*>(smem);
  float* s_b = reinterpret_cast<float*>(smem + C::OFF_B);
  unsigned char* s_halo = smem + C::OFF_HALO;

  const int n_groups = (cout + C::BN - 1) / C::BN;
  const int ng = blockIdx.x % n_groups;
  const int first = blockIdx.x / n_groups, stride = gridDim.x / n_groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + C::TW - 1) / C::TW, tiles_y = (H + C::TH - 1) / C::TH;
  const int per_img = tiles_x * tiles_y, n_tiles = S * per_img;

  // Window pixel (i, j) of tile t is image pixel (y0 - HALO + i, x0 - HALO + j).
  auto prefetch = [&](int t, int buf) {
    const int rem = t % per_img;
    const int r0 = (rem / tiles_x) * C::TH - C::HALO, c0 = (rem % tiles_x) * C::TW - C::HALO;
    const int8_t* img = in + (size_t)(t / per_img) * H * W * C::CIN;
    const uint32_t dst = smem_addr(s_halo + buf * C::HALO_BYTES);
    for (int i = tid; i < C::HPIX * C::CHUNKS; i += C::kThreads) {
      const int p = i / C::CHUNKS, ch = i % C::CHUNKS;
      const int r = r0 + p / C::HW, c = c0 + p % C::HW;
      const bool ok = r >= 0 && r < H && c >= 0 && c < W;
      cp_async16(dst + p * C::PSTRIDE + ch * 16,
                 ok ? img + ((size_t)r * W + c) * C::CIN + ch * 16 : (const int8_t*)in, ok);
    }
  };
  if (first < n_tiles) prefetch(first, 0);
  {
    const uint32_t dst = smem_addr(smem);
    const uint4* src = w_g + (size_t)ng * C::W_VECS;
    for (int i = tid; i < C::W_VECS; i += C::kThreads) cp_async16(dst + 16 * i, src + i, true);
  }
  cp_async_commit();
  for (int i = tid; i < C::BN; i += C::kThreads) {
    const int ch = ng * C::BN + i;
    s_b[i] = ch < cout ? bias_g[ch] : 0.0f;
  }

  // Warp (wm, wn): tile rows wy, wy + 1, columns wx .. wx + 8MT - 1 as MT m16
  // tiles (rows 0-7 of m16 tile mt: row wy, columns wx + 8mt + 0..7; rows
  // 8-15: row wy + 1), channels wn * 8NT .. of the block's n-group. Output
  // (y, x) at tap (u, v) reads window pixel (y + u, x + v). ldmatrix lanes
  // 0-7 / 8-15 / 16-23 / 24-31 address the rows of the four 8 x 16-byte
  // matrices: (row wy, k 0-15), (row wy + 1, k 0-15), (row wy, k 16-31),
  // (row wy + 1, k 16-31).
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int wy = (wm / C::WX) * 2, wx = (wm % C::WX) * 8 * C::MT;
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t a_lane =
      ((wy + ((lane >> 3) & 1)) * C::HW + wx + (lane & 7)) * C::PSTRIDE + (lane >> 4) * 16;
  const float m = *m_p;
  const int flip = (POOL && m < 0.0f) ? -1 : 0;  // requant nonincreasing: pool the minimum sum
  const int Ho = POOL ? H / 2 : H, Wo = POOL ? W / 2 : W;
  const int ch_warp = wn * C::NT * 8;  // the warp's first channel in the n-group

  int buf = 0;
  for (int t = first; t < n_tiles; t += stride, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile's window (and, the first time, weights and bias) is in
    if (t + stride < n_tiles) prefetch(t + stride, buf ^ 1);
    cp_async_commit();

    int acc[C::MT][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

    const uint32_t a_base = smem_addr(s_halo + buf * C::HALO_BYTES) + a_lane;
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks) {
      const int tap = ks / C::CSTEPS, cs = ks % C::CSTEPS;
      const uint32_t off = ((tap / C::K) * C::HW + tap % C::K) * C::PSTRIDE + cs * 32;
      uint32_t a[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) ldmatrix_x4(a_base + off + mt * 8 * C::PSTRIDE, a[mt]);
#pragma unroll
      for (int q = 0; q < C::NT / 2; ++q) {
        // n-tiles 2q and 2q + 1 of the warp: {b0, b1} of each
        const uint4 b = s_w[(ks * C::NPB + wn * (C::NT / 2) + q) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          mma_s8(acc[mt][2 * q], a[mt], b.x, b.y);
          mma_s8(acc[mt][2 * q + 1], a[mt], b.z, b.w);
        }
      }
    }

    // Epilogue: lane (g, tig) holds, per n-tile j, channels 8j + 2tig + {0, 1}
    // of pixel (wy, x) in accumulators 0-1 and of (wy + 1, x) in 2-3, with
    // x = wx + 8mt + g; lane g ^ 1 holds column x ^ 1.
    const int s = t / per_img, rem = t % per_img;
    const int y = (rem / tiles_x) * C::TH + wy;
    const int ch0 = ng * C::BN + ch_warp;  // the warp's first channel
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const int x = (rem % tiles_x) * C::TW + wx + 8 * mt + g;
      if constexpr (POOL) {
        static_assert(C::NT == 8, "pooled layers store 64 channels a warp");
        uint32_t wv[4];
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
          int v0 = max(acc[mt][j][0] ^ flip, acc[mt][j][2] ^ flip);
          int v1 = max(acc[mt][j][1] ^ flip, acc[mt][j][3] ^ flip);
          v0 = max(v0, __shfl_xor_sync(kFull, v0, 4));
          v1 = max(v1, __shfl_xor_sync(kFull, v1, 4));
          const int c = ch_warp + 8 * j + 2 * tig;
          const uint32_t p = pair2(requant(v0 ^ flip, s_b[c], m, lo),
                                   requant(v1 ^ flip, s_b[c + 1], m, lo));
          wv[j >> 1] = (j & 1) ? __byte_perm(wv[j >> 1], p, 0x5410) : p;
        }
        const uint4 o = transpose16(wv, tig);
        const int oy = y >> 1, ox = x >> 1;
        if (!(g & 1) && oy < Ho && ox < Wo)
          *reinterpret_cast<uint4*>(out + (((size_t)s * Ho + oy) * Wo + ox) * cout + ch0 + 16 * tig) = o;
      } else if constexpr (C::NT == 8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t wv[4];
#pragma unroll
          for (int j = 0; j < C::NT; ++j) {
            const int c = ch_warp + 8 * j + 2 * tig;
            const uint32_t p = pair2(requant(acc[mt][j][2 * h], s_b[c], m, lo),
                                     requant(acc[mt][j][2 * h + 1], s_b[c + 1], m, lo));
            wv[j >> 1] = (j & 1) ? __byte_perm(wv[j >> 1], p, 0x5410) : p;
          }
          const uint4 o = transpose16(wv, tig);
          if (y + h < Ho && x < Wo)
            *reinterpret_cast<uint4*>(out + (((size_t)s * Ho + y + h) * Wo + x) * cout + ch0 + 16 * tig) = o;
        }
      } else {  // rows of `cout` bytes, not 16-byte aligned: a byte a channel
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool in_img = y + h < Ho && x < Wo;
          int8_t* px = out + (((size_t)s * Ho + y + h) * Wo + x) * cout;
#pragma unroll
          for (int j = 0; j < C::NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = ch_warp + 8 * j + 2 * tig + e;
              if (in_img && ng * C::BN + c < cout)
                px[ng * C::BN + c] = (int8_t)requant(acc[mt][j][2 * h + e], s_b[c], m, lo);
            }
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outstanding when the block exits
}

template <class C, bool POOL>
int launch(const void* in, const void* w, const void* bias, const void* m, void* out, int S,
           int H, int W, int cout, int relu, void* stream) {
  // The persistent grid's size (blocks that fit at once), found once per
  // instantiation and device.
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  auto kernel = qconv_kernel<C, POOL>;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    C::SMEM)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::kThreads,
                                                             C::SMEM)) != cudaSuccess)
      return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const int n_groups = (cout + C::BN - 1) / C::BN;
  const long long tiles = (long long)S * ((H + C::TH - 1) / C::TH) * ((W + C::TW - 1) / C::TW);
  const long long per_group = resident[dev] / n_groups;
  if (per_group <= 0) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)((tiles < per_group ? tiles : per_group) * n_groups);
  kernel<<<grid, C::kThreads, C::SMEM, (cudaStream_t)stream>>>(
      (const int8_t*)in, (const uint4*)w, (const float*)bias, (const float*)m, (int8_t*)out, S,
      H, W, cout, relu ? 0.0f : -128.0f);
  return (int)cudaGetLastError();
}

}  // namespace

// One layer: x (S, H, W, cin) int8 NHWC -> out (S, H', W', cout) int8 NHWC,
// H' x W' = H x W, or floor(H/2) x floor(W/2) with `pool`. w: qconv_weights'
// layout for the instantiation; bias: (cout,) f32 quantized bias; m: () f32.
extern "C" int qconv(const void* in, const void* w, const void* bias, const void* m, void* out,
                     int S, int H, int W, int cin, int cout, int k, int pool, int relu,
                     void* stream) {
  if (S <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (k == 3 && cin == 64 && cout == 64)
    return pool ? launch<CfgC64, true>(in, w, bias, m, out, S, H, W, cout, relu, stream)
                : launch<CfgC64, false>(in, w, bias, m, out, S, H, W, cout, relu, stream);
  if (k == 3 && cin == 64 && cout == 128 && !pool)
    return launch<CfgC64N128, false>(in, w, bias, m, out, S, H, W, cout, relu, stream);
  if (k == 3 && cin == 128 && cout == 128)
    return pool ? launch<CfgC128, true>(in, w, bias, m, out, S, H, W, cout, relu, stream)
                : launch<CfgC128, false>(in, w, bias, m, out, S, H, W, cout, relu, stream);
  if (k == 3 && cin == 128 && cout == 256 && !pool)
    return launch<CfgC128, false>(in, w, bias, m, out, S, H, W, cout, relu, stream);
  if (k == 1 && cin == 256 && cout == 65 && !pool)
    return launch<CfgPb, false>(in, w, bias, m, out, S, H, W, cout, relu, stream);
  if (k == 1 && cin == 256 && cout == 256 && !pool)
    return launch<CfgDb, false>(in, w, bias, m, out, S, H, W, cout, relu, stream);
  return (int)cudaErrorInvalidValue;
}
