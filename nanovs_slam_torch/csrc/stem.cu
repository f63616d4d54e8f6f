// Fused backbone stem: conv3x3(3 -> C1) + bias, LeakyReLU (slope 0.01, or
// 0 for the ReLU of the MCU configs), conv3x3(C1 -> C2) + bias, LeakyReLU,
// 2x2 max-pool; SAME padding, with the conv1 positions outside the image
// zeroed before conv2. The biases are the folded BatchNorm of
// conv1a/conv1b.
//
// Replaces the TPU kernel nanovs_slam_tpu/ops/pallas/fused_stem.py
// (fused_stem_pair_pool). On the TPU the 3-channel minor dim was padded to
// (8, 128) tiles, which inflated its traffic 43.7x, so the JAX package left
// the kernel off its path. Hopper has no such tiling rule.
//
// Design: both convolutions are implicit GEMMs on the tensor cores
// (mma.sync m16n8k8 TF32) in 3xTF32, which keeps float32 accuracy. A block
// of 4 warps owns 8 conv2 rows by 16 columns (4 x 8 pooled outputs):
//   1. it stages the 12x20x3 halo'd input tile and conv2's weights as B
//      fragments, each value split into its TF32 hi and lo parts once;
//   2. conv1 over the 10x18 tile with its one-pixel ring: M = 180 pixels
//      in m-tiles of 16, N = C1, K = 27 taps x channels padded to 32 (A
//      gathered from the input tile, B in registers). Bias, activation,
//      zero outside the image; the result goes to shared memory channel-
//      last, already split, laid out so that a lane's A values of a pixel
//      are two 16-byte loads: with t = lane % 4, channels t + 4q (q < C1/4)
//      hi, then lo, at float (t * C1/2) of the pixel, whose stride 2*C1 + 4
//      keeps the 8 lanes of a quarter warp on distinct banks;
//   3. conv2: a warp takes conv2 rows 2w and 2w+1 (two m-tiles of 16
//      columns), N = C2 in n-tiles of 8, K = 9 taps x C1, one tap and 8
//      channels a k-step;
//   4. pool in registers: the two m-tiles give the vertical max in-thread,
//      the accumulator rows g and g+1 (lanes 4 apart) the horizontal one by
//      one shuffle; bias and activation come after the max, which is exact
//      because both are monotonic. The pooled values go out through a
//      warp-private shared-memory transpose as 32-byte NCHW runs.
// Neither conv1 nor the full-resolution conv2 output touches device memory.
// The code is generic in (C1, C2) with C1 % 16 == 0 and C2 % 8 == 0; the
// instances are configs N (16, 24) and S/F (16, 32).
//
// The wide instance, config D's (64, 128), cannot hold that tile: conv2's
// split weights alone take 576 KB. stem_wide_kernel keeps the tile's
// geometry and its 3xTF32 products but
//   - streams conv2's weights through shared memory a tap at a time (64 KB,
//     hi and lo), double-buffered with cp.async from a copy that
//     stem_pack_kernel writes at each call, already split and in fragment
//     order, so that a tap's copy is coalesced 16-byte loads;
//   - keeps conv1's tile raw, which leaves room for the two tap buffers, and
//     splits a lane's A values where they are loaded, once for the warp's 8
//     n-tiles;
//   - runs 8 warps: a warp takes a conv2 row pair and half of C2 (2 m-tiles
//     x 8 n-tiles);
//   - lays conv1's tile out per pixel in chunks of 16 channels, a lane's
//     four channels t + 4q of a chunk side by side, so that one 16-byte
//     load gives a lane its A values of two k-steps; the pixel stride
//     C1 + 16 keeps a quarter warp's loads on distinct banks;
//   - sums a tap's products apart and adds the sum in float32: K = 576 in
//     one chain of tensor-core sums lost up to 2.3e-05 against the twin.
// Its shared memory (218 KB) allows one block an SM. Splitting C2 over the
// grid instead (two blocks of 64 channels a tile, conv1's tile split once
// when stored) took 1.45x as long on the card.
//
// Bound on an H100: operations. At 240x320, C1 = 16, C2 = 24 a frame is
// 0.60 GFLOP (conv2 0.53) against 4.6 MB of input and output: 3.6 us at the
// 3xTF32 rate (three TF32 products a product at 495 TFLOP/s), 8.9 us at the
// 67 TFLOP/s float32 rate of the CUDA cores. At C1 = 64, C2 = 128 a frame
// is 11.59 GFLOP against 10.8 MB: 70.2 us at the 3xTF32 rate.
//
// The bfloat16 instances (stem_bf16_kernel, all three widths) compute what
// the model computes at bf16: x and the folded weights rounded to bf16,
// both convolutions one pass of mma.sync m16n8k16 bf16 with float32
// accumulation (no split: the operands are exact in bf16), bias and
// activation in float32, conv1's activation rounded to bf16 before conv2
// reads it, and the pooled output rounded to bf16. The tile's geometry is
// the float32 kernel's; conv1's tile is bf16 channel-last with a pixel
// stride of C1 + 8 (a quarter warp's 32-bit A loads on distinct banks), and
// a k-step of conv2 is 16 channels of one tap. The weights sit in shared
// memory as B fragments for the whole block: gathered and rounded by each
// block at (16, 24) and (16, 32) (9 KB); at (64, 128) (147 KB)
// stem_pack_bf16_kernel writes them once a call and one block an SM copies
// them with cp.async, then walks over tiles. At 240x320 and (64, 128) a
// frame is 11.59 GFLOP against 5.4 MB: 11.7 us at 989 TFLOP/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileH = 2 * kWarps;  // conv2 rows a block: a row pair a warp
constexpr int kTileW = 16;          // conv2 columns a block: one m-tile
constexpr int kPoolH = kTileH / 2, kPoolW = kTileW / 2;
constexpr int kY1H = kTileH + 2, kY1W = kTileW + 2;  // conv1 tile and ring
constexpr int kY1Pix = kY1H * kY1W;
constexpr int kInH = kTileH + 4, kInW = kTileW + 4;  // input tile and halo
constexpr int kIn = 3 * kInH * kInW;
constexpr int kK1 = 27;  // conv1's depth, padded to 4 k-steps of 8

template <int C1, int C2>
struct StemSmem {
  static constexpr int kPix = 2 * C1 + 4;  // floats a conv1 pixel
  float4 w2[9 * (C1 / 8) * (C2 / 8) * 32];  // conv2's B fragments
  float y1[kY1Pix * kPix];                  // conv1 tile, hi and lo
  union {
    float x[2][kIn];                     // input tile [ci][r][c], hi and lo
    float out[kWarps][C2][kPoolW + 1];  // pooled outputs, a warp's own
  } u;
};

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads, 3)
stem_kernel(const float* __restrict__ x, long long sx_b, long long sx_h,
            long long sx_w, long long sx_c, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ out, int H,
            int W, float slope) {
  static_assert(C1 % 16 == 0 && C2 % 8 == 0, "C1 % 16, C2 % 8");
  constexpr int KS = C1 / 8;     // conv2 k-steps a tap
  constexpr int NT = C2 / 8;     // conv2 n-tiles
  constexpr int NT1 = C1 / 8;    // conv1 n-tiles
  constexpr int Q = C1 / 4;      // a lane's channels of a conv1 pixel
  constexpr int PIX = StemSmem<C1, C2>::kPix;
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<StemSmem<C1, C2>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTileH;  // first conv2 row of the tile
  const int ox0 = blockIdx.x * kTileW;

  // 1. the input tile, zero outside the image, split
  const float* xb = x + (long long)b * sx_b;
  for (int e = tid; e < kIn; e += kThreads) {
    const int ci = e / (kInH * kInW), r = e / kInW % kInH, c = e % kInW;
    const int gy = oy0 - 2 + r, gx = ox0 - 2 + c;
    const float v = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? xb[gy * sx_h + gx * sx_w + ci * sx_c]
                        : 0.f;
    uint32_t hi, lo;
    nvs::split_tf32(v, hi, lo);
    s.u.x[0][e] = __uint_as_float(hi);
    s.u.x[1][e] = __uint_as_float(lo);
  }
  // conv2's B fragments: slot ((tap * KS + ks) * NT + nt) * 32 + lane holds
  // w2[nt*8 + g][ks*8 + t][tap] and the same at channel + 4, hi then lo
  for (int e = tid; e < 9 * KS * NT * 32; e += kThreads) {
    const int l = e & 31, nt = (e >> 5) % NT, ks = (e >> 5) / NT % KS;
    const int tap = (e >> 5) / (NT * KS);
    const float* wp = w2 + ((nt * 8 + (l >> 2)) * C1 + ks * 8 + (l & 3)) * 9
                      + tap;
    uint32_t h0, l0, h1, l1;
    nvs::split_tf32(__ldg(wp), h0, l0);
    nvs::split_tf32(__ldg(wp + 4 * 9), h1, l1);
    s.w2[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(l0), __uint_as_float(l1));
  }
  // conv1's B fragments, in registers: k = ci*9 + ky*3 + kx, zero from 27;
  // koff: the lane's two k of each k-step as offsets into the input tile
  uint32_t w1h[4][NT1][2], w1l[4][NT1][2];
  int koff[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = ks * 8 + t + 4 * j;
      koff[ks][j] = k < kK1 ? k / 9 * kInH * kInW + k % 9 / 3 * kInW + k % 3
                            : 0;
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        const float v = k < kK1 ? __ldg(w1 + (nt * 8 + g) * kK1 + k) : 0.f;
        nvs::split_tf32(v, w1h[ks][nt][j], w1l[ks][nt][j]);
      }
    }
  float b1v[NT1][2];
#pragma unroll
  for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) b1v[nt][j] = __ldg(b1 + nt * 8 + 2 * t + j);
  __syncthreads();

  // 2. conv1: m-tiles of 16 tile pixels (row-major over kY1H x kY1W)
  for (int m = warp; m < (kY1Pix + 15) / 16; m += kWarps) {
    int poff[2];  // accumulator rows g and g + 8: their pixel's input offset
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = min(m * 16 + g + 8 * r, kY1Pix - 1);
      poff[r] = p / kY1W * kInW + p % kY1W;
    }
    float acc[NT1][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // a0..a3: (row g | g+8) x (k | k + 4)
        const bool valid = ks * 8 + t + 4 * (q >> 1) < kK1;
        const int idx = koff[ks][q >> 1] + poff[q & 1];
        ah[q] = valid ? bits(s.u.x[0][idx]) : 0u;
        al[q] = valid ? bits(s.u.x[1][idx]) : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt)
        nvs::mma_3xtf32(acc[nt], ah, al, w1h[ks][nt], w1l[ks][nt]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = m * 16 + g + (i >> 1) * 8;
      if (p >= kY1Pix) continue;
      const int gy = oy0 - 1 + p / kY1W, gx = ox0 - 1 + p % kY1W;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        const int ch = nt * 8 + 2 * t + (i & 1);
        const float v =
            in ? nvs::leaky(acc[nt][i] + b1v[nt][i & 1], slope) : 0.f;
        uint32_t hi, lo;
        nvs::split_tf32(v, hi, lo);
        float* py = s.y1 + p * PIX + (ch & 3) * (C1 / 2) + (ch >> 2);
        py[0] = __uint_as_float(hi);
        py[Q] = __uint_as_float(lo);
      }
    }
  }
  __syncthreads();

  // 3. conv2: the warp's m-tiles are conv2 rows 2w (j = 0) and 2w + 1
  float acc[2][NT][4] = {};
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    float a[2][2][2][Q];  // [m-tile][row g | g + 8][hi | lo][channel t + 4q]
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* p = s.y1 + ((2 * warp + j + ky) * kY1W + g + 8 * r + kx)
                                * PIX + t * (C1 / 2);
#pragma unroll
        for (int hl = 0; hl < 2; ++hl)
#pragma unroll
          for (int v = 0; v < Q / 4; ++v) {
            const float4 f =
                *reinterpret_cast<const float4*>(p + hl * Q + 4 * v);
            a[j][r][hl][4 * v] = f.x;
            a[j][r][hl][4 * v + 1] = f.y;
            a[j][r][hl][4 * v + 2] = f.z;
            a[j][r][hl][4 * v + 3] = f.w;
          }
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // k-step ks: column t is channel 8ks + t (q = 2ks), t + 4 is q + 1
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ah[j][q] = bits(a[j][q & 1][0][2 * ks + (q >> 1)]);
          al[j][q] = bits(a[j][q & 1][1][2 * ks + (q >> 1)]);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 f = s.w2[((tap * KS + ks) * NT + nt) * 32 + lane];
        const uint32_t bh[2] = {bits(f.x), bits(f.y)};
        const uint32_t bl[2] = {bits(f.z), bits(f.w)};
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvs::mma_3xtf32(acc[j][nt], ah[j], al[j], bh, bl);
      }
    }
  }

  // 4. pool: rows 2w, 2w + 1 in-thread; columns g, g + 1 from lane + 4.
  // Lanes of even g hold pooled column g/2 (d0, d1) and 4 + g/2 (d2, d3).
  float(*so)[kPoolW + 1] = s.u.out[warp];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = fmaxf(acc[0][nt][i], acc[1][nt][i]);
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      if (!(g & 1)) {
        const int ch = nt * 8 + 2 * t + (i & 1);
        so[ch][(i >> 1) * 4 + g / 2] = nvs::leaky(v + __ldg(b2 + ch), slope);
      }
    }
  __syncwarp();
  const int H2 = H / 2, W2 = W / 2;
  const int py = blockIdx.y * kPoolH + warp, px0 = blockIdx.x * kPoolW;
  if (py < H2) {
    for (int e = lane; e < C2 * kPoolW; e += 32) {
      const int ch = e / kPoolW, c = e % kPoolW;
      if (px0 + c < W2)
        out[(((long long)b * C2 + ch) * H2 + py) * W2 + px0 + c] = so[ch][c];
    }
  }
}

template <int C1, int C2>
cudaError_t launch(const float* x, const long long* sx, const float* w1,
                   const float* b1, const float* w2, const float* b2,
                   float* out, int B, int H, int W, float slope,
                   cudaStream_t stream) {
  constexpr int kSmem = sizeof(StemSmem<C1, C2>);
  const cudaError_t err = nvs::once_per_device([] {
    return cudaFuncSetAttribute(stem_kernel<C1, C2>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem);
  });
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + kPoolW - 1) / kPoolW, (H / 2 + kPoolH - 1) / kPoolH,
                  B);
  stem_kernel<C1, C2><<<grid, kThreads, kSmem, stream>>>(
      x, sx[0], sx[1], sx[2], sx[3], w1, b1, w2, b2, out, H, W, slope);
  return cudaGetLastError();
}

// ------------------------------------------------ the wide instance (64, 128)

constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;

// floats at c, c + 4 of a k-step's fragment, split: (hi c, hi c+4, lo c,
// lo c+4), the order mma_3xtf32's (bh, bl) take
__device__ __forceinline__ float4 split_pair(float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  nvs::split_tf32(v0, h0, l0);
  nvs::split_tf32(v1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(l0), __uint_as_float(l1));
}

// The weights as B fragments, split, with g = lane / 4 and t = lane % 4:
// p1[(ks * C1/8 + nt) * 32 + lane]: conv1's k = 8 ks + t (and + 4; zero
//   from 27, k = ci*9 + ky*3 + kx) of output channel 8 nt + g;
// p2[((tap * C1/8 + ks) * C2/8 + nt) * 32 + lane]: conv2's input channel
//   8 ks + t (and + 4) of output channel 8 nt + g at tap, so that a tap is
//   one contiguous run.
template <int C1, int C2>
__global__ void stem_pack_kernel(const float* __restrict__ w1,
                                 const float* __restrict__ w2,
                                 float4* __restrict__ p1,
                                 float4* __restrict__ p2) {
  constexpr int N1 = 4 * (C1 / 8) * 32, N2 = 9 * (C1 / 8) * (C2 / 8) * 32;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < N1 + N2;
       e += gridDim.x * blockDim.x) {
    const int l = e & 31, g = l >> 2, t = l & 3;
    if (e < N1) {
      const int nt = (e >> 5) % (C1 / 8), k = (e >> 5) / (C1 / 8) * 8 + t;
      const float* wp = w1 + (nt * 8 + g) * kK1;
      p1[e] = split_pair(k < kK1 ? wp[k] : 0.f,
                         k + 4 < kK1 ? wp[k + 4] : 0.f);
    } else {
      const int f = e - N1, r = f >> 5;
      const int nt = r % (C2 / 8), ks = r / (C2 / 8) % (C1 / 8);
      const int tap = r / (C2 / 8 * (C1 / 8));
      const float* wp = w2 + ((nt * 8 + g) * C1 + ks * 8 + t) * 9 + tap;
      p2[f] = split_pair(wp[0], wp[4 * 9]);
    }
  }
}

template <int C1, int C2>
struct WideSmem {
  static constexpr int kPix = C1 + 16;                   // floats a pixel
  static constexpr int kTap = (C1 / 8) * (C2 / 8) * 32;  // float4 a tap
  float4 w2[2][kTap];            // conv2's fragments of two taps
  float4 w1[4 * (C1 / 8) * 32];  // conv1's fragments
  float y1[kY1Pix * kPix];       // conv1 tile, raw
  union {
    float x[2][kIn];                               // input tile, hi and lo
    float out[kWideWarps][C2 / 2][kPoolW + 1];  // pooled, a warp's own
  } u;
};

__device__ __forceinline__ float part(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

template <int C1, int C2>
__global__ void __launch_bounds__(kWideThreads, 1)
stem_wide_kernel(const float* __restrict__ x, long long sx_b, long long sx_h,
                 long long sx_w, long long sx_c,
                 const float4* __restrict__ p1, const float4* __restrict__ p2,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 float* __restrict__ out, int H, int W, float slope) {
  static_assert(C1 % 16 == 0 && C2 % 16 == 0, "widths");
  constexpr int NT1 = C1 / 8;    // conv1 n-tiles
  constexpr int NT = C2 / 8;     // conv2 n-tiles
  constexpr int NTW = NT / 2;    // ... of a warp
  constexpr int PIX = WideSmem<C1, C2>::kPix;
  constexpr int TAP = WideSmem<C1, C2>::kTap;
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<WideSmem<C1, C2>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTileH, ox0 = blockIdx.x * kTileW;

  // conv1's fragments and conv2's first tap fly while the input is staged
  for (int e = tid; e < 4 * NT1 * 32; e += kWideThreads)
    nvs::cp_async16(&s.w1[e], p1 + e);
  for (int e = tid; e < TAP; e += kWideThreads)
    nvs::cp_async16(&s.w2[0][e], p2 + e);
  nvs::cp_async_commit();

  // 1. the input tile, zero outside the image, split
  const float* xb = x + (long long)b * sx_b;
  for (int e = tid; e < kIn; e += kWideThreads) {
    const int ci = e / (kInH * kInW), r = e / kInW % kInH, c = e % kInW;
    const int gy = oy0 - 2 + r, gx = ox0 - 2 + c;
    const float v = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? xb[gy * sx_h + gx * sx_w + ci * sx_c]
                        : 0.f;
    uint32_t hi, lo;
    nvs::split_tf32(v, hi, lo);
    s.u.x[0][e] = __uint_as_float(hi);
    s.u.x[1][e] = __uint_as_float(lo);
  }
  int koff[4][2];  // the lane's k of each conv1 k-step, into the input tile
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = ks * 8 + t + 4 * j;
      koff[ks][j] = k < kK1 ? k / 9 * kInH * kInW + k % 9 / 3 * kInW + k % 3
                            : 0;
    }
  nvs::cp_async_wait<0>();
  __syncthreads();

  // 2. conv1: units of an m-tile of 16 ring-tile pixels and half the
  // n-tiles, three a warp
  constexpr int M1 = (kY1Pix + 15) / 16, NH1 = NT1 / 2;
  for (int u = warp; u < 2 * M1; u += kWideWarps) {
    const int m = u >> 1, n0 = (u & 1) * NH1;
    int poff[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = min(m * 16 + g + 8 * r, kY1Pix - 1);
      poff[r] = p / kY1W * kInW + p % kY1W;
    }
    float acc[NH1][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool valid = ks * 8 + t + 4 * (q >> 1) < kK1;
        const int idx = koff[ks][q >> 1] + poff[q & 1];
        ah[q] = valid ? bits(s.u.x[0][idx]) : 0u;
        al[q] = valid ? bits(s.u.x[1][idx]) : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < NH1; ++nt) {
        const float4 f = s.w1[(ks * NT1 + n0 + nt) * 32 + lane];
        const uint32_t bh[2] = {bits(f.x), bits(f.y)};
        const uint32_t bl[2] = {bits(f.z), bits(f.w)};
        nvs::mma_3xtf32(acc[nt], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = m * 16 + g + (i >> 1) * 8;
      if (p >= kY1Pix) continue;
      const int gy = oy0 - 1 + p / kY1W, gx = ox0 - 1 + p % kY1W;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int nt = 0; nt < NH1; ++nt) {
        const int ch = (n0 + nt) * 8 + 2 * t + (i & 1), q = ch >> 2;
        s.y1[p * PIX + (q >> 2) * 16 + (ch & 3) * 4 + (q & 3)] =
            in ? nvs::leaky(acc[nt][i] + __ldg(b1 + ch), slope) : 0.f;
      }
    }
  }
  for (int e = tid; e < TAP; e += kWideThreads)
    nvs::cp_async16(&s.w2[1][e], p2 + TAP + e);
  nvs::cp_async_commit();
  __syncthreads();

  // 3. conv2: rows 2 rp (j = 0) and 2 rp + 1 of the tile, n-tiles nh*NTW..;
  // a tap's weights in s.w2[tap & 1], the next tap's in flight
  const int rp = warp & 3, nh = warp >> 2;
  float acc[2][NTW][4] = {};
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    const float4* wb = s.w2[tap & 1];
    // the tensor cores truncate as they accumulate, so the error grows with
    // the products a sum takes in: a tap's 24 go into a sum of their own,
    // which joins acc by a rounded float32 add
    float psum[2][NTW][4] = {};
#pragma unroll
    for (int kp = 0; kp < C1 / 16; ++kp) {
      float4 a4[2][2];  // [m-tile j][row g | g + 8], raw
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a4[j][r] = *reinterpret_cast<const float4*>(
              s.y1 + ((2 * rp + j + ky) * kY1W + g + 8 * r + kx) * PIX
              + kp * 16 + t * 4);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // k-step 2 kp + kk: column t is channel 16 kp + 8 kk + t, part 2 kk
        // of the lane's float4; column t + 4 is part 2 kk + 1
        const int ks = 2 * kp + kk;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            nvs::split_tf32(part(a4[j][q & 1], 2 * kk + (q >> 1)), ah[j][q],
                            al[j][q]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const float4 f = wb[(ks * NT + nh * NTW + nt) * 32 + lane];
          const uint32_t bh[2] = {bits(f.x), bits(f.y)};
          const uint32_t bl[2] = {bits(f.z), bits(f.w)};
#pragma unroll
          for (int j = 0; j < 2; ++j)
            nvs::mma_3xtf32(psum[j][nt], ah[j], al[j], bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][nt][i] += psum[j][nt][i];
    nvs::cp_async_wait<0>();
    __syncthreads();  // every warp is done with s.w2[tap & 1]
    if (tap + 2 < 9) {
      for (int e = tid; e < TAP; e += kWideThreads)
        nvs::cp_async16(&s.w2[tap & 1][e], p2 + (tap + 2) * TAP + e);
      nvs::cp_async_commit();
    }
  }

  // 4. pool as in stem_kernel, the warp's channels through its own
  // shared-memory transpose
  float(*so)[kPoolW + 1] = s.u.out[warp];
  const int c0 = nh * (C2 / 2);
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = fmaxf(acc[0][nt][i], acc[1][nt][i]);
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      if (!(g & 1)) {
        const int cl = nt * 8 + 2 * t + (i & 1);
        so[cl][(i >> 1) * 4 + g / 2] =
            nvs::leaky(v + __ldg(b2 + c0 + cl), slope);
      }
    }
  __syncwarp();
  const int H2 = H / 2, W2 = W / 2;
  const int py = blockIdx.y * kPoolH + rp, px0 = blockIdx.x * kPoolW;
  if (py < H2) {
    for (int e = lane; e < C2 / 2 * kPoolW; e += 32) {
      const int cl = e / kPoolW, c = e % kPoolW;
      if (px0 + c < W2)
        out[(((long long)b * C2 + c0 + cl) * H2 + py) * W2 + px0 + c] =
            so[cl][c];
    }
  }
}

// scratch: at least (4*C1/8*32 + 9*C1/8*C2/8*32) float4, 16-byte aligned
template <int C1, int C2>
cudaError_t launch_wide(const float* x, const long long* sx, const float* w1,
                        const float* b1, const float* w2, const float* b2,
                        float* out, float* scratch, int B, int H, int W,
                        float slope, cudaStream_t stream) {
  constexpr int N1 = 4 * (C1 / 8) * 32, N2 = 9 * (C1 / 8) * (C2 / 8) * 32;
  constexpr int kSmem = sizeof(WideSmem<C1, C2>);
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16)
    return cudaErrorInvalidValue;
  const cudaError_t err = nvs::once_per_device([] {
    return cudaFuncSetAttribute(stem_wide_kernel<C1, C2>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem);
  });
  if (err != cudaSuccess) return err;
  float4* p1 = reinterpret_cast<float4*>(scratch);
  float4* p2 = p1 + N1;
  stem_pack_kernel<C1, C2><<<(N1 + N2 + 255) / 256, 256, 0, stream>>>(
      w1, w2, p1, p2);
  const cudaError_t perr = cudaGetLastError();
  if (perr != cudaSuccess) return perr;
  const dim3 grid((W / 2 + kPoolW - 1) / kPoolW, (H / 2 + kPoolH - 1) / kPoolH,
                  B);
  stem_wide_kernel<C1, C2><<<grid, kWideThreads, kSmem, stream>>>(
      x, sx[0], sx[1], sx[2], sx[3], p1, p2, b1, b2, out, H, W, slope);
  return cudaGetLastError();
}

// ------------------------------------------- the bfloat16 instances

// Tile geometry as above; the warps of a row pair share its C2 channels
// kSplit ways (two at C2 = 128).
template <int C1, int C2>
struct Bf16Cfg {
  static constexpr int kSplit = C2 >= 64 ? 2 : 1;
  static constexpr int kWarps = 4 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int KS = C1 / 16;  // conv2 k-steps a tap
  static constexpr int NT = C2 / 8;   // conv2 n-tiles
  static constexpr int NTW = NT / kSplit;
  static constexpr int NT1 = C1 / 8;  // conv1 n-tiles
  static constexpr int NT1W = NT1 / kSplit;
  static constexpr int kPix = C1 + 8;  // bf16 a conv1 pixel
  static constexpr int kW1 = 2 * NT1 * 32;       // conv1's B fragments
  static constexpr int kW2 = 9 * KS * NT * 32;   // conv2's
  // the weights come from stem_pack_bf16_kernel's copy, and a block walks
  // over several tiles
  static constexpr bool kPacked = C1 >= 64;
};

template <int C1, int C2>
struct Bf16Smem {
  using Cfg = Bf16Cfg<C1, C2>;
  uint2 w2[Cfg::kW2];  // then w1: one run, as stem_pack_bf16_kernel packs
  uint2 w1[Cfg::kW1];
  __nv_bfloat16 y1[kY1Pix * Cfg::kPix];  // conv1 tile, channel-last
  union {
    unsigned short x[kIn];  // input tile [ci][r][c], bf16 bits
    float out[Cfg::kWarps][C2 / Cfg::kSplit][kPoolW + 1];
  } u;
};

// conv1's B fragment e = (ks * C1/8 + nt) * 32 + lane, with g = lane / 4
// and t = lane % 4: k = 16 ks + 2t (+1) and 16 ks + 2t + 8 (+9) of output
// channel 8 nt + g (k = ci*9 + ky*3 + kx, zero from 27), rounded to bf16
template <int C1>
__device__ __forceinline__ uint2 w1_fragment(const float* w1, int e) {
  const int l = e & 31, g = l >> 2, t = l & 3;
  const int nt = (e >> 5) % (C1 / 8), k = (e >> 5) / (C1 / 8) * 16 + 2 * t;
  const float* wp = w1 + (nt * 8 + g) * kK1;
  auto w = [&](int kk) { return kk < kK1 ? __ldg(wp + kk) : 0.f; };
  return make_uint2(nvs::pack_bf16(w(k), w(k + 1)),
                    nvs::pack_bf16(w(k + 8), w(k + 9)));
}

// conv2's B fragment e = ((tap * C1/16 + ks) * C2/8 + nt) * 32 + lane:
// input channels 16 ks + 2t (+1) and + 8 (+9) of output channel 8 nt + g
// at tap, rounded to bf16
template <int C1, int C2>
__device__ __forceinline__ uint2 w2_fragment(const float* w2, int e) {
  const int l = e & 31, g = l >> 2, t = l & 3, r = e >> 5;
  const int nt = r % (C2 / 8), ks = r / (C2 / 8) % (C1 / 16);
  const int tap = r / (C2 / 8 * (C1 / 16));
  const float* wp = w2 + ((nt * 8 + g) * C1 + ks * 16 + 2 * t) * 9 + tap;
  return make_uint2(nvs::pack_bf16(__ldg(wp), __ldg(wp + 9)),
                    nvs::pack_bf16(__ldg(wp + 8 * 9), __ldg(wp + 9 * 9)));
}

// conv2's fragments, then conv1's, in the order of Bf16Smem
template <int C1, int C2>
__global__ void stem_pack_bf16_kernel(const float* __restrict__ w1,
                                      const float* __restrict__ w2,
                                      uint2* __restrict__ p) {
  using Cfg = Bf16Cfg<C1, C2>;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x;
       e < Cfg::kW2 + Cfg::kW1; e += gridDim.x * blockDim.x)
    p[e] = e < Cfg::kW2 ? w2_fragment<C1, C2>(w2, e)
                        : w1_fragment<C1>(w1, e - Cfg::kW2);
}

template <int C1, int C2>
__global__ void __launch_bounds__(Bf16Cfg<C1, C2>::kThreads)
stem_bf16_kernel(const __nv_bfloat16* __restrict__ x, long long sx_b,
                 long long sx_h, long long sx_w, long long sx_c,
                 const float* __restrict__ w1, const float* __restrict__ w2,
                 const uint2* __restrict__ packed,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 __nv_bfloat16* __restrict__ out, int B, int H, int W,
                 float slope) {
  using Cfg = Bf16Cfg<C1, C2>;
  static_assert(C1 % 16 == 0 && C2 % (8 * Cfg::kSplit) == 0, "widths");
  constexpr int PIX = Cfg::kPix, KS = Cfg::KS, NT = Cfg::NT;
  constexpr int NTW = Cfg::NTW, NT1 = Cfg::NT1, NT1W = Cfg::NT1W;
  constexpr int kT = Cfg::kThreads;
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<Bf16Smem<C1, C2>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // the weights, once a block
  if constexpr (Cfg::kPacked) {
    constexpr int n16 = (Cfg::kW2 + Cfg::kW1) / 2;
    const float4* src = reinterpret_cast<const float4*>(packed);
    float4* dst = reinterpret_cast<float4*>(s.w2);
    for (int e = tid; e < n16; e += kT) nvs::cp_async16(dst + e, src + e);
    nvs::cp_async_commit();
  } else {
    for (int e = tid; e < Cfg::kW2; e += kT)
      s.w2[e] = w2_fragment<C1, C2>(w2, e);
    for (int e = tid; e < Cfg::kW1; e += kT) s.w1[e] = w1_fragment<C1>(w1, e);
  }
  // the lane's conv1 k = 16 ks + 2t + (j & 1) + 8 (j >> 1) as offsets into
  // the input tile, -1 from 27
  int koff[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = ks * 16 + 2 * t + (j & 1) + 8 * (j >> 1);
      koff[ks][j] =
          k < kK1 ? k / 9 * kInH * kInW + k % 9 / 3 * kInW + k % 3 : -1;
    }

  const int H2 = H / 2, W2 = W / 2;
  const int nx = (W2 + kPoolW - 1) / kPoolW, ny = (H2 + kPoolH - 1) / kPoolH;
  for (int tile = blockIdx.x; tile < nx * ny * B; tile += gridDim.x) {
    const int b = tile / (nx * ny), ty = tile / nx % ny, tx = tile % nx;
    const int oy0 = ty * kTileH, ox0 = tx * kTileW;
    __syncthreads();  // the last tile's reads of s.y1 and s.u are done

    // 1. the input tile, zero outside the image
    const __nv_bfloat16* xb = x + (long long)b * sx_b;
    for (int e = tid; e < kIn; e += kT) {
      const int ci = e / (kInH * kInW), r = e / kInW % kInH, c = e % kInW;
      const int gy = oy0 - 2 + r, gx = ox0 - 2 + c;
      s.u.x[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                     ? __bfloat16_as_ushort(xb[gy * sx_h + gx * sx_w +
                                               ci * sx_c])
                     : (unsigned short)0;
    }
    if constexpr (Cfg::kPacked) nvs::cp_async_wait<0>();
    __syncthreads();

    // 2. conv1: units of an m-tile of 16 ring-tile pixels and NT1W n-tiles
    constexpr int M1 = (kY1Pix + 15) / 16;
    for (int u = warp; u < M1 * Cfg::kSplit; u += Cfg::kWarps) {
      const int m = u / Cfg::kSplit, n0 = u % Cfg::kSplit * NT1W;
      int poff[2];  // rows g and g + 8: their pixel's input offset
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = min(m * 16 + g + 8 * r, kY1Pix - 1);
        poff[r] = p / kY1W * kInW + p % kY1W;
      }
      float acc[NT1W][4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[4];  // row g + 8 (q & 1), k pair 2t + 8 (q >> 1)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k0 = koff[ks][2 * (q >> 1)], k1 = koff[ks][2 * (q >> 1) + 1];
          const uint32_t lo = k0 >= 0 ? s.u.x[k0 + poff[q & 1]] : 0u;
          const uint32_t hi = k1 >= 0 ? s.u.x[k1 + poff[q & 1]] : 0u;
          a[q] = lo | hi << 16;
        }
#pragma unroll
        for (int nt = 0; nt < NT1W; ++nt) {
          const uint2 f = s.w1[(ks * NT1 + n0 + nt) * 32 + lane];
          const uint32_t bw[2] = {f.x, f.y};
          nvs::mma_bf16(acc[nt], a, bw);
        }
      }
      // bias and activation in float32, zero outside the image, rounded
      // to bf16 as conv2 reads it
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m * 16 + g + 8 * h;
        if (p >= kY1Pix) continue;
        const int gy = oy0 - 1 + p / kY1W, gx = ox0 - 1 + p % kY1W;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int nt = 0; nt < NT1W; ++nt) {
          const int ch = (n0 + nt) * 8 + 2 * t;
          const float v0 =
              in ? nvs::leaky(acc[nt][2 * h] + __ldg(b1 + ch), slope) : 0.f;
          const float v1 =
              in ? nvs::leaky(acc[nt][2 * h + 1] + __ldg(b1 + ch + 1), slope)
                 : 0.f;
          *reinterpret_cast<uint32_t*>(s.y1 + p * PIX + ch) =
              nvs::pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();

    // 3. conv2: rows 2 rp (j = 0) and 2 rp + 1 of the tile, n-tiles
    // nh * NTW ..; a k-step is 16 channels of one tap
    const int rp = warp & 3, nh = warp >> 2;
    float acc[2][NTW][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[2][4];  // [m-tile j][row g + 8 (q & 1), k + 8 (q >> 1)]
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[j][q] = *reinterpret_cast<const uint32_t*>(
                s.y1 + ((2 * rp + j + ky) * kY1W + g + 8 * (q & 1) + kx) * PIX
                + ks * 16 + 2 * t + 8 * (q >> 1));
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const uint2 f = s.w2[((tap * KS + ks) * NT + nh * NTW + nt) * 32
                               + lane];
          const uint32_t bw[2] = {f.x, f.y};
#pragma unroll
          for (int j = 0; j < 2; ++j) nvs::mma_bf16(acc[j][nt], a[j], bw);
        }
      }
    }

    // 4. pool as in stem_kernel, then bias and activation in float32, one
    // rounding to bf16 as the pooled values go out
    float(*so)[kPoolW + 1] = s.u.out[warp];
    const int c0 = nh * (C2 / Cfg::kSplit);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = fmaxf(acc[0][nt][i], acc[1][nt][i]);
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        if (!(g & 1)) {
          const int cl = nt * 8 + 2 * t + (i & 1);
          so[cl][(i >> 1) * 4 + g / 2] =
              nvs::leaky(v + __ldg(b2 + c0 + cl), slope);
        }
      }
    __syncwarp();
    const int py = ty * kPoolH + rp, px0 = tx * kPoolW;
    if (py < H2) {
      for (int e = lane; e < C2 / Cfg::kSplit * kPoolW; e += 32) {
        const int cl = e / kPoolW, c = e % kPoolW;
        if (px0 + c < W2)
          out[(((long long)b * C2 + c0 + cl) * H2 + py) * W2 + px0 + c] =
              __float2bfloat16_rn(so[cl][c]);
      }
    }
  }
}

// scratch: the packed instances' fragments, (kW2 + kW1) uint2, 16-byte
// aligned (unused, and may be null, for the others)
template <int C1, int C2>
cudaError_t launch_bf16(const __nv_bfloat16* x, const long long* sx,
                        const float* w1, const float* b1, const float* w2,
                        const float* b2, __nv_bfloat16* out, void* scratch,
                        int B, int H, int W, float slope,
                        cudaStream_t stream) {
  using Cfg = Bf16Cfg<C1, C2>;
  constexpr int kSmem = sizeof(Bf16Smem<C1, C2>);
  cudaError_t err = nvs::once_per_device([] {
    return cudaFuncSetAttribute(stem_bf16_kernel<C1, C2>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem);
  });
  if (err != cudaSuccess) return err;
  int grid = (W / 2 + kPoolW - 1) / kPoolW * ((H / 2 + kPoolH - 1) / kPoolH)
             * B;
  uint2* packed = nullptr;
  if constexpr (Cfg::kPacked) {
    if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16)
      return cudaErrorInvalidValue;
    packed = static_cast<uint2*>(scratch);
    stem_pack_bf16_kernel<C1, C2>
        <<<(Cfg::kW2 + Cfg::kW1 + 255) / 256, 256, 0, stream>>>(w1, w2,
                                                                 packed);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // one block an SM (its shared memory), each walking over tiles
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    grid = grid < sms ? grid : sms;
  }
  stem_bf16_kernel<C1, C2><<<grid, Cfg::kThreads, kSmem, stream>>>(
      x, sx[0], sx[1], sx[2], sx[3], w1, w2, packed, b1, b2, out, B, H, W,
      slope);
  return cudaGetLastError();
}

}  // namespace

// x (B,H,W,3) with element strides [b, h, w, c]; w1 (C1,3,3,3) and
// w2 (C2,C1,3,3) contiguous OIHW; out contiguous NCHW (B,C2,H/2,W/2),
// floor for an odd H or W (the pool's last row and column pair are conv2's
// rows H-3, H-2 and columns W-3, W-2; conv2's SAME padding reads conv1 up
// to row H-1, which the tile bounds-checks against the full H, W);
// scratch: the wide instance's split weights, 2*9*C1*C2 + 64*C1 floats,
// 16-byte aligned (unused, and may be null, for the narrow ones).
extern "C" int nvs_stem_pair_pool(const float* x, const long long* sx,
                                  const float* w1, const float* b1,
                                  const float* w2, const float* b2,
                                  float* out, float* scratch, int B, int H,
                                  int W, int C1, int C2, float slope,
                                  cudaStream_t stream) {
  if (H < 2 || W < 2 || B < 1 || B > 65535 ||
      (H / 2 + kPoolH - 1) / kPoolH > 65535)
    return (int)cudaErrorInvalidValue;
  if (C1 == 16 && C2 == 24)
    return (int)launch<16, 24>(x, sx, w1, b1, w2, b2, out, B, H, W, slope,
                               stream);
  if (C1 == 16 && C2 == 32)
    return (int)launch<16, 32>(x, sx, w1, b1, w2, b2, out, B, H, W, slope,
                               stream);
  if (C1 == 64 && C2 == 128)
    return (int)launch_wide<64, 128>(x, sx, w1, b1, w2, b2, out, scratch, B,
                                     H, W, slope, stream);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 instances: x (B,H,W,3) bf16 with element strides [b, h, w,
// c]; the weights and biases float32 as above (the weights rounded to bf16
// in the kernel); out contiguous NCHW (B,C2,H/2,W/2) bf16; scratch: for
// (64, 128), 9*C1*C2/2 + 16*C1 floats, 16-byte aligned.
extern "C" int nvs_stem_pair_pool_bf16(const __nv_bfloat16* x,
                                       const long long* sx, const float* w1,
                                       const float* b1, const float* w2,
                                       const float* b2, __nv_bfloat16* out,
                                       void* scratch, int B, int H, int W,
                                       int C1, int C2, float slope,
                                       cudaStream_t stream) {
  if (H < 2 || W < 2 || B < 1 || B > 65535 ||
      (long long)((W / 2 + kPoolW - 1) / kPoolW) *
              ((H / 2 + kPoolH - 1) / kPoolH) * B >
          0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (C1 == 16 && C2 == 24)
    return (int)launch_bf16<16, 24>(x, sx, w1, b1, w2, b2, out, scratch, B,
                                    H, W, slope, stream);
  if (C1 == 16 && C2 == 32)
    return (int)launch_bf16<16, 32>(x, sx, w1, b1, w2, b2, out, scratch, B,
                                    H, W, slope, stream);
  if (C1 == 64 && C2 == 128)
    return (int)launch_bf16<64, 128>(x, sx, w1, b1, w2, b2, out, scratch, B,
                                     H, W, slope, stream);
  return (int)cudaErrorInvalidValue;
}
