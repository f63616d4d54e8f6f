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
// geometry (8 conv2 rows by 16 columns) and its 3xTF32 sums, and is built
// from Hopper's parts:
//   - conv2 runs on wgmma (m64n128k8, TF32): each of two consumer
//     warpgroups takes 64 pixels (two conv2 rows by 8 columns a warp, so
//     that the vertical pool stays in-thread) by all 128 channels; A comes
//     from registers, raw from conv1's tile and split where it is loaded,
//     three products a k-step (a_lo b_hi, a_hi b_lo, a_hi b_hi); B is the
//     tap's weights in shared memory, K-major without swizzle;
//   - conv2's weights stream through shared memory a tap at a time (64 KB,
//     hi and lo), double-buffered with cp.async from a copy that
//     stem_pack_kernel writes at each call, split and in the wgmma layout;
//     measured, the loads hide behind the products (a block's nine taps
//     waited 0.15 us of its 27 us);
//   - a tap's products go into a sum of their own, added to the total in
//     float32: K = 576 in one chain of tensor-core sums lost up to 2.3e-05
//     against the twin;
//   - the blocks are persistent, one an SM, and their warps specialise: a
//     producer warpgroup stages the next tile's input and runs its conv1
//     (mma.sync, 3xTF32) into the second of two conv1 buffers while the
//     consumers run conv2 on the first; the two meet at named barriers.
//     conv1's tile is raw float32, a pixel's channels in chunks of 16 with
//     the chunk index XOR-ed with the pixel's parity (y1_at), so that a
//     quarter warp's 16-byte A loads fall on distinct banks; a producer
//     warp keeps its conv1 fragments and biases in registers, since
//     re-reading them every tile slowed the consumers;
//   - the consumers pool in registers and send a channel's pooled row out
//     as 16-byte stores through the buffer they have just read.
// Shared memory 229 KB: the two tap buffers, the two conv1 buffers, the
// input tile. Phase timers on the card: with conv1 serialised (the first
// design) the products ran at ~77% of the published TF32 rate; beside the
// producer they take about a quarter longer, which the overlap repays.
//
// Bound on an H100: operations. At 240x320, C1 = 16, C2 = 24 a frame is
// 0.60 GFLOP (conv2 0.53) against 4.6 MB of input and output: 3.6 us at the
// 3xTF32 rate (three TF32 products a product at 495 TFLOP/s), 8.9 us at the
// 67 TFLOP/s float32 rate of the CUDA cores. At C1 = 64, C2 = 128 a frame
// is 11.59 GFLOP against 10.8 MB: 70.2 us at the 3xTF32 rate.
//
// The bfloat16 instances compute what the model computes at bf16: x and the
// folded weights rounded to bf16, both convolutions one pass of bf16 products
// with float32 accumulation (no split: the operands are exact in bf16), bias
// and activation in float32, conv1's activation rounded to bf16 before conv2
// reads it, and the pooled output rounded to bf16. At (16, 24) and (16, 32)
// stem_bf16_kernel runs both convolutions on mma.sync m16n8k16 over a tile of 8
// conv2 rows by 32 columns (a warp a row pair, four m-tiles; the ring and the
// halo cost 1.33x and 1.69x the tile, against 1.41x and 1.88x at 16 columns).
// Its blocks are persistent (as many as the card holds at once), each copying
// the weights once in 16-byte loads and turning them into B fragments in shared
// memory (a design that gathered them at stride 9 for every 8x16 tile spent a
// third of a block on it, by phase timers on the card); a thread loads the next
// tile's input into registers while conv2 runs, so that staging a tile is a
// store to shared memory; conv1's K is ordered (tap, channel padded to 4) over
// an input tile of 4 channels a pixel, so that an A register is one 32-bit
// load; conv1's tile is bf16 channel-last with a pixel stride of C1 + 8 (a
// quarter warp's 32-bit A loads on distinct banks); the pooled rows go out as
// 16-byte runs. Eight warps a tile (half the chain a block) measured slower at
// every shape. At (64, 128) stem_bf16_wide_kernel has stem_wide_kernel's roles:
// conv2 on wgmma (m64n128k16, bf16, A from registers) over weights resident in
// shared memory (147 KB, written in the wgmma layout by stem_pack_bf16_kernel
// at each call and copied once a block by the consumers while the producers
// start), one chain of float32 sums; two producer warpgroups, one for each
// conv1 buffer, stage the input and run conv1 on mma.sync. A producer warp
// keeps its conv1 fragments and biases in registers: in the first design they
// were re-read every tile, and that traffic slowed the consumers. At 240x320
// and (64, 128) a frame is 11.59 GFLOP against 5.4 MB: 11.7 us at 989 TFLOP/s.
// Phase timers put the consumers' conv2 at about two thirds of the bf16 rate,
// and their pool and store at a third of a tile's time.
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

// Hopper's warpgroup products: nvs::wgmma_desc and the fences, commits and
// waits in common.cuh. B is K-major without swizzle (core matrices 8 output
// channels by 16 bytes, 128 bytes apart along N, `lbo` along K); with g =
// lane / 4 and t = lane % 4, d[4j + i] of warp w is row 16 w + g + 8 (i >>
// 1), column 8 j + 2 t + (i & 1).
using nvs::fence_async_shared;
using nvs::wgmma_commit;
using nvs::wgmma_desc;
using nvs::wgmma_fence;
using nvs::wgmma_wait;

// keeps the compiler from moving accesses of the sums across a wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b: m64n128k8, TF32 operands (A in registers), float32 sums;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ... m64n128k16, bfloat16 operands
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// stem_wide_kernel's roles: two consumer warpgroups (conv2, pool, store)
// and a producer warpgroup (the next tile's input and conv1), which meet at
// named barriers (0 is __syncthreads'): a conv1 buffer is full (1, 2) or
// empty (3, 4), all consumers (5), all producers (6)
constexpr int kWideConsumers = 256;
constexpr int kWideThreads = kWideConsumers + 128;
enum : int { kBarFull = 1, kBarEmpty = 3, kBarConsumers = 5, kBarProducer = 6 };

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// floats at c, c + 4 of a k-step's fragment, split: (hi c, hi c+4, lo c,
// lo c+4), the order mma_3xtf32's (bh, bl) take
__device__ __forceinline__ float4 split_pair(float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  nvs::split_tf32(v0, h0, l0);
  nvs::split_tf32(v1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(l0), __uint_as_float(l1));
}

// The weights, split into TF32 hi and lo, with g = lane / 4, t = lane % 4:
// p1[(ks * C1/8 + nt) * 32 + lane]: conv1's B fragments for mma.sync, k =
//   8 ks + t (and + 4; zero from 27, k = ci*9 + ky*3 + kx) of output
//   channel 8 nt + g;
// p2: a tap after another, each its hi part, then its lo part (2 C1 C2
//   floats a tap), each part a wgmma B operand over C1 / 8 k-steps: input
//   channel 8 s + k of output channel n at float s*8*C2 + (k/4)*4*C2 + n*4
//   + k%4 (K-major core matrices, 16 * C2 bytes apart along K).
template <int C1, int C2>
__global__ void stem_pack_kernel(const float* __restrict__ w1,
                                 const float* __restrict__ w2,
                                 float4* __restrict__ p1,
                                 float* __restrict__ p2) {
  constexpr int N1 = 4 * (C1 / 8) * 32, N2 = 9 * 2 * C1 * C2;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < N1 + N2;
       e += gridDim.x * blockDim.x) {
    if (e < N1) {
      const int l = e & 31, g = l >> 2, t = l & 3;
      const int nt = (e >> 5) % (C1 / 8), k = (e >> 5) / (C1 / 8) * 8 + t;
      const float* wp = w1 + (nt * 8 + g) * kK1;
      p1[e] = split_pair(k < kK1 ? wp[k] : 0.f,
                         k + 4 < kK1 ? wp[k + 4] : 0.f);
    } else {
      const int f = e - N1, r = f % (C1 * C2);
      const int tap = f / (2 * C1 * C2), lo = f / (C1 * C2) % 2;
      const int ci = r / (8 * C2) * 8 + r / (4 * C2) % 2 * 4 + r % 4;
      const int n = r / 4 % C2;
      uint32_t hi, rest;
      nvs::split_tf32(w2[(n * C1 + ci) * 9 + tap], hi, rest);
      p2[f] = __uint_as_float(lo ? rest : hi);
    }
  }
}

template <int C1, int C2>
struct WideSmem {
  static constexpr int kTap = 2 * C1 * C2;  // floats a tap: hi, then lo
  static constexpr int kOut = 12;          // floats a pooled channel row
  float w2[2][kTap];  // conv2's weights of two taps
  union {
    float y1[kY1Pix * C1];          // conv1 tile, raw (y1_at)
    float out[kPoolH * C2 * kOut];  // then the pooled tile
  } u[2];
  float x[2][kIn];  // input tile, hi and lo
};

// Channel ch of conv1 pixel p in a WideSmem tile (C1 = 64): chunks of 16
// channels, the four of lane t (t, t + 4, t + 8, t + 12) side by side, so
// that one 16-byte load gives a lane its A values of two k-steps; the
// chunk index XOR-ed with the pixel's parity, so that the loads of 8
// consecutive pixels' lanes fall on distinct banks
__device__ __forceinline__ int y1_at(int p, int ch) {
  return p * 64 + ((ch >> 4) ^ (p & 1)) * 16 + (ch & 3) * 4 + (ch >> 2 & 3);
}

__device__ __forceinline__ float part(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

template <int C1, int C2>
__global__ void __launch_bounds__(kWideThreads, 1)
stem_wide_kernel(const float* __restrict__ x, long long sx_b, long long sx_h,
                 long long sx_w, long long sx_c,
                 const float4* __restrict__ p1, const float* __restrict__ p2,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 float* __restrict__ out, int B, int H, int W, float slope) {
  static_assert(C1 == 64 && C2 == 128, "the wgmma shapes are (64, 128)'s");
  constexpr int NT1 = C1 / 8;  // conv1 n-tiles
  using Smem = WideSmem<C1, C2>;
  constexpr int TAP = Smem::kTap, OUT = Smem::kOut;
  constexpr int KSTEP = 8 * C2;  // floats a k-step of a part
  constexpr int LBO = 4 * C2 * 4;
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int H2 = H / 2, W2 = W / 2;
  const int nx = (W2 + kPoolW - 1) / kPoolW, ny = (H2 + kPoolH - 1) / kPoolH;
  const int ntiles = nx * ny * B;
  // block b's tiles are b, b + grid, b + 2 grid, ...: its i-th in conv1
  // buffer s.u[i & 1]

  if (tid >= kWideConsumers) {
    // the producer: a tile's input, zero outside the image, split; then
    // conv1 on mma.sync in 3xTF32 (a warp's unit: an m-tile of 16
    // ring-tile pixels and half the n-tiles), bias, activation, zero
    // outside the image, raw into the buffer the consumers have released
    const int pw = warp - kWideConsumers / 32, ptid = tid - kWideConsumers;
    // the warp's units are m-tiles pw / 2, pw / 2 + 2, ... of n-tiles
    // n0 .. n0 + NH1 - 1: their B fragments and biases stay in registers
    constexpr int M1 = (kY1Pix + 15) / 16, NH1 = NT1 / 2;
    const int n0 = (pw & 1) * NH1;
    float4 w1f[4][NH1];
    float b1r[NH1][2];
#pragma unroll
    for (int nt = 0; nt < NH1; ++nt) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        w1f[ks][nt] = __ldg(p1 + (ks * NT1 + n0 + nt) * 32 + lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        b1r[nt][j] = __ldg(b1 + (n0 + nt) * 8 + 2 * t + j);
    }
    int koff[4][2];  // the lane's k of each k-step, into the input tile
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = ks * 8 + t + 4 * j;
        koff[ks][j] =
            k < kK1 ? k / 9 * kInH * kInW + k % 9 / 3 * kInW + k % 3 : 0;
      }
    for (int tile = blockIdx.x, i = 0; tile < ntiles;
         tile += gridDim.x, ++i) {
      const int b = tile / (nx * ny), ty = tile / nx % ny, tx = tile % nx;
      const int oy0 = ty * kTileH, ox0 = tx * kTileW;
      const float* xb = x + (long long)b * sx_b;
      bar_sync(kBarProducer, 128);  // every producer warp is done with s.x
      for (int e = ptid; e < kIn; e += 128) {
        const int ci = e / (kInH * kInW), r = e / kInW % kInH, c = e % kInW;
        const int gy = oy0 - 2 + r, gx = ox0 - 2 + c;
        const float v = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                            ? xb[gy * sx_h + gx * sx_w + ci * sx_c]
                            : 0.f;
        uint32_t hi, lo;
        nvs::split_tf32(v, hi, lo);
        s.x[0][e] = __uint_as_float(hi);
        s.x[1][e] = __uint_as_float(lo);
      }
      bar_sync(kBarProducer, 128);
      if (i >= 2) bar_sync(kBarEmpty + (i & 1), kWideThreads);
      float* y1 = s.u[i & 1].y1;
      for (int m = pw >> 1; m < M1; m += 2) {
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
            ah[q] = valid ? bits(s.x[0][idx]) : 0u;
            al[q] = valid ? bits(s.x[1][idx]) : 0u;
          }
#pragma unroll
          for (int nt = 0; nt < NH1; ++nt) {
            const float4 f = w1f[ks][nt];
            const uint32_t bh[2] = {bits(f.x), bits(f.y)};
            const uint32_t bl[2] = {bits(f.z), bits(f.w)};
            nvs::mma_3xtf32(acc[nt], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const int p = m * 16 + g + (i4 >> 1) * 8;
          if (p >= kY1Pix) continue;
          const int gy = oy0 - 1 + p / kY1W, gx = ox0 - 1 + p % kY1W;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nt = 0; nt < NH1; ++nt) {
            const int ch = (n0 + nt) * 8 + 2 * t + (i4 & 1);
            y1[y1_at(p, ch)] =
                in ? nvs::leaky(acc[nt][i4] + b1r[nt][i4 & 1], slope) : 0.f;
          }
        }
      }
      bar_arrive(kBarFull + (i & 1), kWideThreads);
    }
    return;
  }

  // The consumers. conv2's weights stream through s.w2 a tap at a time,
  // from tile to tile: the block's running tap count gt holds its weights
  // in s.w2[gt & 1] and the tap after next in flight.
  for (int e = tid; e < TAP / 4; e += kWideConsumers)
    nvs::cp_async16(reinterpret_cast<float4*>(s.w2[0]) + e,
                    reinterpret_cast<const float4*>(p2) + e);
  nvs::cp_async_commit();
  for (int e = tid; e < TAP / 4; e += kWideConsumers)
    nvs::cp_async16(reinterpret_cast<float4*>(s.w2[1]) + e,
                    reinterpret_cast<const float4*>(p2 + TAP) + e);
  nvs::cp_async_commit();
  nvs::cp_async_wait<1>();
  fence_async_shared();
  bar_sync(kBarConsumers, kWideConsumers);

  // conv2 on the two warpgroups, 64 pixels by C2 channels each: warp w4 of
  // warpgroup wg takes conv2 row pair rp, columns c8 .. c8 + 7; its row g
  // is pixel (2 rp, c8 + g), its row g + 8 pixel (2 rp + 1, c8 + g), so
  // that the vertical pool is in-thread. A k-step is 8 channels of one
  // tap, A raw from conv1's tile and split where it is loaded.
  const int wg = warp >> 2, w4 = warp & 3;
  const int rp = 2 * wg + (w4 >> 1), c8 = 8 * (w4 & 1);
  float acc[64], psum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) psum[i] = 0.f;
  int gt = 0;
  for (int tile = blockIdx.x, i = 0; tile < ntiles; tile += gridDim.x, ++i) {
    const int b = tile / (nx * ny), ty = tile / nx % ny, tx = tile % nx;
    const bool more = tile + gridDim.x < ntiles;
    bar_sync(kBarFull + (i & 1), kWideThreads);
    const float* y1 = s.u[i & 1].y1;
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap, ++gt) {
      // the lane's row g at this tap: conv1 pixel pg; its row g + 8 is
      // pg + kY1W, of the same parity
      const int pg = (2 * rp + tap / 3) * kY1W + c8 + g + tap % 3;
      const float* pa = y1 + pg * C1 + 4 * t;
      const int par = pg & 1;
      const float* wb = s.w2[gt & 1];
      // the tensor cores truncate as they accumulate, so the error grows
      // with the products a sum takes in: a tap's go into a sum of their
      // own (scale_d 0 at its first product), which joins acc by a rounded
      // add
      fence_regs(psum);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kp = 0; kp < C1 / 16; ++kp) {
        const float4 fa =
            *reinterpret_cast<const float4*>(pa + (kp ^ par) * 16);
        const float4 fb = *reinterpret_cast<const float4*>(
            pa + kY1W * C1 + (kp ^ par) * 16);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // k-step 2 kp + kk: column t is channel 16 kp + 8 kk + t, part
          // 2 kk of the lane's float4; column t + 4 is part 2 kk + 1. Its A
          // registers are those of the k-step before last, so that
          // k-step's products must be done.
          const int ks = 2 * kp + kk;
          wgmma_wait<1>();
          nvs::split_tf32(part(fa, 2 * kk), ah[kk][0], al[kk][0]);
          nvs::split_tf32(part(fb, 2 * kk), ah[kk][1], al[kk][1]);
          nvs::split_tf32(part(fa, 2 * kk + 1), ah[kk][2], al[kk][2]);
          nvs::split_tf32(part(fb, 2 * kk + 1), ah[kk][3], al[kk][3]);
          const uint64_t dh = wgmma_desc(wb + ks * KSTEP, LBO);
          const uint64_t dl = wgmma_desc(wb + C1 * C2 + ks * KSTEP, LBO);
          wgmma_fence();
          wgmma_tf32_n128(psum, al[kk], dh, ks > 0);
          wgmma_tf32_n128(psum, ah[kk], dl, 1);
          wgmma_tf32_n128(psum, ah[kk], dh, 1);
          wgmma_commit();
        }
      }
      wgmma_wait<0>();
      fence_regs(psum);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += psum[j];
      nvs::cp_async_wait<0>();
      fence_async_shared();
      // every consumer is done with s.w2[gt & 1] (and, after the last
      // tap, with the conv1 tile)
      bar_sync(kBarConsumers, kWideConsumers);
      if (tap + 2 < 9 || more) {  // the block's tap after next
        const float4* src =
            reinterpret_cast<const float4*>(p2 + (tap + 2) % 9 * TAP);
        for (int e = tid; e < TAP / 4; e += kWideConsumers)
          nvs::cp_async16(reinterpret_cast<float4*>(s.w2[gt & 1]) + e,
                          src + e);
        nvs::cp_async_commit();
      }
    }

    // pool: rows 2 rp, 2 rp + 1 in-thread, columns g, g + 1 from lane + 4;
    // lanes of even g hold pooled column c8 / 2 + g / 2. Bias and
    // activation after the max (both monotonic); the pooled tile through
    // the conv1 buffer, so that a channel's row goes out as two 16-byte
    // stores.
    float* so = s.u[i & 1].out;
#pragma unroll
    for (int j = 0; j < C2 / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = fmaxf(acc[4 * j + h], acc[4 * j + 2 + h]);
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        if (!(g & 1)) {
          const int ch = 8 * j + 2 * t + h;
          so[(rp * C2 + ch) * OUT + c8 / 2 + g / 2] =
              nvs::leaky(v + __ldg(b2 + ch), slope);
        }
      }
    bar_sync(kBarConsumers, kWideConsumers);
    const int py0 = ty * kPoolH, px0 = tx * kPoolW;
    float* ob = out + (long long)b * C2 * H2 * W2;
    if (W2 % 4 == 0) {  // px0 % 8 == 0: a float4 is wholly in or out
      for (int e = tid; e < kPoolH * C2 * 2; e += kWideConsumers) {
        const int q = e & 1, ch = (e >> 1) % C2, r = e / (2 * C2);
        if (py0 + r < H2 && px0 + 4 * q < W2)
          *reinterpret_cast<float4*>(ob + ((long long)ch * H2 + py0 + r) * W2
                                     + px0 + 4 * q) =
              *reinterpret_cast<const float4*>(so + (r * C2 + ch) * OUT
                                               + 4 * q);
      }
    } else {
      for (int e = tid; e < kPoolH * C2 * kPoolW; e += kWideConsumers) {
        const int c = e % kPoolW, ch = e / kPoolW % C2, r = e / (kPoolW * C2);
        if (py0 + r < H2 && px0 + c < W2)
          ob[((long long)ch * H2 + py0 + r) * W2 + px0 + c] =
              so[(r * C2 + ch) * OUT + c];
      }
    }
    // the producer waits for this buffer only if it has a tile for it
    if (tile + 2 * gridDim.x < ntiles)
      bar_arrive(kBarEmpty + (i & 1), kWideThreads);
  }
}

// scratch: at least (4*C1/8*32*4 + 2*9*C1*C2) floats, 16-byte aligned
template <int C1, int C2>
cudaError_t launch_wide(const float* x, const long long* sx, const float* w1,
                        const float* b1, const float* w2, const float* b2,
                        float* out, float* scratch, int B, int H, int W,
                        float slope, cudaStream_t stream) {
  constexpr int N1 = 4 * (C1 / 8) * 32, N2 = 9 * 2 * C1 * C2;
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
  float* p2 = scratch + 4 * N1;
  stem_pack_kernel<C1, C2><<<(N1 + N2 + 255) / 256, 256, 0, stream>>>(
      w1, w2, p1, p2);
  const cudaError_t perr = cudaGetLastError();
  if (perr != cudaSuccess) return perr;
  // one block an SM (its shared memory), each walking over tiles
  int dev = 0, sms = 0;
  cudaError_t aerr = cudaGetDevice(&dev);
  if (aerr == cudaSuccess)
    aerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (aerr != cudaSuccess) return aerr;
  const int tiles = (W / 2 + kPoolW - 1) / kPoolW *
                    ((H / 2 + kPoolH - 1) / kPoolH) * B;
  stem_wide_kernel<C1, C2><<<tiles < sms ? tiles : sms, kWideThreads, kSmem,
                             stream>>>(x, sx[0], sx[1], sx[2], sx[3], p1, p2,
                                       b1, b2, out, B, H, W, slope);
  return cudaGetLastError();
}

// ------------------------------------------- the bfloat16 instances

// The narrow instances' tile: kTileH conv2 rows (a warp a row pair) by
// kBfTileW columns (kBfMT m-tiles of 16 a row)
constexpr int kBfTileW = 32;
constexpr int kBfMT = kBfTileW / 16;
constexpr int kBfPoolW = kBfTileW / 2;
constexpr int kBfY1W = kBfTileW + 2, kBfY1Pix = kY1H * kBfY1W;  // ring tile
constexpr int kBfInW = kBfTileW + 4, kBfInPix = kInH * kBfInW;  // input
constexpr int kBfIn = 3 * kBfInPix;
constexpr int kBfThreads = 128;
constexpr int kBfWarps = kBfThreads / 32;
// input values a thread loads ahead, for the tile after the current one
constexpr int kBfHeld = (kBfIn + kBfThreads - 1) / kBfThreads;

template <int C1, int C2>
struct Bf16Cfg {
  static constexpr int KS = C1 / 16;  // conv2 k-steps a tap
  static constexpr int NT = C2 / 8;   // conv2 n-tiles
  static constexpr int NT1 = C1 / 8;  // conv1 n-tiles
  static constexpr int kPix = C1 + 8;  // bf16 a conv1 pixel
  static constexpr int kW1 = 3 * NT1 * 32;       // conv1's B fragments
  static constexpr int kW2 = 9 * KS * NT * 32;   // conv2's
  static constexpr int kRaw = C2 * C1 * 9 + C1 * kK1;  // the weights as given
};

template <int C1, int C2>
struct Bf16Smem {
  using Cfg = Bf16Cfg<C1, C2>;
  uint2 w2[Cfg::kW2];
  uint2 w1[Cfg::kW1];
  union {
    float raw[Cfg::kRaw];                    // the weights, once a block
    __nv_bfloat16 y1[kBfY1Pix * Cfg::kPix];  // conv1 tile, channel-last
  } u;
  alignas(16) __nv_bfloat16 out[kBfWarps][C2][kBfPoolW];  // a warp's own
  unsigned short x[kBfInPix * 4];  // input tile [r][c][ci], ci 3 zero
};

// conv1's B fragment e = (ks * C1/8 + nt) * 32 + lane, with g = lane / 4
// and t = lane % 4: k = 16 ks + 2t (+1) and 16 ks + 2t + 8 (+9) of output
// channel 8 nt + g (k = ci*9 + ky*3 + kx, zero from 27), rounded to bf16
template <int C1>
__device__ __forceinline__ uint2 w1_fragment(const float* w1, int e) {
  const int l = e & 31, g = l >> 2, t = l & 3;
  const int nt = (e >> 5) % (C1 / 8), k = (e >> 5) / (C1 / 8) * 16 + 2 * t;
  const float* wp = w1 + (nt * 8 + g) * kK1;
  auto w = [&](int kk) { return kk < kK1 ? wp[kk] : 0.f; };
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
  return make_uint2(nvs::pack_bf16(wp[0], wp[9]),
                    nvs::pack_bf16(wp[8 * 9], wp[9 * 9]));
}

// The narrow instances' conv1 B fragment e = (ks * C1/8 + nt) * 32 + lane:
// k = 16 ks + 2t (+1) and 16 ks + 2t + 8 (+9) of output channel 8 nt + g,
// with k = tap * 4 + ci (channel 3 and taps from 9 zero), rounded to bf16
template <int C1>
__device__ __forceinline__ uint2 w1_tap_fragment(const float* w1, int e) {
  const int l = e & 31, g = l >> 2, t = l & 3;
  const int nt = (e >> 5) % (C1 / 8), k = (e >> 5) / (C1 / 8) * 16 + 2 * t;
  const float* wp = w1 + (nt * 8 + g) * kK1;
  auto w = [&](int kk) {
    return kk < 36 && kk % 4 < 3 ? wp[kk % 4 * 9 + kk / 4] : 0.f;
  };
  return make_uint2(nvs::pack_bf16(w(k), w(k + 1)),
                    nvs::pack_bf16(w(k + 8), w(k + 9)));
}

template <int C1, int C2>
__global__ void __launch_bounds__(kBfThreads)
stem_bf16_kernel(const __nv_bfloat16* __restrict__ x, long long sx_b,
                 long long sx_h, long long sx_w, long long sx_c,
                 const float* __restrict__ w1, const float* __restrict__ w2,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 __nv_bfloat16* __restrict__ out, int B, int H, int W,
                 float slope) {
  using Cfg = Bf16Cfg<C1, C2>;
  static_assert(C1 % 16 == 0 && C2 % 8 == 0, "widths");
  constexpr int PIX = Cfg::kPix, KS = Cfg::KS, NT = Cfg::NT, NT1 = Cfg::NT1;
  constexpr int kT = kBfThreads, kW2Raw = C2 * C1 * 9;
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<Bf16Smem<C1, C2>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int H2 = H / 2, W2 = W / 2;
  const int nx = (W2 + kBfPoolW - 1) / kBfPoolW;
  const int ny = (H2 + kPoolH - 1) / kPoolH;
  const int ntiles = nx * ny * B;

  // the input values of a tile that this thread stages, zero outside the
  // image, loaded into registers a tile ahead
  unsigned short held[kBfHeld];
  auto load_input = [&](int tile) {
    const int b = tile / (nx * ny), ty = tile / nx % ny, tx = tile % nx;
    const int gy0 = ty * kTileH - 2, gx0 = tx * kBfTileW - 2;
    const __nv_bfloat16* xb = x + (long long)b * sx_b;
#pragma unroll
    for (int i = 0; i < kBfHeld; ++i) {
      const int e = tid + kT * i;
      const int ci = e / (kInH * kBfInW), r = e / kBfInW % kInH;
      const int gy = gy0 + r, gx = gx0 + e % kBfInW;
      held[i] = e < kBfIn && gy >= 0 && gy < H && gx >= 0 && gx < W
                    ? __bfloat16_as_ushort(
                          xb[gy * sx_h + gx * sx_w + ci * sx_c])
                    : (unsigned short)0;
    }
  };

  // 1. the weights, once a block: as given into shared memory (16-byte
  // loads, all in flight at once), then as B fragments rounded to bf16,
  // while the first tile's input loads; the lane's biases in registers
  // (channels 8 nt + 2t, + 1)
  if ((int)blockIdx.x < ntiles) load_input(blockIdx.x);
  if (((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) &
       15) == 0) {
    constexpr int N2 = kW2Raw / 4, N1 = C1 * kK1 / 4;
    constexpr int R2 = (N2 + kT - 1) / kT, R1 = (N1 + kT - 1) / kT;
    float4 v2[R2], v1[R1];
#pragma unroll
    for (int i = 0; i < R2; ++i)
      if (tid + kT * i < N2)
        v2[i] = __ldg(reinterpret_cast<const float4*>(w2) + tid + kT * i);
#pragma unroll
    for (int i = 0; i < R1; ++i)
      if (tid + kT * i < N1)
        v1[i] = __ldg(reinterpret_cast<const float4*>(w1) + tid + kT * i);
#pragma unroll
    for (int i = 0; i < R2; ++i)
      if (tid + kT * i < N2)
        reinterpret_cast<float4*>(s.u.raw)[tid + kT * i] = v2[i];
#pragma unroll
    for (int i = 0; i < R1; ++i)
      if (tid + kT * i < N1)
        reinterpret_cast<float4*>(s.u.raw + kW2Raw)[tid + kT * i] = v1[i];
  } else {
    for (int e = tid; e < kW2Raw; e += kT) s.u.raw[e] = __ldg(w2 + e);
    for (int e = tid; e < C1 * kK1; e += kT)
      s.u.raw[kW2Raw + e] = __ldg(w1 + e);
  }
  for (int e = tid; e < kBfInPix; e += kT) s.x[4 * e + 3] = 0;
  float b1r[NT1][2], b2r[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) b1r[nt][j] = __ldg(b1 + nt * 8 + 2 * t + j);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) b2r[nt][j] = __ldg(b2 + nt * 8 + 2 * t + j);
  __syncthreads();
  for (int e = tid; e < Cfg::kW2; e += kT)
    s.w2[e] = w2_fragment<C1, C2>(s.u.raw, e);
  for (int e = tid; e < Cfg::kW1; e += kT)
    s.w1[e] = w1_tap_fragment<C1>(s.u.raw + kW2Raw, e);
  // conv1's k = tap * 4 + ci: the lane's pairs k = 16 ks + 2t + 8 h (+1)
  // are channels (ci, ci + 1) of one input pixel, one 32-bit load, at
  // these offsets from the output pixel's (-1 past the nine taps)
  int koff[3][2];
#pragma unroll
  for (int ks = 0; ks < 3; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = ks * 16 + 2 * t + 8 * h, tap = k / 4;
      koff[ks][h] = tap < 9 ? (tap / 3 * kBfInW + tap % 3) * 4 + k % 4 : -1;
    }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (nx * ny), ty = tile / nx % ny, tx = tile % nx;
    const int oy0 = ty * kTileH, ox0 = tx * kBfTileW;
    __syncthreads();  // the fragments are built; the last tile's reads of
                      // s.u and s.x are done
#pragma unroll
    for (int i = 0; i < kBfHeld; ++i) {
      const int e = tid + kT * i;  // channel e / kBfInPix, pixel e % kBfInPix
      if (e < kBfIn) s.x[e % kBfInPix * 4 + e / kBfInPix] = held[i];
    }
    __syncthreads();

    // 2. conv1: m-tiles of 16 ring-tile pixels, warp, warp + 4, ..., two
    // at a time (independent sums)
    constexpr int M1 = (kBfY1Pix + 15) / 16;
    constexpr int M1W = (M1 + kBfWarps - 1) / kBfWarps;  // a warp's m-tiles
    for (int m2 = 0; m2 < M1W; m2 += 2) {
      int poff[2][2];  // m-tile j, rows g and g + 8: their pixel's offset
      bool live[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = warp + kBfWarps * (m2 + j);
        live[j] = m < M1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = min(m * 16 + g + 8 * r, kBfY1Pix - 1);
          poff[j][r] = (p / kBfY1W * kBfInW + p % kBfY1W) * 4;
        }
      }
      float acc[2][NT1][4] = {};
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
        uint32_t a[2][4];  // row g + 8 (q & 1), k pair 2t + 8 (q >> 1)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = koff[ks][q >> 1];
            a[j][q] = k >= 0 ? *reinterpret_cast<const uint32_t*>(
                                   s.x + poff[j][q & 1] + k)
                             : 0u;
          }
#pragma unroll
        for (int nt = 0; nt < NT1; ++nt) {
          const uint2 f = s.w1[(ks * NT1 + nt) * 32 + lane];
          const uint32_t bw[2] = {f.x, f.y};
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (live[j]) nvs::mma_bf16(acc[j][nt], a[j], bw);
        }
      }
      // bias and activation in float32, zero outside the image, rounded
      // to bf16 as conv2 reads it
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (warp + kBfWarps * (m2 + j)) * 16 + g + 8 * h;
          if (!live[j] || p >= kBfY1Pix) continue;
          const int gy = oy0 - 1 + p / kBfY1W, gx = ox0 - 1 + p % kBfY1W;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt) {
            const float v0 =
                in ? nvs::leaky(acc[j][nt][2 * h] + b1r[nt][0], slope) : 0.f;
            const float v1 =
                in ? nvs::leaky(acc[j][nt][2 * h + 1] + b1r[nt][1], slope)
                   : 0.f;
            *reinterpret_cast<uint32_t*>(s.u.y1 + p * PIX + nt * 8 + 2 * t) =
                nvs::pack_bf16(v0, v1);
          }
        }
    }
    __syncthreads();

    // 3. the next tile's input, in flight while conv2 runs: rows 2 rp + r
    // of the tile, m-tiles of columns 16 mb .. 16 mb + 15; a k-step is 16
    // channels of one tap
    if (tile + (int)gridDim.x < ntiles) load_input(tile + gridDim.x);
    const int rp = warp;
    float acc[2][kBfMT][NT][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // [row][m-tile][row g + 8 (q & 1), k + 8 (q >> 1)]
        uint32_t a[2][kBfMT][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int mb = 0; mb < kBfMT; ++mb)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              a[r][mb][q] = *reinterpret_cast<const uint32_t*>(
                  s.u.y1 +
                  ((2 * rp + r + ky) * kBfY1W + 16 * mb + g + 8 * (q & 1) +
                   kx) * PIX +
                  ks * 16 + 2 * t + 8 * (q >> 1));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 f = s.w2[((tap * KS + ks) * NT + nt) * 32 + lane];
          const uint32_t bw[2] = {f.x, f.y};
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int mb = 0; mb < kBfMT; ++mb)
              nvs::mma_bf16(acc[r][mb][nt], a[r][mb], bw);
        }
      }
    }

    // 4. pool as in stem_kernel, then bias and activation in float32, one
    // rounding to bf16; a channel's pooled row goes out as 16-byte runs
    __nv_bfloat16(*so)[kBfPoolW] = s.out[warp];
#pragma unroll
    for (int mb = 0; mb < kBfMT; ++mb)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = fmaxf(acc[0][mb][nt][i], acc[1][mb][nt][i]);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          if (!(g & 1))
            so[nt * 8 + 2 * t + (i & 1)][8 * mb + (i >> 1) * 4 + g / 2] =
                __float2bfloat16_rn(
                    nvs::leaky(v + b2r[nt][i & 1], slope));
        }
    __syncwarp();
    const int py = ty * kPoolH + rp, px0 = tx * kBfPoolW;
    if (py < H2) {
      __nv_bfloat16* orow = out + ((long long)b * C2 * H2 + py) * W2 + px0;
      if (W2 % 8 == 0) {  // px0 % 8 == 0: a run is wholly in or out
        constexpr int kRuns = kBfPoolW / 8;
        for (int e = lane; e < C2 * kRuns; e += 32) {
          const int cl = e / kRuns, h = e % kRuns;
          if (px0 + 8 * h < W2)
            *reinterpret_cast<uint4*>(orow + (long long)cl * H2 * W2 + 8 * h) =
                *reinterpret_cast<const uint4*>(&so[cl][8 * h]);
        }
      } else {
        for (int e = lane; e < C2 * kBfPoolW; e += 32) {
          const int cl = e / kBfPoolW, c = e % kBfPoolW;
          if (px0 + c < W2) orow[(long long)cl * H2 * W2 + c] = so[cl][c];
        }
      }
    }
  }
}

template <int C1, int C2>
cudaError_t launch_bf16(const __nv_bfloat16* x, const long long* sx,
                        const float* w1, const float* b1, const float* w2,
                        const float* b2, __nv_bfloat16* out, int B, int H,
                        int W, float slope, cudaStream_t stream) {
  constexpr int kSmem = sizeof(Bf16Smem<C1, C2>);
  cudaError_t err = nvs::once_per_device([] {
    return cudaFuncSetAttribute(stem_bf16_kernel<C1, C2>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem);
  });
  if (err != cudaSuccess) return err;
  // persistent: as many blocks as the card holds at once, each walking
  // over tiles
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, stem_bf16_kernel<C1, C2>, kBfThreads, kSmem)) !=
          cudaSuccess)
    return err;
  const long long tiles = (long long)((W / 2 + kBfPoolW - 1) / kBfPoolW) *
                          ((H / 2 + kPoolH - 1) / kPoolH) * B;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  stem_bf16_kernel<C1, C2>
      <<<(int)(tiles < slots ? tiles : slots), kBfThreads, kSmem, stream>>>(
          x, sx[0], sx[1], sx[2], sx[3], w1, w2, b1, b2, out, B, H, W, slope);
  return cudaGetLastError();
}

// ----------------------------------- the bfloat16 wide instance (64, 128)

// The roles of stem_bf16_wide_kernel: two consumer warpgroups (conv2,
// pool, store) and two producer warpgroups, one for each conv1 buffer
// (its tiles' input and conv1), at stem_wide_kernel's named barriers (the
// producer of buffer p at kBarProducer + p).
constexpr int kBwThreads = kWideConsumers + 2 * 128;

template <int C1, int C2>
struct Bf16WideSmem {
  static constexpr int kW2 = 9 * C1 * C2;        // bf16, wgmma B operands
  static constexpr int kW1 = 2 * (C1 / 8) * 32;  // uint2, conv1 fragments
  static constexpr int kPix = C1 + 8;            // bf16 a conv1 pixel
  __nv_bfloat16 w2[kW2];
  uint2 w1[2][kW1];  // a copy for each producer
  union alignas(16) Tile {
    __nv_bfloat16 y1[kY1Pix * kPix];            // conv1 tile
    __nv_bfloat16 out[kPoolH * C2 * kPoolW];  // then the pooled tile
  } u[2];
  unsigned short x[2][kIn];  // input tiles [ci][r][c], bf16 bits
};

// conv2's weights as wgmma B operands, a tap after another, then conv1's
// fragments (w1_fragment): input channel 16 s + k of output channel n at
// tap at bf16 (tap * C1/16 + s) * 16 * C2 + (k/8) * 8 * C2 + n*8 + k%8
// (K-major core matrices, 16 * C2 bytes apart along K); rounded to bf16
template <int C1, int C2>
__global__ void stem_pack_bf16_kernel(const float* __restrict__ w1,
                                      const float* __restrict__ w2,
                                      uint32_t* __restrict__ p) {
  constexpr int N2 = 9 * C1 * C2 / 2;  // bf16 pairs
  constexpr int N1 = Bf16WideSmem<C1, C2>::kW1;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < N2 + N1;
       e += gridDim.x * blockDim.x) {
    if (e < N2) {
      const int r = 2 * e % (C1 * C2), tap = 2 * e / (C1 * C2);
      const int ci = r / (16 * C2) * 16 + r / (8 * C2) % 2 * 8 + r % 8;
      const int n = r / 8 % C2;
      const float* wp = w2 + (n * C1 + ci) * 9 + tap;
      p[e] = nvs::pack_bf16(wp[0], wp[9]);
    } else {
      reinterpret_cast<uint2*>(p + N2)[e - N2] = w1_fragment<C1>(w1, e - N2);
    }
  }
}

template <int C1, int C2>
__global__ void __launch_bounds__(kBwThreads, 1)
stem_bf16_wide_kernel(const __nv_bfloat16* __restrict__ x, long long sx_b,
                      long long sx_h, long long sx_w, long long sx_c,
                      const uint4* __restrict__ packed,
                      const float* __restrict__ b1,
                      const float* __restrict__ b2,
                      __nv_bfloat16* __restrict__ out, int B, int H, int W,
                      float slope) {
  static_assert(C1 == 64 && C2 == 128, "the wgmma shapes are (64, 128)'s");
  using Smem = Bf16WideSmem<C1, C2>;
  constexpr int PIX = Smem::kPix, NT1 = C1 / 8, NT1W = NT1 / 2;
  constexpr int KS = C1 / 16;  // conv2 k-steps a tap
  constexpr int kFull = kWideConsumers + 128;  // threads at a buffer's barrier
  extern __shared__ float4 smem_raw[];
  auto& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const int H2 = H / 2, W2 = W / 2;
  const int nx = (W2 + kPoolW - 1) / kPoolW, ny = (H2 + kPoolH - 1) / kPoolH;
  const int ntiles = nx * ny * B;
  // block b's tiles are b, b + grid, b + 2 grid, ...: its i-th in buffer
  // s.u[i & 1], from producer i & 1

  if (tid >= kWideConsumers) {
    // a producer: its tiles' input, zero outside the image; conv1 on
    // mma.sync (a warp's unit: an m-tile of 16 ring-tile pixels and half
    // the n-tiles), bias and activation in float32, zero outside the
    // image, rounded to bf16 as conv2 reads it
    const int pr = (tid - kWideConsumers) >> 7, pw = warp & 3;
    const int ptid = tid & 127;
    // conv1's fragments, once a block (each producer its own copy's
    // share of them, behind its own barrier)
    {
      constexpr int n16 = Smem::kW1 * 8 / 16;
      const uint4* src = packed + Smem::kW2 * 2 / 16;
      for (int e = ptid; e < n16; e += 128)
        nvs::cp_async16(reinterpret_cast<uint4*>(s.w1[pr]) + e, src + e);
      nvs::cp_async_commit();
      nvs::cp_async_wait<0>();
    }
    unsigned short* xs = s.x[pr];
    __nv_bfloat16* y1 = s.u[pr].y1;
    // the warp's units are m-tiles pw / 2, pw / 2 + 2, ... of n-tiles
    // n0 .. n0 + NT1W - 1: their B fragments and biases stay in registers
    constexpr int M1 = (kY1Pix + 15) / 16;
    const int n0 = (pw & 1) * NT1W;
    uint2 w1f[2][NT1W];
    float b1r[NT1W][2];
    bar_sync(kBarProducer + pr, 128);  // every share of s.w1[pr] is in
#pragma unroll
    for (int nt = 0; nt < NT1W; ++nt) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        w1f[ks][nt] = s.w1[pr][(ks * NT1 + n0 + nt) * 32 + lane];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        b1r[nt][j] = __ldg(b1 + (n0 + nt) * 8 + 2 * t + j);
    }
    // the lane's conv1 k = 16 ks + 2t + (j & 1) + 8 (j >> 1) as offsets
    // into the input tile, -1 from 27
    int koff[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = ks * 16 + 2 * t + (j & 1) + 8 * (j >> 1);
        koff[ks][j] =
            k < kK1 ? k / 9 * kInH * kInW + k % 9 / 3 * kInW + k % 3 : -1;
      }
    for (int tile = blockIdx.x + pr * gridDim.x, i = pr; tile < ntiles;
         tile += 2 * gridDim.x, i += 2) {
      const int b = tile / (nx * ny), ty = tile / nx % ny, tx = tile % nx;
      const int oy0 = ty * kTileH, ox0 = tx * kTileW;
      const __nv_bfloat16* xb = x + (long long)b * sx_b;
      bar_sync(kBarProducer + pr, 128);  // its warps are done with xs
      for (int e = ptid; e < kIn; e += 128) {
        const int ci = e / (kInH * kInW), r = e / kInW % kInH, c = e % kInW;
        const int gy = oy0 - 2 + r, gx = ox0 - 2 + c;
        xs[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    ? __bfloat16_as_ushort(xb[gy * sx_h + gx * sx_w +
                                              ci * sx_c])
                    : (unsigned short)0;
      }
      bar_sync(kBarProducer + pr, 128);
      if (i >= 2) bar_sync(kBarEmpty + pr, kFull);
      for (int m = pw >> 1; m < M1; m += 2) {
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
            const int k0 = koff[ks][2 * (q >> 1)];
            const int k1 = koff[ks][2 * (q >> 1) + 1];
            const uint32_t lo = k0 >= 0 ? xs[k0 + poff[q & 1]] : 0u;
            const uint32_t hi = k1 >= 0 ? xs[k1 + poff[q & 1]] : 0u;
            a[q] = lo | hi << 16;
          }
#pragma unroll
          for (int nt = 0; nt < NT1W; ++nt) {
            const uint32_t bw[2] = {w1f[ks][nt].x, w1f[ks][nt].y};
            nvs::mma_bf16(acc[nt], a, bw);
          }
        }
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
                in ? nvs::leaky(acc[nt][2 * h] + b1r[nt][0], slope) : 0.f;
            const float v1 =
                in ? nvs::leaky(acc[nt][2 * h + 1] + b1r[nt][1], slope) : 0.f;
            *reinterpret_cast<uint32_t*>(y1 + p * PIX + ch) =
                nvs::pack_bf16(v0, v1);
          }
        }
      }
      bar_arrive(kBarFull + pr, kFull);
    }
    return;
  }

  // The consumers: conv2 on wgmma, one chain of float32 sums over the 9
  // taps x C1 channels. Warp w4 of warpgroup wg takes row pair rp, columns
  // c8 .. c8 + 7 (rows g and g + 8 of its 16: conv2 rows 2 rp, 2 rp + 1);
  // a k-step is 16 channels of one tap, its A registers those of the
  // k-step before last.
  const int rp = 2 * (warp >> 2) + ((warp & 3) >> 1), c8 = 8 * (warp & 1);
  const uint64_t desc0 = wgmma_desc(s.w2, 8 * C2 * 2);
  // conv2's weights, once a block, while the producers start
  for (int e = tid; e < Smem::kW2 * 2 / 16; e += kWideConsumers)
    nvs::cp_async16(reinterpret_cast<uint4*>(s.w2) + e, packed + e);
  nvs::cp_async_commit();
  nvs::cp_async_wait<0>();
  fence_async_shared();
  bar_sync(kBarConsumers, kWideConsumers);
  for (int tile = blockIdx.x, i = 0; tile < ntiles; tile += gridDim.x, ++i) {
    const int b = tile / (nx * ny), ty = tile / nx % ny, tx = tile % nx;
    auto& u = s.u[i & 1];
    bar_sync(kBarFull + (i & 1), kFull);
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    fence_regs(acc);
    const __nv_bfloat16* pa0 = u.y1 + (2 * rp * kY1W + c8 + g) * PIX + 2 * t;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const __nv_bfloat16* pa = pa0 + (tap / 3 * kY1W + tap % 3) * PIX;
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int buf = ks & 1;
        wgmma_wait<1>();
        a[buf][0] = *reinterpret_cast<const uint32_t*>(pa + 16 * ks);
        a[buf][1] =
            *reinterpret_cast<const uint32_t*>(pa + kY1W * PIX + 16 * ks);
        a[buf][2] = *reinterpret_cast<const uint32_t*>(pa + 16 * ks + 8);
        a[buf][3] =
            *reinterpret_cast<const uint32_t*>(pa + kY1W * PIX + 16 * ks + 8);
        wgmma_fence();
        // a k-step's B is 16 * C2 * 2 bytes (>> 4 in the descriptor)
        wgmma_bf16_n128(acc, a[buf], desc0 + (tap * KS + ks) * 2 * C2, 1);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    bar_sync(kBarConsumers, kWideConsumers);  // every consumer is done with
                                              // u.y1

    // pool as in stem_wide_kernel, then bias and activation in float32,
    // one rounding to bf16; a channel's row of 8 pooled columns goes out
    // as one 16-byte store
#pragma unroll
    for (int j = 0; j < C2 / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = fmaxf(acc[4 * j + h], acc[4 * j + 2 + h]);
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        if (!(g & 1)) {
          const int ch = 8 * j + 2 * t + h;
          u.out[(rp * C2 + ch) * kPoolW + c8 / 2 + g / 2] =
              __float2bfloat16_rn(nvs::leaky(v + __ldg(b2 + ch), slope));
        }
      }
    bar_sync(kBarConsumers, kWideConsumers);
    const int py0 = ty * kPoolH, px0 = tx * kPoolW;
    __nv_bfloat16* ob = out + (long long)b * C2 * H2 * W2;
    if (W2 % 8 == 0) {  // px0 % 8 == 0: a row is wholly in or out
      for (int e = tid; e < kPoolH * C2; e += kWideConsumers) {
        const int ch = e % C2, r = e / C2;
        if (py0 + r < H2 && px0 < W2)
          *reinterpret_cast<uint4*>(ob + ((long long)ch * H2 + py0 + r) * W2
                                    + px0) =
              *reinterpret_cast<const uint4*>(u.out + e * kPoolW);
      }
    } else {
      for (int e = tid; e < kPoolH * C2 * kPoolW; e += kWideConsumers) {
        const int c = e % kPoolW, ch = e / kPoolW % C2, r = e / (kPoolW * C2);
        if (py0 + r < H2 && px0 + c < W2)
          ob[((long long)ch * H2 + py0 + r) * W2 + px0 + c] = u.out[e];
      }
    }
    // the producer waits for this buffer only if it has a tile for it
    if (tile + 2 * gridDim.x < ntiles)
      bar_arrive(kBarEmpty + (i & 1), kFull);
  }
}

// scratch: (9*C1*C2/2 + 2*kW1) 32-bit words, 16-byte aligned
template <int C1, int C2>
cudaError_t launch_bf16_wide(const __nv_bfloat16* x, const long long* sx,
                             const float* w1, const float* b1,
                             const float* w2, const float* b2,
                             __nv_bfloat16* out, void* scratch, int B, int H,
                             int W, float slope, cudaStream_t stream) {
  using Smem = Bf16WideSmem<C1, C2>;
  constexpr int kSmem = sizeof(Smem);
  constexpr int N = 9 * C1 * C2 / 2 + Smem::kW1;
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = nvs::once_per_device([] {
    return cudaFuncSetAttribute(stem_bf16_wide_kernel<C1, C2>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem);
  });
  if (err != cudaSuccess) return err;
  uint32_t* packed = static_cast<uint32_t*>(scratch);
  stem_pack_bf16_kernel<C1, C2><<<(N + 255) / 256, 256, 0, stream>>>(
      w1, w2, packed);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // one block an SM (its shared memory), each walking over tiles
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int tiles = (W / 2 + kPoolW - 1) / kPoolW *
                    ((H / 2 + kPoolH - 1) / kPoolH) * B;
  stem_bf16_wide_kernel<C1, C2><<<tiles < sms ? tiles : sms, kBwThreads,
                                  kSmem, stream>>>(
      x, sx[0], sx[1], sx[2], sx[3], reinterpret_cast<const uint4*>(packed),
      b1, b2, out, B, H, W, slope);
  return cudaGetLastError();
}

}  // namespace

// x (B,H,W,3) with element strides [b, h, w, c]; w1 (C1,3,3,3) and
// w2 (C2,C1,3,3) contiguous OIHW; out contiguous NCHW (B,C2,H/2,W/2),
// floor for an odd H or W (the pool's last row and column pair are conv2's
// rows H-3, H-2 and columns W-3, W-2; conv2's SAME padding reads conv1 up
// to row H-1, which the tile bounds-checks against the full H, W);
// scratch: the wide instance's weights as stem_pack_kernel writes them,
// 2*9*C1*C2 + 64*C1 floats, 16-byte aligned (unused, and may be null, for
// the narrow ones).
extern "C" int nvs_stem_pair_pool(const float* x, const long long* sx,
                                  const float* w1, const float* b1,
                                  const float* w2, const float* b2,
                                  float* out, float* scratch, int B, int H,
                                  int W, int C1, int C2, float slope,
                                  cudaStream_t stream) {
  if (H < 2 || W < 2 || B < 1 || B > 65535 ||
      (H / 2 + kPoolH - 1) / kPoolH > 65535 ||
      (long long)((W / 2 + kPoolW - 1) / kPoolW) *
              ((H / 2 + kPoolH - 1) / kPoolH) * B >
          0x7fffffffLL)
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
// (64, 128), the weights as stem_pack_bf16_kernel writes them, 9*C1*C2/2
// + 16*C1 floats, 16-byte aligned.
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
    return (int)launch_bf16<16, 24>(x, sx, w1, b1, w2, b2, out, B, H, W,
                                    slope, stream);
  if (C1 == 16 && C2 == 32)
    return (int)launch_bf16<16, 32>(x, sx, w1, b1, w2, b2, out, B, H, W,
                                    slope, stream);
  if (C1 == 64 && C2 == 128)
    return (int)launch_bf16_wide<64, 128>(x, sx, w1, b1, w2, b2, out,
                                          scratch, B, H, W, slope, stream);
  return (int)cudaErrorInvalidValue;
}
