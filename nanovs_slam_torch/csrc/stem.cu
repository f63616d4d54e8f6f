// Fused backbone stem: conv3x3(3 -> C1) + bias, LeakyReLU (slope 0.01, or
// 0 for the ReLU of the MCU configs), conv3x3(C1 -> C2) + bias, LeakyReLU,
// 2x2 max-pool; SAME padding, with the
// conv1 positions outside the image zeroed before conv2. The biases are the
// folded BatchNorm of conv1a/conv1b.
//
// Replaces the TPU kernel nanovs_slam_tpu/ops/pallas/fused_stem.py
// (fused_stem_pair_pool). On the TPU the 3-channel minor dim was padded to
// (8, 128) tiles, which inflated its traffic 43.7x, so the JAX package left
// the kernel off its path. Hopper has no such tiling rule.
//
// Design: a tiled direct convolution. A block owns an 8x8 tile of pooled
// outputs (16x16 conv2 outputs). It stages the 20x20x3 halo'd input tile in
// shared memory, computes conv1 (C1 channels) over the 18x18 tile plus ring
// into shared memory, then each thread computes 4 conv2 outputs for C2/4
// channels, applies bias and LeakyReLU, and writes only the pooled maximum.
// Neither conv1 nor the full-resolution conv2 output touches device memory.
//
// Bound on an H100: operations. At 240x320, C1 = 16, C2 = 24 a frame is
// 0.60 GFLOP (conv2 0.53) against 2.8 MB of input and output, about 9 us at
// the 67 TFLOP/s float32 rate of the CUDA cores (no tensor cores here).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kTile = 8;             // pooled outputs per block side
constexpr int kOut = 2 * kTile;      // conv2 outputs per block side
constexpr int kY1 = kOut + 2;        // conv1 tile side (with ring)
constexpr int kIn = kOut + 4;        // input tile side (with halo)
constexpr int kThreads = 4 * kTile * kTile;  // 64 pooled positions x 4

template <int C1, int C2>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ x, long long sx_b, long long sx_h,
            long long sx_w, long long sx_c, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ out, int H,
            int W, float slope) {
  static_assert(C2 % 4 == 0, "C2 must be a multiple of 4");
  constexpr int CPT = C2 / 4;  // conv2 channels per thread
  __shared__ float s_x[3][kIn][kIn];
  __shared__ float s_y1[C1][kY1][kY1];
  __shared__ float s_w1[C1 * 27];
  __shared__ float s_w2[C2 * C1 * 9];
  __shared__ float s_b1[C1];
  __shared__ float s_b2[C2];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kOut;  // first conv2 row of the tile
  const int ox0 = blockIdx.x * kOut;
  const float* xb = x + (long long)b * sx_b;

  for (int e = tid; e < 3 * kIn * kIn; e += kThreads) {
    const int ci = e / (kIn * kIn);
    const int r = (e / kIn) % kIn;
    const int c = e % kIn;
    const int gy = oy0 - 2 + r, gx = ox0 - 2 + c;
    s_x[ci][r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? xb[gy * sx_h + gx * sx_w + ci * sx_c]
                        : 0.f;
  }
  for (int e = tid; e < C1 * 27; e += kThreads) s_w1[e] = w1[e];
  for (int e = tid; e < C2 * C1 * 9; e += kThreads) s_w2[e] = w2[e];
  for (int e = tid; e < C1; e += kThreads) s_b1[e] = b1[e];
  for (int e = tid; e < C2; e += kThreads) s_b2[e] = b2[e];
  __syncthreads();

  // conv1 over the tile and its one-pixel ring; zero outside the image.
  // Each thread takes two positions in straight-line code and loads each
  // weight once for both (a loop over positions lets the compiler hoist all
  // C1*27 weights into registers, which spills).
  static_assert(kY1 * kY1 <= 2 * kThreads, "two conv1 positions per thread");
  {
    const int p0 = tid, p1 = tid + kThreads;
    const bool has1 = p1 < kY1 * kY1;
    const int r0 = p0 / kY1, c0 = p0 % kY1;
    const int r1 = has1 ? p1 / kY1 : 0, c1 = has1 ? p1 % kY1 : 0;
    float acc0[C1], acc1[C1];
#pragma unroll
    for (int co = 0; co < C1; ++co) acc0[co] = acc1[co] = 0.f;
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v0 = s_x[ci][r0 + ky][c0 + kx];
          const float v1 = s_x[ci][r1 + ky][c1 + kx];
#pragma unroll
          for (int co = 0; co < C1; ++co) {
            const float w = s_w1[co * 27 + ci * 9 + ky * 3 + kx];
            acc0[co] = fmaf(w, v0, acc0[co]);
            acc1[co] = fmaf(w, v1, acc1[co]);
          }
        }
    const int gy0 = oy0 - 1 + r0, gx0 = ox0 - 1 + c0;
    const int gy1 = oy0 - 1 + r1, gx1 = ox0 - 1 + c1;
    const bool in0 = gy0 >= 0 && gy0 < H && gx0 >= 0 && gx0 < W;
    const bool in1 = gy1 >= 0 && gy1 < H && gx1 >= 0 && gx1 < W;
#pragma unroll
    for (int co = 0; co < C1; ++co) {
      s_y1[co][r0][c0] = in0 ? nvs::leaky(acc0[co] + s_b1[co], slope) : 0.f;
      if (has1)
        s_y1[co][r1][c1] = in1 ? nvs::leaky(acc1[co] + s_b1[co], slope) : 0.f;
    }
  }
  __syncthreads();

  // conv2: thread -> one pooled position, CPT output channels, 4 phases
  const int pos = tid % (kTile * kTile);
  const int grp = tid / (kTile * kTile);
  const int py = pos / kTile, px = pos % kTile;
  float acc[CPT][4];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;

  for (int ci = 0; ci < C1; ++ci) {
    float patch[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) patch[a][c] = s_y1[ci][2 * py + a][2 * px + c];
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const float* wk = s_w2 + ((grp * CPT + k) * C1 + ci) * 9;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float w = wk[ky * 3 + kx];
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              acc[k][dy * 2 + dx] =
                  fmaf(w, patch[dy + ky][dx + kx], acc[k][dy * 2 + dx]);
        }
    }
  }

  const int H2 = H / 2, W2 = W / 2;
  const int oy = blockIdx.y * kTile + py, ox = blockIdx.x * kTile + px;
  if (oy < H2 && ox < W2) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int co = grp * CPT + k;
      float m = nvs::leaky(acc[k][0] + s_b2[co], slope);
#pragma unroll
      for (int q = 1; q < 4; ++q) m = fmaxf(m, nvs::leaky(acc[k][q] + s_b2[co], slope));
      out[(((long long)b * C2 + co) * H2 + oy) * W2 + ox] = m;
    }
  }
}

template <int C1, int C2>
void launch(const float* x, const long long* sx, const float* w1,
            const float* b1, const float* w2, const float* b2, float* out,
            int B, int H, int W, float slope, cudaStream_t stream) {
  const dim3 grid((W / 2 + kTile - 1) / kTile, (H / 2 + kTile - 1) / kTile, B);
  stem_kernel<C1, C2><<<grid, kThreads, 0, stream>>>(
      x, sx[0], sx[1], sx[2], sx[3], w1, b1, w2, b2, out, H, W, slope);
}

}  // namespace

// x (B,H,W,3) with element strides [b, h, w, c]; w1 (C1,3,3,3) and
// w2 (C2,C1,3,3) contiguous OIHW; out contiguous NCHW (B,C2,H/2,W/2).
extern "C" int nvs_stem_pair_pool(const float* x, const long long* sx,
                                  const float* w1, const float* b1,
                                  const float* w2, const float* b2,
                                  float* out, int B, int H, int W, int C1,
                                  int C2, float slope, cudaStream_t stream) {
  if (H % 2 || W % 2 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (C1 == 16 && C2 == 24) {
    launch<16, 24>(x, sx, w1, b1, w2, b2, out, B, H, W, slope, stream);
  } else if (C1 == 16 && C2 == 32) {
    launch<16, 32>(x, sx, w1, b1, w2, b2, out, B, H, W, slope, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
