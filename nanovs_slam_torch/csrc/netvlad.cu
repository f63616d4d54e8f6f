// Fused NetVLAD aggregation.
//
// Replaces the TPU kernel nanovs_slam_tpu/ops/pallas/netvlad_kernel.py
// (netvlad_pallas). For each image x (S pixels, C channels), assignment
// weights W (C, K) and centroids (K, C):
//   x_s   <- x_s / max(sqrt(|x_s|^2 + eps^2), eps)       (per pixel)
//   a_s   <- softmax_k(x_s W)
//   vlad  <- sum_s a_s^T x_s - (sum_s a_s) * centroids   (K, C)
//   vlad  <- intra-normalise per cluster, then global L2 over K*C
// with the normalisation of the module (modules/aggregators.NetVLAD).
// The (K, C, S) residual tensor is never formed.
//
// Design: pass 1 splits the S pixels of each image over P blocks. A block
// streams 32-pixel tiles through shared memory, normalises each pixel and
// computes its K logits and softmax with one warp per pixel, and adds
// a^T x and sum a into K*C + K sums in shared memory; it writes them as one
// partial. Pass 2, one block per image, adds the P partials, subtracts the
// centroid term and normalises. The TPU kernel carried everything in one
// grid step per image; on Hopper one block per image would leave the card
// idle at batch 1.
//
// Bound on an H100: operations, barely. At 240x320 (S = 4800, C = 48,
// K = 32) an image is 2 * 2*S*C*K = 29.5 MFLOP against 0.9 MB read, about
// 0.44 us at 67 TFLOP/s (float32, CUDA cores) and 0.28 us at 3.35 TB/s.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileS = 32;
constexpr int kMaxK = 64;  // two clusters per lane
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float l2_denominator(float sumsq) {
  return fmaxf(sqrtf(sumsq + kEps * kEps), kEps);
}

__global__ void __launch_bounds__(kThreads)
netvlad_partial_kernel(const float* __restrict__ x, long long sx_b,
                       long long sx_s, long long sx_c,
                       const float* __restrict__ assign_w,
                       float* __restrict__ partial, int S, int C, int K,
                       int pixels_per_block) {
  extern __shared__ float smem[];
  const int ldx = C + 1;  // padded row: no bank conflicts on the tile store
  float* s_w = smem;                       // C*K
  float* s_x = s_w + C * K;                // kTileS*(C+1)
  float* s_a = s_x + kTileS * ldx;         // kTileS*K
  float* s_acc = s_a + kTileS * K;         // K*C
  float* s_mass = s_acc + K * C;           // K

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int s_begin = blockIdx.x * pixels_per_block;
  const int s_end = min(S, s_begin + pixels_per_block);
  const float* xb = x + (long long)b * sx_b;

  for (int e = tid; e < C * K; e += kThreads) {
    s_w[e] = assign_w[e];
    s_acc[e] = 0.f;
  }
  for (int e = tid; e < K; e += kThreads) s_mass[e] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += kTileS) {
    __syncthreads();
    for (int e = tid; e < kTileS * C; e += kThreads) {
      const int s = e % kTileS, c = e / kTileS;
      s_x[s * ldx + c] = (s0 + s < s_end) ? xb[(s0 + s) * sx_s + c * sx_c]
                                          : 0.f;
    }
    __syncthreads();
    for (int s = warp; s < kTileS; s += kWarps) {
      float* xs = s_x + s * ldx;
      float ss = 0.f;
      for (int c = lane; c < C; c += 32) ss += xs[c] * xs[c];
      const float den = l2_denominator(nvs::warp_sum(ss));
      __syncwarp();
      for (int c = lane; c < C; c += 32) xs[c] /= den;
      __syncwarp();
      const float neg_inf = -__int_as_float(0x7f800000);
      float lg[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = lane + 32 * q;
        if (k < K) {
          float acc = 0.f;
          for (int c = 0; c < C; ++c) acc = fmaf(xs[c], s_w[c * K + k], acc);
          lg[q] = acc;
        }
      }
      const float m = nvs::warp_max(fmaxf(lg[0], lg[1]));
      float ex[2];
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        ex[q] = (lane + 32 * q < K) ? expf(lg[q] - m) : 0.f;
        sum += ex[q];
      }
      sum = nvs::warp_sum(sum);
      const bool valid = s0 + s < s_end;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = lane + 32 * q;
        if (k < K) s_a[s * K + k] = valid ? ex[q] / sum : 0.f;
      }
    }
    __syncthreads();
    for (int e = tid; e < K * C; e += kThreads) {
      const int k = e / C, c = e % C;
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < kTileS; ++s)
        acc = fmaf(s_a[s * K + k], s_x[s * ldx + c], acc);
      s_acc[e] += acc;
    }
    for (int k = tid; k < K; k += kThreads) {
      float acc = 0.f;
      for (int s = 0; s < kTileS; ++s) acc += s_a[s * K + k];
      s_mass[k] += acc;
    }
  }
  __syncthreads();
  float* out = partial + ((long long)b * gridDim.x + blockIdx.x) * (K * C + K);
  for (int e = tid; e < K * C; e += kThreads) out[e] = s_acc[e];
  for (int e = tid; e < K; e += kThreads) out[K * C + e] = s_mass[e];
}

__global__ void __launch_bounds__(kThreads)
netvlad_finish_kernel(const float* __restrict__ partial,
                      const float* __restrict__ centroids,
                      float* __restrict__ out, int C, int K, int P) {
  extern __shared__ float smem[];
  float* s_v = smem;           // K*C
  float* s_mass = s_v + K * C;  // K
  float* s_red = s_mass + K;    // kWarps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int n = K * C + K;
  const float* pb = partial + (long long)b * P * n;

  for (int e = tid; e < n; e += kThreads) {
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc += pb[(long long)p * n + e];
    smem[e] = acc;  // s_v then s_mass, contiguous
  }
  __syncthreads();
  for (int e = tid; e < K * C; e += kThreads)
    s_v[e] -= s_mass[e / C] * centroids[e];
  __syncthreads();
  // intra-normalisation: one warp per cluster
  for (int k = warp; k < K; k += kWarps) {
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) ss += s_v[k * C + c] * s_v[k * C + c];
    const float den = l2_denominator(nvs::warp_sum(ss));
    __syncwarp();
    for (int c = lane; c < C; c += 32) s_v[k * C + c] /= den;
  }
  __syncthreads();
  float ss = 0.f;
  for (int e = tid; e < K * C; e += kThreads) ss += s_v[e] * s_v[e];
  ss = nvs::warp_sum(ss);
  if (lane == 0) s_red[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s_red[w];
  const float den = l2_denominator(total);
  for (int e = tid; e < K * C; e += kThreads)
    out[(long long)b * K * C + e] = s_v[e] / den;
}

}  // namespace

// x (B,S,C) with element strides [b, s, c]; assign_w (C,K), centroids (K,C)
// contiguous; partial (B,P,K*C+K) scratch; out contiguous (B, K*C).
extern "C" int nvs_netvlad(const float* x, const long long* sx,
                           const float* assign_w, const float* centroids,
                           float* partial, float* out, int B, int S, int C,
                           int K, int P, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || C < 1 || S < 1 || P < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem1 =
      sizeof(float) * (C * K + kTileS * (C + 1) + kTileS * K + K * C + K);
  const size_t smem2 = sizeof(float) * (K * C + K + kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      netvlad_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(netvlad_finish_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const int per_block = (S + P - 1) / P;
  netvlad_partial_kernel<<<dim3(P, B), kThreads, smem1, stream>>>(
      x, sx[0], sx[1], sx[2], assign_w, partial, S, C, K, per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  netvlad_finish_kernel<<<B, kThreads, smem2, stream>>>(partial, centroids,
                                                        out, C, K, P);
  return (int)cudaGetLastError();
}
