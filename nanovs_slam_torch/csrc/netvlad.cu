// Fused NetVLAD aggregation, one launch a call.
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
// Design. A block takes kTile = 64 pixels of one image in one pass: it
// stages them and W in shared memory, computes each pixel's K logits with
// four threads a pixel (the pixel's squared norm in the same loop), the
// softmax with two shuffles, and a^T x and sum a with a register tile of
// 2-4 clusters by 4-8 channels a thread. At 240x320 (S = 4800) that is
// 75 blocks at batch 1 (80 with the cluster padding), B times that at
// batch B. Blocks form thread-block clusters of kCluster = 8: each rank
// adds one slice of the eight blocks' sums through distributed shared
// memory and writes it as the cluster's partial. A per-image counter in
// global memory (atomicAdd after a __threadfence) finds the last cluster;
// it adds the cluster partials in a fixed order, subtracts the centroid
// term, normalises each cluster's row (one warp a row) and, after an
// exchange of the eight ranks' sums of squares, the whole vector. Every sum
// runs in a fixed order, so the result is the same from run to run. The
// last cluster sets the counter back to 0, so the scratch is reused by the
// next launch on the stream without a reset.
//
// Bound on an H100: operations, barely. At 240x320 (S = 4800, C = 48,
// K = 32) an image is 2 * 2*S*C*K = 29.5 MFLOP against 0.9 MB read, about
// 0.44 us at 67 TFLOP/s (float32, CUDA cores) and 0.28 us at 3.35 TB/s. The
// kernel is bound by the latency of its chain (stage, logits, sums, cluster
// reduce, last-cluster finish), which the design keeps to one pass.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // pixels a block
constexpr int kCluster = 8;     // blocks a cluster
constexpr int kMaxK = 64;
constexpr int kMaxC = 128;
constexpr int kCGroups = 16;    // channel groups of the a^T x tile
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float l2_denominator(float sumsq) {
  return fmaxf(sqrtf(sumsq + kEps * kEps), kEps);
}

struct Args {
  const float* x;  // (B, S, C) with element strides sx_b, sx_s, sx_c
  long long sx_b, sx_s, sx_c;
  const float* assign_w;   // (C, K)
  const float* centroids;  // (K, C)
  float* partial;          // (B, n_clusters, K*C + K)
  unsigned int* counter;   // (B), 0 between launches
  float* out;              // (B, K*C)
  int S, C, K;
};

// KPT: clusters a thread takes in the logits (K <= 4 * KPT); RK, RC:
// clusters and channels a thread takes in the a^T x tile
// (K <= (kThreads / kCGroups) * RK, C <= kCGroups * RC).
template <int KPT, int RK, int RC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
netvlad_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int C = a.C, K = a.K, ldx = C + 1, lda = K + 1;
  float* s_w = reinterpret_cast<float*>(smem4);  // C*K
  float* s_x = s_w + C * K;                      // kTile*(C+1); later sums
  float* s_a = s_x + kTile * ldx;                // kTile*(K+1)
  float* s_inv = s_a + kTile * lda;              // kTile
  float* s_red = s_inv + kTile;                  // kWarps
  __shared__ float s_rank_ss;
  __shared__ int s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kTile;
  const int n = min(kTile, a.S - s0);  // may be <= 0: a padding block
  const float* xb = a.x + (long long)b * a.sx_b;

  // stage W and the tile (zeros past the image's last pixel)
  for (int e = tid; e < C * K; e += kThreads) s_w[e] = a.assign_w[e];
  if (a.sx_c == 1) {  // NHWC memory: neighbouring threads, channels
    for (int e = tid; e < kTile * C; e += kThreads) {
      const int s = e / C, c = e % C;
      s_x[s * ldx + c] = s < n ? xb[(long long)(s0 + s) * a.sx_s + c] : 0.f;
    }
  } else {  // NCHW memory: neighbouring threads, pixels
    for (int e = tid; e < kTile * C; e += kThreads) {
      const int s = e % kTile, c = e / kTile;
      s_x[s * ldx + c] =
          s < n ? xb[(long long)(s0 + s) * a.sx_s + (long long)c * a.sx_c]
                : 0.f;
    }
  }
  __syncthreads();

  // logits and softmax: four threads a pixel, cluster k = j + 4u
  {
    const int p = tid >> 2, j = tid & 3;
    const float* xs = s_x + p * ldx;
    float acc[KPT];
#pragma unroll
    for (int u = 0; u < KPT; ++u) acc[u] = 0.f;
    float ss = 0.f;
    for (int c = 0; c < C; ++c) {
      const float xc = xs[c];
      ss = fmaf(xc, xc, ss);
      const float* wr = s_w + c * K + j;
#pragma unroll
      for (int u = 0; u < KPT; ++u)
        if (j + 4 * u < K) acc[u] = fmaf(xc, wr[4 * u], acc[u]);
    }
    const float den = l2_denominator(ss);
    const float neg_inf = -__int_as_float(0x7f800000);
    float m = neg_inf;
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      acc[u] = j + 4 * u < K ? acc[u] / den : neg_inf;
      m = fmaxf(m, acc[u]);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      acc[u] = expf(acc[u] - m);  // 0 past K
      sum += acc[u];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const bool valid = p < n;
#pragma unroll
    for (int u = 0; u < KPT; ++u)
      if (j + 4 * u < K)
        s_a[p * lda + j + 4 * u] = valid ? acc[u] / sum : 0.f;
    if (j == 0) s_inv[p] = 1.f / den;
  }
  __syncthreads();

  // a^T x and sum a: thread (kg, cg) owns clusters kg + 16 r, channels
  // cg + 16 i; every thread of a kg sums the mass, cg == 0 keeps it
  const int cgp = tid % kCGroups, kg = tid / kCGroups;
  constexpr int kKGroups = kThreads / kCGroups;
  float acc[RK][RC], mass[RK];
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    mass[r] = 0.f;
#pragma unroll
    for (int i = 0; i < RC; ++i) acc[r][i] = 0.f;
  }
  if (n > 0) {
    for (int s = 0; s < kTile; ++s) {
      const float inv = s_inv[s];
      float as[RK], xs[RC];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        const int k = kg + kKGroups * r;
        const float av = k < K ? s_a[s * lda + k] : 0.f;
        mass[r] += av;
        as[r] = av * inv;
      }
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        const int c = cgp + kCGroups * i;
        xs[i] = c < C ? s_x[s * ldx + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int i = 0; i < RC; ++i)
          acc[r][i] = fmaf(as[r], xs[i], acc[r][i]);
    }
  }
  __syncthreads();  // the tile is read: its space takes the block's sums
  float* s_sum = s_x;  // K*C, then K masses (K <= kTile, so it fits)
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int k = kg + kKGroups * r;
    if (k >= K) continue;
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int c = cgp + kCGroups * i;
      if (c < C) s_sum[k * C + c] = acc[r][i];
    }
    if (cgp == 0) s_sum[K * C + k] = mass[r];
  }
  cluster.sync();

  // rank r adds clusters [k0, k1) of the eight blocks (rows and masses)
  const int per = (K + kCluster - 1) / kCluster;
  const int k0 = min(K, rank * per), k1 = min(K, k0 + per);
  const int ncl = gridDim.x / kCluster;
  const int cl = blockIdx.x / kCluster;
  const int nv = K * C + K;
  float* part = a.partial + ((long long)b * ncl + cl) * nv;
  const int rows = (k1 - k0) * C;
  for (int e = tid; e < rows + (k1 - k0); e += kThreads) {
    const int idx = e < rows ? k0 * C + e : K * C + k0 + (e - rows);
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      v += cluster.map_shared_rank(s_sum, q)[idx];
    part[idx] = v;
  }
  __threadfence();
  cluster.sync();  // partials written and fenced; remote reads done
  if (rank == 0 && tid == 0) {
    const unsigned int done = atomicAdd(a.counter + b, 1u) + 1;
    const int last = done == (unsigned int)ncl;
    if (last) a.counter[b] = 0;  // ready for the next launch
    for (int q = 0; q < kCluster; ++q)
      *cluster.map_shared_rank(&s_last, q) = last;
  }
  cluster.sync();
  if (!s_last) return;  // the whole cluster: not the image's last
  __threadfence();

  // the last cluster: rank r finishes clusters [k0, k1), one warp a row
  const float* pb = a.partial + (long long)b * ncl * nv;
  float ss_rows = 0.f;
  constexpr int kPerLane = kMaxC / 32;
  for (int k = k0 + warp; k < k1; k += kWarps) {
    float m = 0.f;
    for (int q = 0; q < ncl; ++q)
      m += __ldcg(pb + (long long)q * nv + K * C + k);
    float v[kPerLane];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = 0.f;
      if (c < C) {
        float acc_v = 0.f;
        for (int q = 0; q < ncl; ++q)
          acc_v += __ldcg(pb + (long long)q * nv + k * C + c);
        v[i] = acc_v - m * a.centroids[k * C + c];
      }
      ss += v[i] * v[i];
    }
    const float den = l2_denominator(nvs::warp_sum(ss));
    float ss_n = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      v[i] /= den;
      ss_n += v[i] * v[i];
      const int c = lane + 32 * i;
      if (c < C) s_x[k * C + c] = v[i];  // this rank's rows, kept here
    }
    ss_rows += nvs::warp_sum(ss_n);
  }
  if (lane == 0) s_red[warp] = ss_rows;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_red[w];
    s_rank_ss = t;
  }
  cluster.sync();
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < kCluster; ++q)
    total += *cluster.map_shared_rank(&s_rank_ss, q);
  const float den = l2_denominator(total);
  float* ob = a.out + (long long)b * K * C;
  for (int e = k0 * C + tid; e < k1 * C; e += kThreads) ob[e] = s_x[e] / den;
  cluster.sync();  // keep s_rank_ss alive until every rank has read it
}

size_t smem_bytes(int C, int K) {
  return sizeof(float) *
         (C * K + kTile * (C + 1) + kTile * (K + 1) + kTile + kWarps);
}

// The instances: KPT, RK by K (<= 32, <= 64), RC by C (<= 64, <= 128).
void (*const kKernels[2][2])(Args) = {
    {netvlad_kernel<8, 2, 4>, netvlad_kernel<8, 2, 8>},
    {netvlad_kernel<16, 4, 4>, netvlad_kernel<16, 4, 8>}};

// Raises the dynamic shared-memory limit of every instance once per device
// to the most the widths can ask (C = 128, K = 64); until a call succeeds,
// each call tries again and returns its error.
cudaError_t set_smem_limits() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev].load()))
    return err;
  for (auto& row : kKernels)
    for (auto kernel : row)
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes(kMaxC, kMaxK));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

// Blocks a launch takes for one image of S pixels: a multiple of the
// cluster size.
int blocks_per_image(int S) {
  const int p = (S + kTile - 1) / kTile;
  return (p + kCluster - 1) / kCluster * kCluster;
}

}  // namespace

// Floats of the partial scratch one image of S pixels needs at widths C, K:
// one K*C + K partial a cluster.
extern "C" int nvs_netvlad_partial_size(int S, int C, int K) {
  return blocks_per_image(S) / kCluster * (K * C + K);
}

// x (B,S,C) with element strides [b, s, c]; assign_w (C,K), centroids (K,C)
// contiguous; partial (B, nvs_netvlad_partial_size) float scratch; counter (B)
// unsigned ints, zero before the first launch (each launch leaves them
// zero); out contiguous (B, K*C). One launch.
extern "C" int nvs_netvlad(const float* x, const long long* sx,
                           const float* assign_w, const float* centroids,
                           float* partial, unsigned int* counter, float* out,
                           int B, int S, int C, int K, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || C < 1 || C > kMaxC || S < 1 || B < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits();
  if (err != cudaSuccess) return (int)err;
  const Args args{x, sx[0], sx[1], sx[2], assign_w, centroids, partial,
                  counter, out, S, C, K};
  kKernels[K > 32][C > 64]<<<dim3(blocks_per_image(S), B), kThreads,
                             smem_bytes(C, K), stream>>>(args);
  return (int)cudaGetLastError();
}
