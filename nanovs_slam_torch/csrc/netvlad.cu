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
// The (K, C, S) residual tensor is never formed. The bfloat16 instance reads
// a bf16 x and computes in float32 as the module does at bf16: it rounds
// the normalised x_s to bf16 (the module normalises in its compute dtype)
// and takes everything after it in float32.
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
// next launch on the stream without a reset. When the wrapper asks for
// them (a gradient will be needed), the last cluster also writes each
// image's u = a^T x - (sum a) * centroids (K, C) before normalisation and
// the masses sum a (K): the backward below starts from them.
//
// Bound on an H100: operations, barely. At 240x320 (S = 4800, C = 48,
// K = 32) an image is 2 * 2*S*C*K = 29.5 MFLOP against 0.9 MB read, about
// 0.44 us at 67 TFLOP/s (float32, CUDA cores) and 0.28 us at 3.35 TB/s. The
// kernel is bound by the latency of its chain (stage, logits, sums, cluster
// reduce, last-cluster finish), which the design keeps to one pass.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

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
  const void* x;  // (B, S, C) float or bf16, element strides sx_b, sx_s, sx_c
  long long sx_b, sx_s, sx_c;
  const float* assign_w;   // (C, K)
  const float* centroids;  // (K, C)
  float* partial;          // (B, n_clusters, K*C + K)
  unsigned int* counter;   // (B), 0 between launches
  float* out;              // (B, K*C)
  float* residual;         // (B, K*C) u before normalisation, or null
  float* mass;             // (B, K) sum_s a, or null
  int S, C, K;
};

// KPT: clusters a thread takes in the logits (K <= 4 * KPT); RK, RC:
// clusters and channels a thread takes in the a^T x tile
// (K <= (kThreads / kCGroups) * RK, C <= kCGroups * RC). T: x's type.
template <int KPT, int RK, int RC, typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
netvlad_kernel(Args a) {
  constexpr bool kRoundX = std::is_same<T, __nv_bfloat16>::value;
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
  const T* xb = static_cast<const T*>(a.x) + (long long)b * a.sx_b;

  // stage W and the tile (zeros past the image's last pixel)
  for (int e = tid; e < C * K; e += kThreads) s_w[e] = a.assign_w[e];
  if (a.sx_c == 1) {  // NHWC memory: neighbouring threads, channels
    for (int e = tid; e < kTile * C; e += kThreads) {
      const int s = e / C, c = e % C;
      s_x[s * ldx + c] =
          s < n ? nvs::to_f32(xb[(long long)(s0 + s) * a.sx_s + c]) : 0.f;
    }
  } else {  // NCHW memory: neighbouring threads, pixels
    for (int e = tid; e < kTile * C; e += kThreads) {
      const int s = e % kTile, c = e / kTile;
      s_x[s * ldx + c] =
          s < n ? nvs::to_f32(
                      xb[(long long)(s0 + s) * a.sx_s + (long long)c * a.sx_c])
                : 0.f;
    }
  }
  __syncthreads();
  if constexpr (kRoundX) {
    // x_s / den rounded to bf16, in place, by the pixel's four threads
    // (one warp): the logits below then take den = 1
    const int p = tid >> 2, j = tid & 3;
    float* xs = s_x + p * ldx;
    float ss = 0.f;
    for (int c = j; c < C; c += 4) ss = fmaf(xs[c], xs[c], ss);
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    const float den = l2_denominator(ss);
    for (int c = j; c < C; c += 4)
      xs[c] = __bfloat162float(__float2bfloat16_rn(xs[c] / den));
    __syncwarp();
  }

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
    const float den = kRoundX ? 1.f : l2_denominator(ss);
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
    if (a.mass != nullptr && lane == 0) a.mass[(long long)b * K + k] = m;
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
        if (a.residual != nullptr)
          a.residual[((long long)b * K + k) * C + c] = v[i];
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

// The instances: x's type (float, bf16); KPT, RK by K (<= 32, <= 64); RC
// by C (<= 64, <= 128).
void (*const kKernels[2][2][2])(Args) = {
    {{netvlad_kernel<8, 2, 4, float>, netvlad_kernel<8, 2, 8, float>},
     {netvlad_kernel<16, 4, 4, float>, netvlad_kernel<16, 4, 8, float>}},
    {{netvlad_kernel<8, 2, 4, __nv_bfloat16>,
      netvlad_kernel<8, 2, 8, __nv_bfloat16>},
     {netvlad_kernel<16, 4, 4, __nv_bfloat16>,
      netvlad_kernel<16, 4, 8, __nv_bfloat16>}}};

// Raises the dynamic shared-memory limit of every instance once per device
// to the most the widths can ask (C = 128, K = 64).
cudaError_t set_smem_limits() {
  return nvs::once_per_device([] {
    cudaError_t err = cudaSuccess;
    for (auto& type : kKernels)
      for (auto& row : type)
        for (auto kernel : row)
          if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem_bytes(kMaxC, kMaxK));
    return err;
  });
}

// Blocks a launch takes for one image of S pixels: a multiple of the
// cluster size.
int blocks_per_image(int S) {
  const int p = (S + kTile - 1) / kTile;
  return (p + kCluster - 1) / kCluster * kCluster;
}

int launch(const void* x, bool bf16, const long long* sx,
           const float* assign_w, const float* centroids, float* partial,
           unsigned int* counter, float* out, float* residual, float* mass,
           int B, int S, int C, int K, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || C < 1 || C > kMaxC || S < 1 || B < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits();
  if (err != cudaSuccess) return (int)err;
  const Args args{x,       sx[0],   sx[1], sx[2],    assign_w, centroids,
                  partial, counter, out,   residual, mass,     S, C, K};
  kKernels[bf16][K > 32][C > 64]<<<dim3(blocks_per_image(S), B), kThreads,
                                   smem_bytes(C, K), stream>>>(args);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ backward
//
// The gradient of the function above with respect to x, W and the
// centroids, float32 only. It starts from the forward's u (K, C) and
// masses m (K) of each image (written by the forward when a gradient will
// be needed) and follows the chain with l2_normalize's
// x / max(sqrt(|x|^2 + eps^2), eps) at each of its three places:
//   global L2:     dv = (gy - (gy . y) y) / Q,        y = v / Q
//   cluster norm:  du_k = (dv_k - (dv_k . v_k) v_k) / q_k,  v_k = u_k / q_k
//   centroids:     dcen += -m (.) du,   dm_k = -du_k . cen_k
//   per pixel:     da = x^ du^T + dm;  dl = a (.) (da - (a . da));
//                  dx^ = a du + dl W^T;  dW += x^T dl;
//                  dx = (dx^ - (dx^ . x^) x^) / den.
// Design. netvlad_bwd_kernel: a block takes kBwdTile = 32 pixels of one
// image (38 blocks an image at 30x40, 150 at 60x80). Each block first
// recomputes its image's du and dm from u, m and gy (K*C values, a warp a
// cluster row: a few thousand operations against the tile's ~1 MFLOP),
// then stages the tile's x^ and W in shared memory and runs the three
// S x K x C products of the tile as loops over shared memory (thread e owns
// output e, neighbouring threads neighbouring outputs; rows padded by one
// so that the strided operand is free of bank conflicts). It writes dx,
// its tile's dW (C, K) as a partial and, in the image's first block, the
// image's -m (.) du. netvlad_bwd_reduce adds the partials in a fixed order
// (tiles, then images). No atomics: two runs give equal gradients.
//
// Bound on an H100: operations, far below both. At config S's train shape
// (B = 4, S = 1200, C = K = 64) the chain is about 6 S K C = 29.5 MFLOP an
// image (118 MFLOP a call) against ~2.5 MB moved: 1.8 us at 67 TFLOP/s.
// The kernel is bound by the latency of its chain of barriers and by the
// partials' round trip, which a simple first design accepts.

constexpr int kBwdTile = 32;  // pixels a block of the backward

struct BwdArgs {
  const float* gy;         // (B, K*C)
  const float* x;          // (B, S, C), element strides sx_b, sx_s, sx_c
  long long sx_b, sx_s, sx_c;
  const float* assign_w;   // (C, K)
  const float* centroids;  // (K, C)
  const float* residual;   // (B, K*C) the forward's u
  const float* mass;       // (B, K) the forward's m
  float* dx;               // (B, S, C), element strides sd_b, sd_s, sd_c
  long long sd_b, sd_s, sd_c;
  float* dw_part;          // (B * tiles, C*K) a block's x^T dl
  float* dcen_part;        // (B, K*C) an image's -m (.) du
  int S, C, K;
};

size_t bwd_smem_bytes(int C, int K) {
  const int ldc = C + 1, ldk = K + 1;
  return sizeof(float) * (C * ldk + K * ldc + 2 * kBwdTile * ldc +
                          2 * kBwdTile * ldk + 2 * K + kBwdTile + kWarps);
}

// The block's sum of each thread's v, in a fixed order (every thread gets
// it); s_red holds kWarps floats and is free again on return.
__device__ float block_sum(float v, float* s_red) {
  v = nvs::warp_sum(v);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s_red[w];
  __syncthreads();
  return t;
}

__global__ void __launch_bounds__(kThreads) netvlad_bwd_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  constexpr int P = kBwdTile;
  const int C = a.C, K = a.K, ldc = C + 1, ldk = K + 1;
  float* s_w = reinterpret_cast<float*>(smem4);  // W[c][k], C x ldk
  float* s_du = s_w + C * ldk;   // v, then du: K x ldc
  float* s_x = s_du + K * ldc;   // x, then x^: P x ldc
  float* s_dx = s_x + P * ldc;   // dx^, then dx: P x ldc
  float* s_a = s_dx + P * ldc;   // logits, then a: P x ldk
  float* s_dl = s_a + P * ldk;   // da, then dl: P x ldk
  float* s_dm = s_dl + P * ldk;  // K
  float* s_q = s_dm + K;         // K: the clusters' denominators
  float* s_den = s_q + K;        // P: the pixels' denominators
  float* s_red = s_den + P;      // kWarps

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int s0 = tile * P;
  const int n = min(P, a.S - s0);
  const long long KC = (long long)K * C;
  const float* gyb = a.gy + b * KC;
  const float* xb = a.x + b * a.sx_b;

  for (int e = tid; e < C * K; e += kThreads)
    s_w[(e / K) * ldk + e % K] = a.assign_w[e];
  for (int e = tid; e < K * C; e += kThreads)
    s_du[(e / C) * ldc + e % C] = a.residual[b * KC + e];
  if (a.sx_c == 1) {  // NHWC memory: neighbouring threads, channels
    for (int e = tid; e < P * C; e += kThreads) {
      const int s = e / C, c = e % C;
      s_x[s * ldc + c] = s < n ? xb[(long long)(s0 + s) * a.sx_s + c] : 0.f;
    }
  } else {  // NCHW memory: neighbouring threads, pixels
    for (int e = tid; e < P * C; e += kThreads) {
      const int s = e % P, c = e / P;
      s_x[s * ldc + c] =
          s < n ? xb[(long long)(s0 + s) * a.sx_s + (long long)c * a.sx_c]
                : 0.f;
    }
  }
  __syncthreads();

  // the clusters' norms: v_k = u_k / q_k in place, Q from sum |v_k|^2
  float ss_v = 0.f;
  for (int k = warp; k < K; k += kWarps) {
    float* row = s_du + k * ldc;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) ss = fmaf(row[c], row[c], ss);
    const float q = l2_denominator(nvs::warp_sum(ss));
    float ssk = 0.f;
    for (int c = lane; c < C; c += 32) {
      row[c] /= q;
      ssk = fmaf(row[c], row[c], ssk);
    }
    ss_v += nvs::warp_sum(ssk);
    if (lane == 0) s_q[k] = q;
  }
  const float Q = l2_denominator(block_sum(lane == 0 ? ss_v : 0.f, s_red));
  float g = 0.f;  // gy . y
  for (int e = tid; e < K * C; e += kThreads)
    g = fmaf(gyb[e], s_du[(e / C) * ldc + e % C] / Q, g);
  const float G = block_sum(g, s_red);

  // du and dm a cluster row (one warp a row); the image's first block
  // writes -m (.) du
  for (int k = warp; k < K; k += kWarps) {
    float* row = s_du + k * ldc;
    const float* gk = gyb + (long long)k * C;
    float dot = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dv = (gk[c] - G * (row[c] / Q)) / Q;
      dot = fmaf(dv, row[c], dot);
    }
    dot = nvs::warp_sum(dot);
    const float q = s_q[k], m = a.mass[(long long)b * K + k];
    float dm = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dv = (gk[c] - G * (row[c] / Q)) / Q;
      const float du = (dv - dot * row[c]) / q;
      row[c] = du;
      dm = fmaf(du, a.centroids[k * C + c], dm);
      if (tile == 0) a.dcen_part[b * KC + (long long)k * C + c] = -m * du;
    }
    dm = nvs::warp_sum(dm);
    if (lane == 0) s_dm[k] = -dm;
  }

  // the pixels' norms: x^ = x / den in place (one warp a pixel)
  for (int p = warp; p < P; p += kWarps) {
    float* xs = s_x + p * ldc;
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) ss = fmaf(xs[c], xs[c], ss);
    const float den = l2_denominator(nvs::warp_sum(ss));
    for (int c = lane; c < C; c += 32) xs[c] /= den;
    if (lane == 0) s_den[p] = den;
  }
  __syncthreads();

  // logits x^ W and da = x^ du^T + dm (P x K, depth C)
  for (int e = tid; e < P * K; e += kThreads) {
    const int p = e / K, k = e % K;
    const float* xs = s_x + p * ldc;
    const float* dk = s_du + k * ldc;
    float l = 0.f, da = 0.f;
    for (int c = 0; c < C; ++c) {
      l = fmaf(xs[c], s_w[c * ldk + k], l);
      da = fmaf(xs[c], dk[c], da);
    }
    s_a[p * ldk + k] = l;
    s_dl[p * ldk + k] = da + s_dm[k];
  }
  __syncthreads();

  // softmax and its backward (one warp a pixel; K <= 64: two lanes' worth)
  for (int p = warp; p < P; p += kWarps) {
    float* ar = s_a + p * ldk;
    float* dr = s_dl + p * ldk;
    const float neg_inf = -__int_as_float(0x7f800000);
    float mx = neg_inf;
    for (int k = lane; k < K; k += 32) mx = fmaxf(mx, ar[k]);
    mx = nvs::warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < K; k += 32) {
      ar[k] = expf(ar[k] - mx);
      sum += ar[k];
    }
    sum = nvs::warp_sum(sum);
    float dot = 0.f;
    for (int k = lane; k < K; k += 32) {
      ar[k] /= sum;
      dot = fmaf(ar[k], dr[k], dot);
    }
    dot = nvs::warp_sum(dot);
    for (int k = lane; k < K; k += 32)
      dr[k] = p < n ? ar[k] * (dr[k] - dot) : 0.f;
  }
  __syncthreads();

  // dx^ = a du + dl W^T (P x C, depth 2K) and the tile's dW = x^T dl
  // (C x K, depth P)
  for (int e = tid; e < P * C; e += kThreads) {
    const int p = e / C, c = e % C;
    const float* ar = s_a + p * ldk;
    const float* dr = s_dl + p * ldk;
    const float* wr = s_w + c * ldk;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      acc = fmaf(ar[k], s_du[k * ldc + c], acc);
      acc = fmaf(dr[k], wr[k], acc);
    }
    s_dx[p * ldc + c] = acc;
  }
  float* part = a.dw_part + ((long long)b * gridDim.x + tile) * KC;
  for (int e = tid; e < C * K; e += kThreads) {
    const int c = e / K, k = e % K;
    float acc = 0.f;
    for (int p = 0; p < P; ++p)
      acc = fmaf(s_x[p * ldc + c], s_dl[p * ldk + k], acc);
    part[e] = acc;
  }
  __syncthreads();

  // the pixels' norm backward, in place (one warp a pixel)
  for (int p = warp; p < n; p += kWarps) {
    float* dr = s_dx + p * ldc;
    const float* xs = s_x + p * ldc;
    float dot = 0.f;
    for (int c = lane; c < C; c += 32) dot = fmaf(dr[c], xs[c], dot);
    dot = nvs::warp_sum(dot);
    const float den = s_den[p];
    for (int c = lane; c < C; c += 32) dr[c] = (dr[c] - dot * xs[c]) / den;
  }
  __syncthreads();
  float* db = a.dx + b * a.sd_b;
  if (a.sd_c == 1) {
    for (int e = tid; e < n * C; e += kThreads) {
      const int s = e / C, c = e % C;
      db[(long long)(s0 + s) * a.sd_s + c] = s_dx[s * ldc + c];
    }
  } else {
    for (int e = tid; e < P * C; e += kThreads) {
      const int s = e % P, c = e / P;
      if (s < n)
        db[(long long)(s0 + s) * a.sd_s + (long long)c * a.sd_c] =
            s_dx[s * ldc + c];
    }
  }
}

// dW = the tiles' partials added in order, dcen = the images' in order.
__global__ void netvlad_bwd_reduce(const float* dw_part,
                                   const float* dcen_part, float* dw,
                                   float* dcen, int n_parts, int B, int KC) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < KC) {
    float s = 0.f;
    for (int q = 0; q < n_parts; ++q) s += dw_part[(long long)q * KC + e];
    dw[e] = s;
  } else if (e < 2 * KC) {
    const int i = e - KC;
    float s = 0.f;
    for (int q = 0; q < B; ++q) s += dcen_part[(long long)q * KC + i];
    dcen[i] = s;
  }
}

int bwd_tiles(int S) { return (S + kBwdTile - 1) / kBwdTile; }

cudaError_t set_bwd_smem_limit() {
  return nvs::once_per_device([] {
    return cudaFuncSetAttribute(netvlad_bwd_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bwd_smem_bytes(kMaxC, kMaxK));
  });
}

}  // namespace

// Floats of the partial scratch one image of S pixels needs at widths C, K:
// one K*C + K partial a cluster.
extern "C" int nvs_netvlad_partial_size(int S, int C, int K) {
  return blocks_per_image(S) / kCluster * (K * C + K);
}

// x (B,S,C) float32 with element strides [b, s, c]; assign_w (C,K),
// centroids (K,C) contiguous; partial (B, nvs_netvlad_partial_size) float
// scratch; counter (B) unsigned ints, zero before the first launch (each
// launch leaves them zero); out contiguous (B, K*C); residual (B, K*C) and
// mass (B, K) contiguous, or both null (not written). One launch.
extern "C" int nvs_netvlad(const float* x, const long long* sx,
                           const float* assign_w, const float* centroids,
                           float* partial, unsigned int* counter, float* out,
                           float* residual, float* mass, int B, int S, int C,
                           int K, cudaStream_t stream) {
  return launch(x, false, sx, assign_w, centroids, partial, counter, out,
                residual, mass, B, S, C, K, stream);
}

// The same with a bfloat16 x; everything else float32.
extern "C" int nvs_netvlad_bf16(const __nv_bfloat16* x, const long long* sx,
                                const float* assign_w, const float* centroids,
                                float* partial, unsigned int* counter,
                                float* out, float* residual, float* mass,
                                int B, int S, int C, int K,
                                cudaStream_t stream) {
  return launch(x, true, sx, assign_w, centroids, partial, counter, out,
                residual, mass, B, S, C, K, stream);
}

// Floats of the backward's scratch at batch B: the tiles' dW partials
// (B * tiles, C*K) and the images' dcen partials (B, K*C).
extern "C" int nvs_netvlad_backward_scratch_size(int B, int S, int C, int K) {
  return (B * bwd_tiles(S) + B) * K * C;
}

// gy (B, K*C), residual (B, K*C) and mass (B, K) from nvs_netvlad,
// assign_w (C, K) and centroids (K, C) contiguous, float32; x and dx
// (B, S, C) with element strides sx, sdx [b, s, c]; scratch of
// nvs_netvlad_backward_scratch_size floats; dw (C, K), dcen (K, C)
// contiguous. Two launches (the blocks, the fixed-order reduction).
extern "C" int nvs_netvlad_backward(
    const float* gy, const float* x, const long long* sx,
    const float* assign_w, const float* centroids, const float* residual,
    const float* mass, float* dx, const long long* sdx, float* scratch,
    float* dw, float* dcen, int B, int S, int C, int K,
    cudaStream_t stream) {
  if (K < 1 || K > kMaxK || C < 1 || C > kMaxC || S < 1 || B < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_bwd_smem_limit();
  if (err != cudaSuccess) return (int)err;
  const int tiles = bwd_tiles(S), KC = K * C;
  float* dcen_part = scratch + (long long)B * tiles * KC;
  const BwdArgs args{gy,     x,      sx[0],    sx[1],     sx[2],  assign_w,
                     centroids, residual, mass, dx,   sdx[0], sdx[1],
                     sdx[2], scratch, dcen_part, S, C, K};
  netvlad_bwd_kernel<<<dim3(tiles, B), kThreads, bwd_smem_bytes(C, K),
                       stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  netvlad_bwd_reduce<<<(2 * KC + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(scratch, dcen_part, dw, dcen, B * tiles, B,
                                 KC);
  return (int)cudaGetLastError();
}
