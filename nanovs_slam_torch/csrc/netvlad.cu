// Fused NetVLAD aggregation, one launch a call.
//
// Replaces the TPU kernel nanovs_slam_tpu/ops/pallas/netvlad_kernel.py
// (netvlad_pallas). For each image x (S pixels, C channels), assignment
// weights W (C, K) and centroids (K, C):
//   x_s   <- x_s / max(sqrt(|x_s|^2 + eps^2), eps)       (per pixel)
//   a_s   <- softmax_k(x_s W + b)     (b: the vladv2 bias, or none)
//   vlad  <- sum_s a_s^T x_s - (sum_s a_s) * centroids   (K, C)
//   vlad  <- intra-normalise per cluster, then global L2 over K*C
// with the normalisation of the module (modules/aggregators.NetVLAD). The
// bias is KeypointFormer's (NetVLAD(vladv2=True),
// nanovs_slam_tpu/modules/aggregators.py:64-69); without it the logits are
// x_s W alone, as before it was added.
// The (K, C, S) residual tensor is never formed. The bfloat16 instance reads
// a bf16 x and computes in float32 as the module does at bf16: it rounds
// the normalised x_s to bf16 (the module normalises in its compute dtype)
// and takes everything after it in float32.
//
// Design. A block takes kTile = 64 pixels of one image in one pass: it
// stages them and W in shared memory, computes each pixel's K logits with
// four threads a pixel (the pixel's squared norm in the same loop), the
// softmax with two shuffles, and a^T x and sum a with a register tile of
// 2-4 clusters by 4-16 channels a thread. At 240x320 (S = 4800) that is
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
// KeypointFormer's head (C = 256, K = 64, x (33, 41) at 256x320) is 88.7
// MFLOP an image, 1.3 us at 67 TFLOP/s; its block takes 145 KiB of dynamic
// shared memory (W alone is 64 KiB), so one block an SM.
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
constexpr int kMaxC = 256;
constexpr int kCGroups = 16;    // channel groups of the a^T x tile
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float l2_denominator(float sumsq) {
  return fmaxf(sqrtf(sumsq + kEps * kEps), kEps);
}

struct Args {
  const void* x;  // (B, S, C) float or bf16, element strides sx_b, sx_s, sx_c
  long long sx_b, sx_s, sx_c;
  const float* assign_w;   // (C, K)
  const float* assign_b;   // (K), or null: no bias
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
      const int k = j + 4 * u;
      if (k < K)
        acc[u] = a.assign_b != nullptr ? acc[u] / den + a.assign_b[k]
                                       : acc[u] / den;
      else
        acc[u] = neg_inf;
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
// by C (<= 64, <= 128, <= 256).
void (*const kKernels[2][2][3])(Args) = {
    {{netvlad_kernel<8, 2, 4, float>, netvlad_kernel<8, 2, 8, float>,
      netvlad_kernel<8, 2, 16, float>},
     {netvlad_kernel<16, 4, 4, float>, netvlad_kernel<16, 4, 8, float>,
      netvlad_kernel<16, 4, 16, float>}},
    {{netvlad_kernel<8, 2, 4, __nv_bfloat16>,
      netvlad_kernel<8, 2, 8, __nv_bfloat16>,
      netvlad_kernel<8, 2, 16, __nv_bfloat16>},
     {netvlad_kernel<16, 4, 4, __nv_bfloat16>,
      netvlad_kernel<16, 4, 8, __nv_bfloat16>,
      netvlad_kernel<16, 4, 16, __nv_bfloat16>}}};

// Raises the dynamic shared-memory limit of every instance once per device
// to the most the widths can ask (C = 256, K = 64: 148,256 bytes).
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
           const float* assign_w, const float* assign_b,
           const float* centroids, float* partial,
           unsigned int* counter, float* out, float* residual, float* mass,
           int B, int S, int C, int K, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || C < 1 || C > kMaxC || S < 1 || B < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits();
  if (err != cudaSuccess) return (int)err;
  const Args args{x,         sx[0],    sx[1],   sx[2], assign_w,
                  assign_b,  centroids, partial, counter, out,
                  residual,  mass,      S,       C,     K};
  const int rc = C > 128 ? 2 : C > 64 ? 1 : 0;
  kKernels[bf16][K > 32][rc]<<<dim3(blocks_per_image(S), B), kThreads,
                                   smem_bytes(C, K), stream>>>(args);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ backward
//
// The gradient of the function above with respect to x, W, the centroids
// and, where the forward had one, the bias, for a float32 or a bfloat16 x.
// It starts from the forward's u (K, C) and masses m (K) of each image
// (written by the forward when a gradient will be needed) and follows the
// chain with l2_normalize's
// x / max(sqrt(|x|^2 + eps^2), eps) at each of its three places:
//   global L2:     dv = (gy - (gy . y) y) / Q,        y = v / Q
//   cluster norm:  du_k = (dv_k - (dv_k . v_k) v_k) / q_k,  v_k = u_k / q_k
//   centroids:     dcen += -m (.) du,   dm_k = -du_k . cen_k
//   per pixel:     l = x^ W + b;  a = softmax(l);  da = x^ du^T + dm;
//                  dl = a (.) (da - (a . da));
//                  dx^ = [a | dl] [du ; W^T];  dW += x^T dl;  db += dl;
//                  dx = (dx^ - (dx^ . x^) x^) / den.
// At bfloat16 (the forward's bf16 instance, and autograd through its plain
// twin with a bf16 x): x is read as bf16, x^ is rounded to bf16 where the
// forward rounds it (the products use it), dx^ is rounded to bf16 (the
// cast's gradient), the norm's backward takes the unrounded x / den, and
// dx is written as bf16; everything between is float32. Only the tile
// kernel's x loads and dx stores change type.
// Design: three launches, chained by programmatic dependent launch.
//   1. netvlad_bwd_prologue, 8 cluster rows of an image a block: du, dm
//      and -m (.) du from u, m and gy; du written twice (K x C and C x K)
//      and W^T once, zero-padded to the instance's widths, so that the
//      tiles copy them with 16-byte cp.async.
//   2. netvlad_bwd_tile, a block of 10 warps a tile of kBwdTile = 40
//      pixels (30 tiles an image at the train shape's 30x40: 120 blocks on
//      132 SMs; 120 at config N's 60x80). It stages its x and W, normalises
//      x and takes the logits and the softmax before it waits for the
//      prologue, whose launch it overlaps. The products are register tiles
//      over shared memory at compile-time widths (CP, KP): a thread takes
//      1-4 pixels by 4 clusters or channels, float4 loads, a fixed order of
//      sums; the softmax and dl run in the registers of the logits' tile
//      (a pixel's clusters are neighbouring lanes of one warp), the
//      pixels' norms a group of 8 lanes a pixel. Instances: (48, 32) V2 N,
//      (48, 64) V3 N, (64, 64) the S family, (128, 64) F; any other
//      C <= 128, K <= 64 runs in the smallest that holds it, zero-padded
//      (padded clusters take no part in the softmax). Blocks form clusters
//      of 8 that add their tiles' dW (and the column sums of dl, db)
//      through distributed shared memory: one partial a cluster.
//   3. netvlad_bwd_reduce: dW and db from the clusters' partials and dcen
//      from the images', each in a fixed order. No atomics: two runs give
//      the same bits.
// At 128 < C <= 256 (KeypointFormer's "default" head, C = 256, K = 64) the
// tile kernel cannot hold [W | du^T] and [du ; W^T]: 256 KiB of shared
// memory. There netvlad_bwd_wide takes the place of step 2: a block a tile
// of 32 pixels, a warp 4 of them; W, du^T, du and W^T are read through L1
// from the prologue's padded copies, each load serving the warp's 4
// pixels (a lane takes clusters lane and lane + 32 in the logits and da,
// channels lane + 32 j in dx^); the tile's x^, a and dl stay in shared
// memory (58 KiB), and each block writes its tile's x^T dl and column sums
// of dl as a partial, which the same reduction adds in block order.
// Phase timers on the card: a design with a block a 32-pixel tile, the
// image's prologue in every block and scalar products over shared memory
// spent 38% of a block on the repeated prologue and 44% on the products.
// A 3xTF32 tensor-core version of the products (mma.sync m16n8k8, x^ and
// [a | dl] split once into hi and lo) was slower than these register
// tiles: each fragment is 8 scalar loads from shared memory, which then
// bound it.
//
// Bound on an H100: operations. At config S's train shape (B = 4, S =
// 1200, C = K = 64) the five S x K x C products are 197 MFLOP against ~2.6
// MB moved: 2.9 us at 67 TFLOP/s.

constexpr int kBwdTile = 40;      // pixels a tile block
constexpr int kBwdThreads = 320;  // 10 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kPrologueThreads = 256;  // 8 warps, a cluster row each
// more than half of an SM's 228 KB of shared memory: one tile block an SM
constexpr size_t kOneBlockSmem = 116 * 1024;

struct BwdArgs {
  const float* gy;         // (B, K*C)
  const void* x;  // (B, S, C) float or bf16, element strides sx_b, sx_s, sx_c
  long long sx_b, sx_s, sx_c;
  const float* assign_w;   // (C, K)
  const float* centroids;  // (K, C)
  const float* residual;   // (B, K*C) the forward's u
  const float* mass;       // (B, K) the forward's m
  void* dx;       // (B, S, C) as x, element strides sd_b, sd_s, sd_c
  long long sd_b, sd_s, sd_c;
  float* du;         // (B, KP, CP) zero-padded
  float* du_t;       // (B, CP, KP) zero-padded
  float* w_t;        // (KP, CP) zero-padded
  float* dm;         // (B, KP) zero-padded
  float* dw_part;    // (clusters, CP*KP) a cluster's x^T dl
  float* dcen_part;  // (B, K*C) an image's -m (.) du
  float* dw;         // (C, K)
  float* dcen;       // (K, C)
  const float* assign_b;  // (K), or null: no bias
  float* db;              // (K), or null: not written
  int B, S, C, K;
  int tiles;  // tiles an image
};

// A dW partial: x^T dl at the padded widths, then the column sums of dl.
__host__ __device__ constexpr long long part_floats(int cp, int kp) {
  return (long long)cp * kp + kp;
}

// The tile kernel's shapes at padded widths (CP, KP).
template <int CP, int KP>
struct BwdCfg {
  static_assert(KP == 32 || KP == 64, "KP");
  static_assert(CP % 16 == 0 && CP <= kMaxC, "CP");
  static constexpr int LDX = CP + 4;      // x^, dx^: a pixel's row
  static constexpr int LDA = 2 * KP + 4;  // [a | dl]: a pixel's row
  static constexpr int KG = KP / 4;       // cluster groups of 4
  static constexpr int TP1 = KP / 32;     // pixels a thread of [l | da]
  static constexpr int CG = CP / 4;       // channel groups of 4
  static constexpr int TP2 = CP <= 64 ? 2 : 4;  // pixels a thread of dx^
  static constexpr int NT2 = kBwdTile / TP2 * CG;
  static constexpr int DWC = CP <= 64 ? 4 : 8;  // channels a thread of dW
  static constexpr int NTW = CP / DWC * KG;
  static constexpr int kB1 = CP * 2 * KP;  // [W | du^T], later dx^
  static constexpr int kB2 = 2 * KP * CP;  // [du ; W^T], later dW
  static constexpr int kFloats = kB1 + kB2 + kBwdTile * (LDX + LDA) + KP +
                                 2 * kBwdTile;
  static_assert(CP * KP + KP <= kB2, "the tile's dW and db");
  static_assert(kBwdTile / TP1 * KG == kBwdThreads, "[l | da]: a task each");
  static_assert(NT2 <= kBwdThreads && NTW <= kBwdThreads, "a task each");
  static_assert(kBwdTile * LDX <= kB1 && CP * KP <= kB2, "aliases");
  static_assert(CP * KP % (4 * kCluster) == 0, "the cluster's dW slices");
};

// acc[i][j] += sum_d A[i lda + d] B[d ldb + j] for i < R, j < 4, d < D, d
// ascending; A's rows and B 16-byte aligned, D % 4 == 0.
template <int R, int D>
__device__ __forceinline__ void mac_rows(const float* A, int lda,
                                         const float* B, int ldb,
                                         float (&acc)[R][4]) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[R], bv[4];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + i * lda + d);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      bv[u] = *reinterpret_cast<const float4*>(B + (d + u) * ldb);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float a4[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[i][0] = fmaf(a4[u], bv[u].x, acc[i][0]);
        acc[i][1] = fmaf(a4[u], bv[u].y, acc[i][1]);
        acc[i][2] = fmaf(a4[u], bv[u].z, acc[i][2]);
        acc[i][3] = fmaf(a4[u], bv[u].w, acc[i][3]);
      }
    }
  }
}

// acc[i][j] += sum_d A[d lda + i] B[d ldb + j] for i < R, j < 4, d < D, d
// ascending; A's and B's rows 16-byte aligned, R % 4 == 0.
template <int R, int D>
__device__ __forceinline__ void mac_cols(const float* A, int lda,
                                         const float* B, int ldb,
                                         float (&acc)[R][4]) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[R];
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(A + d * lda + 4 * q);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
    const float4 b = *reinterpret_cast<const float4*>(B + d * ldb);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
      acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
      acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
    }
  }
}

// Reduces v over the G neighbouring lanes of a group (G a power of two):
// every lane of the group gets the same bits.
template <int G, bool kMax>
__device__ __forceinline__ float group_reduce(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  return v;
}

// Programmatic dependent launch (as in lightglue.cu): the next kernel may
// start; this one waits for the previous one's writes.
__device__ __forceinline__ void allow_next_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_previous_launch() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// An image's du, dm and -m (.) du, 8 cluster rows a block (a warp a
// row): every block takes the image's q_k, |v_k|^2 and gy_k . v_k of all
// rows (the same sums in the same order in each), Q and G from them, then
// its own rows; the blocks of image 0 also write their rows of W^T. Every
// load is issued before the first is used.
template <int CP, int KP>
__global__ void __launch_bounds__(kPrologueThreads)
netvlad_bwd_prologue(BwdArgs a) {
  allow_next_launch();  // the tiles stage x and take the softmax meanwhile
  constexpr int kW = kPrologueThreads / 32;
  constexpr int NCL = (CP + 31) / 32;  // a lane's channels
  constexpr int RPW = KP / kW;         // rows a warp takes for the norms
  __shared__ float s_q[KP], s_ss[KP], s_gv[KP];
  const int C = a.C, K = a.K, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kW + warp;  // the warp's own row
  const long long KC = (long long)K * C;
  const float* ub = a.residual + b * KC;
  const float* gb = a.gy + b * KC;

  float u[RPW][NCL], g[RPW][NCL], ur[NCL], gr[NCL], cen[NCL], wt[NCL];
#pragma unroll
  for (int i = 0; i < NCL; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int kj = warp + kW * j;
      const bool in = kj < K && c < C;
      u[j][i] = in ? ub[kj * C + c] : 0.f;
      g[j][i] = in ? gb[kj * C + c] : 0.f;
    }
    const bool in = k < K && c < C;
    ur[i] = in ? ub[k * C + c] : 0.f;
    gr[i] = in ? gb[k * C + c] : 0.f;
    cen[i] = in ? a.centroids[k * C + c] : 0.f;
    wt[i] = in && b == 0 ? a.assign_w[c * K + k] : 0.f;
  }
  const float m = k < K ? a.mass[(long long)b * K + k] : 0.f;

  // every row's norm q_k, |v_k|^2 and gy_k . v_k, v_k = u_k / q_k
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NCL; ++i) ss = fmaf(u[j][i], u[j][i], ss);
    const float q = l2_denominator(nvs::warp_sum(ss));
    float ssv = 0.f, gv = 0.f;
#pragma unroll
    for (int i = 0; i < NCL; ++i) {
      const float v = u[j][i] / q;
      ssv = fmaf(v, v, ssv);
      gv = fmaf(g[j][i], v, gv);
    }
    ssv = nvs::warp_sum(ssv);
    gv = nvs::warp_sum(gv);
    if (lane == 0 && warp + kW * j < K) {
      s_q[warp + kW * j] = q;
      s_ss[warp + kW * j] = ssv;
      s_gv[warp + kW * j] = gv;
    }
  }
  __syncthreads();
  float ss_all = 0.f, gv_all = 0.f;  // every warp the same sums
  for (int kk = lane; kk < K; kk += 32) {
    ss_all += s_ss[kk];
    gv_all += s_gv[kk];
  }
  const float Q = l2_denominator(nvs::warp_sum(ss_all));
  const float G = nvs::warp_sum(gv_all) / Q;  // gy . y

  // the warp's row: du, dm and -m (.) du, zeros past K and C
  float du[NCL], dmk = 0.f;
  if (k < K) {
    const float q = s_q[k];
    float v[NCL], dv[NCL], dot = 0.f;
#pragma unroll
    for (int i = 0; i < NCL; ++i) {
      const bool in = lane + 32 * i < C;
      v[i] = in ? ur[i] / q : 0.f;
      dv[i] = in ? (gr[i] - G * (v[i] / Q)) / Q : 0.f;
      dot = fmaf(dv[i], v[i], dot);
    }
    dot = nvs::warp_sum(dot);
#pragma unroll
    for (int i = 0; i < NCL; ++i) {
      const int c = lane + 32 * i;
      du[i] = c < C ? (dv[i] - dot * v[i]) / q : 0.f;
      dmk = fmaf(du[i], cen[i], dmk);
      if (c < C) a.dcen_part[b * KC + (long long)k * C + c] = -m * du[i];
    }
    dmk = -nvs::warp_sum(dmk);
  } else {
#pragma unroll
    for (int i = 0; i < NCL; ++i) du[i] = 0.f;
  }
  float* dub = a.du + ((long long)b * KP + k) * CP;
  float* dutb = a.du_t + (long long)b * CP * KP + k;
#pragma unroll
  for (int i = 0; i < NCL; ++i) {
    const int c = lane + 32 * i;
    if (c < CP) {
      dub[c] = du[i];
      dutb[(long long)c * KP] = du[i];
      if (b == 0) a.w_t[k * CP + c] = wt[i];
    }
  }
  if (lane == 0) a.dm[(long long)b * KP + k] = dmk;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A tile of kBwdTile pixels: dx, and the cluster's share of dW. T: x's
// and dx's type.
template <int CP, int KP, typename T>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kBwdThreads, 1) netvlad_bwd_tile(BwdArgs a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  using G = BwdCfg<CP, KP>;
  constexpr int P = kBwdTile, LDX = G::LDX, LDA = G::LDA, KG = G::KG;
  constexpr int TP1 = G::TP1, TP2 = G::TP2, CG = G::CG, DWC = G::DWC;
  extern __shared__ float4 smem4[];
  float* s_b1 = reinterpret_cast<float*>(smem4);  // CP x 2KP, then dx^
  float* s_b2 = s_b1 + G::kB1;   // 2KP x CP, then the tile's dW (CP x KP)
  float* s_x = s_b2 + G::kB2;    // P x LDX: x, then x^
  float* s_a = s_x + P * LDX;    // P x LDA: [a | dl]
  float* s_dm = s_a + P * LDA;   // KP
  float* s_den = s_dm + KP;      // P: the pixels' denominators
  float* s_dot = s_den + P;      // P: dx^ . x^

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, K = a.K;
  const int t = blockIdx.x;  // blocks past the last tile pad the clusters
  const int b = min(t / a.tiles, a.B - 1);
  const int s0 = (t % a.tiles) * P;
  const int n = t < a.B * a.tiles ? min(P, a.S - s0) : 0;

  // 1. W and the tile's x, zeros past the widths and the image's last
  // pixel (every load in flight before the first store)
  {
    constexpr int kT = kBwdThreads;
    constexpr int RW = (CP * KP + kT - 1) / kT, RX = (P * CP + kT - 1) / kT;
    float w[RW], v[RX];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int e = tid + kT * i, c = e / KP, k = e % KP;
      w[i] = e < CP * KP && c < C && k < K ? __ldg(a.assign_w + c * K + k)
                                           : 0.f;
    }
    const T* xb = static_cast<const T*>(a.x) + b * a.sx_b;
    const bool nhwc = a.sx_c == 1;
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      // NHWC memory: neighbouring threads, channels; NCHW: pixels
      const int e = tid + kT * i;
      const int p = nhwc ? e / CP : e % P, c = nhwc ? e % CP : e / P;
      v[i] = e < P * CP && p < n && c < C
                 ? load_f32(xb + (long long)(s0 + p) * a.sx_s +
                            (long long)c * a.sx_c)
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int e = tid + kT * i;
      if (e < CP * KP) s_b1[e / KP * 2 * KP + e % KP] = w[i];
    }
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      const int e = tid + kT * i;
      const int p = nhwc ? e / CP : e % P, c = nhwc ? e % CP : e / P;
      if (e < P * CP) s_x[p * LDX + c] = v[i];
    }
  }
  __syncthreads();

  // 2. the pixels' norms: x^ = x / den in place (a group of 8 lanes a
  // pixel, 4 pixels a warp)
  const int q8 = lane & 7;
  static_assert(P == 4 * kBwdWarps, "a pixel a group");
  {
    const int p = warp * 4 + (lane >> 3);
    float* xs = s_x + p * LDX;
    float ss = 0.f;
#pragma unroll
    for (int c = q8; c < CP; c += 8) ss = fmaf(xs[c], xs[c], ss);
    const float den = l2_denominator(group_reduce<8, false>(ss));
#pragma unroll
    for (int c = q8; c < CP; c += 8)
      xs[c] = kBf16 ? round_bf16(xs[c] / den) : xs[c] / den;
    if (q8 == 0) s_den[p] = den;
  }
  __syncthreads();

  // 3. logits and softmax: thread (pg, kg) takes pixels TP1 pg .. and
  // clusters 4 kg .. 4 kg + 3; a pixel group's KG threads are neighbouring
  // lanes of one warp
  const int kg = tid % KG, pg = tid / KG;
  const float* xrows = s_x + pg * TP1 * LDX;
  float av[TP1][4] = {};
  mac_rows<TP1, CP>(xrows, LDX, s_b1 + 4 * kg, 2 * KP, av);
  const float neg_inf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < TP1; ++i) {
    float mx = neg_inf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * kg + j;
      if (k >= K)
        av[i][j] = neg_inf;  // a padded cluster
      else if (a.assign_b != nullptr)
        av[i][j] += __ldg(a.assign_b + k);
      mx = fmaxf(mx, av[i][j]);
    }
    mx = group_reduce<KG, true>(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      av[i][j] = expf(av[i][j] - mx);
      sum += av[i][j];
    }
    sum = group_reduce<KG, false>(sum);
#pragma unroll
    for (int j = 0; j < 4; ++j) av[i][j] /= sum;
  }

  // 4. the prologue's du, du^T, W^T and dm
  wait_previous_launch();
  allow_next_launch();  // the reduction's blocks wait for this grid
  {
    const float* dutb = a.du_t + (long long)b * CP * KP;
    for (int e = tid; e < CP * KP / 4; e += kBwdThreads) {
      const int c = e / (KP / 4), j = e % (KP / 4);
      nvs::cp_async16(s_b1 + c * 2 * KP + KP + 4 * j, dutb + c * KP + 4 * j);
    }
    const float* dub = a.du + (long long)b * KP * CP;
    for (int e = tid; e < KP * CP / 4; e += kBwdThreads) {
      nvs::cp_async16(s_b2 + 4 * e, dub + 4 * e);
      nvs::cp_async16(s_b2 + KP * CP + 4 * e, a.w_t + 4 * e);
    }
    for (int e = tid; e < KP / 4; e += kBwdThreads)
      nvs::cp_async16(s_dm + 4 * e, a.dm + (long long)b * KP + 4 * e);
    nvs::cp_async_commit();
    nvs::cp_async_wait<0>();
  }
  __syncthreads();

  // 5. da = x^ du^T + dm and dl = a (.) (da - a . da); [a | dl] out
  {
    float da[TP1][4] = {};
    mac_rows<TP1, CP>(xrows, LDX, s_b1 + KP + 4 * kg, 2 * KP, da);
#pragma unroll
    for (int i = 0; i < TP1; ++i) {
      const int p = pg * TP1 + i;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        da[i][j] += s_dm[4 * kg + j];
        dot = fmaf(av[i][j], da[i][j], dot);
      }
      dot = group_reduce<KG, false>(dot);
      float dl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dl[j] = p < n ? av[i][j] * (da[i][j] - dot) : 0.f;
      *reinterpret_cast<float4*>(s_a + p * LDA + 4 * kg) =
          make_float4(av[i][0], av[i][1], av[i][2], av[i][3]);
      *reinterpret_cast<float4*>(s_a + p * LDA + KP + 4 * kg) =
          make_float4(dl[0], dl[1], dl[2], dl[3]);
    }
  }
  __syncthreads();

  // 6. dx^ = [a | dl] [du ; W^T] (into the space of [W | du^T]) and the
  // tile's dW = x^T dl (kept in registers until [du ; W^T] is read)
  if (tid < G::NT2) {
    const int c4 = tid % CG, p0 = tid / CG * TP2;
    float acc[TP2][4] = {};
    mac_rows<TP2, 2 * KP>(s_a + p0 * LDA, LDA, s_b2 + 4 * c4, CP, acc);
#pragma unroll
    for (int i = 0; i < TP2; ++i)
      *reinterpret_cast<float4*>(s_b1 + (p0 + i) * LDX + 4 * c4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  const bool dw_thread = tid < G::NTW;
  const int k4 = tid % KG, c0 = tid / KG * DWC;
  float w[DWC][4] = {};
  if (dw_thread) mac_cols<DWC, P>(s_x + c0, LDX, s_a + KP + 4 * k4, LDA, w);
  float db_tile = 0.f;  // the tile's column sum of dl, pixels in order
  if (tid < KP)
    for (int p = 0; p < P; ++p) db_tile += s_a[p * LDA + KP + tid];
  __syncthreads();
  if (dw_thread)
#pragma unroll
    for (int i = 0; i < DWC; ++i)
      *reinterpret_cast<float4*>(s_b2 + (c0 + i) * KP + 4 * k4) =
          make_float4(w[i][0], w[i][1], w[i][2], w[i][3]);
  if (tid < KP) s_b2[CP * KP + tid] = db_tile;  // W^T's space, read

  // 7. the pixels' norm backward: dx = (dx^ - (dx^ . x^) x^) / den; at
  // bf16 with dx^ rounded to bf16 and x^ = x / den unrounded (x read again)
  const T* xg = static_cast<const T*>(a.x) + b * a.sx_b;
  auto x_hat = [&](int p, int c) {
    return kBf16 ? load_f32(xg + (long long)(s0 + p) * a.sx_s +
                            (long long)c * a.sx_c) /
                       s_den[p]
                 : s_x[p * LDX + c];
  };
  {
    const int p = warp * 4 + (lane >> 3);
    float* dr = s_b1 + p * LDX;
    float dot = 0.f;
#pragma unroll
    for (int c = q8; c < CP; c += 8) {
      if constexpr (kBf16) dr[c] = round_bf16(dr[c]);
      if (!kBf16 || (p < n && c < C)) dot = fmaf(dr[c], x_hat(p, c), dot);
    }
    dot = group_reduce<8, false>(dot);
    if (q8 == 0) s_dot[p] = dot;
  }
  __syncthreads();
  T* db = static_cast<T*>(a.dx) + b * a.sd_b;
  if (a.sd_c == 1) {
    for (int e = tid; e < n * C; e += kBwdThreads) {
      const int p = e / C, c = e % C;
      store_as(db + (long long)(s0 + p) * a.sd_s + c,
               (s_b1[p * LDX + c] - s_dot[p] * x_hat(p, c)) / s_den[p]);
    }
  } else {
    for (int e = tid; e < P * C; e += kBwdThreads) {
      const int p = e % P, c = e / P;
      if (p < n)
        store_as(db + (long long)(s0 + p) * a.sd_s + (long long)c * a.sd_c,
                 (s_b1[p * LDX + c] - s_dot[p] * x_hat(p, c)) / s_den[p]);
    }
  }

  // 8. the cluster's dW: rank r adds slice r of the eight tiles' dW, in
  // rank order, and writes it as the cluster's partial; rank 0 also adds
  // their db
  cluster.sync();
  constexpr int kSlice = CP * KP / kCluster;
  const int rank = (int)cluster.block_rank();
  float* part = a.dw_part + (blockIdx.x / kCluster) * part_floats(CP, KP);
  if (rank == 0 && tid < KP) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      v += cluster.map_shared_rank(s_b2, q)[CP * KP + tid];
    part[CP * KP + tid] = v;
  }
  for (int e = rank * kSlice + 4 * tid; e < (rank + 1) * kSlice;
       e += 4 * kBwdThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      const float4 r = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(s_b2, q) + e);
      v.x += r.x;
      v.y += r.y;
      v.z += r.z;
      v.w += r.w;
    }
    *reinterpret_cast<float4*>(part + e) = v;
  }
  cluster.sync();  // keep every rank's dW alive until it has been read
}

// dW and db from the partials and dcen from the images', in order.
template <int CP, int KP>
__global__ void __launch_bounds__(256)
netvlad_bwd_reduce(BwdArgs a, int n_parts) {
  wait_previous_launch();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int KC = a.K * a.C;
  constexpr long long kPart = part_floats(CP, KP);
  if (e < KC) {
    const float* p = a.dw_part + (e / a.K) * KP + e % a.K;
    float s = 0.f;
#pragma unroll 8
    for (int q = 0; q < n_parts; ++q) s += p[q * kPart];
    a.dw[e] = s;
  } else if (e < 2 * KC) {
    const int i = e - KC;
    float s = 0.f;
    for (int q = 0; q < a.B; ++q) s += a.dcen_part[(long long)q * KC + i];
    a.dcen[i] = s;
  } else if (e < 2 * KC + a.K && a.db != nullptr) {
    const float* p = a.dw_part + CP * KP + (e - 2 * KC);
    float s = 0.f;
    for (int q = 0; q < n_parts; ++q) s += p[q * kPart];
    a.db[e - 2 * KC] = s;
  }
}

// The tile kernel's place at 128 < C <= 256 (see the notes above the
// backward): a block a tile of kWideTile pixels of one image, a warp
// kWidePix of them. T: x's and dx's type.
constexpr int kWideCP = 256, kWideKP = 64;  // the prologue's padded widths
constexpr int kWideTile = 32;
constexpr int kWideThreads = 256;
constexpr int kWidePix = kWideTile / (kWideThreads / 32);
constexpr int kWideLDX = kWideCP + 4;
constexpr size_t kWideSmem =
    sizeof(float) * (kWideTile * kWideLDX + 2 * kWideTile * kWideKP +
                     kWideTile);

template <typename T>
__global__ void __launch_bounds__(kWideThreads) netvlad_bwd_wide(BwdArgs a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int P = kWideTile, CP = kWideCP, KP = kWideKP, LDX = kWideLDX;
  constexpr int NP = kWidePix, NC = CP / 32;
  extern __shared__ float4 smem4[];
  float* s_x = reinterpret_cast<float*>(smem4);  // P x LDX: x, x^, then dx
  float* s_a = s_x + P * LDX;                    // P x KP: a
  float* s_dl = s_a + P * KP;                    // P x KP: dl
  float* s_den = s_dl + P * KP;                  // P
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, K = a.K;
  const int b = blockIdx.x / a.tiles;
  const int s0 = (blockIdx.x % a.tiles) * P;
  const int n = min(P, a.S - s0);
  const T* xb = static_cast<const T*>(a.x) + b * a.sx_b;
  const bool nhwc = a.sx_c == 1;

  // 1. the tile's x, zeros past C and the image's last pixel (NHWC memory:
  // neighbouring threads, channels; NCHW: pixels)
  for (int e = tid; e < P * CP; e += kWideThreads) {
    const int p = nhwc ? e / CP : e % P, c = nhwc ? e % CP : e / P;
    s_x[p * LDX + c] =
        p < n && c < C ? load_f32(xb + (long long)(s0 + p) * a.sx_s +
                                  (long long)c * a.sx_c)
                       : 0.f;
  }
  __syncthreads();

  // 2. the warp's pixels: x^ = x / den in place (rounded to bf16 at bf16)
  const int p0 = warp * NP;
  float den[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float* xs = s_x + (p0 + i) * LDX;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) ss = fmaf(xs[lane + 32 * j],
                                           xs[lane + 32 * j], ss);
    den[i] = l2_denominator(nvs::warp_sum(ss));
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float v = xs[lane + 32 * j] / den[i];
      xs[lane + 32 * j] = kBf16 ? round_bf16(v) : v;
    }
    if (lane == 0) s_den[p0 + i] = den[i];
  }
  __syncwarp();

  // 3. logits l = x^ W + b and da = x^ du^T + dm: lane takes clusters
  // lane and lane + 32; each load of W and du^T serves the NP pixels
  const float* dutb = a.du_t + (long long)b * CP * KP;
  const int kk[2] = {lane, lane + 32};
  float l[NP][2] = {}, da[NP][2] = {};
  for (int c = 0; c < C; ++c) {
    float w[2], d[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      w[h] = kk[h] < K ? __ldg(a.assign_w + c * K + kk[h]) : 0.f;
      d[h] = __ldg(dutb + c * KP + kk[h]);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float xv = s_x[(p0 + i) * LDX + c];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[i][h] = fmaf(xv, w[h], l[i][h]);
        da[i][h] = fmaf(xv, d[h], da[i][h]);
      }
    }
  }
  const float neg_inf = -__int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = p0 + i;
    float mx = neg_inf;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (kk[h] >= K)
        l[i][h] = neg_inf;
      else if (a.assign_b != nullptr)
        l[i][h] += __ldg(a.assign_b + kk[h]);
      mx = fmaxf(mx, l[i][h]);
    }
    mx = nvs::warp_max(mx);
    float av[2], sum = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      av[h] = expf(l[i][h] - mx);  // 0 past K
      sum += av[h];
    }
    sum = nvs::warp_sum(sum);
    float dot = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      av[h] /= sum;
      da[i][h] += a.dm[(long long)b * KP + kk[h]];
      dot = fmaf(av[h], da[i][h], dot);
    }
    dot = nvs::warp_sum(dot);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s_a[p * KP + kk[h]] = av[h];
      s_dl[p * KP + kk[h]] = p < n ? av[h] * (da[i][h] - dot) : 0.f;
    }
  }
  __syncwarp();

  // 4. dx^ = a du + dl W^T: lane takes channels lane + 32 j
  const float* dub = a.du + (long long)b * KP * CP;
  float g[NP][NC] = {};
  for (int k = 0; k < K; ++k) {
    float u[NC], wt[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      u[j] = __ldg(dub + k * CP + lane + 32 * j);
      wt[j] = __ldg(a.w_t + k * CP + lane + 32 * j);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float ak = s_a[(p0 + i) * KP + k];
      const float dk = s_dl[(p0 + i) * KP + k];
#pragma unroll
      for (int j = 0; j < NC; ++j)
        g[i][j] = fmaf(dk, wt[j], fmaf(ak, u[j], g[i][j]));
    }
  }

  // 5. the pixels' norm backward: dx = (dx^ - (dx^ . x^) x^) / den; at
  // bf16 with dx^ rounded to bf16 and x^ = x / den unrounded (x read again)
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = p0 + i;
    float xh[NC], dot = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (kBf16) {
        g[i][j] = round_bf16(g[i][j]);
        xh[j] = p < n && c < C
                    ? load_f32(xb + (long long)(s0 + p) * a.sx_s +
                               (long long)c * a.sx_c) /
                          den[i]
                    : 0.f;
      } else {
        xh[j] = s_x[p * LDX + c];
      }
      dot = fmaf(g[i][j], xh[j], dot);
    }
    dot = nvs::warp_sum(dot);
#pragma unroll
    for (int j = 0; j < NC; ++j) g[i][j] = (g[i][j] - dot * xh[j]) / den[i];
  }

  // 6. the tile's partial: x^T dl (thread: 16 channels by 4 clusters) and
  // the column sums of dl, pixels in order
  __syncthreads();
  {
    const int k4 = tid % (KP / 4), c0 = tid / (KP / 4) * 16;
    float w[16][4] = {};
    mac_cols<16, P>(s_x + c0, LDX, s_dl + 4 * k4, KP, w);
    float* part = a.dw_part + blockIdx.x * part_floats(CP, KP);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<float4*>(part + (c0 + i) * KP + 4 * k4) =
          make_float4(w[i][0], w[i][1], w[i][2], w[i][3]);
    if (tid < KP) {
      float v = 0.f;
      for (int p = 0; p < P; ++p) v += s_dl[p * KP + tid];
      part[CP * KP + tid] = v;
    }
  }
  __syncthreads();

  // 7. dx through shared memory, stored as x was read
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) s_x[(p0 + i) * LDX + lane + 32 * j] = g[i][j];
  __syncthreads();
  T* dxb = static_cast<T*>(a.dx) + b * a.sd_b;
  const bool dnhwc = a.sd_c == 1;
  for (int e = tid; e < P * CP; e += kWideThreads) {
    const int p = dnhwc ? e / CP : e % P, c = dnhwc ? e % CP : e / P;
    if (p < n && c < C)
      store_as(dxb + (long long)(s0 + p) * a.sd_s + (long long)c * a.sd_c,
               s_x[p * LDX + c]);
  }
}

// kernel<<<grid, threads, smem, stream>>>(args...), allowed to start while
// the previous kernel on the stream runs (it waits for it inside)
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), int grid, int threads,
                       size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The instance for widths C, K: (48, 32), (48, 64), (64, 64) or
// (128, 64), the first that holds them; (256, 64) the wide kernel
struct BwdWidths {
  int cp, kp;
};

BwdWidths bwd_widths(int C, int K) {
  if (C <= 48) return {48, K <= 32 ? 32 : 64};
  if (C > 128) return {kWideCP, kWideKP};
  return {C <= 64 ? 64 : 128, 64};
}

int bwd_tiles(int S, int C) {
  const int tile = C > 128 ? kWideTile : kBwdTile;
  return (S + tile - 1) / tile;
}

int bwd_blocks(int B, int S) {
  return (B * bwd_tiles(S, 0) + kCluster - 1) / kCluster * kCluster;
}

// The dW partials at widths C: one a cluster of tiles, or one a wide block
int bwd_parts(int B, int S, int C) {
  return C > 128 ? B * bwd_tiles(S, C) : bwd_blocks(B, S) / kCluster;
}

// The scratch's parts, in floats from its start (16-byte aligned each but
// the last)
struct BwdScratch {
  long long du, du_t, w_t, dm, dw_part, dcen_part, total;
};

BwdScratch bwd_scratch(int B, int S, int C, int K) {
  const BwdWidths w = bwd_widths(C, K);
  const long long pc = (long long)w.cp * w.kp;
  BwdScratch s;
  s.du = 0;
  s.du_t = s.du + B * pc;
  s.w_t = s.du_t + B * pc;
  s.dm = s.w_t + pc;
  s.dw_part = s.dm + (long long)B * w.kp;
  s.dcen_part = s.dw_part + bwd_parts(B, S, C) * part_floats(w.cp, w.kp);
  s.total = s.dcen_part + (long long)B * K * C;
  return s;
}

template <int CP, int KP, typename T>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(float) * BwdCfg<CP, KP>::kFloats;
  cudaError_t err = nvs::once_per_device([] {
    return cudaFuncSetAttribute(
        netvlad_bwd_tile<CP, KP, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kSmem > kOneBlockSmem ? kSmem : kOneBlockSmem));
  });
  if (err != cudaSuccess) return err;
  netvlad_bwd_prologue<CP, KP>
      <<<dim3(KP / 8, a.B), kPrologueThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // when the tiles fit the card at once, dynamic shared memory above half
  // an SM's keeps the cluster scheduler from placing two on one SM
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int blocks = bwd_blocks(a.B, a.S);
  const size_t smem = blocks <= sms && kSmem < kOneBlockSmem ? kOneBlockSmem
                                                             : kSmem;
  if ((err = launch_pdl(netvlad_bwd_tile<CP, KP, T>, blocks, kBwdThreads,
                        smem, stream, a)) != cudaSuccess)
    return err;
  return launch_pdl(netvlad_bwd_reduce<CP, KP>,
                    (2 * a.K * a.C + a.K + 255) / 256, 256, 0, stream, a,
                    blocks / kCluster);
}

// The backward at 128 < C <= 256: the prologue, the wide tiles, the
// reduction, in stream order.
template <typename T>
cudaError_t launch_bwd_wide(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = nvs::once_per_device([] {
    return cudaFuncSetAttribute(netvlad_bwd_wide<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kWideSmem);
  });
  if (err != cudaSuccess) return err;
  netvlad_bwd_prologue<kWideCP, kWideKP>
      <<<dim3(kWideKP / 8, a.B), kPrologueThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  netvlad_bwd_wide<T><<<a.B * a.tiles, kWideThreads, kWideSmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  netvlad_bwd_reduce<kWideCP, kWideKP>
      <<<(2 * a.K * a.C + a.K + 255) / 256, 256, 0, stream>>>(
          a, a.B * a.tiles);
  return cudaGetLastError();
}

}  // namespace

// Floats of the partial scratch one image of S pixels needs at widths C, K:
// one K*C + K partial a cluster.
extern "C" int nvs_netvlad_partial_size(int S, int C, int K) {
  return blocks_per_image(S) / kCluster * (K * C + K);
}

// x (B,S,C) float32 with element strides [b, s, c]; assign_w (C,K),
// centroids (K,C) contiguous, assign_b (K) or null (no bias); partial
// (B, nvs_netvlad_partial_size) float scratch; counter (B) unsigned ints,
// zero before the first launch (each
// launch leaves them zero); out contiguous (B, K*C); residual (B, K*C) and
// mass (B, K) contiguous, or both null (not written). One launch.
extern "C" int nvs_netvlad(const float* x, const long long* sx,
                           const float* assign_w, const float* assign_b,
                           const float* centroids, float* partial,
                           unsigned int* counter, float* out,
                           float* residual, float* mass, int B, int S, int C,
                           int K, cudaStream_t stream) {
  return launch(x, false, sx, assign_w, assign_b, centroids, partial,
                counter, out, residual, mass, B, S, C, K, stream);
}

// The same with a bfloat16 x; everything else float32.
extern "C" int nvs_netvlad_bf16(const __nv_bfloat16* x, const long long* sx,
                                const float* assign_w, const float* assign_b,
                                const float* centroids, float* partial,
                                unsigned int* counter, float* out,
                                float* residual, float* mass, int B, int S,
                                int C, int K, cudaStream_t stream) {
  return launch(x, true, sx, assign_w, assign_b, centroids, partial, counter,
                out, residual, mass, B, S, C, K, stream);
}

// Floats of the backward's scratch at batch B: du, du^T, W^T and dm at the
// instance's widths, the clusters' dW partials and the images' dcen
// partials.
extern "C" int nvs_netvlad_backward_scratch_size(int B, int S, int C, int K) {
  return (int)bwd_scratch(B, S, C, K).total;
}

namespace {

template <typename T>
int backward(const float* gy, const T* x, const long long* sx,
             const float* assign_w, const float* assign_b,
             const float* centroids, const float* residual,
             const float* mass, T* dx, const long long* sdx, float* scratch,
             float* dw, float* dcen, float* db, int B, int S, int C, int K,
             cudaStream_t stream) {
  if (K < 1 || K > kMaxK || C < 1 || C > kMaxC || S < 1 || B < 1 ||
      B > 65535 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const BwdScratch s = bwd_scratch(B, S, C, K);
  const BwdArgs args{gy,     x,      sx[0],     sx[1],  sx[2],
                     assign_w, centroids, residual, mass, dx,
                     sdx[0], sdx[1], sdx[2],    scratch + s.du,
                     scratch + s.du_t,  scratch + s.w_t, scratch + s.dm,
                     scratch + s.dw_part, scratch + s.dcen_part, dw, dcen,
                     assign_b, db,
                     B,      S,      C,         K,
                     bwd_tiles(S, C)};
  const BwdWidths w = bwd_widths(C, K);
  if (w.cp == kWideCP) return (int)launch_bwd_wide<T>(args, stream);
  if (w.cp == 48)
    return (int)(w.kp == 32 ? launch_bwd<48, 32, T>(args, stream)
                            : launch_bwd<48, 64, T>(args, stream));
  return (int)(w.cp == 64 ? launch_bwd<64, 64, T>(args, stream)
                          : launch_bwd<128, 64, T>(args, stream));
}

}  // namespace

// gy (B, K*C), residual (B, K*C) and mass (B, K) from nvs_netvlad,
// assign_w (C, K), assign_b (K) or null and centroids (K, C) contiguous,
// float32; x and dx (B, S, C) with element strides sx, sdx [b, s, c];
// scratch of nvs_netvlad_backward_scratch_size floats, 16-byte aligned;
// dw (C, K), dcen (K, C), db (K) or null contiguous. Three launches (the
// images' prologue, the tiles, the fixed-order reduction), at C <= 128 the
// last two programmatically dependent.
extern "C" int nvs_netvlad_backward(
    const float* gy, const float* x, const long long* sx,
    const float* assign_w, const float* assign_b, const float* centroids,
    const float* residual, const float* mass, float* dx,
    const long long* sdx, float* scratch, float* dw, float* dcen, float* db,
    int B, int S, int C, int K, cudaStream_t stream) {
  return backward(gy, x, sx, assign_w, assign_b, centroids, residual, mass,
                  dx, sdx, scratch, dw, dcen, db, B, S, C, K, stream);
}

// The same with a bfloat16 x and dx (residual and mass from
// nvs_netvlad_bf16); everything else float32.
extern "C" int nvs_netvlad_backward_bf16(
    const float* gy, const __nv_bfloat16* x, const long long* sx,
    const float* assign_w, const float* assign_b, const float* centroids,
    const float* residual, const float* mass, __nv_bfloat16* dx,
    const long long* sdx, float* scratch, float* dw, float* dcen, float* db,
    int B, int S, int C, int K, cudaStream_t stream) {
  return backward(gy, x, sx, assign_w, assign_b, centroids, residual, mass,
                  dx, sdx, scratch, dw, dcen, db, B, S, C, K, stream);
}
