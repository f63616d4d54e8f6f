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
// Design at C <= 128 (netvlad_kernel). A block takes kTile = 64 pixels of
// one image in one pass: it
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
// Design at 128 < C <= 256 (netvlad_wide_kernel; KeypointFormer's head,
// C = 256, K = 64). One block holding all of W (64 KiB) and a 64-pixel tile
// would be one block an SM, with W staged again by every block. Instead a
// cluster of 8 blocks takes two tiles of 32 pixels at a time, block
// (sl, h) the slice of 64 channels sl of tile h, and keeps its slice of W
// (16 KiB) for the whole launch: the clusters, as many as the card holds
// at once shared out over the images (the grid is fixed for a card and a
// shape), walk their image's pairs of tiles in a fixed order, the next
// tile's x in flight while one is computed. A tile's logits are a partial
// a slice (its channels split over two warp halves, register tiles of 4
// pixels by 4 clusters on float4 loads of W), added with the pixels'
// |x|^2 over distributed shared memory in rank order, double-buffered so
// that one cluster barrier a tile suffices (two at bf16, whose x^ is
// rounded before the products); the slice's a^T x^ is summed in registers
// over the walk. At its end each block adds its rows over the pair's two
// tiles into the cluster's partial, and the image's last cluster (the same
// counter) adds the partials in order, subtracts the centroid term and
// normalises, the rows' and the global sums of squares added over the
// slices in rank order. An image of 221 pixels takes 4 pairs of tiles, no
// padding block.
//
// Bound on an H100: operations, barely. At 240x320 (S = 4800, C = 48,
// K = 32) an image is 2 * 2*S*C*K = 29.5 MFLOP against 0.9 MB read, about
// 0.44 us at 67 TFLOP/s (float32, CUDA cores) and 0.28 us at 3.35 TB/s. The
// kernel is bound by the latency of its chain (stage, logits, sums, cluster
// reduce, last-cluster finish), which the design keeps to one pass.
// KeypointFormer's head (C = 256, K = 64, x (33, 41) at 256x320) is 88.7
// MFLOP an image, 1.3 us at 67 TFLOP/s. The wide kernel is bound by its
// chain a tile (a tile's loads, the partial logits, a cluster barrier, the
// softmax over remote partials, a^T x^), which phase timers on the card
// found several times longer than its products, and at batch 8 by the
// length of the walk (an image's 22 pairs over a few clusters each).
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
// by C (<= 64, <= 128). Above C = 128 netvlad_wide_kernel (below) runs.
constexpr int kNarrowMaxC = 128;
void (*const kKernels[2][2][2])(Args) = {
    {{netvlad_kernel<8, 2, 4, float>, netvlad_kernel<8, 2, 8, float>},
     {netvlad_kernel<16, 4, 4, float>, netvlad_kernel<16, 4, 8, float>}},
    {{netvlad_kernel<8, 2, 4, __nv_bfloat16>,
      netvlad_kernel<8, 2, 8, __nv_bfloat16>},
     {netvlad_kernel<16, 4, 4, __nv_bfloat16>,
      netvlad_kernel<16, 4, 8, __nv_bfloat16>}}};

// Raises the dynamic shared-memory limit of every instance once per device
// to the most the widths can ask (C = 128, K = 64: 82,720 bytes).
cudaError_t set_smem_limits() {
  return nvs::once_per_device([] {
    cudaError_t err = cudaSuccess;
    for (auto& type : kKernels)
      for (auto& row : type)
        for (auto kernel : row)
          if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem_bytes(kNarrowMaxC, kMaxK));
    return err;
  });
}

// Blocks a launch takes for one image of S pixels: a multiple of the
// cluster size.
int blocks_per_image(int S) {
  const int p = (S + kTile - 1) / kTile;
  return (p + kCluster - 1) / kCluster * kCluster;
}

template <typename T>
cudaError_t launch_wide(const Args& a, int B, cudaStream_t stream);

int launch(const void* x, bool bf16, const long long* sx,
           const float* assign_w, const float* assign_b,
           const float* centroids, float* partial,
           unsigned int* counter, float* out, float* residual, float* mass,
           int B, int S, int C, int K, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || C < 1 || C > kMaxC || S < 1 || B < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = C > kNarrowMaxC ? cudaSuccess : set_smem_limits();
  if (err != cudaSuccess) return (int)err;
  const Args args{x,         sx[0],    sx[1],   sx[2], assign_w,
                  assign_b,  centroids, partial, counter, out,
                  residual,  mass,      S,       C,     K};
  if (C > kNarrowMaxC)
    return (int)(bf16 ? launch_wide<__nv_bfloat16>(args, B, stream)
                      : launch_wide<float>(args, B, stream));
  kKernels[bf16][K > 32][C > 64]<<<dim3(blocks_per_image(S), B), kThreads,
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
// Design at C <= 128: three launches, chained by programmatic dependent
// launch.
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
// Phase timers on the card: a design with a block a 32-pixel tile, the
// image's prologue in every block and scalar products over shared memory
// spent 38% of a block on the repeated prologue and 44% on the products.
// A 3xTF32 tensor-core version of the products (mma.sync m16n8k8, x^ and
// [a | dl] split once into hi and lo) was slower than these register
// tiles: each fragment is 8 scalar loads from shared memory, which then
// bound it.
// Design at 128 < C <= 256 (KeypointFormer's "default" head, C = 256,
// K = 64), where [W | du^T] and [du ; W^T] of a whole image would take
// 256 KiB of shared memory: two launches, netvlad_bwd_wide and the same
// reduction by programmatic dependent launch. A cluster of 4 blocks takes
// a tile of 32 pixels, block sl the channels [64 sl, 64 sl + 64), and
// stages its slices of W (cp.async), x, u, gy and the centroids once (28
// clusters, 112 blocks at the train shape's x (4, 13, 17, 256)). It
// derives the prologue's du and dm itself: the rows' |u_k|^2 and
// gy_k . u_k and the pixels' |x|^2 are partials a slice, added over
// distributed shared memory in rank order, so that every tile of an image
// gets the same du. du^T sits beside W in one padded [W | du^T] (a row a
// channel), which the products read as it is for the logits and da and
// transposed for dx^ = [dl | a] [W | du^T]^T: nothing is written twice.
// The slice's [l | da + dm] is a partial added over distributed shared
// memory in rank order, the softmax and dl follow in every block, and
// dx^, x^T dl and the norm's dot (a third exchange) are register tiles
// over shared memory (float4 loads, fixed orders of sums). Each tile
// writes its x^T dl and column sums of dl as a partial, the image's first
// tile -m (.) du as the image's dcen partial. The products stay on the
// CUDA cores: 3xTF32 fragments cost the loads above, and phase timers on
// the card found the tile's barriers and loads, not its products, taking
// most of a block's time.
//
// Bound on an H100: operations. At config S's train shape (B = 4, S =
// 1200, C = K = 64) the five S x K x C products are 197 MFLOP against ~2.6
// MB moved: 2.9 us at 67 TFLOP/s; at KeypointFormer's (B = 4, S = 221,
// C = 256, K = 64), 145 MFLOP: 2.2 us.

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

// ------------------------------------------------------- 128 < C <= 256
//
// The forward and the backward above C = 128 (see the notes at the head of
// the file and of the backward): a tile of kWideP pixels is shared by the
// kWideSlices blocks of a thread-block cluster (two tiles by a forward
// cluster), each holding one slice of kWideCS channels of x and W (and of
// u, gy and the centroids) in its own shared memory. Whatever sums over C
// (the pixels' norms, the logits, da, the rows' norms, dx^ . x^) is a
// partial a block, added over distributed shared memory in rank order, so
// that every block of a tile gets the same bits.
constexpr int kWideSlices = 4;                 // blocks splitting C
constexpr int kWideCS = kMaxC / kWideSlices;   // channels a block
constexpr int kWideP = 32;                     // pixels a tile
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideLdp = kWideP + 4;           // a row over the tile's pixels
constexpr int kWideLdk = kMaxK + 4;            // a row over the clusters
constexpr int kWideLdj = 2 * kMaxK + 4;        // a row over [W | du^T]
constexpr int kWideTiles = 2;                  // tiles a forward cluster
constexpr int kWideCluster = kWideSlices * kWideTiles;
constexpr int kWideCP = kMaxC, kWideKP = kMaxK;  // the dW partials' widths
static_assert(kWideCS == 64 && kWideThreads == 256 && kWideP == 32,
              "the thread maps below");

// All threads of all blocks of the cluster: arrive after the block's last
// read of a peer's shared memory, wait before it exits (cluster.sync() in
// two halves).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void add4(float (&acc)[4], float4 v) {
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

// sum_d a[d] b[d] over a float4 each, added to acc in d order
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// A slice of x's tile into registers: element e = tid + 256 i is pixel p,
// channel c of the slice (NHWC memory: neighbouring threads, channels;
// NCHW: pixels); zeros past the image's last pixel and past C.
template <typename T>
__device__ __forceinline__ void load_x_slice(const T* xb, long long sx_s,
                                             long long sx_c, int s0, int n,
                                             int c0, int cn,
                                             float (&v)[kWideP * kWideCS /
                                                        kWideThreads]) {
  const bool nhwc = sx_c == 1;
#pragma unroll
  for (int i = 0; i < kWideP * kWideCS / kWideThreads; ++i) {
    const int e = threadIdx.x + kWideThreads * i;
    const int p = nhwc ? e / kWideCS : e % kWideP;
    const int c = nhwc ? e % kWideCS : e / kWideP;
    v[i] = p < n && c < cn ? load_f32(xb + (long long)(s0 + p) * sx_s +
                                      (long long)(c0 + c) * sx_c)
                           : 0.f;
  }
}

// ... and from registers to shared memory, channel-major (c x kWideLdp)
__device__ __forceinline__ void store_x_slice(
    float* dst, long long sx_c,
    const float (&v)[kWideP * kWideCS / kWideThreads]) {
  const bool nhwc = sx_c == 1;
#pragma unroll
  for (int i = 0; i < kWideP * kWideCS / kWideThreads; ++i) {
    const int e = threadIdx.x + kWideThreads * i;
    const int p = nhwc ? e / kWideCS : e % kWideP;
    const int c = nhwc ? e % kWideCS : e / kWideP;
    dst[c * kWideLdp + p] = v[i];
  }
}

// A pixel's |x|^2 over a block's slice, 8 lanes a pixel (channels j8 + 8 i
// of the channel-major tile xt), in every lane of the 8: in float32, or
// (kExact, for a bf16 x) in double, where each x^2 is exact and the sum
// over C rounds once, to the float32 that a correctly rounded sum gives,
// so that x / den rounds to bf16 as the twin's normalisation does and not
// a bf16 ulp away at the odd element near a midpoint.
template <bool kExact>
__device__ __forceinline__ double slice_sumsq(const float* xt, int px,
                                              int j8) {
  if constexpr (kExact) {
    double ss = 0.0;
#pragma unroll
    for (int i = 0; i < kWideCS / 8; ++i) {
      const double v = xt[(j8 + 8 * i) * kWideLdp + px];
      ss = fma(v, v, ss);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    return ss;
  } else {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kWideCS / 8; ++i) {
      const float v = xt[(j8 + 8 * i) * kWideLdp + px];
      ss = fmaf(v, v, ss);
    }
    return group_reduce<8, false>(ss);
  }
}

// ... and over the kWideSlices slices whose blocks are ranks r0 .. of the
// cluster (their slice_sumsq at buf + px), in rank order
template <bool kExact>
__device__ __forceinline__ float tile_sumsq(const cg::cluster_group& cluster,
                                            double* buf, int r0) {
  if constexpr (kExact) {
    double ss = 0.0;
#pragma unroll
    for (int q = 0; q < kWideSlices; ++q)
      ss += *cluster.map_shared_rank(buf, r0 + q);
    return (float)ss;
  } else {
    float ss = 0.f;
#pragma unroll
    for (int q = 0; q < kWideSlices; ++q)
      ss += (float)*cluster.map_shared_rank(buf, r0 + q);
    return ss;
  }
}

// W's rows [c0, c0 + cn) into dst (kWideCS rows of ld floats, columns
// [0, kMaxK)), zeros past C and K: cp.async through L1, 16 bytes a copy
// where W's rows are 16-byte aligned, else 4; one commit group.
__device__ __forceinline__ void stage_w_slice(float* dst, int ld,
                                              const float* w, int K, int c0,
                                              int cn) {
  if (K % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kWideCS * kMaxK / 4 / kWideThreads; ++i) {
      const int e = threadIdx.x + kWideThreads * i;
      const int c = e / (kMaxK / 4), k = 4 * (e % (kMaxK / 4));
      const bool in = c < cn && k < K;
      nvs::cp_async16_ca(dst + c * ld + k,
                         in ? w + (long long)(c0 + c) * K + k : w, in);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kWideCS * kMaxK / kWideThreads; ++i) {
      const int e = threadIdx.x + kWideThreads * i;
      const int c = e / kMaxK, k = e % kMaxK;
      const bool in = c < cn && k < K;
      nvs::cp_async4(dst + c * ld + k,
                     in ? w + (long long)(c0 + c) * K + k : w, in);
    }
  }
  nvs::cp_async_commit();
}

// The forward at 128 < C <= 256: a cluster of kWideCluster blocks walks
// pairs of tiles of kWideP pixels of one image (pairs cl, cl + ncl, ...;
// ncl from wide_clusters: as many clusters as the card holds at once);
// block (slice sl, tile h) keeps W's rows [64 sl, 64 sl + 64) for the whole
// walk and takes tile h of each pair, summing its a^T x^ in registers.
// T: x's type.
template <typename T>
__global__ void __cluster_dims__(kWideCluster, 1, 1)
    __launch_bounds__(kWideThreads, 2) netvlad_wide_kernel(Args a) {
  constexpr bool kRoundX = std::is_same<T, __nv_bfloat16>::value;
  constexpr int P = kWideP, CS = kWideCS, KP = kMaxK;
  constexpr int LDP = kWideLdp, LDK = kWideLdk;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // CS x LDK: W's rows
  float* s_xt = s_w + CS * LDK;   // CS x LDP: x (x^ at bf16), channel-major
  float* s_l = s_xt + CS * LDP;   // 2 x P x LDK: the slice's logits
  float* s_lh = s_l + 2 * P * LDK;  // P x LDK: its upper half of channels'
  float* s_at = s_lh + P * LDK;     // KP x LDP: a^T / den
  float* s_a = s_at + KP * LDP;     // KP x LDP: a^T
  float* s_u = s_at;  // KP x LDK: the walk's a^T x^ (s_at's, s_a's space)
  // 2 x P: the slice's |x|^2 (in double: see slice_sumsq)
  double* s_ss = reinterpret_cast<double*>(s_a + KP * LDP);
  float* s_m = reinterpret_cast<float*>(s_ss + 2 * P);  // KP: the masses
  float* s_row = s_m + KP;        // 32: the finish's rows, slice's |v|^2
  float* s_red = s_row + 32;      // kWideWarps
  float* s_bias = s_red + kWideWarps;  // KP
  __shared__ float s_blk;
  __shared__ int s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int sl = rank % kWideSlices, h = rank / kWideSlices;
  const int hr = h * kWideSlices;  // the tile's first rank
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, K = a.K, b = blockIdx.y;
  const int cl = blockIdx.x / kWideCluster, ncl = gridDim.x / kWideCluster;
  const int c0 = sl * CS, cn = min(CS, C - c0);  // cn <= 0: an empty slice
  const int pairs = (a.S + kWideTiles * P - 1) / (kWideTiles * P);
  const T* xb = static_cast<const T*>(a.x) + (long long)b * a.sx_b;
  const int px = tid >> 3, j8 = tid & 7;  // a pixel (or a row), 8 lanes
  const int cg = lane & 15, kg = 2 * warp + (lane >> 4);  // a^T x^'s

  // W's slice by cp.async, the bias (zeros without one); the first pair's
  // x through registers (each next pair's loads are in flight while this
  // one is computed)
  stage_w_slice(s_w, LDK, a.assign_w, K, c0, cn);
  if (tid < KP)
    s_bias[tid] = a.assign_b != nullptr && tid < K ? __ldg(a.assign_b + tid)
                                                   : 0.f;
  float xv[P * CS / kWideThreads];
  const int step = ncl * kWideTiles * P;  // pixels from a tile to the next
  int s0 = (cl * kWideTiles + h) * P;     // the tile's first pixel
  load_x_slice(xb, a.sx_s, a.sx_c, s0, a.S - s0, c0, cn, xv);
  float acc[4][4] = {}, mass = 0.f;
  for (int pr = cl, it = 0; pr < pairs; pr += ncl, ++it, s0 += step) {
    const int n = min(P, a.S - s0);  // n <= 0: a padding tile
    float* l_buf = s_l + (it & 1) * P * LDK;  // peers read the last tile's
    double* ss_buf = s_ss + (it & 1) * P;
    store_x_slice(s_xt, a.sx_c, xv);
    if (pr + ncl < pairs)
      load_x_slice(xb, a.sx_s, a.sx_c, s0 + step, a.S - s0 - step, c0, cn,
                   xv);
    __syncthreads();

    // 1. the pixels' |x|^2 over the slice (8 lanes a pixel)
    {
      const double ss = slice_sumsq<kRoundX>(s_xt, px, j8);
      if (j8 == 0) ss_buf[px] = ss;
    }
    if constexpr (kRoundX) {
      // x^ = x / den rounded to bf16 before the products, as the module
      cluster.sync();
      const float den =
          l2_denominator(tile_sumsq<true>(cluster, ss_buf + px, hr));
#pragma unroll
      for (int i = 0; i < CS / 8; ++i) {
        float* v = s_xt + (j8 + 8 * i) * LDP + px;
        *v = round_bf16(*v / den);
      }
    }
    nvs::cp_async_wait<0>();  // W (the first tile)
    __syncthreads();

    // 2. the slice's logits: warps 0-3 take its channels [0, 32), warps
    // 4-7 [32, 64), added in that order; thread pixels 4 pq .., clusters
    // 4 kq ..
    {
      const int kq = lane & 15, pq = 2 * (warp & 3) + (lane >> 4);
      const int half = warp >> 2;
      float l[4][4] = {};
#pragma unroll 8
      for (int c = half * (CS / 2); c < (half + 1) * (CS / 2); ++c) {
        const float4 x4 = ld4(s_xt + c * LDP + 4 * pq);
        const float4 wv = ld4(s_w + c * LDK + 4 * kq);
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          l[i][0] = fmaf(xs[i], wv.x, l[i][0]);
          l[i][1] = fmaf(xs[i], wv.y, l[i][1]);
          l[i][2] = fmaf(xs[i], wv.z, l[i][2]);
          l[i][3] = fmaf(xs[i], wv.w, l[i][3]);
        }
      }
      if (half)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(s_lh + (4 * pq + i) * LDK + 4 * kq) =
              make_float4(l[i][0], l[i][1], l[i][2], l[i][3]);
      __syncthreads();
      if (!half)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = ld4(s_lh + (4 * pq + i) * LDK + 4 * kq);
          *reinterpret_cast<float4*>(l_buf + (4 * pq + i) * LDK + 4 * kq) =
              make_float4(l[i][0] + v.x, l[i][1] + v.y, l[i][2] + v.z,
                          l[i][3] + v.w);
        }
    }
    cluster.sync();  // every slice's logits (and |x|^2) written

    // 3. the tile's logits, slices added in rank order; softmax (8 lanes a
    // pixel: clusters 4 j8 .. 4 j8 + 3 and 32 + 4 j8 ..)
    {
      float l[8] = {};
#pragma unroll
      for (int q = 0; q < kWideSlices; ++q) {
        const float* r = cluster.map_shared_rank(l_buf, hr + q) + px * LDK;
        const float4 v0 = ld4(r + 4 * j8), v1 = ld4(r + 32 + 4 * j8);
        const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) l[i] += v[i];
      }
      float den = 1.f;  // at bf16 x^ is normalised already
      if constexpr (!kRoundX)
        den = l2_denominator(tile_sumsq<false>(cluster, ss_buf + px, hr));
      const float neg_inf = -__int_as_float(0x7f800000);
      float mx = neg_inf;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = (i & 3) + 4 * j8 + 32 * (i >> 2);
        l[i] = k >= K ? neg_inf : l[i] / den + s_bias[k];
        mx = fmaxf(mx, l[i]);
      }
      mx = group_reduce<8, true>(mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        l[i] = expf(l[i] - mx);  // 0 past K
        sum += l[i];
      }
      sum = group_reduce<8, false>(sum);
      const float inv = 1.f / den;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = (i & 3) + 4 * j8 + 32 * (i >> 2);
        const float av = px < n ? l[i] / sum : 0.f;
        s_a[k * LDP + px] = av;
        s_at[k * LDP + px] = av * inv;
      }
    }
    __syncthreads();

    // 4. the tile's a^T x^ over the slice, added to the walk's (thread
    // clusters 4 kg .., channels cg + 16 u; pixels in order), and masses
#pragma unroll 2
    for (int p = 0; p < P; p += 4) {
      float4 av[4], x4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = ld4(s_at + (4 * kg + i) * LDP + p);
#pragma unroll
      for (int u = 0; u < 4; ++u) x4[u] = ld4(s_xt + (cg + 16 * u) * LDP + p);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][u] = dot4(av[i], x4[u], acc[i][u]);
    }
    if (tid < KP) {
      float m = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p) m += s_a[tid * LDP + p];
      mass += m;
    }
    __syncthreads();  // s_xt, s_at and s_a free for the next tile
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      s_u[(4 * kg + i) * LDK + cg + 16 * u] = acc[i][u];
  if (tid < KP) s_m[tid] = mass;
  cluster.sync();

  // 5. the cluster's partial: block (sl, h) adds rows [32 h, 32 h + 32) of
  // its slice over the two tiles' walks, in tile order (block (0, h) the
  // masses)
  const long long nv = (long long)K * C + K;
  {
    float* part = a.partial + ((long long)b * ncl + cl) * nv;
    const int k = 32 * h + px;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = 4 * j8 + 32 * i;
      float sum[4] = {};
#pragma unroll
      for (int t = 0; t < kWideTiles; ++t)
        add4(sum, ld4(cluster.map_shared_rank(s_u, t * kWideSlices + sl) +
                      k * LDK + c));
      if (k < K)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < cn) part[(long long)k * C + c0 + c + u] = sum[u];
    }
    if (sl == 0 && tid < 32 && 32 * h + tid < K) {
      float m = 0.f;
#pragma unroll
      for (int t = 0; t < kWideTiles; ++t)
        m += *cluster.map_shared_rank(s_m + 32 * h + tid, t * kWideSlices);
      part[(long long)K * C + 32 * h + tid] = m;
    }
  }
  __threadfence();
  cluster.sync();  // partials written and fenced; remote reads done
  if (rank == 0 && tid == 0) {
    const unsigned int done = atomicAdd(a.counter + b, 1u) + 1;
    const int last = done == (unsigned int)ncl;
    if (last) a.counter[b] = 0;  // ready for the next launch
    for (int q = 0; q < kWideCluster; ++q)
      *cluster.map_shared_rank(&s_last, q) = last;
  }
  cluster.sync();
  if (!s_last) return;  // the whole cluster: not the image's last
  __threadfence();

  // 6. the last cluster: block (sl, h) finishes rows [32 h, 32 h + 32) of
  // its slice, 8 lanes a row (channels j8 + 8 i): the clusters' partials
  // in order (four in flight at once), the centroid term, the rows' norms
  // over the slices (in rank order), the global norm over the cluster's
  // blocks (in rank order)
  const int k = 32 * h + px;
  const bool row_in = k < K;
  const float* pb = a.partial + (long long)b * ncl * nv;
  float m = 0.f, v[8] = {};
  if (row_in) {
    const float* pm = pb + (long long)K * C + k;
    const float* pr = pb + (long long)k * C + c0 + j8;
    int q = 0;
    for (; q + 4 <= ncl; q += 4) {
      float mm[4], t[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mm[u] = __ldcg(pm + (q + u) * nv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          t[u][i] = j8 + 8 * i < cn ? __ldcg(pr + (q + u) * nv + 8 * i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        m += mm[u];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] += t[u][i];
      }
    }
    for (; q < ncl; ++q) {
      m += __ldcg(pm + q * nv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (j8 + 8 * i < cn) v[i] += __ldcg(pr + q * nv + 8 * i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = j8 + 8 * i;
    if (row_in && c < cn) {
      v[i] -= m * a.centroids[(long long)k * C + c0 + c];
      if (a.residual != nullptr)
        a.residual[((long long)b * K + k) * C + c0 + c] = v[i];
    } else {
      v[i] = 0.f;
    }
    ss = fmaf(v[i], v[i], ss);
  }
  if (a.mass != nullptr && sl == 0 && j8 == 0 && row_in)
    a.mass[(long long)b * K + k] = m;
  ss = group_reduce<8, false>(ss);
  if (j8 == 0) s_row[px] = ss;
  cluster.sync();
  float rs = 0.f;
#pragma unroll
  for (int q = 0; q < kWideSlices; ++q)
    rs += *cluster.map_shared_rank(s_row + px, hr + q);
  const float den = l2_denominator(rs);
  float ssn = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] /= den;
    ssn = fmaf(v[i], v[i], ssn);
  }
  ssn = group_reduce<8, false>(ssn);  // the row's, in all 8 lanes
  {
    // the warp's four rows in order, then the warps in order
    float w = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) w += __shfl_sync(0xffffffffu, ssn, 8 * r);
    if (lane == 0) s_red[warp] = w;
  }
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWideWarps; ++w) t += s_red[w];
    s_blk = t;
  }
  cluster.sync();
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < kWideCluster; ++q)
    total += *cluster.map_shared_rank(&s_blk, q);
  const float qd = l2_denominator(total);
  if (row_in) {
    float* ob = a.out + ((long long)b * K + k) * C + c0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (j8 + 8 * i < cn) ob[j8 + 8 * i] = v[i] / qd;
  }
  cluster.sync();  // keep s_row and s_blk alive until every block read them
}

size_t wide_smem_bytes() {
  return sizeof(float) * (kWideCS * kWideLdk + kWideCS * kWideLdp +
                          3 * kWideP * kWideLdk + 2 * kMaxK * kWideLdp +
                          4 * kWideP + 2 * kMaxK + 32 + kWideWarps);
}

// Pairs of tiles an image of S pixels has in the forward above C = 128.
int wide_pairs(int S) {
  return (S + kWideTiles * kWideP - 1) / (kWideTiles * kWideP);
}

// The backward's tiles at 128 < C <= 256: a cluster of kWideSlices blocks
// a tile of kWideP pixels, block sl holding channels [64 sl, 64 sl + 64).
// It derives du and dm from u, m and gy itself (every tile of an image the
// same sums in the same order), and writes dx, the tile's x^T dl and
// column sums of dl as a dW partial, and (the image's first tile) -m (.) du
// as the image's dcen partial. T: x's and dx's type.
template <typename T>
__global__ void __cluster_dims__(kWideSlices, 1, 1)
    __launch_bounds__(kWideThreads, 2) netvlad_bwd_wide(BwdArgs a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int P = kWideP, CS = kWideCS, KP = kMaxK;
  constexpr int LDP = kWideLdp, LDJ = kWideLdj;
  extern __shared__ float4 smem4[];
  float* s_b1 = reinterpret_cast<float*>(smem4);  // CS x LDJ: [W | du^T]
  float* s_xt = s_b1 + CS * LDJ;     // CS x LDP: x^, channel-major
  float* s_xr = s_xt + CS * LDP;     // CS x LDP: x (bf16: x / den again)
  float* s_part = s_xr + CS * LDP;   // P x LDJ: the slice's [l | da + dm]
  float* s_dx = s_part;              // CS x LDP: dx (the partials' space)
  float* s_A = s_part + P * LDJ;     // P x LDJ: [dl | a]
  float* s_dlt = s_A + P * LDJ;      // KP x LDP: dl^T
  // P: the slice's |x|^2 (in double: see slice_sumsq)
  double* s_ssx = reinterpret_cast<double*>(s_dlt + KP * LDP);
  float* s_ssu = reinterpret_cast<float*>(s_ssx + P);  // KP: its |u_k|^2
  float* s_gu = s_ssu + KP;          // KP: the slice's gy_k . u_k
  float* s_dmp = s_gu + KP;          // KP: the slice's dm
  float* s_q = s_dmp + KP;           // KP: q_k
  float* s_dk = s_q + KP;            // KP: dv_k . v_k
  float* s_den = s_dk + KP;          // P
  float* s_dotp = s_den + P;         // P: the slice's dx^ . x^
  __shared__ float s_QG[2];
  allow_next_launch();  // the reduction's blocks wait for this grid

  cg::cluster_group cluster = cg::this_cluster();
  const int sl = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, K = a.K;
  const int t = blockIdx.x / kWideSlices;  // the tile
  const int b = t / a.tiles, s0 = (t % a.tiles) * P;
  const int n = min(P, a.S - s0);
  const int c0 = sl * CS, cn = min(CS, C - c0);  // cn <= 0: an empty slice
  const long long KC = (long long)K * C;
  const T* xb = static_cast<const T*>(a.x) + (long long)b * a.sx_b;

  // 1. every load in flight at once: W's slice by cp.async; x's, and the
  // slice of u, gy and the centroids (row kr, channels qr + 4 i) through
  // registers
  stage_w_slice(s_b1, LDJ, a.assign_w, K, c0, cn);
  const int kr = tid >> 2, qr = tid & 3;
  constexpr int RU = CS / 4;
  float u[RU], g[RU], ce[RU];
  {
    const bool in_k = kr < K;
    const float* ub = a.residual + b * KC + (long long)kr * C + c0;
    const float* gb = a.gy + b * KC + (long long)kr * C + c0;
    const float* cb = a.centroids + (long long)kr * C + c0;
#pragma unroll
    for (int i = 0; i < RU; ++i) {
      const int c = qr + 4 * i;
      const bool in = in_k && c < cn;
      u[i] = in ? __ldg(ub + c) : 0.f;
      g[i] = in ? __ldg(gb + c) : 0.f;
      ce[i] = in ? __ldg(cb + c) : 0.f;
    }
  }
  const float mk = kr < K ? __ldg(a.mass + (long long)b * K + kr) : 0.f;
  {
    float xv[P * CS / kWideThreads];
    load_x_slice(xb, a.sx_s, a.sx_c, s0, n, c0, cn, xv);
    store_x_slice(s_xt, a.sx_c, xv);
    if constexpr (kBf16) store_x_slice(s_xr, a.sx_c, xv);
  }
  __syncthreads();

  // 2. the slice's sums: |x|^2 a pixel (8 lanes a pixel), |u_k|^2 and
  // gy_k . u_k a row (4 lanes a row)
  const int px = tid >> 3, j8 = tid & 7;
  {
    const double ss = slice_sumsq<kBf16>(s_xt, px, j8);
    if (j8 == 0) s_ssx[px] = ss;
    float su = 0.f, gu = 0.f;
#pragma unroll
    for (int i = 0; i < RU; ++i) {
      su = fmaf(u[i], u[i], su);
      gu = fmaf(g[i], u[i], gu);
    }
    su = group_reduce<4, false>(su);
    gu = group_reduce<4, false>(gu);
    if (qr == 0) {
      s_ssu[kr] = su;
      s_gu[kr] = gu;
    }
  }
  cluster.sync();

  // 3. the sums over C, slices in rank order: warp 0 the rows' q_k, the
  // global Q and G = gy . y and each row's dv_k . v_k; warp 1 the pixels'
  // denominators
  if (warp == 0) {
    float q[2], ssv[2], gv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = lane + 32 * hh;
      float su = 0.f, gu = 0.f;
#pragma unroll
      for (int r = 0; r < kWideSlices; ++r) {
        su += *cluster.map_shared_rank(s_ssu + k, r);
        gu += *cluster.map_shared_rank(s_gu + k, r);
      }
      q[hh] = l2_denominator(su);
      ssv[hh] = su / (q[hh] * q[hh]);  // |v_k|^2, v_k = u_k / q_k
      gv[hh] = gu / q[hh];             // gy_k . v_k
    }
    const float Q = l2_denominator(nvs::warp_sum(ssv[0] + ssv[1]));
    const float G = nvs::warp_sum(gv[0] + gv[1]) / Q;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      s_q[lane + 32 * hh] = q[hh];
      s_dk[lane + 32 * hh] = (gv[hh] - G * (ssv[hh] / Q)) / Q;
    }
    if (lane == 0) {
      s_QG[0] = Q;
      s_QG[1] = G;
    }
  } else if (warp == 1) {
    s_den[lane] = l2_denominator(tile_sumsq<kBf16>(cluster, s_ssx + lane, 0));
  }
  __syncthreads();

  // 4. x^ = x / den in place (rounded to bf16 at bf16); du^T beside W,
  // the slice's dm, and the image's dcen partial from its first tile
#pragma unroll
  for (int i = 0; i < P * CS / kWideThreads; ++i) {
    const int e = tid + kWideThreads * i, c = e / P, p = e % P;
    const float v = s_xt[c * LDP + p] / s_den[p];
    s_xt[c * LDP + p] = kBf16 ? round_bf16(v) : v;
  }
  {
    // (by reciprocals: within float32 rounding of the chain's divisions)
    const float iq = 1.f / s_q[kr], dk = s_dk[kr], iQ = 1.f / s_QG[0];
    const float G = s_QG[1];
    const bool first = t % a.tiles == 0 && kr < K;
    float* dcb = a.dcen_part + b * KC + (long long)kr * C + c0;
    float dm = 0.f;
#pragma unroll
    for (int i = 0; i < RU; ++i) {
      const int c = qr + 4 * i;
      const float v = u[i] * iq;
      const float dv = (g[i] - G * (v * iQ)) * iQ;
      const float du = (dv - dk * v) * iq;  // 0 past C and K
      s_b1[c * LDJ + KP + kr] = du;
      dm = fmaf(du, ce[i], dm);
      if (first && c < cn) dcb[c] = -mk * du;
    }
    dm = group_reduce<4, false>(dm);
    if (qr == 0) s_dmp[kr] = -dm;
  }
  nvs::cp_async_wait<0>();
  __syncthreads();

  // 5. the slice's [l | da] = x^ [W | du^T] over its channels, in channel
  // order (thread pixels 4 pg .., columns 4 jg ..), its dm added to da
  {
    const int jg = (warp & 3) * 8 + (lane & 7);
    const int pg = (warp >> 2) * 4 + (lane >> 3);
    float acc[4][4] = {};
#pragma unroll 4
    for (int c = 0; c < CS; ++c) {
      const float4 xv = ld4(s_xt + c * LDP + 4 * pg);
      const float4 bv = ld4(s_b1 + c * LDJ + 4 * jg);
      const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(x4[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(x4[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(x4[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(x4[i], bv.w, acc[i][3]);
      }
    }
    if (4 * jg >= KP) {
      const float4 dm = ld4(s_dmp + 4 * jg - KP);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += dm.x;
        acc[i][1] += dm.y;
        acc[i][2] += dm.z;
        acc[i][3] += dm.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(s_part + (4 * pg + i) * LDJ + 4 * jg) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  cluster.sync();

  // 6. l and da over C (slices in rank order), the softmax and dl = a (.)
  // (da - a . da), 8 lanes a pixel (clusters 4 j8 .. and 32 + 4 j8 ..)
  {
    float l[8] = {}, da[8] = {};
#pragma unroll
    for (int r = 0; r < kWideSlices; ++r) {
      const float* row = cluster.map_shared_rank(s_part, r) + px * LDJ;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float4 lv = ld4(row + 32 * hh + 4 * j8);
        const float4 dv = ld4(row + KP + 32 * hh + 4 * j8);
        l[4 * hh] += lv.x;
        l[4 * hh + 1] += lv.y;
        l[4 * hh + 2] += lv.z;
        l[4 * hh + 3] += lv.w;
        da[4 * hh] += dv.x;
        da[4 * hh + 1] += dv.y;
        da[4 * hh + 2] += dv.z;
        da[4 * hh + 3] += dv.w;
      }
    }
    const float neg_inf = -__int_as_float(0x7f800000);
    float mx = neg_inf;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = (i & 3) + 4 * j8 + 32 * (i >> 2);
      if (k >= K)
        l[i] = neg_inf;  // a padded cluster
      else if (a.assign_b != nullptr)
        l[i] += __ldg(a.assign_b + k);
      mx = fmaxf(mx, l[i]);
    }
    mx = group_reduce<8, true>(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      l[i] = expf(l[i] - mx);
      sum += l[i];
    }
    sum = group_reduce<8, false>(sum);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      l[i] /= sum;  // a
      dot = fmaf(l[i], da[i], dot);
    }
    dot = group_reduce<8, false>(dot);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = l[4 * hh + i];
        dl[i] = px < n ? av * (da[4 * hh + i] - dot) : 0.f;
        s_dlt[(32 * hh + 4 * j8 + i) * LDP + px] = dl[i];
      }
      *reinterpret_cast<float4*>(s_A + px * LDJ + 32 * hh + 4 * j8) =
          make_float4(dl[0], dl[1], dl[2], dl[3]);
      *reinterpret_cast<float4*>(s_A + px * LDJ + KP + 32 * hh + 4 * j8) =
          make_float4(l[4 * hh], l[4 * hh + 1], l[4 * hh + 2], l[4 * hh + 3]);
    }
  }
  __syncthreads();

  // 7. dx^ = [dl | a] [W | du^T]^T (thread pixels 2 pp, 2 pp + 1, channels
  // cg + 16 u) and the tile's x^T dl (channels 4 cw .., clusters kg + 16 i),
  // written as its dW partial with the column sums of dl (block 0)
  const int cg = lane & 15, pp = 2 * warp + (lane >> 4);
  float gx[2][4] = {};
#pragma unroll 4
  for (int j = 0; j < 2 * KP; j += 4) {
    float4 av[2], bv[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) av[i] = ld4(s_A + (2 * pp + i) * LDJ + j);
#pragma unroll
    for (int u = 0; u < 4; ++u) bv[u] = ld4(s_b1 + (cg + 16 * u) * LDJ + j);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) gx[i][u] = dot4(av[i], bv[u], gx[i][u]);
  }
  {
    const int kg = lane & 15, cw = 2 * warp + (lane >> 4);
    float w[4][4] = {};
#pragma unroll 2
    for (int p = 0; p < P; p += 4) {
      float4 xv[4], dv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) xv[u] = ld4(s_xt + (4 * cw + u) * LDP + p);
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = ld4(s_dlt + (kg + 16 * i) * LDP + p);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) w[u][i] = dot4(xv[u], dv[i], w[u][i]);
    }
    float* part = a.dw_part + t * part_floats(kWideCP, kWideKP);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[(c0 + 4 * cw + u) * kWideKP + kg + 16 * i] = w[u][i];
    if (sl == 0 && tid < KP) {
      float v = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p) v += s_dlt[tid * LDP + p];
      part[kWideCP * kWideKP + tid] = v;
    }
  }

  // 8. the pixels' norm backward: dx = (dx^ - (dx^ . x^) x^) / den, the
  // dot over C from the slices' (in rank order); at bf16 with dx^ rounded
  // to bf16 and x^ = x / den unrounded
  float xh[2][4];
  {
    float dot[2] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = 2 * pp + i;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cg + 16 * u;
        if constexpr (kBf16) {
          gx[i][u] = round_bf16(gx[i][u]);
          xh[i][u] = s_xr[c * LDP + p] / s_den[p];
        } else {
          xh[i][u] = s_xt[c * LDP + p];
        }
        dot[i] = fmaf(gx[i][u], xh[i][u], dot[i]);
      }
      dot[i] = group_reduce<16, false>(dot[i]);
    }
    if (cg == 0) {
      s_dotp[2 * pp] = dot[0];
      s_dotp[2 * pp + 1] = dot[1];
    }
  }
  cluster.sync();  // the dots written; every block's partials read
  {
    float dot[2] = {};
#pragma unroll
    for (int r = 0; r < kWideSlices; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        dot[i] += *cluster.map_shared_rank(s_dotp + 2 * pp + i, r);
    cluster_arrive();  // the block's last read of a peer
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = 2 * pp + i;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        s_dx[(cg + 16 * u) * LDP + p] =
            (gx[i][u] - dot[i] * xh[i][u]) / s_den[p];
    }
  }
  __syncthreads();

  // 9. dx stored as x was read
  {
    T* dxb = static_cast<T*>(a.dx) + (long long)b * a.sd_b;
    const bool nhwc = a.sd_c == 1;
#pragma unroll
    for (int i = 0; i < P * CS / kWideThreads; ++i) {
      const int e = tid + kWideThreads * i;
      const int p = nhwc ? e / CS : e % P, c = nhwc ? e % CS : e / P;
      if (p < n && c < cn)
        store_as(dxb + (long long)(s0 + p) * a.sd_s +
                     (long long)(c0 + c) * a.sd_c,
                 s_dx[c * LDP + p]);
    }
  }
  cluster_wait();  // no peer reads this block's shared memory any more
}

size_t wide_bwd_smem_bytes() {
  return sizeof(float) * (kWideCS * kWideLdj + 2 * kWideCS * kWideLdp +
                          2 * kWideP * kWideLdj + kMaxK * kWideLdp +
                          4 * kWideP + 5 * kMaxK);
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
// (128, 64), the first that holds them; (256, 64) the wide kernel's dW
// partials
struct BwdWidths {
  int cp, kp;
};

BwdWidths bwd_widths(int C, int K) {
  if (C <= 48) return {48, K <= 32 ? 32 : 64};
  if (C > 128) return {kWideCP, kWideKP};
  return {C <= 64 ? 64 : 128, 64};
}

int bwd_tiles(int S, int C) {
  const int tile = C > 128 ? kWideP : kBwdTile;
  return (S + tile - 1) / tile;
}

int bwd_blocks(int B, int S) {
  return (B * bwd_tiles(S, 0) + kCluster - 1) / kCluster * kCluster;
}

// The dW partials at widths C: one a cluster of tiles, or one a wide tile
int bwd_parts(int B, int S, int C) {
  return C > 128 ? B * bwd_tiles(S, C) : bwd_blocks(B, S) / kCluster;
}

// The scratch's parts, in floats from its start (16-byte aligned each but
// the last); above C = 128 the tiles derive du and dm themselves, and the
// prologue's parts are empty
struct BwdScratch {
  long long du, du_t, w_t, dm, dw_part, dcen_part, total;
};

BwdScratch bwd_scratch(int B, int S, int C, int K) {
  const BwdWidths w = bwd_widths(C, K);
  const bool wide = C > 128;
  const long long pc = wide ? 0 : (long long)w.cp * w.kp;
  BwdScratch s;
  s.du = 0;
  s.du_t = s.du + B * pc;
  s.w_t = s.du_t + B * pc;
  s.dm = s.w_t + pc;
  s.dw_part = s.dm + (wide ? 0 : (long long)B * w.kp);
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

// Raises the dynamic shared-memory limits of the kernels at 128 < C <= 256
// for x's type T, once per device.
template <typename T>
cudaError_t set_wide_limits() {
  return nvs::once_per_device([] {
    cudaError_t err = cudaFuncSetAttribute(
        netvlad_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)wide_smem_bytes());
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(netvlad_bwd_wide<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)wide_bwd_smem_bytes());
  });
}

// The clusters of netvlad_wide_kernel<T> the card holds at once: the
// occupancy calculator's (else the blocks an SM times the SMs), asked once
// a device.
template <typename T>
int wide_resident_clusters() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> resident[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = kMaxDevices;
  int r = dev < kMaxDevices ? resident[dev].load() : 0;
  if (r == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kWideCluster);
    cfg.blockDim = dim3(kWideThreads);
    cfg.dynamicSmemBytes = wide_smem_bytes();
    if (cudaOccupancyMaxActiveClusters(&r, netvlad_wide_kernel<T>, &cfg) !=
            cudaSuccess ||
        r < 1) {  // the blocks an SM, as if every SM took its share
      cudaGetLastError();
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, netvlad_wide_kernel<T>, kWideThreads, wide_smem_bytes());
      cudaGetLastError();
      r = sms * per_sm / kWideCluster > 1 ? sms * per_sm / kWideCluster : 1;
    }
    if (dev < kMaxDevices) resident[dev].store(r);
  }
  return r;
}

// Clusters the forward above C = 128 gives each of B images of S pixels:
// the resident clusters shared out, each walking as few pairs of tiles as
// keep all B images' clusters resident at once (no second wave). The
// grid, and with it the sums' order, is fixed for a card and a shape.
template <typename T>
int wide_clusters(int S, int B) {
  const int r = wide_resident_clusters<T>();
  const int pairs = wide_pairs(S);
  int per = (int)(((long long)pairs * B + r - 1) / r);
  while (per < pairs && (long long)((pairs + per - 1) / per) * B > r) ++per;
  return (pairs + per - 1) / per;
}

// The forward at 128 < C <= 256: one launch.
template <typename T>
cudaError_t launch_wide(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = set_wide_limits<T>();
  if (err != cudaSuccess) return err;
  netvlad_wide_kernel<T>
      <<<dim3(kWideCluster * wide_clusters<T>(a.S, B), B), kWideThreads,
         wide_smem_bytes(), stream>>>(a);
  return cudaGetLastError();
}

// The backward at 128 < C <= 256: the tiles, then the reduction by
// programmatic dependent launch.
template <typename T>
cudaError_t launch_bwd_wide(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = set_wide_limits<T>();
  if (err != cudaSuccess) return err;
  netvlad_bwd_wide<T><<<kWideSlices * a.B * a.tiles, kWideThreads,
                        wide_bwd_smem_bytes(), stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_pdl(netvlad_bwd_reduce<kWideCP, kWideKP>,
                    (2 * a.K * a.C + a.K + 255) / 256, 256, 0, stream, a,
                    a.B * a.tiles);
}

// The launch of a kernel at 128 < C <= 256 (the forward, or the backward's
// tiles) for x's type T at batch B and S pixels an image, as shape = {blocks,
// blocks a cluster, threads a block, dynamic shared bytes a block, blocks
// an SM (the occupancy calculator's; -1 if it refuses), the card's SMs,
// registers a thread, local bytes a thread, the forward's resident
// clusters (0 for the backward)}.
template <typename T>
int wide_shape(bool backward, int B, int S, int* shape) {
  cudaError_t err = set_wide_limits<T>();
  if (err != cudaSuccess) return (int)err;
  const void* fn = backward
                       ? reinterpret_cast<const void*>(netvlad_bwd_wide<T>)
                       : reinterpret_cast<const void*>(netvlad_wide_kernel<T>);
  const size_t smem = backward ? wide_bwd_smem_bytes() : wide_smem_bytes();
  shape[0] = backward ? kWideSlices * B * ((S + kWideP - 1) / kWideP)
                      : kWideCluster * wide_clusters<T>(S, B) * B;
  shape[1] = backward ? kWideSlices : kWideCluster;
  shape[2] = kWideThreads;
  shape[3] = (int)smem;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kWideThreads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();
    per_sm = -1;
  }
  shape[4] = per_sm;
  int dev = 0;
  cudaFuncAttributes attr;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(shape + 5, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess)
    return (int)err;
  shape[6] = attr.numRegs;
  shape[7] = (int)attr.localSizeBytes;
  shape[8] = backward ? 0 : wide_resident_clusters<T>();
  return 0;
}

}  // namespace

// Floats of the partial scratch one image of S pixels needs at widths C, K:
// one K*C + K partial a cluster (above C = 128, at most one a pair of
// tiles).
extern "C" int nvs_netvlad_partial_size(int S, int C, int K) {
  const int clusters = C > kNarrowMaxC ? wide_pairs(S)
                                       : blocks_per_image(S) / kCluster;
  return clusters * (K * C + K);
}

// The launch a call at 128 < C <= 256 makes (``backward``: its tiles) for a
// float32 or (``bf16``) bfloat16 x of batch B and S pixels an image: see
// wide_shape. Nothing is launched.
extern "C" int nvs_netvlad_wide_shape(int backward, int bf16, int B, int S,
                                      int* shape) {
  return bf16 ? wide_shape<__nv_bfloat16>(backward, B, S, shape)
              : wide_shape<float>(backward, B, S, shape);
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
