// LightGlue transformer stack: L layers on a batch of descriptor-set pairs.
//
// Replaces the TPU kernel nanovs_slam_tpu/ops/pallas/lightglue_kernel.py
// (fused_transformer). Each layer, for images 0 (M rows) and 1 (N rows) of
// each pair, with H = 4 heads of DH = D/4 channels:
//   self:  q, k, v <- x Wqkv + b; rotary on q, k; ctx <- softmax(q k^T /
//          sqrt(DH)) v over the image's own valid keys;
//          x <- x + fc2(GELU(LN(fc1([x, ctx Wo + bo]))))
//   cross: qk, v <- x Wqk + b, x Wv + b; image 0 attends to image 1's keys
//          (softmax over rows of qk0 qk1^T), image 1 to image 0's (softmax
//          over its columns, i.e. the rows of qk1 qk0^T); the same FFN.
// Keys outside the mask get no weight; a query row with no valid key gets a
// zero context, as the module's masked_softmax gives it (the Pallas kernel's
// additive -1e9 mask would average over the padded keys instead).
//
// Design. The TPU kernel held every weight and activation in VMEM and ran
// the whole stack in one grid step. On Hopper one block per pair would leave
// 131 of 132 SMs idle, so each layer is six launches over many blocks:
//   proj_kernel: one warp per row, one lane per pair of outputs; the
//     weights (<= 3 D^2) are staged in shared memory. The rotary is applied
//     to the interleaved (even, odd) pairs in registers, in the module's
//     basis (no half-basis permutation). q, k, v go out as (B, H, n, DH).
//   attn_kernel: flash-style online softmax. A block takes 32 query rows of
//     one head of one problem (self: image 0 and image 1; cross: the two
//     directions), four threads per row each taking every fourth key of a
//     64-key tile staged in shared memory; the four partial softmaxes are
//     merged with warp shuffles. exp2 with log2(e) folded into the scale.
//   ffn_kernel: one warp per row: out projection, fc1 over [x, msg],
//     LayerNorm (eps 1e-5), exact GELU (erff), fc2 and the residual. Its
//     weights (7 D^2 + 8 D floats) are staged in shared memory.
// One host call (nvs_lightglue_layers) enqueues every launch of the layers
// it is given on the caller's stream.
//
// Bound on an H100: operations. Per layer 38 (M+N) D^2 + 4 (M^2+N^2) D +
// 6 M N D flops: at M = N = 512, D = 32, L = 4 that is 0.63 GFLOP, 9.4 us at
// 67 TFLOP/s (float32, CUDA cores); at 1024, 2.2 GFLOP, 33 us. The bytes
// (weights 80 KB a layer, activations < 1 MB) move in well under that.
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kHeads = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kProjRows = 16;  // rows per projection block
constexpr int kFfnRows = 32;   // rows per FFN block
constexpr int kSplit = 4;      // threads per query row
constexpr int kQRows = 32;     // query rows per attention block
constexpr int kAttnThreads = kQRows * kSplit;
constexpr int kKeyTile = 64;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T pick(int img, T a, T b) {
  return img ? b : a;
}

// ------------------------------------------------------------- projection

struct ProjArgs {
  const float* x0;  // (B, M, D) rows
  const float* x1;  // (B, N, D)
  const float* cs0;  // (B, M, DH/2) rotary tables; unused without rotary
  const float* sn0;
  const float* cs1;
  const float* sn1;
  float* out0;  // image 0: q | k | v, each (B, H, M, DH)
  float* out1;  // image 1: q | k | v, each (B, H, N, DH)
  const float* w;  // (D, T*D) in-major, then the bias (T*D)
  int B, M, N;
};

// T = 3: self-attention q, k, v with the rotary on q and k.
// T = 2: cross-attention qk (into the q slot) and v (into the v slot).
template <int D, int T>
__global__ void __launch_bounds__(kThreads) proj_kernel(ProjArgs a) {
  constexpr int DH = D / kHeads;
  constexpr int kOut = T * D;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // D * kOut, then kOut
  float* s_b = s_w + D * kOut;
  float* xs = s_b + kOut + (threadIdx.x >> 5) * D;  // this warp's row
  const int tid = threadIdx.x, lane = tid & 31;

  for (int e = tid; e < D * kOut + kOut; e += kThreads) s_w[e] = a.w[e];
  __syncthreads();
  const int rows0 = a.B * a.M, rows = rows0 + a.B * a.N;
  const int r_end = min(rows, (blockIdx.x + 1) * kProjRows);
  for (int r = blockIdx.x * kProjRows + (tid >> 5); r < r_end; r += kWarps) {
    const int img = r >= rows0;
    const int rr = img ? r - rows0 : r;  // row within its image's (B, n)
    const int n = pick(img, a.M, a.N);
    const int b = rr / n, i = rr % n;
    const float* x = pick(img, a.x0, a.x1) + (long long)rr * D;
    for (int c = lane; c < D; c += 32) xs[c] = x[c];
    __syncwarp();
    const long long slot = (long long)a.B * n * D;  // one of q, k, v
    for (int p = lane; p < kOut / 2; p += 32) {
      const int o = 2 * p;
      float2 acc = *reinterpret_cast<const float2*>(s_b + o);
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float xc = xs[c];
        const float2 w = *reinterpret_cast<const float2*>(s_w + c * kOut + o);
        acc.x = fmaf(xc, w.x, acc.x);
        acc.y = fmaf(xc, w.y, acc.y);
      }
      const int t = o / D, h = (o % D) / DH, j = o % DH;
      if (T == 3 && t < 2) {
        const long long ti = (long long)rr * (DH / 2) + j / 2;
        const float c = pick(img, a.cs0, a.cs1)[ti];
        const float s = pick(img, a.sn0, a.sn1)[ti];
        acc = make_float2(acc.x * c - acc.y * s, acc.y * c + acc.x * s);
      }
      float* out = pick(img, a.out0, a.out1) + (T == 3 ? t : 2 * t) * slot +
                   (((long long)b * kHeads + h) * n + i) * DH + j;
      *reinterpret_cast<float2*>(out) = acc;
    }
    __syncwarp();
  }
}

// -------------------------------------------------------------- attention

struct AttnProblem {
  const float* q;  // (B, H, nq, DH)
  const float* k;  // (B, H, nk, DH)
  const float* v;  // (B, H, nk, DH)
  const unsigned char* kmask;  // (B, nk) validity, or null: all valid
  float* ctx;  // (B, nq, H*DH), heads side by side
  int nq, nk;
};

struct AttnArgs {
  AttnProblem p0, p1;
  float scale_log2;  // log2(e) / sqrt(DH)
};

template <int DH>
__global__ void __launch_bounds__(kAttnThreads) attn_kernel(AttnArgs a) {
  constexpr int kStride = DH + 4;  // padded key row: no bank conflicts
  constexpr int kVec = DH / 4;
  constexpr int kPer = kKeyTile / kSplit;
  __shared__ __align__(16) float s_k[kKeyTile * kStride];
  __shared__ __align__(16) float s_v[kKeyTile * kStride];
  __shared__ bool s_valid[kKeyTile];

  const AttnProblem P = (blockIdx.z & 1) ? a.p1 : a.p0;
  const int b = blockIdx.z >> 1, h = blockIdx.y;
  const int row0 = blockIdx.x * kQRows;
  if (row0 >= P.nq) return;  // the whole block: this problem is shorter
  const int tid = threadIdx.x, split = tid % kSplit;
  const int i = row0 + tid / kSplit;
  const bool active = i < P.nq;
  const long long bh = (long long)b * kHeads + h;

  float q[DH], acc[DH];
  const float* qr = P.q + (bh * P.nq + (active ? i : row0)) * DH;
#pragma unroll
  for (int j = 0; j < DH; ++j) {
    q[j] = qr[j] * a.scale_log2;
    acc[j] = 0.f;
  }
  const float neg_inf = -__int_as_float(0x7f800000);
  float m = neg_inf, l = 0.f;
  const float* kb = P.k + bh * P.nk * DH;
  const float* vb = P.v + bh * P.nk * DH;
  const unsigned char* mb = P.kmask ? P.kmask + (long long)b * P.nk : nullptr;

  for (int k0 = 0; k0 < P.nk; k0 += kKeyTile) {
    __syncthreads();
    for (int e = tid; e < kKeyTile * kVec; e += kAttnThreads) {
      const int kk = e / kVec, c4 = e % kVec, key = k0 + kk;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < P.nk) {
        kv = reinterpret_cast<const float4*>(kb + (long long)key * DH)[c4];
        vv = reinterpret_cast<const float4*>(vb + (long long)key * DH)[c4];
      }
      *reinterpret_cast<float4*>(s_k + kk * kStride + 4 * c4) = kv;
      *reinterpret_cast<float4*>(s_v + kk * kStride + 4 * c4) = vv;
    }
    for (int kk = tid; kk < kKeyTile; kk += kAttnThreads) {
      const int key = k0 + kk;
      s_valid[kk] = key < P.nk && (mb == nullptr || mb[key]);
    }
    __syncthreads();

    float s[kPer];
    float mt = neg_inf;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int kk = split + kSplit * u;
      const float* kr = s_k + kk * kStride;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < DH; j += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + j);
        dot = fmaf(q[j], k4.x, dot);
        dot = fmaf(q[j + 1], k4.y, dot);
        dot = fmaf(q[j + 2], k4.z, dot);
        dot = fmaf(q[j + 3], k4.w, dot);
      }
      s[u] = s_valid[kk] ? dot : neg_inf;
      mt = fmaxf(mt, s[u]);
    }
    if (mt == neg_inf) continue;  // no valid key in this thread's share
    if (mt > m) {
      const float alpha = exp2f(m - mt);  // 0 while m is -inf
      l *= alpha;
#pragma unroll
      for (int j = 0; j < DH; ++j) acc[j] *= alpha;
      m = mt;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const float p = exp2f(s[u] - m);  // 0 for an invalid key
      l += p;
      const float* vr = s_v + (split + kSplit * u) * kStride;
#pragma unroll
      for (int j = 0; j < DH; j += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr + j);
        acc[j] = fmaf(p, v4.x, acc[j]);
        acc[j + 1] = fmaf(p, v4.y, acc[j + 1]);
        acc[j + 2] = fmaf(p, v4.z, acc[j + 2]);
        acc[j + 3] = fmaf(p, v4.w, acc[j + 3]);
      }
    }
  }

  // merge the kSplit partial softmaxes of a row (adjacent lanes)
  float m_all = m;
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1)
    m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, o));
  const float f = m == neg_inf ? 0.f : exp2f(m - m_all);
  l *= f;
#pragma unroll
  for (int j = 0; j < DH; ++j) acc[j] *= f;
#pragma unroll
  for (int o = 1; o < kSplit; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int j = 0; j < DH; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (active && split == 0) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no valid key: zero
    float* out = P.ctx + ((long long)b * P.nq + i) * (kHeads * DH) + h * DH;
#pragma unroll
    for (int j = 0; j < DH; j += 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(acc[j] * inv, acc[j + 1] * inv, acc[j + 2] * inv,
                      acc[j + 3] * inv);
  }
}

// ------------------------------------------------- out projection and FFN

struct FfnArgs {
  const float* x0;  // (B, M, D) residual input
  const float* x1;
  const float* ctx0;  // (B, M, D) attention context
  const float* ctx1;
  float* y0;  // (B, M, D) output; may be x0 (in place, row by row)
  float* y1;
  const float* w;  // wo (D,D), bo, fc1 (2D,2D), b1, ln_g, ln_b, fc2 (2D,D), b2
  int rows0, rows1;  // B*M, B*N
};

template <int D>
__host__ __device__ constexpr int ffn_weights() {
  return 7 * D * D + 8 * D;
}

template <int D>
__global__ void __launch_bounds__(kThreads) ffn_kernel(FfnArgs a) {
  constexpr int D2 = 2 * D;
  constexpr int kPer = D2 / 32;
  extern __shared__ float4 smem4[];
  float* s_wo = reinterpret_cast<float*>(smem4);
  float* s_bo = s_wo + D * D;
  float* s_fc1 = s_bo + D;
  float* s_b1 = s_fc1 + D2 * D2;
  float* s_g = s_b1 + D2;
  float* s_beta = s_g + D2;
  float* s_fc2 = s_beta + D2;
  float* s_b2 = s_fc2 + D2 * D;
  const int tid = threadIdx.x, lane = tid & 31;
  float* xm = s_wo + ffn_weights<D>() + (tid >> 5) * (5 * D);  // [x | msg]
  float* cx = xm + D2;  // ctx
  float* hb = cx + D;   // GELU(LN(fc1)), 2D

  for (int e = tid; e < ffn_weights<D>(); e += kThreads) s_wo[e] = a.w[e];
  __syncthreads();
  const int rows = a.rows0 + a.rows1;
  const int r_end = min(rows, (blockIdx.x + 1) * kFfnRows);
  for (int r = blockIdx.x * kFfnRows + (tid >> 5); r < r_end; r += kWarps) {
    const int img = r >= a.rows0;
    const long long off = (long long)(img ? r - a.rows0 : r) * D;
    const float* x = pick(img, a.x0, a.x1) + off;
    const float* ctx = pick(img, a.ctx0, a.ctx1) + off;
    for (int c = lane; c < D; c += 32) {
      xm[c] = x[c];
      cx[c] = ctx[c];
    }
    __syncwarp();
    for (int o = lane; o < D; o += 32) {
      float acc = s_bo[o];
#pragma unroll 8
      for (int c = 0; c < D; ++c) acc = fmaf(cx[c], s_wo[c * D + o], acc);
      xm[D + o] = acc;
    }
    __syncwarp();
    float hv[kPer];
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int o = lane + 32 * u;
      float acc = s_b1[o];
#pragma unroll 8
      for (int c = 0; c < D2; ++c) acc = fmaf(xm[c], s_fc1[c * D2 + o], acc);
      hv[u] = acc;
      sum += acc;
    }
    const float mu = nvs::warp_sum(sum) / D2;
    float sq = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) sq += (hv[u] - mu) * (hv[u] - mu);
    const float rstd = rsqrtf(nvs::warp_sum(sq) / D2 + 1e-5f);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int o = lane + 32 * u;
      const float t = (hv[u] - mu) * rstd * s_g[o] + s_beta[o];
      hb[o] = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
    }
    __syncwarp();
    float* y = pick(img, a.y0, a.y1) + off;
    for (int o = lane; o < D; o += 32) {
      float acc = s_b2[o];
#pragma unroll 8
      for (int c = 0; c < D2; ++c) acc = fmaf(hb[c], s_fc2[c * D + o], acc);
      y[o] = xm[o] + acc;
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------- host

template <int D, int T>
constexpr size_t proj_smem() {
  return sizeof(float) * (D * T * D + T * D + kWarps * D);
}

template <int D>
constexpr size_t ffn_smem() {
  return sizeof(float) * (ffn_weights<D>() + kWarps * 5 * D);
}

// Raises the dynamic shared-memory limits of the D-wide kernels once per
// device: the attribute holds for every later launch there. Until a call
// succeeds, each call tries again and returns its error.
template <int D>
cudaError_t set_smem_limits() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev].load()))
    return err;
  err = cudaFuncSetAttribute(proj_kernel<D, 3>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)proj_smem<D, 3>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(proj_kernel<D, 2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)proj_smem<D, 2>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ffn_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ffn_smem<D>());
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

template <int D>
cudaError_t run_layers(int l_begin, int l_end, const float* x0,
                       const float* x1, float* o0, float* o1,
                       const float* cs0, const float* sn0, const float* cs1,
                       const float* sn1, const unsigned char* mask0,
                       const unsigned char* mask1, const float* packed,
                       float* scratch, long long layer_stride, int B, int M,
                       int N, cudaStream_t stream) {
  constexpr int DH = D / kHeads;
  cudaError_t err = set_smem_limits<D>();
  if (err != cudaSuccess) return err;
  // scratch: image 0 q | k | v | ctx, each (B, M, D) floats; then image 1
  const long long s0 = (long long)B * M * D, s1 = (long long)B * N * D;
  float* qkv0 = scratch;
  float* ctx0 = scratch + 3 * s0;
  float* qkv1 = scratch + 4 * s0;
  float* ctx1 = qkv1 + 3 * s1;
  const int rows = B * (M + N);
  const dim3 proj_grid((rows + kProjRows - 1) / kProjRows);
  const dim3 ffn_grid((rows + kFfnRows - 1) / kFfnRows);
  const dim3 attn_grid(((M > N ? M : N) + kQRows - 1) / kQRows, kHeads,
                       2 * B);
  const float scale_log2 = kLog2e / sqrtf((float)DH);

  const float* cur0 = x0;
  const float* cur1 = x1;
  for (int l = l_begin; l < l_end; ++l) {
    const float* w_self = packed + l * layer_stride;
    const float* w_cross = w_self + 10 * D * D + 11 * D;
    // self-attention: both images in each launch; writes o0/o1
    proj_kernel<D, 3><<<proj_grid, kThreads, proj_smem<D, 3>(), stream>>>(
        ProjArgs{cur0, cur1, cs0, sn0, cs1, sn1, qkv0, qkv1, w_self, B, M,
                 N});
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attn_kernel<DH><<<attn_grid, kAttnThreads, 0, stream>>>(AttnArgs{
        {qkv0, qkv0 + s0, qkv0 + 2 * s0, mask0, ctx0, M, M},
        {qkv1, qkv1 + s1, qkv1 + 2 * s1, mask1, ctx1, N, N}, scale_log2});
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ffn_kernel<D><<<ffn_grid, kThreads, ffn_smem<D>(), stream>>>(
        FfnArgs{cur0, cur1, ctx0, ctx1, o0, o1, w_self + 3 * D * D + 3 * D,
                B * M, B * N});
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    cur0 = o0;
    cur1 = o1;
    // cross-attention: qk into the q slot, v into the v slot; in place
    proj_kernel<D, 2><<<proj_grid, kThreads, proj_smem<D, 2>(), stream>>>(
        ProjArgs{o0, o1, nullptr, nullptr, nullptr, nullptr, qkv0, qkv1,
                 w_cross, B, M, N});
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attn_kernel<DH><<<attn_grid, kAttnThreads, 0, stream>>>(AttnArgs{
        {qkv0, qkv1, qkv1 + 2 * s1, mask1, ctx0, M, N},
        {qkv1, qkv0, qkv0 + 2 * s0, mask0, ctx1, N, M}, scale_log2});
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ffn_kernel<D><<<ffn_grid, kThreads, ffn_smem<D>(), stream>>>(
        FfnArgs{o0, o1, ctx0, ctx1, o0, o1, w_cross + 2 * D * D + 2 * D,
                B * M, B * N});
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Layers [l_begin, l_end) of the stack. x0 (B,M,D), x1 (B,N,D) in; o0, o1
// out (the same shapes, distinct from the inputs); cs/sn (B,n,DH/2); masks
// (B,n) bytes or null; packed (L, layer_stride) floats; scratch
// 4*B*(M+N)*D floats. All contiguous. D in {32, 64}, 4 heads. Returns the
// first cudaError_t of the launches.
extern "C" int nvs_lightglue_layers(
    int l_begin, int l_end, const float* x0, const float* x1, float* o0,
    float* o1, const float* cs0, const float* sn0, const float* cs1,
    const float* sn1, const unsigned char* mask0,
    const unsigned char* mask1, const float* packed, float* scratch,
    long long layer_stride, int B, int M, int N, int D,
    cudaStream_t stream) {
  if (B < 1 || 2 * B > 65535 || M < 1 || N < 1 || l_begin < 0 ||
      l_end < l_begin)
    return (int)cudaErrorInvalidValue;
  if (l_begin == l_end) {
    cudaError_t err = cudaMemcpyAsync(o0, x0, sizeof(float) * B * M * D,
                                      cudaMemcpyDeviceToDevice, stream);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(o1, x1, sizeof(float) * B * N * D,
                            cudaMemcpyDeviceToDevice, stream);
    return (int)err;
  }
  switch (D) {
    case 32:
      return (int)run_layers<32>(l_begin, l_end, x0, x1, o0, o1, cs0, sn0,
                                 cs1, sn1, mask0, mask1, packed, scratch,
                                 layer_stride, B, M, N, stream);
    case 64:
      return (int)run_layers<64>(l_begin, l_end, x0, x1, o0, o1, cs0, sn0,
                                 cs1, sn1, mask0, mask1, packed, scratch,
                                 layer_stride, B, M, N, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
