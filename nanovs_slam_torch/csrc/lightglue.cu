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
// 131 of 132 SMs idle, so the stack is a chain of launches over many blocks,
// 4 a layer plus one:
//   row_kernel: 8 rows a block, 2 rows a warp sharing each weight read;
//     the self FFN is fused with the cross projection that follows it, and
//     the cross FFN with the next layer's self projection (the row a warp
//     finishes is the row it projects). The FFN is the out projection, fc1
//     over [x, msg], LayerNorm (eps 1e-5), exact GELU (erff), fc2 and the
//     residual; the projection applies the rotary to the interleaved (even,
//     odd) pairs in neighbouring lanes, in the module's basis (no
//     half-basis permutation). q, k, v go out as (B, H, n, DH).
//   attn_kernel: flash-style online softmax on the tensor cores. A block
//     takes 32 query rows of one head of one problem (self: image 0 and
//     image 1; cross: the two directions), 16 rows and half the keys a
//     warp; its four warps share each 128-key tile of K and V,
//     double-buffered with cp.async.
//     q k^T and p v are m16n8k8 TF32 products (DH = 8 is one k-step; DH =
//     16 two) in 3xTF32, which keeps float32 accuracy. exp2 with log2(e)
//     folded into the scale.
// Every launch of a call but the first is a programmatic dependent launch
// (Hopper): the next kernel starts while this one runs, stages its weights,
// and waits (griddepcontrol.wait) before it reads what this one writes. The
// first waits for the stream as usual, because what ran before the call may
// have written the packed weights it stages. One host call
// (nvs_lightglue_layers) enqueues every launch of the layers it is given on
// the caller's stream.
//
// Bound on an H100: operations. Per layer 38 (M+N) D^2 + 4 (M^2+N^2) D +
// 6 M N D flops: at M = N = 512, D = 32, L = 4 that is 0.63 GFLOP, 9.4 us at
// 67 TFLOP/s (float32, CUDA cores); at 1024, 2.2 GFLOP, 33 us. The bytes
// (weights 80 KB a layer, activations < 1 MB) move in well under that.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kHeads = 4;
constexpr int kRowsPerWarp = 2;  // rows a warp of the row kernel carries
constexpr int kRowThreads = 128;
constexpr int kRowRows = kRowThreads / 32 * kRowsPerWarp;  // rows a block
constexpr int kQGroups = 2;  // attention: groups of 16 query rows a block
constexpr int kKeySplit = 2;  // warps that share a group, each 64 keys of 128
constexpr int kAttnThreads = kQGroups * kKeySplit * 32;
constexpr int kQRows = kQGroups * 16;  // query rows a block
constexpr int kKeyTile = 64 * kKeySplit;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T pick(int img, T a, T b) {
  return img ? b : a;
}

// ------------------------------------------------- PDL (Hopper) helpers

// Programmatic dependent launch: a kernel waits for the previous one on the
// stream before it touches what that one wrote or reads, and then lets the
// next one start, whose blocks stage their weights while this one runs.
// Letting it start before the wait would cascade: every later kernel's
// blocks would take SM resources while waiting.
__device__ __forceinline__ void allow_next_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_previous_launch() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ------------------------------------------------- FFN and/or projection

struct RowArgs {
  const float* x0;    // (B, M, D) residual input, or the rows to project
  const float* x1;    // (B, N, D)
  const float* ctx0;  // (B, M, D) attention context (with the FFN)
  const float* ctx1;
  float* y0;  // (B, M, D) FFN output; may be x0 (in place, row by row)
  float* y1;
  const float* w_ffn;   // wo (D,D), bo, fc1 (2D,2D), b1, ln_g, ln_b,
                        // fc2 (2D,D), b2; unused without the FFN
  const float* w_proj;  // (D, T*D) in-major, then the bias (T*D)
  const float* cs0;     // (B, M, DH/2) rotary tables (T = 3 only)
  const float* sn0;
  const float* cs1;
  const float* sn1;
  float* qkv0;  // image 0: q | k | v slots, each (B, H, M, DH)
  float* qkv1;  // image 1: the same with N
  int B, M, N;
};

template <int D>
__host__ __device__ constexpr int ffn_weights() {
  return 7 * D * D + 8 * D;
}

template <int D, int T>
__host__ __device__ constexpr int proj_weights() {
  return T * D * D + T * D;
}

// One row kernel for the three places a layer needs one:
//   kFfn, T = 2: self block's out projection + FFN, then the cross q/k, v;
//   kFfn, T = 3: cross block's FFN, then the next layer's self q, k, v;
//   kFfn, T = 0: the last layer's cross FFN;   !kFfn, T = 3: the first
//   layer's self projection of the input rows.
// A block takes kRowRows rows of both images (image 0's B*M rows, then
// image 1's), a warp kRowsPerWarp of them: every weight a lane reads from
// shared memory feeds that many rows (register blocking), and the chain of
// dependent FMAs is one row deep. The row a warp finishes stays in shared
// memory for the projection that follows. Weights (at most 10 D^2 + 11 D
// floats: 167 KB at D = 64, within the 227 KB a block can have) are staged
// before the wait for the previous launch.
template <int D, bool kFfn, int T>
__global__ void __launch_bounds__(kRowThreads) row_kernel(RowArgs a) {
  constexpr int D2 = 2 * D;
  constexpr int DH = D / kHeads;
  constexpr int R = kRowsPerWarp;
  constexpr int kWf = kFfn ? ffn_weights<D>() : 0;
  constexpr int kWp = proj_weights<D, T>();
  constexpr int kRowBuf = 5 * D;  // [x | msg] (2D), ctx then y (D), h (2D)
  extern __shared__ float4 smem4[];
  float* s_ffn = reinterpret_cast<float*>(smem4);
  float* s_proj = s_ffn + kWf;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* buf = s_proj + kWp + warp * R * kRowBuf;

  {
    const float4* src = reinterpret_cast<const float4*>(a.w_ffn);
    float4* dst = reinterpret_cast<float4*>(s_ffn);
    for (int e = tid; e < kWf / 4; e += kRowThreads) dst[e] = src[e];
    src = reinterpret_cast<const float4*>(a.w_proj);
    dst = reinterpret_cast<float4*>(s_proj);
    for (int e = tid; e < kWp / 4; e += kRowThreads) dst[e] = src[e];
  }
  wait_previous_launch();
  allow_next_launch();
  __syncthreads();

  const int rows0 = a.B * a.M, rows = rows0 + a.B * a.N;
  const int r0 = blockIdx.x * kRowRows + warp * R;
  int img[R];
  long long off[R];  // the row's element offset in its image's (B, n, D)
  bool valid[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r;
    valid[r] = row < rows;
    img[r] = row >= rows0;
    off[r] = valid[r] ? (long long)(img[r] ? row - rows0 : row) * D : 0;
  }
  float* xm[R];
  float* cy[R];
  float* hb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    xm[r] = buf + r * kRowBuf;
    cy[r] = xm[r] + D2;
    hb[r] = cy[r] + D;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* x = pick(img[r], a.x0, a.x1) + off[r];
    const float* ctx = pick(img[r], a.ctx0, a.ctx1) + off[r];
    for (int c = lane; c < D; c += 32) {
      xm[r][c] = valid[r] ? x[c] : 0.f;
      if (kFfn) cy[r][c] = valid[r] ? ctx[c] : 0.f;
    }
  }
  __syncwarp();

  const float* y_rows[R];  // the rows the projection reads
  if (kFfn) {
    const float* s_wo = s_ffn;
    const float* s_bo = s_wo + D * D;
    const float* s_fc1 = s_bo + D;
    const float* s_b1 = s_fc1 + D2 * D2;
    const float* s_g = s_b1 + D2;
    const float* s_beta = s_g + D2;
    const float* s_fc2 = s_beta + D2;
    const float* s_b2 = s_fc2 + D2 * D;
    // msg = ctx wo + bo, beside x
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      const int o = lane + 32 * u;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = s_bo[o];
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float w = s_wo[c * D + o];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(cy[r][c], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) xm[r][D + o] = acc[r];
    }
    __syncwarp();
    // h = GELU(LN([x, msg] fc1 + b1))
    constexpr int kPer = D2 / 32;
    float hv[R][kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) hv[r][u] = s_b1[lane + 32 * u];
#pragma unroll 4
    for (int c = 0; c < D2; ++c) {
      float w[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) w[u] = s_fc1[c * D2 + lane + 32 * u];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xc = xm[r][c];
#pragma unroll
        for (int u = 0; u < kPer; ++u) hv[r][u] = fmaf(xc, w[u], hv[r][u]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u) sum += hv[r][u];
      const float mu = nvs::warp_sum(sum) / D2;
      float sq = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u) sq += (hv[r][u] - mu) * (hv[r][u] - mu);
      const float rstd = rsqrtf(nvs::warp_sum(sq) / D2 + 1e-5f);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int o = lane + 32 * u;
        const float t = (hv[r][u] - mu) * rstd * s_g[o] + s_beta[o];
        hb[r][o] = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
      }
    }
    __syncwarp();
    // y = x + h fc2 + b2: out to the rows, and kept (over ctx) to project
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      const int o = lane + 32 * u;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = s_b2[o];
#pragma unroll 8
      for (int c = 0; c < D2; ++c) {
        const float w = s_fc2[c * D + o];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(hb[r][c], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float y = xm[r][o] + acc[r];
        cy[r][o] = y;
        if (valid[r]) pick(img[r], a.y0, a.y1)[off[r] + o] = y;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) y_rows[r] = cy[r];
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) y_rows[r] = xm[r];
  }
  if constexpr (T > 0) {
    // projection: lane owns outputs lane + 32 u of (type, head, channel);
    // the rotary pairs (even, odd) sit in neighbouring lanes
    const float* s_wp = s_proj;
    const float* s_bp = s_proj + T * D * D;
    constexpr int kOut = T * D / 32;
    float acc[R][kOut];
#pragma unroll
    for (int u = 0; u < kOut; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][u] = s_bp[lane + 32 * u];
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float w[kOut];
#pragma unroll
      for (int u = 0; u < kOut; ++u) w[u] = s_wp[c * T * D + lane + 32 * u];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float yc = y_rows[r][c];
#pragma unroll
        for (int u = 0; u < kOut; ++u) acc[r][u] = fmaf(yc, w[u], acc[r][u]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = pick(img[r], a.M, a.N);
      const long long rr = off[r] / D;  // row within its image's (B, n)
      const long long b = rr / n, i = rr % n;
      const long long slot = (long long)a.B * n * D;  // one of q, k, v
      float* out = pick(img[r], a.qkv0, a.qkv1);
#pragma unroll
      for (int u = 0; u < kOut; ++u) {
        const int o = lane + 32 * u;
        const int t = o / D, h = (o % D) / DH, j = o % DH;
        float v = acc[r][u];
        if (T == 3 && t < 2) {  // rotary on q and k, interleaved pairs
          const float other = __shfl_xor_sync(0xffffffffu, v, 1);
          const long long ti = rr * (DH / 2) + j / 2;
          const float c = valid[r] ? pick(img[r], a.cs0, a.cs1)[ti] : 0.f;
          const float s = valid[r] ? pick(img[r], a.sn0, a.sn1)[ti] : 0.f;
          v = (j & 1) ? v * c + other * s : v * c - other * s;
        }
        if (valid[r])
          out[(T == 3 ? t : 2 * t) * slot +
              ((b * kHeads + h) * n + i) * DH + j] = v;
      }
    }
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

// 3xTF32 on the tensor cores: x = hi + lo with hi = tf32(x) and lo =
// tf32(x - hi); a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi keeps float32
// accuracy (plain TF32 keeps about three digits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// d += a b, one m16n8k8 TF32 product: a 16x8 (row), b 8x8 (col).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// 16 bytes global -> shared, zero-filled when !in (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// A block takes 32 query rows in 2 groups of 16 and walks the keys in
// 128-key tiles of K and V, loaded with cp.async into one of two buffers
// while the other is in use. Two warps share a group, each with its own
// online softmax over its 64 keys of every tile; they merge through shared
// memory at the end, which halves the dependent chain a warp runs. Per 8
// keys: q k^T is one m16n8k8 product per
// 8 channels (DH / 8 k-steps), p v one per 8 output channels, each as
// 3xTF32. The scores' accumulator layout (row g = lane / 4, keys 2t, 2t+1
// with t = lane % 4) is reused as p's operand layout by taking key 2t as
// k-index t and key 2t+1 as t + 4; v's operand follows the same order.
template <int DH>
__global__ void __launch_bounds__(kAttnThreads) attn_kernel(AttnArgs a) {
  constexpr int kStride = DH + 4;  // padded key row: no bank conflicts
  constexpr int kSteps = DH / 8;   // k-steps of q k^T, n-tiles of p v
  constexpr int kChunks = 64 / 8;  // 8-key chunks of a warp's share
  __shared__ __align__(16) float s_k[2][kKeyTile * kStride];
  __shared__ __align__(16) float s_v[2][kKeyTile * kStride];
  __shared__ bool s_valid[2][kKeyTile];

  wait_previous_launch();
  allow_next_launch();
  const AttnProblem P = (blockIdx.z & 1) ? a.p1 : a.p0;
  const int b = blockIdx.z >> 1, h = blockIdx.y;
  const int row0 = blockIdx.x * kQRows;
  if (row0 >= P.nq) return;  // the whole block: this problem is shorter
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5, half = warp / kQGroups;  // half: 64-key share
  const int qr = row0 + (warp % kQGroups) * 16;  // the group's first row
  const bool active = qr < P.nq;
  const long long bh = (long long)b * kHeads + h;
  const float* kb = P.k + bh * P.nk * DH;
  const float* vb = P.v + bh * P.nk * DH;
  const unsigned char* mb = P.kmask ? P.kmask + (long long)b * P.nk : nullptr;

  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * kKeyTile;
    for (int e = tid; e < kKeyTile * DH / 4; e += kAttnThreads) {
      const int kk = e / (DH / 4), c = 4 * (e % (DH / 4)), key = k0 + kk;
      const bool in = key < P.nk;
      const long long src = (long long)(in ? key : 0) * DH + c;
      cp_async16(&s_k[buf][kk * kStride + c], kb + src, in);
      cp_async16(&s_v[buf][kk * kStride + c], vb + src, in);
    }
    for (int kk = tid; kk < kKeyTile; kk += kAttnThreads) {
      const int key = k0 + kk;
      s_valid[buf][kk] = key < P.nk && (mb == nullptr || mb[key]);
    }
    cp_async_commit();
  };

  // q's operand (rows g, g + 8; channels t, t + 4 of each k-step), with
  // log2(e) / sqrt(DH) folded in
  uint32_t qh[kSteps][4], ql[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qr + g + 8 * (i & 1), col = 8 * ks + t + 4 * (i >> 1);
      const float v = row < P.nq
                          ? P.q[(bh * P.nq + row) * DH + col] * a.scale_log2
                          : 0.f;
      split_tf32(v, qh[ks][i], ql[ks][i]);
    }
  const float neg_inf = -__int_as_float(0x7f800000);
  // p v accumulates in two sets (even and odd 8-key chunks): two shorter
  // chains of dependent products
  float o[2][kSteps][4] = {}, m[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};

  const int n_tiles = (P.nk + kKeyTile - 1) / kKeyTile;
  load_tile(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* sk = s_k[buf] + 64 * half * kStride;
      const float* sv = s_v[buf] + 64 * half * kStride;
      const bool* valid = s_valid[buf] + 64 * half;
      float s[kChunks][4];
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        s[ch][0] = s[ch][1] = s[ch][2] = s[ch][3] = 0.f;
        const float* kr = sk + (8 * ch + g) * kStride;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          uint32_t kh[2], kl[2];
          split_tf32(kr[8 * ks + t], kh[0], kl[0]);
          split_tf32(kr[8 * ks + t + 4], kh[1], kl[1]);
          mma_3xtf32(s[ch], qh[ks], ql[ks], kh, kl);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!valid[8 * ch + 2 * t + (i & 1)]) s[ch][i] = neg_inf;
      }
      // online softmax of rows g (values 0, 1) and g + 8 (values 2, 3)
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        mt[0] = fmaxf(mt[0], fmaxf(s[ch][0], s[ch][1]));
        mt[1] = fmaxf(mt[1], fmaxf(s[ch][2], s[ch][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float alpha = mt[r] == neg_inf ? 1.f : exp2f(m[r] - mt[r]);
        m[r] = mt[r];
        l[r] *= alpha;
#pragma unroll
        for (int nt = 0; nt < kSteps; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            o[e][nt][2 * r] *= alpha;
            o[e][nt][2 * r + 1] *= alpha;
          }
      }
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mr = m[i >> 1];  // -inf: no valid key yet, p = 0
          p[i] = mr == neg_inf ? 0.f : exp2f(s[ch][i] - mr);
        }
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        uint32_t ph[4], pl[4];  // k-index t: key 2t; t + 4: key 2t + 1
        split_tf32(p[0], ph[0], pl[0]);
        split_tf32(p[2], ph[1], pl[1]);
        split_tf32(p[1], ph[2], pl[2]);
        split_tf32(p[3], ph[3], pl[3]);
        const float* vr = sv + (8 * ch + 2 * t) * kStride + g;
#pragma unroll
        for (int nt = 0; nt < kSteps; ++nt) {
          uint32_t vh[2], vl[2];
          split_tf32(vr[8 * nt], vh[0], vl[0]);
          split_tf32(vr[kStride + 8 * nt], vh[1], vl[1]);
          mma_3xtf32(o[ch & 1][nt], ph, pl, vh, vl);
        }
      }
    }
    __syncthreads();  // the buffer is read before the next load overwrites
  }

  // the two halves of a group merge: half 1 leaves its m, l and context
  // in shared memory (the tiles' space: every read of it is done), half 0
  // rescales both to the common maximum and writes
  constexpr int kPart = 4 + 4 * kSteps;  // m, l of two rows; o
  float* part = s_k[0] + ((warp % kQGroups) * 32 + lane) * kPart;
  static_assert(kQGroups * 32 * kPart <= kKeyTile * kStride,
                "the merge fits in a tile buffer");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      part[r] = m[r];
      part[2 + r] = l[r];
    }
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[4 + 4 * nt + i] = o[0][nt][i] + o[1][nt][i];
  }
  __syncthreads();
  if (half == 1 || !active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + g + 8 * r;
    const float m1 = part[r], mm = fmaxf(m[r], m1);
    const float f0 = m[r] == neg_inf ? 0.f : exp2f(m[r] - mm);
    const float f1 = m1 == neg_inf ? 0.f : exp2f(m1 - mm);
    const float lr = l[r] * f0 + part[2 + r] * f1;
    if (row >= P.nq) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;  // no valid key: zero
    float* out = P.ctx + ((long long)b * P.nq + row) * (kHeads * DH) +
                 h * DH + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt) {
      const float* o1 = part + 4 + 4 * nt + 2 * r;
      *reinterpret_cast<float2*>(out + 8 * nt) = make_float2(
          ((o[0][nt][2 * r] + o[1][nt][2 * r]) * f0 + o1[0] * f1) * inv,
          ((o[0][nt][2 * r + 1] + o[1][nt][2 * r + 1]) * f0 + o1[1] * f1) *
              inv);
    }
  }
}

// ------------------------------------------------------------------- host

template <int D, bool kFfn, int T>
constexpr size_t row_smem() {
  return sizeof(float) * ((kFfn ? ffn_weights<D>() : 0) +
                          proj_weights<D, T>() + kRowThreads / 32 *
                          kRowsPerWarp * 5 * D);
}

template <int D, bool kFfn, int T>
cudaError_t set_row_smem() {
  return cudaFuncSetAttribute(row_kernel<D, kFfn, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)row_smem<D, kFfn, T>());
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
  if (err == cudaSuccess) err = set_row_smem<D, false, 3>();
  if (err == cudaSuccess) err = set_row_smem<D, true, 2>();
  if (err == cudaSuccess) err = set_row_smem<D, true, 3>();
  if (err == cudaSuccess) err = set_row_smem<D, true, 0>();
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

// Enqueues kernel<<<grid, block, smem, stream>>>(args), with programmatic
// stream serialisation if pdl: it may then start while the previous kernel
// drains.
template <typename Args>
cudaError_t launch(void (*kernel)(Args), dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, bool pdl, const Args& args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = pdl;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// The launch plan of layers [l_begin, l_end): the first layer's self
// projection, then per layer self attention, self FFN + cross projection,
// cross attention, and cross FFN + the next layer's self projection (the
// last layer's cross FFN alone): 4 (l_end - l_begin) + 1 launches. pdl:
// the launches after the first are programmatic dependent launches.
template <int D>
cudaError_t run_layers(int l_begin, int l_end, const float* x0,
                       const float* x1, float* o0, float* o1,
                       const float* cs0, const float* sn0, const float* cs1,
                       const float* sn1, const unsigned char* mask0,
                       const unsigned char* mask1, const float* packed,
                       float* scratch, long long layer_stride, int B, int M,
                       int N, bool pdl, cudaStream_t stream) {
  constexpr int DH = D / kHeads;
  constexpr int kSelf = 3 * D * D + 3 * D;  // self projection
  constexpr int kCross = 2 * D * D + 2 * D;  // cross projection
  constexpr int kBlock = kSelf + ffn_weights<D>();  // the self block
  cudaError_t err = set_smem_limits<D>();
  if (err != cudaSuccess) return err;
  // scratch: image 0 q | k | v | ctx, each (B, M, D) floats; then image 1
  const long long s0 = (long long)B * M * D, s1 = (long long)B * N * D;
  float* qkv0 = scratch;
  float* ctx0 = scratch + 3 * s0;
  float* qkv1 = scratch + 4 * s0;
  float* ctx1 = qkv1 + 3 * s1;
  const int rows = B * (M + N);
  const dim3 row_grid((rows + kRowRows - 1) / kRowRows);
  const dim3 attn_grid(((M > N ? M : N) + kQRows - 1) / kQRows, kHeads,
                       2 * B);
  const float scale_log2 = kLog2e / sqrtf((float)DH);
  auto layer = [&](int l) { return packed + l * layer_stride; };

  err = launch(row_kernel<D, false, 3>, row_grid, kRowThreads,
               row_smem<D, false, 3>(), stream, false,
               RowArgs{x0, x1, nullptr, nullptr, nullptr, nullptr, nullptr,
                       layer(l_begin), cs0, sn0, cs1, sn1, qkv0, qkv1, B, M,
                       N});
  const float* cur0 = x0;
  const float* cur1 = x1;
  for (int l = l_begin; l < l_end && err == cudaSuccess; ++l) {
    const float* w_cross = layer(l) + kBlock;
    err = launch(attn_kernel<DH>, attn_grid, kAttnThreads, 0, stream, pdl,
                 AttnArgs{{qkv0, qkv0 + s0, qkv0 + 2 * s0, mask0, ctx0, M, M},
                          {qkv1, qkv1 + s1, qkv1 + 2 * s1, mask1, ctx1, N, N},
                          scale_log2});
    if (err != cudaSuccess) break;
    // self FFN into o0/o1, then the cross projection: qk into the q slot,
    // v into the v slot
    err = launch(row_kernel<D, true, 2>, row_grid, kRowThreads,
                 row_smem<D, true, 2>(), stream, pdl,
                 RowArgs{cur0, cur1, ctx0, ctx1, o0, o1, layer(l) + kSelf,
                         w_cross, nullptr, nullptr, nullptr, nullptr, qkv0,
                         qkv1, B, M, N});
    if (err != cudaSuccess) break;
    cur0 = o0;
    cur1 = o1;
    err = launch(attn_kernel<DH>, attn_grid, kAttnThreads, 0, stream, pdl,
                 AttnArgs{{qkv0, qkv1, qkv1 + 2 * s1, mask1, ctx0, M, N},
                          {qkv1, qkv0, qkv0 + 2 * s0, mask0, ctx1, N, M},
                          scale_log2});
    if (err != cudaSuccess) break;
    // cross FFN in place, then the next layer's self projection
    const RowArgs ffn{o0, o1, ctx0, ctx1, o0, o1, w_cross + kCross,
                      l + 1 < l_end ? layer(l + 1) : nullptr, cs0, sn0, cs1,
                      sn1, qkv0, qkv1, B, M, N};
    err = l + 1 < l_end
              ? launch(row_kernel<D, true, 3>, row_grid, kRowThreads,
                       row_smem<D, true, 3>(), stream, pdl, ffn)
              : launch(row_kernel<D, true, 0>, row_grid, kRowThreads,
                       row_smem<D, true, 0>(), stream, pdl, ffn);
  }
  return err;
}

}  // namespace

// Layers [l_begin, l_end) of the stack. x0 (B,M,D), x1 (B,N,D) in; o0, o1
// out (the same shapes, distinct from the inputs); cs/sn (B,n,DH/2); masks
// (B,n) bytes or null; packed (L, layer_stride) floats; scratch
// 4*B*(M+N)*D floats. All contiguous. D in {32, 64}, 4 heads. pdl 0 turns
// programmatic dependent launch off for the whole call (same results), so
// that a profiler's per-kernel durations do not overlap. Returns the first
// cudaError_t of the launches.
extern "C" int nvs_lightglue_layers(
    int l_begin, int l_end, const float* x0, const float* x1, float* o0,
    float* o1, const float* cs0, const float* sn0, const float* cs1,
    const float* sn1, const unsigned char* mask0,
    const unsigned char* mask1, const float* packed, float* scratch,
    long long layer_stride, int B, int M, int N, int D, int pdl,
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
                                 layer_stride, B, M, N, pdl != 0, stream);
    case 64:
      return (int)run_layers<64>(l_begin, l_end, x0, x1, o0, o1, cs0, sn0,
                                 cs1, sn1, mask0, mask1, packed, scratch,
                                 layer_stride, B, M, N, pdl != 0, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
