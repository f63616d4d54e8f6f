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
//   row_kernel (D = 32, 64): 8 rows a block, 2 rows a warp sharing each
//     weight read; the self FFN is fused with the cross projection that
//     follows it, and the cross FFN with the next layer's self projection
//     (the row a warp finishes is the row it projects). The FFN is the out projection, fc1
//     over [x, msg], LayerNorm (eps 1e-5), exact GELU (erff), fc2 and the
//     residual; the projection applies the rotary to the interleaved (even,
//     odd) pairs in neighbouring lanes, in the module's basis (no
//     half-basis permutation). q, k, v go out as (B, H, n, DH).
//   attn_kernel<DH> (DH = 8, 16): flash-style online softmax on the
//     tensor cores. A block takes 32 query rows of one head of one problem
//     (self: image 0 and image 1; cross: the two directions), 16 rows and
//     half the keys a warp; its four warps share each 128-key tile of K and
//     V, double-buffered with cp.async. q k^T and p v are m16n8k8 TF32
//     products in 3xTF32, which keeps float32 accuracy; exp2 with log2(e)
//     folded into the scale.
//
// D = 256 (config "default", namespace d256). A layer's weights are 2.6 MB
// (float32) and its products 31.4 / 79.7 GFLOP a call at K = 512 / 1024
// (9 layers): bound by operations, 0.190 / 0.483 ms with everything in
// 3xTF32 on the tensor cores at 165 TFLOP/s. The first D = 256 kernels
// (row_tiled_kernel and attn_kernel<64>, one block an SM) reached 16% /
// 30% of the float32 bound, held back by three things; what this design
// does about each:
//   - Half the card or less: 64 / 128 blocks of 16 rows. row_kernel
//     shares a tile of RT = 32 rows among the CL = 4 blocks of a
//     thread-block cluster, each computing 1 / CL of every product's
//     output columns: 128 blocks at K = 512 (1,024 rows), 32 clusters of
//     4, with 111 KB of shared memory a block: two blocks an SM. (Tiles of
//     64 rows over 8 blocks measured slower: PERF.md §6.)
//     The LayerNorm's row statistics over 2D = 512 (mean and M2 of each
//     warp's columns, merged in one order, Chan et al.) and the operand
//     rows each block needs whole (msg, h, y) go through distributed
//     shared memory: a block writes its columns into its own buffer, and
//     after a cluster barrier every block pulls the others' with 16-byte
//     ld.shared::cluster loads; a last barrier keeps each block until its
//     peers are done reading it. The operand buffer holds 256 columns: fc1
//     runs over [x] then [msg], fc2 over h's two halves.
//   - The CUDA cores, bound by shared-memory reads: every product is an
//     m16n8k8 TF32 product in 3xTF32 (two sums: A_hi W_hi; A_lo W_hi +
//     A_hi W_lo). The weights are split into TF32 hi / lo once, by
//     split_weights_kernel, into B-fragment order ([K/8][N/8][32 lanes]
//     float4 {hi, hi, lo, lo}; the module caches the copy beside its
//     packed weights); a warp reads a fragment as one 16-byte load and
//     splits only its operand rows. The rotary takes the (even, odd) pairs
//     each thread holds in its accumulators.
//   - Every block streaming every weight from L2: not reduced. A block
//     streams only its columns' share of each weight, but as hi / lo
//     fragments, twice the float32 bytes: a row tile reads the launch's
//     fragments (5.2 MB) once, so a launch at K = 512 reads ~166 MB of L2,
//     as the first design's 64 blocks of 2.6 MB did (PERF.md §6: the
//     row stage is bound by moving data; multicast to the blocks of a
//     cluster is still to do). What the design does is keep the stream in
//     flight: a ring of 6 stages filled by TMA bulk copies (cp.async.bulk
//     with an mbarrier a stage, issued by one thread, kept 5 chunks ahead),
//     one sequence across the launch's products, so that the next
//     product's first chunks land during this one's epilogue and exchanges.
//   From kTiledRows = 1,536 rows on, the row stage is the first design's
//   row_tiled_kernel (16 rows a block across the full width, float32
//   weights streamed with cp.async, CUDA cores). It measured faster at
//   K = 1024 (2,048 rows: the clusters take two or more waves and twice
//   the L2 traffic of K = 512) and the clusters faster at K = 512 (1,024
//   rows); no shape between was timed, and the cut is their midpoint.
//   d256::attn_kernel (DH = 64): a cluster of 2 blocks shares 64 query
//     rows (4 groups of 16, 2 warps a group); block r takes key tiles r,
//     r + 2, ... (32 keys), each warp 16 keys of a tile. K and V land raw in
//     a 3-stage cp.async ring (swizzled 16-byte chunks), and one pass of the
//     block splits a tile into TF32 hi / lo once, in fragment order; no warp
//     splits K or V. The four partials of a group (2 warps x 2 blocks) merge
//     in block 0 in a fixed order, block 1's through distributed shared
//     memory. 112 KB: two blocks an SM; 128 blocks at K = 512.
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
// Every sum is taken in a fixed order (no atomics, no split whose order
// varies): results are the same bits with PDL on and off, launch to
// launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------- FFN and/or projection, D = 256

namespace d256 {

constexpr int D = 256, D2 = 2 * D, DH = D / kHeads;
constexpr int kLda = D + 4;  // padded operand row: conflict-free fragments

// A row tile of RT = 32 rows is shared by the CL = 4 blocks of a cluster,
// each computing 1 / CL of every product's output columns; a block's 8
// warps are WM along the rows (16 each) by WN along the columns, and a
// warp takes nt(N) n-tiles of 8 columns of a (K, N) product. The operand
// buffer holds RT rows of 256 columns: fc1 runs over [x] then [msg], fc2
// over h's two halves. A ring stage holds kStageTiles n-tile k-steps
// (512 bytes each) of weight fragments; a product's chunk takes ks(NB)
// k-steps of its NB n-tiles, the most that fit. 6 stages of 12 KB, 111 KB
// a block: two blocks an SM. (Tiles of 64 rows over 8 blocks, 3 stages of
// 24 KB, 113 KB, also two blocks an SM, measured slower at K = 512: see
// PERF.md §6.)
constexpr int RT = 32;
struct Tile {
  static constexpr int CL = RT / 8;
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;  // blocks an SM
  static constexpr int WM = RT / 16;
  static constexpr int WN = kThreads / 32 / WM;
  static constexpr int kStages = 6;
  static constexpr int kStageTiles = 24;
  static constexpr int kStageF4 = kStageTiles * 32;
  static constexpr int kSlots = CL * WN;  // LayerNorm partials a row
  // the block's share of the biases and LayerNorm parameters: bo, b1, g,
  // beta, b2, the projection's bias
  static constexpr int kPar = (D + 3 * D2 + D + 3 * D) / CL;
  __host__ __device__ static constexpr int nt(int N) { return N / 8 / CL / WN; }
  __host__ __device__ static constexpr int ks(int nb) {
    return nb * 8 <= kStageTiles ? 8 : nb * 4 <= kStageTiles ? 4
         : nb * 2 <= kStageTiles ? 2 : 1;
  }
};

struct Smem {
  float4 ring[Tile::kStages][Tile::kStageF4];  // weight fragments
  float a[RT][kLda];  // the operand rows: ctx, x, msg, h's halves, y
  float2 ln[RT][Tile::kSlots];  // LayerNorm partials (mean, M2)
  float par[Tile::kPar];
  unsigned long long full[Tile::kStages];  // a stage's bytes landed
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A product's weights, split into TF32 hi / lo once (split_weights_kernel)
// and laid out as m16n8k8 B fragments: [K/8][N/8][32 lanes] float4.
struct Mat {
  const float4* w;
  int chunks;   // K / 8 / ks
  int ks;       // k-steps a chunk
  int n_tiles;  // N / 8
};

constexpr int kMaxMats = 4;

// The weights of a launch's products in order, streamed through the ring
// in chunks: one sequence across the products, so the next product's first
// chunks load during this one's epilogue and exchanges. Chunk j goes to
// stage j % kStages; a block copies its own n-tiles, a k-step's (NB * 512
// contiguous bytes) a TMA bulk copy, all issued by thread 0, which tells
// the stage's mbarrier the bytes to expect; the threads wait for the
// barrier's phase (j / kStages) % 2 to complete.
struct Stream {
  static constexpr int kStages = Tile::kStages;
  Mat mats[kMaxMats];
  int n_mats;
  float4* ring;
  unsigned long long* full;  // kStages mbarriers
  int rank;  // the block's rank in its cluster: its column share
  int j;     // the next chunk to consume

  __device__ __forceinline__ void issue(int chunk) const {
    const float4* w = nullptr;
    int n_tiles = 0, ks = 0, c = chunk;
#pragma unroll
    for (int m = 0; m < kMaxMats; ++m) {
      if (w == nullptr && m < n_mats) {
        if (c < mats[m].chunks) {
          w = mats[m].w;
          n_tiles = mats[m].n_tiles;
          ks = mats[m].ks;
        } else {
          c -= mats[m].chunks;
        }
      }
    }
    if (w == nullptr || threadIdx.x != 0) return;  // past the last chunk
    const int nb = n_tiles / Tile::CL;
    const uint32_t bytes = nb * 32 * sizeof(float4);  // a k-step
    const float4* src =
        w + ((long long)c * ks * n_tiles + (long long)rank * nb) * 32;
    float4* dst = ring + (chunk % kStages) * Tile::kStageF4;
    const uint32_t bar = smem_addr(full + chunk % kStages);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes * ks) : "memory");
    for (int k = 0; k < ks; ++k)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(dst + k * nb * 32)),
             "l"(src + (long long)k * n_tiles * 32), "r"(bytes), "r"(bar)
          : "memory");
  }

  // waits until chunk j has landed
  __device__ __forceinline__ void wait_chunk() const {
    const uint32_t bar = smem_addr(full + j % kStages);
    const uint32_t parity = (j / kStages) & 1;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }

  // hi, lo += the warp's 16 rows of A (k_steps k-steps, row stride kLda,
  // in shared memory) times its NT n-tiles of the product being streamed,
  // in chunks of KS k-steps, as 3xTF32 in two sums: hi takes A_hi W_hi, lo
  // the two small terms. Each chunk starts with a block barrier, after
  // which the chunk kStages - 1 ahead is issued into the stage the
  // previous chunk used.
  template <int NT, int KS>
  __device__ __forceinline__ void gemm(int k_steps, const float* A,
                                       float (&hi)[NT][4],
                                       float (&lo)[NT][4]) {
    constexpr int NB = NT * Tile::WN;  // n-tiles a block
    static_assert(KS == Tile::ks(NB), "the chunk the stream copies");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp % Tile::WM, wn = warp / Tile::WM;
    const float* ar = A + (16 * wm + (lane >> 2)) * kLda + (lane & 3);
    for (int c = 0; c < k_steps / KS; ++c, ++j) {
      __syncthreads();  // every warp is done with chunk j - 1's stage
      issue(j + kStages - 1);
      wait_chunk();
      const float4* st =
          ring + (j % kStages) * Tile::kStageF4 + wn * NT * 32 + lane;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const float* a = ar + 8 * (c * KS + ks);
        uint32_t ah[4], al[4];
        nvs::split_tf32(a[0], ah[0], al[0]);
        nvs::split_tf32(a[8 * kLda], ah[1], al[1]);
        nvs::split_tf32(a[4], ah[2], al[2]);
        nvs::split_tf32(a[8 * kLda + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 b = st[(ks * NB + n) * 32];
          const uint32_t bh[2] = {__float_as_uint(b.x), __float_as_uint(b.y)};
          const uint32_t bl[2] = {__float_as_uint(b.z), __float_as_uint(b.w)};
          nvs::mma_tf32(lo[n], al, bh);
          nvs::mma_tf32(lo[n], ah, bl);
          nvs::mma_tf32(hi[n], ah, bh);
        }
      }
    }
  }
};

// The block's first column of n-tile n of a warp's NT (of the product's
// columns; the block's own start at rank * 8 NT WN).
template <int NT>
__device__ __forceinline__ int tile_col(int n) {
  const int wn = (threadIdx.x >> 5) / Tile::WM;
  return 8 * (wn * NT + n);
}

// An accumulator tile's two rows (values 0, 1: row g; 2, 3: row g + 8;
// columns 2t, 2t + 1) regrouped between lanes t and t ^ 1: even t gets
// row g, odd t row g + 8, each with the four columns 4 (t / 2) .. + 3.
__device__ __forceinline__ float4 quad(float v0, float v1, float v2,
                                       float v3) {
  const bool odd = threadIdx.x & 1;
  const float sx = odd ? v0 : v2, sy = odd ? v1 : v3;  // the partner's
  const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
  const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
  return odd ? make_float4(rx, ry, v2, v3) : make_float4(v0, v1, rx, ry);
}

// v to the same place in every block of the cluster (its own included).
template <int CL>
__device__ __forceinline__ void push(float2* local, float2 v) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(local);
#pragma unroll
  for (int q = 0; q < CL; ++q) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(addr), "r"(q));
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
                 :: "r"(remote), "f"(v.x), "f"(v.y) : "memory");
  }
}

// Rows [0, RT) x columns [c0(q), c0(q) + W) of the operand buffer, from
// the blocks q = q0 .. q0 + NQ - 1 of the cluster (this one's own included:
// a copy in place), into this block's buffer: 16-byte loads of distributed
// shared memory, eight in flight a thread. c0(q) = q * W - shift.
template <int NQ, int W>
__device__ __forceinline__ void pull(float (*A)[kLda], int q0, int shift) {
  constexpr int kF4 = RT * W / 4, kAll = NQ * kF4, kBatch = 8;
  constexpr int kThreads = Tile::kThreads;
  static_assert(kAll % (kThreads * kBatch) == 0, "whole batches");
  for (int e0 = threadIdx.x; e0 < kAll; e0 += kThreads * kBatch) {
    float4 v[kBatch];
    float* dst[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kThreads, q = q0 + e / kF4, f = e % kF4;
      dst[b] = &A[f / (W / 4)][q * W - shift + 4 * (f % (W / 4))];
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(remote) : "r"(smem_addr(dst[b])), "r"(q));
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(v[b].x), "=f"(v[b].y), "=f"(v[b].z), "=f"(v[b].w)
                   : "r"(remote) : "memory");
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) *reinterpret_cast<float4*>(dst[b]) = v[b];
  }
}

// All threads of all blocks of the cluster: what any of them wrote to
// shared memory before (its own or a peer's) is visible to all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// cluster_sync in two halves: a block arrives after its last read of a
// peer's shared memory and waits before it exits, so that no block's
// shared memory goes away while a peer still reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float gelu(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

struct Args {
  RowArgs r;              // w_ffn / w_proj: the packed layer, for biases
  const float4* f_ffn;    // wo, fc1, fc2 as fragments (split_weights_kernel)
  const float4* f_proj;   // the projection's
};

// What row_kernel<kFfn, T> computes, for a tile of RT rows of both
// images (image 0's B*M rows, then image 1's) across a cluster of CL
// blocks (see the file's head).
template <bool kFfn, int T>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    row_kernel(Args args) {
  using TL = Tile;
  constexpr int CL = TL::CL, kThreads = TL::kThreads, kSlots = TL::kSlots;
  constexpr int kWo = TL::nt(D), kFc1 = TL::nt(D2), kFc2 = TL::nt(D);
  constexpr int kP = TL::nt(T * D);
  constexpr int kKsWo = TL::ks(kWo * TL::WN), kKsFc1 = TL::ks(kFc1 * TL::WN);
  constexpr int kKsFc2 = TL::ks(kFc2 * TL::WN), kKsP = TL::ks(kP * TL::WN);
  extern __shared__ float4 row256_smem4[];
  auto& s = *reinterpret_cast<Smem*>(row256_smem4);
  const RowArgs& a = args.r;
  uint32_t rank_u;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank_u));
  const int rank = (int)rank_u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % TL::WM, wn = warp / TL::WM;

  Stream ws;
  ws.ring = &s.ring[0][0];
  ws.full = s.full;
  ws.rank = rank;
  ws.j = 0;
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < TL::kStages; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&s.full[q])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const Mat proj{args.f_proj, D / 8 / kKsP, kKsP, T * D / 8};
  if (kFfn) {
    ws.mats[0] = Mat{args.f_ffn, D / 8 / kKsWo, kKsWo, D / 8};           // wo
    ws.mats[1] = Mat{args.f_ffn + D * D / 2, D2 / 8 / kKsFc1, kKsFc1,
                     D2 / 8};                                            // fc1
    ws.mats[2] = Mat{args.f_ffn + 5 * D * D / 2, D2 / 8 / kKsFc2, kKsFc2,
                     D / 8};                                             // fc2
    ws.mats[3] = proj;
    ws.n_mats = T > 0 ? 4 : 3;
  } else {
    ws.mats[0] = proj;
    ws.n_mats = 1;
  }
  // the weights were written before the call: the ring and the block's
  // parameters load before the wait for the previous launch
#pragma unroll
  for (int c = 0; c < TL::kStages - 1; ++c) ws.issue(c);
  // s.par: bo | b1 | g | beta | b2 | projection bias, the block's columns
  constexpr int kBo = 0, kB1 = D / CL, kG = kB1 + D2 / CL, kBeta = kG + D2 / CL;
  constexpr int kB2 = kBeta + D2 / CL, kBp = kB2 + D / CL;
  if (kFfn) {
    const float* w_bo = a.w_ffn + D * D;
    const float* w_b1 = w_bo + D + D2 * D2;
    const float* w_b2 = w_b1 + 3 * D2 + D2 * D;
    for (int e = tid; e < D / CL; e += kThreads) {
      s.par[kBo + e] = w_bo[rank * (D / CL) + e];
      s.par[kB2 + e] = w_b2[rank * (D / CL) + e];
    }
    for (int e = tid; e < D2 / CL; e += kThreads)
#pragma unroll
      for (int p = 0; p < 3; ++p)  // b1, g, beta: D2 apart
        s.par[kB1 + p * (D2 / CL) + e] = w_b1[p * D2 + rank * (D2 / CL) + e];
  }
  if (T > 0)
    for (int e = tid; e < T * D / CL; e += kThreads)
      s.par[kBp + e] = a.w_proj[T * D * D + rank * (T * D / CL) + e];
  wait_previous_launch();
  allow_next_launch();

  const int rows0 = a.B * a.M, rows = rows0 + a.B * a.N;
  const int row_base = (blockIdx.x / CL) * RT;
  // the operand rows src (ctx or x), zero past the last; async: its wait
  // and the next chunk's barrier publish them
  auto load_rows = [&](const float* src0, const float* src1) {
    for (int e = tid; e < RT * D / 4; e += kThreads) {
      const int i = e / (D / 4), c = 4 * (e % (D / 4)), row = row_base + i;
      const bool in = row < rows;
      const int im = row >= rows0;
      const long long o = in ? (long long)(im ? row - rows0 : row) * D + c : 0;
      nvs::cp_async16(&s.a[i][c], pick(im, src0, src1) + o, in);
    }
    nvs::cp_async_commit();
  };
  load_rows(kFfn ? a.ctx0 : a.x0, kFfn ? a.ctx1 : a.x1);
  nvs::cp_async_wait<0>();

  // the rows of the thread's accumulators (h = 0: 16 wm + g; 1: + 8), and
  // of its quad() groups (16 wm + g + 8 (t & 1))
  const int qrow = 16 * wm + g + 8 * (t & 1);
  auto where = [&](int i, int& img, long long& rr) {  // -> in range
    const int row = row_base + i;
    img = row >= rows0;
    rr = img ? row - rows0 : row;  // the row within its image's (B, n)
    return row < rows;
  };
  const int c4 = 4 * (t >> 1);  // the quad's first column in its n-tile

  if constexpr (kFfn) {
    float4 m[kWo];  // msg = ctx wo + bo
    {
      float hi[kWo][4] = {}, lo[kWo][4] = {};
      ws.template gemm<kWo, kKsWo>(D / 8, &s.a[0][0], hi, lo);
#pragma unroll
      for (int n = 0; n < kWo; ++n) {
        const float* bo = &s.par[kBo + tile_col<kWo>(n) + 2 * t];
        m[n] = quad(hi[n][0] + lo[n][0] + bo[0], hi[n][1] + lo[n][1] + bo[1],
                    hi[n][2] + lo[n][2] + bo[0], hi[n][3] + lo[n][3] + bo[1]);
      }
    }
    __syncthreads();  // every warp has read ctx: x takes its place
    load_rows(a.x0, a.x1);
    nvs::cp_async_wait<0>();
    float4 hq[kFc1];  // h = GELU(LN([x, msg] fc1 + b1))
    {
      float hi[kFc1][4] = {}, lo[kFc1][4] = {};
      ws.template gemm<kFc1, kKsFc1>(D / 8, &s.a[0][0], hi, lo);  // x
      __syncthreads();  // every warp has read x: msg takes its place
#pragma unroll
      for (int n = 0; n < kWo; ++n)
        *reinterpret_cast<float4*>(
            &s.a[qrow][rank * (D / CL) + tile_col<kWo>(n) + c4]) = m[n];
      cluster_sync();  // every block's share of msg is in place
      pull<CL, D / CL>(s.a, 0, 0);
      ws.template gemm<kFc1, kKsFc1>(D / 8, &s.a[0][0], hi, lo);  // msg
      float v[kFc1][4], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kFc1; ++n) {
        const float* b1 = &s.par[kB1 + tile_col<kFc1>(n) + 2 * t];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[n][e] = hi[n][e] + lo[n][e] + b1[e & 1];
          sum[e >> 1] += v[n][e];
        }
      }
      // the row's mean and M2 over the warp's columns, then merged over
      // every block and warp in one order (Chan et al.: equal counts)
      constexpr int kCols = 8 * kFc1;
      float mean[2], m2[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        mean[h] = sum[h] / kCols;
      }
#pragma unroll
      for (int n = 0; n < kFc1; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = v[n][e] - mean[e >> 1];
          m2[e >> 1] += d * d;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], 1);
        m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], 2);
        if (t == 0)
          push<CL>(&s.ln[16 * wm + g + 8 * h][rank * TL::WN + wn],
                   make_float2(mean[h], m2[h]));
      }
      cluster_sync();  // every block is done with msg, too
      float mu[2], rstd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2* p = s.ln[16 * wm + g + 8 * h];
        float mm = 0.f;
#pragma unroll
        for (int q = 0; q < kSlots; ++q) mm += p[q].x;
        mm /= kSlots;
        float var = 0.f;
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
          const float d = p[q].x - mm;
          var += p[q].y + kCols * d * d;
        }
        mu[h] = mm;
        rstd[h] = rsqrtf(var / D2 + 1e-5f);
      }
#pragma unroll
      for (int n = 0; n < kFc1; ++n) {
        const int col = tile_col<kFc1>(n) + 2 * t;
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = gelu((v[n][e] - mu[e >> 1]) * rstd[e >> 1] *
                          s.par[kG + col + (e & 1)] +
                      s.par[kBeta + col + (e & 1)]);
        hq[n] = quad(y[0], y[1], y[2], y[3]);
      }
    }
    {  // y = x + h fc2 + b2: out to the rows, and to every block's operand
      // h's columns [0, D) come from blocks 0 .. CL/2 - 1, [D, 2D) from
      // the rest: fc2 takes them in two passes. A block writes its share
      // into its own buffer; after the barrier every block pulls the half.
      auto share_h = [&](int half) {
        if (rank / (CL / 2) == half)
#pragma unroll
          for (int n = 0; n < kFc1; ++n)
            *reinterpret_cast<float4*>(&s.a[qrow][rank * (D2 / CL) - half * D +
                                                  tile_col<kFc1>(n) + c4]) =
                hq[n];
        cluster_sync();  // also: every block is done pulling the last half
        pull<CL / 2, D2 / CL>(s.a, half * (CL / 2), half * D);
      };
      float hi[kFc2][4] = {}, lo[kFc2][4] = {};
      share_h(0);
      ws.template gemm<kFc2, kKsFc2>(D / 8, &s.a[0][0], hi, lo);
      __syncthreads();  // every warp has read h's first half
      share_h(1);
      if constexpr (T == 0) cluster_arrive();  // after this block's last read of a peer
      ws.template gemm<kFc2, kKsFc2>(D / 8, &s.a[0][0], hi, lo);
      int img;
      long long rr;
      const bool in = where(qrow, img, rr);
      // the residual from the rows themselves: y may be x (in place), and
      // only this thread reads or writes these four columns
      float4 y[kFc2];
      const float* x = pick(img, a.x0, a.x1) + rr * D + rank * (D / CL) + c4;
#pragma unroll
      for (int n = 0; n < kFc2; ++n) {
        const float* b2 = &s.par[kB2 + tile_col<kFc2>(n) + 2 * t];
        y[n] = quad(hi[n][0] + lo[n][0] + b2[0], hi[n][1] + lo[n][1] + b2[1],
                    hi[n][2] + lo[n][2] + b2[0], hi[n][3] + lo[n][3] + b2[1]);
      }
      float4 xr[kFc2];
#pragma unroll
      for (int n = 0; n < kFc2; ++n)
        xr[n] = in ? *reinterpret_cast<const float4*>(x + tile_col<kFc2>(n))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int n = 0; n < kFc2; ++n) {
        y[n] = make_float4(xr[n].x + y[n].x, xr[n].y + y[n].y,
                           xr[n].z + y[n].z, xr[n].w + y[n].w);
        if (in)
          *reinterpret_cast<float4*>(pick(img, a.y0, a.y1) + rr * D +
                                     rank * (D / CL) + tile_col<kFc2>(n) +
                                     c4) = y[n];
      }
      if constexpr (T > 0) {
        cluster_sync();  // every block is done with h
#pragma unroll
        for (int n = 0; n < kFc2; ++n)
          *reinterpret_cast<float4*>(
              &s.a[qrow][rank * (D / CL) + tile_col<kFc2>(n) + c4]) = y[n];
        cluster_sync();
        pull<CL, D / CL>(s.a, 0, 0);
        cluster_arrive();  // after this block's last read of a peer
      }
    }
  }
  if constexpr (T > 0) {
    // projection of [0, D): outputs (type, head, channel); the rotary on
    // q and k in the accumulators, whose (even, odd) pairs a thread holds
    constexpr int NT = kP;
    float hi[NT][4] = {}, lo[NT][4] = {};
    ws.template gemm<NT, kKsP>(D / 8, &s.a[0][0], hi, lo);
    int img[2];
    long long rr[2];
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) in[h] = where(16 * wm + g + 8 * h, img[h], rr[h]);
    float4 out[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = rank * (T * D / CL) + tile_col<NT>(n) + 2 * t;
      const int type = col / D, jj = col % DH;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = hi[n][e] + lo[n][e] + s.par[kBp + col - rank * (T * D / CL) + (e & 1)];
      if (T == 3 && type < 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long ti = (in[h] ? rr[h] : 0) * (DH / 2) + jj / 2;
          const float c = pick(img[h], a.cs0, a.cs1)[ti];
          const float sn = pick(img[h], a.sn0, a.sn1)[ti];
          const float e0 = v[2 * h], e1 = v[2 * h + 1];
          v[2 * h] = e0 * c - e1 * sn;
          v[2 * h + 1] = e1 * c + e0 * sn;
        }
      }
      out[n] = quad(v[0], v[1], v[2], v[3]);
    }
    const int h = t & 1;  // quad(): even t holds row g, odd t row g + 8
    if (in[h]) {
      const int n_img = pick(img[h], a.M, a.N);
      const long long b = rr[h] / n_img, i = rr[h] % n_img;
      const long long slot = (long long)a.B * n_img * D;  // one of q, k, v
      float* base = pick(img[h], a.qkv0, a.qkv1);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = rank * (T * D / CL) + tile_col<NT>(n) + c4;
        const int type = col / D, head = (col % D) / DH, jj = col % DH;
        *reinterpret_cast<float4*>(
            base + (T == 3 ? type : 2 * type) * slot +
            ((b * kHeads + head) * n_img + i) * DH + jj) = out[n];
      }
    }
  }
  if constexpr (kFfn) cluster_wait();  // every peer is done reading this one
}

// The weights of every layer's eight products (the self block's proj,
// wo, fc1, fc2, then the cross block's) as TF32 hi / lo fragments of
// m16n8k8's B operand: a (K, N) matrix W becomes [K/8][N/8][32] float4
// {hi W[8ks+t][8nt+g], hi W[8ks+t+4][8nt+g], lo of both}, g = lane / 4,
// t = lane % 4; 38 D^2 floats a layer. One thread a float4.
__global__ void split_weights_kernel(const float* __restrict__ packed,
                                     long long layer_stride, float4* out,
                                     int L) {
  constexpr long long kLayer = 19LL * D * D / 2;  // float4 a layer
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= L * kLayer) return;
  const int l = (int)(idx / kLayer);
  long long f = idx % kLayer;
  // per block (T = 3, then 2; the cross block after the self block's
  // 10 D^2 + 11 D floats): proj (D, T D) at 0, wo (D, D) at T D^2 + T D,
  // fc1 (2D, 2D) at (T+1) (D^2 + D), fc2 (2D, D) at (T+5) D^2 + (T+7) D
  const float* w = packed + l * layer_stride;
  int K = 0, N = 0;
  for (int blk = 0; blk < 2 && K == 0; ++blk) {
    const int T = 3 - blk;
    const long long mk[4] = {D, D, D2, D2}, mn[4] = {(long long)T * D, D, D2, D};
    const long long mo[4] = {0, (long long)T * D * D + T * D,
                             (long long)(T + 1) * (D * D + D),
                             (long long)(T + 5) * D * D + (T + 7) * D};
    for (int m = 0; m < 4; ++m) {
      const long long n4 = mk[m] * mn[m] / 2;
      if (f < n4) {
        w += mo[m];
        K = (int)mk[m];
        N = (int)mn[m];
        break;
      }
      f -= n4;
    }
    if (K == 0) w += 10LL * D * D + 11 * D;
  }
  const int lane = (int)(f % 32), g = lane >> 2, t = lane & 3;
  const long long frag = f / 32;
  const int nt = (int)(frag % (N / 8)), ks = (int)(frag / (N / 8));
  const float* src = w + (long long)(8 * ks + t) * N + 8 * nt + g;
  uint32_t h0, l0, h1, l1;
  nvs::split_tf32(src[0], h0, l0);
  nvs::split_tf32(src[4LL * N], h1, l1);
  out[idx] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                         __uint_as_float(l0), __uint_as_float(l1));
}

}  // namespace d256

// ----------------------- FFN and/or projection, D = 256, 1,536 rows or more

// The first design's row stage, kept for calls of kTiledRows rows or more,
// where it is faster than the clusters (see the file's head): a block of 8
// warps owns 16 rows across the full output width and streams each
// float32 weight matrix through shared memory in chunks of 32 input rows,
// double-buffered with cp.async, on the CUDA cores.

constexpr int kTileRows = 16;   // rows a block of the tiled row kernel
constexpr int kTileThreads = 256;
constexpr int kSlab = 256;      // output columns a pass
constexpr int kChunk = 32;      // weight rows a shared-memory chunk
constexpr int kRowGroups = kTileThreads / (kSlab / 4);  // 4 rows a thread
constexpr int kRowsPerThread = kTileRows / kRowGroups;

// acc[r][j] += sum over k < K of A[r0 + r][k] W[k][n0 + cg + 64 j], with
// r0 = 4 (tid / 64) and cg = tid % 64: A (kTileRows, lda) in shared memory,
// W (K, ldw) in device memory, streamed through s_w (2 x kChunk x kSlab
// floats) in chunks of kChunk rows. Starts and ends with a block barrier,
// so A may be written just before and s_w reused just after.
__device__ __forceinline__ void tile_gemm(
    const float* A, int lda, const float* __restrict__ W, int ldw, int n0,
    int K, float* s_w, float (&acc)[kRowsPerThread][4]) {
  const int tid = threadIdx.x, cg = tid % 64, rg = tid / 64;
  const int n_chunks = K / kChunk;
  auto load = [&](int c, int buf) {
    float* dst = s_w + buf * kChunk * kSlab;
    for (int e = tid; e < kChunk * kSlab / 4; e += kTileThreads) {
      const int kk = e / (kSlab / 4), c4 = 4 * (e % (kSlab / 4));
      nvs::cp_async16(dst + kk * kSlab + c4,
                      W + (long long)(c * kChunk + kk) * ldw + n0 + c4);
    }
    nvs::cp_async_commit();
  };
  __syncthreads();
  load(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load(c + 1, (c + 1) & 1);
      nvs::cp_async_wait<1>();
    } else {
      nvs::cp_async_wait<0>();
    }
    __syncthreads();
    const float* w = s_w + (c & 1) * kChunk * kSlab + cg;
    const float* a = A + rg * kRowsPerThread * lda + c * kChunk;
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      float av[kRowsPerThread], wv[4];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) av[r] = a[r * lda + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w[kk * kSlab + 64 * j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av[r], wv[j], acc[r][j]);
    }
    __syncthreads();  // every warp is done with this buffer
  }
}

template <bool kFfn>
struct TiledSmem {
  static constexpr int D = 256;
  float w[2 * kChunk * kSlab];  // weight chunks
  float xm[kTileRows][2 * D];   // [x | msg]
  float cy[kTileRows][D];       // ctx, then the FFN's output y
  float h[kFfn ? kTileRows : 1][2 * D];  // fc1, then LN and GELU
};

// What row_kernel<256, kFfn, T> would compute, with the weights streamed.
// A block takes kTileRows rows of both images (image 0's B*M rows, then
// image 1's).
template <bool kFfn, int T>
__global__ void __launch_bounds__(kTileThreads) row_tiled_kernel(RowArgs a) {
  constexpr int D = 256, D2 = 2 * D, DH = D / kHeads;
  constexpr int RT = kRowsPerThread;
  extern __shared__ float4 tiled_smem4[];
  auto& s = *reinterpret_cast<TiledSmem<kFfn>*>(tiled_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % 64, rg = tid / 64;
  wait_previous_launch();
  allow_next_launch();

  const int rows0 = a.B * a.M, rows = rows0 + a.B * a.N;
  const int row_base = blockIdx.x * kTileRows;
  // the rows this thread's accumulators hold
  int img[RT];
  long long off[RT];  // the row's element offset in its image's (B, n, D)
  bool valid[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row_base + rg * RT + r;
    valid[r] = row < rows;
    img[r] = row >= rows0;
    off[r] = valid[r] ? (long long)(img[r] ? row - rows0 : row) * D : 0;
  }
  for (int e = tid; e < kTileRows * D; e += kTileThreads) {
    const int i = e / D, c = e % D, row = row_base + i;
    const bool in = row < rows;
    const int im = row >= rows0;
    const long long o = in ? (long long)(im ? row - rows0 : row) * D + c : 0;
    s.xm[i][c] = in ? pick(im, a.x0, a.x1)[o] : 0.f;
    if (kFfn) s.cy[i][c] = in ? pick(im, a.ctx0, a.ctx1)[o] : 0.f;
  }
  float acc[RT][4];
  auto init = [&](const float* bias, int n0) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = bias[n0 + cg + 64 * j];
  };

  const float* y_rows = &s.xm[0][0];  // the rows the projection reads
  int y_ld = D2;
  if constexpr (kFfn) {
    const float* w_wo = a.w_ffn;
    const float* w_bo = w_wo + D * D;
    const float* w_fc1 = w_bo + D;
    const float* w_b1 = w_fc1 + D2 * D2;
    const float* w_g = w_b1 + D2;
    const float* w_beta = w_g + D2;
    const float* w_fc2 = w_beta + D2;
    const float* w_b2 = w_fc2 + D2 * D;
    // msg = ctx wo + bo, beside x
    init(w_bo, 0);
    tile_gemm(&s.cy[0][0], D, w_wo, D, 0, D, s.w, acc);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s.xm[rg * RT + r][D + cg + 64 * j] = acc[r][j];
    // fc1 over [x, msg], in two slabs
    for (int n0 = 0; n0 < D2; n0 += kSlab) {
      init(w_b1, n0);
      tile_gemm(&s.xm[0][0], D2, w_fc1, D2, n0, D2, s.w, acc);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s.h[rg * RT + r][n0 + cg + 64 * j] = acc[r][j];
    }
    __syncthreads();
    // LayerNorm (eps 1e-5) and exact GELU, a warp a row
    for (int i = warp; i < kTileRows; i += kTileThreads / 32) {
      constexpr int kPer = D2 / 32;
      float v[kPer], sum = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u) sum += (v[u] = s.h[i][lane + 32 * u]);
      const float mu = nvs::warp_sum(sum) / D2;
      float sq = 0.f;
#pragma unroll
      for (int u = 0; u < kPer; ++u) sq += (v[u] - mu) * (v[u] - mu);
      const float rstd = rsqrtf(nvs::warp_sum(sq) / D2 + 1e-5f);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int o = lane + 32 * u;
        const float t = (v[u] - mu) * rstd * w_g[o] + w_beta[o];
        s.h[i][o] = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
      }
    }
    // y = x + h fc2 + b2: out to the rows, and kept (over ctx) to project
    init(w_b2, 0);
    tile_gemm(&s.h[0][0], D2, w_fc2, D, 0, D2, s.w, acc);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = rg * RT + r, o = cg + 64 * j;
        const float y = s.xm[i][o] + acc[r][j];
        s.cy[i][o] = y;
        if (valid[r]) pick(img[r], a.y0, a.y1)[off[r] + o] = y;
      }
    y_rows = &s.cy[0][0];
    y_ld = D;
  }
  if constexpr (T > 0) {
    // projection: slab p holds outputs 256 p + cg + 64 j of (type, head,
    // channel); the rotary pairs (even, odd) sit in neighbouring lanes
    const float* w_bp = a.w_proj + T * D * D;
    for (int n0 = 0; n0 < T * D; n0 += kSlab) {
      init(w_bp, n0);
      tile_gemm(y_rows, y_ld, a.w_proj, T * D, n0, D, s.w, acc);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int n = pick(img[r], a.M, a.N);
        const long long rr = off[r] / D;  // row within its image's (B, n)
        const long long b = rr / n, i = rr % n;
        const long long slot = (long long)a.B * n * D;  // one of q, k, v
        float* out = pick(img[r], a.qkv0, a.qkv1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = n0 + cg + 64 * j;
          const int t = o / D, h = (o % D) / DH, jj = o % DH;
          float v = acc[r][j];
          if (T == 3 && t < 2) {  // rotary on q and k, interleaved pairs
            const float other = __shfl_xor_sync(0xffffffffu, v, 1);
            const long long ti = rr * (DH / 2) + jj / 2;
            const float c = valid[r] ? pick(img[r], a.cs0, a.cs1)[ti] : 0.f;
            const float sn = valid[r] ? pick(img[r], a.sn0, a.sn1)[ti] : 0.f;
            v = (jj & 1) ? v * c + other * sn : v * c - other * sn;
          }
          if (valid[r])
            out[(T == 3 ? t : 2 * t) * slot +
                ((b * kHeads + h) * n + i) * DH + jj] = v;
        }
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

using nvs::cp_async16;
using nvs::cp_async_commit;
using nvs::cp_async_wait;

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
struct AttnSmem {
  static constexpr int kStride = DH + 4;  // padded key row: no bank conflicts
  float k[2][kKeyTile * kStride];
  float v[2][kKeyTile * kStride];
  bool valid[2][kKeyTile];
};

template <int DH>
__global__ void __launch_bounds__(kAttnThreads) attn_kernel(AttnArgs a) {
  constexpr int kStride = AttnSmem<DH>::kStride;
  constexpr int kSteps = DH / 8;   // k-steps of q k^T, n-tiles of p v
  constexpr int kChunks = 64 / 8;  // 8-key chunks of a warp's share
  // p v accumulates in two sets (even and odd 8-key chunks), two shorter
  // chains of dependent products, while that costs few registers
  constexpr int kSets = kSteps >= 4 ? 1 : 2;
  extern __shared__ float4 attn_smem4[];
  auto& sm = *reinterpret_cast<AttnSmem<DH>*>(attn_smem4);
  auto& s_k = sm.k;
  auto& s_v = sm.v;
  auto& s_valid = sm.valid;

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
      nvs::split_tf32(v, qh[ks][i], ql[ks][i]);
    }
  const float neg_inf = -__int_as_float(0x7f800000);
  float o[kSets][kSteps][4] = {}, m[2] = {neg_inf, neg_inf};
  float l[2] = {0.f, 0.f};

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
          nvs::split_tf32(kr[8 * ks + t], kh[0], kl[0]);
          nvs::split_tf32(kr[8 * ks + t + 4], kh[1], kl[1]);
          nvs::mma_3xtf32(s[ch], qh[ks], ql[ks], kh, kl);
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
          for (int e = 0; e < kSets; ++e) {
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
        nvs::split_tf32(p[0], ph[0], pl[0]);
        nvs::split_tf32(p[2], ph[1], pl[1]);
        nvs::split_tf32(p[1], ph[2], pl[2]);
        nvs::split_tf32(p[3], ph[3], pl[3]);
        const float* vr = sv + (8 * ch + 2 * t) * kStride + g;
#pragma unroll
        for (int nt = 0; nt < kSteps; ++nt) {
          uint32_t vh[2], vl[2];
          nvs::split_tf32(vr[8 * nt], vh[0], vl[0]);
          nvs::split_tf32(vr[kStride + 8 * nt], vh[1], vl[1]);
          nvs::mma_3xtf32(o[ch % kSets][nt], ph, pl, vh, vl);
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
  auto osum = [&](int nt, int i) {
    float v = o[0][nt][i];
#pragma unroll
    for (int e = 1; e < kSets; ++e) v += o[e][nt][i];
    return v;
  };
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
      for (int i = 0; i < 4; ++i) part[4 + 4 * nt + i] = osum(nt, i);
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
          (osum(nt, 2 * r) * f0 + o1[0] * f1) * inv,
          (osum(nt, 2 * r + 1) * f0 + o1[1] * f1) * inv);
    }
  }
}

// ----------------------------------------------------- attention, DH = 64

namespace d256 {

constexpr int kAGroups = 4;   // groups of 16 query rows a block
constexpr int kAParts = 2;    // warps that share a group: 16 keys of a tile
constexpr int kACluster = 2;  // blocks that share a query tile: every
                              // other key tile each
constexpr int kAThreads = kAGroups * kAParts * 32;
constexpr int kARows = kAGroups * 16;  // query rows a block
constexpr int kATile = 32;             // keys a stage
constexpr int kAChunks = kATile / 8 / kAParts;  // 8-key chunks a warp a tile

// K and V land raw (cp.async ring of three stages, two tiles ahead); one
// pass of the block splits a stage into TF32 hi / lo once, in m16n8k8
// B-fragment order, so that a warp reads a fragment as one float4 and
// splits nothing:
//   kf[chunk][k-step][lane] = {hi K[8c+g][8ks+t], hi K[8c+g][8ks+t+4], lo,
//                              lo}  (q k^T: k = channel, n = key)
//   vf[chunk][n-tile][lane] = {hi V[8c+2t][8nt+g], hi V[8c+2t+1][8nt+g],
//                              lo, lo}  (p v: k-index t is key 2t, t + 4
//                              key 2t + 1, the scores' accumulator order)
// A raw key row's 16-byte chunks are swizzled (chunk q of key k at
// q ^ (k % 8)), so that the pass reads a fragment's two values without
// bank conflicts and writes 32 fragments at consecutive lanes. 112 KB in
// all: two blocks an SM.
constexpr int kARaw = 3;
struct AttnSmem64 {
  float raw[kARaw][2][kATile * 64];
  float4 kf[2][kATile / 8][8][32];
  float4 vf[2][kATile / 8][8][32];
  bool valid[2][kATile];
};

// v into the same place in block `rank` of the cluster.
__device__ __forceinline__ void put(float4* local, int rank, float4 v) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The attention of attn_kernel<64> (same problems and output): a cluster
// of 2 blocks takes 64 query rows, in 4 groups of 16; block r walks the
// key tiles r, r + 2, ... (32 keys each), and the 2 warps of a group take
// 16 keys of every tile each, with an online softmax of their own. The
// four partials of a group (2 warps x 2 blocks) merge in block 0 in a
// fixed order, block 1's pushed through distributed shared memory.
__global__ void __launch_bounds__(kAThreads, 2) attn_kernel(AttnArgs a) {
  constexpr int DH = 64, kSteps = DH / 8;
  extern __shared__ float4 attn64_smem4[];
  auto& sm = *reinterpret_cast<AttnSmem64*>(attn64_smem4);

  wait_previous_launch();
  allow_next_launch();
  const AttnProblem P = (blockIdx.z & 1) ? a.p1 : a.p0;
  const int b = blockIdx.z >> 1, h = blockIdx.y;
  const int row0 = blockIdx.x / kACluster * kARows;
  if (row0 >= P.nq) return;  // the whole cluster: this problem is shorter
  uint32_t rank_u;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank_u));
  const int rank = (int)rank_u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp % kAGroups, part = warp / kAGroups;  // part: its keys
  const int qr = row0 + grp * 16;  // the group's first row
  const bool active = qr < P.nq;
  const long long bh = (long long)b * kHeads + h;
  const float* kb = P.k + bh * P.nk * DH;
  const float* vb = P.v + bh * P.nk * DH;
  const unsigned char* mb = P.kmask ? P.kmask + (long long)b * P.nk : nullptr;
  // this block's key tiles: step i takes tile 2 i + rank
  const int n_tiles = ((P.nk + kATile - 1) / kATile - rank + 1) / kACluster;
  auto key0 = [&](int i) { return (kACluster * i + rank) * kATile; };

  auto load_tile = [&](int i) {  // an empty group past the last
    const int k0 = key0(i), buf = i % kARaw;
    for (int e = tid; e < (i < n_tiles ? kATile * DH / 4 : 0);
         e += kAThreads) {
      const int kk = e / (DH / 4), c = 4 * (e % (DH / 4)), key = k0 + kk;
      const bool in = key < P.nk;
      const long long src = (long long)(in ? key : 0) * DH + c;
      const int sw = kk * DH + 4 * ((c >> 2) ^ (kk & 7));
      cp_async16(&sm.raw[buf][0][sw], kb + src, in);
      cp_async16(&sm.raw[buf][1][sw], vb + src, in);
    }
    cp_async_commit();
  };
  // raw[i % 3] -> kf, vf, valid [i % 2]: thread tid makes fragments
  // tid + 256 j of each (lane = tid % 32: consecutive lanes, consecutive
  // float4)
  auto split_tile = [&](int i) {
    const int rb = i % kARaw, buf = i & 1;
    auto frag = [](float x, float y) {
      uint32_t xh, xl, yh, yl;
      nvs::split_tf32(x, xh, xl);
      nvs::split_tf32(y, yh, yl);
      return make_float4(__uint_as_float(xh), __uint_as_float(yh),
                         __uint_as_float(xl), __uint_as_float(yl));
    };
    auto at = [](int key, int col) {  // the swizzled place of (key, col)
      return key * DH + 4 * ((col >> 2) ^ (key & 7)) + (col & 3);
    };
    const float* rk = sm.raw[rb][0];
    const float* rv = sm.raw[rb][1];
    float4* kf = &sm.kf[buf][0][0][0];
    float4* vf = &sm.vf[buf][0][0][0];
#pragma unroll
    for (int j = 0; j < kATile * 8 * 4 / kAThreads; ++j) {
      const int f = tid + kAThreads * j;  // [chunk][k-step | n-tile][lane]
      const int c = f >> 8, st = (f >> 5) & 7, fg = (f >> 2) & 7, ft = f & 3;
      const int kk = 8 * c + fg, vk = 8 * c + 2 * ft;
      kf[f] = frag(rk[at(kk, 8 * st + ft)], rk[at(kk, 8 * st + ft + 4)]);
      vf[f] = frag(rv[at(vk, 8 * st + fg)], rv[at(vk + 1, 8 * st + fg)]);
    }
    if (tid < kATile) {
      const int key = key0(i) + tid;
      sm.valid[buf][tid] = key < P.nk && (mb == nullptr || mb[key]);
    }
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
      nvs::split_tf32(v, qh[ks][i], ql[ks][i]);
    }
  const float neg_inf = -__int_as_float(0x7f800000);
  float o[kSteps][4] = {}, m[2] = {neg_inf, neg_inf};
  float l[2] = {0.f, 0.f};

  for (int i = 0; i < kARaw; ++i) load_tile(i);
  cp_async_wait<kARaw - 1>();
  __syncthreads();
  if (n_tiles > 0) split_tile(0);
  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    cp_async_wait<kARaw - 2>();  // step i + 1's tile has landed
    __syncthreads();             // and step i's fragments are written
    // raw[i % 3] was split at the previous step, fragments [buf ^ 1] read
    load_tile(i + kARaw);
    if (i + 1 < n_tiles) split_tile(i + 1);
    if (!active) continue;
    const bool* valid = sm.valid[buf] + 8 * kAChunks * part;
    // q k^T of the warp's 16 keys (the two chunks' chains interleave)
    float s[kAChunks][4] = {};
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int ch = 0; ch < kAChunks; ++ch) {
        const float4 f = sm.kf[buf][kAChunks * part + ch][ks][lane];
        const uint32_t fh[2] = {__float_as_uint(f.x), __float_as_uint(f.y)};
        const uint32_t fl[2] = {__float_as_uint(f.z), __float_as_uint(f.w)};
        nvs::mma_3xtf32(s[ch], qh[ks], ql[ks], fh, fl);
      }
#pragma unroll
    for (int ch = 0; ch < kAChunks; ++ch)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!valid[8 * ch + 2 * t + (e & 1)]) s[ch][e] = neg_inf;
    // online softmax of rows g (values 0, 1) and g + 8 (values 2, 3); the
    // context is rescaled only when a row's maximum moved (alpha != 1)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = m[r];
#pragma unroll
      for (int ch = 0; ch < kAChunks; ++ch)
        mt = fmaxf(mt, fmaxf(s[ch][2 * r], s[ch][2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      alpha[r] = mt == neg_inf ? 1.f : exp2f(m[r] - mt);
      m[r] = mt;
      l[r] *= alpha[r];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nt = 0; nt < kSteps; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int ch = 0; ch < kAChunks; ++ch) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mr = m[e >> 1];  // -inf: no valid key yet, p = 0
        p[e] = mr == neg_inf ? 0.f : exp2f(s[ch][e] - mr);
      }
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      uint32_t ph[4], pl[4];  // k-index t: key 2t; t + 4: key 2t + 1
      nvs::split_tf32(p[0], ph[0], pl[0]);
      nvs::split_tf32(p[2], ph[1], pl[1]);
      nvs::split_tf32(p[1], ph[2], pl[2]);
      nvs::split_tf32(p[3], ph[3], pl[3]);
      const float4* vf = &sm.vf[buf][kAChunks * part + ch][0][lane];
#pragma unroll
      for (int nt = 0; nt < kSteps; ++nt) {
        const float4 f = vf[nt * 32];
        const uint32_t fh[2] = {__float_as_uint(f.x), __float_as_uint(f.y)};
        const uint32_t fl[2] = {__float_as_uint(f.z), __float_as_uint(f.w)};
        nvs::mma_3xtf32(o[nt], ph, pl, fh, fl);
      }
    }
  }
  cluster_sync();  // every warp of both blocks is done with the fragments

  // a group's four partials merge in block 0, in the order (block 0, part
  // 0), (0, 1), (1, 0), (1, 1): the others leave m, l and context in block
  // 0's fragment space, block 1's through distributed shared memory
  constexpr int kPart = 4 + 4 * kSteps;  // m, l of two rows; o: 9 float4
  constexpr int kSrc = kACluster * kAParts - 1;
  float4* parts = &sm.kf[0][0][0][0];
  static_assert(kAGroups * kSrc * 32 * kPart * sizeof(float) <=
                    sizeof(sm.kf) + sizeof(sm.vf),
                "the merge fits in the fragments' space");
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int src = rank * kAParts + part;  // 0: the merging warp
  if (src > 0) {
    float4* mine = parts + ((grp * kSrc + src - 1) * 32 + lane) * (kPart / 4);
    const float4 ml = make_float4(m[0], m[1], l[0], l[1]);
    if (rank == 0) {
      mine[0] = ml;
#pragma unroll
      for (int nt = 0; nt < kSteps; ++nt)
        mine[1 + nt] = make_float4(o[nt][0], o[nt][1], o[nt][2], o[nt][3]);
    } else {
      put(mine, 0, ml);
#pragma unroll
      for (int nt = 0; nt < kSteps; ++nt)
        put(mine + 1 + nt, 0,
            make_float4(o[nt][0], o[nt][1], o[nt][2], o[nt][3]));
    }
  }
  cluster_sync();
  if (src > 0 || !active) return;
  // part q's m, l: other[q * 32 * 9]; its context from + 1
  const float4* other = parts + (grp * kSrc * 32 + lane) * (kPart / 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + g + 8 * r;
    float mm = m[r];
#pragma unroll
    for (int q = 0; q < kSrc; ++q) {
      const float4 ml = other[q * 32 * (kPart / 4)];
      mm = fmaxf(mm, r ? ml.y : ml.x);
    }
    float f[kSrc + 1];
    f[0] = m[r] == neg_inf ? 0.f : exp2f(m[r] - mm);
    float lr = l[r] * f[0];
#pragma unroll
    for (int q = 0; q < kSrc; ++q) {
      const float4 ml = other[q * 32 * (kPart / 4)];
      const float mq = r ? ml.y : ml.x;
      f[q + 1] = mq == neg_inf ? 0.f : exp2f(mq - mm);
      lr += (r ? ml.w : ml.z) * f[q + 1];
    }
    if (row >= P.nq) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;  // no valid key: zero
    float* out = P.ctx + ((long long)b * P.nq + row) * (kHeads * DH) +
                 h * DH + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kSteps; ++nt) {
      float v0 = o[nt][2 * r] * f[0], v1 = o[nt][2 * r + 1] * f[0];
#pragma unroll
      for (int q = 0; q < kSrc; ++q) {
        const float4 oq = other[q * 32 * (kPart / 4) + 1 + nt];
        v0 += (r ? oq.z : oq.x) * f[q + 1];
        v1 += (r ? oq.w : oq.y) * f[q + 1];
      }
      *reinterpret_cast<float2*>(out + 8 * nt) =
          make_float2(v0 * inv, v1 * inv);
    }
  }
}

}  // namespace d256

// ------------------------------------------------------------------- host

// The row stage of width D <= 64: its kernel, threads, rows a block and
// dynamic shared memory.
template <int D, bool kFfn, int T>
struct RowStage {
  static constexpr int kThreads = kRowThreads;
  static constexpr int kRows = kRowRows;
  static constexpr size_t kSmem =
      sizeof(float) * ((kFfn ? ffn_weights<D>() : 0) + proj_weights<D, T>() +
                       kRowThreads / 32 * kRowsPerWarp * 5 * D);
  static void (*kernel())(RowArgs) { return row_kernel<D, kFfn, T>; }
  static cudaError_t set_smem() {
    return cudaFuncSetAttribute(kernel(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmem);
  }
};

// Raises the dynamic shared-memory limits of the D-wide kernels once per
// device.
template <int D>
cudaError_t set_smem_limits() {
  return nvs::once_per_device([] {
    cudaError_t err = RowStage<D, false, 3>::set_smem();
    if (err == cudaSuccess) err = RowStage<D, true, 2>::set_smem();
    if (err == cudaSuccess) err = RowStage<D, true, 3>::set_smem();
    if (err == cudaSuccess) err = RowStage<D, true, 0>::set_smem();
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_kernel<D / kHeads>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sizeof(AttnSmem<D / kHeads>));
    return err;
  });
}

// Enqueues kernel<<<grid, block, smem, stream>>>(args), with programmatic
// stream serialisation if pdl: it may then start while the previous kernel
// drains; as clusters of `cluster` blocks along x if cluster > 1.
template <typename Args>
cudaError_t launch(void (*kernel)(Args), dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, bool pdl, const Args& args,
                   int cluster = 1) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
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
  const dim3 attn_grid(((M > N ? M : N) + kQRows - 1) / kQRows, kHeads,
                       2 * B);
  const float scale_log2 = kLog2e / sqrtf((float)DH);
  auto layer = [&](int l) { return packed + l * layer_stride; };
  constexpr size_t kAttnSmem = sizeof(AttnSmem<DH>);
  auto row = [&](auto stage, bool dep, const RowArgs& args) {
    using S = decltype(stage);
    return launch(S::kernel(), dim3((rows + S::kRows - 1) / S::kRows),
                  S::kThreads, S::kSmem, stream, dep, args);
  };

  err = row(RowStage<D, false, 3>{}, false,
            RowArgs{x0, x1, nullptr, nullptr, nullptr, nullptr, nullptr,
                    layer(l_begin), cs0, sn0, cs1, sn1, qkv0, qkv1, B, M, N});
  const float* cur0 = x0;
  const float* cur1 = x1;
  for (int l = l_begin; l < l_end && err == cudaSuccess; ++l) {
    const float* w_cross = layer(l) + kBlock;
    err = launch(attn_kernel<DH>, attn_grid, kAttnThreads, kAttnSmem,
                 stream, pdl,
                 AttnArgs{{qkv0, qkv0 + s0, qkv0 + 2 * s0, mask0, ctx0, M, M},
                          {qkv1, qkv1 + s1, qkv1 + 2 * s1, mask1, ctx1, N, N},
                          scale_log2});
    if (err != cudaSuccess) break;
    // self FFN into o0/o1, then the cross projection: qk into the q slot,
    // v into the v slot
    err = row(RowStage<D, true, 2>{}, pdl,
              RowArgs{cur0, cur1, ctx0, ctx1, o0, o1, layer(l) + kSelf,
                      w_cross, nullptr, nullptr, nullptr, nullptr, qkv0, qkv1,
                      B, M, N});
    if (err != cudaSuccess) break;
    cur0 = o0;
    cur1 = o1;
    err = launch(attn_kernel<DH>, attn_grid, kAttnThreads, kAttnSmem,
                 stream, pdl,
                 AttnArgs{{qkv0, qkv1, qkv1 + 2 * s1, mask1, ctx0, M, N},
                          {qkv1, qkv0, qkv0 + 2 * s0, mask0, ctx1, N, M},
                          scale_log2});
    if (err != cudaSuccess) break;
    // cross FFN in place, then the next layer's self projection
    const RowArgs ffn{o0, o1, ctx0, ctx1, o0, o1, w_cross + kCross,
                      l + 1 < l_end ? layer(l + 1) : nullptr, cs0, sn0, cs1,
                      sn1, qkv0, qkv1, B, M, N};
    err = l + 1 < l_end ? row(RowStage<D, true, 3>{}, pdl, ffn)
                        : row(RowStage<D, true, 0>{}, pdl, ffn);
  }
  return err;
}

// ------------------------------------------------------- host, D = 256

namespace d256 {

// Calls of kTiledRows rows (B (M + N)) or more run the row stage on
// row_tiled_kernel, fewer on the clusters of row_kernel (see the file's
// head: the cut is the midpoint of the two measured shapes).
constexpr int kTiledRows = 1536;

// The launch geometry of row_kernel.
struct Plan {
  static constexpr int kCluster = Tile::CL;
  static constexpr int kThreads = Tile::kThreads;
  static constexpr size_t kSmem = sizeof(Smem);
  static int grid(int rows) { return (rows + RT - 1) / RT * kCluster; }
};
constexpr size_t kAttnSmem = sizeof(AttnSmem64);

cudaError_t set_smem_limits() {
  return nvs::once_per_device([] {
    const int smem = (int)Plan::kSmem;
    cudaError_t err = cudaSuccess;
    void (*const kernels[])(Args) = {row_kernel<false, 3>, row_kernel<true, 2>,
                                     row_kernel<true, 3>, row_kernel<true, 0>};
    for (auto k : kernels)
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    void (*const tiled[])(RowArgs) = {
        row_tiled_kernel<false, 3>, row_tiled_kernel<true, 2>,
        row_tiled_kernel<true, 3>, row_tiled_kernel<true, 0>};
    const size_t tiled_smem[] = {sizeof(TiledSmem<false>),
                                 sizeof(TiledSmem<true>),
                                 sizeof(TiledSmem<true>),
                                 sizeof(TiledSmem<true>)};
    for (int i = 0; i < 4 && err == cudaSuccess; ++i)
      err = cudaFuncSetAttribute(tiled[i],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)tiled_smem[i]);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kAttnSmem);
    return err;
  });
}

// run_layers<256>'s plan with the D = 256 kernels: the same launches, the
// row stages as clusters reading the weights' fragments (split, (L, 38
// D^2) floats from split_weights_kernel), or, from kTiledRows rows on, as
// row_tiled_kernel reading the packed weights.
cudaError_t run_layers(int l_begin, int l_end, const float* x0,
                       const float* x1, float* o0, float* o1,
                       const float* cs0, const float* sn0, const float* cs1,
                       const float* sn1, const unsigned char* mask0,
                       const unsigned char* mask1, const float* packed,
                       const float4* split, float* scratch,
                       long long layer_stride, int B, int M, int N, bool pdl,
                       cudaStream_t stream) {
  constexpr int kSelf = 3 * D * D + 3 * D;
  constexpr int kCross = 2 * D * D + 2 * D;
  constexpr int kBlock = kSelf + ffn_weights<D>();
  // a layer's fragments (float4): self proj, self wo, ..., cross proj at
  // 5 D^2, cross wo at 6 D^2
  constexpr long long kF4 = 19LL * D * D / 2;
  const int rows = B * (M + N);
  const bool tiled = rows >= kTiledRows;
  if (!tiled && split == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits();
  if (err != cudaSuccess) return err;
  const long long s0 = (long long)B * M * D, s1 = (long long)B * N * D;
  float* qkv0 = scratch;
  float* ctx0 = scratch + 3 * s0;
  float* qkv1 = scratch + 4 * s0;
  float* ctx1 = qkv1 + 3 * s1;
  const dim3 row_grid(Plan::grid(rows));
  const dim3 attn_grid(((M > N ? M : N) + kARows - 1) / kARows * kACluster,
                       kHeads, 2 * B);
  const float scale_log2 = kLog2e / sqrtf((float)DH);
  auto layer = [&](int l) { return packed + l * layer_stride; };
  // layer l's fragments from float4 `at` on (none for row_tiled_kernel)
  auto frags = [&](int l, long long at) -> const float4* {
    return split ? split + l * kF4 + at : nullptr;
  };
  // row(ffn, t, ...): the row stage <kFfn, T> of either kind
  auto row = [&](auto ffn, auto t, bool dep, const Args& args) {
    constexpr bool kFfn = decltype(ffn)::value;
    constexpr int T = decltype(t)::value;
    if (tiled)
      return launch(row_tiled_kernel<kFfn, T>,
                    dim3((rows + kTileRows - 1) / kTileRows), kTileThreads,
                    sizeof(TiledSmem<kFfn>), stream, dep, args.r);
    return launch(row_kernel<kFfn, T>, row_grid, Plan::kThreads,
                  Plan::kSmem, stream, dep, args, Plan::kCluster);
  };
  using Ffn = std::true_type;
  using Proj = std::false_type;
  using T0 = std::integral_constant<int, 0>;
  using T2 = std::integral_constant<int, 2>;
  using T3 = std::integral_constant<int, 3>;

  err = row(Proj{}, T3{}, false,
            Args{RowArgs{x0, x1, nullptr, nullptr, nullptr, nullptr, nullptr,
                         layer(l_begin), cs0, sn0, cs1, sn1, qkv0, qkv1, B,
                         M, N},
                 nullptr, frags(l_begin, 0)});
  const float* cur0 = x0;
  const float* cur1 = x1;
  for (int l = l_begin; l < l_end && err == cudaSuccess; ++l) {
    const float* w_cross = layer(l) + kBlock;
    err = launch(attn_kernel, attn_grid, kAThreads, kAttnSmem, stream, pdl,
                 AttnArgs{{qkv0, qkv0 + s0, qkv0 + 2 * s0, mask0, ctx0, M, M},
                          {qkv1, qkv1 + s1, qkv1 + 2 * s1, mask1, ctx1, N, N},
                          scale_log2},
                 kACluster);
    if (err != cudaSuccess) break;
    err = row(Ffn{}, T2{}, pdl,
              Args{RowArgs{cur0, cur1, ctx0, ctx1, o0, o1, layer(l) + kSelf,
                           w_cross, nullptr, nullptr, nullptr, nullptr, qkv0,
                           qkv1, B, M, N},
                   frags(l, 3LL * D * D / 2), frags(l, 5LL * D * D)});
    if (err != cudaSuccess) break;
    cur0 = o0;
    cur1 = o1;
    err = launch(attn_kernel, attn_grid, kAThreads, kAttnSmem, stream, pdl,
                 AttnArgs{{qkv0, qkv1, qkv1 + 2 * s1, mask1, ctx0, M, N},
                          {qkv1, qkv0, qkv0 + 2 * s0, mask0, ctx1, N, M},
                          scale_log2},
                 kACluster);
    if (err != cudaSuccess) break;
    const bool next = l + 1 < l_end;
    const Args ffn{RowArgs{o0, o1, ctx0, ctx1, o0, o1, w_cross + kCross,
                           next ? layer(l + 1) : nullptr, cs0, sn0, cs1, sn1,
                           qkv0, qkv1, B, M, N},
                   frags(l, 6LL * D * D), next ? frags(l + 1, 0) : nullptr};
    err = next ? row(Ffn{}, T3{}, pdl, ffn) : row(Ffn{}, T0{}, pdl, ffn);
  }
  return err;
}

}  // namespace d256

}  // namespace

// Layers [l_begin, l_end) of the stack. x0 (B,M,D), x1 (B,N,D) in; o0, o1
// out (the same shapes, distinct from the inputs); cs/sn (B,n,DH/2); masks
// (B,n) bytes or null; packed (L, layer_stride) floats; split (D = 256
// only, else unused): the weights' fragments from nvs_lightglue_split,
// (L, 38 D^2) floats, which row_kernel reads (below kTiledRows rows; null
// is refused there, taken from there on); scratch 4*B*(M+N)*D floats. All
// contiguous. D in {32, 64, 256}, 4 heads. pdl 0 turns programmatic
// dependent launch off for the whole call (same results), so that a
// profiler's per-kernel durations do not overlap. Returns the first
// cudaError_t of the launches.
extern "C" int nvs_lightglue_layers(
    int l_begin, int l_end, const float* x0, const float* x1, float* o0,
    float* o1, const float* cs0, const float* sn0, const float* cs1,
    const float* sn1, const unsigned char* mask0,
    const unsigned char* mask1, const float* packed, const float* split,
    float* scratch, long long layer_stride, int B, int M, int N, int D,
    int pdl, cudaStream_t stream) {
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
    case 256:
      return (int)d256::run_layers(l_begin, l_end, x0, x1, o0, o1, cs0, sn0,
                                   cs1, sn1, mask0, mask1, packed,
                                   reinterpret_cast<const float4*>(split),
                                   scratch, layer_stride, B, M, N, pdl != 0,
                                   stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The D = 256 weights' fragments: split (L, 38 D^2) floats, 16-byte
// aligned, from packed (L, layer_stride). One launch.
extern "C" int nvs_lightglue_split(const float* packed, float* split,
                                   long long layer_stride, int L, int D,
                                   cudaStream_t stream) {
  if (D != d256::D || L < 1) return (int)cudaErrorInvalidValue;
  const long long n = 19LL * D * D / 2 * L;
  d256::split_weights_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                               stream>>>(packed, layer_stride,
                                         reinterpret_cast<float4*>(split), L);
  return (int)cudaGetLastError();
}

// The D = 256 launch plan at (B, M, N), as the card takes it: out[0..5]
// the row stage's grid (blocks), cluster, threads, dynamic shared memory
// (bytes) and the clusters of row_kernel the card can hold at once
// (cudaOccupancyMaxActiveClusters); out[5..10] the attention's grid x, y,
// z, threads, shared memory; out[10] its blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); out[11] 1 where the
// row stage is row_tiled_kernel.
extern "C" int nvs_lightglue_plan(int B, int M, int N, long long* out) {
  using d256::Plan;
  cudaError_t err = d256::set_smem_limits();
  if (err != cudaSuccess) return (int)err;
  const int rows = B * (M + N);
  const bool tiled = rows >= d256::kTiledRows;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Plan::kCluster;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Plan::grid(rows));
  cfg.blockDim = dim3(Plan::kThreads);
  cfg.dynamicSmemBytes = Plan::kSmem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0, blocks = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, d256::row_kernel<true, 3>,
                                       &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, d256::attn_kernel, d256::kAThreads, d256::kAttnSmem);
  if (err != cudaSuccess) return (int)err;
  const long long v[12] = {
      tiled ? (rows + kTileRows - 1) / kTileRows : Plan::grid(rows),
      tiled ? 1 : Plan::kCluster,
      tiled ? kTileThreads : Plan::kThreads,
      (long long)(tiled ? sizeof(TiledSmem<true>) : Plan::kSmem),
      clusters,
      ((M > N ? M : N) + d256::kARows - 1) / d256::kARows * d256::kACluster,
      kHeads,
      2 * B,
      d256::kAThreads,
      (long long)d256::kAttnSmem,
      blocks,
      tiled};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}
