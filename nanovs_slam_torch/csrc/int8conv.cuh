// Int8 3x3 convolution (stride 1, SAME) with folded BatchNorm and
// (Leaky)ReLU: the conv block of int8 serving. The kernel and its launch
// plan; int8conv.cu holds the C interface and the float32 blocks'
// instances, int8conv_bf16.cu the bfloat16 blocks'.
//
// It replaces no Pallas kernel. Its JAX counterpart is XLA's int8
// convolution in nanovs_slam_tpu/quant.py::int8_conv
// (lax.conv_general_dilated on int8 with int32 results), which PyTorch
// lacks on CUDA. The function is kernels/int8conv.py's (its plain twin
// int8_conv3x3_plain): codes q = clip(rint(x / s_in), -127, 127) of a
// float32 or bfloat16 map (an IEEE division of the float32 value, as the
// JAX package divides), int32 sums over 3x3 taps and channels, then
// (float(acc) * m) * a + b and the activation in float32, each product and
// sum rounded on its own (no fused multiply-add), so that the kernel and
// the twin agree bit for bit; in a bfloat16 block (the kernel's TX) the
// affine is rounded to bf16 and the activation's product too, as a bf16
// block rounds; out the block's type (float32 or bf16) NCHW, or codes of
// that value at the consumer's scale as int8 NHWC, 2x2 max-pooled (floor)
// for a chained pool. A block reads a map of its own type, or int8 codes.
//
// Bound: at config S's and N's widths (Cin 3..96, Cout 16..128) the int8
// products need ~10-170 operations a byte moved, below the H100's ~590
// int8 operations a byte, so bytes bound it. Two designs, one chosen a
// call by shape (dispatch, kStripMinQuarters):
//  - tiles, for the latency-bound calls of under 3/4 of a wave of
//    strips (the S8 request at batch 1, its 60x80 and 30x40 maps at batch
//    8): what bounds them is a block's chain of copies, quantisation,
//    products and epilogue, and how many such chains an SM keeps in flight;
//  - strips, for calls with strips for at least 3/4 of the pipes the card
//    holds (config N at batch 128, the JAX package's int8 deployment
//    config; S8 batch 8's 240x320 and 120x160 maps): there the tiles' cost
//    is their halo (a 16-pixel tile reads 2x its columns and 1.5x its rows
//    from L2 and quantises them again), one item in flight, channels
//    padded to the warp's width and half-sector bf16 stores. Measured on an
//    NVIDIA H100 80GB HBM3 at 700 W (tools/int8_variants.py): N28's 23 bf16
//    calls at batch 128 summed 10.8-10.9 ms on tiles against 6.3 ms on
//    strips, each of them faster as strips; at S8 batch 1 every call is
//    1.2-4.7x slower as strips (a few strips for 264 pipes).
//
// Tiles: an implicit GEMM with M = pixels, N = Cout, K = 9 Cin in (tap,
// channel) order zero-padded to a multiple of 32.
//  - Work: a tile is TH rows by 16 pixels. TH = 8 (a warp a row and all of
//    up to 64 channels) for at most 32 channels, and where many tiles make
//    fewer rounds of 8-row tiles pay for their larger halo; else TH = 4 (a
//    row two warps, half the channels each, up to 256; grid.y splits more):
//    a 60x80 map at batch 1 is 75 tiles on 75 SMs. Blocks of 8 warps are
//    persistent: as many as the card holds, each with the same number of
//    tiles, block b taking tiles b, b + grid, ...
//  - Input: the next item is copied with cp.async while the current one is
//    quantised or multiplied. Int8 NHWC codes go straight into a ring of two
//    halo tiles (16-byte copies where Cin % 16 == 0, else 4-byte ones, or
//    plain loads for Cin % 4 != 0). A float NCHW map goes a channel plane's
//    halo rows at a time into a ring of two staged chunks, in its own type
//    (TX, the block's: float32 or bf16): the 16-byte-aligned span of 16 B
//    before x0 to 16 B after the tile (x0 - 4 .. x0 + 19 in float32, x0 - 8
//    .. x0 + 23 in bf16) where W is a multiple of a piece (4 or 8 values),
//    else the 18 values one by one (4-byte copies in float32, plain loads in
//    bf16); zero-filled outside the frame (the SAME padding). A chunk is 64
//    channels where every SM has at most one tile, else 32, or 16 or 8
//    where that lets two blocks share an SM. The block quantises each chunk
//    from shared memory into the halo tile (a bf16 value widened to float32
//    exactly), four channels a thread and word.
//  - Codes: quantize() gives clip(rint(x / s)) of the IEEE quotient, from
//    the product with 1 / s where that provably rounds alike, else from
//    __fdiv_rn (about 1 value in 20,000, near a half-integer).
//  - Weights: copied once a block into shared memory (for all its tiles)
//    through L1: every block of a call reads the same lines, which through
//    L2 alone queued behind one another. Each 16-byte piece of K lands so
//    that a warp's B fragments fall on 32 banks. Where they do not fit
//    beside the input ring (Cin 256 at Cout 256) each tile streams them in
//    K chunks through a ring of two.
//  - Products: A built from the halo tile through a table of tap offsets
//    (conv1a's Cin = 3 gathers it byte by byte), B the weights in shared
//    memory, whose layout is wgmma's K-major core-matrix layout. Where a
//    warp has 64 or more channels, Hopper's wgmma (m64nNk32 s32.s8.s8, a
//    warpgroup's 4 rows, A from registers, B through a matrix descriptor);
//    below that mma.sync m16n8k32, which measured faster there
//    (tools/int8_variants.py times both at every instance).
//  - Epilogue: float32 or bf16 straight from the accumulators (4 full
//    32-byte sectors a warp store in float32), or the codes staged in
//    shared memory and
//    written as NHWC words, four codes pooled with __vmaxs4 first. Halo
//    pixels are padded to 16 bytes times an odd number, which keeps the
//    fragment loads free of bank conflicts.
//
// Strips: the same GEMM with K = the 9 G (tap, 16-channel group) items in
// pairs (G = ceil(Cin / 16)), N = Cout exactly (16..128: wgmma's widths).
//  - Work: a strip is R rows (8, 4 or 2, the most that fits) by TW columns
//    (W up to 320, else equal column tiles; half that where it buys 4 rows
//    instead of 2) of one image. A block is two
//    pipes sharing the weights (resident, copied once by cp.async), each a
//    producer warp and one or two consumer warpgroups (two up to N = 96);
//    persistent blocks, one an SM; each pipe walks a contiguous range of
//    strips down its column tile.
//  - Input: the producer warp bulk-copies (TMA, cp.async.bulk) the rows of
//    a strip's next chunks into a ring of 2-4 stages, an mbarrier a stage:
//    a float map's CC (16 or 8) channel planes' rows (whole W rows at
//    full width, else the tile plus 16 bytes a side), or int8 NHWC rows.
//    Rows and columns outside the frame are not copied; the consumers
//    write their zero codes (the SAME padding).
//  - Codes: the consumers quantise each chunk once (8 values a thread,
//    branch-free; quantize() for a value near a half-integer) into code
//    planes [group][pixel][16 bytes] with a row pitch P = TW + 8. A strip
//    below the last one keeps its two shared code rows (moved up) and
//    converts only its R new rows.
//  - Products: pixel m of a strip (row m / P, column m % P) under tap (dy,
//    dx) reads code pixel m + dy P + dx, so a tap's A operand for 64
//    pixels is the plane shifted: a K-major no-swizzle descriptor (8-pixel
//    core matrices 128 bytes apart, the pair's second item LBO above its
//    first). wgmma m64nNk32 s32.s8.s8 with A and B from shared memory.
//    Columns P - 8 .. P - 1 of a row are computed and dropped.
//  - Epilogue: a warpgroup's m-blocks alternate with its partner's, one's
//    epilogue under the other's products. Float out staged [channel][64
//    pixels] and stored as 16-byte pieces along W (8 lanes a channel's 64
//    pixels); codes staged for the strip, then each row's pixels as
//    16-byte pieces (or pooled words).
#pragma once

#include <cmath>
#include <numeric>
#include <type_traits>

#include "common.cuh"

namespace nvs_int8 {

constexpr int kTW = 16, kWT = kTW + 2;  // tile and halo columns
constexpr int kThreads = 256;  // 8 warps
using bf16 = __nv_bfloat16;

// a staged row of a float map of type TX: a 16-byte piece of kPer values
// before the tile's kTW, and one after, x0 - kPer .. x0 + kTW + kPer - 1;
// halo column j (x0 - 1 + j) at kPer - 1 + j
template <typename TX>
struct Stage {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(TX));
  static constexpr int kSW = kTW + 2 * kPer;
};

// an output tile of TH rows (a warp a row; two warps a row, each half the
// channels, where TH = 4) by kTW pixels, and its halo
template <int TH>
struct Tile {
  static constexpr int HT = TH + 2;         // halo rows
  static constexpr int HPix = HT * kWT;     // halo pixels
  static constexpr int Halves = 8 / TH;     // warps a row
  template <typename TX>  // values a staged channel
  static constexpr int StageCh = HT * Stage<TX>::kSW;
};
constexpr int kRing = 2;  // input items in shared memory: 1 in flight
constexpr int kSmemMax = 227 * 1024;
constexpr int kFloatOut = 0, kInt8Out = 1;  // 2: int8, 2x2 max-pooled
enum : int { kCopySync = 0, kCopy4 = 1, kCopy16 = 2 };
enum : int { kXF32 = 0, kXInt8 = 1, kXBF16 = 2 };  // input types

struct Params {
  const void* x;
  const int8_t* w;  // (Cout, Kpad)
  const float* m;
  const float* a;
  const float* b;
  void* out;
  int x_int8, out_mode;
  int B, H, W, Cin, Cout, K, Kpad;
  int NB;     // output channels a block (8 NT 8 / TH), Cout zero-padded
  int PS;     // halo tile: bytes a pixel
  int copy;   // kCopy16 / kCopy4 / kCopySync: how the input is copied
  int CC;     // float input: channels staged an item
  int nch;    // ... items (chunks) a tile
  int KC;     // k of the weights in shared memory at a time (Kpad: all)
  int tiles_x, tiles_y, ntiles;
  int tile_bytes;                                   // a halo tile
  int off_stage, off_w, off_mab, off_offs, off_ep;  // shared memory (bytes)
  int smem;
  float scale_in, out_scale, slope;
  float rcp_in, rcp_out;  // 1 / scale, or 0 where a scale is not normal
};

// The kernel and its launch plan have internal linkage: each translation
// unit compiles its own instances, and no static of one library (say, the
// record of which kernels had their shared-memory limit raised) is shared
// with another library built from these sources in the same process.
namespace {

// clip(rint(v / s), -127, 127) with the IEEE quotient v / s. The product
// y = v * r with r = 1 / s (both rounded) is within 1.8e-7 |y| of the
// rounded quotient, so where |y| >= 128 (the code is +-127) or y lies more
// than 3e-5 from a half-integer (|y| < 128), rint(y) is its code; the rest
// (about 1 in 20,000 values, NaN included) take the division itself. r = 0
// (s not normal) always divides.
__device__ __forceinline__ int8_t quantize(float v, float s, float r) {
  float q;
  const float y = __fmul_rn(v, r);
  if (r != 0.f && fabsf(y) >= 128.f) {
    q = y;
  } else if (r != 0.f && fabsf(__fsub_rn(y, floorf(y)) - 0.5f) > 3e-5f) {
    q = rintf(y);
  } else {
    q = rintf(__fdiv_rn(v, s));
  }
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// quantize()'s code where the product with r rounds as the quotient,
// without a branch; clears `exact` where it may not (within 3e-5 of a
// half-integer, NaN, r = 0: quantize() then decides)
__device__ __forceinline__ int quantize_fast(float v, float r, bool& exact) {
  const float y = __fmul_rn(v, r);
  const bool big = fabsf(y) >= 128.f;
  exact = exact && r != 0.f &&
          (big || fabsf(__fsub_rn(y, floorf(y)) - 0.5f) > 3e-5f);
  return static_cast<int>(fminf(fmaxf(big ? y : rintf(y), -127.f), 127.f));
}

// the low bytes of four codes, a's lowest
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b, one m16n8k32 int8 product with int32 sums: a 16x32 (row), b
// 32x8 (col), four int8 a register with the lower k in the low byte. With
// g = lane / 4 and t = lane % 4: a = {(g, 4t..4t+3), (g+8, 4t..4t+3),
// (g, 16+4t..), (g+8, 16+4t..)}, b = {(4t..4t+3, g), (16+4t.., g)}, d =
// {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct TileAt {
  int img, y0, x0;
};

template <int TH>
__device__ __forceinline__ TileAt tile_at(const Params& p, int tile) {
  const int r = tile / p.tiles_x;
  return {r / p.tiles_y, r % p.tiles_y * TH, tile % p.tiles_x * kTW};
}

// k0 .. k1 of the weights of the block's NB channels (from n0) -> shared
// memory through L1 (the blocks of an SM share the lines, which every block
// of the call reads): the 16-byte piece j of channel n at j * 16 NB + n * 16,
// so that a warp's B fragments (its 8 channels' 4 bytes at lane t) fall on
// 32 banks; channels >= Cout are zeros
template <int NB>
__device__ void copy_weights(const Params& p, int8_t* dst, int n0, int k0,
                             int k1) {
  const int nj = (k1 - k0) / 16;
  for (int i = threadIdx.x; i < NB * nj; i += kThreads) {
    const int n = i / nj, j = i % nj;
    const bool in = n0 + n < p.Cout;
    const int8_t* src =
        p.w + (in ? static_cast<size_t>(n0 + n) * p.Kpad + k0 + 16 * j : 0);
    nvs::cp_async16_ca(dst + j * 16 * NB + n * 16, src, in);
  }
}

// a tile's input, zeros outside the frame: a float map's channels c0 ..
// c0 + cc - 1 as halo rows into the staging buffer sb ([channel][row][kSW],
// column j at x0 - kPer + j), or the int8 codes into the halo tile tb
// ([pixel][PS])
template <typename TX, int TH>
__device__ void copy_input(const Params& p, int tile, int c0, int cc, TX* sb,
                           int8_t* tb) {
  constexpr int kHT = Tile<TH>::HT, kHPix = Tile<TH>::HPix;
  constexpr int kPer = Stage<TX>::kPer, kSW = Stage<TX>::kSW;
  const TileAt at = tile_at<TH>(p, tile);
  if (!p.x_int8) {
    const TX* xf = static_cast<const TX*>(p.x) +
                   (static_cast<size_t>(at.img) * p.Cin + c0) * p.H * p.W;
    if (p.copy == kCopy16) {
      constexpr int kPieces = kSW / kPer;
      for (int i = threadIdx.x; i < cc * kHT * kPieces; i += kThreads) {
        const int k = i % kPieces, rr = i / kPieces;  // rr: channel, row
        const int gy = at.y0 - 1 + rr % kHT, gx = at.x0 - kPer + kPer * k;
        // W % kPer == 0: a piece is in the frame or out of it whole
        const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
        const TX* src =
            xf + (in ? (static_cast<size_t>(rr / kHT) * p.H + gy) * p.W + gx
                     : 0);
        nvs::cp_async16(sb + rr * kSW + kPer * k, src, in);
      }
    } else {
      for (int i = threadIdx.x; i < cc * kHT * kWT; i += kThreads) {
        const int j = i % kWT, rr = i / kWT;
        const int gy = at.y0 - 1 + rr % kHT, gx = at.x0 - 1 + j;
        const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
        const TX* src =
            xf + (in ? (static_cast<size_t>(rr / kHT) * p.H + gy) * p.W + gx
                     : 0);
        TX* dst = sb + rr * kSW + kPer - 1 + j;
        if constexpr (sizeof(TX) == 4)
          nvs::cp_async4(dst, src, in);
        else  // no cp.async of 2 bytes: a load, in shared memory by the
              // barrier that precedes its use
          *dst = in ? *src : TX(0.f);
      }
    }
    return;
  }
  const int8_t* xq = static_cast<const int8_t*>(p.x);
  const int per = p.copy == kCopy16 ? p.Cin / 16
                  : p.copy == kCopy4 ? p.Cin / 4 : p.Cin;
  for (int i = threadIdx.x; i < kHPix * per; i += kThreads) {
    const int q = i / per, c = i % per;
    const int gy = at.y0 - 1 + q / kWT, gx = at.x0 - 1 + q % kWT;
    const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    const size_t src =
        in ? ((static_cast<size_t>(at.img) * p.H + gy) * p.W + gx) * p.Cin : 0;
    if (p.copy == kCopy16)
      nvs::cp_async16(tb + q * p.PS + 16 * c, xq + src + 16 * c, in);
    else if (p.copy == kCopy4)
      nvs::cp_async4(tb + q * p.PS + 4 * c, xq + src + 4 * c, in);
    else
      tb[q * p.PS + c] = in ? xq[src + c] : int8_t(0);
  }
}

// the staged channels c0 .. c0 + cc - 1 -> codes in the halo tile
template <typename TX, bool VEC, int TH>
__device__ void quantize_input(const Params& p, const TX* sb, int8_t* tb,
                               int c0, int cc) {
  constexpr int kHT = Tile<TH>::HT, kHPix = Tile<TH>::HPix;
  constexpr int kStageCh = Tile<TH>::template StageCh<TX>;
  constexpr int kSW = Stage<TX>::kSW, kCol = Stage<TX>::kPer - 1;
  if (VEC) {  // cc % 4 == 0: four channels a thread, one word
    for (int i = threadIdx.x; i < cc / 4 * kHPix; i += kThreads) {
      const int q = i % kHPix, c4 = i / kHPix;
      const TX* s = sb + (4 * c4 * kHT + q / kWT) * kSW + q % kWT + kCol;
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v |= uint32_t(uint8_t(quantize(nvs::to_f32(s[j * kStageCh]),
                                       p.scale_in, p.rcp_in)))
             << (8 * j);
      *reinterpret_cast<uint32_t*>(tb + q * p.PS + c0 + 4 * c4) = v;
    }
  } else {
    for (int i = threadIdx.x; i < cc * kHPix; i += kThreads) {
      const int q = i % kHPix, c = i / kHPix;
      tb[q * p.PS + c0 + c] = quantize(
          nvs::to_f32(sb[(c * kHT + q / kWT) * kSW + q % kWT + kCol]),
          p.scale_in, p.rcp_in);
    }
  }
}

// a k-step's A fragment from the halo tile tb: the warp's pixels at base0
// and base1, k through the offsets table. VEC: Cin % 4 == 0, so four
// consecutive k share a tap and are one word of the halo tile; else each k
// is a byte of its own.
template <bool VEC>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const int8_t* tb,
                                       const int* offs, int kk, int base0,
                                       int base1, int t) {
  if (VEC) {
    const int o0 = offs[kk / 4 + t], o1 = offs[kk / 4 + 4 + t];
    r[0] = lds32(tb + base0 + o0);
    r[1] = lds32(tb + base1 + o0);
    r[2] = lds32(tb + base0 + o1);
    r[3] = lds32(tb + base1 + o1);
  } else {
    r[0] = r[1] = r[2] = r[3] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o0 = offs[kk + 4 * t + j], o1 = offs[kk + 16 + 4 * t + j];
      r[0] |= uint32_t(uint8_t(tb[base0 + o0])) << (8 * j);
      r[1] |= uint32_t(uint8_t(tb[base1 + o0])) << (8 * j);
      r[2] |= uint32_t(uint8_t(tb[base0 + o1])) << (8 * j);
      r[3] |= uint32_t(uint8_t(tb[base1 + o1])) << (8 * j);
    }
  }
}

// acc += A B over k0 .. k1 for one warp on mma.sync: A from the halo
// tile, B (its NT n8-tiles) from the block's NB channels of weights in
// shared memory, w pointing at k0's piece of the warp's first channel
template <bool VEC, int NT, int NB>
__device__ __forceinline__ void products_mma(int (&acc)[NT][4],
                                             const int8_t* tb,
                                             const int* offs,
                                             const int8_t* w, int k0,
                                             int k1, int base0, int base1,
                                             int t) {
  const int g = (threadIdx.x % 32) / 4;
  for (int kk = k0; kk < k1; kk += 32) {
    uint32_t a[4];
    load_a<VEC>(a, tb, offs, kk, base0, base1, t);
    const int8_t* wk = w + (kk - k0) / 16 * 16 * NB + g * 16 + 4 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma_s8(acc[j], a, lds32(wk + 128 * j), lds32(wk + 16 * NB + 128 * j));
  }
}

// d += a b: one warpgroup's m64nNk32 int8 product with int32 sums (the RS
// form: each warp's 16 rows of A as its m16n8k32 fragment, B through a
// matrix descriptor); d[4j + i] is mma_s8's d[i] of n8-tile j
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(1));
}


// ... the same on Hopper's warpgroup products (wgmma), for the warpgroup of
// 4 warps (rows) that share the warp's channels. The weights' layout is
// wgmma's K-major core-matrix layout (8 channels by 16 bytes, 128 bytes
// apart along N, 16 NB apart along K). The k-steps go in batches of 4:
// their A fragments are loaded before the batch is issued and the next
// batch's loads wait for it, so that no register a product reads is
// written while it runs (else ptxas serialises every product); the tail a
// k-step at a time.
template <bool VEC, int NT, int NB>
__device__ __forceinline__ void products_wgmma(int (&acc)[NT][4],
                                               const int8_t* tb,
                                               const int* offs,
                                               const int8_t* w, int k0,
                                               int k1, int base0, int base1,
                                               int t) {
  int (&d)[NT * 4] = *reinterpret_cast<int (*)[NT * 4]>(&acc[0][0]);
  const uint64_t desc0 = nvs::wgmma_desc(w, 16 * NB);
  const uint64_t kstep = 2 * NB;  // 32 NB bytes, >> 4 in the descriptor
  int kk = k0;
  for (; kk + 128 <= k1; kk += 128) {
    uint32_t a[4][4];
    nvs::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      load_a<VEC>(a[j], tb, offs, kk + 32 * j, base0, base1, t);
    nvs::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_s8<8 * NT>(d, a[j], desc0 + ((kk - k0) / 32 + j) * kstep);
    nvs::wgmma_commit();
  }
  for (; kk < k1; kk += 32) {
    uint32_t a[4];
    nvs::wgmma_wait<0>();
    load_a<VEC>(a, tb, offs, kk, base0, base1, t);
    nvs::wgmma_fence();
    wgmma_s8<8 * NT>(d, a, desc0 + (kk - k0) / 32 * kstep);
    nvs::wgmma_commit();
  }
  nvs::wgmma_wait<0>();
}

// The products: on wgmma where a warp has at least kWgmmaMinN channels (the
// wide instances, where it measured faster), else on mma.sync, which
// measured faster at 8 to 32 channels (tools/int8_variants.py times both
// at every instance)
constexpr int kWgmmaMinN = 64;

template <bool VEC, int NT, int NB>
__device__ __forceinline__ void products(int (&acc)[NT][4],
                                         const int8_t* tb, const int* offs,
                                         const int8_t* w, int k0, int k1,
                                         int base0, int base1, int t) {
  if constexpr (8 * NT >= kWgmmaMinN)
    products_wgmma<VEC, NT, NB>(acc, tb, offs, w, k0, k1, base0, base1, t);
  else
    products_mma<VEC, NT, NB>(acc, tb, offs, w, k0, k1, base0, base1, t);
}

// bf16(v), widened back
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// rescale, BN and activation of one warp's sums (m, a, b of the block's
// channels in mab), rounded where a bf16 block rounds where TX is bf16: TX
// NCHW out, or the codes staged in ep ([pixel][NB])
template <typename TX, int NT, int TH>
__device__ __forceinline__ void epilogue(const Params& p,
                                         const int (&acc)[NT][4],
                                         const float* mab, const TileAt& at,
                                         int n0, int8_t* ep) {
  constexpr int NB = 8 * NT * Tile<TH>::Halves;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wr = warp % TH, h = warp / TH;
  const int oy = at.y0 + wr;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cl = 8 * (h * NT + j) + 2 * t + (e & 1);  // within the block
      const int c = n0 + cl;
      const int ox = at.x0 + g + 8 * (e >> 1);
      float v = 0.f;
      if (c < p.Cout) {
        v = __fmul_rn(static_cast<float>(acc[j][e]), mab[cl]);
        v = __fadd_rn(__fmul_rn(v, mab[NB + cl]), mab[2 * NB + cl]);
        if constexpr (std::is_same<TX, bf16>::value) {
          v = round_bf16(v);
          v = v > 0.f ? v : round_bf16(__fmul_rn(v, p.slope));
        } else {
          v = v > 0.f ? v : __fmul_rn(v, p.slope);
        }
      }
      if (p.out_mode == kFloatOut) {
        if (c < p.Cout && oy < p.H && ox < p.W) {
          const size_t o =
              ((static_cast<size_t>(at.img) * p.Cout + c) * p.H + oy) * p.W +
              ox;
          static_cast<TX*>(p.out)[o] = TX(v);  // exact in bf16 too
        }
      } else {
        ep[(wr * kTW + g + 8 * (e >> 1)) * NB + cl] =
            quantize(v, p.out_scale, p.rcp_out);
      }
    }
  }
}

// the staged codes -> int8 NHWC words, 2x2 max-pooled (floor on odd sizes)
// for kInt8Out + 1
template <int NB, int TH>
__device__ void write_codes(const Params& p, const TileAt& at, int n0,
                            const int8_t* ep) {
  int8_t* out = static_cast<int8_t*>(p.out);
  constexpr int words = NB / 4;
  if (p.out_mode == kInt8Out) {
    for (int i = threadIdx.x; i < TH * kTW * words; i += kThreads) {
      const int q = i / words, c4 = i % words;
      const int yy = at.y0 + q / kTW, xx = at.x0 + q % kTW;
      if (yy < p.H && xx < p.W && n0 + 4 * c4 < p.Cout)
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<size_t>(at.img) * p.H + yy) * p.W + xx)
                      * p.Cout + n0 + 4 * c4) = lds32(ep + q * NB + 4 * c4);
    }
    return;
  }
  const int Ho = p.H / 2, Wo = p.W / 2;
  constexpr int PH = TH / 2, PW = kTW / 2;
  for (int i = threadIdx.x; i < PH * PW * words; i += kThreads) {
    const int q = i / words, c4 = i % words;
    const int py = q / PW, px = q % PW;
    const int yy = at.y0 / 2 + py, xx = at.x0 / 2 + px;
    if (yy < Ho && xx < Wo && n0 + 4 * c4 < p.Cout) {
      const int8_t* s = ep + (2 * py * kTW + 2 * px) * NB + 4 * c4;
      const uint32_t v = __vmaxs4(__vmaxs4(lds32(s), lds32(s + NB)),
                                  __vmaxs4(lds32(s + kTW * NB),
                                           lds32(s + (kTW + 1) * NB)));
      *reinterpret_cast<uint32_t*>(
          out + ((static_cast<size_t>(at.img) * Ho + yy) * Wo + xx) * p.Cout
          + n0 + 4 * c4) = v;
    }
  }
}

// registers: the narrow instances should fit more blocks an SM
template <int NT>
constexpr int min_blocks() {
  return NT <= 2 ? 4 : NT == 4 ? 3 : NT == 8 ? 2 : 1;
}

// NT: n8-tiles a warp; a block's 8 warps are the tile's TH rows by 8 / TH
// parts of its NB = 8 NT (8 / TH) output channels; TX: the block's type,
// float or bf16 (a float map's, which is staged so, and the output's)
template <typename TX, bool VEC, int NT, int TH>
__global__ void __launch_bounds__(kThreads, min_blocks<NT>())
    int8conv_kernel(const Params p) {
  constexpr int NB = 8 * NT * Tile<TH>::Halves;
  constexpr int kStageCh = Tile<TH>::template StageCh<TX>;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* tiles = reinterpret_cast<int8_t*>(smem);  // kRing (int8 in) or 1
  TX* stage = reinterpret_cast<TX*>(smem + p.off_stage);  // kRing
  int8_t* wsm = reinterpret_cast<int8_t*>(smem + p.off_w);
  float* mab = reinterpret_cast<float*>(smem + p.off_mab);
  int* offs = reinterpret_cast<int*>(smem + p.off_offs);
  int8_t* ep = reinterpret_cast<int8_t*>(smem + p.off_ep);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wr = warp % TH, h = warp / TH;
  const int n0 = blockIdx.y * NB;
  const bool fin = !p.x_int8, resident = p.KC == p.Kpad;
  // items: the block's tiles, each in nch channel chunks of a float input;
  // item i is copied into ring slot i % kRing while item i - 1 is worked on
  const int nch = fin ? p.nch : 1;
  const int n_items = ((p.ntiles - 1 - blockIdx.x) / gridDim.x + 1) * nch;
  auto copy_item = [&](int i) {
    if (i >= n_items) return;
    const int tile = blockIdx.x + i / nch * gridDim.x, c0 = i % nch * p.CC;
    const int slot = i % kRing;
    copy_input<TX, TH>(p, tile, c0, min(p.CC, p.Cin - c0),
                   stage + slot * p.CC * kStageCh,
                   tiles + slot * p.tile_bytes);
  };
  // the prologue's groups: item 0, then the weights
  copy_item(0);
  nvs::cp_async_commit();
  if (resident) copy_weights<NB>(p, wsm, n0, 0, p.Kpad);
  nvs::cp_async_commit();
  // k (a word of four k where VEC) -> its byte in the halo tile, from the
  // window's top-left pixel; the padded k read pixel 0 (their weights are
  // 0)
  const int n_offs = VEC ? p.Kpad / 4 : p.Kpad;
  for (int i = tid; i < n_offs; i += kThreads) {
    const int k = VEC ? 4 * i : i;
    int o = 0;
    if (k < p.K) {
      const int tap = k / p.Cin, c = k % p.Cin;
      o = ((tap / 3) * kWT + tap % 3) * p.PS + c;
    }
    offs[i] = o;
  }
  for (int i = tid; i < 3 * NB; i += kThreads) {
    const int j = i / NB, c = n0 + i % NB;
    const float* v = j == 0 ? p.m : j == 1 ? p.a : p.b;
    mab[i] = c < p.Cout ? v[c] : 0.f;
  }

  const int base0 = (wr * kWT + g) * p.PS;  // pixel (wr, g) of the tile
  const int base1 = base0 + 8 * p.PS;       // pixel (wr, g + 8)
  const int8_t* w_warp = wsm + h * NT * 128;  // the warp's first channel
  for (int i = 0; i < n_items; ++i) {
    // item i has landed (at i = 0 the weights' group may still be in
    // flight behind it); every thread is done with item i - 1's slot and
    // the last tile's products
    if (i == 0)
      nvs::cp_async_wait<1>();
    else
      nvs::cp_async_wait<0>();
    __syncthreads();
    copy_item(i + 1);  // overlaps all that follows
    nvs::cp_async_commit();
    const int slot = i % kRing;
    const int8_t* tb = tiles + (fin ? 0 : slot * p.tile_bytes);
    if (fin) {
      const int c0 = i % nch * p.CC;
      quantize_input<TX, VEC, TH>(p, stage + slot * p.CC * kStageCh, tiles,
                                  c0, min(p.CC, p.Cin - c0));
      if (i % nch != nch - 1) continue;
    }
    if (i < nch) {  // the first tile: the weights too, for wgmma's proxy
      nvs::cp_async_wait<0>();
      nvs::fence_async_shared();
    }
    if (fin || i < nch) __syncthreads();
    const TileAt at = tile_at<TH>(p, blockIdx.x + i / nch * gridDim.x);
    int acc[NT][4] = {};
    if (resident) {
      products<VEC, NT, NB>(acc, tb, offs, w_warp, 0, p.Kpad, base0, base1,
                            t);
    } else {  // a ring of two K chunks
      copy_weights<NB>(p, wsm, n0, 0, p.KC);
      nvs::cp_async_commit();
      for (int k0 = 0, j = 0; k0 < p.Kpad; k0 += p.KC, ++j) {
        const int k1 = min(p.Kpad, k0 + p.KC);
        nvs::cp_async_wait<0>();
        nvs::fence_async_shared();
        __syncthreads();  // chunk j in, chunk j - 1 read by every warp
        if (k1 < p.Kpad)
          copy_weights<NB>(p, wsm + ((j + 1) & 1) * p.KC * NB, n0, k1,
                           min(p.Kpad, k1 + p.KC));
        nvs::cp_async_commit();
        products<VEC, NT, NB>(acc, tb, offs, w_warp + (j & 1) * p.KC * NB,
                              k0, k1, base0, base1, t);
      }
    }
    epilogue<TX, NT, TH>(p, acc, mab, at, n0, ep);
    if (p.out_mode != kFloatOut) {
      __syncthreads();
      write_codes<NB, TH>(p, at, n0, ep);
    }
  }
}

// ---------------------------------------------------------------------
// The strip design (the header's note says what it is; dispatch, which
// calls take it). A block is two pipes, each one or two consumer
// warpgroups fed by a producer warp of its own; the pipes share the
// block's resident weights. A pipe walks a contiguous range of strips: R
// output rows by TW columns of one image, going down its column tile.

constexpr int kStripPipes = 2;
// consumer warpgroups a pipe: two (taking alternate m-blocks, so that one's
// epilogue runs under the other's products) where a thread's accumulators
// leave the registers for it (N <= 96: 576 threads, 96 registers a thread;
// N = 96 spills 64-72 bytes and still ran faster than on one warpgroup at
// N28's convs_4 and convs_6), else one
__host__ __device__ constexpr int strip_wgs(int n) { return n <= 96 ? 2 : 1; }
__host__ __device__ constexpr int strip_threads(int n) {
  return kStripPipes * (128 * strip_wgs(n) + 32);
}
constexpr int kStripMaxW = 320;     // a strip's columns at most
constexpr int kStripMaxMB = 16;     // a strip's 64-pixel m-blocks at most
constexpr int kStripMaxStages = 4;  // the input ring's stages at most

// a float output's staging row (64 pixels of a channel, padded so that the
// accumulators' stores fall on distinct banks)
template <typename TX>
__host__ __device__ constexpr int ep_pitch() {
  return sizeof(TX) == 2 ? 72 : 68;
}

struct StripParams {
  const void* x;
  const int8_t* w;  // (Cout, Kpad)
  const float* m;
  const float* a;
  const float* b;
  void* out;
  int x_int8, out_mode;
  int H, W, Cin, Cout, Kpad;
  int G;   // 16-channel groups of codes (planes)
  int NK;  // k-steps of 32: the 9 G (tap, group) items in pairs
  int R, TW, P;     // strip rows and columns; a code row's pixels (TW + 8)
  int ncol, nys;    // column tiles; strips a column tile
  int nstrips;      // B ncol nys
  int mblocks;      // ceil(R P / 64)
  int PLN;          // pixels a code plane: mblocks 64 + 2 P + 8
  int pre;          // staged pixels before x0 (16 bytes of them, or more)
  int SP;           // a staged row's bytes
  int CC;           // float input: channels a chunk; int8 input: rows
  int S;            // the ring's stages
  int stage_bytes;
  int off_mab, off_kt, off_pipes, pipe_bytes;  // the weights at 0
  int p_stage, p_ep, p_bar;                    // a pipe's codes at 0
  int smem;
  float scale_in, out_scale, slope;
  float rcp_in, rcp_out;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// n bytes global -> shared by the TMA unit, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(n), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// four (two) 8x8 matrices of 16-bit values from a warp's mma fragments
// (a register each: row lane / 4, columns 2 (lane % 4) and + 1) to shared
// memory transposed: matrix i's column c at the address of lane 8 i + c
__device__ __forceinline__ void stmatrix_x4_trans(void* p, uint32_t a,
                                                  uint32_t b, uint32_t c,
                                                  uint32_t d) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
      :: "r"(smem_u32(p)), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

__device__ __forceinline__ void stmatrix_x2_trans(void* p, uint32_t a,
                                                  uint32_t b) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};"
               :: "r"(smem_u32(p)), "r"(a), "r"(b) : "memory");
}

// the compiler may not move a read of d across this point (after a wgmma
// wait) nor a write of d before it
template <int NR>
__device__ __forceinline__ void fence_regs(int (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d = (acc ? d : 0) + a b: one warpgroup's m64nNk32 int8 product with
// int32 sums, A and B both through matrix descriptors (K-major, no
// swizzle); d[4j + i] is mma_s8's d[i] of n8-tile j of the warp's 16 rows
template <int N>
__device__ __forceinline__ void wgmma_ss(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<16>(int (&d)[8], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<24>(int (&d)[12], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(int (&d)[16], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(int (&d)[24], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(int (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(int (&d)[48], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(int (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// item i of the K order: tap i / G, channel group i % G; its A operand
// for pixel 0 of the strip in 16-byte units from the codes' base: the
// group's plane, shifted by the tap
__host__ __device__ __forceinline__ int item_at(const StripParams& p,
                                                int item) {
  const int t = item / p.G;
  return item % p.G * p.PLN + t / 3 * p.P + t % 3;
}

// k-step s multiplies items 2s and 2s + 1, the one at the lower address
// first (a descriptor's second core matrix along K lies LBO above its
// first); an odd count's last step pairs item 9G - 1 with zero weights
__device__ __forceinline__ void kstep_items(const StripParams& p, int s,
                                            int& first, int& second) {
  const int a = 2 * s, b = 2 * s + 1;
  if (b >= 9 * p.G) {
    first = a;
    second = -1;
  } else if (item_at(p, a) < item_at(p, b)) {
    first = a;
    second = b;
  } else {
    first = b;
    second = a;
  }
}

struct StripAt {
  int img, ys, y0, x0, tw;
};

__device__ __forceinline__ StripAt strip_at(const StripParams& p, int s) {
  const int ys = s % p.nys, r = s / p.nys, col = r % p.ncol;
  const int x0 = col * p.TW;
  return {r / p.ncol, ys, ys * p.R, x0, min(p.TW, p.W - x0)};
}

// chunks of a strip whose code rows i0 .. R + 1 are copied
__device__ __forceinline__ int strip_chunks(const StripParams& p, int i0) {
  return p.x_int8 ? (p.R + 2 - i0 + p.CC - 1) / p.CC
                  : (p.Cin + p.CC - 1) / p.CC;
}

// The producer warp of a pipe: its strips' input, chunk q into stage
// q % S once the consumers have released the stage's last chunk. A float
// chunk is CC channel planes' rows, a row (channel, code row i) at
// (channel, i) of [CC][R + 2][SP bytes]; an int8 chunk is CC code rows of
// NHWC pixels, [CC][SP bytes]; each row the frame's columns x0 - pre ..
// x0 + tw + pre - 1, a bulk copy. Rows and columns outside the frame are
// not copied (the consumers write their zeros).
template <typename TX>
__device__ void strip_producer(const StripParams& p, unsigned char* pipe,
                               int s0, int s1) {
  const int lane = threadIdx.x % 32;
  unsigned char* stages = pipe + p.p_stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(pipe + p.p_bar);
  uint64_t* empty = full + kStripMaxStages;
  const int esz = p.x_int8 ? p.Cin : static_cast<int>(sizeof(TX));
  int q = 0;
  for (int s = s0; s < s1; ++s) {
    const StripAt at = strip_at(p, s);
    const int i0 = s > s0 && at.ys > 0 ? 2 : 0;
    const int xs = max(0, at.x0 - p.pre), xe = min(p.W, at.x0 + at.tw + p.pre);
    const uint32_t row_bytes = (xe - xs) * esz;
    const int col_off = (xs - at.x0 + p.pre) * esz;
    // code row i holds frame row y0 - 1 + i
    const int in_lo = max(i0, 1 - at.y0), in_hi = min(p.R + 2, p.H + 1 - at.y0);
    const int nch = strip_chunks(p, i0);
    for (int c = 0; c < nch; ++c, ++q) {
      const int st = q % p.S;
      if (q >= p.S) mbar_wait(empty + st, (q / p.S - 1) & 1);
      unsigned char* dst = stages + st * p.stage_bytes;
      int ia = in_lo, ib = in_hi, c0 = 0, cc = 1;
      if (p.x_int8) {
        ia = max(in_lo, i0 + c * p.CC);
        ib = min(in_hi, i0 + (c + 1) * p.CC);
      } else {
        c0 = c * p.CC;
        cc = min(p.CC, p.Cin - c0);
      }
      const int nr = max(0, ib - ia), n = cc * nr;
      if (lane == 0) mbar_expect_tx(full + st, n * row_bytes);
      __syncwarp();
      for (int k = lane; k < n; k += 32) {
        const int i = ia + k % nr, gy = at.y0 - 1 + i;
        if (p.x_int8) {
          const int8_t* src = static_cast<const int8_t*>(p.x) +
              ((static_cast<size_t>(at.img) * p.H + gy) * p.W + xs) * p.Cin;
          bulk_copy(dst + (i - i0 - c * p.CC) * p.SP + col_off, src,
                    row_bytes, full + st);
        } else {
          const int ch = c0 + k / nr;
          const TX* src = static_cast<const TX*>(p.x) +
              ((static_cast<size_t>(at.img) * p.Cin + ch) * p.H + gy) * p.W +
              xs;
          bulk_copy(dst + ((ch - c0) * (p.R + 2) + i) * p.SP + col_off, src,
                    row_bytes, full + st);
        }
      }
    }
  }
}

// A staged float chunk -> codes: a thread a code pixel (row i, column j:
// frame pixel (y0 - 1 + i, x0 - 1 + j)) and 8 channels, one 8-byte store
// into the channels' plane ([group][pixel][16 bytes]); zeros outside the
// frame and beyond Cin
template <typename TX>
__device__ void convert_float(const StripParams& p, const StripAt& at,
                              int i0, int c, const unsigned char* stage,
                              int8_t* codes, int tid, int nthr) {
  const int c0 = c * p.CC, cc = min(p.CC, p.Cin - c0);
  const int nh = (cc + 7) / 8, npx = at.tw + 2;
  const int row_el = p.SP / static_cast<int>(sizeof(TX));
  const int ch_el = (p.R + 2) * row_el;
  const TX* sb = reinterpret_cast<const TX*>(stage);
  const int units = (p.R + 2 - i0) * nh * npx;
  for (int u = tid; u < units; u += nthr) {
    const int j = u % npx, rest = u / npx, h = rest % nh, i = i0 + rest / nh;
    const int gy = at.y0 - 1 + i, gx = at.x0 - 1 + j;
    uint32_t lo = 0, hi = 0;
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      const TX* s = sb + (8 * h * (p.R + 2) + i) * row_el + j - 1 + p.pre;
      float v[8];
      int q[8];
      bool exact = true;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = 8 * h + k < cc ? nvs::to_f32(s[k * ch_el]) : 0.f;
        q[k] = quantize_fast(v[k], p.rcp_in, exact);
      }
      if (!exact) {  // about one value in 20,000
#pragma unroll
        for (int k = 0; k < 8; ++k)
          q[k] = quantize(v[k], p.scale_in, p.rcp_in);
      }
      lo = pack4(q[0], q[1], q[2], q[3]);
      hi = pack4(q[4], q[5], q[6], q[7]);
    }
    const int ch = c0 + 8 * h;
    *reinterpret_cast<uint2*>(
        codes + (static_cast<size_t>(ch / 16) * p.PLN + i * p.P + j) * 16 +
        ch % 16) = make_uint2(lo, hi);
  }
}

// A staged int8 chunk (code rows ia .. ib - 1) -> codes: a thread a code
// pixel and a channel group, its 16 bytes as four words
__device__ void convert_int8(const StripParams& p, const StripAt& at, int i0,
                             int c, const unsigned char* stage,
                             int8_t* codes, int tid, int nthr) {
  const int ia = i0 + c * p.CC, ib = min(p.R + 2, ia + p.CC);
  const int npx = at.tw + 2, units = (ib - ia) * p.G * npx;
  for (int u = tid; u < units; u += nthr) {
    const int j = u % npx, rest = u / npx, g = rest % p.G, i = ia + rest / p.G;
    const int gy = at.y0 - 1 + i, gx = at.x0 - 1 + j;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      const unsigned char* s =
          stage + (i - ia) * p.SP + (j - 1 + p.pre) * p.Cin + 16 * g;
      const int left = p.Cin - 16 * g;  // a multiple of 4
      v.x = left > 0 ? *reinterpret_cast<const uint32_t*>(s) : 0u;
      v.y = left > 4 ? *reinterpret_cast<const uint32_t*>(s + 4) : 0u;
      v.z = left > 8 ? *reinterpret_cast<const uint32_t*>(s + 8) : 0u;
      v.w = left > 12 ? *reinterpret_cast<const uint32_t*>(s + 12) : 0u;
    }
    *reinterpret_cast<uint4*>(
        codes + (static_cast<size_t>(g) * p.PLN + i * p.P + j) * 16) = v;
  }
}

// rescale, BN and activation of one sum of channel n (m, a, b in mab),
// rounded where a bf16 block rounds where TX is bf16
template <typename TX>
__device__ __forceinline__ float block_value(int acc, const float* mab,
                                             int n, int nb, float slope) {
  float v = __fmul_rn(static_cast<float>(acc), mab[n]);
  v = __fadd_rn(__fmul_rn(v, mab[nb + n]), mab[2 * nb + n]);
  if constexpr (std::is_same<TX, bf16>::value) {
    v = round_bf16(v);
    return v > 0.f ? v : round_bf16(__fmul_rn(v, slope));
  } else {
    return v > 0.f ? v : __fmul_rn(v, slope);
  }
}

// m-block mb's sums (of the warpgroup's thread wtid) -> the block's type
// NCHW: staged [channel][64 pixels] in the warpgroup's ep, then each
// channel's 8-pixel (bf16) or 4-pixel (float32) pieces as 16-byte stores,
// a channel's pieces on consecutive lanes
template <typename TX, int N>
__device__ __forceinline__ void strip_store_float(const StripParams& p,
                                                  const StripAt& at,
                                                  const int (&d)[N / 2],
                                                  int mb, const float* mab,
                                                  TX* ep, int wtid, int bar) {
  constexpr int EPP = ep_pitch<TX>();
  const int lane = wtid % 32, g = lane / 4, t = lane % 4;
  const int row0 = 16 * (wtid / 32) + g;
  if constexpr (std::is_same<TX, bf16>::value) {
    // stmatrix .trans: matrix i of an x4 is n8-tile j + i / 2's pixels
    // 8 (i % 2) .. + 7; lane 8 i + c gives channel c's row of it
    const int i = lane / 8, c = lane % 8;
    auto value = [&](int k) {  // d[k] as the block computes it
      return block_value<TX>(d[k], mab, 8 * (k / 4) + 2 * t + (k & 1), N,
                             p.slope);
    };
#pragma unroll
    for (int j = 0; j + 1 < N / 8; j += 2)
      stmatrix_x4_trans(ep + (8 * (j + i / 2) + c) * EPP + row0 - g +
                            8 * (i % 2),
                        nvs::pack_bf16(value(4 * j), value(4 * j + 1)),
                        nvs::pack_bf16(value(4 * j + 2), value(4 * j + 3)),
                        nvs::pack_bf16(value(4 * j + 4), value(4 * j + 5)),
                        nvs::pack_bf16(value(4 * j + 6), value(4 * j + 7)));
    if constexpr (N / 8 % 2 == 1) {  // the last n8-tile (lanes 0-15)
      constexpr int j = N / 8 - 1;
      stmatrix_x2_trans(ep + (8 * j + c) * EPP + row0 - g + 8 * (i % 2),
                        nvs::pack_bf16(value(4 * j), value(4 * j + 1)),
                        nvs::pack_bf16(value(4 * j + 2), value(4 * j + 3)));
    }
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 8 * j + 2 * t + (e & 1);
        ep[n * EPP + row0 + 8 * (e >> 1)] =
            TX(block_value<TX>(d[4 * j + e], mab, n, N, p.slope));
      }
    }
  }
  bar_sync(bar, 128);
  // a thread's pieces: piece k = wtid % kPieces of every kStep-th channel
  constexpr int kPix = 16 / static_cast<int>(sizeof(TX));  // a piece's
  constexpr int kPieces = 64 / kPix, kStep = 128 / kPieces;
  const int k = wtid % kPieces;
  const int m = mb * 64 + k * kPix, r = m / p.P, cx = m % p.P;
  if (r < p.R && at.y0 + r < p.H && cx < at.tw) {
    const size_t plane = static_cast<size_t>(p.H) * p.W;
    TX* o = static_cast<TX*>(p.out) + at.img * N * plane +
            static_cast<size_t>(at.y0 + r) * p.W + at.x0 + cx;
    for (int n = wtid / kPieces; n < N; n += kStep)
      *reinterpret_cast<uint4*>(o + n * plane) =
          *reinterpret_cast<const uint4*>(ep + n * EPP + k * kPix);
  }
  bar_sync(bar, 128);  // ep is free for the next m-block
}

// m-block mb's sums (of the warpgroup's thread wtid) -> codes staged
// [strip pixel][N] in ep8, two channels a 16-bit store. An n8-tile's four
// values at a time: quantize_fast's codes, and quantize()'s for the four
// where one needs them (quantize() a value, and a second pass over the
// whole m-block where one value needs it, ran slower on the H100).
template <typename TX, int N>
__device__ __forceinline__ void strip_stage_codes(const StripParams& p,
                                                  const int (&d)[N / 2],
                                                  int mb, const float* mab,
                                                  int8_t* ep8, int wtid) {
  const int lane = wtid % 32, g = lane / 4, t = lane % 4;
  const int row0 = mb * 64 + 16 * (wtid / 32) + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int n = 8 * j + 2 * t;
    bool exact = true;
    int q[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q[e] = quantize_fast(
          block_value<TX>(d[4 * j + e], mab, n + (e & 1), N, p.slope),
          p.rcp_out, exact);
    if (!exact) {  // about one value in 20,000
#pragma unroll
      for (int e = 0; e < 4; ++e)
        q[e] = quantize(
            block_value<TX>(d[4 * j + e], mab, n + (e & 1), N, p.slope),
            p.out_scale, p.rcp_out);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)  // rows g and g + 8
      *reinterpret_cast<uint16_t*>(ep8 + (row0 + 8 * h) * N + n) =
          static_cast<uint16_t>(uint8_t(q[2 * h]) |
                                uint32_t(uint8_t(q[2 * h + 1])) << 8);
  }
}

// the strip's staged codes -> int8 NHWC: each row's pixels (contiguous in
// ep8 and in the output) as 16-byte pieces, or 2x2 max-pooled (floor on
// odd sizes) as words for kInt8Out + 1
template <int N>
__device__ __forceinline__ void strip_write_codes(const StripParams& p,
                                                  const StripAt& at,
                                                  const int8_t* ep8, int tid,
                                                  int nthr) {
  int8_t* out = static_cast<int8_t*>(p.out);
  if (p.out_mode == kInt8Out) {
    const int rows = min(p.R, p.H - at.y0), pieces = at.tw * N / 16;
    for (int r = 0; r < rows; ++r) {
      uint4* o = reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(at.img) * p.H + at.y0 + r) * p.W +
                 at.x0) * N);
      const uint4* s = reinterpret_cast<const uint4*>(ep8 + r * p.P * N);
      for (int u = tid; u < pieces; u += nthr) o[u] = s[u];
    }
    return;
  }
  constexpr int words = N / 4;
  const int Ho = p.H / 2, Wo = p.W / 2, PW = at.tw / 2;
  const int rows = min(p.R / 2, Ho - at.y0 / 2);
  for (int py = 0; py < rows; ++py) {
    uint32_t* o = reinterpret_cast<uint32_t*>(
        out + ((static_cast<size_t>(at.img) * Ho + at.y0 / 2 + py) * Wo +
               at.x0 / 2) * N);
    const int8_t* s0 = ep8 + 2 * py * p.P * N;
    for (int u = tid; u < PW * words; u += nthr) {
      const int8_t* s = s0 + 2 * (u / words) * N + 4 * (u % words);
      o[u] = __vmaxs4(__vmaxs4(lds32(s), lds32(s + N)),
                      __vmaxs4(lds32(s + p.P * N), lds32(s + (p.P + 1) * N)));
    }
  }
}

// m-block mb's products: NK k-steps of wgmma, A the codes shifted by each
// k-step's items (table kt), B the resident weights
template <int N>
__device__ __forceinline__ void strip_products(int (&d)[N / 2],
                                               const uint64_t* kt,
                                               uint64_t da, uint64_t db,
                                               int nk, int mb) {
  nvs::wgmma_fence();
  da += 64 * mb;  // 64 pixels of 16 bytes
  for (int s = 0; s < nk; ++s)
    wgmma_ss<N>(d, da + kt[s], db + static_cast<uint64_t>(s) * (2 * N), s);
  nvs::wgmma_commit();
}

// The consumer warpgroups of a pipe. For each strip: the code rows of the
// strip above are kept where the strip continues one (its last two rows
// moved up), the rest converted from the ring's chunks by all of the
// pipe's threads; then each warpgroup's m-blocks' products and epilogues,
// one warpgroup's epilogue under the other's products (a second set of
// accumulators in one warpgroup, the next m-block's products in flight
// during an epilogue, made ptxas serialise every wgmma: C7514).
template <typename TX, int N>
__device__ void strip_consumer(const StripParams& p, unsigned char* smem,
                               unsigned char* pipe, int pipe_id, int s0,
                               int s1) {
  constexpr int WGS = strip_wgs(N), NT = 128 * WGS;
  const int tid = threadIdx.x % NT, wg = tid / 128, wtid = tid % 128;
  const int bar = 1 + pipe_id;                          // the pipe's
  const int wbar = 1 + kStripPipes + pipe_id * WGS + wg;  // the warpgroup's
  int8_t* codes = reinterpret_cast<int8_t*>(pipe);
  const unsigned char* stages = pipe + p.p_stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(pipe + p.p_bar);
  uint64_t* empty = full + kStripMaxStages;
  const float* mab = reinterpret_cast<const float*>(smem + p.off_mab);
  const uint64_t* kt = reinterpret_cast<const uint64_t*>(smem + p.off_kt);
  const uint64_t da = nvs::wgmma_desc(codes, 0);
  const uint64_t db = nvs::wgmma_desc(smem, 16 * N);
  TX* ep = reinterpret_cast<TX*>(pipe + p.p_ep) + wg * N * ep_pitch<TX>();
  int8_t* ep8 = reinterpret_cast<int8_t*>(pipe + p.p_ep);
  int q = 0;
  int d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0;
  for (int s = s0; s < s1; ++s) {
    const StripAt at = strip_at(p, s);
    const bool cont = s > s0 && at.ys > 0;
    bar_sync(bar, NT);  // every warp is done with the last strip
    if (cont) {
      for (int u = tid; u < p.G * 2 * p.P; u += NT) {
        uint4* plane = reinterpret_cast<uint4*>(codes) +
                       static_cast<size_t>(u / (2 * p.P)) * p.PLN;
        plane[u % (2 * p.P)] = plane[p.R * p.P + u % (2 * p.P)];
      }
      bar_sync(bar, NT);
    }
    const int i0 = cont ? 2 : 0, nch = strip_chunks(p, i0);
    for (int c = 0; c < nch; ++c, ++q) {
      const int st = q % p.S;
      mbar_wait(full + st, (q / p.S) & 1);
      const unsigned char* stage = stages + st * p.stage_bytes;
      if (p.x_int8)
        convert_int8(p, at, i0, c, stage, codes, tid, NT);
      else
        convert_float<TX>(p, at, i0, c, stage, codes, tid, NT);
      mbar_arrive(empty + st);
    }
    nvs::fence_async_shared();
    bar_sync(bar, NT);
    for (int mb = wg; mb < p.mblocks; mb += WGS) {
      fence_regs(d);
      strip_products<N>(d, kt, da, db, p.NK, mb);
      nvs::wgmma_wait<0>();
      fence_regs(d);
      if (p.out_mode == kFloatOut)
        strip_store_float<TX, N>(p, at, d, mb, mab, ep, wtid, wbar);
      else
        strip_stage_codes<TX, N>(p, d, mb, mab, ep8, wtid);
    }
    if (p.out_mode != kFloatOut) {
      bar_sync(bar, NT);
      strip_write_codes<N>(p, at, ep8, tid, NT);
    }
  }
}

// The block: the mbarriers, the weights in the k-steps' order (piece 2s +
// h of channel n at (2s + h) 16 N + 16 n: wgmma's K-major core matrices),
// m, a, b and the k-step table, then the pipes' warps in their roles.
// Pipe v of the grid's takes strips [v S / V, (v + 1) S / V).
template <typename TX, int N>
__global__ void __launch_bounds__(strip_threads(N), 1)
    int8conv_strip_kernel(const StripParams p) {
  constexpr int WGS = strip_wgs(N), THREADS = strip_threads(N);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int v = 0; v < kStripPipes; ++v) {
      uint64_t* full = reinterpret_cast<uint64_t*>(
          smem + p.off_pipes + v * p.pipe_bytes + p.p_bar);
      for (int s = 0; s < kStripMaxStages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(full + kStripMaxStages + s, 128 * WGS);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int8_t* wsm = reinterpret_cast<int8_t*>(smem);
  for (int i = tid; i < 2 * p.NK * N * 4; i += THREADS) {
    const int k4 = i % 4, n = i / 4 % N, piece = i / (4 * N);
    int first, second;
    kstep_items(p, piece / 2, first, second);
    const int item = piece % 2 ? second : first;
    const int c = item % p.G * 16 + 4 * k4;  // item < 0: zeros
    const bool in = item >= 0 && c < p.Cin;
    const int8_t* src =
        p.w + (in ? static_cast<size_t>(n) * p.Kpad + item / p.G * p.Cin + c
                  : 0);
    int8_t* dst = wsm + (piece * N + n) * 16 + 4 * k4;
    if (p.Cin % 4 == 0) {
      nvs::cp_async4(dst, src, in);
    } else {  // conv1a's 3 channels: the next tap's bytes stay out
      uint32_t v = 0;
      for (int b = 0; b < 4; ++b)
        if (in && c + b < p.Cin) v |= uint32_t(uint8_t(src[b])) << (8 * b);
      *reinterpret_cast<uint32_t*>(dst) = v;
    }
  }
  nvs::cp_async_commit();
  float* mab = reinterpret_cast<float*>(smem + p.off_mab);
  for (int i = tid; i < 3 * N; i += THREADS)
    mab[i] = (i < N ? p.m : i < 2 * N ? p.a : p.b)[i % N];
  uint64_t* kt = reinterpret_cast<uint64_t*>(smem + p.off_kt);
  for (int s = tid; s < p.NK; s += THREADS) {
    int first, second;
    kstep_items(p, s, first, second);
    const int a0 = item_at(p, first);
    const int lbo = second >= 0 ? item_at(p, second) - a0 : 1;
    kt[s] = static_cast<uint64_t>(a0) | static_cast<uint64_t>(lbo) << 16;
  }
  nvs::cp_async_wait<0>();
  nvs::fence_async_shared();
  __syncthreads();
  const int warp = tid / 32, pipes = gridDim.x * kStripPipes;
  const int nc = 4 * WGS * kStripPipes;  // consumer warps
  const int v = warp < nc ? warp / (4 * WGS) : warp - nc;
  const int vp = blockIdx.x * kStripPipes + v;
  const int s0 = static_cast<int>(static_cast<long long>(vp) * p.nstrips /
                                  pipes);
  const int s1 = static_cast<int>(static_cast<long long>(vp + 1) *
                                  p.nstrips / pipes);
  unsigned char* pipe = smem + p.off_pipes + v * p.pipe_bytes;
  if (warp >= nc)
    strip_producer<TX>(p, pipe, s0, s1);
  else
    strip_consumer<TX, N>(p, smem, pipe, v, s0, s1);
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// 1 / s rounded, for a normal s > 0 (quantize's bound holds there), else 0
inline float reciprocal(float s) {
  return std::isnormal(s) && s > 0.f ? 1.f / s : 0.f;
}

// The shared-memory plan for chunks of up to `chunk` float channels: the
// input ring (kRing halo tiles of int8 codes, or kRing staged chunks and
// one halo tile), the weights (all of K if they fit, else a ring of two K
// chunks of 32 KB), m, a and b, the offsets table and the codes' staging.
// False if it does not fit.
template <typename TX, int TH>
bool plan(Params& p, bool vec, int chunk) {
  const bool fin = !p.x_int8;
  p.tile_bytes = round_up(Tile<TH>::HPix * p.PS, 16);
  p.CC = p.Cin;
  p.nch = 1;
  if (fin) {
    p.nch = (p.Cin + chunk - 1) / chunk;
    p.CC = round_up((p.Cin + p.nch - 1) / p.nch, vec ? 4 : 1);
  }
  const int staged =
      Tile<TH>::template StageCh<TX> * static_cast<int>(sizeof(TX));
  const int input = fin ? p.tile_bytes + kRing * p.CC * staged
                        : kRing * p.tile_bytes;
  const int offs = round_up(4 * (vec ? p.Kpad / 4 : p.Kpad), 16);
  const int rest = 3 * p.NB * 4 + offs +
                   (p.out_mode == kFloatOut ? 0 : TH * kTW * p.NB);
  int wbytes = p.Kpad * p.NB;
  p.KC = p.Kpad;
  if (input + wbytes + rest > kSmemMax) {
    p.KC = min(p.Kpad, max(32, 32768 / p.NB / 32 * 32));
    wbytes = 2 * p.KC * p.NB;
  }
  p.off_stage = fin ? p.tile_bytes : kRing * p.tile_bytes;
  p.off_w = input;
  p.off_mab = p.off_w + wbytes;
  p.off_offs = p.off_mab + 3 * p.NB * 4;
  p.off_ep = p.off_offs + offs;
  p.smem = input + wbytes + rest;
  return p.smem <= kSmemMax;
}

// a call's launch: its instance, parameters, grid and blocks an SM
struct Launch {
  void (*kernel)(Params);
  Params p;
  dim3 grid;
  int per_sm, th, warp_channels;
  int waves() const {  // rounds of tiles a block walks
    return (p.ntiles + grid.x - 1) / grid.x;
  }
};

template <typename TX, bool VEC, int NT, int TH>
cudaError_t prepare(Params p, int sms, Launch& l) {
  p.NB = 8 * NT * Tile<TH>::Halves;
  p.tiles_x = (p.W + kTW - 1) / kTW;
  p.tiles_y = (p.H + TH - 1) / TH;
  p.ntiles = p.B * p.tiles_x * p.tiles_y;
  const auto kernel = int8conv_kernel<TX, VEC, NT, TH>;
  cudaError_t err = nvs::once_per_device([&] {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemMax);
  });
  if (err != cudaSuccess) return err;
  // a float input's chunk: where each SM gets at most one tile, 64 channels
  // (one wait a tile at Cin 64); else 32, or 16 or 8 where that lets two
  // blocks share an SM (228 KB, 1 KB of it a block's own)
  auto two_fit = [](const Params& q) { return 2 * (q.smem + 1024) <= 233472; };
  if (!plan<TX, TH>(p, VEC, p.ntiles <= sms ? 64 : 32))
    return cudaErrorInvalidValue;
  for (int chunk = 16; !p.x_int8 && p.ntiles > sms && !two_fit(p) &&
                       chunk >= 8; chunk /= 2) {
    Params q = p;
    if (plan<TX, TH>(q, VEC, chunk) && two_fit(q)) p = q;
  }
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, p.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // as many blocks as the card holds, each with the same number of tiles
  const int gy = (p.Cout + p.NB - 1) / p.NB;
  const int slots = max(1, per_sm * sms / gy);
  const int per_block = (p.ntiles + slots - 1) / slots;
  l = {kernel, p, dim3((p.ntiles + per_block - 1) / per_block, gy), per_sm,
       TH, 8 * NT};
  return cudaSuccess;
}

template <typename TX, bool VEC>
cudaError_t prepare_th8(const Params& p, int sms, Launch& l) {
  if (p.Cout <= 8) return prepare<TX, VEC, 1, 8>(p, sms, l);
  if (p.Cout <= 16) return prepare<TX, VEC, 2, 8>(p, sms, l);
  if (p.Cout <= 32) return prepare<TX, VEC, 4, 8>(p, sms, l);
  return prepare<TX, VEC, 8, 8>(p, sms, l);
}

template <typename TX, bool VEC>
cudaError_t prepare_th4(const Params& p, int sms, Launch& l) {
  const int half = (min(p.Cout, 256) + 1) / 2;
  if (half <= 32) return prepare<TX, VEC, 4, 4>(p, sms, l);
  if (half <= 64) return prepare<TX, VEC, 8, 4>(p, sms, l);
  return prepare<TX, VEC, 16, 4>(p, sms, l);
}

// The strip design's geometry for a call, false where it does not take the
// call: an int8 input's Cin a multiple of 4 (its words), Cout one
// of wgmma's widths here (N = Cout exactly), W a multiple of 8 (a bf16
// row's 16-byte pieces; with the code pitch TW + 8, a piece's pixels are
// all in the strip or all beyond it) and 16-byte-aligned tensors. A strip
// spans W (up to kStripMaxW columns, else W in equal column tiles, a
// multiple of 8 each) and R rows, the most of 8, 4, 2 for which R P stays
// within kStripMaxMB m-blocks and the shared memory holds the weights and
// two pipes' codes, ring (float input: 16 channels a chunk, else 8; int8:
// the strip's rows a chunk, else half) and epilogue staging, with the most
// stages up to 4 (2 at least). Where that leaves 2 rows, column tiles of
// half the width (64 columns or more) are taken if they hold 4 rows or
// more: at N28 B128
// (tools/int8_variants.py's shapes, NVIDIA H100 80GB HBM3, 700 W) the
// 72-channel 120x160 conv ran 0.733 ms in 4x80 strips against 0.820 in
// 2x160, and conv1a / conv1b 1-3% faster in 4x160 than 2x320.
inline bool strip_width(int n) {
  return n == 16 || n == 24 || n == 32 || n == 48 || n == 64 || n == 96 ||
         n == 128;
}

// the geometry in ncol column tiles
template <typename TX>
bool strip_fit(const Params& p, int ncol, StripParams& q) {
  q = StripParams{};
  q.x = p.x;
  q.w = p.w;
  q.m = p.m;
  q.a = p.a;
  q.b = p.b;
  q.out = p.out;
  q.x_int8 = p.x_int8;
  q.out_mode = p.out_mode;
  q.H = p.H;
  q.W = p.W;
  q.Cin = p.Cin;
  q.Cout = p.Cout;
  q.Kpad = p.Kpad;
  q.scale_in = p.scale_in;
  q.out_scale = p.out_scale;
  q.slope = p.slope;
  q.rcp_in = p.rcp_in;
  q.rcp_out = p.rcp_out;
  const int N = p.Cout, tx = static_cast<int>(sizeof(TX));
  q.G = (p.Cin + 15) / 16;
  q.NK = (9 * q.G + 1) / 2;
  q.ncol = ncol;
  q.TW = round_up((p.W + q.ncol - 1) / q.ncol, 8);
  q.P = q.TW + 8;
  q.pre = p.x_int8 ? 16 / std::gcd(p.Cin, 16) : 16 / tx;
  const int span = q.TW + 2 * q.pre;
  q.SP = p.x_int8 ? round_up(span * p.Cin, 16) : span * tx;
  q.off_mab = round_up(2 * q.NK * 16 * N, 128);
  q.off_kt = q.off_mab + round_up(12 * N, 16);
  q.off_pipes = round_up(q.off_kt + 8 * q.NK, 128);
  const int rows[3] = {8, 4, 2};
  for (const int R : rows) {
    const int mblocks = (R * q.P + 63) / 64;
    if (mblocks > kStripMaxMB) continue;
    const int pln = mblocks * 64 + 2 * q.P + 8;
    const int codes = round_up(q.G * pln * 16, 128);
    const int ep = round_up(p.out_mode == kFloatOut
                                ? strip_wgs(N) * N * ep_pitch<TX>() * tx
                                : mblocks * 64 * N, 16);
    const int chunks[2] = {p.x_int8 ? R + 2 : min(16, p.Cin),
                           p.x_int8 ? R / 2 + 1 : min(8, p.Cin)};
    for (const int cc : chunks) {
      const int stage =
          round_up(p.x_int8 ? cc * q.SP : cc * (R + 2) * q.SP, 128);
      for (int S = kStripMaxStages; S >= 2; --S) {
        const int pipe =
            round_up(codes + S * stage + ep + 16 * kStripMaxStages, 128);
        if (q.off_pipes + kStripPipes * pipe > kSmemMax) continue;
        q.R = R;
        q.nys = (p.H + R - 1) / R;
        q.nstrips = p.B * q.ncol * q.nys;
        q.mblocks = mblocks;
        q.PLN = pln;
        q.CC = cc;
        q.S = S;
        q.stage_bytes = stage;
        q.p_stage = codes;
        q.p_ep = codes + S * stage;
        q.p_bar = q.p_ep + ep;
        q.pipe_bytes = pipe;
        q.smem = q.off_pipes + kStripPipes * pipe;
        return true;
      }
    }
  }
  return false;
}

template <typename TX>
bool strip_geometry(const Params& p, StripParams& q) {
  if ((p.x_int8 && p.Cin % 4 != 0) || p.W % 8 != 0 ||
      !strip_width(p.Cout) || reinterpret_cast<uintptr_t>(p.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.out) % 16 != 0)
    return false;
  const int ncol = (p.W + kStripMaxW - 1) / kStripMaxW;
  if (!strip_fit<TX>(p, ncol, q)) return false;
  StripParams half;
  if (q.R == 2 && p.W >= 128 * ncol && strip_fit<TX>(p, 2 * ncol, half) &&
      half.R >= 4)
    q = half;
  return true;
}

// a strip call's launch: as many blocks as the card holds, at most one
// strip a pipe
struct StripLaunch {
  void (*kernel)(StripParams);
  StripParams p;
  int grid, per_sm;
};

template <typename TX, int N>
cudaError_t strip_prepare_n(const StripParams& q, int sms, StripLaunch& l) {
  const auto kernel = int8conv_strip_kernel<TX, N>;
  cudaError_t err = nvs::once_per_device([&] {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemMax);
  });
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, strip_threads(N), q.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  l = {kernel, q,
       min(per_sm * sms, (q.nstrips + kStripPipes - 1) / kStripPipes),
       per_sm};
  return cudaSuccess;
}

template <typename TX>
cudaError_t strip_prepare(const StripParams& q, int sms, StripLaunch& l) {
  switch (q.Cout) {
    case 16: return strip_prepare_n<TX, 16>(q, sms, l);
    case 24: return strip_prepare_n<TX, 24>(q, sms, l);
    case 32: return strip_prepare_n<TX, 32>(q, sms, l);
    case 48: return strip_prepare_n<TX, 48>(q, sms, l);
    case 64: return strip_prepare_n<TX, 64>(q, sms, l);
    case 96: return strip_prepare_n<TX, 96>(q, sms, l);
    case 128: return strip_prepare_n<TX, 128>(q, sms, l);
  }
  return cudaErrorInvalidValue;
}

// The design by shape: strips where the strip geometry takes the call and
// it has strips for at least kStripMinQuarters / 4 of a wave (a strip for
// every pipe the card holds at once: 264 on the H100), the tiles
// elsewhere. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/int8_variants.py, every call of the S8 request at float32 and
// bf16, batch 1 and 8, and of N28's at bf16, batch 128, in both designs):
// the calls of 0.91 of a wave or more ran faster as strips (every N28
// call, 1.9-58 waves: by 17-60%; S8 batch 8's 240x320 and 120x160 convs,
// its float32 60x80 heads and its bf16 convs_5: by 4-39%), but for S8
// batch 8's float32 conv4b (5% slower); those of 0.45 or less ran slower
// (S8 batch 8's conv4a, the bf16 60x80 heads and the 30x40 convs: by
// 14-257%; every S8 batch 1 call: 1.2-4.7x).
constexpr int kStripMinQuarters = 3;

// [grid.x, grid.y, shared-memory bytes, blocks an SM, SMs, weights
// resident (1) or streamed (0), their K chunk, staged channels (strips:
// channels, or int8 rows, a chunk), chunks a tile, channels a warp (strips:
// a warpgroup's), tile rows, design (0 tiles, 1 strips), tile columns,
// input stages, consumer warpgroups a block (strips), m-blocks a strip]
constexpr int kShapeLen = 16;

// The tile: 8 rows, each warp a row and every channel, for up to 32
// channels (the backbone's wide maps); 4 rows, each row two warps of half
// the channels, beyond 64 channels (up to 256) and wherever 8-row tiles
// would not cut the rounds of tiles a block walks to under 3 / 5 of the
// 4-row tiles' (an 8-row tile's halo is 5 / 3 of a 4-row tile's). So a
// 60x80 map at batch 1 runs 75 tiles on 75 SMs, and a 120x160 map runs in
// 8-row tiles.
template <typename TX, bool VEC>
cudaError_t dispatch(const Params& p, cudaStream_t stream, int* shape) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  StripParams q;
  if (strip_geometry<TX>(p, q)) {
    StripLaunch sl{};
    if ((err = strip_prepare<TX>(q, sms, sl)) != cudaSuccess) return err;
    if (4 * q.nstrips >=
        kStripMinQuarters * kStripPipes * sl.per_sm * sms) {
      if (shape != nullptr) {
        const int s[kShapeLen] = {
            sl.grid, 1, q.smem, sl.per_sm, sms, 1, 32 * q.NK, q.CC,
            q.x_int8 ? (q.R + 1 + q.CC) / q.CC : (q.Cin + q.CC - 1) / q.CC,
            q.Cout, q.R, 1, q.TW, q.S, kStripPipes * strip_wgs(q.Cout),
            q.mblocks};
        for (int i = 0; i < kShapeLen; ++i) shape[i] = s[i];
        return cudaSuccess;
      }
      sl.kernel<<<sl.grid, strip_threads(q.Cout), q.smem, stream>>>(sl.p);
      return cudaGetLastError();
    }
  }
  Launch l{};
  if (p.Cout <= 32) {
    err = prepare_th8<TX, VEC>(p, sms, l);
  } else {
    err = prepare_th4<TX, VEC>(p, sms, l);
    Launch l8{};
    if (err == cudaSuccess && p.Cout <= 64 &&
        prepare_th8<TX, VEC>(p, sms, l8) == cudaSuccess &&
        5 * l8.waves() < 3 * l.waves())
      l = l8;
  }
  if (err != cudaSuccess) return err;
  if (shape != nullptr) {
    const Params& q = l.p;
    const int s[kShapeLen] = {int(l.grid.x), int(l.grid.y), q.smem, l.per_sm,
                              sms, q.KC == q.Kpad, q.KC, q.CC, q.nch,
                              l.warp_channels, l.th, 0, kTW, kRing, 0, 0};
    for (int i = 0; i < kShapeLen; ++i) shape[i] = s[i];
    return cudaSuccess;
  }
  l.kernel<<<l.grid, kThreads, l.p.smem, stream>>>(l.p);
  return cudaGetLastError();
}

}  // namespace

// dispatch<bf16, VEC>, the bf16 blocks' instances, compiled in
// int8conv_bf16.cu (a translation unit of its own, so that nvcc builds the
// two sets of instances in parallel)
cudaError_t dispatch_bf16(const Params& p, bool vec, cudaStream_t stream,
                          int* shape);

}  // namespace nvs_int8
