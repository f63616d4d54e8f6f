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
// Bound: at config S's widths (Cin 3..96, Cout 16..128) the int8 products
// need ~10-170 operations a byte moved, below the H100's ~590 int8
// operations a byte, so bytes bound it. On this card what bounds a call of
// the S8 request is latency: a block's chain of copies, quantisation,
// products and epilogue, and how many such chains an SM keeps in flight:
// a float halo walked one dependent load and IEEE division a thread at a
// time, one 8x16 tile a block (40 blocks at 60x80) and the weights copied
// again for every tile leave it latency-bound, and the design below takes
// each of these away.
//
// Design: an implicit GEMM with M = pixels, N = Cout, K = 9 Cin in (tap,
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
#pragma once

#include <cmath>
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

// [grid.x, grid.y, shared-memory bytes, blocks an SM, SMs, weights
// resident (1) or streamed (0), their K chunk, staged channels, chunks a
// tile, channels a warp, tile rows]
constexpr int kShapeLen = 11;

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
                              l.warp_channels, l.th};
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
