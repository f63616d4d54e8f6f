// Int8 3x3 convolution (stride 1, SAME) with folded BatchNorm and
// (Leaky)ReLU: the conv block of int8 serving.
//
// It replaces no Pallas kernel. Its JAX counterpart is XLA's int8
// convolution in nanovs_slam_tpu/quant.py::int8_conv
// (lax.conv_general_dilated on int8 with int32 results), which PyTorch
// lacks on CUDA. The function is kernels/int8conv.py's (its plain twin
// int8_conv3x3_plain): codes q = clip(rint(x / s_in), -127, 127) (an IEEE
// division, as the JAX package divides), int32 sums over 3x3 taps and
// channels, then (float(acc) * m) * a + b and the activation in float32,
// each product and sum rounded on its own (no fused multiply-add), so that
// the kernel and the twin agree bit for bit; out float32 NCHW, or codes at
// the consumer's scale as int8 NHWC, 2x2 max-pooled (floor) for a chained
// pool.
//
// Bound: at config S's widths (Cin 3..96, Cout 16..128) the int8 products
// need ~10-170 operations a byte moved, below the H100's ~590 int8
// operations a byte, so bytes bound it. Design: an implicit GEMM with M =
// pixels, N = Cout, K = 9 Cin in (tap, channel) order zero-padded to a
// multiple of 32, on mma.sync.m16n8k32 s8 x s8 -> s32. A block of 8 warps
// takes an 8x16 tile of output pixels (a warp a row of 16, one m16 tile)
// by up to 128 output channels (grid.y splits more): it loads the 10x18
// halo tile once into shared memory (quantising a float input as it
// loads, so the float map is read once and no code tensor is written), its
// weights in K chunks, and builds each A fragment from the halo tile
// through a table of tap offsets. The epilogue writes float32 straight
// from the accumulators (4 full 32-byte sectors a warp store), or stages
// the codes in shared memory and writes NHWC words, pooling four codes
// with __vmaxs4 first. Shared-memory rows are padded to 16 bytes times an
// odd number, which keeps the fragment loads free of bank conflicts.
// Simple first: no cp.async pipeline, no wgmma.
#include "common.cuh"

namespace {

constexpr int kTH = 8, kTW = 16;  // output tile: a warp a row
constexpr int kHT = kTH + 2, kWT = kTW + 2;  // its halo tile
constexpr int kThreads = 32 * kTH;
constexpr int kFloatOut = 0, kInt8Out = 1;  // 2: int8, 2x2 max-pooled

struct Params {
  const void* x;
  const int8_t* w;  // (Cout, Kpad)
  const float* m;
  const float* a;
  const float* b;
  void* out;
  int x_int8, out_mode;
  int B, H, W, Cin, Cout, K, Kpad;
  int KC;     // weight chunk (k) held in shared memory at a time
  int PS;     // halo tile: bytes a pixel
  int KS;     // weight chunk: bytes a row
  int tiles_x, tiles_y;
  int off_offs, off_w, off_stage;  // shared-memory offsets (bytes)
  float scale_in, out_scale, slope;
};

__device__ __forceinline__ int8_t quantize(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
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

// VEC: Cin % 4 == 0, so four consecutive k share a tap and are one word
// of the halo tile; else (conv1a's Cin = 3) each k is a byte of its own.
// NT: n8 tiles a block (NB = 8 NT output channels).
template <bool VEC, int NT>
__global__ void __launch_bounds__(kThreads)
    int8conv_kernel(const Params p) {
  constexpr int NB = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* tile = reinterpret_cast<int8_t*>(smem);
  int* offs = reinterpret_cast<int*>(smem + p.off_offs);
  int8_t* wsm = reinterpret_cast<int8_t*>(smem + p.off_w);
  int8_t* stage = reinterpret_cast<int8_t*>(smem + p.off_stage);

  const int tid = threadIdx.x;
  int r = blockIdx.x;
  const int tx = r % p.tiles_x;
  r /= p.tiles_x;
  const int ty = r % p.tiles_y;
  const int img = r / p.tiles_y;
  const int n0 = blockIdx.y * NB;
  const int y0 = ty * kTH, x0 = tx * kTW;
  constexpr int npix = kHT * kWT;

  // the halo tile, codes at pixel stride PS; zeros outside the frame (the
  // SAME padding of the code tensor)
  if (p.x_int8) {
    const int8_t* xq = static_cast<const int8_t*>(p.x);
    const int cw = VEC ? p.Cin / 4 : p.Cin;
    for (int i = tid; i < npix * cw; i += kThreads) {
      const int q = i / cw, c = i % cw;
      const int gy = y0 - 1 + q / kWT, gx = x0 - 1 + q % kWT;
      const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      const size_t src = ((static_cast<size_t>(img) * p.H + gy) * p.W + gx)
                         * p.Cin;
      if (VEC) {
        *reinterpret_cast<uint32_t*>(tile + q * p.PS + 4 * c) =
            in ? *reinterpret_cast<const uint32_t*>(xq + src + 4 * c) : 0u;
      } else {
        tile[q * p.PS + c] = in ? xq[src + c] : int8_t(0);
      }
    }
  } else {
    const float* xf = static_cast<const float*>(p.x);
    for (int i = tid; i < npix * p.Cin; i += kThreads) {
      const int c = i / npix, q = i % npix;
      const int gy = y0 - 1 + q / kWT, gx = x0 - 1 + q % kWT;
      int8_t v = 0;
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
        v = quantize(xf[((static_cast<size_t>(img) * p.Cin + c) * p.H + gy)
                        * p.W + gx], p.scale_in);
      tile[q * p.PS + c] = v;
    }
  }
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

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int base0 = (warp * kWT + g) * p.PS;  // pixel (warp, g)
  const int base1 = base0 + 8 * p.PS;         // pixel (warp, g + 8)
  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  for (int k0 = 0; k0 < p.Kpad; k0 += p.KC) {
    const int kc = min(p.KC, p.Kpad - k0);
    __syncthreads();  // the tile and table written; the last chunk used
    const int v16 = kc / 16;
    for (int i = tid; i < NB * v16; i += kThreads) {
      const int n = i / v16, j = i % v16;
      int4 v = make_int4(0, 0, 0, 0);
      if (n0 + n < p.Cout)
        v = *reinterpret_cast<const int4*>(
            p.w + static_cast<size_t>(n0 + n) * p.Kpad + k0 + 16 * j);
      *reinterpret_cast<int4*>(wsm + n * p.KS + 16 * j) = v;
    }
    __syncthreads();
    for (int ks = 0; ks < kc; ks += 32) {
      const int kk = k0 + ks;
      uint32_t a[4];
      if (VEC) {
        const int o0 = offs[kk / 4 + t], o1 = offs[kk / 4 + 4 + t];
        a[0] = lds32(tile + base0 + o0);
        a[1] = lds32(tile + base1 + o0);
        a[2] = lds32(tile + base0 + o1);
        a[3] = lds32(tile + base1 + o1);
      } else {
        a[0] = a[1] = a[2] = a[3] = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o0 = offs[kk + 4 * t + j], o1 = offs[kk + 16 + 4 * t + j];
          a[0] |= uint32_t(uint8_t(tile[base0 + o0])) << (8 * j);
          a[1] |= uint32_t(uint8_t(tile[base1 + o0])) << (8 * j);
          a[2] |= uint32_t(uint8_t(tile[base0 + o1])) << (8 * j);
          a[3] |= uint32_t(uint8_t(tile[base1 + o1])) << (8 * j);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* wr = wsm + (8 * j + g) * p.KS + ks + 4 * t;
        mma_s8(acc[j], a, lds32(wr), lds32(wr + 16));
      }
    }
  }

  // epilogue: rescale, BN, activation
  const int oy = y0 + warp;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cl = 8 * j + 2 * t + (e & 1);  // channel within the block
      const int c = n0 + cl;
      const int ox = x0 + g + 8 * (e >> 1);
      float v = 0.f;
      if (c < p.Cout) {
        v = __fmul_rn(static_cast<float>(acc[j][e]), p.m[c]);
        v = __fadd_rn(__fmul_rn(v, p.a[c]), p.b[c]);
        v = v > 0.f ? v : __fmul_rn(v, p.slope);
      }
      if (p.out_mode == kFloatOut) {
        if (c < p.Cout && oy < p.H && ox < p.W)
          static_cast<float*>(p.out)[((static_cast<size_t>(img) * p.Cout + c)
                                      * p.H + oy) * p.W + ox] = v;
      } else {
        stage[(warp * kTW + g + 8 * (e >> 1)) * NB + cl] =
            quantize(v, p.out_scale);
      }
    }
  }
  if (p.out_mode == kFloatOut) return;
  __syncthreads();
  int8_t* out = static_cast<int8_t*>(p.out);
  constexpr int words = NB / 4;
  if (p.out_mode == kInt8Out) {
    for (int i = tid; i < kTH * kTW * words; i += kThreads) {
      const int q = i / words, c4 = i % words;
      const int yy = y0 + q / kTW, xx = x0 + q % kTW;
      if (yy < p.H && xx < p.W && n0 + 4 * c4 < p.Cout)
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<size_t>(img) * p.H + yy) * p.W + xx) * p.Cout
            + n0 + 4 * c4) = lds32(stage + q * NB + 4 * c4);
    }
  } else {  // 2x2 max-pool of the codes (floor on odd sizes)
    const int Ho = p.H / 2, Wo = p.W / 2;
    constexpr int PH = kTH / 2, PW = kTW / 2;
    for (int i = tid; i < PH * PW * words; i += kThreads) {
      const int q = i / words, c4 = i % words;
      const int py = q / PW, px = q % PW;
      const int yy = y0 / 2 + py, xx = x0 / 2 + px;
      if (yy < Ho && xx < Wo && n0 + 4 * c4 < p.Cout) {
        const int8_t* s = stage + ((2 * py) * kTW + 2 * px) * NB + 4 * c4;
        const uint32_t v = __vmaxs4(__vmaxs4(lds32(s), lds32(s + NB)),
                                    __vmaxs4(lds32(s + kTW * NB),
                                             lds32(s + (kTW + 1) * NB)));
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<size_t>(img) * Ho + yy) * Wo + xx) * p.Cout
            + n0 + 4 * c4) = v;
      }
    }
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <bool VEC, int NT>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int NB = 8 * NT;
  // weight chunk: up to 64 KB a block
  p.KC = min(p.Kpad, max(32, (65536 / NB - 16) / 32 * 32));
  p.KS = p.KC + 16;  // KC / 16 is even: +16 makes it odd
  p.off_offs = round_up(kHT * kWT * p.PS, 16);
  p.off_w = p.off_offs + round_up(4 * (VEC ? p.Kpad / 4 : p.Kpad), 16);
  p.off_stage = p.off_w + NB * p.KS;
  const int smem = p.off_stage + (p.out_mode == kFloatOut ? 0 : kTH * kTW * NB);
  cudaError_t err = nvs::once_per_device([] {
    return cudaFuncSetAttribute(int8conv_kernel<VEC, NT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                227 * 1024);
  });
  if (err != cudaSuccess) return err;
  p.tiles_x = (p.W + kTW - 1) / kTW;
  p.tiles_y = (p.H + kTH - 1) / kTH;
  const dim3 grid(p.B * p.tiles_x * p.tiles_y, (p.Cout + NB - 1) / NB);
  int8conv_kernel<VEC, NT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  const int nt = (p.Cout + 7) / 8;
  if (nt <= 2) return launch<VEC, 2>(p, stream);
  if (nt <= 4) return launch<VEC, 4>(p, stream);
  if (nt <= 8) return launch<VEC, 8>(p, stream);
  return launch<VEC, 16>(p, stream);
}

}  // namespace

extern "C" int nvs_int8_conv3x3(const void* x, int x_int8, const void* w,
                                const void* m, const void* a, const void* b,
                                void* out, int out_mode, int B, int H, int W,
                                int Cin, int Cout, int Kpad, float scale_in,
                                float out_scale, float slope, void* stream) {
  Params p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.m = static_cast<const float*>(m);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.out = out;
  p.x_int8 = x_int8;
  p.out_mode = out_mode;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.K = 9 * Cin;
  p.Kpad = Kpad;
  p.scale_in = scale_in;
  p.out_scale = out_scale;
  p.slope = slope;
  if (B <= 0 || H <= 0 || W <= 0 || Cout % 8 != 0 || Kpad % 32 != 0 ||
      Kpad < 9 * Cin)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin % 4 == 0) {
    // 16 bytes times an odd number: the eight pixels of a fragment's rows
    // fall on distinct banks
    int ps = round_up(Cin, 16);
    if ((ps / 16) % 2 == 0) ps += 16;
    p.PS = ps;
    return static_cast<int>(dispatch<true>(p, s));
  }
  p.PS = round_up(Cin, 4);
  return static_cast<int>(dispatch<false>(p, s));
}
