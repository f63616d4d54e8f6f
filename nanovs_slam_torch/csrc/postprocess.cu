// Fused inference postprocess for KP2DTiny.
//
// Replaces the TPU kernel nanovs_slam_tpu/ops/pallas/postprocess_kernel.py
// (fused_postprocess_pallas). For every cell (i, j) of the (Hc, Wc) grid:
//   score  <- score with a one-cell border zeroed;
//   coord  <- clip(j*cell + (cell-1)/2 + s*cross_ratio*(cell-1)/2) per axis;
//   desc   <- bilinear, align_corners, zero-padded sample of the dense
//             descriptor map (B, Hf, Wf, C) at coord, L2-normalised by
//             max(||v||, 1e-12).
// The TPU kernel computed the sample as a 36-tap hat stencil over stride-2
// phase planes because Mosaic has no gather; here each thread reads the 4
// bilinear taps directly.
//
// Design: the model hands the kernel NHWC views of NCHW conv outputs, so
// neighbouring channels of the descriptor map lie Hf*Wf floats apart and
// neighbouring cells' taps about 2 floats apart. A block takes 32
// consecutive cells (flattened over b, i, j), one a lane, and its 8 warps
// split the channels (warp w takes w, w + 8, ...): for one channel and one
// tap row a warp's loads cover about 66 contiguous floats, and at batch 1
// the 4,800 cells still make 1,200 warps. Each value goes into a shared-
// memory tile [cell][C + 1] (an odd stride: the lanes' cells fall on
// distinct banks); the warps' partial sums of squares give each cell's
// norm; then the block writes its 32*C descriptors as contiguous NHWC lines.
// Score and coordinate reads and writes are coalesced along the cell row.
// The bfloat16 instance reads bf16 score, shift and descriptors and computes
// and writes float32, as the TPU kernel reads any float type as float32.
//
// Bound on an H100: memory. At 240x320 with C = 32 a frame reads 2.5 MB of
// descriptors (1.2 MB in bf16) and writes 0.7 MB, about 1 us at 3.35 TB/s;
// at batch 1 the launch dominates. KeypointFormer hands it C = 256 (its
// "default" config) at 256x320: 5.2 MB read and 1.3 MB written a frame,
// about 2 us. Up to C = 256 the tile stays in static shared memory (34 KB
// with the norms' partials); each warp takes ceil(C / 8) channels. Inputs
// are taken through their strides, so the NCHW conv output is read in
// place (no transpose), and any layout is right; outputs are NHWC.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kCells = 32;  // cells a block, one a lane
constexpr int kWarps = 8;   // channel groups
constexpr int kMaxChannels = 256;  // s_desc: 32 x 257 floats, 32.9 KB

template <typename T>
__global__ void __launch_bounds__(kCells * kWarps) postprocess_kernel(
    const T* __restrict__ score, long long ss_b, long long ss_h,
    long long ss_w, const T* __restrict__ shift, long long sh_b,
    long long sh_h, long long sh_w, long long sh_c,
    const T* __restrict__ feat, long long sf_b, long long sf_h,
    long long sf_w, long long sf_c, float* __restrict__ score_out,
    float* __restrict__ coord_out, float* __restrict__ desc_out, int B,
    int Hc, int Wc, int Hf, int Wf, int C, int H, int W, float cellf,
    float step, float shift_scale) {
  __shared__ float s_desc[kCells * (kMaxChannels + 1)];
  __shared__ float s_ss[kWarps][kCells];
  __shared__ float s_norm[kCells];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_cells = (long long)B * Hc * Wc;
  const long long cell0 = (long long)blockIdx.x * kCells;
  const bool live = cell0 + lane < n_cells;
  // a lane past the last cell decodes that cell again and stores nothing
  const long long cell = live ? cell0 + lane : n_cells - 1;
  const int j = (int)(cell % Wc);
  const int i = (int)((cell / Wc) % Hc);
  const long long b = cell / ((long long)Hc * Wc);

  // coordinate decode, in the order of ops/grid.decode_coords and with its
  // roundings (no fused multiply-add), so the coords match it bit for bit
  const T* sp = shift + b * sh_b + i * sh_h + j * sh_w;
  const float bx = __fadd_rn(__fmul_rn((float)j, cellf), step);
  const float by = __fadd_rn(__fmul_rn((float)i, cellf), step);
  const float cx = fminf(
      fmaxf(__fadd_rn(bx, __fmul_rn(nvs::to_f32(sp[0]), shift_scale)), 0.f),
      (float)(W - 1));
  const float cy = fminf(
      fmaxf(__fadd_rn(by, __fmul_rn(nvs::to_f32(sp[sh_c]), shift_scale)),
            0.f),
      (float)(H - 1));
  if (warp == 0 && live) {
    const bool inner = i > 0 && i < Hc - 1 && j > 0 && j < Wc - 1;
    const float s = nvs::to_f32(score[b * ss_b + i * ss_h + j * ss_w]);
    score_out[cell] = inner ? s : 0.f;
    reinterpret_cast<float2*>(coord_out)[cell] = make_float2(cx, cy);
  }

  // image coords -> [-1, 1] -> feature-map pixels (ops/grid_sample order)
  const float gx = cx / ((float)(W - 1) * 0.5f) - 1.f;
  const float gy = cy / ((float)(H - 1) * 0.5f) - 1.f;
  const float px = (gx + 1.f) * 0.5f * (float)(Wf - 1);
  const float py = (gy + 1.f) * 0.5f * (float)(Hf - 1);
  const float fx = floorf(px), fy = floorf(py);
  const float wx = px - fx, wy = py - fy;
  const int x0 = (int)fx, y0 = (int)fy, x1 = x0 + 1, y1 = y0 + 1;
  const bool ix0 = x0 >= 0 && x0 < Wf, ix1 = x1 >= 0 && x1 < Wf;
  const bool iy0 = y0 >= 0 && y0 < Hf, iy1 = y1 >= 0 && y1 < Hf;
  const T* fb = feat + b * sf_b;

  const int stride = C + 1;
  float ss = 0.f;
#pragma unroll 4
  for (int c = warp; c < C; c += kWarps) {
    const T* fc = fb + c * sf_c;
    const float v00 =
        (iy0 && ix0) ? nvs::to_f32(fc[y0 * sf_h + x0 * sf_w]) : 0.f;
    const float v01 =
        (iy0 && ix1) ? nvs::to_f32(fc[y0 * sf_h + x1 * sf_w]) : 0.f;
    const float v10 =
        (iy1 && ix0) ? nvs::to_f32(fc[y1 * sf_h + x0 * sf_w]) : 0.f;
    const float v11 =
        (iy1 && ix1) ? nvs::to_f32(fc[y1 * sf_h + x1 * sf_w]) : 0.f;
    const float top = v00 * (1.f - wx) + v01 * wx;
    const float bot = v10 * (1.f - wx) + v11 * wx;
    const float v = top * (1.f - wy) + bot * wy;
    s_desc[lane * stride + c] = v;
    ss += v * v;
  }
  s_ss[warp][lane] = ss;
  __syncthreads();
  if (warp == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_ss[w][lane];
    s_norm[lane] = fmaxf(sqrtf(total), 1e-12f);
  }
  __syncthreads();
  const int n = (int)min((long long)kCells, n_cells - cell0);
  float* out = desc_out + cell0 * C;
  for (int e = threadIdx.x; e < n * C; e += kCells * kWarps) {
    const int k = e / C;
    out[e] = s_desc[k * stride + e - k * C] / s_norm[k];
  }
}

template <typename T>
int launch(const T* score, const long long* ss, const T* shift,
           const long long* sh, const T* feat, const long long* sf,
           float* score_out, float* coord_out, float* desc_out, int B, int Hc,
           int Wc, int Hf, int Wf, int C, int H, int W, int cell,
           float cross_ratio, cudaStream_t stream) {
  if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
  const long long cells = (long long)B * Hc * Wc;
  const long long blocks = (cells + kCells - 1) / kCells;
  const float step = (cell - 1) / 2.0f;
  postprocess_kernel<T><<<(unsigned)blocks, kCells * kWarps, 0, stream>>>(
      score, ss[0], ss[1], ss[2], shift, sh[0], sh[1], sh[2], sh[3], feat,
      sf[0], sf[1], sf[2], sf[3], score_out, coord_out, desc_out, B, Hc, Wc,
      Hf, Wf, C, H, W, (float)cell, step, cross_ratio * step);
  return (int)cudaGetLastError();
}

}  // namespace

// score (B,Hc,Wc,1), shift (B,Hc,Wc,2), feat (B,Hf,Wf,C) float32 with
// element strides [b, h, w, c]; outputs contiguous NHWC float32.
extern "C" int nvs_postprocess(const float* score, const long long* ss,
                               const float* shift, const long long* sh,
                               const float* feat, const long long* sf,
                               float* score_out, float* coord_out,
                               float* desc_out, int B, int Hc, int Wc, int Hf,
                               int Wf, int C, int H, int W, int cell,
                               float cross_ratio, cudaStream_t stream) {
  return launch(score, ss, shift, sh, feat, sf, score_out, coord_out,
                desc_out, B, Hc, Wc, Hf, Wf, C, H, W, cell, cross_ratio,
                stream);
}

// The same with bfloat16 score, shift and feat; outputs float32.
extern "C" int nvs_postprocess_bf16(const __nv_bfloat16* score,
                                    const long long* ss,
                                    const __nv_bfloat16* shift,
                                    const long long* sh,
                                    const __nv_bfloat16* feat,
                                    const long long* sf, float* score_out,
                                    float* coord_out, float* desc_out, int B,
                                    int Hc, int Wc, int Hf, int Wf, int C,
                                    int H, int W, int cell, float cross_ratio,
                                    cudaStream_t stream) {
  return launch(score, ss, shift, sh, feat, sf, score_out, coord_out,
                desc_out, B, Hc, Wc, Hf, Wf, C, H, W, cell, cross_ratio,
                stream);
}
