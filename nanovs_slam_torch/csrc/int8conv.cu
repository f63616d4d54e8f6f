// Int8 3x3 convolution: the C interface and the float32 blocks' instances
// of the kernel (a float32 map or int8 codes in). The kernel, its design and
// its launch plan are int8conv.cuh's; int8conv_bf16.cu compiles the
// bfloat16 blocks' instances.
#include "int8conv.cuh"

namespace nvs_int8 {
namespace {

// the instances of the block's type
template <bool VEC>
cudaError_t dispatch_x(const Params& p, bool bf16_block, cudaStream_t stream,
                       int* shape) {
  return bf16_block ? dispatch_bf16(p, VEC, stream, shape)
                    : dispatch<float, VEC>(p, stream, shape);
}

int run(const void* x, int x_type, const void* w, const void* m,
        const void* a, const void* b, void* out, int out_mode, int out_bf16,
        int B, int H, int W, int Cin, int Cout, int Kpad, float scale_in,
        float out_scale, float slope, void* stream, int* shape) {
  Params p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.m = static_cast<const float*>(m);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.out = out;
  p.x_int8 = x_type == kXInt8;
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
  p.rcp_in = reciprocal(scale_in);
  p.rcp_out = reciprocal(out_scale);
  const bool own_type = p.x_int8 || (x_type == kXBF16) == (out_bf16 != 0);
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout % 8 != 0 ||
      Kpad % 32 != 0 || Kpad < 9 * Cin || x_type < kXF32 ||
      x_type > kXBF16 || !own_type)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (p.x_int8)
    p.copy = Cin % 16 == 0 && xa % 16 == 0  ? kCopy16
             : Cin % 4 == 0 && xa % 4 == 0 ? kCopy4 : kCopySync;
  else if (x_type == kXF32)
    p.copy = W % 4 == 0 && xa % 16 == 0 ? kCopy16 : kCopy4;
  else  // bf16: the value by value path loads
    p.copy = W % 8 == 0 && xa % 16 == 0 ? kCopy16 : kCopySync;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin % 4 == 0) {
    // 16 bytes times an odd number: the eight pixels of a fragment's rows
    // fall on distinct banks
    int ps = round_up(Cin, 16);
    if ((ps / 16) % 2 == 0) ps += 16;
    p.PS = ps;
    return static_cast<int>(dispatch_x<true>(p, out_bf16, s, shape));
  }
  p.PS = round_up(Cin, 4);
  return static_cast<int>(dispatch_x<false>(p, out_bf16, s, shape));
}

}  // namespace
}  // namespace nvs_int8

using nvs_int8::run;

// x_type: 0 float32 NCHW, 1 int8 NHWC codes, 2 bfloat16 NCHW; out_bf16:
// the block computes in bf16 (its rounding, and a bf16 float output); a
// float map is of the block's type
extern "C" int nvs_int8_conv3x3(const void* x, int x_type, const void* w,
                                const void* m, const void* a, const void* b,
                                void* out, int out_mode, int out_bf16, int B,
                                int H, int W, int Cin, int Cout, int Kpad,
                                float scale_in, float out_scale, float slope,
                                void* stream) {
  return run(x, x_type, w, m, a, b, out, out_mode, out_bf16, B, H, W, Cin,
             Cout, Kpad, scale_in, out_scale, slope, stream, nullptr);
}

// The launch nvs_int8_conv3x3 would make for these shapes (kShapeLen ints
// into shape; nothing is launched).
extern "C" int nvs_int8_conv3x3_shape(int x_type, int out_mode,
                                      int out_bf16, int B, int H, int W,
                                      int Cin, int Cout, int Kpad,
                                      int* shape) {
  // a 16-byte-aligned input, as the allocator gives
  return run(reinterpret_cast<const void*>(256), x_type, nullptr, nullptr,
             nullptr, nullptr, nullptr, out_mode, out_bf16, B, H, W, Cin,
             Cout, Kpad, 1.f, 1.f, 0.f, nullptr, shape);
}
