// Int8 3x3 convolution: the bfloat16 blocks' instances of the kernel
// (int8conv.cuh: a bf16 map, staged as bf16, or int8 codes in; the bf16
// block's rounding and a bf16 output), in a translation unit of their own
// so that they compile beside int8conv.cu's.
#include "int8conv.cuh"

namespace nvs_int8 {

cudaError_t dispatch_bf16(const Params& p, bool vec, cudaStream_t stream,
                          int* shape) {
  return vec ? dispatch<bf16, true>(p, stream, shape)
             : dispatch<bf16, false>(p, stream, shape);
}

}  // namespace nvs_int8
