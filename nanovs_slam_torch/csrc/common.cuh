// Helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace nvs {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

// 3xTF32 on the tensor cores: x = hi + lo with hi = tf32(x) and lo =
// tf32(x - hi); a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi keeps float32
// accuracy (plain TF32 keeps about three digits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// d += a b, one m16n8k8 TF32 product: a 16x8 (row), b 8x8 (col). With g =
// lane / 4 and t = lane % 4: a = {(g, t), (g+8, t), (g, t+4), (g+8, t+4)},
// b = {(t, g), (t+4, g)}, d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
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

// Two floats rounded to bfloat16 (to nearest even) in one register, lo in
// the low half: the order of an mma.sync operand's pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b, one m16n8k16 bfloat16 product with float32 accumulation: a
// 16x16 (row), b 16x8 (col), two bf16 a register with the lower k in the
// low half. With g = lane / 4 and t = lane % 4: a = {(g, 2t..2t+1),
// (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9)}, b = {(2t..2t+1, g),
// (2t+8..2t+9, g)}, d as for mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A float32 or bfloat16 element read as float32.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes global -> shared, zero-filled when !in (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

// ... through L1
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src,
                                              bool in = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

// 4 bytes global -> shared (through L1), zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Hopper's warpgroup products (wgmma.mma_async): a warpgroup of 4 warps
// multiplies a 64-row A held in registers (each warp 16 rows, the fragment
// of an mma.sync m16n8k*) by a B in shared memory that a matrix descriptor
// describes: here K-major without swizzle, core matrices of 8 rows (output
// channels) by 16 bytes, `sbo` bytes apart along N and `lbo` bytes apart
// along K.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo,
                                               int sbo = 128) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// until at most N committed groups of the warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// makes this thread's shared-memory writes (cp.async included) visible to
// later wgmma reads (the async proxy); a barrier then hands them on
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Calls set() once per device, e.g. to raise a kernel's dynamic
// shared-memory limit, which holds for every later launch there. Until a
// call succeeds, each call tries again and returns its error. Every call
// site passes its own lambda, hence its own record of the devices done.
template <typename F>
cudaError_t once_per_device(F set) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev].load()))
    return err;
  err = set();
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

}  // namespace nvs
