// Shared by the tensor-core designs of the chunked gated linear
// recurrence (gla_ssd.cu, gla_rwkv6.cu): the chunk length, the strided
// [B, S, H, d] view, the bf16 mma.sync product with f32 accumulators, and
// the hi + lo split that keeps an f32 operand's ~2^-16 relative accuracy
// through bf16 products.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // chunk length (the model's)
constexpr int PAD = 8;         // bf16 row padding: conflict-free fragments
constexpr int LC_ = C + PAD;

struct Strides {               // element strides of a [B, S, H, d] view
  long long b, s, h, d;
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// x = hi + lo to ~2^-16 relative, both bf16
__device__ __forceinline__ void split(float x, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// two neighbouring bf16 of a row as one 32-bit fragment register
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once (call
// outside any graph capture).
template <typename Kernel>
int opt_in(Kernel kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return (int)err;
}

}  // namespace
