// Building blocks shared by the port's tensor-core kernels: split TF32
// ("3xTF32") products on mma.sync, and cp.async copies with zero fill.
//
// Split TF32 keeps fp32 accuracy on the TF32 tensor cores: each fp32 operand
// x is split as hi = tf32_rna(x), lo = tf32_rna(x - hi), and a product is
// taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b (small terms first), summed in
// fp32 registers. The dropped lo*lo term and the rounding of lo are about
// 2^-22 of |a*b|, against 2^-11 for one TF32 pass.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace di {

// cvt.rna.tf32.f32 (nearest, ties away from zero) of a finite x, bit for
// bit: add half of the 13 dropped mantissa bits' range to the sign-magnitude
// pattern and clear them. Two integer operations issue faster than the
// conversion instruction, which bounded both kernels on the H100 (PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo), both TF32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a * b on one m16n8k8 TF32 tile (fp32 accumulate). Fragments, with
// g = lane / 4 and t = lane % 4:
//   a[0..3] = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]
//   b[0..1] = B[t][g], B[t+4][g]
//   d[0..3] = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at fp32 accuracy from split operands
__device__ __forceinline__ void mma_split(float* d, const uint32_t* ahi, const uint32_t* alo,
                                          const uint32_t* bhi, const uint32_t* blo) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// 16-byte (or 4-byte) asynchronous global -> shared copy; with pred false
// nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace di
