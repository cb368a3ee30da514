// bf16 products on mma.sync for the kernels' bf16 variants, which compute
// what the JAX package's Pallas kernels compute on a TPU by default: bf16
// operands, fp32 accumulation. K2's operands arrive in fp32 and are rounded
// to bf16 (round to nearest, ties to even, as XLA's convert) as they are
// staged into shared memory; K1's arrive in bf16. Both reach the fragments
// by ldmatrix.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace di {

// (lo, hi) rounded to bf16 and packed, lo in the low 16 bits: the element
// with the lower k (or column) index of an mma.sync fragment register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x rounded to bf16 and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += a * b on one m16n8k16 bf16 tile (fp32 accumulate). Fragments, with
// g = lane / 4 and t = lane % 4, each register two bf16 (lower k first):
//   a[0..3] = A[g][2t..2t+1], A[g+8][2t..2t+1], A[g][2t+8..2t+9], A[g+8][2t+8..2t+9]
//   b[0..1] = B[2t..2t+1][g], B[2t+8..2t+9][g]
//   d[0..3] = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory, one fragment register each:
// lanes 8i .. 8i + 7 give the row addresses (16 bytes each) of matrix i, and
// lane 4g + t receives row g, elements 2t and 2t + 1 of every matrix
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// The same with each 8 x 8 matrix transposed: lane 4g + t receives
// elements 2t and 2t + 1 of column g (rows 2t and 2t + 1), the B fragment of
// a [k][n] matrix stored k-major
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

}  // namespace di
