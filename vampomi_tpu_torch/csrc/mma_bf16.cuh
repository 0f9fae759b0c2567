// Warp-level bf16 tensor-core products for the matrix-unit probe kernels
// (atx_mxu.cu, mxu_xtw.cuh): one `mma.sync.aligned.m16n8k16.row.col.f32.
// bf16.bf16.f32`, D (16 x 8, f32) += A (16 x 16, bf16) B (16 x 8, bf16).
//
// Fragments (PTX ISA, "Matrix fragments for mma.m16n8k16"), for lane l,
// g = l / 4 and t = l % 4, each 32-bit register two bf16, the lower index in
// the low half:
//   A  a[0] = A[g][2t, 2t+1]     a[1] = A[g+8][2t, 2t+1]
//      a[2] = A[g][2t+8, 2t+9]   a[3] = A[g+8][2t+8, 2t+9]
//   B  b0   = B[2t, 2t+1][g]     b1   = B[2t+8, 2t+9][g]
//   D  d[0] = D[g][2t]  d[1] = D[g][2t+1]  d[2] = D[g+8][2t]  d[3] = D[g+8][2t+1]
// The sum runs over k, so any one-to-one map of the 16 k slots onto the
// data is free as long as A and B use the same one: lane (g, t) holds slots
// {2t, 2t+1, 2t+8, 2t+9} of both, which lets each lane put four contiguous
// data elements there and load them with one wide load.
//
// Codes decode exactly (codes.cuh): an int8 code or a nibble code is an
// integer of magnitude <= 128, exact in bf16's 8-bit significand, so the
// f32 decode's upper half is the bf16 value and packing two codes is one
// byte permute.  Vectors are rounded to bf16 to nearest even, as JAX's
// `astype(bfloat16)` does.  The products of bf16 values are exact in f32;
// the tensor cores' f32 sums do not round like a chain of IEEE f32 adds.

#pragma once

#include <cuda_bf16.h>

#include "codes.cuh"

namespace vampomi {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values exact in bf16 (decoded codes) as one bf16 pair, lo in the
// low half: the upper halves of their f32 bit patterns
__device__ __forceinline__ unsigned pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// two f32 values rounded to bf16 (nearest even) as one pair, lo in the low half
__device__ __forceinline__ unsigned pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 16 bytes of row `xr` from byte `col`, zero where they pass `len` or when
// the row is out of range; VEC: one 16-byte load (len % 16 == 0, aligned)
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* xr, long long col, long long len, bool row_ok) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!row_ok || col >= len) return v;
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(xr + col));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (col + b < len) w[b / 4] |= static_cast<unsigned>(__ldg(xr + col + b)) << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace vampomi
