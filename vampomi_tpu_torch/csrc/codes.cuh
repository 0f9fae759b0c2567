// Exact f32 decodes of the design's bytes, shared by the kernels of the
// int8, packed-int4 and bf16 designs.
//
// A design byte holds P codes:
//   P = 1  int8: one code in [-127, 127] (ops/operator.py quantize_markers);
//   P = 2  packed int4: two nibbles biased by +8, the low one the code of
//          sample j, the high one the code of sample j + N/2, both in
//          [-8, 7] (ops/operator.py pack_nibbles_host).
// Byte j of a row of nb bytes thus carries the codes of samples p*nb + j,
// p < P, and a row holds N = P*nb samples.  A bf16 element takes two bytes
// (`Bf16` below).
//
// The row-blocked templates xy.cuh and xtw.cuh read a row as units of UB
// bytes (one sample each per half, P halves: N = P*nb/UB) and 16-byte loads
// as quads: four consecutive samples of each half, from WPQ words.  Each
// decode type gives P, UB and WPQ, `quad` (a quad of a 16-byte load),
// `quad_at` (a quad from its words) and `unit` (unit j of a row).
//
// Every code is upcast to f32 exactly.  Instead of an int->float conversion
// per code, a biased byte value v in [0, 255] is placed in the low mantissa
// bits of 2^23 with one byte permute: the bit pattern 0x4B000000 | v is the
// float 2^23 + v exactly, and subtracting 2^23 + bias (exact: both values
// and the difference are integers below 2^24) leaves the code.  That is one
// integer-pipe permute and one FP32 add per code, where a conversion per code
// would run on the narrower conversion unit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vampomi {

constexpr float kTwo23 = 8388608.0f;

// code of byte i (0..3, a compile-time constant after unrolling) of u,
// whose bytes hold biased values code + BIAS
template <int BIAS>
__device__ __forceinline__ float biased_byte(unsigned u, int i) {
  const unsigned bits = __byte_perm(u, 0x4B000000u, 0x7440u | static_cast<unsigned>(i));
  return __int_as_float(static_cast<int>(bits)) - (kTwo23 + static_cast<float>(BIAS));
}

template <int P>
struct Codes;

// int8: flipping the sign bit of each byte turns code c into c + 128
template <>
struct Codes<1> {
  // codes of the four bytes of a little-endian word: c[0][i] is byte i
  __device__ static __forceinline__ void word(unsigned w, float (&c)[1][4]) {
    const unsigned u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) c[0][i] = biased_byte<128>(u, i);
  }
  __device__ static __forceinline__ void byte(unsigned b, float (&c)[1]) {
    c[0] = static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b)));
  }
};

// packed int4: c[0][i] the low nibble of byte i, c[1][i] the high nibble
template <>
struct Codes<2> {
  __device__ static __forceinline__ void word(unsigned w, float (&c)[2][4]) {
    const unsigned lo = w & 0x0F0F0F0Fu;
    const unsigned hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[0][i] = biased_byte<8>(lo, i);
      c[1][i] = biased_byte<8>(hi, i);
    }
  }
  __device__ static __forceinline__ void byte(unsigned b, float (&c)[2]) {
    c[0] = static_cast<float>(static_cast<int>(b & 15u) - 8);
    c[1] = static_cast<float>(static_cast<int>((b >> 4) & 15u) - 8);
  }
};

// the codes of a packed word's eight nibbles as two words of signed bytes:
// byte i of `lo` (of `hi`) is the code of byte i's low (high) nibble, the
// nibble minus its bias of 8 in each byte apart (no carry between bytes)
__device__ __forceinline__ void nibble_codes(unsigned w, unsigned& lo, unsigned& hi) {
  lo = __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
  hi = __vsub4((w >> 4) & 0x0F0F0F0Fu, 0x08080808u);
}

__device__ __forceinline__ unsigned pick(const uint4& v, int k) {
  // register select (no local-memory array indexing)
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// the template interface of the byte decodes: a quad is one word
template <int P_>
struct ByteCodes : Codes<P_> {
  static constexpr int P = P_, UB = 1, WPQ = 1;
  __device__ static __forceinline__ void quad(const uint4& v, int q, float (&c)[P_][4]) {
    Codes<P_>::word(pick(v, q), c);
  }
  __device__ static __forceinline__ void quad_at(const unsigned* w, float (&c)[P_][4]) {
    Codes<P_>::word(w[0], c);
  }
  __device__ static __forceinline__ void unit(const uint8_t* row, long long j, float (&c)[P_]) {
    Codes<P_>::byte(__ldg(row + j), c);
  }
};

// bf16: an element is the upper half of an f32, so it widens exactly by
// its bits shifted left 16; a little-endian word holds element 2i in its
// low half and 2i + 1 in its high half, and a quad takes two words
struct Bf16 {
  static constexpr int P = 1, UB = 2, WPQ = 2;
  __device__ static __forceinline__ void pair(unsigned w, float& a, float& b) {
    a = __uint_as_float(w << 16);
    b = __uint_as_float(w & 0xFFFF0000u);
  }
  __device__ static __forceinline__ void quad(const uint4& v, int q, float (&c)[1][4]) {
    pair(pick(v, 2 * q), c[0][0], c[0][1]);
    pair(pick(v, 2 * q + 1), c[0][2], c[0][3]);
  }
  __device__ static __forceinline__ void quad_at(const unsigned* w, float (&c)[1][4]) {
    pair(w[0], c[0][0], c[0][1]);
    pair(w[1], c[0][2], c[0][3]);
  }
  __device__ static __forceinline__ void unit(const uint8_t* row, long long j, float (&c)[1]) {
    const unsigned h = __ldg(reinterpret_cast<const unsigned short*>(row) + j);
    c[0] = __uint_as_float(h << 16);
  }
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// resident blocks of `kernel` on the whole card at `threads` threads and
// `smem` bytes of dynamic shared memory each (at least one)
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<long long>(sms) * (per_sm < 1 ? 1 : per_sm);
  return cudaSuccess;
}

}  // namespace vampomi
