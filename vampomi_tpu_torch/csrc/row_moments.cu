// Per-row moments of the quantized design's codes, the sufficient statistics
// of the leave-one-out association test:
//
//   out[m][0] = sum of the codes of marker row m       (int64)
//   out[m][1] = sum of the squares of those codes      (int64)
//
//   row_moments_int8     X (M, N) int8, one code per byte
//   row_moments_packed4  X (M, N/2) uint8, two nibbles per byte biased by +8
//                        (codes.cuh), both counted
//
// It replaces the reductions of the JAX package's `_loo_stats`
// (vampomi_tpu/modes/association.py:78-81, 98-100), which XLA fuses into its
// read of X; there they are no Pallas kernel, and on the card a separate
// torch reduction reads X at a tenth of the memory rate and squares through
// an upcast copy.  The sums are integers, so any order gives the same bits:
// the kernel equals its plain version (int64 chunk sums) bitwise, at any row
// length (a row of N int8 codes of -128 sums its squares to 16,384 N, past
// int32 from N = 131,072 on).
//
// Bound: bytes of X (M*nb in, 16*M out).  The row pattern of the read-floor
// probe `stream_rowsum` (stream.cu) with a second accumulator: one warp per
// row, 16-byte loads with four in flight per lane, and `__dp4a` for the
// arithmetic: `__dp4a(w, 0x01010101, s)` adds a word's four signed bytes and
// `__dp4a(w, w, s2)` their squares, one instruction each; a packed word is
// first split into two words of signed codes (codes.cuh nibble_codes).  The
// `__dp4a` sums stay int32 for one outer step of the load loop (at most
// 4*16*16,384 a lane) and are then folded into the lane's int64 sums.  The
// lanes' int64 sums meet in a `__shfl_xor_sync` butterfly, and lane 0
// writes the row's pair.  Ragged shapes: any M >= 1 and nb >= 1; when a
// 16-byte load does not fit the row length or the pointer, each lane reads
// one byte at a time into its int64 sums.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() of the launch.

#include <cstdint>

#include "codes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;  // 16-byte loads in flight per lane
constexpr int kOnes = 0x01010101;
constexpr long long kMaxGrid = 0x7fffffffLL;

template <int P>
__device__ __forceinline__ void moments_word(unsigned w, int& s, int& s2);

template <>
__device__ __forceinline__ void moments_word<1>(unsigned w, int& s, int& s2) {
  const int q = static_cast<int>(w);
  s = __dp4a(q, kOnes, s);
  s2 = __dp4a(q, q, s2);
}

template <>
__device__ __forceinline__ void moments_word<2>(unsigned w, int& s, int& s2) {
  unsigned lo, hi;
  vampomi::nibble_codes(w, lo, hi);
  const int l = static_cast<int>(lo), h = static_cast<int>(hi);
  s = __dp4a(l, kOnes, s);
  s = __dp4a(h, kOnes, s);
  s2 = __dp4a(l, l, s2);
  s2 = __dp4a(h, h, s2);
}

template <int P>
__device__ __forceinline__ void moments16(const uint4& v, int& s, int& s2) {
  moments_word<P>(v.x, s, s2);
  moments_word<P>(v.y, s, s2);
  moments_word<P>(v.z, s, s2);
  moments_word<P>(v.w, s, s2);
}

template <int P>
__device__ __forceinline__ void moments_byte(unsigned b, long long& s, long long& s2) {
  if constexpr (P == 1) {
    const int q = static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(b)));
    s += q;
    s2 += q * q;
  } else {
    const int lo = static_cast<int>(b & 15u) - 8;
    const int hi = static_cast<int>((b >> 4) & 15u) - 8;
    s += lo + hi;
    s2 += lo * lo + hi * hi;
  }
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

template <int P, bool VEC>
__global__ void __launch_bounds__(kThreads)
row_moments_kernel(const uint8_t* __restrict__ X, longlong2* __restrict__ out, long long M,
                   long long nb) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); row < M;
       row += stride) {
    const uint8_t* xr = X + row * nb;
    long long s = 0, s2 = 0;
    if (VEC) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      const long long n16 = nb >> 4;
      long long c = lane;
      for (; c + (kLoads - 1) * 32 < n16; c += kLoads * 32) {
        uint4 v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) v[u] = __ldg(xv + c + u * 32);
        int t = 0, t2 = 0;  // at most 4*16*16,384 a step: exact in int32
#pragma unroll
        for (int u = 0; u < kLoads; ++u) moments16<P>(v[u], t, t2);
        s += t;
        s2 += t2;
      }
      int t = 0, t2 = 0;  // fewer than kLoads loads left
      for (; c < n16; c += 32) moments16<P>(__ldg(xv + c), t, t2);
      s += t;
      s2 += t2;
    } else {
      for (long long j = lane; j < nb; j += 32) moments_byte<P>(xr[j], s, s2);
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) out[row] = make_longlong2(s, s2);
  }
}

template <int P>
int launch(const void* X, void* out, long long M, long long nb, void* stream) {
  if (M < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* Xp = static_cast<const uint8_t*>(X);
  longlong2* op = static_cast<longlong2*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = nb % 16 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const long long need = (M + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(need > kMaxGrid ? kMaxGrid : need);
  if (vec) {
    row_moments_kernel<P, true><<<grid, kThreads, 0, s>>>(Xp, op, M, nb);
  } else {
    row_moments_kernel<P, false><<<grid, kThreads, 0, s>>>(Xp, op, M, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (M, N) int8; out (M, 2) int64
extern "C" int row_moments_int8_launch(const void* X, void* out, long long M, long long N,
                                       void* stream) {
  return launch<1>(X, out, M, N, stream);
}

// X (M, nb) packed bytes, N = 2 nb codes a row; out (M, 2) int64
extern "C" int row_moments_packed4_launch(const void* X, void* out, long long M, long long nb,
                                          void* stream) {
  return launch<2>(X, out, M, nb, stream);
}
