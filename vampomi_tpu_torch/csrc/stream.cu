// The card's HBM read floor: every byte of an int8 (M, N) X read once and
// summed as int32, with the least compute that cannot be elided.
//
//   stream_sum     out[0]    = sum of all M*N bytes, int32 wraparound
//   stream_rowsum  out[m]    = sum of row m's N bytes, int32 (the write
//                              pattern of the atx matvec: one int per row)
//
// They replace the TPU Pallas probe kernels `stream_sum` and `stream_rowsum`
// (tools/matvec_floor_probe.py:83-109, 112-132).  Integer addition modulo
// 2^32 gives the same bits in any order, so the results are bitwise
// repeatable and equal the plain int64 sums wrapped to int32.  The TPU
// `stream_sum` runs a grid of M // TM steps and so drops the last M mod TM
// rows; these sum every row.
//
// Bound: bytes of X and nothing else, which is the point of a floor probe.
// Each lane reads 16 bytes per load and keeps four loads in flight, and
// `__dp4a(word, 0x01010101, acc)` adds the four signed bytes of a word in
// one instruction, so the integer pipe never limits the stream.  The grid
// covers X once: on the H100 that streams 2-4% faster than persistent
// blocks walking X with a grid stride (PERF.md).
//   * stream_sum: X as one flat byte array cut into 16 KiB chunks, one per
//     block (neighbouring lanes on neighbouring 16 bytes); each block adds
//     its partial into out[0] with one integer atomic (exact, so the order
//     does not matter; out[0] must be zero before the launch).
//   * stream_rowsum: one warp per row, as atx_int8.cu; the lane sums meet in
//     a warp-shuffle tree and lane 0 writes the row's sum.
// Ragged shapes: any M >= 1 and N >= 1; when a 16-byte load does not fit
// the shape or the pointer the kernels read one byte per lane instead.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() of the launch.

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kOnes = 0x01010101u;

// the sum of the 16 signed bytes of v added to acc
__device__ __forceinline__ int sum16(const uint4& v, int acc) {
  acc = __dp4a(static_cast<int>(v.x), static_cast<int>(kOnes), acc);
  acc = __dp4a(static_cast<int>(v.y), static_cast<int>(kOnes), acc);
  acc = __dp4a(static_cast<int>(v.z), static_cast<int>(kOnes), acc);
  return __dp4a(static_cast<int>(v.w), static_cast<int>(kOnes), acc);
}

__device__ __forceinline__ unsigned warp_usum(unsigned s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

constexpr int kLoads = 4;                          // 16-byte loads in flight per lane
constexpr long long kChunk = kThreads * kLoads;    // 16-byte words per stream_sum block
constexpr long long kMaxGrid = 0x7fffffffLL;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
stream_sum_kernel(const int8_t* __restrict__ X, long long bytes, unsigned* __restrict__ out) {
  int acc = 0;
  long long tail = 0;  // first byte the 16-byte loads do not cover
  if (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(X);
    const long long n16 = bytes >> 4;
    for (long long i = blockIdx.x * kChunk + threadIdx.x; i < n16; i += gridDim.x * kChunk) {
      if (i + (kLoads - 1) * kThreads < n16) {
        uint4 v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) v[u] = __ldg(xv + i + u * kThreads);
#pragma unroll
        for (int u = 0; u < kLoads; ++u) acc = sum16(v[u], acc);
      } else {
        for (long long j = i; j < n16 && j < i + kChunk; j += kThreads)
          acc = sum16(__ldg(xv + j), acc);
      }
    }
    tail = n16 << 4;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long b = tail + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; b < bytes;
       b += stride)
    acc += static_cast<int>(X[b]);

  __shared__ unsigned warp_part[kWarps];
  const unsigned s = warp_usum(static_cast<unsigned>(acc));
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned block = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) block += warp_part[w];
    atomicAdd(out, block);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
stream_rowsum_kernel(const int8_t* __restrict__ X, int* __restrict__ out, long long M, long long N) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); row < M;
       row += stride) {
    const int8_t* xr = X + row * N;
    int acc = 0;
    if (VEC) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      const long long n16 = N >> 4;
      long long c = lane;
      for (; c + (kLoads - 1) * 32 < n16; c += kLoads * 32) {
        uint4 v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) v[u] = __ldg(xv + c + u * 32);
#pragma unroll
        for (int u = 0; u < kLoads; ++u) acc = sum16(v[u], acc);
      }
      for (; c < n16; c += 32) acc = sum16(__ldg(xv + c), acc);
    } else {
      for (long long n = lane; n < N; n += 32) acc += static_cast<int>(xr[n]);
    }
    const unsigned s = warp_usum(static_cast<unsigned>(acc));
    if (lane == 0) out[row] = static_cast<int>(s);
  }
}

unsigned grid_for(long long need) {
  return static_cast<unsigned>(need < 1 ? 1 : (need > kMaxGrid ? kMaxGrid : need));
}

}  // namespace

// out: one int32, zeroed by the caller before the launch
extern "C" int stream_sum_launch(const void* X, void* out, long long M, long long N, void* stream) {
  if (M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* Xp = static_cast<const int8_t*>(X);
  unsigned* op = static_cast<unsigned*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bytes = M * N;
  if (reinterpret_cast<uintptr_t>(X) % 16 == 0) {
    const unsigned grid = grid_for((bytes / 16 + kChunk - 1) / kChunk);
    stream_sum_kernel<true><<<grid, kThreads, 0, s>>>(Xp, bytes, op);
  } else {
    const unsigned grid = grid_for((bytes + kThreads - 1) / kThreads);
    stream_sum_kernel<false><<<grid, kThreads, 0, s>>>(Xp, bytes, op);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: (M,) int32
extern "C" int stream_rowsum_launch(const void* X, void* out, long long M, long long N,
                                    void* stream) {
  if (M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* Xp = static_cast<const int8_t*>(X);
  int* op = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const unsigned grid = grid_for((M + kWarps - 1) / kWarps);
  if (vec) {
    stream_rowsum_kernel<true><<<grid, kThreads, 0, s>>>(Xp, op, M, N);
  } else {
    stream_rowsum_kernel<false><<<grid, kThreads, 0, s>>>(Xp, op, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}
