// v[m] = sum_n float(X[m, n]) * y[n]: the int8 design-matrix A^T y matvec.
//
// Replaces the TPU Pallas kernel `_atx_kernel` / `atx_int8_raw`
// (vampomi_tpu/ops/pallas_matvec.py:55-86) and computes exactly what it
// computes: every int8 code is upcast exactly to f32, multiplied by the f32
// y entry, and summed in f32.  y is never rounded to a narrower type.
//
// Bound: bytes of X.  One pass reads M*N bytes (10.0 GiB at the
// M = 1,048,576 x N = 10,240 north-star shape) against 4*N bytes of y and
// 4*M bytes of output, at two FLOPs per byte, so HBM bandwidth is the limit.
// The design keeps the X stream coalesced and wide and takes everything else
// off the memory bus:
//   * one warp per row; each lane loads 16 contiguous bytes of X (one
//     128-bit load), so a warp reads 512 contiguous bytes per step, and the
//     loop is unrolled so several loads are in flight per lane;
//   * y is staged once per block in shared memory when it fits the 48 KB
//     static budget (N <= 12,288) and read through the read-only cache
//     (__ldg) otherwise;
//   * the four float4 reads of y a lane makes per 16 bytes are rotated by
//     (lane / 2) % 4, so the eight lanes of each quarter warp hit eight
//     distinct 16-byte bank groups: without the rotation every y read is a
//     4-way bank conflict and shared memory, not HBM, would bound the kernel;
//   * blocks are persistent (as many as fit on the SMs at once) and walk
//     rows with a grid stride, so y is staged a few hundred times, not M/8;
//   * the lane partial sums meet in a warp-shuffle tree: no atomics, so the
//     result is bitwise repeatable from run to run.
// Ragged shapes: any M >= 1 and N >= 1.  When N % 16 != 0 or X is not
// 16-byte aligned the kernel reads one byte per lane per step instead.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps per block, one row each at a time
constexpr int kThreads = kWarps * 32;
constexpr long long kSmemYBytes = 48 * 1024;  // static shared-memory budget

__device__ __forceinline__ float dot4_i8(int word, float4 y) {
  // byte j of the little-endian word is column 4k+j; int8 -> f32 is exact
  const unsigned u = static_cast<unsigned>(word);
  const float a = static_cast<float>(static_cast<int8_t>(u & 0xffu));
  const float b = static_cast<float>(static_cast<int8_t>((u >> 8) & 0xffu));
  const float c = static_cast<float>(static_cast<int8_t>((u >> 16) & 0xffu));
  const float d = static_cast<float>(static_cast<int8_t>(u >> 24));
  float s = a * y.x;
  s = fmaf(b, y.y, s);
  s = fmaf(c, y.z, s);
  s = fmaf(d, y.w, s);
  return s;
}

__device__ __forceinline__ int pick(const int4& v, int k) {
  // register select (no local-memory array indexing)
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// VEC: 16-byte loads of X (N % 16 == 0, aligned rows).  SMEM: y staged in
// shared memory (N * 4 <= kSmemYBytes).
template <bool VEC, bool SMEM>
__global__ void __launch_bounds__(kThreads)
atx_int8_kernel(const int8_t* __restrict__ X, const float* __restrict__ y,
                float* __restrict__ out, long long M, long long N) {
  extern __shared__ float4 ys_raw[];
  const float* ys = reinterpret_cast<const float*>(ys_raw);
  if (SMEM) {
    float* dst = reinterpret_cast<float*>(ys_raw);
    for (long long i = threadIdx.x; i < N; i += kThreads) dst[i] = y[i];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;

  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp; row < M;
       row += stride) {
    const int8_t* xr = X + row * N;
    float acc = 0.0f;
    if (VEC) {
      const int4* xv = reinterpret_cast<const int4*>(xr);
      const long long nchunks = N >> 4;  // 16 codes per chunk
      const int rot = (lane >> 1) & 3;
#pragma unroll 4
      for (long long c = lane; c < nchunks; c += 32) {
        const int4 v = __ldg(xv + c);
        const long long y4 = c * 4;  // float4 index of the chunk's first column
#pragma unroll
        for (int k0 = 0; k0 < 4; ++k0) {
          const int k = (k0 + rot) & 3;
          float4 yy;
          if (SMEM) {
            yy = ys_raw[y4 + k];
          } else {
            yy = __ldg(reinterpret_cast<const float4*>(y) + y4 + k);
          }
          acc += dot4_i8(pick(v, k), yy);
        }
      }
    } else {
      for (long long n = lane; n < N; n += 32) {
        const float yv = SMEM ? ys[n] : __ldg(y + n);
        acc = fmaf(static_cast<float>(xr[n]), yv, acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[row] = acc;
  }
}

template <bool VEC, bool SMEM>
cudaError_t launch(const int8_t* X, const float* y, float* out, long long M, long long N,
                   cudaStream_t stream) {
  const size_t smem = SMEM ? static_cast<size_t>(N) * sizeof(float) : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, atx_int8_kernel<VEC, SMEM>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long need = (M + kWarps - 1) / kWarps;
  long long grid = static_cast<long long>(sms) * per_sm;
  if (grid > need) grid = need;
  atx_int8_kernel<VEC, SMEM><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      X, y, out, M, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int atx_int8_launch(const void* X, const void* y, void* out, long long M,
                               long long N, void* stream) {
  if (M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* Xp = static_cast<const int8_t*>(X);
  const float* yp = static_cast<const float*>(y);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(X) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const bool smem = static_cast<long long>(N) * 4 <= kSmemYBytes;
  cudaError_t err;
  if (vec) {
    err = smem ? launch<true, true>(Xp, yp, op, M, N, s) : launch<true, false>(Xp, yp, op, M, N, s);
  } else {
    err = smem ? launch<false, true>(Xp, yp, op, M, N, s) : launch<false, false>(Xp, yp, op, M, N, s);
  }
  return static_cast<int>(err);
}
