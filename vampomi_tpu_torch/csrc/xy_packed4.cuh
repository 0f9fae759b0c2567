// Y = X Ys on the packed-int4 design: the reduce direction (atx /
// atx_batch) for K <= 8 right-hand sides.
//
//   X   (M, n2) bytes, two biased nibbles each (codes.cuh, P = 2): byte j
//       carries the codes of samples j (low) and j + n2 (high), N = 2*n2
//   Yt  (K, N)  f32, the right-hand sides transposed (the wrapper's copy)
//   Y   (M, K)  f32:  Y[m, k] = sum_j lo(m, j) Yt[k, j] + hi(m, j) Yt[k, j + n2]
//
// It replaces the TPU Pallas kernels `atx_packed4_raw` (K = 1,
// vampomi_tpu/ops/pallas_matvec.py:89-124) and `atx_batch_packed4_raw`
// (pallas_matvec.py:183-238).  The batch kernel rounds Ys to bf16 for the
// TPU's matrix unit; here every code is upcast exactly to f32, multiplied by
// the f32 entry and summed in f32 (the interpret-mode arithmetic).
//
// Bound: bytes of X.  One pass reads M*n2 bytes at 4*K FLOPs per byte
// against 4*N*K bytes of Ys and 4*M*K bytes of output.  The design follows
// atx_int8.cu:
//   * one warp per row; each lane loads 16 contiguous bytes of X (32 codes)
//     per step, so a warp reads 512 contiguous bytes, unrolled four deep;
//   * Yt is staged once per persistent block in dynamic shared memory when
//     K*N*4 bytes fit kSmemMax (N = 10,240: 40 KB at K = 1, 80 KB at K = 2;
//     above the 48 KB static limit, so the kernel opts in with
//     cudaFuncSetAttribute), and read through the read-only cache otherwise
//     (K = 8 at N = 10,240 is 320 KB: more than a block may hold);
//   * a lane's 16 bytes need four float4 of Yt[k] for the low nibbles and
//     four, n2 floats further on, for the high ones; the four reads are
//     rotated by (lane / 2) % 4 so each quarter warp hits eight distinct
//     16-byte bank groups (the high half is a constant shift of the low
//     one, so it is conflict-free too);
//   * blocks are persistent and walk rows with a grid stride; lane partial
//     sums meet in a warp-shuffle tree: no atomics, bitwise repeatable.
// Ragged shapes: any M >= 1 and n2 >= 1.  When n2 % 16 != 0 or a pointer is
// not 16-byte aligned each lane reads one byte per step.

#pragma once

#include "codes.cuh"

namespace vampomi {

constexpr int kXyWarps = 8;  // warps per block, one row each at a time
constexpr int kXyThreads = kXyWarps * 32;
constexpr long long kSmemMax = 100 * 1024;  // two blocks of 256 threads fit one SM

template <int K, bool VEC, bool SMEM>
__global__ void __launch_bounds__(kXyThreads)
xy_packed4_kernel(const uint8_t* __restrict__ X, const float* __restrict__ Yt,
                  float* __restrict__ out, long long M, long long n2) {
  extern __shared__ float4 ys_raw[];
  const long long N = 2 * n2;
  const float* ys = SMEM ? reinterpret_cast<const float*>(ys_raw) : Yt;
  if (SMEM) {
    float* dst = reinterpret_cast<float*>(ys_raw);
    for (long long i = threadIdx.x; i < K * N; i += kXyThreads) dst[i] = Yt[i];
    __syncthreads();
  }
  const float4* ys4 = reinterpret_cast<const float4*>(ys);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kXyWarps;

  for (long long row = static_cast<long long>(blockIdx.x) * kXyWarps + warp; row < M;
       row += stride) {
    const uint8_t* xr = X + row * n2;
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
    if (VEC) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      const long long nchunks = n2 >> 4;  // 16 bytes per chunk
      const long long h4 = n2 >> 2;       // float4 offset of the high half
      const int rot = (lane >> 1) & 3;
#pragma unroll 4
      for (long long c = lane; c < nchunks; c += 32) {
        const uint4 v = __ldg(xv + c);
        const long long y4 = c * 4;  // float4 index of the chunk's first low column
#pragma unroll
        for (int q0 = 0; q0 < 4; ++q0) {
          const int q = (q0 + rot) & 3;
          float cd[2][4];
          Codes<2>::word(pick(v, q), cd);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const long long base = k * (N >> 2) + y4 + q;
            float4 lo, hi;
            if (SMEM) {
              lo = ys4[base];
              hi = ys4[base + h4];
            } else {
              lo = __ldg(ys4 + base);
              hi = __ldg(ys4 + base + h4);
            }
            float s = acc[k];
            s = fmaf(cd[0][0], lo.x, s);
            s = fmaf(cd[0][1], lo.y, s);
            s = fmaf(cd[0][2], lo.z, s);
            s = fmaf(cd[0][3], lo.w, s);
            s = fmaf(cd[1][0], hi.x, s);
            s = fmaf(cd[1][1], hi.y, s);
            s = fmaf(cd[1][2], hi.z, s);
            s = fmaf(cd[1][3], hi.w, s);
            acc[k] = s;
          }
        }
      }
    } else {
      for (long long j = lane; j < n2; j += 32) {
        float cd[2];
        Codes<2>::byte(xr[j], cd);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float* yk = ys + k * N;
          acc[k] = fmaf(cd[0], SMEM ? yk[j] : __ldg(yk + j), acc[k]);
          acc[k] = fmaf(cd[1], SMEM ? yk[j + n2] : __ldg(yk + j + n2), acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float s = warp_sum(acc[k]);
      if (lane == 0) out[row * K + k] = s;
    }
  }
}

template <int K, bool VEC, bool SMEM>
cudaError_t xy_packed4_launch_t(const uint8_t* X, const float* Yt, float* out, long long M,
                                long long n2, cudaStream_t stream) {
  const size_t smem = SMEM ? static_cast<size_t>(K) * 2 * n2 * sizeof(float) : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(xy_packed4_kernel<K, VEC, SMEM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  long long grid = 0;
  err = resident_blocks(xy_packed4_kernel<K, VEC, SMEM>, kXyThreads, smem, &grid);
  if (err != cudaSuccess) return err;
  const long long need = (M + kXyWarps - 1) / kXyWarps;
  if (grid > need) grid = need;
  xy_packed4_kernel<K, VEC, SMEM><<<static_cast<unsigned>(grid), kXyThreads, smem, stream>>>(
      X, Yt, out, M, n2);
  return cudaGetLastError();
}

template <int K>
cudaError_t xy_packed4_k(const uint8_t* X, const float* Yt, float* out, long long M, long long n2,
                         bool vec, cudaStream_t s) {
  const bool smem = static_cast<long long>(K) * 2 * n2 * 4 <= kSmemMax;
  if (vec) {
    return smem ? xy_packed4_launch_t<K, true, true>(X, Yt, out, M, n2, s)
                : xy_packed4_launch_t<K, true, false>(X, Yt, out, M, n2, s);
  }
  return smem ? xy_packed4_launch_t<K, false, true>(X, Yt, out, M, n2, s)
              : xy_packed4_launch_t<K, false, false>(X, Yt, out, M, n2, s);
}

// the 16-byte path needs n2 % 16 == 0 and 16-byte aligned X and Yt
inline bool xy_packed4_vec(const void* X, const void* Yt, long long n2) {
  return n2 % 16 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(Yt) % 16 == 0;
}

}  // namespace vampomi
