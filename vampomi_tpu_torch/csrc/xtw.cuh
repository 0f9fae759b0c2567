// Z = X^T W over marker rows: the broadcast direction of the quantized and
// bf16 designs (ax / ax_batch), for K <= 8 right-hand sides.
//
//   X  (M, nb) bytes, marker-major, read through a decode type C
//      (codes.cuh): units of C::UB bytes, unit j carrying sample p*nu + j of
//      each half p < C::P, nu = nb/UB
//   W  (M, K)  f32, row-major
//   Z  (N, K)  f32, N = P*nu:  Z[p*nu + j, k] = sum_m x_p(X[m, j]) W[m, k]
//
// Instances: C = ByteCodes<1> (int8), ByteCodes<2> (packed int4), Bf16
// (the bf16 design's broadcast, an XLA einsum in the JAX package,
// vampomi_tpu/ops/operator.py:186-197, with no Pallas kernel).
//
// It replaces two TPU Pallas kernels that compute this with a sequential
// grid, zeroing the (K, N) output on the first grid step and adding each
// (TM, nb) tile's product into it: `ax_batch_packed4_raw`
// (vampomi_tpu/ops/pallas_matvec.py:127-180, P = 2) and `ax2_i8_pallas`
// (tools/r4_probe.py:77-103, P = 1).  Those round W to bf16 for the TPU's
// matrix unit; here every code is upcast exactly to f32, multiplied by the
// f32 weight and summed in f32 (the interpret-mode arithmetic).
//
// Bound: bytes of X.  One pass reads M*nb bytes at 2*P*K/UB FLOPs per byte,
// against 4*M*K bytes of W and 4*N*K bytes of output.  Hopper has no ordered
// grid, so the sum over markers is split in two passes:
//   1. each warp owns a column tile of 32*VB bytes (lane l the VB contiguous
//      bytes l*VB.., one 16-, 8- or 4-byte load per row) and one range of
//      rows (a "split"); each lane keeps K*P*VB/UB accumulators in registers
//      (at most 64), walks its rows four at a time so four loads are in
//      flight, reads the row's K weights as a broadcast load, and writes its
//      columns of the split's partial Z to a workspace (splits, N, K);
//   2. a second kernel sums the partials over the splits in a fixed order.
// No atomics: the result is bitwise repeatable.  The splits are as many as
// fill the card once (resident warps / column tiles), so the workspace is a
// few tens of MB at the largest shapes.
// Ragged shapes: any M >= 1 and nb >= 1 (a multiple of UB).  When
// nb % VB != 0 or X is not 16-byte aligned each lane reads its VB bytes one
// unit at a time.

#pragma once

#include "codes.cuh"

namespace vampomi {

constexpr int kXtwWarps = 4;                  // warps per block
constexpr int kXtwThreads = kXtwWarps * 32;
constexpr int kXtwMinRows = 64;               // no split holds fewer rows

// bytes per lane: the widest load that keeps K*P*VB/UB accumulators <= 64
template <class C>
constexpr int xtw_vb(int K) {
  return K * C::P * 16 / C::UB <= 64 ? 16 : (K * C::P * 8 / C::UB <= 64 ? 8 : 4);
}

template <int VB>
__device__ __forceinline__ void load_words(const uint8_t* p, unsigned (&w)[VB / 4]) {
  if constexpr (VB == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// the VB/(4*WPQ) quads of a lane's VB bytes, each into four of its
// accumulators per half and right-hand side
template <class C, int K, int VB>
__device__ __forceinline__ void fma_words(const unsigned (&w)[VB / 4], const float (&wt)[K],
                                          float (&acc)[K][C::P][VB / C::UB]) {
  constexpr int P = C::P;
#pragma unroll
  for (int q = 0; q < VB / (4 * C::WPQ); ++q) {
    float c[P][4];
    C::quad_at(&w[q * C::WPQ], c);
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k][p][4 * q + i] = fmaf(c[p][i], wt[k], acc[k][p][4 * q + i]);
  }
}

template <class C, int K, int VB, bool VEC>
__global__ void __launch_bounds__(kXtwThreads, 4)
xtw_kernel(const uint8_t* __restrict__ X, const float* __restrict__ W, float* __restrict__ part,
           long long M, long long nb, long long splits, long long rows_per_split, long long tiles) {
  constexpr int P = C::P;
  constexpr int E = VB / C::UB;  // units per lane
  const long long nu = nb / C::UB;
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * kXtwWarps + (threadIdx.x >> 5);
  const long long split = gw / tiles;
  if (split >= splits) return;
  const long long col0 = (gw % tiles) * (32LL * VB) + static_cast<long long>(lane) * VB;
  if (col0 >= nb) return;  // past the row's end (VEC: all VB bytes are in range)
  const long long u0 = col0 / C::UB;  // the lane's first unit
  const long long r0 = split * rows_per_split;
  const long long r1 = r0 + rows_per_split < M ? r0 + rows_per_split : M;

  float acc[K][P][E];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int b = 0; b < E; ++b) acc[k][p][b] = 0.0f;

  if (VEC) {
    const uint8_t* xp = X + r0 * nb + col0;
    long long r = r0;
    for (; r + 4 <= r1; r += 4, xp += 4 * nb) {
      unsigned w[4][VB / 4];
      float wt[4][K];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_words<VB>(xp + u * nb, w[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) wt[u][k] = __ldg(W + (r + u) * K + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) fma_words<C, K, VB>(w[u], wt[u], acc);
    }
    for (; r < r1; ++r, xp += nb) {
      unsigned w[VB / 4];
      float wt[K];
      load_words<VB>(xp, w);
#pragma unroll
      for (int k = 0; k < K; ++k) wt[k] = __ldg(W + r * K + k);
      fma_words<C, K, VB>(w, wt, acc);
    }
  } else {
    for (long long r = r0; r < r1; ++r) {
      const uint8_t* row = X + r * nb;
      float wt[K];
#pragma unroll
      for (int k = 0; k < K; ++k) wt[k] = __ldg(W + r * K + k);
#pragma unroll
      for (int b = 0; b < E; ++b) {
        if (u0 + b < nu) {
          float c[P];
          C::unit(row, u0 + b, c);
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int k = 0; k < K; ++k) acc[k][p][b] = fmaf(c[p], wt[k], acc[k][p][b]);
        }
      }
    }
  }

  float* out = part + split * (P * nu) * K;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int b = 0; b < E; ++b) {
      const long long col = u0 + b;
      if (col < nu) {
#pragma unroll
        for (int k = 0; k < K; ++k) out[(p * nu + col) * K + k] = acc[k][p][b];
      }
    }
}

// out[i] = sum over s of part[s*len + i], s in order
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, long long len,
                  long long splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < len;
       i += stride) {
    float s = 0.0f;
    for (long long j = 0; j < splits; ++j) s += part[j * len + i];
    out[i] = s;
  }
}

template <class C, int K>
struct Xtw {
  static constexpr int VB = xtw_vb<C>(K);

  static long long tiles(long long nb) { return (nb + 32LL * VB - 1) / (32LL * VB); }

  // splits that fill the card once, none with fewer than kXtwMinRows rows
  // and none empty
  static cudaError_t splits(long long M, long long nb, long long* out) {
    long long blocks = 0;
    cudaError_t err = resident_blocks(xtw_kernel<C, K, VB, true>, kXtwThreads, 0, &blocks);
    if (err != cudaSuccess) return err;
    long long s = blocks * kXtwWarps / tiles(nb);
    const long long most = (M + kXtwMinRows - 1) / kXtwMinRows;
    if (s > most) s = most;
    if (s < 1) s = 1;
    const long long rows = (M + s - 1) / s;
    *out = (M + rows - 1) / rows;
    return cudaSuccess;
  }

  static cudaError_t launch(const uint8_t* X, const float* W, float* part, float* out, long long M,
                            long long nb, long long splits, bool vec, cudaStream_t stream) {
    const long long rows = (M + splits - 1) / splits;
    const long long t = tiles(nb);
    const long long warps = splits * t;
    const unsigned grid = static_cast<unsigned>((warps + kXtwWarps - 1) / kXtwWarps);
    if (vec) {
      xtw_kernel<C, K, VB, true>
          <<<grid, kXtwThreads, 0, stream>>>(X, W, part, M, nb, splits, rows, t);
    } else {
      xtw_kernel<C, K, VB, false>
          <<<grid, kXtwThreads, 0, stream>>>(X, W, part, M, nb, splits, rows, t);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long len = C::P * (nb / C::UB) * K;
    long long g = (len + 255) / 256;
    if (g > 4096) g = 4096;
    sum_splits_kernel<<<static_cast<unsigned>(g), 256, 0, stream>>>(part, out, len, splits);
    return cudaGetLastError();
  }
};

// The C entry points of a library built from this header, for the decode
// type C and rows of nb bytes.  `splits` reports the workspace the launch
// needs: (splits, N, K) f32.
template <class C>
cudaError_t xtw_splits(long long M, long long nb, int K, long long* out) {
  switch (K) {
    case 1: return Xtw<C, 1>::splits(M, nb, out);
    case 2: return Xtw<C, 2>::splits(M, nb, out);
    case 3: return Xtw<C, 3>::splits(M, nb, out);
    case 4: return Xtw<C, 4>::splits(M, nb, out);
    case 5: return Xtw<C, 5>::splits(M, nb, out);
    case 6: return Xtw<C, 6>::splits(M, nb, out);
    case 7: return Xtw<C, 7>::splits(M, nb, out);
    case 8: return Xtw<C, 8>::splits(M, nb, out);
    default: return cudaErrorInvalidValue;
  }
}

template <class C>
cudaError_t xtw_launch(const void* X, const void* W, void* part, void* out, long long M,
                       long long nb, int K, long long splits, void* stream) {
  if (M < 1 || nb < C::UB || nb % C::UB != 0 || splits < 1) return cudaErrorInvalidValue;
  const uint8_t* Xp = static_cast<const uint8_t*>(X);
  const float* Wp = static_cast<const float*>(W);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(X) % 16 == 0;
  switch (K) {
#define VAMPOMI_XTW_CASE(KK)                                                              \
  case KK:                                                                               \
    return Xtw<C, KK>::launch(Xp, Wp, pp, op, M, nb, splits,                             \
                              aligned && nb % Xtw<C, KK>::VB == 0, s);
    VAMPOMI_XTW_CASE(1)
    VAMPOMI_XTW_CASE(2)
    VAMPOMI_XTW_CASE(3)
    VAMPOMI_XTW_CASE(4)
    VAMPOMI_XTW_CASE(5)
    VAMPOMI_XTW_CASE(6)
    VAMPOMI_XTW_CASE(7)
    VAMPOMI_XTW_CASE(8)
#undef VAMPOMI_XTW_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vampomi
