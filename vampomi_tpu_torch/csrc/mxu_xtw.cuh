// Z = codes(X)^T bf16(W) over marker rows on the tensor cores: the
// broadcast direction of the quantized design with W rounded to bf16 and
// the products summed in f32, for K <= 8 right-hand sides.
//
//   X  (M, nb) bytes, marker-major, P codes per byte (codes.cuh)
//   W  (M, K)  f32, row-major, rounded to bf16 (nearest even) in the kernel
//   Z  (N, K)  f32, N = P*nb:  Z[p*nb + j, k] = sum_m code_p(X[m, j]) bf16(W[m, k])
//
// It replaces two TPU Pallas probe kernels that contract bf16 tiles on the
// MXU into a resident f32 output along a sequential grid: `ax_mxu`
// (tools/matvec_floor_probe.py:168-200, P = 1, K = 1) and `ax2_i4_pallas`
// (tools/r4_probe.py:139-174, P = 2, K = 2).  The CUDA-core twin of this
// template is xtw.cuh, which multiplies in f32 without rounding W.
//
// The contraction runs over X's rows, so X enters the product transposed:
// A = X^T (16 columns of X by 16 markers), B = W (16 markers by 8, K of
// them used), D = Z (16 columns by 8).  Lane (g, t) loads 16 bytes (columns
// col + 16g .. + 15) from each of the four rows m0 + 4t + i, i < 4; its k
// slots {2t, 2t+1, 2t+8, 2t+9} are those four markers (mma_bf16.cuh), so the
// f32 decode of byte e of row i IS the transposed element, and two of them
// make one A register with one byte permute: no shared-memory staging, no
// ldmatrix.  Byte e of the lane's 16 goes to product e / 2, as A row g
// (e even) or g + 8 (e odd), so one step of 16 markers is 8 products per
// code plane, and a warp covers 128 columns of bytes (P*128 of Z).  B lanes
// g < K carry column g of W; D lane (g, t) holds Z columns 2t and 2t + 1.
//
// Bound: bytes of X, as xtw.cuh.  Hopper has no ordered grid, so the sum
// over markers is split as there: each warp owns a 128-byte column tile and
// one range of rows (a "split"), accumulates in the tensor cores' f32
// registers, and writes its partial Z to a workspace (splits, N, K); xtw.cuh's
// `sum_splits_kernel` sums the partials in a fixed order.  No atomics: the
// result is bitwise repeatable.
// Ragged shapes: any M >= 1 (rows past a split's end load nothing and meet
// zero weights) and nb >= 1 (one byte per lane when nb % 16 != 0 or X is not
// 16-byte aligned).

#pragma once

#include "mma_bf16.cuh"
#include "xtw.cuh"

namespace vampomi {

constexpr int kMxuWarps = 4;
constexpr int kMxuThreads = kMxuWarps * 32;
constexpr long long kMxuTileBytes = 128;  // 8 lane groups x 16 bytes

template <int P, bool VEC>
__global__ void __launch_bounds__(kMxuThreads)
mxu_xtw_kernel(const uint8_t* __restrict__ X, const float* __restrict__ W, float* __restrict__ part,
               long long M, long long nb, int K, long long splits, long long rows_per_split,
               long long tiles) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long gw = static_cast<long long>(blockIdx.x) * kMxuWarps + (threadIdx.x >> 5);
  const long long split = gw / tiles;
  if (split >= splits) return;  // whole warps leave together: mma needs all 32 lanes
  const long long col = (gw % tiles) * kMxuTileBytes + 16LL * g;
  const long long r0 = split * rows_per_split;
  const long long r1 = r0 + rows_per_split < M ? r0 + rows_per_split : M;

  float d[P][8][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[p][e][i] = 0.0f;

  for (long long m0 = r0; m0 < r1; m0 += 16) {
    uint4 x[4];
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = m0 + 4 * t + i;
      const bool ok = row < r1;
      x[i] = load16<VEC>(X + (ok ? row : 0) * nb, col, nb, ok);
      w[i] = ok && g < K ? __ldg(W + row * K + g) : 0.0f;
    }
    const unsigned b0 = pack_rn(w[0], w[1]);
    const unsigned b1 = pack_rn(w[2], w[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // bytes 4q .. 4q + 3 of the lane's 16
      float c[4][P][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) Codes<P>::word(pick(x[i], q), c[i]);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // bytes 2h (A row g) and 2h + 1 (row g + 8)
          const unsigned a[4] = {pack_exact(c[0][p][2 * h], c[1][p][2 * h]),
                                 pack_exact(c[0][p][2 * h + 1], c[1][p][2 * h + 1]),
                                 pack_exact(c[2][p][2 * h], c[3][p][2 * h]),
                                 pack_exact(c[2][p][2 * h + 1], c[3][p][2 * h + 1])};
          mma_bf16(d[p][2 * q + h], a, b0, b1);
        }
    }
  }

  float* out = part + split * (P * nb) * K;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // Z column col + 2e + r: D row g + 8r
        const long long j = col + 2 * e + r;
        if (j >= nb) continue;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          if (2 * t + kk < K) out[(p * nb + j) * K + 2 * t + kk] = d[p][e][2 * r + kk];
      }
}

template <int P>
struct MxuXtw {
  static long long tiles(long long nb) { return (nb + kMxuTileBytes - 1) / kMxuTileBytes; }

  // splits that fill the card once, each a multiple of 16 rows and none
  // with fewer than kXtwMinRows rows
  static cudaError_t splits(long long M, long long nb, long long* out) {
    long long blocks = 0;
    cudaError_t err = resident_blocks(mxu_xtw_kernel<P, true>, kMxuThreads, 0, &blocks);
    if (err != cudaSuccess) return err;
    long long s = blocks * kMxuWarps / tiles(nb);
    const long long most = (M + kXtwMinRows - 1) / kXtwMinRows;
    if (s > most) s = most;
    if (s < 1) s = 1;
    *out = (M + rows(M, s) - 1) / rows(M, s);
    return cudaSuccess;
  }

  static long long rows(long long M, long long splits) {
    return ((M + splits - 1) / splits + 15) / 16 * 16;
  }

  static cudaError_t launch(const uint8_t* X, const float* W, float* part, float* out, long long M,
                            long long nb, int K, long long splits, bool vec, cudaStream_t stream) {
    const long long t = tiles(nb);
    const unsigned grid = static_cast<unsigned>((splits * t + kMxuWarps - 1) / kMxuWarps);
    const long long r = rows(M, splits);
    if (vec) {
      mxu_xtw_kernel<P, true><<<grid, kMxuThreads, 0, stream>>>(X, W, part, M, nb, K, splits, r, t);
    } else {
      mxu_xtw_kernel<P, false><<<grid, kMxuThreads, 0, stream>>>(X, W, part, M, nb, K, splits, r, t);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long len = P * nb * K;
    long long g = (len + 255) / 256;
    if (g > 4096) g = 4096;
    sum_splits_kernel<<<static_cast<unsigned>(g), 256, 0, stream>>>(part, out, len, splits);
    return cudaGetLastError();
  }
};

// The C entry points of a library built from this header, for P codes per
// byte, with the signatures of xtw.cuh's: `splits` reports the workspace the
// launch needs, (splits, N, K) f32.
template <int P>
cudaError_t mxu_xtw_splits(long long M, long long nb, int K, long long* out) {
  if (M < 1 || nb < 1 || K < 1 || K > 8) return cudaErrorInvalidValue;
  return MxuXtw<P>::splits(M, nb, out);
}

template <int P>
cudaError_t mxu_xtw_launch(const void* X, const void* W, void* part, void* out, long long M,
                           long long nb, int K, long long splits, void* stream) {
  if (M < 1 || nb < 1 || K < 1 || K > 8 || splits < 1) return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(X) % 16 == 0 && nb % 16 == 0;
  return MxuXtw<P>::launch(static_cast<const uint8_t*>(X), static_cast<const float*>(W),
                           static_cast<float*>(part), static_cast<float*>(out), M, nb, K, splits,
                           vec, static_cast<cudaStream_t>(stream));
}

}  // namespace vampomi
