// Y = X Ys over marker rows: the reduce direction of the quantized and bf16
// designs (atx / atx_batch), for K <= 8 right-hand sides.
//
//   X   (M, nb) bytes, marker-major, read through a decode type C
//       (codes.cuh): units of C::UB bytes, unit j of a row carrying sample
//       p*nu + j of each half p < C::P, nu = nb/UB, so N = P*nu
//   Yt  (K, N)  f32, the right-hand sides transposed (the wrapper's copy)
//   Y   (M, K)  f32:  Y[m, k] = sum_p sum_j x_p(X[m, j]) Yt[k, p*nu + j]
//
// Instances: C = ByteCodes<1> (int8, UB = 1), ByteCodes<2> (packed int4),
// Bf16 (UB = 2: a 16-byte load holds 8 elements, two quads, where a byte
// design's holds four quads of each half).
//
// It replaces the TPU Pallas kernels `atx_batch_packed4_raw`
// (vampomi_tpu/ops/pallas_matvec.py:183-238) and `atx_packed4_raw`
// (pallas_matvec.py:89-124), both P = 2, and the int8 einsum of
// `atx_batch` (vampomi_tpu/ops/operator.py:334-340, P = 1), which has no
// Pallas kernel.  The TPU rounds Ys to bf16 for its matrix unit; here every
// code is upcast exactly to f32, multiplied by the f32 entry and summed in
// f32 (the interpret-mode arithmetic).
//
// Bound.  One pass reads M*nb bytes of X at 2*P*K/UB FLOPs per byte, against
// 4*N*K bytes of Ys and 4*M*K bytes of output.  At K = 2 that is 8 FLOPs a
// packed byte: 1.28 ms of f32 FMAs at 67 TFLOP/s against 3.21 ms for the
// 10.7 GB of X at 3.35 TB/s (M = 2,097,152 x nb = 5,120), so the bytes
// bound it.  At K = 8 on the packed design the FMAs (5.1 ms) pass the bytes.
//
// Design.  The earlier form of this kernel gave each warp one row: every
// float4 of Ys read from shared memory fed the four FMAs of that one row, so
// a byte of X cost 4*P*K bytes of shared-memory reads (16 B at P = 2, K = 2).
// Shared memory delivers 128 B per clock per SM, ~30 TB/s on the card, so X
// could not stream faster than ~2 TB/s (it measured 1.50 TB/s on an H100
// 80GB HBM3 at 700 W).  Here a warp owns R = xy_rows(K)
// rows at once:
//   * a lane loads the same 16-byte column chunk from each of its R rows
//     (R independent 16-byte loads in flight, and the next chunk's R loads
//     issued before the current one is used), decodes them, and applies
//     each float4 of Ys it reads from shared memory to all R rows, so a byte
//     of X costs 4*P*K/R bytes of shared-memory reads (4 B at P = 2, K = 2
//     and R = 4, the ratio at which atx_int8 runs at 82% of its
//     bound);
//   * the R*K partial sums stay in registers (on the packed design at K = 2
//     one per code half, so a word feeds two chains of four FMAs, not one
//     of eight); the Ys float4s of one 4-byte word are read once into
//     registers (4*K*P of them) and reused by the R rows;
//   * Yt is staged once per persistent block in dynamic shared memory when
//     K*N*4 bytes fit kSmemMax (N = 10,240: 40 KB at K = 1, 80 KB at K = 2;
//     above the 48 KB static limit, so the kernel opts in with
//     cudaFuncSetAttribute), and read through the read-only cache otherwise;
//   * lane l reads float4 Qc + q of each (k, p) segment of Ys at step q of
//     chunk c = l + 32t, Q = 4/UB quads a chunk; in shared memory that
//     float4 is stored at Qc + (q ^ ((c / (8/Q)) % Q)) (xy_swz), so the eight
//     lanes of a quarter warp hit eight distinct 16-byte bank groups while
//     q, the quad of the chunk the step decodes, is known at compile time (a
//     word picked by a lane-dependent index costs three selects per row and
//     step); through the read-only cache the quads are rotated by
//     (lane / (8/Q)) % Q instead;
//   * blocks are persistent and walk row groups with a grid stride; lane
//     partial sums meet in a warp-shuffle tree: no atomics, bitwise
//     repeatable.
// With shared memory off the critical path, the packed design's decode
// bounds it: a 4-byte word of one row takes ~35 instructions at K = 2 (the
// nibble masks, 8 byte permutes and 8 subtracts, 16 FMAs) against ~17 for
// int8, and its FMAs need enough independent sums to keep the pipes fed.
// int8 comes within ~12% of the bytes' bound; the packed design stays
// further from it (PERF.md).
// Ragged shapes: any M >= 1 and nb >= 1.  The last M mod R rows of a group
// read row M-1 again and are not written.  When nb % 16 != 0 or a pointer is
// not 16-byte aligned each lane reads one unit of each row per step.

#pragma once

#include "codes.cuh"

namespace vampomi {

constexpr int kXyWarps = 8;  // warps per block, R rows each at a time
constexpr int kXyThreads = kXyWarps * 32;
constexpr long long kSmemMax = 100 * 1024;  // two blocks fit one SM

// Rows per warp, fixed per K at compile time: 4 at K <= 2 (the fastest of
// 1, 2, 4 and 8 on the card, PERF.md), and above that as many as keep the partial sums, 4*P*K floats of Ys a step and the 2*R
// chunks in flight within the 128 registers a thread of two blocks of 256
// may hold, with no spills (ptxas -v).
constexpr int xy_rows(int K) { return K <= 4 ? 4 : (K <= 6 ? 2 : 1); }

// Partial sums per row and right-hand side on the 16-byte path: on the
// packed design at K = 2 the two code halves sum apart (two chains of four
// FMAs per word instead of one of eight: more independent work per warp,
// measured faster; at K = 1 it measured slower), else one.
__host__ __device__ constexpr int xy_sums(int P, int K) { return P == 2 && K == 2 ? 2 : 1; }

// quads (float4s of Ys per half) in a 16-byte chunk of a row
template <class C>
__host__ __device__ constexpr int xy_quads() { return 4 / C::UB; }

// float4s of one (k, p) segment of Ys on the 16-byte path, nb/(4*UB) (a
// shift: nb is never negative)
template <class C>
__host__ __device__ constexpr long long xy_n4(long long nb) { return nb >> (C::UB == 2 ? 3 : 2); }

// float4s of one (k, p) segment of Ys in shared memory on the 16-byte path:
// xy_n4, rounded up to a 128-byte multiple so every segment starts on bank 0
template <class C>
__host__ __device__ constexpr long long xy_seg(long long nb) { return (xy_n4<C>(nb) + 7) & ~7LL; }

// where float4 j of a segment is stored in shared memory: its group of Q
// (one chunk's quads) keeps its place, the float4 within the group is
// XORed with bits 3.. of j (Q = 4: bits 3-4; Q = 2: bit 3)
template <int Q>
__device__ __forceinline__ long long xy_swz(long long j) { return j ^ ((j >> 3) & (Q - 1)); }

// ys4: Ys in shared memory as K*P swizzled segments of xy_seg(nb) float4s
// (SMEM), or Yt in device memory, segments of xy_n4(nb) float4s
template <class C, int K, int R, bool SMEM>
__device__ __forceinline__ void xy_vec(const uint8_t* const (&xr)[R], const float4* ys4,
                                       long long nb, int lane, float (&acc)[R][K]) {
  constexpr int P = C::P;
  constexpr int Q = xy_quads<C>();
  const long long nchunks = nb >> 4;  // 16 bytes per chunk
  const long long seg = SMEM ? xy_seg<C>(nb) : xy_n4<C>(nb);
  constexpr int kRotShift = Q == 4 ? 1 : (Q == 2 ? 2 : 3);  // log2(8/Q)
  const int rot = (lane >> kRotShift) & (Q - 1);  // (c / (8/Q)) % Q for every chunk c of this lane
  constexpr int S = xy_sums(P, K);
  float part[R][K][S];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int h = 0; h < S; ++h) part[i][k][h] = 0.0f;
  long long c = lane;
  uint4 v[R];
  if (c < nchunks) {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = __ldg(reinterpret_cast<const uint4*>(xr[i]) + c);
  }
  for (; c < nchunks; c += 32) {
    const bool more = c + 32 < nchunks;
    uint4 nxt[R];
    if (more) {
#pragma unroll
      for (int i = 0; i < R; ++i) nxt[i] = __ldg(reinterpret_cast<const uint4*>(xr[i]) + c + 32);
    }
#pragma unroll
    for (int q0 = 0; q0 < Q; ++q0) {
      const int q = SMEM ? q0 : (q0 + rot) & (Q - 1);  // the quad this step decodes
      const long long at = c * Q + (SMEM ? (q0 ^ rot) : q);
      float4 y[K][P];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const long long idx = (k * P + p) * seg + at;
          y[k][p] = SMEM ? ys4[idx] : __ldg(ys4 + idx);
        }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float cd[P][4];
        C::quad(v[i], q, cd);
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int p = 0; p < P; ++p) {
            float& s = part[i][k][S == 1 ? 0 : p];
            s = fmaf(cd[p][0], y[k][p].x, s);
            s = fmaf(cd[p][1], y[k][p].y, s);
            s = fmaf(cd[p][2], y[k][p].z, s);
            s = fmaf(cd[p][3], y[k][p].w, s);
          }
      }
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = nxt[i];
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int h = 0; h < S; ++h) acc[i][k] += part[i][k][h];
}

template <class C, int K, int R, bool SMEM>
__device__ __forceinline__ void xy_units(const uint8_t* const (&xr)[R], const float* ys,
                                         long long nb, int lane, float (&acc)[R][K]) {
  constexpr int P = C::P;
  const long long nu = nb / C::UB;
  const long long N = P * nu;
  for (long long j = lane; j < nu; j += 32) {
    float cd[R][P];
#pragma unroll
    for (int i = 0; i < R; ++i) C::unit(xr[i], j, cd[i]);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const long long idx = k * N + p * nu + j;
        const float y = SMEM ? ys[idx] : __ldg(ys + idx);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][k] = fmaf(cd[i][p], y, acc[i][k]);
      }
  }
}

template <class C, int K, int R, bool VEC, bool SMEM>
__global__ void __launch_bounds__(kXyThreads, 2)
xy_kernel(const uint8_t* __restrict__ X, const float* __restrict__ Yt, float* __restrict__ out,
          long long M, long long nb) {
  constexpr int P = C::P;
  extern __shared__ float4 ys_raw[];
  const long long N = P * (nb / C::UB);
  const float* ys = SMEM ? reinterpret_cast<const float*>(ys_raw) : Yt;
  if (SMEM) {
    if constexpr (VEC) {  // nb % 16 == 0 and Yt 16-byte aligned
      const float4* src = reinterpret_cast<const float4*>(Yt);
      const long long n4 = xy_n4<C>(nb), seg = xy_seg<C>(nb);
      for (long long i = threadIdx.x; i < K * P * n4; i += kXyThreads) {
        const long long s = i / n4, j = i - s * n4;  // segment (k, p) = (s / P, s % P)
        ys_raw[s * seg + xy_swz<xy_quads<C>()>(j)] = __ldg(src + i);
      }
    } else {
      float* dst = reinterpret_cast<float*>(ys_raw);
      for (long long i = threadIdx.x; i < K * N; i += kXyThreads) dst[i] = __ldg(Yt + i);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long groups = (M + R - 1) / R;
  const long long stride = static_cast<long long>(gridDim.x) * kXyWarps;

  for (long long g = static_cast<long long>(blockIdx.x) * kXyWarps + warp; g < groups;
       g += stride) {
    const long long r0 = g * R;
    const uint8_t* xr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) xr[i] = X + (r0 + i < M ? r0 + i : M - 1) * nb;
    float acc[R][K];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[i][k] = 0.0f;
    if constexpr (VEC) {
      xy_vec<C, K, R, SMEM>(xr, reinterpret_cast<const float4*>(ys), nb, lane, acc);
    } else {
      xy_units<C, K, R, SMEM>(xr, ys, nb, lane, acc);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float s = warp_sum(acc[i][k]);
        if (lane == 0 && r0 + i < M) out[(r0 + i) * K + k] = s;
      }
  }
}

// bytes of Ys in shared memory
template <class C, int K, bool VEC>
long long xy_smem(long long nb) {
  return VEC ? K * C::P * xy_seg<C>(nb) * 16 : K * C::P * (nb / C::UB) * 4;
}

template <class C, int K, int R, bool VEC, bool SMEM>
cudaError_t xy_launch_t(const uint8_t* X, const float* Yt, float* out, long long M, long long nb,
                        cudaStream_t stream) {
  const size_t smem = SMEM ? static_cast<size_t>(xy_smem<C, K, VEC>(nb)) : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(xy_kernel<C, K, R, VEC, SMEM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  long long grid = 0;
  err = resident_blocks(xy_kernel<C, K, R, VEC, SMEM>, kXyThreads, smem, &grid);
  if (err != cudaSuccess) return err;
  const long long need = ((M + R - 1) / R + kXyWarps - 1) / kXyWarps;
  if (grid > need) grid = need;
  xy_kernel<C, K, R, VEC, SMEM><<<static_cast<unsigned>(grid), kXyThreads, smem, stream>>>(
      X, Yt, out, M, nb);
  return cudaGetLastError();
}

template <class C, int K, int R>
cudaError_t xy_paths(const uint8_t* X, const float* Yt, float* out, long long M, long long nb,
                     bool vec, cudaStream_t s) {
  if (vec) {
    return xy_smem<C, K, true>(nb) <= kSmemMax
               ? xy_launch_t<C, K, R, true, true>(X, Yt, out, M, nb, s)
               : xy_launch_t<C, K, R, true, false>(X, Yt, out, M, nb, s);
  }
  return xy_smem<C, K, false>(nb) <= kSmemMax
             ? xy_launch_t<C, K, R, false, true>(X, Yt, out, M, nb, s)
             : xy_launch_t<C, K, R, false, false>(X, Yt, out, M, nb, s);
}

// K right-hand sides at xy_rows(K) rows per warp, on every path (16-byte or
// unit loads, Ys in shared memory or not)
template <class C, int K>
cudaError_t xy_k(const uint8_t* X, const float* Yt, float* out, long long M, long long nb,
                 bool vec, cudaStream_t s) {
  return xy_paths<C, K, xy_rows(K)>(X, Yt, out, M, nb, vec, s);
}

// the 16-byte path needs nb % 16 == 0 and 16-byte aligned X and Yt
inline bool xy_vec_ok(const void* X, const void* Yt, long long nb) {
  return nb % 16 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(Yt) % 16 == 0;
}

// K-th instance for k == K, else the next one, up to 8
template <class C, int K>
cudaError_t xy_dispatch(const uint8_t* X, const float* Yt, float* out, long long M, long long nb,
                        int k, bool vec, cudaStream_t s) {
  if constexpr (K > 8) {
    return cudaErrorInvalidValue;
  } else {
    return k == K ? xy_k<C, K>(X, Yt, out, M, nb, vec, s)
                  : xy_dispatch<C, K + 1>(X, Yt, out, M, nb, k, vec, s);
  }
}

// The C entry point of a library built from this header, for the decode
// type C and rows of nb bytes (nb % C::UB == 0): launches on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of the launch.
template <class C>
cudaError_t xy_launch(const void* X, const void* Yt, void* out, long long M, long long nb, int K,
                      void* stream) {
  if (M < 1 || nb < C::UB || nb % C::UB != 0 || K < 1 || K > 8) return cudaErrorInvalidValue;
  return xy_dispatch<C, 1>(static_cast<const uint8_t*>(X), static_cast<const float*>(Yt),
                           static_cast<float*>(out), M, nb, K, xy_vec_ok(X, Yt, nb),
                           static_cast<cudaStream_t>(stream));
}

}  // namespace vampomi
