// v[m] = sum_n X[m, n] * bf16(y[n]) on the tensor cores: the int8 A^T y
// matvec with y rounded to bf16 and the products summed in f32.
//
// Replaces the TPU Pallas probe kernel `atx_mxu`
// (tools/matvec_floor_probe.py:135-165), the matrix-unit variant of
// `atx_int8_raw`: each (TM, N) tile cast to bf16 and contracted with the
// (N, 1) bf16 y on the MXU into f32.  Here each warp owns 16 rows and walks
// their columns 64 at a time with m16n8k16 bf16 products (mma_bf16.cuh):
//   * A is X: lane (g, t) loads 16 bytes of row g and of row g + 8 at column
//     c0 + 16t, and its four k slots of step s are the columns
//     c0 + 16t + 4s + {0, 1, 2, 3}, so four products cover 64 columns and
//     every load is a 16-byte load of 64 contiguous bytes per row;
//   * B is y: column 0 holds y, the other seven columns are zero.  That is
//     the narrow-operand cost the probe exists to measure (the TPU probe's
//     note, tools/r4_probe.py:10): 7/8 of every product is wasted;
//   * D column 0 is the result for the 16 rows; lanes t == 0 write it.
// y is rounded to bf16 (nearest even) once per call by a small kernel into
// a zero-padded workspace of npad (a multiple of 64) values, so every B
// load is in range and columns past N add 0 * 0.
//
// Bound: bytes of X (M*N), as for atx_int8.cu; the tensor cores do 8x the
// useful products.  Rows are walked by persistent blocks with a grid
// stride; every row's sum stays in one warp, so the result is bitwise
// repeatable.  Ragged shapes: any M >= 1 (the last 16-row group is masked)
// and N >= 1 (one byte per lane when N % 16 != 0 or X is not 16-byte
// aligned).
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launches.

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr long long kCols = 64;  // columns one step of four products covers

using vampomi::Codes;

// yb[i] = bf16(y[2i]) | bf16(y[2i+1]) << 16, zero past n
__global__ void __launch_bounds__(256)
round_y_kernel(const float* __restrict__ y, unsigned* __restrict__ yb, long long n, long long words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < words;
       i += stride) {
    const float lo = 2 * i < n ? y[2 * i] : 0.0f;
    const float hi = 2 * i + 1 < n ? y[2 * i + 1] : 0.0f;
    yb[i] = vampomi::pack_rn(lo, hi);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
atx_mxu_kernel(const uint8_t* __restrict__ X, const unsigned* __restrict__ yb,
               float* __restrict__ out, long long M, long long N, long long npad) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long groups = (M + 15) / 16;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const uint4* yv = reinterpret_cast<const uint4*>(yb);
  for (long long grp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       grp < groups; grp += stride) {
    const long long r0 = grp * 16 + g;
    const long long r1 = r0 + 8;
    const bool ok0 = r0 < M, ok1 = r1 < M;
    const uint8_t* x0 = X + (ok0 ? r0 : 0) * N;
    const uint8_t* x1 = X + (ok1 ? r1 : 0) * N;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (long long c0 = 0; c0 < npad; c0 += kCols) {
      const long long c = c0 + 16 * t;
      const uint4 u0 = vampomi::load16<VEC>(x0, c, N, ok0);
      const uint4 u1 = vampomi::load16<VEC>(x1, c, N, ok1);
      uint4 ya = make_uint4(0u, 0u, 0u, 0u), yc = ya;
      if (g == 0) {  // B column 0: y at columns c .. c + 15 (8 bf16 pairs)
        ya = __ldg(yv + c / 8);
        yc = __ldg(yv + c / 8 + 1);
      }
      const unsigned yw[8] = {ya.x, ya.y, ya.z, ya.w, yc.x, yc.y, yc.z, yc.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float f0[1][4], f1[1][4];
        Codes<1>::word(vampomi::pick(u0, s), f0);
        Codes<1>::word(vampomi::pick(u1, s), f1);
        const unsigned a[4] = {vampomi::pack_exact(f0[0][0], f0[0][1]),
                               vampomi::pack_exact(f1[0][0], f1[0][1]),
                               vampomi::pack_exact(f0[0][2], f0[0][3]),
                               vampomi::pack_exact(f1[0][2], f1[0][3])};
        vampomi::mma_bf16(d, a, yw[2 * s], yw[2 * s + 1]);
      }
    }
    if (t == 0) {
      if (ok0) out[r0] = d[0];
      if (ok1) out[r1] = d[2];
    }
  }
}

template <bool VEC>
cudaError_t launch(const uint8_t* X, const unsigned* yb, float* out, long long M, long long N,
                   long long npad, cudaStream_t stream) {
  long long blocks = 0;
  cudaError_t err = vampomi::resident_blocks(atx_mxu_kernel<VEC>, kThreads, 0, &blocks);
  if (err != cudaSuccess) return err;
  const long long need = ((M + 15) / 16 + kWarps - 1) / kWarps;
  if (blocks > need) blocks = need;
  atx_mxu_kernel<VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(X, yb, out, M, N, npad);
  return cudaGetLastError();
}

}  // namespace

// yb: workspace of npad bf16 values (npad / 2 words), npad >= N a multiple of 64
extern "C" int atx_mxu_launch(const void* X, const void* y, void* yb, void* out, long long M,
                              long long N, long long npad, void* stream) {
  if (M < 1 || N < 1 || npad < N || npad % kCols != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* Xp = static_cast<const uint8_t*>(X);
  unsigned* ybp = static_cast<unsigned*>(yb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long words = npad / 2;
  long long g = (words + 255) / 256;
  if (g > 1024) g = 1024;
  round_y_kernel<<<static_cast<unsigned>(g), 256, 0, s>>>(static_cast<const float*>(y), ybp, N, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* op = static_cast<float*>(out);
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  err = vec ? launch<true>(Xp, ybp, op, M, N, npad, s) : launch<false>(Xp, ybp, op, M, N, npad, s);
  return static_cast<int>(err);
}
