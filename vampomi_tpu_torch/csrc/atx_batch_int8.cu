// Y = X Ys on the int8 design for K <= 8 right-hand sides:
// Y[m, k] = sum_n X[m, n] Ys[n, k].
//
// The A^T pass of multi-right-hand-side CG.  The JAX package computes it as
// an XLA einsum (vampomi_tpu/ops/operator.py:334-340, Ys rounded to bf16),
// with no Pallas kernel; here every int8 code is upcast exactly to f32,
// multiplied by the f32 entry and summed in f32.  The P = 1 instances,
// K = 1..8, of the row-blocked reduce kernel in xy.cuh, whose note gives
// the bound and the design.  The caller passes Ys transposed, Yt (K, N)
// contiguous.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.

#include "xy.cuh"

extern "C" int atx_batch_int8_launch(const void* X, const void* Yt, void* out, long long M,
                                     long long N, int K, void* stream) {
  return static_cast<int>(vampomi::xy_launch<vampomi::ByteCodes<1>>(X, Yt, out, M, N, K, stream));
}
