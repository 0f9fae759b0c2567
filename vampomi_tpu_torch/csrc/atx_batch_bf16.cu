// Y = X Ys on the bf16 design for K <= 8 right-hand sides:
// Y[m, k] = sum_n float(X[m, n]) Ys[n, k].
//
// The A^T pass of multi-right-hand-side CG on the bf16 design.  The JAX
// package computes it as an XLA einsum (vampomi_tpu/ops/operator.py:334-340,
// Ys rounded to bf16), with no Pallas kernel; here each bf16 element is
// widened to f32 exactly, multiplied by the f32 entry and summed in f32.
// The Bf16 instances, K = 1..8, of the row-blocked reduce kernel in xy.cuh,
// whose note gives the bound and the design.  The caller passes Ys
// transposed, Yt (K, N) contiguous.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch; N is the
// row's element count.

#include "xy.cuh"

extern "C" int atx_batch_bf16_launch(const void* X, const void* Yt, void* out, long long M,
                                     long long N, int K, void* stream) {
  return static_cast<int>(vampomi::xy_launch<vampomi::Bf16>(X, Yt, out, M, 2 * N, K, stream));
}
