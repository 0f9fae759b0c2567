// Z = X^T W on the bf16 design for K <= 8 right-hand sides:
// Z[n, k] = sum_m float(X[m, n]) W[m, k].
//
// The bf16 design's broadcast pass (ax, and the engine's two-column
// ax_batch).  The JAX package computes it as an XLA einsum
// (vampomi_tpu/ops/operator.py:186-197, W rounded to bf16), with no Pallas
// kernel; here each bf16 element is widened to f32 exactly, multiplied by
// the f32 weight and summed in f32: the Bf16 instance of the broadcast
// kernel in xtw.cuh, whose note gives the bound and the two-pass design
// (a lane's 16 bytes are eight elements, so the accumulators stay at 8*K).
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return a cudaError_t; `_splits` gives the number of
// partials the workspace (splits, N, K) f32 must hold.  N is the row's
// element count.

#include "xtw.cuh"

extern "C" int ax_batch_bf16_splits(long long M, long long N, int K, long long* splits) {
  return static_cast<int>(vampomi::xtw_splits<vampomi::Bf16>(M, 2 * N, K, splits));
}

extern "C" int ax_batch_bf16_launch(const void* X, const void* W, void* work, void* out,
                                    long long M, long long N, int K, long long splits,
                                    void* stream) {
  return static_cast<int>(
      vampomi::xtw_launch<vampomi::Bf16>(X, W, work, out, M, 2 * N, K, splits, stream));
}
