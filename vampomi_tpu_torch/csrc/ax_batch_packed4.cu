// Z = X^T W on the packed-int4 design for K <= 8 right-hand sides:
// Z[j, k] = sum_m lo(m, j) W[m, k],  Z[j + n2, k] = sum_m hi(m, j) W[m, k].
//
// Replaces the TPU Pallas kernel `ax_batch_packed4_raw`
// (vampomi_tpu/ops/pallas_matvec.py:127-180), with f32 products where the
// TPU rounds W to bf16: the P = 2 instance of the broadcast kernel in
// xtw.cuh, whose note gives the bound and the two-pass design.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return a cudaError_t; `_splits` gives the number of
// partials the workspace (splits, 2*n2, K) f32 must hold.

#include "xtw.cuh"

extern "C" int ax_batch_packed4_splits(long long M, long long n2, int K, long long* splits) {
  return static_cast<int>(vampomi::xtw_splits<vampomi::ByteCodes<2>>(M, n2, K, splits));
}

extern "C" int ax_batch_packed4_launch(const void* X, const void* W, void* work, void* out,
                                       long long M, long long n2, int K, long long splits,
                                       void* stream) {
  return static_cast<int>(
      vampomi::xtw_launch<vampomi::ByteCodes<2>>(X, W, work, out, M, n2, K, splits, stream));
}
