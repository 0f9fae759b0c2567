// Z = X^T W on the int8 design for K <= 8 right-hand sides:
// Z[n, k] = sum_m X[m, n] W[m, k].
//
// Replaces the TPU Pallas kernel `ax2_i8_pallas` / `_ax2_i8_kernel`
// (tools/r4_probe.py:77-103, K = 2), with f32 products where the TPU rounds
// W to bf16, for any K <= 8: the P = 1 instance of the broadcast kernel in
// xtw.cuh, whose note gives the bound and the two-pass design.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return a cudaError_t; `_splits` gives the number of
// partials the workspace (splits, N, K) f32 must hold.

#include "xtw.cuh"

extern "C" int ax_batch_int8_splits(long long M, long long N, int K, long long* splits) {
  return static_cast<int>(vampomi::xtw_splits<vampomi::ByteCodes<1>>(M, N, K, splits));
}

extern "C" int ax_batch_int8_launch(const void* X, const void* W, void* work, void* out,
                                    long long M, long long N, int K, long long splits,
                                    void* stream) {
  return static_cast<int>(
      vampomi::xtw_launch<vampomi::ByteCodes<1>>(X, W, work, out, M, N, K, splits, stream));
}
