// Z = X^T bf16(W) on the tensor cores for (M, N) int8 codes and K <= 8
// right-hand sides: Z[j, k] = sum_m X[m, j] bf16(W[m, k]), f32 sums.
//
// Replaces the TPU Pallas probe kernel `ax_mxu`
// (tools/matvec_floor_probe.py:168-200, K = 1): the P = 1 instance of the
// tensor-core broadcast template in mxu_xtw.cuh, whose note gives the bound
// and the design.  Its CUDA-core twin is ax_batch_int8.cu.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return a cudaError_t; `_splits` gives the number of
// partials the workspace (splits, N, K) f32 must hold.

#include "mxu_xtw.cuh"

extern "C" int ax_mxu_splits(long long M, long long N, int K, long long* splits) {
  return static_cast<int>(vampomi::mxu_xtw_splits<1>(M, N, K, splits));
}

extern "C" int ax_mxu_launch(const void* X, const void* W, void* work, void* out, long long M,
                             long long N, int K, long long splits, void* stream) {
  return static_cast<int>(vampomi::mxu_xtw_launch<1>(X, W, work, out, M, N, K, splits, stream));
}
