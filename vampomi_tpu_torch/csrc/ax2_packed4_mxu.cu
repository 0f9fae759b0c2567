// Z = codes(X)^T bf16(W) on the tensor cores for the packed-int4 design and
// K <= 8 right-hand sides: Z[j, k] = sum_m lo(m, j) bf16(W[m, k]),
// Z[j + n2, k] = sum_m hi(m, j) bf16(W[m, k]), f32 sums.
//
// Replaces the TPU Pallas probe kernel `ax2_i4_pallas`
// (tools/r4_probe.py:139-174, K = 2, which returns Z^T): the P = 2 instance
// of the tensor-core broadcast template in mxu_xtw.cuh, whose note gives the
// bound and the design.  Its CUDA-core twin is ax_batch_packed4.cu.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return a cudaError_t; `_splits` gives the number of
// partials the workspace (splits, 2*n2, K) f32 must hold.

#include "mxu_xtw.cuh"

extern "C" int ax2_packed4_mxu_splits(long long M, long long n2, int K, long long* splits) {
  return static_cast<int>(vampomi::mxu_xtw_splits<2>(M, n2, K, splits));
}

extern "C" int ax2_packed4_mxu_launch(const void* X, const void* W, void* work, void* out,
                                      long long M, long long n2, int K, long long splits,
                                      void* stream) {
  return static_cast<int>(vampomi::mxu_xtw_launch<2>(X, W, work, out, M, n2, K, splits, stream));
}
