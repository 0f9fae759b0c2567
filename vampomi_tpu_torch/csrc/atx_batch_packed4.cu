// Y = X Ys on the packed-int4 design for K <= 8 right-hand sides:
// Y[m, k] = sum_j lo(m, j) Ys[j, k] + hi(m, j) Ys[j + n2, k].
//
// Replaces the TPU Pallas kernel `atx_batch_packed4_raw`
// (vampomi_tpu/ops/pallas_matvec.py:183-238), with f32 products where the
// TPU rounds Ys to bf16: the P = 2 instances, K = 1..8, of the row-blocked
// reduce kernel in xy.cuh, whose note gives the bound and the design.  The
// caller passes Ys transposed, Yt (K, 2*n2) contiguous.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.

#include "xy.cuh"

extern "C" int atx_batch_packed4_launch(const void* X, const void* Yt, void* out, long long M,
                                        long long n2, int K, void* stream) {
  return static_cast<int>(vampomi::xy_launch<vampomi::ByteCodes<2>>(X, Yt, out, M, n2, K, stream));
}
