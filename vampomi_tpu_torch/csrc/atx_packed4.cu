// v = X y on the packed-int4 design: v[m] = sum_j lo(m, j) y[j] + hi(m, j) y[j + n2].
//
// Replaces the TPU Pallas kernel `atx_packed4_raw`
// (vampomi_tpu/ops/pallas_matvec.py:89-124): the P = 2, K = 1 instance of
// the row-blocked reduce kernel in xy.cuh, whose note gives the bound and
// the design.  y (N,) is its own transpose.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.

#include "xy.cuh"

extern "C" int atx_packed4_launch(const void* X, const void* y, void* out, long long M,
                                  long long n2, void* stream) {
  if (M < 1 || n2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(vampomi::xy_k<vampomi::ByteCodes<2>, 1>(
      static_cast<const uint8_t*>(X), static_cast<const float*>(y), static_cast<float*>(out), M,
      n2, vampomi::xy_vec_ok(X, y, n2), static_cast<cudaStream_t>(stream)));
}
