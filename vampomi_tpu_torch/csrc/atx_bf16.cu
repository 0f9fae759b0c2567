// v = X y on the bf16 design: v[m] = sum_n float(X[m, n]) * y[n].
//
// The bf16 design's A^T y pass.  The JAX package computes it as an XLA
// einsum (vampomi_tpu/ops/operator.py:261-267, the bf16 branch of `atx`),
// with no Pallas kernel, rounding y to bf16 for the TPU's matrix unit; here
// each bf16 element is widened to f32 exactly (its bits shifted left 16),
// multiplied by the f32 entry of y and summed in f32, so y is never rounded.
// A bf16 torch.matmul would round the output to bf16, and an f32 copy of X
// would take 40 GiB at the north-star shape.
//
// Bound: bytes of X, 2 a element: 21.47 GB at M = 1,048,576 x N = 10,240,
// 6.41 ms at 3.35 TB/s, against 2 FLOPs an element (0.32 ms of f32 FMAs at
// 67 TFLOP/s).  The Bf16, K = 1 instance of the row-blocked reduce kernel in
// xy.cuh, whose note gives the design: a 16-byte load is eight elements,
// two quads of y.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch; N is the
// row's element count.

#include "xy.cuh"

extern "C" int atx_bf16_launch(const void* X, const void* y, void* out, long long M, long long N,
                               void* stream) {
  if (M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(vampomi::xy_k<vampomi::Bf16, 1>(
      static_cast<const uint8_t*>(X), static_cast<const float*>(y), static_cast<float*>(out), M,
      2 * N, vampomi::xy_vec_ok(X, y, 2 * N), static_cast<cudaStream_t>(stream)));
}
