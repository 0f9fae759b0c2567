// Y = X Ys on the packed-int4 design for K <= 8 right-hand sides:
// Y[m, k] = sum_j lo(m, j) Ys[j, k] + hi(m, j) Ys[j + n2, k].
//
// Replaces the TPU Pallas kernel `atx_batch_packed4_raw`
// (vampomi_tpu/ops/pallas_matvec.py:183-238), with f32 products where the
// TPU rounds Ys to bf16: the instances K = 1..8 of the reduce-direction
// kernel in xy_packed4.cuh, whose note gives the bound and the design.  The
// caller passes Ys transposed, Yt (K, 2*n2) contiguous.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.

#include "xy_packed4.cuh"

extern "C" int atx_batch_packed4_launch(const void* X, const void* Yt, void* out, long long M,
                                        long long n2, int K, void* stream) {
  if (M < 1 || n2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* Xp = static_cast<const uint8_t*>(X);
  const float* Yp = static_cast<const float*>(Yt);
  float* op = static_cast<float*>(out);
  const bool vec = vampomi::xy_packed4_vec(X, Yt, n2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (K) {
    case 1: err = vampomi::xy_packed4_k<1>(Xp, Yp, op, M, n2, vec, s); break;
    case 2: err = vampomi::xy_packed4_k<2>(Xp, Yp, op, M, n2, vec, s); break;
    case 3: err = vampomi::xy_packed4_k<3>(Xp, Yp, op, M, n2, vec, s); break;
    case 4: err = vampomi::xy_packed4_k<4>(Xp, Yp, op, M, n2, vec, s); break;
    case 5: err = vampomi::xy_packed4_k<5>(Xp, Yp, op, M, n2, vec, s); break;
    case 6: err = vampomi::xy_packed4_k<6>(Xp, Yp, op, M, n2, vec, s); break;
    case 7: err = vampomi::xy_packed4_k<7>(Xp, Yp, op, M, n2, vec, s); break;
    case 8: err = vampomi::xy_packed4_k<8>(Xp, Yp, op, M, n2, vec, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
