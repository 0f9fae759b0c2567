// Sequential spike-and-slab Gibbs draws over one block of B markers, given
// the block's Gram G_b = A_b A_b^T:
//
//   for j in 0..B-1:
//     r_j   = c[j] + G[j][j] x[j]                      (f64)
//     v_l   = 1 / (G[j][j]/sigma_e + 1/psi_l),  m_l = v_l r_j / sigma_e
//     log w_l = log pi_l + (log v_l - log psi_l)/2 + m_l^2/(2 v_l)   (psi_l > 0)
//             = log pi_l                                            (psi_l = 0)
//     k     = #{l : cumsum(w)_l < u_j * sum(w)}         (categorical draw)
//     x_new = psi_k > 0 ? m_k + sqrt(v_k) z_j : 0,  times mmask_j
//     c    -= G[j] * f32(x_new - x[j])                  (f32, two roundings)
//
// with psi = cvars * sigma_g.  A masked marker (mmask_j = 0) gives the spike
// a log-weight of 0 and every slab -inf, so k = 0 and x_new = 0.
//
// It replaces `block_update` (vampomi_tpu/gibbs/sampler.py:128), an XLA
// `fori_loop` over the B markers, with no Pallas kernel.  The arithmetic is
// that function's, in the same precisions: the conditional in f64, the local
// correlations c in f32, and the update of c as a product and a difference
// each rounded (__fmul_rn / __fsub_rn, so nvcc cannot contract them into one
// FMA that JAX and the plain version do not do; the same for the two f64
// products that are added, __dmul_rn / __dadd_rn).
//
// Bound: its bytes are the B^2 f32 of G plus the vectors (at B = 256 about
// 0.27 MB, 0.08 us at 3.35 TB/s), but the B steps depend on each other:
// each is an L-way f64 log / exp chain on one thread and two block-wide
// barriers, and that chain sets the time.  The design does nothing about it
// yet; it is right first: one thread block per call, c in shared memory
// (or, past the shared-memory limit, in a global scratch vector), thread 0
// draws marker j and publishes d = x_new - x_j through shared memory, then
// every thread updates its entries of c from row j of G, read coalesced
// from global memory.  Threads: min(B, 1024) rounded up to a warp, with a
// strided loop for larger B.  The L log-weights live in shared memory
// beside pi, psi and log psi, so L has no fixed cap.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemOptIn = 232448;  // shared memory a block may use on Hopper

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gibbs_block_kernel(const float* __restrict__ G, const float* __restrict__ r0,
                   const T* __restrict__ xb0, const T* __restrict__ mmask,
                   const T* __restrict__ u, const T* __restrict__ z,
                   const double* __restrict__ pi, const double* __restrict__ cvars,
                   const double* __restrict__ sigma_g, const double* __restrict__ sigma_e,
                   long long B, int L, T* __restrict__ xb, int* __restrict__ comp,
                   float* __restrict__ c_global) {
  extern __shared__ double smem[];
  double* log_pi = smem;          // L
  double* psi = log_pi + L;       // L
  double* log_psi = psi + L;      // L: log of psi where psi > 0, else 0
  double* logw = log_psi + L;     // L: the current marker's log-weights, then weights
  float* c = c_global != nullptr ? c_global : reinterpret_cast<float*>(logw + L);
  __shared__ float d_shared;

  const double se = *sigma_e;
  for (long long t = threadIdx.x; t < B; t += blockDim.x) {
    c[t] = r0[t];
    xb[t] = xb0[t];
  }
  if (threadIdx.x == 0) {
    const double sg = *sigma_g;
    for (int l = 0; l < L; ++l) {
      log_pi[l] = log(fmax(pi[l], 1e-300));
      psi[l] = cvars[l] * sg;
      log_psi[l] = psi[l] > 0.0 ? log(psi[l]) : 0.0;
    }
  }
  __syncthreads();

  for (long long j = 0; j < B; ++j) {
    if (threadIdx.x == 0) {
      const double sjj = static_cast<double>(G[j * B + j]);
      const double xj = static_cast<double>(xb[j]);
      const double rj = __dadd_rn(static_cast<double>(c[j]), __dmul_rn(sjj, xj));
      const bool live = static_cast<double>(mmask[j]) > 0.0;
      double mx = -INFINITY;
      for (int l = 0; l < L; ++l) {
        double lw;
        if (!live) {
          lw = psi[l] > 0.0 ? -INFINITY : 0.0;
        } else if (psi[l] > 0.0) {
          const double v = 1.0 / (sjj / se + 1.0 / psi[l]);
          const double m = v * rj / se;
          lw = log_pi[l] + 0.5 * (log(v) - log_psi[l]) + 0.5 * m * m / v;
        } else {
          lw = log_pi[l];
        }
        logw[l] = lw;
        mx = fmax(mx, lw);
      }
      double total = 0.0;
      for (int l = 0; l < L; ++l) {
        logw[l] = exp(logw[l] - mx);
        total += logw[l];
      }
      const double thr = static_cast<double>(u[j]) * total;
      double cum = 0.0;
      int k = 0;
      for (int l = 0; l < L; ++l) {
        cum += logw[l];
        k += cum < thr;
      }
      const int kk = k < L ? k : L - 1;  // JAX clamps an index past the end
      double xnew = 0.0;
      if (psi[kk] > 0.0) {
        const double v = 1.0 / (sjj / se + 1.0 / psi[kk]);
        xnew = __dadd_rn(v * rj / se, __dmul_rn(sqrt(v), static_cast<double>(z[j])));
      }
      xnew *= static_cast<double>(mmask[j]);
      d_shared = static_cast<float>(xnew - xj);
      xb[j] = static_cast<T>(xnew);
      comp[j] = k;
    }
    __syncthreads();
    const float d = d_shared;
    const float* g = G + j * B;
    for (long long t = threadIdx.x; t < B; t += blockDim.x) {
      c[t] = __fsub_rn(c[t], __fmul_rn(g[t], d));
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* G, const void* r0, const void* xb0, const void* mmask, const void* u,
           const void* z, const void* pi, const void* cvars, const void* sigma_g,
           const void* sigma_e, long long B, int L, void* xb, void* comp, void* c_scratch,
           void* stream) {
  if (B < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (B < kMaxThreads ? B : kMaxThreads);
  const int threads = static_cast<int>((want + 31) / 32 * 32);
  const size_t smem = 4 * L * sizeof(double) + (c_scratch ? 0 : B * sizeof(float));
  if (smem > static_cast<size_t>(kSmemOptIn)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gibbs_block_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(G), static_cast<const float*>(r0), static_cast<const T*>(xb0),
      static_cast<const T*>(mmask), static_cast<const T*>(u), static_cast<const T*>(z),
      static_cast<const double*>(pi), static_cast<const double*>(cvars),
      static_cast<const double*>(sigma_g), static_cast<const double*>(sigma_e), B, L,
      static_cast<T*>(xb), static_cast<int*>(comp), static_cast<float*>(c_scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G (B, B) f32; r0 (B,) f32; xb0, mmask, u, z, xb (B,) in the work dtype
// (f32 here, f64 below); pi, cvars (L,) f64; sigma_g, sigma_e one f64 each
// on the card; comp (B,) int32; c_scratch null, or B f32 of global scratch
// for c when B f32 do not fit in shared memory beside the 4 L f64.
extern "C" int gibbs_block_f32_launch(const void* G, const void* r0, const void* xb0,
                                      const void* mmask, const void* u, const void* z,
                                      const void* pi, const void* cvars, const void* sigma_g,
                                      const void* sigma_e, long long B, int L, void* xb,
                                      void* comp, void* c_scratch, void* stream) {
  return launch<float>(G, r0, xb0, mmask, u, z, pi, cvars, sigma_g, sigma_e, B, L, xb, comp,
                       c_scratch, stream);
}

extern "C" int gibbs_block_f64_launch(const void* G, const void* r0, const void* xb0,
                                      const void* mmask, const void* u, const void* z,
                                      const void* pi, const void* cvars, const void* sigma_g,
                                      const void* sigma_e, long long B, int L, void* xb,
                                      void* comp, void* c_scratch, void* stream) {
  return launch<double>(G, r0, xb0, mmask, u, z, pi, cvars, sigma_g, sigma_e, B, L, xb, comp,
                        c_scratch, stream);
}
