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
// products that are added, __dmul_rn / __dadd_rn).  The cumulative sum runs
// over l in order, and k is left unclamped in `comp` (clamped only to read
// psi, v and m), as JAX does.
//
// Bound: its bytes are the B^2 f32 of G plus the vectors (at B = 256 about
// 0.27 MB, 0.08 us at 3.35 TB/s), but the B steps depend on each other, and
// that chain of dependent f64 operations sets the time.  The design takes
// off the chain everything that does not depend on it:
//
//  - The terms of (j, l) that need only G[j][j], psi and sigma_e -- v_jl,
//    a_jl = log pi_l + (log v_jl - log psi_l)/2 and sqrt(v_jl), three
//    divisions, a log and a square root -- and G[j][j] x[j] are computed
//    ahead, one sub-block of 32 markers at a time, by the warps that do not
//    carry the chain, into a double buffer in shared memory, written as the
//    same expressions so the values are the same bits.  When those tables do
//    not fit beside the rest (L > 132) the chain computes them itself.
//  - One warp carries the chain, 32 markers (a sub-block) at a time.  Lane i
//    holds c of marker j0 + i in a register and reads column i of the
//    sub-block's 32 x 32 diagonal tile of G, staged ahead; each lane updates
//    its own c, and every lane also keeps the c of the marker to be drawn
//    next (from that lane's c and G[j][j+1], as that lane computes it), so
//    r_j needs no exchange.  For L <= 32 lane l holds component l in
//    registers: it computes m_l and the log-weight, every lane gathers the L
//    log-weights by shuffles for the max and, after each lane's exp, the L
//    weights for the sum in order l = 0..L-1; lane l keeps its cumulative
//    sum, a ballot of (cumsum_l < u * sum) counts k, and lane k's x_new,
//    formed ahead by each lane for its own component, is shuffled out.  The
//    gathers are unrolled to a bound of 4, 8, 16 or 32 with every shuffle
//    unconditional (no divergence around them).  For L > 32 lanes
//    loop over l and the log-weights, weights and means go through shared
//    memory.  No block barrier inside a sub-block.
//  - The rest of c takes the sub-block's 32 updates later.  Each c[k]
//    receives c[k] - G[j][k] d_j in j order and is read only when marker k
//    is drawn, so the updates of sub-block s are applied, in j order with
//    the same two roundings, by the chain warp to sub-block s+1's entries
//    (from a tile of G staged ahead) just before it draws them, and by the
//    other warps to every later entry while the chain draws sub-block s+1.
//    One block barrier a sub-block (B/32 in all) in place of two a marker.
//
// The per-step critical path left on the chain (L <= 32): an f64 add (r_j);
// an f64 multiply and divide (m), two multiplies and a divide (m^2/(2v))
// and an add (the log-weight); L shuffles and maxes; a subtract and an exp;
// L shuffles and adds; a multiply, a compare and a ballot (k); a shuffle
// (x_new), a multiply, a subtract and a conversion (d); an f32 multiply and
// subtract (c of the next marker).  Two f64 divisions and one exp a step,
// where a loop over l on one thread has 5 L divisions, L logs and L exps.
//
// c lives in shared memory, or past the shared-memory limit in a global
// scratch vector the caller gives.  Threads: one chain warp and
// min(ceil(B/32), 15) warps that stage ahead and update the rest of c.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;  // the chain warp keeps up to 128 registers a thread
constexpr int kSmemOptIn = 232448;  // shared memory a block may use on Hopper
constexpr int kSub = 32;            // markers a sub-block: one a lane of the chain warp
constexpr int kTile = kSub * kSub;
// a marker's staged terms: G[j][j], G[j][j] x_j, x_j, mmask_j, u_j, z_j
constexpr int kTerms = 6;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory, in bytes: 72 L + 19,712, plus 1,536 L for the tables of
// v, a and sqrt(v) when they fit (L <= 132), plus 4 B for c when it fits.
// ops/gibbs_block.py follows the same rule to decide on the scratch.
constexpr size_t kFixedBytes = 8 * 2 * kTerms * kSub + 4 * (2 * kSub + 4 * kTile);
constexpr size_t kPerL = 8 * 9;
constexpr size_t kTablePerL = 8 * 3 * 2 * kSub;

// v, a = log pi + (log v - log psi)/2 and sqrt(v) of one slab component:
// the expressions of JAX's block_update, so the values are the same bits.
__device__ __forceinline__ void slab_terms(double sjj, double se, double psi, double log_pi,
                                           double log_psi, double& v, double& a, double& sv) {
  v = 1.0 / (sjj / se + 1.0 / psi);
  a = log_pi + 0.5 * (log(v) - log_psi);
  sv = sqrt(v);
}

struct Smem {
  double* log_pi;   // L
  double* psi;      // L
  double* log_psi;  // L: log of psi where psi > 0, else 0
  double* lw;       // [2][L] a step's log-weights, by step parity
  double* w;        // [2][L] its weights
  double* m;        // [2][L] its slab means
  double* terms;    // [2][kTerms][kSub] a sub-block's per-marker terms, by sub-block parity
  double* tv;       // [2][kSub][L] v, or null when the chain computes the terms
  double* ta;       // [2][kSub][L] a
  double* ts;       // [2][kSub][L] sqrt(v)
  float* d;         // [2][kSub] a sub-block's f32 x_new - x_j
  float* diag;      // [2][kSub][kSub] rows and columns of the sub-block
  float* up;        // [2][kSub][kSub] rows of the sub-block before, columns of this one
  float* c;         // B, or the global scratch
};

__device__ Smem carve(double* base, int L, bool tab, float* c_global) {
  Smem s;
  s.log_pi = base;
  s.psi = s.log_pi + L;
  s.log_psi = s.psi + L;
  s.lw = s.log_psi + L;
  s.w = s.lw + 2 * L;
  s.m = s.w + 2 * L;
  s.terms = s.m + 2 * L;
  double* end = s.terms + 2 * kTerms * kSub;
  s.tv = tab ? end : nullptr;
  s.ta = tab ? end + 2 * kSub * L : nullptr;
  s.ts = tab ? end + 4 * kSub * L : nullptr;
  if (tab) end += 6 * kSub * L;
  s.d = reinterpret_cast<float*>(end);
  s.diag = s.d + 2 * kSub;
  s.up = s.diag + 2 * kTile;
  s.c = c_global != nullptr ? c_global : s.up + 2 * kTile;
  return s;
}

// Stage sub-block `sb` into buffer sb & 1: its markers' terms, their tables
// of v, a and sqrt(v), its diagonal tile of G and the tile of the rows
// before it; threads t0, t0 + nt, ... share the work.
template <typename T>
__device__ __forceinline__ void stage(const Smem& sm, long long sb, int t0, int nt,
                                      const float* G, const T* xb0, const T* mmask, const T* u,
                                      const T* z, double se, long long B, int L) {
  const long long j0 = sb * kSub;
  const int n = static_cast<int>(B - j0 < kSub ? B - j0 : kSub);
  const int p = static_cast<int>(sb & 1);
  double* tm = sm.terms + p * kTerms * kSub;
  for (int r = t0; r < kSub; r += nt) {
    double sjj = 0.0, xj = 0.0, mk = 0.0, uu = 0.0, zz = 0.0;
    if (r < n) {
      const long long j = j0 + r;
      sjj = static_cast<double>(G[j * B + j]);
      xj = static_cast<double>(xb0[j]);
      mk = static_cast<double>(mmask[j]);
      uu = static_cast<double>(u[j]);
      zz = static_cast<double>(z[j]);
    }
    tm[0 * kSub + r] = sjj;
    tm[1 * kSub + r] = __dmul_rn(sjj, xj);
    tm[2 * kSub + r] = xj;
    tm[3 * kSub + r] = mk;
    tm[4 * kSub + r] = uu;
    tm[5 * kSub + r] = zz;
  }
  if (sm.tv != nullptr) {
    for (int i = t0; i < kSub * L; i += nt) {
      const int r = i / L, l = i - r * L;
      if (r < n && sm.psi[l] > 0.0) {
        const long long j = j0 + r;
        double v, a, sv;
        slab_terms(static_cast<double>(G[j * B + j]), se, sm.psi[l], sm.log_pi[l], sm.log_psi[l],
                   v, a, sv);
        const int at = (p * kSub + r) * L + l;
        sm.tv[at] = v;
        sm.ta[at] = a;
        sm.ts[at] = sv;
      }
    }
  }
  for (int i = t0; i < kTile; i += nt) {
    const int r = i / kSub, q = i - r * kSub;
    sm.diag[p * kTile + i] = r < n && q < n ? G[(j0 + r) * B + j0 + q] : 0.0f;
    if (sb > 0) sm.up[p * kTile + i] = q < n ? G[(j0 - kSub + r) * B + j0 + q] : 0.0f;
  }
}

// L > 32: lane l holds components l, l + 32, ...; the log-weights, weights
// and means go through shared memory (by step parity), and every lane reads
// all L of them in order.
__device__ __forceinline__ void chain_wide(const Smem& sm, int p, int n, int L, double se,
                                           float& ci, double& myx, int& myk, float& myd) {
  const int lane = threadIdx.x & (kSub - 1);
  const double* tm = sm.terms + p * kTerms * kSub;
  const float* diag = sm.diag + p * kTile;
  for (int r = 0; r < n; ++r) {
    const double sjj = tm[r], sx = tm[kSub + r], xj = tm[2 * kSub + r];
    const double mk = tm[3 * kSub + r], uu = tm[4 * kSub + r], zz = tm[5 * kSub + r];
    const float g = diag[r * kSub + lane];
    const int row = (p * kSub + r) * L;
    double* lw = sm.lw + (r & 1) * L;
    double* w = sm.w + (r & 1) * L;
    double* m = sm.m + (r & 1) * L;
    const double rj = __dadd_rn(static_cast<double>(__shfl_sync(kFull, ci, r)), sx);
    const bool live = mk > 0.0;
    for (int l = lane; l < L; l += kSub) {
      const double ps = sm.psi[l];
      double lwl, ml = 0.0;
      if (ps > 0.0) {
        double v, a, sv;
        if (sm.tv != nullptr) {
          v = sm.tv[row + l];
          a = sm.ta[row + l];
        } else {
          slab_terms(sjj, se, ps, sm.log_pi[l], sm.log_psi[l], v, a, sv);
        }
        ml = v * rj / se;
        lwl = live ? a + 0.5 * ml * ml / v : -INFINITY;
      } else {
        lwl = live ? sm.log_pi[l] : 0.0;
      }
      lw[l] = lwl;
      m[l] = ml;
    }
    __syncwarp();
    double mx = -INFINITY;
    for (int l = 0; l < L; ++l) mx = fmax(mx, lw[l]);
    for (int l = lane; l < L; l += kSub) w[l] = exp(lw[l] - mx);
    __syncwarp();
    double total = 0.0;
    for (int l = 0; l < L; ++l) total += w[l];
    const double thr = uu * total;
    double cum = 0.0;
    int k = 0;
    for (int l = 0; l < L; ++l) {
      cum += w[l];
      k += cum < thr;
    }
    const int kk = k < L ? k : L - 1;  // JAX clamps an index past the end
    double xnew = 0.0;
    if (sm.psi[kk] > 0.0) {
      double sv;
      if (sm.tv != nullptr) {
        sv = sm.ts[row + kk];
      } else {
        double v, a;
        slab_terms(sjj, se, sm.psi[kk], sm.log_pi[kk], sm.log_psi[kk], v, a, sv);
      }
      xnew = __dadd_rn(m[kk], __dmul_rn(sv, zz));
    }
    xnew *= mk;
    const float d = static_cast<float>(xnew - xj);
    ci = __fsub_rn(ci, __fmul_rn(g, d));
    if (lane == r) {
      myx = xnew;
      myk = k;
      myd = d;
    }
  }
}

// A step's chain-free inputs, loaded one step ahead.
struct Step {
  double sx, xj, mk, uu, zz;  // G[j][j] x_j, x_j, mmask_j, u_j, z_j
  double v, a, sv;            // this lane's component's v, a and sqrt(v)
  float g, gn;                // G[j][j0 + lane], and G[j][j + 1] for the next marker's c
};

__device__ __forceinline__ Step load_step(const Smem& sm, int p, int r, int lc, bool slab, int L) {
  const double* tm = sm.terms + p * kTerms * kSub;
  const float* diag = sm.diag + p * kTile + r * kSub;
  const int lane = threadIdx.x & (kSub - 1);
  const int at = (p * kSub + r) * L + lc;
  Step s;
  s.sx = tm[kSub + r];
  s.xj = tm[2 * kSub + r];
  s.mk = tm[3 * kSub + r];
  s.uu = tm[4 * kSub + r];
  s.zz = tm[5 * kSub + r];
  s.v = slab ? sm.tv[at] : 1.0;
  s.a = slab ? sm.ta[at] : 0.0;
  s.sv = slab ? sm.ts[at] : 0.0;
  s.g = diag[lane];
  s.gn = diag[(r + 1) & (kSub - 1)];
  return s;
}

// L <= 32: lane l holds component l in registers.  Every lane keeps the c of
// the marker being drawn (from lane r + 1's c before the step's update and
// G[j][j + 1], as that lane computes it), so r_j needs no shuffle; the max
// and the in-order sums gather the L values by shuffles; lane l's
// cumulative sum is compared with u * sum and a ballot counts k; each lane
// forms its component's x_new ahead, and lane k's is shuffled out.
template <int kMaxL>
__device__ __forceinline__ void chain_narrow(const Smem& sm, int p, int n, int L, double se,
                                             float& ci, double& myx, int& myk, float& myd) {
  const int lane = threadIdx.x & (kSub - 1);
  const bool mine = lane < L;
  const int lc = mine ? lane : 0;
  const double lpi = sm.log_pi[lc];
  const bool slab = mine && sm.psi[lc] > 0.0;
  float cr = __shfl_sync(kFull, ci, 0);
  Step s = load_step(sm, p, 0, lc, slab, L);
  for (int r = 0; r < n; ++r) {
    const Step nx = r + 1 < n ? load_step(sm, p, r + 1, lc, slab, L) : s;
    const float cn = __shfl_sync(kFull, ci, (r + 1) & (kSub - 1));
    const double rj = __dadd_rn(static_cast<double>(cr), s.sx);
    const double ml = s.v * rj / se;
    const double lwl = s.mk > 0.0 ? (slab ? s.a + 0.5 * ml * ml / s.v : lpi)
                                  : (slab ? -INFINITY : 0.0);
    const double xc = slab ? __dadd_rn(ml, __dmul_rn(s.sv, s.zz)) : 0.0;
    double mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxL; ++i) {  // every shuffle unconditional: no divergence
      const double t = __shfl_sync(kFull, lwl, i);
      mx = i < L ? fmax(mx, t) : mx;
    }
    const double wl = exp(lwl - mx);
    double cum = 0.0, upto = 0.0;
#pragma unroll
    for (int i = 0; i < kMaxL; ++i) {
      const double t = __shfl_sync(kFull, wl, i);
      cum = i < L ? cum + t : cum;
      upto = i == lane ? cum : upto;
    }
    const double thr = s.uu * cum;
    const int k = __popc(__ballot_sync(kFull, mine && upto < thr));
    const int kk = k < L ? k : L - 1;  // JAX clamps an index past the end
    double xnew = __shfl_sync(kFull, xc, kk);
    xnew *= s.mk;
    const float d = static_cast<float>(xnew - s.xj);
    ci = __fsub_rn(ci, __fmul_rn(s.g, d));
    cr = __fsub_rn(cn, __fmul_rn(s.gn, d));
    if (lane == r) {
      myx = xnew;
      myk = k;
      myd = d;
    }
    s = nx;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gibbs_block_kernel(const float* __restrict__ G, const float* __restrict__ r0,
                   const T* __restrict__ xb0, const T* __restrict__ mmask,
                   const T* __restrict__ u, const T* __restrict__ z,
                   const double* __restrict__ pi, const double* __restrict__ cvars,
                   const double* __restrict__ sigma_g, const double* __restrict__ sigma_e,
                   long long B, int L, int tab, T* __restrict__ xb, int* __restrict__ comp,
                   float* __restrict__ c_global) {
  extern __shared__ double smem[];
  const Smem sm = carve(smem, L, tab != 0, c_global);
  const int tid = threadIdx.x, nt = blockDim.x;
  const double se = *sigma_e;

  for (long long t = tid; t < B; t += nt) sm.c[t] = r0[t];
  if (tid < L) {
    const double sg = *sigma_g;
    for (int l = tid; l < L; l += nt) {
      sm.log_pi[l] = log(fmax(pi[l], 1e-300));
      sm.psi[l] = cvars[l] * sg;
      sm.log_psi[l] = sm.psi[l] > 0.0 ? log(sm.psi[l]) : 0.0;
    }
  }
  __syncthreads();
  stage(sm, 0, tid, nt, G, xb0, mmask, u, z, se, B, L);
  __syncthreads();

  const long long nsub = (B + kSub - 1) / kSub;
  const int lane = tid & (kSub - 1);
  for (long long sb = 0; sb < nsub; ++sb) {
    const long long j0 = sb * kSub;
    const int p = static_cast<int>(sb & 1);
    if (tid < kSub) {
      // the chain: draw the sub-block's n markers in order
      const int n = static_cast<int>(B - j0 < kSub ? B - j0 : kSub);
      float ci = lane < n ? sm.c[j0 + lane] : 0.0f;
      if (sb > 0) {  // the sub-block before's updates, in j order
        const float* dprev = sm.d + (p ^ 1) * kSub;
        const float* up = sm.up + p * kTile;
        for (int r = 0; r < kSub; ++r) {
          ci = __fsub_rn(ci, __fmul_rn(up[r * kSub + lane], dprev[r]));
        }
      }
      double myx = 0.0;
      int myk = 0;
      float myd = 0.0f;
      if (L <= 4) {
        chain_narrow<4>(sm, p, n, L, se, ci, myx, myk, myd);
      } else if (L <= 8) {
        chain_narrow<8>(sm, p, n, L, se, ci, myx, myk, myd);
      } else if (L <= 16) {
        chain_narrow<16>(sm, p, n, L, se, ci, myx, myk, myd);
      } else if (L <= kSub) {
        chain_narrow<kSub>(sm, p, n, L, se, ci, myx, myk, myd);
      } else {
        chain_wide(sm, p, n, L, se, ci, myx, myk, myd);
      }
      if (lane < n) {
        xb[j0 + lane] = static_cast<T>(myx);
        comp[j0 + lane] = myk;
      }
      sm.d[p * kSub + lane] = myd;
    } else {
      // the rest: the sub-block before's updates to every entry past this
      // sub-block, then the next sub-block staged
      const int ht = tid - kSub, nh = nt - kSub;
      if (sb > 0) {
        const float* dprev = sm.d + (p ^ 1) * kSub;
        const float* g = G + (j0 - kSub) * B;
        for (long long t = j0 + kSub + ht; t < B; t += nh) {
          float ct = sm.c[t];
#pragma unroll
          for (int r = 0; r < kSub; ++r) ct = __fsub_rn(ct, __fmul_rn(g[r * B + t], dprev[r]));
          sm.c[t] = ct;
        }
      }
      if (sb + 1 < nsub) stage(sm, sb + 1, ht, nh, G, xb0, mmask, u, z, se, B, L);
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
  const long long warps = (B + kSub - 1) / kSub + 1;
  const int threads = static_cast<int>(warps < kMaxThreads / kSub ? warps * kSub : kMaxThreads);
  const size_t base = kFixedBytes + kPerL * static_cast<size_t>(L);
  const bool tab = base + kTablePerL * L <= static_cast<size_t>(kSmemOptIn);
  const size_t smem = base + (tab ? kTablePerL * L : 0) + (c_scratch ? 0 : B * sizeof(float));
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
      tab ? 1 : 0, static_cast<T*>(xb), static_cast<int*>(comp),
      static_cast<float*>(c_scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G (B, B) f32; r0 (B,) f32; xb0, mmask, u, z, xb (B,) in the work dtype
// (f32 here, f64 below); pi, cvars (L,) f64; sigma_g, sigma_e one f64 each
// on the card; comp (B,) int32; c_scratch null, or B f32 of global scratch
// for c when B f32 do not fit in shared memory beside the rest (the rule
// above kFixedBytes).
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
