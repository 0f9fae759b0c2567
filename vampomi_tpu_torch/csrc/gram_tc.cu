// G += X_b^T diag(w^2) X_b over one block of marker rows, on the tensor cores,
// for the spectral solver's Gram (ops/spectral.py gram, ops/gram_tc.py).
//
// Replaces no Pallas kernel: the JAX package's Gram is an XLA dot
// (vampomi_tpu/ops/spectral.py:111-133) that rounds w^2 x to bf16 once.
// Before this kernel the port ran the same function in full f32 through
// torch.matmul, a SIMT SGEMM on the CUDA cores near their 67 TFLOP/s.
//
// The arithmetic keeps that f32 function.  A code (int8 in [-127, 127],
// a nibble in [-8, 7]) or a bf16 value is exact in bf16.  The weighted side
// v = w^2_m x_mi is formed in f32 exactly as torch does (one rounded
// multiply), then split into three bf16 pieces,
//     h = bf16(v),  m = bf16(v - h),  l = bf16(v - h - m),
// with h + m + l == v bit for bit (8 + 8 + 8 significand bits hold f32's
// 24; the residuals are exact f32 subtractions, and at |v| ~ 1e-2 no piece
// comes near bf16's underflow).  Each code x piece product is exact in f32,
// and the three products of a marker are summed into one f32 accumulator.
//
// Two kernels a block of kb <= kpad markers:
//   * gram_tc_split_kernel, a pre-pass: decodes a 64-marker x 64-byte tile,
//     forms v and its pieces and writes, for each sample i, the bf16 rows
//     S[p][i][k] (p = 0 the code, 1-3 the pieces h, m, l; k the marker in
//     the block), transposed so that the GEMM reads both operands K-major,
//     the layout TMA's 128-byte swizzle and wgmma take without transposes.
//     Markers past kb, up to the next multiple of 64, are written as zeros.
//     Each tile also writes t's partial sum over its 64 markers,
//     sum_k fma(u_k, x_ki), in marker order (deterministic; t = X^T u is
//     summed over the partials by the caller).
//   * gram_tc_mma_kernel: persistent blocks walk the lower block triangle
//     of 128 x 128 tiles (I >= J; a diagonal tile is computed whole).  One
//     thread of a producer warpgroup keeps a ring of kStages stages full by
//     TMA: per 64 markers the three 128-row piece tiles of I and the code
//     tile of J (64 KB).  Two consumer warpgroups each own 64 rows of the
//     tile and issue, per 16 markers, three wgmma m64n128k16 bf16 products
//     (one a piece) into the same f32 registers; each stage's sums are then
//     added into a second set of f32 registers by IEEE adds (the tensor
//     cores' own f32 sums truncate; see the consumer).  At a tile's end
//     those are added into G (f32, row-major N x N),
//     masked at N.  Each tile of a launch has one owner, so no atomics: G
//     is bitwise repeatable.  Tiles above the diagonal are never written;
//     the caller mirrors the lower triangle.
//
// Bound: 3 x 2 x kb x 128^2 FLOPs a tile at the card's 989 TFLOP/s of dense
// bf16: at N = 10,240 the triangle is 3,240 of 6,400 tiles, 3.34e14 FLOPs
// for M = 1,048,576 (0.338 s).  A stage brings 64 KB for 6.3 MFLOP, so the
// loads come mostly from L2 and the tensor cores set the pace.
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return a cudaError_t (or kEncodeFailed when the tensor
// map cannot be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;                         // rows and columns of a G tile
constexpr int kStepK = 64;                         // markers a stage: one 128-byte bf16 row
constexpr int kStages = 3;
constexpr int kPieces = 3;
constexpr int kTileBytes = kTile * kStepK * 2;     // 16 KB
constexpr int kStageBytes = (kPieces + 1) * kTileBytes;
constexpr int kThreads = 384;                      // warpgroups 0-1 consume, 2 produces
constexpr size_t kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * sizeof(uint64_t);
constexpr int kSplitThreads = 256;
constexpr int kSplitLd = kStepK + 8;               // padded shared row of the pre-pass (bf16)
constexpr int kEncodeFailed = 100000;

// ---------------------------------------------------------------- pre-pass

// codes of unit j of a row: c[0] (and, packed, c[1] the high nibble's)
template <int KIND>
__device__ __forceinline__ void decode(const uint8_t* xr, long long j, bool ok, float* c) {
  if constexpr (KIND == 0) {
    c[0] = ok ? static_cast<float>(static_cast<int8_t>(xr[j])) : 0.0f;
  } else if constexpr (KIND == 1) {
    const unsigned b = ok ? xr[j] : 0x88u;
    c[0] = static_cast<float>(static_cast<int>(b & 15u) - 8);
    c[1] = static_cast<float>(static_cast<int>(b >> 4) - 8);
  } else {
    const unsigned h = ok ? reinterpret_cast<const unsigned short*>(xr)[j] : 0u;
    c[0] = __uint_as_float(h << 16);
  }
}

// KIND 0: int8 codes, one a byte; 1: packed nibbles, byte j holding samples
// j and units + j; 2: bf16 values.  Grid (ceil(units / 64), ceil(kb / 64)).
template <int KIND>
__global__ void __launch_bounds__(kSplitThreads)
gram_tc_split_kernel(const uint8_t* __restrict__ X, long long row_bytes, long long kb,
                     long long units, long long n, const float* __restrict__ w2,
                     const float* __restrict__ u, __nv_bfloat16* __restrict__ S, long long npad,
                     long long kpad, float* __restrict__ tpart) {
  constexpr int P = KIND == 1 ? 2 : 1;
  constexpr int kRows = 64 * P;  // samples of the tile
  extern __shared__ __align__(16) uint8_t split_smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(split_smem);  // [4][kRows][kSplitLd]
  float* us = reinterpret_cast<float*>(tile + 4 * kRows * kSplitLd);    // [64]
  const long long j0 = static_cast<long long>(blockIdx.x) * 64;
  const long long m0 = static_cast<long long>(blockIdx.y) * kStepK;
  const int tid = threadIdx.x;
  if (tid < kStepK) us[tid] = m0 + tid < kb ? u[m0 + tid] : 0.0f;
  const int r = tid >> 2;          // marker of the tile
  const int q0 = (tid & 3) * 16;   // first of the thread's 16 units
  const bool row_ok = m0 + r < kb;
  const float w = row_ok ? w2[m0 + r] : 0.0f;
  const uint8_t* xr = X + (m0 + r) * row_bytes;
#pragma unroll 4
  for (int q = 0; q < 16; ++q) {
    float c[P];
    decode<KIND>(xr, j0 + q0 + q, row_ok && j0 + q0 + q < units, c);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = p * 64 + q0 + q;
      const float v = __fmul_rn(w, c[p]);
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      const float r1 = __fsub_rn(v, __bfloat162float(h));
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      const float r2 = __fsub_rn(r1, __bfloat162float(mid));
      tile[(0 * kRows + i) * kSplitLd + r] = __float2bfloat16_rn(c[p]);
      tile[(1 * kRows + i) * kSplitLd + r] = h;
      tile[(2 * kRows + i) * kSplitLd + r] = mid;
      tile[(3 * kRows + i) * kSplitLd + r] = __float2bfloat16_rn(r2);
    }
  }
  __syncthreads();
  if (tid < kRows && j0 + tid % 64 < units) {  // t's partial over the tile's markers
    float acc = 0.0f;
    for (int k = 0; k < kStepK; ++k)
      acc = __fmaf_rn(us[k], __bfloat162float(tile[tid * kSplitLd + k]), acc);
    tpart[blockIdx.y * n + (tid / 64) * units + j0 + tid % 64] = acc;
  }
  for (int idx = tid; idx < 4 * kRows * 8; idx += kSplitThreads) {
    const int chunk = idx & 7;  // 8 markers: 16 bytes
    const int i = (idx >> 3) % kRows;
    const int piece = idx / (8 * kRows);
    if (j0 + i % 64 >= units) continue;
    const long long gi = (i / 64) * units + j0 + i % 64;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + (piece * kRows + i) * kSplitLd + chunk * 8);
    *reinterpret_cast<uint4*>(S + (piece * npad + gi) * kpad + m0 + chunk * 8) = v;
  }
}

// ---------------------------------------------------------------- the GEMM

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the phase of parity `parity` of the barrier has completed; a
// wait of 2^31 polls (minutes) traps, so a fault shows as a failed launch
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == 0x80000000u) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// a 2-D TMA load of box (kStepK, kTile) at (c0, c1) into dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the wgmma descriptor of a K-major bf16 tile in the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO), the tile 1024-aligned
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32, this warpgroup's registers) = A (64 x 16) B (16 x 128)^T,
// plus d unless `keep` is 0
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(keep));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// tile t of the lower block triangle, row by row: (I, J), J <= I
__device__ __forceinline__ void tile_of(int t, int& I, int& J) {
  I = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (I * (I + 1) / 2 > t) --I;
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  J = t - I * (I + 1) / 2;
}

// S, through `map`: (4 npad, kpad) bf16, rows [0, npad) the codes and
// [p npad, (p + 1) npad) piece p; ksteps = ceil(kb / kStepK)
__global__ void __launch_bounds__(kThreads, 1)
gram_tc_mma_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ G, int n, int npad,
                   int ntiles, int ksteps) {
  extern __shared__ uint8_t mma_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(mma_smem) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every load
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int I, J;
        tile_of(t, I, J);
        for (int ks = 0; ks < ksteps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStageBytes);
          uint8_t* st = smem + stage * kStageBytes;
          const int k0 = ks * kStepK;
#pragma unroll
          for (int p = 0; p < kPieces; ++p)
            tma_load(st + p * kTileBytes, &map, &full[stage], k0, (p + 1) * npad + I * kTile);
          tma_load(st + kPieces * kTileBytes, &map, &full[stage], k0, J * kTile);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of each tile
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const bool leader = threadIdx.x % 128 == 0;
  // Each stage's products are summed by the tensor cores into d, then added
  // into acc by IEEE f32 adds.  The tensor cores' f32 sums truncate: left
  // to run over a block of 16,384 markers they biased the diagonal (a sum of
  // like-signed terms) low by 3e-5 to 9e-5 on an H100.  Promoted every
  // stage, G errs less than the f32 SGEMM's (6-7e-7 against 1.8-2.4e-6 of
  // max |G| at 40,000 x 2,048); every 2 or 4 stages it erred more and ran
  // slower.  With h, m and l interleaved the diagonal of K still read low by
  // 2.0-2.6e-7 on average at 131,072 x 10,240; the small pieces first cut
  // that to 0.45-1.0e-7 at the same speed.  Two sets of d, one stage's
  // products in flight while the other's are promoted, gained ~2%: the
  // drain is not what bounds the kernel.
  float d[64];
  float acc[64];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int I, J;
    tile_of(t, I, J);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint32_t st = smem_u32(smem + stage * kStageBytes);
      const uint32_t a = st + wg * 64 * 128;  // 64 rows of 128 bytes
      const uint32_t b = st + kPieces * kTileBytes;
      fence_acc(d);
      wgmma_fence();
      // l, m, then h: the small pieces go in while d is small, so that
      // only the four products of h truncate against its full sum
#pragma unroll
      for (int p = kPieces - 1; p >= 0; --p) {
#pragma unroll
        for (int s = 0; s < kStepK / 16; ++s)
          wgmma_m64n128k16(d, desc_sw128(a + p * kTileBytes + 32 * s), desc_sw128(b + 32 * s),
                           p < kPieces - 1 || s > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(d);
      if (leader) mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // acc[4q + 2h + e] is row 16 warp + lane / 4 + 8h, column 8q + 2 (lane % 4) + e
    const long long r0 = static_cast<long long>(I) * kTile + wg * 64 + warp * 16 + lane / 4;
    const long long c0 = static_cast<long long>(J) * kTile + 2 * (lane % 4);
    const bool pairs = n % 2 == 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const long long c = c0 + 8 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = r0 + 8 * h;
        if (r >= n || c >= n) continue;
        float* g = G + r * n + c;
        if (pairs) {
          float2 v = *reinterpret_cast<float2*>(g);
          v.x += acc[4 * q + 2 * h];
          v.y += acc[4 * q + 2 * h + 1];
          *reinterpret_cast<float2*>(g) = v;
        } else {
          g[0] += acc[4 * q + 2 * h];
          if (c + 1 < n) g[1] += acc[4 * q + 2 * h + 1];
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int KIND>
cudaError_t launch_split(const uint8_t* X, long long row_bytes, long long kb, long long units,
                         long long n, const float* w2, const float* u, __nv_bfloat16* S,
                         long long npad, long long kpad, float* tpart, cudaStream_t stream) {
  constexpr int kRows = 64 * (KIND == 1 ? 2 : 1);
  constexpr size_t smem = 4 * kRows * kSplitLd * sizeof(__nv_bfloat16) + kStepK * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      gram_tc_split_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((units + 63) / 64),
                  static_cast<unsigned>((kb + kStepK - 1) / kStepK));
  gram_tc_split_kernel<KIND><<<grid, kSplitThreads, smem, stream>>>(X, row_bytes, kb, units, n, w2,
                                                                    u, S, npad, kpad, tpart);
  return cudaGetLastError();
}

}  // namespace

// The pre-pass of one block of kb marker rows at X (row_bytes a row; `units`
// bytes a row for kind 0 int8 and 1 packed, elements for 2 bf16; n samples):
// S (4, npad, kpad) bf16 and tpart (ceil(kb / 64), n) f32.  npad >= n and kpad
// >= kb are multiples of 128 and 64.
extern "C" int gram_tc_split_launch(const void* X, int kind, long long row_bytes, long long kb,
                                    long long units, long long n, const void* w2, const void* u,
                                    void* S, long long npad, long long kpad, void* tpart,
                                    void* stream) {
  if (kb < 1 || kb > kpad || kpad % kStepK != 0 || n < 1 || npad < n || npad % kTile != 0 ||
      kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* Xp = static_cast<const uint8_t*>(X);
  const float* w = static_cast<const float*>(w2);
  const float* up = static_cast<const float*>(u);
  __nv_bfloat16* Sp = static_cast<__nv_bfloat16*>(S);
  float* tp = static_cast<float*>(tpart);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kind == 0)
    err = launch_split<0>(Xp, row_bytes, kb, units, n, w, up, Sp, npad, kpad, tp, s);
  else if (kind == 1)
    err = launch_split<1>(Xp, row_bytes, kb, units, n, w, up, Sp, npad, kpad, tp, s);
  else
    err = launch_split<2>(Xp, row_bytes, kb, units, n, w, up, Sp, npad, kpad, tp, s);
  return static_cast<int>(err);
}

// G (n, n) f32 += the lower block triangle of the block's products, from S as
// the pre-pass left it for kb markers
extern "C" int gram_tc_launch(void* S, void* G, long long n, long long npad, long long kpad,
                              long long kb, void* stream) {
  if (kb < 1 || kb > kpad || kpad % kStepK != 0 || n < 1 || npad < n || npad % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeFailed;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kpad), static_cast<cuuint64_t>(4 * npad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kpad * 2)};
  const cuuint32_t box[2] = {kStepK, kTile};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, S, dims, strides, box,
                              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);
  int dev = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(gram_tc_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int side = static_cast<int>(npad / kTile);
  const int ntiles = side * (side + 1) / 2;
  const int ksteps = static_cast<int>((kb + kStepK - 1) / kStepK);
  const int grid = ntiles < sms ? ntiles : sms;
  gram_tc_mma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<float*>(G), static_cast<int>(n), static_cast<int>(npad), ntiles, ksteps);
  return static_cast<int>(cudaGetLastError());
}
