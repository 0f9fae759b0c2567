"""The Gibbs block-update kernel's CUDA source, run on the CPU.

`vampomi_tpu_torch/csrc/gibbs_block.cu` uses a small CUDA surface: one
thread block, `__syncthreads`, `__syncwarp`, `__shfl_sync`,
`__ballot_sync`, the `_rn` intrinsics and dynamic shared memory.  Here g++
compiles it against a header that runs each CUDA thread as a std::thread
(barriers for the two syncs, a slot array for the shuffle and the ballot,
the intrinsics as plain operations under -ffp-contract=off), and the result
is held bitwise against the plain version `gibbs_block_update_plain`: both
use the host's f64 log and exp, so every draw and every x must agree
exactly.  This checks the kernel's schedule (the sub-blocks of 32 markers,
the delayed updates of c, the staged tables, the shuffles) without a card;
the card tests (`tests/test_torch_kernels_cuda.py`) and `chip_smoke.py`
hold the compiled kernel itself.  Skips where g++ is missing or has no
C++20 <barrier>.
"""

from __future__ import annotations

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from vampomi_tpu_torch.gibbs import sampler
from vampomi_tpu_torch.ops import gibbs_block as tblock

SOURCE = Path(tblock.__file__).resolve().parent.parent / "csrc" / "gibbs_block.cu"

SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct Idx { unsigned x; };
inline thread_local Idx threadIdx, blockDim;
struct Warp { std::barrier<>* bar; double slot[32]; };
inline thread_local std::barrier<>* shim_block;
inline thread_local Warp* shim_warp;
inline double* shim_smem;
inline void __syncthreads() { shim_block->arrive_and_wait(); }
inline void __syncwarp() { shim_warp->bar->arrive_and_wait(); }
template <class V> V __shfl_sync(unsigned, V v, int src) {
  Warp& w = *shim_warp;
  std::memcpy(&w.slot[threadIdx.x & 31], &v, sizeof v);
  w.bar->arrive_and_wait();
  V out;
  std::memcpy(&out, &w.slot[src], sizeof out);
  w.bar->arrive_and_wait();
  return out;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  Warp& w = *shim_warp;
  w.slot[threadIdx.x & 31] = pred ? 1.0 : 0.0;
  w.bar->arrive_and_wait();
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i) bits |= (w.slot[i] != 0.0 ? 1u : 0u) << i;
  w.bar->arrive_and_wait();
  return bits;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
template <class K, class... A> void shim_launch(K kernel, int threads, size_t bytes, A... args) {
  std::vector<double> mem(bytes / 8 + 1, std::nan(""));  // NaN: a read before a write shows
  shim_smem = mem.data();
  std::barrier<> block(threads);
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  std::vector<Warp> warps((threads + 31) / 32);
  for (auto& w : warps) { bars.emplace_back(new std::barrier<>(32)); w.bar = bars.back().get(); }
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx.x = t; blockDim.x = threads; shim_block = &block; shim_warp = &warps[t / 32];
      kernel(args...);
    });
  for (auto& th : ts) th.join();
}
"""


@pytest.fixture(scope="module")
def kernel_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA source on CPU threads")
    src = SOURCE.read_text()
    subs = [(r"extern __shared__ double smem\[\];", "double* smem = shim_smem;"),
            (r"kernel<<<1, threads, smem, static_cast<cudaStream_t>\(stream\)>>>\(",
             "shim_launch(kernel, threads, smem, ")]
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        assert n == 1, f"the kernel source no longer has {pat!r}"
    d = tmp_path_factory.mktemp("gibbs_shim")
    (d / "shim.h").write_text(SHIM)
    (d / "kernel.cpp").write_text(src)
    out = d / "kernel.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", "-include", str(d / "shim.h"), "-o", str(out),
                        str(d / "kernel.cpp")], capture_output=True, text=True)
    if r.returncode != 0 and "barrier" in r.stderr and "No such file" in r.stderr:
        pytest.skip("g++ without C++20 <barrier>")
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(out))
    for name in ("gibbs_block_f32_launch", "gibbs_block_f64_launch"):
        getattr(lib, name).argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int]
                                       + [ctypes.c_void_p] * 4)
    return lib


def _inputs(B, L, dtype, masked, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, 300)) / math.sqrt(300)
    mm = np.ones(B)
    mm[list(masked) if isinstance(masked, tuple) else rng.choice(B, masked, replace=False)] = 0.0
    vec = lambda v: torch.as_tensor(v, dtype=dtype)  # noqa: E731
    f64 = dict(dtype=torch.float64)
    return (torch.as_tensor(A @ A.T, dtype=torch.float32),
            torch.as_tensor(rng.normal(size=B) * 2, dtype=torch.float32),
            vec(rng.normal(size=B) * 0.3), vec(mm), vec(rng.uniform(size=B)),
            vec(rng.normal(size=B)), torch.as_tensor(rng.dirichlet(np.ones(L)), **f64),
            torch.as_tensor(sampler.decade_cvars(L), **f64), torch.tensor(1.7, **f64),
            torch.tensor(0.4, **f64))


def _run(lib, args, scratch):
    B, L = args[2].shape[0], args[6].shape[0]
    xb = torch.empty_like(args[2])
    comp = torch.empty(B, dtype=torch.int32)
    c = torch.empty(B, dtype=torch.float32) if scratch else None
    fn = getattr(lib, "gibbs_block_f64_launch" if args[2].dtype == torch.float64
                 else "gibbs_block_f32_launch")
    err = fn(*[t.data_ptr() for t in args], B, L, xb.data_ptr(), comp.data_ptr(),
             None if c is None else c.data_ptr(), None)
    assert err == 0
    return xb, comp


@pytest.mark.parametrize("B,L,dtype,masked,scratch", [
    (1, 4, torch.float32, 0, False), (31, 2, torch.float32, 3, False),
    (33, 4, torch.float64, 5, False), (64, 6, torch.float32, 0, True),
    (257, 4, torch.float32, (0, 31, 32, 63, 64, 255, 256), False),
    (256, 4, torch.float64, 3, True), (33, 33, torch.float32, 2, False),
    (70, 40, torch.float64, 4, False), (50, 1, torch.float32, 3, False),
    (64, 16, torch.float32, 2, False), (40, 32, torch.float64, 1, False),
    (40, 140, torch.float32, 3, False)])  # L past the tables' room: the chain computes v
def test_kernel_source_on_cpu_threads_matches_plain_bitwise(kernel_lib, B, L, dtype, masked,
                                                            scratch):
    """The kernel's schedule on CPU threads: x and the components bitwise
    equal to the plain version's, for ragged sub-blocks, L past a warp's 32
    lanes, masked markers on sub-block boundaries, c in shared memory and in
    global scratch."""
    args = _inputs(B, L, dtype, masked, seed=B * 7 + L)
    x, k = _run(kernel_lib, args, scratch)
    px, pk = tblock.gibbs_block_update_plain(*args)
    assert torch.equal(k, pk)
    assert torch.equal(x, px)
    assert bool((x[args[3] == 0] == 0).all())


@pytest.mark.parametrize("B,L,scratch", [
    (256, 4, False), (51_576, 4, False), (51_577, 4, True), (58_200, 4, True),
    (1, 132, False), (50_000, 140, False), (51_000, 140, True)])
def test_scratch_rule_follows_the_kernel_layout(B, L, scratch):
    """c goes to global scratch exactly when the kernel's shared memory
    (19,712 + 72 L bytes, the tables' 1,536 L where L <= 132, and 4 B) is past
    the 232,448 bytes a block may use."""
    assert tblock.needs_scratch(B, L) is scratch
