"""Build and load the port's hand-written CUDA kernels and its host IO
runtime.

Each kernel library is a `.cu` file under `vampomi_tpu_torch/csrc/` with a
plain C entry point; it may include headers (`*.cuh`) from the same
directory.  It is compiled with nvcc into a shared library at first use and
loaded with ctypes: no PyTorch headers are included, so a build takes
seconds, not the minutes `torch.utils.cpp_extension.load` needs.  A `.cpp`
file there (`host_io.cpp`, the native IO runtime of io/native.py) is host
code: the C++ compiler builds it the same way, so it runs on the CPU too.

Libraries go to `build/vampomi_tpu_torch/` at the repository root, named by a
hash of the source, every header it includes and the flags, so an edited
source or header rebuilds and a second process reuses the first one's build.
`build_all` starts one nvcc per library, all at once.  A build is written
to a temporary file and renamed into place, so processes that build the
same library at once never see half a file; threads of one process take
`_LOCK` around the whole build and load, so only one of them builds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vampomi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# the flags of the JAX package's native extension (setup.py:20-22)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-D_FILE_OFFSET_BITS=64")
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
_FUNCTIONS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
# seconds from the start of each build in this process until it was seen
# finished (0.0 when the library was already built)
BUILD_SECONDS: dict[str, float] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, the standard toolkit location, or PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels of vampomi_tpu_torch are built from source "
            "at first use"
        )
    return found


def find_cxx() -> str:
    """The host C++ compiler: c++ or g++ on PATH."""
    found = shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "no C++ compiler (c++ or g++) on PATH: the native IO runtime of "
            "vampomi_tpu_torch (csrc/host_io.cpp) is built from source at first use")
    return found


def _main_source(name: str) -> Path:
    """csrc/<name>.cpp for host code, else the kernel csrc/<name>.cu."""
    cpp = CSRC / f"{name}.cpp"
    return cpp if cpp.exists() else CSRC / f"{name}.cu"


def _flags(name: str) -> tuple[str, ...]:
    return HOST_FLAGS if _main_source(name).suffix == ".cpp" else NVCC_FLAGS


def sources(name: str) -> list[Path]:
    """`csrc/<name>.cu` (or `.cpp`) and every header it includes from csrc/,
    transitively."""
    seen: list[Path] = []
    todo = [_main_source(name)]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(f.read_bytes())]
    return seen


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for f in sorted(sources(name)):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, ctypes.CDLL]:
    """The loaded shared libraries of `csrc/<name>.cu` (or `.cpp`) for each
    name, the missing ones built in parallel (one compiler process each:
    nvcc for a kernel, the host C++ compiler for host code).

    Raises RuntimeError with the compiler's output when a build fails."""
    with _LOCK:
        return _build_all(names)


def _build_all(names) -> dict[str, ctypes.CDLL]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in dict.fromkeys(names):
        if name in _LOADED:
            continue
        so = _library_path(name)
        if so.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        src = _main_source(name)
        compiler = find_cxx() if src.suffix == ".cpp" else find_nvcc()
        cmd = [compiler, *_flags(name), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, cmd, tmp, so, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, so, t0) in started.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(cmd[0])} failed to build {name} "
                          f"(exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(_library_path(name)))
    return {name: _LOADED[name] for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/<name>.cu` (or `.cpp`), built if
    needed."""
    return build_all([name])[name]


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of library `name`, returning a cudaError_t
    as an int; looked up once per process (a wrapper calls this on every
    launch, and the lookup cost ~60 us of host time a call on the H100's
    host)."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[(name, symbol)] = fn
    return fn


def check_launch(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {err}")
