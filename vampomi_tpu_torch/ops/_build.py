"""Build and load the port's hand-written CUDA kernels.

Each kernel is a `.cu` file under `vampomi_tpu_torch/csrc/` with a plain C
entry point.  It is compiled with nvcc into a shared library at first use and
loaded with ctypes: no PyTorch headers are included, so a build takes
seconds, not the minutes `torch.utils.cpp_extension.load` needs.

Libraries go to `build/vampomi_tpu_torch/` at the repository root, named by a
hash of the source and the flags, so an edited source rebuilds and a second
process reuses the first one's build.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vampomi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}
# seconds each build took in this process (0.0 when the library was cached)
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


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/<name>.cu`, built if needed.

    Raises RuntimeError with nvcc's output when the build fails."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{name}-{key}.so"
    t0 = time.perf_counter()
    if not so.exists():
        tmp = BUILD_DIR / f"{name}-{key}.{os.getpid()}.tmp.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _LOADED[name] = lib
    return lib
