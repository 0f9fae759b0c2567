"""Environment health check: `python -m vampomi_tpu_torch.doctor` (port of
vampomi_tpu/doctor.py).

Probes each dependency of the port up front and prints one PASS/WARN/FAIL
line per check; exit code 0 when nothing FAILs, else 1.  The checks, in
dependency order: torch, numpy and scipy import (jax is not asked for);
a CUDA card is visible (its name), and its power limit (from nvidia-smi, a
WARN where that tool is missing); nvcc is found and accepts `-arch=sm_90a`;
every kernel source `csrc/*.cu` builds through `ops/_build.py`; one small
launch each of `atx_int8` and `gibbs_block_update` matches its plain
version.  Every device probe runs in a subprocess under a deadline, so a
card or a build that hangs becomes a FAIL line, not a hung doctor.  The JAX
package's relay probe and compile-cache check have no counterpart here.

On a machine without a card the host check PASSes and the CUDA checks FAIL
(exit 1).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

_GREEN, _YELLOW, _RED, _OFF = "\033[32m", "\033[33m", "\033[31m", "\033[0m"
_ROOT = Path(__file__).resolve().parents[1]  # the directory holding the package


def _line(status: str, name: str, detail: str) -> bool:
    color = {"PASS": _GREEN, "WARN": _YELLOW, "FAIL": _RED}[status]
    tag = f"{color}{status}{_OFF}" if sys.stdout.isatty() else status
    print(f"[{tag}] {name:<22} {detail}", flush=True)
    return status != "FAIL"


def _probe(code: str, timeout_s: float):
    """Run `code` in a fresh interpreter, with the package importable, under
    a deadline; None on timeout."""
    try:
        return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=timeout_s, cwd=_ROOT)
    except subprocess.TimeoutExpired:
        return None


def _probe_line(name: str, code: str, timeout_s: float) -> bool:
    """A check whose probe prints `OK <detail>` as its last line on success."""
    out = _probe(code, timeout_s)
    if out is None:
        return _line("FAIL", name, f"hang: no answer within {timeout_s:.0f}s")
    lines = (out.stdout or "").strip().splitlines()
    if out.returncode == 0 and lines and lines[-1].startswith("OK"):
        return _line("PASS", name, lines[-1][2:].strip())
    tail = (out.stderr or out.stdout or "").strip().splitlines()
    return _line("FAIL", name, tail[-1] if tail else f"probe exited {out.returncode}")


def check_python_deps() -> bool:
    missing, versions = [], []
    for mod in ("torch", "numpy", "scipy"):
        try:
            versions.append(f"{mod} {__import__(mod).__version__}")
        except ImportError:
            missing.append(mod)
    if missing:
        return _line("FAIL", "python deps", f"missing: {', '.join(missing)}")
    return _line("PASS", "python deps", ", ".join(versions))


def check_cuda(timeout_s: float = 60.0) -> bool:
    code = (
        "import torch\n"
        "assert torch.cuda.is_available(), 'torch.cuda.is_available() is False'\n"
        "x = torch.ones((512, 512), device='cuda')\n"
        "v = float((x @ x)[0, 0])\n"
        "assert v == 512.0, f'512x512 matmul gave {v}'\n"
        "print(f'OK {torch.cuda.device_count()}x {torch.cuda.get_device_name(0)}, "
        "torch {torch.__version__}, CUDA {torch.version.cuda}')\n"
    )
    return _probe_line("cuda device", code, timeout_s)


def check_power_limit(timeout_s: float = 30.0) -> bool:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return _line("WARN", "power limit", "nvidia-smi not found: the card's power limit "
                                            "is unknown")
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return _line("FAIL", "power limit", f"nvidia-smi gave no answer within {timeout_s:.0f}s")
    if out.returncode != 0 or not out.stdout.strip():
        tail = (out.stderr or out.stdout).strip().splitlines()
        return _line("FAIL", "power limit", tail[-1] if tail else "nvidia-smi failed")
    return _line("PASS", "power limit", "; ".join(out.stdout.strip().splitlines()))


def check_nvcc(timeout_s: float = 120.0) -> bool:
    from .ops import _build

    try:
        nvcc = _build.find_nvcc()
    except RuntimeError as e:
        return _line("FAIL", "nvcc", str(e))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"doctor-{os.getpid()}.cu"
    obj = src.with_suffix(".o")
    src.write_text("__global__ void doctor_probe(float* x) { x[threadIdx.x] += 1.0f; }\n")
    try:
        out = subprocess.run([nvcc, "-arch=sm_90a", "-c", str(src), "-o", str(obj)],
                             capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return _line("FAIL", "nvcc", f"{nvcc}: no answer within {timeout_s:.0f}s")
    finally:
        src.unlink(missing_ok=True)
        obj.unlink(missing_ok=True)
    if out.returncode != 0:
        tail = (out.stderr or out.stdout).strip().splitlines()
        return _line("FAIL", "nvcc", f"-arch=sm_90a refused: {tail[-1] if tail else ''}")
    return _line("PASS", "nvcc", f"{nvcc} accepts -arch=sm_90a")


def kernel_names() -> list[str]:
    from .ops import _build

    return sorted(p.stem for p in _build.CSRC.glob("*.cu"))


def check_kernel_builds(timeout_s: float = 600.0) -> bool:
    code = (
        "from vampomi_tpu_torch.ops import _build\n"
        f"names = {kernel_names()!r}\n"
        "_build.build_all(names)\n"
        "built = sum(1 for n in names if _build.BUILD_SECONDS.get(n, 0.0) > 0.0)\n"
        "print(f'OK {len(names)} libraries under {_build.BUILD_DIR} '\n"
        "      f'({built} built now, in parallel)')\n"
    )
    return _probe_line("kernel builds", code, timeout_s)


def check_kernel_launches(timeout_s: float = 300.0) -> bool:
    code = (
        "import numpy as np, torch\n"
        "assert torch.cuda.is_available(), 'torch.cuda.is_available() is False'\n"
        "from vampomi_tpu_torch.ops.atx_int8 import atx_int8, atx_int8_plain\n"
        "from vampomi_tpu_torch.ops.gibbs_block import gibbs_block_update, "
        "gibbs_block_update_plain\n"
        "from vampomi_tpu_torch.gibbs.sampler import decade_cvars\n"
        "rng = np.random.default_rng(0)\n"
        "dev = torch.device('cuda')\n"
        "X = torch.as_tensor(rng.integers(-127, 128, (1000, 4096)), dtype=torch.int8, "
        "device=dev)\n"
        "y = torch.as_tensor(rng.normal(size=4096), dtype=torch.float32, device=dev)\n"
        "v, pv = atx_int8(X, y), atx_int8_plain(X, y)\n"
        "err = float((v - pv).abs().max() / pv.abs().max())\n"
        "assert err < 1e-5, f'atx_int8 off its plain version by {err:.2e} relative'\n"
        "B, L = 256, 4\n"
        "A = torch.as_tensor(rng.normal(size=(B, 300)) / np.sqrt(300), dtype=torch.float32, "
        "device=dev)\n"
        "f64 = dict(dtype=torch.float64, device=dev)\n"
        "vec = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)\n"
        "args = (A @ A.T, vec(rng.normal(size=B) * 2), vec(rng.normal(size=B) * 0.3), "
        "vec(np.ones(B)), vec(rng.uniform(size=B)), vec(rng.normal(size=B)), "
        "torch.as_tensor(rng.dirichlet(np.ones(L)), **f64), "
        "torch.as_tensor(decade_cvars(L), **f64), torch.tensor(1.7, **f64), "
        "torch.tensor(0.4, **f64))\n"
        "(x, k), (px, pk) = gibbs_block_update(*args), gibbs_block_update_plain(*args)\n"
        "torch.cuda.synchronize()\n"
        "assert torch.equal(k, pk), 'gibbs_block_update components differ from plain'\n"
        "gx = float((x - px).abs().max() / px.abs().max())\n"
        "assert gx < 1e-6, f'gibbs_block_update x off plain by {gx:.2e} relative'\n"
        "print(f'OK atx_int8 (1000 x 4096) to {err:.1e}, gibbs_block_update (B = 256, L = 4) '\n"
        "      f'components equal, x to {gx:.1e}')\n"
    )
    return _probe_line("kernel launches", code, timeout_s)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    timeout = float(args[1]) if args[:1] == ["--device-timeout"] else 60.0
    ok = check_python_deps()
    ok &= check_cuda(timeout)
    ok &= check_power_limit()
    nvcc_ok = check_nvcc()
    ok &= nvcc_ok
    if nvcc_ok:
        ok &= check_kernel_builds()
    else:
        ok &= _line("FAIL", "kernel builds", "skipped: no working nvcc")
    ok &= check_kernel_launches(max(timeout, 300.0))
    print("doctor:", "healthy" if ok else "PROBLEMS FOUND", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
