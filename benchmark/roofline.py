"""The yardstick of the kernels: the card's published peaks and the least
time of a piece of work (a copy of the port's tools arithmetic,
vampomi_tpu_torch/tools/__init__.py bound_ms, matvec_bound).

A pass over the design reads every byte of it once, at 2 operations per
code and vector: at the cells' K <= 2 vectors the bytes bind (10 GiB take
3.2 ms at 3.35 TB/s, its operations 0.64 ms at 67 TFLOP/s), so a pass's
least time is its design's bytes at HBM_BPS.  The vectors it reads and
writes, (M + N) x K floats, are under 0.1% of the design and are left out,
so the bound is never counted high.
"""

from __future__ import annotations

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes
# per second, FLOPs per second of f32 on the CUDA cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def bound_s(nbytes: float, ops: float, ops_rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least seconds for work that moves `nbytes` through HBM and does
    `ops` operations at `ops_rate`: the larger time, and which sets it."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / ops_rate
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def design_bytes(m: int, n: int, packed: bool) -> int:
    """Bytes of the stored design: M x N int8 codes, or M x N/2 packed bytes."""
    return m * (n // 2 if packed else n)
