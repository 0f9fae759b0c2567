"""Run configuration: the JAX package's `RunConfig` (vampomi_tpu/config.py)
with the same fields and defaults, plus `device`, the counterpart of JAX's
platform choice.

Devices are explicit: `resolve_device("cuda")` raises when no card is
present, and never runs on the CPU instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

DEFAULT_VARS = [0.0, 1e-06, 6e-06, 3e-05, 2e-04, 1e-03, 6e-03, 3e-02, 2e-01, 1.0]
DEFAULT_PROBS = [
    9.90000e-01, 5.00000e-03, 2.50000e-03, 1.25000e-03, 6.25000e-04,
    3.12500e-04, 1.56250e-04, 7.81250e-05, 3.90625e-05, 3.90625e-05,
]

_DTYPES = {
    "float64": torch.float64, "f64": torch.float64,
    "float32": torch.float32, "f32": torch.float32,
    # per-marker affine-quantized design (ops/operator.py quantize_markers)
    "int8": torch.int8, "i8": torch.int8,
    # packed 4-bit design, two codes per byte (ops/operator.py PACKED4_DTYPE)
    "int4": torch.uint8, "i4": torch.uint8,
    # the raw values rounded to bf16 (ops/operator.py build_design)
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def resolve_device(name: str | torch.device) -> torch.device:
    """The torch.device for `name` ("cuda", "cuda:1", "cpu").

    "cuda" without a usable card raises.  On a card, TF32 is switched off
    for matmuls and convolutions: the package relies on full-f32 products
    (the JAX package asks for Precision.HIGHEST throughout its operator and
    solvers)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available() "
                "is False: pass --device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (cuda or cpu)")
    return dev


@dataclass
class RunConfig:
    # files
    meth_file: str = ""
    meth_file_test: str = ""
    phen_file: str = ""
    phen_file_test: str = ""
    true_signal_file: str = ""
    estimate_file: str = ""
    r1_file: str = ""
    cov_estimate_file: str = ""
    cov_file: str = ""
    cov_file_test: str = ""
    out_dir: str = ""
    out_name: str = ""

    # mode / model
    run_mode: str = "infere"           # infere | test | association_test | predict
    model: str = "linear"              # linear | bin_class
    pval_method: str = "se"            # se | loo | loo_std (ours)

    # dimensions
    Mt: int = 0
    N: int = 0
    N_test: int = 0
    Mt_test: int = 0
    C: int = 0

    # VAMP hyperparameters (defaults = reference options.hpp:79-104)
    stop_criteria_thr: float = 0.01
    merge_vars_thr: float = 5e-1
    EM_err_thr: float = 1e-2
    EM_max_iter: int = 1
    CG_max_iter: int = 500
    CG_err_tol: float = 1e-5
    num_mix_comp: int = 10   # decorative in the reference too (SURVEY Q6)
    learn_vars: int = 1
    learn_prior_delay: int = 1
    # truth-free EM stabilizer: cap the slab's total second moment at
    # N*em_h2_budget after every EM update (engine/linear.py _em_phase);
    # 0 = off (reference trajectory parity)
    em_h2_budget: float = 0.0
    alpha_scale: float = 1.0
    redglob: int = 0
    probit_var: float = 1.0
    rho: float = 0.5
    h2: float = 0.5
    gam1: float = 1e-6
    verbosity: int = 0
    iterations: int = 50

    vars: list[float] = field(default_factory=lambda: list(DEFAULT_VARS))
    probs: list[float] = field(default_factory=lambda: list(DEFAULT_PROBS))
    test_iter_range: list[int] = field(default_factory=lambda: [1, 50])

    # extensions beyond the reference (as in the JAX package)
    lmmse_solver: str = "auto"    # auto | cg | spectral | eigen
    spectral_max_n: int = 16384   # auto picks spectral only when N <= this
    eigen_cache: str = ""
    eigen_build_budget: float = 0.0  # wall seconds the eigen build may take (0 = unlimited)
    compute_dtype: str = "auto"   # auto | float64 | float32 | bfloat16 | int8 | int4
    seed: int = 0                 # seeded probe RNG (fixes reference quirk Q4)
    checkpoint_file: str = ""
    resume_file: str = ""
    trace: int = 1                # write <out>_trace.jsonl telemetry
    profile_dir: str = ""

    # the port's own
    device: str = "cuda"          # cuda | cpu

    def resolved_compute_dtype(self) -> torch.dtype:
        """torch dtype of the design matrix.  "auto" is f64 on the CPU (the
        correctness oracle) and f32 on a card (vampomi_tpu/config.py:94-96)."""
        if self.compute_dtype == "auto":
            return (torch.float64 if torch.device(self.device).type == "cpu"
                    else torch.float32)
        return _DTYPES[self.compute_dtype]

    def check(self):
        if self.meth_file == "" and self.meth_file_test == "":
            raise SystemExit(
                "FATAL  : no meth file provided! Please use the --meth-file option."
            )

    def em_signal_budget(self, n: int) -> float:
        """Internal-scale EM signal budget N*em_h2_budget (prior vars carry
        the xN scaling, vamp.cpp:87-88); 0.0 disables the projection."""
        return float(n) * self.em_h2_budget if self.em_h2_budget > 0 else 0.0
