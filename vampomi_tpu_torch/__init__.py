"""vampomi_tpu_torch — gVAMP for omics-scale Bayesian regression in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of the JAX package `vampomi_tpu`, which stays beside it as the
reference.  It keeps that package's module layout and function names, so each
counterpart is found under the same path.  It imports torch and numpy, never
jax and never `vampomi_tpu`: importing any `vampomi_tpu` module imports jax and
sets process-wide JAX options, and the machines with the card have no jax.

Importing this package has no side effects.  Devices are chosen explicitly
(`config.resolve_device`); there is no global default dtype.

Ported so far, on one device: linear and probit `--run-mode infere`, with
covariates, over f64, f32, bf16, int8 and packed-int4 designs with the
`cg`, `spectral` and `eigen` LMMSE solvers, exact-state checkpoint/resume
and the eigen cache; the `test`, `association_test` and `predict` run
modes; the array API (`api.py`); the Gibbs warm start (`gibbs/`,
`scripts/conf_gibbs_init.py`, `scripts/pip.py`, `--init-conf`); the doctor
(`doctor.py`); the two matvec probe tools.  ROADMAP.md lists the rest.
"""

__version__ = "0.1.0"
