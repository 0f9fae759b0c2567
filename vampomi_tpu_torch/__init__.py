"""vampomi_tpu_torch — gVAMP for omics-scale Bayesian regression in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of the JAX package `vampomi_tpu`, which stays beside it as the
reference.  It keeps that package's module layout and function names, so each
counterpart is found under the same path.  It imports torch and numpy, never
jax and never `vampomi_tpu`: importing any `vampomi_tpu` module imports jax and
sets process-wide JAX options, and the machines with the card have no jax.

Importing this package has no side effects.  Devices are chosen explicitly
(`config.resolve_device`); there is no global default dtype.

Ported so far: the single-device linear `--run-mode infere` over f64, f32 and
int8 designs with the `cg` and `eigen` LMMSE solvers (see ROADMAP.md for the
rest).
"""

__version__ = "0.1.0"
