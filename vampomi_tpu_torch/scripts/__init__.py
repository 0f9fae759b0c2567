"""Post-processing CLIs of the Gibbs warm start, numpy copies of the JAX
package's `vampomi_tpu/scripts/` (the other five scripts are not ported yet,
ROADMAP.md):

    python -m vampomi_tpu_torch.scripts.conf_gibbs_init ...
    python -m vampomi_tpu_torch.scripts.pip ...
"""
