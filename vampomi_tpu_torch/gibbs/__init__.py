"""The spike-and-slab Gibbs sampler, the warm-start stage of gVAMP (port of
vampomi_tpu/gibbs).

See sampler.py for the block residual-update design and runner.py for the
GMRM-compatible output formats consumed by scripts/conf_gibbs_init.py and
scripts/pip.py.
"""

from .runner import GibbsResult, run_gibbs
from .sampler import (
    GibbsState,
    SweepStats,
    TorchDraws,
    block_update,
    build_block_grams,
    decade_cvars,
    gibbs_sweep,
    init_state,
    sweep_stats,
)

__all__ = [
    "GibbsResult",
    "GibbsState",
    "SweepStats",
    "TorchDraws",
    "block_update",
    "build_block_grams",
    "decade_cvars",
    "gibbs_sweep",
    "init_state",
    "run_gibbs",
    "sweep_stats",
]
