"""CLI of the Gibbs warm-start sampler: `python -m vampomi_tpu_torch.gibbs`
(the flags of `python -m vampomi_tpu.gibbs`, plus `--device {cuda,cpu}`).

Produces <out>.csv / <out>.bet / <out>.grm, directly consumable by
  python -m vampomi_tpu_torch.scripts.conf_gibbs_init -csv <out>.csv -grm <out>.grm
  python -m vampomi_tpu_torch.scripts.pip -bet <out>.bet -iterations a:b
and the .conf then by `python -m vampomi_tpu_torch.cli --init-conf`.
"""

from __future__ import annotations

import argparse

import torch

from ..config import resolve_device
from .runner import run_gibbs

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


def main(argv=None):
    p = argparse.ArgumentParser(description="Gibbs warm-start sampler (PyTorch/CUDA)")
    p.add_argument("--meth-file", required=True)
    p.add_argument("--phen-file", required=True)
    p.add_argument("--N", type=int, required=True)
    p.add_argument("--Mt", type=int, required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--out-name", default="gibbs")
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--burnin", type=int, default=None)
    p.add_argument("--num-mix-comp", type=int, default=4,
                   help="mixture size L incl. the spike (decade ladder)")
    p.add_argument("--block", type=int, default=256)
    p.add_argument("--thin", type=int, default=1)  # thin>1 breaks reference pip.py normalization
    p.add_argument("--h2", type=float, default=0.5, help="h2 init guess")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha-scale", type=float, default=1.0)
    p.add_argument("--compute-dtype", default="float32", choices=sorted(_DTYPES))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default; raises without one) or on the CPU")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    from ..dataset import load_dataset

    ds = load_dataset(a.meth_file, a.phen_file, a.N, a.Mt, "linear",
                      _DTYPES[a.compute_dtype], device, alpha_scale=a.alpha_scale)
    res = run_gibbs(
        ds.dm, ds.phen.y, iterations=a.iterations, burnin=a.burnin,
        l_comp=a.num_mix_comp, block=a.block, thin=a.thin, h2_init=a.h2,
        seed=a.seed, out_dir=a.out_dir, out_name=a.out_name,
    )
    print(f"[gibbs] done: h2={res.h2_mean:.4f} "
          f"sigma_g={res.sigma_g_mean:.4g} (file units) "
          f"lambda={1.0 - res.pi_mean[0]:.4g}")
    print(f"[gibbs] outputs: {res.csv_path} {res.bet_path} {res.grm_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
