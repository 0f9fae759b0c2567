"""Host loop and GMRM-format outputs of the Gibbs sampler (port of
vampomi_tpu/gibbs/runner.py).

Output contracts (what the reference's consumers parse), byte for byte the
JAX runner's:
  - CSV, one row per sweep: [iteration, mu, sigma_g_file, sigma_e, h2,
    m_incl, vg, L, pi_0..pi_{L-1}] (conf_gibbs_init reads row[2..5], row[7]
    and row[8+i]; columns 1 and 6 are informational).
  - .bet stream (scripts/pip.py): uint32 marker count, then per kept sweep
    [uint32 iteration, Mt float64 betas] in FILE units (beta = x/sqrt(N)).
    `thin` > 1 keeps only every thin-th sweep; the reference pip.py
    normalizes PIP by the iteration-number span, so feed it thin = 1 streams.
  - .grm group-mixtures file (conf_gibbs_init -grm): one line of the
    posterior-mean sigma_g (file units) times the ladder ratios.

The JAX runner's compile-ahead thread is a TPU workaround and is not ported.
Each sweep makes one host fetch (its statistics, inside gibbs_sweep) and,
on thinned or averaging sweeps, one more of the M-length x.
"""

from __future__ import annotations

import os
import struct
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.operator import DesignMatrix
from .sampler import TorchDraws, build_block_grams, decade_cvars, gibbs_sweep, init_state


class GibbsResult(NamedTuple):
    x_mean_file: np.ndarray    # posterior-mean beta (file units), length Mt
    pip: np.ndarray            # posterior inclusion prob, length Mt
    sigma_g_mean: float        # file units, over the averaging window
    sigma_e_mean: float
    h2_mean: float
    pi_mean: np.ndarray
    csv_path: str | None
    bet_path: str | None
    grm_path: str | None
    sweeps: int
    # the port's own: seconds of the Gram build (the device synchronized)
    # and of each sweep, from its start to the return of its fetch
    gram_seconds: float = 0.0
    sweep_seconds: tuple = ()


def run_gibbs(
    dm: DesignMatrix,
    y: np.ndarray,
    iterations: int = 500,
    burnin: int | None = None,
    l_comp: int = 4,
    block: int = 256,
    thin: int = 1,
    h2_init: float = 0.5,
    seed: int = 0,
    out_dir: str | None = None,
    out_name: str = "gibbs",
    verbose: bool = True,
    draws=None,
) -> GibbsResult:
    """Run `iterations` systematic-scan sweeps; average over the post-burnin
    window (default: second half).  `draws` is the draw source (default
    TorchDraws(seed))."""
    n = int(dm.n)
    mt = int(dm.mt)
    sqrt_n = float(np.sqrt(n))
    dev = dm.device
    if burnin is None:
        burnin = iterations // 2
    while dm.m_pad % block != 0:   # block must divide M; shrink to a divisor
        block //= 2
    cvars = torch.as_tensor(decade_cvars(l_comp), dtype=torch.float64).to(dev)
    draws = TorchDraws(seed) if draws is None else draws

    state = init_state(dm, y, l_comp, h2_init=h2_init)

    t0 = time.perf_counter()
    grams = build_block_grams(dm, block=block)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gram_s = time.perf_counter() - t0
    if verbose:
        print(f"[gibbs] {dm.m_pad // block} block Grams (B={block}) in {gram_s:.2f}s", flush=True)

    y_dev = torch.as_tensor(np.asarray(y, dtype=np.float64)).to(device=dev, dtype=dm.wd)

    csv_path = bet_path = grm_path = None
    csv_f = bet_f = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        csv_path = os.path.join(out_dir, f"{out_name}.csv")
        bet_path = os.path.join(out_dir, f"{out_name}.bet")
        grm_path = os.path.join(out_dir, f"{out_name}.grm")
        csv_f = open(csv_path, "w")
        bet_f = open(bet_path, "wb")
        bet_f.write(struct.pack("I", mt))

    x_sum = np.zeros(mt)
    pip_cnt = np.zeros(mt)
    navg = 0
    sg_sum = se_sum = h2_sum = 0.0
    pi_sum = np.zeros(l_comp)
    sweep_s = []

    t_loop = time.perf_counter()
    for it in range(1, iterations + 1):
        t_sweep = time.perf_counter()
        state, st = gibbs_sweep(dm, grams, state, cvars, draws, y_dev, block=block)
        sweep_s.append(time.perf_counter() - t_sweep)
        sg = st.sigma_g / n                 # internal -> file units
        se, h2, pi = st.sigma_e, st.h2, st.pi

        if csv_f is not None:
            row = [it, f"{st.mu:.10g}", f"{sg:.10g}", f"{se:.10g}",
                   f"{h2:.10g}", st.m_incl, f"{st.vg:.10g}", l_comp]
            row += [f"{p:.12f}" for p in pi]
            csv_f.write(",".join(str(v) for v in row) + "\n")

        thinned = it % thin == 0
        in_window = it > burnin
        if thinned or in_window:
            x_host = state.x.cpu().numpy().astype(np.float64)[:mt] / sqrt_n
        if thinned and bet_f is not None:
            bet_f.write(struct.pack("I", it))
            bet_f.write(x_host.astype("<f8").tobytes())
        if in_window:
            x_sum += x_host
            pip_cnt += np.abs(x_host) > 0
            sg_sum += sg
            se_sum += se
            h2_sum += h2
            pi_sum += pi
            navg += 1
        if verbose and (it % 50 == 0 or it == 1):
            print(f"[gibbs] sweep {it}/{iterations}: h2={h2:.4f} "
                  f"m_incl={st.m_incl} sigma_e={se:.4f} "
                  f"({(time.perf_counter() - t_loop) / it:.3f}s/sweep)", flush=True)

    if csv_f is not None:
        csv_f.close()
    if bet_f is not None:
        bet_f.close()

    navg = max(navg, 1)
    sg_mean = sg_sum / navg
    if grm_path is not None:
        ladder = np.asarray(decade_cvars(l_comp)) * sg_mean
        with open(grm_path, "w") as f:
            f.write(" ".join(f"{v:.12g}" for v in ladder) + "\n")

    return GibbsResult(
        x_mean_file=x_sum / navg,
        pip=pip_cnt / navg,
        sigma_g_mean=sg_mean,
        sigma_e_mean=se_sum / navg,
        h2_mean=h2_sum / navg,
        pi_mean=pi_sum / navg,
        csv_path=csv_path,
        bet_path=bet_path,
        grm_path=grm_path,
        sweeps=iterations,
        gram_seconds=gram_s,
        sweep_seconds=tuple(sweep_s),
    )
