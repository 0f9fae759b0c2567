"""The port's mixture prior (denoisers, EM, merge, init) against the JAX
package (vampomi_tpu/prior/mixture.py) on the CPU.

Inputs come from a seed with numpy and include the cold start
(gam1 = 1e-6, sigma = 1e6), where the stable shrinkage forms matter.
Tolerances: rtol 1e-12 in f64 (same formulas, sums in another order) and
1e-5 in f32 (a few ulps of f32 through exp and (M, L) sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.prior import mixture as jmix
from vampomi_tpu_torch import convert
from vampomi_tpu_torch.prior import mixture as tmix

torch.set_num_threads(2)

PROBS = [0.9, 0.05, 0.03, 0.02]
VARS = [0.0, 1e-3, 1e-2, 5e-2]
N = 300
RTOL = {"float64": 1e-12, "float32": 1e-5}
DT = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


def _prior_pair(probs=PROBS, vars_=VARS):
    jp = jmix.init_prior(probs, vars_, N)
    tp = convert.prior_from_arrays({k: np.asarray(v) for k, v in jp._asdict().items()})
    return jp, tp


def _r1(dtype, m=500, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=m) * np.sqrt(N * 0.01)).astype(dtype)


@pytest.mark.parametrize("name", list(DT))
@pytest.mark.parametrize("gam1", [1e-6, 0.05, 3.0])
@pytest.mark.parametrize("fn", ["g1", "g1d"])
def test_denoisers_match_jax(name, gam1, fn):
    npd, td = DT[name]
    jp, tp = _prior_pair()
    y = _r1(npd)
    want = np.asarray(getattr(jmix, fn)(jnp.asarray(y), jnp.asarray(gam1), jp))
    got = getattr(tmix, fn)(torch.as_tensor(y), torch.tensor(gam1, dtype=torch.float64), tp)
    assert got.dtype == td
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[name], atol=0)


def test_init_prior_matches_jax():
    jp = jmix.init_prior(PROBS, VARS, N, l_max=6)
    tp = tmix.init_prior(PROBS, VARS, N, l_max=6)
    for k in ("probs", "vars", "active"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)))
    assert tp.probs.dtype == torch.float64 and tp.active.dtype == torch.bool


@pytest.mark.parametrize("name", list(DT))
@pytest.mark.parametrize("learn_vars", [1, 0])
@pytest.mark.parametrize("gam1", [1e-6, 0.8])
def test_em_update_matches_jax(name, learn_vars, gam1):
    npd, _ = DT[name]
    jp, tp = _prior_pair()
    r1 = _r1(npd, seed=2)
    r1[::7] *= 4.0  # a few large entries: the slab responsibilities move
    mmask = np.ones_like(r1)
    mmask[-20:] = 0.0  # masked markers drop out of every statistic
    mt = float(len(r1) - 20)
    kw = dict(em_max_iter=4, em_err_thr=1e-3, learn_vars=learn_vars)
    want = jmix.em_update(jnp.asarray(r1), jnp.asarray(gam1), jp, jnp.asarray(mmask),
                          jnp.asarray(mt), **kw)
    got = tmix.em_update(torch.as_tensor(r1), torch.tensor(gam1, dtype=torch.float64),
                         tp, torch.as_tensor(mmask), mt, **kw)
    for k in ("probs", "vars"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=RTOL[name], atol=0)
    if not learn_vars:
        np.testing.assert_array_equal(got.vars.numpy(), tp.vars.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_merge_components_device_matches_jax(seed):
    rng = np.random.default_rng(seed)
    L = 8
    vars_ = np.sort(rng.uniform(1e-3, 1.0, size=L))
    vars_[0] = 0.0
    vars_[3] = vars_[2] * 1.2          # a near-duplicate pair merges
    vars_[6] = vars_[5] * (1 + 1e-9)
    probs = rng.dirichlet(np.ones(L))
    active = np.ones(L, dtype=bool)
    active[4] = False
    d = dict(probs=probs, vars=vars_, active=active)
    jp = jmix.MixturePrior(**{k: jnp.asarray(v) for k, v in d.items()})
    want = jmix.merge_components_device(jp, 0.5)
    got = tmix.merge_components_device(convert.prior_from_arrays(d), 0.5)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), rtol=1e-15)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    np.testing.assert_array_equal(got.vars.numpy(), np.asarray(want.vars))
    # and the host merge agrees with both
    hp, _, ha = tmix.merge_components(probs, vars_, active, 0.5)
    np.testing.assert_allclose(hp, got.probs.numpy(), rtol=1e-15)
    np.testing.assert_array_equal(ha, got.active.numpy())
