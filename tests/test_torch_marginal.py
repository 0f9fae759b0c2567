"""The port's copy of the marginal-effect prior estimators
(vampomi_tpu_torch/prior/marginal.py) against the JAX package's
(vampomi_tpu/prior/marginal.py) on the inputs of tests/test_marginal_prior.py:
the same numpy code, so the results are equal bit for bit."""

import numpy as np
import pytest

from vampomi_tpu.prior import marginal as jmarg
from vampomi_tpu_torch.prior import marginal as tmarg

from tests.test_marginal_prior import _fixture, _northstar_mixture


def test_normal_ppf_is_the_same():
    for p in (1e-9, 0.01, 0.3, 0.5, 0.77, 0.999999):
        assert tmarg._normal_ppf(p) == jmarg._normal_ppf(p)


@pytest.mark.parametrize("seed", [0, 3])
def test_fit_marginal_mixture_is_the_same_at_the_north_star_shape(seed):
    """Pinned-v0 SQUAREM EM on direct mixture draws of the north-star
    composition (tests/test_marginal_prior.py:100-127), and on a mis-pinned
    v0 (:130-140)."""
    b, _, v0, _, _ = _northstar_mixture(seed)
    assert tmarg.fit_marginal_mixture(b, v0) == jmarg.fit_marginal_mixture(b, v0)
    assert tmarg.fit_marginal_mixture(b, v0 * 1.01) == jmarg.fit_marginal_mixture(b, v0 * 1.01)
    with pytest.raises(ValueError, match="positive"):
        tmarg.fit_marginal_mixture(b, 0.0)


@pytest.fixture(scope="module")
def probit_fixture():
    """tests/test_marginal_prior.py:143-161, seed 3."""
    return _fixture(32768, 2048, 0.01, 0.8, 3, probit=True)


def test_estimate_probit_prior_is_the_same(probit_fixture):
    b, y, _, _ = probit_fixture
    n = 2048
    got = tmarg.estimate_probit_prior(b, n, float(y.mean()))
    assert got == jmarg.estimate_probit_prior(b, n, float(y.mean()))
    assert 0.2 <= got["h2"] <= 0.95
    # engine units (tests/test_marginal_prior.py:164-174)
    eng = dict(bhat=b * np.sqrt(n), n=n, ybar=float(y.mean()), col_sumsq=float(n - 1))
    assert tmarg.estimate_probit_prior(**eng) == jmarg.estimate_probit_prior(**eng)


def test_estimate_prior_with_a_shifted_threshold_and_linear_is_the_same():
    """tests/test_marginal_prior.py:177-199: a linear trait, and a probit
    trait with ~25% cases."""
    b, y, _, _ = _fixture(32768, 2048, 0.01, 0.8, 5, probit=False)
    y_ss = float((y - y.mean()) @ (y - y.mean()))
    got = tmarg.estimate_linear_prior(b, 2048, y_ss=y_ss)
    assert got == jmarg.estimate_linear_prior(b, 2048, y_ss=y_ss)
    assert 0.3 <= got["h2"] <= 0.95
    b, y, _, _ = _fixture(32768, 2048, 0.01, 0.8, 13, probit=True, thr=0.7)
    assert tmarg.estimate_probit_prior(b, 2048, float(y.mean())) == \
        jmarg.estimate_probit_prior(b, 2048, float(y.mean()))
