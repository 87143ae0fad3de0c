"""The port's MCMC summaries (``bayesbridge_tpu_torch.utils.
mcmc_summarizer``) against the JAX package's on the same NumPy arrays.

Both are NumPy code; the port keeps its own copy so that it imports
nothing of the JAX package. ESS, split R-hat and the pooled ESS must
agree to rtol 1e-12 on chains with real autocorrelation; R-hat must flag
chains that sit at different means; the credible-interval plot draws.
"""

import numpy as np
import pytest

from bayesbridge_tpu.utils import mcmc_summarizer as jax_summ
from bayesbridge_tpu_torch.utils import mcmc_summarizer as summ


def _ar1_chains(seed, n_chains=4, n_par=6, n_iter=300, rho=0.7):
    """AR(1) chains, (n_chains, n_par, n_iter)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_chains, n_par, n_iter))
    eps = rng.standard_normal(x.shape)
    for t in range(1, n_iter):
        x[..., t] = rho * x[..., t - 1] + eps[..., t]
    return x


@pytest.mark.parametrize('seed', [0, 1])
def test_diagnostics_match_jax(seed):
    x = _ar1_chains(seed)
    for fn in ('compute_split_rhat', 'compute_multichain_ess'):
        np.testing.assert_allclose(getattr(summ, fn)(x),
                                   getattr(jax_summ, fn)(x), rtol=1e-12)
    np.testing.assert_allclose(
        summ.compute_effective_sample_size(x[0]),
        jax_summ.compute_effective_sample_size(x[0]), rtol=1e-12)
    assert summ.compute_effective_sample_size(x[0, 0]) == \
        pytest.approx(jax_summ.compute_effective_sample_size(x[0, 0]),
                      rel=1e-12)
    # The iteration and chain axes may sit anywhere.
    moved = np.moveaxis(x, (0, 2), (2, 1))
    np.testing.assert_allclose(
        summ.compute_split_rhat(moved, iter_axis=1, chain_axis=2),
        summ.compute_split_rhat(x), rtol=1e-12)


def test_rhat_detects_disagreement():
    rng = np.random.default_rng(0)
    good = rng.standard_normal((4, 200))
    bad = good + np.arange(4)[:, None] * 10.0  # chains at different means
    assert summ.compute_split_rhat(good[..., None, :]).item() < 1.1
    assert summ.compute_split_rhat(bad[..., None, :]).item() > 2.0
    with pytest.raises(ValueError, match='4 iterations'):
        summ.compute_split_rhat(good[..., :3])


def test_plot_conf_interval_draws():
    matplotlib = pytest.importorskip('matplotlib')
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    x = _ar1_chains(2, n_chains=1, n_par=5)[0]
    ax = summ.plot_conf_interval(x, n_coef_to_plot=4, coef_index_offset=1)
    assert ax.get_xlabel() == 'coefficient index'
    assert len(ax.lines) + len(ax.collections) > 0
    plt.close(ax.figure)
