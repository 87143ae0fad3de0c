"""MCMC output summaries: credible-interval plots, the effective sample
size, split R-hat and the pooled ESS of several chains.

The port's own copy of ``bayesbridge_tpu/utils/mcmc_summarizer.py``
(reference: util/mcmc_summarizer.py:6-47), plain NumPy on host arrays,
so that the port imports nothing of the JAX package. matplotlib is
imported only inside :func:`plot_conf_interval`.
"""

import numpy as np


def plot_conf_interval(coef_samples, conf_level=.95, n_coef_to_plot=None,
                       marker='o', markersize=5, capsize=6,
                       coef_index_offset=0, ax=None):
    """Plot posterior medians with equal-tailed credible intervals.

    Parameters
    ----------
    coef_samples : array of shape (n_coef, n_samples)
    conf_level : float in (0, 1)
    n_coef_to_plot : int or None (all)
    coef_index_offset : int
        Skip the first coefficients (e.g. the intercept).
    ax : matplotlib axis or None
    """
    import matplotlib.pyplot as plt

    coef_samples = np.asarray(coef_samples)[coef_index_offset:, :]
    if n_coef_to_plot is not None:
        coef_samples = coef_samples[:n_coef_to_plot, :]
    n_coef = coef_samples.shape[0]

    tail_prob = (1 - conf_level) / 2
    lower, median, upper = np.quantile(
        coef_samples, [tail_prob, .5, 1 - tail_prob], axis=-1)

    if ax is None:
        _, ax = plt.subplots()
    index = 1 + coef_index_offset + np.arange(n_coef)
    ax.errorbar(
        index, median, yerr=np.stack((median - lower, upper - median)),
        fmt=marker, markersize=markersize, capsize=capsize)
    ax.set_xlabel('coefficient index')
    ax.set_ylabel('posterior credible interval')
    return ax


def compute_effective_sample_size(samples, axis=-1):
    """ESS via the initial-monotone-sequence estimator of Geyer (1992),
    vectorized over the leading axes. Beyond the reference's utilities;
    used for ESS per second."""
    samples = np.moveaxis(np.asarray(samples, dtype=np.float64), axis, -1)
    single = samples.ndim == 1
    if single:
        samples = samples[None, :]
    n = samples.shape[-1]
    centered = samples - samples.mean(-1, keepdims=True)
    # FFT autocovariance for all chains at once.
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(centered, nfft, axis=-1)
    acov = np.fft.irfft(f * np.conjugate(f), nfft, axis=-1)[..., :n].real
    acov /= n
    var0 = acov[..., 0]
    var0 = np.where(var0 <= 0, np.inf, var0)
    rho = acov / var0[..., None]

    # Geyer pairs P_k = rho[2k] + rho[2k+1], k = 0, 1, ...
    n_pairs = n // 2
    paired = rho[..., :2 * n_pairs].reshape(
        *rho.shape[:-1], n_pairs, 2).sum(-1)
    # Initial positive sequence: truncate at the first non-positive pair.
    positive = paired > 0
    first_nonpos = np.where(positive.all(-1), n_pairs,
                            np.argmax(~positive, -1))
    mask = np.arange(n_pairs) < first_nonpos[..., None]
    # Initial monotone sequence: enforce non-increasing pairs.
    paired = np.minimum.accumulate(np.where(mask, paired, np.inf), axis=-1)
    paired = np.where(mask, paired, 0.0)
    # IAT tau = -1 + 2 * sum_k P_k  (rho_0 = 1 is inside P_0).
    tau = -1.0 + 2.0 * paired.sum(-1)
    ess = n / np.maximum(tau, 1.0 / n)
    ess = np.minimum(ess, 1.0 * n)
    return float(ess[0]) if single else ess


def compute_split_rhat(chain_samples, iter_axis=-1, chain_axis=0):
    """Split-Rhat (Gelman et al. 2013) convergence diagnostic for
    multi-chain output as produced by
    :func:`bayesbridge_tpu_torch.multichain.gibbs_chains`.

    Each chain is split in half (so a single chain still yields a
    meaningful statistic) and the classic between/within variance ratio
    is computed per parameter. Values near 1 indicate mixing.
    """
    x = np.asarray(chain_samples, dtype=np.float64)
    x = np.moveaxis(x, (chain_axis, iter_axis), (0, -1))
    n = x.shape[-1]
    half = n // 2
    if half < 2:
        raise ValueError("Need at least 4 iterations per chain.")
    # Split each chain into two half-chains along a new leading axis.
    x = np.concatenate((x[..., :half], x[..., n - half:]), axis=0)
    m = x.shape[0]
    chain_mean = x.mean(-1)
    chain_var = x.var(-1, ddof=1)
    w = chain_var.mean(0)
    b = half * chain_mean.var(0, ddof=1)
    var_plus = (half - 1) / half * w + b / half
    with np.errstate(divide='ignore', invalid='ignore'):
        rhat = np.sqrt(var_plus / w)
    return np.where(w > 0, rhat, 1.0)


def compute_multichain_ess(chain_samples, iter_axis=-1, chain_axis=0):
    """Pooled effective sample size: per-chain Geyer ESS summed over
    chains (chains are independent by construction)."""
    x = np.asarray(chain_samples, dtype=np.float64)
    x = np.moveaxis(x, (chain_axis, iter_axis), (0, -1))
    return compute_effective_sample_size(x).sum(0)
