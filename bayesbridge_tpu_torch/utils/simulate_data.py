"""Synthetic data generation for demos, tests and benchmarks.

Host-side NumPy/SciPy utilities mirroring the reference's generators
(reference: simulate_data.py:8-143): mixed dense / sparse-binary /
categorical designs and outcome simulation for each model family. A NumPy copy of ``bayesbridge_tpu.utils.simulate_data``: for
a seed both give identical arrays, so data built for one package can
be fed to the other.
"""

import numpy as np
import scipy.sparse as sps


def simulate_outcome(X, beta, model, intercept=0., n_trial=None, seed=None):
    """Simulate a response under the given model (simulate_data.py:8-26)."""
    if seed is not None:
        np.random.seed(seed)

    linear_pred = intercept + X.dot(beta)
    if model == 'linear':
        return linear_pred + np.random.randn(X.shape[0])
    if model == 'logit':
        if n_trial is None:
            n_trial = np.ones(X.shape[0])
        prob = 1.0 / (1.0 + np.exp(-linear_pred))
        n_success = np.random.binomial(n_trial.astype(np.int64), prob)
        return n_success, n_trial
    if model == 'cox':
        from ..models.cox import CoxModel
        return CoxModel.simulate_outcome(X, beta, censoring_frac=.5)
    raise NotImplementedError(model)


def simulate_design(
        n_obs, n_pred, binary_frac=0., categorical_frac=0.,
        corr_dense_design=False, binary_pred_freq=.1, n_category=5,
        shuffle_columns=False, seed=None, format_='sparse'):
    """Mixed dense/binary/categorical design (simulate_data.py:29-63)."""
    if seed is not None:
        np.random.seed(seed)

    n_dense = int(n_pred * (1 - binary_frac - categorical_frac))
    n_categorical = int((n_pred * categorical_frac) / (n_category - 1))
    n_binary = n_pred - n_dense - n_categorical * (n_category - 1)

    X_dense = _simulate_dense(n_obs, n_dense, corr_dense_design)
    if n_binary + n_categorical == 0:
        X = X_dense
    else:
        parts = [sps.csr_matrix(X_dense)]
        if n_binary > 0:
            parts.append(sps.csr_matrix(
                _simulate_binary(n_obs, n_binary, binary_pred_freq)))
        if n_categorical > 0:
            parts.append(_simulate_categorical(
                n_obs, n_categorical, n_category))
        X = sps.hstack(parts).tocsr()

    if shuffle_columns:
        X = X[:, np.random.permutation(n_pred)]

    if format_ == 'sparse':
        X = sps.csr_matrix(X)
    elif sps.issparse(X):
        X = X.toarray()
    return X


def normal_design(n, p=16_384, per_row=164, seed=0):
    """n x p with `per_row` standard-normal draws a row at uniform columns
    (duplicates summed, zeros dropped), as a scipy CSR: the sparse
    benchmark's general-valued design (``build_sparse`` of
    ``baselines/bench_sparse_matvec.py`` with values 'normal', at
    density per_row / p)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, p, size=(n, per_row))
    X = sps.csr_matrix((np.ones(n * per_row), cols.ravel(),
                        np.arange(n + 1, dtype=np.int64) * per_row),
                       shape=(n, p))
    X.sum_duplicates()
    X.data[:] = rng.standard_normal(X.nnz)
    X.eliminate_zeros()
    return X


def _simulate_dense(n_obs, n_pred, corr_design):
    if not corr_design:
        return np.random.randn(n_obs, n_pred)
    # Factor-structured covariance: I + F L F' (simulate_data.py:82-98).
    n_factor = min(100, int(n_pred / 2)) or 1
    factor, _ = np.linalg.qr(np.random.randn(n_pred, n_factor))
    pc_sd = np.linspace(100., 1., n_factor + 1)
    loading = pc_sd[:n_factor] - 1.
    X = (factor @ (loading[:, None] * np.random.randn(n_factor, n_obs))).T
    return X + np.random.randn(n_obs, n_pred)


def _simulate_binary(n_obs, n_pred, sparsity, max_freq_per_col=.5):
    """0/1 columns with average density `sparsity`, per-column density
    Beta-distributed and capped at `max_freq_per_col`
    (simulate_data.py:100-117).

    Benchmark-scale blocks are assembled directly in CSC (no n x p dense
    transient) from the SAME np.random draw sequence, so small-scale
    goldens and large-scale benches see identical matrices for a seed.
    """
    a = .5
    b = a * (max_freq_per_col / sparsity - 1)
    freq = max_freq_per_col * np.random.beta(a, b, n_pred)
    nnz_per_col = np.ceil(n_obs * freq).astype(np.int64)
    if n_obs * n_pred > 2e8:
        indices = np.empty(int(nnz_per_col.sum()), dtype=np.int32)
        indptr = np.zeros(n_pred + 1, dtype=np.int64)
        np.cumsum(nnz_per_col, out=indptr[1:])
        for j in range(n_pred):
            rows = np.random.choice(n_obs, nnz_per_col[j], replace=False)
            rows.sort()
            indices[indptr[j]:indptr[j + 1]] = rows
        return sps.csc_matrix(
            (np.ones(len(indices)), indices, indptr),
            shape=(n_obs, n_pred))
    X = np.zeros((n_obs, n_pred))
    for j in range(n_pred):
        X[np.random.choice(n_obs, nnz_per_col[j], replace=False), j] = 1.
    return X


def _simulate_categorical(n_obs, n_pred, n_category=5):
    """Dummy-coded categorical predictors, most frequent level as baseline
    (simulate_data.py:119-143)."""
    blocks = []
    for _ in range(n_pred):
        freq = np.sort(np.random.dirichlet(np.ones(n_category)))[::-1][1:]
        boundaries = np.concatenate(
            ([0], np.floor(n_obs * np.cumsum(freq)))).astype(np.int64)
        block = np.zeros((n_obs, n_category - 1))
        for j in range(n_category - 1):
            block[boundaries[j]:boundaries[j + 1], j] = 1.
        blocks.append(sps.csr_matrix(block[np.random.permutation(n_obs), :]))
    return sps.hstack(blocks)
