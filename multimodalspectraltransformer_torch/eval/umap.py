"""Minimal first-party UMAP (fingerprint-space cluster visualization).

The port's own copy of the JAX package's ``eval/umap.py`` (numpy and scipy
only), so the same ``random_state`` gives the same layout.

The reference calls umap-learn for its cluster plots
(`clustering_visualization_v15_4.py:28-384`); that package is not in this
environment, and round 1 silently degraded UMAP to t-SNE. This is the
standard UMAP recipe at visualization scale (N up to a few thousand
512-bit fingerprints — exact kNN is cheap):

1. exact kNN graph, per-point rho (nearest distance) and sigma calibrated
   by binary search so the smoothed neighborhood cardinality is
   log2(n_neighbors),
2. fuzzy simplicial set w = exp(-(d - rho)/sigma), symmetrized by
   probabilistic t-conorm W + W^T - W∘W^T,
3. (a, b) curve parameters fitted to the min_dist membership curve,
4. PCA initialization, then SGD over edges sampled proportionally to
   membership with uniform negative sampling.

Host-side numpy by design: this is a cold visualization utility, not a
device compute path.
"""

from __future__ import annotations

import numpy as np


def _knn(x: np.ndarray, k: int):
    d2 = np.maximum(
        (x * x).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * (x @ x.T), 0.0
    )
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    dist = np.sqrt(np.take_along_axis(d2, idx, axis=1))
    return idx, dist


def _smooth_knn(dist: np.ndarray, k: int, n_iter: int = 64):
    """Per-point (rho, sigma): rho = nearest nonzero distance, sigma solves
    sum_j exp(-(d_ij - rho)/sigma) = log2(k)."""
    n = dist.shape[0]
    # rho = nearest NONZERO distance (standard UMAP local connectivity):
    # with duplicate points dist[:, 0] is 0 and the point would lose its
    # guaranteed membership-1 edge, deflating its neighborhood weights
    nonzero = np.where(dist > 0, dist, np.inf)
    rho = np.min(nonzero, axis=1)
    rho = np.where(np.isfinite(rho), rho, 0.0)  # all-duplicate row
    target = np.log2(k)
    sigma = np.ones(n)
    for i in range(n):
        lo, hi = 0.0, np.inf
        mid = 1.0
        d = np.maximum(dist[i] - rho[i], 0.0)
        for _ in range(n_iter):
            val = np.exp(-d / mid).sum()
            if abs(val - target) < 1e-5:
                break
            if val > target:
                hi = mid
                mid = (lo + hi) / 2.0
            else:
                lo = mid
                mid = mid * 2.0 if hi == np.inf else (lo + hi) / 2.0
        sigma[i] = max(mid, 1e-8)
    return rho, sigma


def _fit_ab(min_dist: float, spread: float = 1.0):
    """Fit y = 1/(1 + a x^(2b)) to the piecewise target curve."""
    try:
        from scipy.optimize import curve_fit

        xs = np.linspace(0, spread * 3, 300)
        ys = np.where(xs < min_dist, 1.0, np.exp(-(xs - min_dist) / spread))

        def f(x, a, b):
            return 1.0 / (1.0 + a * x ** (2.0 * b))

        (a, b), _ = curve_fit(f, xs, ys, p0=(1.5, 1.0), maxfev=10000)
        return float(a), float(b)
    except Exception:
        return 1.577, 0.895  # the standard min_dist=0.1 values


def umap_embed(
    x: np.ndarray,
    n_components: int = 2,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    n_epochs: int = 200,
    learning_rate: float = 1.0,
    negative_samples: int = 5,
    random_state: int = 0,
) -> np.ndarray:
    """[N, D] -> [N, n_components] UMAP layout."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if n <= 2:
        return np.zeros((n, n_components))
    k = min(n_neighbors, n - 1)
    idx, dist = _knn(x, k)
    rho, sigma = _smooth_knn(dist, k)

    w = np.exp(-np.maximum(dist - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), k)
    cols = idx.ravel()
    vals = w.ravel()
    # symmetrize: dense is fine at visualization scale
    W = np.zeros((n, n))
    W[rows, cols] = vals
    W = W + W.T - W * W.T

    a, b = _fit_ab(min_dist)

    # PCA init, scaled to the usual 10-unit box
    xc = x - x.mean(0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    emb = xc @ vt[:n_components].T
    scale = np.abs(emb).max() or 1.0
    emb = (emb / scale * 10.0).astype(np.float64)

    ei, ej = np.nonzero(W)
    ew = W[ei, ej]
    if len(ei) == 0:
        return emb
    # edge sampling schedule (epochs_per_sample ~ 1/weight)
    rng = np.random.default_rng(random_state)
    n_edges = len(ei)
    eps = ew.max() / np.maximum(ew, 1e-12)  # epochs between samples per edge
    next_sample = eps.copy()

    for epoch in range(1, n_epochs + 1):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        active = next_sample <= epoch
        if not active.any():
            continue
        ii, jj = ei[active], ej[active]
        d = emb[ii] - emb[jj]
        d2 = (d * d).sum(1)
        # attractive gradient; coincident points (d2 == 0, e.g. duplicate
        # fingerprints sharing the PCA init) get zero force, not 0**(b-1)=inf
        safe_d2 = np.where(d2 > 0.0, d2, 1.0)
        g = (-2.0 * a * b * safe_d2 ** (b - 1.0)) / (1.0 + a * safe_d2**b)
        g = np.where(d2 > 0.0, g, 0.0)
        g = np.clip(g[:, None] * d, -4.0, 4.0)
        np.add.at(emb, ii, alpha * g)
        np.add.at(emb, jj, -alpha * g)
        # negative sampling
        for _ in range(negative_samples):
            kk = rng.integers(0, n, size=len(ii))
            d = emb[ii] - emb[kk]
            d2 = (d * d).sum(1) + 1e-3
            g = (2.0 * b) / (d2 * (1.0 + a * d2**b))
            g = np.clip(g[:, None] * d, -4.0, 4.0)
            np.add.at(emb, ii, alpha * g)
        next_sample[active] += eps[active]

    return emb.astype(np.float32)
