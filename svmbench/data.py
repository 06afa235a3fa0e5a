"""The benchmark's data: a frozen copy of the planted generator
(``dpsvm_tpu_torch/data/synthetic.py``: ``make_planted`` and
``_planted_latent``, arithmetic unchanged), so that a later change to the
program cannot change what the benchmark feeds it.

NumPy only. The same (shape, gamma, seed) gives the same arrays as the
program's own ``make_planted``; ``tests/test_svmbench.py`` holds the two
together.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_planted(n: int, d: int, gamma: float, seed: int = 0,
                 noise: float = 0.02, latent_dim: int = 16,
                 clusters_per_class: int = 8,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(x: (n, d) float32, y: (n,) int32 in {+1, -1}): points on a random
    ``latent_dim``-dimensional subspace, each class a mixture of
    ``clusters_per_class`` Gaussians scaled to ``gamma`` (within-cluster
    squared distance ~0.7/gamma, between clusters ~1.5/gamma), and a
    ``noise`` share of labels flipped."""
    x, y, _ = _planted(n, d, gamma, seed, noise, latent_dim,
                       clusters_per_class)
    return x, y


def _planted(n, d, gamma, seed, noise, latent_dim, clusters_per_class):
    """``make_planted``'s (x, y) and the (d, latent_dim) orthonormal basis
    that embeds the latent points."""
    x, assign, rng, basis = _planted_latent(n, d, gamma,
                                            2 * clusters_per_class,
                                            latent_dim, seed)
    y = np.where(assign < clusters_per_class, 1, -1).astype(np.int32)
    flip = rng.random(n) < noise
    y = np.where(flip, -y, y).astype(np.int32)
    return x, y, basis


def _planted_latent(n: int, d: int, gamma: float, n_clusters: int,
                    latent_dim: int, seed: int):
    """(x, cluster assignment, rng, basis): cluster centres on a latent sphere of
    radius sqrt(0.4/gamma), cluster noise sigma = sqrt(0.35/(latent_dim
    gamma)), embedded isometrically by the Q of a Gaussian's QR."""
    if latent_dim > d:
        latent_dim = d
    rng = np.random.default_rng(seed)
    sigma = float(np.sqrt(0.35 / (latent_dim * gamma)))
    r_c = float(np.sqrt(0.4 / gamma))
    centers = rng.normal(size=(n_clusters, latent_dim))
    centers *= r_c / np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, size=n)
    z = centers[assign] + sigma * rng.normal(size=(n, latent_dim))
    basis, _ = np.linalg.qr(rng.normal(size=(d, latent_dim)))
    x = (z @ basis.T).astype(np.float32)
    return x, assign, rng, basis


def problems(config: dict, count: int) -> list:
    """``count`` problems of the configuration, each (x, y, x_heldout,
    y_heldout). Problem 0 is one planted draw of ``n_train + n_heldout``
    rows from the configuration's own ``data.seed``, split in that order
    (as the reference's MNIST files are a training and a test file of one
    distribution). Problem k > 0 is the same draw turned: its latent
    points embedded by another orthonormal basis, drawn from (data seed,
    k). Every distance, so the RBF kernel, and every label stay as they
    were up to float32 rounding, so each problem is the same job on other
    numbers; the solver's path, and its iteration count, differ a little
    from problem to problem (rounding parts trajectories at near-ties)."""
    gen = config["data"]
    n, nh, d = (int(config["n_train"]), int(config["n_heldout"]),
                int(config["d"]))
    k = min(int(gen["latent_dim"]), d)
    x, y, basis = _planted(n + nh, d, float(config["gamma"]),
                           int(gen["seed"]), float(gen["noise"]), k,
                           int(gen["clusters_per_class"]))
    z = x.astype(np.float64) @ basis
    out = []
    for i in range(int(count)):
        if i:
            turn, _ = np.linalg.qr(np.random.default_rng(
                [int(gen["seed"]), i]).normal(size=(d, k)))
            x = (z @ turn.T).astype(np.float32)
        out.append((x[:n], y[:n], x[n:], y[n:]))
    return out
