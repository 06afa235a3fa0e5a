"""Synthetic dataset fixtures (copy of ``dpsvm_tpu/data/synthetic.py``).

Numpy only, so the same seed gives the same arrays in both packages:
Gaussian blobs, XOR (needs the RBF kernel), and the planted generator that
gives a gamma-calibrated, convergent problem at the reference's headline
shape (60000 x 784), and its k-class variant. The binary generators
return (x: (n, d) float32, y: (n,) int32 in {+1, -1});
``make_planted_multiclass`` returns labels 0..k-1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_blobs(n: int = 200, d: int = 4, seed: int = 0,
               separation: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """Two Gaussian clusters at +/- separation/2 along each axis."""
    rng = np.random.default_rng(seed)
    n_pos = n // 2
    n_neg = n - n_pos
    center = np.full((d,), separation / 2.0, dtype=np.float32)
    xp = rng.normal(loc=center, scale=1.0, size=(n_pos, d))
    xn = rng.normal(loc=-center, scale=1.0, size=(n_neg, d))
    x = np.concatenate([xp, xn]).astype(np.float32)
    y = np.concatenate([np.ones(n_pos), -np.ones(n_neg)]).astype(np.int32)
    perm = rng.permutation(n)
    return x[perm], y[perm]


def make_xor(n: int = 200, seed: int = 0,
             noise: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """2-D XOR: not linearly separable, exercises the RBF kernel."""
    rng = np.random.default_rng(seed)
    signs = rng.integers(0, 2, size=(n, 2)) * 2 - 1
    x = signs + rng.normal(scale=noise, size=(n, 2))
    y = (signs[:, 0] * signs[:, 1]).astype(np.int32)
    return x.astype(np.float32), y


def make_planted(n: int, d: int, gamma: float, seed: int = 0,
                 noise: float = 0.02, latent_dim: int = 16,
                 clusters_per_class: int = 8,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Benchmark data with a planted decision boundary tuned to gamma.

    I.i.d. features in high dimension put every pair of points at nearly
    the same distance: at the reference's benchmark gammas K is then
    about the identity matrix, and SMO's global progress stalls. Real
    data lives near a low-dimensional manifold, so kernel values span
    (0, 1).

    This generator plants that structure deliberately, scaled to the
    gamma it will be trained with:

      * points live on a ``latent_dim``-dimensional subspace embedded in
        d dims by a random orthonormal map (so d only adds cost, not
        distance — exactly like pixel space),
      * each class is a mixture of ``clusters_per_class`` Gaussians;
        the latent scale is chosen so typical WITHIN-cluster squared
        distance is about 1/gamma (kernel values ~e^-1) and
        between-cluster distances are a few times that — K has real
        off-diagonal mass and the problem has geometry worth learning,
      * a ``noise`` fraction of labels is flipped uniformly; those
        points become bounded SVs (alpha = C), giving the optimizer the
        same bounded/free SV mix real benchmarks have. SV fraction is
        therefore controllable: about noise + the margin population.

    Every returned dataset is convergent at its own (gamma, reasonable
    C): asserted at CI scale by the JAX package's tests/test_data.py.
    """
    x, assign, rng = _planted_latent(n, d, gamma, 2 * clusters_per_class,
                                     latent_dim, seed)
    y = np.where(assign < clusters_per_class, 1, -1).astype(np.int32)
    flip = rng.random(n) < noise
    y = np.where(flip, -y, y).astype(np.int32)
    return x, y


def _planted_latent(n: int, d: int, gamma: float, n_clusters: int,
                    latent_dim: int, seed: int):
    """(x, cluster assignment, rng) — the gamma-calibrated latent
    cluster geometry: cluster centers on a latent sphere of radius r_c,
    cluster noise sigma, tuned against REAL image data (sklearn digits at its benchmark gamma:
    off-diagonal K has median ~0.3, p99 ~0.76) via within-cluster
    E||xi-xj||^2 = 2*latent_dim*sigma^2 := 0.7/gamma (K ~ 0.5) and
    cross-cluster ~ 1.5/gamma (K ~ 0.22). The returned rng has
    consumed the generation draws, so callers' label-noise draws stay
    reproducible per (shape, seed)."""
    if latent_dim > d:
        latent_dim = d
    rng = np.random.default_rng(seed)
    sigma = float(np.sqrt(0.35 / (latent_dim * gamma)))
    r_c = float(np.sqrt(0.4 / gamma))
    centers = rng.normal(size=(n_clusters, latent_dim))
    centers *= r_c / np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, size=n)
    z = centers[assign] + sigma * rng.normal(size=(n, latent_dim))
    # Embed isometrically: random orthonormal rows (QR of a Gaussian).
    basis, _ = np.linalg.qr(rng.normal(size=(d, latent_dim)))
    x = (z @ basis.T).astype(np.float32)
    return x, assign, rng


def make_planted_multiclass(n: int, d: int, gamma: float, k: int = 10,
                            seed: int = 0, noise: float = 0.02,
                            latent_dim: int = 16,
                            clusters_per_class: int = 4,
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """K-class variant of ``make_planted``: the same gamma-calibrated
    latent cluster geometry, with ``clusters_per_class`` clusters per
    class and integer labels 0..k-1. ``noise`` flips a fraction of
    labels to a uniformly random OTHER class (the multiclass analog of
    the binary flip — those points become bounded SVs of their pairs)."""
    x, assign, rng = _planted_latent(n, d, gamma, k * clusters_per_class,
                                     latent_dim, seed)
    y = (assign // clusters_per_class).astype(np.int32)
    flip = rng.random(n) < noise
    shift = rng.integers(1, k, size=n)
    y = np.where(flip, (y + shift) % k, y).astype(np.int32)
    return x, y


def save_csv(path: str, x: np.ndarray, y: np.ndarray) -> None:
    """Write (x, y) in the reference's dense CSV format (parse.cpp).
    Integer labels write as ints (reference parity); float labels
    (regression targets) keep their value."""
    int_labels = np.issubdtype(np.asarray(y).dtype, np.integer)
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            row = ",".join(repr(float(v)) for v in x[i])
            lab = int(y[i]) if int_labels else repr(float(y[i]))
            f.write(f"{lab},{row}\n")
