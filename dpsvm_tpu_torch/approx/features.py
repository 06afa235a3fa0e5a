"""Kernel-approximating feature maps, RFF and Nystrom (port of
``dpsvm_tpu/approx/features.py``).

An explicit map phi with phi(x).phi(z) ~= K(x, z) turns the kernel SVM
into a linear problem over phi(x), which ``approx/primal.py`` solves in
the primal. Both maps are deterministic in (seed, shape), and their host
math is the JAX package's line for line, so the two packages build the
same map bit for bit and a model file rebuilds it in either:

* **RFF** (random Fourier features, RBF only): W ~ N(0, 2 gamma I),
  phi(x) = sqrt(2/D) [cos(xW), sin(xW)], so ||phi(x)||^2 == 1. The map
  is the (d, D/2) float32 matrix ``rff_omega`` draws with NumPy's
  ``default_rng(seed)``.
* **Nystrom** (any vector kernel): m <= D landmark rows drawn from the
  training set, K_mm eigendecomposed on the host in float64 and
  rank-truncated at ``_NYSTROM_RCOND``; phi(x) = K(x, landmarks) @ proj.

The transform runs on the device in blocks of ``CHUNK`` rows: each block
of X is copied to the device, featurized there and written into the
feature matrix, which stays on the device (``featurize_padded``). X is
never on the device whole, and the feature matrix never visits the host.
The products are float32 with TF32 off (``matmul_precision`` "highest"
or "high"); "default" multiplies bfloat16 operands with float32
accumulation, as the solvers' bfloat16 X does. The features themselves
are float32 either way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.ops.kernels import (KernelSpec, dots_f32,
                                         rows_from_dots, row_norms_sq)

# Rank cutoff for the Nystrom eigenspectrum, relative to the largest
# eigenvalue: below this a direction is numerical noise and dividing by
# sqrt(lambda) would amplify it into the features.
_NYSTROM_RCOND = 1e-6

# Rows featurized per device block.
CHUNK = 8192


@dataclasses.dataclass(frozen=True)
class FeatureMap:
    """One built feature map: everything needed to featurize new rows and
    to persist or rebuild the map bit for bit."""

    kind: str                       # "rff" | "nystrom"
    d: int                          # input width
    dim: int                        # output feature dim (after Nystrom's
                                    # rank truncation)
    seed: int
    gamma: float
    kernel: str = "rbf"             # base kernel (Nystrom: any vector kind)
    coef0: float = 0.0
    degree: int = 3
    omega: Optional[np.ndarray] = None      # rff: (d, dim/2) frequencies
    landmarks: Optional[np.ndarray] = None  # nystrom: (m, d) rows
    proj: Optional[np.ndarray] = None       # nystrom: (m, dim) whitening

    @property
    def kernel_spec(self) -> KernelSpec:
        return KernelSpec(kind=self.kernel, gamma=float(self.gamma),
                          coef0=float(self.coef0), degree=int(self.degree))


def rff_omega(d: int, dim: int, gamma: float, seed: int) -> np.ndarray:
    """The (d, dim/2) RFF frequency matrix, N(0, 2 gamma) i.i.d.,
    deterministic in (d, dim, gamma, seed)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, dim // 2))
            * math.sqrt(2.0 * gamma)).astype(np.float32)


def build_feature_map(kind: str, x: np.ndarray, dim: int, seed: int,
                      spec: KernelSpec) -> FeatureMap:
    """Build a map for training data ``x`` (rff only reads its width)."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if kind == "rff":
        if spec.kind != "rbf":
            raise ValueError("rff approximates the RBF kernel only")
        return FeatureMap(kind="rff", d=d, dim=int(dim), seed=int(seed),
                          gamma=float(spec.gamma),
                          omega=rff_omega(d, int(dim), float(spec.gamma),
                                          int(seed)))
    if kind != "nystrom":
        raise ValueError(f"unknown feature map kind {kind!r}")
    m = min(int(dim), n)
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=m, replace=False))
    landmarks = np.ascontiguousarray(x[idx])
    kmm = _host_kernel(landmarks, landmarks, spec).astype(np.float64)
    # Symmetrize against float noise before eigh; truncate the spectrum
    # at numerical zero so 1/sqrt(lambda) never amplifies noise.
    lam, u = np.linalg.eigh((kmm + kmm.T) / 2.0)
    keep = lam > max(lam[-1], 0.0) * _NYSTROM_RCOND
    if not keep.any():
        raise ValueError("nystrom landmark kernel is numerically zero — "
                         "check gamma / feature scaling")
    lam, u = lam[keep], u[:, keep]
    proj = (u / np.sqrt(lam)[None, :]).astype(np.float32)
    return FeatureMap(kind="nystrom", d=d, dim=int(proj.shape[1]),
                      seed=int(seed), gamma=float(spec.gamma),
                      kernel=spec.kind, coef0=float(spec.coef0),
                      degree=int(spec.degree), landmarks=landmarks,
                      proj=proj)


def _host_kernel(a: np.ndarray, b: np.ndarray,
                 spec: KernelSpec) -> np.ndarray:
    """Small dense K(a, b) on the host, in float64 (landmark-sized only)."""
    dots = a.astype(np.float64) @ b.astype(np.float64).T
    if spec.kind == "linear":
        return dots
    if spec.kind == "poly":
        return (spec.gamma * dots + spec.coef0) ** spec.degree
    if spec.kind == "sigmoid":
        return np.tanh(spec.gamma * dots + spec.coef0)
    a2 = np.sum(a.astype(np.float64) ** 2, axis=1)
    b2 = np.sum(b.astype(np.float64) ** 2, axis=1)
    return np.exp(-spec.gamma * np.maximum(
        a2[:, None] - 2.0 * dots + b2[None, :], 0.0))


class DeviceMap:
    """A ``FeatureMap``'s arrays on one device, and the block transform
    over them."""

    def __init__(self, fmap: FeatureMap, device: torch.device,
                 precision: str = "highest"):
        self.fmap, self.device = fmap, torch.device(device)
        # bfloat16 operands under "default" (float32 accumulation)
        self.low = str(precision).lower() == "default"
        cast = torch.bfloat16 if self.low else torch.float32
        if fmap.kind == "rff":
            # (D/2, d): the rows dots_f32 multiplies a block against
            self.omega_t = torch.from_numpy(np.ascontiguousarray(
                fmap.omega.T)).to(self.device, cast)
            self.scale = float(np.float32(math.sqrt(
                2.0 / (2 * fmap.omega.shape[1]))))
        else:
            lm = torch.from_numpy(np.ascontiguousarray(
                fmap.landmarks, np.float32)).to(self.device)
            self.l2 = row_norms_sq(lm)
            self.landmarks = lm.to(cast)
            self.proj = torch.from_numpy(np.ascontiguousarray(
                fmap.proj, np.float32)).to(self.device)

    def block(self, xb: torch.Tensor) -> torch.Tensor:
        """phi of a (m, d) float32 block on the device: (m, dim) float32."""
        fmap = self.fmap
        cast = xb.to(torch.bfloat16) if self.low else xb
        if fmap.kind == "rff":
            z = dots_f32(cast, self.omega_t)                 # (m, D/2)
            return torch.cat([torch.cos(z), torch.sin(z)], dim=1).mul_(
                self.scale)
        k = rows_from_dots(dots_f32(cast, self.landmarks),
                           row_norms_sq(xb), self.l2, fmap.kernel_spec)
        return dots_f32(k, self.proj.T)


def device_map(fmap: FeatureMap, device, precision: str = "highest"
               ) -> DeviceMap:
    return DeviceMap(fmap, resolve_device(device), precision)


def featurize_padded(fmap: FeatureMap, x: np.ndarray, n_pad: int,
                     rows: Optional[np.ndarray] = None, bias: bool = False,
                     chunk: int = CHUNK, device=None,
                     precision: str = "highest"
                     ) -> Tuple[torch.Tensor, float]:
    """The (n_pad, dim [+ 1]) float32 feature matrix on the device, and
    the float64 sum over its real rows of ||phi_i||^2 (taken before the
    bias lane). Row i featurizes ``x[rows[i]]`` (``rows`` None: x in
    order); rows at or past n = len(rows) are zero (the primal solver
    masks them out of the loss by their row weight). ``bias`` adds a
    last lane, 1 on real rows and 0 on pad rows (the primal's bias
    feature)."""
    x = np.asarray(x, np.float32)
    dm = device_map(fmap, device, precision)
    n = x.shape[0] if rows is None else len(rows)
    dim = dm.fmap.dim
    phi = torch.zeros((int(n_pad), dim + int(bias)), dtype=torch.float32,
                      device=dm.device)
    sq = torch.zeros((), dtype=torch.float64, device=dm.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        xb = x[lo:hi] if rows is None else x[rows[lo:hi]]
        blk = dm.block(torch.from_numpy(np.ascontiguousarray(xb)).to(
            dm.device))
        sq += blk.double().square().sum()
        phi[lo:hi, :dim] = blk
    if bias:
        phi[:n, dim] = 1.0
    return phi, float(sq)


def featurize(fmap: FeatureMap, x: np.ndarray, chunk: int = CHUNK,
              device=None, precision: str = "highest") -> torch.Tensor:
    """phi(x): the (n, dim) float32 features on the device."""
    x = np.asarray(x, np.float32)
    return featurize_padded(fmap, x, x.shape[0], chunk=chunk, device=device,
                            precision=precision)[0]
