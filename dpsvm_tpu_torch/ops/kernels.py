"""RBF kernel math on tensors (port of ``dpsvm_tpu/ops/kernels.py``).

The reference computes kernel rows as one SGEMV per working-set index
(``svmTrain.cu:216-249``) followed by the elementwise
exp(-gamma (|x_i|^2 + |x_a|^2 - 2 dot)) (``svmTrain.cu:128-135``). Only the
RBF kernel is ported.
"""

from __future__ import annotations

import numpy as np
import torch


def row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    """|x_i|^2 per row, in float32 whatever x's type."""
    xf = x.float()
    return (xf * xf).sum(dim=1)


def host_row_norms_sq(x) -> np.ndarray:
    """|x_i|^2 per row on the host, with the JAX package's expression
    (``ops/kernels.host_row_norms_sq``): the decomposition feeds these
    norms to the device, as its JAX counterpart does."""
    xf = np.ascontiguousarray(x, dtype=np.float32)
    return np.einsum("ij,ij->i", xf, xf).astype(np.float32)


def rows_from_dots(dots: torch.Tensor, w2: torch.Tensor, x2: torch.Tensor,
                   gamma) -> torch.Tensor:
    """K(a, i) = exp(-gamma (|x_i|^2 + |x_a|^2 - 2 x_a.x_i)).

    dots: (r, n) dot products of r working rows against all points;
    w2: (r,) squared norms of the working rows; x2: (n,). Same operations
    in the same order as the JAX expression,
    ``exp(-gamma * (x2[None, :] + w2[:, None] - 2.0 * dots))``, but in
    place: ``dots`` is consumed, and one (r, n) temporary is made instead
    of four (the decomposition's blocks are gigabytes)."""
    k = x2[None, :] + w2[:, None]
    k.sub_(dots.mul_(2.0))
    return k.mul_(-gamma).exp_()


def kernel_rows(rows: torch.Tensor, w2: torch.Tensor, x: torch.Tensor,
                x2: torch.Tensor, gamma) -> torch.Tensor:
    """Full RBF kernel rows for the given working rows: (r, n), in f32."""
    dots = torch.matmul(rows.float(), x.float().T)
    return rows_from_dots(dots, w2, x2, gamma)

