"""Kernel math on tensors (port of ``dpsvm_tpu/ops/kernels.py``): RBF, the
reference's kernel, and the rest of the LIBSVM family, all from the same
dot products:

    linear       K = u.v
    poly         K = (gamma u.v + coef0)^degree
    rbf          K = exp(-gamma |u - v|^2)
    sigmoid      K = tanh(gamma u.v + coef0)
    precomputed  X is K itself: a "row fetch" is a gather, and the x2 slot
                 carries diag(K)

The reference computes kernel rows as one SGEMV per working-set index
(``svmTrain.cu:216-249``) followed by the elementwise
exp(-gamma (|x_i|^2 + |x_a|^2 - 2 dot)) (``svmTrain.cu:128-135``). Every
solver path goes through ``rows_from_dots`` / ``kdiag_from_norms`` with a
``KernelSpec``, so the RBF expression is the same whatever else is added.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch


class KernelSpec(NamedTuple):
    """Kernel description (a hashable value, as in the JAX package)."""

    kind: str = "rbf"        # linear | poly | rbf | sigmoid | precomputed
    gamma: float = 1.0       # unused by linear/precomputed
    coef0: float = 0.0       # poly / sigmoid only
    degree: int = 3          # poly only

    @property
    def is_rbf(self) -> bool:
        return self.kind == "rbf"

    @classmethod
    def coerce(cls, value) -> "KernelSpec":
        """A KernelSpec, or a bare gamma float as RBF shorthand."""
        if isinstance(value, cls):
            return value
        return cls(kind="rbf", gamma=float(value))


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls in full float32: TF32 off for the block (on the
    card, also while a CUDA graph is captured: the math mode is baked into
    the captured products)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dots_f32(rows: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """rows . xb^T as float32: full float32 for float32 X; for bfloat16 X
    bfloat16 products accumulated in float32 (``torch.mm`` with
    ``out_dtype``: a bfloat16 ``matmul`` would round the dots to
    bfloat16); on the CPU, which has no such product, the same values
    through a float32 product."""
    if rows.dtype == torch.float32:
        with exact_f32():
            return torch.matmul(rows, xb.T)
    if rows.is_cuda:
        return torch.mm(rows, xb.T, out_dtype=torch.float32)
    return torch.matmul(rows.float(), xb.float().T)


def row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    """|x_i|^2 per row, in float32 whatever x's type."""
    xf = x.float()
    return (xf * xf).sum(dim=1)


def host_row_norms_sq(x) -> np.ndarray:
    """|x_i|^2 per row on the host, with the JAX package's expression
    (``ops/kernels.host_row_norms_sq``): the solvers feed these norms to
    the device, as their JAX counterparts do."""
    xf = np.ascontiguousarray(x, dtype=np.float32)
    return np.einsum("ij,ij->i", xf, xf).astype(np.float32)


def host_row_stats(x, spec) -> np.ndarray:
    """The per-row scalar the solvers carry as ``x2``: squared row norms
    for the vector kernels, diag(K) for precomputed (x is then K)."""
    spec = KernelSpec.coerce(spec)
    if spec.kind == "precomputed":
        return np.ascontiguousarray(
            np.diagonal(np.asarray(x, np.float32))).astype(np.float32)
    return host_row_norms_sq(x)


def integer_pow(v: torch.Tensor, degree: int) -> torch.Tensor:
    """v ** degree for an integer degree >= 1 by exponentiation by
    squaring, the multiplications in the order XLA is given them for
    ``lax.integer_pow`` (jax/_src/lax/lax.py ``_integer_pow``), so the
    rounding matches bit for bit. ``torch.pow`` has special cases of its
    own for small exponents."""
    acc, base, e = None, v, int(degree)
    while e > 0:
        if e & 1:
            acc = base if acc is None else acc * base
        e >>= 1
        if e > 0:
            base = base * base
    return acc


def _affine(v: torch.Tensor, spec: KernelSpec) -> torch.Tensor:
    """gamma v + coef0 rounded once, as one fused multiply-add: XLA
    contracts the JAX expression ``g * dots + coef0`` into an FMA, and
    ``addcmul`` computes it so (on the CPU and on the card) when its scale
    is 1. The constants are made on v's device by a fill, which a captured
    CUDA graph can hold."""
    return torch.addcmul(v.new_full((), spec.coef0), v,
                         v.new_full((), spec.gamma))


def rows_from_dots(dots: torch.Tensor, w2: torch.Tensor, x2: torch.Tensor,
                   spec) -> torch.Tensor:
    """Kernel rows from dot products, by kind.

    dots: (r, n) dot products of r working rows against all points (RBF
    consumes it); w2: (r,) squared norms of the working rows (RBF only);
    x2: (n,). ``spec`` is a KernelSpec or a bare gamma (RBF).

    RBF is ``exp(-gamma * (x2[None, :] + w2[:, None] - 2.0 * dots))``,
    the JAX expression operation for operation, but in place: one (r, n)
    temporary is made instead of four (the decomposition's blocks are
    gigabytes)."""
    spec = KernelSpec.coerce(spec)
    g = spec.gamma
    if spec.kind == "rbf":
        k = x2[None, :] + w2[:, None]
        k.sub_(dots.mul_(2.0))
        return k.mul_(-g).exp_()
    if spec.kind == "linear":
        return dots
    if spec.kind == "poly":
        return integer_pow(_affine(dots, spec), spec.degree)
    if spec.kind == "sigmoid":
        return torch.tanh(_affine(dots, spec))
    raise ValueError(f"unknown kernel kind {spec.kind!r}")


def kdiag_from_norms(x2: torch.Tensor, spec) -> torch.Tensor:
    """K(i, i) from the x2 slot (WSS2's a_j needs the diagonal; for RBF
    it is identically 1, and callers keep the reference's literal
    ``2 - 2K`` form instead)."""
    spec = KernelSpec.coerce(spec)
    if spec.kind == "rbf":
        return torch.ones_like(x2)
    if spec.kind in ("linear", "precomputed"):
        return x2          # precomputed: x2 carries diag(K)
    if spec.kind == "poly":
        return integer_pow(_affine(x2, spec), spec.degree)
    if spec.kind == "sigmoid":
        return torch.tanh(_affine(x2, spec))
    raise ValueError(f"unknown kernel kind {spec.kind!r}")


def kernel_rows(rows: torch.Tensor, w2: torch.Tensor, x: torch.Tensor,
                x2: torch.Tensor, spec) -> torch.Tensor:
    """Full kernel rows for the given working rows: (r, n), in float32.
    For precomputed the gathered rows are the kernel rows."""
    spec = KernelSpec.coerce(spec)
    if spec.kind == "precomputed":
        return rows.float()
    dots = torch.matmul(rows.float(), x.float().T)
    return rows_from_dots(dots, w2, x2, spec)
