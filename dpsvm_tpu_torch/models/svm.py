"""Trained-model representation and batched inference (port of
``dpsvm_tpu/models/svm.py``): the models of every kernel kind, for
classification, regression and one-class (``task``), all evaluated by the
same decision function.

The whole evaluation is one (m, d) x (d, n_sv) product per batch with the
kernel's epilogue and a reduction against alpha * y;
``pairwise_decision_values`` evaluates the P models of a one-vs-one model
in one product over their concatenated SVs. The JAX package
leaves that product to XLA outside any Pallas kernel; here it is
``torch.matmul`` in float32 with TF32 off. A precomputed-kernel model
keeps SV indices into the training set, and its input is K(test, train):
the decision gathers the SV columns.

Decision rule parity: prediction is +1 iff dual >= 0
(``svmTrain.cu:650-656``); ``include_b`` subtracts the intercept, as the
trainer's accuracy does (``svmTrain.cu:648``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import TrainResult
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.ops.kernels import (KernelSpec, exact_f32, kernel_rows,
                                         row_norms_sq)


@dataclasses.dataclass
class SVMModel:
    """Support vectors + duals: everything the model file holds
    (gamma, b, then per-SV alpha, y, x — ``svmTrainMain.cpp:386-416``)."""

    x_sv: np.ndarray      # (n_sv, d) float32 ((n_sv, 0) for precomputed)
    alpha: np.ndarray     # (n_sv,) float32, all > 0
    y_sv: np.ndarray      # (n_sv,) int32 +/-1
    b: float
    gamma: float
    kernel: str = "rbf"   # LIBSVM -t family; "rbf" = the reference's
    coef0: float = 0.0
    degree: int = 3
    task: str = "svc"     # "svc" (classification), "svr" (regression:
                          # alpha, y_sv encode delta = a - a*) or
                          # "oneclass" (y_sv all +1, b = rho)
    sv_idx: Optional[np.ndarray] = None   # precomputed only: SV indices
                          # into the training set (LIBSVM's "0:serial")
    n_train: Optional[int] = None         # precomputed only: the width
                          # K(test, train) must have
    n_train_exact: bool = True            # False: n_train is a lower
                          # bound (a model file whose svidx width ends
                          # in '+', from a LIBSVM import)

    @property
    def kernel_spec(self) -> KernelSpec:
        """The evaluation's kernel, with gamma and coef0 in float32 as the
        JAX package's decision program receives them."""
        return KernelSpec(kind=self.kernel,
                          gamma=np.float32(self.gamma).item(),
                          coef0=np.float32(self.coef0).item(),
                          degree=int(self.degree))

    @property
    def n_sv(self) -> int:
        return int(self.alpha.shape[0])

    @property
    def num_attributes(self) -> int:
        """Width the evaluation input must have: d for vector kernels,
        n_train (K(test, train) columns) for precomputed."""
        if self.kernel == "precomputed":
            return int(self.n_train)
        return int(self.x_sv.shape[1])

    @classmethod
    def from_train_result(cls, x: np.ndarray, y: np.ndarray,
                          result: TrainResult) -> "SVMModel":
        """Compact SVs (alpha > 0) out of the training set — the
        ``aggregate_sv`` step (``svmTrain.cu:595-631``) as one mask. For a
        precomputed kernel x is K, and the model keeps the SV indices."""
        alpha = np.asarray(result.alpha, dtype=np.float32)
        keep = alpha > 0
        common = dict(alpha=alpha[keep], y_sv=np.asarray(y, np.int32)[keep],
                      b=float(result.b), gamma=float(result.gamma),
                      kernel=result.kernel, coef0=float(result.coef0),
                      degree=int(result.degree))
        if result.kernel == "precomputed":
            return cls(x_sv=np.zeros((int(keep.sum()), 0), np.float32),
                       sv_idx=np.flatnonzero(keep).astype(np.int64),
                       n_train=int(np.asarray(x).shape[0]), **common)
        return cls(
            x_sv=np.ascontiguousarray(np.asarray(x, np.float32)[keep]),
            **common)


def decision_function(model: SVMModel, x_test: np.ndarray,
                      include_b: bool = True,
                      batch_size: Optional[int] = 8192,
                      device=None) -> np.ndarray:
    """dual_i = sum_j alpha_j y_j K(x_j, t_i) [- b], in batches of at most
    ``batch_size`` test rows so device memory stays bounded (one batch
    holds (batch_size, n_sv) kernel values). For a precomputed kernel
    ``x_test`` is K(test, train) and the batch's kernel values are its SV
    columns. Approx models (``approx/``) dispatch to their own decision
    (featurize, then one product with the weights)."""
    if getattr(model, "is_approx", False):
        from dpsvm_tpu_torch.approx.model import decision_function as _approx
        return _approx(model, x_test, include_b=include_b,
                       batch_size=batch_size, device=device)
    dev = resolve_device(device)
    x_test = np.ascontiguousarray(x_test, np.float32)
    width = model.num_attributes
    if x_test.ndim != 2 or not (x_test.shape[1] == width or (
            model.kernel == "precomputed" and not model.n_train_exact
            and x_test.shape[1] > width)):
        raise ValueError(f"x_test must be (m, {width}), got {x_test.shape}"
                         + (" (K(test, train): one column per training row)"
                            if model.kernel == "precomputed" else ""))
    spec = model.kernel_spec
    coef = torch.from_numpy(
        (model.alpha * model.y_sv.astype(np.float32)).astype(np.float32)
    ).to(dev)
    b = torch.tensor(np.float32(model.b), device=dev)
    if spec.kind == "precomputed":
        cols = torch.from_numpy(np.asarray(model.sv_idx, np.int64)).to(dev)
    else:
        x_sv = torch.from_numpy(np.ascontiguousarray(model.x_sv,
                                                     np.float32)).to(dev)
        sv2 = row_norms_sq(x_sv)
    m = x_test.shape[0]
    step = m if batch_size is None else max(1, int(batch_size))
    out = np.empty((m,), np.float32)
    with exact_f32():
        for lo in range(0, m, step):
            hi = min(lo + step, m)
            xb = torch.from_numpy(x_test[lo:hi]).to(dev)
            if spec.kind == "precomputed":
                k = xb.index_select(1, cols)
            else:
                k = kernel_rows(xb, row_norms_sq(xb), x_sv, sv2, spec)
            dual = torch.matmul(k, coef)
            if include_b:
                dual = dual - b
            out[lo:hi] = dual.cpu().numpy()
    return out


def pairwise_decision_values(models, x_test: np.ndarray,
                             include_b: bool = True,
                             batch_size: int = 8192,
                             device=None) -> np.ndarray:
    """(m, P) decision values of P models that share one kernel (a
    one-vs-one model's pairs) in one pass: per batch of at most
    ``batch_size`` test rows, one (m, d) x (d, S) kernel product over the
    concatenated SVs of all P models, then each model's sum over its own
    contiguous range of the S columns (a product with its alpha * y),
    minus its b. Each pair's sum is its own reduction: nothing is added
    across pairs (no atomics, so the same order on every run, and a
    non-finite kernel value stays in its pair's decision)."""
    dev = resolve_device(device)
    x_test = np.ascontiguousarray(x_test, np.float32)
    spec = models[0].kernel_spec
    bounds = np.cumsum([0] + [m.n_sv for m in models])
    x_sv = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([m.x_sv for m in models]), np.float32)).to(dev)
    coef = torch.from_numpy(np.concatenate(
        [m.alpha * m.y_sv.astype(np.float32) for m in models]).astype(
            np.float32)).to(dev)
    b = torch.from_numpy(np.array([m.b for m in models], np.float32)).to(dev)
    sv2 = row_norms_sq(x_sv)
    m_rows, P = x_test.shape[0], len(models)
    out = np.empty((m_rows, P), np.float32)
    step = max(1, int(batch_size))
    with exact_f32():
        for lo in range(0, m_rows, step):
            hi = min(lo + step, m_rows)
            xb = torch.from_numpy(x_test[lo:hi]).to(dev)
            k = kernel_rows(xb, row_norms_sq(xb), x_sv, sv2, spec)
            dual = torch.stack([torch.matmul(k[:, s:e], coef[s:e])
                                for s, e in zip(bounds[:-1], bounds[1:])],
                               dim=1)
            if include_b:
                dual = dual - b
            out[lo:hi] = dual.cpu().numpy()
    return out


def predict(model: SVMModel, x_test: np.ndarray, include_b: bool = True,
            device=None) -> np.ndarray:
    """+1 iff dual >= 0 (svmTrain.cu:650-656)."""
    dual = decision_function(model, x_test, include_b=include_b,
                             device=device)
    return np.where(dual < 0, -1, 1).astype(np.int32)


def evaluate(model: SVMModel, x_test: np.ndarray, y_test: np.ndarray,
             include_b: bool = True, device=None) -> float:
    """Fraction of correct predictions."""
    pred = predict(model, x_test, include_b=include_b, device=device)
    return float(np.mean(pred == np.asarray(y_test, np.int32)))
