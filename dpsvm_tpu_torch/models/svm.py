"""Trained-model representation and batched inference (port of
``dpsvm_tpu/models/svm.py``, RBF models).

The whole evaluation is one (m, d) x (d, n_sv) product per batch with the
RBF epilogue and a reduction against alpha * y. The JAX package leaves that
product to XLA outside any Pallas kernel; here it is ``torch.matmul`` in
float32 (TF32 is off by default for matmuls in PyTorch and this module
does not turn it on).

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
from dpsvm_tpu_torch.ops.kernels import kernel_rows, row_norms_sq


@dataclasses.dataclass
class SVMModel:
    """Support vectors + duals: everything the model file holds
    (gamma, b, then per-SV alpha, y, x — ``svmTrainMain.cpp:386-416``)."""

    x_sv: np.ndarray      # (n_sv, d) float32
    alpha: np.ndarray     # (n_sv,) float32, all > 0
    y_sv: np.ndarray      # (n_sv,) int32 +/-1
    b: float
    gamma: float
    kernel: str = "rbf"

    @property
    def n_sv(self) -> int:
        return int(self.alpha.shape[0])

    @property
    def num_attributes(self) -> int:
        return int(self.x_sv.shape[1])

    @classmethod
    def from_train_result(cls, x: np.ndarray, y: np.ndarray,
                          result: TrainResult) -> "SVMModel":
        """Compact SVs (alpha > 0) out of the training set — the
        ``aggregate_sv`` step (``svmTrain.cu:595-631``) as one mask."""
        alpha = np.asarray(result.alpha, dtype=np.float32)
        keep = alpha > 0
        return cls(
            x_sv=np.ascontiguousarray(np.asarray(x, np.float32)[keep]),
            alpha=alpha[keep],
            y_sv=np.asarray(y, np.int32)[keep],
            b=float(result.b),
            gamma=float(result.gamma),
            kernel=result.kernel,
        )


def decision_function(model: SVMModel, x_test: np.ndarray,
                      include_b: bool = True,
                      batch_size: Optional[int] = 8192,
                      device=None) -> np.ndarray:
    """dual_i = sum_j alpha_j y_j K(x_j, t_i) [- b], in batches of at most
    ``batch_size`` test rows so device memory stays bounded (one batch
    holds (batch_size, n_sv) kernel values)."""
    if model.kernel != "rbf":
        raise NotImplementedError(
            f"kernel {model.kernel!r} is not ported to dpsvm_tpu_torch yet")
    dev = resolve_device(device)
    x_test = np.ascontiguousarray(x_test, np.float32)
    if x_test.ndim != 2 or x_test.shape[1] != model.num_attributes:
        raise ValueError(f"x_test must be (m, {model.num_attributes}), got "
                         f"{x_test.shape}")
    x_sv = torch.from_numpy(np.ascontiguousarray(model.x_sv,
                                                 np.float32)).to(dev)
    sv2 = row_norms_sq(x_sv)
    coef = torch.from_numpy(
        (model.alpha * model.y_sv.astype(np.float32)).astype(np.float32)
    ).to(dev)
    b = torch.tensor(np.float32(model.b), device=dev)
    gamma = np.float32(model.gamma).item()
    m = x_test.shape[0]
    step = m if batch_size is None else max(1, int(batch_size))
    out = np.empty((m,), np.float32)
    for lo in range(0, m, step):
        hi = min(lo + step, m)
        xb = torch.from_numpy(x_test[lo:hi]).to(dev)
        k = kernel_rows(xb, row_norms_sq(xb), x_sv, sv2, gamma)
        dual = torch.matmul(k, coef)
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
