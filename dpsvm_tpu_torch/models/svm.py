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
from typing import NamedTuple, Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import TrainResult
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.ops.kernels import (KernelSpec, dots_f32, exact_f32,
                                         kernel_rows, row_norms_sq,
                                         rows_from_dots)


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


#: rows a decision's products are computed over at once (``row_tiles``)
ROW_TILE = 64


class SVOperands(NamedTuple):
    """One model's (or a one-vs-one model's concatenated) decision
    operands on a device: what ``decision_block`` and
    ``pairwise_block`` read. ``x_low`` is the SV rows in bfloat16 for
    ``precision="default"`` (None: float32 products, TF32 off)."""
    x_sv: Optional[torch.Tensor]     # (S, d) f32; None for precomputed
    sv2: Optional[torch.Tensor]      # (S,) f32 squared norms
    coef: torch.Tensor               # (S,) f32 alpha * y
    b: torch.Tensor                  # () f32, or (P,) for pairwise
    spec: KernelSpec
    cols: Optional[torch.Tensor]     # precomputed: (S,) int64 SV columns
    bounds: tuple                    # pairwise: the P + 1 range ends
    x_low: Optional[torch.Tensor] = None

    def device_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in
                       (self.x_sv, self.sv2, self.coef, self.b, self.cols,
                        self.x_low) if t is not None))


def sv_operands(models, device, precision: str = "highest") -> SVOperands:
    """The operands of one SV model, or (a sequence of models sharing one
    kernel) of their concatenated SVs, copied to ``device`` once."""
    single = isinstance(models, SVMModel)
    ms = [models] if single else list(models)
    dev = torch.device(device)
    spec = ms[0].kernel_spec
    coef = torch.from_numpy(np.concatenate(
        [m.alpha * m.y_sv.astype(np.float32) for m in ms]).astype(
            np.float32)).to(dev)
    bs = np.array([m.b for m in ms], np.float32)
    b = torch.from_numpy(bs[:1].reshape(()) if single else bs).to(dev)
    bounds = tuple(int(v) for v in np.cumsum([0] + [m.n_sv for m in ms]))
    if spec.kind == "precomputed":
        cols = torch.from_numpy(np.concatenate(
            [np.asarray(m.sv_idx, np.int64) for m in ms])).to(dev)
        return SVOperands(None, None, coef, b, spec, cols, bounds)
    x_sv = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([m.x_sv for m in ms]), np.float32)).to(dev)
    low = (x_sv.to(torch.bfloat16) if str(precision).lower() == "default"
           else None)
    return SVOperands(x_sv, row_norms_sq(x_sv), coef, b, spec, None,
                      bounds, low)


def _kernel_block(xb: torch.Tensor, ops: SVOperands) -> torch.Tensor:
    """The (m, S) kernel values of a block of rows against the SVs."""
    if ops.cols is not None:
        return xb.index_select(1, ops.cols)
    if ops.x_low is not None:
        # bfloat16 operands, float32 accumulation and epilogue
        return rows_from_dots(dots_f32(xb.to(torch.bfloat16), ops.x_low),
                              row_norms_sq(xb), ops.sv2, ops.spec)
    return kernel_rows(xb, row_norms_sq(xb), ops.x_sv, ops.sv2, ops.spec)


def row_tiles(fn, xb: torch.Tensor) -> torch.Tensor:
    """``fn`` over the rows of ``xb`` in tiles of ROW_TILE rows (the last
    one padded with zero rows), the results stacked and cut to the rows'
    count. A product's algorithm, and so the order its sums take, depends
    on its row count (on the CPU for odd counts and one row; on the card
    cuBLAS picks by shape), so every decision is computed in tiles of one
    shape: a row's decision is then the same whatever the request size,
    the batch it was coalesced into or the bucket that ran it."""
    m = xb.shape[0]
    pad = (-m) % ROW_TILE
    if pad:
        xb = torch.cat([xb, xb.new_zeros((pad, xb.shape[1]))])
    if xb.shape[0] == ROW_TILE:
        return fn(xb)[:m]
    return torch.cat([fn(xb[i:i + ROW_TILE])
                      for i in range(0, xb.shape[0], ROW_TILE)])[:m]


def decision_block(xb: torch.Tensor, ops: SVOperands,
                   include_b: bool = True) -> torch.Tensor:
    """(m,) decisions of a (m, d) block on the operands' device, in row
    tiles: the one definition ``decision_function`` and the serving
    engine share (no host read, so a CUDA graph can hold it)."""
    def tile(t):
        dual = torch.matmul(_kernel_block(t, ops), ops.coef)
        return dual - ops.b if include_b else dual
    return row_tiles(tile, xb)


def pairwise_block(xb: torch.Tensor, ops: SVOperands,
                   include_b: bool = True) -> torch.Tensor:
    """(m, P) decisions of P models over their concatenated SVs, in row
    tiles: one kernel product a tile, then each model's sum over its own
    contiguous range of the columns (no sum across models)."""
    def tile(t):
        k = _kernel_block(t, ops)
        b = ops.bounds
        dual = torch.stack([torch.matmul(k[:, s:e], ops.coef[s:e])
                            for s, e in zip(b[:-1], b[1:])], dim=1)
        return dual - ops.b if include_b else dual
    return row_tiles(tile, xb)


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
    ops = sv_operands(model, dev)
    m = x_test.shape[0]
    step = m if batch_size is None else max(1, int(batch_size))
    out = np.empty((m,), np.float32)
    with exact_f32():
        for lo in range(0, m, step):
            hi = min(lo + step, m)
            xb = torch.from_numpy(x_test[lo:hi]).to(dev)
            out[lo:hi] = decision_block(xb, ops, include_b).cpu().numpy()
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
    ops = sv_operands(list(models), dev)
    m_rows, P = x_test.shape[0], len(models)
    out = np.empty((m_rows, P), np.float32)
    step = max(1, int(batch_size))
    with exact_f32():
        for lo in range(0, m_rows, step):
            hi = min(lo + step, m_rows)
            xb = torch.from_numpy(x_test[lo:hi]).to(dev)
            out[lo:hi] = pairwise_block(xb, ops, include_b).cpu().numpy()
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
