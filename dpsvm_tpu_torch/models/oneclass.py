"""One-class SVM (novelty detection) on the classification solver (port of
``dpsvm_tpu/models/oneclass.py``).

LIBSVM's one-class formulation (``svm-train -s 2``, Schoelkopf et al.):

    min  1/2 a' K a
    s.t. 0 <= a_i <= 1,  sum(a) = nu * n

All pseudo-labels are +1, so the Keerthi machinery applies verbatim: the
dual gradient is f = K a (no linear term), the pair update moves mass
between two alphas (s = +1 conserves the sum), and the box is C = 1. Like
SVR (``models/svr.py``), the whole thing runs on the unmodified solver
paths through ``api.train``'s ``alpha_init`` + ``f_init`` hooks, seeded
with LIBSVM's own initialization: a_i = 1 for the first floor(nu*n)
points, the fractional remainder on the next one, 0 after, and f0 = K a0
in one streamed kernel pass on the device (``ops/diagnostics._stream_kv``;
one matvec for a precomputed kernel). ``working_set > 2`` takes the
decomposition (kernel B), whose first round then starts with floor(nu*n)
alphas at the box.

Decision: f(x) = sum_i a_i K(x_i, x) - rho with rho = (b_lo + b_hi)/2,
the batched decision function (y_sv all +1), task "oneclass"; sign >= 0
means inlier.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.models.svm import SVMModel, decision_function


def oneclass_seed(n: int, nu: float) -> np.ndarray:
    """LIBSVM's seed (svm.cpp solve_one_class): sum(alpha0) = nu * n, 1 on
    the first floor(nu n) rows and the fraction on the next one."""
    target = nu * n
    n_full = int(target)
    alpha0 = np.zeros(n, np.float32)
    alpha0[:n_full] = 1.0
    if n_full < n:
        alpha0[n_full] = np.float32(target - n_full)
    return alpha0


def train_oneclass(x: np.ndarray, nu: float = 0.5,
                   config: Optional[SVMConfig] = None, device=None
                   ) -> Tuple[SVMModel, TrainResult]:
    """Fit a one-class SVM on unlabeled rows. 0 < nu < 1 bounds the
    outlier fraction (LIBSVM -n). ``config.c`` is ignored (the one-class
    box is 1 by construction). ``device`` None means the GPU; ``"cpu"``
    runs the plain PyTorch paths."""
    from dpsvm_tpu_torch.api import train
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.ops.diagnostics import _stream_kv
    from dpsvm_tpu_torch.utils import densify

    x = densify(x)
    config = config or SVMConfig()
    precomp = config.kernel == "precomputed"
    if not 0.0 < nu < 1.0:
        raise ValueError(f"nu must be in (0, 1), got {nu}")
    if config.weight_pos != 1.0 or config.weight_neg != 1.0:
        raise ValueError("class weights do not apply to one-class "
                         "training (there is one pseudo-class)")
    x = np.asarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {x.shape}")
    if precomp and x.shape[0] != x.shape[1]:
        raise ValueError(
            "precomputed one-class training needs the square (n, n) "
            f"kernel matrix K(train, train); got {x.shape}")
    n, d = x.shape
    alpha0 = oneclass_seed(n, nu)
    if not np.any(alpha0 > 0):
        raise ValueError(f"nu={nu} with n={n} initializes no support "
                         "vectors; increase nu or the dataset size")
    dev = resolve_device(device)
    if precomp:
        # x IS K: the seed gradient is one matvec, no kernel pass
        f0 = (x @ alpha0).astype(np.float32)
    else:
        f0 = _stream_kv(x, alpha0, config.kernel_spec(d), block=4096,
                        device=dev)
    z = np.ones(n, np.int32)
    # c = 1 by construction; the pairwise clip because the constraint
    # VALUE (sum alpha = nu n) is part of the model
    config = dataclasses.replace(config, c=1.0, clip="pairwise")
    result = train(x, z, config, device=dev, f_init=f0, alpha_init=alpha0,
                   guard_eta=True)

    alpha = np.asarray(result.alpha, np.float32)
    keep = alpha > 0
    extra = {}
    if precomp:
        extra = dict(sv_idx=np.flatnonzero(keep).astype(np.int64),
                     n_train=n)
    model = SVMModel(
        x_sv=(np.zeros((int(keep.sum()), 0), np.float32) if precomp
              else np.ascontiguousarray(x[keep])),
        alpha=alpha[keep],
        y_sv=np.ones(int(keep.sum()), np.int32),
        b=float(result.b),                    # rho
        gamma=float(result.gamma),
        kernel=result.kernel,
        coef0=float(result.coef0),
        degree=int(result.degree),
        task="oneclass",
        **extra,
    )
    return model, result


def score_oneclass(model: SVMModel, x_test: np.ndarray,
                   device=None) -> np.ndarray:
    """Signed decision values sum_i a_i K(x_i, x) - rho (>= 0: inlier)."""
    if model.task != "oneclass":
        raise ValueError("score_oneclass needs a task='oneclass' model")
    return decision_function(model, x_test, include_b=True, device=device)


def predict_oneclass(model: SVMModel, x_test: np.ndarray,
                     device=None) -> np.ndarray:
    """+1 inlier / -1 outlier (sklearn OneClassSVM convention)."""
    dec = score_oneclass(model, x_test, device=device)
    return np.where(dec < 0, -1, 1).astype(np.int32)
