"""epsilon-SVR (support vector regression) on the classification solver
(port of ``dpsvm_tpu/models/svr.py``).

LIBSVM's epsilon-SVR (``svm-train -s 3``) costs almost no new solver code,
because the SVR dual IS a classification-shaped SMO problem over 2n
variables (LIBSVM solves it with the same Solver class):

    min  1/2 (a - a*)' K (a - a*) + p sum(a + a*) - y'(a - a*)
    s.t. sum(a - a*) = 0,  0 <= a, a* <= C

Stack beta = [a; a*] with pseudo-labels z = [+1...; -1...]: the dual
gradient in Keerthi form is exactly the solver's f vector with
initialization f0 = [p - y; -p - y] (classification's f0 = -z is the
special case p=0, y=z), kernel rows taken at base indices, and the very
same I_up/I_low masks, selection, eta and alpha step. So ``train_svr``
duplicates the rows (``np.tile(K, (2, 2))`` for a precomputed kernel),
seeds f through ``api.train``'s ``f_init`` hook and runs the unmodified
paths: ``working_set > 2`` takes the decomposition and kernel B on every
round, ``shrinking=True`` the active-set manager, anything else the
general pair. A seeded problem never takes the fused pair (kernel A).
The stacked twin rows give eta exactly 0 when a twin pair is selected, so
the run clamps eta to LIBSVM's TAU (``guard_eta``; the decomposition's
subsolve always does).

The fitted regressor is an ``SVMModel`` with task="svr" whose
coefficients encode delta_i = a_i - a*_i as (alpha=|delta|,
y=sign(delta)): the batched decision function then computes the
regression prediction  y(x) = sum_i delta_i K(x_i, x) - b  unchanged.

With ``config.solver`` an approx solver, ``train_svr`` solves the
epsilon-insensitive loss in the primal instead (``approx/primal.py``, no
2n dual stacking) and returns an ``ApproxSVMModel`` with task="svr".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.models.svm import SVMModel, decision_function


def train_svr(x: np.ndarray, y: np.ndarray,
              config: Optional[SVMConfig] = None, device=None
              ) -> Tuple[SVMModel, TrainResult]:
    """Fit an epsilon-SVR. y: (n,) float targets; tube half-width =
    ``config.svr_epsilon`` (LIBSVM -p, default 0.1). ``device`` None means
    the GPU; ``"cpu"`` runs the plain PyTorch paths.

    ``config.clip`` is ALWAYS the conserving pairwise rule here: the SVR
    dual's equality constraint is part of the model, and the reference's
    independent clip drifts it. Class weights are refused."""
    from dpsvm_tpu_torch.api import train
    from dpsvm_tpu_torch.utils import densify

    x = densify(x)
    config = config or SVMConfig()
    if config.solver != "exact":
        from dpsvm_tpu_torch.approx.primal import fit_approx
        return fit_approx(x, y, config, task="svr", device=device)
    precomp = config.kernel == "precomputed"
    config.validate()
    if config.weight_pos != 1.0 or config.weight_neg != 1.0:
        raise ValueError("class weights are a classification concept; "
                         "they would weight the two SVR dual halves "
                         "asymmetrically (use a per-sample-weight "
                         "formulation instead)")
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {x.shape}")
    if precomp and x.shape[0] != x.shape[1]:
        raise ValueError(
            "precomputed SVR training needs the square (n, n) kernel "
            f"matrix K(train, train); got {x.shape}")
    if y.shape != (x.shape[0],):
        raise ValueError(f"y must be ({x.shape[0]},), got {y.shape}")
    n = x.shape[0]
    p = np.float32(config.svr_epsilon)
    if config.clip == "independent":
        config = dataclasses.replace(config, clip="pairwise")

    # the 2n pseudo-examples duplicate the original rows: for a
    # precomputed kernel their matrix is K tiled 2x2
    x2n = np.tile(x, (2, 2)) if precomp else np.vstack([x, x])
    z = np.concatenate([np.ones(n, np.int32), -np.ones(n, np.int32)])
    f0 = np.concatenate([p - y, -p - y]).astype(np.float32)
    result = train(x2n, z, config, device=device, f_init=f0,
                   guard_eta=True)

    beta = np.asarray(result.alpha, np.float32)
    delta = beta[:n] - beta[n:]
    keep = delta != 0
    extra = {}
    if precomp:
        # SV indices into the ORIGINAL n rows: prediction gathers the
        # user's K(test, train) columns like every precomputed model
        extra = dict(sv_idx=np.flatnonzero(keep).astype(np.int64),
                     n_train=n)
    model = SVMModel(
        x_sv=(np.zeros((int(keep.sum()), 0), np.float32) if precomp
              else np.ascontiguousarray(x[keep])),
        alpha=np.abs(delta[keep]),
        y_sv=np.sign(delta[keep]).astype(np.int32),
        b=float(result.b),
        gamma=float(result.gamma),
        kernel=result.kernel,
        coef0=float(result.coef0),
        degree=int(result.degree),
        task="svr",
        **extra,
    )
    return model, result


def predict_svr(model: SVMModel, x_test: np.ndarray,
                include_b: bool = True, device=None) -> np.ndarray:
    """Continuous predictions y(x) = sum_i delta_i K(x_i, x) - b."""
    if model.task != "svr":
        raise ValueError("predict_svr needs a task='svr' model; use "
                         "models.svm.predict for classifiers")
    return decision_function(model, x_test, include_b=include_b,
                             device=device)


def regression_metrics(pred: np.ndarray, y: np.ndarray) -> dict:
    """MSE / MAE / R^2: the one definition shared by the training report,
    the test CLI and cross-validation."""
    y = np.asarray(y, np.float32)
    err = np.asarray(pred, np.float32) - y
    ss_res = float(np.sum(err * err))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    return {
        "mse": float(np.mean(err * err)),
        "mae": float(np.mean(np.abs(err))),
        "r2": 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0,
    }


def evaluate_svr(model: SVMModel, x_test: np.ndarray, y_test: np.ndarray,
                 include_b: bool = True, device=None) -> dict:
    """MSE / MAE / R^2 on held-out targets."""
    return regression_metrics(
        predict_svr(model, x_test, include_b=include_b, device=device),
        y_test)
