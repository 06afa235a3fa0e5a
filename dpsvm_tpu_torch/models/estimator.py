"""scikit-learn-style estimator facade (port of
``dpsvm_tpu/models/estimator.py``): SVC-shaped fit/predict/score.

``DPSVMClassifier`` adapts ``api.fit`` to the sklearn estimator protocol
and ``DPSVMRegressor`` adapts ``models/svr.train_svr``. They are
duck-typed: sklearn is not needed. They follow the fit/predict/score
conventions, get_params/set_params included, so they drop into sklearn
pipelines and CV utilities when sklearn is present.

Labels may be ANY two values (sklearn-style), not just +/-1: classes_ is
the sorted unique pair, mapped internally onto the solver's -1/+1. More
than two classes dispatch to the one-vs-one trainer. The hyperparameters
are the JAX estimators', plus ``device`` (None means the GPU, ``"cpu"``
the plain PyTorch paths). ``solver="approx-rff" | "approx-nystrom"``
fits a primal linear model over an explicit feature map (``approx/``; no
SV set, so ``n_support_`` is None after a binary fit), and ``"cascade"``
the three-stage schedule (``solver/cascade.py``); ``shards`` passes through to ``api.train``: ``shards > 1`` trains over the
ranks of an initialized process group (every rank fitting the same data),
and raises without one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig

try:
    # Optional: inheriting sklearn's mixins provides the estimator-tag
    # protocol its meta-utilities (clone, cross_val_score, pipelines,
    # is_classifier/is_regressor) check for. Everything else here is
    # self-contained, so without sklearn the classes are plain objects
    # with the same duck-typed API.
    from sklearn.base import BaseEstimator as _SkBase
    from sklearn.base import ClassifierMixin as _SkClassifier
    from sklearn.base import RegressorMixin as _SkRegressor
    _CLF_BASES = (_SkClassifier, _SkBase)
    _REG_BASES = (_SkRegressor, _SkBase)
except ImportError:                                   # pragma: no cover
    _CLF_BASES = (object,)
    _REG_BASES = (object,)


class _ParamsMixin:
    """get_params/set_params/_check_fitted derived from one per-class
    ``_PARAM_NAMES`` tuple."""

    _PARAM_NAMES: tuple = ()
    _FITTED_ATTR: str = "_model"

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._PARAM_NAMES}

    def set_params(self, **params):
        for k, v in params.items():
            if k not in self._PARAM_NAMES:
                raise ValueError(f"invalid parameter {k!r}")
            setattr(self, k, v)
        return self

    def _check_fitted(self) -> None:
        if not hasattr(self, self._FITTED_ATTR):
            raise RuntimeError(f"this {type(self).__name__} is not "
                               "fitted yet; call fit(X, y) first")

    def _common_config_kwargs(self) -> Dict[str, Any]:
        """The SVMConfig fields shared by both estimators."""
        return dict(c=self.C, kernel=self.kernel, degree=self.degree,
                    gamma=self.gamma, coef0=self.coef0, epsilon=self.tol,
                    max_iter=self.max_iter, selection=self.selection,
                    shards=self.shards, working_set=self.working_set,
                    shrinking=self.shrinking,
                    matmul_precision=self.matmul_precision,
                    solver=self.solver, approx_dim=self.approx_dim,
                    approx_seed=self.approx_seed)


def _dense(X) -> np.ndarray:
    from dpsvm_tpu_torch.utils import densify
    return np.asarray(densify(X), np.float32)


class DPSVMClassifier(_ParamsMixin, *_CLF_BASES):
    """SVM classifier on the modified-SMO solver (LIBSVM kernel family).

    Parameters mirror ``sklearn.svm.SVC`` where they overlap (C, kernel,
    degree, gamma, coef0, tol, max_iter) plus the execution knobs.
    ``gamma=None`` means 1/n_features. ``probability`` takes True (Platt
    fit on training decisions) or "cv" (5-fold held-out fit, LIBSVM's
    -b 1 procedure, 5 extra trainings).
    """

    def __init__(self, C: float = 1.0, kernel: str = "rbf",
                 degree: int = 3, gamma: Optional[float] = None,
                 coef0: float = 0.0,
                 tol: float = 1e-3, max_iter: int = 150_000,
                 selection: str = "first-order", shards: int = 1,
                 matmul_precision: str = "highest",
                 working_set: int = 2, shrinking: bool = False,
                 polish: bool = False,
                 probability: "Union[bool, str]" = False,
                 batched: bool = False,
                 class_weight: "Optional[dict]" = None,
                 solver: str = "exact", approx_dim: int = 1024,
                 approx_seed: int = 0, device=None):
        self.C = C
        self.kernel = kernel
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.tol = tol
        self.max_iter = max_iter
        self.selection = selection
        self.shards = shards
        self.matmul_precision = matmul_precision
        self.working_set = working_set
        self.shrinking = shrinking
        self.polish = polish
        self.probability = probability
        # Multiclass-only: all OvO pairs in one batched program.
        self.batched = batched
        # sklearn's class_weight dict (LIBSVM -wi): original label ->
        # cost multiplier.
        self.class_weight = class_weight
        self.solver = solver
        self.approx_dim = approx_dim
        self.approx_seed = approx_seed
        self.device = device

    _PARAM_NAMES = ("C", "kernel", "degree", "gamma", "coef0", "tol",
                    "max_iter", "selection", "shards", "matmul_precision",
                    "working_set", "shrinking", "polish", "probability",
                    "batched", "class_weight", "solver", "approx_dim",
                    "approx_seed", "device")
    _FITTED_ATTR = "classes_"

    def _config(self) -> SVMConfig:
        # polish is classification-only (the SVR wrapper seeds f)
        return SVMConfig(polish=self.polish,
                         **self._common_config_kwargs())

    def fit(self, X, y) -> "DPSVMClassifier":
        """Train; fitted state is assigned only after training succeeds,
        so a failed refit leaves the previous fit intact (and every
        optional attribute is reset, never stale from an earlier fit)."""
        from dpsvm_tpu_torch.api import fit as _fit

        X = _dense(X)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) < 2:
            raise ValueError(f"need at least 2 classes, got {classes}")
        state: Dict[str, Any] = {
            "classes_": classes, "_model": None, "_multi": None,
            "_platt": None, "intercept_": None, "n_support_": None,
        }
        dev = self.device
        if len(classes) == 2:
            cfg = self._config()
            if self.class_weight:
                from dpsvm_tpu_torch.models.multiclass import (
                    resolve_class_weight, weighted_binary_config)
                cw = resolve_class_weight(classes, self.class_weight)
                # classes[1] maps to +1 below
                cfg = weighted_binary_config(cfg,
                                             cw.get(classes[1], 1.0),
                                             cw.get(classes[0], 1.0))
            ypm = np.where(y == classes[1], 1, -1).astype(np.int32)
            model, result = _fit(X, ypm, cfg, device=dev)
            state.update(
                _model=model,
                n_iter_=result.n_iter,
                converged_=result.converged,
                intercept_=np.array([-result.b]),
                n_support_=(None if getattr(model, "is_approx", False)
                            else np.array([int(np.sum(model.y_sv < 0)),
                                           int(np.sum(model.y_sv > 0))])))
            if self.probability:
                from dpsvm_tpu_torch.models.calibration import (
                    fit_platt, fit_platt_cv)
                from dpsvm_tpu_torch.models.svm import decision_function
                if self.probability == "cv":
                    state["_platt"] = fit_platt_cv(X, ypm, cfg, device=dev)
                else:
                    dec = np.asarray(decision_function(model, X,
                                                       device=dev))
                    state["_platt"] = fit_platt(dec, ypm)
        else:
            from dpsvm_tpu_torch.models.multiclass import train_multiclass
            multi, results = train_multiclass(
                X, y, self._config(), probability=self.probability,
                batched=self.batched, class_weight=self.class_weight,
                device=dev)
            state.update(
                _multi=multi,
                n_iter_=int(sum(r.n_iter for r in results)),
                converged_=all(r.converged for r in results))
        for k, v in state.items():
            setattr(self, k, v)
        return self

    def decision_function(self, X) -> np.ndarray:
        self._check_fitted()
        if self._model is None:
            raise ValueError("decision_function is binary-only; use "
                             "predict for multiclass models")
        from dpsvm_tpu_torch.models.svm import decision_function as _dec
        return np.asarray(_dec(self._model, _dense(X), device=self.device))

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        X = _dense(X)
        if self._model is not None:
            dec = self.decision_function(X)
            return np.where(dec < 0, self.classes_[0], self.classes_[1])
        from dpsvm_tpu_torch.models.multiclass import predict_multiclass
        return predict_multiclass(self._multi, X, device=self.device)

    def predict_proba(self, X) -> np.ndarray:
        """(n, n_classes) probabilities in classes_ order; needs
        probability=True. Binary: the Platt sigmoid; multiclass:
        per-pair Platt + pairwise coupling (LIBSVM -b 1)."""
        self._check_fitted()
        if self._multi is not None:
            if self._multi.platt is None:
                raise RuntimeError("fit with probability=True to enable "
                                   "predict_proba")
            from dpsvm_tpu_torch.models.multiclass import (
                predict_proba_multiclass)
            return predict_proba_multiclass(self._multi, _dense(X),
                                            device=self.device)
        if getattr(self, "_platt", None) is None:
            raise RuntimeError("fit with probability=True to enable "
                               "predict_proba")
        from dpsvm_tpu_torch.models.calibration import sigmoid_proba
        p1 = sigmoid_proba(self.decision_function(X), *self._platt)
        return np.stack([1.0 - p1, p1], axis=1)

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


class DPSVMRegressor(_ParamsMixin, *_REG_BASES):
    """epsilon-SVR on the modified-SMO solver, sklearn-SVR-shaped.

    Parameters mirror ``sklearn.svm.SVR`` where they overlap (C, kernel,
    degree, gamma, coef0, epsilon = tube half-width, tol, max_iter) plus
    the execution knobs. See models/svr.py for the 2n-variable mapping
    onto the classification solver.
    """

    def __init__(self, C: float = 1.0, kernel: str = "rbf",
                 degree: int = 3, gamma: Optional[float] = None,
                 coef0: float = 0.0, epsilon: float = 0.1,
                 tol: float = 1e-3, max_iter: int = 150_000,
                 selection: str = "first-order", shards: int = 1,
                 matmul_precision: str = "highest",
                 working_set: int = 2, shrinking: bool = False,
                 solver: str = "exact", approx_dim: int = 1024,
                 approx_seed: int = 0, device=None):
        self.C = C
        self.kernel = kernel
        self.degree = degree
        self.gamma = gamma
        self.coef0 = coef0
        self.epsilon = epsilon
        self.tol = tol
        self.max_iter = max_iter
        self.selection = selection
        self.shards = shards
        self.matmul_precision = matmul_precision
        self.working_set = working_set
        self.shrinking = shrinking
        self.solver = solver
        self.approx_dim = approx_dim
        self.approx_seed = approx_seed
        self.device = device

    _PARAM_NAMES = ("C", "kernel", "degree", "gamma", "coef0", "epsilon",
                    "tol", "max_iter", "selection", "shards",
                    "matmul_precision", "working_set", "shrinking",
                    "solver", "approx_dim", "approx_seed", "device")

    def _config(self) -> SVMConfig:
        return SVMConfig(svr_epsilon=self.epsilon,
                         **self._common_config_kwargs())

    def fit(self, X, y) -> "DPSVMRegressor":
        from dpsvm_tpu_torch.models.svr import train_svr

        model, result = train_svr(_dense(X), np.asarray(y, np.float32),
                                  self._config(), device=self.device)
        self._model = model
        self.n_iter_ = result.n_iter
        self.converged_ = result.converged
        self.intercept_ = np.array([-result.b])
        self.n_support_ = np.array([model.n_sv])
        return self

    def predict(self, X) -> np.ndarray:
        from dpsvm_tpu_torch.models.svr import predict_svr

        self._check_fitted()
        return np.asarray(predict_svr(self._model, _dense(X),
                                      device=self.device))

    def score(self, X, y) -> float:
        """R^2, the sklearn regressor convention."""
        from dpsvm_tpu_torch.models.svr import evaluate_svr

        self._check_fitted()
        return float(evaluate_svr(self._model, _dense(X),
                                  np.asarray(y, np.float32),
                                  device=self.device)["r2"])
