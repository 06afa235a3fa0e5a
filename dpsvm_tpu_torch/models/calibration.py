"""Platt scaling: calibrated probabilities from SVM decision values (port of
``dpsvm_tpu/models/calibration.py``; the fit is numpy, a copy of the JAX
package's, so the same decision values give the same (A, B)).

LIBSVM's ``-b 1`` analog (the reference has no probability outputs).
Fits P(y=+1 | dec) = 1 / (1 + exp(A*dec + B)) by regularized maximum
likelihood with Newton's method (Platt 1999, with the Lin/Weng/Lin 2007
numerical fixes: target smoothing and a stable log-sum formulation).

Two fit procedures: ``fit_platt`` on the training decision values
(the cheap default — one extra inference pass; overestimates
confidence slightly on well-separated data) and ``fit_platt_cv``,
LIBSVM's actual -b 1 procedure (pool 5-fold held-out decisions at the
cost of five extra trainings; CLI ``--probability-cv``, estimator
``probability="cv"`` — measured 8x closer to sklearn's calibrated
probabilities in the JAX package's tests/test_calibration.py). The
decision values come from the port's ``decision_function``, on the card
unless ``device="cpu"``.

Persisted as a ``<model>.platt.json`` sidecar so the reference-format
model file stays byte-compatible with the reference tooling.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from dpsvm_tpu_torch.models.svm import SVMModel, decision_function


def fit_platt(dec: np.ndarray, y: np.ndarray,
              max_iter: int = 100) -> Tuple[float, float]:
    """Fit (A, B) of the sigmoid on decision values dec with labels y."""
    dec = np.asarray(dec, np.float64)
    y = np.asarray(y)
    n_pos = int(np.sum(y > 0))
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Platt fit needs both classes present")
    # Smoothed targets (Platt 1999 eq. for prior-correct regularization).
    t = np.where(y > 0, (n_pos + 1.0) / (n_pos + 2.0),
                 1.0 / (n_neg + 2.0))

    a, b = 0.0, float(np.log((n_neg + 1.0) / (n_pos + 1.0)))
    sigma = 1e-12
    for _ in range(max_iter):
        p = sigmoid_proba(dec, a, b)
        # gradient of the negative log-likelihood wrt (a, b)
        d1 = t - p
        g1 = float(np.dot(dec, d1))
        g2 = float(np.sum(d1))
        if abs(g1) < 1e-5 and abs(g2) < 1e-5:
            break
        w = p * (1.0 - p)
        h11 = float(np.dot(dec * dec, w)) + sigma
        h22 = float(np.sum(w)) + sigma
        h21 = float(np.dot(dec, w))
        det = h11 * h22 - h21 * h21
        da = -(h22 * g1 - h21 * g2) / det
        db = -(-h21 * g1 + h11 * g2) / det
        # Backtracking line search on the NLL. With p = 1/(1+e^z):
        # NLL = -sum[t log p + (1-t) log(1-p)]
        #     =  sum[logaddexp(0, z) - (1-t) z]   (stable for any z)
        def nll(aa, bb):
            zz = aa * dec + bb
            return float(np.sum(np.logaddexp(0.0, zz) - (1.0 - t) * zz))
        base = nll(a, b)
        step = 1.0
        while step >= 1e-10:
            na, nb = a + step * da, b + step * db
            if nll(na, nb) < base + 1e-4 * step * (g1 * da + g2 * db):
                a, b = na, nb
                break
            step *= 0.5
        else:
            break
    return float(a), float(b)


def fit_platt_cv(x: np.ndarray, y: np.ndarray, config,
                 k: int = 5, seed: int = 0,
                 device=None) -> Tuple[float, float]:
    """LIBSVM-faithful sigmoid fit: pool decision values of k-fold
    HELD-OUT models, then fit (A, B) on the pooled values.

    This is exactly what svm-train -b 1 does (libsvm's
    svm_binary_svc_probability): the extra k trainings buy decision
    values that are not optimistically separated by the very model
    being calibrated. The plain ``fit_platt`` on training decisions is
    the documented cheap default; this is the quality option
    (CLI: --probability-cv).
    """
    import dataclasses

    from dpsvm_tpu_torch.api import fit as _fit
    from dpsvm_tpu_torch.models.cv import kfold_assignment

    # The fold fits are internal: checkpoint/resume/profiling belong to
    # the caller's MAIN fit. Sharing them here would re-resume a
    # full-n checkpoint into fold-sized problems (shape error) or let
    # five fold fits overwrite the real run's checkpoint file.
    config = dataclasses.replace(config, checkpoint_path=None,
                                 checkpoint_every=0, resume_from=None)
    y = np.asarray(y)
    fold = kfold_assignment(y, k, seed=seed)
    dec = np.empty(len(y), np.float64)
    for f in range(k):
        tr = fold != f
        te = ~tr
        if len(np.unique(y[tr])) < 2:
            raise ValueError(f"CV-fit calibration: fold {f} leaves a "
                             "single training class — use fewer folds "
                             "or plain --probability")
        model, _ = _fit(np.ascontiguousarray(x[tr]), y[tr], config,
                        device=device)
        dec[te] = np.asarray(decision_function(model, x[te],
                                               device=device))
    return fit_platt(dec, y)


def sigmoid_proba(dec: np.ndarray, a: float, b: float) -> np.ndarray:
    """P(y = +1 | dec) = 1/(1 + exp(a*dec + b)), computed stably on
    either side of z = 0."""
    z = a * np.asarray(dec, np.float64) + b
    ez = np.exp(-np.abs(z))
    return np.where(z >= 0, ez / (1.0 + ez), 1.0 / (1.0 + ez))


def predict_proba(model: SVMModel, x: np.ndarray, a: float, b: float,
                  include_b: bool = True, device=None) -> np.ndarray:
    """P(y = +1 | x) under the fitted sigmoid."""
    return sigmoid_proba(decision_function(model, x, include_b=include_b,
                                           device=device), a, b)


def sidecar_path(model_path: str) -> str:
    return model_path + ".platt.json"


def save_platt(model_path: str, a: float, b: float) -> None:
    with open(sidecar_path(model_path), "w") as f:
        json.dump({"format": "dpsvm_tpu-platt-v1", "A": a, "B": b}, f)


def load_platt(model_path: str) -> Tuple[float, float]:
    p = sidecar_path(model_path)
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    with open(p) as f:
        d = json.load(f)
    if d.get("format") != "dpsvm_tpu-platt-v1":
        raise ValueError(f"{p}: unknown format {d.get('format')!r}")
    return float(d["A"]), float(d["B"])
