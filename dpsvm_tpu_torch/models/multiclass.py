"""Multi-class classification: one-vs-one on the binary SMO trainer (port of
``dpsvm_tpu/models/multiclass.py``).

Beyond-reference capability (the reference is strictly binary): the
LIBSVM construction — K(K-1)/2 pairwise binary problems, each trained on
the examples of its two classes with labels remapped to +/-1 (first
class of the pair = +1), prediction by majority vote with ties going to
the earlier class in sorted order.

Persistence is a directory: ``index.json`` (classes + pair file names)
plus one reference-format model file per pair, so every sub-model stays
individually loadable by the binary tooling. The files are the JAX
package's byte for byte: a directory written by either package loads and
predicts the same in the other.

Training runs on the card unless ``device="cpu"``: sequentially, each
pair through the port's ``api.fit`` (at the default config the fused pair,
kernel A; with ``working_set > 2`` the decomposition, kernel B), or with
``batched=True`` all pairs in one program (``solver/batched_ovo.py``). The
P pairwise decisions come from one kernel product over the concatenated
SVs (``models/svm.pairwise_decision_values``). nu-SVC pairs come with
``models/nusvm.py``, which is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.models.io import load_model, save_model
from dpsvm_tpu_torch.models.svm import (SVMModel, decision_function,
                                        pairwise_decision_values)


@dataclasses.dataclass
class MulticlassModel:
    classes: np.ndarray                    # (k,) sorted original labels
    pairs: List[Tuple[int, int]]           # index pairs into classes
    models: List[SVMModel]                 # one per pair
    platt: "Optional[List[Tuple[float, float]]]" = None
                                           # per-pair Platt (A, B) when
                                           # trained with probability

    @property
    def n_classes(self) -> int:
        return len(self.classes)


def resolve_class_weight(classes, class_weight) -> dict:
    """Validate a user class_weight mapping against the label set.

    ONE copy of the rules for every entry point (train_multiclass, the
    sklearn estimator): must be a dict-like label -> weight mapping
    (sklearn's "balanced" string is NOT supported — compute the weights
    explicitly), and every key must be a label present in y."""
    if isinstance(class_weight, str) or not hasattr(class_weight, "get"):
        raise ValueError(
            f"class_weight must be a dict mapping label -> cost weight; "
            f"got {class_weight!r} ('balanced' is not supported — "
            "compute the weights explicitly, e.g. n/(k*bincount))")
    unknown = {k for k in class_weight if not np.any(classes == k)}
    if unknown:
        raise ValueError(
            f"class_weight has labels not present in y: "
            f"{sorted(unknown)} (classes: {classes.tolist()})")
    return dict(class_weight)


def weighted_binary_config(config: SVMConfig, w_pos: float,
                           w_neg: float) -> SVMConfig:
    """The weighted subproblem's config: C*w_pos on the +1 side,
    C*w_neg on the -1 side, and ALWAYS the pairwise clip.

    class_weight is DEFINED as LIBSVM's -wi, whose solver does the
    joint (pairwise) alpha update — semantic, not stylistic: under the
    reference's independent clip, asymmetric box bounds let
    sum(alpha*y) drift arbitrarily far (measured on the wine 0-vs-1
    pair at w=(0.3, 2.0): drift -252.9, intercept -226.9 vs libsvm's
    2.0 — a converged-but-wrong model), while the pairwise rule
    conserves the constraint and matches libsvm's b to 1e-3."""
    cfg = dataclasses.replace(config, clip="pairwise",
                              weight_pos=float(w_pos),
                              weight_neg=float(w_neg))
    cfg.validate()
    return cfg


def train_multiclass(x: np.ndarray, y: np.ndarray,
                     config: Optional[SVMConfig] = None,
                     probability: "Union[bool, str]" = False,
                     batched: bool = False,
                     class_weight: "Optional[dict]" = None,
                     nu: Optional[float] = None,
                     device=None,
                     ) -> Tuple[MulticlassModel, List[TrainResult]]:
    """Train OvO; y may hold any integer labels (2 classes work too).

    ``nu``: nu-SVC pairs (LIBSVM ``-s 1``) need ``models/nusvm.py``,
    which the port does not have yet: raises NotImplementedError.
    ``device`` None means the GPU; ``"cpu"`` runs the plain PyTorch
    paths.

    ``class_weight``: LIBSVM's ``-wi`` generalized to any label set
    (sklearn's ``class_weight`` dict): maps original label -> cost
    multiplier; a pair (a, b) trains with C*w[a] on a's examples and
    C*w[b] on b's. Labels absent from the mapping weigh 1.0. Sequential
    path only (the batched program shares one weight pair across all
    subproblems — rejected loudly, not ignored).

    ``probability=True`` fits a per-pair Platt sigmoid on the pair's
    training decision values (the binary --probability simplification,
    see models/calibration.py) so ``predict_proba_multiclass`` can
    couple them — LIBSVM's ``-b 1`` for multiclass. ``probability="cv"``
    fits each pair's sigmoid on k-fold held-out decisions instead
    (LIBSVM's actual procedure, at k extra trainings per pair).

    ``batched=True`` trains ALL pairs in one compiled batched program
    (solver/batched_ovo.py): per-pair trajectories are exactly the
    sequential solver's, but the X stream and the per-step latency
    floor are paid once per batched step for every pair instead of per
    pair. Restricted to the plain first-order single-device path (the
    guard below); the sequential loop remains the general one."""
    from dpsvm_tpu_torch.api import fit
    from dpsvm_tpu_torch.utils import densify

    if nu is not None:
        raise NotImplementedError(
            "nu-SVC multi-class training needs models/nusvm.py, which is "
            "not ported to dpsvm_tpu_torch yet")
    x = densify(x)
    config = config or SVMConfig()
    precomp = config.kernel == "precomputed"
    if precomp:
        # LIBSVM -t 4 with >2 classes: each pair trains on the
        # (rows, COLUMNS) sub-kernel K[sel][:, sel], and the pair
        # model's SV indices are remapped to GLOBAL training indices
        # afterwards so prediction consumes the user's full
        # K(test, train) like any precomputed binary model.
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[0] != x.shape[1]:
            raise ValueError(
                "precomputed multiclass training needs the square "
                f"(n, n) kernel matrix K(train, train); got {x.shape}")
        if len(np.asarray(y)) != x.shape[0]:
            # the flatnonzero+fancy-indexing pair slicing below would
            # silently train on a row subset for a short y (the
            # vector-kernel path's boolean mask fails loudly instead)
            raise ValueError(
                f"y has {len(np.asarray(y))} labels for a "
                f"{x.shape[0]}-row kernel matrix")
        if batched:
            raise ValueError(
                "the batched program streams a feature matrix; "
                "precomputed multiclass runs the sequential per-pair "
                "path — train with batched=False")
        if probability == "cv":
            raise ValueError(
                "probability='cv' refits on row subsets, which needs "
                "matching kernel column subsets per fold; use "
                "probability=True with the precomputed kernel")
    if config.checkpoint_path or config.resume_from:
        # Every pairwise fit would share the one checkpoint file —
        # overwriting each other or failing shape validation mid-run.
        raise ValueError(
            "checkpoint_path/resume_from are single-model options; "
            "they cannot be shared across the pairwise multiclass "
            "subproblems")
    y = np.asarray(y)
    classes = np.unique(y)
    if len(classes) < 2:
        raise ValueError(f"need at least 2 classes, got {classes}")
    if class_weight is not None:
        if batched:
            raise ValueError(
                "class_weight needs per-pair box bounds; the batched "
                "program shares one weight pair across all subproblems "
                "— train with batched=False")
        if config.weight_pos != 1.0 or config.weight_neg != 1.0:
            raise ValueError(
                "pass either class_weight (per original label) or "
                "config weight_pos/weight_neg (per pair side), not "
                "both — ambiguous which applies to a pair")
        class_weight = resolve_class_weight(classes, class_weight)

    def pair_config(ai: int, bi: int) -> SVMConfig:
        """The pair's config: C*w[a] on the +1 side, C*w[b] on the -1
        side, pairwise clip (see weighted_binary_config; numpy label
        scalars hash-equal their python values, so the user's dict
        keys look up directly)."""
        if class_weight is None:
            return config
        return weighted_binary_config(
            config, class_weight.get(classes[ai], 1.0),
            class_weight.get(classes[bi], 1.0))

    if batched:
        from dpsvm_tpu_torch.solver.batched_ovo import (batched_guard,
                                                        ovo_pair_shapes)
        batched_guard(config, "OvO",
                      ovo_pair_shapes(y, classes, x.shape[1]))
    dev = resolve_device(device)
    pairs, models, results = [], [], []
    platt: Optional[List[Tuple[float, float]]] = [] if probability else None
    if batched:
        from dpsvm_tpu_torch.solver.batched_ovo import (build_pair_targets,
                                                        compact_submodel,
                                                        train_ovo_batched)

        yb, valid, pairs = build_pair_targets(y, classes)
        batch_results = train_ovo_batched(x, yb, valid, config, device=dev)
        for p, (ai, bi) in enumerate(pairs):
            sel = valid[p]
            ys = np.where(y[sel] == classes[ai], 1, -1).astype(np.int32)
            model, r = compact_submodel(x, sel, ys, batch_results[p])
            models.append(model)
            results.append(r)
            if probability:
                from dpsvm_tpu_torch.models.calibration import (
                    fit_platt, fit_platt_cv)
                xs = np.ascontiguousarray(x[sel])
                if probability == "cv":
                    platt.append(fit_platt_cv(xs, ys, config, device=dev))
                else:
                    dec = np.asarray(decision_function(models[-1], xs,
                                                       device=dev))
                    platt.append(fit_platt(dec, ys))
        return MulticlassModel(classes=classes, pairs=pairs,
                               models=models, platt=platt), results
    for ai in range(len(classes)):
        for bi in range(ai + 1, len(classes)):
            sel = (y == classes[ai]) | (y == classes[bi])
            sel_idx = np.flatnonzero(sel)
            if precomp:
                # the pair's SQUARE sub-kernel (rows AND columns)
                xs = np.ascontiguousarray(x[np.ix_(sel_idx, sel_idx)])
            else:
                xs = np.ascontiguousarray(x[sel])
            ys = np.where(y[sel] == classes[ai], 1, -1).astype(np.int32)
            cfg = pair_config(ai, bi)
            model, result = fit(xs, ys, cfg, device=dev)
            if precomp:
                # remap the pair-local SV indices to the full training
                # set and widen n_train, so this model evaluates
                # against the user's (m, n) K(test, train) directly
                model = dataclasses.replace(
                    model, sv_idx=sel_idx[model.sv_idx],
                    n_train=x.shape[0])
            pairs.append((ai, bi))
            models.append(model)
            results.append(result)
            if probability:
                from dpsvm_tpu_torch.models.calibration import (
                    fit_platt, fit_platt_cv)
                if probability == "cv":
                    platt.append(fit_platt_cv(xs, ys, cfg, device=dev))
                else:
                    # precomputed: the remapped model consumes the
                    # n-wide rows K[sel] (not the square slice)
                    xdec = x[sel] if precomp else xs
                    dec = np.asarray(decision_function(model, xdec,
                                                       device=dev))
                    platt.append(fit_platt(dec, ys))
    return MulticlassModel(classes=classes, pairs=pairs,
                           models=models, platt=platt), results


def pairwise_decisions(model: MulticlassModel, x: np.ndarray,
                       include_b: bool = True,
                       device=None) -> List[np.ndarray]:
    """One decision vector per pair — computed once and shared by the
    vote and the probability coupling (each pass is a full kernel
    inference; callers evaluating both must not pay it twice).

    When every pair shares one kernel spec (always true for models this
    package trains; checked, not assumed — a hand-assembled directory
    may mix kernels), all P inferences collapse into ONE pass
    (``pairwise_decision_values``): one ``(m, d) @ (d, sum n_sv)``
    product over the concatenated SV rows, then each pair's sum over
    its own SV range."""
    ms = model.models
    specs = {(m.kernel, float(m.gamma), float(m.coef0), int(m.degree))
             for m in ms}
    if len(specs) == 1 and ms[0].kernel != "precomputed" and len(ms) > 1:
        out = pairwise_decision_values(ms, x, include_b=include_b,
                                       device=device)
        return [out[:, p] for p in range(len(ms))]
    return [np.asarray(decision_function(m, x, include_b=include_b,
                                         device=device))
            for m in ms]


def predict_multiclass(model: MulticlassModel, x: np.ndarray,
                       include_b: bool = True,
                       decisions: Optional[List[np.ndarray]] = None,
                       device=None) -> np.ndarray:
    """Majority vote over pairwise decisions; ties -> earlier class.

    include_b=False drops the intercept like seq_test.cpp:197, matching
    the binary evaluator's --no-b. ``decisions`` reuses a
    ``pairwise_decisions`` result (include_b must match)."""
    if decisions is None:
        decisions = pairwise_decisions(model, x, include_b=include_b,
                                       device=device)
    n = x.shape[0]
    votes = np.zeros((n, model.n_classes), dtype=np.int32)
    for (ai, bi), dec in zip(model.pairs, decisions):
        votes[:, ai] += dec >= 0
        votes[:, bi] += dec < 0
    return model.classes[np.argmax(votes, axis=1)]


def _couple_pairwise(r: np.ndarray, max_iter: int = 100,
                     eps: float = 1e-12) -> np.ndarray:
    """Class probabilities from pairwise ones (Wu, Lin & Weng 2004,
    their second method — the one LIBSVM's multiclass -b 1 uses).

    r: (n, k, k) with r[t, i, j] = P(class i | i or j, x_t) and
    r[t, j, i] = 1 - r[t, i, j]. Minimizes
    sum_i sum_{j != i} (r[j,i] p_i - r[i,j] p_j)^2 subject to
    p >= 0, sum p = 1, by the paper's Gauss-Seidel iteration —
    implemented from the published equations, vectorized over the n
    samples (every sample runs the same component update in lockstep;
    convergence is per the max over samples)."""
    n, k, _ = r.shape
    if k == 2:
        p = np.empty((n, 2))
        p[:, 0] = r[:, 0, 1]
        p[:, 1] = r[:, 1, 0]
        return p
    q = np.zeros((n, k, k))
    for i in range(k):
        for j in range(k):
            if i == j:
                mask = np.ones(k, bool)
                mask[i] = False
                q[:, i, i] = np.sum(r[:, mask, i] ** 2, axis=1)
            else:
                q[:, i, j] = -r[:, j, i] * r[:, i, j]
    p = np.full((n, k), 1.0 / k)
    for _ in range(max_iter):
        qp = np.einsum("nij,nj->ni", q, p)
        pqp = np.einsum("ni,ni->n", p, qp)
        if np.max(np.abs(qp - pqp[:, None])) < 0.005 / k:
            break
        for t in range(k):
            diff = (-qp[:, t] + pqp) / q[:, t, t]
            p[:, t] += diff
            pqp = ((pqp + diff * (diff * q[:, t, t] + 2.0 * qp[:, t]))
                   / (1.0 + diff) ** 2)
            qp = (qp + diff[:, None] * q[:, t, :]) / (1.0 + diff)[:, None]
            p /= (1.0 + diff)[:, None]
    return np.clip(p, eps, None) / np.sum(
        np.clip(p, eps, None), axis=1, keepdims=True)


def predict_proba_multiclass(model: MulticlassModel, x: np.ndarray,
                             decisions: Optional[List[np.ndarray]]
                             = None, device=None) -> np.ndarray:
    """(n, k) class probabilities in ``model.classes`` order via
    per-pair Platt sigmoids + pairwise coupling (LIBSVM -b 1).
    ``decisions`` reuses a ``pairwise_decisions`` result (the sigmoids
    were fit on intercept-included decisions, so it must be one
    computed with include_b=True)."""
    from dpsvm_tpu_torch.models.calibration import sigmoid_proba

    if model.platt is None:
        raise ValueError("this multiclass model was trained without "
                         "probability calibration — retrain with "
                         "probability=True (CLI: --multiclass "
                         "--probability)")
    if decisions is None:
        decisions = pairwise_decisions(model, x, include_b=True,
                                       device=device)
    n = x.shape[0]
    k = model.n_classes
    r = np.zeros((n, k, k))
    for (ai, bi), dec, (pa, pb) in zip(model.pairs, decisions,
                                       model.platt):
        # pair label +1 == class ai (train_multiclass's orientation);
        # LIBSVM clips coupled inputs away from exact 0/1
        pr = np.clip(sigmoid_proba(dec, pa, pb), 1e-7, 1.0 - 1e-7)
        r[:, ai, bi] = pr
        r[:, bi, ai] = 1.0 - pr
    return _couple_pairwise(r)


def evaluate_multiclass(model: MulticlassModel, x: np.ndarray,
                        y: np.ndarray, include_b: bool = True,
                        device=None) -> float:
    return float(np.mean(predict_multiclass(model, x, include_b,
                                            device=device)
                         == np.asarray(y)))


def save_multiclass(model: MulticlassModel, dirpath: str) -> None:
    os.makedirs(dirpath, exist_ok=True)
    entries = []
    for i, ((ai, bi), m) in enumerate(zip(model.pairs, model.models)):
        name = f"pair_{int(model.classes[ai])}_{int(model.classes[bi])}.svm"
        save_model(m, os.path.join(dirpath, name))
        entry = {"a": int(ai), "b": int(bi), "file": name}
        if model.platt is not None:
            pa, pb = model.platt[i]
            entry["platt"] = [float(pa), float(pb)]
        entries.append(entry)
    with open(os.path.join(dirpath, "index.json"), "w") as f:
        json.dump({"format": "dpsvm_tpu-ovo-v1",
                   "classes": [int(c) for c in model.classes],
                   "pairs": entries}, f, indent=1)


def load_multiclass(dirpath: str) -> MulticlassModel:
    index_path = os.path.join(dirpath, "index.json")
    if not os.path.exists(index_path):
        raise FileNotFoundError(index_path)
    with open(index_path) as f:
        index = json.load(f)
    if index.get("format") != "dpsvm_tpu-ovo-v1":
        raise ValueError(f"{index_path}: unknown format "
                         f"{index.get('format')!r}")
    classes = np.asarray(index["classes"])
    pairs, models, platt = [], [], []
    for e in index["pairs"]:
        pairs.append((int(e["a"]), int(e["b"])))
        models.append(load_model(os.path.join(dirpath, e["file"])))
        if "platt" in e:
            platt.append((float(e["platt"][0]), float(e["platt"][1])))
    if platt and len(platt) != len(pairs):
        raise ValueError(f"{index_path}: {len(platt)} platt entries for "
                         f"{len(pairs)} pairs — corrupt index")
    return MulticlassModel(classes=classes, pairs=pairs, models=models,
                           platt=platt or None)
