"""k-fold cross-validation (LIBSVM's ``svm-train -v n`` mode; port of
``dpsvm_tpu/models/cv.py``).

The reference has no model-selection tooling; LIBSVM's CLI does (one of
its most-used flags), so the train CLI here grows ``--cv K``: train on
k-1 folds, predict the held-out fold, pool the held-out predictions
over all folds, and report pooled accuracy (classification) or
MSE/MAE/R^2 (regression) — exactly LIBSVM's protocol (svm.cpp
``svm_cross_validation``), including per-class stratification of the
fold assignment for classification.

Fold assignment is deterministic per ``seed`` so CV numbers are
reproducible run to run; ``kfold_assignment`` is the JAX package's, so the
same seed gives the same folds in both packages. Folds train on the card
unless ``device="cpu"``: each through the port's ``api.fit`` (kernel A at
the default config), or with ``batched=True`` all of them in one program
(``solver/batched_ovo.py``). Regression (``task="svr"``) trains each
fold through ``models/svr.train_svr``, sequentially, on unstratified folds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig


def kfold_assignment(y: np.ndarray, k: int, seed: int = 0,
                     stratify: bool = True) -> np.ndarray:
    """fold id in [0, k) per example; stratified round-robin per class
    when ``stratify`` (classification), plain shuffle otherwise."""
    n = len(y)
    if not 2 <= k <= n:
        raise ValueError(f"cv folds must be in [2, n={n}], got {k}")
    rng = np.random.default_rng(seed)
    fold = np.empty(n, np.int64)
    if stratify:
        for cls in np.unique(y):
            idx = np.flatnonzero(y == cls)
            rng.shuffle(idx)
            fold[idx] = np.arange(len(idx)) % k
    else:
        perm = rng.permutation(n)
        fold[perm] = np.arange(n) % k
    return fold


def cross_validate(x: np.ndarray, y: np.ndarray, k: int,
                   config: Optional[SVMConfig] = None,
                   task: str = "svc", seed: int = 0,
                   batched: bool = False,
                   class_weight: "Optional[dict]" = None,
                   device=None) -> dict:
    """Pooled held-out predictions over k folds.

    task: "svc" (binary or multiclass by label count) or "svr".
    Returns {"predictions", "folds", plus task metrics}. With
    ``kernel="precomputed"`` x is the (n, n) K(train, train); folds
    slice (rows, columns) sub-kernels, for both tasks, on the sequential
    per-fold path only: the batched program streams a feature matrix and
    rejects precomputed below.

    ``class_weight``: per-label costs (LIBSVM -wi; see
    models/multiclass.train_multiclass) applied to every fold's
    training — classification only, sequential only (the batched
    program shares one weight pair; SVR has no classes).

    ``batched=True`` (classification only) trains every fold's
    subproblems in ONE compiled batched program (solver/batched_ovo.py
    — the machinery is a general masked-subproblem batch, and CV folds
    are just K more masks): K subproblems for binary, K * K(K-1)/2 for
    multiclass OvO, instead of k sequential trainings. Same scope guard
    as ``train_multiclass(batched=True)``; SVR is rejected (its 2n
    pseudo-example construction doesn't share X across folds).
    """
    from dpsvm_tpu_torch.utils import densify
    x = densify(x)
    config = config or SVMConfig()
    precomp = config.kernel == "precomputed"
    if precomp:
        # LIBSVM -v with -t 4: each fold trains on the (rows, COLUMNS)
        # sub-kernel K[tr][:, tr] and scores held-out rows against
        # K[te][:, tr] — the same slicing train_multiclass uses per
        # OvO pair (its models then handle pair slicing themselves).
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[0] != x.shape[1]:
            raise ValueError(
                "precomputed CV needs the square (n, n) kernel matrix "
                f"K(train, train); got {x.shape}")
        if len(np.asarray(y)) != x.shape[0]:
            raise ValueError(
                f"y has {len(np.asarray(y))} labels for a "
                f"{x.shape[0]}-row kernel matrix")
        if batched:
            raise ValueError(
                "the batched program streams a feature matrix; "
                "precomputed CV runs the sequential per-fold path — "
                "run --cv without batching")
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    if task not in ("svc", "svr"):
        raise ValueError(f"task must be 'svc' or 'svr', got {task!r}")
    if config.checkpoint_path or config.resume_from:
        raise ValueError("checkpoint/resume are single-run options; they "
                         "cannot be shared across CV folds")

    if class_weight is not None:
        if task == "svr":
            raise ValueError("class_weight is classification-only "
                             "(SVR has no classes)")
        if batched:
            raise ValueError(
                "class_weight needs per-pair box bounds; the batched "
                "program shares one weight pair across all subproblems "
                "— run --cv without batching")
        from dpsvm_tpu_torch.models.multiclass import resolve_class_weight
        class_weight = resolve_class_weight(np.unique(y), class_weight)
    if batched and task == "svr":
        raise ValueError(
            "batched CV is classification-only: SVR folds train on "
            "2m pseudo-examples built per fold (models/svr.py), so "
            "they do not share one X the way classification folds "
            "do; run --cv without batching for SVR")

    fold = kfold_assignment(y, k, seed, stratify=task == "svc")
    if batched:
        from dpsvm_tpu_torch.solver.batched_ovo import (batched_guard,
                                                        ovo_pair_shapes)
        # Sentinel resolution is per subproblem on the sequential path:
        # per-fold for binary, per fold x pair for multiclass.
        shapes = []
        d = x.shape[1]
        for f in range(k):
            ytr = y[fold != f]
            cls = np.unique(ytr)
            if len(cls) > 2:
                shapes += ovo_pair_shapes(ytr, cls, d)
            else:
                shapes.append((len(ytr), d))
        batched_guard(config, "CV", shapes)
        pred = _cross_validate_batched(x, y, k, fold, config, device)
        return {"predictions": pred, "folds": fold, "k": k,
                "accuracy": float(np.mean(pred == y))}
    pred = np.empty(len(y), np.float32 if task == "svr" else y.dtype)
    for f in range(k):
        tr = fold != f
        te = ~tr
        if precomp:
            tr_idx = np.flatnonzero(tr)
            x_tr = np.ascontiguousarray(x[np.ix_(tr_idx, tr_idx)])
            x_te = np.ascontiguousarray(x[np.ix_(np.flatnonzero(te),
                                                 tr_idx)])
        else:
            x_tr, x_te = x[tr], x[te]
        if task == "svr":
            from dpsvm_tpu_torch.models.svr import predict_svr, train_svr
            model, _ = train_svr(x_tr, y[tr], config, device=device)
            pred[te] = predict_svr(model, x_te, device=device)
        elif len(np.unique(y[tr])) > 2:
            from dpsvm_tpu_torch.models.multiclass import (
                predict_multiclass, train_multiclass)
            mc, _ = train_multiclass(x_tr, y[tr], config,
                                     class_weight=class_weight,
                                     device=device)
            pred[te] = predict_multiclass(mc, x_te, device=device)
        else:
            from dpsvm_tpu_torch.api import fit
            from dpsvm_tpu_torch.models.svm import predict
            classes = np.unique(y[tr])
            if len(classes) < 2:
                # A fold whose train split holds one class would pass
                # _check_xy (all-+1 is a subset of {-1,+1}) and train a
                # degenerate model; fail loudly instead.
                raise ValueError(
                    f"CV fold {f}: training split has a single class "
                    f"({classes!r}) — a class has fewer than {k} members; "
                    "reduce k or rebalance the data")
            ypm = np.where(y[tr] == classes[-1], 1, -1).astype(np.int32)
            cfg = config
            if class_weight is not None:
                from dpsvm_tpu_torch.models.multiclass import (
                    weighted_binary_config)
                cfg = weighted_binary_config(
                    config, class_weight.get(classes[-1], 1.0),
                    class_weight.get(classes[0], 1.0))
            model, _ = fit(x_tr, ypm, cfg, device=device)
            p = predict(model, x_te, device=device)
            pred[te] = np.where(p > 0, classes[-1], classes[0])

    out = {"predictions": pred, "folds": fold, "k": k}
    if task == "svr":
        from dpsvm_tpu_torch.models.svr import regression_metrics
        out.update(regression_metrics(pred, y))
    else:
        out["accuracy"] = float(np.mean(pred == y))
    return out


def _cross_validate_batched(x: np.ndarray, y: np.ndarray, k: int,
                            fold: np.ndarray, config: SVMConfig,
                            device=None) -> np.ndarray:
    """All folds' classification subproblems in one batched program.

    Binary: K subproblems, subproblem f = the +/-1 problem on rows with
    fold != f. Multiclass: K * P subproblems (every fold x every OvO
    pair), then each fold's slice of results votes on its held-out rows
    exactly like the sequential path's per-fold MulticlassModel.
    """
    from dpsvm_tpu_torch.models.svm import predict
    from dpsvm_tpu_torch.solver.batched_ovo import (build_pair_targets,
                                                    compact_submodel,
                                                    train_ovo_batched)

    classes = np.unique(y)
    if len(classes) < 2:
        # Same fail-loudly contract as the sequential per-fold guard:
        # a P=0 pair batch would otherwise "train" nothing and vote
        # classes[0] everywhere with a perfect-looking accuracy.
        raise ValueError(f"need at least 2 classes, got {classes}")
    n = len(y)
    pred = np.empty(n, y.dtype)
    # Fold f's training split must hold every class (the sequential
    # path's per-fold guard, checked up front here since training is
    # one shot).
    for f in range(k):
        tr_classes = np.unique(y[fold != f])
        if len(tr_classes) < len(classes):
            raise ValueError(
                f"CV fold {f}: training split is missing classes "
                f"(has {tr_classes!r}) — a class has fewer than {k} "
                "members; reduce k or rebalance the data")

    if len(classes) == 2:
        ypm = np.where(y == classes[-1], 1, -1).astype(np.float32)
        yb = np.tile(ypm, (k, 1))
        valid = np.stack([fold != f for f in range(k)])
        yb[~valid] = 0.0
        results = train_ovo_batched(x, yb, valid, config, device=device)
        for f, r in enumerate(results):
            sel = valid[f]
            ys = np.where(ypm[sel] > 0, 1, -1).astype(np.int32)
            model, _ = compact_submodel(x, sel, ys, r)
            te = fold == f
            p = predict(model, x[te], device=device)
            pred[te] = np.where(p > 0, classes[-1], classes[0])
        return pred

    # Multiclass: K folds x P pairs in one batch. Subproblem (f, p)
    # is pair p's +/-1 problem masked to fold f's training rows.
    pair_yb, pair_valid, pairs = build_pair_targets(y, classes)
    P = len(pairs)
    yb = np.repeat(pair_yb[None, :, :], k, axis=0).reshape(k * P, n)
    valid = (np.repeat(pair_valid[None, :, :], k, axis=0)
             & np.stack([fold != f for f in range(k)])[:, None, :]
             ).reshape(k * P, n)
    yb[~valid] = 0.0
    results = train_ovo_batched(x, yb, valid, config, device=device)
    from dpsvm_tpu_torch.models.multiclass import (MulticlassModel,
                                                   predict_multiclass)
    for f in range(k):
        models = []
        for p, (ai, bi) in enumerate(pairs):
            sel = valid[f * P + p]
            ys = np.where(y[sel] == classes[ai], 1, -1).astype(np.int32)
            model, _ = compact_submodel(x, sel, ys, results[f * P + p])
            models.append(model)
        mc = MulticlassModel(classes=classes, pairs=pairs, models=models)
        te = fold == f
        pred[te] = predict_multiclass(mc, x[te], device=device)
    return pred


def cross_validate_c_sweep(x: np.ndarray, y: np.ndarray, k: int, cs,
                           config: Optional[SVMConfig] = None,
                           seed: int = 0, gammas=None,
                           device=None) -> dict:
    """CV accuracy at every point of a C (x gamma) grid — ALL folds x
    grid points in one compiled batched program (binary
    classification).

    This is LIBSVM grid.py (one k-fold CV per grid point, each fold a
    full training) collapsed into a single batch of k * len(cs) [*
    len(gammas)] masked subproblems. Returns {"cs", "accuracies",
    "best_c", "best_accuracy", "folds"}; with ``gammas`` also
    {"gammas", "best_gamma"}, and "accuracies" becomes a
    (len(cs), len(gammas)) matrix. Ties prefer the SMALLER C (more
    regularization at equal held-out accuracy), then the smaller gamma
    (smoother kernel).
    """
    from dpsvm_tpu_torch.models.svm import predict
    from dpsvm_tpu_torch.solver.batched_ovo import (batched_guard,
                                                    compact_submodel,
                                                    train_ovo_batched,
                                                    validate_c_grid)
    from dpsvm_tpu_torch.utils import densify

    config = config or SVMConfig()
    batched_guard(config, "CV C-sweep")
    if config.checkpoint_path or config.resume_from:
        raise ValueError("checkpoint/resume are single-run options; "
                         "they cannot be shared across the sweep's "
                         "fold x C subproblems")
    # capture the caller's ORIGINAL values before the f32 training cast
    # (reported best_c/best_gamma must compare equal to the input grid)
    cs_in = [float(c) for c in np.asarray(cs).ravel()]
    gammas_in = (None if gammas is None
                 else [float(g) for g in np.asarray(gammas).ravel()])
    cs, gammas = validate_c_grid(cs, config, gammas)
    x = np.asarray(densify(x), np.float32)
    y = np.asarray(y)
    classes = np.unique(y)
    if len(classes) != 2:
        raise ValueError("the CV C-sweep is binary-only; run "
                         "cross_validate per C for multiclass")

    fold = kfold_assignment(y, k, seed, stratify=True)
    for f in range(k):
        if len(np.unique(y[fold != f])) < 2:
            raise ValueError(
                f"CV fold {f}: training split has a single class — a "
                f"class has fewer than {k} members; reduce k")
    batched_guard(config, "CV C-sweep",
                  [(int(np.sum(fold != f)), x.shape[1])
                   for f in range(k)])
    ypm = np.where(y == classes[-1], 1, -1).astype(np.float32)
    n = len(y)
    # The per-fold grid column: (C, gamma) pairs in row-major order
    # (plain C list when no gamma axis).
    if gammas_in is None:
        grid_c, grid_g = list(cs), None
    else:
        grid_c = [c for c in cs for _ in gammas_in]
        grid_g = np.array(gammas_in * len(cs), np.float32)
    J = len(grid_c)
    # Subproblem (f, j) -> row f*J + j: fold f's mask, grid point j.
    yb = np.tile(ypm, (k * J, 1))
    valid = np.repeat(np.stack([fold != f for f in range(k)]), J, axis=0)
    yb[~valid] = 0.0
    c_values = np.tile(np.asarray(grid_c, np.float32), k)
    gamma_values = None if grid_g is None else np.tile(grid_g, k)
    results = train_ovo_batched(x, yb, valid, config, device=device,
                                c_values=c_values,
                                gamma_values=gamma_values)

    correct = np.zeros(J, np.int64)
    for f in range(k):
        te = fold == f
        sel = valid[f * J]              # same training mask for all C
        # the fold's training slice and labels are shared by its whole
        # C column — copy once, not J times
        xs = np.ascontiguousarray(x[sel])
        ys = np.where(ypm[sel] > 0, 1, -1).astype(np.int32)
        for j in range(J):
            model, _ = compact_submodel(x, sel, ys, results[f * J + j],
                                        xs=xs)
            p = predict(model, x[te], device=device)
            pred = np.where(p > 0, classes[-1], classes[0])
            correct[j] += int(np.sum(pred == y[te]))
    accs = correct / float(n)
    # report the caller's ORIGINAL values (the f32 cast is a training
    # detail; best_c must compare equal to the input grid point)
    if gammas_in is None:
        best = int(max(range(J), key=lambda j: (accs[j], -cs_in[j])))
        return {"cs": cs_in, "accuracies": accs, "best_c": cs_in[best],
                "best_accuracy": float(accs[best]), "folds": fold,
                "k": k}
    G = len(gammas_in)
    best = int(max(range(J), key=lambda j: (
        accs[j], -cs_in[j // G], -gammas_in[j % G])))
    return {"cs": cs_in, "gammas": gammas_in,
            "accuracies": accs.reshape(len(cs_in), G),
            "best_c": cs_in[best // G], "best_gamma": gammas_in[best % G],
            "best_accuracy": float(accs[best]), "folds": fold, "k": k}
