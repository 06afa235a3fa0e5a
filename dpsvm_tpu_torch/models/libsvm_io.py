"""LIBSVM ``.model``-format interoperability (port of
``dpsvm_tpu/models/libsvm_io.py``, numpy only).

The reference's model file is its own CSV-ish layout
(``svmTrainMain.cpp:386-416`` — handled by ``models/io.py``); users
switching from LIBSVM/sklearn bring files in LIBSVM's standard text
format instead::

    svm_type c_svc
    kernel_type rbf
    gamma 0.25
    nr_class 2
    total_sv 253
    rho -0.087
    label 1 -1
    nr_sv 130 123
    SV
    <sv_coef> <idx>:<val> <idx>:<val> ...

Mapping onto ``SVMModel`` (decision f(x) = sum_i alpha_i y_i K(x_i,x)
- b, positive => +1 — the reference's convention, which is LIBSVM's
too):

* ``sv_coef_i = alpha_i * y_i`` and ``rho = b``, directly — true for
  binary c_svc, for epsilon_svr (where our alpha/y_sv encode
  delta = a - a*), and for one_class (y_sv all +1, b = rho).
* LIBSVM's decision is positive for ``label[0]``; when a c_svc file
  says ``label -1 1`` the stored coefficients are the negatives of
  ours, so loading flips them (and rho) to keep our positive==+1
  convention. Writing always emits ``label 1 -1``.
* SV feature lines are 1-based sparse ``idx:val``; absent indices are
  zero. Writing emits non-zero features only (LIBSVM's own tools do
  the same for dense data).

Only the binary tasks this framework trains are supported: ``c_svc``,
``epsilon_svr``, ``one_class`` (multiclass LIBSVM files hold k>2
classes and pairwise rho blocks — out of scope, rejected loudly).
Numbers are written with the JAX package's formats (``.17g`` for the
header's floats and the coefficients, ``.9g`` for SV features), so a
model either package writes is the same file byte for byte (each SV line
is one %-format of its non-zero features).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from dpsvm_tpu_torch.models.svm import SVMModel

_TASK_TO_SVMTYPE = {"svc": "c_svc", "svr": "epsilon_svr",
                    "oneclass": "one_class"}
_SVMTYPE_TO_TASK = {v: k for k, v in _TASK_TO_SVMTYPE.items()}
_SVMTYPE_TO_TASK["nu_svc"] = "svc"    # a fitted nu model's decision
_SVMTYPE_TO_TASK["nu_svr"] = "svr"    # function is the same functional
                                      # form; only training differed
_KERNEL_TO_LIBSVM = {"linear": "linear", "poly": "polynomial",
                     "rbf": "rbf", "sigmoid": "sigmoid",
                     "precomputed": "precomputed"}
_LIBSVM_TO_KERNEL = {v: k for k, v in _KERNEL_TO_LIBSVM.items()}


def save_libsvm_model(model: SVMModel, path: str) -> int:
    """Write ``model`` in LIBSVM's text format; returns SV lines written.

    SVs are grouped +1-class first to match the ``label 1 -1`` /
    ``nr_sv`` segmentation LIBSVM's own readers assume.
    """
    if model.task not in _TASK_TO_SVMTYPE:
        raise ValueError(f"cannot export task {model.task!r} as a "
                         "LIBSVM model (supported: svc, svr, oneclass)")
    if model.kernel == "precomputed" and model.sv_idx is None:
        # Validate before opening the file: failing mid-write would
        # leave a truncated .model behind.
        raise ValueError("precomputed model has no sv_idx (training "
                         "serials) — cannot write LIBSVM '0:serial' "
                         "SV lines")
    coef = np.asarray(model.alpha, np.float64) * np.asarray(
        model.y_sv, np.float64)
    x = np.asarray(model.x_sv)
    order = np.argsort(-np.asarray(model.y_sv))   # +1 block, then -1
    lines: List[str] = [
        f"svm_type {_TASK_TO_SVMTYPE[model.task]}",
        f"kernel_type {_KERNEL_TO_LIBSVM[model.kernel]}",
    ]
    if model.kernel == "poly":
        lines.append(f"degree {int(model.degree)}")
    if model.kernel != "linear":
        lines.append(f"gamma {model.gamma:.17g}")
    if model.kernel in ("poly", "sigmoid"):
        lines.append(f"coef0 {model.coef0:.17g}")
    if model.task == "svc":
        n_pos = int(np.sum(model.y_sv > 0))
        lines += ["nr_class 2", f"total_sv {model.n_sv}",
                  f"rho {model.b:.17g}", "label 1 -1",
                  f"nr_sv {n_pos} {model.n_sv - n_pos}"]
    else:
        lines += ["nr_class 2", f"total_sv {model.n_sv}",
                  f"rho {model.b:.17g}"]
    lines.append("SV")
    for i in order:
        if model.kernel == "precomputed":
            # LIBSVM stores the SV as its 1-based training serial
            feats = f"0:{int(model.sv_idx[i]) + 1}"
        else:
            # the non-zero features; one %-format a line gives the text
            # f"{j + 1}:{v:.9g}" gives per value
            nz = np.flatnonzero(x[i])
            feats = (" %d:%.9g" * len(nz))[1:] % tuple(
                v for pair in zip((nz + 1).tolist(), x[i][nz].tolist())
                for v in pair)
        lines.append(f"{coef[i]:.17g} {feats}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return model.n_sv


def load_libsvm_model(path: str,
                      n_features: Optional[int] = None) -> SVMModel:
    """Read a LIBSVM ``.model`` file into an ``SVMModel``.

    ``n_features`` widens the SV matrix when the file's largest feature
    index undershoots the data's dimensionality (trailing all-zero
    columns are unrepresented in the sparse format).
    """
    with open(path) as fh:
        raw = [ln.strip() for ln in fh]
    header: Dict[str, str] = {}
    sv_lines: List[str] = []
    in_sv = False
    for ln in raw:
        if not ln:
            continue
        if in_sv:
            sv_lines.append(ln)
        elif ln == "SV":
            in_sv = True
        else:
            key, _, val = ln.partition(" ")
            header[key] = val.strip()
    if not in_sv:
        raise ValueError(f"{path}: no 'SV' section — not a LIBSVM "
                         "model file")

    svm_type = header.get("svm_type", "c_svc")
    if svm_type not in _SVMTYPE_TO_TASK:
        raise ValueError(f"{path}: unsupported svm_type {svm_type!r}")
    task = _SVMTYPE_TO_TASK[svm_type]
    ltype = header.get("kernel_type", "rbf")
    if ltype not in _LIBSVM_TO_KERNEL:
        raise ValueError(f"{path}: unsupported kernel_type {ltype!r}")
    kernel = _LIBSVM_TO_KERNEL[ltype]
    nr_class = int(header.get("nr_class", 2))
    if task == "svc" and nr_class != 2:
        raise ValueError(f"{path}: {nr_class}-class LIBSVM models hold "
                         "pairwise coef/rho blocks; import binary "
                         "models (train --multiclass keeps per-pair "
                         "model files instead)")
    rho_vals = [float(v) for v in header.get("rho", "0").split()]
    if len(rho_vals) != 1:
        raise ValueError(f"{path}: expected one rho for a binary model, "
                         f"got {len(rho_vals)}")
    rho = rho_vals[0]

    def _svc_label_flip(coefs, rho):
        """LIBSVM's decision is positive for label[0]; ours for +1 —
        a 'label -1 1' file stores negated coefficients."""
        labels = [int(v) for v in header.get("label", "1 -1").split()]
        if sorted(labels) != [-1, 1]:
            raise ValueError(f"{path}: binary import needs labels "
                             f"{{-1, 1}}, got {labels} — remap labels "
                             "at conversion time (cli convert)")
        if labels[0] == -1:
            return -coefs, -rho
        return coefs, rho

    coefs = np.empty(len(sv_lines), np.float64)
    if kernel == "precomputed":
        if task != "svc":
            raise ValueError(f"{path}: precomputed import supports "
                             "c_svc models only")
        # SV lines are "coef 0:serial" — the SV's 1-based position in
        # the training set. n_train is not stored by LIBSVM; use
        # n_features (K(test, train) width) when given, else the
        # largest serial seen.
        sv_idx = np.empty(len(sv_lines), np.int64)
        for i, ln in enumerate(sv_lines):
            parts = ln.split()
            if len(parts) != 2 or not parts[1].startswith("0:"):
                raise ValueError(f"{path}: precomputed SV line {i} must "
                                 f"be '<coef> 0:<serial>', got {ln!r}")
            coefs[i] = float(parts[0])
            serial = int(parts[1][2:])
            if serial < 1:
                raise ValueError(f"{path}: SV serial {serial} (LIBSVM "
                                 "serials are 1-based)")
            sv_idx[i] = serial - 1
        coefs, rho_pc = _svc_label_flip(coefs, rho)
        # LIBSVM stores no n_train: the largest serial only bounds it
        # from below. Pass n_features (the K(test, train) width) to get
        # the true width — cli test does.
        n_train = max(int(sv_idx.max()) + 1, n_features or 0)
        return SVMModel(
            x_sv=np.zeros((len(sv_lines), 0), np.float32),
            alpha=np.abs(coefs).astype(np.float32),
            y_sv=np.where(coefs >= 0, 1, -1).astype(np.int32),
            b=rho_pc, gamma=float(header.get("gamma", 1.0)),
            kernel="precomputed", task="svc",
            sv_idx=sv_idx, n_train=n_train,
            n_train_exact=n_features is not None)
    feats: List[Dict[int, float]] = []
    max_idx = 0
    for i, ln in enumerate(sv_lines):
        parts = ln.split()
        coefs[i] = float(parts[0])
        row: Dict[int, float] = {}
        for tok in parts[1:]:
            idx_s, _, val_s = tok.partition(":")
            idx = int(idx_s)
            if idx < 1:
                raise ValueError(f"{path}: SV feature index {idx} "
                                 "(LIBSVM indices are 1-based)")
            row[idx] = float(val_s)
            max_idx = max(max_idx, idx)
        feats.append(row)
    d = max(max_idx, n_features or 0)
    if d == 0:
        raise ValueError(f"{path}: SVs carry no features")
    x = np.zeros((len(sv_lines), d), np.float32)
    for i, row in enumerate(feats):
        for idx, val in row.items():
            x[i, idx - 1] = val

    if task == "svc":
        coefs, rho = _svc_label_flip(coefs, rho)
    if task == "oneclass":
        y_sv = np.ones(len(sv_lines), np.int32)
        alpha = coefs.astype(np.float32)
        if (coefs < 0).any():
            raise ValueError(f"{path}: one_class sv_coef must be >= 0")
    else:
        y_sv = np.where(coefs >= 0, 1, -1).astype(np.int32)
        alpha = np.abs(coefs).astype(np.float32)

    gamma = float(header.get("gamma", 1.0 / d))
    return SVMModel(
        x_sv=x, alpha=alpha, y_sv=y_sv, b=rho, gamma=gamma,
        kernel=kernel, coef0=float(header.get("coef0", 0.0)),
        degree=int(header.get("degree", 3)), task=task)
