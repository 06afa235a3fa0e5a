"""Model-file serialization, reference-compatible (port of
``dpsvm_tpu/models/io.py`` for binary C-SVC models, numpy only).

Format (the MPI trainer's, ``svmTrainMain.cpp:386-416``):

    line 1:  gamma
    line 2:  b
    line 3+: alpha,y,x1,...,xd        (one line per SV, alpha > 0)

The reader also accepts the layout without the b line (``seq.cpp:302``),
by sniffing whether line 2 is a lone scalar. Models of the other kernels
open with a self-describing line instead of the bare gamma,

    kernel <kind> <gamma> <coef0> <degree>

and a precomputed-kernel model then carries its SV indices into the
training set (and the width K(test, train) must have; a '+' suffix marks
a lower bound) on the line ``svidx <n_train>[+] <i> <j> ...``, before b;
its SV lines are ``alpha,y``. RBF models keep the reference layout. Files
written by either package load in the other to identical arrays, and
write back byte for byte: every float is written with 9 significant
digits, which round-trips float32 exactly. The JAX package's other
layouts (regression and one-class ``task`` lines, LIBSVM ``.model``
files, approx ``.npz`` models) are not ported yet and raise.
"""

from __future__ import annotations

import os

import numpy as np

from dpsvm_tpu_torch.models.svm import SVMModel


def save_model(model: SVMModel, path: str) -> int:
    """Write the model file; returns the number of SV lines written."""
    alpha = np.ascontiguousarray(model.alpha, np.float32)
    y = np.ascontiguousarray(model.y_sv, np.int32)
    x = np.ascontiguousarray(model.x_sv, np.float32)
    precomputed = model.kernel == "precomputed"
    # Every stored row of a precomputed model aligns with svidx: none is
    # skipped.
    keep = np.ones_like(alpha, bool) if precomputed else alpha > 0
    with open(path, "w") as f:
        if model.kernel == "rbf":
            f.write(f"{model.gamma:.9g}\n")
        else:
            f.write(f"kernel {model.kernel} {model.gamma:.9g} "
                    f"{model.coef0:.9g} {int(model.degree)}\n")
        if precomputed:
            idx = " ".join(str(int(i)) for i in model.sv_idx)
            lb = "" if model.n_train_exact else "+"
            f.write(f"svidx {int(model.n_train)}{lb} {idx}\n")
        f.write(f"{model.b:.9g}\n")
        # one %-format a line: the same text as f"{v:.9g}" per value
        line = "%.9g,%d" + ",%.9g" * x.shape[1] + "\n"
        for a, lab, row in zip(alpha[keep].tolist(), y[keep].tolist(),
                               x[keep].tolist()):
            f.write(line % (a, lab, *row))
    return int(keep.sum())


def load_model(path: str) -> SVMModel:
    """Read a model file: the reference layout (with or without b), or
    the ``kernel ...`` header of the other kernels."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        if f.read(4) == b"PK\x03\x04":
            raise NotImplementedError(
                f"{path}: approx (.npz) models are not ported to "
                "dpsvm_tpu_torch yet")
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if len(lines) < 2:
        raise ValueError(f"{path}: not a model file (needs gamma + SVs)")
    if lines[0].startswith("svm_type"):
        raise NotImplementedError(
            f"{path}: LIBSVM .model files are not ported to "
            "dpsvm_tpu_torch yet")
    kernel, coef0, degree = "rbf", 0.0, 3
    if lines[0].startswith("kernel "):
        parts = lines[0].split()
        if len(parts) != 5:
            raise ValueError(f"{path}: bad kernel header {lines[0]!r} "
                             "(want: kernel <kind> <gamma> <coef0> <degree>)")
        kernel, gamma, coef0, degree = (parts[1], float(parts[2]),
                                        float(parts[3]), int(parts[4]))
    else:
        gamma = float(lines[0])
    if lines[1].startswith("task "):
        raise NotImplementedError(
            f"{path}: {lines[1].split()[-1]!r} models are not ported to "
            "dpsvm_tpu_torch yet (binary C-SVC only)")
    sv_idx, n_train, n_train_exact = None, None, True
    if lines[1].startswith("svidx "):
        if kernel != "precomputed":
            raise ValueError(f"{path}: svidx line is precomputed-kernel "
                             "only")
        parts = lines[1].split()
        n_train_exact = not parts[1].endswith("+")
        n_train = int(parts[1].rstrip("+"))
        sv_idx = np.asarray(parts[2:], dtype=np.int64)
        lines = [lines[0]] + lines[2:]
    elif kernel == "precomputed":
        raise ValueError(f"{path}: precomputed-kernel model is missing "
                         "its svidx line")
    has_b = len(lines) > 1 and "," not in lines[1]
    b = float(lines[1]) if has_b else 0.0
    sv_lines = lines[2:] if has_b else lines[1:]
    if not sv_lines:
        raise ValueError(f"{path}: model has no support vectors")
    n_sv = len(sv_lines)
    d = sv_lines[0].count(",") - 1
    alpha = np.empty((n_sv,), np.float32)
    y = np.empty((n_sv,), np.int32)
    x = np.empty((n_sv, d), np.float32)
    for i, ln in enumerate(sv_lines):
        parts = ln.split(",")
        if len(parts) != d + 2:
            raise ValueError(f"{path}: SV line {i} has {len(parts)} fields, "
                             f"expected {d + 2}")
        alpha[i] = float(parts[0])
        y[i] = int(float(parts[1]))
        x[i] = np.asarray(parts[2:], dtype=np.float32)
    if sv_idx is not None and len(sv_idx) != n_sv:
        raise ValueError(f"{path}: svidx lists {len(sv_idx)} indices "
                         f"but there are {n_sv} SV lines")
    return SVMModel(x_sv=x, alpha=alpha, y_sv=y, b=b, gamma=gamma,
                    kernel=kernel, coef0=coef0, degree=degree,
                    sv_idx=sv_idx, n_train=n_train,
                    n_train_exact=n_train_exact)
