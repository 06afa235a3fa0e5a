"""Model-file serialization, reference-compatible (port of
``dpsvm_tpu/models/io.py`` for RBF models, numpy only).

Format (the MPI trainer's, ``svmTrainMain.cpp:386-416``):

    line 1:  gamma
    line 2:  b
    line 3+: alpha,y,x1,...,xd        (one line per SV, alpha > 0)

The reader also accepts the layout without the b line (``seq.cpp:302``),
by sniffing whether line 2 is a lone scalar. Files written by either
package load in the other to identical arrays: every float is written
with 9 significant digits, which round-trips float32 exactly. The JAX
package's extended layouts (``kernel ...`` headers for other kernels,
regression, LIBSVM ``.model`` files, approx ``.npz`` models) are not
ported yet and raise.
"""

from __future__ import annotations

import os

import numpy as np

from dpsvm_tpu_torch.models.svm import SVMModel


def save_model(model: SVMModel, path: str) -> int:
    """Write the model file; returns the number of SV lines written."""
    if model.kernel != "rbf":
        raise NotImplementedError(
            f"kernel {model.kernel!r} model files are not ported to "
            "dpsvm_tpu_torch yet")
    alpha = np.ascontiguousarray(model.alpha, np.float32)
    y = np.ascontiguousarray(model.y_sv, np.int32)
    x = np.ascontiguousarray(model.x_sv, np.float32)
    keep = alpha > 0
    with open(path, "w") as f:
        f.write(f"{model.gamma:.9g}\n{model.b:.9g}\n")
        for a, lab, row in zip(alpha[keep], y[keep], x[keep]):
            f.write(f"{a:.9g},{int(lab)},"
                    + ",".join(f"{v:.9g}" for v in row.tolist()) + "\n")
    return int(keep.sum())


def load_model(path: str) -> SVMModel:
    """Read a reference-layout RBF model file (with or without b)."""
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
    if lines[0].startswith(("kernel ", "svm_type")):
        raise NotImplementedError(
            f"{path}: only the reference RBF layout is ported to "
            f"dpsvm_tpu_torch yet (first line {lines[0][:40]!r})")
    gamma = float(lines[0])
    has_b = "," not in lines[1]
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
    return SVMModel(x_sv=x, alpha=alpha, y_sv=y, b=b, gamma=gamma)
