"""Approx-model representation, decision math and persistence (port of
``dpsvm_tpu/approx/model.py``).

An approx model has no support vectors: it is a feature map plus one
(D,) primal weight vector and an intercept. Its decision keeps the SV
models' sign convention, ``decision = phi(x).w - b``, so Platt sidecars,
``--no-b`` and one-vs-one work unchanged on either model kind.

Persistence is one ``.npz`` in the JAX package's layout and format
marker, so a file written by either package loads in the other:
``models/io.save_model`` / ``load_model`` dispatch on the zip magic. RFF
maps persist only (seed, dims, gamma), and the frequency matrix is drawn
again on load, bit for bit; Nystrom persists its landmarks and whitening
projection.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from dpsvm_tpu_torch.approx.features import (CHUNK, FeatureMap, device_map,
                                             rff_omega)
from dpsvm_tpu_torch.ops.kernels import exact_f32

_FORMAT = "dpsvm-approx-v1"


@dataclasses.dataclass
class ApproxSVMModel:
    """Feature map + primal weights (see module docstring)."""

    fmap: FeatureMap
    w: np.ndarray                 # (fmap.dim,) f32 feature weights
    b: float                      # decision = phi.w - b (SV convention)
    task: str = "svc"             # "svc" | "svr"

    # Duck-typed marker the dispatch sites read (models/svm.py,
    # models/io.py, models/multiclass.py).
    is_approx: bool = dataclasses.field(default=True, init=False,
                                        repr=False)

    @property
    def model_kind(self) -> str:
        return f"approx-{self.fmap.kind}"

    @property
    def kernel(self) -> str:
        return self.fmap.kernel

    @property
    def gamma(self) -> float:
        return float(self.fmap.gamma)

    @property
    def coef0(self) -> float:
        return float(self.fmap.coef0)

    @property
    def degree(self) -> int:
        return int(self.fmap.degree)

    @property
    def num_attributes(self) -> int:
        return int(self.fmap.d)

    @property
    def n_sv(self) -> int:
        # No SV set exists; 0 keeps n_sv-printing surfaces truthful.
        return 0


def decision_function(model: ApproxSVMModel, x_test: np.ndarray,
                      include_b: bool = True,
                      batch_size: Optional[int] = CHUNK,
                      device=None) -> np.ndarray:
    """phi(t_i).w [- b], featurized and reduced on the device in blocks of
    ``batch_size`` rows, float32 with TF32 off."""
    x_test = np.asarray(x_test, np.float32)
    if x_test.ndim == 1:
        x_test = x_test[None, :]
    if x_test.shape[1] != model.num_attributes:
        raise ValueError(
            f"approx evaluation needs {model.num_attributes} "
            f"attributes, got {x_test.shape[1]}")
    dm = device_map(model.fmap, device)
    w = torch.from_numpy(np.asarray(model.w, np.float32)).to(dm.device)
    b = torch.tensor(np.float32(model.b), device=dm.device)
    m = x_test.shape[0]
    step = m if batch_size is None else max(1, int(batch_size))
    out = np.empty((m,), np.float32)
    with exact_f32():
        for lo in range(0, m, step):
            hi = min(lo + step, m)
            phi = dm.block(torch.from_numpy(
                np.ascontiguousarray(x_test[lo:hi])).to(dm.device))
            dual = torch.matmul(phi, w)
            if include_b:
                dual = dual - b
            out[lo:hi] = dual.cpu().numpy()
    return out


def predict(model: ApproxSVMModel, x_test: np.ndarray,
            include_b: bool = True, device=None) -> np.ndarray:
    dec = decision_function(model, x_test, include_b=include_b,
                            device=device)
    if model.task == "svr":
        return dec
    return np.where(dec < 0, -1, 1).astype(np.int32)


def save_approx_model(model: ApproxSVMModel, path: str) -> int:
    """Write the one-file .npz; returns 0 (no SV lines exist)."""
    fmap = model.fmap
    arrays = dict(
        format=np.str_(_FORMAT),
        task=np.str_(model.task),
        kind=np.str_(fmap.kind),
        kernel=np.str_(fmap.kernel),
        w=np.asarray(model.w, np.float32),
        b=np.float64(model.b),
        gamma=np.float64(fmap.gamma),
        coef0=np.float64(fmap.coef0),
        degree=np.int64(fmap.degree),
        seed=np.int64(fmap.seed),
        dim=np.int64(fmap.dim),
        d=np.int64(fmap.d),
    )
    if fmap.kind == "nystrom":
        arrays["landmarks"] = np.asarray(fmap.landmarks, np.float32)
        arrays["proj"] = np.asarray(fmap.proj, np.float32)
    # tmp + rename: a crash mid-save never leaves a half-written model.
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return 0


def load_approx_model(path: str) -> ApproxSVMModel:
    with np.load(path, allow_pickle=False) as z:
        if "format" not in z.files or str(z["format"]) != _FORMAT:
            raise ValueError(f"{path}: not a dpsvm approx model "
                             "(missing/unknown format marker)")
        kind = str(z["kind"])
        d, dim, seed = int(z["d"]), int(z["dim"]), int(z["seed"])
        gamma = float(z["gamma"])
        if kind == "rff":
            fmap = FeatureMap(kind="rff", d=d, dim=dim, seed=seed,
                              gamma=gamma,
                              omega=rff_omega(d, dim, gamma, seed))
        else:
            fmap = FeatureMap(kind="nystrom", d=d, dim=dim, seed=seed,
                              gamma=gamma, kernel=str(z["kernel"]),
                              coef0=float(z["coef0"]),
                              degree=int(z["degree"]),
                              landmarks=np.asarray(z["landmarks"],
                                                   np.float32),
                              proj=np.asarray(z["proj"], np.float32))
        w = np.asarray(z["w"], np.float32)
        if w.shape != (fmap.dim,):
            raise ValueError(f"{path}: weight vector {w.shape} does not "
                             f"match feature dim {fmap.dim}")
        return ApproxSVMModel(fmap=fmap, w=w, b=float(z["b"]),
                              task=str(z["task"]))


def is_approx_model_file(path: str) -> bool:
    """Approx models are .npz (zip) files; no text model format (reference
    or LIBSVM) can start with the zip magic."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"PK\x03\x04"
    except OSError:
        return False
