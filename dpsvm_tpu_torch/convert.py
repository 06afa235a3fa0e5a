"""Carry state across from the JAX package, as numpy arrays.

The two packages share no objects; what crosses is plain arrays:

* ``model_from_numpy`` turns a model's fields (as read off a JAX
  ``SVMModel``, its ``task`` included) into the port's ``SVMModel``;
* ``approx_model_from_numpy`` does the same for a JAX ``ApproxSVMModel``:
  the feature map's arrays (omega, or landmarks and proj) and scalars, w
  and b;
* ``carry_from_numpy`` rebuilds the fused carry from solver state
  (alpha, f), the way ``init_fused_carry`` does on resume: the working set
  is a pure function of (alpha, f);
* ``decomp_carry_from_numpy`` turns the fields of a JAX ``DecompCarry``
  into the port's, so a decomposition run handed over mid-way goes on
  along the same trajectory;
* ``smo_carry_from_numpy`` does the same for a JAX ``SMOCarry`` of the
  general pair (``solver.smo.train_single_device(..., carry=)``), a
  nu-selection run included: its stopping slots (0, max gap) carry over
  as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.experimental.fused import init_fused_carry
from dpsvm_tpu_torch.experimental.fused_step import FusedCarry
from dpsvm_tpu_torch.models.svm import SVMModel
from dpsvm_tpu_torch.solver.decomp import DecompCarry
from dpsvm_tpu_torch.solver.smo import SMOCarry, init_carry


def model_from_numpy(x_sv, alpha, y_sv, b, gamma, kernel: str = "rbf",
                     coef0: float = 0.0, degree: int = 3, sv_idx=None,
                     n_train=None, n_train_exact: bool = True,
                     task: str = "svc") -> SVMModel:
    if task not in ("svc", "svr", "oneclass"):
        raise ValueError(f"unknown task {task!r}")
    return SVMModel(x_sv=np.ascontiguousarray(x_sv, np.float32),
                    alpha=np.asarray(alpha, np.float32).reshape(-1),
                    y_sv=np.asarray(y_sv, np.int32).reshape(-1),
                    b=float(b), gamma=float(gamma), kernel=str(kernel),
                    coef0=float(coef0), degree=int(degree),
                    task=str(task), sv_idx=(None if sv_idx is None
                            else np.asarray(sv_idx, np.int64).reshape(-1)),
                    n_train=None if n_train is None else int(n_train),
                    n_train_exact=bool(n_train_exact))


def approx_model_from_numpy(kind: str, d: int, dim: int, seed: int,
                            gamma: float, w, b, task: str = "svc",
                            kernel: str = "rbf", coef0: float = 0.0,
                            degree: int = 3, omega=None, landmarks=None,
                            proj=None):
    """The port's ``ApproxSVMModel`` from a JAX one's fields (``fmap.kind``,
    ``fmap.d``, ``fmap.dim``, ``fmap.seed``, ``fmap.gamma``, ``w``, ``b``,
    ``task``, and the map's arrays). An RFF map without ``omega`` draws it
    again from the seed (``rff_omega``: the same bits)."""
    from dpsvm_tpu_torch.approx.features import FeatureMap, rff_omega
    from dpsvm_tpu_torch.approx.model import ApproxSVMModel
    if task not in ("svc", "svr"):
        raise ValueError(f"unknown approx task {task!r}")
    if kind == "rff":
        om = (rff_omega(int(d), int(dim), float(gamma), int(seed))
              if omega is None else np.asarray(omega, np.float32))
        if om.shape != (int(d), int(dim) // 2):
            raise ValueError(f"omega must be ({d}, {int(dim) // 2}), got "
                             f"{om.shape}")
        fmap = FeatureMap(kind="rff", d=int(d), dim=int(dim),
                          seed=int(seed), gamma=float(gamma),
                          omega=np.ascontiguousarray(om))
    elif kind == "nystrom":
        lm = np.ascontiguousarray(landmarks, np.float32)
        pj = np.ascontiguousarray(proj, np.float32)
        if lm.ndim != 2 or lm.shape[1] != int(d) or pj.shape != (
                lm.shape[0], int(dim)):
            raise ValueError(f"landmarks {lm.shape} / proj {pj.shape} do "
                             f"not fit d={d}, dim={dim}")
        fmap = FeatureMap(kind="nystrom", d=int(d), dim=int(dim),
                          seed=int(seed), gamma=float(gamma),
                          kernel=str(kernel), coef0=float(coef0),
                          degree=int(degree), landmarks=lm, proj=pj)
    else:
        raise ValueError(f"unknown feature map kind {kind!r}")
    w = np.asarray(w, np.float32).reshape(-1)
    if w.shape != (int(dim),):
        raise ValueError(f"w must be ({dim},), got {w.shape}")
    return ApproxSVMModel(fmap=fmap, w=w.copy(), b=float(b), task=str(task))


def carry_from_numpy(alpha, f, y, c: float, n_iter: int = 0,
                     device=None) -> FusedCarry:
    """The fused carry for state (alpha, f) of labels y, on ``device``
    (None means the GPU, as every entry point of the port). The carry owns
    copies: the solver updates alpha and f in place."""
    dev = resolve_device(device)

    def vec(v):
        return torch.tensor(np.asarray(v, np.float32).reshape(-1),
                            device=dev)

    return init_fused_carry(vec(alpha), vec(f), vec(y), float(c),
                            n_iter=n_iter)


def decomp_carry_from_numpy(alpha, f, y, b_hi, b_lo, n_iter, rounds,
                            device=None) -> DecompCarry:
    """The port's decomposition carry from a JAX ``DecompCarry``'s fields
    as numpy values, on ``device`` (None means the GPU). ``y`` gives the
    problem's size, which alpha and f must have. The carry owns copies:
    the solver updates alpha and f in place."""
    dev = resolve_device(device)
    n = np.asarray(y).reshape(-1).shape[0]

    def vec(v):
        v = np.asarray(v, np.float32).reshape(-1)
        if v.shape != (n,):
            raise ValueError(f"alpha and f must have {n} entries, got "
                             f"{v.shape[0]}")
        return torch.tensor(v, device=dev)

    def scalar(v, dtype):
        return torch.tensor(np.asarray(v, dtype).reshape(()), device=dev)

    return DecompCarry(alpha=vec(alpha), f=vec(f),
                       b_hi=scalar(b_hi, np.float32),
                       b_lo=scalar(b_lo, np.float32),
                       n_iter=scalar(n_iter, np.int32),
                       rounds=scalar(rounds, np.int32))


def smo_carry_from_numpy(alpha, f, y, b_hi, b_lo, n_iter,
                         device=None) -> SMOCarry:
    """The port's general-pair carry from a JAX ``SMOCarry``'s fields as
    numpy values (its row cache is not carried: the port has none), on
    ``device`` (None means the GPU). ``y`` gives the problem's size. The
    carry owns copies: the solver updates alpha and f in place."""
    dev = resolve_device(device)
    yd = torch.tensor(np.asarray(y, np.float32).reshape(-1), device=dev)
    n = yd.shape[0]
    for v in (alpha, f):
        if np.asarray(v).reshape(-1).shape != (n,):
            raise ValueError(f"alpha and f must have {n} entries, got "
                             f"{np.asarray(v).size}")
    return init_carry(yd, f_init=f, alpha_init=alpha,
                      b_hi=np.asarray(b_hi, np.float32).item(),
                      b_lo=np.asarray(b_lo, np.float32).item(),
                      n_iter=int(np.asarray(n_iter)))
