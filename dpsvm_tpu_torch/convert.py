"""Carry state across from the JAX package, as numpy arrays.

The two packages share no objects; what crosses is plain arrays:

* ``model_from_numpy`` turns a model's fields (as read off a JAX
  ``SVMModel``, its ``task`` included) into the port's ``SVMModel``;
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
