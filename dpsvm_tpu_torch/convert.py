"""Carry state across from the JAX package, as numpy arrays.

The two packages share no objects; what crosses is plain arrays:

* ``model_from_numpy`` turns a model's fields (as read off a JAX
  ``SVMModel``) into the port's ``SVMModel``;
* ``carry_from_numpy`` rebuilds the fused carry from solver state
  (alpha, f), the way ``init_fused_carry`` does on resume: the working set
  is a pure function of (alpha, f).
"""

from __future__ import annotations

import numpy as np
import torch

from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.experimental.fused import init_fused_carry
from dpsvm_tpu_torch.experimental.fused_step import FusedCarry
from dpsvm_tpu_torch.models.svm import SVMModel


def model_from_numpy(x_sv, alpha, y_sv, b, gamma) -> SVMModel:
    return SVMModel(x_sv=np.ascontiguousarray(x_sv, np.float32),
                    alpha=np.asarray(alpha, np.float32).reshape(-1),
                    y_sv=np.asarray(y_sv, np.int32).reshape(-1),
                    b=float(b), gamma=float(gamma))


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
