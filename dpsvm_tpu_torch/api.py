"""Library entry points (port of ``dpsvm_tpu/api.py``): ``train`` and
``fit`` for the exact solver on one device, through the fused iteration.

Both run on the card unless the caller passes ``device="cpu"``. Every
solver path beside the fused first-order SMO raises: it is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.models.svm import SVMModel

Device = Optional[Union[str, torch.device]]


def _check_xy(x, y):
    """The cheap shape/label validation of the JAX ``_check_xy``."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {x.shape}")
    if y.shape != (x.shape[0],):
        raise ValueError(f"y must be ({x.shape[0]},), got {y.shape}")
    labels = np.unique(y)
    if not np.all(np.isin(labels, (-1, 1))):
        raise ValueError(
            f"labels must be +/-1 for binary training, got {labels[:10]} — "
            "multi-class training is not ported to dpsvm_tpu_torch yet")
    return x, y


def train(x: np.ndarray, y: np.ndarray,
          config: Optional[SVMConfig] = None,
          device: Device = None) -> TrainResult:
    """Train a binary RBF SVM with the modified-SMO solver.

    x: (n, d) float features; y: (n,) labels in {+1, -1}. ``device``
    None means the GPU; ``"cpu"`` runs the plain PyTorch path."""
    config = config or SVMConfig()
    config.validate()
    if config.working_set == 0:
        # The JAX auto plan resolves to the classic pair at every shape.
        config = dataclasses.replace(config, working_set=2)
    why = config.fused_incompatibility()
    if why is not None:
        raise NotImplementedError(
            f"dpsvm_tpu_torch does not support {why} yet: only the fused "
            "first-order SMO path (binary RBF, independent clip, one "
            "device, unweighted, no row cache) is ported")
    dev = resolve_device(device)
    x, y = _check_xy(x, y)
    from dpsvm_tpu_torch.experimental.fused import train_single_device_fused
    return train_single_device_fused(x, y, config, dev)


def fit(x: np.ndarray, y: np.ndarray, config: Optional[SVMConfig] = None,
        device: Device = None) -> Tuple[SVMModel, TrainResult]:
    """train + SV compaction in one call."""
    result = train(x, y, config, device=device)
    return SVMModel.from_train_result(x, y, result), result
