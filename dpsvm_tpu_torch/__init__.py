"""dpsvm_tpu_torch — the PyTorch/CUDA port of dpsvm_tpu, for NVIDIA Hopper.

The JAX package ``dpsvm_tpu`` is the reference this package is held
against; the port imports neither JAX nor anything of it. This slice
trains binary RBF C-SVC with first-order SMO on one GPU: each iteration's
O(n) work is one pass over X in a hand-written CUDA kernel
(``csrc/fused_step.cu``, built with nvcc at first use). Entry points run
on the GPU unless the caller passes ``device="cpu"``, which runs the plain
PyTorch versions of the kernels.

Public API
----------
``train(X, y, config, device)``    -> TrainResult
``fit(X, y, config, device)``      -> (SVMModel, TrainResult)
``SVMConfig``                      config dataclass (reference flag parity)
``evaluate``                       accuracy of a model on (X, y)
``load_model`` / ``save_model``    reference-compatible model file I/O
"""

from dpsvm_tpu_torch.api import fit, train
from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.models.io import load_model, save_model
from dpsvm_tpu_torch.models.svm import (SVMModel, decision_function,
                                        evaluate, predict)

__all__ = [
    "SVMConfig",
    "TrainResult",
    "SVMModel",
    "train",
    "fit",
    "decision_function",
    "predict",
    "evaluate",
    "save_model",
    "load_model",
]
