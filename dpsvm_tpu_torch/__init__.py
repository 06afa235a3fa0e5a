"""dpsvm_tpu_torch — the PyTorch/CUDA port of dpsvm_tpu, for NVIDIA Hopper.

The JAX package ``dpsvm_tpu`` is the reference this package is held
against; the port imports neither JAX nor anything of it. It trains
binary C-SVC on one GPU with every LIBSVM kernel kind, along three solver
paths (``api.train`` says which config takes which): the fused
first-order RBF pair, one pass over X an iteration in a hand-written CUDA
kernel (``csrc/fused_step.cu``); the general pair (``solver/smo.py``:
WSS2, class weights, both clips, seeds), chunks of PyTorch calls captured
in a CUDA graph; and the large-working-set decomposition, whose inner
subsolve is a hand-written CUDA kernel (``csrc/subsolve.cu``). Kernels
build with nvcc at first use. Entry points run on the GPU unless the
caller passes ``device="cpu"``, which runs the plain PyTorch versions.

Public API
----------
``train(X, y, config, device)``    -> TrainResult
``fit(X, y, config, device)``      -> (SVMModel, TrainResult)
``warm_start(X, y, alpha, config, device)`` -> TrainResult
``SVMConfig``                      config dataclass (reference flag parity)
``evaluate``                       accuracy of a model on (X, y)
``load_model`` / ``save_model``    reference-compatible model file I/O
"""

from dpsvm_tpu_torch.api import fit, train, warm_start
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
    "warm_start",
    "decision_function",
    "predict",
    "evaluate",
    "save_model",
    "load_model",
]
