"""dpsvm_tpu_torch — the PyTorch/CUDA port of dpsvm_tpu, for NVIDIA Hopper.

The JAX package ``dpsvm_tpu`` is the reference this package is held
against; the port imports neither JAX nor anything of it. It trains
binary C-SVC on one GPU with every LIBSVM kernel kind, along three solver
paths (``api.train`` says which config takes which): the fused
first-order RBF pair, one pass over X an iteration in a hand-written CUDA
kernel (``csrc/fused_step.cu``); the general pair (``solver/smo.py``:
WSS2, class weights, both clips, seeds), chunks of PyTorch calls captured
in a CUDA graph; and the large-working-set decomposition, whose inner
subsolve is a hand-written CUDA kernel (``csrc/subsolve.cu``). The
general pair carries the kernel-row cache (``cache_size > 0``). On top of
the binary trainer: one-vs-one multi-class (``models/multiclass.py``,
sequential per pair or all pairs in one batched program,
``solver/batched_ovo.py``), Platt probabilities
(``models/calibration.py``), k-fold cross-validation (``models/cv.py``)
and the batched C x gamma sweep (``sweep_c``). The task families run on the
same solver paths through their seeding hooks: epsilon-SVR
(``models/svr.py``) and one-class (``models/oneclass.py``) on the general
pair or the decomposition (kernel B), nu-SVC and nu-SVR
(``models/nusvm.py``) on the general pair with LIBSVM's two-constraint
selection; LIBSVM ``.model`` files load and save (``models/libsvm_io.py``),
and ``DPSVMClassifier`` / ``DPSVMRegressor`` wrap it all in the sklearn
protocol. ``SVMConfig(shards=P)`` trains over the P ranks of a
``torch.distributed`` group, one process a device (``parallel/``: the
sharded pair and the sharded decomposition, NCCL between CUDA ranks, gloo
between CPU ranks; ``parallel.multihost.launch_local`` starts local
ranks). ``SVMConfig(solver="approx-rff" | "approx-nystrom")`` trains a
primal linear model over an explicit feature map kept on the GPU
(``approx/``: the million-row path), and ``solver="cascade"`` screens
with it and polishes the kept rows exactly (``solver/cascade.py``).
Kernels build with nvcc at first use. Entry points run on the GPU unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions.

Public API
----------
``train(X, y, config, device)``    -> TrainResult
``fit(X, y, config, device)``      -> (SVMModel, TrainResult); an
                                   ``ApproxSVMModel`` for the approx solvers
``warm_start(X, y, alpha, config, device)`` -> TrainResult
``sweep_c(X, y, cs, config, gammas, device)`` -> [(SVMModel, TrainResult)]
``train_multiclass(X, y, config, ...)`` -> (MulticlassModel, [TrainResult])
``cross_validate(X, y, k, config, ...)`` -> dict (task "svc" or "svr")
``DPSVMClassifier`` / ``DPSVMRegressor``   sklearn-protocol estimators
``train_svr`` / ``predict_svr``    epsilon-SVR (LIBSVM -s 3)
``train_oneclass`` / ``predict_oneclass``  one-class SVM (LIBSVM -s 2)
``train_nusvc`` / ``train_nusvr``  nu-SVM family (LIBSVM -s 1 / -s 4)
``SVMConfig``                      config dataclass (reference flag parity)
``evaluate``                       accuracy of a model on (X, y)
``load_model`` / ``save_model``    reference-compatible model file I/O
                                   (``load_model`` also reads LIBSVM
                                   ``.model`` files)
``load_multiclass`` / ``save_multiclass``  model directories (JAX format)
"""

from dpsvm_tpu_torch.api import fit, sweep_c, train, warm_start
from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.models.cv import cross_validate, cross_validate_c_sweep
from dpsvm_tpu_torch.models.io import load_model, save_model
from dpsvm_tpu_torch.models.multiclass import (MulticlassModel,
                                               evaluate_multiclass,
                                               load_multiclass,
                                               predict_multiclass,
                                               predict_proba_multiclass,
                                               save_multiclass,
                                               train_multiclass)
from dpsvm_tpu_torch.models.nusvm import train_nusvc, train_nusvr
from dpsvm_tpu_torch.models.oneclass import (predict_oneclass,
                                             score_oneclass, train_oneclass)
from dpsvm_tpu_torch.models.svm import (SVMModel, decision_function,
                                        evaluate, predict)
from dpsvm_tpu_torch.models.svr import evaluate_svr, predict_svr, train_svr

__all__ = [
    "SVMConfig",
    "TrainResult",
    "SVMModel",
    "train",
    "fit",
    "warm_start",
    "sweep_c",
    "MulticlassModel",
    "train_multiclass",
    "predict_multiclass",
    "predict_proba_multiclass",
    "evaluate_multiclass",
    "save_multiclass",
    "load_multiclass",
    "cross_validate",
    "cross_validate_c_sweep",
    "decision_function",
    "predict",
    "evaluate",
    "save_model",
    "load_model",
    "DPSVMClassifier",
    "DPSVMRegressor",
    "train_svr",
    "predict_svr",
    "evaluate_svr",
    "train_oneclass",
    "predict_oneclass",
    "score_oneclass",
    "train_nusvc",
    "train_nusvr",
]


def __getattr__(name: str):
    """The estimators load on first use: their module imports sklearn
    when it is installed (~2 s), which a writer process or a CLI call
    should not pay."""
    if name in ("DPSVMClassifier", "DPSVMRegressor"):
        from dpsvm_tpu_torch.models import estimator
        return getattr(estimator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
