"""Model objects and serialization."""

from dpsvm_tpu_torch.models.svm import (SVMModel, decision_function,
                                        evaluate, predict)
from dpsvm_tpu_torch.models.io import load_model, save_model
from dpsvm_tpu_torch.models.calibration import (fit_platt, load_platt,
                                                predict_proba, save_platt)

__all__ = [
    "SVMModel",
    "decision_function",
    "predict",
    "evaluate",
    "save_model",
    "load_model",
    "fit_platt",
    "predict_proba",
    "save_platt",
    "load_platt",
]
