"""Solver configuration and result types for the PyTorch/CUDA port.

A copy of the fields of ``dpsvm_tpu.config.SVMConfig`` that training and
testing read, with the same names, defaults and validation messages. The
port keeps its own copy: it never imports the JAX package.

What this slice trains is the envelope ``fused_incompatibility`` accepts:
binary C-SVC, RBF kernel, first-order (Keerthi) selection, the reference's
independent clip, one device, no class weights, no row cache. ``api.train``
raises with that method's message for any other config.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Sentinel used by the reference for masked I-set scores
# (svmTrain.cu:59,66 use +/-1e9); kept identical for parity.
SENTINEL = 1.0e9

_PRECISIONS = ("highest", "high", "default")


@dataclasses.dataclass(frozen=True)
class SVMConfig:
    """Hyperparameters + execution options for the SMO solver."""

    # --- algorithm (reference-parity) ---
    c: float = 1.0                      # box constraint C
    gamma: Optional[float] = None       # kernel gamma; None => 1.0 / d
    kernel: str = "rbf"                 # only "rbf" is ported
    epsilon: float = 0.001              # convergence tolerance
    max_iter: int = 150_000             # iteration cap
    cache_size: int = 0                 # kernel-row cache lines (0 = off)
    weight_pos: float = 1.0             # class-weighted costs (not ported:
    weight_neg: float = 1.0             # both must stay 1.0)
    selection: str = "first-order"      # working-set rule
    working_set: int = 2                # 2 = the reference's SMO pair
    clip: str = "independent"           # the reference's alpha clip

    # --- execution ---
    shards: int = 1                     # devices along the data axis
    chunk_iters: int = 512              # host polls convergence every chunk
    matmul_precision: str = "highest"   # "highest"/"high": X stored f32;
                                        # "default": X stored bf16 (half
                                        # the bytes of the per-iteration
                                        # pass); accumulation is f32 always
    verbose: bool = False
    log_every: int = 0                  # 0 = no per-chunk logging
    wall_budget_s: float = 0.0          # stop dispatching chunks after this
                                        # much wall-clock (0 = no budget)

    def fused_incompatibility(self) -> Optional[str]:
        """Why the fused iteration cannot run this config (None if it can).
        The port's ``train`` raises with this message: every other solver
        path is still to be ported."""
        if self.shards > 1:
            return "shards > 1"
        if self.kernel != "rbf":
            return f"kernel {self.kernel!r} (RBF only)"
        if self.clip != "independent":
            return f"clip {self.clip!r} (reference clip only)"
        if self.cache_size > 0:
            return "the kernel-row cache (cache_size > 0)"
        if self.selection != "first-order":
            return f"selection {self.selection!r}"
        if self.working_set != 2:
            return "working_set > 2 (decomposition)"
        if self.weight_pos != 1.0 or self.weight_neg != 1.0:
            return "class-weighted costs"
        return None

    def resolve_gamma(self, num_attributes: int) -> float:
        if self.gamma is not None:
            return float(self.gamma)
        return 1.0 / float(num_attributes)

    def validate(self) -> None:
        if self.c <= 0:
            raise ValueError(f"cost must be > 0, got {self.c}")
        if self.epsilon <= 0:
            raise ValueError(f"epsilon must be > 0, got {self.epsilon}")
        if self.max_iter <= 0:
            raise ValueError(f"max_iter must be > 0, got {self.max_iter}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.cache_size < 0:
            raise ValueError(f"cache_size must be >= 0, got {self.cache_size}")
        if self.chunk_iters <= 0:
            raise ValueError(
                f"chunk_iters must be > 0, got {self.chunk_iters}")
        if self.wall_budget_s < 0:
            raise ValueError(
                f"wall_budget_s must be >= 0, got {self.wall_budget_s}")
        if not (math.isfinite(self.weight_pos) and self.weight_pos > 0
                and math.isfinite(self.weight_neg)
                and self.weight_neg > 0):
            raise ValueError("class weights must be > 0 and finite, got "
                             f"({self.weight_pos}, {self.weight_neg})")
        if self.clip not in ("independent", "pairwise"):
            raise ValueError(f"clip must be 'independent' or 'pairwise', "
                             f"got {self.clip!r}")
        if self.kernel not in ("linear", "poly", "rbf", "sigmoid",
                               "precomputed"):
            raise ValueError(f"kernel must be 'linear', 'poly', 'rbf', "
                             f"'sigmoid' or 'precomputed', got "
                             f"{self.kernel!r}")
        if self.selection not in ("first-order", "second-order"):
            raise ValueError(f"selection must be 'first-order' or "
                             f"'second-order', got {self.selection!r}")
        if self.working_set not in (0, 2) and (
                self.working_set < 4 or self.working_set % 2
                or self.working_set > 16384):
            raise ValueError("working_set must be 0 (auto), 2 "
                             "(classic SMO pair) or an even value "
                             f"in [4, 16384], got {self.working_set}")
        if self.matmul_precision not in _PRECISIONS:
            raise ValueError(f"matmul_precision must be one of "
                             f"{_PRECISIONS}, got {self.matmul_precision!r}")


@dataclasses.dataclass
class TrainResult:
    """Outcome of a training run (``svmTrainMain.cpp:313-348``): intercept
    b, iteration count, convergence status, wall time, plus the solver
    state needed to build a model (alpha) and the final optimality gap."""

    alpha: "object"                     # (n,) float array
    b: float
    n_iter: int
    converged: bool
    b_lo: float
    b_hi: float
    train_seconds: float
    gamma: float
    n_sv: int
    kernel: str = "rbf"
    coef0: float = 0.0
    degree: int = 3

    @property
    def gap(self) -> float:
        return self.b_lo - self.b_hi
