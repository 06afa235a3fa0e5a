"""Library entry points (port of ``dpsvm_tpu/api.py``): ``train``, ``fit``,
``warm_start`` and ``sweep_c`` for the exact solver, on one device or over
the ranks of a process group. ``fit`` also dispatches on
``config.solver``: the approx solvers (``approx/primal.py``) and the
cascade (``solver/cascade.py``); the other three refuse them, with the
JAX package's messages.

``train`` routes as the JAX package does (``api.py:114-147`` there):

* ``shards > 1`` (or a ``group`` given): the distributed trainers over the
  ranks of a ``torch.distributed`` group, one process a device, every
  rank calling ``train`` with the same full (x, y):
  ``parallel/dist_decomp.py`` for ``working_set > 2`` (kernel B on every
  rank), else ``parallel/dist_smo.py``. Without an initialized group it
  raises, naming the ways to start one (the CLI's ``--shards``,
  ``parallel.multihost.launch_local``, ``torchrun``,
  ``multihost.initialize``);
* ``working_set > 2``: the large-working-set decomposition
  (``solver/decomp.py``, kernel B for the inner subsolve);
* a config within ``SVMConfig.fused_incompatibility`` with no
  ``f_init``/``alpha_init`` seed and no ``guard_eta``: the fused pair
  (``experimental/fused.py``, kernel A, one launch an iteration);
* every other ``working_set == 2`` config: the general pair
  (``solver/smo.py``), which also carries the kernel-row cache.

Before the path choice, ``train`` resolves the "auto" sentinels
(``SVMConfig.resolved``) and sends ``shrinking=True`` to the active-set
manager (``solver/shrink.py``), which wraps the general pair or the
decomposition, on one device or over the ranks, as
``dpsvm_tpu/api.py:117-124`` does. scipy.sparse input
is densified first. ``train`` is binary; multi-class labels go to
``models/multiclass.train_multiclass``. ``sweep_c`` fits one binary
problem at every point of a C (x gamma) grid in one batched program
(``solver/batched_ovo.py``). All of them run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.models.svm import SVMModel
from dpsvm_tpu_torch.utils import densify
from dpsvm_tpu_torch.utils.timing import span

Device = Optional[Union[str, torch.device]]


def _check_xy(x, y):
    """The cheap shape/label validation of the JAX ``_check_xy`` (train
    and warm_start run it before any kernel work)."""
    x = np.asarray(densify(x), np.float32)
    y = np.asarray(y)
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {x.shape}")
    if y.shape != (x.shape[0],):
        raise ValueError(f"y must be ({x.shape[0]},), got {y.shape}")
    labels = np.unique(y)
    if not np.all(np.isin(labels, (-1, 1))):
        raise ValueError(
            f"labels must be +/-1 for binary training, got {labels[:10]} — "
            "for multi-class data use models.multiclass.train_multiclass "
            "(CLI: train --multiclass)")
    return x, y


def train(x: np.ndarray, y: np.ndarray,
          config: Optional[SVMConfig] = None,
          device: Device = None,
          f_init: Optional[np.ndarray] = None,
          alpha_init: Optional[np.ndarray] = None,
          guard_eta: bool = False, group=None) -> TrainResult:
    """Train a binary SVM with the modified-SMO solver.

    x: (n, d) float features (the (n, n) kernel matrix for
    ``kernel="precomputed"``); y: (n,) labels in {+1, -1}. ``device`` None
    means the GPU; ``"cpu"`` runs the plain PyTorch path. ``f_init`` /
    ``alpha_init`` override f = -y, alpha = 0 (``warm_start``'s hook).
    ``guard_eta`` clamps the first-order update's denominator to LIBSVM's
    TAU (1e-12); off, plain classification keeps the reference's raw
    division (svmTrainMain.cpp:289). ``group``: the process group of a
    distributed run (default: the world group when ``config.shards > 1``);
    given, it overrides ``config.shards``. The device of a distributed
    rank defaults to its CUDA device under NCCL."""
    config = config or SVMConfig()
    config.validate()
    if config.solver != "exact":
        raise ValueError(
            "approx solvers have no dual alpha vector to return, and "
            "the cascade is a multi-stage schedule — train through "
            "api.fit (which returns the right model kind), or "
            "approx.fit_approx / solver.cascade.fit_cascade directly")
    with span("fit.check"):
        x, y = _check_xy(x, y)
    config = config.resolved(x.shape[0], x.shape[1])
    if config.kernel == "precomputed" and x.shape[0] != x.shape[1]:
        raise ValueError("precomputed kernel training needs the square "
                         f"(n, n) kernel matrix as x, got {x.shape}")
    if config.polish:
        return _polish(x, y, config, device, f_init, alpha_init, guard_eta)
    dist = config.shards > 1 or group is not None
    if config.shrinking:
        from dpsvm_tpu_torch.solver.shrink import train_shrinking
        return train_shrinking(x, y, config,
                               device if dist else resolve_device(device),
                               f_init=f_init, alpha_init=alpha_init,
                               guard_eta=guard_eta, group=group)
    if dist:
        if config.working_set > 2:
            from dpsvm_tpu_torch.parallel.dist_decomp import (
                train_distributed_decomp)
            return train_distributed_decomp(
                x, y, config, group=group, f_init=f_init,
                alpha_init=alpha_init, device=device)
        from dpsvm_tpu_torch.parallel.dist_smo import train_distributed
        return train_distributed(x, y, config, group=group, f_init=f_init,
                                 alpha_init=alpha_init, guard_eta=guard_eta,
                                 device=device)
    if config.working_set > 2:
        dev = resolve_device(device)
        from dpsvm_tpu_torch.solver.decomp import train_single_device_decomp
        return train_single_device_decomp(x, y, config, dev, f_init=f_init,
                                          alpha_init=alpha_init)
    if (f_init is None and alpha_init is None and not guard_eta
            and config.fused_incompatibility() is None):
        # the fused kernel hard-codes the classification init and the
        # reference's raw division
        dev = resolve_device(device)
        from dpsvm_tpu_torch.experimental.fused import (
            train_single_device_fused)
        return train_single_device_fused(x, y, config, dev)
    dev = resolve_device(device)
    from dpsvm_tpu_torch.solver.smo import train_single_device
    return train_single_device(x, y, config, dev, f_init=f_init,
                               alpha_init=alpha_init, guard_eta=guard_eta)


def _polish(x, y, config: SVMConfig, device, f_init, alpha_init,
            guard_eta) -> TrainResult:
    """Two-phase "polishing" (the fast-SVM recipe, arXiv:2207.01016): the
    configured solver path does the bulk of the work with bfloat16 X,
    then an exact-float32 warm start refines to the same epsilon from f
    recomputed from alpha."""
    if f_init is not None or alpha_init is not None:
        raise ValueError(
            "polish composes with the plain classification init "
            "only — the SVR/one-class wrappers seed f and manage "
            "their own duals; polish their output via warm_start "
            "with matmul_precision='highest' instead")
    fast_p = ("default" if config.matmul_precision == "highest"
              else config.matmul_precision)
    fast = train(x, y, dataclasses.replace(
        config, polish=False, matmul_precision=fast_p), device=device,
        guard_eta=guard_eta)
    budget = config.max_iter - fast.n_iter
    if budget <= 0:
        if fast.converged:
            warnings.warn(
                "polish: the fast phase consumed the entire "
                "max_iter budget while converging, so the exact-f32 "
                "refinement was skipped — the returned model's KKT "
                "condition holds at fast precision only. Raise "
                "max_iter to get the polished guarantee.")
        return fast
    t0 = time.perf_counter()
    refined = warm_start(x, y, fast.alpha, dataclasses.replace(
        config, polish=False, matmul_precision="highest",
        max_iter=budget), device=device, guard_eta=guard_eta)
    # The refinement's fresh O(n^2) kernel pass is part of the schedule.
    refine_seconds = time.perf_counter() - t0
    return dataclasses.replace(
        refined, n_iter=fast.n_iter + refined.n_iter,
        train_seconds=fast.train_seconds + refine_seconds)


def fit(x: np.ndarray, y: np.ndarray, config: Optional[SVMConfig] = None,
        device: Device = None) -> Tuple[SVMModel, TrainResult]:
    """train + SV compaction in one call.

    ``config.solver = "approx-rff" | "approx-nystrom"`` dispatches to the
    kernel-approximation path (``approx/primal.fit_approx``) and returns
    an ``ApproxSVMModel``, which every consumer (``decision_function``,
    ``models/io``, CV, multi-class) dispatches on; ``"cascade"`` to the
    three-stage schedule (``solver/cascade.fit_cascade``), which returns
    an ordinary ``SVMModel``.

    The exact route's profiler ranges (``utils/timing.span``): ``fit``
    around the call, and inside it ``fit.check`` (``train``'s
    validation), the solver path's own (the fused pair's ``fit.upload``,
    the driver's ``train.loop`` and ``train.download``) and
    ``fit.compact`` (``SVMModel.from_train_result``)."""
    config = config or SVMConfig()
    if config.solver == "cascade":
        from dpsvm_tpu_torch.solver.cascade import fit_cascade
        return fit_cascade(x, y, config, device=device)
    if config.solver != "exact":
        from dpsvm_tpu_torch.approx.primal import fit_approx
        return fit_approx(x, y, config, device=device)
    with span("fit"):
        x = densify(x)      # from_train_result consumes x too
        result = train(x, y, config, device=device)
        with span("fit.compact"):
            model = SVMModel.from_train_result(x, y, result)
    return model, result


def sweep_c(x: np.ndarray, y: np.ndarray, cs,
            config: Optional[SVMConfig] = None, gammas=None,
            device: Device = None) -> "list[Tuple[SVMModel, TrainResult]]":
    """Fit the same +/-1 problem at every point of a C (x gamma) grid in
    ONE batched program (``solver/batched_ovo.train_c_sweep``: C only
    moves the box bound, gamma only the kernel epilogue after the shared
    dots). Returns [(model, result)] in ``cs`` order (row-major (C,
    gamma) order with ``gammas``)."""
    from dpsvm_tpu_torch.solver.batched_ovo import train_c_sweep

    x, y = _check_xy(x, y)
    config = config or SVMConfig()
    if config.solver != "exact":
        raise ValueError("the batched C/gamma sweep is a dual-solver "
                         "program; approx solvers sweep by refitting "
                         "(the feature map is shared work, see "
                         "docs/APPROX.md)")
    results = train_c_sweep(x, y, cs, config, device=device, gammas=gammas)
    return [(SVMModel.from_train_result(x, y, r), r) for r in results]


def warm_start(x: np.ndarray, y: np.ndarray, alpha: np.ndarray,
               config: Optional[SVMConfig] = None, device: Device = None,
               guard_eta: bool = False, group=None) -> TrainResult:
    """Continue training from a previous solution's alpha.

    Recomputes f = K (alpha*y) - y in one streamed kernel pass
    (``ops.diagnostics._stream_kv``) and resumes the SMO loop, so a capped
    run can be continued with a larger ``max_iter`` (or a tighter
    ``epsilon``), and a converged alpha returns after the first poll. The
    alphas must come from a run with the same C and weights: membership
    of the box's corners is an exact comparison against this config's
    bounds. ``group``: as ``train``'s (a distributed continuation)."""
    from dpsvm_tpu_torch.ops.diagnostics import _stream_kv

    config = config or SVMConfig()
    config.validate()
    if config.solver != "exact":
        raise ValueError("warm_start continues a DUAL trajectory from "
                         "alpha; approx solvers have no dual, and the "
                         "cascade CALLS warm_start for its polish stage "
                         "— pass solver='exact' (resume a primal run "
                         "via checkpoint_path/resume_from instead)")
    if config.polish:
        raise ValueError("warm_start IS the refinement mechanism polish "
                         "is built from — call it with "
                         "matmul_precision='highest' instead of "
                         "polish=True")
    if config.resume_from:
        raise ValueError("config.resume_from would override the given "
                         "alpha (checkpoint resume takes precedence in "
                         "the solvers) — clear it, or resume the "
                         "checkpoint via train() instead")
    x, y = _check_xy(x, y)
    yf = np.asarray(y, np.float32)
    alpha = np.asarray(alpha, np.float32)
    if alpha.shape != (x.shape[0],):
        raise ValueError(f"alpha must be ({x.shape[0]},), got {alpha.shape}")
    box = np.broadcast_to(np.asarray(config.box_bound(y), np.float32),
                          alpha.shape)
    if (not np.isfinite(alpha).all() or (alpha < 0).any()
            or (alpha > box).any()):
        raise ValueError("alpha outside [0, C] (or non-finite) — not a "
                         "feasible dual point for this config")
    dev = resolve_device(device)
    kv = _stream_kv(x, alpha * yf, config.kernel_spec(x.shape[1]),
                    block=4096, device=dev)
    return train(x, y, config, device=dev,
                 f_init=(kv - yf).astype(np.float32), alpha_init=alpha,
                 guard_eta=guard_eta, group=group)
