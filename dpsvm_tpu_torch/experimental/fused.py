"""Single-device SMO through the fused iteration (port of
``dpsvm_tpu/experimental/fused.py``).

Each iteration's O(n) work (kernel rows, f update, next working-set
selection) is one pass over X: on the card, the CUDA kernels of
``fused_step``, enqueued a chunk at a time with no host synchronisation
inside the chunk; on the CPU, their plain PyTorch versions. The chunk
semantics are those of the JAX ``_run_chunk``:

* bodies run while ``b_lo > b_hi + 2 eps`` (checked before the body, in
  f32) and ``n_iter < limit``;
* on a convergence exit one trailing do-while body runs and keeps the
  converged ``b_hi`` / ``b_lo`` (``svmTrainMain.cpp:235-310``), gated on
  progress in this chunk (or ``n_iter == 0``) and on ``n_iter < max_iter``,
  so it is applied once.

When ``matmul_precision == "default"`` X is stored bfloat16, halving the
bytes of the pass; ``x2`` is taken from the stored X so that K(a, a) stays
~1 and eta stays positive. Otherwise X is float32 and the kernel
accumulates in fp32 FMA (no TF32 anywhere on the path).
"""

from __future__ import annotations

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.experimental.fused_step import (
    S_BHI, S_BLO, S_NITER, S_RUN_PASS, S_RUN_PROLOGUE, FusedCarry,
    FusedWorkspace, book_runs, launch_fused_chunk, pack_state,
    run_chunk_plain)
from dpsvm_tpu_torch.ops.kernels import row_norms_sq
from dpsvm_tpu_torch.ops.selection import masked_extrema
from dpsvm_tpu_torch.solver.driver import (device_sv_count,
                                           host_training_loop, pack_stats,
                                           read_stats)


def init_fused_carry(alpha: torch.Tensor, f: torch.Tensor, y: torch.Tensor,
                     c: float, n_iter: int = 0) -> FusedCarry:
    """Selection for the first iteration from the current (alpha, f); also
    the resume path: the working set is a pure function of solver state."""
    i_hi, b_hi, i_lo, b_lo = masked_extrema(alpha, y, f, c, valid=y != 0.0)
    return FusedCarry(alpha=alpha, f=f,
                      state=pack_state(i_hi, i_lo, b_hi, b_lo, n_iter,
                                       alpha.device))


def _stats(carry: FusedCarry) -> torch.Tensor:
    s = carry.state
    return pack_stats(s[S_NITER], s[S_BLO], s[S_BHI],
                      device_sv_count(carry.alpha), s[S_RUN_PROLOGUE],
                      s[S_RUN_PASS])


def _prepare(x: np.ndarray, y: np.ndarray, config: SVMConfig,
             device: torch.device):
    x_dtype = (torch.bfloat16 if config.matmul_precision == "default"
               else torch.float32)
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    xd = xd.to(x_dtype).contiguous()
    x2 = row_norms_sq(xd)                       # from the STORED X
    yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
    alpha = torch.zeros_like(yd)
    f = -yd
    return xd, x2, yd, init_fused_carry(alpha, f, yd, float(config.c))


def _consts(config: SVMConfig, gamma: float) -> dict:
    return dict(c=float(config.c), gamma=gamma,
                two_eps=float(np.float32(2.0 * config.epsilon)),
                max_iter=int(config.max_iter))


def train_single_device_fused(x: np.ndarray, y: np.ndarray,
                              config: SVMConfig,
                              device: torch.device) -> TrainResult:
    """Train on one device through ``launch_fused_chunk``: the CUDA
    kernels on the card, their plain versions on the CPU."""
    config.validate()
    gamma = float(config.resolve_gamma(x.shape[1]))
    xd, x2, yd, carry = _prepare(x, y, config, device)
    ws = FusedWorkspace(xd)
    consts = _consts(config, gamma)

    def step(cr: FusedCarry, limit: int):
        launch_fused_chunk(cr, xd, x2, yd, ws, limit=limit, **consts)
        st = read_stats(_stats(cr))
        book_runs(ws, st.n_iter, *st.runs)
        return cr, st

    return host_training_loop(config, gamma, carry, step,
                              lambda cr: cr.alpha.cpu().numpy())


def train_single_device_plain(x: np.ndarray, y: np.ndarray,
                              config: SVMConfig,
                              device: torch.device) -> TrainResult:
    """The same training loop through the plain versions on any device:
    the reference the kernel path is held against on the card."""
    config.validate()
    gamma = float(config.resolve_gamma(x.shape[1]))
    xd, x2, yd, carry = _prepare(x, y, config, device)
    consts = _consts(config, gamma)

    def step(cr: FusedCarry, limit: int):
        run_chunk_plain(cr, xd, x2, yd, limit=limit, **consts)
        return cr, read_stats(_stats(cr))

    return host_training_loop(config, gamma, carry, step,
                              lambda cr: cr.alpha.cpu().numpy())
