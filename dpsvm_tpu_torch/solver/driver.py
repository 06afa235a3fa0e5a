"""Host-side training driver (lean port of ``dpsvm_tpu/solver/driver.py``).

The solver hands this loop a chunk runner that advances the carry by up
to ``chunk_iters`` iterations on the device with no host synchronisation
inside the chunk. The loop polls once per chunk: one packed-stats tensor,
one device-to-host read, with the floats carried as bit patterns so every
field is exact. Checkpoints, tracing, watch rules, health monitoring and
fault injection of the JAX driver are not ported yet.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig, TrainResult

_logger = logging.getLogger("dpsvm_tpu_torch")

class ChunkStats(NamedTuple):
    n_iter: int
    b_lo: float
    b_hi: float
    n_sv: int
    runs: tuple         # per kernel, launches whose body ran, ever


class DivergenceError(RuntimeError):
    """The poll saw a non-finite optimality gap: the run cannot converge."""


def device_sv_count(alpha: torch.Tensor) -> torch.Tensor:
    """count(alpha > 0) as an int32 0-d tensor, on alpha's device."""
    return (alpha > 0).sum(dtype=torch.int32)


def pack_stats(n_iter, b_lo, b_hi, n_sv, *runs) -> torch.Tensor:
    """Poll scalars as one int32 tensor on the device, the layout every
    poll reads: [n_iter, b_lo bits, b_hi bits, n_sv, runs...]. Every
    argument is a 0-d int32 device tensor; the b's are bit patterns (the
    carry state stores them so)."""
    return torch.stack([n_iter, b_lo, b_hi, n_sv, *runs])


def read_stats(stats: torch.Tensor) -> ChunkStats:
    """The poll's one device-to-host read, unpacked."""
    s = stats.cpu().numpy()
    b = s[1:3].view(np.float32)
    return ChunkStats(int(s[0]), float(b[0]), float(b[1]), int(s[3]),
                      tuple(int(v) for v in s[4:]))


def _finite_converged(b_lo: float, b_hi: float, eps: float) -> bool:
    """The driver's convergence verdict: gap closed AND finite."""
    return (math.isfinite(b_lo) and math.isfinite(b_hi)
            and not (b_lo > b_hi + 2.0 * eps))


def log_progress(config: SVMConfig, n_iter: int, b_lo: float, b_hi: float,
                 final: bool, prev_iter: int) -> None:
    if not config.verbose and not config.log_every:
        return
    every = config.log_every or config.chunk_iters
    if not final and n_iter // every == prev_iter // every:
        return
    gap = b_lo - b_hi
    if _logger.isEnabledFor(logging.INFO) and _logger.hasHandlers():
        _logger.info("iter=%d gap=%.6g (b_lo=%.6g b_hi=%.6g, converged at "
                     "%.3g)", n_iter, gap, b_lo, b_hi, 2 * config.epsilon)
    elif config.verbose:
        print(f"[dpsvm_tpu_torch] iter={n_iter} gap={gap:.6g} "
              f"target={2 * config.epsilon:.3g}", flush=True)


def host_training_loop(config: SVMConfig, gamma: float, carry,
                       step_chunk: Callable,
                       carry_to_host: Callable) -> TrainResult:
    """Run chunks until convergence, ``max_iter`` or the wall budget.

    ``step_chunk(carry, limit) -> (carry, ChunkStats)`` advances the carry
    to at most ``limit`` iterations (plus the trailing do-while body on
    convergence) and performs the poll's single read.
    ``carry_to_host(carry)`` returns alpha as a numpy array."""
    eps = float(config.epsilon)
    t0 = time.perf_counter()
    n_iter = prev = 0
    while True:
        limit = min(n_iter + config.chunk_iters, config.max_iter)
        carry, st = step_chunk(carry, limit)
        n_iter, b_lo, b_hi = st.n_iter, st.b_lo, st.b_hi
        # Finite-aware: every NaN comparison is False, so a plain
        # `not (b_lo > ...)` would call a NaN gap converged.
        converged = _finite_converged(b_lo, b_hi, eps)
        done = converged or n_iter >= config.max_iter
        if not done and not (math.isfinite(b_lo) and math.isfinite(b_hi)):
            raise DivergenceError(
                f"non-finite optimality gap at iter {n_iter} (b_lo={b_lo}, "
                f"b_hi={b_hi}): a NaN/Inf in the data or the solver state")
        if (not done and config.wall_budget_s
                and time.perf_counter() - t0 > config.wall_budget_s):
            done = True
        log_progress(config, n_iter, b_lo, b_hi, done, prev)
        prev = n_iter
        if done:
            break
    alpha = np.array(carry_to_host(carry), np.float32, copy=True)
    return TrainResult(
        alpha=alpha,
        b=(b_lo + b_hi) / 2.0,            # svmTrainMain.cpp:329
        n_iter=n_iter,
        converged=converged,
        b_lo=b_lo,
        b_hi=b_hi,
        train_seconds=time.perf_counter() - t0,
        gamma=gamma,
        n_sv=int(np.sum(alpha > 0)),
    )
