"""Single-device SMO through the fused iteration (port of
``dpsvm_tpu/experimental/fused.py``).

Each iteration's O(n) work (kernel rows, f update, next working-set
selection) is one pass over X: on the card, one launch of the CUDA kernel
of ``fused_step``, enqueued a chunk at a time with no host synchronisation
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

Resume (``config.resume_from``, as ``dpsvm_tpu/experimental/fused.py``
does it): a checkpoint of a finished run is returned as it is; otherwise
the working set is recomputed from the restored (alpha, f) (it is a pure
function of the solver state). When that selection already closes the gap
the general pair's resumed loop would still run one body (its condition
sees the checkpoint's stale open gap), so one body of the kernel runs
here too and keeps the recomputed b's (``_mirror_body``), unless the
checkpoint was saved at ``max_iter``.
"""

from __future__ import annotations

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.experimental.fused_step import (
    S_BHI, S_BLO, S_NITER, S_RUN, FusedCarry, FusedWorkspace, book_runs,
    launch_fused_chunk, pack_state, run_chunk_plain, unpack_state)
from dpsvm_tpu_torch.ops.kernels import row_norms_sq
from dpsvm_tpu_torch.ops.selection import masked_extrema
from dpsvm_tpu_torch.solver.driver import (device_sv_count, gap_open,
                                           host_training_loop, pack_stats,
                                           read_stats, resume_state)


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
                      device_sv_count(carry.alpha), torch.zeros_like(s[0]),
                      s[S_RUN])


def _prepare(x: np.ndarray, y: np.ndarray, config: SVMConfig,
             device: torch.device):
    """X as stored, its norms, y, and the alpha = 0, f = -y state."""
    x_dtype = (torch.bfloat16 if config.matmul_precision == "default"
               else torch.float32)
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    xd = xd.to(x_dtype).contiguous()
    x2 = row_norms_sq(xd)                       # from the STORED X
    yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
    return xd, x2, yd, torch.zeros_like(yd), -yd


def _consts(config: SVMConfig, gamma: float) -> dict:
    return dict(c=float(config.c), gamma=gamma,
                two_eps=float(np.float32(2.0 * config.epsilon)),
                max_iter=int(config.max_iter))


def _finished(ckpt, gamma: float) -> TrainResult:
    """A checkpoint of a converged run, returned as it is: entering the
    loop would apply the trailing do-while body again."""
    alpha = np.asarray(ckpt.alpha, np.float32)
    return TrainResult(
        alpha=alpha, b=(ckpt.b_lo + ckpt.b_hi) / 2.0, n_iter=ckpt.n_iter,
        converged=True, b_lo=ckpt.b_lo, b_hi=ckpt.b_hi, train_seconds=0.0,
        gamma=gamma, n_sv=int(np.sum(alpha > 0)))


def _mirror_body(carry: FusedCarry, ws, n_iter: int, launch) -> None:
    """One SMO body from the recomputed selection, keeping its b's: the
    host-side mirror of the general pair's stale-gap body on resume. It
    is the chunk's trailing do-while body, which fires on a closed gap
    when n_iter == 0 (the program-initial gate), so the carry's n_iter
    (and the workspace's record of it) is set to 0 for one chunk of limit
    0, one launch, and to ``n_iter + 1`` after it. ``launch(carry,
    limit)`` is the path's chunk (kernel A on the card, its plain version
    on the CPU)."""
    carry.state[S_NITER] = 0
    if ws is not None:
        ws.n_iter = 0
    launch(carry, 0)
    carry.state[S_NITER] = n_iter + 1
    if ws is not None:
        ws.n_iter = n_iter + 1


def _run(x: np.ndarray, y: np.ndarray, config: SVMConfig,
         device: torch.device, plain: bool) -> TrainResult:
    """The fused pair's loop, through ``launch_fused_chunk`` (the kernel
    on CUDA tensors) or, with ``plain``, through ``run_chunk_plain``."""
    config.validate()
    gamma = float(config.resolve_gamma(x.shape[1]))
    xd, x2, yd, alpha, f = _prepare(x, y, config, device)
    consts = _consts(config, gamma)
    ckpt = resume_state(config, x.shape[0], x.shape[1], gamma)
    it0 = 0
    if ckpt is not None:
        if not gap_open(ckpt.b_lo, ckpt.b_hi, 2.0 * config.epsilon):
            return _finished(ckpt, gamma)
        it0 = int(ckpt.n_iter)
        alpha = torch.from_numpy(np.asarray(ckpt.alpha, np.float32)).to(
            device)
        f = torch.from_numpy(np.asarray(ckpt.f, np.float32)).to(device)
    carry = init_fused_carry(alpha, f, yd, float(config.c), it0)
    ws = None if plain else FusedWorkspace(xd, n_iter=it0)

    def launch(cr: FusedCarry, limit: int):
        if plain:
            run_chunk_plain(cr, xd, x2, yd, limit=limit, **consts)
        else:
            launch_fused_chunk(cr, xd, x2, yd, ws, limit=limit, **consts)

    if ckpt is not None and it0 < config.max_iter:
        _, _, b_hi, b_lo, _ = unpack_state(carry.state)
        if not (float(b_lo) > float(b_hi) + 2.0 * float(config.epsilon)):
            _mirror_body(carry, ws, it0, launch)

    def step(cr: FusedCarry, limit: int):
        launch(cr, limit)
        st = read_stats(_stats(cr))
        if ws is not None:
            book_runs(ws, st.n_iter, *st.runs)
        return cr, st

    return host_training_loop(
        config, gamma, carry, step,
        lambda cr: (cr.alpha.cpu().numpy(), cr.f.cpu().numpy()),
        it0=it0, dims=x.shape)


def train_single_device_fused(x: np.ndarray, y: np.ndarray,
                              config: SVMConfig,
                              device: torch.device) -> TrainResult:
    """Train on one device through ``launch_fused_chunk``: the CUDA
    kernel on the card, its plain versions on the CPU."""
    return _run(x, y, config, device, plain=False)


def train_single_device_plain(x: np.ndarray, y: np.ndarray,
                              config: SVMConfig,
                              device: torch.device) -> TrainResult:
    """The same training loop through the plain versions on any device:
    the reference the kernel path is held against on the card."""
    return _run(x, y, config, device, plain=True)
