"""Host-side training driver (lean port of ``dpsvm_tpu/solver/driver.py``).

The solver hands this loop a chunk runner that advances the carry by up
to ``chunk_iters`` iterations on the device with no host synchronisation
inside the chunk. The loop polls once per chunk: one packed-stats tensor,
one device-to-host read, with the floats carried as bit patterns so every
field is exact. Tracing, watch rules, health monitoring and fault
injection of the JAX driver are not ported yet.

Checkpoints: with ``checkpoint_every > 0`` a poll that crosses an
every-N boundary reads (alpha, f) once and saves them with the polled
scalars (``utils/checkpoint.py``); no other poll reads more than the
packed stats. ``resume_state`` loads the checkpoint a run resumes from,
falling back past corrupt rotation slots.

Distributed runs (``parallel/``) pass their ``mesh``: every decision the
loop takes is then one every rank takes alike. The polled scalars are
replicated by construction; the poll also carries every rank's own view
of them (the probe tail, ``parallel.mesh.shard_probe``), and rows that
disagree raise ``MeshDesyncError``. The wall budget's verdict is the
largest over the ranks (ranks whose clocks disagree would otherwise stop
at different polls and leave the others waiting in a collective). A
checkpoint's (alpha, f) are gathered on every rank and written by rank 0
alone. The rollback, heartbeats and fault injection of the JAX package's
elastic layer are not ported.

``poll_hook`` follows the JAX contract: called at each poll of a run that
is not done, ``poll_hook(n_iter, carry, stats) -> Optional[new_step]``, a
non-None return replacing the chunk runner. The JAX loop dispatches the
next chunk before it polls (pipelined dispatch), so there a replacement
first runs one chunk after the poll that chose it; while checkpoints are
on it dispatches strictly in sequence, and a replacement runs from the
next chunk. This loop keeps both schedules, so that a run whose hook
swaps runners (the decomposition's working-set growth) walks the JAX
run's trajectory either way.
"""

from __future__ import annotations

import logging
import math
import sys
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.parallel.mesh import all_max
from dpsvm_tpu_torch.utils.checkpoint import (CheckpointCorruptError,
                                              CheckpointError,
                                              SolverCheckpoint,
                                              checkpoint_candidates,
                                              dist_checkpoint,
                                              load_checkpoint,
                                              maybe_checkpoint)

_logger = logging.getLogger("dpsvm_tpu_torch")

# Ever, in this process: checkpoint saves, the (alpha, f) reads they made,
# and the seconds the host spent in them (read, write, rename).
CHECKPOINTS = {"saves": 0, "pulls": 0, "seconds": 0.0}


class ChunkStats(NamedTuple):
    n_iter: int
    b_lo: float
    b_hi: float
    n_sv: int
    rounds: int         # decomposition outer rounds (0 on other paths)
    runs: tuple         # per kernel, launches whose body ran, ever
    probe: tuple = ()   # distributed: every rank's (n_iter, b_lo bits,
                        # b_hi bits), one row a rank


class DivergenceError(RuntimeError):
    """The poll saw a non-finite optimality gap: the run cannot converge."""


class MeshDesyncError(RuntimeError):
    """The ranks' own views of the polled scalars disagree."""


def device_sv_count(alpha: torch.Tensor) -> torch.Tensor:
    """count(alpha > 0) as an int32 0-d tensor, on alpha's device."""
    return (alpha > 0).sum(dtype=torch.int32)


def pack_stats(n_iter, b_lo, b_hi, n_sv, rounds, *runs) -> torch.Tensor:
    """Poll scalars as one int32 tensor on the device, the layout every
    poll reads: [n_iter, b_lo bits, b_hi bits, n_sv, rounds, runs...].
    Every argument is a 0-d int32 device tensor; the b's are bit patterns
    (the carry states store them so)."""
    return torch.stack([n_iter, b_lo, b_hi, n_sv, rounds, *runs])


def read_stats(stats: torch.Tensor, shards: int = 0) -> ChunkStats:
    """The poll's one device-to-host read, unpacked. ``shards`` > 0: the
    last 3 x shards words are the distributed runs' probe tail."""
    s = stats.cpu().numpy()
    b = s[1:3].view(np.float32)
    tail = len(s) - 3 * int(shards)
    probe = tuple(tuple(int(v) for v in row)
                  for row in s[tail:].reshape(-1, 3)) if shards else ()
    return ChunkStats(int(s[0]), float(b[0]), float(b[1]), int(s[3]),
                      int(s[4]), tuple(int(v) for v in s[5:tail]), probe)


def check_probe(st: ChunkStats) -> None:
    """Raise ``MeshDesyncError`` when the ranks' rows of the probe tail
    disagree (they are equal by construction on a healthy mesh)."""
    if st.probe and any(row != st.probe[0] for row in st.probe):
        raise MeshDesyncError(
            "ranks disagree on the polled state (n_iter, b_lo bits, b_hi "
            f"bits) by rank: {list(st.probe)}")


def resume_state(config: SVMConfig, n: int, d: int, gamma: float,
                 shards: int = 1) -> Optional[SolverCheckpoint]:
    """Load and check the checkpoint ``config.resume_from`` names, or None.

    A corrupt file (truncated, bit-flipped: what ``load_checkpoint``
    rejects) falls back to the newest intact rotation slot (``state.1.npz``,
    ...), saying what was skipped; only when every slot is unreadable does
    the error propagate. An intact checkpoint of another problem or
    config always raises ``CheckpointMismatchError``.

    ``shards`` is this run's mesh size. A checkpoint saved on another
    mesh is not a mismatch: the state is the global unpadded (alpha, f),
    which the distributed trainers re-slice for this mesh, and a
    ``RESHARD:`` line on stderr names both meshes."""
    if not config.resume_from:
        return None
    skipped = []
    last_err: Optional[CheckpointError] = None
    for path in checkpoint_candidates(config.resume_from):
        try:
            ckpt = load_checkpoint(path)
        except CheckpointCorruptError as e:
            print(f"WARNING: {e}; trying older rotation slot",
                  file=sys.stderr, flush=True)
            skipped.append(path)
            last_err = e
            continue
        ckpt.validate_against(n, d, config, gamma, shards=shards)
        if skipped:
            print(f"WARNING: resuming from rotation slot {path} "
                  f"(skipped corrupt: {skipped})",
                  file=sys.stderr, flush=True)
        if ckpt.needs_reshard(shards):
            print(f"RESHARD: checkpoint {path} was saved on a "
                  f"{ckpt.mesh_desc()}; resuming on {shards} — "
                  f"re-slicing the global state onto the new mesh",
                  file=sys.stderr, flush=True)
        return ckpt
    raise CheckpointError(
        f"no intact checkpoint to resume: {config.resume_from} and "
        f"every rotation slot failed ({skipped})") from last_err


def gap_open(b_lo, b_hi, two_eps: float):
    """The do-while condition's gap test on the host, in the device's
    arithmetic: b_lo > b_hi + 2 eps with the sum rounded to float32, as
    ``smo.live``, both kernels and the batched program compute it. Tested
    in float64, a gap can stay open on the host after the device has
    closed it (b_hi + 2 eps rounding up to b_lo; one-class at 60000 rows
    has |f| ~ 834, where a float32 ulp is 6e-5), and the loop would then
    poll a device that never steps again. Every host loop tests its gap
    here. Scalars give a bool, arrays (one b per problem) a bool array;
    NaN is closed, as on the device."""
    out = (np.asarray(b_lo, np.float32)
           > np.asarray(b_hi, np.float32) + np.float32(two_eps))
    return bool(out) if out.ndim == 0 else out


def _finite_converged(b_lo: float, b_hi: float, eps: float) -> bool:
    """The driver's convergence verdict: gap closed AND finite."""
    return (math.isfinite(b_lo) and math.isfinite(b_hi)
            and not gap_open(b_lo, b_hi, 2.0 * eps))


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
                       step_chunk: Callable, carry_to_host: Callable,
                       poll_hook: Optional[Callable] = None,
                       it0: int = 0,
                       dims: Optional[Tuple[int, int]] = None,
                       mesh=None) -> TrainResult:
    """Run chunks until convergence, ``max_iter`` or the wall budget.

    ``step_chunk(carry, limit) -> (carry, ChunkStats)`` advances the carry
    to at most ``limit`` iterations (plus the trailing do-while body on
    convergence) and performs the poll's single read.
    ``carry_to_host(carry)`` returns (alpha, f) as numpy arrays.
    ``poll_hook``: see the module docstring. ``it0`` is the carry's
    n_iter at the start (a run continued mid-way). ``dims`` is the
    problem's (n, d), which a checkpoint records. ``mesh`` (a
    ``parallel.mesh.DataMesh``): a distributed run; see the module
    docstring."""
    eps = float(config.epsilon)
    shards = 1 if mesh is None else mesh.size
    pipeline = config.checkpoint_every == 0
    t0 = time.perf_counter()
    n_iter = prev = last_saved = int(it0)
    pending = None

    def snapshot() -> SolverCheckpoint:
        # the carry as the last poll left it: the loop dispatches in
        # sequence while checkpoints are on
        alpha, f = carry_to_host(carry)
        CHECKPOINTS["pulls"] += 1
        return SolverCheckpoint(
            alpha=np.asarray(alpha, np.float32),
            f=np.asarray(f, np.float32), n_iter=n_iter, b_lo=b_lo,
            b_hi=b_hi, c=float(config.c), gamma=gamma,
            epsilon=float(config.epsilon), n=int(dims[0]), d=int(dims[1]),
            weight_pos=float(config.weight_pos),
            weight_neg=float(config.weight_neg), kernel=config.kernel,
            coef0=float(config.coef0), degree=int(config.degree),
            shards=shards, host_count=shards, host_id=0)

    while True:
        limit = min(n_iter + config.chunk_iters, config.max_iter)
        carry, st = step_chunk(carry, limit)
        if pending is not None:     # chosen one poll ago: runs from here
            step_chunk, pending = pending, None
        n_iter, b_lo, b_hi = st.n_iter, st.b_lo, st.b_hi
        # Finite-aware: every NaN comparison is False, so a plain
        # `not (b_lo > ...)` would call a NaN gap converged.
        converged = _finite_converged(b_lo, b_hi, eps)
        done = converged or n_iter >= config.max_iter
        if not done and not (math.isfinite(b_lo) and math.isfinite(b_hi)):
            raise DivergenceError(
                f"non-finite optimality gap at iter {n_iter} (b_lo={b_lo}, "
                f"b_hi={b_hi}): a NaN/Inf in the data or the solver state")
        check_probe(st)
        if not done and config.wall_budget_s:
            over = time.perf_counter() - t0 > config.wall_budget_s
            if mesh is not None:
                over = all_max(mesh, float(over)) > 0
            done = over
        log_progress(config, n_iter, b_lo, b_hi, done, prev)
        prev = n_iter
        if poll_hook is not None and not done:
            replacement = poll_hook(n_iter, carry, st)
            if replacement is not None:
                if pipeline:
                    pending = replacement
                else:
                    step_chunk = replacement
        t_save = time.perf_counter()
        if mesh is None:
            saved = maybe_checkpoint(config, last_saved, n_iter, snapshot)
        else:
            saved = dist_checkpoint(config, last_saved, n_iter, snapshot,
                                    mesh.rank == 0)
        if saved != last_saved:
            CHECKPOINTS["saves"] += 1
            CHECKPOINTS["seconds"] += time.perf_counter() - t_save
        last_saved = saved
        if done:
            break
    alpha, _ = carry_to_host(carry)
    alpha = np.array(alpha, np.float32, copy=True)
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
        kernel=config.kernel,
        coef0=float(config.coef0),
        degree=int(config.degree),
        rounds=st.rounds,
    )
