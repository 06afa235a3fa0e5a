"""Shrinking (active-set) training on one device (port of
``dpsvm_tpu/solver/shrink.py``): LIBSVM's -h heuristic.

LIBSVM shrinks the optimisation to the rows that can still move: a bound
variable whose gradient says it will stay at its bound is taken out of
selection and of the f update, and the full problem is revisited only to
validate convergence (svm.cpp's be_shrunk / reconstruct_gradient). Here a
host-level manager wraps the existing chunk runners, the general pair
(``solver/smo.py``, ``working_set == 2``) or the decomposition
(``solver/decomp.py``, kernel B, ``working_set > 2``):

* train in chunks on the ACTIVE subproblem (x, y, x2, alpha, f compacted
  to the active rows; SMO on it is exact, since the inactive alphas are
  frozen and their share is already in the active rows' f);
* every ``min(SHRINK_CHECK_ITERS, n)`` iterations pull (alpha, f) and
  apply LIBSVM's rule: an I_up-only row with f > b_lo, or an I_low-only
  row with f < b_hi, can no longer be in a violating pair. Compact only
  when the active set at least halves;
* when the subproblem converges (or the budget ends), scatter alpha and f
  back, rebuild the inactive rows' f exactly in one streamed pass over
  the support vectors (``ops.diagnostics._stream_kv_against``; the active
  rows keep their maintained f, as in LIBSVM), and check optimality on
  the FULL problem on the host. Converged: done; otherwise training goes
  on unshrunk, and may shrink again.

So the model meets the unshrunk path's stopping rule on the full
problem: shrinking changes the trajectory, never the convergence
contract.

On the card. Each active subproblem is padded to a power-of-two capacity
(``_bucket_cap``) with inert rows (zero x and x2, y = +1, alpha = 0,
f = SENTINEL) that the runners' ``valid`` mask keeps out of selection.
The general pair keeps, for each capacity, one problem and one carry whose
tensors it refills in place, and the CUDA graph captured over them, so an
unshrink and re-shrink cycle replays graphs already captured: at most one
capture a capacity, about log2(n) in all. The decomposition has no graph;
its padding slots reach kernel B as masked slots. ``n_iter``, ``b_hi``,
``b_lo`` (and the decomposition's rounds) carry across every rebuild, so
the ``max_iter`` budget is never granted again.

Over the ranks (``shards > 1``, as ``dpsvm_tpu/solver/shrink.py:189-350``
does it): every rank runs this manager on the same host state, and each
active subproblem goes through the distributed pad-and-shard protocol
(``parallel/dist_smo.prepare_distributed_inputs(capacity=)``) at the same
power-of-two capacities, so the pair keeps one SPMD problem, carry and
captured graph a capacity there too. The pulls are all-gathers, every
decision is taken on replicated values (the wall budget's as the largest
verdict over the ranks), and the unshrink's f rebuild is split across the
ranks and gathered. An active set never drops below P rows.

``RUN`` records the last run: the size of the active set at the start
and after every compaction and unshrink (the JAX package's trace events
carry the same sequence) and the iteration each took effect at, the
capacities it built, its compactions,
unshrinks, graph captures, (alpha, f) pulls, the host seconds of each
kind of work, and the rows whose f the last unshrink rebuilt (their
indices, the rebuilt f and the alpha it was rebuilt from). It writes no trace file (the trace layer is not
ported).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SENTINEL, SVMConfig, TrainResult
from dpsvm_tpu_torch.ops.diagnostics import _stream_kv_against
from dpsvm_tpu_torch.ops.kernels import KernelSpec, kdiag_from_norms
from dpsvm_tpu_torch.ops.selection import box_sides, iup_ilow_masks_np
from dpsvm_tpu_torch.parallel import dist_decomp as dd
from dpsvm_tpu_torch.parallel import dist_smo as ds
from dpsvm_tpu_torch.parallel.mesh import (all_max, gather_rows,
                                           make_data_mesh, split_rows,
                                           to_host)
from dpsvm_tpu_torch.solver import smo
from dpsvm_tpu_torch.solver.decomp import (DecompCarry, DecompProblem,
                                           DecompWorkspace, make_runner)
from dpsvm_tpu_torch.observability.device import memory_snapshot
from dpsvm_tpu_torch.utils import watchdog
from dpsvm_tpu_torch.solver.driver import (DivergenceError, begin_trace,
                                           check_probe, drain_compiles,
                                           gap_open, log_progress, settle,
                                           trace_env)

# Ceiling on iterations between shrink-rule checks (each pulls alpha and
# f); the cadence is min(n, this) a run. LIBSVM's is min(n, 1000).
SHRINK_CHECK_ITERS = 4096

# The last run of train_shrinking (reset at its start).
RUN: dict = {}


def _bucket_cap(n_act: int, n: int, floor: int = 512) -> int:
    """Power-of-two capacity for an active subproblem, floored to keep
    tiny subproblems from churning and capped at n: every distinct
    capacity is one more graph capture on the general pair, so cycles
    that land on the same bucket share one, at most about log2(n) in
    all."""
    cap = floor
    while cap < n_act:
        cap *= 2
    return min(cap, n)


def _host_extrema(alpha, y, f, c_box):
    """(b_hi, b_lo) from host arrays: the full-problem optimality check at
    unshrink. Membership is the one shared rule
    (``ops.selection.iup_ilow_masks_np``)."""
    in_up, in_low = iup_ilow_masks_np(alpha, y, c_box)
    b_hi = float(f[in_up].min()) if in_up.any() else np.inf
    b_lo = float(f[in_low].max()) if in_low.any() else -np.inf
    return b_hi, b_lo


def _shrinkable(alpha, y, f, c_box, b_hi, b_lo):
    """LIBSVM's be_shrunk on this f convention: a row that can no longer
    be either side of a violating pair (I_up-only with f > b_lo can never
    beat the max violator as the argmin side, and vice versa)."""
    in_up, in_low = iup_ilow_masks_np(alpha, y, c_box)
    up_only = in_up & ~in_low
    low_only = in_low & ~in_up
    return (up_only & (f > b_lo)) | (low_only & (f < b_hi))


def _reconstruct_inactive_f(x, y, alpha, f, alpha0, f0, active_mask,
                            spec: KernelSpec, block: int = 8192,
                            device: Optional[torch.device] = None,
                            mesh=None) -> np.ndarray:
    """Exact f for the inactive rows (one streamed kernel pass); the
    active rows keep their maintained values (LIBSVM's
    reconstruct_gradient split).

    Rebuilt RELATIVE to the run's initial state,
    f_i = f0_i + sum_j (alpha_j - alpha0_j) y_j K_ij: for plain
    classification (f0 = -y, alpha0 = 0) the textbook K(alpha y) - y, and
    right for seeded runs too (warm_start), where the absolute formula
    would rebuild the wrong gradient. With a ``mesh`` each rank rebuilds
    its share of the rows and the shares are gathered on every rank."""
    inactive = ~active_mask
    if not inactive.any():
        return f
    coef = ((alpha - alpha0) * y).astype(np.float32)
    sv = coef != 0.0
    rows = np.flatnonzero(inactive)
    if mesh is not None:
        lo, hi, per = split_rows(len(rows), mesh)
        rows = rows[lo:hi]
    if not sv.any() or not len(rows):
        kv = np.zeros(len(rows), np.float32)
    else:
        kv = _stream_kv_against(x[rows], x[sv], coef[sv], spec, block,
                                device or torch.device("cpu"))
    if mesh is not None:
        kv = gather_rows(mesh, kv, per, int(inactive.sum()))
    f = f.copy()
    f[inactive] = f0[inactive] + kv
    return f


def _fill(dst: torch.Tensor, src: torch.Tensor, pad) -> None:
    """dst[:len(src)] = src and the rest = pad, in place."""
    k = src.shape[0]
    dst[:k].copy_(src)
    dst[k:].fill_(pad)


def _pad_box(config: SVMConfig) -> float:
    """The box of a padding row (y = +1) under class weights."""
    return float(np.float32(config.c * config.weight_pos))


def _seeds(alpha, f, idx, cap: int, device: torch.device):
    """The padded subproblem's (alpha, f) on the device: the host values
    of the rows ``idx``, then alpha = 0 and f = SENTINEL to ``cap``."""
    pad = cap - len(idx)
    return tuple(torch.from_numpy(np.concatenate(
        [v[idx], np.full(pad, fill, np.float32)])).to(device)
        for v, fill in ((alpha, 0.0), (f, SENTINEL)))


def _step_and_pull(run, carry, n_act: int):
    """``step(limit) -> ChunkStats`` and ``pull() -> (alpha, f)`` of the
    active rows, around a chunk runner (the eager loops return new
    carries, so the latest is kept)."""
    state = [carry]

    def step(limit: int):
        state[0], st = run(state[0], limit)
        return settle(st)

    def pull():
        return (state[0].alpha[:n_act].cpu().numpy(),
                state[0].f[:n_act].cpu().numpy())

    return step, pull


class _PairPath:
    """The general pair on an active subproblem. One slot a capacity: an
    ``SMOProblem`` and an ``SMOCarry`` of ``cap`` rows refilled in place
    at each rebuild, and on the card the masked ``GraphChunk`` captured
    over them once."""

    def __init__(self, x, y, config: SVMConfig, device: torch.device,
                 guard_eta: bool, plain: bool):
        self.full = smo.SMOProblem.build(x, y, config, device)
        self.pad_box = _pad_box(config)
        self.opts = smo.SMOOptions.from_config(config, guard_eta)
        self.two_eps = smo.two_eps_f32(config.epsilon)
        self.graph = device.type == "cuda" and not plain
        self.slots = {}

    def _slot(self, cap: int):
        if cap not in self.slots:
            full, dev = self.full, self.full.y.device

            def vec(src):
                return torch.empty((cap,) + tuple(src.shape[1:]),
                                   dtype=src.dtype, device=dev)

            c_box = (vec(full.c_box) if isinstance(full.c_box, torch.Tensor)
                     else full.c_box)
            prob = dataclasses.replace(
                full, x=vec(full.x), y=vec(full.y), x2=vec(full.x2),
                kdiag=None if full.kdiag is None else vec(full.kdiag),
                c_box=c_box, up_side=vec(full.up_side),
                low_side=vec(full.low_side))
            carry = smo.init_carry(torch.ones(cap, device=dev))
            self.slots[cap] = [prob, carry, None]
        return self.slots[cap]

    def make(self, idx: np.ndarray, cap: int, alpha, f, n_iter: int,
             b_hi: float, b_lo: float, rounds: int):
        """(step, pull) for the rows ``idx`` at capacity ``cap``, seeded
        from the host (alpha, f) and the loop's scalars."""
        n_act = len(idx)
        full = self.full
        slot = self._slot(cap)
        prob, carry = slot[0], slot[1]
        ii = torch.from_numpy(np.asarray(idx, np.int64)).to(full.y.device)
        _fill(prob.x, full.x.index_select(0, ii), 0.0)
        _fill(prob.y, full.y.index_select(0, ii), 1.0)
        _fill(prob.x2, full.x2.index_select(0, ii), 0.0)
        if prob.kdiag is not None:
            prob.kdiag.copy_(kdiag_from_norms(prob.x2, prob.spec))
        if isinstance(prob.c_box, torch.Tensor):
            _fill(prob.c_box, full.c_box.index_select(0, ii), self.pad_box)
        up, low = box_sides(prob.y, prob.c_box)
        prob.up_side.copy_(up)
        prob.low_side.copy_(low)
        for dst, src in zip((carry.alpha, carry.f),
                            _seeds(alpha, f, idx, cap, full.y.device)):
            dst.copy_(src)
        carry.b_hi.fill_(float(np.float32(b_hi)))
        carry.b_lo.fill_(float(np.float32(b_lo)))
        carry.n_iter.fill_(int(n_iter))
        if self.graph and slot[2] is None:
            slot[2] = smo.GraphChunk(carry, prob, self.opts, self.two_eps,
                                     masked=True)
        run = smo.make_chunk_runner(carry, prob, self.opts, self.two_eps,
                                    plain=not self.graph, n_valid=n_act,
                                    chunk=slot[2])
        return _step_and_pull(run, carry, n_act)


def _refill(dst, src) -> None:
    """Copy every tensor field of ``src`` into ``dst``'s, in place."""
    for name, v in vars(src).items():
        if isinstance(v, torch.Tensor):
            getattr(dst, name).copy_(v)


class _DistPath:
    """The pair or the decomposition over the ranks on an active
    subproblem, through the distributed pad-and-shard protocol at the
    manager's capacity. The pair keeps one slot a capacity (problem,
    carry, and on an NCCL rank the captured graph), refilled in place;
    the decomposition builds its runner anew and keeps one workspace."""

    def __init__(self, x, y, config: SVMConfig, mesh, q: int,
                 guard_eta: bool, plain: bool):
        self.x, self.y, self.config, self.mesh = x, y, config, mesh
        self.q, self.plain = q, plain
        self.opts = smo.SMOOptions.from_config(config, guard_eta)
        self.two_eps = smo.two_eps_f32(config.epsilon)
        self.ws = DecompWorkspace(mesh.device) if q else None
        self.slots = {}

    def make(self, idx: np.ndarray, cap: int, alpha, f, n_iter: int,
             b_hi: float, b_lo: float, rounds: int):
        n_act, mesh = len(idx), self.mesh
        di = ds.prepare_distributed_inputs(
            self.x[idx], self.y[idx], self.config, mesh, None, f[idx],
            alpha[idx], capacity=cap, decomp=bool(self.q))
        init = (di.init[0], di.init[1], b_hi, b_lo, n_iter)
        if self.q:
            carry = dd.init_decomp_carry(di.prob, init, rounds)
            self.ws.last = None
            run = dd.make_dist_decomp_runner(
                di.prob, self.config, self.q, self.ws, n_act, self.plain)
        else:
            carry = ds.init_carry(di.prob, init)
            if cap in self.slots:
                prob, slot_carry, chunk = self.slots[cap]
                _refill(prob, di.prob)
                for dst, src in zip(slot_carry, carry):
                    if dst is not None:
                        dst.copy_(src)
                carry = slot_carry
            else:
                prob, chunk = di.prob, None
            run = ds.make_dist_runner(carry, prob, self.opts, self.two_eps,
                                      self.plain, chunk=chunk)
            self.slots[cap] = (prob, carry, run.chunk)
        state = [carry]

        def step(limit: int):
            state[0], st = run(state[0], limit)
            return settle(st)

        def pull():
            return (to_host(mesh, state[0].alpha, n_act),
                    to_host(mesh, state[0].f, n_act))

        return step, pull


class _DecompPath:
    """The decomposition on an active subproblem: a padded
    ``DecompProblem`` gathered from the full one at each rebuild, and one
    ``DecompWorkspace`` for the whole run, so kernel B's device-counted
    runs and steps are booked across rebuilds."""

    def __init__(self, x, y, config: SVMConfig, device: torch.device,
                 q: int, plain: bool):
        self.full = DecompProblem.build(x, y, config, device)
        self.ws = DecompWorkspace(device)
        self.config, self.q, self.plain = config, q, plain

    def make(self, idx: np.ndarray, cap: int, alpha, f, n_iter: int,
             b_hi: float, b_lo: float, rounds: int):
        full = self.full
        dev = full.y.device
        ii = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)

        def padded(src, pad):
            out = torch.empty((cap,) + tuple(src.shape[1:]), dtype=src.dtype,
                              device=dev)
            _fill(out, src.index_select(0, ii), pad)
            return out

        x = padded(full.x, 0.0)
        y = padded(full.y, 1.0)
        c_box = full.c_box
        if isinstance(c_box, torch.Tensor):
            c_box = padded(c_box, _pad_box(self.config))
        prob = dataclasses.replace(
            full, x=x,
            x_pass=x if full.x_pass is full.x else padded(full.x_pass, 0.0),
            y=y, x2=padded(full.x2, 0.0), c_box=c_box)

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=dev)

        carry = DecompCarry(
            *_seeds(alpha, f, idx, cap, dev),
            b_hi=scalar(float(np.float32(b_hi)), torch.float32),
            b_lo=scalar(float(np.float32(b_lo)), torch.float32),
            n_iter=scalar(int(n_iter), torch.int32),
            rounds=scalar(int(rounds), torch.int32))
        self.ws.last = None
        run = make_runner(prob, self.config, self.q, self.ws, self.plain,
                          n_valid=len(idx))
        return _step_and_pull(run, carry, len(idx))


def reset_run() -> None:
    RUN.clear()
    RUN.update(active_sizes=[], active_since=[], capacities=[],
               compactions=0, unshrinks=0,
               captures=0, pulls=0, rebuilt=None,
               seconds={"rebuild": 0.0, "pull": 0.0, "reconstruct": 0.0})


def train_shrinking(x: np.ndarray, y: np.ndarray, config: SVMConfig,
                    device: torch.device,
                    f_init: Optional[np.ndarray] = None,
                    alpha_init: Optional[np.ndarray] = None,
                    guard_eta: bool = False,
                    plain: bool = False, group=None) -> TrainResult:
    """Active-set training: the general pair for ``working_set == 2``,
    the decomposition for ``working_set > 2``, on one device or over the
    ranks (``config.shards > 1``, or ``group``; every rank calls it with
    the same full (x, y)). The same NumPy-in, NumPy-out contract as the
    other solvers; ``plain`` runs the eager loop / kernel B's plain
    version on any device."""
    config.validate()
    mesh = None
    if config.shards > 1 or group is not None:
        mesh = make_data_mesh(config.shards, group, device)
        device = mesh.device
    counts = smo.COUNTS if mesh is None else ds.COUNTS
    reset_run()
    captures0 = counts["captures"]
    t0 = time.perf_counter()
    n, d = x.shape
    gamma = float(config.resolve_gamma(d))
    kspec = config.kernel_spec(d)
    eps = float(config.epsilon)
    chunk = int(config.chunk_iters)

    x = np.ascontiguousarray(np.asarray(x, np.float32))
    y_np = np.asarray(y, np.float32)
    c_box = np.broadcast_to(
        np.asarray(config.box_bound(y_np), np.float32), y_np.shape)
    alpha = (np.zeros(n, np.float32) if alpha_init is None
             else np.asarray(alpha_init, np.float32).copy())
    f = (-y_np.copy() if f_init is None
         else np.asarray(f_init, np.float32).copy())
    alpha0 = alpha.copy()       # the initial state anchors the relative
    f0 = f.copy()               # f rebuild at unshrink

    min_active = 1
    if config.working_set > 2:
        q = 2 * min(int(config.working_set) // 2, n)
        # the decomposition's top-k needs q/2 <= the active rows: never
        # compact below the block size
        min_active = q
    else:
        q = 0
    if mesh is not None:
        min_active = max(min_active, mesh.size)
        path = _DistPath(x, y_np, config, mesh, q, guard_eta, plain)
    elif q:
        path = _DecompPath(x, y, config, device, q, plain)
    else:
        path = _PairPath(x, y, config, device, guard_eta, plain)

    def make_active(idx, it, b_hi, b_lo, rounds):
        t = time.perf_counter()
        cap = _bucket_cap(max(len(idx), min_active), n)
        if len(idx) < n or not RUN["active_sizes"]:
            RUN["active_sizes"].append(int(len(idx)))
            RUN["active_since"].append(int(it))
        RUN["capacities"].append(int(cap))
        out = path.make(idx, cap, alpha, f, it, b_hi, b_lo, rounds)
        RUN["seconds"]["rebuild"] += time.perf_counter() - t
        # a new active size may capture a new graph: a fresh stall window
        watchdog.pet()
        return out

    def pulled():
        t = time.perf_counter()
        out = pull()
        RUN["pulls"] += 1
        RUN["seconds"]["pull"] += time.perf_counter() - t
        return out

    # The run trace (the JAX manager's): chunk records from the runners'
    # packed stats (n_sv and the counters describe the active subproblem;
    # n_active rides each record) and shrink/unshrink events at every
    # active-set transition. Rank 0 alone writes a distributed run's.
    trace = (begin_trace(config, n, d, gamma, "shrink",
                         env=trace_env(device))
             if config.trace_out and (mesh is None or mesh.rank == 0)
             else None)
    # set-up is done: a fresh stall window for the first chunk
    watchdog.pet()
    try:
        active = np.arange(n)
        step, pull = make_active(active, 0, -SENTINEL, SENTINEL, 0)
        it = last_check = 0
        while True:
            limit = min(it + chunk, config.max_iter)
            prev_polled = it
            st = step(limit)
            check_probe(st)
            it, b_lo, b_hi = st.n_iter, st.b_lo, st.b_hi
            if not (math.isfinite(b_lo) and math.isfinite(b_hi)):
                raise DivergenceError(
                    f"non-finite optimality gap (b_lo={b_lo}, "
                    f"b_hi={b_hi}): a NaN/Inf in the data or the solver "
                    "state", it)
            sub_converged = not gap_open(b_lo, b_hi, 2.0 * eps)
            capped = it >= config.max_iter
            if not capped and config.wall_budget_s:
                # the same exit as the iteration cap, taken alike by
                # every rank
                over = time.perf_counter() - t0 > config.wall_budget_s
                capped = (over if mesh is None
                          else all_max(mesh, float(over)) > 0)
                if capped and trace is not None:
                    trace.event("wall_budget", n_iter=it)
            if not capped:          # the final line after the loop reports
                log_progress(config, it, b_lo, b_hi, False, prev_polled)
            if trace is not None:
                # the driver's poll-boundary facts: queued captures (the
                # manager's rebuilds land here) and the watermarks
                drain_compiles(trace, it)
                trace.chunk(n_iter=it, b_lo=b_lo, b_hi=b_hi,
                            n_sv=st.n_sv, cache_hits=st.cache_hits,
                            cache_misses=st.cache_misses,
                            rounds=st.rounds, n_active=len(active),
                            hbm=memory_snapshot(device))

            if sub_converged or capped:
                alpha[active], f[active] = pulled()
                if len(active) == n:
                    converged = sub_converged
                    break
                # Unshrink: exact f for the frozen rows, then the real
                # optimality check on the full problem.
                t = time.perf_counter()
                mask = np.zeros(n, bool)
                mask[active] = True
                f = _reconstruct_inactive_f(x, y_np, alpha, f, alpha0, f0,
                                            mask, kspec, device=device,
                                            mesh=mesh)
                RUN["rebuilt"] = (np.flatnonzero(~mask), f[~mask].copy(),
                                  alpha.copy())
                RUN["seconds"]["reconstruct"] += time.perf_counter() - t
                RUN["unshrinks"] += 1
                RUN["active_sizes"].append(n)
                RUN["active_since"].append(int(it))
                b_hi, b_lo = _host_extrema(alpha, y_np, f, c_box)
                converged = not gap_open(b_lo, b_hi, 2.0 * eps)
                if trace is not None:
                    trace.event("unshrink", n_iter=it,
                                n_active_before=len(active),
                                n_active_after=n,
                                full_problem_converged=converged)
                if converged or capped:
                    break
                # Not there yet: go on with the full problem (and shrink
                # again as its tail converges). n_iter survives the
                # rebuild, so the budget is not granted again, and the
                # rebuilt extrema are the next chunk's entry state.
                active = np.arange(n)
                step, pull = make_active(active, it, b_hi, b_lo, st.rounds)
                continue

            # The shrink check, at most every min(SHRINK_CHECK_ITERS, n)
            # iterations (each pulls alpha and f); compact only when the
            # active set at least halves.
            if it - last_check < min(SHRINK_CHECK_ITERS, n):
                continue
            last_check = it
            a_act, f_act = pulled()
            shrink = _shrinkable(a_act, y_np[active], f_act,
                                 c_box[active], b_hi, b_lo)
            keep = int(len(active) - shrink.sum())
            if keep <= len(active) // 2 and keep >= min_active:
                alpha[active] = a_act
                f[active] = f_act
                if trace is not None:
                    trace.event("shrink", n_iter=it,
                                n_active_before=len(active),
                                n_active_after=keep)
                active = active[~shrink]
                RUN["compactions"] += 1
                # n_iter and the stopping state survive the compaction
                step, pull = make_active(active, it, b_hi, b_lo, st.rounds)

        log_progress(config, it, b_lo, b_hi, True, it)
        RUN["captures"] = counts["captures"] - captures0
        result = TrainResult(
            alpha=alpha, b=(b_lo + b_hi) / 2.0, n_iter=it,
            converged=converged, b_lo=b_lo, b_hi=b_hi,
            train_seconds=time.perf_counter() - t0, gamma=gamma,
            n_sv=int(np.sum(alpha > 0)), kernel=config.kernel,
            coef0=float(config.coef0), degree=int(config.degree),
            rounds=st.rounds)
        if trace is not None:
            drain_compiles(trace, result.n_iter)
            trace.summary(converged=result.converged, n_iter=result.n_iter,
                          b=result.b, b_lo=result.b_lo, b_hi=result.b_hi,
                          n_sv=result.n_sv,
                          train_seconds=result.train_seconds)
        return result
    finally:
        drain_compiles(None)        # never leak into the next run
        if trace is not None:
            trace.close()
