"""Batched one-vs-one training: many SMO subproblems in ONE program (port of
``dpsvm_tpu/solver/batched_ovo.py``).

The K(K-1)/2 pair subproblems of one-vs-one (and the folds of CV, and the
points of a C x gamma grid) are independent and share one X. So they run
together: each batched step advances every still-active subproblem by one
exact first-order SMO iteration, and

* every subproblem's working-pair rows join one ``(2P, d) @ (d, n)``
  product (``torch.matmul``), so X is streamed once a step for all of
  them;
* selection is a masked ``(P, n)`` row-wise (value, index) reduction,
  first index on ties (``ops/selection.rowwise_extrema``);
* the per-problem box ``c`` (the C grid) and gamma (the gamma grid: the
  dots are gamma-independent, only the epilogue differs) are (P,) tensors,
  so one program serves any assignment.

A subproblem whose own gap has closed (or that has run ``max_iter`` of its
own steps) is frozen: its alphas and b slots stop moving and its
``n_iter`` stops counting. Alphas are written lo then hi per problem, as
two scatters. The claim is the JAX package's: equal given equal arithmetic
to the sequential per-pair solver (the batched product tiles differently
from the sequential ``(2, d) @ (d, n_sub)``, so a near-tie can flip).

On the card a chunk is a captured CUDA graph of ``GRAPH_BODIES`` gated
bodies, as the general pair's (``solver/smo.py``): each body reads the
chunk's condition (some problem active, and ``t < limit``) from the carry
on the device and gates every write on it, ``limit`` is a device scalar
the host fills, and the poll reads one ``(3, P)`` int32 stats tensor a
chunk (n_iter, and the b's as bit patterns). The CPU, and ``plain=True``
anywhere, runs the same step in an eager loop that tests the condition on
the host. Scope (``batched_guard``): first-order selection, unweighted,
one device, no cache, shrinking or decomposition, every kernel kind but
precomputed; both clips.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dpsvm_tpu_torch.utils import watchdog
from dpsvm_tpu_torch.config import SENTINEL, SVMConfig, TrainResult
from dpsvm_tpu_torch.observability import compilewatch
from dpsvm_tpu_torch.ops.kernels import (dots_f32, exact_f32,
                                         host_row_stats, rows_from_dots)
from dpsvm_tpu_torch.ops.selection import (box_sides, rowwise_extrema,
                                           sided_scores)
from dpsvm_tpu_torch.ops.update import alpha_pair_step
from dpsvm_tpu_torch.solver.driver import gap_open
from dpsvm_tpu_torch.solver.smo import capture

GRAPH_BODIES = 16

# Ever, in this process: graphs captured, replays enqueued, and the
# (3, P) stats reads of the polls (one a chunk).
COUNTS = {"captures": 0, "replays": 0, "reads": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def compact_submodel(x: np.ndarray, sel: np.ndarray, ys: np.ndarray,
                     result: TrainResult, xs: "Optional[np.ndarray]" = None):
    """(SVMModel, compacted TrainResult) for one batched subproblem: the
    "callers compact with their own row masks" step of
    ``train_ovo_batched``'s contract, in one place for every consumer
    (OvO pairs, binary CV folds, multiclass CV fold x pair). ``xs`` is
    the x[sel] slice when the caller already has it."""
    from dpsvm_tpu_torch.models.svm import SVMModel

    if xs is None:
        xs = np.ascontiguousarray(x[sel])
    rr = dataclasses.replace(
        result, alpha=np.asarray(result.alpha, np.float32)[sel])
    return SVMModel.from_train_result(xs, np.asarray(ys, np.int32),
                                      rr), rr


def ovo_pair_shapes(y, classes, d):
    """(n_a + n_b, d) for every OvO pair of ``classes`` in ``y``: the
    subproblem shapes the sequential path resolves auto sentinels at."""
    y = np.asarray(y)
    counts = {cl: int(np.sum(y == cl)) for cl in classes}
    return [(counts[classes[a]] + counts[classes[b]], d)
            for a in range(len(classes))
            for b in range(a + 1, len(classes))]


def batched_guard(config: SVMConfig, what: str,
                  subproblem_shapes=None) -> None:
    """Reject configs the batched program would silently ignore or change
    the math of (the JAX table, for the fields the port has; its
    ``backend`` row cannot fire here). ``subproblem_shapes``: the (n, d)
    of each subproblem the sequential equivalent would train; with auto
    sentinels each must resolve to the classic first-order pair."""
    blockers = [name for name, bad in (
        ("selection", config.selection != "first-order"),
        ("weights", config.weight_pos != 1.0 or config.weight_neg != 1.0),
        ("shards", config.shards != 1),
        ("shrinking", config.shrinking not in (False, "auto")),
        ("working_set", config.working_set not in (0, 2)),
        ("cache_size", config.cache_size > 0),
        ("use_pallas", config.use_pallas == "on"),
        ("polish", config.polish),
    ) if bad]
    if blockers:
        raise ValueError(
            f"batched {what} runs the plain first-order single-device "
            f"path; incompatible options set: {blockers} (train "
            "with batched=False for these)")
    if (config.shrinking == "auto" or config.working_set == 0) \
            and subproblem_shapes is not None:
        for n_i, d_i in subproblem_shapes:
            r = config.resolved(int(n_i), int(d_i))
            if r.working_set != 2 or r.shrinking:
                raise ValueError(
                    f"batched {what}: the auto solver plan resolves to "
                    f"a non-classic path (working_set={r.working_set}, "
                    f"shrinking={r.shrinking}) for a {n_i}x{d_i} "
                    "subproblem; the batched program only implements "
                    "the classic first-order path — train with "
                    "batched=False, or set working_set=2 / "
                    "shrinking=False explicitly to accept the classic "
                    "path for every subproblem")


def build_pair_targets(y: np.ndarray, classes: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  List[Tuple[int, int]]]:
    """(yb (P, n) f32 with +/-1 on the pair's rows and 0 elsewhere, valid
    (P, n) bool, pairs): the OvO subproblem layout over the shared example
    axis, rows in full-set order (the tie order the sequential trainer
    sees on its compacted subset)."""
    y = np.asarray(y)
    k = len(classes)
    pairs = [(a, b) for a in range(k) for b in range(a + 1, k)]
    n = y.shape[0]
    yb = np.zeros((len(pairs), n), np.float32)
    valid = np.zeros((len(pairs), n), bool)
    for p, (a, b) in enumerate(pairs):
        sel_a = y == classes[a]
        sel_b = y == classes[b]
        yb[p, sel_a] = 1.0
        yb[p, sel_b] = -1.0
        valid[p] = sel_a | sel_b
    return yb, valid, pairs


class OvoCarry(NamedTuple):
    alpha: torch.Tensor     # (P, n) f32
    f: torch.Tensor         # (P, n) f32
    b_hi: torch.Tensor      # (P,) f32: the last step's selection, like the
    b_lo: torch.Tensor      # (P,) f32  pair solver's do-while slots
    n_iter: torch.Tensor    # (P,) i32 per-problem steps
    t: torch.Tensor         # () i32 batched steps taken


@dataclasses.dataclass
class OvoProblem:
    """The device-side inputs: X as stored (float32, or bfloat16 under
    ``matmul_precision="default"``, as the solvers store it), the (P, n)
    targets and masks, x2 of the stored X, each problem's box sides and
    its (2P, 1) gamma column (the hi rows' then the lo rows')."""
    x: torch.Tensor
    yb: torch.Tensor
    x2: torch.Tensor
    valid: torch.Tensor
    c: torch.Tensor         # (P,)
    up_side: torch.Tensor
    low_side: torch.Tensor
    g2: torch.Tensor        # (2P, 1)
    spec: object
    two_eps: float
    max_iter: int
    pairwise: bool


def init_ovo_carry(yb: torch.Tensor) -> OvoCarry:
    P = yb.shape[0]
    dev = yb.device
    return OvoCarry(
        alpha=torch.zeros_like(yb), f=-yb,
        b_hi=torch.full((P,), -SENTINEL, dtype=torch.float32, device=dev),
        b_lo=torch.full((P,), SENTINEL, dtype=torch.float32, device=dev),
        n_iter=torch.zeros((P,), dtype=torch.int32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev))


def active_problems(carry: OvoCarry, prob: OvoProblem) -> torch.Tensor:
    """(P,) bool: the gap still open and budget left (the sequential
    solver's do-while condition, per problem)."""
    return ((carry.b_lo > carry.b_hi + prob.two_eps)
            & (carry.n_iter < prob.max_iter))


def _ovo_update(carry: OvoCarry, prob: OvoProblem, active: torch.Tensor):
    """One batched step's new (alpha, f, b_hi, b_lo), every problem in
    ``active`` advanced one first-order SMO iteration, the rest frozen."""
    alpha, f = carry.alpha, carry.f
    P = alpha.shape[0]
    f_up, f_low, _ = sided_scores(alpha, f, prob.up_side, prob.low_side,
                                  prob.valid)
    i_hi, b_hi, i_lo, b_lo = rowwise_extrema(f_up, f_low)
    w_idx = torch.cat([i_hi, i_lo])                       # (2P,)
    dots = dots_f32(prob.x.index_select(0, w_idx), prob.x)  # (2P, n)
    k_all = rows_from_dots(dots, prob.x2.index_select(0, w_idx), prob.x2,
                           prob.spec, gamma=prob.g2)
    k_hi, k_lo = k_all[:P], k_all[P:]

    def gather(m, i):
        return m.gather(1, i[:, None])[:, 0]

    eta = gather(k_hi, i_hi) + gather(k_lo, i_lo) - 2.0 * gather(k_hi, i_lo)
    y_hi, y_lo = gather(prob.yb, i_hi), gather(prob.yb, i_lo)
    a_hi, a_lo = gather(alpha, i_hi), gather(alpha, i_lo)
    a_hi_n, a_lo_n = alpha_pair_step(a_hi, a_lo, y_hi, y_lo, b_hi, b_lo, eta,
                                     prob.c, prob.c, prob.pairwise)
    a_hi_n = torch.where(active, a_hi_n, a_hi)
    a_lo_n = torch.where(active, a_lo_n, a_lo)
    # lo, then hi, per problem: two scatters (one with both indices has no
    # defined order for the i_hi == i_lo corner)
    alpha = alpha.clone()
    alpha.scatter_(1, i_lo[:, None], a_lo_n[:, None])
    alpha.scatter_(1, i_hi[:, None], a_hi_n[:, None])
    f = (f + ((a_hi_n - a_hi) * y_hi)[:, None] * k_hi
         + ((a_lo_n - a_lo) * y_lo)[:, None] * k_lo)
    # b slots move only for problems that stepped, so a finished problem's
    # condition stays false and its gap is its last real step's
    return (alpha, f, torch.where(active, b_hi, carry.b_hi),
            torch.where(active, b_lo, carry.b_lo))


def ovo_step(carry: OvoCarry, prob: OvoProblem) -> OvoCarry:
    """One batched step as a new carry (the eager loop's)."""
    active = active_problems(carry, prob)
    alpha, f, b_hi, b_lo = _ovo_update(carry, prob, active)
    return OvoCarry(alpha, f, b_hi, b_lo,
                    carry.n_iter + active.to(torch.int32), carry.t + 1)


def ovo_body(carry: OvoCarry, prob: OvoProblem, limit: torch.Tensor) -> None:
    """``ovo_step`` in place, gated on the chunk's condition (some problem
    active and ``t < limit``) read on the device: when it is false every
    write puts back what it read. Reads nothing back to the host."""
    active = active_problems(carry, prob)
    go = active.any() & (carry.t < limit)
    active = active & go
    alpha, f, b_hi, b_lo = _ovo_update(carry, prob, active)
    carry.alpha.copy_(alpha)
    carry.f.copy_(torch.where(go, f, carry.f))
    carry.b_hi.copy_(b_hi)
    carry.b_lo.copy_(b_lo)
    carry.n_iter.add_(active.to(torch.int32))
    carry.t.add_(go.to(torch.int32))


def run_ovo_plain(carry: OvoCarry, prob: OvoProblem,
                  limit: int) -> OvoCarry:
    """The chunk as an eager loop: ``ovo_step`` while some problem is
    active and t < limit, tested on the host before each step."""
    while bool(active_problems(carry, prob).any()) and int(carry.t) < limit:
        carry = ovo_step(carry, prob)
    return carry


class OvoGraphChunk:
    """The chunk on the card: ``bodies`` gated ``ovo_body``s captured once
    in a CUDA graph over the carry, replayed after the host fills
    ``limit`` until the chunk's steps are covered."""

    def __init__(self, carry: OvoCarry, prob: OvoProblem,
                 bodies: int = GRAPH_BODIES):
        self.bodies = int(bodies)
        self.limit = torch.zeros((), dtype=torch.int32,
                                 device=carry.alpha.device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), exact_f32():
            ovo_body(carry, prob, self.limit)     # limit 0: a no-op
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with capture(self.graph, program="ovo-chunk",
                     signature=compilewatch.shape_signature(prob.x)):
            for _ in range(self.bodies):
                ovo_body(carry, prob, self.limit)
        COUNTS["captures"] += 1

    def run(self, t: int, limit: int) -> None:
        self.limit.fill_(int(limit))
        replays = -(-(int(limit) - int(t)) // self.bodies)
        for _ in range(replays):
            self.graph.replay()
        COUNTS["replays"] += replays


def _read_stats(carry: OvoCarry):
    """The poll's one read: (n_iter, b_lo, b_hi) per problem from a (3, P)
    int32 tensor, the b's as bit patterns."""
    s = torch.stack([carry.n_iter, carry.b_lo.view(torch.int32),
                     carry.b_hi.view(torch.int32)]).cpu().numpy()
    COUNTS["reads"] += 1
    watchdog.pet()
    return s[0], s[1].view(np.float32), s[2].view(np.float32)


def _per_problem(values, P: int, what: str, default) -> np.ndarray:
    if values is None:
        return np.full((P,), np.float32(default))
    arr = np.asarray(values, np.float32)
    if arr.shape != (P,):
        raise ValueError(f"{what}_values must have shape ({P},), got "
                         f"{arr.shape}")
    if not (np.all(np.isfinite(arr)) and np.all(arr > 0)):
        # (isfinite matters: NaN/inf pass a bare > 0 test and train a
        # silently "converged" empty model)
        raise ValueError(f"every {'C' if what == 'c' else what} in "
                         f"{what}_values must be a finite number > 0")
    return arr


def build_ovo_problem(x: np.ndarray, yb: np.ndarray, valid: np.ndarray,
                      config: SVMConfig, device: torch.device,
                      c_values: Optional[np.ndarray] = None,
                      gamma_values: Optional[np.ndarray] = None
                      ) -> OvoProblem:
    """The batch's device-side inputs (see ``train_ovo_batched`` for the
    per-problem ``c_values`` and ``gamma_values``)."""
    n, d = x.shape
    P = yb.shape[0]
    spec = config.kernel_spec(d)
    c_arr = _per_problem(c_values, P, "c", config.c)
    g_arr = _per_problem(gamma_values, P, "gamma",
                         config.resolve_gamma(d))
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    stored = np.asarray(x, np.float32)
    if config.matmul_precision == "default":
        xd = xd.to(torch.bfloat16).contiguous()
        stored = xd.float().cpu().numpy()
    ybd = torch.from_numpy(np.asarray(yb, np.float32)).to(device)
    c_d = torch.from_numpy(c_arr).to(device)
    up, low = box_sides(ybd, c_d[:, None])
    g_d = torch.from_numpy(g_arr).to(device)
    return OvoProblem(
        x=xd, yb=ybd,
        x2=torch.from_numpy(host_row_stats(stored, spec)).to(device),
        valid=torch.from_numpy(np.asarray(valid, bool)).to(device), c=c_d,
        up_side=up, low_side=low, g2=torch.cat([g_d, g_d])[:, None],
        spec=spec, two_eps=float(np.float32(2.0 * config.epsilon)),
        max_iter=int(config.max_iter),
        pairwise=config.clip == "pairwise")


def train_ovo_batched(x: np.ndarray, yb: np.ndarray, valid: np.ndarray,
                      config: SVMConfig,
                      device: Optional[torch.device] = None,
                      c_values: Optional[np.ndarray] = None,
                      gamma_values: Optional[np.ndarray] = None,
                      plain: bool = False,
                      carry: Optional[OvoCarry] = None) -> List[TrainResult]:
    """Train the (P, n) batch; one TrainResult per subproblem, each with
    the full-length (n,) alpha (zeros off the subproblem: callers compact
    with their own row masks).

    ``c_values`` (P,) gives each subproblem its own box bound (default
    config.c); ``gamma_values`` (P,) its own gamma (default the config's
    resolved gamma), and each result reports its gamma. ``device`` None
    means the GPU; ``plain`` runs the eager loop on any device (the
    reference the graph is held against). ``carry`` is a fresh
    ``init_ovo_carry`` of the targets on the device, for a caller that
    reads the final (alpha, f) from it: the graph updates it in place."""
    from dpsvm_tpu_torch.device import resolve_device

    config.validate()
    P, d = yb.shape[0], x.shape[1]
    c_values = _per_problem(c_values, P, "c", config.c)
    gamma_values = _per_problem(gamma_values, P, "gamma",
                                config.resolve_gamma(d))
    dev = resolve_device(device)
    t0 = time.perf_counter()
    prob = build_ovo_problem(x, yb, valid, config, dev, c_values,
                             gamma_values)
    g_arr = gamma_values
    if carry is None:
        carry = init_ovo_carry(prob.yb)
    if dev.type == "cuda" and not plain:
        graph = OvoGraphChunk(carry, prob)

        def advance(cr, t, limit):
            graph.run(t, limit)
            return cr
    else:
        def advance(cr, t, limit):
            with exact_f32():
                return run_ovo_plain(cr, prob, limit)

    eps = float(config.epsilon)
    chunk = int(config.chunk_iters)
    # every problem freezes after max_iter of its own steps, so max_iter
    # batched steps bound the run
    budget = int(config.max_iter)
    limit = min(chunk, budget)
    carry = advance(carry, 0, limit)
    while True:
        n_iter, b_lo, b_hi = _read_stats(carry)
        done = ~gap_open(b_lo, b_hi, 2.0 * eps)
        capped = n_iter >= budget
        limit_next = min(limit + chunk, budget)
        if np.all(done | capped) or limit_next == limit:
            break
        if (config.wall_budget_s
                and time.perf_counter() - t0 > config.wall_budget_s):
            # the JAX loop has the next chunk in flight when its budget
            # trips and returns that chunk's carry: run it, and report it
            carry = advance(carry, limit, limit_next)
            n_iter, b_lo, b_hi = _read_stats(carry)
            done = ~gap_open(b_lo, b_hi, 2.0 * eps)
            break
        carry = advance(carry, limit, limit_next)
        limit = limit_next

    train_seconds = time.perf_counter() - t0
    alpha_all = carry.alpha.cpu().numpy()
    return [TrainResult(
        alpha=alpha_all[p],
        b=(float(b_lo[p]) + float(b_hi[p])) / 2.0,
        n_iter=int(n_iter[p]),
        converged=bool(done[p]),
        b_lo=float(b_lo[p]),
        b_hi=float(b_hi[p]),
        train_seconds=train_seconds,    # one program: wall clock is
        gamma=float(g_arr[p]),          # per batch, not per problem
        n_sv=int(np.sum(alpha_all[p] > 0)),
        kernel=config.kernel,
        coef0=float(config.coef0),
        degree=int(config.degree)) for p in range(P)]


def validate_c_grid(cs, config: SVMConfig, gammas=None):
    """Shared validation of the grid-sweep entry points (``train_c_sweep``,
    ``models/cv.cross_validate_c_sweep``). Returns (cs, gammas) as the
    float32 arrays trained with, gammas None when not swept."""
    if config.kernel == "precomputed":
        # The batched step computes kernel rows from X (matmul +
        # epilogue); the precomputed gather path is not wired into it.
        raise ValueError("the batched C-sweep does not support the "
                         "precomputed kernel; fit each C with "
                         "api.fit instead")
    cs = np.asarray(cs, np.float32)
    if cs.ndim != 1 or len(cs) == 0:
        raise ValueError(f"cs must be a non-empty 1-D list of C values, "
                         f"got shape {cs.shape}")
    if not (np.all(np.isfinite(cs)) and np.all(cs > 0)):
        raise ValueError("every C must be a finite number > 0 "
                         "(after float32 cast)")
    if gammas is None:
        return cs, None
    if config.kernel == "linear":
        # gamma does not enter the linear kernel: a gamma axis would
        # train identical copies and report a made-up best gamma
        raise ValueError("the linear kernel has no gamma; drop the "
                         "gamma axis of the sweep")
    gammas = np.asarray(gammas, np.float32)
    if gammas.ndim != 1 or len(gammas) == 0:
        raise ValueError(f"gammas must be a non-empty 1-D list, got "
                         f"shape {gammas.shape}")
    if not (np.all(np.isfinite(gammas)) and np.all(gammas > 0)):
        raise ValueError("every gamma must be a finite number > 0 "
                         "(after float32 cast)")
    return cs, gammas


def train_c_sweep(x: np.ndarray, y: np.ndarray, cs,
                  config: SVMConfig,
                  device: Optional[torch.device] = None,
                  gammas=None, plain: bool = False) -> List[TrainResult]:
    """Train the same binary problem at every point of a C (x gamma) grid
    in one batched program. ``y`` is +/-1. Without ``gammas``: one result
    per C in input order; with them the product grid in row-major (C,
    gamma) order, index i * len(gammas) + j for (cs[i], gammas[j]).
    config.c is ignored in favour of ``cs``."""
    x = np.asarray(x)
    batched_guard(config, "C-sweep", [(x.shape[0], x.shape[1])])
    cs, gammas = validate_c_grid(cs, config, gammas)
    y = np.asarray(y, np.float32)
    bad = set(np.unique(y)) - {1.0, -1.0}
    if bad:
        raise ValueError(f"train_c_sweep takes +/-1 labels, got extra "
                         f"values {sorted(bad)}")
    if gammas is None:
        c_values, gamma_values = cs, None
    else:
        c_values = np.repeat(cs, len(gammas))
        gamma_values = np.tile(gammas, len(cs))
    P = len(c_values)
    yb = np.tile(y, (P, 1))
    valid = np.ones((P, len(y)), bool)
    return train_ovo_batched(x, yb, valid, config, device=device,
                             c_values=c_values, gamma_values=gamma_values,
                             plain=plain)
