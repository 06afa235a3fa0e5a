"""Primal linear solver for feature-mapped problems (port of
``dpsvm_tpu/approx/primal.py``).

With an explicit feature map (approx/features.py) the kernel SVM is a
linear model over phi(x), solved in the primal:

    SVC:  min_w  lam/2 ||w||^2 + (1/n) sum_i r_i max(0, 1 - y_i f_i)^2
    SVR:  min_w  lam/2 ||w||^2 + (1/n) sum_i r_i max(0, |f_i - y_i| - p)^2

with f_i = phi_i.w (the bias a constant last feature, not regularized),
lam = 1/(C n), r_i the class weights and p the SVR tube half-width. The
optimizer is the JAX package's, step for step: Nesterov momentum 0.9 at
step 1/L from a known smoothness bound (the trace bound over minibatches,
a seeded power iteration's spectral bound in full-batch mode), a step
factor that halves when a refresh of the exact gradient norm fails to
beat the best one, and, in full-batch mode, the gradient restart. The
metric the host loop polls is that exact gradient's L2 norm: ``b_lo`` =
metric, ``b_hi`` = 0, so the host loop's gap test is ``metric <= 2 eps``;
``n_sv`` is the last step's margin violators.

``shards > 1`` (or a process group) takes full-batch steps on
row-sharded features, as the JAX package's sharded path does: every rank
featurizes its contiguous share of the shuffled rows, the step size's
statistics (the squared-norm sum and each power-iteration product) are
summed over the ranks, and a step's gradient and margin violators are
one all-reduce (``parallel/mesh.all_sum_``); every rank then takes the
same update from the same replicated sums.

Problems of ``_FULLBATCH_ROWS`` rows or more take full-batch steps: each
is two matrix-vector products over the (n_pad, D + 1) feature matrix (a
pass over it to f = phi u, a pass back to phi' g), so a step is
memory-bound and its floor is two reads of phi. Below that, contiguous
minibatches of a shuffled-once phi, picked by n_iter on the device.

The feature matrix is built on the device (``featurize_padded``) and
stays there: the JAX package takes it to the host and puts it back, which
at 10^6 rows is a 4.1 GB round trip. The step size's statistics (the mean
squared feature norm and the power iteration) are computed on the device
too, from the JAX package's seeded start vector, so ``big_l`` agrees with
the JAX package's to float32 rounding, not bit for bit: trajectories
agree across packages to a tolerance, not bitwise.

The JAX package runs a chunk as one ``lax.while_loop``. Here, on the card,
a chunk is a captured CUDA graph of ``GRAPH_BODIES`` gated bodies (the
pattern of ``solver/smo.py``'s ``GraphChunk``): each body tests
``metric > 2 eps and n_iter < limit`` on the device and writes through
``torch.where``, so a body past the end leaves the carry bit for bit as it
was (it still runs its two products). The minibatch's metric refresh,
a ``lax.cond`` there, computes both sides and selects one, since the
card's PyTorch has no conditional graph node (cheap: minibatch mode only
runs below 2048 rows). The plain version is the same step in an eager
loop that tests the condition on the host: the CPU's path and the
reference the graph is held against. The trajectory is a pure function
of the carry, so a run resumes bitwise from any checkpoint wherever its
chunks began. ``COUNTS`` counts captures (one a fit on the card), replays
and the poll's packed-stats reads (one a chunk); ``RUN`` records the last
fit's set-up and, on the card, the device milliseconds of its graph
replays and the bodies they ran (CUDA events around each chunk's
replays, read at the poll): ``graph_ms / graph_bodies`` is a step's
time.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dpsvm_tpu_torch.approx.features import (FeatureMap, build_feature_map,
                                             featurize_padded)
from dpsvm_tpu_torch.approx.model import ApproxSVMModel
from dpsvm_tpu_torch.config import SENTINEL, SVMConfig, TrainResult
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.observability import compilewatch
from dpsvm_tpu_torch.ops.kernels import exact_f32
from dpsvm_tpu_torch.parallel.mesh import (all_gather, all_sum_,
                                           make_data_mesh, shard_probe)
from dpsvm_tpu_torch.solver.driver import (ChunkStats, Poll, copy_carry_,
                                           host_training_loop, pack_stats,
                                           read_stats, resume_state)
from dpsvm_tpu_torch.solver.smo import capture, two_eps_f32
from dpsvm_tpu_torch.utils import densify

# Minibatch rows per step below _FULLBATCH_ROWS rows, and the row count
# from which steps are full-batch (the JAX package's constants).
_BATCH = 1024
_FULLBATCH_ROWS = 2048
# Power-iteration steps for the spectral curvature estimate.
_POWER_ITERS = 24
# Minibatch mode refreshes the exact metric every _CHECK_EPOCHS epochs.
_CHECK_EPOCHS = 4
_MOMENTUM = 0.9

# Bodies in one captured graph; a chunk replays it until its iterations
# are covered.
GRAPH_BODIES = 16

# Ever, in this process: graphs captured, replays enqueued, and the
# packed-stats reads of the polls (one a chunk).
COUNTS = {"captures": 0, "replays": 0, "reads": 0}
# The last fit's set-up: shapes, step-size statistics, where phi lives and
# the seconds its build took.
RUN: dict = {}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class PrimalCarry(NamedTuple):
    w: object           # (Dp,) f32 weights (bias = last entry)
    v: object           # (Dp,) f32 momentum
    metric: object      # () f32 exact ||grad||_2 at the last refresh
                        # (SENTINEL = not yet evaluated)
    best: object        # () f32 best refreshed metric (plateau reference)
    lrf: object         # () f32 adaptive step factor
    n_iter: object      # () i32
    nact: object        # () i32 margin violators in the last step's rows


def init_carry(dp: int) -> PrimalCarry:
    """The starting carry as host NumPy values."""
    return PrimalCarry(
        w=np.zeros((dp,), np.float32),
        v=np.zeros((dp,), np.float32),
        metric=np.float32(SENTINEL),
        best=np.float32(SENTINEL),
        lrf=np.float32(1.0),
        n_iter=np.int32(0),
        nact=np.int32(0),
    )


def pack_state(carry_host: PrimalCarry) -> Tuple[np.ndarray, np.ndarray]:
    """Carry -> the checkpoint's (alpha, f) slots: alpha = w, f = [v,
    metric, best, lrf], everything the trajectory is a function of (the
    JAX package's layout, so checkpoints resume in either package)."""
    w = np.asarray(carry_host.w, np.float32)
    f = np.concatenate([
        np.asarray(carry_host.v, np.float32),
        np.asarray([float(carry_host.metric), float(carry_host.best),
                    float(carry_host.lrf)], np.float32),
    ])
    return w, f


def unpack_state(ck, dp: int) -> PrimalCarry:
    """Checkpoint slots -> carry (pack_state's inverse)."""
    f = np.asarray(ck.f, np.float32)
    if ck.alpha.shape != (dp,) or f.shape != (dp + 3,):
        raise ValueError(
            f"checkpoint state shapes {ck.alpha.shape}/{f.shape} do not "
            f"match this problem's packed dim {dp} — was it written by "
            "a different approx_dim?"
            + (" (shape dp + 4 is a LIVE streaming checkpoint; resume "
               "it with fit_approx_stream(live=True))"
               if f.shape == (dp + 4,) else ""))
    return PrimalCarry(
        w=np.asarray(ck.alpha, np.float32),
        v=f[:dp].copy(),
        metric=np.float32(f[dp]),
        best=np.float32(f[dp + 1]),
        lrf=np.float32(f[dp + 2]),
        n_iter=np.int32(ck.n_iter),
        nact=np.int32(0),
    )


def pack_state_live(carry_host: PrimalCarry, generation: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """A live streaming checkpoint's slots: ``pack_state`` plus one lane
    carrying the shard-log generation the trajectory had consumed, so a
    killed live run resumes with exactly the shard set it had admitted
    (generations are small integers, exact in float32)."""
    w, f = pack_state(carry_host)
    return w, np.concatenate(
        [f, np.asarray([np.float32(generation)], np.float32)])


def unpack_state_live(ck, dp: int) -> Tuple[PrimalCarry, int]:
    """(carry, consumed generation) from a live streaming checkpoint
    (``pack_state_live``'s inverse)."""
    f = np.asarray(ck.f, np.float32)
    if ck.alpha.shape != (dp,) or f.shape != (dp + 4,):
        raise ValueError(
            f"live checkpoint state shapes {ck.alpha.shape}/{f.shape} "
            f"do not match packed dim {dp} + the generation lane — "
            "written by a frozen-stream run (resume with live=False) "
            "or a different approx_dim?")
    carry = PrimalCarry(
        w=np.asarray(ck.alpha, np.float32),
        v=f[:dp].copy(),
        metric=np.float32(f[dp]),
        best=np.float32(f[dp + 1]),
        lrf=np.float32(f[dp + 2]),
        n_iter=np.int32(ck.n_iter),
        nact=np.int32(0),
    )
    return carry, int(f[dp + 3])


def warm_start_vector(model: ApproxSVMModel) -> np.ndarray:
    """The packed (dp,) primal weight vector of an approx model: the
    ``init_w`` a warm-started (re)train starts from (the bias rides as
    the last lane; the model stores ``b = -w[-1]``)."""
    return np.concatenate([np.asarray(model.w, np.float32),
                           np.asarray([-float(model.b)], np.float32)])


def _apply_init_w(carry: PrimalCarry, init_w, dp: int) -> PrimalCarry:
    iw = np.asarray(init_w, np.float32)
    if iw.shape != (dp,):
        raise ValueError(
            f"init_w must be ({dp},) — the packed weight vector "
            "including the bias lane (warm_start_vector(model)); got "
            f"shape {iw.shape}")
    if not np.isfinite(iw).all():
        raise ValueError("init_w holds non-finite values")
    return carry._replace(w=iw.copy())


def carry_to_device(c: PrimalCarry, device) -> PrimalCarry:
    """Device tensors the carry owns (the graph updates them in place)."""
    def t(v, dtype):
        return torch.tensor(np.asarray(v, dtype), device=device)
    return PrimalCarry(w=t(c.w, np.float32), v=t(c.v, np.float32),
                       metric=t(c.metric, np.float32),
                       best=t(c.best, np.float32),
                       lrf=t(c.lrf, np.float32),
                       n_iter=t(c.n_iter, np.int32),
                       nact=t(c.nact, np.int32))


def carry_to_host(c: PrimalCarry) -> PrimalCarry:
    return PrimalCarry(*(np.asarray(v.cpu().numpy()) for v in c))


@dataclasses.dataclass
class PrimalProblem:
    """The device-side inputs of a run: the padded feature matrix (bias
    lane last), labels and row weights (0 on pad rows), and the step's
    constants as float32 0-d tensors (read by the graph, never copied
    from the host inside it)."""
    phi: torch.Tensor       # (n_pad, dp) f32
    y: torch.Tensor         # (n_pad,) f32
    rw: torch.Tensor        # (n_pad,) f32
    reg_mask: torch.Tensor  # (dp,) f32: 0 on the bias lane
    denom: torch.Tensor     # () data-term divisor n / n_batches
    n_real: torch.Tensor    # () n
    lam: torch.Tensor       # () 1 / (C n)
    lr: torch.Tensor        # () 1 / big_l
    n_batches: int
    batch: int
    task: str
    svr_eps: float
    two_eps: float          # 2 eps as the float32 the condition adds
    mesh: object = None     # parallel.mesh.DataMesh of a sharded run: phi,
                            # y and rw hold this rank's rows

    @property
    def check_every(self) -> int:
        return 1 if self.n_batches == 1 else _CHECK_EPOCHS * self.n_batches

    @property
    def adapt_every(self) -> int:
        # The full-batch decay window is longer: momentum descent is not
        # monotone step to step (the JAX package's reasoning).
        return 256 if self.n_batches == 1 else self.check_every


def residual_grad(prob: PrimalProblem, f, yb, rb):
    """Per-row dLoss/df (weighted; 0 on pad rows) and the activity mask."""
    if prob.task == "svr":
        r = f - yb
        z = r.abs() - prob.svr_eps
        act = z > 0
        return torch.where(act, 2.0 * torch.sign(r) * z, 0.0) * rb, act
    z = 1.0 - yb * f
    act = z > 0
    return torch.where(act, -2.0 * z * yb, 0.0) * rb, act


def exact_metric(prob: PrimalProblem, w) -> torch.Tensor:
    """||grad||_2 of the full objective at w (minibatch refreshes)."""
    gg, _ = residual_grad(prob, torch.matmul(prob.phi, w), prob.y, prob.rw)
    full = (torch.matmul(gg, prob.phi) / prob.n_real
            + prob.lam * w * prob.reg_mask)
    return torch.sqrt(torch.sum(full * full))


def primal_step(s: PrimalCarry, prob: PrimalProblem) -> PrimalCarry:
    """One step as a new carry (the JAX runner's ``body``, op for op).
    Reads nothing back to the host."""
    beta = _MOMENTUM
    if prob.n_batches == 1:
        pb, yb, rb = prob.phi, prob.y, prob.rw
    else:
        k = torch.remainder(s.n_iter, prob.n_batches).reshape(1)
        pb = prob.phi.view(prob.n_batches, prob.batch, -1).index_select(
            0, k)[0]
        yb = prob.y.view(prob.n_batches, prob.batch).index_select(0, k)[0]
        rb = prob.rw.view(prob.n_batches, prob.batch).index_select(0, k)[0]
    # Nesterov: the gradient at the lookahead point w + beta v.
    u = s.w + beta * s.v
    g, act = residual_grad(prob, torch.matmul(pb, u), yb, rb)
    gp = torch.matmul(g, pb)
    nact = torch.sum(act & (rb > 0), dtype=torch.int32)
    if prob.mesh is not None:
        # the global product: this rank's rows' share and its violators,
        # summed over the ranks in one all-reduce (exact counts below
        # 2^24 rows)
        packed = torch.cat([gp, nact.to(torch.float32).reshape(1)])
        all_sum_(prob.mesh, packed)
        gp, nact = packed[:-1], packed[-1].to(torch.int32)
    grad = gp / prob.denom + prob.lam * u * prob.reg_mask
    return descend(s, prob, grad, nact)


def descend(s: PrimalCarry, prob: PrimalProblem, grad,
            nact) -> PrimalCarry:
    """The step from the objective's gradient at the lookahead point:
    momentum, the metric (and, in full-batch mode, the gradient restart),
    the plateau decay. Shared by ``primal_step`` and the streaming fit's
    update, whose gradient is summed shard by shard."""
    beta = _MOMENTUM
    v = beta * s.v - (prob.lr * s.lrf) * grad
    w = s.w + v
    t = s.n_iter + 1
    if prob.n_batches == 1:
        # Full batch: grad is the exact objective gradient; restart the
        # momentum when it points uphill.
        metric = torch.sqrt(torch.sum(grad * grad))
        v = torch.where(torch.dot(grad, v) > 0, torch.zeros_like(v), v)
    else:
        # lax.cond there; both sides here, one selected
        metric = torch.where(torch.remainder(t, prob.check_every) == 0,
                             exact_metric(prob, w), s.metric)
    refresh = torch.remainder(t, prob.adapt_every) == 0
    fresh = s.best >= float(np.float32(SENTINEL) * np.float32(0.5))
    decay = refresh & ~fresh & (metric >= s.best)
    lrf = torch.clamp_min(torch.where(decay, s.lrf * 0.5, s.lrf),
                          1.0 / 4096.0)
    best = torch.where(refresh, torch.minimum(s.best, metric), s.best)
    return PrimalCarry(w=w, v=v, metric=metric, best=best, lrf=lrf,
                       n_iter=t, nact=nact)


def live(s: PrimalCarry, prob: PrimalProblem, limit) -> torch.Tensor:
    """The loop condition on the device: metric > 2 eps (float32) and
    n_iter below ``limit``."""
    return (s.metric > prob.two_eps) & (s.n_iter < limit)


def primal_body(s: PrimalCarry, prob: PrimalProblem,
                limit: torch.Tensor) -> None:
    """``primal_step`` in place, gated on ``live``: when the condition is
    false every write puts back what it read (the graph's body)."""
    go = live(s, prob, limit)
    new = primal_step(s, prob)
    for old, val in zip(s[:-2], new[:-2]):
        old.copy_(torch.where(go, val, old))
    s.nact.copy_(torch.where(go, new.nact, s.nact))
    s.n_iter.add_(go.to(torch.int32))


def run_chunk_plain(s: PrimalCarry, prob: PrimalProblem,
                    limit: int) -> PrimalCarry:
    """The chunk as an eager loop: ``primal_step`` while the condition,
    read on the host before each step, holds."""
    while bool(live(s, prob, limit)):
        s = primal_step(s, prob)
    return s


class GraphChunk:
    """The chunk on the card: ``bodies`` gated bodies captured once in a
    CUDA graph over the carry's tensors, replayed ceil(iterations /
    bodies) times after the host fills ``limit``."""

    def __init__(self, carry: PrimalCarry, prob: PrimalProblem,
                 bodies: int = GRAPH_BODIES):
        self.bodies = int(bodies)
        self.limit = torch.zeros((), dtype=torch.int32,
                                 device=carry.w.device)
        # Warm up (cuBLAS handles, workspaces) on a side stream with limit
        # 0: the body is a no-op.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), exact_f32():
            primal_body(carry, prob, self.limit)
        torch.cuda.current_stream().wait_stream(side)
        if prob.mesh is not None:   # the NCCL communicator is up
            torch.cuda.synchronize(carry.w.device)
        self.graph = torch.cuda.CUDAGraph()
        with capture(self.graph, program="primal-chunk",
                     signature=compilewatch.shape_signature(prob.phi)):
            for _ in range(self.bodies):
                primal_body(carry, prob, self.limit)
        COUNTS["captures"] += 1
        # CUDA events around each run's replays: the device time of the
        # bodies, read once the poll has synchronised
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def run(self, n_iter: int, limit: int) -> int:
        self.limit.fill_(int(limit))
        replays = max(0, -(-(int(limit) - int(n_iter)) // self.bodies))
        self.events[0].record()
        for _ in range(replays):
            self.graph.replay()
        self.events[1].record()
        COUNTS["replays"] += replays
        return replays


def _stats(s: PrimalCarry, mesh=None) -> torch.Tensor:
    """The poll's packed stats: [n_iter, metric bits, 0.0 bits, nact, 0],
    and on a mesh every rank's probe row after them (one all-gather): the
    desync check and shard heartbeats of ``solver/driver``."""
    zero = torch.zeros_like(s.metric)
    stats = pack_stats(s.n_iter, s.metric.view(torch.int32),
                       zero.view(torch.int32), s.nact,
                       torch.zeros_like(s.n_iter))
    if mesh is None:
        return stats
    probes = all_gather(mesh, shard_probe(s.n_iter, s.metric, zero))
    return torch.cat([stats, probes.reshape(-1)])


def make_chunk_runner(carry: PrimalCarry, prob: PrimalProblem,
                      plain: bool = False):
    """``step(carry, limit) -> (carry, poll)`` for
    ``host_training_loop``: the captured graph on the card, the eager loop
    on the CPU (or anywhere, with ``plain``); ``poll`` (a ``driver.Poll``)
    makes the chunk's one read. ``step.carry`` is the carry after the last
    chunk."""
    state = {"n_iter": int(carry.n_iter), "bodies": 0}
    chunk = None
    mesh = prob.mesh
    # a graph holds NCCL collectives, not gloo's (host-staged) ones
    if carry.w.is_cuda and not plain and (mesh is None
                                          or mesh.backend == "nccl"):
        chunk = GraphChunk(carry, prob)
        RUN.update(graph_ms=0.0, graph_bodies=0)

        def advance(cr, limit):
            state["bodies"] = (chunk.run(state["n_iter"], limit)
                               * chunk.bodies)
            return cr
    else:
        def advance(cr, limit):
            with exact_f32():
                return run_chunk_plain(cr, prob, limit)

    def step(cr: PrimalCarry, limit: int):
        cr = advance(cr, limit)
        stats = _stats(cr, mesh)

        def poll() -> ChunkStats:
            st: ChunkStats = read_stats(stats, 0 if mesh is None
                                        else mesh.size)
            COUNTS["reads"] += 1
            if chunk is not None:  # the read synchronised: events are done
                RUN["graph_ms"] += chunk.events[0].elapsed_time(
                    chunk.events[1])
                RUN["graph_bodies"] += state["bodies"]
            state["n_iter"] = st.n_iter
            return st
        step.carry = cr
        return cr, Poll(poll)

    step.carry = carry
    step.state = state      # the last poll's n_iter (a rollback resets it)
    return step


def _power_lambda_max(phi: torch.Tensor, n: int, mesh=None) -> float:
    """lambda_max((1/n) Phi'Phi) by seeded power iteration on the device,
    from the JAX package's start vector (pad rows are zero, so they drop
    out). Deterministic, so the step size and the trajectory are a pure
    function of the config and the data. On a mesh ``phi`` is this rank's
    rows and each product Phi'(Phi v) is summed over the ranks, so every
    rank iterates on the same vector."""
    rng = np.random.default_rng(0)
    v0 = rng.standard_normal(phi.shape[1]).astype(np.float32)
    v0 /= np.linalg.norm(v0)
    v = torch.from_numpy(v0).to(phi.device)
    nf = torch.tensor(np.float32(n), device=phi.device)
    lmax = 0.0
    with exact_f32():
        for _ in range(_POWER_ITERS):
            w = torch.matmul(torch.matmul(phi, v), phi)
            if mesh is not None:
                all_sum_(mesh, w)
            w = w / nf
            norm = torch.linalg.vector_norm(w)
            lmax = float(norm)
            if lmax <= 0.0:            # all-zero features: regularizer only
                return 0.0
            v = w / norm
    return lmax


def _check_svc_labels(y: np.ndarray) -> np.ndarray:
    labels = np.unique(y)
    if not np.all(np.isin(labels, (-1, 1))):
        raise ValueError(
            f"labels must be +/-1 for binary training, got "
            f"{labels[:10]} — for multi-class data use "
            "models.multiclass.train_multiclass (CLI: train --multiclass)")
    return np.asarray(y, np.float32)


def build_problem(x: np.ndarray, yv: np.ndarray, config: SVMConfig,
                  task: str, fmap: FeatureMap, device: torch.device,
                  mesh=None) -> PrimalProblem:
    """Shuffle once (seeded by approx_seed), featurize on the device with
    the bias lane, and derive the step size (the JAX package's
    ``fit_approx`` set-up). With ``mesh`` (a sharded run) the steps are
    full batch: the shuffled rows are padded to a multiple of the ranks,
    each rank featurizes its contiguous share, and the step size's
    statistics are summed over the ranks."""
    n = x.shape[0]
    dp = fmap.dim + 1
    if mesh is not None:
        batch = n_pad = -(-n // mesh.size) * mesh.size
    elif n >= _FULLBATCH_ROWS:
        batch = n_pad = -(-n // 256) * 256
    else:
        batch = min(_BATCH, 1 << (n - 1).bit_length())
        n_pad = -(-n // batch) * batch
    # Contiguous minibatches over class-sorted input would be class-pure:
    # shuffle once, deterministically.
    perm = np.random.default_rng(config.approx_seed).permutation(n)
    # this process's rows of the shuffled, padded problem
    lo, n_loc = ((0, n_pad) if mesh is None
                 else (mesh.rank * (n_pad // mesh.size),
                       n_pad // mesh.size))
    t0 = time.perf_counter()
    phi, sq = featurize_padded(fmap, x, n_loc, rows=perm[lo:lo + n_loc],
                               bias=True, device=device,
                               precision=config.matmul_precision)
    if mesh is not None:
        sq = float(all_sum_(mesh, torch.tensor(sq, dtype=torch.float64,
                                               device=device)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_feat = time.perf_counter() - t0
    # Mean squared feature-row norm over real rows, + the bias lane's 1:
    # the curvature bound behind the tuning-free step size.
    msq = sq / n + 1.0
    lam = 1.0 / (float(config.c) * n)
    maxrw = (max(float(config.weight_pos), float(config.weight_neg))
             if task == "svc" else 1.0)
    lmax = None
    if batch == n_pad:
        # Full batch: the spectral estimate (converges from below; the 1.1
        # margin and the plateau decay cover the rest), the trace bound
        # as a ceiling.
        lmax = _power_lambda_max(phi, n, mesh)
        curv = min(msq, 1.1 * lmax)
    else:
        # Every slice's data Hessian has trace at most (n_pad/n) msq.
        curv = msq * (n_pad / n)
    big_l = lam + 2.0 * maxrw * curv
    y_s = yv[perm]
    yp = np.zeros((n_pad,), np.float32)
    yp[:n] = y_s
    rw = np.zeros((n_pad,), np.float32)
    if task == "svc":
        rw[:n] = np.where(y_s > 0, np.float32(config.weight_pos),
                          np.float32(config.weight_neg))
    else:
        rw[:n] = 1.0
    yp, rw = yp[lo:lo + n_loc], rw[lo:lo + n_loc]
    reg_mask = np.ones((dp,), np.float32)
    reg_mask[-1] = 0.0

    def f32(v):
        return torch.tensor(np.float32(v), device=device)

    n_batches = n_pad // batch
    RUN.clear()
    RUN.update(n_pad=n_pad, shards=1 if mesh is None else mesh.size,
               lmax=lmax, big_l=big_l, msq=msq,
               phi_device=str(phi.device), phi_shape=tuple(phi.shape),
               phi_bytes=int(phi.numel() * phi.element_size()),
               featurize_seconds=t_feat)
    return PrimalProblem(
        phi=phi, y=torch.from_numpy(yp).to(device),
        rw=torch.from_numpy(rw).to(device),
        reg_mask=torch.from_numpy(reg_mask).to(device),
        denom=f32(n / n_batches), n_real=f32(n), lam=f32(lam),
        lr=f32(1.0 / big_l), n_batches=n_batches, batch=batch, task=task,
        svr_eps=float(np.float32(config.svr_epsilon)),
        two_eps=two_eps_f32(config.epsilon), mesh=mesh)


def fit_approx(x: np.ndarray, y: np.ndarray,
               config: Optional[SVMConfig] = None,
               task: str = "svc", *, init_w=None, device=None,
               plain: bool = False, group=None
               ) -> Tuple[ApproxSVMModel, TrainResult]:
    """Featurize + primal-solve; the approx path's ``api.fit``.

    Returns ``(ApproxSVMModel, TrainResult)``: the result's ``b_lo`` /
    ``b_hi`` carry the final (metric, 0) pair, so its ``gap`` is the
    gradient-norm metric, and ``n_sv`` counts the last step's margin
    violators (there is no SV set). ``init_w`` warm-starts the weights
    from a packed (dp,) vector (``warm_start_vector(model)``); a
    configured ``resume_from`` checkpoint takes precedence. ``device``
    None means the GPU; ``plain`` runs the eager loop on any device.

    ``config.shards > 1`` (or a ``group``, which then overrides it) trains
    over the ranks of a ``torch.distributed`` group, one process a
    device, every rank called with the same full (x, y): full-batch steps
    on row-sharded features, one all-reduce of the (D + 1) gradient a
    step (``parallel/mesh.all_sum_``), every decision taken from
    replicated stats, and every rank returns the same model. On NCCL
    ranks a chunk is a captured graph with the collectives inside, on
    gloo ranks the eager loop; ``device`` is the rank's device (default:
    its CUDA device under NCCL, the CPU under gloo)."""
    config = config or SVMConfig()
    config.validate()
    if config.solver not in ("approx-rff", "approx-nystrom"):
        raise ValueError("fit_approx needs solver='approx-rff' or "
                         "'approx-nystrom'")
    if task not in ("svc", "svr"):
        raise ValueError(f"task must be 'svc' or 'svr', got {task!r}")
    x = np.asarray(densify(x), np.float32)
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {x.shape}")
    y = np.asarray(y)
    if y.shape != (x.shape[0],):
        raise ValueError(f"y must be ({x.shape[0]},), got {y.shape}")
    yv = (_check_svc_labels(y) if task == "svc"
          else np.asarray(y, np.float32))
    mesh = None
    if config.shards > 1 or group is not None:
        mesh = make_data_mesh(config.shards, group, device)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    n, d = x.shape
    gamma = float(config.resolve_gamma(d))
    spec = config.kernel_spec(d)
    kind = config.solver.split("-", 1)[1]
    fmap = build_feature_map(kind, x, config.approx_dim,
                             config.approx_seed, spec)
    dp = fmap.dim + 1                      # + bias feature
    prob = build_problem(x, yv, config, task, fmap, dev, mesh)

    carry = init_carry(dp)
    if init_w is not None:
        carry = _apply_init_w(carry, init_w, dp)
    # Checkpoint identity: (n, Dp) names the packed primal problem the way
    # (n, d) names a dual one; the map is deterministic in the config.
    ckpt = resume_state(config, n, dp, gamma,
                        shards=1 if mesh is None else mesh.size)
    if ckpt is not None:
        carry = unpack_state(ckpt, dp)
    carry = carry_to_device(carry, dev)
    step = make_chunk_runner(carry, prob, plain)

    def carry_from_ckpt(ck) -> PrimalCarry:
        # the checkpoint into the carry's tensors (the captured graph
        # keeps its buffers); the runner restarts from its n_iter
        copy_carry_(carry, carry_to_device(unpack_state(ck, dp), dev))
        step.state["n_iter"] = int(ck.n_iter)
        step.carry = carry
        return carry

    result = host_training_loop(
        config, gamma, carry, step,
        lambda c: pack_state(carry_to_host(c)),
        it0=int(ckpt.n_iter) if ckpt is not None else 0, dims=(n, dp),
        mesh=mesh, carry_from_ckpt=carry_from_ckpt)
    final = carry_to_host(step.carry)
    w_out = np.asarray(final.w, np.float32)
    model = ApproxSVMModel(fmap=fmap, w=w_out[:-1].copy(),
                           b=-float(w_out[-1]), task=task)
    result = dataclasses.replace(
        result, b=model.b, n_sv=int(final.nact), gamma=gamma,
        kernel=config.kernel, coef0=float(config.coef0),
        degree=int(config.degree))
    return model, result


class _ShardReader:
    """The streaming fit's shard reads: ``passes()`` yields (k, None for a
    quarantined shard, else ``prepare(k, x, y)`` of its verified read) for
    every shard in manifest order. While the main thread copies and
    launches the device work of one shard, up to ``PREFETCH`` worker
    threads read, verify and prepare the next ones (file reads, zlib's
    CRC, NumPy's reductions and the copies into pinned memory release the
    GIL), so the host holds at most that many shard blocks more. The host
    seconds of the reads (``read_s``, summed over the workers) and of the
    main thread's waits for them (``wait_s``) are booked."""

    PREFETCH = 4

    def __init__(self, ds, policy: str, allow_nonfinite: bool, prepare):
        self.ds, self.policy, self.allow = ds, policy, allow_nonfinite
        self.prepare = prepare
        self.read_s = self.wait_s = 0.0
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(self.PREFETCH)
        self._futs = collections.deque()
        self._next = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # reads of a pass that will not come: the unstarted ones cancelled
        self._pool.shutdown(wait=True, cancel_futures=True)

    def _read(self, k: int):
        t0 = time.perf_counter()
        got = self.ds.read_shard_checked(k, on_bad_shard=self.policy,
                                         allow_nonfinite=self.allow)
        if got is not None:
            got = self.prepare(k, *got)
        with self._lock:
            self.read_s += time.perf_counter() - t0
        return got

    def passes(self):
        """One pass over the shards admitted when it starts. The reads run
        on ahead through the shards in cyclic order, into the next pass
        too (a step's first shards are read while the last ones are
        consumed), a window of at most n_shards - 1 reads: a shard's next
        read starts only after its last one was consumed. The cursor is a
        shard index below the pass's count, so the reads never pass the
        admitted list: a live log's view grows only between passes, and
        shards it admits join the next pass in manifest order after the
        ones read ahead."""
        n = self.ds.n_shards
        window = max(1, min(self.PREFETCH, n - 1))
        for _ in range(n):
            while len(self._futs) < window:
                k = self._next
                self._futs.append((k, self._pool.submit(self._read, k)))
                self._next = (k + 1) % n
            k, fut = self._futs.popleft()
            t0 = time.perf_counter()
            got = fut.result()
            self.wait_s += time.perf_counter() - t0
            yield k, got


def _pinned(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor to copy from: pinned for the card (the
    copy is then asynchronous, and the host reads and verifies the next
    shard meanwhile), as it is for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


def fit_approx_stream(ds, config: Optional[SVMConfig] = None,
                      task: str = "svc", allow_nonfinite: bool = False, *,
                      live: Optional[bool] = None, init_w=None, watcher=None,
                      device=None) -> Tuple[ApproxSVMModel, TrainResult]:
    """Featurize + primal-solve a ``data.stream.ShardedDataset`` that never
    fully materializes: the out-of-core path (JAX
    ``approx/primal.fit_approx_stream``).

    Deterministic full-batch gradient steps: each step streams every live
    shard, in manifest order, through a verified read on the host
    (``read_shard_checked``: CRC and finiteness, every step; worker
    threads read a few shards ahead, ``_ShardReader``), a copy of its
    rows to the device through pinned memory, featurization there and the accumulation of
    its part of the gradient at the lookahead point; the update is the
    in-memory full-batch move (``descend``), gated on the device on
    ``metric > 2 eps and n_iter < limit``. Neither the whole of X nor phi
    is ever on the device, and no step reads anything back: the host
    loop is ``driver.host_training_loop`` with its one packed-stats read
    a chunk, so a streaming run polls exactly as often as an in-memory
    one. The step size is the JAX package's: the trace curvature bound
    from a prologue epoch that verifies every shard once (quarantine
    fires there first) and sums the squared feature norms, in float64 on
    the device; the data term's divisor stays the manifest's n when
    shards are quarantined. Resume from a checkpoint is bitwise (the
    trajectory is a function of the carry, the shard bytes and the
    manifest order). ``init_w`` warm-starts the weights.

    ``live=True`` (or ``config.live``) trains the directory as a LIVE
    shard log (``data/live.py``): before each step, a sweep boundary, a
    ``ShardLogWatcher`` (or the given ``watcher``, which must wrap ``ds``)
    polls the manifest once, on the host, and admits new durable shards
    into the run: each is read and verified once to grow the curvature
    statistic (in shard order, as the prologue does), the divisor, lam and
    the step size are rewritten in place in their device scalars from the
    admitted view (no device-to-host read: the step-size arithmetic runs
    on the device in float64, as the host's would), and the next pass
    reads the grown list. One ``ingest_grow`` event a growing boundary and
    one ``append_admitted`` a shard go through the driver's event queue.
    So a live fit reads the packed stats exactly as often as a frozen one.
    Checkpoints carry the consumed generation (``pack_state_live``): a
    resume opens the dataset at the run's entry generation
    (``ShardedDataset.open(dir, at_generation=g0)``) and re-admits exactly
    the shards the killed run had consumed before the watcher may see
    more; a frozen resume of a live checkpoint raises ``ValueError``.

    ``RUN`` records the set-up, the steps and their wall seconds, and the
    host seconds of the reads and verifies (summed over the read-ahead
    threads) and of the main thread's waits for them. The device's own
    time is torch.profiler's to measure (``chip_smoke.py``): CUDA events
    between a shard's launches would count the waits for the host too."""
    from dpsvm_tpu_torch.data import stream as streamlib

    config = config or SVMConfig()
    config.validate()
    live = bool(config.live) if live is None else bool(live)
    if config.solver == "exact":
        raise ValueError(
            "streaming training is the approx primal path (the exact "
            "dual solvers touch O(n^2) kernel state and need X "
            "materialized): use solver='approx-rff'/'approx-nystrom', "
            "or materialize the shards via data.loader.load_dataset")
    if config.solver not in ("approx-rff", "approx-nystrom"):
        raise ValueError("fit_approx_stream needs solver='approx-rff' or "
                         "'approx-nystrom' (the cascade streams through "
                         "solver/cascade.fit_cascade_stream)")
    if task not in ("svc", "svr"):
        raise ValueError(f"task must be 'svc' or 'svr', got {task!r}")
    if config.shards != 1:
        raise ValueError(
            "fit_approx_stream is single-process: the sharded "
            "full-batch path (config.shards > 1) consumes in-memory "
            "arrays — materialize, or stream on one process")
    dev = resolve_device(device)
    n, d = ds.n, ds.d
    spec = config.kernel_spec(d)
    kind = config.solver.split("-", 1)[1]
    streamlib.check_stream_budget(
        config.mem_budget_mb, n=n, d=d, rows_per_shard=ds.rows_per_shard,
        feat_dim=config.approx_dim, what=ds.directory)
    if kind == "rff":
        # The RFF map reads only the input width.
        fmap = build_feature_map("rff", np.zeros((1, d), np.float32),
                                 config.approx_dim, config.approx_seed, spec)
    else:
        # Nystrom landmarks: a seeded global subsample gathered from the
        # shards that hold them (strict integrity).
        m = min(int(config.approx_dim), n)
        rng = np.random.default_rng(config.approx_seed)
        idx = np.sort(rng.choice(n, size=m, replace=False))
        fmap = build_feature_map("nystrom", ds.gather_rows(idx), m,
                                 config.approx_seed, spec)

    def shard_lanes(k, y):
        if task == "svc":
            labels = np.unique(y)
            if not np.all(np.isin(labels, (-1, 1))):
                raise ValueError(
                    f"shard {k}: labels must be +/-1 for binary "
                    f"training, got {labels[:10]} — multiclass shard "
                    "sets train via materialization")
            yv = np.asarray(y, np.float32)
            rw = np.where(yv > 0, np.float32(config.weight_pos),
                          np.float32(config.weight_neg))
        else:
            yv = np.asarray(y, np.float32)
            rw = np.ones((len(yv),), np.float32)
        return yv, rw

    def prepare(k, x, y):
        """A worker's share of a shard: the label check, its lanes, and x
        and the lanes as host tensors to copy from."""
        return [_pinned(a, dev) for a in (x, *shard_lanes(k, y))]

    if live and watcher is None:
        from dpsvm_tpu_torch.data.live import ShardLogWatcher
        from dpsvm_tpu_torch.solver.driver import queue_trace_event
        # the absorb step below verifies (and may quarantine) every
        # admitted shard, so the watcher reads none itself
        watcher = ShardLogWatcher(
            ds, on_bad_shard=config.on_bad_shard,
            allow_nonfinite=allow_nonfinite, verify_appends=False,
            on_event=queue_trace_event)
    if watcher is not None and watcher.ds is not ds:
        raise ValueError("watcher must wrap the SAME ShardedDataset "
                         "handle this run trains on")

    with _ShardReader(ds, config.on_bad_shard, allow_nonfinite,
                      prepare) as reader:
        return _fit_stream(ds, config, task, init_w, dev, fmap, reader,
                           watcher if live else None, shard_lanes,
                           allow_nonfinite)


def _fit_stream(ds, config: SVMConfig, task: str, init_w, dev, fmap,
                reader: _ShardReader, watcher, shard_lanes,
                allow_nonfinite: bool):
    """``fit_approx_stream`` from its prologue epoch on; ``reader``
    yields each shard's (x, y lane, row-weight lane) as host tensors;
    ``watcher`` is the live run's (None: a frozen run)."""
    from dpsvm_tpu_torch.approx.features import device_map
    from dpsvm_tpu_torch.data import stream as streamlib
    from dpsvm_tpu_torch.solver.driver import queue_trace_event

    # n is the ENTRY view's row count, the run's identity (checkpoint
    # validation) even as a live log grows: a resume re-enters at the
    # same pinned view and re-admits to the checkpoint's generation.
    n = ds.n
    live = watcher is not None
    gamma = float(config.resolve_gamma(ds.d))
    dp = fmap.dim + 1
    dm = device_map(fmap, dev, config.matmul_precision)
    msq_num = torch.zeros((), dtype=torch.float64, device=dev)
    scale = {"seen": 0}

    def absorb(xt: torch.Tensor) -> None:
        # the curvature statistic over a shard's real rows, in float64 on
        # the device; shards add in index order, whether they were in the
        # entry view or admitted later (the bitwise-resume arithmetic)
        with exact_f32():
            phi = dm.block(xt.to(dev, non_blocking=True))
        msq_num.add_(phi.double().square().sum())
        scale["seen"] += xt.shape[0]

    # Prologue epoch: every shard verified once (quarantine fires here
    # first, so a run and its resume see the same live set) while the
    # squared feature norms accumulate over real rows, in shard order.
    t_pro = time.perf_counter()
    for _k, got in reader.passes():
        if got is not None:
            absorb(got[0])
    if scale["seen"] == 0:
        raise streamlib.IngestAbortError(
            f"{ds.directory}: no readable shard survived the prologue")
    maxrw = (max(float(config.weight_pos), float(config.weight_neg))
             if task == "svc" else 1.0)
    reg_mask = torch.ones((dp,), dtype=torch.float32, device=dev)
    reg_mask[-1] = 0.0

    def f32(v):
        return torch.tensor(np.float32(v), device=dev)

    prob = PrimalProblem(
        phi=None, y=None, rw=None, reg_mask=reg_mask, denom=f32(n),
        n_real=f32(n), lam=f32(0.0), lr=f32(0.0), n_batches=1,
        batch=0, task=task, svr_eps=float(np.float32(config.svr_epsilon)),
        two_eps=two_eps_f32(config.epsilon))

    def rescale() -> torch.Tensor:
        """(divisor, lam, lr) of the admitted view, written in place into
        the problem's device scalars. The divisor is the admitted
        manifest's n (quarantined rows included: the objective does not
        renormalize around lost rows); the step keeps the trace curvature
        bound, computed on the device in float64 as the host would (so
        no read) and rounded once to float32. Returns the float64
        curvature bound big_l."""
        n_live = ds.n
        lam = 1.0 / (float(config.c) * n_live)
        big_l = lam + 2.0 * maxrw * (msq_num / scale["seen"] + 1.0)
        prob.n_real.fill_(float(np.float32(n_live)))
        prob.lam.fill_(float(np.float32(lam)))
        prob.lr.copy_((1.0 / big_l).float())
        return big_l

    big_l = float(rescale())
    msq = float(msq_num) / scale["seen"] + 1.0
    RUN.clear()
    RUN.update(stream=True, n_shards=ds.n_shards,
               rows_per_shard=ds.rows_per_shard, divisor=n, msq=msq,
               big_l=big_l, lr=np.float32(prob.lr.item()),
               phi_device=str(dev),
               prologue_seconds=time.perf_counter() - t_pro,
               steps=0, read_seconds=0.0, read_wait_seconds=0.0,
               step_seconds=0.0, live=live, generation=ds.generation,
               admissions=0, grown_rows=0, step_walls=[])

    def absorb_shard(k: int) -> int:
        got = ds.read_shard_checked(k, on_bad_shard=config.on_bad_shard,
                                    allow_nonfinite=allow_nonfinite)
        if got is None:
            return 0
        shard_lanes(k, got[1])               # label check up front
        absorb(torch.from_numpy(got[0]))
        return int(got[0].shape[0])

    def admit_new() -> None:
        """Sweep-boundary admission: one manifest poll on the host; new
        shards absorbed and the scalars rewritten on the device; one
        ingest_grow event for the boundary."""
        admitted = watcher.poll()
        if not admitted:
            return
        grown = sum(absorb_shard(k) for k in admitted)
        rescale()
        RUN["admissions"] += 1
        RUN["grown_rows"] += grown
        RUN["generation"] = ds.generation
        queue_trace_event("ingest_grow", generation=int(ds.generation),
                          n_new_rows=int(grown), shards=int(ds.n_shards),
                          quarantined=len(ds.quarantined))

    carry = init_carry(dp)
    if init_w is not None:
        carry = _apply_init_w(carry, init_w, dp)
    ckpt = resume_state(config, n, dp, gamma)
    if ckpt is not None:
        if live:
            carry, gen_ck = unpack_state_live(ckpt, dp)
            if gen_ck > ds.generation:
                # re-admit exactly the shards the killed run had consumed
                # before the watcher may see anything newer
                from dpsvm_tpu_torch.data.live import read_manifest_checked
                pinned = streamlib.pin_manifest_generation(
                    read_manifest_checked(ds.directory), gen_ck)
                for k in ds.admit_manifest(pinned):
                    absorb_shard(k)
                rescale()
                RUN["generation"] = ds.generation
            queue_trace_event("ingest_resume", n_iter=int(ckpt.n_iter),
                              shards=int(ds.n_shards),
                              generation=int(ds.generation),
                              quarantined=len(ds.quarantined))
        else:
            carry = unpack_state(ckpt, dp)
            queue_trace_event("ingest_resume", n_iter=int(ckpt.n_iter),
                              shards=int(ds.n_shards),
                              quarantined=len(ds.quarantined))
    carry = carry_to_device(carry, dev)
    state = {"it": int(ckpt.n_iter) if ckpt is not None else 0}

    def one_step(c: PrimalCarry, limit_t) -> PrimalCarry:
        u = c.w + _MOMENTUM * c.v
        gacc = nacc = None
        for _k, got in reader.passes():
            if got is None:
                continue
            xt, yb, rb = (t.to(dev, non_blocking=True) for t in got)
            with exact_f32():
                phi = dm.block(xt)
                f = torch.matmul(phi, u[:-1]) + u[-1]
                g, act = residual_grad(prob, f, yb, rb)
                gpart = torch.cat([torch.matmul(g, phi), g.sum().reshape(1)])
            npart = torch.sum(act & (rb > 0), dtype=torch.int32)
            # Partials add in manifest order, as the JAX package's do.
            gacc = gpart if gacc is None else gacc + gpart
            nacc = npart if nacc is None else nacc + npart
        if gacc is None:
            raise streamlib.IngestAbortError(
                f"{ds.directory}: every shard is quarantined")
        go = (c.metric > prob.two_eps) & (c.n_iter < limit_t)
        grad = gacc / prob.n_real + prob.lam * u * prob.reg_mask
        with exact_f32():
            new = descend(c, prob, grad, nacc)
        out = PrimalCarry(*(torch.where(go, a, b) for a, b in zip(new, c)))
        return out

    def step_chunk(c: PrimalCarry, limit: int):
        limit_t = torch.tensor(int(limit), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        r0, w0 = reader.read_s, reader.wait_s
        steps = 0
        while state["it"] < int(limit):
            t_step = time.perf_counter()
            if live:
                admit_new()
            c = one_step(c, limit_t)
            state["it"] += 1
            steps += 1
            if live:
                RUN["step_walls"].append(
                    (ds.n_shards, time.perf_counter() - t_step))
        # Zero steps (a chunk dispatched at max_iter): the carry as it is.
        st: ChunkStats = read_stats(_stats(c))
        COUNTS["reads"] += 1
        RUN["steps"] += steps
        RUN["step_seconds"] += time.perf_counter() - t0
        RUN["read_seconds"] += reader.read_s - r0
        RUN["read_wait_seconds"] += reader.wait_s - w0
        step_chunk.carry = c
        return c, st

    def to_host(c):
        if live:
            return pack_state_live(carry_to_host(c), ds.generation)
        return pack_state(carry_to_host(c))

    def carry_from_ckpt(ck) -> PrimalCarry:
        # Both halves of the trajectory state: the carry and the host's
        # step cursor. Live, the admitted view never shrinks: a rollback
        # to an older generation keeps the grown view (JAX
        # ``carry_from_ckpt``).
        state["it"] = int(ck.n_iter)
        restored = (unpack_state_live(ck, dp)[0] if live
                    else unpack_state(ck, dp))
        step_chunk.carry = carry_to_device(restored, dev)
        return step_chunk.carry

    step_chunk.carry = carry
    result = host_training_loop(
        config, gamma, carry, step_chunk, to_host, it0=state["it"],
        dims=(n, dp), carry_from_ckpt=carry_from_ckpt)
    RUN["divisor"] = ds.n
    final = carry_to_host(step_chunk.carry)
    w_out = np.asarray(final.w, np.float32)
    model = ApproxSVMModel(fmap=fmap, w=w_out[:-1].copy(),
                           b=-float(w_out[-1]), task=task)
    result = dataclasses.replace(
        result, b=model.b, n_sv=int(final.nact), gamma=gamma,
        kernel=config.kernel, coef0=float(config.coef0),
        degree=int(config.degree))
    return model, result
