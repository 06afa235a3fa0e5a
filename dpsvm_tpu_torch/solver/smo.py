"""Single-device SMO, the general pair (port of ``dpsvm_tpu/solver/smo.py``).

One modified-SMO iteration (select -> kernel rows -> eta -> alpha pair ->
f) in PyTorch calls, for every ``working_set == 2`` config outside the
fused kernel's envelope:

* selection: first-order (Keerthi: ``argminmax``, or ``packed`` 64-bit
  keys) or second-order (LIBSVM's WSS2, Fan/Chen/Lin 2005: the hi row
  first, then the partner maximising (f_j - b_hi)^2 / a_j, then its row);
* the kernel family (``KernelSpec``): the rows are one ``(r, d) . (d, n)``
  product and the kernel's epilogue, or a gather of K rows for a
  precomputed kernel (X is K);
* class weights (a per-example box), both clips (``alpha_pair_step``) and
  ``guard_eta`` (eta clamped to LIBSVM's TAU on the first-order path);
* ``f_init`` / ``alpha_init`` seeds (``api.warm_start``, ``polish`` and
  the task families: ``models/svr.py``, ``models/oneclass.py``);
* ``nu_selection``, LIBSVM's Solver_NU choice for the nu family's two
  equality constraints (``models/nusvm.py``): the violating pair within
  each class (one row-wise min and one row-wise max over the (2, n)
  class-masked scores, 64-bit (value, index) keys: the first index on
  ties and a NaN winning, as ``jnp.argmin``/``jnp.argmax``), and the class
  with the larger gap, the + class on a tie. The carry's stopping slots
  hold (0, max gap), so the do-while condition is unchanged.

The JAX package runs its chunk as a ``lax.while_loop`` inside one XLA
program. Here, on the card, a chunk is a captured CUDA graph of
``GRAPH_BODIES`` bodies replayed until the chunk's iterations are covered,
with no host synchronisation inside the chunk. Each body reads the
do-while condition ``(b_lo > b_hi + 2 eps) & (n_iter < limit)`` from the
carry on the device and gates every write through ``torch.where``, so a
body after convergence or past ``limit`` leaves the carry as it found it
(it still runs its products: the cost of up to a chunk of bodies at the
end of a run). ``limit`` is a device tensor the host fills before the
replays. The poll reads one packed-stats tensor per chunk
(``solver/driver.py``). Rows are fetched with ``index_select`` on 0-d index
tensors, so nothing in a body reads back to the host; TF32 is off while
the graph is captured, which is when cuBLAS's math mode is fixed.

The plain version is the same ``smo_step`` in an eager loop that tests the
condition on the host before each body: the CPU's path, and the reference
the graph is held against on the card.

The ``valid`` mask: the shrinking manager (``solver/shrink.py``) pads an
active subproblem to a power-of-two capacity, and rows at or past
``n_valid`` never enter selection. On the card ``n_valid`` is a device
scalar the captured graph reads, like ``limit``, so a capture depends on
the capacity only and is reused across compactions (``GraphChunk(...,
masked=True)``). The unmasked graph has no mask work in its bodies (the
JAX package keeps ``masked`` a build-time flag for the same reason).

A run resumes from a checkpoint (``resume_from``) with the saved (alpha,
f, b_hi, b_lo, n_iter): the b's are the last body's, so the loop goes on
exactly as the run that saved it would have.

The kernel-row cache (``cache_size > 0``, ``ops/rowcache.py``) serves the
first-order branch: the carry holds a ``RowCache`` of dot-product rows. The
eager loop skips the pair's ``(2, d) @ (d, n)`` product on a double hit as
``lax.cond`` does (``cache_fetch_pair`` reads the hit flags). A captured
body cannot read them, and the card's PyTorch (2.11) has no CUDA-graph
conditional node to skip the product on the device, so the body computes
the product every time and takes the cached rows on a double hit
(compute and select). Either way the rows, the eviction, the counters and
so the trajectory are those of the JAX package, and the cached run is
bitwise the uncached one: a cached row is the output of the same product.
The counters ride the poll's packed stats into ``TrainResult.cache_hits``
/ ``cache_misses``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SENTINEL, SVMConfig, TrainResult
from dpsvm_tpu_torch.observability import compilewatch
from dpsvm_tpu_torch.ops.kernels import (KernelSpec, dots_f32, exact_f32,
                                         host_row_stats, kdiag_from_norms,
                                         rows_from_dots)
from dpsvm_tpu_torch.ops.rowcache import (RowCache, cache_fetch_pair,
                                          cache_init, cached_pair,
                                          commit_pair_, pair_plan)
from dpsvm_tpu_torch.ops.selection import (box_sides, extrema_of,
                                           packed_extrema_of, pick,
                                           rowwise_extrema, sided_scores,
                                           valid_rows)
from dpsvm_tpu_torch.ops.update import alpha_pair_step
from dpsvm_tpu_torch.solver.driver import (ChunkStats, Poll, copy_carry_,
                                           device_sv_count,
                                           host_training_loop, pack_stats,
                                           read_stats, resume_state)

# Bodies in one captured graph; a chunk replays it until its iterations
# are covered (chunk_iters / GRAPH_BODIES replays of a full chunk).
GRAPH_BODIES = 16

# Ever, in this process: graphs captured, graph replays enqueued, and the
# packed-stats reads of the polls (one per chunk).
COUNTS = {"captures": 0, "replays": 0, "reads": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class SMOCarry(NamedTuple):
    alpha: torch.Tensor    # (n,) f32
    f: torch.Tensor        # (n,) f32 optimality/gradient vector
    b_hi: torch.Tensor     # () f32 from the latest selection
    b_lo: torch.Tensor     # () f32
    n_iter: torch.Tensor   # () i32
    cache: Optional[RowCache] = None    # the row cache (cache_size > 0)


def init_carry(y: torch.Tensor, f_init=None, alpha_init=None,
               b_hi: float = -SENTINEL, b_lo: float = SENTINEL,
               n_iter: int = 0, cache_lines: int = 0) -> SMOCarry:
    """alpha = 0, f = -y (svmTrain.cu:349,380), or the given seeds; the
    sentinel b's force the first body to run (the reference's do-while).
    ``cache_lines`` > 0 adds an empty row cache of that many lines. The
    carry owns its tensors: the graph updates them in place."""
    dev = y.device

    def vec(v):
        return torch.tensor(np.asarray(v, np.float32).reshape(-1),
                            device=dev)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    return SMOCarry(
        alpha=torch.zeros_like(y) if alpha_init is None else vec(alpha_init),
        f=-y if f_init is None else vec(f_init),
        b_hi=scalar(float(np.float32(b_hi)), torch.float32),
        b_lo=scalar(float(np.float32(b_lo)), torch.float32),
        n_iter=scalar(int(n_iter), torch.int32),
        cache=(cache_init(int(cache_lines), y.shape[0], device=dev)
               if cache_lines > 0 else None))


class SMOOptions(NamedTuple):
    """The branches of ``smo_step`` (static, as in the JAX runner)."""
    second_order: bool = False
    packed_select: bool = False
    pairwise_clip: bool = False
    guard_eta: bool = False
    nu_selection: bool = False

    @classmethod
    def from_config(cls, config: SVMConfig, guard_eta: bool = False,
                    nu_selection: bool = False) -> "SMOOptions":
        return cls(second_order=config.selection == "second-order",
                   packed_select=config.select_impl == "packed",
                   pairwise_clip=config.clip == "pairwise",
                   guard_eta=bool(guard_eta),
                   nu_selection=bool(nu_selection))


@dataclasses.dataclass
class SMOProblem:
    """The device-side inputs of a run: X as stored (float32, or bfloat16
    under ``matmul_precision="default"``; K itself, float32, for a
    precomputed kernel), labels, the x2 slot of the stored X (squared
    norms, or diag(K)), K(i, i) for the non-RBF kinds, the box (a float C
    or the per-example (n,) box of class weights) and its two sides
    (``ops.selection.box_sides``)."""
    x: torch.Tensor
    y: torch.Tensor
    x2: torch.Tensor
    kdiag: Optional[torch.Tensor]
    c_box: object
    up_side: torch.Tensor
    low_side: torch.Tensor
    spec: KernelSpec

    @classmethod
    def build(cls, x: np.ndarray, y: np.ndarray, config: SVMConfig,
              device: torch.device) -> "SMOProblem":
        spec = config.kernel_spec(x.shape[1])
        xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
        stored = np.asarray(x, np.float32)
        if config.matmul_precision == "default" and spec.kind != "precomputed":
            # bfloat16 X halves the bytes of the row product; x2 comes
            # from the stored X, so K(i, i) stays ~1 (as in the fused path).
            xd = xd.to(torch.bfloat16).contiguous()
            stored = xd.float().cpu().numpy()
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
        x2 = torch.from_numpy(host_row_stats(stored, spec)).to(device)
        kdiag = None if spec.is_rbf else kdiag_from_norms(x2, spec)
        box = config.box_bound(y)
        c_box = (float(box) if np.isscalar(box)
                 else torch.from_numpy(np.asarray(box, np.float32)).to(device))
        up, low = box_sides(yd, c_box)
        return cls(xd, yd, x2, kdiag, c_box, up, low, spec)

    def rows(self, idx: torch.Tensor,
             dots: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Kernel rows (r, n) in float32 for the (r,) indices ``idx``,
        from their dot products ``dots`` when given (the row cache's)."""
        if self.spec.kind == "precomputed":
            return self.x.index_select(0, idx)  # the gathered K rows
        if dots is None:
            dots = self.dots(idx)
        return rows_from_dots(dots, self.x2.index_select(0, idx), self.x2,
                              self.spec)

    def dots(self, idx: torch.Tensor) -> torch.Tensor:
        """The (r, n) float32 dot products of rows ``idx`` with X."""
        return dots_f32(self.x.index_select(0, idx), self.x)


class PairUpdate(NamedTuple):
    """What one body computes from the carry, before anything is written."""
    i_hi: torch.Tensor
    i_lo: torch.Tensor
    a_hi: torch.Tensor      # alpha[i_hi], alpha[i_lo] before the step
    a_lo: torch.Tensor
    a_hi_n: torch.Tensor    # ... and after it
    a_lo_n: torch.Tensor
    f: torch.Tensor         # the updated f (a new tensor)
    b_hi: torch.Tensor
    b_lo: torch.Tensor


def pair_update(carry: SMOCarry, prob: SMOProblem, opts: SMOOptions,
                valid: Optional[torch.Tensor] = None,
                fetch: Optional[Callable] = None) -> PairUpdate:
    """One modified-SMO iteration's values (``smo_step`` of the JAX
    package, branch for branch), reading the carry only.

    Second-order: among I_low violators j with f_j > b_hi, maximise
    (f_j - b_hi)^2 / a_j with a_j = K_ii + K_jj - 2 K(hi, j), the literal
    2 - 2 K(hi, j) for RBF; the stopping gap and the intercept still come
    from the max violator b_lo (svmTrainMain.cpp:310,329), and the alpha
    step uses the selected violator's f. Rows where ``valid`` is False are
    in neither index set. ``fetch(pair) -> dots`` gives the first-order
    pair's dot products (the row cache's fetch)."""
    alpha, f, y = carry.alpha, carry.f, prob.y
    f_up, f_low, in_low = sided_scores(alpha, f, prob.up_side, prob.low_side,
                                       valid)
    if opts.nu_selection:
        # Solver_NU: the pair shares its label. Row 0 is the + class,
        # row 1 the - class; the step uses the winning class's extrema,
        # and the stopping slots carry (0, max gap).
        pos = y > 0
        cls = torch.stack([pos, ~pos])
        ih, bh, il, bl = rowwise_extrema(
            torch.where(cls, f_up, SENTINEL), torch.where(cls, f_low,
                                                          -SENTINEL))
        gap = bl - bh
        use_p = gap[0] >= gap[1]
        i_hi = torch.where(use_p, ih[0], ih[1])
        i_lo = torch.where(use_p, il[0], il[1])
        b_hi = torch.where(use_p, bh[0], bh[1])
        b_lo_sel = torch.where(use_p, bl[0], bl[1])
        b_lo = torch.maximum(gap[0], gap[1])
        pair = torch.stack([i_hi, i_lo])
        k = prob.rows(pair)
    elif opts.second_order:
        i_hi = torch.argmin(f_up)
        b_hi = pick(f_up, i_hi)
        b_lo = torch.max(f_low)                       # stopping gap only
        k_hi = prob.rows(i_hi.reshape(1))[0]
        bb = f_low - b_hi
        if prob.spec.is_rbf:
            a = torch.clamp_min(2.0 - 2.0 * k_hi, 1e-12)
        else:
            kd = prob.kdiag
            a = torch.clamp_min(pick(kd, i_hi) + kd - 2.0 * k_hi, 1e-12)
        obj = torch.where(in_low & (bb > 0), bb * bb / a, -1.0)
        i_lo = torch.argmax(obj)
        k = torch.stack([k_hi, prob.rows(i_lo.reshape(1))[0]])
        b_lo_sel = pick(f_low, i_lo)
        pair = torch.stack([i_hi, i_lo])
    else:
        extrema = packed_extrema_of if opts.packed_select else extrema_of
        i_hi, b_hi, i_lo, b_lo = extrema(f_up, f_low)
        b_lo_sel = b_lo
        pair = torch.stack([i_hi, i_lo])
        k = prob.rows(pair, None if fetch is None else fetch(pair))
    n = k.shape[1]
    kk = k.reshape(-1).index_select(0, torch.stack([i_hi, n + i_lo, i_lo]))
    eta = kk[0] + kk[1] - 2.0 * kk[2]
    if opts.second_order or opts.guard_eta or opts.nu_selection:
        # WSS2 divides by the clamped a_j, so the update does too (LIBSVM's
        # TAU); guard_eta applies the clamp to first-order. The plain
        # classification path keeps the reference's raw division.
        eta = torch.clamp_min(eta, 1e-12)
    y_hi, y_lo = y.index_select(0, pair).unbind()
    a_hi, a_lo = alpha.index_select(0, pair).unbind()
    if isinstance(prob.c_box, torch.Tensor):
        c_hi, c_lo = prob.c_box.index_select(0, pair).unbind()
    else:
        c_hi = c_lo = prob.c_box
    a_hi_n, a_lo_n = alpha_pair_step(a_hi, a_lo, y_hi, y_lo, b_hi, b_lo_sel,
                                     eta, c_hi, c_lo, opts.pairwise_clip)
    # Each product rounded before its sum, as the NumPy oracle does it
    # (XLA on the CPU contracts the two into FMAs; with them the linear
    # kernel's trajectory leaves the oracle's within a few iterations).
    f_new = (f + ((a_hi_n - a_hi) * y_hi) * k[0]
             + ((a_lo_n - a_lo) * y_lo) * k[1])
    if opts.nu_selection:
        b_hi = torch.zeros_like(b_hi)       # the stopping slots
    return PairUpdate(i_hi, i_lo, a_hi, a_lo, a_hi_n, a_lo_n, f_new, b_hi,
                      b_lo)


def smo_step(carry: SMOCarry, prob: SMOProblem, opts: SMOOptions,
             valid: Optional[torch.Tensor] = None) -> SMOCarry:
    """One iteration as a new carry. The write order lo, then hi, mirrors
    train_step2 (svmTrain.cu:491-492) for the i_hi == i_lo corner. With a
    row cache the pair's rows come through ``cache_fetch_pair``."""
    fetch, cache = None, [carry.cache]
    if carry.cache is not None:
        def fetch(pair):
            dots, cache[0] = cache_fetch_pair(carry.cache, pair[0], pair[1],
                                              lambda: prob.dots(pair))
            return dots
    u = pair_update(carry, prob, opts, valid, fetch)
    alpha = carry.alpha.clone()
    alpha.index_copy_(0, u.i_lo.reshape(1), u.a_lo_n.reshape(1))
    alpha.index_copy_(0, u.i_hi.reshape(1), u.a_hi_n.reshape(1))
    return SMOCarry(alpha, u.f, u.b_hi, u.b_lo, carry.n_iter + 1, cache[0])


def live(carry: SMOCarry, two_eps: float, limit) -> torch.Tensor:
    """The do-while condition, a bool 0-d tensor on the carry's device:
    the gap is open (in float32) and n_iter is below ``limit``."""
    return (carry.b_lo > carry.b_hi + two_eps) & (carry.n_iter < limit)


def smo_body(carry: SMOCarry, prob: SMOProblem, opts: SMOOptions,
             two_eps: float, limit: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> None:
    """``smo_step`` in place, gated on ``live``: when the condition is
    false every write puts back what it read, so the carry is unchanged
    bit for bit. Reads nothing back to the host (the graph's body). With
    a row cache the pair's product runs every body, and a double hit
    takes the cached rows."""
    go = live(carry, two_eps, limit)
    fetch = None
    if carry.cache is not None:
        def fetch(pair):
            cache = carry.cache
            p = pair_plan(cache, pair[0], pair[1])
            dots = torch.where(p.hit_a & p.hit_b, cached_pair(cache, p),
                               prob.dots(pair))
            # written before the RBF epilogue consumes dots in place
            commit_pair_(cache, pair[0], pair[1], p, dots, go=go)
            return dots
    u = pair_update(carry, prob, opts, valid, fetch)
    carry.alpha.index_copy_(0, u.i_lo.reshape(1),
                            torch.where(go, u.a_lo_n, u.a_lo).reshape(1))
    carry.alpha.index_copy_(0, u.i_hi.reshape(1),
                            torch.where(go, u.a_hi_n, u.a_hi).reshape(1))
    carry.f.copy_(torch.where(go, u.f, carry.f))
    carry.b_hi.copy_(torch.where(go, u.b_hi, carry.b_hi))
    carry.b_lo.copy_(torch.where(go, u.b_lo, carry.b_lo))
    carry.n_iter.add_(go.to(torch.int32))


def run_chunk_plain(carry: SMOCarry, prob: SMOProblem, opts: SMOOptions,
                    two_eps: float, limit: int,
                    valid: Optional[torch.Tensor] = None) -> SMOCarry:
    """The chunk as an eager loop: ``smo_step`` while the condition,
    read on the host before each body, holds."""
    while bool(live(carry, two_eps, limit)):
        carry = smo_step(carry, prob, opts, valid)
    return carry


@contextlib.contextmanager
def capture(graph: "torch.cuda.CUDAGraph", pool=None,
            thread_local: bool = False, stream=None, *,
            program: str = "graph", signature: Optional[str] = None,
            collect: bool = True):
    """``torch.cuda.graph(graph, pool=pool)`` with TF32 off, after a
    collection and with Python's cycle collector held off until it ends: a
    collection inside a capture can release the CUDA objects of dead
    cycles that earlier code left, which may invalidate the capture (one
    capture in a run of the 157 card tests was invalidated before this was
    added). ``pool`` shares one memory pool among graphs (the serving
    engine's ladder). ``thread_local``: other threads may go on using the
    card during the capture (a registry reload captures a new engine's
    graphs while the old engine serves). ``stream`` is the capture stream
    (default: PyTorch's one shared capture stream). cuBLAS keeps a
    workspace per (handle, stream), and a graph replays the one its capture
    used: graphs that may replay at the same time on different streams
    (the replicas of a serving pool) need capture streams of their own, or
    their products share a workspace and race. Each capture is one
    observation of ``program`` at ``signature`` for the run trace
    (``observability/compilewatch``), with the capture's seconds.
    ``collect=False`` skips the collection, for a caller that collected
    once and holds the collector off over several captures (a full
    collection costs ~0.1-1 s in a process of many objects)."""
    if collect:
        gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    mode = "thread_local" if thread_local else "global"
    try:
        with compilewatch.observing(program, signature=signature), \
                exact_f32(), torch.cuda.graph(graph, pool=pool,
                                              stream=stream,
                                              capture_error_mode=mode):
            yield
    finally:
        if enabled:
            gc.enable()


class GraphChunk:
    """The chunk on the card: ``bodies`` gated bodies captured once in a
    CUDA graph over the carry's tensors, replayed ceil(iterations /
    bodies) times after the host fills ``limit``. ``masked`` adds a
    device scalar ``n_valid``, filled by the host like ``limit``, from
    which the graph builds the ``valid`` mask once a replay."""

    def __init__(self, carry: SMOCarry, prob: SMOProblem, opts: SMOOptions,
                 two_eps: float, bodies: int = GRAPH_BODIES,
                 masked: bool = False):
        self.carry, self.bodies = carry, int(bodies)
        dev = carry.alpha.device
        self.limit = torch.zeros((), dtype=torch.int32, device=dev)
        self.n_valid = (torch.zeros((), dtype=torch.int32, device=dev)
                        if masked else None)
        n = carry.alpha.shape[0]

        def run_bodies(count):
            valid = (None if self.n_valid is None
                     else valid_rows(n, self.n_valid, dev))
            for _ in range(count):
                smo_body(carry, prob, opts, two_eps, self.limit, valid)

        # Warm up (cuBLAS handles and workspaces) on a side stream with
        # limit 0: the body is a no-op.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), exact_f32():
            run_bodies(1)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with capture(self.graph, program="smo-chunk",
                     signature=compilewatch.shape_signature(
                         carry.alpha, prob.x)):
            run_bodies(self.bodies)
        COUNTS["captures"] += 1

    def run(self, n_iter: int, limit: int,
            n_valid: Optional[int] = None) -> int:
        """Advance the carry from ``n_iter`` (the last poll's) towards
        ``limit``; returns the replays enqueued. Nothing is read back."""
        self.limit.fill_(int(limit))
        if self.n_valid is not None:
            self.n_valid.fill_(int(n_valid))
        replays = -(-(int(limit) - int(n_iter)) // self.bodies)
        for _ in range(replays):
            self.graph.replay()
        COUNTS["replays"] += replays
        return replays


def _stats(carry: SMOCarry) -> torch.Tensor:
    """The poll's packed stats; with a row cache its hits and misses ride
    in the ``runs`` slots."""
    cache = () if carry.cache is None else (carry.cache.hits,
                                            carry.cache.misses)
    return pack_stats(carry.n_iter, carry.b_lo.view(torch.int32),
                      carry.b_hi.view(torch.int32),
                      device_sv_count(carry.alpha),
                      torch.zeros_like(carry.n_iter), *cache)


def make_chunk_runner(carry: SMOCarry, prob: SMOProblem, opts: SMOOptions,
                      two_eps: float, plain: bool = False,
                      n_valid: Optional[int] = None,
                      chunk: Optional[GraphChunk] = None):
    """``step(carry, limit) -> (carry, poll)`` for ``host_training_loop``:
    the captured graph on the card, the eager loop on the CPU (or
    anywhere, with ``plain``). ``poll`` (a ``driver.Poll``) makes the
    chunk's one read. ``n_valid`` masks the rows at or past it out of
    selection; ``chunk`` is a graph already captured over this carry and
    problem (the shrinking manager's cache), masked when ``n_valid`` is
    given."""
    state = {"n_iter": int(carry.n_iter)}
    if carry.alpha.is_cuda and not plain:
        if chunk is None:
            chunk = GraphChunk(carry, prob, opts, two_eps,
                               masked=n_valid is not None)

        def advance(cr, limit):
            chunk.run(state["n_iter"], limit, n_valid)
            return cr
    else:
        valid = (None if n_valid is None else
                 valid_rows(carry.alpha.shape[0], n_valid,
                            carry.alpha.device))

        def advance(cr, limit):
            with exact_f32():
                return run_chunk_plain(cr, prob, opts, two_eps, limit,
                                       valid)

    def step(cr: SMOCarry, limit: int):
        cr = advance(cr, limit)
        stats = _stats(cr)

        def poll() -> ChunkStats:
            st: ChunkStats = read_stats(stats)
            COUNTS["reads"] += 1
            if cr.cache is not None:
                st = st._replace(cache_hits=st.runs[0],
                                 cache_misses=st.runs[1])
            state["n_iter"] = st.n_iter
            step.last = st
            return st
        return cr, Poll(poll)

    step.state = state      # the last poll's n_iter (a rollback resets it)
    return step


def rollback_hook(carry, step, fresh: Callable):
    """``carry_from_ckpt`` of a runner from ``make_chunk_runner`` (or the
    distributed one): ``fresh(ck)`` builds a carry from the checkpoint,
    whose tensors are copied into ``carry``'s (the captured graph keeps
    its buffers), and the runner restarts from the checkpoint's n_iter.
    The row cache starts cold, as in the JAX package."""
    def carry_from_ckpt(ck):
        copy_carry_(carry, fresh(ck))
        step.state["n_iter"] = int(ck.n_iter)
        return carry
    return carry_from_ckpt


def two_eps_f32(epsilon: float) -> float:
    """2 eps as the float32 the condition adds (JAX: f32 + 2.0 * eps)."""
    return float(np.float32(2.0 * epsilon))


def train_single_device(x: np.ndarray, y: np.ndarray, config: SVMConfig,
                        device: torch.device,
                        f_init: Optional[np.ndarray] = None,
                        alpha_init: Optional[np.ndarray] = None,
                        guard_eta: bool = False, plain: bool = False,
                        carry: Optional[SMOCarry] = None,
                        nu_selection: bool = False) -> TrainResult:
    """Train on one device through the general pair.

    ``f_init`` / ``alpha_init`` override f = -y, alpha = 0 (the caller
    keeps them consistent: f must be the dual gradient at alpha).
    ``nu_selection`` takes Solver_NU's per-class pair (the nu family's
    wrappers, ``models/nusvm.py``, call it so and derive b from the final
    state, not from the carry's stopping slots).
    ``carry`` continues a run handed over mid-way (``convert.
    smo_carry_from_numpy``) on the same trajectory; a checkpoint
    (``config.resume_from``) takes precedence over both. ``plain`` runs
    the eager loop on any device (the reference the graph is held
    against)."""
    config.validate()
    prob = SMOProblem.build(x, y, config, device)
    ckpt = resume_state(config, x.shape[0], x.shape[1],
                        float(prob.spec.gamma))
    lines = int(config.cache_size)
    if ckpt is not None:
        carry = init_carry(prob.y, ckpt.f, ckpt.alpha, b_hi=ckpt.b_hi,
                           b_lo=ckpt.b_lo, n_iter=ckpt.n_iter,
                           cache_lines=lines)
    elif carry is None:
        carry = init_carry(prob.y, f_init, alpha_init, cache_lines=lines)
    elif lines and carry.cache is None:
        carry = carry._replace(cache=cache_init(lines, x.shape[0],
                                                device=device))
    step = make_chunk_runner(carry, prob, SMOOptions.from_config(
        config, guard_eta, nu_selection), two_eps_f32(config.epsilon), plain)
    hook = rollback_hook(carry, step, lambda ck: init_carry(
        prob.y, ck.f, ck.alpha, b_hi=ck.b_hi, b_lo=ck.b_lo,
        n_iter=ck.n_iter, cache_lines=lines))
    res = host_training_loop(
        config, float(prob.spec.gamma), carry, step,
        lambda cr: (cr.alpha.cpu().numpy(), cr.f.cpu().numpy()),
        it0=int(carry.n_iter), dims=x.shape, carry_from_ckpt=hook)
    if lines:
        hits, misses = step.last.runs
        res = dataclasses.replace(res, cache_hits=hits, cache_misses=misses)
    return res
