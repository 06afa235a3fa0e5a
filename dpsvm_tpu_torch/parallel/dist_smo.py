"""Distributed SMO pair over ``torch.distributed`` (port of
``dpsvm_tpu/parallel/dist_smo.py``).

The reference's MPI layer (``svmTrainMain.cpp``, SURVEY CS-1), as the JAX
package lays it out, with one process a device:

* contiguous example shards: n padded to a multiple of P, n_s = n_pad / P
  rows a rank, a validity mask keeping the padding out of both index sets
  (``svmTrainMain.cpp:367-384`` gives the last rank the remainder);
* per iteration, each rank's local extrema, one all-gather, and the same
  scan on every rank, in which the first shard wins ties (the reference's
  ``MPI::Allgather`` of each rank's extreme tuple and its strict
  comparisons, ``svmTrainMain.cpp:244-277``). The port packs each
  iteration's all-gather into one int32 tensor: the b's as bit patterns
  beside the global indices, so the gathered values are bit-exact;
* X row-sharded (``shard_x=True``): the owner of each working row sends it
  by a masked sum, one (2, d + 3) pack of the two rows and their owners'
  (x^2, y, alpha). ``shard_x=False`` keeps the reference's layout, the
  full X on every rank (``svmTrainMain.cpp:180``), and sums the scalars
  only;
* eta's three kernel entries from the owners' K rows by a second masked
  sum (the reference recomputes them on the host with CBLAS each
  iteration, ``svmTrainMain.cpp:282``);
* each rank updates its own alpha and f. alpha and f are both sharded.

Every rank passes the full (x, y), as every MPI rank of the reference
holds the full dataset, and keeps its own shard on its device; every rank
returns the same ``TrainResult``.

On the card (NCCL) a chunk is a captured CUDA graph of ``GRAPH_BODIES``
gated bodies with the collectives inside it, as the general pair's
``GraphChunk``: each body reads the do-while condition on the device and
gates every write, so all ranks replay the same graph the same number of
times and the host reads one packed-stats tensor a poll. Elsewhere (gloo;
``plain=True``) the same body runs in an eager loop that reads the
condition on the host before each iteration; the condition's scalars are
replicated, so every rank takes the same number of steps.

With P = 1 every collective is the identity and the run is the general
pair's (``solver/smo.py``) bit for bit: the gathered b's and indices are
the local ones, a masked sum of one rank adds nothing, and the products
are the same calls on the same rows.

The row cache (``cache_size > 0``, first-order): one cache a rank, each
line this shard's segment of a dot-product row, keyed by the global
working index (the reference's per-rank cache, ``svmTrain.cu:142-156``).
The key sequence is replicated, so every rank sees the same hits and
misses, and the counters equal one device's.
"""

from __future__ import annotations

import dataclasses
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
                                           sided_scores)
from dpsvm_tpu_torch.ops.update import alpha_pair_step
from dpsvm_tpu_torch.parallel.mesh import (DataMesh, all_gather, all_sum_,
                                           make_data_mesh, owner_index,
                                           shard_probe, to_host)
from dpsvm_tpu_torch.parallel.mesh import owner_read as _owner_read
from dpsvm_tpu_torch.solver import smo
from dpsvm_tpu_torch.solver.driver import (ChunkStats, Poll,
                                           device_sv_count,
                                           host_training_loop, pack_stats,
                                           read_stats, resume_state)

# Ever, in this process: graphs captured, graph replays enqueued, and the
# packed-stats reads of the polls (as ``smo.COUNTS``).
COUNTS = {"captures": 0, "replays": 0, "reads": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class DistCarry(NamedTuple):
    alpha: torch.Tensor     # (n_s,) this rank's shard
    f: torch.Tensor         # (n_s,)
    b_hi: torch.Tensor      # () f32, replicated
    b_lo: torch.Tensor      # ()
    n_iter: torch.Tensor    # () i32, replicated
    cache: Optional[RowCache] = None    # this rank's lines: (lines, n_s)


@dataclasses.dataclass
class DistProblem:
    """One rank's inputs. ``x``/``x2`` are this shard's rows (``shard_x``)
    or the full padded arrays (the reference's layout); for a precomputed
    kernel the rows of X are rows of K, padded to n_pad columns. ``y``,
    ``valid``, the box and its sides are always this shard's."""
    mesh: DataMesh
    n_s: int
    x: torch.Tensor
    y: torch.Tensor
    x2: torch.Tensor
    valid: torch.Tensor
    c_box: object           # float C, or this shard's (n_s,) box
    up_side: torch.Tensor
    low_side: torch.Tensor
    spec: KernelSpec
    shard_x: bool
    c: float
    weights: tuple
    x_pass: Optional[torch.Tensor] = None   # decomposition: the X its
                                            # rank-q pass reads

    @property
    def base(self) -> int:
        return self.mesh.rank * self.n_s

    def local(self, v: torch.Tensor) -> torch.Tensor:
        """This shard's rows of ``x`` or ``x2`` (``_local_slice``)."""
        return _local_slice(v, self.mesh.rank, self.n_s, self.shard_x)

    def c_of(self, y_sel: torch.Tensor):
        """The box of a broadcast working row (``_weighted_box``)."""
        return _weighted_box(self.c, self.weights, y_sel)


def _weighted_box(c: float, weights, ys):
    """The box by label: the scalar C when the class weights are (1, 1),
    the reference's exact path, else C w(y) per element of ``ys`` (for a
    broadcast working row's y, already replicated: weighted clips need no
    extra collective)."""
    wp, wn = weights
    if wp == 1.0 and wn == 1.0:
        return c
    return torch.where(ys > 0, ys.new_full((), np.float32(c * wp)),
                       ys.new_full((), np.float32(c * wn)))


def _local_slice(v: torch.Tensor, rank: int, n_per_shard: int,
                 shard_x: bool) -> torch.Tensor:
    """This shard's rows of X or x2: the array itself when X is sharded, a
    row slice (a view) when X is replicated."""
    if shard_x:
        return v
    return v[rank * n_per_shard:(rank + 1) * n_per_shard]


class DistInputs(NamedTuple):
    """What the pad-and-shard protocol produces, shared by the pair and
    the decomposition: the rank's problem and its seed, (alpha, f) of
    this shard as NumPy and the (b_hi, b_lo, n_iter) scalars."""
    prob: DistProblem
    init: tuple


def prepare_distributed_inputs(x, y, config: SVMConfig, mesh: DataMesh,
                               ckpt, f_init, alpha_init,
                               capacity: Optional[int] = None,
                               decomp: bool = False) -> DistInputs:
    """Pad n to the mesh, place this rank's X/y/x2/valid with the
    configured layout, and seed (alpha, f, b's, n_iter) from the checkpoint
    (re-sliced for this mesh) or the classification init, which
    ``f_init`` / ``alpha_init`` override.

    ``capacity``: pad the row count up to at least this many rows before
    the rounding to the mesh (the shrinking manager's power-of-two
    capacities). Capacity rows are zero and masked invalid like the mesh's
    padding. Under ``matmul_precision="default"`` the pair stores X in
    bfloat16 and takes x2 from the stored values, as on one device; the
    decomposition (``decomp``) keeps X and x2 in float32 for K_WW and adds
    the bfloat16 copy its rank-q pass reads (``x_pass``)."""
    n, d = x.shape
    p, dev = mesh.size, mesh.device
    n_cap = max(n, int(capacity or 0))
    n_pad = -(-n_cap // p) * p
    n_s = n_pad // p
    base = mesh.rank * n_s
    spec = config.kernel_spec(d)
    pre = spec.kind == "precomputed"
    xf = np.asarray(x, np.float32)
    bf16 = config.matmul_precision == "default" and not pre
    stored = (torch.from_numpy(np.ascontiguousarray(xf)).to(
        torch.bfloat16).float().numpy() if bf16 and not decomp else xf)
    width = n_pad if pre else d

    def padded(v, lo, hi):
        out = np.zeros((hi - lo,) + ((width,) if v.ndim == 2 else ()),
                       np.float32)
        top = min(hi, n)
        if top > lo:
            if v.ndim == 2:
                out[:top - lo, :v.shape[1]] = v[lo:top]
            else:
                out[:top - lo] = v[lo:top]
        return out

    lo, hi = (base, base + n_s) if config.shard_x else (0, n_pad)
    xd = torch.from_numpy(padded(stored, lo, hi)).to(dev)
    x_pass = None
    if decomp:
        x_pass = xd.to(torch.bfloat16) if bf16 else xd
    elif bf16:
        xd = xd.to(torch.bfloat16)
    x2d = torch.from_numpy(padded(host_row_stats(stored, spec), lo,
                                  hi)).to(dev)
    yp = padded(np.asarray(y, np.float32), base, base + n_s)
    yd = torch.from_numpy(yp).to(dev)
    valid = torch.arange(base, base + n_s, device=dev) < n
    wp, wn = float(config.weight_pos), float(config.weight_neg)
    c = float(config.c)
    c_box = _weighted_box(c, (wp, wn), yd)
    up, low = box_sides(yd, c_box)
    prob = DistProblem(mesh, n_s, xd, yd, x2d, valid, c_box, up, low, spec,
                       bool(config.shard_x), c, (wp, wn), x_pass)

    if ckpt is not None:
        init = ckpt_init(ckpt, prob)
    else:
        a0 = (np.zeros(n_s, np.float32) if alpha_init is None
              else rank_slice(alpha_init, prob))
        f0 = -yp if f_init is None else rank_slice(f_init, prob)
        init = (a0, f0, -SENTINEL, SENTINEL, 0)
    return DistInputs(prob, init)


def rank_slice(v, prob: DistProblem) -> np.ndarray:
    """This rank's (n_s,) share of a global (n,) vector on the mesh's
    padded rows (the padding rows are zero)."""
    v = np.asarray(v, np.float32)
    out = np.zeros((prob.n_s * prob.mesh.size,), np.float32)
    out[:v.shape[0]] = v
    base = prob.mesh.rank * prob.n_s
    return out[base:base + prob.n_s]


def ckpt_init(ck, prob: DistProblem) -> tuple:
    """This rank's (alpha, f, b_hi, b_lo, n_iter) seed from a checkpoint's
    global state, re-sliced for this mesh."""
    return (rank_slice(ck.alpha, prob), rank_slice(ck.f, prob), ck.b_hi,
            ck.b_lo, int(ck.n_iter))


def init_carry(prob: DistProblem, init: tuple,
               cache_lines: int = 0) -> DistCarry:
    """The carry on the rank's device from a ``DistInputs.init`` seed; it
    owns its tensors (the graph updates them in place)."""
    dev = prob.y.device

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    return DistCarry(
        alpha=torch.from_numpy(np.array(init[0], np.float32)).to(dev),
        f=torch.from_numpy(np.array(init[1], np.float32)).to(dev),
        b_hi=scalar(float(np.float32(init[2])), torch.float32),
        b_lo=scalar(float(np.float32(init[3])), torch.float32),
        n_iter=scalar(int(init[4]), torch.int32),
        cache=(cache_init(int(cache_lines), prob.n_s, device=dev)
               if cache_lines > 0 else None))


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(()).view(torch.int32)


def _gather_scan(mesh: DataMesh, cols, lowest: tuple):
    """All-gather one int32 row a rank and scan it on every rank.
    ``cols`` are 0-d tensors (floats travel as bit patterns); ``lowest``
    says, for each float column to scan, whether its smallest (True) or
    largest (False) value wins, the first rank on ties. Returns the
    gathered (P, k) int32 table and, per scanned column, the winning rank
    as a 0-d tensor."""
    row = torch.stack([c.reshape(()).view(torch.int32)
                       if c.dtype == torch.float32 else c.reshape(()).to(
                           torch.int32) for c in cols])
    g = all_gather(mesh, row)                                  # (P, k)
    wins = []
    for j, low in enumerate(lowest):
        v = g[:, j].contiguous().view(torch.float32)
        wins.append(torch.argmin(v) if low else torch.argmax(v))
    return g, wins


def _at(g: torch.Tensor, p: torch.Tensor, j: int, as_float: bool = False):
    """g[p, j] as a 0-d tensor (a float column reinterpreted)."""
    col = g[:, j].contiguous()
    if as_float:
        col = col.view(torch.float32)
    return pick(col, p)


def _broadcast_row(prob: DistProblem, alpha: torch.Tensor, gis, ps,
                    locs, owns):
    """The working rows of global indices ``gis`` (owners ``ps``) and
    their (x2, y, alpha), replicated on every rank by one masked sum: the
    rows and the six scalars when X is sharded, the scalars only when X
    is replicated (every rank reads the rows itself). Returns (rows (r,
    width) in X's type, scalars (r, 3) float32)."""
    mesh, xs = prob.mesh, prob.x
    scal = []
    for gi, loc, own in zip(gis, locs, owns):
        x2 = (_owner_read(prob.x2, loc, own) if prob.shard_x else
              torch.where(own, pick(prob.x2, gi), prob.x2.new_zeros(())))
        scal += [x2, _owner_read(prob.y, loc, own),
                 _owner_read(alpha, loc, own)]
    scal = torch.stack(scal)
    r = len(gis)
    if prob.shard_x:
        width = xs.shape[1]
        pack = torch.cat([_owner_read(xs, loc, own).float()
                          for loc, own in zip(locs, owns)] + [scal])
        all_sum_(mesh, pack)
        rows = pack[:r * width].view(r, width).to(xs.dtype)
        scal = pack[r * width:]
    else:
        rows = xs.index_select(0, torch.stack(gis).to(torch.int64))
        all_sum_(mesh, scal)
    return rows, scal.view(r, 3)


def _eta_kernel_entries(mesh, k_hi, k_lo, loc_hi, own_hi, loc_lo, own_lo):
    """(K(hi,hi), K(lo,lo), K(hi,lo)) from the owners' local kernel rows,
    by one masked sum."""
    kk = torch.stack([_owner_read(k_hi, loc_hi, own_hi),
                      _owner_read(k_lo, loc_lo, own_lo),
                      _owner_read(k_hi, loc_lo, own_lo)])
    return all_sum_(mesh, kk)


class DistUpdate(NamedTuple):
    i_hi: torch.Tensor      # the working pair's global indices
    i_lo: torch.Tensor
    loc_hi: torch.Tensor
    own_hi: torch.Tensor
    loc_lo: torch.Tensor
    own_lo: torch.Tensor
    a_hi_n: torch.Tensor
    a_lo_n: torch.Tensor
    f: torch.Tensor
    b_hi: torch.Tensor
    b_lo: torch.Tensor


def _dist_step_wss2(carry: DistCarry, prob: DistProblem,
                    opts: smo.SMOOptions) -> DistUpdate:
    """One second-order (WSS2) iteration's values (the JAX package's
    ``_dist_step_wss2`` up to its writes, which the callers make):
    the hi row is broadcast first, every rank scores its violators
    against it, and the lo index comes from a second all-gather."""
    mesh, n_s, spec = prob.mesh, prob.n_s, prob.spec
    alpha, f = carry.alpha, carry.f
    f_up, f_low, in_low = sided_scores(alpha, f, prob.up_side,
                                       prob.low_side, prob.valid)
    li_hi = torch.argmin(f_up)
    g, (p_hi, p_lo_stop) = _gather_scan(
        mesh, [pick(f_up, li_hi), torch.max(f_low), li_hi + prob.base],
        (True, False))
    b_hi = _at(g, p_hi, 0, True)
    b_lo = _at(g, p_lo_stop, 1, True)           # the stopping gap only
    i_hi = _at(g, p_hi, 2)
    own_hi = p_hi == mesh.rank
    loc_hi = owner_index(i_hi, p_hi, n_s)
    xs_l, x2s_l = prob.local(prob.x), prob.local(prob.x2)

    def k_row(row, w2):
        if spec.kind == "precomputed":
            # the broadcast row is the kernel row: this shard's columns
            return row[prob.base:prob.base + n_s].float()
        return rows_from_dots(dots_f32(row[None], xs_l), w2.reshape(1),
                              x2s_l, spec)[0]

    rows, sc = _broadcast_row(prob, alpha, [i_hi], [p_hi], [loc_hi],
                               [own_hi])
    k_hi = k_row(rows[0], sc[0, 0])
    bb = f_low - b_hi
    if spec.is_rbf:
        a = torch.clamp_min(2.0 - 2.0 * k_hi, 1e-12)
    else:
        a = torch.clamp_min(kdiag_from_norms(sc[0, 0], spec)
                            + kdiag_from_norms(x2s_l, spec) - 2.0 * k_hi,
                            1e-12)
    obj = torch.where(in_low & (bb > 0), bb * bb / a, -1.0)
    li_lo = torch.argmax(obj)
    g2, (p_lo,) = _gather_scan(
        mesh, [pick(obj, li_lo), pick(f_low, li_lo), li_lo + prob.base],
        (False,))
    b_lo_sel = _at(g2, p_lo, 1, True)
    i_lo = _at(g2, p_lo, 2)
    own_lo = p_lo == mesh.rank
    loc_lo = owner_index(i_lo, p_lo, n_s)
    rows_lo, sc_lo = _broadcast_row(prob, alpha, [i_lo], [p_lo], [loc_lo],
                                     [own_lo])
    k_lo = k_row(rows_lo[0], sc_lo[0, 0])
    kk = _eta_kernel_entries(mesh, k_hi, k_lo, loc_hi, own_hi, loc_lo, own_lo)
    eta = torch.clamp_min(kk[0] + kk[1] - 2.0 * kk[2], 1e-12)
    y_hi, a_hi = sc[0, 1], sc[0, 2]
    y_lo, a_lo = sc_lo[0, 1], sc_lo[0, 2]
    a_hi_n, a_lo_n = alpha_pair_step(a_hi, a_lo, y_hi, y_lo, b_hi, b_lo_sel,
                                     eta, prob.c_of(y_hi), prob.c_of(y_lo),
                                     opts.pairwise_clip)
    f_new = (f + ((a_hi_n - a_hi) * y_hi) * k_hi
             + ((a_lo_n - a_lo) * y_lo) * k_lo)
    return DistUpdate(i_hi, i_lo, loc_hi, own_hi, loc_lo, own_lo, a_hi_n,
                      a_lo_n, f_new, b_hi, b_lo)


def _dist_step(carry: DistCarry, prob: DistProblem, opts: smo.SMOOptions,
               fetch: Optional[Callable] = None) -> DistUpdate:
    """One first-order iteration's values (the JAX package's ``_dist_step``
    up to its writes, which the callers make): local extrema,
    one all-gather and the scan, one masked sum of the working rows, the
    local K rows, one masked sum of eta's entries. ``fetch(i_hi, i_lo,
    compute) -> dots`` is the row cache's."""
    mesh, n_s, spec = prob.mesh, prob.n_s, prob.spec
    alpha, f = carry.alpha, carry.f
    f_up, f_low, _ = sided_scores(alpha, f, prob.up_side, prob.low_side,
                                  prob.valid)
    extrema = packed_extrema_of if opts.packed_select else extrema_of
    li_hi, lb_hi, li_lo, lb_lo = extrema(f_up, f_low)
    g, (p_hi, p_lo) = _gather_scan(
        mesh, [lb_hi, lb_lo, li_hi + prob.base, li_lo + prob.base],
        (True, False))
    b_hi, b_lo = _at(g, p_hi, 0, True), _at(g, p_lo, 1, True)
    i_hi, i_lo = _at(g, p_hi, 2), _at(g, p_lo, 3)
    own_hi, own_lo = p_hi == mesh.rank, p_lo == mesh.rank
    loc_hi = owner_index(i_hi, p_hi, n_s)
    loc_lo = owner_index(i_lo, p_lo, n_s)
    rows, sc = _broadcast_row(prob, alpha, [i_hi, i_lo], [p_hi, p_lo],
                               [loc_hi, loc_lo], [own_hi, own_lo])
    w2 = sc[:, 0]
    if spec.kind == "precomputed":
        # the rows are full (column-padded) K rows: eta's entries are
        # global-index reads, the local K rows a column slice
        width = rows.shape[1]
        kk = rows.reshape(-1).index_select(0, torch.stack(
            [i_hi, width + i_lo, i_lo]).to(torch.int64))
        k_local = rows[:, prob.base:prob.base + n_s]
    elif fetch is not None or prob.shard_x:
        xs_l, x2s_l = prob.local(prob.x), prob.local(prob.x2)
        dots = (dots_f32(rows, xs_l) if fetch is None else
                fetch(i_hi, i_lo, lambda: dots_f32(rows, xs_l)))
        k_local = rows_from_dots(dots, w2, x2s_l, spec)         # (2, n_s)
        kk = _eta_kernel_entries(mesh, k_local[0], k_local[1], loc_hi, own_hi,
                          loc_lo, own_lo)
    else:
        k_full = rows_from_dots(dots_f32(rows, prob.x), w2, prob.x2, spec)
        width = k_full.shape[1]
        kk = k_full.reshape(-1).index_select(0, torch.stack(
            [i_hi, width + i_lo, i_lo]).to(torch.int64))
        k_local = k_full[:, prob.base:prob.base + n_s]
    eta = kk[0] + kk[1] - 2.0 * kk[2]
    if opts.guard_eta:
        eta = torch.clamp_min(eta, 1e-12)
    y_hi, y_lo = sc[0, 1], sc[1, 1]
    a_hi, a_lo = sc[0, 2], sc[1, 2]
    a_hi_n, a_lo_n = alpha_pair_step(a_hi, a_lo, y_hi, y_lo, b_hi, b_lo,
                                     eta, prob.c_of(y_hi), prob.c_of(y_lo),
                                     opts.pairwise_clip)
    f_new = (f + ((a_hi_n - a_hi) * y_hi) * k_local[0]
             + ((a_lo_n - a_lo) * y_lo) * k_local[1])
    return DistUpdate(i_hi, i_lo, loc_hi, own_hi, loc_lo, own_lo, a_hi_n,
                      a_lo_n, f_new, b_hi, b_lo)


def _update(carry, prob, opts, fetch=None) -> DistUpdate:
    if opts.second_order:
        return _dist_step_wss2(carry, prob, opts)
    return _dist_step(carry, prob, opts, fetch)


def _write_alpha_(alpha: torch.Tensor, u: DistUpdate,
                  go: Optional[torch.Tensor] = None) -> None:
    """The owners' alpha writes, lo then hi (train_step2's order,
    svmTrain.cu:491-492), each kept only on its owner (and while ``go``)."""
    for loc, own, new in ((u.loc_lo, u.own_lo, u.a_lo_n),
                          (u.loc_hi, u.own_hi, u.a_hi_n)):
        li = loc.reshape(1)
        keep = own if go is None else own & go
        alpha.index_copy_(0, li, torch.where(
            keep, new, alpha.index_select(0, li)[0]).reshape(1))


def dist_step(carry: DistCarry, prob: DistProblem,
              opts: smo.SMOOptions) -> DistCarry:
    """One iteration as a new carry (the eager loop's)."""
    fetch, cache = None, [carry.cache]
    if carry.cache is not None:
        def fetch(i_hi, i_lo, compute):
            dots, cache[0] = cache_fetch_pair(carry.cache, i_hi, i_lo,
                                              compute)
            return dots
    u = _update(carry, prob, opts, fetch)
    alpha = carry.alpha.clone()
    _write_alpha_(alpha, u)
    return DistCarry(alpha, u.f, u.b_hi, u.b_lo, carry.n_iter + 1, cache[0])


def dist_body(carry: DistCarry, prob: DistProblem, opts: smo.SMOOptions,
              two_eps: float, limit: torch.Tensor) -> None:
    """``dist_step`` in place, gated on ``smo.live``: every collective
    runs, and when the condition is false every write puts back what it
    read. Reads nothing back to the host (the graph's body). With a row
    cache the product runs every body and a double hit takes the cached
    rows."""
    go = smo.live(carry, two_eps, limit)
    fetch = None
    if carry.cache is not None:
        def fetch(i_hi, i_lo, compute):
            c = carry.cache
            p = pair_plan(c, i_hi, i_lo)
            dots = torch.where(p.hit_a & p.hit_b, cached_pair(c, p),
                               compute())
            commit_pair_(c, i_hi, i_lo, p, dots, go=go)
            return dots
    u = _update(carry, prob, opts, fetch)
    _write_alpha_(carry.alpha, u, go)
    carry.f.copy_(torch.where(go, u.f, carry.f))
    carry.b_hi.copy_(torch.where(go, u.b_hi, carry.b_hi))
    carry.b_lo.copy_(torch.where(go, u.b_lo, carry.b_lo))
    carry.n_iter.add_(go.to(torch.int32))


def run_chunk_plain(carry: DistCarry, prob: DistProblem,
                    opts: smo.SMOOptions, two_eps: float,
                    limit: int) -> DistCarry:
    """The chunk as an eager loop: ``dist_step`` while the condition,
    read on the host before each iteration, holds (the same on every
    rank: its scalars are replicated)."""
    while bool(smo.live(carry, two_eps, limit)):
        carry = dist_step(carry, prob, opts)
    return carry


class DistGraphChunk:
    """The chunk on the card: ``bodies`` gated ``dist_body`` calls, NCCL
    collectives included, captured once in a CUDA graph over the carry's
    tensors and replayed ceil(iterations / bodies) times after the host
    fills ``limit``. Every rank replays the same count (the count comes
    from the replicated poll)."""

    def __init__(self, carry: DistCarry, prob: DistProblem,
                 opts: smo.SMOOptions, two_eps: float,
                 bodies: int = smo.GRAPH_BODIES):
        self.carry, self.bodies = carry, int(bodies)
        dev = carry.alpha.device
        self.limit = torch.zeros((), dtype=torch.int32, device=dev)

        def run_bodies(count):
            for _ in range(count):
                dist_body(carry, prob, opts, two_eps, self.limit)

        # Warm up (cuBLAS handles, the NCCL communicator) with limit 0:
        # the body is a no-op on every rank.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), exact_f32():
            run_bodies(1)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        with smo.capture(self.graph, program="dist-smo-chunk",
                         signature=compilewatch.shape_signature(
                             carry.alpha)):
            run_bodies(self.bodies)
        COUNTS["captures"] += 1

    def run(self, n_iter: int, limit: int) -> int:
        self.limit.fill_(int(limit))
        replays = -(-(int(limit) - int(n_iter)) // self.bodies)
        for _ in range(replays):
            self.graph.replay()
        COUNTS["replays"] += replays
        return replays


def dist_stats(carry, prob: DistProblem, rounds=None,
               runs=()) -> torch.Tensor:
    """The poll's packed stats on every rank: [n_iter, b_lo bits, b_hi
    bits, n_sv over all ranks, rounds, runs..., then every rank's probe
    row]. One all-gather: each rank's probe with its own SV count."""
    row = torch.cat([shard_probe(carry.n_iter, carry.b_lo, carry.b_hi),
                     device_sv_count(carry.alpha).reshape(1)])
    g = all_gather(prob.mesh, row)                              # (P, 4)
    return torch.cat([
        pack_stats(carry.n_iter, _bits(carry.b_lo), _bits(carry.b_hi),
                   g[:, 3].sum(dtype=torch.int32),
                   torch.zeros_like(carry.n_iter) if rounds is None
                   else rounds, *runs),
        g[:, :3].reshape(-1)])


def make_dist_runner(carry: DistCarry, prob: DistProblem,
                     opts: smo.SMOOptions, two_eps: float,
                     plain: bool = False,
                     chunk: Optional[DistGraphChunk] = None):
    """``step(carry, limit) -> (carry, poll)``: the captured graph on an
    NCCL rank, the eager loop elsewhere (or anywhere, with ``plain``);
    ``poll`` (a ``driver.Poll``) makes the chunk's one read. ``chunk`` is
    a graph already captured over this carry and problem."""
    state = {"n_iter": int(carry.n_iter)}
    graph = carry.alpha.is_cuda and prob.mesh.backend == "nccl" and not plain
    if graph:
        if chunk is None:
            chunk = DistGraphChunk(carry, prob, opts, two_eps)

        def advance(cr, limit):
            chunk.run(state["n_iter"], limit)
            return cr
    else:
        def advance(cr, limit):
            with exact_f32():
                return run_chunk_plain(cr, prob, opts, two_eps, limit)

    def step(cr: DistCarry, limit: int):
        cr = advance(cr, limit)
        cache = () if cr.cache is None else (cr.cache.hits, cr.cache.misses)
        stats = dist_stats(cr, prob, runs=cache)

        def poll() -> ChunkStats:
            st = read_stats(stats, shards=prob.mesh.size)
            COUNTS["reads"] += 1
            if cr.cache is not None:
                st = st._replace(cache_hits=st.runs[0],
                                 cache_misses=st.runs[1])
            state["n_iter"] = st.n_iter
            step.last = st
            return st
        return cr, Poll(poll)

    step.chunk = chunk
    step.state = state      # the last poll's n_iter (a rollback resets it)
    return step


def train_distributed(x: np.ndarray, y: np.ndarray, config: SVMConfig,
                      group=None, f_init: Optional[np.ndarray] = None,
                      alpha_init: Optional[np.ndarray] = None,
                      guard_eta: bool = False, device=None,
                      plain: bool = False) -> TrainResult:
    """Train the pair over the ranks of ``group`` (default: the world
    group, which must hold ``config.shards`` ranks); call it on every
    rank with the same full (x, y). ``group`` overrides ``config.shards``
    (at world size 1 it runs this path on one device). ``device`` is the
    rank's device (default: its CUDA device under NCCL, the CPU under
    gloo). ``f_init`` / ``alpha_init`` seed the run (the task families);
    a checkpoint takes precedence, re-sliced for this mesh. ``plain`` runs
    the eager loop on the card too."""
    config.validate()
    n, d = x.shape
    mesh = make_data_mesh(config.shards, group, device)
    gamma = float(config.resolve_gamma(d))
    ckpt = resume_state(config, n, d, gamma, shards=mesh.size)
    di = prepare_distributed_inputs(x, y, config, mesh, ckpt, f_init,
                                    alpha_init)
    lines = int(config.cache_size)
    carry = init_carry(di.prob, di.init, cache_lines=lines)
    step = make_dist_runner(carry, di.prob,
                            smo.SMOOptions.from_config(config, guard_eta),
                            smo.two_eps_f32(config.epsilon), plain)
    hook = smo.rollback_hook(carry, step, lambda ck: init_carry(
        di.prob, ckpt_init(ck, di.prob), cache_lines=lines))
    res = host_training_loop(
        config, gamma, carry, step,
        lambda cr: (to_host(mesh, cr.alpha, n), to_host(mesh, cr.f, n)),
        it0=int(di.init[4]), dims=x.shape, mesh=mesh,
        carry_from_ckpt=hook)
    if lines:
        hits, misses = step.last.runs
        res = dataclasses.replace(res, cache_hits=hits, cache_misses=misses)
    return res
