"""Distributed large-working-set decomposition (port of
``dpsvm_tpu/parallel/dist_decomp.py``).

``solver/decomp.py``'s outer round, SPMD over the ranks of
``parallel/dist_smo.py``'s mesh. Per round:

* each rank takes its local top q/2 violators per side (a stable sort of
  its masked scores: ``lax.top_k``'s order, ties to the lower index);
* one all-gather merges them (values as bit patterns beside their global
  indices, both sides in one int32 row a rank), and the global top q/2 a
  side is a stable sort of the P x q/2 candidates, the same on every rank.
  Stability and contiguous shards make the merge equal to one device's
  top-k on equal scores (ties to the lowest global index in both);
* the (q, d) working rows and their (x2, y, alpha, f) come from their
  owners in one masked sum of a (q, d + 4) pack (the rows are left out
  when X is replicated);
* K_WW in exact float32 and the capped WSS2 subsolve run on every rank,
  on identical inputs: on the card kernel B
  (``experimental/subsolve_kernel.launch_inner_subsolve``), on the CPU its
  plain version. Under ``use_pallas="auto"`` that is the port's choice,
  as on one device (the JAX package runs its plain subsolve there; its
  ``use_pallas="on"`` with shards stays refused, word for word);
* the (q, d) . (d, n_s) block fetch and the rank-q f update are local to
  each rank (``solver/decomp.rank_q_update``).

The round loop reads one packed-stats tensor a round on the host (its
condition needs the gap and n_iter), as on one device; each read carries
every rank's probe row. With P = 1 a round is the single-device round's:
the same W, the same K_WW, the same subsolve and the same updates.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
from dpsvm_tpu_torch.ops.kernels import exact_f32, rows_from_dots
from dpsvm_tpu_torch.ops.selection import (masked_scores_and_masks,
                                           top_k_first, unique_padded)
from dpsvm_tpu_torch.parallel.dist_smo import (DistProblem, _weighted_box,
                                               dist_stats,
                                               prepare_distributed_inputs)
from dpsvm_tpu_torch.parallel.mesh import (DataMesh, all_gather, all_sum_,
                                           make_data_mesh, to_host)
from dpsvm_tpu_torch.solver.decomp import (DecompWorkspace,
                                           _make_growth_hook, rank_q_update)
from dpsvm_tpu_torch.solver.driver import (gap_open, host_training_loop,
                                           read_stats, resume_state)

# Packed-stats reads of the distributed round loops, ever (one a round,
# plus the first of each run).
READS = {"stats": 0}


class DistDecompCarry(NamedTuple):
    alpha: torch.Tensor     # (n_s,) this rank's shard
    f: torch.Tensor         # (n_s,)
    b_hi: torch.Tensor      # () f32, replicated
    b_lo: torch.Tensor      # ()
    n_iter: torch.Tensor    # () i32 cumulative inner pair-updates
    rounds: torch.Tensor    # () i32 outer rounds


def _merged_top(mesh: DataMesh, sides, k: int):
    """The global top k of each side from each rank's candidates: one
    all-gather of [values bits, global indices] per side, then a stable
    sort of the P x k_loc values, best first, on every rank (the order of
    any value tie is then ascending global index, as one device's top-k).
    ``sides``: [(values (k_loc,) f32 best first, global indices)]."""
    k_loc = sides[0][0].shape[0]
    row = torch.cat([t for v, gi in sides
                     for t in (v.view(torch.int32), gi.to(torch.int32))])
    g = all_gather(mesh, row)                        # (P, 2 sides x 2 k_loc)
    out = []
    for j in range(len(sides)):
        vals = g[:, 2 * j * k_loc:(2 * j + 1) * k_loc].contiguous().view(
            torch.float32).reshape(-1)
        gidx = g[:, (2 * j + 1) * k_loc:(2 * j + 2) * k_loc].reshape(-1)
        order = torch.sort(-vals, stable=True).indices[:k]
        out.append((vals[order], gidx[order]))
    return out


def _gather_w(prob: DistProblem, wi: torch.Tensor, active: torch.Tensor,
              alpha: torch.Tensor, f: torch.Tensor):
    """The working set's (rows, x2, y, alpha, f), replicated from the
    owners by one masked sum of a (q, d + 4) pack (the rows left out when X
    is replicated: every rank reads them itself)."""
    n_s, q = prob.n_s, wi.shape[0]
    loc = torch.clamp(wi - prob.base, 0, n_s - 1)
    own = active & (torch.div(wi, n_s, rounding_mode="floor")
                    == prob.mesh.rank)
    x2_c = (prob.x2[loc] if prob.shard_x
            else prob.x2[torch.clamp(wi, 0, prob.x2.shape[0] - 1)])
    zero = torch.zeros((), dtype=torch.float32, device=wi.device)
    cols = torch.stack([torch.where(own, v, zero)
                        for v in (x2_c, prob.y[loc], alpha[loc], f[loc])],
                       dim=1)                                   # (q, 4)
    if prob.shard_x:
        rows = torch.where(own[:, None], prob.x[loc], 0.0)
        width = rows.shape[1]
        pack = all_sum_(prob.mesh, torch.cat([rows.reshape(-1),
                                              cols.reshape(-1)]))
        rows = pack[:q * width].view(q, width)
        cols = pack[q * width:].view(q, 4)
    else:
        all_sum_(prob.mesh, cols)
        rows = prob.x[torch.clamp(wi, 0, prob.x.shape[0] - 1)]
        rows = torch.where(active[:, None], rows, 0.0)
    return (rows, *(cols[:, j].contiguous() for j in range(4)))


def _dist_decomp_step(carry: DistDecompCarry, prob: DistProblem, *,
                      q: int, inner_cap: int, epsilon: float, step_cap: int,
                      n_true: int, pairwise_clip: bool = False,
                      subsolve=sk.launch_inner_subsolve) -> DistDecompCarry:
    """One distributed outer round. ``n_true`` is
    the count of real rows: global indices at or past it are padding.
    alpha and f are updated in place."""
    mesh, n_s, spec = prob.mesh, prob.n_s, prob.spec
    alpha, f = carry.alpha, carry.f
    span = torch.profiler.record_function

    with span("decomp.select"):
        f_up, f_low, _, _ = masked_scores_and_masks(alpha, prob.y, f,
                                                    prob.c_box, prob.valid)
        k2 = q // 2
        # A shard can hold fewer rows than q/2: it then offers its whole
        # slice (the q <= 2n clamp leaves P x k_loc >= q/2 candidates).
        k_loc = min(k2, n_s)
        up_l = top_k_first(-f_up, k_loc)
        low_l = top_k_first(f_low, k_loc)
        (uv, ui), (lv, li) = _merged_top(mesh, [
            ((-f_up)[up_l], up_l + prob.base),
            (f_low[low_l], low_l + prob.base)], k2)
        b_hi = -uv[0]
        b_lo = lv[0]
        w_idx = unique_padded(torch.cat([ui, li]).to(torch.int64), q)
        active = (w_idx >= 0) & (w_idx < n_true)
        wi = torch.where(active, w_idx, 0)
        rows, x2_w, y_w, a_w0, f_w0 = _gather_w(prob, wi, active, alpha, f)
        c_w = _weighted_box(prob.c, prob.weights, y_w)
        if not isinstance(c_w, torch.Tensor):
            c_w = torch.full((q,), np.float32(c_w), device=y_w.device)

    with span("decomp.k_ww"):
        if spec.kind == "precomputed":
            k_ww = rows[:, wi].contiguous()
        else:
            with exact_f32():
                dots_ww = torch.matmul(rows, rows.T)
            k_ww = rows_from_dots(dots_ww, x2_w, x2_w, spec)
            del dots_ww

    with span("decomp.subsolve"):
        a_in, _, _, _, t = subsolve(k_ww, y_w, c_w, a_w0, f_w0, active,
                                    epsilon, step_cap, max_cap=inner_cap,
                                    pairwise=pairwise_clip)
    del k_ww

    with span("decomp.rank_q"):
        dalpha = torch.where(active, a_in - a_w0, 0.0)
        own = active & (torch.div(wi, n_s, rounding_mode="floor")
                        == mesh.rank)
        loc = torch.clamp(wi - prob.base, 0, n_s - 1)
        alpha.index_add_(0, loc, torch.where(own, dalpha, 0.0))
        coef = dalpha * y_w
        if spec.kind == "precomputed":
            rank_q_update(f, coef, rows[:, prob.base:prob.base + n_s]
                          .contiguous(), prob.x_pass, x2_w, prob.x2, spec)
        else:
            rows_pass = (rows if prob.x_pass.dtype == rows.dtype
                         else rows.to(prob.x_pass.dtype))
            rank_q_update(f, coef, rows_pass, prob.local(prob.x_pass), x2_w,
                          prob.local(prob.x2), spec)
    return DistDecompCarry(alpha, f, b_hi, b_lo, carry.n_iter + t,
                           carry.rounds + 1)


def make_dist_decomp_runner(prob: DistProblem, config: SVMConfig, q: int,
                            ws: DecompWorkspace, n_true: int,
                            plain: bool = False):
    """The chunk runner at working-set size q: ``run(carry, limit) ->
    (carry, ChunkStats)`` runs rounds while the gap is open and ``n_iter <
    limit``. The inner cap is ``inner_iters``, or ``max(32, q // 4)``.
    ``plain`` runs the subsolve's plain version on the card too."""
    cap = int(config.inner_iters) or max(32, q // 4)
    two_eps = sk.two_eps_f32(config.epsilon)
    subsolve = (sk.inner_subsolve_plain if plain else
                functools.partial(sk.launch_inner_subsolve, runs=ws.runs))
    kw = dict(q=q, inner_cap=cap, epsilon=float(config.epsilon),
              n_true=int(n_true), pairwise_clip=config.clip == "pairwise",
              subsolve=subsolve)

    def read(carry):
        st = read_stats(dist_stats(carry, prob, rounds=carry.rounds,
                                   runs=(ws.runs[0], ws.runs[1])),
                        shards=prob.mesh.size)
        READS["stats"] += 1
        for count, total, booked in zip((sk.RUNS, sk.STEPS), st.runs,
                                        ws.booked):
            count["inner_subsolve"] += total - booked
        ws.booked = st.runs
        ws.last = st
        return st

    def run(carry: DistDecompCarry, limit: int):
        st = ws.last if ws.last is not None else read(carry)
        while gap_open(st.b_lo, st.b_hi, two_eps) and st.n_iter < limit:
            carry = _dist_decomp_step(carry, prob,
                                      step_cap=min(cap, limit - st.n_iter),
                                      **kw)
            st = read(carry)
        return carry, st

    return run


def init_decomp_carry(prob: DistProblem, init: tuple,
                      rounds: int = 0) -> DistDecompCarry:
    dev = prob.y.device

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    return DistDecompCarry(
        alpha=torch.from_numpy(np.array(init[0], np.float32)).to(dev),
        f=torch.from_numpy(np.array(init[1], np.float32)).to(dev),
        b_hi=scalar(float(np.float32(init[2])), torch.float32),
        b_lo=scalar(float(np.float32(init[3])), torch.float32),
        n_iter=scalar(int(init[4]), torch.int32),
        rounds=scalar(int(rounds), torch.int32))


def train_distributed_decomp(x: np.ndarray, y: np.ndarray,
                             config: SVMConfig, group=None,
                             f_init: Optional[np.ndarray] = None,
                             alpha_init: Optional[np.ndarray] = None,
                             device=None, plain: bool = False
                             ) -> TrainResult:
    """``working_set > 2`` over the ranks of ``group`` (default: the world
    group of ``config.shards`` ranks); call it on every rank with the same
    full (x, y). Seeds, checkpoints and ``plain`` as
    ``dist_smo.train_distributed``; ``grow_working_set`` grows q as on one
    device (the carry does not depend on q)."""
    config.validate()
    n, d = x.shape
    mesh = make_data_mesh(config.shards, group, device)
    gamma = float(config.resolve_gamma(d))
    q = 2 * min(int(config.working_set) // 2, n)
    ckpt = resume_state(config, n, d, gamma, shards=mesh.size)
    di = prepare_distributed_inputs(x, y, config, mesh, ckpt, f_init,
                                    alpha_init, decomp=True)
    ws = DecompWorkspace(mesh.device)
    carry = init_decomp_carry(di.prob, di.init)

    def build(q_now: int):
        q_now = 2 * min(int(q_now) // 2, n)
        return make_dist_decomp_runner(di.prob, config, q_now, ws, n, plain)

    hook = (_make_growth_hook(config, n, q, build)
            if config.grow_working_set else None)
    return host_training_loop(
        config, gamma, carry, build(q),
        lambda cr: (to_host(mesh, cr.alpha, n), to_host(mesh, cr.f, n)),
        poll_hook=hook, it0=int(di.init[4]), dims=x.shape, mesh=mesh)
