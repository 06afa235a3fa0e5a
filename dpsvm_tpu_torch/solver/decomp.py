"""Large-working-set SMO decomposition (port of ``dpsvm_tpu/solver/decomp.py``).

One outer round:

1. select the top q/2 violators from I_up (smallest f) and the top q/2
   from I_low (largest f), ties to the lower index as ``lax.top_k`` breaks
   them; the union, deduplicated and padded with inactive slots, is the
   working set W;
2. K_WW = rows . rows^T in exact float32 (TF32 off whatever the caller set)
   with the kernel's epilogue (``KernelSpec``: every LIBSVM kind); for a
   precomputed kernel, where X is K, the (q, q) block is gathered;
3. the capped WSS2 subsolve on K_WW: on the card one launch of the CUDA
   kernel ``csrc/subsolve.cu`` (``launch_inner_subsolve``), on the CPU its
   plain version;
4. the rank-q update: alpha[W] += dalpha and f += (dalpha y_W) . K_WN, with
   K_WN = kernel(rows . X^T) in column blocks of n so the (q, n)
   intermediate never exists whole (precomputed: the gathered K rows).

The two matrix products stay ``torch.matmul`` (the JAX package leaves them
to XLA). With ``matmul_precision="default"`` the rank-q pass reads a
bfloat16 copy of X and accumulates in float32, as the JAX package's
DEFAULT precision does on its chip; K_WW and the norms stay float32. A
precomputed K is never copied to bfloat16 (the JAX package keeps it in
float32).

Rounds run while ``b_lo > b_hi + 2 eps`` and ``n_iter < limit``, each with
``step_cap = min(inner_cap, limit - n_iter)``, so ``n_iter`` (inner pair
updates) stops exactly at the budget. The b's a round stores are its
pre-update outer extrema, so the loop ends one round after the gap closes:
that round takes no inner step but counts in ``rounds``, as in JAX.

Nothing is read back to the host inside a round. The round loop reads one
packed-stats tensor per round (its condition needs the gap and n_iter);
the last read of a chunk is the driver's poll. The four parts of a round
run inside ``torch.profiler`` ranges named ``decomp.select``,
``decomp.k_ww``, ``decomp.subsolve`` and ``decomp.rank_q``.

The ``valid`` mask (the shrinking manager's padded capacities, as in the
general pair): rows where it is False never enter selection, and a
padding row drawn into W as top-k filler reaches the subsolve as a masked
slot. A run resumes from a checkpoint with the saved (alpha, f, b_hi,
b_lo, n_iter); its ``rounds`` count restarts at 0 (telemetry, not solver
state). The distributed decomposition is not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SENTINEL, SVMConfig, TrainResult
from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
from dpsvm_tpu_torch.ops.kernels import (KernelSpec, dots_f32, exact_f32,
                                         host_row_stats, rows_from_dots)
from dpsvm_tpu_torch.ops.selection import (masked_scores_and_masks,
                                           top_k_first, unique_padded,
                                           valid_rows)
from dpsvm_tpu_torch.solver.driver import (ChunkStats, device_sv_count,
                                           gap_open, host_training_loop,
                                           pack_stats, read_stats,
                                           resume_state)

# Elements of one (q, columns) block of the rank-q pass: 1 GiB in float32.
# Two such blocks are alive at once (the dots and the kernel block).
RANK_Q_BLOCK_ELEMS = 1 << 28


class DecompCarry(NamedTuple):
    alpha: torch.Tensor    # (n,) f32
    f: torch.Tensor        # (n,) f32
    b_hi: torch.Tensor     # () f32 latest global selection
    b_lo: torch.Tensor     # () f32
    n_iter: torch.Tensor   # () i32 cumulative INNER pair-updates
    rounds: torch.Tensor   # () i32 outer rounds


def init_carry(y: torch.Tensor) -> DecompCarry:
    """alpha = 0, f = -y; sentinel b's force the first round."""
    dev = y.device

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    return DecompCarry(alpha=torch.zeros_like(y), f=-y,
                       b_hi=scalar(-SENTINEL, torch.float32),
                       b_lo=scalar(SENTINEL, torch.float32),
                       n_iter=scalar(0, torch.int32),
                       rounds=scalar(0, torch.int32))


@dataclasses.dataclass
class DecompProblem:
    """The device-side inputs of a run: X in float32 (K_WW and the norms;
    K itself for a precomputed kernel), the X the rank-q pass reads (a
    bfloat16 copy under "default"), labels, the host-computed x2 slot
    (squared norms, or diag(K)), the per-example box and the kernel."""
    x: torch.Tensor
    x_pass: torch.Tensor
    y: torch.Tensor
    x2: torch.Tensor
    gamma: float
    c: float
    c_box: object          # float C, or the (n,) f32 per-example box
    spec: KernelSpec = KernelSpec()

    @classmethod
    def build(cls, x: np.ndarray, y: np.ndarray, config: SVMConfig,
              device: torch.device) -> "DecompProblem":
        spec = config.kernel_spec(x.shape[1])
        xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
        x_pass = (xd.to(torch.bfloat16) if config.matmul_precision == "default"
                  and spec.kind != "precomputed" else xd)
        yd = torch.from_numpy(np.asarray(y, np.float32)).to(device)
        x2 = torch.from_numpy(host_row_stats(x, spec)).to(device)
        c = float(config.c)
        wp, wn = float(config.weight_pos), float(config.weight_neg)
        c_box = c
        if wp != 1.0 or wn != 1.0:
            c_box = torch.where(
                yd > 0, torch.tensor(np.float32(c * wp), device=device),
                torch.tensor(np.float32(c * wn), device=device))
        return cls(xd, x_pass, yd, x2, float(spec.gamma), c, c_box, spec)


def rank_q_update(f: torch.Tensor, coef: torch.Tensor, rows: torch.Tensor,
                  x_pass: torch.Tensor, x2w: torch.Tensor, x2: torch.Tensor,
                  spec) -> None:
    """f += coef . K_WN in place, K_WN = kernel(rows . X^T) built one
    column block at a time (``RANK_Q_BLOCK_ELEMS``); for a precomputed
    kernel ``rows`` are the gathered K rows, K_WN itself."""
    spec = KernelSpec.coerce(spec)
    if spec.kind == "precomputed":
        with exact_f32():
            f += torch.matmul(coef, rows)
        return
    n, q = x_pass.shape[0], rows.shape[0]
    step = max(1, min(n, RANK_Q_BLOCK_ELEMS // max(q, 1)))
    for s in range(0, n, step):
        e = min(n, s + step)
        k = rows_from_dots(dots_f32(rows, x_pass[s:e]), x2w, x2[s:e], spec)
        with exact_f32():
            f[s:e] += torch.matmul(coef, k)


def decomp_step(carry: DecompCarry, prob: DecompProblem, *, q: int,
                inner_cap: int, epsilon: float, step_cap: int,
                pairwise_clip: bool = False,
                subsolve: Callable = sk.launch_inner_subsolve,
                valid: Optional[torch.Tensor] = None) -> DecompCarry:
    """One outer round (select q -> K_WW -> subsolve -> rank-q update).
    ``step_cap`` caps the round's inner steps (``min(inner_cap, limit -
    n_iter)``, from the last poll). ``subsolve`` has the contract of
    ``launch_inner_subsolve``; the plain path passes
    ``inner_subsolve_plain``. Rows where ``valid`` is False are in
    neither index set. alpha and f are updated in place."""
    alpha, f, y = carry.alpha, carry.f, prob.y
    span = torch.profiler.record_function

    with span("decomp.select"):
        # Top q/2 violators per side.
        f_up, f_low, _, _ = masked_scores_and_masks(alpha, y, f, prob.c_box,
                                                    valid)
        up_idx = top_k_first(-f_up, q // 2)      # ascending f: worst first
        low_idx = top_k_first(f_low, q // 2)     # descending f
        b_hi = f_up[up_idx[0]]
        b_lo = f_low[low_idx[0]]
        # Dedup (an interior alpha is in both sets), padding with -1;
        # padded slots map to row 0 and stay inactive. W keeps
        # jnp.unique's order, which is the order the subsolve breaks its
        # ties in.
        w_idx = unique_padded(torch.cat([up_idx, low_idx]), q)
        active = w_idx >= 0
        wi = torch.where(active, w_idx, 0)
        if valid is not None:
            # capacity padding picked as top-k filler when the real
            # violators run out: a masked slot, frozen in the subsolve
            active = active & valid[wi]
        y_w = y[wi]
        a_w0 = alpha[wi]
        f_w0 = f[wi]
        if isinstance(prob.c_box, torch.Tensor):
            c_w = prob.c_box[wi]
        else:
            c_w = torch.full((q,), np.float32(prob.c), device=y.device)

    with span("decomp.k_ww"):
        # K_WW exactly, in float32 (a bf16 block is not PSD enough: see
        # the JAX module's note); for a precomputed kernel, a column
        # gather of the stored K rows.
        rows = prob.x[wi]
        x2w = prob.x2[wi]
        if prob.spec.kind == "precomputed":
            k_ww = rows[:, wi]
        else:
            with exact_f32():
                dots_ww = torch.matmul(rows, rows.T)
            k_ww = rows_from_dots(dots_ww, x2w, x2w, prob.spec)
            del dots_ww

    with span("decomp.subsolve"):
        a_in, _, _, _, t = subsolve(k_ww, y_w, c_w, a_w0, f_w0, active,
                                    epsilon, step_cap, max_cap=inner_cap,
                                    pairwise=pairwise_clip)
    del k_ww

    with span("decomp.rank_q"):
        # Padding slots carry dalpha == 0, so the repeated index-0 adds
        # are exact.
        dalpha = torch.where(active, a_in - a_w0, 0.0)
        alpha.index_add_(0, wi, dalpha)
        rows_pass = rows if prob.x_pass is prob.x else prob.x_pass[wi]
        rank_q_update(f, dalpha * y_w, rows_pass, prob.x_pass, x2w, prob.x2,
                      prob.spec)
    return DecompCarry(alpha, f, b_hi, b_lo, carry.n_iter + t,
                       carry.rounds + 1)


# Packed-stats reads of the decomposition's round loops, ever (one per
# round, plus the first of each run).
READS = {"stats": 0}


class DecompWorkspace:
    """Per-run state beside the carry: the device words kernel B counts its
    runs and steps in, what of them is booked into ``subsolve_kernel.RUNS``
    and ``STEPS``, and the stats of the last read (a chunk starts from
    them instead of reading the same state again)."""

    def __init__(self, device: torch.device):
        self.runs = torch.zeros(2, dtype=torch.int32, device=device)
        self.booked = (0, 0)
        self.last: Optional[ChunkStats] = None


def _stats(carry: DecompCarry, ws: DecompWorkspace) -> torch.Tensor:
    return pack_stats(carry.n_iter, carry.b_lo.view(torch.int32),
                      carry.b_hi.view(torch.int32),
                      device_sv_count(carry.alpha), carry.rounds,
                      ws.runs[0], ws.runs[1])


def make_runner(prob: DecompProblem, config: SVMConfig, q: int,
                ws: DecompWorkspace, plain: bool = False,
                n_valid: Optional[int] = None):
    """The chunk runner at working-set size q (``_build_decomp_runner``):
    ``run(carry, limit) -> (carry, ChunkStats)`` runs rounds while the gap
    is open and ``n_iter < limit``. The inner cap is ``inner_iters``, or
    ``max(32, q // 4)`` when that is 0. ``plain`` runs the subsolve's
    plain version on any device (the reference the kernel path is held
    against on the card). ``n_valid`` masks the rows at or past it out of
    selection (the ``masked=True`` runner of the JAX package)."""
    cap = int(config.inner_iters) or max(32, q // 4)
    two_eps = sk.two_eps_f32(config.epsilon)
    subsolve = (sk.inner_subsolve_plain if plain else
                functools.partial(sk.launch_inner_subsolve, runs=ws.runs))
    valid = (None if n_valid is None else
             valid_rows(prob.y.shape[0], n_valid, prob.y.device))
    kw = dict(q=q, inner_cap=cap, epsilon=float(config.epsilon),
              pairwise_clip=config.clip == "pairwise", subsolve=subsolve,
              valid=valid)

    def read(carry):
        st = read_stats(_stats(carry, ws))
        READS["stats"] += 1
        for count, total, booked in zip((sk.RUNS, sk.STEPS), st.runs,
                                        ws.booked):
            count["inner_subsolve"] += total - booked
        ws.booked = st.runs
        ws.last = st
        return st

    def run(carry: DecompCarry, limit: int):
        st = ws.last if ws.last is not None else read(carry)
        while gap_open(st.b_lo, st.b_hi, two_eps) and st.n_iter < limit:
            carry = decomp_step(carry, prob, step_cap=min(cap, limit
                                                          - st.n_iter),
                                **kw)
            st = read(carry)
        return carry, st

    return run


# Growth-manager tuning, the JAX package's constants and reasons
# (dpsvm_tpu/solver/decomp.py): check cadence backing off from
# GROW_CHECK_MIN to GROW_CHECK_MAX inner updates while nothing grows;
# growth when n_sv passes GROW_AT_OCCUPANCY of q, to GROW_TARGET_FACTOR x
# n_sv rounded up to GROW_QUANTUM. GROW_HBM_BUDGET bounds the grown q by
# 8 bytes per (q-row x example) there; the port's rank-q pass works in
# column blocks, but it keeps the bound so that both packages grow
# through the same q.
GROW_CHECK_MIN = 2_048
GROW_CHECK_MAX = 16_384
GROW_AT_OCCUPANCY = 0.75
GROW_TARGET_FACTOR = 1.5
GROW_QUANTUM = 2_048
GROW_HBM_BUDGET = 8 * 1024 ** 3


def _make_growth_hook(config: SVMConfig, n: int, q0: int, build):
    """poll_hook implementing adaptive working-set growth: whenever the
    polled SV count passes GROW_AT_OCCUPANCY of the block, the runner is
    rebuilt at GROW_TARGET_FACTOR x n_sv (rounded up to GROW_QUANTUM, at
    least doubled, capped by the validation bound, n and the budget). The
    carry does not depend on q, so growth is a new runner only."""
    q_mem = int(GROW_HBM_BUDGET // (8 * max(n, 1)))
    q_max = min(16_384, n - (n % 2), max(q_mem - (q_mem % 2), q0))
    state = {"q": q0, "last_check": 0, "cadence": GROW_CHECK_MIN}

    def hook(n_iter: int, carry, stats):
        if (state["q"] >= q_max
                or n_iter - state["last_check"] < state["cadence"]):
            return None
        state["last_check"] = n_iter
        n_sv = int(stats.n_sv)
        if n_sv <= GROW_AT_OCCUPANCY * state["q"]:
            state["cadence"] = min(2 * state["cadence"], GROW_CHECK_MAX)
            return None
        state["cadence"] = GROW_CHECK_MIN
        target = int(np.ceil(GROW_TARGET_FACTOR * n_sv / GROW_QUANTUM)
                     * GROW_QUANTUM)
        new_q = min(q_max, max(2 * state["q"], target))
        new_q -= new_q % 2
        if new_q <= state["q"]:
            return None
        if config.verbose:
            print(f"[grow] n_sv={n_sv} at q={state['q']} "
                  f"(occupancy {n_sv / state['q']:.2f}) -> q={new_q}",
                  file=sys.stderr, flush=True)
        state["q"] = new_q
        return build(new_q)

    return hook


def train_single_device_decomp(x: np.ndarray, y: np.ndarray,
                               config: SVMConfig, device: torch.device,
                               plain: bool = False,
                               f_init: Optional[np.ndarray] = None,
                               alpha_init: Optional[np.ndarray] = None
                               ) -> TrainResult:
    """Train with working_set = q > 2 on one device: the CUDA subsolve
    kernel on the card, its plain version on the CPU (or anywhere, with
    ``plain``). q = 2 min(q/2, n): a problem smaller than the block
    degrades to a smaller one. ``f_init`` / ``alpha_init`` override
    f = -y, alpha = 0 (``api.warm_start``); a checkpoint
    (``config.resume_from``) takes precedence."""
    config.validate()
    n = x.shape[0]
    q = 2 * min(int(config.working_set) // 2, n)
    prob = DecompProblem.build(x, y, config, device)
    ws = DecompWorkspace(device)
    carry = init_carry(prob.y)

    def vec(v):
        return torch.from_numpy(np.asarray(v, np.float32).copy()).to(device)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    ckpt = resume_state(config, n, x.shape[1], prob.gamma)
    if ckpt is not None:
        carry = carry._replace(
            alpha=vec(ckpt.alpha), f=vec(ckpt.f),
            b_hi=scalar(float(np.float32(ckpt.b_hi)), torch.float32),
            b_lo=scalar(float(np.float32(ckpt.b_lo)), torch.float32),
            n_iter=scalar(int(ckpt.n_iter), torch.int32))
    else:
        if f_init is not None:
            carry = carry._replace(f=vec(f_init))
        if alpha_init is not None:
            carry = carry._replace(alpha=vec(alpha_init))

    def build(q_now: int):
        return make_runner(prob, config, q_now, ws, plain)

    hook = (_make_growth_hook(config, n, q, build)
            if config.grow_working_set else None)
    return host_training_loop(
        config, prob.gamma, carry, build(q),
        lambda cr: (cr.alpha.cpu().numpy(), cr.f.cpu().numpy()),
        poll_hook=hook, it0=int(carry.n_iter), dims=x.shape)
