"""Fused SMO iteration: one pass over X per iteration, on Hopper.

Port of ``dpsvm_tpu/experimental/fused_step.py``. Its Pallas TPU kernel
``_fused_iter_kernel`` (reached through ``fused_update_select``) and the
scalar prologue of ``fused_smo_body`` become one hand-written CUDA kernel,
``fused_iter_kernel`` in ``dpsvm_tpu_torch/csrc/fused_step.cu``, launched
once per iteration. Every block computes the prologue (eta, the clipped
alpha pair, the f deltas) itself, then streams its share of X:
dots = rows . X^T, K = exp(-gamma (x2 + w2 - 2 dots)) for hi and lo,
f += d_hi K_hi + d_lo K_lo in place, Keerthi-masked scores of the
post-update (alpha, f), one (argmin, argmax) partial per block; the block
that finishes last reduces the partials into [i_hi, i_lo], [b_hi, b_lo]
and writes the alpha pair (lo slot before hi).

What bounds it on the card: the pass reads X once per iteration (n*d*4
bytes in f32, n*d*2 in bf16, 188 MB / 94 MB at 60000 x 784, both larger
than the 50 MB L2) for 4*n*d flops, so it is bound by HBM bandwidth. The
design keeps many 16-byte loads in flight (units of four rows in a
software pipeline, dealt to the warps and then taken from a device
counter), runs the epilogue of four rows at once and accumulates with
fp32 FMA; it uses no tensor cores. Ties go to the lower
index in both reductions, so the working set is the one ``jnp.argmin`` /
``jnp.argmax`` pick whatever the order the blocks ran in. The source's
header says more; ``launch_geometry`` mirrors its launch shape.

The kernel has one wrapper, ``launch_fused_chunk``, which enqueues a chunk
of iterations (one launch each) for CUDA tensors and runs the plain
version, ``run_chunk_plain``, for CPU tensors. ``LAUNCHES`` counts the
launches the wrapper enqueued. Launches past the end of a chunk's work
exit at their first instruction; the kernel counts the launches whose body
ran in a carry word, and ``book_runs`` adds them to ``RUNS`` at the poll.

The plain versions (``fused_update_select_plain``,
``fused_prologue_plain``, ``fused_smo_body_plain``) keep the JAX
functions' argument order and run on any device: the CPU path, and the
reference the kernel is held against on the card.

Layout differences from the JAX module: vectors are 1-D (n,) and nothing is
padded (the kernel masks the ragged edge itself); the carry's scalars live
in one int32 device tensor, ``state`` (floats as bit patterns), so that a
chunk of iterations runs without the host reading anything.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dpsvm_tpu_torch.ops.selection import masked_scores
from dpsvm_tpu_torch.ops.update import alpha_pair_step
from dpsvm_tpu_torch.solver.driver import gap_open

# Carry words, as in csrc/fused_step.cu. Words 5, 6, 8 and 9 are the
# device's own: chunk-loop control, the blocks' ticket and the pool cursor
# (S_DONE, S_ENTRY, S_TICKET, S_CURSOR there).
S_IHI, S_ILO, S_BHI, S_BLO, S_NITER = 0, 1, 2, 3, 4
S_RUN = 7
STATE_WORDS = 16

# Launch shape, as in the source: kWarps warps a block, at most one block
# per SM, units of kGroup rows of which the first kStaticShare percent are
# dealt to the warps in turn; Hopper's shared memory a block can use.
WARPS = 8
GROUP = 4
UNROLL = 3
STATIC_SHARE = 85
SMEM_LIMIT = 232_448

# Per kernel: launches enqueued by launch_fused_chunk (host), and launches
# whose body ran (counted by the kernel on the device, booked at the poll).
# "fused_update_select" is the whole iteration: prologue, pass, finalize.
KERNELS = ("fused_update_select",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
RUNS = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = RUNS[k] = 0


class FusedCarry(NamedTuple):
    """Loop carry. The working set for the next body rides in ``state``
    (selection moved across the loop back-edge, as in the JAX carry)."""
    alpha: torch.Tensor   # (n,) f32
    f: torch.Tensor       # (n,) f32
    state: torch.Tensor   # (STATE_WORDS,) int32, same device


def pack_state(i_hi, i_lo, b_hi, b_lo, n_iter: int, device) -> torch.Tensor:
    """A fresh carry state from the working set and the iteration count."""
    state = torch.zeros(STATE_WORDS, dtype=torch.int32, device=device)
    state[S_IHI] = i_hi
    state[S_ILO] = i_lo
    b = torch.stack([torch.as_tensor(b_hi, dtype=torch.float32),
                     torch.as_tensor(b_lo, dtype=torch.float32)]).to(device)
    state[S_BHI:S_BLO + 1] = b.view(torch.int32)
    state[S_NITER] = n_iter
    return state


def unpack_state(state: torch.Tensor):
    """(i_hi, i_lo, b_hi, b_lo, n_iter) on the host; b's as np.float32."""
    s = state.cpu().numpy()
    b = s[S_BHI:S_BLO + 1].view(np.float32)
    return int(s[S_IHI]), int(s[S_ILO]), b[0], b[1], int(s[S_NITER])


# ---------------------------------------------------------------- plain

def fused_update_select_plain(rows, scalars, x, x2, y, alpha, f):
    """Plain PyTorch version of the pass + finalize, with the contract of
    the JAX package's ``fused_update_select``: rows (2, d) [x_hi, x_lo] in
    X's type; scalars (8,) f32 [d_hi, d_lo, gamma, w2_hi, w2_lo, C, 0, 0];
    x (n, d) f32 or bf16; x2, y, alpha, f (n,) f32, rows with y == 0 in
    neither index set. Returns (f, sel_i (2,) i32 [i_hi, i_lo], sel_v (2,)
    f32 [b_hi, b_lo]); f is updated in place, as the Pallas call aliases
    it."""
    d_hi, d_lo, gamma, w2_hi, w2_lo, c = (scalars[k] for k in range(6))
    dots = torch.matmul(rows.float(), x.float().T)            # (2, n)
    k_hi = torch.exp(-gamma * (x2 + w2_hi - 2.0 * dots[0]))
    k_lo = torch.exp(-gamma * (x2 + w2_lo - 2.0 * dots[1]))
    f.copy_(f + d_hi * k_hi + d_lo * k_lo)
    f_up, f_low = masked_scores(alpha, y, f, c, valid=y != 0.0)
    i_hi = torch.argmin(f_up)
    i_lo = torch.argmax(f_low)
    sel_i = torch.stack([i_hi, i_lo]).to(torch.int32)
    sel_v = torch.stack([f_up[i_hi], f_low[i_lo]])
    return f, sel_i, sel_v


def fused_prologue_plain(state, x, x2, y, alpha, c: float, gamma: float):
    """Plain PyTorch version of the scalar prologue of ``fused_smo_body``
    (``dpsvm_tpu/experimental/fused_step.py:193-233``): eta from the stored
    x2 and a full-f32 (2, 2) product of the rows, the independently clipped
    pair, lo written before hi (i_hi == i_lo keeps the hi value), and the
    f deltas from the new values. alpha is updated in place. Returns
    (rows (2, d) in x's type, scalars (8,) f32)."""
    i_hi, i_lo, b_hi, b_lo, _ = unpack_state(state)
    dev = x.device
    rows = x[[i_hi, i_lo]]                                    # (2, d)
    rows32 = rows.float()
    x2_hi, x2_lo = x2[i_hi], x2[i_lo]
    pair = torch.matmul(rows32, rows32.T)                     # (2, 2)
    k_hh = torch.exp(-gamma * (2.0 * x2_hi - 2.0 * pair[0, 0]))
    k_ll = torch.exp(-gamma * (2.0 * x2_lo - 2.0 * pair[1, 1]))
    k_hl = torch.exp(-gamma * (x2_hi + x2_lo - 2.0 * pair[0, 1]))
    eta = k_hh + k_ll - 2.0 * k_hl
    y_hi, y_lo = y[i_hi], y[i_lo]
    a_hi, a_lo = alpha[i_hi].clone(), alpha[i_lo].clone()
    f32 = dict(dtype=torch.float32, device=dev)
    a_hi_n, a_lo_n = alpha_pair_step(
        a_hi, a_lo, y_hi, y_lo, torch.tensor(b_hi, **f32),
        torch.tensor(b_lo, **f32), eta, c, c, pairwise=False)
    alpha[i_lo] = a_lo_n
    alpha[i_hi] = a_hi_n
    zero = torch.zeros((), **f32)
    scalars = torch.stack([
        (a_hi_n - a_hi) * y_hi, (a_lo_n - a_lo) * y_lo,
        torch.tensor(gamma, **f32), x2_hi, x2_lo, torch.tensor(c, **f32),
        zero, zero])
    return rows, scalars


def fused_smo_body_plain(carry: FusedCarry, x, x2, y, c: float,
                         gamma: float) -> FusedCarry:
    """One SMO iteration (``fused_smo_body`` of the JAX package,
    ``svmTrainMain.cpp:282-299``) in plain PyTorch on any device: the
    prologue, then the pass. alpha, f and state are updated in place."""
    rows, scalars = fused_prologue_plain(carry.state, x, x2, y, carry.alpha,
                                         c, gamma)
    _, sel_i, sel_v = fused_update_select_plain(rows, scalars, x, x2, y,
                                                carry.alpha, carry.f)
    carry.state[S_IHI:S_ILO + 1] = sel_i
    carry.state[S_BHI:S_BLO + 1] = sel_v.view(torch.int32)
    carry.state[S_NITER] += 1
    return carry


def run_chunk_plain(carry: FusedCarry, x, x2, y, *, c: float, gamma: float,
                    two_eps: float, limit: int, max_iter: int) -> FusedCarry:
    """One chunk (``_run_chunk`` of the JAX package) as a host loop over
    ``fused_smo_body_plain``, in place: bodies while the gap is open and
    ``n_iter < limit``; on convergence, one trailing body that keeps the
    converged b's, gated on progress in this chunk (or ``n_iter == 0``)
    and on ``n_iter < max_iter``."""
    def still_open() -> bool:
        _, _, b_hi, b_lo, _ = unpack_state(carry.state)
        return gap_open(b_lo, b_hi, two_eps)

    entry = n_iter = unpack_state(carry.state)[4]
    while still_open() and n_iter < limit:
        fused_smo_body_plain(carry, x, x2, y, c, gamma)
        n_iter += 1
    if (not still_open() and (n_iter > entry or n_iter == 0)
            and n_iter < max_iter):
        b = carry.state[S_BHI:S_BLO + 1].clone()
        fused_smo_body_plain(carry, x, x2, y, c, gamma)
        carry.state[S_BHI:S_BLO + 1] = b
    return carry


# --------------------------------------------------------------- kernels

_ARGTYPES = {
    "dpsvm_fused_chunk": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
       ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
_GEOMETRY_MISMATCH = -1     # kGeometryMismatch in the source


def _lib() -> ctypes.CDLL:
    from dpsvm_tpu_torch.build import load_library
    lib = load_library("fused_step")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _dtype_code(x: torch.Tensor) -> int:
    if x.dtype == torch.float32:
        return 0
    if x.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"X must be float32 or bfloat16, got {x.dtype}")


def _require(x: torch.Tensor, vectors, state: torch.Tensor) -> None:
    """Checks the kernel relies on: device, type, shape, contiguity."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"X must be a contiguous (n, d) tensor, got "
                         f"{tuple(x.shape)}")
    n = x.shape[0]
    for name, v in vectors.items():
        if (v.device != x.device or v.dtype != torch.float32
                or v.shape != (n,) or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({n},) "
                             f"tensor on {x.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if (state.dtype != torch.int32 or state.shape != (STATE_WORDS,)
            or state.device != x.device):
        raise ValueError("state must be an int32 carry state on X's device")


class Geometry(NamedTuple):
    """One iteration's launch: ``grid`` blocks of ``threads``; X read in
    chunks of ``chunk`` elements (16 bytes, or one element off the vector
    path), ``tail`` chunks of each row past its last whole 32-chunk round;
    ``units`` units of ``group`` rows, the first ``dealt`` dealt to the
    warps in turn and the rest taken from a shared counter; ``smem`` bytes
    of dynamic shared memory; one (argmin, argmax) partial per block."""
    grid: int
    threads: int
    group: int
    chunk: int
    tail: int
    units: int
    dealt: int
    smem: int
    partials: int


def launch_geometry(n: int, d: int, elem: int, sms: int,
                    vec: bool = True) -> Geometry:
    """The kernel's launch shape for an (n, d) X of ``elem``-byte elements
    on a card with ``sms`` SMs: one block per SM (fewer for a small n).
    Raises where the shared memory would not fit."""
    chunk = 16 // elem if vec else 1
    if d % chunk:
        raise ValueError(f"d = {d} does not fill {chunk}-element chunks")
    grid = max(1, min(sms, -(-n // 32)))
    units = -(-n // GROUP)
    gwarps = grid * WARPS
    dealt = units * STATIC_SHARE // 100 // gwarps * gwarps
    # the two working rows as f32, then on the vector path each warp's
    # first UNROLL rounds of GROUP rows of 16-byte chunks, copied ahead
    smem = 4 * 2 * (-(-d // 4) * 4) + (WARPS * UNROLL * GROUP * 32 * 16
                                       if vec else 0)
    if smem > SMEM_LIMIT:
        raise ValueError(f"d = {d} needs {smem} bytes of shared memory, "
                         f"more than a block has ({SMEM_LIMIT})")
    return Geometry(grid, 32 * WARPS, GROUP, chunk, (d // chunk) % 32,
                    units, dealt, smem, grid)


def vec_ok(x: torch.Tensor) -> int:
    """Whole 16-byte loads of every row: d fills them and X is aligned."""
    return int(x.shape[1] % (16 // x.element_size()) == 0
               and x.data_ptr() % 16 == 0)


class FusedWorkspace:
    """Scratch of the CUDA chunk loop, allocated once per training run,
    and the host's record of the carry at the last poll. ``rows`` and
    ``scalars`` hold the last body's prologue output."""

    def __init__(self, x: torch.Tensor, n_iter: int = 0):
        n, d = x.shape
        dev = x.device
        self.vec_ok = vec_ok(x)
        self.geometry = None
        if dev.type == "cuda":
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            self.geometry = launch_geometry(n, d, x.element_size(), sms,
                                            bool(self.vec_ok))
        self.rows = torch.empty((2, d), dtype=x.dtype, device=dev)
        self.scalars = torch.empty(8, dtype=torch.float32, device=dev)
        self.partials = torch.empty(
            (self.geometry.partials if self.geometry else 1, 4),
            dtype=torch.int32, device=dev)
        self.n_iter = n_iter  # polled
        self.runs = dict.fromkeys(KERNELS, 0)   # polled device counts


def launch_fused_chunk(carry: FusedCarry, x, x2, y, ws: FusedWorkspace, *,
                       c: float, gamma: float, two_eps: float, limit: int,
                       max_iter: int) -> int:
    """Advance the carry by one chunk (``_run_chunk`` of the JAX package):
    up to ``limit - n_iter`` bodies while the gap is open, then, on
    convergence, the one trailing do-while body that keeps the converged
    b's. alpha, f and state are updated in place.

    For CUDA tensors this enqueues ``limit - n_iter + 1`` iterations (the
    last is the trailing-body slot), one launch each, with no host
    synchronisation; the device turns the launches it does not need into
    no-ops. For CPU tensors it runs ``run_chunk_plain``. ``ws.n_iter`` must
    be the carry's n_iter at the last poll. Returns the iterations
    enqueued (0 on the CPU)."""
    if x.device.type == "cpu":
        run_chunk_plain(carry, x, x2, y, c=c, gamma=gamma, two_eps=two_eps,
                        limit=limit, max_iter=max_iter)
        return 0
    _require(x, {"x2": x2, "y": y, "alpha": carry.alpha, "f": carry.f},
             carry.state)
    n, d = x.shape
    g = ws.geometry
    iters = limit - ws.n_iter + 1          # + the trailing-body slot
    rc = _lib().dpsvm_fused_chunk(
        _dtype_code(x), carry.state.data_ptr(), x.data_ptr(), x2.data_ptr(),
        y.data_ptr(), carry.alpha.data_ptr(), carry.f.data_ptr(),
        ws.rows.data_ptr(), ws.scalars.data_ptr(), ws.partials.data_ptr(),
        n, d, float(c), float(gamma), float(two_eps), int(limit),
        int(max_iter), iters, g.grid, ws.vec_ok, g.smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc == _GEOMETRY_MISMATCH:
        raise RuntimeError(f"fused chunk launch: launch_geometry gives "
                           f"{g.smem} bytes of shared memory, not the "
                           f"source's layout")
    if rc != 0:
        raise RuntimeError(f"fused chunk launch: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(x.device)})")
    for k in KERNELS:
        LAUNCHES[k] += iters
    return iters


def book_runs(ws: FusedWorkspace, n_iter: int, *runs: int) -> None:
    """Book the device's run counts (``state[S_RUN]``, read by the poll)
    into ``RUNS``, and record the polled n_iter in ``ws``."""
    for k, total in zip(KERNELS, runs):
        RUNS[k] += total - ws.runs[k]
        ws.runs[k] = total
    ws.n_iter = n_iter
