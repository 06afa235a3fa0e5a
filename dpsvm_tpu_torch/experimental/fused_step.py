"""Fused SMO iteration: one pass over X per iteration, on Hopper.

Port of ``dpsvm_tpu/experimental/fused_step.py``. Its Pallas TPU kernel
``_fused_iter_kernel`` (reached through ``fused_update_select``) becomes
the hand-written CUDA kernels in ``dpsvm_tpu_torch/csrc/fused_step.cu``:

    prologue  (1 block)  eta, the clipped alpha pair (lo slot written
                         before hi), the pass's scalars
    pass      (grid)     dots = rows . X^T, K = exp(-gamma (x2 + w2 - 2 dots))
                         for hi and lo, f += d_hi K_hi + d_lo K_lo in place,
                         Keerthi-masked scores of the post-update (alpha, f),
                         one (argmin, argmax) partial per block
    finalize  (1 block)  partials -> [i_hi, i_lo], [b_hi, b_lo] in the carry

What bounds it on the card: the pass reads X once per iteration (n*d*4
bytes in f32, n*d*2 in bf16, 188 MB / 94 MB at 60000 x 784, both larger
than the 50 MB L2) for 4*n*d flops, so it is bound by HBM bandwidth. The
design streams X with coalesced 16-byte loads, one warp per row, keeps the
two working rows in shared memory and accumulates with fp32 FMA; it uses
no tensor cores. Ties go to the lower index in both reductions, so the
working set is the one ``jnp.argmin`` / ``jnp.argmax`` pick whatever the
order the blocks ran in. The source's header says more.

The kernels have one wrapper, ``launch_fused_chunk``, which enqueues a
chunk of iterations (three launches each) for CUDA tensors and runs the
plain version, ``run_chunk_plain``, for CPU tensors. ``LAUNCHES`` counts
the launches the wrapper enqueued, per kernel. Launches past the end of a
chunk's work exit at their first instruction; each kernel counts the
launches whose body ran in a carry word of its own, and ``book_runs``
adds them to ``RUNS`` at the poll.

The plain versions (``fused_update_select_plain``,
``fused_prologue_plain``, ``fused_smo_body_plain``) keep the JAX
functions' argument order and run on any device: the CPU path, and the
reference the kernels are held against on the card.

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

# Carry words, as in csrc/fused_step.cu. Words 5-8 are the device's own
# chunk-loop control (S_ACTIVE, S_TRAIL, S_DONE, S_ENTRY there).
S_IHI, S_ILO, S_BHI, S_BLO, S_NITER = 0, 1, 2, 3, 4
S_RUN_PROLOGUE, S_RUN_PASS = 9, 10
STATE_WORDS = 16

PASS_WARPS = 8          # kPassThreads / 32 in the source
BLOCKS_PER_SM = 8

# Per kernel: launches enqueued by launch_fused_chunk (host), and launches
# whose body ran (counted by the kernel on the device, booked at the poll).
# "fused_update_select" is the pass with its finalize.
KERNELS = ("fused_prologue", "fused_update_select")
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
    eps2 = np.float32(two_eps)

    def gap_open() -> bool:
        _, _, b_hi, b_lo, _ = unpack_state(carry.state)
        return bool(b_lo > b_hi + eps2)

    entry = n_iter = unpack_state(carry.state)[4]
    while gap_open() and n_iter < limit:
        fused_smo_body_plain(carry, x, x2, y, c, gamma)
        n_iter += 1
    if (not gap_open() and (n_iter > entry or n_iter == 0)
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
       ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


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
    """Checks the kernels rely on: device, type, shape, contiguity."""
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


def pass_grid(n: int, device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // PASS_WARPS), sms * BLOCKS_PER_SM))


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
        self.grid = pass_grid(n, dev) if dev.type == "cuda" else 0
        self.vec_ok = vec_ok(x)
        self.rows = torch.empty((2, d), dtype=x.dtype, device=dev)
        self.scalars = torch.empty(8, dtype=torch.float32, device=dev)
        self.partials = torch.empty((max(self.grid, 1), 4),
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
    last is the trailing-body slot), three launches each, with no host
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
    iters = limit - ws.n_iter + 1          # + the trailing-body slot
    rc = _lib().dpsvm_fused_chunk(
        _dtype_code(x), carry.state.data_ptr(), x.data_ptr(), x2.data_ptr(),
        y.data_ptr(), carry.alpha.data_ptr(), carry.f.data_ptr(),
        ws.rows.data_ptr(), ws.scalars.data_ptr(), ws.partials.data_ptr(),
        n, d, float(c), float(gamma), float(two_eps), int(limit),
        int(max_iter), iters, ws.grid, ws.vec_ok,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused chunk launch: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(x.device)})")
    for k in KERNELS:
        LAUNCHES[k] += iters
    return iters


def book_runs(ws: FusedWorkspace, n_iter: int, run_prologue: int,
              run_pass: int) -> None:
    """Book the device's run counts (``state[S_RUN_*]``, read by the poll)
    into ``RUNS``, and record the polled n_iter in ``ws``."""
    for k, total in zip(KERNELS, (run_prologue, run_pass)):
        RUNS[k] += total - ws.runs[k]
        ws.runs[k] = total
    ws.n_iter = n_iter
