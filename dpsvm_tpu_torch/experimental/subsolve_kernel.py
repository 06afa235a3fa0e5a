"""The decomposition's inner subsolve as one CUDA kernel launch.

Port of ``dpsvm_tpu/experimental/subsolve_kernel.py``. Its Pallas TPU
kernel ``_subsolve_kernel`` (reached through ``pallas_inner_subsolve``)
becomes the hand-written CUDA kernel in ``dpsvm_tpu_torch/csrc/subsolve.cu``:
the whole capped WSS2 SMO subsolve of one decomposition round, up to
``max_cap`` pair updates on the (q, q) block K_WW, in one launch of one
thread-block cluster. Each block of the cluster owns a contiguous range of
the q slots and keeps their alpha, f, diagonal, labels, boxes and index-set
byte in its shared memory; each step reads its slice of two K rows and
does two reductions, each one exchange of records through distributed
shared memory. ``launch_geometry`` gives the launch shape; the source's
header says what bounds the kernel and why it is built so.

The wrapper, ``launch_inner_subsolve``, launches the kernel for CUDA
tensors (or raises) and runs the plain version, ``inner_subsolve_plain``,
for CPU tensors. ``LAUNCHES`` counts the launches the wrapper enqueued;
the kernel counts its own runs, and the steps they took, in two device
words (``runs``), which the decomposition reads in its poll and books into
``RUNS`` and ``STEPS``.

Both versions have the contract of the JAX package's ``inner_subsolve``
(``solver/decomp.py``) and ``pallas_inner_subsolve``: returns
``(a, f, b_hi, b_lo, t)``, with ``t`` an int32 0-d tensor, never carried
through a float. The kernel writes every f32 operation as an explicitly
rounded intrinsic and divides in IEEE, so on the card it is held bitwise
to the plain version, whatever the cluster size.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from dpsvm_tpu_torch.ops.selection import masked_scores_and_masks
from dpsvm_tpu_torch.ops.update import alpha_pair_step

MAX_Q = 16384           # kMaxQ in the source

# Launch shape, as in the source: a cluster of at most MAX_CLUSTER blocks
# of at most MAX_THREADS threads, each thread owning up to MAX_PER pairs
# of slots; SLOT_BYTES of dynamic shared memory a slot (alpha, f,
# diagonal, y, c: float32; the index-set byte) beside STATIC_SMEM bytes of
# 48-byte records (one a warp, and two exchange buffers of one a block)
# and two mbarriers; Hopper's shared memory a block can use. Below
# CLUSTER_MIN_Q slots the launch is one block; from it on the cluster
# doubles until a block has at most BLOCK_SLOTS slots (a step is quickest
# with many small blocks: scripts/subsolve_phases.py, PERF.md section 5).
MAX_CLUSTER = 16
MAX_THREADS = 512
MAX_PER = 8
SLOT_BYTES = 21
STATIC_SMEM = 48 * (MAX_THREADS // 32 + 2 * MAX_CLUSTER) + 16
SMEM_LIMIT = 232_448
CLUSTER_MIN_Q = 512
BLOCK_SLOTS = 256

KERNELS = ("inner_subsolve",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
RUNS = dict.fromkeys(KERNELS, 0)
STEPS = dict.fromkeys(KERNELS, 0)      # inner steps of the runs


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = RUNS[k] = STEPS[k] = 0


def two_eps_f32(epsilon: float) -> np.float32:
    """2 * epsilon as the float32 the loop condition adds to b_hi."""
    return np.float32(2.0 * float(epsilon))


# ---------------------------------------------------------------- plain

def inner_subsolve_plain(k_ww, y_w, c_w, a_w0, f_w0, active, epsilon,
                         step_cap, *, max_cap: int, pairwise: bool):
    """The WSS2 SMO subsolve on a (q, q) block in plain PyTorch, on any
    device: ``inner_subsolve`` of the JAX package step for step. k_ww
    (q, q), y_w, c_w, a_w0, f_w0 (q,) float32; active (q,) bool. Seeded
    with the block's real entry extrema, so an already-optimal block takes
    no step; a step runs while the previous step's stored gap is open and
    ``t < min(step_cap, max_cap)``. Returns (a, f, b_hi, b_lo, t)."""
    dev = k_ww.device
    two_eps = torch.tensor(two_eps_f32(epsilon), device=dev)
    kdiag = torch.diagonal(k_ww)
    a, f = a_w0.clone(), f_w0.clone()
    fu0, fl0, _, _ = masked_scores_and_masks(a, y_w, f, c_w, valid=active)
    b_hi, b_lo = fu0.min(), fl0.max()
    cap = min(int(max_cap), int(step_cap))
    t = 0
    while t < cap and bool(b_lo > b_hi + two_eps):
        fu, fl, _, in_low = masked_scores_and_masks(a, y_w, f, c_w,
                                                    valid=active)
        i_hi = torch.argmin(fu)
        bh = fu[i_hi]
        bl = fl.max()
        row_hi = k_ww[i_hi]
        bb = fl - bh
        aa = torch.clamp(kdiag[i_hi] + kdiag - 2.0 * row_hi, min=1e-12)
        obj = torch.where(in_low & (bb > 0), bb * bb / aa, -1.0)
        i_lo = torch.argmax(obj)
        bl_sel = fl[i_lo]
        row_lo = k_ww[i_lo]
        eta = torch.clamp(kdiag[i_hi] + kdiag[i_lo] - 2.0 * row_hi[i_lo],
                          min=1e-12)
        a_hi, a_lo = a[i_hi].clone(), a[i_lo].clone()
        y_hi, y_lo = y_w[i_hi], y_w[i_lo]
        a_hi_n, a_lo_n = alpha_pair_step(a_hi, a_lo, y_hi, y_lo, bh, bl_sel,
                                         eta, c_w[i_hi], c_w[i_lo], pairwise)
        a[i_lo] = a_lo_n            # lo then hi: i_hi == i_lo keeps hi
        a[i_hi] = a_hi_n
        f = (f + (a_hi_n - a_hi) * y_hi * row_hi
             + (a_lo_n - a_lo) * y_lo * row_lo)
        b_hi, b_lo = bh, bl
        t += 1
    return a, f, b_hi, b_lo, torch.tensor(t, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------- kernel

class Geometry(NamedTuple):
    """One subsolve's launch: one cluster of ``cluster`` blocks of
    ``threads`` threads; block r owns slots [r * slots, (r + 1) * slots)
    (the last block fewer, or none), thread t of a block the slot pairs
    2 (t + threads p) + {0, 1} for p < ``per``; ``smem`` bytes of dynamic
    shared memory a block."""
    cluster: int
    threads: int
    slots: int
    per: int
    smem: int


def launch_geometry(q: int, sms: int,
                    cluster: Optional[int] = None) -> Geometry:
    """The kernel's launch shape for a (q, q) block on a card with ``sms``
    SMs. ``cluster`` forces the cluster size (a power of two up to
    MAX_CLUSTER); by default it is 1 below CLUSTER_MIN_Q and otherwise the
    smallest that leaves a block at most BLOCK_SLOTS slots. Raises where
    the shape does not fit."""
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"the inner-subsolve kernel takes 1 <= q <= "
                         f"{MAX_Q}, got q={q}")
    if cluster is None:
        cluster = 1
        if q >= CLUSTER_MIN_Q:
            while cluster < MAX_CLUSTER and q > cluster * BLOCK_SLOTS:
                cluster *= 2
    if (cluster < 1 or cluster & (cluster - 1) or cluster > MAX_CLUSTER
            or cluster > sms):
        raise ValueError(f"a cluster is a power of two up to "
                         f"{min(MAX_CLUSTER, sms)} blocks, got {cluster}")
    slots = 2 * -(-q // (2 * cluster))              # even: whole pairs
    threads = min(MAX_THREADS, 32 * -(-slots // 64))
    per = 1
    while 2 * threads * per < slots:
        per *= 2
    smem = slots * SLOT_BYTES
    if per > MAX_PER or smem + STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"q={q} in a cluster of {cluster} gives a block "
                         f"{slots} slots, {smem + STATIC_SMEM} bytes of "
                         f"shared memory; a block has {SMEM_LIMIT}")
    return Geometry(cluster, threads, slots, per, smem)


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
_GEOMETRY_MISMATCH = -1     # kGeometryMismatch in the source
_UNSCHEDULABLE = -2         # kClusterUnschedulable


def _lib() -> ctypes.CDLL:
    from dpsvm_tpu_torch.build import load_library
    lib = load_library("subsolve")
    lib.dpsvm_inner_subsolve.argtypes = _ARGTYPES
    lib.dpsvm_inner_subsolve.restype = ctypes.c_int
    return lib


def _require(k_ww, vectors, active, runs) -> int:
    """Checks the kernel relies on: device, type, shape, contiguity, and
    the q it takes. Returns q."""
    if k_ww.dim() != 2 or k_ww.shape[0] != k_ww.shape[1]:
        raise ValueError(f"k_ww must be a (q, q) tensor, got "
                         f"{tuple(k_ww.shape)}")
    q = k_ww.shape[0]
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"the inner-subsolve kernel takes 1 <= q <= "
                         f"{MAX_Q} (alpha, f and the diagonal of the "
                         f"block live in one cluster's shared memory), got "
                         f"q={q}")
    for name, v in (("k_ww", k_ww), *vectors.items()):
        if (v.device != k_ww.device or v.dtype != torch.float32
                or not v.is_contiguous()
                or (name != "k_ww" and v.shape != (q,))):
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"of the block's size on {k_ww.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
    if (active.dtype != torch.bool or active.shape != (q,)
            or active.device != k_ww.device or not active.is_contiguous()):
        raise ValueError(f"active must be a contiguous bool ({q},) tensor "
                         f"on {k_ww.device}")
    if (runs.dtype != torch.int32 or runs.numel() < 2
            or runs.device != k_ww.device or not runs.is_contiguous()):
        raise ValueError("runs must be two contiguous int32 words on "
                         "k_ww's device")
    return q


def launch_inner_subsolve(k_ww, y_w, c_w, a_w0, f_w0, active, epsilon,
                          step_cap, *, max_cap: int, pairwise: bool,
                          runs=None, cluster: Optional[int] = None):
    """Run the capped subsolve (see ``inner_subsolve_plain``) in one
    kernel launch for CUDA tensors, or as the plain version for CPU
    tensors. ``runs``: two int32 device words; the kernel adds one to the
    first when its body runs and its steps t to the second (scratch words
    if None). ``cluster`` forces the cluster size (``launch_geometry``).
    Returns (a, f, b_hi, b_lo, t) as tensors on the inputs' device;
    nothing is read back to the host."""
    if k_ww.device.type == "cpu":
        return inner_subsolve_plain(k_ww, y_w, c_w, a_w0, f_w0, active,
                                    epsilon, step_cap, max_cap=max_cap,
                                    pairwise=pairwise)
    dev = k_ww.device
    if runs is None:
        runs = torch.zeros(2, dtype=torch.int32, device=dev)
    q = _require(k_ww, {"y_w": y_w, "c_w": c_w, "a_w0": a_w0,
                        "f_w0": f_w0}, active, runs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = launch_geometry(q, sms, cluster)
    a = torch.empty_like(a_w0)
    f = torch.empty_like(f_w0)
    out = torch.empty(3, dtype=torch.int32, device=dev)
    rc = _lib().dpsvm_inner_subsolve(
        k_ww.data_ptr(), y_w.data_ptr(), c_w.data_ptr(), active.data_ptr(),
        a_w0.data_ptr(), f_w0.data_ptr(), a.data_ptr(), f.data_ptr(),
        out.data_ptr(), runs.data_ptr(), q, float(two_eps_f32(epsilon)),
        int(step_cap), int(max_cap), int(bool(pairwise)), g.cluster,
        g.threads, g.slots, g.smem, torch.cuda.current_stream(dev).cuda_stream)
    if rc == _GEOMETRY_MISMATCH:
        raise RuntimeError(f"inner subsolve launch: launch_geometry gives "
                           f"{g}, not the source's layout")
    if rc == _UNSCHEDULABLE:
        raise RuntimeError(f"inner subsolve launch: a cluster of "
                           f"{g.cluster} blocks of {g.threads} threads and "
                           f"{g.smem} bytes of shared memory cannot be "
                           f"resident on {torch.cuda.get_device_name(dev)} "
                           f"(cudaOccupancyMaxActiveClusters is 0)")
    if rc != 0:
        raise RuntimeError(f"inner subsolve launch: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(dev)}, q={q}, "
                           f"{g})")
    LAUNCHES["inner_subsolve"] += 1
    b = out[:2].view(torch.float32)
    return a, f, b[0], b[1], out[2]
