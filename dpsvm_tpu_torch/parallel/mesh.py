"""The 1-D data mesh over ``torch.distributed`` (port of
``dpsvm_tpu/parallel/mesh.py``).

The reference's process topology is ``mpirun -np P`` with one GPU a node
(``Makefile:74``), the cluster size fixed at ``MPI::COMM_WORLD.Get_size()``
(``svmTrainMain.cpp:153``). The JAX package maps that onto a 1-D device
mesh inside one SPMD program. Here the SPMD is the processes themselves:
one process a device, every rank running the same program over its own
contiguous shard, with the collectives of a process group between them
(NCCL between CUDA ranks, gloo between CPU ranks). So
``shard_map_compat`` and ``pcast_varying`` have no counterpart: there is no
traced program whose replication types need marking, and a value every
rank computes from the same gathered inputs is replicated by construction.

``DataMesh`` carries what a rank needs: the group, its rank and size, and
its device. The owner-read helpers (``owner_read``, ``owner_index``) give
a rank's contribution to a masked sum: the owner of a global row
contributes its value, every other rank zeros, and a sum over ranks
replicates the row (the JAX package's masked ``psum``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from dpsvm_tpu_torch.parallel.multihost import gloo_on_card

NO_GROUP = (
    "shards={shards} needs an initialized process group of {shards} "
    "ranks, one a device: run the CLI's train with --shards {shards} (it "
    "starts the ranks on this host), start them from Python with "
    "dpsvm_tpu_torch.parallel.multihost.launch_local, launch the script "
    "under torchrun, or call dpsvm_tpu_torch.parallel.multihost."
    "initialize(coordinator, num_processes, process_id) in every rank "
    "first")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data mesh."""

    group: object               # the ProcessGroup (None: the default one)
    rank: int
    size: int
    device: torch.device
    backend: str


def _rank_device(backend: str) -> torch.device:
    """The default device of a rank: its CUDA device under NCCL or a gloo
    group on the card (the one ``multihost.initialize`` set), else the
    CPU."""
    if backend == "nccl" or gloo_on_card():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_data_mesh(shards: int, group=None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> DataMesh:
    """The mesh of ``shards`` ranks: the default group (which must hold
    exactly ``shards`` ranks), or ``group`` as given, whose size then
    overrides ``shards`` (the JAX package's explicit ``mesh``).

    The backend follows the device: NCCL between CUDA ranks, gloo between
    CPU ranks. Only a caller that builds its own group, or a world that
    ``multihost.initialize(backend="gloo")`` put on the card, may pair
    gloo with CUDA tensors (gloo stages them through the host)."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(NO_GROUP.format(shards=int(shards)))
        size = dist.get_world_size()
        if size != int(shards):
            raise ValueError(
                f"need {shards} devices for {shards} shards, have {size} "
                f"({dist.get_backend()} ranks). Start one rank a device "
                f"(--shards on the CLI, multihost.launch_local, torchrun).")
    else:
        size = dist.get_world_size(group)
    backend = str(dist.get_backend(group))
    dev = _rank_device(backend) if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available for this rank's device")
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError(f"a CPU rank needs a gloo group, got {backend}")
    if (dev.type == "cuda" and backend != "nccl" and group is None
            and not gloo_on_card()):
        raise ValueError(
            f"a CUDA rank of the default group needs NCCL, got {backend} "
            "(pass device='cpu' for gloo ranks)")
    return DataMesh(group=group, rank=dist.get_rank(group), size=size,
                    device=dev, backend=backend)


def _gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:
        fn = dist.all_gather_into_tensor
    fn(out, t, group=group)


def all_gather(mesh: DataMesh, t: torch.Tensor) -> torch.Tensor:
    """(P, *t.shape): every rank's ``t``, in rank order, on every rank."""
    t = t.contiguous()
    out = t.new_empty((mesh.size,) + tuple(t.shape))
    _gather_into(out.view(-1), t.view(-1), mesh.group)
    return out


def all_sum_(mesh: DataMesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_max_(mesh: DataMesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise largest of ``t`` over the ranks, in place; returns
    it."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


def all_max(mesh: DataMesh, value: float) -> float:
    """The largest of the ranks' host values (a decision every rank
    must take alike: the wall budget's verdict)."""
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t.item())


def owner_read(arr: torch.Tensor, loc: torch.Tensor,
               own: torch.Tensor) -> torch.Tensor:
    """``arr[loc]`` on the owning rank, zeros elsewhere (to be summed over
    ranks by the caller). ``loc`` and ``own`` are 0-d tensors: nothing is
    read back to the host, so a captured graph can hold it."""
    v = arr.index_select(0, loc.reshape(1))[0]
    return torch.where(own, v, torch.zeros_like(v))


def owner_index(gi: torch.Tensor, owner: torch.Tensor, n_s: int
                ) -> torch.Tensor:
    """The local row of global row ``gi`` on rank ``owner``, clamped into
    this rank's shard (the dynamic index of the JAX package clamps too);
    only the owner's read is ever kept."""
    return torch.clamp(gi.to(torch.int64) - owner.to(torch.int64) * n_s,
                       0, n_s - 1)


def shard_probe(n_iter: torch.Tensor, b_lo: torch.Tensor,
                b_hi: torch.Tensor) -> torch.Tensor:
    """This rank's (3,) int32 probe: [n_iter, b_lo bits, b_hi bits], the
    rank's own view of the poll scalars, gathered into the poll's packed
    stats so that the host sees every rank's in the same read. Rows that
    disagree are a mesh out of step (``driver.check_probe``)."""
    return torch.stack([n_iter.to(torch.int32).reshape(()),
                        b_lo.reshape(()).view(torch.int32),
                        b_hi.reshape(()).view(torch.int32)])


def to_host(mesh: DataMesh, local: torch.Tensor, n: int) -> np.ndarray:
    """The global array from every rank's shard: an all-gather of the
    (n_s, ...) shards in rank order, trimmed to the n real rows, as host
    NumPy on every rank (a collective: every rank calls it)."""
    return all_gather(mesh, local).reshape(
        (-1,) + tuple(local.shape[1:]))[:n].cpu().numpy()


def split_rows(m: int, mesh: DataMesh):
    """(lo, hi) of this rank's share of m rows of replicated work that
    the ranks split and then gather (``gather_rows``)."""
    per = -(-m // mesh.size)
    lo = min(mesh.rank * per, m)
    return lo, min(lo + per, m), per


def gather_rows(mesh: DataMesh, part: np.ndarray, per: int,
                m: int) -> np.ndarray:
    """Every rank's ``part`` (its ``split_rows`` share, float32) joined in
    rank order: the same host array on every rank."""
    buf = np.zeros((per,), np.float32)
    buf[:len(part)] = part
    t = torch.from_numpy(buf).to(mesh.device)
    return to_host(mesh, t, m)
