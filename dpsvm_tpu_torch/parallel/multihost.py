"""Multi-process runtime: lifecycle, identity, launcher (port of
``dpsvm_tpu/parallel/multihost.py``).

The reference scales across machines with ``mpirun --hostfile hf``
(``svmTrainMain.cpp:144-159``, ``Makefile:74``). Here each rank is one
process with one device, joined by ``torch.distributed``: NCCL between
CUDA ranks, gloo between CPU ranks, or, asked for by name, gloo between
CUDA ranks that share cards (``backend="gloo"``; the CLI's
``--dist-backend gloo``). Three ways to start a group:

* across hosts, one command a rank with an explicit coordinator:
  ``python -m dpsvm_tpu_torch train --coordinator host0:29500
  --num-hosts 4 --host-id $RANK --shards 4 ...`` (``initialize`` with the
  three arguments: ``tcp://`` rendezvous);
* under ``torchrun``, whose environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ...) ``initialize()`` with no arguments reads
  (``env://``), the counterpart of the JAX package's discovery through the
  metadata server;
* on this host, ``launch_local(P, fn)``: P ranks started as processes, one
  device each (``cuda:<rank>``, or gloo ranks on the CPU), the counterpart
  of ``mpirun -np P``. The CLI's ``--shards P``, the tests and
  ``chip_smoke.py`` start their ranks so.

Every rendezvous and every collective gets a timeout
(``INIT_TIMEOUT_S``), so a rank that never arrives fails its group instead
of hanging it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import time
import traceback
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Seconds a rendezvous or a collective may wait for the other ranks.
INIT_TIMEOUT_S = 120.0


#: Whether this process's group is gloo between CUDA ranks
#: (``initialize(backend="gloo")`` on the card): ranks that share cards.
_GLOO_ON_CARD = {"on": False}


def _device_of(device) -> torch.device:
    if device is None:
        device = os.environ.get("DPSVM_DEVICE", "cuda")
    return torch.device(device)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None, store=None,
               timeout_s: float = INIT_TIMEOUT_S,
               backend: Optional[str] = None) -> None:
    """Join (or create) the process group. Idempotent.

    ``coordinator`` ("host:port") with ``num_processes`` and
    ``process_id`` is a ``tcp://`` rendezvous; ``store`` (a
    ``torch.distributed`` store) replaces it; with neither, the
    environment ``torchrun`` sets is read (``env://``). The rank's device
    is ``device``, else ``DPSVM_DEVICE`` (``local_host_env``), else the
    card: a CUDA rank takes ``cuda:<LOCAL_RANK>`` and NCCL, a CPU rank
    gloo. A missing card is an error, never a quiet move to gloo.
    ``backend="gloo"`` on CUDA ranks lets ranks share cards: the rank
    takes ``cuda:<LOCAL_RANK mod cards>`` and gloo stages its collectives
    through the host (slow: for drills and tests on fewer cards than
    ranks)."""
    if is_initialized():
        return
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend}")
    dev = _device_of(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA is not available for a {backend or 'nccl'} rank on "
                "the card: pass device='cpu' (CLI: --device cpu) for gloo "
                "ranks on the CPU")
        local = (dev.index if dev.index is not None else
                 int(os.environ.get("LOCAL_RANK", process_id or 0)))
        if backend == "gloo":
            local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
        backend = backend or "nccl"
    elif dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA ranks: a CPU rank is gloo")
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    _GLOO_ON_CARD["on"] = dev.type == "cuda" and backend == "gloo"
    kwargs = dict(backend=backend,
                  timeout=datetime.timedelta(seconds=float(timeout_s)))
    if store is not None:
        kwargs.update(store=store, world_size=int(num_processes),
                      rank=int(process_id))
    elif coordinator is not None:
        kwargs.update(init_method=f"tcp://{coordinator}",
                      world_size=int(num_processes), rank=int(process_id))
    else:
        kwargs.update(init_method="env://")
    dist.init_process_group(**kwargs)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def gloo_on_card() -> bool:
    """Whether this process is a CUDA rank of a gloo group that
    ``initialize(backend="gloo")`` made (ranks sharing cards)."""
    return is_initialized() and _GLOO_ON_CARD["on"]


def host_count() -> int:
    """Ranks in the group; 1 on an uninitialized process."""
    return dist.get_world_size() if is_initialized() else 1


def host_id() -> int:
    """This process's rank; 0 on an uninitialized process."""
    return dist.get_rank() if is_initialized() else 0


def host_allgather(value) -> np.ndarray:
    """``value`` stacked across ranks -> ``(host_count, ...)``. On an
    uninitialized process a NumPy wrap, shape ``(1, ...)``; in a group a
    collective every rank must call."""
    if not is_initialized():
        return np.asarray(value)[None]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, np.asarray(value))
    return np.stack(out)


def process_info() -> str:
    """Rank banner (the reference's Get_rank/Get_processor_name,
    ``svmTrainMain.cpp:154-167``)."""
    if not is_initialized():
        return "process 0/1 (no process group)"
    dev = (f"cuda:{torch.cuda.current_device()}"
           if dist.get_backend() == "nccl" else "cpu")
    return (f"process {dist.get_rank()}/{dist.get_world_size()}, "
            f"{dist.get_backend()} on {dev}, "
            f"{torch.cuda.device_count()} local GPUs")


def topology() -> dict:
    """Process and device facts as one dictionary, for logs."""
    try:
        cuda = torch.cuda.is_available()
        n = torch.cuda.device_count() if cuda else 0
        return {
            "platform": "gpu" if cuda else "cpu",
            "local_devices": n,
            "processes": host_count(),
            "process_id": host_id(),
            "backend": dist.get_backend() if is_initialized() else None,
            "device_kinds": sorted({torch.cuda.get_device_name(i)
                                    for i in range(n)}),
        }
    except Exception as e:               # report, not raise
        return {"error": f"{type(e).__name__}: {e}"}


def find_free_port() -> int:
    """A free localhost TCP port for a coordinator (bind-to-0 probe; a
    clash in the short window before the coordinator binds fails loudly)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def coordinator_reachable(coordinator: str,
                          timeout_s: float = 5.0) -> Optional[str]:
    """None when a TCP connect to ``host:port`` succeeds within the
    deadline; else the one-line reason."""
    host, sep, port = coordinator.rpartition(":")
    if not sep or not port.isdigit():
        return (f"malformed coordinator address {coordinator!r} "
                "(want host:port)")
    try:
        with socket.create_connection((host or "127.0.0.1", int(port)),
                                      timeout=timeout_s):
            return None
    except OSError as e:
        return (f"coordinator {coordinator} unreachable within "
                f"{timeout_s:g}s ({e})")


def local_host_env(host_id: int, base: Optional[Dict[str, str]] = None,
                   device: str = "cuda") -> Dict[str, str]:
    """Environment for one local rank: its rank numbers and its one
    device, ``cuda:<local rank>`` or the CPU (``DPSVM_DEVICE``, which
    ``initialize`` reads)."""
    env = dict(os.environ if base is None else base)
    env["DPSVM_HOST_ID"] = str(int(host_id))
    env["LOCAL_RANK"] = str(int(host_id))
    env["DPSVM_DEVICE"] = (f"cuda:{int(host_id)}"
                           if torch.device(device).type == "cuda" else "cpu")
    return env


class RanksFailedError(RuntimeError):
    """Ranks of a local world failed. ``causes`` holds the exceptions the
    failed ranks raised, where they could be sent back (the elastic
    supervisor looks for a lost shard or a preemption among them)."""

    def __init__(self, message: str, causes=()):
        super().__init__(message)
        self.causes = list(causes)


def _picklable(exc: BaseException):
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return None


def _rank_main(rank: int, nprocs: int, store_path: str, device: str,
               fn: Callable, args: Sequence, out_path: str,
               timeout_s: float, events: Sequence = (),
               backend: Optional[str] = None) -> None:
    os.environ.update(local_host_env(rank, base={}, device=device))
    if events:
        from dpsvm_tpu_torch.solver import driver
        for event, extra in events:
            driver.queue_trace_event(event, **extra)
    if torch.device(device).type == "cpu":
        # the ranks share this host's cores: one share each, so that no
        # rank's thread pool fights the others'
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    try:
        initialize(num_processes=nprocs, process_id=rank,
                   store=dist.FileStore(store_path, nprocs),
                   timeout_s=timeout_s, backend=backend)
        result = fn(rank, *args)
        with open(out_path, "wb") as fh:
            pickle.dump(("ok", result), fh)
    except BaseException as e:
        with open(out_path, "wb") as fh:
            pickle.dump(("error", (traceback.format_exc(), _picklable(e))),
                        fh)
        raise SystemExit(1)
    finally:
        if is_initialized():
            dist.destroy_process_group()


def launch_local(nprocs: int, fn: Callable, args: Sequence = (),
                 device: str = "cuda",
                 timeout_s: float = INIT_TIMEOUT_S,
                 run_timeout_s: Optional[float] = None,
                 backend: Optional[str] = None) -> list:
    """Start ``nprocs`` ranks on this host and return ``fn(rank, *args)``
    of each, in rank order (``fn`` and ``args`` must pickle: a function of
    an importable module).

    Each rank is a spawned process with its group initialized (a
    ``FileStore`` in a fresh temporary directory, so no port is taken) and
    one device: ``cuda:<rank>`` under NCCL, or the CPU under gloo with
    ``device="cpu"``. P ranks that would share one GPU under NCCL are
    refused: NCCL does not run two ranks on one device; with
    ``backend="gloo"`` CUDA ranks share the cards (``initialize``).
    ``timeout_s`` bounds the rendezvous and every collective;
    ``run_timeout_s`` the
    whole run (default: no bound beyond the collectives'). A rank that
    fails, or a run past its bound, stops every rank and raises
    ``RanksFailedError``. Trace events queued in this process
    (``driver.queue_trace_event``: the elastic supervisor's ``retry``)
    move to the ranks' queues."""
    nprocs = int(nprocs)
    dev = torch.device(device)
    if nprocs < 1:
        raise ValueError(f"need at least one rank, got {nprocs}")
    if dev.type == "cuda" and backend != "gloo":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if nprocs > have:
            raise ValueError(
                f"{nprocs} NCCL ranks need {nprocs} GPUs, this host has "
                f"{have}: NCCL does not run two ranks on one device (use "
                f"--device cpu for gloo ranks, or fewer shards)")
    import torch.multiprocessing as mp

    from dpsvm_tpu_torch.solver import driver
    events = tuple(driver.drain_queued_events())
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dpsvm_ranks_")
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(nprocs)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, store, str(dev), fn, tuple(args),
                               outs[r], timeout_s, events, backend),
                         daemon=False)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = (None if run_timeout_s is None
                else time.monotonic() + float(run_timeout_s))
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                # one rank failed: the others would wait in a collective
                # until their timeout; stop them now
                time.sleep(0.5)
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{nprocs} local ranks still running after "
                    f"{run_timeout_s:g} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    results, errors, causes = [], [], []
    for r, (p, path) in enumerate(zip(procs, outs)):
        if os.path.exists(path):
            with open(path, "rb") as fh:
                status, value = pickle.load(fh)
        else:
            status, value = "error", (f"exit code {p.exitcode}, no result",
                                      None)
        if status == "ok":
            results.append(value)
        else:
            text, exc = value
            errors.append(f"rank {r}: {text}")
            if exc is not None:
                causes.append(exc)
    for path in outs:
        if os.path.exists(path):
            os.unlink(path)
    for name in os.listdir(tmp):
        os.unlink(os.path.join(tmp, name))
    os.rmdir(tmp)
    if errors:
        raise RanksFailedError(f"{len(errors)} of {nprocs} local ranks "
                               "failed:\n" + "\n".join(errors), causes)
    return results
