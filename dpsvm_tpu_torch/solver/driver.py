"""Host-side training driver (port of ``dpsvm_tpu/solver/driver.py``).

The solver hands this loop a chunk runner that advances the carry by up
to ``chunk_iters`` iterations on the device with no host synchronisation
inside the chunk. The loop polls once per chunk: one packed-stats tensor,
one device-to-host read, with the floats carried as bit patterns so every
field is exact. A runner returns the poll unread (a ``Poll``, which makes
the read when called: ``dispatch`` times the enqueue, ``poll`` the
blocking read, as in the JAX driver) or already read (the decomposition
reads once a round inside its chunk).

Resilience (JAX ``driver.py`` "Resilience"), on every solver path:

* a SIGTERM/SIGINT during the loop (``resilience/preempt.trap``) waits for
  the next poll, where the loop saves a final checkpoint, writes a
  ``preempt`` event and raises ``PreemptedError`` (CLI exit 75, the
  supervisor's resume cue). With ``checkpoint_every == 0`` the JAX loop
  has a speculative chunk in flight at that poll and snapshots after it,
  so this loop runs that one chunk first and snapshots at its end;
* every poll feeds a ``HealthMonitor`` (non-finite gap; with
  ``health_window``, stagnation and SV collapse), checked before the
  checkpoint so a sick state never overwrites a good slot. Policy
  ``config.on_divergence``: raise, rollback (restore the newest intact
  checkpoint through the path's ``carry_from_ckpt``, halve the chunk;
  no hook, no checkpoint path or a spent budget degrade to raise and say
  why) or ignore;
* ``debug_nans``: each poll also reads one flag, whether the carry's alpha
  and f are all finite (one device reduction), and raises
  ``FloatingPointError`` naming the chunk's iterations (the JAX package
  sets ``jax_debug_nans``, which has no PyTorch counterpart);
* the deterministic faults of ``resilience/faultinject.py`` fire at their
  poll or iteration (``NAN_ITER`` poisons the host's view of the stats,
  never the device state), and the stall watchdog is petted at every
  read (``utils/watchdog.py``).

Checkpoints: with ``checkpoint_every > 0`` a poll that crosses an
every-N boundary reads (alpha, f) once and saves them with the polled
scalars (``utils/checkpoint.py``); no other poll reads more than the
packed stats. ``resume_state`` loads the checkpoint a run resumes from,
falling back past corrupt rotation slots.

Distributed runs (``parallel/``) pass their ``mesh``: every decision the
loop takes is then one every rank takes alike, from the replicated stats,
before the next collective. The poll also carries every rank's own view
of the polled scalars (the probe tail, ``parallel.mesh.shard_probe``):
ranks that disagree at one iteration are a desynchronized mesh, which
writes a ``desync`` event and goes through ``on_divergence`` like any
divergence (``DesyncError``); the rows' progress gives each rank a
heartbeat age (``shard_ages`` on chunk records and watch samples); and the
kill-shard drill raises ``ShardLostError`` on every rank at one poll. The
wall budget's verdict, a pending preemption and the ``debug_nans`` flag
are the largest over the ranks (ranks whose clocks or signals differ
would otherwise stop at different polls and leave the others waiting in
a collective). A checkpoint's (alpha, f) are gathered on every rank and
written by rank 0 alone.

Observability (JAX ``driver.py`` "Poll economics"): with ``trace_out``
set every poll appends a chunk record to the run trace (the JAX
package's schema, ``observability/record.py``), built from the poll's one
read and host-side facts only: the ``PhaseTimer`` buckets, the
allocator's watermarks (``observability/device.py``), and the capture
and build records queued by ``observability/compilewatch``. The same
values feed ``TrainingMetrics`` (the ``metrics_out`` file, the
``metrics_port`` sidecar), the watchtower (``watch_rules``; a firing
rule writes ``alert`` and ``incident`` events and, with ``bundle_dir``,
an incident bundle from the flight recorder) and the profiler window
(``profile_dir``). A traced, exported, watched and profiled run reads
from the device exactly what a bare run reads, so its trajectory is
bitwise the bare run's.

Events: subsystems with no handle on the run (the shard reader's
``quarantine``, the streaming fit's ``ingest_resume``) call
``queue_trace_event``; the loop drains the queue when it starts and at
every poll into the run trace. ``EVENTS`` keeps the drained events of
the run in progress, or of the last one, traced or not (the in-process
view the data layer's checks read).

``poll_hook`` follows the JAX contract: called at each poll of a run that
is not done, ``poll_hook(n_iter, carry, stats) -> Optional[new_step]``, a
non-None return replacing the chunk runner. The JAX loop dispatches the
next chunk before it polls (pipelined dispatch), so there a replacement
first runs one chunk after the poll that chose it; while checkpoints are
on it dispatches strictly in sequence, and a replacement runs from the
next chunk. This loop keeps both schedules, so that a run whose hook
swaps runners (the decomposition's working-set growth) walks the JAX
run's trajectory either way.
"""

from __future__ import annotations

import logging
import math
import os
import signal
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig, TrainResult
from dpsvm_tpu_torch.observability import compilewatch
from dpsvm_tpu_torch.observability import metrics as metricslib
from dpsvm_tpu_torch.observability import profiler as profilerlib
from dpsvm_tpu_torch.observability.device import memory_snapshot
from dpsvm_tpu_torch.observability.record import SOLVER_NAMES, RunTrace
from dpsvm_tpu_torch.parallel.mesh import all_max_
from dpsvm_tpu_torch.resilience import elastic, faultinject, hostgroup, preempt
from dpsvm_tpu_torch.resilience.health import (DesyncError, DivergenceError,
                                               HealthMonitor)
from dpsvm_tpu_torch.utils import watchdog
from dpsvm_tpu_torch.utils.checkpoint import (CheckpointCorruptError,
                                              CheckpointError,
                                              SolverCheckpoint,
                                              checkpoint_candidates,
                                              dist_checkpoint,
                                              load_checkpoint,
                                              maybe_checkpoint,
                                              newest_intact_checkpoint,
                                              save_checkpoint)
from dpsvm_tpu_torch.utils.timing import PhaseTimer, span

_logger = logging.getLogger("dpsvm_tpu_torch")

# Ever, in this process: checkpoint saves, the (alpha, f) reads they made,
# and the seconds the host spent in them (read, write, rename).
CHECKPOINTS = {"saves": 0, "pulls": 0, "seconds": 0.0}

# Ever, in this process: the polls' packed-stats reads (``read_stats``),
# every path's one device-to-host read a poll; the ``debug_nans`` flag
# reads of one rank (one a poll of a run that sets it); and a mesh's
# agreement reads (``_agree``: one a poll that is not its run's last).
READS = {"stats": 0, "finite": 0, "agree": 0}


# Lifecycle facts queued by subsystems with no handle on the run, and the
# ones the latest run drained: (event, extra) pairs.
_PENDING_TRACE_EVENTS: list = []
EVENTS: list = []


def queue_trace_event(event: str, **extra) -> None:
    _PENDING_TRACE_EVENTS.append((event, extra))


def drain_queued_events(trace=None) -> list:
    """Take every queued event (the loop's drain at each poll) and write
    each into ``trace`` when one is given. Draining with tracing off
    discards them from the queue, so one run's events never leak into
    the next run's trace."""
    pending, _PENDING_TRACE_EVENTS[:] = _PENDING_TRACE_EVENTS[:], []
    if trace is not None:
        for event, extra in pending:
            trace.event(event, **extra)
    return pending


class ChunkStats(NamedTuple):
    n_iter: int
    b_lo: float
    b_hi: float
    n_sv: int
    rounds: int         # decomposition outer rounds (0 on other paths)
    runs: tuple         # per kernel, launches whose body ran, ever
    probe: tuple = ()   # distributed: every rank's (n_iter, b_lo bits,
                        # b_hi bits), one row a rank
    cache_hits: int = 0     # the general pair's row cache (device
    cache_misses: int = 0   # cumulative), for the trace's chunk record


def device_sv_count(alpha: torch.Tensor) -> torch.Tensor:
    """count(alpha > 0) as an int32 0-d tensor, on alpha's device."""
    return (alpha > 0).sum(dtype=torch.int32)


def pack_stats(n_iter, b_lo, b_hi, n_sv, rounds, *runs) -> torch.Tensor:
    """Poll scalars as one int32 tensor on the device, the layout every
    poll reads: [n_iter, b_lo bits, b_hi bits, n_sv, rounds, runs...].
    Every argument is a 0-d int32 device tensor; the b's are bit patterns
    (the carry states store them so)."""
    return torch.stack([n_iter, b_lo, b_hi, n_sv, rounds, *runs])


def read_stats(stats: torch.Tensor, shards: int = 0) -> ChunkStats:
    """The poll's one device-to-host read, unpacked. ``shards`` > 0: the
    last 3 x shards words are the distributed runs' probe tail."""
    s = stats.cpu().numpy()
    READS["stats"] += 1
    watchdog.pet()
    b = s[1:3].view(np.float32)
    tail = len(s) - 3 * int(shards)
    probe = tuple(tuple(int(v) for v in row)
                  for row in s[tail:].reshape(-1, 3)) if shards else ()
    return ChunkStats(int(s[0]), float(b[0]), float(b[1]), int(s[3]),
                      int(s[4]), tuple(int(v) for v in s[5:tail]), probe)


class Poll:
    """A chunk's one stats read, not made yet: ``read`` makes it (and the
    runner's bookkeeping on it) at the first call, or at the first access
    to a ``ChunkStats`` field, and never again."""

    __slots__ = ("_read", "_st")

    def __init__(self, read: Callable[[], ChunkStats]):
        self._read, self._st = read, None

    def __call__(self) -> ChunkStats:
        if self._st is None:
            self._st = self._read()
        return self._st

    def __getattr__(self, name):
        return getattr(self(), name)


def settle(poll: Union[ChunkStats, Poll]) -> ChunkStats:
    """A runner's poll as stats: read now when the runner returned it
    unread, else as the runner read it."""
    return poll() if isinstance(poll, Poll) else poll


def check_probe(st: ChunkStats) -> None:
    """Raise ``DesyncError`` when ranks at the same iteration disagree on
    the polled gap bits (``elastic.desync_reason``): the check of a loop
    with no ``on_divergence`` policy (the shrinking manager's)."""
    reason = elastic.desync_reason(st.probe) if st.probe else None
    if reason is not None:
        raise DesyncError(reason, st.n_iter)


def copy_carry_(dst, src):
    """Copy every tensor of ``src`` into the same field of ``dst`` in place
    (nested named tuples too) and return ``dst``: a rollback keeps the
    buffers a captured CUDA graph reads and writes."""
    for a, b in zip(dst, src):
        if isinstance(a, torch.Tensor):
            a.copy_(b)
        elif isinstance(a, tuple) and a is not None:
            copy_carry_(a, b)
    return dst


def _nonfinite(carry) -> torch.Tensor:
    """A 0-d device flag: some entry of the carry's alpha or f (every
    float tensor of a carry without them) is not finite. No read."""
    vecs = [getattr(carry, k) for k in ("alpha", "f")
            if isinstance(getattr(carry, k, None), torch.Tensor)]
    if not vecs:
        vecs = [v for v in carry if isinstance(v, torch.Tensor)
                and v.is_floating_point()]
    return ~torch.stack([torch.isfinite(v).all() for v in vecs]).all()


def _agree(carry, mesh, debug_nans: bool, over: bool,
           signum: Optional[int]) -> Tuple[bool, bool, Optional[int]]:
    """What every rank of a poll must decide alike: (finite, over,
    signum), the carry's finite flag (``debug_nans`` only, else True), the
    wall budget's verdict and a pending preemption signal. One rank reads
    only the flag (one device reduction, one read: ``READS["finite"]``);
    the ranks of a mesh take the largest of the three over the ranks in
    one all-reduce and one read (``READS["agree"]``), so that a poll pays
    one collective, and none where there is nothing to decide."""
    flag = _nonfinite(carry) if debug_nans else None
    if mesh is None:
        if flag is None:
            return True, over, signum
        READS["finite"] += 1
        return not bool(flag.item()), over, signum
    t = torch.tensor([0.0, float(over), float(signum or 0)],
                     dtype=torch.float64, device=mesh.device)
    if flag is not None:
        t[0] = flag
    bad, over_all, sig = all_max_(mesh, t).tolist()
    READS["agree"] += 1
    return bad == 0, over_all > 0, int(sig) or None


def resume_state(config: SVMConfig, n: int, d: int, gamma: float,
                 shards: int = 1) -> Optional[SolverCheckpoint]:
    """Load and check the checkpoint ``config.resume_from`` names, or None.

    A corrupt file (truncated, bit-flipped: what ``load_checkpoint``
    rejects) falls back to the newest intact rotation slot (``state.1.npz``,
    ...), saying what was skipped and queueing a ``rollback`` event for
    the run's trace; only when every slot is unreadable does the error
    propagate. An intact checkpoint of another problem or
    config always raises ``CheckpointMismatchError``.

    ``shards`` is this run's mesh size. A checkpoint saved on another
    mesh is not a mismatch: the state is the global unpadded (alpha, f),
    which the distributed trainers re-slice for this mesh; a ``RESHARD:``
    line on stderr and a queued ``reshard`` event name both meshes."""
    if not config.resume_from:
        return None
    skipped = []
    last_err: Optional[CheckpointError] = None
    for path in checkpoint_candidates(config.resume_from):
        try:
            ckpt = load_checkpoint(path)
        except CheckpointCorruptError as e:
            print(f"WARNING: {e}; trying older rotation slot",
                  file=sys.stderr, flush=True)
            skipped.append(path)
            last_err = e
            continue
        ckpt.validate_against(n, d, config, gamma, shards=shards)
        if skipped:
            queue_trace_event("rollback", n_iter=ckpt.n_iter,
                              reason="corrupt checkpoint on resume",
                              checkpoint=path, skipped=skipped)
            print(f"WARNING: resuming from rotation slot {path} "
                  f"(skipped corrupt: {skipped})",
                  file=sys.stderr, flush=True)
        if ckpt.needs_reshard(shards):
            queue_trace_event("reshard", n_iter=ckpt.n_iter,
                              from_shards=int(ckpt.shards),
                              to_shards=int(shards), checkpoint=path)
            print(f"RESHARD: checkpoint {path} was saved on a "
                  f"{ckpt.mesh_desc()}; resuming on {shards} — "
                  f"re-slicing the global state onto the new mesh",
                  file=sys.stderr, flush=True)
        return ckpt
    raise CheckpointError(
        f"no intact checkpoint to resume: {config.resume_from} and "
        f"every rotation slot failed ({skipped})") from last_err


def gap_open(b_lo, b_hi, two_eps: float):
    """The do-while condition's gap test on the host, in the device's
    arithmetic: b_lo > b_hi + 2 eps with the sum rounded to float32, as
    ``smo.live``, both kernels and the batched program compute it. Tested
    in float64, a gap can stay open on the host after the device has
    closed it (b_hi + 2 eps rounding up to b_lo; one-class at 60000 rows
    has |f| ~ 834, where a float32 ulp is 6e-5), and the loop would then
    poll a device that never steps again. Every host loop tests its gap
    here. Scalars give a bool, arrays (one b per problem) a bool array;
    NaN is closed, as on the device."""
    out = (np.asarray(b_lo, np.float32)
           > np.asarray(b_hi, np.float32) + np.float32(two_eps))
    return bool(out) if out.ndim == 0 else out


def _finite_converged(b_lo: float, b_hi: float, eps: float) -> bool:
    """The driver's convergence verdict: gap closed AND finite."""
    return (math.isfinite(b_lo) and math.isfinite(b_hi)
            and not gap_open(b_lo, b_hi, 2.0 * eps))


def log_progress(config: SVMConfig, n_iter: int, b_lo: float, b_hi: float,
                 final: bool, prev_iter: int) -> None:
    if not config.verbose and not config.log_every:
        return
    every = config.log_every or config.chunk_iters
    if not final and n_iter // every == prev_iter // every:
        return
    gap = b_lo - b_hi
    if _logger.isEnabledFor(logging.INFO) and _logger.hasHandlers():
        _logger.info("iter=%d gap=%.6g (b_lo=%.6g b_hi=%.6g, converged at "
                     "%.3g)", n_iter, gap, b_lo, b_hi, 2 * config.epsilon)
    elif config.verbose:
        print(f"[dpsvm_tpu_torch] iter={n_iter} gap={gap:.6g} "
              f"target={2 * config.epsilon:.3g}", flush=True)


def _carry_device(carry) -> torch.device:
    """The device of the carry's first tensor (the run's device)."""
    fields = (carry if isinstance(carry, tuple)
              else getattr(carry, "__dict__", {}).values())
    for v in fields:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


_POWER: dict = {}


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` gives it ("700.00 W"),
    or None where it does not answer; asked once a process."""
    if "limit" not in _POWER:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=10)
            first = out.stdout.strip().splitlines()
            _POWER["limit"] = (first[0].strip()
                               if out.returncode == 0 and first else None)
        except (OSError, subprocess.SubprocessError):
            _POWER["limit"] = None
    return _POWER["limit"]


def trace_env(device=None) -> dict:
    """Device facts for the trace manifest: ``backend`` "cuda" or "cpu",
    the card's name as ``device_kind`` and the visible card count (on the
    CPU: "cpu" and 1). On the card ``power_limit`` rides along, so every
    number rendered from the trace can name it."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return {"backend": "cpu", "device_kind": "cpu", "device_count": 1}
    return {"backend": "cuda",
            "device_kind": torch.cuda.get_device_name(dev),
            "device_count": torch.cuda.device_count(),
            "power_limit": power_limit()}


def begin_trace(config: SVMConfig, n: int, d: int, gamma: float,
                solver: str, it0: int = 0, env: Optional[dict] = None):
    """RunTrace for this run, or None when tracing is off. Shared with
    the shrinking manager and the cascade so every producer writes the
    one schema. Drains the pending-event queue right after
    the manifest; a supervised retry announces itself through
    ``DPSVM_RETRY_ATTEMPT`` (resilience/supervisor.py), and an attempt after
    a host loss through ``DPSVM_HOST_LOST``, ``DPSVM_REFORM_FROM`` and
    ``DPSVM_REFORM_TO`` (resilience/hostgroup.py): the dead host first,
    then the group change."""
    pending, _PENDING_TRACE_EVENTS[:] = _PENDING_TRACE_EVENTS[:], []
    if not getattr(config, "trace_out", None):
        return None
    trace = RunTrace(config.trace_out, config=config, n=n, d=d,
                     gamma=gamma, solver=solver, it0=it0,
                     env=env if env is not None else trace_env())
    attempt = os.environ.get("DPSVM_RETRY_ATTEMPT", "").strip()
    if attempt.isdigit():
        trace.event("retry", n_iter=it0, attempt=int(attempt))
    lost = os.environ.get("DPSVM_HOST_LOST", "").strip()
    if lost.isdigit():
        trace.event("host_lost", n_iter=it0, host_id=int(lost))
    rf = os.environ.get("DPSVM_REFORM_FROM", "").strip()
    rt = os.environ.get("DPSVM_REFORM_TO", "").strip()
    if rf.isdigit() and rt.isdigit():
        trace.event("reform", n_iter=it0, from_hosts=int(rf),
                    to_hosts=int(rt))
    for event, extra in pending:
        trace.event(event, **extra)
    return trace


def drain_compiles(trace, n_iter: int = 0, metrics=None) -> list:
    """Flush pending capture and build observations
    (observability/compilewatch) into ``trace`` as ``compile`` records
    and, when given, the metric feeder (``metrics.TrainingMetrics``).
    Draining with both off discards them, so one run's observations
    never leak into the next run's trace. Returns the drained
    observations (the watch reads the newest program's work count)."""
    drained = compilewatch.drain()
    for rec in drained:
        if trace is not None:
            trace.compile(program=rec["program"], seconds=rec["seconds"],
                          signature=rec.get("signature"),
                          flops=rec.get("flops"), bytes=rec.get("bytes"),
                          n_iter=n_iter)
        if metrics is not None:
            metrics.on_compile(rec)
    return drained


class _Watch:
    """The continuous watch and the flight recorder of one run
    (``watch_rules`` / ``bundle_dir``): the training rules evaluated on
    facts the poll already holds, the recorder teeing off the trace
    feed, an incident bundle when a rule fires."""

    def __init__(self, config: SVMConfig, train_metrics, solver: str,
                 n: int, d: int, gamma: float, shards: int, env: dict):
        from dpsvm_tpu_torch.observability import blackbox, roofline, slo
        self.config = config
        self.metrics = train_metrics
        self.watcher = slo.Watchtower(
            slo.load_rules(config.watch_rules, default="training"))
        self.incidents = metricslib.incidents_counter(
            train_metrics.registry)
        self.peaks = roofline.peaks_for(env.get("device_kind"))
        self.flight = blackbox.FlightRecorder(blackbox.make_manifest(
            solver=solver, n=n, d=d, gamma=gamma,
            config={"kernel": config.kernel, "coef0": float(config.coef0),
                    "degree": int(config.degree), "shards": int(shards)},
            env=env))
        self.prev = None        # (n_iter, t) for the it/s fact
        self.flops = None       # newest chunk program's FLOPs an iteration
        if config.bundle_dir:
            blackbox.arm_emergency(self.flight, config.bundle_dir,
                                   train_metrics.registry)

    def tee(self, trace):
        from dpsvm_tpu_torch.observability import blackbox
        return blackbox.TeeTrace(trace, self.flight)

    def note_compiles(self, drained) -> None:
        for rec in drained:
            if rec.get("flops") is not None:
                self.flops = float(rec["flops"])

    def incident(self, trace, rule: str, severity: str, window: str,
                 reason: str, n_iter: int) -> None:
        """One firing: the incident counter, a metrics snapshot, a bundle
        and an ``incident`` event (into the tee, so the flight ring
        carries the alert history the bundle dumps)."""
        from dpsvm_tpu_torch.observability import blackbox
        self.incidents.inc()
        self.flight.snapshot_metrics(self.metrics.registry)
        if not self.config.bundle_dir:
            return
        path = blackbox.dump_bundle(
            self.config.bundle_dir, recorder=self.flight, rule=rule,
            severity=severity, window=window, reason=reason,
            registry=self.metrics.registry,
            extra={"source": "training", "n_iter": int(n_iter)})
        if path and trace is not None:
            trace.event("incident", n_iter=n_iter, rule=rule,
                        window=window, severity=severity, bundle=path)

    def observe(self, trace, n_iter: int, b_lo: float, b_hi: float,
                n_sv: int, shard_ages=None) -> None:
        """One watch sample a poll, from host-side facts only."""
        now = time.perf_counter()
        gap = b_lo - b_hi
        sample = {"n_iter": float(n_iter), "n_sv": float(n_sv),
                  "gap": gap if math.isfinite(gap) else float("inf")}
        sample["compiles"], sample["compile_seconds"] = (
            self.metrics.compile_totals())
        if shard_ages:
            sample["heartbeat_age"] = float(max(shard_ages))
        if (self.peaks is not None and self.flops is not None
                and self.prev is not None and now > self.prev[1]
                and n_iter > self.prev[0]):
            ips = (n_iter - self.prev[0]) / (now - self.prev[1])
            sample["roofline_fraction"] = (self.flops * ips
                                           / self.peaks["peak_flops"])
        self.prev = (int(n_iter), now)
        for tr in self.watcher.observe(sample, t=now):
            if trace is not None:
                trace.event("alert", n_iter=n_iter, rule=tr["rule"],
                            window=tr["window"], severity=tr["severity"],
                            state=tr["state"], reason=tr["reason"])
            if tr["state"] == "firing":
                self.incident(trace, tr["rule"], tr["severity"],
                              tr["window"], tr["reason"], n_iter)

    def close(self) -> None:
        from dpsvm_tpu_torch.observability import blackbox
        blackbox.disarm_emergency(self.flight)


def host_training_loop(config: SVMConfig, gamma: float, carry,
                       step_chunk: Callable, carry_to_host: Callable,
                       poll_hook: Optional[Callable] = None,
                       it0: int = 0,
                       dims: Optional[Tuple[int, int]] = None,
                       mesh=None,
                       carry_from_ckpt: Optional[Callable] = None
                       ) -> TrainResult:
    """Run chunks until convergence, ``max_iter`` or the wall budget.

    ``step_chunk(carry, limit) -> (carry, poll)`` enqueues the carry's
    advance to at most ``limit`` iterations (plus the trailing do-while
    body on convergence); ``poll`` is the poll's single read, unread (a
    ``Poll``) or read (``ChunkStats``; see ``settle``).
    ``carry_to_host(carry)`` returns (alpha, f) as numpy arrays.
    ``poll_hook``: see the module docstring. ``it0`` is the carry's
    n_iter at the start (a run continued mid-way). ``dims`` is the
    problem's (n, d), which a checkpoint and the trace record. ``mesh``
    (a ``parallel.mesh.DataMesh``): a distributed run; see the module
    docstring. ``carry_from_ckpt(ckpt) -> carry`` restores the carry from
    a checkpoint for the rollback policy (None: rollback degrades to
    raise). The trace, exporters, watch and profiler follow the config
    (module docstring): rank 0 alone traces, exports and watches a
    distributed run, except in a supervised host group, where every host
    does, each to its own paths."""
    eps = float(config.epsilon)
    shards = 1 if mesh is None else mesh.size
    pipeline = config.checkpoint_every == 0
    chunk = int(config.chunk_iters)
    n, d = (0, 0) if dims is None else (int(dims[0]), int(dims[1]))
    device = _carry_device(carry)
    solver = SOLVER_NAMES.get(type(carry).__name__, type(carry).__name__)
    lead = mesh is None or mesh.rank == 0
    # In a supervised host group every host has its own trace and metrics
    # paths (the fleet views merge and federate them); elsewhere the ranks
    # of one command share them, so rank 0 alone writes.
    obs = lead or hostgroup.in_group()
    observed = obs and bool(config.trace_out or config.metrics_out
                             or config.metrics_port is not None
                             or config.watch_rules or config.bundle_dir
                             or config.profile_dir)
    env = trace_env(device) if observed else None
    queued = drain_queued_events()
    trace = (begin_trace(config, n, d, gamma, solver, it0, env) if obs
             else None)
    EVENTS[:] = queued
    for event, extra in queued if trace is not None else ():
        trace.event(event, **extra)
    monitor = HealthMonitor(policy=config.on_divergence,
                            window=config.health_window)
    # The elastic instruments of a distributed run: desync detection and
    # heartbeats over the probe tail.
    desync = elastic.DesyncDetector()
    heartbeats = elastic.ShardHeartbeats(shards) if shards > 1 else None
    faults = faultinject.current()
    session = (profilerlib.ProfileSession(config.profile_dir,
                                          solver=solver, device=device)
               if config.profile_dir and obs else None)
    # Host-loop accounting, not device time: "dispatch" buckets the
    # enqueue calls, "poll" the blocking stats reads.
    timer = PhaseTimer()
    if session is not None:
        session.attach_timer(timer)
    train_metrics = metricslib.TrainingMetrics(solver=solver, n=n, d=d)
    watch = None
    if obs and (config.bundle_dir or config.watch_rules):
        watch = _Watch(config, train_metrics, solver, n, d, gamma, shards,
                       env)
        trace = watch.tee(trace)
    exporting = obs and (config.metrics_port is not None
                          or bool(config.metrics_out))
    sidecar = None
    if obs and config.metrics_port is not None:
        sidecar = metricslib.MetricsServer(train_metrics.registry,
                                           port=config.metrics_port)
        print(f"metrics: http://127.0.0.1:{sidecar.port}/metricsz"
              "?format=prometheus (read-only, down at run end)",
              file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    n_iter = prev = last_saved = int(it0)
    pending = None
    # set-up is done: a fresh watchdog window for the first chunk
    watchdog.pet()

    def snapshot() -> SolverCheckpoint:
        # the carry as the last poll left it: the loop dispatches in
        # sequence
        alpha, f = carry_to_host(carry)
        CHECKPOINTS["pulls"] += 1
        return SolverCheckpoint(
            alpha=np.asarray(alpha, np.float32),
            f=np.asarray(f, np.float32), n_iter=n_iter, b_lo=b_lo,
            b_hi=b_hi, c=float(config.c), gamma=gamma,
            epsilon=float(config.epsilon), n=int(dims[0]), d=int(dims[1]),
            weight_pos=float(config.weight_pos),
            weight_neg=float(config.weight_neg), kernel=config.kernel,
            coef0=float(config.coef0), degree=int(config.degree),
            shards=shards, host_count=shards, host_id=0)

    def incident(kind: str, reason: str) -> None:
        # a tripped guard is an incident: the black box dumps before the
        # policy acts, so a raise still leaves its bundle
        if watch is not None:
            watch.incident(trace, f"health-{kind}", "page",
                           f"health_window={config.health_window}",
                           reason, n_iter)

    elastic.register_heartbeats(heartbeats)
    try:
        # train.loop: the chunks and polls; its self time is the loop's
        # bookkeeping between the phases
        with preempt.trap(), span("train.loop"):
            while True:
                limit = min(n_iter + chunk, config.max_iter)
                with timer.phase("dispatch"):
                    carry, poll = step_chunk(carry, limit)
                with timer.phase("poll"):
                    st = settle(poll)
                if faults is not None:
                    st = faults.poison_stats(st)
                if faults is not None and faults.note_poll():
                    preempt.simulate(signal.SIGTERM)
                # Finite-aware: every NaN comparison is False, so a plain
                # `not (b_lo > ...)` would call a NaN gap converged.
                converged = _finite_converged(st.b_lo, st.b_hi, eps)
                done = converged or st.n_iter >= config.max_iter
                over = bool(not done and config.wall_budget_s
                            and time.perf_counter() - t0
                            > config.wall_budget_s)
                signum = None if done else preempt.pending()
                if config.debug_nans or (mesh is not None and not done):
                    with timer.phase("agree"):
                        finite, over, signum = _agree(
                            carry, mesh, config.debug_nans, over, signum)
                    if not finite:
                        raise FloatingPointError(
                            f"debug_nans: non-finite alpha or f after the "
                            f"chunk over iterations [{n_iter}, {st.n_iter}]")
                n_iter, b_lo, b_hi = st.n_iter, st.b_lo, st.b_hi
                if faults is not None and shards > 1:
                    # the kill-shard drill: raised on every rank at this
                    # poll, with no snapshot, like a real loss
                    lost = faults.dist_kill_now()
                    if lost:
                        if trace is not None:
                            trace.event("shard_lost", n_iter=n_iter,
                                        shard=lost - 1, shards=shards)
                        raise elastic.ShardLostError(lost - 1, shards,
                                                     n_iter)
                if faults is not None and faults.host_kill_now():
                    # the host-loss drill: a real death, no cleanup
                    os.kill(os.getpid(), signal.SIGKILL)
                hostgroup.note_poll_heartbeat(n_iter)
                shard_ages = (heartbeats.note_poll(st.probe)
                              if heartbeats is not None else None)
                # Device facts for this poll, all host-side: the queued
                # capture/build records land before the chunk they
                # delayed, and the allocator watermark is a dictionary
                # read.
                drained = drain_compiles(trace, st.n_iter,
                                         metrics=train_metrics)
                if watch is not None:
                    watch.note_compiles(drained)
                EVENTS.extend(drain_queued_events(trace))
                hbm = (memory_snapshot(device)
                       if trace is not None or exporting else None)
                if session is not None:
                    session.note_poll()
                if pending is not None:   # chosen one poll ago: runs now
                    step_chunk, pending = pending, None
                if over:
                    done = True
                    if trace is not None:
                        trace.event("wall_budget", n_iter=n_iter)
                if not done and signum is not None:
                    # The preemption snapshot (a finished run ignores the
                    # signal: its results are about to be written).
                    if pipeline:
                        # the JAX loop's in-flight chunk: run it and
                        # snapshot the state after it
                        limit = min(n_iter + chunk, config.max_iter)
                        with timer.phase("dispatch"):
                            carry, poll = step_chunk(carry, limit)
                        with timer.phase("poll"):
                            st = settle(poll)
                        n_iter, b_lo, b_hi = st.n_iter, st.b_lo, st.b_hi
                    saved_to = None
                    if config.checkpoint_path:
                        try:
                            with timer.phase("checkpoint"):
                                ck = snapshot()
                                if lead:
                                    save_checkpoint(
                                        config.checkpoint_path, ck,
                                        keep=config.checkpoint_keep)
                            saved_to = config.checkpoint_path
                        except (OSError, CheckpointError) as e:
                            print(f"WARNING: preemption snapshot failed "
                                  f"({e}); previous checkpoint kept",
                                  file=sys.stderr, flush=True)
                    log_progress(config, n_iter, b_lo, b_hi, True, prev)
                    if trace is not None:
                        trace.event("preempt", n_iter=n_iter,
                                    signal=int(signum),
                                    checkpoint=saved_to)
                    raise preempt.PreemptedError(signum, n_iter, saved_to)
                log_progress(config, n_iter, b_lo, b_hi, done, prev)
                prev = n_iter
                if trace is not None:
                    trace.chunk(n_iter=n_iter, b_lo=b_lo, b_hi=b_hi,
                                n_sv=st.n_sv, cache_hits=st.cache_hits,
                                cache_misses=st.cache_misses,
                                rounds=st.rounds,
                                phases=dict(timer.seconds),
                                phase_counts=dict(timer.counts), hbm=hbm,
                                **({"shard_ages": shard_ages}
                                   if shard_ages is not None else {}))
                # Same values, second consumer: the live metric registry.
                train_metrics.on_poll(
                    n_iter=n_iter, b_lo=b_lo, b_hi=b_hi, n_sv=st.n_sv,
                    cache_hits=st.cache_hits, cache_misses=st.cache_misses,
                    phases=timer.seconds, phase_counts=timer.counts,
                    hbm=hbm, shard_ages=shard_ages)
                if exporting and config.metrics_out:
                    metricslib.write_snapshot(train_metrics.registry,
                                              config.metrics_out)
                if watch is not None:
                    watch.observe(trace, n_iter, b_lo, b_hi, st.n_sv,
                                  shard_ages)
                # Divergence guards, before the checkpoint: a sick state
                # never overwrites a good slot. A desynchronized mesh is
                # a divergent run and takes the same policy.
                reason = None if done else monitor.check(
                    n_iter=n_iter, b_lo=b_lo, b_hi=b_hi, n_sv=st.n_sv)
                kind = "divergence"
                if reason is None and not done:
                    reason = desync.check(st.probe)
                    if reason is not None:
                        kind = "desync"
                if reason is not None:
                    incident(kind, reason)
                    policy = monitor.policy
                    if policy == "rollback" and (
                            carry_from_ckpt is None
                            or not config.checkpoint_path
                            or monitor.exhausted):
                        why = ("rollback budget exhausted"
                               if monitor.exhausted else
                               "this solver path has no rollback hook"
                               if carry_from_ckpt is None else
                               "no checkpoint_path configured")
                        print(f"WARNING: divergence policy 'rollback' "
                              f"unavailable ({why}); raising",
                              file=sys.stderr, flush=True)
                        policy = "raise"
                    extra = {"shards": shards} if kind == "desync" else {}
                    if policy == "ignore":
                        print(f"WARNING: {reason} at iter {n_iter} "
                              "(on_divergence='ignore')",
                              file=sys.stderr, flush=True)
                        if trace is not None:
                            trace.event(kind, n_iter=n_iter, reason=reason,
                                        action="ignore", **extra)
                    elif policy == "raise":
                        if trace is not None:
                            trace.event(kind, n_iter=n_iter, reason=reason,
                                        action="raise", **extra)
                        err = (DesyncError if kind == "desync"
                               else DivergenceError)
                        raise err(reason, n_iter)
                    else:
                        best, skipped = newest_intact_checkpoint(
                            config.checkpoint_path)
                        if best is None:
                            raise DivergenceError(
                                f"{reason}; rollback found no intact "
                                f"checkpoint (skipped {skipped})", n_iter)
                        if trace is not None and kind == "desync":
                            trace.event(kind, n_iter=n_iter, reason=reason,
                                        action="rollback", **extra)
                        ck = load_checkpoint(best)
                        ck.validate_against(n, d, config, gamma,
                                            shards=shards)
                        carry = carry_from_ckpt(ck)
                        chunk = max(chunk // 2, 1)
                        monitor.note_rollback(ck.n_iter)
                        desync.reset()      # the restored state re-earns
                        print(f"WARNING: {reason} at iter {n_iter}; "
                              f"rolled back to {best} (iter "
                              f"{ck.n_iter}), chunk_iters now {chunk}",
                              file=sys.stderr, flush=True)
                        if trace is not None:
                            trace.event("rollback", n_iter=ck.n_iter,
                                        reason=reason, checkpoint=best,
                                        skipped=skipped, chunk_iters=chunk)
                        n_iter = prev = last_saved = int(ck.n_iter)
                        # the next dispatch runs the restored carry; a
                        # pipelined loop's sick in-flight chunk is never
                        # run here
                        continue
                if poll_hook is not None and not done:
                    with timer.phase("hook"):
                        replacement = poll_hook(n_iter, carry, st)
                    if replacement is not None:
                        if pipeline:
                            pending = replacement
                        else:
                            step_chunk = replacement
                        if trace is not None:
                            trace.event("program_swap", n_iter=n_iter)
                t_save = time.perf_counter()
                with timer.phase("checkpoint"):
                    if mesh is None:
                        saved = maybe_checkpoint(config, last_saved, n_iter,
                                                 snapshot)
                    else:
                        saved = dist_checkpoint(config, last_saved, n_iter,
                                                snapshot, mesh.rank == 0)
                if saved != last_saved:
                    CHECKPOINTS["saves"] += 1
                    CHECKPOINTS["seconds"] += time.perf_counter() - t_save
                    if trace is not None:
                        trace.event("checkpoint", n_iter=n_iter)
                last_saved = saved
                if done:
                    break
        with span("train.download"):
            alpha, _ = carry_to_host(carry)
            alpha = np.array(alpha, np.float32, copy=True)
        result = TrainResult(
            alpha=alpha,
            b=(b_lo + b_hi) / 2.0,            # svmTrainMain.cpp:329
            n_iter=n_iter,
            converged=converged,
            b_lo=b_lo,
            b_hi=b_hi,
            train_seconds=time.perf_counter() - t0,
            gamma=gamma,
            n_sv=int(np.sum(alpha > 0)),
            kernel=config.kernel,
            coef0=float(config.coef0),
            degree=int(config.degree),
            rounds=st.rounds,
        )
        train_metrics.on_done(converged=result.converged,
                              n_iter=result.n_iter)
        if trace is not None:
            drain_compiles(trace, result.n_iter, metrics=train_metrics)
            EVENTS.extend(drain_queued_events(trace))
            trace.summary(converged=result.converged, n_iter=result.n_iter,
                          b=result.b, b_lo=result.b_lo, b_hi=result.b_hi,
                          n_sv=result.n_sv,
                          train_seconds=result.train_seconds,
                          cache_hits=st.cache_hits,
                          cache_misses=st.cache_misses, rounds=st.rounds,
                          phases=dict(timer.seconds),
                          phase_counts=dict(timer.counts))
        return result
    finally:
        # Leftover observations (error exits, untraced runs) must not
        # leak into the next run's trace.
        if watch is not None:
            watch.close()
        elastic.register_heartbeats(None)
        live = trace if trace is not None and not trace.closed else None
        drain_compiles(live, metrics=train_metrics)
        EVENTS.extend(drain_queued_events(live))
        if trace is not None:
            trace.close()
        # Exporter teardown: the final snapshot, the sidecar down, the
        # profiler window closed and its summary written; none of these
        # may raise over a dying run.
        if exporting and config.metrics_out:
            metricslib.write_snapshot(train_metrics.registry,
                                      config.metrics_out)
        if sidecar is not None:
            sidecar.close()
        if session is not None:
            session.close()
