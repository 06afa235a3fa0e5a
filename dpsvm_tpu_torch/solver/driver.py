"""Host-side training driver (port of ``dpsvm_tpu/solver/driver.py``).

The solver hands this loop a chunk runner that advances the carry by up
to ``chunk_iters`` iterations on the device with no host synchronisation
inside the chunk. The loop polls once per chunk: one packed-stats tensor,
one device-to-host read, with the floats carried as bit patterns so every
field is exact. A runner returns the poll unread (a ``Poll``, which makes
the read when called: ``dispatch`` times the enqueue, ``poll`` the
blocking read, as in the JAX driver) or already read (the decomposition
reads once a round inside its chunk). Health monitoring, rollback,
preemption snapshots and fault injection of the JAX driver are not
ported yet (ROADMAP item 13b).

Checkpoints: with ``checkpoint_every > 0`` a poll that crosses an
every-N boundary reads (alpha, f) once and saves them with the polled
scalars (``utils/checkpoint.py``); no other poll reads more than the
packed stats. ``resume_state`` loads the checkpoint a run resumes from,
falling back past corrupt rotation slots.

Distributed runs (``parallel/``) pass their ``mesh``: every decision the
loop takes is then one every rank takes alike. The polled scalars are
replicated by construction; the poll also carries every rank's own view
of them (the probe tail, ``parallel.mesh.shard_probe``), and rows that
disagree raise ``MeshDesyncError``. The wall budget's verdict is the
largest over the ranks (ranks whose clocks disagree would otherwise stop
at different polls and leave the others waiting in a collective). A
checkpoint's (alpha, f) are gathered on every rank and written by rank 0
alone.

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
from dpsvm_tpu_torch.parallel.mesh import all_max
from dpsvm_tpu_torch.utils.checkpoint import (CheckpointCorruptError,
                                              CheckpointError,
                                              SolverCheckpoint,
                                              checkpoint_candidates,
                                              dist_checkpoint,
                                              load_checkpoint,
                                              maybe_checkpoint)
from dpsvm_tpu_torch.utils.timing import PhaseTimer

_logger = logging.getLogger("dpsvm_tpu_torch")

# Ever, in this process: checkpoint saves, the (alpha, f) reads they made,
# and the seconds the host spent in them (read, write, rename).
CHECKPOINTS = {"saves": 0, "pulls": 0, "seconds": 0.0}

# Ever, in this process: the polls' packed-stats reads (``read_stats``),
# every path's one device-to-host read a poll.
READS = {"stats": 0}


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


class DivergenceError(RuntimeError):
    """The poll saw a non-finite optimality gap: the run cannot converge."""


class MeshDesyncError(RuntimeError):
    """The ranks' own views of the polled scalars disagree."""


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
    """Raise ``MeshDesyncError`` when the ranks' rows of the probe tail
    disagree (they are equal by construction on a healthy mesh)."""
    if st.probe and any(row != st.probe[0] for row in st.probe):
        raise MeshDesyncError(
            "ranks disagree on the polled state (n_iter, b_lo bits, b_hi "
            f"bits) by rank: {list(st.probe)}")


def resume_state(config: SVMConfig, n: int, d: int, gamma: float,
                 shards: int = 1) -> Optional[SolverCheckpoint]:
    """Load and check the checkpoint ``config.resume_from`` names, or None.

    A corrupt file (truncated, bit-flipped: what ``load_checkpoint``
    rejects) falls back to the newest intact rotation slot (``state.1.npz``,
    ...), saying what was skipped; only when every slot is unreadable does
    the error propagate. An intact checkpoint of another problem or
    config always raises ``CheckpointMismatchError``.

    ``shards`` is this run's mesh size. A checkpoint saved on another
    mesh is not a mismatch: the state is the global unpadded (alpha, f),
    which the distributed trainers re-slice for this mesh, and a
    ``RESHARD:`` line on stderr names both meshes."""
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
            print(f"WARNING: resuming from rotation slot {path} "
                  f"(skipped corrupt: {skipped})",
                  file=sys.stderr, flush=True)
        if ckpt.needs_reshard(shards):
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
    ``DPSVM_RETRY_ATTEMPT`` (resilience/supervisor.py)."""
    pending, _PENDING_TRACE_EVENTS[:] = _PENDING_TRACE_EVENTS[:], []
    if not getattr(config, "trace_out", None):
        return None
    trace = RunTrace(config.trace_out, config=config, n=n, d=d,
                     gamma=gamma, solver=solver, it0=it0,
                     env=env if env is not None else trace_env())
    attempt = os.environ.get("DPSVM_RETRY_ATTEMPT", "").strip()
    if attempt.isdigit():
        trace.event("retry", n_iter=it0, attempt=int(attempt))
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
                n_sv: int) -> None:
        """One watch sample a poll, from host-side facts only."""
        now = time.perf_counter()
        gap = b_lo - b_hi
        sample = {"n_iter": float(n_iter), "n_sv": float(n_sv),
                  "gap": gap if math.isfinite(gap) else float("inf")}
        sample["compiles"], sample["compile_seconds"] = (
            self.metrics.compile_totals())
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
                       mesh=None) -> TrainResult:
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
    docstring. The trace, exporters, watch and profiler follow the
    config (module docstring): rank 0 alone traces, exports and watches
    a distributed run."""
    eps = float(config.epsilon)
    shards = 1 if mesh is None else mesh.size
    pipeline = config.checkpoint_every == 0
    n, d = (0, 0) if dims is None else (int(dims[0]), int(dims[1]))
    device = _carry_device(carry)
    solver = SOLVER_NAMES.get(type(carry).__name__, type(carry).__name__)
    lead = mesh is None or mesh.rank == 0
    observed = lead and bool(config.trace_out or config.metrics_out
                             or config.metrics_port is not None
                             or config.watch_rules or config.bundle_dir
                             or config.profile_dir)
    env = trace_env(device) if observed else None
    queued = drain_queued_events()
    trace = (begin_trace(config, n, d, gamma, solver, it0, env) if lead
             else None)
    EVENTS[:] = queued
    for event, extra in queued if trace is not None else ():
        trace.event(event, **extra)
    session = (profilerlib.ProfileSession(config.profile_dir,
                                          solver=solver, device=device)
               if config.profile_dir and lead else None)
    # Host-loop accounting, not device time: "dispatch" buckets the
    # enqueue calls, "poll" the blocking stats reads.
    timer = PhaseTimer(annotate=session.annotation
                       if session is not None else None)
    if session is not None:
        session.attach_timer(timer)
    train_metrics = metricslib.TrainingMetrics(solver=solver, n=n, d=d)
    watch = None
    if lead and (config.bundle_dir or config.watch_rules):
        watch = _Watch(config, train_metrics, solver, n, d, gamma, shards,
                       env)
        trace = watch.tee(trace)
    exporting = lead and (config.metrics_port is not None
                          or bool(config.metrics_out))
    sidecar = None
    if lead and config.metrics_port is not None:
        sidecar = metricslib.MetricsServer(train_metrics.registry,
                                           port=config.metrics_port)
        print(f"metrics: http://127.0.0.1:{sidecar.port}/metricsz"
              "?format=prometheus (read-only, down at run end)",
              file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    n_iter = prev = last_saved = int(it0)
    pending = None

    def snapshot() -> SolverCheckpoint:
        # the carry as the last poll left it: the loop dispatches in
        # sequence while checkpoints are on
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

    try:
        while True:
            limit = min(n_iter + config.chunk_iters, config.max_iter)
            with timer.phase("dispatch"):
                carry, poll = step_chunk(carry, limit)
            with timer.phase("poll"):
                st = settle(poll)
            # Device facts for this poll, all host-side: the queued
            # capture/build records land before the chunk they delayed,
            # and the allocator watermark is a dictionary read.
            drained = drain_compiles(trace, st.n_iter,
                                     metrics=train_metrics)
            if watch is not None:
                watch.note_compiles(drained)
            EVENTS.extend(drain_queued_events(trace))
            hbm = (memory_snapshot(device)
                   if trace is not None or exporting else None)
            if session is not None:
                session.note_poll()
            if pending is not None:     # chosen one poll ago: runs from here
                step_chunk, pending = pending, None
            n_iter, b_lo, b_hi = st.n_iter, st.b_lo, st.b_hi
            # Finite-aware: every NaN comparison is False, so a plain
            # `not (b_lo > ...)` would call a NaN gap converged.
            converged = _finite_converged(b_lo, b_hi, eps)
            done = converged or n_iter >= config.max_iter
            if not done and not (math.isfinite(b_lo)
                                 and math.isfinite(b_hi)):
                if trace is not None:
                    trace.event("divergence", n_iter=n_iter,
                                reason="non-finite optimality gap",
                                action="raise")
                raise DivergenceError(
                    f"non-finite optimality gap at iter {n_iter} "
                    f"(b_lo={b_lo}, b_hi={b_hi}): a NaN/Inf in the data "
                    "or the solver state")
            check_probe(st)
            if not done and config.wall_budget_s:
                over = time.perf_counter() - t0 > config.wall_budget_s
                if mesh is not None:
                    over = all_max(mesh, float(over)) > 0
                done = over
                if over and trace is not None:
                    trace.event("wall_budget", n_iter=n_iter)
            log_progress(config, n_iter, b_lo, b_hi, done, prev)
            prev = n_iter
            if trace is not None:
                trace.chunk(n_iter=n_iter, b_lo=b_lo, b_hi=b_hi,
                            n_sv=st.n_sv, cache_hits=st.cache_hits,
                            cache_misses=st.cache_misses, rounds=st.rounds,
                            phases=dict(timer.seconds),
                            phase_counts=dict(timer.counts), hbm=hbm)
            # Same values, second consumer: the live metric registry.
            train_metrics.on_poll(
                n_iter=n_iter, b_lo=b_lo, b_hi=b_hi, n_sv=st.n_sv,
                cache_hits=st.cache_hits, cache_misses=st.cache_misses,
                phases=timer.seconds, phase_counts=timer.counts, hbm=hbm)
            if exporting and config.metrics_out:
                metricslib.write_snapshot(train_metrics.registry,
                                          config.metrics_out)
            if watch is not None:
                watch.observe(trace, n_iter, b_lo, b_hi, st.n_sv)
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
