"""The RunTrace recorder: one run's JSONL artifact (port of
``dpsvm_tpu/observability/record.py``). The training driver, the
shrinking manager, the cascade and the grid write their run traces with
it, and the serving stack its serving traces (``open_serving_trace``).

The reference left its per-phase instrumentation commented out
(``svmTrain.cu:218-293``) and its duality-gap probe dead
(``seq.cpp:352-376``); we resurrected both (utils/timing.py,
ops/diagnostics.py) but they were islands — no single artifact recorded
what a training run *did*. ``RunTrace`` is that artifact: one JSONL
file per run (schema in observability/schema.py, prose in
docs/OBSERVABILITY.md) holding the manifest, a record per host poll,
compile accounting, solver events, and a summary. Every signal in the
per-chunk record rides the solvers' existing packed-stats transfer
(solver/driver.py "Poll economics") or a host-side API read
(``device.memory_stats()``), so a traced run performs ZERO additional
device->host transfers.

Producers: the shared host driver (solver/driver.host_training_loop —
every path through it: single-device, fused, decomposition, and both
SPMD variants), the shrinking manager (solver/shrink.py), and the
benchmark harnesses (bench.py, bench_convergence.py via
``BENCH_TRACE_OUT``). Consumers: the ``dpsvm report`` and ``dpsvm
compare`` CLI subcommands (observability/report.py, compare.py).

This module never touches a device: callers pass device facts in via
``env`` / ``hbm`` / the compile log.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Dict, List, Optional

from dpsvm_tpu_torch.observability.schema import (TRACE_SCHEMA_VERSION,
                                            TraceWriter)

# Every in-flight RunTrace, so emergency exit paths (the stall watchdog's
# os._exit) can stamp a terminal event record before the process dies —
# an abandoned trace with no terminal record is indistinguishable from a
# live run (docs/ROBUSTNESS.md). Weak: a dropped recorder unregisters
# itself.
_OPEN_TRACES: "weakref.WeakSet[RunTrace]" = weakref.WeakSet()


def flush_open_traces(event: str, **extra) -> int:
    """Best-effort: append ``event`` to every still-open trace and close
    it. Called from exit paths that bypass the driver's finally block
    (utils/watchdog.py expiry — a different thread, microseconds before
    os._exit, while the training thread is wedged in a device call, so
    a concurrent write is not a practical concern). Returns the number
    of traces flushed; never raises."""
    count = 0
    for tr in list(_OPEN_TRACES):
        try:
            tr.event(event, **extra)
            tr.close()
            count += 1
        except Exception:
            pass
    # Armed flight recorders land an incident bundle on the same
    # emergency path (observability/blackbox.py): a watchdog stall
    # leaves a postmortem artifact, not just a terminal trace event.
    try:
        from dpsvm_tpu_torch.observability import blackbox
        blackbox.dump_emergency(event)
    except Exception:
        pass
    return count

# Carry-class -> human solver-path name (the driver keys the manifest on
# the carry type; one table so a new solver fails loudly in tests, not
# silently as its class name).
SOLVER_NAMES = {
    "SMOCarry": "smo",
    "DistCarry": "dist-smo",
    "DecompCarry": "decomp",
    "DistDecompCarry": "dist-decomp",
    "FusedCarry": "fused-pallas",
    "PrimalCarry": "approx-primal",
}

# Event types the resilient serving layer emits into a serving trace
# (docs/SERVING.md "Resilience", docs/ROBUSTNESS.md "Self-healing
# serving"): replica circuit-breaker transitions (`eject`/`rebuild`),
# overload shedding tier activations (`shed`), duplicate dispatches
# (`hedge`), and the model-lifecycle loop (`drift` detected ->
# `retrain` finished -> `promote` with ok=True on hot-swap / ok=False
# when the eval gate kept the old generation). The schema treats event
# names as free strings; this table is the documented vocabulary so
# consumers (report rendering, tests) have one source of truth.
SERVING_EVENTS = ("eject", "rebuild", "shed", "hedge", "drift",
                  "retrain", "promote")

# Event types the ELASTIC distributed layer emits into a training
# trace (resilience/elastic.py, docs/DISTRIBUTED.md "Elastic
# training"): `desync` = shards disagree on replicated-by-construction
# poll state (carries `shards`; feeds the on_divergence policy),
# `shard_lost` = a mesh shard died mid-run (the kill-shard drill /
# a real host loss), `reshard` = a resume re-sliced the global
# checkpoint state onto a different mesh (carries `from_shards` /
# `to_shards`; rewinds the n_iter baseline like `rollback` —
# observability/schema.REWIND_EVENTS).
DIST_EVENTS = ("desync", "shard_lost", "reshard")

# Event types the MULTI-HOST layer emits (resilience/hostgroup.py,
# docs/DISTRIBUTED.md "Multi-host"): `host_lost` = a real host process
# died or went heartbeat-silent past the deadline (requires `host_id`),
# `reform` = the group supervisor relaunched the survivors as a
# smaller process group resuming from the newest intact checkpoint
# (requires `from_hosts`/`to_hosts`; rewinds the n_iter baseline like
# `reshard` — observability/schema.REWIND_EVENTS). Both are written by
# the RESUMED attempt's driver from the supervisor's env markers, so
# the recovery story survives the fact that each attempt is a separate
# process writing a fresh trace file.
HOST_EVENTS = ("host_lost", "reform")

# Event types the streaming data layer emits into a training trace
# (data/stream.py, docs/DATA.md): `quarantine` = a data shard failed
# its CRC / finiteness check under on_bad_shard="quarantine" and was
# dropped from every later pass (carries `shard` + `reason` — the
# schema validator requires both); `ingest_resume` = a streaming train
# resumed from a checkpoint (carries the shard count; it rewinds
# NOTHING — deliberately not in schema.REWIND_EVENTS, the resumed
# n_iter baseline stands).
INGEST_EVENTS = ("quarantine", "ingest_resume")

# Event types the LIVE shard-log layer emits (data/live.py +
# approx/primal.fit_approx_stream(live=True) + the continuous-learning
# serving loop — docs/DATA.md "Live shard logs", docs/SERVING.md
# "Continuous learning"): `append_admitted` = one durable appended
# shard entered a reader's admitted view (requires shard + generation;
# carries rows), `ingest_grow` = a live training sweep boundary
# admitted new rows (requires generation + n_new_rows — the divisor/
# step-size math re-derived from the grown view), `refresh` = the
# serving loop chose its refresh flavor (requires refresh_kind =
# "incremental"|"full"; the key is NOT `kind` — that would collide
# with the record kind at write time), `refresh_resume` = a killed
# loop resumed at the gate with its durable candidate.
LIVE_EVENTS = ("append_admitted", "ingest_grow", "refresh",
               "refresh_resume")

# Span names the serving layer records per sampled request (schema v3+,
# docs/OBSERVABILITY.md "Spans"). The `request` root covers admission
# to response; its direct children are the sequential pipeline stages
# (`admission` = parse+validate, `queue_wait` = batcher queue,
# `batch_form` = coalescing window, `device_dispatch` = pool dispatch
# through the engine, `respond` = result assembly + send). Below the
# dispatch stage the pool records `replica_compute` per engine call
# and zero-length markers for the resilience machinery (`hedge_fired`
# / `hedge_won` / `redispatch`). Free strings to the schema; this
# table is the documented vocabulary, like SERVING_EVENTS.
SERVING_SPANS = ("request", "admission", "queue_wait", "batch_form",
                 "device_dispatch", "respond", "replica_compute",
                 "hedge_fired", "hedge_won", "redispatch")

# Event types the model-fleet layer emits into a serving trace
# (dpsvm_tpu/fleet/modelcache.py, docs/SERVING.md "Model fleet"):
# `model_fault` = a cold model was hydrated into the budgeted cache
# (requires `model` + `cold_start_ms` — the measured cold start is the
# whole point of the event; the fleet drill's p99 over these IS the
# `fleet_cold_start_p99_ms` ledger row), `model_evict` = the admission
# ledger paged a resident model's buffers out (requires `model`). The
# watchtower's `model-cache-thrash` rule rates the fault counter these
# events mirror (observability/slo.py).
FLEET_EVENTS = ("model_fault", "model_evict")

# Event types the C×γ grid trainer emits (dpsvm_tpu/fleet/grid.py,
# docs/PERF.md): `grid_cell` = one grid point solved + scored held-out
# (requires `c`/`gamma`/`holdout_acc`; carries n_sv + convergence),
# `grid_winner` = the selected cell (requires `c`/`gamma`; carries
# whether the cascade polish refit it). A grid trace is a training
# trace (solver="grid") whose summary reports the WINNING cell's
# duals plus grid_cells/grid_devices extras.
GRID_EVENTS = ("grid_cell", "grid_winner")

# Event types the continuous-watch layer emits (observability/slo.py +
# blackbox.py, docs/OBSERVABILITY.md "Watch & alerts"): `alert` = a
# rule crossed a state boundary (fired or cleared — `state` says
# which; the schema requires rule/window/severity), `incident` = the
# flight recorder dumped a bundle for a firing (adds `bundle`, the
# directory `dpsvm bundle` renders). Emitted into serving traces by
# the ServingServer's watchtower and into training traces by the
# shared host driver's watch hook.
WATCH_EVENTS = ("alert", "incident")

# Event types the cascade solver emits into its run trace
# (solver/cascade.py, docs/APPROX.md "Cascade"): `screen` = stage-2
# margin-band selection done (carries `n_kept`/`n_total` — the
# subproblem split), `polish` = one exact warm-started solve of the
# kept subproblem finished (carries `round`/`n_kept`), `readmit` =
# the KKT verify of the screened-out rows found violators and grew
# the kept set (carries `round`/`n_readmitted`), `cascade_resume` =
# the run picked up from a durable stage-boundary state file. The
# schema validator enforces the stage ordering
# (observability/schema.py EVENT_EXTRA_KEYS comment).
CASCADE_EVENTS = ("screen", "polish", "readmit", "cascade_resume")


def open_serving_trace(path: str, *, models: Optional[dict] = None,
                       env: Optional[dict] = None,
                       sample_rate: Optional[float] = None) -> "RunTrace":
    """A RunTrace for a SERVING process: manifest solver="serving",
    no chunk records — the manifest, `SERVING_EVENTS` markers as they
    happen, per-request `span` trees for sampled requests
    (``sample_rate``, recorded in the manifest config so a reader
    knows what fraction of traffic the spans represent), and a
    close_serving_trace() summary at drain. The artifact validates
    under the ordinary current schema, so `dpsvm report` and the trace
    tooling consume it unchanged."""
    config = {"models": dict(models or {})}
    if sample_rate is not None:
        config["trace_sample_rate"] = float(sample_rate)
    return RunTrace(path, solver="serving", config=config, env=env)


def close_serving_trace(tr: "RunTrace", *, requests: int = 0,
                        errors: int = 0, seconds: float = 0.0,
                        **extra) -> None:
    """Stamp the zero-filled solver summary a serving trace ends with
    (the solver fields are schema-required; a serving process has no
    duals, so they read as zeros) plus the serving counters."""
    if tr.closed:
        return
    tr.summary(converged=True, n_iter=0, b=0.0, b_lo=0.0, b_hi=0.0,
               n_sv=0, train_seconds=float(seconds),
               requests=int(requests), errors=int(errors), **extra)
    tr.close()


def _config_dict(config) -> dict:
    if config is None:
        return {}
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    return dict(config)


class RunTrace:
    """One training run's JSONL recorder.

    Construction writes the manifest; ``chunk``/``event``/``compile``
    append during the run; ``summary`` + ``close`` finish it. All
    record shapes are owned here so every producer (driver, shrink
    manager, benchmarks) emits the one schema
    observability/schema.validate_trace checks.

    The recorder also accumulates the run-level device facts the v2
    summary carries — compile count/seconds, the FLOPs estimate of the
    newest program, the high-water HBM mark across polls — so
    producers only report what they observe and the totals can never
    drift from the records they summarize.
    """

    def __init__(self, path: str, *, config=None, n: int = 0, d: int = 0,
                 gamma: float = 0.0, solver: str = "unknown",
                 it0: int = 0, env: Optional[dict] = None):
        config_d = _config_dict(config)
        kernel = {
            "kind": config_d.get("kernel", "rbf"),
            "gamma": float(gamma),
            "coef0": float(config_d.get("coef0", 0.0)),
            "degree": int(config_d.get("degree", 3)),
        }
        mesh = {"shards": int(config_d.get("shards", 1)),
                "shard_x": bool(config_d.get("shard_x", True))}
        from dpsvm_tpu_torch import __version__
        self._w = TraceWriter(path)
        self._t0 = time.perf_counter()
        self._it0 = int(it0)
        self._closed = False
        self._n_compiles = 0
        self._compile_seconds = 0.0
        self._est_flops: Optional[float] = None
        self._est_bytes: Optional[float] = None
        self._hbm_peak: Optional[int] = None
        # Serving traces are written from many threads (handler threads
        # emitting request spans, pool workers emitting events): one
        # lock serializes the (timestamp, write) pair so `t` stays
        # non-decreasing in file order — the schema's ordering rule.
        self._lock = threading.Lock()
        self._w.write({
            "kind": "manifest",
            "schema": TRACE_SCHEMA_VERSION,
            "version": __version__,
            "solver": solver,
            "n": int(n),
            "d": int(d),
            "gamma": float(gamma),
            "kernel": kernel,
            "mesh": mesh,
            "env": dict(env or {"backend": None, "device_kind": None,
                                "device_count": None}),
            "config": config_d,
            "it0": int(it0),
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            # High-resolution wall-clock anchor for cross-host merge
            # (observability/merge.py): `t` values are perf_counter
            # offsets from THIS instant, so hosts sharing a wall clock
            # (one machine, or an NTP-synced pod) align exactly via
            # unix_k - unix_ref — the only anchor a constant straggler
            # lag cannot contaminate.
            "unix": time.time(),
        })
        _OPEN_TRACES.add(self)

    @property
    def path(self) -> str:
        return self._w.path

    @property
    def closed(self) -> bool:
        return self._closed

    def _t(self) -> float:
        return round(time.perf_counter() - self._t0, 6)

    def _note_hbm(self, hbm: Optional[dict]) -> Optional[dict]:
        if not hbm:
            return {"in_use": None, "peak": None, "limit": None}
        peak = hbm.get("peak")
        if peak is not None:
            self._hbm_peak = max(self._hbm_peak or 0, int(peak))
        return {"in_use": hbm.get("in_use"), "peak": peak,
                "limit": hbm.get("limit")}

    def chunk(self, *, n_iter: int, b_lo: float, b_hi: float,
              n_sv: int = 0, cache_hits: int = 0, cache_misses: int = 0,
              rounds: int = 0,
              phases: Optional[Dict[str, float]] = None,
              phase_counts: Optional[Dict[str, int]] = None,
              hbm: Optional[dict] = None,
              **extra) -> None:
        """One host-poll record. Every argument is already on the host
        (the packed-stats read; ``hbm`` is a host-side
        ``device.memory_stats()`` dictionary read) — recording is file
        I/O only."""
        rec = {
            "kind": "chunk",
            "n_iter": int(n_iter),
            "b_lo": float(b_lo),
            "b_hi": float(b_hi),
            "gap": float(b_lo) - float(b_hi),
            "n_sv": int(n_sv),
            "cache_hits": int(cache_hits),
            "cache_misses": int(cache_misses),
            "rounds": int(rounds),
            "t": self._t(),
            "phases": {k: round(float(v), 6)
                       for k, v in (phases or {}).items()},
            "phase_counts": {k: int(v)
                             for k, v in (phase_counts or {}).items()},
            "hbm": self._note_hbm(hbm),
        }
        rec.update(extra)
        self._w.write(rec)

    def event(self, event: str, *, n_iter: int = 0, **extra) -> None:
        """Solver lifecycle marker: checkpoint, program_swap (working-set
        growth), wall_budget, shrink, unshrink."""
        with self._lock:
            rec = {"kind": "event", "event": str(event),
                   "n_iter": int(n_iter), "t": self._t()}
            rec.update(extra)
            self._w.write(rec)

    def span(self, *, trace_id, span_id: int, parent: Optional[int],
             name: str, t_start: float, t_end: float, **extra) -> None:
        """One request-scoped span (schema v3+; serving producers:
        observability/spans.RequestSpans via ServingServer).
        ``t_start``/``t_end`` are ABSOLUTE time.perf_counter readings —
        the recorder rebases them onto its own t0 so every span shares
        the trace's clock. All spans of one request are emitted
        together at request completion, under the write lock, so
        records of concurrent requests interleave whole, never torn."""
        rel0 = round(float(t_start) - self._t0, 6)
        rel1 = round(float(t_end) - self._t0, 6)
        with self._lock:
            rec = {"kind": "span", "trace_id": trace_id,
                   "span_id": int(span_id),
                   "parent": int(parent) if parent is not None else None,
                   "name": str(name), "t_start": rel0, "t_end": rel1,
                   "t": self._t()}
            rec.update(extra)
            self._w.write(rec)

    def compile(self, *, program: str, seconds: float,
                signature: Optional[str] = None,
                flops: Optional[float] = None,
                bytes: Optional[float] = None, n_iter: int = 0,
                **extra) -> None:
        """One XLA compile (or retrace) of a chunk program
        (observability/compilewatch.py detects them; the driver drains
        its log here). ``flops``/``bytes`` are the program's
        cost_analysis estimates — on the chunk runners, the while-loop
        body counted once, i.e. ~per-iteration FLOPs and bytes-accessed
        (docs/OBSERVABILITY.md); together they are the arithmetic
        intensity the roofline verdict divides
        (observability/roofline.py)."""
        with self._lock:
            rec = {"kind": "compile", "program": str(program),
                   "seconds": round(float(seconds), 6),
                   "signature": signature,
                   "flops": float(flops) if flops is not None else None,
                   "bytes": float(bytes) if bytes is not None else None,
                   "n_iter": int(n_iter), "t": self._t()}
            rec.update(extra)
            self._n_compiles += 1
            self._compile_seconds += float(seconds)
            if flops is not None:
                self._est_flops = float(flops)
            if bytes is not None:
                self._est_bytes = float(bytes)
            self._w.write(rec)

    def summary(self, *, converged: bool, n_iter: int, b: float,
                b_lo: float, b_hi: float, n_sv: int,
                train_seconds: float, cache_hits: int = 0,
                cache_misses: int = 0,
                phases: Optional[Dict[str, float]] = None,
                phase_counts: Optional[Dict[str, int]] = None,
                **extra) -> None:
        iters = int(n_iter) - self._it0
        lookups = int(cache_hits) + int(cache_misses)
        rec = {
            "kind": "summary",
            "converged": bool(converged),
            "n_iter": int(n_iter),
            "iters": iters,
            "iters_per_sec": round(iters / train_seconds, 3)
            if train_seconds > 0 else 0.0,
            "b": float(b),
            "b_lo": float(b_lo),
            "b_hi": float(b_hi),
            "gap": float(b_lo) - float(b_hi),
            "n_sv": int(n_sv),
            "cache_hits": int(cache_hits),
            "cache_misses": int(cache_misses),
            "cache_hit_rate": round(cache_hits / lookups, 6)
            if lookups else None,
            "train_seconds": round(float(train_seconds), 6),
            "phases": {k: round(float(v), 6)
                       for k, v in (phases or {}).items()},
            "phase_counts": {k: int(v)
                             for k, v in (phase_counts or {}).items()},
            "n_compiles": self._n_compiles,
            "compile_seconds": round(self._compile_seconds, 6),
            "hbm_peak": self._hbm_peak,
            "est_flops": self._est_flops,
            "est_bytes": self._est_bytes,
            "t": self._t(),
        }
        rec.update(extra)
        with self._lock:
            rec["t"] = self._t()
            self._w.write(rec)

    def close(self) -> None:
        self._closed = True
        _OPEN_TRACES.discard(self)
        self._w.close()
