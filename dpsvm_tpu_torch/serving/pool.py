"""Replica pool: N prediction engines with failure isolation (port of
``dpsvm_tpu/serving/pool.py``).

One engine behind one batcher worker is fragile — a
single wedged device call (or a poisoned replica emitting NaN) takes
every request down with it, and the only recovery is a process
restart. "Parallel SVMs in Practice" (arXiv:1404.1066) argues that in
deployed systems availability dominates one-shot training quality;
this module is that argument applied to our serving half
(docs/SERVING.md "Resilience"):

* **Failure isolation** — each replica is its own ``PredictionEngine``
  (own device buffers, own warmed ladder) with its own worker thread.
  A wedged or poisoned replica loses *itself*; the pool keeps
  answering from the others.
* **Health + circuit breaker** — every dispatch feeds the replica's
  ``resilience.health.ReplicaMonitor`` (the training HealthMonitor's
  window shape on serving vitals: latency + non-finite output
  counts). A deadline blown *while computing* marks the replica
  wedged; a single non-finite output marks it poisoned (inputs are
  validated finite at admission, so non-finite out = corrupted
  replica state — the serving analogue of the always-armed NaN-gap
  guard). Either way the replica's circuit opens (``eject`` event),
  it stops receiving traffic, and a background rebuild constructs a
  fresh engine from the model source; the rebuilt replica re-enters
  **half-open** and must answer one probe dispatch before the circuit
  closes.
* **Deadline budgets** — every dispatch carries an absolute deadline
  (serving/budget.py). A reaper thread fails blown dispatches with
  ``DeadlineExceededError`` (HTTP: 504) instead of letting callers
  hang on a dead replica.
* **Hedging** — optionally, a dispatch still unanswered after a
  p99-based delay is re-dispatched to a second replica; first answer
  wins (``hedge`` event, hedges fired/won counted). Output parity
  makes this safe: replicas serve the same artifact and rows are
  batch-mate independent, so either answer is THE answer.

Determinism for CI: every failure mode has an injection point in
``resilience/faultinject.py`` (``DPSVM_FAULT_SERVE_*``), so wedge /
poison / failed-rebuild are exact, reproducible events on CPU.

On the card each replica's worker replays its engine's graphs on a
CUDA stream of its own, so replicas of one device overlap and a
rebuild's (thread-local) capture runs beside their replays. "Stray
compiles" are capture and build observations
(``observability/compilewatch``, each engine capture one) made outside a
replica build: the steady state captures nothing, and a rebuild's own
warmup captures are drained inside its build guard.

No device at module import: engines are built by the caller-supplied
``build_fn`` (the registry's loader); the pool itself is stdlib +
numpy and testable with stub engines.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np

from dpsvm_tpu_torch.observability import compilewatch
from dpsvm_tpu_torch.observability.metrics import MetricsRegistry
from dpsvm_tpu_torch.resilience import faultinject
from dpsvm_tpu_torch.resilience.health import ReplicaMonitor
from dpsvm_tpu_torch.serving.budget import DeadlineExceededError, hedge_delay_s

#: circuit-breaker states
CLOSED = "closed"          # healthy, receiving traffic
OPEN = "open"              # ejected, rebuild pending/in-flight
HALF_OPEN = "half-open"    # rebuilt, awaiting its probe dispatch

#: rebuild retry policy (the injected-fault model is transient, so
#: retrying is the point; the cap stops a permanently-broken source
#: from spinning forever)
REBUILD_MAX_ATTEMPTS = 6


def _drain_captures() -> int:
    """Observations since the previous drain, process-wide: captures and
    builds (``observability/compilewatch``, the source the JAX package's
    pool drains)."""
    return len(compilewatch.drain())


def _replica_stream(engine):
    """A CUDA stream of the replica's own when its engine is on the card,
    else None."""
    dev = getattr(engine, "device", None)
    if getattr(dev, "type", None) != "cuda":
        return None
    import torch
    return torch.cuda.Stream(dev)


def _on_stream(stream):
    if stream is None:
        return contextlib.nullcontext()
    import torch
    return torch.cuda.stream(stream)


class PoolUnavailableError(RuntimeError):
    """No replica can take the dispatch (all circuits open). The HTTP
    layer maps this to 503 — the pool is rebuilding, try again."""


class _Dispatch:
    """One batch's journey through the pool: publish-once future with
    deadline, hedge bookkeeping and a record of who is computing it."""

    __slots__ = ("x", "want", "deadline", "event", "result", "error",
                 "lock", "done", "winner", "t0", "hedge_at",
                 "hedge_fired", "primary_idx", "attempts", "computing",
                 "spans")

    def __init__(self, x: np.ndarray, want: Tuple[str, ...],
                 deadline: float, hedge_at: Optional[float],
                 spans: Sequence = ()):
        # span contexts (observability/spans.RequestSpans) of the
        # sampled requests riding this batch: the pool hangs its
        # replica_compute / hedge / redispatch spans under each one's
        # device_dispatch stage (docs/OBSERVABILITY.md "Spans")
        self.spans = tuple(spans or ())
        self.x = x
        self.want = want
        self.deadline = float(deadline)
        self.event = threading.Event()
        self.lock = threading.Lock()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.done = False
        self.winner: Optional[int] = None
        self.t0 = time.perf_counter()
        self.hedge_at = hedge_at       # absolute; None = hedging off
        self.hedge_fired = False
        self.primary_idx: Optional[int] = None
        self.attempts = 0              # redispatches after failures
        self.computing: List["_Replica"] = []

    def complete(self, result: Optional[dict] = None,
                 error: Optional[BaseException] = None,
                 winner: Optional[int] = None) -> bool:
        """Publish exactly once; False if someone already did."""
        with self.lock:
            if self.done:
                return False
            self.done = True
            self.result = result
            self.error = error
            self.winner = winner
        self.event.set()
        return True


class _Replica:
    """One engine + its worker thread + its health record."""

    def __init__(self, idx: int, engine, generation: int = 1,
                 state: str = CLOSED):
        self.idx = int(idx)
        self.engine = engine
        self.generation = int(generation)
        self.state = state
        self.retired = False           # ejected or refreshed away
        self.probing = False           # half-open probe in flight
        self.busy_since: Optional[float] = None  # compute in flight
        self.monitor = ReplicaMonitor()
        self.queue: deque = deque()
        self.cond = threading.Condition()
        self.thread: Optional[threading.Thread] = None
        self.stream = _replica_stream(engine)

    def enqueue(self, d: _Dispatch) -> None:
        with self.cond:
            self.queue.append(d)
            self.cond.notify()

    def drain_queue(self) -> List[_Dispatch]:
        with self.cond:
            out = list(self.queue)
            self.queue.clear()
            self.cond.notify_all()
        return out


#: pool robustness counters: one registry counter family each, labeled
#: by model — the hand-rolled dict these replaced lives on only as the
#: keys of `metrics()` (docs/OBSERVABILITY.md "Metrics")
_POOL_COUNTER_HELP = {
    "dispatches": "batches dispatched to a replica",
    "ejections": "replicas ejected by the circuit breaker",
    "rebuilds": "successful background replica rebuilds",
    "rebuild_failures": "failed replica rebuild attempts",
    "hedges_fired": "hedged re-dispatches fired",
    "hedges_won": "hedged re-dispatches that answered first",
    "redispatches": "dispatches retried on another replica",
    "timeouts": "dispatches failed on a blown deadline",
}


class ReplicaPool:
    """N replicas behind one dispatch interface (module docstring).

    ``build_fn(idx)`` constructs a warmed engine for slot ``idx`` —
    called at construction, and again for every background rebuild
    (which is what makes a rebuild pick up the CURRENT registry
    source, i.e. the artifact generation serving now).

    ``hedge``: ``"off"`` (default), ``"auto"`` (p99-based delay from
    the pool's rolling latency window), or a float delay in seconds.

    ``metrics``: the ``observability.metrics.MetricsRegistry`` the
    pool's robustness counters live in (labeled ``model=<name>``) —
    the ServingServer passes its own so `/metricsz?format=prometheus`
    exposes them; a standalone pool gets a private registry and
    behaves exactly as before.
    """

    def __init__(self, build_fn: Callable[[int], object],
                 n_replicas: int = 1, *, name: str = "default",
                 deadline_s: float = 30.0, hedge="off",
                 rebuild: bool = True, rebuild_backoff_s: float = 0.05,
                 reap_interval_s: float = 0.005,
                 watch_compiles: bool = False,
                 on_event: Optional[Callable[..., None]] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.name = str(name)
        self.build_fn = build_fn
        self.deadline_s = float(deadline_s)
        self.hedge = hedge
        self.rebuild = bool(rebuild)
        self.rebuild_backoff_s = float(rebuild_backoff_s)
        self.reap_interval_s = float(reap_interval_s)
        self.watch_compiles = bool(watch_compiles)
        self._on_event = on_event
        self.events: deque = deque(maxlen=512)
        self._lock = threading.Lock()
        self._rr = 0                   # round-robin cursor
        self._inflight: Set[_Dispatch] = set()
        self._lat_ms: deque = deque(maxlen=512)
        self._building = 0
        self._stray = 0
        # Robustness counters migrated onto the unified metric
        # registry (observability/metrics.py): one counter family per
        # key, this pool's series labeled by model name. `metrics()`
        # reads the same series back, so the JSON view and the
        # Prometheus exposition can never disagree.
        self._mreg = metrics if metrics is not None else MetricsRegistry()
        self._counters = {
            key: self._mreg.counter(f"dpsvm_pool_{key}_total", help_,
                                    labels=("model",))
            .labels(model=self.name)
            for key, help_ in _POOL_COUNTER_HELP.items()}
        self._stop = threading.Event()
        self._replicas: List[_Replica] = []
        for i in range(int(n_replicas)):
            with self._build_guard():
                engine = build_fn(i)
            self._replicas.append(self._spawn(i, engine, generation=1,
                                              state=CLOSED))
        if self.watch_compiles:
            # post-warmup baseline: anything drained later is a stray
            _drain_captures()
        self._reaper = threading.Thread(
            target=self._reap, name=f"dpsvm-pool[{self.name}]-reaper",
            daemon=True)
        self._reaper.start()

    # -- construction helpers -----------------------------------------

    class _BuildGuard:
        def __init__(self, pool):
            self.pool = pool

        def __enter__(self):
            with self.pool._lock:
                self.pool._building += 1

        def __exit__(self, *exc):
            if self.pool.watch_compiles:
                # the build's own warmup compiles are not strays;
                # drained before _building drops so a concurrent
                # stray_compiles() can never misattribute them
                _drain_captures()
            with self.pool._lock:
                self.pool._building -= 1

    def _build_guard(self) -> "_BuildGuard":
        return self._BuildGuard(self)

    def _spawn(self, idx: int, engine, *, generation: int,
               state: str) -> _Replica:
        r = _Replica(idx, engine, generation=generation, state=state)
        r.thread = threading.Thread(
            target=self._worker, args=(r,),
            name=f"dpsvm-pool[{self.name}]-r{idx}g{generation}",
            daemon=True)
        r.thread.start()
        return r

    # -- events -------------------------------------------------------

    def _emit(self, event: str, **extra) -> None:
        rec = {"event": event, **extra}
        self.events.append(rec)
        if self._on_event is not None:
            try:
                self._on_event(event, **extra)
            except Exception:
                pass                   # observability must not kill serving

    # -- dispatch -----------------------------------------------------

    def _hedge_at(self, t0: float) -> Optional[float]:
        if self.hedge in (None, "off", False) or len(self._replicas) < 2:
            return None
        if self.hedge == "auto":
            with self._lock:
                window = list(self._lat_ms)
            return t0 + hedge_delay_s(window)
        return t0 + float(self.hedge)

    def _choose(self, exclude: Set[int] = frozenset()
                ) -> Optional[_Replica]:
        """Round-robin over CLOSED replicas; a HALF_OPEN replica with
        no probe in flight is eligible too (and the chosen dispatch IS
        its probe). None = every circuit open."""
        with self._lock:
            n = len(self._replicas)
            for step in range(n):
                r = self._replicas[(self._rr + step) % n]
                if r.idx in exclude or r.retired:
                    continue
                if r.state == CLOSED:
                    self._rr = (self._rr + step + 1) % n
                    return r
                if r.state == HALF_OPEN and not r.probing:
                    # probed in ordinary rotation — a rebuilt replica
                    # re-enters service without waiting for the rest of
                    # the pool to fail first
                    r.probing = True
                    self._rr = (self._rr + step + 1) % n
                    return r
        return None

    def infer(self, x, want: Sequence[str] = ("labels",), *,
              timeout: Optional[float] = None,
              deadline: Optional[float] = None,
              spans: Sequence = ()) -> dict:
        """Dispatch one batch; blocks until a replica answers or the
        deadline passes. Raises DeadlineExceededError (504) on a blown
        budget, PoolUnavailableError (503) when every circuit is open,
        ValueError for client mistakes (width mismatch etc.).
        ``spans``: RequestSpans contexts of the batch's sampled
        requests (the batcher threads them through)."""
        x = np.asarray(x, np.float32)
        if deadline is None:
            deadline = time.perf_counter() + (self.deadline_s
                                              if timeout is None
                                              else float(timeout))
        d = _Dispatch(x, tuple(want), deadline, self._hedge_at(
            time.perf_counter()), spans=spans)
        r = self._choose()
        if r is None:
            raise PoolUnavailableError(
                f"pool {self.name!r}: no healthy replica "
                f"(all {len(self._replicas)} circuits open; rebuilding)")
        d.primary_idx = r.idx
        with self._lock:
            self._counters["dispatches"].inc()
            self._inflight.add(d)
        r.enqueue(d)
        try:
            d.event.wait(max(0.0, deadline - time.perf_counter())
                         + 4 * self.reap_interval_s + 0.05)
            if not d.event.is_set():
                # reaper missed (extreme scheduling); fail it ourselves
                self._fail_deadline(d)
        finally:
            with self._lock:
                self._inflight.discard(d)
        if d.error is not None:
            raise d.error
        return d.result

    @staticmethod
    def _span_mark(d: _Dispatch, name: str, **extra) -> None:
        """Stamp a marker span under every sampled request of the
        batch. Defensive: attribution must never kill serving."""
        for ctx in d.spans:
            try:
                ctx.mark(name, parent="device_dispatch", **extra)
            except Exception:
                pass

    def _redispatch(self, d: _Dispatch, exclude: Set[int]) -> None:
        if d.done:
            return
        self._span_mark(d, "redispatch", excluded=sorted(exclude))
        d.attempts += 1
        if d.attempts >= len(self._replicas) + 1:
            d.complete(error=PoolUnavailableError(
                f"pool {self.name!r}: dispatch failed on "
                f"{d.attempts} replicas"))
            return
        r = self._choose(exclude=exclude)
        if r is None:
            d.complete(error=PoolUnavailableError(
                f"pool {self.name!r}: no healthy replica left for "
                "redispatch"))
            return
        with self._lock:
            self._counters["redispatches"].inc()
        r.enqueue(d)

    # -- worker -------------------------------------------------------

    def _worker(self, replica: _Replica) -> None:
        while True:
            with replica.cond:
                while not replica.queue:
                    if replica.retired or self._stop.is_set():
                        return
                    replica.cond.wait(0.1)
                d = replica.queue.popleft()
            if replica.retired:
                self._redispatch(d, exclude={replica.idx})
                continue
            self._compute(replica, d)
            if replica.retired:        # ejected mid-compute (wedge)
                return

    def _unprobe(self, replica: _Replica) -> None:
        """Half-open probe fell through without a verdict (its dispatch
        was answered elsewhere / was a client error) — make the replica
        eligible for the next probe instead of wedging it half-open."""
        with self._lock:
            if replica.state == HALF_OPEN:
                replica.probing = False

    def _compute(self, replica: _Replica, d: _Dispatch) -> None:
        with d.lock:
            if d.done:
                self._unprobe(replica)
                return
            d.computing.append(replica)
        t0 = time.perf_counter()
        # busy_since is what the reaper watches for wedge detection: a
        # compute older than the pool deadline marks the REPLICA wedged
        # even when the dispatch itself was rescued by a hedge (else a
        # won hedge would mask the wedge and the stuck worker's queue
        # would grow unserved forever).
        replica.busy_since = t0
        # Per-request compute spans: each sampled request riding this
        # batch gets a replica_compute child under its device_dispatch
        # (ended in the finally — a wedged compute keeps its span open
        # until the request's finish() cuts it at the root, which IS
        # the attribution of a wedge).
        comp_spans = []
        for ctx in d.spans:
            try:
                # (model, tenant) on the compute span (schema v4): the
                # identity rides the request's span context, so
                # per-tenant device-compute cost is pure host-side
                # span math — zero extra device transfers.
                ident = {"model": self.name}
                tenant = getattr(ctx, "tenant", None)
                if tenant is not None:
                    ident["tenant"] = tenant
                comp_spans.append(
                    (ctx, ctx.start("replica_compute",
                                    parent="device_dispatch",
                                    replica=replica.idx,
                                    generation=replica.generation,
                                    **ident)))
            except Exception:
                pass
        try:
            plan = faultinject.current()
            if plan is not None and plan.note_serve_compute(
                    replica.idx, replica.generation):
                faultinject.serve_wedge_wait()
                if d.done or replica.retired:
                    self._unprobe(replica)
                    return             # released after ejection
            if plan is not None:
                # slow-replica drill (DPSVM_FAULT_SERVE_SLOW_REPLICA_MS):
                # the compute takes longer than the request deadline ->
                # 504 storm -> the serving burn-rate rule must fire
                slow_s = plan.serve_slow_delay_s()
                if slow_s > 0:
                    time.sleep(slow_s)
            try:
                with _on_stream(replica.stream):
                    res = replica.engine.infer(d.x, d.want)
            except ValueError as e:
                d.complete(error=e)    # client mistake, not replica ill
                self._unprobe(replica)
                return
            except Exception as e:     # replica fault: isolate + retry
                replica.monitor.note_nonfinite()
                self._eject(replica, f"compute error: {e}")
                self._redispatch(d, exclude={replica.idx})
                return
        finally:
            replica.busy_since = None
            for ctx, sp in comp_spans:
                try:
                    ctx.end(sp)
                except Exception:
                    pass
        ms = (time.perf_counter() - t0) * 1000.0
        replica.monitor.note_latency(ms)
        with self._lock:
            self._lat_ms.append(ms)
        if plan is not None and plan.serve_poisoned(replica.idx,
                                                    replica.generation):
            res = {k: np.full(np.shape(v), np.nan)
                   for k, v in res.items()}
        if self._nonfinite(res):
            replica.monitor.note_nonfinite()
            self._eject(replica, "nonfinite outputs")
            self._redispatch(d, exclude={replica.idx})
            return
        won = d.complete(result=res, winner=replica.idx)
        if won and d.hedge_fired and replica.idx != d.primary_idx:
            with self._lock:
                self._counters["hedges_won"].inc()
            self._span_mark(d, "hedge_won", replica=replica.idx)
        if replica.state == HALF_OPEN:
            # a finite, timely compute is the probe's verdict whether
            # or not it won the publish race: close the circuit
            with self._lock:
                replica.state = CLOSED
                replica.probing = False

    @staticmethod
    def _nonfinite(res: dict) -> bool:
        for v in res.values():
            a = np.asarray(v)
            if (np.issubdtype(a.dtype, np.floating)
                    and not np.all(np.isfinite(a))):
                return True
        return False

    # -- circuit breaker ----------------------------------------------

    def _eject(self, replica: _Replica, reason: str) -> None:
        with self._lock:
            if replica.retired:
                return
            replica.retired = True
            replica.state = OPEN
            self._counters["ejections"].inc()
        self._emit("eject", replica=replica.idx,
                   generation=replica.generation, reason=reason)
        for d in replica.drain_queue():
            self._redispatch(d, exclude={replica.idx})
        if self.rebuild and not self._stop.is_set():
            threading.Thread(
                target=self._rebuild,
                args=(replica.idx, replica.generation),
                name=f"dpsvm-pool[{self.name}]-rebuild{replica.idx}",
                daemon=True).start()

    def _rebuild(self, idx: int, old_generation: int) -> None:
        attempt = 0
        while not self._stop.is_set():
            attempt += 1
            try:
                with self._build_guard():
                    faultinject.on_serve_reload()
                    engine = self.build_fn(idx)
            except Exception as e:     # noqa: BLE001 — retried/reported
                with self._lock:
                    self._counters["rebuild_failures"].inc()
                self._emit("rebuild", replica=idx, ok=False,
                           attempt=attempt, error=str(e))
                if attempt >= REBUILD_MAX_ATTEMPTS:
                    return             # stays OPEN; operator visible
                self._stop.wait(self.rebuild_backoff_s
                                * (2 ** (attempt - 1)))
                continue
            new = self._spawn(idx, engine,
                              generation=old_generation + 1,
                              state=HALF_OPEN)
            with self._lock:
                self._replicas[idx] = new
                self._counters["rebuilds"].inc()
            self._emit("rebuild", replica=idx, ok=True,
                       generation=new.generation, attempt=attempt)
            return

    def refresh(self) -> None:
        """Rolling rebuild of every replica from the CURRENT source —
        the pool side of a registry hot-swap. One replica at a time,
        each fully built+warmed before its predecessor retires, so the
        pool keeps serving throughout (briefly mixed generations)."""
        for idx in range(len(self._replicas)):
            with self._build_guard():
                engine = self.build_fn(idx)
            with self._lock:
                old = self._replicas[idx]
                new = self._spawn(idx, engine,
                                  generation=old.generation + 1,
                                  state=CLOSED)
                self._replicas[idx] = new
                old.retired = True
            for d in old.drain_queue():
                self._redispatch(d, exclude=set())

    # -- reaper -------------------------------------------------------

    def _fail_deadline(self, d: _Dispatch) -> None:
        with d.lock:
            computing = list(d.computing)
        completed = d.complete(error=DeadlineExceededError(
            "deadline budget exhausted before any replica answered"))
        if not completed:
            return
        with self._lock:
            self._counters["timeouts"].inc()
        for r in computing:
            r.monitor.note_timeout()
            self._eject(r, "wedge (deadline blown while computing)")

    def _reap(self) -> None:
        while not self._stop.is_set():
            now = time.perf_counter()
            with self._lock:
                inflight = list(self._inflight)
                replicas = list(self._replicas)
            for r in replicas:
                busy = r.busy_since
                if (busy is not None and not r.retired
                        and now - busy > self.deadline_s):
                    r.monitor.note_timeout()
                    self._eject(r, "wedge (compute exceeded the pool "
                                   "deadline)")
            for d in inflight:
                if d.done:
                    continue
                if now >= d.deadline:
                    self._fail_deadline(d)
                    continue
                if (d.hedge_at is not None and not d.hedge_fired
                        and now >= d.hedge_at):
                    d.hedge_fired = True
                    with d.lock:
                        busy = {r.idx for r in d.computing}
                    r2 = self._choose(exclude=busy | {d.primary_idx})
                    if r2 is not None:
                        with self._lock:
                            self._counters["hedges_fired"].inc()
                        self._emit("hedge", primary=d.primary_idx,
                                   hedge=r2.idx)
                        self._span_mark(d, "hedge_fired",
                                        primary=d.primary_idx,
                                        hedge=r2.idx)
                        r2.enqueue(d)
            self._stop.wait(self.reap_interval_s)

    # -- facts --------------------------------------------------------

    @property
    def num_attributes(self) -> int:
        return int(self._replicas[0].engine.num_attributes)

    @property
    def n_healthy(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas
                       if not r.retired and r.state == CLOSED)

    def replica_states(self) -> List[str]:
        with self._lock:
            return [r.state for r in self._replicas]

    def stray_compiles(self) -> int:
        """Graph captures observed OUTSIDE engine builds since the pool
        warmed — the steady-state-retrace counter the chaos acceptance
        pins at zero. Pull-based (drained on read) and suppressed while
        a build is in flight so a rebuild's own warmup is never
        miscounted as a stray."""
        if not self.watch_compiles:
            return self._stray
        with self._lock:
            if self._building > 0:
                return self._stray
        self._stray += _drain_captures()
        return self._stray

    def metrics(self) -> dict:
        with self._lock:
            reps = list(self._replicas)
        # the registry series ARE the counters now; the JSON view reads
        # them back so the two surfaces cannot drift
        out = {k: int(c.value) for k, c in self._counters.items()}
        out["n_replicas"] = len(reps)
        out["n_healthy"] = sum(1 for r in reps
                               if not r.retired and r.state == CLOSED)
        out["stray_compiles"] = self.stray_compiles()
        out["replicas"] = [
            {"replica": r.idx, "state": (OPEN if r.retired and
                                         r.state != OPEN else r.state),
             "generation": r.generation, **r.monitor.stats()}
            for r in reps]
        return out

    # -- lifecycle ----------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            reps = list(self._replicas)
        for r in reps:
            r.retired = True
            with r.cond:
                r.cond.notify_all()
        for r in reps:
            if r.thread is not None:
                r.thread.join(0.5)     # wedged threads stay abandoned
