"""Request-scoped span trees: where one serving request's time went (port
of ``dpsvm_tpu/observability/spans.py``).

`/metricsz` answers "how slow are requests" (p50/p95/p99 over a
window) but not "WHY was this one slow" — a 48 ms request that spent
46 ms queued needs a different fix (admission control, more replicas)
than one that spent 46 ms in the device dispatch (bigger buckets,
hedging). "Parallel SVMs in Practice" (arXiv:1404.1066) puts exactly
this per-request operational visibility on the deployment-critical
list. This module is the recorder the serving stack threads through
itself (docs/OBSERVABILITY.md "Spans"):

* the HTTP layer opens one ``RequestSpans`` per SAMPLED request
  (``dpsvm serve --trace-sample-rate``) — the root ``request`` span;
* each pipeline stage brackets itself: ``admission`` (parse +
  validate) in the handler, ``queue_wait``/``batch_form``/
  ``device_dispatch`` in the micro-batcher (serving/batcher.py),
  ``replica_compute`` + the hedge/redispatch markers in the replica
  pool (serving/pool.py), ``respond`` back in the handler;
* at request completion ``finish()`` closes the tree — clamping every
  child into the root's interval and force-ending still-open stages
  at the root end, so a request that died waiting (504) shows WHERE
  it was waiting instead of losing the span — and the server emits
  the spans as ``span`` records (schema v3+) into the serving trace
  (observability/record.RunTrace.span).

Everything here is stdlib (perf_counter + a lock): recording a span is
two clock reads and a list append, which is what keeps the sampled
steady-state overhead inside the pinned bound (tests/test_spans.py).

The tree invariants the schema validator enforces
(observability/schema._validate_spans) are established HERE: children
clamped inside the root, stage spans sequential so the root's direct
children can never sum past its wall time — the shortfall is the
request's *unattributed* residual, reported by ``dpsvm report``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

#: the root span's name — one per request, parent=null.
ROOT = "request"


class Span:
    """One named interval (absolute perf_counter endpoints; ``end`` is
    None while open). ``extra`` lands verbatim on the trace record."""

    __slots__ = ("span_id", "parent", "name", "start", "end", "extra")

    def __init__(self, span_id: int, parent: Optional[int], name: str,
                 start: float, extra: dict):
        self.span_id = span_id
        self.parent = parent
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.extra = extra

    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start


class RequestSpans:
    """One request's span tree, built concurrently by the handler
    thread, the batcher worker and the pool workers (thread-safe).

    ``start(name, parent=...)`` opens a child span — ``parent`` names
    an earlier span (default: the root) and is resolved by name, last
    opened wins, so the pool can hang ``replica_compute`` under
    whichever ``device_dispatch`` is current without holding a
    reference across the queue. ``start`` returns the Span; enders
    that might race a same-named sibling (hedged computes) pass the
    Span back to ``end`` instead of the name."""

    __slots__ = ("trace_id", "_lock", "_spans", "_by_name", "_next_id",
                 "finished", "tenant", "model")

    def __init__(self, trace_id, first_stage: Optional[str] = None):
        self.trace_id = trace_id
        self._lock = threading.Lock()
        self._next_id = 0
        self._spans: List[Span] = []
        self._by_name: Dict[str, Span] = {}
        self.finished = False
        # Tenant/model identity (schema v4, docs/OBSERVABILITY.md
        # "Per-tenant attribution"): set by the HTTP layer right after
        # it parses the request body, read by every downstream stage
        # (the pool stamps them on replica_compute spans) and merged
        # into the root's extras at finish — the tree IS the carrier,
        # so no pipeline signature needs a tenant parameter.
        self.tenant: Optional[str] = None
        self.model: Optional[str] = None
        root = self._open(ROOT, parent_id=None, extra={})
        if first_stage:
            # first stage opens at the root's exact timestamp: a
            # thread preempted between "create tree" and "bracket
            # stage 1" would otherwise leak the stall into the
            # unattributed residual
            self._open(first_stage, parent_id=root.span_id, extra={},
                       at=root.start)

    def _open(self, name: str, parent_id: Optional[int],
              extra: dict, at: Optional[float] = None) -> Span:
        sp = Span(self._next_id, parent_id, name,
                  time.perf_counter() if at is None else at, extra)
        self._next_id += 1
        self._spans.append(sp)
        self._by_name[name] = sp
        return sp

    @property
    def root(self) -> Span:
        return self._spans[0]

    def start(self, name: str, parent: str = ROOT, **extra) -> Span:
        with self._lock:
            psp = self._by_name.get(parent)
            pid = psp.span_id if psp is not None else 0
            sp = self._open(name, pid, extra)
            if pid == 0:
                # The root's direct children are SEQUENTIAL pipeline
                # stages: starting the next stage closes the previous
                # one at exactly this instant, so no time can fall
                # into the cracks between two brackets (the residual
                # stays what is genuinely unattributed). Deeper spans
                # (hedged replica computes) may overlap and are never
                # auto-closed.
                for prev in self._spans[1:-1]:
                    if prev.parent == 0 and prev.end is None:
                        prev.end = sp.start
            return sp

    def end(self, span, **extra) -> None:
        """Close a span by name (the common sequential stages) or by
        the Span object ``start`` returned (concurrent same-named
        spans, e.g. hedged computes). Unknown name / already-ended =
        no-op: enders must never throw into the serving path."""
        now = time.perf_counter()
        with self._lock:
            sp = (self._by_name.get(span) if isinstance(span, str)
                  else span)
            if sp is None or sp.end is not None:
                return
            sp.end = now
            if extra:
                sp.extra.update(extra)

    def mark(self, name: str, parent: str = ROOT, **extra) -> None:
        """Zero-length marker span (hedge fired/won, redispatch):
        a point event that still rides the span tree."""
        with self._lock:
            psp = self._by_name.get(parent)
            sp = self._open(name, psp.span_id if psp else 0, extra)
            sp.end = sp.start

    def finish(self, **extra) -> List[Span]:
        """End the root (merging ``extra`` — status, row count,
        deadline facts), close the tree and return its spans.

        Still-open children are force-ended at the root's end rather
        than dropped: a request that blew its deadline mid-queue keeps
        its ``queue_wait`` span to the bitter end — that IS the
        attribution. Every child is then clamped into its PARENT's
        (already clamped) interval — creation order guarantees parents
        precede children — so the schema's containment rule holds
        exactly; a hedged loser's ``replica_compute`` that outlives
        the request's dispatch stage is truncated to its overlap with
        it (the tail ran, but no longer on this request's clock). The
        root gains ``unattributed_ms``: root wall minus the sum of its
        direct children — the residual `dpsvm report` prints (never
        silently absorbed into a stage)."""
        now = time.perf_counter()
        with self._lock:
            if self.finished:
                return list(self._spans)
            self.finished = True
            root = self._spans[0]
            root.end = now
            if extra:
                root.extra.update(extra)
            # tenant/model land on the ROOT span (schema v4) on every
            # exit path — 200s and the handler's error back-stop alike
            # — so attribution never depends on how the request died.
            if self.tenant is not None:
                root.extra.setdefault("tenant", self.tenant)
            if self.model is not None:
                root.extra.setdefault("model", self.model)
            child_sum = 0.0
            clamped = {root.span_id: root}
            for sp in self._spans[1:]:
                if sp.end is None:
                    sp.end = now
                    sp.extra.setdefault("cut_at_root_end", True)
                parent = clamped.get(sp.parent, root)
                new_start = min(max(sp.start, parent.start), parent.end)
                new_end = min(max(sp.end, parent.start), parent.end)
                if new_end < sp.end - 1e-9:
                    sp.extra.setdefault("cut_at_parent_end", True)
                sp.start, sp.end = new_start, new_end
                clamped[sp.span_id] = sp
                if sp.parent == root.span_id:
                    child_sum += sp.end - sp.start
            root.extra["unattributed_ms"] = round(
                max(root.end - root.start - child_sum, 0.0) * 1000.0, 3)
            return list(self._spans)

    def breakdown(self) -> Dict[str, float]:
        """{stage name: milliseconds} for the root's direct children
        (+ ``total_ms`` and ``unattributed_ms``) — the per-request
        view the HTTP response returns under ``X-Trace-Spans`` and the
        loadgen knee rows aggregate. Only meaningful after finish()."""
        with self._lock:
            root = self._spans[0]
            if root.end is None:
                return {}
            out: Dict[str, float] = {
                "total_ms": round((root.end - root.start) * 1000.0, 3)}
            for sp in self._spans[1:]:
                if sp.parent == root.span_id and sp.end is not None:
                    out[sp.name] = round(
                        out.get(sp.name, 0.0)
                        + (sp.end - sp.start) * 1000.0, 3)
            ua = root.extra.get("unattributed_ms")
            if ua is not None:
                out["unattributed_ms"] = ua
            return out

    def emit_into(self, trace) -> int:
        """Write every span as a schema span record into ``trace`` (an
        observability/record.RunTrace). Returns records written. The
        caller finishes first; an unfinished tree emits nothing (a
        half-built tree would violate the schema it is supposed to
        satisfy)."""
        if not self.finished:
            return 0
        with self._lock:
            spans = list(self._spans)
        for sp in spans:
            trace.span(trace_id=self.trace_id, span_id=sp.span_id,
                       parent=sp.parent, name=sp.name,
                       t_start=sp.start, t_end=sp.end, **sp.extra)
        return len(spans)


def should_sample(index: int, rate: float) -> bool:
    """Deterministic stride sampling: request ``index`` (0-based
    admission counter) is sampled iff the cumulative quota
    ``floor((i+1)*rate)`` advances at it. rate=1 samples everything,
    rate=0 nothing, rate=0.25 every 4th — evenly spread with no RNG,
    so tests and replays see the same picks."""
    r = min(max(float(rate), 0.0), 1.0)
    if r <= 0.0:
        return False
    return int((index + 1) * r) > int(index * r)
