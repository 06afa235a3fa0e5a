"""Dynamic micro-batching: many small requests, few big device passes
(port of ``dpsvm_tpu/serving/batcher.py``, a copy).

The amortization argument the training side already made (one big
compiled pass beats many launches — "Recipe for Fast Large-scale SVM
Training", arXiv:2207.01016) applies unchanged to inference: a single
``(64, d) @ (d, n_sv)`` pass costs barely more than a ``(1, d)`` one,
so concurrent single-row requests should ride the same device pass.

One worker thread owns the engine. Requests enqueue; the worker takes
the oldest request and keeps coalescing until either ``max_batch`` rows
are gathered or ``max_delay_ms`` has passed since the batch opened —
the classic size-or-deadline rule, so an idle server adds at most
``max_delay_ms`` latency and a busy one converges to full buckets.

Admission control is a bounded ROW queue: when ``max_queue`` rows are
already waiting, ``submit`` raises ``QueueFullError`` immediately — a
fast reject the HTTP layer turns into 429, instead of unbounded queue
latency (the failure mode where an overloaded server times every
client out instead of telling any of them to back off).

Correctness does not depend on how traffic happens to coalesce: engine
output rows are independent of their batch-mates (bitwise — see
``engine.py``), so a request answered in a 64-row batch is answered
identically to one served alone. ``tests/test_torch_serving.py`` pins this
by replaying the same requests under forced-coalesced and sequential
scheduling.

Stdlib and numpy only on purpose (no torch import): the module is
importable on a machine with no accelerator, and unit tests can drive it
with a stub engine.
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dpsvm_tpu_torch.serving.budget import DeadlineExceededError

#: outputs the engine's ``infer`` understands; "proba" additionally
#: needs calibration. Lives here (stdlib-only module) so the HTTP
#: layer can validate without importing the device-backed engine.
KNOWN_OUTPUTS = ("labels", "decision", "proba")


class QueueFullError(RuntimeError):
    """Admission reject: the pending-row queue is at capacity. The
    caller should shed load (HTTP 429), not wait."""


class BatcherClosedError(RuntimeError):
    """Submitted after close() — the server is draining."""


class _Ticket:
    """One request's future: wait() blocks until the worker publishes
    this request's slice of the batch result (or its error).

    A ticket may carry an absolute ``deadline`` (perf_counter). A
    waiter that times out marks the ticket ``cancelled``, and the
    worker drops cancelled/expired tickets at batch-formation time
    instead of computing for nobody — the expired work is counted in
    ``stats()["expired"]``, never silently burned.

    ``spans`` (observability/spans.RequestSpans, None when the request
    is unsampled) rides along so the worker can bracket this ticket's
    queue-wait / batch-formation / dispatch stages — the request-scoped
    latency attribution of docs/OBSERVABILITY.md "Spans".

    ``on_done`` (callable taking the ticket, or None) fires from the
    worker thread right after the ticket's result or error is
    published (``event.set()``). It exists for callers that must NOT
    block a thread in ``wait()`` — the asyncio front door passes a
    ``loop.call_soon_threadsafe`` trampoline here and resolves a
    future on the loop instead. The callback must be fast and never
    raise (exceptions are swallowed so they can't kill the worker)."""

    __slots__ = ("rows", "want", "event", "result", "error", "t_submit",
                 "deadline", "cancelled", "spans", "on_done")

    def __init__(self, rows: np.ndarray, want: Tuple[str, ...],
                 deadline: Optional[float] = None, spans=None,
                 on_done=None):
        self.rows = rows
        self.want = want
        self.event = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.deadline = deadline
        self.cancelled = False
        self.spans = spans
        self.on_done = on_done

    def wait(self, timeout: Optional[float] = None) -> dict:
        """Block for the result. The wait is bounded by BOTH the given
        timeout and the ticket's own deadline; on expiry the ticket is
        cancelled (so the worker won't compute it) and
        ``DeadlineExceededError`` — a TimeoutError — is raised (the
        HTTP layer maps it to 504, never a 400)."""
        if self.deadline is not None:
            rem = self.deadline - time.perf_counter()
            timeout = rem if timeout is None else min(timeout, rem)
        if timeout is not None and timeout <= 0:
            self.cancelled = True
            raise DeadlineExceededError(
                "deadline exhausted before the prediction completed")
        if not self.event.wait(timeout):
            # Mark first, then re-check: the worker may have published
            # between the wait timing out and the cancel landing.
            self.cancelled = True
            if not self.event.is_set():
                raise DeadlineExceededError(
                    "prediction did not complete in time")
        # The dispatch stage is NOT ended here: the next stage the
        # caller opens (`respond`) auto-closes it at that exact
        # instant (observability/spans.RequestSpans.start), so the
        # thread-wakeup latency between the worker's publish and the
        # caller resuming is attributed to the dispatch with no gap —
        # and a caller that never gets that far (blown deadline) has
        # it cut at the root end by finish(), which IS the attribution.
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Size-or-deadline request coalescing in front of an engine.

    ``infer_fn(x, want)`` is the engine call (resolved per batch, so a
    registry hot-reload takes effect without rebuilding the batcher).
    ``start=False`` leaves the worker unstarted — tests use it to stage
    a deterministic queue, then ``start()`` to coalesce it in one batch.
    """

    def __init__(self, infer_fn: Callable[[np.ndarray, Tuple[str, ...]],
                                          dict],
                 *, max_batch: int = 256, max_delay_ms: float = 2.0,
                 max_queue: int = 4096, start: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._infer = infer_fn
        # Deadline-aware engines (the replica pool) take the batch's
        # deadline as a keyword; plain engines keep the 2-arg shape.
        # Same opt-in for span contexts: a `spans` keyword means the
        # engine (the pool) records its own sub-spans per request.
        try:
            params = inspect.signature(infer_fn).parameters
            self._pass_deadline = "deadline" in params
            self._pass_spans = "spans" in params
        except (TypeError, ValueError):
            self._pass_deadline = False
            self._pass_spans = False
        self.max_batch = int(max_batch)
        self.max_delay_s = max(float(max_delay_ms), 0.0) / 1000.0
        self.max_queue = int(max_queue)
        self._q: deque = deque()
        self._rows_queued = 0
        self._cond = threading.Condition()
        self._closing = False
        self._drain = True
        self._worker: Optional[threading.Thread] = None
        # batch-size histogram: coalesced rows per engine call
        self._batch_rows: Dict[int, int] = {}
        self._n_batches = 0
        self._n_requests = 0
        self._n_rejected = 0
        self._n_expired = 0
        if start:
            self.start()

    # -- client side --------------------------------------------------

    def submit(self, rows, want: Sequence[str] = ("labels",),
               deadline: Optional[float] = None, spans=None,
               on_done=None) -> _Ticket:
        """Enqueue one request (rows: (k, d) float32). Returns a ticket
        to ``wait()`` on. Raises ``QueueFullError`` (fast, no blocking)
        at capacity, ``BatcherClosedError`` while draining.
        ``deadline`` (absolute perf_counter) bounds the whole journey:
        an expired ticket is dropped at batch formation, not computed.
        ``spans`` (RequestSpans or None) opens its ``queue_wait`` the
        moment the ticket is accepted — rejects never count as queue
        time. ``on_done`` (see ``_Ticket``) is attached ATOMICALLY at
        submit so there is no window where the worker publishes before
        the callback exists."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        n = int(rows.shape[0])
        if n == 0:
            raise ValueError("empty request")
        t = _Ticket(rows, tuple(want), deadline, spans=spans,
                    on_done=on_done)
        with self._cond:
            if self._closing:
                raise BatcherClosedError("server is draining")
            if self._rows_queued + n > self.max_queue:
                self._n_rejected += 1
                raise QueueFullError(
                    f"queue full ({self._rows_queued} rows waiting, "
                    f"max {self.max_queue}) — retry with backoff")
            if spans is not None:
                spans.start("queue_wait")
            self._q.append(t)
            self._rows_queued += n
            self._n_requests += 1
            self._cond.notify()
        return t

    def infer(self, rows, want: Sequence[str] = ("labels",),
              timeout: Optional[float] = 60.0) -> dict:
        """submit + wait — the HTTP handler's one call."""
        return self.submit(rows, want).wait(timeout)

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        if self._worker is not None:
            return
        self._worker = threading.Thread(target=self._run,
                                        name="dpsvm-batcher",
                                        daemon=True)
        self._worker.start()

    def close(self, drain: bool = True,
              timeout: Optional[float] = 30.0) -> None:
        """Stop accepting; with ``drain`` the worker finishes every
        queued request first (the SIGTERM graceful-drain semantics),
        otherwise pending tickets fail with BatcherClosedError."""
        with self._cond:
            self._closing = True
            self._drain = drain
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)

    # -- stats --------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return self._rows_queued

    def stats(self) -> dict:
        with self._cond:
            return {
                "requests": self._n_requests,
                "rejected": self._n_rejected,
                "expired": self._n_expired,
                "batches": self._n_batches,
                "queue_depth_rows": self._rows_queued,
                "batch_rows_histogram": {str(k): v for k, v in
                                         sorted(self._batch_rows.items())},
            }

    # -- worker -------------------------------------------------------

    @staticmethod
    def _notify(t: _Ticket) -> None:
        """Fire the ticket's ``on_done`` (if any) after its terminal
        publish. Runs on the worker thread; callback errors are
        swallowed — a broken callback must not take the batcher (and
        every other tenant's requests) down with it."""
        cb = t.on_done
        if cb is not None:
            try:
                cb(t)
            except Exception:
                pass

    @staticmethod
    def _note_batched(t: _Ticket) -> None:
        """Span bookkeeping at batch admission: the ticket stops
        waiting in the queue and starts riding an open batch
        (batch_form's start auto-closes queue_wait at the same
        timestamp — stage transitions are gap-free by construction)."""
        if t.spans is not None:
            t.spans.start("batch_form")

    def _prune_head(self) -> None:
        """Drop dead tickets from the queue head (holding the lock).
        Cancelled tickets (their waiter already gave up) and
        deadline-expired ones are dropped here — at batch-formation
        time — instead of being computed for nobody; an expired
        ticket's waiter (if any is still blocked on a caller-supplied
        timeout) is woken with DeadlineExceededError. Both count as
        ``expired`` in stats()."""
        now = time.perf_counter()
        while self._q:
            t = self._q[0]
            expired = (t.deadline is not None and t.deadline <= now)
            if not (t.cancelled or expired):
                return
            self._q.popleft()
            self._rows_queued -= int(t.rows.shape[0])
            self._n_expired += 1
            if not t.cancelled:
                t.error = DeadlineExceededError(
                    "deadline passed while queued")
                t.event.set()
            # on_done fires for cancelled tickets too: the async front
            # door accounts inflight rows at submit and only releases
            # them in on_done, so a silent drop here would leak them
            # until the dispatcher wedges at _inflight_limit.
            self._notify(t)

    def _take_batch(self) -> Optional[List[_Ticket]]:
        """Block for the first request, then coalesce until max_batch
        rows or the deadline. None = closed and (drained or no-drain).
        May return an empty list when every queued ticket had already
        expired — the worker just takes the next batch."""
        with self._cond:
            while True:
                self._prune_head()
                if self._q:
                    break
                if self._closing:
                    return None
                self._cond.wait()
            if self._closing and not self._drain:
                return None
            first = self._q.popleft()
            self._rows_queued -= int(first.rows.shape[0])
            self._note_batched(first)
            batch = [first]
            rows = int(first.rows.shape[0])
            deadline = time.perf_counter() + self.max_delay_s
            while rows < self.max_batch:
                self._prune_head()
                if self._q:
                    nxt = int(self._q[0].rows.shape[0])
                    if rows + nxt > self.max_batch:
                        break
                    t = self._q.popleft()
                    self._rows_queued -= nxt
                    self._note_batched(t)
                    batch.append(t)
                    rows += nxt
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._closing:
                    break
                self._cond.wait(remaining)
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                if not self._drain:
                    with self._cond:
                        leftovers = list(self._q)
                        self._q.clear()
                        self._rows_queued = 0
                    for t in leftovers:
                        t.error = BatcherClosedError("server shut down")
                        t.event.set()
                        self._notify(t)
                return
            if not batch:                  # all queued tickets expired
                continue
            x = (batch[0].rows if len(batch) == 1
                 else np.concatenate([t.rows for t in batch]))
            want = tuple(dict.fromkeys(w for t in batch for w in t.want))
            with self._cond:
                self._n_batches += 1
                self._batch_rows[int(x.shape[0])] = \
                    self._batch_rows.get(int(x.shape[0]), 0) + 1
            span_ctxs = []
            for t in batch:
                if t.spans is not None:
                    # auto-closes batch_form at the same instant
                    t.spans.start("device_dispatch",
                                  batch_rows=int(x.shape[0]))
                    span_ctxs.append(t.spans)
            try:
                kw = {}
                if self._pass_deadline:
                    # the batch stays interesting until its LAST
                    # member's deadline (earlier members 504 on their
                    # own wait; later ones still want the result)
                    ds = [t.deadline for t in batch]
                    kw["deadline"] = (None if any(d is None for d in ds)
                                      else max(ds))
                if self._pass_spans and span_ctxs:
                    kw["spans"] = span_ctxs
                res = (self._infer(x, want, **kw) if kw
                       else self._infer(x, want))
            except BaseException as e:     # noqa: BLE001 — published to
                for t in batch:            # every waiting ticket
                    if t.spans is not None:
                        t.spans.end("device_dispatch",
                                    error=type(e).__name__)
                    t.error = e
                    t.event.set()
                    self._notify(t)
                continue
            lo = 0
            for t in batch:
                hi = lo + int(t.rows.shape[0])
                t.result = {k: v[lo:hi] for k, v in res.items()
                            if k in t.want}
                # device_dispatch is ended by the waiter's NEXT stage
                # bracket (auto-close) so wakeup latency stays
                # attributed with no inter-stage gap
                t.event.set()
                self._notify(t)
                lo = hi
