"""Elastic distributed training: the fault model of a world of ranks
(port of ``dpsvm_tpu/resilience/elastic.py``).

In the port a shard is a rank: one process with one device, joined by
``torch.distributed`` (``parallel/``). The pieces:

* **shard probes**: every rank's own view of the replicated poll scalars
  (n_iter, b_lo bits, b_hi bits) rides the poll's one packed-stats read
  (``parallel.mesh.shard_probe``; ``ChunkStats.probe`` on the host, one
  row a rank). Ranks at the same iteration whose gap bits differ are a
  desynchronized mesh: ``DesyncDetector`` reports it once, and the driver
  writes a ``desync`` event and applies ``on_divergence`` (raise ->
  ``DesyncError``; rollback -> the newest intact checkpoint);
* **shard heartbeats**: host-side per-rank freshness from the probes. A
  rank whose reported n_iter stops advancing while the others move ages;
  the ages ride every chunk record (``shard_ages``) and the stall
  watchdog's verdict (``stall_extras``);
* **shard loss and the degraded-mesh resume**: ``ShardLostError`` is the
  transient "a rank died" signal (``DPSVM_FAULT_DIST_KILL_SHARD``), which
  every rank raises at the same poll because they all read the same
  replicated stats. ``run_elastic`` runs in the process that starts the
  ranks: it catches the loss, shrinks the world to the survivors and
  starts a new world from the newest intact checkpoint, whose state is the
  global (alpha, f) that any world size re-slices (``reshard`` and
  ``retry`` events on the resumed trace).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

#: Probe lanes a rank: [n_iter, b_lo bits, b_hi bits] as int32.
PROBE_WIDTH = 3


class ShardLostError(RuntimeError):
    """A rank of the world was lost mid-run. Transient: the run resumes on
    the surviving ranks from the newest intact checkpoint
    (``run_elastic``)."""

    def __init__(self, shard: int, shards: int, n_iter: int):
        self.shard = int(shard)          # 0-based lost shard
        self.shards = int(shards)        # world size at the loss
        self.n_iter = int(n_iter)
        super().__init__(
            f"shard {shard}/{shards} lost at iteration {n_iter}; "
            f"resume on the surviving mesh from the newest intact "
            f"checkpoint (run_elastic / train --retries)")

    def __reduce__(self):
        # the ranks report their errors to the launcher by pickle
        return (ShardLostError, (self.shard, self.shards, self.n_iter))


def _rows(probes) -> np.ndarray:
    return np.asarray(probes, np.int32).reshape(-1, PROBE_WIDTH)


def probe_values(probes) -> List[dict]:
    """A (P, 3) int32 probe block as per-rank host values."""
    out = []
    for row in _rows(probes):
        b = row[1:3].view(np.float32)
        out.append({"n_iter": int(row[0]), "b_lo": float(b[0]),
                    "b_hi": float(b[1])})
    return out


def desync_reason(probes) -> Optional[str]:
    """The reason ranks disagree on replicated values (None: they agree).
    Bit-level: at one iteration every rank's (b_lo, b_hi) are the same
    bits, so ranks at the same n_iter with different gap bits are out of
    step, not noisy. Ranks at different iterations are lag (the heartbeat
    ages' signal), never a desync."""
    probes = _rows(probes)
    if len(probes) < 2:
        return None
    lead = int(probes[:, 0].max())
    lead_mask = probes[:, 0] == lead
    ref_idx = int(np.argmax(lead_mask))
    ref = probes[ref_idx]
    bad = [k for k in range(len(probes))
           if lead_mask[k] and not bool((probes[k] == ref).all())]
    if not bad:
        return None
    vals = probe_values(probes)
    return (f"cross-shard desync on replicated poll state at iteration "
            f"{lead}: shard(s) {bad} disagree with shard {ref_idx} "
            f"(shard {ref_idx}: {vals[ref_idx]}; "
            f"shard {bad[0]}: {vals[bad[0]]})")


class DesyncDetector:
    """Reports a desync once an incident; ``reset()`` after a rollback
    re-arms it (the restored state re-earns its trust)."""

    def __init__(self):
        self._reported = False

    def check(self, probes) -> Optional[str]:
        if probes is None or len(probes) == 0 or self._reported:
            return None
        reason = desync_reason(probes)
        if reason is not None:
            self._reported = True
        return reason

    def reset(self) -> None:
        self._reported = False


class ShardHeartbeats:
    """Per-rank freshness from the poll probes: a rank's age is the wall
    time since its reported n_iter last advanced."""

    def __init__(self, shards: int):
        self.shards = int(shards)
        self._last_iter = np.full((self.shards,), -1, np.int64)
        self._last_seen = np.full((self.shards,), time.monotonic())
        self._last_poll = time.monotonic()

    def note_poll(self, probes) -> List[float]:
        """Record one poll's probes; the per-rank ages (seconds, rounded)
        for the chunk record."""
        now = time.monotonic()
        self._last_poll = now
        if probes is not None and len(probes):
            rows = _rows(probes)
            for k in range(min(self.shards, len(rows))):
                if int(rows[k, 0]) > self._last_iter[k]:
                    self._last_iter[k] = int(rows[k, 0])
                    self._last_seen[k] = now
        return [round(now - t, 3) for t in self._last_seen]

    def ages(self) -> List[float]:
        now = time.monotonic()
        return [round(now - t, 3) for t in self._last_seen]

    def poll_age(self) -> float:
        return time.monotonic() - self._last_poll


# The live distributed run's heartbeats, read by the stall watchdog's
# expiry from its own thread.
_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[ShardHeartbeats] = None


def register_heartbeats(hb: Optional[ShardHeartbeats]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = hb


def stall_extras() -> dict:
    """Facts for the watchdog's ``stall`` event: a verdict telling a
    collective hang (every rank exactly as stale as the last poll) from a
    straggler (one rank's progress lags the rest). Empty outside a
    distributed run."""
    with _ACTIVE_LOCK:
        hb = _ACTIVE
    if hb is None:
        return {}
    ages = hb.ages()
    poll_age = round(hb.poll_age(), 3)
    spread = max(ages) - min(ages)
    if spread > max(1.0, 0.5 * poll_age):
        verdict = f"straggler-shard-{int(np.argmax(np.asarray(ages)))}"
    else:
        verdict = "collective-hang"
    return {"dist_verdict": verdict, "shards": hb.shards,
            "shard_ages": ages, "poll_age": poll_age}


def surviving_shards(shards: int, min_shards: int = 1) -> int:
    """World size after losing one rank: P - 1, floored at
    ``min_shards`` (any size works: the checkpoint's state is global)."""
    return max(int(shards) - 1, int(min_shards), 1)


def _transient_cause(e: BaseException):
    """The ``ShardLostError`` / ``PreemptedError`` behind ``e``: itself,
    or the first such error the ranks of a failed local world reported
    (``parallel.multihost.RanksFailedError``)."""
    from dpsvm_tpu_torch.resilience.preempt import PreemptedError
    if isinstance(e, (ShardLostError, PreemptedError)):
        return e
    for cause in getattr(e, "causes", ()):
        if isinstance(cause, ShardLostError):
            return cause
    for cause in getattr(e, "causes", ()):
        if isinstance(cause, PreemptedError):
            return cause
    return None


def run_elastic(fn: Callable[[Optional[str], int, int], object], *,
                shards: int, retries: int,
                checkpoint_path: Optional[str] = None,
                min_shards: int = 1, backoff_s: float = 0.0,
                sleep: Callable[[float], None] = time.sleep):
    """The elastic supervisor: ``fn(resume_from, shards, attempt)`` runs
    the training (typically a world of ``shards`` local ranks through
    ``parallel.multihost.launch_local``). A ``ShardLostError``, raised
    directly or reported by the ranks, shrinks the world to the survivors
    and resumes from the newest intact checkpoint; a ``PreemptedError``
    retries on the same world. A ``retry`` event is queued for the next
    attempt's trace (``launch_local`` hands the queue to its ranks); the
    ``reshard`` event comes from the resumed run's ``resume_state``.
    Anything else fails fast."""
    from dpsvm_tpu_torch.resilience.supervisor import _log, newest_intact
    from dpsvm_tpu_torch.solver import driver

    attempt = 0
    p = int(shards)
    while True:
        resume, skipped = newest_intact(checkpoint_path)
        if skipped and resume:
            _log(f"skipping unreadable checkpoint slot(s) "
                 f"{skipped} -> resuming {resume}")
        try:
            return fn(resume, p, attempt)
        except Exception as e:
            cause = _transient_cause(e)
            if cause is None or attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt)
            attempt += 1
            if isinstance(cause, ShardLostError):
                survivors = surviving_shards(p, min_shards)
                _log(f"shard {cause.shard}/{p} lost at iter "
                     f"{cause.n_iter}; retry {attempt}/{retries} on the "
                     f"surviving {survivors}-shard mesh in {delay:.1f}s")
                p = survivors
            else:
                _log(f"preempted at iter {cause.n_iter}; retry "
                     f"{attempt}/{retries} in {delay:.1f}s")
            driver.queue_trace_event("retry", attempt=attempt,
                                     resumed_from=resume)
            if delay > 0:
                sleep(delay)
