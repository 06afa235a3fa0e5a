"""Divergence guards: solver-state health checks at the poll boundary
(port of ``dpsvm_tpu/resilience/health.py``; the training driver runs a
``HealthMonitor`` a run, the serving pool a ``ReplicaMonitor`` a
replica).

Every signal the monitor reads — n_iter, b_lo, b_hi, SV count — already
rides the solvers' packed-stats transfer (solver/driver.py "Poll
economics"), so monitoring costs ZERO extra device->host traffic; the
"adaptive shrinking" line of work (arXiv:1406.5161) motivates treating
solver-state health as a first-class monitored signal rather than
letting a sick run burn its whole iteration budget.

Detections:

* **non-finite gap** — a NaN/inf b_lo or b_hi. Without the guard a NaN
  gap is WORSE than a hang: every float comparison with NaN is False,
  so the driver's ``not (b_lo > b_hi + 2 eps)`` reads as *converged*
  and the run returns garbage marked success;
* **gap stagnation** — no strict improvement of the best-seen gap for
  ``health_window`` iterations (convergence is non-monotone per-chunk,
  so the window should span many chunks);
* **SV-count collapse** — the support set shrinking to under 1/8 of
  its peak (peak >= 64) while the gap is still open: alpha mass
  draining to zero mid-run is a classic symptom of corrupted state.

The non-finite guard is always armed — a NaN gap is never legitimate
(and without it the run would *return converged* — see the driver's
finite-aware verdict). Stagnation and collapse are trajectory-shape
HEURISTICS: they arm only when ``health_window > 0`` (explicit
opt-in), because a heuristic wired to the default ``raise`` policy
must not be able to kill a legitimate run (e.g. the nu/one-class
wrappers seed alpha densely and legitimately shed SVs).

Policy (``SVMConfig.on_divergence``): ``"raise"`` fails fast with
``DivergenceError``; ``"rollback"`` has the driver restore the newest
intact checkpoint and continue with a halved ``chunk_iters`` (bounded
by MAX_ROLLBACKS — a deterministic divergence would otherwise loop
forever); ``"ignore"`` records a trace event and keeps going.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Optional

POLICIES = ("raise", "rollback", "ignore")

#: Rollbacks allowed per run before the monitor escalates to raise.
MAX_ROLLBACKS = 3

#: Collapse = n_sv * COLLAPSE_FACTOR < peak, once peak >= COLLAPSE_MIN_PEAK.
COLLAPSE_FACTOR = 8
COLLAPSE_MIN_PEAK = 64


class DivergenceError(RuntimeError):
    """The HealthMonitor detected an unhealthy run and the policy says
    fail fast (or rollback options were exhausted/unavailable)."""

    def __init__(self, reason: str, n_iter: int):
        self.reason = reason
        self.n_iter = int(n_iter)
        super().__init__(
            f"training diverged at iteration {n_iter}: {reason}")


class DesyncError(DivergenceError):
    """Cross-shard desync (resilience/elastic.py): shards disagree on
    replicated-by-construction poll state. Subclasses DivergenceError
    because it rides the same ``on_divergence`` policy — callers that
    catch divergence handle desync too, and ones that care WHICH guard
    tripped can still tell."""


class HealthMonitor:
    """Per-run divergence detector, fed one ChunkStats-shaped poll at a
    time by host_training_loop. check() returns a reason string on the
    first detection of each kind (None = healthy)."""

    def __init__(self, policy: str = "raise", window: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"on_divergence must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.policy = policy
        self.window = int(window)
        self.rollbacks = 0
        self._best_gap = math.inf
        self._best_iter: Optional[int] = None
        self._peak_sv = 0
        self._reported: set = set()

    @property
    def exhausted(self) -> bool:
        return self.rollbacks >= MAX_ROLLBACKS

    def note_rollback(self, n_iter: int) -> None:
        """Reset progress tracking after the driver restored a
        checkpoint — the rolled-back trajectory re-earns its window."""
        self.rollbacks += 1
        self._best_gap = math.inf
        self._best_iter = int(n_iter)
        self._peak_sv = 0
        self._reported.clear()

    def _once(self, key: str, reason: str) -> Optional[str]:
        if key in self._reported:
            return None
        self._reported.add(key)
        return reason

    def check(self, *, n_iter: int, b_lo: float, b_hi: float,
              n_sv: int = 0) -> Optional[str]:
        if not (math.isfinite(b_lo) and math.isfinite(b_hi)):
            return self._once(
                "nonfinite",
                f"non-finite optimality gap (b_lo={b_lo}, b_hi={b_hi})")
        if not self.window:         # heuristic guards are opt-in
            return None
        gap = b_lo - b_hi
        self._peak_sv = max(self._peak_sv, int(n_sv))
        if (self._peak_sv >= COLLAPSE_MIN_PEAK
                and int(n_sv) * COLLAPSE_FACTOR < self._peak_sv):
            return self._once(
                "collapse",
                f"SV count collapsed to {n_sv} from a peak of "
                f"{self._peak_sv} with the gap still open ({gap:.4g})")
        if self._best_iter is None:
            self._best_iter = int(n_iter)
        if gap < self._best_gap - 1e-12:
            self._best_gap = gap
            self._best_iter = int(n_iter)
        elif int(n_iter) - self._best_iter >= self.window:
            return self._once(
                "stagnation",
                f"gap stagnant at {self._best_gap:.6g} for "
                f"{int(n_iter) - self._best_iter} iterations "
                f"(window {self.window})")
        return None


class ReplicaMonitor:
    """Serving-side health: the HealthMonitor's window shape applied
    to a prediction replica's two observable vitals (serving/pool.py).

    * **non-finite outputs** — like the training-side NaN-gap guard,
      always armed and never legitimate: the HTTP layer rejects
      non-finite *inputs* at admission and model parameters are
      finite, so a NaN/inf decision value means corrupted replica
      state (a poisoned device buffer). One occurrence is grounds for
      ejection.
    * **latency** — a rolling window of per-dispatch wall times. A
      dispatch that blows the pool deadline while *running* on the
      replica marks it wedged (the pool decides that; the monitor
      records it). The window also feeds the p99-based hedge delay
      (serving/budget.hedge_delay_s).

    Thread-safe: workers record, the reaper and /metricsz read."""

    def __init__(self, window: int = 256):
        self._lat_ms: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()
        self._dispatches = 0
        self._nonfinite = 0
        self._timeouts = 0

    def note_latency(self, ms: float) -> None:
        with self._lock:
            self._dispatches += 1
            self._lat_ms.append(float(ms))

    def note_nonfinite(self) -> None:
        """One compute returned non-finite values — never legitimate
        (see class docstring); the pool ejects on the first report."""
        with self._lock:
            self._nonfinite += 1

    def note_timeout(self) -> None:
        with self._lock:
            self._timeouts += 1

    @property
    def nonfinite(self) -> int:
        with self._lock:
            return self._nonfinite

    def latencies_ms(self) -> "list[float]":
        with self._lock:
            return list(self._lat_ms)

    def stats(self) -> dict:
        with self._lock:
            lat = list(self._lat_ms)
            out = {"dispatches": self._dispatches,
                   "nonfinite": self._nonfinite,
                   "timeouts": self._timeouts}
        if lat:
            s = sorted(lat)
            out["p50_ms"] = round(s[len(s) // 2], 3)
            out["p99_ms"] = round(s[min(len(s) - 1,
                                        int(len(s) * 0.99))], 3)
        return out
