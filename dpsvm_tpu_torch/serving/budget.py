"""Per-request deadline budgets, hedging delays, and the overload
degradation ladder (port of ``dpsvm_tpu/serving/budget.py``, a copy).

Three small policies the resilient serving layer shares
(docs/SERVING.md "Resilience"):

* **Budget** — one absolute deadline per request, fixed at admission
  and carried through queue -> batch -> device dispatch, so every
  stage bounds its wait by what is *left*, not by a fresh full
  timeout (the classic failure where three 30 s stages turn a 30 s
  SLO into 90 s). A blown budget surfaces as
  ``DeadlineExceededError`` — a ``TimeoutError`` subclass the HTTP
  layer maps to **504**, never the 400 family (a timeout is the
  server's fault, not the client's).
* **hedge_delay_s** — when to fire a duplicate dispatch at a second
  replica: the p99 of the recent latency window times a small
  multiplier (clamped). Hedging at p99 bounds the work overhead at
  ~1% duplicated requests while converting tail stalls into a second
  chance ("The Tail at Scale" rule of thumb).
* **DegradeController** — tiered load shedding keyed on queue fill,
  so overload is a slope instead of a cliff: first drop the optional
  expensive output (``proba`` -> ``decision``), then shed whole
  requests to a registered cheaper sibling model (the ``approx/``
  path exists exactly to make that sibling affordable), and only
  past that reject with 429.

Stdlib + numpy only: importable anywhere the batcher is.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np


class DeadlineExceededError(TimeoutError):
    """The request's deadline budget ran out. HTTP layer: 504 +
    Retry-After (NOT a 400 — the client did nothing wrong)."""


class Budget:
    """One request's deadline, fixed at admission.

    All times are ``time.perf_counter`` based; ``deadline`` is
    absolute so it can be handed across threads (ticket -> batcher
    worker -> pool dispatch) without re-anchoring."""

    __slots__ = ("t0", "deadline", "total_s", "tenant")

    def __init__(self, total_s: float,
                 t0: Optional[float] = None,
                 tenant: Optional[str] = None):
        if not (total_s > 0):
            raise ValueError(f"budget must be > 0 s, got {total_s}")
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self.total_s = float(total_s)
        self.deadline = self.t0 + self.total_s
        # Who this deadline is spent for (docs/OBSERVABILITY.md
        # "Per-tenant attribution"): carried with the deadline across
        # threads so the 504 accounting downstream of the ticket wait
        # can bill the right tenant without re-deriving identity.
        self.tenant = tenant

    def remaining(self) -> float:
        """Seconds left (>= 0)."""
        return max(0.0, self.deadline - time.perf_counter())

    def expired(self) -> bool:
        return time.perf_counter() >= self.deadline

    def check(self, where: str = "") -> None:
        if self.expired():
            raise DeadlineExceededError(
                f"deadline budget ({self.total_s:.3g}s) exhausted"
                + (f" at {where}" if where else ""))

    def spent(self) -> float:
        """Seconds consumed since admission."""
        return time.perf_counter() - self.t0

    def describe(self) -> dict:
        """Deadline accounting for the request's root span
        (docs/OBSERVABILITY.md "Spans"): how big the budget was and
        how much was left when described — a 504's root span says not
        just THAT the budget blew but how deep in it the request
        died."""
        out = {"deadline_ms": round(self.total_s * 1000.0, 3),
               "deadline_remaining_ms": round(
                   self.remaining() * 1000.0, 3)}
        if self.tenant is not None:
            out["tenant"] = self.tenant
        return out

    def __repr__(self) -> str:
        return (f"Budget(total={self.total_s:.3g}s, "
                f"remaining={self.remaining():.3g}s)")


#: hedge clamp bounds (seconds) — below the floor a hedge races the
#: primary on noise; above the cap a "hedge" is just a retry.
HEDGE_MIN_S = 0.002
HEDGE_MAX_S = 2.0
HEDGE_MIN_SAMPLES = 16


def hedge_delay_s(lat_ms: Sequence[float], *,
                  multiplier: float = 1.1,
                  min_s: float = HEDGE_MIN_S,
                  max_s: float = HEDGE_MAX_S,
                  min_samples: int = HEDGE_MIN_SAMPLES) -> float:
    """The p99-based hedge delay: fire the duplicate only when the
    primary has taken longer than (nearly) every recent request.
    With a cold window (fewer than ``min_samples`` observations) the
    delay is the conservative cap — hedging arms itself only once
    the latency distribution is actually known."""
    lat = np.asarray(list(lat_ms), np.float64)
    if lat.size < min_samples:
        return float(max_s)
    p99 = float(np.percentile(lat, 99.0)) / 1000.0
    return float(min(max(p99 * multiplier, min_s), max_s))


#: Degradation tiers, mildest first. ``tier >= 1`` sheds ``proba``;
#: ``tier >= 2`` sheds whole requests to the sibling model;
#: tier 3 is the queue-full 429 the batcher already enforces.
TIER_NONE = 0
TIER_SHED_PROBA = 1
TIER_SHED_SIBLING = 2
TIER_NAMES = {TIER_NONE: "none", TIER_SHED_PROBA: "shed_proba",
              TIER_SHED_SIBLING: "shed_sibling"}


class DegradeController:
    """Maps queue fill to a degradation tier and tracks activations.

    ``tier_for(depth, cap)`` is pure; ``note(tier)`` records the
    transition and returns True exactly when the tier ESCALATED —
    the moment worth a ``shed`` trace event (per-request counting
    would spam the trace under sustained overload)."""

    def __init__(self, *, enabled: bool = True,
                 shed_proba_fill: float = 0.5,
                 shed_sibling_fill: float = 0.8):
        if not (0.0 < shed_proba_fill <= shed_sibling_fill <= 1.0):
            raise ValueError(
                "need 0 < shed_proba_fill <= shed_sibling_fill <= 1, "
                f"got {shed_proba_fill} / {shed_sibling_fill}")
        self.enabled = bool(enabled)
        self.shed_proba_fill = float(shed_proba_fill)
        self.shed_sibling_fill = float(shed_sibling_fill)
        self._tier = TIER_NONE
        self._activations = {TIER_SHED_PROBA: 0, TIER_SHED_SIBLING: 0}
        self._lock = threading.Lock()

    def tier_for(self, queue_depth: int, max_queue: int) -> int:
        if not self.enabled or max_queue <= 0:
            return TIER_NONE
        fill = queue_depth / max_queue
        if fill >= self.shed_sibling_fill:
            return TIER_SHED_SIBLING
        if fill >= self.shed_proba_fill:
            return TIER_SHED_PROBA
        return TIER_NONE

    def note(self, tier: int) -> bool:
        """Record the current tier; True on escalation (emit `shed`)."""
        with self._lock:
            escalated = tier > self._tier
            if escalated and tier in self._activations:
                self._activations[tier] += 1
            self._tier = tier
            return escalated

    @property
    def tier(self) -> int:
        with self._lock:
            return self._tier

    def stats(self) -> dict:
        with self._lock:
            return {
                "tier": self._tier,
                "tier_name": TIER_NAMES.get(self._tier, "?"),
                "activations": {TIER_NAMES[k]: v for k, v in
                                self._activations.items()},
            }
