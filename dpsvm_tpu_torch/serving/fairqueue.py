"""Per-tenant weighted-fair admission queue: deficit round-robin (port of
``dpsvm_tpu/serving/fairqueue.py``).

The micro-batcher's single FIFO is fair only when tenants behave: one
hot tenant that fires faster than the service rate fills the queue and
every other tenant's requests age behind its backlog — exactly the
noisy-neighbour shape the ``tenant-fair-share`` watchtower rule exists
to catch (observability/slo.py). This module puts a scheduling
decision, not just a detector, in front of the batcher: requests are
queued per tenant LANE and served in deficit-round-robin (DRR) order
(Shreedhar & Varghese '95), so the service RATIO between backlogged
lanes follows their configured weights regardless of arrival ratio.

Semantics (docs/SERVING.md "Front door"):

* One lane per RESOLVED tenant label — the same vocabulary the cost
  ledger bills (``metrics.TenantLabelBudget``): the long tail folds
  into the ``other`` lane, so lane cardinality is bounded by the
  tenant budget and an attacker minting labels shares ONE lane.
* The service unit is ROWS (a 64-row request costs 64× a 1-row one —
  weighting requests would let a tenant cheat with huge batches).
* Each backlogged lane in turn earns ``quantum * weight`` rows of
  deficit and dequeues whole requests while its deficit covers them;
  leftover deficit carries to its next turn, so a lane whose requests
  exceed one quantum still gets its share over multiple rounds. An
  emptied lane forfeits its deficit (classic DRR — credit never
  accumulates while idle).
* Admission is bounded PER LANE (``lane_capacity`` rows): a hot
  tenant's overflow rejects the hot tenant (HTTP 429), never a cold
  one — per-tenant backpressure instead of the shared-FIFO cliff.

Starvation-freedom falls out of the round-robin: a backlogged weight-1
lane is visited once per round, and a round serves at most
``quantum * sum(weights of backlogged lanes)`` rows, so the oldest
request in any lane waits a bounded number of service rows —
``tests/test_frontdoor.py`` pins both properties deterministically.

Stdlib-only and event-loop-friendly: O(1) push, O(lanes) worst-case
pop, no threads of its own. A small lock makes push/pop/stats safe
from any thread (the async front door drives it from the loop; metric
collectors read stats from wherever the scrape lands).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

#: default deficit earned per turn per unit weight, in rows. One
#: batcher-bucket's worth is the natural grain: a lane's turn admits
#: about one coalesced device pass of its traffic.
DEFAULT_QUANTUM_ROWS = 32


class LaneFullError(RuntimeError):
    """Per-tenant admission reject: THIS tenant's lane is at capacity.
    The HTTP layer turns it into 429 for the hot tenant while other
    lanes keep admitting."""


class _Lane:
    __slots__ = ("name", "weight", "deficit", "q", "rows", "pushed",
                 "served", "rejected")

    def __init__(self, name: str, weight: float):
        self.name = name
        self.weight = float(weight)
        self.deficit = 0.0
        self.q: deque = deque()          # (rows, t_push, item)
        self.rows = 0                    # rows currently queued
        self.pushed = 0                  # requests admitted, lifetime
        self.served = 0                  # requests dequeued, lifetime
        self.rejected = 0                # requests refused, lifetime


class FairQueue:
    """Deficit-round-robin queue over tenant lanes (module docstring).

    ``weights`` maps tenant label -> weight (default 1.0 for unlisted
    tenants, including ``other``). Weights must be > 0; they are fixed
    at construction — the serving CLI builds one queue per process from
    ``--tenant-weight`` flags.
    """

    def __init__(self, *, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0,
                 lane_capacity: int = 4096,
                 quantum: int = DEFAULT_QUANTUM_ROWS):
        if lane_capacity < 1:
            raise ValueError(f"lane_capacity must be >= 1, got "
                             f"{lane_capacity}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if not (default_weight > 0):
            raise ValueError(f"default_weight must be > 0, got "
                             f"{default_weight}")
        for k, w in (weights or {}).items():
            if not (float(w) > 0):
                raise ValueError(f"tenant weight must be > 0, got "
                                 f"{k}={w}")
        self.lane_capacity = int(lane_capacity)
        self.quantum = int(quantum)
        self.default_weight = float(default_weight)
        self._weights = {k: float(v) for k, v in (weights or {}).items()}
        self._lanes: Dict[str, _Lane] = {}
        # round-robin order over BACKLOGGED lanes: lanes enter at the
        # tail when they go non-empty and leave when drained
        self._active: deque = deque()
        # the lane (if any) that already earned its quantum for the
        # CURRENT front-of-round turn — a turn earns exactly once, so
        # a lane whose deficit runs dry yields instead of re-earning
        # (re-earning would serve the front lane to exhaustion and
        # void the weight ratio entirely)
        self._earned: Optional[_Lane] = None
        self._rows = 0
        self._lock = threading.Lock()

    # -- admission ----------------------------------------------------

    def weight_of(self, tenant: str) -> float:
        return self._weights.get(tenant, self.default_weight)

    def push(self, tenant: str, item, rows: int) -> None:
        """Admit one request (``rows`` service units) to the tenant's
        lane. Raises ``LaneFullError`` when THIS lane is at capacity —
        a fast per-tenant reject that leaves every other lane
        untouched. A single request larger than the lane capacity is
        refused outright (it could never be admitted)."""
        rows = int(rows)
        if rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        with self._lock:
            lane = self._lanes.get(tenant)
            if lane is None:
                lane = self._lanes[tenant] = _Lane(
                    tenant, self.weight_of(tenant))
            if lane.rows + rows > self.lane_capacity:
                lane.rejected += 1
                raise LaneFullError(
                    f"tenant {tenant!r} queue full ({lane.rows} rows "
                    f"waiting, lane capacity {self.lane_capacity}) — "
                    "retry with backoff")
            was_empty = not lane.q
            lane.q.append((rows, time.perf_counter(), item))
            lane.rows += rows
            lane.pushed += 1
            self._rows += rows
            if was_empty:
                lane.deficit = 0.0       # idle credit never accumulates
                self._active.append(lane)

    # -- service ------------------------------------------------------

    def pop(self):
        """Dequeue the next request in DRR order, or None when empty.
        Returns ``(tenant, item, rows)``."""
        with self._lock:
            while self._active:
                lane = self._active[0]
                if not lane.q:           # drained on a previous pop
                    lane.deficit = 0.0
                    self._active.popleft()
                    self._earned = None
                    continue
                if self._earned is not lane:
                    # lane's turn begins: earn ONE quantum. Earning
                    # again before the turn ends would serve the front
                    # lane to exhaustion regardless of weights.
                    lane.deficit += self.quantum * lane.weight
                    self._earned = lane
                rows = lane.q[0][0]
                if lane.deficit < rows:
                    # deficit exhausted (or an oversized head): turn
                    # over, leftover deficit carries to the next round
                    # — DRR's carryover, no starvation of big requests
                    self._active.rotate(-1)
                    self._earned = None
                    continue
                rows, _t, item = lane.q.popleft()
                lane.deficit -= rows
                lane.rows -= rows
                lane.served += 1
                self._rows -= rows
                if not lane.q:
                    lane.deficit = 0.0
                    self._active.popleft()
                    self._earned = None
                return lane.name, item, rows
            return None

    def drop(self, predicate) -> int:
        """Remove queued items for which ``predicate(item)`` is true
        (cancelled/expired requests); returns rows removed. O(total
        queued) — called on the drain path, not per request."""
        removed = 0
        with self._lock:
            for lane in self._lanes.values():
                if not lane.q:
                    continue
                keep = deque()
                for rows, t, item in lane.q:
                    if predicate(item):
                        lane.rows -= rows
                        self._rows -= rows
                        removed += rows
                    else:
                        keep.append((rows, t, item))
                lane.q = keep
                if not keep and lane in self._active:
                    lane.deficit = 0.0
                    self._active.remove(lane)
                    if self._earned is lane:
                        self._earned = None
        return removed

    # -- facts --------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return self._rows

    @property
    def rows_queued(self) -> int:
        with self._lock:
            return self._rows

    def oldest_age_s(self, tenant: Optional[str] = None) -> float:
        """Age (seconds) of the oldest queued request — in one lane, or
        across all lanes. 0.0 when empty. The starvation-freedom bound
        the tests pin is over this number."""
        now = time.perf_counter()
        with self._lock:
            lanes = ([self._lanes[tenant]]
                     if tenant is not None and tenant in self._lanes
                     else self._lanes.values())
            heads = [lane.q[0][1] for lane in lanes if lane.q]
        return (now - min(heads)) if heads else 0.0

    def depths(self) -> Dict[str, int]:
        """rows queued per lane (only lanes that ever admitted) — the
        /metricsz queue-lane gauges and the doctor report."""
        with self._lock:
            return {name: lane.rows
                    for name, lane in sorted(self._lanes.items())}

    def stats(self) -> dict:
        with self._lock:
            return {
                "rows_queued": self._rows,
                "quantum_rows": self.quantum,
                "lane_capacity_rows": self.lane_capacity,
                "lanes": {
                    name: {"weight": lane.weight, "rows": lane.rows,
                           "depth": len(lane.q),
                           "pushed": lane.pushed,
                           "served": lane.served,
                           "rejected": lane.rejected}
                    for name, lane in sorted(self._lanes.items())},
            }


def parse_tenant_weights(specs) -> Dict[str, float]:
    """``--tenant-weight NAME=W`` flag values -> {name: weight}.
    Raises ValueError with a usable message on malformed specs."""
    out: Dict[str, float] = {}
    for spec in specs or ():
        name, sep, w = str(spec).partition("=")
        if not sep or not name:
            raise ValueError(f"--tenant-weight needs NAME=WEIGHT, got "
                             f"{spec!r}")
        try:
            weight = float(w)
        except ValueError:
            raise ValueError(f"--tenant-weight {name}: weight must be "
                             f"a number, got {w!r}")
        if not (weight > 0):
            raise ValueError(f"--tenant-weight {name}: weight must be "
                             f"> 0, got {weight}")
        out[name] = weight
    return out


def drr_schedule(pushes: List[Tuple[str, int]],
                 weights: Dict[str, float],
                 quantum: int = DEFAULT_QUANTUM_ROWS
                 ) -> List[Tuple[str, int]]:
    """The deterministic service order of a STAGED queue: push every
    ``(tenant, rows)`` first, then pop to exhaustion. Pure function of
    its inputs — what the property tests (and the selfcheck's
    fair-queue gate) assert the 8:1 ratio on."""
    fq = FairQueue(weights=weights, quantum=quantum,
                   lane_capacity=1 << 30)
    for i, (tenant, rows) in enumerate(pushes):
        fq.push(tenant, i, rows)
    order: List[Tuple[str, int]] = []
    while True:
        got = fq.pop()
        if got is None:
            return order
        order.append((got[0], got[2]))
