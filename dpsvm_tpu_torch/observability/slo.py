"""Continuous SLO watching: declarative alert rules over live metrics
(port of ``dpsvm_tpu/observability/slo.py``).

Every observability layer before this one (traces, spans, roofline,
metrics, perf ledger) is retrospective — a human runs ``dpsvm report``
or ``compare`` after the fact. This module is the *continuous* half:
a small, deterministic rule engine that watches the metric samples the
system already produces (the ``/metricsz`` surfaces, the
``--metrics-out`` snapshots, a live run trace) and turns degradation
into alert state WHILE it is happening — the layer that converts the
instrumentation from reporter into pager (docs/OBSERVABILITY.md
"Watch & alerts"; "Parallel SVMs in Practice", arxiv 1404.1066, on
deployments living or dying on operational tooling).

Design constraints, in order:

* **Deterministic.** Every rule is a pure function of the
  ``(t, sample)`` series it has observed: callers pass explicit
  timestamps (the ``Watchtower`` clock is injectable and only used
  when a caller omits ``t``), so every firing is replayable in CI —
  no wall-clock reads inside rule evaluation, ever.
* **Dependency-free.** stdlib only (not even numpy): imported by the
  serving layer, the CLI and the training driver, and must never
  force a backend init.
* **Host-side.** A watched training run performs ZERO additional
  device->host transfers: every sample fact already rides the
  packed-stats poll (solver/driver.py "Poll economics"); a watched
  serving process reads its own counters.

Rule kinds (specs are plain dicts — JSON on disk, Python inline):

* ``burn_rate`` — the Google-SRE multi-window burn-rate alert on an
  error-budget SLO: given cumulative ``good``/``bad`` counters, an
  ``objective`` (e.g. 0.999 availability), and two windows, the rule
  fires only when BOTH the fast and the slow window burn the error
  budget at >= ``threshold`` x the sustainable rate — fast-only
  spikes (shorter than the fast window) never page, and a sustained
  burn pages within the fast window. Clears with hysteresis
  (``clear_after_s`` of healthy fast-window burn), so a flapping
  source cannot flap the alert.
* ``threshold`` — ``metric`` above/below a bound for ``for_s``
  seconds (queue-depth saturation, shard-heartbeat age, p99).
* ``rate`` — the per-second rate of a cumulative counter over
  ``window_s`` above a bound (compile storms: steady state retraces
  NOTHING, so a sustained compile rate is always pathological).
* ``stagnation`` — a metric whose best-seen value stops improving for
  ``window_s`` (the training gap beyond the HealthMonitor's window —
  the watch-side twin of resilience/health.py's in-run guard).
* ``drop_vs_baseline`` — ``metric`` below ``baseline * (1 -
  drop_pct/100)`` for ``for_s``; the baseline is a literal number or
  resolved ONCE at ruleset load from the perf-ledger median
  (``baseline_case`` — the roofline_fraction drop rule).
* ``fair_share`` — noisy-tenant detection: one tenant's share of the
  fleet's trailing-window queue-wait above ``share_above`` while at
  least ``min_tenants`` tenants are active. Reads the cumulative
  ``tenant:<name>:queue_wait_ms`` / ``tenant:<name>:compute_ms``
  lanes the serving layer exports (docs/OBSERVABILITY.md "Per-tenant
  attribution") — queue wait is the cost a tenant imposes on its
  NEIGHBOURS, so a dominant queue-wait share is the isolation alarm
  even when the tenant's own latency still looks fine.
* ``skew`` — straggler detection for a multi-host group: the lag
  between the fastest and the slowest host's ``host:<k>:<metric>``
  lane (normally ``n_iter``), MEANED over a full ``window_s`` of
  samples, above ``lag_above``. The mean — not the instantaneous gap
  — because a healthy group shows a transient gap at every collective
  boundary (the fast host publishes first), while a straggler holds
  the gap open across the whole window. The firing names the laggard
  (the host with the lowest mean progress): the reason carries the
  literal ``skew[host-K]`` and the transition/state a ``host`` key,
  so the fleet incident bundle can attribute the stall
  (docs/OBSERVABILITY.md "Fleet").

**Per-tenant templates.** A rule spec carrying ``"per_tenant": true``
is a TEMPLATE, not a rule: the ``Watchtower`` discovers active
tenants from the ``tenant:<name>:<metric>`` keys in each sample and
expands the template into one concrete rule per tenant (named
``template[tenant]``, ``{tenant}`` substituted into metric/counter
names), capped at ``tenant_cap`` expansions so alert cardinality is
bounded exactly like the metric label budget (metrics.py
``TenantLabelBudget``). The ``other`` overflow tenant is never
expanded — its lanes aggregate many tenants, so a firing there could
not name a culprit. Templates round-trip verbatim through
``RuleSet.to_specs()``; expanded rules live only inside the tower,
and their transitions/states carry a ``tenant`` key so incident
bundles can name the tenant (serving/server.py ``_on_alert``).

**Per-host templates.** The same pattern over the fleet sample's
``host:<k>:<metric>`` lanes (observability/fleet.py): a spec carrying
``"per_host": true`` expands into one concrete rule per active host
(named ``template[host-K]``, ``{host}`` substituted), capped at
``host_cap`` — so a 3-host group's heartbeat-stale page watches three
lanes from one template, and a 300-host fleet cannot explode alert
cardinality.

Severities and exit codes (the ``dpsvm watch`` contract): ``warn`` ->
exit 4, ``page`` -> exit 5; no alert -> 0; a stale/unreachable source
-> 3 (matching ``report --follow``'s stall exit). Distinct codes so
cron/CI can gate per severity.
"""

from __future__ import annotations

import json
import math
import re
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

SEVERITIES = ("warn", "page")

#: `dpsvm watch` exit codes, per the worst severity that FIRED during
#: the watch (not merely the final state — a burn that fired and
#: cleared still failed the gate).
EXIT_OK = 0
EXIT_STALE = 3          # source unreachable / stopped updating
EXIT_WARN = 4
EXIT_PAGE = 5

RULE_KINDS = ("burn_rate", "threshold", "rate", "stagnation",
              "drop_vs_baseline", "fair_share", "skew")

#: The overflow pseudo-tenant (mirrors metrics.TENANT_OTHER — pinned
#: equal in tests/test_watch.py so the two stay one vocabulary without
#: this stdlib-only module importing the metrics layer).
TENANT_OTHER = "other"

#: Default cap on per-template tenant fan-out: alert cardinality gets
#: the same bound the metric series get (metrics.DEFAULT_TENANT_BUDGET).
TENANT_FAN_OUT_CAP = 32

#: ``tenant:<name>:<metric>`` — the flattened per-tenant sample lanes
#: (sample_from_metricsz_json / serving watch_sample). The tenant part
#: is greedy so tenant names containing ``:`` still parse (the metric
#: suffix never contains one).
_TENANT_KEY_RE = re.compile(r"^tenant:(?P<tenant>.+):(?P<metric>[^:]+)$")

#: Default cap on per-template host fan-out (the fleet twin of
#: TENANT_FAN_OUT_CAP).
HOST_FAN_OUT_CAP = 32

#: ``host:<k>:<metric>`` — the flattened per-host sample lanes the
#: fleet federation layer builds (observability/fleet.py
#: fleet_watch_sample). Host ids are integers, so the pattern is
#: strict where the tenant one is greedy.
_HOST_KEY_RE = re.compile(r"^host:(?P<host>\d+):(?P<metric>.+)$")


class RuleError(ValueError):
    """A rule spec that cannot be parsed/validated."""


def severity_exit_code(severity: Optional[str]) -> int:
    return {None: EXIT_OK, "warn": EXIT_WARN, "page": EXIT_PAGE}[severity]


def worst_severity(a: Optional[str], b: Optional[str]) -> Optional[str]:
    order = {None: 0, "warn": 1, "page": 2}
    return a if order[a] >= order[b] else b


def _num(spec: dict, key: str, default=None, *, required: bool = False,
         positive: bool = False):
    v = spec.get(key, default)
    if v is None:
        if required:
            raise RuleError(f"rule {spec.get('name')!r}: missing "
                            f"required key {key!r}")
        return None
    try:
        v = float(v)
    except (TypeError, ValueError):
        raise RuleError(f"rule {spec.get('name')!r}: {key} must be a "
                        f"number, got {spec.get(key)!r}")
    if not math.isfinite(v):
        raise RuleError(f"rule {spec.get('name')!r}: {key} must be "
                        f"finite, got {v}")
    if positive and v <= 0:
        raise RuleError(f"rule {spec.get('name')!r}: {key} must be "
                        f"> 0, got {v}")
    return v


class Rule:
    """One alert rule: spec parsing, sample-window state, and the
    shared fire/clear state machine (for_s debounce on the way up,
    clear_after_s hysteresis on the way down — the no-flap contract
    pinned in tests/test_watch.py)."""

    def __init__(self, spec: dict):
        if not isinstance(spec, dict):
            raise RuleError(f"rule spec must be a dict, got {spec!r}")
        self.spec = dict(spec)
        self.name = str(spec.get("name") or "").strip()
        if not self.name:
            raise RuleError(f"rule spec missing 'name': {spec!r}")
        self.kind = spec.get("kind")
        if self.kind not in RULE_KINDS:
            raise RuleError(f"rule {self.name!r}: kind must be one of "
                            f"{RULE_KINDS}, got {self.kind!r}")
        self.severity = spec.get("severity", "warn")
        if self.severity not in SEVERITIES:
            raise RuleError(f"rule {self.name!r}: severity must be one "
                            f"of {SEVERITIES}, got {self.severity!r}")
        self.for_s = _num(spec, "for_s", 0.0) or 0.0
        self.clear_after_s = _num(spec, "clear_after_s", 0.0) or 0.0
        # per-kind parameters (validated eagerly so a bad rules file
        # fails at load, not at the 3 a.m. firing)
        k = self.kind
        self.per_tenant = bool(spec.get("per_tenant"))
        self.tenant = spec.get("tenant")
        if self.tenant is not None:
            self.tenant = str(self.tenant)
        self.per_host = bool(spec.get("per_host"))
        self.host = spec.get("host")
        if self.host is not None:
            try:
                self.host = int(self.host)
            except (TypeError, ValueError):
                raise RuleError(f"rule {self.name!r}: host must be an "
                                f"integer, got {spec.get('host')!r}")
        #: skew only: the laggard host the last evaluation attributed
        self._laggard: Optional[int] = None
        if k == "skew":
            if self.per_host:
                raise RuleError(
                    f"rule {self.name!r}: skew is inherently "
                    "cross-host — it reads every host:<k> lane "
                    "itself; 'per_host' templating would watch one "
                    "host against nobody")
            self.metric = str(spec.get("metric") or "n_iter")
            self.window_s = _num(spec, "window_s", required=True,
                                 positive=True)
            self.lag_above = _num(spec, "lag_above", required=True,
                                  positive=True)
        elif k == "fair_share":
            if not self.per_tenant and not self.tenant:
                raise RuleError(
                    f"rule {self.name!r}: fair_share needs 'tenant' "
                    "(or 'per_tenant': true to template over active "
                    "tenants)")
            self.window_s = _num(spec, "window_s", 60.0,
                                 positive=True)
            share = _num(spec, "share_above", 0.5)
            if not (0.0 < share < 1.0):
                raise RuleError(f"rule {self.name!r}: share_above "
                                f"must be in (0, 1), got {share}")
            self.share_above = share
            mt = _num(spec, "min_tenants", 2.0)
            if mt < 1:
                raise RuleError(f"rule {self.name!r}: min_tenants "
                                f"must be >= 1, got {mt}")
            self.min_tenants = int(mt)
            self.min_queue_wait_ms = _num(spec, "min_queue_wait_ms",
                                          1.0) or 0.0
        elif k == "burn_rate":
            self.good = str(spec.get("good") or "")
            self.bad = str(spec.get("bad") or "")
            if not self.good or not self.bad:
                raise RuleError(f"rule {self.name!r}: burn_rate needs "
                                "'good' and 'bad' counter names")
            obj = _num(spec, "objective", required=True)
            if not (0.0 < obj < 1.0):
                raise RuleError(f"rule {self.name!r}: objective must be "
                                f"in (0, 1), got {obj}")
            self.objective = obj
            self.budget = 1.0 - obj
            self.fast_window_s = _num(spec, "fast_window_s",
                                      required=True, positive=True)
            self.slow_window_s = _num(spec, "slow_window_s",
                                      required=True, positive=True)
            if self.slow_window_s < self.fast_window_s:
                raise RuleError(
                    f"rule {self.name!r}: slow_window_s "
                    f"({self.slow_window_s}) must be >= fast_window_s "
                    f"({self.fast_window_s})")
            self.threshold = _num(spec, "threshold", required=True,
                                  positive=True)
        elif k in ("threshold", "drop_vs_baseline", "rate",
                   "stagnation"):
            self.metric = str(spec.get("metric") or "")
            if not self.metric:
                raise RuleError(f"rule {self.name!r}: {k} needs "
                                "'metric'")
            if k == "threshold":
                self.above = _num(spec, "above")
                self.below = _num(spec, "below")
                if (self.above is None) == (self.below is None):
                    raise RuleError(f"rule {self.name!r}: threshold "
                                    "needs exactly one of 'above' / "
                                    "'below'")
            elif k == "rate":
                self.window_s = _num(spec, "window_s", required=True,
                                     positive=True)
                self.above = _num(spec, "above", required=True)
            elif k == "stagnation":
                self.window_s = _num(spec, "window_s", required=True,
                                     positive=True)
                self.min_drop = _num(spec, "min_drop", 0.0) or 0.0
                self.direction = spec.get("direction", "down")
                if self.direction not in ("down", "up"):
                    raise RuleError(f"rule {self.name!r}: direction "
                                    "must be 'down' or 'up'")
            else:   # drop_vs_baseline
                self.drop_pct = _num(spec, "drop_pct", required=True,
                                     positive=True)
                self.baseline = _num(spec, "baseline")
                self.baseline_case = spec.get("baseline_case")
                if self.baseline is None and not self.baseline_case:
                    raise RuleError(
                        f"rule {self.name!r}: drop_vs_baseline needs "
                        "'baseline' (a number) or 'baseline_case' (a "
                        "perf-ledger case whose median becomes the "
                        "baseline)")
        # window of (t, value-or-tuple) samples; pruned per kind
        self._samples: deque = deque()
        # fire/clear state machine
        self.firing = False
        self.since: Optional[float] = None       # state entered at
        self._true_since: Optional[float] = None
        self._false_since: Optional[float] = None
        self.reason = ""
        self.fired_count = 0

    # -- window bookkeeping -------------------------------------------

    def _keep_window_s(self) -> float:
        if self.kind == "burn_rate":
            return self.slow_window_s
        if self.kind in ("rate", "stagnation", "fair_share", "skew"):
            return self.window_s
        # threshold / drop_vs_baseline hold no history beyond the
        # debounce; keep the larger debounce span
        return max(self.for_s, self.clear_after_s, 1.0)

    def _prune(self, t: float) -> None:
        keep = self._keep_window_s()
        # keep ONE sample at-or-before the window edge so window deltas
        # of cumulative counters span the full window, not a truncation
        while (len(self._samples) >= 2
               and self._samples[1][0] <= t - keep):
            self._samples.popleft()

    # -- per-kind condition evaluation --------------------------------

    def _window_delta(self, t: float, window_s: float,
                      idx: int) -> Optional[float]:
        """Delta of cumulative-counter lane ``idx`` over the trailing
        window; None with fewer than two samples in range. A counter
        RESET (value decreased — process restart) re-bases at the
        reset point instead of reporting a negative delta."""
        inside = [(ts, v) for ts, v in self._samples
                  if ts >= t - window_s]
        if len(inside) < 2:
            return None
        total = 0.0
        prev = inside[0][1][idx]
        for _, v in inside[1:]:
            cur = v[idx]
            if cur >= prev:
                total += cur - prev
            prev = cur
        return total

    def _burn(self, t: float, window_s: float) -> Optional[float]:
        good = self._window_delta(t, window_s, 0)
        bad = self._window_delta(t, window_s, 1)
        if good is None or bad is None:
            return None
        total = good + bad
        if total <= 0:
            return None                 # no traffic: no verdict
        return (bad / total) / self.budget

    def _condition(self, t: float,
                   sample: Dict[str, float]) -> Tuple[Optional[bool], str]:
        """(condition, reason). None = insufficient data (no state
        transition either way)."""
        if self.kind == "burn_rate":
            g, b = sample.get(self.good), sample.get(self.bad)
            if g is None or b is None:
                return None, ""
            self._samples.append((t, (float(g), float(b))))
            self._prune(t)
            fast = self._burn(t, self.fast_window_s)
            slow = self._burn(t, self.slow_window_s)
            if fast is None or slow is None:
                return None, ""
            cond = (fast >= self.threshold and slow >= self.threshold)
            return cond, (f"burn {fast:.1f}x (fast "
                          f"{self.fast_window_s:g}s) / {slow:.1f}x "
                          f"(slow {self.slow_window_s:g}s) of the "
                          f"{self.budget:.4g} error budget "
                          f"(threshold {self.threshold:g}x)")
        if self.kind == "fair_share":
            own_qw = sample.get(f"tenant:{self.tenant}:queue_wait_ms")
            own_c = sample.get(f"tenant:{self.tenant}:compute_ms")
            if own_qw is None or own_c is None:
                return None, ""
            tot_qw = tot_c = 0.0
            active = set()
            for key, val in sample.items():
                m = _TENANT_KEY_RE.match(key)
                if m is None or not isinstance(val, (int, float)):
                    continue
                active.add(m.group("tenant"))
                if m.group("metric") == "queue_wait_ms":
                    tot_qw += float(val)
                elif m.group("metric") == "compute_ms":
                    tot_c += float(val)
            self._samples.append(
                (t, (float(own_qw), tot_qw, float(own_c), tot_c,
                     float(len(active)))))
            self._prune(t)
            # like ``rate``: a FULL window before any verdict, so the
            # first busy seconds of a process can't misread as a hog
            if t - self._samples[0][0] < self.window_s:
                return None, ""
            d_own_qw = self._window_delta(t, self.window_s, 0)
            d_tot_qw = self._window_delta(t, self.window_s, 1)
            d_own_c = self._window_delta(t, self.window_s, 2)
            d_tot_c = self._window_delta(t, self.window_s, 3)
            if d_own_qw is None or d_tot_qw is None:
                return None, ""
            n_active = int(self._samples[-1][1][4])
            if (n_active < self.min_tenants
                    or d_tot_qw < self.min_queue_wait_ms):
                # too few tenants / too little queueing for a share to
                # mean anything: explicitly healthy, not no-verdict,
                # so a firing clears when traffic drains
                return False, ""
            qw_share = d_own_qw / d_tot_qw
            comp_share = ((d_own_c or 0.0) / d_tot_c
                          if (d_own_c is not None and d_tot_c)
                          else 0.0)
            return (qw_share >= self.share_above,
                    f"tenant {self.tenant!r} queue_wait share "
                    f"{qw_share:.0%} (compute share {comp_share:.0%}) "
                    f"over {self.window_s:g}s across {n_active} "
                    f"active tenants (threshold "
                    f"{self.share_above:.0%})")
        if self.kind == "skew":
            vals: Dict[int, float] = {}
            suffix = f":{self.metric}"
            for key, val in sample.items():
                m = _HOST_KEY_RE.match(key)
                if (m is not None and key.endswith(suffix)
                        and m.group("metric") == self.metric
                        and isinstance(val, (int, float))
                        and math.isfinite(float(val))):
                    vals[int(m.group("host"))] = float(val)
            if len(vals) < 2:
                # a lone host has nobody to lag behind; explicitly
                # healthy (not no-verdict) so a firing clears when the
                # rest of the group drains away
                return (False, "") if self._samples else (None, "")
            self._samples.append((t, vals))
            self._prune(t)
            # a FULL window before any verdict (the rate/fair_share
            # contract): every collective boundary opens a transient
            # gap while the fast host's publish races the slow one's,
            # so only a gap that SURVIVES the whole window is a
            # straggler
            if t - self._samples[0][0] < self.window_s:
                return None, ""
            inside = [(ts, hv) for ts, hv in self._samples
                      if ts >= t - self.window_s and len(hv) >= 2]
            if len(inside) < 2:
                return None, ""
            lag = sum(max(hv.values()) - min(hv.values())
                      for _, hv in inside) / len(inside)
            # the laggard: lowest mean progress over the window
            sums: Dict[int, List[float]] = {}
            for _, hv in inside:
                for h, v in hv.items():
                    sums.setdefault(h, []).append(v)
            means = {h: sum(vs) / len(vs) for h, vs in sums.items()}
            self._laggard = min(means, key=lambda h: (means[h], h))
            return (lag > self.lag_above,
                    f"skew[host-{self._laggard}]: {self.metric} lag "
                    f"{lag:.3g} between fastest and slowest of "
                    f"{len(means)} hosts over {self.window_s:g}s "
                    f"(threshold {self.lag_above:g})")
        v = sample.get(self.metric)
        if v is None:
            return None, ""
        v = float(v)
        if not math.isfinite(v):
            # a non-finite metric is its own emergency: treat as the
            # bad side of whichever comparison the rule makes
            return True, f"{self.metric} is non-finite ({v})"
        if self.kind == "threshold":
            if self.above is not None:
                return (v > self.above,
                        f"{self.metric}={v:g} above {self.above:g}")
            return (v < self.below,
                    f"{self.metric}={v:g} below {self.below:g}")
        if self.kind == "rate":
            self._samples.append((t, (v,)))
            self._prune(t)
            # a FULL window of history is required before any verdict:
            # a process's first seconds always show a high counter
            # rate (warmup compiles), and delta-over-a-sliver would
            # misread that as a storm
            first_t = self._samples[0][0]
            if t - first_t < self.window_s:
                return None, ""
            delta = self._window_delta(t, self.window_s, 0)
            if delta is None:
                return None, ""
            r = delta / self.window_s
            return (r > self.above,
                    f"{self.metric} rate {r:.3g}/s over "
                    f"{self.window_s:g}s above {self.above:g}/s")
        if self.kind == "stagnation":
            better = (lambda a, b: a < b - self.min_drop) \
                if self.direction == "down" else \
                (lambda a, b: a > b + self.min_drop)
            if not self._samples:
                self._samples.append((t, (v,)))
                return None, ""
            best_t, (best_v,) = self._samples[0]
            if better(v, best_v):
                self._samples.clear()
                self._samples.append((t, (v,)))
                return False, ""
            stale = t - best_t
            return (stale >= self.window_s,
                    f"{self.metric} stuck at {best_v:g} for "
                    f"{stale:.3g}s (window {self.window_s:g}s)")
        # drop_vs_baseline
        if self.baseline is None:
            return None, ""             # unresolvable baseline: no-op
        floor = self.baseline * (1.0 - self.drop_pct / 100.0)
        return (v < floor,
                f"{self.metric}={v:g} below {floor:g} "
                f"({self.drop_pct:g}% under baseline "
                f"{self.baseline:g})")

    # -- the fire/clear state machine ---------------------------------

    def observe(self, t: float, sample: Dict[str, float]
                ) -> Optional[dict]:
        """Feed one sample; returns a transition dict on a state
        change (fire/clear), else None."""
        cond, reason = self._condition(t, sample)
        if cond is None:
            return None
        if cond:
            self._false_since = None
            if self._true_since is None:
                self._true_since = t
            if (not self.firing
                    and t - self._true_since >= self.for_s):
                self.firing = True
                self.since = t
                self.reason = reason
                self.fired_count += 1
                return self._transition("firing", t)
            if self.firing:
                self.reason = reason
        else:
            self._true_since = None
            if self._false_since is None:
                self._false_since = t
            if (self.firing
                    and t - self._false_since >= self.clear_after_s):
                self.firing = False
                self.since = t
                self.reason = ""
                return self._transition("ok", t)
        return None

    def window_desc(self) -> str:
        if self.kind == "burn_rate":
            return (f"fast={self.fast_window_s:g}s/"
                    f"slow={self.slow_window_s:g}s")
        if self.kind in ("rate", "stagnation", "fair_share", "skew"):
            return f"{self.window_s:g}s"
        if self.for_s:
            return f"for={self.for_s:g}s"
        return "instant"

    def _attributed_host(self) -> Optional[int]:
        """The host a firing names: the spec pin (a per_host
        expansion), else the skew laggard."""
        return self.host if self.host is not None else self._laggard

    def _transition(self, state: str, t: float) -> dict:
        out = {"rule": self.name, "kind": self.kind,
               "severity": self.severity, "state": state,
               "window": self.window_desc(), "reason": self.reason,
               "t": round(float(t), 6)}
        if self.tenant:
            out["tenant"] = self.tenant
        host = self._attributed_host()
        if host is not None:
            out["host"] = host
        return out

    def state(self) -> dict:
        out = {"rule": self.name, "kind": self.kind,
               "severity": self.severity,
               "state": "firing" if self.firing else "ok",
               "window": self.window_desc(),
               "since": self.since, "reason": self.reason,
               "fired_count": self.fired_count}
        if self.tenant:
            out["tenant"] = self.tenant
        host = self._attributed_host()
        if host is not None:
            out["host"] = host
        return out

    def to_dict(self) -> dict:
        return dict(self.spec)


class RuleSet:
    """An ordered list of rules, round-trippable to/from plain dicts
    (the one source of truth a rules file, the selfcheck and the
    /metricsz alert states all share)."""

    def __init__(self, rules: Sequence[Rule]):
        self.rules = list(rules)
        names = [r.name for r in self.rules]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise RuleError(f"duplicate rule name(s): {dupes}")

    @classmethod
    def from_specs(cls, specs: Sequence[dict],
                   ledger_records: Optional[Sequence[dict]] = None
                   ) -> "RuleSet":
        rules = [Rule(s) for s in specs]
        for r in rules:
            if (r.kind == "drop_vs_baseline" and r.baseline is None
                    and r.baseline_case):
                r.baseline = resolve_ledger_baseline(
                    r.baseline_case, r.spec.get("baseline_metric",
                                                r.metric),
                    window=int(r.spec.get("baseline_window", 5) or 5),
                    records=ledger_records)
        return cls(rules)

    @classmethod
    def from_file(cls, path: str) -> "RuleSet":
        """Load a rules file: a JSON list of rule specs, or an object
        with a ``rules`` list (so a file can carry a comment/metadata
        envelope)."""
        with open(path) as fh:
            data = json.load(fh)
        if isinstance(data, dict):
            data = data.get("rules")
        if not isinstance(data, list) or not data:
            raise RuleError(f"{path}: expected a JSON list of rule "
                            "specs (or {'rules': [...]})")
        return cls.from_specs(data)

    def to_specs(self) -> List[dict]:
        return [r.to_dict() for r in self.rules]

    def __len__(self) -> int:
        return len(self.rules)

    def __iter__(self):
        return iter(self.rules)


def resolve_ledger_baseline(case: str, metric: str = "value", *,
                            window: int = 5,
                            records: Optional[Sequence[dict]] = None
                            ) -> Optional[float]:
    """Median of the case's last ``window`` perf-ledger readings —
    the baseline of the roofline-drop rule. None when the ledger is
    absent/disabled or the case has no finite readings (the rule then
    evaluates to no-verdict instead of inventing a baseline)."""
    try:
        from dpsvm_tpu_torch.observability import ledger
        if records is None:
            path = ledger.ledger_path()
            if path is None:
                return None
            records = ledger.read(path)
        vals: List[float] = []
        for r in records:
            if r.get("case") != case:
                continue
            v = r.get(metric)
            if v is None:
                v = (r.get("metrics") or {}).get(metric)
            if isinstance(v, (int, float)) and math.isfinite(v):
                vals.append(float(v))
        if not vals:
            return None
        tail = sorted(vals[-window:])
        mid = len(tail) // 2
        if len(tail) % 2:
            return tail[mid]
        return 0.5 * (tail[mid - 1] + tail[mid])
    except Exception:
        return None


def active_tenants(sample: Dict[str, float]) -> List[str]:
    """Tenant names present in a sample's ``tenant:<name>:<metric>``
    lanes, sorted (deterministic expansion order), ``other`` excluded
    — the overflow aggregate can never name a culprit."""
    seen = set()
    for key in sample:
        m = _TENANT_KEY_RE.match(key)
        if m is not None and m.group("tenant") != TENANT_OTHER:
            seen.add(m.group("tenant"))
    return sorted(seen)


def expand_tenant_rule(spec: dict, tenant: str) -> dict:
    """One concrete rule spec from a ``per_tenant`` template:
    ``{tenant}`` substituted into the metric/counter names, the rule
    renamed ``template[tenant]`` and pinned to the tenant."""
    out = {k: v for k, v in spec.items() if k != "per_tenant"}
    out["name"] = f"{spec.get('name')}[{tenant}]"
    out["tenant"] = tenant
    for key in ("metric", "good", "bad"):
        v = out.get(key)
        if isinstance(v, str) and "{tenant}" in v:
            out[key] = v.replace("{tenant}", tenant)
    return out


def active_hosts(sample: Dict[str, float]) -> List[int]:
    """Host ids present in a sample's ``host:<k>:<metric>`` lanes,
    sorted — the ``per_host`` expansion source."""
    seen = set()
    for key in sample:
        m = _HOST_KEY_RE.match(key)
        if m is not None:
            seen.add(int(m.group("host")))
    return sorted(seen)


def expand_host_rule(spec: dict, host: int) -> dict:
    """One concrete rule spec from a ``per_host`` template:
    ``{host}`` substituted into the metric/counter names, the rule
    renamed ``template[host-K]`` and pinned to the host."""
    out = {k: v for k, v in spec.items() if k != "per_host"}
    out["name"] = f"{spec.get('name')}[host-{host}]"
    out["host"] = int(host)
    for key in ("metric", "good", "bad"):
        v = out.get(key)
        if isinstance(v, str) and "{host}" in v:
            out[key] = v.replace("{host}", str(host))
    return out


class Watchtower:
    """A RuleSet plus the evaluation loop state: feed samples, get
    transitions; thread-safe (serving feeds from handler threads).

    ``clock`` is injected for determinism and only consulted when a
    caller omits ``t`` — tests and the trace-replay path always pass
    explicit timestamps, so firings replay bit-identically.

    ``per_tenant`` template rules are expanded lazily against the
    tenants each sample shows as active, at most ``tenant_cap``
    concrete rules per template (first-seen wins once the cap is
    reached; an expanded rule persists for the watch's lifetime so a
    briefly-idle tenant keeps its alert history)."""

    def __init__(self, rules, *,
                 clock: Optional[Callable[[], float]] = None,
                 tenant_cap: int = TENANT_FAN_OUT_CAP,
                 host_cap: int = HOST_FAN_OUT_CAP):
        if isinstance(rules, RuleSet):
            self.ruleset = rules
        else:
            self.ruleset = RuleSet.from_specs(list(rules))
        self._clock = clock
        self._lock = threading.Lock()
        self._worst_fired: Optional[str] = None
        self.transitions_total = 0
        self.tenant_cap = max(1, int(tenant_cap))
        self.host_cap = max(1, int(host_cap))
        # template name -> {tenant -> concrete Rule}
        self._tenant_rules: Dict[str, Dict[str, Rule]] = {
            r.name: {} for r in self.ruleset if r.per_tenant}
        # template name -> {host -> concrete Rule}
        self._host_rules: Dict[str, Dict[int, Rule]] = {
            r.name: {} for r in self.ruleset if r.per_host}

    def _expand(self, sample: Dict[str, float]) -> None:
        """Lock held. Materialize concrete rules for newly-active
        tenants/hosts, within the per-template caps."""
        tenants = hosts = None
        for template in self.ruleset:
            if template.per_tenant:
                if tenants is None:
                    tenants = active_tenants(sample)
                expanded = self._tenant_rules[template.name]
                for ten in tenants:
                    if ten in expanded:
                        continue
                    if len(expanded) >= self.tenant_cap:
                        break
                    expanded[ten] = Rule(
                        expand_tenant_rule(template.spec, ten))
            elif template.per_host:
                if hosts is None:
                    hosts = active_hosts(sample)
                hexp = self._host_rules[template.name]
                for h in hosts:
                    if h in hexp:
                        continue
                    if len(hexp) >= self.host_cap:
                        break
                    hexp[h] = Rule(
                        expand_host_rule(template.spec, h))

    def _live_rules(self) -> List[Rule]:
        """Lock held. Evaluation order: concrete base rules, then the
        expansions of each template (templates themselves never see a
        sample — their metric names still hold the placeholder)."""
        out = [r for r in self.ruleset
               if not r.per_tenant and not r.per_host]
        for template in self.ruleset:
            if template.per_tenant:
                out.extend(self._tenant_rules[template.name].values())
            elif template.per_host:
                out.extend(self._host_rules[template.name].values())
        return out

    def observe(self, sample: Dict[str, float],
                t: Optional[float] = None) -> List[dict]:
        """Evaluate every rule against one sample at time ``t``;
        returns the state transitions (possibly empty)."""
        if t is None:
            if self._clock is None:
                import time
                t = time.monotonic()
            else:
                t = self._clock()
        out: List[dict] = []
        with self._lock:
            self._expand(sample)
            for rule in self._live_rules():
                tr = rule.observe(float(t), sample)
                if tr is not None:
                    out.append(tr)
                    self.transitions_total += 1
                    if tr["state"] == "firing":
                        self._worst_fired = worst_severity(
                            self._worst_fired, tr["severity"])
        return out

    def states(self) -> List[dict]:
        with self._lock:
            return [r.state() for r in self._live_rules()]

    def firing(self) -> List[dict]:
        return [s for s in self.states() if s["state"] == "firing"]

    def worst_firing(self) -> Optional[str]:
        worst: Optional[str] = None
        for s in self.firing():
            worst = worst_severity(worst, s["severity"])
        return worst

    @property
    def worst_fired(self) -> Optional[str]:
        """Worst severity that EVER fired during this watch — the
        ``dpsvm watch`` exit-code fact (a fired-and-cleared burn still
        failed the gate)."""
        with self._lock:
            return self._worst_fired

    def exit_code(self) -> int:
        return severity_exit_code(self.worst_fired)


# ---------------------------------------------------------------------
# default rule sets (docs/OBSERVABILITY.md "Watch & alerts")
# ---------------------------------------------------------------------

def default_serving_rules() -> List[dict]:
    """The serving SLO rules every ServingServer watches out of the
    box: a paging multi-window burn-rate alert on availability (504
    deadline misses burning the 99.9% objective's budget), a warning
    on sustained queue saturation (the shed ladder's territory —
    serving/budget.py), and two per-tenant templates — an
    availability burn scoped to one tenant's traffic and the
    ``fair_share`` noisy-neighbour warn — expanded over whatever
    tenants the live sample shows (docs/OBSERVABILITY.md "Per-tenant
    attribution")."""
    return [
        {"name": "availability-burn", "kind": "burn_rate",
         "severity": "page",
         "good": "requests", "bad": "deadline_504",
         "objective": 0.999,
         "fast_window_s": 60.0, "slow_window_s": 600.0,
         "threshold": 14.4, "clear_after_s": 60.0},
        {"name": "queue-saturation", "kind": "threshold",
         "severity": "warn",
         "metric": "queue_fill", "above": 0.8,
         "for_s": 5.0, "clear_after_s": 10.0},
        {"name": "tenant-availability-burn", "kind": "burn_rate",
         "severity": "warn", "per_tenant": True,
         "good": "tenant:{tenant}:requests",
         "bad": "tenant:{tenant}:deadline_504",
         "objective": 0.999,
         "fast_window_s": 60.0, "slow_window_s": 600.0,
         "threshold": 14.4, "clear_after_s": 60.0},
        {"name": "tenant-fair-share", "kind": "fair_share",
         "severity": "warn", "per_tenant": True,
         "window_s": 60.0, "share_above": 0.5, "min_tenants": 2,
         "for_s": 5.0, "clear_after_s": 30.0},
        # A thrashing model cache pages BEFORE p99 does: sustained
        # hydration faults mean the working set outgrew the HBM budget
        # (every fault is a cold start on someone's request), so rate
        # the fault counter like the training side rates compiles
        # (compile-storm). > 1 fault/s sustained over a minute is
        # churn, not warmup (docs/SERVING.md "Model fleet").
        {"name": "model-cache-thrash", "kind": "rate",
         "severity": "warn", "metric": "model_faults",
         "window_s": 60.0, "above": 1.0, "clear_after_s": 60.0},
    ]


def default_training_rules(
        ledger_records: Optional[Sequence[dict]] = None) -> List[dict]:
    """The training-side rules the driver watches when armed
    (``--watch-rules``/``--bundle-dir``): gap stagnation beyond the
    HealthMonitor's in-run window, a compile storm (steady state
    retraces nothing — solver/driver.py), shard-heartbeat age
    (straggler/hang), and a roofline_fraction drop against the
    perf-ledger median when a history exists."""
    return [
        {"name": "gap-stagnation", "kind": "stagnation",
         "severity": "warn", "metric": "gap",
         "window_s": 120.0, "clear_after_s": 0.0},
        {"name": "compile-storm", "kind": "rate", "severity": "warn",
         "metric": "compiles", "window_s": 60.0, "above": 0.5,
         "clear_after_s": 60.0},
        {"name": "shard-heartbeat", "kind": "threshold",
         "severity": "page", "metric": "heartbeat_age",
         "above": 120.0, "for_s": 0.0, "clear_after_s": 0.0},
        {"name": "roofline-drop", "kind": "drop_vs_baseline",
         "severity": "warn", "metric": "roofline_fraction",
         "baseline_case": "bench_headline",
         "baseline_metric": "roofline_fraction",
         "drop_pct": 25.0, "for_s": 0.0, "clear_after_s": 0.0},
    ]


def default_fleet_rules() -> List[dict]:
    """The multi-host group rules ``dpsvm fleet --watch`` and the
    straggler drill arm by default (docs/OBSERVABILITY.md "Fleet"):

    * a paging per-host heartbeat-stale threshold — expanded over the
      ``host:<k>:heartbeat_age_seconds`` lanes the federation layer
      builds, so a silent host pages by NAME;
    * a paging reform-storm rate — the group ``generation`` counter
      (every reformation increments it: resilience/hostgroup.py)
      climbing faster than ~3 reformations / 10 min means the group is
      thrashing, not recovering;
    * the warning ``skew`` rule on per-host iteration progress — one
      chunk of sustained lag (the drill plants 25-iteration chunks) is
      a straggler, the transient collective-boundary gap is not.
    """
    return [
        {"name": "host-heartbeat-stale", "kind": "threshold",
         "severity": "page", "per_host": True,
         "metric": "host:{host}:heartbeat_age_seconds",
         "above": 120.0, "for_s": 0.0, "clear_after_s": 0.0},
        {"name": "reform-storm", "kind": "rate", "severity": "page",
         "metric": "generation", "window_s": 600.0, "above": 0.005,
         "clear_after_s": 120.0},
        {"name": "iteration-skew", "kind": "skew", "severity": "warn",
         "metric": "n_iter", "window_s": 30.0, "lag_above": 20.0,
         "clear_after_s": 10.0},
    ]


def load_rules(source, *, default: str = "serving") -> RuleSet:
    """Resolve a rules argument: None -> the named default set
    (``serving``/``training``/``fleet``), a path ->
    ``RuleSet.from_file``, a list of specs / a RuleSet -> as-is."""
    if source is None:
        specs = {"serving": default_serving_rules,
                 "training": default_training_rules,
                 "fleet": default_fleet_rules}[default]()
        return RuleSet.from_specs(specs)
    if isinstance(source, RuleSet):
        return source
    if isinstance(source, str):
        return RuleSet.from_file(source)
    return RuleSet.from_specs(list(source))


# ---------------------------------------------------------------------
# sample flatteners: every watch source -> one canonical sample dict
# ---------------------------------------------------------------------
#
# The canonical vocabulary rules reference (documented in
# docs/OBSERVABILITY.md "Watch & alerts"):
#
#   serving:  requests, deadline_504, errors, rejected, queue_depth,
#             queue_fill, p99_ms, healthy_replicas, incidents
#   training: n_iter, gap, n_sv, compiles, compile_seconds,
#             heartbeat_age, roofline_fraction, iters_per_sec
#
# Raw exposition names are ALSO included (prefixless rules stay
# readable; power users can reference any exported series).

_PROM_CANON = {
    "dpsvm_serving_requests_total": "requests",
    "dpsvm_serving_deadline_504_total": "deadline_504",
    "dpsvm_serving_errors_total": "errors",
    "dpsvm_serving_rejected_total": "rejected",
    "dpsvm_serving_queue_depth": "queue_depth",
    "dpsvm_fleet_model_faults_total": "model_faults",
    "dpsvm_fleet_model_evictions_total": "model_evictions",
    "dpsvm_serving_replicas_healthy": "healthy_replicas",
    "dpsvm_incidents_total": "incidents",
    "dpsvm_train_iterations": "n_iter",
    "dpsvm_train_gap": "gap",
    "dpsvm_train_n_sv": "n_sv",
    "dpsvm_train_iters_per_sec": "iters_per_sec",
    "dpsvm_train_compiles_total": "compiles",
    "dpsvm_train_compile_seconds_total": "compile_seconds",
    "dpsvm_train_shard_heartbeat_age_seconds": "heartbeat_age",
}

_PROM_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{[^{}]*\})?\s+(?P<value>[^ ]+)\s*$")


def sample_from_prometheus(text: str) -> Dict[str, float]:
    """Flatten a Prometheus text exposition into a sample dict.
    Multiple series of one family collapse: ``_total`` counters sum
    (per-label traffic adds), everything else takes the max (the worst
    queue depth / heartbeat age is the alarming one)."""
    acc: Dict[str, List[float]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            continue
        try:
            v = float(m.group("value").replace("+Inf", "inf")
                      .replace("-Inf", "-inf").replace("NaN", "nan"))
        except ValueError:
            continue
        acc.setdefault(m.group("name"), []).append(v)
    out: Dict[str, float] = {}
    for name, vals in acc.items():
        agg = sum(vals) if name.endswith("_total") else max(vals)
        out[name] = agg
        canon = _PROM_CANON.get(name)
        if canon:
            out[canon] = agg
    return out


def sample_from_metricsz_json(obj: dict) -> Dict[str, float]:
    """Flatten the serving server's JSON ``/metricsz`` blob into a
    sample (serving/server.py metrics())."""
    out: Dict[str, float] = {}
    for key in ("requests", "errors", "rejected", "deadline_504",
                "expired", "ejections", "rebuilds", "incidents_total"):
        v = obj.get(key)
        if isinstance(v, (int, float)):
            out["incidents" if key == "incidents_total" else key] = \
                float(v)
    lat = obj.get("latency_ms") or {}
    if isinstance(lat.get("p99"), (int, float)):
        out["p99_ms"] = float(lat["p99"])
    depth = 0.0
    for st in (obj.get("models") or {}).values():
        if isinstance(st, dict) and isinstance(
                st.get("queue_depth_rows"), (int, float)):
            depth += float(st["queue_depth_rows"])
    out["queue_depth"] = depth
    # model-fleet cache lanes (serving metrics() "model_cache") — the
    # model-cache-thrash rule's fault counter plus the eviction/
    # residency companions
    mc = obj.get("model_cache") or {}
    if isinstance(mc, dict):
        for key, canon in (("faults", "model_faults"),
                           ("evictions", "model_evictions"),
                           ("resident", "model_cache_resident"),
                           ("budget", "model_cache_budget")):
            v = mc.get(key)
            if isinstance(v, (int, float)):
                out[canon] = float(v)
    # per-tenant lanes (serving metrics() "tenants.per_tenant") —
    # the vocabulary the per_tenant rule templates reference
    per_tenant = (obj.get("tenants") or {}).get("per_tenant") or {}
    if isinstance(per_tenant, dict):
        for ten, st in per_tenant.items():
            if not isinstance(st, dict):
                continue
            for key, v in st.items():
                if isinstance(v, (int, float)):
                    out[f"tenant:{ten}:{key}"] = float(v)
    return out


def sample_from_chunk(rec: dict) -> Tuple[float, Dict[str, float]]:
    """(t, sample) from one run-trace ``chunk`` record — the
    trace-tail watch source (``dpsvm watch --trace``)."""
    t = float(rec.get("t", 0.0))
    out: Dict[str, float] = {}
    for key in ("n_iter", "gap", "n_sv"):
        v = rec.get(key)
        if isinstance(v, (int, float)):
            out[key] = float(v)
    ages = rec.get("shard_ages")
    if isinstance(ages, (list, tuple)) and ages:
        try:
            out["heartbeat_age"] = max(float(a) for a in ages)
        except (TypeError, ValueError):
            pass
    return t, out


# ---------------------------------------------------------------------
# snapshot-sequence tracking (the --metrics-out tail contract)
# ---------------------------------------------------------------------

SNAPSHOT_HEADER_RE = re.compile(
    r"^# dpsvm-snapshot seq=(?P<seq>\d+) unix=(?P<unix>[0-9.]+) "
    r"time=(?P<time>\S+)")


def parse_snapshot_header(text: str) -> Optional[dict]:
    """The ``--metrics-out`` header line (metrics.write_snapshot):
    ``# dpsvm-snapshot seq=N unix=T time=ISO``. None when absent (a
    pre-watch snapshot or a foreign exposition)."""
    first = text.split("\n", 1)[0]
    m = SNAPSHOT_HEADER_RE.match(first)
    if m is None:
        return None
    return {"seq": int(m.group("seq")),
            "unix": float(m.group("unix")),
            "time": m.group("time")}


class SnapshotFollower:
    """Tracks the monotonic ``seq`` of successive ``--metrics-out``
    snapshots so a tailing consumer detects missed and duplicate
    snapshots instead of silently mis-windowing its rates. ``note``
    returns (fresh, problems): ``fresh`` False on a duplicate (same
    snapshot re-read — do NOT re-evaluate rules on it), problems
    naming any gap."""

    def __init__(self):
        self.last_seq: Optional[int] = None
        self.missed = 0
        self.duplicates = 0

    def note(self, header: Optional[dict]) -> Tuple[bool, List[str]]:
        if header is None:
            return True, []         # headerless source: no tracking
        seq = header["seq"]
        problems: List[str] = []
        if self.last_seq is not None:
            if seq == self.last_seq:
                self.duplicates += 1
                return False, []
            if seq < self.last_seq:
                problems.append(
                    f"snapshot seq went backwards ({self.last_seq} -> "
                    f"{seq}): writer restarted")
            elif seq > self.last_seq + 1:
                gap = seq - self.last_seq - 1
                self.missed += gap
                problems.append(
                    f"missed {gap} snapshot(s) between seq "
                    f"{self.last_seq} and {seq}")
        self.last_seq = seq
        return True, problems
