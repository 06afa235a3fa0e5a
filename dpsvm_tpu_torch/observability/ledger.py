"""Persistent perf ledger + historical regression gate (port of
``dpsvm_tpu/observability/ledger.py``).

``dpsvm compare`` is strictly pairwise: every PR can pass its A/B gate
while a 2%-per-PR drift accumulates invisibly ("Recipe for Fast
Large-scale SVM Training", arXiv:2207.01016, is the worked example of
why perf trajectories need bookkeeping, not snapshots). The ledger is
the fix: one append-only JSONL file that every measurement producer
writes a schema-versioned record into —

* ``bench.py`` / ``bench_convergence.py`` rows (kind ``bench``),
* every ``benchmarks/burst_runner.py`` row (kind ``burst``), so the
  gate has data from the first window,
* ``dpsvm loadgen`` rows incl. the ``--saturate`` SLO row (kind
  ``loadgen``),
* ``dpsvm compare --fail-on-regress`` verdicts (kind ``compare``).

Each record carries the run identity (git sha, backend, case tag), the
measurement (``value``/``unit`` + the full metrics dict) and a
``trace`` pointer at its provenance trace when one was archived.

``dpsvm perf`` renders per-case history; ``dpsvm perf gate --window N
--fail-on-regress PCT`` applies the historical check: the newest
record against the **median of the previous N** records,
direction-aware like ``compare`` (an it/s drop and a seconds growth
are both regressions) — so drift that accumulated across several
individually-passing PRs still fails CI.

Path resolution: ``DPSVM_PERF_LEDGER`` env (empty string = disabled),
else the port's own ``dpsvm_tpu_torch/_ledger/perf_ledger.jsonl`` (a
directory git ignores: the JAX package's tracked history under
``benchmarks/results`` is never written by the port).
Appends are best-effort by default (a full disk must not kill a bench
run); readers tolerate a torn final line like the trace reader.

Dependency-free (stdlib only): the ledger is read and written on a
machine with no accelerator.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time
from typing import Dict, List, Optional, Sequence

LEDGER_ENV = "DPSVM_PERF_LEDGER"
LEDGER_SCHEMA = 1

#: record kinds the documented producers write (free strings otherwise;
#: this is the vocabulary, like record.SERVING_EVENTS). "tune" rows
#: come from `dpsvm tune` (tuning/tuner.py): per-knob probe readings
#: plus the tuned_vs_default A/B verdict. "robust" rows come from the
#: resilience drills (resilience/hostgroup.host_loss_drill):
#: recovery latencies, gated direction "lower" like any latency.
#: "fleet" rows come from the model-fleet subsystem (dpsvm_tpu/fleet):
#: the fleet_cache_drill's cold-start p99 and `dpsvm grid`'s
#: grid_vs_sequential speedup, both trace-pointed (docs/PERF.md).
KINDS = ("bench", "burst", "loadgen", "compare", "tune", "serve",
         "robust", "fleet")

#: unit -> gate direction ("higher" = bigger is better). The per-record
#: ``direction`` field wins; the metric-name heuristics below back this
#: up for rows without a unit.
DIRECTION_BY_UNIT = {
    "iter/s": "higher", "ex/s": "higher", "req/s": "higher",
    "x": "higher", "rows/s": "higher",
    "s": "lower", "ms": "lower", "bytes": "lower",
}

_LOWER_HINTS = ("seconds", "_ms", "_s", "latency", "hbm", "bytes",
                "compile")
_HIGHER_HINTS = ("per_sec", "per_s", "speedup", "rps", "throughput",
                 "accuracy", "availability", "iters", "roofline",
                 "fraction")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def default_ledger_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_ledger", "perf_ledger.jsonl")


def ledger_path(explicit: Optional[str] = None) -> Optional[str]:
    """Resolve the ledger file: explicit argument, else the env var
    (EMPTY env value = ledger disabled -> None), else the port's
    default."""
    if explicit:
        return explicit
    env = os.environ.get(LEDGER_ENV)
    if env is not None:
        return env or None
    return default_ledger_path()


_GIT_SHA: Optional[str] = None


def git_sha() -> Optional[str]:
    """Current repo sha (cached; env DPSVM_GIT_SHA overrides — CI
    images without a .git dir still get provenance)."""
    global _GIT_SHA
    if _GIT_SHA is not None:
        return _GIT_SHA or None
    env = os.environ.get("DPSVM_GIT_SHA", "").strip()
    if env:
        _GIT_SHA = env
        return env
    try:
        out = subprocess.run(
            ["git", "-C", repo_root(), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10)
        _GIT_SHA = out.stdout.strip() if out.returncode == 0 else ""
    except Exception:
        _GIT_SHA = ""
    return _GIT_SHA or None


def backend_hint() -> Optional[str]:
    """Best-effort backend tag WITHOUT initializing CUDA: ``cuda`` once
    this process has initialized the card, else ``DPSVM_PLATFORM``.
    None when nothing is known: never forces a device probe."""
    import sys
    th = sys.modules.get("torch")
    if th is not None:
        try:
            if th.cuda.is_initialized():
                return "cuda"
        except Exception:
            pass
    v = os.environ.get("DPSVM_PLATFORM", "").strip()
    if v:
        return v.split(",")[0]
    return None


def direction_for(record: dict) -> str:
    """Gate direction for a record: explicit field, unit table, then
    metric-name heuristics; 'higher' when truly unknown (a throughput
    bias — the common case here)."""
    d = record.get("direction")
    if d in ("higher", "lower"):
        return d
    unit = record.get("unit")
    if unit in DIRECTION_BY_UNIT:
        return DIRECTION_BY_UNIT[unit]
    name = str(record.get("case", "")) + " " + str(
        (record.get("metrics") or {}).get("metric", ""))
    low = name.lower()
    if any(h in low for h in _LOWER_HINTS):
        return "lower"
    if any(h in low for h in _HIGHER_HINTS):
        return "higher"
    return "higher"


def host_count_hint() -> int:
    """The provenance host count: ``DPSVM_HOST_COUNT`` (set by the
    hostgroup supervisor for its children) when parseable, else 1 —
    the single-process default every pre-fleet row implicitly had."""
    raw = os.environ.get("DPSVM_HOST_COUNT", "").strip()
    try:
        n = int(raw)
        return n if n >= 1 else 1
    except ValueError:
        return 1


def make_record(case: str, metrics: Optional[dict] = None, *,
                kind: str = "bench", value: Optional[float] = None,
                unit: Optional[str] = None,
                direction: Optional[str] = None,
                trace: Optional[str] = None,
                backend: Optional[str] = None,
                host_count: Optional[int] = None) -> dict:
    metrics = dict(metrics or {})
    if value is None:
        v = metrics.get("value")
        value = float(v) if isinstance(v, (int, float)) else None
    return {
        "schema": LEDGER_SCHEMA,
        "kind": str(kind),
        "case": str(case),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "git_sha": git_sha(),
        "backend": backend if backend is not None else backend_hint(),
        # multi-host provenance: a 3-host row must never gate against
        # single-host history (docs/OBSERVABILITY.md "Fleet")
        "host_count": (int(host_count) if host_count is not None
                       else host_count_hint()),
        "value": value,
        "unit": unit if unit is not None else metrics.get("unit"),
        "direction": direction,
        "metrics": metrics,
        "trace": trace,
    }


def append(case: str, metrics: Optional[dict] = None, *,
           kind: str = "bench", value: Optional[float] = None,
           unit: Optional[str] = None, direction: Optional[str] = None,
           trace: Optional[str] = None, backend: Optional[str] = None,
           host_count: Optional[int] = None,
           path: Optional[str] = None,
           strict: bool = False) -> Optional[str]:
    """Append one record; returns the ledger path written (None when
    the ledger is disabled or, in non-strict mode, the write failed —
    provenance hiccups must not burn a measured row)."""
    resolved = ledger_path(path)
    if resolved is None:
        return None
    rec = make_record(case, metrics, kind=kind, value=value, unit=unit,
                      direction=direction, trace=trace, backend=backend,
                      host_count=host_count)
    try:
        parent = os.path.dirname(os.path.abspath(resolved))
        os.makedirs(parent, exist_ok=True)
        with open(resolved, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
        return resolved
    except OSError:
        if strict:
            raise
        return None


def read(path: str) -> List[dict]:
    """Every intact record, in append order. A torn FINAL line (a
    producer killed mid-write) is dropped, matching the trace reader;
    a torn interior line raises — that is corruption, not a race."""
    records: List[dict] = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    for i, raw in enumerate(lines):
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise ValueError(f"{path}:{i + 1}: not a JSON record")
        if isinstance(rec, dict):
            records.append(rec)
    return records


def cases(records: Sequence[dict]) -> List[str]:
    seen: Dict[str, None] = {}
    for r in records:
        c = r.get("case")
        if c:
            seen.setdefault(str(c), None)
    return list(seen)


def series(records: Sequence[dict], case: str,
           metric: str = "value") -> List[dict]:
    """The case's measurement history, append order: records with a
    finite numeric reading of ``metric`` (top-level ``value`` or a key
    of the metrics dict)."""
    out = []
    for r in records:
        if str(r.get("case")) != str(case):
            continue
        v = (r.get("value") if metric == "value"
             else (r.get("metrics") or {}).get(metric))
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if v != v or v in (float("inf"), float("-inf")):
            continue
        out.append({"value": float(v), "time": r.get("time"),
                    "git_sha": r.get("git_sha"),
                    "backend": r.get("backend"),
                    "unit": r.get("unit"), "record": r})
    return out


def gate(records: Sequence[dict], *, window: int = 5,
         threshold_pct: float = 10.0, case: Optional[str] = None,
         metric: str = "value") -> List[str]:
    """Historical regression verdicts (empty = gate passes).

    Per case: newest value vs the MEDIAN of the up-to-``window``
    records before it — the robust baseline a slow multi-PR drift
    cannot drag along with it (each pairwise step passes, but the
    newest-vs-median delta keeps growing until it trips). Direction
    comes from the newest record (``direction``/``unit``/name
    heuristics). Cases with fewer than 2 readings have no history to
    gate and are skipped.

    Provenance filter: only rows whose ``host_count`` matches the
    newest record's (absent = 1, the pre-fleet default) count as
    history — a 3-host reading regressing against single-host medians
    (or propping them up) would be a category error, not a trend
    (docs/OBSERVABILITY.md "Fleet").
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    targets = [case] if case else cases(records)
    verdicts = []

    def _hc(rec: dict) -> int:
        v = rec.get("host_count")
        return int(v) if isinstance(v, int) and not isinstance(
            v, bool) and v >= 1 else 1

    for c in targets:
        hist = series(records, c, metric=metric)
        if len(hist) < 2:
            continue
        want_hc = _hc(hist[-1]["record"])
        hist = [h for h in hist if _hc(h["record"]) == want_hc]
        if len(hist) < 2:
            continue
        newest = hist[-1]
        base_vals = [h["value"] for h in hist[-(window + 1):-1]]
        base = statistics.median(base_vals)
        direction = direction_for(newest["record"])
        v = newest["value"]
        if base == 0:
            continue
        delta_pct = (v - base) / abs(base) * 100.0
        bad = (delta_pct < -threshold_pct if direction == "higher"
               else delta_pct > threshold_pct)
        if bad:
            what = ("dropped" if direction == "higher" else "grew")
            unit = newest.get("unit") or ""
            verdicts.append(
                f"{c}: {metric} {what} {abs(delta_pct):.1f}% vs "
                f"median of last {len(base_vals)} "
                f"({base:g} -> {v:g}{' ' + unit if unit else ''}, "
                f"threshold {threshold_pct:g}%, direction {direction})")
    return verdicts


# ---------------------------------------------------------------------
# `dpsvm perf` rendering
# ---------------------------------------------------------------------

def _trend_bar(v: float, lo: float, hi: float, width: int = 28) -> str:
    if hi <= lo:
        return "#" * (width // 2)
    frac = (v - lo) / (hi - lo)
    return "#" * max(1, int(round(frac * width)))


def render_history(records: Sequence[dict], *,
                   case: Optional[str] = None, metric: str = "value",
                   last: int = 12, width: int = 28) -> str:
    """Per-case ASCII trend (the `report` gap-curve idiom applied to
    history): one bar per recorded run, newest last, so the drift
    `compare` cannot see is visible at a glance."""
    targets = [case] if case else cases(records)
    out = []
    for c in targets:
        hist = series(records, c, metric=metric)
        if not hist:
            out.append(f"{c}: no numeric {metric!r} readings")
            continue
        shown = hist[-last:]
        vals = [h["value"] for h in shown]
        lo, hi = min(vals), max(vals)
        unit = next((h["unit"] for h in reversed(shown)
                     if h.get("unit")), "")
        direction = direction_for(shown[-1]["record"])
        out.append(f"{c}  [{metric}{', ' + unit if unit else ''}; "
                   f"{len(hist)} run(s), direction {direction}]")
        for h in shown:
            sha = (h.get("git_sha") or "-------")[:7]
            t = (h.get("time") or "")[:16]
            out.append(f"  {t:<16} {sha:<7} {h['value']:>12,.4g}  "
                       f"{_trend_bar(h['value'], lo, hi, width)}")
        if len(hist) > len(shown):
            out.append(f"  ({len(hist) - len(shown)} older run(s) "
                       "not shown)")
        out.append("")
    return "\n".join(out).rstrip()
