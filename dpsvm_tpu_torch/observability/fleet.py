"""Metrics federation: N hosts' metric surfaces -> one fleet view (port
of ``dpsvm_tpu/observability/fleet.py``).

A multi-host run (resilience/hostgroup.py) leaves one metric surface a
host: its ``--metrics-out`` snapshot file or its live ``/metricsz``
endpoint. This module reads them together:

* ``collect`` reads every host's source (files and URLs mixed) into
  per-host sample sets; an unreachable host is data (``up = 0``), not an
  error;
* ``federate`` folds them into one fleet snapshot: counters summed, ages
  maxed, ``dpsvm_train_iterations`` the smallest (the group's progress is
  its slowest member's), and a few per-host series under a ``host`` label
  whose cardinality ``TenantLabelBudget`` bounds (metrics.py);
* ``render_exposition`` writes the snapshot as a Prometheus exposition
  that passes ``metrics.validate_exposition``;
* ``fleet_watch_sample`` flattens it into the ``host:<k>:<metric>`` lanes
  the ``skew`` rule and the per-host templates read (slo.py);
* ``host_artifacts`` gathers every host's heartbeat, trace tail and
  doctor line for a fleet incident bundle (blackbox.py).

Histogram components (``_bucket`` / ``_sum`` / ``_count``) are not
federated: summing buckets is right only on identical ``le`` grids.

Stdlib only, no device: ``fleet`` runs on a machine with no card. The
same snapshot and exposition text as the JAX package's federation on the
same files (``tests/test_torch_fleet_obs.py``).
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from dpsvm_tpu_torch.observability.metrics import (DEFAULT_TENANT_BUDGET,
                                                   TenantLabelBudget,
                                                   _SAMPLE_RE,
                                                   _split_labels)
from dpsvm_tpu_torch.observability.slo import parse_snapshot_header

#: exposition families that get a per-host labelled series in the
#: federated output (name here -> fleet family name). Curated, not
#: everything: per-host fan-out multiplies series count by host count,
#: so only the lanes straggler/skew debugging actually reads ride it.
PER_HOST_SERIES = {
    "dpsvm_train_iterations": "dpsvm_host_iterations",
    "dpsvm_train_gap": "dpsvm_host_gap",
    "dpsvm_train_n_sv": "dpsvm_host_n_sv",
    "dpsvm_train_compiles_total": "dpsvm_host_compiles_total",
}

#: federated family -> aggregation override. Everything else follows
#: the suffix rules: ``*_total`` sums, ``*age*`` maxes, rest maxes.
_AGG_OVERRIDES = {
    "dpsvm_train_iterations": "min",
}

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")

#: the host group's heartbeat file naming (resilience/hostgroup.py
#: write_heartbeat): the generation/seq side channel of federation.
HEARTBEAT_FILE_RE = re.compile(r"^host-(?P<host>\d+)\.json$")


class FleetError(ValueError):
    """A fleet source list that cannot be used at all (empty, or
    host ids that collide)."""


# ---------------------------------------------------------------------
# source reading
# ---------------------------------------------------------------------

def _is_url(src: str) -> bool:
    return src.startswith("http://") or src.startswith("https://")


def _scrape_url(src: str) -> str:
    """Normalize a host source URL to its Prometheus scrape endpoint
    (the serving/metrics servers expose ``/metricsz?format=
    prometheus``); a URL already naming /metricsz is kept."""
    if "metricsz" in src:
        return src
    return src.rstrip("/") + "/metricsz?format=prometheus"


def read_source(src: str, *, timeout: float = 5.0) -> str:
    """One host's exposition text from a snapshot file or a live URL.
    Raises OSError on an unreachable source (collect() converts that
    into ``up=0`` data)."""
    if _is_url(src):
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(_scrape_url(src),
                                        timeout=timeout) as r:
                return r.read().decode("utf-8", "replace")
        except urllib.error.URLError as e:
            raise OSError(str(e))
    with open(src) as fh:
        return fh.read()


def parse_exposition(text: str) -> List[Tuple[str, Dict[str, str],
                                              float]]:
    """(name, labels, value) triples from an exposition text; bad
    lines are skipped (a half-written foreign file must not kill the
    fleet view — the snapshot writer is atomic, scrapes are whole)."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        labels_raw = m.group("labels")
        labels = _split_labels(labels_raw) if labels_raw else []
        if labels is None:
            continue
        try:
            v = float(m.group("value").replace("+Inf", "inf")
                      .replace("-Inf", "-inf").replace("NaN", "nan"))
        except ValueError:
            continue
        out.append((m.group("name"), dict(labels), v))
    return out


def resolve_sources(sources: Sequence[str]) -> Dict[int, str]:
    """host id -> source. Ids are parsed from ``host-K``/``h{K}``/
    ``hostK`` markers in the source string (file names like
    ``metrics_h1.prom``, URLs like ``http://...:9101`` get positional
    ids when nothing matches). Colliding explicit ids are an error —
    two sources claiming host 1 would silently double-count."""
    if not sources:
        raise FleetError("no fleet sources given")
    out: Dict[int, str] = {}
    unnumbered: List[str] = []
    for src in sources:
        base = os.path.basename(src.rstrip("/")) if not _is_url(src) \
            else src
        m = re.search(r"(?:host-?|_h|\bh)(\d+)", base)
        if m:
            host = int(m.group(1))
            if host in out:
                raise FleetError(
                    f"host {host} claimed twice: {out[host]} and {src}")
            out[host] = src
        else:
            unnumbered.append(src)
    nxt = 0
    for src in unnumbered:
        while nxt in out:
            nxt += 1
        out[nxt] = src
        nxt += 1
    return dict(sorted(out.items()))


def collect(sources: Union[Dict[int, str], Sequence[str]], *,
            timeout: float = 5.0,
            now: Optional[float] = None) -> Dict[int, dict]:
    """Read every host's source. Returns host -> state dict:
    ``{"source", "up", "error", "seq", "unix", "age_s", "samples"}``.
    An unreachable host comes back ``up=0`` with the error string —
    the fleet view must render precisely when a host is sick."""
    if not isinstance(sources, dict):
        sources = resolve_sources(list(sources))
    if not sources:
        raise FleetError("no fleet sources given")
    now = time.time() if now is None else float(now)
    out: Dict[int, dict] = {}
    for host, src in sorted(sources.items()):
        st = {"source": src, "up": 1, "error": None, "seq": None,
              "unix": None, "age_s": None, "samples": []}
        try:
            text = read_source(src, timeout=timeout)
        except OSError as e:
            st["up"] = 0
            st["error"] = str(e)
            out[host] = st
            continue
        header = parse_snapshot_header(text)
        if header is not None:
            st["seq"] = header["seq"]
            st["unix"] = header["unix"]
            st["age_s"] = max(0.0, now - header["unix"])
        elif not _is_url(src):
            # a headerless FILE has only its mtime as a staleness fact
            try:
                st["age_s"] = max(0.0, now - os.path.getmtime(src))
            except OSError:
                pass
        else:
            st["age_s"] = 0.0       # a live scrape that answered IS fresh
        st["samples"] = parse_exposition(text)
        out[host] = st
    return out


def read_heartbeats(hosts_dir: str,
                    now: Optional[float] = None) -> Dict[int, dict]:
    """The hostgroup heartbeat files (``host-K.json``) as host ->
    record, each annotated with ``age_s`` (wall clock vs the record's
    own ``t``) and ``path``. Unreadable/corrupt files yield
    ``{"error": ...}`` — a torn heartbeat is a finding, not a crash."""
    now = time.time() if now is None else float(now)
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(hosts_dir)
    except OSError:
        return out
    for name in sorted(names):
        m = HEARTBEAT_FILE_RE.match(name)
        if m is None:
            continue
        host = int(m.group("host"))
        path = os.path.join(hosts_dir, name)
        try:
            with open(path) as fh:
                rec = json.load(fh)
            if not isinstance(rec, dict):
                raise ValueError("not an object")
        except (OSError, ValueError) as e:
            out[host] = {"error": str(e), "path": path}
            continue
        rec = dict(rec)
        rec["path"] = path
        t = rec.get("t")
        if isinstance(t, (int, float)):
            rec["age_s"] = max(0.0, now - float(t))
        out[host] = rec
    return out


# ---------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------

def _is_hist_component(name: str) -> bool:
    return any(name.endswith(s) for s in _HIST_SUFFIXES)


def _host_scalar(samples, name: str) -> Optional[float]:
    """One host's scalar value for a family: multi-series families
    collapse the way sample_from_prometheus does (sum counters, max
    the rest)."""
    vals = [v for n, _lbl, v in samples
            if n == name and not math.isnan(v)]
    if not vals:
        return None
    return sum(vals) if name.endswith("_total") else max(vals)


def federate(host_state: Dict[int, dict], *,
             budget: Optional[TenantLabelBudget] = None,
             heartbeats: Optional[Dict[int, dict]] = None) -> dict:
    """Fold per-host sample sets into one fleet snapshot dict:

    ``aggregate``   family -> fleet scalar (sum/max/min per the rules),
    ``per_host``    fleet family -> {host_label: value} for the
                    curated PER_HOST_SERIES plus liveness/age lanes,
    ``hosts``       host -> digest (up, seq, age_s, n_iter, gap, ...),
    ``lag``         fleet iteration lag (max - min over live hosts),
    ``slowest``     the host holding the minimum iteration count.

    ``budget`` bounds the ``host`` label exactly like tenant labels:
    out-of-budget hosts collapse into the ``other`` series (their
    values AGGREGATE — sum for counters, max for gauges)."""
    if not host_state:
        raise FleetError("no hosts collected")
    budget = budget or TenantLabelBudget(DEFAULT_TENANT_BUDGET)
    heartbeats = heartbeats or {}

    # fleet scalars
    agg: Dict[str, float] = {}
    per_family_vals: Dict[str, List[float]] = {}
    for host, st in host_state.items():
        names = {n for n, _lbl, _v in st["samples"]}
        for name in names:
            if _is_hist_component(name):
                continue
            v = _host_scalar(st["samples"], name)
            if v is not None:
                per_family_vals.setdefault(name, []).append(v)
    for name, vals in per_family_vals.items():
        how = _AGG_OVERRIDES.get(name)
        if how is None:
            if name.endswith("_total"):
                how = "sum"
            elif "age" in name:
                how = "max"
            else:
                how = "max"
        agg[name] = (sum(vals) if how == "sum"
                     else min(vals) if how == "min" else max(vals))

    # per-host labelled series, label bounded by the budget. An
    # overflowed host's values MERGE into the `other` series. One
    # resolve per host per pass: lanes of the same host must all land
    # under ONE label, and repeated touches inside a single federation
    # pass must not churn the budget's LRU (the two-touch admission is
    # calibrated for request streams, not for the ~6 series each host
    # contributes here).
    per_host: Dict[str, Dict[str, float]] = {}
    label_of = {host: budget.resolve(str(host))
                for host in sorted(host_state)}

    def _lane(family: str, host: int, value: float,
              counter: bool) -> None:
        label = label_of[host]
        lanes = per_host.setdefault(family, {})
        if label in lanes:
            lanes[label] = (lanes[label] + value if counter
                            else max(lanes[label], value))
        else:
            lanes[label] = value

    hosts: Dict[int, dict] = {}
    iters: Dict[int, float] = {}
    for host, st in sorted(host_state.items()):
        digest = {"source": st["source"], "up": st["up"],
                  "error": st["error"], "seq": st["seq"],
                  "age_s": st["age_s"]}
        _lane("dpsvm_host_up", host, float(st["up"]), False)
        if st["age_s"] is not None:
            _lane("dpsvm_host_heartbeat_age_seconds", host,
                  float(st["age_s"]), False)
        for src_name, fleet_name in PER_HOST_SERIES.items():
            v = _host_scalar(st["samples"], src_name)
            if v is None:
                continue
            _lane(fleet_name, host, v,
                  fleet_name.endswith("_total"))
            key = {"dpsvm_host_iterations": "n_iter",
                   "dpsvm_host_gap": "gap",
                   "dpsvm_host_n_sv": "n_sv",
                   "dpsvm_host_compiles_total": "compiles"}[fleet_name]
            digest[key] = v
            if fleet_name == "dpsvm_host_iterations":
                iters[host] = v
        hb = heartbeats.get(host)
        if hb and not hb.get("error"):
            for k in ("generation", "seq", "n_iter"):
                if isinstance(hb.get(k), (int, float)):
                    digest[f"hb_{k}"] = hb[k]
            if isinstance(hb.get("age_s"), (int, float)):
                digest["hb_age_s"] = hb["age_s"]
                _lane("dpsvm_host_heartbeat_age_seconds", host,
                      float(hb["age_s"]), False)
        hosts[host] = digest

    # group-generation fact for the reform-storm rule: the heartbeat
    # files carry it (hostgroup increments it at every reformation)
    gens = [hb.get("generation") for hb in heartbeats.values()
            if isinstance(hb.get("generation"), (int, float))]
    if gens:
        agg["dpsvm_fleet_generation"] = float(max(gens))

    lag = (max(iters.values()) - min(iters.values())) if len(iters) > 1 \
        else 0.0
    slowest = (min(iters, key=lambda h: (iters[h], h))
               if len(iters) > 1 else None)
    agg["dpsvm_fleet_hosts"] = float(len(host_state))
    agg["dpsvm_fleet_hosts_up"] = float(
        sum(st["up"] for st in host_state.values()))
    agg["dpsvm_fleet_iteration_lag"] = float(lag)
    return {"hosts": hosts, "aggregate": agg, "per_host": per_host,
            "lag": float(lag), "slowest": slowest}


# ---------------------------------------------------------------------
# output surfaces
# ---------------------------------------------------------------------

def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_exposition(snapshot: dict) -> str:
    """The fleet snapshot as a Prometheus text exposition — passes
    ``metrics.validate_exposition`` (pinned in tests): one TYPE line
    per family, families contiguous, counters are the ``_total``
    names."""
    lines: List[str] = []
    for name in sorted(snapshot["aggregate"]):
        kind = "counter" if name.endswith("_total") else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {_fmt(snapshot['aggregate'][name])}")
    for family in sorted(snapshot["per_host"]):
        kind = "counter" if family.endswith("_total") else "gauge"
        lines.append(f"# TYPE {family} {kind}")
        for label in sorted(snapshot["per_host"][family],
                            key=lambda s: (len(s), s)):
            v = snapshot["per_host"][family][label]
            lines.append(f'{family}{{host="{label}"}} {_fmt(v)}')
    return "\n".join(lines) + "\n"


def fleet_watch_sample(snapshot: dict) -> Dict[str, float]:
    """The watch-sample the fleet rules read (slo.py): per-host lanes
    as ``host:<k>:<metric>`` plus the fleet scalars under their
    canonical names (``generation`` feeds the reform-storm rule,
    ``n_iter`` the fleet-progress view)."""
    out: Dict[str, float] = {}
    for host, digest in snapshot["hosts"].items():
        for key in ("n_iter", "gap", "n_sv", "compiles"):
            v = digest.get(key)
            if isinstance(v, (int, float)):
                out[f"host:{host}:{key}"] = float(v)
        age = digest.get("hb_age_s", digest.get("age_s"))
        if isinstance(age, (int, float)):
            out[f"host:{host}:heartbeat_age_seconds"] = float(age)
        out[f"host:{host}:up"] = float(digest.get("up", 0))
    agg = snapshot["aggregate"]
    out["hosts"] = agg.get("dpsvm_fleet_hosts", 0.0)
    out["hosts_up"] = agg.get("dpsvm_fleet_hosts_up", 0.0)
    out["iteration_lag"] = agg.get("dpsvm_fleet_iteration_lag", 0.0)
    out["generation"] = agg.get("dpsvm_fleet_generation", 0.0)
    if "dpsvm_train_iterations" in agg:
        out["n_iter"] = agg["dpsvm_train_iterations"]
    return out


def render_fleet_table(snapshot: dict) -> str:
    """The human `dpsvm fleet` surface: one row per host — progress,
    lag behind the group's fastest member, staleness, liveness — with
    the slowest host marked. Degrades gracefully when a lane is
    missing (an unreachable host still gets its row; that row IS the
    finding)."""
    iters = {h: d.get("n_iter") for h, d in snapshot["hosts"].items()
             if isinstance(d.get("n_iter"), (int, float))}
    fastest = max(iters.values()) if iters else None
    rows = [("host", "up", "iter", "lag", "gap", "hb-age", "seq",
             "source")]
    for host in sorted(snapshot["hosts"]):
        d = snapshot["hosts"][host]
        it = d.get("n_iter")
        lag = (f"{fastest - it:g}" if isinstance(it, (int, float))
               and fastest is not None else "-")
        age = d.get("hb_age_s", d.get("age_s"))
        mark = " <- slowest" if host == snapshot["slowest"] else ""
        rows.append((
            str(host), str(d.get("up", "?")),
            f"{it:g}" if isinstance(it, (int, float)) else "-", lag,
            f"{d['gap']:.3g}" if isinstance(d.get("gap"),
                                            (int, float)) else "-",
            f"{age:.1f}s" if isinstance(age, (int, float)) else "-",
            str(d.get("seq", d.get("hb_seq", "-")) or "-"),
            str(d.get("source", "-")) + mark))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    out = []
    for r in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths))
                   .rstrip())
    out.append(f"fleet: {int(snapshot['aggregate'].get('dpsvm_fleet_hosts', 0))} "
               f"host(s), iteration lag {snapshot['lag']:g}"
               + (f", slowest host {snapshot['slowest']}"
                  if snapshot["slowest"] is not None else ""))
    return "\n".join(out)


# ---------------------------------------------------------------------
# incident-bundle artifact collection
# ---------------------------------------------------------------------

def host_artifacts(trace_dir: Optional[str] = None,
                   hosts_dir: Optional[str] = None, *,
                   tail_lines: int = 40,
                   now: Optional[float] = None) -> Dict[int, dict]:
    """Every host's forensic artifacts for a fleet incident bundle
    (blackbox.dump_bundle ``host_artifacts=``): per host a dict of
    ``heartbeat`` (the parsed heartbeat record), ``trace_tail`` (the
    last lines of its newest trace file) and ``doctor`` (a one-host
    liveness diagnosis line). Best-effort per host — a dead host's
    missing pieces must not block bundling the survivors' evidence."""
    out: Dict[int, dict] = {}
    hbs = read_heartbeats(hosts_dir, now=now) if hosts_dir else {}
    fams: Dict[int, str] = {}
    if trace_dir:
        from dpsvm_tpu_torch.observability import merge
        fams = merge.discover_family(trace_dir)
    for host in sorted(set(hbs) | set(fams)):
        art: dict = {}
        hb = hbs.get(host)
        if hb is not None:
            art["heartbeat"] = hb
        path = fams.get(host)
        if path:
            try:
                with open(path) as fh:
                    art["trace_tail"] = fh.readlines()[-tail_lines:]
                art["trace_path"] = path
            except OSError:
                pass
        lines = [f"host {host}:"]
        if hb is None:
            lines.append("  heartbeat: MISSING")
        elif hb.get("error"):
            lines.append(f"  heartbeat: UNREADABLE ({hb['error']})")
        else:
            age = hb.get("age_s")
            lines.append(
                f"  heartbeat: n_iter={hb.get('n_iter')} "
                f"seq={hb.get('seq')} "
                f"generation={hb.get('generation')} "
                f"age={age:.1f}s" if isinstance(age, (int, float))
                else f"  heartbeat: n_iter={hb.get('n_iter')} "
                     f"seq={hb.get('seq')}")
        lines.append(f"  trace: {os.path.basename(path) if path else 'MISSING'}")
        art["doctor"] = "\n".join(lines) + "\n"
        out[host] = art
    return out
