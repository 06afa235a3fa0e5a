"""Black-box flight recorder + incident bundles (port of
``dpsvm_tpu/observability/blackbox.py``).

The postmortem problem this closes: when a production run degrades —
a 504 storm, a stagnant gap, a watchdog stall — the rich artifacts
(traces, metrics, ledger rows) either were not armed or describe the
whole run, not the minutes that mattered.

``FlightRecorder`` is a bounded, in-process ring of the most recent
trace-shaped records (chunk/event/compile/span), metrics snapshots and
its own manifest — fed for free from the paths that already hold every
fact on the host (the driver's packed-stats polls, the serving
server's event/span emission), so recording costs ZERO additional
device->host transfers and bounded memory regardless of run length.

When an alert rule fires (observability/slo.py), a divergence guard
trips, or an emergency exit path runs, ``dump_bundle`` writes a
self-contained incident directory:

    incident-<stamp>-<rule>/
      incident.json        manifest: rule, severity, window, reason,
                           fired-at time, git sha, file inventory
      trace.jsonl          the ring contents as a VALID schema-v3
                           trace (manifest + records + synthesized
                           summary) — `dpsvm report` renders it,
                           `validate_trace` accepts it
      metrics.prom         Prometheus text exposition at dump time
      metrics.json         the JSON snapshot twin
      doctor.txt           host-side environment facts (never inits
                           CUDA: device facts only when this process
                           has already initialized it)
      tuned_profile.json   the active tuned-profile entry (none until
                           the tuning layer is ported, ROADMAP item 13c)
      perf_ledger.jsonl    the relevant perf-ledger context rows
                           (tail), when a ledger is configured

``validate_bundle`` and ``render_bundle`` (the incident header and the
embedded trace's report) back the ``bundle`` CLI.

Like the schema module this file is dependency-free (stdlib only) and
never initializes a backend.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from dpsvm_tpu_torch.observability.schema import (MANIFEST_KEYS, SUMMARY_KEYS,
                                            TRACE_SCHEMA_VERSION,
                                            read_trace, validate_trace)

#: incident.json schema version
BUNDLE_SCHEMA = 1

#: files every bundle must carry (tuned_profile / perf_ledger are
#: best-effort context: present when the source exists)
BUNDLE_REQUIRED_FILES = ("incident.json", "trace.jsonl",
                         "metrics.prom", "metrics.json", "doctor.txt")

INCIDENT_KEYS = ("schema", "rule", "severity", "window", "reason",
                 "time", "t", "git_sha", "files")

_DUMP_LOCK = threading.Lock()
_DUMP_SEQ = 0

# Emergency registry: (recorder, bundle_dir, registry) tuples armed by
# the driver / serving server so exit paths that bypass their finally
# blocks (the stall watchdog's os._exit) can still land a bundle —
# record.flush_open_traces calls dump_emergency right before dying.
_EMERGENCY: List[tuple] = []
_EMERGENCY_LOCK = threading.Lock()


def make_manifest(*, solver: str, n: int = 0, d: int = 0,
                  gamma: float = 0.0, config: Optional[dict] = None,
                  env: Optional[dict] = None) -> dict:
    """A schema-v3 trace manifest for the ring (same shape the
    RunTrace recorder writes — observability/record.py — so the dumped
    trace validates and renders through the ordinary tooling)."""
    config = dict(config or {})
    try:
        from dpsvm_tpu_torch import __version__
    except Exception:               # pragma: no cover — import cycle
        __version__ = "0"
    man = {
        "kind": "manifest",
        "schema": TRACE_SCHEMA_VERSION,
        "version": __version__,
        "solver": str(solver),
        "n": int(n), "d": int(d), "gamma": float(gamma),
        "kernel": {"kind": config.get("kernel", "rbf"),
                   "gamma": float(gamma),
                   "coef0": float(config.get("coef0", 0.0)),
                   "degree": int(config.get("degree", 3))},
        "mesh": {"shards": int(config.get("shards", 1)),
                 "shard_x": bool(config.get("shard_x", True))},
        "env": dict(env or {"backend": None, "device_kind": None,
                            "device_count": None}),
        "config": config,
        "it0": 0,
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    missing = [k for k in MANIFEST_KEYS if k not in man]
    assert not missing, f"manifest shape drifted: missing {missing}"
    return man


class FlightRecorder:
    """Bounded ring of recent trace-shaped records + metrics
    snapshots. The record methods mirror RunTrace's signatures
    (observability/record.py) so ``TeeTrace`` can forward one call to
    both sinks; every append is host-side dict work under one lock."""

    def __init__(self, manifest: dict, *, capacity: int = 512,
                 snapshot_capacity: int = 8):
        self.manifest = dict(manifest)
        self._ring: deque = deque(maxlen=int(capacity))
        self._snapshots: deque = deque(maxlen=int(snapshot_capacity))
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._last_t = 0.0
        self._closed = False
        self._final_summary: Optional[dict] = None

    # -- clock --------------------------------------------------------

    def _t(self) -> float:
        # monotone even across clock hiccups: the schema's t-ordering
        # rule is part of the dumped trace's validity
        t = round(time.perf_counter() - self._t0, 6)
        with self._lock:
            t = max(t, self._last_t)
            self._last_t = t
            return t

    def _append(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)

    # -- RunTrace-shaped producers ------------------------------------

    def chunk(self, *, n_iter: int, b_lo: float, b_hi: float,
              n_sv: int = 0, cache_hits: int = 0, cache_misses: int = 0,
              rounds: int = 0, phases: Optional[Dict] = None,
              phase_counts: Optional[Dict] = None,
              hbm: Optional[dict] = None, **extra) -> None:
        rec = {"kind": "chunk", "n_iter": int(n_iter),
               "b_lo": float(b_lo), "b_hi": float(b_hi),
               "gap": float(b_lo) - float(b_hi), "n_sv": int(n_sv),
               "cache_hits": int(cache_hits),
               "cache_misses": int(cache_misses), "rounds": int(rounds),
               "t": self._t(),
               "phases": {k: round(float(v), 6)
                          for k, v in (phases or {}).items()},
               "phase_counts": {k: int(v)
                                for k, v in (phase_counts or {}).items()},
               "hbm": dict(hbm) if hbm else {"in_use": None,
                                             "peak": None,
                                             "limit": None}}
        rec.update(extra)
        self._append(rec)

    def event(self, event: str, *, n_iter: int = 0, **extra) -> None:
        rec = {"kind": "event", "event": str(event),
               "n_iter": int(n_iter), "t": self._t()}
        rec.update(extra)
        self._append(rec)

    def compile(self, *, program: str, seconds: float,
                signature=None, flops=None, bytes=None,
                n_iter: int = 0, **extra) -> None:
        rec = {"kind": "compile", "program": str(program),
               "seconds": round(float(seconds), 6),
               "signature": signature,
               "flops": float(flops) if flops is not None else None,
               "bytes": float(bytes) if bytes is not None else None,
               "n_iter": int(n_iter), "t": self._t()}
        rec.update(extra)
        self._append(rec)

    def span(self, *, trace_id, span_id: int, parent, name: str,
             t_start: float, t_end: float, **extra) -> None:
        # same rebase the RunTrace recorder does: absolute
        # perf_counter readings onto the recorder's clock
        rel0 = round(float(t_start) - self._t0, 6)
        rel1 = round(float(t_end) - self._t0, 6)
        rec = {"kind": "span", "trace_id": trace_id,
               "span_id": int(span_id),
               "parent": int(parent) if parent is not None else None,
               "name": str(name), "t_start": rel0, "t_end": rel1,
               "t": self._t()}
        rec.update(extra)
        self._append(rec)

    def summary(self, **kw) -> None:
        # a live recorder never holds a summary (the dump synthesizes
        # one); the final summary of a finished run is kept as the
        # dump's source of truth instead of a ring record, so a bundle
        # dumped mid-run stays valid
        with self._lock:
            self._final_summary = dict(kw)

    def snapshot_metrics(self, registry) -> None:
        """Park one metrics snapshot (JSON dict + text exposition) in
        the snapshot ring — called at alert transitions and dump time;
        never raises into the caller."""
        try:
            snap = {"t": self._t(),
                    "json": registry.snapshot(),
                    "prometheus": registry.render_prometheus()}
            with self._lock:
                self._snapshots.append(snap)
        except Exception:
            pass

    # -- ring views ---------------------------------------------------

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def last_snapshot(self) -> Optional[dict]:
        with self._lock:
            return self._snapshots[-1] if self._snapshots else None

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True

    # -- the dumped trace ---------------------------------------------

    def trace_records(self) -> List[dict]:
        """Manifest + ring contents + a synthesized summary — a
        self-contained, schema-valid v3 trace of the recent past.

        A ring is a LEFT-truncated slice of the run's record stream,
        so anything ordering-sensitive whose opening record fell off
        the edge is dropped rather than emitted invalid: span groups
        whose root (or a parent) was truncated away, and cascade
        stage events whose predecessor stage is gone (``polish``
        before any ``screen`` in the slice, ``readmit`` before any
        ``polish``). Chunk n_iter monotonicity survives truncation by
        construction — the ring drops oldest-first, and every rewind
        event rides between the chunks it separates."""
        recs = _sanitize_slice(self.records())
        last_t = max([r.get("t", 0.0) for r in recs] + [0.0])
        last_chunk = None
        for r in recs:
            if r.get("kind") == "chunk":
                last_chunk = r
        summary = {
            "kind": "summary", "converged": False,
            "n_iter": int((last_chunk or {}).get("n_iter", 0)),
            "iters": int((last_chunk or {}).get("n_iter", 0)),
            "iters_per_sec": 0.0,
            "b": 0.0,
            "b_lo": float((last_chunk or {}).get("b_lo", 0.0)),
            "b_hi": float((last_chunk or {}).get("b_hi", 0.0)),
            "gap": float((last_chunk or {}).get("gap", 0.0)),
            "n_sv": int((last_chunk or {}).get("n_sv", 0)),
            "cache_hits": int((last_chunk or {}).get("cache_hits", 0)),
            "cache_misses": int((last_chunk or {})
                                .get("cache_misses", 0)),
            "cache_hit_rate": None,
            "train_seconds": round(last_t, 6),
            "phases": dict((last_chunk or {}).get("phases", {})),
            "phase_counts": dict((last_chunk or {})
                                 .get("phase_counts", {})),
            "n_compiles": sum(1 for r in recs
                              if r.get("kind") == "compile"),
            "compile_seconds": round(
                sum(r.get("seconds", 0.0) for r in recs
                    if r.get("kind") == "compile"), 6),
            "hbm_peak": None,
            "est_flops": None,
            "est_bytes": None,
            "flight_recorder": True,    # honesty marker: a ring slice,
            "t": last_t,                # not a whole-run summary
        }
        missing = [k for k in SUMMARY_KEYS if k not in summary]
        assert not missing, f"summary shape drifted: missing {missing}"
        return [dict(self.manifest)] + recs + [summary]


def _sanitize_slice(recs: List[dict]) -> List[dict]:
    """Drop records a left-truncated ring cannot emit validly (see
    FlightRecorder.trace_records)."""
    # span groups: keep only requests whose root AND every referenced
    # parent survived the truncation
    by_trace: Dict[object, List[dict]] = {}
    for r in recs:
        if r.get("kind") == "span":
            by_trace.setdefault(r.get("trace_id"), []).append(r)
    bad_traces = set()
    for tid, group in by_trace.items():
        ids = {g.get("span_id") for g in group}
        roots = [g for g in group if g.get("parent") is None]
        if len(roots) != 1 or any(
                g.get("parent") is not None and g["parent"] not in ids
                for g in group):
            bad_traces.add(tid)
    out: List[dict] = []
    saw_screen = saw_polish = False
    for r in recs:
        kind = r.get("kind")
        if kind == "span" and r.get("trace_id") in bad_traces:
            continue
        if kind == "event":
            ev = r.get("event")
            if ev == "screen":
                saw_screen = True
            elif ev == "polish":
                if not saw_screen:
                    continue
                saw_polish = True
            elif ev == "readmit" and not saw_polish:
                continue
        out.append(r)
    return out


class TeeTrace:
    """Quacks like a RunTrace for the driver's call sites, forwarding
    every record to the file trace (when one is armed) AND the flight
    recorder — so watching a run records its black box without a
    second producer at any call site. ``file_trace`` may be None
    (watch armed, ``--trace-out`` not)."""

    def __init__(self, file_trace, flight: FlightRecorder):
        self._file = file_trace
        self._flight = flight

    def _both(self, method: str, *a, **kw):
        if self._file is not None:
            getattr(self._file, method)(*a, **kw)
        try:
            getattr(self._flight, method)(*a, **kw)
        except Exception:
            pass                # the black box must never kill the run

    def chunk(self, **kw):
        self._both("chunk", **kw)

    def event(self, event, **kw):
        self._both("event", event, **kw)

    def compile(self, **kw):
        self._both("compile", **kw)

    def span(self, **kw):
        self._both("span", **kw)

    def summary(self, **kw):
        self._both("summary", **kw)

    @property
    def path(self):
        return self._file.path if self._file is not None else None

    @property
    def closed(self) -> bool:
        return (self._file.closed if self._file is not None
                else self._flight.closed)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        self._flight.close()


# ---------------------------------------------------------------------
# bundle dump
# ---------------------------------------------------------------------

def _slug(s: str) -> str:
    out = "".join(c if c.isalnum() or c in "-_" else "-"
                  for c in str(s))
    return out.strip("-")[:48] or "incident"


def _doctor_text() -> str:
    """Host-side environment facts for the bundle — a bounded,
    never-blocking subset of ``dpsvm doctor``: this runs inside a
    degrading process, so it must not initialize a backend, touch a
    device, or wait on anything."""
    import platform

    lines = [f"dpsvm bundle doctor ("
             f"{time.strftime('%Y-%m-%dT%H:%M:%S%z')})"]
    try:
        from dpsvm_tpu_torch import __version__
        lines.append(f"dpsvm: {__version__}")
    except Exception:
        pass
    lines.append(f"python: {platform.python_version()} "
                 f"({sys.platform})")
    lines.append(f"host: {platform.node()}")
    # device facts ONLY when the backend is already up in this
    # process (a dictionary read) — never an init from a bundle dump
    th = sys.modules.get("torch")
    if th is not None and th.cuda.is_initialized():
        try:
            n = th.cuda.device_count()
            lines.append(f"backend: cuda x{n} "
                         f"({th.cuda.get_device_name(0)})")
        except Exception as e:
            lines.append(f"backend: unreadable ({e})")
    else:
        lines.append("backend: not initialized in this process")
    try:
        import shutil
        usage = shutil.disk_usage(os.getcwd())
        lines.append(f"disk: {usage.free / 1e9:.2f} GB free of "
                     f"{usage.total / 1e9:.2f} GB at {os.getcwd()}")
    except OSError:
        pass
    faults = sorted(k for k in os.environ
                    if k.startswith(("DPSVM_FAULT_", "BENCH_FAULT_")))
    if faults:
        lines.append("armed fault injections: " + ", ".join(
            f"{k}={os.environ[k]}" for k in faults))
    return "\n".join(lines) + "\n"


def _tuned_profile_entry() -> Optional[dict]:
    """The active tuned-profile entry: none until the tuning layer is
    ported (ROADMAP item 13c)."""
    return None


def _ledger_tail(limit: int = 25) -> List[dict]:
    try:
        from dpsvm_tpu_torch.observability import ledger
        path = ledger.ledger_path()
        if path is None or not os.path.exists(path):
            return []
        return ledger.read(path)[-limit:]
    except Exception:
        return []


def _git_sha() -> Optional[str]:
    try:
        from dpsvm_tpu_torch.observability.ledger import git_sha
        return git_sha()
    except Exception:
        return None


def dump_bundle(out_dir: str, *, recorder: FlightRecorder,
                rule: str, severity: str, window: str, reason: str,
                registry=None, extra: Optional[dict] = None,
                host_artifacts: Optional[Dict[int, dict]] = None
                ) -> str:
    """Write one self-contained incident bundle; returns its
    directory. Never raises — a failed dump logs to stderr and
    returns "" (the incident response must not take the producer
    down with it).

    ``host_artifacts`` makes this a FLEET bundle (docs/OBSERVABILITY.md
    "Fleet"): host id -> ``{"heartbeat": dict, "trace_tail": [lines],
    "doctor": str}`` (observability/fleet.host_artifacts collects it),
    landing as ``host-<k>-heartbeat.json`` / ``host-<k>-trace-tail
    .jsonl`` / ``host-<k>-doctor.txt`` entries in the file inventory —
    so one bundle carries every group member's last words, not just
    the dumping process's own ring."""
    global _DUMP_SEQ
    try:
        with _DUMP_LOCK:
            _DUMP_SEQ += 1
            seq = _DUMP_SEQ
        stamp = time.strftime("%Y%m%d-%H%M%S")
        name = f"incident-{stamp}-{seq:03d}-{_slug(rule)}"
        path = os.path.join(out_dir, name)
        os.makedirs(path, exist_ok=True)

        # 1. the black-box trace
        trace_path = os.path.join(path, "trace.jsonl")
        with open(trace_path, "w") as fh:
            for rec in recorder.trace_records():
                fh.write(json.dumps(rec) + "\n")

        # 2. metrics at dump time (live registry preferred; the last
        # ring snapshot as fallback)
        snap_json, snap_prom = {}, ""
        if registry is not None:
            try:
                snap_json = registry.snapshot()
                snap_prom = registry.render_prometheus()
            except Exception:
                pass
        if not snap_prom:
            last = recorder.last_snapshot()
            if last is not None:
                snap_json = last["json"]
                snap_prom = last["prometheus"]
        with open(os.path.join(path, "metrics.json"), "w") as fh:
            json.dump(snap_json, fh, indent=1)
        with open(os.path.join(path, "metrics.prom"), "w") as fh:
            fh.write(snap_prom)

        # 3. doctor facts
        with open(os.path.join(path, "doctor.txt"), "w") as fh:
            fh.write(_doctor_text())

        files = {"trace": "trace.jsonl",
                 "metrics_prometheus": "metrics.prom",
                 "metrics_json": "metrics.json",
                 "doctor": "doctor.txt"}

        # 4. context: tuned profile + perf-ledger tail (best-effort)
        entry = _tuned_profile_entry()
        if entry is not None:
            with open(os.path.join(path, "tuned_profile.json"),
                      "w") as fh:
                json.dump(entry, fh, indent=1)
            files["tuned_profile"] = "tuned_profile.json"
        tail = _ledger_tail()
        if tail:
            with open(os.path.join(path, "perf_ledger.jsonl"),
                      "w") as fh:
                for rec in tail:
                    fh.write(json.dumps(rec) + "\n")
            files["perf_ledger"] = "perf_ledger.jsonl"

        # 4b. per-host artifacts (fleet bundles): written before the
        # manifest so a listed file always exists
        for hid in sorted(host_artifacts or {}):
            art = host_artifacts[hid]
            if not isinstance(art, dict):
                continue
            if art.get("heartbeat") is not None:
                fname = f"host-{hid}-heartbeat.json"
                with open(os.path.join(path, fname), "w") as fh:
                    json.dump(art["heartbeat"], fh, indent=1)
                files[f"host_{hid}_heartbeat"] = fname
            tail_lines = art.get("trace_tail")
            if tail_lines:
                fname = f"host-{hid}-trace-tail.jsonl"
                with open(os.path.join(path, fname), "w") as fh:
                    for line in tail_lines:
                        fh.write(line if line.endswith("\n")
                                 else line + "\n")
                files[f"host_{hid}_trace_tail"] = fname
            if art.get("doctor"):
                fname = f"host-{hid}-doctor.txt"
                with open(os.path.join(path, fname), "w") as fh:
                    fh.write(str(art["doctor"]))
                files[f"host_{hid}_doctor"] = fname

        # 5. the manifest, written LAST: an incident.json implies a
        # complete bundle
        incident = {
            "schema": BUNDLE_SCHEMA,
            "rule": str(rule),
            "severity": str(severity),
            "window": str(window),
            "reason": str(reason),
            "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "t": round(time.time(), 3),
            "git_sha": _git_sha(),
            "files": files,
        }
        if extra:
            incident.update(extra)
        with open(os.path.join(path, "incident.json"), "w") as fh:
            json.dump(incident, fh, indent=1)
        print(f"INCIDENT: rule {rule!r} ({severity}) -> bundle {path}",
              file=sys.stderr, flush=True)
        return path
    except Exception as e:          # pragma: no cover — disk death
        print(f"WARNING: incident bundle dump failed: {e}",
              file=sys.stderr, flush=True)
        return ""


# ---------------------------------------------------------------------
# emergency dumps (watchdog stall / hard exits)
# ---------------------------------------------------------------------

def arm_emergency(recorder: FlightRecorder, bundle_dir: str,
                  registry=None) -> None:
    """Register a recorder for the emergency path: exit routes that
    bypass the owner's finally block (the stall watchdog's os._exit)
    call ``dump_emergency`` and every armed recorder lands a bundle."""
    with _EMERGENCY_LOCK:
        _EMERGENCY.append((recorder, bundle_dir, registry))


def disarm_emergency(recorder: FlightRecorder) -> None:
    with _EMERGENCY_LOCK:
        _EMERGENCY[:] = [e for e in _EMERGENCY if e[0] is not recorder]


def dump_emergency(reason: str) -> int:
    """Best-effort bundle per armed recorder; returns how many were
    dumped. Called from record.flush_open_traces — microseconds before
    an os._exit, so everything is try/except best-effort."""
    with _EMERGENCY_LOCK:
        armed = list(_EMERGENCY)
        _EMERGENCY[:] = []
    n = 0
    for recorder, bundle_dir, registry in armed:
        try:
            recorder.event(reason)
            if dump_bundle(bundle_dir, recorder=recorder,
                           rule=reason, severity="page",
                           window="emergency", reason=reason,
                           registry=registry):
                n += 1
        except Exception:
            pass
    return n


# ---------------------------------------------------------------------
# bundle validation + rendering (the `dpsvm bundle` CLI)
# ---------------------------------------------------------------------

def resolve_bundle_dir(path: str) -> str:
    """Accept a bundle directory OR a parent --bundle-dir: the newest
    ``incident-*`` child wins (mirrors resolve_trace_path's
    newest-artifact convention)."""
    if os.path.isfile(os.path.join(path, "incident.json")):
        return path
    children = sorted(
        (c for c in os.listdir(path)
         if c.startswith("incident-")
         and os.path.isfile(os.path.join(path, c, "incident.json"))),
        key=lambda c: os.path.getmtime(os.path.join(path, c)))
    if not children:
        raise FileNotFoundError(
            f"{path}: neither an incident bundle (no incident.json) "
            "nor a directory containing incident-* bundles")
    return os.path.join(path, children[-1])


def load_incident(bundle_dir: str) -> dict:
    with open(os.path.join(bundle_dir, "incident.json")) as fh:
        return json.load(fh)


def validate_bundle(bundle_dir: str) -> List[str]:
    """Full bundle check; returns problems (empty = valid): the
    incident manifest parses and carries its required keys, every
    required file exists, the embedded trace passes ``validate_trace``
    and the metrics exposition passes the Prometheus grammar
    validator."""
    problems: List[str] = []
    inc_path = os.path.join(bundle_dir, "incident.json")
    try:
        with open(inc_path) as fh:
            incident = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return [f"incident.json unreadable: {e}"]
    missing = [k for k in INCIDENT_KEYS if k not in incident]
    if missing:
        problems.append(f"incident.json missing keys {missing}")
    if incident.get("severity") not in ("warn", "page"):
        problems.append("incident.json severity must be warn|page, "
                        f"got {incident.get('severity')!r}")
    for fname in BUNDLE_REQUIRED_FILES:
        if not os.path.isfile(os.path.join(bundle_dir, fname)):
            problems.append(f"missing required file {fname}")
    for key, fname in (incident.get("files") or {}).items():
        if not os.path.isfile(os.path.join(bundle_dir, fname)):
            problems.append(f"files[{key!r}] names missing {fname}")
    trace_path = os.path.join(bundle_dir, "trace.jsonl")
    if os.path.isfile(trace_path):
        try:
            records = read_trace(trace_path)
            errs = validate_trace(records)
            problems += [f"trace.jsonl: {e}" for e in errs]
        except ValueError as e:
            problems.append(f"trace.jsonl unreadable: {e}")
    prom_path = os.path.join(bundle_dir, "metrics.prom")
    if os.path.isfile(prom_path):
        from dpsvm_tpu_torch.observability.metrics import validate_exposition
        with open(prom_path) as fh:
            text = fh.read()
        if text.strip():
            problems += [f"metrics.prom: {e}"
                         for e in validate_exposition(text)]
    json_path = os.path.join(bundle_dir, "metrics.json")
    if os.path.isfile(json_path):
        try:
            with open(json_path) as fh:
                json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            problems.append(f"metrics.json unreadable: {e}")
    return problems


def render_bundle(bundle_dir: str) -> str:
    """Human rendering of one bundle: the incident header plus the
    embedded trace's report (observability/report.py)."""
    incident = load_incident(bundle_dir)
    lines = [
        f"incident bundle: {bundle_dir}",
        f"  rule:     {incident.get('rule')} "
        f"[{incident.get('severity')}]",
        f"  window:   {incident.get('window')}",
        f"  reason:   {incident.get('reason')}",
        f"  time:     {incident.get('time')}  "
        f"(git {str(incident.get('git_sha') or 'unknown')[:12]})",
        f"  files:    " + ", ".join(
            sorted((incident.get("files") or {}).values())),
    ]
    trace_path = os.path.join(bundle_dir, "trace.jsonl")
    if os.path.isfile(trace_path):
        try:
            records = read_trace(trace_path)
            from dpsvm_tpu_torch.observability.report import render_report
            lines.append("")
            lines.append("embedded trace:")
            lines.extend("  " + ln
                         for ln in render_report(records).splitlines())
        except (ValueError, OSError) as e:
            lines.append(f"  trace: unrenderable ({e})")
    return "\n".join(lines)
