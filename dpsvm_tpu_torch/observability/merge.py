"""Cross-host trace merge: N per-host traces -> one fleet trace (port of
``dpsvm_tpu/observability/merge.py``).

A multi-host run (resilience/hostgroup.py) writes one trace a host, the
``trace_h{K}_a{N}.jsonl`` family, and each file's ``t`` axis starts at its
own process's start (observability/record.py: ``t = perf_counter() -
t0``). ``merge_traces`` puts the records of every host on one timeline,
tags each with its ``host``, and returns one schema-v5 trace
(``schema.FLEET_SCHEMA_VERSION``) that ``validate_trace`` accepts and
``report`` renders with a lane a host (``report.host_lanes``).

Clock alignment, per host against the lowest host id, best anchor first:

1. the manifests' ``unix`` stamps (``time.time()`` where ``t`` starts):
   exact on hosts that share a wall clock, and the one anchor a straggler
   cannot contaminate, since its lateness survives a wall-clock offset;
2. matched chunk records: ranks of one group step the same ``n_iter``
   schedule in lockstep, so the median of ``t_ref(n) - t_k(n)`` over the
   common ``n_iter`` values (the median keeps a straggler's publish delay
   out);
3. matched ``host_lost`` / ``reform`` events, by occurrence;
4. the manifests' ``time`` stamps (1 s resolution).

Traces merge only when their manifests agree on the run fingerprint
(solver, n, d, gamma, kernel): merging two runs is a ``MergeError``. In
the merged stream span ``trace_id``s gain an ``h{K}:`` prefix, and each
host's summary becomes a ``host_summary`` event beside one synthesized
fleet summary (converged = every host converged; n_iter and
train_seconds the group's largest).

Stdlib only: ``report`` on a merged family runs on a machine with no
card. The same records as the JAX package's merge, field for field
(``tests/test_torch_fleet_obs.py``).
"""

from __future__ import annotations

import json
import os
import re
import statistics
import time
from typing import Dict, List, Optional, Sequence, Union

from dpsvm_tpu_torch.observability.schema import (FLEET_SCHEMA_VERSION,
                                                  SUMMARY_KEYS, read_trace)

#: the host-group drills' per-host trace naming (resilience/hostgroup.py)
TRACE_FAMILY_RE = re.compile(
    r"^trace_h(?P<host>\d+)(?:_a(?P<attempt>\d+))?\.jsonl$")

#: manifest keys two traces must agree on to be the same run
FINGERPRINT_KEYS = ("solver", "n", "d", "gamma", "kernel")

#: events matchable by occurrence index as cross-host clock anchors
ANCHOR_EVENTS = ("host_lost", "reform")


class MergeError(ValueError):
    """The trace family cannot be merged: mismatched run fingerprints,
    a record stream with no manifest, or no traces at all."""


def discover_family(dir_path: str) -> Dict[int, str]:
    """Map host id -> newest per-host trace path under ``dir_path``.

    "Newest" is the highest attempt number (``_a{N}``; a bare
    ``trace_h{K}.jsonl`` counts as attempt 0) — after a reformation
    the surviving hosts' a1 traces carry the recovery story, while the
    dead host keeps only its a0 trace. Returns {} when the directory
    holds no family members (callers decide whether that is an
    error)."""
    best: Dict[int, tuple] = {}
    try:
        names = os.listdir(dir_path)
    except OSError:
        return {}
    for name in names:
        m = TRACE_FAMILY_RE.match(name)
        if not m:
            continue
        host = int(m.group("host"))
        attempt = int(m.group("attempt") or 0)
        if host not in best or attempt > best[host][0]:
            best[host] = (attempt, os.path.join(dir_path, name))
    return {h: p for h, (_a, p) in sorted(best.items())}


def fingerprint(manifest: dict) -> dict:
    return {k: manifest.get(k) for k in FINGERPRINT_KEYS}


def _manifest_epoch(manifest: dict) -> Optional[float]:
    """The manifest ``time`` stamp as a unix epoch (None when
    unparseable) — the coarse clock-alignment fallback."""
    raw = str(manifest.get("time") or "")
    for fmt in ("%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%dT%H:%M:%S"):
        try:
            st = time.strptime(raw, fmt)
        except ValueError:
            continue
        try:
            return time.mktime(st) - (st.tm_gmtoff or 0) \
                if fmt.endswith("%z") else time.mktime(st)
        except (OverflowError, ValueError):
            return None
    return None


def _chunk_anchors(records: Sequence[dict]) -> Dict[int, float]:
    """First chunk ``t`` per ``n_iter`` value."""
    out: Dict[int, float] = {}
    for r in records:
        if r.get("kind") != "chunk":
            continue
        n, t = r.get("n_iter"), r.get("t")
        if isinstance(n, int) and isinstance(t, (int, float)) \
                and n not in out:
            out[n] = float(t)
    return out


def _event_anchors(records: Sequence[dict]) -> Dict[tuple, float]:
    """``t`` per (event name, occurrence index) for ANCHOR_EVENTS."""
    counts: Dict[str, int] = {}
    out: Dict[tuple, float] = {}
    for r in records:
        if r.get("kind") != "event" or r.get("event") not in ANCHOR_EVENTS:
            continue
        ev, t = str(r["event"]), r.get("t")
        idx = counts.get(ev, 0)
        counts[ev] = idx + 1
        if isinstance(t, (int, float)):
            out[(ev, idx)] = float(t)
    return out


def align_offsets(traces: Dict[int, List[dict]]) -> Dict[int, float]:
    """Per-host clock offsets onto the reference (lowest host id)
    timeline: ``t_fleet = t_host + offset``. Anchor preference per the
    module docstring; a host sharing no anchor at all with the
    reference gets offset 0.0 (already honest — there is nothing to
    align against)."""
    ref = min(traces)
    ref_chunks = _chunk_anchors(traces[ref])
    ref_events = _event_anchors(traces[ref])
    ref_epoch = _manifest_epoch(traces[ref][0])
    ref_unix = traces[ref][0].get("unix")
    offsets: Dict[int, float] = {ref: 0.0}
    for host, records in traces.items():
        if host == ref:
            continue
        unix = records[0].get("unix")
        if isinstance(unix, (int, float)) \
                and isinstance(ref_unix, (int, float)):
            offsets[host] = float(unix) - float(ref_unix)
            continue
        chunks = _chunk_anchors(records)
        common = sorted(set(ref_chunks) & set(chunks))
        if common:
            offsets[host] = statistics.median(
                ref_chunks[n] - chunks[n] for n in common)
            continue
        events = _event_anchors(records)
        shared = sorted(set(ref_events) & set(events))
        if shared:
            offsets[host] = statistics.median(
                ref_events[k] - events[k] for k in shared)
            continue
        epoch = _manifest_epoch(records[0])
        if ref_epoch is not None and epoch is not None:
            offsets[host] = epoch - ref_epoch
        else:
            offsets[host] = 0.0
    return offsets


def _check_fingerprints(traces: Dict[int, List[dict]]) -> None:
    for host, records in traces.items():
        if not records or records[0].get("kind") != "manifest":
            raise MergeError(
                f"host {host}: trace does not start with a manifest "
                "record — not a run trace")
    ref = min(traces)
    want = fingerprint(traces[ref][0])
    bad = []
    for host in sorted(traces):
        got = fingerprint(traces[host][0])
        if got != want:
            fields = sorted(k for k in FINGERPRINT_KEYS
                            if got.get(k) != want.get(k))
            bad.append(f"host {host} differs on {fields} "
                       f"({ {k: got[k] for k in fields} } vs "
                       f"{ {k: want[k] for k in fields} })")
    if bad:
        raise MergeError(
            "refusing to merge traces of different runs: "
            + "; ".join(bad))


def _demote_summary(summary: dict, host: int) -> dict:
    """A host's own summary as a ``host_summary`` event record — the
    merged trace keeps exactly one (synthesized) summary."""
    rec = {"kind": "event", "event": "host_summary", "host": host,
           "n_iter": int(summary.get("n_iter", 0) or 0),
           "t": summary.get("t", 0.0)}
    for k in ("converged", "iters", "iters_per_sec", "gap", "n_sv",
              "train_seconds"):
        if k in summary:
            rec[k] = summary[k]
    return rec


def merge_traces(traces: Dict[int, List[dict]],
                 sources: Optional[Dict[int, str]] = None) -> List[dict]:
    """Merge per-host record streams into one schema-v5 fleet trace.

    ``traces`` maps host id -> that host's records (manifest first, as
    ``read_trace`` returns them). Raises MergeError on an empty input,
    a stream with no manifest, or mismatched run fingerprints. The
    result validates under ``schema.validate_trace`` — the caller owes
    no post-processing."""
    if not traces:
        raise MergeError("no traces to merge")
    _check_fingerprints(traces)
    offsets = align_offsets(traces)
    ref = min(traces)

    body: List[dict] = []
    host_summaries: Dict[int, dict] = {}
    for host in sorted(traces):
        off = offsets[host]
        for r in traces[host][1:]:
            if not isinstance(r, dict):
                continue
            rec = dict(r)
            rec["host"] = host
            t = rec.get("t")
            if isinstance(t, (int, float)):
                rec["t"] = round(float(t) + off, 6)
            if rec.get("kind") == "span":
                for k in ("t_start", "t_end"):
                    tv = rec.get(k)
                    if isinstance(tv, (int, float)):
                        rec[k] = round(float(tv) + off, 6)
                rec["trace_id"] = f"h{host}:{rec.get('trace_id')}"
            if rec.get("kind") == "summary":
                host_summaries[host] = rec
                rec = _demote_summary(rec, host)
            body.append(rec)

    # one fleet timeline: non-decreasing t, >= 0. The sort is stable,
    # so each host's own record order (the per-lane n_iter contract)
    # survives; the rebase absorbs a reference host that started later
    # than a peer.
    body.sort(key=lambda r: (r.get("t", 0.0),))
    t_min = min((r["t"] for r in body
                 if isinstance(r.get("t"), (int, float))), default=0.0)
    if t_min < 0:
        for r in body:
            if isinstance(r.get("t"), (int, float)):
                r["t"] = round(r["t"] - t_min, 6)
            if r.get("kind") == "span":
                for k in ("t_start", "t_end"):
                    if isinstance(r.get(k), (int, float)):
                        r[k] = round(r[k] - t_min, 6)

    manifest = dict(traces[ref][0])
    manifest["schema"] = FLEET_SCHEMA_VERSION
    manifest["merged"] = True
    manifest["hosts"] = {
        str(h): {"offset_s": round(offsets[h], 6),
                 "schema": traces[h][0].get("schema"),
                 "source": (os.path.basename(sources[h])
                            if sources and h in sources else None)}
        for h in sorted(traces)}

    out = [manifest] + body
    if host_summaries:
        out.append(_fleet_summary(host_summaries, offsets, body))
    return out


def _fleet_summary(host_summaries: Dict[int, dict],
                   offsets: Dict[int, float],
                   body: List[dict]) -> dict:
    """One group-level summary synthesized from the hosts' own: the
    group converged iff EVERY host converged, progress facts are the
    group max (the group is done when its slowest member is)."""
    ref = min(host_summaries)
    summary = dict(host_summaries[ref])
    summary["converged"] = all(bool(s.get("converged"))
                               for s in host_summaries.values())
    for k in ("n_iter", "iters"):
        summary[k] = max(int(s.get(k, 0) or 0)
                         for s in host_summaries.values())
    summary["train_seconds"] = round(
        max(float(s.get("train_seconds", 0.0) or 0.0)
            for s in host_summaries.values()), 6)
    summary["t"] = max([r.get("t", 0.0) for r in body] + [0.0])
    summary["host"] = None          # group-level, no single lane
    summary["fleet_hosts"] = sorted(host_summaries)
    for k in SUMMARY_KEYS:
        summary.setdefault(k, None)
    return summary


def merge_paths(paths: Union[Dict[int, str], Sequence[str]]
                ) -> List[dict]:
    """Merge trace FILES. ``paths`` is host->path, or a sequence whose
    host ids are parsed from the ``trace_h{K}`` names (positional ids
    as the fallback for alien names)."""
    if not isinstance(paths, dict):
        resolved: Dict[int, str] = {}
        for i, p in enumerate(paths):
            m = TRACE_FAMILY_RE.match(os.path.basename(p))
            host = int(m.group("host")) if m else i
            if host in resolved:
                raise MergeError(
                    f"duplicate host {host}: {resolved[host]} and {p}")
            resolved[host] = p
        paths = resolved
    if not paths:
        raise MergeError("no traces to merge")
    traces = {h: read_trace(p) for h, p in paths.items()}
    return merge_traces(traces, sources=dict(paths))


def merge_dir(dir_path: str) -> List[dict]:
    """Merge the newest-attempt trace family found under a directory
    (the hostgroup run dir)."""
    fam = discover_family(dir_path)
    if not fam:
        raise FileNotFoundError(
            f"{dir_path}: no trace_h*.jsonl family members")
    return merge_paths(fam)


def write_merged(records: List[dict], out_path: str) -> str:
    """Write a merged trace as JSONL (the shape ``dpsvm report`` and
    ``validate_trace`` read back)."""
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")
    os.replace(tmp, out_path)
    return out_path
