"""Run-trace JSONL format: writer, reader, schema validation (port of
``dpsvm_tpu/observability/schema.py``; a trace either package writes
validates under the other's schema).

One training run = one JSONL file (``SVMConfig.trace_out`` / the train
CLI's ``--trace-out``): a ``manifest`` record (what was asked for and on
what hardware), then ``chunk`` records at every host poll (the solver's
packed-stats transfer already carries n_iter/gap/SV-count/cache
counters, so tracing adds ZERO device->host transfers — see
solver/driver.py "Poll economics"), ``compile`` records whenever a
chunk program pays an XLA compile or retrace (docs/OBSERVABILITY.md
"Compile accounting"), optional ``event`` records (checkpoint /
program swap / shrink), and a final ``summary`` record.

This module is deliberately dependency-free (no jax import): the
``report``/``compare`` CLI subcommands and the schema self-check must
run without initializing any backend. The recorder that knows about
solvers lives in ``dpsvm_tpu_torch.observability.record``.

The schema is versioned and validated by ``validate_trace`` — the same
function backs ``python -m dpsvm_tpu_torch.telemetry --selfcheck`` (tier-1:
tests/test_observability.py), so a drifting producer fails loudly
instead of silently writing traces the report renderer can no longer
read. Version history:

* v1 — manifest/chunk/event/summary. Still accepted: a v1
  manifest selects the v1 key sets and forbids v2-only record kinds.
* v2 — adds the ``compile`` record kind, per-chunk ``hbm`` watermarks
  and ``phase_counts``, and the summary's compile/HBM/FLOP facts
  (``n_compiles``, ``compile_seconds``, ``hbm_peak``, ``est_flops``).
  Additively (still v2): the elastic distributed events — ``desync``
  (cross-shard disagreement; must carry ``shards``), ``reshard``
  (resume re-sliced onto a different mesh; must carry ``from_shards``
  and ``to_shards``, and like ``rollback`` it legitimately rewinds the
  n_iter baseline to its checkpoint's iteration) and ``shard_lost``
  (a mesh shard died mid-run) — docs/DISTRIBUTED.md "Elastic
  training". Chunk records of distributed runs may carry
  ``shard_ages`` (per-shard heartbeat ages, seconds).
* v3 — adds the ``span`` record kind (request-scoped latency
  attribution in serving traces, docs/OBSERVABILITY.md "Spans") and
  the summary's ``est_bytes`` fact (cost-model bytes-accessed per
  iteration — the denominator of the arithmetic-intensity verdict in
  observability/roofline.py). Spans form per-request trees keyed by
  ``trace_id``: one root span per request (``parent`` null) whose
  children attribute the wall time to pipeline stages (queue wait,
  batch formation, device dispatch, ...). Ordering is part of the
  schema: a span ends at or after it starts, a child lies within its
  parent's interval, the root's direct children never sum past the
  root's own duration (the shortfall is the request's *unattributed*
  residual, reported — never hidden — by ``dpsvm report``), and a
  ``parent`` must name a span of the same ``trace_id``.
* v4 — tenant attribution (docs/OBSERVABILITY.md "Per-tenant
  attribution"): serving span roots and ``replica_compute`` children
  may carry ``tenant`` and ``model`` extras identifying who the
  request's time was spent for (``X-Tenant`` header / body ``tenant``
  field, default = model name). Purely additive — no new record
  kinds, no new required keys — so every v3 consumer reads a v4
  trace unchanged and v1/v2/v3 traces keep validating
  (tests/fixtures/trace_v{1,2,3}.jsonl).
* v5 — the merged-fleet trace (observability/merge.py,
  docs/OBSERVABILITY.md "Fleet"): N per-host traces of one group run
  combined into ONE clock-aligned stream where every record carries a
  ``host`` tag. Single-host producers keep writing v4
  (``TRACE_SCHEMA_VERSION``); only the merger stamps
  ``FLEET_SCHEMA_VERSION``. What changes at >= 5: chunk ``n_iter``
  monotonicity is checked PER HOST LANE (interleaved hosts progress
  independently; a rewind event tagged with ``host`` resets only that
  lane, an untagged ``reform`` resets the whole group), and each
  host's own final summary is demoted by the merger to a
  ``host_summary`` event so the one-summary rule still holds for the
  synthesized fleet summary. ``t`` stays globally non-decreasing —
  clock alignment is the merger's job, and a merged trace that
  rewinds time is a broken merge.
"""

from __future__ import annotations

import json
from typing import IO, Dict, List, Optional

TRACE_SCHEMA_VERSION = 4
#: schema stamped by observability/merge.py on a merged multi-host
#: trace — the only producer of v5; single-host writers stay at v4
FLEET_SCHEMA_VERSION = 5
SUPPORTED_SCHEMAS = (1, 2, 3, 4, 5)

# Required keys per record kind. Values may be null where noted in
# docs/OBSERVABILITY.md (e.g. env.device_kind on an uninitialized
# backend, hbm watermarks on CPU); presence is the contract.
MANIFEST_KEYS = ("schema", "version", "solver", "n", "d", "gamma",
                 "kernel", "mesh", "env", "config", "it0", "time")
CHUNK_KEYS_V1 = ("n_iter", "b_lo", "b_hi", "gap", "n_sv", "cache_hits",
                 "cache_misses", "rounds", "t", "phases")
CHUNK_KEYS = CHUNK_KEYS_V1 + ("phase_counts", "hbm")
EVENT_KEYS = ("event", "n_iter", "t")
COMPILE_KEYS = ("program", "seconds", "t")
SUMMARY_KEYS_V1 = ("converged", "n_iter", "iters", "iters_per_sec", "b",
                   "b_lo", "b_hi", "gap", "n_sv", "cache_hits",
                   "cache_misses", "cache_hit_rate", "train_seconds",
                   "phases", "t")
SUMMARY_KEYS_V2 = SUMMARY_KEYS_V1 + ("phase_counts", "n_compiles",
                                     "compile_seconds", "hbm_peak",
                                     "est_flops")
SUMMARY_KEYS = SUMMARY_KEYS_V2 + ("est_bytes",)
SPAN_KEYS = ("trace_id", "span_id", "parent", "name", "t_start",
             "t_end", "t")
KINDS_V1 = ("manifest", "chunk", "event", "summary")
KINDS_V2 = KINDS_V1 + ("compile",)
KINDS = KINDS_V2 + ("span",)

#: slack (seconds) for the span containment/sum checks: producers clamp
#: children to their root's interval at emission, so only float
#: rounding of the recorded 6-decimal timestamps needs absorbing.
SPAN_SLACK_S = 2e-6

# Events that may legitimately FOLLOW the summary record: emergency
# exit paths (the stall watchdog's flush_open_traces, a preemption
# signal landing between summary and close) stamp their marker into an
# already-summarized trace rather than lose it (docs/ROBUSTNESS.md).
# Everything else after a summary is trace corruption or interleaved
# writers — rejected by validate_trace.
TERMINAL_EVENTS = ("stall", "preempt")

# Events that rewind the chunk-record n_iter baseline to their own
# n_iter: `rollback` (checkpoint restored after divergence/corruption),
# `reshard` (resume re-sliced onto a different mesh — the checkpoint's
# iteration restarts the count on the new mesh), and `reform` (a host
# group shrank after a host loss and the resumed attempt restarts from
# the checkpoint's iteration — resilience/hostgroup.py).
REWIND_EVENTS = ("rollback", "reshard", "reform")

# Required extra keys per elastic/ingest/cascade event type (beyond
# EVENT_KEYS): a `desync` without its mesh size, a `reshard` without
# both mesh sizes, or a `quarantine` without the shard and reason is
# useless to every consumer, so the validator rejects them. Note the
# ingest vocabulary's asymmetry: `quarantine` marks a data shard
# dropped mid-run, and `ingest_resume` (a streaming train picking up
# from a checkpoint) REWINDS NOTHING — unlike rollback/reshard it is
# deliberately absent from REWIND_EVENTS, so a chunk record whose
# n_iter regresses after one is still trace corruption.
#
# Cascade events (solver/cascade.py, docs/APPROX.md "Cascade"):
# `screen` carries the kept/total row split, `polish` the repair-round
# index and subproblem size, `readmit` the round index and how many
# KKT violators were re-admitted. Ordering is part of the schema
# (validate_trace): `polish`/`readmit` may only follow a `screen`,
# `readmit` only a `polish`, and readmit round indices never decrease
# — a trace violating any of these was written by a broken (or
# interleaved) producer.
#
# Watch events (observability/slo.py, docs/OBSERVABILITY.md "Watch &
# alerts"): `alert` marks a rule's state TRANSITION (fire or clear —
# the `state` key distinguishes; rule/window/severity are required so
# a consumer can always tell WHICH contract broke and over what
# window), `incident` marks a flight-recorder bundle dump (carries the
# same identity plus `bundle`, the dumped directory).
#
# Live shard-log events (data/live.py + the continuous-learning loop,
# docs/DATA.md "Live shard logs" / docs/SERVING.md "Continuous
# learning"): `append_admitted` marks one durable appended shard
# entering a reader's view (shard + the generation that published it),
# `ingest_grow` marks a sweep boundary at which live training admitted
# new rows (the grown generation + row delta), and `refresh` marks the
# serving loop choosing its refresh flavor — `refresh_kind` MUST be
# "incremental" or "full" (validated below; a refresh of unknown kind
# is a broken producer, not a vocabulary extension). The flavor key is
# `refresh_kind`, not `kind`: every record's own `kind` field IS the
# record kind, and an event extra named `kind` would overwrite it at
# write time.
EVENT_EXTRA_KEYS = {
    "desync": ("shards",),
    "reshard": ("from_shards", "to_shards"),
    "quarantine": ("shard", "reason"),
    "screen": ("n_kept", "n_total"),
    "polish": ("round", "n_kept"),
    "readmit": ("round", "n_readmitted"),
    "alert": ("rule", "window", "severity"),
    "incident": ("rule", "window", "severity", "bundle"),
    "append_admitted": ("shard", "generation"),
    "ingest_grow": ("generation", "n_new_rows"),
    "refresh": ("refresh_kind",),
    # Multi-host recovery (resilience/hostgroup.py): a `host_lost`
    # without the dead host's id, or a `reform` without both group
    # sizes, cannot drive a playbook — rejected like their elastic
    # shard-level counterparts above.
    "host_lost": ("host_id",),
    "reform": ("from_hosts", "to_hosts"),
    # Model-fleet cache events (dpsvm_tpu/fleet/modelcache.py): a
    # `model_fault` without the model name and its measured cold start
    # can drive neither the thrash rule's attribution nor the
    # fleet_cold_start_p99_ms ledger row; a `model_evict` without the
    # name cannot explain the next fault.
    "model_fault": ("model", "cold_start_ms"),
    "model_evict": ("model",),
    # Grid-trainer events (dpsvm_tpu/fleet/grid.py): a `grid_cell`
    # without its coordinates and held-out score is useless to the
    # selection audit; `grid_winner` must at least name the cell.
    "grid_cell": ("c", "gamma", "holdout_acc"),
    "grid_winner": ("c", "gamma"),
}

#: the closed value set of the `refresh` event's `refresh_kind`
REFRESH_KINDS = ("incremental", "full")


class TraceWriter:
    """Append-one-JSON-record-per-line writer, flushed per record so a
    killed run still leaves a parseable partial trace."""

    def __init__(self, path: str):
        self.path = path
        self._fh: Optional[IO[str]] = open(path, "w")

    def write(self, record: dict) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_trace(path: str) -> List[dict]:
    """Parse a trace file into its records. Raises ValueError on a line
    that is not JSON (a truncated FINAL line — a run killed mid-write —
    is tolerated and dropped, matching the flush-per-record writer)."""
    records: List[dict] = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    for i, raw in enumerate(lines):
        raw = raw.strip()
        if not raw:
            continue
        try:
            records.append(json.loads(raw))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break                   # torn final write of a dead run
            raise ValueError(f"{path}:{i + 1}: not a JSON record")
    return records


def _missing(record: dict, keys) -> List[str]:
    return [k for k in keys if k not in record]


def validate_trace(records: List[dict]) -> List[str]:
    """Schema check; returns a list of problems (empty = valid).

    Contract (acceptance bar of docs/OBSERVABILITY.md): exactly one
    leading manifest at a supported schema version (the version selects
    the per-kind key sets — v1 traces keep validating); >= 0 chunk
    records with monotone non-decreasing n_iter (per ``host`` lane in
    a v5 merged trace) and non-negative counters; ``t`` non-decreasing across every record that carries it;
    at most one summary, followed only by terminal events (stall /
    preempt — the emergency flush paths). A ``rollback`` event
    legitimately rewinds the run to its checkpoint's iteration
    (docs/ROBUSTNESS.md), so it resets the n_iter monotonicity
    baseline; nothing resets the ``t`` baseline — a time rewind means
    interleaved writers. Cascade stage events are ordered (see
    EVENT_EXTRA_KEYS): ``polish`` only after ``screen``, ``readmit``
    only after ``polish``, readmit rounds non-decreasing. Span records
    (v3) obey the per-request tree rules in _validate_spans."""
    errors: List[str] = []
    if not records:
        return ["empty trace (no records)"]
    head = records[0]
    schema = head.get("schema") if isinstance(head, dict) else None
    v1 = schema == 1
    if v1:
        kinds, chunk_keys, summary_keys = (
            KINDS_V1, CHUNK_KEYS_V1, SUMMARY_KEYS_V1)
    elif schema == 2:
        kinds, chunk_keys, summary_keys = (
            KINDS_V2, CHUNK_KEYS, SUMMARY_KEYS_V2)
    else:
        kinds, chunk_keys, summary_keys = KINDS, CHUNK_KEYS, SUMMARY_KEYS
    for i, r in enumerate(records):
        if not isinstance(r, dict) or r.get("kind") not in kinds:
            errors.append(f"record {i}: unknown kind "
                          f"{r.get('kind') if isinstance(r, dict) else r!r}")
    if head.get("kind") != "manifest":
        errors.append("record 0: trace must start with a manifest")
    else:
        if schema not in SUPPORTED_SCHEMAS:
            errors.append(f"manifest: schema {schema!r} not in "
                          f"supported {SUPPORTED_SCHEMAS}")
        miss = _missing(head, MANIFEST_KEYS)
        if miss:
            errors.append(f"manifest: missing keys {miss}")
    if sum(isinstance(r, dict) and r.get("kind") == "manifest"
           for r in records) > 1:
        errors.append("multiple manifest records")

    # chunk n_iter monotonicity baselines. Pre-v5 traces have exactly
    # one lane (key None); a v5 merged trace interleaves N hosts that
    # progress independently, so each ``host`` tag is its own lane.
    fleet = isinstance(schema, int) and not isinstance(schema, bool) \
        and schema >= 5
    prev_iter_by_lane: Dict[object, int] = {}
    prev_t = None
    summary_at = None
    saw_screen = False
    saw_polish = False
    prev_readmit_round = None
    spans: List[tuple] = []
    for i, r in enumerate(records):
        if not isinstance(r, dict):
            continue
        kind = r.get("kind")
        t = r.get("t")
        if isinstance(t, (int, float)):
            if prev_t is not None and t < prev_t:
                errors.append(f"record {i}: t {t} < previous {prev_t} "
                              "(time must be non-decreasing)")
            prev_t = t
        if summary_at is not None and not (
                kind == "event" and r.get("event") in TERMINAL_EVENTS):
            errors.append(f"record {i}: only terminal events "
                          f"({'/'.join(TERMINAL_EVENTS)}) may follow "
                          f"the final summary at record {summary_at}")
        if kind == "chunk":
            miss = _missing(r, chunk_keys)
            if miss:
                errors.append(f"record {i}: chunk missing keys {miss}")
                continue
            lane = r.get("host") if fleet else None
            base = prev_iter_by_lane.get(lane)
            if base is not None and r["n_iter"] < base:
                where = (f" in host {lane} lane"
                         if fleet and lane is not None else "")
                errors.append(f"record {i}: n_iter {r['n_iter']} < "
                              f"previous {base} (not monotone{where})")
            prev_iter_by_lane[lane] = r["n_iter"]
            for k in ("n_sv", "cache_hits", "cache_misses", "rounds"):
                if r[k] < 0:
                    errors.append(f"record {i}: {k} = {r[k]} < 0")
        elif kind == "event":
            miss = _missing(r, EVENT_KEYS)
            extra = EVENT_EXTRA_KEYS.get(r.get("event"), ())
            miss += _missing(r, extra)
            if miss:
                errors.append(f"record {i}: event missing keys {miss}")
            elif r.get("event") in REWIND_EVENTS:
                # The run restarted from a checkpoint at this iteration
                # (rollback), possibly on a different mesh (reshard).
                # In a merged fleet trace a host-tagged rewind resets
                # only that host's lane; an untagged one (a group-wide
                # reform) resets every lane seen so far.
                if fleet and "host" not in r:
                    prev_iter_by_lane = {
                        k: r["n_iter"] for k in prev_iter_by_lane}
                else:
                    prev_iter_by_lane[
                        r.get("host") if fleet else None] = r["n_iter"]
            elif r.get("event") == "refresh":
                if r.get("refresh_kind") not in REFRESH_KINDS:
                    errors.append(
                        f"record {i}: refresh_kind "
                        f"{r.get('refresh_kind')!r} not in "
                        f"{REFRESH_KINDS}")
            elif r.get("event") == "ingest_grow":
                if int(r.get("n_new_rows", 0) or 0) < 0:
                    errors.append(f"record {i}: ingest_grow "
                                  f"n_new_rows {r['n_new_rows']} < 0")
            elif r.get("event") == "screen":
                saw_screen = True
            elif r.get("event") == "polish":
                if not saw_screen:
                    errors.append(f"record {i}: polish event before "
                                  "any screen event (cascade stages "
                                  "are ordered)")
                saw_polish = True
            elif r.get("event") == "readmit":
                if not saw_polish:
                    errors.append(f"record {i}: readmit event before "
                                  "any polish event (re-admission "
                                  "repairs a polished model)")
                rnd = r["round"]
                if (prev_readmit_round is not None
                        and rnd < prev_readmit_round):
                    errors.append(
                        f"record {i}: readmit round {rnd} < previous "
                        f"{prev_readmit_round} (rounds must not "
                        "decrease)")
                prev_readmit_round = rnd
        elif kind == "compile":
            miss = _missing(r, COMPILE_KEYS)
            if miss:
                errors.append(f"record {i}: compile missing keys {miss}")
            elif r["seconds"] < 0:
                errors.append(f"record {i}: compile seconds "
                              f"{r['seconds']} < 0")
        elif kind == "span":
            miss = _missing(r, SPAN_KEYS)
            if miss:
                errors.append(f"record {i}: span missing keys {miss}")
            else:
                spans.append((i, r))
        elif kind == "summary":
            miss = _missing(r, summary_keys)
            if miss:
                errors.append(f"record {i}: summary missing keys {miss}")
            if summary_at is not None:
                errors.append(f"record {i}: second summary (first at "
                              f"record {summary_at})")
            else:
                summary_at = i
    errors += _validate_spans(spans)
    return errors


def _validate_spans(spans: List[tuple]) -> List[str]:
    """The per-request span-tree rules (schema v3, module docstring).

    ``spans`` is [(record_index, span_record), ...] with the per-record
    keys already checked. Grouping is by ``trace_id``, so the records
    of concurrent requests may interleave freely in the file — the
    tree rules apply within each request:

    * every span ends at or after it starts;
    * ``parent`` (when not null) names a ``span_id`` of the SAME
      trace_id — an orphan points at a request that never recorded
      its parent, i.e. a broken or interleaved producer;
    * a child's [t_start, t_end] lies within its parent's (producers
      clamp at emission; SPAN_SLACK_S absorbs timestamp rounding);
    * per request there is exactly one root (``parent`` null), and the
      root's DIRECT children — the pipeline stages — never sum past
      the root's own duration. The shortfall is the request's
      "unattributed" residual, a first-class fact `dpsvm report`
      prints; an overshoot means overlapping stage spans, which the
      serving producer never emits.
    """
    errors: List[str] = []
    by_trace: Dict[object, List[tuple]] = {}
    for i, r in spans:
        t0, t1 = r["t_start"], r["t_end"]
        if not (isinstance(t0, (int, float))
                and isinstance(t1, (int, float))):
            errors.append(f"record {i}: span t_start/t_end must be "
                          f"numbers, got {t0!r}/{t1!r}")
            continue
        if t1 < t0:
            errors.append(f"record {i}: span {r['name']!r} ends before "
                          f"it starts (t_end {t1} < t_start {t0})")
            continue
        by_trace.setdefault(r["trace_id"], []).append((i, r))
    for tid, group in by_trace.items():
        ids = {r["span_id"]: (i, r) for i, r in group}
        roots = [(i, r) for i, r in group if r["parent"] is None]
        if len(roots) != 1:
            errors.append(f"trace_id {tid!r}: {len(roots)} root span(s) "
                          "(parent=null) — every request records "
                          "exactly one")
            continue
        _ri, root = roots[0]
        child_sum = 0.0
        for i, r in group:
            p = r["parent"]
            if p is None:
                continue
            if p not in ids:
                errors.append(f"record {i}: span {r['name']!r} has "
                              f"orphan parent {p!r} (no such span_id "
                              f"in trace_id {tid!r})")
                continue
            _pi, parent = ids[p]
            if (r["t_start"] < parent["t_start"] - SPAN_SLACK_S
                    or r["t_end"] > parent["t_end"] + SPAN_SLACK_S):
                errors.append(
                    f"record {i}: span {r['name']!r} "
                    f"[{r['t_start']}, {r['t_end']}] escapes its "
                    f"parent {parent['name']!r} "
                    f"[{parent['t_start']}, {parent['t_end']}]")
            if p == root["span_id"]:
                child_sum += r["t_end"] - r["t_start"]
        root_dur = root["t_end"] - root["t_start"]
        if child_sum > root_dur + SPAN_SLACK_S * max(len(group), 1):
            errors.append(
                f"trace_id {tid!r}: direct children sum to "
                f"{child_sum:.6f}s > the root's {root_dur:.6f}s wall — "
                "stage spans overlap (attribution over 100%)")
    return errors
