"""Run observability of the port (``dpsvm_tpu/observability``): traces,
capture and build accounting, reports, live follow, cross-run comparison,
the metric registry and its exporters, the profiler, the watch and the
flight recorder.

Layout:

* ``schema``       — JSONL record shapes + ``validate_trace``, the JAX
                     package's schema (either package's traces validate
                     under either validator). Stdlib only.
* ``record``       — the ``RunTrace`` recorder every producer writes
                     through (the driver, the shrink manager, the
                     cascade, the grid, the serving stack).
* ``compilewatch`` — CUDA-graph captures, ``nvcc`` builds and first
                     launches of the chunk programs, drained into traces
                     at poll boundaries.
* ``device``       — the allocator's memory watermarks (nulls on the
                     CPU), a host-side read.
* ``report``       — digest + ASCII report + ``--follow`` live tail.
* ``compare``      — two-trace delta table + regression gate.
* ``metrics``      — the metric registry, its exposition and validator,
                     the training and data feeders, the ``--metrics-port``
                     sidecar and ``--metrics-out`` snapshots.
* ``profiler``     — windowed ``torch.profiler`` sessions with
                     phase-named ranges (``utils/timing.span``) and the
                     ``profile summarize`` reconciliation sidecar.
* ``roofline``     — achieved against the H100 data-sheet peaks.
* ``ledger``       — the perf ledger and its historical gate.
* ``slo``, ``blackbox``, ``spans`` — the watchtower, the flight
                     recorder and its incident bundles, request spans.

* ``merge``, ``fleet`` — the fleet views: a multi-host trace family on
                     one timeline, N hosts' metric surfaces federated
                     into one exposition, a fleet bundle's artifacts.
                     Stdlib only.

Importing this package touches no device: ``torch`` is
imported inside the functions that need it (device, profiler), so
``report``/``compare``/``perf`` run on a machine with no card.
"""

from __future__ import annotations

from typing import List, Optional

from dpsvm_tpu_torch.observability.compare import (compare_paths,
                                                   compare_traces,
                                                   regressions,
                                                   render_compare)
from dpsvm_tpu_torch.observability.record import (SOLVER_NAMES, RunTrace,
                                                  flush_open_traces)
from dpsvm_tpu_torch.observability.report import (follow_trace,
                                                  host_lanes, load_trace,
                                                  load_trace_auto,
                                                  render_report,
                                                  resolve_trace_path,
                                                  span_attribution,
                                                  summarize_trace,
                                                  trace_facts)
from dpsvm_tpu_torch.observability.metrics import (MetricsRegistry,
                                                   default_registry,
                                                   validate_exposition)
from dpsvm_tpu_torch.observability.schema import (TRACE_SCHEMA_VERSION,
                                                  TraceWriter, read_trace,
                                                  validate_trace)

__all__ = [
    "TRACE_SCHEMA_VERSION", "TraceWriter", "read_trace",
    "validate_trace", "RunTrace", "SOLVER_NAMES", "flush_open_traces",
    "load_trace", "load_trace_auto", "render_report",
    "summarize_trace", "trace_facts",
    "span_attribution", "host_lanes", "resolve_trace_path",
    "follow_trace",
    "compare_traces", "compare_paths", "render_compare", "regressions",
    "MetricsRegistry", "default_registry", "validate_exposition",
    "selfcheck", "main",
]

# A v1 trace embedded verbatim: the schema gate asserts that old
# traces keep validating after every v2+ change (the committed file
# fixture lives at tests/fixtures/trace_v1.jsonl; this inline copy
# makes the CLI selfcheck self-contained).
V1_SAMPLE_RECORDS: List[dict] = [
    {"kind": "manifest", "schema": 1, "version": "0.0", "solver": "smo",
     "n": 100, "d": 4, "gamma": 0.25,
     "kernel": {"kind": "rbf", "gamma": 0.25, "coef0": 0.0, "degree": 3},
     "mesh": {"shards": 1, "shard_x": True},
     "env": {"backend": "cpu", "device_kind": "host", "device_count": 1},
     "config": {}, "it0": 0, "time": "2026-01-01T00:00:00+0000"},
    {"kind": "chunk", "n_iter": 512, "b_lo": 0.5, "b_hi": -0.5,
     "gap": 1.0, "n_sv": 10, "cache_hits": 0, "cache_misses": 0,
     "rounds": 0, "t": 0.1, "phases": {"dispatch": 0.01, "poll": 0.05}},
    {"kind": "event", "event": "checkpoint", "n_iter": 512, "t": 0.2},
    {"kind": "summary", "converged": True, "n_iter": 900, "iters": 900,
     "iters_per_sec": 3000.0, "b": 0.1, "b_lo": 0.1004, "b_hi": 0.0996,
     "gap": 0.0008, "n_sv": 12, "cache_hits": 0, "cache_misses": 0,
     "cache_hit_rate": None, "train_seconds": 0.3,
     "phases": {"dispatch": 0.02, "poll": 0.2}, "t": 0.31},
]


def selfcheck(tmp_dir: Optional[str] = None,
              device: Optional[str] = None) -> List[str]:
    """Produce a synthetic v2 trace through the real writer, then run
    it through the real validator, renderer and comparator; also
    validate the embedded v1 sample; then the metrics, ledger, spans,
    roofline and watch gates and a traced training run on ``device``
    (default: the card). Returns problems (empty = OK).
    ``tests/test_torch_report.py`` and ``python -m
    dpsvm_tpu_torch.observability --selfcheck`` both call this, so a
    schema drift between producer and validator fails loudly."""
    import os
    import tempfile

    problems = []
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        path = os.path.join(td, "selfcheck.jsonl")
        tr = RunTrace(path, config={"kernel": "rbf", "shards": 2,
                                    "shard_x": True, "coef0": 0.0,
                                    "degree": 3},
                      n=1000, d=32, gamma=0.5, solver="smo", it0=0,
                      env={"backend": "cpu", "device_kind": "host",
                           "device_count": 2})
        tr.compile(program="smo-chunk", seconds=1.25,
                   signature="((1000,), float32)", flops=2.0e6)
        for i, gap in enumerate((1.5, 0.3, 0.0009)):
            tr.chunk(n_iter=(i + 1) * 512, b_lo=gap / 2, b_hi=-gap / 2,
                     n_sv=100 * (i + 1), cache_hits=i * 10,
                     cache_misses=i * 20, rounds=i,
                     phases={"dispatch": 0.1 * i, "poll": 0.2 * i},
                     phase_counts={"dispatch": i + 1, "poll": i + 1},
                     hbm={"in_use": 1 << 28, "peak": (1 << 28) + i,
                          "limit": 16 << 30})
        tr.event("checkpoint", n_iter=1024)
        tr.summary(converged=True, n_iter=1536, b=0.0, b_lo=0.00045,
                   b_hi=-0.00045, n_sv=300, train_seconds=1.5,
                   cache_hits=20, cache_misses=40,
                   phases={"dispatch": 0.3, "poll": 0.6},
                   phase_counts={"dispatch": 3, "poll": 3})
        tr.close()
        try:
            records = load_trace(path)
        except ValueError as e:
            return [str(e)]
        digest = summarize_trace(records)
        if digest["n_chunks"] != 3 or digest["summary"] is None:
            problems.append(f"digest mismatch: {digest['n_chunks']} "
                            "chunks or missing summary")
        s = digest["summary"]
        facts = {k: (s or {}).get(k)
                 for k in ("n_compiles", "compile_seconds",
                           "est_flops", "hbm_peak")}
        if facts != {"n_compiles": 1, "compile_seconds": 1.25,
                     "est_flops": 2.0e6, "hbm_peak": (1 << 28) + 2}:
            problems.append(f"summary device facts drifted: {facts}")
        text = render_report(records)
        for needle in ("run: smo", "converged at iter 1,536",
                       "hit rate 33.3%", "checkpoint@1,024",
                       "compiles: 1 program(s)", "hbm peak:",
                       "throughput: ~"):
            if needle not in text:
                problems.append(f"report rendering lost {needle!r}")
        # A trace must compare cleanly against itself with zero
        # regressions at any threshold.
        cmp = compare_traces(records, records)
        if regressions(cmp, 0.001):
            problems.append("self-comparison reported a regression: "
                            f"{regressions(cmp, 0.001)}")
        render_compare(cmp)
    # v1 back-compat: the embedded sample must keep validating and
    # rendering (hbm/compile facts absent, not invented).
    v1_errors = validate_trace(V1_SAMPLE_RECORDS)
    if v1_errors:
        problems.append(f"v1 sample no longer validates: {v1_errors}")
    else:
        v1_text = render_report(V1_SAMPLE_RECORDS)
        if "hbm peak" in v1_text or "compiles:" in v1_text:
            problems.append("v1 rendering invented v2 device facts")
    problems += _selfcheck_metrics()
    problems += _selfcheck_ledger(tmp_dir)
    problems += _selfcheck_spans(tmp_dir)
    problems += _selfcheck_roofline(tmp_dir)
    problems += _selfcheck_watch(tmp_dir)
    problems += _selfcheck_tenants(tmp_dir)
    problems += _selfcheck_fleet(tmp_dir)
    problems += _selfcheck_driver(tmp_dir, device)
    return problems


def _selfcheck_watch(tmp_dir: Optional[str] = None) -> List[str]:
    """The continuous-watch gate (docs/OBSERVABILITY.md "Watch &
    alerts"): rule round-trip -> a planted burn against an injectable
    clock fires the multi-window rule and ONLY then -> flight-recorder
    bundle dump -> the bundle re-validates (embedded trace schema
    v3, exposition grammar) -> the alert clears after the burn stops
    — plus the live half: a fault-injected slow replica turns real
    HTTP requests into a 504 storm that must fire the serving
    watchtower, dump a bundle and clear once the fault lifts."""
    import json
    import os
    import tempfile
    import urllib.request

    from dpsvm_tpu_torch.observability import blackbox, slo

    problems: List[str] = []
    # 1. rule round-trip: specs -> RuleSet -> specs, bit-identical
    specs = slo.default_serving_rules() + slo.default_training_rules()
    rs = slo.RuleSet.from_specs(specs)
    if rs.to_specs() != specs:
        problems.append("rule round-trip drifted "
                        f"({rs.to_specs()} != {specs})")
    # 2. planted burn on an injectable clock: healthy for 120 ticks,
    # then a 50% 504 ratio — the page rule must fire, and a healthy
    # steady state must never have fired
    tower = slo.Watchtower(slo.load_rules(None, default="serving"))
    fired_at = None
    for i in range(400):
        t = float(i)
        bad = max(0, i - 120) * 5.0 if i <= 240 else 600.0
        trs = tower.observe({"requests": i * 10.0,
                             "deadline_504": bad}, t=t)
        for tr in trs:
            if tr["state"] == "firing" and fired_at is None:
                if i <= 120:
                    problems.append("burn rule fired on healthy "
                                    f"steady state at t={t}")
                fired_at = t
    if fired_at is None:
        problems.append("planted 50% 504 burn never fired the "
                        "burn-rate rule")
    elif not any(s["state"] == "ok" for s in tower.states()
                 if s["rule"] == "availability-burn"):
        problems.append("burn-rate alert did not clear after the "
                        "burn stopped")
    if tower.worst_fired != "page" or tower.exit_code() != slo.EXIT_PAGE:
        problems.append(f"watch exit-code contract drifted: "
                        f"{tower.worst_fired} -> {tower.exit_code()}")
    # 3. bundle dump -> re-validate
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        fr = blackbox.FlightRecorder(blackbox.make_manifest(
            solver="selfcheck-watch"))
        fr.chunk(n_iter=512, b_lo=0.5, b_hi=-0.5)
        fr.event("alert", rule="availability-burn",
                 window="fast=60s/slow=600s", severity="page",
                 state="firing", reason="selfcheck burn")
        reg = MetricsRegistry()
        reg.counter("dpsvm_selfcheck_total", "check").inc()
        path = blackbox.dump_bundle(
            td, recorder=fr, rule="availability-burn",
            severity="page", window="fast=60s/slow=600s",
            reason="selfcheck burn", registry=reg)
        if not path:
            problems.append("bundle dump failed")
        else:
            errs = blackbox.validate_bundle(path)
            if errs:
                problems.append(f"dumped bundle no longer validates: "
                                f"{errs}")
            if blackbox.resolve_bundle_dir(td) != path:
                problems.append("resolve_bundle_dir lost the bundle")
        # 4. the live drill: slow-replica fault -> 504 storm through
        # REAL HTTP -> the server's own watchtower fires + dumps ->
        # fault lifts -> recovery (alert clears)
        problems += _watch_storm_drill(td)
    return problems


def _watch_storm_drill(td: str) -> List[str]:
    """Fault-injected 504 storm against a stub-engine ServingServer
    (no backend init): the in-process half of the drill that
    the JAX package's tests also pin as a subprocess."""
    import json
    import os
    import time
    import urllib.request

    from dpsvm_tpu_torch.observability import blackbox, slo

    try:
        import numpy as np

        from dpsvm_tpu_torch.resilience import faultinject
        from dpsvm_tpu_torch.serving.server import ServingServer
    except Exception as e:              # pragma: no cover — env issue
        return [f"watch drill setup failed: {e}"]

    class _Engine:
        num_attributes = 4
        calibrated = False
        manifest = {"task": "selfcheck-stub", "num_attributes": 4}

        def infer(self, x, want):
            n = int(np.shape(x)[0])
            return {k: (np.ones(n, np.int32) if k == "labels"
                        else np.zeros(n, np.float32))
                    for k in want}

        def bucket_counts(self):
            return {}

    class _Registry:
        def __init__(self):
            self._e = _Engine()

        def names(self):
            return ["default"]

        def engine(self, name):
            return self._e

        def build(self, name):
            return _Engine()

        def manifests(self):
            return {"default": dict(self._e.manifest, generation=1)}

    problems: List[str] = []
    bundle_dir = os.path.join(td, "storm-bundles")
    # tight windows so the drill runs in ~2 s of wall clock; the
    # determinism tests live on the injectable clock, this drills the
    # REAL feed path end-to-end
    rules = [{"name": "availability-burn", "kind": "burn_rate",
              "severity": "page", "good": "requests",
              "bad": "deadline_504", "objective": 0.999,
              "fast_window_s": 0.4, "slow_window_s": 1.0,
              "threshold": 2.0, "clear_after_s": 0.3}]
    # ~30 slowed computes cover the storm phase, then the fault lifts
    faultinject.install(faultinject.FaultPlan(
        serve_slow_replica_ms=60, serve_slow_for=30))
    srv = None
    try:
        srv = ServingServer(_Registry(), port=0, max_batch=4,
                            max_delay_ms=0.2, watch_rules=rules,
                            bundle_dir=bundle_dir).start()
        body = json.dumps({"instances": [[0.0] * 4],
                           "timeout_ms": 15}).encode()

        def post():
            req = urllib.request.Request(
                srv.url + "/v1/predict", data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    r.read()
                    return r.status
            except urllib.error.HTTPError as e:
                e.read()
                return e.code

        deadline = time.monotonic() + 20.0
        fired = False
        while time.monotonic() < deadline and not fired:
            post()
            fired = any(s["state"] == "firing"
                        for s in srv.watch.states())
        if not fired:
            problems.append("504 storm never fired the serving "
                            "burn-rate rule")
        # recovery: the fault has a finite budget (serve_slow_for), so
        # continued traffic is healthy and the alert must clear
        cleared = False
        while time.monotonic() < deadline and not cleared:
            post()
            cleared = all(s["state"] == "ok"
                          for s in srv.watch.states())
            if not cleared:
                time.sleep(0.05)
        if not cleared:
            problems.append("alert did not clear after the slow-"
                            "replica fault lifted")
        m = srv.metrics()
        if not m.get("incidents_total"):
            problems.append("dpsvm_incidents_total never incremented")
        if not any(e.get("event") == "alert" for e in m.get("events",
                                                            [])):
            problems.append("events ring has no alert entry")
        bundles = [b for b in (os.listdir(bundle_dir)
                               if os.path.isdir(bundle_dir) else [])
                   if b.startswith("incident-")]
        if not bundles:
            problems.append("storm fired but dumped no bundle")
        else:
            bpath = blackbox.resolve_bundle_dir(bundle_dir)
            errs = blackbox.validate_bundle(bpath)
            if errs:
                problems.append(f"storm bundle invalid: {errs}")
            inc = blackbox.load_incident(bpath)
            if inc.get("rule") != "availability-burn":
                problems.append("incident.json lost the rule name")
    except Exception as e:
        problems.append(f"watch storm drill crashed: {e!r}")
    finally:
        try:
            if srv is not None:
                srv.drain(timeout=10.0)
        except Exception:
            pass
        faultinject.clear()
    return problems


def _selfcheck_tenants(tmp_dir: Optional[str] = None) -> List[str]:
    """The per-tenant attribution gate: multi-tenant stub traffic with a
    planted hog -> per-tenant series land on both /metricsz faces
    (validator-clean exposition) -> the tenant-fair-share rule fires
    NAMING the hog -> the incident bundle carries the tenant -> the
    trace's span roots attribute every sampled request to its
    tenant."""
    import json
    import os
    import tempfile
    import time
    import urllib.error
    import urllib.request

    from dpsvm_tpu_torch.observability import blackbox
    from dpsvm_tpu_torch.observability.metrics import validate_exposition

    try:
        import numpy as np

        from dpsvm_tpu_torch.serving.loadgen import tenant_of
        from dpsvm_tpu_torch.serving.server import ServingServer
    except Exception as e:              # pragma: no cover — env issue
        return [f"tenant drill setup failed: {e}"]

    class _Engine:
        num_attributes = 4
        calibrated = False
        manifest = {"task": "selfcheck-stub", "num_attributes": 4}

        def infer(self, x, want):
            n = int(np.shape(x)[0])
            return {k: (np.ones(n, np.int32) if k == "labels"
                        else np.zeros(n, np.float32))
                    for k in want}

        def bucket_counts(self):
            return {}

    class _Registry:
        def __init__(self):
            self._e = _Engine()

        def names(self):
            return ["default", "aux"]

        def engine(self, name):
            return self._e

        def build(self, name):
            return _Engine()

        def manifests(self):
            return {n: dict(self._e.manifest, generation=1)
                    for n in self.names()}

    problems: List[str] = []
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        bundle_dir = os.path.join(td, "tenant-bundles")
        trace_path = os.path.join(td, "tenant-trace.jsonl")
        rules = [{"name": "tenant-fair-share", "kind": "fair_share",
                  "severity": "warn", "per_tenant": True,
                  "window_s": 0.8, "share_above": 0.5,
                  "min_tenants": 2, "for_s": 0.0,
                  "clear_after_s": 10.0}]
        srv = None
        try:
            srv = ServingServer(_Registry(), port=0, max_batch=4,
                                max_delay_ms=0.2, watch_rules=rules,
                                bundle_dir=bundle_dir,
                                trace_out=trace_path,
                                trace_sample_rate=1.0,
                                tenant_budget=8).start()

            def post(i):
                body = {"instances": [[0.0] * 4],
                        "model": ("aux" if i % 7 == 3 else "default"),
                        "tenant": tenant_of(i, 8, 0.8)}
                req = urllib.request.Request(
                    srv.url + "/v1/predict",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as r:
                    r.read()

            deadline = time.monotonic() + 20.0
            fired = {}
            i = 0
            while time.monotonic() < deadline and not fired:
                post(i)
                i += 1
                fired = next(
                    (s for s in srv.watch.states()
                     if s["state"] == "firing"
                     and s["rule"].startswith("tenant-fair-share[")),
                    {})
            if not fired:
                problems.append("planted hot tenant never fired the "
                                "fair-share rule")
            elif fired.get("tenant") != "t0":
                problems.append("fair-share fired for "
                                f"{fired.get('tenant')!r}, not the "
                                "planted hog t0")
            # both /metricsz faces carry the per-tenant series
            with urllib.request.urlopen(
                    srv.url + "/metricsz?format=prometheus",
                    timeout=10) as r:
                expo = r.read().decode()
            errs = validate_exposition(expo)
            if errs:
                problems.append("per-tenant exposition invalid: "
                                f"{errs}")
            if 'dpsvm_tenant_requests_total{tenant="t0"}' not in expo:
                problems.append("tenant series missing from the "
                                "prometheus exposition")
            with urllib.request.urlopen(srv.url + "/metricsz",
                                        timeout=10) as r:
                mz = json.loads(r.read())
            per = (mz.get("tenants") or {}).get("per_tenant") or {}
            if not per or max(
                    per, key=lambda t: per[t]["requests"]) != "t0":
                problems.append("JSON cost ledger did not rank the "
                                f"hog first: {sorted(per)}")
            for name in ("default", "aux"):
                if name not in (mz.get("per_model") or {}):
                    problems.append(f"per_model block lost {name!r}")
        except Exception as e:
            problems.append(f"tenant drill crashed: {e!r}")
        finally:
            try:
                if srv is not None:
                    srv.drain(timeout=10.0)
            except Exception:
                pass
        # the incident bundle names the culprit and validates clean
        bundles = [b for b in (os.listdir(bundle_dir)
                               if os.path.isdir(bundle_dir) else [])
                   if b.startswith("incident-")]
        if not bundles:
            problems.append("fair-share fired but dumped no bundle")
        else:
            bpath = blackbox.resolve_bundle_dir(bundle_dir)
            errs = blackbox.validate_bundle(bpath)
            if errs:
                problems.append(f"tenant bundle invalid: {errs}")
            inc = blackbox.load_incident(bpath)
            if inc.get("tenant") != "t0":
                problems.append("incident.json does not name the "
                                f"tenant: {inc.get('tenant')!r}")
        # every sampled span root attributes its request to a tenant
        try:
            records = load_trace(trace_path)
        except (OSError, ValueError) as e:
            problems.append(f"tenant trace unreadable: {e}")
            records = []
        roots = [r for r in records
                 if r.get("kind") == "span" and r.get("name") == "request"]
        if not roots:
            problems.append("tenant trace recorded no request roots")
        if any("tenant" not in r for r in roots):
            problems.append("a sampled span root lost its tenant")
    return problems


def _selfcheck_spans(tmp_dir: Optional[str] = None) -> List[str]:
    """Span round-trip (schema v3, docs/OBSERVABILITY.md "Spans"):
    serve real HTTP requests through the REAL serving stack — stub
    engine, so no backend init — under --trace-out at sample rate 1.0,
    then validate the v3 artifact and assert the attribution residual
    stays under 10% of each request's wall (the acceptance bar: spans
    must explain where the time went, not leave it unattributed)."""
    import json
    import os
    import tempfile
    import urllib.request

    try:
        import numpy as np

        from dpsvm_tpu_torch.serving.server import ServingServer
    except Exception as e:              # pragma: no cover — env issue
        return [f"span selfcheck setup failed: {e}"]

    class _Engine:
        num_attributes = 4
        calibrated = False
        manifest = {"task": "selfcheck-stub", "num_attributes": 4}

        def infer(self, x, want):
            n = int(np.shape(x)[0])
            out = {}
            if "labels" in want:
                out["labels"] = np.ones(n, np.int32)
            if "decision" in want:
                out["decision"] = np.zeros(n, np.float32)
            return out

        def bucket_counts(self):
            return {}

    class _Registry:
        def __init__(self):
            self._e = _Engine()

        def names(self):
            return ["default"]

        def engine(self, name):
            return self._e

        def build(self, name):
            return _Engine()

        def manifests(self):
            return {"default": dict(self._e.manifest, generation=1)}

    problems: List[str] = []
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        path = os.path.join(td, "serve.jsonl")
        srv = ServingServer(_Registry(), port=0, max_batch=8,
                            max_delay_ms=0.5, trace_out=path,
                            trace_sample_rate=1.0).start()
        try:
            body = json.dumps(
                {"instances": [[0.0] * 4, [1.0] * 4]}).encode()
            for _ in range(6):
                req = urllib.request.Request(
                    srv.url + "/v1/predict", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=15) as r:
                    r.read()
        finally:
            srv.drain(timeout=15.0)
        try:
            records = load_trace(path)      # validates v3 en route
        except ValueError as e:
            return [f"serving span trace failed validation: {e}"]
        if (records[0].get("schema") or 0) < 3:
            problems.append("serving trace is not schema v3")
        att = span_attribution(records)
        if att is None or att["requests"] < 6:
            problems.append(f"span attribution lost requests: {att}")
        elif att["covered_90pct_frac"] < 0.99:
            problems.append(
                "attribution residual >= 10% on "
                f"{1 - att['covered_90pct_frac']:.0%} of requests "
                f"(slowest: {att['slowest'][:1]})")
        text = render_report(records)
        for needle in ("request latency attribution",
                       "slowest requests", "device_dispatch"):
            if needle not in text:
                problems.append(f"span report rendering lost "
                                f"{needle!r}")
    return problems


def _selfcheck_roofline(tmp_dir: Optional[str] = None) -> List[str]:
    """Roofline round-trip: a synthetic trace on a known device (the
    H100 data-sheet row, a kernel-A-shaped work count: 4 n d FLOPs and
    n d f32 bytes an iteration at n = 60000, d = 784) must render an
    achieved-against-spec fraction naming its f32 peak and the power
    limit, and a memory-bound verdict a phase; an unknown device must
    read as an honest n/a; and a perf-ledger history of
    roofline_fraction readings must be gateable (a planted drop
    fails). The numbers are inputs of the check, not measurements."""
    import os
    import tempfile

    from dpsvm_tpu_torch.observability import ledger, roofline

    problems: List[str] = []
    row = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    if row is None or row["peak_flops_f32"] != 67e12 \
            or row["peak_flops_bf16"] != 989e12:
        problems.append(f"peak table lost the H100 row: {row}")
    if roofline.peaks_for("cpu") is not None:
        problems.append("peak table invented a CPU peak")
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        path = os.path.join(td, "fused_h100.jsonl")
        tr = RunTrace(path, config={"kernel": "rbf"}, n=60000, d=784,
                      gamma=0.25, solver="fused-pallas",
                      env={"backend": "cuda",
                           "device_kind": "NVIDIA H100 80GB HBM3",
                           "device_count": 1,
                           "power_limit": "700.00 W"})
        tr.compile(program="fused-chunk", seconds=0.01,
                   flops=4.0 * 60000 * 784, bytes=4.0 * 60000 * 784)
        tr.chunk(n_iter=100_000, b_lo=0.1, b_hi=-0.1,
                 phases={"dispatch": 1.0, "poll": 5.5},
                 phase_counts={"dispatch": 10, "poll": 10})
        tr.summary(converged=True, n_iter=100_000, b=0.0, b_lo=0.001,
                   b_hi=-0.001, n_sv=100, train_seconds=7.0,
                   phases={"dispatch": 1.0, "poll": 5.5},
                   phase_counts={"dispatch": 10, "poll": 10})
        tr.close()
        try:
            records = load_trace(path)
        except ValueError as e:
            return [f"roofline sample failed validation: {e}"]
        facts = trace_facts(records)
        frac = facts.get("roofline_fraction")
        if not (frac and 0 < frac < 1):
            problems.append(f"roofline_fraction not computed: {frac}")
        if facts.get("roofline_verdict") != "memory-bound":
            problems.append("the kernel-A point must read memory-bound, "
                            f"got {facts.get('roofline_verdict')}")
        text = render_report(records)
        for needle in ("roofline: NVIDIA H100", "a spec, not a "
                       "measurement", "this card: 700.00 W",
                       "of the f32 peak", "[memory-bound]"):
            if needle not in text:
                problems.append(f"roofline rendering lost {needle!r}")
        # unknown hardware: explicit n/a, never an invented number
        records[0] = dict(records[0],
                          env={"backend": "cpu", "device_kind": "cpu",
                               "device_count": 1})
        if trace_facts(records).get("roofline_fraction") is not None:
            problems.append("unknown device got a roofline fraction")
        if "roofline: n/a" not in render_report(records):
            problems.append("unknown device lost the explicit "
                            "roofline n/a line")
        # ledger gate on the roofline_fraction column
        lpath = os.path.join(td, "ledger.jsonl")
        for v in (0.60, 0.61, 0.59, 0.60, 0.60, 0.40):
            ledger.append("bench_headline",
                          {"value": 16000.0, "unit": "iter/s",
                           "roofline_fraction": v},
                          kind="bench", path=lpath, strict=True)
        records_l = ledger.read(lpath)
        if ledger.gate(records_l, window=5, threshold_pct=10.0,
                       metric="roofline_fraction") == []:
            problems.append("planted roofline_fraction drop PASSED "
                            "the perf gate")
        if ledger.gate(records_l[:-1], window=5, threshold_pct=10.0,
                       metric="roofline_fraction"):
            problems.append("clean roofline_fraction history failed "
                            "the perf gate")
    return problems


def _selfcheck_driver(tmp_dir: Optional[str] = None,
                      device: Optional[str] = None) -> List[str]:
    """The training driver's observability on ``device`` (default: the
    card): a small fused-pair fit traced, exported, watched, bundled and
    profiled is bitwise the bare fit, with one stats read a poll in
    both; its trace validates, holds a chunk record a poll with the
    allocator's facts and the chunk program's record, and renders; its
    metrics snapshot validates."""
    import os
    import tempfile

    import numpy as np

    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data.synthetic import make_blobs
    from dpsvm_tpu_torch.solver import driver

    problems: List[str] = []
    x, y = make_blobs(n=96, d=6, seed=3)
    base = dict(c=1.0, gamma=0.5, epsilon=1e-3, chunk_iters=16,
                max_iter=4000)
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        obs = dict(trace_out=os.path.join(td, "t.jsonl"),
                   metrics_out=os.path.join(td, "m.prom"),
                   metrics_port=0, watch_rules=None,
                   bundle_dir=os.path.join(td, "bundles"),
                   profile_dir=os.path.join(td, "prof"))
        runs = []
        for extra in ({}, obs):
            reads = driver.READS["stats"]
            r = api.train(x, y, SVMConfig(**base, **extra), device=device)
            runs.append((r, driver.READS["stats"] - reads))
        (bare, n_bare), (seen, n_seen) = runs
        if not (np.array_equal(bare.alpha.view(np.int32),
                               seen.alpha.view(np.int32))
                and (bare.n_iter, bare.b) == (seen.n_iter, seen.b)):
            problems.append("the observed fit is not bitwise the bare "
                            "fit")
        if n_bare != n_seen:
            problems.append(f"stats reads: bare {n_bare}, observed "
                            f"{n_seen}")
        try:
            records = load_trace(obs["trace_out"])
        except (OSError, ValueError) as e:
            return problems + [f"driver trace invalid: {e}"]
        chunks = [r for r in records if r["kind"] == "chunk"]
        if len(chunks) != n_seen:
            problems.append(f"{len(chunks)} chunk records for "
                            f"{n_seen} polls")
        if not any(r["kind"] == "compile" for r in records):
            problems.append("the trace has no compile record")
        s = records[-1]
        if s["kind"] != "summary" or (s["n_iter"], s["n_sv"]) != (
                seen.n_iter, seen.n_sv):
            problems.append("the trace summary disagrees with the fit")
        if "converged at iter" not in render_report(records):
            problems.append("the driver trace does not render")
        with open(obs["metrics_out"]) as fh:
            errs = validate_exposition(fh.read())
        if errs:
            problems.append(f"metrics snapshot invalid: {errs}")
        if not os.path.isfile(os.path.join(obs["profile_dir"],
                                           "profile_summary.json")):
            problems.append("the profiler wrote no summary")
    return problems


def _selfcheck_fleet(tmp_dir: Optional[str] = None) -> List[str]:
    """The fleet-observability gate: a synthetic 3-host trace family with a planted straggler must
    merge into ONE schema-v5 validator-clean timeline whose lanes and
    report NAME the straggler -> a mismatched fingerprint must refuse
    to merge -> the skew rule fires naming the laggard host and
    clears after it catches up -> per-host metrics snapshots federate
    into a validator-clean exposition with the right aggregation
    (iterations min'ed, compiles summed) -> the fleet incident bundle
    carries every host's artifacts and re-validates. The subprocess
    twin (real hosts, real hang fault) is
    ``resilience/hostgroup.py straggler_drill``."""
    import json
    import os
    import tempfile

    from dpsvm_tpu_torch.observability import blackbox, fleet, merge, slo
    from dpsvm_tpu_torch.observability.metrics import write_snapshot
    from dpsvm_tpu_torch.observability.report import (host_lanes,
                                                      load_trace_auto)

    problems: List[str] = []
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        # one schema-v4 run through the REAL writer, then three host
        # copies of it: same wall-clock start (equal manifest `unix`
        # anchors), host 1 holding the group longer at every chunk —
        # the planted straggler
        base = os.path.join(td, "template.jsonl")
        tr = RunTrace(base, config={"kernel": "rbf", "shards": 3,
                                    "shard_x": True, "coef0": 0.0,
                                    "degree": 3},
                      n=3000, d=16, gamma=0.5, solver="dist-smo",
                      it0=0, env={"backend": "cpu",
                                  "device_kind": "host",
                                  "device_count": 1})
        for i in range(4):
            tr.chunk(n_iter=(i + 1) * 128, b_lo=0.4 - 0.1 * i,
                     b_hi=-(0.4 - 0.1 * i), n_sv=40 + i,
                     cache_hits=i, cache_misses=i, rounds=i,
                     phases={"dispatch": 0.01, "poll": 0.02})
        tr.summary(converged=True, n_iter=512, b=0.0, b_lo=1e-3,
                   b_hi=-1e-3, n_sv=44, train_seconds=1.0,
                   cache_hits=4, cache_misses=4,
                   phases={"dispatch": 0.04, "poll": 0.08},
                   phase_counts={"dispatch": 4, "poll": 4})
        tr.close()
        template = load_trace(base)
        fam = os.path.join(td, "fam")
        os.makedirs(fam)
        for h in (0, 1, 2):
            recs = [dict(r) for r in template]
            recs[0]["unix"] = 1.7e9          # same wall-clock start
            chunk_i = 0
            for r in recs[1:]:
                if not isinstance(r.get("t"), (int, float)):
                    continue
                if r.get("kind") == "chunk":
                    chunk_i += 1
                lag = 0.4 * chunk_i if h == 1 else 0.0
                r["t"] = round(1.0 * chunk_i + lag + 0.001 * h, 6)
            with open(os.path.join(fam, f"trace_h{h}.jsonl"),
                      "w") as fh:
                for r in recs:
                    fh.write(json.dumps(r) + "\n")
        merged = merge.merge_dir(fam)
        errs = validate_trace(merged)
        if errs:
            problems.append(f"merged fleet trace invalid: {errs}")
        lanes = host_lanes(merged)
        if lanes is None or lanes["straggler"] != 1:
            problems.append("planted straggler not attributed: "
                            f"{lanes and lanes['straggler']}")
        text = render_report(merged)
        if "straggler: host 1" not in text:
            problems.append("fleet report lost the straggler line")
        # dpsvm report on the directory must auto-merge the family;
        # the single-trace resolver must refuse it naming the hosts
        if len(load_trace_auto(fam)) != len(merged):
            problems.append("load_trace_auto did not merge the "
                            "trace family")
        try:
            resolve_trace_path(fam)
            problems.append("resolve_trace_path silently picked one "
                            "host of a multi-host family")
        except ValueError:
            pass
        # mismatched run fingerprints must refuse to merge
        bad = os.path.join(td, "bad")
        os.makedirs(bad)
        for h, gamma in ((0, 0.5), (1, 0.25)):
            recs = [dict(r) for r in template]
            recs[0]["gamma"] = gamma
            with open(os.path.join(bad, f"trace_h{h}.jsonl"),
                      "w") as fh:
                for r in recs:
                    fh.write(json.dumps(r) + "\n")
        try:
            merge.merge_dir(bad)
            problems.append("mismatched fingerprints merged anyway")
        except merge.MergeError:
            pass
        # the skew rule: host 1 a full chunk behind over the window
        # fires NAMING it, then clears once the lanes level; the
        # per-host heartbeat template expands over the same sample
        tower = slo.Watchtower(slo.load_rules(None, default="fleet"))
        fired = []
        for i in range(80):
            front = 128.0 * (1 + i // 8)
            sample = {}
            for h in (0, 1, 2):
                lagging = h == 1 and i <= 32
                sample[f"host:{h}:n_iter"] = (front - 64.0 if lagging
                                              else front)
                sample[f"host:{h}:heartbeat_age_seconds"] = 1.0
            sample["generation"] = 0.0
            fired += [t for t in tower.observe(sample, t=float(i))
                      if t["rule"] == "iteration-skew"]
        if not fired or fired[0]["state"] != "firing":
            problems.append("planted iteration skew never fired")
        elif (fired[0].get("host") != 1
              or "skew[host-1]" not in fired[0]["reason"]):
            problems.append("skew rule did not name host 1: "
                            f"{fired[0]}")
        if not any(t["state"] == "ok" for t in fired):
            problems.append("skew alert did not clear after the "
                            "laggard caught up")
        if not any(s["rule"] == "host-heartbeat-stale[host-2]"
                   for s in tower.states()):
            problems.append("per-host heartbeat template did not "
                            "expand over the active hosts")
        # federation: two sidecar snapshots -> one fleet snapshot,
        # iterations min'ed, compiles summed, exposition valid
        srcs = []
        for h, (iters, compiles) in enumerate(((500.0, 3),
                                               (380.0, 2))):
            reg = MetricsRegistry()
            reg.gauge("dpsvm_train_iterations", "it").set(iters)
            reg.gauge("dpsvm_train_gap", "gap").set(0.01 * (h + 1))
            reg.counter("dpsvm_train_compiles_total",
                        "compiles").inc(compiles)
            path = os.path.join(td, f"metrics_h{h}.prom")
            write_snapshot(reg, path, seq=5 + h)
            srcs.append(path)
        snap = fleet.federate(fleet.collect(srcs))
        agg = snap["aggregate"]
        if (agg.get("dpsvm_train_iterations") != 380.0
                or agg.get("dpsvm_train_compiles_total") != 5.0):
            problems.append(f"federation aggregation drifted: {agg}")
        if snap["lag"] != 120.0 or snap["slowest"] != 1:
            problems.append("fleet lag/slowest drifted: "
                            f"{snap['lag']}/{snap['slowest']}")
        expo = fleet.render_exposition(snap)
        errs = validate_exposition(expo)
        if errs:
            problems.append(f"fleet exposition invalid: {errs}")
        if 'dpsvm_host_iterations{host="1"} 380' not in expo:
            problems.append("per-host iteration lane missing from "
                            "the fleet exposition")
        if "host:1:n_iter" not in fleet.fleet_watch_sample(snap):
            problems.append("fleet watch sample lost the host lanes")
        # the fleet incident bundle: every host's artifacts ride
        # along and the bundle re-validates
        hb_dir = os.path.join(td, "hosts")
        os.makedirs(hb_dir)
        for h in (0, 1, 2):
            with open(os.path.join(hb_dir, f"host-{h}.json"),
                      "w") as fh:
                json.dump({"host": h, "n_iter": 512, "generation": 0,
                           "pid": 1000 + h, "t": 1.7e9, "seq": 9}, fh)
        arts = fleet.host_artifacts(fam, hb_dir)
        if sorted(arts) != [0, 1, 2]:
            problems.append(f"host_artifacts lost hosts: "
                            f"{sorted(arts)}")
        fr = blackbox.FlightRecorder(blackbox.make_manifest(
            solver="selfcheck-fleet"))
        fr.event("alert", rule="iteration-skew", window="30s",
                 severity="warn", state="firing",
                 reason=fired[0]["reason"] if fired else "skew")
        bpath = blackbox.dump_bundle(
            os.path.join(td, "bundles"), recorder=fr,
            rule="iteration-skew", severity="warn", window="30s",
            reason="selfcheck skew",
            extra={"extra": {"host": 1}}, host_artifacts=arts)
        if not bpath:
            problems.append("fleet bundle dump failed")
        else:
            errs = blackbox.validate_bundle(bpath)
            if errs:
                problems.append(f"fleet bundle invalid: {errs}")
            inc = blackbox.load_incident(bpath)
            if (inc.get("extra") or {}).get("host") != 1:
                problems.append("fleet incident lost the straggler "
                                "host")
            if not os.path.exists(os.path.join(
                    bpath, "host-1-heartbeat.json")):
                problems.append("fleet bundle lost host 1's "
                                "heartbeat artifact")
    return problems


def _selfcheck_metrics() -> List[str]:
    """Registry -> exposition -> grammar validator round-trip, plus a
    tamper check (the validator must actually reject broken text) —
    the schema gate of the metrics surface, sibling of the trace
    writer/validator round-trip above."""
    problems = []
    reg = MetricsRegistry()
    c = reg.counter("dpsvm_check_requests_total", "selfcheck counter",
                    labels=("model",))
    c.labels(model="default").inc(3)
    c.labels(model='odd"name\nwith escapes').inc()
    reg.gauge("dpsvm_check_gap", "selfcheck gauge").set(0.125)
    h = reg.histogram("dpsvm_check_latency_ms", "selfcheck histogram",
                      buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 5000.0):
        h.observe(v)
    text = reg.render_prometheus()
    errs = validate_exposition(text)
    if errs:
        problems.append(f"exposition no longer validates: {errs}")
    if c.labels(model="default").value != 3:
        problems.append("counter read-back drifted")
    tampered = text.replace('le="+Inf"} 4', 'le="+Inf"} 3')
    if not validate_exposition(tampered):
        problems.append("exposition validator accepted a broken "
                        "histogram (+Inf bucket != _count)")
    snap = reg.snapshot()
    if snap.get("dpsvm_check_gap", {}).get("series", [{}])[0].get(
            "value") != 0.125:
        problems.append("JSON snapshot lost the gauge value")
    return problems


def _selfcheck_ledger(tmp_dir: Optional[str] = None) -> List[str]:
    """Perf-ledger append/read/gate round-trip: a planted 20%
    historical regression MUST fail the gate; a clean history and a
    single-run case must pass (docs/OBSERVABILITY.md "Perf ledger")."""
    import os
    import tempfile

    from dpsvm_tpu_torch.observability import ledger

    problems = []
    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        path = os.path.join(td, "ledger.jsonl")
        for v in (100.0, 101.0, 99.0, 100.0, 100.0, 100.5):
            ledger.append("clean_case", {"value": v, "unit": "iter/s"},
                          kind="bench", path=path, strict=True)
        for v in (100.0, 100.0, 101.0, 99.0, 100.0, 80.0):
            ledger.append("planted_regression",
                          {"value": v, "unit": "iter/s"},
                          kind="bench", path=path, strict=True,
                          trace="traces/planted.jsonl")
        ledger.append("single_run", {"value": 5.0, "unit": "s"},
                      kind="burst", path=path, strict=True)
        records = ledger.read(path)
        if len(records) != 13:
            problems.append(f"ledger round-trip lost records "
                            f"({len(records)}/13)")
        clean = ledger.gate(records, window=5, threshold_pct=10.0,
                            case="clean_case")
        if clean:
            problems.append(f"clean history failed the gate: {clean}")
        planted = ledger.gate(records, window=5, threshold_pct=10.0,
                              case="planted_regression")
        if not planted:
            problems.append("planted 20% regression PASSED the "
                            "historical gate")
        if ledger.gate(records, window=5, threshold_pct=10.0,
                       case="single_run"):
            problems.append("single-run case (no history) failed the "
                            "gate")
        # the full-ledger sweep must flag exactly the planted case
        allv = ledger.gate(records, window=5, threshold_pct=10.0)
        if [v.split(":")[0] for v in allv] != ["planted_regression"]:
            problems.append(f"full-ledger gate verdicts drifted: {allv}")
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(prog="python -m "
                                "dpsvm_tpu_torch.observability")
    p.add_argument("--selfcheck", action="store_true",
                   help="writer -> validator -> renderer -> comparator "
                        "round-trip on a synthetic trace (the schema "
                        "gate), v1 back-compat, the metrics, ledger, "
                        "spans, roofline and watch gates, and a traced "
                        "training run on --device")
    p.add_argument("--device", default=None,
                   help="device of the selfcheck's training run "
                        "(default: the card; 'cpu' for the plain path)")
    p.add_argument("--validate", default=None, metavar="TRACE",
                   help="validate an existing trace file (or the newest "
                        "*.jsonl in a directory)")
    args = p.parse_args(argv)
    if args.selfcheck:
        problems = selfcheck(device=args.device)
        if problems:
            print("observability selfcheck FAILED:", file=sys.stderr)
            for pr in problems:
                print(f"  {pr}", file=sys.stderr)
            return 1
        print("observability selfcheck OK "
              f"(schema v{TRACE_SCHEMA_VERSION}, v1 accepted; metrics "
              "exposition + ledger gate + serving span round-trip + "
              "roofline render + watch gate (burn-rate fire/clear, "
              "504-storm drill, incident-bundle round-trip) + a traced "
              "fit bitwise the bare one, one stats read a poll, "
              "checked)")
        return 0
    if args.validate:
        try:
            resolved = resolve_trace_path(args.validate)
            records = load_trace(resolved)
        except (OSError, ValueError) as e:
            print(f"INVALID: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"valid": True, "records": len(records),
                          "path": resolved}))
        return 0
    p.print_help()
    return 2
