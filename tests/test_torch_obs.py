"""The port's observability and resilience copies held to the JAX package:
the exposition validator, tenant hygiene, span sampling, the SLO rules'
alert transitions, serving traces and perf-ledger rows read across
packages, incident bundles, the health monitors, the deferred signal trap
and the retry supervisor. All host-side: nothing here touches a device.
"""

import json
import os
import signal

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401


# ---------------------------------------------------------------------
# metrics: the exposition grammar, tenant names
# ---------------------------------------------------------------------

def _registry_with_traffic(metrics_mod):
    reg = metrics_mod.MetricsRegistry()
    c = reg.counter("dpsvm_t_requests_total", "requests", labels=("tenant",))
    for t, n in (("a", 3), ('acme"prod', 2), ("back\\slash", 1)):
        c.labels(tenant=t).inc(n)
    h = reg.histogram("dpsvm_t_latency_ms", "latency",
                      buckets=metrics_mod.DEFAULT_LATENCY_BUCKETS_MS,
                      labels=("model",))
    for v in (0.05, 0.3, 7.0, 120.0, 9000.0):
        h.labels(model="m").observe(v)
    reg.gauge("dpsvm_t_depth", "queue depth").labels().set(4)
    metrics_mod.incidents_counter(reg).inc()
    return reg


BAD_EXPOSITIONS = [
    "# TYPE x counter\nx -1\n",
    "# TYPE x counter\n# TYPE x counter\nx 1\n",
    "x 1\n# TYPE x counter\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\n"
    "h_sum 1\nh_count 1\n",
    "# TYPE h histogram\n",
    "x{a=\"unterminated} 1\n",
    "# TYPE a gauge\na 1\n# TYPE b gauge\nb 1\na{x=\"1\"} 2\n",
    "x 1\nx 1\n",
    "# TYPE x bogus\nx 1\n",
]


def test_exposition_validator_agrees_with_the_jax_one():
    from dpsvm_tpu.observability import metrics as jm
    from dpsvm_tpu_torch.observability import metrics as pm
    text = _registry_with_traffic(pm).render_prometheus()
    assert pm.validate_exposition(text) == []
    assert jm.validate_exposition(text) == []
    jtext = _registry_with_traffic(jm).render_prometheus()
    assert jtext == text
    for bad in BAD_EXPOSITIONS:
        assert pm.validate_exposition(bad) == jm.validate_exposition(bad)
        assert pm.validate_exposition(bad), bad


@pytest.mark.parametrize("name", [
    None, "", "   ", "gold", "  gold  ", "a\nb", "tab\there", "x" * 200,
    'acme"prod', "back\\slash", 17, 3.5, {"a": 1}, ["a"], ("a",),
    "été", "\x00nul"])
def test_sanitize_tenant_matches_jax(name):
    from dpsvm_tpu.observability.metrics import sanitize_tenant as jst
    from dpsvm_tpu_torch.observability.metrics import (MAX_TENANT_LEN,
                                                       sanitize_tenant)
    assert sanitize_tenant(name) == jst(name)
    out = sanitize_tenant(name)
    assert out is None or len(out) <= MAX_TENANT_LEN


def test_wants_prometheus_and_content_type():
    from dpsvm_tpu.observability import metrics as jm
    from dpsvm_tpu_torch.observability import metrics as pm
    assert pm.PROMETHEUS_CONTENT_TYPE == jm.PROMETHEUS_CONTENT_TYPE
    for path in ("/metricsz", "/metricsz?format=prometheus",
                 "/metricsz?format=json", "/metricsz?x=1&format=prometheus"):
        assert pm.wants_prometheus(path) == jm.wants_prometheus(path)


# ---------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.1, 0.25, 1 / 3, 0.5, 0.999, 1.0,
                                  -1.0, 2.0])
def test_should_sample_matches_jax(rate):
    from dpsvm_tpu.observability.spans import should_sample as js
    from dpsvm_tpu_torch.observability.spans import should_sample
    picks = [should_sample(i, rate) for i in range(400)]
    assert picks == [js(i, rate) for i in range(400)]


def test_request_spans_tree_shape_matches_jax():
    from dpsvm_tpu.observability.spans import RequestSpans as JRS
    from dpsvm_tpu_torch.observability.spans import RequestSpans as PRS

    def drive(cls):
        rs = cls(7, first_stage="admission")
        rs.tenant, rs.model = "gold", "m"
        rs.start("queue_wait")
        sp = rs.start("replica_compute", parent="queue_wait", replica=1)
        rs.end(sp)
        rs.mark("hedge_fired", parent="queue_wait", primary=0, hedge=1)
        rs.start("respond")
        spans = rs.finish(status=200)
        return ([(s.name, s.parent, sorted(s.extra)) for s in spans],
                sorted(rs.breakdown()))

    assert drive(PRS) == drive(JRS)


# ---------------------------------------------------------------------
# SLO rules: the same counter sequence, the same transitions
# ---------------------------------------------------------------------

def _sample_stream():
    """A deterministic serving counter sequence: clean traffic, a 504
    storm, queue saturation, one hot tenant, a model-cache fault burst,
    then recovery."""
    rng = np.random.default_rng(3)
    req = bad = faults = 0.0
    tenants = {f"t{i}": 0.0 for i in range(4)}
    out = []
    for k in range(400):
        t = 2.0 * k
        storm = 60 <= k < 120
        req += 50
        bad += 5 if storm else 0
        fill = 0.9 if 150 <= k < 200 else 0.1 * rng.random()
        faults += 3 if 220 <= k < 260 else 0
        for name in tenants:
            tenants[name] += 40 if (name == "t0" and 280 <= k < 340) else 5
        s = {"requests": req, "deadline_504": bad, "queue_fill": fill,
             "model_faults": faults}
        for name, v in tenants.items():
            s[f"tenant:{name}:requests"] = v
            s[f"tenant:{name}:deadline_504"] = bad / 4
        out.append((t, s))
    return out


def _transitions(slo_mod, specs):
    w = slo_mod.Watchtower(slo_mod.RuleSet.from_specs(specs))
    got = []
    for i, (t, s) in enumerate(_sample_stream()):
        for tr in w.observe(s, t=t):
            got.append((i, tr["rule"], tr["state"], tr.get("tenant")))
    return got


@pytest.mark.parametrize("which", ["serving", "one_rule_each"])
def test_slo_transitions_match_jax(which):
    from dpsvm_tpu.observability import slo as js
    from dpsvm_tpu_torch.observability import slo as ps
    if which == "serving":
        specs = ps.default_serving_rules()
        assert specs == js.default_serving_rules()
    else:
        specs = [
            {"name": "burn", "kind": "burn_rate", "severity": "page",
             "good": "requests", "bad": "deadline_504",
             "objective": 0.99, "fast_window_s": 20.0,
             "slow_window_s": 100.0, "threshold": 2.0,
             "clear_after_s": 20.0},
            {"name": "sat", "kind": "threshold", "severity": "warn",
             "metric": "queue_fill", "above": 0.8, "for_s": 4.0,
             "clear_after_s": 6.0},
            {"name": "thrash", "kind": "rate", "severity": "warn",
             "metric": "model_faults", "window_s": 10.0, "above": 1.0,
             "clear_after_s": 10.0},
            {"name": "fair", "kind": "fair_share", "severity": "warn",
             "per_tenant": True, "window_s": 20.0, "share_above": 0.5,
             "min_tenants": 2, "for_s": 0.0, "clear_after_s": 10.0}]
    got = _transitions(ps, specs)
    assert got == _transitions(js, specs)
    assert any(s == "firing" for _, _, s, _ in got)
    assert any(s != "firing" for _, _, s, _ in got)


def test_rule_grammar_errors_match_jax():
    from dpsvm_tpu.observability import slo as js
    from dpsvm_tpu_torch.observability import slo as ps
    bad = [{"kind": "burn_rate"}, {"name": "x", "kind": "nope"},
           {"name": "x", "kind": "threshold", "metric": "m"},
           {"name": "x", "kind": "burn_rate", "good": "a", "bad": "b",
            "objective": 2.0}]
    for spec in bad:
        with pytest.raises(js.RuleError) as je:
            js.Rule(spec)
        with pytest.raises(ps.RuleError) as pe:
            ps.Rule(spec)
        assert str(pe.value) == str(je.value)


def test_slo_roofline_baseline_reads_the_ports_ledger(tmp_path,
                                                       monkeypatch):
    from dpsvm_tpu_torch.observability import ledger, slo
    path = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv("DPSVM_PERF_LEDGER", path)
    for v in (10.0, 12.0, 11.0):
        ledger.append("roofline_case", {"roofline_frac": v}, value=v)
    base = slo.resolve_ledger_baseline("roofline_case", "roofline_frac")
    from dpsvm_tpu.observability import slo as js
    assert base == js.resolve_ledger_baseline(
        "roofline_case", "roofline_frac", records=ledger.read(path))


# ---------------------------------------------------------------------
# traces and ledger rows across packages
# ---------------------------------------------------------------------

def _serving_trace(record_mod, path):
    tr = record_mod.open_serving_trace(path, models={"default": {}},
                                       sample_rate=0.5)
    tr.event("eject", n_iter=0, replica=1, generation=1, reason="wedge")
    tr.event("rebuild", n_iter=0, replica=1, ok=True, generation=2)
    record_mod.close_serving_trace(tr, requests=10, errors=1, seconds=0.5,
                                   deadline_504=1)
    return path


def test_serving_traces_validate_across_packages(tmp_path):
    from dpsvm_tpu.observability import record as jr
    from dpsvm_tpu.observability import schema as js
    from dpsvm_tpu_torch import __version__
    from dpsvm_tpu_torch.observability import record as pr
    from dpsvm_tpu_torch.observability import schema as ps
    mine = _serving_trace(pr, str(tmp_path / "port.jsonl"))
    theirs = _serving_trace(jr, str(tmp_path / "jax.jsonl"))
    for path in (mine, theirs):
        assert ps.validate_trace(ps.read_trace(path)) == []
        assert js.validate_trace(js.read_trace(path)) == []
    recs = ps.read_trace(mine)
    assert recs[0]["solver"] == "serving"
    assert recs[0]["version"] == __version__
    assert [r["kind"] for r in recs] == [r["kind"] for r in
                                          js.read_trace(theirs)]
    assert ps.TRACE_SCHEMA_VERSION == js.TRACE_SCHEMA_VERSION


def test_flush_open_traces_stamps_a_terminal_event(tmp_path):
    from dpsvm_tpu.observability import schema as js
    from dpsvm_tpu_torch.observability import record as pr
    tr = pr.open_serving_trace(str(tmp_path / "t.jsonl"))
    assert pr.flush_open_traces("watchdog_stall", seconds=1.0) >= 1
    recs = js.read_trace(str(tmp_path / "t.jsonl"))
    assert recs[-1]["kind"] == "event"
    assert recs[-1]["event"] == "watchdog_stall"
    assert tr.closed


def test_ledger_rows_read_across_packages(tmp_path, monkeypatch):
    from dpsvm_tpu.observability import ledger as jl
    from dpsvm_tpu_torch.observability import ledger as pl
    path = str(tmp_path / "ledger.jsonl")
    for i, v in enumerate((100.0, 101.0, 99.0, 100.5, 80.0)):
        mod = pl if i % 2 else jl
        mod.append("serving_examples_per_sec", {"metric": "x"},
                   kind="loadgen", value=v, unit="ex/s", path=path,
                   backend="cuda" if mod is pl else "cpu", strict=True)
    for mod in (pl, jl):
        recs = mod.read(path)
        assert len(recs) == 5
        assert mod.cases(recs) == ["serving_examples_per_sec"]
    verdict = pl.gate(pl.read(path), window=4, threshold_pct=5.0)
    assert verdict == jl.gate(jl.read(path), window=4, threshold_pct=5.0)
    assert verdict
    assert pl.make_record("c", {"a": 1}, backend="cuda").keys() == \
        jl.make_record("c", {"a": 1}, backend="cpu").keys()


def test_ledger_default_path_is_the_ports_own(monkeypatch):
    from dpsvm_tpu_torch.observability import ledger
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("DPSVM_PERF_LEDGER", raising=False)
    got = ledger.ledger_path()
    assert got == os.path.join(root, "dpsvm_tpu_torch", "_ledger",
                               "perf_ledger.jsonl")
    assert "benchmarks" not in got
    with open(os.path.join(root, ".gitignore")) as fh:
        assert "dpsvm_tpu_torch/_ledger/" in fh.read().split()
    monkeypatch.setenv("DPSVM_PERF_LEDGER", "")
    assert ledger.ledger_path() is None
    assert ledger.append("x", {"a": 1}) is None


def test_ledger_backend_hint_never_initializes_cuda(monkeypatch):
    import torch
    from dpsvm_tpu_torch.observability import ledger
    monkeypatch.delenv("DPSVM_PLATFORM", raising=False)
    if not torch.cuda.is_initialized():
        assert ledger.backend_hint() is None
        assert not torch.cuda.is_initialized()
    monkeypatch.setenv("DPSVM_PLATFORM", "cpu")
    assert ledger.backend_hint() in ("cpu", "cuda")


# ---------------------------------------------------------------------
# flight recorder and incident bundles
# ---------------------------------------------------------------------

def test_bundle_dump_validates_under_both_packages(tmp_path):
    import torch
    from dpsvm_tpu.observability import blackbox as jb
    from dpsvm_tpu_torch.observability import blackbox as pb
    from dpsvm_tpu_torch.observability.metrics import MetricsRegistry
    init = torch.cuda.is_initialized()
    rec = pb.FlightRecorder(pb.make_manifest(solver="serving",
                                             config={"models": ["m"]}))
    rec.event("eject", n_iter=0, replica=0, reason="wedge")
    import time
    t0 = time.perf_counter()
    rec.span(trace_id=1, span_id=0, parent=None, name="request",
             t_start=t0, t_end=t0 + 0.001, status=200)
    reg = MetricsRegistry()
    reg.counter("dpsvm_x_total", "x").labels().inc()
    out = pb.dump_bundle(str(tmp_path), recorder=rec, rule="burn",
                         severity="page", window="60s", reason="planted",
                         registry=reg)
    assert out and os.path.isdir(out)
    assert pb.validate_bundle(out) == []
    assert jb.validate_bundle(out) == []
    doctor = open(os.path.join(out, "doctor.txt")).read()
    assert "backend:" in doctor
    assert torch.cuda.is_initialized() == init
    assert "tuned_profile" not in pb.load_incident(out)["files"]
    text = pb.render_bundle(out)
    assert "rule:     burn [page]" in text and "records" in text


# ---------------------------------------------------------------------
# health, preemption, supervision
# ---------------------------------------------------------------------

def test_replica_monitor_matches_jax():
    from dpsvm_tpu.resilience.health import ReplicaMonitor as J
    from dpsvm_tpu_torch.resilience.health import ReplicaMonitor as P
    a, b = P(), J()
    for i in range(40):
        for m in (a, b):
            m.note_latency(0.5 + (i % 7))
            if i % 13 == 0:
                m.note_nonfinite()
            if i % 17 == 0:
                m.note_timeout()
    assert a.stats() == b.stats()


def test_health_monitor_matches_jax():
    from dpsvm_tpu.resilience import health as jh
    from dpsvm_tpu_torch.resilience import health as ph
    seq = [(100 * k, 1.0 - 0.01 * k, -1.0 + 0.01 * k, 10 + k)
           for k in range(30)]
    seq.append((3000, float("nan"), 0.0, 40))

    def run(mod):
        mon = mod.HealthMonitor()
        out = []
        for n_iter, b_lo, b_hi, n_sv in seq:
            try:
                mon.check(n_iter=n_iter, b_lo=b_lo, b_hi=b_hi, n_sv=n_sv)
                out.append("ok")
            except mod.DivergenceError as e:
                out.append(f"diverged: {e}")
        return out

    assert run(ph) == run(jh)


def test_preempt_trap_defers_the_signal():
    from dpsvm_tpu_torch.resilience import preempt
    with preempt.trap():
        assert preempt.pending() is None
        os.kill(os.getpid(), signal.SIGTERM)
        import time
        deadline = time.time() + 5
        while preempt.pending() is None and time.time() < deadline:
            time.sleep(0.01)
        assert preempt.pending() == signal.SIGTERM
    assert preempt.pending() is None
    assert preempt.PREEMPT_EXIT_CODE == 75


def test_run_with_retries_resumes_after_preemption(tmp_path):
    from dpsvm_tpu_torch.resilience.preempt import PreemptedError
    from dpsvm_tpu_torch.resilience.supervisor import (is_transient,
                                                       run_with_retries)
    calls = []

    def fn(resume_from, attempt):
        calls.append((resume_from, attempt))
        if attempt < 2:
            raise PreemptedError(signal.SIGTERM, 10 * (attempt + 1))
        return "done"

    from dpsvm_tpu_torch.solver import driver
    assert run_with_retries(fn, retries=3, backoff_s=0.0,
                            sleep=lambda s: None) == "done"
    assert [a for _, a in calls] == [0, 1, 2]
    # fn trains nothing, so the attempts' retry markers are still queued
    # for the next run's trace: take them, so none leaks into a later
    # test's trace
    assert [(e, kw["attempt"]) for e, kw in driver.drain_queued_events()
            ] == [("retry", 1), ("retry", 2)]
    with pytest.raises(PreemptedError):
        run_with_retries(fn, retries=0, backoff_s=0.0)
    assert driver.drain_queued_events() == []
    assert is_transient(75) and not is_transient(1)
