"""The port's fleet views held to the JAX package's: the cross-host trace
merge (``observability/merge.py``), metrics federation
(``observability/fleet.py``), the ``report`` / ``fleet`` / ``tenants``
commands, the ``skew`` rule over a merged family, the observability
selfcheck's tenant and fleet gates, and the straggler and 1000-model
fleet drills.

Merge and federation are host code, so they are held to JAX exactly: one
trace family (three hosts written through the port's ``RunTrace``, a
planted clock offset or a planted straggler) goes through both packages'
``merge_dir``, and the merged records must be equal field for field; the
same snapshot and heartbeat files go through both packages' ``collect``
/ ``federate`` at one fixed ``now``, and the snapshots, the exposition
text, the watch sample and the table must be equal. No field differs.
The ``tenants`` command reads the same trace and the same live server
through both CLIs, digest for digest. The straggler drill spawns three
training hosts and is marked ``slow``, as the JAX package marks its own
(``tests/test_fleet.py::test_straggler_drill_end_to_end``).
"""

from __future__ import annotations

import io
import json
import os
import urllib.request
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from dpsvm_tpu.observability import fleet as jfleet
from dpsvm_tpu.observability import merge as jmerge
from dpsvm_tpu_torch.observability import fleet as tfleet
from dpsvm_tpu_torch.observability import merge as tmerge
from torch_threads import one_thread  # noqa: F401

NOW = 1.7e9 + 60.0      # the fixed wall clock of the federation cases


# ---------------------------------------------------------------------
# trace families, written through the port's recorder

def _template(tmp_path, *, gamma=0.5, chunks=4):
    from dpsvm_tpu_torch.observability.record import RunTrace
    from dpsvm_tpu_torch.observability.report import load_trace
    path = os.path.join(str(tmp_path), f"template_{gamma}.jsonl")
    tr = RunTrace(path, config={"kernel": "rbf", "shards": 3,
                                "shard_x": True, "coef0": 0.0,
                                "degree": 3},
                  n=3000, d=16, gamma=gamma, solver="dist-smo", it0=0,
                  env={"backend": "cpu", "device_kind": "host",
                       "device_count": 1})
    for i in range(chunks):
        tr.chunk(n_iter=(i + 1) * 128, b_lo=0.4 - 0.1 * i,
                 b_hi=-(0.4 - 0.1 * i), n_sv=40 + i, cache_hits=i,
                 cache_misses=i, rounds=i,
                 phases={"dispatch": 0.01, "poll": 0.02})
    tr.event("checkpoint", n_iter=chunks * 64)
    tr.summary(converged=True, n_iter=chunks * 128, b=0.0, b_lo=1e-3,
               b_hi=-1e-3, n_sv=44, train_seconds=1.0, cache_hits=4,
               cache_misses=4, phases={"dispatch": 0.04, "poll": 0.08},
               phase_counts={"dispatch": chunks, "poll": chunks})
    tr.close()
    records = load_trace(path)
    os.unlink(path)
    return records


def _host_copy(template, *, unix=None, t_of=None, events=()):
    """A host's copy with its own time axis: ``t_of(k)`` is the k-th
    timed record's t; ``unix`` None removes the wall-clock anchor;
    ``events`` adds (name, t) anchor events."""
    records = [dict(r) for r in template]
    if unix is None:
        records[0].pop("unix", None)
    else:
        records[0]["unix"] = float(unix)
    k = 0
    for r in records[1:]:
        if isinstance(r.get("t"), (int, float)):
            k += 1
            r["t"] = round(float(t_of(k)), 6)
    for name, t, extra in events:
        records.insert(len(records) - 1, {"kind": "event", "event": name,
                                          "n_iter": 0, "t": float(t),
                                          **extra})
    return records


def _write_family(dirname, per_host, attempt=None):
    os.makedirs(dirname, exist_ok=True)
    for host, records in per_host.items():
        name = (f"trace_h{host}.jsonl" if attempt is None
                else f"trace_h{host}_a{attempt}.jsonl")
        with open(os.path.join(dirname, name), "w") as fh:
            for r in records:
                fh.write(json.dumps(r) + "\n")
    return dirname


def _family(tmp_path, kind):
    """Three hosts. ``straggler``: one wall clock, host 1 0.4 s later at
    every timed record; ``offset``: no wall-clock anchors, host 1's clock
    +5 s (chunk anchors align it); ``late``: host 2 started 3 s later by
    the wall clock; ``events``: no anchors but matched host_lost/reform
    events and a stale attempt-0 file beside the attempt-1 ones."""
    tpl = _template(tmp_path)
    fam = os.path.join(str(tmp_path), kind)
    if kind == "straggler":
        per = {h: _host_copy(tpl, unix=1.7e9,
                             t_of=lambda k, h=h: k + (0.4 * k if h == 1
                                                      else 0.0) + 1e-3 * h)
               for h in (0, 1, 2)}
    elif kind == "offset":
        per = {h: _host_copy(tpl, unix=None,
                             t_of=lambda k, h=h: k + (5.0 if h == 1
                                                      else 0.0))
               for h in (0, 1, 2)}
    elif kind == "late":
        per = {h: _host_copy(tpl, unix=1.7e9 + (3.0 if h == 2 else 0.0),
                             t_of=lambda k: k) for h in (0, 1, 2)}
    else:
        no_chunks = [r for r in tpl if r.get("kind") != "chunk"]
        per = {h: _host_copy(no_chunks, unix=None,
                             t_of=lambda k, h=h: k + 2.0 * h,
                             events=(("host_lost", 0.5 + 2.0 * h,
                                      {"host_id": 2}),
                                     ("reform", 0.7 + 2.0 * h,
                                      {"from_hosts": 3, "to_hosts": 2})))
               for h in (0, 1)}
        _write_family(fam, {h: _host_copy(tpl, unix=None,
                                          t_of=lambda k: k)
                            for h in (0, 1, 2)}, attempt=0)
        return _write_family(fam, per, attempt=1)
    return _write_family(fam, per)


FAMILIES = ("straggler", "offset", "late", "events")


@pytest.mark.parametrize("kind", FAMILIES)
def test_merge_matches_jax_record_for_record(kind, tmp_path):
    from dpsvm_tpu_torch.observability.schema import validate_trace
    fam = _family(tmp_path, kind)
    assert tmerge.discover_family(fam) == jmerge.discover_family(fam)
    got, want = tmerge.merge_dir(fam), jmerge.merge_dir(fam)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    assert validate_trace(got) == []
    # the file the port writes is the file JAX writes
    a = tmerge.write_merged(got, os.path.join(str(tmp_path), "t.jsonl"))
    b = jmerge.write_merged(want, os.path.join(str(tmp_path), "j.jsonl"))
    assert open(a).read() == open(b).read()


def test_merge_aligns_and_attributes_like_jax(tmp_path):
    from dpsvm_tpu_torch.observability.report import host_lanes
    merged = tmerge.merge_dir(_family(tmp_path, "offset"))
    by = {(r["host"], r["n_iter"]): r["t"] for r in merged[1:]
          if r.get("kind") == "chunk"}
    for n in (128, 256, 384, 512):
        assert by[(1, n)] == pytest.approx(by[(0, n)], abs=0.01)
    late = tmerge.merge_dir(_family(tmp_path, "late"))
    assert late[0]["hosts"]["2"]["offset_s"] == pytest.approx(3.0)
    lanes = host_lanes(tmerge.merge_dir(_family(tmp_path, "straggler")))
    assert lanes["straggler"] == 1
    summaries = [r for r in late if r.get("kind") == "summary"]
    assert len(summaries) == 1 and summaries[0]["fleet_hosts"] == [0, 1, 2]


def test_mismatched_fingerprints_refuse_to_merge_in_both(tmp_path):
    ta, tb = _template(tmp_path, gamma=0.5), _template(tmp_path, gamma=0.25)
    fam = _write_family(os.path.join(str(tmp_path), "bad"), {
        0: _host_copy(ta, unix=1.7e9, t_of=lambda k: k),
        1: _host_copy(tb, unix=1.7e9, t_of=lambda k: k)})
    msgs = []
    for mod in (tmerge, jmerge):
        with pytest.raises(mod.MergeError, match="gamma") as e:
            mod.merge_dir(fam)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(tmerge.MergeError, match="no traces"):
        tmerge.merge_traces({})


def _fleet_section(text):
    """The lane lines of a report (the two packages' reports differ in
    their version headers, not here)."""
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("fleet:"))
    j = next((k for k in range(i + 1, len(lines)) if not lines[k].strip()),
             len(lines))
    return lines[i:j]


def test_report_renders_the_family_lanes(tmp_path):
    from dpsvm_tpu.observability.report import render_report as jrender
    from dpsvm_tpu_torch.observability.report import (load_trace_auto,
                                                      render_report,
                                                      resolve_trace_path)
    fam = _family(tmp_path, "straggler")
    records = load_trace_auto(fam)
    assert records[0]["merged"] is True
    text = render_report(records)
    assert "straggler: host 1" in text and "<- straggler" in text
    assert "fleet: 3 host lane(s) merged" in text
    assert _fleet_section(text) == _fleet_section(
        jrender(jmerge.merge_dir(fam)))
    with pytest.raises(ValueError, match="hosts 0, 1, 2"):
        resolve_trace_path(fam)
    single = _write_family(os.path.join(str(tmp_path), "single"),
                           {0: _template(tmp_path)})
    assert resolve_trace_path(single).endswith("trace_h0.jsonl")


def test_skew_fires_on_the_merged_family_and_clears(tmp_path):
    from dpsvm_tpu_torch.observability.slo import Watchtower
    merged = tmerge.merge_dir(_family(tmp_path, "straggler"))
    chunks = [r for r in merged if r.get("kind") == "chunk"]
    tower = Watchtower([{"name": "iteration-skew", "kind": "skew",
                         "severity": "warn", "metric": "n_iter",
                         "window_s": 1.0, "lag_above": 10.0,
                         "clear_after_s": 0.5}])
    latest, trans = {}, []
    for rec in chunks:
        latest[rec["host"]] = float(rec["n_iter"])
        trans += tower.observe({f"host:{k}:n_iter": v
                                for k, v in latest.items()},
                               t=float(rec["t"]))
    t = max(r["t"] for r in chunks)
    front = max(latest.values())
    for i in range(40):
        trans += tower.observe({f"host:{k}:n_iter": front for k in latest},
                               t=t + 0.1 * (i + 1))
    fired = [x for x in trans if x["state"] == "firing"]
    assert fired and fired[0]["host"] == 1
    assert "skew[host-1]" in fired[0]["reason"]
    assert any(x["state"] == "ok" for x in trans)


# ---------------------------------------------------------------------
# federation

def _sidecar(tmp_path, host, iters, compiles, gap=None, seq=5):
    from dpsvm_tpu_torch.observability.metrics import (MetricsRegistry,
                                                       write_snapshot)
    reg = MetricsRegistry()
    reg.gauge("dpsvm_train_iterations", "it").set(float(iters))
    reg.gauge("dpsvm_train_gap", "gap").set(
        0.01 * (host + 1) if gap is None else gap)
    reg.gauge("dpsvm_train_n_sv", "n_sv").set(40.0 + host)
    reg.counter("dpsvm_train_compiles_total", "c").inc(compiles)
    reg.counter("dpsvm_serve_requests_total", "r").inc(10 * (host + 1))
    path = os.path.join(str(tmp_path), f"metrics_h{host}.prom")
    write_snapshot(reg, path, seq=seq + host)
    return path


def _fleet_dir(tmp_path, hosts=3, dead=False):
    from dpsvm_tpu_torch.resilience import hostgroup
    srcs = [_sidecar(tmp_path, h, iters=500 - 60 * h, compiles=h + 1)
            for h in range(hosts)]
    if dead:
        srcs.append(os.path.join(str(tmp_path), f"metrics_h{hosts}.prom"))
    hb = os.path.join(str(tmp_path), "hb")
    for h in range(hosts):
        hostgroup.write_heartbeat(hb, h, 500 - 60 * h, generation=2,
                                  seq=9 - h)
    return srcs, hb


@pytest.mark.parametrize("dead, budget", [(False, None), (True, None),
                                          (False, 2)],
                         ids=["all-up", "dead-host", "label-budget"])
def test_federation_matches_jax(dead, budget, tmp_path):
    srcs, hb = _fleet_dir(tmp_path, hosts=4 if budget else 3, dead=dead)
    out = {}
    for tag, mod in (("port", tfleet), ("jax", jfleet)):
        state = mod.collect(srcs, now=NOW)
        snap = mod.federate(
            state, heartbeats=mod.read_heartbeats(hb, now=NOW),
            budget=(mod.TenantLabelBudget(budget) if budget else None))
        out[tag] = (snap, mod.render_exposition(snap),
                    mod.fleet_watch_sample(snap),
                    mod.render_fleet_table(snap))
    (ts, te, tw, tt), (js, je, jw, jt) = out["port"], out["jax"]
    # the snapshot, the exposition text, the watch sample and the table:
    # equal, every field (both read the files at the same ``now``)
    assert ts == js
    assert te == je and tw == jw and tt == jt
    from dpsvm_tpu_torch.observability.metrics import validate_exposition
    assert validate_exposition(te) == []
    hosts = 4 if budget else 3
    assert ts["aggregate"]["dpsvm_fleet_hosts_up"] == float(hosts)
    assert ts["aggregate"]["dpsvm_train_iterations"] == 500 - 60 * (
        hosts - 1)
    assert ts["slowest"] == hosts - 1
    assert ('host="other"' in te) == bool(budget)


def test_sources_and_artifacts_match_jax(tmp_path):
    srcs = ["run/metrics_h2.prom", "http://node-0:9100", "x/host-5.prom"]
    assert tfleet.resolve_sources(srcs) == jfleet.resolve_sources(srcs)
    for mod in (tfleet, jfleet):
        with pytest.raises(mod.FleetError, match="claimed twice"):
            mod.resolve_sources(["a/metrics_h1.prom", "b/metrics_h1.prom"])
    text = open(_sidecar(tmp_path, 0, 5, 1)).read()
    assert tfleet.parse_exposition(text) == jfleet.parse_exposition(text)
    fam = _family(tmp_path, "straggler")
    _, hb = _fleet_dir(tmp_path)
    assert tfleet.host_artifacts(fam, hb, now=NOW) == \
        jfleet.host_artifacts(fam, hb, now=NOW)


def test_a_fleet_bundle_carries_every_host(tmp_path):
    from dpsvm_tpu_torch.observability import blackbox
    fam = _family(tmp_path, "straggler")
    _, hb = _fleet_dir(tmp_path)
    arts = tfleet.host_artifacts(fam, hb)
    assert sorted(arts) == [0, 1, 2]
    fr = blackbox.FlightRecorder(blackbox.make_manifest(solver="dist-smo"))
    fr.event("skew", n_iter=512, host=1)
    bundle = blackbox.dump_bundle(
        os.path.join(str(tmp_path), "bundles"), recorder=fr,
        rule="iteration-skew", severity="warn", window="1s",
        reason="skew[host-1]", extra={"extra": {"host": 1}},
        host_artifacts=arts)
    assert blackbox.validate_bundle(bundle) == []
    assert blackbox.load_incident(bundle)["extra"]["host"] == 1
    assert os.path.exists(os.path.join(bundle, "host-1-heartbeat.json"))


# ---------------------------------------------------------------------
# the commands

def _cli(main, args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue()


CLI_CASES = [("fleet-json", False, ["--json"], 0),
             ("fleet-table", False, [], 0),
             ("fleet-dead", True, [], 3),
             ("fleet-watch", False, ["--watch", "--json"], 0),
             ("fleet-out", False, ["--out", "-"], 0),
             ("fleet-dup", False, ["metrics_h0.prom"], 2),
             ("report", False, None, 0)]


@pytest.mark.parametrize("name, dead, extra, rc_want", CLI_CASES,
                         ids=[c[0] for c in CLI_CASES])
def test_cli_fleet_and_report_match_jax(name, dead, extra, rc_want,
                                        tmp_path, monkeypatch):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    monkeypatch.chdir(tmp_path)
    srcs, hb = _fleet_dir(tmp_path, dead=dead)
    if extra is None:
        args = ["report", _family(tmp_path, "straggler")]
    else:
        dup = [os.path.join(str(tmp_path), "x", e) for e in extra
               if e.endswith(".prom")]
        extra = [e for e in extra if not e.endswith(".prom")]
        args = ["fleet", *srcs, *dup, "--hosts-dir", hb, *extra]
    got = [_cli(m, args) for m in (tmain, jmain)]
    assert got[0][0] == got[1][0] == rc_want, got
    if name in ("fleet-table", "fleet-dead", "fleet-out"):
        # the heartbeat ages read the wall clock: equal but for them (the
        # table's first column, the exposition's non-age lines)
        strip = [[ln.split("  ")[0] for ln in g[1].splitlines()
                  if "heartbeat_age" not in ln] for g in got]
        assert strip[0] == strip[1]
    if name == "fleet-dead":
        assert "UNREACHABLE host(s): 3" in got[0][1]
    if name == "report":
        assert "straggler: host 1" in got[0][1]
        assert _fleet_section(got[0][1]) == _fleet_section(got[1][1])
    if name == "fleet-json":
        snap = json.loads(got[0][1])
        assert snap["slowest"] == 2 and snap["lag"] == 120.0
    if name == "fleet-watch":
        snap = json.loads(got[0][1])
        assert {s["rule"] for s in snap["alerts"]} >= {"iteration-skew",
                                                       "reform-storm"}
    if name == "fleet-dup":
        assert "claimed twice" in got[0][2] and got[0][2] == got[1][2]


def test_cli_fleet_watch_pages_exit_5(tmp_path):
    """A planted paging rule that one sample fires: the watch exit code
    (5) in both packages."""
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    srcs, hb = _fleet_dir(tmp_path)
    rules = os.path.join(str(tmp_path), "rules.json")
    with open(rules, "w") as fh:
        json.dump([{"name": "lagging", "kind": "threshold",
                    "severity": "page", "metric": "iteration_lag",
                    "above": 50.0, "for_s": 0.0}], fh)
    for main in (tmain, jmain):
        rc, out, _ = _cli(main, ["fleet", *srcs, "--watch", "--rules",
                                 rules])
        assert rc == 5 and "lagging PAGE" in out


class _Engine:
    num_attributes = 4
    calibrated = False
    manifest = {"task": "tenant-stub", "num_attributes": 4}

    def infer(self, x, want):
        n = int(np.shape(x)[0])
        return {k: (np.ones(n, np.int32) if k == "labels"
                    else np.zeros(n, np.float32)) for k in want}

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


@pytest.fixture
def tenant_server(tmp_path):
    from dpsvm_tpu_torch.serving.server import ServingServer
    trace = os.path.join(str(tmp_path), "serve.jsonl")
    srv = ServingServer(_Registry(), port=0, max_batch=4,
                        max_delay_ms=0.2, trace_out=trace,
                        trace_sample_rate=1.0, tenant_budget=8).start()
    for i in range(24):
        body = {"instances": [[0.0] * 4],
                "tenant": "t0" if i % 3 else f"t{1 + i % 2}"}
        req = urllib.request.Request(
            srv.url + "/v1/predict", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            r.read()
    yield srv, trace
    if not srv.draining:
        srv.drain(timeout=10.0)


def test_cli_tenants_matches_jax(tenant_server, tmp_path):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    srv, trace = tenant_server
    live = [_cli(m, ["tenants", "--url", srv.url, "--json", "--top", "2"])
            for m in (tmain, jmain)]
    assert live[0][0] == live[1][0] == 0
    assert json.loads(live[0][1]) == json.loads(live[1][1])
    assert json.loads(live[0][1])["rows"][0]["tenant"] == "t0"
    table = _cli(tmain, ["tenants", "--url", srv.url])
    assert table[0] == 0 and "tenants (live): budget 8" in table[1]
    srv.drain(timeout=10.0)
    for args in (["tenants", trace, "--json"], ["tenants", trace]):
        got = [_cli(m, args) for m in (tmain, jmain)]
        assert got[0][0] == got[1][0] == 0
        assert got[0][1] == got[1][1]
    att = json.loads(_cli(tmain, ["tenants", trace, "--json"])[1])
    assert att["rows"][0]["tenant"] == "t0"


def test_cli_tenants_exit_codes_match_jax(tmp_path):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    fam = _family(tmp_path, "straggler")
    no_tenants = os.path.join(fam, "trace_h0.jsonl")
    cases = ((["tenants", no_tenants], 1),
             (["tenants", os.path.join(str(tmp_path), "none.jsonl")], 2),
             (["tenants", "--url", "http://127.0.0.1:9", "--timeout",
               "2"], 2))
    for args, want in cases:
        got = [_cli(m, args) for m in (tmain, jmain)]
        assert got[0][0] == got[1][0] == want, (args, got)
        assert got[0][2].splitlines()[-1].split(":")[0] == \
            got[1][2].splitlines()[-1].split(":")[0]


# ---------------------------------------------------------------------
# the selfchecks and the drills

def test_observability_selfchecks_of_tenants_and_fleet(tmp_path):
    from dpsvm_tpu_torch import observability as obs
    assert obs._selfcheck_tenants(str(tmp_path)) == []
    assert obs._selfcheck_fleet(str(tmp_path)) == []


def test_fleet_cache_drill_holds_the_budget(tmp_path, monkeypatch):
    from dpsvm_tpu.fleet import fleet_cache_drill as jdrill
    from dpsvm_tpu_torch.fleet import fleet_cache_drill, main
    monkeypatch.setenv("DPSVM_PERF_LEDGER",
                       os.path.join(str(tmp_path), "ledger.jsonl"))
    row = fleet_cache_drill(os.path.join(str(tmp_path), "t"), n_models=200,
                            budget=16, device="cpu")
    os.makedirs(os.path.join(str(tmp_path), "j"))
    want = jdrill(os.path.join(str(tmp_path), "j"), n_models=200,
                  budget=16)
    assert row["ok"] and want["ok"]
    for k in ("touches", "hits", "faults", "transients", "evictions",
              "resident", "peak_resident", "hot_models", "metric",
              "models", "budget", "trace_valid", "hot_set_survived_scan"):
        assert row[k] == want[k], k
    assert row["peak_resident"] <= 16 and row["value"] > 0.0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_cache_drill(os.path.join(str(tmp_path), "c"), n_models=8,
                          budget=2)
    # the entry point: one JSON row, exit 0, the ledger row kind "fleet"
    rc, out, _ = _cli(main, ["--drill", "--device", "cpu"])
    assert rc == 0 and json.loads(out)["peak_resident"] <= 32
    from dpsvm_tpu_torch.observability import ledger
    rows = ledger.read(os.environ["DPSVM_PERF_LEDGER"])
    assert rows[-1]["case"] == "fleet_cache_drill"
    assert rows[-1]["kind"] == "fleet"


def test_fleet_selfcheck_writes_a_valid_trace(tmp_path):
    from dpsvm_tpu_torch.fleet import selfcheck
    assert selfcheck(str(tmp_path), device="cpu") == []
    assert os.path.exists(os.path.join(str(tmp_path),
                                       "fleet_selfcheck.jsonl"))


def test_the_straggler_drill_needs_a_device_or_cpu(tmp_path):
    import torch

    from dpsvm_tpu_torch.resilience import hostgroup
    if torch.cuda.is_available():
        pytest.skip("this check is of a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hostgroup.straggler_drill(str(tmp_path))


@pytest.mark.slow
def test_straggler_drill_end_to_end(tmp_path, monkeypatch):
    from dpsvm_tpu_torch.observability import ledger
    from dpsvm_tpu_torch.resilience import hostgroup
    monkeypatch.setenv("DPSVM_PERF_LEDGER",
                       os.path.join(str(tmp_path), "ledger.jsonl"))
    facts = hostgroup.straggler_drill(str(tmp_path / "d"), device="cpu")
    assert facts["straggler"] == 1 and facts["skew_fired"] >= 1
    assert facts["skew_cleared"] >= 1
    assert facts["straggler_behind_s"] > 0.1
    rows = ledger.read(os.environ["DPSVM_PERF_LEDGER"])
    assert rows[-1]["case"] == "straggler_drill"
    assert rows[-1]["host_count"] == 3
