"""The port's training run trace held to the JAX package's: the driver's
chunk records on the general pair's first-order path and the fused pair's
plain chunk, the shrinking manager's, the cascade's and the grid's traces,
record for record; an observed run (trace, metrics file and sidecar, watch
rules, bundles, a profiler window) bitwise the bare run with the same count
of stats reads; the metrics exporters; the watch firing into the trace and
a bundle; capture and build accounting; the config's guard rows.

Trajectories part at float32 rounding across frameworks, so b's are held
to the bar of the whole-run shrinking tests (``abs(b - b_jax) <= 1e-4``,
tests/test_torch_shrink.py); n_iter, n_sv and the record sequence must be
equal. Times differ and are not compared; ``compile`` records are checked
on their own (each package records its own programs: JAX its jit compiles,
the port its first launches, captures and builds).
"""

import json
import os
import re
import urllib.request

import numpy as np
import pytest
import torch

from dpsvm_tpu.data.synthetic import make_blobs, make_planted

B_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(path, keep_compiles=False):
    from dpsvm_tpu_torch.observability.report import load_trace
    return [r for r in load_trace(str(path))
            if keep_compiles or r["kind"] != "compile"]


def _assert_same_records(jrecs, trecs):
    """Same kinds in the same order, the same keys a record, equal n_iter
    and n_sv a poll, b's within B_TOL."""
    assert [r["kind"] for r in trecs] == [r["kind"] for r in jrecs]
    for j, t in zip(jrecs, trecs):
        assert set(t) == set(j), (t["kind"], set(t) ^ set(j))
        if t["kind"] in ("chunk", "summary"):
            assert (t["n_iter"], t["n_sv"]) == (j["n_iter"], j["n_sv"])
            assert abs(t["b_lo"] - j["b_lo"]) <= B_TOL
            assert abs(t["b_hi"] - j["b_hi"]) <= B_TOL
        if t["kind"] == "event":
            assert {k: v for k, v in t.items() if k != "t"} == \
                {k: v for k, v in j.items() if k != "t"}
    assert trecs[0]["solver"] == jrecs[0]["solver"]


# ---------------------------------------------------------------------
# the driver: both pairs against the JAX driver
# ---------------------------------------------------------------------

@pytest.mark.parametrize("path", ["general", "fused"])
def test_driver_trace_matches_jax_record_for_record(path, tmp_path):
    from dpsvm_tpu import api as japi
    from dpsvm_tpu.config import SVMConfig as JConfig
    from dpsvm_tpu.observability.schema import validate_trace as jvalidate
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.solver import smo

    x, y = make_blobs(n=96, d=6, seed=3)
    kw = dict(c=1.0, gamma=0.5, epsilon=1e-3, chunk_iters=16,
              max_iter=20000)
    jt, tt = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jpallas = "off" if path == "general" else "on"
    jres = japi.train(x, y, JConfig(use_pallas=jpallas, trace_out=str(jt),
                                    **kw))
    cfg = SVMConfig(trace_out=str(tt), **kw)
    res = (smo.train_single_device(x, y, cfg, torch.device("cpu"))
           if path == "general" else api.train(x, y, cfg, device="cpu"))
    assert res.n_iter == jres.n_iter
    jrecs, trecs = _records(jt), _records(tt)
    _assert_same_records(jrecs, trecs)
    chunks = [r for r in trecs if r["kind"] == "chunk"]
    assert len(chunks) >= 4
    for c, jc in zip(chunks, [r for r in jrecs if r["kind"] == "chunk"]):
        # the JAX driver's phase names, poll for poll
        assert set(c["phases"]) == set(jc["phases"])
        assert c["hbm"] == {"in_use": None, "peak": None, "limit": None}
    assert set(trecs[-1]["phases"]) == {"dispatch", "poll", "checkpoint"}
    assert trecs[0]["env"] == {"backend": "cpu", "device_kind": "cpu",
                               "device_count": 1}
    s = trecs[-1]
    assert (s["n_iter"], s["n_sv"], s["converged"]) == (
        res.n_iter, res.n_sv, res.converged)
    # each package's validator takes the other's trace
    assert jvalidate(_records(tt, keep_compiles=True)) == []
    comp = [r for r in _records(tt, keep_compiles=True)
            if r["kind"] == "compile"]
    if path == "fused":
        assert [c["program"] for c in comp] == ["fused-chunk"]
        assert comp[0]["flops"] == 4.0 * 96 * 6
        assert comp[0]["bytes"] == 96 * 6 * 4 + 2 * 6 * 4 + 5 * 96 * 4 + 32
    else:
        assert comp == []       # the CPU's eager loop captures nothing


def test_shrink_trace_matches_jax(tmp_path, monkeypatch):
    from dpsvm_tpu import api as japi
    from dpsvm_tpu.config import SVMConfig as JConfig
    from dpsvm_tpu.solver import shrink as jshrink
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.solver import shrink as tshrink

    monkeypatch.setattr(jshrink, "SHRINK_CHECK_ITERS", 128)
    monkeypatch.setattr(tshrink, "SHRINK_CHECK_ITERS", 128)
    x, y = make_planted(190, 40, 0.25, seed=2)
    kw = dict(c=1.0, epsilon=1e-3, chunk_iters=64, shrinking=True,
              kernel="linear")
    jt, tt = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    japi.train(x, y, JConfig(trace_out=str(jt), **kw))
    res = api.train(x, y, SVMConfig(trace_out=str(tt), **kw), device="cpu")
    trecs = _records(tt)
    _assert_same_records(_records(jt), trecs)
    events = [r["event"] for r in trecs if r["kind"] == "event"]
    assert "shrink" in events and events[-1] == "unshrink"
    for r in trecs:
        if r.get("event") == "shrink":
            assert r["n_active_before"] > r["n_active_after"]
    actives = [r["n_active"] for r in trecs if r["kind"] == "chunk"]
    assert actives[0] == 190 and min(actives) < 190
    assert trecs[-1]["n_iter"] == res.n_iter and trecs[0]["solver"] == \
        "shrink"


def test_cascade_trace_matches_jax(tmp_path):
    from dpsvm_tpu import api as japi
    from dpsvm_tpu.config import SVMConfig as JConfig
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig

    x, y = make_blobs(n=300, d=8, seed=3)
    kw = dict(solver="cascade", approx_dim=8, screen_margin=1e-3, c=1.0,
              gamma=0.125, epsilon=1e-3)
    jt, tt = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    japi.fit(x, y, JConfig(trace_out=str(jt), **kw))
    _, res = api.fit(x, y, SVMConfig(trace_out=str(tt), **kw), device="cpu")
    jrecs, trecs = _records(jt), _records(tt)
    assert [(r["kind"], r.get("event")) for r in trecs] == \
        [(r["kind"], r.get("event")) for r in jrecs]
    for j, t in zip(jrecs, trecs):
        assert set(t) == set(j)
        for k in ("round", "n_kept", "n_readmitted", "n_total", "band"):
            assert t.get(k) == j.get(k)
    events = [r["event"] for r in trecs if r["kind"] == "event"]
    assert events[0] == "screen" and "readmit" in events
    assert events[-1] == "polish"
    s = trecs[-1]
    assert set(s["phases"]) == {"approx", "screen", "polish", "verify"}
    assert (s["n_kept"], s["n_readmitted"]) == (res.n_kept,
                                               res.n_readmitted)


def test_grid_trace_matches_jax(tmp_path):
    from dpsvm_tpu.fleet import grid as jgrid
    from dpsvm_tpu.observability.record import RunTrace as JTrace
    from dpsvm_tpu_torch.fleet import grid as tgrid
    from dpsvm_tpu_torch.observability.record import RunTrace

    x, y = make_blobs(n=200, d=6, seed=4)
    grids = {}
    for tag, mod, trace_cls, kw in (("j", jgrid, JTrace, {}),
                                    ("t", tgrid, RunTrace,
                                     {"device": "cpu"})):
        tr = trace_cls(str(tmp_path / f"{tag}.jsonl"), solver="grid", n=200,
                       d=6, gamma=0.5)
        grids[tag] = mod.train_grid(x, y, cs=(1.0, 10.0), gammas=(0.5,),
                                    trace=tr, **kw)
        tr.close()
    jrecs, trecs = _records(tmp_path / "j.jsonl"), _records(
        tmp_path / "t.jsonl")
    assert [(r["kind"], r.get("event")) for r in trecs] == [
        ("manifest", None), ("event", "grid_cell"), ("event", "grid_cell"),
        ("event", "grid_winner"), ("summary", None)]
    one = 1.0 / grids["t"].n_holdout
    for j, t in zip(jrecs, trecs):
        assert set(t) == set(j)
        if t["kind"] == "event":
            assert (t["c"], np.float32(t["gamma"])) == (j["c"],
                                                        np.float32(j["gamma"]))
            assert abs(t["holdout_acc"] - j["holdout_acc"]) <= one + 1e-9
    assert trecs[-1]["grid_cells"] == 2


# ---------------------------------------------------------------------
# observed = bare: bitwise, with the same count of reads
# ---------------------------------------------------------------------

def _count_host_reads(monkeypatch):
    """Count every copy of a tensor to the host the run makes: .cpu(),
    .item(), .tolist() and .numpy() on any tensor."""
    counts = {"n": 0}
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **k):
            counts["n"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return counts


@pytest.mark.parametrize("path", ["fused", "general", "decomp"])
def test_observed_run_is_bitwise_the_bare_run(path, tmp_path, monkeypatch):
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.solver import driver

    x, y = make_blobs(n=96, d=6, seed=3)
    kw = dict(c=1.0, gamma=0.5, epsilon=1e-3, chunk_iters=16)
    kw.update({"general": dict(selection="second-order"),
               "decomp": dict(working_set=8, inner_iters=4)}.get(path, {}))
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([
        {"name": "gap-stagnation", "kind": "stagnation",
         "severity": "warn", "metric": "gap", "window_s": 60.0}]))
    obs = dict(trace_out=str(tmp_path / "t.jsonl"),
               metrics_out=str(tmp_path / "m.prom"), metrics_port=0,
               watch_rules=str(rules), bundle_dir=str(tmp_path / "b"),
               profile_dir=str(tmp_path / "p"))
    counts = _count_host_reads(monkeypatch)
    runs = []
    for extra in ({}, obs):
        reads, host = driver.READS["stats"], counts["n"]
        r = api.train(x, y, SVMConfig(**kw, **extra), device="cpu")
        runs.append((r, driver.READS["stats"] - reads, counts["n"] - host))
    (bare, nb, hb), (seen, ns, hs) = runs
    assert np.array_equal(bare.alpha.view(np.int32),
                          seen.alpha.view(np.int32))
    assert (bare.n_iter, bare.b, bare.b_lo, bare.b_hi) == (
        seen.n_iter, seen.b, seen.b_lo, seen.b_hi)
    assert nb == ns and hb == hs and nb >= 2
    trecs = _records(obs["trace_out"])
    chunks = [r for r in trecs if r["kind"] == "chunk"]
    if path == "decomp":        # one read a round, the last one polled
        assert [c["rounds"] for c in chunks] == sorted(
            c["rounds"] for c in chunks) and chunks[-1]["rounds"] > 0
    else:
        assert len(chunks) == ns
    assert os.path.isfile(os.path.join(obs["profile_dir"],
                                       "profile_summary.json"))


# ---------------------------------------------------------------------
# exporters, watch, bundles
# ---------------------------------------------------------------------

def test_metrics_snapshot_has_jax_families_and_validates(tmp_path):
    from dpsvm_tpu.observability import metrics as jm
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.observability import metrics as pm
    from dpsvm_tpu_torch.observability import slo

    x, y = make_blobs(n=96, d=6, seed=3)
    out = str(tmp_path / "m.prom")
    api.train(x, y, SVMConfig(c=1.0, gamma=0.5, chunk_iters=16,
                              metrics_out=out), device="cpu")
    text = open(out).read()
    assert pm.validate_exposition(text) == []
    assert jm.validate_exposition(text) == []
    assert slo.parse_snapshot_header(text)["seq"] >= 2
    fams = set(re.findall(r"^# TYPE (dpsvm_train_\w+) ", text, re.M))
    jreg = jm.MetricsRegistry()
    jm.TrainingMetrics(jreg, solver="x")
    want = set(re.findall(r"^# TYPE (dpsvm_train_\w+) ",
                          jreg.render_prometheus(), re.M))
    preg = pm.MetricsRegistry()
    pm.TrainingMetrics(preg, solver="x")
    assert set(re.findall(r"^# TYPE (dpsvm_train_\w+) ",
                          preg.render_prometheus(), re.M)) == want
    assert fams <= want and "dpsvm_train_polls_total" in fams


def test_metrics_sidecar_scraped_mid_run(tmp_path, capsys):
    """The driver's --metrics-port sidecar answers a scrape while the
    loop runs (a stub chunk runner scrapes it from its second chunk)
    and is down when the run ends."""
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.observability.metrics import validate_exposition
    from dpsvm_tpu_torch.solver.driver import ChunkStats, host_training_loop

    scraped = {}

    def step(carry, limit):
        if limit == 20 and not scraped:
            url = re.search(r"(http://\S+/metricsz)",
                            capsys.readouterr().err).group(1)
            with urllib.request.urlopen(url + "?format=prometheus",
                                        timeout=10) as r:
                scraped["text"] = r.read().decode()
            scraped["url"] = url
        return carry, ChunkStats(limit, 1.0, 0.0, 3, 0, ())

    cfg = SVMConfig(max_iter=40, chunk_iters=10, metrics_port=0)
    host_training_loop(cfg, 1.0, None, step,
                       lambda cr: (np.zeros(3), np.zeros(3)))
    assert validate_exposition(scraped["text"]) == []
    assert "dpsvm_train_iterations 10" in scraped["text"]
    with pytest.raises(OSError):
        urllib.request.urlopen(scraped["url"], timeout=2)


def test_watch_rule_fires_into_the_trace_and_a_bundle(tmp_path):
    """A tiny stagnation window fires mid-run: the trace records alert ->
    incident, the bundle validates under both packages and renders with
    its embedded report, and the run itself is not stopped."""
    from dpsvm_tpu.observability import blackbox as jb
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.observability import blackbox as pb

    # the JAX watch drill's data: an epsilon no run reaches, so the gap
    # stagnates
    rng = np.random.default_rng(1)
    x = rng.standard_normal((80, 6)).astype(np.float32)
    y = np.where(x[:, 0] > 0, 1, -1).astype(np.int32)
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([
        {"name": "gap-stagnation", "kind": "stagnation",
         "severity": "warn", "metric": "gap", "window_s": 1e-3}]))
    trace = str(tmp_path / "t.jsonl")
    r = api.train(x, y, SVMConfig(c=1.0, epsilon=1e-12,
                                  chunk_iters=64, max_iter=2000,
                                  watch_rules=str(rules), trace_out=trace,
                                  bundle_dir=str(tmp_path / "b")),
                  device="cpu")
    evs = [e for e in _records(trace) if e["kind"] == "event"]
    alerts = [e for e in evs if e["event"] == "alert"]
    incidents = [e for e in evs if e["event"] == "incident"]
    assert alerts and alerts[0]["rule"] == "gap-stagnation"
    assert alerts[0]["n_iter"] < r.n_iter    # alerting does not stop it
    assert incidents and os.path.isdir(incidents[0]["bundle"])
    bundle = incidents[0]["bundle"]
    assert pb.validate_bundle(bundle) == [] and jb.validate_bundle(bundle) \
        == []
    assert pb.load_incident(bundle)["source"] == "training"
    text = pb.render_bundle(bundle)
    assert "embedded trace:" in text and "run: fused-pallas" in text


# ---------------------------------------------------------------------
# capture and build accounting, events, guards
# ---------------------------------------------------------------------

def test_build_and_first_launch_observations(tmp_path, monkeypatch):
    """Every nvcc build is one ``build:<library>`` observation (a fake
    nvcc here writes the library); ``instrument`` observes a runner's
    first call once; the decomposition's round carries kernel B's work
    an inner step."""
    from dpsvm_tpu_torch import api, build
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.observability import compilewatch

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 1 ]; do\n"
                    "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
                    "  shift\ndone\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    compilewatch.drain()
    build.build_all()
    got = compilewatch.drain()
    assert sorted(r["program"] for r in got) == ["build:fused_step",
                                                  "build:subsolve"]
    assert all(r["flops"] is None and r["seconds"] >= 0 for r in got)
    build.build_all()                       # built: nothing to observe
    assert compilewatch.pending() == 0

    calls = []
    run = compilewatch.instrument(lambda v: calls.append(v), "p",
                                  signature="s", flops=2.0, bytes=4.0)
    run(1)
    run(2)
    obs = compilewatch.drain()
    assert calls == [1, 2] and len(obs) == 1
    assert (obs[0]["program"], obs[0]["flops"], obs[0]["bytes"]) == (
        "p", 2.0, 4.0)

    x, y = make_blobs(n=96, d=6, seed=3)
    trace = str(tmp_path / "t.jsonl")
    api.train(x, y, SVMConfig(c=1.0, gamma=0.5, working_set=8,
                              inner_iters=4, trace_out=trace), device="cpu")
    comp = [r for r in _records(trace, keep_compiles=True)
            if r["kind"] == "compile"]
    assert [c["program"] for c in comp] == ["decomp-chunk/q=8"]
    assert (comp[0]["flops"], comp[0]["bytes"]) == (88.0, 64.0)


def test_queued_events_land_in_the_trace(tmp_path):
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.solver import driver

    x, y = make_blobs(n=96, d=6, seed=3)
    trace = str(tmp_path / "t.jsonl")
    driver.queue_trace_event("quarantine", shard=1, reason="crc", rows=7)
    api.train(x, y, SVMConfig(c=1.0, gamma=0.5, trace_out=trace),
              device="cpu")
    recs = _records(trace)
    assert recs[1]["event"] == "quarantine" and recs[1]["rows"] == 7
    assert driver.EVENTS == [("quarantine", {"shard": 1, "reason": "crc",
                                             "rows": 7})]


def test_trace_env_and_memory_facts_on_the_cpu():
    from dpsvm_tpu_torch.observability.device import memory_snapshot
    from dpsvm_tpu_torch.solver.driver import trace_env
    assert memory_snapshot("cpu") == {"in_use": None, "peak": None,
                                      "limit": None}
    assert trace_env("cpu") == {"backend": "cpu", "device_kind": "cpu",
                                "device_count": 1}


GUARDS = [dict(metrics_port=70000), dict(metrics_port=-1),
          dict(polish=True, trace_out="t.jsonl"),
          dict(solver="cascade", profile_dir="p"),
          dict(shrinking=True, profile_dir="p"),
          dict(shrinking=True, metrics_out="m"),
          dict(shrinking=True, metrics_port=0),
          dict(shrinking=True, watch_rules="r"),
          dict(shrinking=True, bundle_dir="b")]


@pytest.mark.parametrize("kw", GUARDS,
                         ids=["-".join(map(str, g)) for g in GUARDS])
def test_observability_guards_match_jax(kw):
    from dpsvm_tpu.config import SVMConfig as JConfig
    from dpsvm_tpu_torch.config import SVMConfig
    msgs = []
    for cls in (JConfig, SVMConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cv_refuses_a_trace_like_jax():
    from dpsvm_tpu.config import SVMConfig as JConfig
    from dpsvm_tpu.models.cv import cross_validate as jcv
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.models.cv import cross_validate

    x, y = make_blobs(n=40, d=3, seed=0)
    msgs = []
    for fn, cls, kw in ((jcv, JConfig, {}), (cross_validate, SVMConfig,
                                            {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            fn(x, y, 3, cls(max_iter=100, trace_out="t.jsonl"), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "trace_out" in msgs[0]
