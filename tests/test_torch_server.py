"""The port's replica pool and threaded HTTP server against the JAX
package's: the same model file served by both answers the same requests
within the engine bars, both expose the same /metricsz keys and Prometheus
families, the pool runs the same event sequence under every serve fault
point, and ``cli serve`` drains on SIGTERM. Models are a few dozen SVs at
d <= 8, servers bind 127.0.0.1:0, every wait has a deadline.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk_model(n_sv=40, d=5, seed=0, b=0.2, gamma=0.5):
    from dpsvm_tpu_torch.models.svm import SVMModel
    rng = np.random.default_rng(seed)
    return SVMModel(
        x_sv=rng.standard_normal((n_sv, d)).astype(np.float32),
        alpha=rng.uniform(0.05, 2.0, n_sv).astype(np.float32),
        y_sv=np.where(rng.random(n_sv) < 0.5, -1, 1).astype(np.int32),
        b=b, gamma=gamma)


def _rows(n, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


def _post(url, payload, timeout=20.0, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body else {})


def _get(url, timeout=20.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _wait_until(pred, timeout_s=15.0, interval_s=0.01):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return pred()


# ---------------------------------------------------------------------
# the threaded server against the JAX one
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_servers(tmp_path_factory):
    """One calibrated model file served by the JAX package's server and by
    the port's (device='cpu'), each with 2 replicas and a serving trace
    sampled at 0.5."""
    from dpsvm_tpu.serving.registry import ModelRegistry as JReg
    from dpsvm_tpu.serving.server import ServingServer as JSrv
    from dpsvm_tpu_torch.models.calibration import save_platt
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    from dpsvm_tpu_torch.serving.server import ServingServer
    tmp = tmp_path_factory.mktemp("servers")
    path = str(tmp / "m.svm")
    save_model(_mk_model(seed=3), path)
    save_platt(path, -1.3, 0.2)
    jreg = JReg()
    jreg.register("default", path, max_batch=16)
    jsrv = JSrv(jreg, port=0, max_batch=16, replicas=2,
                trace_out=str(tmp / "jax.jsonl"),
                trace_sample_rate=0.5).start()
    preg = ModelRegistry()
    preg.register("default", path, max_batch=16, device="cpu")
    psrv = ServingServer(preg, port=0, max_batch=16, replicas=2,
                         trace_out=str(tmp / "port.jsonl"),
                         trace_sample_rate=0.5, device="cpu").start()
    yield jsrv, psrv, path, tmp
    psrv.drain(timeout=10.0)
    jsrv.drain(timeout=10.0)


@pytest.mark.parametrize("n", [1, 3, 16, 37])
def test_answers_match_the_jax_server(both_servers, n):
    jsrv, psrv, _, _ = both_servers
    q = _rows(n, 5, seed=n)
    payload = {"instances": q.tolist(),
               "return": ["labels", "decision", "proba"]}
    cj, bj = _post(jsrv.url + "/v1/predict", payload)
    cp, bp = _post(psrv.url + "/v1/predict", payload)
    assert cj == cp == 200, (bj, bp)
    np.testing.assert_allclose(bp["decision"], bj["decision"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(bp["proba"], bj["proba"], atol=1e-4, rtol=0)
    far = np.abs(np.asarray(bj["decision"])) > 1e-5
    assert np.array_equal(np.asarray(bp["labels"])[far],
                          np.asarray(bj["labels"])[far])
    assert bp["n"] == bj["n"] == n and bp["model"] == bj["model"]


@pytest.mark.parametrize("payload,why", [
    ({"instances": [[1.0, 2.0]]}, "width"),
    ({"instances": []}, "empty"),
    ({"instances": [[1.0] * 5], "return": ["bogus"]}, "output"),
    ({"instances": [[1.0] * 5], "model": "nope"}, "model"),
    ({"instances": [[float("nan")] * 5]}, "nonfinite"),
    ({"instances": "text"}, "shape"),
])
def test_client_errors_match_the_jax_server(both_servers, payload, why):
    jsrv, psrv, _, _ = both_servers
    cj, bj = _post(jsrv.url + "/v1/predict", payload)
    cp, bp = _post(psrv.url + "/v1/predict", payload)
    assert cp == cj, (why, bj, bp)
    assert cp in (400, 404, 413) and "error" in bp


def _families(text):
    return sorted(ln.split()[2] for ln in text.splitlines()
                  if ln.startswith("# TYPE "))


def test_metricsz_keys_and_families_match_the_jax_server(both_servers):
    from dpsvm_tpu.observability.metrics import validate_exposition as jval
    from dpsvm_tpu_torch.observability.metrics import validate_exposition
    jsrv, psrv, _, _ = both_servers
    for srv in (jsrv, psrv):
        for i in range(6):
            code, _ = _post(srv.url + "/v1/predict",
                            {"instances": _rows(2, 5, seed=40 + i).tolist(),
                             "tenant": f"t{i % 2}"})
            assert code == 200
    _, jjson = _get(jsrv.url + "/metricsz")
    _, pjson = _get(psrv.url + "/metricsz")
    jm, pm = json.loads(jjson), json.loads(pjson)
    assert sorted(pm) == sorted(jm)
    assert sorted(pm["models"]["default"]) == sorted(
        jm["models"]["default"])
    assert sorted(pm["models"]["default"]["pool"]) == sorted(
        jm["models"]["default"]["pool"])
    assert pm["stray_compiles"] == 0
    _, jtext = _get(jsrv.url + "/metricsz?format=prometheus")
    _, ptext = _get(psrv.url + "/metricsz?format=prometheus")
    assert _families(ptext) == _families(jtext)
    assert validate_exposition(ptext) == []
    assert jval(ptext) == []
    assert validate_exposition(jtext) == []


def test_healthz_models_and_reload(both_servers):
    import dataclasses
    from dpsvm_tpu_torch.models.io import load_model, save_model
    jsrv, psrv, path, _ = both_servers
    code, body = _get(psrv.url + "/healthz")
    assert code == 200 and json.loads(body)["models"] == ["default"]
    _, models = _get(psrv.url + "/v1/models")
    man = json.loads(models)["models"]["default"]
    assert man["device"] == "cpu" and man["num_attributes"] == 5
    q = _rows(3, 5, seed=9)
    _, before = _post(psrv.url + "/v1/predict",
                      {"instances": q.tolist(), "return": ["decision"]})
    model = load_model(path)
    save_model(dataclasses.replace(model, b=model.b + 1.0), path)
    try:
        code, body = _post(psrv.url + "/v1/reload", {"model": "default"})
        assert code == 200 and body["manifest"]["generation"] == 2
        _, after = _post(psrv.url + "/v1/predict",
                         {"instances": q.tolist(), "return": ["decision"]})
        np.testing.assert_allclose(np.asarray(after["decision"]),
                                   np.asarray(before["decision"]) - 1.0,
                                   atol=1e-5)
    finally:
        save_model(model, path)
        _post(psrv.url + "/v1/reload", {"model": "default"})


def test_serving_traces_validate_across_packages(tmp_path):
    """A drained port server's trace, with its sampled span trees, is
    valid under both schemas, as a drained JAX server's is."""
    from dpsvm_tpu.observability import schema as js
    from dpsvm_tpu.serving.registry import ModelRegistry as JReg
    from dpsvm_tpu.serving.server import ServingServer as JSrv
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.observability import schema as ps
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    from dpsvm_tpu_torch.serving.server import ServingServer
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(seed=5), path)
    traces = {}
    for tag in ("port", "jax"):
        tr = str(tmp_path / f"{tag}.jsonl")
        if tag == "port":
            reg = ModelRegistry()
            reg.register("default", path, max_batch=8, device="cpu")
            srv = ServingServer(reg, port=0, max_batch=8, trace_out=tr,
                                trace_sample_rate=0.25,
                                device="cpu").start()
        else:
            reg = JReg()
            reg.register("default", path, max_batch=8)
            srv = JSrv(reg, port=0, max_batch=8, trace_out=tr,
                       trace_sample_rate=0.25).start()
        for i in range(8):
            assert _post(srv.url + "/v1/predict",
                         {"instances": _rows(2, 5, seed=i).tolist()})[0] \
                == 200
        srv.drain(timeout=10.0)
        traces[tag] = tr
    for tag, tr in traces.items():
        assert ps.validate_trace(ps.read_trace(tr)) == [], tag
        assert js.validate_trace(js.read_trace(tr)) == [], tag
    spans = lambda p: sorted({r["name"] for r in ps.read_trace(p)  # noqa
                              if r["kind"] == "span"})
    assert spans(traces["port"]) == spans(traces["jax"])
    assert {"queue_wait", "device_dispatch"} <= set(spans(traces["port"]))


# ---------------------------------------------------------------------
# the pool with stub engines, under every serve fault point
# ---------------------------------------------------------------------

class StubEngine:
    """A deterministic engine: every row decides ``value``."""

    num_attributes = 4
    calibrated = False

    def __init__(self, value: float = 0.5):
        self.value = value

    def infer(self, x, want):
        n = int(np.shape(x)[0])
        out = {}
        if "labels" in want:
            out["labels"] = np.ones(n, np.int32)
        if "decision" in want:
            out["decision"] = np.full(n, self.value, np.float32)
        return out

    def bucket_counts(self):
        return {}


SCENARIOS = {
    "wedge": dict(plan=dict(serve_wedge_replica=1), n=3,
                  pool=dict(deadline_s=0.3), requests=12, after=6),
    "wedge_after": dict(plan=dict(serve_wedge_replica=2,
                                  serve_wedge_after=4), n=3,
                        pool=dict(deadline_s=0.3), requests=12, after=6),
    "nan": dict(plan=dict(serve_nan_after=3), n=3,
                pool=dict(deadline_s=5.0), requests=12, after=6),
    "failed_rebuild": dict(plan=dict(serve_nan_after=1,
                                     serve_fail_reload=1), n=2,
                           pool=dict(deadline_s=5.0,
                                     rebuild_backoff_s=0.01),
                           requests=4, after=4),
    "hedged_wedge": dict(plan=dict(serve_wedge_replica=1), n=3,
                         pool=dict(deadline_s=0.4, hedge=0.03),
                         requests=1, after=6),
    "slow_hedged": dict(plan=dict(serve_slow_replica_ms=200,
                                  serve_slow_for=1), n=2,
                        pool=dict(deadline_s=5.0, hedge=0.03),
                        requests=1, after=0),
    "all_open": dict(plan=dict(serve_nan_after=1), n=1,
                     pool=dict(deadline_s=5.0, rebuild=False),
                     requests=2, after=0),
}


def _drive_pool(pkg, name, sc):
    """(outcomes, events, counters) of one scenario on one package's pool,
    after its rebuilds settle."""
    fi = __import__(f"{pkg}.resilience.faultinject", fromlist=["x"])
    pool_mod = __import__(f"{pkg}.serving.pool", fromlist=["x"])
    budget = __import__(f"{pkg}.serving.budget", fromlist=["x"])
    fi.reset_serve_wedge()
    fi.install(fi.FaultPlan(**sc["plan"]))
    pool = pool_mod.ReplicaPool(lambda i: StubEngine(), sc["n"], name=name,
                                **sc["pool"])
    outcomes = []
    try:
        def one():
            try:
                out = pool.infer(_rows(1, 4), ("labels", "decision"))
                assert np.all(np.isfinite(out["decision"]))
                return "ok"
            except budget.DeadlineExceededError:
                return "504"
            except pool_mod.PoolUnavailableError:
                return "503"
        for _ in range(sc["requests"]):
            outcomes.append(one())
        if sc["pool"].get("rebuild", True) and sc["plan"].get(
                "serve_slow_replica_ms") is None:
            assert _wait_until(lambda: pool.metrics()["rebuilds"] >= 1)
        for _ in range(sc["after"]):
            outcomes.append(one())
        if sc["pool"].get("rebuild", True):
            assert _wait_until(lambda: pool.replica_states()
                               == ["closed"] * sc["n"]), \
                pool.replica_states()
        m = pool.metrics()
        counters = {k: v for k, v in m.items() if k != "replicas"}
        counters["states"] = [r["state"] for r in m["replicas"]]
        counters["generations"] = [r["generation"] for r in m["replicas"]]
        # a wedge's eject reason names whichever of the reaper's two
        # checks (the compute's age, the dispatch's deadline) saw it
        # first, a race in both packages: compare the kind only
        events = [{k: (v.split(" (")[0] if k == "reason" else v)
                   for k, v in e.items() if k != "error"}
                  for e in pool.events]
        return outcomes, events, counters
    finally:
        fi.release_serve_wedge()
        fi.clear()
        pool.close()
        fi.reset_serve_wedge()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_under_fault_matches_jax(name):
    sc = SCENARIOS[name]
    port = _drive_pool("dpsvm_tpu_torch", name, sc)
    jax_ = _drive_pool("dpsvm_tpu", name, sc)
    assert port == jax_
    outcomes, events, counters = port
    if name.startswith("wedge"):
        assert outcomes.count("504") == 1
        assert [e["event"] for e in events][:2] == ["eject", "rebuild"]
    if name == "nan":
        assert "504" not in outcomes and counters["ejections"] == 1
    if name == "hedged_wedge" or name == "slow_hedged":
        assert counters["hedges_won"] == 1 and outcomes[0] == "ok"
    if name == "all_open":
        assert outcomes == ["503", "503"]
    assert counters["stray_compiles"] == 0


def test_pool_refresh_swaps_generations_while_serving():
    from dpsvm_tpu_torch.serving.pool import ReplicaPool
    vals = iter([1.0, 2.0, 2.0, 2.0])
    pool = ReplicaPool(lambda i: StubEngine(value=next(vals)), 2,
                       name="gen", deadline_s=5.0)
    try:
        got = {float(pool.infer(_rows(1, 4), ("decision",))["decision"][0])
               for _ in range(4)}
        assert got == {1.0, 2.0}
        pool.refresh()
        got = {float(pool.infer(_rows(1, 4), ("decision",))["decision"][0])
               for _ in range(4)}
        assert got == {2.0}
        assert all(r["generation"] == 2 for r in pool.metrics()["replicas"])
    finally:
        pool.close()


def test_stray_captures_count_outside_builds_only():
    """The pool's stray counter drains the capture and build observations
    (``observability/compilewatch``, the source JAX's pool drains): a
    build's own captures are not strays, a capture outside one is, and a
    capture (one ``engine.COUNTS`` step and one observation, as
    ``smo.capture`` makes it) counts once."""
    from dpsvm_tpu_torch.observability import compilewatch
    from dpsvm_tpu_torch.serving import engine as E
    from dpsvm_tpu_torch.serving.pool import ReplicaPool

    def captured():
        E.COUNTS["captures"] += 1
        compilewatch.observe("serve-bucket/rows=1", 0.0)

    def build(i):
        for _ in range(3):                  # a build's warmup captures
            captured()
        return StubEngine()

    pool = ReplicaPool(build, 2, name="strays", deadline_s=5.0,
                       watch_compiles=True)
    try:
        pool.infer(_rows(1, 4), ("decision",))
        assert pool.stray_compiles() == 0
        captured()                          # a capture under traffic
        assert pool.stray_compiles() == 1
        pool.refresh()                      # rebuilds capture inside guards
        assert pool.stray_compiles() == 1
    finally:
        pool.close()


def test_replica_engines_on_the_cpu_get_no_stream(tmp_path):
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.serving.engine import PredictionEngine
    from dpsvm_tpu_torch.serving.pool import ReplicaPool, _replica_stream
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(d=4), path)
    pool = ReplicaPool(lambda i: PredictionEngine.load(
        path, max_batch=8, device="cpu"), 2, name="cpu", deadline_s=5.0)
    try:
        assert all(r.stream is None for r in pool._replicas)
        assert _replica_stream(StubEngine()) is None
        a = pool.infer(_rows(5, 4), ("decision",))["decision"]
        b = pool.infer(_rows(5, 4), ("decision",))["decision"]
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    finally:
        pool.close()


# ---------------------------------------------------------------------
# server resilience: deadlines, the shed ladder, the CLI drain
# ---------------------------------------------------------------------

def test_server_deadline_is_504_and_counted(tmp_path):
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.resilience import faultinject as fi
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    from dpsvm_tpu_torch.serving.server import ServingServer
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(), path)
    reg = ModelRegistry()
    reg.register("default", path, max_batch=8, device="cpu")
    srv = ServingServer(reg, port=0, max_batch=8, device="cpu").start()
    fi.install(fi.FaultPlan(serve_slow_replica_ms=400, serve_slow_for=1))
    try:
        code, body = _post(srv.url + "/v1/predict",
                           {"instances": _rows(1, 5).tolist(),
                            "timeout_ms": 50})
        assert code == 504 and "error" in body
        m = srv.metrics()
        assert m["deadline_504"] == 1
    finally:
        fi.clear()
        srv.drain(timeout=10.0)


def test_server_shed_ladder_proba_then_sibling(tmp_path):
    from dpsvm_tpu_torch.models.calibration import save_platt
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    from dpsvm_tpu_torch.serving.server import ServingServer
    mpath, spath = str(tmp_path / "m.svm"), str(tmp_path / "s.svm")
    save_model(_mk_model(seed=24), mpath)
    save_platt(mpath, -1.0, 0.0)
    save_model(_mk_model(seed=25), spath)
    reg = ModelRegistry()
    reg.register("default", mpath, max_batch=4, device="cpu")
    reg.register("approx-twin", spath, max_batch=4, device="cpu")
    srv = ServingServer(reg, port=0, max_batch=4, max_queue=10,
                        siblings={"default": "approx-twin"},
                        shed_proba_fill=0.3, shed_sibling_fill=0.6,
                        device="cpu")
    try:
        want = ("labels", "proba")
        assert srv.degrade("default", want) == ("default", want, None)
        srv.batcher("default")._rows_queued = 3
        name, eff, marker = srv.degrade("default", want)
        assert name == "default" and "proba" not in eff
        assert marker == "shed_proba"
        srv.batcher("default")._rows_queued = 7
        name, eff, marker = srv.degrade("default", want)
        assert name == "approx-twin" and marker == "sibling:approx-twin"
        srv.batcher("default")._rows_queued = 0
        m = srv.metrics()
        assert m["shed_proba"] >= 1 and m["shed_sibling"] >= 1
        wpath = str(tmp_path / "w.svm")
        save_model(_mk_model(seed=26, d=7), wpath)
        reg.register("wide", wpath, max_batch=4, device="cpu")
        with pytest.raises(ValueError, match="attributes"):
            srv.set_sibling("default", "wide")
    finally:
        srv.drain(timeout=10.0)


def _serve_proc(tmp_path, model_path, extra=()):
    port_file = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               DPSVM_PERF_LEDGER="")
    p = subprocess.Popen(
        [sys.executable, "-m", "dpsvm_tpu_torch.cli", "serve", "-m",
         model_path, "--port", "0", "--port-file", str(port_file),
         "--device", "cpu", "--max-batch", "8", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    deadline = time.time() + 60
    while time.time() < deadline:
        if port_file.exists() and port_file.read_text().strip():
            return p, int(port_file.read_text())
        if p.poll() is not None:
            break
        time.sleep(0.05)
    p.kill()
    out, err = p.communicate(timeout=10)
    raise AssertionError(f"serve never wrote its port file: {err[-2000:]}")


def test_cli_serve_sigterm_drains_and_exits_zero(tmp_path):
    """SIGTERM mid-traffic: every request the server counted reached its
    client (200 or a 503 while draining), the process exits 0."""
    from dpsvm_tpu_torch.models.io import save_model
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(seed=7), path)
    p, port = _serve_proc(tmp_path, path, extra=("-q", "--replicas", "2"))
    url = f"http://127.0.0.1:{port}/v1/predict"
    results, lock = [], threading.Lock()

    def client(seed):
        while True:
            try:
                code, _ = _post(url, {"instances":
                                      _rows(3, 5, seed=seed).tolist()},
                                timeout=30.0)
            except (urllib.error.URLError, ConnectionError, OSError):
                code = -1                   # never accepted
            with lock:
                results.append(code)
            if code != 200:
                return

    ths = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in ths:
        t.start()
    assert _wait_until(lambda: len(results) >= 8, timeout_s=30.0)
    p.send_signal(signal.SIGTERM)
    for t in ths:
        t.join(30.0)
    out, err = p.communicate(timeout=60)
    assert p.returncode == 0, err[-2000:]
    assert "drained (signal 15)" not in err          # -q keeps it quiet
    assert all(c in (200, 503, -1) for c in results), results
    assert results.count(200) >= 8


def test_cli_serve_reports_the_drain_counts(tmp_path):
    from dpsvm_tpu_torch.models.io import save_model
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(seed=8), path)
    p, port = _serve_proc(tmp_path, path)
    url = f"http://127.0.0.1:{port}/v1/predict"
    for i in range(5):
        assert _post(url, {"instances": _rows(2, 5, seed=i).tolist()})[0] \
            == 200
    p.send_signal(signal.SIGTERM)
    out, err = p.communicate(timeout=60)
    assert p.returncode == 0
    assert "drained (signal 15): 5 requests, 0 rejected, 0 errors" in err
    assert "device cpu" in err


def test_cli_loadgen_row_names_the_device_and_lands_in_the_ledger(
        tmp_path):
    from dpsvm_tpu_torch.models.io import save_model
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(seed=9), path)
    p, port = _serve_proc(tmp_path, path, extra=("-q",))
    ledger = tmp_path / "ledger.jsonl"
    try:
        env = dict(os.environ, PYTHONPATH=ROOT,
                   DPSVM_PERF_LEDGER=str(ledger))
        lg = subprocess.run(
            [sys.executable, "-m", "dpsvm_tpu_torch.cli", "loadgen",
             "--url", f"http://127.0.0.1:{port}", "--requests", "30",
             "--batch", "3", "--concurrency", "4",
             "--no-compare-sequential"], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=120)
        assert lg.returncode == 0, lg.stderr
        row = json.loads(lg.stdout.strip().splitlines()[-1])
        assert row["device"] == "cpu" and row["device_name"] == "cpu"
        assert row["errors"] == 0 and row["requests"] == 30
        recs = [json.loads(ln) for ln in ledger.read_text().splitlines()]
        assert len(recs) == 1 and recs[0]["backend"] == "cpu"
        assert recs[0]["kind"] == "loadgen"
        bad = subprocess.run(
            [sys.executable, "-m", "dpsvm_tpu_torch.cli", "loadgen",
             "--url", f"http://127.0.0.1:{port}", "--model", "nope"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
        assert bad.returncode == 2 and "no model" in bad.stderr
    finally:
        p.send_signal(signal.SIGTERM)
        p.communicate(timeout=60)
    assert p.returncode == 0


@pytest.mark.parametrize("args,msg", [
    (["--replicas", "0"], "--replicas must be >= 1"),
    (["--hedge-ms", "soon"], "--hedge-ms must be"),
    (["--degrade-to", "nosep"], "--degrade-to needs NAME=SIBLING"),
    (["--tenant-weight", "gold=8"], "--tenant-weight needs --front-end"),
    (["--trace-sample-rate", "2"], "--trace-sample-rate must be"),
])
def test_cli_serve_flag_errors(tmp_path, args, msg):
    from dpsvm_tpu_torch.cli import main
    from dpsvm_tpu_torch.models.io import save_model
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(), path)
    import contextlib
    import io
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["serve", "-m", path, "--device", "cpu", *args])
    assert rc == 2 and msg in err.getvalue()


def test_cli_serve_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from dpsvm_tpu_torch.cli import main
    from dpsvm_tpu_torch.models.io import save_model
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(), path)
    import contextlib
    import io
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["serve", "-m", path, "--port", "0"])
    assert rc == 2 and "CUDA is not available" in err.getvalue()
