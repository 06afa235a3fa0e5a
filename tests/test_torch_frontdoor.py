"""The port's async front door and weighted-fair queue against the JAX
package's: ``FairQueue``, ``drr_schedule`` and ``parse_tenant_weights``
give the JAX order item for item, the front door answers bitwise the
threaded server over the same artifact, maps errors alike, holds idle
keep-alive connections, refuses past its cap and drains on SIGTERM.
Small models (d = 5), 127.0.0.1:0, one intra-op thread, deadlines on every
wait.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
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
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# ---------------------------------------------------------------------
# the fair queue: the JAX order item for item
# ---------------------------------------------------------------------

SCHEDULES = {
    "weights_8_to_1": ([("gold", 1)] * 160 + [("bronze", 1)] * 160,
                       {"gold": 8.0, "bronze": 1.0}, 8),
    "rows_not_requests": ([("batchy", 16)] * 10 + [("single", 1)] * 160,
                          {}, 16),
    "starvation_bound": ([("hog", 1)] * 800 + [("meek", 1)] * 4,
                         {"hog": 16.0, "meek": 1.0}, 8),
    "oversized": ([("big", 40)] + [("small", 1)] * 64, {}, 8),
    "interleaved": ([(f"t{i % 5}", 1 + i % 7) for i in range(300)],
                    {"t0": 3.0, "t1": 0.5, "t4": 2.0}, 32),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_drr_schedule_matches_jax(name):
    from dpsvm_tpu.serving.fairqueue import drr_schedule as jdrr
    from dpsvm_tpu_torch.serving.fairqueue import drr_schedule
    pushes, weights, quantum = SCHEDULES[name]
    order = drr_schedule(pushes, weights, quantum=quantum)
    assert order == jdrr(pushes, weights, quantum=quantum)
    assert sum(r for _, r in order) == sum(r for _, r in pushes)
    if name == "weights_8_to_1":
        assert sum(1 for t, _ in order[:72] if t == "gold") == 64
        assert sum(1 for t, _ in order[72:144] if t == "gold") == 64


@pytest.mark.parametrize("specs", [
    ["gold=8", "bronze=1.5"], [], ["a=1", "a=2"], ["gold"], ["gold=lots"],
    ["gold=0"], ["gold=-2"], ["=3"], ["x=inf"]])
def test_parse_tenant_weights_matches_jax(specs):
    from dpsvm_tpu.serving.fairqueue import parse_tenant_weights as jp
    from dpsvm_tpu_torch.serving.fairqueue import parse_tenant_weights
    try:
        want = ("ok", jp(specs))
    except ValueError as e:
        want = ("error", str(e))
    try:
        got = ("ok", parse_tenant_weights(specs))
    except ValueError as e:
        got = ("error", str(e))
    assert got == want


def _fq_trace(mod):
    """Pushes, rejections, drops and pops interleaved on one queue: every
    outcome and every stats() in order."""
    fq = mod.FairQueue(weights={"hot": 4.0, "warm": 2.0}, lane_capacity=12,
                       quantum=4)
    out = []
    rng = np.random.default_rng(5)
    for i in range(200):
        op = rng.integers(0, 3)
        if op < 2:
            tenant = ("hot", "warm", "cold")[int(rng.integers(0, 3))]
            rows = int(rng.integers(1, 6))
            try:
                fq.push(tenant, i, rows)
                out.append(("push", tenant, rows))
            except mod.LaneFullError as e:
                out.append(("full", str(e)))
        else:
            out.append(("pop", fq.pop()))
        if i % 50 == 49:
            out.append(("drop", fq.drop(lambda item: item % 7 == 0)))
            st = fq.stats()
            out.append(("stats", st["rows_queued"], {
                k: {kk: vv for kk, vv in v.items()}
                for k, v in st["lanes"].items()}))
            out.append(("depths", fq.depths(), len(fq), fq.rows_queued))
    return out


def test_fair_queue_operations_match_jax():
    from dpsvm_tpu.serving import fairqueue as jfq
    from dpsvm_tpu_torch.serving import fairqueue as pfq
    assert _fq_trace(pfq) == _fq_trace(jfq)
    assert pfq.DEFAULT_QUANTUM_ROWS == jfq.DEFAULT_QUANTUM_ROWS


# ---------------------------------------------------------------------
# the async front door against the threaded server
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def front_door(tmp_path_factory):
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.serving.frontdoor import AsyncFrontDoor
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    from dpsvm_tpu_torch.serving.server import ServingServer
    tmp = tmp_path_factory.mktemp("fd")
    path = str(tmp / "m.svm")
    model = _mk_model(seed=21)
    save_model(model, path)
    reg_a, reg_t = ModelRegistry(), ModelRegistry()
    reg_a.register("default", path, max_batch=8, device="cpu")
    reg_t.register("default", path, max_batch=8, device="cpu")
    fd = AsyncFrontDoor(
        ServingServer(reg_a, port=0, max_batch=8, max_delay_ms=1.0,
                      max_queue=64, device="cpu"),
        tenant_weights={"gold": 8.0}, max_connections=64).start()
    thr = ServingServer(reg_t, port=0, max_batch=8, max_delay_ms=1.0,
                        max_queue=64, device="cpu").start()
    yield fd, thr, model, path
    fd.drain(timeout=10.0)
    thr.drain(timeout=10.0)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 30])
def test_async_answers_bitwise_the_threaded_server(front_door, n):
    fd, thr, _, _ = front_door
    payload = {"instances": _rows(n, 5, seed=100 + n).tolist(),
               "return": ["labels", "decision"]}
    ca, ba = _post(fd.url + "/v1/predict", payload)
    ct, bt = _post(thr.url + "/v1/predict", payload)
    assert ca == ct == 200
    a = np.asarray(ba["decision"], np.float32)
    t = np.asarray(bt["decision"], np.float32)
    assert np.array_equal(a.view(np.int32), t.view(np.int32))
    assert ba["labels"] == bt["labels"]


@pytest.mark.parametrize("payload", [
    {"instances": [[1.0, 2.0]]},
    {"instances": []},
    {"instances": [[1.0] * 5], "return": ["bogus"]},
    {"instances": [[1.0] * 5], "model": "nope"},
    {"instances": [[1.0] * 5], "return": ["proba"]},
])
def test_async_error_mapping_matches_threaded(front_door, payload):
    fd, thr, _, _ = front_door
    ca, ba = _post(fd.url + "/v1/predict", payload)
    ct, bt = _post(thr.url + "/v1/predict", payload)
    assert ca == ct and ca in (400, 404, 413)
    assert "error" in ba and "error" in bt


def test_async_span_chain_and_lane_metrics(front_door):
    from dpsvm_tpu_torch.observability.metrics import validate_exposition
    fd, thr, _, _ = front_door
    code, body = _post(fd.url + "/v1/predict",
                       {"instances": _rows(3, 5).tolist()},
                       headers={"X-Trace-Spans": "1", "X-Tenant": "gold"})
    assert code == 200
    for stage in ("fair_queue", "queue_wait", "batch_form",
                  "device_dispatch", "respond"):
        assert stage in body["spans"], sorted(body["spans"])
    _post(fd.url + "/v1/predict", {"instances": _rows(2, 5).tolist()},
          headers={"X-Tenant": "bronze"})
    code, m = _get(fd.url + "/metricsz")
    fdm = m["front_door"]
    assert fdm["kind"] == "async" and fdm["max_connections"] == 64
    assert fdm["tenant_weights"] == {"gold": 8.0}
    lanes = fdm["fair_queue"]["lanes"]
    assert lanes["gold"]["weight"] == 8.0 and lanes["gold"]["served"] >= 1
    assert lanes["bronze"]["weight"] == 1.0
    code, mt = _get(thr.url + "/metricsz")
    assert mt["front_door"] == {"kind": "threaded"}
    with urllib.request.urlopen(fd.url + "/metricsz?format=prometheus",
                                timeout=10) as r:
        text = r.read().decode()
    assert validate_exposition(text) == []
    assert 'dpsvm_frontdoor_queue_lane_rows{tenant="gold"}' in text


def test_async_concurrent_tenants_bitwise_decision_function(front_door):
    from dpsvm_tpu_torch.models.svm import decision_function
    fd, _, model, _ = front_door
    results = [None] * 24
    lock = threading.Lock()

    def fire(i):
        q = _rows(1 + i % 5, 5, seed=200 + i)
        code, body = _post(fd.url + "/v1/predict",
                           {"instances": q.tolist(), "return": ["decision"]},
                           headers={"X-Tenant": f"t{i % 4}"})
        with lock:
            results[i] = (code, body, q)

    ths = [threading.Thread(target=fire, args=(i,)) for i in range(24)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60.0)
    for r in results:
        assert r is not None
        code, body, q = r
        assert code == 200, body
        got = np.asarray(body["decision"], np.float32)
        want = decision_function(model, q, device="cpu")
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_loadgen_holds_idle_connections(front_door):
    from dpsvm_tpu_torch.serving.loadgen import run_loadgen
    fd, _, _, _ = front_door
    row = run_loadgen(fd.url, _rows(64, 5), requests=40, concurrency=4,
                      connections=24, timeout=20.0)
    assert row["open_connections"] == 24
    assert row["errors"] == 0 and row["throughput_rps"] > 0


def test_async_connection_cap_immediate_503(tmp_path):
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.serving.frontdoor import AsyncFrontDoor
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    from dpsvm_tpu_torch.serving.server import ServingServer
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(seed=24), path)
    reg = ModelRegistry()
    reg.register("default", path, max_batch=8, device="cpu")
    fd = AsyncFrontDoor(ServingServer(reg, port=0, max_batch=8,
                                      device="cpu"),
                        max_connections=3).start()
    held = []
    try:
        for _ in range(3):
            held.append(socket.create_connection(("127.0.0.1", fd.port),
                                                 timeout=10))
        time.sleep(0.2)
        s4 = socket.create_connection(("127.0.0.1", fd.port), timeout=10)
        try:
            s4.settimeout(10)
            raw = s4.recv(65536)
            assert b"503" in raw.split(b"\r\n", 1)[0], raw[:200]
        finally:
            s4.close()
        for s in held:
            s.close()
        held = []
        deadline = time.time() + 10
        code = None
        while time.time() < deadline:
            code, _ = _get(fd.url + "/healthz")
            if code == 200:
                break
            time.sleep(0.1)
        assert code == 200
        _, m = _get(fd.url + "/metricsz")
        assert m["front_door"]["connections_rejected"] >= 1
    finally:
        for s in held:
            s.close()
        fd.drain(timeout=10.0)


def test_async_serve_sigterm_drains_and_exits_zero(tmp_path):
    """``serve --front-end async`` under traffic: SIGTERM answers
    everything accepted (200, or 503 while draining) and exits 0."""
    from dpsvm_tpu_torch.models.io import save_model
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(seed=25), path)
    port_file = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               DPSVM_PERF_LEDGER="")
    p = subprocess.Popen(
        [sys.executable, "-m", "dpsvm_tpu_torch.cli", "serve", "-m", path,
         "--port", "0", "--port-file", str(port_file), "--device", "cpu",
         "--max-batch", "8", "--front-end", "async", "--tenant-weight",
         "gold=8", "-q"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 60
    while not (port_file.exists() and port_file.read_text().strip()):
        assert p.poll() is None, p.communicate()[1][-2000:]
        assert time.time() < deadline, "serve never wrote its port file"
        time.sleep(0.05)
    url = f"http://127.0.0.1:{int(port_file.read_text())}/v1/predict"
    results, lock = [], threading.Lock()

    def fire(i):
        try:
            code, _ = _post(url, {"instances": _rows(3, 5, seed=i).tolist()},
                            timeout=30.0,
                            headers={"X-Tenant": "gold" if i % 2
                                     else "bronze"})
        except (urllib.error.URLError, ConnectionError, OSError):
            code = -1                       # refused after the drain began
        with lock:
            results.append(code)

    ths = [threading.Thread(target=fire, args=(i,)) for i in range(12)]
    for t in ths[:6]:
        t.start()
    for t in ths[:6]:
        t.join(30.0)
    p.send_signal(signal.SIGTERM)
    for t in ths[6:]:
        t.start()
    for t in ths:
        t.join(30.0)
    out, err = p.communicate(timeout=60)
    assert p.returncode == 0, err[-2000:]
    assert len(results) == 12
    assert all(c in (200, 503, -1) for c in results), results
    assert results.count(200) >= 6
