"""The port's serving modules (``dpsvm_tpu_torch/serving``) on the CPU,
against the port's own decision functions and the JAX package's
``dpsvm_tpu/serving`` on the same model files.

Bars, and why:

* the engine against ``decision_function``: bitwise on the same block at
  the same shape (one definition of the decision block), and bitwise
  across request sizes too: both compute every decision in tiles of
  ``ROW_TILE`` rows (``models/svm.row_tiles``), because the CPU's products
  are not bitwise across row counts (a one-row product and odd-length
  reductions take other kernels);
* the port's engine against JAX's engine on the same model file within
  1e-5 (``tests/test_torch_models.py``'s decision bar), for binary SVC
  with Platt, SVR, one-class, precomputed, approx (RFF and Nystrom) and a
  one-vs-one directory; ``precision="default"`` (bfloat16 operands) within
  JAX's ``DECISION_TOL`` = 5e-2 of the float32 decisions;
* the batcher: a staged queue's answers bitwise the engine on the
  coalesced rows, within 1e-5 of direct calls; queue-full rejects at
  once; close drains or fails pending work as JAX's does;
* the registry: hot reload serves the new artifact at generation 2; an
  injected reload failure leaves the old engine live; ``promote_file``;
* ``ShardedDecider`` on four CPU "devices": bitwise its own
  ``reference``, within 1e-5 of the single-device ladder, the byte
  estimates JAX's;
* ``test --batch N`` against the monolithic ``test``: the same labels
  (away from |decision| < 1e-5) and decisions within 1e-5;
* the serving selfcheck, in process and as a module.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import numpy as np
import pytest
import torch

from dpsvm_tpu.serving import engine as jeng
from dpsvm_tpu.serving import sharded as jsharded
from dpsvm_tpu_torch.approx.primal import fit_approx
from dpsvm_tpu_torch.cli import main as tmain
from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.data.synthetic import make_blobs, save_csv
from dpsvm_tpu_torch.models.calibration import save_platt, sigmoid_proba
from dpsvm_tpu_torch.models.io import load_model, save_model
from dpsvm_tpu_torch.models.multiclass import (pairwise_decisions,
                                               predict_multiclass,
                                               save_multiclass,
                                               train_multiclass)
from dpsvm_tpu_torch.models.svm import (SVMModel, decision_function,
                                        pairwise_decision_values)
from dpsvm_tpu_torch.resilience import faultinject as tfault
from dpsvm_tpu_torch.serving import engine as teng
from dpsvm_tpu_torch.serving import sharded as tsharded
from dpsvm_tpu_torch.serving.batcher import (BatcherClosedError,
                                             MicroBatcher, QueueFullError)
from dpsvm_tpu_torch.serving.registry import ModelRegistry
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
DECISION_TOL = 5e-2          # tests/test_precision.py's bf16 bar


@pytest.fixture(autouse=True)
def _clean_faults():
    tfault.clear()
    yield
    tfault.clear()


def _mk_model(n_sv=40, d=5, seed=0, b=0.2, gamma=0.5, task="svc",
              zero_frac=0.0):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.05, 2.0, n_sv).astype(np.float32)
    if zero_frac:
        alpha[: int(n_sv * zero_frac)] = 0.0
    return SVMModel(
        x_sv=rng.standard_normal((n_sv, d)).astype(np.float32),
        alpha=alpha,
        y_sv=(np.ones(n_sv, np.int32) if task == "oneclass" else
              np.where(rng.random(n_sv) < 0.5, -1, 1).astype(np.int32)),
        b=b, gamma=gamma, task=task)


def _rows(n, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


def _bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _same_block(engine, model, q):
    """The engine's answer for ``q`` is bitwise ``decision_function`` on
    each padded bucket block it ran."""
    out = engine.decision_values(q)
    for lo, take, bucket in engine._ladder.plan(q.shape[0]):
        block = np.zeros((bucket, q.shape[1]), np.float32)
        block[:take] = q[lo:lo + take]
        want = decision_function(model, block, device=CPU)[:take]
        assert _bits(out[lo:lo + take], want), (q.shape, bucket)
    return out


@pytest.mark.parametrize("max_batch", [1, 5, 32, 256])
def test_bucket_ladder_matches_jax(max_batch):
    assert teng.bucket_ladder(max_batch) == jeng.bucket_ladder(max_batch)


def test_ladder_refuses_an_empty_top_rung():
    with pytest.raises(ValueError, match="max_batch must be >= 1"):
        teng.bucket_ladder(0)


def test_engine_bitwise_on_the_block_and_no_captures_on_the_cpu():
    model = _mk_model(d=6, seed=3)
    teng.reset_counts()
    engine = teng.PredictionEngine(model, max_batch=32, device=CPU)
    assert engine.buckets == [1, 2, 4, 8, 16, 32]
    assert engine.warmup_captures == 0 and engine.captured == 0
    from dpsvm_tpu_torch.serving import mixed_sizes
    for i, s in enumerate(mixed_sizes(32)):
        q = _rows(s, 6, seed=10 + i)
        out = _same_block(engine, model, q)
        assert _bits(out, decision_function(model, q, device=CPU)), s
    # a row's decision does not depend on the request around it
    big = _rows(77, 6, seed=99)
    whole = decision_function(model, big, device=CPU)
    for lo, hi in ((0, 1), (5, 6), (3, 40), (31, 77)):
        assert _bits(engine.decision_values(big[lo:hi]), whole[lo:hi])
    assert teng.COUNTS == {"captures": 0, "replays": 0}
    counts = engine.bucket_counts()
    # 24 passes for the mixed sizes, 6 for the four slices
    assert counts[32] >= 2 and sum(counts.values()) == 30
    assert engine.manifest["warmup_captures"] == 0


def test_compaction_matches_jax_and_is_counted():
    model = _mk_model(n_sv=40, d=5, zero_frac=0.25)
    tm, tdrop = teng.compact_model(model)
    jm, jdrop = jeng.compact_model(dataclasses.replace(model))
    assert tdrop == jdrop == 10
    np.testing.assert_array_equal(tm.x_sv, jm.x_sv)
    np.testing.assert_array_equal(tm.alpha, jm.alpha)
    assert teng.compact_model(tm)[0] is tm
    engine = teng.PredictionEngine(model, max_batch=8, device=CPU)
    assert engine.manifest["n_sv_dropped"] == 10 and engine.n_sv == 30
    q = _rows(7, 5)
    np.testing.assert_allclose(engine.decision_values(q),
                               decision_function(model, q, device=CPU),
                               rtol=0, atol=1e-5)


def _svm_file(tmp_path, kind):
    """(path, port model) of each model kind the engine serves."""
    path = str(tmp_path / f"{kind}.model")
    if kind in ("rff", "nystrom"):
        x, y = make_blobs(n=200, d=5, seed=4)
        model, _ = fit_approx(x, y, SVMConfig(
            solver=f"approx-{kind}", approx_dim=32, c=10.0, epsilon=5e-3,
            max_iter=300), device=CPU)
        path = str(tmp_path / f"{kind}.npz")
        save_model(model, path)
        return path, load_model(path)
    if kind == "precomputed":
        rng = np.random.default_rng(5)
        model = SVMModel(x_sv=np.zeros((12, 0), np.float32),
                         alpha=rng.uniform(0.1, 1.0, 12).astype(np.float32),
                         y_sv=np.where(rng.random(12) < 0.5, -1,
                                       1).astype(np.int32),
                         b=0.1, gamma=0.0, kernel="precomputed",
                         sv_idx=np.sort(rng.choice(30, 12, replace=False)),
                         n_train=30)
    else:
        model = _mk_model(d=5, seed=6, task=kind)
    save_model(model, path)
    if kind == "svc":
        save_platt(path, -1.3, 0.2)
    return path, load_model(path)


@pytest.mark.parametrize("kind", ["svc", "svr", "oneclass", "precomputed",
                                  "rff", "nystrom"])
def test_engine_per_model_kind_against_jax(tmp_path, kind):
    path, model = _svm_file(tmp_path, kind)
    engine = teng.PredictionEngine.load(path, max_batch=8, device=CPU)
    jengine = jeng.PredictionEngine.load(path, max_batch=8)
    d = engine.num_attributes
    want = ("labels", "decision") + (("proba",) if kind == "svc" else ())
    for i, s in enumerate((1, 3, 8, 13)):
        q = _rows(s, d, seed=20 + i)
        if kind == "precomputed":
            q = np.abs(q)
        _same_block(engine, model, q)
        out, jout = engine.infer(q, want=want), jengine.infer(q, want=want)
        np.testing.assert_allclose(out["decision"], jout["decision"],
                                   rtol=0, atol=1e-5)
        if kind == "svr":
            assert _bits(out["labels"], out["decision"])
        else:
            assert np.array_equal(out["labels"], np.where(
                out["decision"] < 0, -1, 1))
        if kind == "svc":
            assert _bits(out["proba"],
                         sigmoid_proba(out["decision"], -1.3, 0.2))
    m, jm = engine.manifest, jengine.manifest
    for k in ("task", "model_kind", "num_attributes", "n_sv", "buckets",
              "calibrated"):
        assert m[k] == jm[k], k


def _mc_dir(tmp_path, mixed=False):
    x, y = make_blobs(n=150, d=4, seed=2)
    y = np.where(x[:, 0] > 0.5, 2, np.where(y > 0, 1, 0))
    mc, _ = train_multiclass(x, y, SVMConfig(c=5.0, gamma=0.5,
                                             epsilon=1e-2),
                             probability=True, device=CPU)
    if mixed:
        mc = dataclasses.replace(mc, models=[
            dataclasses.replace(mc.models[0], gamma=0.25)]
            + list(mc.models[1:]))
    path = str(tmp_path / ("mixed" if mixed else "mc"))
    save_multiclass(mc, path)
    return path, mc


@pytest.mark.parametrize("mixed", [False, True])
def test_multiclass_segment_pack_against_the_direct_paths(tmp_path, mixed):
    path, mc = _mc_dir(tmp_path, mixed)
    engine = teng.PredictionEngine.load(path, max_batch=16, device=CPU)
    jengine = jeng.PredictionEngine.load(path, max_batch=16)
    q = _rows(16, 4, seed=31)
    dec = engine.decision_values(q)
    if not mixed:
        assert _bits(dec, pairwise_decision_values(mc.models, q,
                                                   device=CPU))
    np.testing.assert_allclose(
        dec, np.stack(pairwise_decisions(mc, q, device=CPU), axis=1),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(dec, jengine.decision_values(q), rtol=0,
                               atol=1e-5)
    labels = engine.predict(q)
    assert np.array_equal(labels, predict_multiclass(
        mc, q, decisions=list(dec.T)))
    assert np.array_equal(labels, jengine.predict(q))
    proba = engine.predict_proba(q)
    np.testing.assert_allclose(proba, jengine.predict_proba(q), atol=1e-4)
    assert engine.manifest["n_pairs"] == 3
    assert len(engine.pairwise_list(q)) == 3


def test_width_and_outputs_are_validated_as_jax():
    msgs = []
    for mod, kw in ((teng, dict(device=CPU)), (jeng, {})):
        engine = mod.PredictionEngine(_mk_model(d=5), max_batch=4, **kw)
        with pytest.raises(ValueError) as e:
            engine.predict(_rows(3, 4))
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="unknown outputs"):
            engine.infer(_rows(3, 5), want=("nope",))
        with pytest.raises(ValueError, match="no probability"):
            engine.infer(_rows(3, 5), want=("proba",))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="precision"):
        teng.PredictionEngine(_mk_model(), precision="fast", device=CPU)


def test_bf16_precision_within_the_decision_tolerance(tmp_path):
    for kind in ("svc", "rff"):
        path, model = _svm_file(tmp_path, kind)
        exact = teng.PredictionEngine.load(path, max_batch=16, device=CPU)
        low = teng.PredictionEngine.load(path, max_batch=16, device=CPU,
                                         precision="default")
        assert low.manifest["precision"] == "default"
        q = _rows(29, exact.num_attributes, seed=41)
        err = np.max(np.abs(low.decision_values(q)
                            - exact.decision_values(q)))
        assert 0 < err <= DECISION_TOL, (kind, err)


# --- the batcher -------------------------------------------------------------

def test_batcher_coalescing_is_deterministic():
    engine = teng.PredictionEngine(_mk_model(d=6, seed=8), max_batch=16,
                                   device=CPU)
    queries = [_rows(s, 6, seed=60 + s) for s in (1, 3, 2, 5, 4, 1, 7)]
    concat = engine.infer(np.concatenate(queries[:6]),
                          want=("labels", "decision"))
    offsets = np.cumsum([0] + [q.shape[0] for q in queries])
    bat = MicroBatcher(engine.infer, max_batch=16, max_delay_ms=50.0,
                       start=False)
    tickets = [bat.submit(q, want=("labels", "decision")) for q in queries]
    bat.start()
    for i, (t, q) in enumerate(zip(tickets, queries)):
        got = t.wait(timeout=30.0)
        direct = engine.infer(q, want=("labels", "decision"))
        if i < 6:       # the first batch: 1+3+2+5+4+1 = 16 rows
            lo, hi = offsets[i], offsets[i + 1]
            assert _bits(got["decision"], concat["decision"][lo:hi])
        # coalesced or alone, the same bits (row tiles)
        assert _bits(got["decision"], direct["decision"])
        assert np.array_equal(got["labels"], direct["labels"])
    st = bat.stats()
    assert st["requests"] == 7 and st["batch_rows_histogram"] == {"16": 1,
                                                                  "7": 1}
    bat.close()


def test_batcher_queue_full_rejects_at_once_and_drains():
    calls = []

    def infer_fn(x, want):
        calls.append(x.shape[0])
        return {"labels": np.zeros(x.shape[0], np.int32)}

    bat = MicroBatcher(infer_fn, max_batch=4, max_queue=6, start=False)
    t1 = bat.submit(_rows(4, 3))
    t2 = bat.submit(_rows(2, 3))
    t0 = time.perf_counter()
    with pytest.raises(QueueFullError):
        bat.submit(_rows(1, 3))
    assert time.perf_counter() - t0 < 0.5
    assert bat.stats()["rejected"] == 1
    bat.start()
    assert t1.wait(10.0)["labels"].shape == (4,)
    assert t2.wait(10.0)["labels"].shape == (2,)
    bat.close(drain=True)
    with pytest.raises(BatcherClosedError):
        bat.submit(_rows(1, 3))
    # without drain, pending tickets fail with BatcherClosedError
    bat2 = MicroBatcher(infer_fn, max_batch=4, start=False)
    pending = bat2.submit(_rows(2, 3))
    bat2.start()
    bat2.close(drain=False)
    try:
        pending.wait(5.0)       # the worker may have taken it first
    except BatcherClosedError:
        pass


def test_batcher_drain_answers_everything_queued():
    engine = teng.PredictionEngine(_mk_model(d=3, seed=9), max_batch=2,
                                   device=CPU)
    bat = MicroBatcher(engine.infer, max_batch=2, max_delay_ms=0.0,
                       max_queue=100, start=False)
    qs = [_rows(1, 3, seed=s) for s in range(9)]
    tickets = [bat.submit(q, want=("decision",)) for q in qs]
    closer = threading.Thread(target=bat.close, kwargs={"drain": True})
    bat.start()
    closer.start()
    for t, q in zip(tickets, qs):
        np.testing.assert_allclose(t.wait(30.0)["decision"],
                                   engine.decision_values(q), atol=1e-5)
    closer.join(30.0)


# --- the registry ------------------------------------------------------------

def test_registry_reload_fault_knob_and_promote(tmp_path):
    model = _mk_model(d=4, seed=12)
    path = str(tmp_path / "m.svm")
    save_model(model, path)
    reg = ModelRegistry()
    reg.register("m", path, max_batch=8, device=CPU)
    reg.register("cold", path, lazy=True, device=CPU)
    man = reg.manifests()
    assert man["m"]["resident"] and not man["cold"]["resident"]
    assert man["m"]["generation"] == 1
    row = _rows(2, 4)
    save_model(dataclasses.replace(model, b=model.b + 1.0), path)
    old = reg.engine("m")
    tfault.install(tfault.FaultPlan(serve_fail_reload=1))
    with pytest.raises(OSError, match="injected reload failure"):
        reg.reload("m")
    tfault.clear()
    assert reg.engine("m") is old and reg.manifests()["m"]["generation"] == 1
    reg.reload("m")
    assert reg.manifests()["m"]["generation"] == 2
    np.testing.assert_allclose(reg.engine("m").decision_values(row),
                               old.decision_values(row) - 1.0, atol=1e-6)
    cand = str(tmp_path / "cand.svm")
    save_model(dataclasses.replace(model, b=model.b - 1.0), cand)
    assert reg.promote_file("m", cand) == 3 and not os.path.exists(cand)
    np.testing.assert_allclose(reg.engine("m").decision_values(row),
                               old.decision_values(row) + 1.0, atol=1e-6)
    assert reg.engine("cold").num_attributes == 4
    assert reg.resident("cold") and reg.evict("cold")
    assert not reg.resident("cold")
    with pytest.raises(KeyError):
        reg.engine("nope")


def test_serve_reload_knob_parses_from_env(monkeypatch):
    monkeypatch.setenv("DPSVM_FAULT_SERVE_FAIL_RELOAD", "1")
    tfault.clear()
    with pytest.raises(OSError):
        tfault.on_serve_reload()
    tfault.on_serve_reload()          # the knob fires once


# --- the sharded decider -----------------------------------------------------

@pytest.mark.parametrize("kind", ["sv", "rff", "nystrom"])
def test_sharded_decider_on_four_cpu_devices(tmp_path, kind):
    if kind == "sv":
        model = _mk_model(n_sv=45, d=5, seed=13)
    else:
        model = _svm_file(tmp_path, kind)[1]
    sd = tsharded.ShardedDecider(model, devices=[CPU] * 4)
    assert sd.n_shards == 4 and sd.padded_len % 4 == 0
    q = _rows(16, 5, seed=51)
    got = sd(q)
    assert _bits(got, sd.reference(q))
    engine = teng.PredictionEngine(model, max_batch=16, device=CPU)
    np.testing.assert_allclose(got.numpy(), engine.decision_values(q),
                               rtol=0, atol=1e-5)
    assert tsharded.model_bytes_est(model) == jsharded.model_bytes_est(
        model)
    assert tsharded.eligible(model)
    facts = sd.facts()
    assert facts["shard_axis"] == ("sv" if kind == "sv" else "feature")
    assert facts["devices"] == ["cpu"] * 4


def test_engine_shards_only_past_its_budget_on_two_devices():
    model = _mk_model(n_sv=45, d=5, seed=13)
    assert not tsharded.eligible(dataclasses.replace(
        model, kernel="precomputed"))
    # on the CPU one device is visible: never sharded, whatever the budget
    engine = teng.PredictionEngine(model, max_batch=8, device=CPU,
                                   hbm_budget_mb=1e-6)
    assert not engine.sharded and engine.manifest["hbm_budget_mb"] == 1e-6
    with pytest.raises(ValueError, match="hbm_budget_mb"):
        teng.PredictionEngine(model, device=CPU, hbm_budget_mb=0)


# --- test --batch --------------------------------------------------------------

def _cli(args):
    buf = StringIO()
    with redirect_stdout(buf):
        rc = tmain(args + ["--device", "cpu"])
    return rc, buf.getvalue()


def _acc(out):
    return [ln for ln in out.splitlines() if "ccuracy" in ln]


@pytest.mark.parametrize("kind", ["binary", "multiclass", "approx"])
def test_cmd_test_batch_matches_monolithic(tmp_path, kind):
    x, y = make_blobs(n=240, d=5, seed=14)
    csv = str(tmp_path / "d.csv")
    if kind == "binary":
        save_csv(csv, x, y)
        assert _cli(["train", "-f", csv, "-m", str(tmp_path / "m"),
                     "-c", "5", "-g", "0.5", "-q"])[0] == 0
        model = str(tmp_path / "m")
    elif kind == "multiclass":
        y = np.where(x[:, 0] > 0.5, 2, np.where(y > 0, 1, 0))
        save_csv(csv, x, y)
        model = _mc_dir(tmp_path)[0]
        x4 = x[:, :4]
        save_csv(csv, x4, y)
    else:
        save_csv(csv, x, y)
        model = _svm_file(tmp_path, "rff")[0]
    outs = {}
    for tag, extra in (("mono", []), ("batch", ["--batch", "16"])):
        pred = str(tmp_path / f"pred_{tag}.txt")
        rc, out = _cli(["test", "-f", csv, "-m", model, "--predictions",
                        pred] + extra)
        assert rc == 0
        outs[tag] = (out, Path(pred).read_text().splitlines())
    assert _acc(outs["mono"][0]) == _acc(outs["batch"][0])
    if kind == "multiclass":
        assert outs["mono"][1] == outs["batch"][1]
        return
    mono = np.array([[float(v) for v in ln.split(",")]
                     for ln in outs["mono"][1]])
    bat = np.array([[float(v) for v in ln.split(",")]
                    for ln in outs["batch"][1]])
    assert np.max(np.abs(mono[:, 1] - bat[:, 1])) <= 1e-5
    far = np.abs(mono[:, 1]) > 1e-5
    assert np.array_equal(mono[far, 0], bat[far, 0])


def test_cmd_test_batch_refuses_a_negative_size(tmp_path, capsys):
    x, y = make_blobs(n=40, d=3, seed=1)
    csv = str(tmp_path / "d.csv")
    save_csv(csv, x, y)
    rc = tmain(["test", "-f", csv, "-m", str(tmp_path / "none"), "--batch",
                "-1", "--device", "cpu"])
    assert rc == 2 and "--batch must be >= 0" in capsys.readouterr().err


# --- the gate ------------------------------------------------------------------

def test_serving_selfcheck():
    from dpsvm_tpu_torch.serving import selfcheck
    assert selfcheck(device="cpu") == []


def test_serving_selfcheck_module_runs_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "dpsvm_tpu_torch.serving", "--selfcheck",
         "--device", "cpu"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "serving selfcheck OK" in r.stdout
