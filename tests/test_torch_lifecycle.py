"""The port's lifecycle loop against the JAX package's: the KS distance,
the drift detector and the hedge delay exact on the same inputs; the live
drift drill at its defaults (96-row shards, approx_dim 64) running the
same stage events in order, promoting, and recovering the shifted
accuracy in both packages; the compare gate refused at construction until
its tools are ported; a full-width (d = 784) drill on a small log.
"""

import json
import os

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", range(6))
def test_ks_distance_matches_jax(case):
    from dpsvm_tpu.serving.lifecycle import ks_distance as jks
    from dpsvm_tpu_torch.serving.lifecycle import ks_distance
    rng = np.random.default_rng(case)
    a = rng.standard_normal(64 + 50 * case)
    b = 0.3 * case + rng.standard_normal(100 + 17 * case)
    if case == 5:
        b = np.array([])
    assert ks_distance(a, b) == jks(a, b)
    assert ks_distance(a, a) == 0.0


def test_drift_detector_matches_jax():
    from dpsvm_tpu.serving.lifecycle import DriftDetector as JD
    from dpsvm_tpu_torch.serving.lifecycle import DriftDetector as PD
    rng = np.random.default_rng(0)
    ref = rng.standard_normal(512)
    windows = [np.random.default_rng(k).standard_normal(512) + 0.4 * k
               for k in range(6)]
    windows.append(windows[5][:32])
    windows.append(np.concatenate([windows[0], [np.nan] * 50]))
    p, j = PD(ref), JD(ref)
    for w in windows:
        assert p.check(w) == j.check(w)
    p.rearm(windows[5])
    j.rearm(windows[5])
    for w in windows:
        assert p.check(w) == j.check(w)
    for bad in ({"threshold": 0.0}, {"threshold": 1.5}):
        with pytest.raises(ValueError):
            PD(ref, **bad)
    with pytest.raises(ValueError):
        PD([1.0])


@pytest.mark.parametrize("n", [0, 5, 15, 16, 100, 512])
def test_hedge_delay_matches_jax(n):
    from dpsvm_tpu.serving.budget import hedge_delay_s as jh
    from dpsvm_tpu_torch.serving.budget import hedge_delay_s
    lat = np.random.default_rng(n).exponential(3.0, n)
    assert hedge_delay_s(lat) == jh(lat)


def _mk_model(seed=0, d=4, b=0.2):
    from dpsvm_tpu_torch.models.svm import SVMModel
    rng = np.random.default_rng(seed)
    return SVMModel(
        x_sv=rng.standard_normal((20, d)).astype(np.float32),
        alpha=rng.uniform(0.05, 2.0, 20).astype(np.float32),
        y_sv=np.where(rng.random(20) < 0.5, -1, 1).astype(np.int32),
        b=b, gamma=0.5)


def test_compare_gate_is_refused_at_construction(tmp_path):
    """A loop armed with a baseline trace AND a regression bar is built
    and gates on ``compare`` (the refusal this test once pinned is gone):
    a candidate trace slower past the bar holds, an equal one passes, an
    unreadable one holds with the reason; either half alone leaves the
    accuracy floor as the gate."""
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.observability.record import RunTrace
    from dpsvm_tpu_torch.serving.lifecycle import (DriftDetector,
                                                   LifecycleLoop,
                                                   RetrainResult)
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    path = str(tmp_path / "m.svm")
    save_model(_mk_model(), path)
    reg = ModelRegistry()
    reg.register("default", path, max_batch=8, device="cpu")
    kw = dict(registry=reg, name="default",
              detector=DriftDetector(np.arange(10.0)),
              score_source=lambda: [], retrain_fn=lambda r, a: None,
              eval_fn=lambda p: 1.0, accuracy_floor=0.5)

    def traced(name, seconds):
        tp = str(tmp_path / name)
        tr = RunTrace(tp, solver="smo", n=8, d=4, gamma=0.5)
        tr.chunk(n_iter=100, b_lo=1.0, b_hi=0.0, n_sv=4)
        tr.summary(converged=True, n_iter=100, b=0.5, b_lo=0.5,
                   b_hi=0.5, n_sv=4, train_seconds=seconds)
        tr.close()
        return tp

    base, same, slow = (traced("a.jsonl", 1.0), traced("b.jsonl", 1.0),
                        traced("c.jsonl", 2.0))
    cand = str(tmp_path / "c.svm")
    save_model(_mk_model(seed=1), cand)
    gated = LifecycleLoop(baseline_trace=base, fail_on_regress_pct=5.0,
                          **kw)
    assert gated.gate(RetrainResult(model_path=cand,
                                    trace_path=same)).passed
    g = gated.gate(RetrainResult(model_path=cand, trace_path=slow))
    assert not g.passed and any("iters_per_sec" in p for p in g.problems)
    g = gated.gate(RetrainResult(model_path=cand, trace_path=cand))
    assert not g.passed and "trace compare failed" in g.problems[0]
    # either half alone is accepted: the gate is the accuracy floor
    loop = LifecycleLoop(baseline_trace=str(tmp_path / "t.jsonl"), **kw)
    loop2 = LifecycleLoop(fail_on_regress_pct=5.0, **kw)
    for lp in (loop, loop2):
        g = lp.gate(RetrainResult(model_path=cand, trace_path=cand))
        assert g.passed and g.problems == []


def test_lifecycle_step_promotes_and_holds(tmp_path):
    """drift -> supervised retrain -> accuracy gate -> atomic hot-swap;
    a candidate under the floor changes nothing."""
    import dataclasses
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.serving.lifecycle import (DriftDetector,
                                                   LifecycleLoop,
                                                   RetrainResult)
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    path = str(tmp_path / "m.svm")
    model = _mk_model()
    save_model(model, path)
    reg = ModelRegistry()
    reg.register("default", path, max_batch=8, device="cpu")
    rng = np.random.default_rng(1)
    window = {"w": rng.standard_normal(256)}
    acc = {"v": 0.9}
    promoted = []

    def retrain(resume_from, attempt):
        cand = str(tmp_path / f"cand{len(promoted)}.svm")
        save_model(dataclasses.replace(model, b=model.b + 1.0), cand)
        return RetrainResult(model_path=cand,
                             reference_scores=window["w"])

    loop = LifecycleLoop(registry=reg, name="default",
                         detector=DriftDetector(rng.standard_normal(256)),
                         score_source=lambda: window["w"],
                         retrain_fn=retrain, eval_fn=lambda p: acc["v"],
                         accuracy_floor=0.8,
                         on_promote=promoted.append)
    assert loop.step() == "no-drift"
    window["w"] = 3.0 + rng.standard_normal(256)
    assert loop.step() == "promoted"
    assert reg.manifests()["default"]["generation"] == 2
    assert promoted == ["default"]
    assert loop.step() == "no-drift"            # re-armed on the new scores
    window["w"] = -3.0 + rng.standard_normal(256)
    acc["v"] = 0.5
    assert loop.step() == "gate-held"
    assert reg.manifests()["default"]["generation"] == 2
    assert [h["event"] for h in loop.history] == [
        "drift", "retrain", "promote", "drift", "retrain", "promote"]
    assert loop.history[-1]["ok"] is False


def _drill_events(trace_path, schema):
    return [r["event"] for r in schema.read_trace(trace_path)
            if r.get("kind") == "event"]


def test_live_drift_drill_matches_jax(tmp_path):
    """Both drills at their defaults: the same stage events in order, a
    promotion, the shifted accuracy recovered above the floor, no
    ejection; each trace valid under both schemas."""
    from dpsvm_tpu.observability import schema as js
    from dpsvm_tpu.serving.lifecycle import live_drift_drill as jdrill
    from dpsvm_tpu_torch.observability import schema as ps
    from dpsvm_tpu_torch.serving.lifecycle import live_drift_drill
    rows = {}
    for tag, fn, kw in (("port", live_drift_drill, {"device": "cpu"}),
                        ("jax", jdrill, {})):
        base = tmp_path / tag
        base.mkdir()
        tr = str(tmp_path / f"{tag}.jsonl")
        row = fn(str(base), trace_path=tr,
                 ledger_path=str(tmp_path / f"{tag}_ledger.jsonl"), **kw)
        assert ps.validate_trace(ps.read_trace(tr)) == []
        assert js.validate_trace(js.read_trace(tr)) == []
        rows[tag] = (row, _drill_events(tr, ps))
    (prow, pev), (jrow, jev) = rows["port"], rows["jax"]
    assert pev == jev
    assert {"append_admitted", "drift", "refresh", "retrain",
            "promote"} <= set(pev)
    for row in (prow, jrow):
        assert row["ok"] and row["promoted"]
        assert row["generation"] == 2 and row["ejections"] == 0
        assert row["accuracy_shifted_after"] >= row["accuracy_floor"]
    assert prow["outcomes"] == jrow["outcomes"]
    assert prow["log_generation"] == jrow["log_generation"]
    led = [json.loads(ln) for ln in
           (tmp_path / "port_ledger.jsonl").read_text().splitlines()]
    assert led and led[-1]["case"] == "live_refresh_latency"
    assert led[-1]["kind"] == "serve" and led[-1]["unit"] == "s"


def test_live_drift_drill_at_full_width(tmp_path):
    """The drill at d = 784 (rows on a 6-dimensional subspace, gamma
    1/6): the same recovery on a small log."""
    from dpsvm_tpu_torch.serving.lifecycle import live_drift_drill
    row = live_drift_drill(str(tmp_path), d=784, rows_per_shard=256,
                           seed_shards=3, append_shards=2, approx_dim=128,
                           max_iter=150, holdout=256, device="cpu")
    assert row["ok"] and row["generation"] == 2, row
    assert row["accuracy_shifted_before"] < row["accuracy_floor"]
    assert row["accuracy_shifted_after"] >= row["accuracy_floor"]
    with pytest.raises(ValueError, match="d >= 6"):
        live_drift_drill(str(tmp_path / "x"), d=4, device="cpu")


def test_drill_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from dpsvm_tpu_torch.serving.lifecycle import live_drift_drill
    with pytest.raises(RuntimeError, match="device='cpu'"):
        live_drift_drill(str(tmp_path))
    assert not os.listdir(tmp_path)
