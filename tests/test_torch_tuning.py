"""The port's tuning layer (``dpsvm_tpu_torch/tuning``) held to the JAX
package's (``dpsvm_tpu/tuning``): the same planted profiles and the same
fake measures go to both packages, which must agree on ``apply_tuned``'s
precedence, ``validate_entry``'s problems, ``select_winner`` and the
survivors and probe order of ``successive_halving``; a profile file
written by either package loads in the other. Then the port alone on the
CPU: the device key (a ``cpu`` entry never applies on the card, nor the
reverse), the compile correction on a planted trace, real probes, a tiny
tune run, the CLI's train, serve and tune, the doctor's lines, the
selfcheck, and the fused pair's fit bitwise across ``chunk_iters``.
"""

import json
import os
import time

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs
from dpsvm_tpu.observability import ledger as jledger
from dpsvm_tpu.tuning import profile as jprof
from dpsvm_tpu.tuning import tuner as jtuner
from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.observability import ledger as tledger
from dpsvm_tpu_torch.tuning import profile as prof
from dpsvm_tpu_torch.tuning import tuner
from torch_threads import one_thread  # noqa: F401

CARD = "NVIDIA H100 80GB HBM3"
PKGS = {"jax": (jprof, JConfig), "port": (prof, SVMConfig)}


def _save(tmp_path, knobs, device_kind="cpu", name="profile.json",
          mutate=None):
    entry = prof.make_entry(device_kind, knobs)
    if mutate:
        mutate(entry)
    path = str(tmp_path / name)
    if prof.validate_entry(entry):
        # invalid-by-design entries bypass save_entry's refusal
        with open(path, "w") as fh:
            json.dump({"schema": prof.PROFILE_SCHEMA,
                       "profiles": {entry["device_kind"]: entry}}, fh)
        return path
    return prof.save_entry(entry, path)


def _apply(pkg_name, path, explicit=(), **cfg):
    """apply_tuned of one package on the CPU (JAX reads its backend's
    kind, "cpu" here; the port is told its device kind)."""
    pkg, config = PKGS[pkg_name]
    kw = {} if pkg_name == "jax" else {"device_kind": "cpu"}
    c, applied = pkg.apply_tuned(config(**cfg), explicit=set(explicit),
                                 path=path, **kw)
    return applied, c.chunk_iters, c.cache_size


# -- resolution precedence: explicit > tuned > built-in default --------

@pytest.mark.parametrize("knobs, explicit, cfg, want", [
    ({"chunk_iters": 2048, "cache_lines": 64}, (), {},
     ({"chunk_iters": 2048, "cache_size": 64}, 2048, 64)),
    # explicit wins even at the default value
    ({"chunk_iters": 2048}, ("chunk_iters",), {}, ({}, 512, 0)),
    # a non-default config value wins
    ({"chunk_iters": 2048}, (), {"chunk_iters": 64}, ({}, 64, 0)),
    # a cache on a decomposition fails validate(): skipped, the rest
    # still applies
    ({"chunk_iters": 2048, "cache_lines": 64}, (), {"working_set": 8},
     ({"chunk_iters": 2048}, 2048, 0)),
], ids=["default", "explicit", "nondefault", "conflict"])
def test_apply_tuned_precedence_matches_jax(tmp_path, knobs, explicit, cfg,
                                            want):
    path = _save(tmp_path, knobs)
    got = {p: _apply(p, path, explicit, **cfg) for p in PKGS}
    assert got["port"] == got["jax"] == want


def test_port_has_no_backend_exemption(tmp_path):
    # the JAX package never resolves its numpy golden reference; the port
    # has no backend field, so its default config always resolves
    path = _save(tmp_path, {"chunk_iters": 2048})
    assert jprof.apply_tuned(JConfig(backend="numpy"), path=path)[1] == {}
    assert not hasattr(SVMConfig(), "backend")
    assert _apply("port", path)[0] == {"chunk_iters": 2048}


# -- invalidation: opt-out, device mismatch, provenance ---------------

def test_opt_out_env(tmp_path, monkeypatch):
    path = _save(tmp_path, {"chunk_iters": 2048})
    monkeypatch.setenv(prof.NO_TUNED_ENV, "1")
    assert prof.active_entry("cpu", path=path) is None
    assert _apply("port", path)[0] == {} == _apply("jax", path)[0]


@pytest.mark.parametrize("entry_kind, run_kind", [
    ("cpu", CARD), (CARD, "cpu"), ("TPU v5e", CARD)])
def test_device_mismatch_invalidates(tmp_path, entry_kind, run_kind):
    path = _save(tmp_path, {"chunk_iters": 2048}, device_kind=entry_kind)
    assert prof.active_entry(run_kind, path=path) is None
    _, applied = prof.apply_tuned(SVMConfig(), device_kind=run_kind,
                                  path=path)
    assert applied == {}
    # ...but asking FOR that device finds it (case-insensitively)
    assert prof.active_entry(entry_kind.upper(), path=path) is not None


def test_renamed_entry_is_a_provenance_lie(tmp_path):
    entry = prof.make_entry(CARD, {"chunk_iters": 9})
    path = str(tmp_path / "copied.json")
    with open(path, "w") as fh:
        json.dump({"schema": prof.PROFILE_SCHEMA,
                   "profiles": {"cpu": entry}}, fh)
    assert prof.active_entry("cpu", path=path) is None
    assert jprof.active_entry(path=path) is None


@pytest.mark.parametrize("mutate, problem", [
    (lambda e: e.update(git_sha=""), "git_sha"),
    (lambda e: e.update(schema=99), "schema"),
    (lambda e: e.update(time=""), "timestamp"),
    (lambda e: e["knobs"].update(chunk_iters="fast"), "non-numeric"),
])
def test_invalid_provenance_rejected_as_jax_does(tmp_path, mutate,
                                                 problem):
    path = _save(tmp_path, {"chunk_iters": 2048}, mutate=mutate)
    entry = prof.load_profiles(path)["cpu"]
    mine = prof.validate_entry(entry)
    assert mine == jprof.validate_entry(entry)
    assert any(problem in p for p in mine)
    assert prof.active_entry("cpu", path=path) is None


def test_save_entry_refuses_invalid_and_merges(tmp_path):
    path = str(tmp_path / "p.json")
    bad = prof.make_entry("cpu", {"chunk_iters": 1024})
    bad["git_sha"] = ""
    with pytest.raises(ValueError, match="invalid profile"):
        prof.save_entry(bad, path)
    prof.save_entry(prof.make_entry("cpu", {"chunk_iters": 1024}), path)
    prof.save_entry(prof.make_entry(CARD, {"chunk_iters": 4096}), path)
    profiles = prof.load_profiles(path)
    assert set(profiles) == {"cpu", CARD}
    assert profiles["cpu"]["knobs"]["chunk_iters"] == 1024
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_profile_files_load_in_the_other_package(tmp_path, writer):
    wpkg, _ = PKGS[writer]
    rpkg = prof if writer == "jax" else jprof
    path = str(tmp_path / "p.json")
    wpkg.save_entry(wpkg.make_entry("cpu", {"chunk_iters": 2048,
                                            "cache_lines": 64}), path)
    wpkg.save_entry(wpkg.make_entry(CARD, {"serve_max_batch": 128}), path)
    loaded = rpkg.load_profiles(path)
    assert set(loaded) == {"cpu", CARD}
    assert rpkg.validate_entry(loaded[CARD]) == []
    assert rpkg.active_entry("cpu", path=path)["knobs"] == {
        "chunk_iters": 2048, "cache_lines": 64}
    assert rpkg.tuned_value(rpkg.active_entry(CARD, path=path),
                            "serve_max_batch") == 128
    # and resolution through the reader gives what the writer would
    assert _apply("port", path) == _apply("jax", path)


def test_disabled_env_and_damaged_file_degrade(tmp_path, monkeypatch):
    monkeypatch.setenv(prof.PROFILE_ENV, "")
    assert prof.profile_path() is None
    assert prof.active_entry("cpu") is None
    assert prof.doctor_lines("cpu")[0].startswith("tuned profiles disabled")
    path = str(tmp_path / "torn.json")
    with open(path, "w") as fh:
        fh.write('{"schema": 1, "profiles": {')
    assert prof.load_profiles(path) == {}
    monkeypatch.delenv(prof.PROFILE_ENV)
    assert prof.profile_path() == prof.default_profile_path()
    assert prof.default_profile_path().endswith(
        os.path.join("dpsvm_tpu_torch", "_ledger", "tuned_profile.json"))


def test_device_kind_never_initializes_cuda():
    import torch
    assert prof.current_device_kind("cpu") == "cpu"
    assert prof.current_device_kind(torch.device("cpu")) == "cpu"
    if not torch.cuda.is_initialized():
        assert prof.current_device_kind() is None
        assert not torch.cuda.is_initialized()


# -- the comparison: a planted slower-than-default candidate loses ------

@pytest.mark.parametrize("default, rates, pct", [
    (512, {512: 100.0, 2048: 80.0, 128: 95.0}, 2.0),
    (512, {512: 100.0, 1024: 101.0}, 2.0),
    (512, {512: 100.0, 1024: 110.0}, 2.0),
    (0, {0: 50.0, 64: 51.5, 256: 49.0}, 2.0),
    (256, {128: 900.0, 256: 1000.0}, 0.0),
])
def test_select_winner_matches_jax(default, rates, pct):
    got = tuner.select_winner(default, rates, pct)
    assert got == jtuner.select_winner(default, rates, pct)
    assert rates[got[0]] >= rates[default]


def test_select_winner_requires_anchored_default():
    for t in (tuner, jtuner):
        with pytest.raises(ValueError, match="unanchored"):
            t.select_winner(512, {1024: 110.0}, 2.0)


def _fake_measure(rates, ledger, calls):
    def measure(v, budget, rung):
        calls.append((v, budget, rung))
        return ledger.make_record(
            "tune_probe_fake",
            {"knob": "fake", "candidate": int(v), "rung": int(rung),
             "budget_iters": int(budget)},
            kind="tune", value=rates[v], unit="iter/s")
    return measure


@pytest.mark.parametrize("values, default, rates, budgets", [
    ((64, 128, 1024, 2048), 512,
     {64: 50.0, 128: 60.0, 512: 100.0, 1024: 70.0, 2048: 90.0},
     (100, 200, 400)),
    ((128, 2048), 512, {512: 100.0, 128: 60.0, 2048: 90.0}, (100, 200)),
    ((128, 256, 1024, 2048, 4096), 512,
     {128: 10.0, 256: 120.0, 512: 20.0, 1024: 130.0, 2048: 30.0,
      4096: 140.0}, (10, 20, 40)),
])
def test_halving_survivors_and_probe_order_match_jax(values, default,
                                                     rates, budgets):
    got = {}
    for name, t, led in (("port", tuner, tledger),
                         ("jax", jtuner, jledger)):
        calls, logs = [], []
        final, probes = t.successive_halving(
            values, default, _fake_measure(rates, led, calls), budgets,
            time.monotonic() + 60.0, logs.append)
        got[name] = (final, calls, logs,
                     [(p["metrics"]["candidate"], p["metrics"]["rung"])
                      for p in probes],
                     t.select_winner(default, final, 2.0))
    assert got["port"] == got["jax"]
    final, calls = got["port"][0], got["port"][1]
    assert default in final and len(calls) == len(got["port"][3])


def test_halving_deadline_expires():
    for t, led in ((tuner, tledger), (jtuner, jledger)):
        with pytest.raises(t.DeadlineExpired):
            t.successive_halving(
                (128, 1024), 512,
                _fake_measure({128: 1.0, 512: 2.0, 1024: 3.0}, led, []),
                (100, 200), time.monotonic() - 1.0, lambda s: None)


# -- the compile correction ---------------------------------------------

def test_compile_correction_counts_captures_and_builds_only(tmp_path):
    recs = [("fused-chunk", 5.0), ("decomp-chunk/q=64", 3.0),
            ("smo-chunk", 0.25), ("build:fused_step", 1.5),
            ("serve-bucket/rows=8", 0.125), ("ovo-chunk", 0.5),
            ("primal-chunk", 0.0625), ("dist-smo-chunk", 0.03125)]
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as fh:
        fh.write(json.dumps({"kind": "manifest"}) + "\n")
        for program, s in recs:
            fh.write(json.dumps({"kind": "compile", "program": program,
                                 "seconds": s}) + "\n")
        fh.write(json.dumps({"kind": "chunk", "seconds": 7.0}) + "\n")
    assert tuner._trace_compile_seconds(path) == 2.46875
    assert tuner._trace_compile_seconds(None) == 0.0
    assert tuner._trace_compile_seconds(str(tmp_path / "no")) == 0.0


# -- real probes and the tiny tune run on the CPU ----------------------

def test_probe_train_row_shape(tmp_path):
    x, y = make_blobs(n=400, d=8, seed=0)
    cfg = SVMConfig(c=10.0, epsilon=1e-5, max_iter=100_000)
    row = tuner.probe_train(x, y, cfg, "chunk_iters", 256, 400, 0,
                            trace_dir=str(tmp_path), device="cpu")
    assert row["kind"] == "tune" and row["case"] == "tune_probe_chunk_iters"
    assert row["value"] > 0 and row["unit"] == "iter/s"
    m = row["metrics"]
    assert m["candidate"] == 256 and m["n_iter"] == 400
    assert os.path.exists(row["trace"])
    # the fused pair's first chunk is a compile record of real work: not
    # subtracted, so the rate is the host loop's
    from dpsvm_tpu_torch.observability.schema import read_trace
    progs = [r["program"] for r in read_trace(row["trace"])
             if r["kind"] == "compile"]
    assert progs == ["fused-chunk"] and m["compile_seconds"] == 0.0
    assert m["rate"] == pytest.approx(400 / m["seconds"], rel=1e-3)
    assert m["registry"]["dpsvm_train_iterations"] == 400


def test_probe_serve_rate():
    from dpsvm_tpu_torch.api import fit
    x, y = make_blobs(n=300, d=8, seed=0)
    model, _ = fit(x, y, SVMConfig(c=1.0, max_iter=20_000), device="cpu")
    rows = np.random.default_rng(0).standard_normal(
        (max(tuner.SERVE_SIZES), 8)).astype(np.float32)
    row = tuner.probe_serve(model, 128, 0, 1, rows, device="cpu")
    assert row["case"] == "tune_probe_serve_max_batch"
    assert row["value"] > 0 and row["unit"] == "rows/s"
    assert row["metrics"]["buckets"][-1] == 128
    assert row["metrics"]["rows"] == sum(tuner.SERVE_SIZES)
    assert row["metrics"]["warmup_compiles"] == 0     # eager on the CPU


def test_run_tune_tiny_end_to_end(tmp_path, monkeypatch):
    ledger_path = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv("DPSVM_PERF_LEDGER", ledger_path)
    x, y = make_blobs(n=600, d=8, seed=0, separation=0.5)
    out = str(tmp_path / "tuned_profile.json")
    logs = []
    entry, rc = tuner.run_tune(
        x, y, base_config=SVMConfig(c=10.0, epsilon=1e-5,
                                    max_iter=100_000),
        knobs=("chunk_iters", "cache_lines", "serve_max_batch"),
        grids={"chunk_iters": (128, 512), "cache_lines": (0, 64),
               "serve_max_batch": (128, 256)},
        probe_iters=300, rungs=2, deadline_s=120.0, min_win_pct=1.0,
        profile_out=out, trace_dir=str(tmp_path / "traces"),
        device="cpu", log=logs.append)
    assert rc == 0 and prof.validate_entry(entry) == []
    assert entry["device_kind"] == "cpu"
    saved = prof.load_profiles(out)["cpu"]
    assert saved["knobs"] == entry["knobs"]
    assert set(entry["knobs"]) <= {"chunk_iters", "cache_lines",
                                   "serve_max_batch"}
    cases = [p["case"] for p in saved["probes"]]
    for knob in ("chunk_iters", "cache_lines", "serve_max_batch"):
        assert f"tune_probe_{knob}" in cases
    assert all(p.get("trace") for p in saved["probes"]
               if p["case"] != "tune_probe_serve_max_batch")
    rows = tledger.read(ledger_path)
    assert {r["case"] for r in rows} >= {"tune_probe_chunk_iters",
                                         "tune_probe_cache_lines"}
    if {"chunk_iters", "cache_lines"} & set(entry["knobs"]):
        win = entry["win"]
        assert any(r["case"] == "tuned_vs_default" for r in rows)
        assert os.path.exists(win["trace_tuned"]) and "compare_ok" in win
    # the JAX package reads the port's entry
    assert jprof.load_profiles(out)["cpu"]["knobs"] == entry["knobs"]


def test_run_tune_deadline_expired_exits_1(tmp_path):
    x, y = make_blobs(n=300, d=8, seed=0)
    logs = []
    entry, rc = tuner.run_tune(
        x, y, knobs=("chunk_iters", "serve_max_batch"),
        grids={"chunk_iters": (128, 512)}, probe_iters=100, rungs=1,
        deadline_s=0.0, profile_out=str(tmp_path / "p.json"),
        device="cpu", log=logs.append)
    assert rc == 1 and entry == {}
    assert not os.path.exists(str(tmp_path / "p.json"))
    assert any("keeping the default" in ln for ln in logs)


def test_run_tune_default_device_without_cuda_raises(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = make_blobs(n=100, d=4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tuner.run_tune(x, y, profile_out=str(tmp_path / "p.json"),
                       log=lambda s: None)
    from dpsvm_tpu_torch.tuning import selfcheck
    assert any("CUDA is not available" in p for p in selfcheck())


def test_fused_fit_is_bitwise_across_chunk_iters():
    from dpsvm_tpu_torch import train
    x, y = make_blobs(n=300, d=8, seed=0, separation=0.5)
    fits = {}
    for ci in (128, 512, 2048):
        r = train(x, y, SVMConfig(c=10.0, epsilon=1e-5, max_iter=100_000,
                                  chunk_iters=ci), device="cpu")
        assert r.converged
        fits[ci] = (r.n_iter, r.b, r.alpha.tobytes())
    assert fits[128] == fits[512] == fits[2048]


# -- the surfaces: CLI train, serve and tune, doctor, provenance tag ----

def _write_csv(tmp_path, n=120, d=6):
    x, y = make_blobs(n=n, d=d, seed=0)
    src = str(tmp_path / "train.csv")
    np.savetxt(src, np.column_stack([y, x]), delimiter=",", fmt="%.6f")
    return src


def test_cli_train_consults_profile(tmp_path, monkeypatch, capsys):
    from dpsvm_tpu_torch.cli import main
    path = _save(tmp_path, {"chunk_iters": 2048, "cache_lines": 8})
    monkeypatch.setenv(prof.PROFILE_ENV, path)
    src = _write_csv(tmp_path)
    model = str(tmp_path / "m.svm")
    base = ["train", "-f", src, "-m", model, "-n", "4000", "--device",
            "cpu"]
    assert main(base) == 0
    assert ("tuned profile: cache_size=8, chunk_iters=2048 "
            "(--no-tuned for built-in defaults)") in capsys.readouterr().err
    # an explicit flag wins, even set to the built-in default
    assert main(base + ["--chunk-iters", "512"]) == 0
    assert "tuned profile: cache_size=8 (" in capsys.readouterr().err
    assert main(base + ["--chunk-iters", "512", "-s", "0"]) == 0
    assert "tuned profile:" not in capsys.readouterr().err
    # --no-tuned and DPSVM_NO_TUNED=1 opt out
    assert main(base + ["--no-tuned"]) == 0
    assert "tuned profile:" not in capsys.readouterr().err
    monkeypatch.setenv(prof.NO_TUNED_ENV, "1")
    assert main(base) == 0
    assert "tuned profile:" not in capsys.readouterr().err
    monkeypatch.delenv(prof.NO_TUNED_ENV)
    # the card's entry never applies to a CPU train
    monkeypatch.setenv(prof.PROFILE_ENV, _save(
        tmp_path, {"chunk_iters": 2048}, device_kind=CARD, name="c.json"))
    assert main(base) == 0
    assert "tuned profile:" not in capsys.readouterr().err


class _Stop(Exception):
    pass


def test_cli_serve_consults_profile(tmp_path, monkeypatch, capsys):
    from dpsvm_tpu_torch.api import fit
    from dpsvm_tpu_torch.cli import main
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.serving import server
    x, y = make_blobs(n=80, d=4, seed=0)
    model, _ = fit(x, y, SVMConfig(c=1.0), device="cpu")
    mpath = str(tmp_path / "m.svm")
    save_model(model, mpath)
    seen = []

    class FakeServer:
        def __init__(self, registry, host, port, **kw):
            seen.append((kw["max_batch"], kw["hedge"],
                         registry.engine("default").max_batch))
            raise ValueError("stopped before serving")

    monkeypatch.setattr(server, "ServingServer", FakeServer)
    monkeypatch.setenv(prof.PROFILE_ENV, _save(
        tmp_path, {"serve_max_batch": 64, "serve_hedge_ms": 25}))
    base = ["serve", "-m", mpath, "--port", "0", "--device", "cpu"]
    assert main(base) == 2
    err = capsys.readouterr().err
    assert ("tuned profile: max_batch=64 (--no-tuned for the built-in "
            "256)") in err and "hedge_ms" not in err
    assert main(base + ["--replicas", "2"]) == 2
    assert "tuned profile: hedge_ms=25.0" in capsys.readouterr().err
    assert main(base + ["--max-batch", "32", "--replicas", "2",
                        "--hedge-ms", "auto"]) == 2
    assert "tuned profile:" not in capsys.readouterr().err
    assert main(base + ["--no-tuned", "--replicas", "2"]) == 2
    assert "tuned profile:" not in capsys.readouterr().err
    assert seen == [(64, "off", 64), (64, 0.025, 64), (32, "auto", 32),
                    (256, "off", 256)]


def test_cli_tune(tmp_path, capsys):
    from dpsvm_tpu_torch.cli import main
    out = str(tmp_path / "p.json")
    assert main(["tune", "--device", "cpu", "--n", "300", "--d", "8",
                 "--knobs", "chunk_iters", "--grid", "chunk_iters=128",
                 "--probe-iters", "200", "--rungs", "1", "--out", out,
                 "--no-ledger", "--trace-dir", str(tmp_path / "t")]) == 0
    err = capsys.readouterr().err
    assert "tune: device 'cpu'" in err and "written to" in err
    entry = prof.load_profiles(out)["cpu"]
    assert [p["metrics"]["candidate"] for p in entry["probes"]
            if p["case"] == "tune_probe_chunk_iters"] == [128, 512]
    assert main(["tune", "--device", "cpu", "--knobs", "bogus"]) == 2
    assert main(["tune", "--device", "cpu", "--grid", "chunk_iters"]) == 2


def test_doctor_lines_report_states(tmp_path, monkeypatch):
    path = _save(tmp_path, {"chunk_iters": 2048})
    lines = prof.doctor_lines("cpu", path=path)
    assert any("active profile" in ln and "chunk_iters=2048" in ln
               for ln in lines)
    assert any("provenance: git" in ln for ln in lines)
    missing = prof.doctor_lines("cpu", path=str(tmp_path / "none.json"))
    assert any("no tuned profile" in ln for ln in missing)
    monkeypatch.setenv(prof.NO_TUNED_ENV, "1")
    assert any("OPT-OUT" in ln
               for ln in prof.doctor_lines("cpu", path=path))
    monkeypatch.delenv(prof.NO_TUNED_ENV)
    mism = _save(tmp_path, {"chunk_iters": 9}, device_kind=CARD,
                 name="mism.json")
    assert any("no valid entry" in ln
               for ln in prof.doctor_lines("cpu", path=mism))
    win = prof.make_entry("cpu", {"chunk_iters": 2048},
                          win={"speedup": 1.25, "compare_ok": True})
    wpath = prof.save_entry(win, str(tmp_path / "w.json"))
    assert prof.doctor_lines("cpu", path=wpath)[-1] == (
        "measured win: 1.25x vs defaults (tuned_vs_default; compare gate "
        "OK)")
    assert jprof.doctor_lines("cpu", path=wpath)[-1] == (
        prof.doctor_lines("cpu", path=wpath)[-1])


def test_doctor_cli_reports_tuned(tmp_path, monkeypatch, capsys):
    from dpsvm_tpu_torch.cli import main
    path = _save(tmp_path, {"chunk_iters": 2048})
    monkeypatch.setenv(prof.PROFILE_ENV, path)
    assert main(["doctor", "--device", "cpu", "--shards", "1",
                 "--timeout", "60"]) == 0
    out = capsys.readouterr().out
    assert "tuned: active profile for 'cpu': chunk_iters=2048" in out


def test_provenance_tag_for_bench_rows(tmp_path):
    path = _save(tmp_path, {"chunk_iters": 2048})
    tag = prof.provenance_tag("cpu", path=path)
    assert tag is not None and tag.startswith("cpu@")
    assert prof.provenance_tag("cpu", path=str(tmp_path / "no.json")) is None


def test_tune_selfcheck_gate():
    from dpsvm_tpu_torch.tuning import selfcheck
    assert selfcheck(device="cpu") == []
