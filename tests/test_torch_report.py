"""The port's trace consumers held to the JAX package's: each package's
validator, report and comparator on the other's trace; the live follow;
the profiler's sidecar and its reconciliation with the trace's phases; the
lifecycle's compare gate against JAX's; the CLI's ``info``, ``report``,
``compare``, ``perf``, ``profile``, ``watch`` and ``bundle`` with the JAX
CLI's flags; and the observability selfcheck. Everything reads files:
both traces come from one small fused-pair fit a package (the JAX one
through the Pallas kernel in interpret mode).
"""

import json
import os
import shutil

import numpy as np
import pytest

from dpsvm_tpu.data.synthetic import make_blobs
from torch_threads import one_thread  # noqa: F401

KW = dict(c=1.0, gamma=0.5, epsilon=1e-3, chunk_iters=16, max_iter=20000)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """(jax trace, port trace, port profile dir, port bundle dir, port
    metrics file) of the same fit."""
    from dpsvm_tpu import api as japi
    from dpsvm_tpu.config import SVMConfig as JConfig
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig

    td = tmp_path_factory.mktemp("traces")
    x, y = make_blobs(n=96, d=6, seed=3)
    jt = str(td / "jax.jsonl")
    japi.train(x, y, JConfig(use_pallas="on", trace_out=jt, **KW))
    tt = str(td / "port.jsonl")
    api.train(x, y, SVMConfig(trace_out=tt, profile_dir=str(td / "prof"),
                              metrics_out=str(td / "m.prom"), **KW),
              device="cpu")
    return {"jax": jt, "port": tt, "prof": str(td / "prof"),
            "metrics": str(td / "m.prom"), "dir": td}


# ---------------------------------------------------------------------
# validators, reports, comparators across packages
# ---------------------------------------------------------------------

@pytest.mark.parametrize("reader", ["jax", "port"])
def test_each_package_reads_both_traces(traces, reader):
    if reader == "jax":
        from dpsvm_tpu.observability import compare as cmp
        from dpsvm_tpu.observability import report as rep
    else:
        from dpsvm_tpu_torch.observability import compare as cmp
        from dpsvm_tpu_torch.observability import report as rep
    recs = {k: rep.load_trace(traces[k]) for k in ("jax", "port")}
    facts = {k: rep.trace_facts(v) for k, v in recs.items()}
    for k, r in recs.items():
        text = rep.render_report(r)
        assert f"converged at iter {facts[k]['n_iter']:,}" in text
        assert "host-loop phase time" in text
    assert facts["jax"]["n_iter"] == facts["port"]["n_iter"]
    assert facts["jax"]["n_sv"] == facts["port"]["n_sv"]
    c = cmp.compare_traces(recs["jax"], recs["port"])
    assert {m["metric"] for m in c["metrics"]} >= {"iters_per_sec",
                                                  "n_iter", "n_sv"}
    by = {m["metric"]: m for m in c["metrics"]}
    assert by["n_iter"]["a"] == by["n_iter"]["b"]
    assert cmp.regressions(cmp.compare_traces(recs["port"], recs["port"]),
                           0.001) == []
    cmp.render_compare(c)


def test_both_packages_digest_a_trace_alike(traces):
    """report --json's digest and compare's verdicts: the same numbers
    from either package (the port's roofline block adds the peak it used
    and the power limit)."""
    from dpsvm_tpu.observability import compare as jcmp
    from dpsvm_tpu.observability import report as jrep
    from dpsvm_tpu_torch.observability import compare as tcmp
    from dpsvm_tpu_torch.observability import report as trep
    for k in ("jax", "port"):
        recs = trep.load_trace(traces[k])
        jf, tf = jrep.trace_facts(recs), trep.trace_facts(recs)
        jf.pop("roofline"), tf.pop("roofline")
        assert jf == tf
    ja, jb = (jrep.load_trace(traces[k]) for k in ("jax", "port"))
    assert tcmp.regressions(tcmp.compare_traces(ja, jb), 5.0) == \
        jcmp.regressions(jcmp.compare_traces(ja, jb), 5.0)


def test_follow_ends_on_the_summary(traces, capsys):
    from dpsvm_tpu_torch.observability.report import follow_trace
    assert follow_trace(traces["port"], interval=0.01, stall_timeout=5.0,
                        width=40) == 0
    assert "converged at iter" in capsys.readouterr().out


def test_a_host_family_directory_is_refused(tmp_path):
    # one file of a family is refused; the family merges, and files that
    # are no run traces refuse to merge
    from dpsvm_tpu_torch.observability.report import (discover_family,
                                                      load_trace_auto,
                                                      resolve_trace_path)
    for name in ("trace_h0.jsonl", "trace_h1_a1.jsonl", "trace_h1.jsonl"):
        (tmp_path / name).write_text("")
    assert discover_family(str(tmp_path)) == {
        0: str(tmp_path / "trace_h0.jsonl"),
        1: str(tmp_path / "trace_h1_a1.jsonl")}
    with pytest.raises(ValueError, match="2-host trace family"):
        resolve_trace_path(str(tmp_path))
    with pytest.raises(ValueError, match="does not start with a manifest"):
        load_trace_auto(str(tmp_path))


# ---------------------------------------------------------------------
# the profiler's sidecar
# ---------------------------------------------------------------------

def test_profile_summary_reconciles_with_the_trace(traces):
    from dpsvm_tpu.observability import profiler as jprof
    from dpsvm_tpu_torch.observability import profiler as tprof
    res = tprof.summarize_profile(traces["prof"], trace_path=traces["port"])
    assert res["phases_match"] is True
    assert res["window"]["started_at_poll"] == 0
    assert res["activities"] == ["cpu"] and "kernels_ms" in res["device"]
    assert res["artifacts"] and all(
        a["path"].endswith(".pt.trace.json") for a in res["artifacts"])
    assert set(res["annotations"]) >= {"dispatch", "poll"}
    # the JAX package's renderer reads the port's sidecar: same layout
    text = jprof.render_summary(jprof.load_summary(traces["prof"]),
                                res["trace_phase_counts"])
    assert "every trace phase has a matching annotation" in text
    assert "device time in the window" in tprof.render_summary(
        res, res["trace_phase_counts"])


# ---------------------------------------------------------------------
# the lifecycle's compare gate
# ---------------------------------------------------------------------

class _Registry:
    def __init__(self, path):
        self._p = path

    def source(self, name):
        return self._p


@pytest.mark.parametrize("pct", [5.0, 1e6])
def test_lifecycle_gate_agrees_with_jax(traces, tmp_path, pct):
    """A slower candidate trace against the baseline: both packages'
    gates hold (or pass) it with the same problems."""
    from dpsvm_tpu.serving import lifecycle as jl
    from dpsvm_tpu_torch.serving import lifecycle as tl
    slow = tmp_path / "slow.jsonl"
    recs = [json.loads(ln) for ln in open(traces["port"])]
    recs[-1]["train_seconds"] *= 3.0
    recs[-1]["iters_per_sec"] /= 3.0
    slow.write_text("".join(json.dumps(r) + "\n" for r in recs))
    model = tmp_path / "m.svm"
    model.write_text("x")
    out = []
    for mod in (jl, tl):
        loop = mod.LifecycleLoop(
            registry=_Registry(str(model)), name="default",
            detector=mod.DriftDetector(np.arange(10.0)),
            score_source=lambda: [], retrain_fn=lambda r, a: None,
            eval_fn=lambda p: 1.0, accuracy_floor=0.5,
            baseline_trace=traces["port"], fail_on_regress_pct=pct)
        g = loop.gate(mod.RetrainResult(model_path=str(model),
                                        trace_path=str(slow)))
        out.append((g.passed, g.problems))
    assert out[0] == out[1]
    assert out[1][0] is (pct > 100)


# ---------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------

SUBCOMMANDS = ["info", "report", "compare", "perf", "profile", "watch",
               "bundle"]


def _options(parser, name):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    p = sub.choices[name]
    return {s for a in p._actions for s in a.option_strings} | {
        a.dest for a in p._actions if not a.option_strings}


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_cli_subcommands_take_the_jax_flags(name):
    from dpsvm_tpu import cli as jcli
    from dpsvm_tpu_torch import cli as tcli
    assert _options(tcli.build_parser(), name) == _options(
        jcli.build_parser(), name)


def test_cli_train_and_grid_take_the_jax_observability_flags():
    from dpsvm_tpu import cli as jcli
    from dpsvm_tpu_torch import cli as tcli
    obs = {"--trace-out", "--metrics-out", "--metrics-port",
           "--profile-dir", "--watch-rules", "--bundle-dir"}
    assert obs <= _options(tcli.build_parser(), "train")
    assert obs <= _options(jcli.build_parser(), "train")
    grid = {"--trace-out", "--no-ledger"}
    assert grid <= _options(tcli.build_parser(), "grid") & _options(
        jcli.build_parser(), "grid")


def test_cli_report_compare_profile_watch(traces, capsys):
    from dpsvm_tpu_torch.cli import main
    assert main(["report", traces["jax"]]) == 0
    assert "converged at iter" in capsys.readouterr().out
    assert main(["report", traces["port"], "--json"]) == 0
    digest = json.loads(capsys.readouterr().out)
    assert digest["summary"]["n_iter"] > 0
    assert main(["report", str(traces["dir"] / "missing.jsonl")]) == 2
    capsys.readouterr()
    assert main(["compare", traces["jax"], traces["port"],
                 "--fail-on-regress", "1e9"]) == 0
    assert "no regression past" in capsys.readouterr().out
    assert main(["profile", "summarize", traces["prof"], "--trace",
                 traces["port"]]) == 0
    assert "trace_calls" in capsys.readouterr().out
    assert main(["watch", "--trace", traces["port"], "--once",
                 "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["exit_code"] == 0
    assert main(["watch", "--metrics-file", traces["metrics"], "--once",
                 "--json"]) == 0
    capsys.readouterr()


def test_cli_compare_gates_a_planted_regression(traces, tmp_path, capsys,
                                                 monkeypatch):
    from dpsvm_tpu_torch.cli import main
    from dpsvm_tpu_torch.observability import ledger
    led = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv("DPSVM_PERF_LEDGER", led)
    slow = tmp_path / "slow.jsonl"
    recs = [json.loads(ln) for ln in open(traces["port"])]
    recs[-1]["iters_per_sec"] /= 2.0
    slow.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert main(["compare", traces["port"], str(slow),
                 "--fail-on-regress", "10"]) == 1
    assert "REGRESSION past 10% threshold" in capsys.readouterr().out
    assert [r["kind"] for r in ledger.read(led)] == ["compare"]
    assert main(["perf"]) == 0
    assert "perf ledger:" in capsys.readouterr().out
    assert main(["perf", "gate", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["regressions"] == []
    monkeypatch.setenv("DPSVM_PERF_LEDGER", str(tmp_path / "none.jsonl"))
    assert main(["perf"]) == 2


def test_cli_bundle_valid_and_tampered(traces, tmp_path, capsys):
    from dpsvm_tpu_torch.cli import main
    from dpsvm_tpu_torch.observability import blackbox
    from dpsvm_tpu_torch.observability.metrics import MetricsRegistry
    fr = blackbox.FlightRecorder(blackbox.make_manifest(solver="smo"))
    for rec in [json.loads(ln) for ln in open(traces["port"])][1:]:
        if rec["kind"] == "chunk":
            fr.chunk(**{k: v for k, v in rec.items()
                        if k in ("n_iter", "b_lo", "b_hi", "n_sv")})
    path = blackbox.dump_bundle(str(tmp_path), recorder=fr, rule="r",
                                severity="warn", window="1s", reason="x",
                                registry=MetricsRegistry())
    assert main(["bundle", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "embedded trace:" in out and "bundle OK" in out
    os.remove(os.path.join(path, "metrics.prom"))     # tampered
    assert main(["bundle", path, "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["valid"] is False
    shutil.rmtree(path)
    assert main(["bundle", str(tmp_path / "none")]) == 2


def test_cli_info_names_the_device(capsys):
    from dpsvm_tpu_torch.cli import main
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "torch " in out and "backend:" in out and "kernel builds:" in out


def test_observability_selfcheck_on_the_cpu():
    from dpsvm_tpu_torch.observability import selfcheck
    assert selfcheck(device="cpu") == []
