"""The port's model fleet (``dpsvm_tpu_torch/fleet``) on the CPU, against
the JAX package's ``dpsvm_tpu/fleet`` and the port's own engines and fits.

Bars, and why:

* the packer: a member's packed column is bitwise a dedicated
  ``PredictionEngine`` for that model at the same block shape (each member
  runs its own decision block in the shared program); membership changes
  repack, and steady traffic captures nothing;
* the cache: the same touch sequence through the port's ``ModelCache`` and
  JAX's gives the same counters and resident set (the same
  ``TenantLabelBudget`` ledger, whose decisions are held to JAX's on a
  random sequence); conservation (touches == hits + faults + transients);
  a one-shot scan evicts nothing; paging out frees the model's device
  bytes; the fault and evict events and the ``dpsvm_fleet_model_*_total``
  counters agree;
* the grid against JAX's ``train_grid`` on the same rows: the same split,
  the same winner, per-cell held-out accuracy within one example and n_sv
  within 2% or 3 (the LibSVM bar between the packages' converged models);
  against sequential ``api.fit`` on the same split by the bar between
  paths (n_sv within 2% or 3, accuracy within 0.5%); ``promote_winner``
  and the CLI ``grid``;
* the fleet selfcheck, in process and as a module.
"""

import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import numpy as np
import pytest
import torch

from dpsvm_tpu.cli import main as jmain
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.fleet import grid as jgrid
from dpsvm_tpu.fleet import modelcache as jcache
from dpsvm_tpu.fleet import packer as jpacker
from dpsvm_tpu.observability import metrics as jmetrics
from dpsvm_tpu.serving import registry as jregistry
from dpsvm_tpu_torch import api
from dpsvm_tpu_torch.cli import main as tmain
from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.data.synthetic import make_blobs, save_csv
from dpsvm_tpu_torch.fleet import ModelCache, tiny_fleet
from dpsvm_tpu_torch.fleet import grid as tgrid
from dpsvm_tpu_torch.fleet import packer as tpacker
from dpsvm_tpu_torch.models.io import load_model
from dpsvm_tpu_torch.models.svm import evaluate
from dpsvm_tpu_torch.observability.metrics import (MetricsRegistry,
                                                   TenantLabelBudget)
from dpsvm_tpu_torch.serving import engine as teng
from dpsvm_tpu_torch.serving.registry import ModelRegistry

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _q(n=5, d=4, seed=3):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


# --- the packer --------------------------------------------------------------

def test_group_spec_and_packable_match_jax(tmp_path):
    paths = tiny_fleet(str(tmp_path), 4, specs=((0.5, 4), (0.25, 4)))
    for p in paths:
        m = load_model(p)
        assert tuple(tpacker.GroupSpec.of(m)) == tuple(
            jpacker.GroupSpec.of(m))
        assert tpacker.packable(m) and jpacker.packable(m)


def test_packed_columns_are_bitwise_a_dedicated_engine(tmp_path):
    paths = tiny_fleet(str(tmp_path), 6)
    models = [load_model(p) for p in paths]
    g = tpacker.PackedGroup(tpacker.GroupSpec.of(models[0]), max_batch=8,
                            device=CPU)
    for i, m in enumerate(models):
        g.add(f"m{i}", m)
    with pytest.raises(ValueError, match="already packed"):
        g.add("m0", models[0])
    for n in (1, 5, 8, 19):
        q = _q(n, seed=n)
        allc = g.decisions_all(q)
        assert allc.shape == (n, 6)
        for i, m in enumerate(models):
            want = teng.PredictionEngine(m, max_batch=8,
                                         device=CPU).decision_values(q)
            assert np.array_equal(allc[:, i].view(np.int32),
                                  want.view(np.int32)), (n, i)
    assert g.stats()["repacks"] == 1
    g.remove("m2")
    assert g.names() == ["m0", "m1", "m3", "m4", "m5"]
    assert g.decisions_for("m3", _q()).shape == (5,)
    assert g.stats()["repacks"] == 2
    os.makedirs(tmp_path / "o")
    other = tiny_fleet(str(tmp_path / "o"), 1, specs=((0.25, 4),))[0]
    with pytest.raises(ValueError, match="spec"):
        g.add("x", load_model(other))


def test_group_packer_routes_by_spec(tmp_path):
    paths = tiny_fleet(str(tmp_path), 6, specs=((0.5, 4), (0.25, 4)))
    gp = tpacker.GroupPacker(max_batch=8, device=CPU)
    for i, p in enumerate(paths):
        assert gp.add(f"m{i}", load_model(p)) is gp.group_for(f"m{i}")
    st = gp.stats()
    assert st["groups"] == 2 and st["packed_models"] == 6
    for i in (0, 2, 4):
        assert gp.remove(f"m{i}")
    assert gp.stats()["groups"] == 1 and not gp.remove("m0")


# --- the cache ---------------------------------------------------------------

def test_tenant_label_budget_decides_as_jax():
    rng = np.random.default_rng(5)
    seq = [f"t{int(v)}" for v in rng.zipf(1.3, 600) % 40]
    t_ev, j_ev = [], []
    tb = TenantLabelBudget(6, on_evict=t_ev.append)
    jb = jmetrics.TenantLabelBudget(6, on_evict=j_ev.append)
    assert [tb.resolve(s) for s in seq] == [jb.resolve(s) for s in seq]
    assert t_ev == j_ev and tb.residents() == jb.residents()
    assert tb.stats() == jb.stats()


def _touches(n_models, budget, seed=11):
    rng = np.random.default_rng(seed)
    hot = [f"m{i:04d}" for i in range(budget - 2)]
    seq = [hot[int(v)] for v in rng.integers(0, len(hot), 40)]
    seq += [f"m{i:04d}" for i in range(n_models)]           # a scan
    seq += [f"m{n_models - 1:04d}", hot[0]] * 2              # a newcomer
    return seq


def test_cache_matches_jax_counters_and_residents(tmp_path):
    n_models, budget = 24, 6
    paths = tiny_fleet(str(tmp_path), n_models, specs=((0.5, 4), (0.25, 4)))
    treg, jreg = ModelRegistry(), jregistry.ModelRegistry()
    for i, p in enumerate(paths):
        treg.register(f"m{i:04d}", p, lazy=True, device=CPU)
        jreg.register(f"m{i:04d}", p, lazy=True)
    events, metrics = [], MetricsRegistry()
    tc = ModelCache(treg, budget=budget, max_batch=8, device=CPU,
                    metrics=metrics,
                    on_event=lambda e, **kw: events.append((e, kw)))
    jc = jcache.ModelCache(jreg, budget=budget, max_batch=8)
    q = _q()
    for name in _touches(n_models, budget):
        to = tc.infer(name, q, want=("decision", "labels"))
        jo = jc.infer(name, q, want=("decision", "labels"))
        np.testing.assert_allclose(to["decision"], jo["decision"],
                                   rtol=0, atol=1e-5)
        assert np.array_equal(to["labels"], jo["labels"])
    ts, js = tc.stats(), jc.stats()
    for k in ("resident", "touches", "hits", "faults", "transients",
              "evictions", "ledger_overflow"):
        assert ts[k] == js[k], k
    assert tc.resident_names() == jc.resident_names()
    assert ts["touches"] == ts["hits"] + ts["faults"] + ts["transients"]
    assert ts["evictions"] >= 1 and ts["transients"] >= n_models - budget
    names = [e for e, _ in events]
    assert names.count("model_fault") == ts["faults"]
    assert names.count("model_evict") == ts["evictions"]
    for k in ("hits", "faults", "transients", "evictions"):
        assert metrics.get(f"dpsvm_fleet_model_{k}_total").value == ts[k]


def test_a_one_shot_scan_evicts_nothing(tmp_path):
    paths = tiny_fleet(str(tmp_path), 20)
    reg = ModelRegistry()
    for i, p in enumerate(paths):
        reg.register(f"m{i:04d}", p, lazy=True, device=CPU)
    cache = ModelCache(reg, budget=4, max_batch=8, device=CPU,
                       metrics=MetricsRegistry())
    for i in range(4):
        cache.infer(f"m{i:04d}", _q())
    before = cache.resident_names()
    teng.reset_counts()
    for i in range(4, 20):
        cache.infer(f"m{i:04d}", _q())
    st = cache.stats()
    assert cache.resident_names() == before
    assert st["evictions"] == 0 and st["transients"] == 16
    assert teng.COUNTS["captures"] == 0
    with pytest.raises(KeyError):
        cache.infer("nope", _q())


def test_paging_out_frees_the_models_device_bytes(tmp_path):
    paths = tiny_fleet(str(tmp_path), 3)
    mc_path = str(tmp_path / "mc")
    x, y = make_blobs(n=90, d=4, seed=2)
    from dpsvm_tpu_torch.models.multiclass import (save_multiclass,
                                                   train_multiclass)
    mc, _ = train_multiclass(x, np.where(x[:, 0] > 0.5, 2, np.where(
        y > 0, 1, 0)), SVMConfig(c=5.0, gamma=0.5, epsilon=1e-2),
        device=CPU)
    save_multiclass(mc, mc_path)
    reg = ModelRegistry()
    for i, p in enumerate(paths):
        reg.register(f"m{i}", p, lazy=True, device=CPU)
    reg.register("mc", mc_path, lazy=True, device=CPU)
    cache = ModelCache(reg, budget=4, max_batch=8, device=CPU,
                       metrics=MetricsRegistry())
    for name in ("m0", "m1", "m2", "mc"):
        cache.infer(name, _q())
    full = cache.resident_bytes()
    sv_bytes = sum(load_model(p).n_sv * (4 + 2) * 4 + 4 for p in paths)
    mc_bytes = sum(m.n_sv * (4 + 2) * 4 for m in mc.models) + 3 * 4
    assert full == sv_bytes + mc_bytes
    engine = cache._resident["mc"].engine
    assert cache.evict("mc") and engine.device_bytes() == 0
    assert cache.resident_bytes() == sv_bytes
    assert cache.evict("m1") and not cache.evict("m1")
    assert cache.resident_bytes() == 0       # the group repacks lazily
    cache.infer("m0", _q())
    assert cache.resident_bytes() == sv_bytes - (
        load_model(paths[1]).n_sv * 6 * 4 + 4)


# --- the grid ----------------------------------------------------------------

def _grid_data():
    x, y = make_blobs(n=240, d=4, seed=21, separation=1.0)
    return x.astype(np.float32), np.asarray(y, np.int32)


def test_holdout_split_and_partition_match_jax():
    for n, frac, seed in ((100, 0.2, 0), (37, 0.3, 5)):
        for a, b in zip(tgrid.holdout_split(n, frac, seed),
                        jgrid.holdout_split(n, frac, seed)):
            np.testing.assert_array_equal(a, b)
    for k in (1, 2, 3, 7):
        assert tgrid._partition(list(range(5)), k) == jgrid._partition(
            list(range(5)), k)
    for frac in (0.0, 1.0):
        with pytest.raises(ValueError, match="holdout_frac"):
            tgrid.holdout_split(10, frac, 0)


def _sv_close(a, b):
    return abs(a - b) <= max(3, 0.02 * max(a, b))


def test_grid_matches_jax_and_sequential_fits():
    x, y = _grid_data()
    cs, gs = (1.0, 10.0), (0.25, 1.0)
    cfg = dict(epsilon=1e-3)
    tg = tgrid.train_grid(x, y, cs=cs, gammas=gs, config=SVMConfig(**cfg),
                          device=CPU)
    jg = jgrid.train_grid(x, y, cs=cs, gammas=gs, config=JConfig(**cfg))
    assert (tg.n_train, tg.n_holdout, tg.devices) == (192, 48, 1)
    assert (jg.n_train, jg.n_holdout) == (192, 48)
    one = 1.0 / tg.n_holdout
    for t, j in zip(tg.cells, jg.cells):
        assert (t.c, t.gamma) == (j.c, np.float32(j.gamma))
        assert abs(t.holdout_acc - j.holdout_acc) <= one + 1e-12
        assert _sv_close(t.result.n_sv, j.result.n_sv)
    assert tg.winner == jg.winner
    # the winner is the row-major first maximum
    accs = [c.holdout_acc for c in tg.cells]
    assert tg.winner == accs.index(max(accs))
    seconds, seq = tgrid.sequential_grid_seconds(
        x, y, cs=cs, gammas=gs, config=SVMConfig(**cfg), device=CPU)
    assert seconds > 0 and len(seq) == 4
    tr, ho = tgrid.holdout_split(len(y), 0.2, 0)
    for (c, g, m), cell in zip(seq, tg.cells):
        assert (c, g) == (cell.c, gs[tg.cells.index(cell) % 2])
        assert _sv_close(m.n_sv, cell.model.n_sv)
        assert abs(evaluate(m, x[ho], y[ho], device=CPU)
                   - cell.holdout_acc) <= 0.005 + one
    # the grid's run trace: a grid_cell event a cell, then the winner
    # and the summary (the refusal this once pinned is gone)
    events = []

    class _Rec:
        def event(self, name, **kw):
            events.append((name, kw))

        def summary(self, **kw):
            events.append(("summary", kw))

    g1 = tgrid.train_grid(x, y, cs=cs[:1], gammas=gs[:1],
                          config=SVMConfig(**cfg), trace=_Rec(),
                          device=CPU)
    assert [e for e, _ in events] == ["grid_cell", "grid_winner",
                                      "summary"]
    assert events[0][1]["holdout_acc"] == round(g1.best.holdout_acc, 6)
    assert events[2][1]["grid_cells"] == 1


def test_grid_polish_and_promote(tmp_path):
    x, y = _grid_data()
    g = tgrid.train_grid(x, y, cs=(1.0, 10.0), gammas=(0.5,),
                         config=SVMConfig(epsilon=1e-3), polish=True,
                         device=CPU)
    assert g.polished and hasattr(g.best.result, "n_kept")
    ref, _ = api.fit(x, y, SVMConfig(c=g.best.c, gamma=g.best.gamma,
                                     epsilon=1e-3), device=CPU)
    assert _sv_close(g.best.model.n_sv, ref.n_sv)
    served = str(tmp_path / "served.svm")
    from dpsvm_tpu_torch.models.io import save_model
    save_model(g.cells[1 - g.winner].model, served)
    reg = ModelRegistry()
    reg.register("w", served, max_batch=8, device=CPU)
    assert tgrid.promote_winner(g, reg, "w") == 2
    assert load_model(served).n_sv == g.best.model.n_sv
    assert not [f for f in os.listdir(tmp_path) if "grid-cand" in f]
    reg.register("mem", model=g.best.model, device=CPU)
    with pytest.raises(ValueError, match="in-memory"):
        tgrid.promote_winner(g, reg, "mem")


def _cli(main, args):
    buf, err = StringIO(), StringIO()
    from contextlib import redirect_stderr
    with redirect_stdout(buf), redirect_stderr(err):
        rc = main(args)
    return rc, buf.getvalue(), err.getvalue()


def test_cli_grid_against_jax(tmp_path):
    x, y = _grid_data()
    csv = str(tmp_path / "d.csv")
    save_csv(csv, x, y)
    args = ["grid", "-f", csv, "--cs", "1,10", "--gammas", "0.25,1",
            "--json"]
    rc, out, _ = _cli(tmain, args + [
        "--compare-sequential", "--polish", "--out",
        str(tmp_path / "w.svm"), "--promote", str(tmp_path / "p.svm"),
        "--device", "cpu"])
    assert rc == 0
    row = json.loads(out.strip().splitlines()[-1])
    rc, jout, _ = _cli(jmain, args)
    assert rc == 0
    jrow = json.loads(jout.strip().splitlines()[-1])
    assert row["winner"]["c"] == jrow["winner"]["c"]
    assert row["winner"]["gamma"] == jrow["winner"]["gamma"]
    assert [(c["c"], c["gamma"]) for c in row["cells"]] == [
        (c["c"], c["gamma"]) for c in jrow["cells"]]
    assert row["polished"] and row["generation"] == 2
    assert row["seq_acc_gap_max"] <= 0.005 + 1.0 / row["n_holdout"]
    assert row["grid_vs_sequential_x"] > 0
    assert os.path.exists(row["out"]) and os.path.exists(row["promoted"])
    for bad in (["--cs", "a,b"], ["--cs", "0"], ["--gammas", "-1"],
                ["--holdout-frac", "1.5"]):
        msgs = []
        for main, extra in ((tmain, ["--device", "cpu"]), (jmain, [])):
            rc, _o, err = _cli(main, ["grid", "-f", csv] + bad + extra)
            msgs.append((rc, err.strip().splitlines()[-1]))
        assert msgs[0] == msgs[1] and msgs[0][0] == 2, msgs


# --- the gate ------------------------------------------------------------------

def test_fleet_selfcheck():
    from dpsvm_tpu_torch.fleet import selfcheck
    assert selfcheck(device="cpu") == []


def test_fleet_selfcheck_module_runs_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "dpsvm_tpu_torch.fleet", "--selfcheck",
         "--device", "cpu"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "fleet selfcheck OK" in r.stdout
