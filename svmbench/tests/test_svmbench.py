"""CPU tests of the benchmark's harness (``svmbench/``), on a copy of its
data files cut to a tiny size; one test, marked ``cuda``, runs real cells
on the card.

    python -m pytest svmbench/tests -q
"""

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from svmbench import core, data, reference

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "svmbench"

# The tiny cells' limits, set from CPU readings of the tiny cells
# (seeds 1, 2): kkt_gap 2.0e-3-2.4e-3 sound against 3.4e-2-9.1e-2 for the
# bfloat16 control; heldout_gap 2.6e-6-1.6e-4 against 1.4e-3-2.2e-2;
# decision_gap 5.3e-8-5.9e-8 against 3.6e-4-6.6e-4.
TINY_FIT_LIMITS = {"unconverged": 0, "box": 0, "compaction": 0,
                   "kkt_gap": 0.006, "heldout_gap": 0.0006}
TINY_SCORE_LIMITS = {"failed": 0, "decision_gap": 1e-5, "label_mismatch": 0}


def _tiny_root(dest: Path) -> Path:
    """BENCHMARK.json and svmbench/'s data files under ``dest``, every
    configuration and mix cut to a size the CPU runs in a second or two;
    the metric readers are the real ones."""
    (dest / "svmbench").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics", "kinds"):
        shutil.copytree(BENCH / sub, dest / "svmbench" / sub)
    cfgs = dest / "svmbench" / "configs"
    for path in cfgs.glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(n_train=300, n_heldout=100, d=16, max_iter=20000)
        if "score_model" in cfg:
            cfg["score_model"]["n_sv"] = 60
        path.write_text(json.dumps(cfg))
    mixes = dest / "svmbench" / "traffic"
    for path in mixes.glob("*.json"):
        mix = json.loads(path.read_text())
        if mix["kind"] == "score":
            mix.update(max_batch=64, slice_start_s=0.1, slice_s=0.2)
        path.write_text(json.dumps(mix))
    lims = dest / "svmbench" / "limits"
    lims.mkdir()
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        kind = json.loads((mixes / f"{cell['traffic']}.json").read_text())
        tiny = (TINY_SCORE_LIMITS if kind["kind"] == "score"
                else TINY_FIT_LIMITS)
        (lims / f"{cell['name']}.json").write_text(json.dumps(tiny))
    return dest


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return _tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, workload, seed=3, seconds=0.0, trace=False, **kw):
    return core.run_cell(root, workload, seed, seconds, trace,
                         device="cpu", **kw)


# -- the frozen copies ----------------------------------------------------


@pytest.mark.parametrize("n,d,gamma,seed", [(500, 784, 0.25, 0),
                                            (300, 123, 0.5, 7),
                                            (64, 8, 1.0, 2 ** 33 + 5)])
def test_generator_matches_the_programs(n, d, gamma, seed):
    from dpsvm_tpu_torch.data.synthetic import make_planted
    x0, y0 = make_planted(n, d, gamma, seed=seed)
    x1, y1 = data.make_planted(n, d, gamma, seed=seed)
    assert x1.shape == (n, d) and x1.dtype == np.float32
    assert y1.dtype == np.int32 and set(np.unique(y1)) <= {-1, 1}
    np.testing.assert_array_equal(x0, x1)
    np.testing.assert_array_equal(y0, y1)


def test_the_turned_problems_are_the_same_job():
    cfg = json.loads((BENCH / "configs" / "adult.json").read_text())
    cfg.update(n_train=200, n_heldout=50)
    probs = data.problems(cfg, 3)
    x0, y0 = data.make_planted(250, cfg["d"], cfg["gamma"], seed=0)
    np.testing.assert_array_equal(probs[0][0], x0[:200])

    def d2(x):
        return ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2
                ).sum(-1)
    for x, y, xh, yh in probs[1:]:
        np.testing.assert_array_equal(y, y0[:200])
        np.testing.assert_array_equal(yh, y0[200:])
        assert np.abs(x - probs[0][0]).max() > 0.1
        np.testing.assert_allclose(d2(x), d2(probs[0][0]), atol=1e-4)


def test_kernel_a_counts_match_the_programs():
    from dpsvm_tpu_torch.experimental.fused import iteration_work
    from svmbench import roofline
    for dtype, el in ((torch.float32, 4), (torch.bfloat16, 2)):
        xd = torch.zeros((60, 7), dtype=dtype)
        assert roofline.kernel_a_work(60, 7, el) == iteration_work(xd)


# -- the plain reference --------------------------------------------------


def test_reference_accepts_a_cpu_fit_and_rejects_a_perturbed_one():
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig
    x, y = data.make_planted(300, 16, 0.5, seed=4)
    cfg = SVMConfig(c=10.0, gamma=0.5, epsilon=1e-3)
    model, res = api.fit(x, y, cfg, device="cpu")
    coef = model.alpha.astype(np.float64) * model.y_sv
    ok = reference.kkt(x, y, res.alpha, model.x_sv, coef, 10.0, 0.5, "cpu")
    assert 0 < ok["gap"] <= 2.5e-3
    assert abs(ok["b"] - res.b) < 1e-3
    alpha = res.alpha.copy()
    i = int(np.flatnonzero((alpha > 0) & (alpha < 10.0))[0])
    alpha[i] *= 0.5
    keep = alpha > 0
    bad = reference.kkt(x, y, alpha, x[keep],
                        alpha[keep].astype(np.float64) * y[keep], 10.0, 0.5,
                        "cpu")
    assert bad["gap"] > 10 * ok["gap"]


def test_reference_sums_match_a_direct_sum():
    rng = np.random.default_rng(0)
    x, sv = rng.normal(size=(7, 5)), rng.normal(size=(4, 5))
    coef = rng.normal(size=4)
    kv, scale = reference.rbf_sums(x, sv, coef, 0.3, "cpu", block=3)
    k = np.exp(-0.3 * ((x[:, None, :] - sv[None, :, :]) ** 2).sum(-1))
    np.testing.assert_allclose(kv, k @ coef, rtol=1e-12)
    np.testing.assert_allclose(scale, k @ np.abs(coef), rtol=1e-12)


# -- the result line ------------------------------------------------------


@pytest.mark.parametrize("workload,trace", [("adult.fit", False),
                                            ("mnist-evenodd.score", False),
                                            ("mnist-evenodd.score", True)])
def test_result_line_keys(tiny, workload, trace):
    result, lines, _ = _run(tiny, workload, seconds=1.5 if trace else 0.5,
                            trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[:5] == keys
    assert list(result)[-1] == "checks"          # the compared numbers last
    assert ("breakdown" in result) == trace
    assert set(result) == set(keys) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert result["correct"] is True
    bench = core.load_bench(tiny)
    want = (core.per_layer_of(bench, workload) if trace
            else core.end_to_end_of(bench, workload))
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in want}
    assert set(result["metrics"]) <= {m["name"] for m in want}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
        assert any(line.startswith(f"check {name}:") for line in lines)
    json.dumps(result, allow_nan=False)


def test_every_cell_runs_and_passes_its_check(tiny):
    bench = core.load_bench(tiny)
    for cell in bench["workloads"]:
        result, _, _ = _run(tiny, cell["name"], seconds=0.3)
        assert result["correct"] is True, (cell["name"], result["checks"])
        assert result["attempted"] > 0 and result["failed"] == 0


# -- data, not code -------------------------------------------------------


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = _tiny_root(tmp_path)
    sb = root / "svmbench"
    cfg = json.loads((sb / "configs" / "adult.json").read_text())
    cfg.update(name="blobs", d=9, gamma=0.7)
    (sb / "configs" / "blobs.json").write_text(json.dumps(cfg))
    mix = json.loads((sb / "traffic" / "fit.json").read_text())
    mix.update(problems=1, warmup_iters=16)
    (sb / "traffic" / "fit-one.json").write_text(json.dumps(mix))
    (sb / "metrics" / "fits_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.cell.fits))\n")
    (sb / "limits" / "blobs.fit-one.json").write_text(
        json.dumps(TINY_FIT_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "blobs", "source": "x",
                             "file": "svmbench/configs/blobs.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "blobs.fit-one",
                               "config": "blobs",
                               "traffic": "fit-one", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("blobs.fit-one")
    bench["per_layer"].append({"name": "fits_in_window", "unit": "fits",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "entry", "moves": "fit_s",
                               "workloads": ["blobs.fit-one"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    plain, _, obj = _run(root, "blobs.fit-one", seconds=0.2)
    assert plain["correct"] and set(plain["metrics"]) == {"setup_s",
                                                          "fit_s"}
    assert obj.x.shape[1] == 9 and {f.problem for f in obj.fits} == {0}
    traced, _, obj = _run(root, "blobs.fit-one", seconds=0.2,
                          trace=True)
    assert traced["metrics"]["fits_in_window"]["value"] == len(obj.fits)


#: a traffic kind that no file of the harness knows: the held-out file
#: scored by the program's plain ``decision_function`` (``test`` without
#: ``--batch``), job after job
PLAIN_KIND = '''
import time
import numpy as np
from svmbench import data, reference
from svmbench.kinds.score import score_model


class Cell:
    kind = "plain"
    slice_name = "svmbench.slice"

    def __init__(self, config, traffic, seed, device, precision=None):
        from dpsvm_tpu_torch.models.svm import SVMModel, decision_function
        self.f, self.config, self.device = decision_function, config, device
        x, y, self.pool, _ = data.problems(config, 1)[0]
        self.sv, self.alpha, self.y_sv, self.b = score_model(config, x, y,
                                                             seed)
        self.model = SVMModel(x_sv=self.sv, alpha=self.alpha,
                              y_sv=self.y_sv, b=self.b,
                              gamma=float(config["gamma"]))
        self.out = []

    def window(self, seconds, capture=None):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not self.out:
            self.out.append(self.f(self.model, self.pool,
                                   device=self.device))
        wall = time.perf_counter() - t0
        return {"plain_rows_per_s": len(self.out) * len(self.pool) / wall}

    attempted = property(lambda self: len(self.out))
    failed = property(lambda self: 0)

    def release(self):
        pass

    def judge(self, device, limits):
        coef = self.alpha.astype(np.float64) * self.y_sv
        kv, scale = reference.rbf_sums(self.pool, self.sv, coef,
                                       float(self.config["gamma"]), device)
        gap = max(float(np.max(np.abs(d - (kv - self.b))
                               / (scale + abs(self.b)))) for d in self.out)
        return {"decision_gap": gap}
'''


def test_a_new_kind_is_found_by_name(tmp_path):
    root = _tiny_root(tmp_path)
    sb = root / "svmbench"
    (sb / "kinds" / "plain.py").write_text(PLAIN_KIND)
    (sb / "traffic" / "plain.json").write_text(json.dumps({"kind": "plain"}))
    (sb / "limits" / "mnist-evenodd.plain.json").write_text(
        json.dumps({"decision_gap": 1e-5}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mnist-evenodd.plain",
                               "config": "mnist-evenodd", "traffic": "plain",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "plain_rows_per_s",
                                "unit": "rows/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["mnist-evenodd.plain"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, lines, obj = _run(root, "mnist-evenodd.plain", seconds=0.2)
    assert obj.kind == "plain" and result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "plain_rows_per_s"}
    assert lines[0].startswith("check decision_gap:")


# -- what the process may load ---------------------------------------------


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dpsvm_tpu_torch_extra", object())
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dpsvm_tpu.solver", object())
    assert core.forbidden_modules() == ["dpsvm_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny):
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import torch; torch.set_num_threads(2);"
            "from pathlib import Path; from svmbench import core;"
            "core.run_cell(Path(sys.argv[2]), 'mnist-evenodd.score', 5, 0.3,"
            " False, device='cpu');"
            "core.run_cell(Path(sys.argv[2]), 'adult.fit', 5, 0.0, False,"
            " device='cpu');"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(tiny)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "dpsvm_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "dpsvm_tpu"}


def test_reference_imports_nothing_of_the_program():
    src = (BENCH / "reference.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+(dpsvm|jax|svmbench)", src,
                         re.M)


def test_run_exits_nonzero_without_a_card_or_without_the_program(tmp_path):
    args = ["--workload", "adult.fit", "--seed", "1", "--seconds", "1"]
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "svmbench/run.py", *args],
                             capture_output=True, text=True, timeout=120,
                             cwd=ROOT)
        assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "svmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "svmbench/run.py", *args],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


# -- correct: the control and the faults -----------------------------------


@pytest.mark.parametrize("workload", ["mnist-evenodd.fit", "adult.fit",
                                      "mnist-evenodd.score"])
def test_the_control_fails_the_check(tiny, workload):
    """The program's bfloat16 route in place of the float32 one the
    configuration states."""
    secs = 0.3 if "score" in workload else 0.0
    sound, _, _ = _run(tiny, workload, seed=11, seconds=secs)
    control, _, _ = _run(tiny, workload, seed=11, seconds=secs,
                         precision="default")
    assert sound["correct"] is True
    assert control["correct"] is False


def _fault_train(kind):
    from dpsvm_tpu_torch import api
    real = api.train

    def train(x, y, config=None, device=None, **kw):
        if kind == "half":          # half the rows left out
            h = x.shape[0] // 2
            r = real(x[:h], y[:h], config, device=device, **kw)
            alpha = np.concatenate([r.alpha, np.zeros(x.shape[0] - h,
                                                      np.float32)])
            return dataclasses.replace(r, alpha=alpha)
        r = real(x, y, config, device=device, **kw)
        if kind == "unchanged":     # the state returned as it came in
            return dataclasses.replace(r, alpha=np.zeros_like(r.alpha),
                                       b=0.0, n_sv=0)
        alpha = r.alpha.copy()      # one answer altered where produced
        i = int(np.flatnonzero((alpha > 0) & (alpha < config.c))[0])
        alpha[i] *= 0.5
        return dataclasses.replace(r, alpha=alpha)
    return train


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["mnist-evenodd.fit", "adult.fit"])
def test_a_broken_fit_fails_the_check(tiny, monkeypatch, workload, fault):
    from dpsvm_tpu_torch import api
    ok, _, _ = _run(tiny, workload, seed=12)
    assert ok["correct"] is True
    monkeypatch.setattr(api, "train", _fault_train(fault))
    bad, _, _ = _run(tiny, workload, seed=12)
    assert bad["correct"] is False


@pytest.mark.parametrize("fault", ["altered", "dropped"])
def test_a_broken_engine_fails_the_check(tiny, monkeypatch, fault):
    from dpsvm_tpu_torch.serving.engine import PredictionEngine
    real = PredictionEngine.decision_values
    calls = []

    def decision_values(self, x):
        out = real(self, x)
        calls.append(1)
        if len(calls) < 3:          # set-up, and the window's first job
            return out
        if fault == "altered":      # one decision altered where produced
            out = out.copy()
            out[-1] += 0.05
        else:                       # half the rows left out
            out = out[: len(out) // 2]
        return out
    monkeypatch.setattr(PredictionEngine, "decision_values",
                        decision_values)
    bad, _, _ = _run(tiny, "mnist-evenodd.score", seed=13, seconds=0.3)
    assert len(calls) >= 3 and bad["correct"] is False


# -- the manifest --------------------------------------------------------


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_manifest_keeps_to_its_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["svmbench"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = {c["name"] for c in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("svmbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        mix = json.loads((BENCH / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (BENCH / "kinds" / f"{mix['kind']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    assert [m["name"] for m in bench["end_to_end"]][0] == "setup_s"
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in cells:
        e2e = core.end_to_end_of(bench, w)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert core.per_layer_of(bench, w)


# -- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload,seconds", [("adult.fit", 2),
                                              ("mnist-evenodd.score", 3)])
def test_a_cell_runs_on_the_card(card, workload, seconds):
    out = subprocess.run(
        [sys.executable, "svmbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 17), "--seconds", str(seconds),
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
