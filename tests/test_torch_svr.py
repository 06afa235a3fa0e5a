"""The port's epsilon-SVR (``models/svr.py``) on the CPU, against the JAX
package, its NumPy oracle and sklearn's SVR (libsvm), on every path it
routes to: the general pair, the decomposition (kernel B's plain version
here) and shrinking.

Bars, and why:

* the general pair's whole run on the stacked 2n problem against
  ``smo_reference(..., f_init, guard_eta=True)`` with the pairwise clip:
  on the linear kernel the same (i_hi, i_lo) sequence, n_iter and alphas
  (its kernel values are the dots themselves, so the two round alike);
  on RBF the LibSVM bar (n_sv within 2% or 3, predictions within 5e-3),
  since PyTorch's and NumPy's exp differ in last bits (ROADMAP Queue 3);
* converged models: predictions within 5e-3 of the JAX ``train_svr``'s,
  and the sklearn bars of ``tests/test_svr.py``;
* the decomposition (working_set 16 to 64) against the port's own general
  pair and the JAX decomposition by the LibSVM bar: its trajectories part
  across frameworks on the CPU (ROADMAP Queue 3), so n_iter is not held;
* the twin-pair hazard of ``tests/test_svr.py``: eta = 0, the TAU clamp,
  both alphas on the box, on the general pair and the decomposition;
* model files: the JAX package's ``task svr`` layout byte for byte both
  ways; the CLI's report lines equal the JAX CLI's.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs
from dpsvm_tpu.models import cv as jcv
from dpsvm_tpu.models import io as jio
from dpsvm_tpu.models import svr as jsvr
from dpsvm_tpu.solver.oracle import smo_reference
from dpsvm_tpu_torch import SVMConfig, fit, train
from dpsvm_tpu_torch.convert import model_from_numpy
from dpsvm_tpu_torch.models import cv as tcv
from dpsvm_tpu_torch.models import io as tio
from dpsvm_tpu_torch.models import svr as tsvr
from dpsvm_tpu_torch.solver import smo as tsmo
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def reg_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 5)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1]).astype(np.float32)
    return x, y


def _pred(model, x):
    return tsvr.predict_svr(model, x, device="cpu")


def _near(a, b, tol=5e-3):
    assert np.abs(np.asarray(a) - np.asarray(b)).max() <= tol


def _stacked(x, y, p):
    n = len(y)
    z = np.concatenate([np.ones(n), -np.ones(n)]).astype(np.int32)
    f0 = np.concatenate([p - y, -p - y]).astype(np.float32)
    return np.vstack([x, x]), z, f0


def test_svr_linear_run_follows_the_oracle(reg_data):
    x, _ = reg_data
    y = (0.5 * x[:, 1] - x[:, 2]).astype(np.float32)
    x2, z, f0 = _stacked(x, y, np.float32(0.05))
    kw = dict(c=10.0, kernel="linear", clip="pairwise", max_iter=40_000)
    trace = []
    ref = smo_reference(x2, z, JConfig(**kw), trace=trace, f_init=f0,
                        guard_eta=True)
    prob = tsmo.SMOProblem.build(x2, z, SVMConfig(**kw), CPU)
    opts = tsmo.SMOOptions.from_config(SVMConfig(**kw), guard_eta=True)
    carry, got = tsmo.init_carry(prob.y, f0), []
    while bool(tsmo.live(carry, tsmo.two_eps_f32(1e-3), 40_000)):
        u = tsmo.pair_update(carry, prob, opts)
        got.append((int(u.i_hi), int(u.i_lo)))
        carry = tsmo.smo_step(carry, prob, opts)
    assert got == [(a, b) for a, b, _, _ in trace]
    res = train(x2, z, SVMConfig(**kw), device="cpu", f_init=f0,
                guard_eta=True)
    assert res.n_iter == ref.n_iter and res.converged
    np.testing.assert_array_equal(res.alpha, ref.alpha)


def test_svr_rbf_run_meets_the_bar_against_the_oracle(reg_data):
    x, y = reg_data
    x2, z, f0 = _stacked(x, y, np.float32(0.05))
    kw = dict(c=10.0, clip="pairwise", max_iter=40_000)
    ref = smo_reference(x2, z, JConfig(**kw), f_init=f0, guard_eta=True)
    got = train(x2, z, SVMConfig(**kw), device="cpu", f_init=f0,
                guard_eta=True)
    assert got.converged and ref.converged
    assert abs(got.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)
    dg = got.alpha[:200] - got.alpha[200:]
    dr = ref.alpha[:200] - ref.alpha[200:]
    kx = np.exp(-0.2 * ((x[:, None] - x[None]) ** 2).sum(-1))
    _near(kx @ dg - got.b, kx @ dr - ref.b)


def test_svr_matches_jax_and_sklearn(reg_data):
    sk_svm = pytest.importorskip("sklearn.svm")
    x, y = reg_data
    cfg = dict(c=10.0, svr_epsilon=0.05, max_iter=20000)
    model, result = tsvr.train_svr(x, y, SVMConfig(**cfg), device="cpu")
    jm, _ = jsvr.train_svr(x, y, JConfig(**cfg))
    assert result.converged and model.task == "svr"
    assert 0 < model.n_sv < len(y)
    assert tsvr.evaluate_svr(model, x, y, device="cpu")["r2"] > 0.99
    _near(_pred(model, x), jsvr.predict_svr(jm, x))
    sk = sk_svm.SVR(C=10.0, epsilon=0.05, gamma=1 / x.shape[1],
                    tol=1e-3).fit(x, y)
    _near(_pred(model, x), sk.predict(x))
    assert abs(model.n_sv - len(sk.support_)) <= max(3, 0.05 * len(y))
    # the pairwise clip conserves sum(a - a*) = 0
    n = len(y)
    assert abs(float(np.sum(result.alpha[:n] - result.alpha[n:]))) < 1e-4


@pytest.mark.parametrize("kw,target", [
    (dict(kernel="linear"), lambda x: 0.5 * x[:, 1] - x[:, 2]),
    (dict(kernel="poly", degree=2, coef0=1.0, gamma=0.5),
     lambda x: x[:, 0] * x[:, 1] + 0.3 * x[:, 2] ** 2),
])
def test_svr_other_kernels_match_jax_and_sklearn(kw, target, reg_data):
    sk_svm = pytest.importorskip("sklearn.svm")
    x, _ = reg_data
    y = target(x).astype(np.float32)
    cfg = dict(c=10.0, svr_epsilon=0.05, max_iter=40000, **kw)
    model, result = tsvr.train_svr(x, y, SVMConfig(**cfg), device="cpu")
    jm, _ = jsvr.train_svr(x, y, JConfig(**cfg))
    assert result.converged
    _near(_pred(model, x), jsvr.predict_svr(jm, x))
    sk_kw = dict(kw)
    sk_kw.setdefault("gamma", 1 / x.shape[1])
    sk = sk_svm.SVR(C=10.0, epsilon=0.05, tol=1e-3, **sk_kw).fit(x, y)
    _near(_pred(model, x), sk.predict(x), 2e-2)


def test_svr_precomputed_matches_jax_and_rbf(reg_data):
    x, y = reg_data
    x, y = x[:120], y[:120]
    k = np.exp(-0.2 * ((x[:, None].astype(np.float64) - x[None]) ** 2)
               .sum(-1)).astype(np.float32)
    cfg = dict(c=10.0, svr_epsilon=0.05, max_iter=20000)
    model, res = tsvr.train_svr(k, y, SVMConfig(kernel="precomputed", **cfg),
                                device="cpu")
    jm, _ = jsvr.train_svr(k, y, JConfig(kernel="precomputed", **cfg))
    assert res.converged and model.num_attributes == 120
    np.testing.assert_array_equal(model.sv_idx, jm.sv_idx)
    _near(_pred(model, k), jsvr.predict_svr(jm, k))
    rbf, _ = tsvr.train_svr(x, y, SVMConfig(**cfg), device="cpu")
    _near(_pred(model, k), _pred(rbf, x))


@pytest.mark.parametrize("q", [16, 32, 64])
def test_svr_decomposition_meets_the_bar(q, reg_data):
    """working_set > 2 routes the seeded 2n problem to the decomposition
    (kernel B's plain version on the CPU)."""
    x, y = reg_data
    cfg = dict(c=10.0, svr_epsilon=0.05, max_iter=40000)
    pair, rp = tsvr.train_svr(x, y, SVMConfig(**cfg), device="cpu")
    dec, rd = tsvr.train_svr(x, y, SVMConfig(working_set=q, **cfg),
                             device="cpu")
    jd, rj = jsvr.train_svr(x, y, JConfig(working_set=q, **cfg))
    assert rd.converged and rd.rounds > 0 and rj.converged
    for other in (pair, jd):
        assert abs(dec.n_sv - other.n_sv) <= max(0.02 * other.n_sv, 3)
    _near(_pred(dec, x), _pred(pair, x))
    _near(_pred(dec, x), jsvr.predict_svr(jd, x))


def test_svr_shrinking_meets_the_bar(reg_data):
    x, y = reg_data
    cfg = dict(c=10.0, svr_epsilon=0.05, max_iter=40000)
    pair, _ = tsvr.train_svr(x, y, SVMConfig(**cfg), device="cpu")
    shr, rs = tsvr.train_svr(x, y, SVMConfig(shrinking=True,
                                             selection="second-order",
                                             **cfg), device="cpu")
    assert rs.converged
    assert abs(shr.n_sv - pair.n_sv) <= max(0.02 * pair.n_sv, 3)
    _near(_pred(shr, x), _pred(pair, x))


@pytest.mark.parametrize("q", [2, 4])
def test_twin_pair_hazard(q):
    """Two identical rows with pseudo-labels +1/-1 and an f_init that
    makes them the first pair: eta = K00 + K11 - 2 K01 = 0 exactly. The
    TAU clamp takes the maximal step: both alphas land on the box, on the
    general pair (q = 2) and the decomposition (q = 4), as in JAX."""
    from dpsvm_tpu.api import train as jtrain
    x = np.array([[1.0, 0.0], [1.0, 0.0]], np.float32)
    z = np.array([1, -1], np.int32)
    f0 = np.array([-1.0, 1.0], np.float32)
    kw = dict(c=2.0, gamma=0.5, epsilon=1e-3, max_iter=50, working_set=q)
    r = train(x, z, SVMConfig(**kw), device="cpu", f_init=f0,
              guard_eta=True)
    rj = jtrain(x, z, JConfig(**kw), f_init=f0, guard_eta=True)
    a = np.asarray(r.alpha)
    assert np.isfinite(a).all() and np.isfinite([r.b, r.b_lo, r.b_hi]).all()
    np.testing.assert_array_equal(a, [2.0, 2.0])
    np.testing.assert_array_equal(a, np.asarray(rj.alpha))
    assert r.n_iter == rj.n_iter


def test_svr_duplicate_training_points(reg_data):
    x, y = reg_data
    xd = np.vstack([x[:50], x[:50]])
    yd = np.concatenate([y[:50], y[:50]])
    cfg = dict(c=10.0, svr_epsilon=0.02, max_iter=40000)
    model, result = tsvr.train_svr(xd, yd, SVMConfig(**cfg), device="cpu")
    jm, _ = jsvr.train_svr(xd, yd, JConfig(**cfg))
    assert result.converged and np.isfinite(result.alpha).all()
    assert tsvr.evaluate_svr(model, xd, yd, device="cpu")["r2"] > 0.98
    _near(_pred(model, xd), jsvr.predict_svr(jm, xd))


def _same_error(call_j, call_t, exc=ValueError):
    msgs = []
    for call in (call_j, call_t):
        with pytest.raises(exc) as e:
            call()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


def test_svr_refusals_match_jax(reg_data):
    x, y = reg_data
    assert "class weights" in _same_error(
        lambda: jsvr.train_svr(x, y, JConfig(weight_pos=2.0)),
        lambda: tsvr.train_svr(x, y, SVMConfig(weight_pos=2.0),
                               device="cpu"))
    _same_error(lambda: jsvr.train_svr(x, y[:5]),
                lambda: tsvr.train_svr(x, y[:5], device="cpu"))
    _same_error(lambda: jsvr.train_svr(x, y, JConfig(svr_epsilon=-1.0)),
                lambda: tsvr.train_svr(x, y, SVMConfig(svr_epsilon=-1.0),
                                       device="cpu"))
    xb, yb = make_blobs(n=40, d=3, seed=0)
    model, _ = fit(xb, yb, SVMConfig(max_iter=3000), device="cpu")
    with pytest.raises(ValueError, match="svr"):
        tsvr.predict_svr(model, xb, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsvr.train_svr(x, y)


def test_regression_metrics_are_jax(reg_data):
    _, y = reg_data
    pred = y + np.random.default_rng(1).normal(0, 0.1, len(y))
    assert tsvr.regression_metrics(pred, y) == jsvr.regression_metrics(
        pred, y)


def test_svr_model_files_cross_both_ways(tmp_path, reg_data):
    x, y = reg_data
    jm, _ = jsvr.train_svr(x, y, JConfig(c=10.0, svr_epsilon=0.05))
    tm = model_from_numpy(jm.x_sv, jm.alpha, jm.y_sv, jm.b, jm.gamma,
                          task="svr")
    pj, pt = str(tmp_path / "j.svr"), str(tmp_path / "t.svr")
    jio.save_model(jm, pj)
    tio.save_model(tm, pt)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    with open(pt) as f:
        assert f.readline().startswith("kernel rbf ")
        assert f.readline().strip() == "task svr"
    back = tio.load_model(pj)
    assert back.task == "svr"
    np.testing.assert_array_equal(_pred(back, x), _pred(tm, x))
    assert jio.load_model(pt).task == "svr"


def test_cross_validate_svr_matches_jax(reg_data):
    x, y = reg_data
    cfg = dict(c=10.0, svr_epsilon=0.05, max_iter=20000)
    rj = jcv.cross_validate(x, y, 4, JConfig(**cfg), task="svr", seed=2)
    rt = tcv.cross_validate(x, y, 4, SVMConfig(**cfg), task="svr", seed=2,
                            device="cpu")
    np.testing.assert_array_equal(rt["folds"], rj["folds"])
    assert rt["predictions"].dtype == np.float32
    _near(rt["predictions"], rj["predictions"])
    for key in ("mse", "mae", "r2"):
        assert abs(rt[key] - rj[key]) <= 1e-3
    _same_error(lambda: jcv.cross_validate(x, y, 4, JConfig(**cfg),
                                           task="svr", batched=True),
                lambda: tcv.cross_validate(x, y, 4, SVMConfig(**cfg),
                                           task="svr", batched=True,
                                           device="cpu"))


def _cli(main, args):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(args)
    return rc, out.getvalue()


def test_cli_svr_train_test_prints_the_jax_lines(tmp_path):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain

    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, 5)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1]).astype(np.float32)
    data = str(tmp_path / "reg.csv")
    with open(data, "w") as f:
        for xi, yi in zip(x, y):
            f.write(f"{yi}," + ",".join(f"{v:.6f}" for v in xi) + "\n")
    lines = {}
    for tag, main, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        model = str(tmp_path / f"{tag}.svr")
        rc, out = _cli(main, ["train", "-f", data, "-m", model, "--svr",
                              "-c", "10", "-p", "0.05", "-q", *extra])
        assert rc == 0
        train_lines = [ln for ln in out.splitlines()
                       if ln.startswith(("Number", "Training MSE",
                                         "Training iterations"))]
        preds = str(tmp_path / f"{tag}.txt")
        rc, out = _cli(main, ["test", "-f", data, "-m", model,
                              "--predictions", preds, *extra])
        assert rc == 0
        lines[tag] = train_lines + out.splitlines()
        vals = np.loadtxt(preds)
        assert vals.shape == (len(y),) and np.mean((vals - y) ** 2) < 0.01
    assert lines["port"] == lines["jax"]
    # a tube wider than the targets: no SVs, a clean error, no file
    model = str(tmp_path / "never.svr")
    rc, _ = _cli(tmain, ["train", "-f", data, "-m", model, "--svr", "-p",
                         "100", "-q", "--device", "cpu"])
    assert rc == 1 and not os.path.exists(model)


def test_cli_svr_cv_prints_the_jax_line(tmp_path, reg_data):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain

    x, y = reg_data
    data = str(tmp_path / "reg.csv")
    with open(data, "w") as f:
        for xi, yi in zip(x[:90], y[:90]):
            f.write(f"{yi}," + ",".join(f"{v:.6f}" for v in xi) + "\n")
    outs = [_cli(m, ["train", "-f", data, "-v", "3", "--svr", "-c", "10",
                     "-q", *extra])
            for m, extra in ((jmain, []), (tmain, ["--device", "cpu"]))]
    assert outs[0][0] == outs[1][0] == 0
    assert outs[1][1].startswith("Cross Validation (3-fold) MSE:")
    assert outs[1][1] == outs[0][1]


CONFLICTS = [
    ["--svr", "--one-class"],
    ["--nu-svc", "--nu-svr"],
    ["--svr", "--multiclass"],
    ["--one-class", "--probability"],
    ["--nu-svr", "--probability-cv"],
    ["--nu-svc", "--multiclass", "--probability-cv"],
    ["--svr", "--weight-pos", "2"],
    ["--one-class", "--clip", "independent"],
    ["--nu-svc", "-v", "3"],
    ["--nu-svr", "--checkpoint", "s.npz"],
    ["--svr", "-v", "3", "--c-sweep", "1,2"],
    ["--svr", "-v", "3", "--batched"],
    ["--svr", "-v", "3", "--weight", "1:2", "--clip", "pairwise"],
    ["--one-class", "-v", "3"],
    ["--model-format", "libsvm", "--multiclass"],
]


@pytest.mark.parametrize("flags", CONFLICTS, ids=" ".join)
def test_cli_conflicts_match_jax(flags, tmp_path, capsys):
    """Each row of the JAX CLI's conflict table for the new flags: the
    same exit code and the same message, before the data is read."""
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain

    x, y = make_blobs(n=30, d=3, seed=0)
    data = str(tmp_path / "d.csv")
    with open(data, "w") as f:
        for xi, yi in zip(x, y):
            f.write(f"{yi}," + ",".join(f"{v:.6f}" for v in xi) + "\n")
    args = ["train", "-f", data, "-m", str(tmp_path / "m"), "-q", *flags]
    got = []
    for main, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        rc = main(args + extra)
        got.append((rc, capsys.readouterr().err.strip().splitlines()[-1]))
    assert got[0][0] == 2 and got[1] == got[0], got
