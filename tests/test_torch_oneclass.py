"""The port's one-class SVM (``models/oneclass.py``) on the CPU, against the
JAX package, its NumPy oracle and sklearn's OneClassSVM (libsvm), on the
general pair and the decomposition (kernel B's plain version here).

Bars, and why:

* the general pair's whole run from LIBSVM's seed (floor(nu n) alphas at
  the box, f0 = K alpha0) against ``smo_reference(..., f_init,
  alpha_init, guard_eta=True)`` with the pairwise clip: the same n_iter
  on both kernels here, the linear one also with the same (i_hi, i_lo)
  sequence and alphas; RBF alphas within 1e-5 (PyTorch's and NumPy's exp
  differ in last bits);
* converged models: decisions within 5e-3 of the JAX ``train_oneclass``'s
  and the sklearn bars of ``tests/test_oneclass.py``;
* the decomposition (working_set 16 to 64) against the port's own general
  pair and the JAX decomposition by the LibSVM bar (n_sv within 2% or 3,
  decisions within 5e-3), not n_iter (ROADMAP Queue 3);
* model files: the JAX package's ``task oneclass`` layout byte for byte
  both ways; the CLI's report lines are the JAX CLI's, up to the side
  a margin SV's training row falls on.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.models import io as jio
from dpsvm_tpu.models import oneclass as joc
from dpsvm_tpu.ops.diagnostics import _stream_kv as j_stream_kv
from dpsvm_tpu.solver.oracle import smo_reference
from dpsvm_tpu_torch import SVMConfig, train
from dpsvm_tpu_torch.convert import model_from_numpy
from dpsvm_tpu_torch.models import io as tio
from dpsvm_tpu_torch.models import oneclass as toc
from dpsvm_tpu_torch.solver import smo as tsmo
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    return rng.normal(size=(300, 4)).astype(np.float32)


def _score(model, x):
    return toc.score_oneclass(model, x, device="cpu")


def _near(a, b, tol=5e-3):
    assert np.abs(np.asarray(a) - np.asarray(b)).max() <= tol


def test_seed_is_libsvm_s():
    a = toc.oneclass_seed(10, 0.25)
    np.testing.assert_array_equal(a, [1, 1, 0.5, 0, 0, 0, 0, 0, 0, 0])
    assert a.dtype == np.float32


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("nu", [0.1, 0.2])
def test_run_follows_the_oracle(cloud, kernel, nu):
    n = len(cloud)
    kw = dict(c=1.0, clip="pairwise", max_iter=50000, kernel=kernel)
    a0 = toc.oneclass_seed(n, nu)
    f0 = np.asarray(j_stream_kv(cloud, a0, JConfig(**kw).kernel_spec(4),
                                block=4096), np.float32)
    z = np.ones(n, np.int32)
    trace = []
    ref = smo_reference(cloud, z, JConfig(**kw), trace=trace, f_init=f0,
                        alpha_init=a0, guard_eta=True)
    got = train(cloud, z, SVMConfig(**kw), device="cpu", f_init=f0,
                alpha_init=a0, guard_eta=True)
    assert got.converged and got.n_iter == ref.n_iter
    if kernel == "linear":
        prob = tsmo.SMOProblem.build(cloud, z, SVMConfig(**kw), CPU)
        opts = tsmo.SMOOptions.from_config(SVMConfig(**kw), guard_eta=True)
        carry, pairs = tsmo.init_carry(prob.y, f0, a0), []
        while bool(tsmo.live(carry, tsmo.two_eps_f32(1e-3), 50000)):
            u = tsmo.pair_update(carry, prob, opts)
            pairs.append((int(u.i_hi), int(u.i_lo)))
            carry = tsmo.smo_step(carry, prob, opts)
        assert pairs == [(a, b) for a, b, _, _ in trace]
        np.testing.assert_array_equal(got.alpha, ref.alpha)
    else:
        np.testing.assert_allclose(got.alpha, ref.alpha, atol=1e-5)
    # the pairwise clip conserves sum(alpha) = nu n
    assert abs(float(np.sum(got.alpha)) - nu * n) < 1e-3


def test_matches_jax_and_sklearn(cloud):
    sk_svm = pytest.importorskip("sklearn.svm")
    model, result = toc.train_oneclass(cloud, nu=0.2,
                                       config=SVMConfig(max_iter=50000),
                                       device="cpu")
    jm, _ = joc.train_oneclass(cloud, nu=0.2,
                               config=JConfig(max_iter=50000))
    assert result.converged and model.task == "oneclass"
    _near(_score(model, cloud), joc.score_oneclass(jm, cloud))
    sk = sk_svm.OneClassSVM(nu=0.2, gamma=1 / cloud.shape[1]).fit(cloud)
    assert abs(model.b - float(np.ravel(sk.offset_)[0])) < 1e-3
    _near(_score(model, cloud), sk.decision_function(cloud), 2e-3)
    pred = toc.predict_oneclass(model, cloud, device="cpu")
    assert np.mean(pred == sk.predict(cloud)) >= 0.98
    assert abs(float(np.mean(pred < 0)) - 0.2) < 0.05


def test_flags_outliers(cloud):
    model, _ = toc.train_oneclass(cloud, nu=0.1,
                                  config=SVMConfig(max_iter=50000),
                                  device="cpu")
    far = np.full((5, cloud.shape[1]), 25.0, np.float32)
    assert (toc.predict_oneclass(model, far, device="cpu") == -1).all()
    center = np.zeros((3, cloud.shape[1]), np.float32)
    assert (toc.predict_oneclass(model, center, device="cpu") == 1).all()


@pytest.mark.parametrize("q", [16, 32, 64])
def test_decomposition_meets_the_bar(cloud, q):
    """working_set > 2: the decomposition's first round starts with
    floor(nu n) alphas at the box and f = K alpha0."""
    cfg = dict(max_iter=50000)
    pair, _ = toc.train_oneclass(cloud, 0.2, SVMConfig(**cfg), device="cpu")
    dec, rd = toc.train_oneclass(cloud, 0.2, SVMConfig(working_set=q, **cfg),
                                 device="cpu")
    jd, rj = joc.train_oneclass(cloud, 0.2, JConfig(working_set=q, **cfg))
    assert rd.converged and rd.rounds > 0 and rj.converged
    assert abs(float(np.sum(rd.alpha)) - 0.2 * len(cloud)) < 1e-3
    for other in (pair, jd):
        assert abs(dec.n_sv - other.n_sv) <= max(0.02 * other.n_sv, 3)
    _near(_score(dec, cloud), _score(pair, cloud))
    _near(_score(dec, cloud), joc.score_oneclass(jd, cloud))


def test_precomputed_matches_jax(cloud):
    x = cloud[:150]
    k = np.exp(-0.25 * ((x[:, None].astype(np.float64) - x[None]) ** 2)
               .sum(-1)).astype(np.float32)
    cfg = dict(max_iter=50000)
    model, res = toc.train_oneclass(k, 0.2, SVMConfig(kernel="precomputed",
                                                      **cfg), device="cpu")
    jm, _ = joc.train_oneclass(k, 0.2, JConfig(kernel="precomputed", **cfg))
    assert res.converged
    np.testing.assert_array_equal(model.sv_idx, jm.sv_idx)
    _near(_score(model, k), joc.score_oneclass(jm, k))
    rbf, _ = toc.train_oneclass(x, 0.2, SVMConfig(**cfg), device="cpu")
    _near(_score(model, k), _score(rbf, x))


def _same_error(call_j, call_t, exc=ValueError):
    msgs = []
    for call in (call_j, call_t):
        with pytest.raises(exc) as e:
            call()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


@pytest.mark.parametrize("nu,kw", [(0.0, {}), (1.0, {}),
                                   (0.2, dict(weight_pos=2.0))])
def test_refusals_match_jax(cloud, nu, kw):
    _same_error(lambda: joc.train_oneclass(cloud, nu, JConfig(**kw)),
                lambda: toc.train_oneclass(cloud, nu, SVMConfig(**kw),
                                           device="cpu"))


def test_needs_the_card_by_default(cloud):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        toc.train_oneclass(cloud, 0.2)


def test_model_files_cross_both_ways(tmp_path, cloud):
    jm, _ = joc.train_oneclass(cloud, nu=0.3,
                               config=JConfig(max_iter=50000))
    tm = model_from_numpy(jm.x_sv, jm.alpha, jm.y_sv, jm.b, jm.gamma,
                          task="oneclass")
    pj, pt = str(tmp_path / "j.oc"), str(tmp_path / "t.oc")
    jio.save_model(jm, pj)
    tio.save_model(tm, pt)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    back = tio.load_model(pj)
    assert back.task == "oneclass"
    np.testing.assert_array_equal(_score(back, cloud), _score(tm, cloud))
    assert jio.load_model(pt).task == "oneclass"
    with pytest.raises(ValueError, match="oneclass"):
        toc.score_oneclass(model_from_numpy(jm.x_sv, jm.alpha, jm.y_sv,
                                            jm.b, jm.gamma), cloud,
                           device="cpu")


def _cli(main, args):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(args)
    return rc, out.getvalue()


def test_cli_oneclass_prints_the_jax_lines(tmp_path, cloud):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain

    data = str(tmp_path / "oc.csv")
    with open(data, "w") as f:
        for i, xi in enumerate(cloud):
            f.write(f"{1 if i % 7 else -1}," + ",".join(f"{v:.6f}" for v in xi)
                    + "\n")
    lines = {}
    for tag, main, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        model = str(tmp_path / f"{tag}.oc")
        rc, out = _cli(main, ["train", "-f", data, "-m", model,
                              "--one-class", "--nu", "0.2", "-q", *extra])
        assert rc == 0
        keep = [ln for ln in out.splitlines()
                if not ln.startswith("Training time")]
        preds = str(tmp_path / f"{tag}.txt")
        rc, out = _cli(main, ["test", "-f", data, "-m", model,
                              "--predictions", preds, *extra])
        assert rc == 0
        lines[tag] = keep + out.splitlines()
        assert set(np.unique(np.loadtxt(preds))) <= {-1.0, 1.0}
    # The same lines, up to the decision of a margin SV: a free alpha's
    # training row has decision 0 give or take the ulps of f0 (XLA's
    # streamed pass against PyTorch's), so a row or two may change side.
    assert len(lines["port"]) == len(lines["jax"])
    for lp, lj in zip(lines["port"], lines["jax"]):
        head, _, vp = lp.partition(": ")
        assert lj.startswith(head + ": ")
        if lp == lj:
            continue
        a, b = float(vp.split()[0]), float(lj.partition(": ")[2].split()[0])
        assert abs(a - b) <= (1e-5 if head == "rho" else 2.0 / len(cloud))


def test_host_stops_where_the_device_stops():
    """b_hi + 2 eps rounds up to b_lo in float32 (|f| ~ 834, as one-class
    at 60000 rows has), though the float64 gap is above 2 eps: the
    device's condition has closed, and the host's verdict must close with
    it instead of polling a device that never steps again (the wall
    budget ends the run if it does not)."""
    from dpsvm_tpu_torch.convert import smo_carry_from_numpy
    from dpsvm_tpu_torch.solver.driver import _finite_converged, gap_open
    b_hi = 834.5536499023438
    b_lo = b_hi + 33 * 2.0 ** -14            # 33 float32 ulps above
    assert b_lo - b_hi > 2e-3 and np.float32(b_lo) == b_lo
    assert not gap_open(b_lo, b_hi, 2e-3) and _finite_converged(b_lo, b_hi,
                                                                 1e-3)
    assert gap_open(b_lo + 2.0 ** -14, b_hi, 2e-3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    z = np.ones(40, np.float32)
    a = np.full(40, 0.5, np.float32)
    carry = smo_carry_from_numpy(a, np.full(40, b_hi, np.float32), z, b_hi,
                                 b_lo, 7, device="cpu")
    res = tsmo.train_single_device(
        x, z, SVMConfig(c=1.0, clip="pairwise", wall_budget_s=5.0), CPU,
        carry=carry, guard_eta=True)
    assert res.converged and res.n_iter == 7


@pytest.mark.parametrize("working_set", [2, 16])
def test_shrinking_stops_where_the_device_stops(working_set):
    """The same float32-closed, float64-open gap through the active-set
    manager (one-class and epsilon-SVR with ``shrinking=True`` take it):
    the sub-problem's verdict and the verdict after unshrinking are the
    device's, so the run converges at once instead of polling until the
    wall budget. Identical rows give eta = 0, and f0 puts b_lo 33 float32
    ulps above b_hi at |f| ~ 834."""
    from dpsvm_tpu_torch.solver.shrink import train_shrinking
    b_hi = 834.5536499023438
    b_lo = b_hi + 33 * 2.0 ** -14
    n = 40
    f0 = np.full(n, b_hi, np.float32)
    f0[1] = f0[3] = b_lo
    res = train_shrinking(
        np.zeros((n, 3), np.float32), np.ones(n, np.float32),
        SVMConfig(c=1.0, clip="pairwise", shrinking=True,
                  working_set=working_set, wall_budget_s=5.0),
        CPU, f_init=f0, alpha_init=np.full(n, 0.5, np.float32),
        guard_eta=True)
    assert res.converged and res.n_iter <= 1
    assert (res.b_hi, res.b_lo) == (b_hi, b_lo)
