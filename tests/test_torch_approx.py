"""The port's approx solvers (``dpsvm_tpu_torch/approx/``) on the CPU,
against the JAX package's ``dpsvm_tpu/approx/``.

Bars, and why:

* bitwise: ``rff_omega``, the Nystrom landmarks and projection (both
  packages run the same NumPy and float64 ``eigh`` on the host), the
  shuffle (the labels the port lays out on the device), and the three
  ``screening`` functions (a NumPy copy);
* ``featurize`` within 1e-5 of the largest feature (absolute below 1):
  the block products are float32 in both, in different summation orders;
* ``big_l`` within 1e-5 relative: the port takes the mean squared feature
  norm and the power iteration on the device, from the same seeded start;
* one primal step from a common carry and a common feature matrix: w
  within 1e-6 relative;
* converged fits (minibatch below 2048 rows and full batch, RFF and
  Nystrom, SVC and SVR): decisions within 5e-3, held-out accuracy within
  one example, n_iter within 5% (squared-hinge activity flips at near-ties
  can move a trajectory, ROADMAP Queue 3; at these sizes they agree);
* files: approx ``.npz`` models and approx checkpoints load in the other
  package; a JAX checkpoint at step 300 resumes in the port; the port's
  own resume is bitwise;
* the config, api and CLI refusals: the JAX exception types and messages;
* the estimators, CV, Platt and one-vs-one approx pairs against the JAX
  package's; ``python -m dpsvm_tpu_torch.approx --selfcheck``.
"""

import dataclasses
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from dpsvm_tpu import api as japi
from dpsvm_tpu.approx import features as jfeat
from dpsvm_tpu.approx import model as jmodel
from dpsvm_tpu.approx import primal as jprimal
from dpsvm_tpu.approx import screening as jscreen
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs
from dpsvm_tpu.ops.kernels import KernelSpec as JSpec
from dpsvm_tpu_torch import api as tapi
from dpsvm_tpu_torch.approx import features as tfeat
from dpsvm_tpu_torch.approx import model as tmodel
from dpsvm_tpu_torch.approx import primal as tprimal
from dpsvm_tpu_torch.approx import screening as tscreen
from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.ops.kernels import KernelSpec
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _problem(n, d=16, task="svc", seed=3, held=300):
    x, y = make_blobs(n=n + held, d=d, seed=seed)
    if task == "svr":
        rng = np.random.default_rng(1)
        y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(len(x))).astype(
            np.float32)
    return x[:n], y[:n], x[n:], y[n:]


def _kw(kind, d=16, **extra):
    return dict(solver=f"approx-{kind}", approx_dim=256, c=5.0,
                gamma=1.0 / d, epsilon=1e-3, max_iter=20_000, **extra)


def _jfit(x, y, kw, task="svc", **extra):
    return jprimal.fit_approx(x, y, JConfig(**kw), task=task, **extra)


def _tfit(x, y, kw, task="svc", **extra):
    return tprimal.fit_approx(x, y, SVMConfig(**kw), task=task, device=CPU,
                              **extra)


# --- feature maps --------------------------------------------------------

@pytest.mark.parametrize("d,dim,gamma,seed", [(16, 256, 0.0625, 0),
                                              (784, 1024, 0.25, 7),
                                              (5, 6, 1.5, 123)])
def test_rff_omega_is_bitwise_the_jax_one(d, dim, gamma, seed):
    np.testing.assert_array_equal(tfeat.rff_omega(d, dim, gamma, seed),
                                  jfeat.rff_omega(d, dim, gamma, seed))


@pytest.mark.parametrize("kernel", ["rbf", "poly", "sigmoid", "linear"])
def test_nystrom_map_is_bitwise_the_jax_one(kernel):
    x, _, _, _ = _problem(500, d=12)
    kw = dict(kind=kernel, gamma=0.1, coef0=0.5, degree=3)
    jm = jfeat.build_feature_map("nystrom", x, 128, 4, JSpec(**kw))
    tm = tfeat.build_feature_map("nystrom", x, 128, 4, KernelSpec(**kw))
    assert tm.dim == jm.dim
    np.testing.assert_array_equal(tm.landmarks, jm.landmarks)
    np.testing.assert_array_equal(tm.proj, jm.proj)


@pytest.mark.parametrize("kind,kernel", [("rff", "rbf"),
                                         ("nystrom", "rbf"),
                                         ("nystrom", "poly"),
                                         ("nystrom", "sigmoid")])
def test_featurize_matches_jax(kind, kernel):
    """phi within 1e-5 of the largest feature (1e-5 absolute below 1;
    Nystrom's poly features reach ~5 here), x spanning two blocks of the
    transform."""
    x, _, _, _ = _problem(700, d=12)
    kw = dict(kind=kernel, gamma=0.1, coef0=0.5, degree=2)
    jm = jfeat.build_feature_map(kind, x, 128, 2, JSpec(**kw))
    tm = tfeat.build_feature_map(kind, x, 128, 2, KernelSpec(**kw))
    want = jfeat.featurize(jm, x, chunk=512)
    got = tfeat.featurize(tm, x, chunk=512, device=CPU)
    assert got.device == CPU and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(
        1.0, float(np.max(np.abs(want)))))


# --- the primal set-up and step -----------------------------------------

def _jax_big_l(x, y, cfg: JConfig, task="svc"):
    """The JAX ``fit_approx`` set-up, line for line (its big_l, padded
    phi with the bias lane, labels and row weights)."""
    n, d = x.shape
    fmap = jfeat.build_feature_map(cfg.solver.split("-", 1)[1], x,
                                   cfg.approx_dim, cfg.approx_seed,
                                   cfg.kernel_spec(d))
    if n >= jprimal._FULLBATCH_ROWS:
        batch = n_pad = -(-n // 256) * 256
    else:
        batch = min(jprimal._BATCH, 1 << (n - 1).bit_length())
        n_pad = -(-n // batch) * batch
    perm = np.random.default_rng(cfg.approx_seed).permutation(n)
    phi = jfeat.featurize_padded(fmap, x[perm], n_pad)
    msq = float(np.mean(np.sum(phi[:n].astype(np.float64) ** 2, axis=1)))
    phi = np.concatenate([phi, np.zeros((n_pad, 1), np.float32)], axis=1)
    phi[:n, -1] = 1.0
    msq += 1.0
    lam = 1.0 / (float(cfg.c) * n)
    if batch == n_pad:
        curv = min(msq, 1.1 * jprimal._power_lambda_max(phi, n))
    else:
        curv = msq * (n_pad / n)
    yp = np.zeros((n_pad,), np.float32)
    yp[:n] = np.asarray(y, np.float32)[perm]
    return lam + 2.0 * curv, phi, yp, batch, n_pad, lam


@pytest.mark.parametrize("n,kind", [(800, "rff"), (1500, "rff"),
                                    (3000, "rff"), (3000, "nystrom")])
def test_step_size_and_layout_match_jax(n, kind):
    """big_l within 1e-5 relative; the shuffled labels bitwise (the
    permutation); the same batch and padding."""
    x, y, _, _ = _problem(n)
    kw = _kw(kind)
    big_l, phi, yp, batch, n_pad, _ = _jax_big_l(x, y, JConfig(**kw))
    fmap = tfeat.build_feature_map(kind, x, 256, 0,
                                   SVMConfig(**kw).kernel_spec(16))
    prob = tprimal.build_problem(x, np.asarray(y, np.float32),
                                 SVMConfig(**kw), "svc", fmap, CPU)
    assert (prob.batch, tprimal.RUN["n_pad"]) == (batch, n_pad)
    assert abs(tprimal.RUN["big_l"] - big_l) <= 1e-5 * big_l
    np.testing.assert_array_equal(prob.y.numpy(), yp)
    np.testing.assert_allclose(prob.phi.numpy(), phi, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,task", [(800, "svc"), (1500, "svc"),
                                    (3000, "svr")])
def test_one_primal_step_from_a_common_carry(n, task):
    """The JAX runner with limit = n_iter + 1 and the port's
    ``primal_step`` on the same phi and carry: w within 1e-6 relative."""
    x, y, _, _ = _problem(n, task=task)
    kw = _kw("rff")
    big_l, phi, yp, batch, n_pad, lam = _jax_big_l(x, y, JConfig(**kw),
                                                   task)
    dp = phi.shape[1]
    rw = np.zeros((n_pad,), np.float32)
    rw[:n] = 1.0
    rng = np.random.default_rng(5)
    carry = tprimal.init_carry(dp)._replace(
        w=(0.1 * rng.standard_normal(dp)).astype(np.float32),
        v=(0.01 * rng.standard_normal(dp)).astype(np.float32),
        metric=np.float32(0.5), best=np.float32(0.6),
        lrf=np.float32(0.5), n_iter=np.int32(255))
    runner = jprimal._build_primal_runner(task, n_pad, dp, batch, n, lam,
                                          big_l, 1e-3, 0.1, "HIGHEST")
    jc, _ = runner(jprimal.PrimalCarry(*carry), phi, yp, rw,
                   np.int32(256))
    f32 = lambda v: torch.tensor(np.float32(v))          # noqa: E731
    reg = np.ones((dp,), np.float32)
    reg[-1] = 0.0
    nb = n_pad // batch
    prob = tprimal.PrimalProblem(
        phi=torch.from_numpy(phi), y=torch.from_numpy(yp),
        rw=torch.from_numpy(rw), reg_mask=torch.from_numpy(reg),
        denom=f32(n / nb), n_real=f32(n), lam=f32(lam),
        lr=f32(1.0 / big_l), n_batches=nb, batch=batch, task=task,
        svr_eps=float(np.float32(0.1)), two_eps=float(np.float32(2e-3)))
    tc = tprimal.primal_step(tprimal.carry_to_device(carry, CPU), prob)
    assert int(tc.n_iter) == int(jc.n_iter) == 256
    w_j = np.asarray(jc.w)
    np.testing.assert_allclose(tc.w.numpy(), w_j, rtol=0,
                               atol=1e-6 * float(np.max(np.abs(w_j))))
    for a in ("metric", "best", "lrf"):
        np.testing.assert_allclose(float(getattr(tc, a)),
                                   float(getattr(jc, a)), rtol=1e-5)


# --- converged fits -------------------------------------------------------

FITS = [(800, "rff", "svc"), (1500, "rff", "svc"), (3000, "rff", "svc"),
        (1500, "nystrom", "svc"), (3000, "nystrom", "svc"),
        (1500, "rff", "svr"), (3000, "nystrom", "svr")]


@pytest.mark.parametrize("n,kind,task", FITS,
                         ids=["-".join(map(str, f)) for f in FITS])
def test_converged_fit_matches_jax(n, kind, task):
    x, y, xh, yh = _problem(n, task=task)
    kw = _kw(kind)
    mj, rj = _jfit(x, y, kw, task)
    mt, rt = _tfit(x, y, kw, task)
    assert rj.converged and rt.converged
    assert abs(rt.n_iter - rj.n_iter) <= max(2, 0.05 * rj.n_iter)
    dj = jmodel.decision_function(mj, xh)
    dt = tmodel.decision_function(mt, xh, device=CPU)
    assert float(np.max(np.abs(dt - dj))) < 5e-3
    if task == "svc":
        miss = np.sum((dj < 0) != (dt < 0))
        assert miss <= 1
    assert mt.task == task and rt.n_sv == rj.n_sv or abs(
        rt.n_sv - rj.n_sv) <= max(3, 0.02 * rj.n_sv)
    assert rt.b_hi == 0.0 and rt.b_lo <= 2e-3


# --- files -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rff", "nystrom"])
def test_model_files_go_both_ways(kind, tmp_path):
    x, y, xh, _ = _problem(600)
    mj, _ = _jfit(x, y, _kw(kind))
    mt, _ = _tfit(x, y, _kw(kind))
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    from dpsvm_tpu.models import io as jio
    from dpsvm_tpu_torch.models import io as tio
    assert jio.save_model(mj, pj) == 0 and tio.save_model(mt, pt) == 0
    got_t, got_j = tio.load_model(pj), jio.load_model(pt)
    for a, b in ((got_t, mj), (got_j, mt)):
        assert a.model_kind == b.model_kind and a.task == b.task
        np.testing.assert_array_equal(a.w, b.w)
        assert a.b == b.b and a.fmap.dim == b.fmap.dim
        for arr in ("omega", "landmarks", "proj"):
            if getattr(b.fmap, arr) is not None:
                np.testing.assert_array_equal(getattr(a.fmap, arr),
                                              getattr(b.fmap, arr))
    np.testing.assert_allclose(
        tmodel.decision_function(got_t, xh, device=CPU),
        jmodel.decision_function(mj, xh), rtol=0, atol=1e-5)
    assert tmodel.is_approx_model_file(pj)
    from dpsvm_tpu_torch.convert import approx_model_from_numpy
    fm = mj.fmap
    conv = approx_model_from_numpy(
        fm.kind, fm.d, fm.dim, fm.seed, fm.gamma, mj.w, mj.b, mj.task,
        kernel=fm.kernel, coef0=fm.coef0, degree=fm.degree,
        omega=fm.omega, landmarks=fm.landmarks, proj=fm.proj)
    np.testing.assert_array_equal(
        tmodel.decision_function(conv, xh, device=CPU),
        tmodel.decision_function(got_t, xh, device=CPU))


def test_a_file_without_the_marker_is_refused(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, w=np.zeros(3))
    from dpsvm_tpu.models import io as jio
    from dpsvm_tpu_torch.models import io as tio
    msgs = []
    for mod in (jio, tio):
        with pytest.raises(ValueError) as e:
            mod.load_model(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "format marker" in msgs[0]


def test_checkpoints_go_both_ways_and_the_port_resumes_bitwise(tmp_path):
    """A JAX checkpoint at step 300 resumes in the port (and the port's in
    the JAX package) to step 600 within the fit bar of the uncut JAX run;
    the port's own cut-and-resume is bitwise its uncut run."""
    x, y, xh, _ = _problem(3000)
    kw = dict(_kw("rff"), epsilon=1e-9, max_iter=600, chunk_iters=256)
    full_j, _ = _jfit(x, y, kw)
    full_t, _ = _tfit(x, y, kw)
    for tag, cut, resume, full in (("j", _jfit, _tfit, full_j),
                                   ("t", _tfit, _jfit, full_t)):
        ck = str(tmp_path / f"{tag}.npz")
        cut(x, y, dict(kw, max_iter=300, checkpoint_path=ck,
                       checkpoint_every=100))
        m, r = resume(x, y, dict(kw, resume_from=ck))
        assert r.n_iter == 600
        dm = (tmodel.decision_function(m, xh, device=CPU)
              if isinstance(m, tmodel.ApproxSVMModel)
              else jmodel.decision_function(m, xh))
        ref = jmodel.decision_function(full_j, xh)
        assert float(np.max(np.abs(dm - ref))) < 5e-3
    ck = str(tmp_path / "own.npz")
    _tfit(x, y, dict(kw, max_iter=300, checkpoint_path=ck,
                     checkpoint_every=100))
    m, r = _tfit(x, y, dict(kw, resume_from=ck))
    assert r.n_iter == 600
    np.testing.assert_array_equal(m.w, full_t.w)
    assert m.b == full_t.b


def test_warm_start_vector_and_init_w():
    x, y, _, _ = _problem(800)
    m, r = _tfit(x, y, _kw("rff"))
    iw = tprimal.warm_start_vector(m)
    assert iw.shape == (257,) and iw[-1] == np.float32(-m.b)
    m2, r2 = _tfit(x, y, _kw("rff"), init_w=iw)
    assert r2.n_iter < r.n_iter
    with pytest.raises(ValueError, match="init_w must be"):
        _tfit(x, y, _kw("rff"), init_w=iw[:-1])


# --- refusals --------------------------------------------------------------

REFUSED = [dict(solver="approx-rff", working_set=64),
           dict(solver="exact", screen_margin=0.7),
           dict(solver="cascade", polish=True),
           dict(solver="approx-nystrom", cache_size=4),
           dict(solver="approx-rff", selection="second-order"),
           dict(solver="approx-rff", shrinking=True),
           dict(solver="approx-nystrom", screen_cap=5),
           dict(solver="approx-rff", kernel="poly"),
           dict(solver="approx-rff", approx_dim=65),
           dict(solver="cascade", approx_dim=65),
           dict(solver="approx-nystrom", approx_dim=1),
           dict(solver="approx-nystrom", kernel="precomputed"),
           dict(solver="cascade", kernel="precomputed"),
           dict(solver="cascade", screen_margin=-1.0),
           dict(solver="cascade", screen_cap=-2),
           dict(solver="cascade", resume_from="x.npz"),
           dict(solver="cascade", checkpoint_path="x.npz",
                checkpoint_every=10),
           dict(solver="nope")]


@pytest.mark.parametrize("kw", REFUSED, ids=lambda k: ",".join(
    f"{a}={b}" for a, b in k.items()))
def test_config_refusals_match_jax(kw):
    msgs = []
    for cls in (JConfig, SVMConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_config_accepts_both_knob_families():
    SVMConfig(solver="cascade", approx_dim=64, approx_seed=7,
              selection="second-order", shrinking=True,
              screen_margin=0.2, screen_cap=1000).validate()
    SVMConfig(solver="cascade", working_set=64, inner_iters=8).validate()
    SVMConfig(solver="approx-nystrom", kernel="poly",
              approx_dim=33).validate()


def test_api_refusals_match_jax():
    x, y, _, _ = _problem(60)
    cfgs = (JConfig(solver="approx-rff"), SVMConfig(solver="approx-rff"))
    calls = [(lambda m, c: m.train(x, y, c)),
             (lambda m, c: m.warm_start(x, y, np.zeros(len(y)), c)),
             (lambda m, c: m.sweep_c(x, y, [1.0, 2.0], c))]
    for call in calls:
        msgs = []
        for mod, cfg in zip((japi, tapi), cfgs):
            with pytest.raises(ValueError) as e:
                call(mod, cfg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="fit_approx needs"):
        tprimal.fit_approx(x, y, SVMConfig(), device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tprimal.fit_approx(x, y, SVMConfig(solver="approx-rff", shards=2),
                           device=CPU)
    with pytest.raises(ValueError, match="labels must be"):
        tprimal.fit_approx(x, y + 2, SVMConfig(solver="approx-rff"),
                           device=CPU)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    x, y, _, _ = _problem(60)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprimal.fit_approx(x, y, SVMConfig(solver="approx-rff"))


# --- the consumers: api.fit, estimators, CV, Platt, one-vs-one -------------

def test_api_fit_and_svr_dispatch():
    from dpsvm_tpu.models import svr as jsvr
    from dpsvm_tpu_torch.models import svr as tsvr
    x, y, xh, _ = _problem(600)
    mt, _ = tapi.fit(x, y, SVMConfig(**_kw("rff")), device=CPU)
    mj, _ = japi.fit(x, y, JConfig(**_kw("rff")))
    assert mt.is_approx and mt.n_sv == 0
    from dpsvm_tpu_torch.models.svm import decision_function, predict
    assert float(np.max(np.abs(decision_function(mt, xh, device=CPU)
                               - jmodel.decision_function(mj, xh)))) < 5e-3
    assert set(np.unique(predict(mt, xh, device=CPU))) <= {-1, 1}
    x, y, xh, _ = _problem(600, task="svr")
    mt, _ = tsvr.train_svr(x, y, SVMConfig(**_kw("nystrom")), device=CPU)
    mj, _ = jsvr.train_svr(x, y, JConfig(**_kw("nystrom")))
    assert mt.task == "svr"
    np.testing.assert_allclose(tsvr.predict_svr(mt, xh, device=CPU),
                               jsvr.predict_svr(mj, xh), atol=5e-3)


def test_estimators_take_the_approx_solvers():
    from dpsvm_tpu.models import estimator as jest
    from dpsvm_tpu_torch.models import estimator as test_
    x, y, xh, yh = _problem(600)
    labels = np.where(y > 0, 7, 3)
    kw = dict(C=5.0, gamma=1.0 / 16, solver="approx-rff", approx_dim=256)
    ct = test_.DPSVMClassifier(device="cpu", **kw).fit(x, labels)
    cj = jest.DPSVMClassifier(**kw).fit(x, labels)
    assert ct.n_support_ is None and cj.n_support_ is None
    np.testing.assert_allclose(ct.decision_function(xh),
                               cj.decision_function(xh), atol=5e-3)
    assert np.mean(ct.predict(xh) == cj.predict(xh)) >= 0.99
    x, y, xh, yh = _problem(600, task="svr")
    rt = test_.DPSVMRegressor(device="cpu", **kw).fit(x, y)
    rj = jest.DPSVMRegressor(**kw).fit(x, y)
    np.testing.assert_allclose(rt.predict(xh), rj.predict(xh), atol=5e-3)
    assert abs(rt.score(xh, yh) - rj.score(xh, yh)) < 1e-3


def test_cv_and_platt_over_approx_models():
    from dpsvm_tpu.models import calibration as jcal
    from dpsvm_tpu.models import cv as jcv
    from dpsvm_tpu_torch.models import calibration as tcal
    from dpsvm_tpu_torch.models import cv as tcv
    x, y, _, _ = _problem(600)
    kw = _kw("rff")
    rt = tcv.cross_validate(x, y, 3, SVMConfig(**kw), device=CPU)
    rj = jcv.cross_validate(x, y, 3, JConfig(**kw))
    assert np.mean(rt["predictions"] == rj["predictions"]) >= 0.99
    at, bt = tcal.fit_platt_cv(x, y, SVMConfig(**kw), k=3, device=CPU)
    aj, bj = jcal.fit_platt_cv(x, y, JConfig(**kw), k=3)
    assert abs(at - aj) < 1e-2 and abs(bt - bj) < 1e-2


def test_one_vs_one_approx_pairs(tmp_path):
    from dpsvm_tpu.models import multiclass as jmc
    from dpsvm_tpu_torch.models import multiclass as tmc
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=3.0, size=(3, 8))
    lab = rng.integers(0, 3, size=450)
    x = (centers[lab] + rng.normal(size=(450, 8))).astype(np.float32)
    kw = _kw("rff", d=8)
    mt, rt = tmc.train_multiclass(x, lab, SVMConfig(**kw), device=CPU,
                                  probability=True)
    mj, rj = jmc.train_multiclass(x, lab, JConfig(**kw), probability=True)
    assert all(m.is_approx for m in mt.models)
    pt = tmc.predict_multiclass(mt, x, device=CPU)
    assert np.mean(pt == jmc.predict_multiclass(mj, x)) >= 0.99
    np.testing.assert_allclose(
        tmc.predict_proba_multiclass(mt, x, device=CPU),
        jmc.predict_proba_multiclass(mj, x), atol=2e-2)
    tmc.save_multiclass(mt, str(tmp_path / "mc"))
    back = jmc.load_multiclass(str(tmp_path / "mc"))
    assert np.mean(jmc.predict_multiclass(back, x) == pt) == 1.0
    msgs = []
    for mod, cls, extra in ((jmc, JConfig, {}), (tmc, SVMConfig,
                                                 {"device": CPU})):
        with pytest.raises(ValueError) as e:
            mod.train_multiclass(x, lab, cls(**kw), batched=True, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --- the CLI -----------------------------------------------------------

def _cli(main, args):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(args)
    return rc, out.getvalue()


def _csv(path, x, y):
    with open(path, "w") as f:
        for xi, yi in zip(x, y):
            f.write(f"{yi}," + ",".join(f"{v:.6f}" for v in xi) + "\n")


@pytest.mark.parametrize("solver", ["approx-rff", "approx-nystrom"])
def test_cli_approx_train_and_test(solver, tmp_path):
    """``train --solver approx-*`` then ``test``, both packages: the same
    report lines (iterations, model kind) and test accuracy within one
    example; each package reads the other's model file."""
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    x, y, _, _ = _problem(400, d=8)
    data = str(tmp_path / "d.csv")
    _csv(data, x, y)
    outs = {}
    for tag, main, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        model = str(tmp_path / f"{tag}.npz")
        rc, out = _cli(main, ["train", "-f", data, "-m", model, "--solver",
                              solver, "--approx-dim", "64", "-c", "5", "-q",
                              *extra])
        assert rc == 0, out
        assert f"Approx model: {solver} dim=" in out
        outs[tag] = out
    for model, main, extra in ((str(tmp_path / "jax.npz"), tmain,
                                ["--device", "cpu"]),
                               (str(tmp_path / "port.npz"), jmain, [])):
        rc, out = _cli(main, ["test", "-f", data, "-m", model, *extra])
        assert rc == 0 and "Test accuracy" in out
    accs = [float(o.split("Training accuracy: ")[1].split()[0])
            for o in outs.values()]
    assert abs(accs[0] - accs[1]) <= 1.0 / len(y) + 1e-9


CONFLICTS = [
    ["--solver", "approx-rff", "-v", "3", "--c-sweep", "1,2"],
    ["--solver", "approx-rff", "--multiclass", "--batched"],
    ["--solver", "approx-nystrom", "--model-format", "libsvm"],
    ["--solver", "cascade", "-v", "3", "--batched"],
    ["--solver", "cascade", "--svr"],
    ["--solver", "approx-rff", "--one-class"],
    ["--solver", "approx-rff", "--nu-svc"],
]


@pytest.mark.parametrize("flags", CONFLICTS, ids=" ".join)
def test_cli_conflicts_match_jax(flags, tmp_path, capsys):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    x, y, _, _ = _problem(30, d=3, held=0)
    data = str(tmp_path / "d.csv")
    _csv(data, x, y)
    args = ["train", "-f", data, "-m", str(tmp_path / "m"), "-q", *flags]
    got = []
    for main, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        rc = main(args + extra)
        got.append((rc, capsys.readouterr().err.strip().splitlines()[-1]))
    assert got[0][0] == 2 and got[1] == got[0], got


def test_selfcheck_module_runs_on_the_cpu():
    p = subprocess.run([sys.executable, "-m", "dpsvm_tpu_torch.approx",
                        "--selfcheck", "--device", "cpu"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ,
                                             OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr
    assert "approx selfcheck OK" in p.stdout


# --- screening (a NumPy copy) ---------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_screening_functions_are_bitwise_the_jax_ones(seed):
    rng = np.random.default_rng(seed)
    n = 500
    idx = np.sort(rng.choice(5000, size=n, replace=False))
    yf = rng.normal(size=n).astype(np.float32)
    yf[::7] = yf[0]                       # ties break on the index
    for cap in (None, 0, 100, n, n + 5):
        a, ca = jscreen.apply_cap(idx, yf, cap)
        b, cb = tscreen.apply_cap(idx, yf, cap)
        np.testing.assert_array_equal(a, b)
        assert ca == cb
    e = rng.normal(1.0, 0.5, size=n)
    a = e * 0.67 + rng.normal(0, 0.05, size=n)
    assert tscreen.margin_scale(e, a) == jscreen.margin_scale(e, a)
    assert tscreen.margin_scale(e[:5], a[:5]) == 1.0
    dec = rng.normal(size=n).astype(np.float32)
    yy = rng.choice([-1, 1], size=n)
    np.testing.assert_array_equal(
        tscreen.kkt_zero_violations(dec, yy, 2e-3),
        jscreen.kkt_zero_violations(dec, yy, 2e-3))
