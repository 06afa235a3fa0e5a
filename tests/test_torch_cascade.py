"""The port's cascade (``dpsvm_tpu_torch/solver/cascade.py``) on the CPU,
against the JAX package's ``dpsvm_tpu/solver/cascade.py``, on the fixtures
of ``tests/test_cascade.py`` (blobs 800 x 16, C = 5).

Bars, and why:

* zero screened-out KKT violators after repair, and convergence: the
  cascade's exactness certificate;
* ``n_kept`` within 1% of the JAX cascade's: a row at the band's edge can
  fall on the other side in the other package (float32 margins), which
  is not a fault (ROADMAP Queue 3);
* the models at the LibSVM bar (``tests/conftest.py``'s
  ``assert_libsvm_parity``: n_sv within 2% or 3, accuracy within one
  example on the training and a held-out set) against the JAX cascade's
  and the port's exact fit, and decisions within the JAX test's 0.1 of
  the exact fit's with the same signs;
* the adversarial re-admission case (D = 8, screen_margin = 1e-3) recovers
  the missed SVs;
* stage files: the fingerprint is the JAX package's dict; a file written
  by either package resumes in the other; the port's kill-and-resume at
  stages 1-3 is bitwise; a stale file is refused;
* the calibration probe (run here on 800 rows by lowering its row
  threshold in both packages) gives the JAX scale within 1e-3.
"""

import dataclasses
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from dpsvm_tpu import api as japi
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs
from dpsvm_tpu.models.svm import decision_function as jdec
from dpsvm_tpu.resilience import faultinject as jfault
from dpsvm_tpu.solver import cascade as jcs
from dpsvm_tpu_torch import api as tapi
from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.models.svm import decision_function as tdec
from dpsvm_tpu_torch.models.svm import evaluate
from dpsvm_tpu_torch.resilience import faultinject as tfault
from dpsvm_tpu_torch.solver import cascade as tcs

CPU = torch.device("cpu")
KW = dict(c=5.0, gamma=1.0 / 16, epsilon=1e-3, max_iter=200_000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small eager steps: the tier-1
    run puts six workers on the cores, and a worker's BLAS threads then
    contend (measured: a 1500-row approx fit took 69 s at 8 threads
    beside seven busy cores, 1.2 s at 1)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def blobs():
    x, y = make_blobs(n=1000, d=16, seed=3)
    return x[:800], y[:800], x[800:], y[800:]


@pytest.fixture(scope="module")
def fits(blobs):
    x, y, _, _ = blobs
    return {"jax": jcs.fit_cascade(x, y, JConfig(solver="cascade",
                                                 approx_dim=256, **KW)),
            "port": tcs.fit_cascade(x, y, SVMConfig(solver="cascade",
                                                    approx_dim=256, **KW),
                                    device=CPU),
            "exact": tapi.fit(x, y, SVMConfig(**KW), device=CPU)}


def _libsvm_bar(m, ref, sets):
    """n_sv within 2% or 3, accuracy within one example on each set."""
    assert abs(m.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3.0)
    for xs, ys in sets:
        a = evaluate(m, xs, ys, device=CPU)
        b = evaluate(ref, xs, ys, device=CPU)
        assert abs(a - b) <= 1.0 / len(ys) + 1e-9


def _convert(m):
    """A JAX SVMModel as the port's."""
    from dpsvm_tpu_torch.convert import model_from_numpy
    return model_from_numpy(m.x_sv, m.alpha, m.y_sv, m.b, m.gamma,
                            kernel=m.kernel, coef0=m.coef0,
                            degree=m.degree)


def test_cascade_matches_jax_and_the_exact_fit(blobs, fits):
    x, y, xh, yh = blobs
    mj, rj = fits["jax"]
    mt, rt = fits["port"]
    me, _ = fits["exact"]
    assert rt.converged and rt.kkt_violators == 0
    assert rj.converged and rj.kkt_violators == 0
    assert abs(rt.n_kept - rj.n_kept) <= 0.01 * rj.n_kept
    sets = ((x, y), (xh, yh))
    _libsvm_bar(mt, _convert(mj), sets)
    _libsvm_bar(mt, me, sets)
    de, dc = tdec(me, x, device=CPU), tdec(mt, x, device=CPU)
    assert float(np.max(np.abs(de - dc))) < 0.1
    assert np.array_equal(np.sign(de), np.sign(dc))


def test_result_shape_and_model_kind(blobs, fits):
    x, _, _, _ = blobs
    m, r = fits["port"]
    assert not getattr(m, "is_approx", False)
    assert r.alpha.shape == (x.shape[0],)
    assert int(np.sum(r.alpha > 0)) == m.n_sv
    assert 0 < r.n_kept < r.n_total == x.shape[0]
    kept = np.zeros(x.shape[0], bool)
    kept[r._kept_idx] = True
    assert not np.any(r.alpha[~kept] > 0)
    assert r.n_iter == r.approx_iters + r.polish_iters
    assert set(r.stage_seconds) == {"approx", "screen", "polish", "verify"}


def test_readmission_recovers_missed_svs(blobs, fits):
    """A crude map (D = 8) and a near-zero band miss true SVs; the verify
    re-admits them and the result still matches the exact fit."""
    x, y, _, _ = blobs
    me, _ = fits["exact"]
    cfg = SVMConfig(solver="cascade", approx_dim=8, screen_margin=1e-3,
                    **KW)
    m, r = tapi.fit(x, y, cfg, device=CPU)
    mj, rj = japi.fit(x, y, JConfig(solver="cascade", approx_dim=8,
                                    screen_margin=1e-3, **KW))
    assert r.n_readmitted > 0 and r.readmit_rounds >= 2
    assert r.kkt_violators == 0 and r.converged
    assert abs(r.n_kept - rj.n_kept) <= 0.01 * rj.n_kept
    de, dc = tdec(me, x, device=CPU), tdec(m, x, device=CPU)
    assert float(np.max(np.abs(de - dc))) < 0.1
    assert np.array_equal(np.sign(de), np.sign(dc))


def test_screen_cap_bounds_the_subproblem(blobs):
    x, y, _, _ = blobs
    cfg = SVMConfig(solver="cascade", approx_dim=256, screen_cap=300, **KW)
    _, r = tcs.fit_cascade(x, y, cfg, device=CPU)
    assert r.n_kept <= 300 + r.n_readmitted and r.kkt_violators == 0


def test_fingerprint_is_the_jax_dict():
    for kw in (dict(solver="cascade"),
               dict(solver="cascade", c=3.0, approx_dim=64, screen_cap=9,
                    weight_pos=2.0, epsilon=1e-2, kernel="poly")):
        init = np.arange(5, dtype=np.float32)
        a = jcs._fingerprint(JConfig(**kw), 100, 7, 0.5, init)
        b = tcs._fingerprint(SVMConfig(**kw), 100, 7, 0.5, init)
        assert a.keys() == b.keys()
        for k in a:
            assert type(a[k]) is type(b[k]) and a[k] == b[k]


def _kill(mod, fault, fit, x, y, cfg, stage):
    fault.install(fault.FaultPlan(cascade_stop_stage=stage))
    try:
        with pytest.raises(mod.CascadeInterrupted):
            fit(x, y, cfg)
    finally:
        fault.install(None)
        fault.clear()


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_kill_and_resume_is_bitwise(blobs, fits, stage, tmp_path):
    x, y, _, _ = blobs
    ref, _ = fits["port"]
    ck = str(tmp_path / "state.npz")
    cfg = SVMConfig(solver="cascade", approx_dim=256, checkpoint_path=ck,
                    **KW)

    def fit(a, b, c):
        return tcs.fit_cascade(a, b, c, device=CPU)

    _kill(tcs, tfault, fit, x, y, cfg, stage)
    assert os.path.exists(ck + ".cascade.npz")
    m, _ = fit(x, y, cfg)
    np.testing.assert_array_equal(m.alpha, ref.alpha)
    np.testing.assert_array_equal(m.x_sv, ref.x_sv)
    assert m.b == ref.b
    assert not os.path.exists(ck + ".cascade.npz")


@pytest.mark.parametrize("writer,stage", [("jax", 1), ("jax", 2),
                                          ("jax", 3), ("port", 2)])
def test_stage_files_go_both_ways(blobs, fits, writer, stage, tmp_path):
    """A stage file written by one package resumes in the other: zero
    violators, the LibSVM bar against the uninterrupted JAX cascade."""
    x, y, xh, yh = blobs
    ck = str(tmp_path / "state.npz")
    kw = dict(solver="cascade", approx_dim=256, checkpoint_path=ck, **KW)

    def tfit(a, b, c):
        return tcs.fit_cascade(a, b, c, device=CPU)

    if writer == "jax":
        _kill(jcs, jfault, jcs.fit_cascade, x, y, JConfig(**kw), stage)
        m, r = tfit(x, y, SVMConfig(**kw))
    else:
        _kill(tcs, tfault, tfit, x, y, SVMConfig(**kw), stage)
        mj, r = jcs.fit_cascade(x, y, JConfig(**kw))
        m = _convert(mj)
    assert r.kkt_violators == 0 and r.converged
    _libsvm_bar(m, _convert(fits["jax"][0]), ((x, y), (xh, yh)))
    assert not os.path.exists(ck + ".cascade.npz")


def test_stale_stage_state_is_refused(blobs, tmp_path):
    x, y, _, _ = blobs
    ck = str(tmp_path / "state.npz")
    cfg = SVMConfig(solver="cascade", approx_dim=256, checkpoint_path=ck,
                    **KW)

    def fit(a, b, c):
        return tcs.fit_cascade(a, b, c, device=CPU)

    _kill(tcs, tfault, fit, x, y, cfg, 1)
    with pytest.raises(tcs.CascadeStateError, match="stale"):
        fit(x, y, dataclasses.replace(cfg, c=9.0))
    with open(ck + ".cascade.npz", "wb") as f:
        f.write(b"not a zip")
    with pytest.raises(tcs.CascadeStateError, match="unreadable"):
        fit(x, y, cfg)


def test_the_kill_point_reads_the_environment(monkeypatch):
    monkeypatch.setenv("DPSVM_FAULT_CASCADE_STOP_STAGE", "2")
    tfault.clear()
    try:
        plan = tfault.current()
        assert plan is not None and plan.cascade_stop_stage == 2
        assert not plan.cascade_stop_now(1)
        assert plan.cascade_stop_now(2) and not plan.cascade_stop_now(3)
    finally:
        tfault.clear()
    monkeypatch.delenv("DPSVM_FAULT_CASCADE_STOP_STAGE")
    assert tfault.current() is None
    tfault.clear()


def test_calibration_probe_matches_jax(blobs, monkeypatch):
    """The probe path (``api.fit`` on a seeded subsample, then
    ``margin_scale``) at a lowered row threshold in both packages: the
    same scale within 1e-3 and kept counts within 1%."""
    x, y, _, _ = blobs
    for mod in (jcs, tcs):
        monkeypatch.setattr(mod, "_PROBE_ROWS", 256)
        monkeypatch.setattr(mod, "_PROBE_MIN_N", 500)
    kw = dict(solver="cascade", approx_dim=256, **KW)
    _, rt = tcs.fit_cascade(x, y, SVMConfig(**kw), device=CPU)
    scale_t = tcs.RUN["scale"]
    assert tcs.RUN["probe_rows"] == 256 and tcs.RUN["probe_iters"] > 0
    _, rj = jcs.fit_cascade(x, y, JConfig(**kw))
    # the JAX package logs its scale only; recompute it from its probe
    rng = np.random.default_rng(1)
    idx = np.sort(rng.choice(len(y), size=256, replace=False))
    m_a, _ = japi.fit(x, y, JConfig(**dict(kw, solver="approx-rff",
                                           epsilon=3e-3, max_iter=5000)))
    m_p, _ = japi.fit(x[idx], y[idx], JConfig(**KW))
    yf = np.asarray(y[idx], np.float32)
    scale_j = jcs.screening.margin_scale(jdec(m_p, x[idx]) * yf,
                                         jdec(m_a, x[idx]) * yf)
    assert abs(scale_t - scale_j) <= 1e-3
    assert abs(rt.n_kept - rj.n_kept) <= 0.01 * rj.n_kept
    assert rt.kkt_violators == 0


def test_refusals_match_jax(blobs):
    x, y, _, _ = blobs
    pairs = [(lambda m, c: m.train(x, y, c)),
             (lambda m, c: m.warm_start(x, y, np.zeros(len(y)), c))]
    for call in pairs:
        msgs = []
        for mod, cfg in ((japi, JConfig(solver="cascade")),
                         (tapi, SVMConfig(solver="cascade"))):
            with pytest.raises(ValueError) as e:
                call(mod, cfg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for fn, cfg in ((jcs.fit_cascade, JConfig()),
                    (tcs.fit_cascade, SVMConfig())):
        with pytest.raises(ValueError) as e:
            fn(x, y, cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "fit_cascade needs solver='cascade'"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcs.fit_cascade(x, y, SVMConfig(solver="cascade", shards=2),
                        device=CPU)


def _cli(main, args):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(args)
    return rc, out.getvalue()


def test_cli_cascade_train_and_test(tmp_path):
    """``train --solver cascade`` then ``test``, both packages: the report
    lines name the cascade, each package tests the other's model file,
    and the two models meet the LibSVM bar."""
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu.models.io import load_model as jload
    from dpsvm_tpu_torch.cli import main as tmain
    from dpsvm_tpu_torch.models.io import load_model as tload
    x, y = make_blobs(n=400, d=8, seed=5)
    data = str(tmp_path / "train.csv")
    with open(data, "w") as f:
        for xi, yi in zip(x, y):
            f.write(f"{int(yi)}," + ",".join(f"{v:.7g}" for v in xi) + "\n")
    for tag, main, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        rc, out = _cli(main, ["train", "-f", data, "-m",
                              str(tmp_path / f"{tag}.svm"), "--solver",
                              "cascade", "--approx-dim", "64",
                              "--screen-margin", "0.3", "-c", "5", "-g",
                              "0.125", "-q", *extra])
        assert rc == 0 and "Cascade: screened 400 ->" in out
        assert "0 KKT violator(s)" in out and "Number of SVs:" in out
    for model, main, extra in ((str(tmp_path / "jax.svm"), tmain,
                                ["--device", "cpu"]),
                               (str(tmp_path / "port.svm"), jmain, [])):
        rc, out = _cli(main, ["test", "-f", data, "-m", model, *extra])
        assert rc == 0 and "Test accuracy" in out
    mt = tload(str(tmp_path / "port.svm"))
    mj = _convert(jload(str(tmp_path / "jax.svm")))
    _libsvm_bar(mt, mj, ((x, y),))
