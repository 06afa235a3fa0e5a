"""LIBSVM ``.model`` files in the port (``models/libsvm_io.py``, and
``models/io.load_model``'s dispatch to it) on the CPU, against the JAX
package and sklearn's fitted libsvm attributes.

Bars, and why:

* a file holding sklearn's own fitted libsvm attributes loads into a model
  whose decisions equal sklearn's within 1e-5 (both label orders a real
  file can use), as ``tests/test_libsvm_model_io.py`` holds the JAX
  reader;
* files cross both ways: a model written by either package from the same
  arrays is the same file byte for byte, and loads in the other package
  to identical arrays, so its decisions are equal;
* refusals: the JAX reader's messages, word for word;
* the CLI: ``--model-format libsvm``, ``test`` on a LIBSVM file, and the
  width reconciliation of sparse data and sparse models, as the JAX CLI.
"""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs, save_csv
from dpsvm_tpu.models import libsvm_io as jlib
from dpsvm_tpu.models import nusvm as jnu
from dpsvm_tpu.models import oneclass as joc
from dpsvm_tpu.models import svr as jsvr
from dpsvm_tpu_torch import SVMConfig, fit
from dpsvm_tpu_torch.convert import model_from_numpy
from dpsvm_tpu_torch.models import io as tio
from dpsvm_tpu_torch.models import libsvm_io as tlib
from dpsvm_tpu_torch.models.svm import decision_function

sk_svm = pytest.importorskip("sklearn.svm")


def _dec(model, x):
    return decision_function(model, x, device="cpu")


def _sv_lines(coefs, svs):
    return [f"{c:.17g} " + " ".join(f"{j + 1}:{v:.9g}"
                                     for j, v in enumerate(sv) if v != 0)
            for c, sv in zip(coefs, svs)]


def _svc_file(clf, label_order):
    coef = clf.dual_coef_[0]
    rho = -float(clf.intercept_[0])
    if label_order[0] == -1:
        coef, rho = -coef, -rho
    return ["svm_type c_svc", "kernel_type rbf", f"gamma {clf._gamma:.17g}",
            "nr_class 2", f"total_sv {len(coef)}", f"rho {rho:.17g}",
            f"label {label_order[0]} {label_order[1]}",
            f"nr_sv {clf.n_support_[0]} {clf.n_support_[1]}", "SV",
            *_sv_lines(coef, clf.support_vectors_)]


@pytest.fixture(scope="module")
def blobs():
    return make_blobs(n=96, d=6, seed=3)


@pytest.mark.parametrize("label_order", [(1, -1), (-1, 1)])
def test_load_matches_sklearn_decision(blobs, tmp_path, label_order):
    x, y = blobs
    clf = sk_svm.SVC(C=4.0, kernel="rbf", gamma=0.25).fit(x, y)
    path = str(tmp_path / "m.model")
    with open(path, "w") as fh:
        fh.write("\n".join(_svc_file(clf, label_order)) + "\n")
    model = tio.load_model(path)           # dispatched on 'svm_type'
    assert tio.is_libsvm_model(path)
    assert model.task == "svc" and model.kernel == "rbf"
    np.testing.assert_allclose(_dec(model, x), clf.decision_function(x),
                               rtol=1e-5, atol=1e-5)
    want = jlib.load_libsvm_model(path)
    np.testing.assert_array_equal(model.alpha, want.alpha)
    np.testing.assert_array_equal(model.y_sv, want.y_sv)
    assert model.b == want.b


def test_regression_and_oneclass_match_sklearn(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, 6)).astype(np.float32)
    yr = (x[:, 0] - 0.5 * x[:, 1] + 0.1 * rng.normal(size=120)).astype(
        np.float32)
    reg = sk_svm.SVR(C=3.0, gamma=0.25, epsilon=0.1).fit(x, yr)
    oc = sk_svm.OneClassSVM(nu=0.2, gamma=0.3).fit(x)
    for name, est, kind, dec in (
            ("svr", reg, "epsilon_svr", reg.predict(x)),
            ("oc", oc, "one_class", oc.decision_function(x))):
        rho = (-float(est.intercept_[0]) if name == "svr"
               else float(est.offset_[0]))
        path = str(tmp_path / f"{name}.model")
        with open(path, "w") as fh:
            fh.write("\n".join([f"svm_type {kind}", "kernel_type rbf",
                                f"gamma {est._gamma:.17g}", "nr_class 2",
                                f"total_sv {len(est.dual_coef_[0])}",
                                f"rho {rho:.17g}", "SV",
                                *_sv_lines(est.dual_coef_[0],
                                           est.support_vectors_)]) + "\n")
        model = tio.load_model(path, n_features=6)
        assert model.task == ("svr" if name == "svr" else "oneclass")
        np.testing.assert_allclose(_dec(model, x), dec, rtol=1e-4,
                                   atol=1e-4)


def _models(blobs):
    """(tag, JAX model) of every task and kernel the writer supports."""
    x, y = blobs
    out = []
    for kind, extra in (("rbf", {}), ("linear", {}),
                        ("poly", dict(degree=2, coef0=1.0)),
                        ("sigmoid", dict(coef0=0.5, gamma=0.01))):
        from dpsvm_tpu.api import fit as jfit
        out.append((f"svc-{kind}", jfit(x, y, JConfig(c=2.0, kernel=kind,
                                                      **extra))[0]))
    rng = np.random.default_rng(1)
    yr = (x[:, 0] + 0.2 * rng.normal(size=len(y))).astype(np.float32)
    out.append(("svr", jsvr.train_svr(x, yr, JConfig(c=2.0))[0]))
    out.append(("oneclass", joc.train_oneclass(x, 0.2)[0]))
    out.append(("nusvc", jnu.train_nusvc(x, y, 0.3)[0]))
    k = (x @ x.T).astype(np.float32)
    out.append(("precomputed", jfit(k, y, JConfig(kernel="precomputed"))[0]))
    return out


def _port_model(m):
    return model_from_numpy(m.x_sv, m.alpha, m.y_sv, m.b, m.gamma,
                            m.kernel, m.coef0, m.degree, m.sv_idx,
                            m.n_train, m.n_train_exact, m.task)


def test_files_cross_both_ways_byte_for_byte(blobs, tmp_path):
    x, _ = blobs
    for tag, jm in _models(blobs):
        tm = _port_model(jm)
        pj, pt = str(tmp_path / f"{tag}.j"), str(tmp_path / f"{tag}.t")
        assert jlib.save_libsvm_model(jm, pj) == tlib.save_libsvm_model(tm,
                                                                        pt)
        with open(pj, "rb") as a, open(pt, "rb") as b:
            assert a.read() == b.read(), tag
        width = None if tag == "precomputed" else x.shape[1]
        # the JAX file in the port, the port's file in JAX
        got = tio.load_model(pj, n_features=width)
        want = jlib.load_libsvm_model(pt, n_features=width)
        assert got.task == want.task and got.kernel == want.kernel
        for field in ("alpha", "y_sv", "x_sv"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert (got.b, got.gamma, got.coef0, got.degree) == (
            want.b, want.gamma, want.coef0, want.degree)
        if tag != "precomputed":
            back = tio.load_model(pt, n_features=width)
            np.testing.assert_allclose(_dec(back, x), _dec(tm, x),
                                       rtol=1e-5, atol=1e-5)


def test_sparse_sv_lines_are_the_jax_text(tmp_path):
    """Zero features (+0 and -0) are left out of an SV line, and every
    other value is written as the JAX writer writes it."""
    from dpsvm_tpu.models.svm import SVMModel as JModel
    x = np.array([[0.0, 1.5, -0.0, 1e-30], [3.25, 0.0, 0.0, -2.0 / 3.0]],
                 np.float32)
    fields = dict(x_sv=x, alpha=np.array([0.1, 0.7], np.float32),
                  y_sv=np.array([-1, 1], np.int32), b=0.125, gamma=0.5)
    pj, pt = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    jlib.save_libsvm_model(JModel(**fields), pj)
    tlib.save_libsvm_model(model_from_numpy(**fields), pt)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        text = b.read()
        assert a.read() == text
    assert b" 2:1.5 4:1e-30\n" in text and b" 4:-0.666666687\n" in text


def test_port_trained_models_round_trip(blobs, tmp_path):
    x, y = blobs
    model, _ = fit(x, y, SVMConfig(c=4.0, gamma=0.25), device="cpu")
    path = str(tmp_path / "rt.model")
    assert tlib.save_libsvm_model(model, path) == model.n_sv
    back = tio.load_model(path, n_features=x.shape[1])
    np.testing.assert_allclose(_dec(back, x), _dec(model, x), rtol=1e-5,
                               atol=1e-5)
    assert back.n_sv == model.n_sv


BAD = [
    "svm_type c_svc\nkernel_type rbf\n",
    "svm_type c_svc\nkernel_type rbf\nnr_class 3\nrho 0 0 0\nSV\n1.0 1:1\n",
    "svm_type c_svc\nkernel_type foo\nSV\n1.0 1:1\n",
    "svm_type c_svc\nkernel_type precomputed\nSV\n1.0 1:1\n",
    "svm_type c_svc\nkernel_type rbf\nlabel 0 1\nSV\n1.0 1:1\n",
    "svm_type nu_svr_x\nkernel_type rbf\nSV\n1.0 1:1\n",
    "svm_type one_class\nkernel_type rbf\nSV\n-1.0 1:1\n",
    "svm_type c_svc\nkernel_type rbf\nSV\n1.0 0:1\n",
]


@pytest.mark.parametrize("text", BAD, ids=range(len(BAD)))
def test_refusals_match_jax(tmp_path, text):
    p = tmp_path / "bad.model"
    p.write_text(text)
    msgs = []
    for load in (jlib.load_libsvm_model, tlib.load_libsvm_model):
        with pytest.raises(ValueError) as e:
            load(str(p))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_n_features_widening(tmp_path):
    p = tmp_path / "w.model"
    p.write_text("svm_type c_svc\nkernel_type rbf\ngamma 0.5\n"
                 "nr_class 2\ntotal_sv 2\nrho 0\nlabel 1 -1\n"
                 "nr_sv 1 1\nSV\n1.0 1:1 2:2\n-1.0 1:3\n")
    assert tio.load_model(str(p)).x_sv.shape == (2, 2)
    m8 = tio.load_model(str(p), n_features=8)
    assert m8.x_sv.shape == (2, 8) and (m8.x_sv[:, 2:] == 0).all()


def test_precomputed_without_sv_idx_refused_as_jax(tmp_path):
    from dpsvm_tpu.models.svm import SVMModel as JModel

    fields = dict(x_sv=np.zeros((1, 0), np.float32),
                  alpha=np.ones(1, np.float32), y_sv=np.ones(1, np.int32),
                  b=0.0, gamma=0.5, kernel="precomputed")
    msgs = []
    for save, model in ((jlib.save_libsvm_model, JModel(**fields)),
                        (tlib.save_libsvm_model, model_from_numpy(**fields))):
        with pytest.raises(ValueError) as e:
            save(model, str(tmp_path / "x.model"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert not (tmp_path / "x.model").exists()


def _csv(tmp_path, n=80, d=5, seed=2):
    x, y = make_blobs(n=n, d=d, seed=seed)
    path = str(tmp_path / "d.csv")
    save_csv(path, x, y)
    return path


def test_cli_train_libsvm_format_then_test(tmp_path, capsys):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain

    csv = _csv(tmp_path)
    model = str(tmp_path / "m.model")
    assert tmain(["train", "-f", csv, "-m", model, "--model-format",
                  "libsvm", "-q", "--device", "cpu"]) == 0
    assert open(model).readline().startswith("svm_type c_svc")
    capsys.readouterr()
    assert tmain(["test", "-f", csv, "-m", model, "--device", "cpu"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jmain(["test", "-f", csv, "-m", model]) == 0
    jax_out = capsys.readouterr().out.splitlines()
    assert port[:2] == jax_out[:2]          # SVs and accuracy


def test_cli_width_reconciliation(tmp_path):
    """libsvm data wider than a sparse .model widens the model; narrower
    data pads up; a dense CSV of another width is an error."""
    from dpsvm_tpu_torch.cli import main as tmain

    model = tmp_path / "m.model"
    model.write_text(
        "svm_type c_svc\nkernel_type rbf\ngamma 0.5\nnr_class 2\n"
        "total_sv 2\nrho 0\nlabel 1 -1\nnr_sv 1 1\nSV\n"
        "1.0 1:1\n-1.0 2:1\n")
    wide = tmp_path / "wide.libsvm"
    wide.write_text("+1 1:1 3:0.5\n-1 2:1\n")
    assert tmain(["test", "-f", str(wide), "-m", str(model),
                  "--device", "cpu"]) == 0
    narrow = tmp_path / "narrow.libsvm"
    narrow.write_text("+1 1:1\n")
    assert tmain(["test", "-f", str(narrow), "-m", str(model),
                  "--device", "cpu"]) == 0
    dense = tmp_path / "d.csv"
    dense.write_text("1,1,0,0\n-1,0,1,0\n")
    ref = tmp_path / "ref.svm"
    ref.write_text("0.5\n0\n1,1,1,0\n1,-1,0,1\n")
    assert tmain(["test", "-f", str(dense), "-m", str(ref),
                  "--device", "cpu"]) == 2
