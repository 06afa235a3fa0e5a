"""Inference, model files, data loading and generators of the PyTorch port
against the JAX package's, on the same inputs.

Tolerances: decision values within 1e-5 (both compute the same float32
(m, d) x (d, n_sv) product and RBF epilogue; only the summation order of
the matmul differs). Model files, CSV loads and generated data must be
equal exactly.
"""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data import loader as jloader
from dpsvm_tpu.data import synthetic as jsyn
from dpsvm_tpu.models import io as jio
from dpsvm_tpu.models import svm as jsvm
from dpsvm_tpu.solver.oracle import smo_reference
from dpsvm_tpu_torch.convert import model_from_numpy
from dpsvm_tpu_torch.data import loader as tloader
from dpsvm_tpu_torch.data import synthetic as tsyn
from dpsvm_tpu_torch.models import io as tio
from dpsvm_tpu_torch.models import svm as tsvm
from torch_threads import one_thread  # noqa: F401


def _jax_model():
    x, y = jsyn.make_blobs(n=160, d=9, seed=4)
    res = smo_reference(x, y, JConfig(c=2.0, gamma=0.2, epsilon=1e-3))
    return jsvm.SVMModel.from_train_result(x, y, res)


def _port(jm):
    return model_from_numpy(jm.x_sv, jm.alpha, jm.y_sv, jm.b, jm.gamma)


@pytest.mark.parametrize("batch", [None, 7, 8192])
@pytest.mark.parametrize("include_b", [True, False])
def test_decision_function_matches_jax(batch, include_b):
    jm = _jax_model()
    xt, _ = jsyn.make_blobs(n=53, d=9, seed=8)
    want = jsvm.decision_function(jm, xt, include_b=include_b)
    got = tsvm.decision_function(_port(jm), xt, include_b=include_b,
                                 batch_size=batch, device="cpu")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_predict_and_evaluate_match_jax():
    jm = _jax_model()
    xt, yt = jsyn.make_blobs(n=200, d=9, seed=9)
    pm = _port(jm)
    np.testing.assert_array_equal(tsvm.predict(pm, xt, device="cpu"),
                                  jsvm.predict(jm, xt))
    assert tsvm.evaluate(pm, xt, yt, device="cpu") == jsvm.evaluate(
        jm, xt, yt)


def _same_model(a, b):
    np.testing.assert_array_equal(a.x_sv, b.x_sv)
    np.testing.assert_array_equal(a.alpha, b.alpha)
    np.testing.assert_array_equal(a.y_sv, b.y_sv)
    assert np.float32(a.b) == np.float32(b.b)
    assert np.float32(a.gamma) == np.float32(b.gamma)


def test_model_file_jax_to_port(tmp_path):
    jm = _jax_model()
    path = str(tmp_path / "jax.svm")
    jio.save_model(jm, path)
    _same_model(tio.load_model(path), jm)


def test_model_file_port_to_jax(tmp_path):
    pm = _port(_jax_model())
    path = str(tmp_path / "port.svm")
    assert tio.save_model(pm, path) == pm.n_sv
    _same_model(jio.load_model(path), pm)
    _same_model(tio.load_model(path), pm)


def test_model_file_without_b_line(tmp_path):
    path = tmp_path / "seq.svm"
    path.write_text("0.5\n0.25,1,1.0,2.0\n0.75,-1,3.0,4.0\n")
    got = tio.load_model(str(path))
    want = jio.load_model(str(path))
    _same_model(got, want)
    assert got.b == 0.0


def test_extended_model_files_are_refused(tmp_path):
    """A zip file that is not an approx model (no format marker) is
    refused with the JAX package's ValueError; approx ``.npz`` models
    themselves load now (tests/test_torch_approx.py). The ``task`` line
    and LIBSVM ``.model`` files load, as in the JAX package (fuller checks
    in tests/test_torch_svr.py and tests/test_torch_libsvm_io.py)."""
    path = tmp_path / "svr.svm"
    path.write_text("kernel linear 1 0 3\ntask svr\n0.1\n0.5,1,1.0\n")
    got, want = tio.load_model(str(path)), jio.load_model(str(path))
    assert got.task == want.task == "svr"
    _same_model(got, want)
    path = tmp_path / "lib.model"
    path.write_text("svm_type c_svc\nkernel_type rbf\n")
    msgs = []
    for mod in (tio, jio):
        with pytest.raises(ValueError) as e:
            mod.load_model(str(path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "no 'SV' section" in msgs[0]
    path = tmp_path / "approx.npz"
    np.savez(path, w=np.zeros(3))
    msgs = []
    for mod in (tio, jio):
        with pytest.raises(ValueError) as e:
            mod.load_model(str(path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "format marker" in msgs[0]


def test_load_csv_matches_jax(tmp_path):
    x, y = jsyn.make_blobs(n=37, d=5, seed=2)
    path = str(tmp_path / "d.csv")
    jsyn.save_csv(path, x, y)
    xj, yj = jloader.load_csv(path)
    xt, yt = tloader.load_dataset(path)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    assert xt.dtype == np.float32 and yt.dtype == np.int32
    xs, ys = tloader.load_csv(path, num_examples=10, num_attributes=3)
    xjs, yjs = jloader.load_csv(path, num_examples=10, num_attributes=3)
    np.testing.assert_array_equal(xs, xjs)
    np.testing.assert_array_equal(ys, yjs)


@pytest.mark.parametrize("bad", ["nan", "inf", "-inf"])
def test_load_csv_rejects_nonfinite(tmp_path, bad):
    path = tmp_path / "bad.csv"
    path.write_text(f"1,0.5,0.25\n-1,0.1,{bad}\n")
    with pytest.raises(ValueError, match="row 1, column 1"):
        tloader.load_csv(str(path))


def test_load_csv_malformed_line_names_it(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("1,0.5,0.25\n-1,0.1,abc\n")
    with pytest.raises(ValueError, match=":2:"):
        tloader.load_csv(str(path))


def test_libsvm_input_not_ported_yet(tmp_path):
    """The libsvm format is ported now (``load_libsvm``, held against the
    JAX parser in tests/test_torch_loader.py), and so are shard
    directories (tests/test_torch_stream.py): a directory without a
    manifest is refused, naming what it lacks."""
    path = tmp_path / "d.libsvm"
    path.write_text("1 1:0.5 3:0.25\n")
    x, y = tloader.load_dataset(str(path))
    np.testing.assert_array_equal(x, np.array([[0.5, 0.0, 0.25]],
                                              np.float32))
    np.testing.assert_array_equal(y, np.array([1], np.int32))
    with pytest.raises(FileNotFoundError, match="not a shard dataset"):
        tloader.load_dataset(str(tmp_path))


@pytest.mark.parametrize("seed", [0, 5])
def test_generators_match_jax(seed):
    for a, b in ((jsyn.make_blobs(n=77, d=4, seed=seed),
                  tsyn.make_blobs(n=77, d=4, seed=seed)),
                 (jsyn.make_xor(n=60, seed=seed),
                  tsyn.make_xor(n=60, seed=seed)),
                 (jsyn.make_planted(300, 40, 0.25, seed=seed),
                  tsyn.make_planted(300, 40, 0.25, seed=seed))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
