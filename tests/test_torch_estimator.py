"""The port's sklearn-protocol estimators (``models/estimator.py``) on the
CPU, against the JAX package's.

Bars, and why:

* ``get_params``/``set_params``: the JAX estimators' parameters and
  defaults, plus ``device``;
* fit/predict/score/predict_proba against the JAX estimator at the same
  parameters: the same classes and predictions, decision values within
  5e-3 (the bar between converged fits of the two packages), accuracy and
  R^2 within one example / 1e-3, probabilities within 1e-3;
* sklearn's ``clone`` and ``cross_val_score`` accept the estimators;
* refusals: an unknown ``solver`` raises the config's ValueError (the
  approx solvers themselves are held in tests/test_torch_approx.py),
  ``shards > 1`` raises as
  ``api.train`` does.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from dpsvm_tpu.data.synthetic import make_blobs, make_xor
from dpsvm_tpu.models import estimator as jest
from dpsvm_tpu_torch.models import estimator as test_
from torch_threads import one_thread  # noqa: F401

CPU = dict(device="cpu")


def _near(a, b, tol=5e-3):
    assert np.abs(np.asarray(a) - np.asarray(b)).max() <= tol


@pytest.mark.parametrize("cls", ["DPSVMClassifier", "DPSVMRegressor"])
def test_params_are_jax_plus_device(cls):
    j, t = getattr(jest, cls)(), getattr(test_, cls)()
    pj, pt = j.get_params(), t.get_params()
    assert pt.pop("device") is None and pt == pj
    t.set_params(C=2.0, selection="second-order", device="cpu")
    assert (t.C, t.selection, t.device) == (2.0, "second-order", "cpu")
    with pytest.raises(ValueError, match="invalid parameter"):
        t.set_params(nope=1)


def test_binary_arbitrary_labels_match_jax():
    x, y = make_blobs(n=200, d=4, seed=0)
    y73 = np.where(y > 0, 7, 3)
    j = jest.DPSVMClassifier(C=1.0, gamma=0.5).fit(x, y73)
    t = test_.DPSVMClassifier(C=1.0, gamma=0.5, **CPU).fit(x, y73)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    assert t.converged_ and set(np.unique(t.predict(x))) <= {3, 7}
    np.testing.assert_array_equal(t.predict(x), j.predict(x))
    _near(t.decision_function(x), j.decision_function(x))
    np.testing.assert_array_equal(t.n_support_, j.n_support_)
    assert abs(t.score(x, y73) - j.score(x, y73)) <= 1 / len(y)
    _near(t.intercept_, j.intercept_)
    dec = t.decision_function(x)
    np.testing.assert_array_equal(t.predict(x), np.where(dec < 0, 3, 7))


@pytest.mark.parametrize("probability", [True, "cv"])
def test_predict_proba_matches_jax(probability):
    x, y = make_blobs(n=150, d=3, seed=2)
    j = jest.DPSVMClassifier(probability=probability).fit(x, y)
    t = test_.DPSVMClassifier(probability=probability, **CPU).fit(x, y)
    p = t.predict_proba(x)
    assert p.shape == (150, 2)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-12)
    _near(p, j.predict_proba(x), 1e-3)


def test_predict_proba_requires_probability_flag():
    x, y = make_blobs(n=120, d=3, seed=1)
    t = test_.DPSVMClassifier(**CPU).fit(x, y)
    with pytest.raises(RuntimeError, match="probability=True"):
        t.predict_proba(x)


def test_multiclass_dispatch_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(90, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=90)
    x += 1.5 * y[:, None].astype(np.float32)
    kw = dict(C=1.0, gamma=0.5, probability=True)
    j = jest.DPSVMClassifier(**kw).fit(x, y)
    t = test_.DPSVMClassifier(**kw, **CPU).fit(x, y)
    assert len(t.classes_) == 3 and t.score(x, y) > 0.9
    assert np.mean(t.predict(x) == j.predict(x)) >= 1 - 1 / len(y)
    _near(t.predict_proba(x), j.predict_proba(x), 1e-2)
    with pytest.raises(ValueError, match="binary-only"):
        t.decision_function(x)


def test_class_weight_matches_jax():
    x, y = make_blobs(n=160, d=4, seed=6)
    kw = dict(C=2.0, gamma=0.5, class_weight={-1: 3.0})
    j = jest.DPSVMClassifier(**kw).fit(x, y)
    t = test_.DPSVMClassifier(**kw, **CPU).fit(x, y)
    _near(t.decision_function(x), j.decision_function(x))


def test_regressor_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 5)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.5 * x[:, 1]).astype(np.float32)
    kw = dict(C=10.0, epsilon=0.05, max_iter=20000)
    j = jest.DPSVMRegressor(**kw).fit(x, y)
    t = test_.DPSVMRegressor(**kw, **CPU).fit(x, y)
    assert t.converged_ and t.score(x, y) > 0.99
    assert abs(t.score(x, y) - j.score(x, y)) <= 1e-3
    _near(t.predict(x), j.predict(x))
    assert t.predict(x[:7]).shape == (7,)
    assert abs(int(t.n_support_[0]) - int(j.n_support_[0])) <= 3


def test_unfitted_raises():
    for est in (test_.DPSVMClassifier(**CPU), test_.DPSVMRegressor(**CPU)):
        with pytest.raises(RuntimeError, match="not fitted"):
            est.predict(np.zeros((2, 2), np.float32))


def test_sklearn_interop_clone_and_cv():
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    from sklearn.model_selection import cross_val_score

    x, y = make_xor(n=200, seed=3)
    clf = test_.DPSVMClassifier(C=10.0, gamma=1.0, **CPU)
    c2 = clone(clf)
    assert c2.get_params() == clf.get_params()
    scores = cross_val_score(clf, x, y, cv=3)
    jscores = cross_val_score(jest.DPSVMClassifier(C=10.0, gamma=1.0), x, y,
                              cv=3)
    assert scores.mean() > 0.9
    np.testing.assert_allclose(scores, jscores, atol=3 / len(y))
    rng = np.random.default_rng(1)
    xr = rng.normal(size=(90, 3)).astype(np.float32)
    yr = (xr[:, 0] - xr[:, 1]).astype(np.float32)
    rs = cross_val_score(test_.DPSVMRegressor(C=10.0, **CPU), xr, yr, cv=3)
    np.testing.assert_allclose(
        rs, cross_val_score(jest.DPSVMRegressor(C=10.0), xr, yr, cv=3),
        atol=1e-3)


def test_failed_refit_preserves_previous_fit():
    x1, y1 = make_blobs(n=100, d=3, seed=4)
    y17 = np.where(y1 > 0, 7, 3)
    clf = test_.DPSVMClassifier(probability=True, **CPU).fit(x1, y17)
    p_before = clf.predict_proba(x1)
    clf.set_params(C=-1.0)
    with pytest.raises(ValueError):
        clf.fit(x1, np.where(y1 > 0, 1, 0))
    assert set(clf.classes_) == {3, 7}
    np.testing.assert_array_equal(clf.predict_proba(x1), p_before)
    clf.set_params(C=1.0, probability=False)
    clf.fit(x1, y17)
    with pytest.raises(RuntimeError, match="probability=True"):
        clf.predict_proba(x1)


def test_solver_knobs_and_sparse_input():
    x, y = make_blobs(n=200, d=5, seed=3)
    for kw in (dict(working_set=16), dict(shrinking=True),
               dict(selection="second-order")):
        clf = test_.DPSVMClassifier(C=5.0, gamma=0.5, **kw, **CPU).fit(x, y)
        assert clf.score(x, y) >= 0.95
    clf = test_.DPSVMClassifier(C=2.0, max_iter=20_000, **CPU)
    clf.fit(sp.csr_matrix(x), y)
    np.testing.assert_array_equal(clf.predict(sp.csr_matrix(x)),
                                  clf.predict(x))
    np.testing.assert_allclose(clf.decision_function(sp.csr_matrix(x)),
                               clf.decision_function(x))


def test_refusals():
    x, y = make_blobs(n=60, d=3, seed=0)
    for est in (test_.DPSVMClassifier, test_.DPSVMRegressor):
        with pytest.raises(ValueError, match="solver must be one of"):
            est(solver="approx-rbf", **CPU).fit(x, y)
        with pytest.raises(RuntimeError, match="launch_local"):
            est(shards=2, **CPU).fit(x, y)
    with pytest.raises(ValueError, match="at least 2 classes"):
        test_.DPSVMClassifier(**CPU).fit(x, np.ones_like(y))


def test_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    x, y = make_blobs(n=40, d=3, seed=0)
    for est in (test_.DPSVMClassifier(), test_.DPSVMRegressor()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            est.fit(x, y)
