"""The port's k-fold cross-validation (``models/cv.py``) on the CPU,
against the JAX package's.

Bars, and why:

* ``kfold_assignment``: exactly the JAX function's (the same numpy copy,
  so the same seed gives the same folds);
* pooled accuracy against JAX, sequential and batched, binary and
  multi-class: within one example a fold (k / n). Each fold's model is a
  converged SMO fit, and the two packages' fits may part at a near-tie
  (ROADMAP Queue 3);
* the CV C (x gamma) sweep: each grid point's accuracy within one example
  a fold of JAX's and of the port's own per-point ``cross_validate``;
* guards and messages: JAX's, word for word; ``task="svr"`` against the
  JAX package's regression CV (predictions within 5e-3).
"""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.models import cv as jcv
from dpsvm_tpu_torch import SVMConfig
from dpsvm_tpu_torch.data.synthetic import make_blobs
from dpsvm_tpu_torch.models import cv as tcv
from tests.test_multiclass import make_three_class

KW = dict(c=1.0, gamma=0.25, epsilon=1e-3, max_iter=20_000, chunk_iters=64)


def _binary():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(240, 8)).astype(np.float32)
    y = (x[:, :2].sum(axis=1) + 0.3 * rng.normal(size=240) > 0).astype(
        np.int32)
    return x, y


def _three():
    return make_three_class(n_per=60, d=4, seed=13)


@pytest.mark.parametrize("k,seed,stratify", [(2, 0, True), (5, 3, True),
                                             (4, 7, False), (10, 1, True)])
def test_kfold_assignment_is_jax_bit_for_bit(k, seed, stratify):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4, size=97)
    np.testing.assert_array_equal(
        tcv.kfold_assignment(y, k, seed, stratify=stratify),
        jcv.kfold_assignment(y, k, seed, stratify=stratify))


@pytest.mark.parametrize("k", [1, 98])
def test_kfold_bad_k_matches_jax(k):
    msgs = []
    for mod in (jcv, tcv):
        with pytest.raises(ValueError) as e:
            mod.kfold_assignment(np.zeros(97), k)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _both(x, y, k, batched=False, seed=3, **kw):
    cfg = dict(KW, **kw.pop("cfg", {}))
    rj = jcv.cross_validate(x, y, k, JConfig(**cfg), seed=seed,
                            batched=batched, **kw)
    rt = tcv.cross_validate(x, y, k, SVMConfig(**cfg), seed=seed,
                            batched=batched, device="cpu", **kw)
    np.testing.assert_array_equal(rt["folds"], rj["folds"])
    assert rt["k"] == k and rt["predictions"].dtype == rj[
        "predictions"].dtype
    assert abs(rt["accuracy"] - rj["accuracy"]) <= k / len(y) + 1e-9
    return rj, rt


@pytest.mark.parametrize("data", ["binary", "three"])
@pytest.mark.parametrize("batched", [False, True])
def test_cross_validate_matches_jax(data, batched):
    x, y = _binary() if data == "binary" else _three()
    _, rt = _both(x, y, 5 if data == "binary" else 4, batched=batched)
    assert rt["accuracy"] > 0.85


@pytest.mark.parametrize("data", ["binary", "three"])
def test_batched_cv_matches_sequential(data):
    x, y = _binary() if data == "binary" else _three()
    seq = tcv.cross_validate(x, y, 4, SVMConfig(**KW), seed=1, device="cpu")
    bat = tcv.cross_validate(x, y, 4, SVMConfig(**KW), seed=1, device="cpu",
                             batched=True)
    np.testing.assert_array_equal(bat["folds"], seq["folds"])
    assert abs(bat["accuracy"] - seq["accuracy"]) <= 4 / len(y) + 1e-9


def test_cv_class_weight_matches_jax():
    x, y = _binary()
    _both(x, y, 4, class_weight={1: 2.0, 0: 0.5},
          cfg=dict(clip="pairwise"))
    x, y = _three()
    _both(x, y, 3, class_weight={3: 2.0}, cfg=dict(clip="pairwise"))


def test_cv_precomputed_matches_jax():
    x, y = _binary()
    d = ((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    k = np.exp(-0.25 * d).astype(np.float32)
    _both(k, y, 4, cfg=dict(kernel="precomputed"))


def test_cv_c_sweep_matches_jax_and_per_point_cv():
    x, y = _binary()
    cs = [0.1, 1.0, 10.0]
    cfg = dict(KW, gamma=0.125)
    rj = jcv.cross_validate_c_sweep(x, y, 4, cs, JConfig(**cfg), seed=2)
    rt = tcv.cross_validate_c_sweep(x, y, 4, cs, SVMConfig(**cfg), seed=2,
                                    device="cpu")
    np.testing.assert_array_equal(rt["folds"], rj["folds"])
    assert rt["cs"] == cs and rt["best_c"] in cs
    np.testing.assert_allclose(rt["accuracies"], rj["accuracies"],
                               atol=4 / len(y) + 1e-9)
    j = int(np.argmax(rt["accuracies"]))
    assert rt["best_accuracy"] == rt["accuracies"][j]
    for i, c in enumerate(cs):
        r = tcv.cross_validate(x, y, 4, SVMConfig(**dict(cfg, c=c)), seed=2,
                               device="cpu")
        assert abs(rt["accuracies"][i] - r["accuracy"]) <= 4 / len(y) + 1e-9


def test_cv_grid_sweep_matches_jax():
    x, y = _binary()
    rj = jcv.cross_validate_c_sweep(x, y, 4, [0.5, 5.0], JConfig(**KW),
                                    seed=7, gammas=[0.05, 0.5])
    rt = tcv.cross_validate_c_sweep(x, y, 4, [0.5, 5.0], SVMConfig(**KW),
                                    seed=7, gammas=[0.05, 0.5],
                                    device="cpu")
    assert rt["accuracies"].shape == (2, 2)
    np.testing.assert_allclose(rt["accuracies"], rj["accuracies"],
                               atol=4 / len(y) + 1e-9)
    i = rt["cs"].index(rt["best_c"])
    jj = rt["gammas"].index(rt["best_gamma"])
    assert rt["best_accuracy"] == rt["accuracies"][i, jj]


def test_svr_is_not_ported_yet():
    """``task="svr"`` is ported now (``models/svr.py``; the fuller checks
    are in tests/test_torch_svr.py): the same unstratified folds and
    pooled metrics as the JAX package on this input."""
    x, y = make_blobs(n=60, d=3, seed=0)
    y = y.astype(np.float32)
    rj = jcv.cross_validate(x, y, 3, JConfig(**KW), task="svr")
    rt = tcv.cross_validate(x, y, 3, SVMConfig(**KW), task="svr",
                            device="cpu")
    np.testing.assert_array_equal(rt["folds"], rj["folds"])
    assert np.abs(rt["predictions"] - rj["predictions"]).max() <= 5e-3
    assert abs(rt["mse"] - rj["mse"]) <= 1e-3


GUARDS = {
    "svr batched": (dict(task="svr", batched=True), {}),
    "svr weights": (dict(task="svr", class_weight={1: 2.0}), {}),
    "task": (dict(task="rank"), {}),
    "checkpoint": ({}, dict(checkpoint_path="s.npz")),
    "batched guard": (dict(batched=True), dict(selection="second-order")),
    "weights batched": (dict(class_weight={1: 2.0}, batched=True), {}),
    "balanced": (dict(class_weight="balanced"), {}),
    "precomputed batched": (dict(batched=True), dict(kernel="precomputed")),
}


@pytest.mark.parametrize("case", GUARDS)
def test_guards_match_jax(case):
    kw, cfg = GUARDS[case]
    x, y = make_blobs(n=60, d=3, seed=0)
    if cfg.get("kernel") == "precomputed":
        x = (x @ x.T).astype(np.float32)
    msgs = []
    for mod, C in ((jcv, JConfig), (tcv, SVMConfig)):
        with pytest.raises(ValueError) as e:
            mod.cross_validate(x, y, 3, C(**dict(KW, **cfg)), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_single_class_folds_and_sweep_guards_match_jax():
    x, y = make_blobs(n=40, d=3, seed=0)
    y = np.where(np.arange(40) < 1, -1, 1)       # one member of a class
    xc, yc = _three()
    calls = [
        lambda m, C: m.cross_validate(x, y, 3, C(**KW)),
        lambda m, C: m.cross_validate(x, y, 3, C(**KW), batched=True),
        lambda m, C: m.cross_validate_c_sweep(x, y, 3, [1.0], C(**KW)),
        lambda m, C: m.cross_validate_c_sweep(xc, yc, 3, [1.0], C(**KW)),
        lambda m, C: m.cross_validate_c_sweep(
            x, np.where(np.arange(40) < 20, -1, 1), 3, [], C(**KW)),
        lambda m, C: m.cross_validate_c_sweep(
            x, y, 3, [1.0], C(**dict(KW, checkpoint_path="s.npz"))),
    ]
    for call in calls:
        msgs = []
        for mod, C in ((jcv, JConfig), (tcv, SVMConfig)):
            with pytest.raises(ValueError) as e:
                call(mod, C)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_cli_cv_and_sweep(tmp_path, capsys):
    from dpsvm_tpu_torch import cli as tcli
    from dpsvm_tpu_torch.data.synthetic import save_csv
    x, y = _binary()
    f = str(tmp_path / "b.csv")
    save_csv(f, x, np.where(y > 0, 1, -1))
    assert tcli.main(["train", "-f", f, "-v", "4", "-g", "0.125", "-q",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Cross Validation Accuracy = ")
    assert tcli.main(["train", "-f", f, "-v", "4", "--batched", "-q",
                      "--device", "cpu"]) == 0
    assert "Cross Validation Accuracy" in capsys.readouterr().out
    assert tcli.main(["train", "-f", f, "-v", "3", "--c-sweep", "0.5,5",
                      "--gamma-sweep", "0.05,0.5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("Cross Validation Accuracy") == 4 and "Best: C=" in out
    assert tcli.main(["train", "-f", f, "-v", "3", "--c-sweep", "x",
                      "--device", "cpu"]) == 2
    assert "comma lists" in capsys.readouterr().err


def test_cv_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    x, y = _binary()
    for call in (lambda: tcv.cross_validate(x, y, 3, SVMConfig(**KW)),
                 lambda: tcv.cross_validate_c_sweep(x, y, 3, [1.0],
                                                    SVMConfig(**KW))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cv_sweep_is_the_per_fold_batch():
    """One (fold, C) column of the sweep's batch is a batched CV at that
    C: the same accuracy, bit for bit on the same device."""
    x, y = _binary()
    sweep = tcv.cross_validate_c_sweep(x, y, 3, [2.0], SVMConfig(**KW),
                                       seed=5, device="cpu")
    cv = tcv.cross_validate(x, y, 3, SVMConfig(**dict(KW, c=2.0)), seed=5,
                            batched=True, device="cpu")
    assert sweep["accuracies"][0] == cv["accuracy"]
