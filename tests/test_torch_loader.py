"""The port's libsvm input (``data/loader.py``) and scipy.sparse input on
the CPU, against the JAX package.

Bars: ``load_libsvm`` returns the same arrays as the JAX package's, bit for
bit, on generated files (the two parse each value with ``np.float32``),
and raises ``ValueError`` with the same message on every malformed file
(the non-finite cases compare the message up to its hint, which both
packages now end alike). scipy.sparse input
trains to the JAX package's model under the LibSVM bar (n_sv within 2% or
3, accuracy within one example), as ``tests/conftest.py`` holds it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from dpsvm_tpu.api import fit as jfit
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data import loader as jloader
from dpsvm_tpu.data.synthetic import make_planted, save_csv
from dpsvm_tpu.models.svm import evaluate as jevaluate
from dpsvm_tpu_torch import SVMConfig, evaluate, fit, train, warm_start
from dpsvm_tpu_torch.data import loader as tloader

ROOT = Path(__file__).resolve().parents[1]


def _write_libsvm(path, x, y, rng, comments=False, shuffle=False):
    """x as libsvm text: only the nonzeros, 1-based, each value as its
    float32 repr; optionally comment and blank lines and shuffled
    indices."""
    with open(path, "w") as fh:
        if comments:
            fh.write("# generated\n\n")
        for i in range(x.shape[0]):
            nz = np.flatnonzero(x[i])
            if shuffle:
                nz = rng.permutation(nz)
            toks = " ".join(f"{j + 1}:{repr(float(x[i, j]))}" for j in nz)
            fh.write(f"{int(y[i])} {toks}".rstrip() + "\n")
            if comments and i % 7 == 3:
                fh.write("   \n# a comment line\n")


def _sparse_rows(n, d, seed, density=0.3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) > density] = 0.0
    x[3] = 0.0                          # a label-only line
    y = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    return x, y, rng


@pytest.mark.parametrize("comments,shuffle", [(False, False), (True, True)])
def test_load_libsvm_matches_jax(tmp_path, comments, shuffle):
    x, y, rng = _sparse_rows(50, 9, seed=1)
    y[::5] = 3                          # multiclass labels load as ints
    path = str(tmp_path / "d.libsvm")
    _write_libsvm(path, x, y, rng, comments, shuffle)
    assert tloader.sniff_format(path) == jloader.sniff_format(path) == \
        "libsvm"
    for kw in ({}, dict(num_attributes=12), dict(num_attributes=5),
               dict(num_examples=20), dict(num_examples=50,
                                           num_attributes=9)):
        gx, gy = tloader.load_libsvm(path, **kw)
        wx, wy = jloader.load_libsvm(path, **kw)
        assert gx.dtype == wx.dtype == np.float32
        assert gy.dtype == wy.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    gx, gy = tloader.load_dataset(path)
    np.testing.assert_array_equal(gx, x)
    np.testing.assert_array_equal(gy, y)


def test_duplicate_indices_keep_the_last(tmp_path):
    path = str(tmp_path / "dup.libsvm")
    with open(path, "w") as fh:
        fh.write("1 2:1.5 2:-0.25 1:3\n-1 3:1e-3\n")
    gx, gy = tloader.load_libsvm(path)
    wx, wy = jloader.load_libsvm(path)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gx, np.array([[3, -0.25, 0], [0, 0, 1e-3]],
                                               np.float32))


BAD = {
    "bad-label": "1 1:0.5\nabc 2:1\n",
    "non-integer-label": "1 1:0.5\n1.5 2:1\n",
    "bad-token": "1 1:0.5\n-1 2=1\n",
    "bad-value": "1 1:0.5 2:x\n",
    "two-colons": "1 1:0.5:2\n",
    "zero-index": "1 0:0.5\n",
    "negative-index": "1 1:0.5\n-1 -2:1\n",
    "no-features": "1\n-1\n",
    "empty": "\n# only a comment\n",
    "nan": "1 1:0.5 2:nan\n",
    "inf": "1 1:0.5\n-1 3:-inf\n",
}
# the port's message ends early where the JAX one names an option the
# port does not have
TAIL = {"nan": " — rejected at load", "inf": " — rejected at load"}


@pytest.mark.parametrize("case", sorted(BAD))
def test_errors_match_jax(tmp_path, case):
    path = str(tmp_path / f"{case}.libsvm")
    with open(path, "w") as fh:
        fh.write(BAD[case])
    msgs = []
    for mod in (tloader, jloader):
        with pytest.raises(ValueError) as e:
            mod.load_libsvm(path)
        msgs.append(str(e.value))
    cut = TAIL.get(case)
    if cut:
        assert cut in msgs[0] and cut in msgs[1], msgs
        msgs = [m[:m.index(cut)] for m in msgs]
    assert msgs[0] == msgs[1]
    assert path in msgs[0]


@pytest.mark.parametrize("kw,what", [
    (dict(num_examples=5), "expected 5 rows, found 2"),
    (dict(num_examples=0), "empty dataset"),
    (dict(num_examples=4, num_attributes=3), "expected 4 rows, found 2"),
])
def test_shape_errors_match_jax(tmp_path, kw, what):
    path = str(tmp_path / "short.libsvm")
    with open(path, "w") as fh:
        fh.write("1 1:0.5\n-1 2:1\n")
    msgs = []
    for mod in (tloader, jloader):
        with pytest.raises(ValueError, match=what) as e:
            mod.load_libsvm(path, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(FileNotFoundError):
        tloader.load_libsvm(str(tmp_path / "missing.libsvm"))


def test_libsvm_and_csv_load_the_same_rows(tmp_path):
    x, y = make_planted(120, 30, 0.25, seed=3)
    csv, lib = str(tmp_path / "d.csv"), str(tmp_path / "d.libsvm")
    save_csv(csv, x, y)
    _write_libsvm(lib, x, y, np.random.default_rng(0))
    cx, cy = tloader.load_dataset(csv)
    lx, ly = tloader.load_dataset(lib)
    np.testing.assert_array_equal(cx, lx)
    np.testing.assert_array_equal(cy, ly)
    cfg = SVMConfig(c=10.0, gamma=0.25, max_iter=300)
    a = train(cx, cy, cfg, device="cpu")
    b = train(lx, ly, cfg, device="cpu")
    assert np.array_equal(a.alpha, b.alpha) and a.n_iter == b.n_iter


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "dpsvm_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_trains_and_tests_from_libsvm(tmp_path):
    x, y = make_planted(240, 30, 0.25, seed=4)
    tr, te = str(tmp_path / "tr.libsvm"), str(tmp_path / "te.libsvm")
    rng = np.random.default_rng(0)
    _write_libsvm(tr, x[:180], y[:180], rng)
    _write_libsvm(te, x[180:], y[180:], rng)
    model = str(tmp_path / "m.svm")
    out = _cli("train", "--device", "cpu", "-f", tr, "-m", model, "-c",
               "10", "-g", "0.25", "--shrinking", "-q")
    assert out.returncode == 0, out.stderr
    assert "Number of SVs:" in out.stdout
    out = _cli("test", "--device", "cpu", "-f", te, "-m", model)
    assert out.returncode == 0, out.stderr
    acc = float([ln for ln in out.stdout.splitlines()
                 if ln.startswith("Test accuracy:")][0].split()[-1])
    mj, _ = jfit(x[:180], y[:180], JConfig(c=10.0, gamma=0.25))
    assert abs(acc - jevaluate(mj, x[180:], y[180:])) <= 1 / 60 + 1e-9
    out = _cli("train", "--device", "cpu", "-f", tr, "-m", model,
               "--shrinking", "maybe")
    assert out.returncode == 2 and "--shrinking takes 0, 1 or auto" in \
        out.stderr


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_sparse_input_trains_as_jax(fmt):
    """A 60 x 5 problem given as scipy.sparse: densified as the JAX
    package densifies it, then trained by both."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(60, 5)).astype(np.float32)
    x[rng.random((60, 5)) < 0.4] = 0.0
    y = np.where(x[:, 0] + 0.5 * x[:, 1] > 0, 1, -1).astype(np.int32)
    xs = sp.csr_matrix(x).asformat(fmt)
    cfg = dict(c=1.0, gamma=0.5, epsilon=1e-3)
    model, res = fit(xs, y, SVMConfig(**cfg), device="cpu")
    jmodel, jres = jfit(xs, y, JConfig(**cfg))
    assert res.converged and jres.converged
    assert abs(res.n_sv - jres.n_sv) <= max(0.02 * jres.n_sv, 3)
    assert abs(evaluate(model, x, y, device="cpu")
               - jevaluate(jmodel, x, y)) <= 1 / 60 + 1e-9
    dense = train(x, y, SVMConfig(**cfg), device="cpu")
    assert np.array_equal(train(xs, y, SVMConfig(**cfg),
                                device="cpu").alpha, dense.alpha)
    assert warm_start(xs, y, dense.alpha, SVMConfig(**cfg),
                      device="cpu").converged


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
def test_float_labels_match_jax(tmp_path, fmt):
    """Regression targets: ``float_labels=True`` keeps them as float32, as
    the JAX parser does, through ``load_dataset`` for both formats."""
    rng = np.random.default_rng(4)
    x = np.round(rng.normal(size=(9, 4)), 3).astype(np.float32)
    y = rng.normal(size=9).astype(np.float32)
    path = str(tmp_path / f"reg.{fmt}")
    with open(path, "w") as fh:
        for xi, yi in zip(x, y):
            feats = (",".join(f"{v}" for v in xi) if fmt == "csv" else
                     " ".join(f"{j + 1}:{v}" for j, v in enumerate(xi)))
            fh.write(f"{float(yi)!r}{',' if fmt == 'csv' else ' '}{feats}\n")
    xt, yt = tloader.load_dataset(path, float_labels=True)
    xj, yj = jloader.load_dataset(path, float_labels=True)
    assert yt.dtype == yj.dtype == np.float32
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, y)
