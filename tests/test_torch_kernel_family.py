"""The LIBSVM kernel family of the port (``ops/kernels.py``), its packed
selection (``ops/selection.py``), and the models, files and decomposition
runs of every kernel kind, against the JAX package on the CPU.

Tolerances, from what the two sides compute:

* linear, poly and precomputed kernel values are equal bit for bit: the
  dots are given, ``gamma u.v + coef0`` is one fused multiply-add on both
  sides (XLA contracts it; ``addcmul`` computes it so) and ``** degree``
  is the same sequence of multiplications;
* rbf within 2 ulp and sigmoid within 4 ulp: XLA's exp and tanh on the CPU
  are its own approximations (measured: 1 and 4 ulp at most);
* packed selection equals ``masked_extrema`` bit for bit on finite scores;
* decision values within 1e-5 at float32 (the (m, n_sv) product sums in
  another order); model files byte for byte.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs, make_planted, make_xor
from dpsvm_tpu.models import io as jio
from dpsvm_tpu.models.svm import SVMModel as JModel
from dpsvm_tpu.models.svm import decision_function as jdec
from dpsvm_tpu.ops import kernels as jk
from dpsvm_tpu.ops import selection as jsel
from dpsvm_tpu.solver import decomp as jdecomp
from dpsvm_tpu_torch import SVMConfig, fit
from dpsvm_tpu_torch.convert import model_from_numpy
from dpsvm_tpu_torch.models import io as tio
from dpsvm_tpu_torch.models.svm import decision_function as tdec
from dpsvm_tpu_torch.ops import kernels as tk
from dpsvm_tpu_torch.ops import selection as tsel
from dpsvm_tpu_torch.solver.decomp import train_single_device_decomp
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")

SPECS = [("linear", 0.1, 0.0, 3), ("rbf", 0.25, 0.0, 3),
         ("sigmoid", 0.05, 0.3, 3), ("sigmoid", 1 / 784, 0.0, 3)] + [
    ("poly", g, c0, deg) for deg, g, c0 in (
        (1, 0.13, 0.5), (2, 0.13, -0.5), (3, 0.37, -0.7), (4, 0.1, 1.3),
        (5, 0.21, 0.25))]
ULPS = {"linear": 0, "poly": 0, "precomputed": 0, "rbf": 2, "sigmoid": 4}


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _spec_id(s):
    return f"{s[0]}-d{s[3]}-r{s[2]}"


@pytest.mark.parametrize("spec", SPECS, ids=_spec_id)
def test_rows_and_diagonal_match_jax(spec):
    rng = np.random.default_rng(0)
    dots = rng.normal(0, 3, (3, 1001)).astype(np.float32)
    w2 = np.abs(rng.normal(0, 3, 3)).astype(np.float32)
    x2 = np.abs(rng.normal(0, 3, 1001)).astype(np.float32)
    js, ts = jk.KernelSpec(*spec), tk.KernelSpec(*spec)
    want = jax.jit(lambda d, w, x: jk.rows_from_dots(d, w, x, js))(
        dots, w2, x2)
    got = tk.rows_from_dots(torch.from_numpy(dots.copy()),
                            torch.from_numpy(w2), torch.from_numpy(x2), ts)
    assert _ulps(got.numpy(), want) <= ULPS[spec[0]]
    want = jax.jit(lambda x: jk.kdiag_from_norms(x, js))(x2)
    got = tk.kdiag_from_norms(torch.from_numpy(x2), ts)
    assert _ulps(got.numpy(), want) <= ULPS[spec[0]]


@pytest.mark.parametrize("degree", range(1, 9))
def test_integer_pow_is_lax_integer_pow(degree):
    v = np.random.default_rng(degree).normal(0, 1.5, 4097).astype(np.float32)
    want = jax.jit(lambda a: jax.lax.integer_pow(a, degree))(v)
    got = tk.integer_pow(torch.from_numpy(v), degree)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["linear", "poly", "rbf", "sigmoid",
                                  "precomputed"])
def test_kernel_rows_and_row_stats_match_jax(kind):
    x, _ = make_blobs(n=70, d=9, seed=4)
    if kind == "precomputed":
        x = (x @ x.T).astype(np.float32)             # a PSD K
    spec = (kind, 0.2, 0.5, 2)
    js, ts = jk.KernelSpec(*spec), tk.KernelSpec(*spec)
    x2_j = jk.host_row_stats(x, js)
    x2_t = tk.host_row_stats(x, ts)
    assert np.array_equal(x2_t, x2_j) and x2_t.dtype == np.float32
    if kind == "precomputed":
        assert np.array_equal(x2_t, np.diagonal(x))
    rows = x[[3, 40, 69]]
    want = jax.jit(lambda r, w, a, b: jk.kernel_rows(r, w, a, b, js))(
        rows, x2_j[[3, 40, 69]], x, x2_j)
    got = tk.kernel_rows(torch.from_numpy(rows),
                         torch.from_numpy(x2_t[[3, 40, 69]]),
                         torch.from_numpy(x), torch.from_numpy(x2_t), ts)
    # the dots themselves are two float32 sums of 9 products
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_kernel_spec_and_config():
    assert tk.KernelSpec.coerce(0.5) == tk.KernelSpec("rbf", 0.5)
    spec = tk.KernelSpec("poly", 0.1, 1.0, 2)
    assert tk.KernelSpec.coerce(spec) is spec and not spec.is_rbf
    for kw in (dict(), dict(kernel="poly", degree=5, coef0=-1.0),
               dict(kernel="sigmoid", gamma=0.3)):
        assert tuple(SVMConfig(**kw).kernel_spec(7)) == tuple(
            JConfig(**kw).kernel_spec(7))
    y = np.array([1, -1, 1])
    for kw in (dict(c=3.0), dict(c=3.0, weight_pos=0.3, weight_neg=7.0)):
        want = np.asarray(JConfig(**kw).box_bound(y))
        got = np.asarray(SVMConfig(**kw).box_bound(y))
        assert np.array_equal(got, want) and got.dtype == want.dtype


def _selection_case(case, n=257, seed=0):
    """(alpha, y, f, c, valid): ties within and across the scores, the
    sentinels, alpha exactly at 0 and at C, -0.0 beside 0.0."""
    rng = np.random.default_rng(seed)
    y = rng.choice([-1.0, 1.0], n).astype(np.float32)
    c = 2.0
    alpha = rng.choice([0.0, c, 0.7], n).astype(np.float32)
    f = rng.choice([-1.0, -0.0, 0.0, 1.0, 2.5], n).astype(np.float32)
    valid = None
    if case == "weighted":
        c = np.where(y > 0, np.float32(4.0), np.float32(0.5))
        alpha = np.where(rng.random(n) < 0.4, c, alpha).astype(np.float32)
        alpha = np.minimum(alpha, c).astype(np.float32)
    elif case == "valid":
        valid = rng.random(n) < 0.6
    elif case == "one-side-empty":
        y[:] = 1.0
        alpha[:] = c                      # I_up empty: sentinels only
    elif case == "random":
        f = rng.normal(size=n).astype(np.float32)
    return alpha, y, f, c, valid


@pytest.mark.parametrize("case", ["ties", "weighted", "valid",
                                  "one-side-empty", "random"])
def test_packed_selection_is_masked_extrema(case):
    alpha, y, f, c, valid = _selection_case(case)
    jargs = [jnp.asarray(v) for v in (alpha, y, f)] + [
        c if np.isscalar(c) else jnp.asarray(c),
        None if valid is None else jnp.asarray(valid)]
    targs = [torch.from_numpy(v) for v in (alpha, y, f)] + [
        c if np.isscalar(c) else torch.from_numpy(c),
        None if valid is None else torch.from_numpy(valid)]
    want = jsel.masked_extrema_packed(*jargs)
    for got in (tsel.masked_extrema_packed(*targs),
                tsel.masked_extrema(*targs)):
        assert int(got[0]) == int(want[0]) and int(got[2]) == int(want[2])
        for g, w in ((got[1], want[1]), (got[3], want[3])):
            assert np.asarray(g.numpy(), np.float32).tobytes() == \
                np.asarray(w, np.float32).tobytes()


def test_sided_scores_are_the_masked_scores():
    """``box_sides`` + ``sided_scores`` (the general pair's four-operation
    selection) give ``masked_scores_and_masks``'s sets, NaN alpha
    included."""
    for case in ("ties", "weighted", "random"):
        alpha, y, f, c, _ = _selection_case(case, seed=3)
        alpha[5] = np.nan
        a, yt, ft = (torch.from_numpy(v) for v in (alpha, y, f))
        ct = c if np.isscalar(c) else torch.from_numpy(c)
        f_up, f_low, _, in_low = tsel.masked_scores_and_masks(a, yt, ft, ct)
        s_up, s_low, s_in_low = tsel.sided_scores(a, ft,
                                                  *tsel.box_sides(yt, ct))
        assert torch.equal(s_up, f_up) and torch.equal(s_low, f_low)
        assert torch.equal(s_in_low, in_low)


def test_packed_nan_never_wins_unless_all_nan():
    f = torch.tensor([1.0, float("nan"), -3.0, 5.0])
    y = torch.tensor([1.0, 1.0, 1.0, -1.0])
    a = torch.zeros(4)
    i_hi, b_hi, i_lo, b_lo = tsel.masked_extrema_packed(a, y, f, 1.0)
    assert (int(i_hi), float(b_hi), int(i_lo), float(b_lo)) == (2, -3.0,
                                                                 3, 5.0)
    # argminmax lets the NaN win, as jnp.argmin does
    assert int(tsel.masked_extrema(a, y, f, 1.0)[0]) == 1


# ---------------------------------------------------------------- models

def _kind_problem(kind):
    """(x_train, y_train, x_test, config kwargs) for each kind, planted
    150 + 40 rows of width 40; x is K for precomputed (the RBF matrix at
    gamma 0.25; test rows: K(test, train))."""
    x, y = make_planted(190, 40, 0.25, seed=2)
    xtr, ytr, xte = x[:150], y[:150], x[150:]
    kw = {"linear": dict(kernel="linear", c=1.0),
          "poly": dict(kernel="poly", degree=3, coef0=1.0, gamma=1 / 40,
                       c=1.0),
          "rbf": dict(kernel="rbf", gamma=0.25, c=1.0),
          "sigmoid": dict(kernel="sigmoid", gamma=0.5 / 40, coef0=-1.0,
                          c=1.0),
          "precomputed": dict(kernel="precomputed", c=1.0)}[kind]
    if kind == "precomputed":
        xte, xtr = _rbf_matrix(xte, xtr), _rbf_matrix(xtr, xtr)
    return xtr, ytr, xte, kw


def _rbf_matrix(a, b, gamma=0.25):
    d2 = ((a[:, None, :].astype(np.float64) - b[None]) ** 2).sum(-1)
    return np.exp(-gamma * d2).astype(np.float32)


def _true_gap(x, y, alpha, kw):
    """The first-order optimality gap recomputed from scratch with a
    float64 kernel matrix of the kind."""
    xf, yf, a = (np.asarray(v, np.float64) for v in (x, y, alpha))
    kind, c = kw["kernel"], kw["c"]
    g, r, deg = kw.get("gamma", 0.0), kw.get("coef0", 0.0), kw.get(
        "degree", 3)
    dots = xf @ xf.T
    k = {"linear": lambda: dots,
         "poly": lambda: (g * dots + r) ** deg,
         "sigmoid": lambda: np.tanh(g * dots + r),
         "precomputed": lambda: xf}[kind]()
    f = k @ (a * yf) - yf
    at0, atc = a <= 1e-9, a >= c - 1e-6
    inner, pos = ~at0 & ~atc, yf > 0
    in_up = inner | (at0 & pos) | (atc & ~pos)
    in_low = inner | (at0 & ~pos) | (atc & pos)
    return float(f[in_low].max() - f[in_up].min())


KINDS = ["linear", "poly", "rbf", "sigmoid", "precomputed"]


def _fields_equal(a, b):
    assert (a.kernel, a.degree, a.n_train) == (b.kernel, b.degree, b.n_train)
    for f in ("gamma", "coef0", "b"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("x_sv", "alpha", "y_sv"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.sv_idx is None) == (b.sv_idx is None)
    if a.sv_idx is not None:
        assert np.array_equal(a.sv_idx, b.sv_idx)


@pytest.mark.parametrize("kind", KINDS)
def test_model_files_cross_both_ways(kind, tmp_path):
    """A JAX-trained model: its file loads in the port to the same fields
    and writes back byte for byte; the port's decisions on it agree with
    the JAX package's. A port-trained model loads in the JAX package."""
    from dpsvm_tpu.api import fit as jfit
    xtr, ytr, xte, kw = _kind_problem(kind)
    jmodel, _ = jfit(xtr, ytr, JConfig(**kw))
    jpath, tpath = str(tmp_path / "j.svm"), str(tmp_path / "t.svm")
    jio.save_model(jmodel, jpath)
    tmodel = tio.load_model(jpath)
    _fields_equal(tmodel, jio.load_model(jpath))
    tio.save_model(tmodel, tpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    d_t = tdec(tmodel, xte, device="cpu")
    d_j = np.asarray(jdec(jmodel, xte))
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-5)
    # and the port's own model, the other way
    pmodel, _ = fit(xtr, ytr, SVMConfig(**kw), device="cpu")
    tio.save_model(pmodel, tpath)
    back = jio.load_model(tpath)
    _fields_equal(back, tio.load_model(tpath))
    jio.save_model(back, jpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    np.testing.assert_allclose(tdec(pmodel, xte, device="cpu"),
                               np.asarray(jdec(back, xte)), rtol=0,
                               atol=1e-5)


def test_model_from_numpy_carries_the_kernel():
    _, _, xte, kw = _kind_problem("precomputed")
    from dpsvm_tpu.api import fit as jfit
    xtr, ytr, _, _ = _kind_problem("precomputed")
    jm, _ = jfit(xtr, ytr, JConfig(**kw))
    tm = model_from_numpy(jm.x_sv, jm.alpha, jm.y_sv, jm.b, jm.gamma,
                          jm.kernel, jm.coef0, jm.degree, jm.sv_idx,
                          jm.n_train)
    _fields_equal(tm, jm)
    assert tm.num_attributes == 150
    with pytest.raises(ValueError, match="K\\(test, train\\)"):
        tdec(tm, xte[:, :50], device="cpu")


def test_precomputed_lower_bound_width_round_trips(tmp_path):
    path = tmp_path / "lb.svm"
    path.write_text("kernel precomputed 0.5 0 3\nsvidx 7+ 2 5\n0.25\n"
                    "0.5,1\n1,-1\n")
    m = tio.load_model(str(path))
    assert (m.n_train, m.n_train_exact, list(m.sv_idx)) == (7, False, [2, 5])
    # a wider K(test, train) is accepted for a lower-bound width
    assert tdec(m, np.ones((2, 9), np.float32), device="cpu").shape == (2,)
    out = tmp_path / "back.svm"
    tio.save_model(m, str(out))
    assert out.read_text() == path.read_text()


# --------------------------------------------------------- decomposition

@pytest.mark.parametrize("kind", ["linear", "poly", "sigmoid",
                                  "precomputed"])
def test_decomposition_per_kind_matches_jax(kind):
    """The port's decomposition for each kernel kind against the JAX
    package's. Three rounds (24 updates) are held to the decomposition
    tests' float32 bar (alpha rtol 1e-4 / atol 1e-5, the same updates). To
    convergence the two part at near-ties of the WSS2 argmax (XLA on the
    CPU contracts multiply-adds into FMAs, and reassociates the linear
    kernel's two products), so the converged models are held to the true
    gap recomputed in float64 (at most 3 eps) and the LibSVM bar on n_sv
    (2% or 3)."""
    xtr, ytr, _, kw = _kind_problem(kind)
    for max_iter in (24, 20_000):
        cfg = dict(kw, epsilon=1e-3, max_iter=max_iter, working_set=16,
                   inner_iters=8)
        ref = jdecomp.train_single_device_decomp(xtr, ytr, JConfig(**cfg))
        got = train_single_device_decomp(xtr, ytr, SVMConfig(**cfg), CPU)
        if max_iter == 24:
            assert got.n_iter == ref.n_iter == 24
            np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4,
                                       atol=1e-5)
            continue
        assert got.converged and ref.converged
        assert abs(got.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)
        assert _true_gap(xtr, ytr, got.alpha, kw) <= 3e-3
