"""The port's batched subproblem program (``solver/batched_ovo.py``) and
``sweep_c`` on the CPU, against the JAX package's ``train_ovo_batched``,
``train_c_sweep`` and ``api.sweep_c``.

Bars, and why:

* port against JAX, the same (P, n) batch, RBF (both clips): the same
  per-problem n_iter and convergence, alpha within 1e-5 x max(1, C) and b
  within 1e-5. The selection and the clip are exact; the kernel rows
  differ in the last bits (XLA's CPU exp against PyTorch's), which moves
  alpha by ulps, not the working sets on these problems. The other kinds
  part from JAX (see ``test_batched_program_matches_jax``) and are held
  to the LibSVM bar;
* the capped budget (every problem frozen at max_iter) and the wall budget
  (the run stops a chunk after the poll that saw the budget spent, as the
  JAX loop returns its speculative chunk): the same n_iter as JAX;
* the sweep against individual general-pair fits of the port at each (C,
  gamma): the JAX package's own bar (same n_sv, alpha within 5e-3, b
  within 1e-3); the batched product tiles differently from the single
  pair's. Against ``api.fit`` (the fused pair's arithmetic): n_sv within
  2% or 3;
* the guard table and the grid's validation: JAX's messages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu import api as japi
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.ops import kernels as jk
from dpsvm_tpu.solver import batched_ovo as jb
from dpsvm_tpu_torch import SVMConfig, fit, sweep_c
from dpsvm_tpu_torch.ops import kernels as tk
from dpsvm_tpu_torch.ops.selection import rowwise_extrema
from dpsvm_tpu_torch.solver import batched_ovo as tb
from dpsvm_tpu_torch.solver import smo as tsmo
from tests.test_multiclass import make_three_class

CPU = torch.device("cpu")


def _kw(**kw):
    base = dict(c=1.0, gamma=0.25, epsilon=1e-3, max_iter=20_000,
                chunk_iters=64)
    base.update(kw)
    return base


def _both(x, yb, valid, kw, **extra):
    rj = jb.train_ovo_batched(x, yb, valid, JConfig(**kw), **extra)
    rt = tb.train_ovo_batched(x, yb, valid, SVMConfig(**kw), device=CPU,
                              **extra)
    return rj, rt


def _same(rj, rt, c=1.0):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert (b.n_iter, b.converged) == (a.n_iter, a.converged)
        np.testing.assert_allclose(b.alpha, np.asarray(a.alpha),
                                   atol=1e-5 * max(1.0, c))
        assert b.b == pytest.approx(a.b, abs=1e-5)
        assert b.gamma == pytest.approx(a.gamma) and b.n_sv == a.n_sv


def _libsvm_bar(rj, rt, x, yb, valid):
    """Each subproblem's model, JAX's against the port's: n_sv within 2%
    or 3, accuracy on the subproblem's rows within one example."""
    from dpsvm_tpu_torch.models.svm import evaluate
    for p, (a, b) in enumerate(zip(rj, rt)):
        assert a.converged and b.converged
        assert abs(b.n_sv - a.n_sv) <= max(0.02 * a.n_sv, 3.0)
        sel = valid[p]
        ys = yb[p, sel].astype(np.int32)
        accs = [evaluate(tb.compact_submodel(x, sel, ys, r)[0], x[sel], ys,
                         device="cpu") for r in (a, b)]
        assert abs(accs[0] - accs[1]) <= 1.0 / sel.sum() + 1e-9


KINDS = {
    "rbf": {},
    "pairwise": dict(clip="pairwise"),
    "linear": dict(kernel="linear", c=0.1),
    "poly": dict(kernel="poly", gamma=0.1, coef0=1.0, degree=2),
    "sigmoid": dict(kernel="sigmoid", gamma=0.02, coef0=-0.5),
}


@pytest.mark.parametrize("kind", KINDS)
def test_batched_program_matches_jax(kind):
    """RBF, both clips: the JAX trajectory (n_iter exact, alpha within
    1e-5). The other kinds: XLA contracts the batched f update into
    fused multiply-adds, where the port rounds each product as its
    sequential pair does (so that the two port paths are equal given
    equal arithmetic); the trajectories part within tens of steps and
    stop at other points inside the epsilon tolerance, so each pair's
    model is held to the LibSVM bar: n_sv within 2% or 3, accuracy on
    the pair's rows within one example."""
    x, y = make_three_class(n_per=60, d=6, seed=3)
    yb, valid, pairs = tb.build_pair_targets(y, np.unique(y))
    jyb, jvalid, jpairs = jb.build_pair_targets(y, np.unique(y))
    assert pairs == jpairs
    np.testing.assert_array_equal(yb, jyb)
    np.testing.assert_array_equal(valid, jvalid)
    rj, rt = _both(x, yb, valid, _kw(**KINDS[kind]))
    assert all(r.converged for r in rt)
    if kind in ("rbf", "pairwise"):
        _same(rj, rt)
        return
    _libsvm_bar(rj, rt, x, yb, valid)


@pytest.mark.parametrize("kind", KINDS)
def test_one_pair_over_every_row_is_the_general_pair_bitwise(kind):
    """With one subproblem covering every row the batched product has the
    general pair's shape, and the two port paths are the same arithmetic:
    the same n_iter, alpha and b's, bit for bit (the JAX package can only
    claim this up to its CPU fusion, its test is an xfail)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(160, 6)).astype(np.float32)
    y = np.where(rng.random(160) < 0.5, 1, -1).astype(np.int32)
    x[y == 1] += 1.0
    cfg = SVMConfig(**_kw(**KINDS[kind]))
    rb, = tb.train_ovo_batched(x, y.astype(np.float32)[None],
                               np.ones((1, 160), bool), cfg, device=CPU)
    rs = tsmo.train_single_device(x, y, cfg, CPU)
    assert rb.converged and rs.converged and rb.n_iter == rs.n_iter
    np.testing.assert_array_equal(rb.alpha, rs.alpha)
    assert (rb.b_lo, rb.b_hi) == (rs.b_lo, rs.b_hi)


def test_capped_budget_freezes_every_problem_as_jax():
    x, y = make_three_class(n_per=80, d=6, seed=3)
    yb, valid, _ = tb.build_pair_targets(y, np.unique(y))
    rj, rt = _both(x, yb, valid, _kw(max_iter=40))
    assert all(not r.converged and r.n_iter == 40 for r in rt)
    _same(rj, rt)


def test_wall_budget_stops_a_chunk_after_the_poll_as_jax():
    x, y = make_three_class(n_per=80, d=6, seed=5)
    yb, valid, _ = tb.build_pair_targets(y, np.unique(y))
    rj, rt = _both(x, yb, valid, _kw(max_iter=200_000, epsilon=1e-7,
                                     chunk_iters=8, wall_budget_s=1e-9))
    assert any(not r.converged for r in rt)
    assert all(r.n_iter <= 16 for r in rt)
    _same(rj, rt)


def test_per_problem_c_and_gamma_match_jax():
    """Distinct boxes and gammas in one batch (the grid's layout over
    OvO masks)."""
    x, y = make_three_class(n_per=50, d=4, seed=7)
    yb, valid, _ = tb.build_pair_targets(y, np.unique(y))
    c = np.array([0.5, 2.0, 8.0], np.float32)
    g = np.array([0.1, 0.25, 0.6], np.float32)
    rj, rt = _both(x, yb, valid, _kw(), c_values=c, gamma_values=g)
    _same(rj, rt, c=8.0)
    assert [r.gamma for r in rt] == pytest.approx(g.tolist())


def test_gated_body_is_the_step_or_nothing():
    """The graph's body (``ovo_body``, run eagerly here) equals
    ``ovo_step`` while the chunk's condition holds and leaves the carry
    bitwise unchanged past ``limit`` or when every problem is done."""
    x, y = make_three_class(n_per=30, d=4, seed=2)
    yb, valid, _ = tb.build_pair_targets(y, np.unique(y))
    prob = tb.build_ovo_problem(x, yb, valid, SVMConfig(**_kw()), CPU)
    stepped = tb.init_ovo_carry(prob.yb)
    body = tb.init_ovo_carry(prob.yb)
    limit = torch.tensor(25, dtype=torch.int32)
    for _ in range(30):
        if int(stepped.t) < 25:
            stepped = tb.ovo_step(stepped, prob)
        tb.ovo_body(body, prob, limit)
    for a, b in zip(stepped, body):
        assert torch.equal(a, b)
    assert int(body.t) == 25
    done = tb.run_ovo_plain(tb.init_ovo_carry(prob.yb), prob, 10 ** 6)
    before = [t.clone() for t in done]
    tb.ovo_body(done, prob, torch.tensor(10 ** 6, dtype=torch.int32))
    for a, b in zip(before, done):
        assert torch.equal(a, b)


def test_rowwise_extrema_is_jnp_argmin_argmax():
    rng = np.random.default_rng(0)
    vals = np.array([-1.0, 0.0, -0.0, 2.0, np.inf, -np.inf, np.nan, 1e9,
                     -1e9], np.float32)
    for _ in range(50):
        a = rng.choice(vals, size=(4, 9)).astype(np.float32)
        b = rng.choice(vals, size=(4, 9)).astype(np.float32)
        i_hi, b_hi, i_lo, b_lo = rowwise_extrema(torch.from_numpy(a),
                                                 torch.from_numpy(b))
        np.testing.assert_array_equal(i_hi.numpy(),
                                      np.asarray(jnp.argmin(a, axis=1)))
        np.testing.assert_array_equal(i_lo.numpy(),
                                      np.asarray(jnp.argmax(b, axis=1)))
        np.testing.assert_array_equal(b_hi.numpy(),
                                      a[np.arange(4), i_hi.numpy()])


@pytest.mark.parametrize("kind", ["rbf", "poly", "sigmoid", "linear"])
def test_rows_from_dots_per_row_gamma(kind):
    """An (r, 1) gamma tensor: each row as the scalar path at its own gamma
    (bitwise), and within 2e-6 of the JAX ``rows_from_dots(...,
    gamma=g2)``."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, 5)).astype(np.float32)
    w = x[[3, 7, 1, 3]]
    dots = (w @ x.T).astype(np.float32)
    g = np.array([0.1, 0.5, 0.25, 0.7], np.float32)[:, None]
    spec = tk.KernelSpec(kind=kind, gamma=0.3, coef0=0.5, degree=3)
    x2 = tk.host_row_norms_sq(x)
    w2 = tk.host_row_norms_sq(w)
    t = lambda a: torch.from_numpy(np.array(a))
    got = tk.rows_from_dots(t(dots), t(w2), t(x2), spec,
                            gamma=t(g)).numpy()
    for r in range(4):
        one = tk.rows_from_dots(t(dots[r:r + 1]), t(w2[r:r + 1]), t(x2),
                                spec._replace(gamma=float(g[r, 0])))
        np.testing.assert_array_equal(got[r], one.numpy()[0])
    jspec = jk.KernelSpec(kind=kind, gamma=0.3, coef0=0.5, degree=3)
    want = np.asarray(jk.rows_from_dots(jnp.asarray(dots), jnp.asarray(w2),
                                        jnp.asarray(x2), jspec,
                                        gamma=jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


GUARDS = [dict(selection="second-order"), dict(weight_pos=2.0),
          dict(shrinking=True), dict(working_set=64), dict(cache_size=4),
          dict(polish=True), dict(use_pallas="on"), dict(shards=2)]


@pytest.mark.parametrize("bad", GUARDS, ids=lambda d: next(iter(d)))
def test_guard_table_matches_jax(bad):
    msgs = []
    for cls, mod in ((JConfig, jb), (SVMConfig, tb)):
        with pytest.raises(ValueError) as e:
            mod.batched_guard(cls(**_kw(**bad)), "OvO")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_guard_rejects_sentinels_resolving_nonclassic(monkeypatch):
    import dpsvm_tpu_torch.config as cfgmod

    def flipped(n, d, config):
        plan = {}
        if config.shrinking == "auto":
            plan["shrinking"] = True
        if config.working_set == 0:
            plan["working_set"] = 64
        return plan

    shapes = [(60, 4)]
    tb.batched_guard(SVMConfig(**_kw(shrinking="auto", working_set=0)),
                     "OvO", shapes)
    monkeypatch.setattr(cfgmod, "_auto_solver_plan", flipped)
    for kw in (dict(shrinking="auto"), dict(working_set=0)):
        with pytest.raises(ValueError, match="non-classic"):
            tb.batched_guard(SVMConfig(**_kw(**kw)), "OvO", shapes)


def _binary(seed, n=200, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(x[:, 0] + 0.3 * rng.normal(size=n) > 0, 1, -1
                 ).astype(np.int32)
    return x, y


def test_sweep_c_matches_jax_and_individual_fits():
    x, y = _binary(31)
    cs = [0.1, 1.0, 10.0]
    kw = _kw()
    swept = sweep_c(x, y, cs, SVMConfig(**kw), device="cpu")
    jswept = japi.sweep_c(x, y, cs, JConfig(**kw))
    _same([r for _, r in jswept], [r for _, r in swept], c=max(cs))
    for c, (model, r) in zip(cs, swept):
        ri = tsmo.train_single_device(x, y, SVMConfig(**dict(kw, c=c)), CPU)
        assert r.converged and ri.converged
        assert r.n_sv == ri.n_sv == model.n_sv
        np.testing.assert_allclose(r.alpha, ri.alpha, atol=5e-3)
        assert r.b == pytest.approx(ri.b, abs=1e-3)
        _, rf = fit(x, y, SVMConfig(**dict(kw, c=c)), device="cpu")
        assert abs(rf.n_sv - r.n_sv) <= max(0.02 * r.n_sv, 3.0)
    assert len({m.n_sv for m, _ in swept}) > 1


def test_full_grid_matches_jax_and_individual_fits():
    """The grid against JAX's: at gamma = 0.05 one point's trajectory
    parts from JAX's at a near-tie (XLA contracts the RBF epilogue's
    multiply-adds), so the grid is held to the LibSVM bar there and to
    the JAX package's sweep-against-fit bar against the port's general
    pair at each point (the same arithmetic but for the product's
    tiling)."""
    x, y = _binary(51, n=180)
    cs, gs = [0.5, 5.0], [0.05, 0.5]
    kw = _kw()
    grid = sweep_c(x, y, cs, SVMConfig(**kw), gammas=gs, device="cpu")
    jgrid = japi.sweep_c(x, y, cs, JConfig(**kw), gammas=gs)
    yb = np.tile(y.astype(np.float32), (4, 1))
    _libsvm_bar([r for _, r in jgrid], [r for _, r in grid], x, yb,
                np.ones_like(yb, bool))
    idx = 0
    for c in cs:
        for g in gs:
            ri = tsmo.train_single_device(
                x, y, SVMConfig(**dict(kw, c=c, gamma=g)), CPU)
            rb = grid[idx][1]
            assert rb.gamma == pytest.approx(g) and rb.n_sv == ri.n_sv
            np.testing.assert_allclose(rb.alpha, ri.alpha, atol=5e-3)
            idx += 1


@pytest.mark.parametrize("case", ["labels", "empty", "guard", "c_values",
                                  "nan_c", "inf_c", "y_len", "precomputed",
                                  "inf_gamma", "nan_gamma", "linear_gamma"])
def test_sweep_validation_matches_jax(case):
    x, y = _binary(4, n=50, d=4)
    yf = y.astype(np.float32)
    calls = {
        "labels": lambda m, a, C: m.train_c_sweep(
            x, np.arange(50), [1.0], C(**_kw())),
        "empty": lambda m, a, C: m.train_c_sweep(x, yf, [], C(**_kw())),
        "guard": lambda m, a, C: m.train_c_sweep(
            x, yf, [1.0], C(**_kw(selection="second-order"))),
        "c_values": lambda m, a, C: m.train_ovo_batched(
            x, yf[None], np.ones((1, 50), bool), C(**_kw()),
            c_values=np.array([-1.0])),
        "nan_c": lambda m, a, C: a.sweep_c(x, y, [float("nan")], C(**_kw())),
        "inf_c": lambda m, a, C: a.sweep_c(x, y, [float("inf")], C(**_kw())),
        "y_len": lambda m, a, C: a.sweep_c(x, y[:-1], [1.0], C(**_kw())),
        "precomputed": lambda m, a, C: m.train_c_sweep(
            np.eye(50, dtype=np.float32), yf, [1.0],
            C(**_kw(kernel="precomputed"))),
        "inf_gamma": lambda m, a, C: a.sweep_c(
            x, y, [1.0], C(**_kw()), gammas=[float("inf")]),
        "nan_gamma": lambda m, a, C: a.sweep_c(
            x, y, [1.0], C(**_kw()), gammas=[float("nan")]),
        "linear_gamma": lambda m, a, C: m.train_c_sweep(
            x, yf, [1.0], C(**_kw(kernel="linear")), gammas=[0.1, 1.0]),
    }
    from dpsvm_tpu_torch import api as tapi
    msgs = []
    for m, a, C in ((jb, japi, JConfig), (tb, tapi, SVMConfig)):
        with pytest.raises(ValueError) as e:
            calls[case](m, a, C)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_sweep_runs_on_the_card_by_default():
    x, y = _binary(4, n=40, d=3)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep_c(x, y, [1.0], SVMConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.train_ovo_batched(x, y.astype(np.float32)[None],
                             np.ones((1, 40), bool), SVMConfig())


def test_compact_submodel_and_pair_shapes():
    x, y = make_three_class(n_per=20, d=4, seed=1)
    classes = np.unique(y)
    assert tb.ovo_pair_shapes(y, classes, 4) == jb.ovo_pair_shapes(
        y, classes, 4)
    yb, valid, _ = tb.build_pair_targets(y, classes)
    res = tb.train_ovo_batched(x, yb, valid, SVMConfig(**_kw()),
                               device=CPU)
    sel = valid[1]
    ys = np.where(y[sel] == classes[0], 1, -1)
    model, rr = tb.compact_submodel(x, sel, ys, res[1])
    assert rr.alpha.shape == (sel.sum(),) and model.n_sv == res[1].n_sv
    np.testing.assert_array_equal(model.x_sv, x[sel][rr.alpha > 0])
    _, rr2 = tb.compact_submodel(x, sel, ys, dataclasses.replace(res[1]),
                                 xs=np.ascontiguousarray(x[sel]))
    np.testing.assert_array_equal(rr.alpha, rr2.alpha)
