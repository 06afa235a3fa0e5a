"""The port's shrinking (``solver/shrink.py``) and the ``valid`` mask of its
two solver paths on the CPU, against the JAX package.

Bars, and why:

* the host rules (``_bucket_cap``, ``_shrinkable``, ``_host_extrema``,
  ``iup_ilow_masks_np``): exactly equal, they are the same numpy code;
* ``_reconstruct_inactive_f``: exactly equal on the linear kernel with
  small dyadic data (every product and sum is exact in float32, whatever
  order XLA and PyTorch sum in); for the other kinds within 2e-6 *
  max(1, |f|), since XLA's and PyTorch's CPU exp differ in the last bit;
* one masked ``smo_step`` on padded inputs: the same working set, alpha
  and b's bit for bit; f within 1e-6 * max(1, |f|): XLA contracts f's
  update into FMAs, the port rounds each product
  (tests/test_torch_smo.py says why), so f differs in the last bit even
  where every kernel value is exact;
* one masked ``decomp_step``: the same b's and inner step count, and no
  padding row moves; alpha within 1e-6 and f within 1e-6 * max(1, |f|)
  (the subsolve's update rounds where XLA fuses, as above);
* whole shrinking runs: where the port's unshrunk trajectory equals the
  JAX one (the planted problem of tests/test_torch_smo.py and two larger
  ones, RBF and linear), the same sequence of active-set sizes and the
  same n_iter; elsewhere (the decomposition, whose trajectories part at
  near-ties: tests/test_torch_decomp.py) the repo's LibSVM bar
  (``tests/conftest.py::assert_libsvm_parity``: n_sv within 2% or 3 of
  LIBSVM's, train and held-out accuracy within one example), the same bar
  against the port's unshrunk run, n_sv within 2% or 3 of JAX's
  shrinking run, and the true gap recomputed in float64 within
  2 eps + 5e-4, as tests/test_decomp.py holds it.

The check cadence ``SHRINK_CHECK_ITERS`` is set to 128 in both packages
for the whole runs, so that problems of a few hundred rows compact (the
rule is ``min(SHRINK_CHECK_ITERS, n)``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpsvm_tpu.solver.shrink as jshrink
from dpsvm_tpu.api import warm_start as jwarm_start
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.config import _auto_solver_plan as j_plan
from dpsvm_tpu.config import _PLAN_TABLE as J_TABLE
from dpsvm_tpu.config import _shape_class as j_shape_class
from dpsvm_tpu.data.synthetic import make_blobs, make_planted
from dpsvm_tpu.ops.kernels import host_row_stats as j_row_stats
from dpsvm_tpu.ops.selection import iup_ilow_masks_np as j_masks
from dpsvm_tpu.solver import decomp as jdecomp
from dpsvm_tpu.solver import smo as jsmo
from dpsvm_tpu_torch import SVMConfig, evaluate, fit, train, warm_start
from dpsvm_tpu_torch import config as tconfig
from dpsvm_tpu_torch.convert import smo_carry_from_numpy
from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
from dpsvm_tpu_torch.models.svm import SVMModel
from dpsvm_tpu_torch.ops.selection import iup_ilow_masks_np as t_masks
from dpsvm_tpu_torch.solver import decomp as tdecomp
from dpsvm_tpu_torch.solver import shrink as tshrink
from dpsvm_tpu_torch.solver import smo as tsmo
from conftest import split_train_test
from test_decomp import true_gap_and_b

CPU = torch.device("cpu")
CHECK_ITERS = 128


@pytest.fixture
def fast_checks(monkeypatch):
    monkeypatch.setattr(jshrink, "SHRINK_CHECK_ITERS", CHECK_ITERS)
    monkeypatch.setattr(tshrink, "SHRINK_CHECK_ITERS", CHECK_ITERS)


def _jax_shrink(x, y, tmp_path, f_init=None, alpha_init=None, **cfg):
    """JAX's train_shrinking and its active-set sizes: n, then the
    n_active_after of every shrink and unshrink event of its run trace."""
    trace = tmp_path / "jax_trace.jsonl"
    res = jshrink.train_shrinking(x, y, JConfig(trace_out=str(trace), **cfg),
                                  f_init=f_init, alpha_init=alpha_init)
    sizes = [len(y)] + [
        r["n_active_after"] for r in map(json.loads,
                                         trace.read_text().splitlines())
        if r.get("kind") == "event" and r.get("event") in ("shrink",
                                                           "unshrink")]
    return res, sizes


def _dyadic(n, d, seed):
    """Small integer features and labels: every linear-kernel product and
    sum of a dot product is exact in float32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    return x, y


# ------------------------------------------------------------ host rules

@pytest.mark.parametrize("n", [1, 300, 512, 513, 5000, 60000])
def test_bucket_cap_matches_jax(n):
    for n_act in sorted({1, 2, n // 3, n // 2, n - 1, n, 511, 512, 513,
                         4097} & set(range(1, n + 1))):
        for floor in (512, 64):
            assert (tshrink._bucket_cap(n_act, n, floor)
                    == jshrink._bucket_cap(n_act, n, floor))


@pytest.mark.parametrize("weighted", [False, True])
def test_host_rules_match_jax(weighted):
    rng = np.random.default_rng(3)
    n = 400
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    box = (np.where(y > 0, 2.0, 0.5).astype(np.float32) if weighted
           else np.full(n, 1.0, np.float32))
    alpha = np.where(rng.random(n) < 0.3, box,
                     rng.choice([0.0, 0.5], n) * box).astype(np.float32)
    f = rng.normal(0, 1, n).astype(np.float32)
    for a, b in zip(t_masks(alpha, y, box), j_masks(alpha, y, box)):
        np.testing.assert_array_equal(a, b)
    assert (tshrink._host_extrema(alpha, y, f, box)
            == jshrink._host_extrema(alpha, y, f, box))
    for b_hi, b_lo in ((-0.3, 0.4), (0.0, 0.0), (-1.5, 1.5)):
        np.testing.assert_array_equal(
            tshrink._shrinkable(alpha, y, f, box, b_hi, b_lo),
            jshrink._shrinkable(alpha, y, f, box, b_hi, b_lo))


@pytest.mark.parametrize("kind", ["linear", "rbf", "poly", "sigmoid"])
@pytest.mark.parametrize("seeded", [False, True])
def test_reconstruct_inactive_f_matches_jax(kind, seeded):
    n, d = 300, 12
    x, y = _dyadic(n, d, seed=4)
    rng = np.random.default_rng(5)
    yf = y.astype(np.float32)
    alpha = (rng.integers(0, 5, n) / 4.0).astype(np.float32)
    alpha[rng.random(n) < 0.4] = 0.0
    alpha0 = np.zeros(n, np.float32)
    f0 = -yf
    if seeded:      # a warm start's seed: the rebuild is relative to it
        alpha0 = (rng.integers(0, 3, n) / 4.0).astype(np.float32)
        f0 = (rng.integers(-8, 8, n) / 8.0).astype(np.float32)
    f = (rng.integers(-16, 16, n) / 8.0).astype(np.float32)
    active = rng.random(n) < 0.4
    kw = {"linear": {}, "rbf": dict(gamma=0.05),
          "poly": dict(gamma=0.05, coef0=1.0, degree=3),
          "sigmoid": dict(gamma=0.01, coef0=-0.5)}[kind]
    spec_j = JConfig(kernel=kind, **kw).kernel_spec(d)
    spec_t = SVMConfig(kernel=kind, **kw).kernel_spec(d)
    got = tshrink._reconstruct_inactive_f(x, yf, alpha, f, alpha0, f0,
                                          active, spec_t, block=64)
    want = np.asarray(jshrink._reconstruct_inactive_f(
        x, yf, alpha, f, alpha0, f0, active, spec_j, block=64))
    np.testing.assert_array_equal(got[active], f[active])
    if kind == "linear":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 2e-6 * max(1.0,
                                                      np.abs(want).max())


# ------------------------------------------------------ the valid mask

def _padded(x, y, cap):
    """The shrinking manager's padding: zero rows, y = +1."""
    n, d = x.shape
    xp = np.zeros((cap, d), np.float32)
    xp[:n] = x
    yp = np.ones(cap, np.int32)
    yp[:n] = y
    return xp, yp


SMO_CASES = {
    "first-order": dict(kernel="rbf", gamma=0.25),
    "packed": dict(kernel="rbf", gamma=0.25, select_impl="packed"),
    "second-order": dict(kernel="rbf", gamma=0.25, selection="second-order"),
    "weighted": dict(kernel="rbf", gamma=0.25, weight_pos=2.0,
                     weight_neg=0.5),
    "poly-second-order": dict(kernel="poly", gamma=1 / 40, coef0=1.0,
                              selection="second-order"),
    "linear": dict(kernel="linear"),
    "linear-second-order": dict(kernel="linear", selection="second-order"),
}


@pytest.mark.parametrize("case", sorted(SMO_CASES))
def test_masked_smo_step_matches_jax(case):
    """One step of the general pair from a mid-run carry on padded inputs.
    The rows past n_valid are given f = -50 (in I_up, they would win the
    argmin if unmasked; the manager's SENTINEL f keeps them out anyway),
    so the step is only right if the mask holds."""
    kw = SMO_CASES[case]
    x, y = make_planted(150, 40, 0.25, seed=2)
    n_valid, cap = 150, 256
    xp, yp = _padded(x, y, cap)
    rng = np.random.default_rng(7)
    jc, tc = JConfig(c=1.0, **kw), SVMConfig(c=1.0, **kw)
    box = np.broadcast_to(np.asarray(tc.box_bound(yp), np.float32), (cap,))
    alpha = np.where(rng.random(cap) < 0.3, box,
                     rng.choice([0.0, 0.5], cap) * box).astype(np.float32)
    f = (-yp + rng.normal(0, 0.3, cap)).astype(np.float32)
    alpha[n_valid:] = 0.0
    f[n_valid:] = -50.0
    kspec = jc.kernel_spec(xp.shape[1])
    valid = np.arange(cap) < n_valid
    jstep = jax.jit(lambda c: jsmo.smo_step(
        c, jnp.asarray(xp), jnp.asarray(yp, jnp.float32),
        jnp.asarray(j_row_stats(xp, kspec)), float(jc.c), kspec,
        second_order=jc.selection == "second-order",
        weights=(jc.weight_pos, jc.weight_neg),
        packed_select=jc.select_impl == "packed",
        valid=jnp.asarray(valid)))
    want = jstep(jsmo.SMOCarry(jnp.asarray(alpha), jnp.asarray(f),
                               jnp.float32(-1e9), jnp.float32(1e9),
                               jnp.int32(0), jsmo.cache_init(0, cap)))
    prob = tsmo.SMOProblem.build(xp, yp, tc, CPU)
    carry = smo_carry_from_numpy(alpha, f, yp, -1e9, 1e9, 0, device="cpu")
    got = tsmo.smo_step(carry, prob, tsmo.SMOOptions.from_config(tc),
                        valid=torch.from_numpy(valid))
    moved = np.flatnonzero(got.alpha.numpy() != alpha)
    assert moved.size and (moved < n_valid).all()
    assert np.array_equal(got.alpha.numpy(), np.asarray(want.alpha))
    assert float(got.b_hi) == float(want.b_hi) > -50.0
    assert float(got.b_lo) == float(want.b_lo)
    fw = np.asarray(want.f)[:n_valid]
    fg = got.f.numpy()[:n_valid]
    assert np.abs(fg - fw).max() <= 1e-6 * max(1.0, np.abs(fw).max())
    # the unmasked step on the same carry picks a padding row
    free = tsmo.smo_step(carry, prob, tsmo.SMOOptions.from_config(tc))
    assert (np.flatnonzero(free.alpha.numpy() != alpha) >= n_valid).any()


@pytest.mark.parametrize("kind", ["linear", "rbf"])
@pytest.mark.parametrize("n_valid", [40, 150])
def test_masked_decomp_step_matches_jax(kind, n_valid):
    """One decomposition round on padded inputs. With 40 valid rows and
    q = 64 the real violators run out, so padding rows are drawn into W as
    top-k filler: they must reach the subsolve as masked slots."""
    q, cap, inner_cap = 64, 256, 32
    if kind == "linear":
        x, y = _dyadic(n_valid, 8, seed=2)
        x = x / 4.0         # kernel values of the size of f
        kw = dict(kernel="linear")
    else:
        x, y = make_planted(n_valid, 40, 0.25, seed=3)
        kw = dict(kernel="rbf", gamma=0.25)
    xp, yp = _padded(x, y, cap)
    yf = yp.astype(np.float32)
    alpha = np.zeros(cap, np.float32)
    f = -yf
    f[n_valid:] = 1e9
    valid = np.arange(cap) < n_valid
    jc, tc = JConfig(c=1.0, **kw), SVMConfig(c=1.0, **kw)
    kspec = jc.kernel_spec(xp.shape[1])
    carry = jdecomp.DecompCarry(jnp.asarray(alpha), jnp.asarray(f),
                                jnp.float32(-1e9), jnp.float32(1e9),
                                jnp.int32(0), jnp.int32(0))
    want = jax.jit(lambda c: jdecomp.decomp_step(
        c, jnp.asarray(xp), jnp.asarray(yf),
        jnp.asarray(j_row_stats(xp, kspec)), 1.0, kspec, q=q,
        inner_cap=inner_cap, epsilon=1e-3, limit=jnp.int32(inner_cap),
        valid=jnp.asarray(valid)))(carry)
    prob = tdecomp.DecompProblem.build(xp, yp, tc, CPU)
    tcarry = tdecomp.DecompCarry(
        torch.from_numpy(alpha.copy()), torch.from_numpy(f.copy()),
        torch.tensor(-1e9), torch.tensor(1e9),
        torch.tensor(0, dtype=torch.int32), torch.tensor(0,
                                                         dtype=torch.int32))
    got = tdecomp.decomp_step(
        tcarry, prob, q=q, inner_cap=inner_cap, epsilon=1e-3,
        step_cap=inner_cap, subsolve=sk.inner_subsolve_plain,
        valid=torch.from_numpy(valid))
    ga, wa = got.alpha.numpy(), np.asarray(want.alpha)
    assert (ga[n_valid:] == 0.0).all() and (wa[n_valid:] == 0.0).all()
    assert int(got.n_iter) == int(want.n_iter) > 0
    assert float(got.b_hi) == float(want.b_hi)
    assert float(got.b_lo) == float(want.b_lo)
    np.testing.assert_allclose(ga, wa, rtol=0, atol=1e-6)
    fw = np.asarray(want.f)[:n_valid]
    assert (np.abs(got.f.numpy()[:n_valid] - fw).max()
            <= 1e-6 * max(1.0, np.abs(fw).max()))


# ------------------------------------------------------------ whole runs

PROBLEMS = {
    "planted": lambda: make_planted(190, 40, 0.25, seed=2),
    "planted600": lambda: make_planted(600, 40, 0.25, seed=2),
    "blobs1000": lambda: make_blobs(n=1000, d=8, seed=1),
}

SAME_TRAJECTORY = [
    ("planted", dict(kernel="linear")),
    ("planted", dict(gamma=0.25)),
    ("planted", dict(gamma=0.25, selection="second-order")),
    ("planted600", dict(gamma=0.25)),
    ("planted600", dict(gamma=0.25, selection="second-order")),
    ("blobs1000", dict(gamma=0.25)),
    ("blobs1000", dict(gamma=0.25, selection="second-order")),
]


@pytest.mark.parametrize("problem,kw", SAME_TRAJECTORY,
                         ids=[f"{p}-{'-'.join(map(str, k.values()))}"
                              for p, k in SAME_TRAJECTORY])
def test_shrinking_walks_the_jax_trajectory(problem, kw, tmp_path,
                                            fast_checks):
    x, y = PROBLEMS[problem]()
    cfg = dict(c=1.0, epsilon=1e-3, shrinking=True, chunk_iters=64, **kw)
    ref, sizes = _jax_shrink(x, y, tmp_path, **cfg)
    got = train(x, y, SVMConfig(**cfg), device="cpu")
    assert tshrink.RUN["active_sizes"] == sizes
    assert tshrink.RUN["compactions"] >= 1 and tshrink.RUN["unshrinks"] >= 1
    assert got.n_iter == ref.n_iter and got.converged and ref.converged
    assert got.n_sv == ref.n_sv
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)
    assert abs(got.b - ref.b) <= 1e-4


def _assert_bar(got, others, x, y, c, gamma, eps=1e-3, split=None,
                unshrunk=None):
    """n_sv within 2% or 3 of every run in ``others``; with ``split``
    (xte, yte), the LibSVM bar against LIBSVM itself, as
    ``tests/conftest.py::assert_libsvm_parity`` holds it (our epsilon is
    half of LIBSVM's tol, the same stopping gap), and against the port's
    ``unshrunk`` run; and the true gap."""
    from sklearn import svm as sklearn_svm

    assert got.converged
    for ref in others:
        assert ref.converged
        assert abs(got.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)
    if split is not None:
        xte, yte = split
        if unshrunk is not None:
            mg = SVMModel.from_train_result(x, y, got)
            mu = SVMModel.from_train_result(x, y, unshrunk)
            for xs, ys in ((x, y), (xte, yte)):
                assert abs(evaluate(mg, xs, ys, device="cpu")
                           - evaluate(mu, xs, ys, device="cpu")) <= (
                    1.0 / len(ys) + 1e-9)
        lib = sklearn_svm.SVC(C=c, kernel="rbf", gamma=gamma, tol=2 * eps)
        lib.fit(x, y)
        assert abs(got.n_sv - int(lib.n_support_.sum())) <= max(
            0.02 * lib.n_support_.sum(), 3)
        model = SVMModel.from_train_result(x, y, got)
        for xs, ys in ((x, y), (xte, yte)):
            assert abs(evaluate(model, xs, ys, device="cpu")
                       - lib.score(xs, ys)) <= 1.0 / len(ys) + 1e-9
    gap, _ = true_gap_and_b(x, y, got.alpha, C=c, gamma=gamma)
    assert gap <= 2 * eps + 5e-4, gap


BAR_CASES = [
    ("planted600", dict(working_set=16)),
    ("planted600", dict(working_set=32, c=10.0)),
    ("blobs1000", dict(working_set=16)),
    ("planted600", dict(working_set=16, clip="pairwise")),
    ("planted600", dict(selection="second-order", clip="pairwise")),
]


@pytest.mark.parametrize("problem,kw", BAR_CASES,
                         ids=[f"{p}-{'-'.join(map(str, k.values()))}"
                              for p, k in BAR_CASES])
def test_shrinking_meets_the_bar(problem, kw, tmp_path, fast_checks):
    """On 3/4 of the rows: against LIBSVM, JAX's shrinking run and the
    port's unshrunk run."""
    xtr, ytr, xte, yte = split_train_test(*PROBLEMS[problem]())
    cfg = dict(c=1.0, gamma=0.25, epsilon=1e-3, chunk_iters=64)
    cfg.update(kw)
    ref, _ = _jax_shrink(xtr, ytr, tmp_path, shrinking=True, **cfg)
    got = train(xtr, ytr, SVMConfig(shrinking=True, **cfg), device="cpu")
    assert tshrink.RUN["compactions"] >= 1
    if kw.get("working_set", 2) > 2:
        assert min(tshrink.RUN["active_sizes"]) >= kw["working_set"]
    plain = train(xtr, ytr, SVMConfig(**cfg), device="cpu")
    _assert_bar(got, (ref, plain), xtr, ytr, cfg["c"], 0.25,
                split=(xte, yte), unshrunk=plain)


def test_shrinking_after_warm_start(tmp_path, fast_checks):
    """A warm start seeds (alpha0, f0); the unshrink rebuilds f relative
    to them, so the run lands where the unshrunk warm start does."""
    x, y = PROBLEMS["planted600"]()
    base = dict(c=1.0, gamma=0.25, epsilon=1e-3, chunk_iters=64)
    capped = train(x, y, SVMConfig(max_iter=200, **base), device="cpu")
    got = warm_start(x, y, capped.alpha, SVMConfig(shrinking=True, **base),
                     device="cpu")
    assert tshrink.RUN["compactions"] >= 1 and tshrink.RUN["unshrinks"] >= 1
    plain = warm_start(x, y, capped.alpha, SVMConfig(**base), device="cpu")
    ref = jwarm_start(x, y, capped.alpha, JConfig(shrinking=True, **base))
    _assert_bar(got, (plain, ref), x, y, 1.0, 0.25)


def test_max_iter_reached_while_compacted(tmp_path, fast_checks):
    """The budget ends inside a compacted subproblem: the state is
    scattered back, f rebuilt, the full problem checked, and n_iter is
    exactly max_iter, as in JAX."""
    x, y = PROBLEMS["planted600"]()
    cfg = dict(c=1.0, gamma=0.25, epsilon=1e-3, chunk_iters=64,
               shrinking=True, max_iter=300)
    ref, sizes = _jax_shrink(x, y, tmp_path, **cfg)
    got = train(x, y, SVMConfig(**cfg), device="cpu")
    assert got.n_iter == ref.n_iter == 300
    assert not got.converged and not ref.converged
    assert tshrink.RUN["active_sizes"] == sizes
    assert sizes[-2] < len(y) and sizes[-1] == len(y)    # capped compacted
    idx, f_rebuilt, alpha = tshrink.RUN["rebuilt"]
    assert len(idx) == len(y) - sizes[-2]
    np.testing.assert_array_equal(alpha, got.alpha)
    fresh = (np.asarray(jshrink._stream_kv_against(
        x[idx], x, alpha * y, JConfig(gamma=0.25).kernel_spec(40), 4096))
        - y[idx])
    assert np.abs(f_rebuilt - fresh).max() <= 2e-6 * max(
        1.0, np.abs(fresh).max())
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)
    assert abs(got.gap - ref.gap) <= 1e-4


@pytest.mark.parametrize("q", [64, 512])
def test_min_active_is_q(q, tmp_path, fast_checks):
    """The decomposition never compacts below its block: at q = 512 the
    1000-row problem cannot halve without passing under q, so it never
    compacts; at q = 64 it does, to the sizes JAX's manager picks."""
    x, y = PROBLEMS["blobs1000"]()
    cfg = dict(c=1.0, gamma=0.25, epsilon=1e-3, chunk_iters=64,
               shrinking=True, working_set=q)
    ref, sizes = _jax_shrink(x, y, tmp_path, **cfg)
    got = train(x, y, SVMConfig(**cfg), device="cpu")
    assert min(tshrink.RUN["active_sizes"]) >= q
    assert min(tshrink.RUN["capacities"]) >= q
    assert (tshrink.RUN["compactions"] == 0) == (q == 512)
    assert (len(sizes) == 1) == (q == 512)
    _assert_bar(got, (ref,), x, y, 1.0, 0.25)


def test_run_record_counts_its_work(fast_checks):
    x, y = PROBLEMS["planted600"]()
    train(x, y, SVMConfig(c=1.0, gamma=0.25, shrinking=True,
                          chunk_iters=64), device="cpu")
    run = tshrink.RUN
    assert run["compactions"] + run["unshrinks"] + 1 == len(
        run["active_sizes"]) == len(run["active_since"])
    assert run["active_since"][0] == 0
    assert run["active_since"] == sorted(run["active_since"])
    assert len(run["capacities"]) >= 2 and run["captures"] == 0   # no card
    assert run["capacities"][0] == 600 and run["capacities"][1] == 512
    assert run["pulls"] >= run["compactions"] + run["unshrinks"]
    assert set(run["seconds"]) == {"rebuild", "pull", "reconstruct"}


def test_shards_and_precomputed_refused():
    x, y = make_blobs(n=60, d=4, seed=1)
    # shards > 1 shrinks over the ranks of a group, which must exist
    with pytest.raises(RuntimeError, match="launch_local"):
        train(x, y, SVMConfig(shrinking=True, shards=2), device="cpu")
    k = (x @ x.T).astype(np.float32)
    msgs = []
    for cls in (JConfig, SVMConfig):
        with pytest.raises(ValueError) as e:
            cls(kernel="precomputed", shrinking=True).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "shrinking" in msgs[0]
    with pytest.raises(ValueError, match="precomputed kernel does not"):
        train(k, y, SVMConfig(kernel="precomputed", shrinking=True),
              device="cpu")


@pytest.mark.parametrize("kw", [
    dict(shrinking=1), dict(shrinking="yes"), dict(shrinking="auto"),
    dict(shrinking=True, cache_size=4),
    dict(shrinking=True, use_pallas="on"),
    dict(shrinking=True, use_pallas="on", working_set=8),
    dict(shrinking=True, checkpoint_path="s.npz"),
    dict(shrinking=True, resume_from="s.npz"),
    dict(shrinking=True, working_set=8, cache_size=0),
    dict(shrinking="auto", cache_size=4),
])
def test_validation_matches_jax(kw):
    outcome = []
    for cls in (JConfig, SVMConfig):
        try:
            cls(**kw).validate()
            outcome.append(None)
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1], outcome


SHAPES = [(250_000, 10), (60_000, 784), (1_000, 16), (5_000, 100),
          (100, 512), (199_999, 32), (200_000, 33)]
AUTO = [dict(shrinking="auto"), dict(working_set=0),
        dict(shrinking="auto", working_set=0),
        dict(shrinking="auto", cache_size=4),
        dict(shrinking="auto", checkpoint_path="s.npz"),
        dict(shrinking="auto", kernel="precomputed"),
        dict(working_set=0, selection="second-order"),
        dict(shrinking=True, working_set=0)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_auto_plan_resolves_as_jax(shape):
    n, d = shape
    assert tconfig._shape_class(n, d) == j_shape_class(n, d)
    assert tconfig._PLAN_TABLE == J_TABLE
    for kw in AUTO:
        jc, tc = JConfig(**kw), SVMConfig(**kw)
        assert tconfig._auto_solver_plan(n, d, tc) == j_plan(n, d, jc), kw
        if kw.get("kernel") == "precomputed":
            continue
        jr, tr = jc.resolved(n, d), tc.resolved(n, d)
        assert (tr.shrinking, tr.working_set, tr.inner_iters) == (
            jr.shrinking, jr.working_set, jr.inner_iters), kw
    # this PR changes no default path: auto is the unshrunk pair
    res = SVMConfig(shrinking="auto", working_set=0).resolved(n, d)
    assert res.shrinking is False and res.working_set == 2


def test_auto_train_takes_the_unshrunk_pair():
    x, y = make_blobs(n=60, d=4, seed=1)
    reads = tsmo.COUNTS["reads"]
    res = train(x, y, SVMConfig(shrinking="auto", working_set=0,
                                selection="second-order"), device="cpu")
    assert res.converged and tsmo.COUNTS["reads"] > reads
    tshrink.reset_run()
    fit(x, y, SVMConfig(shrinking="auto"), device="cpu")
    assert tshrink.RUN["active_sizes"] == []
