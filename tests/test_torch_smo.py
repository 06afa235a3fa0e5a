"""The port's general SMO pair (``solver/smo.py``) on the CPU, where a chunk
is the eager loop of ``smo_step``, against the JAX package: one step from a
common carry against the JAX ``smo_step``, whole runs against the NumPy
oracle ``smo_reference``, and the entry points (routing, ``warm_start``,
``polish``, the CLI) around it.

Bars, and why:

* one step, every branch x kind: the same (i_hi, i_lo) and alpha bit for
  bit, the same b's; f within 1e-6 * max(1, |f|). The port rounds each of
  f's two products before its sum, as the oracle does, where XLA contracts
  them into FMAs; second-order's one-row products also sum in their own
  order;
* the linear kernel's whole runs: the oracle's (i_hi, i_lo) sequence and
  n_iter, exactly (its kernel values are the dots themselves);
* the other kinds' whole runs: the repo's LibSVM bar against the oracle
  (n_sv within 2% or 3, train and held-out accuracy within one example),
  and with the pairwise clip decision values within 5e-3. Under the
  independent clip sum(alpha y) drifts and the converged model depends on
  the trajectory (ROADMAP Queue 3): poly's kernel values are FMAs and
  ``integer_pow`` here, the oracle's numpy ``**``, so such runs part at a
  near-tie and land on models whose decisions differ at the 1e-2 level.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs, make_planted, make_xor
from dpsvm_tpu.data.synthetic import save_csv
from dpsvm_tpu.ops.kernels import host_row_stats as j_row_stats
from dpsvm_tpu.solver import smo as jsmo
from dpsvm_tpu.solver.oracle import smo_reference
from dpsvm_tpu_torch import SVMConfig, evaluate, fit, train, warm_start
from dpsvm_tpu_torch.convert import smo_carry_from_numpy
from dpsvm_tpu_torch.models.svm import SVMModel, decision_function
from dpsvm_tpu_torch.solver import decomp as tdecomp
from dpsvm_tpu_torch.solver import smo as tsmo

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

BRANCHES = {
    "first-order": {},
    "packed": dict(select_impl="packed"),
    "second-order": dict(selection="second-order"),
    "weighted": dict(weight_pos=2.0, weight_neg=0.5),
    "pairwise": dict(clip="pairwise"),
    "second-order-pairwise": dict(selection="second-order", clip="pairwise"),
    "guard_eta": {},
}
KINDS = {
    "linear": dict(kernel="linear"),
    "poly": dict(kernel="poly", degree=3, coef0=1.0, gamma=1 / 40),
    "rbf": dict(kernel="rbf", gamma=0.25),
    "sigmoid": dict(kernel="sigmoid", gamma=0.5 / 40, coef0=-1.0),
    "precomputed": dict(kernel="precomputed"),
}


def _planted(kind="rbf"):
    """Planted 150 + 40 rows of width 40 (for precomputed: the RBF matrix
    of them at gamma 0.25, and K(test, train))."""
    x, y = make_planted(190, 40, 0.25, seed=2)
    xtr, ytr, xte, yte = x[:150], y[:150], x[150:], y[150:]
    if kind == "precomputed":
        k = lambda a, b: np.exp(-0.25 * ((a[:, None].astype(np.float64)
                                          - b[None]) ** 2).sum(-1))
        xtr, xte = k(xtr, xtr).astype(np.float32), k(xte, xtr).astype(
            np.float32)
    return xtr, ytr, xte, yte


def _cfg(kind, branch, cls=SVMConfig, **kw):
    return cls(**{"c": 1.0, "epsilon": 1e-3, "max_iter": 50_000,
                  **KINDS[kind], **BRANCHES[branch], **kw})


# ------------------------------------------------------------ single steps

@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_single_step_matches_jax(branch, kind):
    """One smo_step from a mid-run carry (alpha at 0, at C and inside, f
    off -y) against the JAX smo_step at HIGHEST."""
    x, y, _, _ = _planted(kind)
    n = len(y)
    rng = np.random.default_rng(7)
    jc, tc = _cfg(kind, branch, JConfig), _cfg(kind, branch)
    box = np.broadcast_to(np.asarray(tc.box_bound(y), np.float32), (n,))
    alpha = np.where(rng.random(n) < 0.3, box,
                     rng.choice([0.0, 0.5], n) * box).astype(np.float32)
    f = (-y + rng.normal(0, 0.3, n)).astype(np.float32)
    kspec = jc.kernel_spec(x.shape[1])
    guard = branch == "guard_eta"
    jstep = jax.jit(lambda c: jsmo.smo_step(
        c, jnp.asarray(x), jnp.asarray(y, jnp.float32),
        jnp.asarray(j_row_stats(x, kspec)), float(jc.c), kspec,
        second_order=jc.selection == "second-order",
        weights=(jc.weight_pos, jc.weight_neg),
        packed_select=jc.select_impl == "packed",
        pairwise_clip=jc.clip == "pairwise", guard_eta=guard))
    want = jstep(jsmo.SMOCarry(jnp.asarray(alpha), jnp.asarray(f),
                               jnp.float32(-1e9), jnp.float32(1e9),
                               jnp.int32(0), jsmo.cache_init(0, n)))
    prob = tsmo.SMOProblem.build(x, y, tc, CPU)
    carry = smo_carry_from_numpy(alpha, f, y, -1e9, 1e9, 0, device="cpu")
    got = tsmo.smo_step(carry, prob, tsmo.SMOOptions.from_config(tc, guard))
    assert np.array_equal(got.alpha.numpy(), np.asarray(want.alpha))
    assert float(got.b_hi) == float(want.b_hi)
    assert float(got.b_lo) == float(want.b_lo)
    assert int(got.n_iter) == 1
    fw = np.asarray(want.f)
    assert np.abs(got.f.numpy() - fw).max() <= 1e-6 * max(1.0,
                                                          np.abs(fw).max())


# --------------------------------------------------------------- whole runs

def _port_trace(x, y, cfg):
    """(i_hi, i_lo) of every body of the eager loop, and the final carry."""
    prob = tsmo.SMOProblem.build(x, y, cfg, CPU)
    carry, opts, trace = tsmo.init_carry(prob.y), tsmo.SMOOptions.from_config(
        cfg), []
    while bool(tsmo.live(carry, tsmo.two_eps_f32(cfg.epsilon),
                         cfg.max_iter)):
        u = tsmo.pair_update(carry, prob, opts)
        trace.append((int(u.i_hi), int(u.i_lo)))
        carry = tsmo.smo_step(carry, prob, opts)
    return trace, carry


LINEAR_PROBLEMS = {
    "planted": lambda: _planted()[:2],
    "blobs": lambda: make_blobs(n=96, d=6, seed=3),
    "d130": lambda: make_blobs(n=90, d=130, seed=5),
    "xor": lambda: make_xor(n=120, seed=1),
}


LINEAR_RUNS = [(p, b) for p in sorted(LINEAR_PROBLEMS)
               for b in ("first-order", "weighted", "pairwise")] + [
    # Second-order's one-row products (the hi row, then the partner's)
    # sum in another order than NumPy's gemv, and the rank-6 blobs and the
    # xor data give the WSS2 objective near-ties that those ulps flip (at
    # body 10 and 104); these two problems have none.
    ("planted", "second-order"), ("d130", "second-order")]


@pytest.mark.parametrize("problem,branch", LINEAR_RUNS)
def test_linear_run_follows_the_oracle(problem, branch):
    x, y = LINEAR_PROBLEMS[problem]()
    trace, carry = _port_trace(x, y, _cfg("linear", branch))
    ref_trace = []
    ref = smo_reference(x, y, _cfg("linear", branch, JConfig),
                        trace=ref_trace)
    assert trace == [(a, b) for a, b, _, _ in ref_trace]
    assert int(carry.n_iter) == ref.n_iter
    got = train(x, y, _cfg("linear", branch, chunk_iters=64), device="cpu")
    assert got.n_iter == ref.n_iter and got.converged == ref.converged
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)


def _accuracy_within_one(model_a, model_b, x, y):
    a = evaluate(model_a, x, y, device="cpu")
    b = evaluate(model_b, x, y, device="cpu")
    assert abs(a - b) <= 1.0 / len(y) + 1e-9, (a, b)


@pytest.mark.parametrize("kind", ["poly", "rbf", "sigmoid"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_whole_run_meets_the_bar(branch, kind):
    xtr, ytr, xte, yte = _planted(kind)
    guard = branch == "guard_eta"
    got = train(xtr, ytr, _cfg(kind, branch, chunk_iters=256),
                device="cpu", guard_eta=guard)
    ref = smo_reference(xtr, ytr, _cfg(kind, branch, JConfig),
                        guard_eta=guard)
    assert got.converged and ref.converged
    assert abs(got.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)
    mg = SVMModel.from_train_result(xtr, ytr, got)
    mr = SVMModel.from_train_result(xtr, ytr, ref)
    for x, y in ((xtr, ytr), (xte, yte)):
        _accuracy_within_one(mg, mr, x, y)
    if "pairwise" in branch:
        dg = decision_function(mg, xte, device="cpu")
        dr = decision_function(mr, xte, device="cpu")
        assert np.abs(dg - dr).max() <= 5e-3


@pytest.mark.parametrize("branch", ["first-order", "second-order",
                                    "pairwise"])
def test_precomputed_run_matches_jax_and_the_rbf_model(branch):
    """The oracle has no precomputed kernel: a precomputed run is held to
    the JAX package's precomputed run (the LibSVM bar, decisions within
    5e-3) and its model to the port's RBF model on the same rows."""
    from dpsvm_tpu.api import train as jtrain
    xtr, ytr, xte, yte = _planted("precomputed")
    got = train(xtr, ytr, _cfg("precomputed", branch), device="cpu")
    ref = jtrain(xtr, ytr, _cfg("precomputed", branch, JConfig))
    assert got.converged and ref.converged
    assert abs(got.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)
    mg = SVMModel.from_train_result(xtr, ytr, got)
    mr = SVMModel.from_train_result(xtr, ytr, ref)
    assert mg.num_attributes == 150 and np.array_equal(
        mg.sv_idx, np.flatnonzero(ref.alpha > 0))
    dg = decision_function(mg, xte, device="cpu")
    assert np.abs(dg - decision_function(mr, xte, device="cpu")).max() \
        <= 5e-3
    # the same rows through the RBF kernel
    rtr, rytr, rte, _ = _planted("rbf")
    mrbf, _ = fit(rtr, rytr, _cfg("rbf", branch), device="cpu")
    assert abs(mg.n_sv - mrbf.n_sv) <= max(0.02 * mrbf.n_sv, 3)
    assert np.abs(dg - decision_function(mrbf, rte, device="cpu")).max() \
        <= 5e-3 if "pairwise" in branch else True


def test_bf16_general_pair_trains():
    xtr, ytr, xte, yte = _planted()
    for branch in ("second-order", "weighted"):
        model, res = fit(xtr, ytr, _cfg("rbf", branch,
                                        matmul_precision="default"),
                         device="cpu")
        ref, _ = fit(xtr, ytr, _cfg("rbf", branch), device="cpu")
        assert res.converged
        assert abs(model.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)
        _accuracy_within_one(model, ref, xte, yte)


def test_jax_carry_continues_on_the_same_trajectory():
    """A JAX SMOCarry taken mid-run (40 iterations of the general pair)
    goes on in the port along the JAX run's trajectory."""
    x, y, _, _ = _planted()
    jc = _cfg("linear", "second-order", JConfig, chunk_iters=64)
    kspec = jc.kernel_spec(x.shape[1])
    run = jsmo._build_chunk_runner(1.0, kspec, 1e-3, False, "HIGHEST",
                                   True)
    args = (jnp.asarray(x), jnp.asarray(y, jnp.float32),
            jnp.asarray(j_row_stats(x, kspec)))
    mid, _ = run(jax.device_put(jsmo.init_carry(y, 0)), *args,
                 np.int32(40))
    carry = smo_carry_from_numpy(np.asarray(mid.alpha), np.asarray(mid.f), y,
                                 np.asarray(mid.b_hi), np.asarray(mid.b_lo),
                                 np.asarray(mid.n_iter), device="cpu")
    assert int(carry.n_iter) == 40
    got = tsmo.train_single_device(x, y, _cfg("linear", "second-order",
                                              chunk_iters=64), CPU,
                                   carry=carry)
    ref = jsmo.train_single_device(x, y, jc)
    assert got.n_iter == ref.n_iter and got.converged
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- entry points

def _path_counts():
    return tsmo.COUNTS["reads"], tdecomp.READS["stats"]


ROUTES = [
    # (config kwargs, train kwargs, expected path)
    (dict(), {}, "fused"),
    (dict(matmul_precision="default"), {}, "fused"),
    (dict(selection="second-order"), {}, "pair"),
    (dict(clip="pairwise"), {}, "pair"),
    (dict(weight_pos=2.0), {}, "pair"),
    # packed selection gives argminmax's answer, and the fused kernel has
    # its own: the fused envelope does not look at select_impl
    (dict(select_impl="packed"), {}, "fused"),
    (dict(select_impl="packed", kernel="linear"), {}, "pair"),
    (dict(), dict(guard_eta=True), "pair"),
    (dict(), dict(f_init=True), "pair"),
    (dict(), dict(alpha_init=True), "pair"),
    (dict(kernel="linear"), {}, "pair"),
    (dict(kernel="poly"), {}, "pair"),
    (dict(kernel="sigmoid", coef0=-1.0), {}, "pair"),
    (dict(kernel="precomputed"), {}, "pair"),
    (dict(working_set=8), {}, "decomp"),
    (dict(working_set=8, kernel="linear"), {}, "decomp"),
    (dict(working_set=8, kernel="poly"), {}, "decomp"),
    (dict(working_set=8, kernel="sigmoid", coef0=-1.0), {}, "decomp"),
    (dict(working_set=8, kernel="precomputed"), {}, "decomp"),
    (dict(working_set=8), dict(f_init=True), "decomp"),
    (dict(working_set=0, selection="second-order"), {}, "pair"),
]


@pytest.mark.parametrize("cfg,kw,path", ROUTES,
                         ids=[f"{i}-{r[2]}" for i, r in enumerate(ROUTES)])
def test_routing(cfg, kw, path):
    x, y = make_blobs(n=60, d=4, seed=1)
    if cfg.get("kernel") == "precomputed":
        x = (x @ x.T).astype(np.float32)
    yf = np.asarray(y, np.float32)
    kw = dict(kw)
    if kw.pop("f_init", False):
        kw["f_init"] = -yf
    if kw.pop("alpha_init", False):
        kw["alpha_init"] = np.zeros_like(yf)
    before = _path_counts()
    res = train(x, y, SVMConfig(c=1.0, **cfg), device="cpu", **kw)
    pair, decomp = (a - b for a, b in zip(_path_counts(), before))
    assert res.converged and res.kernel == cfg.get("kernel", "rbf")
    assert {"fused": (0, 0), "pair": (pair, 0), "decomp": (0, decomp)}[
        path] == (pair, decomp) and (path == "fused" or pair + decomp > 0)


@pytest.mark.parametrize("cfg,why", [
    (dict(shards=2), "shards=2 needs an initialized process group"),
    (dict(shards=2, selection="second-order"), ".*launch_local"),
    (dict(shards=2, working_set=8), ".*torchrun"),
    (dict(shards=2, cache_size=4), ".*--shards 2"),
    (dict(shards=2, cache_size=4, kernel="poly"), ".*multihost.initialize"),
])
def test_what_no_path_covers_raises_naming_it(cfg, why):
    """shards > 1 routes to parallel/: without a process group it raises,
    naming the ways to start one."""
    x, y = make_blobs(n=40, d=3, seed=0)
    with pytest.raises(RuntimeError, match=why):
        train(x, y, SVMConfig(**cfg), device="cpu")


def test_validation_matches_jax():
    """The new fields' rules, message for message."""
    cases = [dict(kernel="poly", degree=0),
             dict(select_impl="fast"),
             dict(select_impl="packed", selection="second-order"),
             dict(select_impl="packed", use_pallas="on"),
             dict(kernel="precomputed", cache_size=2),
             dict(kernel="precomputed", use_pallas="on"),
             dict(select_impl="packed", working_set=8),
             dict(kernel="poly", degree=2, polish=True),
             dict(kernel="sigmoid", coef0=-2.0)]
    for kw in cases:
        outcome = []
        for cls in (JConfig, SVMConfig):
            try:
                cls(**kw).validate()
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], (kw, outcome)


def test_precomputed_needs_a_square_matrix():
    x, y = make_blobs(n=40, d=3, seed=0)
    with pytest.raises(ValueError, match="square"):
        train(x, y, SVMConfig(kernel="precomputed"), device="cpu")


def test_warm_start_lands_on_the_uncapped_model():
    xtr, ytr, xte, _ = _planted()
    # (the decomposition with the pairwise clip: under the independent
    # clip its converged b's differ by ~0.1 between trajectories)
    for kw in (dict(), dict(working_set=16, inner_iters=8,
                            clip="pairwise")):
        cfg = SVMConfig(c=4.0, gamma=0.25, max_iter=50_000, **kw)
        full = train(xtr, ytr, cfg, device="cpu")
        capped = train(xtr, ytr, SVMConfig(c=4.0, gamma=0.25, max_iter=20,
                                           **kw), device="cpu")
        assert full.converged and not capped.converged
        cont = warm_start(xtr, ytr, capped.alpha, cfg, device="cpu")
        assert cont.converged and abs(cont.b - full.b) < 5e-3
        mf = SVMModel.from_train_result(xtr, ytr, full)
        mc = SVMModel.from_train_result(xtr, ytr, cont)
        assert np.abs(decision_function(mf, xte, device="cpu")
                      - decision_function(mc, xte, device="cpu")).max() \
            < 5e-2
        again = warm_start(xtr, ytr, full.alpha, cfg, device="cpu")
        assert again.converged and again.n_iter <= 10


def test_warm_start_f_matches_jax():
    """The streamed K . (alpha y) pass for each kind: the f a warm start
    resumes from, against the JAX package's (same inputs, float32 sums
    of another order)."""
    from dpsvm_tpu.ops.diagnostics import _stream_kv as j_kv
    from dpsvm_tpu_torch.ops.diagnostics import _stream_kv as t_kv
    rng = np.random.default_rng(0)
    for kind in sorted(KINDS):
        x, y, _, _ = _planted(kind)
        coef = (rng.uniform(0, 1, len(y)) * y).astype(np.float32)
        spec = _cfg(kind, "first-order").kernel_spec(x.shape[1])
        jspec = _cfg(kind, "first-order", JConfig).kernel_spec(x.shape[1])
        got = t_kv(x, coef, spec, block=64, device=CPU)
        want = j_kv(x, coef, jspec, block=64)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_warm_start_guards():
    x, y, _, _ = _planted()
    with pytest.raises(ValueError, match="feasible"):
        warm_start(x, y, np.full(len(y), 2.0, np.float32), SVMConfig(c=1.0),
                   device="cpu")
    with pytest.raises(ValueError, match="alpha must be"):
        warm_start(x, y, np.zeros(3, np.float32), device="cpu")
    with pytest.raises(ValueError, match="refinement mechanism"):
        warm_start(x, y, np.zeros(len(y), np.float32),
                   SVMConfig(polish=True), device="cpu")


def test_polish():
    """The fast phase (bfloat16 X, the fused pair for this RBF config),
    then the exact warm start: the model of a plain float32 run."""
    xtr, ytr, xte, yte = _planted()
    cfg = SVMConfig(c=4.0, gamma=0.25, max_iter=50_000)
    reads = tsmo.COUNTS["reads"]
    pol = train(xtr, ytr, SVMConfig(c=4.0, gamma=0.25, max_iter=50_000,
                                    polish=True), device="cpu")
    assert tsmo.COUNTS["reads"] > reads        # the refinement: the pair
    ref = train(xtr, ytr, cfg, device="cpu")
    assert pol.converged and abs(pol.n_sv - ref.n_sv) <= max(
        0.02 * ref.n_sv, 3)
    mp = SVMModel.from_train_result(xtr, ytr, pol)
    mr = SVMModel.from_train_result(xtr, ytr, ref)
    _accuracy_within_one(mp, mr, xte, yte)
    with pytest.raises(ValueError, match="plain classification init"):
        train(xtr, ytr, SVMConfig(polish=True), device="cpu",
              f_init=-np.asarray(ytr, np.float32))
    # a budget the fast phase uses up: its result, with a warning
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        short = train(xtr, ytr, SVMConfig(c=4.0, gamma=0.25, max_iter=30,
                                          polish=True), device="cpu")
    assert short.n_iter == 30 and not short.converged


# ------------------------------------------------------------------ the CLI

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "dpsvm_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def _train_line(out, key):
    return [ln for ln in out.splitlines() if ln.startswith(key)]


def test_cli_kernel_flags_end_to_end(tmp_path):
    """``-t poly -d 2 -r 1 --selection second-order`` (and ``-t 1`` for
    the same kernel) trains the general pair; the file carries the
    kernel header and tests back in both packages."""
    from dpsvm_tpu.cli import main as jax_main
    xtr, ytr, xte, yte = _planted()
    tr, te = str(tmp_path / "tr.csv"), str(tmp_path / "te.csv")
    save_csv(tr, xtr, ytr)
    save_csv(te, xte, yte)
    outs = []
    for t in ("poly", "1"):
        model = str(tmp_path / f"m{t}.svm")
        out = _cli("train", "--device", "cpu", "-f", tr, "-m", model, "-c",
                   "1", "-t", t, "-d", "2", "-r", "1", "-g", "0.025",
                   "--selection", "second-order", "-q")
        assert out.returncode == 0, out.stderr
        assert "NOT converged" not in out.stdout
        outs.append(open(model).read())
        assert outs[-1].startswith("kernel poly 0.025 1 2\n")
    assert outs[0] == outs[1]
    got = _cli("test", "--device", "cpu", "-f", te, "-m", model)
    assert got.returncode == 0, got.stderr
    assert jax_main(["test", "-f", te, "-m", model]) == 0
    out = _cli("train", "--device", "cpu", "-f", tr, "-m", model,
               "-t", "linear", "--select-impl", "packed", "-q")
    assert out.returncode == 0, out.stderr
    bad = _cli("train", "--device", "cpu", "-f", tr, "-m", model, "-t", "7")
    assert bad.returncode == 2 and "not a kernel" in bad.stderr


def test_cli_precomputed_kernel_csv(tmp_path):
    """``-t 4``: the training CSV's rows are K's, the test CSV's
    K(test, train)'s; the port's test accuracy is the JAX CLI's on the same
    file."""
    from dpsvm_tpu.cli import main as jax_main
    ktr, ytr, kte, yte = _planted("precomputed")
    tr, te = str(tmp_path / "ktr.csv"), str(tmp_path / "kte.csv")
    save_csv(tr, ktr, ytr)
    save_csv(te, kte, yte)
    model = str(tmp_path / "k.svm")
    out = _cli("train", "--device", "cpu", "-f", tr, "-m", model, "-t", "4",
               "-c", "1", "-q")
    assert out.returncode == 0, out.stderr
    assert open(model).readline().startswith("kernel precomputed ")
    got = _cli("test", "--device", "cpu", "-f", te, "-m", model)
    assert got.returncode == 0, got.stderr
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_main(["test", "-f", te, "-m", model]) == 0
    acc = _train_line(got.stdout, "Test accuracy:")
    assert acc and acc[0] in buf.getvalue().splitlines()
    wrong = _cli("test", "--device", "cpu", "-f", tr, "-m", model)
    assert wrong.returncode == 0               # K(train, train): 150 wide
    narrow = str(tmp_path / "narrow.csv")
    save_csv(narrow, kte[:, :20], yte)
    assert _cli("test", "--device", "cpu", "-f", narrow,
                "-m", model).returncode == 2
