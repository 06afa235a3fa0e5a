"""The port's large-working-set decomposition (``solver/decomp.py``) on the
CPU, where the inner subsolve is its plain version, against the JAX
package's ``train_single_device_decomp``.

Bar, as for the fused path: the same n_iter and rounds, alpha within rtol
1e-4 / atol 1e-5, b within 1e-4, the same n_sv. JAX's rounds come from its
run trace, whose chunk records carry them.

Both sides are float32, but not bitwise: XLA on the CPU and PyTorch differ
in the last bit of some exp values, and XLA fuses the rank-q product's
multiply-adds. Those ulps move alpha by ~1e-5 after a thousand updates,
and a decomposition's trajectory then parts at the first near-tie of the
top-q/2 boundary or of a WSS2 argmax. So the bar holds for whole runs of a
few dozen rounds (blobs) and for the first 1000 updates of the planted
problems; their converged models are held to the JAX package's own
decomposition bar (tests/test_decomp.py: the true KKT gap recomputed in
float64) and the LibSVM bar (n_sv within 2% or 3, accuracy within one
example).
"""

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import split_train_test
from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs, make_planted, make_xor, save_csv
from dpsvm_tpu.solver import decomp as jdecomp
from dpsvm_tpu_torch import SVMConfig, evaluate, fit, train
from dpsvm_tpu_torch.convert import decomp_carry_from_numpy
from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
from dpsvm_tpu_torch.solver import decomp as tdecomp
from test_decomp import true_gap_and_b

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _jax(x, y, tmp_path, **cfg):
    """JAX's decomposition and its rounds (the last chunk record of its
    run trace)."""
    trace = tmp_path / "jax_trace.jsonl"
    res = jdecomp.train_single_device_decomp(
        x, y, JConfig(trace_out=str(trace), **cfg))
    chunks = [r for r in map(json.loads, trace.read_text().splitlines())
              if r.get("kind") == "chunk"]
    return res, chunks[-1]["rounds"]


def _assert_same_run(got, ref, ref_rounds):
    assert got.converged == ref.converged
    assert (got.n_iter, got.rounds) == (ref.n_iter, ref_rounds)
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)
    assert abs(got.b - ref.b) < 1e-4
    assert got.n_sv == ref.n_sv


BLOBS = dict(c=5.0, gamma=0.5, epsilon=1e-3, max_iter=100_000,
             working_set=32)
PLANTED = dict(c=10.0, gamma=0.5, epsilon=1e-3, max_iter=200_000)
VARIANTS = {
    "q32": dict(working_set=32),
    "q64": dict(working_set=64),
    "q32-pairwise": dict(working_set=32, clip="pairwise"),
    "q64-pairwise-weighted": dict(working_set=64, clip="pairwise",
                                  weight_pos=2.0, weight_neg=0.5),
    "q32-weighted": dict(working_set=32, weight_pos=2.0, weight_neg=0.5),
}


@pytest.mark.parametrize("extra", [
    {}, dict(clip="pairwise"), dict(weight_pos=2.0, weight_neg=0.5),
    dict(chunk_iters=64)], ids=["plain", "pairwise", "weighted", "chunk64"])
def test_blobs_whole_run_matches_jax(extra, tmp_path):
    x, y = make_blobs(n=240, d=5, seed=2)
    cfg = dict(BLOBS, **extra)
    got = train(x, y, SVMConfig(**cfg), device="cpu")
    ref, rounds = _jax(x, y, tmp_path, **cfg)
    assert got.converged
    _assert_same_run(got, ref, rounds)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_planted_prefix_matches_jax(name, tmp_path):
    x, y = make_planted(1200, 16, gamma=0.5, seed=4)
    cfg = dict(PLANTED, **VARIANTS[name], max_iter=1000)
    got = train(x, y, SVMConfig(**cfg), device="cpu")
    ref, rounds = _jax(x, y, tmp_path, **cfg)
    assert got.n_iter == 1000
    _assert_same_run(got, ref, rounds)


@pytest.mark.parametrize("name", ["q32", "q64-pairwise-weighted"])
def test_planted_converged_model_matches_jax(name, tmp_path):
    x, y = make_planted(1200, 16, gamma=0.5, seed=4)
    xtr, ytr, xte, yte = split_train_test(x, y)
    cfg = dict(PLANTED, **VARIANTS[name])
    jcfg = JConfig(**cfg)
    model, got = fit(xtr, ytr, SVMConfig(**cfg), device="cpu")
    ref = jdecomp.train_single_device_decomp(xtr, ytr, jcfg)
    assert got.converged and ref.converged
    gap, b = true_gap_and_b(xtr, ytr, got.alpha, C=jcfg.box_bound(ytr),
                            gamma=0.5)
    assert gap <= 2.0 * cfg["epsilon"] + 5e-4, gap
    assert abs(b - got.b) <= 1e-3
    assert abs(got.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)
    from dpsvm_tpu.models.svm import SVMModel as JModel, evaluate as jeval
    jmodel = JModel.from_train_result(xtr, ytr, ref)
    for xs, ys in ((xtr, ytr), (xte, yte)):
        assert abs(evaluate(model, xs, ys, device="cpu")
                   - jeval(jmodel, xs, ys)) <= 1.0 / len(ys) + 1e-9


def test_n_iter_stops_exactly_at_budget(tmp_path):
    x, y = make_planted(800, 16, gamma=0.5, seed=11)
    cfg = dict(c=10.0, gamma=0.5, epsilon=1e-6, max_iter=500,
               working_set=64)
    got = train(x, y, SVMConfig(**cfg), device="cpu")
    assert not got.converged and got.n_iter == 500
    ref, rounds = _jax(x, y, tmp_path, **cfg)
    _assert_same_run(got, ref, rounds)


def test_q_larger_than_n_degrades_as_in_jax(tmp_path):
    x, y = make_blobs(n=40, d=4, seed=0)
    cfg = dict(c=1.0, gamma=0.5, epsilon=1e-3, max_iter=50_000,
               working_set=512)
    got = train(x, y, SVMConfig(**cfg), device="cpu")
    ref, rounds = _jax(x, y, tmp_path, **cfg)
    assert got.converged
    _assert_same_run(got, ref, rounds)


def _assert_libsvm_parity(x, y, C, gamma, tol, name, **overrides):
    """tests/conftest.py's assert_libsvm_parity, with the port's fit."""
    from sklearn import svm as sklearn_svm
    xtr, ytr, xte, yte = split_train_test(x, y)
    ref = sklearn_svm.SVC(C=C, kernel="rbf", gamma=gamma, tol=tol)
    ref.fit(xtr, ytr)
    ref_nsv = int(ref.n_support_.sum())
    cfg = SVMConfig(c=C, gamma=gamma, epsilon=tol / 2.0, **overrides)
    model, result = fit(xtr, ytr, cfg, device="cpu")
    assert result.converged, name
    assert abs(model.n_sv - ref_nsv) <= max(0.02 * ref_nsv, 3.0), (
        f"{name}: n_sv={model.n_sv} vs libsvm {ref_nsv}")
    for xs, ys in ((xtr, ytr), (xte, yte)):
        acc = evaluate(model, xs, ys, device="cpu")
        assert abs(acc - float(ref.score(xs, ys))) <= 1.0 / len(ys) + 1e-9


@pytest.mark.parametrize("q", [16, 32])
def test_libsvm_parity_blobs_xor(q):
    x, y = make_blobs(n=300, d=6, seed=1)
    _assert_libsvm_parity(x, y, 1.0, 0.25, 1e-3, f"blobs/q={q}",
                          working_set=q)
    x, y = make_xor(n=300, seed=2)
    _assert_libsvm_parity(x, y, 10.0, 1.0, 1e-3, f"xor/q={q}",
                          working_set=q)


def test_carry_handed_over_from_jax_goes_on_alike():
    """One chunk in JAX, then the carry crosses as numpy arrays and one
    more chunk runs in each package."""
    import jax
    import jax.numpy as jnp
    from dpsvm_tpu.ops.kernels import KernelSpec, host_row_norms_sq
    x, y = make_planted(1200, 16, gamma=0.5, seed=4)
    cfg = SVMConfig(c=10.0, gamma=0.5, epsilon=1e-3, working_set=32)
    runner = jdecomp._build_decomp_runner(10.0, KernelSpec("rbf", 0.5),
                                          1e-3, 32, 32, "HIGHEST")
    args = (jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
            jnp.asarray(host_row_norms_sq(x)))
    jc = jax.tree.map(jnp.asarray, jdecomp.init_carry(y))
    jc, _ = runner(jc, *args, np.int32(256))
    mid = jax.tree.map(np.asarray, jc)
    assert int(mid.n_iter) == 256
    jc, _ = runner(jc, *args, np.int32(512))

    carry = decomp_carry_from_numpy(mid.alpha, mid.f, y, mid.b_hi, mid.b_lo,
                                    mid.n_iter, mid.rounds, device="cpu")
    prob = tdecomp.DecompProblem.build(x, y, cfg, CPU)
    run = tdecomp.make_runner(prob, cfg, 32, tdecomp.DecompWorkspace(CPU))
    carry, st = run(carry, 512)
    assert (st.n_iter, st.rounds) == (int(jc.n_iter), int(jc.rounds))
    np.testing.assert_allclose(carry.alpha.numpy(), np.asarray(jc.alpha),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(carry.f.numpy(), np.asarray(jc.f),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="entries"):
        decomp_carry_from_numpy(mid.alpha[:5], mid.f, y, 0, 0, 0, 0,
                                device="cpu")


def _grown(fn):
    """Run fn with verbose growth on; returns (result, q sequence)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        res = fn()
    return res, [int(q) for q in re.findall(r"-> q=(\d+)", err.getvalue())]


GROW = dict(c=10.0, gamma=0.5, epsilon=1e-3, max_iter=200_000,
            working_set=16, grow_working_set=True, verbose=True)


def test_growth_hook_decides_as_jax():
    """The growth manager alone, fed the same polls: it rebuilds at the
    same polls and to the same q as the JAX package's."""
    from dpsvm_tpu_torch.solver.driver import ChunkStats
    rng = np.random.default_rng(0)
    polls, n_iter, n_sv = [], 0, 4
    for _ in range(300):
        n_iter += int(rng.integers(1, 1500))
        n_sv += int(rng.integers(0, 60))
        polls.append((n_iter, n_sv))
    for n, q0 in ((5000, 16), (60000, 4096), (1_000_000, 512)):
        decided = []
        for pkg, cfg in ((jdecomp, JConfig(**GROW)),
                         (tdecomp, SVMConfig(**GROW))):
            built = []
            hook = pkg._make_growth_hook(
                dataclasses.replace(cfg, verbose=False), n, q0,
                lambda q: built.append(q) or q)
            swaps = [(it, hook(it, None, ChunkStats(it, 0.0, 0.0, sv, 0,
                                                    ())))
                     for it, sv in polls]
            decided.append(([s for s in swaps if s[1] is not None], built))
        assert decided[0] == decided[1] and decided[0][1], (n, q0)


def test_growth_follows_jax():
    """End to end, both packages grow through the same q. Past ~2000
    updates at small q the trajectories part at near-ties (see the module
    docstring), so the converged models are held to the model bar."""
    x, y = make_blobs(n=1000, d=5, seed=2)
    got, q_port = _grown(lambda: train(x, y, SVMConfig(**GROW),
                                       device="cpu"))
    ref, q_jax = _grown(lambda: jdecomp.train_single_device_decomp(
        x, y, JConfig(**GROW)))
    assert q_port == q_jax == [1000]
    assert got.converged and ref.converged
    assert abs(got.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)
    gap, _ = true_gap_and_b(x, y, got.alpha, C=10.0, gamma=0.5)
    assert gap <= 2e-3 + 5e-4, gap


def test_growth_swaps_the_runner_one_chunk_after_the_poll():
    """The JAX loop has already dispatched the next chunk when its hook
    runs; the port's driver keeps that schedule."""
    from dpsvm_tpu_torch.solver.driver import ChunkStats, host_training_loop
    calls = []

    def runner(tag):
        def run(carry, limit):
            calls.append((tag, limit))
            return carry, ChunkStats(limit, 1.0, 0.0, 0, 0, ())
        return run

    def hook(n_iter, carry, stats):
        return runner("grown") if n_iter == 20 else None

    cfg = SVMConfig(max_iter=50, chunk_iters=10, working_set=8)
    res = host_training_loop(cfg, 1.0, None, runner("first"),
                             lambda cr: (np.zeros(3), np.zeros(3)),
                             poll_hook=hook)
    assert res.n_iter == 50 and not res.converged
    assert calls == [("first", 10), ("first", 20), ("first", 30),
                     ("grown", 40), ("grown", 50)]


# working_set values around every bound validate() draws.
WS = [0, 2, 3, 4, 32, 2048, 2050, 16384, 16386]


@pytest.mark.parametrize("ws", WS)
def test_config_accepts_and_rejects_what_jax_does(ws):
    grid = dict(inner_iters=[0, 100, -1], grow_working_set=[False, True],
                use_pallas=["auto", "on", "off", "fast"],
                clip=["independent", "pairwise"], shards=[1, 2],
                selection=["first-order", "second-order"])
    keys = sorted(grid)
    for values in np.array(np.meshgrid(*[range(len(grid[k]))
                                         for k in keys])).T.reshape(-1,
                                                                    len(keys)):
        kw = {k: grid[k][i] for k, i in zip(keys, values)}
        outcome = []
        for cls in (JConfig, SVMConfig):
            try:
                cls(working_set=ws, **kw).validate()
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], (ws, kw, outcome)


def test_decomposition_scope_and_dispatch():
    x, y = make_blobs(n=40, d=3, seed=0)
    # shards > 1 routes to parallel/dist_decomp.py, which needs a group
    for kw in (dict(shards=2, kernel="linear"), dict(shards=2)):
        with pytest.raises(RuntimeError, match="launch_local"):
            train(x, y, SVMConfig(working_set=8, **kw), device="cpu")
    sk.reset_counts()
    res = train(x, y, SVMConfig(working_set=8), device="cpu")
    assert res.converged and res.rounds > 0
    assert sk.LAUNCHES == sk.RUNS == {"inner_subsolve": 0}
    assert train(x, y, SVMConfig(), device="cpu").rounds == 0


def _cli(args):
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}
    return subprocess.run([sys.executable, "-m", "dpsvm_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_trains_the_decomposition(tmp_path):
    x, y = make_blobs(n=160, d=5, seed=6)
    csv = str(tmp_path / "tr.csv")
    save_csv(csv, x, y)
    model = str(tmp_path / "m.svm")
    out = _cli(["train", "--device", "cpu", "-f", csv, "-m", model, "-c",
                "10", "-g", "0.2", "-q", "--working-set", "16",
                "--inner-iters", "8", "--clip", "pairwise", "--weight-pos",
                "2", "--weight-neg", "0.5"])
    assert out.returncode == 0, out.stderr
    assert "Number of SVs:" in out.stdout and "NOT converged" not in out.stdout
    assert Path(model).exists()
    # The pair takes the pairwise clip too (through the general pair).
    out = _cli(["train", "--device", "cpu", "-f", csv, "-m", model,
                "--clip", "pairwise", "-q"])
    assert out.returncode == 0 and "NOT converged" not in out.stdout
    out = _cli(["train", "--device", "cpu", "-f", csv, "-m", model,
                "--working-set", "16", "--weight-pos", "nan"])
    assert out.returncode == 2 and "finite" in out.stderr
