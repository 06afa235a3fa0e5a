"""The port's solver diagnostics (``ops/diagnostics.py``) and train's
``--check-kkt`` / ``--polish`` held to the JAX package's.

``optimality_report`` on the conftest problems against JAX's on the same
inputs: alpha with entries at 0, at C and inside the box (so both index
sets and the corners' exact tests are exercised), a scalar box and a
weighted per-example box, an intercept, RBF and a polynomial kernel. Each
package sums float32 kernel products in its own order, so the float64
host sums agree to REPORT_RTOL (relative to the largest term), not bit
for bit. Then ``dual_objective_and_gap`` / ``kkt_violation`` after the
JAX package's ``tests/test_diagnostics.py`` on a converged port fit; the
CLI's five ``--check-kkt`` lines against JAX's; ``--polish`` through the
CLI; and every conflict row of the two flags with JAX's exit code and
message (the shard-directory refusal too). Without CUDA the report
raises unless given ``device="cpu"``.
"""

from __future__ import annotations

import io
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401

# float64 sums over float32 kernel products in two summation orders: the
# products differ by ~1e-7 relative, the sums by at most that of the
# largest term.
REPORT_RTOL = 1e-5


def _alpha(n, c_vec, seed):
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    c_vec = np.broadcast_to(np.asarray(c_vec, np.float32), (n,))
    a = np.where(u < 0.3, 0.0, np.where(u < 0.5, c_vec,
                                        rng.random(n) * c_vec))
    return a.astype(np.float32)


def _problem(name, request):
    x, y = request.getfixturevalue(name)
    return np.asarray(x, np.float32), np.asarray(y)


CASES = [("blobs_small", "rbf", None), ("blobs_odd", "rbf", (1.0, 3.0)),
         ("xor_small", "poly", None), ("xor_small", "rbf", (2.0, 0.5))]


@pytest.mark.parametrize("problem, kind, weights", CASES,
                         ids=[f"{p}-{k}-{'w' if w else 'c'}"
                              for p, k, w in CASES])
def test_optimality_report_matches_jax(problem, kind, weights, request):
    from dpsvm_tpu.ops import kernels as jk
    from dpsvm_tpu.ops.diagnostics import optimality_report as jrep
    from dpsvm_tpu_torch.ops import kernels as tk
    from dpsvm_tpu_torch.ops.diagnostics import optimality_report as trep

    x, y = _problem(problem, request)
    c = 2.0
    c_vec = (c if weights is None else
             np.where(y > 0, c * weights[0], c * weights[1]).astype(
                 np.float32))
    alpha = _alpha(len(y), c_vec, seed=len(y))
    fields = dict(kind=kind, gamma=0.5, coef0=1.0, degree=3)
    got = trep(x, y, alpha, tk.KernelSpec(**fields), c_vec, b=0.125,
               block=32, device="cpu")
    want = jrep(x, y, alpha, jk.KernelSpec(**fields), c_vec, b=0.125,
                block=32)
    scale = max(abs(want.primal), abs(want.dual), 1.0)
    for k in ("dual", "primal", "gap", "eq_residual"):
        assert abs(getattr(got, k) - getattr(want, k)) <= REPORT_RTOL * \
            scale, (k, getattr(got, k), getattr(want, k))
    assert got.kkt_residual == pytest.approx(want.kkt_residual,
                                             abs=REPORT_RTOL * scale)


def test_the_report_needs_a_device_or_cpu(blobs_small):
    import torch

    from dpsvm_tpu_torch.ops.diagnostics import optimality_report
    x, y = blobs_small
    alpha = np.zeros(len(y), np.float32)
    if torch.cuda.is_available():
        pytest.skip("this check is of a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimality_report(x, y, alpha, 0.5, 1.0)
    rep = optimality_report(x, y, alpha, 0.5, 1.0, device="cpu")
    # alpha = 0: the dual is 0 and every hinge is active
    assert rep.dual == 0.0 and rep.gap == pytest.approx(1.0 * len(y))


@pytest.fixture(scope="module")
def solved():
    from dpsvm_tpu_torch import SVMConfig, train
    from dpsvm_tpu_torch.data.synthetic import make_blobs
    x, y = make_blobs(n=120, d=5, seed=9)
    cfg = SVMConfig(c=1.0, gamma=0.5, epsilon=1e-3, max_iter=20_000)
    res = train(x, y, cfg, device="cpu")
    assert res.converged
    return x, y, cfg, res


def test_gap_small_at_optimum_and_large_at_start(solved):
    from dpsvm_tpu_torch.ops.diagnostics import dual_objective_and_gap
    x, y, cfg, res = solved
    dual, primal, gap = dual_objective_and_gap(x, y, res.alpha, res.gamma,
                                               cfg.c, device="cpu")
    assert dual > 0 and primal >= dual - 1e-3
    assert gap / max(1.0, abs(primal)) < 0.05
    dual0, _, gap0 = dual_objective_and_gap(
        x, y, np.zeros(len(y), np.float32), cfg.gamma, cfg.c, device="cpu")
    assert dual0 == 0.0 and gap0 == pytest.approx(cfg.c * len(y), rel=1e-5)


def test_kkt_residual_matches_the_solver_certificate(solved):
    from dpsvm_tpu_torch.ops.diagnostics import kkt_violation
    x, y, cfg, res = solved
    viol = kkt_violation(x, y, res.alpha, res.gamma, cfg.c, device="cpu")
    assert viol <= 2 * cfg.epsilon + 5e-3
    assert viol == pytest.approx(res.b_lo - res.b_hi, abs=5e-3)


# ---------------------------------------------------------------------
# the CLI

def _run(main, args):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(args)
    return rc, out.getvalue()


def _csv(tmp_path, n=100, d=3, seed=4, name="t.csv"):
    from dpsvm_tpu_torch.data.synthetic import make_blobs
    x, y = make_blobs(n=n, d=d, seed=seed)
    path = str(tmp_path / name)
    with open(path, "w") as f:
        for xi, yi in zip(x, y):
            f.write(f"{int(yi)}," + ",".join(f"{v:.9g}" for v in xi)
                    + "\n")
    return path


KKT_LABELS = ("Dual objective:", "Primal objective:", "Duality gap:",
              "Equality residual sum(alpha*y):",
              "KKT residual (recomputed):")


def _kkt_lines(out):
    lines = [ln for ln in out.splitlines() if ln.startswith(KKT_LABELS)]
    return lines, [float(v) for ln in lines
                   for v in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", ln)]


def test_cli_check_kkt_prints_the_jax_lines(tmp_path):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    data = _csv(tmp_path)
    outs = {}
    for tag, main, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        rc, out = _run(main, ["train", "-f", data, "-m",
                              str(tmp_path / f"{tag}.svm"), "-c", "10",
                              "-g", "0.25", "--check-kkt", "-q", *extra])
        assert rc == 0
        outs[tag] = _kkt_lines(out)
    (jl, jv), (tl, tv) = outs["jax"], outs["port"]
    assert len(tl) == len(jl) == 5
    # the same five lines, label for label and word for word outside the
    # numbers
    strip = [re.sub(r"-?\d+\.\d+(?:e[-+]\d+)?", "#", ln) for ln in tl]
    assert strip == [re.sub(r"-?\d+\.\d+(?:e[-+]\d+)?", "#", ln)
                     for ln in jl]
    # the numbers: each package reports on its own fit, and the two fits
    # stop at different points of the eps = 1e-3 KKT band (the report
    # itself is held to JAX's on equal inputs above), so the objectives
    # agree to 1e-3 relative and the residuals sit in the band on both
    dual, primal, gap, eq, kkt, solver_gap, drift = tv
    np.testing.assert_allclose([dual, primal], jv[:2], rtol=1e-3)
    for g, k, sg, dr in ((gap, kkt, solver_gap, drift),
                         (jv[2], jv[4], jv[5], jv[6])):
        assert -1e-3 <= g < 1e-3 * abs(primal) + 0.1
        assert k <= 2e-3 + 5e-3 and sg <= 2e-3 and dr < 1e-3
    assert eq == pytest.approx(jv[3], rel=1e-2)


def test_cli_polish_trains_and_matches_jax(tmp_path):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    data = _csv(tmp_path, n=160, d=4, seed=7)
    got = {}
    for tag, main, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        model = str(tmp_path / f"{tag}.svm")
        rc, out = _run(main, ["train", "-f", data, "-m", model, "-c", "10",
                              "-g", "0.25", "--polish", "-q", *extra])
        assert rc == 0 and os.path.exists(model)
        got[tag] = [ln for ln in out.splitlines()
                    if ln.startswith(("Number of SVs", "Training accuracy"))]
    assert got["port"] == got["jax"]


CONFLICTS = [
    ["--solver", "approx-rff", "--check-kkt"],
    ["--solver", "approx-nystrom", "--check-kkt"],
    ["--multiclass", "--check-kkt"],
    ["-v", "3", "--check-kkt"],
    ["--svr", "--check-kkt"],
    ["--one-class", "--polish"],
    ["--nu-svc", "--check-kkt"],
    ["--nu-svr", "--polish"],
    ["--svr", "--polish"],
]


@pytest.mark.parametrize("flags", CONFLICTS, ids=" ".join)
def test_cli_conflicts_match_jax(flags, tmp_path, capsys):
    """Each row of the JAX CLI's conflict table for --check-kkt and
    --polish: the same exit code and message, before the data is read."""
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    data = _csv(tmp_path, n=30, seed=0)
    args = ["train", "-f", data, "-m", str(tmp_path / "m"), "-q", *flags]
    got = []
    for main, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        rc = main(args + extra)
        got.append((rc, capsys.readouterr().err.strip().splitlines()[-1]))
    assert got[0][0] == 2 and got[1] == got[0], got


def test_cli_check_kkt_refused_on_a_shard_directory(tmp_path, capsys):
    from dpsvm_tpu.cli import main as jmain
    from dpsvm_tpu_torch.cli import main as tmain
    data = _csv(tmp_path, n=60, seed=2)
    shards = str(tmp_path / "shards")
    assert tmain(["convert", "shards", data, shards,
                  "--rows-per-shard", "32"]) == 0
    capsys.readouterr()
    args = ["train", "-f", shards, "-m", str(tmp_path / "m.svm"),
            "--solver", "cascade", "--check-kkt", "-q"]
    got = []
    for main, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        rc = main(args + extra)
        got.append((rc, capsys.readouterr().err.strip().splitlines()[-1]))
    assert got[0][0] == 2 and got[1] == got[0], got
    assert "streaming shard training never materializes" in got[1][1]

