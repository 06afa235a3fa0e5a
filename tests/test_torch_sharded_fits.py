"""The sharded approx solvers and the sharded cascade over two gloo CPU
ranks (``parallel.multihost.launch_local``), held to two oracles.

The JAX package's own sharded approx path fails on this container's JAX
(``ShardingTypeError`` in ``approx/primal.py``), so it is not the oracle.
Instead:

* the port's ``shards=1`` fit of the same rows, at n >= ``_FULLBATCH_ROWS``
  (2048), where both take full-batch steps: the same steps with the
  products' float32 sums split over the ranks, so the weights and the
  held-out decisions agree within SHARD_RTOL of their largest and the
  step counts within SHARD_ITER_TOL;
* the JAX package's ``shards=1`` fit, by the approx bar of
  ``tests/test_torch_approx.py`` (decisions within 5e-3, held-out accuracy
  within one example, steps within 5%).

The cascade (its approx stage and polish over the ranks, the probe with
``shards=1``): zero violators, and its model within the bar between
paths (n_sv within 2%, held-out accuracy within 0.5%) of the port's
``shards=1`` cascade and of the JAX package's. Every rank returns the same
model; rank 0 alone writes the trace and the checkpoint. The ranks start
once for the file (``tests/torch_dist_scenarios.py``). Without CUDA the
sharded fit raises unless its device is the CPU.

The JAX package's mid-scale parity test (8192 x 16 blobs at 8 shards
against one device, ``tests/test_distributed.py``) runs over eight gloo
ranks and is marked ``slow``, as in JAX.
"""

from __future__ import annotations

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

import torch_dist_scenarios as tds
from torch_threads import one_thread  # noqa: F401

# float32 sums of the (D + 1)-gradient split over two ranks, carried over
# ~300 momentum steps: 1.1e-7 of max |w| measured at 2100 rows.
SHARD_RTOL, SHARD_ITER_TOL = 1e-5, 0.01
# the approx bar against the JAX package (tests/test_torch_approx.py)
JAX_DEC_TOL, JAX_ITER_TOL = 5e-3, 0.05


def _blobs(n, d=16, seed=3, held=300, task="svc"):
    from dpsvm_tpu_torch.data.synthetic import make_blobs
    x, y = make_blobs(n=n + held, d=d, seed=seed)
    if task == "svr":
        rng = np.random.default_rng(1)
        y = (np.sin(x[:, 0]) + 0.1 * rng.standard_normal(len(x))).astype(
            np.float32)
    return x[:n], y[:n], x[n:], y[n:]


FITS = {
    "rff": dict(task="svc", n=2100,
                cfg=dict(solver="approx-rff", approx_dim=256, c=5.0,
                         gamma=1.0 / 16, epsilon=1e-3, max_iter=20_000)),
    "nystrom-svr": dict(task="svr", n=2200,
                        cfg=dict(solver="approx-nystrom", approx_dim=128,
                                 c=5.0, gamma=1.0 / 16, epsilon=1e-3,
                                 svr_epsilon=0.1, max_iter=20_000)),
}
CASC = dict(n=600, cfg=dict(solver="cascade", approx_dim=256, c=10.0,
                            gamma=0.25, epsilon=1e-3))
# the cascade whose polish is the decomposition (the distributed one over
# the ranks)
CASC_DECOMP = dict(CASC["cfg"], working_set=128, inner_iters=32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks, every scenario of the file in one launch."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    scen, data = [], {}
    for name, f in FITS.items():
        x, y, xt, yt = _blobs(f["n"], task=f["task"])
        data[name] = (x, y, xt, yt)
        scen.append(dict(name=name, what="approx", task=f["task"], x=x,
                         y=y, x_test=xt, cfg=f["cfg"]))
    x, y, xt, yt = _blobs(CASC["n"], d=8, seed=5)
    data["cascade"] = (x, y, xt, yt)
    scen.append(dict(name="cascade", what="cascade", x=x, y=y, x_test=xt,
                     cfg=CASC["cfg"]))
    scen.append(dict(name="cascade-decomp", what="cascade", x=x, y=y,
                     x_test=xt, cfg=CASC_DECOMP))
    x, y, xt, yt = data["rff"]
    traced = dict(FITS["rff"]["cfg"], trace_out=os.path.join(
        tmp, "trace.jsonl"), checkpoint_path=os.path.join(tmp, "ck.npz"),
        checkpoint_every=64)
    scen.append(dict(name="rff-traced", what="approx", x=x, y=y,
                     x_test=xt, cfg=traced))
    scen.append(dict(name="cascade-traced", what="cascade",
                     x=data["cascade"][0], y=data["cascade"][1],
                     cfg=dict(CASC["cfg"], trace_out=os.path.join(
                         tmp, "casc.jsonl"))))
    return tds.launch(2, scen), data, tmp


def _port_one(name, data):
    from dpsvm_tpu_torch.approx.primal import fit_approx
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.models.svm import decision_function
    f = FITS[name]
    x, y, xt, _ = data[name]
    model, res = fit_approx(x, y, SVMConfig(**f["cfg"]), task=f["task"],
                            device="cpu")
    w = np.concatenate([model.w, [model.b]]).astype(np.float32)
    return res, w, np.asarray(decision_function(model, xt, device="cpu"))


def _jax_one(name, data):
    from dpsvm_tpu.approx.primal import fit_approx
    from dpsvm_tpu.config import SVMConfig
    from dpsvm_tpu.models.svm import decision_function
    f = FITS[name]
    x, y, xt, _ = data[name]
    model, res = fit_approx(x, y, SVMConfig(**f["cfg"]), task=f["task"])
    return res, np.asarray(decision_function(model, xt))


def _metric(name, dec, yt):
    if FITS[name]["task"] == "svc":
        return float(np.mean(np.where(dec < 0, -1, 1) == yt))
    return float(np.mean((dec - yt) ** 2))


@pytest.mark.parametrize("name", list(FITS))
def test_sharded_approx_against_the_ports_one_shard(name, ranks):
    got, data, _ = ranks
    r = got[name]
    assert "exception" not in r, r.get("exception")
    assert r["ranks_agree"] and r["converged"]
    res, w, dec = _port_one(name, data)
    assert res.converged
    assert abs(r["n_iter"] - res.n_iter) <= SHARD_ITER_TOL * res.n_iter
    np.testing.assert_allclose(r["alpha"], w, rtol=0,
                               atol=SHARD_RTOL * np.abs(w).max())
    np.testing.assert_allclose(r["dec"], dec, rtol=0,
                               atol=SHARD_RTOL * np.abs(dec).max())


@pytest.mark.parametrize("name", list(FITS))
def test_sharded_approx_against_jax_one_shard(name, ranks):
    got, data, _ = ranks
    r = got[name]
    res, dec = _jax_one(name, data)
    yt = data[name][3]
    np.testing.assert_allclose(r["dec"], dec, rtol=0, atol=JAX_DEC_TOL)
    assert abs(r["n_iter"] - int(res.n_iter)) <= JAX_ITER_TOL * int(
        res.n_iter)
    if FITS[name]["task"] == "svc":
        assert abs(_metric(name, r["dec"], yt)
                   - _metric(name, dec, yt)) <= 1.0 / len(yt) + 1e-9
    else:
        assert _metric(name, r["dec"], yt) == pytest.approx(
            _metric(name, dec, yt), rel=1e-2)


def _cascade_one(pkg, data, cfg):
    x, y, xt, yt = data["cascade"]
    if pkg == "port":
        from dpsvm_tpu_torch.config import SVMConfig
        from dpsvm_tpu_torch.models.svm import decision_function
        from dpsvm_tpu_torch.solver.cascade import fit_cascade
        model, res = fit_cascade(x, y, SVMConfig(**cfg), device="cpu")
        dec = decision_function(model, xt, device="cpu")
    else:
        from dpsvm_tpu.config import SVMConfig
        from dpsvm_tpu.models.svm import decision_function
        from dpsvm_tpu.solver.cascade import fit_cascade
        model, res = fit_cascade(x, y, SVMConfig(**cfg))
        dec = decision_function(model, xt)
    dec = np.asarray(dec)
    return (int(model.n_sv), float(np.mean(np.where(dec < 0, -1, 1) == yt)),
            res)


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("name", ["cascade", "cascade-decomp"])
def test_sharded_cascade_meets_the_bar_between_paths(name, pkg, ranks):
    got, data, _ = ranks
    r = got[name]
    assert "exception" not in r, r.get("exception")
    assert r["ranks_agree"] and r["converged"] and r["kkt_violators"] == 0
    n_sv = int((r["alpha"] > 0).sum())
    yt = data["cascade"][3]
    acc = float(np.mean(np.where(r["dec"] < 0, -1, 1) == yt))
    ref_sv, ref_acc, res = _cascade_one(
        pkg, data, CASC["cfg"] if name == "cascade" else CASC_DECOMP)
    assert res.kkt_violators == 0
    assert abs(n_sv - ref_sv) <= max(3, 0.02 * ref_sv)
    assert abs(acc - ref_acc) <= 0.005


def test_rank_zero_alone_writes_the_trace_and_the_checkpoint(ranks):
    from dpsvm_tpu_torch.observability.report import load_trace
    from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint
    got, _, tmp = ranks
    for name in ("rff-traced", "cascade-traced"):
        assert "exception" not in got[name], got[name].get("exception")
        assert got[name]["ranks_agree"]
    # a traced, checkpointed run is the bare run, bit for bit
    np.testing.assert_array_equal(got["rff-traced"]["alpha"],
                                  got["rff"]["alpha"])
    records = load_trace(os.path.join(tmp, "trace.jsonl"))   # validates
    assert records[0]["n"] == FITS["rff"]["n"]
    assert records[-1]["kind"] == "summary"
    assert records[-1]["n_iter"] == got["rff"]["n_iter"]
    ck = load_checkpoint(os.path.join(tmp, "ck.npz"))
    assert ck.shards == 2 and ck.n == FITS["rff"]["n"]
    casc = load_trace(os.path.join(tmp, "casc.jsonl"))
    assert casc[0]["solver"] == "cascade"
    assert "screen" in [r["event"] for r in casc if r.get("kind") == "event"]
    # the two writers' files and nothing else
    assert {f for f in os.listdir(tmp) if not f.startswith("ck.")} == {
        "trace.jsonl", "casc.jsonl"}


def test_cli_trains_the_sharded_approx(tmp_path):
    from dpsvm_tpu_torch.cli import main
    from dpsvm_tpu_torch.models.io import load_model
    from dpsvm_tpu_torch.models.svm import decision_function
    x, y, xt, _ = _blobs(2100, d=6, seed=8)
    data = str(tmp_path / "d.csv")
    with open(data, "w") as f:
        for xi, yi in zip(x, y):
            f.write(f"{int(yi)}," + ",".join(f"{v:.9g}" for v in xi) + "\n")
    decs = []
    for shards in (2, 1):
        model = str(tmp_path / f"m{shards}.npz")
        out = io.StringIO()
        with redirect_stdout(out):
            rc = main(["train", "-f", data, "-m", model, "--solver",
                       "approx-rff", "--approx-dim", "128", "-c", "5",
                       "-g", "0.1", "--shards", str(shards), "--device",
                       "cpu", "-q"])
        assert rc == 0
        decs.append(np.asarray(decision_function(load_model(model), xt,
                                                 device="cpu")))
    np.testing.assert_allclose(decs[0], decs[1], rtol=0,
                               atol=SHARD_RTOL * np.abs(decs[1]).max())


def test_the_sharded_fit_needs_a_group_and_a_device(tmp_path):
    import torch

    from dpsvm_tpu_torch.approx.primal import fit_approx
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.solver.cascade import fit_cascade
    x, y, _, _ = _blobs(64, d=4)
    with pytest.raises(RuntimeError, match="needs an initialized process"):
        fit_approx(x, y, SVMConfig(**dict(FITS["rff"]["cfg"], shards=2)),
                   device="cpu")
    with pytest.raises(RuntimeError, match="needs an initialized process"):
        fit_cascade(x, y, SVMConfig(**dict(CASC["cfg"], shards=2)),
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fit_approx(x, y, SVMConfig(**FITS["rff"]["cfg"]))


@pytest.mark.slow
@pytest.mark.parametrize("shard_x", [True, False],
                         ids=["shard_x", "replicated_x"])
def test_midscale_distributed_parity(shard_x):
    """8 gloo ranks against one device at n = 8192 (the JAX package's
    mid-scale parity test): the identical iteration count, alpha within
    1e-4, b within 1e-3, the same support set above 1e-3. One device is
    the general pair (``solver/smo.train_single_device``, JAX's
    ``train_single_device``), which the distributed pair is bit for bit
    at world size 1."""
    import torch

    from dpsvm_tpu_torch import SVMConfig
    from dpsvm_tpu_torch.data.synthetic import make_blobs
    from dpsvm_tpu_torch.solver.smo import train_single_device
    x, y = make_blobs(n=8192, d=16, seed=5, separation=1.0)
    cfg = dict(c=4.0, gamma=0.125, epsilon=1e-3, max_iter=60_000,
               shard_x=shard_x, chunk_iters=1024)
    dist = tds.launch(8, [dict(name="mid", what="train", x=x, y=y,
                               cfg=dict(cfg, shards=8))])["mid"]
    assert "exception" not in dist, dist.get("exception")
    single = train_single_device(x, y, SVMConfig(**cfg),
                                 torch.device("cpu"))
    assert single.converged and dist["ranks_agree"]
    assert dist["n_iter"] == single.n_iter
    np.testing.assert_allclose(dist["alpha"], single.alpha, rtol=1e-4,
                               atol=1e-4)
    assert abs(dist["b"] - single.b) <= 1e-3
    assert np.array_equal(dist["alpha"] > 1e-3, single.alpha > 1e-3)
