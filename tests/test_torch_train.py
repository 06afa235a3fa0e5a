"""The port's training on the CPU (plain versions of the kernels) against
the NumPy oracle ``smo_reference`` and the JAX fused path with the Pallas
kernel in interpret mode.

Bars are tests/test_fused.py's own: the same n_iter, alpha within rtol
1e-4 / atol 1e-5 (both sides are float32 SMO; only the summation order of
the dot products differs), b within 1e-4, the same n_sv.
"""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs, make_xor
from dpsvm_tpu.experimental.fused import train_single_device_fused as j_fused
from dpsvm_tpu.solver.oracle import smo_reference
from dpsvm_tpu_torch import SVMConfig, evaluate, fit, train
from dpsvm_tpu_torch.solver.driver import DivergenceError

PROBLEMS = {
    "blobs_small": (lambda: make_blobs(n=96, d=6, seed=3), 1.0, 0.5),
    "xor_small": (lambda: make_xor(n=120, seed=1), 10.0, 1.0),
    "d130": (lambda: make_blobs(n=90, d=130, seed=5), 1.0, 1.0 / 130),
    "n100": (lambda: make_blobs(n=100, d=7, seed=11), 1.0, 0.3),
}


def _cfg(c, gamma, **kw):
    kw.setdefault("epsilon", 1e-3)
    kw.setdefault("max_iter", 20_000)
    kw.setdefault("chunk_iters", 64)
    return SVMConfig(c=c, gamma=gamma, **kw)


def _assert_same_run(got, ref):
    assert got.converged == ref.converged
    assert got.n_iter == ref.n_iter, (got.n_iter, ref.n_iter)
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)
    assert abs(got.b - ref.b) < 1e-4
    assert got.n_sv == ref.n_sv


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_train_matches_oracle(name):
    make, c, gamma = PROBLEMS[name]
    x, y = make()
    got = train(x, y, _cfg(c, gamma), device="cpu")
    ref = smo_reference(x, y, JConfig(c=c, gamma=gamma, epsilon=1e-3,
                                      max_iter=20_000))
    _assert_same_run(got, ref)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_train_matches_jax_fused(name):
    make, c, gamma = PROBLEMS[name]
    x, y = make()
    got = train(x, y, _cfg(c, gamma), device="cpu")
    ref = j_fused(x, y, JConfig(c=c, gamma=gamma, epsilon=1e-3,
                                max_iter=20_000, chunk_iters=64,
                                use_pallas="on"))
    _assert_same_run(got, ref)


def test_converged_at_start_runs_one_body():
    """epsilon = 1 closes the initial gap (f = -y gives gap exactly 2);
    the reference's do-while still runs one body."""
    x, y = make_blobs(n=96, d=6, seed=3)
    got = train(x, y, _cfg(1.0, 0.5, epsilon=1.0, max_iter=100,
                           chunk_iters=16), device="cpu")
    ref = smo_reference(x, y, JConfig(c=1.0, gamma=0.5, epsilon=1.0,
                                      max_iter=100))
    assert got.n_iter == ref.n_iter == 1
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-5, atol=1e-6)


def test_convergence_on_chunk_boundary():
    """If the gap closes exactly at a chunk's iteration limit, the trailing
    do-while body must still be applied, once."""
    x, y = make_blobs(n=96, d=6, seed=3)
    full = train(x, y, _cfg(1.0, 0.5), device="cpu")
    boundary = train(x, y, _cfg(1.0, 0.5, chunk_iters=full.n_iter - 1),
                     device="cpu")
    assert boundary.n_iter == full.n_iter
    np.testing.assert_allclose(boundary.alpha, full.alpha, rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("chunk", [3, 64])
def test_max_iter_cap(chunk):
    x, y = make_xor(n=120, seed=1)
    got = train(x, y, _cfg(10.0, 1.0, max_iter=10, chunk_iters=chunk),
                device="cpu")
    ref = smo_reference(x, y, JConfig(c=10.0, gamma=1.0, epsilon=1e-3,
                                      max_iter=10))
    assert got.n_iter == ref.n_iter == 10
    assert not got.converged and not ref.converged
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)


def test_bf16_mode_trains():
    """matmul_precision='default' stores X in bfloat16; the model must
    still fit the data."""
    x, y = make_blobs(n=96, d=6, seed=3)
    model, res = fit(x, y, _cfg(1.0, 0.5, matmul_precision="default"),
                     device="cpu")
    assert res.converged
    assert evaluate(model, x, y, device="cpu") > 0.95


def test_nan_in_x_raises_instead_of_spinning():
    x, y = make_blobs(n=96, d=6, seed=3)
    x = x.copy()
    x[17, 2] = np.nan
    with pytest.raises(DivergenceError, match="non-finite"):
        train(x, y, _cfg(1.0, 0.5, max_iter=100_000, chunk_iters=8),
              device="cpu")


@pytest.mark.parametrize("kw", [dict(shards=2, kernel="linear"),
                                dict(shards=2),
                                dict(shards=2, clip="pairwise"),
                                dict(shards=2, cache_size=4),
                                dict(shards=2, selection="second-order"),
                                dict(working_set=8, shards=2, kernel="linear"),
                                dict(shards=2, cache_size=4,
                                     weight_pos=2.0)])
def test_paths_outside_the_slice_raise(kw):
    """shards > 1 runs in a process group of that many ranks: without one
    it raises, naming the ways to start it (tests/test_torch_dist_smo.py
    trains these configs over gloo ranks)."""
    x, y = make_blobs(n=40, d=3, seed=0)
    with pytest.raises(RuntimeError, match="needs an initialized process"):
        train(x, y, SVMConfig(**kw), device="cpu")


def test_bad_labels_and_config_raise():
    x, y = make_blobs(n=40, d=3, seed=0)
    with pytest.raises(ValueError, match="labels"):
        train(x, np.where(y > 0, 2, 0), device="cpu")
    with pytest.raises(ValueError, match="cost"):
        train(x, y, SVMConfig(c=0.0), device="cpu")


def test_training_leaves_no_kernel_launch_on_cpu():
    from dpsvm_tpu_torch.experimental import fused_step
    before = (dict(fused_step.LAUNCHES), dict(fused_step.RUNS))
    x, y = make_blobs(n=40, d=3, seed=0)
    train(x, y, device="cpu")
    assert (fused_step.LAUNCHES, fused_step.RUNS) == before
