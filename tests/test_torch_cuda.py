"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. On a machine with
one (no JAX needed, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every kernel is driven through its one wrapper, ``launch_fused_chunk``,
the code the training loop runs. Covers what chip_smoke.py's 60000 x 784
checks do not: widths whose rows do not fill 16-byte loads (the kernel's
scalar path), tiny n, and the chunked training loop against the
host-driven plain loop (iteration for iteration in float32; in bfloat16
on a 20-iteration prefix, then model quality once converged).
Tolerance on f: 1e-5 * max(1, |f|), as chip_smoke.py states it (two
float32 sums of d products in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch import SVMConfig, train
from dpsvm_tpu_torch.data.synthetic import make_blobs, make_xor
from dpsvm_tpu_torch.experimental import fused_step as fs
from dpsvm_tpu_torch.experimental.fused import train_single_device_plain
from dpsvm_tpu_torch.models.svm import SVMModel, evaluate
from dpsvm_tpu_torch.ops.kernels import row_norms_sq

pytestmark = pytest.mark.cuda

C, GAMMA = 1.0, 0.1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n, d, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    x = x.to(dev).to(dtype).contiguous()
    y = torch.from_numpy(rng.choice([-1.0, 1.0], size=n).astype(np.float32))
    alpha = torch.from_numpy(
        rng.choice([0.0, C, 0.5], size=n).astype(np.float32))
    f = torch.from_numpy((-y.numpy() + rng.normal(0, .3, n)).astype(
        np.float32))
    return dict(x=x, x2=row_norms_sq(x), y=y.to(dev), alpha=alpha.to(dev),
                f=f.to(dev))


def _one_body(inp, i_hi, i_lo):
    """One SMO body from the state (i_hi, i_lo, b_hi=-1, b_lo=1) through
    the chunk wrapper (limit = max_iter = 1: no trailing body) and through
    the plain versions. Returns (kernel carry, plain carry, workspace,
    plain prologue's rows and scalars)."""
    x, x2, y = inp["x"], inp["x2"], inp["y"]
    state = fs.pack_state(i_hi, i_lo, -1.0, 1.0, 0, x.device)
    k = fs.FusedCarry(inp["alpha"].clone(), inp["f"].clone(), state.clone())
    p = fs.FusedCarry(inp["alpha"].clone(), inp["f"].clone(), state.clone())
    ws = fs.FusedWorkspace(x)
    fs.launch_fused_chunk(k, x, x2, y, ws, c=C, gamma=GAMMA, two_eps=2e-3,
                          limit=1, max_iter=1)
    rows_p, sc_p = fs.fused_prologue_plain(state, x, x2, y,
                                           inp["alpha"].clone(), C, GAMMA)
    fs.fused_smo_body_plain(p, x, x2, y, C, GAMMA)
    torch.cuda.synchronize()
    return k, p, ws, rows_p, sc_p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(2, 8), (3, 4), (33, 7), (1000, 130),
                                 (4099, 12), (2048, 784)])
def test_update_select_kernel_matches_plain(dev, dtype, n, d):
    inp = _inputs(n, d, dtype, dev, seed=n + d)
    before = dict(fs.LAUNCHES)
    k, p, _, _, _ = _one_body(inp, 0, n - 1)
    assert all(fs.LAUNCHES[name] == before[name] + 2 for name in fs.KERNELS)
    ks, ps = k.state.tolist(), p.state.tolist()
    assert ks[fs.S_RUN_PROLOGUE] == ks[fs.S_RUN_PASS] == 1
    assert ks[fs.S_NITER] == ps[fs.S_NITER] == 1
    tol = 1e-5 * max(1.0, float(p.f.abs().max()))
    assert float((k.f - p.f).abs().max()) <= tol
    assert ks[fs.S_IHI:fs.S_ILO + 1] == ps[fs.S_IHI:fs.S_ILO + 1]
    b_k = k.state[fs.S_BHI:fs.S_BLO + 1].view(torch.float32)
    b_p = p.state[fs.S_BHI:fs.S_BLO + 1].view(torch.float32)
    assert float((b_k - b_p).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prologue_kernel_matches_plain(dev, dtype):
    inp = _inputs(300, 20, dtype, dev, seed=3)
    k, p, ws, rows_p, sc_p = _one_body(inp, 4, 250)
    assert torch.equal(ws.rows, rows_p)
    assert float((k.alpha - p.alpha).abs().max()) <= 1e-6
    assert float((ws.scalars - sc_p).abs().max()) <= 1e-6


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    inp = _inputs(64, 8, torch.float32, dev)
    ws = fs.FusedWorkspace(inp["x"])
    kw = dict(c=C, gamma=GAMMA, two_eps=2e-3, limit=1, max_iter=1)

    def launch(x=inp["x"], f=inp["f"], state=None):
        state = fs.pack_state(0, 1, -1.0, 1.0, 0, dev) if state is None \
            else state
        carry = fs.FusedCarry(inp["alpha"], f, state)
        fs.launch_fused_chunk(carry, x, inp["x2"], inp["y"], ws, **kw)

    with pytest.raises(ValueError):
        launch(f=inp["f"].double())
    with pytest.raises(ValueError):
        launch(state=torch.zeros(fs.STATE_WORDS, dtype=torch.int64,
                                 device=dev))
    with pytest.raises(TypeError):
        launch(x=inp["x"].half())


@pytest.mark.parametrize("prec", ["highest", "default"])
@pytest.mark.parametrize("make,c,gamma,chunk", [
    (lambda: make_blobs(n=96, d=6, seed=3), 1.0, 0.5, 64),
    (lambda: make_xor(n=120, seed=1), 10.0, 1.0, 7),
    (lambda: make_blobs(n=90, d=130, seed=5), 1.0, 1.0 / 130, 1000),
])
def test_chunked_kernel_training_matches_plain(dev, prec, make, c, gamma,
                                               chunk):
    x, y = make()
    cfg = SVMConfig(c=c, gamma=gamma, chunk_iters=chunk, max_iter=20_000,
                    matmul_precision=prec)
    fs.reset_counts()
    got = train(x, y, cfg)
    for name in fs.KERNELS:
        assert fs.RUNS[name] == got.n_iter
        assert fs.LAUNCHES[name] >= got.n_iter
    ref = train_single_device_plain(x, y, cfg, dev)
    assert got.converged and ref.converged
    if prec == "default":
        # bf16 X rounds many values onto each other, and the last ulp of
        # two summation orders decides the resulting near-ties, so the
        # converged trajectories may part. Both sides read the same bf16
        # X and accumulate in f32: a 20-iteration prefix is held to the
        # float32 bars, the converged models to model quality, as the JAX
        # package holds its bf16 mode
        # (tests/test_fused.py::test_fused_bf16_mode_trains).
        pre = dataclasses.replace(cfg, max_iter=20)
        got_p = train(x, y, pre)
        ref_p = train_single_device_plain(x, y, pre, dev)
        assert got_p.n_iter == ref_p.n_iter
        np.testing.assert_allclose(got_p.alpha, ref_p.alpha, rtol=1e-4,
                                   atol=1e-5)
        assert got_p.n_sv == ref_p.n_sv
        assert abs(got.n_sv - ref.n_sv) <= max(0.02 * ref.n_sv, 3)
        for r in (got, ref):
            assert evaluate(SVMModel.from_train_result(x, y, r), x, y) > 0.95
        return
    assert got.n_iter == ref.n_iter
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)
    assert got.n_sv == ref.n_sv


@pytest.mark.parametrize("eps,max_iter", [(1.0, 100), (1e-3, 10)])
def test_chunk_edges_match_plain(dev, eps, max_iter):
    """Converged at start (one trailing body) and the max_iter cap."""
    x, y = make_blobs(n=96, d=6, seed=3)
    cfg = SVMConfig(c=1.0, gamma=0.5, epsilon=eps, max_iter=max_iter,
                    chunk_iters=4)
    got = train(x, y, cfg)
    ref = train_single_device_plain(x, y, cfg, dev)
    assert got.n_iter == ref.n_iter
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-5, atol=1e-6)
