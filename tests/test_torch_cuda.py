"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. On a machine with
one (no JAX needed, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Every kernel is driven through its one wrapper, ``launch_fused_chunk``
or ``launch_inner_subsolve``, the code the training loops run. Covers
what chip_smoke.py's 60000 x 784 checks do not: widths whose rows do not
fill 16-byte loads and misaligned X (kernel A's scalar path), n below one
unit of rows, at a unit or at 32 rows +- 1 and across every block,
ties across units and blocks, i_hi == i_lo, a NaN in f, a long chunk of
consecutive launches, the trailing body and its progress gate, and the
chunked training loop against the host-driven plain loop (iteration for
iteration in float32; in bfloat16 on a 20-iteration prefix, then model
quality once converged). Tolerance on f: 1e-5 * max(1, |f|), as
chip_smoke.py states it (two float32 sums of d products in different
orders).

The inner subsolve (kernel B) is held bitwise to its plain version: both
perform the same rounded float32 operations, the kernel without FMA
contraction and with IEEE division. Beside the default launch shapes, the
cluster is forced to 16 blocks where q leaves some blocks short or empty;
ties on f and on the WSS2 objective sit in different blocks; i_hi ==
i_lo; NaN in f; q = MAX_Q; 200 launches back to back.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch import SVMConfig, train
from dpsvm_tpu_torch.data.synthetic import make_blobs, make_xor
from dpsvm_tpu_torch.data.synthetic import make_planted
from dpsvm_tpu_torch.experimental import fused_step as fs
from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
from dpsvm_tpu_torch.experimental.fused import train_single_device_plain
from dpsvm_tpu_torch.models.svm import SVMModel, evaluate
from dpsvm_tpu_torch.ops.kernels import row_norms_sq, rows_from_dots
from dpsvm_tpu_torch.ops.selection import masked_scores_and_masks
from dpsvm_tpu_torch.solver import shrink
from dpsvm_tpu_torch.solver.decomp import train_single_device_decomp

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
    assert ks[fs.S_RUN] == 1
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


def _check_body(k, p, tol=None):
    """Kernel carry against plain carry after one body: f within 1e-5 *
    max(1, |f|), the same selection, b's within the same tolerance, alpha
    equal to 1e-6."""
    ks, ps = k.state.tolist(), p.state.tolist()
    tol = tol or 1e-5 * max(1.0, float(p.f.abs().max()))
    assert float((k.f - p.f).abs().max()) <= tol
    assert ks[fs.S_IHI:fs.S_ILO + 1] == ps[fs.S_IHI:fs.S_ILO + 1]
    b_k = k.state[fs.S_BHI:fs.S_BLO + 1].view(torch.float32)
    b_p = p.state[fs.S_BHI:fs.S_BLO + 1].view(torch.float32)
    assert float((b_k - b_p).abs().max()) <= tol
    assert float((k.alpha - p.alpha).abs().max()) <= 1e-6
    return ks


def _planted_inputs(n, d, dtype, dev, seed):
    """_inputs' alpha and f on planted rows (``make_planted`` at GAMMA, as
    chip_smoke.py's kernel checks use): |x|^2 stays ~1/GAMMA, so a row's
    distance to itself is not a cancellation of two ~d-sized sums."""
    inp = _inputs(n, d, dtype, dev, seed)
    x, _ = make_planted(n, d, GAMMA, seed=seed)
    xd = torch.from_numpy(x).to(dev).to(dtype).contiguous()
    return dict(inp, x=xd, x2=row_norms_sq(xd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [
    (3, 784), (4, 784), (5, 784),          # n below one unit, a unit +- 1
    (31, 784), (32, 784), (33, 784),       # a warp's 32 rows +- 1
    (20001, 784),                          # many units, every block
    (517, 131),                            # odd d: the scalar path
])
def test_kernel_matches_plain_at_unit_edges(dev, dtype, n, d):
    inp = _planted_inputs(n, d, dtype, dev, seed=n + d)
    k, p, _, _, _ = _one_body(inp, 0, n - 1)
    assert k.state.tolist()[fs.S_RUN] == 1
    _check_body(k, p)


def test_kernel_takes_misaligned_x_on_the_scalar_path(dev):
    n, d = 300, 16
    inp = _inputs(n, d, torch.float32, dev, seed=9)
    buf = torch.empty(n * d + 1, device=dev)
    x = buf[1:].view(n, d)                       # contiguous, 4 bytes off
    x.copy_(inp["x"])
    inp["x"] = x
    assert fs.vec_ok(x) == 0 and fs.vec_ok(inp["x"].clone()) == 1
    k, p, _, _, _ = _one_body(inp, 3, 200)
    _check_body(k, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ties_go_to_the_first_index_across_units_and_blocks(dev, dtype):
    """Equal f at rows in one 4-row unit, in different units, and in the
    first and the last block; a pair whose clipped step is zero on both
    sides keeps f as made, so the ties decide the selection."""
    n, d = 20001, 64
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, d)).astype(np.float32) / 8.0
    y = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
    alpha = rng.choice([0.0, C, 0.5], size=n).astype(np.float32)
    f = (-y + rng.normal(0, .3, n)).astype(np.float32)
    up = [9, 10, 4000, 4003, n - 1]
    low = [12, 15, 9999, n - 2]
    for idx, lab, val in ((up, 1.0, -6.0), (low, -1.0, 6.0)):
        x[idx] = x[idx[0]]
        y[idx] = lab
        alpha[idx] = 0.0
        f[idx] = val
    xd = torch.from_numpy(x).to(dev).to(dtype).contiguous()
    t = lambda a: torch.from_numpy(a).to(dev)
    inp = dict(x=xd, x2=row_norms_sq(xd), y=t(y), alpha=t(alpha), f=t(f))
    k, p, _, _, _ = _one_body(inp, low[1], up[1])   # zero step: y -1 / +1
    ks = _check_body(k, p)
    assert ks[fs.S_IHI:fs.S_ILO + 1] == [up[0], low[0]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hi_equal_lo_keeps_the_hi_value(dev, dtype):
    inp = _inputs(300, 20, dtype, dev, seed=5)
    k, p, ws, rows_p, sc_p = _one_body(inp, 10, 10)
    assert torch.equal(ws.rows, rows_p)
    assert torch.equal(k.alpha, p.alpha)         # the hi slot's value
    _check_body(k, p)


def test_nan_in_f_surfaces_as_a_non_finite_b(dev):
    """A NaN score wins its extremum, the first NaN index winning."""
    inp = _inputs(5000, 32, torch.float32, dev, seed=6)
    y, a = inp["y"], inp["alpha"]
    in_up = ((a == 0) & (y > 0)) | ((a == C) & (y < 0)) | ((a > 0) & (a < C))
    rows = torch.nonzero(in_up).flatten().tolist()
    j1, j2 = rows[len(rows) // 3], rows[-1]
    inp["f"][[j1, j2]] = float("nan")
    k, p, _, _, _ = _one_body(inp, 0, 4999)
    ks = k.state.tolist()
    b = k.state[fs.S_BHI:fs.S_BLO + 1].view(torch.float32)
    assert ks[fs.S_IHI] == j1 and torch.isnan(b[0])
    assert ks[fs.S_IHI:fs.S_ILO + 1] == p.state.tolist()[fs.S_IHI:fs.S_ILO + 1]


def test_consecutive_launches_match_plain_chunk(dev):
    """A 2000-iteration chunk (one launch an iteration, the block ticket
    and the unit counter reset by each launch's last block) against
    run_chunk_plain, float32, ragged n and d."""
    x, y = make_planted(5001, 132, 0.05, seed=8)
    xd = torch.from_numpy(x).to(dev)
    yd = torch.from_numpy(y.astype(np.float32)).to(dev)
    x2 = row_norms_sq(xd)
    from dpsvm_tpu_torch.experimental.fused import init_fused_carry
    kw = dict(c=10.0, gamma=0.05, two_eps=2e-9, limit=2000, max_iter=10**6)
    k = init_fused_carry(torch.zeros_like(yd), -yd, yd, 10.0)
    p = init_fused_carry(torch.zeros_like(yd), -yd, yd, 10.0)
    ws = fs.FusedWorkspace(xd)
    fs.reset_counts()
    assert fs.launch_fused_chunk(k, xd, x2, yd, ws, **kw) == 2001
    fs.run_chunk_plain(p, xd, x2, yd, **kw)
    torch.cuda.synchronize()
    ks, ps = k.state.tolist(), p.state.tolist()
    assert ks[fs.S_NITER] == ps[fs.S_NITER] == 2000 == ks[fs.S_RUN]
    assert ks[fs.S_IHI:fs.S_ILO + 1] == ps[fs.S_IHI:fs.S_ILO + 1]
    assert ks[8] == ks[9] == 0                   # ticket, unit counter
    np.testing.assert_allclose(k.alpha.cpu().numpy(), p.alpha.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(k.f.cpu().numpy(), p.f.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_iter,limit,max_iter,ran", [
    (0, 10, 100, 1),      # converged at start of the run: the trailing body
    (5, 10, 100, 0),      # converged, no progress in this chunk: nothing
    (0, 10, 0, 0),        # max_iter reached
])
def test_trailing_body_and_progress_gate(dev, n_iter, limit, max_iter, ran):
    inp = _inputs(700, 24, torch.float32, dev, seed=7)
    x, x2, y = inp["x"], inp["x2"], inp["y"]
    state = fs.pack_state(3, 500, 1.0, -1.0, n_iter, dev)   # gap closed
    k = fs.FusedCarry(inp["alpha"].clone(), inp["f"].clone(), state.clone())
    p = fs.FusedCarry(inp["alpha"].clone(), inp["f"].clone(), state.clone())
    ws = fs.FusedWorkspace(x, n_iter=n_iter)
    kw = dict(c=C, gamma=GAMMA, two_eps=2e-3, limit=limit, max_iter=max_iter)
    fs.launch_fused_chunk(k, x, x2, y, ws, **kw)
    fs.run_chunk_plain(p, x, x2, y, **kw)
    torch.cuda.synchronize()
    ks, ps = k.state.tolist(), p.state.tolist()
    assert ks[fs.S_RUN] == ran
    assert ks[fs.S_NITER] == ps[fs.S_NITER] == n_iter + ran
    assert ks[fs.S_BHI:fs.S_BLO + 1] == ps[fs.S_BHI:fs.S_BLO + 1]  # kept
    assert ks[fs.S_IHI:fs.S_ILO + 1] == ps[fs.S_IHI:fs.S_ILO + 1]
    assert float((k.f - p.f).abs().max()) <= 1e-5 * max(
        1.0, float(p.f.abs().max()))
    assert float((k.alpha - p.alpha).abs().max()) <= 1e-6


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


def _block(q, dev, seed=0, weighted=False, masked=0):
    """A (q, q) RBF block of planted 64-wide rows, labels, boxes, and the
    active flags with the last ``masked`` slots off."""
    rng = np.random.default_rng(seed)
    x, y = make_planted(max(2 * q, 64), 64, 0.05, seed=seed)
    idx = rng.choice(len(y), q, replace=False)
    rows = torch.from_numpy(x[idx]).to(dev)
    x2 = row_norms_sq(rows)
    torch.backends.cuda.matmul.allow_tf32 = False
    k = rows_from_dots(rows @ rows.T, x2, x2, 0.05).contiguous()
    y_w = torch.from_numpy(y[idx].astype(np.float32)).to(dev)
    c_w = (torch.where(y_w > 0, 20.0, 5.0) if weighted
           else torch.full((q,), 10.0, device=dev))
    active = torch.arange(q, device=dev) < q - masked
    return k, y_w, c_w, active


def _both(k, y_w, c_w, a0, f0, active, eps, step_cap, max_cap, pairwise,
          cluster=None):
    runs = torch.zeros(2, dtype=torch.int32, device=k.device)
    before = sk.LAUNCHES["inner_subsolve"]
    got = sk.launch_inner_subsolve(k, y_w, c_w, a0, f0, active, eps,
                                   step_cap, max_cap=max_cap,
                                   pairwise=pairwise, runs=runs,
                                   cluster=cluster)
    ref = sk.inner_subsolve_plain(k, y_w, c_w, a0, f0, active, eps,
                                  step_cap, max_cap=max_cap,
                                  pairwise=pairwise)
    torch.cuda.synchronize()
    assert runs.tolist() == [1, int(got[4])]
    assert sk.LAUNCHES["inner_subsolve"] == before + 1
    for u, v in zip(got, ref):
        assert u.dtype == v.dtype and torch.equal(u, v)
    return got


@pytest.mark.parametrize("pairwise", [False, True])
@pytest.mark.parametrize("q", [4, 32, 33, 1030])
def test_subsolve_kernel_matches_plain_bitwise(dev, q, pairwise):
    for cap, weighted, masked, step_cap in ((1, False, 0, 1),
                                            (37, False, 0, 37),
                                            (200, True, min(8, q - 1), 200),
                                            (128, False, 0, 7)):
        k, y_w, c_w, active = _block(q, dev, q + cap, weighted, masked)
        t = _both(k, y_w, c_w, torch.zeros(q, device=dev), -y_w, active,
                  1e-3, step_cap, cap, pairwise)[4]
        assert int(t) <= step_cap
    # An already-optimal block takes no step and returns its input: alpha
    # at 0, at C and inside, and an f that closes the gap (0 on slots in
    # both index sets, +1 on I_up only, -1 on I_low only).
    k, y_w, c_w, active = _block(q, dev, 5)
    rng = np.random.default_rng(q)
    pick = torch.from_numpy(rng.integers(0, 3, q)).to(dev)
    a = torch.where(pick == 0, 0.0, torch.where(pick == 1, c_w, 0.5 * c_w))
    _, _, in_up, in_low = masked_scores_and_masks(a, y_w, -y_w, c_w,
                                                  valid=active)
    f = torch.where(in_up & in_low, 0.0, torch.where(in_up, 1.0, -1.0))
    got = _both(k, y_w, c_w, a, f, active, 1e-3, 100, 100, pairwise)
    assert int(got[4]) == 0
    assert torch.equal(got[0], a) and torch.equal(got[1], f)


def test_subsolve_wrapper_rejects_what_the_kernel_does_not_take(dev):
    k, y_w, c_w, active = _block(32, dev)
    a0 = torch.zeros(32, device=dev)

    def launch(k=k, y_w=y_w, c_w=c_w, a0=a0, active=active, runs=None):
        sk.launch_inner_subsolve(k, y_w, c_w, a0, -y_w, active, 1e-3, 10,
                                 max_cap=10, pairwise=False, runs=runs)

    with pytest.raises(ValueError, match="c_w"):
        launch(c_w=c_w.cpu())                           # wrong device
    with pytest.raises(ValueError, match="a_w0"):
        launch(a0=a0.double())                          # wrong type
    with pytest.raises(ValueError, match="active"):
        launch(active=active.float())
    with pytest.raises(ValueError, match="k_ww"):
        launch(k=k.T)                                   # not contiguous
    with pytest.raises(ValueError, match="runs"):
        launch(runs=torch.zeros(1, dtype=torch.int64, device=dev))
    for q in (0, sk.MAX_Q + 2):                         # q out of range
        z = torch.zeros(q, device=dev)
        with pytest.raises(ValueError, match="q <="):
            sk.launch_inner_subsolve(
                torch.zeros((q, q), device=dev), z, z, z, z,
                torch.zeros(q, dtype=torch.bool, device=dev), 1e-3, 1,
                max_cap=1, pairwise=False)


@pytest.mark.parametrize("extra", [
    dict(working_set=32), dict(working_set=64, clip="pairwise",
                               weight_pos=2.0, weight_neg=0.5, chunk_iters=100),
    dict(working_set=16, grow_working_set=True)], ids=["q32", "q64-pw-w",
                                                      "grow"])
def test_chunked_decomposition_kernel_path_matches_plain(dev, extra):
    x, y = make_planted(1200, 16, 0.5, seed=4)
    cfg = SVMConfig(c=10.0, gamma=0.5, epsilon=1e-3, max_iter=200_000,
                    **extra)
    sk.reset_counts()
    got = train(x, y, cfg)
    assert (sk.LAUNCHES["inner_subsolve"] == sk.RUNS["inner_subsolve"]
            == got.rounds)
    assert sk.STEPS["inner_subsolve"] == got.n_iter
    ref = train_single_device_decomp(x, y, cfg, dev, plain=True)
    assert got.converged and ref.converged
    assert (got.n_iter, got.rounds) == (ref.n_iter, ref.rounds)
    np.testing.assert_allclose(got.alpha, ref.alpha, rtol=1e-4, atol=1e-5)
    assert got.n_sv == ref.n_sv


def _same(u, v):
    """Equal values and NaN at the same places (torch.equal, NaN-aware)."""
    return (u.dtype == v.dtype and torch.equal(torch.isnan(u), torch.isnan(v))
            and torch.equal(torch.nan_to_num(u), torch.nan_to_num(v)))


@pytest.mark.parametrize("pairwise", [False, True])
@pytest.mark.parametrize("q,cluster", [
    (4, 16), (32, 16), (33, 16),           # q below the cluster: empty blocks
    (1030, 16), (4098, None), (12290, None),   # 16k + 2: a short last block
    (2048, 1), (2048, 4),                  # one shape's q in other clusters
])
def test_subsolve_cluster_edges_match_plain_bitwise(dev, q, cluster,
                                                    pairwise):
    for cap, weighted, masked in ((37, False, 0), (128, True, min(8, q - 1))):
        k, y_w, c_w, active = _block(q, dev, q + cap, weighted, masked)
        _both(k, y_w, c_w, torch.zeros(q, device=dev), -y_w, active, 1e-3,
              cap, cap, pairwise, cluster)


def test_subsolve_at_max_q_matches_plain_bitwise(dev):
    q = sk.MAX_Q
    k, y_w, c_w, active = _block(q, dev, 3, weighted=True, masked=8)
    t = _both(k, y_w, c_w, torch.zeros(q, device=dev), -y_w, active, 1e-3,
              37, 37, False)[4]
    assert int(t) == 37
    assert sk.launch_geometry(q, 132).cluster == sk.MAX_CLUSTER


def _duplicate(k, src, dst):
    """Make slot dst's row and column of K copies of slot src's."""
    k[dst, :] = k[src, :]
    k[:, dst] = k[:, src]


@pytest.mark.parametrize("cluster", [None, 16])
def test_subsolve_ties_across_blocks_go_to_the_first_index(dev, cluster):
    """Two I_up slots with equal f, and two I_low slots with equal f and
    equal K rows (so an equal WSS2 objective), each pair in two different
    blocks: the first step takes the first of each, bitwise as the plain
    version does, and so does every later step."""
    q = 4096
    k, y_w, c_w, active = _block(q, dev, 11)
    up, low = (100, 3 * q // 4 + 5), (200, q - 7)
    _duplicate(k, up[0], up[1])
    _duplicate(k, low[0], low[1])
    y_w[list(up)] = 1.0
    y_w[list(low)] = -1.0
    f = -y_w.clone()
    f[list(up)] = -5.0
    f[list(low)] = 500.0               # the largest objective by far
    a0 = torch.zeros(q, device=dev)
    g = sk.launch_geometry(q, 132, cluster)
    assert {u // g.slots for u in up} != {up[0] // g.slots}
    assert {u // g.slots for u in low} != {low[0] // g.slots}
    got = _both(k, y_w, c_w, a0, f, active, 1e-3, 1, 1, False, cluster)
    moved = torch.nonzero(got[0]).flatten().tolist()
    assert moved == [up[0], low[0]]
    _both(k, y_w, c_w, a0, f, active, 1e-3, 128, 128, True, cluster)


@pytest.mark.parametrize("cluster", [None, 16])
def test_subsolve_hi_equal_lo_keeps_the_hi_value(dev, cluster):
    """K = I with two active slots, 0 and q - 1 (in the first and the last
    block): the first step equalises their f exactly at 0, so the second
    (the stored gap is still open) finds every objective at -1 and picks
    i_hi = i_lo = 0, which must leave alpha as it was."""
    q = 4096
    k = torch.eye(q, device=dev)
    y_w = torch.ones(q, device=dev)
    y_w[q - 1] = -1.0
    c_w = torch.full((q,), 10.0, device=dev)
    active = torch.zeros(q, dtype=torch.bool, device=dev)
    active[[0, q - 1]] = True
    f = -y_w.clone()
    got = _both(k, y_w, c_w, torch.zeros(q, device=dev), f, active, 1e-3,
                100, 100, False, cluster)
    assert int(got[4]) == 2
    assert got[0][0] == got[0][q - 1] == 1.0
    assert got[1][0] == got[1][q - 1] == 0.0


@pytest.mark.parametrize("cluster", [None, 16])
def test_subsolve_nan_in_f_matches_plain(dev, cluster):
    """A NaN in an I_up slot's f (in the last block) wins the argmin: b_hi
    is NaN and the loop does not start. A NaN in an inactive slot's f
    stays there while the steps run. Same b's, t, a and f as the plain
    version, NaNs where it has them, and the kernel returns."""
    q = 4096
    k, y_w, c_w, active = _block(q, dev, 13, masked=4)
    a0 = torch.zeros(q, device=dev)
    cases = []
    f = -y_w.clone()
    j = int(torch.nonzero(y_w[:q - 4] > 0).flatten()[-1])
    f[j] = float("nan")
    cases.append((f, True))
    f = -y_w.clone()
    f[q - 2] = float("nan")                      # a masked slot
    cases.append((f, False))
    for f, stops in cases:
        runs = torch.zeros(2, dtype=torch.int32, device=dev)
        got = sk.launch_inner_subsolve(k, y_w, c_w, a0, f, active, 1e-3, 50,
                                       max_cap=50, pairwise=False, runs=runs,
                                       cluster=cluster)
        ref = sk.inner_subsolve_plain(k, y_w, c_w, a0, f, active, 1e-3, 50,
                                      max_cap=50, pairwise=False)
        torch.cuda.synchronize()
        steps = int(ref[4])
        assert int(got[4]) == steps and (steps == 0) == stops
        assert runs.tolist() == [1, steps]
        assert torch.isnan(got[2]) == stops
        for u, v in zip(got, ref):
            assert _same(u, v)
    assert torch.isnan(got[1][q - 2])


def test_subsolve_200_launches_back_to_back(dev):
    """A round loop's launches: 200 on one stream with no synchronisation,
    each from the last one's (a, f), the run words shared, against the
    plain version's chain."""
    q = 4096
    k, y_w, c_w, active = _block(q, dev, 17, weighted=True)
    runs = torch.zeros(2, dtype=torch.int32, device=dev)
    a, f = torch.zeros(q, device=dev), -y_w.clone()
    ap, fp = a.clone(), f.clone()
    ts, tps = [], []
    for i in range(200):
        a, f, bh, bl, t = sk.launch_inner_subsolve(
            k, y_w, c_w, a, f, active, 1e-6, 16, max_cap=16,
            pairwise=bool(i % 2), runs=runs)
        ts.append(t)
    for i in range(200):
        ap, fp, bhp, blp, tp = sk.inner_subsolve_plain(
            k, y_w, c_w, ap, fp, active, 1e-6, 16, max_cap=16,
            pairwise=bool(i % 2))
        tps.append(int(tp))
    torch.cuda.synchronize()
    assert [int(t) for t in ts] == tps and sum(tps) > 0
    assert runs.tolist() == [200, sum(tps)]
    for u, v in ((a, ap), (f, fp), (bh, bhp), (bl, blp)):
        assert torch.equal(u, v)


def test_subsolve_refuses_a_shape_not_the_sources(dev, monkeypatch):
    k, y_w, c_w, active = _block(64, dev)
    real = sk.launch_geometry
    monkeypatch.setattr(sk, "launch_geometry",
                        lambda *a, **kw: real(*a, **kw)._replace(
                            smem=real(*a, **kw).smem + 4))
    with pytest.raises(RuntimeError, match="launch_geometry"):
        sk.launch_inner_subsolve(k, y_w, c_w, torch.zeros(64, device=dev),
                                 -y_w, active, 1e-3, 10, max_cap=10,
                                 pairwise=False)


# --------------------------------------------------------------------------
# The general pair (solver/smo.py): the captured CUDA graph against the
# eager loop of the same smo_step, bitwise. Both run the same PyTorch calls
# on the card; the graph's bodies gate their writes on the device-side
# condition, the eager loop tests it on the host.

from dpsvm_tpu_torch.convert import smo_carry_from_numpy  # noqa: E402
from dpsvm_tpu_torch.solver import smo as gsmo  # noqa: E402
from dpsvm_tpu_torch.solver.driver import DivergenceError  # noqa: E402

SMO_BRANCHES = {
    "first-order": {},
    "packed": dict(select_impl="packed"),
    "second-order": dict(selection="second-order"),
    "weighted-pairwise": dict(weight_pos=2.0, weight_neg=0.5,
                              clip="pairwise"),
    "second-order-weighted": dict(selection="second-order", weight_pos=0.5,
                                  clip="pairwise"),
    "guard_eta": {},                   # train(..., guard_eta=True)
}
SMO_KINDS = {
    "linear": dict(kernel="linear"),
    "poly": dict(kernel="poly", degree=3, coef0=1.0, gamma=0.05),
    "rbf": dict(kernel="rbf"),
    "sigmoid": dict(kernel="sigmoid", coef0=-1.0, gamma=0.01),
    "precomputed": dict(kernel="precomputed"),
}


def _smo_problem(kind, n=400, d=24, seed=1):
    """Planted rows (K = the RBF matrix of them for precomputed)."""
    x, y = make_planted(n, d, 0.25, seed=seed)
    if kind == "precomputed":
        xt = torch.from_numpy(x).double()
        d2 = (xt * xt).sum(1)[:, None] + (xt * xt).sum(1)[None] \
            - 2 * xt @ xt.T
        x = torch.exp(-0.25 * d2.clamp_min(0)).float().numpy()
    return x, y


def _smo_cfg(kind="rbf", branch="first-order", **kw):
    return SVMConfig(**{"c": 4.0, "gamma": 0.25, "epsilon": 1e-3,
                        "max_iter": 20_000, **SMO_KINDS[kind],
                        **SMO_BRANCHES[branch], **kw})


def _graph_and_eager(dev, x, y, cfg, **kw):
    gsmo.reset_counts()
    g = gsmo.train_single_device(x, y, cfg, dev, **kw)
    counts = dict(gsmo.COUNTS)
    e = gsmo.train_single_device(x, y, cfg, dev, plain=True, **kw)
    return g, e, counts


def _same_run(g, e):
    assert (g.n_iter, g.converged) == (e.n_iter, e.converged)
    assert np.array_equal(g.alpha, e.alpha)
    assert (g.b_hi, g.b_lo) == (e.b_hi, e.b_lo)


@pytest.mark.parametrize("kind", sorted(SMO_KINDS))
@pytest.mark.parametrize("branch", sorted(SMO_BRANCHES))
def test_smo_graph_matches_eager_bitwise(dev, branch, kind):
    """Every branch x kind, float32, to convergence; chunk_iters 37 is not
    a multiple of the graph's 16 bodies, so chunks end mid-graph and the
    run converges mid-chunk."""
    x, y = _smo_problem(kind)
    cfg = _smo_cfg(kind, branch, chunk_iters=37)
    g, e, counts = _graph_and_eager(dev, x, y, cfg,
                                    guard_eta=branch == "guard_eta")
    assert g.converged
    _same_run(g, e)
    chunks = -(-g.n_iter // 37)
    assert counts["captures"] == 1
    assert counts["reads"] == chunks          # one device-to-host read each
    assert counts["replays"] == chunks * -(-37 // gsmo.GRAPH_BODIES)


@pytest.mark.parametrize("kind", ["rbf", "linear", "poly"])
@pytest.mark.parametrize("branch", ["first-order", "second-order"])
def test_smo_graph_matches_eager_in_bfloat16(dev, branch, kind):
    x, y = _smo_problem(kind)
    cfg = _smo_cfg(kind, branch, chunk_iters=64, matmul_precision="default")
    g, e, _ = _graph_and_eager(dev, x, y, cfg)
    _same_run(g, e)


@pytest.mark.parametrize("max_iter", [1, 15, 16, 17, 50])
def test_smo_graph_stops_at_limit_mid_graph(dev, max_iter):
    x, y = _smo_problem("rbf")
    cfg = SVMConfig(c=4.0, gamma=0.25, max_iter=max_iter, chunk_iters=37,
                    selection="second-order")
    g, e, counts = _graph_and_eager(dev, x, y, cfg)
    assert g.n_iter == max_iter and not g.converged
    _same_run(g, e)
    # the last chunk replays only what its limit needs
    assert counts["replays"] == sum(
        -(-(min(s + 37, max_iter) - s) // gsmo.GRAPH_BODIES)
        for s in range(0, max_iter, 37))


def test_smo_graph_converged_bodies_change_nothing(dev):
    """A carry whose gap is closed: a whole chunk of bodies is enqueued
    and every one of them is a no-op, bit for bit."""
    x, y = _smo_problem("rbf")
    cfg = SVMConfig(c=4.0, gamma=0.25, selection="second-order")
    prob = gsmo.SMOProblem.build(x, y, cfg, dev)
    rng = np.random.default_rng(2)
    carry = gsmo.init_carry(prob.y, alpha_init=rng.uniform(0, 4, len(y)),
                            f_init=rng.normal(size=len(y)), b_hi=0.25,
                            b_lo=0.25, n_iter=7)
    assert carry.cache is None               # no row cache: 5 tensors
    before = [t.clone() for t in carry[:5]]
    chunk = gsmo.GraphChunk(carry, prob, gsmo.SMOOptions.from_config(cfg),
                            gsmo.two_eps_f32(cfg.epsilon))
    assert chunk.run(7, 7 + 512) == 512 // gsmo.GRAPH_BODIES
    torch.cuda.synchronize()
    for a, b in zip(carry[:5], before):
        assert torch.equal(a, b)


def test_smo_graph_hi_equal_lo(dev):
    """One interior example is the only member of I_up and the largest of
    I_low: i_hi == i_lo, eta = 0, clamped by guard_eta; the lo-then-hi
    writes leave the hi value, in the graph as in the eager loop."""
    n = 64
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.full(n, -1, np.int32)
    y[0] = 1
    alpha = np.zeros(n, np.float32)
    alpha[0] = 0.5
    f = np.linspace(-1, 0, n).astype(np.float32)
    f[0] = 3.0
    cfg = SVMConfig(c=1.0, gamma=0.1, max_iter=1, chunk_iters=4)
    runs = []
    for plain in (False, True):
        carry = smo_carry_from_numpy(alpha, f, y, -1e9, 1e9, 0, device=dev)
        prob = gsmo.SMOProblem.build(x, y, cfg, dev)
        u = gsmo.pair_update(carry, prob, gsmo.SMOOptions(guard_eta=True))
        assert int(u.i_hi) == int(u.i_lo) == 0
        runs.append(gsmo.train_single_device(x, y, cfg, dev, carry=carry,
                                             guard_eta=True, plain=plain))
    _same_run(*runs)
    assert runs[0].n_iter == 1


def test_smo_ties_go_to_the_first_index_on_the_card(dev):
    n, d = 20001, 64
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, d)).astype(np.float32) / 8.0
    y = rng.choice([-1, 1], size=n).astype(np.int32)
    alpha = np.zeros(n, np.float32)
    f = (-y + rng.normal(0, .3, n)).astype(np.float32)
    up, low = [9, 4000, n - 1], [12, 9999, n - 2]
    y[up], y[low] = 1, -1
    f[up], f[low] = -6.0, 6.0
    cfg = SVMConfig(c=1.0, gamma=0.1)
    prob = gsmo.SMOProblem.build(x, y, cfg, dev)
    for packed in (False, True):
        carry = smo_carry_from_numpy(alpha, f, y, -1e9, 1e9, 0, device=dev)
        u = gsmo.pair_update(carry, prob,
                             gsmo.SMOOptions(packed_select=packed))
        assert (int(u.i_hi), int(u.i_lo)) == (up[0], low[0])


@pytest.mark.parametrize("plain", [False, True])
def test_smo_nan_in_f_raises_divergence(dev, plain):
    x, y = _smo_problem("rbf")
    f = -y.astype(np.float32)
    f[17] = np.nan
    with pytest.raises(DivergenceError, match="non-finite"):
        gsmo.train_single_device(x, y, SVMConfig(c=4.0, gamma=0.25,
                                                 chunk_iters=8), dev,
                                 f_init=f, plain=plain)


@pytest.mark.parametrize("kind", ["linear", "poly", "sigmoid",
                                  "precomputed"])
def test_decomposition_kernel_path_matches_plain_per_kind(dev, kind):
    """Kernel B under every kind: the kernel path's rounds against the
    plain subsolve's, bitwise (the rest of a round is the same code)."""
    x, y = _smo_problem(kind, n=600)
    cfg = _smo_cfg(kind, working_set=64, inner_iters=16)
    sk.reset_counts()
    k = train_single_device_decomp(x, y, cfg, dev)
    assert sk.LAUNCHES["inner_subsolve"] == k.rounds > 0
    p = train_single_device_decomp(x, y, cfg, dev, plain=True)
    assert (k.n_iter, k.rounds, k.converged) == (p.n_iter, p.rounds, True)
    assert np.array_equal(k.alpha, p.alpha)


# ----------------------------------- shrinking, checkpoints and resume

@pytest.fixture
def fast_checks(monkeypatch):
    """Shrink checks every 128 iterations, so that small problems
    compact."""
    monkeypatch.setattr(shrink, "SHRINK_CHECK_ITERS", 128)


@pytest.mark.parametrize("branch", ["first-order", "second-order"])
def test_masked_graph_matches_eager_bitwise(dev, branch):
    """The shrinking manager's subproblems (``shrink._PairPath``: rows
    gathered into one padded slot a capacity, the masked graph captured
    over the slot once, n_valid a device scalar) against the same
    subproblems on the eager loop with the same mask, bitwise, at
    capacities 512 and 1024, two row sets each: the second set of each
    capacity replays the capture of the first."""
    x, y = _smo_problem("rbf", n=2000)
    cfg = _smo_cfg("rbf", branch, chunk_iters=37)
    rng = np.random.default_rng(8)
    yf = y.astype(np.float32)
    alpha, f = np.zeros(2000, np.float32), -yf
    paths = [shrink._PairPath(x, y, cfg, dev, False, plain)
             for plain in (False, True)]
    gsmo.reset_counts()
    for cap, sizes in ((512, (400, 300)), (1024, (700, 900))):
        for size in sizes:
            idx = np.sort(rng.choice(2000, size, replace=False))
            out = []
            for path in paths:
                step, pull = path.make(idx, cap, alpha, f, 0, -1e9, 1e9, 0)
                it = 0
                while True:
                    st = step(min(it + 37, 4000))
                    it = st.n_iter
                    if not (st.b_lo > st.b_hi + 2e-3) or it >= 4000:
                        break
                out.append((pull(), st))
            ((ga, gf), gs), ((ea, ef), es) = out
            assert gs.n_iter > 37 and gs[:3] == es[:3]
            assert np.array_equal(ga, ea) and np.array_equal(gf, ef)
    assert gsmo.COUNTS["captures"] == 2


def test_shrinking_on_the_card_matches_its_plain_run(dev, fast_checks):
    """train_shrinking through captured graphs against the same manager
    with the eager loop on the card, bitwise; the run compacts, unshrinks
    and re-shrinks into a capacity already captured, so there are fewer
    captures than rebuilds and no more than capacities."""
    x, y = make_planted(600, 40, 0.25, seed=2)
    cfg = SVMConfig(c=1.0, kernel="linear", selection="second-order",
                    epsilon=1e-3, chunk_iters=64, shrinking=True)
    gsmo.reset_counts()
    got = train(x, y, cfg)
    run = dict(shrink.RUN)
    ref = shrink.train_shrinking(x, y, cfg, dev, plain=True)
    assert run["active_sizes"] == shrink.RUN["active_sizes"]
    assert got.n_iter == ref.n_iter and np.array_equal(got.alpha, ref.alpha)
    assert run["unshrinks"] >= 1 and run["compactions"] >= 2
    assert run["captures"] == gsmo.COUNTS["captures"]
    assert run["captures"] <= len(set(run["capacities"])) < len(
        run["capacities"])


@pytest.mark.parametrize("q", [16, 64])
def test_shrinking_decomposition_kernel_matches_plain(dev, fast_checks, q):
    """Kernel B on padded, compacted active sets against its plain
    version, bitwise (the rest of a round is the same code); kernel B's
    counts agree with the rounds and steps across every rebuild."""
    x, y = make_planted(1500, 24, 0.25, seed=5)
    cfg = SVMConfig(c=1.0, gamma=0.25, epsilon=1e-3, chunk_iters=64,
                    shrinking=True, working_set=q, inner_iters=16)
    sk.reset_counts()
    got = train(x, y, cfg)
    sizes = list(shrink.RUN["active_sizes"])
    assert shrink.RUN["compactions"] >= 1 and min(sizes) >= q
    assert (sk.LAUNCHES["inner_subsolve"] == sk.RUNS["inner_subsolve"]
            == got.rounds > 0)
    assert sk.STEPS["inner_subsolve"] == got.n_iter
    ref = shrink.train_shrinking(x, y, cfg, dev, plain=True)
    assert shrink.RUN["active_sizes"] == sizes
    assert (got.n_iter, got.rounds, got.converged) == (ref.n_iter,
                                                       ref.rounds, True)
    assert np.array_equal(got.alpha, ref.alpha)


@pytest.mark.parametrize("pairwise", [False, True])
def test_subsolve_with_padding_slots_matches_plain(dev, pairwise):
    """A working set that holds capacity padding: zero rows (K = 1 on the
    RBF diagonal, exp(-gamma |x|^2) off it), y = +1, f = SENTINEL, masked.
    Bitwise against the plain version, and the padding slots keep their
    alpha."""
    q, pad = 64, 20
    k, y_w, c_w, active = _block(q, dev, seed=9)
    x, _ = make_planted(q, 64, 0.05, seed=9)
    rows = torch.from_numpy(x).to(dev)
    rows[q - pad:] = 0.0
    x2 = row_norms_sq(rows)
    k = rows_from_dots(rows @ rows.T, x2, x2, 0.05).contiguous()
    y_w[q - pad:] = 1.0
    active = torch.arange(q, device=dev) < q - pad
    f = -y_w.clone()
    f[q - pad:] = 1e9
    got = _both(k, y_w, c_w, torch.zeros(q, device=dev), f, active, 1e-3,
                64, 64, pairwise)
    assert int(got[4]) > 0 and (got[0][q - pad:] == 0).all()


def test_fused_mirror_body_matches_plain(dev, tmp_path):
    """The resume mirror (one body of kernel A from a recomputed, already
    closed selection, keeping its b's) against the same body of the plain
    version: the same alpha bit for bit, the same working set, b's and
    n_iter after it; f within F_RTOL (two float32 sums of d products in
    different orders)."""
    from dpsvm_tpu_torch.experimental import fused as tfused
    from dpsvm_tpu_torch.experimental.fused import init_fused_carry

    from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint

    x, y = make_planted(2000, 64, 0.25, seed=3)
    pair = SVMConfig(c=10.0, gamma=0.25, epsilon=1e-3)
    done = gsmo.train_single_device(x, y, pair, dev, plain=True)
    # the pair's state one body before its end: the selection recomputed
    # from it is already closed
    ck = str(tmp_path / "pair.npz")
    gsmo.train_single_device(x, y, dataclasses.replace(
        pair, max_iter=done.n_iter - 1, checkpoint_path=ck,
        checkpoint_every=1), dev, plain=True)
    last = load_checkpoint(ck)
    prob = gsmo.SMOProblem.build(x, y, pair, dev)
    xd, x2, yd = prob.x, row_norms_sq(prob.x), prob.y
    alpha = torch.from_numpy(last.alpha).to(dev)
    f = torch.from_numpy(last.f).to(dev)
    consts = dict(c=10.0, gamma=0.25, two_eps=float(np.float32(2e-3)),
                  max_iter=10 ** 6)
    out = []
    for plain in (False, True):
        carry = init_fused_carry(alpha.clone(), f.clone(), yd, 10.0,
                                 last.n_iter)
        _, _, b_hi, b_lo, _ = fs.unpack_state(carry.state)
        assert not b_lo > b_hi + np.float32(2e-3)       # closed
        ws = None if plain else fs.FusedWorkspace(xd, n_iter=last.n_iter)
        fs.reset_counts()

        def launch(cr, limit):
            if plain:
                fs.run_chunk_plain(cr, xd, x2, yd, limit=limit, **consts)
            else:
                fs.launch_fused_chunk(cr, xd, x2, yd, ws, limit=limit,
                                      **consts)

        tfused._mirror_body(carry, ws, last.n_iter, launch)
        torch.cuda.synchronize()
        assert fs.LAUNCHES["fused_update_select"] == (0 if plain else 1)
        out.append((carry, fs.unpack_state(carry.state)))
    (k, ks), (p, ps) = out
    assert torch.equal(k.alpha, p.alpha) and not torch.equal(k.alpha, alpha)
    assert ks[:2] == ps[:2] and ks[4] == ps[4] == last.n_iter + 1
    assert (ks[2], ks[3]) == (ps[2], ps[3]) == (b_hi, b_lo)
    fk, fp = k.f.cpu().numpy(), p.f.cpu().numpy()
    assert np.abs(fk - fp).max() <= 1e-5 * max(1.0, np.abs(fp).max())


@pytest.mark.parametrize("path", ["fused", "pair", "decomp"])
def test_kill_and_resume_is_bitwise_on_the_card(dev, path, tmp_path):
    """2K straight against K with a checkpoint, resumed from the file to
    2K: the same alpha, b's and n_iter, bit for bit; on the fused pair
    kernel A's device-counted runs equal the iterations the resumed run
    made."""
    x, y = make_planted(3000, 64, 0.25, seed=6)
    kw = {"fused": {}, "pair": dict(selection="second-order"),
          "decomp": dict(working_set=256, inner_iters=32)}[path]
    k = 320
    base = dict(c=10.0, gamma=0.25, epsilon=1e-3, chunk_iters=64, **kw)
    straight = train(x, y, SVMConfig(max_iter=2 * k, **base))
    ck = str(tmp_path / "state.npz")
    train(x, y, SVMConfig(max_iter=k, checkpoint_path=ck,
                          checkpoint_every=k, checkpoint_keep=2, **base))
    fs.reset_counts()
    resumed = train(x, y, SVMConfig(max_iter=2 * k, resume_from=ck, **base))
    assert resumed.n_iter == straight.n_iter == 2 * k
    assert np.array_equal(resumed.alpha, straight.alpha)
    assert (resumed.b_lo, resumed.b_hi) == (straight.b_lo, straight.b_hi)
    if path == "fused":
        assert fs.RUNS["fused_update_select"] == 2 * k - k


# --- the row cache, the batched subproblem program, pairwise decisions ---

def _three_class(n_per=60, d=6, seed=3):
    rng = np.random.default_rng(seed)
    centers = np.array([[2.0] * d, [-2.0] * d,
                        [2.0] * (d // 2) + [-2.0] * (d - d // 2)])
    x = np.concatenate([rng.normal(loc=c, scale=0.8, size=(n_per, d))
                        for c in centers]).astype(np.float32)
    y = np.repeat(np.array([0, 3, 7], np.int32), n_per)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


@pytest.mark.parametrize("kw", [{}, dict(clip="pairwise"),
                                dict(kernel="poly", gamma=0.05, coef0=1.0),
                                dict(matmul_precision="default")])
def test_cached_graph_matches_cache_off_and_its_eager_loop(dev, kw):
    """The general pair with a row cache: the captured chunk is bitwise
    its eager loop (the host-read skip of ``cache_fetch_pair``) and the
    uncached run, with hits + misses two a fetch."""
    from dpsvm_tpu_torch.solver import smo
    x, y = make_planted(600, 16, 0.25, seed=2)
    base = dict(c=10.0, gamma=0.25, epsilon=1e-3, chunk_iters=64)
    base.update(kw)
    on = SVMConfig(cache_size=8, **base)
    g = smo.train_single_device(x, y, on, dev)
    e = smo.train_single_device(x, y, on, dev, plain=True)
    off = smo.train_single_device(x, y, SVMConfig(**base), dev)
    for r in (e, off):
        assert r.n_iter == g.n_iter and (r.b_lo, r.b_hi) == (g.b_lo, g.b_hi)
        np.testing.assert_array_equal(r.alpha, g.alpha)
    assert (g.cache_hits, g.cache_misses) == (e.cache_hits, e.cache_misses)
    assert g.cache_hits + g.cache_misses == 2 * g.n_iter


@pytest.mark.parametrize("kw", [{}, dict(clip="pairwise"),
                                dict(max_iter=37),
                                dict(kernel="sigmoid", gamma=0.02,
                                     coef0=-0.5)])
def test_batched_graph_matches_its_eager_loop(dev, kw):
    """The batched program's captured chunk against its eager loop: the
    same per-problem n_iter, alpha and b's, bit for bit, a capped budget
    (max_iter not a multiple of the 16 bodies) included."""
    from dpsvm_tpu_torch.solver import batched_ovo as bo
    x, y = _three_class()
    yb, valid, _ = bo.build_pair_targets(y, np.unique(y))
    base = dict(c=1.0, gamma=0.25, epsilon=1e-3, max_iter=20_000,
                chunk_iters=64)
    base.update(kw)
    cfg = SVMConfig(**base)
    bo.reset_counts()
    g = bo.train_ovo_batched(x, yb, valid, cfg, device=dev)
    assert bo.COUNTS["captures"] == 1 and bo.COUNTS["reads"] >= 1
    e = bo.train_ovo_batched(x, yb, valid, cfg, device=dev, plain=True)
    for a, b in zip(g, e):
        assert (a.n_iter, a.b_lo, a.b_hi, a.converged) == (
            b.n_iter, b.b_lo, b.b_hi, b.converged)
        np.testing.assert_array_equal(a.alpha, b.alpha)
    if "max_iter" in kw:
        assert all(r.n_iter == 37 for r in g)


def test_batched_multiclass_on_the_card_matches_the_cpu(dev):
    """The batched program on the card against the same program on the
    CPU: the same models by the LibSVM bar (the products round
    differently)."""
    from dpsvm_tpu_torch.models.multiclass import (predict_multiclass,
                                                   train_multiclass)
    x, y = _three_class(n_per=80)
    cfg = SVMConfig(c=1.0, gamma=0.25, max_iter=20_000, chunk_iters=64)
    mg, rg = train_multiclass(x, y, cfg, batched=True, device=dev)
    mc, rc = train_multiclass(x, y, cfg, batched=True, device="cpu")
    for a, b in zip(rg, rc):
        assert a.converged and abs(a.n_sv - b.n_sv) <= max(0.02 * b.n_sv, 3)
    agree = np.mean(predict_multiclass(mg, x, device=dev)
                    == predict_multiclass(mc, x, device="cpu"))
    assert agree >= 1.0 - 1.0 / len(y) - 1e-9


def test_pairwise_decisions_on_the_card_match_the_cpu(dev):
    """All pairwise decisions of one product over the concatenated SVs on
    the card against the one-model-at-a-time loop on the CPU: within 1e-4
    of the summed |alpha| scale, and the same votes."""
    from dpsvm_tpu_torch.models import multiclass as mc
    from dpsvm_tpu_torch.models.svm import decision_function
    x, y = _three_class(n_per=100, d=8, seed=4)
    model, _ = mc.train_multiclass(x, y, SVMConfig(c=1.0, gamma=0.1),
                                   device="cpu")
    got = mc.pairwise_decisions(model, x, device=dev)
    want = [decision_function(m, x, device="cpu") for m in model.models]
    for g, w, m in zip(got, want, model.models):
        np.testing.assert_allclose(g, w, atol=1e-4 * (1 + m.alpha.sum()))
    assert np.array_equal(mc.predict_multiclass(model, x, decisions=got),
                          mc.predict_multiclass(model, x, decisions=want))


# ------------------------------------------------------- the task families

def _svr_twin_block(q, dev, p=0.1, seed=3):
    """An epsilon-SVR K_WW whose W holds q/2 rows and their stacked twins:
    the RBF block of the rows tiled 2 x 2 (a twin pair's eta is exactly
    0), labels [+1; -1], f = [p - t; -p - t] for smooth targets t, alpha
    0, C 1. Twin pair (5, q/2 + 5) gets f = (-5, 5), so WSS2 takes it
    first: its eta clamps to TAU and both alphas land on the box."""
    h = q // 2
    x, _ = make_planted(max(q, 64), 64, 0.05, seed=seed)
    rows = torch.from_numpy(x[:h]).to(dev)
    x2 = row_norms_sq(rows)
    torch.backends.cuda.matmul.allow_tf32 = False
    k = rows_from_dots(rows @ rows.T, x2, x2, 0.05).repeat(2, 2).contiguous()
    t = torch.sin(3.0 * rows[:, 0])
    y_w = torch.cat([torch.ones(h, device=dev), -torch.ones(h, device=dev)])
    f = torch.cat([p - t, -p - t])
    f[5], f[h + 5] = -5.0, 5.0
    return (k, y_w, torch.ones(q, device=dev), torch.zeros(q, device=dev),
            f.contiguous(), torch.ones(q, dtype=torch.bool, device=dev))


@pytest.mark.parametrize("pairwise", [False, True])
@pytest.mark.parametrize("q", [64, 1030, 4096])
def test_subsolve_on_an_svr_twin_block_matches_plain(dev, q, pairwise):
    k, y_w, c_w, a0, f0, active = _svr_twin_block(q, dev)
    got = _both(k, y_w, c_w, a0, f0, active, 1e-3, 128, 128, pairwise)
    assert int(got[4]) > 0
    assert float(got[0][5]) == float(got[0][q // 2 + 5]) == 1.0


def test_subsolve_on_a_oneclass_first_round_matches_plain(dev):
    """One-class's first decomposition round: floor(nu n) alphas start at
    the box (C = 1) and f = K alpha0; the subsolve's inputs, captured from
    ``decomp_step``, held kernel against plain, bitwise."""
    from dpsvm_tpu_torch.models.oneclass import oneclass_seed
    from dpsvm_tpu_torch.ops.diagnostics import _stream_kv
    from dpsvm_tpu_torch.solver import decomp as sd
    x, _ = make_planted(4096, 64, 0.05, seed=2)
    n, q = len(x), 1024
    a0 = oneclass_seed(n, 0.1)
    cfg = SVMConfig(c=1.0, gamma=0.05, clip="pairwise", working_set=q,
                    inner_iters=128)
    f0 = _stream_kv(x, a0, cfg.kernel_spec(64), block=4096, device=dev)
    prob = sd.DecompProblem.build(x, np.ones(n, np.float32), cfg, dev)
    carry = sd.init_carry(prob.y)._replace(
        alpha=torch.from_numpy(a0).to(dev), f=torch.from_numpy(f0).to(dev))
    seen = []

    def capture(*args, **kw):
        seen[:] = [args, kw]
        return sk.launch_inner_subsolve(*args, **kw)

    sd.decomp_step(carry, prob, q=q, inner_cap=128, epsilon=1e-3,
                   step_cap=128, pairwise_clip=True, subsolve=capture)
    args, kw = seen
    assert float(args[3].max()) == 1.0           # alphas at the box in W
    got = _both(*args[:6], args[6], args[7], kw["max_cap"], kw["pairwise"])
    assert int(got[4]) > 0


def _nu_problem(task, n=600, d=24, device=torch.device("cpu")):
    """(x, labels, alpha0, f0) of a nu-SVC or (stacked) nu-SVR problem,
    seeded as ``models/nusvm.py`` seeds it (nu-SVC's f0 = K (alpha0 y)
    streamed on ``device``)."""
    from dpsvm_tpu_torch.models.nusvm import _nu_head_seed
    from dpsvm_tpu_torch.ops.diagnostics import _stream_kv
    x, y = make_planted(n, d, 0.25, seed=5)
    if task == "nusvc":
        a0 = np.zeros(n, np.float32)
        for cls in (y > 0, y < 0):
            idx = np.flatnonzero(cls)
            a0[idx] = _nu_head_seed(0.3 * n / 2, 1.0, len(idx))
        yf = y.astype(np.float32)
        f0 = _stream_kv(x, a0 * yf, SVMConfig(gamma=0.25).kernel_spec(d),
                        block=4096, device=device)
        return x, yf, a0, f0
    z = np.sin(x[:, 0] * 3).astype(np.float32)
    seed = _nu_head_seed(0.5 * n / 2, 1.0, n)
    return (np.vstack([x, x]), np.concatenate([np.ones(n), -np.ones(n)])
            .astype(np.float32), np.concatenate([seed, seed]),
            np.concatenate([-z, -z]))


@pytest.mark.parametrize("task", ["nusvc", "nusvr"])
def test_nu_selection_graph_matches_eager_bitwise(dev, task):
    """nu_selection in the captured chunk against the eager loop, to
    convergence, with chunks that end mid-graph: one capture, no kernel
    launched, one stats read a chunk."""
    x, y, a0, f0 = _nu_problem(task)
    cfg = SVMConfig(c=1.0, gamma=0.25, clip="pairwise", chunk_iters=37,
                    max_iter=50_000)
    fs.reset_counts()
    sk.reset_counts()
    g, e, counts = _graph_and_eager(dev, x, y, cfg, f_init=f0, alpha_init=a0,
                                    guard_eta=True, nu_selection=True)
    assert g.converged and g.b_hi == 0.0
    _same_run(g, e)
    assert counts["captures"] == 1
    assert counts["reads"] == -(-g.n_iter // 37)
    assert sk.LAUNCHES["inner_subsolve"] == 0
    assert fs.LAUNCHES["fused_update_select"] == 0


@pytest.mark.parametrize("task", ["nusvc", "nusvr"])
def test_nu_selection_graph_matches_eager_at_full_width(dev, task):
    """As chip_smoke.py's phase 2: 512 iterations of nu selection at
    60000 x 784 (nu-SVR: the 120000 stacked rows), the captured chunk
    against the eager loop, bit for bit."""
    x, y, a0, f0 = _nu_problem(task, n=60000, d=784, device=dev)
    cfg = SVMConfig(c=1.0, gamma=0.25, clip="pairwise", max_iter=512)
    g, e, counts = _graph_and_eager(dev, x, y, cfg, f_init=f0, alpha_init=a0,
                                    guard_eta=True, nu_selection=True)
    assert g.n_iter == 512 and g.b_hi == 0.0
    _same_run(g, e)
    assert counts["captures"] == 1 and counts["reads"] == 1


def test_task_families_on_the_card_match_the_cpu(dev):
    """The wrappers on the card against the same wrappers on the CPU: the
    LibSVM bar (n_sv within 2% or 3, decisions within 5e-3), with the
    decomposition for epsilon-SVR and one-class. nu-SVC converges to 5e-5
    (as tests/test_torch_nusvm.py's sklearn bars do): its decisions are
    the dual's scaled by 1/r, which magnifies a 1e-3 gap past 5e-3."""
    from dpsvm_tpu_torch.models import nusvm, oneclass, svr
    from dpsvm_tpu_torch.models.svm import decision_function
    x, y = make_planted(500, 16, 0.25, seed=6)
    t = np.sin(2 * x[:, 0]).astype(np.float32)
    runs = [(lambda d: svr.train_svr(x, t, SVMConfig(c=1.0, working_set=64),
                                     device=d)),
            (lambda d: oneclass.train_oneclass(
                x, 0.1, SVMConfig(working_set=64), device=d)),
            (lambda d: nusvm.train_nusvc(x, y, 0.3, SVMConfig(epsilon=5e-5),
                                         device=d)),
            (lambda d: nusvm.train_nusvr(x, t, 0.5, device=d))]
    for run in runs:
        mg, rg = run(dev)
        mc, rc = run("cpu")
        assert rg.converged and abs(mg.n_sv - mc.n_sv) <= max(
            0.02 * mc.n_sv, 3)
        dg = decision_function(mg, x, device=dev)
        assert np.abs(dg - decision_function(mc, x, device="cpu")).max() \
            <= 5e-3


# ------------------------------------------------- distributed (parallel/)

@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    """An NCCL group of one rank on cuda:0, in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from dpsvm_tpu_torch.parallel import multihost
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "s"), 1)
    multihost.initialize(num_processes=1, process_id=0, store=store,
                         device="cuda:0")
    yield dist.group.WORLD
    dist.destroy_process_group()


DIST_BRANCHES = {
    "first-order": {},
    "second-order": dict(selection="second-order"),
    "cache": dict(cache_size=4),
    "weighted-pairwise": dict(weight_pos=2.0, clip="pairwise"),
    "replicated": dict(shard_x=False),
    "poly": dict(kernel="poly", gamma=1 / 96, coef0=1.0),
}


def _dist_pair(x, y, cfg, group):
    from dpsvm_tpu_torch.parallel import dist_smo as ds
    from dpsvm_tpu_torch.parallel.mesh import make_data_mesh
    from dpsvm_tpu_torch.solver import smo as gs
    mesh = make_data_mesh(1, group)
    di = ds.prepare_distributed_inputs(x, y, cfg, mesh, None, None, None)
    opts = gs.SMOOptions.from_config(cfg)
    return di, opts, gs.two_eps_f32(cfg.epsilon)


@pytest.mark.parametrize("branch", sorted(DIST_BRANCHES))
def test_dist_graph_chunk_matches_its_eager_loop_bitwise(dev, nccl_world,
                                                         branch):
    """A world of one over NCCL: the captured chunk (collectives inside the
    graph) against the eager loop of the same bodies."""
    from dpsvm_tpu_torch.parallel import dist_smo as ds
    x, y = make_planted(3000, 96, 0.25, seed=4)
    cfg = SVMConfig(**{"c": 10.0, "gamma": 0.25, **DIST_BRANCHES[branch]})
    di, opts, two_eps = _dist_pair(x, y, cfg, nccl_world)
    lines = cfg.cache_size
    out = []
    for plain in (False, True):
        carry = ds.init_carry(di.prob, di.init, cache_lines=lines)
        step = ds.make_dist_runner(carry, di.prob, opts, two_eps, plain)
        carry, st = step(carry, 300)
        out.append((carry, st))
    (g, sg), (e, se) = out
    assert sg.n_iter == se.n_iter == 300
    for a, b in ((g.alpha, e.alpha), (g.f, e.f), (g.b_hi, e.b_hi),
                 (g.b_lo, e.b_lo)):
        assert torch.equal(a, b)
    assert sg.probe == se.probe and len(sg.probe) == 1


@pytest.mark.parametrize("branch", sorted(DIST_BRANCHES))
def test_dist_prefix_is_the_general_pair_bitwise(dev, nccl_world, branch):
    from dpsvm_tpu_torch.parallel.dist_smo import train_distributed
    from dpsvm_tpu_torch.solver.smo import train_single_device
    x, y = make_planted(3000, 96, 0.25, seed=4)
    kw = {"c": 10.0, "gamma": 0.25, "max_iter": 500,
          **DIST_BRANCHES[branch]}
    d = train_distributed(x, y, SVMConfig(**kw), group=nccl_world)
    kw.pop("shard_x", None)
    s = train_single_device(x, y, SVMConfig(**kw), dev)
    assert d.n_iter == s.n_iter == 500
    np.testing.assert_array_equal(d.alpha, s.alpha)
    assert (d.b_lo, d.b_hi) == (s.b_lo, s.b_hi)


def test_dist_decomp_kernel_b_matches_plain_round(dev, nccl_world):
    """Kernel B inside the distributed decomposition: the first round's
    launch against the plain subsolve on the same inputs, bitwise; and
    whole rounds of the kernel path against the plain path."""
    from dpsvm_tpu_torch.parallel import dist_decomp as dd
    x, y = make_planted(3000, 96, 0.25, seed=4)
    cfg = SVMConfig(c=10.0, gamma=0.25, working_set=512, inner_iters=64,
                    max_iter=64)
    seen = []
    orig = sk.launch_inner_subsolve

    def spy(*args, **kw):
        seen.append((args, dict(kw)))
        return orig(*args, **kw)

    sk.launch_inner_subsolve = spy
    try:
        dd.train_distributed_decomp(x, y, cfg, group=nccl_world)
    finally:
        sk.launch_inner_subsolve = orig
    assert len(seen) == 1
    args, kw = seen[0]
    kw.pop("runs", None)
    got = orig(*args, **kw)
    want = sk.inner_subsolve_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cfg = dataclasses.replace(cfg, max_iter=6 * 64)
    k = dd.train_distributed_decomp(x, y, cfg, group=nccl_world)
    p = dd.train_distributed_decomp(x, y, cfg, group=nccl_world, plain=True)
    assert (k.n_iter, k.rounds) == (p.n_iter, p.rounds)
    np.testing.assert_array_equal(k.alpha, p.alpha)


def test_two_gloo_ranks_share_the_card(dev, nccl_world):
    """Two gloo ranks (launch_local) with their shards on cuda:0 (an
    explicit group: gloo stages CUDA tensors through the host), against the
    world of one over NCCL: the same n_iter, alpha within 1e-4."""
    from torch_dist_scenarios import launch
    from dpsvm_tpu_torch.parallel.dist_smo import train_distributed
    x, y = make_planted(1500, 64, 0.25, seed=5)
    cfg = dict(c=10.0, gamma=0.25)
    one = train_distributed(x, y, SVMConfig(**cfg), group=nccl_world)
    r = launch(2, [dict(name="gloo-cuda", x=x, y=y, cfg=cfg, group=True,
                        device="cuda:0")])["gloo-cuda"]
    assert "exception" not in r, r.get("exception")
    assert r["ranks_agree"] and r["converged"]
    assert r["n_iter"] == one.n_iter
    np.testing.assert_allclose(r["alpha"], one.alpha, rtol=1e-4, atol=1e-4)


def test_a_gloo_world_on_the_card_trains_on_its_default_group(
        dev, nccl_world):
    """``launch_local(backend="gloo")`` on the card: two CUDA ranks share
    cuda:0 in a gloo world and train on its default group with no group
    or device given (what ``train --dist-backend gloo`` does), against the
    world of one over NCCL: the same n_iter, alpha within 1e-4."""
    from torch_elastic_ranks import card_rank
    from dpsvm_tpu_torch.parallel.dist_smo import train_distributed
    from dpsvm_tpu_torch.parallel.multihost import launch_local
    x, y = make_planted(1500, 64, 0.25, seed=5)
    cfg = dict(c=10.0, gamma=0.25)
    one = train_distributed(x, y, SVMConfig(**cfg), group=nccl_world)
    outs = launch_local(2, card_rank, (x, y, cfg), device="cuda",
                        backend="gloo", run_timeout_s=300)
    assert [o["device"] for o in outs] == ["cuda:0", "cuda:0"]
    assert all(o["converged"] for o in outs)
    assert outs[0]["n_iter"] == outs[1]["n_iter"] == one.n_iter
    np.testing.assert_array_equal(outs[0]["alpha"], outs[1]["alpha"])
    np.testing.assert_allclose(outs[0]["alpha"], one.alpha, rtol=1e-4,
                               atol=1e-4)


# --- the approx solvers and the cascade ---------------------------------

def _approx_problem(n, d=16, kind="rff", task="svc", seed=3):
    x, y = make_blobs(n=n, d=d, seed=seed)
    if task == "svr":
        y = np.sin(x[:, 0]).astype(np.float32)
    cfg = SVMConfig(solver=f"approx-{kind}", approx_dim=256, c=5.0,
                    gamma=1.0 / d, epsilon=1e-3, max_iter=20_000)
    return x, y, cfg


@pytest.mark.parametrize("n,kind,task", [(800, "rff", "svc"),
                                         (1500, "rff", "svc"),
                                         (3000, "nystrom", "svc"),
                                         (3000, "rff", "svr")])
def test_approx_graph_chunk_matches_its_eager_loop(dev, n, kind, task):
    """The captured chunk (gated bodies) against the eager loop of
    ``primal_step`` on the card: the whole fit, bitwise (full-batch,
    minibatch at 1500 rows, Nystrom and SVR)."""
    from dpsvm_tpu_torch.approx import primal
    x, y, cfg = _approx_problem(n, kind=kind, task=task)
    primal.reset_counts()
    mg, rg = primal.fit_approx(x, y, cfg, task=task, device=dev)
    assert primal.COUNTS["captures"] == 1
    assert primal.RUN["phi_device"].startswith("cuda")
    mp, rp = primal.fit_approx(x, y, cfg, task=task, device=dev,
                               plain=True)
    assert rg.n_iter == rp.n_iter and rg.converged
    np.testing.assert_array_equal(mg.w, mp.w)
    assert mg.b == mp.b


@pytest.mark.parametrize("n,kind,task", [(800, "rff", "svc"),
                                         (1500, "nystrom", "svc"),
                                         (3000, "rff", "svr")])
def test_approx_card_fit_matches_the_cpu(dev, n, kind, task):
    """The card's fit against the plain CPU fit: float32 rounding apart,
    the same step count within 5% and decisions within 5e-3."""
    from dpsvm_tpu_torch.approx import primal
    from dpsvm_tpu_torch.models.svm import decision_function
    x, y, cfg = _approx_problem(n, kind=kind, task=task)
    mg, rg = primal.fit_approx(x, y, cfg, task=task, device=dev)
    mc, rc = primal.fit_approx(x, y, cfg, task=task, device="cpu")
    assert rg.converged and rc.converged
    assert abs(rg.n_iter - rc.n_iter) <= max(2, 0.05 * rc.n_iter)
    dg = decision_function(mg, x, device=dev)
    dc = decision_function(mc, x, device="cpu")
    assert float(np.max(np.abs(dg - dc))) < 5e-3


def test_approx_resume_is_bitwise_on_the_card(dev, tmp_path):
    """A fit cut at 300 steps and resumed to 600 lands on the weights of
    the uncut 600-step fit, bit for bit."""
    from dpsvm_tpu_torch.approx import primal
    x, y, cfg = _approx_problem(3000)
    cfg = dataclasses.replace(cfg, epsilon=1e-9, max_iter=600,
                              chunk_iters=256)
    full, _ = primal.fit_approx(x, y, cfg, device=dev)
    ck = str(tmp_path / "ck.npz")
    primal.fit_approx(x, y, dataclasses.replace(
        cfg, max_iter=300, checkpoint_path=ck, checkpoint_every=100),
        device=dev)
    res, r = primal.fit_approx(x, y, dataclasses.replace(
        cfg, resume_from=ck), device=dev)
    assert r.n_iter == 600
    np.testing.assert_array_equal(full.w, res.w)
    assert full.b == res.b


@pytest.mark.parametrize("kw,kernel", [({}, "A"),
                                       (dict(working_set=1024,
                                             inner_iters=64), "B")])
def test_cascade_probe_and_polish_run_the_kernels(dev, kw, kernel):
    """A cascade big enough for the calibration probe (>= 12288 rows):
    at the default dual knobs the probe's api.fit is the fused pair, so
    kernel A's counter moves; with working_set > 2 the probe and the
    polish go through the decomposition, so kernel B's moves. Zero
    violators either way."""
    from dpsvm_tpu_torch.solver import cascade as cs
    x, y = make_planted(13000, 32, 0.25, seed=1)
    cfg = SVMConfig(solver="cascade", approx_dim=256, c=1.0, gamma=0.25,
                    epsilon=1e-3, **kw)
    fs.reset_counts()
    sk.reset_counts()
    _, r = cs.fit_cascade(x, y, cfg, device=dev)
    assert r.kkt_violators == 0 and r.converged
    assert cs.RUN["probe_rows"] == cs._PROBE_ROWS
    if kernel == "A":
        assert fs.LAUNCHES["fused_update_select"] > 0
        assert sk.LAUNCHES["inner_subsolve"] == 0
    else:
        assert sk.LAUNCHES["inner_subsolve"] > 0
        assert fs.LAUNCHES["fused_update_select"] == 0


def test_approx_default_device_without_cuda_raises(monkeypatch):
    """``fit_approx(device=None)`` means the card: without CUDA it raises,
    it never moves to the CPU (the CUDA check is stubbed off here)."""
    from dpsvm_tpu_torch.approx import primal
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, cfg = _approx_problem(200)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        primal.fit_approx(x, y, cfg)


def _stream_dir(tmp_path, n, d=16, rows=512, task="svc", seed=3):
    """A shard directory of ``n`` blob rows (float targets for svr)."""
    from dpsvm_tpu_torch.data import stream as st
    from dpsvm_tpu_torch.data.synthetic import save_csv
    x, y = make_blobs(n=n, d=d, seed=seed)
    if task == "svr":
        y = np.sin(x[:, 0]).astype(np.float32)
    src = str(tmp_path / "src.csv")
    save_csv(src, x, y)
    sdir = str(tmp_path / "shards")
    st.convert_to_shards(src, sdir, rows_per_shard=rows,
                         float_labels=task == "svr")
    return x, y, sdir


@pytest.mark.parametrize("kind,task", [("rff", "svc"), ("nystrom", "svr")])
def test_stream_fit_on_the_card_matches_the_cpu(dev, tmp_path, kind, task):
    """``fit_approx_stream`` on the card against the CPU on the same
    directory: the same step count within 5%, decisions within 5e-3; the
    host booked its reads, one stats read a chunk."""
    from dpsvm_tpu_torch.approx import primal
    from dpsvm_tpu_torch.data import stream as st
    from dpsvm_tpu_torch.models.svm import decision_function
    x, _, sdir = _stream_dir(tmp_path, 2304, task=task)
    cfg = SVMConfig(solver=f"approx-{kind}", approx_dim=256, c=5.0,
                    gamma=1.0 / 16, epsilon=1e-3, max_iter=20_000,
                    chunk_iters=64)
    primal.reset_counts()
    mg, rg = primal.fit_approx_stream(st.ShardedDataset.open(sdir), cfg,
                                      task=task, device=dev)
    run = dict(primal.RUN)
    assert primal.COUNTS["reads"] == -(-rg.n_iter // 64)
    assert run["read_seconds"] > 0 and run["steps"] >= rg.n_iter
    assert run["phi_device"].startswith("cuda")
    mc, rc = primal.fit_approx_stream(st.ShardedDataset.open(sdir), cfg,
                                      task=task, device="cpu")
    assert rg.converged and rc.converged
    assert abs(rg.n_iter - rc.n_iter) <= max(2, 0.05 * rc.n_iter)
    dg = decision_function(mg, x, device=dev)
    dc = decision_function(mc, x, device="cpu")
    assert float(np.max(np.abs(dg - dc))) < 5e-3


def test_stream_steps_on_the_card_are_the_in_memory_steps(dev, tmp_path):
    """64 streamed steps against the captured in-memory full-batch chunk
    over the same rows with the same step size (the stream's, held to the
    in-memory trace bound): w within 1e-5 of its largest entry (float32
    sums in shard order against one product over shuffled rows)."""
    from dpsvm_tpu_torch.approx import primal
    from dpsvm_tpu_torch.approx.features import build_feature_map
    from dpsvm_tpu_torch.data import stream as st
    x, y, sdir = _stream_dir(tmp_path, 2304, rows=500)
    cfg = SVMConfig(solver="approx-rff", approx_dim=256, c=5.0,
                    gamma=1.0 / 16, epsilon=1e-9, max_iter=64,
                    chunk_iters=64)
    ms, rs = primal.fit_approx_stream(st.ShardedDataset.open(sdir), cfg,
                                      device=dev)
    lr = primal.RUN["lr"]
    fmap = build_feature_map("rff", x[:1], 256, 0, cfg.kernel_spec(16))
    prob = primal.build_problem(x, np.asarray(y, np.float32), cfg, "svc",
                                fmap, dev)
    # the stream's step size is the trace bound over the same rows
    big_l = 1.0 / (cfg.c * len(y)) + 2.0 * primal.RUN["msq"]
    assert prob.n_batches == 1 and abs(float(lr) * big_l - 1.0) <= 1e-6
    prob = dataclasses.replace(prob, lr=torch.tensor(np.float32(lr),
                                                     device=dev))
    carry = primal.carry_to_device(primal.init_carry(257), dev)
    step = primal.make_chunk_runner(carry, prob)
    _, st_ = step(carry, 64)
    w = primal.carry_to_host(step.carry).w
    assert rs.n_iter == st_.n_iter == 64
    scale = max(1.0, float(np.max(np.abs(ms.w))))
    assert float(np.max(np.abs(w[:-1] - ms.w))) <= 1e-5 * scale


def test_stream_resume_is_bitwise_on_the_card(dev, tmp_path):
    """A streaming fit cut at a checkpoint (step 32) and resumed to 64
    lands on the uncut fit's weights, bit for bit."""
    from dpsvm_tpu_torch.approx import primal
    from dpsvm_tpu_torch.data import stream as st
    _, _, sdir = _stream_dir(tmp_path, 2304)
    cfg = SVMConfig(solver="approx-rff", approx_dim=256, c=5.0,
                    gamma=1.0 / 16, epsilon=1e-9, max_iter=64,
                    chunk_iters=32)
    full, _ = primal.fit_approx_stream(st.ShardedDataset.open(sdir), cfg,
                                       device=dev)
    ck = str(tmp_path / "ck.npz")
    primal.fit_approx_stream(st.ShardedDataset.open(sdir),
                             dataclasses.replace(cfg, max_iter=32,
                                                 checkpoint_path=ck,
                                                 checkpoint_every=32),
                             device=dev)
    res, r = primal.fit_approx_stream(
        st.ShardedDataset.open(sdir),
        dataclasses.replace(cfg, resume_from=ck), device=dev)
    assert r.n_iter == 64
    np.testing.assert_array_equal(full.w, res.w)
    assert full.b == res.b


@pytest.mark.parametrize("kw,kernel", [({}, "A"),
                                       (dict(working_set=1024,
                                             inner_iters=64), "B")])
def test_stream_cascade_runs_the_kernels(dev, tmp_path, kw, kernel):
    """The streaming cascade over a shard directory of 13000 rows (the
    calibration probe needs >= 12288): kernel A in the probe at the
    default knobs, kernel B in the probe and polish with working_set > 2;
    zero violators; the same model as the in-memory cascade by the bar
    between paths."""
    from dpsvm_tpu_torch.data import stream as st
    from dpsvm_tpu_torch.data.synthetic import save_csv
    from dpsvm_tpu_torch.solver import cascade as cs
    x, y = make_planted(13000, 32, 0.25, seed=1)
    src = str(tmp_path / "src.csv")
    save_csv(src, x, y)
    sdir = str(tmp_path / "shards")
    st.convert_to_shards(src, sdir, rows_per_shard=4096)
    cfg = SVMConfig(solver="cascade", approx_dim=256, c=1.0, gamma=0.25,
                    epsilon=1e-3, **kw)
    fs.reset_counts()
    sk.reset_counts()
    m, r = cs.fit_cascade_stream(st.ShardedDataset.open(sdir), cfg,
                                 device=dev)
    assert r.kkt_violators == 0 and r.converged
    assert cs.RUN["probe_rows"] == cs._PROBE_ROWS
    if kernel == "A":
        assert fs.LAUNCHES["fused_update_select"] > 0
        assert sk.LAUNCHES["inner_subsolve"] == 0
    else:
        assert sk.LAUNCHES["inner_subsolve"] > 0
        assert fs.LAUNCHES["fused_update_select"] == 0
    mi, _ = cs.fit_cascade(x, y, cfg, device=dev)
    assert abs(m.n_sv - mi.n_sv) <= max(3, 0.02 * mi.n_sv)
    assert abs(evaluate(m, x, y, device=dev)
               - evaluate(mi, x, y, device=dev)) <= 0.005


def test_stream_default_device_without_cuda_raises(monkeypatch, tmp_path):
    """``fit_approx_stream(device=None)`` means the card: without CUDA it
    raises, it never moves to the CPU (the CUDA check is stubbed off)."""
    from dpsvm_tpu_torch.approx import primal
    from dpsvm_tpu_torch.data import stream as st
    _, _, sdir = _stream_dir(tmp_path, 300, rows=100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        primal.fit_approx_stream(st.ShardedDataset.open(sdir),
                                 SVMConfig(solver="approx-rff"))


# --- the live log, the serving engine and the fleet on the card --------------

def test_live_fit_on_the_card_matches_the_cpu(dev, tmp_path):
    """A live fit admitting two appended shards on the card against the
    CPU on the same log: the same generation, the same stats reads (as a
    frozen fit's), n_iter within 5%, decisions within 5e-3; no capture."""
    from dpsvm_tpu_torch.approx import primal
    from dpsvm_tpu_torch.data import live as lv
    from dpsvm_tpu_torch.data import stream as st
    from dpsvm_tpu_torch.models.svm import decision_function
    x, _, sdir = _stream_dir(tmp_path, 2048, rows=512)
    for s in (1, 2):
        xa, ya = make_blobs(n=512, d=16, seed=40 + s)
        lv.append_shard(sdir, xa, ya)
    cfg = SVMConfig(solver="approx-rff", approx_dim=256, c=5.0,
                    gamma=1.0 / 16, epsilon=1e-3, max_iter=20_000,
                    chunk_iters=64)
    out = {}
    for where in (dev, "cpu"):
        primal.reset_counts()
        ds = st.ShardedDataset.open(sdir, at_generation=0)
        m, r = primal.fit_approx_stream(ds, cfg, live=True, device=where)
        out[str(where)] = (m, r, ds.generation, dict(primal.COUNTS))
    (mg, rg, gg, cg), (mc, rc, gc, cc) = out.values()
    assert gg == gc == 2 and rg.converged and rc.converged
    assert cg["reads"] == -(-rg.n_iter // 64) and cg["captures"] == 0
    assert abs(rg.n_iter - rc.n_iter) <= max(2, 0.05 * rc.n_iter)
    dg = decision_function(mg, x, device=dev)
    dc = decision_function(mc, x, device="cpu")
    assert float(np.max(np.abs(dg - dc))) < 5e-3


def _serve_model(n_sv=3000, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return SVMModel(x_sv=rng.standard_normal((n_sv, d)).astype(np.float32),
                    alpha=rng.uniform(0.05, 1.0, n_sv).astype(np.float32),
                    y_sv=np.where(rng.random(n_sv) < 0.5, -1,
                                  1).astype(np.int32),
                    b=0.1, gamma=1.0 / d)


@pytest.mark.parametrize("kind", ["sv", "rff"])
def test_engine_captures_a_graph_a_bucket_and_holds_the_contract(dev, kind):
    """One capture a bucket at warmup, none across mixed sizes after it;
    every answer bitwise ``decision_function`` on the same block; across
    request sizes within 1e-5 of the block's max |decision| (cuBLAS may
    pick another algorithm by the row count: ROADMAP Queue 3)."""
    from dpsvm_tpu_torch.serving import engine as E
    if kind == "sv":
        model = _serve_model()
        from dpsvm_tpu_torch.models.svm import decision_function
    else:
        from dpsvm_tpu_torch.approx.model import decision_function
        from dpsvm_tpu_torch.approx.primal import fit_approx
        xb, yb = make_blobs(n=600, d=64, seed=4)
        model, _ = fit_approx(xb, yb, SVMConfig(
            solver="approx-rff", approx_dim=512, c=5.0, epsilon=1e-3),
            device=dev)
    E.reset_counts()
    engine = E.PredictionEngine(model, max_batch=64, device=dev)
    assert engine.warmup_captures == len(engine.buckets) == 7
    assert E.COUNTS["captures"] == 7
    rng = np.random.default_rng(5)
    worst = 0.0
    for s in list(range(1, 70)) + [130, 200]:
        q = rng.standard_normal((s, 64)).astype(np.float32)
        out = engine.decision_values(q)
        for lo, take, bucket in engine._ladder.plan(s):
            block = np.zeros((bucket, 64), np.float32)
            block[:take] = q[lo:lo + take]
            want = decision_function(model, block, device=dev)[:take]
            assert np.array_equal(out[lo:lo + take].view(np.int32),
                                  want.view(np.int32)), (s, bucket)
        direct = decision_function(model, q, device=dev)
        worst = max(worst, float(np.max(np.abs(out - direct)))
                    / float(np.max(np.abs(direct))))
    assert E.COUNTS["captures"] == 7 and E.COUNTS["replays"] > 0
    assert worst <= 1e-5, worst


def test_sharded_decider_over_cuda_twice(dev):
    from dpsvm_tpu_torch.serving import engine as E
    from dpsvm_tpu_torch.serving.sharded import ShardedDecider
    model = _serve_model(n_sv=2049)
    sd = ShardedDecider(model, devices=[dev, dev])
    q = np.random.default_rng(6).standard_normal((64, 64)).astype(
        np.float32)
    got = sd(q).cpu().numpy()
    assert np.array_equal(got.view(np.int32),
                          sd.reference(q).cpu().numpy().view(np.int32))
    lad = E.PredictionEngine(model, max_batch=64,
                             device=dev).decision_values(q)
    assert float(np.max(np.abs(got - lad))) <= 1e-5 * float(
        np.max(np.abs(lad)))


def test_paging_out_frees_the_device_bytes(dev, tmp_path):
    """A dedicated engine's operands and graphs go with its page-out: the
    allocated device bytes fall by at least its operand bytes."""
    import gc
    from dpsvm_tpu_torch.approx.model import save_approx_model
    from dpsvm_tpu_torch.approx.primal import fit_approx
    from dpsvm_tpu_torch.fleet.modelcache import ModelCache
    from dpsvm_tpu_torch.observability.metrics import MetricsRegistry
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    xb, yb = make_blobs(n=600, d=64, seed=4)
    model, _ = fit_approx(xb, yb, SVMConfig(
        solver="approx-rff", approx_dim=4096, c=5.0, epsilon=1e-3),
        device=dev)
    path = str(tmp_path / "a.npz")
    save_approx_model(model, path)
    reg = ModelRegistry()
    reg.register("a", path, lazy=True)
    cache = ModelCache(reg, budget=2, max_batch=64,
                       metrics=MetricsRegistry())
    q = xb[:5]
    cache.infer("a", q)
    engine = cache._resident["a"].engine
    held = engine.device_bytes()
    assert engine.captured == 7 and held > 0
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert cache.evict("a") and engine.device_bytes() == 0
    del engine
    gc.collect()
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated() >= held
    assert cache.resident_bytes() == 0


def test_engine_default_device_without_cuda_raises(monkeypatch):
    """``PredictionEngine(device=None)`` means the card: without CUDA it
    raises, it never moves to the CPU (the CUDA check is stubbed off)."""
    from dpsvm_tpu_torch.serving.engine import PredictionEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PredictionEngine(_serve_model(n_sv=8, d=4))


def _pool_of(path, n, dev, **kw):
    from dpsvm_tpu_torch.serving.engine import PredictionEngine
    from dpsvm_tpu_torch.serving.pool import ReplicaPool
    return ReplicaPool(lambda i: PredictionEngine.load(
        path, max_batch=64, device=dev), n, watch_compiles=True, **kw)


def test_replicas_on_one_card_answer_bitwise_under_concurrency(dev,
                                                                tmp_path):
    """Two replicas of one artifact on cuda:0, each replaying on its own
    stream from its own thread, with an approx model's ladder replaying
    beside them: every answer bitwise ``decision_function`` on its rows
    (each ladder captures on its own stream, so no two graphs share a
    cuBLAS workspace), and no capture after the builds."""
    import threading
    from dpsvm_tpu_torch.approx.model import save_approx_model
    from dpsvm_tpu_torch.approx.primal import fit_approx
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.models.svm import decision_function
    model = _serve_model(n_sv=3000, d=96)
    path = str(tmp_path / "m.svm")
    save_model(model, path)
    xa, ya = make_blobs(n=600, d=96, seed=8)
    amodel, _ = fit_approx(xa, ya, SVMConfig(
        solver="approx-rff", approx_dim=1024, c=5.0, epsilon=1e-3),
        device=dev)
    apath = str(tmp_path / "a.npz")
    save_approx_model(amodel, apath)
    x = np.random.default_rng(3).standard_normal((4096, 96)).astype(
        np.float32)
    ref = decision_function(model, x, device=dev)
    aref = decision_function(amodel, x, device=dev)
    pool = _pool_of(path, 2, dev, name="sv")
    apool = _pool_of(apath, 2, dev, name="approx")
    bad, lock = [], threading.Lock()
    try:
        assert all(r.stream is not None for r in pool._replicas)

        def client(p, r, seed):
            rng = np.random.default_rng(seed)
            for _ in range(60):
                s, o = int(rng.integers(1, 65)), int(rng.integers(0, 4000))
                got = p.infer(x[o:o + s], ("decision",))["decision"]
                if not np.array_equal(got.view(np.int32),
                                      r[o:o + s].view(np.int32)):
                    with lock:
                        bad.append((o, s))

        ths = [threading.Thread(target=client, args=(p, r, k))
               for k, (p, r) in enumerate([(pool, ref), (pool, ref),
                                           (apool, aref), (apool, aref)])]
        for t in ths:
            t.start()
        for t in ths:
            t.join(120)
        assert not bad, bad[:5]
        assert pool.stray_compiles() == 0 and apool.stray_compiles() == 0
    finally:
        pool.close()
        apool.close()


def test_rebuild_under_traffic_captures_no_strays(dev, tmp_path):
    """A NaN-poisoned replica is ejected and rebuilt while the other keeps
    serving: the rebuild's ladder captures inside the build guard (no
    stray), nothing fails, every answer bitwise."""
    import threading
    import time
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.models.svm import decision_function
    from dpsvm_tpu_torch.resilience import faultinject as fi
    model = _serve_model(n_sv=2000, d=64)
    path = str(tmp_path / "m.svm")
    save_model(model, path)
    x = np.random.default_rng(4).standard_normal((2048, 64)).astype(
        np.float32)
    ref = decision_function(model, x, device=dev)
    pool = _pool_of(path, 2, dev, name="rb", deadline_s=30.0)
    fi.install(fi.FaultPlan(serve_nan_after=5))
    bad, lock = [], threading.Lock()
    try:
        def client(seed):
            rng = np.random.default_rng(seed)
            for _ in range(80):
                s, o = int(rng.integers(1, 65)), int(rng.integers(0, 1980))
                got = pool.infer(x[o:o + s], ("decision",))["decision"]
                if not np.array_equal(got.view(np.int32),
                                      ref[o:o + s].view(np.int32)):
                    with lock:
                        bad.append((o, s))

        ths = [threading.Thread(target=client, args=(k,)) for k in range(3)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(120)
        deadline = time.time() + 60
        while pool.replica_states() != ["closed"] * 2:
            assert time.time() < deadline, pool.replica_states()
            pool.infer(x[:3], ("decision",))
            time.sleep(0.05)
        m = pool.metrics()
        assert not bad, bad[:5]
        assert m["ejections"] == 1 and m["rebuilds"] == 1
        assert pool.stray_compiles() == 0
    finally:
        fi.clear()
        pool.close()


def test_threaded_server_on_the_card_answers_bitwise(dev, tmp_path):
    import json
    import urllib.request
    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.models.svm import decision_function
    from dpsvm_tpu_torch.observability.metrics import validate_exposition
    from dpsvm_tpu_torch.serving.registry import ModelRegistry
    from dpsvm_tpu_torch.serving.server import ServingServer
    model = _serve_model(n_sv=1500, d=32)
    path = str(tmp_path / "m.svm")
    save_model(model, path)
    reg = ModelRegistry()
    reg.register("default", path, max_batch=64)
    srv = ServingServer(reg, port=0, max_batch=64, replicas=2).start()
    try:
        x = np.random.default_rng(5).standard_normal((200, 32)).astype(
            np.float32)
        ref = decision_function(model, x, device=dev)
        for o, s in ((0, 1), (3, 17), (40, 64), (100, 33)):
            req = urllib.request.Request(
                srv.url + "/v1/predict", method="POST",
                data=json.dumps({"instances": x[o:o + s].tolist(),
                                 "return": ["decision"]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                got = np.asarray(json.loads(r.read())["decision"],
                                 np.float32)
            assert np.array_equal(got.view(np.int32),
                                  ref[o:o + s].view(np.int32))
        with urllib.request.urlopen(
                srv.url + "/metricsz?format=prometheus", timeout=30) as r:
            assert validate_exposition(r.read().decode()) == []
        man = srv.model_manifests()["default"]
        assert man["device"].startswith("cuda")
        assert man["device_name"] == torch.cuda.get_device_name(0)
        assert srv.pool("default").stray_compiles() == 0
    finally:
        srv.drain(timeout=30.0)


# ---------------------------------------------------------------------
# the driver's observability on the card
# ---------------------------------------------------------------------

def test_traced_kernel_a_run_is_bitwise_its_untraced_twin(dev, tmp_path):
    """A traced, exported, watched and profiled kernel-A run against the
    bare run: bitwise (n_iter, b, alpha), one stats read a poll in both,
    a chunk record a poll with the allocator's in-use bytes, and the
    chunk program's first-launch record with kernel A's work."""
    from dpsvm_tpu_torch.observability.report import load_trace
    from dpsvm_tpu_torch.solver import driver

    x, y = make_blobs(n=2000, d=32, seed=4)
    kw = dict(c=C, gamma=GAMMA, epsilon=1e-3, chunk_iters=64,
              max_iter=1024)
    obs = dict(trace_out=str(tmp_path / "t.jsonl"),
               metrics_out=str(tmp_path / "m.prom"), metrics_port=0,
               bundle_dir=str(tmp_path / "b"),
               profile_dir=str(tmp_path / "p"))
    runs = []
    for extra in ({}, obs):
        reads = driver.READS["stats"]
        r = train(x, y, SVMConfig(**kw, **extra), device=dev)
        runs.append((r, driver.READS["stats"] - reads))
    (bare, nb), (seen, ns) = runs
    assert np.array_equal(bare.alpha.view(np.int32),
                          seen.alpha.view(np.int32))
    assert (bare.n_iter, bare.b) == (seen.n_iter, seen.b) and nb == ns
    recs = load_trace(obs["trace_out"])
    chunks = [r for r in recs if r["kind"] == "chunk"]
    assert len(chunks) == ns
    assert all(c["hbm"]["in_use"] > 0 for c in chunks)
    comp = [r for r in recs if r["kind"] == "compile"]
    assert comp[0]["program"] == "fused-chunk"
    assert comp[0]["flops"] == 4.0 * 2000 * 32
    assert recs[0]["env"]["backend"] == "cuda"


def test_memory_snapshot_reads_the_allocator(dev):
    from dpsvm_tpu_torch.observability.device import memory_snapshot
    keep = torch.ones(1 << 20, device=dev)
    snap = memory_snapshot(dev)
    assert snap["in_use"] >= keep.numel() * 4
    assert snap["peak"] >= snap["in_use"] and snap["limit"] > snap["peak"]


def test_a_capture_is_recorded_once_per_graph_chunk(dev, tmp_path):
    """Each GraphChunk is one capture: one compile record of ``smo-chunk``
    in the run's trace, with its capture's seconds; its replays record
    none."""
    from dpsvm_tpu_torch.observability.report import load_trace
    from dpsvm_tpu_torch.solver import smo as gsmo

    x, y = make_blobs(n=300, d=8, seed=2)
    caps = gsmo.COUNTS["captures"]
    recs = []
    for i in range(2):
        cfg = SVMConfig(c=C, gamma=GAMMA, selection="second-order",
                        chunk_iters=32, max_iter=256,
                        trace_out=str(tmp_path / f"t{i}.jsonl"))
        gsmo.train_single_device(x, y, cfg, dev)
        recs += [r for r in load_trace(cfg.trace_out)
                 if r["kind"] == "compile"]
    assert gsmo.COUNTS["captures"] - caps == 2
    assert [r["program"] for r in recs] == ["smo-chunk"] * 2
    assert all(r["seconds"] > 0 and "300" in r["signature"] for r in recs)


# --------------------------------------------------------------------
# training resilience on the card: rollback into captured graphs and
# kernel A's carry, preemption, debug_nans, the doctor

@pytest.mark.parametrize("kw", [{}, dict(selection="second-order"),
                                dict(working_set=64, inner_iters=16)],
                         ids=["fused", "general", "decomp"])
def test_rollback_on_the_card_lands_bitwise(dev, tmp_path, kw):
    """A poisoned poll under rollback restores the checkpoint into the
    path's device state (kernel A's carry, the general pair's captured
    graph buffers, the decomposition's carry) and the run ends bitwise
    on its own uninterrupted run (for the decomposition: the prefix
    resumed from the restored state at the halved chunk)."""
    from dpsvm_tpu_torch.observability.report import read_trace
    from dpsvm_tpu_torch.resilience import faultinject
    x, y = make_blobs(n=600, d=16, seed=4)
    base = SVMConfig(c=C, gamma=GAMMA, epsilon=1e-12, max_iter=1024,
                     chunk_iters=128, **kw)
    trace = str(tmp_path / "t.jsonl")
    faultinject.install(faultinject.FaultPlan(nan_at_iter=300))
    try:
        rolled = train(x, y, dataclasses.replace(
            base, checkpoint_path=str(tmp_path / "s.npz"),
            checkpoint_every=128, on_divergence="rollback",
            trace_out=trace))
    finally:
        faultinject.clear()
    rb = [r for r in read_trace(trace) if r.get("event") == "rollback"]
    assert [(r["n_iter"], r["chunk_iters"]) for r in rb] == [(256, 64)]
    if "working_set" in kw:
        pre = str(tmp_path / "pre.npz")
        train(x, y, dataclasses.replace(base, max_iter=256,
                                        checkpoint_path=pre,
                                        checkpoint_every=256))
        ref = train(x, y, dataclasses.replace(base, chunk_iters=64,
                                              resume_from=pre))
    else:
        ref = train(x, y, base)
    assert rolled.n_iter == ref.n_iter
    assert rolled.b == ref.b
    np.testing.assert_array_equal(rolled.alpha, ref.alpha)


def test_preempted_kernel_a_run_resumes_bitwise_on_the_card(dev, tmp_path):
    from dpsvm_tpu_torch.resilience import faultinject
    from dpsvm_tpu_torch.resilience.supervisor import run_with_retries
    x, y = make_blobs(n=600, d=16, seed=4)
    base = SVMConfig(c=C, gamma=GAMMA, epsilon=1e-12, max_iter=1024,
                     chunk_iters=128)
    ck = str(tmp_path / "s.npz")
    faultinject.install(faultinject.FaultPlan(preempt_at_poll=3))
    fs.reset_counts()
    try:
        got = run_with_retries(
            lambda resume, k: train(x, y, dataclasses.replace(
                base, checkpoint_path=ck, checkpoint_every=128,
                resume_from=resume)),
            retries=1, backoff_s=0.0, checkpoint_path=ck)
    finally:
        faultinject.clear()
    assert fs.RUNS["fused_update_select"] == 1024
    ref = train(x, y, base)
    assert got.n_iter == ref.n_iter == 1024
    np.testing.assert_array_equal(got.alpha, ref.alpha)


def test_debug_nans_on_the_card(dev):
    from dpsvm_tpu_torch.solver import driver
    x, y = make_blobs(n=600, d=16, seed=4)
    cfg = SVMConfig(c=C, gamma=GAMMA, epsilon=1e-12, max_iter=512,
                    chunk_iters=128)
    bare = train(x, y, cfg)
    f0 = driver.READS["finite"]
    clean = train(x, y, dataclasses.replace(cfg, debug_nans=True))
    assert driver.READS["finite"] - f0 == 4
    np.testing.assert_array_equal(clean.alpha, bare.alpha)
    bad = x.copy()
    bad[5, 3] = np.nan
    with pytest.raises(FloatingPointError, match=r"\[0, "):
        train(bad, y, dataclasses.replace(cfg, debug_nans=True))


def test_doctor_on_the_card(dev, tmp_path):
    from dpsvm_tpu_torch.resilience import doctor
    lines = []
    assert doctor.run_doctor(out=lines.append) == 0
    assert torch.cuda.get_device_name(0) in lines[0]
    coll = next(ln for ln in lines if ln.startswith("collective:"))
    assert "OK" in coll and coll.endswith(" ms")


def test_run_tune_on_the_card_is_keyed_by_its_name(dev, tmp_path,
                                                   monkeypatch):
    """A tune run on the default device runs on the card and keys its
    entry by the card's name; each train probe subtracts exactly its
    captures and builds (kernel A's first chunk is work, not set-up)."""
    from dpsvm_tpu_torch.observability.schema import read_trace
    from dpsvm_tpu_torch.tuning import profile as prof
    from dpsvm_tpu_torch.tuning import tuner
    monkeypatch.setenv("DPSVM_PERF_LEDGER", str(tmp_path / "ledger.jsonl"))
    x, y = make_planted(2048, 32, 1 / 32, seed=0)
    out = str(tmp_path / "p.json")
    entry, rc = tuner.run_tune(
        x, y, base_config=SVMConfig(c=10.0, epsilon=1e-5,
                                    max_iter=10_000_000),
        knobs=("chunk_iters", "cache_lines", "serve_max_batch"),
        grids={"chunk_iters": (128, 512), "cache_lines": (0, 64),
               "serve_max_batch": (128, 256)},
        probe_iters=500, rungs=2, deadline_s=300.0, profile_out=out,
        trace_dir=str(tmp_path / "t"), log=lambda s: None)
    name = torch.cuda.get_device_name(0)
    assert rc == 0 and entry["device_kind"] == name
    assert prof.active_entry(name, path=out) is not None
    assert prof.active_entry("cpu", path=out) is None
    seen = set()
    for p in entry["probes"]:
        if p["case"] not in ("tune_probe_chunk_iters",
                             "tune_probe_cache_lines"):
            continue
        recs = [r for r in read_trace(p["trace"]) if r["kind"] == "compile"]
        progs = [r["program"] for r in recs]
        want = sum(r["seconds"] for r in recs
                   if tuner.is_setup_program(r["program"]))
        assert p["metrics"]["compile_seconds"] == pytest.approx(
            want, abs=1e-4)
        if p["case"] == "tune_probe_chunk_iters" or not p["metrics"][
                "candidate"]:
            assert progs == ["fused-chunk"] and want == 0.0
        else:
            assert progs == ["smo-chunk"] and want > 0.0
        seen.add((p["case"], p["metrics"]["candidate"]))
    assert {("tune_probe_cache_lines", 64),
            ("tune_probe_chunk_iters", 128)} <= seen


def test_fused_fit_is_bitwise_across_chunk_iters_on_the_card(dev):
    """chunk_iters moves only the poll cadence: kernel A's fit is the same
    to the bit (n_iter, alpha, b) at every chunk size."""
    x, y = make_planted(4096, 64, 1 / 64, seed=0)
    fits = {}
    for ci in (128, 512, 2048):
        r = train(x, y, SVMConfig(c=10.0, gamma=1 / 64, epsilon=1e-5,
                                  max_iter=200_000, chunk_iters=ci))
        assert r.converged
        fits[ci] = (r.n_iter, r.b, r.alpha.tobytes())
    assert fits[128] == fits[512] == fits[2048]


def test_bundle_carries_the_tuned_entry_on_the_card(dev, tmp_path,
                                                    monkeypatch):
    from dpsvm_tpu_torch.observability import blackbox
    from dpsvm_tpu_torch.tuning import profile as prof
    torch.zeros(1, device=dev)
    name = torch.cuda.get_device_name(0)
    path = prof.save_entry(prof.make_entry(name, {"chunk_iters": 2048}),
                           str(tmp_path / "p.json"))
    monkeypatch.setenv(prof.PROFILE_ENV, path)
    monkeypatch.delenv(prof.NO_TUNED_ENV, raising=False)
    assert blackbox._tuned_profile_entry()["knobs"] == {"chunk_iters": 2048}
    monkeypatch.setenv(prof.NO_TUNED_ENV, "1")
    assert blackbox._tuned_profile_entry() is None


# ------------------------------------------- sharded approx, KKT report, fleet

def test_sharded_approx_step_on_the_card(dev, nccl_world):
    """The sharded full-batch approx fit in a world of one over NCCL (the
    captured chunk with the all-reduce inside), its eager loop, and the
    one-device fit: the same steps, weights within 1e-5 of the largest
    (row padding differs: to the ranks against 256 rows)."""
    from dpsvm_tpu_torch.approx import primal
    x, y = make_planted(2304, 32, 1.0 / 32, seed=7)
    cfg = SVMConfig(solver="approx-rff", approx_dim=256, c=10.0,
                    gamma=1.0 / 32, epsilon=1e-3, max_iter=20_000)
    fits = {}
    for tag, kw in (("mesh", dict(group=nccl_world)),
                    ("mesh-eager", dict(group=nccl_world, plain=True)),
                    ("one", {})):
        primal.reset_counts()
        model, res = primal.fit_approx(x, y, cfg, device="cuda", **kw)
        assert res.converged, tag
        fits[tag] = (np.concatenate([model.w, [model.b]]), res.n_iter,
                     dict(primal.COUNTS), primal.RUN["shards"])
    w1, n1, _, _ = fits["one"]
    for tag in ("mesh", "mesh-eager"):
        w, n, counts, shards = fits[tag]
        assert shards == 1 and abs(n - n1) <= 0.01 * n1, (tag, n, n1)
        np.testing.assert_allclose(w, w1, rtol=0,
                                   atol=1e-5 * np.abs(w1).max())
    assert fits["mesh"][2]["captures"] == 1
    assert fits["mesh-eager"][2]["captures"] == 0


def test_kkt_report_on_the_card_matches_the_cpu(dev):
    from dpsvm_tpu_torch.ops.diagnostics import optimality_report
    x, y = make_planted(3000, 96, 0.25, seed=4)
    res = train(x, y, SVMConfig(c=10.0, gamma=0.25, epsilon=1e-3),
                device=dev)
    reps = [optimality_report(x, y, res.alpha, 0.25, 10.0, b=res.b,
                              device=d) for d in ("cuda", "cpu")]
    scale = max(abs(reps[1].primal), abs(reps[1].dual), 1.0)
    for k in ("dual", "primal", "gap", "eq_residual", "kkt_residual"):
        assert abs(getattr(reps[0], k) - getattr(reps[1], k)) <= \
            1e-5 * scale, k
    assert abs(reps[0].kkt_residual - res.gap) <= 2e-3


def test_fleet_cache_drill_holds_its_bounds_on_the_card(dev, tmp_path):
    from dpsvm_tpu_torch.fleet import fleet_cache_drill
    from dpsvm_tpu_torch.serving import engine as E
    caps = E.COUNTS["captures"]
    row = fleet_cache_drill(str(tmp_path), n_models=200, budget=16,
                            device="cuda")
    assert row["ok"] and row["device"].startswith("cuda")
    assert row["peak_resident"] <= 16 and row["evictions"] == 0
    assert row["touches"] == row["hits"] + row["faults"] + row["transients"]
    # every fault repacks its group's ladder once; transients capture
    # nothing
    rungs = len(E.bucket_ladder(16))
    assert E.COUNTS["captures"] - caps == row["packer"]["repacks"] * rungs
