"""The port's plain fused_update_select and fused_smo_body against the JAX
package's, with the Pallas kernel in interpret mode (as tests/test_fused.py
drives it on the CPU), the chunk wrapper's CPU path, and the CUDA kernel's
launch geometry (``launch_geometry``, a pure function the kernel's
indexing mirrors).

JAX pads to a multiple of its 512-row block with y = 0 rows; the port
does not pad. Both get the same numpy inputs (bf16 cases: the same
bf16-rounded X). Tolerances: f within 1e-6 absolute (|f| <= ~6 here):
both sides compute the same float32 expression, and only the order in
which the matmul sums d products differs (XLA's dot against PyTorch's),
which moves a dot product by a few ulps. sel_i must be equal. sel_v is f
at sel_i, so it is held to the same 1e-6.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dpsvm_tpu.experimental import fused_step as jfs
from dpsvm_tpu.experimental.fused import init_fused_carry as j_init
from dpsvm_tpu_torch.convert import carry_from_numpy
from dpsvm_tpu_torch.experimental import fused_step as tfs
from torch_threads import one_thread  # noqa: F401

C, GAMMA = 1.5, 0.25
F_ATOL = 1e-6


def _inputs(n: int, d: int, seed: int, bf16: bool):
    """(x, x2, y, alpha, f, rows, scalars) as numpy. Duplicate rows at the
    tie indices keep the tied f values equal after the update; with
    n > 512 the ties span JAX's blocks."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) / np.sqrt(d)
    if bf16:
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    y = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
    alpha = rng.choice([0.0, C, -1.0], size=n)
    alpha[alpha < 0] = rng.uniform(0.1, C - 0.1, (alpha < 0).sum())
    alpha = alpha.astype(np.float32)
    f = (-y + rng.normal(0, 0.3, n)).astype(np.float32)
    up = [3, 4, n // 2, n - 1]
    low = [5, 8, (3 * n) // 4, n - 2]
    for idx, lab, val in ((up, 1.0, -5.0), (low, -1.0, 5.0)):
        x[idx] = x[idx[0]]
        y[idx] = lab
        alpha[idx] = 0.0
        f[idx] = val
    x2 = np.einsum("ij,ij->i", x, x).astype(np.float32)
    rows = x[[1, 2]]
    scalars = np.array([0.7, -0.4, GAMMA, x2[1], x2[2], C, 0, 0], np.float32)
    return x, x2, y, alpha, f, rows, scalars


def _pad(v, n_pad):
    out = np.zeros((1, n_pad), np.float32)
    out[0, :v.shape[0]] = v
    return jnp.asarray(out)


def _jax_x(x, n_pad, bf16):
    xp = np.zeros((n_pad, x.shape[1]), np.float32)
    xp[:x.shape[0]] = x
    xj = jnp.asarray(xp)
    return xj.astype(jnp.bfloat16) if bf16 else xj


def _torch_x(x, bf16):
    xt = torch.from_numpy(x)
    return xt.to(torch.bfloat16) if bf16 else xt


@pytest.mark.parametrize("n,d,bf16", [
    (100, 7, False),      # JAX pads 100 -> 512
    (1030, 16, False),    # three JAX blocks: ties across blocks
    (90, 130, False),     # odd d
    (1030, 16, True),     # bf16 X
    (100, 130, True),
])
def test_plain_update_select_matches_pallas(n, d, bf16):
    x, x2, y, alpha, f, rows, scal = _inputs(n, d, seed=n + d, bf16=bf16)
    n_pad = jfs.pad_to_block(n, jfs.DEFAULT_BLOCK_N)
    xj = _jax_x(x, n_pad, bf16)
    rows_j = jnp.asarray(rows).astype(xj.dtype)
    f_j, si_j, sv_j = jfs.fused_update_select(
        rows_j, jnp.asarray(scal), xj, _pad(x2, n_pad), _pad(y, n_pad),
        _pad(alpha, n_pad), _pad(f, n_pad), interpret=True)
    xt = _torch_x(x, bf16)
    t = torch.from_numpy
    f_t, si_t, sv_t = tfs.fused_update_select_plain(
        xt[[1, 2]], t(scal), xt, t(x2), t(y), t(alpha), t(f.copy()))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j)[0, :n],
                               rtol=0, atol=F_ATOL)
    assert si_t.tolist() == np.asarray(si_j).tolist() == [3, 5]
    np.testing.assert_allclose(sv_t.numpy(), np.asarray(sv_j), rtol=0,
                               atol=F_ATOL)
    assert si_t.dtype == torch.int32 and sv_t.dtype == torch.float32


def test_wrapper_takes_plain_version_only_on_cpu():
    """launch_fused_chunk on CPU tensors runs the plain chunk, in place,
    and launches nothing."""
    x, x2, y, alpha, f, _, _ = _inputs(64, 8, seed=1, bf16=False)
    t = torch.from_numpy
    kw = dict(c=C, gamma=GAMMA, two_eps=2e-3, limit=5, max_iter=100)
    before = (dict(tfs.LAUNCHES), dict(tfs.RUNS))
    a = carry_from_numpy(alpha, f, y, C, device="cpu")
    ws = tfs.FusedWorkspace(t(x))
    assert tfs.launch_fused_chunk(a, t(x), t(x2), t(y), ws, **kw) == 0
    b = carry_from_numpy(alpha, f, y, C, device="cpu")
    tfs.run_chunk_plain(b, t(x), t(x2), t(y), **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert tfs.unpack_state(a.state)[4] == 5
    assert (tfs.LAUNCHES, tfs.RUNS) == before      # no kernel on CPU


@pytest.mark.parametrize("n,d,bf16", [(100, 7, False), (1030, 16, False),
                                      (90, 130, True)])
def test_body_matches_fused_smo_body(n, d, bf16):
    """Prologue + pass, several iterations, against JAX fused_smo_body.
    Each pass may move f by up to F_ATOL against JAX, and the passes'
    differences add up: after k bodies f is held to k * F_ATOL."""
    x, x2, y, alpha, f, _, _ = _inputs(n, d, seed=3 * n + d, bf16=bf16)
    n_pad = jfs.pad_to_block(n, jfs.DEFAULT_BLOCK_N)
    xj = _jax_x(x, n_pad, bf16)
    yj = _pad(y, n_pad)
    cj = j_init(_pad(alpha, n_pad), _pad(f, n_pad), yj, C)
    ct = carry_from_numpy(alpha, f, y, C, device="cpu")
    xt = _torch_x(x, bf16)
    x2t = torch.from_numpy(x2)
    yt = torch.from_numpy(y)
    for k in range(1, 7):
        cj = jfs.fused_smo_body(cj, xj, _pad(x2, n_pad), yj, C, GAMMA,
                                interpret=True)
        ct = tfs.fused_smo_body_plain(ct, xt, x2t, yt, C, GAMMA)
        i_hi, i_lo, b_hi, b_lo, n_iter = tfs.unpack_state(ct.state)
        assert (i_hi, i_lo) == (int(cj.i_hi), int(cj.i_lo))
        assert n_iter == int(cj.n_iter)
        np.testing.assert_allclose([b_hi, b_lo],
                                   [float(cj.b_hi), float(cj.b_lo)],
                                   rtol=0, atol=k * F_ATOL)
        np.testing.assert_allclose(ct.alpha.numpy(),
                                   np.asarray(cj.alpha)[0, :n],
                                   rtol=0, atol=k * F_ATOL)
        np.testing.assert_allclose(ct.f.numpy(), np.asarray(cj.f)[0, :n],
                                   rtol=0, atol=k * F_ATOL)


def test_prologue_corner_hi_equals_lo_keeps_hi():
    """i_hi == i_lo: the lo slot is written first, so the hi value stays."""
    x, x2, y, alpha, f, _, _ = _inputs(64, 8, seed=2, bf16=False)
    state = tfs.pack_state(10, 10, -1.0, 1.0, 0, "cpu")
    a = torch.from_numpy(alpha.copy())
    a_before = float(a[10])
    rows, scal = tfs.fused_prologue_plain(
        state, torch.from_numpy(x), torch.from_numpy(x2), torch.from_numpy(y),
        a, C, GAMMA)
    # eta = 0 for the same row: the step is inf/nan, both slots see it,
    # and the surviving value is the hi one: a_hi + s * (a_lo - a_lo_u)
    assert torch.equal(rows[0], rows[1])
    got = float(a[10])
    assert got != a_before or np.isnan(got)
    jc = jfs.FusedCarry(alpha=_pad(alpha, 512), f=_pad(f, 512),
                        i_hi=jnp.int32(10), i_lo=jnp.int32(10),
                        b_hi=jnp.float32(-1.0), b_lo=jnp.float32(1.0),
                        n_iter=jnp.int32(0))
    out = jfs.fused_smo_body(jc, _jax_x(x, 512, False), _pad(x2, 512),
                             _pad(y, 512), C, GAMMA, interpret=True)
    np.testing.assert_array_equal(np.asarray(out.alpha)[0, 10], got)


# Shapes of the card tests and chip_smoke.py: (n, d).
CARD_SHAPES = [(2, 8), (3, 4), (33, 7), (1000, 130), (4099, 12), (2048, 784),
               (3, 784), (4, 784), (5, 784), (31, 784), (32, 784), (33, 784),
               (20001, 784), (517, 131), (300, 16), (20001, 64), (300, 20),
               (5001, 132), (700, 24), (60000, 784), (60001, 784)]
H100_SMS = 132

# The kernel's indexing (csrc/fused_step.cu, fused_iter_kernel and Pass),
# written out in Python.


def _dealt_units(g, block, warp):
    """The units dealt to warp ``warp`` of block ``block``, in order. The
    units from ``g.dealt`` on are taken at run time, one each time."""
    return list(range(block * tfs.WARPS + warp, g.dealt, g.grid * tfs.WARPS))


def _unit_rows(g, n, unit):
    return list(range(unit * g.group, min(n, (unit + 1) * g.group)))


def _unit_chunks(g, d, lane):
    """The (row of the unit, chunk) pairs lane ``lane`` reads in a unit:
    whole 32-chunk rounds of each row, then the tail chunks of the unit's
    rows spread over the lanes."""
    full = (d // g.chunk) // 32
    out = [(r, k * 32 + lane) for r in range(g.group) for k in range(full)]
    for idx in range(lane, g.group * g.tail, 32):
        out.append((idx // g.tail, full * 32 + idx % g.tail))
    return out


def _geometry_covers(n, d, elem, vec):
    g = tfs.launch_geometry(n, d, elem, H100_SMS, vec)
    assert 1 <= g.grid <= H100_SMS and g.partials == g.grid
    assert g.threads == 32 * tfs.WARPS and g.smem <= tfs.SMEM_LIMIT
    # every unit exactly once: dealt to one warp, or taken from the pool
    dealt = [u for b in range(g.grid) for w in range(tfs.WARPS)
             for u in _dealt_units(g, b, w)]
    assert len(dealt) == g.dealt == len(set(dealt))
    assert sorted(dealt + list(range(g.dealt, g.units))) == list(
        range(g.units))
    assert g.dealt % (g.grid * tfs.WARPS) == 0   # an equal share a warp
    rows = [r for u in range(g.units) for r in _unit_rows(g, n, u)]
    assert rows == list(range(n))                # every row exactly once
    # every chunk of every row of a unit exactly once, over the 32 lanes
    seen = [c for lane in range(32) for c in _unit_chunks(g, d, lane)]
    assert sorted(seen) == [(r, c) for r in range(g.group)
                            for c in range(d // g.chunk)]
    return g


@pytest.mark.parametrize("n,d", CARD_SHAPES)
@pytest.mark.parametrize("elem", [4, 2])
def test_launch_geometry_covers_every_row_once(n, d, elem):
    vec = d % (16 // elem) == 0
    g = _geometry_covers(n, d, elem, vec)
    if (n, d) == (60000, 784):
        assert g.grid == H100_SMS and g.units == 15000
        assert g.chunk == 16 // elem and g.tail == (2 if elem == 2 else 4)


@pytest.mark.parametrize("elem", [4, 2])
def test_launch_geometry_fits_every_width(elem):
    """d from 1 to 4096: the vector path where d fills 16-byte chunks, the
    scalar path always; shared memory within the 227 KB a block has; the
    whole rounds and the tail add up to the row."""
    for d in range(1, 4097):
        for vec in ((True, False) if d % (16 // elem) == 0 else (False,)):
            g = tfs.launch_geometry(1000, d, elem, H100_SMS, vec)
            assert g.smem <= tfs.SMEM_LIMIT
            assert (d // g.chunk) // 32 * 32 + g.tail == d // g.chunk
    for d in (1, 31, 33, 97, 1000, 4095, 4096):   # chunk coverage, sampled
        _geometry_covers(1000, d, elem, False)


def test_launch_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fill"):
        tfs.launch_geometry(100, 7, 4, H100_SMS, vec=True)
    with pytest.raises(ValueError, match="shared memory"):
        tfs.launch_geometry(100, 40000, 4, H100_SMS, vec=False)
