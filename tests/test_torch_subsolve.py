"""The port's inner subsolve (``experimental/subsolve_kernel.py``) on the
CPU, where ``launch_inner_subsolve`` runs the plain version, against the
JAX package's XLA ``inner_subsolve`` and its Pallas kernel
``pallas_inner_subsolve`` in interpret mode, on the blocks of
tests/test_subsolve_kernel.py.

Bar: the same t; a, f and the b's within rtol 1e-5 / atol 1e-6. Both
sides are float32 elementwise chains over the same K_WW; only FMA
contraction and the order of operations differ. At cap 1 the comparison
is with the XLA subsolve alone: there the interpret-mode kernel rounds its
single f update differently from XLA (test_subsolve_kernel.py's xfail).

The kernel's launch shape, ``launch_geometry``, is a pure function and is
checked here too: every slot owned by exactly one block and thread, the
limits of a cluster and a block, one block below the measured threshold,
and the constants it shares with ``csrc/subsolve.cu``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.experimental.subsolve_kernel import pallas_inner_subsolve
from dpsvm_tpu.solver.decomp import inner_subsolve
from dpsvm_tpu_torch.experimental import subsolve_kernel as sk
from test_subsolve_kernel import _block
from torch_threads import one_thread  # noqa: F401

EPS = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(kww, y_w, c_w, a0, f0, active, eps, step_cap, max_cap, pairwise):
    return sk.launch_inner_subsolve(
        _t(kww), _t(y_w), _t(c_w), _t(a0), _t(f0), _t(active), eps,
        step_cap, max_cap=max_cap, pairwise=pairwise)


def _assert_close(got, ref):
    """got: the port's (a, f, b_hi, b_lo, t); ref: the JAX 5-tuple."""
    a, f, bh, bl, t = got
    assert t.dtype == torch.int32
    assert int(t) == int(ref[4])
    for mine, theirs in ((a, ref[0]), (f, ref[1]), (bh, ref[2]),
                         (bl, ref[3])):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pairwise", [False, True])
@pytest.mark.parametrize("cap", [1, 37, 200])
def test_plain_matches_jax_inner_and_pallas(pairwise, cap):
    kww, y_w, c_w = _block()
    q = kww.shape[0]
    a0 = jnp.zeros((q,), jnp.float32)
    f0 = -y_w
    active = jnp.ones((q,), bool)
    got = _port(kww, y_w, c_w, a0, f0, active, EPS, cap, cap, pairwise)
    ref = inner_subsolve(kww, y_w, c_w, a0, f0, active, epsilon=EPS,
                         step_cap=jnp.int32(cap), pairwise_clip=pairwise)
    _assert_close(got, tuple(ref))
    if cap > 1:
        _assert_close(got, pallas_inner_subsolve(
            kww, y_w, c_w, a0, f0, active, EPS, cap, max_cap=cap,
            pairwise=pairwise, interpret=True))


@pytest.mark.parametrize("pairwise", [False, True])
def test_weighted_boxes_and_masked_slots(pairwise):
    kww, y_w, c_w = _block(seed=7, weighted=True)
    q = kww.shape[0]
    a0 = jnp.zeros((q,), jnp.float32)
    f0 = -y_w
    active = jnp.arange(q) < q - 8          # last 8 slots masked out
    got = _port(kww, y_w, c_w, a0, f0, active, EPS, 150, 150, pairwise)
    ref = pallas_inner_subsolve(kww, y_w, c_w, a0, f0, active, EPS, 150,
                                max_cap=150, pairwise=pairwise,
                                interpret=True)
    _assert_close(got, ref)
    _assert_close(got, tuple(inner_subsolve(
        kww, y_w, c_w, a0, f0, active, epsilon=EPS,
        step_cap=jnp.int32(150), pairwise_clip=pairwise)))
    assert np.all(got[0].numpy()[q - 8:] == 0)   # masked slots untouched


def test_already_optimal_block_noops():
    """Seeded with the block's real entry extrema, a converged block takes
    zero steps and returns its input untouched."""
    kww, y_w, c_w = _block(seed=3)
    q = kww.shape[0]
    active = jnp.ones((q,), bool)
    done = inner_subsolve(kww, y_w, c_w, jnp.zeros((q,), jnp.float32), -y_w,
                          active, epsilon=EPS, step_cap=jnp.int32(100_000),
                          pairwise_clip=False)
    a, f, _, _, t = _port(kww, y_w, c_w, done.a, done.f, active, EPS, 100,
                          100, False)
    assert int(t) == 0
    np.testing.assert_array_equal(a.numpy(), np.asarray(done.a))
    np.testing.assert_array_equal(f.numpy(), np.asarray(done.f))


def test_dynamic_step_cap_below_max_cap():
    kww, y_w, c_w = _block(seed=5)
    q = kww.shape[0]
    a0 = jnp.zeros((q,), jnp.float32)
    active = jnp.ones((q,), bool)
    got = _port(kww, y_w, c_w, a0, -y_w, active, 1e-6, 7, 100, False)
    assert int(got[4]) == 7
    _assert_close(got, pallas_inner_subsolve(
        kww, y_w, c_w, a0, -y_w, active, 1e-6, 7, max_cap=100,
        pairwise=False, interpret=True))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    kww, y_w, c_w = _block(seed=9)
    q = kww.shape[0]
    args = (_t(kww), _t(y_w), _t(c_w), torch.zeros(q), -_t(y_w),
            torch.ones(q, dtype=torch.bool), EPS, 50)
    before = (dict(sk.LAUNCHES), dict(sk.RUNS))
    got = sk.launch_inner_subsolve(*args, max_cap=50, pairwise=True)
    ref = sk.inner_subsolve_plain(*args, max_cap=50, pairwise=True)
    assert (sk.LAUNCHES, sk.RUNS) == before
    for u, v in zip(got, ref):
        assert torch.equal(u, v)


# ------------------------------------------------------------ launch shape
# launch_geometry against the kernel's indexing (csrc/subsolve.cu): block
# r owns slots [r * slots, (r + 1) * slots), thread t of a block the slot
# pairs 2 (t + threads p) + {0, 1} for p < per.

H100_SMS = 132
GEOMETRY_QS = [1, 2, 4, 30, 32, 33, 1030, 2048, 4096, 12288, 12290, 16384]


def _owners(g, q):
    """slot -> the (block, thread, p) that own it, in the kernel's
    indexing."""
    seen = {}
    for b in range(g.cluster):
        base = b * g.slots
        n_loc = max(0, min(g.slots, q - base))
        for t in range(g.threads):
            for p in range(g.per):
                for e in (0, 1):
                    slot = 2 * (t + g.threads * p) + e
                    if slot < n_loc:
                        seen.setdefault(base + slot, []).append((b, t, p))
    return seen


def _check_shape(g, q):
    seen = _owners(g, q)
    assert sorted(seen) == list(range(q))               # every slot owned
    assert all(len(v) == 1 for v in seen.values())      # by exactly one
    assert 1 <= g.cluster <= sk.MAX_CLUSTER == 16
    assert g.cluster & (g.cluster - 1) == 0
    assert g.threads % 32 == 0 and 32 <= g.threads <= sk.MAX_THREADS
    assert g.slots % 2 == 0 and g.smem == g.slots * sk.SLOT_BYTES
    assert g.smem + sk.STATIC_SMEM <= sk.SMEM_LIMIT == 227 * 1024
    assert 2 * g.threads * g.per >= g.slots
    assert g.per in (1, 2, 4, 8) and g.per <= sk.MAX_PER


@pytest.mark.parametrize("q", GEOMETRY_QS)
def test_launch_geometry_owns_every_slot_once(q):
    g = sk.launch_geometry(q, H100_SMS)
    _check_shape(g, q)
    if q < sk.CLUSTER_MIN_Q:
        assert g.cluster == 1                 # below the measured threshold
    else:
        assert g.cluster > 1
        assert g.slots <= sk.BLOCK_SLOTS or g.cluster == sk.MAX_CLUSTER


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("q", [1, 4, 33, 1030, 8192, 12290, 16384])
def test_launch_geometry_forced_clusters(q, cluster):
    """A forced cluster gives the same ownership, with short or empty
    blocks where q is small; a block that would not fit is refused."""
    fits = -(-q // (2 * cluster)) * 2 * sk.SLOT_BYTES + sk.STATIC_SMEM \
        <= sk.SMEM_LIMIT and -(-q // (2 * cluster)) <= sk.MAX_THREADS * 8
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            sk.launch_geometry(q, H100_SMS, cluster)
        return
    g = sk.launch_geometry(q, H100_SMS, cluster)
    assert g.cluster == cluster
    _check_shape(g, q)


def test_launch_geometry_refuses_what_the_kernel_does_not_take():
    for q in (0, sk.MAX_Q + 1):
        with pytest.raises(ValueError, match="q <="):
            sk.launch_geometry(q, H100_SMS)
    for cluster in (0, 3, 32):
        with pytest.raises(ValueError, match="power of two"):
            sk.launch_geometry(100, H100_SMS, cluster)
    with pytest.raises(ValueError, match="power of two"):
        sk.launch_geometry(100, 8, 16)        # more blocks than SMs


def test_launch_geometry_constants_match_the_source():
    src = (Path(sk.__file__).resolve().parents[1] / "csrc"
           / "subsolve.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxQ") == sk.MAX_Q
    assert const("kMaxCluster") == sk.MAX_CLUSTER
    assert const("kMaxThreads") == sk.MAX_THREADS
    assert const("kMaxPer") == sk.MAX_PER
    assert "kSlotBytes = 5 * sizeof(float) + 1;" in src and sk.SLOT_BYTES == 21
    # static shared memory: a 48-byte record a warp, two buffers of one a
    # block, two 8-byte mbarriers
    assert "Rec part[kMaxWarps];" in src
    assert "Rec xbuf[2][kMaxCluster];" in src
    assert sk.STATIC_SMEM == 48 * (const("kMaxThreads") // 32
                                   + 2 * const("kMaxCluster")) + 2 * 8
