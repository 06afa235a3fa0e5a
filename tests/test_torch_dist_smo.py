"""The port's distributed SMO pair (``parallel/dist_smo.py``) in gloo ranks
on the CPU, against the JAX package's distributed steps.

The JAX package's trainer (``train_distributed``) fails on this JAX (0.9)
in its stats wrapper, at the ``jnp.concatenate`` of the replicated stats
with the per-shard probe; its steps do not. So the reference here is a
harness this file builds: ``_dist_step`` / ``_dist_step_wss2`` in a
``lax.while_loop`` under ``parallel/mesh.shard_map_compat`` on the CPU
mesh (conftest gives 8 devices), the carry's scalars marked varying and
folded by ``pmax`` on exit, as ``_build_dist_runner`` does. The harness
also records each iteration's (i_hi, i_lo), by the same gathers and scans
the steps make.

Bars, and why:

* the port's ranks against the harness at the same P: the same n_iter and
  (i_hi, i_lo) sequence, alpha within rtol 1e-4 / atol 1e-5 and |db| <
  1e-4 (the JAX package's ``_check_vs_single``): the two sum the same
  float32 products in their own orders, so alpha agrees to a few ulps;
* the row cache against no cache, and P = 1 against the port's general
  pair (``solver/smo.py``): bit for bit (a cached row is the product a
  miss computes; a world of one adds nothing in its collectives);
* one-class: decision values within 2e-3 of the JAX package's
  single-device model (``test_oneclass_distributed_parity``'s bar);
* every rank returns the same result, bit for bit.

The ranks of one world size start once for the whole file (a fixture);
each case reads its scenario's result.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_dist_scenarios import launch

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs, make_planted, make_xor
from dpsvm_tpu.solver.oracle import smo_reference
from dpsvm_tpu_torch import SVMConfig, train
from dpsvm_tpu_torch.resilience.health import DesyncError
from dpsvm_tpu_torch.solver.driver import ChunkStats, check_probe

BLOBS = make_blobs(n=96, d=6, seed=3)
ODD = make_blobs(n=101, d=5, seed=7)
XOR = make_xor(n=120, seed=1)
BASE = dict(c=1.0, gamma=0.5, epsilon=1e-3, max_iter=20_000, chunk_iters=128)


def _planted_k():
    """Planted 80 x 12 rows and their RBF matrix at gamma 0.25."""
    x, y = make_planted(80, 12, 0.25, seed=2)
    xd = x.astype(np.float64)
    k = np.exp(-0.25 * ((xd[:, None] - xd[None]) ** 2).sum(-1))
    return x, y, k.astype(np.float32)


PX, PY, PK = _planted_k()


def _svr_data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(60, 4)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=60)).astype(np.float32)
    return x, y


SX, SY = _svr_data()
CLOUD = np.random.default_rng(0).normal(size=(120, 4)).astype(np.float32)

# name -> (world, data, config fields, JAX harness options)
CASES = {
    "blobs-2": (2, BLOBS, BASE, {}),
    "blobs-4": (4, BLOBS, BASE, {}),
    "blobs-8": (8, BLOBS, BASE, {}),
    "odd-8": (8, ODD, dict(BASE, chunk_iters=64), {}),
    "replicated-4": (4, BLOBS, dict(BASE, shard_x=False), {}),
    "wss2-4": (4, BLOBS, dict(BASE, selection="second-order"), {}),
    "wss2-replicated-4": (4, BLOBS, dict(BASE, selection="second-order",
                                         shard_x=False), {}),
    "packed-4": (4, BLOBS, dict(BASE, select_impl="packed"), {}),
    "weighted-pairwise-4": (4, BLOBS, dict(BASE, weight_pos=2.0,
                                           weight_neg=0.5,
                                           clip="pairwise"), {}),
    "poly-4": (4, (PX, PY), dict(BASE, kernel="poly", gamma=1 / 12,
                                 coef0=1.0, degree=3, c=1.0), {}),
    "precomputed-4": (4, (PK, PY), dict(BASE, kernel="precomputed"), {}),
    "precomputed-wss2-4": (4, (PK, PY), dict(BASE, kernel="precomputed",
                                             selection="second-order"), {}),
}


def _scenarios(world):
    out = []
    for name, (p, (x, y), cfg, _) in CASES.items():
        if p == world:
            out.append(dict(name=name, x=x, y=y, cfg=cfg))
    if world == 8:
        out.append(dict(name="xor-8", x=XOR[0], y=XOR[1],
                        cfg=dict(c=10.0, gamma=1.0, epsilon=1e-3,
                                 max_iter=20_000, chunk_iters=256)))
    if world == 4:
        for lines in (0, 2, 8):
            for sx in (True, False):
                out.append(dict(name=f"cache-{lines}-{sx}", x=BLOBS[0],
                                y=BLOBS[1], cfg=dict(BASE, cache_size=lines,
                                                     shard_x=sx)))
        out.append(dict(name="svr-4", what="svr", x=SX, y=SY,
                        cfg=dict(c=1.0, gamma=0.5, svr_epsilon=0.1,
                                 epsilon=1e-3, max_iter=20_000)))
        out.append(dict(name="oneclass-4", what="oneclass", x=CLOUD,
                        nu=0.2, cfg=dict(max_iter=50_000)))
        out.append(dict(name="group-overrides-4", x=BLOBS[0], y=BLOBS[1],
                        cfg=dict(BASE, shards=2), group=True))
        out.append(dict(name="mesh-64", what="mesh", shards=64))
    if world == 1:
        for tag, extra in P1_BRANCHES.items():
            out.append(dict(name=f"p1-{tag}", x=BLOBS[0], y=BLOBS[1],
                            cfg=dict(BASE, **extra), group=True))
    return out


P1_BRANCHES = {
    "first-order": {},
    "second-order": dict(selection="second-order"),
    "weighted-pairwise": dict(weight_pos=2.0, clip="pairwise"),
    "linear": dict(kernel="linear"),
    "replicated": dict(shard_x=False),
}

_RESULTS = {}


@pytest.fixture(scope="module")
def ranks():
    def get(world):
        if world not in _RESULTS:
            _RESULTS[world] = launch(world, _scenarios(world))
        return _RESULTS[world]
    return get


def _ok(r):
    assert "exception" not in r, r.get("exception")
    assert r["ranks_agree"]
    return r


# ------------------------------------------------------------ the harness

def jax_dist(x, y, p, cfg, f_init=None, alpha_init=None, guard_eta=False):
    """The JAX package's distributed steps in a while_loop under
    shard_map_compat: (n_iter, alpha, b, (i_hi, i_lo) sequence)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as PS

    from dpsvm_tpu.ops.selection import (masked_extrema,
                                         masked_extrema_packed,
                                         masked_scores_and_masks)
    from dpsvm_tpu.ops.kernels import kdiag_from_norms, rows_from_dots
    from dpsvm_tpu.parallel import dist_smo as jd
    from dpsvm_tpu.parallel.mesh import (SHARD_AXIS, make_data_mesh,
                                         pcast_varying, shard_map_compat)

    config = JConfig(shards=p, **cfg)
    mesh = make_data_mesh(p)
    n, d = x.shape
    di = jd.prepare_distributed_inputs(x, y, config, mesh, None, f_init,
                                       alpha_init)
    kspec = config.kernel_spec(d)
    n_s, eps, t_max = di.n_s, float(config.epsilon), int(config.max_iter)
    second = config.selection == "second-order"
    weights = (float(config.weight_pos), float(config.weight_neg))
    kw = dict(c=float(config.c), kspec=kspec, n_per_shard=n_s,
              shard_x=config.shard_x, precision=lax.Precision.HIGHEST,
              weights=weights, pairwise_clip=config.clip == "pairwise")
    if second:
        step = jd._dist_step_wss2
    else:
        step = jd._dist_step
        kw.update(packed_select=config.select_impl == "packed",
                  guard_eta=guard_eta)
    carry = jd.DistCarry(
        alpha=jax.device_put(np.asarray(di.init[0], np.float32), di.shard),
        f=jax.device_put(np.asarray(di.init[1], np.float32), di.shard),
        b_hi=jax.device_put(np.float32(di.init[2]), di.repl),
        b_lo=jax.device_put(np.float32(di.init[3]), di.repl),
        n_iter=jax.device_put(np.int32(0), di.repl),
        ck=jax.device_put(np.full((0,), -1, np.int32), di.shard),
        cs=jax.device_put(np.zeros((0,), np.int32), di.shard),
        cr=jax.device_put(np.zeros((0, n_s), np.float32), di.shard),
        ch=jax.device_put(np.int32(0), di.repl),
        cm=jax.device_put(np.int32(0), di.repl))

    def pair(s, xs, ys, x2s, valid):
        # the working pair as the steps choose it (their gathers and
        # scans, recorded, not used)
        rank = lax.axis_index(SHARD_AXIS)
        c_box, _ = jd._weighted_box(kw["c"], weights, ys)
        if not second:
            sel = (masked_extrema_packed if config.select_impl == "packed"
                   else masked_extrema)
            li_hi, lb_hi, li_lo, lb_lo = sel(s.alpha, ys, s.f, c_box, valid)
            fv = lax.all_gather(jnp.stack([lb_hi, lb_lo]), SHARD_AXIS)
            iv = lax.all_gather(jnp.stack([li_hi, li_lo]).astype(jnp.int32)
                                + rank * n_s, SHARD_AXIS)
            return jnp.stack([iv[jnp.argmin(fv[:, 0]), 0],
                              iv[jnp.argmax(fv[:, 1]), 1]])
        f_up, f_low, _, in_low = masked_scores_and_masks(s.alpha, ys, s.f,
                                                         c_box, valid)
        li_hi = jnp.argmin(f_up)
        fv = lax.all_gather(f_up[li_hi], SHARD_AXIS)
        iv = lax.all_gather(li_hi.astype(jnp.int32) + rank * n_s,
                            SHARD_AXIS)
        p_hi = jnp.argmin(fv)
        b_hi, i_hi = fv[p_hi], iv[p_hi]
        loc, own = i_hi - p_hi * n_s, rank == p_hi
        row, x2_hi, _, _ = jd._broadcast_row(xs, ys, x2s, s.alpha, loc, own,
                                             i_hi, shard_x=config.shard_x)
        xs_l, x2s_l = jd._local_slice(xs, x2s, rank, n_s, config.shard_x)
        if kspec.kind == "precomputed":
            k_hi = lax.dynamic_slice_in_dim(row, rank * n_s, n_s)
        else:
            k_hi = rows_from_dots(jnp.matmul(
                row[None], xs_l.T, precision=lax.Precision.HIGHEST),
                x2_hi[None], x2s_l, kspec)[0]
        bb = f_low - b_hi
        a = (jnp.maximum(2.0 - 2.0 * k_hi, 1e-12) if kspec.is_rbf else
             jnp.maximum(kdiag_from_norms(x2_hi, kspec)
                         + kdiag_from_norms(x2s_l, kspec) - 2.0 * k_hi,
                         1e-12))
        obj = jnp.where(in_low & (bb > 0), bb * bb / a, -1.0)
        li_lo = jnp.argmax(obj)
        ov = lax.all_gather(obj[li_lo], SHARD_AXIS)
        ig = lax.all_gather(li_lo.astype(jnp.int32) + rank * n_s,
                            SHARD_AXIS)
        return jnp.stack([i_hi, ig[jnp.argmax(ov)]])

    def run(c, h, xs, ys, x2s, valid):
        def cond(s):
            c = s[0]
            return (c.b_lo > c.b_hi + 2.0 * eps) & (c.n_iter < t_max)

        def body(s):
            c, h = s
            h = h.at[c.n_iter].set(pair(c, xs, ys, x2s, valid))
            return step(c, xs, ys, x2s, valid, **kw), h

        c = c._replace(b_hi=pcast_varying(c.b_hi),
                       b_lo=pcast_varying(c.b_lo),
                       n_iter=pcast_varying(c.n_iter),
                       ch=pcast_varying(c.ch), cm=pcast_varying(c.cm))
        c, h = lax.while_loop(cond, body, (c, pcast_varying(h)))
        fold = lambda v: lax.pmax(v, SHARD_AXIS)
        return c._replace(b_hi=fold(c.b_hi), b_lo=fold(c.b_lo),
                          n_iter=fold(c.n_iter), ch=fold(c.ch),
                          cm=fold(c.cm)), fold(h)

    shard, repl = PS(SHARD_AXIS), PS()
    x_spec = shard if config.shard_x else repl
    specs = jd.DistCarry(alpha=shard, f=shard, b_hi=repl, b_lo=repl,
                         n_iter=repl, ck=shard, cs=shard,
                         cr=PS(SHARD_AXIS, None), ch=repl, cm=repl)
    mapped = shard_map_compat(
        run, mesh=mesh,
        in_specs=(specs, repl, x_spec, shard, x_spec, shard),
        out_specs=(specs, repl))
    h0 = jnp.full((t_max, 2), -1, jnp.int32)
    out, h = jax.jit(mapped)(carry, h0, di.xd, di.yd, di.x2, di.validd)
    n_iter = int(out.n_iter)
    alpha = np.asarray(out.alpha)[:n]
    b = (float(out.b_lo) + float(out.b_hi)) / 2.0
    return n_iter, alpha, b, [tuple(map(int, r)) for r in
                              np.asarray(h)[:n_iter]]


def _against_harness(r, x, y, p, cfg, **kw):
    n_iter, alpha, b, seq = jax_dist(x, y, p, cfg, **kw)
    assert r["n_iter"] == n_iter
    if "seq" in r:
        assert r["seq"] == seq
    np.testing.assert_allclose(r["alpha"], alpha, rtol=1e-4, atol=1e-5)
    assert abs(r["b"] - b) < 1e-4
    return seq


# ------------------------------------------------------------ the cases

@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_match_the_jax_steps(ranks, name):
    p, (x, y), cfg, opts = CASES[name]
    r = _ok(ranks(p)[name])
    assert r["converged"]
    seq = _against_harness(r, x, y, p, cfg, **opts)
    assert max(max(s) for s in seq) < len(y)      # no padding row chosen


def test_xor_takes_the_oracles_iterations(ranks):
    x, y = XOR
    r = _ok(ranks(8)["xor-8"])
    ref = smo_reference(x, y, JConfig(c=10.0, gamma=1.0, epsilon=1e-3,
                                      max_iter=20_000))
    assert r["n_iter"] == ref.n_iter
    np.testing.assert_allclose(r["alpha"], ref.alpha, rtol=1e-4, atol=1e-5)


def test_padding_rows_never_selected(ranks):
    r = _ok(ranks(8)["odd-8"])
    assert len(r["alpha"]) == len(ODD[1]) == 101
    assert all(i < 101 and j < 101 for i, j in r["seq"])


@pytest.mark.parametrize("lines", [2, 8])
@pytest.mark.parametrize("shard_x", [True, False])
def test_row_cache_is_bit_equal_to_uncached(ranks, lines, shard_x):
    res = ranks(4)
    plain = _ok(res[f"cache-0-{shard_x}"])
    cached = _ok(res[f"cache-{lines}-{shard_x}"])
    assert cached["n_iter"] == plain["n_iter"]
    np.testing.assert_array_equal(cached["alpha"], plain["alpha"])
    assert cached["b"] == plain["b"]
    assert cached["cache_hits"] + cached["cache_misses"] == 2 * cached[
        "n_iter"]
    assert cached["cache_hits"] > 0 or lines == 2


def test_svr_seed_with_guard_eta(ranks):
    """epsilon-SVR's 2n-row seeded problem through api.train's f_init and
    guard_eta, held to the JAX steps on the same seed."""
    r = _ok(ranks(4)["svr-4"])
    n = len(SY)
    p = np.float32(0.1)
    x2n = np.vstack([SX, SX])
    z = np.concatenate([np.ones(n, np.int32), -np.ones(n, np.int32)])
    f0 = np.concatenate([p - SY, -p - SY]).astype(np.float32)
    _against_harness(r, x2n, z, 4, dict(c=1.0, gamma=0.5, epsilon=1e-3,
                                        max_iter=20_000, clip="pairwise"),
                     f_init=f0, guard_eta=True)


def test_oneclass_matches_the_single_device_model(ranks):
    from dpsvm_tpu.models.oneclass import score_oneclass, train_oneclass
    r = _ok(ranks(4)["oneclass-4"])
    assert r["converged"]
    m1, _ = train_oneclass(CLOUD, nu=0.2, config=JConfig(max_iter=50_000))
    np.testing.assert_allclose(r["score"], score_oneclass(m1, CLOUD),
                               atol=2e-3)
    assert abs(float(np.sum(r["alpha"])) - 0.2 * len(CLOUD)) < 1e-3


def test_explicit_group_overrides_config_shards(ranks):
    r = _ok(ranks(4)["group-overrides-4"])
    seq = _against_harness(r, *BLOBS, 4, BASE)
    assert seq


def test_mesh_size_is_checked(ranks):
    r = ranks(4)["mesh-64"]
    assert r["error"].startswith("need 64 devices for 64 shards, have 4")


@pytest.mark.parametrize("tag", sorted(P1_BRANCHES))
def test_world_of_one_is_the_general_pair_bit_for_bit(ranks, tag):
    from dpsvm_tpu_torch.solver.smo import train_single_device
    r = _ok(ranks(1)[f"p1-{tag}"])
    cfg = {k: v for k, v in dict(BASE, **P1_BRANCHES[tag]).items()
           if k != "shard_x"}
    single = train_single_device(*BLOBS, SVMConfig(**cfg),
                                 torch.device("cpu"))
    assert r["n_iter"] == single.n_iter
    np.testing.assert_array_equal(r["alpha"], single.alpha)
    assert (r["b_lo"], r["b_hi"]) == (single.b_lo, single.b_hi)


def test_no_group_raises_naming_the_launchers():
    x, y = BLOBS
    for cfg in (dict(shards=2), dict(shards=2, working_set=8),
                dict(shards=2, shrinking=True)):
        with pytest.raises(RuntimeError) as e:
            train(x, y, SVMConfig(**cfg), device="cpu")
        for word in ("--shards", "launch_local", "torchrun",
                     "multihost.initialize"):
            assert word in str(e.value)


def test_probe_rows_that_disagree_raise():
    # ranks at one iteration whose gap bits differ are a desync; a rank
    # behind the others is lag, which the heartbeats report instead
    st = ChunkStats(10, 1.0, 0.0, 3, 0, (), ((10, 1, 2), (10, 1, 2)))
    check_probe(st)
    check_probe(st._replace(probe=((10, 1, 2), (9, 1, 2))))
    with pytest.raises(DesyncError, match="disagree"):
        check_probe(st._replace(probe=((10, 1, 2), (10, 1, 3))))
