"""The port's distributed decomposition (``parallel/dist_decomp.py``) in gloo
ranks on the CPU, against the JAX package.

The reference is the JAX package's ``_dist_decomp_step`` in a
``lax.while_loop`` under ``shard_map_compat`` on the CPU mesh, the carry's
scalars marked varying and folded by ``pmax`` on exit (its trainer fails
on this JAX in its stats wrapper, its step runs), built by this file.

Bar (``tests/test_dist_decomp.py::_check``, and why): the distributed
rounds tile their (q, d) . (d, n_s) fetch by shard, so one ulp of a
kernel entry can flip a near-tie and the trajectories part; the contract
is an equally good eps-KKT point of the same dual: converged, the f64
KKT gap of the final alpha within 2 eps + 5e-4, |db| <= 1e-3 against the
recomputed b, alpha in its box, and n_sv within max(3, 5%) of the JAX
run's. A world of one is held to the port's single-device decomposition
bit for bit (its rounds are the same calls on the same inputs), and every
rank returns the same result.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_decomp import true_gap_and_b
from torch_dist_scenarios import launch

from dpsvm_tpu.config import SVMConfig as JConfig
from dpsvm_tpu.data.synthetic import make_blobs, make_planted
from dpsvm_tpu_torch import SVMConfig

# Problems of a few hundred pair updates (~20-35 rounds): every round
# waits on three collectives, and gloo ranks share this host's cores.
PLANTED = make_planted(800, 32, gamma=0.5, seed=1)
SMALL = make_planted(400, 16, gamma=0.5, seed=1)
ODD = make_blobs(n=333, d=6, seed=3)
TINY = make_blobs(n=96, d=5, seed=5)
BASE = dict(c=1.0, gamma=0.5, epsilon=1e-3, max_iter=200_000,
            working_set=128, chunk_iters=2048)

# name -> (world, data, config fields)
CASES = {
    "planted-2": (2, PLANTED, BASE),
    "planted-4": (4, PLANTED, BASE),
    "planted-replicated-4": (4, PLANTED, dict(BASE, shard_x=False)),
    "odd-8": (8, ODD, dict(BASE, c=2.0, max_iter=100_000, working_set=32)),
    "tiny-8": (8, TINY, dict(BASE, max_iter=50_000, working_set=64)),
    "weighted-pairwise-4": (4, SMALL, dict(BASE, weight_pos=2.0,
                                           weight_neg=0.5, working_set=64,
                                           clip="pairwise")),
}
P1_BRANCHES = {
    "rbf": {},
    "weighted-pairwise": dict(weight_pos=2.0, clip="pairwise"),
    "linear": dict(kernel="linear"),
    "replicated": dict(shard_x=False),
    "capped": dict(inner_iters=8),
}

_RESULTS = {}


def _scenarios(world):
    out = [dict(name=name, x=x, y=y, cfg=cfg)
           for name, (p, (x, y), cfg) in CASES.items() if p == world]
    if world == 1:
        out += [dict(name=f"p1-{tag}", x=SMALL[0], y=SMALL[1],
                     cfg=dict(BASE, working_set=64, **extra), group=True)
                for tag, extra in P1_BRANCHES.items()]
    return out


@pytest.fixture(scope="module")
def ranks():
    def get(world):
        if world not in _RESULTS:
            _RESULTS[world] = launch(world, _scenarios(world))
        return _RESULTS[world]
    return get


def jax_dist_decomp(x, y, p, cfg):
    """The JAX package's distributed round in a while_loop under
    shard_map_compat: (n_iter, rounds, alpha, b)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as PS

    from dpsvm_tpu.parallel import dist_decomp as jdd
    from dpsvm_tpu.parallel import dist_smo as jd
    from dpsvm_tpu.parallel.mesh import (SHARD_AXIS, make_data_mesh,
                                         pcast_varying, shard_map_compat)

    config = JConfig(shards=p, **{k: v for k, v in cfg.items()
                                  if k != "chunk_iters"})
    mesh = make_data_mesh(p)
    n, d = x.shape
    di = jd.prepare_distributed_inputs(x, y, config, mesh, None, None,
                                       None)
    q = 2 * min(int(config.working_set) // 2, n)
    cap = int(config.inner_iters) or max(32, q // 4)
    eps, limit = float(config.epsilon), int(config.max_iter)
    carry = jdd.DistDecompCarry(
        alpha=jax.device_put(np.asarray(di.init[0], np.float32), di.shard),
        f=jax.device_put(np.asarray(di.init[1], np.float32), di.shard),
        b_hi=jax.device_put(np.float32(di.init[2]), di.repl),
        b_lo=jax.device_put(np.float32(di.init[3]), di.repl),
        n_iter=jax.device_put(np.int32(0), di.repl),
        rounds=jax.device_put(np.int32(0), di.repl))

    def run(c, xs, ys, x2s, valid):
        n_true = lax.psum(jnp.sum(valid.astype(jnp.int32)), SHARD_AXIS)
        lim = jnp.int32(limit)

        def cond(s):
            return (s.b_lo > s.b_hi + 2.0 * eps) & (s.n_iter < lim)

        def body(s):
            return jdd._dist_decomp_step(
                s, xs, ys, x2s, valid, c=float(config.c),
                kspec=config.kernel_spec(d), n_per_shard=di.n_s,
                n_true=n_true, q=q, inner_cap=cap, epsilon=eps, limit=lim,
                shard_x=config.shard_x, precision=lax.Precision.HIGHEST,
                weights=(float(config.weight_pos),
                         float(config.weight_neg)),
                pairwise_clip=config.clip == "pairwise")

        c = c._replace(**{k: pcast_varying(getattr(c, k))
                          for k in ("b_hi", "b_lo", "n_iter", "rounds")})
        out = lax.while_loop(cond, body, c)
        return out._replace(**{k: lax.pmax(getattr(out, k), SHARD_AXIS)
                               for k in ("b_hi", "b_lo", "n_iter",
                                         "rounds")})

    shard, repl = PS(SHARD_AXIS), PS()
    x_spec = shard if config.shard_x else repl
    specs = jdd.DistDecompCarry(alpha=shard, f=shard, b_hi=repl, b_lo=repl,
                                n_iter=repl, rounds=repl)
    mapped = shard_map_compat(run, mesh=mesh,
                              in_specs=(specs, x_spec, shard, x_spec, shard),
                              out_specs=specs)
    out = jax.jit(mapped)(carry, di.xd, di.yd, di.x2, di.validd)
    return (int(out.n_iter), int(out.rounds), np.asarray(out.alpha)[:n],
            (float(out.b_lo) + float(out.b_hi)) / 2.0)


def _check(r, x, y, p, cfg):
    """tests/test_dist_decomp.py::_check's bar, the JAX run at the same
    P standing for its single-device run."""
    assert "exception" not in r, r.get("exception")
    assert r["ranks_agree"] and r["converged"]
    eps, gamma = cfg["epsilon"], cfg["gamma"]
    box = np.asarray(JConfig(**{k: v for k, v in cfg.items()
                                if k not in ("chunk_iters", "shard_x")}
                             ).box_bound(y), np.float64)
    _, _, alpha_j, _ = jax_dist_decomp(x, y, p, cfg)
    gap, b = true_gap_and_b(x, y, r["alpha"], C=box, gamma=gamma)
    assert gap <= 2.0 * eps + 5e-4, gap
    assert abs(b - r["b"]) <= 1e-3
    alpha = r["alpha"]
    assert np.all(alpha >= 0) and np.all(
        alpha <= np.broadcast_to(box, alpha.shape) + 1e-6)
    nsv_j, nsv = int((alpha_j > 0).sum()), int((alpha > 0).sum())
    assert abs(nsv - nsv_j) <= max(3, 0.05 * nsv_j), (nsv, nsv_j)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_meet_the_jax_bar(ranks, name):
    p, (x, y), cfg = CASES[name]
    r = ranks(p)[name]
    _check(r, x, y, p, cfg)
    assert r["rounds"] > 0


def test_padding_rows_never_selected(ranks):
    """n = 333 over 8 ranks: the 3 padding rows never enter W."""
    r = ranks(8)["odd-8"]
    assert 0 <= r["w_max"] < len(ODD[1])
    assert len(r["alpha"]) == 333


def test_q_half_above_shard_rows(ranks):
    """q/2 = 32 above n_s = 12: each rank offers its whole slice."""
    r = ranks(8)["tiny-8"]
    assert r["converged"] and r["rounds"] > 0


@pytest.mark.parametrize("tag", sorted(P1_BRANCHES))
def test_world_of_one_is_the_single_device_rounds(ranks, tag):
    from dpsvm_tpu_torch.solver.decomp import train_single_device_decomp
    r = ranks(1)[f"p1-{tag}"]
    assert "exception" not in r, r.get("exception")
    cfg = {k: v for k, v in dict(BASE, working_set=64,
                                 **P1_BRANCHES[tag]).items()
           if k != "shard_x"}
    single = train_single_device_decomp(*SMALL, SVMConfig(**cfg),
                                        torch.device("cpu"))
    assert (r["n_iter"], r["rounds"]) == (single.n_iter, single.rounds)
    np.testing.assert_array_equal(r["alpha"], single.alpha)
    assert (r["b_lo"], r["b_hi"]) == (single.b_lo, single.b_hi)
