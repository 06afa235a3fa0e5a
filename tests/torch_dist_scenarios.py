"""Scenarios the CPU tests of the port's distributed trainers run inside
their gloo ranks (``parallel.multihost.launch_local``).

This module imports neither JAX nor the JAX package: a spawned rank
imports it to unpickle ``run``. A test starts the ranks of one world size
once, with every scenario of its file, and the parametrised cases only
read the results. Each scenario is a dict: ``name``, ``what`` (which entry
point), the data and the config's fields; ``run`` returns, by name, rank
0's full result and every rank's fingerprint (so a case can check that
the ranks agree).
"""

from __future__ import annotations

import contextlib
import io
import sys

import numpy as np

# Seconds the tests give a launch of ranks (each collective and the
# rendezvous have their own bound, multihost.INIT_TIMEOUT_S).
RUN_TIMEOUT_S = 240.0


@contextlib.contextmanager
def _recorded_pairs(seq):
    """Record the (i_hi, i_lo) of every iteration of the distributed pair
    (the eager loop: one host read an iteration)."""
    from dpsvm_tpu_torch.parallel import dist_smo
    orig = dist_smo._update

    def rec(carry, prob, opts, fetch=None):
        u = orig(carry, prob, opts, fetch)
        seq.append((int(u.i_hi), int(u.i_lo)))
        return u

    dist_smo._update = rec
    try:
        yield
    finally:
        dist_smo._update = orig


@contextlib.contextmanager
def _recorded_w(rows):
    """Record each round's active working-set indices of the distributed
    decomposition."""
    from dpsvm_tpu_torch.parallel import dist_decomp
    orig = dist_decomp._gather_w

    def rec(prob, wi, active, alpha, f):
        rows.append(np.asarray(wi[active].cpu()))
        return orig(prob, wi, active, alpha, f)

    dist_decomp._gather_w = rec
    try:
        yield
    finally:
        dist_decomp._gather_w = orig


def _result(res) -> dict:
    return dict(n_iter=int(res.n_iter), b=float(res.b),
                b_lo=float(res.b_lo), b_hi=float(res.b_hi),
                converged=bool(res.converged), n_sv=int(res.n_sv),
                alpha=np.asarray(res.alpha, np.float32),
                rounds=int(res.rounds), cache_hits=int(res.cache_hits),
                cache_misses=int(res.cache_misses))


def _one(sc: dict) -> dict:
    import torch.distributed as dist

    from dpsvm_tpu_torch import SVMConfig, train
    from dpsvm_tpu_torch.parallel.mesh import make_data_mesh

    what = sc.get("what", "train")
    x, y = sc.get("x"), sc.get("y")
    cfg = dict(sc.get("cfg", {}))
    cfg.setdefault("shards", dist.get_world_size())
    config = SVMConfig(**cfg)
    out: dict = {}
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        if what == "train":
            seq, w_rows = [], []
            with _recorded_pairs(seq), _recorded_w(w_rows):
                res = train(x, y, config, device=sc.get("device", "cpu"),
                            group=dist.group.WORLD if sc.get("group")
                            else None, **sc.get("kw", {}))
            out = _result(res)
            out["seq"] = seq
            out["w_max"] = max((int(r.max()) for r in w_rows if len(r)),
                               default=-1)
        elif what == "svr":
            from dpsvm_tpu_torch.models.svr import train_svr
            model, res = train_svr(x, y, config, device="cpu")
            out = _result(res)
        elif what == "oneclass":
            from dpsvm_tpu_torch.models.oneclass import (score_oneclass,
                                                         train_oneclass)
            model, res = train_oneclass(x, sc["nu"], config, device="cpu")
            out = _result(res)
            out["score"] = np.asarray(score_oneclass(model, x,
                                                     device="cpu"))
        elif what == "shrink":
            from dpsvm_tpu_torch.solver import shrink
            shrink.SHRINK_CHECK_ITERS = sc.get("check", 128)
            orig = shrink._bucket_cap
            if sc.get("exact"):
                shrink._bucket_cap = lambda n_act, n, floor=512: n_act
            try:
                res = train(x, y, config, device="cpu")
            finally:
                shrink._bucket_cap = orig
            out = _result(res)
            out["run"] = {k: v for k, v in shrink.RUN.items()
                          if k != "rebuilt"}
        elif what == "mesh":
            try:
                make_data_mesh(sc["shards"], device="cpu")
                out = {"error": None}
            except ValueError as e:
                out = {"error": str(e)}
        else:
            raise ValueError(f"unknown scenario {what!r}")
    out["stderr"] = err.getvalue()
    return out


def run(rank: int, scenarios) -> dict:
    """Every scenario in order on this rank: rank 0 returns the full
    results, every rank its fingerprints (n_iter and the alpha bytes)."""
    full, prints = {}, {}
    for sc in scenarios:
        try:
            out = _one(sc)
        except Exception as e:          # the case reads it, not the rank
            out = {"exception": f"{type(e).__name__}: {e}"}
        prints[sc["name"]] = (out.get("n_iter"),
                              None if "alpha" not in out
                              else out["alpha"].tobytes())
        full[sc["name"]] = out
        sys.stderr.flush()
    return {"full": full if rank == 0 else None, "prints": prints}


def launch(world: int, scenarios) -> dict:
    """Start ``world`` gloo ranks once and run ``scenarios`` in each;
    returns {name: rank 0's result, with "ranks_agree"}."""
    from dpsvm_tpu_torch.parallel.multihost import launch_local
    outs = launch_local(world, run, (scenarios,), device="cpu",
                        run_timeout_s=RUN_TIMEOUT_S)
    res = outs[0]["full"]
    for name, r in res.items():
        r["ranks_agree"] = all(o["prints"][name] == outs[0]["prints"][name]
                               for o in outs)
    return res
