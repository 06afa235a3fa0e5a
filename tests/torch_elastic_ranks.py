"""What the elastic tests' gloo ranks run (``parallel.multihost.
launch_local``). Imports neither JAX nor the JAX package: a spawned rank
imports this module to unpickle ``run``.

A scenario is a dict: ``name``, the config's fields (``cfg``), an optional
``FaultPlan``'s fields (``plan``) and environment (``env``). ``run``
trains each in turn with the distributed pair over the world and returns,
by name, rank 0's result (or the error every rank raised, with its class
name and ``n_iter``) and the reads the scenario made (``driver.READS``, by
kind); every rank's
(n_iter, alpha bytes) fingerprint rides along so a case can check that
the ranks agree.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np

RUN_TIMEOUT_S = 240.0


def _one(x, y, sc: dict) -> dict:
    from dpsvm_tpu_torch import SVMConfig
    from dpsvm_tpu_torch.parallel.dist_smo import train_distributed
    from dpsvm_tpu_torch.resilience import faultinject
    from dpsvm_tpu_torch.solver import driver
    plan = sc.get("plan")
    faultinject.install(None if plan is None
                        else faultinject.FaultPlan(**plan))
    env = sc.get("env", {})
    os.environ.update(env)
    r0 = dict(driver.READS)
    try:
        import torch.distributed as dist
        cfg = dict(sc["cfg"], shards=dist.get_world_size())
        res = train_distributed(x, y, SVMConfig(**cfg))
        out = {"n_iter": int(res.n_iter), "b": float(res.b),
               "alpha": np.asarray(res.alpha, np.float32)}
    except Exception as e:
        out = {"error": type(e).__name__, "message": str(e),
               "n_iter": getattr(e, "n_iter", None)}
    finally:
        faultinject.clear()
        for k in env:
            os.environ.pop(k, None)
    out["reads"] = {k: v - r0[k] for k, v in driver.READS.items()}
    return out


def run(rank: int, x, y, scenarios) -> dict:
    full, prints = {}, {}
    for sc in scenarios:
        with contextlib.redirect_stderr(io.StringIO()):
            out = _one(x, y, sc)
        prints[sc["name"]] = (out.get("n_iter"),
                              None if "alpha" not in out
                              else out["alpha"].tobytes())
        full[sc["name"]] = out
    return {"full": full if rank == 0 else None, "prints": prints}


def launch(world: int, x, y, scenarios) -> dict:
    """``world`` gloo ranks started once for every scenario; returns
    {name: rank 0's result, with "ranks_agree"}."""
    from dpsvm_tpu_torch.parallel.multihost import launch_local
    outs = launch_local(world, run, (x, y, scenarios), device="cpu",
                        run_timeout_s=RUN_TIMEOUT_S)
    res = outs[0]["full"]
    for name, r in res.items():
        r["ranks_agree"] = all(o["prints"][name] == outs[0]["prints"][name]
                               for o in outs)
    return res


def card_rank(rank: int, x, y, cfg: dict) -> dict:
    """A CUDA rank of a gloo world (``launch_local(backend="gloo")``)
    training the pair on the default group with no device given: its
    result and the device its mesh chose."""
    import torch.distributed as dist

    from dpsvm_tpu_torch import SVMConfig
    from dpsvm_tpu_torch.parallel.dist_smo import train_distributed
    from dpsvm_tpu_torch.parallel.mesh import make_data_mesh
    p = dist.get_world_size()
    res = train_distributed(x, y, SVMConfig(**cfg, shards=p))
    return {"n_iter": int(res.n_iter), "alpha": res.alpha,
            "converged": bool(res.converged),
            "device": str(make_data_mesh(p).device)}
