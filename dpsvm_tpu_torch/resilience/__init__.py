"""Fault-tolerant training: the resilience layer of the port (port of
``dpsvm_tpu/resilience``), wired through the shared host driver
(``solver/driver.host_training_loop``) so every solver path gets it:

* ``preempt``     — SIGTERM/SIGINT -> snapshot checkpoint and the
                    resumable exit 75 at the next poll;
* ``health``      — divergence guards with a raise/rollback/ignore policy
                    (and the serving pool's replica monitor);
* ``supervisor``  — ``train --retries N`` / ``run_with_retries``: relaunch
                    from the newest intact checkpoint with backoff;
* ``faultinject`` — deterministic faults (environment or API) that make
                    all of it testable on the CPU;
* ``elastic``     — the distributed fault model: desync detection and
                    heartbeats on the poll's probe tail, ``ShardLostError``
                    and ``run_elastic`` (a new world of the surviving ranks
                    from the newest intact checkpoint);
* ``hostgroup``   — heartbeat files, the host-group supervisor that
                    reforms after a host dies, the live admission barrier;
* ``doctor``      — the preflight: backend, a timed collective, checkpoint,
                    disk, data and host-group health.

``python -m dpsvm_tpu_torch.resilience --selfcheck`` runs ``selfcheck``.
"""

from __future__ import annotations

import os
from typing import List, Optional

from dpsvm_tpu_torch.resilience.health import (DesyncError, DivergenceError,
                                               HealthMonitor, MAX_ROLLBACKS,
                                               POLICIES)
from dpsvm_tpu_torch.resilience.preempt import (PREEMPT_EXIT_CODE,
                                                PreemptedError)

__all__ = [
    "DesyncError", "DivergenceError", "HealthMonitor", "MAX_ROLLBACKS",
    "POLICIES", "PREEMPT_EXIT_CODE", "PreemptedError", "selfcheck",
]

# A drill world's bound: a rank that hangs (a collective that never
# completes, a card that stops answering) fails the drill in place of
# holding its caller.
DRILL_WORLD_TIMEOUT_S = 300.0


def _base(**kw):
    from dpsvm_tpu_torch.config import SVMConfig
    # epsilon far below float resolution: every run spends its whole
    # max_iter budget, so the end states of the attempts compare exactly
    kw.setdefault("c", 1.0)
    kw.setdefault("gamma", 0.5)
    kw.setdefault("epsilon", 1e-12)
    kw.setdefault("max_iter", 300)
    kw.setdefault("chunk_iters", 25)
    return SVMConfig(**kw)


def elastic_rank(rank: int, x, y, config, plan: Optional[dict],
                 device: str, ref_path: Optional[str] = None) -> dict:
    """One rank of a distributed drill run (started by
    ``multihost.launch_local`` as gloo ranks): with ``ref_path``, first the
    uninterrupted run of the same world (no checkpoints, no trace, no
    fault), whose result rank 0 pickles there; then ``plan`` (a
    ``FaultPlan``'s fields: each attempt's ranks are new processes)
    installed and the distributed pair trained on ``device`` (a card
    shared by gloo ranks needs the explicit world group)."""
    import dataclasses
    import pickle

    import torch.distributed as dist

    from dpsvm_tpu_torch.parallel.dist_smo import train_distributed
    from dpsvm_tpu_torch.resilience import faultinject
    group = dist.group.WORLD if device.startswith("cuda") else None

    def run(cfg) -> dict:
        r = train_distributed(x, y, cfg, group=group, device=device)
        return {"alpha": r.alpha, "n_iter": r.n_iter, "b": r.b}

    if ref_path is not None:
        faultinject.install(None)
        ref = run(dataclasses.replace(config, checkpoint_path=None,
                                      checkpoint_every=0, resume_from=None,
                                      trace_out=None))
        if rank == 0:
            with open(ref_path, "wb") as fh:
                pickle.dump(ref, fh)
    faultinject.install(faultinject.FaultPlan(**plan) if plan else None)
    return run(config)


def kill_shard_drill(td: str, x, y, shards: int = 2, device: str = "cuda",
                     **kw) -> dict:
    """The kill-one-shard drill: ``shards`` gloo ranks with their shards on
    ``device`` (on the card they share it), shard #2 lost at the 3rd
    distributed poll (``DPSVM_FAULT_DIST_KILL_SHARD``), resumed by
    ``elastic.run_elastic`` on the survivors from the newest intact
    checkpoint; attempt 0's world first runs the uninterrupted reference.
    Returns both results and the resumed attempt's trace records."""
    import dataclasses
    import pickle

    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.observability.report import read_trace
    from dpsvm_tpu_torch.parallel import multihost
    from dpsvm_tpu_torch.resilience import elastic

    device = str(resolve_device(device))
    os.makedirs(td, exist_ok=True)
    cfg = _base(**kw)
    ck = os.path.join(td, "dist.npz")
    ref_path = os.path.join(td, "ref.pkl")

    def attempt(resume_from, p, k):
        c = dataclasses.replace(
            cfg, shards=p, checkpoint_path=ck, checkpoint_every=50,
            checkpoint_keep=2, resume_from=resume_from,
            trace_out=os.path.join(td, f"trace_d{k}.jsonl"))
        plan = dict(dist_kill_shard=2, dist_kill_poll=3) if k == 0 else None
        return multihost.launch_local(
            p, elastic_rank,
            (x, y, c, plan, device, ref_path if k == 0 else None),
            device="cpu", run_timeout_s=DRILL_WORLD_TIMEOUT_S)[0]

    got = elastic.run_elastic(attempt, shards=shards, retries=1,
                              backoff_s=0.0, checkpoint_path=ck)
    with open(ref_path, "rb") as fh:
        ref = pickle.load(fh)
    return {"ref": ref, "got": got,
            "trace": read_trace(os.path.join(td, "trace_d1.jsonl"))}


def selfcheck(tmp_dir: Optional[str] = None, host_drill: bool = False,
              device: str = "cuda", shard_drill: bool = True
              ) -> List[str]:
    """Fault injection and recovery end to end on a small problem;
    returns the problems found (empty = OK):

    1. a run preempted by the injected ``PREEMPT_POLL`` fault and resumed
       by ``run_with_retries`` ends bitwise on the uninterrupted run, with
       ``preempt`` on attempt 0's trace and ``retry`` on attempt 1's;
    2. with the newest slot bit-flipped, the resume falls back to the
       rotation slot, lands on the same state and traces a ``rollback``;
    3. (``shard_drill``) the kill-one-shard drill over two gloo ranks
       (``kill_shard_drill``): n_iter equal to the uninterrupted world's,
       alpha within 1e-4 (the survivors' mesh can order the reductions
       otherwise), ``retry`` and ``reshard`` on a schema-valid trace;
    4. (``host_drill``) the kill-one-host drill
       (``hostgroup.host_loss_drill``).

    Every run is on ``device``: the single-device runs (the general pair)
    and the drills' gloo ranks, which share the card."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from dpsvm_tpu_torch.data.synthetic import make_blobs
    from dpsvm_tpu_torch.observability.report import read_trace
    from dpsvm_tpu_torch.observability.schema import validate_trace
    from dpsvm_tpu_torch.resilience import faultinject
    from dpsvm_tpu_torch.resilience.supervisor import run_with_retries
    from dpsvm_tpu_torch.solver.smo import train_single_device
    from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint

    problems: List[str] = []
    dev = torch.device(device)
    x, y = make_blobs(n=64, d=4, seed=11)

    def events(path):
        return [r["event"] for r in read_trace(path)
                if r.get("kind") == "event"]

    with tempfile.TemporaryDirectory(dir=tmp_dir) as td:
        ref = train_single_device(x, y, _base(), dev)
        if ref.n_iter != 300:
            problems.append(f"reference run stopped at {ref.n_iter}, "
                            "expected the full 300-iteration budget")

        # --- injected preemption + supervised resume -----------------
        ck = os.path.join(td, "state.npz")
        cfg = _base(checkpoint_path=ck, checkpoint_every=50,
                    checkpoint_keep=2)
        faultinject.install(faultinject.FaultPlan(preempt_at_poll=3))
        try:
            def attempt(resume_from, k):
                c = dataclasses.replace(
                    cfg, resume_from=resume_from,
                    trace_out=os.path.join(td, f"trace_a{k}.jsonl"))
                return train_single_device(x, y, c, dev)

            result = run_with_retries(attempt, retries=1, backoff_s=0.0,
                                      checkpoint_path=ck)
        finally:
            faultinject.clear()
        if result.n_iter != ref.n_iter:
            problems.append(f"supervised resume ended at {result.n_iter} "
                            f"!= {ref.n_iter}")
        if not np.array_equal(result.alpha, ref.alpha):
            problems.append("supervised resume alpha is not bitwise the "
                            "uninterrupted run's")
        ev0 = events(os.path.join(td, "trace_a0.jsonl"))
        if "preempt" not in ev0:
            problems.append(f"attempt 0 trace has no preempt event "
                            f"(events: {ev0})")
        ev1 = events(os.path.join(td, "trace_a1.jsonl"))
        if "retry" not in ev1:
            problems.append(f"attempt 1 trace has no retry event "
                            f"(events: {ev1})")

        # --- corrupted newest slot -> rotation fallback --------------
        # a bit flip inside the alpha payload, found by content
        snap = load_checkpoint(ck)
        raw = bytearray(open(ck, "rb").read())
        payload = np.ascontiguousarray(snap.alpha, np.float32).tobytes()
        pos = raw.find(payload)
        raw[pos + len(payload) // 2] ^= 0xFF
        with open(ck, "wb") as fh:
            fh.write(bytes(raw))
        trace = os.path.join(td, "trace_fallback.jsonl")
        r2 = train_single_device(x, y, _base(resume_from=ck,
                                             trace_out=trace), dev)
        if not np.array_equal(r2.alpha, ref.alpha):
            problems.append("rotation-slot resume alpha is not bitwise "
                            "the uninterrupted run's")
        if "rollback" not in events(trace):
            problems.append("fallback resume recorded no rollback event")

        # --- kill-one-shard drill: degraded-mesh resume ---------------
        if shard_drill:
            try:
                out = kill_shard_drill(os.path.join(td, "shards"), x, y,
                                       device=device)
            except Exception as e:
                problems.append(f"kill-shard drill failed: "
                                f"{type(e).__name__}: {e}")
            else:
                refd, got = out["ref"], out["got"]
                if got["n_iter"] != refd["n_iter"]:
                    problems.append(
                        f"kill-shard drill: resumed run ended at "
                        f"{got['n_iter']} != {refd['n_iter']}")
                if not np.allclose(got["alpha"], refd["alpha"], rtol=0.0,
                                   atol=1e-4):
                    problems.append(
                        "kill-shard drill: resumed model disagrees with "
                        "the uninterrupted 2-rank run past 1e-4")
                ev = [r["event"] for r in out["trace"]
                      if r.get("kind") == "event"]
                for want in ("retry", "reshard"):
                    if want not in ev:
                        problems.append(
                            f"kill-shard drill: resumed trace has no "
                            f"{want} event (events: {ev})")
                errs = validate_trace(out["trace"])
                if errs:
                    problems.append("kill-shard drill: resumed trace "
                                    f"fails validation: {errs}")

        # --- kill-one-host drill: cross-process reformation ----------
        if host_drill:
            from dpsvm_tpu_torch.resilience import hostgroup
            try:
                facts = hostgroup.host_loss_drill(
                    os.path.join(td, "hostdrill"), device=device)
            except Exception as e:
                problems.append(f"host-loss drill failed: "
                                f"{type(e).__name__}: {e}")
            else:
                if facts.get("host_loss_recovery_s", 0) <= 0:
                    problems.append(
                        "host-loss drill measured no recovery latency "
                        f"(facts: {facts})")
    return problems
