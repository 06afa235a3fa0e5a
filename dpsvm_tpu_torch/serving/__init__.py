"""Online serving (port of ``dpsvm_tpu/serving``): the models the port
trains, served at request sizes that vary.

* ``engine``   — ``PredictionEngine``: any saved model (binary SVC, SVR,
                 one-class, precomputed, approx, one-vs-one directory)
                 packed on the device once and served through a ladder of
                 batch shapes, one captured CUDA graph a bucket on the
                 card; bitwise ``decision_function`` for a block at the
                 same shape.
* ``batcher``  — ``MicroBatcher``: size-or-deadline request coalescing
                 with bounded-queue admission (a fast reject under
                 overload).
* ``budget``   — per-request deadline budgets, the p99 hedge delay, the
                 overload degradation controller.
* ``registry`` — ``ModelRegistry``: named models, atomic hot reload (the
                 old engine serves until the new one is warm),
                 ``promote_file``.
* ``sharded``  — ``ShardedDecider``: a model too big for one device's
                 budget, its reduction axis spread over a list of
                 devices; bitwise its own one-device ``reference``.
* ``pool``     — ``ReplicaPool``: N failure-isolated engine replicas
                 with per-replica circuit breakers (wedge/NaN eject ->
                 background rebuild -> half-open probe -> close), the
                 reaper's deadline 504s and hedged re-dispatch.
* ``server``   — stdlib ``ThreadingHTTPServer``: ``POST /v1/predict``,
                 ``GET /healthz`` / ``/metricsz`` / ``/v1/models``,
                 ``POST /v1/reload``; SIGTERM graceful drain.
* ``frontdoor``— ``AsyncFrontDoor``: one asyncio loop over the same
                 request core, weighted-fair tenant lanes
                 (``fairqueue``), the same drain contract.
* ``loadgen``  — open/closed-loop generator printing one JSON row;
                 ``run_saturate`` steps the open-loop rate to the p99
                 knee.
* ``lifecycle``— KS drift detection on the live score window ->
                 supervised retrain -> accuracy gate -> atomic
                 hot-swap; ``live_drift_drill`` end to end.

Gate: ``python -m dpsvm_tpu_torch.serving --selfcheck [--device cpu]``
builds a model and asserts: one capture a bucket at warmup and none
across mixed-size traffic after it; the engine's decisions, labels and
probabilities bitwise ``decision_function`` on the same blocks (and
across request sizes within 1e-5, bitwise where the backend's products
are); the batcher deterministic (a staged queue coalesces in order,
each answer bitwise the engine's on the coalesced rows) and rejecting
past its queue bound; a registry reload serving the new artifact at
generation 2, and a reload failed by ``DPSVM_FAULT_SERVE_FAIL_RELOAD``
leaving the old one live; a 3-replica pool with a wedged replica giving
exactly one deadline 504, then eject -> rebuild -> closed with no stray
capture; the async front door answering bitwise the threaded server;
the DRR schedule serving exactly 64 gold rows among the first 72 at 8:1
weights; and, with two or more cards, a model over its budget served
sharded, bitwise its reference, capturing nothing. ``--live-drill``,
``--tenant-drill`` and ``--front-door-drill`` run the end-to-end drills.

Importing this package touches no device: the engine loads lazily.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from dpsvm_tpu_torch.serving.batcher import (KNOWN_OUTPUTS,
                                             BatcherClosedError,
                                             MicroBatcher, QueueFullError)
from dpsvm_tpu_torch.serving.budget import (Budget, DeadlineExceededError,
                                            DegradeController)
from dpsvm_tpu_torch.serving.registry import ModelRegistry

__all__ = [
    "KNOWN_OUTPUTS", "BatcherClosedError", "MicroBatcher",
    "QueueFullError", "ModelRegistry", "Budget", "DeadlineExceededError",
    "DegradeController", "PredictionEngine", "SegmentPack",
    "bucket_ladder", "compact_model", "ShardedDecider", "ReplicaPool",
    "PoolUnavailableError", "ServingServer", "AsyncFrontDoor",
    "FairQueue", "selfcheck", "tenant_isolation_drill",
    "front_door_drill", "main",
]

_LAZY = {
    "PredictionEngine": ("dpsvm_tpu_torch.serving.engine",
                         "PredictionEngine"),
    "SegmentPack": ("dpsvm_tpu_torch.serving.engine", "SegmentPack"),
    "bucket_ladder": ("dpsvm_tpu_torch.serving.engine", "bucket_ladder"),
    "compact_model": ("dpsvm_tpu_torch.serving.engine", "compact_model"),
    "ShardedDecider": ("dpsvm_tpu_torch.serving.sharded",
                       "ShardedDecider"),
    "ReplicaPool": ("dpsvm_tpu_torch.serving.pool", "ReplicaPool"),
    "PoolUnavailableError": ("dpsvm_tpu_torch.serving.pool",
                             "PoolUnavailableError"),
    "ServingServer": ("dpsvm_tpu_torch.serving.server", "ServingServer"),
    "AsyncFrontDoor": ("dpsvm_tpu_torch.serving.frontdoor",
                       "AsyncFrontDoor"),
    "FairQueue": ("dpsvm_tpu_torch.serving.fairqueue", "FairQueue"),
}


def __getattr__(name: str):
    """PEP 562 lazy re-exports: the engine (and with it the device) loads
    only when something asks for it."""
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    import importlib
    return getattr(importlib.import_module(mod), attr)


def mixed_sizes(max_batch: int) -> List[int]:
    """>= 20 request sizes covering every rung, the rung boundaries and
    the multi-pass path (> max_batch)."""
    sizes = [1, 2, 3, 4, 5, 7, 8, 9, 12, 15, 16, 17, 20, 24, 28, 31,
             32, 30, 6, 10, 2, 1]
    sizes = [min(s, max_batch) for s in sizes]
    sizes.append(max_batch + 3)
    return sizes


def _bits_equal(a, b) -> bool:
    import numpy as np
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def selfcheck(tmp_dir: Optional[str] = None, device=None) -> List[str]:
    """Run the serving modules end to end on a synthetic model; return the
    problems found (empty = healthy). ``device`` None means the GPU."""
    import dataclasses
    import os
    import tempfile

    import numpy as np

    problems: List[str] = []
    ctx = tempfile.TemporaryDirectory() if tmp_dir is None else None
    base = tmp_dir if tmp_dir is not None else ctx.name
    try:
        from dpsvm_tpu_torch.device import resolve_device
        from dpsvm_tpu_torch.models.calibration import (save_platt,
                                                        sigmoid_proba)
        from dpsvm_tpu_torch.models.io import load_model, save_model
        from dpsvm_tpu_torch.models.svm import SVMModel, decision_function
        from dpsvm_tpu_torch.resilience import faultinject
        from dpsvm_tpu_torch.serving import engine as eng

        dev = resolve_device(device)
        rng = np.random.default_rng(7)
        n_sv, d, max_batch = 48, 6, 32
        model = SVMModel(
            x_sv=rng.standard_normal((n_sv, d)).astype(np.float32),
            alpha=rng.uniform(0.05, 2.0, n_sv).astype(np.float32),
            y_sv=np.where(rng.random(n_sv) < 0.5, -1, 1).astype(np.int32),
            b=0.25, gamma=0.5)
        path = os.path.join(base, "selfcheck.svm")
        save_model(model, path)
        save_platt(path, -1.2, 0.1)

        # 1) one capture a bucket at warmup, none after mixed traffic
        engine = eng.PredictionEngine.load(path, max_batch=max_batch,
                                           device=dev)
        want_caps = len(engine.buckets) if dev.type == "cuda" else 0
        if engine.warmup_captures != want_caps:
            problems.append(f"warmup captured {engine.warmup_captures} "
                            f"graphs for a {len(engine.buckets)}-rung "
                            f"ladder on {dev.type} (wanted {want_caps})")
        caps0 = eng.COUNTS["captures"]
        sizes = mixed_sizes(max_batch)
        queries = [rng.standard_normal((s, d)).astype(np.float32)
                   for s in sizes]
        outs = [engine.infer(q, want=("labels", "decision", "proba"))
                for q in queries]
        if eng.COUNTS["captures"] != caps0:
            problems.append(
                f"{eng.COUNTS['captures'] - caps0} capture(s) across "
                f"{len(sizes)} post-warmup requests — the ladder is "
                "recapturing")

        # 2) parity with the direct path: bitwise on the same block at
        # the same shape; across request sizes within 1e-5
        loaded = load_model(path)
        for q, out in zip(queries, outs):
            for lo, take, bucket in engine._ladder.plan(q.shape[0]):
                block = np.zeros((bucket, d), np.float32)
                block[:take] = q[lo:lo + take]
                same = decision_function(loaded, block, device=dev)[:take]
                if not _bits_equal(out["decision"][lo:lo + take], same):
                    problems.append(
                        "engine decision differs from decision_function "
                        f"on the same {bucket}-row block")
                    break
            direct = decision_function(loaded, q, device=dev)
            err = float(np.max(np.abs(out["decision"] - direct)))
            if err > 1e-5:
                problems.append(f"engine decision at {q.shape[0]} rows "
                                f"is {err:.3g} from decision_function")
                break
            if not np.array_equal(out["labels"], np.where(
                    out["decision"] < 0, -1, 1).astype(np.int32)):
                problems.append(f"engine labels differ at batch size "
                                f"{q.shape[0]}")
                break
            if not _bits_equal(out["proba"], sigmoid_proba(
                    out["decision"], -1.2, 0.1)):
                problems.append(f"engine proba differs at batch size "
                                f"{q.shape[0]}")
                break

        # 3) the batcher is deterministic: a staged queue coalesces in
        # order (size-or-deadline), and each answer is bitwise the
        # engine's on the coalesced rows (within 1e-5 of a direct call on
        # the request's own rows, whose bucket may differ); it rejects
        # past its bound
        from dpsvm_tpu_torch.serving.batcher import (MicroBatcher,
                                                     QueueFullError)
        staged = queries[:8]
        bat = MicroBatcher(engine.infer, max_batch=max_batch,
                           max_delay_ms=20.0, start=False)
        tickets = [bat.submit(q, want=("decision",)) for q in staged]
        bat.start()
        got = [t.wait(timeout=30.0)["decision"] for t in tickets]
        st = bat.stats()
        bat.close()
        batch, expect = [], []
        for q in staged + [None]:
            if q is None or sum(len(r) for r in batch) + len(q) > max_batch:
                dec = engine.decision_values(np.concatenate(batch))
                lo = 0
                for r in batch:
                    expect.append(dec[lo:lo + len(r)])
                    lo += len(r)
                batch = []
            if q is not None:
                batch.append(q)
        if not all(_bits_equal(g, e) for g, e in zip(got, expect)):
            problems.append("batched answers differ from the engine on "
                            "the coalesced rows")
        if max(float(np.max(np.abs(g - engine.decision_values(q))))
               for g, q in zip(got, staged)) > 1e-5:
            problems.append("batched answers are more than 1e-5 from "
                            "direct engine calls")
        if not any(int(k) > sizes[0] for k in st["batch_rows_histogram"]):
            problems.append("staged queue did not coalesce "
                            f"(histogram: {st['batch_rows_histogram']})")
        full = MicroBatcher(engine.infer, max_batch=max_batch,
                            max_queue=8, start=False)
        full.submit(queries[6])                      # 8 rows: at the bound
        try:
            full.submit(queries[0])
            problems.append("a submit past max_queue was admitted")
        except QueueFullError:
            pass
        full.close(drain=False)

        # 4) registry hot reload swaps generations; a failed reload
        # leaves the old engine live
        from dpsvm_tpu_torch.serving.registry import ModelRegistry
        reg = ModelRegistry()
        reg.register("m", path, max_batch=8, device=dev)
        save_model(dataclasses.replace(model, b=model.b + 1.0), path)
        reg.reload("m")
        if reg.manifests()["m"]["generation"] != 2:
            problems.append(f"reload generation "
                            f"{reg.manifests()['m']['generation']} != 2")
        row = queries[0][:1]
        d_old = decision_function(model, row, device=dev)
        d_new = np.asarray(reg.engine("m").decision_values(row))
        if not np.allclose(d_new, d_old - 1.0, atol=1e-6):
            problems.append("hot reload did not serve the new artifact")
        prior = faultinject.current()
        faultinject.install(faultinject.FaultPlan(serve_fail_reload=1))
        try:
            reg.reload("m")
            problems.append("the injected reload failure did not raise")
        except OSError:
            pass
        finally:
            faultinject.install(prior)
        if (reg.manifests()["m"]["generation"] != 2 or not np.allclose(
                reg.engine("m").decision_values(row), d_new, atol=0)):
            problems.append("a failed reload did not leave the old "
                            "engine serving")

        # 5) replica pool: a wedged replica is a 504 for the dispatch
        # that hit it and an eject->rebuild->recovery for the pool, with
        # no capture outside the builds
        problems += _pool_check(path, queries, max_batch, dev)

        # 6) front door bitwise the threaded server; the exact DRR
        # ratio; sharded traffic with no capture
        problems += _front_door_check(path, rng, d, dev)
    except Exception as e:              # noqa: BLE001 - the gate reports
        import traceback
        traceback.print_exc()
        problems.append(f"selfcheck crashed: {type(e).__name__}: {e}")
    finally:
        if ctx is not None:
            ctx.cleanup()
    return problems


def _pool_check(path: str, queries, max_batch: int, dev) -> List[str]:
    """Selfcheck 5: ``ReplicaPool`` of 3 with replica #1 wedged."""
    import time as _time

    from dpsvm_tpu_torch.resilience import faultinject
    from dpsvm_tpu_torch.serving.engine import PredictionEngine

    problems: List[str] = []
    faultinject.reset_serve_wedge()
    prior = faultinject.current()
    faultinject.install(faultinject.FaultPlan(serve_wedge_replica=1))
    from dpsvm_tpu_torch.serving.pool import ReplicaPool
    pool = ReplicaPool(
        lambda i: PredictionEngine.load(path, max_batch=max_batch,
                                        device=dev),
        3, name="selfcheck", deadline_s=1.5, watch_compiles=True)
    try:
        n_504 = n_ok = 0
        for q in queries:
            try:
                pool.infer(q, ("labels", "decision"))
                n_ok += 1
            except DeadlineExceededError:
                n_504 += 1
        if n_504 != 1:
            problems.append(
                f"expected exactly 1 deadline 504 from the wedged "
                f"replica, got {n_504} (of {len(queries)})")
        if n_ok != len(queries) - 1:
            problems.append(f"only {n_ok}/{len(queries) - 1} dispatches "
                            "survived one wedged replica")
        give_up = _time.perf_counter() + 30.0
        while (pool.replica_states() != ["closed"] * 3
               and _time.perf_counter() < give_up):
            try:                           # traffic probes the rebuild
                pool.infer(queries[0], ("labels",))
            except DeadlineExceededError:
                pass
            _time.sleep(0.02)
        if pool.replica_states() != ["closed"] * 3:
            problems.append("ejected replica did not recover to closed: "
                            f"{pool.replica_states()}")
        seq = [e["event"] for e in pool.events]
        if seq[:2] != ["eject", "rebuild"]:
            problems.append(
                f"expected eject->rebuild event sequence, got {seq}")
        stray = pool.stray_compiles()
        if stray:
            problems.append(
                f"{stray} stray capture(s) across pool traffic incl. an "
                "ejection + rebuild: replicas are recapturing")
    finally:
        faultinject.release_serve_wedge()
        faultinject.install(prior)
        pool.close()
    return problems


def _post(url: str, payload: dict, timeout: float = 15.0) -> dict:
    import json as _json
    import urllib.request
    req = urllib.request.Request(
        url + "/v1/predict", data=_json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return _json.loads(r.read())


def _front_door_check(path: str, rng, d: int, dev) -> List[str]:
    """Selfcheck 6: the async front door against the threaded server,
    the DRR ratio, and sharded traffic with no capture."""
    import numpy as np

    from dpsvm_tpu_torch.serving import engine as eng
    from dpsvm_tpu_torch.serving.fairqueue import drr_schedule
    from dpsvm_tpu_torch.serving.frontdoor import AsyncFrontDoor
    from dpsvm_tpu_torch.serving.server import ServingServer

    problems: List[str] = []
    reg_thr, reg_fd = ModelRegistry(), ModelRegistry()
    reg_thr.register("default", path, max_batch=16, device=dev)
    reg_fd.register("default", path, max_batch=16, device=dev)
    thr = ServingServer(reg_thr, port=0, max_batch=16, max_delay_ms=0.5,
                        device=dev).start()
    fd = AsyncFrontDoor(
        ServingServer(reg_fd, port=0, max_batch=16, max_delay_ms=0.5,
                      device=dev),
        tenant_weights={"gold": 8.0}).start()
    try:
        q6 = rng.standard_normal((9, d)).astype(np.float32)
        want6 = {"instances": q6.tolist(),
                 "return": ["labels", "decision"]}
        out_thr = _post(thr.url, want6)
        out_fd = _post(fd.url, want6)
        if (out_thr["decision"] != out_fd["decision"]
                or out_thr["labels"] != out_fd["labels"]):
            problems.append("async front door answered differently from "
                            "the threaded transport over the same "
                            "artifact")
    finally:
        fd.drain(timeout=10.0)
        thr.drain(timeout=10.0)

    # DRR ratio on the pure staged queue: 8:1 weights, everything pushed
    # up front -> one full round serves EXACTLY 64 gold + 8 bronze rows
    pushes = [("gold", 1)] * 80 + [("bronze", 1)] * 80
    order = drr_schedule(pushes, {"gold": 8.0, "bronze": 1.0}, quantum=8)
    gold_first = sum(1 for t, _ in order[:72] if t == "gold")
    if gold_first != 64:
        problems.append(f"DRR served {gold_first}/72 gold rows for an 8:1 "
                        "weight ratio (expected exactly 64: one full "
                        "round)")

    # sharded decisions need two or more cards: force a budget far below
    # the packed model; the decider is bitwise its one-device reference
    # and traffic through it captures nothing
    import torch
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        eng_sh = eng.PredictionEngine.load(path, max_batch=16,
                                           hbm_budget_mb=1e-4, device=dev)
        if not eng_sh.sharded:
            problems.append("engine did not select the sharded decision "
                            "path under a forced 0.0001 MB budget")
        else:
            sd = eng_sh._sharded_deciders[0]
            q_sh = torch.from_numpy(
                rng.standard_normal((16, d)).astype(np.float32)).to(dev)
            got = sd(q_sh).cpu().numpy()
            ref = sd.reference(q_sh).cpu().numpy()
            if not _bits_equal(got, ref):
                problems.append(
                    "sharded decision differs bitwise from its one-"
                    "device reference (max abs err "
                    f"{np.max(np.abs(got - ref)):.3g})")
            caps = eng.COUNTS["captures"]
            for s in (1, 7, 16):
                eng_sh.infer(rng.standard_normal((s, d)).astype(
                    np.float32), want=("decision",))
            if eng.COUNTS["captures"] != caps:
                problems.append(
                    f"{eng.COUNTS['captures'] - caps} capture(s) across "
                    "sharded traffic")
    return problems


def _drill_model(seed: int, base: str, name: str) -> str:
    """A 32-SV, 5-feature synthetic model saved under ``base``."""
    import os

    import numpy as np

    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.models.svm import SVMModel
    rng = np.random.default_rng(seed)
    n_sv, d = 32, 5
    model = SVMModel(
        x_sv=rng.standard_normal((n_sv, d)).astype(np.float32),
        alpha=rng.uniform(0.05, 2.0, n_sv).astype(np.float32),
        y_sv=np.where(rng.random(n_sv) < 0.5, -1, 1).astype(np.int32),
        b=0.1, gamma=0.4)
    path = os.path.join(base, name)
    save_model(model, path)
    return path


def tenant_isolation_drill(tmp_dir: Optional[str] = None,
                           trace_path: Optional[str] = None,
                           device=None) -> dict:
    """The end-to-end noisy-neighbour drill: serve a multi-model
    registry, drive a skewed 8-tenant mix (t0 sends 80%), and prove the
    per-tenant observability chain identifies the hog: the
    ``tenant-fair-share`` rule fires naming t0, the incident bundle's
    incident.json carries the tenant, and the cold tenants' p99 stays
    measurable on its own lane. Returns ONE JSON-able row (``metric:
    tenant_isolation``, headline = the cold tenants' p99 ms); ``ok`` is
    the verdict. ``device`` None means the GPU."""
    import json
    import os
    import tempfile
    import time as _time

    import numpy as np

    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.serving.loadgen import run_loadgen
    from dpsvm_tpu_torch.serving.server import ServingServer

    dev = resolve_device(device)
    ctx = (tempfile.TemporaryDirectory() if tmp_dir is None else None)
    base = tmp_dir if tmp_dir is not None else ctx.name
    ext_trace = trace_path is not None
    row: dict = {"metric": "tenant_isolation", "unit": "ms",
                 "tenants": 8, "hot_tenant_skew": 0.8, "ok": False}
    try:
        path = _drill_model(11, base, "drill.svm")
        rng = np.random.default_rng(12)
        d = 5
        if trace_path is None:
            # the trace is part of the drill's evidence (span roots
            # carry the tenant): always write one somewhere
            trace_path = os.path.join(base, "tenant_drill.jsonl")
        registry = ModelRegistry()
        registry.register("default", path, max_batch=32, device=dev)
        registry.register("aux", path, max_batch=16, device=dev)

        # tight per-tenant rules so the drill converges in seconds:
        # same shapes as default_serving_rules(), drill-speed windows
        rules = [
            {"name": "tenant-fair-share", "kind": "fair_share",
             "severity": "warn", "per_tenant": True, "window_s": 1.0,
             "share_above": 0.5, "min_tenants": 2, "for_s": 0.0,
             "clear_after_s": 10.0},
            {"name": "tenant-availability-burn", "kind": "burn_rate",
             "severity": "warn", "per_tenant": True,
             "good": "tenant:{tenant}:requests",
             "bad": "tenant:{tenant}:deadline_504",
             "objective": 0.999, "fast_window_s": 5.0,
             "slow_window_s": 30.0, "threshold": 14.4,
             "clear_after_s": 10.0},
        ]
        bundle_dir = os.path.join(base, "bundles")
        srv = ServingServer(
            registry, "127.0.0.1", 0, max_batch=32, max_delay_ms=0.5,
            trace_out=trace_path, trace_sample_rate=1.0,
            watch_rules=rules, bundle_dir=bundle_dir,
            tenant_budget=16, device=dev).start()
        url = f"http://127.0.0.1:{srv.port}"
        rows = rng.standard_normal((64, d)).astype(np.float32)
        fired = False
        last = None
        errors = 0
        n_requests = 0
        try:
            give_up = _time.perf_counter() + 30.0
            while _time.perf_counter() < give_up:
                last = run_loadgen(
                    url, rows, model="default", requests=96, batch=1,
                    concurrency=8, mode="closed", want=("labels",),
                    timeout=10.0, spans=True, tenants=8,
                    hot_tenant_skew=0.8)
                errors += int(last.get("errors", 0))
                n_requests += int(last.get("requests", 0))
                fired = any(
                    s["state"] == "firing"
                    and s["rule"] == "tenant-fair-share[t0]"
                    and s.get("tenant") == "t0"
                    for s in srv.watch.states())
                if fired:
                    break
            m = srv.metrics()
        finally:
            srv.drain(timeout=10.0)
        row["fair_share_fired"] = fired
        row["requests"] = n_requests
        row["errors"] = errors
        per = (m.get("tenants") or {}).get("per_tenant") or {}
        hottest = max(per, key=lambda t: per[t]["requests"],
                      default=None)
        row["hot_tenant"] = hottest
        if last is not None:
            row["hot_p99_ms"] = last.get("hot_p99_ms")
            row["others_p99_ms"] = last.get("others_p99_ms")
            row["value"] = last.get("others_p99_ms")
        # the incident bundle must NAME the culprit tenant
        incident_tenant = None
        for ent in sorted(os.listdir(bundle_dir)
                          if os.path.isdir(bundle_dir) else []):
            inc = os.path.join(bundle_dir, ent, "incident.json")
            if os.path.exists(inc):
                with open(inc) as fh:
                    doc = json.load(fh)
                if doc.get("rule") == "tenant-fair-share[t0]":
                    incident_tenant = doc.get("tenant")
        row["incident_tenant"] = incident_tenant
        if ext_trace:
            row["trace"] = trace_path
        row["ok"] = bool(fired and hottest == "t0"
                         and incident_tenant == "t0" and errors == 0
                         and row.get("value") is not None)
    finally:
        if ctx is not None:
            ctx.cleanup()
    return row


def front_door_drill(tmp_dir: Optional[str] = None,
                     trace_path: Optional[str] = None,
                     threaded_connections: int = 20,
                     connection_factor: int = 10,
                     device=None) -> dict:
    """The threaded-vs-async transport drill: saturate the SAME model
    behind both front ends, the async one holding
    ``connection_factor``x the open keep-alive connections, and report
    ONE ``serving_slo_max_rps`` row: async's max sustained RPS under the
    p99 SLO, the threaded baseline, the connection ratio, and WHICH span
    stage sat at the knee (the fair-queue + shallow-batcher design keeps
    it out of ``queue_wait``). ``device`` None means the GPU."""
    import json as _json
    import os
    import tempfile
    import urllib.request

    import numpy as np

    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.serving.frontdoor import AsyncFrontDoor
    from dpsvm_tpu_torch.serving.loadgen import run_saturate
    from dpsvm_tpu_torch.serving.server import ServingServer

    dev = resolve_device(device)
    ctx = (tempfile.TemporaryDirectory() if tmp_dir is None else None)
    base = tmp_dir if tmp_dir is not None else ctx.name
    ext_trace = trace_path is not None
    c_thr = int(threaded_connections)
    c_asy = c_thr * int(connection_factor)
    row: dict = {"metric": "serving_slo_max_rps", "unit": "req/s",
                 "front_end": "async", "ok": False}
    try:
        path = _drill_model(17, base, "frontdoor.svm")
        rng = np.random.default_rng(18)
        d = 5
        if trace_path is None:
            trace_path = os.path.join(base, "front_door.jsonl")
        rows = rng.standard_normal((64, d)).astype(np.float32)
        sat = dict(p99_target_ms=250.0, start_rps=40.0, rps_factor=2.0,
                   max_steps=4, step_requests=80, concurrency=8,
                   timeout=15.0, trace=trace_path)

        reg_thr = ModelRegistry()
        reg_thr.register("default", path, max_batch=32, device=dev)
        thr_srv = ServingServer(reg_thr, "127.0.0.1", 0, max_batch=32,
                                max_delay_ms=0.5, device=dev).start()
        try:
            thr = run_saturate(thr_srv.url, rows, connections=c_thr,
                               **sat)
        finally:
            thr_srv.drain(timeout=10.0)

        reg_asy = ModelRegistry()
        reg_asy.register("default", path, max_batch=32, device=dev)
        fd = AsyncFrontDoor(
            ServingServer(reg_asy, "127.0.0.1", 0, max_batch=32,
                          max_delay_ms=0.5, trace_out=trace_path,
                          trace_sample_rate=1.0, device=dev),
            max_connections=max(4 * c_asy, 64)).start()
        try:
            # the front-door stats mid-run come from the same endpoint
            # any scraper would use, sampled before the held sockets
            # release
            asy = run_saturate(fd.url, rows, connections=c_asy, **sat)
            with urllib.request.urlopen(fd.url + "/metricsz",
                                        timeout=10.0) as r:
                front = _json.loads(r.read()).get("front_door", {})
        finally:
            fd.drain(timeout=10.0)

        thr_open = int(thr.get("open_connections") or 0)
        asy_open = int(asy.get("open_connections") or 0)
        knee = None
        table = asy.get("span_p99_ms") or {}
        if table:
            knee = max(table, key=lambda k: table[k]["p99_ms"])
        row.update(
            value=asy.get("value"),
            slo_met=bool(asy.get("slo_met")),
            p99_target_ms=sat["p99_target_ms"],
            connections_threaded=thr_open,
            connections_async=asy_open,
            connection_ratio=(round(asy_open / thr_open, 2)
                              if thr_open else None),
            throughput_threaded_rps=thr.get("value"),
            throughput_async_rps=asy.get("value"),
            async_vs_threaded=(
                round(asy["value"] / thr["value"], 3)
                if thr.get("value") else None),
            knee_stage=knee,
            queue_wait_p99_ms=asy.get("queue_wait_p99_ms"),
            compute_p99_ms=asy.get("compute_p99_ms"),
            connections_rejected=int(
                front.get("connections_rejected", 0)),
            steps_threaded=thr.get("steps"),
            steps_async=asy.get("steps"),
        )
        if ext_trace:
            row["trace"] = trace_path
        row["ok"] = bool(
            thr.get("slo_met") and asy.get("slo_met")
            and asy_open >= 10 * max(thr_open, 1)
            and thr.get("value") and asy.get("value")
            and asy["value"] >= 0.8 * thr["value"]
            and knee != "queue_wait")
    finally:
        if ctx is not None:
            ctx.cleanup()
    return row


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m dpsvm_tpu_torch.serving --selfcheck`` entry point."""
    import argparse
    import json
    import os

    p = argparse.ArgumentParser(prog="python -m dpsvm_tpu_torch.serving")
    p.add_argument("--selfcheck", action="store_true",
                   help="run the serving gate (module docstring)")
    p.add_argument("--live-drill", action="store_true",
                   help="run the end-to-end live drift-recovery drill: "
                        "seed a shard log, serve from it, append a "
                        "planted distribution shift, and prove the "
                        "drift->refresh->gate->hot-swap loop recovers "
                        "accuracy; prints ONE JSON row "
                        "(live_refresh_latency) and exits 0 iff it "
                        "recovered eject-free")
    p.add_argument("--tenant-drill", action="store_true",
                   help="run the end-to-end noisy-neighbour drill: an "
                        "8-tenant mix with t0 sending 80%%; the fair-"
                        "share rule and the incident bundle must name "
                        "the hog; prints ONE JSON row (tenant_isolation)"
                        " and exits 0 iff the culprit was identified")
    p.add_argument("--front-door-drill", action="store_true",
                   help="run the threaded-vs-async transport drill: "
                        "saturate the same model behind both front "
                        "ends, the async one holding 10x the open "
                        "keep-alive connections; prints ONE JSON row "
                        "(serving_slo_max_rps) and exits 0 iff async "
                        "sustained the SLO at the connection ratio with "
                        "the latency knee out of queue_wait")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engines run (default: the GPU)")
    args = p.parse_args(argv)
    if not (args.selfcheck or args.live_drill or args.tenant_drill
            or args.front_door_drill):
        p.print_help()
        return 2
    trace_env = os.environ.get("BENCH_TRACE_OUT") or None
    if args.front_door_drill:
        row = front_door_drill(trace_path=trace_env, device=args.device)
        print(json.dumps(row))
        return 0 if row.get("ok") else 1
    if args.tenant_drill:
        row = tenant_isolation_drill(trace_path=trace_env,
                                     device=args.device)
        print(json.dumps(row))
        return 0 if row.get("ok") else 1
    if args.live_drill:
        import tempfile

        from dpsvm_tpu_torch.serving.lifecycle import live_drift_drill
        with tempfile.TemporaryDirectory() as tmp:
            row = live_drift_drill(
                tmp, trace_path=trace_env or os.path.join(
                    tmp, "drill.jsonl"), device=args.device)
        print(json.dumps(row))
        return 0 if row.get("ok") else 1
    problems = selfcheck(device=args.device)
    if problems:
        for q in problems:
            print(f"SELFCHECK FAIL: {q}", file=sys.stderr)
        return 1
    print("serving selfcheck OK: one capture a bucket at warmup and none "
          "after mixed traffic, decisions bitwise decision_function on "
          "the same blocks, a deterministic batcher with coalescing and "
          "a queue-full reject, registry reload at generation 2 and a "
          "failed reload leaving the old engine live, a wedged replica "
          "504'd once then ejected, rebuilt and closed with no stray "
          "capture, the async front door bitwise the threaded server, "
          "and DRR serving 8:1 weights at exactly 8:1")
    return 0
