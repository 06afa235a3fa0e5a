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

Gate: ``python -m dpsvm_tpu_torch.serving --selfcheck [--device cpu]``
builds a model and asserts: one capture a bucket at warmup and none
across mixed-size traffic after it; the engine's decisions, labels and
probabilities bitwise ``decision_function`` on the same blocks (and
across request sizes within 1e-5, bitwise where the backend's products
are); the batcher deterministic (a staged queue coalesces in order,
each answer bitwise the engine's on the coalesced rows) and rejecting
past its queue bound; a registry reload serving the new artifact at
generation 2, and a reload failed by ``DPSVM_FAULT_SERVE_FAIL_RELOAD``
leaving the old one live. The JAX
package's replica pool, HTTP server, async front door, fair queue,
lifecycle loop and load generator, and their checks, are ROADMAP item
11b.

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
    "bucket_ladder", "compact_model", "ShardedDecider", "selfcheck",
    "main",
]

_LAZY = {
    "PredictionEngine": ("dpsvm_tpu_torch.serving.engine",
                         "PredictionEngine"),
    "SegmentPack": ("dpsvm_tpu_torch.serving.engine", "SegmentPack"),
    "bucket_ladder": ("dpsvm_tpu_torch.serving.engine", "bucket_ladder"),
    "compact_model": ("dpsvm_tpu_torch.serving.engine", "compact_model"),
    "ShardedDecider": ("dpsvm_tpu_torch.serving.sharded",
                       "ShardedDecider"),
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
    except Exception as e:              # noqa: BLE001 - the gate reports
        import traceback
        traceback.print_exc()
        problems.append(f"selfcheck crashed: {type(e).__name__}: {e}")
    finally:
        if ctx is not None:
            ctx.cleanup()
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m dpsvm_tpu_torch.serving --selfcheck`` entry point."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m dpsvm_tpu_torch.serving")
    p.add_argument("--selfcheck", action="store_true",
                   help="run the serving gate (module docstring)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (default: the GPU)")
    args = p.parse_args(argv)
    if not args.selfcheck:
        p.print_help()
        return 2
    problems = selfcheck(device=args.device)
    if problems:
        for q in problems:
            print(f"SELFCHECK FAIL: {q}", file=sys.stderr)
        return 1
    print("serving selfcheck OK: one capture a bucket at warmup and none "
          "after mixed traffic, decisions bitwise decision_function on "
          "the same blocks, a deterministic batcher with coalescing and "
          "a queue-full reject, registry reload at generation 2 and a "
          "failed reload leaving the old engine live")
    return 0
