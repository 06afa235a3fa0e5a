"""The model fleet (port of ``dpsvm_tpu/fleet``): many tenant models in
one process, and the grid trainer that makes them.

* ``modelcache`` — ``ModelCache``: a budget of resident models with
                   second-touch admission and LRU of activity (the
                   ``TenantLabelBudget`` discipline applied to model
                   names), so one-shot churn never evicts the working
                   set; every hydration is a ``model_fault`` with its
                   measured cold start, every page-out a ``model_evict``.
* ``packer``     — ``GroupPacker`` / ``PackedGroup``: resident models of
                   one spec (kernel, gamma, coef0, degree, width) share
                   one concatenated decision program (the engine's
                   ``SegmentPack``) and one ladder of captured graphs.
* ``grid``       — ``train_grid``: a C x gamma grid as batched sweeps
                   spread over the devices (``solver/batched_ovo``),
                   held-out scores, cascade polish of the winner, and
                   atomic promotion through ``ModelRegistry``.

Gate: ``python -m dpsvm_tpu_torch.fleet --selfcheck [--device cpu]``
registers 64 tiny models lazily under a cache budget of 8 and asserts:
counter conservation (touches == hits + faults + transients), a resident
set a one-shot scan does not evict, zero captures across steady packed
traffic, packed decisions bitwise a fresh dedicated engine's, an
over-budget admission evicting exactly the LRU resident, and the fault
and evict events as a list matching the counters. The JAX gate's
schema-valid fault/evict trace file is ROADMAP item 13c-ii.

Importing this package touches no device.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from dpsvm_tpu_torch.fleet.modelcache import ModelCache
from dpsvm_tpu_torch.fleet.packer import (GroupPacker, GroupSpec,
                                          PackedGroup, packable)

__all__ = [
    "ModelCache", "GroupPacker", "GroupSpec", "PackedGroup", "packable",
    "train_grid", "GridResult", "GridCell", "holdout_split",
    "sequential_grid_seconds", "promote_winner", "selfcheck", "main",
]

_LAZY = {
    "train_grid": ("dpsvm_tpu_torch.fleet.grid", "train_grid"),
    "GridResult": ("dpsvm_tpu_torch.fleet.grid", "GridResult"),
    "GridCell": ("dpsvm_tpu_torch.fleet.grid", "GridCell"),
    "holdout_split": ("dpsvm_tpu_torch.fleet.grid", "holdout_split"),
    "sequential_grid_seconds": ("dpsvm_tpu_torch.fleet.grid",
                                "sequential_grid_seconds"),
    "promote_winner": ("dpsvm_tpu_torch.fleet.grid", "promote_winner"),
}


def __getattr__(name: str):
    """PEP 562 lazy re-exports: the grid pulls the solver stack only when
    something asks for it."""
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    import importlib
    return getattr(importlib.import_module(mod), attr)


def tiny_fleet(base: str, n_models: int, *, specs=((0.5, 4),),
               seed: int = 7) -> List[str]:
    """Save ``n_models`` tiny binary SV models under ``base``; model i
    uses spec i % len(specs) ((gamma, d) pairs). Returns the paths in
    name order."""
    import os

    import numpy as np

    from dpsvm_tpu_torch.models.io import save_model
    from dpsvm_tpu_torch.models.svm import SVMModel

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_models):
        gamma, d = specs[i % len(specs)]
        n_sv = int(rng.integers(4, 12))
        model = SVMModel(
            x_sv=rng.standard_normal((n_sv, d)).astype(np.float32),
            alpha=rng.uniform(0.05, 2.0, n_sv).astype(np.float32),
            y_sv=np.where(rng.random(n_sv) < 0.5, -1, 1).astype(np.int32),
            b=float(rng.normal()), gamma=gamma)
        path = os.path.join(base, f"m{i:04d}.svm")
        save_model(model, path)
        paths.append(path)
    return paths


def selfcheck(tmp_dir: Optional[str] = None, device=None) -> List[str]:
    """Run the fleet cache end to end on 64 tiny models under a budget of
    8; return the problems found (empty = healthy). ``device`` None
    means the GPU."""
    import os
    import tempfile
    import time as _time

    import numpy as np

    problems: List[str] = []
    ctx = tempfile.TemporaryDirectory() if tmp_dir is None else None
    base = tmp_dir if tmp_dir is not None else ctx.name
    try:
        from dpsvm_tpu_torch.device import resolve_device
        from dpsvm_tpu_torch.observability.metrics import MetricsRegistry
        from dpsvm_tpu_torch.serving import engine as eng
        from dpsvm_tpu_torch.serving.registry import ModelRegistry

        dev = resolve_device(device)
        n_models, budget, d = 64, 8, 4
        paths = tiny_fleet(base, n_models, specs=((0.5, d), (0.25, d)))
        registry = ModelRegistry()
        t0 = _time.perf_counter()
        for i, path in enumerate(paths):
            registry.register(f"m{i:04d}", path, lazy=True)
        boot_s = _time.perf_counter() - t0
        if boot_s > 2.0:
            problems.append(f"lazy registration of {n_models} models "
                            f"took {boot_s:.2f}s — it is loading "
                            "models eagerly")
        if any(m["resident"] for m in registry.manifests().values()):
            problems.append("lazy registration reported resident "
                            "models before any request")

        events: list = []
        metrics = MetricsRegistry()
        cache = ModelCache(registry, budget=budget, max_batch=16,
                           device=dev, metrics=metrics,
                           on_event=lambda e, **kw: events.append((e, kw)))
        rng = np.random.default_rng(3)
        q = rng.standard_normal((5, d)).astype(np.float32)

        # 1) an under-budget cache hydrates on the first touch (fault) and
        # answers the repeat from residency (hit)
        hot = [f"m{i:04d}" for i in range(budget)]
        for name in hot:
            cache.infer(name, q)
            cache.infer(name, q)
        st = cache.stats()
        if st["faults"] != budget or st["resident"] != budget:
            problems.append(f"expected {budget} faults/{budget} "
                            f"residents after double-touching the hot "
                            f"set, got {st['faults']}/{st['resident']}")
        if st["evictions"] != 0:
            problems.append(f"{st['evictions']} evictions while under "
                            "budget")

        # 2) zero captures across steady resident traffic
        caps0 = eng.COUNTS["captures"]
        outs = {}
        for _ in range(3):
            for name in hot:
                outs[name] = cache.infer(name, q,
                                         want=("labels", "decision"))
        if eng.COUNTS["captures"] != caps0:
            problems.append(
                f"{eng.COUNTS['captures'] - caps0} capture(s) across "
                "steady resident traffic — the packed groups recapture")

        # 3) packed decisions are bitwise a fresh dedicated engine's at
        # the same block shape
        for name in hot:
            i = int(name[1:])
            fresh = eng.PredictionEngine.load(paths[i], max_batch=16,
                                              device=dev)
            want = fresh.decision_values(q)
            got = outs[name]["decision"]
            fresh.close()
            if not np.array_equal(got.view(np.int32),
                                  want.view(np.int32)):
                problems.append(
                    f"packed decision for {name} differs from a fresh "
                    f"engine (max abs err "
                    f"{np.max(np.abs(got - want)):.3g})")
                break
            if not np.array_equal(outs[name]["labels"], np.where(
                    want < 0, -1, 1).astype(np.int32)):
                problems.append(f"packed labels differ for {name}")
                break

        # 4) a one-shot scan over the cold tail is all transients: the
        # resident set does not churn
        before = set(cache.resident_names())
        for i in range(budget, n_models):
            cache.infer(f"m{i:04d}", q)
        st = cache.stats()
        if set(cache.resident_names()) != before:
            problems.append("a one-shot cold scan changed the "
                            "resident set")
        if st["evictions"] != 0:
            problems.append(f"a one-shot cold scan caused "
                            f"{st['evictions']} evictions")
        if st["transients"] != n_models - budget:
            problems.append(
                f"expected {n_models - budget} transient serves, got "
                f"{st['transients']}")

        # 5) a hot newcomer (its second touch) evicts exactly the LRU
        # resident; the waiting ledger is bounded by the budget, so pick
        # the last-scanned model
        lru = cache.resident_names()[-1]
        newcomer = f"m{n_models - 1:04d}"
        cache.infer(newcomer, q)
        st = cache.stats()
        if st["evictions"] != 1 or lru in cache.resident_names():
            problems.append(
                f"admission over budget should evict the LRU ({lru}); "
                f"evictions={st['evictions']}, residents="
                f"{cache.resident_names()}")
        if newcomer not in cache.resident_names():
            problems.append(f"admitted newcomer {newcomer} is not "
                            "resident")

        # 6) conservation, and the events and counters agree
        st = cache.stats()
        if st["touches"] != st["hits"] + st["faults"] + st["transients"]:
            problems.append(
                f"counter conservation violated: touches "
                f"{st['touches']} != hits {st['hits']} + faults "
                f"{st['faults']} + transients {st['transients']}")
        if st["faults"] != len(cache.cold_start_ms):
            problems.append("every fault must record a cold start "
                            f"({st['faults']} faults, "
                            f"{len(cache.cold_start_ms)} samples)")
        names = [e for e, _ in events]
        if names.count("model_fault") != st["faults"]:
            problems.append(f"{names.count('model_fault')} model_fault "
                            f"events for {st['faults']} faults")
        if names.count("model_evict") != st["evictions"]:
            problems.append(f"{names.count('model_evict')} model_evict "
                            f"events for {st['evictions']} evictions")
        for k in ("hits", "faults", "transients", "evictions"):
            got = metrics.get(f"dpsvm_fleet_model_{k}_total").value
            if int(got) != st[k]:
                problems.append(f"dpsvm_fleet_model_{k}_total {got} != "
                                f"{st[k]}")
    except Exception as e:              # noqa: BLE001 - the gate reports
        import traceback
        traceback.print_exc()
        problems.append(f"selfcheck crashed: {type(e).__name__}: {e}")
    finally:
        if ctx is not None:
            ctx.cleanup()
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m dpsvm_tpu_torch.fleet --selfcheck`` entry point."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m dpsvm_tpu_torch.fleet")
    p.add_argument("--selfcheck", action="store_true",
                   help="64 lazy models under a cache budget of 8 "
                        "(module docstring)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the models are served (default: the GPU)")
    args = p.parse_args(argv)
    if not args.selfcheck:
        p.print_help()
        return 2
    problems = selfcheck(device=args.device)
    if problems:
        for pr in problems:
            print(f"SELFCHECK FAIL: {pr}", file=sys.stderr)
        return 1
    print("fleet selfcheck OK (64 lazy models under a budget of 8: "
          "counters conserved, one-shot churn never touched the working "
          "set, zero captures through the packed groups, packed decisions "
          "bitwise fresh engines', the LRU evicted, events match the "
          "counters)")
    return 0
