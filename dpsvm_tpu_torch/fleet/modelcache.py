"""Budgeted model cache: thousands of tenants, a fixed number resident on
the device (port of ``dpsvm_tpu/fleet/modelcache.py``).

The reference trainer's ``cache.cu`` keeps hot kernel rows in a fixed
slab and pages cold ones out under LRU. A model fleet has the same
economics one level up, so the cache unit here is the MODEL, and its
admission discipline is the tenant label budget
(``observability/metrics.TenantLabelBudget``):

* **second-touch admission**: while the budget has free slots a first
  touch hydrates at once; once it is full, the first request for a cold
  model is served from a throwaway engine (a *transient*: correct, but
  cold), and only a second touch hydrates it, evicting the LRU resident.
  A one-shot scan over many models costs transients and no evictions;
* **LRU of activity**: admission beyond the budget evicts the least
  recently touched resident (a monotone tick, no wall clock);
* **fault and evict accounting**: every hydration is a ``model_fault``
  (with its measured ``cold_start_ms``), every page-out a ``model_evict``;
  both go to ``on_event`` and to the ``dpsvm_fleet_model_*_total``
  counters of the metric registry.

Resident packable models (binary SV models) live in same-spec
``PackedGroup``s (``fleet/packer.py``); other residents (multiclass
directories, approx and precomputed models, in-memory registrations)
hold a dedicated warmed ``PredictionEngine``. Paging a model out frees
its device buffers and its graphs (its group repacks, or its engine
closes); ``resident_bytes`` counts the device bytes the residents hold.

Conservation: every ``infer`` is exactly one of hit, fault or transient,
so ``touches == hits + faults + transients`` and ``evictions <= faults``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from dpsvm_tpu_torch.fleet.packer import GroupPacker, packable
from dpsvm_tpu_torch.observability.metrics import (MetricsRegistry,
                                                   TenantLabelBudget,
                                                   default_registry)


class _Resident:
    """One hydrated model: a packed-group member (the model and its
    optional Platt sidecar) or a dedicated engine."""
    __slots__ = ("model", "platt", "engine", "cold_start_ms")

    def __init__(self, model=None, platt=None, engine=None,
                 cold_start_ms=0.0):
        self.model = model
        self.platt = platt
        self.engine = engine
        self.cold_start_ms = float(cold_start_ms)


class ModelCache:
    """Budgeted residency over a ``ModelRegistry``.

    The registry holds every model's registration (lazy); the cache
    decides which of them hold device buffers now. ``infer(name, x,
    want)`` is the one entry point: it resolves residency, hydrates or
    serves transiently as admission dictates, and answers from the packed
    group or the resident or transient engine. ``device`` None means the
    GPU; ``metrics`` None the process registry.
    """

    def __init__(self, registry, *, budget: int, max_batch: int = 64,
                 precision: str = "highest", warmup: bool = True,
                 on_event: Optional[Callable[..., None]] = None,
                 device=None, metrics: Optional[MetricsRegistry] = None):
        from dpsvm_tpu_torch.device import resolve_device
        if budget < 1:
            raise ValueError(f"model cache budget must be >= 1, "
                             f"got {budget}")
        self.registry = registry
        self.budget = int(budget)
        self.max_batch = int(max_batch)
        self.precision = str(precision)
        self.warmup = bool(warmup)
        self.on_event = on_event
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        # on_evict fires inside resolve(); the RLock makes the page-out
        # re-entrant from the admission
        self._ledger = TenantLabelBudget(self.budget,
                                         on_evict=self._page_out)
        self._packer = GroupPacker(max_batch=self.max_batch,
                                   precision=self.precision,
                                   warmup=self.warmup, device=self.device)
        self._resident: Dict[str, _Resident] = {}
        self.touches = 0
        self.hits = 0
        self.faults = 0
        self.transients = 0
        self.evictions = 0
        self.cold_start_ms: List[float] = []
        reg = metrics if metrics is not None else default_registry()
        self._counters = {
            k: reg.counter(f"dpsvm_fleet_model_{k}_total", help_)
            for k, help_ in (
                ("hits", "model-cache requests served by a resident"),
                ("faults", "model-cache hydrations (second touch)"),
                ("transients", "model-cache requests served cold by a "
                               "throwaway engine"),
                ("evictions", "model-cache page-outs"))}

    # -- events -------------------------------------------------------

    def _emit(self, event: str, **extra) -> None:
        if self.on_event is not None:
            self.on_event(event, **extra)

    # -- residency ----------------------------------------------------

    def resident_names(self) -> List[str]:
        """Resident models, most recently touched first."""
        with self._lock:
            return [n for n in self._ledger.residents()
                    if n in self._resident]

    def is_resident(self, name: str) -> bool:
        with self._lock:
            return name in self._resident

    def _page_out(self, name: str) -> None:
        """Ledger eviction hook: free ``name``'s device buffers (its
        group segment, whose pack rebuilds, or its engine and graphs) but
        keep the registration."""
        with self._lock:
            res = self._resident.pop(name, None)
            if res is None:
                return
            self._packer.remove(name)
            if res.engine is not None:
                res.engine.close()
            self.evictions += 1
            self._counters["evictions"].inc()
        self._emit("model_evict", model=name)

    def evict(self, name: str) -> bool:
        """Operator page-out. Returns whether the model was resident."""
        with self._lock:
            was = name in self._resident
            self._page_out(name)
            return was

    def _engine_for(self, source: str, name: str, warmup: bool):
        from dpsvm_tpu_torch.serving.engine import PredictionEngine
        return PredictionEngine.load(source, name=name,
                                     max_batch=self.max_batch,
                                     precision=self.precision,
                                     warmup=warmup, device=self.device)

    def _hydrate(self, name: str) -> _Resident:
        """Load ``name`` and give it residency: a packable binary SV model
        joins its spec's group (whose ladder is rebuilt and warmed now),
        anything else gets a dedicated warmed engine. The wall time is
        the model's cold start."""
        t0 = time.perf_counter()
        source = self.registry.source(name)
        res = _Resident()
        if source is None:
            res.engine = self.registry.build(name)
        elif os.path.isdir(source):
            res.engine = self._engine_for(source, name, self.warmup)
        else:
            from dpsvm_tpu_torch.models.io import load_model
            from dpsvm_tpu_torch.serving.engine import (PredictionEngine,
                                                        _load_binary_platt)
            model = load_model(source)
            if packable(model):
                res.model = model
                res.platt = _load_binary_platt(source)
                g = self._packer.add(name, model)
                # warm the repacked group now, so the fault pays the
                # whole cold start and not the next request
                if self.warmup:
                    g.decisions_all(np.zeros(
                        (1, g.spec.num_attributes), np.float32))
            else:
                res.engine = PredictionEngine(
                    model, name=name, max_batch=self.max_batch,
                    precision=self.precision, warmup=self.warmup,
                    device=self.device)
        res.cold_start_ms = (time.perf_counter() - t0) * 1e3
        self._resident[name] = res
        self.faults += 1
        self._counters["faults"].inc()
        self.cold_start_ms.append(res.cold_start_ms)
        return res

    def _transient_engine(self, name: str):
        """A throwaway engine for a touch that is not admitted: no
        warmup, no graphs, no residency, dropped after the reply."""
        source = self.registry.source(name)
        if source is None:
            return self.registry.build(name)
        return self._engine_for(source, name, False)

    # -- serving ------------------------------------------------------

    def infer(self, name: str, x, want: Sequence[str] = ("labels",)) -> dict:
        """Serve one request for ``name``: a hit (resident), a fault
        (second touch: hydrate, then serve warm) or a transient (first
        touch of a full cache: a throwaway engine). KeyError for an
        unregistered name, ValueError for bad inputs."""
        self.registry.source(name)          # KeyError for unknown names
        with self._lock:
            self.touches += 1
            resolved = self._ledger.resolve(name)
            res = self._resident.get(name)
            if res is not None:
                self.hits += 1
                self._counters["hits"].inc()
                return self._serve_resident(name, res, x, want)
            if resolved == name:
                # admitted: serve under the lock, so an eviction cannot
                # unseat the model between hydration and its answer
                res = self._hydrate(name)
                out = self._serve_resident(name, res, x, want)
                cold_ms = res.cold_start_ms
            else:
                out = None
        if out is not None:
            self._emit("model_fault", model=name,
                       cold_start_ms=round(cold_ms, 3))
            return out
        # not admitted: a transient, served outside the lock
        engine = self._transient_engine(name)
        with self._lock:
            self.transients += 1
            self._counters["transients"].inc()
        try:
            return engine.infer(x, want=want)
        finally:
            engine.close()

    def _serve_resident(self, name: str, res: _Resident, x, want) -> dict:
        if res.engine is not None:
            return res.engine.infer(x, want=want)
        from dpsvm_tpu_torch.serving.batcher import KNOWN_OUTPUTS

        unknown = [w for w in want if w not in KNOWN_OUTPUTS]
        if unknown:
            raise ValueError(f"unknown outputs {unknown}; "
                             f"pick from {list(KNOWN_OUTPUTS)}")
        if "proba" in want and res.platt is None:
            raise ValueError(
                f"model {name!r} has no probability calibration — "
                "binary models need the .platt.json sidecar next to "
                "the model file")
        group = self._packer.group_for(name)
        if group is None:                    # pragma: no cover - guard
            raise RuntimeError(f"resident model {name!r} lost its "
                               "packed group")
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != group.spec.num_attributes:
            raise ValueError(
                f"model {name!r} expects (n, "
                f"{group.spec.num_attributes}) features, got "
                f"{tuple(x.shape)}")
        dec = group.decisions_for(name, x)
        out: dict = {}
        if "decision" in want:
            out["decision"] = dec
        if "labels" in want:
            if getattr(res.model, "task", "svc") == "svr":
                out["labels"] = dec
            else:
                out["labels"] = np.where(dec < 0, -1, 1).astype(np.int32)
        if "proba" in want:
            from dpsvm_tpu_torch.models.calibration import sigmoid_proba
            pa, pb = res.platt
            # packed groups serve include_b=True decisions, the form the
            # Platt sigmoid is defined on
            out["proba"] = sigmoid_proba(dec, pa, pb)
        return out

    def decisions_group(self, name: str, x) -> np.ndarray:
        """(m, N) decision matrix of the whole spec group ``name`` is in."""
        with self._lock:
            group = self._packer.group_for(name)
            if group is None:
                raise KeyError(f"model {name!r} is not resident in a "
                               "packed group")
        return group.decisions_all(x)

    # -- accounting ---------------------------------------------------

    def resident_bytes(self) -> int:
        """Device bytes the residents hold now: each packed group's
        operands and its ladder's static buffers, and each dedicated
        engine's (the budget itself is enforced in models)."""
        with self._lock:
            total = sum(g.device_bytes() for g in self._packer.groups())
            total += sum(res.engine.device_bytes()
                         for res in self._resident.values()
                         if res.engine is not None)
            return int(total)

    def stats(self) -> dict:
        """Counters, ledger and packer state. Conservation: touches ==
        hits + faults + transients."""
        with self._lock:
            ledger = self._ledger.stats()
            return {
                "budget": self.budget,
                "resident": len(self._resident),
                "touches": self.touches,
                "hits": self.hits,
                "faults": self.faults,
                "transients": self.transients,
                "evictions": self.evictions,
                "ledger_overflow": ledger["overflow"],
                "resident_bytes": self.resident_bytes(),
                "cold_start_p99_ms": _p99(self.cold_start_ms),
                "packer": self._packer.stats(),
            }


def _p99(vals: List[float]) -> float:
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals, np.float64), 99.0))
