"""Named multi-model registry with explicit hot reload (port of
``dpsvm_tpu/serving/registry.py``).

One server process serves many models: each registered name owns a
warmed ``PredictionEngine``. Reload is EXPLICIT (an operator action,
``ModelRegistry.reload``), never an mtime watcher: a model file mid-write
must not be half-loaded, and the operator decides when the new artifact
is ready.

Reload builds the replacement engine COMPLETELY (load, compact, pack,
warm every bucket) before the swap, then swaps under the lock — so
traffic never sees a cold or partially-constructed engine, and a load
failure (corrupt file, wrong width) leaves the old engine serving. The
``generation`` counter increments per successful reload so a manifest
says which artifact generation is live. ``DPSVM_FAULT_SERVE_FAIL_RELOAD``
(``resilience/faultinject.py``) makes a reload fail before it loads.

The engine is imported lazily: the registry stays importable without
touching a device. Engine keyword arguments (``device=``, ``max_batch=``,
...) are kept per entry and passed to every build.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class _Entry:
    __slots__ = ("engine", "source", "model", "kwargs", "generation",
                 "loaded_at")

    def __init__(self, engine, source, model, kwargs):
        self.engine = engine
        self.source = source
        self.model = model            # kept for in-memory rebuilds
        self.kwargs = kwargs
        self.generation = 1
        self.loaded_at = time.time() if engine is not None else None


class ModelRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        # serializes lazy hydrations so a request storm on one cold
        # model builds its engine exactly once (the double-checked
        # pattern)
        self._hydrate_lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}

    def register(self, name: str, source: Optional[str] = None, *,
                 model=None, lazy: bool = False, **engine_kwargs):
        """Load + warm a model under ``name``. ``source`` is a model
        file or multiclass directory; alternatively pass an in-memory
        ``model`` (then reload is unavailable, but replica rebuilds
        still are — the model object is retained).

        ``lazy=True`` registers the manifest only: no engine is built,
        no device buffers are packed, no ladder is warmed — the first
        ``engine()`` call hydrates on demand. A 1000-model fleet
        registry boots in seconds instead of paying 1000 warmups up
        front; ``manifests()`` reports ``resident: false`` until the
        first request lands. Returns the engine (eager) or None (lazy)."""
        if (source is None) == (model is None):
            raise ValueError("register needs exactly one of source= "
                             "(a path) or model= (an in-memory model)")
        engine_kwargs.setdefault("name", name)
        if lazy:
            with self._lock:
                self._entries[name] = _Entry(None, source, model,
                                             engine_kwargs)
            return None
        from dpsvm_tpu_torch.serving.engine import PredictionEngine

        if source is not None:
            engine = PredictionEngine.load(source, **engine_kwargs)
        else:
            engine = PredictionEngine(model, **engine_kwargs)
        with self._lock:
            self._entries[name] = _Entry(engine, source, model,
                                         engine_kwargs)
        return engine

    def build(self, name: str):
        """Construct a FRESH, fully-warmed engine for ``name`` from its
        current source (or retained in-memory model) WITHOUT touching
        the registered entry: the fleet cache's hydration of in-memory
        registrations, and the replica pool's rebuild path when it is
        ported (ROADMAP item 11b)."""
        from dpsvm_tpu_torch.serving.engine import PredictionEngine

        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"no model named {name!r} "
                               f"(registered: {list(self._entries)})")
            source, model, kwargs = entry.source, entry.model, entry.kwargs
        if source is not None:
            return PredictionEngine.load(source, **kwargs)
        return PredictionEngine(model, **kwargs)

    def source(self, name: str) -> Optional[str]:
        """The artifact path ``name`` was registered from (None for
        in-memory models) — the lifecycle loop's hot-swap target."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"no model named {name!r} "
                               f"(registered: {list(self._entries)})")
            return entry.source

    def engine(self, name: str):
        """The model's warmed engine — hydrating a lazy entry on first
        touch (build COMPLETELY outside the registry lock, swap in
        under it: concurrent readers of other models never wait on a
        cold model's warmup)."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"no model named {name!r} "
                           f"(registered: {self.names()})")
        if entry.engine is not None:
            return entry.engine
        with self._hydrate_lock:
            with self._lock:
                entry = self._entries.get(name)
                if entry is None:
                    raise KeyError(f"model {name!r} was removed "
                                   "mid-hydration")
                if entry.engine is not None:
                    return entry.engine
            fresh = self.build(name)
            with self._lock:
                entry = self._entries.get(name)
                if entry is None:
                    raise KeyError(f"model {name!r} was removed "
                                   "mid-hydration")
                entry.engine = fresh
                entry.loaded_at = time.time()
            return fresh

    def resident(self, name: str) -> bool:
        """Whether ``name`` currently holds a hydrated engine (False
        for a lazy entry nobody has requested yet, and for one the
        fleet model cache paged out, ``evict``)."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"no model named {name!r} "
                               f"(registered: {list(self._entries)})")
            return entry.engine is not None

    def evict(self, name: str) -> bool:
        """Drop ``name``'s hydrated engine (device buffers free with
        it) while keeping the registration. The next ``engine()`` call
        re-hydrates from the retained source/model. Returns whether an
        engine was actually resident."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"no model named {name!r} "
                               f"(registered: {list(self._entries)})")
            engine, entry.engine = entry.engine, None
            entry.loaded_at = None
        if engine is not None:
            engine.close()
        return engine is not None

    def reload(self, name: str):
        """Re-load ``name`` from its source path and swap atomically.
        The old engine serves until the new one is fully warmed."""
        from dpsvm_tpu_torch.resilience import faultinject
        from dpsvm_tpu_torch.serving.engine import PredictionEngine

        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"no model named {name!r} "
                               f"(registered: {list(self._entries)})")
            source, kwargs = entry.source, entry.kwargs
        if source is None:
            raise ValueError(f"model {name!r} was registered in-memory; "
                             "there is no source path to reload from")
        faultinject.on_serve_reload()   # DPSVM_FAULT_SERVE_FAIL_RELOAD:
        #                                 raises OSError; old stays live
        fresh = PredictionEngine.load(source, **kwargs)   # may raise —
        with self._lock:                                  # old stays live
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(f"model {name!r} was removed mid-reload")
            entry.engine = fresh
            entry.generation += 1
            entry.loaded_at = time.time()
        return fresh

    def promote_file(self, name: str, candidate_path: str) -> int:
        """Atomic hot-swap of ``name``'s artifact: move the candidate
        file onto the registered source path (``os.replace`` — readers
        see old bytes or new bytes, never a torn file), then the
        explicit warmed reload. Returns the new generation. The only
        blessed way a candidate becomes the serving artifact
        (``fleet/grid.promote_winner`` goes through it)."""
        import os

        source = self.source(name)
        if source is None:
            raise ValueError(
                f"model {name!r} was registered in-memory; there is "
                "no source path to promote onto")
        os.replace(candidate_path, source)
        self.reload(name)
        with self._lock:
            return self._entries[name].generation

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def manifests(self) -> Dict[str, dict]:
        """Per-model manifests. Every entry carries ``resident``: a
        hydrated model reports its full engine manifest, a cold (lazy, or
        evicted) one the light registration facts only, so reading 1000
        cold manifests costs no model loads."""
        with self._lock:
            entries = dict(self._entries)
        out = {}
        for name, e in entries.items():
            if e.engine is not None:
                m = dict(e.engine.manifest)
                m["resident"] = True
                m["loaded_at_unix"] = round(e.loaded_at, 3)
            else:
                m = {"name": name, "source": e.source,
                     "resident": False, "loaded_at_unix": None}
            m["generation"] = e.generation
            out[name] = m
        return out
