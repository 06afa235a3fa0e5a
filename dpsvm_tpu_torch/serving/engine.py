"""Online prediction engine: device-resident model buffers and a ladder of
batch shapes, each a captured CUDA graph (port of
``dpsvm_tpu/serving/engine.py``).

The engine fixes the shape economy once, at load time:

* **Packing and compaction**: support vectors, duals and squared norms
  (or an approx model's feature map and weights) go to the device once.
  Zero-coefficient SVs are compacted away first; the dropped count is in
  the manifest.
* **Bucket ladder**: a request's rows are padded up to a ladder of batch
  shapes, the powers of two below ``max_batch`` and ``max_batch`` itself.
  A request of 37 rows runs at bucket 64; one of 5000 rows against
  ``max_batch=256`` streams as full 256-row passes and one padded
  remainder bucket.
* **One CUDA graph a bucket**: on the card, warmup captures each bucket's
  decision program once, over a static input block, in one memory pool
  shared across the ladder, with TF32 off (the cuBLAS algorithm is fixed
  at capture time). A request copies its rows into the bucket's static
  input (one host-to-device copy), replays, and reads the output once
  (one device-to-host read; nothing is read a row at a time). A request
  longer than ``max_batch`` is one copy of all its padded blocks, a
  device-to-device copy and a replay a block, and one read of all the
  outputs. ``COUNTS`` counts captures and replays: warmup captures one
  graph a bucket and traffic after it captures none (the JAX package's
  ``compilewatch`` receipt). On the CPU the same bucket programs run
  eagerly. Replays from the batcher's thread and from direct callers
  serialize on the engine's lock.

Output parity is bitwise: a bucket runs the port's own decision blocks
(``models/svm.decision_block`` / ``pairwise_block``,
``approx/model.approx_block``), so a block of rows through the engine is
bit for bit ``decision_function`` on the same block at the same shape.
Across shapes it is as bitwise as the backend's products (ROADMAP
Queue 3). ``precision="default"`` is bfloat16 operands with float32
accumulation and float32 output, held to a float tolerance instead;
``"high"`` runs the float32 program as ``"highest"`` does (the card has
no bf16x3 mode, and TF32 would make the graph's algorithm depend on a
global flag).

Model coverage: binary SVC (with an optional Platt sidecar), SVR,
one-class, precomputed-kernel models (a column gather on the device),
approx models, and one-vs-one multiclass directories: same-spec pairs as
one ``SegmentPack`` (one product over the concatenated SVs), mixed specs
as per-pair blocks in one graph. A binary SV or approx model whose packed
buffers exceed ``hbm_budget_mb`` is served through
``serving/sharded.ShardedDecider`` when at least two distinct devices are
visible; those deciders run eagerly (no graph).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.models.multiclass import (MulticlassModel,
                                               load_multiclass,
                                               predict_multiclass,
                                               predict_proba_multiclass)
from dpsvm_tpu_torch.models.svm import (SVMModel, decision_block,
                                        pairwise_block, sv_operands)
from dpsvm_tpu_torch.ops.kernels import exact_f32
from dpsvm_tpu_torch.serving.batcher import KNOWN_OUTPUTS

AnyModel = Union[SVMModel, MulticlassModel]

# Ever, in this process: CUDA graphs captured for ladder buckets, and
# their replays.
COUNTS = {"captures": 0, "replays": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def bucket_ladder(max_batch: int) -> List[int]:
    """Powers of two below ``max_batch``, plus ``max_batch`` itself as the
    top rung (not rounded up: padding 10000 to 16384 would waste 60% of
    every full pass)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(int(max_batch))
    return ladder


def compact_model(model: SVMModel) -> Tuple[SVMModel, int]:
    """Drop zero-coefficient support vectors before device packing.
    Returns (model, n_dropped); the same object when nothing drops, so the
    common path keeps bitwise parity with ``decision_function``. Approx
    models have no SV set and are returned unchanged."""
    if getattr(model, "is_approx", False):
        return model, 0
    alpha = np.asarray(model.alpha)
    keep = alpha != 0
    dropped = int(keep.size - np.count_nonzero(keep))
    if dropped == 0:
        return model, 0
    model = dataclasses.replace(
        model,
        x_sv=np.ascontiguousarray(np.asarray(model.x_sv)[keep]),
        alpha=np.ascontiguousarray(alpha[keep]),
        y_sv=np.ascontiguousarray(np.asarray(model.y_sv)[keep]),
        sv_idx=(np.asarray(model.sv_idx)[keep]
                if model.sv_idx is not None else None),
    )
    return model, dropped


def _load_binary_platt(path: str) -> Optional[Tuple[float, float]]:
    from dpsvm_tpu_torch.models.calibration import load_platt, sidecar_path
    if os.path.exists(sidecar_path(path)):
        return load_platt(path)
    return None


def _check_precision(precision: str) -> str:
    if precision not in ("highest", "high", "default"):
        raise ValueError("precision must be 'highest', 'high' or "
                         f"'default', got {precision!r}")
    return precision


class SegmentPack:
    """N same-spec binary SV models behind one decision block: a (m, N)
    decision matrix a block. With ``concat`` (the engine's one-vs-one
    collapse) their SVs are concatenated into one (m, d) x (d, S_total)
    kernel product, then each model sums over its own range: bitwise
    ``models/svm.pairwise_decision_values`` on the same block. Without it
    (the fleet's same-spec groups, ``fleet/packer.py``) each member runs
    its own ``decision_block`` in the one program: a product's bits depend
    on its column count on the CPU and on the card (cuBLAS picks its
    algorithm by shape), so only the member's own product is bitwise a
    dedicated engine's on the same block."""

    def __init__(self, models: Sequence[SVMModel], *, device,
                 include_b: bool = True, precision: str = "highest",
                 concat: bool = True):
        if not models:
            raise ValueError("SegmentPack needs at least one model")
        specs = {(m.kernel, float(m.gamma), float(m.coef0),
                  int(m.degree), int(m.num_attributes)) for m in models}
        if len(specs) != 1:
            raise ValueError(f"SegmentPack needs one shared kernel "
                             f"spec, got {len(specs)}: {sorted(specs)}")
        if models[0].kernel == "precomputed":
            raise ValueError("precomputed-kernel models have no SV "
                             "feature rows to concatenate")
        self.include_b = bool(include_b)
        precision = _check_precision(precision)
        self.concat = bool(concat)
        if self.concat:
            self.ops = [sv_operands(list(models), device, precision)]
        else:
            self.ops = [sv_operands(m, device, precision) for m in models]

    def block(self, xb: torch.Tensor) -> torch.Tensor:
        """(bucket, d) block on the device -> (bucket, N) decisions."""
        if self.concat:
            return pairwise_block(xb, self.ops[0], self.include_b)
        return torch.stack([decision_block(xb, o, self.include_b)
                            for o in self.ops], dim=1)

    def device_bytes(self) -> int:
        return int(sum(o.device_bytes() for o in self.ops))


class _Bucket:
    """One rung on the card: a static input block, the graph of the
    decision program over it, and its output."""

    def __init__(self, fn, rows: int, d: int, device, pool):
        from dpsvm_tpu_torch.solver.smo import capture
        self.x = torch.zeros((rows, d), dtype=torch.float32, device=device)
        self.host = torch.zeros((rows, d), dtype=torch.float32).pin_memory()
        # warm up (cuBLAS handles, workspaces) on a side stream first
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), exact_f32():
            fn(self.x)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a reload captures while the old engine serves
        with capture(self.graph, pool=pool, thread_local=True):
            self.out = fn(self.x)
        COUNTS["captures"] += 1

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        COUNTS["replays"] += 1
        return self.out

    def device_bytes(self) -> int:
        return int((self.x.numel() + self.out.numel()) * 4)


class Ladder:
    """The bucket ladder over one decision program ``fn`` ((rows, d)
    float32 block on ``device`` -> (rows,) or (rows, P) float32): one
    captured graph a bucket on the card with ``graphs`` (captured at
    ``warmup()``), else eager. ``run`` streams a request through it under
    the lock (module docstring)."""

    def __init__(self, fn: Callable, d: int, max_batch: int, device,
                 graphs: bool = True):
        self.fn = fn
        self.d = int(d)
        self.max_batch = int(max_batch)
        self.buckets = bucket_ladder(self.max_batch)
        self.device = torch.device(device)
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self._graphs: Dict[int, _Bucket] = {}
        self._pool = None
        self.lock = threading.Lock()
        self.counts: Dict[int, int] = {b: 0 for b in self.buckets}

    def warmup(self) -> None:
        """Capture every bucket's graph (the card; eager ladders have
        nothing to prepare)."""
        if not self.graphs:
            return
        with self.lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            for b in self.buckets:
                if b not in self._graphs:
                    self._graphs[b] = _Bucket(self.fn, b, self.d,
                                              self.device, self._pool)

    @property
    def captured(self) -> int:
        return len(self._graphs)

    def bucket_for(self, m: int) -> int:
        for b in self.buckets:
            if b >= m:
                return b
        return self.max_batch

    def plan(self, m: int) -> List[Tuple[int, int, int]]:
        """(row offset, rows taken, bucket) of each pass: full top-rung
        passes, then one padded remainder bucket."""
        out, lo = [], 0
        while lo < m:
            take = min(self.max_batch, m - lo)
            out.append((lo, take, self.bucket_for(take)))
            lo += take
        return out

    def _eager(self, xb: torch.Tensor) -> torch.Tensor:
        with exact_f32():
            return self.fn(xb)

    def run(self, x: np.ndarray) -> np.ndarray:
        """(m, d) float32 rows -> (m,) or (m, P) float32 decisions."""
        m = x.shape[0]
        plan = self.plan(m)
        with self.lock:
            if len(plan) == 1:
                _, take, b = plan[0]
                g = self._graphs.get(b) if self.graphs else None
                if g is not None:
                    hv = g.host.numpy()
                    hv[:take] = x
                    hv[take:] = 0.0
                    g.x.copy_(g.host, non_blocking=True)
                    out = g.replay().cpu().numpy()
                else:
                    block = np.zeros((b, self.d), np.float32)
                    block[:take] = x
                    out = self._eager(torch.from_numpy(block).to(
                        self.device)).cpu().numpy()
                self.counts[b] += 1
                return out[:take]
            # several passes: one copy up of every padded block, one read
            # of every output
            starts = np.cumsum([0] + [b for _, _, b in plan])
            pad = np.zeros((int(starts[-1]), self.d), np.float32)
            for (lo, take, _), s in zip(plan, starts):
                pad[s:s + take] = x[lo:lo + take]
            dev_in = torch.from_numpy(pad).to(self.device)
            outs = []
            for (_, _, b), s in zip(plan, starts):
                g = self._graphs.get(b) if self.graphs else None
                if g is not None:
                    g.x.copy_(dev_in[s:s + b])
                    outs.append(g.replay().clone())
                else:
                    outs.append(self._eager(dev_in[s:s + b]))
                self.counts[b] += 1
            full = torch.cat(outs).cpu().numpy()
        keep = np.concatenate([np.arange(s, s + take) for (_, take, _), s
                               in zip(plan, starts)])
        return full[keep]

    def device_bytes(self) -> int:
        return int(sum(g.device_bytes() for g in self._graphs.values()))

    def close(self) -> None:
        """Free the graphs, their pool and the static buffers."""
        with self.lock:
            self._graphs.clear()
            self._pool = None


class PredictionEngine:
    """One loaded model, packed for serving (module docstring).

    ``infer`` / ``predict`` / ``decision_values`` are safe from any
    thread: a request holds the ladder's lock from its copy up to its
    read. ``device`` None means the GPU.
    """

    def __init__(self, model: AnyModel, *, name: str = "default",
                 max_batch: int = 256, include_b: bool = True,
                 platt: Optional[Tuple[float, float]] = None,
                 source: Optional[str] = None, warmup: bool = True,
                 precision: str = "highest",
                 hbm_budget_mb: Optional[float] = None, device=None):
        self.precision = _check_precision(str(precision))
        if hbm_budget_mb is not None and not (float(hbm_budget_mb) > 0):
            raise ValueError(f"hbm_budget_mb must be > 0, got "
                             f"{hbm_budget_mb}")
        self.device = resolve_device(device)
        self.name = str(name)
        self.include_b = bool(include_b)
        self.source = source
        self.max_batch = int(max_batch)
        self.buckets = bucket_ladder(self.max_batch)
        self.multiclass = isinstance(model, MulticlassModel)
        self.n_sv_dropped = 0
        self.hbm_budget_mb = (float(hbm_budget_mb)
                              if hbm_budget_mb is not None else None)
        self._sharded_deciders: List = []
        self._operands: List = []
        if self.multiclass:
            pairs = []
            for m in model.models:
                m, dropped = compact_model(m)
                self.n_sv_dropped += dropped
                pairs.append(m)
            model = dataclasses.replace(model, models=pairs)
            self.platt = None           # per-pair sigmoids live in model
            self.task = "multiclass"
        else:
            model, self.n_sv_dropped = compact_model(model)
            self.platt = platt
            self.task = model.task
        self.model = model
        fn = self._build()
        # sharded deciders span devices and run eagerly; the rest of the
        # ladder is one graph a bucket on the card
        self._ladder = Ladder(fn, self.num_attributes, self.max_batch,
                              self.device,
                              graphs=warmup and not self._sharded_deciders)
        self.warmup_captures = 0
        if warmup:
            before = COUNTS["captures"]
            self._ladder.warmup()
            self.warmup_captures = COUNTS["captures"] - before

    # -- construction -------------------------------------------------

    @classmethod
    def load(cls, path: str, **kwargs) -> "PredictionEngine":
        """Load any saved model: a multiclass directory or a binary, SVR,
        one-class or approx model file (LIBSVM format auto-detected),
        with the Platt sidecar when one sits next to a binary model."""
        if os.path.isdir(path):
            model: AnyModel = load_multiclass(path)
            platt = None
        else:
            from dpsvm_tpu_torch.models.io import load_model
            model = load_model(path)
            platt = _load_binary_platt(path)
        kwargs.setdefault("platt", platt)
        kwargs.setdefault("name", os.path.basename(path.rstrip("/"))
                          or "default")
        return cls(model, source=path, **kwargs)

    def _build(self) -> Callable:
        """Pack the device buffers; return the block program."""
        if self.multiclass:
            ms = self.model.models
            specs = {(m.kernel, float(m.gamma), float(m.coef0),
                      int(m.degree)) for m in ms}
            if (len(specs) == 1 and ms[0].kernel != "precomputed"
                    and not any(getattr(m, "is_approx", False)
                                for m in ms)):
                pack = SegmentPack(ms, device=self.device,
                                   include_b=self.include_b,
                                   precision=self.precision)
                self._operands.append(pack)
                return pack.block
            # mixed kernel specs: per-pair blocks, still one program
            fns = [self._binary_block(m) for m in ms]
            return lambda xb: torch.stack([f(xb) for f in fns], dim=1)
        return self._binary_block(self.model)

    def _maybe_sharded(self, model):
        """A ShardedDecider when the packed buffers exceed the budget and
        at least two distinct devices of this engine's type are visible,
        else None (the single-device ladder)."""
        if self.hbm_budget_mb is None:
            return None
        from dpsvm_tpu_torch.serving import sharded as _sharded
        if not _sharded.eligible(model):
            return None
        if (_sharded.model_bytes_est(model)
                <= self.hbm_budget_mb * (1 << 20)):
            return None
        if self.device.type != "cuda" or torch.cuda.device_count() < 2:
            return None
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        sd = _sharded.ShardedDecider(model, include_b=self.include_b,
                                     precision=self.precision,
                                     devices=devices)
        self._sharded_deciders.append(sd)
        return sd

    def _binary_block(self, model) -> Callable:
        sharded = self._maybe_sharded(model)
        if sharded is not None:
            return lambda xb: sharded(xb).to(self.device)
        include_b = self.include_b
        if getattr(model, "is_approx", False):
            from dpsvm_tpu_torch.approx.model import (approx_block,
                                                      approx_operands)
            ops = approx_operands(model, self.device, self.precision)
            self._operands.append(ops)
            return lambda xb: approx_block(xb, ops, include_b)
        ops = sv_operands(model, self.device, self.precision)
        self._operands.append(ops)
        return lambda xb: decision_block(xb, ops, include_b)

    # -- facts --------------------------------------------------------

    @property
    def num_attributes(self) -> int:
        if self.multiclass:
            return int(self.model.models[0].num_attributes)
        return int(self.model.num_attributes)

    @property
    def n_sv(self) -> int:
        if self.multiclass:
            return int(sum(m.n_sv for m in self.model.models))
        return int(self.model.n_sv)

    @property
    def calibrated(self) -> bool:
        if self.multiclass:
            return self.model.platt is not None
        return self.platt is not None

    @property
    def sharded(self) -> bool:
        return bool(self._sharded_deciders)

    @property
    def model_kind(self) -> str:
        if self.multiclass:
            return "multiclass"
        return getattr(self.model, "model_kind", "sv")

    @property
    def captured(self) -> int:
        """Graphs this engine holds (one a bucket after warmup on the
        card; 0 on the CPU)."""
        return self._ladder.captured

    def device_bytes(self) -> int:
        """Device bytes this engine holds: the packed operands, and the
        graphs' static inputs and outputs."""
        own = sum(o.device_bytes() for o in self._operands)
        own += sum(sd.device_bytes() for sd in self._sharded_deciders)
        return int(own + self._ladder.device_bytes())

    def close(self) -> None:
        """Free the graphs and the device buffers (a page-out)."""
        self._ladder.close()
        self._operands.clear()
        self._sharded_deciders.clear()
        self._ladder.fn = None

    @property
    def manifest(self) -> dict:
        out = {
            "name": self.name,
            "task": self.task,
            "model_kind": self.model_kind,
            "source": self.source,
            "device": str(self.device),
            "num_attributes": self.num_attributes,
            "n_sv": self.n_sv,
            "n_sv_dropped": self.n_sv_dropped,
            "max_batch": self.max_batch,
            "buckets": list(self.buckets),
            "include_b": self.include_b,
            "precision": self.precision,
            "calibrated": self.calibrated,
            "warmup_captures": self.warmup_captures,
            "device_bytes": self.device_bytes(),
        }
        if self.hbm_budget_mb is not None:
            out["hbm_budget_mb"] = self.hbm_budget_mb
        out["sharded"] = self.sharded
        if self._sharded_deciders:
            out["sharding"] = dict(self._sharded_deciders[0].facts(),
                                   n_sharded_deciders=len(
                                       self._sharded_deciders))
        if self.multiclass:
            out["classes"] = [int(c) for c in self.model.classes]
            out["n_pairs"] = len(self.model.models)
            out["pair_kinds"] = sorted(
                {getattr(m, "model_kind", "sv")
                 for m in self.model.models})
        else:
            out["kernel"] = self.model.kernel
            if self.model_kind.startswith("approx"):
                out["approx_dim"] = int(self.model.fmap.dim)
                out["approx_seed"] = int(self.model.fmap.seed)
        return out

    def bucket_counts(self) -> Dict[int, int]:
        """How many device passes each ladder rung has served."""
        with self._ladder.lock:
            return dict(self._ladder.counts)

    # -- evaluation ---------------------------------------------------

    def _check(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2:
            raise ValueError(f"instances must be (m, {self.num_attributes})"
                             f", got shape {x.shape}")
        if x.shape[1] != self.num_attributes:
            raise ValueError(
                f"instances have {x.shape[1]} attributes, model "
                f"{self.name!r} expects {self.num_attributes}")
        return x

    def _decisions(self, x: np.ndarray) -> np.ndarray:
        x = self._check(x)
        if x.shape[0] == 0:
            tail = (len(self.model.models),) if self.multiclass else ()
            return np.empty((0,) + tail, np.float32)
        return self._ladder.run(x)

    def decision_values(self, x) -> np.ndarray:
        """Binary tasks: the (m,) decision/score/prediction vector.
        Multiclass: the (m, P) pairwise decision matrix."""
        return self._decisions(x)

    def pairwise_list(self, x) -> List[np.ndarray]:
        """Multiclass pairwise decisions as a list of per-pair vectors
        (the shape ``models/multiclass.pairwise_decisions`` returns)."""
        if not self.multiclass:
            raise ValueError("pairwise_list applies to multiclass models")
        dec = self._decisions(x)
        return [dec[:, p] for p in range(dec.shape[1])]

    def _with_b(self, dec: np.ndarray):
        """Decisions with the intercept in, from whatever ``include_b``
        produced (the Platt sigmoids are defined on them)."""
        if self.include_b:
            return dec
        if self.multiclass:
            bs = np.asarray([m.b for m in self.model.models], np.float32)
            return dec - bs[None, :]
        return dec - np.float32(self.model.b)

    def infer(self, x, want: Sequence[str] = ("labels",)) -> dict:
        """One decision pass, every requested output derived from it:
        ``labels`` (class labels; floats for SVR; +1/-1 inlier for
        one-class), ``decision`` ((m, P) pairwise for multiclass),
        ``proba`` (Platt P(+1) for binary; (m, k) coupled class
        probabilities for multiclass). ``proba`` from an uncalibrated
        model raises ValueError."""
        unknown = [w for w in want if w not in KNOWN_OUTPUTS]
        if unknown:
            raise ValueError(f"unknown outputs {unknown}; "
                             f"pick from {list(KNOWN_OUTPUTS)}")
        if "proba" in want and not self.calibrated:
            raise ValueError(
                f"model {self.name!r} has no probability calibration — "
                "train with --probability (binary models also need the "
                ".platt.json sidecar next to the model file)")
        x = self._check(x)
        dec = self._decisions(x)
        out: dict = {}
        if self.multiclass:
            cols = [dec[:, p] for p in range(dec.shape[1])]
            if "proba" in want:
                cols_b = list(np.moveaxis(self._with_b(dec), 1, 0))
                proba = predict_proba_multiclass(self.model, x,
                                                 decisions=cols_b)
                out["proba"] = proba
                if "labels" in want:
                    # LIBSVM -b 1: the coupled argmax
                    out["labels"] = self.model.classes[
                        np.argmax(proba, axis=1)]
            if "labels" in want and "labels" not in out:
                out["labels"] = predict_multiclass(
                    self.model, x, include_b=self.include_b,
                    decisions=cols)
            if "decision" in want:
                out["decision"] = dec
            return out
        if "decision" in want:
            out["decision"] = dec
        if "labels" in want:
            if self.task == "svr":
                out["labels"] = dec
            else:
                out["labels"] = np.where(dec < 0, -1, 1).astype(np.int32)
        if "proba" in want:
            from dpsvm_tpu_torch.models.calibration import sigmoid_proba
            pa, pb = self.platt
            out["proba"] = sigmoid_proba(self._with_b(dec), pa, pb)
        return out

    def predict(self, x) -> np.ndarray:
        return self.infer(x, want=("labels",))["labels"]

    def predict_proba(self, x) -> np.ndarray:
        return self.infer(x, want=("proba",))["proba"]
