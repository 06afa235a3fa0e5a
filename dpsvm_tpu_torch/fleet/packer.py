"""Same-spec batched serving: N resident models, one decision program
(port of ``dpsvm_tpu/fleet/packer.py``).

Tenants overwhelmingly train with one recipe (kernel family, gamma,
feature width), so their models differ only in which support vectors they
hold. This module serves any same-spec GROUP of models through one
``serving/engine.SegmentPack``:

* **one ladder a spec**: the group's bucket ladder (one captured CUDA
  graph a bucket on the card, every member's decision block in it) is
  built once; a request for any member replays the shared graph;
* **one dispatch a request**: a member's request pads into a bucket and
  reads its own column of the (m, N) decision matrix;
* **membership changes repack**: admitting or evicting a member rebuilds
  the pack and recaptures its ladder at the change (counted in
  ``repacks``), never inside a later request; a churn-free steady state
  captures nothing.

Parity: a member's column is its own ``models/svm.decision_block`` (the
pack runs one product a member, not one over the concatenated SVs, whose
bits would depend on the group's total SV count), so it is bitwise a
dedicated ``PredictionEngine`` for that model at the same block shape
(``tests/test_torch_fleet.py``). The JAX package's group is one
concatenated product; the graph keeps the per-member launches off the
host.

No device is touched at import; a pack builds on its first dispatch.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional

import numpy as np


class GroupSpec(NamedTuple):
    """What a model must share to join a packed group: the kernel's
    parameters and the feature width."""
    kernel: str
    gamma: float
    coef0: float
    degree: int
    num_attributes: int

    @classmethod
    def of(cls, model) -> "GroupSpec":
        return cls(kernel=str(model.kernel), gamma=float(model.gamma),
                   coef0=float(model.coef0), degree=int(model.degree),
                   num_attributes=int(model.num_attributes))


def packable(model) -> bool:
    """A binary SV model with feature rows to concatenate: not approx
    (no SV set), not precomputed (no feature rows), not a multiclass
    directory (it packs its own pairs)."""
    if getattr(model, "is_approx", False):
        return False
    if getattr(model, "models", None) is not None:
        return False
    return getattr(model, "kernel", None) not in (None, "precomputed")


class PackedGroup:
    """One spec's members behind one SegmentPack and its ladder.

    Members are (name, model) in admission order; ``decisions_for``
    streams a request through the ladder and slices the member's column.
    The pack is rebuilt after a membership change, its ladder warmed in
    the rebuild."""

    def __init__(self, spec: GroupSpec, *, max_batch: int = 64,
                 include_b: bool = True, precision: str = "highest",
                 warmup: bool = True, device=None):
        from dpsvm_tpu_torch.device import resolve_device
        from dpsvm_tpu_torch.serving.engine import bucket_ladder

        self.spec = spec
        self.max_batch = int(max_batch)
        self.buckets = bucket_ladder(self.max_batch)
        self.include_b = bool(include_b)
        self.precision = str(precision)
        self.warmup = bool(warmup)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._names: List[str] = []
        self._models: List = []
        self._col: Dict[str, int] = {}
        self._pack = None                  # SegmentPack, built lazily
        self._ladder = None
        self.repacks = 0
        self.dispatches = 0

    # -- membership ---------------------------------------------------

    def _drop_pack(self) -> None:
        if self._ladder is not None:
            self._ladder.close()
        self._pack = self._ladder = None

    def add(self, name: str, model) -> None:
        with self._lock:
            if name in self._col:
                raise ValueError(f"model {name!r} already packed")
            if GroupSpec.of(model) != self.spec:
                raise ValueError(f"model {name!r} spec "
                                 f"{GroupSpec.of(model)} != group "
                                 f"spec {self.spec}")
            self._names.append(name)
            self._models.append(model)
            self._col[name] = len(self._names) - 1
            self._drop_pack()              # membership change: repack

    def remove(self, name: str) -> None:
        with self._lock:
            i = self._col.pop(name, None)
            if i is None:
                raise KeyError(f"model {name!r} not in group")
            del self._names[i]
            del self._models[i]
            self._col = {n: j for j, n in enumerate(self._names)}
            self._drop_pack()

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._col

    def __len__(self) -> int:
        with self._lock:
            return len(self._names)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._names)

    # -- evaluation ---------------------------------------------------

    def _ensure_pack(self):
        """Build (or rebuild) the pack and its ladder under the lock; the
        ladder's captures are paid here, at the membership change."""
        from dpsvm_tpu_torch.serving.engine import Ladder, SegmentPack

        if self._ladder is not None:
            return self._ladder
        if not self._models:
            raise RuntimeError("packed group is empty")
        self._pack = SegmentPack(list(self._models), device=self.device,
                                 include_b=self.include_b,
                                 precision=self.precision, concat=False)
        self._ladder = Ladder(self._pack.block, self.spec.num_attributes,
                              self.max_batch, self.device,
                              graphs=self.warmup)
        self.repacks += 1
        if self.warmup:
            self._ladder.warmup()
        return self._ladder

    def decisions_all(self, x: np.ndarray) -> np.ndarray:
        """(m, N) decision matrix for every member at once."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.spec.num_attributes:
            raise ValueError(
                f"instances must be (m, {self.spec.num_attributes}), "
                f"got shape {x.shape}")
        with self._lock:
            ladder = self._ensure_pack()
            self.dispatches += len(ladder.plan(x.shape[0]))
            return ladder.run(x)

    def decisions_for(self, name: str, x: np.ndarray) -> np.ndarray:
        """(m,) decision values for one member through the shared
        program."""
        with self._lock:
            i = self._col.get(name)
        if i is None:
            raise KeyError(f"model {name!r} not in group")
        return self.decisions_all(x)[:, i]

    def device_bytes(self) -> int:
        """Device bytes of the pack's operands and its ladder's static
        buffers (0 before the first dispatch)."""
        with self._lock:
            if self._pack is None:
                return 0
            return int(self._pack.device_bytes()
                       + self._ladder.device_bytes())

    def stats(self) -> dict:
        with self._lock:
            return {"members": len(self._names),
                    "n_sv": int(sum(int(m.n_sv) for m in self._models)),
                    "repacks": self.repacks,
                    "dispatches": self.dispatches,
                    "packed": self._pack is not None}


class GroupPacker:
    """spec -> PackedGroup: every packable resident model lands in
    exactly one group keyed by its GroupSpec. The model cache owns
    membership (admit -> ``add``, evict -> ``remove``)."""

    def __init__(self, *, max_batch: int = 64, include_b: bool = True,
                 precision: str = "highest", warmup: bool = True,
                 device=None):
        self.max_batch = int(max_batch)
        self.include_b = bool(include_b)
        self.precision = str(precision)
        self.warmup = bool(warmup)
        self.device = device
        self._lock = threading.Lock()
        self._groups: Dict[GroupSpec, PackedGroup] = {}
        self._group_of: Dict[str, GroupSpec] = {}

    def add(self, name: str, model) -> Optional[PackedGroup]:
        """Pack ``name`` into its spec's group (created on its first
        member). None for an unpackable model (the caller keeps a
        dedicated engine instead)."""
        if not packable(model):
            return None
        spec = GroupSpec.of(model)
        with self._lock:
            g = self._groups.get(spec)
            if g is None:
                g = PackedGroup(spec, max_batch=self.max_batch,
                                include_b=self.include_b,
                                precision=self.precision,
                                warmup=self.warmup, device=self.device)
                self._groups[spec] = g
            self._group_of[name] = spec
        g.add(name, model)
        return g

    def remove(self, name: str) -> bool:
        with self._lock:
            spec = self._group_of.pop(name, None)
            if spec is None:
                return False
            g = self._groups[spec]
        g.remove(name)
        with self._lock:
            if len(g) == 0 and self._groups.get(spec) is g:
                del self._groups[spec]
        return True

    def group_for(self, name: str) -> Optional[PackedGroup]:
        with self._lock:
            spec = self._group_of.get(name)
            return self._groups.get(spec) if spec is not None else None

    def groups(self) -> List[PackedGroup]:
        with self._lock:
            return list(self._groups.values())

    def stats(self) -> dict:
        gs = self.groups()
        return {"groups": len(gs),
                "packed_models": int(sum(len(g) for g in gs)),
                "repacks": int(sum(g.repacks for g in gs)),
                "dispatches": int(sum(g.dispatches for g in gs))}
