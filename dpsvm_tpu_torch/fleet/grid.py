"""The C x gamma grid trainer: the fleet's production line (port of
``dpsvm_tpu/fleet/grid.py``).

Every tenant model is really a C x gamma GRID of candidates, of which one
is promoted. ``solver/batched_ovo.train_c_sweep`` already solves a whole
product grid as one batched program (C only moves the box bound, gamma
only the kernel epilogue after the shared dot products). This module
wraps it into the production line:

* **device partitions**: the C axis is split contiguously over the
  visible devices, one batched sweep a device, run side by side in
  threads (one partition, the whole grid, on one card);
* **held-out selection**: a seeded split scores every cell on rows the
  solver never saw; the winner is the row-major first argmax, so ties go
  to the smaller C, then the smaller gamma (LIBSVM's grid.py preference
  for the simpler model);
* **cascade polish**: the winning cell can be refit on ALL rows through
  the cascade (``solver="cascade"``, whose calibration probe runs
  ``api.fit``: kernel A at the default knobs);
* **atomic promotion**: ``promote_winner`` hands the winner to
  ``ModelRegistry.promote_file`` (``os.replace`` and a warmed reload).

``sequential_grid_seconds`` times the same cells as one ``api.fit`` each
(kernel A at the default knobs), the baseline of the grid's speedup. The
JAX package's run trace of a grid (``trace=``) is ROADMAP item 13.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class GridCell:
    """One (C, gamma) point: its model, solver result and held-out
    score."""
    c: float
    gamma: float
    model: object
    result: object
    holdout_acc: float


@dataclasses.dataclass
class GridResult:
    cells: List[GridCell]               # row-major (C, gamma) order
    winner: int                         # index into cells
    n_train: int
    n_holdout: int
    train_seconds: float                # wall for the whole grid
    devices: int
    polished: bool = False

    @property
    def best(self) -> GridCell:
        return self.cells[self.winner]


def holdout_split(n: int, holdout_frac: float, seed: int):
    """Deterministic shuffled split (train_idx, holdout_idx): a seeded
    permutation, not a stride (a stride aliases sorted datasets)."""
    if not 0.0 < holdout_frac < 1.0:
        raise ValueError(f"holdout_frac must be in (0, 1), "
                         f"got {holdout_frac}")
    n_hold = max(1, int(round(n * holdout_frac)))
    if n_hold >= n:
        raise ValueError(f"holdout_frac {holdout_frac} leaves no "
                         f"training rows (n={n})")
    perm = np.random.default_rng(seed).permutation(n)
    return np.sort(perm[n_hold:]), np.sort(perm[:n_hold])


def _partition(items: Sequence, k: int) -> List[List]:
    """Contiguous near-even split of ``items`` into <= k non-empty
    chunks, order kept (row-major reassembly stays trivial)."""
    k = max(1, min(int(k), len(items)))
    base, extra = divmod(len(items), k)
    out, lo = [], 0
    for i in range(k):
        hi = lo + base + (1 if i < extra else 0)
        out.append(list(items[lo:hi]))
        lo = hi
    return out


def visible_devices(device=None, max_devices: Optional[int] = None):
    """The devices a grid spreads over: every visible GPU (``device``
    None or a CUDA device), or the one CPU."""
    import torch

    from dpsvm_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    if max_devices is not None:
        devices = devices[:max(1, int(max_devices))]
    return devices


def train_grid(x, y, *, cs: Sequence[float],
               gammas: Optional[Sequence[float]] = None,
               config=None, holdout_frac: float = 0.2, seed: int = 0,
               polish: bool = False, trace=None,
               max_devices: Optional[int] = None,
               device=None) -> GridResult:
    """Solve the full C x gamma grid, score every cell held-out, pick the
    winner (module docstring). ``device`` None means the GPUs."""
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.models.svm import evaluate

    if trace is not None:
        raise NotImplementedError(
            "train_grid(trace=...) (the grid's run trace: grid_cell and "
            "grid_winner events) is not ported to dpsvm_tpu_torch yet "
            "(ROADMAP Queue 1 item 13); pass trace=None")
    config = config or SVMConfig()
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    cs = [float(c) for c in cs]
    gammas_l = [float(g) for g in gammas] if gammas is not None else None
    if not cs:
        raise ValueError("grid needs at least one C value")

    tr_idx, ho_idx = holdout_split(len(y), holdout_frac, seed)
    x_tr, y_tr = x[tr_idx], y[tr_idx]
    x_ho, y_ho = x[ho_idx], y[ho_idx]

    devices = visible_devices(device, max_devices)
    c_parts = _partition(cs, len(devices))

    t0 = time.perf_counter()
    part_out: List[Optional[list]] = [None] * len(c_parts)
    errors: List[BaseException] = []

    def _solve(i: int, part_cs: List[float], dev) -> None:
        # one batched sweep a device, its partition of C
        try:
            part_out[i] = api.sweep_c(x_tr, y_tr, part_cs, config,
                                      gammas=gammas_l, device=dev)
        except BaseException as e:          # re-raised on the caller
            errors.append(e)

    if len(c_parts) == 1:
        _solve(0, c_parts[0], devices[0])
    else:
        threads = [threading.Thread(target=_solve,
                                    args=(i, p, devices[i]),
                                    name=f"grid-part-{i}")
                   for i, p in enumerate(c_parts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    fitted = [pair for part in part_out for pair in (part or [])]

    gs = gammas_l if gammas_l is not None else [None]
    cells: List[GridCell] = []
    for i, (model, result) in enumerate(fitted):
        acc = float(evaluate(model, x_ho, y_ho, device=devices[0]))
        cells.append(GridCell(c=cs[i // len(gs)], gamma=float(result.gamma),
                              model=model, result=result, holdout_acc=acc))
    # np.argmax: the first maximum, row-major (smaller C, then gamma)
    winner = int(np.argmax([c.holdout_acc for c in cells]))

    polished = False
    if polish:
        # refit the winning cell on ALL rows through the cascade: the
        # shipped artifact sees the holdout too
        best = cells[winner]
        pol_cfg = dataclasses.replace(config, c=best.c, gamma=best.gamma,
                                      solver="cascade")
        model, result = api.fit(x, y, pol_cfg, device=devices[0])
        cells[winner] = GridCell(c=best.c, gamma=best.gamma, model=model,
                                 result=result,
                                 holdout_acc=best.holdout_acc)
        polished = True

    return GridResult(cells=cells, winner=winner, n_train=len(tr_idx),
                      n_holdout=len(ho_idx),
                      train_seconds=time.perf_counter() - t0,
                      devices=len(c_parts), polished=polished)


def sequential_grid_seconds(x, y, *, cs: Sequence[float],
                            gammas: Optional[Sequence[float]] = None,
                            config=None, holdout_frac: float = 0.2,
                            seed: int = 0, device=None
                            ) -> Tuple[float, List]:
    """The baseline the batched grid is measured against: the same cells,
    one ``api.fit`` each, on the same split. Returns (wall seconds,
    [(c, gamma, model)] in the grid's row-major order)."""
    from dpsvm_tpu_torch import api
    from dpsvm_tpu_torch.config import SVMConfig

    config = config or SVMConfig()
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    tr_idx, _ = holdout_split(len(y), holdout_frac, seed)
    x_tr, y_tr = x[tr_idx], y[tr_idx]
    gs = [float(g) for g in gammas] if gammas is not None else [config.gamma]
    t0 = time.perf_counter()
    fitted = []
    for c in cs:
        for g in gs:
            cfg = dataclasses.replace(config, c=float(c), gamma=g)
            model, _ = api.fit(x_tr, y_tr, cfg, device=device)
            fitted.append((float(c), g, model))
    return time.perf_counter() - t0, fitted


def promote_winner(grid: GridResult, registry, name: str) -> int:
    """Ship the winning cell through the registry's atomic promote path:
    serialize it to a candidate file beside the registered source, then
    ``promote_file`` (os.replace and a warmed reload). Returns the new
    generation."""
    from dpsvm_tpu_torch.models.io import save_model

    source = registry.source(name)
    if source is None:
        raise ValueError(f"model {name!r} was registered in-memory; "
                         "there is no source path to promote onto")
    d = os.path.dirname(os.path.abspath(source)) or "."
    fd, cand = tempfile.mkstemp(prefix=f".{os.path.basename(source)}.",
                                suffix=".grid-cand", dir=d)
    os.close(fd)
    try:
        save_model(grid.best.model, cand)
        return registry.promote_file(name, cand)
    finally:
        if os.path.exists(cand):        # promote_file moved it on success
            os.unlink(cand)
