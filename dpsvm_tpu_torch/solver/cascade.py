"""Three-stage cascade solver (port of ``dpsvm_tpu/solver/cascade.py``):
approx warm-start -> SV screening -> exact dual polish
(``SVMConfig.solver = "cascade"``).

1. **approx warm-start**: ``approx-rff`` (RBF) or ``approx-nystrom``
   (other vector kernels) trained to a loose tolerance
   (``approx/primal.fit_approx``, its chunk a captured CUDA graph);
2. **SV screening** (``approx/screening.py``): every row scored with the
   approx decision function on the device; the margins are first
   calibrated against a small exact probe solve (``api.fit`` on
   ``_PROBE_ROWS`` rows with the user's dual knobs: the fused pair,
   kernel A, at the default knobs; the decomposition, kernel B, with
   ``working_set > 2``); rows clearing the rescaled band ``y f > 1 +
   screen_margin`` are dropped, and ``screen_cap`` bounds the survivors;
3. **exact dual polish**: ``api.warm_start`` runs the exact solver on the
   kept rows (the general pair, or the decomposition and kernel B with
   ``working_set > 2``), loose first and then at the full epsilon; every
   screened-out row is KKT-checked against the polished model (``alpha =
   0`` demands ``y f >= 1 - 2 epsilon``; intermediate rounds scan the
   near-band window first) and violators are re-admitted, for at most
   ``MAX_READMIT_ROUNDS`` rounds: the result is exact, not approximate.

Resume: with ``checkpoint_path`` set, every stage boundary lands a
durable state file (``<path>.cascade.npz`` + the stage-1 approx model
beside it), in the JAX package's format and with its fingerprint, so a
stage file written by either package resumes in the other. A re-run of
the same command resumes at the last completed boundary, bitwise.
``DPSVM_FAULT_CASCADE_STOP_STAGE=k`` (``resilience/faultinject.py``) is
the kill point the drills use. Stage files are removed on success.

Out of core: ``fit_cascade_stream`` runs the same three stages over a
shard directory (``data/stream.ShardedDataset``, through ``_ShardSource``):
the approx stage is ``fit_approx_stream``, screening and the KKT verify
sweep shard by shard through the integrity-checked reader, and only the
screened subproblem materializes, under ``mem_budget_mb``, which also caps
it (``_screen_cap``). The probe and the polish are the in-memory cascade's
``api.fit`` and ``api.warm_start``, so the kernels are picked alike.

Tracing: ``trace_out`` records one cascade trace, as the JAX package's:
a manifest (solver="cascade"), ``cascade_resume``, ``screen``,
``polish``, ``readmit`` (and, on a shard directory, ``quarantine``)
events and a summary whose phase split (approx/screen/polish/verify)
``report`` renders. The stage sub-runs write no traces of their own.

Sharded (``shards > 1``): the approx stage and the polish take the mesh,
the calibration probe runs with ``shards=1`` on each rank, and rank 0
alone writes the trace and the stage files (``fit_cascade``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
import zlib
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from dpsvm_tpu_torch.approx import screening
from dpsvm_tpu_torch.config import (SCREEN_MARGIN_DEFAULT, SVMConfig,
                                    TrainResult)
from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.models.svm import SVMModel
from dpsvm_tpu_torch.resilience import faultinject

# Repair-round bound: every round re-admits all current violators, so the
# kept set grows monotonically; exhausting the bound raises (never an
# inexact model returned quietly).
MAX_READMIT_ROUNDS = 5

# Stage-1 looseness: the approx run only locates the margin. Its tolerance
# is max(3 epsilon, _APPROX_EPS_FLOOR) and its iterations are capped.
_APPROX_EPS_FLOOR = 3e-3
_APPROX_MAX_ITER = 5000

# Progressive polishing: the first round runs at _LOOSE_FACTOR * epsilon
# with the matching verify slack; the last round always at epsilon.
_LOOSE_FACTOR = 5.0

# Tiered verification: intermediate rounds scan screened-out rows within
# _VERIFY_WINDOW of the band edge; the final verify scans every one.
_VERIFY_WINDOW = 1.0

# Margin-scale calibration probe (screening.margin_scale), skipped below
# _PROBE_MIN_N rows.
_PROBE_ROWS = 4096
_PROBE_MIN_N = 3 * _PROBE_ROWS
_PROBE_MAX_ITER = 100_000

_STATE_FORMAT = "dpsvm-cascade-state-v1"

# The last run's calibration probe: rows, exact iterations, scale (0 rows
# when the problem is below _PROBE_MIN_N).
RUN: dict = {}


class CascadeError(RuntimeError):
    """Base class for cascade orchestration failures."""


class CascadeInterrupted(CascadeError):
    """Raised by the deterministic stage-boundary kill point
    (``DPSVM_FAULT_CASCADE_STOP_STAGE``). The stage state is durable;
    re-running the same command resumes."""

    def __init__(self, stage: int):
        self.stage = stage
        super().__init__(
            f"cascade stopped after stage-{stage} boundary (injected); "
            "re-run to resume from the durable stage state")


class CascadeRepairError(CascadeError):
    """The re-admission loop exhausted its round budget with KKT violators
    still outstanding: the screening band is too tight for this problem;
    raise ``screen_margin`` (or the cap) and re-run."""


class CascadeStateError(ValueError):
    """A stage-state file on disk does not match this run's problem or
    config: stale state from a different run; delete it to restart."""


def _log(msg: str) -> None:
    print(f"CASCADE: {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class CascadeResult(TrainResult):
    """TrainResult + the cascade's own diagnostics. ``n_iter`` sums the
    approx steps and every polish round's iterations; ``alpha`` is
    full-length (zeros at screened-out rows)."""

    n_total: int = 0            # dataset rows screened
    n_band: int = 0             # rows inside the margin band
    n_kept: int = 0             # final exact-subproblem rows
    readmit_rounds: int = 0     # polish rounds run (1 = no repair)
    n_readmitted: int = 0       # rows the KKT verify re-admitted
    kkt_violators: int = 0      # violators after the last round (0 on
                                # success: the exactness certificate)
    approx_iters: int = 0
    polish_iters: int = 0
    stage_seconds: dict = dataclasses.field(default_factory=dict)


class _ArraySource:
    """In-memory (x, y): blocks are fixed-size slices, decisions on the
    device."""

    def __init__(self, x: np.ndarray, y: np.ndarray, device,
                 block: int = 8192, group=None):
        self.x = x
        self.y = np.asarray(y)
        self.n, self.d = x.shape
        self.device = device
        self.block = block
        self.group = group          # a sharded run's process group

    def fit_approx(self, cfg: SVMConfig, init_w=None):
        from dpsvm_tpu_torch.approx.primal import fit_approx
        return fit_approx(self.x, self.y, cfg, init_w=init_w,
                          device=self.device, group=self.group)

    def decisions(self, model, x) -> np.ndarray:
        from dpsvm_tpu_torch.models.svm import decision_function
        return np.asarray(decision_function(model, x, device=self.device))

    def blocks(self, model) -> Iterator[Tuple[int, np.ndarray,
                                              np.ndarray, np.ndarray]]:
        for lo in range(0, self.n, self.block):
            hi = min(lo + self.block, self.n)
            xb = self.x[lo:hi]
            yield lo, xb, self.y[lo:hi], self.decisions(model, xb)

    def iter_out(self, model, kept_idx: np.ndarray,
                 window_idx: Optional[np.ndarray] = None):
        """(global idx, x, y, decisions) over the screened-out rows only
        (the KKT verify); with ``window_idx``, those rows of the window."""
        if window_idx is not None:
            mask = np.zeros(self.n, bool)
            mask[window_idx] = True
        else:
            mask = np.ones(self.n, bool)
        mask[kept_idx] = False
        out_idx = np.flatnonzero(mask)
        if not len(out_idx):
            return
        x_out = np.ascontiguousarray(self.x[out_idx])
        y_out = np.asarray(self.y)[out_idx]
        dec = self.decisions(model, x_out)
        for lo in range(0, len(out_idx), self.block):
            hi = min(lo + self.block, len(out_idx))
            yield (out_idx[lo:hi], x_out[lo:hi], y_out[lo:hi],
                   dec[lo:hi])

    def gather(self, idx: np.ndarray):
        return (np.ascontiguousarray(self.x[idx]),
                np.asarray(self.y)[idx])


class _ShardSource:
    """A ``data.stream.ShardedDataset``: blocks are shards, read through
    the integrity-checked policy path, so screening works on datasets that
    never fit in memory and a quarantined shard drops out of every pass as
    it does in streaming training."""

    kind = "stream"

    def __init__(self, ds, config: SVMConfig, allow_nonfinite: bool,
                 device):
        self.ds = ds
        self.n, self.d = ds.n, ds.d
        self.policy = config.on_bad_shard
        self.allow_nonfinite = allow_nonfinite
        self.device = device
        self.notify_quarantine: Optional[Callable] = None

    def _read(self, k: int):
        return self.ds.read_shard_checked(
            k, on_bad_shard=self.policy,
            allow_nonfinite=self.allow_nonfinite,
            on_quarantine=self.notify_quarantine)

    def fit_approx(self, cfg: SVMConfig, init_w=None):
        from dpsvm_tpu_torch.approx.primal import fit_approx_stream
        return fit_approx_stream(self.ds, cfg, task="svc",
                                 allow_nonfinite=self.allow_nonfinite,
                                 init_w=init_w, device=self.device)

    decisions = _ArraySource.decisions

    def blocks(self, model):
        for k in range(self.ds.n_shards):
            got = self._read(k)
            if got is None:
                continue
            xk, yk = got
            yield self.ds.row_offset(k), xk, yk, self.decisions(model, xk)

    def iter_out(self, model, kept_idx: np.ndarray,
                 window_idx: Optional[np.ndarray] = None):
        """Screened-out rows shard by shard (decisions over the whole
        shard, subset on the host); with ``window_idx``, shards holding no
        window rows are not read."""
        for k in range(self.ds.n_shards):
            base = self.ds.row_offset(k)
            rows_k = self.ds.shard_rows(k)
            if window_idx is not None:
                wlo = np.searchsorted(window_idx, base)
                whi = np.searchsorted(window_idx, base + rows_k)
                if wlo == whi:
                    continue
            got = self._read(k)
            if got is None:
                continue
            xk, yk = got
            if window_idx is not None:
                mask = np.zeros(len(yk), bool)
                mask[window_idx[wlo:whi] - base] = True
            else:
                mask = np.ones(len(yk), bool)
            lo = np.searchsorted(kept_idx, base)
            hi = np.searchsorted(kept_idx, base + rows_k)
            mask[kept_idx[lo:hi] - base] = False
            if not mask.any():
                continue
            dec = self.decisions(model, xk)
            yield (base + np.flatnonzero(mask), xk[mask],
                   np.asarray(yk)[mask], dec[mask])

    def gather(self, idx: np.ndarray):
        """Rows at sorted global ``idx``, one sweep over the shards that
        hold them."""
        idx = np.asarray(idx, np.int64)
        out_x = np.empty((len(idx), self.d), np.float32)
        out_y = None
        rps = self.ds.rows_per_shard
        for k in range(self.ds.n_shards):
            base = self.ds.row_offset(k)
            lo = np.searchsorted(idx, base)
            hi = np.searchsorted(idx, base + rps)
            if lo == hi:
                continue
            got = self._read(k)
            if got is None:
                raise CascadeError(
                    f"shard {k} holds {hi - lo} screened-in row(s) but "
                    "is unreadable/quarantined — the kept subproblem "
                    "cannot be assembled (re-screen after repairing "
                    "the shard)")
            xk, yk = got
            local = idx[lo:hi] - base
            out_x[lo:hi] = xk[local]
            if out_y is None:
                out_y = np.empty((len(idx),), np.asarray(yk).dtype)
            out_y[lo:hi] = np.asarray(yk)[local]
        if out_y is None:
            raise CascadeError("no kept rows could be gathered")
        return out_x, out_y


class _StageState:
    """Durable stage-boundary state under ``checkpoint_path``:
    ``<path>.cascade.npz`` (stage, fingerprint, kept set + alphas,
    counters) and the stage-1 approx model beside it
    (``<path>.cascade.approx.npz``). Writes are atomic (tmp + rename)."""

    def __init__(self, base: str, fingerprint: dict, writes: bool = True):
        self.path = base + ".cascade.npz"
        self.approx_path = base + ".cascade.approx.npz"
        self.fingerprint = fingerprint
        # the ranks of a sharded cascade compute the same state: rank 0
        # alone writes it
        self.writes = bool(writes)

    def load(self) -> Optional[dict]:
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                if str(z["format"]) != _STATE_FORMAT:
                    raise KeyError("format")
                got = {k: z[k] for k in z.files}
        except Exception as e:
            raise CascadeStateError(
                f"{self.path}: unreadable cascade stage state "
                f"({type(e).__name__}: {e}) — delete it to restart"
            ) from e
        for k, want in self.fingerprint.items():
            if k not in got:
                raise CascadeStateError(
                    f"{self.path}: stage state predates the "
                    f"{k!r} fingerprint field — stale state from an "
                    "older run; delete it to restart")
            have = got[k]
            have = (str(have) if isinstance(want, str)
                    else type(want)(have))
            if have != want:
                raise CascadeStateError(
                    f"{self.path}: stage state was written for "
                    f"{k}={have!r}, this run has {k}={want!r} — stale "
                    "state from a different problem/config; delete it "
                    "to restart")
        st = {"stage": int(got["stage"]),
              "counters": np.asarray(got["counters"], np.int64)}
        if st["stage"] >= 2:
            st["kept_idx"] = np.asarray(got["kept_idx"], np.int64)
            st["alpha"] = np.asarray(got["alpha"], np.float32)
            st["n_band"] = int(got["n_band"])
            st["wnd_idx"] = (np.asarray(got["wnd_idx"], np.int64)
                             if "wnd_idx" in got else None)
        if st["stage"] >= 3:
            st["b_lo"] = float(got["b_lo"])
            st["b_hi"] = float(got["b_hi"])
            st["converged"] = bool(got["converged"])
        _log(f"resuming from stage-{st['stage']} boundary state "
             f"({self.path})")
        return st

    def save(self, stage: int, counters, *, kept_idx=None, alpha=None,
             n_band: int = 0, b_lo: float = 0.0, b_hi: float = 0.0,
             converged: bool = False, wnd_idx=None) -> None:
        if not self.writes:
            return
        arrays = dict(format=np.str_(_STATE_FORMAT),
                      stage=np.int64(stage),
                      counters=np.asarray(counters, np.int64),
                      n_band=np.int64(n_band),
                      b_lo=np.float64(b_lo), b_hi=np.float64(b_hi),
                      converged=np.bool_(converged))
        for k, v in self.fingerprint.items():
            arrays[k] = np.str_(v) if isinstance(v, str) else v
        if kept_idx is not None:
            arrays["kept_idx"] = np.asarray(kept_idx, np.int64)
            arrays["alpha"] = np.asarray(alpha, np.float32)
        if wnd_idx is not None:
            # the tiered-verify window: a resumed run scans exactly the
            # rows the uninterrupted run would
            arrays["wnd_idx"] = np.asarray(wnd_idx, np.int64)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
        os.close(fd)
        try:
            np.savez(tmp, **arrays)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def save_approx_model(self, model) -> None:
        from dpsvm_tpu_torch.approx.model import save_approx_model
        if self.writes:
            save_approx_model(model, self.approx_path)

    def load_approx_model(self):
        from dpsvm_tpu_torch.approx.model import load_approx_model
        return load_approx_model(self.approx_path)

    def cleanup(self) -> None:
        if not self.writes:
            return
        for p in (self.path, self.approx_path):
            try:
                os.unlink(p)
            except OSError:
                pass


def _fingerprint(config: SVMConfig, n: int, d: int, gamma: float,
                 approx_init_w=None) -> dict:
    """The stage files' identity, the JAX package's dict key for key (the
    warm-start vector included: a stage file written under another init
    reads as stale)."""
    init_crc = (0 if approx_init_w is None else zlib.crc32(
        np.ascontiguousarray(approx_init_w, np.float32).tobytes()))
    return dict(n=np.int64(n), d=np.int64(d),
                c=np.float64(config.c), gamma=np.float64(gamma),
                epsilon=np.float64(config.epsilon),
                kernel=str(config.kernel),
                screen_margin=np.float64(config.screen_margin),
                screen_cap=np.int64(config.screen_cap),
                approx_dim=np.int64(config.approx_dim),
                approx_seed=np.int64(config.approx_seed),
                weight_pos=np.float64(config.weight_pos),
                weight_neg=np.float64(config.weight_neg),
                init_crc=np.int64(init_crc))


def _approx_config(config: SVMConfig) -> SVMConfig:
    """Stage-1 sub-config: the matching approx solver at a loose
    tolerance, every dual-family and orchestration knob reset."""
    kind = "approx-rff" if config.kernel == "rbf" else "approx-nystrom"
    return dataclasses.replace(
        config, solver=kind,
        epsilon=max(3.0 * float(config.epsilon), _APPROX_EPS_FLOOR),
        max_iter=min(int(config.max_iter), _APPROX_MAX_ITER),
        selection="first-order", select_impl="argminmax",
        working_set=2, inner_iters=0, grow_working_set=False,
        shrinking=False, cache_size=0, use_pallas="auto", polish=False,
        screen_margin=SCREEN_MARGIN_DEFAULT, screen_cap=0,
        trace_out=None, checkpoint_path=None, checkpoint_every=0,
        resume_from=None, profile_dir=None, metrics_port=None,
        metrics_out=None, on_divergence="raise", health_window=0)


def _polish_config(config: SVMConfig, budget: int,
                   epsilon: Optional[float] = None) -> SVMConfig:
    """Stage-3 sub-config: the exact dual solver with the user's
    dual-family knobs intact (selection, working_set, shrinking, clip and
    precision pass through); checkpoints, the trace, the profiler and the
    metrics exporters stay with the orchestrator. ``on_divergence`` and
    ``health_window`` pass through, except that ``"rollback"`` becomes
    raise (the sub-run has no checkpoint of its own: the cascade's stage
    files are the recovery unit) and the shrinking manager, which runs
    its own loop, takes neither."""
    shrink = config.shrinking is True
    return dataclasses.replace(
        config, solver="exact", polish=False,
        screen_margin=SCREEN_MARGIN_DEFAULT, screen_cap=0,
        max_iter=int(budget),
        epsilon=(float(epsilon) if epsilon is not None
                 else config.epsilon),
        trace_out=None, checkpoint_path=None, checkpoint_every=0,
        resume_from=None, profile_dir=None, metrics_port=None,
        metrics_out=None,
        health_window=0 if shrink else config.health_window,
        on_divergence=("raise" if shrink
                       or config.on_divergence == "rollback"
                       else config.on_divergence))


def _calibrate(source, config: SVMConfig, model_a) -> float:
    """The screening calibration factor: solve ``_PROBE_ROWS`` subsampled
    rows exactly (through ``api.fit``) and compare both models' margins on
    them. Deterministic in ``approx_seed``, so a resumed run derives the
    same band."""
    RUN.update(probe_rows=0, probe_iters=0, scale=1.0)
    if source.n < _PROBE_MIN_N:
        return 1.0
    from dpsvm_tpu_torch.api import fit

    rng = np.random.default_rng(int(config.approx_seed) + 1)
    idx = np.sort(rng.choice(source.n, size=_PROBE_ROWS,
                             replace=False).astype(np.int64))
    xp, yp = source.gather(idx)
    probe_cfg = dataclasses.replace(
        _polish_config(config, min(int(config.max_iter),
                                   _PROBE_MAX_ITER)),
        shards=1, shard_x=True)
    m_probe, r_probe = fit(xp, yp, probe_cfg, device=source.device)
    ypf = np.asarray(yp, np.float32)
    yf_probe = source.decisions(m_probe, xp) * ypf
    yf_a = source.decisions(model_a, xp) * ypf
    scale = screening.margin_scale(yf_probe, yf_a)
    RUN.update(probe_rows=len(idx), probe_iters=int(r_probe.n_iter),
               scale=scale)
    _log(f"calibration probe: {len(idx)} rows, "
         f"{r_probe.n_iter} exact iter(s) -> approx-margin scale "
         f"{scale:.3f}")
    return scale


def _screen_cap(config: SVMConfig, d: int) -> int:
    """The effective stage-2 row cap: the explicit ``screen_cap``,
    tightened by what ``mem_budget_mb`` admits (the screened subproblem
    must materialize)."""
    cap = int(config.screen_cap)
    if config.mem_budget_mb:
        from dpsvm_tpu_torch.data.stream import budget_admit_rows
        admits = budget_admit_rows(config.mem_budget_mb, d)
        cap = min(cap, admits) if cap else admits
    return cap


def fit_cascade(x: np.ndarray, y: np.ndarray,
                config: Optional[SVMConfig] = None, *,
                approx_init_w=None, device=None, group=None
                ) -> Tuple[SVMModel, CascadeResult]:
    """In-memory cascade (module docstring). Returns an ordinary
    ``SVMModel`` plus a ``CascadeResult`` whose ``alpha`` is the
    full-length dual vector (zeros at screened-out rows). ``device`` None
    means the GPU.

    ``config.shards > 1`` (or a ``group``, which then overrides it) runs
    it over the ranks of a process group (default: the world group),
    every rank called with the same full (x, y): the
    approx stage and the polish take the mesh (``fit_approx`` and
    ``api.warm_start`` with ``shards``), the calibration probe runs on
    each rank with ``shards=1``, screening and the verify sweep are
    replicated, and rank 0 alone writes the trace and the stage files.
    Every rank returns the same model."""
    from dpsvm_tpu_torch.api import _check_xy

    config = config or SVMConfig()
    config.validate()
    if config.solver != "cascade":
        raise ValueError("fit_cascade needs solver='cascade'")
    x, y = _check_xy(x, y)
    model, result = _run_cascade(
        _ArraySource(x, y, resolve_device(device), group=group), config,
        approx_init_w=approx_init_w)
    full = np.zeros((x.shape[0],), np.float32)
    full[result._kept_idx] = result.alpha
    result.alpha = full
    return model, result


def fit_cascade_stream(ds, config: Optional[SVMConfig] = None,
                       allow_nonfinite: bool = False, *,
                       approx_init_w=None, device=None
                       ) -> Tuple[SVMModel, CascadeResult]:
    """Out-of-core cascade over a ``data.stream.ShardedDataset``: the
    approx stage trains through ``fit_approx_stream``, screening and the
    KKT verify sweep shard by shard, and only the screened subproblem
    materializes (budget-guarded). ``result.alpha`` is kept-length: the
    full vector has nowhere to live. ``device`` None means the GPU."""
    config = config or SVMConfig()
    config.validate()
    if config.solver != "cascade":
        raise ValueError("fit_cascade_stream needs solver='cascade'")
    if config.shards != 1:
        raise ValueError("the streaming cascade is single-process "
                         "(config.shards must be 1), like "
                         "fit_approx_stream")
    return _run_cascade(
        _ShardSource(ds, config, allow_nonfinite, resolve_device(device)),
        config, approx_init_w=approx_init_w)


def _lead(config: SVMConfig, group=None) -> bool:
    """Whether this process writes the cascade's trace and stage files:
    always on one device; rank 0 of a sharded run's group, which must be
    up (``parallel/mesh.NO_GROUP`` otherwise)."""
    if config.shards <= 1 and group is None:
        return True
    import torch.distributed as dist

    from dpsvm_tpu_torch.parallel.mesh import NO_GROUP
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(NO_GROUP.format(shards=int(config.shards)))
    return dist.get_rank(group) == 0


def _begin_trace(config: SVMConfig, n: int, d: int, gamma: float, device,
                 group=None):
    if not config.trace_out or not _lead(config, group):
        return None
    from dpsvm_tpu_torch.solver.driver import begin_trace, trace_env
    return begin_trace(config, n, d, gamma, "cascade",
                       env=trace_env(device))


def _run_cascade(source, config: SVMConfig, *, approx_init_w=None
                 ) -> Tuple[SVMModel, CascadeResult]:
    """The three stages under the cascade's one run trace."""
    trace = _begin_trace(config, source.n, source.d,
                         float(config.resolve_gamma(source.d)),
                         source.device, getattr(source, "group", None))
    if trace is not None and getattr(source, "kind", None) == "stream":
        source.notify_quarantine = (
            lambda k, reason: trace.event(
                "quarantine", shard=int(k), reason=reason,
                rows=source.ds.shard_rows(k)))
    try:
        return _stages(source, config, trace, approx_init_w)
    finally:
        if trace is not None and not trace.closed:
            trace.close()


def _stages(source, config: SVMConfig, trace, approx_init_w
            ) -> Tuple[SVMModel, CascadeResult]:
    n, d = source.n, source.d
    gamma = float(config.resolve_gamma(d))
    margin = float(config.screen_margin)
    kkt_tol = 2.0 * float(config.epsilon)
    t_start = time.perf_counter()
    phases = {"approx": 0.0, "screen": 0.0, "polish": 0.0, "verify": 0.0}
    plan = faultinject.current()
    state = (_StageState(config.checkpoint_path,
                         _fingerprint(config, n, d, gamma, approx_init_w),
                         writes=_lead(config, getattr(source, "group",
                                                      None)))
             if config.checkpoint_path else None)
    st = state.load() if state is not None else None
    RUN.clear()
    if st is not None and trace is not None:
        trace.event("cascade_resume", stage=int(st["stage"]))

    # -- stage 1: approx warm-start ----------------------------------
    approx_iters = 0
    model_a = None
    if st is None:
        t0 = time.perf_counter()
        model_a, res_a = source.fit_approx(_approx_config(config),
                                           init_w=approx_init_w)
        approx_iters = int(res_a.n_iter)
        phases["approx"] = time.perf_counter() - t0
        _log(f"approx warm-start: {approx_iters} iter(s) in "
             f"{phases['approx']:.2f}s (converged={res_a.converged})")
        if state is not None:
            state.save_approx_model(model_a)
            state.save(1, [approx_iters, 0, 0, 0])
            if plan is not None and plan.cascade_stop_now(1):
                raise CascadeInterrupted(1)
    else:
        approx_iters = int(st["counters"][0])
        if st["stage"] == 1:
            model_a = state.load_approx_model()

    # -- stage 2: margin-band screening ------------------------------
    if st is not None and st["stage"] >= 2:
        kept_idx = st["kept_idx"]
        alpha = st["alpha"]
        n_band = int(st["n_band"])
        wnd_idx = st.get("wnd_idx")
        x_kept, y_kept = source.gather(kept_idx)
        if trace is not None:
            trace.event("screen", n_iter=approx_iters,
                        n_kept=int(len(kept_idx)), n_total=int(n),
                        band=n_band, resumed=True)
    else:
        t0 = time.perf_counter()
        # The band tests the calibrated margin yf / scale.
        scale = _calibrate(source, config, model_a)
        band_idx_parts, band_yf_parts, wnd_parts = [], [], []
        # Fallback pair: the 2 globally worst-margin rows, so a too-tight
        # band never leaves the pair solver an empty subproblem.
        worst: list = []
        for off, _xb, yb, dec in source.blocks(model_a):
            yf = (np.asarray(dec, np.float32)
                  * np.asarray(yb, np.float32) / np.float32(scale))
            keep = yf <= np.float32(1.0 + margin)
            band_idx_parts.append(off + np.flatnonzero(keep))
            band_yf_parts.append(yf[keep])
            wnd_parts.append(off + np.flatnonzero(
                yf <= np.float32(1.0 + margin + _VERIFY_WINDOW)))
            for j in np.argsort(yf, kind="stable")[:2]:
                worst.append((float(yf[j]), off + int(j)))
            worst = sorted(worst)[:2]
        wnd_idx = (np.concatenate(wnd_parts) if wnd_parts
                   else np.empty(0, np.int64))
        band_idx = (np.concatenate(band_idx_parts) if band_idx_parts
                    else np.empty(0, np.int64))
        band_yf = (np.concatenate(band_yf_parts) if band_yf_parts
                   else np.empty(0, np.float32))
        n_band = int(len(band_idx))
        if n_band < 2:
            extra = np.array(sorted(i for _v, i in worst), np.int64)
            extra_yf = np.array([v for v, _i in sorted(worst)], np.float32)
            mask = ~np.isin(extra, band_idx)
            band_idx = np.concatenate([band_idx, extra[mask]])
            band_yf = np.concatenate([band_yf, extra_yf[mask]])
            order = np.argsort(band_idx, kind="stable")
            band_idx, band_yf = band_idx[order], band_yf[order]
        cap = _screen_cap(config, d)
        kept_idx, capped = screening.apply_cap(band_idx, band_yf, cap)
        from dpsvm_tpu_torch.data.stream import (_fmt_mb,
                                                 check_materialize_budget,
                                                 materialize_bytes)
        check_materialize_budget(config.mem_budget_mb, n=len(kept_idx),
                                 d=d, what="cascade screened subproblem")
        msg = (f"screen: kept {len(kept_idx):,}/{n:,} rows "
               f"(band {n_band:,} at margin <= {scale:g}*(1+{margin:g})"
               + (f", capped to {cap:,}" if capped else "") + ")")
        if config.mem_budget_mb:
            msg += (f" — screened subproblem "
                    f"{_fmt_mb(materialize_bytes(len(kept_idx), d))} fits "
                    f"--mem-budget-mb {config.mem_budget_mb:g}")
        _log(msg)
        x_kept, y_kept = source.gather(kept_idx)
        # The polish enters from zero duals (the JAX package measured and
        # rejected a margin-implied start); repair rounds warm-start.
        alpha = np.zeros((len(kept_idx),), np.float32)
        phases["screen"] = time.perf_counter() - t0
        if trace is not None:
            trace.event("screen", n_iter=approx_iters,
                        n_kept=int(len(kept_idx)), n_total=int(n),
                        band=n_band, scale=round(float(scale), 4),
                        capped=bool(capped))
        if state is not None:
            state.save(2, [approx_iters, 0, 0, 0], kept_idx=kept_idx,
                       alpha=alpha, n_band=n_band, wnd_idx=wnd_idx)
            if plan is not None and plan.cascade_stop_now(2):
                raise CascadeInterrupted(2)

    # -- stage 3: exact polish + KKT re-admission repair -------------
    from dpsvm_tpu_torch.api import warm_start

    counters = (st["counters"] if st is not None
                else np.array([approx_iters, 0, 0, 0], np.int64))
    polish_iters = int(counters[1])
    rounds_done = int(counters[2])
    readmitted_total = int(counters[3])
    res_p: Optional[TrainResult] = None
    need_polish = True
    if st is not None and st["stage"] >= 3:
        # The saved round's outcome is the polished state: reusing it (not
        # re-running the solver) is what makes the resume bitwise.
        res_p = TrainResult(
            alpha=alpha, b=(st["b_lo"] + st["b_hi"]) / 2.0,
            n_iter=polish_iters, converged=st["converged"],
            b_lo=st["b_lo"], b_hi=st["b_hi"], train_seconds=0.0,
            gamma=gamma, n_sv=int(np.sum(alpha > 0)),
            kernel=config.kernel, coef0=float(config.coef0),
            degree=int(config.degree))
        need_polish = False
    last_vio = 0
    while True:
        # Round 1 runs loose, every later round at the full epsilon; both
        # derive from rounds_done alone, so a stage-3 resume derives them.
        if need_polish:
            budget = int(config.max_iter) - polish_iters
            if budget <= 0:
                _log("polish budget exhausted (max_iter); returning the "
                     "last round unrepaired")
                break
            round_eps = (float(config.epsilon) * _LOOSE_FACTOR
                         if rounds_done == 0 else float(config.epsilon))
            t0 = time.perf_counter()
            res_p = warm_start(x_kept, y_kept, alpha,
                               _polish_config(config, budget,
                                              epsilon=round_eps),
                               device=source.device,
                               group=getattr(source, "group", None))
            phases["polish"] += time.perf_counter() - t0
            alpha = np.asarray(res_p.alpha, np.float32)
            polish_iters += int(res_p.n_iter)
            rounds_done += 1
            _log(f"polish round {rounds_done}: {res_p.n_iter} iter(s) on "
                 f"{len(kept_idx):,} rows at eps={round_eps:g} "
                 f"(converged={res_p.converged})")
            if trace is not None:
                trace.event("polish", n_iter=approx_iters + polish_iters,
                            round=rounds_done, n_kept=int(len(kept_idx)),
                            converged=bool(res_p.converged))
            if state is not None:
                state.save(3, [approx_iters, polish_iters, rounds_done,
                               readmitted_total],
                           kept_idx=kept_idx, alpha=alpha, n_band=n_band,
                           b_lo=res_p.b_lo, b_hi=res_p.b_hi,
                           converged=res_p.converged, wnd_idx=wnd_idx)
                if plan is not None and plan.cascade_stop_now(3):
                    raise CascadeInterrupted(3)
        need_polish = True
        model = SVMModel.from_train_result(
            x_kept, y_kept, dataclasses.replace(res_p, alpha=alpha))
        # KKT verify of the screened-out rows; a loose round certifies
        # only its own looser slack.
        round_was_loose = rounds_done == 1
        tol_r = kkt_tol * (_LOOSE_FACTOR if round_was_loose else 1.0)
        t0 = time.perf_counter()

        def _scan(window):
            parts = ([], [], [])
            for oidx, xb, yb, dec in source.iter_out(
                    model, kept_idx, window_idx=window):
                bad = screening.kkt_zero_violations(dec, yb, tol_r)
                if bad.any():
                    parts[0].append(oidx[bad])
                    parts[1].append(np.asarray(xb)[bad])
                    parts[2].append(np.asarray(yb)[bad])
            return parts

        # Tiered verify: the near-band window first; only a clean
        # full-epsilon round pays the full certification scan (and after
        # a tiny repair, goes straight to it).
        tiny_repair = (not round_was_loose
                       and 0 <= last_vio <= 8 and rounds_done > 1)
        use_window = wnd_idx is not None and not tiny_repair
        vio_idx_parts, vio_x, vio_y = (
            _scan(wnd_idx) if use_window else _scan(None))
        if not vio_idx_parts and use_window and not round_was_loose:
            vio_idx_parts, vio_x, vio_y = _scan(None)
        phases["verify"] += time.perf_counter() - t0
        n_vio = sum(len(p) for p in vio_idx_parts)
        last_vio = int(n_vio)
        if n_vio == 0:
            if not round_was_loose:
                break
            # the full-epsilon round is still owed
            continue
        if rounds_done >= MAX_READMIT_ROUNDS:
            raise CascadeRepairError(
                f"{n_vio} screened-out row(s) still violate the "
                f"zero-alpha KKT condition after "
                f"{MAX_READMIT_ROUNDS} repair rounds — the "
                f"screening band (screen_margin={margin:g}"
                + (f", screen_cap={config.screen_cap}"
                   if config.screen_cap else "") +
                ") is too tight for this problem; widen it and "
                "re-run")
        new_idx = np.concatenate(vio_idx_parts)
        new_x = np.concatenate(vio_x)
        new_y = np.concatenate(vio_y)
        all_idx = np.concatenate([kept_idx, new_idx])
        order = np.argsort(all_idx, kind="stable")
        kept_idx = all_idx[order]
        x_kept = np.concatenate([x_kept, new_x])[order]
        y_kept = np.concatenate([np.asarray(y_kept), new_y])[order]
        # Warm restart: previous alphas, zeros for the re-admitted rows
        # (the equality constraint's value is unchanged).
        alpha = np.concatenate(
            [alpha, np.zeros((len(new_idx),), np.float32)])[order]
        readmitted_total += int(n_vio)
        _log(f"readmit round {rounds_done}: {n_vio} KKT violator(s) "
             f"re-admitted (kept now {len(kept_idx):,})")
        if trace is not None:
            trace.event("readmit", n_iter=approx_iters + polish_iters,
                        round=rounds_done, n_readmitted=int(n_vio))

    # -- finish ------------------------------------------------------
    train_seconds = time.perf_counter() - t_start
    converged = bool(res_p is not None and res_p.converged
                     and last_vio == 0
                     # a budget-stopped run whose only round was the loose
                     # one is not certified at epsilon
                     and rounds_done >= 2)
    model = SVMModel.from_train_result(
        x_kept, y_kept, dataclasses.replace(
            res_p if res_p is not None else _empty_result(gamma, config),
            alpha=alpha))
    result = CascadeResult(
        alpha=alpha,
        b=float(res_p.b) if res_p is not None else 0.0,
        n_iter=approx_iters + polish_iters,
        converged=converged,
        b_lo=float(res_p.b_lo) if res_p is not None else 0.0,
        b_hi=float(res_p.b_hi) if res_p is not None else 0.0,
        train_seconds=train_seconds,
        gamma=gamma, n_sv=model.n_sv, kernel=config.kernel,
        coef0=float(config.coef0), degree=int(config.degree),
        n_total=int(n), n_band=int(n_band), n_kept=int(len(kept_idx)),
        readmit_rounds=rounds_done, n_readmitted=readmitted_total,
        kkt_violators=last_vio, approx_iters=approx_iters,
        polish_iters=polish_iters, stage_seconds=dict(phases))
    result._kept_idx = kept_idx        # fit_cascade scatters
    if trace is not None:
        trace.summary(converged=result.converged, n_iter=result.n_iter,
                      b=result.b, b_lo=result.b_lo, b_hi=result.b_hi,
                      n_sv=result.n_sv, train_seconds=train_seconds,
                      phases=dict(phases), n_kept=result.n_kept,
                      n_readmitted=result.n_readmitted)
    if state is not None:
        state.cleanup()
    return model, result


def _empty_result(gamma: float, config: SVMConfig) -> TrainResult:
    return TrainResult(alpha=np.zeros(0, np.float32), b=0.0, n_iter=0,
                       converged=False, b_lo=0.0, b_hi=0.0,
                       train_seconds=0.0, gamma=gamma, n_sv=0,
                       kernel=config.kernel, coef0=float(config.coef0),
                       degree=int(config.degree))
