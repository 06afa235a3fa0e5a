"""Self-healing model lifecycle: drift -> retrain -> gate -> hot-swap
(port of ``dpsvm_tpu/serving/lifecycle.py``).

A serving model decays silently: the traffic distribution moves and
the frozen decision function keeps scoring it with stale confidence.
"Parallel SVMs in Practice" (arXiv:1404.1066) names model refresh as
the deployment concern that dominates one-shot training; the cheap
retrain that makes an AUTOMATED refresh affordable is exactly the
``approx/`` path ("Recipe for Fast Large-scale SVM Training",
arXiv:2207.01016). This module closes that loop with parts the repo
already has:

1. **Drift detection** — a deterministic two-sample Kolmogorov-
   Smirnov distance between a reference score sample (recorded when
   the serving generation was promoted) and the live rolling
   score-distribution window ``/metricsz`` already keeps. No model
   labels needed: a moved input distribution moves the decision-value
   distribution first.
2. **Supervised retrain** — ``resilience.supervisor.run_with_retries``
   wraps the caller's ``retrain_fn``, so a preempted retrain resumes
   from its checkpoint instead of aborting the refresh.
3. **Eval gate** — the candidate must clear a held-out accuracy floor
   AND (when both runs traced) the ``compare`` regression gate
   (``observability.compare.regressions``) against the serving
   generation's training trace. A refresh that fails the gate changes
   NOTHING: the old generation keeps serving, and the failure is a
   trace event, not a page.
4. **Atomic hot-swap** — only a passing candidate is promoted:
   ``os.replace`` onto the registry source path (atomic at the
   filesystem level), then the registry's explicit reload (new engine
   fully warmed before the swap) and the replica pool's rolling
   refresh.

Everything is deterministic and injectable, so the whole loop — drift
in, promote or gate-hold out — runs on the CPU
(``live_drift_drill(device="cpu")``) as well as on the card.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np


def ks_distance(a, b) -> float:
    """Two-sample Kolmogorov-Smirnov distance sup_x |F_a(x) - F_b(x)|
    — deterministic, rank-based (scale-free), in [0, 1]."""
    a = np.sort(np.asarray(a, np.float64).ravel())
    b = np.sort(np.asarray(b, np.float64).ravel())
    if a.size == 0 or b.size == 0:
        return 0.0
    allv = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, allv, side="right") / a.size
    cdf_b = np.searchsorted(b, allv, side="right") / b.size
    return float(np.max(np.abs(cdf_a - cdf_b)))


class DriftDetector:
    """KS drift test of the live score window against a reference
    sample (the promoted generation's own score distribution).

    ``threshold`` is the KS distance that counts as drift; with the
    default 0.25 a pure location shift of ~0.7 reference standard
    deviations trips it while sampling noise at ``min_count=64`` stays
    an order of magnitude below (KS noise ~ sqrt(1/n) ~ 0.125 at worst
    for the 99th percentile of the null — the margin is the point:
    this arms a RETRAIN, so false positives cost real compute)."""

    def __init__(self, reference, *, threshold: float = 0.25,
                 min_count: int = 64):
        if not (0.0 < threshold <= 1.0):
            raise ValueError(f"threshold must be in (0, 1], "
                             f"got {threshold}")
        self._lock = threading.Lock()
        self.threshold = float(threshold)
        self.min_count = int(min_count)
        self.rearm(reference)

    def rearm(self, reference) -> None:
        """Swap the reference sample — called at every promotion so
        drift is always measured against the GENERATION NOW SERVING."""
        ref = np.asarray(reference, np.float64).ravel()
        if ref.size < 2:
            raise ValueError("reference sample needs >= 2 scores")
        with self._lock:
            self._ref = np.sort(ref)

    def check(self, window) -> Optional[dict]:
        """None = no drift; else the drift facts (the `drift` event's
        payload)."""
        win = np.asarray(window, np.float64).ravel()
        win = win[np.isfinite(win)]
        if win.size < self.min_count:
            return None
        with self._lock:
            ref = self._ref
        ks = ks_distance(ref, win)
        if ks <= self.threshold:
            return None
        return {"ks": round(ks, 6), "threshold": self.threshold,
                "window_n": int(win.size), "reference_n": int(ref.size)}


@dataclasses.dataclass
class RetrainResult:
    """What ``retrain_fn`` hands back: the candidate artifact (a model
    file the serving engine can load), optionally its training trace
    (enables the compare gate) and a fresh reference score sample
    (re-arms the drift detector at promotion)."""
    model_path: str
    trace_path: Optional[str] = None
    reference_scores: Optional[np.ndarray] = None


@dataclasses.dataclass
class GateResult:
    passed: bool
    accuracy: Optional[float]
    floor: float
    problems: "list[str]"


class LifecycleLoop:
    """One model's refresh loop (module docstring).

    * ``score_source()`` -> the live score window (the server's
      ``score_window()``; any 1-D float sequence works).
    * ``retrain_fn(resume_from, attempt)`` -> ``RetrainResult``. Runs
      under ``run_with_retries`` with ``checkpoint_path``, so a
      preempted attempt resumes.
    * ``eval_fn(model_path)`` -> held-out accuracy in [0, 1].
    * ``baseline_trace`` — the serving generation's training trace;
      with it (and a candidate trace) the ``compare`` regression gate
      arms at ``fail_on_regress_pct``.
    * ``on_event(name, **extra)`` — trace/metrics sink (`drift`,
      `retrain`, `promote` with ok True/False).
    * ``on_promote(name)`` — post-swap hook (the server refreshes the
      replica pool here).
    """

    def __init__(self, *, registry, name: str,
                 detector: DriftDetector,
                 score_source: Callable[[], Sequence[float]],
                 retrain_fn: Callable[[Optional[str], int],
                                      RetrainResult],
                 eval_fn: Callable[[str], float],
                 accuracy_floor: float,
                 baseline_trace: Optional[str] = None,
                 fail_on_regress_pct: Optional[float] = None,
                 retries: int = 1, backoff_s: float = 0.0,
                 checkpoint_path: Optional[str] = None,
                 cooldown_s: float = 0.0,
                 on_event: Optional[Callable[..., None]] = None,
                 on_promote: Optional[Callable[[str], None]] = None):
        source = registry.source(name)
        if source is None:
            raise ValueError(
                f"model {name!r} was registered in-memory; the "
                "lifecycle loop needs a source path to hot-swap")
        if os.path.isdir(source):
            raise ValueError(
                "lifecycle hot-swap supports single-file model "
                f"artifacts; {source!r} is a directory (multiclass)")
        self.registry = registry
        self.name = name
        self.detector = detector
        self.score_source = score_source
        self.retrain_fn = retrain_fn
        self.eval_fn = eval_fn
        self.accuracy_floor = float(accuracy_floor)
        self.baseline_trace = baseline_trace
        self.fail_on_regress_pct = fail_on_regress_pct
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.checkpoint_path = checkpoint_path
        self.cooldown_s = float(cooldown_s)
        self._on_event = on_event
        self._on_promote = on_promote
        self._last_action_t = 0.0
        self.history: "list[dict]" = []

    def _emit(self, event: str, **extra) -> None:
        self.history.append({"event": event, **extra})
        if self._on_event is not None:
            try:
                self._on_event(event, **extra)
            except Exception:
                pass

    # -- the loop body ------------------------------------------------

    def step(self) -> str:
        """One poll. Returns the outcome: ``"no-drift"``, ``"cooldown"``,
        ``"promoted"``, ``"gate-held"`` (candidate rejected, old
        generation untouched) or ``"retrain-failed"``."""
        if (self.cooldown_s and
                time.monotonic() - self._last_action_t < self.cooldown_s):
            return "cooldown"
        drift = self.detector.check(self.score_source())
        if drift is None:
            return "no-drift"
        self._emit("drift", model=self.name, **drift)
        self._last_action_t = time.monotonic()
        try:
            result = self._retrain()
        except Exception as e:         # noqa: BLE001 — reported, loop
            self._emit("retrain", model=self.name, ok=False,
                       error=str(e))  # survives to the next poll
            return "retrain-failed"
        self._emit("retrain", model=self.name, ok=True,
                   candidate=result.model_path)
        gate = self.gate(result)
        if not gate.passed:
            self._emit("promote", model=self.name, ok=False,
                       accuracy=gate.accuracy, floor=gate.floor,
                       problems=gate.problems)
            return "gate-held"
        self.promote(result, accuracy=gate.accuracy)
        return "promoted"

    def _retrain(self, fn: Optional[Callable] = None) -> RetrainResult:
        from dpsvm_tpu_torch.resilience.supervisor import run_with_retries

        result = run_with_retries(
            fn or self.retrain_fn, retries=self.retries,
            backoff_s=self.backoff_s,
            checkpoint_path=self.checkpoint_path)
        if not isinstance(result, RetrainResult):
            raise TypeError("retrain_fn must return a RetrainResult, "
                            f"got {type(result).__name__}")
        if not os.path.exists(result.model_path):
            raise FileNotFoundError(
                f"retrain_fn reported {result.model_path!r} but wrote "
                "no such artifact")
        return result

    # -- gate ---------------------------------------------------------

    def gate(self, result: RetrainResult) -> GateResult:
        """Held-out accuracy floor and (when traces exist on both sides)
        the mechanical ``compare`` regression verdicts."""
        problems: "list[str]" = []
        accuracy: Optional[float] = None
        try:
            accuracy = float(self.eval_fn(result.model_path))
        except Exception as e:         # noqa: BLE001 — a gate that
            problems.append(f"eval failed: {e}")   # crashes must HOLD
        if accuracy is not None and accuracy < self.accuracy_floor:
            problems.append(f"held-out accuracy {accuracy:.4f} below "
                            f"floor {self.accuracy_floor:.4f}")
        if (self.baseline_trace and result.trace_path
                and self.fail_on_regress_pct is not None):
            try:
                from dpsvm_tpu_torch.observability.compare import (
                    compare_paths, regressions)
                cmp_, _, _ = compare_paths(self.baseline_trace,
                                           result.trace_path)
                problems.extend(regressions(cmp_,
                                            self.fail_on_regress_pct))
            except Exception as e:     # noqa: BLE001
                problems.append(f"trace compare failed: {e}")
        return GateResult(passed=not problems, accuracy=accuracy,
                          floor=self.accuracy_floor, problems=problems)

    # -- swap ---------------------------------------------------------

    def promote(self, result: RetrainResult,
                accuracy: Optional[float] = None) -> None:
        """Atomically replace the serving artifact and hot-reload: the
        candidate file moves onto the registry source path with
        ``os.replace`` (atomic; readers see old bytes or new bytes,
        never a torn file — ``registry.promote_file``), then the
        registry builds + warms the new engine and swaps it in, then
        the pool refreshes. Any failure here leaves the OLD artifact
        bytes gone only after the replace — which is why the replace
        is last-resort-recoverable: the reload failing keeps the old
        ENGINE serving from memory."""
        gen = self.registry.promote_file(self.name, result.model_path)
        if result.trace_path:
            self.baseline_trace = result.trace_path
        if result.reference_scores is not None:
            self.detector.rearm(result.reference_scores)
        if self._on_promote is not None:
            self._on_promote(self.name)
        self._emit("promote", model=self.name, ok=True,
                   generation=gen, accuracy=accuracy)

    # -- background form ----------------------------------------------

    def run(self, interval_s: float,
            stop: Optional[threading.Event] = None) -> threading.Thread:
        """Poll ``step()`` every ``interval_s`` on a daemon thread
        until ``stop`` is set. Returns the thread."""
        stop = stop or threading.Event()
        self.stop_event = stop

        def loop():
            while not stop.is_set():
                try:
                    self.step()
                except Exception:      # noqa: BLE001 — the loop must
                    pass               # outlive a bad poll
                stop.wait(interval_s)

        t = threading.Thread(target=loop, daemon=True,
                             name=f"dpsvm-lifecycle[{self.name}]")
        t.start()
        return t


# ---------------------------------------------------------------------
# continuous learning on a live shard log
# ---------------------------------------------------------------------

class ContinuousLearningLoop(LifecycleLoop):
    """The drift loop closed over a LIVE shard log (docs/SERVING.md
    "Continuous learning", docs/DATA.md "Live shard logs"): drift can
    now trigger either a CHEAP incremental update — warm-start the
    approx weights on the grown log (``fit_approx_stream(live=True,
    init_w=warm_start_vector(served))``) — or a cadenced FULL retrain
    (every ``full_every``-th refresh; typically the cascade
    warm-started from the incremental weights). Both run under the
    retry supervisor, both must clear the accuracy-floor gate, and
    only a passing candidate reaches the
    atomic hot-swap.

    Robustness contract on top of ``LifecycleLoop``:

    * every stage is individually kill-resumable: the refresh
      functions own their training checkpoints (``checkpoint_path``),
      and once a candidate artifact is durable the loop persists a
      STAGE STATE file (``state_path``, atomic JSON) — a process
      killed between retrain and swap resumes at the GATE with the
      same candidate instead of paying the retrain again;
    * a gate failure dumps an incident bundle (``bundle_dir``)
      whose embedded trace carries the loop's drift/refresh/retrain/
      promote event history — the refresh that did NOT happen leaves
      an artifact saying exactly why;
    * a passing swap lands a ``live_refresh_latency`` perf-ledger row
      (drift-fire -> swapped-generation wall seconds, kind="serve")
      so refresh latency is a gateable historical fact.

    ``incremental_fn`` / ``retrain_fn`` share the retrain signature
    ``(resume_from, attempt) -> RetrainResult``.
    """

    def __init__(self, *, incremental_fn: Optional[Callable] = None,
                 full_every: int = 0,
                 bundle_dir: Optional[str] = None,
                 state_path: Optional[str] = None,
                 ledger_path: Optional[str] = None, **kw):
        super().__init__(**kw)
        if incremental_fn is None and not kw.get("retrain_fn"):
            raise ValueError("ContinuousLearningLoop needs "
                             "incremental_fn and/or retrain_fn")
        self.incremental_fn = incremental_fn
        self.full_every = int(full_every)
        self.bundle_dir = bundle_dir
        self.state_path = state_path
        self.ledger_path = ledger_path
        self.refresh_count = 0
        self.last_refresh: Optional[dict] = None
        self._flight = None
        if bundle_dir:
            from dpsvm_tpu_torch.observability import blackbox
            self._flight = blackbox.FlightRecorder(
                blackbox.make_manifest(
                    solver="serving",
                    config={"model": self.name,
                            "loop": "continuous-learning"}))

    def _emit(self, event: str, **extra) -> None:
        if self._flight is not None:
            try:
                self._flight.event(event, n_iter=0, **extra)
            except Exception:
                pass
        super()._emit(event, **extra)

    # -- durable stage state ------------------------------------------

    def _load_stage_state(self) -> Optional[dict]:
        if not self.state_path or not os.path.exists(self.state_path):
            return None
        import json
        try:
            with open(self.state_path) as fh:
                st = json.load(fh)
        except (OSError, ValueError):
            return None
        if not os.path.exists(st.get("model_path", "")):
            self._clear_stage_state()   # candidate gone: restart clean
            return None
        return st

    def _save_stage_state(self, kind: str, result: RetrainResult,
                          fired_unix: float) -> None:
        if not self.state_path:
            return
        import json
        st = {"stage": "gate", "kind": kind,
              "model_path": result.model_path,
              "trace_path": result.trace_path,
              "reference_scores":
                  (np.asarray(result.reference_scores,
                              np.float64).tolist()
                   if result.reference_scores is not None else None),
              "fired_unix": float(fired_unix),
              "refresh_count": int(self.refresh_count)}
        tmp = f"{self.state_path}.tmp{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(st, fh)
        os.replace(tmp, self.state_path)

    def _clear_stage_state(self) -> None:
        if self.state_path:
            try:
                os.unlink(self.state_path)
            except OSError:
                pass

    # -- the loop body ------------------------------------------------

    def step(self) -> str:
        resumed = self._load_stage_state()
        if resumed is not None:
            # Killed between a durable candidate and the swap: resume
            # at the gate — the retrain is not paid twice.
            self._emit("refresh_resume", model=self.name,
                       refresh_kind=resumed["kind"],
                       candidate=resumed["model_path"])
            self.refresh_count = int(resumed.get(
                "refresh_count", self.refresh_count))
            result = RetrainResult(
                model_path=resumed["model_path"],
                trace_path=resumed.get("trace_path"),
                reference_scores=(
                    np.asarray(resumed["reference_scores"], np.float64)
                    if resumed.get("reference_scores") is not None
                    else None))
            return self._gate_and_swap(resumed["kind"], result,
                                       resumed.get("fired_unix"))
        if (self.cooldown_s and
                time.monotonic() - self._last_action_t < self.cooldown_s):
            return "cooldown"
        drift = self.detector.check(self.score_source())
        if drift is None:
            return "no-drift"
        self._emit("drift", model=self.name, **drift)
        self._last_action_t = time.monotonic()
        fired_unix = time.time()
        want_full = (self.incremental_fn is None
                     or (self.full_every > 0
                         and (self.refresh_count + 1) % self.full_every
                         == 0))
        kind = "full" if want_full else "incremental"
        gen = self.registry.manifests()[self.name]["generation"]
        self._emit("refresh", model=self.name, refresh_kind=kind,
                   generation=gen)
        fn = self.retrain_fn if kind == "full" else self.incremental_fn
        try:
            result = self._retrain(fn)
        except Exception as e:         # noqa: BLE001 — reported, loop
            self._emit("retrain", model=self.name, ok=False,
                       refresh_kind=kind, error=str(e))
            return "retrain-failed"
        self._emit("retrain", model=self.name, ok=True,
                   refresh_kind=kind, candidate=result.model_path)
        self.refresh_count += 1
        self._save_stage_state(kind, result, fired_unix)
        return self._gate_and_swap(kind, result, fired_unix)

    def _gate_and_swap(self, kind: str, result: RetrainResult,
                       fired_unix: Optional[float]) -> str:
        gate = self.gate(result)
        if not gate.passed:
            self._emit("promote", model=self.name, ok=False,
                       refresh_kind=kind, accuracy=gate.accuracy,
                       floor=gate.floor, problems=gate.problems)
            self._dump_gate_bundle(kind, gate)
            self._clear_stage_state()
            return "gate-held"
        self.promote(result, accuracy=gate.accuracy)
        self._clear_stage_state()
        latency = (max(time.time() - float(fired_unix), 0.0)
                   if fired_unix else None)
        gen = self.registry.manifests()[self.name]["generation"]
        self.last_refresh = {"kind": kind, "seconds": latency,
                             "generation": gen,
                             "accuracy": gate.accuracy}
        if latency is not None:
            from dpsvm_tpu_torch.observability import ledger
            ledger.append(
                "live_refresh_latency",
                {"metric": "live_refresh_latency", "refresh_kind": kind,
                 "model": self.name, "generation": gen,
                 "accuracy": gate.accuracy},
                kind="serve", value=float(latency), unit="s",
                direction="lower", trace=result.trace_path,
                path=self.ledger_path)
        return "promoted"

    def _dump_gate_bundle(self, kind: str, gate: GateResult) -> None:
        """A held gate is an incident: the refresh the system decided
        NOT to ship leaves a bundle naming why (docs/OBSERVABILITY.md
        "Incident bundles")."""
        if self._flight is None or not self.bundle_dir:
            return
        from dpsvm_tpu_torch.observability import blackbox
        blackbox.dump_bundle(
            self.bundle_dir, recorder=self._flight,
            rule="refresh-gate-held", severity="warn",
            window=f"model={self.name}",
            reason="; ".join(gate.problems) or "gate held",
            extra={"source": "continuous-learning",
                   "refresh_kind": kind,
                   "accuracy": gate.accuracy, "floor": gate.floor})


# ---------------------------------------------------------------------
# the end-to-end drill
# ---------------------------------------------------------------------

#: the drill world's latent width (its label reads two of these)
_DRILL_LATENT = 6


def live_drift_drill(base_dir: str, *, seed: int = 0,
                     rows_per_shard: int = 96, seed_shards: int = 3,
                     append_shards: int = 4, shift: float = 3.0,
                     shift_at_shard: int = 1,
                     accuracy_floor: float = 0.85,
                     full_every: int = 0,
                     approx_dim: int = 64, c: float = 10.0,
                     trace_path: Optional[str] = None,
                     ledger_path: Optional[str] = None,
                     bundle_dir: Optional[str] = None,
                     d: int = 6, max_iter: int = 600,
                     holdout: int = 256, device=None) -> dict:
    """The live continuous-learning drill, end to end on one process
    (CPU CI + the ``live_drift_drill`` burst tag): seed a shard log,
    train + serve a model from it, APPEND shards whose distribution
    shifts mid-serve, and prove — with no human in the loop — that
    drift fires, the warm-started refresh retrains on the grown log,
    the gate passes, the hot-swap is atomic, the served model's
    held-out accuracy on the SHIFTED world recovers above the floor,
    and serving stays eject-free throughout. Returns one JSON-able
    row (metric ``live_refresh_latency`` = drift-fire -> swapped
    generation wall seconds), appends it to the perf ledger, and —
    when ``trace_path`` is set — records a schema-valid serving trace
    covering every stage event (append_admitted -> drift -> refresh ->
    retrain -> promote).

    ``d`` is the feature width (>= 6; wider rows embed the 6-feature
    world, see below),
    ``max_iter`` caps every fit's steps, ``holdout`` is the rows of each
    held-out world and of the score samples; ``device`` None means the
    GPU for the fits, the engines and the reference decisions."""
    import json as _json

    from dpsvm_tpu_torch.approx.primal import (fit_approx_stream,
                                               warm_start_vector)
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data import live as livelib
    from dpsvm_tpu_torch.data import stream as streamlib
    from dpsvm_tpu_torch.data.synthetic import save_csv
    from dpsvm_tpu_torch.models.io import load_model, save_model
    from dpsvm_tpu_torch.models.svm import decision_function
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.observability.record import (close_serving_trace,
                                                      open_serving_trace)
    from dpsvm_tpu_torch.serving.pool import ReplicaPool
    from dpsvm_tpu_torch.serving.registry import ModelRegistry

    dev = resolve_device(device)
    t_drill = time.perf_counter()
    rng = np.random.default_rng(seed)
    d = int(d)
    if d < _DRILL_LATENT:
        raise ValueError(f"the drill needs d >= {_DRILL_LATENT}, got {d}")
    # Wider than the latent world, rows live on a random 6-dimensional
    # subspace of the d features (as pixels do), and gamma is the latent
    # width's 1/6: the problem is the d = 6 one at any width. I.i.d.
    # features would put every pair of rows at about the same distance,
    # and random features could then not see the two-feature rule.
    embed, gamma = None, None
    if d != _DRILL_LATENT:
        q, _ = np.linalg.qr(np.random.default_rng(seed + 7).standard_normal(
            (d, _DRILL_LATENT)))
        embed = np.ascontiguousarray(q.T, np.float32)
        gamma = 1.0 / _DRILL_LATENT

    def world(z, shifted):
        """(rows in d features, labels) of latent rows ``z``."""
        if shifted:
            z = z + np.float32(shift)
            y = np.where((z[:, 0] - shift)
                         + 0.25 * (z[:, 1] - shift) > 0, 1, -1)
        else:
            y = np.where(z[:, 0] + 0.25 * z[:, 1] > 0, 1, -1)
        x = z if embed is None else z @ embed
        return x, np.asarray(y, np.int32)

    def make_rows(n, shifted):
        return world(rng.standard_normal((n, _DRILL_LATENT)).astype(
            np.float32), shifted)

    # 1. seed log + holdouts (base AND shifted worlds)
    x0, y0 = make_rows(seed_shards * rows_per_shard, False)
    src = os.path.join(base_dir, "seed.csv")
    # wide rows: the first shard goes through the CSV and the rest are
    # appended as binary shards (16384 x 784 floats are ~150 MB of text)
    n_csv = len(y0) if embed is None else min(rows_per_shard, len(y0))
    save_csv(src, x0[:n_csv], y0[:n_csv])
    log_dir = os.path.join(base_dir, "log")
    streamlib.convert_to_shards(src, log_dir,
                                rows_per_shard=rows_per_shard)
    for lo in range(n_csv, len(y0), rows_per_shard):
        livelib.append_shard(log_dir, x0[lo:lo + rows_per_shard],
                             y0[lo:lo + rows_per_shard])
    x_ho_base, y_ho_base = make_rows(holdout, False)
    x_ho_shift, y_ho_shift = make_rows(holdout, True)

    trace = (open_serving_trace(trace_path,
                                models={"default": "live-drill"})
             if trace_path else None)

    def t_event(name, **extra):
        if trace is not None:
            trace.event(name, n_iter=0, **extra)

    # 2. initial model trained from the log, registered, pooled
    cfg = dict(solver="approx-rff", approx_dim=approx_dim, c=c,
               gamma=gamma, epsilon=5e-3, max_iter=max_iter,
               chunk_iters=64, verbose=False)
    ds0 = streamlib.ShardedDataset.open(log_dir)
    model0, _res0 = fit_approx_stream(ds0, SVMConfig(**cfg), device=dev)
    model_path = os.path.join(base_dir, "serving.npz")
    save_model(model0, model_path)
    registry = ModelRegistry()
    registry.register("default", model_path, max_batch=64, device=dev)
    pool = ReplicaPool(lambda idx: registry.build("default"),
                       n_replicas=1, name="default",
                       on_event=lambda e, **kw: t_event(e, **kw))

    def served_scores(x):
        return np.asarray(
            pool.infer(x, ("decision",))["decision"], np.float64)

    try:
        base_scores = served_scores(x0[:holdout])
        detector = DriftDetector(base_scores, threshold=0.25,
                                 min_count=64)

        # 3. the live training view + its watcher (events -> trace)
        ds_live = streamlib.ShardedDataset.open(log_dir)
        watcher = livelib.ShardLogWatcher(
            ds_live,
            on_event=lambda e, **kw: t_event(e, **kw))

        # the serving-side score window: decisions of recently
        # ARRIVED rows, scored through the pool — what /metricsz
        # keeps in production
        window: list = []

        def score_arrivals():
            for k in range(max(0, ds_live.n_shards - 2),
                           ds_live.n_shards):
                got = ds_live.read_shard_checked(k)
                if got is not None:
                    window[:] = served_scores(got[0]).tolist()

        def refresh_fn(kind):
            def run(resume_from, attempt):
                served = load_model(registry.source("default"))
                init = warm_start_vector(served)
                ds_train = streamlib.ShardedDataset.open(log_dir)
                tr_path = os.path.join(
                    base_dir, f"refresh-{kind}.jsonl")
                rcfg = SVMConfig(trace_out=tr_path,
                                 resume_from=resume_from, **cfg)
                if kind == "full":
                    # The cadenced full retrain: the cascade's
                    # warm-started exact polish is the chip-scale
                    # move (solver/cascade.py approx_init_w); at
                    # drill scale the same warm-started stream fit
                    # retrains the full log exactly.
                    model, _ = fit_approx_stream(ds_train, rcfg,
                                                 init_w=init, device=dev)
                else:
                    model, _ = fit_approx_stream(ds_train, rcfg,
                                                 live=True,
                                                 init_w=init, device=dev)
                cand = os.path.join(base_dir, "candidate.npz")
                save_model(model, cand)
                xs = ds_train.materialize()[0][-holdout:]
                return RetrainResult(
                    model_path=cand, trace_path=tr_path,
                    reference_scores=np.asarray(
                        decision_function(model, xs, device=dev),
                        np.float64))
            return run

        def evaluate(candidate_path):
            cand = load_model(candidate_path)
            pred = np.where(np.asarray(
                decision_function(cand, x_ho_shift, device=dev)) < 0,
                -1, 1)
            return float(np.mean(pred == y_ho_shift))

        loop = ContinuousLearningLoop(
            registry=registry, name="default", detector=detector,
            score_source=lambda: np.asarray(window, np.float64),
            retrain_fn=refresh_fn("full"),
            incremental_fn=refresh_fn("incremental"),
            full_every=full_every,
            eval_fn=evaluate, accuracy_floor=accuracy_floor,
            state_path=os.path.join(base_dir, "refresh.state.json"),
            bundle_dir=bundle_dir, ledger_path=ledger_path,
            on_event=t_event,
            on_promote=lambda _name: pool.refresh())

        # 4. pre-shift serving: appends from the BASE world keep the
        # loop quiet (no false drift fire)
        plan = faultinject.current()
        append_rng = np.random.default_rng(seed + 1)
        outcomes = []
        for i in range(append_shards):
            shifted = (plan.live_shift_now(i) if plan is not None
                       else i + 1 >= shift_at_shard)
            xa, ya = world(append_rng.standard_normal(
                (rows_per_shard, _DRILL_LATENT)).astype(np.float32),
                shifted)
            livelib.append_shard(log_dir, xa, ya)
            watcher.poll()
            score_arrivals()
            outcomes.append(loop.step())

        promoted = "promoted" in outcomes
        accepted = [o for o in outcomes
                    if o in ("promoted", "gate-held")]
        pred = np.where(np.asarray(
            served_scores(x_ho_shift)) < 0, -1, 1)
        acc_shift = float(np.mean(pred == y_ho_shift))
        pred_b = np.where(np.asarray(
            served_scores(x_ho_base)) < 0, -1, 1)
        acc_base_before = float(np.mean(np.where(np.asarray(
            decision_function(model0, x_ho_shift, device=dev)) < 0, -1, 1)
            == y_ho_shift))
        pool_metrics = pool.metrics()
        row = {
            "metric": "live_refresh_latency",
            "value": (loop.last_refresh or {}).get("seconds"),
            "unit": "s",
            "promoted": promoted,
            "outcomes": outcomes,
            "refresh_kind": (loop.last_refresh or {}).get("kind"),
            "generation": registry.manifests()["default"]["generation"],
            "log_generation": ds_live.generation,
            "admitted_shards": watcher.admitted_shards,
            "accuracy_shifted_before": acc_base_before,
            "accuracy_shifted_after": acc_shift,
            "accuracy_base_after": float(np.mean(pred_b == y_ho_base)),
            "accuracy_floor": accuracy_floor,
            "ejections": int(pool_metrics.get("ejections", 0)),
            "torn_observed": watcher.torn_observed,
            "stale_observed": watcher.stale_observed,
            "drill_seconds": round(time.perf_counter() - t_drill, 3),
        }
        row["ok"] = bool(promoted and acc_shift >= accuracy_floor
                         and row["ejections"] == 0 and accepted)
        if trace is not None:
            close_serving_trace(trace, requests=len(outcomes),
                                errors=0,
                                seconds=row["drill_seconds"])
        return row
    finally:
        if trace is not None and not trace.closed:
            close_serving_trace(trace)
        pool.close()


# keep the drill's lazy imports honest: faultinject is used above
from dpsvm_tpu_torch.resilience import faultinject  # noqa: E402
