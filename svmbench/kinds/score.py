"""The ``score`` kind: the reference's evaluation job (``seq_test.cpp``:
every row of the held-out file scored against the model), as the port's
``test --batch <max_batch>`` runs it: ``PredictionEngine.decision_values``
over the whole held-out file, its ladder topped at ``max_batch`` rows.
Jobs run back to back from the window's start until ``seconds`` have
passed; the window ends with the job that crossed the mark. The model is
made from the seed (``score_model`` in the configuration); every seed
scores the same rows against a model of the same size.

The constructor is the set-up (the model, the engine and its graphs, one
job), ``window`` the measured window (with a capture, ``slice_s`` seconds
of whole jobs from ``slice_start_s`` on, profiled) and ``judge`` the
comparison with the plain reference, after the window.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from svmbench import data, reference, roofline
from svmbench.core import sync, worst


@dataclasses.dataclass
class Job:
    t0: float
    t1: float
    decision: Optional[np.ndarray]
    profiled: bool
    error: Optional[str] = None


def score_model(config: dict, x: np.ndarray, y: np.ndarray, seed: int):
    """(SV rows, alpha, labels, b) of the scored model: ``n_sv`` rows drawn
    from the training rows, duals uniform in (0, C] with a
    ``bounded_share`` of them at C, b uniform in [-1, 1]; all from the
    seed."""
    sm = config["score_model"]
    c = float(config["c"])
    rng = np.random.default_rng([int(seed), 1])
    idx = np.sort(rng.choice(x.shape[0], int(sm["n_sv"]), replace=False))
    alpha = c * (1.0 - rng.random(idx.size))          # (0, C]
    alpha[rng.random(idx.size) < float(sm["bounded_share"])] = c
    b = float(rng.uniform(-1.0, 1.0))
    return (np.ascontiguousarray(x[idx]), alpha.astype(np.float32),
            np.ascontiguousarray(y[idx]), b)


class Cell:
    kind = "score"
    slice_name = "svmbench.slice"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 precision: Optional[str] = None):
        from dpsvm_tpu_torch.models.svm import SVMModel
        from dpsvm_tpu_torch.serving.engine import PredictionEngine
        self.config, self.traffic = config, traffic
        x, y, self.pool, _ = data.problems(config, 1)[0]
        self.sv, self.alpha, self.y_sv, self.b = score_model(config, x, y,
                                                             seed)
        model = SVMModel(x_sv=self.sv, alpha=self.alpha, y_sv=self.y_sv,
                         b=self.b, gamma=float(config["gamma"]),
                         kernel=config["kernel"])
        self.engine = PredictionEngine(
            model, max_batch=int(traffic["max_batch"]),
            precision=precision or traffic["precision"], device=device)
        self.engine.decision_values(self.pool)   # the job's passes, once
        sync(device)
        self.jobs: List[Job] = []

    def _job(self, profiled: bool) -> Job:
        t0 = time.perf_counter()
        try:
            dec, err = self.engine.decision_values(self.pool), None
        except Exception as e:              # judged: a failed job
            dec, err = None, f"{type(e).__name__}: {e}"
        return Job(t0, time.perf_counter(), dec, profiled, err)

    def window(self, seconds: float, capture=None) -> dict:
        """Whole jobs back to back until ``seconds`` have passed; rows
        answered over the window's wall. With ``capture``, the jobs that
        start from ``slice_start_s`` into the window until ``slice_s`` have
        passed run under the profiler, inside the span
        ``svmbench.slice``."""
        from torch.profiler import record_function
        tr = self.traffic
        t0 = time.perf_counter()
        slice_from = t0 + float(tr["slice_start_s"])
        slice_to = None
        while True:
            if (capture is not None and slice_to is None
                    and time.perf_counter() >= slice_from):
                capture.start()
                span = record_function(self.slice_name)
                span.__enter__()
                slice_to = time.perf_counter() + float(tr["slice_s"])
            job = self._job(capture is not None and capture.running)
            self.jobs.append(job)
            if job.profiled and job.t1 >= slice_to:
                span.__exit__(None, None, None)
                capture.stop()
            if job.t1 - t0 >= seconds:
                break
        if capture is not None and capture.running:
            span.__exit__(None, None, None)
            capture.stop()
            raise RuntimeError("the window closed before the profiled "
                               "slice did: slice_start_s + slice_s must "
                               "end inside --seconds")
        if capture is not None and slice_to is None:
            raise RuntimeError("the window closed before the profiled "
                               "slice began")
        done = sum(j.decision is not None for j in self.jobs)
        return {"score_rows_per_s":
                done * self.pool.shape[0] / (job.t1 - t0)}

    @property
    def attempted(self) -> int:
        return len(self.jobs)

    @property
    def failed(self) -> int:
        return sum(j.decision is None for j in self.jobs)

    def release(self) -> None:
        self.engine.close()

    def slice_rows(self) -> int:
        """Rows scored by the profiled jobs."""
        return self.pool.shape[0] * sum(j.profiled for j in self.jobs)

    def slice_least_s(self) -> float:
        """The least time of the profiled jobs' rows
        (``roofline.score_bound_s``, one job at a time)."""
        n_sv, d = self.sv.shape
        jobs = sum(j.profiled for j in self.jobs)
        return jobs * roofline.score_bound_s(self.pool.shape[0], n_sv, d)

    def judge(self, device, limits: dict) -> dict:
        """``failed`` jobs (an error, or decisions not one finite number a
        row), ``decision_gap`` (the largest gap between a served decision
        value and the reference's, as a share of the reference's sum of
        |terms| plus |b|) and ``label_mismatch`` (rows whose label, the
        sign of the served decision as ``test`` takes it, is not the
        reference's, where the reference's decision lies farther from 0
        than the ``decision_gap`` limit of that scale), over every job of
        the window."""
        gap_limit = float(limits["decision_gap"])
        coef = self.alpha.astype(np.float64) * self.y_sv
        kv, scale = reference.rbf_sums(self.pool, self.sv, coef,
                                       float(self.config["gamma"]), device)
        d_ref = kv - self.b
        scale = scale + abs(self.b)
        sure = np.abs(d_ref) > gap_limit * scale
        lab_ref = np.where(d_ref < 0, -1, 1)
        out = {"failed": 0, "decision_gap": 0.0, "label_mismatch": 0}
        m = self.pool.shape[0]
        for j in self.jobs:
            dec = j.decision
            if (dec is None or np.shape(dec) != (m,)
                    or not np.all(np.isfinite(dec))):
                out["failed"] += 1
                continue
            rel = np.abs(dec.astype(np.float64) - d_ref) / scale
            out["decision_gap"] = worst(out["decision_gap"],
                                        float(rel.max()))
            lab = np.where(dec < 0, -1, 1)
            out["label_mismatch"] += int(np.sum(lab[sure] != lab_ref[sure]))
        return out
