"""The ``fit`` kind: rounds of whole ``api.fit`` calls (host arrays in,
``SVMModel`` out) on ``api.fit``'s default route, each round the
configuration's ``problems`` (the planted draw and turns of it,
``data.problems``) once, in the seed's order. Every seed runs the same
problems, so every seed's window holds the same work. ``warmup_iters``
caps the one warm-up fit of set-up.

The constructor is the set-up, ``window`` the measured window (with a
capture, the first fit profiled) and ``judge`` the comparison with the
plain reference, after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np

from svmbench import data, reference
from svmbench.core import sync, worst


@dataclasses.dataclass
class Fit:
    problem: int
    alpha: np.ndarray
    b: float
    converged: bool
    n_iter: int
    rounds: int
    train_seconds: float
    wall: float
    model: object
    profiled: bool


class Cell:
    kind = "fit"
    slice_name = "svmbench.fit"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 precision: Optional[str] = None):
        from dpsvm_tpu_torch import api
        from dpsvm_tpu_torch.config import SVMConfig
        self.api = api
        self.config = config
        self.device = device
        self.problems = data.problems(config, int(traffic["problems"]))
        self.order = [int(k) for k in np.random.default_rng(
            int(seed)).permutation(len(self.problems))]
        self.x = self.problems[0][0]
        self.cfg = SVMConfig(
            c=float(config["c"]), gamma=float(config["gamma"]),
            kernel=config["kernel"], epsilon=float(config["epsilon"]),
            max_iter=int(config["max_iter"]),
            matmul_precision=precision or config["matmul_precision"])
        self.el = 2 if self.cfg.matmul_precision == "default" else 4
        warm = dataclasses.replace(self.cfg,
                                   max_iter=int(traffic["warmup_iters"]))
        api.fit(self.problems[0][0], self.problems[0][1], warm,
                device=device)
        sync(device)
        self.fits: List[Fit] = []

    def window(self, seconds: float, capture=None) -> dict:
        """Rounds of whole fits, each round every problem once in the
        seed's order, from the window's start until ``seconds`` have
        passed; the window ends with the round that crossed the mark, so
        every seed's window holds the same work. With ``capture``, the
        first fit runs under the profiler inside the span
        ``svmbench.fit``."""
        from torch.profiler import record_function
        t0 = time.perf_counter()
        while True:
            for k in self.order:
                x, y = self.problems[k][:2]
                ts = time.perf_counter()
                profiled = capture is not None and not self.fits
                if profiled:
                    capture.start()
                with (record_function(self.slice_name) if profiled
                      else contextlib.nullcontext()):
                    model, res = self.api.fit(x, y, self.cfg,
                                              device=self.device)
                if profiled:
                    capture.stop()
                te = time.perf_counter()
                self.fits.append(Fit(
                    problem=k, alpha=np.asarray(res.alpha), b=float(res.b),
                    converged=bool(res.converged), n_iter=int(res.n_iter),
                    rounds=int(res.rounds),
                    train_seconds=float(res.train_seconds), wall=te - ts,
                    model=model, profiled=profiled))
            if te - t0 >= seconds:
                break
        return {"fit_s": (te - t0) / len(self.fits)}

    @property
    def attempted(self) -> int:
        return len(self.fits)

    @property
    def failed(self) -> int:
        return sum(not f.converged for f in self.fits)

    def release(self) -> None:
        pass

    def judge(self, device, limits: dict) -> dict:
        """The compared numbers, worst over every fit of the window:
        ``unconverged`` fits, ``box`` (alphas outside [0, C] or not
        finite), ``compaction`` (model rows, alphas, labels or b unlike
        the solver's alpha > 0 rows), ``kkt_gap`` (b_lo - b_hi of the
        solver's alpha, f recomputed in float64 from the model's SVs) and
        ``heldout_gap`` (the largest gap on the held-out rows between the
        model's decision values and the reference's, which uses the
        solver's alpha and the b of its own extrema)."""
        c, gamma = float(self.config["c"]), float(self.config["gamma"])
        out = {"unconverged": 0, "box": 0, "compaction": 0,
               "kkt_gap": float("-inf"), "heldout_gap": 0.0}
        for f in self.fits:
            a, m = f.alpha, f.model
            x, y, xh, _ = self.problems[f.problem]
            out["unconverged"] += int(not f.converged)
            out["box"] += int(np.sum(~np.isfinite(a) | (a < 0) | (a > c)))
            keep = a > 0
            k = int(keep.sum())
            if m.x_sv.shape[0] != k:
                out["compaction"] += abs(m.x_sv.shape[0] - k) + 1
            else:
                bad = (np.any(m.x_sv != x[keep], axis=1)
                       | (m.alpha != a[keep]) | (m.y_sv != y[keep]))
                out["compaction"] += int(bad.sum()) + int(m.b != f.b)
            coef = m.alpha.astype(np.float64) * m.y_sv
            ref = reference.kkt(x, y, a, m.x_sv, coef, c, gamma,
                                device)
            out["kkt_gap"] = worst(out["kkt_gap"], ref["gap"])
            dm, _ = reference.rbf_sums(xh, m.x_sv, coef, gamma, device)
            dr, _ = reference.rbf_sums(
                xh, x[keep],
                a[keep].astype(np.float64) * y[keep], gamma, device)
            gap = np.abs((dm - m.b) - (dr - ref["b"]))
            out["heldout_gap"] = worst(out["heldout_gap"],
                                       float(gap.max()) if gap.size
                                       else 0.0)
        return out
