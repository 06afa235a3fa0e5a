"""Stage 2 of the cascade: margin-band SV screening (a copy of
``dpsvm_tpu/approx/screening.py``: pure NumPy, so both packages screen
the same decision values to the same rows).

The cheap approx solution predicts the support-vector set: a row whose
approx margin ``y_i * f(x_i)`` clears ``1 + screen_margin`` is a
confident non-SV — its exact dual variable is almost surely 0 and it
can be dropped from the exact subproblem. The keep rule

    y_i * f(x_i) <= 1 + delta          (delta = config.screen_margin)

is the margin band ``|f(x)| <= 1 + delta`` completed on the wrong
side: for a correctly classified row ``y f == |f|`` so the two agree,
and a misclassified row (``y f < 0``, an at-bound SV in the exact
dual) is always kept no matter how far past the band it sits. The
margins are tested after CALIBRATION (``margin_scale`` below): the
approx stage's squared-hinge objective compresses decision values
relative to the exact hinge dual, and banding the raw values
over-keeps by 2-3x. The parallel-shrinking literature
(arXiv:1406.5161) screens on exactly this one-sided test; the
polishing recipe (arXiv:2207.01016) supplies the repair loop that
makes the band a performance knob instead of a correctness one —
``solver/cascade.py`` KKT-checks every screened-out row against the
polished model and re-admits violators.

Everything here is pure NumPy over already-computed decision values;
the scorer that produces those values (in-memory batches on the
device) lives in ``solver/cascade.py`` next to the orchestration that
consumes them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def apply_cap(idx: np.ndarray, yf: np.ndarray,
              cap: Optional[int]) -> Tuple[np.ndarray, bool]:
    """Enforce the hard row cap on a band selection.

    ``idx`` are the band rows' global indices, ``yf`` their margins.
    Over-cap rows are dropped LARGEST-margin-first — the rows kept are
    the ones most likely to be SVs (violators and at-bound rows have
    the smallest ``y f``). Deterministic: ties break on the global
    index, so the same data always screens to the same subproblem.
    Returns (sorted kept indices, whether the cap actually trimmed).
    """
    idx = np.asarray(idx, np.int64)
    if cap is None or cap <= 0 or len(idx) <= cap:
        return np.sort(idx), False
    order = np.lexsort((idx, np.asarray(yf, np.float32)))
    return np.sort(idx[order[:cap]]), True


def margin_scale(yf_exact: np.ndarray, yf_approx: np.ndarray,
                 floor: float = 0.2) -> float:
    """Calibration factor between approx and exact decision scales.

    The approx stage solves the SQUARED hinge (L2-SVM) primal, whose
    optimum has a systematically different weight scale from the L1
    hinge dual the exact solver certifies — measured on the planted
    8000x32 bench shape: approx margins compressed to ~0.67x the
    exact ones, so the raw band ``y f_a <= 1 + delta`` over-kept 52%
    of the rows where the true SV fraction was 20%. Dividing the
    approx margins by this factor before banding recovers the exact
    margin geometry (the cascade estimates it from a small exact
    PROBE solve — solver/cascade.py ``_calibrate``).

    The estimator is the median ratio over rows both models place
    confidently on the correct side (``y f > floor`` for both —
    ratio-stable, outlier-immune), clamped to [0.2, 5] so one
    degenerate probe can never nuke the band.
    """
    a = np.asarray(yf_approx, np.float64)
    e = np.asarray(yf_exact, np.float64)
    mask = (a > floor) & (e > floor)
    if mask.sum() < 8:
        return 1.0
    return float(np.clip(np.median(a[mask] / e[mask]), 0.2, 5.0))


def kkt_zero_violations(decisions: np.ndarray, y: np.ndarray,
                        tol: float) -> np.ndarray:
    """Mask of screened-out rows violating the ``alpha = 0`` KKT
    condition against a polished model: ``y f < 1 - tol``. The
    tolerance is the exact solver's own stopping slack (``2 epsilon``
    — the polished subproblem's interior rows satisfy no more), so a
    clean verify pass certifies the screened-out rows to the same bar
    the polish certifies the kept rows."""
    yf = np.asarray(decisions, np.float32) * np.asarray(y, np.float32)
    return yf < np.float32(1.0 - tol)
